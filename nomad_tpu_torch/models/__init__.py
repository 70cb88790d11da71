"""Device-facing models: fleet tensorization + constraint compilation."""
from .fleet import FleetStatics, FleetView, build_fleet, fleet_cache  # noqa: F401
from .constraints import compile_group_mask  # noqa: F401
