"""Command-line interface (python -m nomad_tpu_torch.cli)."""
from .main import main  # noqa: F401
