"""Shared pure helpers with no package-level dependencies.

Lives below both the scheduler layer and the device-model layer so constraint
predicates are importable from either side without cycles.
"""
from .predicates import (  # noqa: F401
    check_constraint_values,
    resolve_constraint_target,
)
from .versions import check_constraint as check_version_constraint  # noqa: F401
