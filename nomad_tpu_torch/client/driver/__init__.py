"""Task driver framework.

Capability parity with reference client/driver/driver.go: a registry
of built-in drivers, each implementing fingerprint (advertise
``driver.<name>`` node attributes), ``start`` (launch a task, return a
handle), and ``open`` (re-attach to a live task after agent restart via the
persisted handle id).  Handles expose wait/update/kill.
"""
from __future__ import annotations

from typing import Callable, Optional

from .base import Driver, DriverHandle, ExecContext  # noqa: F401
from .raw_exec import RawExecDriver
from .exec_driver import ExecDriver
from .java import JavaDriver
from .qemu import QemuDriver
from .docker import DockerDriver
from .rkt import RktDriver

BUILTIN_DRIVERS: dict = {
    "raw_exec": RawExecDriver,
    "exec": ExecDriver,
    "java": JavaDriver,
    "qemu": QemuDriver,
    "docker": DockerDriver,
    "rkt": RktDriver,
}


def new_driver(name: str, ctx) -> Driver:
    cls = BUILTIN_DRIVERS.get(name)
    if cls is None:
        raise ValueError(f"unknown driver {name!r}")
    return cls(ctx)
