"""raw_exec driver: plain subprocess, no isolation.

Capability parity with reference client/driver/raw_exec.go: runs the
command directly with the task environment; must be explicitly enabled
(option ``driver.raw_exec.enable``) since it provides no isolation.
"""
from __future__ import annotations

from .base import Driver, parse_command


class RawExecDriver(Driver):
    name = "raw_exec"

    @classmethod
    def fingerprint(cls, cfg, node) -> bool:
        if not cfg.read_bool("driver.raw_exec.enable"):
            node.attributes.pop("driver.raw_exec", None)
            return False
        node.attributes["driver.raw_exec"] = "1"
        return True

    def start(self, task):
        argv = parse_command(task)
        return self.spawn(task, argv, kind="raw")
