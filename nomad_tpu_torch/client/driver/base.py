"""Driver base contracts + the shared subprocess executor.

Capability parity with reference client/driver/driver.go:46-135
(Driver/DriverHandle/ExecContext) and reference client/executor/
(process supervision; re-attach by persisted id).  The Linux executor's
cgroup + chroot isolation lives in exec_driver.py; this module provides the
portable process machinery every driver shares.
"""
from __future__ import annotations

import logging
import os
import shlex
import signal
import subprocess
import threading
from typing import Optional

from nomad_tpu_torch.client.task_env import task_environment

logger = logging.getLogger("nomad_tpu_torch.client.driver")


class ExecContext:
    """Per-alloc execution context handed to drivers
    (reference driver.go:96-109).  ``options`` carries the client
    config's free-form kv namespace (reference config.Read/ReadBool —
    e.g. docker.cleanup.container)."""

    def __init__(self, alloc_dir, alloc_id: str = "",
                 options: Optional[dict] = None) -> None:
        self.alloc_dir = alloc_dir      # AllocDir
        self.alloc_id = alloc_id
        self.options = options or {}

    def read_bool(self, key: str, default: bool = False) -> bool:
        from nomad_tpu_torch.client.config import read_bool_option

        return read_bool_option(self.options, key, default)


class DriverHandle:
    """A running task: wait/update/kill + a serializable re-attach id."""

    def id(self) -> str:
        raise NotImplementedError

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        """Block for exit; returns exit code or None if still running."""
        raise NotImplementedError

    def is_running(self) -> bool:
        raise NotImplementedError

    def update(self, task) -> None:
        raise NotImplementedError

    def kill(self) -> None:
        raise NotImplementedError


class ProcessHandle(DriverHandle):
    """Handle over a supervised subprocess.

    The re-attach id carries the pid: after an agent restart, ``from_id``
    adopts the live process (reference executor re-attach,
    client/task_runner.go:92-105 + executor/exec_linux.go handles).
    """

    def __init__(self, proc: Optional[subprocess.Popen] = None,
                 pid: Optional[int] = None, kind: str = "proc") -> None:
        self.proc = proc
        self.pid = proc.pid if proc is not None else pid
        self.kind = kind
        self._exit_code: Optional[int] = None
        self._done = threading.Event()
        if proc is not None:
            threading.Thread(target=self._reap, daemon=True).start()
        elif pid is not None:
            threading.Thread(target=self._poll_adopted,
                             daemon=True).start()

    def _reap(self) -> None:
        self._exit_code = self.proc.wait()
        self._done.set()

    def _poll_adopted(self) -> None:
        """An adopted pid isn't our child; poll liveness instead of wait."""
        import time

        while _pid_alive(self.pid):
            time.sleep(0.2)
        self._exit_code = 0  # exit status unknowable for non-children
        self._done.set()

    def id(self) -> str:
        return f"{self.kind}:{self.pid}"

    @classmethod
    def from_id(cls, handle_id: str) -> "ProcessHandle":
        kind, pid = handle_id.split(":", 1)
        pid = int(pid)
        if not _pid_alive(pid):
            raise ProcessLookupError(f"pid {pid} is gone")
        return cls(pid=pid, kind=kind)

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        if self._done.wait(timeout):
            return self._exit_code
        return None

    def is_running(self) -> bool:
        return not self._done.is_set()

    def update(self, task) -> None:
        pass  # resources of a live process are not renegotiated

    def kill(self) -> None:
        if self.pid is None:
            return
        try:
            # Kill the whole process group (children included).
            os.killpg(self.pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError, OSError):
            try:
                os.kill(self.pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                return
        if self.wait(5.0) is None:
            try:
                os.killpg(self.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError, OSError):
                try:
                    os.kill(self.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


class Driver:
    """Base driver (reference driver.go:46-94)."""

    name = "base"

    def __init__(self, ctx: ExecContext) -> None:
        self.ctx = ctx

    @classmethod
    def fingerprint(cls, cfg, node) -> bool:
        """Advertise driver.<name> on the node; False if unavailable."""
        raise NotImplementedError

    def start(self, task) -> DriverHandle:
        raise NotImplementedError

    def open(self, handle_id: str) -> DriverHandle:
        return ProcessHandle.from_id(handle_id)

    # -- shared launch helper ---------------------------------------------
    def spawn(self, task, argv: list, kind: str,
              cwd: Optional[str] = None,
              extra_env: Optional[dict] = None) -> ProcessHandle:
        task_dir = self.ctx.alloc_dir.task_dirs.get(task.name)
        env = dict(os.environ)
        env.update(task_environment(
            task, alloc_dir=self.ctx.alloc_dir.shared_dir,
            task_dir=task_dir))
        env.update(extra_env or {})
        stdout = open(self.ctx.alloc_dir.log_path(task.name, "stdout"),
                      "ab")
        stderr = open(self.ctx.alloc_dir.log_path(task.name, "stderr"),
                      "ab")
        try:
            # faultlint-ok(uninjectable-io): the exec boundary itself;
            # driver.start is consulted at the task_runner seam one
            # frame above — the arming edge goes through the driver
            # registry (dynamic), invisible to the resolved-edge walk.
            proc = subprocess.Popen(
                argv,
                cwd=cwd or task_dir,
                env=env,
                stdout=stdout,
                stderr=stderr,
                start_new_session=True,  # own process group for kill
            )
        finally:
            stdout.close()
            stderr.close()
        logger.info("driver %s started task %s pid %d", self.name,
                    task.name, proc.pid)
        return ProcessHandle(proc, kind=kind)


def parse_command(task) -> list:
    """command + args from a task config (reference drivers read
    config["command"] / config["args"])."""
    command = task.config.get("command", "")
    if not command:
        raise ValueError(f"missing command for task {task.name!r}")
    args = task.config.get("args", "")
    if isinstance(args, str):
        args = shlex.split(args) if args else []
    return [command] + list(args)
