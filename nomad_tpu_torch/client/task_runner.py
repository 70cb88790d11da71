"""TaskRunner: one task's lifecycle inside an allocation.

Capability parity with reference client/task_runner.go: create the
driver, start the task, wait on the handle / update / destroy; persist
{task, handle id} so a restarted agent can driver.open() and re-attach to
the live process instead of restarting it.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable, Optional

from nomad_tpu_torch import faultinject
from nomad_tpu_torch.structs import Task

from .driver import new_driver
from .driver.base import ExecContext

logger = logging.getLogger("nomad_tpu_torch.client.task_runner")

TASK_STATE_PENDING = "pending"
TASK_STATE_RUNNING = "running"
TASK_STATE_DEAD = "dead"


class TaskRunner:
    def __init__(self, ctx: ExecContext, task: Task, state_dir: str = "",
                 on_state: Optional[Callable] = None) -> None:
        self.ctx = ctx
        self.task = task
        self.state_dir = state_dir
        self.on_state = on_state or (lambda *_: None)

        self.state = TASK_STATE_PENDING
        self.failed = False
        self.handle = None
        self._destroy = threading.Event()
        self._updates: list = []
        self._thread: Optional[threading.Thread] = None

    # -- persistence -------------------------------------------------------
    def _state_path(self) -> str:
        return os.path.join(self.state_dir,
                            f"task-{self.task.name}.json")

    def save_state(self) -> None:
        if not self.state_dir:
            return
        os.makedirs(self.state_dir, exist_ok=True)
        data = {"task": self.task.to_dict(),
                "handle_id": self.handle.id() if self.handle else None}
        tmp = self._state_path() + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(data, fh)
        os.replace(tmp, self._state_path())

    def restore_state(self) -> bool:
        """Re-attach to a live task from persisted state; True on
        success."""
        try:
            with open(self._state_path()) as fh:
                data = json.load(fh)
        except (OSError, ValueError):
            return False
        handle_id = data.get("handle_id")
        if not handle_id:
            return False
        driver = new_driver(self.task.driver, self.ctx)
        try:
            self.handle = driver.open(handle_id)
        except Exception:
            logger.info("task %s: stale handle %s, will restart",
                        self.task.name, handle_id)
            return False
        self._set_state(TASK_STATE_RUNNING)
        return True

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.run, daemon=True,
            name=f"task-runner-{self.task.name}")
        self._thread.start()

    def run(self) -> None:
        if self.handle is None:
            try:
                if faultinject.ACTIVE:
                    faultinject.fire("driver.start",
                                     method=self.task.driver)
                driver = new_driver(self.task.driver, self.ctx)
                self.handle = driver.start(self.task)
            except Exception as e:
                logger.exception("task %s failed to start", self.task.name)
                self.failed = True
                self._set_state(TASK_STATE_DEAD, str(e))
                return
            self.save_state()
        self._set_state(TASK_STATE_RUNNING)

        while not self._destroy.is_set():
            exit_code = self.handle.wait(timeout=0.2)
            if exit_code is not None:
                self.failed = exit_code != 0
                self._set_state(TASK_STATE_DEAD,
                                f"exit code {exit_code}")
                self._cleanup_state()
                return
            while self._updates:
                update = self._updates.pop(0)
                self.task = update
                try:
                    self.handle.update(update)
                except Exception:
                    logger.exception("task %s update failed",
                                     self.task.name)
        # Destroy requested.
        try:
            self.handle.kill()
        except Exception:
            logger.exception("task %s kill failed", self.task.name)
        self._set_state(TASK_STATE_DEAD, "task destroyed")
        self._cleanup_state()

    def update(self, task: Task) -> None:
        self._updates.append(task)

    def destroy(self) -> None:
        self._destroy.set()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def _set_state(self, state: str, description: str = "") -> None:
        self.state = state
        self.on_state(self.task.name, state, description)

    def _cleanup_state(self) -> None:
        if self.state_dir:
            try:
                os.unlink(self._state_path())
            except OSError:
                pass
