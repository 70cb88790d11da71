"""AllocRunner: one allocation's lifecycle on a client.

Capability parity with reference client/alloc_runner.go: build the
alloc dir, spawn a TaskRunner per task, aggregate task states into the
alloc's client status, sync dirty status to the server with retry, and
handle update/destroy.  State persists to ``state.json`` per alloc for
restore on agent restart.
"""
from __future__ import annotations

import json
import logging
import os
import threading
from collections import deque
from typing import Callable, Optional

from nomad_tpu_torch.structs import (
    ALLOC_CLIENT_STATUS_DEAD,
    ALLOC_CLIENT_STATUS_FAILED,
    ALLOC_CLIENT_STATUS_PENDING,
    ALLOC_CLIENT_STATUS_RUNNING,
    ALLOC_DESIRED_STATUS_RUN,
    Allocation,
    Task,
)

from nomad_tpu_torch.utils.sync import CopySwap

from .allocdir import AllocDir
from .driver.base import ExecContext
from .task_runner import TASK_STATE_DEAD, TASK_STATE_RUNNING, TaskRunner

logger = logging.getLogger("nomad_tpu_torch.client.alloc_runner")


class CorruptAllocState(ValueError):
    """Persisted alloc state exists but cannot be decoded (torn write,
    truncation, crash mid-save).  The RUNNER is unrecoverable locally;
    the ALLOCATION is not — the server still knows it, and the client
    degrades to re-fetching it from the first alloc watch and
    re-attaching (task state persists separately, so a live task's
    handle usually survives)."""


def reclaim_orphan(alloc_id: str, alloc_root: str, state_dir: str,
                   options: Optional[dict] = None) -> None:
    """Kill-and-reclaim for an alloc the server is DONE with (terminal
    or gone) whose local alloc state is torn (CorruptAllocState): the
    alloc spec is unreadable, but each task's spec and driver handle
    persist separately (``task-<name>.json``), so any still-live
    process is re-attached by its handle and killed before the
    directories are reclaimed — a torn state file must never leave an
    orphan running forever."""
    ctx = ExecContext(AllocDir(alloc_root), alloc_id, options=options)
    try:
        names = os.listdir(state_dir)
    except OSError:
        names = []
    for name in names:
        if not (name.startswith("task-") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(state_dir, name)) as fh:
                task = Task.from_dict(json.load(fh)["task"])
        except Exception:
            continue  # the task file is torn too: no handle to open
        tr = TaskRunner(ctx, task, state_dir=state_dir)
        if tr.restore_state():
            try:
                tr.handle.kill()
            except Exception:
                logger.exception("orphan task %s kill failed", task.name)
    import shutil

    shutil.rmtree(state_dir, ignore_errors=True)
    shutil.rmtree(alloc_root, ignore_errors=True)


class AllocRunner:
    def __init__(self, alloc: Allocation, alloc_root: str,
                 state_dir: str = "",
                 on_status: Optional[Callable] = None,
                 options: Optional[dict] = None) -> None:
        # Rebound atomically (copy-swap) by publishers holding
        # _publish_lock; readers see the previous or new immutable
        # alloc, never a torn one.
        self.alloc: CopySwap = alloc
        self.alloc_root = alloc_root
        self.state_dir = state_dir
        self.on_status = on_status or (lambda alloc: None)

        self.alloc_dir = AllocDir(alloc_root)
        self.ctx = ExecContext(self.alloc_dir, alloc.id, options=options)
        # Published as ONE complete set under _lock by run() before any
        # task starts (see the publish comment there); never mutated
        # after, so bare reads are safe — the annotation states the
        # contract the lint enforces (locked writes, exempt reads).
        self.task_runners: CopySwap = {}
        self.task_states: dict = {}
        self._destroy = threading.Event()
        self._lock = threading.Lock()
        # Publication sequencing: _on_task_state stamps each aggregate
        # with a sequence under _lock; _publish_lock serializes the
        # publish (alloc swap + persist + server sync) and drops
        # aggregates older than one already published, so two runner
        # threads finishing together can't publish newest-first and let
        # the stale status win.
        self._publish_lock = threading.Lock()
        self._state_seq = 0
        self._published_seq = 0
        # Server-sync outbox: on_status is a blocking RPC with retries —
        # it must run OUTSIDE _publish_lock (or one unreachable server
        # stalls every sibling publish and update()), but still in
        # publish order.  Appends happen under _publish_lock; a single
        # drainer at a time delivers FIFO.
        self._status_outbox: "deque" = deque()
        self._outbox_lock = threading.Lock()

    # -- state persistence -------------------------------------------------
    def _state_path(self) -> str:
        return os.path.join(self.state_dir, "state.json")

    def save_state(self) -> None:
        if not self.state_dir:
            return
        os.makedirs(self.state_dir, exist_ok=True)
        tmp = self._state_path() + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"alloc": self.alloc.to_dict()}, fh)
        # faultlint-ok(uninjectable-io): client-local checkpoint; the
        # crash sites cover the server storage planes, and the client
        # restore path is driven directly by its tests.
        os.replace(tmp, self._state_path())

    @classmethod
    def restore(cls, alloc_root: str, state_dir: str,
                on_status: Optional[Callable] = None,
                options: Optional[dict] = None
                ) -> Optional["AllocRunner"]:
        """Rebuild a runner from persisted state.  Returns None when no
        state was persisted (nothing to restore); raises
        :class:`CorruptAllocState` when state exists but is torn — the
        caller must re-fetch the alloc from the server rather than
        silently discarding a possibly-running allocation."""
        path = os.path.join(state_dir, "state.json")
        try:
            with open(path) as fh:
                data = json.load(fh)
            alloc = Allocation.from_dict(data["alloc"])
        except OSError:
            return None
        except Exception as e:
            raise CorruptAllocState(f"{path}: {e}") from e
        runner = cls(alloc, alloc_root, state_dir, on_status,
                     options=options)
        return runner

    # -- lifecycle ---------------------------------------------------------
    def tasks(self) -> list:
        tg = self.alloc.job.lookup_task_group(self.alloc.task_group) \
            if self.alloc.job else None
        return list(tg.tasks) if tg else []

    def run(self, restore: bool = False) -> None:
        tasks = self.tasks()
        if not tasks:
            self._set_client_status(ALLOC_CLIENT_STATUS_FAILED,
                                    "alloc has no tasks")
            return
        self.alloc_dir.build(tasks)
        self.save_state()
        runners = []
        for task in tasks:
            # Use per-task resources from the scheduler when present.
            task_resources = self.alloc.task_resources.get(task.name)
            if task_resources is not None:
                task = task.copy()
                task.resources = task_resources
            runners.append(TaskRunner(self.ctx, task,
                                      state_dir=self.state_dir,
                                      on_state=self._on_task_state))
        # Publish the COMPLETE runner set before starting any task: the
        # first started task can die (or report running) immediately,
        # firing _on_task_state from its runner thread — _aggregate must
        # see every sibling, or a fast-exiting first task marks the whole
        # alloc dead/failed with its siblings not yet created (and the
        # dict would be mutated mid-iteration under _aggregate's walk).
        with self._lock:
            for tr in runners:
                self.task_runners[tr.task.name] = tr
        for tr in runners:
            if restore:
                # Re-attach to the live process when its handle is still
                # valid; start() supervises either way.
                tr.restore_state()
            tr.start()

    def _on_task_state(self, task_name: str, state: str,
                       description: str) -> None:
        with self._lock:
            self.task_states[task_name] = {"state": state,
                                           "description": description}
            status, desc = self._aggregate()
            # Snapshot + sequence under the lock: a sibling task's runner
            # thread may be inserting its own state while we publish ours,
            # and the sequence lets the publisher drop this aggregate if a
            # newer one already went out.
            states = dict(self.task_states)
            self._state_seq += 1
            seq = self._state_seq
        # No unlocked status pre-check here: even a "no change" aggregate
        # must consume its seq under the publish lock, or an older
        # in-flight aggregate slips past the fence afterwards.
        self._set_client_status(status, desc, states, seq)

    def _aggregate(self) -> tuple[str, str]:
        """Task states -> alloc client status
        (reference alloc_runner.go:150-196)."""
        states = [s["state"] for s in self.task_states.values()]
        failed = any(tr.failed for tr in self.task_runners.values())
        if failed:
            return ALLOC_CLIENT_STATUS_FAILED, "one or more tasks failed"
        if states and all(s == TASK_STATE_DEAD for s in states) and \
                len(states) == len(self.task_runners):
            return ALLOC_CLIENT_STATUS_DEAD, "all tasks completed"
        if any(s == TASK_STATE_RUNNING for s in states):
            return ALLOC_CLIENT_STATUS_RUNNING, ""
        return ALLOC_CLIENT_STATUS_PENDING, ""

    def _set_client_status(self, status: str, description: str,
                           task_states: Optional[dict] = None,
                           seq: Optional[int] = None) -> None:
        with self._publish_lock:
            if seq is not None:
                if seq <= self._published_seq:
                    return  # a newer aggregate already published
                # Consume the seq BEFORE the no-change skip: a skipped
                # newest aggregate must still fence out older ones.
                self._published_seq = seq
                if status == self.alloc.client_status:
                    return
            if task_states is None:
                with self._lock:
                    task_states = dict(self.task_states)
            updated = self.alloc.copy()
            updated.client_status = status
            updated.client_description = description
            updated.task_states = task_states
            self.alloc = updated
            self.save_state()
            self._status_outbox.append(updated)
        self._drain_outbox()

    def _drain_outbox(self) -> None:
        """Deliver queued status syncs FIFO, one drainer at a time, with
        the publish lock NOT held (on_status blocks on RPC retries).
        The outer re-check closes the race where an appender bounces off
        a drainer that is just finishing."""
        while self._status_outbox:
            if not self._outbox_lock.acquire(blocking=False):
                return  # current drainer re-checks after releasing
            try:
                while True:
                    try:
                        updated = self._status_outbox.popleft()
                    except IndexError:
                        break
                    try:
                        self.on_status(updated)
                    except Exception:
                        logger.exception("alloc %s status sync failed",
                                         updated.id)
            finally:
                self._outbox_lock.release()

    def update(self, alloc: Allocation) -> None:
        """Server pushed a new version of this alloc."""
        # Keep client-authoritative fields; take the server's view of the
        # rest (desired status, job version, modify index).  The
        # read-merge-write of self.alloc must hold the publish lock or a
        # task thread's concurrent status publish is silently lost.
        alloc = alloc.copy()
        with self._publish_lock:
            alloc.client_status = self.alloc.client_status
            alloc.client_description = self.alloc.client_description
            alloc.task_states = self.alloc.task_states
            self.alloc = alloc
        if alloc.desired_status != ALLOC_DESIRED_STATUS_RUN:
            self.destroy_tasks()
            return
        tg = alloc.job.lookup_task_group(alloc.task_group) \
            if alloc.job else None
        if tg is None:
            return
        for task in tg.tasks:
            tr = self.task_runners.get(task.name)
            if tr is not None:
                tr.update(task)

    def destroy_tasks(self) -> None:
        for tr in self.task_runners.values():
            tr.destroy()

    def destroy(self) -> None:
        self._destroy.set()
        self.destroy_tasks()
        for tr in self.task_runners.values():
            tr.join(10)
        self.alloc_dir.destroy()
        if self.state_dir:
            import shutil

            shutil.rmtree(self.state_dir, ignore_errors=True)

    def wait_for_status(self, status: str, timeout: float = 10.0) -> bool:
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.alloc.client_status == status:
                return True
            time.sleep(0.02)
        return False
