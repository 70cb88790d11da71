"""Boot-log gating + recent-log ring for the agent.

Capability parity with the reference's log plumbing:
- GatedHandler = helper/gated-writer/writer.go — writes are BUFFERED
  until the gate opens (the agent knows its final log level/sinks only
  after config parsing), then replayed once and passed through;
- LogWriter = command/agent/log_writer.go — a ring of recent formatted
  lines with attachable live sinks, serving "show me the agent log"
  monitors without re-reading files.

Installed by the CLI agent command (nomad_tpu_torch/cli/main.py
cmd_agent); library embedders keep plain propagation.

Counterpart of ``nomad_tpu/utils/gated_log.py``; the default logger is
the port's own, ``nomad_tpu_torch``, so a JAX agent and a port agent in
one process each gate only their own package's records.
"""
from __future__ import annotations

import logging
import sys
import threading
from collections import deque
from typing import Callable, Optional

from nomad_tpu_torch.utils.sync import CopySwap

FORMAT = "%(asctime)s [%(levelname)s] %(name)s: %(message)s"


class LogWriter(logging.Handler):
    """Ring buffer of recent formatted lines + attachable live sinks."""

    def __init__(self, maxlen: int = 512) -> None:
        super().__init__()
        self.setFormatter(logging.Formatter(FORMAT))
        self._ring: deque = deque(maxlen=maxlen)
        self._total = 0  # monotonic count of lines ever appended
        self._sinks: list = []
        # Reentrant: a sink that logs through the same logger (error
        # paths) must not deadlock the pipeline.
        self._slock = threading.RLock()

    def emit(self, record: logging.LogRecord) -> None:
        try:
            line = self.format(record)
        except Exception:  # pragma: no cover - defensive
            return
        with self._slock:
            self._ring.append(line)
            self._total += 1
            sinks = list(self._sinks)
        for sink in sinks:
            try:
                sink(line)
            except Exception:  # pragma: no cover - bad sink
                pass

    def lines(self, n: int = 0) -> list:
        with self._slock:
            out = list(self._ring)
        return out[-n:] if n else out

    def lines_since(self, since: int) -> tuple[list, int]:
        """(lines appended after monotonic offset ``since``, current
        offset) — the follow-mode contract: clients resume from the
        returned offset and never re-see or miss a line (lines evicted
        past the ring's maxlen before being read are simply gone).

        ``since > total`` means the offset came from a PREVIOUS process
        (agent restarted, counter reset): the whole ring is returned —
        the restart backlog is exactly what a watching operator wants."""
        with self._slock:
            total = self._total
            ring = list(self._ring)
        if since > total:
            return ring, total
        avail = min(len(ring), total - since)
        return (ring[-avail:] if avail else []), total

    def monitor(self, sink: Callable[[str], None]) -> Callable[[], None]:
        """Attach a live sink; returns an unsubscribe callable.  The
        recent ring is replayed into the sink first, so a monitor sees
        context before the live tail (reference log_writer.go logs +
        handlers).

        Replay-then-register happens under the (reentrant) lock so a
        concurrent emit cannot interleave a live line among backlog
        lines; the cost is that logging threads wait out the (bounded,
        <= maxlen lines) replay at attach time — sinks must be prompt
        and never block on remote I/O (buffer and drain elsewhere)."""
        with self._slock:
            # Snapshot: a reentrant sink that logs (the RLock admits it)
            # would otherwise mutate the deque mid-iteration.
            for line in list(self._ring):
                sink(line)
            self._sinks.append(sink)

        def unsubscribe() -> None:
            with self._slock:
                if sink in self._sinks:
                    self._sinks.remove(sink)
        return unsubscribe


class GatedHandler(logging.Handler):
    """Buffers records until ``open_gate``; then replays them through
    the final targets exactly once and passes live records through."""

    def __init__(self) -> None:
        super().__init__(level=logging.NOTSET)
        self._buffer: list = []
        # Rebound (a fresh list) under _glock by open_gate; bare reads
        # serve whichever complete target list was last published —
        # the copy-on-write-swap contract the annotation enforces.
        self._targets: CopySwap = []
        self._open = False
        self._glock = threading.Lock()

    @staticmethod
    def _dispatch(targets: list, record: logging.LogRecord) -> None:
        for t in targets:
            # Handler.handle() skips the per-handler level check (that
            # normally lives in Logger.callHandlers) — apply it here so
            # the configured level filters buffered AND live records.
            if record.levelno >= t.level:
                t.handle(record)

    def emit(self, record: logging.LogRecord) -> None:
        with self._glock:
            if not self._open:
                self._buffer.append(record)
                return
            targets = list(self._targets)
        self._dispatch(targets, record)

    def open_gate(self, targets: list) -> None:
        """Drain-then-open: buffered records are dispatched BEFORE the
        gate flips, iterating until the buffer is empty under the lock,
        so live records emitted by already-running threads during the
        replay still queue behind the backlog — output stays in
        chronological order."""
        with self._glock:
            self._targets = list(targets)
        while True:
            with self._glock:
                buffered, self._buffer = self._buffer, []
                if not buffered:
                    self._open = True
                    return
            for record in buffered:
                self._dispatch(self._targets, record)


class BootLogGate:
    """The CLI agent's logging pipeline: install before config parsing,
    open after the agent knows its level/sinks."""

    def __init__(self, logger_name: str = "nomad_tpu_torch",
                 stream=None) -> None:
        self.logger = logging.getLogger(logger_name)
        self.gate = GatedHandler()
        self.log_writer = LogWriter()
        self._stream = stream
        # Capture everything during boot; the final level filters at
        # gate-open (we don't know the configured level yet).
        self._prior_level = self.logger.level
        self._prior_propagate = self.logger.propagate
        self.logger.setLevel(logging.DEBUG)
        self.logger.propagate = False
        self.logger.addHandler(self.gate)

    def open(self, level: str = "INFO") -> None:
        """Attach the real stderr handler + the recent-log ring at the
        configured level and replay buffered boot records once."""
        numeric = getattr(logging, str(level).upper(), None)
        if not isinstance(numeric, int):
            numeric = logging.INFO
        stderr_handler = logging.StreamHandler(self._stream or sys.stderr)
        stderr_handler.setFormatter(logging.Formatter(FORMAT))
        stderr_handler.setLevel(numeric)
        # The ring stays UNLEVELED: /v1/agent/monitor can serve DEBUG
        # backlog even when stderr filters at INFO (the logger is held
        # at DEBUG for exactly this; the extra record construction on
        # debug sites is the price of always-available monitor detail).
        self.gate.open_gate([stderr_handler, self.log_writer])

    def set_level(self, level: str) -> None:
        """Re-filter the open pipeline (SIGHUP log_level reload).  Only
        the stderr handler moves; the ring keeps capturing everything."""
        numeric = getattr(logging, str(level).upper(), None)
        if not isinstance(numeric, int):
            return
        for target in self.gate._targets:
            if target is not self.log_writer:
                target.setLevel(numeric)

    def remove(self) -> None:
        """Detach (tests / embedder cleanup)."""
        self.logger.removeHandler(self.gate)
        self.logger.setLevel(self._prior_level)
        self.logger.propagate = self._prior_propagate
