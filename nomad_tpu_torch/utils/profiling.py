"""Introspection: host thread stacks + device profiler control.

Capability parity with the reference's pprof mount
(reference command/agent/http.go:115-120 — net/http/pprof under
``enableDebug``) re-thought for this runtime: the host side dumps live
Python thread stacks (the pprof-goroutine equivalent) and the device side
toggles a ``torch.profiler`` session around the scheduler's kernel
launches.

Counterpart of ``nomad_tpu/utils/profiling.py``, whose device side runs
``jax.profiler``.  Here a session records CUDA activity (with the host's
CPU activity beside it) on the card, and CPU activity alone when the
caller asks for ``device="cpu"``; ``device=None`` means ``cuda`` and
raises ``RuntimeError`` where no CUDA device is present.  Stopping the
session writes one Chrome-trace JSON file, :data:`TRACE_FILE`, into the
session's directory.
"""
from __future__ import annotations

import os
import sys
import threading
import traceback
from typing import Optional

TRACE_FILE = "device_trace.json"

_lock = threading.Lock()
_trace_dir: Optional[str] = None
_profiler = None


def thread_stacks() -> dict:
    """Stacks of every live thread, keyed by thread name — the
    goroutine-dump analogue served at /v1/agent/pprof."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        name = names.get(ident, f"thread-{ident}")
        out[f"{name} ({ident})"] = [
            {"file": fs.filename, "line": fs.lineno, "func": fs.name,
             "code": (fs.line or "").strip()}
            for fs in traceback.extract_stack(frame)
        ]
    return out


def _activities(device):
    import torch
    from torch.profiler import ProfilerActivity

    kind = torch.device("cuda" if device is None else device).type
    if kind == "cpu":
        return [ProfilerActivity.CPU]
    if kind != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: a device trace runs on the card unless the "
            "caller passes device='cpu'")
    return [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def start_device_trace(log_dir: str, device=None) -> None:
    """Begin a torch.profiler session capturing every kernel launch and
    transfer until stopped (CUDA activity on the card, CPU activity
    under ``device="cpu"``)."""
    global _trace_dir, _profiler
    from torch.profiler import profile

    with _lock:
        if _trace_dir is not None:
            raise RuntimeError(f"device trace already active in "
                               f"{_trace_dir!r}")
        prof = profile(activities=_activities(device))
        os.makedirs(log_dir, exist_ok=True)
        prof.start()
        _profiler, _trace_dir = prof, log_dir


def stop_device_trace() -> str:
    """End the session and write its Chrome trace to
    ``<log_dir>/TRACE_FILE``; returns the directory."""
    global _trace_dir, _profiler
    with _lock:
        if _trace_dir is None:
            raise RuntimeError("no device trace active")
        prof, done = _profiler, _trace_dir
        _profiler, _trace_dir = None, None
        prof.stop()
        prof.export_chrome_trace(os.path.join(done, TRACE_FILE))
        return done


def active_trace_dir() -> Optional[str]:
    # Under _lock like every other _trace_dir access: a bare read could
    # observe a torn start/stop transition from another thread.
    with _lock:
        return _trace_dir


class device_trace:
    """Context manager for one-shot traces; a ``log_dir`` of None
    traces nothing."""

    def __init__(self, log_dir: Optional[str], device=None) -> None:
        self.log_dir = log_dir
        self.device = device

    def __enter__(self):
        if self.log_dir:
            start_device_trace(self.log_dir, self.device)
        return self

    def __exit__(self, *exc) -> bool:
        if self.log_dir:
            stop_device_trace()
        return False
