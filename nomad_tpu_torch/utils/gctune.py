"""Garbage-collection deferral across a scheduling burst.

Counterpart of ``nomad_tpu/utils/gctune.py`` (only ``gc_pause``, which
the batch runner calls).  The scheduler hot path churns short-lived
acyclic objects (Allocations, AllocMetrics, Resources offers) while the
state store keeps hundreds of thousands of long-lived objects alive;
young-generation collections in the middle of a fused batch promote
every survivor and scan the live store.
"""
from __future__ import annotations

import contextlib
import gc
import threading

_pause_lock = threading.Lock()
_pause_depth = 0
_pause_was_enabled = False


@contextlib.contextmanager
def gc_pause():
    """Defer collections across a bounded scheduling burst.

    A fused batch creates thousands of tracked objects per eval; the
    burst is bounded, the domain objects are reference-acyclic, and
    collection resumes on exit — deferral, not leakage.

    Nest-safe and thread-safe via a refcount: bursts may overlap across
    threads.  The outermost enter saves the gc state, the last exit
    restores it."""
    global _pause_depth, _pause_was_enabled
    with _pause_lock:
        if _pause_depth == 0:
            _pause_was_enabled = gc.isenabled()
            gc.disable()
        _pause_depth += 1
    try:
        yield
    finally:
        with _pause_lock:
            _pause_depth -= 1
            if _pause_depth == 0 and _pause_was_enabled:
                gc.enable()
