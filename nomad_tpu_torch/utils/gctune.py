"""Garbage-collection deferral across a scheduling burst.

Counterpart of ``nomad_tpu/utils/gctune.py``: ``gc_pause``, which the
batch runner calls, and ``tune_gc``, which the server calls at boot.  The scheduler hot path churns short-lived
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


def tune_gc(gen0: int = 50_000, gen1: int = 50, gen2: int = 50,
            freeze: bool = True) -> None:
    """Raise collection thresholds and freeze current live objects into
    the permanent generation.  Idempotent; call again after building
    large long-lived structures to freeze them too.

    The domain objects are reference-acyclic; Python's default
    thresholds (700, 10, 10) then trigger frequent full collections
    that scan the whole live store.  GC stays enabled: true cycles are
    still reclaimed, just far less often."""
    if freeze:
        gc.collect()
        gc.freeze()
    gc.set_threshold(gen0, gen1, gen2)
