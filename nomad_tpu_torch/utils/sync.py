"""Typed concurrency annotations the lock lint enforces.

PR 1's allowlist accumulated a pile of ``bare-read`` waivers whose
justifications all said one of two things: "immutable after __init__" or
"rebound atomically by copy-swap".  Those are *contracts*, and a waiver
ledger is the wrong place for a contract — nothing ever checks that the
attribute actually stays immutable, so the justification rots silently.

These markers move the contract into the type surface where
``nomad_tpu/analysis/lockcheck.py`` can verify it:

``Immutable``
    The attribute is bound once before the object is published (in
    ``__init__`` or a constructor-only helper) and never rebound.
    Bare reads are exempt from the discipline pass; ANY later write —
    even a lock-guarded one — is reported as ``immutable-write``.

``CopySwap``
    The attribute is atomically rebound to a fresh immutable value by
    writers holding the lock (the read-copy-update idiom: readers see
    the old or the new object, never a torn one).  Bare reads are
    exempt; writes outside the lock are still ``bare-write``.

Usage (annotation only — zero runtime behavior)::

    self.addr: Immutable = sock.getsockname()
    self.alloc: CopySwap = alloc      # rebound under _publish_lock

Subscripted forms (``Immutable[str]``) work too.  The classes are
deliberately inert: they exist so the annotation names something
importable and greppable.
"""
from __future__ import annotations

__all__ = ["Immutable", "CopySwap"]


class _Marker:
    """Annotation-only: subscriptable, never instantiated."""

    def __init__(self) -> None:
        raise TypeError(f"{type(self).__name__} is an annotation marker, "
                        "not a runtime type")

    def __class_getitem__(cls, item):
        return cls


class Immutable(_Marker):
    """Bound once pre-publication; reads need no lock, writes forbidden."""


class CopySwap(_Marker):
    """Atomically rebound under the lock; reads need no lock."""
