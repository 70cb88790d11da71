"""Device seams: ONE authority for "which device do we compute on", and
the counted host<->device transfers.

Counterpart of ``nomad_tpu/parallel/devices.py`` on PyTorch.  The port
computes on the card unless the caller asks for the CPU: a device
argument of ``None`` means the process default, which is ``cuda``
until :func:`set_device` says otherwise, and resolving ``cuda`` with no
CUDA device present raises ``RuntimeError`` (there is no fallback to
the CPU).  Tests pass ``"cpu"`` explicitly.

Every explicit transfer the runtime performs goes through the seams
below and is counted on the transfer odometer, so "how many transfers
per eval" is a number a run can record.  :func:`fetch_host` is the one
device->host seam: a non-blocking copy into pinned host memory, then a
wait on a CUDA event recorded after it.
"""
from __future__ import annotations

import threading

from typing import Optional

import numpy as np
import torch

# -- transfer accounting ----------------------------------------------------

_TRANSFER_LOCK = threading.Lock()
_TRANSFERS = {"h2d": 0, "d2h": 0, "d2d": 0}


def note_transfer(kind: str, n: int = 1) -> None:
    """Count ``n`` explicit transfers of ``kind`` ("h2d"/"d2h"/"d2d")."""
    with _TRANSFER_LOCK:
        _TRANSFERS[kind] += n


def transfer_counts() -> dict:
    """Snapshot of the process-lifetime explicit-transfer counters."""
    with _TRANSFER_LOCK:
        return dict(_TRANSFERS)


# -- device resolution ------------------------------------------------------

_DEFAULT: list = ["cuda"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a concrete ``torch.device`` (``cuda`` gains the
    current index, so equal devices compare equal); ``None`` means
    :func:`default_device`.  Raises ``RuntimeError`` for ``cuda`` when
    no CUDA device is present."""
    if device is None:
        device = _DEFAULT[0]
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: nomad_tpu_torch runs on the card unless "
                "the caller passes device='cpu'")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def default_device() -> torch.device:
    """The device an entry point given no device computes on."""
    return resolve_device(None)


def set_device(device) -> str:
    """Make ``device`` the process default; returns the previous
    default (as given) so a caller can restore it."""
    torch.device(device)  # validate the spelling now
    prev = _DEFAULT[0]
    _DEFAULT[0] = str(device)
    return prev


def on_default_platform(t, device=None) -> bool:
    """Is this cached tensor resident on ``device`` (the default when
    None)?  Device caches call this and re-upload on a mismatch."""
    return isinstance(t, torch.Tensor) and t.device == resolve_device(device)


def ensure_on_default(cached, host, device=None):
    """Device copy of ``host`` on ``device``, reusing ``cached`` when it
    is still resident there (returned by identity, so callers can
    detect a re-upload)."""
    if cached is not None and on_default_platform(cached, device):
        return cached
    return put_counted(host, device)


def put_counted(x, device=None):
    """EXPLICIT placement of one host value (numpy array or scalar) or
    tensor onto ``device`` (counted).  A tensor already there passes
    through untouched; a host value is always copied, so the device
    copy never aliases a host array the caller may reuse."""
    device = resolve_device(device)
    if isinstance(x, torch.Tensor):
        if x.device == device:
            return x
        note_transfer(_classify(x.device, device))
        return x.to(device, copy=True)
    note_transfer("h2d")
    return torch.tensor(np.asarray(x), device=device)


def _classify(src: torch.device, dst: torch.device) -> str:
    if src.type == "cpu" and dst.type != "cpu":
        return "h2d"
    if dst.type == "cpu" and src.type != "cpu":
        return "d2h"
    return "d2d"


class PendingHost:
    """A device->host copy in flight: the pinned host tensor it lands
    in and the CUDA event recorded after it."""

    __slots__ = ("host", "event")

    def __init__(self, host: torch.Tensor,
                 event: Optional["torch.cuda.Event"]) -> None:
        self.host = host
        self.event = event


def copy_to_host_async(x) -> PendingHost:
    """Start the device->host copy of a tensor without waiting for it
    (counted); :func:`fetch_host` finishes it.  A CPU tensor needs no
    copy and comes back as it is."""
    if x.device.type == "cpu":
        return PendingHost(x, None)
    note_transfer("d2h")
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(x.device))
    return PendingHost(host, event)


def fetch_host(x):
    """EXPLICIT device->host fetch: the one sanctioned way a device
    result becomes a numpy array.  Takes a tensor or a copy already in
    flight (:func:`copy_to_host_async`); host values pass through."""
    if isinstance(x, torch.Tensor):
        x = copy_to_host_async(x)
    if isinstance(x, PendingHost):
        if x.event is not None:
            x.event.synchronize()
        return x.host.numpy()
    return x
