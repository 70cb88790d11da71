"""Device kernels of the window verify: K6, the group-commit applier's
base fit and overlay fold for one window.

Counterpart of the window-verify section of ``nomad_tpu/parallel/mesh.py``
(``_window_verify_jit`` and its wrapper ``window_verify_sharded``).  The
JAX package runs it with the node axis sharded over a mesh of two or
more devices; one card is the one-device case of that mesh, and the
function does not depend on the mesh.  The sharded K2-K4 wrappers (K7)
and ``dispatch_mesh`` come with the multi-card work.

The window's descriptors are tiny (one row per (plan, node) claim,
placement row and fold entry), all padded to ONE shared power-of-two
bucket B; the fleet tensors they index are the ones already resident on
the caller's device, so the cost of a window does not grow with the
fleet.
"""
from __future__ import annotations

import numpy as np
import torch

from nomad_tpu_torch.parallel.devices import PinnedStaging

# Descriptor arrays of one window, in the order the kernel's packed
# buffer holds them: (name, dtype, width; 0 = one value per entry).
DESCRIPTORS = (
    ("pair_ni", np.int32, 0),       # claimed node index per pair (0-pad)
    ("row_pair", np.int32, 0),      # pair index per placement row (0-pad)
    ("seq_ni", np.int32, 0),        # fold-entry node index (-1-pad)
    ("seq_order", np.int32, 0),     # fold-entry window plan index
    ("seq_comp", np.int32, 0),      # fold-entry claim-graph component
    ("pair_order", np.int32, 0),    # pair's window plan index
    ("pair_comp", np.int32, 0),     # pair's claim-graph component
    ("row_vec", np.float32, 4),     # placement resource vectors (0-pad)
    ("seq_vec", np.float32, 4),     # fold-entry delta (adds +, removals -)
    ("pair_removed", np.float32, 4),  # pair's own removed-row sums
)


def window_verify_plain(capacity, reserved, usage, pair_ni, row_pair,
                        row_vec, seq_ni, seq_vec, seq_order, seq_comp,
                        pair_order, pair_comp, pair_removed):
    """Plain version of K6 on tensors of one device: ``used``,
    ``caps`` f32[B, 4] and ``fits`` bool[B] for every pair.

    The fold is a masked [B, B] @ [B, 4] product in fp32 (TF32 stays
    off for fp32 products unless a caller turns it on).  Every value is
    a small integer in fp32, so each sum is exact and independent of
    its order."""
    npair = pair_ni.shape[0]
    ni = pair_ni.long()
    delta = torch.zeros((npair, 4), dtype=torch.float32,
                        device=usage.device)
    delta.index_add_(0, row_pair.long(), row_vec)
    used = usage[ni, :4] + reserved[ni, :4] + delta
    caps = capacity[ni, :4]
    fold = ((seq_ni[None, :] == pair_ni[:, None])
            & (seq_order[None, :] < pair_order[:, None])
            & (seq_comp[None, :] == pair_comp[:, None])).to(torch.float32)
    used_seq = used + fold @ seq_vec - pair_removed
    fits = (used_seq <= caps).all(dim=1)
    return used, caps, fits


def check_descriptors(n: int, desc: dict) -> int:
    """Validate one window's host descriptors against a fleet of ``n``
    rows; returns the bucket B.  Raises on a dtype, shape or index the
    kernel does not take: the kernel reads the rows the indices name
    and checks nothing itself."""
    b = np.asarray(desc["pair_ni"]).shape[0]
    if b < 8 or b & (b - 1):
        raise ValueError(f"bucket {b}: want a power of two >= 8")
    for name, dtype, width in DESCRIPTORS:
        a = desc[name]
        if not isinstance(a, np.ndarray) or a.dtype != dtype:
            raise TypeError(f"{name}: want a numpy {np.dtype(dtype)} array")
        shape = (b, width) if width else (b,)
        if a.shape != shape:
            raise ValueError(f"{name}: shape {a.shape}, want {shape}")
    ni = desc["pair_ni"]
    if ni.min() < 0 or ni.max() >= n:
        raise IndexError(f"pair_ni outside [0, {n})")
    rp = desc["row_pair"]
    if rp.min() < 0 or rp.max() >= b:
        raise IndexError(f"row_pair outside [0, {b})")
    sn = desc["seq_ni"]
    if sn.min() < -1 or sn.max() >= n:
        raise IndexError(f"seq_ni outside [-1, {n})")
    return b


def pack_descriptors(desc: dict, b: int, out=None) -> np.ndarray:
    """The descriptors as the kernel's one int32 buffer (float arrays
    by their bits), so a window uploads in ONE transfer; written into
    ``out`` (an int32[19 * B] array) when given."""
    if out is None:
        out = np.empty(19 * b, dtype=np.int32)
    at = 0
    for name, _dtype, width in DESCRIPTORS:
        size = b * (width or 1)
        out[at:at + size] = np.ascontiguousarray(
            desc[name]).reshape(-1).view(np.int32)
        at += size
    return out


def kernel_counts(desc: dict, counts=None) -> tuple:
    """(pairs, rows, entries): how far K6 walks a window's descriptors.
    The engine builds a window plan by plan, so its real pairs, rows and
    fold entries come first in window order and the padding after them
    adds nothing; the kernel relies on both (``csrc/window_verify.cu``).
    ``counts`` are the caller's real counts, as the engine knows them;
    without them they are derived from the padding: pairs up to the
    last with a positive order (a pair of order 0 folds nothing), rows
    up to the last with a nonzero vector, entries up to the last on a
    node.  Raises ``ValueError`` where a count exceeds the bucket or the
    order the kernel walks in does not hold: pair_order, row_pair and
    seq_order nondecreasing over those counts, seq_order not
    negative."""
    def end(mask, width=1) -> int:
        last = int(np.argmax(mask[::-1]))  # from the end: 0 when none
        n = 0 if not mask[-1 - last] else len(mask) - last
        return -(-n // width)

    if counts is None:
        counts = (end(desc["pair_order"] > 0),
                  end(desc["row_vec"].reshape(-1) != 0, 4),
                  end(desc["seq_ni"] >= 0))
    counts = tuple(int(c) for c in counts)
    for name, n in zip(("pair_order", "row_pair", "seq_order"), counts):
        a = desc[name]
        if not 0 <= n <= len(a):
            raise ValueError(f"{name}: a count of {n} outside its bucket "
                             f"of {len(a)}")
        a = a[:n]
        if (a[1:] < a[:-1]).any():
            raise ValueError(f"{name}: the kernel takes it nondecreasing "
                             f"over the window's first {n} entries")
    if counts[2] and desc["seq_order"][0] < 0:
        raise ValueError("seq_order: the kernel takes no negative order")
    return counts


# One pair's record in K6's output buffer: used f32[4], caps f32[4],
# fits as one byte, three zero bytes.
OUT_BYTES = 36


def pack_results(used, caps, fits):
    """K6's three results as its one output buffer, uint8[B, 36]."""
    b = used.shape[0]
    return torch.cat([
        used.contiguous().view(torch.uint8),
        caps.contiguous().view(torch.uint8),
        fits.view(torch.uint8)[:, None],
        torch.zeros((b, 3), dtype=torch.uint8, device=used.device)], dim=1)


def unpack_results(buf):
    """(used f32[B, 4], caps f32[B, 4], fits bool[B]) of K6's output
    buffer, a uint8[B, 36] tensor (views) or numpy array (after one
    fetch)."""
    if isinstance(buf, np.ndarray):
        f = buf.view(np.float32)
        return f[:, :4], f[:, 4:8], buf[:, 32] != 0
    f = buf.view(torch.float32)
    return f[:, :4], f[:, 4:8], buf[:, 32].view(torch.bool)


# The descriptors' staging buffer in page-locked host memory, one per
# thread (two threads may verify windows at once), reused from window
# to window once the copy out of it has completed.
_UPLOAD = PinnedStaging(torch.int32)


def window_verify(capacity, reserved, usage, packed=False, counts=None,
                  **desc):
    """K6: one window's base fit and overlay fold.

    ``capacity``/``reserved``/``usage`` are the f32[N, 6] fleet tensors
    resident on one device; ``desc`` holds the host (numpy) descriptor
    arrays named in ``DESCRIPTORS``, padded to one bucket B.  For CPU
    tensors the plain version runs; for CUDA tensors the descriptors are
    packed into a pinned staging buffer, go up in one counted transfer
    on the current stream, and ``window_verify_kernel``
    (``csrc/window_verify.cu``) launches behind it.  Returns (used
    f32[B, 4], caps f32[B, 4], fits bool[B]) on that device, not yet
    synchronized: views of one output buffer, which ``packed`` returns
    instead (uint8[B, 36], :func:`unpack_results`), so a caller fetches
    all three in one transfer.  ``counts`` are the window's real
    (pairs, rows, entries) where the caller knows them
    (:func:`kernel_counts`)."""
    from nomad_tpu_torch.ops import kernels

    fleet = dict(capacity=capacity, reserved=reserved, usage=usage)
    device = kernels.route(fleet)
    n, d = usage.shape
    kernels.check_args(fleet, dict(
        capacity=(torch.float32, (n, d)), reserved=(torch.float32, (n, d)),
        usage=(torch.float32, (n, d))))
    if d < 4:
        raise ValueError(f"fleet rows of {d} values: want at least 4")
    b = check_descriptors(n, desc)
    if device.type == "cpu":
        out = window_verify_plain(
            capacity, reserved, usage,
            **{k: torch.from_numpy(desc[k]) for k, _t, _w in DESCRIPTORS})
        return pack_results(*out) if packed else out
    counts = kernel_counts(desc, counts)
    pack_descriptors(desc, b, _UPLOAD.host_view(19 * b))
    buf = launch_window_verify(capacity, reserved, usage,
                               _UPLOAD.upload(19 * b, device), b, counts)
    return buf if packed else unpack_results(buf)


# K6's launches, counted in ``launch_window_verify`` where the kernel
# launches, whichever caller launched it.
window_verify.launches = 0

# Device indices whose K6 shared-memory limit is raised.
_SET_UP: set = set()


def launch_window_verify(capacity, reserved, usage, packed, b: int,
                         counts: tuple):
    """The kernel launch alone, on a packed descriptor buffer already
    on the card (``pack_descriptors``, validated by the caller) and its
    ``kernel_counts``.  Returns the output buffer, uint8[B, 36]."""
    from nomad_tpu_torch.ops import kernels

    device = usage.device
    if packed.dtype != torch.int32 or tuple(packed.shape) != (19 * b,) \
            or packed.device != device or not packed.is_contiguous():
        raise ValueError("packed descriptors: want int32[19 * B] on "
                         f"{device}")
    out = torch.empty((b, OUT_BYTES), dtype=torch.uint8, device=device)
    lib = kernels.library("window_verify")
    if device.index not in _SET_UP:
        with torch.cuda.device(device):
            kernels.check(lib, "window_verify setup",
                          lib.nomad_window_verify_setup())
        _SET_UP.add(device.index)
    code = lib.nomad_window_verify(
        capacity.data_ptr(), reserved.data_ptr(), usage.data_ptr(),
        usage.shape[1], packed.data_ptr(), b, *counts, out.data_ptr(),
        kernels.stream_handle(device))
    kernels.check(lib, "window_verify", code)
    window_verify.launches += 1
    return out
