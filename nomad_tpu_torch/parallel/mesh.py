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


def pack_descriptors(desc: dict, b: int) -> np.ndarray:
    """The descriptors as the kernel's one int32 buffer (float arrays
    by their bits), so a window uploads in ONE transfer."""
    return np.concatenate([
        np.ascontiguousarray(desc[name]).reshape(-1).view(np.int32)
        for name, _dtype, _width in DESCRIPTORS])


def window_verify(capacity, reserved, usage, **desc):
    """K6: one window's base fit and overlay fold.

    ``capacity``/``reserved``/``usage`` are the f32[N, 6] fleet tensors
    resident on one device; ``desc`` holds the host (numpy) descriptor
    arrays named in ``DESCRIPTORS``, padded to one bucket B.  For CPU
    tensors the plain version runs; for CUDA tensors the descriptors go
    up in one counted transfer and ``window_verify_kernel``
    (``csrc/window_verify.cu``) launches on the current stream.
    Returns (used f32[B, 4], caps f32[B, 4], fits bool[B]) on that
    device, not yet synchronized."""
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
        return window_verify_plain(
            capacity, reserved, usage,
            **{k: torch.from_numpy(desc[k]) for k, _t, _w in DESCRIPTORS})
    from nomad_tpu_torch.parallel.devices import put_counted

    packed = put_counted(pack_descriptors(desc, b), device)
    return launch_window_verify(capacity, reserved, usage, packed, b)


# K6's launches, counted in ``launch_window_verify`` where the kernel
# launches, whichever caller launched it.
window_verify.launches = 0


def launch_window_verify(capacity, reserved, usage, packed, b: int):
    """The kernel launch alone, on a packed descriptor buffer already
    on the card (``pack_descriptors``, validated by the caller)."""
    from nomad_tpu_torch.ops import kernels

    device = usage.device
    if packed.dtype != torch.int32 or tuple(packed.shape) != (19 * b,) \
            or packed.device != device or not packed.is_contiguous():
        raise ValueError("packed descriptors: want int32[19 * B] on "
                         f"{device}")
    d = usage.shape[1]
    used = torch.empty((b, 4), dtype=torch.float32, device=device)
    caps = torch.empty((b, 4), dtype=torch.float32, device=device)
    fits = torch.empty((b,), dtype=torch.bool, device=device)
    lib = kernels.library("window_verify")
    code = lib.nomad_window_verify(
        capacity.data_ptr(), reserved.data_ptr(), usage.data_ptr(), d,
        packed.data_ptr(), b, used.data_ptr(), caps.data_ptr(),
        fits.data_ptr(), kernels.stream_handle(device))
    kernels.check(lib, "window_verify", code)
    window_verify.launches += 1
    return used, caps, fits
