"""CUDA events around the port's device work, for the traced run.

Events are recorded on the current stream around every kernel launch of
the port's libraries (each ``nomad_*`` entry point of
``kernels.PROTOTYPES`` but the plan queries) and around each call of the
port's device seams (``put_counted``, ``ensure_on_default``,
``copy_to_host_async``).  The stream time between a call's two events
is the card's work for it, plus any stretch inside the call where the
card waited on the host (a pageable upload's staging); the union of
those intervals is the card's busy time, an upper bound.

The Python wrappers of the kernels (K2-K6, ``shard_walk``) are wrapped
too, only to note each launch's logical shapes for ``kernels/<name>.py``.
torch.profiler is not used: on the chip machine it drops device events
at random.
"""
from __future__ import annotations

import functools
import inspect
import sys
import threading
import time

# ctypes entry point -> kernel name (the name of its bytes formula)
ENTRY_KERNEL = {
    "nomad_place_sequence": "K2",
    "nomad_place_rounds": "K3",
    "nomad_place_rounds_batch": "K4a",
    "nomad_place_sequence_batch": "K4b",
    "nomad_scatter_rows": "K5",
    "nomad_window_verify": "K6",
    "nomad_window_verify_sharded": "K6_sharded",
    "nomad_shard_walk": "shard_walk",
    "nomad_shard_step": "shard_step",
    "nomad_merge_select": "K7b",
    "nomad_shard_gather": "K7d",
}
# (module, Python wrapper) -> kernel name
WRAPPERS = {
    ("nomad_tpu_torch.ops.binpack", "place_sequence"): "K2",
    ("nomad_tpu_torch.ops.binpack", "place_rounds"): "K3",
    ("nomad_tpu_torch.ops.binpack", "place_rounds_batch"): "K4a",
    ("nomad_tpu_torch.ops.binpack", "place_sequence_batch"): "K4b",
    ("nomad_tpu_torch.models.fleet", "scatter_rows"): "K5",
    ("nomad_tpu_torch.parallel.mesh", "window_verify"): "K6",
    ("nomad_tpu_torch.ops.binpack", "shard_walk"): "shard_walk",
}
SEAMS = ("put_counted", "ensure_on_default", "copy_to_host_async")


def _shapes(kernel: str, args: dict) -> dict:
    """A launch's logical shapes from its wrapper's arguments.  Tensors
    whose contents a formula needs (a sequence's group index) are kept
    by reference and read after the window."""
    if kernel in ("K2", "K4b"):
        gi = args["group_idx"]
        feas = args["feasible"]
        return dict(n=int(args["capacity"].shape[0]),
                    lanes=1 if feas.dim() == 2 else int(feas.shape[0]),
                    g=int(feas.shape[-2]), p=int(gi.shape[-1]),
                    group_idx=gi)
    if kernel in ("K3", "K4a"):
        feas = args["feasible"]
        return dict(n=int(args["capacity"].shape[0]),
                    lanes=1 if feas.dim() == 2 else int(feas.shape[0]),
                    g=int(feas.shape[-2]), k_cap=int(args["k_cap"]),
                    rounds=int(args["rounds"]))
    if kernel == "K5":
        return dict(n=int(args["usage"].shape[0]),
                    d=int(args["usage"].shape[1]),
                    r=int(args["idx"].shape[0]))
    if kernel == "K6":
        from nomad_tpu_torch.parallel import mesh
        pairs, rows, seq = mesh.kernel_counts(args["desc"], args["counts"])
        return dict(n=int(args["usage"].shape[0]), pairs=pairs, rows=rows,
                    seq=seq)
    if kernel == "shard_walk":
        from nomad_tpu_torch.ops import binpack
        shards = args["shards"]
        rows, lanes, g, p, _k, _kout, _steps = binpack._walk_shape(
            shards, args["k_cap"], args["rounds"])
        out = dict(n=rows * len(shards), lanes=lanes, g=g,
                   k_cap=int(args["k_cap"]), rounds=int(args["rounds"]))
        if args.get("valid") is not None:
            out.update(p=p, group_idx=shards[0]["group_idx"])
        return out
    return {}


class Timeline:
    """Install with :meth:`install`; ``records`` then gathers
    (name, kind, start event, end event, host instant, shapes) for each
    timed call, kind ``kernel`` or ``seam``."""

    def __init__(self, torch):
        self.torch = torch
        self.records: list = []
        self._saved: list = []
        self._local = threading.local()
        self.base = None
        self.t_base = None

    # -- wrapping -----------------------------------------------------------
    def _timed(self, fn, name, kind):
        torch, records, local = self.torch, self.records, self._local

        def call(*a, **kw):
            if getattr(local, "depth", 0):
                return fn(*a, **kw)
            local.depth = 1
            shapes = getattr(local, "shapes", None) if kind == "kernel" \
                else None
            t0 = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                return fn(*a, **kw)
            finally:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                records.append((name, kind, start, end, t0, shapes))
                local.depth = 0
        return call

    def _shaped(self, fn, kernel):
        local = self._local
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def call(*a, **kw):
            bound = sig.bind(*a, **kw)
            bound.apply_defaults()
            args = dict(bound.arguments)  # K6's **desc arrives as "desc"
            try:
                local.shapes = dict(_shapes(kernel, args), kernel=kernel)
            except Exception:  # noqa: BLE001 - a shape we cannot read
                local.shapes = None
            try:
                return fn(*a, **kw)
            finally:
                local.shapes = None
        return call

    def _patch_everywhere(self, original, replacement) -> None:
        for name, module in list(sys.modules.items()):
            if module is None or name.split(".")[0] != "nomad_tpu_torch":
                continue
            for attr, value in list(vars(module).items()):
                if value is original:
                    self._saved.append((module, attr, value))
                    setattr(module, attr, replacement)

    def install(self) -> None:
        from nomad_tpu_torch.ops import kernels
        from nomad_tpu_torch.parallel import devices

        torch = self.torch
        for lib_name, protos in kernels.PROTOTYPES.items():
            lib = kernels.library(lib_name)
            for fn in protos:
                if fn.endswith(("_plan", "_setup")):
                    continue
                value = getattr(lib, fn)
                self._saved.append((lib, fn, value))
                setattr(lib, fn, self._timed(
                    value, ENTRY_KERNEL.get(fn, fn), "kernel"))
        for (mod_name, attr), kernel in WRAPPERS.items():
            module = sys.modules.get(mod_name)
            if module is None:
                __import__(mod_name)
                module = sys.modules[mod_name]
            original = getattr(module, attr)
            self._patch_everywhere(original, self._shaped(original, kernel))
        for seam in SEAMS:
            original = getattr(devices, seam)
            self._patch_everywhere(original,
                                   self._timed(original, seam, "seam"))
        torch.cuda.synchronize()
        self.base = torch.cuda.Event(enable_timing=True)
        self.base.record()
        torch.cuda.synchronize()
        self.t_base = time.perf_counter()

    def uninstall(self) -> None:
        for owner, attr, value in reversed(self._saved):
            current = getattr(owner, attr)
            launches = getattr(current, "launches", None)
            if launches is not None and hasattr(value, "launches"):
                value.launches = launches
            setattr(owner, attr, value)
        self._saved.clear()

    # -- reading ------------------------------------------------------------
    def intervals(self, t_open: float, t_close: float) -> list:
        """(name, kind, start s, end s, shapes) on the host's clock for
        every timed call that began inside [t_open, t_close], clipped to
        it.  Synchronizes the card."""
        self.torch.cuda.synchronize()
        out = []
        for name, kind, start, end, t0, shapes in list(self.records):
            if not t_open <= t0 <= t_close:
                continue
            a = self.t_base + self.base.elapsed_time(start) / 1e3
            b = self.t_base + self.base.elapsed_time(end) / 1e3
            out.append((name, kind, max(a, t_open), min(max(a, b),
                                                          t_close), shapes))
        return out
