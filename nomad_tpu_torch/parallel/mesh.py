"""Device meshes for the scheduler: the node axis sharded over devices.

Counterpart of ``nomad_tpu/parallel/mesh.py``.  The problem dimension
that grows is the fleet (nodes x task groups), so the node axis of every
fleet tensor can be split over a mesh of devices: each shard holds
``n_pad / fleet_ways`` rows (both powers of two) as tensors of its own on
its own device, and a storm's lanes can be split over a second axis
(:func:`storm_mesh`).  A :class:`Mesh` is a grid of ``torch.device``
entries with the JAX package's axis names; a sharded operand
(:class:`Sharded`) is the list of its per-shard tensors in the mesh's
device order.

:func:`dispatch_mesh` is the one authority on whether a dispatch
shards, with the JAX package's rule and its ``NOMAD_TPU_MESH`` lever.
It counts distinct CUDA devices, so on one card it returns None and the
unsharded kernels run.  :func:`mesh_override` also takes a device list,
which may name one device several times (a test's eight ``cpu``
entries, four ``cuda:0`` shards on one card): the port's counterpart of
the JAX tests' forced host device count.

The sharded forms (K7) compute exactly what the unsharded kernels do.
XLA turned the JAX forms' argmax and top_k over the sharded axis into
per-shard work and a cross-shard merge.  Here the layout decides the
route (:func:`walk_route`), before any launch: a mesh row whose shards
all sit on one card (at most ``STEP_SHARDS`` of them) runs a whole walk
as ONE shard_walk launch (a thread-block cluster a lane, the merge in
distributed shared memory); a row whose shards span cards takes every
step as one shard_step launch (K7a+c) per card, over that card's shards
(the previous step's winners applied, then the shard's best candidates
selected), and K7b on the row's lead device, with one tail shard_step a
card after the last step (``ops/binpack.py``, ``csrc/binpack.cu``).  The
window verify is one launch of K6's sharded form, which reads the lead
card's shards in place; a shard on another card sends its rows' partial
gathered by K7d (``csrc/window_verify.cu``).  One process drives every
shard: small candidate, update and partial buffers travel between
devices with ``copy_(non_blocking=True)``, which PyTorch orders against
the current streams of both devices.  On the CPU every kernel's plain
version runs, on the same routes.

The window verify (K6): the descriptors of one window are tiny (one row
per (plan, node) claim, placement row and fold entry), all padded to ONE
shared power-of-two bucket B; the fleet tensors they index are the ones
already resident on the caller's device (or on the mesh's shards), so
the cost of a window does not grow with the fleet.
"""
from __future__ import annotations

import contextlib
import ctypes
import os

import numpy as np
import torch

from nomad_tpu_torch.obs import trace as obs_trace
from nomad_tpu_torch.ops.binpack import STEP_SHARDS
from nomad_tpu_torch.parallel.devices import (
    PinnedStaging,
    classify_move,
    default_platform_devices,
    note_transfer,
)

FLEET_AXIS = "fleet"
LANE_AXIS = "lanes"

# -- mesh resolution: the ONE authority ------------------------------------
# Every dispatch that could shard the node axis asks dispatch_mesh(); the
# answer is a property of the platform (the distinct devices) and the
# dispatch shape, overridable by NOMAD_TPU_MESH ("off"/"0" forces the
# unsharded kernels, an integer caps the device count), as in the JAX
# package.

ENV_VAR = "NOMAD_TPU_MESH"

_MESH_CACHE: dict = {}
# Process override installed by mesh_override(); a one-element holder so
# readers never see a torn update.
_OVERRIDE: list = [None]


def _mesh_policy():
    """Resolved policy: "off", "auto", an int device cap, or the list
    of devices a mesh_override named."""
    value = _OVERRIDE[0]
    if isinstance(value, list):
        return value
    if value is None:
        value = os.environ.get(ENV_VAR, "auto")
    value = str(value).strip().lower() or "auto"
    if value in ("off", "none", "0"):
        return "off"
    if value.isdigit():
        return int(value)
    return "auto"


@contextlib.contextmanager
def mesh_override(value):
    """Temporarily force the mesh policy: "off", "auto", a device count,
    or a list of devices that stands in for the platform's (it may
    repeat a device: eight ``cpu`` entries in the tests, four
    ``cuda:0`` shards on one card in ``chip_smoke.py``)."""
    prior = _OVERRIDE[0]
    if isinstance(value, (list, tuple)):
        value = [torch.device(d) for d in value]
    _OVERRIDE[0] = value
    try:
        yield
    finally:
        _OVERRIDE[0] = prior


def dispatch_mesh(n_lanes: int, n_pad: int, device=None):
    """Mesh for a dispatch of ``n_lanes`` evals over an ``n_pad``-wide
    (power-of-two) node axis, or None when one device (or the "off"
    policy, or a shape that cannot split) makes the unsharded kernels
    the right call.  ``device`` is the caller's (None: the process
    default): a caller on the CPU gets no mesh unless an override names
    its devices, and a caller that names a card (``cuda:1``) gets a mesh
    led by that card, so results and resident twins land where its
    server computes.

    The JAX package's rule: a power-of-two subset of the devices; lane
    ways the largest power of two dividing ``n_lanes``, capped at half
    the devices so the fleet axis keeps width; the rest shard the node
    axis, capped so that they divide it.  ``n_lanes == 1`` resolves a
    1-D fleet mesh; a storm gets the 2-D ``(lanes, fleet)`` layout when
    its shape splits.  Meshes are cached, so equal requests get the same
    object and residency keys that hold it hit across calls."""
    policy = _mesh_policy()
    if policy == "off":
        return None
    if isinstance(policy, list):
        all_devices = policy
    else:
        all_devices = default_platform_devices(device)
        lead = None if device is None else torch.device(device).index
        if lead is not None and lead < len(all_devices):
            all_devices = all_devices[lead:] + all_devices[:lead]
    n_dev = len(all_devices)
    if isinstance(policy, int):
        n_dev = min(n_dev, policy)
    if n_dev < 2:
        return None
    n = 1 << (n_dev.bit_length() - 1)  # power-of-two subset
    lane_ways = 1
    while lane_ways * 2 <= min(n // 2, n_lanes) and \
            n_lanes % (lane_ways * 2) == 0:
        lane_ways *= 2
    # Fleet ways must divide the padded node axis (both powers of two,
    # so <= suffices); tiny fleets on big hosts use fewer devices.
    n = min(n, lane_ways * max(1, n_pad))
    if n < 2:
        return None
    devices = tuple(all_devices[:n])
    key = (devices, lane_ways)
    mesh = _MESH_CACHE.get(key)
    if mesh is None:
        mesh = storm_mesh(lane_ways, devices) if lane_ways > 1 \
            else fleet_mesh(devices)
        _MESH_CACHE[key] = mesh
    return mesh


class Mesh:
    """A grid of devices with named axes, the counterpart of
    ``jax.sharding.Mesh``: ``(fleet,)`` (one row) or ``(lanes, fleet)``.
    Hashable and compared by its devices and axis names, so it can key
    the residency caches (models/fleet.py ShardedResidency)."""

    __slots__ = ("grid", "axis_names", "_key")

    def __init__(self, grid, axis_names: tuple) -> None:
        self.grid = tuple(tuple(torch.device(d) for d in row)
                          for row in grid)
        self.axis_names = tuple(axis_names)
        widths = {len(row) for row in self.grid}
        if not self.grid or len(widths) != 1 or 0 in widths:
            raise ValueError("a mesh is a non-empty rectangular grid")
        if len({d.type for d in self.devices}) != 1:
            raise ValueError("a mesh's devices are all cpu or all cuda")
        self._key = (self.grid, self.axis_names)

    @property
    def lane_ways(self) -> int:
        return len(self.grid)

    @property
    def fleet_ways(self) -> int:
        return len(self.grid[0])

    @property
    def shape(self) -> dict:
        if self.axis_names == (FLEET_AXIS,):
            return {FLEET_AXIS: self.fleet_ways}
        return {LANE_AXIS: self.lane_ways, FLEET_AXIS: self.fleet_ways}

    @property
    def devices(self) -> tuple:
        """Every position's device, row by row (a device may repeat)."""
        return tuple(d for row in self.grid for d in row)

    @property
    def lead(self) -> torch.device:
        """Where merges run and results land: the first position's."""
        return self.grid[0][0]

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices]})"


def fleet_mesh(devices=None) -> Mesh:
    """1-D mesh over the given devices (the platform's by default);
    axis name 'fleet'."""
    if devices is None:
        devices = default_platform_devices()
    return Mesh([list(devices)], (FLEET_AXIS,))


def storm_mesh(lane_ways: int, devices=None) -> Mesh:
    """2-D mesh ``(lanes, fleet)``: storm lanes data-parallel across one
    axis, the node axis sharded across the other.  Each lane row holds a
    fleet replica serving B / lane_ways evals."""
    if devices is None:
        devices = default_platform_devices()
    devices = list(devices)
    n = len(devices)
    if lane_ways <= 0 or n % lane_ways:
        raise ValueError(
            f"lane_ways {lane_ways} must divide device count {n}")
    width = n // lane_ways
    return Mesh([devices[r * width:(r + 1) * width]
                 for r in range(lane_ways)], (LANE_AXIS, FLEET_AXIS))


# -- sharded operands ------------------------------------------------------
# A spec names, per leading dimension, the mesh axis that splits it (None:
# whole), as a PartitionSpec does.  A lane spec on a 1-D fleet mesh leaves
# the lanes whole (every shard serves every lane).

NODE = (FLEET_AXIS,)                          # [N, ...] row-sharded
GROUP_NODE = (None, FLEET_AXIS)               # [G, N]
REPL = ()                                     # replicated
LANE = (LANE_AXIS,)                           # [B, ...] per lane row
LANE_N = (LANE_AXIS, FLEET_AXIS)              # [B, N]
LANE_NODE = (LANE_AXIS, None, FLEET_AXIS)     # [B, G, N]


class Sharded(list):
    """A sharded operand: its per-shard tensors in the mesh's position
    order (row by row), each on its position's device, with the mesh,
    the spec that cut it and its global shape.  Positions that hold the
    same slice on the same device share one tensor.  Never written in
    place: an update makes new shard tensors."""

    def __init__(self, shards, mesh: Mesh, spec: tuple, shape: tuple):
        super().__init__(shards)
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shape = tuple(shape)

    @property
    def dtype(self):
        return self[0].dtype


def _slices(spec: tuple, shape: tuple, mesh: Mesh, r: int, c: int) -> tuple:
    """Position (r, c)'s slice of a global array of ``shape``."""
    out = []
    for dim, size in enumerate(shape):
        axis = spec[dim] if dim < len(spec) else None
        ways, at = 1, 0
        if axis == FLEET_AXIS:
            ways, at = mesh.fleet_ways, c
        elif axis == LANE_AXIS and LANE_AXIS in mesh.axis_names:
            ways, at = mesh.lane_ways, r
        if size % ways:
            raise ValueError(f"dimension {dim} of {size} does not split "
                             f"{ways} ways over the {axis} axis")
        width = size // ways
        out.append(slice(at * width, (at + 1) * width))
    return tuple(out)


def _bounds(sl: tuple) -> tuple:
    return tuple((s.start, s.stop) for s in sl)


def _shard(x, mesh: Mesh, spec: tuple) -> Sharded:
    """``x`` (a numpy array or scalar, a tensor or a Sharded) cut by
    ``spec`` onto ``mesh``, every shard a copy of its own (uncounted:
    the seams that call it count)."""
    spec = tuple(spec)
    if isinstance(x, Sharded):
        if x.mesh == mesh and x.spec == spec:
            return x
        x = gather(x)
    if isinstance(x, torch.Tensor):
        src = x
    else:
        # devlint-ok(transfer-in-hot-loop): host data here (a tensor or
        # a Sharded took the branches above); nothing leaves a card.
        a = np.asarray(x)
        src = torch.from_numpy(a if a.flags.c_contiguous else a.copy())
    shape = tuple(src.shape)
    made: dict = {}
    shards = []
    for r, row in enumerate(mesh.grid):
        for c, dev in enumerate(row):
            sl = _slices(spec, shape, mesh, r, c)
            key = (dev, _bounds(sl))
            t = made.get(key)
            if t is None:
                t = made[key] = src[sl].to(dev, copy=True).contiguous()
            shards.append(t)
    return Sharded(shards, mesh, spec, shape)


def _put(x, mesh: Mesh, spec: tuple):
    """EXPLICIT placement of ``x`` on ``mesh`` cut by ``spec`` (one
    counted transfer per array, as the JAX package's ``_put`` counts),
    skipped for an operand already resident with that layout: the seam
    that lets the mesh-resident fleet tensors (the sharded usage mirror,
    capacity/reserved) flow into the sharded kernels without a
    per-dispatch upload."""
    if isinstance(x, Sharded):
        if x.mesh == mesh and x.spec == tuple(spec):
            return x
        kind = "d2d"
    elif isinstance(x, torch.Tensor):
        kind = classify_move(x.device.type, mesh.lead.type)
    else:
        kind = "h2d"
    note_transfer(kind)
    return _shard(x, mesh, spec)


def gather(x: Sharded, device=None) -> torch.Tensor:
    """The whole of a sharded operand as one tensor on ``device`` (the
    mesh's lead by default)."""
    device = x.mesh.lead if device is None else torch.device(device)
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    if any(t.device != device for t in x):
        note_transfer(classify_move(x[0].device.type, device.type))
    seen = set()
    width = x.mesh.fleet_ways
    for pos, t in enumerate(x):
        sl = _slices(x.spec, x.shape, x.mesh, *divmod(pos, width))
        if _bounds(sl) not in seen:
            seen.add(_bounds(sl))
            out[sl].copy_(t)
    return out


def shard_fleet_arrays(mesh: Mesh, capacity, reserved, usage, job_counts,
                       feasible):
    """Place fleet tensors on the mesh, node axis sharded."""
    return (_put(capacity, mesh, NODE), _put(reserved, mesh, NODE),
            _put(usage, mesh, NODE), _put(job_counts, mesh, NODE),
            _put(feasible, mesh, GROUP_NODE))


# -- the sharded walks (shard_walk on one card; K7a+c and K7b across) -----

# The route of each mesh row of every sharded walk, counted as the walks
# take them: "shard_walk" (one launch a row and walk) or "shard_step"
# (shard_step a card and step, K7b a step).
WALK_ROUTES = {"shard_walk": 0, "shard_step": 0}


def walk_route(devices) -> str:
    """The route of a mesh row over ``devices`` (its positions' devices),
    from the layout alone: "shard_walk" where they form one launch group
    (every shard on one card, at most ``STEP_SHARDS`` of them), else
    "shard_step"."""
    return "shard_walk" if len(device_groups(devices)) == 1 else \
        "shard_step"


def device_groups(devices, cap: int = STEP_SHARDS) -> list:
    """One mesh row's shard positions grouped for shard_step, one launch
    a group: ``(device, [positions])`` in the order each device first
    appears, each device's positions in order, cut into runs of at most
    ``cap`` (the kernel's shards a launch)."""
    by_device: dict = {}
    for c, d in enumerate(devices):
        by_device.setdefault(torch.device(d), []).append(c)
    return [(d, cs[i:i + cap]) for d, cs in by_device.items()
            for i in range(0, len(cs), cap)]


def _runs(cs: list) -> list:
    """(lead index, local index) pairs that copy a group's per-shard
    buffers to and from the lead's: one slice pair where its positions
    are contiguous, else one pair a position."""
    if cs == list(range(cs[0], cs[0] + len(cs))):
        return [(slice(cs[0], cs[0] + len(cs)), slice(None))]
    return list(zip(cs, range(len(cs))))


class _Group:
    """One shard_step launch of a mesh row: the operands of its shards,
    its checked plan once the first step has made it, and, on a card
    other than the row's lead, the copies that carry its candidates to
    the lead and the lead's updates back (views made once a walk)."""

    __slots__ = ("shards", "plan", "to_lead", "to_local")

    def __init__(self, shards, to_lead=(), to_local=()) -> None:
        self.shards, self.plan = shards, None
        self.to_lead, self.to_local = to_lead, to_local


class _WalkRow:
    """One mesh row's share of a sharded walk: its lanes' state on every
    shard (usage and job counts, evolved from copies of the base) and
    the walk's results on the lead; on the shard_walk route one launch
    runs the whole walk.  ``ops`` maps each operand to its tensor at
    each mesh position, in the batch layout (a leading lane axis)."""

    def __init__(self, mesh: Mesh, r: int, ops: dict, seq: bool,
                 k_cap: int, rounds: int) -> None:
        width = mesh.fleet_ways
        self.devs = mesh.grid[r]
        self.lead = lead = self.devs[0]
        self.k_cap, self.rounds = k_cap, rounds

        def row(name):
            return [ops[name][r * width + c] for c in range(width)]

        self.cols = {name: row(name) for name in (
            "capacity", "reserved", "feasible", "asks", "distinct",
            "penalty")}
        self.cols["group_idx"] = row("group_idx") if seq else [None] * width
        jc = row("job_counts")
        self.lanes, self.rows = jc[0].shape
        lanes = self.lanes
        # Each lane's own copy of the base, as the vmap's carry.
        self.usage = [u.repeat(lanes, 1, 1) for u in row("usage0")]
        self.jc = [j.clone() for j in jc]
        f32, i32 = torch.float32, torch.int32
        self.counts = self.valid = None
        if seq:
            self.valid = ops["valid"][r * width]
            shape = (lanes, self.cols["group_idx"][0].shape[1])
        else:
            self.counts = ops["counts"][r * width]
            shape = (lanes, self.cols["asks"][0].shape[1], rounds * k_cap)
        self.chosen = torch.empty(shape, dtype=i32, device=lead)
        self.scores = torch.empty(shape, dtype=f32, device=lead)

    def shards(self) -> list:
        """The row's shards as shard_walk takes them."""
        return [dict({name: col[c] for name, col in self.cols.items()},
                     usage=self.usage[c], job_counts=self.jc[c],
                     row_lo=c * self.rows) for c in range(len(self.devs))]

    def walk(self) -> None:
        from nomad_tpu_torch.ops import binpack

        binpack.shard_walk(self.shards(), self.chosen, self.scores,
                           k_cap=self.k_cap, rounds=self.rounds,
                           valid=self.valid, counts=self.counts)


class _Row(_WalkRow):
    """One mesh row's share of a sharded walk on the shard_step route
    (its shards span cards, or outnumber a launch): beside
    :class:`_WalkRow`'s state, the candidate and update buffers on the
    row's lead device and its shards grouped by device, one shard_step
    launch a group and step."""

    def __init__(self, mesh: Mesh, r: int, ops: dict, seq: bool,
                 k_cap: int, rounds: int) -> None:
        super().__init__(mesh, r, ops, seq, k_cap, rounds)
        lanes, lead, width = self.lanes, self.lead, len(self.devs)
        self.k = k = 1 if seq else min(k_cap, self.rows)
        kout = 1 if seq else k_cap
        f32, i32 = torch.float32, torch.int32
        self.cand_v = torch.empty((width, lanes, k), dtype=f32, device=lead)
        self.cand_i = torch.empty((width, lanes, k), dtype=i32, device=lead)
        self.upd = torch.empty((width, lanes, kout), dtype=i32, device=lead)
        row_shards = self.shards()
        self.groups = []
        for dev, cs in device_groups(self.devs):
            if dev == lead:
                cand_v, cand_i, upd, at = self.cand_v, self.cand_i, \
                    self.upd, cs
            else:
                m = len(cs)
                cand_v = torch.empty((m, lanes, k), dtype=f32, device=dev)
                cand_i = torch.empty((m, lanes, k), dtype=i32, device=dev)
                upd = torch.empty((m, lanes, kout), dtype=i32, device=dev)
                at = range(m)
            shards = [dict(row_shards[c], out=(cand_v[j], cand_i[j]),
                           upd=upd[j]) for c, j in zip(cs, at)]
            if dev == lead:
                self.groups.append(_Group(shards))
                continue
            runs = _runs(cs)
            self.groups.append(_Group(
                shards,
                to_lead=[(dst[a], src[b]) for a, b in runs
                         for dst, src in ((self.cand_v, cand_v),
                                          (self.cand_i, cand_i))],
                to_local=[(upd[b], self.upd[a]) for a, b in runs]))
        self.m = None if seq else torch.zeros(lanes, dtype=i32, device=lead)
        self.merge = (self.cand_v, self.cand_i, self.rows, self.upd,
                      self.chosen, self.scores)
        self.launch_merge = None  # K7b bound to its buffers, once checked

    def step(self, apply_step: int, slot: int, rnd: int,
             checked: bool) -> None:
        """One step: shard_step on every group (the updates of the step
        at ``apply_step`` applied, -1 for none, then the select of
        ``slot``), the candidates to the lead, K7b there, its updates
        back to the other cards.  ``slot`` -1 is the walk's tail: the
        last updates applied, nothing selected.  A checked step goes
        through the checking wrappers (and makes the groups' plans);
        the others launch on those plans."""
        from nomad_tpu_torch.ops import binpack

        for g in self.groups:
            if checked:
                g.plan = binpack.shard_step(g.shards, apply_step=apply_step,
                                            select_step=slot, k=self.k)
            else:
                binpack.launch_shard_step(g.plan, apply_step, slot)
            if slot >= 0:
                for dst, src in g.to_lead:
                    dst.copy_(src, non_blocking=True)
        if slot < 0:
            return
        if checked:
            binpack.merge_select(*self.merge, slot=slot, rnd=rnd, m=self.m,
                                 counts=self.counts, valid=self.valid)
            if self.lead.type == "cuda":
                self.launch_merge = binpack.merge_launch(
                    *self.merge, self.m, self.counts, self.valid)
        else:
            self.launch_merge(slot, rnd)
        for g in self.groups:
            for dst, src in g.to_local:
                dst.copy_(src, non_blocking=True)


def _walk(mesh: Mesh, lane_rows, ops: dict, *, seq: bool, k_cap: int = 1,
          rounds: int = 1) -> tuple:
    """Run a sharded walk on the mesh rows ``lane_rows`` (each serving
    its own lanes, step by step side by side) and return (chosen,
    scores, usage) on the mesh's lead device, lanes in row order, shaped
    as K4a/K4b shape them (usage f32[B, N, D], gathered from the
    shards).  Each row takes the route of its layout (:func:`walk_route`,
    counted in ``WALK_ROUTES``): on one card, one shard_walk; across
    cards, step by step: a step of a sequence walk selects for its
    placement p (slot p), a step of the rounds for round ``rnd`` of its
    slot; each step applies the updates of the step before, and a tail
    after the last applies its own.  The first step checks the
    arguments; on the CPU every step runs the plain versions through
    the wrappers."""
    rows = []
    for r in lane_rows:
        route = walk_route(mesh.grid[r])
        WALK_ROUTES[route] += 1
        rows.append((_WalkRow if route == "shard_walk" else _Row)(
            mesh, r, ops, seq, k_cap, rounds))
    stepped = [row for row in rows if isinstance(row, _Row)]
    for row in rows:
        if not isinstance(row, _Row):
            row.walk()
    width = rows[0].chosen.shape[1]
    steps = [(p, 0) for p in range(width)] if seq else \
        [(s, r) for s in range(width) for r in range(rounds)]
    cpu = mesh.lead.type == "cpu"
    prev = -1
    for i, (slot, rnd) in enumerate(steps if stepped else ()):
        for row in stepped:
            row.step(prev, slot, rnd, cpu or i == 0)
        prev = slot
    if steps and stepped:
        for row in stepped:
            row.step(prev, -1, 0, cpu)
    lead = mesh.lead
    # devlint-ok(resident-bypass): the walk's results, card to card:
    # each row's chosen and scores lie on its first card and join on
    # the mesh's lead (a no-op on one card); no host data moves.
    chosen = torch.cat([row.chosen.to(lead) for row in rows])
    # devlint-ok(resident-bypass): as above, the rows' scores.
    scores = torch.cat([row.scores.to(lead) for row in rows])
    usage = torch.empty((chosen.shape[0], mesh.fleet_ways * rows[0].rows,
                         rows[0].usage[0].shape[2]), dtype=torch.float32,
                        device=lead)
    for i, row in enumerate(rows):
        for c, u in enumerate(row.usage):
            usage[i * row.lanes:(i + 1) * row.lanes,
                  c * row.rows:(c + 1) * row.rows].copy_(u)
    return chosen, scores, usage


def _penalty(penalty):
    """A penalty as the walks take it: f32 (a host number or array is
    converted; a tensor or Sharded is taken as placed)."""
    if isinstance(penalty, (Sharded, torch.Tensor)):
        return penalty
    return np.asarray(penalty, dtype=np.float32)


def _one_lane(x: Sharded) -> list:
    """A single eval's operand as one lane of the batch layout."""
    return [t.reshape((1,) + tuple(t.shape)) for t in x]


def _check_k_cap(capacity, k_cap: int, rounds: int) -> None:
    n = capacity.shape[0]
    if not 1 <= k_cap <= n or rounds < 1:
        raise ValueError(f"k_cap {k_cap} must lie in [1, {n}] and rounds "
                         f"{rounds} be >= 1")


def _single_ops(mesh, capacity, reserved, usage0, job_counts0, feasible,
                **replicated) -> dict:
    """A single eval's operands on the mesh (node-sharded fleet tensors,
    replicated descriptors), each as one lane."""
    capacity, reserved, usage0, job_counts0, feasible = shard_fleet_arrays(
        mesh, capacity, reserved, usage0, job_counts0, feasible)
    ops = dict(capacity=capacity, reserved=reserved, usage0=usage0,
               job_counts=_one_lane(job_counts0),
               feasible=_one_lane(feasible))
    replicated["penalty"] = _penalty(replicated["penalty"])
    for name, x in replicated.items():
        ops[name] = _one_lane(_put(x, mesh, REPL))
    return ops


def _batch_ops(mesh, capacity, reserved, usage0, jc0, feasible,
               **lanes) -> dict:
    """A storm's operands on the mesh: the shared fleet tensors
    node-sharded, the per-lane ones on their lane row's shards."""
    ops = dict(capacity=_put(capacity, mesh, NODE),
               reserved=_put(reserved, mesh, NODE),
               usage0=_put(usage0, mesh, NODE),
               job_counts=_put(jc0, mesh, LANE_N),
               feasible=_put(feasible, mesh, LANE_NODE))
    lanes["penalty"] = _penalty(lanes["penalty"])
    for name, x in lanes.items():
        ops[name] = _put(x, mesh, LANE)
    return ops


def place_sequence_sharded(mesh: Mesh, capacity, reserved, usage0,
                           job_counts0, feasible, asks, distinct, group_idx,
                           valid, penalty):
    """K2's placement scan with the node axis sharded over ``mesh`` (a
    single eval: row 0 of a 2-D mesh).  Inputs may be host numpy arrays
    or resident Sharded operands; one shard_walk launch where the
    row's shards share a card, else each step shard_step on every
    card's shards (the owner's update of the step before, then each
    shard's best, k = 1) and K7b's merge of the shards' bests.  Returns
    (chosen i32[P], scores f32[P], usage f32[N, D]) on the mesh's lead
    device, equal to K2's."""
    ops = _single_ops(mesh, capacity, reserved, usage0, job_counts0,
                      feasible, asks=asks, distinct=distinct,
                      group_idx=group_idx, valid=valid, penalty=penalty)
    chosen, scores, usage = _walk(mesh, (0,), ops, seq=True)
    return chosen[0], scores[0], usage[0]


def place_rounds_sharded(mesh: Mesh, capacity, reserved, usage0, jc0,
                         feasible, asks, distinct, counts, penalty, *,
                         k_cap: int, rounds: int):
    """K3's rounds placement with the node axis sharded over ``mesh``:
    each round is a top min(k_cap, R) on every shard of R rows and the
    owners' updates of the round before and a merge to the global top
    k_cap, in one shard_walk launch where the shards share a card, else
    shard_step and K7b a round.
    Returns (chosen i32[G, rounds * k_cap], scores alike, usage
    f32[N, D]) on the mesh's lead device, equal to K3's."""
    _check_k_cap(capacity, k_cap, rounds)
    ops = _single_ops(mesh, capacity, reserved, usage0, jc0, feasible,
                      asks=asks, distinct=distinct, counts=counts,
                      penalty=penalty)
    chosen, scores, usage = _walk(mesh, (0,), ops, seq=False, k_cap=k_cap,
                                  rounds=rounds)
    return chosen[0], scores[0], usage[0]


def place_rounds_batch_sharded(mesh: Mesh, capacity, reserved, usage0, jc0,
                               feasible, asks, distinct, counts, penalty, *,
                               k_cap: int, rounds: int):
    """K4a, node axis sharded: on a 1-D fleet mesh every shard serves
    every lane; on a 2-D ``storm_mesh`` each lane row serves its B /
    lane_ways lanes over its own fleet replica.  Returns K4a's (chosen,
    scores, usage f32[B, N, D]) on the mesh's lead device."""
    _check_k_cap(capacity, k_cap, rounds)
    ops = _batch_ops(mesh, capacity, reserved, usage0, jc0, feasible,
                     asks=asks, distinct=distinct, counts=counts,
                     penalty=penalty)
    return _walk(mesh, range(mesh.lane_ways), ops, seq=False, k_cap=k_cap,
                 rounds=rounds)


def place_sequence_batch_sharded(mesh: Mesh, capacity, reserved, usage0,
                                 jc0, feasible, asks, distinct, group_idx,
                                 valid, penalty):
    """K4b, node axis sharded (lanes too on a 2-D ``storm_mesh``, as in
    :func:`place_rounds_batch_sharded`).  Returns K4b's (chosen, scores,
    usage) on the mesh's lead device."""
    ops = _batch_ops(mesh, capacity, reserved, usage0, jc0, feasible,
                     asks=asks, distinct=distinct, group_idx=group_idx,
                     valid=valid, penalty=penalty)
    return _walk(mesh, range(mesh.lane_ways), ops, seq=True)


# -- the window verify: K6 ---------------------------------------------------

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
    ni = pair_ni.long()
    return _verify_rows(usage[ni, :4], reserved[ni, :4], capacity[ni, :4],
                        pair_ni, row_pair, row_vec, seq_ni, seq_vec,
                        seq_order, seq_comp, pair_order, pair_comp,
                        pair_removed)


def _verify_rows(usage_rows, reserved_rows, capacity_rows, pair_ni,
                 row_pair, row_vec, seq_ni, seq_vec, seq_order, seq_comp,
                 pair_order, pair_comp, pair_removed):
    """K6's plain body on the pairs' rows f32[B, 4], already gathered."""
    npair = pair_ni.shape[0]
    delta = torch.zeros((npair, 4), dtype=torch.float32,
                        device=usage_rows.device)
    delta.index_add_(0, row_pair.long(), row_vec)
    used = usage_rows + reserved_rows + delta
    caps = capacity_rows
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
    started = obs_trace.device_span(device) if obs_trace.ENABLED else None
    code = lib.nomad_window_verify(
        capacity.data_ptr(), reserved.data_ptr(), usage.data_ptr(),
        usage.shape[1], packed.data_ptr(), b, *counts, out.data_ptr(),
        kernels.stream_handle(device))
    if started is not None:
        pairs, rows, seq = counts
        started.end("device.K6", pairs=pairs, rows=rows, seq=seq)
    kernels.check(lib, "window_verify", code)
    window_verify.launches += 1
    return out


# -- the sharded window verify: K6 on the shards, K7d across cards --------
# One launch of K6's sharded form a window: each pair reads its node's
# rows from the shard that owns it, in place where the shard sits on the
# window's card (at most VERIFY_SHARDS of them), else from that shard's
# K7d partial (a masked gather on its own card, copied over).


# One in-place shard of the sharded K6 (``csrc/window_verify.cu``
# VerifyShard: the three pointers, then row_lo); at most VERIFY_SHARDS a
# launch (MAX_VERIFY_SHARDS).
VERIFY_FIELDS = ("capacity", "reserved", "usage")
VERIFY_SHARDS = 16


def verify_layout(devices) -> tuple:
    """(positions read in place, positions gathered by K7d) of a mesh
    row over ``devices``: the lead's own positions, up to
    :data:`VERIFY_SHARDS`, in place; every other position (on another
    card, or past the cap) sends a partial.  Decided from the layout
    alone, before any launch."""
    lead = torch.device(devices[0])
    own = [c for c, d in enumerate(devices) if torch.device(d) == lead]
    own = own[:VERIFY_SHARDS]
    return own, [c for c in range(len(devices)) if c not in own]


def shard_gather_plain(capacity, reserved, usage, row_lo: int, pair_ni):
    """Plain version of K7d: f32[B, 12], each pair's usage, reserved and
    capacity columns 0-3 where the shard (rows [row_lo, row_lo + R))
    owns its node, zeros elsewhere; a masked gather."""
    local = pair_ni.long() - row_lo
    own = (local >= 0) & (local < usage.shape[0])
    at = torch.where(own, local, torch.zeros_like(local))
    rows = torch.cat([usage[at, :4], reserved[at, :4], capacity[at, :4]],
                     dim=1)
    return torch.where(own[:, None], rows, torch.zeros_like(rows))


def shard_gather(capacity, reserved, usage, row_lo: int, pair_ni, out=None):
    """K7d: the plain version for CPU tensors, one ``shard_gather_kernel``
    launch (``csrc/window_verify.cu``) for CUDA tensors.  capacity /
    reserved / usage f32[R, D] (D >= 4) of one shard, pair_ni i32[B] (the
    window's node ids) on the same device; returns (or writes into
    ``out``) f32[B, 12]."""
    args = dict(capacity=capacity, reserved=reserved, usage=usage,
                pair_ni=pair_ni)
    from nomad_tpu_torch.ops import kernels

    device = kernels.route(args)
    rows, d = usage.shape
    b = pair_ni.shape[0]
    if device.type == "cpu":
        got = shard_gather_plain(capacity, reserved, usage, row_lo, pair_ni)
        return got if out is None else out.copy_(got)
    if d < 4:
        raise ValueError(f"fleet rows of {d} values: want at least 4")
    kernels.check_args(args, dict(
        capacity=(torch.float32, (rows, d)),
        reserved=(torch.float32, (rows, d)),
        usage=(torch.float32, (rows, d)), pair_ni=(torch.int32, (b,))))
    if out is None:
        out = torch.empty((b, 12), dtype=torch.float32, device=device)
    kernels.check_args(dict(out=out), dict(out=(torch.float32, (b, 12))))
    lib = kernels.library("window_verify")
    started = obs_trace.device_span(device) if obs_trace.ENABLED else None
    code = lib.nomad_shard_gather(
        capacity.data_ptr(), reserved.data_ptr(), usage.data_ptr(), d,
        row_lo, rows, pair_ni.data_ptr(), b, out.data_ptr(),
        kernels.stream_handle(device))
    if started is not None:
        started.end("device.K7d")
    kernels.check(lib, "shard_gather", code)
    shard_gather.launches += 1
    return out


shard_gather.launches = 0


def window_verify_shards_plain(shards, shard_rows: int, partials, **desc):
    """Plain version of K6's sharded form: each pair's node rows read
    from its owner (shard o owns rows [o R, (o + 1) R), R =
    ``shard_rows``), in place from ``shards`` (mappings of
    :data:`VERIFY_FIELDS` and ``row_lo``) or, for an owner not among
    them, from its K7d partial ``partials`` f32[S, B, 12]; then K6's
    body (:func:`_verify_rows`).  The owner's bits, as K6 reads them."""
    ni = desc["pair_ni"].long()
    b = ni.shape[0]
    covered = torch.zeros(b, dtype=torch.bool, device=ni.device)
    rows = torch.zeros((b, 12), dtype=torch.float32, device=ni.device)
    if partials is not None:
        rows = partials[ni // shard_rows,
                        torch.arange(b, device=ni.device)].clone()
        covered[:] = True
    for sh in shards:
        local = ni - int(sh["row_lo"])
        own = (local >= 0) & (local < shard_rows)
        at = local[own]
        rows[own] = torch.cat([sh["usage"][at, :4], sh["reserved"][at, :4],
                               sh["capacity"][at, :4]], dim=1)
        covered |= own
    if not bool(covered.all()):
        raise ValueError("a pair's node lies on no shard given and no "
                         "partial was")
    return _verify_rows(rows[:, :4], rows[:, 4:8], rows[:, 8:12], **desc)


def verify_table(shards):
    """The sharded K6's by-value table, as host words: per shard the
    pointers of :data:`VERIFY_FIELDS`, then row_lo, in the order of
    ``csrc/window_verify.cu`` VerifyShard."""
    words = []
    for sh in shards:
        words += [sh[name].data_ptr() for name in VERIFY_FIELDS]
        # torchlint-ok(concretize): ``row_lo`` is the shard record's
        # host int (verify_layout), not a tensor.
        words.append(int(sh["row_lo"]))
    return (ctypes.c_uint64 * len(words))(*words)


# Device indices whose sharded K6 shared-memory limit is raised.
_SET_UP_SHARDED: set = set()


def launch_window_verify_shards(shards, shard_rows: int, owners: int,
                                partials, packed, b: int, counts: tuple):
    """K6's sharded form, one launch on the window's card: ``shards``
    (mappings of :data:`VERIFY_FIELDS` and ``row_lo``, CUDA tensors
    f32[shard_rows, D] on that card, at most :data:`VERIFY_SHARDS`) read
    in place, ``partials`` f32[owners, B, 12] (the K7d gathers of the
    other owners) or None where ``shards`` are all ``owners``, and a
    packed descriptor buffer there.  Returns the output buffer,
    uint8[B, 36]; counted in its own ``launches``."""
    from nomad_tpu_torch.ops import kernels

    device = packed.device
    if packed.dtype != torch.int32 or tuple(packed.shape) != (19 * b,) \
            or not packed.is_contiguous():
        raise ValueError(f"packed descriptors: want int32[19 * B] on "
                         f"{device}")
    if not 1 <= len(shards) <= VERIFY_SHARDS:
        raise ValueError(f"the sharded K6 reads 1 to {VERIFY_SHARDS} "
                         f"shards in place, not {len(shards)}")
    d = shards[0]["usage"].shape[1]
    tensors = {f"{name}{s}": sh[name] for s, sh in enumerate(shards)
               for name in VERIFY_FIELDS}
    tensors["packed"] = packed
    specs = {f"{name}{s}": (torch.float32, (shard_rows, d))
             for s in range(len(shards)) for name in VERIFY_FIELDS}
    if partials is not None:
        tensors["partials"] = partials
        specs["partials"] = (torch.float32, (owners, b, 12))
    if kernels.route(tensors) != device:
        raise ValueError("the sharded K6's operands lie on several devices")
    kernels.check_args(tensors, specs)
    table = verify_table(shards)
    out = torch.empty((b, OUT_BYTES), dtype=torch.uint8, device=device)
    lib = kernels.library("window_verify")
    if device.index not in _SET_UP_SHARDED:
        with torch.cuda.device(device):
            kernels.check(lib, "window_verify_sharded setup",
                          lib.nomad_window_verify_sharded_setup())
        _SET_UP_SHARDED.add(device.index)
    started = obs_trace.device_span(device) if obs_trace.ENABLED else None
    code = lib.nomad_window_verify_sharded(
        table, len(shards), owners, shard_rows, d,
        None if partials is None else partials.data_ptr(),
        packed.data_ptr(), b, *counts, out.data_ptr(),
        kernels.stream_handle(device))
    if started is not None:
        started.end("device.K6_sharded")
    kernels.check(lib, "window_verify_sharded", code)
    launch_window_verify_shards.launches += 1
    return out


launch_window_verify_shards.launches = 0


def window_verify_sharded(mesh: Mesh, capacity, reserved, usage, pair_ni,
                          row_pair, row_vec, seq_ni, seq_vec, seq_order,
                          seq_comp, pair_order, pair_comp, pair_removed, *,
                          packed: bool = False, counts=None):
    """One window's base fit and optimistic overlay fold, node axis
    sharded over ``mesh`` (its first row): one launch of K6's sharded
    form on the lead device, reading the lead's shards in place
    (:func:`verify_layout`); each shard elsewhere first gathers its
    rows' partial with K7d on its own card.

    capacity/reserved/usage normally arrive as the resident Sharded
    twins (no transfer: ``_put`` skips them); the descriptors are the
    host (numpy) arrays of :func:`window_verify`, validated against the
    whole fleet, packed and uploaded to the lead in one counted
    transfer (a shard on another device gets its copy of ``pair_ni``
    from there).  Returns what :func:`window_verify` returns, equal to
    it bit for bit, on the lead device."""
    capacity, reserved, usage = (_put(x, mesh, NODE)
                                 for x in (capacity, reserved, usage))
    desc = dict(pair_ni=pair_ni, row_pair=row_pair, row_vec=row_vec,
                seq_ni=seq_ni, seq_vec=seq_vec, seq_order=seq_order,
                seq_comp=seq_comp, pair_order=pair_order,
                pair_comp=pair_comp, pair_removed=pair_removed)
    n, d = usage.shape
    if d < 4:
        raise ValueError(f"fleet rows of {d} values: want at least 4")
    b = check_descriptors(n, desc)
    devs = mesh.grid[0]
    lead = devs[0]
    rows = n // len(devs)
    own, others = verify_layout(devs)
    shards = [dict(capacity=capacity[c], reserved=reserved[c],
                   usage=usage[c], row_lo=c * rows) for c in own]
    upload = None
    partials = None
    if others:
        # Each other shard's K7d partial, gathered on its own card.
        partials = torch.zeros((len(devs), b, 12), dtype=torch.float32,
                               device=lead)
        if lead.type == "cpu":
            pair_ni_on = {lead: torch.from_numpy(desc["pair_ni"])}
        else:
            counts = kernel_counts(desc, counts)
            pack_descriptors(desc, b, _UPLOAD.host_view(19 * b))
            upload = _UPLOAD.upload(19 * b, lead)
            pair_ni_on = {lead: upload[:b]}
        for c in others:
            dev = devs[c]
            ni = pair_ni_on.get(dev)
            if ni is None:
                ni = pair_ni_on[dev] = torch.empty(b, dtype=torch.int32,
                                                   device=dev)
                note_transfer("d2d")
                ni.copy_(pair_ni_on[lead], non_blocking=True)
            part = partials[c] if dev == lead else \
                torch.empty((b, 12), dtype=torch.float32, device=dev)
            shard_gather(capacity[c], reserved[c], usage[c], c * rows, ni,
                         out=part)
            if dev != lead:
                partials[c].copy_(part, non_blocking=True)
    buf = window_verify_shards(shards, rows, len(devs), partials, desc,
                               counts=counts, upload=upload)
    return buf if packed else unpack_results(buf)


def window_verify_shards(shards, shard_rows: int, owners: int, partials,
                         desc: dict, counts=None, upload=None):
    """K6's sharded form on the window's device: the plain version
    (:func:`window_verify_shards_plain`) for CPU tensors, for CUDA
    tensors one launch (:func:`launch_window_verify_shards`) behind the
    window's packed descriptors (``upload``, already on the card, or
    packed from ``desc`` and uploaded here in one counted transfer).
    ``shards`` are read in place, ``partials`` f32[owners, B, 12] (or
    None) hold the other owners' K7d gathers.  Returns K6's output
    buffer, uint8[B, 36] (:func:`unpack_results`)."""
    from nomad_tpu_torch.ops import kernels

    device = kernels.route({f"{name}{s}": sh[name]
                            for s, sh in enumerate(shards)
                            for name in VERIFY_FIELDS})
    b = np.asarray(desc["pair_ni"]).shape[0]
    if device.type == "cpu":
        return pack_results(*window_verify_shards_plain(
            shards, shard_rows, partials,
            **{k: torch.from_numpy(desc[k]) for k, _t, _w in DESCRIPTORS}))
    counts = kernel_counts(desc, counts)
    if upload is None:
        pack_descriptors(desc, b, _UPLOAD.host_view(19 * b))
        upload = _UPLOAD.upload(19 * b, device)
    return launch_window_verify_shards(shards, shard_rows, owners, partials,
                                       upload, b, counts)
