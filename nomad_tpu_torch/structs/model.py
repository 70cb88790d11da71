"""Core data model of nomad-tpu, as carried by the PyTorch port.

Declarative job model (Job -> TaskGroup -> Task), cluster objects (Node,
Allocation, Evaluation, Plan) and the request/response envelopes used by the
RPC layer.  Capability parity with the reference data model
(reference nomad/structs/structs.go), re-designed as Python dataclasses
with explicit copy semantics: every object handed out by the state store is
treated as immutable; mutations go through ``.copy()`` + field assignment.

The model also carries the *tensorization contract*: `Resources.as_vector()`
defines the canonical resource-dimension ordering used by the device-resident
fleet tensors (see nomad_tpu_torch/models/fleet.py).
"""
from __future__ import annotations

import threading
import time
import os as _os
import uuid as _uuid
from dataclasses import MISSING, dataclass, field, fields, replace
from typing import Any, Optional

# ---------------------------------------------------------------------------
# Constants (reference: nomad/structs/structs.go:696-727, 1065-1128, 1267-1290)
# ---------------------------------------------------------------------------

JOB_TYPE_CORE = "_core"
JOB_TYPE_SERVICE = "service"
JOB_TYPE_BATCH = "batch"
JOB_TYPE_SYSTEM = "system"

JOB_STATUS_PENDING = "pending"
JOB_STATUS_RUNNING = "running"
JOB_STATUS_COMPLETE = "complete"
JOB_STATUS_DEAD = "dead"

JOB_MIN_PRIORITY = 1
JOB_DEFAULT_PRIORITY = 50
JOB_MAX_PRIORITY = 100
CORE_JOB_PRIORITY = JOB_MAX_PRIORITY * 2

NODE_STATUS_INIT = "initializing"
NODE_STATUS_READY = "ready"
NODE_STATUS_DOWN = "down"

ALLOC_DESIRED_STATUS_RUN = "run"
ALLOC_DESIRED_STATUS_STOP = "stop"
ALLOC_DESIRED_STATUS_EVICT = "evict"
ALLOC_DESIRED_STATUS_FAILED = "failed"

ALLOC_CLIENT_STATUS_PENDING = "pending"
ALLOC_CLIENT_STATUS_RUNNING = "running"
ALLOC_CLIENT_STATUS_DEAD = "dead"
ALLOC_CLIENT_STATUS_FAILED = "failed"

EVAL_STATUS_PENDING = "pending"
EVAL_STATUS_COMPLETE = "complete"
EVAL_STATUS_FAILED = "failed"

EVAL_TRIGGER_JOB_REGISTER = "job-register"
EVAL_TRIGGER_JOB_DEREGISTER = "job-deregister"
EVAL_TRIGGER_NODE_UPDATE = "node-update"
EVAL_TRIGGER_SCHEDULED = "scheduled"
EVAL_TRIGGER_ROLLING_UPDATE = "rolling-update"

# Core-scheduler job ids (reference: nomad/core_sched.go)
CORE_JOB_EVAL_GC = "eval-gc"
CORE_JOB_NODE_GC = "node-gc"
# Operator-requested GC: both collectors, age thresholds bypassed.
CORE_JOB_FORCE_GC = "force-gc"

# Dynamic port range (reference: nomad/structs/network.go:9-18)
MIN_DYNAMIC_PORT = 20000
MAX_DYNAMIC_PORT = 60000
MAX_RAND_PORT_ATTEMPTS = 20

# Constraint operands (reference: scheduler/feasible.go:259-376; distinct_hosts
# is a forward-ported operand used by the bench configs).
CONSTRAINT_DISTINCT_HOSTS = "distinct_hosts"


def generate_uuid() -> str:
    """Random UUID-format string (reference: nomad/structs/funcs.go:127-139).
    os.urandom + hex slicing: ~5x cheaper than uuid.uuid4() and the
    scheduler mints one per placement (hot at 10k placements/eval)."""
    h = _os.urandom(16).hex()
    return f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"


def generate_uuids(n: int) -> list:
    """n random UUID strings from ONE urandom read (bulk minting for the
    scheduler finish path)."""
    h = _os.urandom(16 * n).hex()
    out = []
    for i in range(0, 32 * n, 32):
        s = h[i:i + 32]
        out.append(f"{s[:8]}-{s[8:12]}-{s[12:16]}-{s[16:20]}-{s[20:]}")
    return out


def msec_now() -> int:
    return int(time.time() * 1000)


def proto_of(cls) -> tuple[dict, list]:
    """Split a dataclass into (static-default dict, default_factory list)
    for template-based construction: hot paths build thousands of
    identical-shaped objects per eval, and ``cls.__new__`` + one dict
    copy is ~3x cheaper than the generated ``__init__`` while staying in
    sync with the dataclass definition automatically."""
    static, factories = {}, []
    for f in fields(cls):
        if f.default_factory is not MISSING:  # type: ignore[misc]
            factories.append((f.name, f.default_factory))
        else:
            static[f.name] = None if f.default is MISSING else f.default
    return static, factories


# ---------------------------------------------------------------------------
# Serialization helpers: every struct supports to_dict()/from_dict() so the
# raft log, RPC plane and HTTP API share one msgpack/JSON-safe representation.
# ---------------------------------------------------------------------------

class _Struct:
    """Mixin providing shallow-copy + dict round trip for dataclasses."""

    def copy(self):
        return replace(self)  # shallow, like Go's *new = *old

    def to_dict(self) -> dict:
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            out[f.name] = _to_plain(v)
        return out

    @classmethod
    def from_dict(cls, d: dict):
        kwargs = {}
        hints = {f.name: f for f in fields(cls)}
        for name, f in hints.items():
            if name not in d:
                continue
            kwargs[name] = _from_plain(cls._field_types().get(name), d[name])
        return cls(**kwargs)

    @classmethod
    def _field_types(cls) -> dict:
        return getattr(cls, "_NESTED", {})


def _to_plain(v):
    if isinstance(v, _Struct):
        return v.to_dict()
    if isinstance(v, list):
        return [_to_plain(x) for x in v]
    if isinstance(v, dict):
        return {k: _to_plain(x) for k, x in v.items()}
    return v


def _from_plain(spec, v):
    if v is None or spec is None:
        return v
    if isinstance(spec, tuple):
        kind, inner = spec
        if kind == "list":
            return [_from_plain(inner, x) for x in v]
        if kind == "dict":
            return {k: _from_plain(inner, x) for k, x in v.items()}
    if isinstance(spec, type) and issubclass(spec, _Struct):
        return spec.from_dict(v)
    return v


# ---------------------------------------------------------------------------
# Resources / networks (reference: nomad/structs/structs.go:538-694)
# ---------------------------------------------------------------------------

# Canonical resource dimension order for fleet tensors.  Bandwidth (mbits) and
# port-count capacity are modeled as extra dims so the device-side fit mask is
# a sound over-approximation of the exact host-side network accounting
# (SURVEY.md section 7 "Network/port allocation").
RESOURCE_DIMS = ("cpu", "memory_mb", "disk_mb", "iops")
NET_DIMS = ("mbits", "port_slots")
ALL_FIT_DIMS = RESOURCE_DIMS + NET_DIMS


@dataclass
class NetworkResource(_Struct):
    """Available or requested network bandwidth + ports on one device."""

    device: str = ""
    cidr: str = ""
    ip: str = ""
    mbits: int = 0
    reserved_ports: list = field(default_factory=list)
    dynamic_ports: list = field(default_factory=list)  # labels

    def copy(self) -> "NetworkResource":
        return NetworkResource(
            device=self.device, cidr=self.cidr, ip=self.ip,
            mbits=self.mbits,
            reserved_ports=list(self.reserved_ports),
            dynamic_ports=list(self.dynamic_ports))

    def add(self, delta: "NetworkResource") -> None:
        if delta.reserved_ports:
            self.reserved_ports = self.reserved_ports + list(delta.reserved_ports)
        self.mbits += delta.mbits
        self.dynamic_ports = self.dynamic_ports + list(delta.dynamic_ports)

    def map_dynamic_ports(self) -> dict:
        """Label -> assigned port for dynamic ports (appended to reserved)."""
        nd = len(self.dynamic_ports)
        ports = self.reserved_ports[len(self.reserved_ports) - nd:] if nd else []
        return dict(zip(self.dynamic_ports, ports))

    def list_static_ports(self) -> list:
        nd = len(self.dynamic_ports)
        return self.reserved_ports[: len(self.reserved_ports) - nd]


@dataclass
class Resources(_Struct):
    """CPU (MHz), memory, disk, IOPS and network asks/capacity."""

    _NESTED = {"networks": ("list", NetworkResource)}

    cpu: int = 0
    memory_mb: int = 0
    disk_mb: int = 0
    iops: int = 0
    networks: list = field(default_factory=list)

    def copy(self) -> "Resources":
        return Resources(
            cpu=self.cpu, memory_mb=self.memory_mb, disk_mb=self.disk_mb,
            iops=self.iops, networks=[n.copy() for n in self.networks])

    def net_index(self, n: NetworkResource) -> int:
        for i, net in enumerate(self.networks):
            if net.device == n.device:
                return i
        return -1

    def superset(self, other: "Resources") -> tuple[bool, str]:
        """Is self a superset of other?  Ignores networks (use NetworkIndex)."""
        if self.cpu < other.cpu:
            return False, "cpu exhausted"
        if self.memory_mb < other.memory_mb:
            return False, "memory exhausted"
        if self.disk_mb < other.disk_mb:
            return False, "disk exhausted"
        if self.iops < other.iops:
            return False, "iops exhausted"
        return True, ""

    def add(self, delta: Optional["Resources"]) -> None:
        if delta is None:
            return
        self.cpu += delta.cpu
        self.memory_mb += delta.memory_mb
        self.disk_mb += delta.disk_mb
        self.iops += delta.iops
        for n in delta.networks:
            idx = self.net_index(n)
            if idx == -1:
                self.networks.append(n.copy())
            else:
                self.networks[idx].add(n)

    def as_vector(self) -> list:
        """Resource ask as [cpu, mem, disk, iops, mbits, port_slots]."""
        mbits = sum(n.mbits for n in self.networks)
        ports = sum(len(n.reserved_ports) + len(n.dynamic_ports)
                    for n in self.networks)
        return [self.cpu, self.memory_mb, self.disk_mb, self.iops, mbits, ports]


# ---------------------------------------------------------------------------
# Job / TaskGroup / Task / Constraint
# (reference: nomad/structs/structs.go:729-1063)
# ---------------------------------------------------------------------------

@dataclass
class Constraint(_Struct):
    """A scheduling constraint: ``l_target operand r_target``.

    Targets support interpolation: ``$node.id|datacenter|name``,
    ``$attr.<key>``, ``$meta.<key>``; operands: = == is != not < <= > >=
    version regexp distinct_hosts (reference: scheduler/feasible.go:225-376).
    """

    hard: bool = True
    l_target: str = ""
    r_target: str = ""
    operand: str = "="
    weight: int = 0

    def validate(self) -> list:
        errs = []
        if not self.operand:
            errs.append("missing constraint operand")
        if not self.hard and self.weight == 0:
            errs.append("soft constraint needs a weight")
        # Operand-specific checks (reference structs.go Constraint.Validate).
        if self.operand == "regexp":
            import re as _re
            try:
                _re.compile(self.r_target)
            except _re.error as e:
                errs.append(
                    f"regular expression failed to compile: {e}")
        elif self.operand == "version":
            from nomad_tpu_torch.utils.versions import parse_constraint
            if parse_constraint(self.r_target) is None:
                errs.append(
                    f"version constraint is invalid: {self.r_target!r}")
        return errs


@dataclass
class Task(_Struct):
    _NESTED = {"resources": Resources, "constraints": ("list", Constraint)}

    name: str = ""
    driver: str = ""
    config: dict = field(default_factory=dict)
    env: dict = field(default_factory=dict)
    constraints: list = field(default_factory=list)
    resources: Resources = field(default_factory=Resources)
    meta: dict = field(default_factory=dict)

    def copy(self) -> "Task":
        t = replace(self)
        t.config = dict(self.config)
        t.env = dict(self.env)
        t.constraints = [c.copy() for c in self.constraints]
        t.resources = self.resources.copy()
        t.meta = dict(self.meta)
        return t

    def validate(self) -> list:
        errs = []
        if not self.name:
            errs.append("missing task name")
        if not self.driver:
            errs.append(f"task {self.name!r} missing driver")
        if self.resources is None:
            errs.append(f"task {self.name!r} missing resources")
        for c in self.constraints:
            errs.extend(c.validate())
        return errs


@dataclass
class TaskGroup(_Struct):
    _NESTED = {"constraints": ("list", Constraint), "tasks": ("list", Task)}

    name: str = ""
    count: int = 1
    constraints: list = field(default_factory=list)
    tasks: list = field(default_factory=list)
    meta: dict = field(default_factory=dict)

    def copy(self) -> "TaskGroup":
        tg = replace(self)
        tg.constraints = [c.copy() for c in self.constraints]
        tg.tasks = [t.copy() for t in self.tasks]
        tg.meta = dict(self.meta)
        return tg

    def lookup_task(self, name: str) -> Optional[Task]:
        for t in self.tasks:
            if t.name == name:
                return t
        return None

    def validate(self) -> list:
        errs = []
        if not self.name:
            errs.append("missing task group name")
        if self.count <= 0:
            errs.append(f"task group {self.name!r} count must be positive")
        if not self.tasks:
            errs.append(f"task group {self.name!r} has no tasks")
        seen = set()
        for t in self.tasks:
            if t.name in seen:
                errs.append(f"task group {self.name!r} has duplicate task {t.name!r}")
            seen.add(t.name)
            errs.extend(t.validate())
        for c in self.constraints:
            errs.extend(c.validate())
        return errs


@dataclass
class UpdateStrategy(_Struct):
    """Rolling update config (reference: structs.go:888-899)."""

    stagger: float = 0.0  # seconds
    max_parallel: int = 0

    def rolling(self) -> bool:
        return self.stagger > 0 and self.max_parallel > 0


@dataclass
class Job(_Struct):
    _NESTED = {
        "constraints": ("list", Constraint),
        "task_groups": ("list", TaskGroup),
        "update": UpdateStrategy,
    }

    id: str = ""
    name: str = ""
    region: str = "global"
    type: str = JOB_TYPE_SERVICE
    priority: int = JOB_DEFAULT_PRIORITY
    all_at_once: bool = False
    datacenters: list = field(default_factory=list)
    constraints: list = field(default_factory=list)
    task_groups: list = field(default_factory=list)
    update: UpdateStrategy = field(default_factory=UpdateStrategy)
    meta: dict = field(default_factory=dict)
    status: str = JOB_STATUS_PENDING
    status_description: str = ""
    create_index: int = 0
    modify_index: int = 0

    def copy(self) -> "Job":
        j = replace(self)
        j.datacenters = list(self.datacenters)
        j.constraints = [c.copy() for c in self.constraints]
        j.task_groups = [tg.copy() for tg in self.task_groups]
        j.update = self.update.copy()
        j.meta = dict(self.meta)
        return j

    def lookup_task_group(self, name: str) -> Optional[TaskGroup]:
        for tg in self.task_groups:
            if tg.name == name:
                return tg
        return None

    def validate(self) -> list:
        errs = []
        if not self.region:
            errs.append("missing job region")
        if not self.id:
            errs.append("missing job id")
        elif " " in self.id:
            errs.append("job id contains a space")
        if not self.name:
            errs.append("missing job name")
        if self.type not in (JOB_TYPE_CORE, JOB_TYPE_SERVICE, JOB_TYPE_BATCH,
                             JOB_TYPE_SYSTEM):
            errs.append(f"invalid job type {self.type!r}")
        if not (JOB_MIN_PRIORITY <= self.priority <= JOB_MAX_PRIORITY
                or self.priority == CORE_JOB_PRIORITY):
            errs.append(
                f"job priority must be between [{JOB_MIN_PRIORITY}, "
                f"{JOB_MAX_PRIORITY}]")
        if not self.datacenters:
            errs.append("missing job datacenters")
        if not self.task_groups:
            errs.append("missing job task groups")
        seen = set()
        for tg in self.task_groups:
            if tg.name in seen:
                errs.append(f"duplicate task group {tg.name!r}")
            seen.add(tg.name)
            if self.type == JOB_TYPE_SYSTEM and tg.count != 1:
                errs.append(
                    f"system job task group {tg.name!r} should have "
                    "a count of 1")
            errs.extend(tg.validate())
        for c in self.constraints:
            errs.extend(c.validate())
        return errs


# ---------------------------------------------------------------------------
# Node (reference: nomad/structs/structs.go:438-534)
# ---------------------------------------------------------------------------

@dataclass
class Node(_Struct):
    _NESTED = {"resources": Resources, "reserved": Resources}

    id: str = ""
    datacenter: str = "dc1"
    name: str = ""
    attributes: dict = field(default_factory=dict)
    resources: Resources = field(default_factory=Resources)
    reserved: Optional[Resources] = None
    links: dict = field(default_factory=dict)
    meta: dict = field(default_factory=dict)
    node_class: str = ""
    drain: bool = False
    status: str = NODE_STATUS_INIT
    status_description: str = ""
    create_index: int = 0
    modify_index: int = 0

    def copy(self) -> "Node":
        n = replace(self)
        n.attributes = dict(self.attributes)
        n.resources = self.resources.copy()
        n.reserved = self.reserved.copy() if self.reserved else None
        n.links = dict(self.links)
        n.meta = dict(self.meta)
        return n

    def terminal_status(self) -> bool:
        return self.status == NODE_STATUS_DOWN


def should_drain_node(status: str) -> bool:
    """Whether allocs on a node with this status must be migrated."""
    return status == NODE_STATUS_DOWN


def valid_node_status(status: str) -> bool:
    return status in (NODE_STATUS_INIT, NODE_STATUS_READY, NODE_STATUS_DOWN)


# ---------------------------------------------------------------------------
# Allocation + metrics (reference: structs.go:1065-1259)
# ---------------------------------------------------------------------------

_METRIC_LAZY_DICTS = frozenset((
    "class_filtered", "constraint_filtered", "class_exhausted",
    "dimension_exhausted", "scores"))
# One lock for all lazy materializations: they are rare (first read of
# a field the fast constructors skipped) and idempotent, but without
# the lock two concurrent first reads of ``scores`` could race the
# _lazy_score_key pop and one would see an empty dict.
_METRIC_LAZY_LOCK = threading.Lock()


@dataclass
class AllocMetric(_Struct):
    """Scheduling explainability data recorded on every placement attempt.

    Lazily materialized: the bulk construction paths (the native finish
    loop in native/port_alloc.cpp and the schedulers' fast_metric
    templates) skip the five per-placement factory dicts and stash the
    one binpack score as two scalars (``_lazy_score_key``/``_lazy_
    score_val``); ``__getattr__`` materializes the dicts on first read,
    so the object/wire contract (reference
    nomad/structs/structs.go:1178-1259 — to_dict, CLI explainability,
    codec) is unchanged while the placement hot loop allocates ~6 fewer
    objects per alloc."""

    nodes_evaluated: int = 0
    nodes_filtered: int = 0
    class_filtered: dict = field(default_factory=dict)
    constraint_filtered: dict = field(default_factory=dict)
    nodes_exhausted: int = 0
    class_exhausted: dict = field(default_factory=dict)
    dimension_exhausted: dict = field(default_factory=dict)
    scores: dict = field(default_factory=dict)
    allocation_time: float = 0.0  # seconds
    coalesced_failures: int = 0

    def __getattr__(self, name: str):
        if name in _METRIC_LAZY_DICTS:
            with _METRIC_LAZY_LOCK:
                d = self.__dict__
                if name in d:  # lost the race: another reader built it
                    return d[name]
                if name == "scores":
                    key = d.pop("_lazy_score_key", None)
                    s = {} if key is None \
                        else {key: d.pop("_lazy_score_val")}
                    d["scores"] = s
                    return s
                val = d[name] = {}
                return val
        raise AttributeError(name)

    def copy(self) -> "AllocMetric":
        m = replace(self)
        m.class_filtered = dict(self.class_filtered)
        m.constraint_filtered = dict(self.constraint_filtered)
        m.class_exhausted = dict(self.class_exhausted)
        m.dimension_exhausted = dict(self.dimension_exhausted)
        m.scores = dict(self.scores)
        return m

    def evaluate_node(self) -> None:
        self.nodes_evaluated += 1

    def filter_node(self, node: Optional[Node], constraint: str) -> None:
        self.nodes_filtered += 1
        if node is not None and node.node_class:
            self.class_filtered[node.node_class] = \
                self.class_filtered.get(node.node_class, 0) + 1
        if constraint:
            self.constraint_filtered[constraint] = \
                self.constraint_filtered.get(constraint, 0) + 1

    def exhausted_node(self, node: Optional[Node], dimension: str) -> None:
        self.nodes_exhausted += 1
        if node is not None and node.node_class:
            self.class_exhausted[node.node_class] = \
                self.class_exhausted.get(node.node_class, 0) + 1
        if dimension:
            self.dimension_exhausted[dimension] = \
                self.dimension_exhausted.get(dimension, 0) + 1

    def score_node(self, node: Node, name: str, score: float) -> None:
        key = f"{node.id}.{name}"
        self.scores[key] = self.scores.get(key, 0.0) + score


@dataclass
class Allocation(_Struct):
    _NESTED = {
        "job": Job,
        "resources": Resources,
        "task_resources": ("dict", Resources),
        "metrics": AllocMetric,
    }

    id: str = ""
    eval_id: str = ""
    name: str = ""
    node_id: str = ""
    job_id: str = ""
    job: Optional[Job] = None
    task_group: str = ""
    resources: Optional[Resources] = None
    task_resources: dict = field(default_factory=dict)
    metrics: Optional[AllocMetric] = None
    desired_status: str = ""
    desired_description: str = ""
    client_status: str = ""
    client_description: str = ""
    task_states: dict = field(default_factory=dict)
    create_index: int = 0
    modify_index: int = 0

    def copy(self) -> "Allocation":
        a = replace(self)
        a.task_resources = dict(self.task_resources)
        a.task_states = dict(self.task_states)
        return a

    def terminal_status(self) -> bool:
        """Terminal by *desired* state only — never by client status, so a
        crashed-but-restartable task keeps its resources accounted."""
        return self.desired_status in (ALLOC_DESIRED_STATUS_STOP,
                                       ALLOC_DESIRED_STATUS_EVICT,
                                       ALLOC_DESIRED_STATUS_FAILED)


# ---------------------------------------------------------------------------
# Evaluation (reference: structs.go:1293-1409)
# ---------------------------------------------------------------------------

@dataclass
class Evaluation(_Struct):
    id: str = ""
    priority: int = JOB_DEFAULT_PRIORITY
    type: str = JOB_TYPE_SERVICE
    triggered_by: str = ""
    job_id: str = ""
    job_modify_index: int = 0
    node_id: str = ""
    node_modify_index: int = 0
    status: str = EVAL_STATUS_PENDING
    status_description: str = ""
    wait: float = 0.0  # seconds
    next_eval: str = ""
    previous_eval: str = ""
    create_index: int = 0
    modify_index: int = 0
    # Trace context (obs/trace.py): {"trace_id", "span_id"} of the
    # eval's anchor span, stamped at creation by the serving endpoint
    # and carried across the raft wire so broker/worker/applier spans
    # on any thread (or server) join the same tree.  Empty when tracing
    # is off.
    trace: dict = field(default_factory=dict)

    def terminal_status(self) -> bool:
        return self.status in (EVAL_STATUS_COMPLETE, EVAL_STATUS_FAILED)

    def should_enqueue(self) -> bool:
        if self.status == EVAL_STATUS_PENDING:
            return True
        if self.status in (EVAL_STATUS_COMPLETE, EVAL_STATUS_FAILED):
            return False
        raise ValueError(f"unhandled eval ({self.id}) status {self.status}")

    def make_plan(self, job: Optional[Job]) -> "Plan":
        return Plan(
            eval_id=self.id,
            priority=self.priority,
            all_at_once=bool(job.all_at_once) if job else False,
            # The plan joins its eval's span tree: queue/verify/commit
            # spans parent to the eval's anchor.
            trace=dict(self.trace),
        )

    def next_rolling_eval(self, wait: float) -> "Evaluation":
        return Evaluation(
            id=generate_uuid(),
            priority=self.priority,
            type=self.type,
            triggered_by=EVAL_TRIGGER_ROLLING_UPDATE,
            job_id=self.job_id,
            job_modify_index=self.job_modify_index,
            status=EVAL_STATUS_PENDING,
            wait=wait,
            previous_eval=self.id,
        )


# ---------------------------------------------------------------------------
# Plan / PlanResult (reference: structs.go:1414-1527)
# ---------------------------------------------------------------------------

@dataclass
class Plan(_Struct):
    _NESTED = {
        "node_update": ("dict", ("list", Allocation)),
        "node_allocation": ("dict", ("list", Allocation)),
        "failed_allocs": ("list", Allocation),
    }

    eval_id: str = ""
    eval_token: str = ""
    priority: int = JOB_DEFAULT_PRIORITY
    all_at_once: bool = False
    node_update: dict = field(default_factory=dict)       # node_id -> [Alloc]
    node_allocation: dict = field(default_factory=dict)   # node_id -> [Alloc]
    failed_allocs: list = field(default_factory=list)
    # Overload control plane: absolute MONOTONIC deadline on this
    # host's clock (0.0 = none).  The applier drops expired plans
    # instead of verifying them (server/plan_apply.py expired_drops).
    # Host-local only — the Plan.Submit endpoint re-stamps it from the
    # RPC envelope's relative budget, never trusting a wire value.
    deadline: float = 0.0
    # Trace context (obs/trace.py): the owning eval's anchor, stamped
    # by Evaluation.make_plan and carried through Plan.Submit so the
    # leader's queue-wait/verify/raft/upsert spans join the tree.
    trace: dict = field(default_factory=dict)

    def append_update(self, alloc: Allocation, status: str, desc: str) -> None:
        new = alloc.copy()
        new.desired_status = status
        new.desired_description = desc
        self.node_update.setdefault(alloc.node_id, []).append(new)

    def pop_update(self, alloc: Allocation) -> None:
        existing = self.node_update.get(alloc.node_id, [])
        if existing and existing[-1].id == alloc.id:
            existing.pop()
            if not existing:
                self.node_update.pop(alloc.node_id, None)

    def append_alloc(self, alloc: Allocation) -> None:
        self.node_allocation.setdefault(alloc.node_id, []).append(alloc)

    def append_failed(self, alloc: Allocation) -> None:
        self.failed_allocs.append(alloc)

    def is_noop(self) -> bool:
        return (not self.node_update and not self.node_allocation
                and not self.failed_allocs)


@dataclass
class PlanResult(_Struct):
    _NESTED = {
        "node_update": ("dict", ("list", Allocation)),
        "node_allocation": ("dict", ("list", Allocation)),
        "failed_allocs": ("list", Allocation),
    }

    node_update: dict = field(default_factory=dict)
    node_allocation: dict = field(default_factory=dict)
    failed_allocs: list = field(default_factory=list)
    refresh_index: int = 0
    alloc_index: int = 0

    def is_noop(self) -> bool:
        return (not self.node_update and not self.node_allocation
                and not self.failed_allocs)

    def full_commit(self, plan: Plan) -> tuple[bool, int, int]:
        pna = plan.node_allocation
        expected = sum(map(len, pna.values()))
        if self.node_allocation is pna:
            # Result shares the plan's dict (nothing was trimmed):
            # committed in full by construction.
            return True, expected, expected
        sna = self.node_allocation
        actual = 0
        for k in pna:
            v = sna.get(k)
            if v is not None:
                actual += len(v)
        return actual == expected, expected, actual
