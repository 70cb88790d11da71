"""Fault plans: named-site rules with deterministic, seedable firing.

A ``FaultPlan`` is a set of rules keyed by *site* — a chokepoint the
runtime consults (``faultinject.fire``) on every pass through it.  Each
rule carries an action, an optional probability, a fire budget, and
match predicates, so a test (or an operator reproducing an incident)
can say precisely "drop the 3rd..5th Node.UpdateAlloc frames" or "hang
one device collect" and get the same failure sequence on every run:
the plan owns a ``random.Random(seed)``, so probabilistic rules are a
deterministic function of (seed, consultation order).

Spec grammar (``NOMAD_TPU_FAULTS`` or ``FaultPlan.parse``)::

    spec    := clause (';' clause)*
    clause  := 'seed' '=' INT
             | site '=' action [ '(' param (',' param)* ')' ]
    action  := 'error' | 'drop' | 'delay' | 'hang'
    param   := 'p' '=' FLOAT          probability per consultation (1.0)
             | 'count' '=' INT        total fires allowed (unlimited)
             | 'after' '=' INT        matches skipped before arming (0)
             | 'secs' '=' FLOAT       delay/hang duration
             | 'method' '=' NAME      RPC method predicate ('*' suffix ok)
             | 'node' '=' ID          node-id predicate ('*' suffix ok)

Example::

    NOMAD_TPU_FAULTS='seed=7;rpc.send=drop(p=0.5,count=3,method=Node.*);device.collect=hang(secs=2)'

Actions:

``error``
    raise ``FaultInjected`` — the generic "this step failed" fault.
``drop``
    raise ``FaultDropped`` (a ``ConnectionError``) — a lost frame.  The
    RPC receive plane special-cases it: the request is swallowed with
    no reply, so the caller sees only its own timeout, exactly like a
    frame lost on the wire.
``delay``
    sleep ``secs`` (default 0.05) and continue — added latency.
``hang``
    sleep ``secs`` (default 300) and continue — a stall long enough
    that any deadline-bounded caller gives up first.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

# The named chokepoints.  Instrumented call sites pass one of these to
# ``fire``; ``parse``/``FaultPlan.add`` reject anything else so a typo
# in a spec fails loudly instead of silently injecting nothing.
SITES = (
    "rpc.send",           # client/conn-pool about to send a request
    "rpc.recv",           # server received a request, pre-dispatch
    "rpc.admit",          # admission control deciding on a request
    "raft.apply",         # an entry entering the replicated log
    "heartbeat.deliver",  # a node heartbeat reaching the leader
    "broker.enqueue",     # an evaluation entering the eval broker
    "device.dispatch",    # a device placement dispatch starting
    "device.collect",     # blocking on a device dispatch's results
    "driver.start",       # a task driver starting a task
    "mux.accept",         # the serving-plane event loop accepting a conn
    "conn.read",          # bytes arriving on a multiplexed client conn
    "watch.deliver",      # the watch fan-out waking a matured waiter
    "log.append",         # a raft log record about to be written
    "log.fsync",          # a written raft log record about to be fsynced
    "snapshot.persist",   # an FSM snapshot file being persisted
    "meta.persist",       # raft term/vote metadata being persisted
)

# The durable-storage chokepoints (server/raft.py FileLogStore /
# SnapshotStore / MetaStore).  They are the only sites where the
# ``crash`` action is legal: a simulated power loss is meaningless at a
# site with no bytes in flight to tear.
STORAGE_SITES = (
    "log.append",
    "log.fsync",
    "snapshot.persist",
    "meta.persist",
)

# Which match-predicate context each site's instrumentation supplies.
# A rule whose predicate a site can never satisfy would silently never
# fire — the worst chaos-run outcome — so add()/parse() reject it.
# (driver.start passes the driver name as ``method``.)
SITE_CONTEXT = {
    "rpc.send": ("method", "node"),
    "rpc.recv": ("method", "node"),
    "rpc.admit": ("method", "node"),
    "raft.apply": (),
    "heartbeat.deliver": ("node",),
    # broker.enqueue passes the eval's scheduler type as ``method`` and
    # its node id (node-update evals) as ``node``.
    "broker.enqueue": ("method", "node"),
    "device.dispatch": (),
    "device.collect": (),
    "driver.start": ("method",),
    # Serving-plane edge sites: accept/read know nothing about the
    # request yet (frames decode later), so they carry no predicates;
    # watch.deliver passes the watch key's table name as ``method``.
    "mux.accept": (),
    "conn.read": (),
    "watch.deliver": ("method",),
    # Storage sites pass the store's on-disk path as ``method`` so a
    # multi-server soak can target ONE server's data_dir with a
    # ``method=/tmp/cluster/s1*`` prefix predicate.
    "log.append": ("method",),
    "log.fsync": ("method",),
    "snapshot.persist": ("method",),
    "meta.persist": ("method",),
}

ACTIONS = ("error", "drop", "delay", "hang", "crash")

DELAY_DEFAULT_SECS = 0.05
HANG_DEFAULT_SECS = 300.0


class FaultInjected(Exception):
    """An injected generic failure."""


class FaultDropped(ConnectionError):
    """An injected lost frame (transport-shaped, hence retryable)."""


class FaultCrash(Exception):
    """A simulated power loss at a durable-storage site.

    The instrumented store reacts before propagating: it leaves the
    file exactly as a mid-write power cut would — ``fraction`` of the
    in-flight bytes durable (``mode="torn"``), or all of them with one
    bit-rotted byte (``mode="corrupt"``) — marks itself dead (no
    further writes may land: the process "died"), and latches the
    owning plan's crash scope so every other storage site the fired
    rule covers refuses writes too until a CrashHarness reboot resets
    it (an unscoped rule covers the whole process; a ``method`` path
    prefix confines the blast radius to one server's data_dir).  Both
    knobs are drawn from the plan's seeded RNG, so one seed replays
    one exact torn-byte layout.
    """

    def __init__(self, site: str, fraction: float, mode: str) -> None:
        super().__init__(
            f"injected crash at {site} (mode={mode}, "
            f"fraction={fraction:.3f})")
        self.site = site
        self.fraction = fraction
        self.mode = mode

    def torn_length(self, total: int) -> int:
        """How many of ``total`` in-flight bytes the power cut left
        durable."""
        return max(0, min(total, int(self.fraction * (total + 1))))


class FaultSpecError(ValueError):
    """A NOMAD_TPU_FAULTS spec (or add() call) that doesn't parse."""


def _match(pattern: Optional[str], value: Optional[str]) -> bool:
    """Predicate match: None matches everything; a trailing '*' is a
    prefix match; otherwise exact."""
    if pattern is None:
        return True
    if value is None:
        return False
    if pattern.endswith("*"):
        return value.startswith(pattern[:-1])
    return value == pattern


class FaultRule:
    """One (site, action) rule.  Mutable counters are guarded by the
    owning plan's lock."""

    __slots__ = ("site", "action", "p", "count", "after", "secs",
                 "method", "node", "fired", "skipped")

    def __init__(self, site: str, action: str, p: float = 1.0,
                 count: Optional[int] = None, after: int = 0,
                 secs: Optional[float] = None,
                 method: Optional[str] = None,
                 node: Optional[str] = None) -> None:
        if site not in SITES:
            raise FaultSpecError(
                f"unknown fault site {site!r}; want one of {', '.join(SITES)}")
        if action not in ACTIONS:
            raise FaultSpecError(
                f"unknown fault action {action!r}; want one of "
                f"{', '.join(ACTIONS)}")
        if not 0.0 <= p <= 1.0:
            raise FaultSpecError(f"probability {p!r} outside [0, 1]")
        if action == "crash" and site not in STORAGE_SITES:
            raise FaultSpecError(
                f"action 'crash' is only valid at the storage sites "
                f"({', '.join(STORAGE_SITES)}); site {site!r} has no "
                f"bytes in flight to tear")
        supplied = SITE_CONTEXT[site]
        for key, value in (("method", method), ("node", node)):
            if value is not None and key not in supplied:
                raise FaultSpecError(
                    f"site {site!r} supplies no {key!r} context: a "
                    f"{key}= predicate there would silently never fire")
        self.site = site
        self.action = action
        self.p = p
        self.count = count
        self.after = after
        self.secs = secs
        self.method = method
        self.node = node
        self.fired = 0     # guarded by plan._lock
        self.skipped = 0   # guarded by plan._lock

    def matches(self, method: Optional[str], node: Optional[str]) -> bool:
        return _match(self.method, method) and _match(self.node, node)

    def __repr__(self) -> str:  # debugging/spec round-trip aid
        parts = []
        if self.p != 1.0:
            parts.append(f"p={self.p}")
        if self.count is not None:
            parts.append(f"count={self.count}")
        if self.after:
            parts.append(f"after={self.after}")
        if self.secs is not None:
            parts.append(f"secs={self.secs}")
        if self.method:
            parts.append(f"method={self.method}")
        if self.node:
            parts.append(f"node={self.node}")
        args = f"({','.join(parts)})" if parts else ""
        return f"{self.site}={self.action}{args}"


class FaultPlan:
    """A seeded set of fault rules, consulted via :meth:`fire`.

    Thread-safe: many runtime threads consult one plan; rule counters
    and the RNG are guarded by one lock.  ``fires`` records every
    injection performed — (site, action, method, node) — so tests can
    assert exactly what was injected.
    """

    FIRES_CAP = 4096  # the record is diagnostic, never unbounded

    def __init__(self, seed: Optional[int] = None) -> None:
        import random

        self._lock = threading.Lock()
        self._rng = random.Random(seed)    # guarded by _lock
        self.seed = seed
        self._rules: dict = {}             # site -> [FaultRule]; guarded
        self.fires: list = []              # injections done; guarded
        # Power-loss latch (guarded by _lock): each crash fire records
        # the fired rule's path scope (its ``method`` prefix, or "" =
        # everything when the rule was unscoped); while any scope is
        # latched, storage sites whose path falls inside it refuse
        # writes — the "dead process" writes nothing anywhere, but a
        # rule aimed at ONE server's data_dir only freezes THAT
        # server's stores.  CrashHarness.reboot() resets it for the
        # reborn process.
        self._crash_scopes: list = []

    def add(self, site: str, action: str, **kw) -> "FaultPlan":
        rule = FaultRule(site, action, **kw)
        with self._lock:
            self._rules.setdefault(site, []).append(rule)
        return self  # chainable: FaultPlan(seed=1).add(...).add(...)

    def rules(self, site: Optional[str] = None) -> list:
        with self._lock:
            if site is not None:
                return list(self._rules.get(site, ()))
            return [r for rules in self._rules.values() for r in rules]

    def fire_count(self, site: Optional[str] = None) -> int:
        with self._lock:
            return sum(1 for f in self.fires
                       if site is None or f[0] == site)

    def exhausted(self) -> bool:
        """Every counted rule has spent its budget (uncounted rules are
        never exhausted)."""
        with self._lock:
            rules = [r for rs in self._rules.values() for r in rs]
            return all(r.count is not None and r.fired >= r.count
                       for r in rules) if rules else True

    def is_crashed(self, path: Optional[str] = None) -> bool:
        """Whether the power-loss latch covers ``path`` (a store's
        on-disk location).  Without ``path``, any latched scope counts
        — callers that can't say where they write must assume the
        dead process is theirs."""
        with self._lock:
            return any(path is None or scope == ""
                       or path.startswith(scope)
                       for scope in self._crash_scopes)

    def reset_crashed(self) -> None:
        """A CrashHarness reboot: the dead process is gone, the reborn
        one's stores may write again."""
        with self._lock:
            del self._crash_scopes[:]

    # -- consultation ------------------------------------------------------
    def fire(self, site: str, method: Optional[str] = None,
             node: Optional[str] = None) -> None:
        """Consult the plan at ``site``.  Sleeps and/or raises per the
        first armed matching rule; returns silently when nothing fires.
        Decision + bookkeeping happen under the lock; the sleep itself
        does not (a delay/hang must not serialize unrelated threads).
        """
        sleep_secs = 0.0
        exc: Optional[Exception] = None
        with self._lock:
            for rule in self._rules.get(site, ()):
                if not rule.matches(method, node):
                    continue
                if rule.count is not None and rule.fired >= rule.count:
                    continue
                if rule.skipped < rule.after:
                    rule.skipped += 1
                    continue
                if rule.p < 1.0 and self._rng.random() >= rule.p:
                    continue
                rule.fired += 1
                if len(self.fires) < self.FIRES_CAP:
                    self.fires.append((site, rule.action, method, node))
                if rule.action == "crash":
                    # Seeded power loss: how much of the in-flight
                    # write survives, and whether the tail is torn or
                    # bit-rotted, are a function of (seed, order).
                    # The latch inherits the rule's path scope: a
                    # method=/data/s1* rule kills only s1's stores.
                    self._crash_scopes.append(
                        rule.method.rstrip("*") if rule.method else "")
                    mode = "corrupt" if self._rng.random() < 0.25 \
                        else "torn"
                    exc = FaultCrash(site, self._rng.random(), mode)
                    break
                if rule.action == "error":
                    exc = FaultInjected(
                        f"injected error at {site}"
                        + (f" ({method})" if method else ""))
                elif rule.action == "drop":
                    exc = FaultDropped(
                        f"injected drop at {site}"
                        + (f" ({method})" if method else ""))
                elif rule.action == "delay":
                    sleep_secs = rule.secs if rule.secs is not None \
                        else DELAY_DEFAULT_SECS
                else:  # hang
                    sleep_secs = rule.secs if rule.secs is not None \
                        else HANG_DEFAULT_SECS
                break  # first armed matching rule wins
        if sleep_secs > 0.0:
            time.sleep(sleep_secs)
        if exc is not None:
            raise exc

    # -- spec parsing ------------------------------------------------------
    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Build a plan from the NOMAD_TPU_FAULTS grammar (module
        docstring).  Raises FaultSpecError on anything malformed."""
        seed: Optional[int] = None
        clauses = []
        for raw in spec.split(";"):
            clause = raw.strip()
            if not clause:
                continue
            if "=" not in clause:
                raise FaultSpecError(
                    f"fault clause {clause!r} is missing '='")
            key, _, rest = clause.partition("=")
            key = key.strip()
            if key == "seed":
                try:
                    seed = int(rest.strip())
                except ValueError:
                    raise FaultSpecError(
                        f"seed {rest.strip()!r} is not an integer") from None
                continue
            clauses.append((key, rest.strip()))

        plan = cls(seed=seed)
        for site, rest in clauses:
            action, _, paren = rest.partition("(")
            action = action.strip()
            kw: dict = {}
            if paren:
                if not paren.endswith(")"):
                    raise FaultSpecError(
                        f"unterminated parameter list in {site}={rest!r}")
                for param in paren[:-1].split(","):
                    param = param.strip()
                    if not param:
                        continue
                    if "=" not in param:
                        raise FaultSpecError(
                            f"parameter {param!r} is missing '='")
                    pk, _, pv = param.partition("=")
                    pk, pv = pk.strip(), pv.strip()
                    if pk == "p":
                        kw["p"] = _parse_num(pk, pv, float)
                    elif pk == "count":
                        kw["count"] = _parse_num(pk, pv, int)
                    elif pk == "after":
                        kw["after"] = _parse_num(pk, pv, int)
                    elif pk == "secs":
                        kw["secs"] = _parse_num(pk, pv, float)
                    elif pk == "method":
                        kw["method"] = pv
                    elif pk == "node":
                        kw["node"] = pv
                    else:
                        raise FaultSpecError(
                            f"unknown fault parameter {pk!r}")
            plan.add(site, action, **kw)
        return plan


def _parse_num(key: str, value: str, kind):
    try:
        return kind(value)
    except ValueError:
        raise FaultSpecError(
            f"fault parameter {key}={value!r} is not a "
            f"{kind.__name__}") from None
