"""RPC endpoints: the server's wire API.

Capability parity with reference nomad/{status,node,job,eval,plan,
alloc}_endpoint.go: every mutating endpoint raft-applies then (where the
reference does) creates evaluations; reads support blocking queries
(min_query_index + max wait with jitter, reference nomad/rpc.go:269-338)
and stale reads; on a follower, writes AND non-stale reads forward to the
leader over the conn pool — default reads are consistent, ``stale`` opts
into follower-local answers (reference nomad/rpc.go:162-227).

Wire shapes are the structs' dict forms; query options ride in the args map
("min_query_index", "max_query_time", "stale", "region").

Counterpart of ``nomad_tpu/server/endpoints.py``, with every service
of its ``install``; a request for another region goes to a server the
port's server knows there (gossip or ``add_region_server``).
"""
from __future__ import annotations

import random
import threading
from typing import Optional

from nomad_tpu_torch import faultinject
from nomad_tpu_torch.obs import trace as trace_mod
from nomad_tpu_torch.structs import Allocation, Evaluation, Job, Node

from . import mux
from . import overload as overload_mod

MAX_BLOCKING_WAIT = 300.0  # reference nomad/rpc.go:30-40

# Query endpoints whose default is a consistent (leader-served) read;
# ``stale`` in the args opts into a follower-local answer.  Status.* is
# deliberately absent — it reports the answering server's own view.
CONSISTENT_READS = frozenset({
    "Node.GetNode", "Node.GetAllocs", "Node.List",
    "Job.GetJob", "Job.List", "Job.Allocations", "Job.Evaluations",
    "Eval.GetEval", "Eval.List", "Eval.Allocations",
    "Alloc.List", "Alloc.GetAlloc",
})


def _jittered(wait: float) -> float:
    wait = min(wait, MAX_BLOCKING_WAIT)
    return wait + wait * random.random() / 16


class Endpoints:
    """All RPC services for one server; registered onto an RPCServer."""

    def __init__(self, server) -> None:
        self.server = server

    def install(self, rpc_server) -> None:
        registered: set = set()
        for service, methods in {
            "Status": ["Ping", "Version", "Leader", "Peers"],
            "Node": ["Register", "Deregister", "UpdateStatus",
                     "UpdateDrain", "Evaluate", "GetNode", "GetAllocs",
                     "UpdateAlloc", "List", "Heartbeat"],
            "Job": ["Register", "Deregister", "Evaluate", "GetJob",
                    "List", "Allocations", "Evaluations"],
            "Eval": ["GetEval", "Dequeue", "Ack", "Nack", "Update",
                     "Create", "Reap", "List", "Allocations"],
            "Plan": ["Submit"],
            "Alloc": ["List", "GetAlloc"],
            "System": ["GarbageCollect"],
        }.items():
            for m in methods:
                handler = getattr(self, f"{service.lower()}_{_snake(m)}")
                full = f"{service}.{m}"
                if full in CONSISTENT_READS:
                    handler = self._with_leader_reads(full, handler)
                handler = self._with_region(full, handler)
                rpc_server.register(full,
                                    self._with_admission(full, handler))
                registered.add(full)
        # Guard against drift: a typo'd CONSISTENT_READS entry would
        # silently leave that read follower-local.
        missing = CONSISTENT_READS - registered
        if missing:
            raise RuntimeError(
                f"CONSISTENT_READS names unregistered methods: {missing}")

    # -- plumbing ---------------------------------------------------------
    def _with_admission(self, method: str, handler):
        """Overload control at the RPC plane, outermost on EVERY
        endpoint (server/overload.py): the arriving envelope's relative
        deadline is converted once to this host's monotonic clock, the
        ``rpc.admit`` fault site fires, and the admission controller
        sheds by priority class — heartbeats bypass on their lane.  A
        shed request costs one state check and an exception: the whole
        point is that rejecting is radically cheaper than serving."""
        def admitted(args: dict):
            overload_mod.stamp_arrival(args)
            # Re-fetch AND None-check behind the ENABLED gate: a
            # concurrent disable() (scoped tracing in tests/bench)
            # must degrade an in-flight request to untraced, never
            # fail it (same discipline at every instrumentation site).
            tracer = trace_mod.tracer() if trace_mod.ENABLED else None
            if tracer is not None:
                # Serve span, parented to the wire envelope's client
                # span (obs/trace.py).  Ambient for the handler body:
                # evals created inside anchor under it, and in-proc
                # call chains (job_register -> apply_eval_update) nest.
                with tracer.span("rpc.serve." + method,
                                 ctx=trace_mod.extract(args),
                                 method=method):
                    return self._admitted_body(method, handler, args)
            return self._admitted_body(method, handler, args)
        return admitted

    def _admitted_body(self, method: str, handler, args: dict):
        """The admission body behind the (optional) serve span."""
        if "_watch_fired" in args:
            # A resumed parked blocking query was admitted when it
            # arrived; it is NOT a new arrival.  Re-admitting here
            # could shed an already-accepted request mid-wait with
            # ErrOverloaded instead of the answered-with-current-
            # state reply the blocking-query contract guarantees
            # (and would double-fire the rpc.admit site per logical
            # request).  stamp_arrival is idempotent, so the
            # original envelope deadline survives the resume.
            return handler(args)
        if faultinject.ACTIVE:
            faultinject.fire_rpc("rpc.admit", method, args)
        ctrl = self.server.overload
        if ctrl is not None:
            ctrl.admit_rpc(method, args)  # raises ErrOverloaded
        return handler(args)

    def _with_leader_reads(self, method: str, handler):
        """Default-consistent reads (reference nomad/rpc.go:175-185): a
        follower forwards the query to the leader unless the caller set
        ``stale`` — _forward already returns None for stale requests,
        leaders, and already-forwarded hops."""
        def routed(args: dict):
            fwd = self._forward(method, args)
            if fwd is not None:
                return fwd
            return handler(args)
        return routed

    def _with_region(self, method: str, handler):
        """Region routing for EVERY endpoint, reads included (reference
        nomad/rpc.go:162-227 ``forward`` stage 1): a request addressed to
        another region goes to a random server there; an unknown region
        errors — it must never silently execute locally."""
        def routed(args: dict):
            region = args.get("region")
            if region and region != self.server.config.region:
                if args.get("_region_forwarded"):
                    raise RuntimeError(
                        f"region forwarding loop: this server is in "
                        f"{self.server.config.region!r}, request wants "
                        f"{region!r}")
                addr = self.server.region_server(region)
                fwd_args = overload_mod.restamp_forward(dict(args))
                fwd_args["_region_forwarded"] = True
                # A forward can hold this dispatch worker for a whole
                # blocking-query window (the remote side parks, WE
                # can't): mark it blocking so the pool spawns bounded
                # overflow instead of letting a handful of forwarded
                # long-polls pin every worker and starve heartbeats.
                # Clip the transport wait to the re-based budget:
                # restamp_forward wrote the caller's remaining envelope
                # into _deadline, and without an explicit timeout the
                # hop would wait the transport default (330s) instead.
                # No envelope -> None -> default, unchanged.
                with mux.blocking_section():
                    return self.server.conn_pool.call(
                        addr, method, fwd_args,
                        timeout=fwd_args.get(overload_mod.DEADLINE_KEY))
            return handler(args)
        return routed

    def _forward(self, method: str, args: dict) -> Optional[dict]:
        """Returns None if this server should handle the request, else the
        forwarded response from the in-region leader (reference
        nomad/rpc.go ``forward`` stage 2; stage 1 — region routing — runs
        in _with_region before any handler).  Guards: never forward to
        self (leadership-transition window) and at most one hop."""
        if self.server.is_leader():
            return None
        if args.get("stale"):
            return None
        if args.get("_forwarded"):
            # Second hop: handle locally rather than bouncing between
            # servers with stale leadership views.
            return None
        leader = self.server.leader_rpc_address()
        if leader is None:
            raise RuntimeError("no cluster leader")
        if tuple(leader) == self.server.rpc_address():
            return None
        fwd_args = overload_mod.restamp_forward(dict(args))
        fwd_args["_forwarded"] = True
        # Same reasoning as the region forward: a leader-forwarded
        # blocking query parks on the LEADER; this follower's worker
        # waits it out synchronously, so mark the wait blocking and
        # let the pool overflow (bounded) rather than pinning workers.
        # Same budget clip as the region hop: the leader forward must
        # not outwait the caller's re-based envelope.
        with mux.blocking_section():
            return self.server.conn_pool.call(
                tuple(leader), method, fwd_args,
                timeout=fwd_args.get(overload_mod.DEADLINE_KEY))

    def _state(self):
        return self.server.fsm.state

    def _blocking(self, args: dict, table: str, run) -> dict:
        """Blocking-query wrapper: wait until the table index passes
        min_query_index or the (jittered, capped) wait expires.

        On the event-driven serving plane the wait is not a parked
        thread: the handler raises ``mux.Parked`` carrying a watch-fan-
        out subscription and the dispatch worker is freed; the request
        re-enters this function (``_watch_fired`` stamped) when the
        index advances or the TTL-wheel timeout fires, and answers with
        current state either way — byte-identical responses to the
        synchronous path (tests/test_blocking_query_port.py locks both
        down).  Synchronous callers (in-proc agent RPC) park ONE shared
        fan-out waiter and wait on a local event — registered once,
        deregistered in ``finally``, so an abandoned wait can never
        leak a registry entry."""
        min_index = int(args.get("min_query_index") or 0)
        state = self._state()
        fired = args.pop("_watch_fired", None)

        def respond() -> dict:
            out = run()
            out["index"] = self._state().get_index(table)
            out["known_leader"] = self.server.has_leader()
            return out

        if min_index <= 0 or fired is not None or \
                state.get_index(table) > min_index:
            return respond()
        wait = _jittered(float(args.get("max_query_time") or
                               MAX_BLOCKING_WAIT))
        # Deadline envelope (server/overload.py): never wait past the
        # caller's remaining budget — a reply past it talks to nobody.
        wait = overload_mod.remaining(
            overload_mod.absolute_deadline(args), wait)
        if mux.parking_enabled():
            def _subscribe(resume):
                token = state.watch.subscribe(
                    (table,), resume, min_index=min_index, ttl=wait)
                return lambda: state.watch.unsubscribe(token)
            raise mux.Parked(_subscribe)
        woke = threading.Event()
        token = state.watch.subscribe((table,),
                                      lambda timed_out: woke.set(),
                                      min_index=min_index)
        try:
            woke.wait(wait)
        finally:
            state.watch.unsubscribe(token)
        return respond()

    # -- Status -----------------------------------------------------------
    def status_ping(self, args: dict) -> dict:
        return {}

    def status_version(self, args: dict) -> dict:
        from nomad_tpu_torch import __version__

        return {"version": __version__}

    def status_leader(self, args: dict) -> dict:
        leader = self.server.leader_rpc_address()
        return {"leader": f"{leader[0]}:{leader[1]}" if leader else ""}

    def status_peers(self, args: dict) -> dict:
        return {"peers": [f"{h}:{p}" for h, p in self.server.peers()]}

    # -- Node -------------------------------------------------------------
    def node_register(self, args: dict) -> dict:
        fwd = self._forward("Node.Register", args)
        if fwd is not None:
            return fwd
        node = Node.from_dict(args["node"])
        if not node.id:
            raise ValueError("missing node ID for client registration")
        if not node.datacenter:
            raise ValueError("missing datacenter for client registration")
        index = self.server.node_register(node)
        ttl = self.server.node_heartbeat(node.id) \
            if self.server.is_leader() else 0.0
        return {"index": index, "heartbeat_ttl": ttl,
                "eval_ids": self.server.create_node_evals(node.id, index)
                if _needs_evals(self._state(), node) else []}

    def node_deregister(self, args: dict) -> dict:
        fwd = self._forward("Node.Deregister", args)
        if fwd is not None:
            return fwd
        index = self.server.node_deregister(args["node_id"])
        return {"index": index}

    def node_update_status(self, args: dict) -> dict:
        fwd = self._forward("Node.UpdateStatus", args)
        if fwd is not None:
            return fwd
        index = self.server.node_update_status(args["node_id"],
                                               args["status"])
        ttl = 0.0
        if args["status"] == "ready":
            ttl = self.server.node_heartbeat(args["node_id"])
        return {"index": index, "heartbeat_ttl": ttl}

    def node_heartbeat(self, args: dict) -> dict:
        fwd = self._forward("Node.Heartbeat", args)
        if fwd is not None:
            return fwd
        ttl = self.server.node_heartbeat(args["node_id"])
        return {"heartbeat_ttl": ttl}

    def node_update_drain(self, args: dict) -> dict:
        fwd = self._forward("Node.UpdateDrain", args)
        if fwd is not None:
            return fwd
        index = self.server.node_update_drain(args["node_id"],
                                              bool(args["drain"]))
        return {"index": index}

    def node_evaluate(self, args: dict) -> dict:
        fwd = self._forward("Node.Evaluate", args)
        if fwd is not None:
            return fwd
        eval_ids = self.server.node_evaluate(args["node_id"])
        return {"eval_ids": eval_ids,
                "index": self.server.raft.applied_index()}

    def node_get_node(self, args: dict) -> dict:
        def run() -> dict:
            node = self._state().node_by_id(args["node_id"])
            return {"node": node.to_dict() if node else None}
        return self._blocking(args, "nodes", run)

    def node_get_allocs(self, args: dict) -> dict:
        def run() -> dict:
            allocs = self._state().allocs_by_node(args["node_id"])
            return {"allocs": [a.to_dict() for a in allocs]}
        return self._blocking(args, "allocs", run)

    def node_update_alloc(self, args: dict) -> dict:
        fwd = self._forward("Node.UpdateAlloc", args)
        if fwd is not None:
            return fwd
        from nomad_tpu_torch.structs import codec

        index = self.server.raft_apply(codec.ALLOC_CLIENT_UPDATE_REQUEST,
                                       {"alloc": args["alloc"]})
        return {"index": index}

    def node_list(self, args: dict) -> dict:
        def run() -> dict:
            return {"nodes": [n.to_dict() for n in self._state().nodes()]}
        return self._blocking(args, "nodes", run)

    # -- Job --------------------------------------------------------------
    def job_register(self, args: dict) -> dict:
        fwd = self._forward("Job.Register", args)
        if fwd is not None:
            return fwd
        job = Job.from_dict(args["job"])
        index, eval_id = self.server.job_register(job)
        return {"index": index, "eval_id": eval_id,
                "job_modify_index": index}

    def job_deregister(self, args: dict) -> dict:
        fwd = self._forward("Job.Deregister", args)
        if fwd is not None:
            return fwd
        index, eval_id = self.server.job_deregister(args["job_id"])
        return {"index": index, "eval_id": eval_id}

    def job_evaluate(self, args: dict) -> dict:
        fwd = self._forward("Job.Evaluate", args)
        if fwd is not None:
            return fwd
        job = self._state().job_by_id(args["job_id"])
        if job is None:
            raise KeyError(f"job not found: {args['job_id']}")
        from nomad_tpu_torch.structs import generate_uuid

        ev = Evaluation(
            id=generate_uuid(), priority=job.priority, type=job.type,
            triggered_by="job-register", job_id=job.id,
            job_modify_index=job.modify_index, status="pending")
        self.server.apply_eval_update([ev])
        return {"eval_id": ev.id,
                "index": self.server.raft.applied_index()}

    def job_get_job(self, args: dict) -> dict:
        def run() -> dict:
            job = self._state().job_by_id(args["job_id"])
            return {"job": job.to_dict() if job else None}
        return self._blocking(args, "jobs", run)

    def job_list(self, args: dict) -> dict:
        def run() -> dict:
            return {"jobs": [j.to_dict() for j in self._state().jobs()]}
        return self._blocking(args, "jobs", run)

    def job_allocations(self, args: dict) -> dict:
        def run() -> dict:
            allocs = self._state().allocs_by_job(args["job_id"])
            return {"allocations": [a.to_dict() for a in allocs]}
        return self._blocking(args, "allocs", run)

    def job_evaluations(self, args: dict) -> dict:
        def run() -> dict:
            evals = self._state().evals_by_job(args["job_id"])
            return {"evaluations": [e.to_dict() for e in evals]}
        return self._blocking(args, "evals", run)

    # -- Eval -------------------------------------------------------------
    def eval_get_eval(self, args: dict) -> dict:
        def run() -> dict:
            ev = self._state().eval_by_id(args["eval_id"])
            return {"eval": ev.to_dict() if ev else None}
        return self._blocking(args, "evals", run)

    def eval_dequeue(self, args: dict) -> dict:
        fwd = self._forward("Eval.Dequeue", args)
        if fwd is not None:
            return fwd
        # Deadline propagation: never block longer than the caller's
        # remaining budget — a reply past it talks to nobody.
        timeout = overload_mod.remaining(
            overload_mod.absolute_deadline(args),
            float(args.get("timeout") or 0.5))
        # A broker long-poll from a wire worker holds this dispatch
        # worker for its whole wait (the broker's condition wait can't
        # park) — mark it blocking so the pool overflows (bounded)
        # rather than letting remote dequeuers pin the plane.
        with mux.blocking_section():
            ev, token = self.server.eval_broker.dequeue(
                args["schedulers"], timeout)
        return {"eval": ev.to_dict() if ev else None, "token": token}

    def eval_ack(self, args: dict) -> dict:
        fwd = self._forward("Eval.Ack", args)
        if fwd is not None:
            return fwd
        self.server.eval_broker.ack(args["eval_id"], args["token"])
        return {}

    def eval_nack(self, args: dict) -> dict:
        fwd = self._forward("Eval.Nack", args)
        if fwd is not None:
            return fwd
        self.server.eval_broker.nack(args["eval_id"], args["token"])
        return {}

    def eval_update(self, args: dict) -> dict:
        fwd = self._forward("Eval.Update", args)
        if fwd is not None:
            return fwd
        evals = [Evaluation.from_dict(e) for e in args["evals"]]
        index = self.server.apply_eval_update(evals,
                                              args.get("eval_token", ""))
        return {"index": index}

    def eval_create(self, args: dict) -> dict:
        return self.eval_update(args)

    def eval_reap(self, args: dict) -> dict:
        fwd = self._forward("Eval.Reap", args)
        if fwd is not None:
            return fwd
        from nomad_tpu_torch.structs import codec

        index = self.server.raft_apply(
            codec.EVAL_DELETE_REQUEST,
            {"evals": args.get("evals", []),
             "allocs": args.get("allocs", [])})
        return {"index": index}

    def eval_list(self, args: dict) -> dict:
        def run() -> dict:
            return {"evaluations": [e.to_dict()
                                    for e in self._state().evals()]}
        return self._blocking(args, "evals", run)

    def eval_allocations(self, args: dict) -> dict:
        def run() -> dict:
            allocs = self._state().allocs_by_eval(args["eval_id"])
            return {"allocations": [a.to_dict() for a in allocs]}
        return self._blocking(args, "allocs", run)

    # -- Plan -------------------------------------------------------------
    def plan_submit(self, args: dict) -> dict:
        fwd = self._forward("Plan.Submit", args)
        if fwd is not None:
            return fwd
        from nomad_tpu_torch.structs import Plan

        plan = Plan.from_dict(args["plan"])
        # The wire value is another host's monotonic clock — meaningless
        # here.  Re-stamp from the envelope's relative budget: the
        # applier drops the plan unverified once it expires.
        deadline = overload_mod.absolute_deadline(args)
        plan.deadline = deadline
        future = self.server.plan_queue.enqueue(plan)
        # The commit wait holds this dispatch worker until the applier
        # answers — blocking, same overflow reasoning as Eval.Dequeue.
        with mux.blocking_section():
            result = future.wait(overload_mod.remaining(deadline, 60.0))
        return {"result": result.to_dict() if result else None}

    # -- Alloc ------------------------------------------------------------
    def alloc_list(self, args: dict) -> dict:
        def run() -> dict:
            return {"allocations": [a.to_dict()
                                    for a in self._state().allocs()]}
        return self._blocking(args, "allocs", run)

    def alloc_get_alloc(self, args: dict) -> dict:
        def run() -> dict:
            alloc = self._state().alloc_by_id(args["alloc_id"])
            return {"alloc": alloc.to_dict() if alloc else None}
        return self._blocking(args, "allocs", run)

    # -- System -----------------------------------------------------------
    def system_garbage_collect(self, args: dict) -> dict:
        """Operator-requested GC (reference nomad/system_endpoint.go):
        the leader enqueues one force-gc core eval; both collectors
        then run with their age thresholds bypassed.  Leader-local like
        every core eval — the enqueue skips raft."""
        fwd = self._forward("System.GarbageCollect", args)
        if fwd is not None:
            return fwd
        from nomad_tpu_torch.structs import CORE_JOB_FORCE_GC

        self.server._enqueue_core_eval(CORE_JOB_FORCE_GC)
        return {"index": self.server.raft.applied_index()}


def _needs_evals(state, node: Node) -> bool:
    """A (re-)registering node triggers evals when it transitions into the
    ready state with things to schedule (node_endpoint.go:64-90)."""
    return node.status == "ready"


def _snake(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i > 0:
            out.append("_")
        out.append(ch.lower())
    return "".join(out)
