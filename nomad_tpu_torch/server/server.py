"""Server: wires raft/FSM, broker, plan queue, applier, and workers.

Capability parity with reference nomad/server.go + leader.go:
construction brings up the replicated log and the scheduling pipeline;
``establish_leadership`` enables the leader-only machinery (broker, plan
queue, plan applier, broker restore from state) and
``revoke_leadership`` tears it down.  In-process callers (tests, scripts)
use the ``job_register`` / ``node_*`` / ``apply_*`` methods directly — the
same in-proc shortcut the reference uses (agent.go:176-178); with
``enable_rpc`` the RPC plane (server/rpc.py, server/endpoints.py) serves
the same methods over the wire, with TLS when the cert and key are set.

Counterpart of ``nomad_tpu/server/server.py``: the in-memory raft or
networked raft (``raft_mode="net"``, server/raft_net.py; a leadership
change runs ``establish_leadership``/``revoke_leadership`` in order),
gossip membership that reconciles raft peers and region federation
(``enable_gossip``, ``add_region_server``), the feedback control plane
(``control_enabled``, nomad_tpu_torch/control) and ``abandon``, the
crash model of faultinject/crash.py.

The server computes on ``config.device``: ``None`` means ``cuda`` and
raises ``RuntimeError`` where no CUDA device is present; tests pass
``"cpu"``.  With ``use_device_scheduler=True`` one ``BatchWorker`` fuses
service/batch evals into one kernel launch on that device, and there is
no fallback to the sequential schedulers for a missing or failing
device.  ``use_device_scheduler=False`` runs plain workers with the
sequential ``service``/``batch`` schedulers, by choice.
"""
from __future__ import annotations

import logging
import random
import threading
import time
from typing import Optional

from nomad_tpu_torch.parallel.devices import resolve_device
from nomad_tpu_torch.structs import (
    CORE_JOB_EVAL_GC,
    CORE_JOB_NODE_GC,
    CORE_JOB_PRIORITY,
    EVAL_STATUS_FAILED,
    Evaluation,
    Job,
    Node,
    codec,
    generate_uuid,
    should_drain_node,
    valid_node_status,
)

from nomad_tpu_torch.obs import trace as obs_trace

from .eval_broker import FAILED_QUEUE, EvalBroker
from .fsm import NomadFSM
from .heartbeat import HeartbeatManager
from .overload import ErrOverloaded, OverloadController
from .plan_apply import PlanApplier
from .plan_queue import PlanQueue
from .raft import (
    FileLogStore,
    InmemRaft,
    SnapshotStore,
    resolve_snapshot_dir,
)
from .rpc import ConnPool, RPCServer, client_tls_context, server_tls_context
from .worker import BatchWorker, Worker

logger = logging.getLogger("nomad_tpu_torch.server")

DEFAULT_SCHEDULERS = ["service", "batch", "system", "_core"]

class ServerConfig:
    """Tunables (reference nomad/config.go:46-236).

    The same keys as the JAX package's ``ServerConfig``, plus ``device``
    (where placement and verification compute; ``None`` = ``cuda``)."""

    def __init__(self, **kw) -> None:
        self.data_dir: Optional[str] = None
        self.num_schedulers: int = 2
        self.enabled_schedulers: list = list(DEFAULT_SCHEDULERS)
        self.eval_nack_timeout: float = 60.0
        self.eval_delivery_limit: int = 3
        self.use_device_scheduler: bool = True   # torch placement
        self.device_batch: int = 64
        self.device: Optional[str] = None        # None = cuda
        # Placement-kernel executor: auto | host | device
        # (scheduler/executor.py; NOMAD_TPU_EXECUTOR env still wins).
        self.executor: str = "auto"
        self.failed_eval_reap_interval: float = 60.0
        self.eval_gc_interval: float = 300.0
        self.eval_gc_threshold: float = 3600.0
        self.node_gc_interval: float = 300.0
        self.node_gc_threshold: float = 24 * 3600.0
        self.region: str = "global"
        # Overload control plane (server/overload.py): queue bounds
        # feed admission pressure; brownout/overload thresholds drive
        # priority shedding; heartbeat knobs drive expiry damping.
        self.broker_depth_limit: int = 4096
        self.plan_queue_depth: int = 1024
        self.overload_brownout_ratio: float = 0.75
        self.overload_ratio: float = 1.0
        self.heartbeat_seed: Optional[int] = None  # seeded TTL jitter
        self.heartbeat_reconcile_rate: float = 32.0  # expiries/s pacing
        self.heartbeat_reconcile_burst: float = 8.0
        # Feedback control plane (nomad_tpu_torch/control): a seeded
        # tick thread adjusting the live knobs above (broker depth limit,
        # brownout/overload ratios, applier window/run-ahead/gather)
        # from the metrics registry's gauges, inside hard rails.  Off
        # by default: tuning is an opt-in behavior change.
        self.control_enabled: bool = False
        self.control_interval: float = 0.25
        self.control_seed: int = 0
        self.enable_rpc: bool = False
        self.bind_addr: str = "127.0.0.1"
        self.rpc_port: int = 0      # 0 = ephemeral
        # Event-driven serving plane (server/mux.py): one selector loop
        # owns every client socket; a bounded pool runs handlers.
        # Resource usage is O(these knobs), never O(connected clients).
        self.rpc_dispatch_workers: int = 8
        self.rpc_dispatch_queue: int = 1024
        self.rpc_max_conns: int = 20000    # past it: shed ErrOverloaded
        self.rpc_idle_timeout: float = 600.0
        self.rpc_read_deadline: float = 30.0  # slowloris/partial-frame reap
        self.raft_mode: str = "inmem"   # "inmem" | "net"
        self.raft_peers: list = []      # [(host, port), ...]
        self.enable_gossip: bool = False
        self.gossip_port: int = 0
        self.server_name: str = ""
        self.raft_election_timeout: tuple = (0.15, 0.30)
        self.raft_heartbeat_interval: float = 0.05
        self.raft_snapshot_threshold: int = 8192
        self.bootstrap_expect: int = 1
        self.tune_gc: bool = True   # server-process GC thresholds+freeze
        # TLS on the RPC plane (0x04 demux, reference nomad/rpc.go:73-117):
        # when cert+key are set the listener accepts TLS connections and
        # the server's own ConnPool dials peers over TLS.
        self.tls_cert_file: str = ""
        self.tls_key_file: str = ""
        self.tls_ca_file: str = ""
        self.tls_verify_client: bool = False
        # Reject plaintext planes on the listener (mTLS deployments).
        self.tls_require: bool = False
        # Expected peer cert name for inter-server dials; empty = verify
        # the CA chain only (servers are usually addressed by raw IP).
        self.tls_server_name: str = ""
        for k, v in kw.items():
            if not hasattr(self, k):
                raise TypeError(f"unknown config key {k!r}")
            setattr(self, k, v)


class Server:
    def __init__(self, config: Optional[ServerConfig] = None) -> None:
        self.config = config or ServerConfig()
        self.device = resolve_device(self.config.device)
        from nomad_tpu_torch.scheduler.executor import (
            executor_policy,
            set_executor_policy,
        )
        if self.config.executor != "auto":
            # Process-wide: the executor choice is a property of the
            # machine, not of one worker.  A bad value fails the boot
            # here, not the first dispatch.
            set_executor_policy(self.config.executor)
        # Resolve once now so a typo'd $NOMAD_TPU_EXECUTOR also fails
        # the boot, not the first dispatch.
        executor_policy()
        if self.config.tune_gc:
            # Scheduler churn + a large live store make default GC
            # thresholds cost long full-collection pauses.
            from nomad_tpu_torch.utils.gctune import tune_gc
            tune_gc()
        # Overload control plane: one controller watches every queue
        # and gates every admission point (server/overload.py).
        self.overload = OverloadController(
            brownout_ratio=self.config.overload_brownout_ratio,
            overload_ratio=self.config.overload_ratio)
        self.eval_broker = EvalBroker(
            self.config.eval_nack_timeout,
            self.config.eval_delivery_limit,
            admission=self.overload,
            max_depth=self.config.broker_depth_limit)
        self.plan_queue = PlanQueue(
            max_depth=self.config.plan_queue_depth)
        self.overload.add_source(
            "eval_broker",
            lambda: (self.eval_broker.depth(),
                     self.config.broker_depth_limit))
        self.overload.add_source(
            "plan_queue",
            lambda: (self.plan_queue.depth(),
                     self.config.plan_queue_depth))
        self.fsm = NomadFSM(eval_broker=self.eval_broker)

        self.heartbeats = HeartbeatManager(
            self, overload=self.overload,
            rng=random.Random(self.config.heartbeat_seed)
            if self.config.heartbeat_seed is not None else None,
            reconcile_rate=self.config.heartbeat_reconcile_rate,
            reconcile_burst=self.config.heartbeat_reconcile_burst)
        self.workers: list = []
        self._leader = False
        self._shutdown = threading.Event()
        self._leader_threads: list = []
        # Set once construction finished (or shutdown began): networked
        # raft can elect this server while its components are still
        # being built, and the leadership callback waits for them.
        self._built = threading.Event()
        self.controller = None

        # The RPC plane's TLS files load here, before any thread starts:
        # a bad cert fails the boot.
        server_tls = client_tls = None
        if self.config.tls_cert_file:
            server_tls = server_tls_context(
                self.config.tls_cert_file, self.config.tls_key_file,
                ca_file=self.config.tls_ca_file or None,
                verify_client=self.config.tls_verify_client)
            client_tls = client_tls_context(
                ca_file=self.config.tls_ca_file or None,
                cert_file=self.config.tls_cert_file or None,
                key_file=self.config.tls_key_file or None,
                check_hostname=bool(self.config.tls_server_name))
        self.conn_pool = ConnPool(
            tls_context=client_tls,
            server_hostname=self.config.tls_server_name)
        # Raft gets its own NON-multiplexed pool (the JAX server's
        # layout): on a shared mux session one large frame written under
        # the session's write lock would stall every raft RPC queued
        # behind it: election and heartbeat latency stay independent of
        # bulk RPC traffic.
        self.raft_pool = ConnPool(
            tls_context=client_tls,
            server_hostname=self.config.tls_server_name,
            multiplex=False)

        # From here on the components start threads and bind ports: a
        # step that raises (a taken RPC or gossip port, a bad data dir)
        # tears down what the earlier steps started.
        self.raft = self.plan_applier = self.rpc_server = None
        self.gossip = self.obs_registry = None
        try:
            self._start_components(server_tls)
        except BaseException:
            self.shutdown()
            raise
        self._built.set()

    def _start_components(self, server_tls) -> None:
        # The listener binds first (networked raft rides it and takes
        # its address), but it starts serving last, below.
        if self.config.enable_rpc or self.config.raft_mode == "net":
            self.rpc_server = RPCServer(
                self.config.bind_addr,
                self.config.rpc_port,
                tls_context=server_tls,
                require_tls=self.config.tls_require,
                dispatch_workers=self.config.rpc_dispatch_workers,
                dispatch_queue=self.config.rpc_dispatch_queue,
                max_conns=self.config.rpc_max_conns,
                idle_timeout=self.config.rpc_idle_timeout,
                read_deadline=self.config.rpc_read_deadline)

        if self.config.raft_mode == "net":
            from .raft_net import NetRaft
            # bootstrap-expect > 1 with no static peer list: stay passive
            # (no self-election) until gossip shows the expected server
            # count, so a booting server can never commit entries as the
            # leader of its own one-node cluster (reference serf.go
            # maybeBootstrap).  Its handlers are registered on the
            # listener here, before it serves, and its election timer
            # starts once the listener serves (below); its replicators
            # may dial a peer that cannot answer yet, a failed exchange.
            defer = self.config.bootstrap_expect > 1 and \
                not self.config.raft_peers and self.config.enable_gossip
            self.raft = NetRaft(
                self.fsm, self.rpc_server, self.raft_pool,
                peers=self.config.raft_peers,
                election_timeout=self.config.raft_election_timeout,
                heartbeat_interval=self.config.raft_heartbeat_interval,
                snapshot_threshold=self.config.raft_snapshot_threshold,
                data_dir=self.config.data_dir,
                defer_elections=defer, start=False)
            self.raft.notify_leadership(self._on_leadership_change)
        else:
            log_store = snapshots = None
            if self.config.data_dir:
                # The JAX package's layout and snapshot format (shared
                # with NetRaft), so one data_dir restores under either
                # package and either raft backend.
                log_store = FileLogStore(
                    f"{self.config.data_dir}/raft/log.bin")
                snapshots = SnapshotStore(
                    resolve_snapshot_dir(self.config.data_dir))
            self.raft = InmemRaft(
                self.fsm, log_store, snapshots,
                snapshot_threshold=self.config.raft_snapshot_threshold)

        self.plan_applier = PlanApplier(
            self.plan_queue, self.eval_broker, self.raft,
            lambda: self.fsm.state, device=self.device)

        if self.rpc_server is not None:
            from .endpoints import Endpoints
            Endpoints(self).install(self.rpc_server)

        # Multi-region federation: region name -> {rpc address, ...} of
        # known servers there, maintained from gossip member tags
        # (reference nomad/server.go:503-538 — serf WAN tags feed the
        # peers-by-region table consulted by rpc.go forwardRegion) or
        # statically via add_region_server (join_wan analogue).
        self._region_servers: dict = {}
        self._region_lock = threading.Lock()

        self._setup_workers()
        self._setup_obs_registry()

        # Feedback control plane (nomad_tpu_torch/control): reads this
        # server's registry gauges, adjusts the live knobs through
        # railed actuators, and publishes its own decisions as the
        # ``controller`` provider — so /v1/agent/metrics carries every
        # knob position and reversal count.
        if self.config.control_enabled:
            from nomad_tpu_torch.control import server_controller
            self.controller = server_controller(self)
            self.obs_registry.register("controller",
                                       self.controller.stats)
            # consensus-ok(leader-fence): the feedback controller
            # actuates host-local performance knobs (batch windows,
            # broker admission) off this server's own metrics — it
            # never touches replicated state, so it runs on every
            # server, leader or not, by design.
            self.controller.start()
        # Gossip membership: servers discover one another (reference
        # nomad/serf.go).  The listener is bound, so the member tags
        # carry its address; gossip and then the listener start last,
        # once every component a handler or a join event reaches exists
        # (the JAX server starts them first, reference
        # nomad/server.go:348-363): no request meets a half-built
        # server.
        if self.config.enable_gossip:
            from .gossip import Gossip
            rpc_addr = self.rpc_address()
            self.gossip = Gossip(
                tags={"role": "nomad-server",
                      "region": self.config.region,
                      "name": self.config.server_name,
                      "rpc": list(rpc_addr) if rpc_addr else None},
                bind=self.config.bind_addr,
                port=self.config.gossip_port,
                on_join=self._gossip_join,
                on_fail=self._gossip_fail,
                on_leave=self._gossip_fail,
            )
        if self.rpc_server is not None:
            self.rpc_server.start()
        start = getattr(self.raft, "start", None)
        if callable(start):
            # Networked raft campaigns only once its peers can reach
            # this server.
            start()

    def _setup_obs_registry(self) -> None:
        """The unified metrics registry (obs/registry.py): every
        component ``stats()`` becomes a ``nomad.<provider>.*`` gauge
        tree.  Per-server instance: the providers close over THIS
        server's components and the registry dies with it (the
        process-global REGISTRY carries only process singletons like the
        device breaker)."""
        from nomad_tpu_torch.obs import MetricsRegistry

        # Importing the breaker registers the process-global
        # nomad.breaker.* provider in obs.REGISTRY.
        from nomad_tpu_torch.scheduler import breaker as _breaker  # noqa: F401

        reg = MetricsRegistry()
        reg.register("broker", self.eval_broker.stats)
        reg.register("plan_queue", self.plan_queue.stats)
        reg.register("applier", self.plan_applier.stats)
        reg.register("applier_components",
                     self.plan_applier.components.stats)
        reg.register("overload", self.overload.stats)
        reg.register("heartbeat", self.heartbeats.stats)
        # fsm.state is REPLACED on snapshot restore: resolve per read.
        reg.register("store", lambda: self.fsm.state.stats())
        reg.register("workers", self._worker_stats)
        if self.rpc_server is not None:
            reg.register("rpc", self.rpc_server.stats)
        self.obs_registry = reg

    def _worker_stats(self) -> dict:
        """Aggregate worker-pool counters: deadline drops, and the evals
        a worker caught an exception on (scheduler, kernel build,
        launch or fetch) and nacked."""
        return {
            "count": len(self.workers),
            "expired_drops": sum(w.expired_drops for w in self.workers),
            "failures": sum(w.failures for w in self.workers),
        }

    def _gossip_join(self, member) -> None:
        """A server joined the gossip pool: record its region for
        cross-region forwarding, and (same region only) add it as a raft
        peer (reference serf.go nodeJoin + leader.go reconcileMember)."""
        if member.tags.get("role") != "nomad-server":
            return
        rpc = member.tags.get("rpc")
        region = member.tags.get("region")
        if rpc and region:
            self.add_region_server(region, (rpc[0], rpc[1]))
        if region != self.config.region:
            return  # other regions federate, they don't share raft
        add_peer = getattr(self.raft, "add_peer", None)
        if rpc and callable(add_peer):
            add_peer((rpc[0], rpc[1]))
        # bootstrap-expect: arm elections once the expected quorum of
        # same-region servers is visible (self + peers).
        enable = getattr(self.raft, "enable_elections", None)
        if callable(enable) and not self.raft.elections_enabled() and \
                len(self.raft.peer_addresses()) >= \
                self.config.bootstrap_expect:
            logger.info("bootstrap-expect %d reached; enabling elections",
                        self.config.bootstrap_expect)
            enable()

    def _gossip_fail(self, member) -> None:
        if member.tags.get("role") != "nomad-server":
            return
        rpc = member.tags.get("rpc")
        region = member.tags.get("region")
        if rpc and region:
            self.remove_region_server(region, (rpc[0], rpc[1]))
        remove_peer = getattr(self.raft, "remove_peer", None)
        if rpc and callable(remove_peer):
            remove_peer((rpc[0], rpc[1]))

    # -- multi-region federation ------------------------------------------
    def add_region_server(self, region: str, addr: tuple) -> None:
        with self._region_lock:
            self._region_servers.setdefault(region, set()).add(
                (addr[0], addr[1]))

    def remove_region_server(self, region: str, addr: tuple) -> None:
        with self._region_lock:
            servers = self._region_servers.get(region)
            if servers:
                servers.discard((addr[0], addr[1]))
                if not servers:
                    del self._region_servers[region]

    def regions(self) -> list:
        """Known region names, ours included (reference Region list API)."""
        with self._region_lock:
            known = set(self._region_servers)
        known.add(self.config.region)
        return sorted(known)

    def region_server(self, region: str) -> tuple:
        """A server address in ``region``, chosen at random (reference
        nomad/rpc.go:207-227 forwardRegion).  Raises when the region is
        unknown — a mis-addressed request must error, not run locally."""
        with self._region_lock:
            servers = list(self._region_servers.get(region, ()))
        if not servers:
            raise RuntimeError(f"no path to region {region!r}")
        return random.choice(servers)

    def _on_leadership_change(self, is_leader: bool) -> None:
        """monitorLeadership parity (leader.go:16-50): raft's notifier
        delivers gains and losses in order.  A gain that lands while the
        server is still being built waits for it; none runs once
        shutdown began."""
        self._built.wait()
        if self._shutdown.is_set():
            return
        if is_leader:
            self.establish_leadership()
        else:
            self.revoke_leadership()

    # -- cluster views -----------------------------------------------------
    def rpc_address(self) -> Optional[tuple]:
        return self.rpc_server.address if self.rpc_server else None

    def leader_rpc_address(self) -> Optional[tuple]:
        """The leader's RPC address (self when leading; NetRaft supplies
        the remote leader otherwise)."""
        if self._leader:
            return self.rpc_address()
        leader = getattr(self.raft, "leader_address", None)
        if callable(leader):
            return leader()
        return None

    def has_leader(self) -> bool:
        return self._leader or self.leader_rpc_address() is not None

    def peers(self) -> list:
        peer_fn = getattr(self.raft, "peer_addresses", None)
        if callable(peer_fn):
            return peer_fn()
        return [self.rpc_address()] if self.rpc_server else []

    # -- setup ------------------------------------------------------------
    def _setup_workers(self) -> None:
        n = self.config.num_schedulers
        if n <= 0:
            # Leader-only server (and test rigs that drive the broker /
            # plan queue by hand): no scheduling workers at all.
            return
        if self.config.use_device_scheduler:
            # One batch worker on the server's device replaces the
            # goroutine fleet for service/batch evals; plain workers
            # cover system/_core so the two pools never race for the
            # same queues.  The device was resolved at construction (a
            # cuda server without a card raised there): there is no
            # sequential fallback.
            self.workers.append(BatchWorker(self,
                                            self.config.device_batch))
            rest = [q for q in self.config.enabled_schedulers
                    if q not in BatchWorker.DEVICE_QUEUES]
            for _ in range(max(1, n - 1)):
                self.workers.append(Worker(self, queues=rest))
        else:
            for _ in range(n):
                self.workers.append(Worker(self))
        for w in self.workers:
            w.start()

    def enabled_schedulers(self) -> list:
        return self.config.enabled_schedulers

    # -- leadership -------------------------------------------------------
    def establish_leadership(self) -> None:
        """Single-node leader bring-up (reference leader.go:99-140)."""
        if self._leader:
            return
        self._leader = True
        if self.workers:
            self.workers[0].set_pause(True)
        if not self._barrier():
            # Leadership lost (its revoke follows from raft's notifier)
            # or shutdown began while the barrier waited: start nothing.
            if self.workers:
                self.workers[0].set_pause(False)
            return
        self.plan_queue.set_enabled(True)
        self.eval_broker.set_enabled(True)
        self.plan_applier.start()
        self._restore_eval_broker()
        if self.workers:
            self.workers[0].set_pause(False)
        self.heartbeats.initialize()
        for target, name in ((self._reap_failed_evals,
                              "failed-eval-reaper"),
                             (self._schedule_periodic, "periodic-gc")):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._leader_threads.append(t)

    def _barrier(self) -> bool:
        """Ensure the FSM has applied everything committed before leader
        state is rebuilt from it (leader.go:52).  As the reference's
        leader loop does, a barrier that fails is tried again, and
        leadership is not established on an FSM that may lag the log:
        the broker restored from it would hand out an eval whose plan
        already committed, and that eval would be placed twice (the
        JAX server logs the failure and goes on).  The in-memory raft
        applies each entry as it commits, so its FSM never lags: a
        failed barrier there (dead storage) is logged and leadership
        goes on, as in the JAX server.  False when raft lost leadership
        or the server is shutting down."""
        is_leader = getattr(self.raft, "is_leader", None)
        if not callable(is_leader):
            try:
                self.raft.barrier()
            except Exception:
                logger.warning("leadership barrier failed", exc_info=True)
            return not self._shutdown.is_set()
        while not self._shutdown.is_set():
            try:
                self.raft.barrier()
                return True
            except Exception:
                logger.warning("leadership barrier failed", exc_info=True)
            if not is_leader():
                return False
        return False

    def revoke_leadership(self) -> None:
        self._leader = False
        self.plan_queue.set_enabled(False)
        self.eval_broker.set_enabled(False)
        self.heartbeats.clear()

    def is_leader(self) -> bool:
        return self._leader

    def abandon(self) -> None:
        """Crash simulation (faultinject/crash.py CrashHarness): drop
        the server WITHOUT graceful teardown.  Storage must already be
        frozen (``freeze_storage``) — this only models the OS reaping a
        dead process: stop events are signalled so daemon threads wind
        down on their own, listener and client sockets are severed
        mid-frame, and nothing is flushed, snapshotted, persisted, or
        responded.  The data_dir stays byte-exact as the crash left it.
        A worker inside a launch on the card finishes it and finds the
        broker and plan queue disabled; its device work is its own and
        leaves the card to the next leader.  ``CrashHarness.reap()``
        does the joins later."""
        self._shutdown.set()
        self._built.set()
        self._leader = False
        if self.controller is not None:
            self.controller._stop.set()  # signal only: crashes don't join
        for w in self.workers:
            w.stop()
        # Pop workers/pollers out of their blocking waits; in-memory
        # only — the broker and plan queue of a dead process are gone
        # anyway, and nothing here answers a client.
        self.eval_broker.set_enabled(False)
        self.plan_queue.set_enabled(False)
        # Raft loops: signal, never join, never close the log store
        # (a close is a graceful act; the store is already frozen).
        stop = getattr(self.raft, "_stop", None)
        if stop is not None:
            stop.set()
        for repl in list(getattr(self.raft, "_replicators", {}).values()):
            repl.stop.set()
            repl.wake.set()
        notify_q = getattr(self.raft, "_notify_queue", None)
        if notify_q is not None:
            notify_q.put(None)
        # Sever the network edge the way a dead process's OS would:
        # every socket drops mid-frame; peers and clients see resets.
        # NOT shutdown() — that joins the loop and dispatch workers and
        # drains in-flight handlers, which is a graceful act; reap()
        # runs the real shutdown() later.  A call still in flight on
        # the pools ends with the pool's ConnectionError.
        if self.rpc_server is not None:
            self.rpc_server.sever()
        self.conn_pool.shutdown()
        self.raft_pool.shutdown()
        gossip_stop = getattr(self.gossip, "_stop", None)
        if gossip_stop is not None and hasattr(gossip_stop, "set"):
            gossip_stop.set()  # no leave broadcast: crashes don't say bye

    def shutdown(self) -> None:
        """Stop and join every thread this server started: the
        controller, the workers, the leader's reaper and periodic GC,
        networked raft's ticker, replicators and notifier, the RPC
        plane's edge loop and dispatch pool, gossip's receive and probe
        loops, the connection pools' readers, the applier with its
        committer and component executor, the broker's and the
        heartbeats' TTL wheels and the store's watch wheel.  A
        construction that raised calls it too, with the parts it never
        built left None."""
        self._shutdown.set()
        self._built.set()
        # Controller first: no knob may move while the components it
        # actuates are being torn down.
        if self.controller is not None:
            self.controller.stop()
        for w in self.workers:
            w.stop()
        self.revoke_leadership()
        # Stop first, join after revoke: disabling the broker pops
        # workers out of their blocking dequeues immediately.
        for w in self.workers:
            w.join(3.0)
        for t in self._leader_threads:
            t.join(3.0)
        self._leader_threads = []
        # Gossip leaves first (its leave broadcast tells the peers),
        # then the listener closes.
        if self.gossip is not None:
            self.gossip.shutdown()
        raft_shutdown = getattr(self.raft, "shutdown", None)
        if callable(raft_shutdown):
            raft_shutdown()
        if self.rpc_server is not None:
            self.rpc_server.shutdown()
        self.conn_pool.shutdown()
        self.raft_pool.shutdown()
        # After revoke (which cleared the timers): reap the heartbeat
        # service threads so nothing fires into the torn-down server.
        self.heartbeats.shutdown()
        # Broker nack wheel + the applier's component executor are
        # service threads with the same contract.
        self.eval_broker.shutdown()
        if self.plan_applier is not None:
            self.plan_applier.shutdown()
        log_store = getattr(self.raft, "log_store", None)
        if log_store is not None:
            log_store.close()
        # Watch fan-out last: the RPC teardown above already
        # deregistered every parked long-poll; this reaps the shared
        # timeout wheel and answers any straggler as timed out.
        self.fsm.state.watch.shutdown()
        # Drop the metrics providers: their closures hold live
        # components and a snapshot of a torn-down server is noise.
        if self.obs_registry is not None:
            self.obs_registry.clear()

    def _restore_eval_broker(self) -> None:
        """Broker is volatile; state is durable.  Re-enqueue all
        non-terminal evals from replicated state (leader.go:145-168).
        ``force``: these evals are already committed — shedding them
        would silently diverge the broker from state."""
        for ev in self.fsm.state.evals():
            if ev.should_enqueue():
                self.eval_broker.enqueue(ev, force=True)

    def _reap_failed_evals(self) -> None:
        """Mark evals past the delivery limit as failed
        (leader.go:204-238)."""
        while not self._shutdown.is_set() and self._leader:
            try:
                ev, token = self.eval_broker.dequeue(
                    [FAILED_QUEUE], timeout=0.25)
            except RuntimeError:
                return
            if ev is None:
                continue
            updated = ev.copy()
            updated.status = EVAL_STATUS_FAILED
            updated.status_description = (
                "evaluation reached delivery limit "
                f"({self.config.eval_delivery_limit})")
            try:
                self.apply_eval_update([updated], token)
            except Exception:
                # A failed apply (dead/crashed storage) must not kill
                # the reaper thread: skip the ack so the eval
                # redelivers and the next pass retries.
                logger.warning("failed-eval reap could not commit; "
                               "will retry", exc_info=True)
                continue
            try:
                self.eval_broker.ack(ev.id, token)
            except ValueError:
                pass

    def _schedule_periodic(self) -> None:
        """Emit eval-gc / node-gc core evals on their intervals
        (leader.go:171-199)."""
        last_eval_gc = last_node_gc = time.monotonic()
        while self._leader and not self._shutdown.wait(0.25):
            now = time.monotonic()
            if now - last_eval_gc >= self.config.eval_gc_interval:
                self._enqueue_core_eval(CORE_JOB_EVAL_GC)
                last_eval_gc = now
            if now - last_node_gc >= self.config.node_gc_interval:
                self._enqueue_core_eval(CORE_JOB_NODE_GC)
                last_node_gc = now

    def _enqueue_core_eval(self, core_job_id: str) -> None:
        ev = Evaluation(
            id=generate_uuid(),
            priority=CORE_JOB_PRIORITY,
            type="_core",
            triggered_by="scheduled",
            job_id=core_job_id,
            status="pending",
            modify_index=self.raft.applied_index(),
        )
        # Core evals skip raft: they are leader-local work
        # (leader.go:188-199).  They are also the FIRST work a browning
        # out leader sheds: GC can always run on the next interval.
        try:
            self.eval_broker.enqueue(ev)
        except ErrOverloaded:
            logger.debug("core eval %s shed under overload", core_job_id)

    # -- raft-backed mutations --------------------------------------------
    def raft_apply(self, msg_type: int, payload: dict) -> int:
        entry = codec.encode(msg_type, payload)
        index, _ = self.raft.apply(entry).wait(30.0)
        return index

    def apply_eval_update(self, evals: list, token: str = "") -> int:
        # Token fencing for in-flight evals (eval_endpoint.go:123-143):
        # an eval that is outstanding may only be updated by its holder.
        for ev in evals:
            held, ok = self.eval_broker.outstanding(ev.id)
            if ok and held != token:
                raise PermissionError(
                    f"eval {ev.id} token does not match outstanding token")
        tracer = obs_trace.tracer() if obs_trace.ENABLED else None
        if tracer is not None:
            # Anchor every freshly created eval (obs/trace.py): the
            # anchor span is the single root all of this eval's spans —
            # broker wait, scheduler stages, plan commit, store upsert,
            # on any thread or after any retry — descend from.  Parent
            # is the ambient context (the serving RPC's span, or the
            # creating eval's context for rolling/next evals), so the
            # tree hangs off the client edge.  This is the one choke
            # point every server-side eval creation path funnels
            # through; evals arriving with a context keep it.
            for ev in evals:
                if not ev.trace and not ev.terminal_status():
                    ev.trace = tracer.anchor(
                        "eval.created", parent_ctx=tracer.ctx(),
                        eval_id=ev.id, eval_type=ev.type,
                        triggered_by=ev.triggered_by)
        return self.raft_apply(
            codec.EVAL_UPDATE_REQUEST,
            {"evals": [e.to_dict() for e in evals]})

    # -- convenience write paths ------------------------------------------
    def job_register(self, job: Job) -> tuple[int, str]:
        errs = job.validate()
        if errs:
            raise ValueError("; ".join(errs))
        index = self.raft_apply(codec.JOB_REGISTER_REQUEST,
                                {"job": job.to_dict()})
        ev = Evaluation(
            id=generate_uuid(),
            priority=job.priority,
            type=job.type,
            triggered_by="job-register",
            job_id=job.id,
            job_modify_index=index,
            status="pending",
            modify_index=index,
            create_index=index,
        )
        self.apply_eval_update([ev])
        return index, ev.id

    def job_deregister(self, job_id: str) -> tuple[int, str]:
        job = self.fsm.state.job_by_id(job_id)
        index = self.raft_apply(codec.JOB_DEREGISTER_REQUEST,
                                {"job_id": job_id})
        ev = Evaluation(
            id=generate_uuid(),
            priority=job.priority if job else CORE_JOB_PRIORITY,
            type=job.type if job else "service",
            triggered_by="job-deregister",
            job_id=job_id,
            modify_index=index,
            create_index=index,
            status="pending",
        )
        self.apply_eval_update([ev])
        return index, ev.id

    def node_register(self, node: Node) -> int:
        return self.raft_apply(codec.NODE_REGISTER_REQUEST,
                               {"node": node.to_dict()})

    def node_deregister(self, node_id: str) -> int:
        index = self.raft_apply(codec.NODE_DEREGISTER_REQUEST,
                                {"node_id": node_id})
        self.create_node_evals(node_id, index)
        return index

    def node_update_status(self, node_id: str, status: str) -> int:
        """Transition a node's status; drain-worthy transitions emit
        node-update evals (node_endpoint.go:121-170)."""
        if not valid_node_status(status):
            raise ValueError(f"invalid node status {status!r}")
        index = self.raft_apply(codec.NODE_UPDATE_STATUS_REQUEST,
                                {"node_id": node_id, "status": status})
        if should_drain_node(status):
            self.create_node_evals(node_id, index)
        return index

    def node_update_drain(self, node_id: str, drain: bool) -> int:
        index = self.raft_apply(codec.NODE_UPDATE_DRAIN_REQUEST,
                                {"node_id": node_id, "drain": drain})
        if drain:
            self.create_node_evals(node_id, index)
        return index

    def node_heartbeat(self, node_id: str) -> float:
        """Client heartbeat: re-arms the TTL timer, returns the next TTL.

        Leadership fence: TTL timers are leader state — only the leader
        invalidates on expiry, so only the leader may arm; off-leader
        the answer is 0.0 (no TTL)."""
        node = self.fsm.state.node_by_id(node_id)
        if node is None:
            raise KeyError(f"node not found: {node_id}")
        if not self._leader:
            return 0.0
        return self.heartbeats.reset_heartbeat_timer(node_id)

    def node_evaluate(self, node_id: str) -> list:
        """Force evals for all jobs with allocs on a node."""
        return self.create_node_evals(node_id, self.raft.applied_index())

    def create_node_evals(self, node_id: str, node_index: int) -> list:
        """One eval per job with allocs on the node, plus every system job
        (node_endpoint.go:440-532)."""
        state = self.fsm.state
        jobs: dict = {}
        for alloc in state.allocs_by_node(node_id):
            if alloc.job_id not in jobs:
                job = state.job_by_id(alloc.job_id) or alloc.job
                if job is not None:
                    jobs[alloc.job_id] = job
        for job in state.jobs_by_scheduler("system"):
            jobs.setdefault(job.id, job)

        evals = []
        for job in jobs.values():
            evals.append(Evaluation(
                id=generate_uuid(),
                priority=job.priority,
                type=job.type,
                triggered_by="node-update",
                job_id=job.id,
                node_id=node_id,
                node_modify_index=node_index,
                status="pending",
            ))
        if evals:
            self.apply_eval_update(evals)
        return [e.id for e in evals]

    def wait_for_evals(self, eval_ids: list, timeout: float = 10.0) -> dict:
        """Poll until the given evals reach a terminal status; returns
        eval id -> status."""
        deadline = time.monotonic() + timeout
        out: dict = {}
        while time.monotonic() < deadline:
            done = True
            for eid in eval_ids:
                ev = self.fsm.state.eval_by_id(eid)
                if ev is None or not ev.terminal_status():
                    done = False
                    break
                out[eid] = ev.status
            if done:
                return out
            time.sleep(0.01)
        raise TimeoutError(f"evals not terminal after {timeout}s")
