"""Agent: embeds a Server and/or Client in one process.

Capability parity with reference command/agent/agent.go: server and
client modes can run together; a colocated client uses the server as an
in-process RPC handler instead of the network.  ``dev_mode`` runs both with
ephemeral state — the `nomad agent -dev` experience.

Counterpart of ``nomad_tpu/agent/agent.py``.  ``AgentConfig`` has one key
more, ``device``: where the agent's server places (``None`` means
``cuda``), passed to ``ServerConfig.device``.  An agent that runs a
server without a card raises ``RuntimeError`` before it starts a thread,
binds a socket or makes a temporary directory; tests pass ``"cpu"``.  A
client-only agent places nothing and ignores the key.
"""
from __future__ import annotations

import logging
import os
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from nomad_tpu_torch import faultinject
from nomad_tpu_torch.client import Client, ClientConfig
from nomad_tpu_torch.obs import trace as trace_mod
from nomad_tpu_torch.parallel.devices import resolve_device
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.endpoints import Endpoints
from nomad_tpu_torch.utils.retry import Backoff

logger = logging.getLogger("nomad_tpu_torch.agent")


class InprocRPC:
    """In-process RPC handler: calls endpoint handlers directly
    (reference agent.go:264 + inmemCodec, nomad/server.go:616-661)."""

    def __init__(self, server: Server) -> None:
        self.endpoints = Endpoints(server)
        self._methods: dict = {}
        # Reuse the wire registry so method names match the network plane.

        class _Reg:
            def __init__(reg) -> None:
                reg.table = {}

            def register(reg, name, fn) -> None:
                reg.table[name] = fn

        reg = _Reg()
        self.endpoints.install(reg)
        self._methods = reg.table

    def call(self, method: str, args: dict, timeout=None):
        if faultinject.ACTIVE:
            # Same chokepoint ConnPool.call instruments for networked
            # clients: a colocated client's "sends" are these calls.
            faultinject.fire_rpc("rpc.send", method, args)
        if timeout is not None and "_deadline" not in args:
            # Deadline propagation, same envelope the wire plane ships
            # (server/overload.py) — the endpoint layer stamps arrival.
            args = dict(args, _deadline=timeout)
        fn = self._methods.get(method)
        if fn is None:
            raise ValueError(f"unknown method {method!r}")
        if trace_mod.ENABLED:
            # Same trace envelope + client span as ConnPool.call: the
            # colocated agent edge is an edge all the same.
            with trace_mod.client_call(method, args) as args:
                return fn(args)
        return fn(args)


@dataclass
class AgentConfig:
    name: str = ""
    region: str = "global"
    datacenter: str = "dc1"
    data_dir: str = ""
    bind_addr: str = "127.0.0.1"
    http_port: int = 4646
    rpc_port: int = 4647
    serf_port: int = 4648
    server_enabled: bool = False
    client_enabled: bool = False
    dev_mode: bool = False
    bootstrap_expect: int = 1
    num_schedulers: int = 2
    enabled_schedulers: list = field(default_factory=list)
    use_device_scheduler: bool = True
    executor: str = ""  # "" = auto (scheduler/executor.py policy)
    servers: list = field(default_factory=list)   # client: server addrs
    raft_peers: list = field(default_factory=list)
    client_options: dict = field(default_factory=dict)
    node_class: str = ""
    meta: dict = field(default_factory=dict)
    retry_join: list = field(default_factory=list)  # gossip addrs
    # Config-file parity fields (reference command/agent/config.go)
    log_level: str = "INFO"
    enable_debug: bool = False
    leave_on_int: bool = False
    leave_on_term: bool = False
    addresses: dict = field(default_factory=dict)
    advertise: dict = field(default_factory=dict)
    telemetry: dict = field(default_factory=dict)
    client_state_dir: str = ""
    client_alloc_dir: str = ""
    client_node_id: str = ""
    network_speed: int = 0
    server_data_dir: str = ""
    # Where the server places: None = cuda (ServerConfig.device).
    device: Optional[str] = None

    @classmethod
    def dev(cls) -> "AgentConfig":
        return cls(server_enabled=True, client_enabled=True, dev_mode=True,
                   http_port=0, rpc_port=0, log_level="DEBUG",
                   enable_debug=True)


class Agent:
    def __init__(self, config: AgentConfig) -> None:
        self.config = config
        if config.server_enabled or config.dev_mode:
            # No card, no agent: raise before any thread, socket or
            # temporary directory exists.
            resolve_device(config.device)
        self.server: Optional[Server] = None
        self.client: Optional[Client] = None
        self.http = None
        # Recent-log ring (utils/gated_log.LogWriter) + level-change
        # hook, installed by the CLI boot gate; None for library
        # embedders.
        self.log_writer = None
        self.on_log_level = None
        # Apply the configured level only when nothing else set one —
        # embedders who configured logging themselves keep their setting.
        if logging.getLogger("nomad_tpu_torch").level == logging.NOTSET:
            self._apply_log_level(config.log_level)
        self._apply_telemetry(config.telemetry)

        if not config.server_enabled and not config.client_enabled and \
                not config.dev_mode:
            raise ValueError(
                "must have at least client or server mode enabled")

        made_dir = None
        if config.dev_mode:
            config.server_enabled = True
            config.client_enabled = True
            if not config.data_dir:
                config.data_dir = made_dir = tempfile.mkdtemp(
                    prefix="nomad-dev-")
            config.client_options.setdefault("driver.raw_exec.enable",
                                             "true")

        self._inproc_rpc: Optional[InprocRPC] = None
        self.obs_registry = None
        try:
            if config.server_enabled:
                self._setup_server()
                self._inproc_rpc = InprocRPC(self.server)
            if config.client_enabled:
                self._setup_client()
            self._setup_http()
        except BaseException:
            # A failed boot (a refused server key, a port in use) stops
            # what it started: no thread outlives the constructor.
            self.shutdown()
            if made_dir is not None:
                shutil.rmtree(made_dir, ignore_errors=True)
            raise

    # -- setup -------------------------------------------------------------
    def _setup_server(self) -> None:
        cfg = ServerConfig(
            num_schedulers=self.config.num_schedulers,
            use_device_scheduler=self.config.use_device_scheduler,
            region=self.config.region,
            bind_addr=self.config.bind_addr,
            rpc_port=self.config.rpc_port,
            enable_rpc=True,
            device=self.config.device,
        )
        if self.config.enabled_schedulers:
            cfg.enabled_schedulers = list(self.config.enabled_schedulers)
        if self.config.executor:
            cfg.executor = self.config.executor
        if self.config.server_data_dir:
            cfg.data_dir = self.config.server_data_dir
        elif self.config.data_dir and not self.config.dev_mode:
            cfg.data_dir = os.path.join(self.config.data_dir, "server")
        # Gossip membership for server agents (reference: serf always
        # runs on servers).  Dev mode binds an ephemeral port so several
        # local agents never collide on the default serf port.
        cfg.enable_gossip = True
        cfg.gossip_port = 0 if self.config.dev_mode \
            else self.config.serf_port
        cfg.server_name = self.config.name or ""
        cfg.bootstrap_expect = max(1, self.config.bootstrap_expect)
        if self.config.raft_peers:
            cfg.raft_mode = "net"
            cfg.raft_peers = list(self.config.raft_peers)
        elif cfg.bootstrap_expect > 1:
            # Gossip-bootstrapped cluster: networked raft with deferred
            # elections until bootstrap_expect servers are visible.
            # Networked raft is not ported: the server refuses both
            # (ValueError, ROADMAP Queue 1 item 3).
            cfg.raft_mode = "net"
        self.server = Server(cfg)
        if not self.config.raft_peers and cfg.bootstrap_expect <= 1:
            # Single-server (or dev) mode: become leader immediately
            # (reference StartAsLeader / bootstrap_expect=1).
            self.server.establish_leadership()
        if self.config.retry_join:
            threading.Thread(target=self._retry_join, daemon=True,
                             name="agent-retry-join").start()

    def _retry_join(self) -> None:
        """Keep trying the configured gossip addresses until a join
        lands or the agent shuts down (reference command.go retry-join:
        indefinite by default)."""
        gossip = getattr(self.server, "gossip", None)
        if gossip is None:
            return
        targets = [tuple(t) for t in self.config.retry_join]
        backoff = Backoff(base=1.0, max_delay=15.0, jitter=0.5)
        while not self.server._shutdown.is_set():
            for target in targets:
                try:
                    gossip.join(target)
                except Exception:
                    logger.warning("retry-join to %s failed", target,
                                   exc_info=True)
            if len(gossip.members()) > 1:
                logger.info("retry-join succeeded (%d members)",
                            len(gossip.members()))
                return
            if backoff.sleep(self.server._shutdown):
                return

    def _setup_client(self) -> None:
        from nomad_tpu_torch.structs import Node

        node = Node(datacenter=self.config.datacenter,
                    name=self.config.name,
                    node_class=self.config.node_class,
                    meta=dict(self.config.meta))
        if self.config.client_node_id:
            node.id = self.config.client_node_id
        cfg = ClientConfig(
            state_dir=self.config.client_state_dir or (
                os.path.join(self.config.data_dir, "client")
                if self.config.data_dir else ""),
            alloc_dir=self.config.client_alloc_dir or (
                os.path.join(self.config.data_dir, "alloc")
                if self.config.data_dir else ""),
            node=node,
            region=self.config.region,
            options=dict(self.config.client_options),
            servers=list(self.config.servers),
            dev_mode=self.config.dev_mode,
        )
        if self.server is not None:
            cfg.rpc_handler = self._inproc_rpc
        elif not cfg.servers:
            raise ValueError("client mode requires servers or a "
                             "colocated server")
        self.client = Client(cfg)
        self.client.start()

    def _setup_http(self) -> None:
        from .http_server import HTTPServer

        self.http = HTTPServer(self, self.config.bind_addr,
                               self.config.http_port)
        # Registry BEFORE start(): the instant the port accepts, a
        # retry-until-up monitor may hit /v1/agent/metrics — it must
        # find obs_registry already assigned.
        self._setup_obs_registry()
        self.http.start()

    def _setup_obs_registry(self) -> None:
        """Agent-level providers (obs/registry.py): the HTTP edge and
        the client's runner census ride beside the server's registry in
        /v1/agent/metrics."""
        from nomad_tpu_torch.obs import MetricsRegistry

        reg = MetricsRegistry()
        if self.http is not None:
            reg.register("http", self.http.stats)
        if self.client is not None:
            reg.register("client", lambda: {
                "allocs": len(self.client.alloc_runners)})
        self.obs_registry = reg

    def metrics_payload(self) -> dict:
        """The /v1/agent/metrics document: every registry this process
        owns (agent + colocated server + process singletons) flattened
        to ``nomad.*`` keys, plus the in-memory telemetry sink.

        ``collect`` (not ``snapshot``): the serving surface stamps each
        provider's ``age_s`` staleness gauge and runs providers under a
        sample deadline, so one component wedged on a dead lock
        isolates as ``.error`` instead of hanging every monitoring
        poll (obs/registry.py)."""
        from nomad_tpu_torch.obs import REGISTRY
        from nomad_tpu_torch.utils.metrics import metrics

        extra = [REGISTRY]
        if self.server is not None:
            extra.append(self.server.obs_registry)
        return {
            "providers": self.obs_registry.collect(timeout=2.0,
                                                   extra=extra),
            "inmem": metrics.inmem.snapshot(),
        }

    # -- RPC from HTTP layer ------------------------------------------------
    def rpc(self, method: str, args: dict):
        if self._inproc_rpc is not None:
            return self._inproc_rpc.call(method, args)
        return self.client.rpc.call(method, args)

    def join(self, address: tuple) -> int:
        """Join another server (gossip when available, else raft peer)."""
        if self.server is None:
            return 0
        gossip = getattr(self.server, "gossip", None)
        if gossip is not None:
            return gossip.join(address)
        add_peer = getattr(self.server.raft, "add_peer", None)
        if callable(add_peer):
            add_peer(address)
            return 1
        return 0

    def leave(self) -> None:
        """Gracefully leave the cluster before shutdown (reference
        command.go:537 gracefulLeave: gossip Leave so peers don't mark us
        failed)."""
        if self.server is not None:
            gossip = getattr(self.server, "gossip", None)
            if gossip is not None:
                try:
                    gossip.leave()
                except Exception:
                    logger.warning("gossip leave failed", exc_info=True)

    # -- reload --------------------------------------------------------------
    def _apply_log_level(self, level: str) -> None:
        if self.on_log_level is not None:
            # CLI boot-gate pipeline: levels live on its handlers (the
            # logger stays at DEBUG so the ring can capture everything).
            self.on_log_level(level)
            return
        numeric = getattr(logging, str(level).upper(), None)
        if isinstance(numeric, int):
            logging.getLogger("nomad_tpu_torch").setLevel(numeric)

    def _apply_telemetry(self, telemetry: dict) -> None:
        if not telemetry:
            return
        from nomad_tpu_torch.agent.config import ConfigError
        from nomad_tpu_torch.utils.metrics import metrics

        addr = telemetry.get("statsd_address") or \
            telemetry.get("statsite_address")
        if addr and ":" in str(addr):
            host, _, port = str(addr).rpartition(":")
            try:
                port = int(port)
            except ValueError:
                raise ConfigError(
                    f"telemetry address {addr!r} has a bad port") from None
            already = any(
                getattr(s, "address", None) == (host, port)
                for s in metrics.sinks)
            if not already:
                metrics.add_statsd(host, port)

    def reload(self, tree: dict) -> list:
        """Apply the reloadable subset of a fresh config-file tree
        (SIGHUP path; reference command.go:463 handleReload re-applies
        the log filter).  Returns the list of keys applied."""
        from .config import RELOADABLE_KEYS

        applied = []
        for key in RELOADABLE_KEYS:
            if key not in tree:
                continue
            if key == "log_level":
                self.config.log_level = tree[key]
                self._apply_log_level(tree[key])
            elif key == "enable_debug":
                self.config.enable_debug = bool(tree[key])
            elif key == "telemetry":
                self.config.telemetry = dict(tree[key])
                self._apply_telemetry(self.config.telemetry)
            applied.append(key)
        return applied

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        out: dict = {"agent": {"name": self.config.name or "agent"}}
        if self.server is not None:
            out["nomad"] = {
                "leader": str(self.server.is_leader()).lower(),
                "applied_index": self.server.raft.applied_index(),
                "broker": self.server.eval_broker.stats(),
                "plan_queue": self.server.plan_queue.stats(),
                "heartbeats": self.server.heartbeats.active(),
            }
        if self.client is not None:
            out["client"] = {
                "node_id": self.client.node.id,
                "allocs": len(self.client.alloc_runners),
            }
        from nomad_tpu_torch.utils.metrics import metrics

        out["metrics"] = metrics.inmem.snapshot()
        return out

    def shutdown(self) -> None:
        if self.http is not None:
            self.http.shutdown()
        if self.client is not None:
            self.client.shutdown()
            self.client.destroy_all()
            # destroy_all only signals the task runners: wait for their
            # kills, so that an agent process that exits next leaves no
            # task running (the JAX agent returns at once).
            deadline = time.monotonic() + 10.0
            for runner in list(self.client.alloc_runners.values()):
                for tr in list(runner.task_runners.values()):
                    tr.join(max(0.0, deadline - time.monotonic()))
        if self.server is not None:
            self.server.shutdown()
        # Drop the agent-level providers and reap the registry's
        # deadline sampler (lazily spawned by metrics_payload's
        # collect) — no monitoring thread may outlive the agent.
        if self.obs_registry is not None:
            self.obs_registry.clear()
