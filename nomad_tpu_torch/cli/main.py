"""CLI commands.

Capability parity with reference command/ + commands.go registry:
agent, run, stop, status, node-status, node-drain, eval-monitor,
server-members, server-join, agent-info, validate, init, version.  All
commands talk to the agent's HTTP API (reference: CLI -> api/ -> agent).

Counterpart of ``nomad_tpu/cli/main.py``, run as ``python -m
nomad_tpu_torch.cli``: every subcommand and flag of the JAX CLI, plus
``agent -device`` (where the agent's server places; the card unless
``-device cpu``).  ``lint`` reads the static analyzers, which are not
ported: it exits 1 and says so.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

from nomad_tpu_torch import __version__
from nomad_tpu_torch.api import APIClient, APIError, QueryOptions

DEFAULT_ADDRESS = os.environ.get("NOMAD_ADDR", "http://127.0.0.1:4646")

EXAMPLE_JOB = """\
# There can only be a single job definition per file.
job "example" {
    # Run the job in the global region, which is the default.
    # region = "global"

    # Specify the datacenters within the region this job can run in.
    datacenters = ["dc1"]

    # Service type jobs optimize for long-lived services.  Use "batch" for
    # short-lived tasks, "system" to run on every node.
    # type = "service"

    # Priority controls access to resources and preemption, 1 to 100.
    # priority = 50

    # Restrict the job to linux nodes.
    constraint {
        attribute = "$attr.kernel.name"
        value = "linux"
    }

    # Rolling updates: one task at a time, 10s apart.
    update {
        stagger = "10s"
        max_parallel = 1
    }

    group "cache" {
        # Number of instances of this group.
        count = 1

        task "redis" {
            driver = "exec"

            config {
                command = "/bin/sleep"
                args = "300"
            }

            resources {
                cpu = 500     # MHz
                memory = 256  # MB
                network {
                    mbits = 10
                    dynamic_ports = ["redis"]
                }
            }
        }
    }
}
"""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="nomad-tpu",
        description="cluster scheduler (the PyTorch/CUDA port)")
    parser.add_argument("-address", default=DEFAULT_ADDRESS,
                        help="agent HTTP address")
    sub = parser.add_subparsers(dest="command")

    p = sub.add_parser("agent", help="run an agent")
    p.add_argument("-dev", action="store_true")
    p.add_argument("-server", action="store_true")
    p.add_argument("-client", action="store_true")
    p.add_argument("-data-dir", default="")
    p.add_argument("-bind", default="127.0.0.1")
    p.add_argument("-http-port", type=int, default=4646)
    p.add_argument("-rpc-port", type=int, default=4647)
    p.add_argument("-serf-port", type=int, default=4648,
                   help="gossip port for server agents (0 = ephemeral)")
    p.add_argument("-servers", default="",
                   help="comma-separated server RPC addrs (client mode)")
    p.add_argument("-executor", default="",
                   help="placement-kernel executor: auto|host|device "
                        "(overrides config; NOMAD_TPU_EXECUTOR env "
                        "overrides both)")
    p.add_argument("-config", action="append", default=[],
                   help="HCL/JSON config file or directory; repeatable, "
                        "merged in order (reloaded on SIGHUP)")
    p.add_argument("-device", default=None,
                   help="where the server places: cuda (the default: "
                        "the card) or cpu")

    p = sub.add_parser("init", help="create an example job file")

    p = sub.add_parser("validate", help="validate a job file")
    p.add_argument("file")

    p = sub.add_parser("run", help="submit a job")
    p.add_argument("file")
    p.add_argument("-detach", action="store_true")

    p = sub.add_parser("stop", help="stop a job")
    p.add_argument("job_id")

    p = sub.add_parser("status", help="job status")
    p.add_argument("job_id", nargs="?")

    p = sub.add_parser("node-status", help="node status")
    p.add_argument("node_id", nargs="?")

    p = sub.add_parser("node-drain", help="toggle node drain")
    p.add_argument("node_id")
    p.add_argument("-enable", action="store_true")
    p.add_argument("-disable", action="store_true")

    p = sub.add_parser("eval-monitor", help="monitor an evaluation")
    p.add_argument("eval_id")

    p = sub.add_parser("alloc-status", help="allocation status")
    p.add_argument("alloc_id")

    sub.add_parser("server-members", help="list cluster servers")
    p = sub.add_parser("server-join", help="join a server")
    p.add_argument("join_address")
    p = sub.add_parser("server-force-leave",
                       help="force a gossip member into left state")
    p.add_argument("member_name")
    p = sub.add_parser("client-config",
                       help="view or update the client's server list")
    p.add_argument("-update-servers", dest="update_servers", default="",
                   help="comma-separated host:port list to switch to")
    p = sub.add_parser("monitor", help="stream recent agent log lines")
    p.add_argument("-lines", type=int, default=0,
                   help="newest N lines (0 = full ring)")
    p.add_argument("-follow", action="store_true",
                   help="poll for new lines until interrupted")
    sub.add_parser("agent-info", help="agent diagnostics")
    p = sub.add_parser(
        "metrics", help="dump the agent's unified metrics registry "
                        "(/v1/agent/metrics: every component stats() "
                        "as nomad.* gauges + the in-mem sink)")
    p.add_argument("-json", dest="as_json", action="store_true",
                   help="raw JSON document instead of the flat listing")
    p.add_argument("-filter", default="",
                   help="only keys containing this substring "
                        "(e.g. 'broker', 'applier')")
    p.add_argument("-watch", type=float, default=0.0, metavar="N",
                   help="re-sample every N seconds and render deltas "
                        "(rates for counters) — live view of the "
                        "feedback controller's behavior; Ctrl-C stops")
    p.add_argument("-rounds", type=int, default=0,
                   help="with -watch: stop after this many re-samples "
                        "(0 = until interrupted); scripts and tests "
                        "bound the loop with it")
    sub.add_parser("version", help="print version")

    p = sub.add_parser(
        "lint", help="static analysis (not ported: exits 1)")
    p.add_argument("path", nargs="?", default="",
                   help="package dir to analyze")
    p.add_argument("-allowlist", default="",
                   help="allowlist file (default: LINT_ALLOWLIST.txt "
                        "next to the package)")
    p.add_argument("-strict", action="store_true",
                   help="also report advisory findings (bare reads of "
                        "guarded attributes)")
    p.add_argument("-json", dest="as_json", action="store_true",
                   help="machine-readable output (includes call-graph "
                        "self-coverage)")
    p.add_argument("-changed", metavar="REV", default="",
                   help="only report findings in files touched since "
                        "REV (git diff --name-only REV); the stale-"
                        "allowlist gate is skipped in this mode")
    p.add_argument("-sarif", metavar="PATH", default="",
                   help="also write a SARIF 2.1.0 log (findings + "
                        "coverage under run properties) to PATH; "
                        "composes with -changed (the SARIF carries "
                        "the filtered set)")

    args = parser.parse_args(argv)
    if not args.command:
        parser.print_help()
        return 1
    try:
        return COMMANDS[args.command](args)
    except APIError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except (ConnectionError, OSError) as e:
        print(f"Error connecting to {args.address}: {e}", file=sys.stderr)
        return 1


# ---------------------------------------------------------------------------
# commands
# ---------------------------------------------------------------------------

def cmd_agent(args) -> int:
    from nomad_tpu_torch.agent import Agent, AgentConfig
    from nomad_tpu_torch.utils.gated_log import BootLogGate

    # Gate boot logs until the final level/sinks are known (config files
    # parsed, agent constructed) — reference helper/gated-writer +
    # command/agent/log_writer.go.  Buffered lines replay exactly once.
    gate = BootLogGate()

    try:
        if args.dev:
            cfg = AgentConfig.dev()
            cfg.http_port = args.http_port
            cfg.rpc_port = args.rpc_port
            cfg.device = args.device
        else:
            cfg = AgentConfig(
                server_enabled=args.server,
                client_enabled=args.client,
                data_dir=args.data_dir,
                bind_addr=args.bind,
                http_port=args.http_port,
                rpc_port=args.rpc_port,
                serf_port=args.serf_port,
                device=args.device,
            )
            if args.servers:
                for part in args.servers.split(","):
                    host, port = part.rsplit(":", 1)
                    cfg.servers.append((host, int(port)))
        if args.config:
            from nomad_tpu_torch.agent.config import (apply_to_agent_config,
                                                load_config_sources)
            apply_to_agent_config(cfg, load_config_sources(args.config))
        if args.executor:
            # Flag beats config files (later source wins, same rule as
            # -config merge order); the env var beats both at dispatch.
            from nomad_tpu_torch.scheduler.executor import validate_executor
            cfg.executor = validate_executor(args.executor, "-executor")

        agent = Agent(cfg)
    except RuntimeError as e:
        # No card for a server agent (or another refused boot): a clean
        # message and a non-zero exit, after the buffered boot logs.
        gate.open("DEBUG")
        print(f"Error starting agent: {e}", file=sys.stderr)
        return 1
    except BaseException:
        # A failed boot must still surface its buffered logs — they are
        # exactly what explains the failure.  DEBUG: show everything.
        gate.open("DEBUG")
        raise
    gate.open(cfg.log_level)
    agent.log_writer = gate.log_writer
    agent.on_log_level = gate.set_level
    stop = []

    def _reload(*_sig):
        # SIGHUP: re-read every -config source and apply the reloadable
        # fields (reference command/agent/command.go:418-423,463).
        if not args.config:
            return
        from nomad_tpu_torch.agent.config import load_config_sources
        print("==> caught SIGHUP, reloading configuration...")
        try:
            applied = agent.reload(load_config_sources(args.config))
        except (ValueError, OSError) as e:
            # ConfigError subclasses ValueError; a reload must never be
            # able to take the agent down (reference command.go:463).
            print(f"    failed to reload configs: {e}", file=sys.stderr)
            return
        print(f"    reloaded: {', '.join(applied) if applied else 'nothing'}")

    # leave_on_interrupt / leave_on_terminate: gracefully gossip-leave
    # before shutdown (reference command.go:403-443 graceful leave).
    signal.signal(signal.SIGINT, lambda *_: stop.append(
        "leave" if cfg.leave_on_int else "stop"))
    signal.signal(signal.SIGTERM, lambda *_: stop.append(
        "leave" if cfg.leave_on_term else "stop"))
    if hasattr(signal, "SIGHUP"):
        signal.signal(signal.SIGHUP, _reload)

    def _dump_metrics(*_sig):
        # SIGUSR1: dump the in-memory telemetry sink (reference
        # go-metrics InmemSignal, command.go setupTelemetry).
        from nomad_tpu_torch.utils.metrics import metrics

        print("==> metrics snapshot:")
        print(json.dumps(metrics.inmem.snapshot(), indent=2,
                         default=str))

    if hasattr(signal, "SIGUSR1"):
        signal.signal(signal.SIGUSR1, _dump_metrics)
    # Announce only once the handlers are in: a supervisor that signals
    # the agent as soon as it reads the HTTP line gets a clean shutdown.
    http_host, http_port = agent.http.address
    print(f"==> nomad-tpu agent started")
    print(f"    HTTP: http://{http_host}:{http_port}")
    if agent.server is not None and agent.server.rpc_address():
        rh, rp = agent.server.rpc_address()
        print(f"    RPC:  {rh}:{rp}")
    if agent.client is not None:
        print(f"    Node: {agent.client.node.id}")
    while not stop:
        time.sleep(0.2)
    if stop[0] == "leave":
        print("==> caught signal, gracefully leaving cluster")
        agent.leave()
    else:
        print("==> caught signal, shutting down")
    agent.shutdown()
    return 0


def cmd_init(args) -> int:
    if os.path.exists("example.nomad"):
        print("Job 'example.nomad' already exists", file=sys.stderr)
        return 1
    with open("example.nomad", "w") as fh:
        fh.write(EXAMPLE_JOB)
    print("Example job file written to example.nomad")
    return 0


def cmd_validate(args) -> int:
    from nomad_tpu_torch.jobspec import ParseError, parse_file

    try:
        parse_file(args.file)
    except ParseError as e:
        print(f"Job validation failed: {e}", file=sys.stderr)
        return 1
    except OSError as e:
        # Without this, a missing file would fall through to main()'s
        # connection-error handler and report a bogus agent error.
        print(f"Error reading {args.file}: {e}", file=sys.stderr)
        return 1
    print("Job validation successful")
    return 0


def cmd_run(args) -> int:
    from nomad_tpu_torch.jobspec import ParseError, parse_file

    try:
        job = parse_file(args.file)
    except ParseError as e:
        print(f"Error parsing job: {e}", file=sys.stderr)
        return 1
    except OSError as e:
        print(f"Error reading {args.file}: {e}", file=sys.stderr)
        return 1
    client = APIClient(args.address)
    resp = client.job_register(job)
    eval_id = resp.get("eval_id", "")
    if args.detach or not eval_id:
        print(f"Job registration successful\nEvaluation ID: {eval_id}")
        return 0
    return _monitor_eval(client, eval_id)


def cmd_stop(args) -> int:
    client = APIClient(args.address)
    resp = client.job_deregister(args.job_id)
    eval_id = resp.get("eval_id", "")
    print(f"Job deregistered\nEvaluation ID: {eval_id}")
    return 0


def cmd_status(args) -> int:
    client = APIClient(args.address)
    if not args.job_id:
        jobs, _ = client.jobs_list()
        if not jobs:
            print("No jobs registered")
            return 0
        print(f"{'ID':<28} {'Type':<8} {'Priority':<8} Status")
        for job in jobs:
            print(f"{job.id:<28} {job.type:<8} {job.priority:<8} "
                  f"{job.status}")
        return 0
    job, _ = client.job_info(args.job_id)
    print(f"ID       = {job.id}")
    print(f"Name     = {job.name}")
    print(f"Type     = {job.type}")
    print(f"Priority = {job.priority}")
    print(f"Status   = {job.status}")
    allocs, _ = client.job_allocations(args.job_id)
    if allocs:
        print("\nAllocations:")
        print(f"{'ID':<38} {'Node':<38} {'Group':<10} "
              f"{'Desired':<8} Client")
        for a in allocs:
            print(f"{a.id:<38} {a.node_id:<38} {a.task_group:<10} "
                  f"{a.desired_status:<8} {a.client_status}")
    return 0


def cmd_node_status(args) -> int:
    client = APIClient(args.address)
    if not args.node_id:
        nodes, _ = client.nodes_list()
        print(f"{'ID':<38} {'DC':<8} {'Name':<16} {'Class':<12} "
              f"{'Drain':<6} Status")
        for n in nodes:
            print(f"{n.id:<38} {n.datacenter:<8} {n.name:<16} "
                  f"{n.node_class:<12} {str(n.drain).lower():<6} "
                  f"{n.status}")
        return 0
    node, _ = client.node_info(args.node_id)
    print(f"ID     = {node.id}")
    print(f"Name   = {node.name}")
    print(f"Class  = {node.node_class}")
    print(f"DC     = {node.datacenter}")
    print(f"Drain  = {str(node.drain).lower()}")
    print(f"Status = {node.status}")
    print(f"Attributes = "
          f"{', '.join(f'{k}={v}' for k, v in sorted(node.attributes.items()))}")
    allocs, _ = client.node_allocations(args.node_id)
    if allocs:
        print("\nAllocations:")
        for a in allocs:
            print(f"{a.id}  job={a.job_id}  {a.desired_status}/"
                  f"{a.client_status}")
    return 0


def cmd_node_drain(args) -> int:
    if args.enable == args.disable:
        print("Either -enable or -disable is required", file=sys.stderr)
        return 1
    client = APIClient(args.address)
    client.node_drain(args.node_id, args.enable)
    print(f"Node {args.node_id} drain = {args.enable}")
    return 0


def cmd_eval_monitor(args) -> int:
    client = APIClient(args.address)
    return _monitor_eval(client, args.eval_id)


def _dump_alloc_status(alloc, indent: str = "    ") -> None:
    """Scheduling explainability for one allocation: filter/exhaustion
    breakdown + scores (reference command/monitor.go dumpAllocStatus).
    Shared by eval-monitor and alloc-status so AllocMetric has exactly
    one renderer."""
    m = alloc.metrics
    if m is None:
        print(f"{indent}Allocation {alloc.id[:8]} status "
              f"{alloc.client_status!r}")
        return
    print(f"{indent}Allocation {alloc.id[:8]} status "
          f"{alloc.client_status!r} "
          f"({m.nodes_filtered}/{m.nodes_evaluated} nodes filtered)")
    sub = indent + "  "
    if m.nodes_evaluated == 0:
        print(f"{sub}* No nodes were eligible for evaluation")
    for cls, num in sorted((m.class_filtered or {}).items()):
        print(f"{sub}* Class {cls!r} filtered {num} nodes")
    for cons, num in sorted((m.constraint_filtered or {}).items()):
        print(f"{sub}* Constraint {cons!r} filtered {num} nodes")
    if m.nodes_exhausted:
        print(f"{sub}* Resources exhausted on {m.nodes_exhausted} nodes")
    for cls, num in sorted((m.class_exhausted or {}).items()):
        print(f"{sub}* Class {cls!r} exhausted on {num} nodes")
    for dim, num in sorted((m.dimension_exhausted or {}).items()):
        print(f"{sub}* Dimension {dim!r} exhausted on {num} nodes")
    if m.coalesced_failures:
        print(f"{sub}* {m.coalesced_failures} additional placements "
              f"failed the same way")
    for name, score in sorted((m.scores or {}).items()):
        print(f"{sub}* Score {name!r} = {score:.3f}")


MONITOR_MAX_CHAIN = 256  # rolling-update evals followed before bailing


def _monitor_eval(client: APIClient, eval_id: str,
                  timeout: float = 60.0) -> int:
    """Poll an eval until terminal, then report its allocations;
    follows rolling-update eval chains, with ``timeout`` bounding each
    eval in the chain (reference command/monitor.go).  Total runtime is
    bounded: stagger sleeps honor the job's full stagger but are capped
    at an absolute 1h per hop, and at most MONITOR_MAX_CHAIN chained
    evals are followed, so a pathological stagger or an endless chain
    can't hang the CLI."""
    followed = 0
    while True:
        print(f"==> Monitoring evaluation \"{eval_id[:8]}\"")
        deadline = time.monotonic() + timeout
        index = 0
        ev = None
        while time.monotonic() < deadline:
            ev, meta = client.eval_info(eval_id, QueryOptions(
                wait_index=index, wait_time=2.0))
            index = meta.last_index
            if ev.status in ("complete", "failed"):
                break
            ev = None
        if ev is None:
            print("    Monitor timed out", file=sys.stderr)
            return 1
        print(f"    Evaluation status: {ev.status} "
              f"{ev.status_description}")
        allocs, _ = client.eval_allocations(eval_id)
        for a in allocs:
            if a.desired_status == "failed":
                # Scheduling failure: the dump carries the header AND
                # the why (reference monitor.go:220-228 +
                # dumpAllocStatus).
                _dump_alloc_status(a)
            else:
                where = f"on node {a.node_id[:8]}" if a.node_id \
                    else "unplaced"
                print(f"    Allocation {a.id[:8]} {where} "
                      f"({a.desired_status})")
        if ev.next_eval:
            # Rolling update: follow the chain like the reference
            # monitor (monitor.go:244-253).  The stagger lives on the
            # NEXT eval (next_rolling_eval sets its ``wait``; the
            # broker holds it that long), so fetch it and sleep that
            # out before the per-eval poll deadline starts.
            followed += 1
            if followed >= MONITOR_MAX_CHAIN:
                print(f"    Followed {followed} chained evaluations; "
                      "giving up (job keeps rolling server-side)",
                      file=sys.stderr)
                return 1
            nxt, _ = client.eval_info(ev.next_eval)
            # Sleep the FULL stagger (capping below it would time the
            # next eval out while the broker still holds it), bounded
            # by an absolute 1h ceiling so a pathological stagger
            # can't hang the CLI forever.
            wait = min(nxt.wait, 3600.0)
            print(f"==> Monitoring next evaluation "
                  f"\"{ev.next_eval[:8]}\" in {wait:.0f}s")
            time.sleep(wait)
            eval_id = ev.next_eval
            continue
        return 0 if ev.status == "complete" else 2


def cmd_alloc_status(args) -> int:
    client = APIClient(args.address)
    alloc, _ = client.alloc_info(args.alloc_id)
    print(f"ID         = {alloc.id}")
    print(f"Eval       = {alloc.eval_id}")
    print(f"Job        = {alloc.job_id}")
    print(f"TaskGroup  = {alloc.task_group}")
    print(f"Node       = {alloc.node_id}")
    print(f"Desired    = {alloc.desired_status}")
    print(f"Client     = {alloc.client_status}")
    if alloc.metrics:
        print(f"\nPlacement metrics:")
        _dump_alloc_status(alloc, indent="  ")
    return 0


def cmd_server_members(args) -> int:
    client = APIClient(args.address)
    for member in client.agent_members():
        print(member)
    return 0


def cmd_server_join(args) -> int:
    client = APIClient(args.address)
    resp = client.agent_join(args.join_address)
    print(f"Joined {resp.get('num_joined', 0)} servers")
    return 0


def cmd_server_force_leave(args) -> int:
    """Force a gossip member into the left state (reference
    command/server_force_leave.go)."""
    client = APIClient(args.address)
    client.agent_force_leave(args.member_name)
    print(f"Forced leave of member {args.member_name!r}")
    return 0


def cmd_client_config(args) -> int:
    """View or update the client's server list (reference
    command/client_config.go)."""
    client = APIClient(args.address)
    if args.update_servers:
        servers = [s.strip() for s in args.update_servers.split(",")
                   if s.strip()]
        client.agent_set_servers(servers)
        print(f"Updated server list ({len(servers)} servers)")
        return 0
    for host, port in client.agent_servers():
        print(f"{host}:{port}")
    return 0


def cmd_agent_info(args) -> int:
    client = APIClient(args.address)
    print(json.dumps(client.agent_self(), indent=2, default=str))
    return 0


def cmd_monitor(args) -> int:
    """Print the agent's recent log ring; with -follow, poll for new
    lines by monotonic offset (the reference's poll-based monitor
    pattern, monitor.go — offsets survive ring wraps, no re-prints)."""
    if args.lines < 0:
        print("monitor: -lines must be >= 0", file=sys.stderr)
        return 1
    client = APIClient(args.address)
    # One request serves both modes: the (server-trimmed) ring snapshot
    # to print and the offset -follow resumes from.
    lines, offset = client.agent_monitor_since(0, args.lines)
    for line in lines:
        print(line)
    if not args.follow:
        return 0
    try:
        while True:
            time.sleep(1.0)
            try:
                lines, offset = client.agent_monitor_since(offset)
            except (OSError, APIError):
                # Transient (agent reload/restart): the monotonic offset
                # lets the stream resume where it left off.
                continue
            for line in lines:
                print(line)
    except KeyboardInterrupt:
        return 0


def cmd_metrics(args) -> int:
    """Dump the unified metrics registry (obs/registry.py) from a live
    agent: flat ``key = value`` lines sorted by key (the key grammar is
    ``nomad.<provider>.<path...>``), or the raw JSON document with
    -json.  The in-mem sink's counters and sample summaries ride along
    under ``counters.*`` / ``samples.*``.

    ``-watch N`` re-samples every N seconds and renders DELTAS: the
    full listing once, then only the keys that changed, each with its
    per-second rate — so counters read as rates and the feedback
    controller's knob movements (``nomad.controller.knobs.*.value``)
    are observable live."""
    client = APIClient(args.address)
    if args.watch and args.watch > 0:
        return _watch_metrics(client, args.watch, args.filter,
                              args.rounds)
    doc = client.agent_metrics()
    if args.as_json:
        print(json.dumps(doc, indent=2, default=str))
        return 0
    flat = _flat_metrics(doc)
    shown = 0
    for key in sorted(flat):
        if args.filter and args.filter not in key:
            continue
        print(f"{key} = {flat[key]}")
        shown += 1
    if args.filter and not shown:
        print(f"no metric keys contain {args.filter!r}", file=sys.stderr)
        return 1
    return 0


def _flat_metrics(doc: dict) -> dict:
    """ONE flattening grammar (obs/registry.flatten) for the inmem doc
    too: counters.<key>, gauges.<key>, samples.<key>.<stat>."""
    from nomad_tpu_torch.obs.registry import flatten

    flat = dict(doc.get("providers") or {})
    flat.update(flatten(doc.get("inmem") or {}))
    return flat


def _watch_metrics(client, interval: float, flt: str,
                   rounds: int) -> int:
    """The -watch loop: first sample prints the (filtered) listing;
    every later round prints only the keys whose value changed, as
    ``key = new (Δdelta, rate/s)`` for numeric keys — a counter's
    line IS its rate.  The substring filter rides to the server
    (?filter=) so a tight watch does not drag the full document over
    the wire every round."""
    prev: "dict | None" = None
    prev_t = 0.0
    done = 0
    try:
        while True:
            doc = client.agent_metrics(filter=flt)
            now = time.monotonic()
            flat = {k: v for k, v in _flat_metrics(doc).items()
                    if not flt or flt in k}
            if prev is None:
                for key in sorted(flat):
                    print(f"{key} = {flat[key]}")
            else:
                dt = max(now - prev_t, 1e-9)
                changed = []
                for key in sorted(flat):
                    old, new = prev.get(key), flat[key]
                    if old == new:
                        continue
                    if isinstance(new, (int, float)) \
                            and not isinstance(new, bool) \
                            and isinstance(old, (int, float)):
                        delta = new - old
                        changed.append(
                            f"{key} = {new} ({delta:+g}, "
                            f"{delta / dt:+.1f}/s)")
                    else:
                        changed.append(f"{key} = {new} (was {old})")
                print(f"--- +{interval:g}s: {len(changed)} of "
                      f"{len(flat)} keys changed")
                for line in changed:
                    print(line)
            prev, prev_t = flat, now
            done += 1
            if rounds and done > rounds:
                return 0
            time.sleep(interval)
    except KeyboardInterrupt:
        return 0


def cmd_version(args) -> int:
    print(f"nomad-tpu v{__version__}")
    return 0


# The ROADMAP item that ports the static analyzers ``lint`` runs.
LINT_UNPORTED = ("lint: the static analyzers (analysis/) are not ported "
                 "to nomad_tpu_torch yet (ROADMAP Queue 1 item 4)")


def cmd_lint(args) -> int:
    """The JAX CLI's static-analysis gate.  Its analyzers are not ported
    (ROADMAP Queue 1 item 4), so the command refuses instead of
    reporting a clean run."""
    print(f"Error: {LINT_UNPORTED}", file=sys.stderr)
    return 1


COMMANDS = {
    "agent": cmd_agent,
    "init": cmd_init,
    "validate": cmd_validate,
    "run": cmd_run,
    "stop": cmd_stop,
    "status": cmd_status,
    "node-status": cmd_node_status,
    "node-drain": cmd_node_drain,
    "eval-monitor": cmd_eval_monitor,
    "alloc-status": cmd_alloc_status,
    "server-members": cmd_server_members,
    "server-join": cmd_server_join,
    "server-force-leave": cmd_server_force_leave,
    "client-config": cmd_client_config,
    "monitor": cmd_monitor,
    "agent-info": cmd_agent_info,
    "metrics": cmd_metrics,
    "version": cmd_version,
    "lint": cmd_lint,
}
