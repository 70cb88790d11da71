"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

The run boots the port's server (``nomad_tpu_torch.server.Server``, its
RPC listener on, the configuration's settings) on the card, registers
the configuration's fleet through raft, starts the load generator
(``loadgen.py``, a process of its own) whose clients warm up with one
job each, then opens the window for ``--seconds``.  After it closes the
run reads the store back and lets the plain reference
(``reference/judge.py``) judge it, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, ``evals_per_s`` and ``setup_s``, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced, ``breakdown``; ``checks`` last, each
compared number with its limit, which also end standard error.

``--plant NAME`` (``faults.py``) breaks the timed path underneath, for
the control and the fault checks of ``correct``; the benchmark's own
runs plant nothing.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import queue  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for _p in (str(ROOT), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import faults  # noqa: E402
import spec  # noqa: E402

# Build and kernel caches of anything the run loads stay inside the
# checkout, at fixed paths (the port's own nvcc and g++ builds go to
# nomad_tpu_torch/_build/).
CACHE = HERE / "_cache"
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(CACHE / _dir)

RING = 1 << 22  # spans the traced run's tracer keeps


class RunError(RuntimeError):
    """The run cannot give a result."""


class Child:
    """The load generator's process, read line by line off a thread."""

    def __init__(self, cell_name, seed, traffic_path):
        self.proc = subprocess.Popen(
            [sys.executable, str(HERE / "loadgen.py"), "--cell", cell_name,
             "--seed", str(seed), "--traffic", str(traffic_path)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=str(ROOT))
        self.lines: queue.Queue = queue.Queue()
        self.reader = threading.Thread(target=self._read, daemon=True,
                                       name="loadgen-reader")
        self.reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def send(self, obj):
        self.proc.stdin.write(json.dumps(obj) + "\n")
        self.proc.stdin.flush()

    def expect(self, event, timeout):
        try:
            line = self.lines.get(timeout=timeout)
        except queue.Empty:
            raise RunError(f"load generator: no {event!r} in {timeout} s")
        if line is None:
            raise RunError(f"load generator exited before {event!r} "
                           f"(code {self.proc.wait()})")
        msg = json.loads(line)
        if msg.get("event") != event:
            raise RunError(f"load generator: {msg} where {event!r} was due")
        return msg

    def stop(self):
        if self.proc.poll() is None:
            try:
                self.proc.stdin.close()
            except OSError:
                pass
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.reader.join(timeout=10)


def read_state(srv) -> dict:
    """The committed state as plain values, for the reference."""
    st = srv.fsm.state
    evals = {e.id: (e.status, e.job_id, e.triggered_by) for e in st.evals()}
    allocs = {"node_id": [], "job_id": [], "name": [], "desired_status": [],
              "ports": []}
    for a in st.allocs():
        allocs["node_id"].append(a.node_id)
        allocs["job_id"].append(a.job_id)
        allocs["name"].append(a.name)
        allocs["desired_status"].append(a.desired_status)
        allocs["ports"].append([p for r in (a.task_resources or {}).values()
                                for net in r.networks
                                for p in net.reserved_ports])
    return {"evals": evals, "allocs": allocs,
            "node_status": {n.id: n.status for n in st.nodes()}}


def window_evals(records, t_open, t_close) -> list:
    """Latencies (s) of the evals that completed inside the window."""
    return [r[5] - r[4] for r in records
            if r[6] == "complete" and r[5] is not None
            and t_open <= r[5] <= t_close]


def gaps(device, spans, t_open, t_close, top=10) -> list:
    """The longest stretches of the window with no device work, each
    named by the shortest host spans under its middle."""
    out, end = [], t_open
    for _n, _k, a, b, _s in sorted(device, key=lambda d: d[2]):
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if t_close > end:
        out.append((end, t_close))
    out.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in out[:top]:
        mid = (a + b) / 2
        under = sorted((s for s in spans
                        if s["t0"] <= mid <= s["t0"] + s["dur"]
                        and not s["name"].startswith("rpc.serve.Eval")),
                       key=lambda s: s["dur"])
        names = []
        for s in under:
            if s["name"] not in names:
                names.append(s["name"])
        named.append(["+".join(names[:3]) or "no span", b - a])
    return named


def device_ops(device, top=10) -> list:
    total: dict = {}
    for name, _k, a, b, _s in device:
        total[name] = total.get(name, 0.0) + (b - a)
    return sorted(([n, s] for n, s in total.items()),
                  key=lambda x: -x[1])[:top]


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(bench, cell, cfg, traffic_path, seed, seconds, trace, *,
             device="cuda", plant=None, child=None):
    """One run; returns the result object the last line prints.
    ``child``: the load generator, started early by the caller, or
    None to start it here; it is stopped before this returns."""
    if child is None:
        child = Child(cell["name"], seed, traffic_path)
    try:
        return _run(bench, cell, cfg, traffic_path, seed, seconds, trace,
                    device, plant, child)
    finally:
        child.stop()


def _run(bench, cell, cfg, traffic_path, seed, seconds, trace, device,
         plant, child):
    import torch

    from nomad_tpu_torch.obs import trace as trace_mod
    from nomad_tpu_torch.parallel import devices
    from nomad_tpu_torch.scheduler.batch import BatchEvalRunner
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.structs import Node

    import shapes
    from reference import judge

    traffic = spec.load_json(traffic_path)
    template = shapes.job_template(traffic["job"])
    nodes = shapes.fleet(cfg, seed)
    on_card = device != "cpu"
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    # Set-up's parts, each from the end of the one before: the imports,
    # CUDA's start and the inputs; the server's boot; the fleet's
    # registrations; leadership and the load generator's start; the
    # warm-up's evals; the traced run's instruments.
    marks = [("start", T_START), ("imports", time.perf_counter())]
    srv = Server(ServerConfig(device=device, **cfg["server"]))
    marks.append(("boot", time.perf_counter()))
    timeline = None
    process = BatchEvalRunner.process
    try:
        if plant is not None:
            faults.PLANTS[plant](srv)
        for d in nodes:
            srv.node_register(Node.from_dict(d))
        marks.append(("fleet", time.perf_counter()))
        srv.establish_leadership()
        child.expect("ready", 300)
        marks.append(("loadgen", time.perf_counter()))
        host, port = srv.rpc_address()
        child.send({"addr": f"{host}:{port}"})
        # A client whose first eval failed sits the window out; the
        # reference counts its request with the rest.
        child.expect("warm", 900)
        marks.append(("warm", time.perf_counter()))

        counters = {"batches": 0, "batch_evals": 0}
        tracer = None
        if trace:
            if on_card:
                from timeline import Timeline

                timeline = Timeline(torch)
                timeline.install()
            def counted(self, evals):
                counters["batches"] += 1
                counters["batch_evals"] += len(evals)
                return process(self, evals)

            BatchEvalRunner.process = counted
            tracer = trace_mod.enable(seed=seed, ring=RING)
        applier0 = srv.plan_applier.stats()
        h2d0 = devices.transfer_counts()["h2d"]
        spec.guard("after set-up")

        t_open = time.perf_counter()
        setup_s = t_open - T_START
        marks.append(("instruments", t_open))
        t_close = t_open + seconds
        child.send({"close": t_close})
        drain = float(traffic["drain_s"])
        done = child.expect("done", seconds + drain + 300)
        t_after = time.perf_counter()

        ctx = None
        if trace:
            h2d = devices.transfer_counts()["h2d"] - h2d0
            applier1 = srv.plan_applier.stats()
            epoch = time.perf_counter() - tracer.now()
            stats = tracer.stats()
            trace_mod.disable()
            spans = [dict(s, t0=s["t0"] + epoch) for s in tracer.snapshot()]
            spans = [s for s in spans if t_open <= s["t0"] <= t_close]
            dev = timeline.intervals(t_open, t_close) if on_card else []
            ctx = dict(
                spans=spans, dropped=stats["dropped"], window_s=seconds,
                device=dev, n_real=len(nodes),
                hbm_bytes_per_s=__import__("readout").HBM_BYTES_PER_S,
                kernel_bytes={k: spec.kernel_bytes(k)
                              for k in spec.kernel_names()},
                counters=dict(counters, h2d=h2d, applier={
                    k: applier1[k] - applier0[k]
                    for k in ("conflict_fallbacks", "plans_committed",
                              "commits")}))
            print(f"tracer: {stats['recorded']} spans recorded, "
                  f"{stats['dropped']} dropped", file=sys.stderr)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        worker_failures = sum(getattr(w, "failures", 0)
                              for w in srv.workers)
        state = read_state(srv)
    finally:
        BatchEvalRunner.process = process
        if timeline is not None:
            timeline.uninstall()
        srv.shutdown()
        child.stop()
    del srv
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if done["forbidden"]:
        raise RunError("load generator loaded " + ", ".join(
            done["forbidden"]))

    records = done["records"]
    every = done["warm_records"] + records
    ops = [(r[0], r[2], r[3], r[6]) for r in every if r[3] is not None]
    t_judge = time.perf_counter()
    # Each client of the closed loop holds at most two jobs live: its
    # previous one stays until its new one's eval is complete.
    checks = judge.judge(nodes, template, ops, state,
                         most_live_jobs=2 * traffic["clients"])
    limit = judge.limits(cfg.get("limits", {}))
    buckets = [0] * (seconds // 5 + 1)
    for r in records:
        if r[5] is not None and t_open <= r[5] <= t_close:
            buckets[int((r[5] - t_open) // 5)] += 1
    t_done = time.perf_counter()
    print(f"after the window: state read and teardown "
          f"{t_judge - t_after:.2f} s, reference {t_done - t_judge:.2f} s; "
          f"{len(state['allocs']['node_id'])} allocations judged; evals "
          f"complete in each 5 s of the window: {buckets}", file=sys.stderr)
    failed = sum(1 for r in records if r[6] != "complete")
    checks["requests_failed"] = sum(1 for r in every if r[6] != "complete")
    checks["worker_failures"] = worker_failures
    checks["clients_stuck"] = len(done["stuck"])
    lat = window_evals(records, t_open, t_close)

    metrics = {}
    if not trace:
        e2e = {"evals_per_s": len(lat) / seconds, "setup_s": setup_s}
        for m in spec.end_to_end(bench, cell["name"]):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        ctx["evals"] = len(lat)
        ctx["latencies"] = lat
        for m in spec.per_layer(bench, cell["name"]):
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": not judge.broken(checks, limit),
              "attempted": len(records), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        from readout import union_s

        dev["busy_s"] = union_s([(a, b) for _n, _k, a, b, _s
                                 in ctx["device"]])
        dev["window_s"] = seconds
        result["breakdown"] = {
            "device_ops": device_ops(ctx["device"]),
            "idle_gaps": gaps(ctx["device"], ctx["spans"], t_open,
                              t_close)}
    result["card"] = card_line() if on_card else "cpu"
    result["setup_parts_s"] = {
        name: t - t_before
        for (_n, t_before), (name, t) in zip(marks, marks[1:])}
    result["checks"] = {k: {"value": v, "limit": limit.get(k, 0)}
                        for k, v in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--plant", choices=sorted(faults.PLANTS))
    args = ap.parse_args(argv)

    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    traffic_path = HERE / "workloads" / f"{cell['traffic']}.json"
    # The load generator's imports overlap this process's.
    child = Child(cell["name"], args.seed, traffic_path)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        child.stop()
        print(f"no run: the cell asks for {cell['chips']} CUDA device(s), "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    try:
        result = run_cell(bench, cell, cfg, traffic_path, args.seed,
                          args.seconds, args.trace, plant=args.plant,
                          child=child)
        spec.guard("at exit")
    except (RunError, ImportError) as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
