"""The load generator: a process of its own holding one thread per
client, each a closed-loop submitter on the port's RPC client.

    python loadgen.py --cell NAME --seed N --traffic FILE

One cycle of a client: ``Job.Register`` of a new job, a blocking
``Eval.GetEval`` until that eval is terminal, ``Job.Deregister`` of the
job it registered in its previous cycle, and a blocking ``Eval.GetEval``
until that one is terminal.  An eval's latency runs from the instant its
request was sent to the instant the monitor read it terminal.

Protocol on standard input and output, one JSON object a line: the
generator prints ``{"event": "ready"}`` once imported (it starts before
the server, so its imports overlap the server's); the next line,
``{"addr": "HOST:PORT"}``, names the server's RPC listener, and the
generator warms up (each client registers its first job and waits for
its eval) and prints ``{"event": "warm"}``; it then reads
``{"close": T}`` (a ``time.perf_counter`` instant, CLOCK_MONOTONIC, the
same clock in both processes), runs cycles until T, waits up to
``drain_s`` past T for the evals in flight, and prints ``{"event":
"done", "records": [...]}``.  A record is ``[kind, client, job_id,
eval_id, t_sent, t_terminal, status]``; a request that failed has
eval_id None and its error as status.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

import shapes  # noqa: E402
import spec  # noqa: E402

TERMINAL = ("complete", "failed", "cancelled")


class Client(threading.Thread):
    def __init__(self, addr, index, cell, seed, template, traffic,
                 records, lock):
        super().__init__(name=f"client-{index}", daemon=True)
        self.addr = addr
        self.index = index
        self.cell = cell
        self.seed = seed
        self.template = template
        self.wait_s = float(traffic["monitor_wait_s"])
        self.drain_s = float(traffic["drain_s"])
        self.records = records
        self.lock = lock
        self.cycle = 0
        self.live = None        # the job registered in the last cycle
        self.close_at = None    # set when the window opens
        self.go = threading.Event()
        self.warm = threading.Event()
        self.warm_error = None
        self.pool = None

    def request(self, kind, method, args):
        """One request and its monitor; returns the record."""
        t_sent = time.perf_counter()
        try:
            reply = self.pool.call(self.addr, method, args, timeout=120.0)
            eval_id = reply["eval_id"]
        except Exception as e:  # noqa: BLE001 - a failed request is data
            return [kind, self.index, args.get("job_id") or
                    args["job"]["id"], None, t_sent, None,
                    f"error: {type(e).__name__}: {e}"]
        job = args.get("job_id") or args["job"]["id"]
        deadline = (self.close_at + self.drain_s) if self.close_at \
            else t_sent + 600.0
        index = 0
        while True:
            left = deadline - time.perf_counter()
            if left <= 0:
                return [kind, self.index, job, eval_id, t_sent, None,
                        "error: not terminal by the deadline"]
            try:
                got = self.pool.call(
                    self.addr, "Eval.GetEval",
                    {"eval_id": eval_id, "min_query_index": index,
                     "max_query_time": min(self.wait_s, left)},
                    timeout=min(self.wait_s, left) + 30.0)
            except Exception as e:  # noqa: BLE001
                return [kind, self.index, job, eval_id, t_sent, None,
                        f"error: {type(e).__name__}: {e}"]
            ev = got.get("eval")
            if ev is not None and ev["status"] in TERMINAL:
                return [kind, self.index, job, eval_id, t_sent,
                        time.perf_counter(), ev["status"]]
            index = max(index, int(got.get("index") or 0))

    def register(self):
        self.cycle += 1
        jid = shapes.job_id(self.cell, self.seed, self.index, self.cycle)
        rec = self.request("register", "Job.Register",
                           {"job": shapes.with_id(self.template, jid)})
        return jid, rec

    def run(self):
        from nomad_tpu_torch.server.rpc import ConnPool

        self.pool = ConnPool()
        try:
            jid, rec = self.register()
            with self.lock:
                self.records.append(rec)
            if rec[-1] != "complete":
                self.warm_error = rec[-1]
            self.live = jid
        finally:
            self.warm.set()
        self.go.wait()
        try:
            while self.warm_error is None:
                if time.perf_counter() >= self.close_at:
                    break
                jid, rec = self.register()
                with self.lock:
                    self.records.append(rec)
                if time.perf_counter() >= self.close_at:
                    break
                old, self.live = self.live, jid
                rec = self.request("deregister", "Job.Deregister",
                                   {"job_id": old})
                with self.lock:
                    self.records.append(rec)
        finally:
            self.pool.shutdown()


def say(obj) -> None:
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--traffic", required=True)
    args = ap.parse_args(argv)
    traffic = spec.load_json(Path(args.traffic))
    template = shapes.job_template(traffic["job"])
    records: list = []
    lock = threading.Lock()
    import nomad_tpu_torch.server.rpc  # noqa: F401 - paid before "ready"
    say({"event": "ready"})
    line = sys.stdin.readline()
    if not line:
        return 2
    host, port = json.loads(line)["addr"].rsplit(":", 1)
    clients = [Client((host, int(port)), i, args.cell, args.seed, template,
                      traffic, records, lock)
               for i in range(traffic["clients"])]
    for c in clients:
        c.start()
    for c in clients:
        c.warm.wait()
    errors = [c.warm_error for c in clients if c.warm_error]
    say({"event": "warm", "errors": errors})
    line = sys.stdin.readline()
    if not line:
        return 2
    close_at = float(json.loads(line)["close"])
    with lock:
        # The warm-up's evals are set-up, not window.
        warm_records, records[:] = list(records), []
    for c in clients:
        c.close_at = close_at
        c.go.set()
    for c in clients:
        c.join(close_at - time.perf_counter() + c.drain_s + 180.0)
    stuck = [c.name for c in clients if c.is_alive()]
    with lock:
        out = list(records)
    say({"event": "done", "warm_records": warm_records, "records": out,
         "stuck": stuck, "forbidden": spec.forbidden_modules()})
    return 0 if not stuck else 3


if __name__ == "__main__":
    sys.exit(main())
