"""K4b's two cluster shapes on one NVIDIA GPU, timed on the same inputs.

    python3 tools/k4b_cluster_shapes.py

K4b (``place_sequence_batch_kernel``, nomad_tpu_torch/csrc/binpack.cu)
runs one thread-block cluster per lane.  Its plan halves K2's cluster
until the lanes fit one wave of the card (``binpack.sequence_batch_plan``);
the other shape keeps K2's cluster (``binpack.sequence_plan``) and lets
the lanes run in waves.  This script launches both at the shapes the
kernel's note cites (N=16,384: B=8, P=256, 3 random groups; B=64, P=64,
runs of 8 groups), holds each to the plain version bit for bit, times
each with CUDA events, and prints one JSON line.  The port launches only
the rule's plan; the other is put in the plan cache here for the call.
"""
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k4b_cluster_shapes: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from nomad_tpu_torch.ops import binpack

    rng = np.random.default_rng(4)
    out = {"card": cs.card_line()}
    for lanes, p, groups, order in ((8, 256, 3, "random"),
                                    (64, 64, 8, "runs")):
        n, g = 16384, 8
        c = cs.lanes_case(torch, n, lanes, rng, uniform=False, g=g)
        group_idx = torch.from_numpy(np.stack([
            cs.sequence_groups(rng, p, groups, order)
            for _ in range(lanes)])).to("cuda")
        valid = torch.ones((lanes, p), dtype=torch.bool, device="cuda")
        penalty = torch.full((lanes,), 10.0, device="cuda")
        args = (c["capacity"], c["reserved"], c["usage0"], c["jc0"],
                c["feasible"], c["asks"], c["distinct"], group_idx, valid,
                penalty)
        want = binpack.place_sequence_batch_plain(*args)
        key = (torch.cuda.current_device(), n, g, lanes)
        rule = binpack.sequence_batch_plan(n, g, lanes, "cuda")
        row = {}
        for name, plan in (("one wave (the rule)", rule),
                           ("K2's cluster, in waves",
                            binpack.sequence_plan(n, g, "cuda"))):
            binpack._SEQUENCE_BATCH_PLANS[key] = plan
            try:
                got = binpack.place_sequence_batch(*args)
                torch.cuda.synchronize()
                cs.compare(torch, f"K4b B={lanes} {name}", got, want)
                row[name] = dict(plan=list(plan), ms=cs.time_ms(
                    torch, lambda: binpack.place_sequence_batch(*args), 5))
            finally:
                binpack._SEQUENCE_BATCH_PLANS[key] = rule
        out[f"N={n} B={lanes} P={p} {order} G={groups}"] = row
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
