"""The batch runner's chained tail on the card (marked ``card``: each
test skips where no CUDA device is present).

On a 10,000-node fleet of ``mock.node()`` the tail's device chain (one
upload of the stacked lanes, K3 launched lane after lane on the usage
the lane before it left, one fetch) equals the same chain of K3's plain
version on the card bit for bit, its uploads do not grow with its lanes,
and each of its ``device.K3`` spans carries its lane's position.

This file imports no JAX, so it runs on a machine with the card and no
JAX package: ``python -m pytest --noconftest -q
tests/test_torch_chained_tail_card.py`` from the repository's root.
"""
import numpy as np
import pytest
import torch

from nomad_tpu_torch import mock
from nomad_tpu_torch.obs import trace
from nomad_tpu_torch.ops import binpack
from nomad_tpu_torch.parallel.devices import transfer_counts
from nomad_tpu_torch.scheduler import Harness
from nomad_tpu_torch.scheduler.batch import BatchEvalRunner
from nomad_tpu_torch.scheduler.executor import executor_override
from nomad_tpu_torch.scheduler.torch_binpack import rounds_to_placements
from nomad_tpu_torch.structs import (
    EVAL_TRIGGER_JOB_REGISTER,
    Evaluation,
    generate_uuid,
)

pytestmark = pytest.mark.card

N_NODES = 10_000


@pytest.fixture(scope="module")
def world():
    """A card harness with a 10,000-node ``mock.node()`` fleet and a
    runner on its snapshot, under the device executor."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    h = Harness(device="cuda")
    h.state.upsert_node_slab(h.next_index(), mock.node_slab(N_NODES))
    runner = BatchEvalRunner(h.snapshot(), h, state_refresh=h.snapshot,
                             device="cuda")
    with executor_override("device"):
        yield h, runner


def _lanes(h, runner, n):
    """``n`` lanes of ``mock.job()`` begun on the runner's snapshot, as
    the tail begins them."""
    jobs = [mock.job() for _ in range(n)]
    for job in jobs:
        h.state.upsert_job(h.next_index(), job)
    runner.state = h.snapshot()
    pending = []
    for job in jobs:
        sched = runner._begin_eval(Evaluation(
            id=generate_uuid(), priority=job.priority, type=job.type,
            triggered_by=EVAL_TRIGGER_JOB_REGISTER, job_id=job.id))
        place, args = sched.deferred
        assert args.rounds_eligible
        pending.append((sched, place, args))
    return pending


def _plain_chain(pending):
    """K3's plain version lane after lane, each on the usage the lane
    before it returned: [(chosen, scores), ...].  It runs on the card,
    as chip_smoke.py holds each kernel to it: the CPU's pow may round
    an ulp apart from the card's."""
    def card(x):
        return torch.from_numpy(np.asarray(x)).to("cuda")

    statics = pending[0][2].statics
    cap, res = card(statics.capacity), card(statics.reserved)
    usage = card(pending[0][2].view.usage)
    out = []
    for _s, _p, a in pending:
        chosen, scores, usage = binpack.place_rounds_plain(
            cap, res, usage, card(a.view.job_counts), card(a.feasible_h),
            card(a.asks), card(a.distinct), card(a.counts), a.penalty,
            k_cap=a.k_cap, rounds=a.rounds)
        out.append(rounds_to_placements(a, chosen.cpu().numpy(),
                                        scores.cpu().numpy()))
    return out


def test_the_device_chain_equals_the_plain_chain(world):
    h, runner = world
    pending = _lanes(h, runner, 32)
    launches = binpack.place_rounds.launches
    done = runner._dispatch_chained(pending)
    assert binpack.place_rounds.launches - launches == 32
    placed = set()
    for (_s, _p, _a, chosen, scores), (want_c, want_s) in zip(
            done, _plain_chain(pending)):
        assert np.array_equal(chosen, want_c)
        assert np.array_equal(np.ascontiguousarray(scores).view(np.int32),
                              np.ascontiguousarray(want_s).view(np.int32))
        assert (chosen[:10] >= 0).all()
        placed.update(chosen[:10].tolist())
    # ten copies a lane of 500 MHz, on nodes that hold seven: each ten
    # nodes take seven lanes before the next ten fill, not each lane
    # the fleet's first ten
    assert len(placed) == 10 * -(-32 // 7)


def test_the_chains_uploads_do_not_grow_with_its_lanes(world):
    h, runner = world
    runner._dispatch_chained(_lanes(h, runner, 8))  # warm
    uploads = []
    for n in (8, 32):
        pending = _lanes(h, runner, n)
        before = transfer_counts()["h2d"]
        runner._dispatch_chained(pending)
        uploads.append(transfer_counts()["h2d"] - before)
    assert uploads[0] == uploads[1] <= 6


def test_each_walk_of_the_chain_is_tagged_with_its_lane(world):
    h, runner = world
    pending = _lanes(h, runner, 4)
    with trace.tracing(seed=3) as t:
        runner._dispatch_chained(pending)
        spans = [s for s in t.snapshot() if s["name"] == "device.K3"]
    assert [s["tags"]["chain"] for s in spans] == [0, 1, 2, 3]
    assert all(s["dur"] > 0 for s in spans)
