"""The port's device verify engine (K6 inside ops/plan_conflict.py) against
its host engine and the JAX package's device engine: twins of
tests/test_plan_batch.py ``device_grouped_apply`` and
``TestDeviceVerifyParity``, plus the verify policy's resolution order.

The port runs its device engine with ``device="cpu"`` under its own
``verify_override("device")``: the plain version of K6 there.  The JAX
package runs its device engine under its ``verify_override("device")``
on the 8-device CPU mesh tests/conftest.py forces.  Every world is built
twice from the same nodes and allocs (nomad_tpu_torch.convert) and the
plans are carried over with their alloc ids; verdict streams, accepted
alloc sets and stores must be byte-identical across the port's device
engine, the port's host engine, the JAX device engine and sequential
application.  Both sides must be seen to dispatch: a silent host run
would compare host against host.
"""
import os
import random

import pytest
import torch

import nomad_tpu.mock as mock
from nomad_tpu.ops import verify_policy as j_policy
from nomad_tpu.ops.plan_conflict import evaluate_window as j_window
from nomad_tpu.server.plan_apply import evaluate_plan as j_evaluate_plan
from nomad_tpu.structs import ALLOC_DESIRED_STATUS_STOP, Plan, generate_uuid
from nomad_tpu_torch import convert
from nomad_tpu_torch.ops import verify_policy as t_policy
from nomad_tpu_torch.ops.plan_conflict import evaluate_window as t_window
from nomad_tpu_torch.parallel import mesh as tmesh
from nomad_tpu_torch.server.plan_apply import evaluate_plan as t_evaluate_plan
from tests.test_torch_plan_conflict import (FREE_CPU, _accepted, _record_storm,
                                            _worlds, make_alloc, net_alloc,
                                            place_plan, result_key,
                                            sequential_apply, store_image)

torch.set_num_threads(1)


def _stamp_adversarial_deadlines(plans) -> None:
    """Deadlines DESCENDING by window position, so the deadline-aware
    component scheduler verifies components in roughly REVERSE window
    order (tests/test_plan_batch.py)."""
    import time as _time
    now = _time.monotonic()
    n = len(plans)
    for i, plan in enumerate(plans):
        plan.deadline = now + 100.0 + (n - i) * 10.0


def grouped_apply(window, store, plans, base_index, **kw):
    """One window verify, one batched upsert, one index per plan."""
    outcomes = window(store, plans, **kw)
    items = [(base_index + i, _accepted(o.result))
             for i, o in enumerate(outcomes) if _accepted(o.result)]
    if items:
        store.upsert_allocs_batched(items)
    return outcomes


def j_device_grouped_apply(store, plans, base_index):
    """tests/test_plan_batch.py device_grouped_apply: warm the lease,
    prove a dispatch on an untouched store, then apply."""
    with j_policy.verify_override("device"):
        j_window(store, plans)
        probe = j_window(store, plans)
        dev = probe.info["device"] if probe.info else None
        assert dev is not None and dev["dispatched"], dev
        return grouped_apply(j_window, store, plans, base_index)


def t_device_grouped_apply(store, plans, base_index):
    """The same in the port, with K6's plain version on the CPU."""
    with t_policy.verify_override("device"):
        t_window(store, plans, device="cpu")
        probe = t_window(store, plans, device="cpu")
        dev = probe.info["device"] if probe.info else None
        assert dev is not None and dev["dispatched"], dev
        assert dev["pairs"] > 0 and dev["bucket"] >= dev["pairs"]
        return grouped_apply(t_window, store, plans, base_index,
                             device="cpu")


def _four_ways(nodes, plans, existing=()):
    """Sequential truth (port), the port's host and device engines and
    the JAX device engine on twin worlds; all byte-compared."""
    tplans = convert.plans_from_reference(plans)
    _js, ts_seq = _worlds(nodes, existing)
    seq = sequential_apply(t_evaluate_plan, ts_seq, tplans, 5000)
    _js, ts_host = _worlds(nodes, existing)
    with t_policy.verify_override("host"):
        host = grouped_apply(t_window, ts_host, tplans, 5000, device="cpu")
    assert host.info is None or host.info["device"] is None
    _js, ts_dev = _worlds(nodes, existing)
    dev = t_device_grouped_apply(ts_dev, tplans, 5000)
    js_dev, _ts = _worlds(nodes, existing)
    jdev = j_device_grouped_apply(js_dev, plans, 5000)
    keys = [result_key(r) for r in seq]
    assert [result_key(o.result) for o in host] == keys
    assert [result_key(o.result) for o in dev] == keys
    assert [result_key(o.result) for o in jdev] == keys
    assert [o.fallback for o in dev] == [o.fallback for o in host] == \
        [o.fallback for o in jdev]
    image = store_image(ts_seq)
    assert store_image(ts_host) == image
    assert store_image(ts_dev) == image
    assert store_image(js_dev) == image
    return dev


@pytest.mark.parametrize("cpu", [600, 800])
def test_recorded_storm_host_vs_device(cpu):
    """The recorded contended storm replayed through every engine, with
    adversarial deadlines so components verify out of window order."""
    nodes, plans = _record_storm(cpu)
    _stamp_adversarial_deadlines(plans)
    out = _four_ways(nodes, plans)
    if cpu == 800:
        assert any(o.result.refresh_index for o in out), \
            "the recorded stream was meant to conflict"


@pytest.mark.parametrize("n_nodes", [8, 24, 64])
def test_seeded_random_windows_across_fleet_sizes(n_nodes):
    """Seeded random contended windows at three fleet sizes — evict-
    frees-capacity, port collisions, over-commit on hot nodes, clean
    placements (tests/test_plan_batch.py's recipe)."""
    rng = random.Random(171_000 + n_nodes)
    nodes = [mock.node(i) for i in range(n_nodes)]
    existing = [make_alloc(nodes[i], cpu=FREE_CPU - 500)
                for i in range(0, n_nodes, 3)]
    plans = []
    hot = nodes[:max(2, n_nodes // 4)]
    for _ in range(24):
        kind = rng.random()
        if kind < 0.25:
            victim = rng.choice(existing)
            evict = Plan(eval_id=generate_uuid())
            evict.append_update(victim, ALLOC_DESIRED_STATUS_STOP, "churn")
            plans.append(evict)
            node = next(n for n in nodes if n.id == victim.node_id)
            plans.append(place_plan(make_alloc(node, cpu=FREE_CPU)))
        elif kind < 0.45:
            node = rng.choice(hot)
            port = 8000 + rng.randrange(4)
            plans.append(place_plan(net_alloc(node, ports=[port])))
            plans.append(place_plan(net_alloc(node, ports=[port])))
        elif kind < 0.7:
            node = rng.choice(hot)
            plans.append(place_plan(make_alloc(
                node, cpu=rng.choice((500, 1500, FREE_CPU)))))
        else:
            node = rng.choice(nodes)
            plans.append(place_plan(make_alloc(
                node, cpu=rng.choice((100, 400, 900)))))
    _stamp_adversarial_deadlines(plans)
    out = _four_ways(nodes, plans, existing)
    assert any(o.result.refresh_index for o in out)


def test_device_info_and_fallback_taxonomy(monkeypatch):
    """host: no device record; no device given: ``no-mesh``; a cold
    lease: ``lease-miss``; a warm one: the dispatch with its counts.
    The JAX package's record carries the same keys."""
    from nomad_tpu_torch.models.fleet import UsageMirror

    nodes = [mock.node(i) for i in range(8)]
    plans = [place_plan(make_alloc(n, cpu=100)) for n in nodes]
    js, ts = _worlds(nodes)
    tplans = convert.plans_from_reference(plans)

    with t_policy.verify_override("host"):
        assert t_window(ts, tplans, device="cpu").info["device"] is None
    with t_policy.verify_override("device"):
        assert t_window(ts, tplans).info["device"] == \
            {"dispatched": False, "fallback": "no-mesh"}
    # A fresh fleet generation whose warm-up upload is not installed
    # (as when a commit replaces the mirror's usage during the upload):
    # the lease misses.
    _js, ts = _worlds(nodes)
    install = UsageMirror._install
    monkeypatch.setattr(UsageMirror, "_install", lambda *a, **kw: None)
    with t_policy.verify_override("device"):
        cold = t_window(ts, tplans, device="cpu").info["device"]
        assert cold == {"dispatched": False, "fallback": "lease-miss"}
        monkeypatch.setattr(UsageMirror, "_install", install)
        before = tmesh.window_verify.launches
        warm = t_window(ts, tplans, device="cpu").info["device"]
    assert warm["dispatched"] and warm["fallback"] is None
    assert warm["pairs"] == len(plans) and warm["bucket"] == 8
    assert warm["seq_ok"] is True and warm["wall"] >= 0
    # The CPU route runs the plain version: nothing crosses a bus and
    # no kernel launches.
    assert (warm["h2d"], warm["d2h"]) == (0, 0)
    assert tmesh.window_verify.launches == before

    with j_policy.verify_override("device"):
        j_window(js, plans)
        jwarm = j_window(js, plans).info["device"]
    assert jwarm["dispatched"]
    assert set(warm) == set(jwarm)
    assert {k: warm[k] for k in ("pairs", "bucket", "seq_ok")} == \
        {k: jwarm[k] for k in ("pairs", "bucket", "seq_ok")}


def test_the_first_window_of_a_fresh_fleet_holds_the_lease():
    """The mirror syncs to the window's snapshot before the warm-up,
    so a fresh fleet generation's first window (whose sync is a
    rebuild) keeps the copy it warmed and dispatches, with the same
    verdicts as the host engine."""
    nodes = [mock.node(i) for i in range(8)]
    plans = [place_plan(make_alloc(n, cpu=100)) for n in nodes]
    tplans = convert.plans_from_reference(plans)
    _js, ts = _worlds(nodes)
    with t_policy.verify_override("host"):
        host = t_window(ts, tplans, device="cpu")
    _js, ts = _worlds(nodes)
    with t_policy.verify_override("device"):
        first = t_window(ts, tplans, device="cpu")
    assert first.info["device"]["dispatched"], first.info["device"]
    assert [o.result.to_dict() for o in first] == \
        [o.result.to_dict() for o in host]


def test_a_dispatch_that_fails_raises():
    """No fallback around the launch: a K6 failure surfaces."""
    nodes = [mock.node(i) for i in range(4)]
    plans = [place_plan(make_alloc(n, cpu=100)) for n in nodes]
    _js, ts = _worlds(nodes)
    tplans = convert.plans_from_reference(plans)
    saved = tmesh.window_verify

    def broken(*a, **kw):
        raise RuntimeError("window_verify: CUDA error 700")
    with t_policy.verify_override("device"):
        t_window(ts, tplans, device="cpu")  # warms the lease
        tmesh.window_verify = broken
        try:
            with pytest.raises(RuntimeError, match="CUDA error"):
                t_window(ts, tplans, device="cpu")
        finally:
            tmesh.window_verify = saved


def test_the_engine_passes_the_windows_real_counts():
    """The device engine hands K6 the real (pairs, rows, entries) it
    built; they are the counts the padding gives, and hold the kernel's
    orders (``mesh.kernel_counts``)."""
    nodes, plans = _record_storm(800)
    _js, ts = _worlds(nodes)
    tplans = convert.plans_from_reference(plans)
    saved = tmesh.window_verify
    seen = []

    def recording(*a, counts=None, **kw):
        desc = {k: kw[k] for k, _t, _w in tmesh.DESCRIPTORS}
        seen.append((counts, tmesh.kernel_counts(desc),
                     tmesh.kernel_counts(desc, counts)))
        return saved(*a, counts=counts, **kw)
    with t_policy.verify_override("device"):
        t_window(ts, tplans, device="cpu")  # warms the lease
        tmesh.window_verify = recording
        try:
            out = t_window(ts, tplans, device="cpu")
        finally:
            tmesh.window_verify = saved
    assert out.info["device"]["dispatched"] and seen
    for given, derived, checked in seen:
        assert given[0] > 0 and given[1] > 0 and given[2] > 0
        assert given == checked
        assert derived[1:] == given[1:]
        # pairs past the derived count are plan 0's: they fold nothing
        assert derived[0] <= given[0]


def test_auto_stays_on_the_host_engine_on_one_device():
    nodes = [mock.node(i) for i in range(4)]
    plans = [place_plan(make_alloc(n, cpu=100)) for n in nodes]
    _js, ts = _worlds(nodes)
    tplans = convert.plans_from_reference(plans)
    with t_policy.verify_override("auto"):
        t_window(ts, tplans, device="cpu")
        assert t_window(ts, tplans, device="cpu").info["device"] is None


def test_j_and_t_evaluate_plan_agree_under_device_policy():
    """A single-plan window takes the per-plan verifier in both
    packages, whatever the policy."""
    nodes = [mock.node(i) for i in range(2)]
    plan = place_plan(make_alloc(nodes[0], cpu=2000),
                      make_alloc(nodes[1], cpu=FREE_CPU + 1))
    js, ts = _worlds(nodes)
    with t_policy.verify_override("device"):
        t_out = t_window(ts, convert.plans_from_reference([plan]),
                         device="cpu")
        j_res = j_evaluate_plan(js, plan)
    assert result_key(t_out[0].result) == result_key(j_res)


# -- verify_policy: resolution order and validation, twins ----------------


@pytest.fixture
def clean_policy():
    saved_env = os.environ.pop(t_policy.ENV_VAR, None)
    saved = (t_policy._configured, j_policy._configured)
    try:
        yield
    finally:
        t_policy._configured, j_policy._configured = saved
        if saved_env is None:
            os.environ.pop(t_policy.ENV_VAR, None)
        else:
            os.environ[t_policy.ENV_VAR] = saved_env


def test_policy_resolution_order_like_jax(clean_policy):
    assert t_policy.ENV_VAR == j_policy.ENV_VAR == "NOMAD_TPU_VERIFY"
    assert t_policy.VALID_VERIFY == j_policy.VALID_VERIFY
    for pol in (t_policy, j_policy):
        assert pol.verify_policy() == "auto"
        pol.set_verify_policy(" Host ")
        assert pol.verify_policy() == "host"       # configured beats auto
        with pol.verify_override("device"):
            assert pol.verify_policy() == "device"  # env beats configured
            with pol.verify_override("host"):
                assert pol.verify_policy() == "host"
            assert pol.verify_policy() == "device"  # nesting restores
        assert pol.verify_policy() == "host"
        os.environ[pol.ENV_VAR] = "DEVICE"
        assert pol.verify_policy() == "device"
        del os.environ[pol.ENV_VAR]
        pol.set_verify_policy("auto")


@pytest.mark.parametrize("bad", ["gpu", "", "hostt"])
def test_policy_validation_errors_like_jax(clean_policy, bad):
    for pol in (t_policy, j_policy):
        with pytest.raises(pol.VerifyPolicyError):
            pol.set_verify_policy(bad)
        with pytest.raises(pol.VerifyPolicyError):
            pol.verify_override(bad)
        with pytest.raises(ValueError):
            pol.validate_verify(bad, "test")
        assert pol._configured == "auto"
        if bad:
            os.environ[pol.ENV_VAR] = bad
            try:
                with pytest.raises(pol.VerifyPolicyError,
                                   match="NOMAD_TPU_VERIFY"):
                    pol.verify_policy()
            finally:
                del os.environ[pol.ENV_VAR]
    assert t_policy.validate_verify(" Device ") == \
        j_policy.validate_verify(" Device ") == "device"
