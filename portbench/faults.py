"""Plants under the timed path, for the control and the fault checks of
``correct``.  The benchmark's own runs plant nothing; ``run.py
--plant NAME`` and the tests do.

- ``verify_off``, the control: the applier commits every plan whole,
  with no fit check (``evaluate_window`` accepts each plan as it came),
  the step a later change could be tempted to take.  Lanes planned from
  one snapshot then land on the same nodes.
- ``stops_dropped``, the control of ``fleet1k-batch``, whose plans
  rarely conflict: the applier commits a plan's placements and leaves
  out its stops, the half of a churning deployment's commits a later
  change could be tempted to defer.
- ``spread``, the control of the packing (``packing_excess``): every
  placement the kernels choose goes to a node drawn at random from the
  fleet instead, the step a later change could be tempted to take,
  since lanes that spread stop landing on the same fullest nodes and
  retrying.  The applier's verify still checks the fit.
- ``state_unchanged``: the FSM's plan commits leave the store as it was.
- ``half_batch``: every second committed plan is left out of the store.
- ``answer_altered``: the placement kernels' answers are altered where
  they are produced: every placement of a lane goes to the lane's first
  chosen node.

Each takes the server and returns nothing; a plant stays for the life
of the process.
"""
from __future__ import annotations

import itertools

KERNELS = ("place_rounds", "place_rounds_batch", "place_sequence",
           "place_sequence_batch")


def verify_off(srv) -> None:
    from nomad_tpu_torch.ops import plan_conflict
    from nomad_tpu_torch.structs import PlanResult

    def accept_all(snap, plans, executor=None, partition=True, device=None):
        return plan_conflict.WindowVerdicts([
            plan_conflict.WindowOutcome(PlanResult(
                node_update=p.node_update,
                node_allocation=p.node_allocation,
                failed_allocs=p.failed_allocs), False)
            for p in plans], None)

    plan_conflict.evaluate_window = accept_all


def stops_dropped(srv) -> None:
    from nomad_tpu_torch.ops import plan_conflict

    verify = plan_conflict.evaluate_window

    def placements_only(snap, plans, **kw):
        outcomes = verify(snap, plans, **kw)
        for outcome in outcomes:
            outcome.result.node_update = {}
        return outcomes

    plan_conflict.evaluate_window = placements_only


def state_unchanged(srv) -> None:
    from nomad_tpu_torch.structs import codec

    for kind in (codec.ALLOC_UPDATE_REQUEST, codec.PLAN_BATCH_APPLY_REQUEST):
        srv.fsm._handlers[kind] = lambda index, payload: None


def half_batch(srv) -> None:
    from nomad_tpu_torch.structs import codec

    fsm = srv.fsm
    batch = fsm._handlers[codec.PLAN_BATCH_APPLY_REQUEST]
    single = fsm._handlers[codec.ALLOC_UPDATE_REQUEST]
    turn = itertools.count()

    def batch_half(index, payload):
        payload = dict(payload, plans=[p for p in payload["plans"]
                                       if next(turn) % 2 == 0])
        return batch(index, payload)

    def single_half(index, payload):
        return single(index, payload) if next(turn) % 2 == 0 else None

    fsm._handlers[codec.PLAN_BATCH_APPLY_REQUEST] = batch_half
    fsm._handlers[codec.ALLOC_UPDATE_REQUEST] = single_half


def answer_altered(srv) -> None:
    from nomad_tpu_torch.ops import binpack

    def altered(fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            chosen = out[0]
            flat = chosen.reshape(chosen.shape[0], -1) if chosen.dim() > 1 \
                else chosen.reshape(1, -1)
            flat.copy_(flat[:, :1].clone().expand_as(flat))
            return out
        call.launches = 0
        return call

    for name in KERNELS:
        setattr(binpack, name, altered(getattr(binpack, name)))


def spread(srv) -> None:
    import torch

    from nomad_tpu_torch.ops import binpack

    draws = itertools.count(1)

    def spread_out(fn):
        def call(capacity, *a, **kw):
            out = fn(capacity, *a, **kw)
            chosen = out[0]
            # Padded rows of the node axis have no capacity and trail.
            real = int((capacity[:, 0] > 0).sum())
            gen = torch.Generator(device=chosen.device)
            gen.manual_seed(next(draws))
            drawn = torch.randint(0, real, chosen.shape, generator=gen,
                                  device=chosen.device, dtype=chosen.dtype)
            chosen.copy_(torch.where(chosen >= 0, drawn, chosen))
            return out
        call.launches = 0
        return call

    for name in KERNELS:
        setattr(binpack, name, spread_out(getattr(binpack, name)))


PLANTS = {"verify_off": verify_off, "stops_dropped": stops_dropped,
          "spread": spread,
          "state_unchanged": state_unchanged,
          "half_batch": half_batch, "answer_altered": answer_altered}
