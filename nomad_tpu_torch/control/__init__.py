"""Feedback control plane: the observability plane drives the knobs.

``obs/`` holds the sensors (per-eval tracing, the unified
MetricsRegistry, the flight recorder) and the server the actuators
(overload state machine, bounded queues, paced expiry) — this package
connects them.
A :class:`~nomad_tpu_torch.control.controller.Controller` is a deterministic,
seeded tick loop (one joinable thread per server/agent) that reads the
gauges the registry already publishes and adjusts the live tunables
through typed :class:`~nomad_tpu_torch.control.controller.Actuator` handles
with hard min/max rails, so every hand-tuned constant that happened to
fit the bench machine becomes a set-point the live system finds itself.

``wiring.py`` holds the standard knob sets: AIMD on the scheduler
pipeline's ``depth`` and the applier's ``max_inflight_commits``,
gradient-step on the applier's ``max_window`` and window-gather
horizon, and slow-moving adjustment of ``broker_depth_limit`` and the
overload brownout/overload ratios (hysteresis preserved — the
controller moves the *thresholds*, never the enter/exit asymmetry).

Explicitly OUT of the controller's reach, by construction: admission
correctness invariants.  ``force=True`` committed-state enqueues (FSM
apply, leadership restore) and the ``Node.Heartbeat`` liveness lane
bypass admission *before* any threshold the controller can move, so no
tuning decision can diverge broker from state or shed the heartbeat
that prevents the TTL-expiry spiral.

Every decision is first-class observability: a ``control.tick`` span
per evaluation with per-knob ``control.adjust`` child spans (old/new
value, driving gauge, direction), a ``controller`` stats()/registry
provider (per-knob position, reversals, rail hits, ticks) mirrored
into ``/v1/agent/metrics``, and the flight recorder dumping on every
controller reversal and every rail saturation — a misbehaving loop
indicts itself.

Counterpart of ``nomad_tpu/control/``: the same knobs, rails, laws and
drivers, so one gauge stream moves a port controller and a JAX one
alike.
"""
from .controller import AIMD, Actuator, Controller, GradientStep
from .wiring import (
    applier_controller,
    runner_controller,
    server_controller,
    wire_applier,
    wire_overload,
    wire_runner,
)

__all__ = [
    "AIMD",
    "Actuator",
    "Controller",
    "GradientStep",
    "applier_controller",
    "runner_controller",
    "server_controller",
    "wire_applier",
    "wire_overload",
    "wire_runner",
]
