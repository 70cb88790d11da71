"""Executor policy: which engine runs the placement walks.

Counterpart of ``nomad_tpu/scheduler/executor.py``.  The torch-binpack
scheduler picks between two executors per dispatch
(scheduler/torch_binpack.py ``choose_host_executor``):

  host    numpy twins of K2/K3 (ops/binpack_host.py): no launch, no
          transfer; wins while the walk is smaller than what a launch,
          its uploads and its result fetch cost on the card;
  device  the hand-written kernels (ops/binpack.py) on the scheduler's
          device: wins for larger walks, fused storms and pipelined
          streams.

``auto`` (the default) applies the cost model, whose two constants
(``TorchBinPackScheduler.HOST_ALWAYS_COST`` / ``HOST_SINGLE_SHOT_COST``)
were measured on an H100 (PERF.md, the executor crossover).  ``host``
/ ``device`` force one side: the chip checks and the parity tests need
a forcible device path, and an operator diagnosing a slow card wants
the same lever without editing code.

``auto`` choosing the host is a COST decision, never a fallback: it is
made before the dispatch from the walk's size alone, recorded in the
scheduler's ``dispatched_host`` and in the pipelined runner's
``host_dispatches``, and never taken in reaction to a launch that
failed.  A kernel that fails to build raises, and on a CUDA device so
does a launch or a result fetch that fails at run time (recorded with
the circuit breaker, scheduler/breaker.py).  Only a pipelined runner on
the CPU, whose "device" walks are the kernels' plain versions, re-runs
a failed eval on the host twin, logged at warning and counted
(``breaker_reruns``).

Resolution order (first set wins):

  1. the ``NOMAD_TPU_EXECUTOR`` environment variable (the JAX
     package's name: one process running both packages reads one
     lever), checked per dispatch;
  2. the process policy set with ``set_executor_policy``;
  3. ``auto``.

The policy only selects the executor; plans are identical on both
sides (tests/test_torch_executor.py).
"""
from __future__ import annotations

import os

EXECUTOR_AUTO = "auto"
EXECUTOR_HOST = "host"
EXECUTOR_DEVICE = "device"

VALID_EXECUTORS = (EXECUTOR_AUTO, EXECUTOR_HOST, EXECUTOR_DEVICE)

ENV_VAR = "NOMAD_TPU_EXECUTOR"

_configured: str = EXECUTOR_AUTO


class ExecutorPolicyError(ValueError):
    pass


def _validate(value: str, source: str) -> str:
    v = (value or "").strip().lower()
    if v not in VALID_EXECUTORS:
        raise ExecutorPolicyError(
            f"invalid executor {value!r} from {source}: want one of "
            f"{', '.join(VALID_EXECUTORS)}")
    return v


def validate_executor(value: str, source: str = "config") -> str:
    """Validation hook for config loaders: the normalized value or
    ExecutorPolicyError."""
    return _validate(value, source)


def set_executor_policy(value: str) -> None:
    """Install the process-wide policy (the environment still wins).
    Raises ExecutorPolicyError on unknown values, so a typo fails the
    caller instead of silently running ``auto``."""
    global _configured
    _configured = _validate(value, "config")


def executor_policy() -> str:
    """The effective policy now: the environment variable, then the
    configured value, then ``auto``.  Read per dispatch (one getenv)."""
    env = os.environ.get(ENV_VAR)
    if env:
        return _validate(env, f"${ENV_VAR}")
    return _configured


class executor_override:
    """Scoped force of the executor (chip checks, parity tests).

    Sets the environment variable, the highest-precedence source, and
    restores its previous value on exit, so nesting behaves.  Process
    wide like the variable itself; use it from the thread that owns the
    run (the pipeline's stage threads read the policy only at dispatch
    time, on the submitting thread).
    """

    def __init__(self, value: str) -> None:
        self.value = _validate(value, "executor_override")
        self._saved: str | None = None

    def __enter__(self) -> "executor_override":
        self._saved = os.environ.get(ENV_VAR)
        os.environ[ENV_VAR] = self.value
        return self

    def __exit__(self, *exc) -> None:
        if self._saved is None:
            os.environ.pop(ENV_VAR, None)
        else:
            os.environ[ENV_VAR] = self._saved
