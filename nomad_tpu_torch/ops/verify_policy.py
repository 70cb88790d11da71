"""Window-verify policy: which engine runs the group-commit base fit.

Counterpart of ``nomad_tpu/ops/verify_policy.py``, with the same
environment variable and the same precedence.  The window verify
(ops/plan_conflict.py evaluate_window) picks between two engines for
the cross-plan base-fit pass:

  host    dense numpy against the UsageMirror's host arrays — no
          dispatch latency, always available, and the exact reference
          every parity test replays;
  device  one launch of the window-verify kernel (K6,
          parallel/mesh.window_verify) per window against the usage
          copy and capacity/reserved already resident on the caller's
          device, or on a mesh the sharded form
          (parallel/mesh.window_verify_sharded: K7d on every shard,
          then K6) against the mesh-resident twins — the fleet tensors
          never cross to the host.

The JAX package takes its device engine only on a mesh of two or more
devices.  So in the port:

  ``host``    pins the reference engine;
  ``device``  first asks for a mesh (parallel/mesh.dispatch_mesh); with
              one, it warms the sharded twins OUTSIDE the mirror lock,
              takes the lease on them under it (models/fleet.py
              UsageMirror.window_lease(mesh)) and verifies through
              ``window_verify_sharded``, as the JAX package does.
              Without one (a single card) it warms the resident copies
              on the caller's device and launches K6 there: the CUDA
              kernel for a CUDA device, its plain version for ``cpu``
              (a difference on purpose: the JAX package stays on the
              host).  A caller that names no device and has no mesh
              gets the ``no-mesh`` fallback, and a cold lease the
              ``lease-miss`` one, as in the JAX package;
  ``auto``    (the default) stays on the host engine, as the JAX
              package does on one device.

Resolution order — first set wins:

  1. the ``NOMAD_TPU_VERIFY`` environment variable — checked per window
     so a run or an operator can flip it without a restart;
  2. the process policy set from server config
     (``set_verify_policy``);
  3. ``auto``.

The lever only selects the engine; verdicts, accepted alloc sets and
store fingerprints are byte-identical on both sides
(tests/test_torch_verify_device.py), and the exact-walk punts —
out-of-fleet nodes, odd port/topology shapes, conflict fallbacks — run
the unchanged host code under either policy.
"""
from __future__ import annotations

import os

VERIFY_AUTO = "auto"
VERIFY_HOST = "host"
VERIFY_DEVICE = "device"

VALID_VERIFY = (VERIFY_AUTO, VERIFY_HOST, VERIFY_DEVICE)

ENV_VAR = "NOMAD_TPU_VERIFY"

_configured: str = VERIFY_AUTO


class VerifyPolicyError(ValueError):
    pass


def _validate(value: str, source: str) -> str:
    v = (value or "").strip().lower()
    if v not in VALID_VERIFY:
        raise VerifyPolicyError(
            f"invalid verify engine {value!r} from {source}: want one "
            f"of {', '.join(VALID_VERIFY)}")
    return v


def validate_verify(value: str, source: str = "config") -> str:
    """Public validation hook for config loaders: normalized value or
    VerifyPolicyError."""
    return _validate(value, source)


def set_verify_policy(value: str) -> None:
    """Install the process-wide policy (config plumbing; env still
    wins).  Raises VerifyPolicyError on unknown values so a typo in a
    config file fails the boot instead of silently running ``auto``."""
    global _configured
    _configured = _validate(value, "config")


def verify_policy() -> str:
    """The effective policy right now: env var, then configured value,
    then ``auto``.  Read per window — cheap (one getenv) and it keeps
    the bench's scoped overrides race-free with respect to restarts."""
    env = os.environ.get(ENV_VAR)
    if env:
        return _validate(env, f"${ENV_VAR}")
    return _configured


class verify_override:
    """Scoped force of the verify engine (bench rows, parity tests).

    Sets the ENV override — the highest-precedence source — and restores
    the previous value on exit, so nesting and config interplay behave
    predictably.  Process-global like the env var itself; use from the
    thread that owns the run (the applier reads the policy once per
    window, on its own thread).
    """

    def __init__(self, value: str) -> None:
        self.value = _validate(value, "verify_override")
        self._saved: str | None = None

    def __enter__(self) -> "verify_override":
        self._saved = os.environ.get(ENV_VAR)
        os.environ[ENV_VAR] = self.value
        return self

    def __exit__(self, *exc) -> None:
        if self._saved is None:
            os.environ.pop(ENV_VAR, None)
        else:
            os.environ[ENV_VAR] = self._saved
