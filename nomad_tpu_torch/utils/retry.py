"""Unified retry/backoff policy.

Every retry loop in the system routes through here instead of hand-rolled
``time.sleep`` loops (which the seed had in four flavors: fixed-interval
forever, linear no-cap, fixed base with no jitter, and
swallow-the-final-failure).  One policy object gives each call path:

  - jittered exponential backoff (full jitter by default — N clients
    retrying the same dead leader must not stampede in lockstep);
  - a per-attempt timeout hint for the transport call;
  - an overall deadline, checked BEFORE sleeping (never burn the last
    second of budget asleep);
  - retryable-exception classification (transport errors retry;
    application errors surface immediately);
  - a shutdown event so retry sleeps never outlive their owner;
  - a metrics hook (`nomad.retry.<name>.retries` / `.gaveup`).

Two shapes:

``Backoff``
    the bare delay sequence, for open-ended supervision loops that
    never "give up" (worker dequeue, peer replication, retry-join) —
    ``next()`` grows the delay, ``reset()`` snaps back after success.

``RetryPolicy``
    a bounded call wrapper for request/response paths —
    ``policy.call(fn)`` retries ``fn`` until success, a non-retryable
    error, ``max_attempts``, the ``deadline``, or ``stop``.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional

from .metrics import metrics

# Transport-shaped failures: the request may not have been processed and
# trying again is meaningful.  TimeoutError covers both socket timeouts
# and blocking-wait expiries; OSError covers refused/reset/unreachable.
# (ConnectionError is an OSError subclass — listed for readability.)
DEFAULT_RETRYABLE = (ConnectionError, TimeoutError, OSError)

# Admission-control NACKs (server/overload.ErrOverloaded) carry this
# marker.  In-proc the exception is an OSError subclass (already
# retryable above); over the wire it arrives as an RPCError whose
# STRING carries the marker — ``is_overloaded`` classifies both, and
# ``transport_or_overload`` is the retryable predicate for clients that
# should ride a shedding server with jittered backoff.
OVERLOADED_MARKER = "overloaded:"


def is_overloaded(exc: BaseException) -> bool:
    """True when ``exc`` is (or wraps, via the RPC error string) an
    admission-control shed — retry later, with backoff."""
    return OVERLOADED_MARKER in str(exc)[:128]


def transport_or_overload(exc: BaseException) -> bool:
    """Retryable predicate: transport-shaped failures OR an explicit
    server shed (the ``ErrOverloaded`` NACK, in-proc or over the
    wire)."""
    return isinstance(exc, DEFAULT_RETRYABLE) or is_overloaded(exc)


class RetryAborted(RuntimeError):
    """The stop event fired while waiting to retry (owner shutdown)."""


class Backoff:
    """Jittered exponential delay sequence.

    Full jitter by default (``jitter=1.0`` draws uniformly from
    (0, delay]); ``jitter=0`` is deterministic.  Not thread-safe — one
    Backoff per supervising loop.
    """

    def __init__(self, base: float = 0.25, max_delay: float = 30.0,
                 multiplier: float = 2.0, jitter: float = 1.0,
                 rng: Optional[random.Random] = None) -> None:
        if base <= 0:
            raise ValueError(f"backoff base must be > 0, got {base!r}")
        self.base = base
        self.max_delay = max(base, max_delay)
        self.multiplier = multiplier
        self.jitter = min(max(jitter, 0.0), 1.0)
        self._rng = rng or random
        self._failures = 0

    @property
    def failures(self) -> int:
        return self._failures

    def next(self) -> float:
        """The delay to wait after one more failure (grows the state)."""
        exp = min(self._failures, 63)  # cap the exponent, not just the delay
        self._failures += 1
        delay = min(self.max_delay, self.base * (self.multiplier ** exp))
        if self.jitter:
            # Full-jitter family: uniform over the top `jitter` fraction,
            # never below (1-jitter)*delay so jitter=1 keeps a (0, d] draw
            # and jitter=0.25 keeps delays within 25% of nominal.
            delay = delay * (1.0 - self.jitter * self._rng.random())
        return max(delay, 1e-6)

    def reset(self) -> None:
        self._failures = 0

    def sleep(self, stop: Optional[threading.Event] = None) -> bool:
        """Wait ``next()`` seconds; returns True if ``stop`` fired
        first (callers exit their loop on True)."""
        delay = self.next()
        if stop is not None:
            return stop.wait(delay)
        time.sleep(delay)
        return False


class RetryPolicy:
    """Bounded retry wrapper for request/response calls.

    Stateless across calls (each ``call`` builds its own Backoff), so
    one module-level policy instance safely serves many threads.
    ``retryable`` is an exception tuple or a predicate; ``name`` keys
    the metrics counters.
    """

    def __init__(self, base: float = 0.25, max_delay: float = 30.0,
                 multiplier: float = 2.0, jitter: float = 1.0,
                 max_attempts: Optional[int] = None,
                 deadline: Optional[float] = None,
                 attempt_timeout: Optional[float] = None,
                 retryable=DEFAULT_RETRYABLE,
                 name: str = "") -> None:
        self.base = base
        self.max_delay = max_delay
        self.multiplier = multiplier
        self.jitter = jitter
        self.max_attempts = max_attempts
        self.deadline = deadline
        self.attempt_timeout = attempt_timeout
        self.retryable = retryable
        self.name = name or "anon"

    def is_retryable(self, exc: BaseException) -> bool:
        if callable(self.retryable) and not isinstance(self.retryable,
                                                       type):
            return bool(self.retryable(exc))
        return isinstance(exc, self.retryable)

    def per_attempt_timeout(self,
                            start: Optional[float] = None) -> Optional[float]:
        """The timeout one attempt should pass to its transport call:
        ``attempt_timeout`` clipped to the deadline's remaining budget
        (pass the ``time.monotonic()`` taken at loop entry)."""
        timeout = self.attempt_timeout
        if self.deadline is not None and start is not None:
            remaining = max(self.deadline - (time.monotonic() - start),
                            0.001)
            timeout = remaining if timeout is None \
                else min(timeout, remaining)
        return timeout

    def call(self, fn: Callable, *,
             stop: Optional[threading.Event] = None,
             on_retry: Optional[Callable] = None,
             rng: Optional[random.Random] = None):
        """Invoke ``fn()`` with retries.  On exhaustion (attempts or
        deadline) the LAST underlying exception is re-raised — callers
        keep their exception types; nothing is swallowed.  ``on_retry``
        (attempt#, exc, upcoming delay) fires before each sleep.

        When the policy carries an ``attempt_timeout`` or ``deadline``,
        ``fn`` is invoked as ``fn(timeout)`` with this attempt's budget
        (attempt_timeout clipped to the deadline's remainder) for the
        caller to hand to its transport call — the policy cannot
        interrupt an arbitrary callable itself, so a caller that
        ignores the argument gets between-attempt enforcement only."""
        backoff = Backoff(self.base, self.max_delay, self.multiplier,
                          self.jitter, rng=rng)
        start = time.monotonic()
        bounded = self.attempt_timeout is not None or \
            self.deadline is not None
        attempt = 0
        while True:
            attempt += 1
            try:
                if bounded:
                    return fn(self.per_attempt_timeout(start))
                return fn()
            except BaseException as e:
                if not self.is_retryable(e):
                    raise
                if self.max_attempts is not None and \
                        attempt >= self.max_attempts:
                    metrics.incr_counter(
                        f"nomad.retry.{self.name}.gaveup")
                    raise
                delay = backoff.next()
                if self.deadline is not None and \
                        time.monotonic() - start + delay > self.deadline:
                    metrics.incr_counter(
                        f"nomad.retry.{self.name}.gaveup")
                    raise
                metrics.incr_counter(f"nomad.retry.{self.name}.retries")
                if on_retry is not None:
                    on_retry(attempt, e, delay)
                if stop is not None:
                    if stop.wait(delay):
                        raise RetryAborted(
                            f"retry of {self.name} aborted: owner "
                            "shutting down") from e
                else:
                    time.sleep(delay)
