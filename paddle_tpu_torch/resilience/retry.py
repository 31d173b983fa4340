"""Reusable retry policy: exponential backoff + seeded jitter, deadlines,
and a circuit breaker.

One policy object serves every transient-failure surface in the stack —
eager collectives (`distributed/collective.py`), the elastic manager's
TCPStore heartbeat traffic, and serving request handling — so retry
behavior is tuned (and observed: `resilience.retries{policy=...}` /
`resilience.giveups{policy=...}` counters + flight events) in one place.

Determinism: jitter draws come from a `random.Random` seeded per policy,
and both the sleep and the clock are injectable — tests run the full
backoff schedule without wall-clock waits.
"""
from __future__ import annotations

import os
import threading
import time

__all__ = ["RetryPolicy", "CircuitBreaker", "CircuitOpenError",
           "DeadlineExceeded", "retrying", "env_policy"]


class CircuitOpenError(RuntimeError):
    """Raised without attempting the call while the breaker is open."""


class DeadlineExceeded(TimeoutError):
    """The policy's total deadline elapsed before a retry could run.
    `__cause__` carries the last real failure."""


class CircuitBreaker:
    """Classic closed → open → half-open breaker.

    After `failure_threshold` CONSECUTIVE failures the breaker opens:
    calls fail fast with `CircuitOpenError` (no load on the failing
    dependency) until `reset_timeout` passes, then exactly one trial
    call is admitted (half-open); its success closes the breaker, its
    failure re-opens it for another window.
    """

    def __init__(self, failure_threshold=5, reset_timeout=30.0,
                 clock=time.monotonic, name="circuit"):
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout = float(reset_timeout)
        self.clock = clock
        self.name = name
        self._lock = threading.Lock()
        self._failures = 0
        self._opened_at = None
        self._half_open_inflight = False

    @property
    def state(self):
        with self._lock:
            if self._opened_at is None:
                return "closed"
            if self.clock() - self._opened_at >= self.reset_timeout:
                return "half_open"
            return "open"

    def allow(self):
        """Admit or refuse one call attempt (refusal raises)."""
        with self._lock:
            if self._opened_at is None:
                return
            if self.clock() - self._opened_at < self.reset_timeout:
                raise CircuitOpenError(
                    f"circuit {self.name!r} open "
                    f"({self._failures} consecutive failures)")
            # half-open: admit a single trial; concurrent callers keep
            # failing fast until the trial resolves
            if self._half_open_inflight:
                raise CircuitOpenError(
                    f"circuit {self.name!r} half-open trial in flight")
            self._half_open_inflight = True

    def record_success(self):
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._half_open_inflight = False

    def record_failure(self):
        """Returns True when this failure OPENED the breaker (edge)."""
        with self._lock:
            self._failures += 1
            self._half_open_inflight = False
            was_open = self._opened_at is not None
            if self._failures >= self.failure_threshold:
                self._opened_at = self.clock()
                return not was_open
            return False


class RetryPolicy:
    """Call wrapper with bounded exponential backoff.

    delay(attempt k) = min(max_delay, base_delay * multiplier**(k-1))
                       * (1 + jitter * U[-1, 1))           (seeded)

    `deadline` bounds the TOTAL wall time across attempts: when the next
    backoff would land past it, the policy raises `DeadlineExceeded`
    from the last real error instead of sleeping.  `retry_on` /
    `give_up_on` are exception-class filters (give_up wins).
    """

    def __init__(self, name, max_attempts=3, base_delay=0.05, max_delay=2.0,
                 multiplier=2.0, jitter=0.25, deadline=None,
                 retry_on=(Exception,), give_up_on=(), seed=None,
                 sleep=time.sleep, clock=time.monotonic,
                 circuit_breaker=None):
        import random

        self.name = str(name)
        self.max_attempts = max(1, int(max_attempts))
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.deadline = None if deadline is None else float(deadline)
        self.retry_on = tuple(retry_on)
        self.give_up_on = tuple(give_up_on)
        self.sleep = sleep
        self.clock = clock
        self.breaker = circuit_breaker
        base = int(seed if seed is not None
                   else os.environ.get("PADDLE_TPU_RETRY_SEED", "0"))
        import zlib

        self._rng = random.Random(
            (base * 1000003) ^ zlib.crc32(self.name.encode()))
        self._rng_lock = threading.Lock()

    def backoff(self, attempt):
        """Deterministic-given-seed delay before retry number `attempt`
        (1-based: the delay after the attempt-th failure)."""
        d = min(self.max_delay,
                self.base_delay * self.multiplier ** (attempt - 1))
        if self.jitter:
            with self._rng_lock:
                d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, d)

    def call(self, fn, *args, **kwargs):
        """Run `fn` under this policy.  Non-retryable errors and the
        final failure propagate unchanged (CI stack traces point at the
        real fault, not the retry machinery)."""
        start = self.clock()
        last = None
        for attempt in range(1, self.max_attempts + 1):
            if self.breaker is not None:
                self.breaker.allow()  # raises CircuitOpenError fast
            try:
                out = fn(*args, **kwargs)
            except self.give_up_on:
                if self.breaker is not None:
                    self.breaker.record_failure()
                raise
            except self.retry_on as e:
                last = e
                opened = (self.breaker.record_failure()
                          if self.breaker is not None else False)
                if opened:
                    self._count("resilience.circuit_open")
                    self._note("resilience.circuit_opened", attempt, e)
                if attempt >= self.max_attempts:
                    break
                delay = self.backoff(attempt)
                if self.deadline is not None and \
                        self.clock() - start + delay > self.deadline:
                    self._note("resilience.retry_deadline", attempt, e)
                    raise DeadlineExceeded(
                        f"policy {self.name!r}: deadline "
                        f"{self.deadline}s exhausted after {attempt} "
                        f"attempts") from e
                self._note("resilience.retry", attempt, e, delay=delay)
                self._count("resilience.retries")
                self.sleep(delay)
            else:
                if self.breaker is not None:
                    self.breaker.record_success()
                return out
        self._count("resilience.giveups")
        self._note("resilience.retry_giveup", self.max_attempts, last)
        raise last

    def __call__(self, fn):
        """Use a policy instance as a decorator."""
        import functools

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            return self.call(fn, *a, **kw)

        wrapped.retry_policy = self
        return wrapped

    # --- observability (never lets telemetry break the retried path) ---
    def _count(self, counter):
        try:
            from ..observability import metrics as _metrics

            _metrics.inc(counter, policy=self.name)
        except Exception:  # pt-lint: ok[PT005]
            pass           # (observability fan-out guard: telemetry
            # failing must never break the retried path, and there is
            # no channel left to report the telemetry failure on)

    def _note(self, kind, attempt, err, **extra):
        try:
            from ..observability import flight as _flight

            _flight.record(kind, policy=self.name, attempt=attempt,
                           error=f"{type(err).__name__}: {err}", **extra)
        except Exception:  # pt-lint: ok[PT005] (fan-out guard, as above)
            pass


def retrying(name, **policy_kwargs):
    """Decorator factory: `@retrying("io.read", max_attempts=5)`."""
    return RetryPolicy(name, **policy_kwargs)


_env_policies: dict = {}
_env_policies_lock = threading.Lock()


def env_policy(name, env_var, default_attempts, **kwargs):
    """Process-wide RetryPolicy singleton with `max_attempts` read from
    `env_var` — the one factory behind the wired-in policies
    (collective dispatch, dataloader fetch, jit compile), so tuning
    lives here instead of three copy-pasted lazy-global blocks."""
    # double-checked locking: lock-free first probe is a GIL-atomic
    # dict get; a stale miss just re-checks under the lock
    pol = _env_policies.get(name)  # pt-lint: ok[PT102]
    if pol is None:
        with _env_policies_lock:
            pol = _env_policies.get(name)
            if pol is None:
                pol = RetryPolicy(
                    name,
                    max_attempts=int(os.environ.get(
                        env_var, str(default_attempts))),
                    **kwargs)
                _env_policies[name] = pol
    return pol
