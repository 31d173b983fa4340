"""Serving-side fault tolerance of the port (``paddle_tpu/resilience``
counterpart): stdlib copies of the JAX package's modules, relative
imports only.

  * `faults`     — seeded fault injection with named fault points
    (serving.request, store.op, router.forward, replica.crash, ...);
    every injection is a flight event and a `resilience.faults{point}`
    counter.
  * `retry`      — `RetryPolicy` (exponential backoff with seeded
    jitter, deadlines) and `CircuitBreaker`, around serving requests,
    router forwards and the elastic heartbeats.
  * `overload`   — admission control: bounded wait queue, concurrency
    limit with an AIMD ceiling fed by observed latency, deadline-aware
    shedding, graceful drain.
  * `preemption` — SIGTERM/SIGINT and maintenance-event guard that turns
    a preemption into a cooperative drain.

The training side of the JAX package (`guards`, the in-step NaN/Inf
guard, and `watchdog`, fed by `step_stats`) is not ported yet (ROADMAP
Queue A6).
"""
from __future__ import annotations

from . import faults, overload, preemption, retry  # noqa: F401
from .faults import InjectedFault, inject  # noqa: F401
from .overload import AdmissionController, ShedError  # noqa: F401
from .preemption import PreemptionGuard, TrainingPreempted  # noqa: F401
from .retry import (  # noqa: F401
    CircuitBreaker, CircuitOpenError, DeadlineExceeded, RetryPolicy,
)

__all__ = [
    "faults", "retry", "overload", "preemption",
    "InjectedFault", "inject", "RetryPolicy",
    "CircuitBreaker", "CircuitOpenError", "DeadlineExceeded",
    "AdmissionController", "ShedError",
    "PreemptionGuard", "TrainingPreempted",
]
