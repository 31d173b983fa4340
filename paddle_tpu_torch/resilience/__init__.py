"""Fault tolerance of the port (``paddle_tpu/resilience`` counterpart):
stdlib copies of the JAX package's modules, relative imports only, and
the device half of the train step's guard (torch, imported where it
runs).

  * `faults`     — seeded fault injection with named fault points
    (train.step, checkpoint.write, serving.request, store.op,
    router.forward, replica.crash, ...); every injection is a flight
    event and a `resilience.faults{point}` counter.
  * `retry`      — `RetryPolicy` (exponential backoff with seeded
    jitter, deadlines) and `CircuitBreaker`, around serving requests,
    router forwards and the elastic heartbeats.
  * `guards`     — the in-step NaN/Inf guard: a finiteness reduction
    and a select on the device inside the train step (torch), and the
    host-side warn → skip → rollback ladder `StepGuard` (a copy), which
    rolls back through the checkpoint manager.
  * `watchdog`   — heartbeat hang watchdog fed by `StepTimer`; dumps
    the flight ring and the span trace on a stall.
  * `overload`   — admission control: bounded wait queue, concurrency
    limit with an AIMD ceiling fed by observed latency, deadline-aware
    shedding, graceful drain.
  * `preemption` — SIGTERM/SIGINT and maintenance-event guard that turns
    a preemption into a cooperative drain, or in training into a
    checkpoint at the step's next safe point.
"""
from __future__ import annotations

from . import faults, guards, overload, preemption, retry, watchdog  # noqa: F401
from .faults import InjectedFault, inject  # noqa: F401
from .guards import StepGuard  # noqa: F401
from .overload import AdmissionController, ShedError  # noqa: F401
from .preemption import PreemptionGuard, TrainingPreempted  # noqa: F401
from .retry import (  # noqa: F401
    CircuitBreaker, CircuitOpenError, DeadlineExceeded, RetryPolicy,
)
from .watchdog import Watchdog, WatchdogStall  # noqa: F401

__all__ = [
    "faults", "retry", "guards", "watchdog", "overload", "preemption",
    "InjectedFault", "inject", "StepGuard", "RetryPolicy",
    "CircuitBreaker", "CircuitOpenError", "DeadlineExceeded",
    "Watchdog", "WatchdogStall", "AdmissionController", "ShedError",
    "PreemptionGuard", "TrainingPreempted",
]
