"""Runtime telemetry of the port (``paddle_tpu/observability``
counterpart).  Relative imports only; no module here imports torch at
its top level.

Stdlib copies of the JAX package's modules:
  * `metrics`, `trace`, `flight` — counters / gauges / histograms, the
    span timeline, the decision ring;
  * `tenant_ledger`, `timeseries` — per-tenant metering, sampled series
    and request timelines;
  * `lifecycle` — a replica's spawn-to-first-token phases and the
    per-program compile sub-ledger;
  * `request_trace`, `slo`, `export` — request identity across hops,
    the SLO ledger, the telemetry exporter of a fleet's replicas.

  * `step_stats` — `StepTimer`: step records, the JSONL stream, the
    record hooks the watchdog beats from; its device peak memory is the
    CUDA allocator's (`torch`, imported when a record reads it).

The port's own:
  * `capture_cost` — the role of ``observability/xla_cost.py``: each
    CUDA graph's warm-up and capture wall time, under the label of the
    JAX program whose role the graph takes, in the lifecycle ledger, a
    span and a flight event.

`attach()` turns the stack on with a stable snapshot schema; the
serving fleet's replicas call it at start.  The schema declares only
the counters and gauges of paths the port has (ROADMAP C2 lists what
is left out).
"""
from __future__ import annotations

from . import (  # noqa: F401
    capture_cost, export, flight, goodput, lifecycle, metrics,
    request_trace, slo, step_stats, tenant_ledger, timeseries, trace,
)
from .step_stats import StepTimer  # noqa: F401

__all__ = ["metrics", "flight", "trace", "capture_cost", "request_trace",
           "slo", "export", "goodput", "tenant_ledger", "timeseries",
           "lifecycle", "step_stats", "StepTimer", "attach", "detach"]

# The snapshot-schema floor `attach()` guarantees: these counters exist
# (at 0) in every telemetry snapshot even when the path never fired in
# this process.  Every entry carries exactly the label set its live
# increment site uses, so the declared key is the key that counts.
_SCHEMA_COUNTERS = tuple(
    # fault injections and retry traffic at the fault points and
    # policies of the serving plane and the train step
    [("resilience.faults", {"point": p})
     for p in ("checkpoint.write", "dataloader.batch", "train.step",
               "serving.request", "store.op", "router.forward",
               "router.stream_read", "router.resume_verify",
               "replica.crash")]
    + [("resilience.retries", {"policy": p})
       for p in ("elastic.heartbeat", "serving", "dataloader")]
    + [("resilience.giveups", {"policy": p})
       for p in ("elastic.heartbeat", "serving", "dataloader")]
    + [("resilience.circuit_open", {"policy": p})
       for p in ("elastic.heartbeat", "serving")]
    # the train step's guard (skips by source, rollbacks of the guard
    # and of the checkpoint manager) and the watchdog
    + [("resilience.skipped_steps", {"source": s})
       for s in ("guard", "amp", "amp_floor")]
    + [("resilience.rollbacks", {}), ("resilience.watchdog_trips", {}),
       ("resilience.degraded_batches", {})]
    # admission sheds by reason, QoS sheds and preemptions by class,
    # preemption signals and serving drains
    + [("resilience.shed_requests", {"reason": r})
       for r in ("queue_full", "queue_timeout", "deadline", "draining",
                 "no_replicas", "deadline_exceeded")]
    + [("qos.shed", {"class": c}) for c in ("paid", "free", "batch")]
    + [("qos.preemptions", {"class": c})
       for c in ("paid", "free", "batch")]
    + [("preemption.signals", {"signal": s})
       for s in ("SIGTERM", "SIGINT")]
    + [("preemption.maintenance_events", {}),
       ("preemption.checkpoints", {}), ("preemption.drains", {}),
       ("preemption.callback_errors", {})]
    # request outcomes on both sides of a hop
    + [("serving.requests", {"status": s})
       for s in ("ok", "client_error", "shed", "timeout", "error")]
    + [("client.requests", {"status": s})
       for s in ("ok", "shed_retry", "error")]
    # the continuous-batching engine
    + [("engine.sequences", {"event": e})
       for e in ("submitted", "admitted", "completed", "cancelled",
                 "evicted")]
    + [("engine.tokens", {})]
    # speculative decoding: committed and discarded draft proposals
    + [("engine.spec_decode", {"result": r})
       for r in ("accepted", "rejected")]
    # the router: failovers, ejections, outcomes, mid-stream resumes
    + [("router.failovers", {}), ("router.ejections", {}),
       ("router.readmissions", {})]
    + [("router.requests", {"endpoint": ep, "status": s})
       for ep in ("predict", "generate")
       for s in ("ok", "client_error", "shed", "interrupted", "error")]
    + [("router.stream_resumes", {"outcome": o})
       for o in ("ok", "diverged", "exhausted")]
    + [("serving.resume_prefill", {"cache": c})
       for c in ("hit", "partial", "miss")]
    # prefix caching and the router's affinity picks
    + [("engine.prefix_cache", {"event": e})
       for e in ("hit", "miss", "evict")]
    + [("router.affinity", {"outcome": o})
       for o in ("affine", "least_loaded")]
    + [("autoscaler.decisions", {"action": a})
       for a in ("up", "down", "hold", "up_predictive")]
    + [("telemetry.anomalies", {"kind": k}) for k in ("ttft", "itl")]
    + [("tenant.requests", {"status": s})
       for s in ("ok", "shed", "client_error", "error")]
    + [("lifecycle.spawns", {}), ("lifecycle.double_stamps", {})]
)

# Gauges attach() zeroes so the admission and engine state is always
# present in a snapshot.  Entries are a bare name or a (name, labels)
# pair for labeled gauge series.
_SCHEMA_GAUGES = ("serving.inflight", "serving.queue_depth",
                  "serving.admission_limit",
                  "engine.active_sequences", "engine.waiting_sequences",
                  "engine.batch_occupancy", "engine.page_utilization",
                  "engine.spec_tokens",
                  "engine.prefix_cached_tokens",
                  "engine.prefix_cache_hit_rate",
                  "tenant.tracked", "tenant.other_tokens") \
    + tuple(("telemetry.timeseries_samples", {"sampler": s})
            for s in ("serving", "router")) \
    + tuple(("router.replicas", {"state": s})
            for s in ("up", "draining", "ejected", "down")) \
    + tuple(("router.capacity", {"endpoint": ep})
            for ep in ("predict", "generate")) \
    + tuple(("autoscaler.replicas", {"state": s})
            for s in ("target", "actual")) \
    + tuple(("engine.weight_precision", {"precision": p})
            for p in ("full", "bf16", "int8")) \
    + tuple(("paged.pool_precision", {"precision": p})
            for p in ("full", "int8")) \
    + tuple(("lifecycle.phase_ms", {"phase": p})
            for p in lifecycle.PHASES[1:]) \
    + (("lifecycle.compile_ms", {"program": "~total"}),
       "autoscaler.observed_spawn_ms") \
    + tuple(("slo.burn_rate", {"endpoint": ep, "class": c})
            for ep in ("predict", "generate")
            for c in ("paid", "free", "batch"))

# Histograms attach() pre-registers empty, so a fresh server's /metrics
# exposes the series before the first observation.
_SCHEMA_HISTS = (
    ("serving.itl_ms", {"endpoint": "generate"}),
    ("router.resume_gap_ms", {}),
)


def attach(crash_hook: bool = True):
    """Enable the telemetry stack: metrics registry on, schema counters
    pre-declared, flight recorder on (with its crash-dump excepthook),
    span tracer buffering.  Returns the metrics registry."""
    metrics.enable()
    for name, labels in _SCHEMA_COUNTERS:
        metrics.declare(name, **labels)
    for entry in _SCHEMA_GAUGES:
        if isinstance(entry, tuple):
            metrics.set_gauge(entry[0], 0, **entry[1])
        else:
            metrics.set_gauge(entry, 0)
    for name, labels in _SCHEMA_HISTS:
        metrics.declare_hist(name, **labels)
    flight.get_recorder().enabled = True
    trace.enable()
    if crash_hook:
        flight.install_crash_hook()
    return metrics.get_registry()


def detach():
    """Disable metric recording and span buffering (the flight recorder
    stays on).  Does not clear collected data."""
    metrics.disable()
    trace.disable()
