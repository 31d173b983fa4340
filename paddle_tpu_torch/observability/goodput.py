"""Training goodput accounting: productive step time vs lost time.

MLPerf-style pod training (PAPERS.md) treats "goodput" — the fraction
of wall-clock a job spends making forward progress — as the scaling
discipline's headline number: a 40% MFU step rate means little if 30%
of the wall went to recompiles, NaN rollbacks, and preemption drains.
This module derives that partition from signals the stack ALREADY
emits — StepTimer records (`step_stats`) and flight-ring events — so
any telemetry run gets a goodput report for free:

  * **productive** — steady-state step walls (records with
    `compile=False`);
  * **compile**    — records flagged `compile=True` (the trace+compile
    ledger);
  * **rollback**   — StepGuard skip/rollback events
    (`resilience.guard_skip` / `resilience.guard_rollback`): each
    skipped step burned ~one median steady step of device time and
    produced nothing;
  * **retry**      — `resilience.retry` flight events carry their
    backoff `delay`; summed, they are wall the job spent waiting to try
    again;
  * **preemption** — `resilience.drain_begin` → `resilience
    .drain_complete`/`drain_timeout` pairs and `preemption.tripped` →
    `preemption.checkpoint_saved` pairs, measured on the flight
    events' own wall timestamps;
  * **other**      — the remainder when the caller supplies the true
    wall (`wall_s=`): time nothing accounted for (input stalls, host
    gaps — the next thing to chase).

`partition()` is pure (synthetic streams test it directly);
`from_live()` reads the default flight recorder; `publish()` exports
`goodput.*` gauges; `metric_rows()` shapes bench-JSON rows for
`tools/perf_gate.py`.  `bench.py --telemetry` embeds the report and
emits the rows.

stdlib-only, package-relative imports guarded (file-loadable).
"""
from __future__ import annotations

import time

__all__ = ["partition", "from_live", "publish", "metric_rows",
           "SCHEMA_VERSION"]

SCHEMA_VERSION = "goodput/v1"

_ROLLBACK_KINDS = ("resilience.guard_skip", "resilience.guard_rollback")
_RETRY_KIND = "resilience.retry"
_DRAIN_PAIRS = (
    ("resilience.drain_begin",
     ("resilience.drain_complete", "resilience.drain_timeout")),
    ("preemption.tripped", ("preemption.checkpoint_saved",)),
)


def _metrics_module():
    try:
        from . import metrics  # type: ignore

        return metrics
    except ImportError:
        return None


def _median(vals):
    if not vals:
        return 0.0
    v = sorted(vals)
    n = len(v)
    return v[n // 2] if n % 2 else (v[n // 2 - 1] + v[n // 2]) / 2.0


def partition(step_records, flight_events=(), wall_s=None) -> dict:
    """Partition wall time.  `step_records` are step_stats dicts
    (StepTimer.records or parsed JSONL); `flight_events` are flight
    ring dicts (wall `t` + `kind`).  `wall_s`, when known, bounds the
    accounting and surfaces unattributed time as `other_s`."""
    recs = [r for r in step_records if isinstance(r, dict)]
    steady = [r for r in recs if not r.get("compile")]
    comp = [r for r in recs if r.get("compile")]

    def total_s(rows):
        return sum(float(r.get("wall_ms", 0.0))
                   * max(int(r.get("n_steps", 1)), 1) for r in rows) / 1e3

    productive_s = total_s(steady)
    compile_s = total_s(comp)
    median_step_s = _median(
        [float(r.get("wall_ms", 0.0)) for r in steady]) / 1e3

    rollback_events = 0
    retry_s = 0.0
    opens: dict = {}
    drain_s = 0.0
    for e in flight_events:
        if not isinstance(e, dict):
            continue
        kind = e.get("kind")
        if kind in _ROLLBACK_KINDS:
            rollback_events += 1
        elif kind == _RETRY_KIND:
            try:
                retry_s += max(0.0, float(e.get("delay", 0.0)))
            except (TypeError, ValueError):
                pass
        else:
            for begin, ends in _DRAIN_PAIRS:
                if kind == begin:
                    opens[begin] = float(e.get("t", 0.0))
                elif kind in ends and begin in opens:
                    t0 = opens.pop(begin)
                    try:
                        drain_s += max(0.0, float(e.get("t", t0)) - t0)
                    except (TypeError, ValueError):
                        pass
    rollback_s = rollback_events * median_step_s

    lost = {"compile_s": round(compile_s, 6),
            "rollback_s": round(rollback_s, 6),
            "retry_s": round(retry_s, 6),
            "preemption_s": round(drain_s, 6)}
    lost_s = sum(lost.values())
    accounted = productive_s + lost_s
    if wall_s is None:
        wall_s = accounted
        other_s = 0.0
    else:
        wall_s = float(wall_s)
        other_s = max(0.0, wall_s - accounted)
    lost["other_s"] = round(other_s, 6)
    lost_s += other_s
    out = {
        "schema": SCHEMA_VERSION,
        "wall_s": round(wall_s, 6),
        "productive_s": round(productive_s, 6),
        "lost_s": round(lost_s, 6),
        "lost": lost,
        "steps": sum(max(int(r.get("n_steps", 1)), 1) for r in steady),
        "compile_records": len(comp),
        "rollback_events": rollback_events,
        "productive_frac": round(productive_s / wall_s, 6)
        if wall_s > 0 else 0.0,
        "lost_frac": round(lost_s / wall_s, 6) if wall_s > 0 else 0.0,
    }
    return out


def from_live(timer, wall_s=None) -> dict:
    """Goodput from a live StepTimer + the default flight recorder —
    what bench.py calls at the end of a telemetry run."""
    try:
        from . import flight as _flight  # type: ignore

        events = _flight.events()
    except ImportError:
        events = ()
    with timer._lock:
        records = list(timer.records)
    return partition(records, events, wall_s=wall_s)


def publish(report, registry=None) -> None:
    """Export a goodput report as `goodput.*` gauges on the shared
    registry (fraction, seconds, and per-category lost seconds) — what
    the telemetry dumps and /metrics carry to the fleet rollup."""
    metrics = _metrics_module()
    if metrics is None:
        return
    reg = registry or metrics.get_registry()
    reg.set_gauge("goodput.productive_frac", report["productive_frac"])
    reg.set_gauge("goodput.productive_s", report["productive_s"])
    reg.set_gauge("goodput.wall_s", report["wall_s"])
    reg.set_gauge("goodput.lost_s", report["lost_s"])
    for cat, v in report.get("lost", {}).items():
        reg.set_gauge("goodput.lost_s", v, category=cat.rsplit("_s", 1)[0])


def metric_rows(report, degraded=False) -> list:
    """Bench-output rows for tools/perf_gate.py: goodput fraction gates
    higher-is-better, lost fraction lower-is-better.  Degraded (CPU
    proxy) runs mark the rows so the gate never judges a proxy
    partition against an on-chip floor."""
    rows = [
        {"metric": "goodput.productive_frac",
         "value": report["productive_frac"], "unit": "frac"},
        {"metric": "goodput.lost_frac", "value": report["lost_frac"],
         "unit": "frac", "lower_better": True},
    ]
    if degraded:
        for r in rows:
            r["degraded"] = True
    return rows


def now_wall_s(t0: float) -> float:
    """Convenience for callers bracketing a run with time.time()."""
    return max(0.0, time.time() - float(t0))
