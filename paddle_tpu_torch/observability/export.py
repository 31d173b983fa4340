"""Per-process telemetry export: periodic dumps a fleet can aggregate.

Everything the in-process stack collects — metrics snapshot (bucketed
histograms included), new span-tracer events, new flight-ring events,
an optional SLO report — lands as self-describing JSONL lines keyed by
host/pid/rank in a shared directory.  `tools/telemetry_agg.py` merges
the dumps of an N-process fleet (serving replicas, training ranks, the
client side of a hop) into ONE pid-tracked Perfetto timeline plus a
fleet-wide metrics/SLO rollup; `tools/analyze_chip_log.py` validates
the stream with the same discipline as step_stats and trace_event.

Schema (`telemetry_dump/v1`) — one line per dump:
    {"phase": "telemetry_dump", "t": "<ISO8601>", "schema": str,
     "host": str, "pid": int, "rank": int|null, "run_id": str,
     "seq": int, "reason": "periodic"|"final"|"on_demand",
     "wall": float,                      # time.time() at dump
     "trace_wall_epoch": float,          # wall time of the tracer's
                                         # monotonic ts origin — how the
                                         # aggregator aligns processes
     "metrics": {...snapshot...},        # counters/gauges/histograms
     "slo": {...} | null,                # slo.SLOTracker.report()
     "trace_events": [...],              # NEW tracer events since the
                                         # last dump (incremental)
     "flight_events": [...],             # NEW flight events (by seq)
     "timeseries": {"interval_s": f,     # OPTIONAL: NEW
                    "frames": [...]},    # sampler frames since the last
                                         # dump (incremental by seq)
     "request_timelines": [...],         # OPTIONAL: recent per-request
                                         # timeline summaries
     "tenants": {...},                   # OPTIONAL: the
                                         # process's TenantLedger
                                         # snapshot (full state, not
                                         # incremental — the aggregator
                                         # merges each process's LAST
                                         # dump)
     "lifecycle": {...}}                 # OPTIONAL: the
                                         # process's lifecycle record
                                         # (replica) or the fleet view
                                         # (supervisor); full state,
                                         # last dump wins

Incremental on purpose: the tracer buffer holds 64k events — a
per-interval full snapshot would quadratically re-ship history.  Both
cursors (tracer `added()` count, flight `seq`) survive across dumps, so
concatenating one file's lines replays the process's whole story.

`TelemetryExporter.digest()` is the tiny fleet-membership view of the
same data (a few counters, not the streams) — `fleet/elastic.py` rides
it on the heartbeat store so `telemetry_digests()` answers "how is
every live rank doing" without touching the dump directory.

This module keeps its top level stdlib-only AND free of
package-relative imports (the `_obs_modules` guard), so
tools/telemetry_agg.py and tools/analyze_chip_log.py can file-load it.
"""
from __future__ import annotations

import json
import os
import socket
import threading
import time

__all__ = [
    "TelemetryExporter", "TELEMETRY_PHASE", "SCHEMA_VERSION",
    "validate_telemetry_stream", "summarize_telemetry_stream",
]

TELEMETRY_PHASE = "telemetry_dump"
SCHEMA_VERSION = "telemetry_dump/v1"
DEFAULT_INTERVAL_S = 30.0

_REQUIRED = {"phase": str, "t": str, "schema": str, "host": str,
             "pid": int, "seq": int, "reason": str,
             "wall": (int, float)}


def _obs_modules():
    """(metrics, trace, flight) siblings, or Nones when file-loaded
    standalone (the validation helpers below need none of them)."""
    try:
        from . import flight, metrics, trace  # type: ignore

        return metrics, trace, flight
    except ImportError:
        return None, None, None


def _timeseries_module():
    """The timeseries sibling, or None when file-loaded standalone."""
    try:
        from . import timeseries  # type: ignore

        return timeseries
    except ImportError:
        return None


def _iso_now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S")


class TelemetryExporter:
    """Dump this process's telemetry to `<outdir>/telemetry_<host>_
    <pid>[_r<rank>].jsonl` — once per `interval_s` on a daemon thread
    (`start()`/`stop()`), or explicitly (`dump_once()`).

    `slo` is an optional zero-arg callable returning an SLO report to
    embed (serving passes `server.slo.report`); `extra` a dict merged
    into every line (deployment labels: replica name, zone...)."""

    def __init__(self, outdir=None, interval_s=None, run_id=None,
                 rank=None, host=None, pid=None, slo=None, extra=None,
                 timelines=None, tenants=None, lifecycle=None):
        outdir = outdir or os.environ.get("PADDLE_TPU_TELEMETRY_DIR")
        if not outdir:
            raise ValueError(
                "TelemetryExporter needs an output directory (outdir= "
                "or env PADDLE_TPU_TELEMETRY_DIR)")
        if interval_s is None:
            interval_s = float(os.environ.get(
                "PADDLE_TPU_TELEMETRY_INTERVAL", DEFAULT_INTERVAL_S))
        self.outdir = str(outdir)
        self.interval_s = max(0.05, float(interval_s))
        self.host = str(host) if host else socket.gethostname()
        self.pid = int(pid) if pid is not None else os.getpid()
        if rank is None:
            rank = os.environ.get("PADDLE_TRAINER_ID")
        self.rank = None if rank is None else int(rank)
        self.run_id = str(run_id) if run_id else f"proc_{self.pid}"
        self.slo = slo
        # optional zero-arg callable returning recent RequestTimeline
        # summaries: a replica's exporter embeds the engine's
        # per-request latency story next to its metrics
        self.timelines = timelines
        # optional zero-arg callable returning a TenantLedger snapshot
        #: each dump carries the process's CURRENT tenant
        # book; telemetry_agg merges the fleet's last dumps
        self.tenants = tenants
        # optional zero-arg callable returning the process's lifecycle
        # record: a replica passes its LifecycleLedger's
        # record(); the supervisor passes FleetLifecycle.fleet_view()
        self.lifecycle = lifecycle
        self.extra = dict(extra or {})
        name = f"telemetry_{self.host}_{self.pid}"
        if self.rank is not None:
            name += f"_r{self.rank}"
        self.path = os.path.join(self.outdir, name + ".jsonl")
        self._lock = threading.Lock()
        self._seq = 0
        self._trace_seen = 0
        self._flight_seen = 0
        self._ts_seen = 0
        self._stop = threading.Event()
        self._thread = None
        self._io_lock = threading.Lock()  # serializes file appends
        # only — never held while reading/advancing telemetry state

    # --- dumping -------------------------------------------------------------
    def dump_once(self, reason="on_demand") -> str:
        """Append one dump line; returns the file path.  Thread-safe and
        incremental (only events new since the previous dump ship)."""
        metrics, trace, flight = _obs_modules()
        with self._lock:
            self._seq += 1
            line = {"phase": TELEMETRY_PHASE, "t": _iso_now(),
                    "schema": SCHEMA_VERSION, "host": self.host,
                    "pid": self.pid, "rank": self.rank,
                    "run_id": self.run_id, "seq": self._seq,
                    "reason": str(reason), "wall": time.time()}
            line.update(self.extra)
            # SLO report FIRST: report() publishes the slo.* gauges,
            # so the metrics snapshot below carries the current burn
            # rate instead of the previous interval's
            if self.slo is not None:
                try:
                    line["slo"] = self.slo()
                except Exception as e:
                    # a broken SLO callback must not sink the dump —
                    # but it must be VISIBLE in the stream it broke
                    line["slo_error"] = f"{type(e).__name__}: {e}"
            if metrics is not None:
                line["metrics"] = metrics.snapshot()
            if trace is not None:
                tracer = trace.get_tracer()
                evts = tracer.events()
                added = tracer.added()
                fresh = added - self._trace_seen
                self._trace_seen = added
                line["trace_wall_epoch"] = tracer.wall_epoch
                line["trace_events"] = evts[max(
                    0, len(evts) - max(0, fresh)):] if fresh > 0 else []
            if flight is not None:
                fevts = [e for e in flight.events()
                         if e.get("seq", 0) > self._flight_seen]
                if fevts:
                    self._flight_seen = max(e.get("seq", 0)
                                            for e in fevts)
                line["flight_events"] = fevts
            # the time dimension: frames the process-default
            # sampler collected since the last dump — incremental like
            # the trace/flight cursors, so concatenating one file's
            # lines replays the process's whole retained series
            tsmod = _timeseries_module()
            if tsmod is not None:
                sampler = tsmod.get_default_sampler()
                if sampler is not None:
                    frames = sampler.frames_since(self._ts_seen)
                    if frames:
                        self._ts_seen = frames[-1]["seq"]
                    line["timeseries"] = {
                        "interval_s": sampler.interval_s,
                        "frames": frames}
            if self.timelines is not None:
                try:
                    line["request_timelines"] = self.timelines()
                except Exception as e:
                    # same contract as the slo callback: a broken
                    # provider never sinks the dump, but stays VISIBLE
                    line["request_timelines_error"] = \
                        f"{type(e).__name__}: {e}"
            if self.tenants is not None:
                try:
                    line["tenants"] = self.tenants()
                except Exception as e:
                    line["tenants_error"] = f"{type(e).__name__}: {e}"
            if self.lifecycle is not None:
                try:
                    line["lifecycle"] = self.lifecycle()
                except Exception as e:
                    line["lifecycle_error"] = f"{type(e).__name__}: {e}"
        # the disk append runs OUTSIDE _lock: digest() rides the fleet
        # heartbeat and must never wait behind file IO.  _io_lock
        # serializes appends so two concurrent dumps cannot interleave
        # partial lines (the seq/cursor partition above is already
        # consistent — _lock owns it).
        os.makedirs(self.outdir, exist_ok=True)
        with self._io_lock:
            # pt-lint: ok[PT501] (dedicated IO lock: held only across this append, no state read waits on it)
            with open(self.path, "a") as f:
                f.write(json.dumps(line, default=str) + "\n")
        return self.path

    def digest(self) -> dict:
        """The heartbeat-sized view: identity + a handful of rollup
        numbers (requests by status, sheds, goodput gauge when set).
        Small by contract — it rides the fleet store on every beat."""
        metrics, _trace, _flight = _obs_modules()
        with self._lock:
            seq = self._seq
        out = {"host": self.host, "pid": self.pid, "rank": self.rank,
               "run_id": self.run_id, "seq": seq,
               "wall": time.time()}
        if metrics is not None:
            snap = metrics.snapshot()
            counters = snap.get("counters", {})
            out["requests"] = sum(
                v for k, v in counters.items()
                if k.startswith("serving.requests"))
            out["shed"] = sum(
                v for k, v in counters.items()
                if k.startswith("resilience.shed_requests"))
            gauges = snap.get("gauges", {})
            for key in ("goodput.productive_frac", "serving.inflight",
                        "slo.burn_rate{endpoint=predict}"):
                if key in gauges:
                    out[key.split("{")[0].replace(".", "_")] = gauges[key]
        return out

    # --- lifecycle -----------------------------------------------------------
    def start(self):
        """Begin periodic dumps (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="paddle-tpu-telemetry-export")
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.dump_once(reason="periodic")
            except Exception:
                metrics, _t, _f = _obs_modules()
                if metrics is not None:
                    # a full disk / unmounted share: count it — the
                    # aggregator's gap and this counter are the evidence
                    metrics.inc("telemetry.export_errors")

    def stop(self, final_dump=True):
        """Stop the periodic thread; by default write one last dump so
        the stream ends with the process's final state."""
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2)
        self._thread = None
        if final_dump:
            try:
                self.dump_once(reason="final")
            except OSError:
                pass  # teardown path: the disk may already be gone

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False


# ----------------------- stream validation -----------------------
#
# Pure functions over parsed JSONL entries, mirroring
# step_stats.validate_stream / trace.validate_trace_stream:
# tools/analyze_chip_log.py file-loads this module for them.

def validate_telemetry_stream(entries) -> list:
    """Schema errors for telemetry_dump entries in `entries` (other
    phases ignored — chip logs interleave).  Empty list = valid."""
    errors = []
    seqs: dict = {}
    for i, e in enumerate(entries):
        if not isinstance(e, dict) or e.get("phase") != TELEMETRY_PHASE:
            continue
        for key, typ in _REQUIRED.items():
            if key not in e:
                errors.append(f"entry {i}: missing required key {key!r}")
            elif not isinstance(e[key], typ) or isinstance(e[key], bool):
                errors.append(
                    f"entry {i}: key {key!r} has type "
                    f"{type(e[key]).__name__}, expected {typ}")
        if e.get("schema") not in (None, SCHEMA_VERSION):
            errors.append(f"entry {i}: unknown schema {e.get('schema')!r}")
        for key in ("metrics", "slo", "timeseries", "tenants",
                    "lifecycle"):
            if key in e and e[key] is not None \
                    and not isinstance(e[key], dict):
                errors.append(f"entry {i}: key {key!r} not an object")
        for key in ("trace_events", "flight_events",
                    "request_timelines"):
            if key in e and not isinstance(e[key], list):
                errors.append(f"entry {i}: key {key!r} not a list")
        ts = e.get("timeseries")
        if isinstance(ts, dict) and not isinstance(
                ts.get("frames", []), list):
            errors.append(f"entry {i}: timeseries.frames not a list")
        if isinstance(e.get("seq"), int) and isinstance(e.get("pid"), int):
            ident = (e.get("host"), e["pid"], e.get("rank"))
            prev = seqs.get(ident)
            if prev is not None and e["seq"] <= prev:
                errors.append(
                    f"entry {i}: seq {e['seq']} not increasing for "
                    f"{ident} (prev {prev})")
            seqs[ident] = e["seq"]
    return errors


def summarize_telemetry_stream(entries) -> dict:
    """Per-process digest of a telemetry_dump stream: dump counts,
    shipped event counts, last counters-total per process."""
    procs: dict = {}
    for e in entries:
        if not isinstance(e, dict) or e.get("phase") != TELEMETRY_PHASE:
            continue
        ident = f"{e.get('host', '?')}:{e.get('pid', '?')}" + (
            f":r{e['rank']}" if e.get("rank") is not None else "")
        s = procs.setdefault(ident, {
            "dumps": 0, "trace_events": 0, "flight_events": 0})
        s["dumps"] += 1
        s["trace_events"] += len(e.get("trace_events") or ())
        s["flight_events"] += len(e.get("flight_events") or ())
        m = e.get("metrics")
        if isinstance(m, dict):
            counters = m.get("counters", {})
            if isinstance(counters, dict):
                s["counters_total"] = sum(
                    v for v in counters.values()
                    if isinstance(v, (int, float)))
        if isinstance(e.get("slo"), dict):
            s["has_slo"] = True
    return procs
