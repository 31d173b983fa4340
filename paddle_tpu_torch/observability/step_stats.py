"""Step-level training/serving telemetry: StepTimer + JSONL stream.

A `StepTimer` sits in the train/serve loop (and `bench.py --telemetry`)
and turns wall-clock step measurements into:

  * per-step records — wall time, tokens/s, estimated MFU (from the
    caller's FLOPs accounting, the same 6*N*tokens model bench.py uses),
    host->device transfer bytes, device allocator peak — emitted as a
    JSONL stream whose lines follow the `tools/chip_session_log.jsonl`
    convention (every line a self-describing object with "phase" and
    "t"), so `tools/analyze_chip_log.py` consumes live runs and
    historical logs uniformly;
  * a compile-time ledger: records marked ``compile=True`` (first-step
    trace+compile walls) are summarized separately from steady-state
    steps, making "first step 38 s, steady 210 ms" a queryable fact
    instead of an xprof anecdote;
  * registry metrics: `step.wall_ms` / `step.compile_ms` histograms and
    `mem.peak_bytes_in_use` gauges on the shared metrics registry.

Schema (`step_stats/v1`) — one line per record:
    {"phase": "step_stats", "t": "<ISO8601>", "run_id": str,
     "step": int, "n_steps": int, "wall_ms": float, "compile": bool,
     optional: "tokens_per_s", "mfu", "transfer_bytes",
               "peak_bytes_in_use", "scope"}

This module keeps its top level stdlib-only AND free of package-relative
imports: a log analyzer can file-load it without importing the package.

The port's copy (``paddle_tpu/observability/step_stats.py``) differs
from the JAX module only in `_device_peak_bytes`, which reads the CUDA
allocator's peak through torch, imported when a record asks for it.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

__all__ = ["StepTimer", "STEP_PHASE", "SCHEMA_VERSION", "validate_stream",
           "summarize_stream", "add_record_hook", "remove_record_hook"]

STEP_PHASE = "step_stats"
SCHEMA_VERSION = "step_stats/v1"

_REQUIRED = {"phase": str, "t": str, "run_id": str, "step": int,
             "n_steps": int, "wall_ms": (int, float), "compile": bool}
_OPTIONAL = {"tokens_per_s": (int, float), "mfu": (int, float),
             "transfer_bytes": int, "peak_bytes_in_use": int,
             "scope": str}


def _iso_now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S")


def _obs_modules():
    """(metrics, flight, trace) from the observability package, or Nones
    when running standalone (file-loaded by tools/)."""
    try:
        from . import flight, metrics, trace  # type: ignore

        return metrics, flight, trace
    except ImportError:
        return None, None, None


# record hooks: callables invoked with each finished step record —
# how the resilience watchdog heartbeats off step progress without
# step_stats importing resilience (no cycle, no per-site wiring)
_record_hooks: list = []


def add_record_hook(fn) -> None:
    if fn not in _record_hooks:
        _record_hooks.append(fn)


def remove_record_hook(fn) -> None:
    if fn in _record_hooks:
        _record_hooks.remove(fn)


def _device_peak_bytes():
    """The CUDA caching allocator's high-watermark on the current
    device (`torch.cuda.max_memory_allocated`); None on a host without
    CUDA, or when torch is not importable (the module file-loaded by
    a tool)."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        v = torch.cuda.max_memory_allocated()
        return int(v) if v else None
    except Exception:
        return None


class StepTimer:
    """Feed it step walls; it emits records, metrics, and a summary.

    tokens_per_step / flops_per_step / peak_flops may be set after
    construction (bench knows the parameter count only after building
    the model) — rates appear on records from that point on.
    """

    def __init__(self, run_id=None, tokens_per_step=None,
                 flops_per_step=None, peak_flops=None, sink=None,
                 read_device_memory=True):
        self.run_id = str(run_id) if run_id else f"run_{os.getpid()}"
        self.tokens_per_step = tokens_per_step
        self.flops_per_step = flops_per_step
        self.peak_flops = peak_flops
        self.read_device_memory = read_device_memory
        self._sink_path = sink
        self.records: list = []
        self._lock = threading.Lock()
        self._next_step = 0

    @contextlib.contextmanager
    def step(self, n_steps=1, compile_step=False, transfer_bytes=0):
        """Context manager timing one step (or one n_steps-long compiled
        multi-step program — the wall is divided per step)."""
        t0 = time.perf_counter()
        yield
        self.record(time.perf_counter() - t0, n_steps=n_steps,
                    compile_step=compile_step,
                    transfer_bytes=transfer_bytes)

    def record(self, wall_s, n_steps=1, compile_step=False,
               transfer_bytes=0):
        """Record a measured wall of `n_steps` device steps."""
        n = max(int(n_steps), 1)
        per_step_s = float(wall_s) / n
        metrics, _flight, trace = _obs_modules()
        rec = {"phase": STEP_PHASE, "t": _iso_now(), "run_id": self.run_id,
               "step": -1, "n_steps": n,
               "wall_ms": round(per_step_s * 1e3, 4),
               "compile": bool(compile_step)}
        if transfer_bytes:
            rec["transfer_bytes"] = int(transfer_bytes)
        if self.tokens_per_step and not compile_step:
            rec["tokens_per_s"] = round(self.tokens_per_step / per_step_s, 2)
            if self.flops_per_step and self.peak_flops:
                rec["mfu"] = round(self.flops_per_step / per_step_s
                                   / self.peak_flops, 6)
        if self.read_device_memory:
            peak = _device_peak_bytes()
            if peak is not None:
                rec["peak_bytes_in_use"] = peak
        if metrics is not None:
            scope = metrics.current_scope()
            if scope is not None:
                rec["scope"] = scope
            name = "step.compile_ms" if compile_step else "step.wall_ms"
            metrics.observe(name, per_step_s * 1e3, run_id=self.run_id)
            if "peak_bytes_in_use" in rec:
                metrics.set_gauge("mem.peak_bytes_in_use",
                                  rec["peak_bytes_in_use"])
            if transfer_bytes:
                metrics.inc("step.transfer_bytes", int(transfer_bytes),
                            run_id=self.run_id)
        with self._lock:
            # step id claimed under the lock: concurrent record() calls
            # must not share an id (the JSONL stream keys on it)
            rec["step"] = self._next_step
            self._next_step += n
            self.records.append(rec)
        if trace is not None and trace.enabled():
            # frame marker on the run's synthetic track: the step just
            # finished, so it occupies [now - wall, now] on the timeline
            name = "compile+step" if compile_step else (
                f"step {rec['step']}" if n == 1
                else f"steps {rec['step']}..{rec['step'] + n - 1}")
            trace.frame(name, float(wall_s) * 1e6,
                        track=f"steps:{self.run_id}",
                        step=rec["step"], n_steps=n,
                        wall_ms=rec["wall_ms"],
                        compile=bool(compile_step))
            if "peak_bytes_in_use" in rec:
                trace.counter("mem.peak_bytes_in_use",
                              track=f"mem:{self.run_id}",
                              bytes=rec["peak_bytes_in_use"])
        if self._sink_path:
            try:
                d = os.path.dirname(os.path.abspath(self._sink_path))
                os.makedirs(d, exist_ok=True)
                with open(self._sink_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            except OSError:
                pass  # telemetry must never sink the run
        for hook in list(_record_hooks):
            try:
                hook(rec)
            except Exception:
                # a broken hook must never sink the run — but a hook
                # that dies silently (a dead watchdog heartbeat!) is
                # exactly the failure the metrics exist to surface
                if metrics is not None:
                    metrics.inc("step.record_hook_errors")
        return rec

    def summary(self) -> dict:
        """Aggregate view for embedding (bench JSON `telemetry.step_stats`):
        compile ledger vs steady-state wall stats, throughput, MFU."""
        with self._lock:
            recs = list(self.records)
        steady = [r for r in recs if not r["compile"]]
        comp = [r for r in recs if r["compile"]]
        out = {"schema": SCHEMA_VERSION, "run_id": self.run_id,
               "records": len(recs),
               "steps": sum(r["n_steps"] for r in recs)}
        if comp:
            walls = [r["wall_ms"] * r["n_steps"] for r in comp]
            out["compile_ms"] = {"count": len(comp),
                                 "total": round(sum(walls), 3),
                                 "max": round(max(walls), 3)}
        if steady:
            walls = sorted(r["wall_ms"] for r in steady)
            out["wall_ms"] = {
                "count": len(walls),
                "mean": round(sum(walls) / len(walls), 4),
                "min": round(walls[0], 4), "max": round(walls[-1], 4),
                "p50": round(walls[len(walls) // 2], 4)}
            total_steps = sum(r["n_steps"] for r in steady)
            total_s = sum(r["wall_ms"] * r["n_steps"] for r in steady) / 1e3
            if self.tokens_per_step and total_s > 0:
                out["tokens_per_s"] = round(
                    self.tokens_per_step * total_steps / total_s, 2)
                if self.flops_per_step and self.peak_flops:
                    out["mfu"] = round(
                        self.flops_per_step * total_steps / total_s
                        / self.peak_flops, 6)
        tb = sum(r.get("transfer_bytes", 0) for r in recs)
        if tb:
            out["transfer_bytes"] = tb
        peaks = [r["peak_bytes_in_use"] for r in recs
                 if "peak_bytes_in_use" in r]
        if peaks:
            out["peak_bytes_in_use"] = max(peaks)
        return out


# ----------------------- stream validation -----------------------
#
# Pure functions over parsed JSONL entries (tools/analyze_chip_log.py
# file-loads this module to get them — keep them stdlib-only).

def validate_stream(entries) -> list:
    """Schema errors for the step_stats entries in `entries` (non-step
    entries are ignored — chip_session logs interleave phases).  Empty
    list = valid."""
    errors = []
    for i, e in enumerate(entries):
        if not isinstance(e, dict) or e.get("phase") != STEP_PHASE:
            continue
        for key, typ in _REQUIRED.items():
            if key not in e:
                errors.append(f"entry {i}: missing required key {key!r}")
            elif not isinstance(e[key], typ) or isinstance(e[key], bool) \
                    and typ is not bool:
                errors.append(
                    f"entry {i}: key {key!r} has type "
                    f"{type(e[key]).__name__}, expected {typ}")
        for key, typ in _OPTIONAL.items():
            if key in e and not isinstance(e[key], typ):
                errors.append(
                    f"entry {i}: optional key {key!r} has type "
                    f"{type(e[key]).__name__}, expected {typ}")
        if isinstance(e.get("wall_ms"), (int, float)) and e["wall_ms"] < 0:
            errors.append(f"entry {i}: negative wall_ms")
    return errors


def summarize_stream(entries) -> dict:
    """Per-run_id digest of a step_stats stream: step counts, compile vs
    steady wall stats, mean throughput/MFU.  Shape:
    {run_id: {"records", "steps", "compile_ms_total", "steady_wall_ms":
    {...}, "tokens_per_s"?, "mfu"?}}"""
    runs: dict = {}
    for e in entries:
        if not isinstance(e, dict) or e.get("phase") != STEP_PHASE:
            continue
        runs.setdefault(e.get("run_id", "?"), []).append(e)
    out = {}
    for run_id, recs in runs.items():
        steady = [r for r in recs if not r.get("compile")]
        comp = [r for r in recs if r.get("compile")]
        s = {"records": len(recs),
             "steps": sum(int(r.get("n_steps", 1)) for r in recs),
             "compile_ms_total": round(
                 sum(float(r.get("wall_ms", 0)) * int(r.get("n_steps", 1))
                     for r in comp), 3)}
        if steady:
            walls = sorted(float(r.get("wall_ms", 0)) for r in steady)
            s["steady_wall_ms"] = {
                "count": len(walls),
                "mean": round(sum(walls) / len(walls), 4),
                "min": round(walls[0], 4), "max": round(walls[-1], 4)}
            tps = [r["tokens_per_s"] for r in steady if "tokens_per_s" in r]
            if tps:
                s["tokens_per_s_mean"] = round(sum(tps) / len(tps), 2)
            mfus = [r["mfu"] for r in steady if "mfu" in r]
            if mfus:
                s["mfu_mean"] = round(sum(mfus) / len(mfus), 6)
        out[run_id] = s
    return out
