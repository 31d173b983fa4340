"""Process-local metrics registry: counters / gauges / histograms.

The permanent version of the one-off xprof forensics that drove the
round-5 MFU climb (PERF.md): the hot paths that used to fail *silently*
— flash-attention layout dispatch, autotune cache, `jit.to_static`
retraces, collectives, allocator peaks — increment cheap process-local
metrics, and any run can snapshot them (JSONL or Prometheus text).

Design constraints, in priority order:
  * near-zero cost when disabled: one attribute read + branch per call,
    no dict/lock work.  The registry is DISABLED by default; bench's
    ``--telemetry`` flag, ``observability.attach()``, or env
    ``PADDLE_TPU_METRICS=1`` turn it on.
  * thread-safe when enabled: a single registry lock guards the maps
    (counters are dict updates — contention is negligible next to what
    the instrumented paths do).
  * labels: a metric key is (name, sorted label items).  Snapshot keys
    render as ``name{k=v,...}`` so tests and tools can string-match.
  * scope tagging: while a `profiler.RecordEvent` span is open on this
    thread, HISTOGRAMS observed with ``tag_scope`` enabled (default)
    carry a ``scope=<innermost span>`` label, and flight events / step
    records capture the scope too — "spans tag metrics with the active
    scope".  Counters and gauges are never auto-tagged: their keys stay
    byte-identical to the schema ``attach()`` declares (pass ``scope=``
    explicitly to split one by scope).

This module is stdlib-only on purpose: it imports during
``paddle_tpu.__init__`` (the Pallas dispatch sites pull it in) and must
never create an import cycle or pay a jax import.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import threading
import time

__all__ = [
    "MetricsRegistry", "get_registry", "inc", "set_gauge", "observe",
    "declare", "declare_hist", "snapshot", "to_prometheus",
    "dump_jsonl", "enable", "disable", "enabled", "reset", "push_scope",
    "pop_scope", "current_scope", "DEFAULT_BUCKETS", "quantile",
]

# --------------------------- scope stack ---------------------------

_scopes = threading.local()


def push_scope(name: str) -> int:
    """Enter a named scope on this thread; returns a token for pop_scope
    (tokens make unbalanced exits — e.g. a RecordEvent.end without a
    begin on this thread — safe no-ops instead of corruption)."""
    stack = getattr(_scopes, "stack", None)
    if stack is None:
        stack = _scopes.stack = []
    stack.append(str(name))
    return len(stack)


def pop_scope(token: int) -> None:
    stack = getattr(_scopes, "stack", None)
    if stack and 0 < token <= len(stack):
        del stack[token - 1:]


def current_scope():
    """Innermost open scope name on this thread, or None."""
    stack = getattr(_scopes, "stack", None)
    return stack[-1] if stack else None


# --------------------------- histograms ---------------------------

def _log_spaced(lo: float, hi: float, per_decade: int) -> tuple:
    """Geometric bucket bounds lo..hi, `per_decade` per factor of 10,
    rounded to 4 significant digits so the `le` labels stay short and
    byte-stable across processes (the fleet aggregator merges by
    label)."""
    out = []
    i = 0
    while True:
        b = float(f"{lo * 10 ** (i / per_decade):.4g}")
        if b > hi:
            return tuple(out)
        out.append(b)
        i += 1


# The fixed bucket ladder every histogram uses: 0.1 .. 1e5 covers
# sub-ms serving phases through 100 s compile walls at the ms scale the
# step/request metrics record in.  FIXED (not per-metric) on purpose:
# cross-process histogram merge (tools/telemetry_agg.py) is a plain
# per-bucket sum only when every process shares one ladder.
DEFAULT_BUCKETS = _log_spaced(0.1, 1e5, 4)


def quantile(sorted_vals, q: float):
    """Linear-interpolated quantile of an already-sorted sequence (the
    numpy 'linear' definition): even-count p50 is the midpoint of the
    middle pair, and a 3-sample p95 interpolates instead of snapping to
    the max.  None on empty input."""
    n = len(sorted_vals)
    if n == 0:
        return None
    if n == 1:
        return float(sorted_vals[0])
    pos = max(0.0, min(1.0, float(q))) * (n - 1)
    i = int(pos)
    frac = pos - i
    if frac == 0.0 or i + 1 >= n:
        return float(sorted_vals[min(i, n - 1)])
    return float(sorted_vals[i]) + frac * (
        float(sorted_vals[i + 1]) - float(sorted_vals[i]))


class _Hist:
    """count/sum/min/max, fixed log-spaced buckets (`le`-style: bucket i
    counts values <= bounds[i], the last slot is +Inf overflow), and a
    bounded reservoir of recent values.  Percentiles are exact
    (interpolated ranks over the reservoir) while every observation
    still fits it, and bucket-interpolated beyond that — the buckets
    see ALL observations, so long-running servers report real p99s, not
    the last 256 samples'."""

    __slots__ = ("count", "total", "min", "max", "recent", "bounds",
                 "buckets")

    def __init__(self, bounds=DEFAULT_BUCKETS):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.recent = collections.deque(maxlen=256)
        self.bounds = bounds
        self.buckets = [0] * (len(bounds) + 1)  # +1: the +Inf slot

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self.recent.append(v)
        self.buckets[bisect.bisect_left(self.bounds, v)] += 1

    def percentile(self, q: float):
        """Bucket-interpolated percentile over ALL observations (the
        Prometheus histogram_quantile estimate), clamped to the
        observed [min, max]."""
        if not self.count:
            return None
        target = max(0.0, min(1.0, float(q))) * self.count
        cum = 0
        for i, c in enumerate(self.buckets):
            if c and cum + c >= target:
                lo = self.min if i == 0 else self.bounds[i - 1]
                hi = self.max if i >= len(self.bounds) else self.bounds[i]
                est = lo + (hi - lo) * ((target - cum) / c)
                return max(self.min, min(self.max, est))
            cum += c
        return self.max

    def summary(self) -> dict:
        out = {"count": self.count, "total": round(self.total, 6)}
        if self.count:
            out["mean"] = round(self.total / self.count, 6)
            out["min"] = round(self.min, 6)
            out["max"] = round(self.max, 6)
            if self.count <= len(self.recent):
                # the reservoir still holds every observation: exact
                # interpolated-rank percentiles
                r = sorted(self.recent)
                p50, p95, p99 = (quantile(r, q)
                                 for q in (0.5, 0.95, 0.99))
            else:
                p50, p95, p99 = (self.percentile(q)
                                 for q in (0.5, 0.95, 0.99))
            out["p50"] = round(p50, 6)
            out["p95"] = round(p95, 6)
            out["p99"] = round(p99, 6)
            out["last"] = round(self.recent[-1], 6)
            # sparse non-cumulative bucket counts keyed by upper bound
            # ("inf" = overflow): what telemetry_agg sums to merge one
            # fleet-wide distribution
            out["buckets"] = {
                ("inf" if i >= len(self.bounds)
                 else f"{self.bounds[i]:g}"): c
                for i, c in enumerate(self.buckets) if c}
        return out


# --------------------------- registry ---------------------------

def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render(name: str, lkey: tuple) -> str:
    if not lkey:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in lkey) + "}"


class MetricsRegistry:
    def __init__(self, enabled: bool = False, tag_scope: bool = True):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._hists: dict = {}
        self._enabled = bool(enabled)
        self.tag_scope = tag_scope

    # -- state --
    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def enabled(self) -> bool:
        return self._enabled

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    # -- recording --
    def _tagged(self, labels: dict) -> dict:
        # auto-scope-tagging applies to HISTOGRAMS only (timings are
        # scope-local by nature; RecordEvent integration) — see inc()
        if self.tag_scope and "scope" not in labels:
            s = current_scope()
            if s is not None:
                labels = dict(labels, scope=s)
        return labels

    def inc(self, name: str, value=1, **labels) -> None:
        # counters are NOT auto-scope-tagged: their keys must stay
        # byte-identical to the schema attach() declares (pass scope=
        # explicitly to split a counter by scope)
        if not self._enabled:
            return
        key = (name, _label_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + value

    def declare(self, name: str, **labels) -> None:
        """Pre-register a counter at 0 so snapshots carry a stable schema
        even for paths that never fired this run (e.g. autotune on a CPU
        host).  Works regardless of the enabled flag — declaring schema
        is not a hot path."""
        key = (name, _label_key(labels))
        with self._lock:
            self._counters.setdefault(key, 0)

    def declare_hist(self, name: str, **labels) -> None:
        """Pre-register an EMPTY histogram (count 0, full bucket ladder)
        so snapshots and /metrics render the series before the first
        observation — a fresh server exposes `serving.itl_ms` at zero
        instead of omitting it (schema discipline).  Works
        regardless of the enabled flag, like declare()."""
        key = (name, _label_key(labels))
        with self._lock:
            self._hists.setdefault(key, _Hist())

    def set_gauge(self, name: str, value, **labels) -> None:
        if not self._enabled:
            return
        key = (name, _label_key(labels))
        with self._lock:
            self._gauges[key] = value

    def observe(self, name: str, value, **labels) -> None:
        if not self._enabled:
            return
        key = (name, _label_key(self._tagged(labels)))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Hist()
            h.observe(value)

    # -- export --
    def snapshot(self) -> dict:
        """One structured dict: {"ts", "counters", "gauges", "histograms"}
        with ``name{k=v}`` string keys (JSON-serializable as-is)."""
        with self._lock:
            counters = {_render(n, l): v
                        for (n, l), v in sorted(self._counters.items())}
            gauges = {_render(n, l): v
                      for (n, l), v in sorted(self._gauges.items())}
            hists = {_render(n, l): h.summary()
                     for (n, l), h in sorted(self._hists.items())}
        return {"ts": time.time(), "counters": counters, "gauges": gauges,
                "histograms": hists}

    def to_prometheus(self, prefix: str = "paddle_tpu") -> str:
        """Prometheus text exposition format: counters, gauges, and full
        histograms — cumulative ``_bucket{le="..."}`` series (the
        ``histogram_quantile()`` input), ``_sum``/``_count``, plus a
        separate ``<name>_quantile{quantile="..."}`` gauge family
        carrying the registry's own p50/p95/p99 so a bare curl shows
        the percentiles without a PromQL engine.  (A distinct family on
        purpose: bare-name ``{quantile=}`` samples inside a ``# TYPE
        ... histogram`` block are invalid under OpenMetrics/strict
        parsers and would poison the whole scrape.)"""
        def pname(name):
            return prefix + "_" + name.replace(".", "_").replace("-", "_")

        def plabels(lkey, *extra):
            items = list(lkey) + list(extra)
            if not items:
                return ""
            return "{" + ",".join(f'{k}="{v}"' for k, v in items) + "}"

        lines = []
        with self._lock:
            seen = set()
            for (n, l), v in sorted(self._counters.items()):
                if n not in seen:
                    lines.append(f"# TYPE {pname(n)} counter")
                    seen.add(n)
                lines.append(f"{pname(n)}{plabels(l)} {v}")
            for (n, l), v in sorted(self._gauges.items()):
                if n not in seen:
                    lines.append(f"# TYPE {pname(n)} gauge")
                    seen.add(n)
                lines.append(f"{pname(n)}{plabels(l)} {v}")
            for (n, l), h in sorted(self._hists.items()):
                if n not in seen:
                    lines.append(f"# TYPE {pname(n)} histogram")
                    seen.add(n)
                cum = 0
                for i, b in enumerate(h.bounds):
                    cum += h.buckets[i]
                    lines.append(f"{pname(n)}_bucket"
                                 f"{plabels(l, ('le', f'{b:g}'))} {cum}")
                lines.append(f"{pname(n)}_bucket"
                             f"{plabels(l, ('le', '+Inf'))} {h.count}")
                lines.append(f"{pname(n)}_sum{plabels(l)} {h.total}")
                lines.append(f"{pname(n)}_count{plabels(l)} {h.count}")
                summ = h.summary()
                qname = pname(n) + "_quantile"
                if qname not in seen and any(
                        f"p{int(float(q) * 100)}" in summ
                        for q in ("0.5", "0.95", "0.99")):
                    lines.append(f"# TYPE {qname} gauge")
                    seen.add(qname)
                for q in ("0.5", "0.95", "0.99"):
                    key = "p" + str(int(float(q) * 100))
                    if key in summ:
                        lines.append(
                            f"{qname}{plabels(l, ('quantile', q))} "
                            f"{summ[key]}")
        return "\n".join(lines) + "\n"

    def dump_jsonl(self, path: str, extra: dict | None = None) -> str:
        """Append one snapshot line to `path` (the chip-session-log
        convention: one self-describing JSON object per line)."""
        line = {"phase": "metrics_snapshot",
                "t": time.strftime("%Y-%m-%dT%H:%M:%S")}
        if extra:
            line.update(extra)
        line.update(self.snapshot())
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(line, default=str) + "\n")
        return path


_default = MetricsRegistry(
    enabled=os.environ.get("PADDLE_TPU_METRICS", "0") in ("1", "true",
                                                          "True"))


def get_registry() -> MetricsRegistry:
    return _default


# module-level conveniences bound to the default registry — the form the
# instrumented call sites use (`metrics.inc("flash.dispatch", tier=...)`)
def inc(name, value=1, **labels):
    _default.inc(name, value, **labels)


def declare(name, **labels):
    _default.declare(name, **labels)


def declare_hist(name, **labels):
    _default.declare_hist(name, **labels)


def set_gauge(name, value, **labels):
    _default.set_gauge(name, value, **labels)


def observe(name, value, **labels):
    _default.observe(name, value, **labels)


def snapshot():
    return _default.snapshot()


def to_prometheus(prefix="paddle_tpu"):
    return _default.to_prometheus(prefix)


def dump_jsonl(path, extra=None):
    return _default.dump_jsonl(path, extra)


def enable():
    _default.enable()


def disable():
    _default.disable()


def enabled():
    return _default.enabled()


def reset():
    _default.reset()
