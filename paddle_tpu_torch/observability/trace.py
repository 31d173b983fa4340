"""Unified trace timeline: thread-safe span tracer with Perfetto export.

The fourth observability pillar (docs/OBSERVABILITY.md): the metrics registry gave the
framework counters, a flight ring, and step-stats JSONL, but the signals
were siloed — a RecordEvent scope, a gate-reject flight event, and a
step wall could not be laid on ONE timeline.  This module is that
timeline:

  * spans   — monotonic-clock begin/end pairs with parent/child nesting
    per thread, labels, and a bounded event buffer (`span()` context
    manager, `traced()` decorator, or explicit `begin()`/`end()` for
    scope objects like profiler.RecordEvent);
  * instants — point events (the flight recorder mirrors every ring
    event here when the tracer is on, so dispatch decisions and gate
    rejects land between the spans that caused them);
  * frames  — step markers on a per-run synthetic track (StepTimer
    emits one per step record: the train loop's heartbeat row);
  * counters — numeric series ("C" events: allocator peak over time).

Export is Chrome trace-event JSON (the format Perfetto and
chrome://tracing open natively): complete events with real `pid`/`tid`,
`process_name`/`thread_name`/`thread_sort_index` metadata so nested
scopes render as stacked slices per thread instead of collapsing onto
one row, and synthetic tracks for frames/counters sorted below the real
threads.

Cost model: DISABLED by default — one attribute read + branch per call
(`observability.attach()`, `trace.enable()`, or env
``PADDLE_TPU_TRACE=1`` turn it on).  When enabled, a span is two clock
reads, a dict, and a deque append under a short lock; the buffer is
bounded (oldest events drop, the drop count is reported in the export).

This module keeps its top level stdlib-only AND free of package-relative
imports: `tools/analyze_chip_log.py` and `tools/perf_gate.py` file-load
it (like step_stats.py), so traces can be validated and merged without
importing jax-heavy `paddle_tpu`.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import threading
import time

__all__ = [
    "SpanTracer", "get_tracer", "span", "traced", "begin", "end",
    "instant", "frame", "counter", "enable", "disable", "enabled",
    "clear", "events", "to_chrome", "export", "dump_jsonl",
    "current_span", "TRACE_PHASE", "SCHEMA_VERSION", "DEFAULT_CAPACITY",
    "validate_trace_stream", "summarize_trace_stream",
]

TRACE_PHASE = "trace_event"
SCHEMA_VERSION = "trace/v1"
DEFAULT_CAPACITY = 65536

# synthetic tracks (frames/counters) sort below real threads in the UI
_VIRTUAL_SORT_BASE = 1000


def _metrics_module():
    """The sibling metrics module, or None when file-loaded standalone."""
    try:
        from . import metrics  # type: ignore

        return metrics
    except ImportError:
        return None


class Span:
    """Open-span handle: mutate ``args`` before the span closes to attach
    metadata computed inside the span (e.g. xla_cost attaches the
    compiler's FLOPs estimate to the compile span that produced it)."""

    __slots__ = ("name", "cat", "args", "t0_us", "tid", "depth")

    def __init__(self, name, cat, args, t0_us, tid, depth):
        self.name = name
        self.cat = cat
        self.args = args
        self.t0_us = t0_us
        self.tid = tid
        self.depth = depth


class SpanTracer:
    def __init__(self, capacity: int = DEFAULT_CAPACITY, enabled=None):
        self._lock = threading.Lock()
        self._events = collections.deque(maxlen=int(capacity))
        self.capacity = int(capacity)
        self._n_added = 0
        if enabled is None:
            enabled = os.environ.get("PADDLE_TPU_TRACE", "0") in (
                "1", "true", "True")
        self._enabled = bool(enabled)
        # one epoch per tracer: every ts is microseconds since this
        # monotonic origin, so spans/instants/frames from all threads
        # share a comparable clock
        self._epoch_ns = time.perf_counter_ns()
        self.wall_epoch = time.time()
        self.pid = os.getpid()
        self._tids: dict = {}        # threading ident -> small stable tid
        self._tid_names: dict = {}   # tid -> display name
        self._virtual: dict = {}     # track name -> tid
        self._local = threading.local()

    # ------------------------------ state ------------------------------
    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def enabled(self) -> bool:
        return self._enabled

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._n_added = 0

    def dropped(self) -> int:
        with self._lock:
            return max(0, self._n_added - self.capacity)

    def added(self) -> int:
        """Lifetime event count (monotone): the incremental-export
        cursor — `export.TelemetryExporter` dumps only events appended
        since its last dump by diffing this against its own cursor."""
        with self._lock:
            return self._n_added

    # ------------------------------ clock/ids ------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._epoch_ns) / 1e3

    def _tid(self) -> int:
        ident = threading.get_ident()
        # double-checked locking: the lock-free read is a GIL-atomic
        # dict get on this thread's own (immutable-once-written) entry
        tid = self._tids.get(ident)  # pt-lint: ok[PT102]
        if tid is None:
            with self._lock:
                tid = self._tids.get(ident)
                if tid is None:
                    tid = len(self._tids) + 1
                    self._tids[ident] = tid
                    self._tid_names[tid] = threading.current_thread().name
        return tid

    def virtual_tid(self, track: str) -> int:
        """Stable tid for a synthetic track (frames, counters); rendered
        below the real threads via thread_sort_index."""
        # same double-checked pattern as _tid (lock-free first probe)
        tid = self._virtual.get(track)  # pt-lint: ok[PT102]
        if tid is None:
            with self._lock:
                tid = self._virtual.get(track)
                if tid is None:
                    tid = _VIRTUAL_SORT_BASE + len(self._virtual) + 1
                    self._virtual[track] = tid
                    self._tid_names[tid] = track
        return tid

    def _append(self, evt: dict) -> None:
        with self._lock:
            self._n_added += 1
            self._events.append(evt)

    # ------------------------------ spans ------------------------------
    def begin(self, name: str, cat: str = "host", **args):
        """Open a span on this thread; returns a Span token for end()
        (None when disabled — end(None) is a no-op, so begin/end pairs
        cost one branch each when tracing is off)."""
        if not self._enabled:
            return None
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        sp = Span(str(name), cat, dict(args), self._now_us(), self._tid(),
                  len(stack))
        stack.append(sp)
        return sp

    def end(self, sp) -> None:
        if sp is None:
            return
        t1 = self._now_us()
        stack = getattr(self._local, "stack", None)
        if stack and sp in stack:
            # tolerate unbalanced exits: drop this span and anything
            # opened (and never closed) inside it
            del stack[stack.index(sp):]
            if stack:
                sp.args.setdefault("parent", stack[-1].name)
        if not self._enabled:
            # disabled mid-span: the stack is already popped (a leaked
            # entry would mislabel every later span's parent), only the
            # event emission is skipped
            return
        metrics = _metrics_module()
        if metrics is not None:
            scope = metrics.current_scope()
            if scope is not None and scope != sp.name:
                sp.args.setdefault("scope", scope)
        self._append({"name": sp.name, "cat": sp.cat, "ph": "X",
                      "ts": round(sp.t0_us, 3),
                      "dur": round(max(t1 - sp.t0_us, 0.0), 3),
                      "pid": self.pid, "tid": sp.tid, "args": sp.args})

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "host", **args):
        sp = self.begin(name, cat, **args)
        try:
            yield sp
        finally:
            self.end(sp)

    def traced(self, name=None, cat: str = "host"):
        """Decorator form: @trace.traced() or @trace.traced("label")."""
        def deco(fn):
            label = name or getattr(fn, "__qualname__",
                                    getattr(fn, "__name__", "fn"))

            @functools.wraps(fn)
            def wrapper(*a, **kw):
                if not self._enabled:
                    return fn(*a, **kw)
                with self.span(label, cat=cat):
                    return fn(*a, **kw)

            return wrapper

        if callable(name):  # bare @traced usage
            fn, name = name, None
            return deco(fn)
        return deco

    def current_span(self):
        """Innermost open span name on this thread, or None."""
        stack = getattr(self._local, "stack", None)
        return stack[-1].name if stack else None

    # ------------------------- instants / frames -------------------------
    def instant(self, name: str, cat: str = "flight", **args) -> None:
        """Point event on the calling thread's track."""
        if not self._enabled:
            return
        self._append({"name": str(name), "cat": cat, "ph": "i", "s": "t",
                      "ts": round(self._now_us(), 3), "pid": self.pid,
                      "tid": self._tid(), "args": args})

    def frame(self, name: str, dur_us: float, track: str = "steps",
              ts_us=None, **args) -> None:
        """Step frame marker: a complete event on a synthetic per-run
        track.  ts defaults to `now - dur` (the caller reports a wall it
        just finished measuring)."""
        if not self._enabled:
            return
        dur_us = max(float(dur_us), 0.0)
        if ts_us is None:
            ts_us = self._now_us() - dur_us
        self._append({"name": str(name), "cat": "step", "ph": "X",
                      "ts": round(max(float(ts_us), 0.0), 3),
                      "dur": round(dur_us, 3), "pid": self.pid,
                      "tid": self.virtual_tid(track), "args": args})

    def counter(self, name: str, track: str = "counters", **series) -> None:
        """Numeric series sample ("C" event): series kwargs are the
        stacked values Perfetto plots."""
        if not self._enabled:
            return
        self._append({"name": str(name), "cat": "counter", "ph": "C",
                      "ts": round(self._now_us(), 3), "pid": self.pid,
                      "tid": self.virtual_tid(track), "args": series})

    # ------------------------------ export ------------------------------
    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def _metadata(self) -> list:
        meta = [{"name": "process_name", "ph": "M", "pid": self.pid,
                 "tid": 0, "args": {"name": "paddle_tpu"}}]
        with self._lock:
            names = dict(self._tid_names)
        for tid, name in sorted(names.items()):
            meta.append({"name": "thread_name", "ph": "M", "pid": self.pid,
                         "tid": tid, "args": {"name": name}})
            meta.append({"name": "thread_sort_index", "ph": "M",
                         "pid": self.pid, "tid": tid,
                         "args": {"sort_index": tid}})
        return meta

    def to_chrome(self) -> dict:
        """Chrome trace-event / Perfetto JSON object (json.dump-ready)."""
        return {
            "traceEvents": self._metadata() + self.events(),
            "displayTimeUnit": "ms",
            "otherData": {"schema": SCHEMA_VERSION, "pid": self.pid,
                          "wall_epoch": self.wall_epoch,
                          "dropped_events": self.dropped()},
        }

    def export(self, path: str) -> str:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, default=str)
        return path

    def dump_jsonl(self, path: str) -> str:
        """Append the buffer as chip-session-convention JSONL (one
        self-describing line per event, `phase`+`t` first) so trace
        events can interleave with step_stats / flight streams and
        `tools/analyze_chip_log.py` validates all three uniformly."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        t = time.strftime("%Y-%m-%dT%H:%M:%S")
        with open(path, "a") as f:
            for e in self.events():
                line = {"phase": TRACE_PHASE, "t": t}
                line.update(e)
                f.write(json.dumps(line, default=str) + "\n")
        return path


_default = SpanTracer()


def get_tracer() -> SpanTracer:
    return _default


# module-level conveniences bound to the default tracer — the form the
# instrumented call sites use (`trace.span("collective.all_reduce")`)
def span(name, cat="host", **args):
    return _default.span(name, cat=cat, **args)


def traced(name=None, cat="host"):
    return _default.traced(name, cat=cat)


def begin(name, cat="host", **args):
    return _default.begin(name, cat=cat, **args)


def end(sp):
    _default.end(sp)


def instant(name, cat="flight", **args):
    _default.instant(name, cat=cat, **args)


def frame(name, dur_us, track="steps", ts_us=None, **args):
    _default.frame(name, dur_us, track=track, ts_us=ts_us, **args)


def counter(name, track="counters", **series):
    _default.counter(name, track=track, **series)


def enable():
    _default.enable()


def disable():
    _default.disable()


def enabled():
    return _default.enabled()


def clear():
    _default.clear()


def events():
    return _default.events()


def to_chrome():
    return _default.to_chrome()


def export(path):
    return _default.export(path)


def dump_jsonl(path):
    return _default.dump_jsonl(path)


def current_span():
    return _default.current_span()


# ----------------------- stream validation -----------------------
#
# Pure functions over parsed JSONL entries, mirroring
# step_stats.validate_stream: tools/analyze_chip_log.py file-loads this
# module to get them — keep them stdlib-only.

_PHASES = {"X", "i", "C", "M", "B", "E"}


def validate_trace_stream(entries) -> list:
    """Schema errors for the trace_event entries in `entries` (non-trace
    entries are ignored — chip logs interleave phases).  Empty list =
    valid."""
    errors = []
    for i, e in enumerate(entries):
        if not isinstance(e, dict) or e.get("phase") != TRACE_PHASE:
            continue
        ph = e.get("ph")
        if ph not in _PHASES:
            errors.append(f"entry {i}: bad ph {ph!r}")
            continue
        if not isinstance(e.get("name"), str) or not e.get("name"):
            errors.append(f"entry {i}: missing/bad name")
        if ph != "M":
            ts = e.get("ts")
            if not isinstance(ts, (int, float)) or isinstance(ts, bool) \
                    or ts < 0:
                errors.append(f"entry {i}: missing/negative ts")
        for key in ("pid", "tid"):
            if ph != "M" and not isinstance(e.get(key), int):
                errors.append(f"entry {i}: missing int {key}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or isinstance(dur, bool) \
                    or dur < 0:
                errors.append(f"entry {i}: X event missing/negative dur")
    return errors


def summarize_trace_stream(entries) -> dict:
    """Digest of a trace_event stream: event counts by ph, span count and
    total/max span wall per name (top ones), distinct tracks."""
    spans = {}
    by_ph: dict = {}
    tids = set()
    for e in entries:
        if not isinstance(e, dict) or e.get("phase") != TRACE_PHASE:
            continue
        ph = e.get("ph")
        by_ph[ph] = by_ph.get(ph, 0) + 1
        if "tid" in e:
            tids.add(e["tid"])
        if ph == "X" and isinstance(e.get("dur"), (int, float)):
            rec = spans.setdefault(e.get("name", "?"), [0, 0.0, 0.0])
            rec[0] += 1
            rec[1] += float(e["dur"])
            rec[2] = max(rec[2], float(e["dur"]))
    out = {"events": sum(by_ph.values()), "by_ph": by_ph,
           "tracks": len(tids)}
    if spans:
        top = sorted(spans.items(), key=lambda kv: -kv[1][1])[:10]
        out["spans"] = {
            name: {"count": c, "total_us": round(tot, 1),
                   "max_us": round(mx, 1)}
            for name, (c, tot, mx) in top}
    return out
