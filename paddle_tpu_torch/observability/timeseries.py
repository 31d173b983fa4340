"""Time-series telemetry plane: rates, derivatives, and per-token
latency attribution.

Everything the registry (metrics.py) holds is a point-in-time value: a
counter says how many, never how fast; a gauge says where the queue is,
never where it is GOING.  This module adds the time dimension, bounded
by construction:

  * `TimeSeries` — a fixed-capacity ring of *frames* (one timestamped
    dict of name→value per sample) with the query math every consumer
    shares: `window()`, counter-aware reset-safe `rate()`, least-squares
    `derivative()` (the autoscaler's predictive signal), and a
    time-decayed `ewma()`.  O(capacity × names) memory, ever.
  * `TimeSeriesSampler` — a daemon that snapshots a DECLARED set of
    counters/gauges from the `MetricsRegistry` into a `TimeSeries` every
    `interval_s`.  Served on `GET /debug/timeseries` (serving + router),
    shipped incrementally in `TelemetryExporter` dumps (`frames_since`),
    merged fleet-wide by `tools/telemetry_agg.py` (per-process series,
    fleet-sum series, Perfetto counter tracks).
  * `RequestTimeline` — one request's latency story: admission → queue
    → prefill start/end → first token → per-decode-step token stamps
    (reservoir-bounded: past `PADDLE_TPU_ITL_TIMELINE_CAP` stamps the
    retained set decimates 2×, so memory stays O(cap) while coverage
    spans the whole stream) plus the top-K largest inter-token gaps
    with their timestamps — the stall evidence `GET /debug/requests/<id>`
    correlates against the scheduler's decision ring.
  * `DecisionRing` — the scheduler's bounded decision log: admit /
    evict-recompute / prefix-reclaim / defrag events with reason, seq
    ids, and page pressure at decision time.  `window(t0, t1)` answers
    "what did the scheduler do during THIS token gap".
  * `AnomalyDetector` — online rolling-baseline regression detection:
    the median of a recent window vs the median of the trailing
    baseline it displaces; a window median beyond `ratio`× the baseline
    fires a loud flight event + `telemetry.anomalies{kind}` counter
    (with a per-kind cooldown), so an ITL/TTFT cliff lands in telemetry
    before a human looks at a dashboard.  Steady noise stays silent: a
    persistent shift is absorbed into the baseline and stops firing.

Env knobs (read when the matching ctor arg is None):
  PADDLE_TPU_TIMESERIES_INTERVAL_S  sampler period (s)         (1.0)
  PADDLE_TPU_TIMESERIES_CAPACITY    frames kept per ring       (512)
  PADDLE_TPU_ITL_TIMELINE_CAP       token stamps per timeline  (256)
  PADDLE_TPU_ANOMALY_RATIO          window/baseline median bar (3.0)
  PADDLE_TPU_ANOMALY_WINDOW         recent-window length       (24)

stdlib-only on purpose (same contract as metrics.py): the engine's hot
path stamps timelines and the exporter ships frames without ever
paying a jax import.
"""
from __future__ import annotations

import collections
import os
import threading
import time

from . import metrics as _metrics

__all__ = [
    "TimeSeries", "TimeSeriesSampler", "RequestTimeline", "DecisionRing",
    "AnomalyDetector", "get_default_sampler", "set_default_sampler",
]

DEFAULT_INTERVAL_S = 1.0
DEFAULT_CAPACITY = 512
DEFAULT_TIMELINE_CAP = 256
DEFAULT_TOP_GAPS = 8


def _env_num(name, default, cast=float):
    # local on purpose (not resilience.overload._env_num): resilience
    # imports observability — this module importing it back would be a
    # package cycle
    raw = os.environ.get(name)
    if raw is None or str(raw).strip() == "":
        return default
    try:
        return cast(float(raw))
    except (TypeError, ValueError):
        return default


def _median(vals):
    return _metrics.quantile(sorted(vals), 0.5)


# ---------------------------------------------------------------------------
# the bounded series store + query math
# ---------------------------------------------------------------------------

class TimeSeries:
    """Fixed-capacity ring of frames.  A frame is one sampling instant:
    ``{"seq", "t" (monotonic), "wall", "values": {name: float}}``.
    Recording and every query take the ring lock — consumers are a
    ~1 Hz sampler and debug endpoints, not hot paths."""

    def __init__(self, capacity=None, clock=time.monotonic):
        if capacity is None:
            capacity = int(_env_num("PADDLE_TPU_TIMESERIES_CAPACITY",
                                    DEFAULT_CAPACITY, int))
        self.capacity = max(2, int(capacity))
        self.clock = clock
        self._lock = threading.Lock()
        self._frames = collections.deque(maxlen=self.capacity)
        self._seq = 0

    # -- recording --
    def record(self, values, t=None, wall=None) -> int:
        """Append one frame; returns its seq.  `values` is copied."""
        vals = {str(k): float(v) for k, v in dict(values).items()}
        with self._lock:
            self._seq += 1
            self._frames.append({
                "seq": self._seq,
                "t": float(t) if t is not None else float(self.clock()),
                "wall": float(wall) if wall is not None else time.time(),
                "values": vals,
            })
            return self._seq

    # -- raw access --
    def frames(self) -> list:
        with self._lock:
            return list(self._frames)

    def frames_since(self, seq: int) -> list:
        """Frames with seq > `seq` — the exporter's incremental cursor
        (concatenating one process's shipped frames replays its whole
        retained series)."""
        with self._lock:
            return [f for f in self._frames if f["seq"] > int(seq)]

    def names(self) -> list:
        seen = {}
        with self._lock:
            for f in self._frames:
                for k in f["values"]:
                    seen[k] = True
        return sorted(seen)

    def __len__(self) -> int:
        with self._lock:
            return len(self._frames)

    # -- queries --
    def window(self, name, secs=None) -> list:
        """[(t, value)] for `name` over the trailing `secs` (None = the
        whole retained ring), oldest first."""
        name = str(name)
        with self._lock:
            frames = list(self._frames)
        if not frames:
            return []
        cutoff = None if secs is None else frames[-1]["t"] - float(secs)
        out = []
        for f in frames:
            if cutoff is not None and f["t"] < cutoff:
                continue
            v = f["values"].get(name)
            if v is not None:
                out.append((f["t"], v))
        return out

    def latest(self, name):
        w = self.window(name, None)
        return w[-1][1] if w else None

    def rate(self, name, secs) -> float | None:
        """Counter rate over the trailing window, per second.
        COUNTER-AWARE and reset-safe (the Prometheus ``rate()``
        semantic): a sample below its predecessor means the process
        restarted — the post-reset value is the delta, not a negative.
        None when fewer than two samples cover the window."""
        w = self.window(name, secs)
        if len(w) < 2:
            return None
        elapsed = w[-1][0] - w[0][0]
        if elapsed <= 0:
            return None
        total = 0.0
        for (_, prev), (_, cur) in zip(w, w[1:]):
            d = cur - prev
            total += d if d >= 0 else cur
        return total / elapsed

    def derivative(self, name, secs) -> float | None:
        """Gauge slope over the trailing window, units per second —
        least-squares, so one noisy sample can't own the sign (the
        autoscaler's queue-growth predictive input).  None below two
        samples."""
        w = self.window(name, secs)
        if len(w) < 2:
            return None
        t0 = w[0][0]
        n = float(len(w))
        sx = sum(t - t0 for t, _ in w)
        sy = sum(v for _, v in w)
        sxx = sum((t - t0) ** 2 for t, _ in w)
        sxy = sum((t - t0) * v for t, v in w)
        denom = n * sxx - sx * sx
        if denom <= 0:
            return None
        return (n * sxy - sx * sy) / denom

    def ewma(self, name, secs, halflife=None) -> float | None:
        """Time-decayed exponential moving average over the trailing
        window (halflife defaults to secs/4): recent samples dominate
        without a sudden window edge."""
        w = self.window(name, secs)
        if not w:
            return None
        hl = float(halflife) if halflife else max(1e-9, float(secs) / 4.0)
        t_end = w[-1][0]
        num = den = 0.0
        for t, v in w:
            wgt = 0.5 ** ((t_end - t) / hl)
            num += wgt * v
            den += wgt
        return num / den if den > 0 else None

    def series(self, secs=None) -> dict:
        """{name: {"t": [...monotonic...], "wall": [...], "v": [...]}}
        over the trailing window — the /debug/timeseries body."""
        with self._lock:
            frames = list(self._frames)
        if not frames:
            return {}
        cutoff = None if secs is None else frames[-1]["t"] - float(secs)
        out: dict = {}
        for f in frames:
            if cutoff is not None and f["t"] < cutoff:
                continue
            for k, v in f["values"].items():
                s = out.setdefault(k, {"t": [], "wall": [], "v": []})
                s["t"].append(round(f["t"], 6))
                s["wall"].append(round(f["wall"], 6))
                s["v"].append(v)
        return out


# ---------------------------------------------------------------------------
# the registry sampler
# ---------------------------------------------------------------------------

class TimeSeriesSampler(TimeSeries):
    """Snapshot a declared set of registry counters/gauges into the
    ring every `interval_s`.

    A watched name matches its EXACT rendered snapshot key first
    (``engine.tokens``); a bare name with labeled series sums every
    label variant (``serving.requests`` = Σ over status) — the rollup
    shape rates/derivatives want.  Counters win over gauges on a name
    collision (rate() is the counter question).  Each `sample()` also
    publishes the `telemetry.timeseries_samples` health gauge: a
    flat-lined value is the sampler's own outage alarm."""

    def __init__(self, names=(), registry=None, interval_s=None,
                 capacity=None, clock=time.monotonic, name="sampler"):
        super().__init__(capacity=capacity, clock=clock)
        if interval_s is None:
            interval_s = _env_num("PADDLE_TPU_TIMESERIES_INTERVAL_S",
                                  DEFAULT_INTERVAL_S, float)
        self.interval_s = max(0.05, float(interval_s))
        self.watched = tuple(str(n) for n in names)
        self.registry = registry or _metrics.get_registry()
        # the health gauge's label: two samplers in one process (a
        # router AND a server) must not share one gauge, or a dead
        # sampling thread hides behind the live one's count
        self.name = str(name)
        self._samples = 0
        self._kinds: dict = {}     # name -> "counter" | "gauge"
        self._stop = threading.Event()
        self._thread = None

    @staticmethod
    def _resolve(name, table):
        """Exact key, else the sum of the name's label variants; None
        when the table carries neither."""
        v = table.get(name)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
        prefix = name + "{"
        total, hit = 0.0, False
        for k, tv in table.items():
            if k.startswith(prefix) and isinstance(tv, (int, float)) \
                    and not isinstance(tv, bool):
                total += float(tv)
                hit = True
        return total if hit else None

    def sample(self) -> dict:
        """One sampling pass: resolve every watched name against the
        registry snapshot, record the frame, publish health.  Returns
        the recorded values."""
        snap = self.registry.snapshot()
        counters = snap.get("counters", {})
        gauges = snap.get("gauges", {})
        values = {}
        kinds = {}
        for name in self.watched:
            v = self._resolve(name, counters)
            if v is not None:
                kinds[name] = "counter"
            else:
                v = self._resolve(name, gauges)
                if v is not None:
                    kinds[name] = "gauge"
            if v is not None:
                values[name] = v
        self.record(values)
        with self._lock:
            self._samples += 1
            self._kinds.update(kinds)
            n = self._samples
        self.registry.set_gauge("telemetry.timeseries_samples", n,
                                sampler=self.name)
        return values

    def stats(self) -> dict:
        with self._lock:
            n = self._samples
            kinds = dict(self._kinds)
            last = self._frames[-1] if self._frames else None
        return {
            "name": self.name,
            "interval_s": self.interval_s,
            "capacity": self.capacity,
            "samples": n,
            "frames": len(self),
            "watched": list(self.watched),
            "kinds": kinds,
            "last_age_s": (None if last is None
                           else round(self.clock() - last["t"], 3)),
        }

    def describe(self, secs=None) -> dict:
        """The /debug/timeseries body: health + full series + a
        convenience rate (COUNTER names only — reset-safe rate() over
        a falling gauge would fabricate positive throughput) and
        derivative (gauge names) per name over the last 30 s."""
        out = dict(self.stats())
        out["series"] = self.series(secs)
        kinds = out["kinds"]
        qsecs = 30.0 if secs is None else float(secs)
        out["rate_30s"] = {
            n: round(r, 6)
            for n in out["series"]
            if kinds.get(n) == "counter"
            and (r := self.rate(n, qsecs)) is not None}
        out["derivative_30s"] = {
            n: round(d, 6)
            for n in out["series"]
            if kinds.get(n) == "gauge"
            and (d := self.derivative(n, qsecs)) is not None}
        return out

    # -- lifecycle --
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="paddle-tpu-timeseries")
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.sample()
            except Exception:  # pt-lint: ok[PT005]
                pass           # (observability fan-out guard: one bad
                # snapshot pass must not kill the sampling thread)

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2)
        self._thread = None


# the process-default sampler: what TelemetryExporter ships frames from
_default_lock = threading.Lock()
_default_sampler = None


def set_default_sampler(sampler, force=False):
    """Register the process's exporter-visible sampler.  First one
    wins unless `force` — a replica process has exactly one server; a
    test harness hosting a router AND a server keeps the first."""
    global _default_sampler
    with _default_lock:
        if _default_sampler is None or force or sampler is None:
            _default_sampler = sampler
        return _default_sampler


def get_default_sampler():
    with _default_lock:
        return _default_sampler


# ---------------------------------------------------------------------------
# per-request latency attribution
# ---------------------------------------------------------------------------

class RequestTimeline:
    """One request's latency story, bounded by construction.

    Events (submitted / admitted / prefill_start / prefill_end /
    evicted / finished) are a short list; token stamps decimate 2×
    whenever they hit the cap (stride doubles, coverage stays
    whole-stream); the top-K largest inter-token gaps keep their exact
    (index, t_before, t_after) — the stall evidence the decision ring
    is queried against."""

    _EVENT_CAP = 64
    # kinds recorded even past the cap (once each, by nature): an
    # eviction-thrashed request — exactly what this endpoint exists to
    # explain — must never show as unfinished because its churn filled
    # the event list first
    _TERMINAL = ("finished",)

    def __init__(self, request_id, clock=time.monotonic,
                 token_cap=None):
        if token_cap is None:
            token_cap = int(_env_num("PADDLE_TPU_ITL_TIMELINE_CAP",
                                     DEFAULT_TIMELINE_CAP, int))
        self.request_id = str(request_id)
        self.clock = clock
        self.token_cap = max(4, int(token_cap))
        self.t0 = float(clock())
        self.wall0 = time.time()
        self._lock = threading.Lock()
        self._events = []          # [(t, kind, data)] — bounded
        self._stamps = []          # [(token_index, t)] — decimated
        self._stride = 1
        self._next_keep = 0
        self.n_tokens = 0
        self.first_token_t = None
        self._last_token_t = None
        self._gap_sum = 0.0
        self._gap_max = 0.0
        self._top_gaps = []        # [(gap_s, idx, t_prev, t_now)] top-K

    def _wall(self, t):
        return self.wall0 + (t - self.t0)

    def event(self, kind, **data) -> None:
        t = float(self.clock())
        kind = str(kind)
        with self._lock:
            if len(self._events) < self._EVENT_CAP \
                    or kind in self._TERMINAL:
                self._events.append((t, kind, dict(data)))
            elif self._events[-1][1] != "events_truncated":
                self._events.append((t, "events_truncated", {}))

    def token(self) -> None:
        """Stamp one accepted token (engine edge)."""
        t = float(self.clock())
        with self._lock:
            idx = self.n_tokens
            self.n_tokens += 1
            if idx == 0:
                self.first_token_t = t
            else:
                gap = t - self._last_token_t
                self._gap_sum += gap
                if gap > self._gap_max:
                    self._gap_max = gap
                self._note_gap_locked(gap, idx, self._last_token_t, t)
            self._last_token_t = t
            if idx >= self._next_keep:
                self._stamps.append((idx, t))
                self._next_keep = idx + self._stride
                if len(self._stamps) > self.token_cap:
                    # decimate: keep every other stamp, double the
                    # stride — memory halves, coverage stays end-to-end
                    self._stamps = self._stamps[::2]
                    self._stride *= 2

    def _note_gap_locked(self, gap, idx, t_prev, t_now):  # pt-lint: ok[PT102] (token holds _lock)
        top = self._top_gaps
        top.append((gap, idx, t_prev, t_now))
        top.sort(reverse=True)
        del top[DEFAULT_TOP_GAPS:]

    def describe(self) -> dict:
        """JSON-ready view: events, decimated stamps, gap stats, and
        the top gaps (each later annotated with co-scheduled decision
        events by `InferenceEngine.request_debug`)."""
        with self._lock:
            events = list(self._events)
            stamps = list(self._stamps)
            top = list(self._top_gaps)
            n = self.n_tokens
            first = self.first_token_t
            gap_sum, gap_max = self._gap_sum, self._gap_max
            stride = self._stride
        return {
            "request_id": self.request_id,
            "wall_start": round(self.wall0, 6),
            "tokens": n,
            "first_token_ms": (None if first is None
                               else round((first - self.t0) * 1e3, 3)),
            "itl_mean_ms": (round(gap_sum / (n - 1) * 1e3, 3)
                            if n > 1 else None),
            "itl_max_ms": round(gap_max * 1e3, 3) if n > 1 else None,
            "events": [{"t": round(t, 6),
                        "wall": round(self._wall(t), 6),
                        "offset_ms": round((t - self.t0) * 1e3, 3),
                        "kind": kind, **data}
                       for t, kind, data in events],
            "token_stamps": [{"token": i, "t": round(t, 6),
                              "offset_ms": round((t - self.t0) * 1e3, 3)}
                             for i, t in stamps],
            "token_stride": stride,
            "gaps": [{"token": idx, "gap_ms": round(g * 1e3, 3),
                      "t_start": round(tp, 6), "t_end": round(tn, 6),
                      "wall_start": round(self._wall(tp), 6)}
                     for g, idx, tp, tn in top],
        }

    def summary(self) -> dict:
        """The tiny per-request row /debug/telemetry and exporter dumps
        embed (full detail stays behind /debug/requests/<id>)."""
        d = self.describe()
        return {k: d[k] for k in ("request_id", "tokens",
                                  "first_token_ms", "itl_mean_ms",
                                  "itl_max_ms")}


# ---------------------------------------------------------------------------
# the scheduler decision ring
# ---------------------------------------------------------------------------

class DecisionRing:
    """Bounded ring of scheduler decisions (admit / evict_recompute /
    prefix_reclaim / defrag), each stamped with the scheduler clock and
    the page pressure at decision time.  `window(t0, t1)` is the
    correlation query behind /debug/requests/<id>: which co-scheduled
    work landed inside THIS token gap."""

    def __init__(self, capacity=512, clock=time.monotonic):
        self.capacity = max(8, int(capacity))
        self.clock = clock
        self._lock = threading.Lock()
        self._events = collections.deque(maxlen=self.capacity)
        self._seq = 0

    def record(self, kind, **data) -> dict:
        evt = dict(data)
        evt["kind"] = str(kind)
        evt["t"] = float(self.clock())
        evt["wall"] = time.time()
        with self._lock:
            self._seq += 1
            evt["seq"] = self._seq
            self._events.append(evt)
        return evt

    def events(self, limit=None) -> list:
        with self._lock:
            out = list(self._events)
        return out if limit is None else out[-int(limit):]

    def window(self, t0, t1, pad=0.0) -> list:
        lo, hi = float(t0) - float(pad), float(t1) + float(pad)
        with self._lock:
            return [dict(e) for e in self._events if lo <= e["t"] <= hi]

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


# ---------------------------------------------------------------------------
# online anomaly detection
# ---------------------------------------------------------------------------

class AnomalyDetector:
    """Rolling-baseline latency-regression watchdog.

    Per kind ("ttft", "itl", ...): observations fill a recent window;
    the values the window displaces become the trailing baseline.  When
    the window median exceeds ``ratio ×`` the baseline median (baseline
    mature: ≥ `min_baseline` samples), the detector fires ONCE per
    `cooldown_s`: `telemetry.anomalies{kind}` counter + a loud
    `telemetry.anomaly` flight event carrying both medians.  A cliff
    that persists is eventually absorbed into the baseline and stops
    firing — by then it IS the baseline, and the counter already told
    the story.  Steady noise never fires: medians are robust to
    outliers by construction."""

    def __init__(self, ratio=None, window=None, baseline=128,
                 min_baseline=32, cooldown_s=30.0,
                 clock=time.monotonic):
        if ratio is None:
            ratio = _env_num("PADDLE_TPU_ANOMALY_RATIO", 3.0, float)
        if window is None:
            window = int(_env_num("PADDLE_TPU_ANOMALY_WINDOW", 24, int))
        self.ratio = max(1.0, float(ratio))
        self.window = max(4, int(window))
        self.baseline = max(self.window, int(baseline))
        self.min_baseline = max(4, int(min_baseline))
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._state: dict = {}     # kind -> {recent, base, fired, ...}

    def _kind_locked(self, kind):  # pt-lint: ok[PT102] (observe holds _lock)
        st = self._state.get(kind)
        if st is None:
            st = self._state[kind] = {
                "recent": collections.deque(maxlen=self.window),
                "base": collections.deque(maxlen=self.baseline),
                "fired": 0,
                "last_fire_t": None,
                "observed": 0,
            }
        return st

    def observe(self, kind, value_ms) -> bool:
        """Feed one latency observation; returns True when this
        observation fired an anomaly."""
        kind = str(kind)
        v = float(value_ms)
        fire = None
        with self._lock:
            st = self._kind_locked(kind)
            st["observed"] += 1
            recent = st["recent"]
            if len(recent) == recent.maxlen:
                st["base"].append(recent[0])
            recent.append(v)
            if len(recent) < recent.maxlen \
                    or len(st["base"]) < self.min_baseline:
                return False
            med_w = _median(recent)
            med_b = _median(st["base"])
            if med_b is None or med_b <= 0 or med_w <= self.ratio * med_b:
                return False
            now = float(self.clock())
            last = st["last_fire_t"]
            if last is not None and now - last < self.cooldown_s:
                return False
            st["last_fire_t"] = now
            st["fired"] += 1
            fire = (med_w, med_b)
        _metrics.inc("telemetry.anomalies", kind=kind)
        try:
            from . import flight as _flight

            _flight.record("telemetry.anomaly", kind=kind,
                           window_median_ms=round(fire[0], 3),
                           baseline_median_ms=round(fire[1], 3),
                           ratio=round(fire[0] / fire[1], 2))
        except Exception:  # pt-lint: ok[PT005]
            pass           # (observability fan-out guard: the serving
            # hot path feeds this per token)
        return True

    def report(self) -> dict:
        out = {}
        with self._lock:
            for kind, st in sorted(self._state.items()):
                out[kind] = {
                    "observed": st["observed"],
                    "fired": st["fired"],
                    "window_median_ms": _median(st["recent"]),
                    "baseline_median_ms": _median(st["base"]),
                    "baseline_n": len(st["base"]),
                }
        return out
