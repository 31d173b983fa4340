"""Replica lifecycle ledger: spawn-to-first-token phase attribution.

ROADMAP item 5 ("kill the cold start") needs a measurement before the
optimization: today the interval between `ReplicaFleet.add_replica()`
and the replica's first routable token is a black box, so the
autoscaler's predictive signal buys capacity of unknown latency.  This
module is that measurement plane.

Two sides, two clocks:

  * `LifecycleLedger` — lives INSIDE a replica process and stamps the
    phases that process can see on its OWN monotonic clock:

        proc_spawn -> imports -> weight_load -> warmup -> announce
                                        (-> first_token, much later)

    Per-program compile wall time (trace/lower vs compile, fed by
    `xla_cost.instrument`) lands in a bounded sub-ledger keyed by
    program label; compiles overflowing the cap fold into `~other` so
    labels stay bounded.

  * `FleetLifecycle` — lives in the SUPERVISOR process (ReplicaFleet)
    and stamps what only it can see, again on its own monotonic clock:

        spawn (Popen) -> announce (file observed) -> first_probe_up
                      -> first_routable_request

Clock-skew join rule: a duration is only ever computed between two
stamps taken by the SAME process's monotonic clock.  Cross-process
joins carry both wall anchors: the supervisor passes its spawn wall
time to the child via `PADDLE_TPU_SPAWN_WALL`, and the child back-dates
its `proc_spawn` stamp by the wall delta — so the child's `imports`
duration covers fork + interpreter start + package imports without
ever differencing two machines'/processes' monotonic clocks.  The
residual that neither side can attribute (announce-file detection lag,
wall skew) is reported honestly as `other`, clamped at zero.

Published metrics (bounded labels, declared at zero by `attach()`):

    lifecycle.phase_ms{phase=...}    gauge, ms of the just-closed phase
    lifecycle.compile_ms{program}    gauge, per-program + {program=~total}
    lifecycle.spawns                 counter
    lifecycle.double_stamps          counter (strict stamps are LOUD)

The full per-spawn records are served by `GET /debug/lifecycle` on
both serving and router, embedded in `/debug/telemetry` and exporter
dumps, and rolled up across processes by `tools/telemetry_agg.py` via
the pure helpers `join` / `validate_record` / `rollup_records`.

Knobs:
  PADDLE_TPU_LIFECYCLE_COMPILE_CAP  distinct program labels kept   (32)
  PADDLE_TPU_LIFECYCLE_HISTORY      per-fleet spawn records kept  (128)
  PADDLE_TPU_REPLICA_WARMUP         fleet: warm up before announce (1)

stdlib-only and file-loadable standalone (tools/telemetry_agg.py loads
this file without the package; sibling imports are guarded).
"""

from __future__ import annotations

import collections
import os
import threading
import time

__all__ = [
    "PHASES",
    "LifecycleLedger",
    "FleetLifecycle",
    "get_ledger",
    "reset",
    "join",
    "validate_record",
    "rollup_records",
]

# Canonical phase order, spawn to first emitted token.  proc_spawn is
# the anchor (zero-duration); everything after it closes a phase.
PHASES = (
    "proc_spawn",
    "imports",
    "weight_load",
    "warmup",
    "announce",
    "first_probe_up",
    "first_routable_request",
    "first_token",
)

# Phases stamped by the replica process itself, in its own ledger.
REPLICA_PHASES = ("proc_spawn", "imports", "weight_load", "warmup", "announce")

# Phases only the supervisor (fleet monitor / router) can observe.
SUPERVISOR_PHASES = ("announce", "first_probe_up", "first_routable_request")

_ORD = {p: i for i, p in enumerate(PHASES)}

SCHEMA = "lifecycle/v1"


def _metrics_module():
    """The metrics sibling, or None when file-loaded standalone."""
    try:
        from . import metrics  # type: ignore

        return metrics
    except ImportError:
        return None


def _flight_module():
    try:
        from . import flight  # type: ignore

        return flight
    except ImportError:
        return None


def compile_cap() -> int:
    try:
        return max(1, int(os.environ.get("PADDLE_TPU_LIFECYCLE_COMPILE_CAP", "32")))
    except ValueError:
        return 32


def history_cap() -> int:
    try:
        return max(1, int(os.environ.get("PADDLE_TPU_LIFECYCLE_HISTORY", "128")))
    except ValueError:
        return 128


class LifecycleLedger:
    """Per-process phase ledger.  One per replica process.

    `stamp()` is STRICT: stamping a phase twice keeps the first stamp,
    increments `lifecycle.double_stamps`, and drops a flight event —
    a silent re-stamp would quietly rewrite history.  Hot paths that
    legitimately race (first_token from concurrent requests) use
    `stamp_once()`, which is quiet first-wins.
    """

    def __init__(self, clock=None, wall=None):
        self._clock = clock or time.monotonic
        self._wall = wall or time.time
        self._lock = threading.Lock()
        self._stamps = {}  # phase -> (mono, wall)
        self._compiles = collections.OrderedDict()  # label -> dict
        self._double_stamps = 0
        self._begun = False

    # -- stamping -----------------------------------------------------

    def begin(self, spawn_wall=None):
        """Reset and stamp `proc_spawn`.

        `spawn_wall` is the supervisor's wall clock at Popen time
        (PADDLE_TPU_SPAWN_WALL).  When sane (0 <= delta < 1h) the
        proc_spawn stamp is back-dated by the wall delta so the
        `imports` phase covers fork + interpreter + package imports.
        """
        now_m, now_w = self._clock(), self._wall()
        anchor_m, anchor_w = now_m, now_w
        if spawn_wall is not None:
            try:
                delta = now_w - float(spawn_wall)
            except (TypeError, ValueError):
                delta = -1.0
            if 0.0 <= delta < 3600.0:
                anchor_m, anchor_w = now_m - delta, float(spawn_wall)
        with self._lock:
            self._stamps = {"proc_spawn": (anchor_m, anchor_w)}
            self._compiles = collections.OrderedDict()
            self._double_stamps = 0
            self._begun = True
        m = _metrics_module()
        if m is not None:
            m.inc("lifecycle.spawns")
        return anchor_w

    def _put(self, phase, strict):
        if phase not in _ORD:
            raise ValueError(f"unknown lifecycle phase: {phase!r}")
        now_m, now_w = self._clock(), self._wall()
        with self._lock:
            if not self._begun:
                # Stamping before begin(): anchor implicitly so the
                # ledger is never in an unusable state.
                self._stamps.setdefault("proc_spawn", (now_m, now_w))
                self._begun = True
            if phase in self._stamps:
                if strict:
                    self._double_stamps += 1
                    dup = True
                else:
                    return None
            else:
                dup = False
                self._stamps[phase] = (now_m, now_w)
                prev = self._prev_mono_locked(phase, now_m)
        if dup:
            m = _metrics_module()
            if m is not None:
                m.inc("lifecycle.double_stamps")
            f = _flight_module()
            if f is not None:
                try:
                    f.get_recorder().record("lifecycle.double_stamp", phase=phase)
                except Exception:  # pt-lint: ok[PT005]
                    pass           # (the double_stamps counter above IS
                    # the signal; a broken flight ring must not turn a
                    # loud-but-harmless re-stamp into a crash)
            return None
        m = _metrics_module()
        if m is not None:
            m.set_gauge("lifecycle.phase_ms", (now_m - prev) * 1e3, phase=phase)
        return now_m

    def _prev_mono_locked(self, phase, default):  # pt-lint: ok[PT102] (_put holds self._lock)
        """Monotonic time of the nearest earlier stamped phase."""
        best = None
        for p, (mono, _w) in self._stamps.items():
            if p != phase and _ORD[p] < _ORD[phase]:
                if best is None or _ORD[p] > best[0]:
                    best = (_ORD[p], mono)
        return best[1] if best is not None else default

    def stamp(self, phase):
        """Strict stamp: double-stamping is loud (counter + flight)."""
        return self._put(phase, strict=True)

    def stamp_once(self, phase):
        """Quiet first-wins stamp for legitimately racy phases."""
        return self._put(phase, strict=False)

    # -- compile sub-ledger -------------------------------------------

    def record_compile(self, program, lower_ms=0.0, compile_ms=0.0):
        """Attribute one trace/lower/compile to a program label.

        Bounded: past `compile_cap()` distinct labels, new programs
        fold into `~other`.  Publishes `lifecycle.compile_ms{program}`
        per label plus a `{program="~total"}` running sum.
        """
        label = str(program)
        with self._lock:
            if label not in self._compiles and len(self._compiles) >= compile_cap():
                label = "~other"
            e = self._compiles.setdefault(
                label, {"count": 0, "lower_ms": 0.0, "compile_ms": 0.0}
            )
            e["count"] += 1
            e["lower_ms"] += float(lower_ms)
            e["compile_ms"] += float(compile_ms)
            per_label = e["lower_ms"] + e["compile_ms"]
            total = sum(c["lower_ms"] + c["compile_ms"] for c in self._compiles.values())
        m = _metrics_module()
        if m is not None:
            m.set_gauge("lifecycle.compile_ms", per_label, program=label)
            m.set_gauge("lifecycle.compile_ms", total, program="~total")

    # -- snapshot -----------------------------------------------------

    def record(self) -> dict:
        """Serializable snapshot of this process's lifecycle."""
        with self._lock:
            stamps = dict(self._stamps)
            compiles = {k: dict(v) for k, v in self._compiles.items()}
            double = self._double_stamps
        anchor = stamps.get("proc_spawn")
        phases = {}
        for p in PHASES:
            if p in stamps:
                mono, wall = stamps[p]
                phases[p] = {
                    "mono_ms": (mono - anchor[0]) * 1e3 if anchor else 0.0,
                    "wall": wall,
                }
        durations = {}
        prev = None
        for p in PHASES:
            if p not in phases:
                continue
            if prev is not None:
                durations[p] = phases[p]["mono_ms"] - phases[prev]["mono_ms"]
            prev = p
        total = phases[prev]["mono_ms"] if prev is not None else 0.0
        return {
            "schema": SCHEMA,
            "pid": os.getpid(),
            "spawn_wall": anchor[1] if anchor else None,
            "phases": phases,
            "durations_ms": durations,
            "total_ms": total,
            "compiles": compiles,
            "compile_total_ms": sum(
                c["lower_ms"] + c["compile_ms"] for c in compiles.values()
            ),
            "double_stamps": double,
        }


class FleetLifecycle:
    """Supervisor-side spawn records, joined with replica ledgers.

    One per ReplicaFleet.  `spawn(rid)` opens a record (archiving any
    prior spawn of the same rid); the monitor/router stamp the phases
    only they can see; the router attaches the replica's own ledger
    record at first-probe-up so the joined record survives the replica
    being scaled back down.  Memory is bounded: at most
    `history_cap()` records total (active + archived), oldest evicted.
    """

    def __init__(self, clock=None, wall=None):
        self._clock = clock or time.monotonic
        self._wall = wall or time.time
        self._lock = threading.Lock()
        self._records = collections.OrderedDict()  # rid -> record
        self._archive = collections.deque(maxlen=history_cap())
        self._spawn_samples = collections.deque(maxlen=64)
        self._spawns = 0

    def spawn(self, rid, rank=None) -> float:
        """Open a spawn record; returns the wall anchor to pass to the
        child via PADDLE_TPU_SPAWN_WALL."""
        now_m, now_w = self._clock(), self._wall()
        with self._lock:
            old = self._records.pop(rid, None)
            if old is not None:
                self._archive.append(old)
            self._records[rid] = {
                "rid": rid,
                "rank": rank,
                "spawn_wall": now_w,
                "spawn_mono": now_m,
                "stamps": {},  # phase -> {"mono_ms", "wall"}
                "replica": None,
            }
            while len(self._records) > history_cap():
                self._records.popitem(last=False)
            self._spawns += 1
        m = _metrics_module()
        if m is not None:
            m.inc("lifecycle.spawns")
        return now_w

    def stamp(self, rid, phase) -> bool:
        """First-wins supervisor stamp; returns True if it landed."""
        now_m, now_w = self._clock(), self._wall()
        with self._lock:
            rec = self._records.get(rid)
            if rec is None or phase in rec["stamps"]:
                return False
            ms = (now_m - rec["spawn_mono"]) * 1e3
            rec["stamps"][phase] = {"mono_ms": ms, "wall": now_w}
            if phase == "first_probe_up":
                self._spawn_samples.append(ms)
        m = _metrics_module()
        if m is not None:
            m.set_gauge("lifecycle.phase_ms", ms, phase=phase)
        return True

    def attach_replica_record(self, rid, record) -> bool:
        """Durably attach the replica's own ledger record."""
        if not isinstance(record, dict):
            return False
        with self._lock:
            rec = self._records.get(rid)
            if rec is None:
                return False
            rec["replica"] = record
        return True

    def observed_spawn_ms(self):
        """Median observed spawn -> first_probe_up over recent spawns,
        or None before any spawn completed."""
        with self._lock:
            samples = sorted(self._spawn_samples)
        if not samples:
            return None
        return samples[len(samples) // 2]

    def records(self) -> list:
        """Joined records (active + archived), oldest first."""
        with self._lock:
            raw = list(self._archive) + list(self._records.values())
        return [join(r, r.get("replica")) for r in raw]

    def fleet_view(self) -> dict:
        recs = self.records()
        with self._lock:
            spawns = self._spawns
        return {
            "schema": SCHEMA,
            "spawns": spawns,
            "observed_spawn_ms": self.observed_spawn_ms(),
            "records": recs,
            "rollup": rollup_records(recs),
        }


# -- pure helpers (usable file-loaded, no package required) -----------


def join(sup_record, replica_record) -> dict:
    """Join a supervisor spawn record with the replica's own ledger.

    Durations never cross clocks: replica phases come from the replica
    record (whose proc_spawn anchor is already wall-joined), supervisor
    phases from supervisor stamps.  The unattributable residual is
    `other` (>= 0).
    """
    sup = sup_record or {}
    stamps = sup.get("stamps", {})
    out = {
        "schema": SCHEMA,
        "rid": sup.get("rid"),
        "rank": sup.get("rank"),
        "spawn_wall": sup.get("spawn_wall"),
        "supervisor_ms": {p: s["mono_ms"] for p, s in stamps.items()},
        "replica": replica_record,
        "phases_ms": {},
    }
    phases = dict(out["phases_ms"])
    rep = replica_record if isinstance(replica_record, dict) else None
    rep_durations = (rep or {}).get("durations_ms", {})
    for p in ("imports", "weight_load", "warmup", "announce"):
        if rep is not None:
            phases[p] = float(rep_durations.get(p, 0.0))
    if rep is not None:
        phases["compile"] = float(rep.get("compile_total_ms", 0.0))
    ann = stamps.get("announce", {}).get("mono_ms")
    fpu = stamps.get("first_probe_up", {}).get("mono_ms")
    if ann is not None and fpu is not None:
        phases["probe"] = fpu - ann
    if fpu is not None:
        out["total_ms"] = fpu
        if rep is not None:
            rep_span = (rep.get("phases", {}).get("announce") or {}).get("mono_ms")
            if rep_span is not None and "probe" in phases:
                phases["other"] = max(0.0, fpu - rep_span - phases["probe"])
    out["phases_ms"] = phases
    return out


def validate_record(joined) -> list:
    """Problems with one joined spawn record; [] means complete and
    monotone.  `compile` is an attribution overlay on `warmup`, not a
    timeline phase, so it is exempt from the >= 0 phase checks only in
    the sense that it must still be >= 0 like everything else."""
    problems = []
    if not isinstance(joined, dict):
        return ["not a dict"]
    sup_ms = joined.get("supervisor_ms", {})
    for p in ("announce", "first_probe_up"):
        if p not in sup_ms:
            problems.append(f"supervisor stamp missing: {p}")
    order = [p for p in PHASES if p in sup_ms]
    for a, b in zip(order, order[1:]):
        if sup_ms[b] < sup_ms[a]:
            problems.append(f"supervisor stamps not monotone: {a} -> {b}")
    rep = joined.get("replica")
    if not isinstance(rep, dict):
        problems.append("replica record missing")
    else:
        rphases = rep.get("phases", {})
        for p in REPLICA_PHASES:
            if p not in rphases:
                problems.append(f"replica phase missing: {p}")
        seq = [p for p in PHASES if p in rphases]
        for a, b in zip(seq, seq[1:]):
            if rphases[b].get("mono_ms", 0.0) < rphases[a].get("mono_ms", 0.0):
                problems.append(f"replica phases not monotone: {a} -> {b}")
        for p, d in rep.get("durations_ms", {}).items():
            if d < 0:
                problems.append(f"negative duration: {p} = {d:.3f}ms")
    for p, d in joined.get("phases_ms", {}).items():
        if d < 0:
            problems.append(f"negative joined phase: {p} = {d:.3f}ms")
    return problems


def _pct(sorted_vals, p):
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(p * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def rollup_records(joined_records) -> dict:
    """Percentiles per joined phase across spawns (p50/p95/max)."""
    by_phase = {}
    totals = []
    for r in joined_records or []:
        if not isinstance(r, dict):
            continue
        for p, d in r.get("phases_ms", {}).items():
            by_phase.setdefault(p, []).append(float(d))
        if "total_ms" in r:
            totals.append(float(r["total_ms"]))
    out = {"count": len(joined_records or []), "phases": {}}
    for p, vals in sorted(by_phase.items()):
        sv = sorted(vals)
        out["phases"][p] = {
            "count": len(sv),
            "p50": _pct(sv, 0.50),
            "p95": _pct(sv, 0.95),
            "max": sv[-1],
        }
    if totals:
        sv = sorted(totals)
        out["total_ms"] = {
            "count": len(sv),
            "p50": _pct(sv, 0.50),
            "p95": _pct(sv, 0.95),
            "max": sv[-1],
        }
    return out


# -- module default ledger (the replica process's one ledger) ---------

_LEDGER = LifecycleLedger()
_LEDGER_LOCK = threading.Lock()


def get_ledger() -> LifecycleLedger:
    with _LEDGER_LOCK:
        return _LEDGER


def reset() -> None:
    """Replace the process ledger (tests)."""
    global _LEDGER
    with _LEDGER_LOCK:
        _LEDGER = LifecycleLedger()
