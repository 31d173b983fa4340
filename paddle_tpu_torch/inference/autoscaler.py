"""SLO-driven fleet autoscaling: close the loop nobody closed.

The fleet (inference/fleet.py) load-balances a FIXED N replicas and
the SLOTracker (observability/slo.py) computes an error-budget burn
rate nobody acts on: a traffic step either sheds forever or idles
capacity.  The `Autoscaler` closes the
loop:

  * **signals** — the router's fleet-level SLO burn rate (`Router.slo`:
    edge sheds and unsaved failures burn budget there even when every
    replica's own ledger is clean) and the edge admission occupancy
    ((inflight+queued)/limit over both endpoint controllers).  Both
    already exist; the autoscaler only reads.
  * **scale up** on SUSTAINED burn (≥ `burn_up` for `up_sustain`
    consecutive ticks) or sustained occupancy above the high-water
    mark (`occ_up`): `fleet.add_replica()` — spawn, announce,
    readiness-gated into rotation by the router's probe loop.
  * **scale down** on sustained idle (occupancy ≤ `occ_down` AND burn
    below `burn_up` for `down_sustain` ticks):
    `fleet.remove_replica(rank)` — which routes EXCLUSIVELY through
    the zero-loss drain protocol (mark-draining → router in-flight →
    0 → SIGTERM → PreemptionGuard drain → exit 0).  The victim is the
    LEAST affinity-hot routable replica: draining the replica most
    prefix fingerprints are warm on would trade those tenants' TTFT
    for nothing (`Router.affinity_counts`).
  * **hysteresis** — the sustain streaks ask for consecutive evidence
    (one noisy probe can't flap the fleet), and a `cooldown_s` window
    after every action lets the last decision's effect land before
    the next is considered.  Replica count is clamped to
    [`min_replicas`, `max_replicas`] always.

Telemetry (attach() schema): `autoscaler.replicas{state=target|actual}`
gauges and `autoscaler.decisions{action=up|up_predictive|down|hold}`
counters, both visible in `/debug/telemetry` and the `telemetry_agg`
rollup next to `router.capacity{endpoint}`.  Every decision lands in `self.events`
(ordered, like `ReplicaFleet.events`) and as `autoscaler.*` flight
events.

  * **predictive scale-up** —
    burn is LAGGING by one SLO window: by the time the budget burns,
    the queue already ate the latency.  Every tick records occupancy
    and queue depth into a bounded `timeseries.TimeSeries` (the same
    injectable clock), and a SUSTAINED positive least-squares slope —
    occupancy growing ≥ `deriv_up`/s (or queue depth ≥
    `queue_deriv_up`/s) while occupancy is already past `deriv_floor`
    — fires a scale-up BEFORE the burn/occupancy thresholds cross,
    through the SAME sustain/cooldown machinery, counted as
    `autoscaler.decisions{action=up_predictive}` and logged as a
    `scale_up_predictive` event.  The first time burn crosses
    `burn_up` a `burn_threshold_crossed` event lands in the log, so
    the surge chaos can assert the predictive scale-up strictly
    preceded the burn-only trigger within one run.

Env knobs (read when the matching ctor arg is None):
  PADDLE_TPU_AUTOSCALE_MIN         lower replica bound           (1)
  PADDLE_TPU_AUTOSCALE_MAX         upper replica bound           (4)
  PADDLE_TPU_AUTOSCALE_COOLDOWN_S  post-action quiet window      (5.0)
  PADDLE_TPU_AUTOSCALE_BURN_UP     burn rate that demands growth (3.0)
  PADDLE_TPU_AUTOSCALE_OCC_UP      occupancy high-water mark     (0.8)
  PADDLE_TPU_AUTOSCALE_OCC_DOWN    occupancy idle mark           (0.2)
  PADDLE_TPU_AUTOSCALE_DERIV_UP    occupancy slope (1/s) that
                                   predicts saturation           (0.05)
  PADDLE_TPU_AUTOSCALE_QUEUE_DERIV_UP  queue-depth slope (req/s) (1.5)
  PADDLE_TPU_AUTOSCALE_DERIV_WINDOW_S  slope fit window          (5.0)
  PADDLE_TPU_AUTOSCALE_DERIV_FLOOR occupancy below which slopes
                                   are noise, never a signal     (0.3)

`burn_up` defaults to the SLO "ticket" rung (slo._BURN_SLOW): spending
a 30-day budget in ~10 days is the point where capacity — not a human
— should respond; the page rung (14.4) is far too late to start
scaling.  Clock and tick are injectable: tests drive `tick()` directly
under a fake clock (tests/test_autoscaler.py); `start()` runs the same
tick on a daemon thread every `interval` seconds.  The surge chaos
scenario (`tools/chaos_check.py --scenario surge`) proves the whole
loop absorbs a 10× open-loop traffic step with zero admitted-request
failures and drains back to min size with zero replayed tokens.
"""
from __future__ import annotations

import threading
import time

from ..observability import metrics as _metrics
from ..observability.timeseries import TimeSeries
from ..resilience.overload import _env_num

__all__ = ["Autoscaler"]


class Autoscaler:
    """Close the loop between the fleet's SLO/occupancy signals and its
    replica count.  See the module docstring for semantics; `tick()` is
    one decision, `start()`/`stop()` run it periodically."""

    def __init__(self, fleet, min_replicas=None, max_replicas=None,
                 burn_up=None, occ_up=None, occ_down=None,
                 up_sustain=2, down_sustain=6, cooldown_s=None,
                 interval=0.5, drain_grace=5.0, clock=time.monotonic,
                 deriv_up=None, queue_deriv_up=None,
                 deriv_window_s=None, deriv_floor=None):
        if min_replicas is None:
            min_replicas = _env_num("PADDLE_TPU_AUTOSCALE_MIN", 1, int)
        if max_replicas is None:
            max_replicas = _env_num("PADDLE_TPU_AUTOSCALE_MAX", 4, int)
        if cooldown_s is None:
            cooldown_s = _env_num("PADDLE_TPU_AUTOSCALE_COOLDOWN_S",
                                  5.0, float)
        if burn_up is None:
            burn_up = _env_num("PADDLE_TPU_AUTOSCALE_BURN_UP", 3.0,
                               float)
        if occ_up is None:
            occ_up = _env_num("PADDLE_TPU_AUTOSCALE_OCC_UP", 0.8, float)
        if occ_down is None:
            occ_down = _env_num("PADDLE_TPU_AUTOSCALE_OCC_DOWN", 0.2,
                                float)
        if deriv_up is None:
            deriv_up = _env_num("PADDLE_TPU_AUTOSCALE_DERIV_UP", 0.05,
                                float)
        if queue_deriv_up is None:
            queue_deriv_up = _env_num(
                "PADDLE_TPU_AUTOSCALE_QUEUE_DERIV_UP", 1.5, float)
        if deriv_window_s is None:
            deriv_window_s = _env_num(
                "PADDLE_TPU_AUTOSCALE_DERIV_WINDOW_S", 5.0, float)
        if deriv_floor is None:
            deriv_floor = _env_num("PADDLE_TPU_AUTOSCALE_DERIV_FLOOR",
                                   0.3, float)
        self.fleet = fleet
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self.burn_up = float(burn_up)
        self.occ_up = float(occ_up)
        self.occ_down = float(occ_down)
        self.up_sustain = max(1, int(up_sustain))
        self.down_sustain = max(1, int(down_sustain))
        self.cooldown_s = float(cooldown_s)
        self.interval = float(interval)
        self.drain_grace = float(drain_grace)
        self.clock = clock
        self.deriv_up = float(deriv_up)
        self.queue_deriv_up = float(queue_deriv_up)
        self.deriv_window_s = max(self.interval, float(deriv_window_s))
        self.deriv_floor = float(deriv_floor)
        # the predictive signal's memory: one frame per tick, bounded —
        # the timeseries plane under the same injectable clock
        self.timeseries = TimeSeries(capacity=256, clock=clock)
        self.events = []           # ordered decision log (tests assert)
        self.peak_replicas = 0     # high-water mark the surge gate reads
        self._target = None        # lazily initialised from the fleet
        self._up_streak = 0
        self._pred_streak = 0
        self._down_streak = 0
        self._burn_crossed = False
        self._last_action_t = None
        self._lock = threading.Lock()      # guards self.events only
        self._tick_lock = threading.Lock()  # serializes decisions
        self._stop = threading.Event()
        self._thread = None

    # ------------------------------------------------------------------
    # signals
    # ------------------------------------------------------------------
    def signals(self):
        """One read of the control inputs.  Burn = the worst windowed
        per-endpoint burn rate on the router's fleet-level SLO ledger;
        occupancy = the fuller of the two edge admission controllers,
        (inflight+queued)/limit — above 1.0 means the queue is eating
        into its depth."""
        router = self.fleet.router
        burn = 0.0
        paid_burn = 0.0
        report = router.slo.report(publish_gauges=False)
        for ep in report.get("endpoints", {}).values():
            if ep.get("requests"):
                burn = max(burn, float(ep.get("burn_rate") or 0.0))
            # the paid tier's OWN burn: measured against its
            # (usually tighter) class objective.  Under surge the
            # aggregate burn is dominated by deliberately-degraded
            # free/batch sheds — the fleet must still grow when the
            # PAID promise is the one burning.
            crep = (ep.get("classes") or {}).get("paid")
            if crep and crep.get("requests"):
                paid_burn = max(paid_burn,
                                float(crep.get("burn_rate") or 0.0))
        occupancy = 0.0
        queued = 0
        for ctl in (router.admission, router.gen_admission):
            st = ctl.stats()
            queued += int(st["queued"])
            occupancy = max(
                occupancy,
                (st["inflight"] + st["queued"]) / max(1, st["limit"]))
        # observed spawn->routable: what a scale-up actually
        # costs right now, measured by the fleet lifecycle plane from
        # completed spawns.  None until the first spawn completed;
        # getattr keeps duck-typed test fleets working unchanged.
        spawn_ms = getattr(self.fleet, "observed_spawn_ms", None)
        spawn_ms = spawn_ms() if callable(spawn_ms) else None
        if spawn_ms is not None:
            spawn_ms = round(float(spawn_ms), 3)
            _metrics.set_gauge("autoscaler.observed_spawn_ms", spawn_ms)
        return {
            "burn_rate": round(burn, 4),
            "paid_burn_rate": round(paid_burn, 4),
            "occupancy": round(occupancy, 4),
            "queue_depth": queued,
            "actual": self.fleet.replica_count(),
            "routable": router.routable_count(),
            "observed_spawn_ms": spawn_ms,
        }

    # ------------------------------------------------------------------
    # the decision
    # ------------------------------------------------------------------
    def tick(self):
        """One control-loop pass: read signals, update the sustain
        streaks, maybe act.  Returns the action taken ("up" | "down" |
        "hold").  Serialized by its own lock — a slow scale action (add
        blocks on announce, remove on drain) never overlaps the next
        tick's decision."""
        with self._tick_lock:
            return self._tick_locked()

    def _tick_locked(self):  # pt-lint: ok[PT102] (tick holds _tick_lock)
        sig = self.signals()
        actual = sig["actual"]
        if self._target is None:
            self._target = min(self.max_replicas,
                               max(self.min_replicas, actual))
        # feed the timeseries plane FIRST: the slopes below read the
        # frame this tick just recorded
        self.timeseries.record(
            {"occupancy": sig["occupancy"],
             "queue_depth": sig["queue_depth"],
             "burn_rate": sig["burn_rate"],
             "replicas": actual})
        d_occ = self.timeseries.derivative("occupancy",
                                           self.deriv_window_s)
        d_queue = self.timeseries.derivative("queue_depth",
                                             self.deriv_window_s)
        sig["d_occupancy"] = None if d_occ is None else round(d_occ, 4)
        sig["d_queue_depth"] = (None if d_queue is None
                                else round(d_queue, 4))
        if max(sig["burn_rate"], sig["paid_burn_rate"]) >= self.burn_up \
                and not self._burn_crossed:
            # the ordering witness the surge chaos asserts against: a
            # predictive scale-up logged BEFORE this event beat the
            # burn-only trigger within the same run
            self._burn_crossed = True
            self._event("burn_threshold_crossed", **sig)
        # paid-class burn is a first-class scale-up trigger:
        # the fleet grows FOR the paid tier — every decision event
        # carries `paid_burn_rate`, so the log shows which promise the
        # action defended
        wants_up = (sig["burn_rate"] >= self.burn_up
                    or sig["paid_burn_rate"] >= self.burn_up
                    or sig["occupancy"] >= self.occ_up)
        # the LEADING signal: pressure not yet over the bar, but
        # growing fast enough that it will be — fire while the launch
        # still lands ahead of the saturation, not one SLO window after
        wants_pred = (sig["occupancy"] >= self.deriv_floor
                      and ((d_occ is not None
                            and d_occ >= self.deriv_up)
                           or (d_queue is not None
                               and d_queue >= self.queue_deriv_up)))
        wants_down = (sig["burn_rate"] < self.burn_up
                      and sig["paid_burn_rate"] < self.burn_up
                      and sig["occupancy"] <= self.occ_down)
        self._up_streak = self._up_streak + 1 if wants_up else 0
        # threshold evidence counts toward the predictive streak too:
        # pressure crossing the bar is the strongest growth evidence
        self._pred_streak = (self._pred_streak + 1
                             if (wants_pred or wants_up) else 0)
        self._down_streak = self._down_streak + 1 if wants_down else 0
        now = self.clock()
        cooled = (self._last_action_t is None
                  or now - self._last_action_t >= self.cooldown_s)
        action = "hold"
        grow = None
        if actual < self.max_replicas and cooled:
            if wants_up and self._up_streak >= self.up_sustain:
                grow = "up"
            elif wants_pred and self._pred_streak >= self.up_sustain:
                grow = "up_predictive"
        if grow is not None:
            rank = self.fleet.add_replica()
            if rank is not None:
                action = grow
                self._target = min(self.max_replicas, actual + 1)
                self._last_action_t = self.clock()  # launch took time
                self._up_streak = 0
                self._pred_streak = 0
                self._event("scale_up" if grow == "up"
                            else "scale_up_predictive", rank=rank,
                            **sig)
            else:
                # the spawn/announce failed: back off for a cooldown
                # anyway — without this, sustained burn retries a full
                # launch cycle EVERY tick (a fork/kill hot loop that
                # wedges the tick thread inside launch timeouts)
                self._last_action_t = self.clock()
                self._event("scale_up_failed", **sig)
        elif (wants_down and self._down_streak >= self.down_sustain
                and actual > self.min_replicas and cooled):
            rank = self._pick_scale_down()
            removed = None if rank is None else \
                self.fleet.remove_replica(rank, grace=self.drain_grace)
            if removed is not None:
                action = "down"
                self._target = max(self.min_replicas, actual - 1)
                self._last_action_t = self.clock()  # drain took time
                self._down_streak = 0
                self._event("scale_down", rank=rank, **sig)
            elif rank is not None:
                # the rank vanished between the pick and the remove
                # (e.g. the monitor retired it): nothing was removed,
                # so this tick is a hold, not a phantom "down" — the
                # capacity drop already happened without us
                self._event("scale_down_raced", rank=rank, **sig)
        actual_now = self.fleet.replica_count()
        self.peak_replicas = max(self.peak_replicas, actual_now)
        _metrics.inc("autoscaler.decisions", action=action)
        _metrics.set_gauge("autoscaler.replicas", self._target,
                           state="target")
        _metrics.set_gauge("autoscaler.replicas", actual_now,
                           state="actual")
        return action

    def _pick_scale_down(self):
        """The scale-down victim: a ROUTABLE replica (never one already
        draining/ejected/down — those are not carrying capacity, and a
        second drain on them would race the first), least affinity-hot
        first; ties retire the newest rank, so the longest-lived
        replica keeps its warm caches.  None when nothing is safely
        removable this tick."""
        router = self.fleet.router
        ranks = {f"r{rank}": rank for rank in self.fleet.replica_ranks()}
        candidates = [rid for rid in router.routable_ids()
                      if rid in ranks]
        if not candidates:
            return None
        counts = router.affinity_counts()
        candidates.sort(
            key=lambda rid: (counts.get(rid, 0), -ranks[rid]))
        return ranks[candidates[0]]

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="paddle-tpu-autoscaler")
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception as e:  # pt-lint: ok[PT005]
                # the control loop must outlive one bad pass (a replica
                # racing teardown mid-signal-read); leave evidence
                self._event("tick_error",
                            error=f"{type(e).__name__}: {e}")

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(2.0, self.interval * 4))
        return True

    def describe(self):
        with self._lock:
            events = list(self.events)
        # decision state is owned by _tick_lock, not the events lock —
        # taken AFTER _lock is released, so no nesting edge
        with self._tick_lock:
            target = self._target
            peak = self.peak_replicas
        return {
            "min": self.min_replicas, "max": self.max_replicas,
            "target": target,
            "actual": self.fleet.replica_count(),
            "peak": peak,
            "burn_up": self.burn_up, "occ_up": self.occ_up,
            "occ_down": self.occ_down,
            "cooldown_s": self.cooldown_s,
            "deriv_up": self.deriv_up,
            "queue_deriv_up": self.queue_deriv_up,
            "deriv_window_s": self.deriv_window_s,
            "deriv_floor": self.deriv_floor,
            "d_occupancy": self.timeseries.derivative(
                "occupancy", self.deriv_window_s),
            "d_queue_depth": self.timeseries.derivative(
                "queue_depth", self.deriv_window_s),
            "events": events,
        }

    def _event(self, kind, **data):
        row = dict(data, kind=kind, t=time.time())
        with self._lock:
            self.events.append(row)
        try:
            from ..observability import flight as _flight

            _flight.record(f"autoscaler.{kind}", **data)
        except Exception:  # pt-lint: ok[PT005]
            pass           # (observability fan-out guard: scaling must
            # scale even when telemetry is broken)
