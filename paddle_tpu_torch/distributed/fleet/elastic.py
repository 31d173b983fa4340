"""Elastic training: node registry, heartbeats, membership watch, restart.

Role parity: `ElasticManager`
(`python/paddle/distributed/fleet/elastic/manager.py:126`, SURVEY §2.5/§5)
— etcd node registry + heartbeats, fault-tolerance levels, watch+restart
loop, `--nnodes=min:max` scale range, and the exit-code protocol the
launcher understands.

A copy of the JAX package's module: the registry rides the port's
TCPStore (`distributed/store.py`, over `torch.distributed.TCPStore`)
instead of etcd; membership changes trigger the same local-pod restart
protocol.  The serving fleet (`inference/fleet.py`) uses its heartbeats
as a liveness signal next to process exit.
"""
from __future__ import annotations

import os
import signal
import threading
import time

# exit-code protocol (manager.py:32-39 parity)
ELASTIC_EXIT_CODE = 101          # relaunch me with a new world
ELASTIC_AUTO_PARALLEL_EXIT_CODE = 102


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


class ElasticLevel:
    FAULT_TOLERANCE = 1   # fixed world size, restart on failure
    ELASTIC = 2           # world may scale within [min, max]


class ElasticManager:
    def __init__(self, args=None, store=None, job_id=None, np_range=None,
                 heartbeat_interval=2.0, heartbeat_ttl=8.0):
        from ..store import TCPStore

        self.job_id = job_id or os.environ.get("PADDLE_JOB_ID", "default")
        rng = np_range or os.environ.get("PADDLE_ELASTIC_NP", "1")
        if isinstance(rng, str) and ":" in rng:
            lo, hi = rng.split(":")
            self.min_np, self.max_np = int(lo), int(hi)
        else:
            self.min_np = self.max_np = int(rng)
        self.elastic_level = (
            ElasticLevel.ELASTIC if self.max_np > self.min_np
            else ElasticLevel.FAULT_TOLERANCE)
        self.rank = int(os.environ.get("PADDLE_TRAINER_ID", 0))
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_ttl = heartbeat_ttl
        if store is not None:
            self.store = store
        else:
            master = os.environ.get("PADDLE_MASTER", "127.0.0.1:8476")
            host, port = master.split(":")
            self.store = TCPStore(host, int(port),
                                  is_master=(self.rank == 0))
        self._stop = threading.Event()
        self._thread = None
        self._membership_version = 0
        self.enabled = os.environ.get("PADDLE_ELASTIC_ENABLE",
                                      "1") not in ("0", "false")
        # heartbeat store traffic rides the resilience retry policy: a
        # transient TCPStore error (master restarting, tunnel blip) is
        # retried with backoff instead of silently dropping beats — and
        # a persistent one is COUNTED (resilience.giveups) while the
        # watch thread stays alive to beat again next interval
        from ...resilience.retry import RetryPolicy

        self._hb_retry = RetryPolicy(
            "elastic.heartbeat", max_attempts=3,
            base_delay=min(0.1, heartbeat_interval / 10.0),
            max_delay=max(0.25, heartbeat_interval / 2.0))
        self.missed_beats = 0
        self._done_marked = False
        self._telemetry_fn = None  # attach_telemetry(): digest provider

    # --- registry ------------------------------------------------------------
    def _hb_key(self, rank=None):
        r = self.rank if rank is None else rank
        return f"elastic/{self.job_id}/hb/{r}"

    def register(self):
        """Join the registry and start heartbeating (idempotent: a
        second register on a live manager is a no-op, and a register
        after exit() restarts the beat)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._hb_retry.call(self._set_heartbeat)
        self._thread = threading.Thread(target=self._beat, daemon=True,
                                        name="elastic-heartbeat")
        self._thread.start()

    def _set_heartbeat(self):
        from ...resilience import faults as _faults

        _faults.fire("store.op", op="heartbeat", rank=self.rank)
        self.store.set(self._hb_key(), str(time.time()))
        if self._telemetry_fn is not None:
            self._set_telemetry_digest()

    # --- telemetry digests ---------------------------------------------------
    def _tel_key(self, rank=None):
        r = self.rank if rank is None else rank
        return f"elastic/{self.job_id}/telemetry/{r}"

    def attach_telemetry(self, digest_fn):
        """Ride a small telemetry digest on every heartbeat:
        `digest_fn` is a zero-arg callable returning a JSON-friendly
        dict — typically `observability.export.TelemetryExporter
        .digest` — written next to this rank's heartbeat key, so
        `telemetry_digests()` answers "how is every live rank doing"
        from the store alone, with the freshness guarantee of the beat
        itself."""
        self._telemetry_fn = digest_fn
        return self

    def _set_telemetry_digest(self):
        import json as _json

        try:
            self.store.set(self._tel_key(),
                           _json.dumps(self._telemetry_fn(),
                                       default=str))
        except Exception:
            # the digest is best-effort cargo on the beat: losing it
            # must never cost the heartbeat (the retry policy would
            # re-raise and the rank would age out) — but count it
            try:
                from ...observability import metrics as _metrics

                _metrics.inc("fleet.telemetry_digest_errors")
            except Exception:  # pt-lint: ok[PT005]
                pass           # (observability fan-out guard: the
                # beat must go on through interpreter teardown)

    def telemetry_digests(self, scan_up_to=None):
        """{rank: digest dict} for every rank that published one —
        the live-fleet rollup view (`tools/telemetry_agg.py` reads the
        dump DIRECTORY for the full streams; this is the cheap
        store-side summary)."""
        import json as _json

        out = {}
        for r in range(scan_up_to if scan_up_to is not None
                       else self.max_np):
            try:
                raw = self.store.get(self._tel_key(r), timeout=0.5)
                out[r] = _json.loads(raw)
            except Exception:  # pt-lint: ok[PT005]
                continue       # absent key IS the signal: rank never
                # published (or its beat aged out with it)
        return out

    def _beat(self):
        while not self._stop.is_set():
            try:
                self._hb_retry.call(self._set_heartbeat)
            except Exception:
                # beats missed past the retry budget: the registry will
                # age this rank out after heartbeat_ttl — but the thread
                # MUST survive to resume beating if the store comes back
                # (a dead watch thread turns one transient blip into a
                # permanent eviction)
                self.missed_beats += 1
            self._stop.wait(self.heartbeat_interval)

    def alive_ranks(self, scan_up_to=None):
        """Ranks with fresh heartbeats, scanned over the FULL scale range
        (so joins beyond the current world — scale-out — are visible)."""
        now = time.time()
        alive = []
        for r in range(scan_up_to if scan_up_to is not None else self.max_np):
            try:
                ts = float(self.store.get(self._hb_key(r), timeout=0.5))
            except Exception:
                # an absent key IS the signal (rank not registered /
                # aged out) — but count the scan miss so a store that
                # errors on every rank is distinguishable from a world
                # that is genuinely down to one rank
                try:
                    from ...observability import metrics as _metrics

                    _metrics.inc("resilience.heartbeat_scan_misses")
                except Exception:  # pt-lint: ok[PT005]
                    pass           # (observability fan-out guard: the
                    # membership scan must survive interpreter teardown)
                continue
            if now - ts <= self.heartbeat_ttl:
                alive.append(r)
        return alive

    # --- watch ---------------------------------------------------------------
    def watch(self, world_size):
        """One membership check. Returns an ElasticStatus.

        After a RESTART the relaunched script must derive its NEW world from
        the registry (`len(alive_ranks())`), not from the stale
        PADDLE_TRAINERS_NUM env — the launcher restarts the local pod; the
        world resize happens at rendezvous.
        """
        alive = self.alive_ranks()
        n = len(alive)
        if n == world_size:
            return ElasticStatus.COMPLETED if self._job_done() \
                else ElasticStatus.HOLD
        if self.elastic_level == ElasticLevel.FAULT_TOLERANCE:
            # fixed world: any membership change means restart-and-rejoin;
            # the launcher's max_restart caps repeated failures
            self._membership_version += 1
            return ElasticStatus.RESTART
        if n >= self.min_np:
            # scale-in or scale-out within [min, max]: relaunch on the new
            # membership
            self._membership_version += 1
            return ElasticStatus.RESTART
        return ElasticStatus.ERROR

    def _job_done(self):
        try:
            return self.store.check(f"elastic/{self.job_id}/done")
        except Exception:
            return False

    def mark_done(self):
        self.store.set(f"elastic/{self.job_id}/done", "1")

    def exit(self, completed=True):
        """Stop heartbeating and (rank 0, completed=True) mark the job
        done.  Idempotent on BOTH effects independently: repeated
        exit()/stop() calls — launcher teardown racing a signal handler
        racing atexit — are safe, and a stop() followed by a genuine
        exit(completed=True) still marks done (the done-marker has its
        own once-guard, not the stop flag's)."""
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2)
        if t is None or t is threading.current_thread() \
                or not t.is_alive():
            self._thread = None
        # else: the beat thread is stuck in a blocked store call — KEEP
        # the handle so register() refuses to spawn a duplicate; _stop
        # stays set, so the orphan exits when the call finally returns
        if completed and self.rank == 0 and not self._done_marked:
            try:
                self.mark_done()
                self._done_marked = True
            except Exception as e:
                # an unmarked done means the other ranks will treat the
                # next membership change as a failure and restart — a
                # state worth a flight event, not a silent shrug
                try:
                    from ...observability import flight as _flight

                    _flight.record(
                        "resilience.elastic_mark_done_failed",
                        job_id=self.job_id,
                        error=f"{type(e).__name__}: {e}")
                except Exception:  # pt-lint: ok[PT005]
                    pass           # (observability fan-out guard:
                    # exit() runs in signal/atexit paths and must
                    # never raise)

    def stop(self):
        """Generic teardown (failure paths, signal handlers, atexit):
        stops heartbeating WITHOUT marking the job done — only an
        explicit exit(completed=True) may cancel the restart protocol
        for the other ranks."""
        self.exit(completed=False)

    shutdown = stop

    # --- preemption ----------------------------------------------------------
    def attach_preemption_guard(self, guard, install=True):
        """Cooperative preemption (docs/RESILIENCE.md): when `guard`
        (resilience.preemption.PreemptionGuard) trips, this rank STOPS
        heartbeating — it ages out of membership at heartbeat_ttl and
        the surviving ranks restart on the shrunk world — instead of
        the legacy hard `os._exit` that vanished mid-collective while
        its last fresh beat still advertised it alive.  The guard's
        exit_code is set to ELASTIC_EXIT_CODE so TrainingPreempted
        carries the launcher's relaunch protocol.  The training loop's
        safe point (DistributedTrainStep._check_preemption) does the
        checkpointing; this hook only handles membership."""
        if install:
            guard.install()
        guard.exit_code = ELASTIC_EXIT_CODE
        guard.on_preempt(self._on_preempt)
        self._preemption_guard = guard
        return guard

    def _on_preempt(self, reason):
        try:
            from ...observability import flight as _flight

            _flight.record("preemption.elastic_deregister",
                           job_id=self.job_id, rank=self.rank,
                           reason=reason)
        except Exception:  # pt-lint: ok[PT005]
            pass           # (observability fan-out guard: runs in
            # signal context — deregistration must still happen)
        self.stop()  # stop beating; TTL ages this rank out

    # --- restart protocol ----------------------------------------------------
    @staticmethod
    def request_relaunch():
        """Child signals the launcher: bring me back with a fresh world."""
        os._exit(ELASTIC_EXIT_CODE)

    @staticmethod
    def signal_handler(sig, frame):
        os._exit(ELASTIC_EXIT_CODE)

    def install_signal_handlers(self):
        """Legacy hard-exit handlers (immediate ELASTIC_EXIT_CODE, no
        checkpoint, no deregistration).  Prefer
        `attach_preemption_guard(PreemptionGuard())`: same relaunch
        protocol, but the training loop checkpoints at its next safe
        point and the rank leaves membership cleanly first."""
        signal.signal(signal.SIGTERM, self.signal_handler)
        signal.signal(signal.SIGINT, self.signal_handler)
