"""Heartbeat hang watchdog (a copy of ``paddle_tpu/resilience/
watchdog.py``): detects a stalled training/serving loop and dumps the
evidence BEFORE the process is killed from outside.

A stalled collective or a wedged host loop looks identical from the
orchestrator: no step progress.  The watchdog turns that into a
diagnosable event — on stall it dumps the flight ring and exports the
Perfetto trace (the last thing every subsystem decided), bumps
`resilience.watchdog_trips`, runs the `on_stall` callback, and (when
`raise_in_main=True`) interrupts the main thread so the run dies with a
stack trace at the stall point instead of hanging until preemption.

Feeding: `watch_step_timer()` hooks `observability.step_stats` so every
StepTimer record beats the watchdog (zero changes at call sites), and
`beat()` is public for manual loops.
"""
from __future__ import annotations

import os
import threading
import time

__all__ = ["Watchdog", "WatchdogStall"]


class WatchdogStall(RuntimeError):
    pass


class Watchdog:
    def __init__(self, timeout=60.0, poll=None, on_stall=None,
                 dump_dir=None, raise_in_main=False, clock=time.monotonic,
                 name="train"):
        self.timeout = float(timeout)
        self.poll = float(poll) if poll is not None \
            else max(0.05, self.timeout / 10.0)
        self.on_stall = on_stall
        self.dump_dir = dump_dir
        self.raise_in_main = bool(raise_in_main)
        self.clock = clock
        self.name = str(name)
        self._lock = threading.Lock()
        self._last_beat = None
        self._stop = threading.Event()
        self._thread = None
        self._hook = None
        self.trips = 0
        self.last_dump = None

    # --- heartbeat ----------------------------------------------------------
    def beat(self):
        with self._lock:
            self._last_beat = self.clock()

    def watch_step_timer(self):
        """Beat on every StepTimer record (train/serve/bench loops feed
        the watchdog for free).  Returns self for chaining."""
        from ..observability import step_stats

        if self._hook is None:
            self._hook = lambda rec: self.beat()
            step_stats.add_record_hook(self._hook)
        return self

    # --- lifecycle (start/stop idempotent) ----------------------------------
    def start(self):
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._last_beat = self.clock()
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"resilience-watchdog-{self.name}")
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        # the handle swap happens under the same lock start() uses:
        # stop() racing start() must never join a thread start() is
        # still publishing (PT101 — the race the lint gate now catches)
        with self._lock:
            t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)
        with self._lock:
            # only retire the thread we stopped: a start() that ran
            # between the two lock sections published a NEW watchdog
            # that must not be orphaned here
            if self._thread is t:
                self._thread = None
        if self._hook is not None:
            try:
                from ..observability import step_stats

                step_stats.remove_record_hook(self._hook)
            except Exception:
                from ..observability import metrics as _metrics

                _metrics.inc("resilience.watchdog_unhook_errors")
            self._hook = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # --- stall detection ----------------------------------------------------
    def stalled_for(self):
        with self._lock:
            if self._last_beat is None:
                return 0.0
            return self.clock() - self._last_beat

    def _run(self):
        while not self._stop.wait(self.poll):
            age = self.stalled_for()
            if age > self.timeout:
                self._trip(age)
                # re-arm: a recovered loop (e.g. rollback + restart)
                # should be watchable again without a new Watchdog
                self.beat()

    def check(self):
        """Synchronous probe for host loops that poll instead of running
        the thread: raises WatchdogStall past the timeout."""
        age = self.stalled_for()
        if age > self.timeout:
            self._trip(age)
            raise WatchdogStall(
                f"watchdog {self.name!r}: no heartbeat for {age:.1f}s "
                f"(timeout {self.timeout}s)")

    def _trip(self, age):
        # pt-lint: ok[PT503] (monitoring counter: incremented by whichever thread detects the stall; a torn read is impossible for an int and a lost increment only undercounts evidence files)
        self.trips += 1
        dump_path = trace_path = None
        try:
            from ..observability import flight as _flight
            from ..observability import metrics as _metrics
            from ..observability import trace as _trace

            _metrics.inc("resilience.watchdog_trips")
            _flight.record("resilience.watchdog_trip", watchdog=self.name,
                           stalled_s=round(age, 3), timeout_s=self.timeout)
            import tempfile

            # default to tmp, not CWD: stall evidence must not litter
            # whatever directory the job happens to be running in
            d = self.dump_dir or os.environ.get(
                "PADDLE_TPU_WATCHDOG_DIR", tempfile.gettempdir())
            os.makedirs(d, exist_ok=True)
            tag = f"watchdog_{self.name}_{os.getpid()}_{self.trips}"
            dump_path = _flight.dump(os.path.join(d, tag + "_flight.jsonl"),
                                     reason=f"watchdog_stall:{age:.1f}s")
            if _trace.enabled() and _trace.events():
                trace_path = os.path.join(d, tag + "_trace.json")
                _trace.export(trace_path)
        except Exception as e:
            # evidence collection must never mask the stall — but a
            # silent evidence failure is its own black hole: say so on
            # stderr (the one channel that cannot have been the thing
            # that just failed)
            import sys

            print(f"[resilience] watchdog evidence dump failed: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
        # pt-lint: ok[PT503] (monitoring breadcrumb: single atomic tuple store, read only by humans/tests asking "where did the evidence go")
        self.last_dump = (dump_path, trace_path)
        if self.on_stall is not None:
            try:
                self.on_stall(age)
            except Exception:
                try:
                    from ..observability import metrics as _metrics

                    _metrics.inc("resilience.watchdog_callback_errors")
                except Exception:  # pt-lint: ok[PT005] (observability
                    pass           # fan-out guard: nothing left to tell)
        if self.raise_in_main:
            import _thread

            _thread.interrupt_main()
