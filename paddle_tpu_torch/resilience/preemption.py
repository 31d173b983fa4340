"""Preemption-safe shutdown: SIGTERM/SIGINT guard + maintenance hook
(docs/RESILIENCE.md).

Preemptible VMs get a SIGTERM and a short grace window before the
machine disappears; maintenance events announce the same thing through
a metadata endpoint.  Both used to be process death: the signal either
killed Python outright or hit `ElasticManager.signal_handler`'s
`os._exit`, vanishing mid-collective with unsaved optimizer state and
in-flight serving requests.

`PreemptionGuard` turns the signal into a *cooperative* shutdown:

  * `install()` replaces the SIGTERM/SIGINT handlers with one that only
    TRIPS the guard (sets an event, counts the signal, fires registered
    callbacks) — no work happens in signal context beyond flag flips.
  * long-running loops poll `guard.check()` at their own safe points:
    the training step checkpoints through its `CheckpointManager` and
    raises `TrainingPreempted`; the serving loop flips to draining and
    exits after in-flight requests finish; the elastic manager stops
    heartbeating so the rank ages out of membership instead of holding
    a fresh beat while dead.
  * a pollable `maintenance_hook` (any callable returning truthy when a
    maintenance/preemption event is pending — e.g. a reader of the GCE
    metadata endpoint) feeds the same trip path, rate-limited to
    `maintenance_interval` seconds between polls.

The guard trips once: the first reason wins, later signals are counted
but do not re-fire callbacks.  `uninstall()` restores the previous
handlers (tests, nested runners).
"""
from __future__ import annotations

import signal
import threading
import time

__all__ = ["PreemptionGuard", "TrainingPreempted"]


class TrainingPreempted(Exception):
    """Raised by the training loop's safe point after the emergency
    checkpoint landed: the process should deregister and exit cleanly,
    and a restart resumes from `checkpoint_dir`.  `exit_code` carries
    the launcher protocol (ELASTIC_EXIT_CODE when an elastic manager
    wants a relaunch, 0 for a plain clean exit)."""

    def __init__(self, reason, checkpoint_dir=None, step=None, exit_code=0):
        msg = f"training preempted ({reason})"
        if checkpoint_dir is not None:
            msg += f"; resumable checkpoint at {checkpoint_dir}"
        super().__init__(msg)
        self.reason = reason
        self.checkpoint_dir = checkpoint_dir
        self.step = step
        self.exit_code = int(exit_code)


class PreemptionGuard:
    # what TrainingPreempted.exit_code should carry when THIS guard
    # trips a training loop; ElasticManager.attach_preemption_guard
    # sets it to ELASTIC_EXIT_CODE (relaunch-me protocol)
    exit_code = 0

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT),
                 maintenance_hook=None, maintenance_interval=5.0,
                 clock=time.monotonic):
        self.signals = tuple(signals)
        self.maintenance_hook = maintenance_hook
        self.maintenance_interval = float(maintenance_interval)
        self.clock = clock
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._reason = None
        self._callbacks = []
        self._prev_handlers = {}
        self._last_poll = None
        self._pending_signal = None  # written ONLY in signal context
        self._pending_lock = threading.Lock()

    # --- signal wiring -------------------------------------------------------
    def install(self):
        """Install the trip handler for `signals` (main thread only —
        CPython restriction), remembering the previous handlers.
        Idempotent; returns self for `guard = PreemptionGuard().install()`."""
        for sig in self.signals:
            if sig in self._prev_handlers:
                continue
            self._prev_handlers[sig] = signal.signal(sig, self._handler)
        return self

    def uninstall(self):
        """Restore the handlers `install()` replaced.  Idempotent."""
        while self._prev_handlers:
            sig, prev = self._prev_handlers.popitem()
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):  # pt-lint: ok[PT005]
                pass  # non-main thread / handler gone at teardown —
                # restoring is best-effort, never worth crashing exit

    def __enter__(self):
        return self.install()

    def __exit__(self, exc_type, exc, tb):
        self.uninstall()
        return False

    def _handler(self, signum, frame):
        try:
            name = signal.Signals(signum).name
        except ValueError:
            name = str(signum)
        # SIGNAL CONTEXT: CPython runs this on the main thread, which
        # may be interrupted while HOLDING the metrics/flight/admission
        # locks the trip path acquires — taking any of them here can
        # deadlock the process through its whole grace window.  Only a
        # GIL-atomic attribute write happens here; the actual trip
        # (counters, flight event, callbacks) runs on a helper thread,
        # with check()/preempted as the polling fallback.
        self._pending_signal = name  # pt-lint: ok[PT101] (signal
        # context MUST stay lock-free — GIL-atomic write; consumers
        # read-and-clear under _pending_lock in _process_pending)
        try:
            threading.Thread(target=self._process_pending,
                             name="preemption-trip",
                             daemon=True).start()
        except RuntimeError:  # pt-lint: ok[PT005]
            pass  # interpreter teardown / thread limit: the next
            # check()/preempted poll processes the pending signal

    def _process_pending(self):
        """Turn a handler-recorded signal into a full trip, OUTSIDE
        signal context (helper thread or a check()/preempted poll)."""
        with self._pending_lock:
            name, self._pending_signal = self._pending_signal, None
        if name is None:
            return
        try:
            from ..observability import metrics as _metrics

            _metrics.inc("preemption.signals", signal=name)
        except Exception:  # pt-lint: ok[PT005]
            pass           # (observability fan-out guard: counting
            # must never mask the trip itself)
        self.trip(f"signal:{name}")

    # --- trip / poll ---------------------------------------------------------
    def trip(self, reason):
        """Flip the guard (idempotent; first reason wins) and fire the
        registered callbacks exactly once.  Callbacks run in the
        tripping thread and are individually guarded — one failing must
        not starve the rest of their shutdown notice."""
        with self._lock:
            if self._reason is not None:
                return
            reason = self._reason = str(reason)
            callbacks = list(self._callbacks)
        self._event.set()
        try:
            from ..observability import flight as _flight

            _flight.record("preemption.tripped", reason=reason)
        except Exception:  # pt-lint: ok[PT005]
            pass           # (observability fan-out guard, as above)
        for cb in callbacks:
            self._run_callback(cb, reason)

    def _run_callback(self, cb, reason):
        try:
            cb(reason)
        except Exception as e:
            try:
                from ..observability import flight as _flight
                from ..observability import metrics as _metrics

                _metrics.inc("preemption.callback_errors")
                _flight.record("preemption.callback_error",
                               callback=getattr(cb, "__name__", repr(cb)),
                               error=f"{type(e).__name__}: {e}")
            except Exception:  # pt-lint: ok[PT005]
                pass           # (observability fan-out guard, as above)

    def on_preempt(self, cb):
        """Register `cb(reason)` to run when the guard trips.  A
        callback registered after the trip runs immediately — late
        subscribers (a server started during shutdown) still drain."""
        with self._lock:
            reason = self._reason
            if reason is None:
                self._callbacks.append(cb)
        if reason is not None:
            self._run_callback(cb, reason)
        return cb

    @property
    def preempted(self):
        if self._pending_signal is not None:  # pt-lint: ok[PT102]
            # (lock-free probe; _process_pending re-checks under lock)
            self._process_pending()  # helper thread lost the race/died
        return self._event.is_set()

    @property
    def reason(self):
        with self._lock:
            return self._reason

    def check(self):
        """Pollable safe-point probe: polls the maintenance hook (rate
        limited) and returns whether the guard has tripped.  This is
        what `DistributedTrainStep` calls between dispatches."""
        if self._pending_signal is not None:  # pt-lint: ok[PT102]
            # (lock-free probe; _process_pending re-checks under lock)
            self._process_pending()
        if not self._event.is_set() and self.maintenance_hook is not None:
            now = self.clock()
            if self._last_poll is None or \
                    now - self._last_poll >= self.maintenance_interval:
                self._last_poll = now
                try:
                    pending = self.maintenance_hook()
                except Exception as e:
                    pending = None
                    try:
                        from ..observability import flight as _flight

                        _flight.record("preemption.maintenance_poll_error",
                                       error=f"{type(e).__name__}: {e}")
                    except Exception:  # pt-lint: ok[PT005]
                        pass           # (observability fan-out guard)
                if pending:
                    try:
                        from ..observability import metrics as _metrics

                        _metrics.inc("preemption.maintenance_events")
                    except Exception:  # pt-lint: ok[PT005]
                        pass           # (observability fan-out guard)
                    self.trip(f"maintenance:{pending}")
        return self._event.is_set()

    def wait(self, timeout=None):
        """Block until the guard trips (serving main loops park here).
        Polls the signal-pending flag so a trip still lands even when
        the handler's helper thread could not spawn."""
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        while True:
            if self._pending_signal is not None:  # pt-lint: ok[PT102]
                # (lock-free probe; re-checked under _pending_lock)
                self._process_pending()
            if deadline is None:
                remaining = 0.1
            else:
                remaining = min(0.1, deadline - time.monotonic())
                if remaining <= 0:
                    return self._event.is_set()
            if self._event.wait(remaining):
                return True
