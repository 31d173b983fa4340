"""Serving admission control: bounded queue + concurrency limit +
deadline-aware load shedding (docs/RESILIENCE.md).

The front door of `inference/serving.py`: every request must pass an
`AdmissionController` BEFORE it can touch the predictor lock.  Without
one, overload has exactly one failure mode — requests pile up
unboundedly on the lock, all of them eventually time out together, and
the clients retry in a herd that keeps the server saturated forever.
With one, the server does bounded work and says "no" cheaply:

  * **concurrency limit** (`max_inflight`): at most this many requests
    run the predictor concurrently (the device executes one program at
    a time; extra concurrency only buys queue depth inside XLA).
  * **bounded wait queue** (`queue_depth`): at most this many requests
    wait for a slot; the next one is shed immediately (`queue_full`).
  * **deadline-aware shedding**: a request whose estimated completion
    time (queue ahead of it x observed latency / limit + its own
    service) already overruns its deadline is shed at the door instead
    of timing out after consuming a slot (`deadline`).
  * **AIMD adaptive limit**: when a `latency_target` is set, the
    observed per-request latency EWMA drives the live limit — latency
    over target multiplies the limit down (fast backoff under
    overload), a window of on-target completions adds 1 back (slow
    recovery), classic TCP-style AIMD bounded to
    [`min_limit`, `max_inflight`].
  * **draining**: `begin_drain()` flips the controller into shutdown
    mode — new and queued requests are shed (`draining`, HTTP 503),
    in-flight ones finish; `drain(timeout)` blocks until they have.
  * **QoS classes**: admission is class-aware.  The wait
    queue is partitioned by nested weighted shares (batch may occupy
    at most its share, free+batch theirs, paid the whole depth), the
    dequeue order is strict priority (paid > free > batch, FIFO within
    a class) with an aging knob that promotes a starved waiter one
    rank per `qos_age_s` so batch still eventually runs, a full queue
    sheds the lowest-class youngest waiter to make room for a
    higher-class arrival (shed lowest FIRST — never the paid request),
    and `Retry-After` scales by class so free/batch back off honestly
    longer under the same pressure estimate.

Every shed increments `resilience.shed_requests{reason=...}` (and
`qos.shed{class=...}`) and lands a flight instant; `serving.inflight` /
`serving.queue_depth` / `serving.admission_limit` gauges track the live
state.  Clock is injectable — tests run the whole machine without
wall-clock waits.

Env knobs (read when the matching ctor arg is None):
  PADDLE_TPU_MAX_INFLIGHT    concurrency limit        (default 4)
  PADDLE_TPU_QUEUE_DEPTH     bounded queue length     (default 16)
  PADDLE_TPU_QUEUE_TIMEOUT   max queue wait, seconds  (default 10)
  PADDLE_TPU_LATENCY_TARGET  AIMD latency target, seconds (default off)
  PADDLE_TPU_QOS_AGE_S       starvation aging: +1 rank per this many
                             queued seconds (default 30; 0 disables)
"""
from __future__ import annotations

import math
import os
import threading
import time

from ..inference import qos as _qos

__all__ = ["AdmissionController", "ShedError", "AdmissionTicket"]

_MAX_RANK = max(_qos.class_rank(c) for c in _qos.CLASSES)


def _env_num(var, default, cast):
    raw = os.environ.get(var)
    if raw is None or raw == "":
        return default
    try:
        return cast(raw)
    except ValueError:
        raise ValueError(f"{var} must parse as {cast.__name__}, "
                         f"got {raw!r}") from None


class ShedError(RuntimeError):
    """A request was refused at admission.  `reason` is one of
    `queue_full` / `queue_timeout` / `deadline` / `draining` (plus
    `no_replicas` at the fleet router's edge); `retry_after` is the
    server's estimate
    (seconds) of when retrying could succeed — serving surfaces it as
    an HTTP `Retry-After` header.  Overload sheds map to 429 (back off
    and retry), draining / no_replicas to 503 (this instance cannot
    serve you — retry elsewhere / later)."""

    def __init__(self, reason, retry_after=1.0, detail=""):
        super().__init__(
            f"request shed ({reason})" + (f": {detail}" if detail else ""))
        self.reason = str(reason)
        self.retry_after = max(0.0, float(retry_after))

    @property
    def http_status(self):
        return 503 if self.reason in ("draining", "no_replicas") else 429


class AdmissionTicket:
    """One admitted request's slot.  Context-manager form releases on
    exit with ok = no-exception; `release()` is idempotent.
    `queue_wait` is the seconds this request spent waiting for a slot —
    the "queue" phase of the request-trace breakdown."""

    __slots__ = ("_controller", "_start", "_released", "queue_wait")

    def __init__(self, controller, start, queue_wait=0.0):
        self._controller = controller
        self._start = start
        self._released = False
        self.queue_wait = float(queue_wait)

    def release(self, ok=True):
        if self._released:
            return
        self._released = True
        latency = self._controller.clock() - self._start
        self._controller._release(ok=ok, latency=latency)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release(ok=exc_type is None)
        return False


class _Waiter:
    """One queued request's QoS bookkeeping: its class/rank, when it
    enqueued (FIFO within a class + the aging promotion both read it),
    and whether a higher-class arrival displaced it out of a full
    queue (it sheds itself on wakeup)."""

    __slots__ = ("cls", "rank", "enq", "displaced")

    def __init__(self, cls, rank, enq):
        self.cls = cls
        self.rank = rank
        self.enq = enq
        self.displaced = False


class AdmissionController:
    def __init__(self, max_inflight=None, queue_depth=None,
                 queue_timeout=None, latency_target=None, min_limit=1,
                 ewma_alpha=0.3, decrease_factor=0.7, name="serving",
                 clock=time.monotonic, qos_age_s=None):
        if max_inflight is None:
            max_inflight = _env_num("PADDLE_TPU_MAX_INFLIGHT", 4, int)
        if queue_depth is None:
            queue_depth = _env_num("PADDLE_TPU_QUEUE_DEPTH", 16, int)
        if queue_timeout is None:
            queue_timeout = _env_num("PADDLE_TPU_QUEUE_TIMEOUT", 10.0, float)
        if latency_target is None:
            latency_target = _env_num("PADDLE_TPU_LATENCY_TARGET", 0.0,
                                      float) or None
        if qos_age_s is None:
            qos_age_s = _env_num("PADDLE_TPU_QOS_AGE_S", 30.0, float)
        self.max_inflight = max(1, int(max_inflight))
        self.queue_depth = max(0, int(queue_depth))
        self.queue_timeout = float(queue_timeout)
        self.latency_target = latency_target
        self.min_limit = max(1, min(int(min_limit), self.max_inflight))
        self.ewma_alpha = float(ewma_alpha)
        self.decrease_factor = float(decrease_factor)
        self.name = str(name)
        self.clock = clock
        self.qos_age_s = max(0.0, float(qos_age_s))
        self._cv = threading.Condition(threading.Lock())
        self._limit = self.max_inflight
        self._inflight = 0
        self._queued = 0
        self._waiters = []     # live _Waiter records (insertion order)
        self._draining = False
        self._ewma = None      # EWMA of observed request latency (s)
        self._good = 0         # on-target completions since last bump
        self._shed = {"queue_full": 0, "queue_timeout": 0,
                      "deadline": 0, "draining": 0}
        self._shed_by_class = {c: 0 for c in _qos.CLASSES}
        self._completed = 0
        self._failed = 0
        self._publish_gauges()

    # --- introspection ------------------------------------------------------
    @property
    def draining(self):
        with self._cv:
            return self._draining

    @property
    def limit(self):  # pt-lint: ok[PT102] (monitoring read: a stale
        # limit is a fine answer to "what is the limit right now")
        """The LIVE concurrency limit (AIMD moves it within
        [min_limit, max_inflight]; fixed at max_inflight otherwise)."""
        return self._limit

    def set_capacity(self, max_inflight):
        """Re-size the concurrency limit at runtime — the fleet router
        uses this to track live backend capacity (replicas ejected or
        re-admitted change how much work the edge may admit).  Without
        a `latency_target` the live limit follows the new capacity
        exactly; with AIMD active, the adjusted limit is clamped into
        the new [min_limit, max_inflight] band but otherwise keeps its
        learned value.  Waiters are woken: a capacity increase can
        admit a queued request immediately."""
        with self._cv:
            self.max_inflight = max(1, int(max_inflight))
            # keep the AIMD band non-empty: a shrink below min_limit
            # drags min_limit down with it (mirror of __init__), or
            # the clamp below would hold _limit ABOVE the new capacity
            self.min_limit = min(self.min_limit, self.max_inflight)
            if self.latency_target is None:
                self._limit = self.max_inflight
            else:
                self._limit = max(self.min_limit,
                                  min(self._limit, self.max_inflight))
            self._publish_gauges()
            self._cv.notify_all()

    def stats(self):
        with self._cv:
            queued_by_class = {c: 0 for c in _qos.CLASSES}
            for w in self._waiters:
                if not w.displaced:
                    queued_by_class[w.cls] += 1
            return {
                "inflight": self._inflight,
                "queued": self._queued,
                "limit": self._limit,
                "max_inflight": self.max_inflight,
                "queue_depth": self.queue_depth,
                "draining": self._draining,
                "ewma_latency": self._ewma,
                "completed": self._completed,
                "failed": self._failed,
                "shed": dict(self._shed),
                "queued_by_class": queued_by_class,
                "shed_by_class": dict(self._shed_by_class),
            }

    # --- QoS queue policy (callers hold _cv) --------------------------------
    def _class_cap_locked(self, rank):  # pt-lint: ok[PT102] (callers hold _cv)
        """Nested weighted partition cap for classes at-or-below
        `rank`: batch may occupy at most its weighted share of the
        queue, free+batch theirs, and the top class the whole depth —
        so a flood of low-class arrivals can never camp the queue a
        paid request needs."""
        total = sum(_qos.class_weight(c) for c in _qos.CLASSES)
        share = sum(_qos.class_weight(c) for c in _qos.CLASSES
                    if _qos.class_rank(c) <= rank)
        if share >= total:
            return self.queue_depth
        return min(self.queue_depth,
                   max(1, math.ceil(self.queue_depth * share / total)))

    def _effective_rank_locked(self, w, now):  # pt-lint: ok[PT102] (callers hold _cv)
        """Rank after aging: one rank per `qos_age_s` queued seconds,
        capped at the top — bounds starvation (a batch waiter
        eventually outranks a steady paid stream and runs)."""
        if self.qos_age_s <= 0:
            return w.rank
        return min(_MAX_RANK,
                   w.rank + int((now - w.enq) / self.qos_age_s))

    def _head_waiter_locked(self, now):  # pt-lint: ok[PT102] (callers hold _cv)
        """Strict-priority dequeue order: highest effective rank wins,
        FIFO within a rank."""
        best, best_key = None, None
        for w in self._waiters:
            if w.displaced:
                continue
            key = (self._effective_rank_locked(w, now), -w.enq)
            if best is None or key > best_key:
                best, best_key = w, key
        return best

    def _retry_after_locked(self, cls, base=None):  # pt-lint: ok[PT102] (callers hold _cv)
        """Class-aware backoff: the same pressure estimate, scaled so
        free/batch clients honestly wait longer before retrying than
        the paid tier they would otherwise race."""
        base = self._estimate_wait() if base is None else base
        return base * _qos.retry_after_factor(cls)

    # --- admission ----------------------------------------------------------
    def admit(self, deadline=None, priority_class=None):
        """Admit one request (blocking while the queue drains ahead of
        it) and return an `AdmissionTicket`, or raise `ShedError`.
        `deadline` is an absolute `clock()` instant the caller must
        finish by; admission refuses work it estimates cannot finish in
        time.  `priority_class` orders everything: queue partition,
        dequeue order, who gets displaced from a full queue, and the
        `Retry-After` a shed carries."""
        cls = _qos.normalize_class(priority_class) or _qos.DEFAULT_CLASS
        rank = _qos.class_rank(cls)
        with self._cv:
            if self._draining:
                self._shed_locked("draining", self._drain_retry_after(),
                                  cls=cls)
            # queue_full only applies to requests that would actually
            # have to queue — a free slot admits regardless of depth 0
            if self._inflight >= self._limit:
                cap = self._class_cap_locked(rank)
                while True:
                    active = [w for w in self._waiters if not w.displaced]
                    at_or_below = sum(1 for w in active if w.rank <= rank)
                    if len(active) < self.queue_depth and \
                            at_or_below < cap:
                        break
                    # full for this class: shed the lowest-class
                    # YOUNGEST waiter that this request outranks —
                    # lowest class degrades first, oldest work survives
                    victim = min(
                        (w for w in active if w.rank < rank),
                        key=lambda w: (w.rank, -w.enq), default=None)
                    if victim is None:
                        self._shed_locked(
                            "queue_full", self._retry_after_locked(cls),
                            cls=cls)
                    victim.displaced = True
                    self._cv.notify_all()
            est = self._estimate_wait()
            if deadline is not None and self.clock() + est > deadline:
                self._shed_locked(
                    "deadline", self._retry_after_locked(cls, est),
                    cls=cls,
                    detail=f"estimated completion {est:.3f}s past deadline")
            self._queued += 1
            waiter = _Waiter(cls, rank, self.clock())
            self._waiters.append(waiter)
            self._publish_gauges()
            wait_t0 = self.clock()
            qspan = None
            try:
                # queue_timeout bounds the head-of-line wait even when
                # the request's own deadline is laxer — whichever comes
                # first sheds (a 30s request deadline must not grant a
                # 30s queue camp when the operator capped waits at 1s)
                timeout_at = self.clock() + self.queue_timeout
                if deadline is not None:
                    timeout_at = min(timeout_at, deadline)
                while True:
                    if waiter.displaced:
                        self._shed_locked(
                            "queue_full", self._retry_after_locked(cls),
                            cls=cls,
                            detail="displaced by a higher-class arrival")
                    if self._draining:
                        self._shed_locked("draining",
                                          self._drain_retry_after(),
                                          cls=cls)
                    now = self.clock()
                    if self._inflight < self._limit and \
                            self._head_waiter_locked(now) is waiter:
                        break
                    remaining = timeout_at - now
                    if remaining <= 0:
                        if deadline is not None and now >= deadline:
                            # the request's own deadline was the
                            # binding bound: report the actionable
                            # reason, not a generic queue timeout
                            self._shed_locked(
                                "deadline",
                                self._retry_after_locked(cls), cls=cls,
                                detail="queue wait exhausted the deadline")
                        self._shed_locked(
                            "queue_timeout",
                            self._retry_after_locked(cls), cls=cls,
                            detail="queue wait exceeded the operator "
                                   "queue timeout")
                    if qspan is None:
                        # this request will actually wait: its queue
                        # camp is a span on the request trace (request
                        # id attached via the active RequestContext)
                        qspan = self._begin_queue_span()
                    self._cv.wait(remaining)
                self._inflight += 1
            finally:
                self._end_queue_span(qspan)
                self._queued -= 1
                try:
                    self._waiters.remove(waiter)
                except ValueError:
                    pass
                self._publish_gauges()
                # a shed waiter leaving the queue can be the drain()
                # waiter's last blocker — wake it to re-check; an
                # admitted head must also pass the baton to the next
                self._cv.notify_all()
            queue_wait = self.clock() - wait_t0
        return AdmissionTicket(self, self.clock(), queue_wait=queue_wait)

    def _release(self, ok, latency):
        with self._cv:
            self._inflight = max(0, self._inflight - 1)
            if ok:
                self._completed += 1
            else:
                self._failed += 1
            self._observe_locked(latency)
            self._publish_gauges()
            self._cv.notify_all()

    # --- load estimation / AIMD ---------------------------------------------
    def _estimate_wait(self):  # pt-lint: ok[PT102] (callers hold _cv)
        """Estimated time for a request admitted NOW to complete: the
        work ahead of it (queued + inflight) served at `limit`-way
        concurrency, plus its own service time — all at the observed
        latency EWMA.  Zero until the first completion (no evidence of
        slowness yet: admit optimistically, shed on facts)."""
        if not self._ewma:
            return 0.0
        ahead = self._queued + self._inflight
        return self._ewma * ahead / max(1, self._limit) + self._ewma

    def _drain_retry_after(self):
        # a draining instance never comes back; tell the client to try
        # another replica after roughly one service time
        return self._ewma if self._ewma else 1.0

    def _observe_locked(self, latency):  # pt-lint: ok[PT101,PT102] (callers hold _cv)
        if latency is None or latency < 0:
            return
        self._ewma = (latency if self._ewma is None else
                      (1.0 - self.ewma_alpha) * self._ewma
                      + self.ewma_alpha * latency)
        if self.latency_target is None:
            return
        if self._ewma > self.latency_target:
            new = max(self.min_limit,
                      int(math.floor(self._limit * self.decrease_factor)))
            if new < self._limit:
                self._limit = new
                self._good = 0
                self._note("resilience.admission_limit_decrease",
                           limit=new, ewma=round(self._ewma, 6))
        else:
            self._good += 1
            # additive increase once per limit-sized window of on-target
            # completions: recovery probes capacity slowly (AIMD)
            if self._good >= self._limit and self._limit < self.max_inflight:
                self._limit += 1
                self._good = 0
                self._note("resilience.admission_limit_increase",
                           limit=self._limit, ewma=round(self._ewma, 6))

    # --- drain ---------------------------------------------------------------
    def begin_drain(self):
        """Stop admitting: every new or queued request sheds with
        `draining`; in-flight requests keep their slots.  Idempotent."""
        with self._cv:
            if self._draining:
                return
            self._draining = True
            self._publish_gauges()
            self._cv.notify_all()
        self._note("resilience.drain_begin", name=self.name)

    def drain(self, timeout=None):
        """`begin_drain()` then block until no requests are in flight or
        queued (queued ones shed themselves as they wake).  Returns True
        when fully drained, False on timeout — the caller decides
        whether a hard stop is acceptable then."""
        if timeout is None:
            timeout = _env_num("PADDLE_TPU_DRAIN_TIMEOUT", 30.0, float)
        self.begin_drain()
        deadline = self.clock() + float(timeout)
        with self._cv:
            while self._inflight > 0 or self._queued > 0:
                remaining = deadline - self.clock()
                if remaining <= 0:
                    self._note("resilience.drain_timeout",
                               inflight=self._inflight,
                               queued=self._queued)
                    return False
                self._cv.wait(remaining)
        self._note("resilience.drain_complete", name=self.name)
        return True

    # --- observability (fan-out guarded: shedding must shed, not crash) -----
    def _begin_queue_span(self):
        """Open a `serving.queue` span carrying the active request's
        identity (request_trace contextvar) — the queue-wait phase of
        the per-request breakdown.  Guarded: a telemetry error must
        never turn a queue camp into a 500."""
        try:
            from ..observability import request_trace as _rtrace
            from ..observability import trace as _trace

            ctx = _rtrace.current()
            args = ctx.trace_args() if ctx is not None else {}
            return _trace.begin("serving.queue", cat="serving", **args)
        except Exception:  # pt-lint: ok[PT005]
            return None    # (observability fan-out guard, as below)

    @staticmethod
    def _end_queue_span(sp):
        if sp is None:
            return
        try:
            from ..observability import trace as _trace

            _trace.end(sp)
        except Exception:  # pt-lint: ok[PT005]
            pass           # (observability fan-out guard, as below)

    def _shed_locked(self, reason, retry_after, detail="", cls=None):  # pt-lint: ok[PT102] (callers hold _cv)
        self._shed[reason] = self._shed.get(reason, 0) + 1
        if cls is not None:
            self._shed_by_class[cls] = self._shed_by_class.get(cls, 0) + 1
        try:
            from ..observability import flight as _flight
            from ..observability import metrics as _metrics

            _metrics.inc("resilience.shed_requests", reason=reason)
            if cls is not None:
                _metrics.inc("qos.shed", **{"class": cls})
            _flight.record("resilience.request_shed", reason=reason,
                           retry_after=round(float(retry_after), 3),
                           inflight=self._inflight, queued=self._queued,
                           limit=self._limit,
                           **({"cls": cls} if cls else {}))
        except Exception:  # pt-lint: ok[PT005]
            pass           # (observability fan-out guard: a telemetry
            # error here would turn a cheap shed into a 500)
        raise ShedError(reason, retry_after=retry_after, detail=detail)

    def _publish_gauges(self):  # pt-lint: ok[PT102] (ctor + _cv holders)
        try:
            from ..observability import metrics as _metrics

            _metrics.set_gauge("serving.inflight", self._inflight)
            _metrics.set_gauge("serving.queue_depth", self._queued)
            _metrics.set_gauge("serving.admission_limit", self._limit)
        except Exception:  # pt-lint: ok[PT005]
            pass           # (observability fan-out guard, as above)

    def _note(self, kind, **data):
        try:
            from ..observability import flight as _flight

            _flight.record(kind, **data)
        except Exception:  # pt-lint: ok[PT005]
            pass           # (observability fan-out guard, as above)
