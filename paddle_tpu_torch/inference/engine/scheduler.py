"""Continuous-batching scheduler: slots, admission, eviction.

The engine decodes at ONE fixed compiled batch shape (`max_slots`
sequence slots).  This scheduler decides, each engine step, which
sequence occupies which slot:

  * **admission** — waiting sequences enter freed slots FIFO, as soon
    as a slot AND enough pages for their prompt exist (no head-of-line
    blocking on the longest in-flight request: a finished sequence's
    slot is refilled on the very next step).
  * **completion** — a sequence that emitted eos / exhausted
    max_new_tokens (or was cancelled) releases its slot and pages at
    the next `schedule()`.
  * **eviction** — when the pool cannot cover every running sequence's
    next `chunk` tokens, the YOUNGEST running sequence (latest
    admission) is preempted back to the waiting queue's FRONT: its
    pages free immediately, and on re-admission it re-prefills from
    prompt + tokens-generated-so-far, which continues the greedy stream
    exactly (recompute-style preemption — deterministic, no KV
    snapshot).  Evicting the youngest keeps the oldest request's
    latency bound tight.
  * **prefix sharing** — with a `PrefixIndex` attached,
    admission looks up the longest cached page-aligned prefix of the
    prompt, takes pool references on the matched pages
    (`PagePool.share`), and allocates private pages only for the tail
    — the engine then prefills only `[shared_len, s0)`.  Under page
    pressure an LRU tier of refcount-IDLE cached prefixes is reclaimed
    FIRST (`PrefixIndex.evict_idle`), sitting between FIFO admission
    and youngest-first recompute eviction: cold cache always dies
    before live work.

The clock is injectable and ordering is decided by admission sequence
numbers, never wall time — the unit tests drive the whole policy
without sleeping.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque

import numpy as np

from .. import qos as _qos
from .paging import OutOfPages, PagePool, SCRATCH_PAGE

__all__ = ["Sequence", "Scheduler", "SchedulerOutput"]

_RANKS = tuple(_qos.class_rank(c) for c in _qos.CLASSES)

# sliding window over which per-tenant decode-slot-ms rates (the
# quota/fairness unit — same unit the TenantLedger bills) are averaged
_QUOTA_WINDOW_S = 10.0


def _parse_quotas(raw):
    """``class:slots`` pairs (comma-separated) → {class: float slots}.
    Malformed entries are dropped — a bad env var must not take the
    scheduler down."""
    out = {}
    for part in (raw or "").split(","):
        part = part.strip()
        if not part or ":" not in part:
            continue
        cls, _, val = part.rpartition(":")
        cls = _qos.normalize_class(cls)
        try:
            val = float(val)
        except ValueError:
            continue
        if cls is not None and val > 0:
            out[cls] = val
    return out

WAITING, RUNNING, FINISHED, CANCELLED = (
    "waiting", "running", "finished", "cancelled")


class Sequence:
    """One request's decode state (host view)."""

    _ids = itertools.count()

    def __init__(self, input_ids, max_new_tokens, eos_token_id=None,
                 request_id=None, arrived_at=0.0, tenant_id=None,
                 priority_class=None, deadline=None,
                 prebilled_tokens=0):
        ids = np.asarray(input_ids, np.int32).reshape(-1)
        if ids.size < 1:
            raise ValueError("empty prompt")
        self.prompt = ids
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        self.eos_token_id = (None if eos_token_id is None
                             else int(eos_token_id))
        self.request_id = request_id or f"seq-{next(self._ids)}"
        self.tenant_id = tenant_id   # who the ledger bills
        # what was promised: orders admission and picks
        # preemption victims; validate-or-drop to the default class
        self.priority_class = (_qos.normalize_class(priority_class)
                               or _qos.DEFAULT_CLASS)
        self.arrived_at = float(arrived_at)
        # absolute monotonic instant (scheduler clock) after which this
        # request is worthless to its client (ROADMAP 4):
        # admission sheds an already-expired sequence instead of
        # prefilling work nobody will wait for
        self.deadline = None if deadline is None else float(deadline)
        # mid-stream failover billing: the first N accepted
        # tokens were already billed by the replica that died — the
        # resume replica re-derives them (the divergence check's verify
        # token) but must not bill them again
        self.prebilled_tokens = max(0, int(prebilled_tokens))
        self._page_mark = None       # last page-seconds charge instant
        self.timeline = None       # optional RequestTimeline
        self.state = WAITING
        self.tokens = []           # accepted generated tokens
        self.pages = []            # live page ids (engine's pools)
        self.length = 0            # tokens materialized in the cache
        self.shared_len = 0        # cached-prefix tokens (page-aligned)
        self.shared_nodes = []     # matched PrefixIndex nodes (opaque)
        self.cache_state = None    # hit | partial | miss (at admission)
        self.slot = None
        self.last_token = None     # next decode step's input token
        self.admit_seqno = None    # ordering: eviction picks the max
        self.evictions = 0
        self.finish_reason = None
        self.handle = None         # engine-attached delivery sink

    # --- derived ------------------------------------------------------------
    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.tokens)

    @property
    def done(self) -> bool:
        return self.state in (FINISHED, CANCELLED)

    def resume_prompt(self) -> np.ndarray:
        """What a (re-)prefill must process: the original prompt plus
        everything already emitted — recompute preemption replays the
        stream deterministically."""
        if not self.tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)])

    def output_ids(self) -> np.ndarray:
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)])

    def __repr__(self):
        return (f"Sequence({self.request_id}, {self.state}, "
                f"len={self.length}, gen={len(self.tokens)}/"
                f"{self.max_new_tokens})")


class SchedulerOutput:
    """One schedule() decision: which sequences need a prefill this
    step, who is running, and who was preempted."""

    def __init__(self, prefills, running, evicted, finished):
        self.prefills = prefills   # newly admitted (pages allocated)
        self.running = running     # every live slot after admission
        self.evicted = evicted     # preempted back to waiting
        self.finished = finished   # released this schedule()


class Scheduler:
    def __init__(self, max_slots: int, pool: PagePool,
                 max_pages_per_seq: int, clock=time.monotonic,
                 prefix_index=None, decision_ring=None,
                 tenant_ledger=None, qos_age_s=None, quotas=None):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.max_slots = int(max_slots)
        self.pool = pool
        self.max_pages_per_seq = int(max_pages_per_seq)
        self.clock = clock
        self.prefix_index = prefix_index  # optional PrefixIndex
        # QoS policy knobs: aging bounds starvation (a
        # waiting sequence gains one rank per qos_age_s seconds), and
        # `quotas` caps a TENANT's decode-slot rate per class —
        # {"free": 2.0} = a free tenant may hold at most ~2 decode
        # slots averaged over the quota window; over-quota tenants are
        # admitted last and evicted first WITHIN their class
        # (work-conserving: slots never idle to enforce a quota)
        if qos_age_s is None:
            qos_age_s = float(os.environ.get(
                "PADDLE_TPU_QOS_AGE_S", "") or 30.0)
        self.qos_age_s = max(0.0, float(qos_age_s))
        if quotas is None:
            quotas = _parse_quotas(os.environ.get(
                "PADDLE_TPU_QOS_QUOTAS", ""))
        self.quotas = dict(quotas or {})
        self._slot_ms = {}         # tenant -> deque[(t, slot_ms)]
        # optional timeseries.DecisionRing: every admit /
        # evict-recompute / prefix-reclaim decision lands there with
        # the page pressure AT DECISION TIME, so a request's token gap
        # can be attributed to the co-scheduled work that caused it
        self.decisions = decision_ring
        # optional TenantLedger: the scheduler owns every
        # page-residency edge (admit / grow / evict / release), so it
        # is THE place KV page-seconds — ∫ page_count dt — integrate
        self.tenant_ledger = tenant_ledger
        self._lock = threading.RLock()
        self._waiting = deque()
        self._running = {}         # slot -> Sequence
        self._seqno = itertools.count()
        self._by_id = {}           # request_id -> Sequence (live only)

    # --- intake -------------------------------------------------------------
    def submit(self, seq: Sequence) -> None:
        max_len = self.max_pages_per_seq * self.pool.page_size
        need = seq.prompt.size + seq.max_new_tokens
        if need > max_len:
            raise ValueError(
                f"prompt+max_new_tokens = {need} exceeds the engine's "
                f"max sequence length {max_len} "
                f"({self.max_pages_per_seq} pages x "
                f"{self.pool.page_size})")
        with self._lock:
            if seq.request_id in self._by_id:
                raise ValueError(
                    f"duplicate request id {seq.request_id!r}")
            seq.arrived_at = self.clock()
            self._by_id[seq.request_id] = seq
            self._waiting.append(seq)

    def cancel(self, request_id) -> bool:
        """Mark a live sequence cancelled; its slot/pages release at the
        next schedule().  Returns False for unknown/finished ids."""
        with self._lock:
            seq = self._by_id.get(request_id)
            if seq is None or seq.done:
                return False
            seq.state = CANCELLED
            seq.finish_reason = "cancelled"
            return True

    def finish(self, seq: Sequence, reason: str) -> None:
        """Called by the engine when a running sequence completes."""
        with self._lock:
            if seq.done:
                return
            seq.state = FINISHED
            seq.finish_reason = reason

    # --- the per-step decision ----------------------------------------------
    def _decide(self, kind, **data):  # pt-lint: ok[PT101,PT102] (callers hold _lock)
        """One decision-ring entry, stamped with the pool pressure at
        decision time.  Guarded: the scheduler must schedule even when
        the observability plane is broken."""
        if self.decisions is None:
            return
        try:
            self.decisions.record(
                kind, pressure=round(self.pool.utilization(), 4),
                **data)
        except Exception:  # pt-lint: ok[PT005]
            pass           # (observability fan-out guard)

    # --- QoS accounting / ordering ------------------------------------------
    def note_decode_slot_ms(self, tenant_id, ms):
        """One decode step's slot occupancy for one tenant — the engine
        feeds this alongside the ledger's `record_decode_slot_ms`, so
        quotas and fairness are priced in the SAME decode-slot-ms unit
        the tenant is billed in."""
        with self._lock:
            q = self._slot_ms.get(tenant_id)
            if q is None:
                q = self._slot_ms[tenant_id] = deque()
            now = self.clock()
            q.append((now, float(ms)))
            horizon = now - _QUOTA_WINDOW_S
            while q and q[0][0] < horizon:
                q.popleft()

    def _slot_rate_locked(self, tenant_id):  # pt-lint: ok[PT101,PT102] (callers hold _lock)
        """Average decode slots this tenant held over the quota window
        (1.0 = one slot continuously busy for it)."""
        q = self._slot_ms.get(tenant_id)
        if not q:
            return 0.0
        now = self.clock()
        horizon = now - _QUOTA_WINDOW_S
        while q and q[0][0] < horizon:
            q.popleft()
        return sum(ms for _, ms in q) / (_QUOTA_WINDOW_S * 1e3)

    def _over_quota_locked(self, seq):  # pt-lint: ok[PT101,PT102] (callers hold _lock)
        quota = self.quotas.get(seq.priority_class)
        if quota is None or seq.tenant_id is None:
            return False
        return self._slot_rate_locked(seq.tenant_id) > quota

    def _eff_rank_locked(self, seq, now):  # pt-lint: ok[PT101,PT102] (callers hold _lock)
        """Class rank after starvation aging: +1 rank per `qos_age_s`
        waited seconds, capped at the top class — a batch sequence
        eventually outranks a steady paid stream in ADMISSION order
        (preemption stays on static rank: aging earns a slot, not the
        right to take someone else's)."""
        rank = _qos.class_rank(seq.priority_class)
        if self.qos_age_s <= 0:
            return rank
        waited = max(0.0, now - seq.arrived_at)
        return min(max(_RANKS), rank + int(waited / self.qos_age_s))

    def _admission_order_locked(self, now):  # pt-lint: ok[PT101,PT102] (callers hold _lock)
        """Waiting sequences in admission order: highest effective rank
        first, FIFO within a rank (a preempted sequence keeps its
        original arrival, so it resumes before newer same-class work),
        under-quota tenants before over-quota ones at equal rank, and
        weighted decode-slot fairness as the final tie-break (the
        tenant with the smallest usage-per-weight goes first)."""
        def key(pair):
            idx, seq = pair
            usage = self._slot_rate_locked(seq.tenant_id) \
                / _qos.class_weight(seq.priority_class)
            return (-self._eff_rank_locked(seq, now),
                    self._over_quota_locked(seq),
                    seq.arrived_at, round(usage, 6), idx)
        return [s for _, s in
                sorted(enumerate(self._waiting), key=key)]

    def _charge_pages_locked(self, seq):  # pt-lint: ok[PT101,PT102] (callers hold _lock)
        """Integrate page-seconds since the last charge at the CURRENT
        page count, and restart the integration window.  Called before
        any page-count change (grow/evict/release) and once per
        schedule() for every running sequence, so occupancy accrues
        continuously instead of materializing only at terminal edges.
        Guarded: metering must never fail a scheduling decision."""
        if self.tenant_ledger is None:
            return
        try:
            now = self.clock()
            if seq._page_mark is not None and seq.pages:
                self.tenant_ledger.record_page_seconds(
                    seq.tenant_id,
                    len(seq.pages) * (now - seq._page_mark))
            seq._page_mark = now
        except Exception:  # pt-lint: ok[PT005]
            pass           # (observability fan-out guard)

    def _release_locked(self, seq):  # pt-lint: ok[PT101,PT102] (callers hold _lock)
        self._charge_pages_locked(seq)
        seq._page_mark = None
        if seq.pages:
            self.pool.free(seq.pages)
            seq.pages = []
        if seq.slot is not None:
            self._running.pop(seq.slot, None)
            seq.slot = None
        self._by_id.pop(seq.request_id, None)

    def _pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.pool.page_size)

    def _target_pages(self, seq, tokens: int) -> int:
        """Pages a sequence needs to cover `tokens` cache positions,
        clamped to what it can EVER use: prompt + max_new_tokens (and
        the table width).  Without the total clamp, a decode_chunk
        reaching past the sequence's own finish line would demand pages
        for tokens that only ever land in the scratch page — and could
        evict (or refuse to admit) a sequence that actually fits."""
        total = seq.prompt.size + seq.max_new_tokens
        return min(self._pages_needed(min(tokens, total)),
                   self.max_pages_per_seq)

    def schedule(self, chunk: int = 1) -> SchedulerOutput:
        """One step's slot/page plan:

        1. release finished/cancelled sequences (slots + pages back),
        2. grow every running sequence's page span to cover `chunk`
           more tokens, evicting the youngest on pool pressure,
        3. admit waiting sequences FIFO into free slots while pages for
           prompt + first chunk exist.

        Admission after release in the same call: a completed sequence's
        slot serves a new request on the very next decode step."""
        with self._lock:
            finished = []
            for slot in list(self._running):
                seq = self._running[slot]
                if seq.done:
                    finished.append(seq)
                    self._release_locked(seq)
            # cancelled while still waiting: drop before admission
            drop = [s for s in self._waiting if s.done]
            for seq in drop:
                finished.append(seq)
                self._by_id.pop(seq.request_id, None)
            if drop:
                self._waiting = deque(
                    s for s in self._waiting if not s.done)

            evicted = []
            # 2. page headroom for the next `chunk` decode tokens; a
            # running seq writes positions [length, length+chunk)
            for slot in sorted(self._running):
                seq = self._running.get(slot)
                if seq is None or seq.slot is None:
                    continue  # evicted earlier in this pass
                # settle page-seconds at the OLD page count before any
                # growth this step (and once per step regardless — the
                # integral accrues continuously)
                self._charge_pages_locked(seq)
                while True:
                    target = self._target_pages(
                        seq, seq.length + max(1, int(chunk)))
                    need = target - len(seq.pages)
                    if need <= 0:
                        break
                    try:
                        seq.pages.extend(self.pool.alloc(need))
                        break
                    except OutOfPages:
                        # LRU tier first: reclaim refcount-idle cached
                        # prefixes before touching any live sequence
                        if self.prefix_index is not None:
                            got = self.prefix_index.evict_idle(need)
                            if got > 0:
                                self._decide(
                                    "prefix_reclaim", pages=got,
                                    requested=need,
                                    for_request=seq.request_id)
                                continue
                        # youngest-first preemption INCLUDING the
                        # growing sequence itself: when it is the
                        # youngest, it self-preempts rather than
                        # throwing away an older request's longer KV
                        victim = self._evict_youngest_locked()
                        if victim is None:
                            break  # nothing live to evict (can't happen
                            # while seq itself is live; belt-and-braces)
                        self._decide(
                            "evict_recompute",
                            request_id=victim.request_id,
                            for_request=seq.request_id,
                            generated=len(victim.tokens))
                        evicted.append(victim)
                        if victim is seq:
                            break

            # 3. priority-ordered admission into free slots: strict
            # priority with starvation aging, FIFO within a class
            # (pre-QoS this was plain FIFO, which the
            # single-class case still degenerates to).  A high-class
            # candidate that cannot get a slot or pages preempts the
            # lowest-class youngest running sequence via the SAME
            # recompute-eviction path pressure uses — the victim
            # resumes warm from the prefix cache, stream intact.
            prefills = []
            while self._waiting:
                now = self.clock()
                seq = self._admission_order_locked(now)[0]
                if seq.deadline is not None and now >= seq.deadline:
                    # engine-side deadline shed (ROADMAP 4): the budget
                    # expired while queued —
                    # prefilling now only steals pages from requests
                    # someone still wants.  Honest reason, counted.
                    self._waiting.remove(seq)
                    self._by_id.pop(seq.request_id, None)
                    seq.state = FINISHED
                    seq.finish_reason = "deadline_exceeded"
                    finished.append(seq)
                    self._decide("deadline_shed",
                                 request_id=seq.request_id,
                                 waited_s=round(now - seq.arrived_at, 4),
                                 **{"class": seq.priority_class})
                    if seq.timeline is not None:
                        seq.timeline.event("deadline_shed",
                                           waited_s=round(
                                               now - seq.arrived_at, 4))
                    try:
                        from ...observability import metrics as _metrics

                        _metrics.inc("resilience.shed_requests",
                                     reason="deadline_exceeded")
                    except Exception:  # pt-lint: ok[PT005]
                        pass           # (observability fan-out guard)
                    continue
                if len(self._running) >= self.max_slots:
                    victim = self._preempt_for_locked(seq)
                    if victim is None:
                        break  # nothing this candidate outranks
                    evicted.append(victim)
                prompt = seq.resume_prompt()
                shared_pages = self._lookup_prefix_locked(seq, prompt)
                need = self._target_pages(
                    seq, prompt.size + max(1, int(chunk))) \
                    - len(shared_pages)
                starved = False
                while not self.pool.can_alloc(need):
                    # LRU tier first (cold cache dies before live
                    # work), then policy preemption of lower classes
                    if self.prefix_index is not None:
                        got = self.prefix_index.evict_idle(
                            need - self.pool.free_pages)
                        if got > 0:
                            self._decide("prefix_reclaim", pages=got,
                                         requested=need,
                                         for_request=seq.request_id)
                            continue
                    victim = self._preempt_for_locked(seq)
                    if victim is not None:
                        evicted.append(victim)
                        continue
                    starved = True
                    break
                if starved:
                    # release the just-pinned prefix refs before
                    # refusing — nothing skips the chosen head
                    if shared_pages:
                        self.pool.free(shared_pages)
                        seq.shared_len = 0
                        seq.shared_nodes = []
                        seq.cache_state = None
                    break
                self._waiting.remove(seq)
                seq.pages = shared_pages + self.pool.alloc(need)
                seq._page_mark = self.clock()  # residency starts NOW
                seq.slot = self._free_slot_locked()
                seq.state = RUNNING
                seq.admit_seqno = next(self._seqno)
                self._running[seq.slot] = seq
                prefills.append(seq)
                self._decide("admit", request_id=seq.request_id,
                             cache_state=seq.cache_state or "miss",
                             shared_tokens=int(seq.shared_len or 0),
                             pages=len(seq.pages),
                             prompt_tokens=int(prompt.size),
                             evictions=seq.evictions)
                if seq.timeline is not None:
                    seq.timeline.event(
                        "admitted", slot=seq.slot,
                        pages=len(seq.pages),
                        cache_state=seq.cache_state or "miss")

            running = [self._running[s] for s in sorted(self._running)]
            return SchedulerOutput(prefills, running, evicted, finished)

    def _lookup_prefix_locked(self, seq, prompt):  # pt-lint: ok[PT101,PT102] (schedule holds _lock)
        """Cached-prefix lookup for one admission candidate: pins the
        matched pages with `PagePool.share` IMMEDIATELY (so a following
        `evict_idle` pressure reclaim can never free what this admission
        is about to use) and records the share on the sequence.  The
        share cap leaves at least one prompt token for the tail — the
        prefill must still produce the first generated token."""
        seq.shared_len = 0
        seq.shared_nodes = []
        seq.cache_state = None
        if self.prefix_index is None:
            return []
        max_share = min((int(prompt.size) - 1) // self.pool.page_size,
                        self.max_pages_per_seq)
        if max_share <= 0:
            seq.cache_state = "miss"
            return []
        shared_tokens, pages, nodes = self.prefix_index.lookup(
            prompt, max_share)
        if not pages:
            seq.cache_state = "miss"
            return []
        pages = self.pool.share(pages)
        seq.shared_len = int(shared_tokens)
        seq.shared_nodes = nodes
        seq.cache_state = "hit" if len(pages) == max_share else "partial"
        return pages

    def _free_slot_locked(self):  # pt-lint: ok[PT102] (callers hold _lock)
        for s in range(self.max_slots):
            if s not in self._running:
                return s
        raise RuntimeError("no free slot (scheduler invariant broken)")

    def _evict_youngest_locked(self, below_rank=None):  # pt-lint: ok[PT102] (callers hold _lock)
        """Class-aware recompute-eviction victim: the LOWEST class
        first (paid dies last), over-quota tenants before on-quota
        ones within a class, youngest admission within that — the
        pre-QoS youngest-first policy, applied per class.  With
        `below_rank`, only sequences of strictly lower class are
        eligible (policy preemption must never evict a peer)."""
        cands = [s for s in self._running.values() if not s.done]
        if below_rank is not None:
            cands = [s for s in cands
                     if _qos.class_rank(s.priority_class) < below_rank]
        if not cands:
            return None
        victim = max(cands, key=lambda s: (
            -_qos.class_rank(s.priority_class),
            self._over_quota_locked(s), s.admit_seqno))
        self._evict_locked(victim)
        return victim

    def _preempt_for_locked(self, seq):  # pt-lint: ok[PT101,PT102] (callers hold _lock)
        """Policy preemption: evict the lowest-class
        youngest RUNNING sequence so the strictly-higher-class `seq`
        can take its slot/pages — through the exact recompute-eviction
        path pressure uses, so the victim resumes warm from the prefix
        cache and its stream continues bit-identically.  Returns the
        victim or None (nothing outranked)."""
        rank = _qos.class_rank(seq.priority_class)
        victim = self._evict_youngest_locked(below_rank=rank)
        if victim is None:
            return None
        self._decide("evict_preempt", request_id=victim.request_id,
                     for_request=seq.request_id,
                     victim_class=victim.priority_class,
                     for_class=seq.priority_class,
                     generated=len(victim.tokens))
        try:
            from ...observability import metrics as _metrics

            _metrics.inc("qos.preemptions",
                         **{"class": victim.priority_class})
        except Exception:  # pt-lint: ok[PT005]
            pass           # (observability fan-out guard)
        return victim

    def _evict_locked(self, seq):  # pt-lint: ok[PT101,PT102] (callers hold _lock)
        self._charge_pages_locked(seq)
        seq._page_mark = None       # residency ends until re-admission
        self.pool.free(seq.pages)   # shared refs decrement; cache keeps
        seq.pages = []              # its own — re-admission re-shares
        self._running.pop(seq.slot, None)
        seq.slot = None
        seq.length = 0
        seq.shared_len = 0
        seq.shared_nodes = []
        seq.cache_state = None
        seq.last_token = None
        seq.state = WAITING
        seq.evictions += 1
        if seq.timeline is not None:
            seq.timeline.event("evicted", generated=len(seq.tokens))
        # FRONT of the queue: the preempted request resumes before
        # anything that arrived after it
        self._waiting.appendleft(seq)

    def release_finished(self) -> list:
        """Release every done running sequence NOW (slot + pages back to
        the pool) instead of waiting for the next schedule() — the
        engine calls this at the end of each step so a drained engine
        holds zero pages (the chaos scenario's leak assertion)."""
        with self._lock:
            released = []
            for slot in list(self._running):
                seq = self._running[slot]
                if seq.done:
                    released.append(seq)
                    self._release_locked(seq)
            return released

    # --- introspection ------------------------------------------------------
    @property
    def active_sequences(self) -> int:
        with self._lock:
            return len(self._running)

    @property
    def waiting_sequences(self) -> int:
        with self._lock:
            return len(self._waiting)

    def running_seqs(self) -> list:
        with self._lock:
            return [self._running[s] for s in sorted(self._running)]

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._running or self._waiting)

    def stats(self) -> dict:
        with self._lock:
            by_class = {c: {"running": 0, "waiting": 0}
                        for c in _qos.CLASSES}
            for s in self._running.values():
                by_class[s.priority_class]["running"] += 1
            for s in self._waiting:
                by_class[s.priority_class]["waiting"] += 1
            return {
                "running": len(self._running),
                "waiting": len(self._waiting),
                "max_slots": self.max_slots,
                "occupancy": len(self._running) / self.max_slots,
                "by_class": by_class,
            }
