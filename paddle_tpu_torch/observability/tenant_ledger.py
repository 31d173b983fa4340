"""Per-tenant metering: a bounded-cardinality resource ledger.

ROADMAP item 4 (multi-tenant QoS) needs the stack to answer "which
tenant consumed what" before any priority/quota policy can exist.  The
population is millions of tenants (PAPERS.md's shared-prefix serving
workload), so per-tenant METRIC LABELS are a cardinality bomb — one
`tenant.requests{tenant=...}` counter per distinct id would grow the
registry (and every Prometheus scrape) without bound.  This module is
the alternative: a `TenantLedger` tracks the top-K heavy hitters
EXACTLY like Space-Saving [Metwally et al. 2005] tracks frequencies,
folds everyone else into an honest `~other` bucket, and maintains an
explicit conservation invariant:

    for every metered field:  Σ tracked tenants + other == totals

so a million distinct tenants cost O(K) memory and the books still
balance to the global counters.  What is metered, per tenant:

  * `requests`              by status (ok / shed / client_error / error)
  * `prefill_tokens`        prompt tokens actually computed at prefill
  * `prefill_saved_tokens`  prompt tokens served from the prefix cache
                            instead (prefix-cache hits, attributed to the
                            tenants they benefit)
  * `decode_tokens`         accepted decode tokens
  * `decode_slot_ms`        wall-milliseconds of decode-slot occupancy
  * `kv_page_seconds`       ∫ page_count dt over each sequence's
                            residency (admission → eviction/release)

Space-Saving semantics: the table holds at most K entries.  A new
tenant arriving at a full table REPLACES the minimum-weight entry; the
newcomer inherits the victim's weight as its over-estimate bound
(`err`), and the victim's EXACT counts fold into `~other` — so counts
conserve (nothing is dropped), while `weight`/`err` carry the classic
top-K guarantee (any tenant with true weight > err is in the table).
`weight` grows by 1 per request + 1 per token, the units the ledger
exists to attribute.

Engine-token coherence: `record_decode()` increments the global
`engine.tokens` counter INSIDE the ledger lock (the call site skips
its own increment when a ledger is wired), and `snapshot()` reads the
counter back under the same lock — so a snapshot's
`metrics_engine_tokens` is EXACTLY consistent with its
`totals.decode_tokens` even while tokens stream (the chaos
conservation gate compares the two; a mid-dump race can never skew
them).  The field equals `totals.decode_tokens` only when this ledger
is the process's sole decode biller (one engine per process — the
replica deployment).

Aggregate (bounded-label) metrics: `record_request` also counts
`tenant.requests{status=...}` on the shared registry, and `snapshot`
publishes `tenant.tracked` / `tenant.other_tokens` gauges — the ONLY
tenant data that ever reaches `/metrics`.  The top-K table itself is
served by `GET /debug/tenants` and the telemetry dumps, never rendered
to Prometheus.

Knobs:
  PADDLE_TPU_TENANT_LEDGER   "0" disables metering entirely    (on)
  PADDLE_TPU_TENANT_TOPK     table capacity K                  (32)

stdlib-only and file-loadable standalone (the `_obs_modules` guard, as
export.py): `tools/telemetry_agg.py` file-loads this module for
`merge_snapshots` — merging two Space-Saving sketches sums matched
keys and folds unmatched evictees into error bounds / `~other`.
"""
from __future__ import annotations

import os
import re
import threading
from collections import deque

__all__ = [
    "TenantLedger", "merge_snapshots", "conservation_delta",
    "sanitize_tenant", "enabled", "topk", "SCHEMA_VERSION",
    "ANON_TENANT", "OTHER_KEY", "STATUSES", "COUNT_FIELDS",
    "FLOAT_FIELDS",
]

SCHEMA_VERSION = "tenant_ledger/v1"
ANON_TENANT = "anon"
OTHER_KEY = "~other"
DEFAULT_TOPK = 32
RESERVOIR = 64

# request outcomes the ledger books (serving's `timeout` maps to
# `error` at the billing site: a deadline burn is the server's failure)
STATUSES = ("ok", "shed", "client_error", "error")
# integer token fields + float resource fields — every snapshot/merge/
# conservation helper iterates these, so adding a metered quantity is
# one tuple edit
COUNT_FIELDS = ("prefill_tokens", "prefill_saved_tokens",
                "decode_tokens")
FLOAT_FIELDS = ("decode_slot_ms", "kv_page_seconds")

# tenant ids ride HTTP headers, JSON dumps and debug tables: same
# hostile-input discipline as request ids (request_trace._REQUEST_ID)
_TENANT_ID = re.compile(r"^[A-Za-z0-9._:-]{1,64}$")


def _metrics_module():
    """The metrics sibling, or None when file-loaded standalone."""
    try:
        from . import metrics  # type: ignore

        return metrics
    except ImportError:
        return None


def sanitize_tenant(raw):
    """A safe tenant id, or None when `raw` is absent/hostile."""
    if raw is None:
        return None
    s = str(raw)
    return s if _TENANT_ID.match(s) else None


def enabled() -> bool:
    """Metering is on unless PADDLE_TPU_TENANT_LEDGER=0.  Callers that
    construct ledgers additionally require the metrics registry to be
    live (a detached process must not pay even O(K))."""
    return os.environ.get("PADDLE_TPU_TENANT_LEDGER", "1") \
        not in ("0", "off", "false")


def topk() -> int:
    try:
        k = int(os.environ.get("PADDLE_TPU_TENANT_TOPK", DEFAULT_TOPK))
    except ValueError:
        k = DEFAULT_TOPK
    return max(1, k)


def _new_entry(weight=0.0, err=0.0):
    return {
        "requests": dict.fromkeys(STATUSES, 0),
        "prefill_tokens": 0, "prefill_saved_tokens": 0,
        "decode_tokens": 0,
        "decode_slot_ms": 0.0, "kv_page_seconds": 0.0,
        "weight": float(weight), "err": float(err),
        # per-tenant latency reservoirs (top-K only): sliding windows,
        # summarized (never dumped raw) — an evicted tenant's window
        # is dropped, its counts fold into ~other
        "_ttft": deque(maxlen=RESERVOIR),
        "_itl": deque(maxlen=RESERVOIR),
    }


def _fold(dst, src):
    """Fold one entry/bucket's exact counts into another (eviction and
    merge both route through here — conservation by construction)."""
    for s, n in src["requests"].items():
        dst["requests"][s] = dst["requests"].get(s, 0) + int(n)
    for f in COUNT_FIELDS:
        dst[f] = dst.get(f, 0) + int(src.get(f, 0))
    for f in FLOAT_FIELDS:
        dst[f] = dst.get(f, 0.0) + float(src.get(f, 0.0))
    return dst


def _summary(vals):
    """p50/p95/max/n over a small reservoir (shared quantile helper
    when the metrics sibling is importable, else local interpolation)."""
    vals = sorted(float(v) for v in vals)
    if not vals:
        return None
    m = _metrics_module()
    if m is not None:
        q = m.quantile
    else:
        def q(sv, p):
            pos = p * (len(sv) - 1)
            i, frac = int(pos), pos - int(pos)
            if frac == 0.0 or i + 1 >= len(sv):
                return float(sv[min(i, len(sv) - 1)])
            return float(sv[i]) + frac * (float(sv[i + 1])
                                          - float(sv[i]))
    return {"p50": round(q(vals, 0.5), 3), "p95": round(q(vals, 0.95), 3),
            "max": round(vals[-1], 3), "n": len(vals)}


class TenantLedger:
    """Bounded top-K tenant accounting (see module docstring).

    Thread-safe; every mutator is O(1) amortized except the O(K) min
    scan on an eviction (K is small by design).  One instance per
    engine/server/router — NOT process-global, so in-process
    multi-replica tests keep per-replica books."""

    def __init__(self, k=None, clock=None):
        self.k = int(k) if k else topk()
        self._lock = threading.Lock()
        self._tenants: dict = {}
        self._other = _new_entry()
        self._other_folds = 0     # evictions folded into ~other
        self._totals = _new_entry()
        self._distinct_seen = 0   # distinct ids ever admitted

    # --- recording ---------------------------------------------------------
    def _entry(self, tenant):  # pt-lint: ok[PT101,PT102] (callers hold _lock)
        """The tracked entry for `tenant`, admitting (and possibly
        evicting) per Space-Saving.  Caller holds the lock."""
        e = self._tenants.get(tenant)
        if e is not None:
            return e
        self._distinct_seen += 1
        if len(self._tenants) < self.k:
            return self._tenants.setdefault(tenant, _new_entry())
        victim_id = min(self._tenants,
                        key=lambda t: self._tenants[t]["weight"])
        victim = self._tenants.pop(victim_id)
        _fold(self._other, victim)
        self._other_folds += 1
        # Space-Saving: the newcomer inherits the victim's weight as
        # its over-estimate bound; its COUNTS start at zero (they were
        # genuinely not observed — the bound `err` says how much of
        # `weight` may be inherited, not earned)
        e = _new_entry(weight=victim["weight"], err=victim["weight"])
        self._tenants[tenant] = e
        return e

    def _charge(self, tenant, winc):
        e = self._entry(tenant)
        e["weight"] += winc
        return e

    def record_request(self, tenant, status):
        """Bill one request outcome.  Unknown statuses map to `error`;
        `timeout` maps to `error` (the bounded-status discipline)."""
        tenant = sanitize_tenant(tenant) or ANON_TENANT
        status = str(status)
        if status == "timeout" or status not in STATUSES:
            status = "error"
        with self._lock:
            e = self._charge(tenant, 1.0)
            e["requests"][status] += 1
            self._totals["requests"][status] += 1
        m = _metrics_module()
        if m is not None:
            # the aggregate (bounded-label) mirror on the registry
            m.inc("tenant.requests", status=status)

    def record_prefill(self, tenant, computed, saved=0):
        """Bill prefill work: `computed` prompt tokens actually ran the
        model, `saved` were served from the prefix cache instead."""
        tenant = sanitize_tenant(tenant) or ANON_TENANT
        computed, saved = max(0, int(computed)), max(0, int(saved))
        with self._lock:
            e = self._charge(tenant, float(computed + saved))
            e["prefill_tokens"] += computed
            e["prefill_saved_tokens"] += saved
            self._totals["prefill_tokens"] += computed
            self._totals["prefill_saved_tokens"] += saved

    def record_decode(self, tenant, n=1, count_engine_tokens=True):
        """Bill `n` accepted decode tokens.  When the metrics registry
        is live this ALSO increments `engine.tokens` inside the ledger
        lock (the call site must then skip its own inc): the pairing is
        what makes a concurrent snapshot's `metrics_engine_tokens`
        exactly consistent with `totals.decode_tokens`."""
        tenant = sanitize_tenant(tenant) or ANON_TENANT
        n = int(n)
        if n <= 0:
            return
        m = _metrics_module()
        with self._lock:
            e = self._charge(tenant, float(n))
            e["decode_tokens"] += n
            self._totals["decode_tokens"] += n
            if count_engine_tokens and m is not None:
                m.inc("engine.tokens", n)

    def record_decode_slot_ms(self, tenant, ms):
        tenant = sanitize_tenant(tenant) or ANON_TENANT
        ms = float(ms)
        if ms <= 0.0:
            return
        with self._lock:
            # no weight charge: slot-ms is derived occupancy, not a
            # new unit of demand (requests/tokens already charged it)
            e = self._entry(tenant)
            e["decode_slot_ms"] += ms
            self._totals["decode_slot_ms"] += ms

    def record_page_seconds(self, tenant, page_seconds):
        tenant = sanitize_tenant(tenant) or ANON_TENANT
        ps = float(page_seconds)
        if ps <= 0.0:
            return
        with self._lock:
            e = self._entry(tenant)
            e["kv_page_seconds"] += ps
            self._totals["kv_page_seconds"] += ps

    def observe_ttft(self, tenant, ms):
        """Per-tenant TTFT sample — stored ONLY while the tenant is in
        the top-K table (reservoirs are bounded to K by construction;
        an untracked tenant's sample is deliberately dropped, never a
        reason to admit it)."""
        tenant = sanitize_tenant(tenant) or ANON_TENANT
        with self._lock:
            e = self._tenants.get(tenant)
            if e is not None:
                e["_ttft"].append(float(ms))

    def observe_itl(self, tenant, ms):
        tenant = sanitize_tenant(tenant) or ANON_TENANT
        with self._lock:
            e = self._tenants.get(tenant)
            if e is not None:
                e["_itl"].append(float(ms))

    # --- reading -----------------------------------------------------------
    @staticmethod
    def _entry_out(e, latencies=True):
        out = {"requests": {s: n for s, n in e["requests"].items()
                            if n},
               "weight": round(float(e["weight"]), 3),
               "err": round(float(e["err"]), 3)}
        for f in COUNT_FIELDS:
            out[f] = int(e.get(f, 0))
        for f in FLOAT_FIELDS:
            # 6 decimals: display-friendly while keeping the summed
            # rounding drift far below conservation_delta's tolerance
            out[f] = round(float(e.get(f, 0.0)), 6)
        if latencies:
            for key, src in (("ttft_ms", "_ttft"), ("itl_ms", "_itl")):
                s = _summary(e.get(src) or ())
                if s is not None:
                    out[key] = s
        return out

    def snapshot(self) -> dict:
        """The JSON-able top-K table + other bucket + totals.  Also
        publishes the bounded aggregate gauges (`tenant.tracked`,
        `tenant.other_tokens`) — the per-tenant table itself NEVER
        enters the registry."""
        m = _metrics_module()
        with self._lock:
            tenants = {
                t: self._entry_out(e)
                for t, e in sorted(self._tenants.items(),
                                   key=lambda kv: -kv[1]["weight"])}
            other = self._entry_out(self._other, latencies=False)
            other.pop("err", None)
            other["folds"] = self._other_folds
            totals = self._entry_out(self._totals, latencies=False)
            for drop in ("weight", "err"):
                totals.pop(drop, None)
            snap = {"schema": SCHEMA_VERSION, "k": self.k,
                    "tracked": len(self._tenants),
                    "distinct_seen": self._distinct_seen,
                    "tenants": tenants, "other": other,
                    "totals": totals}
            other_tokens = (other["decode_tokens"]
                            + other["prefill_tokens"])
            if m is not None and m.enabled():
                # read back engine.tokens INSIDE the lock: decode incs
                # hold this lock while counting, so this value is
                # exactly consistent with totals.decode_tokens (see
                # module docstring)
                snap["metrics_engine_tokens"] = int(
                    m.snapshot()["counters"].get("engine.tokens", 0))
        if m is not None and m.enabled():
            m.set_gauge("tenant.tracked", snap["tracked"])
            m.set_gauge("tenant.other_tokens", other_tokens)
        return snap

    def conservation(self) -> dict:
        """Per-field invariant deltas: totals − (Σ tracked + other).
        All-zero == the books balance (the chaos gate's assertion)."""
        return conservation_delta(self.snapshot())


# --------------------------- pure helpers ---------------------------
#
# Snapshot-dict functions (no TenantLedger needed): telemetry_agg
# file-loads this module and merges per-replica snapshots with these.

def conservation_delta(snap) -> dict:
    """{field: totals − (Σ tenants + other)} over a snapshot dict.
    Float fields compare within 1e-3 (snapshot values are rounded to
    6 decimals, so honest books drift by ≤ parts·5e-7); a non-empty
    value at any key means the invariant broke."""
    parts = list((snap.get("tenants") or {}).values())
    parts.append(snap.get("other") or {})
    totals = snap.get("totals") or {}
    out = {}
    acc_req: dict = {}
    for p in parts:
        for s, n in (p.get("requests") or {}).items():
            acc_req[s] = acc_req.get(s, 0) + int(n)
    for s in STATUSES:
        d = int((totals.get("requests") or {}).get(s, 0)) \
            - acc_req.get(s, 0)
        if d:
            out[f"requests.{s}"] = d
    for f in COUNT_FIELDS:
        d = int(totals.get(f, 0)) - sum(int(p.get(f, 0)) for p in parts)
        if d:
            out[f] = d
    for f in FLOAT_FIELDS:
        d = float(totals.get(f, 0.0)) - sum(float(p.get(f, 0.0))
                                            for p in parts)
        if abs(d) > 1e-3:
            out[f] = round(d, 6)
    return out


def merge_snapshots(snaps, k=None) -> dict:
    """Merge N ledger snapshots into one fleet-wide snapshot dict.

    Space-Saving merge: matched keys SUM (counts, weight, err);
    when the union exceeds K the smallest-weight entries are evicted —
    their exact counts fold into `~other` (never dropped), exactly as
    a live eviction would.  Per-tenant latency summaries do not merge
    (reservoir percentiles are not additive) and are omitted; the
    per-replica snapshots keep them."""
    snaps = [s for s in snaps if isinstance(s, dict)]
    if k is None:
        k = max([int(s.get("k", DEFAULT_TOPK)) for s in snaps]
                or [DEFAULT_TOPK])
    merged: dict = {}
    other = _new_entry()
    other = {kk: v for kk, v in other.items()
             if not kk.startswith("_")}
    folds = 0
    totals = {f: 0 for f in COUNT_FIELDS}
    totals.update({f: 0.0 for f in FLOAT_FIELDS})
    totals["requests"] = dict.fromkeys(STATUSES, 0)
    distinct = 0
    engine_tokens = 0
    have_engine_tokens = False
    for s in snaps:
        distinct += int(s.get("distinct_seen", 0))
        if "metrics_engine_tokens" in s:
            engine_tokens += int(s["metrics_engine_tokens"])
            have_engine_tokens = True
        for t, e in (s.get("tenants") or {}).items():
            m = merged.setdefault(t, dict(
                {f: 0 for f in COUNT_FIELDS},
                **{f: 0.0 for f in FLOAT_FIELDS},
                requests={}, weight=0.0, err=0.0))
            _fold(m, {"requests": e.get("requests") or {},
                      **{f: e.get(f, 0) for f in COUNT_FIELDS},
                      **{f: e.get(f, 0.0) for f in FLOAT_FIELDS}})
            m["weight"] += float(e.get("weight", 0.0))
            m["err"] += float(e.get("err", 0.0))
        o = s.get("other")
        if o:
            _fold(other, {"requests": o.get("requests") or {},
                          **{f: o.get(f, 0) for f in COUNT_FIELDS},
                          **{f: o.get(f, 0.0) for f in FLOAT_FIELDS}})
            folds += int(o.get("folds", 0))
        tt = s.get("totals") or {}
        for st, n in (tt.get("requests") or {}).items():
            if st in totals["requests"]:
                totals["requests"][st] += int(n)
        for f in COUNT_FIELDS:
            totals[f] += int(tt.get(f, 0))
        for f in FLOAT_FIELDS:
            totals[f] += float(tt.get(f, 0.0))
    # truncate the union back to K: smallest weights fold into ~other
    # (their counts conserve; the fleet table keeps the honest top-K)
    if len(merged) > k:
        by_weight = sorted(merged.items(), key=lambda kv: kv[1]["weight"])
        for t, e in by_weight[:len(merged) - k]:
            _fold(other, e)
            folds += 1
            del merged[t]
    out_tenants = {}
    for t, e in sorted(merged.items(), key=lambda kv: -kv[1]["weight"]):
        row = {"requests": {st: n for st, n in e["requests"].items()
                            if n},
               "weight": round(e["weight"], 3),
               "err": round(e["err"], 3)}
        for f in COUNT_FIELDS:
            row[f] = int(e[f])
        for f in FLOAT_FIELDS:
            row[f] = round(e[f], 6)
        out_tenants[t] = row
    other_out = {"requests": {st: n for st, n in other["requests"].items()
                              if n}, "folds": folds}
    for f in COUNT_FIELDS:
        other_out[f] = int(other.get(f, 0))
    for f in FLOAT_FIELDS:
        other_out[f] = round(float(other.get(f, 0.0)), 6)
    totals_out = {"requests": totals["requests"]}
    for f in COUNT_FIELDS:
        totals_out[f] = int(totals[f])
    for f in FLOAT_FIELDS:
        totals_out[f] = round(float(totals[f]), 6)
    out = {"schema": SCHEMA_VERSION, "k": k,
           "tracked": len(out_tenants), "distinct_seen": distinct,
           "merged_from": len(snaps),
           "tenants": out_tenants, "other": other_out,
           "totals": totals_out}
    if have_engine_tokens:
        out["metrics_engine_tokens"] = engine_tokens
    return out
