"""QoS priority classes: the shared vocabulary of the multi-tenant
policy plane (ROADMAP item 4).

Three classes, strictly ordered:

  =======  ====  =======================================================
  class    rank  promise
  =======  ====  =======================================================
  paid      2    holds its p99 under surge; shed LAST, preempts others
  free      1    best-effort; degrades via counted sheds + warm
                 preemption before paid feels anything
  batch     0    throughput scavenger; first shed, first preempted,
                 aging-bounded so it still eventually runs
  =======  ====  =======================================================

Every layer prices the same ordering differently:

  * the **edge** (`AdmissionController`) queues/sheds lowest class
    first (nested weighted queue partitions + strict-priority dequeue
    with an aging knob) and hands lower classes honest longer
    `Retry-After` backoff;
  * the **scheduler** preempts the lowest-class youngest sequence via
    the recompute-eviction path (warm resume from the prefix cache);
  * the **SLO tracker** keeps per-class burn so the autoscaler scales
    for the paid tier while free absorbs the shed.

Class identity arrives on `X-Priority-Class` (validate-or-drop, like
every identity header), defaults per tenant via the
`PADDLE_TPU_QOS_CLASSES` map (``tenant-0:paid,team-*:batch,*:free``),
and falls back to `DEFAULT_CLASS`.

stdlib-only and import-cycle-free: observability and inference both
import this.
"""
from __future__ import annotations

import fnmatch
import os

__all__ = [
    "CLASSES", "DEFAULT_CLASS", "class_rank", "normalize_class",
    "class_map_from_env", "resolve_class", "retry_after_factor",
    "class_weight", "ENV_CLASS_MAP", "ENV_RESUME_CLASSES",
    "resume_classes_from_env",
]

# strict order, highest first — rank = distance from the end
CLASSES = ("paid", "free", "batch")
DEFAULT_CLASS = "free"
ENV_CLASS_MAP = "PADDLE_TPU_QOS_CLASSES"
# which classes the router's mid-stream resume serves:
# comma-separated class names; unset/empty = every class.  The knob
# exists so an operator can declare `batch` streams not worth the
# resume re-prefill — they fall back to the clean `interrupted` record
ENV_RESUME_CLASSES = "PADDLE_TPU_STREAM_RESUME_CLASSES"

_RANK = {c: len(CLASSES) - 1 - i for i, c in enumerate(CLASSES)}

# decode-slot / queue-share weights (fairness is priced in the
# ledger's decode-slot-ms unit; these are the relative shares)
_WEIGHT = {"paid": 4.0, "free": 2.0, "batch": 1.0}

# Retry-After multipliers: a shed free/batch client backs off honestly
# longer than a paid one under the same pressure estimate
_RETRY_FACTOR = {"paid": 1.0, "free": 2.0, "batch": 4.0}


def class_rank(cls) -> int:
    """Numeric priority (higher = more important).  Unknown/None maps
    to the default class's rank — rank is for ORDERING, normalization
    for validation."""
    return _RANK.get(cls, _RANK[DEFAULT_CLASS])


def normalize_class(value):
    """Validate-or-drop: the class name if `value` is a known class
    (case-insensitive, surrounding whitespace tolerated), else None.
    A garbage `X-Priority-Class` must not mint a garbage label."""
    if value is None:
        return None
    v = str(value).strip().lower()
    return v if v in _RANK else None


def class_weight(cls) -> float:
    return _WEIGHT.get(cls, _WEIGHT[DEFAULT_CLASS])


def retry_after_factor(cls) -> float:
    return _RETRY_FACTOR.get(cls, _RETRY_FACTOR[DEFAULT_CLASS])


def class_map_from_env(env=None) -> list:
    """Parse `PADDLE_TPU_QOS_CLASSES` into an ordered list of
    (tenant-pattern, class) rules.  Format: comma-separated
    ``pattern:class`` entries; patterns are fnmatch-style (so ``*``
    and ``team-*`` work); first match wins.  Malformed entries and
    unknown classes are dropped, not raised — a bad env var must not
    take the edge down."""
    raw = (env if env is not None
           else os.environ.get(ENV_CLASS_MAP, "")) or ""
    rules = []
    for part in raw.split(","):
        part = part.strip()
        if not part or ":" not in part:
            continue
        pattern, _, cls = part.rpartition(":")
        cls = normalize_class(cls)
        pattern = pattern.strip()
        if not pattern or cls is None:
            continue
        rules.append((pattern, cls))
    return rules


def resume_classes_from_env(env=None) -> frozenset:
    """Parse `PADDLE_TPU_STREAM_RESUME_CLASSES` into the set of classes
    eligible for mid-stream resume.  Unset or empty means
    ALL classes; unknown names are dropped (validate-or-drop, like
    every class input) — and if every entry is garbage the policy
    falls back to all-classes rather than silently disabling resume
    fleet-wide on a typo."""
    raw = (env if env is not None
           else os.environ.get(ENV_RESUME_CLASSES, "")) or ""
    if not raw.strip():
        return frozenset(CLASSES)
    picked = frozenset(
        c for c in (normalize_class(p) for p in raw.split(","))
        if c is not None)
    return picked or frozenset(CLASSES)


def resolve_class(tenant_id=None, explicit=None, rules=None):
    """The one resolution order every edge uses: an explicit (already
    validated) class wins, else the tenant→class map, else
    `DEFAULT_CLASS`."""
    cls = normalize_class(explicit)
    if cls is not None:
        return cls
    if rules is None:
        rules = class_map_from_env()
    if tenant_id is not None and rules:
        tid = str(tenant_id)
        for pattern, cls in rules:
            if fnmatch.fnmatchcase(tid, pattern):
                return cls
    return DEFAULT_CLASS
