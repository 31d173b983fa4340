"""Deterministic, seeded fault injection with named fault points.

Pod-scale training only works when preemption and failure are routine,
which means every recovery path must be *testable* — this harness makes
each failure mode deterministically injectable so CI exercises the same
reflexes production needs (PAPERS.md: MLPerf TPU-v3 pod scaling;
EQuARX collective faults).

Named fault points (instrumented call sites `fire()` these):

  checkpoint.write   distributed/checkpoint/api.py  per shard file write
  collective.call    distributed/collective.py      eager collective exec
  dataloader.batch   io/dataloader.py               per yielded batch
  jit.compile        jit/api.py                     to_static trace/compile build
  train.step         distributed/train_step.py      per host dispatch
  serving.request    inference/serving.py           per predict call
  store.op           distributed/fleet/elastic.py   heartbeat store traffic
  router.forward     inference/router.py            per forward attempt
  router.stream_read inference/router.py            per streamed /generate
                     line read off a replica (an injection here severs
                     the stream mid-flight — the deterministic stand-in
                     for a replica dying with tokens delivered)
  router.resume_verify inference/router.py          per resume
                     first-token divergence check (an injection forces
                     the mismatch branch — the loud `interrupted`
                     fallback, never a wrong token)
  replica.crash      inference/fleet.py             replica main loop tick
                     (kind="error" → the replica exits non-zero; any
                     other kind → immediate os._exit, a simulated
                     kill -9)

Activation is programmatic (`inject(...)` — usually as a context
manager in tests) or via env:

  PADDLE_TPU_FAULTS="collective.call,p=0.3,times=2;train.step,at=3,kind=nan"
  PADDLE_TPU_FAULT_SEED=1234

Each rule is evaluated deterministically: probability draws come from a
`random.Random` seeded per rule (global seed + point name + rule index),
and count triggers (`at`, `every`, `after`) key on the per-point call
counter — the same seed and call sequence always injects the same
faults.  Every injection lands on the PR-1 flight recorder (and hence
the PR-2 trace timeline) and bumps `resilience.faults{point=...}`.
"""
from __future__ import annotations

import os
import threading
import zlib

__all__ = [
    "FAULT_POINTS", "InjectedFault", "FaultRule", "FaultAction",
    "inject", "fire", "clear", "active", "call_count", "reset_counters",
    "configure_from_env", "corrupt_file",
]

FAULT_POINTS = (
    "checkpoint.write", "collective.call", "dataloader.batch",
    "jit.compile", "train.step", "serving.request", "store.op",
    "router.forward", "router.stream_read", "router.resume_verify",
    "replica.crash",
)

_ENV_SPEC = "PADDLE_TPU_FAULTS"
_ENV_SEED = "PADDLE_TPU_FAULT_SEED"


class InjectedFault(RuntimeError):
    """The error a kind="error" (default) fault raises at its fault
    point.  Carries the point and the payload so recovery code and
    tests can assert on exactly which injection fired."""

    def __init__(self, point, kind="error", call=None, **payload):
        self.point = point
        self.kind = kind
        self.call = call
        self.payload = payload
        detail = f" call={call}" if call is not None else ""
        super().__init__(f"injected fault at {point!r} (kind={kind}{detail})")


class FaultAction:
    """What a non-raising fault asks the site to do: `kind` names the
    behavior the instrumented site implements (e.g. "torn" / "corrupt"
    for checkpoint.write, "nan" for train.step)."""

    __slots__ = ("point", "kind", "call", "payload")

    def __init__(self, point, kind, call, payload):
        self.point = point
        self.kind = kind
        self.call = call
        self.payload = dict(payload)

    def __repr__(self):
        return f"<FaultAction {self.point} kind={self.kind} call={self.call}>"


class FaultRule:
    """One armed injection at one point.

    Triggers (combinable; all that are set must agree):
      p      probability per call (seeded draw)
      at     fire exactly on the Nth call to the point (1-based)
      every  fire on every Nth call
      after  only calls strictly beyond N are eligible
      times  stop after firing N times (default: p/every unlimited,
             `at` implies times=1)
    """

    def __init__(self, point, kind="error", p=None, at=None, every=None,
                 after=0, times=None, seed=None, index=0, **payload):
        if point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {point!r} (known: {FAULT_POINTS})")
        import random

        self.point = point
        self.kind = str(kind)
        self.p = None if p is None else float(p)
        self.at = None if at is None else int(at)
        self.every = None if every is None else int(every)
        self.after = int(after)
        if times is None:
            times = 1 if self.at is not None else None
        self.times = None if times is None else int(times)
        self.fired = 0
        self.payload = payload
        base = int(seed if seed is not None
                   else os.environ.get(_ENV_SEED, "0"))
        # per-rule deterministic stream: global seed x point x rule index
        self._rng = random.Random(
            (base * 1000003) ^ zlib.crc32(point.encode()) ^ (int(index) << 17))

    def should_fire(self, call_n):
        if self.times is not None and self.fired >= self.times:
            return False
        if call_n <= self.after:
            return False
        if self.at is not None and call_n != self.at:
            return False
        if self.every is not None and call_n % self.every != 0:
            return False
        if self.p is not None and self._rng.random() >= self.p:
            return False
        return True


class _FaultState:
    def __init__(self):
        self.lock = threading.Lock()
        self.rules: list = []
        self.counts: dict = {}
        self.injected: list = []  # (point, kind, call) log for tests


_state = _FaultState()
_env_loaded = False


def _parse_env_spec(spec):
    """`point,k=v,k=v;point2,...` → list of FaultRule."""
    rules = []
    for i, part in enumerate(filter(None, (s.strip()
                                           for s in spec.split(";")))):
        fields = [f.strip() for f in part.split(",") if f.strip()]
        point, kwargs = fields[0], {}
        for f in fields[1:]:
            k, _, v = f.partition("=")
            kwargs[k.strip()] = v.strip()
        for k in ("p",):
            if k in kwargs:
                kwargs[k] = float(kwargs[k])
        for k in ("at", "every", "after", "times", "seed"):
            if k in kwargs:
                kwargs[k] = int(kwargs[k])
        rules.append(FaultRule(point, index=i, **kwargs))
    return rules


def configure_from_env(force=False):
    """Arm rules from $PADDLE_TPU_FAULTS (idempotent; `force` re-reads)."""
    global _env_loaded
    if _env_loaded and not force:
        return
    _env_loaded = True
    spec = os.environ.get(_ENV_SPEC, "")
    if spec:
        with _state.lock:
            _state.rules.extend(_parse_env_spec(spec))


class _Injection:
    """Context-manager handle for one armed rule (tests: `with
    faults.inject("collective.call", times=2): ...`).  Usable without
    `with` for process-lifetime arming."""

    def __init__(self, rule):
        self.rule = rule

    def __enter__(self):
        return self.rule

    def __exit__(self, *exc):
        with _state.lock:
            if self.rule in _state.rules:
                _state.rules.remove(self.rule)
        return False


def inject(point, kind="error", **kwargs):
    """Arm one fault rule at `point`.  Returns a context manager that
    disarms on exit (the rule object is its `as` target)."""
    with _state.lock:
        rule = FaultRule(point, kind=kind, index=len(_state.rules), **kwargs)
        _state.rules.append(rule)
    return _Injection(rule)


def clear():
    """Disarm everything and forget call counters."""
    with _state.lock:
        _state.rules.clear()
        _state.counts.clear()
        _state.injected.clear()


def active():
    """Snapshot of armed rules (shared objects — read-only use)."""
    with _state.lock:
        return list(_state.rules)


def call_count(point):
    with _state.lock:
        return _state.counts.get(point, 0)


def reset_counters():
    with _state.lock:
        _state.counts.clear()


def injected_log():
    """(point, kind, call) tuples of every injection so far."""
    with _state.lock:
        return list(_state.injected)


def fire(point, **ctx):
    """Evaluate the armed rules at a fault point.

    Returns None (the overwhelmingly common case — one lock'd counter
    bump when any rule is armed, a plain pass-through when none are),
    raises `InjectedFault` for kind="error" rules, or returns a
    `FaultAction` the call site interprets for special kinds ("torn",
    "corrupt", "nan", "stall", ...).
    """
    configure_from_env()
    # lock-free fast path: with no rules armed (production), fire() is
    # a list-emptiness check — no shared mutex on eager collectives,
    # dataloader batches, or concurrent serving requests.  The benign
    # race (a rule armed concurrently) only delays it by one call.
    if not _state.rules:
        return None
    with _state.lock:
        if not _state.rules:
            return None
        n = _state.counts.get(point, 0) + 1
        _state.counts[point] = n
        hit = None
        for rule in _state.rules:
            if rule.point == point and rule.should_fire(n):
                rule.fired += 1
                hit = rule
                break
        if hit is not None:
            _state.injected.append((point, hit.kind, n))
    if hit is None:
        return None
    _record_injection(point, hit.kind, n, ctx)
    payload = dict(hit.payload)
    payload.update(ctx)
    if hit.kind == "error":
        raise InjectedFault(point, kind="error", call=n, **payload)
    return FaultAction(point, hit.kind, n, payload)


def _record_injection(point, kind, call_n, ctx):
    """Every injection is observable: a flight-ring event (which doubles
    as a trace instant) + a metrics counter.  Telemetry failures must
    never change fault semantics."""
    try:
        from ..observability import flight as _flight
        from ..observability import metrics as _metrics

        _metrics.inc("resilience.faults", point=point)
        safe_ctx = {k: v for k, v in ctx.items()
                    if k not in ("kind", "point", "call")
                    and isinstance(v, (str, int, float, bool, list, tuple))}
        # NB: the payload key is fault_kind — `kind` is record()'s own
        # event-name parameter
        _flight.record("resilience.fault_injected", point=point,
                       fault_kind=kind, call=call_n, **safe_ctx)
    except Exception:  # pt-lint: ok[PT005] (observability fan-out
        pass           # guard: injection must not depend on telemetry)


def corrupt_file(path, seed=0, nbytes=1):
    """Deterministically flip `nbytes` bytes of the file at `path`
    (bit-rot simulation for CRC tests).  Returns the flipped offsets."""
    import random

    size = os.path.getsize(path)
    if size == 0:
        return []
    rng = random.Random(
        (int(seed) * 1000003) ^ zlib.crc32(os.path.basename(path).encode()))
    offsets = sorted(rng.randrange(size) for _ in range(max(1, int(nbytes))))
    with open(path, "r+b") as f:
        for off in offsets:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))
    return offsets
