"""Capture timing: the port's counterpart of ``observability/xla_cost.py``.

The JAX package pays for each fixed-shape program once, when `jax.jit`
traces, lowers and compiles it; `xla_cost.instrument` times that and
records it in the lifecycle ledger (`lifecycle.record_compile`), in an
``xla.compile:<label>`` span and in a flight event.  Here the same cost
is a CUDA graph's warm-up, the eager first run on the capture stream
(where the kernels build at first use), and its capture
(`core.graphs.capture`).  Each graph is timed under the label of the JAX
program whose role it takes:

  * ``decode_n{n}`` — the engine's decode program of n steps;
  * ``prefill_s{sb}`` — the engine's cold prefill at bucket sb.  One
    graph holds the prefill and its pack, which the JAX package compiles
    as two programs (``prefill_s{sb}`` and ``pack_s{sb}[_q]``), so the
    graph takes the prefill's label;
  * ``cprefill_s{sb}_p{npp}`` (``..._q`` on the int8 KV tier) — the warm
    prefill with its pack, at prefix bucket npp;
  * ``jit::<fn>`` — a `jit.to_static` signature;
  * ``train_step`` — a train step's batch signature;
  * ``decode_chunk_n{n}`` — a `generate()` decode chunk of n steps, a
    program the JAX package compiles without timing it.

`record_compile(label, lower_ms=warm-up ms, compile_ms=capture ms)`
feeds the ledger (and its ``lifecycle.compile_ms{program}`` gauges), a
``graph.capture:<label>`` span covers both, and a ``graph.capture``
flight event carries the two times.  A capture that fails raises
through the timing, which records nothing for it.  XLA's cost analysis
(FLOPs, bytes, temporaries: the ``xla.cost.*`` gauges) has no
counterpart for a CUDA graph and is left out.
"""
from __future__ import annotations

import time

from . import flight as _flight
from . import lifecycle as _lifecycle
from . import trace as _trace

__all__ = ["CaptureTiming"]


class CaptureTiming:
    """Context manager timing one program's warm-up and capture: enter
    before the warm-up, call `warmed()` after it, leave after the
    capture.  On a clean exit the times are recorded; an exception
    passes through unrecorded (`__exit__` never suppresses it)."""

    def __init__(self, label: str):
        self.label = str(label)
        self.warm_up_ms = self.capture_ms = None
        self._span = None
        self._t0 = self._t1 = None

    def __enter__(self):
        self._span = _trace.begin(f"graph.capture:{self.label}",
                                  cat="compile")
        self._t0 = time.perf_counter()
        return self

    def warmed(self) -> None:
        """The warm-up ended (the capture starts now)."""
        self._t1 = time.perf_counter()

    def __exit__(self, exc_type, exc, tb):
        t2 = time.perf_counter()
        if exc_type is None:
            t1 = self._t0 if self._t1 is None else self._t1
            self.warm_up_ms = (t1 - self._t0) * 1e3
            self.capture_ms = (t2 - t1) * 1e3
            if self._span is not None:
                self._span.args.update(warm_up_ms=self.warm_up_ms,
                                       capture_ms=self.capture_ms)
            _lifecycle.get_ledger().record_compile(
                self.label, lower_ms=self.warm_up_ms,
                compile_ms=self.capture_ms)
            _flight.record("graph.capture", label=self.label,
                           warm_up_ms=self.warm_up_ms,
                           capture_ms=self.capture_ms)
        elif self._span is not None:
            self._span.args["failed"] = exc_type.__name__
        _trace.end(self._span)
        return False
