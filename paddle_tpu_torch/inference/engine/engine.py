"""Continuous-batching inference engine over a paged KV cache.

Counterpart of ``paddle_tpu/inference/engine/engine.py`` (the exact
tier and the int8 KV tier).
The engine keeps a FIXED batch of `max_slots` sequence slots and
advances every in-flight sequence `decode_chunk` tokens per step,
admitting new sequences into freed slots between steps.  Per sequence:

  * **prefill**: a cold prefill left-pads the prompt to a bucket and
    runs the dense static-cache forward (`flash_fwd` with the pad mask
    as bias); a warm prefill (prefix cache hit) gathers the cached
    prefix pages into a dense buffer and runs only the tail.
  * **pack**: copies the fresh dense K/V into the sequence's pages.
  * **decode**: ragged steps at the fixed `[max_slots]` batch — each
    step writes every slot's current token into its page and attends
    through `paged_attention` with per-slot lengths.

The JAX package compiles these as `jax.jit` programs with donated
pools; here they are methods that update the pool tensors IN PLACE.
The decode step is a fixed-shape program as in the JAX package: one per
(decode_chunk, KV tier), over static device buffers (the tokens, page
table and lengths in, the tokens out) and the pools, which nothing ever
rebinds.  On a CUDA device it is a CUDA graph (`core.graphs`): at its
first step the body runs once eagerly on all-scratch inputs, touching
only scratch page 0, and is then captured on the thread that steps the
engine; every step copies the host arrays into the buffers and replays
it.  On the CPU the same body runs eagerly.  Prefill and the pack stay
eager.  Free slots ride along pointing at scratch page 0 with length 0;
their output is discarded on the host.

The int8 KV tier (``kv_precision="int8"``): the page pools hold int8
codes with per-token, per-head f32 scale tables [num_pages, Hkv,
page_size] (initialised to 1, so a never-written slot decodes to
zeros).  Decode writes and the pack quantize each K/V head vector on its
own (`ops.quant.quantize_vectors`), so a packed page is bit-identical to
what token-by-token writes would store; `paged_attention` dequantizes
inside its int8 kernel.  Prefill stays exact (dense, in the model's
dtype), and a prefix-cache hit's warm prefill reads the radix node's
commit-time exact copy of each page (the "sidecar"), not the int8 pools.
A page costs one byte per element plus four per scale, so a
``pool_hbm_mb`` budget admits about twice the pages of bf16.

Not ported yet (ROADMAP Queue A4): the int8 weight tier
(`weight_precision`) and draft-model speculative decoding
(`spec_tokens`); setting either raises NotImplementedError.

Env knobs (read when the matching ctor arg is None):
  PADDLE_TPU_ENGINE_PAGE_SIZE       tokens per KV page        (16)
  PADDLE_TPU_ENGINE_MAX_PAGES      pool size incl. scratch    (derived)
  PADDLE_TPU_ENGINE_MAX_SLOTS      batch slots                (4)
  PADDLE_TPU_ENGINE_DECODE_CHUNK   decode steps per engine step (1)
  PADDLE_TPU_ENGINE_PREFILL_BUCKET prompt padding granule     (16)
  PADDLE_TPU_ENGINE_MAX_SEQ_LEN    per-sequence token cap     (model's)
  PADDLE_TPU_ENGINE_POOL_HBM_MB    pool byte budget, MiB      (0 = unset)
  PADDLE_TPU_ENGINE_PREFIX_CACHE   prefix caching on/off      (1)
  PADDLE_TPU_ENGINE_PREFIX_CACHE_MAX_TOKENS  cache bound      (0=pool)
"""
from __future__ import annotations

import copy
import functools
import os
import queue
import threading
import time

import numpy as np
import torch

from ...core import graphs as GR
from ...core.flags import _env_num
from ...models import generation as GEN
from ...ops.quant import quantize_vectors
from ...observability import metrics as _metrics
from ...observability import tenant_ledger as _tledger
from ...observability import trace as _trace
from ...observability.timeseries import DecisionRing, RequestTimeline
from .paging import PagePool
from .prefix import PrefixIndex
from .scheduler import Scheduler, Sequence

__all__ = ["EngineConfig", "InferenceEngine", "RequestHandle"]

# completed-request timelines retained for request_debug()
_TIMELINE_LRU = 128

_NOT_PORTED = ("is not ported to paddle_tpu_torch yet (ROADMAP Queue A4: "
               "int8 weights, speculative decode)")


def _precision_knob(explicit, env, valid):
    raw = explicit if explicit is not None else os.environ.get(env, "")
    key = str(raw).strip().lower()
    if key not in valid:
        raise ValueError(
            f"{env}={raw!r}: expected one of "
            f"{sorted(k for k in valid if k)} (or unset for the exact "
            f"tier)")
    return valid[key]


class EngineConfig:
    """Engine sizing knobs; every ctor arg falls back to its
    PADDLE_TPU_ENGINE_* env, then the default."""

    def __init__(self, page_size=None, num_pages=None, max_slots=None,
                 decode_chunk=None, prefill_bucket=None,
                 max_seq_len=None, weight_precision=None,
                 kv_precision=None, spec_tokens=None, pool_hbm_mb=None,
                 prefix_cache=None, prefix_cache_max_tokens=None):
        self.page_size = int(page_size if page_size is not None else
                             _env_num("PADDLE_TPU_ENGINE_PAGE_SIZE", 16,
                                      int))
        self.max_slots = int(max_slots if max_slots is not None else
                             _env_num("PADDLE_TPU_ENGINE_MAX_SLOTS", 4,
                                      int))
        self.decode_chunk = int(
            decode_chunk if decode_chunk is not None else
            _env_num("PADDLE_TPU_ENGINE_DECODE_CHUNK", 1, int))
        self.prefill_bucket = int(
            prefill_bucket if prefill_bucket is not None else
            _env_num("PADDLE_TPU_ENGINE_PREFILL_BUCKET", 16, int))
        # 0 = resolve from the model's max_seq_len at engine build
        self.max_seq_len = int(
            max_seq_len if max_seq_len is not None else
            _env_num("PADDLE_TPU_ENGINE_MAX_SEQ_LEN", 0, int))
        # 0 = derived: every slot can hold a max-length sequence
        self.num_pages = int(num_pages if num_pages is not None else
                             _env_num("PADDLE_TPU_ENGINE_MAX_PAGES", 0,
                                      int))
        self.weight_precision = _precision_knob(
            weight_precision, "PADDLE_TPU_ENGINE_WEIGHT_PRECISION",
            {"": None, "f32": None, "full": None, "fp32": None,
             "bf16": "bf16", "int8": "int8"})
        self.kv_precision = _precision_knob(
            kv_precision, "PADDLE_TPU_ENGINE_KV_PRECISION",
            {"": None, "f32": None, "full": None, "fp32": None,
             "int8": "int8"})
        self.spec_tokens = int(
            spec_tokens if spec_tokens is not None else
            _env_num("PADDLE_TPU_ENGINE_SPEC_TOKENS", 0, int))
        self.pool_hbm_mb = float(
            pool_hbm_mb if pool_hbm_mb is not None else
            _env_num("PADDLE_TPU_ENGINE_POOL_HBM_MB", 0.0, float))
        self.prefix_cache = bool(int(
            prefix_cache if prefix_cache is not None else
            _env_num("PADDLE_TPU_ENGINE_PREFIX_CACHE", 1, int)))
        self.prefix_cache_max_tokens = int(
            prefix_cache_max_tokens
            if prefix_cache_max_tokens is not None else
            _env_num("PADDLE_TPU_ENGINE_PREFIX_CACHE_MAX_TOKENS", 0,
                     int))
        for name in ("page_size", "max_slots", "decode_chunk",
                     "prefill_bucket"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got "
                                 f"{getattr(self, name)}")
        if self.spec_tokens < 0:
            raise ValueError(
                f"spec_tokens must be >= 0, got {self.spec_tokens}")
        if self.prefix_cache_max_tokens < 0:
            raise ValueError(
                f"prefix_cache_max_tokens must be >= 0, got "
                f"{self.prefix_cache_max_tokens}")


class RequestHandle:
    """One submitted request's delivery side: a token stream plus a
    completion event."""

    def __init__(self, seq: Sequence):
        self._seq = seq
        self.request_id = seq.request_id
        self.tenant_id = getattr(seq, "tenant_id", None)
        self._q = queue.Queue()
        self.done = threading.Event()
        self.finish_reason = None

    def _push(self, tok: int) -> None:
        self._q.put(int(tok))

    def _finish(self, reason: str) -> None:
        if self.done.is_set():
            return
        self.finish_reason = reason
        self.done.set()
        self._q.put(None)          # stream sentinel

    def stream(self, timeout: float = 120.0):
        """Yield generated tokens as they land; returns at completion."""
        while True:
            tok = self._q.get(timeout=timeout)
            if tok is None:
                return
            yield tok

    def result(self, timeout: float = 120.0) -> np.ndarray:
        """Blocking: full int32 [s0 + n_generated] ids (prompt
        included, like `generate`)."""
        if not self.done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not finished in {timeout}s")
        return self._seq.output_ids()

    @property
    def tokens(self) -> list:
        return list(self._seq.tokens)

    @property
    def cancelled(self) -> bool:
        return self.finish_reason == "cancelled"

    @property
    def cache_state(self) -> str:
        """Prefix-cache outcome at admission: hit / partial / miss."""
        return self._seq.cache_state or "miss"


class _DecodeProgram:
    """The static int32 device buffers of a decode program: tok
    [max_slots], pt [max_slots, max_pages_per_seq] and lengths
    [max_slots] in, toks [max_slots, n] out.  On a CUDA device `graph`
    replays the n steps over them and `bound` is what it holds of the
    pools.  It keeps no reference to the engine, so a dropped engine
    frees its pools at once."""

    def __init__(self, slots, pages, n, device):
        def buf(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=device)

        self.tok, self.pt = buf(slots), buf(slots, pages)
        self.lengths, self.toks = buf(slots), buf(slots, n)
        self.graph = self.bound = None


class InferenceEngine:
    """Continuous-batching greedy engine over one model with the
    `GPTForCausalLM` cached-forward contract, on the model's device.

    All tensor work runs under `torch.inference_mode()`; grad mode is
    thread-local in PyTorch, so the loop thread enters it itself."""

    def __init__(self, model, config: EngineConfig = None,
                 clock=time.monotonic, draft_model=None):
        # own copy: max_seq_len/num_pages resolve against THIS model
        self.config = copy.copy(config) if config is not None \
            else EngineConfig()
        cfg = self.config
        self._quant = cfg.kv_precision == "int8"
        if cfg.weight_precision is not None:
            raise NotImplementedError(
                f"EngineConfig.weight_precision={cfg.weight_precision!r} "
                + _NOT_PORTED)
        if cfg.spec_tokens > 0 or draft_model is not None:
            raise NotImplementedError("speculative decoding (spec_tokens/"
                                      "draft_model) " + _NOT_PORTED)
        self._model = model
        model.eval()
        self._device = model.device
        with torch.inference_mode():
            probe = model.init_kv_caches(1, 1)
        self._layers = len(probe)
        _, self._hkv, _, self._hd = probe[0][0].shape
        self._dtype = probe[0][0].dtype
        del probe
        if cfg.max_seq_len <= 0:
            cfg.max_seq_len = int(getattr(model.cfg, "max_seq_len", 0)) \
                or 2048
        self.max_pages_per_seq = -(-cfg.max_seq_len // cfg.page_size)
        if cfg.num_pages <= 0:
            if cfg.pool_hbm_mb > 0:
                cfg.num_pages = max(
                    2, int(cfg.pool_hbm_mb * 2**20) // self._page_bytes())
            else:
                cfg.num_pages = cfg.max_slots * self.max_pages_per_seq + 1
        self.pool = PagePool(cfg.num_pages, cfg.page_size)
        self._prefix = None
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._prefix_tokens_saved = 0
        self._prefix_tokens_total = 0
        if cfg.prefix_cache:
            self._prefix = PrefixIndex(
                self.pool, max_tokens=cfg.prefix_cache_max_tokens,
                clock=clock,
                on_evict=lambda n: _metrics.inc(
                    "engine.prefix_cache", n, event="evict"))
        self._clock = clock
        self.decisions = DecisionRing(capacity=512, clock=clock)
        self._timeline_cap = int(_env_num(
            "PADDLE_TPU_ITL_TIMELINE_CAP", 256, int))
        self._timelines = {}       # request_id -> RequestTimeline (LRU)
        self.tenant_ledger = None
        if _tledger.enabled() and _metrics.enabled():
            self.tenant_ledger = _tledger.TenantLedger()
        self.scheduler = Scheduler(cfg.max_slots, self.pool,
                                   self.max_pages_per_seq, clock=clock,
                                   prefix_index=self._prefix,
                                   decision_ring=self.decisions,
                                   tenant_ledger=self.tenant_ledger)
        shape = (cfg.num_pages, self._hkv, cfg.page_size, self._hd)
        pool_dtype = torch.int8 if self._quant else self._dtype
        with torch.inference_mode():
            self._k_pools = [torch.zeros(shape, dtype=pool_dtype,
                                         device=self._device)
                             for _ in range(self._layers)]
            self._v_pools = [torch.zeros(shape, dtype=pool_dtype,
                                         device=self._device)
                             for _ in range(self._layers)]
            self._k_scales = self._v_scales = None
            if self._quant:
                # scale 1 everywhere: a never-written (scratch) slot
                # decodes to exact zeros, like the bf16 pool's zeros
                self._k_scales = [torch.ones(shape[:3], dtype=torch.float32,
                                             device=self._device)
                                  for _ in range(self._layers)]
                self._v_scales = [torch.ones(shape[:3], dtype=torch.float32,
                                             device=self._device)
                                  for _ in range(self._layers)]
        self._programs = {}        # (n, kv tier) -> _DecodeProgram
        self._handles = {}         # request_id -> RequestHandle
        self._lock = threading.RLock()
        self._work = threading.Condition()
        self._thread = None
        self._running = False
        self.steps = 0
        _metrics.set_gauge("engine.weight_precision", 1, precision="full")
        _metrics.set_gauge("paged.pool_precision", 1,
                           precision=cfg.kv_precision or "full")
        _metrics.set_gauge("engine.spec_tokens", 0)

    def _page_bytes(self) -> int:
        """Device bytes ONE page costs across all layers (K + V pools,
        plus the scale tables under the int8 KV tier) — the unit the
        ``pool_hbm_mb`` budget divides."""
        if self._quant:
            item, scale_item = 1, 4
        else:
            item = torch.empty((), dtype=self._dtype).element_size()
            scale_item = 0
        slots = self._hkv * self.config.page_size
        per_pool = slots * self._hd * item + slots * scale_item
        return max(1, self._layers * 2 * per_pool)

    def _tensor(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(
            self._device, non_blocking=True)

    # --- model steps (counterparts of the JAX engine's jitted programs) -----
    def _run_prefill(self, sb: int, ids, start: int):
        """`_prefill_program`: one left-padded sequence at bucket sb.
        Returns (greedy first token, dense K bufs, dense V bufs); the
        dense capacity is sb + page_size so the pack's last page slice
        never runs past the buffer."""
        cap = sb + self.config.page_size
        caches = [(torch.zeros(1, self._hkv, cap, self._hd,
                               dtype=self._dtype, device=self._device),
                   torch.zeros(1, self._hkv, cap, self._hd,
                               dtype=self._dtype, device=self._device))
                  for _ in range(self._layers)]
        logits, new = self._model(self._tensor(ids), kv_caches=caches,
                                  cache_pos=0,
                                  attn_start=self._tensor([start]))
        tok = int(logits[0, -1].float().argmax())
        return tok, [c[0] for c in new], [c[1] for c in new]

    def _run_pack(self, kbufs, vbufs, pages, start: int) -> None:
        """`_pack_program`: copy page-size chunks of the dense buffers,
        from offset start + i * page_size, into pages[i] (in place).
        Entries equal to the scratch page 0 are skipped: the JAX program
        writes garbage there, which nothing reads.  A chunk that would
        run past the buffer is clamped to its end, as
        `lax.dynamic_slice` does (only pages past the prompt's span,
        whose slots decode overwrites before reading, can hit this).
        Under the int8 KV tier each [Hkv, page_size, D] chunk quantizes
        per vector, the codec of the decode write, so the packed pages
        equal what token-by-token writes would have stored."""
        ps = self.config.page_size
        cap = kbufs[0].shape[2]
        live = [(i, int(p)) for i, p in enumerate(pages) if p != 0]
        if not live:
            return
        lows = [min(start + i * ps, cap - ps) for i, _ in live]
        dst = self._tensor([p for _, p in live], torch.long)
        idx = (torch.tensor(lows)[:, None] + torch.arange(ps)[None, :]
               ).reshape(-1).to(self._device)
        n = len(live)
        for pools, scales, bufs in ((self._k_pools, self._k_scales, kbufs),
                                    (self._v_pools, self._v_scales, vbufs)):
            for li, (pool, buf) in enumerate(zip(pools, bufs)):
                chunk = buf[0].index_select(1, idx)          # [hkv, n*ps, d]
                chunk = chunk.reshape(self._hkv, n, ps, self._hd) \
                    .transpose(0, 1)                         # [n, hkv, ps, d]
                if self._quant:
                    pool[dst], scales[li][dst] = quantize_vectors(chunk)
                else:
                    pool[dst] = chunk.to(pool.dtype)

    def _run_cached_prefill(self, sb: int, npp: int, ids, start: int,
                            plen: int, prefix_k, prefix_v):
        """`_cached_prefill_program`: warm tail prefill.  The cached
        prefix, per layer [npp, Hkv, page_size, D] pages (`prefix_k`,
        `prefix_v`), lays out as a dense buffer at [0, npp*ps); the tail
        (left-padded to bucket sb) runs under `warm_prefill_guard`, so
        each tail query attends prefix + causal tail."""
        ps = self.config.page_size
        pcap = npp * ps

        def dense(pages):
            g = pages.transpose(0, 1).reshape(self._hkv, pcap, self._hd)
            return torch.cat(
                [g[None], torch.zeros(1, self._hkv, sb + ps, self._hd,
                                      dtype=self._dtype,
                                      device=self._device)], dim=2)

        caches = [(dense(prefix_k[li]), dense(prefix_v[li]))
                  for li in range(self._layers)]
        with GEN.warm_prefill_guard(plen):
            logits, new = self._model(self._tensor(ids), kv_caches=caches,
                                      cache_pos=plen,
                                      attn_start=self._tensor([start]))
        tok = int(logits[0, -1].float().argmax())
        return tok, [c[0] for c in new], [c[1] for c in new]

    def _decode_body(self, n: int, tok, pt, lengths, toks):
        """The body of `_decode_program`: n ragged decode steps at the
        fixed [max_slots] batch from tok [max_slots] at lengths
        [max_slots] over page table pt, each step's greedy tokens
        written into toks [max_slots, n] (all int32, on the device).  The
        pools (and scale tables) update in place."""
        if self._quant:
            caches = [(k, v, pt, ks, vs) for k, v, ks, vs in zip(
                self._k_pools, self._v_pools, self._k_scales,
                self._v_scales)]
        else:
            caches = [(k, v, pt)
                      for k, v in zip(self._k_pools, self._v_pools)]
        for j in range(n):
            logits, _ = self._model(tok[:, None], kv_caches=caches,
                                    cache_pos=lengths)
            tok = logits[:, -1].float().argmax(-1).to(torch.int32)
            toks[:, j] = tok
            lengths = lengths + 1
        return toks

    def _pool_tensors(self) -> list:
        """The pools and scale tables a decode graph writes."""
        return self._k_pools + self._v_pools + (
            self._k_scales + self._v_scales if self._quant else [])

    def _decode_program(self, n: int) -> "_DecodeProgram":
        """`_decode_program`: the static buffers of n decode steps, and
        on a CUDA device their graph, built at the first step of the key
        (n, KV tier)."""
        key = (n, self.config.kv_precision)
        prog = self._programs.get(key)
        if prog is None:
            prog = _DecodeProgram(self.config.max_slots,
                                  self.max_pages_per_seq, n, self._device)
            if self._device.type == "cuda":
                self._capture_decode(n, prog)
            self._programs[key] = prog
        return prog

    def _capture_decode(self, n: int, prog) -> None:
        """Warm the body up on the program's zero buffers (every slot on
        scratch page 0 at length 0: it writes nothing else), then capture
        it into the program's graph.  A failure raises."""
        body = functools.partial(self._decode_body, n, prog.tok, prog.pt,
                                 prog.lengths, prog.toks)
        stream = torch.cuda.Stream(self._device)
        GR.warm_up(body, stream)
        prog.graph = GR.Graph(body, stream)
        prog.bound = GR.addresses(self._pool_tensors())

    def _run_decode(self, n: int, tok, pt, lengths):
        """n decode steps from host arrays tok [max_slots], pt
        [max_slots, max_pages_per_seq] and lengths [max_slots] (int32).
        Returns the tokens [max_slots, n] as a host array."""
        prog = self._decode_program(n)
        for dst, src in ((prog.tok, tok), (prog.pt, pt),
                         (prog.lengths, lengths)):
            # on the current stream, so ordered before the replay
            dst.copy_(torch.from_numpy(src), non_blocking=True)
        if self._device.type == "cpu":
            self._decode_body(n, prog.tok, prog.pt, prog.lengths, prog.toks)
        else:
            self._replay_decode(prog)
        # a copy: the next step rewrites the buffer
        return prog.toks.to("cpu", copy=True).numpy()

    def _replay_decode(self, prog) -> None:
        if GR.addresses(self._pool_tensors()) != prog.bound:
            raise RuntimeError(
                "the engine's page pools were rebound after the decode "
                "graph captured them; pools must be updated in place")
        prog.graph.replay()

    # --- intake -------------------------------------------------------------
    def submit(self, input_ids, max_new_tokens=32, eos_token_id=None,
               request_id=None, tenant_id=None,
               priority_class=None, deadline=None,
               prebilled_tokens=0) -> RequestHandle:
        """Enqueue one sequence; returns its `RequestHandle`.  Raises
        ValueError when the request can never fit."""
        if isinstance(input_ids, torch.Tensor):
            input_ids = input_ids.cpu().numpy()
        seq = Sequence(input_ids, max_new_tokens,
                       eos_token_id=eos_token_id, request_id=request_id,
                       tenant_id=tenant_id, priority_class=priority_class,
                       deadline=deadline,
                       prebilled_tokens=prebilled_tokens)
        need = -(-(seq.prompt.size + seq.max_new_tokens)
                 // self.config.page_size)
        if need > self.pool.capacity:
            raise ValueError(
                f"request needs {need} pages, pool holds "
                f"{self.pool.capacity}")
        handle = RequestHandle(seq)
        seq.handle = handle
        if self._timeline_cap > 0:
            tl = RequestTimeline(seq.request_id, clock=self._clock,
                                 token_cap=self._timeline_cap)
            tl.event("submitted", prompt_tokens=int(seq.prompt.size),
                     max_new_tokens=int(seq.max_new_tokens))
            seq.timeline = tl
        # register BEFORE the scheduler can see the sequence: the loop
        # thread may admit and finish it before submit() returns
        with self._lock:
            self._handles[seq.request_id] = handle
            if seq.timeline is not None:
                self._timelines.pop(seq.request_id, None)
                self._timelines[seq.request_id] = seq.timeline
                while len(self._timelines) > _TIMELINE_LRU:
                    # evict the oldest COMPLETED request first
                    victim = next(
                        (rid for rid in self._timelines
                         if rid not in self._handles), None)
                    if victim is None:
                        victim = next(iter(self._timelines))
                    self._timelines.pop(victim)
        try:
            self.scheduler.submit(seq)  # validates vs max_pages_per_seq
        except Exception:
            with self._lock:
                self._handles.pop(seq.request_id, None)
                self._timelines.pop(seq.request_id, None)
            raise
        _metrics.inc("engine.sequences", event="submitted")
        with self._work:
            self._work.notify_all()
        return handle

    def cancel(self, request_id) -> bool:
        """Abandon a sequence: its handle completes as cancelled now;
        slot and pages return to the pool at the next schedule()."""
        ok = self.scheduler.cancel(request_id)
        if ok:
            _metrics.inc("engine.sequences", event="cancelled")
            with self._lock:
                handle = self._handles.pop(request_id, None)
            if handle is not None:
                handle._finish("cancelled")
            with self._work:
                self._work.notify_all()
        return ok

    # --- the engine step ----------------------------------------------------
    def step(self) -> bool:
        """One engine iteration: schedule -> prefill admissions ->
        ragged decode chunk -> deliver.  Returns True when any work
        happened."""
        with self._lock, torch.inference_mode():
            with _trace.span("engine.schedule", cat="engine"):
                out = self.scheduler.schedule(self.config.decode_chunk)
            for seq in out.evicted:
                _metrics.inc("engine.sequences", event="evicted")
            for seq in out.finished:
                self._handles.pop(seq.request_id, None)
                if seq.handle is not None:
                    seq.handle._finish(seq.finish_reason or "finished")
            did = bool(out.finished or out.evicted)
            for seq in out.prefills:
                self._prefill(seq)
                did = True
            running = [s for s in out.running
                       if not s.done and s.slot is not None]
            if running:
                self._decode(running)
                did = True
            # free completed sequences' slots/pages NOW: a drained
            # engine must hold zero pages
            self.scheduler.release_finished()
            if did:
                self.steps += 1
            self._publish_gauges()
        return did

    def _bucket(self, s0: int) -> int:
        b = self.config.prefill_bucket
        return -(-s0 // b) * b

    def _prefill(self, seq: Sequence) -> None:
        prompt = seq.resume_prompt()
        s0 = prompt.size
        shared = int(seq.shared_len or 0)
        if seq.timeline is not None:
            seq.timeline.event("prefill_start", tokens=s0,
                               shared=shared,
                               resumed=bool(seq.evictions))
        with _trace.span("engine.prefill", cat="engine",
                         request=seq.request_id, tokens=s0,
                         shared=shared, pages=len(seq.pages)):
            if shared > 0:
                t0, kbufs, vbufs, start = self._warm_prefill(seq, prompt,
                                                             shared)
            else:
                t0, kbufs, vbufs, start = self._cold_prefill(seq, prompt)
            self._commit_prefix(seq, kbufs, vbufs, start)
            seq.length = s0
            seq.last_token = t0
        if seq.timeline is not None:
            seq.timeline.event("prefill_end", tokens=s0)
        if self._prefix is not None:
            if seq.cache_state in ("hit", "partial"):
                self._prefix_hits += 1
                _metrics.inc("engine.prefix_cache", event="hit")
            else:
                self._prefix_misses += 1
                _metrics.inc("engine.prefix_cache", event="miss")
            self._prefix_tokens_saved += shared
            self._prefix_tokens_total += s0
        if self.tenant_ledger is not None:
            self.tenant_ledger.record_prefill(
                seq.tenant_id, s0 - shared, saved=shared)
        _metrics.inc("engine.sequences", event="admitted")
        self._accept(seq, t0)

    def _cold_prefill(self, seq, prompt):
        """Dense prefill from token 0.  Returns (first token, dense K
        bufs, dense V bufs, pad_start): prompt token t sits at buffer
        offset pad_start + t, and packs (and commits) from there."""
        s0 = prompt.size
        sb = self._bucket(s0)
        start = sb - s0
        ids = np.zeros((1, sb), np.int32)
        ids[0, start:] = prompt
        tok, kbufs, vbufs = self._run_prefill(sb, ids, start)
        npb = -(-sb // self.config.page_size)
        pages = np.zeros((npb,), np.int32)
        n_real = min(len(seq.pages), npb)
        pages[:n_real] = seq.pages[:n_real]
        self._run_pack(kbufs, vbufs, pages, start)
        return tok, kbufs, vbufs, start

    @staticmethod
    def _prefix_bucket(n_pages: int) -> int:
        """Prefix page capacity bucket: next power of two (keeps the
        buffer shapes, and the JAX program set, bounded)."""
        npp = 1
        while npp < n_pages:
            npp *= 2
        return npp

    def _warm_prefill(self, seq, prompt, shared):
        """Prefill ONLY the tail [shared, s0): the cached prefix pages
        are already in the sequence's table.  The tail's K/V packs into
        the sequence's PRIVATE tail pages (the scheduler never shares
        the boundary page), so no shared page is written.  The prefix
        comes from the pools, or under the int8 KV tier from the
        matched nodes' exact sidecar.  Returns as `_cold_prefill`."""
        ps = self.config.page_size
        tail = prompt[shared:]
        sb = self._bucket(tail.size)
        start = sb - tail.size
        npa = shared // ps
        npp = self._prefix_bucket(npa)
        ids = np.zeros((1, sb), np.int32)
        ids[0, start:] = tail
        if self._quant:
            prefix_k, prefix_v = self._sidecar_prefix(seq, npa, npp)
        else:
            pages = np.zeros((npp,), np.int32)
            pages[:npa] = seq.pages[:npa]
            pg = self._tensor(pages, torch.long)
            prefix_k = [pool[pg] for pool in self._k_pools]
            prefix_v = [pool[pg] for pool in self._v_pools]
        tok, kbufs, vbufs = self._run_cached_prefill(
            sb, npp, ids, start, shared, prefix_k, prefix_v)
        # the fresh span landed at [shared, shared+sb): tail token j at
        # shared + start + j
        npb = -(-sb // ps)
        tpages = np.zeros((npb,), np.int32)
        n_tail = max(0, min(len(seq.pages) - npa, npb))
        tpages[:n_tail] = seq.pages[npa:npa + n_tail]
        self._run_pack(kbufs, vbufs, tpages, shared + start)
        # commit offset: prompt token t sits at start + t in the returned
        # buffers (tail token j, prompt token shared + j, landed at
        # shared + start + j)
        return tok, kbufs, vbufs, start

    def _sidecar_prefix(self, seq, npa, npp):
        """int8 KV tier: stack the matched radix nodes' commit-time exact
        page copies into per-layer prefix pages [npp, Hkv, page_size,
        D], zero past npa."""
        zero = torch.zeros(self._hkv, self.config.page_size, self._hd,
                           dtype=self._dtype, device=self._device)
        ek, ev = [], []
        for li in range(self._layers):
            ks, vs = [], []
            for i in range(npa):
                ex = seq.shared_nodes[i].exact
                if ex is None:
                    raise RuntimeError(
                        "prefix-cache node without an exact sidecar "
                        "under kv_precision=int8 (commit-path bug)")
                ks.append(ex[li][0])
                vs.append(ex[li][1])
            pad = [zero] * (npp - npa)
            ek.append(torch.stack(ks + pad))
            ev.append(torch.stack(vs + pad))
        return ek, ev

    def _commit_prefix(self, seq, kbufs, vbufs, start) -> None:
        """Register the ORIGINAL prompt's full pages in the radix index
        (the partial tail page stays private — decode still writes it).
        `start` is the buffer offset of prompt token 0 in the dense
        buffers just returned (cold and warm alike), where the int8
        tier's exact page copies are sliced from: one copy per layer of
        the new full pages, [n, Hkv, page_size, D], each node holding a
        page of it (not the whole prefill buffer)."""
        if self._prefix is None:
            return
        ps = self.config.page_size
        n_full = min(int(seq.prompt.size) // ps, len(seq.pages))
        if n_full <= 0:
            return
        exact = None
        if self._quant:
            # the first sc nodes exist (matched at admission); insert
            # never reads their slots
            sc = min(int(seq.shared_len or 0) // ps, n_full)
            lo, hi = start + sc * ps, start + n_full * ps

            def pages(buf):          # [n_full - sc, Hkv, page_size, D]
                return buf[0, :, lo:hi].reshape(
                    self._hkv, n_full - sc, ps, self._hd) \
                    .transpose(0, 1).contiguous()

            copies = [(pages(kb), pages(vb)) for kb, vb in zip(kbufs, vbufs)]
            exact = [None] * sc + [[(k[i], v[i]) for k, v in copies]
                                   for i in range(n_full - sc)]
        self._prefix.insert(seq.prompt[:n_full * ps], seq.pages[:n_full],
                            exact=exact)

    def _batch_arrays(self, running):
        """The decode program's host inputs: tok, pt, lengths (int32)."""
        s_, p_ = self.config.max_slots, self.max_pages_per_seq
        tok = np.zeros((s_,), np.int32)
        pt = np.zeros((s_, p_), np.int32)
        lengths = np.zeros((s_,), np.int32)
        for seq in running:
            tok[seq.slot] = seq.last_token
            pt[seq.slot, :len(seq.pages)] = seq.pages
            lengths[seq.slot] = seq.length
        return tok, pt, lengths

    def _decode(self, running) -> None:
        cfg = self.config
        t_step = time.perf_counter()
        tok, pt, lengths = self._batch_arrays(running)
        # ALWAYS the configured chunk, as the JAX engine does (its
        # fixed-shape contract); tokens past a finish are discarded
        n = cfg.decode_chunk
        with _trace.span("engine.decode", cat="engine", batch=len(running),
                         chunk=n, occupancy=len(running) / cfg.max_slots):
            toks = self._run_decode(n, tok, pt, lengths)
        with _trace.span("engine.detokenize", cat="engine",
                         batch=len(running), chunk=n):
            for seq in running:
                row = toks[seq.slot]
                for j in range(n):
                    if seq.done:
                        break  # mid-chunk finish: the rest is not output
                    self._accept(seq, int(row[j]))
                seq.length += n
                seq.last_token = int(row[n - 1])
        self._bill_decode_slots(running, t_step)

    def _bill_decode_slots(self, running, t_step) -> None:
        """Decode-slot occupancy billing: every sequence in the pass
        occupied one batch slot for the step's wall time."""
        if not running:
            return
        step_ms = (time.perf_counter() - t_step) * 1e3
        for seq in running:
            if self.tenant_ledger is not None:
                self.tenant_ledger.record_decode_slot_ms(
                    seq.tenant_id, step_ms)
            self.scheduler.note_decode_slot_ms(seq.tenant_id, step_ms)

    def _accept(self, seq: Sequence, tok: int) -> None:
        """One generated token passes the host: record, deliver, finish
        on eos / length (the eos itself is emitted, nothing after it)."""
        seq.tokens.append(int(tok))
        if seq.timeline is not None:
            seq.timeline.token()
        if len(seq.tokens) <= seq.prebilled_tokens:
            pass  # a resumed request's already-billed position
        elif self.tenant_ledger is not None:
            self.tenant_ledger.record_decode(seq.tenant_id)
        else:
            _metrics.inc("engine.tokens")
        if seq.handle is not None:
            seq.handle._push(tok)
        if seq.eos_token_id is not None and int(tok) == seq.eos_token_id:
            self._finish(seq, "eos")
        elif len(seq.tokens) >= seq.max_new_tokens:
            self._finish(seq, "length")

    def _finish(self, seq: Sequence, reason: str) -> None:
        if seq.timeline is not None:
            seq.timeline.event("finished", reason=reason,
                               generated=len(seq.tokens))
        self.scheduler.finish(seq, reason)
        # release slot/pages BEFORE the handle signals completion
        self.scheduler.release_finished()
        _metrics.inc("engine.sequences", event="completed")
        if seq.handle is not None:
            seq.handle._finish(reason)
        with self._lock:
            self._handles.pop(seq.request_id, None)

    def _publish_gauges(self) -> None:
        st = self.scheduler.stats()
        _metrics.set_gauge("engine.active_sequences", st["running"])
        _metrics.set_gauge("engine.waiting_sequences", st["waiting"])
        _metrics.set_gauge("engine.batch_occupancy", st["occupancy"])
        _metrics.set_gauge("engine.page_utilization",
                           self.pool.utilization())
        if self._prefix is not None:
            total = self._prefix_hits + self._prefix_misses
            _metrics.set_gauge("engine.prefix_cached_tokens",
                               self._prefix.cached_tokens)
            _metrics.set_gauge("engine.prefix_cache_hit_rate",
                               (self._prefix_hits / total) if total
                               else 0.0)

    # --- maintenance --------------------------------------------------------
    def defrag(self) -> int:
        """Compact live pages to the densest pool prefix: apply the
        allocator's moves to the device pools and every live page
        table.  Returns the number of pages moved."""
        with self._lock, torch.inference_mode():
            moves = self.pool.defrag()
            if not moves:
                return 0
            self.decisions.record(
                "defrag", moves=len(moves),
                pressure=round(self.pool.utilization(), 4))
            # ascending-dst order is overwrite-safe: src > dst always,
            # and every src exceeds all earlier dsts
            tables = self._k_pools + self._v_pools
            if self._quant:
                tables += self._k_scales + self._v_scales
            for src, dst in sorted(moves.items(), key=lambda kv: kv[1]):
                for p in tables:
                    p[dst] = p[src]
            for seq in self.scheduler.running_seqs():
                seq.pages = [moves.get(p, p) for p in seq.pages]
            if self._prefix is not None:
                self._prefix.apply_moves(moves)
        return len(moves)

    def clear_prefix_cache(self) -> int:
        """Drop every prefix-cache reference.  Returns the number of
        cache pages released."""
        with self._lock:
            if self._prefix is None:
                return 0
            return self._prefix.clear()

    def prefix_cache_stats(self) -> dict:
        hits, misses = self._prefix_hits, self._prefix_misses
        total = hits + misses
        st = {
            "enabled": self._prefix is not None,
            "hits": hits,
            "misses": misses,
            "hit_rate": (hits / total) if total else 0.0,
            "prefill_tokens_saved": self._prefix_tokens_saved,
            "prefill_tokens_total": self._prefix_tokens_total,
            "tokens_saved_frac":
                (self._prefix_tokens_saved
                 / max(1, self._prefix_tokens_total)),
        }
        if self._prefix is not None:
            st.update(self._prefix.stats())
        return st

    def request_debug(self, request_id):
        """The request's timeline with each top inter-token gap
        annotated by the scheduler decisions inside it; None for unknown
        or aged-out ids."""
        with self._lock:
            tl = self._timelines.get(request_id)
        if tl is None:
            return None
        d = tl.describe()
        for gap in d["gaps"]:
            evs = self.decisions.window(gap["t_start"], gap["t_end"],
                                        pad=0.005)
            gap["events"] = evs
            causes = []
            for ev in evs:
                who = ev.get("request_id") or ev.get("for_request")
                if ev["kind"] == "evict_recompute" \
                        and ev.get("request_id") == request_id:
                    causes.append(
                        f"evicted (recompute) for "
                        f"{ev.get('for_request')}, pool at "
                        f"{ev.get('pressure', 0):.0%}")
                elif ev["kind"] == "admit" and who != request_id:
                    causes.append(
                        f"co-scheduled {ev.get('cache_state', 'cold')} "
                        f"prefill of {who}, pool at "
                        f"{ev.get('pressure', 0):.0%}")
                elif who != request_id:
                    causes.append(
                        f"co-scheduled {ev['kind']} "
                        f"({who or 'pool'}), pool at "
                        f"{ev.get('pressure', 0):.0%}")
                else:
                    causes.append(
                        f"{ev['kind']} of this request, pool at "
                        f"{ev.get('pressure', 0):.0%}")
            gap["cause"] = "; ".join(causes) if causes else None
        d["decision_ring_tail"] = self.decisions.events(limit=32)
        return d

    def recent_timelines(self, n=8) -> list:
        with self._lock:
            tls = list(self._timelines.values())[-int(n):]
        return [tl.summary() for tl in tls]

    # --- loop / lifecycle ---------------------------------------------------
    def start(self):
        """Run the engine loop on a daemon thread; `step()` remains
        callable inline."""
        with self._lock:
            if self._thread is not None:
                return self
            self._running = True
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="paddle-tpu-engine")
            self._thread.start()
        return self

    def _loop(self):
        # grad mode is thread-local: enter inference mode in THIS thread
        with torch.inference_mode():
            while self._running:
                if not self.step():
                    with self._work:
                        if self._running and not self.scheduler.has_work():
                            self._work.wait(timeout=0.05)

    def stop(self, timeout: float = 10.0):
        with self._lock:
            self._running = False
            thread = self._thread
            self._thread = None
        with self._work:
            self._work.notify_all()
        if thread is not None:
            thread.join(timeout=timeout)

    # --- convenience (tests / equivalence) ----------------------------------
    def generate(self, prompts, max_new_tokens=32, eos_token_id=None,
                 timeout: float = 300.0):
        """Submit every prompt and run the engine to completion (inline
        when the loop thread is not running).  Returns a list of int32
        [s0_i + n_generated_i] arrays."""
        handles = [self.submit(p, max_new_tokens,
                               eos_token_id=eos_token_id)
                   for p in prompts]
        if self._thread is None:
            idle = 0
            while any(not h.done.is_set() for h in handles):
                if self.step():
                    idle = 0
                else:
                    idle += 1
                    if idle > 1000:
                        raise RuntimeError(
                            "engine made no progress (scheduler stuck)")
        return [h.result(timeout=timeout) for h in handles]

    def stats(self) -> dict:
        st = self.scheduler.stats()
        st["pages"] = self.pool.stats()
        st["weight_precision"] = "full"
        st["kv_precision"] = self.config.kv_precision or "full"
        st["spec_tokens"] = 0
        st["page_bytes"] = self._page_bytes()
        st["prefix_cache"] = self.prefix_cache_stats()
        st["steps"] = self.steps
        return st
