"""Continuous-batching inference engine over a paged KV cache.

Counterpart of ``paddle_tpu/inference/engine/engine.py``: the exact
tier, the int8 KV tier, the bf16 and int8 weight tiers and draft-model
speculative decoding.
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
pools; here they are fixed-shape programs that update the pool tensors
IN PLACE, each over static device buffers and the pools, which nothing
ever rebinds:

  * the decode step, one per (decode_chunk, KV tier): the tokens, page
    table and lengths in, the tokens out;
  * the cold prefill and its pack as ONE program per (bucket sb, KV
    tier): the left-padded ids [1, sb], the pad start and the span's
    pages [npb] in, the first token out (int32, read after the run);
  * the warm prefill and its pack, one per (sb, npp, KV tier), npp the
    power-of-two prefix bucket: as the cold one, plus the prefix length
    plen (a 0-dim device tensor) and, on the exact tier, the prefix
    pages [npp].  The tail writes at the fixed offset npp * page_size
    of the dense buffers; the prefix keys [plen, npp * page_size) and
    the tail's pad keys are hidden by the pad bias, so the key count
    and the causal offset depend on (sb, npp) only.

The dense K/V buffers of a prefill are temporaries of its program.  On
a CUDA device each program is a CUDA graph (`core.graphs`), and all of
an engine's graphs share one memory pool, so the pool holds about the
largest bucket's buffers.  The decode program's body runs once eagerly
at its first step on all-zero (all-scratch) inputs, touching only
scratch page 0; a prefill program's first run is its first real prefill
(a made-up one would overwrite the staging rows a warm int8 prefill
reads its prefix from).  Either is then captured on the thread that
steps the engine, and every later use copies the host arrays into the
buffers and replays the graph.  On the CPU the same bodies run eagerly.  Free slots ride along pointing at scratch
page 0 with length 0; their output is discarded on the host.

The pack writes every one of a bucket's npb page chunks by device
index, as the JAX pack does: entries past the prompt's pages point at
scratch page 0, which takes their garbage.  Page 0's content (and under
the int8 tier its scale rows) is garbage by design and may differ from
run to run where indices repeat; only free slots and entries past a
sequence's span read it, and their outputs are discarded or masked.

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

The weight tiers (``weight_precision="int8"`` or ``"bf16"``): at
construction every 2-D floating weight of a `Linear` (``[in, out]``,
per-output-channel scales over axis 0) and, when the embedding doubles
as the LM head, the tied embedding (per-row scales over axis 1) are
stored as int8 codes with f32 scales (`ops.quant.quantize_channels`),
or as a bf16 cast.  The caller's model keeps its own weights.  Every
model call of the engine runs under `nn.weights_in_use`, so each
weight is dequantized back to its own dtype where it is used, just
before its matmul or lookup, inside the bodies the graphs capture: a
graph's pool holds one weight's temporary at a time, never a copy of
the model.  `effective_params()` returns the weights the engine
computes with; loaded into the model, plain `generate()` gives the
engine's streams.

Speculative decoding (``spec_tokens=k`` with ``draft_model=``): the
draft keeps full-precision pools of its own geometry under either KV
tier, at the same page ids as the target's (one page table, one
allocator), and its own prefill programs (labels ``prefill_s{sb}_draft``
and ``cprefill_s{sb}_p{npp}_draft``: the same bucket into its pools).
A step is one pass of the spec program (one per (k, KV tier), label
``spec_k{k}``): the draft takes k + 1 single-token steps at
``[max_slots, 1]``, then the target scores all k + 1 positions in one
ragged paged pass of ``max_slots * (k + 1)`` rows, each row at its own
cache position over its slot's page-table row, and the greedy accept
runs on the device; the host reads the tokens g and the counts.  Rows at
or past a slot's limit (prompt + max_new_tokens) go to scratch page 0 at
position 0, so an overflow row never writes a committed position that a
row of the same pass attends (every row writes before any row attends).
The committed stream equals sequential greedy decoding with any draft.

Env knobs (read when the matching ctor arg is None):
  PADDLE_TPU_ENGINE_PAGE_SIZE       tokens per KV page        (16)
  PADDLE_TPU_ENGINE_MAX_PAGES      pool size incl. scratch    (derived)
  PADDLE_TPU_ENGINE_MAX_SLOTS      batch slots                (4)
  PADDLE_TPU_ENGINE_DECODE_CHUNK   decode steps per engine step (1)
  PADDLE_TPU_ENGINE_PREFILL_BUCKET prompt padding granule     (16)
  PADDLE_TPU_ENGINE_MAX_SEQ_LEN    per-sequence token cap     (model's)
  PADDLE_TPU_ENGINE_POOL_HBM_MB    pool byte budget, MiB      (0 = unset)
  PADDLE_TPU_ENGINE_WEIGHT_PRECISION  int8 / bf16 weight tier  (exact)
  PADDLE_TPU_ENGINE_KV_PRECISION   int8 KV tier               (exact)
  PADDLE_TPU_ENGINE_SPEC_TOKENS    draft proposals per pass   (0 = off)
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
from ...nn import Embedding, Linear, weights_in_use
from ...ops.quant import (
    dequantize_channels, quantize_channels, quantize_vectors,
)
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


def _matmul_weights(model) -> dict:
    """``{name: (weight, contraction axis)}`` of the weights the weight
    tiers store narrow (JAX `_matmul_weight_names`): every 2-D floating
    `Linear` weight (``[in, out]``: axis 0), and the embedding when the
    model ties it to the LM head (``x @ w.T``: its output channels are
    vocab rows, so axis 1; the lookup dequantizes the same rows with the
    same scales)."""
    cfg = getattr(model, "cfg", None)
    vocab = int(getattr(cfg, "vocab_size", 0))
    tied = bool(getattr(cfg, "tie_embeddings", False))
    out = {}
    for prefix, layer in model.named_modules():
        w = getattr(layer, "weight", None)
        if not isinstance(w, torch.Tensor) or w.dim() != 2 \
                or not w.is_floating_point():
            continue
        name = f"{prefix}.weight" if prefix else "weight"
        if isinstance(layer, Linear):
            out[name] = (w, 0)
        elif tied and isinstance(layer, Embedding) and w.shape[0] == vocab:
            out[name] = (w, 1)
    return out


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


class _PrefillProgram:
    """The static device buffers of a prefill program at bucket sb (and,
    warm, prefix bucket npp): ids [1, sb] int32, start [1] int32 (the
    pad length) and pages [npb] int64 in, and for the warm program plen
    (0-dim int32) and, where the prefix is read from pools (the exact
    tier, or any tier with a draft model), prefix_pages [npp] int64; tok
    [1] int32 out.  On a CUDA device `graph` replays the prefill and its
    pack over them (`dgraph` the draft's) and `bound` is what they hold
    of the pools and the staging buffers.  It keeps no reference to the
    engine."""

    def __init__(self, sb, npp, npb, exact, device):
        def buf(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.sb, self.npp = sb, npp
        self.ids, self.start, self.tok = buf(1, sb), buf(1), buf(1)
        self.pages = buf(npb, dtype=torch.long)
        self.plen = self.prefix_pages = None
        if npp is not None:
            self.plen = buf()
            if exact:
                self.prefix_pages = buf(npp, dtype=torch.long)
        # the target's graph and the draft's (speculative decoding)
        self.graph = self.dgraph = self.bound = None


class _SpecProgram:
    """The static int32 device buffers of the spec program of k
    proposals: tok, lengths and limits [max_slots] and pt [max_slots,
    max_pages_per_seq] in, the target's tokens g [max_slots, k + 1] and
    the committed counts [max_slots] out; on a CUDA device its graph and
    what it holds of the pools."""

    def __init__(self, slots, pages, k, device):
        def buf(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=device)

        self.k = k
        self.tok, self.pt = buf(slots), buf(slots, pages)
        self.lengths, self.limits = buf(slots), buf(slots)
        self.g, self.counts = buf(slots, k + 1), buf(slots)
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
        # {weight: (stored, scales or None, dtype)}, `weights_in_use`'s map
        self._wq = {}
        self._wq_names = {}
        if cfg.weight_precision is not None:
            self._quantize_weights()
        self._draft = None
        if cfg.spec_tokens > 0:
            if draft_model is None:
                raise ValueError(
                    "spec_tokens > 0 needs a draft_model at engine "
                    "construction")
            self._init_draft(draft_model)
        elif draft_model is not None:
            raise ValueError(
                "draft_model given but config.spec_tokens == 0 — set "
                "spec_tokens (or PADDLE_TPU_ENGINE_SPEC_TOKENS) to the "
                "draft proposal length")
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
            # int8 tier with prefix caching: per layer [P, Hkv,
            # page_size, D] in the model's dtype, P the most pages a
            # prefill spans or a prefix bucket holds.  A prefill program
            # writes its span's exact page chunks here (the commit clones
            # the new full pages into the radix nodes' sidecar), and a
            # warm one reads its prefix pages from here (filled from the
            # sidecar before it runs).
            self._stage_k = self._stage_v = None
            if self._quant and self._prefix is not None:
                rows = max(-(-self._bucket(cfg.max_seq_len)
                             // cfg.page_size),
                           self._prefix_bucket(self.max_pages_per_seq))
                stage = (rows, self._hkv, cfg.page_size, self._hd)
                self._stage_k = [torch.zeros(stage, dtype=self._dtype,
                                             device=self._device)
                                 for _ in range(self._layers)]
                self._stage_v = [torch.zeros(stage, dtype=self._dtype,
                                             device=self._device)
                                 for _ in range(self._layers)]
            if self._draft is not None:
                self._init_draft_pools()
        self._programs = {}        # (n, kv tier) -> _DecodeProgram
        self._specs = {}           # (k, kv tier) -> _SpecProgram
        self._prefills = {}        # (sb, npp, kv tier) -> _PrefillProgram
        self._mempool = None       # the graphs' shared memory pool
        self._handles = {}         # request_id -> RequestHandle
        self._lock = threading.RLock()
        self._work = threading.Condition()
        self._thread = None
        self._running = False
        self.steps = 0
        # programs run: each prefill launches every layer's attention
        # once, each decode step `decode_chunk` times (a replica's
        # launch counts are checked against these from outside it)
        self.prefill_count = 0
        self.decode_steps = 0
        self.spec_passes = 0
        _metrics.set_gauge("engine.weight_precision", 1,
                           precision=cfg.weight_precision or "full")
        _metrics.set_gauge("paged.pool_precision", 1,
                           precision=cfg.kv_precision or "full")
        _metrics.set_gauge("engine.spec_tokens", cfg.spec_tokens)

    def _page_bytes(self) -> int:
        """Device bytes ONE page costs across all layers (K + V pools,
        plus the scale tables under the int8 KV tier, plus the draft's
        pools) — the unit the ``pool_hbm_mb`` budget divides."""
        if self._quant:
            item, scale_item = 1, 4
        else:
            item = torch.empty((), dtype=self._dtype).element_size()
            scale_item = 0
        ps = self.config.page_size
        slots = self._hkv * ps
        per_pool = slots * self._hd * item + slots * scale_item
        total = self._layers * 2 * per_pool
        if self._draft is not None:
            d = self._draft
            total += d["layers"] * 2 * d["hkv"] * ps * d["hd"] * torch.empty(
                (), dtype=d["dtype"]).element_size()
        return max(1, total)

    # --- weight tiers and the draft (built once, at construction) -----------
    def _quantize_weights(self) -> None:
        """Store every weight of `_matmul_weights` narrow: int8 codes and
        f32 per-channel scales, or a bf16 cast (JAX `_quantize_weights`).
        The model's own weights stay as they are."""
        prec = self.config.weight_precision
        with torch.inference_mode():
            for name, (w, axis) in _matmul_weights(self._model).items():
                if prec == "int8":
                    q, scales = quantize_channels(w, axis=axis)
                else:
                    q, scales = w.to(torch.bfloat16), None
                self._wq[w] = (q, scales, w.dtype)
                self._wq_names[name] = w

    def effective_params(self) -> dict:
        """``{name: tensor}`` of every parameter of the model as the
        engine computes with it: the stored weights dequantized, the rest
        the model's own.  Loaded into the model (`load_reference_state`),
        plain `generate()` gives the engine's streams."""
        with torch.inference_mode():
            out = {name: p.detach()
                   for name, p in self._model.named_parameters()}
            for name, w in self._wq_names.items():
                q, scales, dtype = self._wq[w]
                out[name] = q.to(dtype) if scales is None \
                    else dequantize_channels(q, scales, dtype)
        return out

    def _init_draft(self, draft_model) -> None:
        draft_model.eval()
        with torch.inference_mode():
            probe = draft_model.init_kv_caches(1, 1)
        tv = int(getattr(getattr(self._model, "cfg", None), "vocab_size", 0))
        dv = int(getattr(getattr(draft_model, "cfg", None), "vocab_size", 0))
        if tv and dv and tv != dv:
            raise ValueError(
                f"draft vocab_size {dv} != target vocab_size {tv} — "
                f"proposals would index a different token space")
        self._draft = {
            "model": draft_model,
            "layers": len(probe),
            "hkv": probe[0][0].shape[1],
            "hd": probe[0][0].shape[3],
            "dtype": probe[0][0].dtype,
        }

    def _init_draft_pools(self) -> None:
        """The draft's pools: the target's page ids, its own geometry, its
        own dtype under either KV tier (the draft is small)."""
        d, cfg = self._draft, self.config
        shape = (cfg.num_pages, d["hkv"], cfg.page_size, d["hd"])
        for key in ("k_pools", "v_pools"):
            d[key] = [torch.zeros(shape, dtype=d["dtype"],
                                  device=self._device)
                      for _ in range(d["layers"])]

    def _forward(self, draft, *args, **kwargs):
        """One call of the target model (under its stored weights) or of
        the draft."""
        if draft:
            return self._draft["model"](*args, **kwargs)
        with weights_in_use(self._wq):
            return self._model(*args, **kwargs)

    def _sides(self) -> tuple:
        """The `draft` flags of the models a prefill runs: the target,
        then the draft when there is one."""
        return (False, True) if self._draft is not None else (False,)

    def _geometry(self, draft):
        """(layers, kv heads, head dim, dtype) of the target or the
        draft."""
        if draft:
            d = self._draft
            return d["layers"], d["hkv"], d["hd"], d["dtype"]
        return self._layers, self._hkv, self._hd, self._dtype

    def _tensor(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(
            self._device, non_blocking=True)

    # --- model steps (counterparts of the JAX engine's jitted programs) -----
    def _dense_prefill(self, sb: int, ids, start, draft=False):
        """`_prefill_program`'s forward on device inputs: ids [1, sb]
        int32, start [1] int32.  Returns (greedy first token [1] int32,
        dense K bufs, dense V bufs); the dense capacity is sb + page_size
        so the pack's last page slice never runs past the buffer.  The
        target's, or with `draft` the draft's."""
        layers, hkv, hd, dtype = self._geometry(draft)
        cap = sb + self.config.page_size
        caches = [(torch.zeros(1, hkv, cap, hd, dtype=dtype,
                               device=self._device),
                   torch.zeros(1, hkv, cap, hd, dtype=dtype,
                               device=self._device))
                  for _ in range(layers)]
        logits, new = self._forward(draft, ids, kv_caches=caches,
                                    cache_pos=0, attn_start=start)
        tok = logits[:, -1].float().argmax(-1).to(torch.int32)
        return tok, [c[0] for c in new], [c[1] for c in new]

    def _dense_cached_prefill(self, sb: int, npp: int, ids, start, plen,
                              prefix_k, prefix_v, draft=False):
        """`_cached_prefill_program`'s forward: the cached prefix, per
        layer [npp, Hkv, page_size, D] pages (`prefix_k`, `prefix_v`),
        lays out as a dense buffer at [0, npp * page_size), of which the
        first `plen` tokens are real (an int or a 0-dim device tensor);
        the tail (left-padded to bucket sb) writes at npp * page_size
        under `warm_prefill_guard`, so each tail query attends the real
        prefix + causal tail.  Returns as `_dense_prefill`."""
        layers, hkv, hd, dtype = self._geometry(draft)
        ps = self.config.page_size
        pcap = npp * ps

        def dense(pages):
            g = pages.transpose(0, 1).reshape(hkv, pcap, hd)
            return torch.cat(
                [g[None].to(dtype),
                 torch.zeros(1, hkv, sb + ps, hd, dtype=dtype,
                             device=self._device)], dim=2)

        caches = [(dense(prefix_k[li]), dense(prefix_v[li]))
                  for li in range(layers)]
        with GEN.warm_prefill_guard(pcap):
            logits, new = self._forward(draft, ids, kv_caches=caches,
                                        cache_pos=plen, attn_start=start)
        tok = logits[:, -1].float().argmax(-1).to(torch.int32)
        return tok, [c[0] for c in new], [c[1] for c in new]

    def _pack_pages(self, kbufs, vbufs, pages, offset, draft=False) -> None:
        """`_pack_program` on device inputs: copy page-size chunks of the
        dense buffers, from offset[0] + i * page_size, into pages[i] (in
        place) for every i, scratch entries included (page 0 takes their
        garbage, as in the JAX program).  A chunk that would run past the
        buffer is clamped to its end, as `lax.dynamic_slice` does (only
        entries past the prompt's span, whose slots decode overwrites
        before reading, can hit this).  Under the int8 KV tier each
        [Hkv, page_size, D] chunk quantizes per vector, the codec of the
        decode write, so the packed pages equal what token-by-token
        writes would have stored; with prefix caching the exact chunks
        also land in the staging buffers, chunk i in row i.  With `draft`
        the draft's buffers into its own (exact) pools."""
        _, hkv, hd, _ = self._geometry(draft)
        ps = self.config.page_size
        cap = kbufs[0].shape[2]
        npb = pages.shape[0]
        ar = torch.arange(max(npb, ps), device=self._device)
        lows = torch.clamp(offset.long() + ps * ar[:npb], max=cap - ps)
        idx = (lows[:, None] + ar[None, :ps]).reshape(-1)
        if draft:
            d = self._draft
            sides = ((d["k_pools"], None, kbufs, None),
                     (d["v_pools"], None, vbufs, None))
        else:
            sides = ((self._k_pools, self._k_scales, kbufs, self._stage_k),
                     (self._v_pools, self._v_scales, vbufs, self._stage_v))
        for pools, scales, bufs, stage in sides:
            for li, (pool, buf) in enumerate(zip(pools, bufs)):
                chunk = buf[0].index_select(1, idx)          # [hkv, n*ps, d]
                chunk = chunk.reshape(hkv, npb, ps, hd) \
                    .transpose(0, 1)                         # [n, hkv, ps, d]
                if stage is not None:
                    stage[li][:npb].copy_(chunk)
                if scales is not None:
                    pool[pages], scales[li][pages] = quantize_vectors(chunk)
                else:
                    pool[pages] = chunk.to(pool.dtype)

    def _run_prefill(self, sb: int, ids, start: int):
        """The cold prefill alone, eagerly, from host inputs (ids [1, sb]
        int32, start the pad length): (first token, dense K bufs, dense V
        bufs)."""
        tok, kbufs, vbufs = self._dense_prefill(sb, self._tensor(ids),
                                                self._tensor([start]))
        return int(tok[0]), kbufs, vbufs

    def _run_pack(self, kbufs, vbufs, pages, start: int) -> None:
        """The pack alone, eagerly, from host inputs: pages [npb] int32
        from buffer offset `start` (`_pack_pages`)."""
        self._pack_pages(kbufs, vbufs, self._tensor(pages, torch.long),
                         self._tensor([start]))

    def _run_cached_prefill(self, sb: int, npp: int, ids, start: int,
                            plen: int, prefix_k, prefix_v):
        """The warm prefill alone, eagerly, from host inputs: returns as
        `_run_prefill`, the tail at npp * page_size + start of the
        returned buffers."""
        tok, kbufs, vbufs = self._dense_cached_prefill(
            sb, npp, self._tensor(ids), self._tensor([start]),
            self._tensor(plen), prefix_k, prefix_v)
        return int(tok[0]), kbufs, vbufs

    def _prefill_body(self, prog, draft=False) -> None:
        """The body of a prefill program: the cold or warm prefill of
        `prog`'s static inputs, its first token into prog.tok, and the
        pack of its span's pages.  The warm program's prefix comes from
        the pools (exact tier) or the staging buffers (int8 tier).  With
        `draft` the draft's prefill of the same inputs into its own pools
        (its prefix always from them); its token is not used."""
        if prog.npp is None:
            tok, kbufs, vbufs = self._dense_prefill(prog.sb, prog.ids,
                                                    prog.start, draft)
            offset = prog.start
        else:
            if draft:
                prefix_k = [pool[prog.prefix_pages]
                            for pool in self._draft["k_pools"]]
                prefix_v = [pool[prog.prefix_pages]
                            for pool in self._draft["v_pools"]]
            elif self._quant:
                prefix_k = [st[:prog.npp] for st in self._stage_k]
                prefix_v = [st[:prog.npp] for st in self._stage_v]
            else:
                prefix_k = [pool[prog.prefix_pages] for pool in self._k_pools]
                prefix_v = [pool[prog.prefix_pages] for pool in self._v_pools]
            tok, kbufs, vbufs = self._dense_cached_prefill(
                prog.sb, prog.npp, prog.ids, prog.start, prog.plen,
                prefix_k, prefix_v, draft)
            offset = prog.start + prog.npp * self.config.page_size
        self._pack_pages(kbufs, vbufs, prog.pages, offset, draft)
        if not draft:
            prog.tok.copy_(tok)

    def _prefill_body_all(self, prog) -> None:
        """The eager run of a prefill: the target's body, then the
        draft's."""
        for draft in self._sides():
            self._prefill_body(prog, draft)

    def _prefill_tensors(self) -> list:
        """The pools, scale tables and staging buffers a prefill graph
        reads and writes."""
        return self._pool_tensors() + (
            self._stage_k + self._stage_v if self._stage_k else [])

    def _prefill_program(self, sb: int, npp=None) -> "_PrefillProgram":
        """`_prefill_program` + `_pack_program` (cold, npp None) or
        `_cached_prefill_program` + `_pack_program` (warm): the static
        buffers of the key (sb, npp, KV tier), made at its first
        prefill; on a CUDA device `_replay_prefill` captures their graph
        then."""
        key = (sb, npp, self.config.kv_precision)
        if key not in self._prefills:
            # the draft's warm prefill reads its prefix from its pools
            self._prefills[key] = _PrefillProgram(
                sb, npp, -(-sb // self.config.page_size),
                not self._quant or self._draft is not None, self._device)
        return self._prefills[key]

    def _graph_pool(self):
        """The memory pool every graph of this engine is captured in."""
        if self._mempool is None:
            self._mempool = torch.cuda.graph_pool_handle()
        return self._mempool

    def _capture_prefill(self, prog, draft=False) -> None:
        """Run the body eagerly on the capture stream over the inputs
        loaded into `prog` (the first prefill of the program: a real
        one, whose results it leaves in the pools, the staging buffers
        and prog.tok), then capture it into the program's graph (with
        `draft`, the draft's graph), timed under the JAX label of the
        prefill (`_prefill_label`).  A failure raises."""
        body = functools.partial(self._prefill_body, prog, draft)
        stream = GR.capture_stream(self._device)
        _, graph = GR.capture(body, stream, self._prefill_label(prog, draft),
                              pool=self._graph_pool())
        if draft:
            prog.dgraph = graph
        else:
            prog.graph = graph
        prog.bound = GR.addresses(self._prefill_tensors())

    def _prefill_label(self, prog, draft=False) -> str:
        """The label of the JAX program whose role `prog`'s graph takes:
        ``prefill_s{sb}`` (cold) or ``cprefill_s{sb}_p{npp}`` (warm;
        ``_q`` on the int8 tier), ``_draft`` appended for the draft's.
        One graph holds the prefill and its pack, two programs in the
        JAX package, and takes the prefill's label."""
        if prog.npp is None:
            label = f"prefill_s{prog.sb}"
        else:
            label = f"cprefill_s{prog.sb}_p{prog.npp}" + (
                "_q" if self._quant and not draft else "")
        return label + ("_draft" if draft else "")

    def _run_prefill_program(self, prog, ids, start: int, pages, plen=0,
                             prefix_pages=None) -> int:
        """One prefill and its pack from host arrays: ids [1, sb], the pad
        length `start`, the span's pages [npb]; warm also the prefix
        length `plen` and on the exact tier its pages [npp].  Returns the
        first token."""
        self._load_prefill(prog, ids, start, pages, plen, prefix_pages)
        if self._device.type == "cpu":
            self._prefill_body_all(prog)
        else:
            self._replay_prefill(prog)
        return int(prog.tok[0])

    @staticmethod
    def _load_prefill(prog, ids, start, pages, plen, prefix_pages) -> None:
        """Copy a prefill's host inputs into `prog`'s static buffers."""
        for dst, src in ((prog.ids, ids), (prog.start, [start]),
                         (prog.pages, pages), (prog.plen, plen),
                         (prog.prefix_pages, prefix_pages)):
            if dst is not None:
                # on the current stream, so ordered before the replay
                dst.copy_(torch.as_tensor(np.asarray(src)),
                          non_blocking=True)

    def _replay_prefill(self, prog) -> None:
        """The CUDA path of `_run_prefill_program`: the program's graph
        replayed (then the draft's), or at its first prefill the body run
        and captured.  A warm-up on made-up inputs would write the
        staging rows the warm int8 program reads its prefix from, so the
        first run is the real one, as a train step's first step is."""
        if prog.graph is None:
            for draft in self._sides():
                self._capture_prefill(prog, draft)
            return
        if GR.addresses(self._prefill_tensors()) != prog.bound:
            raise RuntimeError(
                "the engine's page pools were rebound after a prefill "
                "graph captured them; pools must be updated in place")
        prog.graph.replay()
        if self._draft is not None:
            prog.dgraph.replay()

    def _caches(self, pt, draft=False) -> list:
        """The per-layer paged caches over page table pt: 5-tuples with
        the scale tables under the int8 KV tier, else 3-tuples (the
        draft's always)."""
        if draft:
            return [(k, v, pt) for k, v in zip(self._draft["k_pools"],
                                               self._draft["v_pools"])]
        if self._quant:
            return [(k, v, pt, ks, vs) for k, v, ks, vs in zip(
                self._k_pools, self._v_pools, self._k_scales,
                self._v_scales)]
        return [(k, v, pt) for k, v in zip(self._k_pools, self._v_pools)]

    def _decode_body(self, n: int, tok, pt, lengths, toks):
        """The body of `_decode_program`: n ragged decode steps at the
        fixed [max_slots] batch from tok [max_slots] at lengths
        [max_slots] over page table pt, each step's greedy tokens
        written into toks [max_slots, n] (all int32, on the device).  The
        pools (and scale tables) update in place."""
        caches = self._caches(pt)
        for j in range(n):
            logits, _ = self._forward(False, tok[:, None], kv_caches=caches,
                                      cache_pos=lengths)
            tok = logits[:, -1].float().argmax(-1).to(torch.int32)
            toks[:, j] = tok
            lengths = lengths + 1
        return toks

    def _pool_tensors(self) -> list:
        """The pools and scale tables the engine's graphs write (the
        draft's pools last)."""
        return self._k_pools + self._v_pools + (
            self._k_scales + self._v_scales if self._quant else []) + (
            self._draft["k_pools"] + self._draft["v_pools"]
            if self._draft is not None else [])

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
        it into the program's graph, timed as ``decode_n{n}``.  A failure
        raises."""
        body = functools.partial(self._decode_body, n, prog.tok, prog.pt,
                                 prog.lengths, prog.toks)
        stream = GR.capture_stream(self._device)
        _, prog.graph = GR.capture(body, stream, f"decode_n{n}",
                                   pool=self._graph_pool())
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
        """Replay a decode or spec program's graph, which holds the
        pools' addresses."""
        if GR.addresses(self._pool_tensors()) != prog.bound:
            raise RuntimeError(
                "the engine's page pools were rebound after the decode "
                "graph captured them; pools must be updated in place")
        prog.graph.replay()

    def _spec_body(self, prog) -> None:
        """The body of the spec program (JAX `_spec_program`): one pass
        of k = prog.k proposals at the fixed [max_slots] batch from
        prog's tok, lengths, limits and page table.  The draft takes
        k + 1 single-token steps (the last writes the last proposal's K/V,
        so a fully accepted pass leaves its cache complete); the target
        then scores the k + 1 positions of every slot in one ragged paged
        pass of max_slots * (k + 1) rows, row (s, i) at position
        lengths[s] + i over slot s's page-table row.  A row at or past
        limits[s] goes to scratch page 0 at position 0: unmasked, its
        page lookup would hit a live page and its write a committed
        position that the pass's valid rows attend (all rows write before
        any row attends).  Writes the target's tokens into prog.g and
        1 + the accepted prefix (proposal i kept while it equals the
        target's token i) into prog.counts."""
        k, n = prog.k, prog.k + 1
        tok, pt, lengths, limits = prog.tok, prog.pt, prog.lengths, \
            prog.limits
        cur, pos, props = tok, lengths, []
        for _ in range(n):
            ok = pos < limits
            logits, _ = self._forward(
                True, cur[:, None],
                kv_caches=self._caches(torch.where(ok[:, None], pt, 0),
                                       draft=True),
                cache_pos=torch.where(ok, pos, 0))
            cur = logits[:, -1].float().argmax(-1).to(torch.int32)
            props.append(cur)
            pos = pos + 1
        props = torch.stack(props[:k], dim=1)                    # [S, k]
        ids = torch.cat([tok[:, None], props], dim=1).reshape(-1, 1)
        steps = torch.arange(n, dtype=torch.int32, device=tok.device)
        pos_f = (lengths[:, None] + steps[None, :]).reshape(-1)
        ok_f = pos_f < limits.repeat_interleave(n)
        pt_f = torch.where(ok_f[:, None], pt.repeat_interleave(n, dim=0), 0)
        logits, _ = self._forward(False, ids, kv_caches=self._caches(pt_f),
                                  cache_pos=torch.where(ok_f, pos_f, 0))
        g = logits[:, -1].float().argmax(-1).to(torch.int32).reshape(-1, n)
        match = (props == g[:, :k]).to(torch.int32)
        prog.g.copy_(g)
        prog.counts.copy_(match.cumprod(dim=1).sum(dim=1) + 1)

    def _spec_program(self, k: int) -> "_SpecProgram":
        """`_spec_program`: the static buffers of a pass of k proposals,
        and on a CUDA device its graph, built at the first pass of the
        key (k, KV tier).  The graph's warm-up runs on the zero buffers:
        every limit 0, so every row goes to scratch page 0."""
        key = (k, self.config.kv_precision)
        prog = self._specs.get(key)
        if prog is None:
            prog = _SpecProgram(self.config.max_slots,
                                self.max_pages_per_seq, k, self._device)
            if self._device.type == "cuda":
                self._capture_spec(prog)
            self._specs[key] = prog
        return prog

    def _capture_spec(self, prog) -> None:
        """Warm the spec body up on the program's zero buffers, then
        capture it, timed as ``spec_k{k}``.  A failure raises."""
        body = functools.partial(self._spec_body, prog)
        stream = GR.capture_stream(self._device)
        _, prog.graph = GR.capture(body, stream, f"spec_k{prog.k}",
                                   pool=self._graph_pool())
        prog.bound = GR.addresses(self._pool_tensors())

    def _run_spec(self, k: int, tok, pt, lengths, limits):
        """One spec pass from host arrays (int32: tok, lengths, limits
        [max_slots], pt [max_slots, max_pages_per_seq]).  Returns the
        target's tokens [max_slots, k + 1] and the counts [max_slots] as
        host arrays."""
        prog = self._spec_program(k)
        for dst, src in ((prog.tok, tok), (prog.pt, pt),
                         (prog.lengths, lengths), (prog.limits, limits)):
            dst.copy_(torch.from_numpy(src), non_blocking=True)
        if self._device.type == "cpu":
            self._spec_body(prog)
        else:
            self._replay_decode(prog)
        return (prog.g.to("cpu", copy=True).numpy(),
                prog.counts.to("cpu", copy=True).numpy())

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
            # a spec pass writes up to spec_tokens + 1 positions: the
            # scheduler provisions pages for the whole pass
            chunk = (self.config.spec_tokens + 1 if self._draft is not None
                     else self.config.decode_chunk)
            with _trace.span("engine.schedule", cat="engine"):
                out = self.scheduler.schedule(chunk)
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
                if self._draft is not None:
                    self._spec_decode(running)
                else:
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
        self.prefill_count += 1
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
                t0 = self._warm_prefill(seq, prompt, shared)
            else:
                t0 = self._cold_prefill(seq, prompt)
            self._commit_prefix(seq)
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

    def _cold_prefill(self, seq, prompt) -> int:
        """Dense prefill from token 0 and its pack; returns the first
        token.  Prompt token t sits at buffer offset pad_start + t and
        packs from there."""
        s0 = prompt.size
        sb = self._bucket(s0)
        start = sb - s0
        ids = np.zeros((1, sb), np.int32)
        ids[0, start:] = prompt
        npb = -(-sb // self.config.page_size)
        pages = np.zeros((npb,), np.int32)
        n_real = min(len(seq.pages), npb)
        pages[:n_real] = seq.pages[:n_real]
        return self._run_prefill_program(self._prefill_program(sb), ids,
                                         start, pages)

    @staticmethod
    def _prefix_bucket(n_pages: int) -> int:
        """Prefix page capacity bucket: next power of two (keeps the
        buffer shapes, and the JAX program set, bounded)."""
        npp = 1
        while npp < n_pages:
            npp *= 2
        return npp

    def _warm_prefill(self, seq, prompt, shared) -> int:
        """Prefill ONLY the tail [shared, s0): the cached prefix pages
        are already in the sequence's table.  The tail's K/V packs into
        the sequence's PRIVATE tail pages (the scheduler never shares
        the boundary page), so no shared page is written.  The prefix
        comes from the pools, or under the int8 KV tier from the
        matched nodes' exact sidecar.  Returns the first token."""
        ps = self.config.page_size
        tail = prompt[shared:]
        sb = self._bucket(tail.size)
        start = sb - tail.size
        npa = shared // ps
        npp = self._prefix_bucket(npa)
        ids = np.zeros((1, sb), np.int32)
        ids[0, start:] = tail
        prefix_pages = None
        if self._quant:
            self._sidecar_prefix(seq, npa)
        if not self._quant or self._draft is not None:
            # the exact target's prefix, and the draft's, in the pools
            prefix_pages = np.zeros((npp,), np.int32)
            prefix_pages[:npa] = seq.pages[:npa]
        # tail page i takes tail tokens [i * ps, (i + 1) * ps)
        npb = -(-sb // ps)
        tpages = np.zeros((npb,), np.int32)
        n_tail = max(0, min(len(seq.pages) - npa, npb))
        tpages[:n_tail] = seq.pages[npa:npa + n_tail]
        return self._run_prefill_program(self._prefill_program(sb, npp), ids,
                                         start, tpages, shared, prefix_pages)

    def _sidecar_prefix(self, seq, npa) -> None:
        """int8 KV tier: copy the matched radix nodes' commit-time exact
        page copies into rows [0, npa) of the staging buffers, the warm
        program's prefix (rows past npa are hidden keys)."""
        nodes = seq.shared_nodes[:npa]
        if any(node.exact is None for node in nodes):
            raise RuntimeError(
                "prefix-cache node without an exact sidecar "
                "under kv_precision=int8 (commit-path bug)")
        for li in range(self._layers):
            for stage, kv in ((self._stage_k, 0), (self._stage_v, 1)):
                torch.stack([node.exact[li][kv] for node in nodes],
                            out=stage[li][:npa])

    def _commit_prefix(self, seq) -> None:
        """Register the ORIGINAL prompt's full pages in the radix index
        (the partial tail page stays private — decode still writes it).
        Under the int8 tier each new full page also keeps an exact copy
        per layer (the sidecar), cloned from the staging buffers that the
        prefill just filled: the prefilled span's page chunk i (cold: the
        prompt's page i; warm: page shared / page_size + i) in row i."""
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
            # clones: the next prefill rewrites the staging buffers
            copies = [(sk[:n_full - sc].clone(), sv[:n_full - sc].clone())
                      for sk, sv in zip(self._stage_k, self._stage_v)]
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
        self.decode_steps += 1
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

    def _spec_decode(self, running) -> None:
        """One spec pass over the running sequences: each commits the
        target's tokens g[:count] (stopping at an eos inside them)."""
        self.spec_passes += 1
        cfg = self.config
        k = cfg.spec_tokens
        t_step = time.perf_counter()
        tok, pt, lengths = self._batch_arrays(running)
        # each slot's lifetime cap in cache positions; free slots keep 0,
        # so every row of theirs is masked
        limits = np.zeros((cfg.max_slots,), np.int32)
        for seq in running:
            limits[seq.slot] = seq.prompt.size + seq.max_new_tokens
        with _trace.span("engine.decode", cat="engine", batch=len(running),
                         chunk=k + 1, spec=True,
                         occupancy=len(running) / cfg.max_slots):
            g, counts = self._run_spec(k, tok, pt, lengths, limits)
        with _trace.span("engine.detokenize", cat="engine",
                         batch=len(running), chunk=k + 1):
            for seq in running:
                row, cnt = g[seq.slot], int(counts[seq.slot])
                # cnt - 1 proposals accepted, the rest of the k rejected
                # (their cache slots are rewritten before anything
                # attends them)
                _metrics.inc("engine.spec_decode", cnt - 1,
                             result="accepted")
                _metrics.inc("engine.spec_decode", k - (cnt - 1),
                             result="rejected")
                for j in range(cnt):
                    if seq.done:
                        break  # mid-pass finish (eos): the rest is not output
                    self._accept(seq, int(row[j]))
                seq.length += cnt
                seq.last_token = int(row[cnt - 1])
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
            # the draft's pools move with the target's
            tables = self._pool_tensors()
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
        st["weight_precision"] = self.config.weight_precision or "full"
        st["kv_precision"] = self.config.kv_precision or "full"
        st["spec_tokens"] = self.config.spec_tokens if self._draft else 0
        st["page_bytes"] = self._page_bytes()
        st["prefix_cache"] = self.prefix_cache_stats()
        st["steps"] = self.steps
        return st
