"""GPT family (``paddle_tpu/models/gpt.py`` counterpart): the serving
forward, the training forward with the fused LM head + cross entropy,
`GPTPretrainingCriterion`, and the LLaMA variant (``use_rope``,
``use_rmsnorm``, ``use_swiglu``, an untied LM head; the legacy
`llama_7b` preset).

Parameter names and shapes equal the JAX package's
``functional_state()`` names (``gpt.h.0.attn.qkv_proj.weight`` is
``[in, out]``), so `load_reference_state` carries weights across
one to one.  The JAX model's ``mpu.*ParallelLinear`` layers are plain
`Linear` here under the same attribute names.  Dropout, recompute and
the sequence / context parallel flags are not ported: setting one
raises NotImplementedError.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..nn import Embedding, LayerNorm, Linear, RMSNorm, weight_in_use
from ..nn import functional as F
from .generation import (
    GenerationMixin, _static_cache_attention, decode_position_ids,
    forward_phases, init_kv_caches,
)

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM",
           "GPTPretrainingCriterion", "gpt_tiny", "gpt_1p3b", "llama_7b",
           "load_reference_state"]


def refuse_unported(owner, **options):
    """Training options the port has not ported yet raise when set."""
    for name, value in options.items():
        if value:
            raise NotImplementedError(
                f"{owner}({name}={value!r}) is not ported yet (ROADMAP "
                "Queue A)")


class GPTConfig:
    """The JAX package's GPTConfig: the GPT-2 family, and the LLaMA
    variant with ``use_rope`` / ``use_rmsnorm`` / ``use_swiglu`` and
    ``tie_embeddings=False``."""

    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, max_seq_len=1024, ffn_hidden=None,
                 dropout=0.0, attn_dropout=0.0, use_rope=False,
                 use_rmsnorm=False, use_swiglu=False, tie_embeddings=True,
                 recompute=False, sequence_parallel=False,
                 context_parallel=False,
                 layer_norm_eps=1e-5, fused_head_ce=False):
        refuse_unported("GPTConfig", dropout=dropout,
                        attn_dropout=attn_dropout, recompute=recompute,
                        sequence_parallel=sequence_parallel,
                        context_parallel=context_parallel)
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_seq_len = max_seq_len
        # SwiGLU: 8/3 of the width, rounded to 128 (JAX :43-45)
        self.ffn_hidden = ffn_hidden or (
            int(8 * hidden_size / 3 / 128 + 1) * 128 if use_swiglu
            else 4 * hidden_size)
        self.use_rope = use_rope
        self.use_rmsnorm = use_rmsnorm
        self.use_swiglu = use_swiglu
        self.tie_embeddings = tie_embeddings
        self.layer_norm_eps = layer_norm_eps
        # training returns hidden states; GPTPretrainingCriterion fuses
        # the LM-head projection into the chunked CE (the [B,S,V] logits
        # never materialize)
        self.fused_head_ce = fused_head_ce


def _norm(cfg, device, dtype):
    if cfg.use_rmsnorm:
        return RMSNorm(cfg.hidden_size, cfg.layer_norm_eps, device=device,
                       dtype=dtype)
    return LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device=device,
                     dtype=dtype)


class GPTAttention(nn.Module):
    def __init__(self, cfg, **kw):
        super().__init__()
        self.cfg = cfg
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.qkv_proj = Linear(cfg.hidden_size, 3 * cfg.hidden_size, **kw)
        self.out_proj = Linear(cfg.hidden_size, cfg.hidden_size, **kw)

    def forward(self, x, rope=None, kv_cache=None, cache_pos=None,
                attn_start=None):
        """`rope`: the forward's (cos, sin) under ``use_rope``
        (`GPTModel.forward`), else None."""
        b, s, h = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv.unbind(dim=2)
        if self.cfg.use_rope:
            q, k = F.rotate_qk(q, k, rope)
        if kv_cache is not None:
            out, new_cache = _static_cache_attention(
                q, k, v, kv_cache, cache_pos, attn_start)
            return self.out_proj(out.reshape(b, s, h)), new_cache
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.out_proj(out.reshape(b, s, h))


class GPTMLP(nn.Module):
    def __init__(self, cfg, **kw):
        super().__init__()
        self.use_swiglu = cfg.use_swiglu
        if cfg.use_swiglu:
            self.gate_up_proj = Linear(cfg.hidden_size, 2 * cfg.ffn_hidden,
                                       **kw)
        else:
            self.up_proj = Linear(cfg.hidden_size, cfg.ffn_hidden, **kw)
        self.down_proj = Linear(cfg.ffn_hidden, cfg.hidden_size, **kw)

    def forward(self, x):
        if self.use_swiglu:
            return self.down_proj(F.swiglu(self.gate_up_proj(x)))
        return self.down_proj(F.gelu(self.up_proj(x), approximate=True))


class GPTBlock(nn.Module):
    def __init__(self, cfg, *, device, dtype, generator):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.ln_1 = _norm(cfg, device, dtype)
        self.attn = GPTAttention(cfg, **kw)
        self.ln_2 = _norm(cfg, device, dtype)
        self.mlp = GPTMLP(cfg, **kw)

    def forward(self, x, rope=None, kv_cache=None, cache_pos=None,
                attn_start=None):
        if kv_cache is not None:
            a, new_cache = self.attn(self.ln_1(x), rope, kv_cache=kv_cache,
                                     cache_pos=cache_pos,
                                     attn_start=attn_start)
            x = x + a
            x = x + self.mlp(self.ln_2(x))
            return x, new_cache
        x = x + self.attn(self.ln_1(x), rope)
        return x + self.mlp(self.ln_2(x))


class GPTModel(nn.Module):
    def __init__(self, cfg, *, device, dtype, generator):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        if not cfg.use_rope:
            self.wpe = Embedding(cfg.max_seq_len, cfg.hidden_size, **kw)
        self.h = nn.ModuleList([GPTBlock(cfg, **kw)
                                for _ in range(cfg.num_layers)])
        self.ln_f = _norm(cfg, device, dtype)

    def forward(self, input_ids, kv_caches=None, cache_pos=None,
                attn_start=None):
        b, s = input_ids.shape
        x = self.wte(input_ids.long())
        cfg, rope = self.cfg, None
        if cfg.use_rope:
            rope = forward_phases(x, cfg.hidden_size // cfg.num_heads,
                                  kv_caches, cache_pos, attn_start)
        else:
            if kv_caches is not None:
                pos = decode_position_ids(cache_pos, b, s, attn_start,
                                          device=input_ids.device)
            else:
                pos = torch.arange(s, device=input_ids.device)
            x = x + self.wpe(pos.long())
        if kv_caches is not None:
            new_caches = []
            for block, kc in zip(self.h, kv_caches):
                x, nc = block(x, rope, kv_cache=kc, cache_pos=cache_pos,
                              attn_start=attn_start)
                new_caches.append(nc)
            return self.ln_f(x), new_caches
        for block in self.h:
            x = block(x, rope)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module, GenerationMixin):
    """GPT with the LM head.  ``device=None`` means ``"cuda"`` and raises
    on a host without CUDA (pass ``device="cpu"`` for the plain CPU
    path); parameters are drawn from a `torch.Generator` seeded with
    `seed` on that device."""

    def __init__(self, cfg, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        self.cfg = cfg
        self.gpt = GPTModel(cfg, device=dev, dtype=dtype, generator=gen)
        self.lm_head = None if cfg.tie_embeddings else Linear(
            cfg.hidden_size, cfg.vocab_size, bias=False, device=dev,
            dtype=dtype, generator=gen)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.gpt.wte.weight.dtype

    def forward(self, input_ids, kv_caches=None, cache_pos=None,
                attn_start=None):
        if kv_caches is not None:
            x, new_caches = self.gpt(input_ids, kv_caches=kv_caches,
                                     cache_pos=cache_pos,
                                     attn_start=attn_start)
        else:
            x = self.gpt(input_ids)
        if self.cfg.fused_head_ce and self.training and kv_caches is None:
            # hidden states out; GPTPretrainingCriterion(model=...) owns
            # the projection.  The marker makes a criterion that cannot
            # fuse fail loudly instead of scoring hidden states as logits.
            x.fused_head_hidden = True
            return x
        if self.lm_head is None:
            # tied head
            logits = torch.matmul(x, weight_in_use(self.gpt.wte.weight).t())
        else:
            logits = self.lm_head(x)
        if kv_caches is not None:
            return logits, new_caches
        return logits

    def init_kv_caches(self, batch, max_len):
        cfg = self.cfg
        return init_kv_caches(cfg.num_layers, batch, cfg.num_heads,
                              cfg.hidden_size // cfg.num_heads, max_len,
                              dtype=self.dtype, device=self.device)


NEG_INF = -1e30


def _ce_fwd_chunk(carry, blk, base, safe_labels):
    """One online-logsumexp CE step over a [N, C] f32 logits block
    (JAX :281): the running max / sum and the picked target logit, for
    both the chunked-softmax CE and the fused linear + CE."""
    m, l, picked = carry
    m_new = torch.maximum(m, blk.max(dim=1).values)
    l_new = l * torch.exp(m - m_new) + \
        torch.exp(blk - m_new[:, None]).sum(dim=1)
    width = blk.shape[1]
    in_chunk = (safe_labels >= base) & (safe_labels < base + width)
    idx = (safe_labels - base).clamp(0, width - 1)
    val = blk.gather(1, idx[:, None])[:, 0]
    return m_new, l_new, torch.where(in_chunk, val, picked)


def _ce_bwd_chunk(blk, base, lse, safe_labels, valid):
    """d(loss) / d(logits block) (JAX :297): the softmax recomputed from
    the saved logsumexp minus the one-hot, zero on ignored tokens."""
    p = torch.exp(blk - lse[:, None])
    cols = torch.arange(blk.shape[1], device=blk.device)
    onehot = cols[None, :] == (safe_labels - base)[:, None]
    return (p - onehot.to(p.dtype)) * valid[:, None]


def _ce_lse(block_at, bases, safe_labels):
    """(logsumexp, target logit) per row, online over the blocks
    `block_at(base)` for each vocab offset in `bases`.  The JAX scans pad
    the vocab with -1e30 columns, whose exp is exactly 0; the port's last
    block is narrower instead, with the same values."""
    n, dev = safe_labels.shape[0], safe_labels.device
    carry = (torch.full((n,), NEG_INF, device=dev),
             torch.zeros(n, device=dev), torch.zeros(n, device=dev))
    for base in bases:
        carry = _ce_fwd_chunk(carry, block_at(base), base, safe_labels)
    m, l, picked = carry
    return m + torch.log(l.clamp(min=1e-30)), picked


def _head_logits(h, wc):
    """f32 logits [N, C] of one vocab chunk.  In f32 this is the JAX
    product.  With bf16 operands torch.matmul accumulates in f32 but
    rounds its output to bf16 before the upcast (JAX keeps the f32
    accumulator, `preferred_element_type`, :401-403): each logit carries
    a relative error up to 2^-9, which the logsumexp and the loss then
    inherit, while every later step of the CE stays f32."""
    return torch.matmul(h, wc.t()).float()


class _ChunkedSoftmaxCE(torch.autograd.Function):
    """Summed CE over [N, V] logits, read one vocab chunk at a time in
    f32; the backward recomputes each chunk's softmax and writes
    d(logits) in the logits' dtype (`_chunked_softmax_ce` :306)."""

    @staticmethod
    def forward(ctx, logits, safe_labels, valid, chunk):
        lse, picked = _ce_lse(
            lambda base: logits[:, base:base + chunk].float(),
            range(0, logits.shape[1], chunk), safe_labels)
        ctx.save_for_backward(logits, lse, safe_labels, valid)
        ctx.chunk = chunk
        return torch.where(valid, lse - picked, 0.0).sum()

    @staticmethod
    def backward(ctx, g):
        logits, lse, safe_labels, valid = ctx.saved_tensors
        chunk = ctx.chunk
        dlogits = torch.empty_like(logits)
        for base in range(0, logits.shape[1], chunk):
            blk = logits[:, base:base + chunk].float()
            d = _ce_bwd_chunk(blk, base, lse, safe_labels, valid)
            dlogits[:, base:base + chunk] = (g * d).to(logits.dtype)
        return dlogits, None, None, None


class _FusedLinearCE(torch.autograd.Function):
    """Summed CE of the logits h @ w.T without materialising them
    (`_fused_linear_ce` :375): each vocab chunk's logits are computed,
    folded into the running logsumexp and dropped; the backward
    recomputes them per chunk and accumulates dh (f32) and each chunk's
    dW, so nothing of size N x V is ever stored."""

    @staticmethod
    def forward(ctx, h, w, safe_labels, valid, chunk):
        lse, picked = _ce_lse(
            lambda base: _head_logits(h, w[base:base + chunk]),
            range(0, w.shape[0], chunk), safe_labels)
        ctx.save_for_backward(h, w, lse, safe_labels, valid)
        ctx.chunk = chunk
        return torch.where(valid, lse - picked, 0.0).sum()

    @staticmethod
    def backward(ctx, g):
        h, w, lse, safe_labels, valid = ctx.saved_tensors
        chunk = ctx.chunk
        dh = torch.zeros(h.shape, device=h.device, dtype=torch.float32)
        dw = torch.empty(w.shape, device=w.device, dtype=torch.float32)
        for base in range(0, w.shape[0], chunk):
            wc = w[base:base + chunk]
            d = _ce_bwd_chunk(_head_logits(h, wc), base, lse, safe_labels,
                              valid).to(h.dtype)                   # [N, C]
            dh += torch.matmul(d, wc).float()
            dw[base:base + chunk] = torch.matmul(d.t(), h).float()
        return (g * dh).to(h.dtype), (g * dw).to(w.dtype), None, None, None


def _labels(labels, ignore_index):
    valid = labels != ignore_index
    return torch.where(valid, labels, 0).long(), valid


def _chunked_softmax_ce(logits, labels, ignore_index, n_chunks=8):
    """Cross entropy over [N, V] logits by vocab chunks.  Returns
    (total loss f32, count of non-ignored tokens f32)."""
    safe, valid = _labels(labels, ignore_index)
    chunk = -(-logits.shape[1] // n_chunks)
    total = _ChunkedSoftmaxCE.apply(logits, safe, valid, chunk)
    return total, valid.float().sum()


def _fused_linear_ce(h, w, labels, ignore_index, n_chunks=16):
    """Cross entropy fused with the LM head: h [N, Hd], w [V, Hd] (the
    tied embedding), labels [N].  Returns (total loss f32, count of
    non-ignored tokens f32)."""
    safe, valid = _labels(labels, ignore_index)
    chunk = -(-w.shape[0] // n_chunks)
    total = _FusedLinearCE.apply(h, w, safe, valid, chunk)
    return total, valid.float().sum()


class GPTPretrainingCriterion(nn.Module):
    """Token-level LM loss, the mean over tokens whose label is not
    `ignore_index` (JAX :461).

    ``fused=True`` with ``model=`` (a model built with
    ``cfg.fused_head_ce=True``, which returns hidden states in training)
    fuses the tied LM head into the chunked CE, reading the embedding
    weight through the live model, so a train step that swaps the
    model's parameters differentiates it like any other.  ``fused=True``
    on logits of a vocab >= 8192 takes the chunked-softmax CE;
    otherwise the plain `cross_entropy`."""

    def __init__(self, ignore_index=-100, fused=True, model=None):
        super().__init__()
        self.ignore_index = ignore_index
        self.fused = fused
        if model is not None and not model.cfg.tie_embeddings:
            raise ValueError("fused head+CE currently requires tied "
                             "embeddings")
        # a plain reference, not a submodule: the criterion owns no
        # parameters of its own
        object.__setattr__(self, "_model", model)

    def forward(self, logits, labels):
        labels = torch.as_tensor(labels, device=logits.device)
        is_hidden = getattr(logits, "fused_head_hidden", False)
        if is_hidden and (self._model is None or not self.fused):
            # either mismatch silently scores hidden states as logits
            raise RuntimeError(
                "model was built with cfg.fused_head_ce=True (returns "
                "hidden states in training) but the criterion cannot fuse "
                "— construct GPTPretrainingCriterion(model=model) with "
                "fused=True (got model="
                f"{'set' if self._model is not None else 'None'}, "
                f"fused={self.fused})")
        n = logits.shape[:-1].numel()
        if is_hidden:
            total, count = _fused_linear_ce(
                logits.reshape(n, logits.shape[-1]),
                self._model.gpt.wte.weight, labels.reshape(n),
                self.ignore_index)
            return total / count.clamp(min=1.0)
        if self.fused and logits.shape[-1] >= 8192:
            total, count = _chunked_softmax_ce(
                logits.reshape(n, logits.shape[-1]), labels.reshape(n),
                self.ignore_index)
            return total / count.clamp(min=1.0)
        return F.cross_entropy(logits, labels, ignore_index=self.ignore_index)


def load_reference_state(model, params, buffers=None) -> None:
    """Copy the JAX model's ``functional_state()`` params (name -> array,
    numpy or anything `np.asarray` takes) into `model`, onto its device
    and dtype; with `buffers` (the second dict of ``functional_state()``)
    the model's persistent buffers too, such as batch norm's `_mean` and
    `_variance`.  Every name and shape must match: a missing or extra
    name raises, as does a shape mismatch."""
    own = dict(model.named_parameters())
    targets = [(own, params)]
    if buffers is not None:
        state = model.state_dict(keep_vars=True)
        targets.append(({n: b for n, b in model.named_buffers()
                         if n in state}, buffers))
    for dst, src_dict in targets:
        missing = sorted(set(dst) - set(src_dict))
        extra = sorted(set(src_dict) - set(dst))
        if missing or extra:
            raise KeyError(f"load_reference_state: missing {missing}, "
                           f"unexpected {extra}")
    with torch.no_grad():
        for dst, src_dict in targets:
            for name, p in dst.items():
                src = np.asarray(src_dict[name])
                if tuple(src.shape) != tuple(p.shape):
                    raise ValueError(
                        f"load_reference_state: {name} has shape "
                        f"{tuple(src.shape)}, model expects "
                        f"{tuple(p.shape)}")
                p.copy_(torch.from_numpy(np.array(src)).to(
                    device=p.device, dtype=p.dtype))


def gpt_tiny(**kw):
    kw.setdefault("vocab_size", 1024)
    kw.setdefault("hidden_size", 128)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("max_seq_len", 128)
    return GPTConfig(**kw)


def gpt_1p3b(**kw):
    return GPTConfig(vocab_size=50304, hidden_size=2048, num_layers=24,
                     num_heads=16, max_seq_len=2048, **kw)


def llama_7b(**kw):
    """The legacy GPT-class LLaMA-7B preset (JAX :594); the LLaMA family
    proper is `models.llama`."""
    kw.setdefault("use_rope", True)
    kw.setdefault("use_rmsnorm", True)
    kw.setdefault("use_swiglu", True)
    kw.setdefault("tie_embeddings", False)
    return GPTConfig(vocab_size=32000, hidden_size=4096, num_layers=32,
                     num_heads=32, max_seq_len=2048, **kw)
