"""GPT family, inference path (``paddle_tpu/models/gpt.py`` counterpart).

Parameter names and shapes equal the JAX package's
``functional_state()`` names (``gpt.h.0.attn.qkv_proj.weight`` is
``[in, out]``), so `load_reference_state` carries weights across
one to one.  The JAX model's ``mpu.*ParallelLinear`` layers are plain
`Linear` here under the same attribute names.  The LLaMA variant
(rope / RMSNorm / SwiGLU), an untied LM head and training (dropout,
recompute, the fused head + CE) come with later slices; their
`GPTConfig` fields arrive with them, so passing one raises `TypeError`.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from ..nn import Embedding, LayerNorm, Linear
from ..nn import functional as F
from .generation import (
    GenerationMixin, _static_cache_attention, decode_position_ids,
    init_kv_caches,
)

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_tiny",
           "gpt_1p3b", "load_reference_state"]


class GPTConfig:
    """The fields of the JAX package's GPTConfig that the ported model
    reads: the GPT-2 family with tied embeddings, at inference."""

    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, max_seq_len=1024, ffn_hidden=None,
                 layer_norm_eps=1e-5):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_seq_len = max_seq_len
        self.ffn_hidden = ffn_hidden or 4 * hidden_size
        self.layer_norm_eps = layer_norm_eps


class GPTAttention(nn.Module):
    def __init__(self, cfg, **kw):
        super().__init__()
        self.cfg = cfg
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.qkv_proj = Linear(cfg.hidden_size, 3 * cfg.hidden_size, **kw)
        self.out_proj = Linear(cfg.hidden_size, cfg.hidden_size, **kw)

    def forward(self, x, kv_cache=None, cache_pos=None, attn_start=None):
        b, s, h = x.shape
        qkv = self.qkv_proj(x).reshape(b, s, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv.unbind(dim=2)
        if kv_cache is not None:
            out, new_cache = _static_cache_attention(
                q, k, v, kv_cache, cache_pos, attn_start)
            return self.out_proj(out.reshape(b, s, h)), new_cache
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.out_proj(out.reshape(b, s, h))


class GPTMLP(nn.Module):
    def __init__(self, cfg, **kw):
        super().__init__()
        self.up_proj = Linear(cfg.hidden_size, cfg.ffn_hidden, **kw)
        self.down_proj = Linear(cfg.ffn_hidden, cfg.hidden_size, **kw)

    def forward(self, x):
        return self.down_proj(F.gelu(self.up_proj(x), approximate=True))


class GPTBlock(nn.Module):
    def __init__(self, cfg, *, device, dtype, generator):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.ln_1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                              device=device, dtype=dtype)
        self.attn = GPTAttention(cfg, **kw)
        self.ln_2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                              device=device, dtype=dtype)
        self.mlp = GPTMLP(cfg, **kw)

    def forward(self, x, kv_cache=None, cache_pos=None, attn_start=None):
        if kv_cache is not None:
            a, new_cache = self.attn(self.ln_1(x), kv_cache=kv_cache,
                                     cache_pos=cache_pos,
                                     attn_start=attn_start)
            x = x + a
            x = x + self.mlp(self.ln_2(x))
            return x, new_cache
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class GPTModel(nn.Module):
    def __init__(self, cfg, *, device, dtype, generator):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.wpe = Embedding(cfg.max_seq_len, cfg.hidden_size, **kw)
        self.h = nn.ModuleList([GPTBlock(cfg, **kw)
                                for _ in range(cfg.num_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                              device=device, dtype=dtype)

    def forward(self, input_ids, kv_caches=None, cache_pos=None,
                attn_start=None):
        b, s = input_ids.shape
        x = self.wte(input_ids.long())
        if kv_caches is not None:
            pos = decode_position_ids(cache_pos, b, s, attn_start,
                                      device=input_ids.device)
        else:
            pos = torch.arange(s, device=input_ids.device)
        x = x + self.wpe(pos.long())
        if kv_caches is not None:
            new_caches = []
            for block, kc in zip(self.h, kv_caches):
                x, nc = block(x, kv_cache=kc, cache_pos=cache_pos,
                              attn_start=attn_start)
                new_caches.append(nc)
            return self.ln_f(x), new_caches
        for block in self.h:
            x = block(x)
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
        logits = torch.matmul(x, self.gpt.wte.weight.t())   # tied head
        if kv_caches is not None:
            return logits, new_caches
        return logits

    def init_kv_caches(self, batch, max_len):
        cfg = self.cfg
        return init_kv_caches(cfg.num_layers, batch, cfg.num_heads,
                              cfg.hidden_size // cfg.num_heads, max_len,
                              dtype=self.dtype, device=self.device)


def load_reference_state(model, params) -> None:
    """Copy the JAX model's ``functional_state()`` params (name -> array,
    numpy or anything `np.asarray` takes) into `model`, onto its device
    and dtype.  Every name and shape must match: a missing or extra name
    raises, as does a shape mismatch."""
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise KeyError(f"load_reference_state: missing {missing}, "
                       f"unexpected {extra}")
    with torch.no_grad():
        for name, p in own.items():
            src = np.asarray(params[name])
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"load_reference_state: {name} has shape "
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
