"""LLaMA family (``paddle_tpu/models/llama.py`` counterpart): a decoder
with grouped-query attention, rotary embeddings, RMSNorm, SwiGLU and an
untied LM head, for serving and training.

Parameter names and shapes equal the JAX package's ``functional_state()``
(``model.layers.0.attn.qkv_proj.weight`` is ``[in, out]``, the untied
``lm_head.weight`` is ``[hidden, vocab]``), so `load_reference_state`
carries weights across one to one.  K and V keep ``num_kv_heads`` heads
everywhere: the flash, decode and paged kernels group the query heads
per kv head, and the KV caches are sized by ``num_kv_heads``.

``dropout`` is the attention's rate, as in the JAX model (:132), which
applies it to nothing on either package (ROADMAP C2.6).
``recompute`` replays each block in the backward in training
(`distributed.recompute`, under ``recompute_policy``), rope and flash
kernels included.  The pipeline stages (`llama_pipe_layers`) are not
ported yet (ROADMAP Queue A), nor are the sequence / context parallel
flags: setting one raises NotImplementedError.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.device import resolve_device
from ..distributed.recompute import _resolve_policy
from ..distributed.recompute import recompute as _recompute
from ..nn import Embedding, Linear, RMSNorm, weight_in_use
from ..nn import functional as F
from ..nn.layer_base import Layer
from .generation import (
    GenerationMixin, _static_cache_attention, forward_phases, init_kv_caches,
)
from .gpt import refuse_unported

__all__ = ["LlamaConfig", "LlamaModel", "LlamaForCausalLM",
           "LlamaPretrainingCriterion", "llama_tiny", "llama_7b",
           "llama_13b", "llama2_70b_shapes"]


class LlamaConfig:
    def __init__(self, vocab_size=32000, hidden_size=4096, num_layers=32,
                 num_heads=32, num_kv_heads=None, max_seq_len=2048,
                 ffn_hidden=11008, rope_theta=10000.0, rms_eps=1e-6,
                 dropout=0.0, tie_embeddings=False, recompute=False,
                 recompute_policy=None, sequence_parallel=False,
                 context_parallel=False):
        refuse_unported("LlamaConfig", sequence_parallel=sequence_parallel,
                        context_parallel=context_parallel)
        _resolve_policy(recompute_policy)
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.max_seq_len = max_seq_len
        self.ffn_hidden = ffn_hidden
        self.rope_theta = rope_theta
        self.rms_eps = rms_eps
        self.dropout = dropout
        self.tie_embeddings = tie_embeddings
        self.recompute = recompute
        # named policy: None / "full" | "dots" | "dots_no_batch"
        self.recompute_policy = recompute_policy


class LlamaAttention(Layer):
    def __init__(self, cfg, **kw):
        super().__init__()
        self.cfg = cfg
        self.num_heads = cfg.num_heads
        self.num_kv_heads = cfg.num_kv_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        q_size = cfg.num_heads * self.head_dim
        kv_size = cfg.num_kv_heads * self.head_dim
        # fused bias-free qkv, split [q | k | v] along the last axis
        self.qkv_proj = Linear(cfg.hidden_size, q_size + 2 * kv_size,
                               bias_attr=False, **kw)
        self.out_proj = Linear(q_size, cfg.hidden_size, bias_attr=False, **kw)

    def forward(self, x, rope, kv_cache=None, cache_pos=None,
                attn_start=None):
        """`rope`: the forward's (cos, sin) (`LlamaModel.forward`)."""
        b, s, _ = x.shape
        hd = self.head_dim
        q_size = self.num_heads * hd
        kv_size = self.num_kv_heads * hd
        # views of the projection (token stride q_size + 2 * kv_size):
        # the rope kernel reads q and k through their strides
        q, k, v = self.qkv_proj(x).split([q_size, kv_size, kv_size], dim=-1)
        q = q.reshape(b, s, self.num_heads, hd)
        k = k.reshape(b, s, self.num_kv_heads, hd)
        v = v.reshape(b, s, self.num_kv_heads, hd)
        q, k = F.rotate_qk(q, k, rope)
        if kv_cache is not None:
            out, new_cache = _static_cache_attention(q, k, v, kv_cache,
                                                     cache_pos, attn_start)
            return self.out_proj(out.reshape(b, s, q_size)), new_cache
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True,
            dropout_p=self.cfg.dropout if self.training else 0.0,
            training=self.training)
        return self.out_proj(out.reshape(b, s, q_size))


class LlamaMLP(Layer):
    def __init__(self, cfg, **kw):
        super().__init__()
        self.gate_up_proj = Linear(cfg.hidden_size, 2 * cfg.ffn_hidden,
                                   bias_attr=False, **kw)
        self.down_proj = Linear(cfg.ffn_hidden, cfg.hidden_size, bias_attr=False,
                                **kw)

    def forward(self, x):
        return self.down_proj(F.swiglu(self.gate_up_proj(x)))


class LlamaBlock(Layer):
    def __init__(self, cfg, *, device, dtype, generator):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.input_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps,
                                  device=device, dtype=dtype)
        self.attn = LlamaAttention(cfg, **kw)
        self.post_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps,
                                 device=device, dtype=dtype)
        self.mlp = LlamaMLP(cfg, **kw)
        self.cfg = cfg

    def _body(self, x, rope):
        x = x + self.attn(self.input_norm(x), rope)
        return x + self.mlp(self.post_norm(x))

    def forward(self, x, rope, kv_cache=None, cache_pos=None,
                attn_start=None):
        if kv_cache is not None:
            a, new_cache = self.attn(self.input_norm(x), rope,
                                     kv_cache=kv_cache, cache_pos=cache_pos,
                                     attn_start=attn_start)
            x = x + a
            return x + self.mlp(self.post_norm(x)), new_cache
        if self.cfg.recompute and self.training:
            return _recompute(self._body, x, rope,
                              policy=self.cfg.recompute_policy)
        return self._body(x, rope)


class LlamaModel(Layer):
    def __init__(self, cfg, *, device, dtype, generator):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.layers = nn.ModuleList([LlamaBlock(cfg, **kw)
                                     for _ in range(cfg.num_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_eps, device=device,
                            dtype=dtype)

    def forward(self, input_ids, kv_caches=None, cache_pos=None,
                attn_start=None):
        x = self.embed_tokens(input_ids.long())
        cfg = self.cfg
        rope = forward_phases(x, cfg.hidden_size // cfg.num_heads, kv_caches,
                              cache_pos, attn_start, cfg.rope_theta)
        if kv_caches is not None:
            new_caches = []
            for blk, kc in zip(self.layers, kv_caches):
                x, nc = blk(x, rope, kv_cache=kc, cache_pos=cache_pos,
                            attn_start=attn_start)
                new_caches.append(nc)
            return self.norm(x), new_caches
        for blk in self.layers:
            x = blk(x, rope)
        return self.norm(x)


class LlamaForCausalLM(Layer, GenerationMixin):
    """LLaMA with its LM head (tied, or an untied ``lm_head`` ``[hidden,
    vocab]``).  ``device=None`` means ``"cuda"`` and raises on a host
    without CUDA (pass ``device="cpu"`` for the plain CPU path);
    parameters are drawn from a `torch.Generator` seeded with `seed` on
    that device."""

    def __init__(self, cfg, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        self.cfg = cfg
        self.model = LlamaModel(cfg, device=dev, dtype=dtype, generator=gen)
        self.lm_head = None if cfg.tie_embeddings else Linear(
            cfg.hidden_size, cfg.vocab_size, bias_attr=False, device=dev,
            dtype=dtype, generator=gen)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.model.embed_tokens.weight.dtype

    def forward(self, input_ids, kv_caches=None, cache_pos=None,
                attn_start=None):
        if kv_caches is not None:
            h, new_caches = self.model(input_ids, kv_caches=kv_caches,
                                       cache_pos=cache_pos,
                                       attn_start=attn_start)
        else:
            h = self.model(input_ids)
        if self.lm_head is None:
            logits = torch.matmul(
                h, weight_in_use(self.model.embed_tokens.weight).t())
        else:
            logits = self.lm_head(h)
        if kv_caches is not None:
            return logits, new_caches
        return logits

    def init_kv_caches(self, batch, max_len):
        cfg = self.cfg
        # kv heads only: the caches stay grouped (GQA)
        return init_kv_caches(cfg.num_layers, batch, cfg.num_kv_heads,
                              cfg.hidden_size // cfg.num_heads, max_len,
                              dtype=self.dtype, device=self.device)


class LlamaPretrainingCriterion(Layer):
    """Mean token cross entropy over [B, S, V] logits, tokens labelled
    `ignore_index` left out (JAX :248)."""

    def __init__(self, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, logits, labels):
        labels = torch.as_tensor(labels, device=logits.device)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1),
                               ignore_index=self.ignore_index)


def llama_tiny(**kw):
    d = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=128, ffn_hidden=256)
    d.update(kw)
    return LlamaConfig(**d)


def llama_7b(**kw):
    d = dict(vocab_size=32000, hidden_size=4096, num_layers=32,
             num_heads=32, max_seq_len=2048, ffn_hidden=11008)
    d.update(kw)
    return LlamaConfig(**d)


def llama_13b(**kw):
    d = dict(vocab_size=32000, hidden_size=5120, num_layers=40,
             num_heads=40, max_seq_len=2048, ffn_hidden=13824)
    d.update(kw)
    return LlamaConfig(**d)


def llama2_70b_shapes(**kw):
    d = dict(vocab_size=32000, hidden_size=8192, num_layers=80,
             num_heads=64, num_kv_heads=8, max_seq_len=4096,
             ffn_hidden=28672)
    d.update(kw)
    return LlamaConfig(**d)
