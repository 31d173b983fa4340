"""Vision Transformer (``paddle_tpu/vision/models/vit.py`` counterpart:
`PatchEmbed` :20, `MHSA` :36, `Block` :61, `VisionTransformer` :78 and
the presets :110-133).

The patch embedding is a plain strided `conv2d`, as the JAX package
computes it outside Pallas.  Attention goes through the port's
`scaled_dot_product_attention` on ``[B, N, H, hd]`` with no mask: on the
card the flash kernels forward and backward, at N = (img / patch)² + 1
tokens (197 for ViT-B/16 at 224²; a length that is not a multiple of 8
takes the native tier).  Dropout (`drop_rate`) acts in training mode on
the embedded tokens, the projection and the MLP; `attn_drop_rate` is the
attention's own rate, applied to nothing (ROADMAP C2.6).  `cls_token`
and `pos_embed` take the JAX package's default initialiser, uniform in
±1 / sqrt(fan_in) with fan_in the product of all axes but the first.
Names and shapes equal the JAX model's ``functional_state()``; models
are built in eval mode on `device` (``None`` = CUDA), with parameters
drawn from a generator seeded with `seed`.
"""
from __future__ import annotations

import math

import torch

from ... import nn
from ...core.device import resolve_device
from ...nn import functional as F
from ...nn.layer_base import Layer

__all__ = ["VisionTransformer", "vit_b_16", "vit_b_32", "vit_l_16",
           "vit_l_32", "vit_h_14"]


class PatchEmbed(Layer):
    def __init__(self, img_size=224, patch_size=16, in_ch=3, embed_dim=768,
                 *, kw):
        super().__init__()
        self.num_patches = (img_size // patch_size) ** 2
        self.proj = nn.Conv2D(in_ch, embed_dim, patch_size,
                              stride=patch_size, **kw)

    def forward(self, x):
        x = self.proj(x)                       # [B, E, H/P, W/P]
        b, e = x.shape[0], x.shape[1]
        return x.reshape(b, e, -1).transpose(1, 2)   # [B, N, E]


class MHSA(Layer):
    def __init__(self, dim, num_heads, attn_drop=0.0, proj_drop=0.0, *,
                 kw):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim, **kw)
        self.proj = nn.Linear(dim, dim, **kw)
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop

    def forward(self, x):
        b, n, d = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(dim=2)            # [B, N, H, hd]
        out = F.scaled_dot_product_attention(
            q, k, v, dropout_p=self.attn_drop if self.training else 0.0,
            training=self.training)
        out = self.proj(out.reshape(b, n, d))
        if self.proj_drop:
            out = F.dropout(out, self.proj_drop, training=self.training)
        return out


class Block(Layer):
    def __init__(self, dim, num_heads, mlp_ratio=4.0, drop=0.0,
                 attn_drop=0.0, eps=1e-6, *, kw):
        super().__init__()
        nkw = dict(device=kw["device"], dtype=kw["dtype"])
        self.norm1 = nn.LayerNorm(dim, epsilon=eps, **nkw)
        self.attn = MHSA(dim, num_heads, attn_drop, drop, kw=kw)
        self.norm2 = nn.LayerNorm(dim, epsilon=eps, **nkw)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(
            nn.Linear(dim, hidden, **kw), nn.GELU(), nn.Dropout(drop),
            nn.Linear(hidden, dim, **kw), nn.Dropout(drop))

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


def _default_param(shape, kw):
    """The JAX `create_parameter` default: U(±1 / sqrt(fan_in))."""
    fan_in = math.prod(shape[1:])
    bound = 1.0 / math.sqrt(fan_in)
    t = torch.empty(*shape, device=kw["device"], dtype=kw["dtype"])
    t.uniform_(-bound, bound, generator=kw["generator"])
    return torch.nn.Parameter(t)


class VisionTransformer(Layer):
    def __init__(self, img_size=224, patch_size=16, in_ch=3,
                 num_classes=1000, embed_dim=768, depth=12, num_heads=12,
                 mlp_ratio=4.0, drop_rate=0.0, attn_drop_rate=0.0, eps=1e-6,
                 *, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        kw = dict(device=dev, dtype=dtype, generator=gen)
        self.patch_embed = PatchEmbed(img_size, patch_size, in_ch,
                                      embed_dim, kw=kw)
        n = self.patch_embed.num_patches
        self.cls_token = _default_param([1, 1, embed_dim], kw)
        self.pos_embed = _default_param([1, n + 1, embed_dim], kw)
        self.pos_drop = nn.Dropout(drop_rate)
        self.blocks = nn.LayerList([
            Block(embed_dim, num_heads, mlp_ratio, drop_rate,
                  attn_drop_rate, eps, kw=kw) for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, epsilon=eps, device=dev,
                                 dtype=dtype)
        self.head = nn.Linear(embed_dim, num_classes, **kw) \
            if num_classes > 0 else None
        self.eval()

    def forward(self, x):
        x = self.patch_embed(x)
        b = x.shape[0]
        cls = self.cls_token.expand(b, 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1)
        x = self.pos_drop(x + self.pos_embed)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        cls_out = x[:, 0]
        return self.head(cls_out) if self.head is not None else cls_out


def _vit(patch, dim, depth, heads, **kw):
    d = dict(patch_size=patch, embed_dim=dim, depth=depth, num_heads=heads)
    d.update(kw)
    return VisionTransformer(**d)


def vit_b_16(**kw):
    return _vit(16, 768, 12, 12, **kw)


def vit_b_32(**kw):
    return _vit(32, 768, 12, 12, **kw)


def vit_l_16(**kw):
    return _vit(16, 1024, 24, 16, **kw)


def vit_l_32(**kw):
    return _vit(32, 1024, 24, 16, **kw)


def vit_h_14(**kw):
    return _vit(14, 1280, 32, 16, **kw)
