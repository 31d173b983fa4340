"""Swin Transformer (``paddle_tpu/vision/models/swin.py`` counterpart).

Each block's attention is one call of the `window_attention` kernel on
the post-projection qkv image: cyclic shift, window partition, per-head
attention with the dense relative-position bias and the shift mask,
softmax and window reverse in one launch (12 per Swin-T forward).  The
dense bias is one matmul of the trainable table against the one-hot
constant of `_bias_onehot`, as in the JAX package; the shift
mask is built in numpy exactly as there (-100.0 across regions, no
shift when the window covers the feature map).  Both constants are
non-persistent buffers: ``functional_state()`` has no buffers for Swin.
Names and shapes equal the JAX model's.  In training (``model.train()``)
the window attention differentiates through the backward kernel on
the card (`WindowAttentionCore`, 12 launches per Swin-T step), and
through the plain version on the CPU; under the train
step's O2 cast the dense bias is still formed in f32 from the bf16
table, and the mask stays an f32 constant with no gradient.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ... import nn
from ...core.device import resolve_device
from ...nn import functional as F
from ...nn.layer_base import Layer
from ...ops.kernels.window_attention import window_attention

__all__ = ["SwinTransformer", "swin_t", "swin_s", "swin_b"]


@functools.lru_cache(maxsize=None)
def _bias_onehot(window_size):
    """The one-hot [ws^4, (2w-1)^2] f32 that densifies the rel-pos table
    (the JAX `_rel_bias_constants` :58-79, its second value)."""
    coords = np.stack(np.meshgrid(np.arange(window_size),
                                  np.arange(window_size), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + window_size - 1
    rel_index = rel[..., 0] * (2 * window_size - 1) + rel[..., 1]
    n_tok = window_size * window_size
    n_tab = (2 * window_size - 1) ** 2
    onehot = np.zeros((n_tok * n_tok, n_tab), np.float32)
    onehot[np.arange(n_tok * n_tok), rel_index.reshape(-1)] = 1.0
    return onehot


def _shift_mask(resolution, ws, shift):
    """The additive [nW, ws², ws²] f32 shift mask (JAX :164-179)."""
    h, w = resolution
    img_mask = np.zeros((1, h, w, 1))
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws_ in slices:
            img_mask[:, hs, ws_, :] = cnt
            cnt += 1
    m = img_mask.reshape(1, h // ws, ws, w // ws, ws, 1)
    m = m.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(Layer):
    """`forward(x_img, mask, shift)`: the normed features [B, H, W, C] ->
    qkv projection -> the window kernel -> output projection."""

    def __init__(self, dim, window_size, num_heads, attn_drop=0.0,
                 proj_drop=0.0, *, kw):
        super().__init__()
        self.ws = window_size
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, **kw)
        self.proj = nn.Linear(dim, dim, **kw)
        n_tab = (2 * window_size - 1) ** 2
        bound = 1.0 / math.sqrt(n_tab)
        tab = torch.empty(n_tab, num_heads, device=kw["device"],
                          dtype=kw["dtype"])
        tab.uniform_(-bound, bound, generator=kw["generator"])
        self.rel_bias = torch.nn.Parameter(tab)
        self.register_buffer("_bias_onehot", torch.from_numpy(
            _bias_onehot(window_size)).to(kw["device"]), persistable=False)

    def dense_bias(self):
        """Dense f32 [heads, ws², ws²] bias: table [T, h] against the
        one-hot [P, T], contracted over T."""
        n_tok = self.ws * self.ws
        dense = torch.einsum("th,pt->hp", self.rel_bias.float(),
                             self._bias_onehot)
        return dense.reshape(self.num_heads, n_tok, n_tok)

    def forward(self, x_img, mask=None, shift=0):
        out = window_attention(self.qkv(x_img), self.dense_bias(), mask,
                               self.ws, int(shift), self.num_heads)
        if self.attn_drop and self.training:
            # on the attention output, as the JAX model applies it (:136)
            out = F.dropout(out, self.attn_drop, training=True)
        out = self.proj(out)
        if self.proj_drop and self.training:
            out = F.dropout(out, self.proj_drop, training=True)
        return out


class SwinBlock(Layer):
    def __init__(self, dim, input_resolution, num_heads, window_size=7,
                 shift_size=0, mlp_ratio=4.0, drop=0.0, *, kw):
        super().__init__()
        nkw = dict(device=kw["device"], dtype=kw["dtype"])
        self.resolution = input_resolution
        self.ws = min(window_size, *input_resolution)
        # a window covering the whole feature map needs no shift
        self.shift = 0 if min(input_resolution) <= self.ws else shift_size
        self.norm1 = nn.LayerNorm(dim, **nkw)
        self.attn = WindowAttention(dim, self.ws, num_heads, attn_drop=drop,
                                    proj_drop=drop, kw=kw)
        self.norm2 = nn.LayerNorm(dim, **nkw)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(nn.Linear(dim, hidden, **kw), nn.GELU(),
                                 nn.Dropout(drop),
                                 nn.Linear(hidden, dim, **kw),
                                 nn.Dropout(drop))
        mask = None if self.shift == 0 else torch.from_numpy(
            _shift_mask(input_resolution, self.ws, self.shift)).to(
                kw["device"])
        self.register_buffer("_attn_mask", mask, persistable=False)

    def forward(self, x):
        h, w = self.resolution
        b, n, c = x.shape
        shortcut = x
        x = self.norm1(x).reshape(b, h, w, c)
        x = self.attn(x, self._attn_mask, shift=self.shift)
        x = shortcut + x.reshape(b, n, c)
        return x + self.mlp(self.norm2(x))


class PatchMerging(Layer):
    def __init__(self, input_resolution, dim, *, kw):
        super().__init__()
        self.resolution = input_resolution
        self.norm = nn.LayerNorm(4 * dim, device=kw["device"],
                                 dtype=kw["dtype"])
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias_attr=False, **kw)

    def forward(self, x):
        h, w = self.resolution
        b, _, c = x.shape
        x = x.reshape(b, h, w, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        x = x.reshape(b, (h // 2) * (w // 2), 4 * c)
        return self.reduction(self.norm(x))


class SwinTransformer(Layer):
    """Built in eval mode on `device` (``None`` = CUDA), parameters drawn
    from a generator seeded with `seed`; ``.train()`` trains it, with
    `drop_rate` dropout on each block's attention output, projection and
    MLP as in the JAX model."""

    def __init__(self, img_size=224, patch_size=4, in_ch=3, num_classes=1000,
                 embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
                 window_size=7, mlp_ratio=4.0, drop_rate=0.0, *, device=None,
                 dtype=torch.float32, seed=0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        kw = dict(device=dev, dtype=dtype, generator=gen)
        self.patch_embed = nn.Conv2D(in_ch, embed_dim, patch_size,
                                     stride=patch_size, **kw)
        res = img_size // patch_size
        self.num_layers = len(depths)
        layers = []
        dim = embed_dim
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            for d in range(depth):
                layers.append(SwinBlock(
                    dim, (res, res), heads, window_size,
                    shift_size=0 if d % 2 == 0 else window_size // 2,
                    mlp_ratio=mlp_ratio, drop=drop_rate, kw=kw))
            if i != self.num_layers - 1:
                layers.append(PatchMerging((res, res), dim, kw=kw))
                dim *= 2
                res //= 2
        self.blocks = nn.LayerList(layers)
        self.norm = nn.LayerNorm(dim, device=dev, dtype=dtype)
        self.head = nn.Linear(dim, num_classes, **kw)
        self.eval()

    def forward(self, x):
        x = self.patch_embed(x)                  # [B, E, H', W']
        b, e = x.shape[0], x.shape[1]
        x = x.reshape(b, e, -1).transpose(1, 2)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        return self.head(x.mean(dim=1))


def swin_t(**kw):
    return SwinTransformer(embed_dim=96, depths=(2, 2, 6, 2),
                           num_heads=(3, 6, 12, 24), **kw)


def swin_s(**kw):
    return SwinTransformer(embed_dim=96, depths=(2, 2, 18, 2),
                           num_heads=(3, 6, 12, 24), **kw)


def swin_b(**kw):
    return SwinTransformer(embed_dim=128, depths=(2, 2, 18, 2),
                           num_heads=(4, 8, 16, 32), **kw)
