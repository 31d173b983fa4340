"""Common functionals (``paddle_tpu/nn/functional/common.py``
counterpart): linear, bilinear, embedding, the dropouts, padding
(``paddle_tpu/ops/manipulation.py:542``), unfold / fold, similarity and
distance, label smoothing, one_hot, sequence_mask, normalize,
class_center_sample, temporal_shift (``paddle_tpu/ops/extra.py:416``),
gather_tree and sparse_attention, as the JAX functions compute them.

Dropout (:47-95) is plain PyTorch on every device, as in the JAX package, which computes
dropout outside any Pallas kernel.  The keep mask is uniform < 1 - p
drawn from the generator of the tensor's device (`core.rng`), in the
mask's shape: x's, or 1 on every axis but those of `axis`.  The kept
values keep JAX's rounding, ``where(keep, x / (1 - p), 0)`` in x's dtype
(:64), with 1 - p rounded to x's dtype first as JAX rounds its
weak-typed scalar.  Autograd saves the mask, so the backward scales the
gradient by the forward's mask.
"""
from __future__ import annotations

import numpy as np
import torch

from ...amp import gate as _amp
from ...core import rng
from ...core.dtypes import torch_dtype

__all__ = [
    "linear", "embedding", "bilinear", "dropout", "dropout2d", "dropout3d",
    "alpha_dropout", "pad", "unfold", "fold", "cosine_similarity",
    "label_smooth", "one_hot", "sequence_mask", "normalize",
    "class_center_sample", "pairwise_distance", "zeropad2d",
    "temporal_shift", "gather_tree", "sparse_attention",
]

_ALPHA = 1.6732632423543772
_SCALE = 1.0507009873554805


def _keep(x, p, shape):
    u = torch.rand(shape, generator=rng.generator(x.device),
                   device=x.device)
    return u < 1.0 - p


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zero each element (or each slice along `axis`) with probability
    `p`.  ``upscale_in_train`` scales the kept values by 1 / (1 - p) in
    training and is the identity in inference; ``downscale_in_infer``
    keeps them as they are in training and scales by 1 - p in
    inference."""
    if not training or p == 0.0:
        if training or mode != "downscale_in_infer" or p == 0.0:
            return x
        return x * (1.0 - p)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = _keep(x, p, shape)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "upscale_in_train":
        # JAX divides by 1 - p rounded to x's dtype (a weak-typed scalar)
        keep_rate = torch.tensor(1.0 - p, dtype=x.dtype).item()
        return torch.where(keep, x / keep_rate, zero)
    return torch.where(keep, x, zero)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Whole channels of [N, C, H, W] (or NHWC) dropped."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    """Whole channels of [N, C, D, H, W] (or NDHWC) dropped."""
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=axis, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-preserving dropout: dropped elements take the SELU's negative
    saturation, then an affine map keeps the mean and variance."""
    if not training or p == 0.0:
        return x
    keep = _keep(x, p, x.shape)
    alpha_p = -_ALPHA * _SCALE
    a = 1.0 / (_SCALE * ((1 - p) * (1 + p * alpha_p ** 2)) ** 0.5)
    b = -a * alpha_p * p
    out = a * torch.where(keep, x, torch.full((), alpha_p, dtype=x.dtype,
                                              device=x.device)) + b
    return out.to(x.dtype)


def linear(x, weight, bias=None, name=None):
    """x @ weight (+ bias), weight [in, out] (Paddle's layout); in the AMP
    dtype under `amp.auto_cast`."""
    x, weight, bias = _amp.cast("linear", x, weight, bias)
    y = torch.matmul(x, weight)
    return _amp.seen("linear", y if bias is None else y + bias)


def _zero_rows(out, ids, padding_idx):
    """Rows of a lookup whose id is `padding_idx` set to zero (their
    weight row gets no gradient, as JAX's `where` gives it none)."""
    if padding_idx is None:
        return out
    mask = (ids == padding_idx).unsqueeze(-1)
    return torch.where(mask, torch.zeros((), dtype=out.dtype,
                                         device=out.device), out)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of `weight` [num, dim] at the ids `x`; rows of id
    `padding_idx` read as zero.  `sparse` is accepted: the gradient is a
    dense tensor (torch's `index_put`), as JAX's is."""
    return _zero_rows(weight[x], x, padding_idx)


def bilinear(x1, x2, weight, bias=None, name=None):
    """out[b, o] = x1[b] @ weight[o] @ x2[b] (+ bias), weight [out, in1,
    in2]."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


_PAD_MODES = ("constant", "reflect", "replicate", "circular")


def _pad_cfg(pad, nd, data_format):
    """Per-axis (before, after) of Paddle's `pad` list (JAX ops
    manipulation.py:543-566): 2 * ndim values in axis order, or the
    spatial pads of a 3-D / 4-D / 5-D input, last spatial axis first
    ([left, right, top, bottom, front, back]), channel-first only for
    exactly "NCL" / "NCHW" / "NCDHW"; otherwise the trailing axes."""
    pad = [int(p) for p in pad]
    if len(pad) == 2 * nd:
        return [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    first = {3: "NCL", 4: "NCHW", 5: "NCDHW"}.get(nd)
    if first is not None and len(pad) == 2 * (nd - 2):
        pairs = [(pad[2 * i], pad[2 * i + 1])
                 for i in range(nd - 2)][::-1]
        if data_format == first:
            return [(0, 0), (0, 0)] + pairs
        return [(0, 0)] + pairs + [(0, 0)]
    return [(0, 0)] * (nd - len(pad) // 2) + \
        [(pad[2 * i], pad[2 * i + 1]) for i in range(len(pad) // 2)]


def _pad_index(n, lo, hi, mode, device):
    """Source index of each output position along an axis of length n
    padded by (lo, hi): numpy's edge / reflect / wrap modes."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return torch.remainder(i, n)
    period = 2 * (n - 1)
    if period == 0:
        return torch.zeros_like(i)
    i = torch.remainder(i, period)
    return torch.where(i < n, i, period - i)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Pad `x` by Paddle's `pad` list (see `_pad_cfg`) in `mode`:
    "constant" (with `value`), "reflect" (about the edge, the edge not
    repeated), "replicate" (the edge repeated) or "circular"."""
    if mode not in _PAD_MODES:
        raise ValueError(f"pad: unknown mode {mode!r}")
    cfg = _pad_cfg(pad, x.dim(), data_format)
    if mode == "constant":
        flat = []
        for lo, hi in reversed(cfg):
            flat += [lo, hi]
        return torch.nn.functional.pad(x, flat, "constant", value)
    for axis, (lo, hi) in enumerate(cfg):
        if lo or hi:
            idx = _pad_index(x.shape[axis], lo, hi, mode, x.device)
            x = x.index_select(axis, idx)
    return x


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """Zero-pad H and W of a 4-D tensor; padding [left, right, top,
    bottom]."""
    return pad(x, padding, "constant", 0.0, data_format)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _pads4(p):
    """(top, bottom, left, right) of an int, a pair or four values."""
    if isinstance(p, int):
        return (p, p, p, p)
    if len(p) == 2:
        return (p[0], p[0], p[1], p[1])
    return tuple(p)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """[N, C, H, W] -> [N, C * kh * kw, L] sliding blocks, C the outer
    factor of the feature axis."""
    t, b, l, r = _pads4(paddings)
    x = torch.nn.functional.pad(x, (l, r, t, b))
    return torch.nn.functional.unfold(x, _pair(kernel_sizes),
                                      _pair(dilations), 0, _pair(strides))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """The adjoint of `unfold`: blocks [N, C * kh * kw, L] summed back
    into [N, C, H, W] (JAX :173-200)."""
    oh, ow = _pair(output_sizes)
    kh, kw = _pair(kernel_sizes)
    sh, sw = _pair(strides)
    dh, dw = _pair(dilations)
    pads = _pads4(paddings)
    n, ckk, _ = x.shape
    c = ckk // (kh * kw)
    hh, ww = oh + pads[0] + pads[1], ow + pads[2] + pads[3]
    nh = (hh - (dh * (kh - 1) + 1)) // sh + 1
    nw = (ww - (dw * (kw - 1) + 1)) // sw + 1
    out = torch.zeros(n, c, hh, ww, dtype=x.dtype, device=x.device)
    xr = x.reshape(n, c, kh, kw, nh, nw)
    for i in range(kh):
        for j in range(kw):
            hs, ws = i * dh, j * dw
            out[:, :, hs:hs + nh * sh:sh, ws:ws + nw * sw:sw] += \
                xr[:, :, i, j]
    return out[:, :, pads[0]:hh - pads[1], pads[2]:ww - pads[3]]


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    dot = torch.sum(x1 * x2, dim=axis)
    n1 = torch.sqrt(torch.sum(x1 * x1, dim=axis))
    n2 = torch.sqrt(torch.sum(x2 * x2, dim=axis))
    return dot / torch.clamp(n1 * n2, min=eps)


def _norm(x, p, axis, keepdim):
    """Paddle's vector p-norm along `axis` (JAX ops linalg.py:58)."""
    if p == float("inf"):
        return x.abs().amax(dim=axis, keepdim=keepdim)
    if p == float("-inf"):
        return x.abs().amin(dim=axis, keepdim=keepdim)
    if p == 0:
        return (x != 0).to(x.dtype).sum(dim=axis, keepdim=keepdim)
    if p == 2:
        return torch.sqrt(torch.sum(x.abs().square(), dim=axis,
                                    keepdim=keepdim))
    return torch.sum(x.abs() ** p, dim=axis, keepdim=keepdim) ** (1.0 / p)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """The p-norm of x - y + epsilon along the last axis."""
    return _norm(x - y + epsilon, p, -1, keepdim)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def one_hot(x, num_classes, name=None):
    """f32 one-hot rows (an id outside [0, num_classes) gives a zero row,
    as jax.nn.one_hot)."""
    ids = x.long()
    valid = (ids >= 0) & (ids < num_classes)
    out = torch.nn.functional.one_hot(torch.where(valid, ids, 0),
                                      num_classes).to(torch.float32)
    return out * valid.unsqueeze(-1)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    m = int(maxlen) if maxlen is not None else int(x.max())
    r = torch.arange(m, device=x.device)
    return (r < x.unsqueeze(-1)).to(torch_dtype(dtype))


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    norm = torch.sum(torch.abs(x) ** p, dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp(norm, min=epsilon)


def class_center_sample(label, num_classes, num_samples, group=None):
    """Class centers for partial-FC training (JAX :212): every positive
    class, then negatives drawn by ``np.random.RandomState(0)`` up to
    `num_samples`, on the host as in JAX.  Returns (the labels remapped
    to the sampled centers, the sampled class ids), int64 on the
    label's device."""
    dev = label.device if isinstance(label, torch.Tensor) else "cpu"
    lv = np.asarray(label.detach().cpu() if isinstance(label, torch.Tensor)
                    else label).reshape(-1)
    pos = np.unique(lv)
    if len(pos) >= num_samples:
        sampled = pos
    else:
        neg_pool = np.setdiff1d(np.arange(num_classes), pos)
        picked = np.random.RandomState(0).choice(
            neg_pool, size=num_samples - len(pos), replace=False)
        sampled = np.sort(np.concatenate([pos, picked]))
    remap = -np.ones(num_classes, np.int64)
    remap[sampled] = np.arange(len(sampled))
    return (torch.as_tensor(remap[lv], device=dev),
            torch.as_tensor(sampled.astype(np.int64), device=dev))


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM's shift over [N * T, C, H, W]: the first `shift_ratio` of the
    channels from the previous segment, the next as many from the next
    one, zero at the ends."""
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    nt, c, h, w = x.shape
    n = nt // seg_num
    v = x.reshape(n, seg_num, c, h, w)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    padded = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 0, 1, 1))
    out = torch.cat([padded[:, :seg_num, :c1], padded[:, 2:, c1:c2],
                     v[:, :, c2:]], dim=2).reshape(nt, c, h, w)
    if data_format == "NHWC":
        out = out.permute(0, 2, 3, 1)
    return out


def gather_tree(ids, parents):
    """Beam-search back-tracing: ids / parents [T, B, W] -> the full
    sequences, following the parent pointers from the last step back."""
    t = ids.shape[0]
    beam = torch.arange(ids.shape[2], device=ids.device,
                        dtype=parents.dtype).expand(ids.shape[1], -1)
    outs = [None] * t
    for i in range(t - 1, -1, -1):
        idx = beam.long()
        outs[i] = torch.gather(ids[i], 1, idx)
        beam = torch.gather(parents[i], 1, idx)
    return torch.stack(outs)


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention of each query row over its CSR column set only (JAX
    :263): q / k / v [B, H, S, D], offset [B, H, S + 1], columns [B, H,
    nnz]; scores and softmax in f32, the output in q's dtype.  The
    padding and attention masks are accepted and unused, as in JAX."""
    b, h, s, d = query.shape
    nnz = sparse_csr_columns.shape[-1]
    off = sparse_csr_offset.long()
    cols = sparse_csr_columns.long()
    counts = off[..., 1:] - off[..., :-1]
    pos = torch.arange(nnz, device=query.device)
    idx = (off[..., :-1, None] + pos).clamp(0, nnz - 1)
    valid = pos < counts[..., None]
    gathered = torch.gather(cols[..., None, :].expand(b, h, s, nnz), -1, idx)
    bi = torch.arange(b, device=query.device)[:, None, None, None]
    hi = torch.arange(h, device=query.device)[None, :, None, None]
    kg, vg = key[bi, hi, gathered], value[bi, hi, gathered]
    logits = torch.einsum("bhsd,bhsnd->bhsn", query.float(),
                          kg.float()) * (1.0 / (d ** 0.5))
    logits = torch.where(valid, logits, torch.full((), -1e30,
                                                   device=query.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhsn,bhsnd->bhsd", probs, vg.float())
    return out.to(query.dtype)
