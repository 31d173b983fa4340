"""Pooling functionals (``paddle_tpu/nn/functional/pooling.py``
counterpart), as the JAX functions compute them with
`lax.reduce_window`:

  * max pools pad with -inf; average pools divide by the number of
    in-bounds elements where they pad and ``exclusive=True`` (else by
    the window size); string padding ("SAME" / "VALID") is XLA's;
  * `ceil_mode` is accepted and ignored, as in JAX (floor mode), and so
    are `divisor_override` and the adaptive pools' `data_format`;
  * `max_pool2d(return_mask=True)` returns the flat h * w index of each
    maximum (NCHW, no ceil_mode; JAX :127-156); `max_pool1d` refuses
    `return_mask` as JAX does, and the adaptive max pools ignore it;
  * adaptive pools average (or max) over the buckets [floor(i n / o),
    ceil((i + 1) n / o)) of each spatial axis;
  * the unpools scatter into the flat spatial positions the indices
    name, the output size from `output_size` or (in - 1) s - 2 p + k.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "avg_pool1d", "avg_pool2d", "avg_pool3d",
    "max_pool1d", "max_pool2d", "max_pool3d",
    "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
    "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d",
    "max_unpool1d", "max_unpool2d", "max_unpool3d",
]


def _tup(v, n):
    if v is None:
        return None
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


def _same(spatial, k, s):
    out = []
    for size, kk, ss in zip(spatial, k, s):
        total = max(0, ((size + ss - 1) // ss - 1) * ss + kk - size)
        out.append((total // 2, total - total // 2))
    return out


def _windows(x, k, s):
    """x [N, C, *sp] -> [N, C, *out, *k] windows (strides s)."""
    for i, (kk, ss) in enumerate(zip(k, s)):
        x = x.unfold(2 + i, kk, ss)
    return x


def _pool(x, ksize, stride, padding, n, mode, exclusive=True,
          channel_last=False):
    k = _tup(ksize, n)
    s = _tup(stride, n) or k
    if channel_last:
        x = x.movedim(-1, 1)
    if isinstance(padding, str):
        pads = ([(0, 0)] * n if padding.upper() == "VALID"
                else _same(x.shape[2:], k, s))
    else:
        pads = [(p, p) for p in _tup(padding, n)]
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    red = tuple(range(-n, 0))
    if mode == "max":
        fill = -math.inf if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        xp = F.pad(x, flat, "constant", fill) if any(flat) else x
        out = _windows(xp, k, s).amax(dim=red)
    else:
        xp = F.pad(x, flat) if any(flat) else x
        out = _windows(xp, k, s).sum(dim=red)
        # string padding divides by the window (JAX's pads are a string)
        if exclusive and any(flat) and not isinstance(padding, str):
            ones = F.pad(torch.ones_like(x), flat)
            out = out / _windows(ones, k, s).sum(dim=red)
        else:
            out = out / float(math.prod(k))
    return out.movedim(1, -1) if channel_last else out


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _pool(x, kernel_size, stride, padding, 1, "avg", exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 2, "avg", exclusive,
                 data_format == "NHWC")


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, "avg", exclusive,
                 data_format == "NDHWC")


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    if return_mask:
        raise NotImplementedError(
            "max_pool1d(return_mask=True): use max_pool2d on a [N,C,1,L] "
            "view — 2d carries the argmax path")
    return _pool(x, kernel_size, stride, padding, 1, "max")


def _max_pool2d_with_index(x, kernel_size, stride, padding):
    """Pooled values and the flat h * w index of each maximum, the first
    maximum of a window in row-major window order (JAX :127)."""
    kh, kw = _tup(kernel_size, 2)
    sh, sw = _tup(stride or kernel_size, 2)
    ph, pw = _tup(padding, 2)
    h, w = x.shape[2], x.shape[3]
    neg = torch.finfo(torch.float32).min
    xp = F.pad(x, (pw, pw, ph, ph), "constant", neg)
    win = xp.unfold(2, kh, sh).unfold(3, kw, sw)     # N, C, OH, OW, kh, kw
    oh, ow = win.shape[2], win.shape[3]
    flat = win.reshape(*win.shape[:4], kh * kw)
    vals, local = flat.max(dim=-1)
    ki, kj = local // kw, local % kw
    gy = torch.arange(oh, device=x.device)[:, None] * sh + ki - ph
    gx = torch.arange(ow, device=x.device)[None, :] * sw + kj - pw
    mask = (gy.clamp(0, h - 1) * w + gx.clamp(0, w - 1)).to(torch.int32)
    return vals, mask


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    """Padded with -inf, floor mode (the JAX `_pool` ignores ceil_mode);
    `stride=None` is the kernel size."""
    if return_mask:
        if data_format != "NCHW":
            raise NotImplementedError("return_mask needs NCHW")
        if ceil_mode:
            raise NotImplementedError("return_mask with ceil_mode")
        return _max_pool2d_with_index(x, kernel_size, stride, padding)
    if data_format == "NCHW" and not isinstance(padding, str):
        # the vision models' route: torch's pool, the same numbers
        return F.max_pool2d(x, kernel_size, stride, padding)
    return _pool(x, kernel_size, stride, padding, 2, "max",
                 channel_last=data_format == "NHWC")


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _pool(x, kernel_size, stride, padding, 3, "max",
                 channel_last=data_format == "NDHWC")


def _adaptive(x, output_size, n, mode):
    out_sz = _tup(output_size, n)
    out = x
    for ax, o in enumerate(out_sz):
        dim = out.shape[2 + ax]
        pieces = []
        for i in range(o):
            lo, hi = (i * dim) // o, -((-(i + 1) * dim) // o)
            seg = out.narrow(2 + ax, lo, hi - lo)
            pieces.append(seg.amax(dim=2 + ax, keepdim=True) if mode == "max"
                          else seg.mean(dim=2 + ax, keepdim=True))
        out = torch.cat(pieces, dim=2 + ax)
    return out


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, "avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Mean over the buckets [floor(i*n/o), ceil((i+1)*n/o)) of each
    spatial axis, as the JAX `_adaptive` takes them."""
    return F.adaptive_avg_pool2d(x, output_size)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, "avg")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 1, "max")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 2, "max")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 3, "max")


def _unpool(x, indices, spatial):
    n, c = x.shape[0], x.shape[1]
    out = x.new_zeros(n, c, math.prod(spatial))
    out.scatter_(2, indices.reshape(n, c, -1).long(), x.reshape(n, c, -1))
    return out.reshape((n, c) + tuple(spatial))


def _unpool_size(in_sp, kernel_size, stride, padding, nd, output_size):
    if output_size is not None:
        return tuple(output_size[-nd:])
    ks = _tup(kernel_size, nd)
    st = ks if stride is None else _tup(stride, nd)
    pd = _tup(padding, nd)
    return tuple((i - 1) * s - 2 * p + k
                 for i, k, s, p in zip(in_sp, ks, st, pd))


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _unpool(x, indices, _unpool_size(
        x.shape[2:], kernel_size, stride, padding, 1, output_size))


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _unpool(x, indices, _unpool_size(
        x.shape[2:], kernel_size, stride, padding, 2, output_size))


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _unpool(x, indices, _unpool_size(
        x.shape[2:], kernel_size, stride, padding, 3, output_size))
