"""Vision functionals (``paddle_tpu/nn/functional/vision.py``
counterpart): interpolate / upsample, pixel_shuffle / pixel_unshuffle,
channel_shuffle, affine_grid and grid_sample.

`interpolate` computes what the JAX function computes: "nearest" takes
source index floor(i * in / out) on each resized axis; every other mode
is `jax.image.resize` ("bilinear" / "linear" / "trilinear" / "area" its
triangle kernel, "bicubic" its Keys cubic, a = -0.5), half-pixel
centres with the kernel widened by in / out when downsampling
(antialiasing), one weight matrix per resized axis.  `align_corners`
and `align_mode` are accepted and do not change the result, as in JAX
(ROADMAP C2.37: Paddle's `align_corners=True` samples the corners).
"""
from __future__ import annotations

import torch

__all__ = ["interpolate", "upsample", "pixel_shuffle", "pixel_unshuffle",
           "channel_shuffle", "affine_grid", "grid_sample"]

_CHANNEL_LAST = ("NHWC", "NWC", "NDHWC")


def _triangle(x):
    return torch.clamp(1 - x.abs(), min=0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros((), device=x.device), out)


def _weight_mat(n_in, n_out, kernel, device):
    """[n_in, n_out] f32 weights of `jax.image.resize` along one axis
    (`compute_weight_mat`: scale n_out / n_in, no translation,
    antialiased)."""
    scale = torch.tensor(n_out / n_in, dtype=torch.float32)
    inv = 1.0 / scale
    kscale = torch.clamp(inv, min=1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]
         ).abs() / kscale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones(())),
                    torch.zeros(()))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros(())).to(device)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    chan_last = data_format in _CHANNEL_LAST
    first = 1 if chan_last else 2
    spatial = x.shape[first:x.dim() - 1] if chan_last else x.shape[2:]
    n_sp = len(spatial)
    if size is None:
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * n_sp
        size = [int(s * f) for s, f in zip(spatial, scale_factor)]
    else:
        size = [int(s) for s in (size if isinstance(size, (list, tuple))
                                 else [size])]
    axes = range(first, first + n_sp)
    if mode == "nearest":
        out = x
        for i, ax in enumerate(axes):
            n_in, n_out = x.shape[ax], size[i]
            idx = torch.floor(torch.arange(n_out, dtype=torch.float32)
                              * n_in / n_out).long().to(x.device)
            out = out.index_select(ax, idx)
        return out
    kernel = {"bilinear": _triangle, "linear": _triangle,
              "trilinear": _triangle, "area": _triangle,
              "bicubic": _keys_cubic}[mode]
    out = x if x.is_floating_point() else x.float()
    for i, ax in enumerate(axes):
        n_in, n_out = out.shape[ax], size[i]
        if n_in == n_out:
            continue
        w = _weight_mat(n_in, n_out, kernel, x.device).to(out.dtype)
        out = torch.tensordot(out, w, dims=([ax], [0])).movedim(-1, ax)
    return out


upsample = interpolate


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        out = x.reshape(n, c // (r * r), r, r, h, w)
        return out.permute(0, 1, 4, 2, 5, 3).reshape(n, c // (r * r),
                                                     h * r, w * r)
    n, h, w, c = x.shape
    out = x.reshape(n, h, w, r, r, c // (r * r))
    return out.permute(0, 1, 3, 2, 4, 5).reshape(n, h * r, w * r,
                                                 c // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        out = x.reshape(n, c, h // r, r, w // r, r)
        return out.permute(0, 1, 3, 5, 2, 4).reshape(n, c * r * r, h // r,
                                                     w // r)
    n, h, w, c = x.shape
    out = x.reshape(n, h // r, r, w // r, r, c)
    return out.permute(0, 1, 3, 2, 4, 5).reshape(n, h // r, w // r,
                                                 c * r * r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return x.reshape(n, groups, c // groups, h, w).transpose(
            1, 2).reshape(n, c, h, w)
    n, h, w, c = x.shape
    return x.reshape(n, h, w, groups, c // groups).transpose(
        3, 4).reshape(n, h, w, c)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """[N, H, W, 2] sampling grid of the affine maps theta [N, 2, 3] over
    the normalised [-1, 1] coordinates of an [N, C, H, W] output."""
    n, _, h, w = [int(s) for s in out_shape]
    dev, dt = theta.device, theta.dtype
    if align_corners:
        ys = torch.linspace(-1, 1, h, device=dev, dtype=dt)
        xs = torch.linspace(-1, 1, w, device=dev, dtype=dt)
    else:
        ys = (torch.arange(h, device=dev, dtype=dt) + 0.5) * 2 / h - 1
        xs = (torch.arange(w, device=dev, dtype=dt) + 0.5) * 2 / w - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("hwk,nck->nhwc", base, theta)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """x [N, C, H, W] sampled at grid [N, Hg, Wg, 2] (x, y in [-1, 1]),
    bilinear or nearest (round half to even), zero outside; the JAX
    function's only `padding_mode`."""
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx, fy = (gx + 1) * (w - 1) / 2, (gy + 1) * (h - 1) / 2
    else:
        fx, fy = ((gx + 1) * w - 1) / 2, ((gy + 1) * h - 1) / 2
    bidx = torch.arange(n, device=x.device)[:, None, None]

    def gather(yy, xx):
        valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = x[bidx, :, yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
        v = v.permute(0, 3, 1, 2)                       # N, C, Hg, Wg
        return torch.where(valid[:, None], v, torch.zeros(
            (), dtype=x.dtype, device=x.device))

    if mode == "nearest":
        return gather(torch.round(fy).long(), torch.round(fx).long())
    x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
    x1, y1 = x0 + 1, y0 + 1
    wa = (x1 - fx) * (y1 - fy)
    wb = (x1 - fx) * (fy - y0)
    wc = (fx - x0) * (y1 - fy)
    wd = (fx - x0) * (fy - y0)
    out = gather(y0, x0) * wa[:, None] + gather(y1, x0) * wb[:, None] \
        + gather(y0, x1) * wc[:, None] + gather(y1, x1) * wd[:, None]
    return out.to(x.dtype)
