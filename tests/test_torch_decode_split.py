"""The decode kernels' split-and-merge arithmetic, modelled in plain
PyTorch and held against the JAX package's Pallas kernels: the exact
tier (bf16 / f32 rows) and the int8 tier (int8 codes with f32 scales).

``paddle_tpu_torch/csrc/decode_common.cuh`` (`decode_split`) splits a
sequence's valid keys across a cluster of DEC_SPLIT CTAs (shares of
ceil(n / DEC_SPLIT) keys rounded up to whole tiles), walks each CTA's
share tile by tile with DEC_THREADS / 32 warps (each warp a fixed slice
of every tile, one max and one rescale per tile), merges the warps' (m,
l, acc) into the CTA's partial and the partials in rank order.  An empty
split keeps m = -1e30, l = 0 and must merge with weight exp(-1e30 - mx)
= 0.  `split_merge_model` repeats that arithmetic here, with the
header's constants read from the source, in float32 (with natural
exponentials: the kernels keep scores in log2 units and use 2^x, the
same weights); the CUDA kernels
themselves are held against their plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  The model runs at
key counts that leave splits empty, short tiles and key counts just
over a share, against `paged_attention` and `decode_attention` run in
interpret mode, at atol = rtol = 2e-5 (f32 reduction order).  The int8
tier runs the same core over rows of int8 codes (elements of 1 byte,
read 8 a lane: `DecTile<int8_t, CHP>`'s tiles), with each key's scale
applied to its score and to its weight, which is code * scale summed
over the row within f32 rounding; its model is `split_merge_model` on
the rows dequantized as the JAX kernel dequantizes them, held against
`paged_attention(..., k_scales=, v_scales=, interpret=True)` at the same
tolerance.
"""
from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas.decode_attention import (
    decode_attention as j_decode_attention,
)
from paddle_tpu.ops.pallas.paged_attention import (
    paged_attention as j_paged_attention,
)
from paddle_tpu_torch.ops.quant import dequantize_vectors, quantize_vectors

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = os.path.join(REPO, "paddle_tpu_torch", "csrc", "decode_common.cuh")
TOL = dict(atol=2e-5, rtol=2e-5)
NEG_INF = -1e30


def _constants():
    with open(HEADER) as f:
        text = f.read()
    return {name: int(v) for name, v in re.findall(
        r"constexpr int (DEC_\w+) = (\d+);", text)}


CONST = _constants()
SPLIT = CONST["DEC_SPLIT"]
WARPS = CONST["DEC_THREADS"] // 32


def tile_keys(elem, d):
    """(keys a tile, keys a warp a tile) of `DecTile` for elements of
    `elem` bytes at head dim d (a lane reads 16 bytes of a row, 8 of int8
    codes, whose tile holds half the bytes)."""
    chp = 1
    while chp < d * elem // 16:
        chp *= 2
    rpw = 32 // min(chp * (2 if elem == 1 else 1), 32)
    stage = CONST["DEC_Q8_STAGE_BYTES" if elem == 1 else "DEC_STAGE_BYTES"]
    tk = max(min(stage // (2 * 16 * chp), 64), WARPS * rpw,
             CONST["DEC_THREADS"] // chp)
    return tk, tk // WARPS


def shares(n, tk):
    """[(lo, hi)] of each CTA of a cluster for a sequence of n keys."""
    share = ((n + SPLIT - 1) // SPLIT + tk - 1) // tk * tk
    out = []
    for r in range(SPLIT):
        lo = min(n, r * share)
        out.append((lo, min(n, lo + share)))
    return out


def _merge(states):
    """(m [G], l [G], acc [G, D]) states merged in order."""
    mx = torch.stack([m for m, _, _ in states]).amax(0)
    l = torch.zeros_like(mx)
    acc = torch.zeros_like(states[0][2])
    for m, li, ai in states:
        c = torch.exp(m - mx)
        l = l + li * c
        acc = acc + ai * c[:, None]
    return mx, l, acc


def split_merge_model(q, k, v, elem):
    """q [G, D] (f32, pre-scaled); k, v [n, D] f32: one (sequence, kv
    head)'s valid keys in order.  Returns (out [G, D], the CTAs' (lo,
    hi))."""
    n, d = k.shape
    g = q.shape[0]
    tk, kpw = tile_keys(elem, d)
    parts = []
    splits = shares(n, tk)
    for lo, hi in splits:
        warps = []
        for w in range(WARPS):
            m = torch.full((g,), NEG_INF)
            l = torch.zeros(g)
            acc = torch.zeros(g, d)
            for j in range((hi - lo + tk - 1) // tk):
                idx = lo + j * tk + w * kpw + torch.arange(kpw)
                valid = idx < hi
                rows = idx.clamp(max=n - 1)
                s = torch.where(valid[None], q @ k[rows].T, NEG_INF)
                mn = torch.maximum(m, s.amax(1))
                alpha = torch.exp(m - mn)
                p = torch.where(valid[None], torch.exp(s - mn[:, None]),
                                0.0)
                l = l * alpha + p.sum(1)
                acc = acc * alpha[:, None] + p @ v[rows]
                m = mn
            warps.append((m, l, acc))
        parts.append(_merge(warps))
    _, l, acc = _merge(parts)
    return acc / torch.clamp(l, min=1e-30)[:, None], splits


@pytest.mark.parametrize("elem", [2, 4, 1],
                         ids=["bf16-tiles", "f32-tiles", "int8-tiles"])
@pytest.mark.parametrize("d", [16, 64])
def test_shares_cover_the_keys_and_leave_late_ranks_empty(d, elem):
    tk, _ = tile_keys(elem, d)
    for n in (1, 2, SPLIT - 1, tk, tk + 1, SPLIT * tk + 1, 1041):
        sp = shares(n, tk)
        assert sp[0][0] == 0 and sp[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(sp, sp[1:]))
        # whole tiles except the last non-empty share
        assert all((hi - lo) % tk == 0 for lo, hi in sp if hi < n)
        if n <= tk:
            assert all(lo == hi for lo, hi in sp[1:])


def _paged_case(rs, lens, hq, hkv, d, ps):
    b = len(lens)
    p = max(-(-n // ps) for n in lens) + 1
    npool = b * p + 1
    q = rs.randn(b, hq, d).astype(np.float32)
    kp = rs.randn(npool, hkv, ps, d).astype(np.float32)
    vp = rs.randn(npool, hkv, ps, d).astype(np.float32)
    pt = np.zeros((b, p), np.int32)
    perm = rs.permutation(npool - 1) + 1
    used = 0
    for r, n in enumerate(lens):
        k = -(-n // ps)
        pt[r, :k] = perm[used:used + k]
        used += k
    pos = np.asarray([n - 1 for n in lens], np.int32)
    return q, kp, vp, pt, pos


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16-tiles", "f32-tiles"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (12, 1)])
def test_split_model_matches_pallas_paged_attention(hq, hkv, elem):
    """Key counts 1 (every split but the first empty), a part tile,
    exactly one and just over one tile, and one key over a whole share
    per CTA; a shuffled page table over a pool of pages of 8."""
    rs = np.random.RandomState(11)
    d, ps = 16, 8
    tk, _ = tile_keys(elem, d)
    lens = [1, 5, tk, tk + 1, SPLIT * tk + 1]
    q, kp, vp, pt, pos = _paged_case(rs, lens, hq, hkv, d, ps)
    ref = np.asarray(j_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(pos), interpret=True))
    g = hq // hkv
    scale = 1.0 / d ** 0.5
    empty = 0
    for b, n in enumerate(lens):
        for h in range(hkv):
            pages = torch.from_numpy(pt[b]).long()
            k = torch.from_numpy(kp)[pages, h].reshape(-1, d)[:n]
            v = torch.from_numpy(vp)[pages, h].reshape(-1, d)[:n]
            qg = torch.from_numpy(q[b, h * g:(h + 1) * g]) * scale
            out, splits = split_merge_model(qg, k, v, elem)
            empty += sum(lo == hi for lo, hi in splits)
            np.testing.assert_allclose(out.numpy(),
                                       ref[b, h * g:(h + 1) * g], **TOL)
    assert empty > 0


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16-tiles", "f32-tiles"])
@pytest.mark.parametrize("hq,hkv", [(8, 2), (32, 2)])
def test_split_model_matches_pallas_decode_attention(hq, hkv, elem):
    """Left-padded rows (start > 0): the split counts from `start`, so
    a row's CTAs see only its valid keys start..pos."""
    rs = np.random.RandomState(12)
    d = 16
    tk, _ = tile_keys(elem, d)
    b, s = 4, SPLIT * tk + 48
    q = rs.randn(b, hq, d).astype(np.float32)
    kc = rs.randn(b, hkv, s, d).astype(np.float32)
    vc = rs.randn(b, hkv, s, d).astype(np.float32)
    pos = np.asarray([0, 40, 40 + tk, s - 1], np.int32)
    start = np.asarray([0, 40, 39, s - 1 - SPLIT * tk], np.int32)
    ref = np.asarray(j_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos),
        block_k=8, interpret=True, start=jnp.asarray(start)))
    g = hq // hkv
    scale = 1.0 / d ** 0.5
    for i in range(b):
        for h in range(hkv):
            k = torch.from_numpy(kc[i, h, start[i]:pos[i] + 1])
            v = torch.from_numpy(vc[i, h, start[i]:pos[i] + 1])
            qg = torch.from_numpy(q[i, h * g:(h + 1) * g]) * scale
            out, _ = split_merge_model(qg, k, v, elem)
            np.testing.assert_allclose(out.numpy(),
                                       ref[i, h * g:(h + 1) * g], **TOL)


def test_one_key_merges_to_its_value_row_exactly():
    """pos = 0 (a free engine slot): one key in the first split, every
    other split empty.  The empty splits merge with weight exactly 0 and
    the one key with weight 1, so the output is the value row itself,
    bit for bit, as the JAX kernel's is."""
    rs = np.random.RandomState(13)
    q = rs.randn(1, 3, 32).astype(np.float32)
    kc = rs.randn(1, 1, 8, 32).astype(np.float32)
    vc = rs.randn(1, 1, 8, 32).astype(np.float32)
    out, splits = split_merge_model(torch.from_numpy(q[0]) / 32 ** 0.5,
                                    torch.from_numpy(kc[0, 0, :1]),
                                    torch.from_numpy(vc[0, 0, :1]), 2)
    assert sum(lo < hi for lo, hi in splits) == 1
    assert np.array_equal(out.numpy(), np.repeat(vc[0, 0, :1], 3, 0))
    ref = np.asarray(j_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.zeros(1, jnp.int32), block_k=8, interpret=True))
    assert np.array_equal(ref[0], out.numpy())


def _int8_pages(rs, lens, hq, hkv, d, ps):
    """`_paged_case`'s pools quantized by the port's int8 codec (bit for
    bit the JAX package's): (q, codes, scales of K and V, table, pos)."""
    q, kp, vp, pt, pos = _paged_case(rs, lens, hq, hkv, d, ps)
    kq, ks = quantize_vectors(torch.from_numpy(kp))
    vq, vs = quantize_vectors(torch.from_numpy(vp))
    return q, kq, ks, vq, vs, pt, pos


def _int8_rows(codes, scales, pages, h, n):
    """One (sequence, kv head)'s first n keys, dequantized in f32 as the
    kernel does: each key's 16-code chunks times its scale."""
    d = codes.shape[-1]
    return dequantize_vectors(codes[pages, h], scales[pages, h]).reshape(
        -1, d)[:n]


@pytest.mark.parametrize("ps", [16, 6])
@pytest.mark.parametrize("lens", ["pages", "tiles", "shares"])
@pytest.mark.parametrize("hq,hkv", [(2, 2), (8, 2)])
def test_int8_split_model_matches_pallas_paged_attention(hq, hkv, lens, ps):
    """The int8 tier (G 1 and 4, D 64, pages of 16 and of 6, whose scales
    the kernel copies 4 bytes a row): key counts at and across the page
    boundaries with pos 0 ("pages"), at and across a tile ("tiles") and
    one key over a whole share a CTA ("shares"), with shares left empty;
    the split model on the dequantized rows against the Pallas kernel's
    int8 branch in interpret mode."""
    rs = np.random.RandomState(14)
    d = 64
    tk, _ = tile_keys(1, d)
    lens = {"pages": [1, ps, ps + 1], "tiles": [tk - 1, tk, tk + 1],
            "shares": [SPLIT * tk + 1]}[lens]
    q, kq, ks, vq, vs, pt, pos = _int8_pages(rs, lens, hq, hkv, d, ps)
    ref = np.asarray(j_paged_attention(
        jnp.asarray(q), jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
        jnp.asarray(pt), jnp.asarray(pos), interpret=True,
        k_scales=jnp.asarray(ks.numpy()), v_scales=jnp.asarray(vs.numpy())))
    g = hq // hkv
    scale = 1.0 / d ** 0.5
    empty = 0
    for b, n in enumerate(lens):
        pages = torch.from_numpy(pt[b]).long()
        for h in range(hkv):
            k = _int8_rows(kq, ks, pages, h, n)
            v = _int8_rows(vq, vs, pages, h, n)
            qg = torch.from_numpy(q[b, h * g:(h + 1) * g]) * scale
            out, splits = split_merge_model(qg, k, v, 1)
            empty += sum(lo == hi for lo, hi in splits)
            np.testing.assert_allclose(out.numpy(),
                                       ref[b, h * g:(h + 1) * g], **TOL)
    assert empty > 0


def test_int8_one_key_merges_to_its_dequantized_row_exactly():
    """pos 0 in the int8 tier: the one key's weight is exactly 1 and the
    empty shares' exactly 0, so the output is the key's value codes times
    their scale, bit for bit, as the JAX kernel's is."""
    rs = np.random.RandomState(15)
    q, kq, ks, vq, vs, pt, pos = _int8_pages(rs, [1], 4, 1, 128, 16)
    pages = torch.from_numpy(pt[0]).long()
    out, splits = split_merge_model(
        torch.from_numpy(q[0]) / 128 ** 0.5, _int8_rows(kq, ks, pages, 0, 1),
        _int8_rows(vq, vs, pages, 0, 1), 1)
    assert sum(lo < hi for lo, hi in splits) == 1
    row = _int8_rows(vq, vs, pages, 0, 1).numpy()
    assert np.array_equal(out.numpy(), np.repeat(row, 4, 0))
    ref = np.asarray(j_paged_attention(
        jnp.asarray(q), jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
        jnp.asarray(pt), jnp.asarray(pos), interpret=True,
        k_scales=jnp.asarray(ks.numpy()), v_scales=jnp.asarray(vs.numpy())))
    assert np.array_equal(ref[0], out.numpy())
