"""The port's kernel plain versions against the JAX package's Pallas
kernels, run the way the JAX tests run them on the CPU (interpret mode).

Every case feeds the same seeded numpy inputs to both and compares in
float32 at atol = rtol = 2e-5 (reduction-order noise of f32 softmax).
On the CPU the port's wrappers run their plain versions, so these tests
also check that CPU dispatch launches nothing.  The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu.ops.pallas.decode_attention import (
    decode_attention as j_decode_attention,
)
from paddle_tpu.ops.pallas.paged_attention import (
    paged_attention as j_paged_attention,
)
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels.decode_attention import decode_attention
from paddle_tpu_torch.ops.kernels.flash_attention import flash_fwd
from paddle_tpu_torch.ops.kernels.paged_attention import paged_attention

TOL = dict(atol=2e-5, rtol=2e-5)


def _pad_seq(x, mult=8):
    """[B,H,S,D] -> zero-padded along S to a multiple of `mult`."""
    pad = (-x.shape[2]) % mult
    return np.pad(x, ((0, 0), (0, 0), (0, pad), (0, 0)))


@pytest.fixture(autouse=True)
def _no_launches():
    K.reset_launches()
    yield
    # the CPU path runs plain versions only: no kernel was launched
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d", [
    (2, 16, 16, 4, 4, 16),     # MHA, block-aligned
    (1, 13, 21, 4, 2, 8),      # GQA, odd lengths, Sk > Sq (bottom-right)
    (2, 9, 9, 6, 2, 32),       # GQA rep 3, odd self-attention
])
def test_flash_fwd_plain_matches_fwd_t(b, sq, sk, hq, hkv, d, causal):
    rs = np.random.RandomState(sq * 31 + sk)
    q = rs.randn(b, sq, hq, d).astype(np.float32)
    k = rs.randn(b, sk, hkv, d).astype(np.float32)
    v = rs.randn(b, sk, hkv, d).astype(np.float32)
    qt, kt, vt = (_pad_seq(x.transpose(0, 2, 1, 3)) for x in (q, k, v))
    jo, jl = JFA._fwd_t(jnp.asarray(qt), jnp.asarray(kt), jnp.asarray(vt),
                        causal, 8, 8, seq_q_real=sq, seq_k_real=sk)
    jo = np.asarray(jo)[:, :, :sq].transpose(0, 2, 1, 3)
    jl = np.asarray(jl)[:, :, :sq, 0]
    to, tl = flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(to.numpy(), jo, **TOL)
    np.testing.assert_allclose(tl.numpy(), jl, **TOL)


@pytest.mark.parametrize("kind", ["additive", "bool"])
@pytest.mark.parametrize("bias_shape", [
    (1, 1, 16, 24),     # broadcast over batch and head
    (2, 1, 16, 24),     # per batch row (the left-pad mask's shape)
    (1, 3, 16, 24),     # per head
    (2, 3, 16, 24),     # full
])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_plain_matches_fwd_tb(bias_shape, kind, causal):
    b, h, sq, sk, d = 2, 3, 16, 24, 16
    rs = np.random.RandomState(7)
    q = rs.randn(b, sq, h, d).astype(np.float32)
    k = rs.randn(b, sk, h, d).astype(np.float32)
    v = rs.randn(b, sk, h, d).astype(np.float32)
    if kind == "bool":
        mask = rs.rand(*bias_shape) > 0.3
        # keep the bottom-right diagonal so no row is fully masked
        mask |= np.eye(sq, sk, k=sk - sq, dtype=bool)
        jbias = np.where(mask, 0.0, JFA.NEG_INF).astype(np.float32)
        tbias = torch.from_numpy(mask)
    else:
        jbias = rs.randn(*bias_shape).astype(np.float32)
        tbias = torch.from_numpy(jbias)
    jo, jl = JFA._fwd_tb(
        jnp.asarray(q.transpose(0, 2, 1, 3)),
        jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), jnp.asarray(jbias), causal,
        8, 8)
    to, tl = flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), bias=tbias, causal=causal)
    np.testing.assert_allclose(to.numpy(),
                               np.asarray(jo).transpose(0, 2, 1, 3), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[..., 0], **TOL)


def test_flash_fwd_left_pad_rows_stay_finite():
    """Fully masked (left-pad) query rows: the finite NEG_INF keeps them
    finite — with -inf they would be NaN and poison the next layer."""
    b, s, h, d = 2, 12, 2, 8
    rs = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rs.randn(b, s, h, d).astype(np.float32))
               for _ in range(3))
    start = torch.tensor([5, 0])
    j = torch.arange(s)[None, :]
    i = torch.arange(s)[:, None]
    valid = (j <= i)[None] & (j[None] >= start[:, None, None])
    mask = torch.where(valid[:, None], 0.0, -1e30)
    out, lse = flash_fwd(q, k, v, bias=mask)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()


@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4)])
def test_paged_attention_plain_matches_pallas(hq, hkv):
    rs = np.random.RandomState(1)
    b, d, ps, npool = 5, 16, 8, 12
    q = rs.randn(b, hq, d).astype(np.float32)
    kp = rs.randn(npool, hkv, ps, d).astype(np.float32)
    vp = rs.randn(npool, hkv, ps, d).astype(np.float32)
    # ragged: page-boundary crossing (25), exact boundary (15), single
    # token (0), full table (31), and a free slot on the scratch page
    pt = np.asarray([[1, 2, 3, 4], [5, 6, 0, 0], [7, 0, 0, 0],
                     [8, 9, 10, 11], [0, 0, 0, 0]], np.int32)
    pos = np.asarray([25, 15, 0, 31, 0], np.int32)
    ref = j_paged_attention(jnp.asarray(q), jnp.asarray(kp),
                            jnp.asarray(vp), jnp.asarray(pt),
                            jnp.asarray(pos), interpret=True)
    out = paged_attention(*(torch.from_numpy(x)
                            for x in (q, kp, vp, pt, pos)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_paged_attention_int8_pool_raises():
    q = torch.zeros(1, 2, 8)
    kp = torch.zeros(2, 2, 8, 8, dtype=torch.int8)
    with pytest.raises(NotImplementedError):
        paged_attention(q, kp, kp, torch.zeros(1, 1, dtype=torch.int32),
                        torch.zeros(1, dtype=torch.int32),
                        k_scales=torch.ones(2, 2, 8),
                        v_scales=torch.ones(2, 2, 8))


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("with_start", [True, False])
def test_decode_attention_plain_matches_pallas(hq, hkv, with_start):
    rs = np.random.RandomState(2)
    b, s, d = 3, 40, 16
    q = rs.randn(b, hq, d).astype(np.float32)
    kc = rs.randn(b, hkv, s, d).astype(np.float32)
    vc = rs.randn(b, hkv, s, d).astype(np.float32)
    pos = np.asarray([30, 7, 39], np.int32)
    start = np.asarray([4, 0, 17], np.int32) if with_start else None
    ref = j_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos),
        block_k=8, interpret=True,
        start=None if start is None else jnp.asarray(start))
    out = decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(pos),
        None if start is None else torch.from_numpy(start))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_paged_equals_dense_decode_plain():
    """Gathering each row's pages into a dense cache and running the
    dense decode version gives the paged answer."""
    rs = np.random.RandomState(4)
    b, hq, hkv, d, ps, npool, p = 2, 4, 4, 8, 8, 8, 2
    q = torch.from_numpy(rs.randn(b, hq, d).astype(np.float32))
    kp = torch.from_numpy(rs.randn(npool, hkv, ps, d).astype(np.float32))
    vp = torch.from_numpy(rs.randn(npool, hkv, ps, d).astype(np.float32))
    pt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([11, 6], dtype=torch.int32)
    k = kp[pt.long()].transpose(1, 2).reshape(b, hkv, p * ps, d)
    v = vp[pt.long()].transpose(1, 2).reshape(b, hkv, p * ps, d)
    torch.testing.assert_close(paged_attention(q, kp, vp, pt, pos),
                               decode_attention(q, k, v, pos), **TOL)
