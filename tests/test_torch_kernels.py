"""The port's kernel plain versions against the JAX package's Pallas
kernels, run the way the JAX tests run them on the CPU (interpret mode).

Every case feeds the same seeded numpy inputs to both and compares in
float32 at atol = rtol = 2e-5 (reduction-order noise of f32 softmax);
rope, which sums two products per element, at atol = rtol = 1e-6.
On the CPU the port's wrappers run their plain versions, so these tests
also check that CPU dispatch launches nothing.  The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as P
from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu.ops.pallas import rope as JR
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
from paddle_tpu_torch.ops.kernels.rope import RoPE, rope, rope_reference
from paddle_tpu_torch.nn import functional as TF

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)

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


@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4), (32, 2)])
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
    """The int8 tier is served now (tests/test_torch_quant_kv.py holds it
    against JAX); what still raises is an int8 pool with one scale table
    only.  With both, the plain version dequantizes code * scale."""
    q = torch.ones(1, 2, 8)
    kp = torch.ones(2, 2, 8, 8, dtype=torch.int8)
    table = torch.zeros(1, 1, dtype=torch.int32)
    pos = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
        paged_attention(q, kp, kp, table, pos, k_scales=torch.ones(2, 2, 8))
    with pytest.raises(ValueError, match="together"):
        paged_attention(q, kp, kp, table, pos, v_scales=torch.ones(2, 2, 8))
    out = paged_attention(q, kp, kp, table, pos,
                          k_scales=torch.ones(2, 2, 8),
                          v_scales=torch.full((2, 2, 8), 0.5))
    assert torch.equal(out, torch.full((1, 2, 8), 0.5))


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (32, 2)])
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


# ------------------------------------------------------------------ rope
ROPE_TOL = dict(atol=1e-6, rtol=1e-6)


def _neox_phases(rs, pb, s, d):
    """cos / sin [pb, S, 1, D] = concat(freqs, freqs) phases of random
    positions (both halves equal, as every caller builds them)."""
    pos = rs.randint(0, 2048, (pb, s)).astype(np.float32)
    inv = 1.0 / 10000.0 ** (np.arange(0, d, 2, dtype=np.float32) / d)
    emb = np.concatenate([pos[..., None] * inv] * 2, axis=-1)
    return (np.cos(emb)[:, :, None].astype(np.float32),
            np.sin(emb)[:, :, None].astype(np.float32))


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("b,s,h,d,pb", [
    (2, 4, 3, 16, 1),      # phases broadcast over the batch
    (2, 4, 3, 16, 2),      # per-row phases (left-padded / ragged rows)
    (1, 8, 2, 32, 1),
    (4, 2, 5, 8, 4),
])
def test_rope_plain_matches_pallas_kernel(b, s, h, d, pb, adjoint):
    """Forward and adjoint against `_rope_call` in interpret mode (the
    Pallas kernel itself), on arbitrary phases: both apply the same
    formula, whatever the halves of sin hold."""
    rs = np.random.RandomState(b * 100 + s * 10 + d)
    x = rs.randn(b, s, h, d).astype(np.float32)
    cos = rs.randn(pb, s, 1, d).astype(np.float32)
    sin = rs.randn(pb, s, 1, d).astype(np.float32)
    ref = JR._rope_call(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin),
                        adjoint, interpret=True)
    out = rope(*(torch.from_numpy(a) for a in (x, cos, sin)),
               adjoint=adjoint)
    assert out.shape == x.shape and out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ROPE_TOL)


def test_rope_grad_matches_jax_grad_of_rope_pallas():
    """`RoPE`'s gradient (the adjoint) against ``jax.grad`` through
    `rope_pallas`'s custom VJP, with neox phases; the phases get none."""
    rs = np.random.RandomState(5)
    b, s, h, d = 2, 4, 3, 16
    x = rs.randn(b, s, h, d).astype(np.float32)
    g = rs.randn(b, s, h, d).astype(np.float32)
    cos, sin = _neox_phases(rs, b, s, d)
    want = jax.grad(lambda x_: (JR.rope_pallas(x_, jnp.asarray(cos),
                                               jnp.asarray(sin)) * g).sum())(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tc, ts = (torch.from_numpy(a).requires_grad_() for a in (cos, sin))
    (RoPE.apply(tx, tc, ts) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), **ROPE_TOL)
    assert tc.grad is None and ts.grad is None


def _qk_views(rs, b, s, hq, hkv, d, dtype=torch.float32):
    """q [B,S,Hq,D] and k [B,S,Hkv,D] as the attention takes them: strided
    views of one fused qkv projection."""
    qkv = torch.from_numpy(rs.randn(b, s, (hq + 2 * hkv) * d).astype(
        np.float32)).to(dtype)
    q, k, _ = qkv.split([hq * d, hkv * d, hkv * d], dim=-1)
    return q.reshape(b, s, hq, d), k.reshape(b, s, hkv, d)


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("hq,hkv,pb", [(4, 2, 1), (6, 1, 2), (3, 3, 2)])
def test_paired_rope_plain_matches_pallas_kernel(hq, hkv, pb, adjoint):
    """One `rope` call for q and k of different head counts (GQA 4/2,
    6/1, 3/3), per-row and broadcast phases, forward and adjoint: each
    output against `_rope_call` in interpret mode on that tensor, and bit
    for bit the two single-tensor calls, in f32 and bf16."""
    rs = np.random.RandomState(hq * 10 + hkv + pb)
    b, s, d = 2, 4, 16
    q, k = _qk_views(rs, b, s, hq, hkv, d)
    assert not q.is_contiguous() and not k.is_contiguous()
    cos = rs.randn(pb, s, 1, d).astype(np.float32)
    sin = rs.randn(pb, s, 1, d).astype(np.float32)
    tc, ts = torch.from_numpy(cos), torch.from_numpy(sin)
    oq, ok = rope(q, tc, ts, adjoint=adjoint, k=k)
    for x, out in ((q, oq), (k, ok)):
        ref = JR._rope_call(jnp.asarray(x.numpy()), jnp.asarray(cos),
                            jnp.asarray(sin), adjoint, interpret=True)
        assert out.shape == x.shape and out.is_contiguous()
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ROPE_TOL)
    for dtype in (torch.float32, torch.bfloat16):
        qd, kd, cd, sd = (t.to(dtype) for t in (q, k, tc, ts))
        for inter in (False, True):
            pair = rope(qd, cd, sd, adjoint, inter, k=kd)
            assert torch.equal(pair[0], rope(qd, cd, sd, adjoint, inter))
            assert torch.equal(pair[1], rope(kd, cd, sd, adjoint, inter))


@pytest.mark.parametrize("interleaved", [False, True])
def test_paired_rope_grads_match_jax_grad(interleaved):
    """`RoPE` over q and k together: both gradients from one adjoint call,
    against ``jax.grad`` through the JAX functional (the Pallas
    `rope_pallas` custom VJP for neox, the jnp path for interleaved) on
    the same GQA q [2,4,4,16] and k [2,4,2,16], and bit for bit the
    single-tensor `RoPE`'s."""
    rs = np.random.RandomState(9)
    b, s, hq, hkv, d = 2, 4, 4, 2, 16
    q, k = (rs.randn(b, s, h, d).astype(np.float32) for h in (hq, hkv))
    gq, gk = (rs.randn(b, s, h, d).astype(np.float32) for h in (hq, hkv))

    def jloss(q_, k_):
        oq, ok, _ = P.nn.functional.fused_rotary_position_embedding(
            P.Tensor(q_), P.Tensor(k_), None,
            use_neox_rotary_style=not interleaved)
        return (oq._value * gq).sum() + (ok._value * gk).sum()

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(k))
    tq, tk = (torch.from_numpy(a).requires_grad_() for a in (q, k))
    cos, sin = (p.to(torch.float32) for p in TF.rotary_phases(d, s))
    oq, ok = RoPE.apply(tq, cos, sin, interleaved, tk)
    ((oq * torch.from_numpy(gq)).sum()
     + (ok * torch.from_numpy(gk)).sum()).backward()
    for got, w in zip((tq.grad, tk.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    for x, g, got in ((q, gq, tq.grad), (k, gk, tk.grad)):
        tx = torch.from_numpy(x).requires_grad_()
        (RoPE.apply(tx, cos, sin, interleaved)
         * torch.from_numpy(g)).sum().backward()
        assert torch.equal(tx.grad, got)


def test_fused_rope_rotates_q_k_and_v_as_jax():
    """q and k go through one `RoPE` call and v through its own; all
    three equal the JAX functional's, with per-row position ids."""
    rs = np.random.RandomState(12)
    b, s, hq, hkv, d = 2, 6, 4, 2, 16
    q = rs.randn(b, s, hq, d).astype(np.float32)
    k, v = (rs.randn(b, s, hkv, d).astype(np.float32) for _ in range(2))
    ids = np.clip(np.arange(s)[None] - np.asarray([[0], [2]]), 0,
                  None).astype(np.int32)
    want = P.nn.functional.fused_rotary_position_embedding(
        *(P.to_tensor(a) for a in (q, k, v)), position_ids=ids)
    got = TF.fused_rotary_position_embedding(
        *(torch.from_numpy(a) for a in (q, k, v)),
        position_ids=torch.from_numpy(ids))
    for a, r in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(r._value),
                                   atol=1e-5, rtol=1e-5)


def test_rope_adjoint_is_the_transpose():
    """<rope(x), g> == <x, rope_adjoint(g)> for neox phases (both halves
    of sin equal) and, in the interleaved style, for any phases (to the
    f32 rounding of the plain version's arithmetic)."""
    rs = np.random.RandomState(6)
    x, g = (torch.from_numpy(rs.randn(2, 3, 4, 8)) for _ in range(2))
    cos, sin = (torch.from_numpy(a).double()
                for a in _neox_phases(rs, 2, 3, 8))
    for inter, (c, s_) in ((False, (cos, sin)),
                           (True, (torch.randn(2, 3, 1, 8).double(),
                                   torch.randn(2, 3, 1, 8).double()))):
        lhs = (rope_reference(x, c, s_, interleaved=inter) * g).sum()
        rhs = (x * rope_reference(g, c, s_, adjoint=True,
                                  interleaved=inter)).sum()
        assert abs(lhs - rhs).item() < 1e-5


def _j_fused_rope(q, k, **kw):
    out = P.nn.functional.fused_rotary_position_embedding(
        P.to_tensor(q), P.to_tensor(k), None, **kw)
    return [np.asarray(t._value) for t in out[:2]]


@pytest.mark.parametrize("mode", ["plain", "position_ids", "interleaved",
                                  "explicit_phases", "base"])
def test_fused_rotary_position_embedding_matches_jax(mode):
    rs = np.random.RandomState(7)
    b, s, hq, hkv, d = 2, 6, 4, 2, 16
    q = rs.randn(b, s, hq, d).astype(np.float32)
    k = rs.randn(b, s, hkv, d).astype(np.float32)
    kw = {}
    if mode in ("position_ids", "explicit_phases"):
        # left-pad shift: row 1 starts 3 tokens in (pads clip to 0)
        kw["position_ids"] = np.clip(np.arange(s)[None] - np.asarray(
            [[0], [3]]), 0, None).astype(np.int32)
    if mode == "explicit_phases":
        ang = rs.rand(16, d).astype(np.float32) * 6.0
        kw["cos"], kw["sin"] = np.cos(ang), np.sin(ang)
    if mode == "interleaved":
        kw["use_neox_rotary_style"] = False
    if mode == "base":
        kw["rotary_emb_base"] = 500000.0
    want = _j_fused_rope(q, k, **kw)
    tkw = {n: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for n, v in kw.items()}
    got = TF.fused_rotary_position_embedding(
        torch.from_numpy(q), torch.from_numpy(k), None, **tkw)
    assert got[2] is None
    for a, r in zip(got[:2], want):
        np.testing.assert_allclose(a.numpy(), r, atol=1e-5, rtol=1e-5)


def test_apply_rotary_pos_emb_matches_jax():
    from paddle_tpu.nn.functional.attention import (
        apply_rotary_pos_emb as j_apply,
    )

    rs = np.random.RandomState(10)
    q = rs.randn(2, 5, 4, 8).astype(np.float32)
    k = rs.randn(2, 5, 2, 8).astype(np.float32)
    ang = rs.rand(9, 8).astype(np.float32) * 6.0
    cos, sin = np.cos(ang), np.sin(ang)
    pos = rs.randint(0, 9, (2, 5)).astype(np.int32)
    want = j_apply(*(P.to_tensor(a) for a in (q, k, cos, sin)),
                   position_ids=pos)
    got = TF.apply_rotary_pos_emb(*(torch.from_numpy(a)
                                    for a in (q, k, cos, sin)),
                                  position_ids=torch.from_numpy(pos))
    for a, r in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(r._value),
                                   atol=1e-5, rtol=1e-5)


def test_interleaved_rope_grad_matches_jax_grad():
    """The interleaved style (a jnp path in the JAX package): the port's
    kernel adjoint is the exact VJP that ``jax.grad`` gives there."""
    rs = np.random.RandomState(8)
    q = rs.randn(2, 5, 3, 8).astype(np.float32)
    g = rs.randn(2, 5, 3, 8).astype(np.float32)

    def jloss(q_):
        out = P.nn.functional.fused_rotary_position_embedding(
            P.Tensor(q_), use_neox_rotary_style=False)[0]
        return (out._value * g).sum()

    want = jax.grad(jloss)(jnp.asarray(q))
    tq = torch.from_numpy(q).requires_grad_()
    out = TF.fused_rotary_position_embedding(tq,
                                             use_neox_rotary_style=False)[0]
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_fused_rope_refuses_time_major():
    q = torch.zeros(1, 2, 1, 4)
    with pytest.raises(NotImplementedError, match="time_major"):
        TF.fused_rotary_position_embedding(q, time_major=True)


def test_rope_bf16_plain_rounds_once():
    """bf16: the plain version computes in f32 and rounds once, as the
    kernel does; the JAX package's CPU path computes in bf16 throughout,
    so the two differ by bf16 rounding only (stated tolerance 2e-2 on
    O(1) values)."""
    rs = np.random.RandomState(9)
    x = torch.from_numpy(rs.randn(1, 4, 2, 16).astype(np.float32))
    cos, sin = (torch.from_numpy(a) for a in _neox_phases(rs, 1, 4, 16))
    xb, cb, sb = (t.to(torch.bfloat16) for t in (x, cos, sin))
    got = rope_reference(xb, cb, sb)
    assert got.dtype == torch.bfloat16
    exact = rope_reference(xb.float(), cb.float(), sb.float())
    torch.testing.assert_close(got, exact.to(torch.bfloat16), atol=0, rtol=0)
    jx = P.nn.functional.fused_rotary_position_embedding(
        P.to_tensor(xb.float().numpy()).astype("bfloat16"))[0]
    jb = torch.from_numpy(np.array(jx._value.astype(jnp.float32)))
    ours = TF.fused_rotary_position_embedding(xb)[0].float()
    assert (ours - jb).abs().max().item() <= 2e-2
