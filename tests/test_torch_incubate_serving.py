"""The port's incubate serving functionals against the JAX package's, on
the CPU.

The same seeded numpy inputs go through both packages (B 2-3, H 2-4,
D 8-64, S 6-128): `fused_bias_act`, `swiglu`,
`masked_multihead_attention` (the `decode_attention` route, whose plain
version runs here, and the einsum route), `block_multihead_attention`,
`variable_length_memory_efficient_attention` (`FlashAttention`'s plain
versions here), `fused_ec_moe` / `FusedEcMoe` and the `softmax_mask_fuse`
pair.  f32 within 1e-5, bf16 within 2e-2, each of the largest reference
value; gradients against ``jax.grad`` in f32 within 1e-5 of the largest.
The JAX function's own refusals raise the same error types in the port.

Off the TPU the JAX `masked_multihead_attention` takes its einsum path
(its Pallas kernel is gated off in interpret mode), so the port's kernel
route is held both to that path and to the JAX `decode_attention` kernel
run in interpret mode.  Nothing here launches a kernel.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import incubate as JI
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.incubate import nn as jinn
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.ops.pallas.decode_attention import (
    decode_attention as j_decode_attention,
)
from paddle_tpu_torch import amp
from paddle_tpu_torch import incubate as TI
from paddle_tpu_torch.incubate import nn as tinn
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.nn.functional import attention as TA
from paddle_tpu_torch.ops import kernels as K

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # of the largest reference
DTYPES = sorted(TOL)


@pytest.fixture(autouse=True)
def _no_launches():
    K.reset_launches()
    yield
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def _grid(a, dtype):
    """Seeded values on `dtype`'s grid, as f32 numpy (so both packages
    start from the same numbers)."""
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(getattr(torch, dtype)).float().numpy()


def _t(a, dtype="float32"):
    return torch.from_numpy(np.array(a)).to(getattr(torch, dtype)) \
        if np.asarray(a).dtype.kind == "f" else torch.from_numpy(np.array(a))


def _j(a, dtype="float32"):
    a = np.asarray(a)
    return Tensor(jnp.asarray(a, getattr(jnp, dtype)) if a.dtype.kind == "f"
                  else jnp.asarray(a))


def _np(x):
    """f32 numpy of a port tensor or a JAX Tensor / array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(getattr(x, "_value", x), jnp.float32))


def _held(got, want, dtype, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    limit = TOL[dtype] * max(np.abs(want).max(), 1e-30)
    assert err <= limit, f"{what}: {err} > {TOL[dtype]} of the largest"


# ------------------------------------------------- activations, softmax
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["gelu", "relu", "silu", "swiglu"])
def test_fused_bias_act_matches_jax(act, dtype):
    rs = np.random.RandomState(0)
    x, b = _grid(rs.randn(3, 5, 64), dtype), _grid(rs.randn(64), dtype)
    want = JIF.fused_bias_act(_j(x, dtype), _j(b, dtype), act_method=act)
    got = TIF.fused_bias_act(_t(x, dtype), _t(b, dtype), act_method=act,
                             ignored_option=1)
    _held(got, want, dtype, act)
    _held(TIF.fused_bias_act(_t(x, dtype), act_method=act),
          JIF.fused_bias_act(_j(x, dtype), act_method=act), dtype, act)


def test_fused_bias_act_gelu_is_the_tanh_form_and_unknown_raises():
    x = torch.linspace(-3, 3, 64)
    got = TIF.fused_bias_act(x)
    assert torch.equal(got, torch.nn.functional.gelu(x, approximate="tanh"))
    assert (got - torch.nn.functional.gelu(x)).abs().max() > 1e-4
    with pytest.raises(KeyError):
        JIF.fused_bias_act(_j(x.numpy()), act_method="tanh")
    with pytest.raises(KeyError):
        TIF.fused_bias_act(x, act_method="tanh")


@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu_matches_jax(dtype):
    rs = np.random.RandomState(1)
    x, y = _grid(rs.randn(2, 6, 32), dtype), _grid(rs.randn(2, 6, 32), dtype)
    _held(TIF.swiglu(_t(x, dtype)), JIF.swiglu(_j(x, dtype)), dtype)
    _held(TIF.swiglu(_t(x, dtype), _t(y, dtype)),
          JIF.swiglu(_j(x, dtype), _j(y, dtype)), dtype)


def test_fused_rotary_position_embedding_is_the_ported_one():
    assert TIF.fused_rotary_position_embedding \
        is TA.fused_rotary_position_embedding
    assert "fused_rotary_position_embedding" in TIF.__all__


@pytest.mark.parametrize("dtype", DTYPES)
def test_softmax_mask_fuse_pair_matches_jax(dtype):
    rs = np.random.RandomState(2)
    x = _grid(rs.randn(2, 3, 16, 16) * 3, dtype)
    mask = np.where(rs.rand(2, 1, 16, 16) > 0.3, 0.0, -1e4).astype(
        np.float32)
    got = TI.softmax_mask_fuse(_t(x, dtype), _t(mask))
    assert got.dtype == getattr(torch, dtype)
    _held(got, JI.softmax_mask_fuse(_j(x, dtype), _j(mask)), dtype)
    got = TI.softmax_mask_fuse_upper_triangle(_t(x, dtype))
    _held(got, JI.softmax_mask_fuse_upper_triangle(_j(x, dtype)), dtype)
    assert float(got.float()[..., 0, 1:].abs().max()) == 0.0


# ------------------------------------------- masked_multihead_attention
def _mmha_inputs(rs, b, h, d, s, dtype, filled=20):
    cache = np.zeros((2, b, h, s, d), np.float32)
    cache[:, :, :, :filled] = rs.randn(2, b, h, filled, d)
    return _grid(cache, dtype), _grid(rs.randn(b, 3 * h * d), dtype)


def test_masked_mha_decode_loop():
    """JAX's `test_masked_multihead_attention_decode_loop` on the port,
    at S 6 (the einsum route) and S 8 (the kernel route)."""
    B, H, D = 2, 2, 8
    for S in (6, 8):
        rng = np.random.RandomState(0)
        cache = torch.zeros(2, B, H, S, D)
        toks = rng.rand(S, B, 3 * H * D).astype(np.float32)
        outs = []
        for t in range(4):
            out, cache2 = TIF.masked_multihead_attention(
                torch.from_numpy(toks[t]), cache_kv=cache,
                sequence_lengths=torch.full((B,), t, dtype=torch.int32))
            assert cache2 is cache
            outs.append(out.numpy())
        qkv = toks[:4].reshape(4, B, 3, H, D)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        for t in range(4):
            ref = np.zeros((B, H, D), np.float32)
            for b in range(B):
                for h in range(H):
                    sc = np.array([q[t, b, h] @ k[j, b, h]
                                   for j in range(t + 1)]) / np.sqrt(D)
                    p = np.exp(sc - sc.max())
                    p /= p.sum()
                    ref[b, h] = sum(p[j] * v[j, b, h] for j in range(t + 1))
            np.testing.assert_allclose(outs[t], ref.reshape(B, H * D),
                                       rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", ["kernel", "einsum"])
def test_masked_mha_matches_jax_over_a_decode_loop(route, dtype):
    """Four steps from mixed start lengths: each step's output and the
    cache against JAX's (whose CPU run takes its einsum path); the
    einsum route is forced by a mask (zeros and a -1e4 column)."""
    B, H, D, S = 3, 4, 32, 32
    rs = np.random.RandomState(3)
    cache, _ = _mmha_inputs(rs, B, H, D, S, dtype)
    mask = None
    if route == "einsum":
        mask = np.zeros((B, 1, 1, S), np.float32)
        mask[:, :, :, 2] = -1e4
    calls = []
    real = TIF.decode_attention

    def spy(*a):
        calls.append(a[0].shape)
        return real(*a)

    jc, tc = _j(cache, dtype), _t(cache, dtype)
    pos0 = np.array([5, 19, 0], np.int32)
    try:
        TIF.decode_attention = spy
        for step in range(4):
            x = _grid(rs.randn(B, 3 * H * D), dtype)
            pos = pos0 + step
            jo, jc = JIF.masked_multihead_attention(
                _j(x, dtype), cache_kv=jc,
                src_mask=None if mask is None else _j(mask),
                sequence_lengths=_j(pos))
            to, tc2 = TIF.masked_multihead_attention(
                _t(x, dtype), cache_kv=tc,
                src_mask=None if mask is None else _t(mask),
                sequence_lengths=_t(pos))
            assert tc2 is tc and to.dtype == tc.dtype
            _held(to, jo, dtype, f"step {step}")
            # the write is a copy: bit for bit
            assert np.array_equal(_np(tc), _np(jc))
    finally:
        TIF.decode_attention = real
    assert len(calls) == (4 if route == "kernel" else 0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_mha_kernel_route_matches_the_pallas_kernel(dtype):
    """The port's kernel route (the plain `decode_attention` here) against
    JAX's `decode_attention(..., interpret=True)` on the cache JAX's own
    step writes."""
    B, H, D, S = 2, 4, 64, 128
    rs = np.random.RandomState(4)
    cache, x = _mmha_inputs(rs, B, H, D, S, dtype, filled=100)
    pos = np.array([99, 37], np.int32)
    to, tc = TIF.masked_multihead_attention(
        _t(x, dtype), cache_kv=_t(cache, dtype), sequence_lengths=_t(pos))
    q = jnp.asarray(x, getattr(jnp, dtype)).reshape(B, 3, H, D)[:, 0]
    kc = jnp.asarray(_np(tc[0]), getattr(jnp, dtype))
    vc = jnp.asarray(_np(tc[1]), getattr(jnp, dtype))
    want = j_decode_attention(q, kc, vc, jnp.asarray(pos), interpret=True)
    _held(to, np.asarray(jnp.asarray(want, jnp.float32)).reshape(B, H * D),
          dtype)


def test_masked_mha_refusals_match_jax():
    x, cache = np.zeros((1, 24), np.float32), np.zeros((2, 1, 2, 8, 4),
                                                       np.float32)
    seq = np.zeros((1,), np.int32)
    for pkg, arr in ((JIF, _j), (TIF, _t)):
        with pytest.raises(ValueError, match="cache_kv"):
            pkg.masked_multihead_attention(arr(x), sequence_lengths=arr(seq))
        with pytest.raises(ValueError, match="sequence_lengths"):
            pkg.masked_multihead_attention(arr(x), cache_kv=arr(cache))
        for kw in (dict(rotary_embs=arr(x)), dict(beam_cache_offset=arr(seq)),
                   dict(qkv_out_scale=arr(x)), dict(out_shift=arr(x)),
                   dict(out_smooth=arr(x)), dict(rotary_emb_dims=1)):
            with pytest.raises(NotImplementedError, match=next(iter(kw))):
                pkg.masked_multihead_attention(
                    arr(x), cache_kv=arr(cache), sequence_lengths=arr(seq),
                    **kw)


def test_masked_mha_kernel_shapes_are_jax_s():
    assert TIF.decode_kernel_takes((2, 8, 32, 2048, 128))
    for shape in ((2, 1, 2, 6, 8), (2, 1, 2, 8, 12), (2, 1, 2, 8, 264)):
        assert not TIF.decode_kernel_takes(shape)


# -------------------------------------------- block_multihead_attention
def _block_case(dtype, rs):
    """JAX's block test: block size 4, a 6-block pool, sequences of 5
    and 2 cached tokens, and the dense copy of the same keys."""
    B, H, D, BS, NBLK = 2, 2, 8, 4, 6
    lens = np.array([5, 2], np.int32)
    kc = np.zeros((NBLK, H, BS, D), np.float32)
    vc = np.zeros((NBLK, H, BS, D), np.float32)
    bt = np.array([[0, 2, 4], [1, 3, 5]], np.int32)
    dense = np.zeros((2, B, H, 12, D), np.float32)
    for b in range(B):
        for t in range(lens[b]):
            kv, vv = rs.randn(H, D), rs.randn(H, D)
            phys = bt[b, t // BS]
            kc[phys, :, t % BS], vc[phys, :, t % BS] = kv, vv
            dense[0, b, :, t], dense[1, b, :, t] = kv, vv
    qkv = rs.randn(B, 3 * H * D)
    return (_grid(qkv, dtype), _grid(kc, dtype), _grid(vc, dtype), lens, bt,
            _grid(dense, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_block_mha_matches_jax_and_writes_in_place(dtype):
    qkv, kc, vc, lens, bt, _ = _block_case(dtype, np.random.RandomState(0))
    args = lambda arr: (arr(qkv, dtype), arr(kc, dtype), arr(vc, dtype),
                        arr(lens * 0), arr(lens), arr(lens * 0 + 1))
    jo, jk, jv = JIF.block_multihead_attention(
        *args(_j), block_tables=_j(bt), block_size=4)
    targs = args(_t)
    to, tk, tv = TIF.block_multihead_attention(
        *targs, block_tables=_t(bt), block_size=4)
    assert tk is targs[1] and tv is targs[2]
    _held(to, jo, dtype)
    assert np.array_equal(_np(tk), _np(jk)) and \
        np.array_equal(_np(tv), _np(jv))
    kn = _np(targs[0]).reshape(2, 3, 2, 8)[0, 1]
    assert np.array_equal(_np(tk)[bt[0, 1], :, 1], kn)   # pos 5: blk 1 slot 1


def test_block_mha_equals_masked_mha_over_the_same_cache():
    """JAX's `test_block_multihead_attention_decode_matches_dense` through
    the port: the block cache's output equals the dense cache's
    (`masked_multihead_attention`, both routes), f32."""
    qkv, kc, vc, lens, bt, dense = _block_case("float32",
                                               np.random.RandomState(0))
    out, _, _ = TIF.block_multihead_attention(
        _t(qkv), _t(kc), _t(vc), _t(lens * 0), _t(lens), _t(lens * 0 + 1),
        block_tables=_t(bt), block_size=4)
    for mask in (None, torch.zeros(2, 1, 1, 12)):
        want, _ = TIF.masked_multihead_attention(
            _t(qkv), cache_kv=_t(dense), src_mask=mask,
            sequence_lengths=_t(lens))
        _held(out, want, "float32")


def test_block_mha_refusals_match_jax():
    qkv, kc, vc, lens, bt, _ = _block_case("float32",
                                           np.random.RandomState(0))
    for pkg, arr in ((JIF, _j), (TIF, _t)):
        base = (arr(qkv), arr(kc), arr(vc))
        for kw in (dict(cache_k_quant_scales=arr(qkv)),
                   dict(qkv_out_scale=arr(qkv)), dict(out_smooth=arr(qkv))):
            with pytest.raises(NotImplementedError, match="scales"):
                pkg.block_multihead_attention(
                    *base, arr(lens * 0), arr(lens), arr(lens * 0 + 1),
                    block_tables=arr(bt), block_size=4, **kw)
        for kw in (dict(rope_emb=arr(qkv)), dict(tgt_mask=arr(qkv)),
                   dict(pre_key_cache=arr(kc))):
            with pytest.raises(NotImplementedError, match="rope_emb"):
                pkg.block_multihead_attention(
                    *base, arr(lens * 0), arr(lens), arr(lens * 0 + 1),
                    block_tables=arr(bt), block_size=4, **kw)
        with pytest.raises(NotImplementedError, match="prefill"):
            pkg.block_multihead_attention(
                *base, arr(lens), arr(lens * 0), arr(lens),
                block_tables=arr(bt), block_size=4)


# ------------------------- variable_length_memory_efficient_attention
def test_varlen_mem_eff_lengths():
    """JAX's `test_variable_length_memory_efficient_attention_lengths` on
    the port: row 0 truncated to 3 keys equals dense attention on the
    3-key prefix, row 1 full; the explicit scale honoured."""
    rs = np.random.RandomState(0)
    B, H, S, D = 2, 2, 8, 16
    q, k, v = (rs.randn(B, H, S, D).astype(np.float32) for _ in range(3))
    kv_lens = torch.tensor([3, 8], dtype=torch.int32)
    scale = 0.31
    o = TIF.variable_length_memory_efficient_attention(
        _t(q), _t(k), _t(v), seq_lens=kv_lens, kv_seq_lens=kv_lens,
        scale=scale).numpy()

    def dense(qr, kr, vr):
        logits = np.einsum("hqd,hkd->hqk", qr, kr) * scale
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        return np.einsum("hqk,hkd->hqd", p, vr)

    np.testing.assert_allclose(o[0], dense(q[0], k[0, :, :3], v[0, :, :3]),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(o[1], dense(q[1], k[1], v[1]), rtol=2e-5,
                               atol=2e-5)


VARLEN = {  # name: (causal, kv lengths, mask kind, scale, sq, sk)
    "lengths": (False, [37, 64], None, None, 64, 64),
    "causal_lengths": (True, [64, 20], None, None, 64, 64),
    "causal_sk_gt_sq": (True, [80, 50], None, None, 32, 80),
    "mask_and_lengths": (False, [64, 41], "f32", 0.17, 64, 64),
    "causal_mask": (True, None, "f32", None, 48, 48),
    "plain": (False, None, None, 0.25, 40, 40),
}


def _varlen_inputs(name, dtype, rs):
    causal, kvl, mask, scale, sq, sk = VARLEN[name]
    B, H, D = 2, 3, 32
    q = _grid(rs.randn(B, H, sq, D), dtype)
    k, v = (_grid(rs.randn(B, H, sk, D), dtype) for _ in range(2))
    m = None
    if mask == "f32":
        m = np.where(rs.rand(B, 1, sq, sk) > 0.2, 0.0, -1e4).astype(
            np.float32)
    kvl = None if kvl is None else np.array(kvl, np.int32)
    return (q, k, v), kvl, m, dict(scale=scale, causal=causal)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(VARLEN))
def test_varlen_mem_eff_matches_jax(name, dtype):
    (q, k, v), kvl, m, kw = _varlen_inputs(name, dtype,
                                           np.random.RandomState(5))
    opt = lambda arr, a: None if a is None else arr(a)
    want = JIF.variable_length_memory_efficient_attention(
        *(_j(a, dtype) for a in (q, k, v)), seq_lens=opt(_j, kvl),
        kv_seq_lens=opt(_j, kvl), mask=opt(_j, m), **kw)
    got = TIF.variable_length_memory_efficient_attention(
        *(_t(a, dtype) for a in (q, k, v)), seq_lens=opt(_t, kvl),
        kv_seq_lens=opt(_t, kvl), mask=opt(_t, m), **kw)
    assert got.dtype == getattr(torch, dtype)
    _held(got, want, dtype, name)


@pytest.mark.parametrize("name", sorted(VARLEN))
def test_varlen_mem_eff_grads_match_jax(name):
    (q, k, v), kvl, m, kw = _varlen_inputs(name, "float32",
                                           np.random.RandomState(6))
    g = np.random.RandomState(7).randn(*q.shape[:3], v.shape[-1]).astype(
        np.float32)
    opt = lambda arr, a: None if a is None else arr(a)

    def loss(q, k, v):
        out = JIF.variable_length_memory_efficient_attention(
            Tensor(q), Tensor(k), Tensor(v), kv_seq_lens=opt(_j, kvl),
            mask=opt(_j, m), **kw)
        return jnp.sum(out._value * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                               for a in (q, k, v)))
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    out = TIF.variable_length_memory_efficient_attention(
        *ts, kv_seq_lens=opt(_t, kvl), mask=opt(_t, m), **kw)
    (out * _t(g)).sum().backward()
    for t, w, what in zip(ts, want, "qkv"):
        _held(t.grad, w, "float32", f"{name} d{what}")


@pytest.mark.parametrize("causal", [False, True])
def test_varlen_mem_eff_zero_length_row_matches_jax(causal):
    """A row with kv_seq_lens[b] == 0: JAX's reference masks every key and
    averages the causally visible value rows; the port's forward gives
    the same (ROADMAP C2.25).  Its backward through that row is Sk times
    JAX's (not causal here): the saved LSE absorbs log Sk at the fill's
    magnitude, so the row's probabilities come back as 1, not 1 / Sk."""
    rs = np.random.RandomState(8)
    B, H, S, D = 2, 2, 16, 16
    q, k, v = (rs.randn(B, H, S, D).astype(np.float32) for _ in range(3))
    kvl = np.array([0, 9], np.int32)
    want = JIF.variable_length_memory_efficient_attention(
        _j(q), _j(k), _j(v), kv_seq_lens=_j(kvl), causal=causal)
    got = TIF.variable_length_memory_efficient_attention(
        _t(q), _t(k), _t(v), kv_seq_lens=_t(kvl), causal=causal)
    _held(got, want, "float32")
    mean = np.cumsum(v[0], axis=1) / np.arange(1, S + 1)[:, None] \
        if causal else np.broadcast_to(v[0].mean(1, keepdims=True),
                                       v[0].shape)
    np.testing.assert_allclose(got[0].numpy(), mean, rtol=1e-5, atol=1e-6)
    if causal:
        return
    g = rs.randn(B, H, S, D).astype(np.float32)

    def loss(vv):
        out = JIF.variable_length_memory_efficient_attention(
            _j(q), _j(k), Tensor(vv), kv_seq_lens=_j(kvl))
        return jnp.sum(out._value * g)

    dv_j = np.asarray(jax.grad(loss)(jnp.asarray(v)))
    tv = _t(v).requires_grad_()
    out = TIF.variable_length_memory_efficient_attention(
        _t(q), _t(k), tv, kv_seq_lens=_t(kvl))
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(tv.grad[0].numpy(), S * dv_j[0], rtol=1e-4,
                               atol=1e-5)
    _held(tv.grad[1], dv_j[1], "float32")


def test_varlen_mem_eff_adds_a_bool_mask_as_jax_does():
    """A bool mask is cast to f32 and added (True 1.0, False 0.0), as JAX
    does (:236): it masks nothing."""
    rs = np.random.RandomState(9)
    q, k, v = (rs.randn(2, 2, 8, 16).astype(np.float32) for _ in range(3))
    keep = rs.rand(2, 1, 8, 8) > 0.5
    want = JIF.variable_length_memory_efficient_attention(
        _j(q), _j(k), _j(v), mask=_j(keep))
    got = TIF.variable_length_memory_efficient_attention(
        _t(q), _t(k), _t(v), mask=torch.from_numpy(keep))
    _held(got, want, "float32")
    added = TIF.variable_length_memory_efficient_attention(
        _t(q), _t(k), _t(v), mask=torch.from_numpy(keep.astype(np.float32)))
    assert torch.equal(got, added)
    masked = TIF.variable_length_memory_efficient_attention(
        _t(q), _t(k), _t(v), mask=torch.from_numpy(
            np.where(keep, 0.0, -1e30).astype(np.float32)))
    assert (got - masked).abs().max() > 1e-2


def test_varlen_mem_eff_runs_flash_attention_below_the_amp_gate():
    """The JAX op is on no AMP list: under auto_cast f32 inputs stay f32.
    The call goes to `FlashAttention` (its plain versions on the CPU)."""
    rs = np.random.RandomState(10)
    q, k, v = (_t(rs.randn(2, 2, 8, 16)) for _ in range(3))
    calls = []
    real = TIF.FlashAttention

    class Spy:
        @staticmethod
        def apply(*a):
            calls.append(a[0].dtype)
            return real.apply(*a)

    try:
        TIF.FlashAttention = Spy
        with amp.auto_cast(dtype="bfloat16"):
            out = TIF.variable_length_memory_efficient_attention(
                q, k, v, kv_seq_lens=torch.tensor([3, 8]))
    finally:
        TIF.FlashAttention = real
    assert out.dtype == torch.float32 and calls == [torch.float32]


def test_varlen_mem_eff_refuses_a_trainable_mask():
    """A trainable mask is no longer refused (ROADMAP C1.2): its gradient
    through the port's plain flash backward (the dBias of the kernel's
    contract) equals ``jax.grad`` of the JAX function with respect to
    the mask, with key lengths and causal, and the other gradients stay
    JAX's."""
    for name in ("mask_and_lengths", "causal_mask"):
        (q, k, v), kvl, m, kw = _varlen_inputs(name, "float32",
                                               np.random.RandomState(9))
        g = np.random.RandomState(10).randn(*q.shape[:3], v.shape[-1]) \
            .astype(np.float32)
        opt = lambda arr, a: None if a is None else arr(a)

        def loss(q, k, v, mask):
            out = JIF.variable_length_memory_efficient_attention(
                Tensor(q), Tensor(k), Tensor(v), kv_seq_lens=opt(_j, kvl),
                mask=Tensor(mask), **kw)
            return jnp.sum(out._value * g)

        want = jax.grad(loss, argnums=(0, 1, 2, 3))(
            *(jnp.asarray(a) for a in (q, k, v, m)))
        ts = [_t(a).requires_grad_() for a in (q, k, v, m)]
        out = TIF.variable_length_memory_efficient_attention(
            *ts[:3], kv_seq_lens=opt(_t, kvl), mask=ts[3], **kw)
        (out * _t(g)).sum().backward()
        assert np.abs(np.asarray(want[3])).max() > 0
        for t, w, what in zip(ts, want, ("q", "k", "v", "mask")):
            _held(t.grad, w, "float32", f"{name} d{what}")


# ------------------------------------------------- fused_ec_moe, FusedEcMoe
def _moe_inputs(rs, e, b, dtype, bias_shape):
    S, H, I = 3, 16, 32
    arrays = [rs.randn(b, S, H), rs.randn(b, S, e), rs.randn(e, H, I) * 0.3,
              rs.randn(*bias_shape(e, I)), rs.randn(e, I, H) * 0.3,
              rs.randn(*bias_shape(e, H))]
    return [_grid(a, dtype) for a in arrays]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("case", ["experts_eq_batch", "per_expert_bias"])
def test_fused_ec_moe_matches_jax(case, act, dtype):
    """The bare bias add of JAX (:406, :408): with E == B a [E, 1, I]
    bias goes to batch b by expert b's index; a [E, 1, 1, I] bias is the
    layer's per-expert add."""
    e, b, shape = (2, 2, lambda e, n: (e, 1, n)) if case == \
        "experts_eq_batch" else (4, 2, lambda e, n: (e, 1, 1, n))
    arrays = _moe_inputs(np.random.RandomState(11), e, b, dtype, shape)
    want = JIF.fused_ec_moe(*(_j(a, dtype) for a in arrays), act_type=act)
    got = TIF.fused_ec_moe(*(_t(a, dtype) for a in arrays), act_type=act)
    _held(got, want, dtype, case)


def test_fused_ec_moe_documented_bias_shape_raises_as_jax():
    """E 4, B 2 with the documented [E, 1, I] bias: JAX raises ValueError
    (incompatible broadcast of (4, 2, 3, 32) and (4, 1, 32)); so does the
    port (ROADMAP C2.24)."""
    arrays = _moe_inputs(np.random.RandomState(12), 4, 2, "float32",
                         lambda e, n: (e, 1, n))
    with pytest.raises(ValueError, match="Incompatible shapes"):
        JIF.fused_ec_moe(*(_j(a) for a in arrays))
    with pytest.raises(ValueError, match="Incompatible shapes"):
        TIF.fused_ec_moe(*(_t(a) for a in arrays))


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_fused_ec_moe_layer_matches_jax(act):
    """`FusedEcMoe` over JAX weights carried by `load_reference_state`:
    output and every gradient within 1e-5; equal to the functional with
    [E, 1, 1, *] biases."""
    P.seed(0)
    jm = jinn.FusedEcMoe(16, 32, num_experts=4, act_type=act)
    params, buffers = jm.functional_state()
    rs = np.random.RandomState(13)
    params = {n: (rs.randn(*np.shape(p)) * 0.3).astype(np.float32)
              for n, p in params.items()}
    tm = tinn.FusedEcMoe(16, 32, num_experts=4, act_type=act, device="cpu")
    assert {n: tuple(p.shape) for n, p in tm.named_parameters()} == \
        {n: p.shape for n, p in params.items()}
    assert tuple(tm.gate.weight.shape) == (16, 4)          # [in, out]
    load_reference_state(tm, params)
    x = rs.randn(2, 5, 16).astype(np.float32)
    g = rs.randn(2, 5, 16).astype(np.float32)

    def loss(p, xv):
        out, _ = jm.functional_call(p, buffers, xv)
        return jnp.sum(out * g)

    out_j, _ = jm.functional_call(params, buffers, x)
    grads = jax.grad(loss, argnums=(0, 1))(params, x)
    tx = _t(x).requires_grad_()
    out = tm(tx)
    _held(out, out_j, "float32")
    (out * _t(g)).sum().backward()
    for n, p in tm.named_parameters():
        _held(p.grad, grads[0][n], "float32", n)
    _held(tx.grad, grads[1], "float32", "x")
    with torch.no_grad():
        f = TIF.fused_ec_moe(tx, tm.gate(tx), tm.e_w1, tm.e_b1[:, None],
                             tm.e_w2, tm.e_b2[:, None], act_type=act)
    assert torch.equal(f, out.detach())


def test_fused_ec_moe_layer_refuses_other_activations():
    with pytest.raises(ValueError, match="act_type"):
        jinn.FusedEcMoe(8, 16, 2, act_type="silu")
    with pytest.raises(ValueError, match="act_type"):
        tinn.FusedEcMoe(8, 16, 2, act_type="silu", device="cpu")
