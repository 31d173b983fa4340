"""Every kernel's plain version in float16 against the JAX kernel in
float16, on the CPU.

The JAX Pallas kernels are dtype-generic: each computes in f32 and
writes its input's dtype (``rope.py``:53, ``decode_attention.py``:79,
``fused_norm.py``:76, ``conv_norm.py``:110, ...).  On the card every
port kernel now has an f16 instantiation that keeps its bf16 rounding
order (f32 statistics, scores and accumulators, one rounding to f16
where bf16 rounds to bf16), held against these plain versions by
``chip_smoke.py`` phase 3 and ``tests/test_torch_cuda.py -k f16``.  Here
the same seeded numpy inputs, already on the f16 grid, go through the
plain version on f16 CPU tensors and the JAX kernel on f16 arrays (in
interpret mode, as the JAX package's own tests run it):

  * rope, forward and adjoint (`_rope_call`);
  * dense decode with and without `start` (`decode_attention`);
  * paged decode over f16 pools, and over int8 pools with f32 scales
    and an f16 query (`paged_attention`);
  * the fused norm, LayerNorm and RMS, w / b in f32 and in f16, z
    returned (`_pallas_norm_fwd`);
  * conv + BN + act, dense, stride 2 and depthwise (`_conv_pallas`);
  * the window forward and backward, shifted with the mask
    (`_fwd_pallas`, `_bwd_pallas`);
  * packed (varlen) attention forward and backward (`varlen_attention`
    and its `jax.vjp`).

Tolerances: an output within 2e-3 of its largest reference value (both
sides compute in f32 and round once to f16: about one f16 ulp at 1.0),
a gradient within 1e-2 of its largest reference gradient.  Where the
rounding order differs:
  * XLA's CPU backend keeps excess precision between the f16 adds of
    the fused norm (C2.4): its oracle is the JAX kernel run on its own
    rounded z, as in ``tests/test_torch_incubate.py`` for bf16;
  * the varlen plain version applies `scale` in f32 where JAX folds it
    into q in q's dtype (one more f16 rounding), and its rows that see
    no key are left out (C2.1; none here);
  * the window backward's JAX kernel rounds its dq / dk / dv once to
    f16 from f32 as the plain version does; on the card the tile rounds
    P and dS to f16 as well (C2.26), which these plain versions do not.

Nothing here launches a kernel.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import quant as JQ
from paddle_tpu.ops.pallas import conv_norm as JCN
from paddle_tpu.ops.pallas import fused_norm as JFN
from paddle_tpu.ops.pallas import rope as JR
from paddle_tpu.ops.pallas import window_attention as JWA
from paddle_tpu.ops.pallas.decode_attention import (
    decode_attention as j_decode_attention,
)
from paddle_tpu.ops.pallas.paged_attention import (
    paged_attention as j_paged_attention,
)
from paddle_tpu.ops.pallas.varlen_attention import varlen_attention
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import conv_norm as CN
from paddle_tpu_torch.ops.kernels import decode_attention as DA
from paddle_tpu_torch.ops.kernels import fused_norm as FN
from paddle_tpu_torch.ops.kernels import paged_attention as PA
from paddle_tpu_torch.ops.kernels import rope as RP
from paddle_tpu_torch.ops.kernels import varlen_attention as VA
from paddle_tpu_torch.ops.kernels import window_attention as WA
from paddle_tpu_torch.vision.models import swin as TSW

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)

OUT_REL = 2e-3      # of the largest reference output
GRAD_REL = 1e-2     # of the largest reference gradient


@pytest.fixture(autouse=True)
def _no_launches():
    K.reset_launches()
    yield
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def _f16(rs, *shape, scale=1.0):
    """Seeded normal values already on the f16 grid (as f32 numpy), so
    both packages start from the same f16 numbers."""
    x = torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32))
    return x.to(torch.float16).float().numpy()


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x)).to(
        torch.float16)


def _j(x):
    return None if x is None else jnp.asarray(x, jnp.float16)


def _held(got, want, rel, what=""):
    """got (a torch tensor) within rel of want's largest |value|; both
    finite, same shape."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all() and np.isfinite(want).all(), what
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err,
                                             np.abs(want).max())


# ------------------------------------------------------------------ rope
@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("b,s,h,d,pb", [(2, 4, 3, 16, 1), (2, 4, 4, 32, 2)])
def test_rope_f16_plain_matches_pallas(b, s, h, d, pb, adjoint):
    """Forward and adjoint against `_rope_call` in interpret mode on f16
    x and phases: both take the f32 formula and round once to f16."""
    rs = np.random.RandomState(b * 10 + d + pb)
    x = _f16(rs, b, s, h, d)
    cos, sin = _f16(rs, pb, s, 1, d), _f16(rs, pb, s, 1, d)
    want = JR._rope_call(_j(x), _j(cos), _j(sin), adjoint, interpret=True)
    assert want.dtype == jnp.float16
    got = RP.rope(_t(x), _t(cos), _t(sin), adjoint=adjoint)
    assert got.dtype == torch.float16
    _held(got, want, OUT_REL, "rope")


# ---------------------------------------------------------------- decode
@pytest.mark.parametrize("with_start", [False, True])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_decode_f16_plain_matches_pallas(hq, hkv, with_start):
    rs = np.random.RandomState(hq + hkv + with_start)
    b, s, d = 3, 40, 16
    q, kc, vc = _f16(rs, b, hq, d), _f16(rs, b, hkv, s, d), \
        _f16(rs, b, hkv, s, d)
    pos = np.asarray([30, 7, 39], np.int32)
    start = np.asarray([4, 0, 17], np.int32) if with_start else None
    want = j_decode_attention(
        _j(q), _j(kc), _j(vc), jnp.asarray(pos), block_k=8, interpret=True,
        start=None if start is None else jnp.asarray(start))
    assert want.dtype == jnp.float16
    got = DA.decode_attention(
        _t(q), _t(kc), _t(vc), torch.from_numpy(pos),
        None if start is None else torch.from_numpy(start))
    assert got.dtype == torch.float16
    _held(got, want, OUT_REL, "decode")


# ----------------------------------------------------------------- paged
_TABLE = np.asarray([[1, 2, 3, 4], [5, 6, 0, 0], [7, 0, 0, 0],
                     [8, 9, 10, 11]], np.int32)
_POS = np.asarray([25, 15, 0, 31], np.int32)


@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4)])
def test_paged_f16_pools_plain_matches_pallas(hq, hkv):
    """f16 pools, ragged rows: a page crossing (25), an exact page end
    (15), one token (0) and the full table (31)."""
    rs = np.random.RandomState(hq * 3 + hkv)
    d, ps, npool = 16, 8, 12
    q = _f16(rs, 4, hq, d)
    kp, vp = _f16(rs, npool, hkv, ps, d), _f16(rs, npool, hkv, ps, d)
    want = j_paged_attention(_j(q), _j(kp), _j(vp), jnp.asarray(_TABLE),
                             jnp.asarray(_POS), interpret=True)
    assert want.dtype == jnp.float16
    got = PA.paged_attention(_t(q), _t(kp), _t(vp),
                             torch.from_numpy(_TABLE),
                             torch.from_numpy(_POS))
    assert got.dtype == torch.float16
    _held(got, want, OUT_REL, "paged f16")


@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4)])
def test_paged_int8_pools_f16_query_plain_matches_pallas(hq, hkv):
    """The int8-KV tier of an f16 model: int8 codes with f32 scales
    (the JAX codec), an f16 query, the output in f16."""
    rs = np.random.RandomState(hq * 7 + hkv)
    d, ps, npool = 16, 8, 12
    q = _f16(rs, 4, hq, d)
    kq, ks = JQ.quantize_vectors(
        jnp.asarray(rs.randn(npool, hkv, ps, d).astype(np.float32)))
    vq, vs = JQ.quantize_vectors(
        jnp.asarray(rs.randn(npool, hkv, ps, d).astype(np.float32)))
    want = j_paged_attention(_j(q), kq, vq, jnp.asarray(_TABLE),
                             jnp.asarray(_POS), interpret=True,
                             k_scales=ks, v_scales=vs)
    assert want.dtype == jnp.float16
    t = torch.from_numpy
    got = PA.paged_attention(_t(q), t(np.array(kq)), t(np.array(vq)),
                             t(_TABLE), t(_POS), k_scales=t(np.array(ks)),
                             v_scales=t(np.array(vs)))
    assert got.dtype == torch.float16
    _held(got, want, OUT_REL, "paged int8")


# ------------------------------------------------------------ fused norm
OPERANDS = {  # (weight, shift, bias, residual)
    "all": (True, True, True, True),
    "affine": (True, True, False, False),
    "residual_only": (True, False, False, True),
}


@pytest.mark.parametrize("wdtype", ["float32", "float16"])
@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("ops", sorted(OPERANDS))
def test_fused_norm_f16_plain_matches_pallas(ops, kind, wdtype):
    """x (and bias, residual) in f16, w / b in f32 or in f16, z returned
    where bias or residual is given (bit for bit: the same rounded
    adds).  y against the JAX kernel run on its own rounded z (XLA's CPU
    backend keeps the unrounded sum otherwise, C2.4)."""
    rs = np.random.RandomState(len(ops) + len(kind) + len(wdtype))
    rows, d = 16, 256
    x = _f16(rs, rows, d, scale=2.0)
    w, b, bias, res = (
        (_f16(rs, rows, d) if i == 3 else _f16(rs, d)) if on else None
        for i, on in enumerate(OPERANDS[ops]))
    jw = jnp.float32 if wdtype == "float32" else jnp.float16
    tw = getattr(torch, wdtype)
    want_z = bias is not None or res is not None
    y_j, z_j = JFN._pallas_norm_fwd(
        _j(x), *(None if a is None else jnp.asarray(a, jw) for a in (w, b)),
        _j(bias), _j(res), 1e-6, kind, want_z, interpret=True)
    if want_z:
        y_j, _ = JFN._pallas_norm_fwd(
            z_j, *(None if a is None else jnp.asarray(a, jw)
                   for a in (w, b)), None, None, 1e-6, kind, False,
            interpret=True)
    assert y_j.dtype == jnp.float16
    y, z = FN.fused_norm(_t(x), *(None if a is None else torch.from_numpy(a)
                                  .to(tw) for a in (w, b)),
                         _t(bias), _t(res), eps=1e-6, kind=kind)
    assert y.dtype == torch.float16 and (z is None) == (not want_z)
    _held(y, y_j, OUT_REL, "fused_norm y")
    if want_z:
        np.testing.assert_array_equal(z.float().numpy(),
                                      np.asarray(z_j, np.float32))


def test_fused_norm_f16_grads_keep_the_dtypes():
    """`FusedNorm`'s backward (plain ops, as `_norm_bwd_math` is jnp) in
    f16: dx, dbias and dres in f16, dw in w's dtype, each within 1e-2 of
    the largest gradient of ``jax.grad`` through `fused_norm_pallas` on
    the same f16 inputs."""
    rs = np.random.RandomState(3)
    rows, d = 8, 128
    x, bias, res = _f16(rs, rows, d), _f16(rs, d), _f16(rs, rows, d)
    w, b = _f16(rs, d), _f16(rs, d)
    gy, gz = _f16(rs, rows, d), _f16(rs, rows, d)

    def loss(*a):
        y, z = JFN.fused_norm_pallas(*a, eps=1e-6, kind="ln")
        return (jnp.sum(y.astype(jnp.float32) * jnp.asarray(gy))
                + jnp.sum(z.astype(jnp.float32) * jnp.asarray(gz)))

    want = jax.grad(loss, argnums=tuple(range(5)))(
        _j(x), _j(w), _j(b), _j(bias), _j(res))
    leaves = [_t(a).requires_grad_() for a in (x, w, b, bias, res)]
    y, z = FN.FusedNorm.apply(*leaves, 1e-6, "ln")
    ((y.float() * torch.from_numpy(gy)).sum()
     + (z.float() * torch.from_numpy(gz)).sum()).backward()
    for leaf, jg, name in zip(leaves, want, ("x", "w", "b", "bias", "res")):
        assert leaf.grad.dtype == torch.float16, name
        _held(leaf.grad, jg, GRAD_REL, name)


# ------------------------------------------------------------ conv_bn_act
CONV_CASES = {
    # (B, Cin, H, W, Cout, k, stride, pad, depthwise)
    "dense3x3": (2, 16, 10, 10, 16, 3, 1, 1, False),
    "dense3x3s2": (2, 16, 11, 11, 24, 3, 2, 1, False),
    "depthwise3x3": (2, 12, 9, 9, 12, 3, 1, 1, True),
}


@pytest.mark.parametrize("act", ["relu", "relu6"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_bn_act_f16_plain_matches_pallas(case, act):
    b, ci, h, w, co, k, s, p, dw = CONV_CASES[case]
    rs = np.random.RandomState(50 + sorted(CONV_CASES).index(case))
    x = _f16(rs, b, ci, h, w)
    wt = _f16(rs, co, 1 if dw else ci, k, k,
              scale=1 / np.sqrt((1 if dw else ci) * k * k))
    sc = (rs.rand(co) * 0.5 + 0.5).astype(np.float32)
    sh = (rs.randn(co) * 0.1).astype(np.float32)
    h_out = (h + 2 * p - k) // s + 1
    want = JCN._conv_pallas(_j(x), _j(wt), jnp.asarray(sc), jnp.asarray(sh),
                            (s, s), (p, p), act, dw, h_out)
    assert want.dtype == jnp.float16
    got = CN.conv_bn_act(_t(x), _t(wt), torch.from_numpy(sc),
                         torch.from_numpy(sh), s, p, act)
    assert got.dtype == torch.float16
    _held(got, want, OUT_REL, case)


# ------------------------------------------------------- window attention
WIN_CASES = {
    # (B, H, W, C, heads, ws, shift): Swin's 7x7 windows, head_dim 32
    "unshifted": (2, 14, 14, 64, 2, 7, 0),
    "shifted_masked": (2, 14, 14, 64, 2, 7, 3),
}


def _win_inputs(case, seed):
    b, h, w, c, heads, ws, shift = WIN_CASES[case]
    rs = np.random.RandomState(seed)
    qkv = _f16(rs, b, h, w, 3 * c)
    bias = rs.randn(heads, ws * ws, ws * ws).astype(np.float32)
    g = _f16(rs, b, h, w, c)
    mask = TSW._shift_mask((h, w), ws, shift) if shift else None
    return qkv, bias, mask, g


@pytest.mark.parametrize("case", sorted(WIN_CASES))
def test_window_fwd_f16_plain_matches_pallas(case):
    b, h, w, c, heads, ws, shift = WIN_CASES[case]
    qkv, bias, mask, _ = _win_inputs(case, 60)
    jmask = None if mask is None else jnp.asarray(mask)
    want = JWA._fwd_pallas(_j(qkv), jnp.asarray(bias), jmask, ws, shift,
                           heads, h // ws)
    assert want.dtype == jnp.float16
    got = WA.window_attention(
        _t(qkv), torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask), ws, shift, heads)
    assert got.dtype == torch.float16
    _held(got, want, OUT_REL, case)


@pytest.mark.parametrize("case", sorted(WIN_CASES))
def test_window_bwd_f16_plain_matches_pallas(case):
    """dqkv (f16) and dbias (f32) of the plain backward against
    `_bwd_pallas` (interpret mode) on the same f16 inputs, each within
    1e-2 of its largest reference gradient."""
    b, h, w, c, heads, ws, shift = WIN_CASES[case]
    qkv, bias, mask, g = _win_inputs(case, 61)
    jmask = None if mask is None else jnp.asarray(mask)
    want = JWA._bwd_pallas(_j(qkv), jnp.asarray(bias), jmask, _j(g), ws,
                           shift, heads)
    got = WA.window_attention_bwd(
        _t(qkv), torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask), _t(g), ws, shift,
        heads)
    assert got[0].dtype == torch.float16 and got[1].dtype == torch.float32
    for a, r, name in zip(got, want, ("dqkv", "dbias")):
        _held(a, r, GRAD_REL, name)


# ---------------------------------------------------------------- varlen
VL_CASES = {
    # (q lengths, k lengths or None for the same packing, H, D)
    "ragged": ([1, 7, 12, 5], None, 2, 16),
    "unequal": ([5, 2, 9], [4, 6, 3], 2, 16),
}


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _vl_inputs(case):
    lq, lk, h, d = VL_CASES[case]
    lk = lk or lq
    rs = np.random.RandomState(len(lq) + sum(lk))
    tq, tk = sum(lq), sum(lk)
    return (_f16(rs, tq, h, d), _f16(rs, tk, h, d), _f16(rs, tk, h, d),
            _f16(rs, tq, h, d), _cu(lq), _cu(lk))


@pytest.mark.parametrize("case,causal", [("ragged", True), ("ragged", False),
                                         ("unequal", False)])
def test_varlen_f16_plain_matches_jax(case, causal):
    """The output within 2e-3 of its largest reference value and dq, dk,
    dv within 1e-2 of their largest reference gradients, against
    `varlen_attention` and its `jax.vjp` on the same f16 inputs."""
    q, k, v, g, cq, ck = _vl_inputs(case)

    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(lambda q, k, v: varlen_attention(
            q, k, v, cq, ck, causal=causal), q, k, v)
        return out, vjp(g)

    out_j, grads_j = run(*(_j(x) for x in (q, k, v, g)))
    assert out_j.dtype == jnp.float16
    tq, tk, tv, tg = (_t(x) for x in (q, k, v, g))
    cu_q, cu_k = torch.from_numpy(cq), torch.from_numpy(ck)
    out, lse = VA.varlen_fwd(tq, tk, tv, cu_q, cu_k, causal=causal)
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    _held(out, out_j, OUT_REL, "varlen out")
    grads = VA.varlen_bwd(tq, tk, tv, out, lse, tg, cu_q, cu_k,
                          causal=causal)
    for a, r, name in zip(grads, grads_j, ("dq", "dk", "dv")):
        assert a.dtype == torch.float16
        _held(a, r, GRAD_REL, name)
