"""The vision plain versions against the JAX Pallas kernels in bf16, on
the CPU.

On the card the bf16 dense convs of ``csrc/conv_bn_act.cu``, the bf16
window forward of ``csrc/window_attention.cu`` and the bf16 window
backward of ``csrc/window_attention_bwd.cu`` run on the tensor cores: bf16 operands and f32 accumulators; the window backward also
rounds P and dS to bf16 before its products, where the JAX kernel
(``paddle_tpu/ops/pallas/window_attention.py`` `_bwd_kernel`) keeps them
in f32.  ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold those
kernels against the port's plain versions within 2e-2.  This file pins
the other side of that contract on this host: the same seeded numpy
inputs, on the bf16 grid, go through

  * `conv_bn_act` (the plain version on a bf16 CPU tensor), the JAX
    `conv_bn_act_ref` and `_conv_pallas` (interpret mode) on the same
    bf16 inputs, at small ResNet-like shapes (1x1 and 3x3 at stride 1
    and 2, a 7x7/s2 stem with 3 input channels) and a MobileNetV2-like
    depthwise one: within 2e-2 of the largest reference value;
  * `window_attention_bwd` (plain) against `_bwd_pallas` (interpret
    mode) and ``jax.grad`` of `window_attention_ref`, at Swin-like
    shapes (7x7 windows, head_dim 32, shifted with the mask and not):
    dqkv and dbias each within 2e-2 of its largest reference value;
  * `window_attention` (plain) against `_fwd_pallas` (interpret mode)
    and `window_attention_ref` at the same shapes (the card's bf16
    forward rounds P to bf16 too): within 2e-2 of the largest reference
    value.

Nothing here launches a kernel.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import conv_norm as JCN
from paddle_tpu.ops.pallas import window_attention as JWA
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import conv_norm as CN
from paddle_tpu_torch.ops.kernels import window_attention as WA
from paddle_tpu_torch.vision.models import swin as TSW

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)

BF16_REL = 2e-2     # of the largest reference value: bf16 keeps 8 bits


@pytest.fixture(autouse=True)
def _no_launches():
    K.reset_launches()
    yield
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def _bf16(rs, *shape, scale=1.0):
    """Seeded normal values already on the bf16 grid (as f32 numpy), so
    both packages start from the same bf16 numbers."""
    x = torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


def _rel(got, want):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return np.abs(got - want).max() / np.abs(want).max()


def _np(t):
    return t.float().numpy()


# ------------------------------------------------------------ conv_bn_act
CONV_CASES = {
    # (B, Cin, H, W, Cout, k, stride, pad, depthwise)
    "1x1s1": (2, 16, 8, 8, 32, 1, 1, 0, False),
    "1x1s1_odd_map": (2, 16, 7, 7, 24, 1, 1, 0, False),
    "1x1s2_downsample": (2, 16, 8, 8, 32, 1, 2, 0, False),
    "3x3s1": (2, 16, 10, 10, 16, 3, 1, 1, False),
    "3x3s2": (2, 16, 11, 11, 24, 3, 2, 1, False),
    "stem7x7s2": (2, 3, 16, 16, 8, 7, 2, 3, False),
    "depthwise3x3": (2, 12, 9, 9, 12, 3, 1, 1, True),
}


@pytest.mark.parametrize("act", ["relu", None])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_bn_act_plain_matches_jax_in_bf16(case, act):
    b, ci, h, w, co, k, s, p, dw = CONV_CASES[case]
    rs = np.random.RandomState(20 + sorted(CONV_CASES).index(case))
    x = _bf16(rs, b, ci, h, w)
    wt = _bf16(rs, co, 1 if dw else ci, k, k,
               scale=1 / np.sqrt((1 if dw else ci) * k * k))
    sc = (rs.rand(co) * 0.5 + 0.5).astype(np.float32)
    sh = (rs.randn(co) * 0.1).astype(np.float32)
    jx, jw = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (x, wt))
    jsc, jsh = jnp.asarray(sc), jnp.asarray(sh)
    ref = JCN.conv_bn_act_ref(jx, jw, jsc, jsh, stride=s, padding=p,
                              act=act, depthwise=dw)
    h_out = (h + 2 * p - k) // s + 1
    pallas = JCN._conv_pallas(jx, jw, jsc, jsh, (s, s), (p, p), act, dw,
                              h_out)
    tx, tw = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, wt))
    got = CN.conv_bn_act(tx, tw, torch.from_numpy(sc),
                         torch.from_numpy(sh), s, p, act)
    assert got.dtype == torch.bfloat16
    for want in (ref, pallas):
        assert want.dtype == jnp.bfloat16
        assert _rel(_np(got), want) <= BF16_REL


# ------------------------------------------------------ window backward
WIN_CASES = {
    # (B, H, W, C, heads, ws, shift): Swin's 7x7 windows, head_dim 32
    "unshifted": (2, 14, 14, 64, 2, 7, 0),
    "shifted_masked": (2, 14, 14, 64, 2, 7, 3),
    "one_window": (2, 7, 7, 96, 3, 7, 0),
}


@pytest.mark.parametrize("case", sorted(WIN_CASES))
def test_window_bwd_plain_matches_jax_in_bf16(case):
    b, h, w, c, heads, ws, shift = WIN_CASES[case]
    rs = np.random.RandomState(30 + sorted(WIN_CASES).index(case))
    qkv = _bf16(rs, b, h, w, 3 * c)
    bias = rs.randn(heads, ws * ws, ws * ws).astype(np.float32)
    g = _bf16(rs, b, h, w, c)
    mask = TSW._shift_mask((h, w), ws, shift) if shift else None
    jq, jg = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (qkv, g))
    jb = jnp.asarray(bias)
    jmask = None if mask is None else jnp.asarray(mask)
    pallas = JWA._bwd_pallas(jq, jb, jmask, jg, ws, shift, heads)

    def loss(qv, bv):
        out = JWA.window_attention_ref(qv, bv, jmask, window_size=ws,
                                       shift=shift, num_heads=heads)
        return (out.astype(jnp.float32) * jg.astype(jnp.float32)).sum()

    grad = jax.grad(loss, argnums=(0, 1))(jq, jb)
    tq, tg = (torch.from_numpy(a).to(torch.bfloat16) for a in (qkv, g))
    got = WA.window_attention_bwd(
        tq, torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask), tg, ws, shift,
        heads)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    for want in (pallas, grad):
        for a, r in zip(got, want):
            assert _rel(_np(a), r) <= BF16_REL


# ------------------------------------------------------- window forward
@pytest.mark.parametrize("case", sorted(WIN_CASES))
def test_window_fwd_plain_matches_jax_in_bf16(case):
    """The forward's other side of the contract: on the card the bf16
    window forward rounds P to bf16 before P V (the JAX `_fwd_kernel`
    keeps it f32); the plain version it is held to there agrees here with
    `_fwd_pallas` (interpret mode) and `window_attention_ref` on the same
    bf16 inputs, within 2e-2 of the largest reference value."""
    b, h, w, c, heads, ws, shift = WIN_CASES[case]
    rs = np.random.RandomState(40 + sorted(WIN_CASES).index(case))
    qkv = _bf16(rs, b, h, w, 3 * c)
    bias = rs.randn(heads, ws * ws, ws * ws).astype(np.float32)
    mask = TSW._shift_mask((h, w), ws, shift) if shift else None
    jq, jb = jnp.asarray(qkv, dtype=jnp.bfloat16), jnp.asarray(bias)
    jmask = None if mask is None else jnp.asarray(mask)
    pallas = JWA._fwd_pallas(jq, jb, jmask, ws, shift, heads, h // ws)
    ref = JWA.window_attention_ref(jq, jb, jmask, window_size=ws,
                                   shift=shift, num_heads=heads)
    got = WA.window_attention(
        torch.from_numpy(qkv).to(torch.bfloat16), torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask), ws, shift, heads)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, w, c)
    for want in (pallas, ref):
        assert want.dtype == jnp.bfloat16
        assert _rel(_np(got), want) <= BF16_REL
