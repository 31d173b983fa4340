"""The flash plain versions against the JAX Pallas kernels in float16,
on the CPU.

The JAX flash kernels take any float dtype (`flash_attention_available`
gates only on the head dim).  On the card the f16 flash kernels
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``, the dense modes: causal,
full and biased) run the bf16 kernels' tensor-core core on f16
operands: f32 accumulators, P and dS rounded to f16 in registers where
the JAX kernels round them to the input dtype (``paddle_tpu/ops/pallas/
flash_attention.py``:209, :459, :572, :578).  ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold those kernels against the port's plain
versions within 1e-2.  Here the same seeded numpy inputs, on the f16
grid, go through

  * `flash_fwd` (the plain version on a CPU tensor) and `_fwd_t` /
    `_fwd_tb` (interpret mode): the output within 1e-2 of the largest
    reference value, the f32 LSE within 1e-4;
  * `flash_bwd` (plain) and ``jax.grad`` through `_flash_core_flat` and
    the biased `_flash_core_b`: each gradient within 1e-2 of its largest
    reference value.

Nothing here launches a kernel.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels.flash_attention import flash_bwd, flash_fwd

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)

F16_REL = 1e-2      # of the largest reference value
LSE_TOL = 1e-4      # f32 scores from the same f16 inputs

SHAPES = [
    (1, 16, 32, 4, 2, 16),      # GQA rep 2, Sk > Sq (bottom-right)
    (2, 24, 24, 6, 2, 32),      # GQA rep 3
]


@pytest.fixture(autouse=True)
def _no_launches():
    K.reset_launches()
    yield
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def _f16(rs, *shape):
    """Seeded normal values already on the f16 grid (as f32 numpy), so
    both packages start from the same f16 numbers."""
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    return x.to(torch.float16).float().numpy()


def _qkvg(rs, b, sq, sk, hq, hkv, d):
    return (_f16(rs, b, sq, hq, d), _f16(rs, b, sk, hkv, d),
            _f16(rs, b, sk, hkv, d), _f16(rs, b, sq, hq, d))


def _t(x):
    return torch.from_numpy(x).to(torch.float16)


def _j(x):
    return jnp.asarray(x, jnp.float16)


def _held(got, want, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    tol = F16_REL * np.abs(want).max()
    assert np.isfinite(got).all() and err <= tol, (what, err, tol)


def _bias(rs, shape, kind, sq, sk):
    """(JAX f32 additive bias, the port's bias) of one kind; boolean
    masks keep the bottom-right diagonal, so no row is fully masked."""
    if kind == "bool":
        mask = rs.rand(*shape) > 0.3
        mask |= np.eye(sq, sk, k=sk - sq, dtype=bool)
        return (np.where(mask, 0.0, JFA.NEG_INF).astype(np.float32),
                torch.from_numpy(mask))
    bias = rs.randn(*shape).astype(np.float32)
    return bias, torch.from_numpy(bias)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d", SHAPES)
def test_flash_fwd_f16_plain_matches_fwd_t(b, sq, sk, hq, hkv, d, causal):
    rs = np.random.RandomState(sq * 13 + d)
    q, k, v, _ = _qkvg(rs, b, sq, sk, hq, hkv, d)
    jo, jl = JFA._fwd_t(*(_j(x.transpose(0, 2, 1, 3)) for x in (q, k, v)),
                        causal, 8, 8)
    to, tl = flash_fwd(_t(q), _t(k), _t(v), causal=causal)
    assert to.dtype == torch.float16 and tl.dtype == torch.float32
    _held(to, np.asarray(jo, np.float32).transpose(0, 2, 1, 3), "out")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[..., 0],
                               atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize("kind", ["additive", "bool"])
@pytest.mark.parametrize("bias_shape", [
    (1, 1, 16, 24),     # broadcast over batch and head
    (2, 3, 16, 24),     # full
])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_f16_plain_matches_fwd_tb(bias_shape, kind, causal):
    b, h, sq, sk, d = 2, 3, 16, 24, 16
    rs = np.random.RandomState(17)
    q, k, v, _ = _qkvg(rs, b, sq, sk, h, h, d)
    jbias, tbias = _bias(rs, bias_shape, kind, sq, sk)
    jo, jl = JFA._fwd_tb(*(_j(x.transpose(0, 2, 1, 3)) for x in (q, k, v)),
                         jnp.asarray(jbias), causal, 8, 8)
    to, tl = flash_fwd(_t(q), _t(k), _t(v), bias=tbias, causal=causal)
    _held(to, np.asarray(jo, np.float32).transpose(0, 2, 1, 3), "out")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[..., 0],
                               atol=LSE_TOL, rtol=0)


def _port_grads(q, k, v, g, bias=None, causal=False):
    tq, tk, tv, tg = (_t(x) for x in (q, k, v, g))
    out, lse = flash_fwd(tq, tk, tv, bias=bias, causal=causal)
    grads = flash_bwd(tq, tk, tv, out, lse, tg, bias=bias, causal=causal)
    assert all(x.dtype == torch.float16 for x in grads)
    return grads


def _jax_grads(core, q, k, v, g):
    def loss(q_, k_, v_):
        return (core(q_, k_, v_).astype(jnp.float32) * g).sum()

    return jax.grad(loss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d", SHAPES)
def test_flash_bwd_f16_plain_matches_flat_core_grad(b, sq, sk, hq, hkv, d,
                                                     causal):
    rs = np.random.RandomState(sq * 7 + d)
    q, k, v, g = _qkvg(rs, b, sq, sk, hq, hkv, d)
    want = _jax_grads(
        lambda q_, k_, v_: JFA._flash_core_flat(q_, k_, v_, causal, 8, 8),
        q, k, v, g)
    for name, got, ref in zip("qkv", _port_grads(q, k, v, g, causal=causal),
                              want):
        _held(got, ref, f"d{name}")


@pytest.mark.parametrize("kind", ["additive", "bool"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_f16_plain_matches_biased_core_grad(kind, causal):
    b, h, sq, sk, d = 2, 3, 16, 24, 16
    rs = np.random.RandomState(19)
    q, k, v, g = _qkvg(rs, b, sq, sk, h, h, d)
    jbias, tbias = _bias(rs, (2, 1, sq, sk), kind, sq, sk)
    want = _jax_grads(
        lambda q_, k_, v_: JFA._flash_core_b(q_, k_, v_, jnp.asarray(jbias),
                                             causal, 8, 8),
        q, k, v, g)
    got = _port_grads(q, k, v, g, bias=tbias, causal=causal)
    for name, a, ref in zip("qkv", got, want):
        _held(a, ref, f"d{name}")
