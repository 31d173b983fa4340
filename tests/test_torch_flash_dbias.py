"""The flash backward's dBias mode (ROADMAP C1.2) on the CPU: a trainable
attention mask's gradient through the port against ``jax.grad`` of the
JAX package's attention with respect to the mask, f32, within 1e-4 of
the largest reference gradient.

`FlashAttention` with a mask that requires grad runs `flash_bwd(...,
bias_grad=True)`; on the CPU that is its plain version,
`flash_bwd_reference`, which shares the kernel's contract (dBias =
p (dP - delta) after the scale, summed over the mask's broadcast axes,
in its shape and dtype).  The oracle is JAX's `scaled_dot_product_
attention`, which sends a trainable mask to its reference path, and
`variable_length_memory_efficient_attention` (its `_ref_attention`).
Mask shapes [B, H, Sq, Sk], [B, 1, 1, Sk], [1, H, Sq, Sk] and [Sq, Sk];
causal and full; GQA (the mask's head axis is the query heads'); -inf
entries (``generate_square_subsequent_mask``'s) give dBias 0.  The port's
`scaled_dot_product_attention` on the CPU (`_sdpa_ref`) gives the same.
The kernel itself is held to this plain version on the card
(``tests/test_torch_cuda.py -k dbias`` and chip_smoke's phase 3).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.incubate.nn import functional as JIF

import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels.flash_attention import (
    FlashAttention, flash_bwd, flash_bwd_reference, flash_fwd,
)

torch.set_num_threads(1)

TOL = 1e-4
B, SQ, SK, D = 2, 12, 20, 16


@pytest.fixture(autouse=True)
def _no_launches():
    K.reset_launches()
    yield
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def _inputs(hq, hkv, mask_shape, seed, neg_inf=False):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, SQ, hq, D).astype(np.float32)
    k, v = (rs.randn(B, SK, hkv, D).astype(np.float32) for _ in range(2))
    mask = rs.randn(*mask_shape).astype(np.float32)
    if neg_inf:
        mask[..., 5] = -np.inf
    g = rs.randn(B, SQ, hq, D).astype(np.float32)
    return q, k, v, mask, g


def _jax_grads(q, k, v, mask, g, causal):
    def loss(q_, k_, v_, m_):
        out = JF.scaled_dot_product_attention(
            Tensor(q_), Tensor(k_), Tensor(v_), attn_mask=Tensor(m_),
            is_causal=causal)
        return jnp.sum(out._value * g)

    return jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (q, k, v, mask)))


def _held(got, want, what):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= TOL * scale, f"{what}: {err} > {TOL} of {scale}"


CASES = {  # name: (hq, hkv, mask shape)
    "full": (4, 4, (B, 4, SQ, SK)),
    "key_pad": (4, 4, (B, 1, 1, SK)),
    "per_head": (4, 4, (1, 4, SQ, SK)),
    "square": (4, 4, (SQ, SK)),
    "gqa_full": (6, 2, (B, 6, SQ, SK)),
    "gqa_key_pad": (6, 3, (B, 1, 1, SK)),
}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mask_gradient_matches_jax_grad(case, causal):
    hq, hkv, shape = CASES[case]
    q, k, v, mask, g = _inputs(hq, hkv, shape, seed=len(case))
    want = _jax_grads(q, k, v, mask, g, causal)
    assert np.abs(np.asarray(want[3])).max() > 0
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, mask)]
    out = FlashAttention.apply(*ts, causal)
    (out * torch.from_numpy(g)).sum().backward()
    for t, w, what in zip(ts, want, ("dq", "dk", "dv", "dmask")):
        _held(t.grad, w, f"{case} {what}")
    # the port's SDPA on the CPU (its plain `_sdpa_ref`) agrees
    m = torch.from_numpy(mask).requires_grad_()
    out = TF.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), attn_mask=m,
        is_causal=causal)
    (out * torch.from_numpy(g)).sum().backward()
    _held(m.grad, want[3], f"{case} sdpa dmask")


def test_neg_inf_entries_get_zero_gradient():
    """A square subsequent mask (-inf above the diagonal) plus a trainable
    bias: dBias is exactly 0 where the mask is -inf, finite elsewhere."""
    q, k, v, mask, g = _inputs(4, 4, (SQ, SK), seed=3, neg_inf=True)
    want = _jax_grads(q, k, v, mask, g, False)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, mask)]
    out = FlashAttention.apply(*ts, False)
    (out * torch.from_numpy(g)).sum().backward()
    d = ts[3].grad
    assert torch.isfinite(d).all() and not d[..., 5].any()
    _held(d, np.nan_to_num(np.asarray(want[3])), "dmask")


def test_flash_bwd_bias_grad_contract():
    """The wrapper's fourth output: dBias in the bias's shape and dtype
    (a bf16 mask gets a bf16 gradient, its f32 sum rounded once); a
    boolean or missing bias refuses `bias_grad`."""
    q, k, v, mask, g = _inputs(4, 2, (B, 1, SQ, SK), seed=4)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    m16 = torch.from_numpy(mask).to(torch.bfloat16)
    out, lse = flash_fwd(tq, tk, tv, bias=m16)
    dq, dk, dv, db = flash_bwd(tq, tk, tv, out, lse, torch.from_numpy(g),
                               bias=m16, bias_grad=True)
    assert db.shape == m16.shape and db.dtype == torch.bfloat16
    ref = flash_bwd_reference(tq, tk, tv, out, lse, torch.from_numpy(g),
                              bias=m16, bias_grad=True)
    assert torch.equal(db, ref[3])
    plain = flash_bwd(tq, tk, tv, out, lse, torch.from_numpy(g), bias=m16)
    assert len(plain) == 3 and all(torch.equal(a, b)
                                   for a, b in zip(plain, (dq, dk, dv)))
    with pytest.raises(ValueError, match="bias_grad"):
        flash_bwd(tq, tk, tv, out, lse, torch.from_numpy(g),
                  bias=m16 > 0, bias_grad=True)
    with pytest.raises(ValueError, match="bias_grad"):
        flash_bwd(tq, tk, tv, out, lse, torch.from_numpy(g), bias_grad=True)


@pytest.mark.parametrize("causal", [False, True])
def test_varlen_mem_eff_mask_gradient_matches_jax(causal):
    """`variable_length_memory_efficient_attention` ([B, H, S, D], key
    lengths and a [B, 1, Sq, Sk] trainable mask) against jax.grad of the
    JAX function."""
    rs = np.random.RandomState(5)
    h = 3
    q = rs.randn(B, h, SQ, D).astype(np.float32)
    k, v = (rs.randn(B, h, SK, D).astype(np.float32) for _ in range(2))
    mask = rs.randn(B, 1, SQ, SK).astype(np.float32)
    kvl = np.array([SK, 9], np.int32)
    g = rs.randn(B, h, SQ, D).astype(np.float32)

    def loss(m_):
        out = JIF.variable_length_memory_efficient_attention(
            *(Tensor(jnp.asarray(a)) for a in (q, k, v)),
            kv_seq_lens=Tensor(jnp.asarray(kvl)), mask=Tensor(m_),
            causal=causal)
        return jnp.sum(out._value * g)

    want = jax.grad(loss)(jnp.asarray(mask))
    m = torch.from_numpy(mask).requires_grad_()
    out = TIF.variable_length_memory_efficient_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        kv_seq_lens=torch.from_numpy(kvl), mask=m, causal=causal)
    (out * torch.from_numpy(g)).sum().backward()
    _held(m.grad, want, "dmask")
