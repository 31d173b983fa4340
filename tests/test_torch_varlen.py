"""The port's packed (varlen) attention against the JAX package's, on the
CPU.

The same seeded numpy inputs go through the JAX `varlen_attention`
(`paddle_tpu/ops/pallas/varlen_attention.py`, its Pallas kernels in
interpret mode off the TPU) and through the port: the plain versions
`varlen_fwd_reference` / `varlen_bwd_reference` and the entry point
`nn.functional.flash_attn_unpadded` (the `VarlenAttention` autograd
function, whose wrappers run the plain versions on a CPU tensor).
Outputs and the gradients of a fixed linear functional of the output
(``jax.grad`` on the JAX side) are compared:

  * f32 within 3e-5 (the JAX package's own varlen tolerance); bf16
    within 2e-2 of the largest reference value (the JAX kernel rounds q
    after folding the scale, and p and ds to bf16 before its dots; the
    port keeps them in f32);
  * packings with one-token sequences, an empty sequence (a repeated
    cu_seqlens entry) and odd totals; causal and not; unequal q / k
    packings; an explicit scale of 0.17;
  * rows that see no key (a q sequence whose k sequence is empty): the
    port writes zeros there, where JAX averages its block's padded value
    rows, so those rows are asserted zero and left out of the comparison,
    and their cotangent is zero so that JAX's padding-dependent rows add
    nothing to its dK / dV;
  * the entry point's refusals: return_softmax, dropout while training,
    causal with unequal packings, and GQA (query heads != kv heads).

Each JAX oracle is jitted once per case.  Nothing here launches a
kernel; the kernels are held against these plain versions on the card
by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.varlen_attention import varlen_attention
from paddle_tpu_torch.nn.functional import flash_attn_unpadded
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import varlen_attention as VA

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)

F32_TOL = 3e-5
BF16_REL = 2e-2

# (q lengths, k lengths or None for the same packing, H, D)
CASES = {
    "ragged": ([1, 7, 0, 12, 5], None, 2, 16),     # total 25, one empty
    "ones": ([1, 1, 3, 1], None, 3, 8),             # total 6
    "unequal": ([5, 2, 9], [4, 6, 3], 2, 16),
    "no_key_rows": ([3, 4, 2], [5, 0, 3], 2, 16),   # rows 3..6 see no key
}


@pytest.fixture(autouse=True)
def _no_launches():
    K.reset_launches()
    yield
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _inputs(case, seed=0):
    lq, lk, h, d = CASES[case]
    lk = lk or lq
    rs = np.random.RandomState(seed)
    tq, tk = sum(lq), sum(lk)
    q = rs.randn(tq, h, d).astype(np.float32)
    k = rs.randn(tk, h, d).astype(np.float32)
    v = rs.randn(tk, h, d).astype(np.float32)
    g = rs.randn(tq, h, d).astype(np.float32)
    # rows whose k sequence is empty see no key
    seg = np.searchsorted(_cu(lq), np.arange(tq), side="right") - 1
    blind = np.array([lk[s] == 0 for s in seg], bool)
    g[blind] = 0.0
    return q, k, v, g, _cu(lq), _cu(lk), blind


@functools.lru_cache(maxsize=None)
def _jax_oracle(case, causal, scale, dtype):
    """(out, (dq, dk, dv)) of the JAX function, as f32 numpy."""
    q, k, v, g, cq, ck, _ = _inputs(case)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16

    @jax.jit
    def run(q, k, v, g):
        def f(q, k, v):
            return varlen_attention(q, k, v, cq, ck, scale=scale,
                                    causal=causal)
        out, vjp = jax.vjp(f, q, k, v)
        return out, vjp(g)

    out, grads = run(*(jnp.asarray(x, jd) for x in (q, k, v, g)))
    return (np.asarray(out, np.float32),
            [np.asarray(x, np.float32) for x in grads])


def _held(got, want, dtype, what):
    got = np.asarray(got, np.float32)
    err = np.abs(got - want).max(initial=0.0)
    tol = F32_TOL if dtype == "float32" else \
        BF16_REL * np.abs(want).max(initial=0.0)
    assert np.isfinite(got).all() and err <= tol, (what, err, tol)


def _t(a, dtype):
    return torch.from_numpy(np.array(a)).to(getattr(torch, dtype))


CASE_IDS = [("ragged", False, None, "float32"),
            ("ragged", True, None, "float32"),
            ("ragged", False, None, "bfloat16"),
            ("ragged", True, None, "bfloat16"),
            ("ones", True, 0.17, "float32"),
            ("unequal", False, 0.17, "float32"),
            ("unequal", False, None, "bfloat16"),
            ("no_key_rows", False, None, "float32")]


@pytest.mark.parametrize("case,causal,scale,dtype", CASE_IDS)
def test_plain_versions_match_jax(case, causal, scale, dtype):
    q, k, v, g, cq, ck, blind = _inputs(case)
    out_j, grads_j = _jax_oracle(case, causal, scale, dtype)
    tq, tk, tv, tg = (_t(x, dtype) for x in (q, k, v, g))
    cu_q, cu_k = torch.from_numpy(cq), torch.from_numpy(ck)
    out, lse = VA.varlen_fwd_reference(tq, tk, tv, cu_q, cu_k, scale,
                                       causal)
    assert out.dtype == tq.dtype and lse.shape == (tq.shape[1], len(q))
    assert torch.isfinite(lse).all()
    assert float(out[torch.from_numpy(blind)].abs().sum()) == 0.0
    _held(out.float()[~blind], out_j[~blind], dtype, "out")
    grads = VA.varlen_bwd_reference(tq, tk, tv, out, lse, tg, cu_q, cu_k,
                                    scale, causal)
    for name, a, b in zip("qkv", grads, grads_j):
        assert a.dtype == tq.dtype
        _held(a.float(), b, dtype, f"d{name}")


@pytest.mark.parametrize("case,causal,scale,dtype", CASE_IDS)
def test_flash_attn_unpadded_matches_jax(case, causal, scale, dtype):
    q, k, v, g, cq, ck, blind = _inputs(case)
    out_j, grads_j = _jax_oracle(case, causal, scale, dtype)
    leaves = [_t(x, dtype).requires_grad_() for x in (q, k, v)]
    lq = CASES[case][0]
    out, softmax = flash_attn_unpadded(
        *leaves, torch.from_numpy(cq), torch.from_numpy(ck), max(lq),
        max(CASES[case][1] or lq), scale, causal=causal)
    assert softmax is None
    assert float(out[torch.from_numpy(blind)].abs().sum()) == 0.0
    _held(out.detach().float()[~blind], out_j[~blind], dtype, "out")
    (out.float() * torch.from_numpy(g)).sum().backward()
    for name, leaf, b in zip("qkv", leaves, grads_j):
        _held(leaf.grad.float(), b, dtype, f"d{name}")


def test_packing_outside_cu_seqlens_matches_jax():
    """Positions before cu[0] and from cu[n] on form segments of their
    own (ids -1 and n), as in JAX: q id i attends k id i."""
    rs = np.random.RandomState(3)
    cq = np.array([2, 5, 7], np.int32)
    ck = np.array([1, 4, 9], np.int32)
    q = rs.randn(9, 2, 8).astype(np.float32)
    k = rs.randn(11, 2, 8).astype(np.float32)
    v = rs.randn(11, 2, 8).astype(np.float32)
    want = np.asarray(varlen_attention(q, k, v, cq, ck))
    got, _ = VA.varlen_fwd_reference(*(torch.from_numpy(x)
                                       for x in (q, k, v, cq, ck)))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)


def _small():
    x = torch.zeros(4, 2, 8)
    cu = torch.tensor([0, 1, 4], dtype=torch.int32)
    return x, cu


def test_flash_attn_unpadded_refusals():
    x, cu = _small()
    with pytest.raises(NotImplementedError, match="return_softmax"):
        flash_attn_unpadded(x, x, x, cu, cu, 3, 3, None,
                            return_softmax=True)
    with pytest.raises(NotImplementedError, match="dropout"):
        flash_attn_unpadded(x, x, x, cu, cu, 3, 3, None, dropout=0.1)
    other = torch.tensor([0, 2, 4], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="identical"):
        flash_attn_unpadded(x, x, x, cu, other, 3, 3, None, causal=True)
    # dropout outside training is accepted, as in JAX
    out, _ = flash_attn_unpadded(x, x, x, cu, other, 3, 3, None,
                                 dropout=0.1, training=False)
    assert out.shape == x.shape


def test_varlen_has_no_gqa():
    x, cu = _small()
    kv = torch.zeros(4, 1, 8)
    with pytest.raises(ValueError, match="GQA"):
        flash_attn_unpadded(x, kv, kv, cu, cu, 3, 3, None)
    with pytest.raises(ValueError, match="GQA"):
        VA.varlen_fwd_reference(x, kv, kv, cu, cu)


def test_wrappers_refuse_non_cpu_tensors_before_any_work():
    meta = torch.empty(4, 2, 8, device="meta")
    cu = torch.empty(3, dtype=torch.int32, device="meta")
    lse = torch.empty(2, 4, device="meta")
    with pytest.raises(ValueError, match="device"):
        VA.varlen_fwd(meta, meta, meta, cu, cu)
    with pytest.raises(ValueError, match="device"):
        VA.varlen_bwd(meta, meta, meta, meta, lse, meta, cu, cu)
