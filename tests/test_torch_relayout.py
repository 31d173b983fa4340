"""The `kv` flash layout tier of the port on the CPU, against the JAX
package.

  * `to_head_major` / `from_head_major` and their adjoints (`ToHeadMajor`,
    `FromHeadMajor`) against JAX `_to_hm` / `_from_hm` and their VJPs;
  * `FlashAttentionKV` forward and gradients against JAX
    `_flash_core_kv` in interpret mode (causal and full, MHA and GQA 4/2,
    the shapes of tests/test_pallas.py's kv cases), within 1e-5 in f32;
  * the head-major plain flash versions bit for bit the native ones;
  * `scaled_dot_product_attention`'s dispatch order (`flash_tier`): mask,
    then padding, then ``FLAGS_flash_layout``, read at call time.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as fa
from paddle_tpu_torch.nn.functional import attention as A
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import flash_attention as FA
from paddle_tpu_torch.ops.kernels import relayout as RL

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_launches():
    K.reset_launches()
    yield
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 24, 3, 16), (1, 7, 1, 8),
                                   (3, 16, 12, 64)])
def test_relayout_pair_and_adjoints_match_jax(shape):
    rs = np.random.RandomState(sum(shape))
    x = _rand(rs, *shape)
    xt = _rand(rs, shape[0], shape[2], shape[1], shape[3])
    got = RL.to_head_major(torch.from_numpy(x))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(fa._to_hm(
        jnp.asarray(x))))
    got = RL.from_head_major(torch.from_numpy(xt))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(fa._from_hm(
        jnp.asarray(xt))))
    # the adjoints: each direction's VJP is the other direction
    for fn, jfn, inp, cot in ((RL.ToHeadMajor, fa._to_hm, x, xt),
                              (RL.FromHeadMajor, fa._from_hm, xt, x)):
        leaf = torch.from_numpy(inp).requires_grad_()
        (g,) = torch.autograd.grad(fn.apply(leaf), leaf,
                                   torch.from_numpy(cot))
        _, vjp = jax.vjp(jfn, jnp.asarray(inp))
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(vjp(jnp.asarray(cot))[0]))


def test_relayout_round_trip_and_dtype():
    x = torch.randn(2, 5, 4, 8, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    assert torch.equal(RL.from_head_major(RL.to_head_major(x)), x)
    assert RL.to_head_major(x).dtype == torch.bfloat16


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(3, 3), (4, 2)])
def test_flash_kv_tier_matches_jax_kv_core(hq, hkv, causal):
    """`FlashAttentionKV` (relayouts around the head-major flash plain
    versions on the CPU) against JAX `_flash_core_kv` in interpret mode:
    the output and all three gradients of a seeded linear loss."""
    rs = np.random.RandomState(7 + hq + hkv)
    b, s, d = 2, 128, 32
    q, k, v = _rand(rs, b, s, hq, d), _rand(rs, b, s, hkv, d), \
        _rand(rs, b, s, hkv, d)
    w = _rand(rs, b, s, hq, d)

    def jloss(q_, k_, v_):
        return (fa._flash_core_kv(q_, k_, v_, causal, 64, 64) * w).sum()

    jout = fa._flash_core_kv(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal, 64, 64)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = FA.FlashAttentionKV.apply(*leaves, causal)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                                   atol=1e-5)
    # the native tier gives the same numbers bit for bit
    native = FA.FlashAttention.apply(*leaves, None, causal)
    assert torch.equal(out, native)
    ngrads = torch.autograd.grad((native * torch.from_numpy(w)).sum(),
                                 leaves)
    for g, n in zip(grads, ngrads):
        assert torch.equal(g, n)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (6, 2)])
def test_head_major_plain_flash_bit_equal_to_native(hq, hkv):
    rs = np.random.RandomState(hq * 5 + hkv)
    b, sq, sk, d = 2, 20, 28, 16
    q = torch.from_numpy(_rand(rs, b, sq, hq, d))
    k = torch.from_numpy(_rand(rs, b, sk, hkv, d))
    v = torch.from_numpy(_rand(rs, b, sk, hkv, d))
    dout = torch.from_numpy(_rand(rs, b, sq, hq, d))
    for causal in (True, False):
        out, lse = FA.flash_fwd(q, k, v, causal=causal)
        out_t, lse_t = FA.flash_fwd(q.transpose(1, 2).contiguous(), k, v,
                                    causal=causal, head_major=True)
        assert torch.equal(out_t, out.transpose(1, 2))
        assert torch.equal(lse_t, lse)
        grads = FA.flash_bwd(q, k, v, out, lse, dout, causal=causal)
        dq_t, dk, dv = FA.flash_bwd(q.transpose(1, 2).contiguous(), k, v,
                                    out_t, lse_t,
                                    dout.transpose(1, 2).contiguous(),
                                    causal=causal, head_major=True)
        assert torch.equal(dq_t, grads[0].transpose(1, 2))
        assert torch.equal(dk, grads[1]) and torch.equal(dv, grads[2])


def test_dispatch_order_mask_padding_then_layout_flag(monkeypatch):
    """The JAX entry's order (flash_attention.py:1793-1928): a mask takes
    the biased path whatever the flag; then lengths not divisible by 8
    the native kernel; then FLAGS_flash_layout=kv the kv tier; every other
    layout value the native kernel.  The flag is read at call time."""
    q = torch.zeros(1, 64, 2, 16)
    odd = torch.zeros(1, 61, 2, 16)
    mask = torch.zeros(1, 1, 64, 64)
    monkeypatch.delenv("FLAGS_flash_layout", raising=False)
    assert FA.layout_flag() == "auto"
    assert A.flash_tier(q, q) == "native"
    for layout in ("auto", "flat", "transpose", "mh"):
        monkeypatch.setenv("FLAGS_flash_layout", layout)
        assert A.flash_tier(q, q) == "native"
    monkeypatch.setenv("FLAGS_flash_layout", "kv")
    assert A.flash_tier(q, q) == "kv"
    assert A.flash_tier(q, q, mask) == "biased"
    assert A.flash_tier(odd, odd) == "native"
    assert A.flash_tier(q, odd) == "native"
    assert A.flash_tier(odd, q) == "native"
    # the CPU path stays the plain attention under every flag
    out = A.scaled_dot_product_attention(q + 1, q, q, is_causal=True)
    monkeypatch.delenv("FLAGS_flash_layout")
    assert torch.equal(out, A.scaled_dot_product_attention(
        q + 1, q, q, is_causal=True))
