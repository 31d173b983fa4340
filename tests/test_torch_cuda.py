"""The port's CUDA kernels against their plain versions, on the card.

Edge cases the main path of ``chip_smoke.py`` does not reach: GQA, odd
and ragged lengths, Sq != Sk, head_dims 8..256, a single query row,
broadcast and boolean biases, fully masked (left-pad) rows, pages
crossed and the scratch page, ``start == pos``, for the forward and the
backward; rope's forward and adjoint over head counts 1..64, head_dims
32..256, odd lengths, per-row and broadcast phases, the interleaved
style and the strided q / k views of a fused qkv projection;
`conv_bn_act` at odd sizes, strides, paddings and kernel sizes, dense
and depthwise, every activation; `window_attention` and its backward
`window_attention_bwd` shifted and not, with and without a mask, one
window, non-square images, 3x3 windows, head_dims 8, 32 and 64; plus
launch counting, the wrappers' input checks, the gradients of
`FlashAttention`, `RoPE`, `ConvBNAct` and `window_attention` against
autograd through the plain versions, tiny GPT and LLaMA models whose
engine and ``generate()`` run on the card, tiny GPT, LLaMA, Swin and
ResNet train steps on the card against the same steps on the CPU, and
tiny ResNet, ResNeXt, MobileNetV2 and Swin forwards against the CPU
with their exact launches per forward; packed (varlen) attention forward
and backward over empty sequences, one-token sequences, unequal q / k
packings, rows that see no key and an explicit scale; the fused norm
over every operand combination, odd and wide rows, and `FusedNorm`'s
gradient; decode and paged attention at GQA groups of 16 and 12; the
incubate fused layers on the card against the CPU; the int8 paged kernel
at page sizes 8 / 16 / 32, GQA groups 1 / 4 / 16, head_dims 64 / 128 /
256, pos 0 and page crossings, and a tiny int8-KV engine on the card;
the relayout kernels and their adjoints (vector, 4-byte and 2-byte
copy units); the flash kernels' head-major mode bit for bit against the
native kernels, and `FlashAttentionKV` against `FlashAttention`; the
bf16 tensor-core flash core at its tile edges (63, 64, 65 and 130 rows,
Sq < Sk and Sq > Sk), head dims 8, 40, 72, 128 and 256 and GQA 12/4,
dense, biased (causal + pad rows) and packed, forward and backward, and
two runs of each mode bit for bit; the bf16 window forward's tensor-core
tile at P = 16, 25, 49 and 64, head dims 8, 24, 32 and 64, shifted with
and without a mask, wrap-around, stage 1's groups of windows, and the
shapes it hands to the CUDA-core kernel (P = 144, an unaligned qkv);
the fused norm's vector kernel at widths 768 to 8192 and the scalar one
for rows of other sizes and unaligned slices (which kernel ran is read
from the profiler); the exact-tier paged and dense decode kernels (keys
split across a thread-block cluster) at key counts at, under and just
over the split's tiles and shares and the pages (pos 0 and fewer keys
than the cluster's CTAs among them), a free slot on scratch page 0, GQA
12/1 and 32/2, head dims 64, 128 and 256, paged == dense bit for bit,
a sequence alone == in a batch, reruns bit for bit, and the refusal of
pools and caches that start off a 16-byte boundary; the int8 decode
kernel (the same cluster split over int8 codes and f32 scales) at the
same edges with pages of 8, 16, 32 and 6 and scale tables off a 16-byte
boundary (both scale copies give the same bits), alone == in a batch
and reruns bit for bit; rope over q and k in one launch (decode rows
whose heads split across blocks, GQA and MQA prefill rows, strided qkv
views, both styles, forward and adjoint) bit for bit two single calls
and the plain version, counting one launch, and `RoPE`'s paired
gradients bit for bit the single-tensor ones; flash at ViT-B/16's
S = 197 and ERNIE-base's biased pair against their plain versions,
dropout inside a captured graph (new masks each replay, the eager body
from the same generator state, `seed()` reproducible; a capture
without its generator raises) and a tiny ERNIE train step with dropout
replayed against its eager body; the engine's int8 weights with
speculative decoding (an accepting and a rejecting draft, both KV
tiers) equal to the CPU engine's streams and to greedy over
`effective_params()`, with exact launches a pass; sampled `generate()`
replaying its generator (== a per-step loop on a card generator of the
same seed); beams equal to the CPU port's (-k "spec or sampled or
beam"); the long job's train step (-k "guarded or resumes or
recompute"): a guarded tiny GPT with dropout skipping a NaN step and
rolling back inside its captured graph, the JAX package's checkpoint
(``tests/data/jax_gpt_train_state``) resumed on the card, and each
recompute policy with dropout equal to the plain step and replaying its
eager body.
Every test needs an NVIDIA card and skips without one.  On the card (no
JAX needed, so the JAX test conftest is left out)::

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: f32 1e-4 (the kernels sum in another order than the plain
versions), bf16 2e-2 (both round an f32 result of O(1) to bf16); the
backward's gradients are held relative to the largest reference
gradient.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import decode_attention as DA
from paddle_tpu_torch.ops.kernels import flash_attention as FA
from paddle_tpu_torch.ops.kernels import fused_norm as FN
from paddle_tpu_torch.ops.kernels import paged_attention as PA
from paddle_tpu_torch.ops.kernels import conv_norm as CN
from paddle_tpu_torch.ops.kernels import relayout as RL
from paddle_tpu_torch.ops.kernels import rope as RP
from paddle_tpu_torch.ops.kernels import varlen_attention as VA
from paddle_tpu_torch.ops.kernels import window_attention as WA

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 1e-2}
DTYPES = [torch.float32, torch.bfloat16]
# every kernel's float16 instantiation rides its f32 / bf16 cases (ids
# "f16": `-k f16` runs them alone)
DTYPES16 = DTYPES + [pytest.param(torch.float16, id="f16")]


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested on the CPU)")
    # full f32 in the plain versions' matmuls and cuDNN convs (both
    # default to TF32 on this card for some or all calls)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


def _randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    assert np.isfinite(err) and err <= TOL[dtype], err


def _close_grads(got, want, dtype):
    """(dq, dk, dv) pairs: max abs error over the largest reference
    gradient, within the dtype's tolerance."""
    for a, r in zip(got, want):
        assert a.shape == r.shape and a.dtype == r.dtype
        assert torch.isfinite(a).all()
        err = (a.float() - r.float()).abs().max().item()
        assert err <= TOL[dtype] * r.float().abs().max().item(), err


def _launched(fn):
    """(fn(), the names of the CUDA kernels that call launched), read by
    torch.profiler: which of a source's kernels the launcher chose.  A
    first call outside the profiler builds and loads the kernel, so the
    profiled call does only its launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, {e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA}


def _bwd_pair(q, k, v, dout, bias=None, causal=False):
    out, lse = FA.flash_fwd(q, k, v, bias=bias, causal=causal)
    return (FA.flash_bwd(q, k, v, out, lse, dout, bias=bias, causal=causal),
            FA.flash_bwd_reference(q, k, v, out, lse, dout, bias=bias,
                                   causal=causal))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d", [
    (2, 13, 21, 4, 2, 64),      # GQA, odd lengths, Sk > Sq
    (1, 70, 70, 8, 8, 128),     # ragged tail tile (70 = 2 * 32 + 6)
    (2, 1, 40, 4, 1, 32),       # one query row, GQA rep 4
    (1, 17, 17, 2, 2, 256),     # widest head_dim
    (3, 9, 9, 3, 3, 8),         # narrowest head_dim
    # the bf16 core's 64-row tiles: one short, exact, one over, two + 2;
    # head dims padded to 16 (40, 72), GQA 12/4
    (1, 63, 63, 12, 4, 40),
    (2, 64, 64, 4, 4, 72),
    (1, 65, 130, 4, 2, 128),    # Sq < Sk, causal bottom-right
    (1, 130, 130, 2, 1, 256),   # 32-key tiles at head_dim 256
    (2, 64, 65, 3, 3, 8),
])
def test_flash_fwd_matches_plain(b, sq, sk, hq, hkv, d, causal, dtype):
    g = torch.Generator(device="cuda").manual_seed(sq * 7 + d)
    q = _randn(g, b, sq, hq, d, dtype=dtype)
    k = _randn(g, b, sk, hkv, d, dtype=dtype)
    v = _randn(g, b, sk, hkv, d, dtype=dtype)
    out, lse = FA.flash_fwd(q, k, v, causal=causal)
    ref_out, ref_lse = FA.flash_fwd_reference(q, k, v, causal=causal)
    _close(out, ref_out, dtype)
    _close(lse, ref_lse, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("bias_shape", [(1, 1, 24, 40), (2, 1, 24, 40),
                                        (1, 3, 24, 40), (2, 3, 24, 40),
                                        (24, 40)])
@pytest.mark.parametrize("kind", ["additive", "bool"])
def test_flash_fwd_bias_matches_plain(bias_shape, kind, dtype):
    g = torch.Generator(device="cuda").manual_seed(11)
    q = _randn(g, 2, 24, 3, 64, dtype=dtype)
    k = _randn(g, 2, 40, 3, 64, dtype=dtype)
    v = _randn(g, 2, 40, 3, 64, dtype=dtype)
    if kind == "bool":
        bias = torch.rand(*bias_shape, generator=g, device="cuda") > 0.3
    else:
        bias = _randn(g, *bias_shape, dtype=torch.float32)
    out, lse = FA.flash_fwd(q, k, v, bias=bias)
    ref_out, ref_lse = FA.flash_fwd_reference(q, k, v, bias=bias)
    _close(out, ref_out, dtype)
    _close(lse, ref_lse, torch.float32)


# (Sq, Sk, head_dim) of the causal + pad-bias cases: the first three at
# 64; then the bf16 core's tile edges (63, 64, 65, 130 rows; Sq < Sk)
# at head dims 40, 128, 8, 72 and 256
PAD_BIAS_CASES = [(45, 45, 64), (70, 70, 64), (9, 40, 64), (63, 63, 40),
                  (64, 130, 128), (65, 65, 8), (130, 130, 72),
                  (65, 130, 256)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_flash_fwd_left_pad_rows_finite_and_equal(dtype):
    """Fully masked query rows (left pad) get the finite NEG_INF: their
    output is finite and equals the plain version's uniform average."""
    g = torch.Generator(device="cuda").manual_seed(3)
    b, s, h, d = 2, 45, 2, 64
    q, k, v = (_randn(g, b, s, h, d, dtype=dtype) for _ in range(3))
    start = torch.tensor([37, 0], device="cuda")
    j = torch.arange(s, device="cuda")
    valid = (j[None, :] <= j[:, None])[None] & (
        j[None, None, :] >= start[:, None, None])
    mask = torch.where(valid[:, None], 0.0, FA.NEG_INF)
    out, lse = FA.flash_fwd(q, k, v, bias=mask)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    ref_out, _ = FA.flash_fwd_reference(q, k, v, bias=mask)
    _close(out, ref_out, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("sq,sk,d", PAD_BIAS_CASES)
def test_flash_fwd_causal_with_pad_bias(sq, sk, d, dtype):
    """The prefill's form: causal plus a pad-only bias [B, 1, 1, Sk]
    (stride 0 over queries).  Real rows match the plain version; pad
    rows, which see no valid key, are finite (the kernel skips the key
    blocks past the diagonal, so it averages other keys there than the
    plain version does)."""
    g = torch.Generator(device="cuda").manual_seed(sq + sk + d)
    b, h = 2, 2
    q = _randn(g, b, sq, h, d, dtype=dtype)
    k = _randn(g, b, sk, h, d, dtype=dtype)
    v = _randn(g, b, sk, h, d, dtype=dtype)
    pad = 5
    start = torch.tensor([sk - sq + pad, 0], device="cuda")
    keys = torch.arange(sk, device="cuda")
    bias = torch.where(keys[None] >= start[:, None], 0.0,
                       FA.NEG_INF)[:, None, None]
    out, lse = FA.flash_fwd(q, k, v, bias=bias, causal=True)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    ref_out, ref_lse = FA.flash_fwd_reference(q, k, v, bias=bias,
                                              causal=True)
    _close(out[:, pad:], ref_out[:, pad:], dtype)
    _close(out[1], ref_out[1], dtype)
    _close(lse[..., pad:], ref_lse[..., pad:], torch.float32)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d", [
    (2, 13, 21, 4, 2, 64),      # GQA, odd lengths, Sk > Sq
    (1, 70, 70, 8, 8, 128),     # ragged tail tile, head_dim 128
    (2, 1, 40, 4, 1, 32),       # one query row, GQA rep 4
    (2, 45, 30, 6, 3, 64),      # Sq > Sk: causal rows with no key
    (1, 17, 17, 2, 2, 256),     # widest head_dim
    (3, 9, 9, 3, 3, 8),         # narrowest head_dim
    # the bf16 core's tiles (64 rows; 64 / 32 keys): edges, padded head
    # dims, GQA 12/4, Sq < Sk and Sq > Sk
    (1, 63, 63, 12, 4, 40),
    (2, 64, 64, 4, 4, 72),
    (1, 65, 130, 4, 2, 128),
    (1, 130, 130, 2, 1, 256),
    (1, 130, 65, 12, 4, 64),
    (2, 64, 65, 3, 3, 8),
])
def test_flash_bwd_matches_plain(b, sq, sk, hq, hkv, d, causal, dtype):
    g = torch.Generator(device="cuda").manual_seed(sq * 11 + d)
    q, dout = (_randn(g, b, sq, hq, d, dtype=dtype) for _ in range(2))
    k, v = (_randn(g, b, sk, hkv, d, dtype=dtype) for _ in range(2))
    if causal and sq > sk:
        # rows before sq - sk see no key; a loss gives them no cotangent
        dout[:, :sq - sk] = 0
    got, want = _bwd_pair(q, k, v, dout, causal=causal)
    _close_grads(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("bias_shape", [(1, 1, 24, 40), (2, 1, 24, 40),
                                        (1, 6, 24, 40), (2, 6, 24, 40),
                                        (24, 40), (2, 1, 1, 40)])
@pytest.mark.parametrize("kind", ["additive", "bool"])
def test_flash_bwd_bias_matches_plain(bias_shape, kind, dtype):
    """Broadcast and boolean biases, with GQA (6 query heads over 3 kv
    heads), which the JAX biased tier does not take."""
    g = torch.Generator(device="cuda").manual_seed(13)
    q, dout = (_randn(g, 2, 24, 6, 64, dtype=dtype) for _ in range(2))
    k, v = (_randn(g, 2, 40, 3, 64, dtype=dtype) for _ in range(2))
    if kind == "bool":
        bias = torch.rand(*bias_shape, generator=g, device="cuda") > 0.3
        bias[..., -1] = True           # every row sees at least one key
    else:
        bias = _randn(g, *bias_shape, dtype=torch.float32)
    got, want = _bwd_pair(q, k, v, dout, bias=bias)
    _close_grads(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_shape,hq,hkv,d", [
    ((2, 6, 24, 40), 6, 6, 64),      # full: stored, no atomics
    ((2, 1, 1, 40), 6, 3, 64),       # a key-pad mask: summed over Sq, h
    ((1, 6, 24, 40), 6, 2, 128),     # per head, summed over the batch
    ((24, 40), 4, 4, 256),           # [Sq, Sk]: two warps a key row
    ((2, 6, 1, 40), 6, 6, 32),       # per head, summed over Sq
    ((1, 1, 24, 40), 2, 1, 8),
])
def test_flash_bwd_dbias_matches_plain(bias_shape, hq, hkv, d, causal,
                                       dtype):
    """The dBias mode (a mask that requires grad) against the plain
    version: dQ / dK / dV and dBias in the mask's shape, relative to the
    largest reference gradient; -inf entries give dBias 0."""
    g = torch.Generator(device="cuda").manual_seed(17)
    q, dout = (_randn(g, 2, 24, hq, d, dtype=dtype) for _ in range(2))
    k, v = (_randn(g, 2, 40, hkv, d, dtype=dtype) for _ in range(2))
    bias = _randn(g, *bias_shape, dtype=torch.float32)
    bias[..., 3] = float("-inf")
    out, lse = FA.flash_fwd(q, k, v, bias=bias, causal=causal)
    got = FA.flash_bwd(q, k, v, out, lse, dout, bias=bias, causal=causal,
                       bias_grad=True)
    want = FA.flash_bwd_reference(q, k, v, out, lse, dout, bias=bias,
                                  causal=causal, bias_grad=True)
    assert got[3].shape == bias.shape and got[3].dtype == bias.dtype
    assert not got[3][..., 3].any()
    _close_grads(got, want, dtype)


def test_flash_attention_trainable_mask_through_autograd():
    """`FlashAttention` with a mask that requires grad launches the dBias
    mode once and gives the mask the plain version's gradient, in the
    mask's dtype (bf16 under O2)."""
    g = torch.Generator(device="cuda").manual_seed(19)
    q, k, v = (_randn(g, 2, 32, 4, 64, dtype=torch.bfloat16)
               for _ in range(3))
    mask = _randn(g, 2, 1, 1, 32, dtype=torch.bfloat16).requires_grad_()
    K.reset_launches()
    out = FA.FlashAttention.apply(q, k, v, mask, True)
    out.float().sum().backward()
    assert K.launch_counts()["flash_bwd"] == 1
    assert mask.grad.dtype == torch.bfloat16
    lse = FA.flash_fwd(q, k, v, bias=mask.detach(), causal=True)[1]
    want = FA.flash_bwd_reference(
        q, k, v, out.detach(), lse, torch.ones_like(out),
        bias=mask.detach(), causal=True, bias_grad=True)[3]
    _close_grads([mask.grad], [want], torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("sq,sk,d", PAD_BIAS_CASES)
def test_flash_bwd_causal_pad_rows(sq, sk, d, dtype):
    """The prefill's mask form under grad: causal plus a pad-only bias.
    Pad rows (no visible key) get finite gradients whatever their
    cotangent; with a zero cotangent there (a loss that ignores pads)
    every gradient equals the plain version's, and pad rows get none."""
    g = torch.Generator(device="cuda").manual_seed(sq * 3 + sk + d)
    b, h = 2, 2
    q, dout = (_randn(g, b, sq, h, d, dtype=dtype) for _ in range(2))
    k, v = (_randn(g, b, sk, h, d, dtype=dtype) for _ in range(2))
    pad = 5
    start = torch.tensor([sk - sq + pad, 0], device="cuda")
    keys = torch.arange(sk, device="cuda")
    bias = torch.where(keys[None] >= start[:, None], 0.0,
                       FA.NEG_INF)[:, None, None]
    out, lse = FA.flash_fwd(q, k, v, bias=bias, causal=True)
    grads = FA.flash_bwd(q, k, v, out, lse, dout, bias=bias, causal=True)
    assert all(torch.isfinite(x).all() for x in grads)
    dout[0, :pad] = 0
    got, want = _bwd_pair(q, k, v, dout, bias=bias, causal=True)
    _close_grads(got, want, dtype)
    assert not got[0][0, :pad].any()


# float16 (the dense modes: causal / full, with or without a bias) on the
# same tensor-core core as bf16: tile edges, padded head dims, GQA
F16_CASES = [(2, 13, 21, 4, 2, 64), (1, 63, 63, 12, 4, 40),
             (2, 64, 64, 4, 4, 72), (1, 65, 130, 4, 2, 128),
             (1, 130, 130, 2, 1, 256), (2, 64, 65, 3, 3, 8),
             (8, 256, 256, 12, 12, 64)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d", F16_CASES)
def test_flash_f16_fwd_bwd_match_plain(b, sq, sk, hq, hkv, d, causal):
    """f16 forward and backward against the plain versions on the same
    f16 inputs, within 1e-2 (of the largest reference gradient), the
    LSE within 1e-4; the kernels ran (launch counters)."""
    dtype = torch.float16
    g = torch.Generator(device="cuda").manual_seed(sq * 5 + d)
    q, dout = (_randn(g, b, sq, hq, d, dtype=dtype) for _ in range(2))
    k, v = (_randn(g, b, sk, hkv, d, dtype=dtype) for _ in range(2))
    K.reset_launches()
    out, lse = FA.flash_fwd(q, k, v, causal=causal)
    ref_out, ref_lse = FA.flash_fwd_reference(q, k, v, causal=causal)
    assert out.dtype == dtype
    _close(out, ref_out, dtype)
    _close(lse, ref_lse, torch.float32)
    got, want = _bwd_pair(q, k, v, dout, causal=causal)
    _close_grads(got, want, dtype)
    counts = K.launch_counts()
    assert counts["flash_fwd"] == 2 and counts["flash_bwd"] == 1


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bias_shape", [(1, 1, 24, 40), (2, 6, 24, 40),
                                        (2, 1, 1, 40)])
def test_flash_f16_bias_matches_plain(bias_shape, causal):
    """The biased mode in f16, GQA 6/3, forward and backward."""
    dtype = torch.float16
    g = torch.Generator(device="cuda").manual_seed(17)
    q, dout = (_randn(g, 2, 24, 6, 64, dtype=dtype) for _ in range(2))
    k, v = (_randn(g, 2, 40, 3, 64, dtype=dtype) for _ in range(2))
    bias = _randn(g, *bias_shape, dtype=torch.float32)
    out, lse = FA.flash_fwd(q, k, v, bias=bias, causal=causal)
    ref_out, ref_lse = FA.flash_fwd_reference(q, k, v, bias=bias,
                                              causal=causal)
    _close(out, ref_out, dtype)
    _close(lse, ref_lse, torch.float32)
    got, want = _bwd_pair(q, k, v, dout, bias=bias, causal=causal)
    _close_grads(got, want, dtype)


def test_flash_f16_reruns_bit_identical_and_other_modes_raise():
    """Two f16 runs of each direction are bit-identical (no atomics);
    the head-major (kv tier) and packed modes take f16 too, each its own
    f16 instantiation, and raise TypeError for a dtype no mode takes
    (float64) rather than compute in another dtype."""
    dtype = torch.float16
    g = torch.Generator(device="cuda").manual_seed(23)
    q, k, v, dout = (_randn(g, 2, 128, 4, 64, dtype=dtype)
                     for _ in range(4))
    runs = []
    for _ in range(2):
        out, lse = FA.flash_fwd(q, k, v, causal=True)
        runs.append((out, lse) + FA.flash_bwd(q, k, v, out, lse, dout,
                                              causal=True))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    out_t, lse_t = FA.flash_fwd(q.transpose(1, 2).contiguous(), k, v,
                                causal=True, head_major=True)
    assert out_t.dtype == dtype
    assert torch.equal(out_t, runs[0][0].transpose(1, 2))
    cu = torch.tensor([0, 128], dtype=torch.int32, device="cuda")
    out_p, _ = VA.varlen_fwd(q[0], k[0], v[0], cu, cu, causal=True)
    assert out_p.dtype == dtype
    _close(out_p, runs[0][0][0], dtype)
    with pytest.raises(TypeError, match="float64"):
        FA.flash_fwd(q.transpose(1, 2).contiguous().double(), k.double(),
                     v.double(), causal=True, head_major=True)
    with pytest.raises(TypeError, match="float64"):
        VA.varlen_fwd(q[0].double(), k[0].double(), v[0].double(), cu, cu,
                      causal=True)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
def test_flash_attention_grad_matches_autograd_of_plain(hq, hkv, causal):
    g = torch.Generator(device="cuda").manual_seed(hq + hkv)
    shapes = ((2, 19, hq, 32), (2, 27, hkv, 32), (2, 27, hkv, 32))
    leaves = [_randn(g, *s, dtype=torch.float32).requires_grad_()
              for s in shapes]
    dout = _randn(g, 2, 19, hq, 32, dtype=torch.float32)
    out = FA.FlashAttention.apply(*leaves, None, causal)
    got = torch.autograd.grad(out, leaves, dout)
    ref_out, _ = FA.flash_fwd_reference(*leaves, causal=causal)
    want = torch.autograd.grad(ref_out, leaves, dout)
    _close(out, ref_out, torch.float32)
    _close_grads(got, want, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
@pytest.mark.parametrize("hq,hkv,d", [(8, 2, 64), (4, 4, 128), (8, 1, 32)])
def test_paged_attention_matches_plain(hq, hkv, d, dtype):
    g = torch.Generator(device="cuda").manual_seed(hq + d)
    ps, npool = 16, 24
    q = _randn(g, 5, hq, d, dtype=dtype)
    kp = _randn(g, npool, hkv, ps, d, dtype=dtype)
    vp = _randn(g, npool, hkv, ps, d, dtype=dtype)
    # page crossings (40), an exact page end (31), one token (0), the
    # full table (63) and a free slot on the scratch page 0
    pt = torch.tensor([[3, 7, 1, 0], [9, 2, 0, 0], [5, 0, 0, 0],
                       [11, 12, 13, 14], [0, 0, 0, 0]], dtype=torch.int32,
                      device="cuda")
    pos = torch.tensor([40, 31, 0, 63, 0], dtype=torch.int32, device="cuda")
    _close(PA.paged_attention(q, kp, vp, pt, pos),
           PA.paged_attention_reference(q, kp, vp, pt, pos), dtype)


@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
@pytest.mark.parametrize("with_start", [True, False])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_decode_attention_matches_plain(hq, hkv, with_start, dtype):
    g = torch.Generator(device="cuda").manual_seed(hq * 3 + hkv)
    b, s, d = 4, 300, 128
    q = _randn(g, b, hq, d, dtype=dtype)
    kc = _randn(g, b, hkv, s, d, dtype=dtype)
    vc = _randn(g, b, hkv, s, d, dtype=dtype)
    pos = torch.tensor([299, 7, 150, 64], dtype=torch.int32, device="cuda")
    start = torch.tensor([10, 0, 150, 63], dtype=torch.int32,
                         device="cuda") if with_start else None
    _close(DA.decode_attention(q, kc, vc, pos, start),
           DA.decode_attention_reference(q, kc, vc, pos, start), dtype)


def _phases(gen, pb, s, d, dtype):
    """neox phases concat(freqs, freqs) of random positions, [pb,S,1,D]."""
    pos = torch.randint(0, 4096, (pb, s), generator=gen, device="cuda")
    inv = 1.0 / 10000.0 ** (torch.arange(0, d, 2, device="cuda") / d)
    emb = (pos[..., None].float() * inv).repeat(1, 1, 2)
    return (torch.cos(emb)[:, :, None].to(dtype),
            torch.sin(emb)[:, :, None].to(dtype))


def _rope_pair(x, cos, sin, interleaved=False):
    for adjoint in (False, True):
        got = RP.rope(x, cos, sin, adjoint=adjoint, interleaved=interleaved)
        assert got.is_contiguous() and got.shape == x.shape
        _close(got, RP.rope_reference(x, cos, sin, adjoint, interleaved),
               x.dtype)


@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("h", [1, 8, 32, 64])
def test_rope_matches_plain(h, d, dtype):
    """Odd S; per-row phases (B > 1) and phases broadcast over the
    batch; forward and adjoint."""
    g = torch.Generator(device="cuda").manual_seed(h * 7 + d)
    x = _randn(g, 3, 13, h, d, dtype=dtype)
    for pb in (3, 1):
        _rope_pair(x, *_phases(g, pb, 13, d, dtype))


@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
def test_rope_interleaved_and_unaligned(dtype):
    """The interleaved style (any phases), and the scalar path: head_dim
    whose half is not a multiple of the 16-byte vector, and an x that
    starts off a 16-byte boundary."""
    g = torch.Generator(device="cuda").manual_seed(5)
    x = _randn(g, 2, 9, 4, 64, dtype=dtype)
    cos = _randn(g, 2, 9, 1, 64, dtype=dtype)
    sin = _randn(g, 2, 9, 1, 64, dtype=dtype)
    _rope_pair(x, cos, sin, interleaved=True)
    x = _randn(g, 2, 9, 4, 12, dtype=dtype)
    _rope_pair(x, *_phases(g, 2, 9, 12, dtype))
    flat = _randn(g, 2 * 9 * 4 * 64 + 1, dtype=dtype)
    _rope_pair(flat[1:].view(2, 9, 4, 64), *_phases(g, 1, 9, 64, dtype))


@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
def test_rope_reads_strided_qkv_views(dtype):
    """q and k as LLaMA's attention takes them: views of the fused qkv
    projection (token stride q_size + 2 * kv_size), read in place."""
    g = torch.Generator(device="cuda").manual_seed(6)
    b, s, hq, hkv, d = 2, 37, 8, 2, 128
    qkv = _randn(g, b, s, (hq + 2 * hkv) * d, dtype=dtype)
    q, k, _ = qkv.split([hq * d, hkv * d, hkv * d], dim=-1)
    q, k = q.reshape(b, s, hq, d), k.reshape(b, s, hkv, d)
    assert not q.is_contiguous() and not k.is_contiguous()
    for x in (q, k):
        _rope_pair(x, *_phases(g, b, s, d, dtype))
        _rope_pair(x, *_phases(g, b, s, d, dtype), interleaved=True)


@pytest.mark.parametrize("interleaved", [False, True])
def test_rope_grad_matches_autograd_of_plain(interleaved):
    g = torch.Generator(device="cuda").manual_seed(7)
    x = _randn(g, 2, 11, 4, 64, dtype=torch.float32).requires_grad_()
    cos, sin = _phases(g, 2, 11, 64, torch.float32)
    dout = _randn(g, 2, 11, 4, 64, dtype=torch.float32)
    K.reset_launches()
    (got,) = torch.autograd.grad(RP.RoPE.apply(x, cos, sin, interleaved),
                                 x, dout)
    assert K.launch_counts()["rope"] == K.launch_counts()["rope_bwd"] == 1
    (want,) = torch.autograd.grad(
        RP.rope_reference(x, cos, sin, interleaved=interleaved), x, dout)
    _close(got, want, torch.float32)


def test_launch_counters_count_cuda_launches_only():
    K.reset_launches()
    q = torch.randn(1, 4, 2, 64, device="cuda")
    out, lse = FA.flash_fwd(q, q, q)
    FA.flash_fwd(q.cpu(), q.cpu(), q.cpu())      # plain version: no count
    FA.flash_bwd(q, q, q, out, lse, q)
    FA.flash_bwd(q.cpu(), q.cpu(), q.cpu(), out.cpu(), lse.cpu(), q.cpu())
    q3 = torch.randn(1, 2, 64, device="cuda")
    cache = torch.randn(1, 2, 8, 64, device="cuda")
    pos = torch.tensor([5], dtype=torch.int32, device="cuda")
    DA.decode_attention(q3, cache, cache, pos)
    pools = torch.randn(2, 2, 8, 64, device="cuda")
    PA.paged_attention(q3, pools, pools,
                       torch.ones(1, 1, dtype=torch.int32, device="cuda"),
                       pos)
    ph = torch.ones(1, 4, 1, 64, device="cuda")
    RP.rope(q, ph, ph)
    RP.rope(q, ph, ph, adjoint=True)
    RP.rope(q.cpu(), ph.cpu(), ph.cpu())
    x = torch.randn(1, 4, 6, 6, device="cuda")
    w = torch.randn(8, 4, 3, 3, device="cuda")
    sc = torch.ones(8, device="cuda")
    CN.conv_bn_act(x, w, sc, sc, 1, 1)
    CN.conv_bn_act(x.cpu(), w.cpu(), sc.cpu(), sc.cpu(), 1, 1)
    qkv = torch.randn(1, 4, 4, 24, device="cuda")
    bias = torch.zeros(2, 16, 16, device="cuda")
    WA.window_attention(qkv, bias, None, 4, 0, 2)
    WA.window_attention(qkv.cpu(), bias.cpu(), None, 4, 0, 2)
    gw = torch.randn(1, 4, 4, 8, device="cuda")
    WA.window_attention_bwd(qkv, bias, None, gw, 4, 0, 2)
    WA.window_attention_bwd(qkv.cpu(), bias.cpu(), None, gw.cpu(), 4, 0, 2)
    qp = torch.randn(5, 2, 64, device="cuda")
    cu = torch.tensor([0, 2, 5], dtype=torch.int32, device="cuda")
    out, lse = VA.varlen_fwd(qp, qp, qp, cu, cu)
    VA.varlen_fwd(qp.cpu(), qp.cpu(), qp.cpu(), cu.cpu(), cu.cpu())
    VA.varlen_bwd(qp, qp, qp, out, lse, qp, cu, cu)
    VA.varlen_bwd(qp.cpu(), qp.cpu(), qp.cpu(), out.cpu(), lse.cpu(),
                  qp.cpu(), cu.cpu(), cu.cpu())
    FN.fused_norm(qp)
    FN.fused_norm(qp.cpu())
    codes = torch.zeros(2, 2, 8, 64, dtype=torch.int8, device="cuda")
    sc = torch.ones(2, 2, 8, device="cuda")
    PA.paged_attention(q3, codes, codes,
                       torch.ones(1, 1, dtype=torch.int32, device="cuda"),
                       pos, k_scales=sc, v_scales=sc)
    PA.paged_attention(q3.cpu(), codes.cpu(), codes.cpu(),
                       torch.ones(1, 1, dtype=torch.int32), pos.cpu(),
                       k_scales=sc.cpu(), v_scales=sc.cpu())
    RL.to_head_major(q)
    RL.to_head_major(q.cpu())
    RL.from_head_major(q)
    RL.from_head_major(q.cpu())
    torch.cuda.synchronize()
    assert K.launch_counts() == {"flash_fwd": 1, "flash_bwd": 1,
                                 "paged_attention": 1,
                                 "decode_attention": 1, "rope": 1,
                                 "rope_bwd": 1, "conv_bn_act": 1,
                                 "window_attention": 1,
                                 "window_attention_bwd": 1,
                                 "varlen_fwd": 1, "varlen_bwd": 1,
                                 "fused_norm": 1, "paged_attention_int8": 1,
                                 "relayout_to_hm": 1,
                                 "relayout_from_hm": 1}
    K.reset_launches()


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.randn(1, 4, 2, 12, device="cuda")            # D % 8 != 0
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_fwd(q, q, q)
    q = torch.randn(1, 2, 4, 64, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_fwd(q, q, q)
    q = torch.randn(1, 4, 2, 64, device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError):
        FA.flash_fwd(q, q, q)
    q = torch.randn(1, 2, 4, 64, device="cuda", dtype=torch.float64)
    kv64 = torch.randn(1, 4, 2, 64, device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError, match="float64"):
        FA.flash_fwd(q, kv64, kv64, head_major=True)
    q = torch.randn(1, 4, 2, 64, device="cuda")
    out, lse = FA.flash_fwd(q, q, q)
    with pytest.raises(ValueError, match="lse"):
        FA.flash_bwd(q, q, q, out, lse.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match="dout"):
        FA.flash_bwd(q, q, q, out, lse, q[:, :2])
    q3 = torch.randn(1, 2, 64, device="cuda")
    pools = torch.zeros(2, 2, 8, 64, device="cuda", dtype=torch.int8)
    pos = torch.zeros(1, dtype=torch.int32, device="cuda")
    table = torch.zeros(1, 1, dtype=torch.int32, device="cuda")
    sc = torch.ones(2, 2, 8, device="cuda")
    with pytest.raises(TypeError):              # int8 pools, no scales
        PA.paged_attention(q3, pools, pools, table, pos)
    with pytest.raises(ValueError, match="together"):
        PA.paged_attention(q3, pools, pools, table, pos, k_scales=sc)
    with pytest.raises(ValueError, match="k_scales"):
        PA.paged_attention(q3, pools, pools, table, pos,
                           k_scales=sc.double(), v_scales=sc)
    with pytest.raises(ValueError, match="multiple of 16"):
        PA.paged_attention(q3[..., :56].contiguous(), pools[..., :56]
                           .contiguous(), pools[..., :56].contiguous(),
                           table, pos, k_scales=sc, v_scales=sc)
    with pytest.raises(TypeError):              # exact pools with scales
        PA.paged_attention(q3, pools.float(), pools.float(), table, pos,
                           k_scales=sc, v_scales=sc)
    with pytest.raises(ValueError, match="contiguous"):
        RL.to_head_major(torch.randn(1, 4, 2, 8, device="cuda")
                         .transpose(1, 2))
    with pytest.raises(TypeError):
        RL.from_head_major(torch.zeros(1, 4, 2, 8, device="cuda",
                                       dtype=torch.float64))
    q_t = torch.randn(1, 2, 4, 64, device="cuda")       # [B, H, S, D]
    kv = torch.randn(1, 4, 2, 64, device="cuda")        # [B, S, H, D]
    with pytest.raises(ValueError, match="bias"):
        FA.flash_fwd(q_t, kv, kv, bias=torch.zeros(1, 1, 4, 4,
                                                   device="cuda"),
                     head_major=True)
    with pytest.raises(TypeError, match="int32"):
        DA.decode_attention(q3, torch.randn(1, 2, 8, 64, device="cuda"),
                            torch.randn(1, 2, 8, 64, device="cuda"),
                            pos.long())
    q = torch.randn(1, 4, 2, 64, device="cuda")
    ph = torch.ones(1, 4, 1, 64, device="cuda")
    with pytest.raises(ValueError, match="even"):
        RP.rope(q[..., :63], ph[..., :63], ph[..., :63])
    with pytest.raises(TypeError, match="bfloat16"):
        RP.rope(q, ph.to(torch.bfloat16), ph.to(torch.bfloat16))
    with pytest.raises(ValueError, match="cos"):
        RP.rope(q, ph[:, :3], ph)


def test_tiny_gpt_on_the_card_matches_cpu_and_engine_matches_generate():
    from paddle_tpu_torch.inference.engine import (
        EngineConfig, InferenceEngine,
    )
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                    num_heads=4, max_seq_len=64)
    cpu = GPTForCausalLM(cfg, device="cpu", seed=1)
    gpu = GPTForCausalLM(cfg, seed=1)                  # default: the card
    assert gpu.device.type == "cuda"
    gpu.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 128, (3, 11)).astype(np.int32)
    with torch.inference_mode():
        lc = cpu(torch.from_numpy(ids))
        lg = gpu(torch.from_numpy(ids).cuda()).cpu()
    # logits reach ~50 here: 1e-3 is 2e-5 relative, f32 summation order
    assert (lg - lc).abs().max().item() < 1e-3
    prompts = [rs.randint(0, 128, (n,)).astype(np.int32)
               for n in (3, 9, 17, 5)]
    refs = [gpu.generate(p[None], max_new_tokens=8).cpu().numpy()[0]
            for p in prompts]
    eng = InferenceEngine(gpu, EngineConfig(page_size=4, max_slots=2,
                                            max_seq_len=64))
    K.reset_launches()
    outs = eng.generate(prompts, max_new_tokens=8)
    counts = K.launch_counts()
    assert counts["flash_fwd"] > 0 and counts["paged_attention"] > 0
    for r, o in zip(refs, outs):
        np.testing.assert_array_equal(o, r)


def test_tiny_gpt_train_step_on_the_card_matches_cpu():
    """A tiny GPT with the fused head + CE in f32, the card (flash_fwd /
    flash_bwd kernels) against the CPU (plain versions): every
    parameter's gradient, then the losses of 3 AdamW steps.

    The parameters after the steps are not compared: the key slice of
    `qkv_proj.bias` has a gradient that is zero up to rounding (softmax
    ignores a shift shared by all keys), and Adam scales that rounding
    noise to a step of +-lr either way.  For the same reason each
    gradient is held relative to at least a thousandth of the largest
    gradient of the model."""
    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.models.gpt import (
        GPTConfig, GPTForCausalLM, GPTPretrainingCriterion,
    )
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig(vocab_size=300, hidden_size=64, num_layers=2,
                    num_heads=4, max_seq_len=64, fused_head_ce=True)
    rs = np.random.RandomState(0)
    ids, labels = (rs.randint(0, 300, (2, 40)).astype(np.int32)
                   for _ in range(2))
    cpu = GPTForCausalLM(cfg, device="cpu", seed=2)
    gpu = GPTForCausalLM(cfg)
    gpu.load_state_dict(cpu.state_dict())
    K.reset_launches()
    grads = []
    for model in (gpu, cpu):
        model.train()
        dev = next(model.parameters()).device
        loss = GPTPretrainingCriterion(model=model)(
            model(torch.from_numpy(ids).to(dev)),
            torch.from_numpy(labels).to(dev))
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    assert K.launch_counts()["flash_bwd"] == 2
    top = max(g.abs().max().item() for g in grads[1])
    for n, a, b in zip(dict(cpu.named_parameters()), *grads):
        err = (a.cpu() - b).abs().max().item()
        assert err <= 1e-4 * max(b.abs().max().item(), 1e-3 * top), (n, err)
    losses = []
    for model in (gpu, cpu):
        step = build_train_step(model, AdamW(learning_rate=1e-3),
                                GPTPretrainingCriterion(model=model))
        losses.append(step.run_steps(ids, labels, repeat=3).cpu())
    assert K.launch_counts()["flash_bwd"] == 2 + 2 * 3
    torch.testing.assert_close(losses[0], losses[1], atol=1e-4, rtol=0)


def test_tiny_llama_on_the_card_matches_cpu_engine_and_train_step():
    """A tiny GQA LLaMA (4 query heads over 2 kv heads): card logits
    against the CPU's; the engine's streams against `generate()` on the
    card; then every gradient and 3 AdamW steps against the CPU, with
    the rope adjoint and flash_bwd launched."""
    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.inference.engine import (
        EngineConfig, InferenceEngine,
    )
    from paddle_tpu_torch.models.llama import (
        LlamaForCausalLM, LlamaPretrainingCriterion, llama_tiny,
    )
    from paddle_tpu_torch.optimizer import AdamW

    cfg = llama_tiny(vocab_size=128, max_seq_len=64)
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=1)
    gpu = LlamaForCausalLM(cfg, seed=1)
    gpu.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 128, (3, 11)).astype(np.int32)
    with torch.inference_mode():
        lc = cpu(torch.from_numpy(ids))
        lg = gpu(torch.from_numpy(ids).cuda()).cpu()
    assert (lg - lc).abs().max().item() < 1e-3
    prompts = [rs.randint(0, 128, (n,)).astype(np.int32)
               for n in (3, 9, 17, 5)]
    refs = [gpu.generate(p[None], max_new_tokens=8).cpu().numpy()[0]
            for p in prompts]
    K.reset_launches()
    outs = InferenceEngine(gpu, EngineConfig(
        page_size=4, max_slots=2, max_seq_len=64)).generate(
            prompts, max_new_tokens=8)
    counts = K.launch_counts()
    assert counts["flash_fwd"] and counts["paged_attention"] \
        and counts["rope"]
    for r, o in zip(refs, outs):
        np.testing.assert_array_equal(o, r)
    labels = rs.randint(0, 128, (3, 11)).astype(np.int32)
    K.reset_launches()
    grads = []
    for model in (gpu, cpu):
        model.train()
        dev = model.device
        loss = LlamaPretrainingCriterion()(
            model(torch.from_numpy(ids).to(dev)),
            torch.from_numpy(labels).to(dev))
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    # one adjoint launch a layer: q's and k's gradients together
    assert K.launch_counts()["rope_bwd"] == cfg.num_layers
    assert K.launch_counts()["flash_bwd"] == cfg.num_layers
    top = max(g.abs().max().item() for g in grads[1])
    for n, a, b in zip(dict(cpu.named_parameters()), *grads):
        err = (a.cpu() - b).abs().max().item()
        assert err <= 1e-4 * max(b.abs().max().item(), 1e-3 * top), (n, err)
    losses = [build_train_step(m, AdamW(learning_rate=1e-3),
                               LlamaPretrainingCriterion()).run_steps(
        ids, labels, repeat=3).cpu() for m in (gpu, cpu)]
    torch.testing.assert_close(losses[0], losses[1], atol=1e-4, rtol=0)


# ------------------------------------------------------------------ vision
@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
@pytest.mark.parametrize("act", ["relu", "relu6", None])
@pytest.mark.parametrize("b,cin,h,w,cout,k,st,pad,dw", [
    (2, 3, 15, 15, 8, 3, 1, 1, False),     # odd H = W = 15, pad 1
    (2, 5, 15, 13, 70, 3, 2, 1, False),    # Cout past one 64 tile
    (1, 16, 7, 7, 33, 1, 1, 0, False),     # 1x1 at 7x7
    (3, 3, 17, 17, 9, 7, 2, 3, False),     # a stem-like 7x7/s2/p3
    (2, 4, 9, 9, 6, 5, 1, 2, False),       # run-time kernel size
    (1, 8, 6, 10, 8, 3, 2, 0, False),      # no padding, stride 2
    (2, 12, 15, 15, 12, 3, 1, 1, True),    # depthwise
    (2, 12, 15, 15, 12, 3, 2, 1, True),    # depthwise stride 2
    (1, 7, 9, 11, 7, 5, 1, 2, True),       # depthwise 5x5
])
def test_conv_bn_act_matches_plain(b, cin, h, w, cout, k, st, pad, dw, act,
                                   dtype):
    gen = torch.Generator(device="cuda").manual_seed(7)
    cin_g = 1 if dw else cin
    x = _randn(gen, b, cin, h, w, dtype=dtype)
    wt = (_randn(gen, cout, cin_g, k, k, dtype=torch.float32)
          / np.sqrt(cin_g * k * k)).to(dtype)
    sc = 0.5 + 0.5 * torch.rand(cout, generator=gen, device="cuda")
    sh = 0.1 * _randn(gen, cout, dtype=torch.float32)
    got = CN.conv_bn_act(x, wt, sc, sh, st, pad, act)
    want = CN.conv_bn_act_reference(x, wt, sc, sh, st, pad, act, dw)
    assert got.shape == want.shape and got.dtype == dtype
    _close(got, want, dtype)


# the bf16 tensor-core conv's tiles and edges (csrc/conv_bn_act.cu)
CONV_TC_CASES = [
    (2, 16, 8, 8, 32, 1, 1, 0),        # 1x1/s1, H*W % 8 == 0 (64 pixels)
    (2, 64, 7, 7, 96, 1, 1, 0),        # 1x1/s1 at 7x7: odd H*W, pairs split
    (2, 16, 15, 15, 32, 3, 2, 1),      # 3x3/s2
    (2, 3, 32, 32, 64, 7, 2, 3),       # the stem: 7x7/s2, Cin 3, K = 147
    (3, 8, 10, 10, 16, 3, 1, 1),       # N tiles cross images (100 pixels)
    (5, 8, 7, 7, 16, 3, 1, 1),         # ... at an odd 49 pixels
    (2, 5, 15, 13, 70, 3, 2, 1),       # a Cout tail, K = 45
    (8, 32, 28, 28, 768, 3, 1, 1),     # the 128 x 128 tile
    (16, 64, 7, 7, 4900, 1, 1, 0),     # 128 x 128, odd pixels, Cout tail
    (2, 48, 10, 10, 64, 3, 1, 1),      # 3x3, K = 432: a tail mid-channel
    (2, 64, 14, 14, 256, 3, 2, 1),     # the 128 x 32 tile, stride 2
    (2, 40, 9, 9, 24, 5, 1, 2),        # a run-time 5x5 over 40 channels
    (64, 32, 14, 14, 256, 3, 1, 1),    # the 128 x 64 tile
    (128, 32, 7, 7, 384, 1, 1, 0),     # 128 x 64 at odd pixels
]


@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
@pytest.mark.parametrize("b,cin,h,w,cout,k,st,pad", CONV_TC_CASES)
def test_conv_bn_act_tensor_core_tiles(b, cin, h, w, cout, k, st, pad,
                                       dtype):
    """The dense conv at each tensor-core tile and edge (bf16; f32 runs
    the CUDA-core kernel at the same shapes), against the plain version,
    and two runs bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = _randn(gen, b, cin, h, w, dtype=dtype)
    wt = (_randn(gen, cout, cin, k, k, dtype=torch.float32)
          / np.sqrt(cin * k * k)).to(dtype)
    sc = 0.5 + 0.5 * torch.rand(cout, generator=gen, device="cuda")
    sh = 0.1 * _randn(gen, cout, dtype=torch.float32)
    got = CN.conv_bn_act(x, wt, sc, sh, st, pad, "relu")
    want = CN.conv_bn_act_reference(x, wt, sc, sh, st, pad, "relu")
    assert got.shape == want.shape and got.dtype == dtype
    _close(got, want, dtype)
    assert torch.equal(CN.conv_bn_act(x, wt, sc, sh, st, pad, "relu"), got)


def test_conv_bn_act_grad_is_the_plain_versions():
    """`ConvBNAct`: the kernel forward, the plain version's autograd
    backward (the JAX custom VJP's contract)."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    ins = [_randn(gen, *s, dtype=torch.float32).requires_grad_()
           for s in ((2, 6, 9, 9), (10, 6, 3, 3), (10,), (10,))]
    dout = _randn(gen, 2, 10, 5, 5, dtype=torch.float32)
    K.reset_launches()
    out = CN.ConvBNAct.apply(*ins, (2, 2), (1, 1), "relu6")
    assert K.launch_counts()["conv_bn_act"] == 1
    got = torch.autograd.grad(out, ins, dout)
    want = torch.autograd.grad(
        CN.conv_bn_act_reference(*ins, 2, 1, "relu6"), ins, dout)
    for a, r in zip(got, want):
        _close(a, r, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
@pytest.mark.parametrize("b,h,w,c,heads,ws,shift,masked", [
    (2, 14, 14, 24, 3, 7, 3, True),        # Swin shape, shifted + mask
    (1, 7, 7, 48, 2, 7, 0, False),         # one window (stage 4 shape)
    (2, 8, 12, 16, 2, 4, 2, True),         # non-square, wrap-around
    (1, 21, 21, 64, 2, 7, 3, True),        # 3x3 windows, hd 32
    (2, 14, 14, 24, 3, 7, 3, False),       # a shift without a mask
    (1, 10, 10, 40, 5, 5, 0, False),       # P = 25, head_dim 8
])
def test_window_attention_matches_plain(b, h, w, c, heads, ws, shift, masked,
                                        dtype):
    from paddle_tpu_torch.vision.models.swin import _shift_mask

    gen = torch.Generator(device="cuda").manual_seed(9)
    qkv = _randn(gen, b, h, w, 3 * c, dtype=dtype)
    bias = _randn(gen, heads, ws * ws, ws * ws, dtype=torch.float32)
    mask = torch.from_numpy(_shift_mask((h, w), ws, shift)).cuda() \
        if masked else None
    got = WA.window_attention(qkv, bias, mask, ws, shift, heads)
    want = WA.window_attention_reference(qkv, bias, mask, ws, shift, heads)
    assert got.shape == (b, h, w, c) and got.dtype == dtype
    _close(got, want, dtype)


WIN_BWD_CASES = [
    (2, 14, 14, 24, 3, 7, 3, True),        # Swin shape, shifted + mask
    (1, 7, 7, 48, 2, 7, 0, False),         # one window, hd 24
    (2, 8, 12, 16, 2, 4, 2, True),         # non-square, wrap-around
    (1, 21, 21, 64, 2, 7, 3, True),        # 3x3 windows, hd 32
    (2, 14, 14, 128, 2, 7, 3, True),       # hd 64
    (3, 7, 7, 96, 3, 7, 0, False),         # stage-4 form: one window, hd 32
    (1, 10, 10, 40, 5, 5, 0, False),       # P = 25, head_dim 8
    (2, 14, 14, 96, 3, 7, 0, False),       # Swin's P = 49, hd 32
    (2, 14, 14, 96, 3, 7, 3, True),        # ... shifted, with the mask
    (2, 56, 56, 96, 3, 7, 3, True),        # stage 1: groups of windows
]


def _win_bwd_inputs(b, h, w, c, heads, ws, shift, masked, dtype, seed=10):
    from paddle_tpu_torch.vision.models.swin import _shift_mask

    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = _randn(gen, b, h, w, 3 * c, dtype=dtype)
    bias = _randn(gen, heads, ws * ws, ws * ws, dtype=torch.float32)
    g = _randn(gen, b, h, w, c, dtype=dtype)
    mask = torch.from_numpy(_shift_mask((h, w), ws, shift)).cuda() \
        if masked else None
    return qkv, bias, mask, g


@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
@pytest.mark.parametrize("b,h,w,c,heads,ws,shift,masked", WIN_BWD_CASES)
def test_window_attention_bwd_matches_plain(b, h, w, c, heads, ws, shift,
                                            masked, dtype):
    """dqkv and dbias against the plain backward, each relative to its
    largest reference gradient (as `flash_bwd` is held); twice, to show
    the per-(batch, head) dbias partials make the result the same on
    every run."""
    qkv, bias, mask, g = _win_bwd_inputs(b, h, w, c, heads, ws, shift,
                                         masked, dtype)
    got = WA.window_attention_bwd(qkv, bias, mask, g, ws, shift, heads)
    want = WA.window_attention_bwd_reference(qkv, bias, mask, g, ws, shift,
                                             heads)
    assert got[0].shape == qkv.shape and got[0].dtype == dtype
    assert got[1].shape == bias.shape and got[1].dtype == torch.float32
    _close_grads(got, want, dtype)
    again = WA.window_attention_bwd(qkv, bias, mask, g, ws, shift, heads)
    assert all(torch.equal(a, r) for a, r in zip(again, got))


# the bf16 forward's tensor-core tile at the backward's cases, plus P =
# 64, a shift without a mask, and a window past the tile (P = 144, the
# CUDA-core kernel)
WIN_FWD_CASES = WIN_BWD_CASES + [
    (2, 16, 16, 64, 2, 8, 4, True),        # P = 64, the full tile, hd 32
    (2, 14, 14, 24, 3, 7, 3, False),       # a shift without a mask, hd 8
    (1, 24, 24, 64, 2, 12, 6, True),       # P = 144: past the tile
]


@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
@pytest.mark.parametrize("b,h,w,c,heads,ws,shift,masked", WIN_FWD_CASES)
def test_window_attention_fwd_kernels_match_plain(b, h, w, c, heads, ws,
                                                  shift, masked, dtype):
    """The forward against its plain version: bf16 windows of up to 64
    tokens at head dims <= 64 (multiples of 8) on the tensor-core tile
    (`window_attention_tc`), f32 and wider bf16 windows on the CUDA-core
    kernel (`window_attention_kernel`), as the profiler shows; twice, for
    identical bits."""
    qkv, bias, mask, _ = _win_bwd_inputs(b, h, w, c, heads, ws, shift,
                                         masked, dtype, seed=12)
    got, names = _launched(
        lambda: WA.window_attention(qkv, bias, mask, ws, shift, heads))
    want = WA.window_attention_reference(qkv, bias, mask, ws, shift, heads)
    assert got.shape == (b, h, w, c) and got.dtype == dtype
    _close(got, want, dtype)
    tile = (dtype in WA.TC_DTYPES and ws * ws <= WA.TC_MAX_TOKENS
            and c // heads <= WA.TC_MAX_HEAD_DIM and (c // heads) % 8 == 0)
    kernel = "window_attention_tc" if tile else "window_attention_kernel"
    assert any(kernel in n for n in names), names
    assert torch.equal(
        WA.window_attention(qkv, bias, mask, ws, shift, heads), got)


def test_window_attention_fwd_bf16_off_alignment_takes_the_cuda_cores():
    """A qkv that starts 2 bytes past 16-byte alignment cannot feed the
    tile's 16-byte copies: the launcher gives it to the CUDA-core kernel,
    with the same result as the plain version."""
    qkv, bias, mask, _ = _win_bwd_inputs(2, 14, 14, 96, 3, 7, 3, True,
                                         torch.bfloat16, seed=13)
    flat = torch.empty(qkv.numel() + 1, dtype=qkv.dtype, device="cuda")
    off = flat[1:].view(qkv.shape)
    off.copy_(qkv)
    got, names = _launched(
        lambda: WA.window_attention(off, bias, mask, 7, 3, 3))
    assert any("window_attention_kernel" in n for n in names), names
    _close(got, WA.window_attention_reference(qkv, bias, mask, 7, 3, 3),
           torch.bfloat16)


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_grad_matches_autograd_of_plain(masked):
    """On the card, `window_attention` on inputs that require grad runs
    the forward kernel once and, under backward, the backward kernel
    once (`WindowAttentionCore`), with the gradients of autograd through
    the plain forward; the mask gets none."""
    qkv, bias, mask, g = _win_bwd_inputs(2, 14, 14, 24, 3, 7, 3, masked,
                                         torch.float32, seed=11)
    qkv.requires_grad_()
    bias.requires_grad_()
    if mask is not None:
        mask.requires_grad_()
    K.reset_launches()
    out = WA.window_attention(qkv, bias, mask, 7, 3, 3)
    assert K.launch_counts()["window_attention"] == 1
    leaves = (qkv, bias) if mask is None else (qkv, bias, mask)
    got = torch.autograd.grad(out, leaves, g, allow_unused=True)
    assert K.launch_counts()["window_attention_bwd"] == 1
    want = torch.autograd.grad(
        WA.window_attention_reference(qkv, bias, mask, 7, 3, 3), (qkv, bias),
        g)
    _close_grads(got[:2], want, torch.float32)
    if mask is not None:
        assert got[2] is None


def test_window_attention_bwd_bf16_rejects_what_the_tile_cannot_take():
    """The bf16 backward's tensor-core tile holds windows of up to 64
    tokens and head dims up to 64, multiples of 8: it raises beyond."""
    for b, h, w, c, heads, ws in ((1, 9, 9, 64, 2, 9),    # P = 81
                                  (1, 7, 7, 24, 2, 7),    # hd 12
                                  (1, 7, 7, 160, 2, 7)):  # hd 80
        qkv, bias, mask, g = _win_bwd_inputs(b, h, w, c, heads, ws, 0,
                                             False, torch.bfloat16)
        with pytest.raises(ValueError, match="bf16"):
            WA.window_attention_bwd(qkv, bias, mask, g, ws, 0, heads)


def test_vision_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.randn(1, 4, 6, 6, device="cuda")
    sc = torch.ones(8, device="cuda")
    with pytest.raises(ValueError, match="neither"):
        CN.conv_bn_act(x, torch.randn(8, 2, 3, 3, device="cuda"), sc, sc)
    with pytest.raises(TypeError):
        CN.conv_bn_act(x, torch.randn(8, 4, 3, 3, device="cuda",
                                      dtype=torch.bfloat16), sc, sc)
    with pytest.raises(ValueError, match="scale"):
        CN.conv_bn_act(x, torch.randn(8, 4, 3, 3, device="cuda"),
                       sc.double(), sc)
    with pytest.raises(ValueError, match="act"):
        CN.conv_bn_act(x, torch.randn(8, 4, 3, 3, device="cuda"), sc, sc,
                       act="gelu")
    with pytest.raises(ValueError, match="device"):      # a host weight
        CN.conv_bn_act(x, torch.randn(8, 4, 3, 3), sc, sc)
    qkv = torch.randn(1, 6, 6, 24, device="cuda")
    bias = torch.zeros(2, 16, 16, device="cuda")
    with pytest.raises(ValueError, match="window"):
        WA.window_attention(qkv, bias, None, 4, 0, 2)     # 6 % 4 != 0
    with pytest.raises(ValueError, match="mask"):
        WA.window_attention(qkv[:, :4, :4], bias,
                            torch.zeros(2, 16, 16, device="cuda"), 4, 2, 2)
    q4 = qkv[:, :4, :4]
    with pytest.raises(ValueError, match="g "):
        WA.window_attention_bwd(q4, bias, None,
                                torch.zeros(1, 4, 4, 4, device="cuda"), 4,
                                0, 2)
    with pytest.raises(ValueError, match="g "):
        WA.window_attention_bwd(q4, bias, None,
                                torch.zeros(1, 4, 4, 8, device="cuda",
                                            dtype=torch.bfloat16), 4, 0, 2)
    with pytest.raises(ValueError, match="limits"):       # 16x16 windows
        WA.window_attention_bwd(
            torch.zeros(1, 16, 16, 96, device="cuda"),
            torch.zeros(1, 256, 256, device="cuda"), None,
            torch.zeros(1, 16, 16, 32, device="cuda"), 16, 0, 1)


@pytest.mark.parametrize("name,kw,size,kernel,per_fwd", [
    ("resnet18", dict(num_classes=10), 32, "conv_bn_act", 17),
    ("resnext50_32x4d", dict(num_classes=10), 32, "conv_bn_act", 33),
    ("MobileNetV2", dict(scale=0.25, num_classes=10), 32, "conv_bn_act",
     35),
    ("SwinTransformer", dict(img_size=56, embed_dim=24, depths=(2, 2),
                             num_heads=(1, 2), window_size=7,
                             num_classes=10), 56, "window_attention", 4),
])
def test_tiny_vision_models_on_the_card_match_cpu(name, kw, size, kernel,
                                                  per_fwd):
    """f32 logits of the card's forward (kernels) against the CPU's
    (plain versions), and the exact launches per forward (ResNeXt's
    grouped 3x3 convs take the composed path: 2 of 3 per block fused)."""
    from paddle_tpu_torch.vision import models as V

    cpu = getattr(V, name)(**kw, device="cpu", seed=3)
    gpu = getattr(V, name)(**kw, seed=3)               # default: the card
    gpu.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.RandomState(0).randn(
        2, 3, size, size).astype(np.float32))
    K.reset_launches()
    with torch.inference_mode():
        lg = gpu(x.cuda()).cpu()
        counts = K.launch_counts()
        lc = cpu(x)
    assert counts[kernel] == per_fwd
    assert ((lg - lc).norm() / lc.norm()).item() < 1e-4


@pytest.mark.parametrize("name,kw,size,batch,kernel,per_step", [
    ("SwinTransformer", dict(img_size=56, embed_dim=24, depths=(2, 2),
                             num_heads=(1, 2), window_size=7,
                             num_classes=10), 56, 2, "window_attention", 4),
    ("resnet18", dict(num_classes=10), 32, 8, "conv_bn_act", 0),
])
def test_tiny_vision_train_step_on_the_card_matches_cpu(name, kw, size, batch,
                                                        kernel, per_step):
    """f32, the card (Swin: the window kernels forward and backward, 4 + 4
    per step; ResNet: batch statistics, no `conv_bn_act`) against the
    CPU (plain versions): every parameter's gradient of one step in
    training mode, held relative to at least a thousandth of the largest
    gradient of the model; then the losses of 3 Momentum steps with
    CrossEntropyLoss within 2e-3 and ResNet's running statistics within
    1e-2 relative L2.  ResNet-18's loss falls from 3.9 to 0.08 in those
    3 steps at batch 8, and cuDNN's f32 convs round otherwise than the
    CPU's: measured on the H100, its losses differ by 5.9e-4 at step 3
    (within 1e-4 at steps 1 and 2)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import models as V

    rs = np.random.RandomState(0)
    imgs = torch.from_numpy(rs.randn(batch, 3, size, size).astype(
        np.float32))
    labels = torch.from_numpy(rs.randint(0, 10, (batch,)).astype(np.int32))
    cpu = getattr(V, name)(**kw, device="cpu", seed=3)
    gpu = getattr(V, name)(**kw, seed=3)
    init = {k: v.clone() for k, v in cpu.state_dict().items()}
    gpu.load_state_dict(init)
    grads = []
    for model in (gpu, cpu):
        model.train()
        dev = next(model.parameters()).device
        K.reset_launches()
        loss = nn.CrossEntropyLoss()(model(imgs.to(dev)), labels.to(dev))
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    top = max(g.abs().max().item() for g in grads[1])
    for n, a, b in zip(dict(cpu.named_parameters()), *grads):
        err = (a.cpu() - b).abs().max().item()
        assert err <= 1e-4 * max(b.abs().max().item(), 1e-3 * top), (n, err)
    for model in (gpu, cpu):                 # undo the running update
        model.load_state_dict(init)
    losses, counts = [], []
    for model in (gpu, cpu):
        K.reset_launches()
        step = build_train_step(model, Momentum(learning_rate=1e-3,
                                                momentum=0.9),
                                nn.CrossEntropyLoss())
        losses.append(step.run_steps(imgs, labels, repeat=3).cpu())
        counts.append(K.launch_counts())
    assert counts[0][kernel] == 3 * per_step
    if kernel == "window_attention":
        assert counts[0]["window_attention_bwd"] == 3 * per_step
    assert not any(counts[1].values())
    torch.testing.assert_close(losses[0], losses[1], atol=2e-3, rtol=0)
    for (n, a), b in zip(gpu.named_buffers(), cpu.buffers()):
        if n.endswith(("_mean", "_variance")):
            err = ((a.cpu() - b).norm() / b.norm()).item()
            assert err <= 1e-2, (n, err)


# --------------------------------------------- packed (varlen) attention
def _packing(lens):
    return torch.tensor([0] + np.cumsum(lens).tolist(), dtype=torch.int32,
                        device="cuda")


VARLEN_CASES = {
    # (q lengths, k lengths or None for the same packing, H, D)
    "ragged": ([1, 7, 64, 0, 100, 33], None, 4, 64),
    "long_and_short": ([300, 1, 2, 45], None, 2, 128),
    "unequal": ([5, 40, 17], [9, 3, 70], 3, 32),
    "no_key_rows": ([3, 6, 4], [5, 0, 9], 2, 64),
    # the bf16 core's 64-row tiles straddled by segments, head dims
    # padded to 16 and the widest
    "tile_edges": ([63, 64, 65, 130], None, 3, 40),
    "d72_unequal": ([65, 63], [130, 64], 2, 72),
    "d8": ([64, 3, 65], None, 2, 8),
    "d256": ([1, 130, 64], None, 2, 256),
}


def _varlen_inputs(case, dtype, seed=0):
    lq, lk, h, d = VARLEN_CASES[case]
    lk = lk or lq
    g = torch.Generator(device="cuda").manual_seed(seed + len(lq))
    q = _randn(g, sum(lq), h, d, dtype=dtype)
    k = _randn(g, sum(lk), h, d, dtype=dtype)
    v = _randn(g, sum(lk), h, d, dtype=dtype)
    return q, k, v, _packing(lq), _packing(lk), lk


@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
@pytest.mark.parametrize("scale", [None, 0.17])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", sorted(VARLEN_CASES))
def test_varlen_matches_plain(case, causal, scale, dtype):
    q, k, v, cq, ck, _ = _varlen_inputs(case, dtype)
    if causal and not torch.equal(cq, ck):
        pytest.skip("causal needs equal packings (flash_attn_unpadded "
                    "refuses the rest)")
    out, lse = VA.varlen_fwd(q, k, v, cq, ck, scale=scale, causal=causal)
    ref_out, ref_lse = VA.varlen_fwd_reference(q, k, v, cq, ck, scale,
                                               causal)
    _close(out, ref_out, dtype)
    _close(lse, ref_lse, torch.float32)
    dout = torch.randn_like(q)
    got = VA.varlen_bwd(q, k, v, out, lse, dout, cq, ck, scale, causal)
    want = VA.varlen_bwd_reference(q, k, v, out, lse, dout, cq, ck, scale,
                                   causal)
    _close_grads(got, want, dtype)


def test_varlen_rows_with_no_key_are_zero_and_finite():
    q, k, v, cq, ck, _ = _varlen_inputs("no_key_rows", torch.float32)
    out, lse = VA.varlen_fwd(q, k, v, cq, ck)
    assert torch.isfinite(lse).all()
    assert out[3:9].abs().max().item() == 0.0      # segment 1 sees no key
    dq, dk, dv = VA.varlen_bwd(q, k, v, out, lse, torch.randn_like(q), cq,
                               ck)
    assert dq[3:9].abs().max().item() == 0.0
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))


def test_varlen_matches_dense_flash_per_sequence():
    """An independent check: each sequence of the packed batch through
    the dense flash kernel equals its rows of the packed kernel."""
    q, k, v, cq, _, _ = _varlen_inputs("ragged", torch.float32)
    out, _ = VA.varlen_fwd(q, k, v, cq, cq, causal=True)
    b = cq.tolist()
    for i in range(len(b) - 1):
        if b[i + 1] == b[i]:
            continue
        s = slice(b[i], b[i + 1])
        dense, _ = FA.flash_fwd(q[None, s], k[None, s], v[None, s],
                                causal=True)
        _close(out[s], dense[0], torch.float32)


def test_flash_attn_unpadded_grad_matches_autograd_of_plain():
    from paddle_tpu_torch.nn.functional import flash_attn_unpadded

    q, k, v, cq, ck, _ = _varlen_inputs("ragged", torch.float32, seed=3)
    g = torch.randn_like(q)
    grads = []
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        out, none = flash_attn_unpadded(*leaves, cq.to(dev), ck.to(dev),
                                        64, 64, None, causal=True)
        assert none is None
        (out * g.to(dev)).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        _close(a.cpu(), b, torch.float32)


# ------------------------------------------------------------ fused norm
@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("rows,d,w,b,bias,res", [
    (37, 768, True, True, False, False),     # ernie_base, odd rows
    (8, 2048, True, True, True, True),       # gpt_1p3b width, all operands
    (5, 1000, True, False, True, True),      # odd d, RMS with bias + res
    (3, 1, False, False, False, True),       # one feature
    (2, 20000, True, True, False, False),    # past 48 KB of shared memory
    (4, 96, False, True, True, False),
    (64, 768, True, True, False, False),     # a warp a row (vector path)
    (19, 2048, True, True, True, True),      # 2 warps a row, all operands
    (9, 4096, True, False, True, True),      # llama_7b width
    (5, 8192, True, True, False, True),      # 70B width: 8 warps a row
])
def test_fused_norm_matches_plain(rows, d, w, b, bias, res, kind, dtype):
    g = torch.Generator(device="cuda").manual_seed(rows * 13 + d)
    x = _randn(g, rows, d, dtype=dtype) * 3 + 1
    ops = dict(w=_randn(g, d, dtype=torch.float32) if w else None,
               b=_randn(g, d, dtype=dtype) if b else None,
               bias=_randn(g, d, dtype=dtype) if bias else None,
               residual=_randn(g, rows, d, dtype=dtype) if res else None)
    if ops["b"] is not None and ops["w"] is not None:
        ops["b"] = ops["b"].float()
    y, z = FN.fused_norm(x, **ops, eps=1e-5, kind=kind)
    ry, rz = FN.fused_norm_reference(x, **ops, eps=1e-5, kind=kind)
    if dtype == torch.float16:
        # f16 rounds |y| up to ~16 here, where one ulp exceeds 1e-2:
        # held relative to the largest |y| (as chip_smoke.py holds it)
        _close_grads([y], [ry], dtype)
    else:
        _close(y, ry, dtype)
    if bias or res:
        assert torch.equal(z, rz)          # the same rounded adds
    else:
        assert z is None and rz is None


@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
@pytest.mark.parametrize("d,vector", [(768, True), (1000, True),
                                      (2048, True), (3, False)])
def test_fused_norm_dispatch_by_shape_and_alignment(d, vector, dtype):
    """Rows of 16-byte multiples at aligned pointers go to the vector
    kernel (`fused_norm_rows`); a row that is not (d = 3: 6 or 12 bytes),
    or the same tensor read from a slice that starts one element past
    alignment (still contiguous), goes to the scalar kernel
    (`fused_norm_kernel`).  Both match the plain version, z bit for
    bit."""
    g = torch.Generator(device="cuda").manual_seed(d)
    rows = 33
    flat = _randn(g, rows * d + 1, dtype=dtype)
    w, b = _randn(g, d, dtype=dtype), _randn(g, d, dtype=dtype)
    res = _randn(g, rows, d, dtype=dtype)
    aligned = flat[:rows * d].view(rows, d)
    skewed = flat[1:].view(rows, d)       # a contiguous odd-offset slice
    assert skewed.is_contiguous()
    for x, want in ((aligned, vector), (skewed, False)):
        (y, z), names = _launched(
            lambda: FN.fused_norm(x, w, b, None, res, eps=1e-5, kind="ln"))
        kernel = "fused_norm_rows" if want else "fused_norm_kernel"
        assert any(kernel in n for n in names), names
        ry, rz = FN.fused_norm_reference(x, w, b, None, res, eps=1e-5,
                                         kind="ln")
        if dtype == torch.float16:      # relative, as above
            _close_grads([y], [ry], dtype)
        else:
            _close(y, ry, dtype)
        assert torch.equal(z, rz)


@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_fused_norm_grad_is_the_plain_backward(kind):
    g = torch.Generator(device="cuda").manual_seed(5)
    x = _randn(g, 6, 256, dtype=torch.float32)
    w, b, bias = (_randn(g, 256, dtype=torch.float32) for _ in range(3))
    res = _randn(g, 6, 256, dtype=torch.float32)
    gy, gz = _randn(g, 6, 256, dtype=torch.float32), \
        _randn(g, 6, 256, dtype=torch.float32)
    grads = []
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_()
                  for t in (x, w, b, bias, res)]
        y, z = FN.FusedNorm.apply(*leaves, 1e-6, kind)
        ((y * gy.to(dev)).sum() + (z * gz.to(dev)).sum()).backward()
        grads.append([t.grad for t in leaves])
    for a, r in zip(*grads):
        _close(a.cpu(), r, torch.float32)


# ------------------------------------------ decode at GQA groups above 8
@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
@pytest.mark.parametrize("hq,hkv", [(32, 2), (12, 1)])
def test_decode_kernels_serve_gqa_groups_above_eight(hq, hkv, dtype):
    g = torch.Generator(device="cuda").manual_seed(hq)
    b, s, d = 3, 200, 128
    q = _randn(g, b, hq, d, dtype=dtype)
    kc = _randn(g, b, hkv, s, d, dtype=dtype)
    vc = _randn(g, b, hkv, s, d, dtype=dtype)
    pos = torch.tensor([199, 7, 100], dtype=torch.int32, device="cuda")
    start = torch.tensor([10, 0, 100], dtype=torch.int32, device="cuda")
    _close(DA.decode_attention(q, kc, vc, pos, start),
           DA.decode_attention_reference(q, kc, vc, pos, start), dtype)
    ps, npool = 16, 40
    kp = _randn(g, npool, hkv, ps, d, dtype=dtype)
    vp = _randn(g, npool, hkv, ps, d, dtype=dtype)
    pt = torch.randperm(npool - 1, generator=g, device="cuda")[:3 * 13] \
        .reshape(3, 13).int() + 1
    _close(PA.paged_attention(q, kp, vp, pt, pos),
           PA.paged_attention_reference(q, kp, vp, pt, pos), dtype)


# ------------------------------------------------ incubate fused layers
@pytest.mark.parametrize("name", ["FusedMultiTransformer",
                                  "FusedTransformerEncoderLayer"])
def test_incubate_layers_on_the_card_match_cpu(name):
    from paddle_tpu_torch.incubate import nn as inn

    kw = dict(num_layers=2) if name == "FusedMultiTransformer" else \
        dict(dropout_rate=0.0)
    cpu = getattr(inn, name)(128, 4, 256, **kw, device="cpu", seed=1)
    gpu = getattr(inn, name)(128, 4, 256, **kw, seed=1)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 40, 128)
    K.reset_launches()
    if name == "FusedMultiTransformer":
        gpu.eval(), cpu.eval()
        _close(gpu(x.cuda()).cpu(), cpu(x), torch.float32)
        assert K.launch_counts()["fused_norm"] == 4
        assert K.launch_counts()["flash_fwd"] == 2
    else:
        gpu.train(), cpu.train()
        outs = [m(x.to(dev)) for m, dev in ((gpu, "cuda"), (cpu, "cpu"))]
        _close(outs[0].cpu(), outs[1], torch.float32)
        gy = torch.randn(outs[1].shape)
        for o in outs:
            (o * gy.to(o.device)).mean().backward()
        for (n, a), b in zip(gpu.named_parameters(), cpu.parameters()):
            if b.grad is None:     # post-LN: the pre-LN scales are unread
                assert a.grad is None, n
                continue
            err = (a.grad.cpu() - b.grad).abs().max().item()
            assert err <= 1e-4 * max(1.0, b.grad.abs().max().item()), n
        assert K.launch_counts()["fused_norm"] == 2
        assert K.launch_counts()["flash_bwd"] == 1
    K.reset_launches()


# ------------------------------------------------ int8 paged attention
def _int8_pools(g, npool, hkv, ps, d):
    from paddle_tpu_torch.ops.quant import quantize_vectors

    kq, ks = quantize_vectors(_randn(g, npool, hkv, ps, d,
                                     dtype=torch.float32) * 2)
    vq, vs = quantize_vectors(_randn(g, npool, hkv, ps, d,
                                     dtype=torch.float32))
    return kq, vq, ks, vs


@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
@pytest.mark.parametrize("ps", [8, 16, 32])
@pytest.mark.parametrize("hq,hkv,d", [(4, 4, 128), (8, 2, 64), (32, 2, 128),
                                      (6, 2, 256), (3, 1, 48)])
def test_paged_attention_int8_matches_plain(hq, hkv, d, ps, dtype):
    """Groups 1, 4, 16 (two chunks of 8 query heads) and 3; head_dims 48
    (three of four lanes per row), 64, 128, 256; a page crossing, an
    exact page end, pos 0, the full table and a free slot on the scratch
    page."""
    g = torch.Generator(device="cuda").manual_seed(hq * 31 + d + ps)
    npool, p = 24, 64 // ps + 1
    q = _randn(g, 5, hq, d, dtype=dtype)
    kq, vq, ks, vs = _int8_pools(g, npool, hkv, ps, d)
    pt = torch.zeros(5, p, dtype=torch.int32, device="cuda")
    perm = torch.randperm(npool - 1, generator=g, device="cuda") + 1
    pos = torch.tensor([ps + 3, 2 * ps - 1, 0, p * ps - 1, 0],
                       dtype=torch.int32, device="cuda")
    used = 0
    for r in range(4):
        n = int(pos[r]) // ps + 1
        pt[r, :n] = perm[used:used + n].int()
        used += n
    K.reset_launches()
    got = PA.paged_attention(q, kq, vq, pt, pos, k_scales=ks, v_scales=vs)
    assert K.launch_counts()["paged_attention_int8"] == 1
    assert K.launch_counts()["paged_attention"] == 0
    K.reset_launches()
    assert got.dtype == dtype
    _close(got, PA.paged_attention_reference(q, kq, vq, pt, pos, ks, vs),
           dtype)


def test_int8_codec_on_the_card_equals_cpu():
    """quantize_vectors on the card bit for bit as on the CPU: codes and
    scales (a true f32 division absmax / 127, not a reciprocal product),
    all-zero vectors and saturation included."""
    from paddle_tpu_torch.ops.quant import quantize_vectors

    g = torch.Generator(device="cuda").manual_seed(11)
    x = _randn(g, 64, 32, 128, dtype=torch.float32) * 3
    x[0, 0] = 0
    x[1, 1, 5] = 1e4
    for dtype in DTYPES:
        got = quantize_vectors(x.to(dtype))
        want = quantize_vectors(x.to(dtype).cpu())
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


def test_tiny_int8_engine_on_the_card_matches_cpu():
    """kv_precision="int8" on the card: streams bit-stable run to run and
    equal to the CPU int8 engine's (the plain versions), first tokens
    equal to greedy, the int8 kernel and never the bf16/f32 one."""
    from paddle_tpu_torch.inference.engine import (
        EngineConfig, InferenceEngine,
    )
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                    num_heads=4, max_seq_len=64)        # head_dim 16
    cpu = GPTForCausalLM(cfg, device="cpu", seed=2)
    gpu = GPTForCausalLM(cfg, seed=2)
    gpu.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, 128, (n,)).astype(np.int32)
               for n in (3, 9, 17, 5)]
    ecfg = EngineConfig(page_size=8, max_slots=2, max_seq_len=64,
                        kv_precision="int8")
    want = InferenceEngine(cpu, ecfg).generate(prompts, max_new_tokens=8)
    K.reset_launches()
    runs = [InferenceEngine(gpu, ecfg).generate(prompts, max_new_tokens=8)
            for _ in range(2)]
    counts = K.launch_counts()
    K.reset_launches()
    assert counts["paged_attention_int8"] > 0
    assert counts["paged_attention"] == 0
    for w, a, b, p in zip(want, *runs, prompts):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, w)
        ref = gpu.generate(p[None], max_new_tokens=1).cpu().numpy()[0]
        np.testing.assert_array_equal(a[:p.size + 1], ref)


# ------------------------------------------------ relayout and kv tier
@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
@pytest.mark.parametrize("shape", [(8, 1024, 12, 64), (2, 37, 3, 128),
                                   (1, 5, 7, 12), (3, 9, 2, 9)])
def test_relayout_matches_plain(shape, dtype):
    """16-byte rows, 4-byte rows (D 12 in bf16 / f32 ... 24 / 48 bytes)
    and 2-byte units (D 9 in bf16); both directions and the adjoints."""
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    x = _randn(g, *shape, dtype=dtype)
    xt = _randn(g, shape[0], shape[2], shape[1], shape[3], dtype=dtype)
    assert torch.equal(RL.to_head_major(x), RL.to_head_major_reference(x))
    assert torch.equal(RL.from_head_major(xt),
                       RL.from_head_major_reference(xt))
    leaf = x.clone().requires_grad_()
    (grad,) = torch.autograd.grad(RL.ToHeadMajor.apply(leaf), leaf, xt)
    assert torch.equal(grad, RL.from_head_major_reference(xt))
    leaf = xt.clone().requires_grad_()
    (grad,) = torch.autograd.grad(RL.FromHeadMajor.apply(leaf), leaf, x)
    assert torch.equal(grad, RL.to_head_major_reference(x))


@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,d", [
    (2, 64, 64, 4, 4, 64), (1, 45, 70, 6, 2, 128), (2, 128, 128, 12, 4, 32),
])
def test_flash_head_major_bit_equal_to_native(b, sq, sk, hq, hkv, d, causal,
                                              dtype):
    g = torch.Generator(device="cuda").manual_seed(sq + hq + d)
    q = _randn(g, b, sq, hq, d, dtype=dtype)
    k = _randn(g, b, sk, hkv, d, dtype=dtype)
    v = _randn(g, b, sk, hkv, d, dtype=dtype)
    dout = _randn(g, b, sq, hq, d, dtype=dtype)
    out, lse = FA.flash_fwd(q, k, v, causal=causal)
    q_t = q.transpose(1, 2).contiguous()
    out_t, lse_t = FA.flash_fwd(q_t, k, v, causal=causal, head_major=True)
    assert torch.equal(out_t, out.transpose(1, 2))
    assert torch.equal(lse_t, lse)
    dq, dk, dv = FA.flash_bwd(q, k, v, out, lse, dout, causal=causal)
    dq_t, dk_t, dv_t = FA.flash_bwd(q_t, k, v, out_t, lse_t,
                                    dout.transpose(1, 2).contiguous(),
                                    causal=causal, head_major=True)
    assert torch.equal(dq_t, dq.transpose(1, 2))
    assert torch.equal(dk_t, dk) and torch.equal(dv_t, dv)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_flash_kv_tier_bit_equal_to_native_and_launches(hq, hkv,
                                                        monkeypatch):
    """`FlashAttentionKV` against `FlashAttention` bit for bit, forward
    and gradients, with 2 + 2 relayout launches per call; and
    scaled_dot_product_attention under FLAGS_flash_layout=kv takes it."""
    from paddle_tpu_torch.nn import functional as F

    g = torch.Generator(device="cuda").manual_seed(hq * 10 + hkv)
    q = _randn(g, 2, 96, hq, 64, dtype=torch.float32)
    k = _randn(g, 2, 96, hkv, 64, dtype=torch.float32)
    v = _randn(g, 2, 96, hkv, 64, dtype=torch.float32)
    w = _randn(g, 2, 96, hq, 64, dtype=torch.float32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    K.reset_launches()
    out = FA.FlashAttentionKV.apply(*leaves, True)
    grads = torch.autograd.grad((out * w).sum(), leaves)
    counts = K.launch_counts()
    assert (counts["relayout_to_hm"], counts["relayout_from_hm"],
            counts["flash_fwd"], counts["flash_bwd"]) == (2, 2, 1, 1)
    native = FA.FlashAttention.apply(*leaves, None, True)
    ngrads = torch.autograd.grad((native * w).sum(), leaves)
    assert torch.equal(out, native)
    for a, b in zip(grads, ngrads):
        assert torch.equal(a, b)
    monkeypatch.setenv("FLAGS_flash_layout", "kv")
    K.reset_launches()
    assert torch.equal(F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=True),
                       native.detach())
    assert K.launch_counts()["relayout_to_hm"] == 1
    K.reset_launches()


@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
def test_flash_kernels_rerun_bit_identical(dtype):
    """No atomics in either core: two runs of the forward and the
    backward give the same bits, dense and biased (GQA 12/4, causal,
    ragged tiles) and packed."""
    g = torch.Generator(device="cuda").manual_seed(5)
    q, dout = (_randn(g, 2, 130, 12, 64, dtype=dtype) for _ in range(2))
    k, v = (_randn(g, 2, 130, 4, 64, dtype=dtype) for _ in range(2))
    bias = _randn(g, 2, 1, 130, 130, dtype=torch.float32)
    for m in (None, bias):
        runs = []
        for _ in range(2):
            out, lse = FA.flash_fwd(q, k, v, bias=m, causal=True)
            runs.append((out, lse) + FA.flash_bwd(q, k, v, out, lse, dout,
                                                  bias=m, causal=True))
        assert all(torch.equal(a, b) for a, b in zip(*runs))
    q, k, v, cq, ck, _ = _varlen_inputs("tile_edges", dtype)
    dout = torch.randn_like(q)
    runs = []
    for _ in range(2):
        out, lse = VA.varlen_fwd(q, k, v, cq, ck, causal=True)
        runs.append((out, lse) + VA.varlen_bwd(q, k, v, out, lse, dout, cq,
                                               ck, causal=True))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ----------------------------- exact-tier decode: keys split on a cluster
def _dec_split():
    """DEC_SPLIT and DEC_STAGE_BYTES / DEC_THREADS of csrc/decode_common.cuh,
    read from the source (the kernels' compile-time constants)."""
    import os
    import re

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "paddle_tpu_torch", "csrc",
        "decode_common.cuh")
    with open(path) as f:
        return {n: int(v) for n, v in re.findall(
            r"constexpr int (DEC_\w+) = (\d+);", f.read())}


def _dec_tile(dtype, d):
    """Keys a tile of `DecTile` at head dim d (a lane reads 16 bytes of a
    row, 8 of int8 codes)."""
    c = _dec_split()
    elem = torch.empty((), dtype=dtype).element_size()
    chp = 1
    while chp < d * elem // 16:
        chp *= 2
    rpw = 32 // min(chp * (2 if elem == 1 else 1), 32)
    stage = c["DEC_Q8_STAGE_BYTES" if elem == 1 else "DEC_STAGE_BYTES"]
    return max(min(stage // (2 * 16 * chp), 64), c["DEC_THREADS"] // 32 * rpw,
               c["DEC_THREADS"] // chp)


def _edge_lengths(dtype, d, ps):
    """Key counts at, under and just over the split's and the pages'
    boundaries: one key (every split but the first empty), fewer keys
    than CTAs, a tile, a share of whole tiles per CTA, pages."""
    split, tk = _dec_split()["DEC_SPLIT"], _dec_tile(dtype, d)
    return sorted({1, 2, split - 1, split, split + 1, tk - 1, tk, tk + 1,
                   split * tk - 1, split * tk, split * tk + 1, ps - 1, ps,
                   ps + 1, 3 * ps, 3 * ps + 1, 2 * split * tk + 5})


def _shuffled_pages(g, lens, hkv, d, ps, dtype, free_slots=1):
    """Pools over distinct shuffled pages for rows of `lens` keys, plus
    `free_slots` rows on scratch page 0 with pos 0."""
    p = max(-(-n // ps) for n in lens)
    npool = len(lens) * p + 1
    kp = _randn(g, npool, hkv, ps, d, dtype=dtype)
    vp = _randn(g, npool, hkv, ps, d, dtype=dtype)
    pt = torch.zeros(len(lens) + free_slots, p, dtype=torch.int32,
                     device="cuda")
    perm = torch.randperm(npool - 1, generator=g, device="cuda") + 1
    used = 0
    for r, n in enumerate(lens):
        k = -(-n // ps)
        pt[r, :k] = perm[used:used + k].int()
        used += k
    pos = torch.tensor(list(lens) + [1] * free_slots, dtype=torch.int32,
                       device="cuda") - 1
    return kp, vp, pt, pos


@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (12, 1), (32, 2)])
def test_paged_attention_split_edges_match_plain(hq, hkv, d, dtype):
    g = torch.Generator(device="cuda").manual_seed(hq + d)
    ps = 16
    lens = _edge_lengths(dtype, d, ps)
    kp, vp, pt, pos = _shuffled_pages(g, lens, hkv, d, ps, dtype)
    q = _randn(g, len(pos), hq, d, dtype=dtype)
    before = PA.launches
    _close(PA.paged_attention(q, kp, vp, pt, pos),
           PA.paged_attention_reference(q, kp, vp, pt, pos), dtype)
    assert PA.launches == before + 1


@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (12, 1), (32, 2)])
def test_decode_attention_split_edges_match_plain(hq, hkv, d, dtype):
    """The same key counts as rows start..pos of a dense cache, left
    padded (start > 0) and not, and pos 0."""
    g = torch.Generator(device="cuda").manual_seed(hq * 3 + d)
    lens = _edge_lengths(dtype, d, 16)
    s = max(lens) + 24
    b = len(lens)
    q = _randn(g, b, hq, d, dtype=dtype)
    kc = _randn(g, b, hkv, s, d, dtype=dtype)
    vc = _randn(g, b, hkv, s, d, dtype=dtype)
    start = torch.tensor([(7 * i) % (s - n + 1) for i, n in enumerate(lens)],
                         dtype=torch.int32, device="cuda")
    pos = start + torch.tensor(lens, dtype=torch.int32, device="cuda") - 1
    for st in (start, None):
        p = pos if st is not None else pos - start
        _close(DA.decode_attention(q, kc, vc, p, st),
               DA.decode_attention_reference(q, kc, vc, p, st), dtype)


@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("hq,hkv", [(32, 32), (32, 4)])
def test_paged_equals_dense_decode_bit_for_bit(hq, hkv, d, dtype):
    """The split counts keys from the first valid one and depends on
    nothing else, and both kernels share every step after the copy: the
    paged kernel over a shuffled page table and the dense kernel over the
    same keys gathered into a cache give the same bits, with start = 0
    and with the keys shifted right (start > 0)."""
    g = torch.Generator(device="cuda").manual_seed(d + hkv)
    ps = 16
    lens = _edge_lengths(dtype, d, ps)
    kp, vp, pt, pos = _shuffled_pages(g, lens, hkv, d, ps, dtype,
                                      free_slots=0)
    q = _randn(g, len(lens), hq, d, dtype=dtype)
    paged = PA.paged_attention(q, kp, vp, pt, pos)
    b, p = pt.shape
    k = kp[pt.long()].transpose(1, 2).reshape(b, hkv, p * ps, d)
    v = vp[pt.long()].transpose(1, 2).reshape(b, hkv, p * ps, d)
    assert torch.equal(DA.decode_attention(q, k.contiguous(), v.contiguous(),
                                           pos), paged)
    shift = 13
    ks = torch.cat([_randn(g, b, hkv, shift, d, dtype=dtype), k], 2)
    vs = torch.cat([_randn(g, b, hkv, shift, d, dtype=dtype), v], 2)
    start = torch.full((b,), shift, dtype=torch.int32, device="cuda")
    assert torch.equal(DA.decode_attention(q, ks, vs, pos + shift, start),
                       paged)


@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
def test_decode_kernels_alone_equal_in_a_batch_and_rerun(dtype):
    """A sequence's output does not depend on the rest of the batch (the
    split is its own), and two runs give the same bits (no atomics)."""
    g = torch.Generator(device="cuda").manual_seed(21)
    hq, hkv, d, ps = 32, 8, 128, 16
    lens = [1041, 3, 520, 77]
    kp, vp, pt, pos = _shuffled_pages(g, lens, hkv, d, ps, dtype,
                                      free_slots=0)
    q = _randn(g, 4, hq, d, dtype=dtype)
    batch = PA.paged_attention(q, kp, vp, pt, pos)
    assert torch.equal(PA.paged_attention(q, kp, vp, pt, pos), batch)
    for i in range(4):
        one = PA.paged_attention(q[i:i + 1].contiguous(), kp, vp,
                                 pt[i:i + 1].contiguous(),
                                 pos[i:i + 1].contiguous())
        assert torch.equal(one[0], batch[i])
    s = 1100
    kc, vc = (_randn(g, 4, hkv, s, d, dtype=dtype) for _ in range(2))
    start = torch.tensor([0, 30, 7, 500], dtype=torch.int32, device="cuda")
    dpos = torch.tensor([1040, 32, 526, 576], dtype=torch.int32,
                        device="cuda")
    batch = DA.decode_attention(q, kc, vc, dpos, start)
    assert torch.equal(DA.decode_attention(q, kc, vc, dpos, start), batch)
    for i in range(4):
        one = DA.decode_attention(q[i:i + 1].contiguous(),
                                  kc[i:i + 1].contiguous(),
                                  vc[i:i + 1].contiguous(),
                                  dpos[i:i + 1].contiguous(),
                                  start[i:i + 1].contiguous())
        assert torch.equal(one[0], batch[i])


@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
def test_exact_decode_wrappers_refuse_misaligned_caches(dtype):
    """The kernels copy K / V rows 16 bytes a lane: a pool or cache that
    does not start on a 16-byte boundary (a contiguous view at an odd
    offset) is refused before any launch."""
    d = 64
    flat = torch.zeros(2 * 2 * 16 * d + 1, device="cuda", dtype=dtype)
    bad = flat[1:].view(2, 2, 16, d)
    good = torch.zeros(2, 2, 16, d, device="cuda", dtype=dtype)
    q = torch.zeros(1, 2, d, device="cuda", dtype=dtype)
    table = torch.ones(1, 1, dtype=torch.int32, device="cuda")
    pos = torch.zeros(1, dtype=torch.int32, device="cuda")
    before = (PA.launches, DA.launches)
    with pytest.raises(ValueError, match="16-byte"):
        PA.paged_attention(q, bad, good, table, pos)
    with pytest.raises(ValueError, match="16-byte"):
        PA.paged_attention(q, good, bad, table, pos)
    cache = flat[1:1 + 2 * 16 * d].view(1, 2, 16, d)
    with pytest.raises(ValueError, match="16-byte"):
        DA.decode_attention(q, cache, good[:1].contiguous(), pos)
    assert (PA.launches, DA.launches) == before


# ------------------------------ int8 decode: the same cluster split
def _int8_shuffled_pages(g, lens, hkv, d, ps, free_slots=1):
    """`_shuffled_pages`'s table and positions over int8 pools (codes and
    f32 scales from the codec), plus the scale tables copied to views
    that start 4 bytes off a 16-byte boundary (the 4-byte scale copies)."""
    kp, vp, pt, pos = _shuffled_pages(g, lens, hkv, d, ps, torch.float32,
                                      free_slots)
    kq, vq, ks, vs = _int8_pools(g, kp.shape[0], hkv, ps, d)
    off = []
    for t in (ks, vs):
        flat = torch.empty(t.numel() + 1, device="cuda")
        view = flat[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16
        off.append(view)
    return kq, vq, ks, vs, off, pt, pos


@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
@pytest.mark.parametrize("ps", [8, 16, 32, 6])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (12, 1), (32, 2)])
def test_paged_attention_int8_split_edges_match_plain(hq, hkv, d, ps, dtype):
    """Key counts at, under and just over the int8 tiles, the shares and
    the pages (pos 0 and fewer keys than the cluster's CTAs among them)
    and a free slot on scratch page 0; pages of 8, 16, 32 and 6 (whose
    scales cannot move four rows a copy), and scale tables off a 16-byte
    boundary: both scale copies give the same bits."""
    g = torch.Generator(device="cuda").manual_seed(hq + d + ps)
    split, tk = _dec_split()["DEC_SPLIT"], _dec_tile(torch.int8, d)
    lens = sorted({1, 2, split - 1, split + 1, tk - 1, tk, tk + 1,
                   split * tk, split * tk + 1, ps - 1, ps, ps + 1, 3 * ps + 1,
                   2 * split * tk + 5} - {0})
    kq, vq, ks, vs, off, pt, pos = _int8_shuffled_pages(g, lens, hkv, d, ps)
    q = _randn(g, len(pos), hq, d, dtype=dtype)
    before = (PA.launches, PA.int8_launches)
    got = PA.paged_attention(q, kq, vq, pt, pos, k_scales=ks, v_scales=vs)
    assert (PA.launches, PA.int8_launches) == (before[0], before[1] + 1)
    _close(got, PA.paged_attention_reference(q, kq, vq, pt, pos, ks, vs),
           dtype)
    assert torch.equal(PA.paged_attention(q, kq, vq, pt, pos,
                                          k_scales=off[0], v_scales=off[1]),
                       got)


@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
def test_paged_attention_int8_alone_equal_in_a_batch_and_rerun(dtype):
    """A sequence's int8 output does not depend on the rest of the batch
    (its split is its own), and two runs give the same bits."""
    g = torch.Generator(device="cuda").manual_seed(23)
    hq, hkv, d, ps = 32, 8, 128, 16
    lens = [1041, 3, 520, 77]
    kq, vq, ks, vs, _, pt, pos = _int8_shuffled_pages(g, lens, hkv, d, ps,
                                                      free_slots=0)
    q = _randn(g, 4, hq, d, dtype=dtype)
    batch = PA.paged_attention(q, kq, vq, pt, pos, k_scales=ks, v_scales=vs)
    assert torch.equal(PA.paged_attention(q, kq, vq, pt, pos, k_scales=ks,
                                          v_scales=vs), batch)
    for i in range(4):
        one = PA.paged_attention(q[i:i + 1].contiguous(), kq, vq,
                                 pt[i:i + 1].contiguous(),
                                 pos[i:i + 1].contiguous(), k_scales=ks,
                                 v_scales=vs)
        assert torch.equal(one[0], batch[i])


# ------------------------------------- rope: q and k in one launch
@pytest.mark.parametrize("dtype", DTYPES16, ids=str)
@pytest.mark.parametrize("b,s,hq,hkv,d", [
    (4, 1, 32, 32, 128),     # llama_7b decode: heads split across blocks
    (1, 67, 32, 8, 128),     # GQA prefill rows
    (3, 5, 12, 1, 64),       # MQA
    (2, 9, 4, 2, 12),        # scalar pairs (D/2 off the 16-byte vector)
])
def test_paired_rope_equals_two_single_calls(b, s, hq, hkv, d, dtype):
    """One launch for q and k (strided views of a fused qkv projection,
    per-row phases) equals the two single-tensor launches and the plain
    version bit for bit, neox and interleaved, forward and adjoint, and
    counts one launch."""
    g = torch.Generator(device="cuda").manual_seed(b * s + hq + d)
    qkv = _randn(g, b, s, (hq + 2 * hkv) * d, dtype=dtype)
    q, k, _ = qkv.split([hq * d, hkv * d, hkv * d], dim=-1)
    q, k = q.reshape(b, s, hq, d), k.reshape(b, s, hkv, d)
    cos, sin = _phases(g, b, s, d, dtype)
    for adjoint in (False, True):
        for inter in (False, True):
            K.reset_launches()
            pq, pk = RP.rope(q, cos, sin, adjoint, inter, k=k)
            counts = K.launch_counts()
            assert (counts["rope"], counts["rope_bwd"]) == (
                (0, 1) if adjoint else (1, 0))
            for x, got in ((q, pq), (k, pk)):
                assert got.is_contiguous() and got.shape == x.shape
                assert torch.equal(got, RP.rope(x, cos, sin, adjoint, inter))
                assert torch.equal(got, RP.rope_reference(x, cos, sin,
                                                          adjoint, inter))
    K.reset_launches()


def test_paired_rope_grads_are_the_single_tensor_grads():
    """`RoPE` over q and k: one forward and one adjoint launch, gradients
    bit for bit those of `RoPE` on each tensor alone."""
    g = torch.Generator(device="cuda").manual_seed(8)
    b, s, hq, hkv, d = 2, 11, 8, 2, 64
    q = _randn(g, b, s, hq, d, dtype=torch.float32).requires_grad_()
    k = _randn(g, b, s, hkv, d, dtype=torch.float32).requires_grad_()
    cos, sin = _phases(g, b, s, d, torch.float32)
    dq, dk = (_randn(g, *x.shape, dtype=torch.float32) for x in (q, k))
    K.reset_launches()
    oq, ok = RP.RoPE.apply(q, cos, sin, False, k)
    got = torch.autograd.grad((oq, ok), (q, k), (dq, dk))
    assert K.launch_counts()["rope"] == K.launch_counts()["rope_bwd"] == 1
    for x, gx, want in ((q, dq, got[0]), (k, dk, got[1])):
        (one,) = torch.autograd.grad(RP.RoPE.apply(x, cos, sin), x, gx)
        assert torch.equal(one, want)
    K.reset_launches()


# ------------------------------- CUDA graphs: the fixed-shape programs
def _tiny_gpt(dtype, fused_head_ce=False, seed=3):
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                    num_heads=4, max_seq_len=64, fused_head_ce=fused_head_ce)
    return GPTForCausalLM(cfg, dtype=dtype, seed=seed)


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_engine_decode_graph_replays_its_eager_body(kv, dtype):
    """The engine's decode program: one graph per (chunk, tier), its
    replays bit for bit its eager body from equal pools (the tokens and
    every pool and scale table), the paged kernel of the tier counted
    once a layer a replayed forward, and a rebound pool refused."""
    from paddle_tpu_torch.inference.engine import (
        EngineConfig, InferenceEngine,
    )

    model = _tiny_gpt(dtype)
    eng = InferenceEngine(model, EngineConfig(
        page_size=4, max_slots=3, max_seq_len=64, decode_chunk=2,
        kv_precision=kv))
    rs = np.random.RandomState(0)
    eng.generate([rs.randint(0, 128, (n,)).astype(np.int32)
                  for n in (3, 9)], max_new_tokens=5)
    assert list(eng._programs) == [(2, kv)]
    prog = eng._programs[(2, kv)]
    assert prog.graph is not None
    s_, p_ = 3, eng.max_pages_per_seq
    pt = (1 + np.arange(s_ * p_, dtype=np.int32)).reshape(s_, p_)
    tok0 = rs.randint(0, 128, s_).astype(np.int32)
    len0 = np.array([0, 17, 50], np.int32)
    pools = eng._pool_tensors()
    paged = "paged_attention_int8" if kv else "paged_attention"
    with torch.inference_mode():
        start = [p.clone() for p in pools]
        K.reset_launches()
        got = eng._run_decode(2, tok0, pt, len0)
        got = np.concatenate([got, eng._run_decode(2, got[:, -1].copy(),
                                                   pt, len0 + 2)], 1)
        counts = K.launch_counts()
        assert counts[paged] == 2 * 2 * 2 and sum(counts.values()) == \
            counts[paged]
        after = [p.clone() for p in pools]
        for p, s in zip(pools, start):
            p.copy_(s)
        want = []
        tok, lengths = tok0, len0
        for _ in range(2):
            toks = torch.zeros(s_, 2, dtype=torch.int32, device="cuda")
            eng._decode_body(2, *(torch.from_numpy(a).cuda()
                                  for a in (tok, pt, lengths)), toks)
            want.append(toks.cpu().numpy())
            tok, lengths = want[-1][:, -1].copy(), lengths + 2
        np.testing.assert_array_equal(got, np.concatenate(want, 1))
        assert all(torch.equal(a, p) for a, p in zip(after, pools))
        eng._k_pools[0] = eng._k_pools[0].clone()
        with pytest.raises(RuntimeError, match="rebound"):
            eng._run_decode(2, tok0, pt, len0)
    K.reset_launches()


def _train_state(step):
    with torch.no_grad():
        return [t.clone() for t in step._state_tensors()]


@pytest.mark.parametrize("amp", [None, "bfloat16"])
def test_train_step_graph_replays_its_eager_body(amp):
    """The train step: the first call of a batch signature runs the body
    and captures it (two model forwards in Python); `__call__` and
    `run_steps` then replay (none), bit for bit the eager body from an
    equal state
    (losses, parameters, slots, the step count), with the flash kernels
    counted once a layer a replay."""
    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    model = _tiny_gpt(torch.float32, fused_head_ce=True)
    step = build_train_step(model, AdamW(learning_rate=1e-3),
                            GPTPretrainingCriterion(model=model),
                            amp_dtype=amp)
    rs = np.random.RandomState(1)
    ids, labels = (torch.from_numpy(rs.randint(0, 128, (2, 40)).astype(
        np.int32)).cuda() for _ in range(2))
    calls = []
    hook = model.register_forward_hook(lambda *a: calls.append(1))
    step(ids, labels)
    step(ids, labels)
    start = _train_state(step)
    K.reset_launches()
    got = step.run_steps(ids, labels, repeat=3)
    counts = K.launch_counts()
    hook.remove()
    assert len(calls) == 2 and len(step._graphs) == 1
    assert counts["flash_fwd"] == counts["flash_bwd"] == 2 * 3
    after = _train_state(step)
    with torch.no_grad():
        for t, s in zip(step._state_tensors(), start):
            t.copy_(s)
    batch = step._place((ids, labels))
    want = torch.stack([step._step(batch) for _ in range(3)])
    assert torch.equal(got, want)
    assert all(torch.equal(a, t) for a, t in zip(after,
                                                 step._state_tensors()))
    K.reset_launches()


def test_train_step_captures_again_after_a_rebound_slot():
    """A slot rebound between steps drops the graph: the next step runs
    the body on the new tensor and captures again, and the steps equal
    those of a step whose slot was copied in place."""
    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    rs = np.random.RandomState(2)
    ids, labels = (torch.from_numpy(rs.randint(0, 128, (2, 40)).astype(
        np.int32)).cuda() for _ in range(2))
    losses = []
    for rebind in (False, True):
        model = _tiny_gpt(torch.float32, fused_head_ce=True)
        step = build_train_step(model, AdamW(learning_rate=1e-3),
                                GPTPretrainingCriterion(model=model))
        run = [step(ids, labels), step(ids, labels)]
        slots = step._state["slots"]["gpt.wte.weight"]
        if rebind:
            slots["moment1"] = slots["moment1"] * 0.5
        else:
            with torch.no_grad():
                slots["moment1"].mul_(0.5)
        graph = step._graphs[next(iter(step._graphs))][1]
        run += [step(ids, labels), step(ids, labels)]
        assert (step._graphs[next(iter(step._graphs))][1] is graph) \
            == (not rebind)
        losses.append(torch.stack(run))
    assert torch.equal(losses[0], losses[1])
    K.reset_launches()


def test_a_failed_capture_raises():
    """A body that waits on the host cannot be captured: the capture
    raises, and nothing runs the body instead."""
    from paddle_tpu_torch.core import graphs as GR

    x = torch.ones(4, device="cuda")
    stream = torch.cuda.Stream()
    GR.warm_up(lambda: x.sum().item(), stream)
    with pytest.raises(RuntimeError):
        GR.Graph(lambda: x.sum().item(), stream)
    torch.cuda.synchronize()


def _prefill_inputs(eng, prog, rs):
    """Random host inputs of a prefill program: ids, a pad of 3, its
    pages (distinct, the last the scratch page 0), and for a warm one a
    prefix 4 tokens short of its bucket on distinct pages."""
    ps, sb, npp = eng.config.page_size, prog.sb, prog.npp
    ids = rs.randint(0, 128, (1, sb)).astype(np.int32)
    npb = prog.pages.numel()
    pages = np.append(rs.permutation(npb - 1) + 1, 0).astype(np.int32)
    plen, prefix = 0, None
    if npp is not None:
        plen = npp * ps - 4
        prefix = np.append(np.arange(20, 20 + npp - 1), 0).astype(np.int32)
    return ids, 3, pages, plen, prefix


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_engine_prefill_graphs_replay_their_eager_bodies(kv, dtype):
    """The engine's prefill programs, cold and warm: one graph per
    (bucket, prefix bucket, tier), each replay bit for bit its eager
    body on the same static inputs from equal state: the first token,
    every pool and scale table without scratch page 0 (garbage by
    design: the pack writes it once per scratch entry), the int8 tier's
    staging buffers whole; flash_fwd counted once a layer a replay."""
    from paddle_tpu_torch.inference.engine import (
        EngineConfig, InferenceEngine,
    )

    model = _tiny_gpt(dtype)
    eng = InferenceEngine(model, EngineConfig(
        page_size=4, max_slots=2, max_seq_len=64, kv_precision=kv))
    rs = np.random.RandomState(4)
    shared = rs.randint(0, 128, (16,)).astype(np.int32)
    a, b = (np.concatenate([shared, rs.randint(0, 128, (n,)).astype(
        np.int32)]) for n in (3, 5))
    # b is admitted after a has committed its prefix: a warm prefill
    eng.generate([a, rs.randint(0, 128, (9,)).astype(np.int32), b],
                 max_new_tokens=3)
    assert eng.prefix_cache_stats()["hits"] >= 1
    assert {(sb, npp) for sb, npp, _ in eng._prefills} == \
        {(32, None), (16, None), (16, 4)}
    n_pools = len(eng._pool_tensors())
    state = eng._prefill_tensors()
    with torch.inference_mode():
        for prog in eng._prefills.values():
            assert prog.graph is not None
            inputs = _prefill_inputs(eng, prog, rs)
            if kv and prog.npp is not None:      # the sidecar's prefix
                for st in eng._stage_k + eng._stage_v:
                    st[:prog.npp].copy_(torch.randn_like(
                        st[:prog.npp], dtype=torch.float32))
            start = [t.clone() for t in state]
            eng._load_prefill(prog, *inputs)
            K.reset_launches()
            eng._replay_prefill(prog)
            assert K.launch_counts()["flash_fwd"] == 2
            got_tok, got = int(prog.tok[0]), [t.clone() for t in state]
            for t, s in zip(state, start):
                t.copy_(s)
            eng._prefill_body(prog)
            assert got_tok == int(prog.tok[0])
            for i, (a, t) in enumerate(zip(got, state)):
                assert torch.equal(a[1:], t[1:]) if i < n_pools else \
                    torch.equal(a, t), (prog.sb, prog.npp, i)
        eng._k_pools[0] = eng._k_pools[0].clone()
        prog = next(iter(eng._prefills.values()))
        with pytest.raises(RuntimeError, match="rebound"):
            eng._replay_prefill(prog)
    K.reset_launches()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_engine_prefill_and_decode_graphs_share_one_pool(dtype):
    """Prefills of three buckets (cold and warm) interleaved with decode
    replays, every graph captured in the engine's one pool on one
    capture stream: the streams equal those of the same engine whose
    programs run their eager bodies (replays swapped for the bodies), bit
    for bit, in both KV tiers."""
    from paddle_tpu_torch.core import graphs as GR
    from paddle_tpu_torch.inference.engine import (
        EngineConfig, InferenceEngine,
    )

    model = _tiny_gpt(dtype)
    rs = np.random.RandomState(5)
    shared = rs.randint(0, 128, (24,)).astype(np.int32)
    prompts = [rs.randint(0, 128, (n,)).astype(np.int32) for n in (5, 20)]
    prompts += [np.concatenate([shared, rs.randint(0, 128, (n,)).astype(
        np.int32)]) for n in (7, 2, 11)] + [rs.randint(0, 128, (40,))
                                            .astype(np.int32)]
    made, real = [], GR.Graph

    def graph(body, stream, pool=None, generators=()):
        made.append((stream, pool))
        return real(body, stream, pool=pool, generators=generators)

    for kv in (None, "int8"):
        cfg = EngineConfig(page_size=4, max_slots=2, max_seq_len=64,
                           kv_precision=kv)
        eager = InferenceEngine(model, cfg)
        eager._capture_decode = lambda *a: None
        eager._replay_prefill = eager._prefill_body
        eager._replay_decode = lambda prog, e=eager: e._decode_body(
            e.config.decode_chunk, prog.tok, prog.pt, prog.lengths,
            prog.toks)
        want = eager.generate(prompts, max_new_tokens=6)
        GR.Graph = graph
        try:
            eng = InferenceEngine(model, cfg)
            got = eng.generate(prompts, max_new_tokens=6)
        finally:
            GR.Graph = real
        assert eng.prefix_cache_stats()["hits"] >= 1
        assert len({sb for sb, _, _ in eng._prefills}) >= 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # one stream for every capture; one pool per engine
    assert len({id(s) for s, _ in made}) == 1 and len(made) >= 8
    assert len({p for _, p in made}) == 2
    K.reset_launches()


def _generate_loop(model, ids, max_new, eos=None, start=None):
    """The per-token eager loop at host int positions, fresh caches."""
    b, s0 = ids.shape
    caches = model.init_kv_caches(b, s0 + max_new)
    logits, caches = model(ids, kv_caches=caches, cache_pos=0,
                           attn_start=start)
    tok = logits[:, -1].float().argmax(-1).to(torch.int32)
    finished = None if eos is None else tok == eos
    out = [tok]
    for i in range(1, max_new):
        if finished is not None and bool(finished.all()):
            break
        logits, caches = model(tok[:, None], kv_caches=caches,
                               cache_pos=s0 + i - 1, attn_start=start)
        tok = logits[:, -1].float().argmax(-1).to(torch.int32)
        if finished is not None:
            tok = torch.where(finished, eos, tok)
            finished = finished | (tok == eos)
        out.append(tok)
    return torch.cat([ids, torch.stack(out, dim=1)], dim=1)


@pytest.mark.parametrize("mode", ["plain", "eos_pad"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_generate_chunk_graphs_replay_their_eager_body(mode, dtype):
    """`generate()`'s decode chunks: the first call of a chunk key runs
    the body and captures it, the second call replays; both equal the
    per-token eager loop bit for bit (device positions give the host
    ints' bits), decode_attention counted once a layer a decode step."""
    model = _tiny_gpt(dtype)
    rs = np.random.RandomState(6)
    ids = torch.from_numpy(rs.randint(0, 128, (3, 9)).astype(
        np.int32)).cuda()
    kw, start = {}, None
    if mode == "eos_pad":
        mask = np.ones((3, 9), np.int32)
        mask[1, :4] = 0
        kw["attention_mask"] = mask
        start = torch.tensor([0, 4, 0], dtype=torch.int32, device="cuda")
        probe = model.generate(ids, max_new_tokens=40, **kw)
        kw["eos_token_id"] = int(probe[0, 9 + 34])
    with torch.inference_mode():
        want = _generate_loop(model, ids, 40, kw.get("eos_token_id"), start)
    K.reset_launches()
    runs = [model.generate(ids, max_new_tokens=40, **kw) for _ in range(2)]
    counts = K.launch_counts()
    for got in runs:
        assert torch.equal(got, want)
    if mode == "plain":         # a warm-up's steps, then a replay's
        assert counts["decode_attention"] == 2 * 2 * 39
    K.reset_launches()


def test_static_function_replays_its_eager_forward():
    """`to_static` on the card: one graph per input signature, each call
    a replay equal to the eager forward bit for bit (bf16 ResNet-18 and
    a small Swin), returned as a clone; conv_bn_act / window_attention
    counted per call; a rebound parameter captures again."""
    from paddle_tpu_torch.jit import to_static
    from paddle_tpu_torch.vision import models as TV

    for ctor, kw, size, kernel in (
            ("resnet18", dict(num_classes=10), 64, "conv_bn_act"),
            ("SwinTransformer", dict(img_size=56, embed_dim=24,
                                     depths=(2, 2), num_heads=(1, 2),
                                     window_size=7, num_classes=10), 56,
             "window_attention")):
        model = getattr(TV, ctor)(**kw, dtype=torch.bfloat16)
        gen = torch.Generator(device="cuda").manual_seed(7)
        xs = [torch.randn(4, 3, size, size, generator=gen, device="cuda",
                          dtype=torch.bfloat16) for _ in range(2)]
        with torch.inference_mode():
            K.reset_launches()
            want = [model(x) for x in xs]
            per_fwd = K.launch_counts()[kernel] // 2
            sf = to_static(model).forward
            sf(xs[0])                          # warm-up, capture, replay
            K.reset_launches()
            got = [model(x) for x in xs]
            assert K.launch_counts()[kernel] == 2 * per_fwd > 0
            g = next(iter(sf._cache.values())).graph
            assert got[1] is not g.outputs
            for a, b in zip(got, want):
                assert torch.equal(a, b)
        head = model.fc if ctor == "resnet18" else model.head
        with torch.no_grad():
            head.weight = torch.nn.Parameter(head.weight * 0.5)
        with torch.inference_mode():
            assert torch.equal(model(xs[0]), sf._fn(xs[0]))
            assert next(iter(sf._cache.values())).graph is not g
        assert len(sf._cache) == 1
    K.reset_launches()


# ------------------------------------------- the encoder family (slice 17)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_at_vit_length_matches_plain(dtype):
    """ViT-B/16's attention: S = 197 (196 patches and the class token),
    not a multiple of 8, full, 12 heads of 64: `flash_tier` sends it to
    the native kernels; forward (O and LSE) and backward against their
    plain versions."""
    from paddle_tpu_torch.nn.functional.attention import flash_tier

    gen = torch.Generator(device="cuda").manual_seed(17)
    q, k, v, dout = (_randn(gen, 4, 197, 12, 64, dtype=dtype)
                     for _ in range(4))
    assert flash_tier(q, k) == "native"
    out, lse = FA.flash_fwd(q, k, v)
    want, wlse = FA.flash_fwd_reference(q, k, v)
    _close(out, want, dtype)
    assert (lse - wlse).abs().max().item() <= 1e-4
    got, ref = _bwd_pair(q, k, v, dout)
    _close_grads(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_ernie_biased_pair_matches_plain(dtype):
    """ERNIE-base's attention: full, 12 heads of 64, S = 512, real lengths
    drawn from 256-512 and the tail padded, the pad as the model builds
    it, a [B, 1, 1, S] f32 bias of (1 - mask) * -1e4 that gets no
    gradient: `flash_fwd` and `flash_bwd` with that bias (the biased
    tier) against their plain versions."""
    from paddle_tpu_torch.nn.functional.attention import flash_tier

    gen = torch.Generator(device="cuda").manual_seed(18)
    b, s = 8, 512
    lens = torch.randint(256, s + 1, (b,), generator=gen, device="cuda")
    mask = (torch.arange(s, device="cuda")[None] < lens[:, None]).float()
    bias = ((1.0 - mask) * -1e4)[:, None, None, :]
    q, k, v, dout = (_randn(gen, b, s, 12, 64, dtype=dtype)
                     for _ in range(4))
    assert flash_tier(q, k, bias) == "biased"
    out, lse = FA.flash_fwd(q, k, v, bias=bias)
    want, wlse = FA.flash_fwd_reference(q, k, v, bias=bias)
    _close(out, want, dtype)
    assert (lse - wlse).abs().max().item() <= 1e-4
    got, ref = _bwd_pair(q, k, v, dout, bias=bias)
    _close_grads(got, ref, dtype)


def test_dropout_in_a_captured_graph_draws_per_replay():
    """`core.rng`'s generator registered with the graph: two replays draw
    different masks, a replay equals the eager body run from the same
    generator state bit for bit, and `seed()` makes a replay
    reproducible."""
    from paddle_tpu_torch.core import graphs as GR
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.nn import functional as TF

    gen = rng.generator("cuda")
    x = torch.randn(64, 1024, device="cuda") + 3.0
    out = torch.empty_like(x)

    def body():
        out.copy_(TF.dropout(x, 0.3))
        return out

    stream = GR.capture_stream("cuda")
    GR.warm_up(body, stream)
    graph = GR.Graph(body, stream, generators=(gen,))
    state = gen.get_state()
    graph.replay()
    first = out.clone()
    after = gen.get_state()
    graph.replay()
    assert not torch.equal(out, first)
    gen.set_state(state)
    eager = body().clone()
    assert torch.equal(eager, first)
    assert torch.equal(gen.get_state(), after)
    rng.seed(5)
    graph.replay()
    again = out.clone()
    rng.seed(5)
    graph.replay()
    assert torch.equal(out, again)
    keep = (first != 0).float().mean().item()
    assert abs(keep - 0.7) < 0.01


def test_train_step_with_dropout_replays_its_eager_body():
    """A tiny ERNIE at dropout 0.1 through `build_train_step(loss_fn=
    None)` with AdamW under a scheduler and `grad_clip_norm`: replays
    equal the eager body from the same state and generator state bit for
    bit, two replays from one state but different generator states
    differ, and the biased flash kernels run once a layer a step."""
    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.models import ernie as TE
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as TL

    cfg = TE.ernie_tiny(dropout=0.1)
    model = TE.ErnieForPretraining(cfg, device="cuda")

    class Loss(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model
            self.crit = TE.ErniePretrainingCriterion()

        def forward(self, ids, labels, nsp):
            logits, nsp_logits = self.model(ids)
            return self.crit(logits, nsp_logits, labels, nsp)

    sched = TL.LinearWarmup(TL.PolynomialDecay(1e-3, decay_steps=20),
                            warmup_steps=2, start_lr=0.0, end_lr=1e-3)
    step = build_train_step(Loss(), AdamW(learning_rate=sched),
                            grad_clip_norm=1.0, amp_dtype="bfloat16")
    rs = np.random.RandomState(0)
    ids = rs.randint(1, cfg.vocab_size, (4, 48)).astype(np.int32)
    ids[:, 40:] = 0
    labels = np.full((4, 48), -100, np.int64)
    labels[:, 3:9] = rs.randint(1, cfg.vocab_size, (4, 6))
    nsp = rs.randint(0, 2, (4,)).astype(np.int64)
    step(ids, labels, nsp)
    start = _train_state(step)
    gstate = step.generator.get_state()
    K.reset_launches()
    got = step.run_steps(ids, labels, nsp, repeat=3, lrs=[1e-3] * 3)
    counts = K.launch_counts()
    assert counts["flash_fwd"] == counts["flash_bwd"] == 2 * 3
    after = _train_state(step)
    gafter = step.generator.get_state()
    with torch.no_grad():
        for t, s in zip(step._state_tensors(), start):
            t.copy_(s)
    step.generator.set_state(gstate)
    step._lr.fill_(1e-3)                 # what `run_steps(lrs=)` set
    batch = step._place((ids, labels, nsp))
    want = torch.stack([step._step(batch) for _ in range(3)])
    assert torch.equal(got, want)
    assert all(torch.equal(a, t) for a, t in zip(after,
                                                 step._state_tensors()))
    assert torch.equal(gafter, step.generator.get_state())
    # the same state, the generator where the last replay left it: other
    # masks, another loss
    with torch.no_grad():
        for t, s in zip(step._state_tensors(), start):
            t.copy_(s)
    other = step.run_steps(ids, labels, nsp, repeat=1, lrs=[1e-3])
    assert not torch.equal(other[0], got[0])
    K.reset_launches()


def test_dropout_capture_without_its_generator_raises():
    """A graph that draws from a CUDA generator it was not told of fails
    its capture (the replays would otherwise repeat one mask)."""
    from paddle_tpu_torch.core import graphs as GR
    from paddle_tpu_torch.nn import functional as TF

    x = torch.randn(8, 64, device="cuda")
    stream = GR.capture_stream("cuda")
    GR.warm_up(lambda: TF.dropout(x, 0.5), stream)
    with pytest.raises(RuntimeError):
        GR.Graph(lambda: TF.dropout(x, 0.5), stream)
    torch.cuda.synchronize()


# ------------------------------------------------------ the serving plane
def _serving_prompts():
    rs = np.random.RandomState(0)
    return [rs.randint(0, 128, (n,)).astype(np.int32)
            for n in (3, 9, 17, 30)]


def _http_streams(address, prompts, new):
    """Every prompt as its own concurrent `InferenceClient` stream:
    (streamed tokens, final record) each."""
    import threading

    from paddle_tpu_torch.inference.serving import InferenceClient

    out = [None] * len(prompts)

    def one(i):
        got = []
        r = InferenceClient(address, timeout=120).generate(
            prompts[i], max_new_tokens=new, on_token=got.append)
        out[i] = (got, r)

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert all(o is not None for o in out), "a stream failed or hung"
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_http_streams_equal_in_process_tokens(dtype):
    """A tiny engine on the card behind `InferenceServer`: concurrent
    HTTP streams equal its in-process tokens bit for bit (prefix cache
    off), each stream its final record; /debug/telemetry's launch
    counters hold flash_fwd to the HTTP round's prefills x layers and
    paged_attention to its decode steps x chunk x layers."""
    import json
    import urllib.request

    from paddle_tpu_torch.inference.engine import (
        EngineConfig, InferenceEngine,
    )
    from paddle_tpu_torch.inference.serving import InferenceServer

    prompts = _serving_prompts()
    model = _tiny_gpt(dtype)
    eng = InferenceEngine(model, EngineConfig(
        page_size=8, max_slots=2, max_seq_len=64, prefix_cache=False))
    want = eng.generate(prompts, max_new_tokens=12)
    srv = InferenceServer(engine=eng, request_timeout=120.0).start()
    try:
        K.reset_launches()
        eng.prefill_count = eng.decode_steps = 0
        for p, w, (got, r) in zip(prompts, want,
                                  _http_streams(srv.address, prompts, 12)):
            np.testing.assert_array_equal(r["output_ids"], w)
            assert got == r["tokens"] == [int(t) for t in w[len(p):]]
            assert r["finish_reason"] == "length"
        with urllib.request.urlopen(srv.address + "/debug/telemetry",
                                    timeout=60) as resp:
            kern = json.loads(resp.read())["kernels"]
        layers = model.cfg.num_layers
        assert kern["prefills"] == len(prompts)
        assert kern["launches"]["flash_fwd"] == layers * len(prompts)
        assert kern["decode_steps"] > 0
        assert kern["launches"]["paged_attention"] == (
            layers * kern["decode_chunk"] * kern["decode_steps"])
    finally:
        srv.shutdown()


def test_capture_timing_lands_in_the_lifecycle_ledger():
    """The engine's first prefill and decode programs on the card are
    timed under the JAX labels: warm-up and capture ms, both > 0."""
    from paddle_tpu_torch.inference.engine import (
        EngineConfig, InferenceEngine,
    )
    from paddle_tpu_torch.observability import lifecycle

    lifecycle.reset()
    try:
        eng = InferenceEngine(_tiny_gpt(torch.float32), EngineConfig(
            page_size=8, max_slots=2, max_seq_len=64, decode_chunk=2))
        eng.generate([np.arange(1, 5, dtype=np.int32)], max_new_tokens=3)
        comp = lifecycle.get_ledger().record()["compiles"]
        assert set(comp) == {"prefill_s16", "decode_n2"}, comp
        for label, c in comp.items():
            assert c["count"] == 1 and c["lower_ms"] > 0 \
                and c["compile_ms"] > 0, (label, c)
    finally:
        lifecycle.reset()


def test_metrics_polled_during_captures_do_not_fail_them():
    """Handler threads scraping /metrics and /ready while the engine's
    loop thread captures new prefill buckets (thread-local capture): every
    capture and every request succeeds, every poll answers 200."""
    import threading
    import urllib.request

    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.inference.engine import (
        EngineConfig, InferenceEngine,
    )
    from paddle_tpu_torch.inference.serving import InferenceServer
    from paddle_tpu_torch.observability import lifecycle

    lifecycle.reset()
    obs.attach(crash_hook=False)
    eng = InferenceEngine(_tiny_gpt(torch.float32), EngineConfig(
        page_size=8, max_slots=4, max_seq_len=64, prefix_cache=False))
    srv = InferenceServer(engine=eng, request_timeout=120.0).start()
    stop, polls, errors = threading.Event(), [], []

    def poll():
        while not stop.is_set():
            for path in ("/metrics", "/ready"):
                try:
                    with urllib.request.urlopen(srv.address + path,
                                                timeout=60) as r:
                        polls.append(r.status)
                except Exception as e:      # reported below
                    errors.append(repr(e))

    pollers = [threading.Thread(target=poll, daemon=True) for _ in range(2)]
    try:
        for t in pollers:
            t.start()
        rs = np.random.RandomState(1)
        # four prompt buckets (16, 32, 48) and the decode program: each
        # captured on the loop thread while the pollers scrape
        prompts = [rs.randint(0, 128, (n,)).astype(np.int32)
                   for n in (5, 20, 40, 45)]
        outs = _http_streams(srv.address, prompts, 6)
        assert all(len(got) == 6 for got, _ in outs)
    finally:
        stop.set()
        for t in pollers:
            t.join(timeout=60)
        srv.shutdown()
        obs.detach()
    comp = lifecycle.get_ledger().record()["compiles"]
    lifecycle.reset()
    assert not errors and polls and set(polls) == {200}, errors[:3]
    assert {"prefill_s16", "prefill_s32", "prefill_s48",
            "decode_n1"} <= set(comp), comp


# ------------------- the weight and speculative tiers, sampling, beams
def _tiny_pair(seed, layers=2, hidden=64, tied=False):
    """A tiny GPT on the CPU and its copy on the card.  Untied by
    default: a seeded tied model repeats its last token (the token's
    own logit dominates), so its streams would test little."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=128, hidden_size=hidden, num_layers=layers,
                    num_heads=4, max_seq_len=64, tie_embeddings=tied)
    cpu = GPTForCausalLM(cfg, device="cpu", seed=seed)
    gpu = GPTForCausalLM(cfg, seed=seed)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("draft_tied", [True, False])
def test_tiny_spec_and_weight_tiers_on_the_card_match_cpu(kv, draft_tied):
    """int8 weights + spec_tokens=3 on the card: streams equal to the
    CPU engine's (the plain versions) and to sequential greedy over the
    engine's `effective_params()` on the card, bit-stable run to run;
    every pass launches the KV tier's paged kernel twice for the target
    and the exact one 4 times for the 1-layer draft (its pools stay
    exact), and so does the spec graph's warm-up on its zero buffers."""
    from paddle_tpu_torch.inference.engine import (
        EngineConfig, InferenceEngine,
    )
    from paddle_tpu_torch.models.gpt import load_reference_state

    cpu, gpu = _tiny_pair(3)
    dcpu, dgpu = _tiny_pair(4, layers=1, hidden=32, tied=draft_tied)
    rs = np.random.RandomState(2)
    prompts = [rs.randint(0, 128, (n,)).astype(np.int32)
               for n in (3, 9, 17, 5, 12)]
    ecfg = EngineConfig(page_size=8, max_slots=3, max_seq_len=64,
                        spec_tokens=3, weight_precision="int8",
                        kv_precision=kv)
    want = InferenceEngine(cpu, ecfg, draft_model=dcpu).generate(
        prompts, max_new_tokens=10)
    K.reset_launches()
    eng = InferenceEngine(gpu, ecfg, draft_model=dgpu)
    got = eng.generate(prompts, max_new_tokens=10)
    counts = K.launch_counts()
    runs = eng.spec_passes + 1                 # + the capture's warm-up
    if kv:
        assert counts["paged_attention_int8"] == 2 * runs
        assert counts["paged_attention"] == 4 * runs
    else:
        assert counts["paged_attention"] == 6 * runs
    again = InferenceEngine(gpu, ecfg, draft_model=dgpu).generate(
        prompts, max_new_tokens=10)
    for w, a, b in zip(want, got, again):
        np.testing.assert_array_equal(a, w)
        np.testing.assert_array_equal(a, b)
    if kv is None:
        _, ref = _tiny_pair(3)
        load_reference_state(ref, {k: v.cpu().numpy() for k, v
                                   in eng.effective_params().items()})
        for p, a in zip(prompts, got):
            np.testing.assert_array_equal(
                a, ref.generate(p[None], max_new_tokens=10).cpu().numpy()[0])


def test_sampled_generate_on_the_card_replays_its_generator():
    """A seed on the card: the first call (eager warm-up, then the
    capture) and the second (a replay, the generator registered with
    the graph) give the same tokens, equal to a per-step eager loop
    drawing from a card generator seeded alike; another seed gives
    others; top_k=1 is greedy."""
    from paddle_tpu_torch.models import generation as GEN

    _, gpu = _tiny_pair(5)
    ids = np.random.RandomState(3).randint(0, 128, (3, 7)).astype(np.int32)
    kw = dict(do_sample=True, temperature=0.9, top_k=10)
    a = gpu.generate(ids, max_new_tokens=20, seed=5, **kw).cpu().numpy()
    b = gpu.generate(ids, max_new_tokens=20, seed=5, **kw).cpu().numpy()
    np.testing.assert_array_equal(a, b)
    g = torch.Generator(device="cuda").manual_seed(5)
    with torch.inference_mode():
        x = torch.from_numpy(ids).cuda()
        caches = gpu.init_kv_caches(3, 27)
        logits, _ = gpu(x, kv_caches=caches, cache_pos=0)
        out = [GEN.sample(logits[:, -1], True, 0.9, 10, g)]
        for i in range(1, 20):
            logits, _ = gpu(out[-1][:, None], kv_caches=caches,
                            cache_pos=7 + i - 1)
            out.append(GEN.sample(logits[:, -1], True, 0.9, 10, g))
    loop = torch.cat([x, torch.stack(out, dim=1)], dim=1).cpu().numpy()
    np.testing.assert_array_equal(a, loop)
    assert not np.array_equal(
        a, gpu.generate(ids, max_new_tokens=20, seed=6, **kw).cpu().numpy())
    np.testing.assert_array_equal(
        gpu.generate(ids, max_new_tokens=20).cpu().numpy(),
        gpu.generate(ids, max_new_tokens=20, do_sample=True, top_k=1,
                     seed=7).cpu().numpy())


@pytest.mark.parametrize("num_beams,eos", [(2, None), (4, 5), (3, 9)])
def test_beam_search_on_the_card_matches_cpu(num_beams, eos):
    """Beams on the card (a CUDA graph a step, replayed from the second
    step on) equal the CPU port's, twice in a row."""
    cpu, gpu = _tiny_pair(6)
    ids = np.random.RandomState(4).randint(0, 128, (2, 9)).astype(np.int32)
    want = cpu.generate(ids, max_new_tokens=12, num_beams=num_beams,
                        eos_token_id=eos, length_penalty=0.6).numpy()
    for _ in range(2):
        got = gpu.generate(ids, max_new_tokens=12, num_beams=num_beams,
                           eos_token_id=eos, length_penalty=0.6)
        np.testing.assert_array_equal(got.cpu().numpy(), want)


# ------------------------------------------- the long job's train step
def _resilient_gpt(guard=None, recompute=None, dropout=0.1, seed=2):
    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.models.gpt import (
        GPTConfig, GPTForCausalLM, GPTPretrainingCriterion,
    )
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                    num_heads=4, max_seq_len=64, fused_head_ce=True,
                    dropout=dropout, recompute=recompute is not None,
                    recompute_policy=recompute)
    model = GPTForCausalLM(cfg, seed=seed)
    return model, build_train_step(model, AdamW(learning_rate=1e-3),
                                   GPTPretrainingCriterion(model=model),
                                   guard=guard)


def _resilient_batch():
    rs = np.random.RandomState(5)
    return tuple(rs.randint(0, 128, (2, 48)).astype(np.int32)
                 for _ in range(2))


def _live(step):
    with torch.no_grad():
        return [t.clone() for t in step.train_state_dict().values()]


def test_guarded_step_skips_and_rolls_back_in_its_graph(tmp_path):
    """A guarded tiny GPT with dropout 0.1 on the card: fault-free replays
    equal the unguarded step's bit for bit; a NaN step (the device flag,
    in the graph already captured) is skipped with the state kept; two
    in a row roll back to the saved checkpoint; one graph throughout,
    the model's forward run only for the eager step and the capture."""
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.resilience import StepGuard, faults

    ids, labels = _resilient_batch()
    rng.seed(3)
    plain = _resilient_gpt()[1].run_steps(ids, labels, repeat=4)
    guard = StepGuard(max_consecutive_bad=2)
    model, step = _resilient_gpt(guard)
    step.attach_checkpoint_manager(CheckpointManager(str(tmp_path)))
    forwards = []
    hook = model.register_forward_hook(lambda *a: forwards.append(1))
    rng.seed(3)
    assert torch.equal(step.run_steps(ids, labels, repeat=4), plain)
    (graph,) = [g for _, g in step._graphs.values()]
    before = _live(step)
    faults.clear()
    try:
        with faults.inject("train.step", kind="nan", at=1):
            bad = step(ids, labels)
        assert torch.isnan(bad) and guard.total_bad == 1
        assert all(torch.equal(a, b) for a, b in zip(before, _live(step)))
        assert torch.isfinite(step(ids, labels))
        step.save_checkpoint()
        saved = _live(step)
        with faults.inject("train.step", kind="nan", times=2):
            step(ids, labels)
            step(ids, labels)
    finally:
        faults.clear()
    assert guard.rollbacks == 1
    assert all(torch.equal(a, b) for a, b in zip(saved, _live(step)))
    assert torch.isfinite(step(ids, labels))
    hook.remove()
    assert len(forwards) == 2
    assert [g for _, g in step._graphs.values()] == [graph]


def test_jax_train_state_resumes_on_the_card():
    """The checkpoint the JAX package's train step wrote
    (``tests/data/jax_gpt_train_state``) resumes in the port's step on
    the card: the next 2 losses are the JAX step's within 1e-4; the
    card's state saved again loads into the CPU port bit for bit."""
    import json
    import os
    import tempfile

    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.models.gpt import (
        GPTConfig, GPTForCausalLM, GPTPretrainingCriterion,
    )
    from paddle_tpu_torch.optimizer import AdamW

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jax_gpt_train_state")
    with open(os.path.join(path, "expected.json")) as f:
        want = json.load(f)
    steps = []
    for device in ("cuda", "cpu"):
        model = GPTForCausalLM(GPTConfig(**want["config"]), device=device,
                               seed=9)
        steps.append(build_train_step(
            model, AdamW(learning_rate=want["learning_rate"]),
            GPTPretrainingCriterion(model=model)))
    card, cpu = steps
    card.load_train_state(path)
    rs = np.random.RandomState(want["batch_seed"])
    ids, labels = (rs.randint(0, 64, (2, 8)).astype(np.int32)
                   for _ in range(2))
    got = [float(card(ids, labels)) for _ in range(2)]
    np.testing.assert_allclose(got, want["next_losses"], rtol=1e-4)
    with tempfile.TemporaryDirectory() as tmp:
        card.save_train_state(tmp)
        cpu.load_train_state(tmp)
    for a, b in zip(card.train_state_dict().values(),
                    cpu.train_state_dict().values()):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("policy", ["full", "dots", "dots_no_batch"])
def test_recompute_with_dropout_on_the_card(policy):
    """Dropout 0.1, 3 AdamW steps in f32 from one generator state: under
    each recompute policy the losses and parameters are the plain
    step's (1e-6 of the largest value; bit for bit where the kernels
    are), the device generator ends where the plain step left it, flash
    runs twice a layer forward and once backward; the recomputed graph
    replays its eager body bit for bit."""
    from paddle_tpu_torch.core import rng

    ids, labels = _resilient_batch()
    runs = []
    for rc in (None, policy):
        model, step = _resilient_gpt(recompute=rc)
        rng.seed(7)
        K.reset_launches()
        losses = step.run_steps(ids, labels, repeat=3)
        runs.append((losses, [p.detach().clone() for p in
                              model.parameters()],
                     step.generator.get_state(), K.launch_counts()))
    (l0, p0, g0, c0), (l1, p1, g1, c1) = runs
    assert (l1 - l0).abs().max() <= 1e-6 * l0.abs().max()
    for a, b in zip(p0, p1):
        assert (a - b).abs().max() <= 1e-6 * a.abs().max()
    assert torch.equal(g0, g1)
    assert (c0["flash_fwd"], c1["flash_fwd"]) == (2 * 3, 4 * 3)
    assert c0["flash_bwd"] == c1["flash_bwd"] == 2 * 3
    start, gstate = _train_state(step), step.generator.get_state()
    got = step.run_steps(ids, labels, repeat=2, lrs=[1e-3] * 2)
    after = _train_state(step)
    with torch.no_grad():
        for t, s in zip(step._state_tensors(), start):
            t.copy_(s)
    step.generator.set_state(gstate)
    step._lr.fill_(1e-3)
    batch = step._place((ids, labels))
    want = torch.stack([step._step(batch) for _ in range(2)])
    assert torch.equal(got, want)
    assert all(torch.equal(a, t) for a, t in zip(after,
                                                 step._state_tensors()))
    K.reset_launches()


# ------------------------------------ the eager training loop (-k eager)
def _train_gpt(seed=2, **kw):
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(**dict(dict(vocab_size=300, hidden_size=64,
                                num_layers=2, num_heads=4, max_seq_len=64,
                                fused_head_ce=True), **kw))
    return GPTForCausalLM(cfg, seed=seed).train()


def _train_batch(seed=0, b=2, s=40):
    rs = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rs.randint(0, 300, (b, s)).astype(
        np.int32)).cuda() for _ in range(2))


ZOO = (("SGD", {}), ("Momentum", dict(momentum=0.9)),
       ("Adagrad", dict(initial_accumulator_value=0.1)),
       ("Adam", dict(amsgrad=True)), ("AdamW", {}), ("Adamax", {}),
       ("RMSProp", dict(centered=True, momentum=0.5)), ("Lamb", {}),
       ("Adadelta", {}), ("Rprop", {}))


@pytest.mark.parametrize("name,kw", ZOO, ids=[z[0] for z in ZOO])
def test_eager_zoo_step_equals_graphed_replay(name, kw):
    """Each rule: 4 steps of the graphed train step (the eager first
    step and its capture, then 3 replays) against 4 eager ``.step()``s
    of the same rule from the same weights, f32: losses and parameters
    within 1e-5 of the largest value (lr 1e-5, so that a sign flip of a
    rounding-level gradient stays within it)."""
    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import optimizer as O

    cls = getattr(O, name)
    ids, labels = _train_batch(3)
    graphed, eager = _train_gpt(), _train_gpt()
    step = build_train_step(graphed, cls(learning_rate=1e-5, **kw),
                            GPTPretrainingCriterion(model=graphed))
    lg = torch.cat([step(ids, labels)[None],
                    step.run_steps(ids, labels, repeat=3)])
    assert len(step._graphs) == 1
    opt = cls(learning_rate=1e-5, parameters=eager.parameters(), **kw)
    crit = GPTPretrainingCriterion(model=eager)
    le = []
    for _ in range(4):
        loss = crit(eager(ids), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        le.append(loss.detach())
    assert (lg - torch.stack(le)).abs().max() <= 1e-5 * lg.abs().max()
    for (n, a), b in zip(graphed.named_parameters(), eager.parameters()):
        assert (a - b).abs().max() <= 1e-5 * max(1.0, a.abs().max()), n


def test_eager_amp_loop_tracks_the_graphed_step():
    """The bf16 O2 eager loop (`decorate`, multi_precision AdamW, clip
    1.0, `auto_cast`) against the graphed bf16 AMP step with the same
    clip, 3 steps from the same weights (the bf16 casts the eager loop's
    masters start from): losses within 2e-2 relative;
    one flash launch of each direction a layer a step."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    ids, labels = _train_batch(4)
    ref = _train_gpt()
    with torch.no_grad():
        # the weights `decorate` gives the eager loop's masters
        for p in ref.parameters():
            p.copy_(p.to(torch.bfloat16))
    step = build_train_step(ref, AdamW(learning_rate=1e-3),
                            GPTPretrainingCriterion(model=ref),
                            amp_dtype="bfloat16", grad_clip_norm=1.0)
    want = step.run_steps(ids, labels, repeat=3)
    model = _train_gpt()
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                multi_precision=True, grad_clip=ClipGradByGlobalNorm(1.0))
    model, opt = amp.decorate(model, opt, level="O2")
    crit = GPTPretrainingCriterion(model=model)
    K.reset_launches()
    got = []
    for _ in range(3):
        with amp.auto_cast(level="O2"):
            loss = crit(model(ids), labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        got.append(loss.detach())
    got = torch.stack(got)
    assert ((got - want).abs() / want.abs()).max() <= 2e-2
    counts = K.launch_counts()
    assert counts["flash_fwd"] == counts["flash_bwd"] == 2 * 3
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())


def test_to_static_training_replay_equals_eager_bit_for_bit():
    """`jit.to_static(model)` in training with dropout 0.1, 4 calls
    (gradients accumulated over the first two, then an AdamW step each)
    against the eager model from the same weights and the same
    generator state: losses, gradients, parameters and the generator's
    state bit for bit; one program, its forward and backward graphs
    replayed from the second call."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    runs = []
    for static in (False, True):
        model = _train_gpt(dropout=0.1)
        if static:
            jit.to_static(model)
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
        crit = GPTPretrainingCriterion(model=model)
        rng.seed(11)
        losses, grads = [], []
        for i in range(4):
            ids, labels = _train_batch(20 + i)
            loss = crit(model(ids), labels)
            loss.backward()
            losses.append(loss.detach())
            if i >= 1:
                grads.append([p.grad.clone() for p in model.parameters()])
                opt.step()
                opt.clear_grad()
        runs.append((torch.stack(losses), grads,
                     [p.detach().clone() for p in model.parameters()],
                     rng.generator("cuda").get_state(), model))
    (l0, g0, p0, s0, _), (l1, g1, p1, s1, m1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for x, y in zip(g0, g1)
               for a, b in zip(x, y))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert torch.equal(s0, s1)
    (prog,) = m1.forward._cache.values()
    assert prog.calls == 3 and prog.bwd is not None


def test_grad_scaler_skip_on_the_card():
    """A forced overflow (the loss times inf) in f16 O1: the step leaves
    the parameters, the Adam slots and the step count bit for bit and
    halves the scale; the next steps train."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    model = _train_gpt()
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 10)
    crit = GPTPretrainingCriterion(model=model)
    ids, labels = _train_batch(5)
    K.reset_launches()
    for i in range(4):
        with amp.auto_cast(dtype="float16"):
            loss = crit(model(ids), labels)
        if i == 2:
            loss = loss * float("inf")
            before = ([p.detach().clone() for p in model.parameters()],
                      [v.clone() for v in opt.state_dict().values()
                       if isinstance(v, torch.Tensor)], opt._step_count)
            scale = scaler._scale
        scaler.scale(loss).backward()
        scaler.step(opt)
        skipped = scaler._found_inf
        scaler.update()
        opt.clear_grad()
        if i == 2:
            assert skipped and scaler._scale == scale / 2
            assert opt._step_count == before[2] == 2
            after = [p.detach() for p in model.parameters()] + [
                v for v in opt.state_dict().values()
                if isinstance(v, torch.Tensor)]
            assert all(torch.equal(a, b) for a, b in
                       zip(before[0] + before[1], after))
        else:
            assert not skipped
    assert opt._step_count == 3
    assert K.launch_counts()["flash_fwd"] == 2 * 4


def test_lbfgs_on_the_card():
    """`LBFGS.step(closure)` converges on the card, its iterates within
    1e-4 of the same run on the CPU."""
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.optimizer import LBFGS

    rs = np.random.RandomState(0)
    xs = rs.randn(32, 3).astype(np.float32)
    ys = xs @ np.array([[1.5], [-2.0], [0.5]], np.float32)
    finals = []
    for dev in ("cuda", "cpu"):
        lin = Linear(3, 1, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
        if dev == "cpu":
            lin.load_state_dict({k: v.cpu() for k, v in first.items()})
        else:
            first = {k: v.clone() for k, v in lin.state_dict().items()}
        opt = LBFGS(parameters=lin.parameters(), max_iter=10)
        x, y = torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)

        def closure():
            loss = ((lin(x) - y) ** 2).mean()
            loss.backward()
            return loss

        finals.append((opt.step(closure), lin.weight.detach().cpu()))
    (lg, wg), (lc, wc) = finals
    assert lg < 1e-3 and abs(lg - lc) <= 1e-4
    assert (wg - wc).abs().max() <= 1e-4


# ------------------------------------------- incubate decode functionals
def _mmha_case(dtype, b=3, h=4, d=64, s=128, seed=21):
    g = torch.Generator(device="cuda").manual_seed(seed)
    cache = _randn(g, 2, b, h, s, d, dtype=dtype)
    steps = [_randn(g, b, 3 * h * d, dtype=dtype) for _ in range(4)]
    return cache, steps, torch.tensor([5, 99, 0], dtype=torch.int32,
                                      device="cuda")[:b]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_masked_mha_kernel_route_matches_einsum_route(dtype):
    """`masked_multihead_attention` with equal q and kv heads (JAX's
    [B, 3, H, D] reshape): the decode_attention route (no mask) against
    the einsum route (a zero mask) over 4 steps; each step launches the
    kernel once, the caches of both routes equal bit for bit."""
    from paddle_tpu_torch.incubate.nn import functional as IF

    cache, steps, pos = _mmha_case(dtype)
    ck, ce = cache.clone(), cache.clone()
    zero = torch.zeros(3, 1, 1, cache.shape[3], device="cuda")
    for i, x in enumerate(steps):
        K.reset_launches()
        got, ck2 = IF.masked_multihead_attention(x, cache_kv=ck,
                                                 sequence_lengths=pos + i)
        assert K.launch_counts()["decode_attention"] == 1 and ck2 is ck
        want, _ = IF.masked_multihead_attention(
            x, cache_kv=ce, src_mask=zero, sequence_lengths=pos + i)
        assert K.launch_counts()["decode_attention"] == 1
        _close(got, want, dtype)
        assert torch.equal(ck, ce)


def test_block_mha_equals_masked_mha_on_the_card():
    """`block_multihead_attention` over 16-token blocks of a shuffled
    pool equals `masked_multihead_attention` (the kernel) over the dense
    copy of the same keys, f32."""
    from paddle_tpu_torch.incubate.nn import functional as IF

    b, h, d, s, bs = 3, 4, 64, 128, 16
    g = torch.Generator(device="cuda").manual_seed(22)
    dense = _randn(g, 2, b, h, s, d, dtype=torch.float32)
    nblk = s // bs
    perm = torch.randperm(b * nblk, generator=torch.Generator().manual_seed(0))
    bt = perm.reshape(b, nblk).to(device="cuda", dtype=torch.int32)
    kc = torch.empty(b * nblk, h, bs, d, device="cuda")
    vc = torch.empty_like(kc)
    for i in range(b):
        for j in range(nblk):
            blk = dense[:, i, :, j * bs:(j + 1) * bs]
            kc[bt[i, j]], vc[bt[i, j]] = blk[0], blk[1]
    x = _randn(g, b, 3 * h * d, dtype=torch.float32)
    lens = torch.tensor([5, 99, 64], dtype=torch.int32, device="cuda")
    out, kc2, _ = IF.block_multihead_attention(
        x, kc, vc, lens * 0, lens, lens * 0 + 1, block_tables=bt,
        block_size=bs)
    want, _ = IF.masked_multihead_attention(x, cache_kv=dense,
                                            sequence_lengths=lens)
    assert kc2 is kc
    _close(out, want, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("causal", [False, True])
def test_varlen_mem_eff_flash_route_matches_sdpa_ref(causal, dtype):
    """`variable_length_memory_efficient_attention` on the card (the
    biased flash kernels, one launch each way) against the plain
    `_sdpa_ref` over the same additive key-length mask in f32, forward
    and backward; a row with no valid key against JAX's average of the
    causally visible value rows."""
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.nn.functional.attention import _sdpa_ref

    b, h, s, d = 3, 4, 256, 64
    g = torch.Generator(device="cuda").manual_seed(23)
    q, k, v, dout = (_randn(g, b, h, s, d, dtype=dtype) for _ in range(4))
    kvl = torch.tensor([256, 77, 0], dtype=torch.int32, device="cuda")
    qs = [t.clone().requires_grad_() for t in (q, k, v)]
    K.reset_launches()
    out = IF.variable_length_memory_efficient_attention(
        *qs, kv_seq_lens=kvl, causal=causal)
    out.backward(dout)
    counts = K.launch_counts()
    assert (counts["flash_fwd"], counts["flash_bwd"]) == (1, 1), counts
    refs = [t.float().clone().requires_grad_() for t in (q, k, v)]
    pad = torch.where(torch.arange(s, device="cuda")[None, :]
                      < kvl[:, None], 0.0, IF._KV_PAD)[:, None, None]
    want = _sdpa_ref(*(t.transpose(1, 2) for t in refs), pad, causal)
    want = want.transpose(1, 2)
    want.backward(dout.float())
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (out[:2].float() - want[:2]).abs().max().item() <= \
        tol * want[:2].abs().max().item()
    visible = torch.arange(1, s + 1, device="cuda")[:, None] if causal \
        else torch.full((s, 1), s, device="cuda")
    mean = (v[2].float().cumsum(1) / visible if causal
            else v[2].float().mean(1, keepdim=True).expand(h, s, d))
    assert (out[2].float() - mean).abs().max().item() <= \
        tol * mean.abs().max().item()
    for a, r in zip(qs, refs):
        err = (a.grad[:2].float() - r.grad[:2]).abs().max().item()
        assert err <= tol * r.grad[:2].abs().max().item(), err


def test_fused_ec_moe_layer_card_matches_cpu():
    """`FusedEcMoe` built on the card and on the CPU from one seed's
    weights: forward and gradients within 1e-4 of the largest (f32)."""
    from paddle_tpu_torch.incubate.nn import FusedEcMoe

    rs = np.random.RandomState(24)
    x = rs.randn(4, 32, 64).astype(np.float32)
    outs = {}
    for dev in ("cuda", "cpu"):
        m = FusedEcMoe(64, 256, 8, device=dev, seed=3)
        if dev == "cpu":
            m.load_state_dict({n: t.cpu() for n, t in state.items()})
        else:
            state = m.state_dict()
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        out = m(xt)
        out.square().sum().backward()
        outs[dev] = [out.detach().cpu(), xt.grad.cpu()] + [
            p.grad.cpu() for p in m.parameters()]
    for a, r in zip(outs["cuda"], outs["cpu"]):
        assert (a - r).abs().max().item() <= 1e-4 * r.abs().max().item()
