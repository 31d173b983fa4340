"""The port's fused norm and incubate fused-transformer path against the
JAX package's, on the CPU.

The same seeded numpy inputs (and, for the layers, the same weights,
moved from ``functional_state()`` by `load_reference_state`) go through
both packages:

  (a) `fused_norm_reference` (the plain version of the `fused_norm`
      kernel) against the Pallas `_pallas_norm_fwd` in interpret mode,
      RMS and LayerNorm, with and without weight, shift, bias and
      residual: f32 within 2e-5 (the JAX package's own fused-norm
      tolerance), bf16 within one bf16 ulp of the reference value (one
      final rounding each; the f32 statistics differ in summation order),
      z bit for bit;
  (b) the gradients of `FusedNorm` against ``jax.grad`` of
      `fused_norm_pallas`, 5e-4 (the JAX test's tolerance);
  (c) `fused_rms_norm` / `fused_layer_norm` against the JAX functionals
      (which off the TPU run their jnp body), and their refusals
      (`quant_scale`, `begin_norm_axis` other than the last axis);
  (d) every ported incubate functional and layer at width 128, 4 heads,
      ffn 256 (2 layers where a layer stacks), f32: outputs and the
      gradients of a fixed linear functional of the output (JAX: the
      eager tape for functionals, ``jax.grad`` through `functional_call`
      for layers), within 1e-5 relative L2.

Nothing here launches a kernel: on the CPU the wrappers run their plain
versions.  The kernels are held against those on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.incubate import nn as jinn
from paddle_tpu.incubate.nn import functional as JIF
from paddle_tpu.ops.pallas import fused_norm as JFN
from paddle_tpu_torch.incubate import nn as tinn
from paddle_tpu_torch.incubate.nn import functional as TIF
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import fused_norm as FN

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)

REL = 1e-5
WIDTH, HEADS, FFN = 128, 4, 256


@pytest.fixture(autouse=True)
def _no_launches():
    K.reset_launches()
    yield
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.array(a)).to(dtype)


# ------------------------------------------------------ (a) the forward
OPERANDS = {  # (weight, shift, bias, residual)
    "all": (True, True, True, True),
    "residual_only": (True, False, False, True),
    "bare": (False, False, False, False),
    "affine": (True, True, False, False),
    "shift_bias": (False, True, True, False),
}


def _norm_inputs(ops, rows=16, d=256, seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(rows, d) * 2 + 0.5).astype(np.float32)
    return [x] + [rs.randn(*((rows, d) if i == 3 else (d,)))
                  .astype(np.float32) if on else None
                  for i, on in enumerate(OPERANDS[ops])]


def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("ops", sorted(OPERANDS))
def test_fused_norm_plain_matches_pallas_kernel(ops, kind, dtype):
    x, w, b, bias, res = _norm_inputs(ops)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    want_z = bias is not None or res is not None
    y_j, z_j = JFN._pallas_norm_fwd(
        *(None if a is None else jnp.asarray(a, jd)
          for a in (x, w, b, bias, res)), 1e-6, kind, want_z,
        interpret=True)
    y, z = FN.fused_norm_reference(*(_t(a, td) for a in (x, w, b, bias,
                                                          res)),
                                   eps=1e-6, kind=kind)
    assert y.dtype == td and (z is None) == (not want_z)
    if dtype == "bfloat16" and want_z:
        # XLA's CPU backend keeps excess precision between the kernel's
        # bf16 adds and its statistics (xla_allow_excess_precision), so
        # the JAX kernel's bf16 y comes from the unrounded sum; the
        # kernel's own semantics (statistics of the rounded z) are the
        # same kernel run on its rounded z output
        y_j, _ = JFN._pallas_norm_fwd(
            z_j, *(None if a is None else jnp.asarray(a, jd)
                   for a in (w, b)), None, None, 1e-6, kind, False,
            interpret=True)
    y_j = np.asarray(y_j, np.float32)
    got = y.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, y_j, atol=2e-5, rtol=2e-5)
    else:
        ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(y_j)))
        assert (np.abs(got - y_j) <= ulp).all()
    if want_z:     # the same rounded adds
        np.testing.assert_array_equal(z.float().numpy(),
                                      np.asarray(z_j, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [768, 1000, 2048])
def test_fused_norm_plain_matches_pallas_at_the_model_widths(d, dtype):
    """The widths the card's vector kernel splits differently (768: a
    warp a row; 1000: the odd width; 2048: two warps a row), LayerNorm
    with every operand, against the JAX kernel in interpret mode on its
    own rounded z (see above): y within one bf16 ulp (f32: 2e-5), z bit
    for bit."""
    rs = np.random.RandomState(d)
    x = (rs.randn(8, d) * 2 + 0.5).astype(np.float32)
    w, b, bias = (rs.randn(d).astype(np.float32) for _ in range(3))
    res = rs.randn(8, d).astype(np.float32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    _, z_j = JFN._pallas_norm_fwd(
        *(jnp.asarray(a, jd) for a in (x, w, b, bias, res)), 1e-5, "ln",
        True, interpret=True)
    y_j, _ = JFN._pallas_norm_fwd(z_j, jnp.asarray(w, jd),
                                  jnp.asarray(b, jd), None, None, 1e-5,
                                  "ln", False, interpret=True)
    y, z = FN.fused_norm_reference(*(_t(a, td) for a in (x, w, b, bias,
                                                          res)),
                                   eps=1e-5, kind="ln")
    got, want = y.float().numpy(), np.asarray(y_j, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    else:
        ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        assert (np.abs(got - want) <= ulp).all()
    np.testing.assert_array_equal(z.float().numpy(),
                                  np.asarray(z_j, np.float32))


# ----------------------------------------------------- (b) the gradients
@functools.lru_cache(maxsize=None)
def _jax_norm_grads(ops, kind):
    args = [a for a in _norm_inputs(ops, seed=1) if a is not None]
    has = [a is not None for a in _norm_inputs(ops, seed=1)]
    rs = np.random.RandomState(2)
    gy = rs.randn(16, 256).astype(np.float32)
    gz = rs.randn(16, 256).astype(np.float32)

    def loss(*args):
        it = iter(args)
        full = [next(it) if h else None for h in has]
        out = JFN.fused_norm_pallas(*full, eps=1e-6, kind=kind)
        if isinstance(out, tuple):
            return jnp.sum(out[0] * gy) + jnp.sum(out[1] * gz)
        return jnp.sum(out * gy)

    grads = jax.jit(jax.grad(loss, argnums=tuple(range(len(args)))))(
        *args)
    return [np.asarray(g) for g in grads], gy, gz


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("ops", ["all", "affine", "bare", "shift_bias"])
def test_fused_norm_grads_match_jax_grad(ops, kind):
    want, gy, gz = _jax_norm_grads(ops, kind)
    full = [_t(a) for a in _norm_inputs(ops, seed=1)]
    leaves = [a.requires_grad_() for a in full if a is not None]
    out = FN.FusedNorm.apply(*full, 1e-6, kind)
    if isinstance(out, tuple):
        loss = (out[0] * _t(gy)).sum() + (out[1] * _t(gz)).sum()
    else:
        loss = (out * _t(gy)).sum()
    loss.backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w, atol=5e-4,
                                   rtol=5e-4)


def test_fused_norm_grads_keep_the_jax_dtypes():
    """bf16: dz rounded to z's dtype, db cast to z's dtype, dw to w's."""
    x, w, b, bias, res = (a if a is None else _t(a, torch.bfloat16)
                          for a in _norm_inputs("all"))
    w = w.float()
    leaves = [t.requires_grad_() for t in (x, w, b, bias, res)]
    y, z = FN.FusedNorm.apply(*leaves, 1e-6, "ln")
    (y.float().sum() + z.float().sum()).backward()
    assert [t.grad.dtype for t in leaves] == [torch.bfloat16, torch.float32,
                                              torch.bfloat16,
                                              torch.bfloat16,
                                              torch.bfloat16]


# -------------------------------------------- (c) the fused functionals
@pytest.mark.parametrize("name", ["fused_rms_norm", "fused_layer_norm"])
@pytest.mark.parametrize("ops", ["all", "affine"])
def test_fused_norm_functionals_match_jax(name, ops):
    x, w, b, bias, res = _norm_inputs(ops, rows=12, d=96)
    x = x.reshape(3, 4, 96)
    res = None if res is None else res.reshape(3, 4, 96)
    want = getattr(JIF, name)(
        P.to_tensor(x), P.to_tensor(w), None if b is None else
        P.to_tensor(b), epsilon=1e-5,
        bias=None if bias is None else P.to_tensor(bias),
        residual=None if res is None else P.to_tensor(res))
    got = getattr(TIF, name)(_t(x), _t(w), _t(b), epsilon=1e-5,
                             bias=_t(bias), residual=_t(res))
    if isinstance(want, (tuple, list)):
        assert len(got) == 2
        for a, c in zip(got, want):
            assert _rel(a.numpy(), c.numpy()) <= REL
    else:
        assert _rel(got.numpy(), want.numpy()) <= REL


def test_fused_norm_functionals_refuse_what_is_not_ported():
    x = torch.zeros(2, 3, 8)
    with pytest.raises(NotImplementedError, match="quant_scale"):
        TIF.fused_rms_norm(x, torch.ones(8), quant_scale=0.5)
    for fn in (TIF.fused_rms_norm, TIF.fused_layer_norm):
        with pytest.raises(NotImplementedError, match="begin_norm_axis"):
            fn(x, torch.ones(24), begin_norm_axis=1)
    # the last axis named either way is accepted
    assert TIF.fused_layer_norm(x, torch.ones(8),
                                begin_norm_axis=2).shape == x.shape


# ------------------------------------ (d) functionals and layers, f32
def _tape(fn, arrays, g):
    """JAX eager tape: fn(*tensors) and the grads of sum(out * g)."""
    ts = [P.to_tensor(a, stop_gradient=False) for a in arrays]
    out = fn(*ts)
    (out * P.to_tensor(g)).sum().backward()
    return out.numpy(), [t.grad.numpy() for t in ts]


def _port(fn, arrays, g):
    ts = [_t(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    (out * _t(g)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _rand(*shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32) \
        * 0.5


FUNCTIONALS = {
    "fused_linear": (
        lambda F: lambda x, w, b: F.fused_linear(x, w, b),
        [(2, 5, 64), (64, 32), (32,)]),
    "fused_linear_transposed": (
        lambda F: lambda x, w, b: F.fused_linear(x, w, b,
                                                 transpose_weight=True),
        [(2, 5, 64), (32, 64), (32,)]),
    "fused_matmul_bias": (
        lambda F: lambda x, w, b: F.fused_matmul_bias(x, w, b,
                                                      transpose_x=True,
                                                      transpose_y=True),
        [(64, 7), (32, 64), (32,)]),
    "fused_linear_activation": (
        lambda F: lambda x, w, b: F.fused_linear_activation(
            x, w, b, trans_x=True, activation="gelu"),
        [(2, 64, 5), (64, 32), (32,)]),
    "fused_linear_activation_relu": (
        lambda F: lambda x, w, b: F.fused_linear_activation(
            x, w, b, trans_y=True, activation="relu"),
        [(3, 64), (32, 64), (32,)]),
    "fused_dropout_add": (
        lambda F: lambda x, y: F.fused_dropout_add(x, y, p=0.0),
        [(2, 5, 16), (2, 5, 16)]),
    "fused_dropout_add_infer": (
        lambda F: lambda x, y: F.fused_dropout_add(
            x, y, p=0.3, training=False, mode="downscale_in_infer"),
        [(2, 5, 16), (2, 5, 16)]),
    "fused_bias_dropout_residual_layer_norm": (
        lambda F: lambda x, r, b, s, sb:
            F.fused_bias_dropout_residual_layer_norm(
                x, r, b, s, sb, dropout_rate=0.0),
        [(2, 6, WIDTH), (2, 6, WIDTH), (WIDTH,), (WIDTH,), (WIDTH,)]),
    "fused_multi_head_attention_pre_ln": (
        lambda F: lambda x, qw, lw, s, sb, qb, lb:
            F.fused_multi_head_attention(
                x, qw, lw, pre_layer_norm=True, pre_ln_scale=s,
                pre_ln_bias=sb, qkv_bias=qb, linear_bias=lb,
                dropout_rate=0.0, attn_dropout_rate=0.0),
        [(2, 6, WIDTH), (3, HEADS, WIDTH // HEADS, WIDTH), (WIDTH, WIDTH),
         (WIDTH,), (WIDTH,), (3, HEADS, WIDTH // HEADS), (WIDTH,)]),
    "fused_multi_head_attention_post_ln": (
        lambda F: lambda x, qw, lw, s, sb:
            F.fused_multi_head_attention(
                x, qw, lw, ln_scale=s, ln_bias=sb, dropout_rate=0.0,
                attn_dropout_rate=0.0),
        [(2, 6, WIDTH), (3, HEADS, WIDTH // HEADS, WIDTH), (WIDTH, WIDTH),
         (WIDTH,), (WIDTH,)]),
    "fused_feedforward_post_ln": (
        lambda F: lambda x, w1, w2, b1, b2, s, sb: F.fused_feedforward(
            x, w1, w2, b1, b2, ln2_scale=s, ln2_bias=sb,
            dropout1_rate=0.0, dropout2_rate=0.0, activation="gelu"),
        [(2, 6, WIDTH), (WIDTH, FFN), (FFN, WIDTH), (FFN,), (WIDTH,),
         (WIDTH,), (WIDTH,)]),
    "fused_multi_transformer": (
        # 12 per-layer lists (ln, qkv, linear, ffn ln, ffn1, ffn2: weight
        # and bias each), two layers
        lambda F: lambda x, *w: F.fused_multi_transformer(
            x, *[[w[i], w[12 + i]] for i in range(12)]),
        [(2, 6, WIDTH)] + 2 * [(WIDTH,), (WIDTH,),
                               (3, HEADS, WIDTH // HEADS, WIDTH),
                               (3, HEADS, WIDTH // HEADS), (WIDTH, WIDTH),
                               (WIDTH,), (WIDTH,), (WIDTH,), (WIDTH, FFN),
                               (FFN,), (FFN, WIDTH), (WIDTH,)]),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONALS))
def test_incubate_functionals_match_jax(name):
    make, shapes = FUNCTIONALS[name]
    arrays = [_rand(*s, seed=i) for i, s in enumerate(shapes)]
    out_t = make(TIF)(*(_t(a) for a in arrays))
    g = np.random.RandomState(99).randn(*out_t.shape).astype(np.float32)
    out_j, grads_j = _tape(make(JIF), arrays, g)
    out_t, grads_t = _port(make(TIF), arrays, g)
    assert _rel(out_t, out_j) <= REL
    for i, (a, b) in enumerate(zip(grads_t, grads_j)):
        assert _rel(a, b) <= REL, (name, i, _rel(a, b))


# (constructor, input shapes, training): the JAX and the port layer are
# built by the same call on each package's incubate.nn
LAYERS = {
    "FusedLinear": (lambda M, **kw: M.FusedLinear(64, 32, **kw),
                    [(2, 5, 64)], True),
    "FusedLinear_transposed": (
        lambda M, **kw: M.FusedLinear(64, 32, transpose_weight=True, **kw),
        [(2, 5, 64)], True),
    "FusedDropoutAdd_eval": (
        lambda M, **kw: M.FusedDropoutAdd(p=0.5),
        [(2, 5, 16), (2, 5, 16)], False),
    "FusedBiasDropoutResidualLayerNorm": (
        lambda M, **kw: M.FusedBiasDropoutResidualLayerNorm(
            WIDTH, dropout_rate=0.0, **kw),
        [(2, 6, WIDTH), (2, 6, WIDTH)], True),
    "FusedMultiHeadAttention_pre_ln": (
        lambda M, **kw: M.FusedMultiHeadAttention(
            WIDTH, HEADS, dropout_rate=0.0, attn_dropout_rate=0.0,
            normalize_before=True, **kw),
        [(2, 6, WIDTH)], True),
    "FusedMultiHeadAttention_post_ln": (
        lambda M, **kw: M.FusedMultiHeadAttention(
            WIDTH, HEADS, dropout_rate=0.0, attn_dropout_rate=0.0, **kw),
        [(2, 6, WIDTH)], True),
    "FusedFeedForward_pre_ln_gelu": (
        lambda M, **kw: M.FusedFeedForward(
            WIDTH, FFN, dropout_rate=0.0, activation="gelu",
            normalize_before=True, **kw),
        [(2, 6, WIDTH)], True),
    "FusedFeedForward_post_ln_relu": (
        lambda M, **kw: M.FusedFeedForward(WIDTH, FFN, dropout_rate=0.0,
                                           **kw),
        [(2, 6, WIDTH)], True),
    "FusedTransformerEncoderLayer": (
        lambda M, **kw: M.FusedTransformerEncoderLayer(
            WIDTH, HEADS, FFN, dropout_rate=0.0, activation="gelu", **kw),
        [(2, 6, WIDTH)], True),
    "FusedMultiTransformer": (
        lambda M, **kw: M.FusedMultiTransformer(WIDTH, HEADS, FFN,
                                                num_layers=2, **kw),
        [(2, 6, WIDTH)], False),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_incubate_layers_match_jax(name):
    make, shapes, train = LAYERS[name]
    P.seed(0)
    jm = make(jinn)
    jm.train() if train else jm.eval()
    params, buffers = jm.functional_state()
    # seeded weights away from the initialisers' ones and zeros
    rs = np.random.RandomState(7)
    params = {n: (rs.randn(*np.shape(v)) * 0.2
                  + (1.0 if "scale" in n else 0.0)).astype(np.float32)
              for n, v in params.items()}
    tm = make(tinn, device="cpu")
    tm.train(train)
    assert dict((n, tuple(p.shape)) for n, p in tm.named_parameters()) \
        == {n: v.shape for n, v in params.items()}
    load_reference_state(tm, params)
    xs = [_rand(*s, seed=10 + i) for i, s in enumerate(shapes)]
    g = _rand(*shapes[0][:-1], 32 if "Linear" in name else shapes[0][-1],
              seed=20) if "Linear" in name else _rand(*shapes[0], seed=20)

    def loss(p, *xs):
        out, _ = jm.functional_call(p, buffers, *xs)
        return jnp.sum(out * g)

    out_j, _ = jm.functional_call(params, buffers, *xs)
    grads_j = jax.jit(jax.grad(loss, argnums=tuple(range(1 + len(xs)))))(
        params, *xs)
    ts = [_t(x).requires_grad_() for x in xs]
    out = tm(*ts)
    assert _rel(out.detach().numpy(), np.asarray(out_j)) <= REL
    (out * _t(g)).sum().backward()
    for n, p in tm.named_parameters():
        want = np.asarray(grads_j[0][n])
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        assert _rel(got, want) <= REL or np.abs(got - want).max() <= 1e-7, \
            (n, _rel(got, want))
    for i, t in enumerate(ts):
        assert _rel(t.grad.numpy(), np.asarray(grads_j[1 + i])) <= REL, i


def test_fused_multi_transformer_attends_without_a_causal_mask():
    """As in JAX (:143, despite its docstring): the first token's output
    depends on the last token."""
    tm = tinn.FusedMultiTransformer(32, 2, 64, num_layers=1, device="cpu")
    tm.eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in tm.parameters():
            p.normal_(0.0, 0.5, generator=gen)
    x = torch.randn(1, 5, 32, generator=gen)
    y = x.clone()
    y[0, -1] = torch.randn(32, generator=gen)
    assert (tm(x)[0, 0] - tm(y)[0, 0]).abs().max() > 1e-3


def test_incubate_layers_refuse_dropout_in_training():
    """Dropout in training is ported: the layer's default rates (JAX's
    0.1) drop elements in training, drawn from the device generator,
    and nothing in eval."""
    from paddle_tpu_torch.core import rng

    layer = tinn.FusedFeedForward(16, 32, device="cpu")   # JAX's 0.1
    x = torch.randn(4, 8, 16, generator=torch.Generator().manual_seed(0))
    layer.eval()
    ref = layer(x)
    assert ref.shape == (4, 8, 16)
    layer.train()
    rng.seed(3)
    a = layer(x)
    rng.seed(3)
    assert torch.equal(a, layer(x))       # one generator state, one mask
    assert not torch.equal(a, ref) and torch.isfinite(a).all()


def test_incubate_layers_default_to_cuda():
    if torch.cuda.is_available():
        assert tinn.FusedLinear(4, 4).weight.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tinn.FusedMultiTransformer(32, 2, 64)


def test_encoder_train_step_trajectory_matches_jax():
    """The slice's training path as a whole, at width 128: two post-LN
    `FusedTransformerEncoderLayer`s (gelu, dropout 0), AdamW(lr 1e-3),
    the mean squared error against a seeded target, 3 f32 steps through
    each package's `build_train_step` from the same weights: per-step
    losses within 1e-4 relative.  The pre-LN scales the post-LN layers
    never read get zero gradients in both (and AdamW's decay)."""
    from paddle_tpu.distributed import fleet, topology
    from paddle_tpu_torch.distributed import build_train_step
    from paddle_tpu_torch.optimizer import AdamW

    rs = np.random.RandomState(11)
    x = rs.randn(2, 6, WIDTH).astype(np.float32)
    target = rs.randn(2, 6, WIDTH).astype(np.float32)

    def stack(M, **kw):
        return [M.FusedTransformerEncoderLayer(
            WIDTH, HEADS, FFN, dropout_rate=0.0, activation="gelu", **kw)
            for _ in range(2)]

    topology.reset_topology()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1, "sep_degree": 1,
                               "sharding_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    try:
        P.seed(0)
        jm = P.nn.Sequential(*stack(jinn))
        params, _ = jm.functional_state()
        tm = torch.nn.Sequential(*stack(tinn, device="cpu"))
        load_reference_state(tm, params)
        model = fleet.distributed_model(jm)
        opt = fleet.distributed_optimizer(P.optimizer.AdamW(
            parameters=model.parameters(), learning_rate=1e-3))
        step = model.build_train_step(opt, P.nn.MSELoss())
        jx, jt = P.to_tensor(x), P.to_tensor(target)
        want = [float(np.asarray(step(jx, jt)._value)) for _ in range(3)]
    finally:
        topology.reset_topology()

    class MSE(torch.nn.Module):
        def forward(self, out, label):
            return (out - label).square().mean()

    got = build_train_step(tm, AdamW(learning_rate=1e-3), MSE()).run_steps(
        x, target, repeat=3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert want[2] < want[0]
