"""The port's vision inference path against the JAX package's, on the CPU
in float32.

Kernel plain versions: `conv_bn_act_reference` against the JAX
`conv_bn_act_ref` and the Pallas `_conv_pallas` run in interpret mode
(dense 1x1, 3x3 at strides 1 and 2, the 7x7/s2/p3 stem, 3x3 depthwise;
relu, relu6 and none), and `window_attention_reference` against
`window_attention_ref` and the Pallas `_fwd_pallas` in interpret mode
(unshifted, shifted with the mask, a single window), both at atol =
rtol = 1e-5 (f32 reduction order; the Pallas forward and the jnp
reference themselves differ by f32 rounding).  The functionals and
layers the models use (batch norm's inference branch in f32 and bf16,
conv2d, the pools, relu6, erf GELU) against their JAX counterparts.
Whole models with the JAX model's weights and seeded batch-norm running
statistics carried across by `load_reference_state(model, params,
buffers)`: ResNet-50, ResNet-18 and ResNeXt-50 (grouped 3x3 convs on the
composed path) at 32x32, MobileNetV2 at scale 0.25, and a two-stage Swin
with a shifted block and a single-window stage, eval logits within 1e-4
of the largest reference logit.  Also: the strict name and shape check
of the buffers, what training mode refuses and runs (its batch norm and
composed convs; the training slice itself is
``tests/test_torch_vision_train.py``), and the fused gradient against
`jax.grad` of the reference.  On the CPU the kernel wrappers run their
plain versions, so nothing here launches a kernel.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import conv_norm as JCN
from paddle_tpu.ops.pallas import window_attention as JWA
from paddle_tpu.vision import models as JV
from paddle_tpu.vision.models import swin as JSW
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import conv_norm as CN
from paddle_tpu_torch.ops.kernels import window_attention as WA
from paddle_tpu_torch.vision import models as TV
from paddle_tpu_torch.vision.models import swin as TSW

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _no_launches():
    K.reset_launches()
    yield
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------ conv_bn_act
CONV_CASES = {
    # (B, Cin, H, W, Cout, k, stride, pad, depthwise)
    "dense1x1": (2, 8, 9, 9, 16, 1, 1, 0, False),
    "dense3x3s1": (2, 8, 10, 10, 12, 3, 1, 1, False),
    "dense3x3s2": (2, 8, 11, 11, 12, 3, 2, 1, False),
    "stem7x7s2": (2, 3, 16, 16, 8, 7, 2, 3, False),
    "depthwise3x3": (2, 6, 9, 9, 6, 3, 2, 1, True),
}


def _conv_inputs(case):
    b, ci, h, w, co, k, s, p, dw = CONV_CASES[case]
    rs = np.random.RandomState(sorted(CONV_CASES).index(case))
    x = rs.randn(b, ci, h, w).astype(np.float32)
    wt = (rs.randn(co, 1 if dw else ci, k, k) * 0.2).astype(np.float32)
    sc = (rs.rand(co) + 0.5).astype(np.float32)
    sh = rs.randn(co).astype(np.float32)
    return x, wt, sc, sh, s, p, dw


@pytest.mark.parametrize("act", ["relu", "relu6", None])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_bn_act_plain_matches_jax_ref_and_pallas(case, act):
    x, wt, sc, sh, s, p, dw = _conv_inputs(case)
    ref = JCN.conv_bn_act_ref(*map(jnp.asarray, (x, wt, sc, sh)), stride=s,
                              padding=p, act=act, depthwise=dw)
    h_out = (x.shape[2] + 2 * p - wt.shape[2]) // s + 1
    pallas = JCN._conv_pallas(*map(jnp.asarray, (x, wt, sc, sh)), (s, s),
                              (p, p), act, dw, h_out)
    plain = CN.conv_bn_act_reference(*map(_t, (x, wt, sc, sh)), s, p, act,
                                     dw)
    wrapped = CN.conv_bn_act(*map(_t, (x, wt, sc, sh)), stride=s,
                             padding=p, act=act)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(plain.numpy(), np.asarray(pallas), **TOL)
    assert torch.equal(wrapped, plain)


@pytest.mark.parametrize("case", ["dense3x3s2", "depthwise3x3"])
def test_conv_bn_act_grad_matches_jax_grad_of_ref(case):
    """`ConvBNAct`'s gradients (x, w, scale, shift) against jax.grad of
    `conv_bn_act_ref`, the function the JAX custom VJP differentiates."""
    x, wt, sc, sh, s, p, dw = _conv_inputs(case)
    g = np.random.RandomState(7).randn(
        *np.asarray(JCN.conv_bn_act_ref(
            *map(jnp.asarray, (x, wt, sc, sh)), stride=s, padding=p,
            act="relu", depthwise=dw)).shape).astype(np.float32)
    jg = jax.grad(lambda *a: (JCN.conv_bn_act_ref(
        *a, stride=s, padding=p, act="relu", depthwise=dw) * g).sum(),
        argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, wt, sc, sh)))
    ins = [_t(a).requires_grad_() for a in (x, wt, sc, sh)]
    out = CN.ConvBNAct.apply(*ins, (s, s), (p, p), "relu")
    out.backward(_t(g))
    for name, a, ref in zip(("x", "w", "scale", "shift"), ins, jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(ref),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


# -------------------------------------------------------- window attention
WIN_CASES = {
    # (B, H, W, C, heads, ws, shift)
    "unshifted": (2, 8, 8, 12, 3, 4, 0),
    "shifted_masked": (2, 8, 8, 8, 2, 4, 2),
    "single_window": (1, 4, 4, 8, 2, 4, 0),
    "swin_ws7_shifted": (1, 14, 14, 16, 2, 7, 3),
}


@pytest.mark.parametrize("case", sorted(WIN_CASES))
def test_window_attention_plain_matches_jax_ref_and_pallas(case):
    b, h, w, c, heads, ws, shift = WIN_CASES[case]
    rs = np.random.RandomState(sorted(WIN_CASES).index(case))
    qkv = rs.randn(b, h, w, 3 * c).astype(np.float32)
    bias = rs.randn(heads, ws * ws, ws * ws).astype(np.float32)
    mask = TSW._shift_mask((h, w), ws, shift) if shift else None
    jmask = None if mask is None else jnp.asarray(mask)
    ref = JWA.window_attention_ref(jnp.asarray(qkv), jnp.asarray(bias),
                                   jmask, window_size=ws, shift=shift,
                                   num_heads=heads)
    pallas = JWA._fwd_pallas(jnp.asarray(qkv), jnp.asarray(bias), jmask, ws,
                             shift, heads, h // ws)
    tmask = None if mask is None else _t(mask)
    plain = WA.window_attention_reference(_t(qkv), _t(bias), tmask, ws,
                                          shift, heads)
    wrapped = WA.window_attention(_t(qkv), _t(bias), tmask, ws, shift, heads)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(plain.numpy(), np.asarray(pallas), **TOL)
    assert torch.equal(wrapped, plain)


def test_window_partition_round_trip_matches_jax():
    x = np.random.RandomState(3).randn(2, 8, 12, 5).astype(np.float32)
    wins = WA.window_partition(_t(x), 4)
    np.testing.assert_array_equal(
        wins.numpy(), np.asarray(JWA.window_partition(jnp.asarray(x), 4)))
    assert torch.equal(WA.window_reverse(wins, 4, 8, 12), _t(x))


def test_swin_constants_match_jax():
    """The one-hot of the dense bias and the -100 shift mask equal the
    JAX model's (`_rel_bias_constants`, SwinBlock's mask)."""
    for ws in (4, 7):
        np.testing.assert_array_equal(TSW._bias_onehot(ws),
                                      JSW._rel_bias_constants(ws)[1])
    P.seed(0)
    jblk = JSW.SwinBlock(8, (14, 14), 2, 7, shift_size=3)
    np.testing.assert_array_equal(TSW._shift_mask((14, 14), 7, 3),
                                  jblk._attn_mask.numpy())


# ------------------------------------------------- functionals and layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_inference_matches_jax(dtype):
    rs = np.random.RandomState(4)
    x = rs.randn(2, 6, 5, 5).astype(np.float32)
    mean = rs.randn(6).astype(np.float32)
    var = (rs.rand(6) + 0.5).astype(np.float32)
    w = (rs.rand(6) + 0.5).astype(np.float32)
    b = rs.randn(6).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = JF.batch_norm(P.to_tensor(jnp.asarray(x, jd)), P.to_tensor(mean),
                        P.to_tensor(var), P.to_tensor(jnp.asarray(w, jd)),
                        P.to_tensor(jnp.asarray(b, jd)), training=False)
    got = TF.batch_norm(_t(x).to(td), _t(mean), _t(var), _t(w).to(td),
                        _t(b).to(td))
    assert got.dtype == td
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(ref.numpy()).astype(np.float32))


@pytest.mark.parametrize("stride,padding,groups", [(1, 0, 1), (2, 1, 1),
                                                   ((2, 1), (1, 0), 2)])
def test_conv2d_matches_jax(stride, padding, groups):
    rs = np.random.RandomState(5)
    x = rs.randn(2, 4, 9, 8).astype(np.float32)
    w = rs.randn(6, 4 // groups, 3, 3).astype(np.float32)
    b = rs.randn(6).astype(np.float32)
    ref = JF.conv2d(P.to_tensor(x), P.to_tensor(w), P.to_tensor(b), stride,
                    padding, 1, groups).numpy()
    got = TF.conv2d(_t(x), _t(w), _t(b), stride, padding, 1, groups)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_pools_match_jax(hw):
    x = np.random.RandomState(6).randn(2, 3, *hw).astype(np.float32)
    np.testing.assert_array_equal(
        TF.max_pool2d(_t(x), 3, 2, 1).numpy(),
        JF.max_pool2d(P.to_tensor(x), 3, 2, 1).numpy())
    np.testing.assert_allclose(
        TF.adaptive_avg_pool2d(_t(x), (1, 1)).numpy(),
        JF.adaptive_avg_pool2d(P.to_tensor(x), (1, 1)).numpy(), **TOL)


def test_activations_match_jax():
    x = np.random.RandomState(7).randn(4, 33).astype(np.float32) * 5
    np.testing.assert_array_equal(TF.relu(_t(x)).numpy(),
                                  JF.relu(P.to_tensor(x)).numpy())
    np.testing.assert_array_equal(tnn.ReLU6()(_t(x)).numpy(),
                                  JF.relu6(P.to_tensor(x)).numpy())
    np.testing.assert_allclose(tnn.GELU()(_t(x)).numpy(),
                               jnn.GELU()(P.to_tensor(x)).numpy(), **TOL)


# ------------------------------------------------------------ whole models
def _seed_bn_stats(jm, seed):
    """Running statistics drawn from `seed` (not the 0 / 1 defaults), so
    the fold of the fused path is exercised."""
    rs = np.random.RandomState(seed)
    for name, b in jm.named_buffers():
        if name.endswith("_mean"):
            b.set_value(rs.normal(0, 0.1, b.shape).astype(np.float32))
        elif name.endswith("_variance"):
            b.set_value(rs.uniform(0.5, 2.0, b.shape).astype(np.float32))


SWIN_SMALL = dict(img_size=56, embed_dim=24, depths=(2, 2), num_heads=(1, 2),
                  window_size=7, num_classes=10)
MODELS = {
    "resnet50": ("resnet50", dict(num_classes=10), 32),
    "resnet18": ("resnet18", dict(num_classes=10), 32),
    "resnext50_32x4d": ("resnext50_32x4d", dict(num_classes=10), 32),
    "mobilenetv2_x0.25": ("MobileNetV2", dict(scale=0.25, num_classes=10),
                          32),
    "swin_2stage": ("SwinTransformer", SWIN_SMALL, 56),
}


def _pair(name):
    ctor, kw, size = MODELS[name]
    P.seed(0)
    jm = getattr(JV, ctor)(**kw)
    jm.eval()
    _seed_bn_stats(jm, 1)
    tm = getattr(TV, ctor)(**kw, device="cpu")
    params, buffers = jm.functional_state()
    load_reference_state(tm, params, buffers)
    return jm, tm, size


# the other models' cases are in tests/test_torch_vision_models.py
SPLIT_MODELS = ("resnet50", "resnext50_32x4d", "swin_2stage")


@pytest.mark.parametrize("name", sorted(set(MODELS) - set(SPLIT_MODELS)))
def test_model_eval_logits_match_jax(name):
    check_eval_logits(name)


def check_eval_logits(name):
    """The model's eval logits against the JAX model's on the same
    weights and seeded batch-norm statistics, 1e-4 of the largest."""
    jm, tm, size = _pair(name)
    x = np.random.RandomState(2).randn(2, 3, size, size).astype(np.float32)
    ref = np.asarray(jm(P.to_tensor(x)).numpy())
    with torch.inference_mode():
        got = tm(_t(x)).numpy()
    assert got.shape == ref.shape == (2, 10)
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= 1e-4 * scale


def test_model_names_match_functional_state():
    """Parameter and persistent-buffer names and shapes equal the JAX
    model's ``functional_state()`` (MobileNetV2: nested Sequentials)."""
    P.seed(0)
    jm = JV.MobileNetV2(scale=0.25, num_classes=10)
    tm = TV.MobileNetV2(scale=0.25, num_classes=10, device="cpu")
    params, buffers = jm.functional_state()
    assert {n: tuple(p.shape) for n, p in tm.named_parameters()} == \
        {n: tuple(v.shape) for n, v in params.items()}
    persistent = set(tm.state_dict()) - set(params)
    assert persistent == set(buffers)
    assert "features.3.conv.1.0.weight" in params


def test_load_reference_state_checks_buffers_strictly():
    P.seed(0)
    jm = JV.resnet18(num_classes=10)
    tm = TV.resnet18(num_classes=10, device="cpu")
    params, buffers = jm.functional_state()
    short = dict(buffers)
    del short["layer2.0.downsample.1._variance"]
    with pytest.raises(KeyError, match="layer2.0.downsample.1._variance"):
        load_reference_state(tm, params, short)
    extra = dict(buffers, **{"bn9._mean": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="bn9._mean"):
        load_reference_state(tm, params, extra)
    bad = dict(buffers, **{"bn1._mean": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="bn1._mean"):
        load_reference_state(tm, params, bad)
    # without buffers the parameters alone are carried (the GPT contract)
    load_reference_state(tm, params)


def test_training_mode_is_refused():
    """What training mode runs.  Swin's dropout (`drop_rate` > 0) is
    ported: it acts in training mode only, so the eval forward equals
    that of the same weights at `drop_rate` 0, and the train forward of
    `drop_rate` 0 equals both.  Batch norm in training mode takes batch
    statistics: `_fusable` refuses to fold it, so a ResNet in train mode
    runs the composed conv, batch norm and act (no `conv_bn_act` call)
    and updates the running statistics, with logits equal to the JAX
    model's in train mode."""
    from paddle_tpu_torch.vision.models import _fused

    kw = dict(device="cpu")
    x = torch.randn(2, 3, 56, 56, generator=torch.Generator().manual_seed(3))
    dropped = TV.SwinTransformer(**SWIN_SMALL, drop_rate=0.1, **kw)
    plain = TV.SwinTransformer(**SWIN_SMALL, **kw)
    with torch.no_grad():
        want = plain(x)
        assert torch.equal(dropped(x), want)
        assert torch.equal(plain.train()(x), want)
        assert not torch.equal(dropped.train()(x), want)
    bn = tnn.BatchNorm2D(4, **kw).eval()
    conv = tnn.Conv2D(3, 4, 3, padding=1, bias_attr=False, **kw)
    assert _fused._fusable(conv, bn, "relu")
    bn.train()
    assert not _fused._fusable(conv, bn, "relu")
    jm, tm, size = _pair("resnet18")
    jm.train()
    tm.train()
    x = np.random.RandomState(2).randn(8, 3, size, size).astype(np.float32)
    ref = np.asarray(jm(P.to_tensor(x)).numpy())
    before = tm.bn1._mean.clone()
    calls = []
    kernel = CN.ConvBNAct.apply
    CN.ConvBNAct.apply = lambda *a: calls.append(1) or kernel(*a)
    try:
        got = tm(_t(x)).detach().numpy()
    finally:
        CN.ConvBNAct.apply = kernel
    assert not calls
    assert not torch.equal(tm.bn1._mean, before)
    np.testing.assert_allclose(tm.bn1._mean.numpy(), jm.bn1._mean.numpy(),
                               **TOL)
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= 1e-4 * scale


def test_swin_cpu_forward_differentiates_the_plain_version():
    """On the CPU the window wrapper runs the plain version, so a Swin
    block's rel-pos table gets a gradient there (on the card through
    the backward kernel)."""
    model = TV.SwinTransformer(**SWIN_SMALL, device="cpu")
    model(torch.randn(1, 3, 56, 56)).square().mean().backward()
    g = model.blocks[1].attn.rel_bias.grad
    assert g is not None and float(g.abs().max()) > 0
