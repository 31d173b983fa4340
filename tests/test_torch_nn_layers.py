"""The port's `nn` layers against the JAX package's, on the CPU.

Every layer class of `paddle_tpu.nn` (the recurrent family has its own
file, ``tests/test_torch_rnn.py``) is built in both packages with the
same arguments; the port's parameters and buffers are the JAX layer's
(`load_reference_state` from ``functional_state()``), and the layer runs
on the same seeded numpy inputs: outputs within rtol 1e-5 / atol 1e-6
(1e-5 for losses and convolutions), the input's and every parameter's
gradient within 1e-4 of ``jax.grad`` of the JAX layer's
`functional_call`.  The layers are built with no `device`, under
``set_device("cpu")`` (ROADMAP C2.35).  Also here: `Layer`'s Paddle
methods, `Parameter` / `ParamAttr` (a frozen parameter, the learning
rate multiplier, a named initializer), the initializers by their
moments and fans, `padding_idx`'s zero row and zero gradient, the
channel-last convolutions and norms, the containers' names, and
C1.1's layers taking the JAX signatures.
"""
from __future__ import annotations

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn as JN
from paddle_tpu.core.tensor import Tensor

import paddle_tpu_torch.nn as TN
from paddle_tpu_torch.core import device as D
from paddle_tpu_torch.models.gpt import load_reference_state
from paddle_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = D._default
    D.set_device("cpu")
    K.reset_launches()
    yield
    D._default = prev
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def _f(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _j(a):
    if isinstance(a, np.ndarray) and a.dtype == np.int64:
        a = a.astype(np.int32)
    return Tensor(jnp.asarray(a)) if isinstance(a, np.ndarray) else a


def _t(a):
    return torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(getattr(x, "_value", x))


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    if isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            _close(g, w, rtol, atol, what)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def _pair(name, args, kw):
    P.seed(0)
    jm = getattr(JN, name)(*args, **kw)
    tm = getattr(TN, name)(*args, **kw)
    params, buffers = jm.functional_state()
    load_reference_state(tm, params, buffers)
    return jm, tm


def _held(name, args, kw, inputs, train=False, rtol=RTOL, atol=ATOL,
          grad=True, fkw=None):
    """Build `name` in both packages, run it on `inputs` and compare the
    outputs; with `grad`, the gradients of sum(out * g) with respect to
    the floating inputs and every parameter against jax.grad."""
    fkw = fkw or {}
    jm, tm = _pair(name, args, kw)
    jm.train() if train else jm.eval()
    tm.train(train)
    want = jm(*(_j(a) for a in inputs), **fkw)
    got = tm(*(_t(a) for a in inputs), **fkw)
    _close(got, want, rtol, atol, name)
    if not grad:
        return tm
    g = np.asarray(np.random.RandomState(99).randn(*_np(want).shape),
                   np.float32)
    fl = [i for i, a in enumerate(inputs)
          if isinstance(a, np.ndarray) and a.dtype.kind == "f"]
    params, buffers = jm.functional_state()

    def loss(p, *xs):
        full = list(inputs)
        for i, x in zip(fl, xs):
            full[i] = x
        out, _ = jm.functional_call(p, buffers, *(
            Tensor(a) if isinstance(a, jax.Array) else _j(a)
            for a in full), **fkw)
        return jnp.sum(out * g)

    jg = jax.grad(loss, argnums=tuple(range(1 + len(fl))))(
        params, *(jnp.asarray(inputs[i]) for i in fl))
    ts = [_t(a) for a in inputs]
    for i in fl:
        ts[i] = ts[i].requires_grad_()
    tm.zero_grad()
    out = tm(*ts, **fkw)
    (out * torch.from_numpy(g)).sum().backward()
    # an input or parameter the output does not depend on: no gradient in
    # torch, zeros from jax.grad
    def grad(t):
        return torch.zeros_like(t) if t.grad is None else t.grad

    for i, w in zip(fl, jg[1:]):
        _close(grad(ts[i]), w, GRAD_TOL, GRAD_TOL, f"{name} dx{i}")
    for n, p in tm.named_parameters():
        if p.requires_grad:
            _close(grad(p), jg[0][n], GRAD_TOL, GRAD_TOL, f"{name} d{n}")
    return tm


X = _f(2, 4, 5, 6, seed=1, scale=2.0)
SEQ = _f(2, 3, 9, seed=2)
VOL = _f(2, 2, 4, 5, 3, seed=3)

# name: (constructor args, kwargs, inputs)
ACTIVATIONS = {
    "ReLU": ((), {}), "ReLU6": ((), {}), "LeakyReLU": ((0.2,), {}),
    "ELU": ((), dict(alpha=0.5)), "SELU": ((), {}), "CELU": ((1.5,), {}),
    "GELU": ((True,), {}), "Silu": ((), {}), "Swish": ((), {}),
    "Mish": ((), {}), "Hardswish": ((), {}), "Hardsigmoid": ((), {}),
    "Hardtanh": ((-0.5, 0.5), {}), "Hardshrink": ((0.3,), {}),
    "Softshrink": ((), dict(threshold=0.3)), "Tanhshrink": ((), {}),
    "Softsign": ((), {}), "Softplus": ((2, 10), {}),
    "Softmax": ((), dict(axis=1)), "LogSoftmax": ((2,), {}),
    "LogSigmoid": ((), {}), "Sigmoid": ((), {}), "Tanh": ((), {}),
    "GLU": ((), dict(axis=-1)), "Maxout": ((2,), {}),
    "ThresholdedReLU": ((0.4,), {}), "PReLU": ((4, 0.1), {}),
    "RReLU": ((0.1, 0.2), {}), "Softmax2D": ((), {}),
}


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_activation_layer_matches_jax(name):
    args, kw = ACTIVATIONS[name]
    _held(name, args, kw, (X,))


LAYERS = {
    "Linear": ((6, 3), {}, (X,)),
    "Linear_no_bias": ((6, 3), dict(bias_attr=False), (X,)),
    "Bilinear": ((3, 4, 2), {}, (_f(5, 3, seed=4), _f(5, 4, seed=5))),
    "Flatten": ((), dict(start_axis=1, stop_axis=2), (X,)),
    "Unflatten": ((1, [2, 2]), {}, (X,)),
    "Identity": ((3, "ignored"), {}, (X,)),
    "Upsample": ((), dict(scale_factor=2), (X,)),
    "Upsample_bilinear": ((), dict(size=[7, 9], mode="bilinear"), (X,)),
    "UpsamplingBilinear2D": ((), dict(size=[3, 4]), (X,)),
    "UpsamplingNearest2D": ((), dict(scale_factor=3), (X,)),
    "Pad1D": ((2,), dict(mode="reflect"), (SEQ,)),
    "Pad2D": (([1, 0, 2, 1],), dict(mode="replicate"), (X,)),
    "Pad2D_nhwc": (([1, 2, 0, 1],), dict(value=0.5, data_format="NHWC"),
                   (X,)),
    "Pad3D": ((1,), dict(mode="circular"), (VOL,)),
    "ZeroPad2D": (([1, 1, 0, 2],), {}, (X,)),
    "CosineSimilarity": ((), dict(axis=2), (X, X[::-1].copy())),
    "PairwiseDistance": ((3.0,), {}, (X, X[::-1].copy())),
    "PixelShuffle": ((2,), {}, (X,)),
    "PixelUnshuffle": ((2,), dict(data_format="NHWC"),
                       (_f(2, 4, 6, 3, seed=6),)),
    "ChannelShuffle": ((2,), {}, (X,)),
    "Unfold": (([2, 3],), dict(strides=1, paddings=1), (X,)),
    "Fold": (([5, 6], 2), {}, (_f(2, 16, 20, seed=7),)),
    "LayerNorm": (([5, 6],), dict(epsilon=1e-4), (X,)),
    "LayerNorm_no_affine": ((6,), dict(weight_attr=False,
                                       bias_attr=False), (X,)),
    "RMSNorm": ((6,), {}, (X,)),
    "GroupNorm": ((2, 4), {}, (X,)),
    "GroupNorm_nhwc": ((3, 6), dict(data_format="NHWC"), (X,)),
    "InstanceNorm1D": ((3,), {}, (SEQ,)),
    "InstanceNorm2D": ((4,), {}, (X,)),
    "InstanceNorm3D": ((2,), dict(weight_attr=False), (VOL,)),
    "LocalResponseNorm": ((3,), {}, (X,)),
    "SpectralNorm": (([4, 5, 6],), dict(axis=1, power_iters=2),
                     (_f(4, 5, 6, seed=8),)),
    "Conv1D": ((3, 4, 3), dict(stride=2, padding=1), (SEQ,)),
    "Conv1D_nlc": ((9, 4, 2), dict(padding="SAME", data_format="NLC"),
                   (SEQ,)),
    "Conv2D": ((4, 6, 3), dict(padding=[1, 0, 1, 2], dilation=2), (X,)),
    "Conv2D_nhwc": ((6, 4, 3), dict(padding=1, groups=2,
                                    data_format="NHWC"), (X,)),
    "Conv3D": ((2, 3, 2), dict(padding=1, stride=[1, 2, 1]), (VOL,)),
    "Conv1DTranspose": ((3, 2, 3), dict(stride=2, output_padding=1),
                        (SEQ,)),
    "Conv2DTranspose": ((4, 6, 3), dict(stride=2, padding=1, groups=2),
                        (X,)),
    "Conv2DTranspose_nhwc": ((6, 2, 2), dict(stride=2, data_format="NHWC"),
                             (X,)),
    "Conv3DTranspose": ((2, 2, 2), dict(stride=2), (VOL,)),
    "AvgPool1D": ((3,), dict(stride=2, padding=1), (SEQ,)),
    "AvgPool2D": ((2,), dict(stride=1, padding=1, exclusive=False), (X,)),
    "AvgPool3D": ((2,), {}, (VOL,)),
    "MaxPool1D": ((2,), {}, (SEQ,)),
    "MaxPool2D": ((3,), dict(stride=2, padding=1), (X,)),
    "MaxPool2D_nhwc": ((2,), dict(data_format="NHWC"), (X,)),
    "MaxPool3D": ((2,), dict(stride=1), (VOL,)),
    "AdaptiveAvgPool1D": ((4,), {}, (SEQ,)),
    "AdaptiveAvgPool2D": (([3, 4],), {}, (X,)),
    "AdaptiveAvgPool3D": ((2,), {}, (VOL,)),
    "AdaptiveMaxPool1D": ((4,), {}, (SEQ,)),
    "AdaptiveMaxPool2D": ((2,), {}, (X,)),
    "AdaptiveMaxPool3D": (([3, 2, 1],), {}, (VOL,)),
    "BatchNorm1D": ((3,), {}, (SEQ,)),
    "BatchNorm2D": ((4,), dict(momentum=0.8), (X,)),
    "BatchNorm2D_nhwc": ((6,), dict(data_format="NHWC"), (X,)),
    "BatchNorm3D": ((2,), {}, (VOL,)),
    "BatchNorm": ((4,), dict(use_global_stats=True), (X,)),
    "SyncBatchNorm": ((4,), {}, (X,)),
}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layer_matches_jax(case, train):
    args, kw, inputs = LAYERS[case]
    name = case.split("_")[0]
    tol = 1e-5 if "Conv" in name or "Norm" in name else ATOL
    tm = _held(name, args, kw, inputs, train=train, atol=tol)
    assert isinstance(tm, TN.Layer)


@pytest.mark.parametrize("training", [False, True])
def test_batch_norm_layer_updates_running_stats_like_jax(training):
    jm, tm = _pair("BatchNorm2D", (4,), dict(momentum=0.7))
    jm.train() if training else jm.eval()
    tm.train(training)
    for seed in (1, 2):
        x = _f(3, 4, 5, 5, seed=seed)
        _close(tm(_t(x)), jm(_j(x)), atol=1e-5)
    _close(tm._mean, jm._mean)
    _close(tm._variance, jm._variance)


def test_dropout_layers_by_their_properties():
    x = torch.ones(8, 16, 4, 4)
    for layer in (TN.Dropout(0.3), TN.Dropout2D(0.3), TN.AlphaDropout(0.3),
                  TN.Dropout(0.3, axis=1)):
        layer.train()
        assert not torch.equal(layer(x), x)
        layer.eval()
        assert torch.equal(layer(x), x)
    d3 = TN.Dropout3D(0.5)
    y = d3(torch.ones(4, 8, 2, 3, 3))
    per_channel = y.reshape(4, 8, -1)
    assert ((per_channel == 0).all(-1) | (per_channel == 2).all(-1)).all()
    down = TN.Dropout(0.3, mode="downscale_in_infer").eval()
    _close(down(_t(X)), JN.Dropout(0.3, mode="downscale_in_infer").eval()(
        _j(X)))


LOSSES = {
    "CrossEntropyLoss": ((), dict(label_smoothing=0.1, ignore_index=1),
                         (_f(6, 5, seed=10), np.array([0, 1, 4, 2, 2, 3]))),
    "MSELoss": ((), {}, (_f(4, 3, seed=11), _f(4, 3, seed=12))),
    "L1Loss": ((), dict(reduction="sum"), (_f(4, 3, seed=11),
                                           _f(4, 3, seed=12))),
    "NLLLoss": ((), {}, (np.log(np.full((4, 3), 1 / 3, np.float32)
                                + _f(4, 3, seed=13, scale=0.01) ** 2),
                         np.array([0, 2, 1, 1]))),
    "BCELoss": ((), {}, (np.full((4, 3), 0.3, np.float32),
                         (_f(4, 3, seed=14) > 0).astype(np.float32))),
    "BCEWithLogitsLoss": ((), {}, (_f(4, 3, seed=15),
                                   (_f(4, 3, seed=16) > 0).astype(
                                       np.float32))),
    "KLDivLoss": ((), dict(reduction="batchmean"),
                  (np.log(np.full((2, 4), 0.25, np.float32)),
                   np.full((2, 4), 0.25, np.float32))),
    "SmoothL1Loss": ((), dict(delta=0.5), (_f(4, 3, seed=17),
                                           _f(4, 3, seed=18))),
    "MarginRankingLoss": ((0.1,), {}, (_f(5, seed=19), _f(5, seed=20),
                                       np.sign(_f(5, seed=21)))),
    "CosineEmbeddingLoss": ((0.2,), {}, (_f(4, 6, seed=22),
                                         _f(4, 6, seed=23),
                                         np.sign(_f(4, seed=24)))),
    "TripletMarginLoss": ((), dict(p=1.0, swap=True),
                          (_f(3, 5, seed=25), _f(3, 5, seed=26),
                           _f(3, 5, seed=27))),
    "TripletMarginWithDistanceLoss": ((), dict(margin=0.5),
                                      (_f(3, 5, seed=25),
                                       _f(3, 5, seed=26),
                                       _f(3, 5, seed=27))),
    "SoftMarginLoss": ((), {}, (_f(4, 3, seed=28),
                                np.sign(_f(4, 3, seed=29)))),
    "MultiLabelSoftMarginLoss": ((), {}, (_f(4, 3, seed=30),
                                          (_f(4, 3, seed=31) > 0).astype(
                                              np.float32))),
    "MultiMarginLoss": ((), dict(margin=0.3), (_f(4, 5, seed=32),
                                               np.array([0, 4, 2, 1]))),
    "HingeEmbeddingLoss": ((0.5,), {}, (_f(4, 3, seed=33),
                                        np.sign(_f(4, 3, seed=34)))),
    "PoissonNLLLoss": ((), dict(full=True), (_f(4, 3, seed=35),
                                             np.abs(_f(4, 3, seed=36)) * 3)),
    "GaussianNLLLoss": ((), {}, (_f(4, 3, seed=37), _f(4, 3, seed=38),
                                 np.abs(_f(4, 3, seed=39)) + 0.1)),
    "HSigmoidLoss": ((4, 6), {}, (_f(5, 4, seed=40),
                                  np.array([0, 5, 3, 2, 1]))),
    "CTCLoss": ((0,), {}, (np.log(np.full((8, 2, 5), 0.2, np.float32)),
                           np.array([[1, 2, 3], [4, 4, 1]]),
                           np.array([8, 6]), np.array([3, 2]))),
    "RNNTLoss": ((), dict(fastemit_lambda=0.0),
                 (_f(2, 4, 3, 5, seed=41), np.array([[1, 2], [3, 0]]),
                  np.array([4, 3]), np.array([2, 1]))),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_layer_matches_jax(name):
    args, kw, inputs = LOSSES[name]
    inputs = tuple(a.astype(np.int64) if a.dtype.kind == "i" else a
                   for a in inputs)
    _held(name, args, kw, inputs, rtol=1e-5, atol=1e-5)


def test_max_unpool_layers_match_jax():
    x = _f(2, 3, 4, 6, seed=42)
    jm = JN.MaxPool2D(2, return_mask=True)
    tm = TN.MaxPool2D(2, return_mask=True)
    (jv, ji), (tv, ti) = jm(_j(x)), tm(_t(x))
    _close(tv, jv)
    _close(ti, ji)
    _close(TN.MaxUnPool2D(2)(tv, ti), JN.MaxUnPool2D(2)(jv, ji))
    x1 = _f(2, 3, 4, seed=43)
    idx1 = np.stack([np.random.RandomState(i).choice(8, 4, replace=False)
                     for i in range(6)]).reshape(2, 3, 4)
    _close(TN.MaxUnPool1D(2)(_t(x1), _t(idx1)),
           JN.MaxUnPool1D(2)(_j(x1), _j(idx1.astype(np.int64))))
    x3 = _f(1, 2, 1, 2, 2, seed=44)
    idx3 = np.stack([np.random.RandomState(i).choice(32, 4, replace=False)
                     for i in range(2)]).reshape(1, 2, 1, 2, 2)
    _close(TN.MaxUnPool3D(2)(_t(x3), _t(idx3)),
           JN.MaxUnPool3D(2)(_j(x3), _j(idx3.astype(np.int64))))


# ------------------------------------------------------------ containers
def test_containers_name_their_children_as_jax():
    def build(N):
        P.seed(0)
        seq = N.Sequential(N.Linear(4, 4), N.ReLU(), N.Linear(4, 2))
        lst = N.LayerList([N.Linear(2, 2)])
        lst.append(N.Linear(2, 3))
        lst.insert(0, N.Identity())
        dct = N.LayerDict({"a": N.Linear(3, 3)})
        dct["b"] = N.Linear(3, 1)
        return seq, lst, dct

    for jc, tc in zip(build(JN), build(TN)):
        jn = sorted(n for n, _ in jc.named_parameters())
        tn = sorted(n for n, _ in tc.named_parameters())
        assert jn == tn
    seq = build(TN)[0]
    assert len(seq) == 3 and isinstance(seq[1], TN.ReLU)
    assert len(seq[1:]) == 2
    plist = TN.ParameterList([TN.Parameter(torch.ones(2))])
    plist.append(TN.Parameter(torch.zeros(3)))
    assert [n for n, _ in plist.named_parameters()] == ["0", "1"]
    dct = build(TN)[2]
    assert list(dct.keys()) == ["a", "b"] and "a" in dct
    dct.pop("a")
    assert list(dct) == ["b"]


# ------------------------------------------------------ Layer, Parameter
class _Net(TN.Layer):
    def __init__(self):
        super().__init__()
        self.w = self.create_parameter([3, 4])
        self.b = self.create_parameter([4], is_bias=True)
        self.fc = TN.Linear(4, 2)
        self.register_buffer("steps", torch.zeros(()), persistable=False)
        self.register_buffer("stat", np.ones(2, np.float32))

    def forward(self, x):
        return self.fc(x @ self.w + self.b)


def test_layer_has_paddle_methods():
    net = _Net()
    assert isinstance(net.w, TN.Parameter) and net.w.device.type == "cpu"
    assert not net.b.any()
    bound = 1 / math.sqrt(3)
    assert net.w.abs().max() <= bound
    assert sorted(net.state_dict()) == ["b", "fc.bias", "fc.weight",
                                        "stat", "w"]
    assert [n for n, _ in net.named_sublayers()] == ["fc"]
    assert net.sublayers() == [net.fc]
    assert net.sublayers(include_self=True)[0] is net
    assert net.full_name() == "_net"
    seen = []
    h = net.register_forward_pre_hook(lambda m, i: seen.append("pre"))
    h2 = net.register_forward_post_hook(lambda m, i, o: o * 0)
    out = net(torch.ones(1, 3))
    assert seen == ["pre"] and not out.any()
    h.remove()
    h2.remove()
    assert net(torch.ones(1, 3)).any() and seen == ["pre"]
    state = {k: v.detach().clone() + 1 for k, v in net.state_dict().items()}
    missing, unexpected = net.set_state_dict(dict(state, extra=1))
    assert missing == [] and unexpected == ["extra"]
    assert torch.equal(net.w, state["w"])
    with pytest.raises(ValueError, match="shape mismatch"):
        net.set_state_dict({"w": np.zeros((2, 2), np.float32)})
    net(torch.ones(1, 3)).sum().backward()
    net.clear_gradients()
    assert not net.w.grad.any()
    net.to(dtype="float16")
    assert net.w.dtype == torch.float16 and net.stat.dtype == torch.float16
    net.astype("bfloat16")
    assert net.fc.weight.dtype == torch.bfloat16
    net.eval()
    assert not net.fc.training
    sub = net.add_sublayer("extra", TN.ReLU())
    assert sub is net.extra
    p = net.add_parameter("scale", TN.Parameter(torch.ones(1)))
    assert p is net.scale


def test_parameter_flags_and_deepcopy():
    p = TN.Parameter(torch.ones(3))
    assert p.trainable and not p.stop_gradient
    p.stop_gradient = True
    assert not p.requires_grad and not p.trainable
    p.trainable = True
    assert p.requires_grad
    p.name = "w0"
    p.optimize_attr["learning_rate"] = 0.5
    q = copy.deepcopy(p)
    assert isinstance(q, TN.Parameter) and q.name == "w0" \
        and q.optimize_attr == {"learning_rate": 0.5}


def test_param_attr_reaches_the_parameter():
    from paddle_tpu_torch.nn import initializer as I

    frozen = TN.ParamAttr(name="w", initializer=I.Constant(0.5),
                          learning_rate=0.1, trainable=False)
    lin = TN.Linear(3, 2, weight_attr=frozen,
                    bias_attr=TN.ParamAttr(initializer=I.Constant(2.0)))
    assert (lin.weight == 0.5).all() and not lin.weight.requires_grad
    assert lin.weight.name == "w" and \
        lin.weight.optimize_attr["learning_rate"] == 0.1
    assert (lin.bias == 2.0).all()
    lin(torch.ones(1, 3)).sum().backward()
    assert lin.weight.grad is None and lin.bias.grad is not None
    # the JAX layer with the same attributes
    J = P.nn.initializer
    jl = JN.Linear(3, 2, weight_attr=JN.ParamAttr(
        initializer=J.Constant(0.5)), bias_attr=JN.ParamAttr(
        initializer=J.Constant(2.0)))
    _close(lin(torch.ones(1, 3)), jl(_j(np.ones((1, 3), np.float32))))
    # the optimizer reads the multiplier, and skips the frozen weight
    from paddle_tpu_torch.optimizer import SGD

    lin2 = TN.Linear(3, 2, weight_attr=TN.ParamAttr(learning_rate=0.5))
    w0 = lin2.weight.detach().clone()
    opt = SGD(learning_rate=1.0, parameters=lin2.parameters())
    lin2(torch.ones(1, 3)).sum().backward()
    g = lin2.weight.grad.clone()
    opt.step()
    _close(lin2.weight, w0 - 0.5 * g)


# ---------------------------------------------------------- initializers
def _draw(init, shape, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return init(shape, torch.float32, device="cpu", generator=gen)


@pytest.mark.parametrize("name,kw,shape,mean,std", [
    ("Normal", dict(mean=0.5, std=2.0), [400, 300], 0.5, 2.0),
    ("Uniform", dict(low=-2.0, high=1.0), [400, 300], -0.5, 3 / 12 ** 0.5),
    ("XavierNormal", {}, [300, 500], 0.0, (2 / 800) ** 0.5),
    ("XavierUniform", {}, [300, 500], 0.0, (6 / 800) ** 0.5 / 3 ** 0.5),
    ("KaimingNormal", {}, [64, 32, 3, 3], 0.0, (2 / 288) ** 0.5),
    ("KaimingUniform", dict(fan_in=50), [200, 300], 0.0,
     (6 / 50) ** 0.5 / 3 ** 0.5),
    ("TruncatedNormal", dict(std=1.0), [400, 300], 0.0, 0.8796),
])
def test_initializer_moments_and_fans(name, kw, shape, mean, std):
    from paddle_tpu_torch.nn import initializer as I

    t = _draw(getattr(I, name)(**kw), shape)
    assert t.shape == tuple(shape) and t.dtype == torch.float32
    n = t.numel()
    assert abs(t.mean().item() - mean) < 5 * std / n ** 0.5
    assert abs(t.std().item() - std) < 0.02 * std
    # the JAX initializer's draw has the same moments
    ref = np.asarray(getattr(P.nn.initializer, name)(**kw)(shape,
                                                           jnp.float32))
    assert abs(ref.std() - t.std().item()) < 0.03 * std


def test_other_initializers():
    from paddle_tpu_torch.nn import initializer as I

    assert (_draw(I.Constant(3.0), [2, 2]) == 3).all()
    v = np.arange(6, dtype=np.float32)
    assert np.array_equal(_draw(I.Assign(v), [2, 3]).numpy(),
                          v.reshape(2, 3))
    q = _draw(I.Orthogonal(gain=2.0), [4, 6]).reshape(4, 6)
    np.testing.assert_allclose((q @ q.T).numpy(), 4 * np.eye(4), atol=1e-5)
    d = _draw(I.Dirac(groups=2), [4, 2, 3, 3])
    jd = np.asarray(P.nn.initializer.Dirac(groups=2)([4, 2, 3, 3],
                                                    jnp.float32))
    assert np.array_equal(d.numpy(), jd)
    for nl, a in (("relu", None), ("tanh", None), ("leaky_relu", 0.2),
                  ("selu", None), ("conv2d", None)):
        assert I.calculate_gain(nl, a) == \
            P.nn.initializer.calculate_gain(nl, a)
    assert I._fans([3, 4, 5, 5]) == P.nn.initializer._fans([3, 4, 5, 5])


def test_default_initializers_are_jaxs():
    """Linear: Xavier-uniform [in, out]; Conv: Kaiming-uniform over
    Cin / groups * k; Embedding: N(0, 1); create_parameter: U(+-1 /
    sqrt(fan_in)); biases zero; norms ones and zeros."""
    lin = TN.Linear(300, 500, generator=torch.Generator().manual_seed(0))
    assert lin.weight.abs().max() <= (6 / 800) ** 0.5
    assert abs(lin.weight.std().item() - (2 / 800) ** 0.5) < 0.002
    conv = TN.Conv2D(16, 32, 3, groups=2)
    assert conv.weight.abs().max() <= (6 / 72) ** 0.5
    assert abs(conv.weight.std().item() - (2 / 72) ** 0.5) < 0.01
    emb = TN.Embedding(1000, 64)
    assert abs(emb.weight.std().item() - 1.0) < 0.02
    ln = TN.LayerNorm(8)
    assert (ln.weight == 1).all() and not ln.bias.any()


# ------------------------------------------------------------ C1.1 cases
def test_c1_1_linear_embedding_conv_take_jax_signatures():
    """ROADMAP C1.1: nn.Linear(4, 8, bias_attr=False), nn.Embedding(10, 4,
    padding_idx=0) and nn.Conv2D(..., data_format="NHWC") build with no
    device under set_device("cpu") and match JAX at the same weights."""
    _held("Linear", (4, 8), dict(bias_attr=False), (_f(3, 4, seed=50),))
    ids = np.array([[0, 3, 9, 0], [5, 0, 1, 2]], np.int64)
    jm, tm = _pair("Embedding", (10, 4), dict(padding_idx=0))
    assert not tm.weight[0].any()
    _close(tm(_t(ids)), jm(_j(ids)))
    tm(_t(ids)).sum().backward()
    assert not tm.weight.grad[0].any() and tm.weight.grad[3].any()
    x = _f(2, 6, 7, 3, seed=51)
    _held("Conv2D", (3, 5, 3), dict(stride=2, padding=1,
                                    data_format="NHWC"), (x,), atol=1e-5)
    _held("BatchNorm2D", (3,), dict(data_format="NHWC",
                                    use_global_stats=True), (x,),
          train=True, atol=1e-5)


def test_every_jax_layer_class_resolves():
    """Every layer class of the JAX `nn` has its port (the recurrent
    family among them), as do `dynamic_decode`, `nn.utils` and
    `nn.quant`."""
    import inspect

    missing = {n for n in dir(JN) if not n.startswith("_")
               and inspect.isclass(getattr(JN, n)) and not hasattr(TN, n)}
    assert missing == set()
    assert callable(TN.dynamic_decode)
    assert set(JN.utils.__all__) <= set(dir(TN.utils))
    assert set(JN.quant.__all__) <= set(dir(TN.quant))
    for n in dir(TN):
        obj = getattr(TN, n)
        if inspect.isclass(obj) and issubclass(obj, torch.nn.Module):
            assert issubclass(obj, TN.Layer), n
