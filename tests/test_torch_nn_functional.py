"""The port's `nn.functional` against the JAX package's, on the CPU.

One parametrised table a module: every public function of
`paddle_tpu.nn.functional` runs in both packages on the same seeded
numpy inputs, f32, and agrees within rtol 1e-5 / atol 1e-6 (losses 1e-5),
its gradients (where the table asks for them) within 1e-4 of
``jax.grad``.  The functions that draw random numbers (`dropout*`,
`alpha_dropout`, `gumbel_softmax`, `rrelu`) are held by their
properties, their deterministic modes against JAX; the in-place forms
mutate their argument.  Also here: every public function of the JAX
module resolves in the port, and `sdp_kernel`'s policy.
"""
from __future__ import annotations

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Tensor

import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def _rs(seed=0):
    return np.random.RandomState(seed)


def _f(*shape, seed=0, scale=1.0):
    return (_rs(seed).randn(*shape) * scale).astype(np.float32)


def _j(a):
    if isinstance(a, np.ndarray):
        if a.dtype == np.int64:
            a = a.astype(np.int32)
        return Tensor(jnp.asarray(a))
    return a


def _t(a):
    return torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(getattr(x, "_value", x))


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for g, w in zip(got, want):
            _close(g, w, rtol, atol, what)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if w.dtype.kind in "iub":
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), rtol=rtol,
                                   atol=atol, err_msg=what)


def _fname(case):
    """The function a table case runs: the longest "_"-prefix of its
    name that the functional module has."""
    parts = case.split("_")
    for n in range(len(parts), 0, -1):
        if hasattr(TF, "_".join(parts[:n])):
            return "_".join(parts[:n])
    raise KeyError(case)


def _run(name, args, kw, rtol=RTOL, atol=ATOL, grad=()):
    """`name` in both packages on `args` (numpy arrays or plain values)
    and `kw`; with `grad` (argument indices) also the gradients of
    sum(out * g) against jax.grad."""
    want = getattr(JF, name)(*(_j(a) for a in args), **kw)
    got = getattr(TF, name)(*(_t(a) for a in args), **kw)
    _close(got, want, rtol, atol, name)
    if not grad:
        return
    g = np.asarray(_rs(99).randn(*_np(want).shape), np.float32)

    def loss(*vals):
        full = list(args)
        for i, v in zip(grad, vals):
            full[i] = v
        out = getattr(JF, name)(*(Tensor(a) if isinstance(a, jax.Array)
                                  else _j(a) for a in full), **kw)
        return jnp.sum(out._value * g)

    jg = jax.grad(loss, argnums=tuple(range(len(grad))))(
        *(jnp.asarray(args[i]) for i in grad))
    ts = [_t(a) for a in args]
    for i in grad:
        ts[i] = ts[i].requires_grad_()
    out = getattr(TF, name)(*ts, **kw)
    (out * torch.from_numpy(g)).sum().backward()
    for i, w in zip(grad, jg):
        _close(ts[i].grad, w, GRAD_TOL, GRAD_TOL, f"{name} d{i}")


# ------------------------------------------------------------ activation
X = _f(3, 4, 6, seed=1, scale=2.0)
ACTIVATION = {
    "relu": ((X,), {}, (0,)),
    "relu6": ((X * 4,), {}, (0,)),
    "leaky_relu": ((X,), dict(negative_slope=0.2), (0,)),
    "prelu": ((X, np.array([0.1, 0.2, 0.3, 0.4], np.float32)), {}, (0, 1)),
    "prelu_scalar": ((X, np.array([0.25], np.float32)), {}, (0,)),
    "prelu_nhwc": ((X.transpose(0, 2, 1), np.array(
        [0.1, 0.2, 0.3, 0.4], np.float32)), dict(data_format="NHWC"), (0,)),
    "elu": ((X,), dict(alpha=0.7), (0,)),
    "selu": ((X,), {}, (0,)),
    "celu": ((X,), dict(alpha=1.3), (0,)),
    "gelu": ((X,), {}, (0,)),
    "gelu_tanh": ((X,), dict(approximate=True), (0,)),
    "silu": ((X,), {}, (0,)),
    "swish": ((X,), {}, (0,)),
    "mish": ((X,), {}, (0,)),
    "hardswish": ((X,), {}, (0,)),
    "hardsigmoid": ((X,), {}, (0,)),
    "hardtanh": ((X,), dict(min=-0.5, max=0.8), (0,)),
    "hardshrink": ((X,), dict(threshold=0.7), (0,)),
    "softshrink": ((X,), dict(threshold=0.7), (0,)),
    "tanhshrink": ((X,), {}, (0,)),
    "softsign": ((X,), {}, (0,)),
    "softplus": ((X * 10,), dict(beta=2, threshold=15), (0,)),
    "softmax": ((X,), dict(axis=1), (0,)),
    "log_softmax": ((X,), dict(axis=-1), (0,)),
    "log_sigmoid": ((X,), {}, (0,)),
    "sigmoid": ((X,), {}, (0,)),
    "tanh": ((X,), {}, (0,)),
    "glu": ((X,), dict(axis=-1), (0,)),
    "maxout": ((X,), dict(groups=2, axis=2), (0,)),
    "thresholded_relu": ((X,), dict(threshold=0.5, value=0.1), (0,)),
    "swiglu": ((X,), {}, (0,)),
    "swiglu_pair": ((X, X[::-1].copy()), {}, (0, 1)),
    "rrelu_eval": ((X,), dict(lower=0.1, upper=0.3, training=False), (0,)),
}


@pytest.mark.parametrize("case", sorted(ACTIVATION))
def test_activation_matches_jax(case):
    args, kw, grad = ACTIVATION[case]
    _run(_fname(case), args, kw, grad=grad)


@pytest.mark.parametrize("name,kw", [
    ("relu_", {}), ("elu_", dict(alpha=0.5)),
    ("hardtanh_", dict(min=-0.3, max=0.4)),
    ("leaky_relu_", dict(negative_slope=0.3)), ("softmax_", dict(axis=0)),
    ("tanh_", {}), ("thresholded_relu_", dict(threshold=0.2)),
])
def test_inplace_activation_mutates_its_argument(name, kw):
    want = getattr(JF, name)(_j(X), **kw)
    t = _t(X)
    got = getattr(TF, name)(t, **kw)
    assert got is t
    _close(t, want, what=name)


def test_random_activations_by_their_properties():
    x = torch.from_numpy(_f(64, 10, seed=2))
    y = TF.gumbel_softmax(x, temperature=0.5)
    assert torch.allclose(y.sum(-1), torch.ones(64))
    h = TF.gumbel_softmax(x.requires_grad_(), hard=True, axis=0)
    assert ((h == 0) | (h == 1)).all() and (h.sum(0) == 1).all()
    h.sum().backward()
    assert x.grad is not None
    neg = -torch.rand(4096) - 0.1
    out = TF.rrelu(neg, 0.1, 0.3, training=True)
    slope = out / neg
    assert slope.min() >= 0.1 and slope.max() <= 0.3
    assert slope.std() > 0.03          # drawn per element
    pos = torch.rand(16)
    assert torch.equal(TF.rrelu(pos, training=True), pos)


# ---------------------------------------------------------------- common
IDS = _rs(3).randint(0, 10, (3, 5)).astype(np.int64)
IDS[0, :2] = 0
IMG = _f(2, 3, 6, 7, seed=4)
VOL = _f(2, 2, 4, 5, 3, seed=5)
SEQ = _f(2, 3, 9, seed=6)
COMMON = {
    "linear": ((_f(4, 6, seed=7), _f(6, 5, seed=8), _f(5, seed=9)), {},
               (0, 1, 2)),
    "embedding": ((IDS, _f(10, 4, seed=10)), {}, (1,)),
    "embedding_pad": ((IDS, _f(10, 4, seed=10)), dict(padding_idx=0),
                      (1,)),
    "bilinear": ((_f(4, 3, seed=11), _f(4, 5, seed=12), _f(2, 3, 5, seed=13),
                  _f(2, seed=14)), {}, (0, 1, 2, 3)),
    "pad_const_nchw": ((IMG, [1, 2, 0, 3]), dict(value=0.5), (0,)),
    "pad_reflect": ((IMG, [2, 1, 1, 2]), dict(mode="reflect"), (0,)),
    "pad_replicate_nhwc": ((IMG, [1, 2, 2, 1]), dict(
        mode="replicate", data_format="NHWC"), (0,)),
    "pad_circular": ((IMG, [3, 1, 2, 2]), dict(mode="circular"), (0,)),
    "pad_full": ((SEQ, [1, 0, 0, 2, 3, 1]), {}, (0,)),
    "pad_ncl": ((SEQ, [2, 3]), dict(mode="reflect", data_format="NCL"),
                (0,)),
    "pad_ncdhw": ((VOL, [1, 1, 0, 2, 1, 0]), dict(
        mode="replicate", data_format="NCDHW"), (0,)),
    "zeropad2d": ((IMG, [1, 0, 2, 1]), {}, (0,)),
    "unfold": ((IMG, [2, 3]), dict(strides=[1, 2], paddings=1,
                                    dilations=[2, 1]), (0,)),
    "unfold_asym": ((IMG, 2), dict(paddings=[1, 0, 2, 1]), (0,)),
    "fold": ((_f(2, 12, 20, seed=15), [5, 6], [2, 2]), dict(
        strides=1, paddings=[0, 0]), (0,)),
    "fold_pad": ((_f(2, 8, 24, seed=16), [4, 6], 2), dict(
        strides=[1, 1], paddings=[1, 0, 0, 1], dilations=1), (0,)),
    "cosine_similarity": ((_f(4, 6, seed=17), _f(4, 6, seed=18)),
                          dict(axis=1), (0, 1)),
    "pairwise_distance": ((_f(4, 6, seed=17), _f(4, 6, seed=18)), {},
                          (0, 1)),
    "pairwise_distance_p1": ((_f(4, 6, seed=17), _f(4, 6, seed=18)),
                             dict(p=1.0, keepdim=True), (0, 1)),
    "label_smooth": ((np.eye(5, dtype=np.float32)[[0, 3, 1]],),
                     dict(epsilon=0.2), (0,)),
    "label_smooth_prior": ((np.eye(4, dtype=np.float32)[[0, 3]],
                            np.full((1, 4), 0.25, np.float32)), {}, (0,)),
    "one_hot": ((np.array([0, 3, 1, 4], np.int64),), dict(num_classes=5),
                ()),
    "sequence_mask": ((np.array([2, 0, 4], np.int64),), dict(maxlen=5),
                      ()),
    "normalize": ((_f(3, 5, seed=19),), dict(p=2, axis=1), (0,)),
    "normalize_p3": ((_f(3, 5, seed=19),), dict(p=3, axis=0), (0,)),
    "temporal_shift": ((_f(6, 8, 3, 3, seed=20),), dict(seg_num=3),
                       (0,)),
    "temporal_shift_nhwc": ((_f(4, 3, 3, 8, seed=21),), dict(
        seg_num=2, shift_ratio=0.25, data_format="NHWC"), (0,)),
    "gather_tree": ((_rs(22).randint(0, 9, (5, 2, 3)).astype(np.int64),
                     _rs(23).randint(0, 3, (5, 2, 3)).astype(np.int64)),
                    {}, ()),
}


def _csr(b, h, s, rs):
    offs, cols = [], []
    nnz = s * 2
    for _ in range(b * h):
        counts = rs.randint(1, 4, s)
        counts = (counts * nnz // counts.sum()).clip(1)
        counts[-1] += nnz - counts.sum()
        off = np.concatenate([[0], np.cumsum(counts)])
        offs.append(off)
        cols.append(rs.randint(0, s, nnz))
    return (np.array(offs, np.int64).reshape(b, h, s + 1),
            np.array(cols, np.int64).reshape(b, h, nnz))


@pytest.mark.parametrize("case", sorted(COMMON))
def test_common_matches_jax(case):
    args, kw, grad = COMMON[case]
    if case == "label_smooth_prior":
        got = TF.label_smooth(_t(args[0]), prior_dist=_t(args[1]))
        want = JF.label_smooth(_j(args[0]), prior_dist=_j(args[1]))
        _close(got, want, what=case)
        return
    _run(_fname(case), args, kw, grad=grad)


def test_embedding_padding_row_gets_no_gradient():
    w = torch.from_numpy(_f(10, 4, seed=10)).requires_grad_()
    out = TF.embedding(torch.from_numpy(IDS), w, padding_idx=0)
    assert not out[0, :2].any()
    out.sum().backward()
    assert not w.grad[0].any() and w.grad[1:].abs().sum() > 0


def test_sparse_attention_matches_jax():
    rs = _rs(24)
    b, h, s, d = 2, 2, 6, 8
    q, k, v = (rs.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    off, cols = _csr(b, h, s, rs)
    _run("sparse_attention", (q, k, v, off, cols), {})


def test_class_center_sample_matches_jax():
    label = np.array([3, 7, 3, 1, 9], np.int64)
    _run("class_center_sample", (label,),
         dict(num_classes=20, num_samples=8))
    _run("class_center_sample", (label,),
         dict(num_classes=20, num_samples=2))


def test_dropouts_by_their_properties_and_jax_in_eval():
    x = torch.ones(64, 32)
    for name, kw in (("dropout", {}), ("dropout", dict(axis=1)),
                     ("dropout2d", {}), ("dropout3d", {}),
                     ("alpha_dropout", {})):
        xin = x if name in ("dropout", "alpha_dropout") else \
            torch.ones(8, 16, 4, 4) if name == "dropout2d" \
            else torch.ones(8, 16, 2, 4, 4)
        y = getattr(TF, name)(xin, 0.25, training=True, **kw)
        assert y.shape == xin.shape and not torch.equal(y, xin)
        assert torch.equal(getattr(TF, name)(xin, 0.25, training=False),
                           xin)
    want = JF.dropout(_j(X), 0.3, training=False, mode="downscale_in_infer")
    _close(TF.dropout(_t(X), 0.3, training=False,
                      mode="downscale_in_infer"), want)


# ------------------------------------------------------------------ conv
CONV = {
    "conv1d": ((SEQ, _f(4, 3, 3, seed=30), _f(4, seed=31)),
               dict(stride=2, padding=1), (0, 1, 2)),
    "conv1d_nlc_same": ((SEQ.transpose(0, 2, 1).copy(),
                         _f(4, 3, 4, seed=30)),
                        dict(padding="SAME", data_format="NLC"), (0, 1)),
    "conv2d_asym": ((IMG, _f(6, 3, 3, 2, seed=32), _f(6, seed=33)),
                    dict(padding=[1, 0, 2, 1], dilation=[1, 2]), (0, 1, 2)),
    "conv2d_nhwc_groups": ((IMG.transpose(0, 2, 3, 1).copy(),
                            _f(6, 1, 3, 3, seed=34)),
                           dict(padding=1, groups=3, data_format="NHWC"),
                           (0, 1)),
    "conv2d_same_stride": ((IMG, _f(4, 3, 3, 3, seed=35)),
                           dict(stride=2, padding="SAME"), (0, 1)),
    "conv2d_valid": ((IMG, _f(4, 3, 2, 2, seed=36)),
                     dict(padding="VALID"), (0, 1)),
    "conv3d": ((VOL, _f(3, 2, 2, 3, 2, seed=37), _f(3, seed=38)),
               dict(padding=[1, 0, 1]), (0, 1, 2)),
    "conv3d_ndhwc": ((VOL.transpose(0, 2, 3, 4, 1).copy(),
                      _f(4, 2, 3, 3, 3, seed=39)),
                     dict(padding=1, data_format="NDHWC"), (0, 1)),
    "conv1d_transpose": ((SEQ, _f(3, 4, 3, seed=40), _f(4, seed=41)),
                         dict(stride=2, padding=1, output_padding=1),
                         (0, 1, 2)),
    "conv2d_transpose": ((IMG, _f(3, 2, 3, 3, seed=42)),
                         dict(stride=2, padding=1, output_padding=1,
                              dilation=1), (0, 1)),
    "conv2d_transpose_groups": ((IMG[:, :2].copy(), _f(2, 2, 2, 3, seed=43),
                                 _f(4, seed=44)),
                                dict(stride=[2, 1], groups=2, dilation=2,
                                     padding=[1, 0]), (0, 1, 2)),
    "conv2d_transpose_nhwc": ((IMG.transpose(0, 2, 3, 1).copy(),
                               _f(3, 4, 2, 2, seed=45)),
                              dict(stride=2, data_format="NHWC"), (0, 1)),
    "conv3d_transpose": ((VOL, _f(2, 3, 2, 2, 2, seed=46)),
                         dict(stride=2, padding=[0, 1, 0]), (0, 1)),
}


@pytest.mark.parametrize("case", sorted(CONV))
def test_conv_matches_jax(case):
    args, kw, grad = CONV[case]
    _run(_fname(case), args, kw, rtol=1e-5, atol=1e-5, grad=grad)


# --------------------------------------------------------------- pooling
POOL = {
    "avg_pool1d": ((SEQ, 3), dict(stride=2, padding=1), (0,)),
    "avg_pool1d_incl": ((SEQ, 3), dict(stride=2, padding=1,
                                       exclusive=False), (0,)),
    "avg_pool2d": ((IMG, 2), dict(stride=1, padding=1), (0,)),
    "avg_pool2d_nhwc": ((IMG.transpose(0, 2, 3, 1).copy(), [2, 3]),
                        dict(stride=[2, 1], data_format="NHWC"), (0,)),
    "avg_pool2d_same": ((IMG, 3), dict(stride=2, padding="SAME"), (0,)),
    "avg_pool3d": ((VOL, 2), dict(stride=1, padding=[1, 0, 1]), (0,)),
    "max_pool1d": ((SEQ, 2), dict(stride=2), (0,)),
    "max_pool2d": ((IMG, 3), dict(stride=2, padding=1), (0,)),
    "max_pool2d_nhwc": ((IMG.transpose(0, 2, 3, 1).copy(), 2),
                        dict(data_format="NHWC"), (0,)),
    "max_pool2d_mask": ((IMG, 2), dict(stride=2, padding=1,
                                       return_mask=True), ()),
    "max_pool3d": ((VOL, 2), dict(stride=1, padding=1), (0,)),
    "adaptive_avg_pool1d": ((SEQ, 4), {}, (0,)),
    "adaptive_avg_pool2d": ((IMG, [4, 3]), {}, (0,)),
    "adaptive_avg_pool3d": ((VOL, [3, 2, 3]), {}, (0,)),
    "adaptive_max_pool1d": ((SEQ, 4), {}, (0,)),
    "adaptive_max_pool2d": ((IMG, [3, 5]), {}, (0,)),
    "adaptive_max_pool3d": ((VOL, 2), {}, (0,)),
}


@pytest.mark.parametrize("case", sorted(POOL))
def test_pooling_matches_jax(case):
    args, kw, grad = POOL[case]
    _run(_fname(case), args, kw, grad=grad)


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_max_unpool_matches_jax(nd):
    shape = {1: (2, 3, 4), 2: (2, 3, 3, 4), 3: (1, 2, 2, 2, 3)}[nd]
    x = _f(*shape, seed=50)
    sp = shape[2:]
    flat = int(np.prod([2 * s for s in sp]))
    idx = np.stack([_rs(51 + i).choice(flat, int(np.prod(sp)),
                                       replace=False)
                    for i in range(shape[0] * shape[1])]).reshape(shape)
    _run(f"max_unpool{nd}d", (x, idx.astype(np.int64), 2), {})
    _run(f"max_unpool{nd}d", (x, idx.astype(np.int64), 2),
         dict(output_size=[2 * s for s in sp]))


# ------------------------------------------------------------------ norm
NORM = {
    "layer_norm": ((IMG, [6, 7], _f(6, 7, seed=60), _f(6, 7, seed=61)),
                   dict(epsilon=1e-4), (0, 2, 3)),
    "layer_norm_int": ((SEQ, 9), {}, (0,)),
    "rms_norm": ((SEQ, _f(9, seed=62)), dict(epsilon=1e-5), (0, 1)),
    "instance_norm": ((IMG,), {}, (0,)),
    "instance_norm_affine": ((IMG,), {}, (0,)),
    "group_norm": ((_f(2, 6, 4, 3, seed=63), 3), dict(epsilon=1e-4),
                   (0,)),
    "group_norm_nhwc": ((_f(2, 4, 3, 6, seed=64), 2),
                        dict(data_format="NHWC"), (0,)),
    "local_response_norm": ((_f(2, 7, 3, 3, seed=65), 3), {}, (0,)),
    "local_response_norm_nhwc": ((_f(2, 3, 3, 6, seed=66), 4), dict(
        alpha=1e-2, beta=0.6, k=2.0, data_format="NHWC"), (0,)),
}


@pytest.mark.parametrize("case", sorted(NORM))
def test_norm_matches_jax(case):
    args, kw, grad = NORM[case]
    if case == "instance_norm_affine":
        kw = dict(weight=_j(_f(3, seed=67)), bias=_j(_f(3, seed=68)))
        want = JF.instance_norm(_j(IMG), **kw)
        got = TF.instance_norm(_t(IMG), weight=_t(_f(3, seed=67)),
                               bias=_t(_f(3, seed=68)))
        _close(got, want, atol=1e-5)
        return
    _run(_fname(case), args, kw, atol=1e-5, grad=grad)


@pytest.mark.parametrize("fmt,training,global_stats", [
    ("NCHW", True, None), ("NHWC", True, None), ("NCHW", False, None),
    ("NHWC", True, True)])
def test_batch_norm_matches_jax(fmt, training, global_stats):
    x = IMG if fmt == "NCHW" else IMG.transpose(0, 2, 3, 1).copy()
    c = 3
    mean, var = _f(c, seed=70) * 0.1, np.abs(_f(c, seed=71)) + 0.5
    w, b = _f(c, seed=72), _f(c, seed=73)
    jm, jv = _j(mean.copy()), _j(var.copy())
    tm, tv = _t(mean), _t(var)
    kw = dict(training=training, momentum=0.8, data_format=fmt,
              use_global_stats=global_stats)
    want = JF.batch_norm(_j(x), jm, jv, _j(w), _j(b), **kw)
    got = TF.batch_norm(_t(x), tm, tv, _t(w), _t(b), **kw)
    _close(got, want, atol=1e-5)
    _close(tm, jm, atol=1e-6)
    _close(tv, jv, atol=1e-6)


# ------------------------------------------------------------------ loss
P3 = np.abs(_f(4, 5, seed=80)) / 3 + 0.05
P3 = (P3 / P3.sum(-1, keepdims=True)).astype(np.float32)
LOGITS = _f(6, 5, seed=81)
LAB = np.array([0, 4, 2, 2, 1, 3], np.int64)
BIN = (_rs(82).rand(4, 5) > 0.5).astype(np.float32)
PM1 = np.where(_rs(83).rand(4) > 0.5, 1.0, -1.0).astype(np.float32)
LOSS = {
    "mse_loss": ((P3, BIN), {}, (0,)),
    "mse_loss_sum": ((P3, BIN), dict(reduction="sum"), (0,)),
    "l1_loss": ((P3, BIN), dict(reduction="none"), (0,)),
    "smooth_l1_loss": ((LOGITS, LOGITS[::-1].copy()), dict(delta=0.7),
                       (0,)),
    "nll_loss": ((np.log(P3), LAB[:4]), {}, (0,)),
    "nll_loss_ignore": ((np.log(P3), np.array([0, 4, -100, 2], np.int64)),
                        dict(ignore_index=-100), (0,)),
    "kl_div": ((np.log(P3), P3[::-1].copy()), dict(reduction="batchmean"),
               (0,)),
    "kl_div_log_target": ((np.log(P3), np.log(P3[::-1].copy())),
                          dict(log_target=True, reduction="sum"), (0,)),
    "binary_cross_entropy": ((P3, BIN), {}, (0,)),
    "binary_cross_entropy_with_logits": ((LOGITS[:4], BIN), {}, (0,)),
    "binary_cross_entropy_with_logits_pos": ((LOGITS[:4], BIN), {}, ()),
    "sigmoid_focal_loss": ((LOGITS[:4], BIN), {}, (0,)),
    "margin_ranking_loss": ((LOGITS[:4, 0].copy(), LOGITS[:4, 1].copy(),
                             PM1), dict(margin=0.2), (0, 1)),
    "hinge_embedding_loss": ((LOGITS[:4], np.where(BIN > 0, 1.0, -1.0)
                              .astype(np.float32)), {}, (0,)),
    "cosine_embedding_loss": ((LOGITS[:4], LOGITS[2:].copy(), PM1),
                              dict(margin=0.1), (0, 1)),
    "triplet_margin_loss": ((LOGITS[:2], LOGITS[2:4].copy(),
                             LOGITS[4:].copy()), dict(swap=True), (0, 1, 2)),
    "triplet_margin_with_distance_loss": ((LOGITS[:2], LOGITS[2:4].copy(),
                                           LOGITS[4:].copy()),
                                          dict(swap=True, margin=2.0),
                                          (0, 1, 2)),
    "soft_margin_loss": ((LOGITS[:4], np.where(BIN > 0, 1.0, -1.0)
                          .astype(np.float32)), {}, (0,)),
    "multi_label_soft_margin_loss": ((LOGITS[:4], BIN), {}, (0,)),
    "multi_margin_loss": ((LOGITS, LAB), dict(p=2, margin=0.5), (0,)),
    "poisson_nll_loss": ((LOGITS[:4], np.abs(BIN * 3)), {}, (0,)),
    "poisson_nll_loss_full": ((P3, np.abs(BIN * 3)), dict(
        log_input=False, full=True), (0,)),
    "gaussian_nll_loss": ((LOGITS[:4], BIN, P3), dict(full=True), (0, 2)),
    "log_loss": ((P3, BIN), {}, (0,)),
    "square_error_cost": ((P3, BIN), {}, (0,)),
    "dice_loss": ((P3.reshape(2, 2, 5), LAB[:4].reshape(2, 2, 1)), {},
                  (0,)),
    "npair_loss": ((LOGITS[:4], LOGITS[2:].copy(),
                    np.array([0, 1, 0, 2], np.int64)), {}, (0, 1)),
    "margin_cross_entropy": ((np.tanh(LOGITS), LAB), dict(scale=8.0),
                             (0,)),
    "cross_entropy_smooth_ignore": ((LOGITS, np.array(
        [0, 4, -100, 2, 1, 3], np.int64)), dict(label_smoothing=0.1),
        (0,)),
}


@pytest.mark.parametrize("case", sorted(LOSS))
def test_loss_matches_jax(case):
    args, kw, grad = LOSS[case]
    if case == "binary_cross_entropy_with_logits_pos":
        jw = _j(np.full(5, 2.0, np.float32))
        want = JF.binary_cross_entropy_with_logits(
            _j(args[0]), _j(args[1]), pos_weight=jw, reduction="none")
        got = TF.binary_cross_entropy_with_logits(
            _t(args[0]), _t(args[1]), pos_weight=torch.full((5,), 2.0),
            reduction="none")
        _close(got, want, LOSS_TOL, LOSS_TOL, case)
        return
    _run(_fname(case), args, kw, LOSS_TOL, LOSS_TOL, grad=grad)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_weighted_losses_match_jax(reduction):
    w = np.abs(_f(5, seed=84)) + 0.1
    want = JF.nll_loss(_j(np.log(P3)), _j(np.array([0, 4, -100, 2])),
                       weight=_j(w), reduction=reduction)
    got = TF.nll_loss(_t(np.log(P3)), torch.tensor([0, 4, -100, 2]),
                      weight=_t(w), reduction=reduction)
    _close(got, want, LOSS_TOL, LOSS_TOL)
    want = JF.binary_cross_entropy(_j(P3), _j(BIN), weight=_j(w),
                                   reduction=reduction)
    got = TF.binary_cross_entropy(_t(P3), _t(BIN), weight=_t(w),
                                  reduction=reduction)
    _close(got, want, LOSS_TOL, LOSS_TOL)
    want = JF.multi_margin_loss(_j(LOGITS), _j(LAB), weight=_j(w),
                                reduction=reduction)
    got = TF.multi_margin_loss(_t(LOGITS), _t(LAB), weight=_t(w),
                               reduction=reduction)
    _close(got, want, LOSS_TOL, LOSS_TOL)


@pytest.mark.parametrize("reduction,norm", [("mean", False), ("sum", True),
                                            ("none", False)])
def test_ctc_loss_matches_jax(reduction, norm):
    rs = _rs(85)
    t, b, c, lmax = 12, 3, 6, 4
    lp = np.log(np.exp(rs.randn(t, b, c)) / np.exp(
        rs.randn(t, b, c)).sum(-1, keepdims=True)).astype(np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    labels = rs.randint(1, c, (b, lmax)).astype(np.int64)
    labels[0, 1] = labels[0, 0]        # a repeat: the skip is refused
    in_len = np.array([12, 9, 7], np.int64)
    lab_len = np.array([4, 2, 0], np.int64)
    _run("ctc_loss", (lp, labels, in_len, lab_len),
         dict(blank=0, reduction=reduction, norm_by_times=norm),
         LOSS_TOL, LOSS_TOL, grad=(0,))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_rnnt_loss_matches_jax(reduction):
    rs = _rs(86)
    b, t, u, v = 2, 5, 3, 6
    logits = rs.randn(b, t, u + 1, v).astype(np.float32)
    label = rs.randint(1, v, (b, u)).astype(np.int64)
    in_len = np.array([5, 3], np.int64)
    lab_len = np.array([3, 1], np.int64)
    _run("rnnt_loss", (logits, label, in_len, lab_len),
         dict(blank=0, fastemit_lambda=0.0, reduction=reduction),
         LOSS_TOL, LOSS_TOL, grad=(0,))


def test_hsigmoid_loss_matches_jax():
    rs = _rs(87)
    x = rs.randn(5, 4).astype(np.float32)
    label = rs.randint(0, 6, (5,)).astype(np.int64)
    w = rs.randn(5, 4).astype(np.float32)
    bias = rs.randn(5).astype(np.float32)
    _run("hsigmoid_loss", (x, label, 6, w, bias), {}, LOSS_TOL, LOSS_TOL,
         grad=(0, 3, 4))


def test_margin_cross_entropy_returns_softmax_like_jax():
    want = JF.margin_cross_entropy(_j(np.tanh(LOGITS)), _j(LAB),
                                   return_softmax=True, reduction="none")
    got = TF.margin_cross_entropy(_t(np.tanh(LOGITS)), _t(LAB),
                                  return_softmax=True, reduction="none")
    _close(got, want, LOSS_TOL, LOSS_TOL)


# ---------------------------------------------------------------- vision
VISION = {
    "interpolate_nearest": ((IMG,), dict(size=[9, 5]), (0,)),
    "interpolate_nearest_nhwc": ((IMG.transpose(0, 2, 3, 1).copy(),),
                                 dict(scale_factor=2, data_format="NHWC"),
                                 (0,)),
    "interpolate_bilinear_up": ((IMG,), dict(size=[11, 13],
                                             mode="bilinear"), (0,)),
    "interpolate_bilinear_down": ((IMG,), dict(size=[3, 4],
                                               mode="bilinear"), (0,)),
    "interpolate_bicubic": ((IMG,), dict(scale_factor=1.5, mode="bicubic",
                                         align_corners=True), (0,)),
    "interpolate_linear": ((SEQ,), dict(size=14, mode="linear",
                                        data_format="NCW"), (0,)),
    "interpolate_trilinear": ((VOL,), dict(size=[6, 3, 4],
                                           mode="trilinear",
                                           data_format="NCDHW"), (0,)),
    "interpolate_area": ((IMG,), dict(size=[3, 3], mode="area"), (0,)),
    "upsample": ((IMG,), dict(scale_factor=2, mode="nearest"), (0,)),
    "pixel_shuffle": ((_f(2, 8, 3, 3, seed=90), 2), {}, (0,)),
    "pixel_shuffle_nhwc": ((_f(2, 3, 3, 8, seed=91), 2),
                           dict(data_format="NHWC"), (0,)),
    "pixel_unshuffle": ((_f(2, 2, 4, 6, seed=92), 2), {}, (0,)),
    "pixel_unshuffle_nhwc": ((_f(2, 4, 6, 2, seed=93), 2),
                             dict(data_format="NHWC"), (0,)),
    "channel_shuffle": ((_f(2, 6, 2, 3, seed=94), 3), {}, (0,)),
    "channel_shuffle_nhwc": ((_f(2, 2, 3, 6, seed=95), 2),
                             dict(data_format="NHWC"), (0,)),
    "affine_grid": ((_f(2, 2, 3, seed=96), [2, 3, 4, 5]), {}, (0,)),
    "affine_grid_half": ((_f(2, 2, 3, seed=96), [2, 3, 4, 5]),
                         dict(align_corners=False), (0,)),
    "grid_sample": ((IMG, np.tanh(_f(2, 4, 5, 2, seed=97)) * 1.2), {},
                    (0, 1)),
    "grid_sample_nearest": ((IMG, np.tanh(_f(2, 4, 5, 2, seed=98)) * 1.2),
                            dict(mode="nearest", align_corners=False),
                            (0,)),
}


@pytest.mark.parametrize("case", sorted(VISION))
def test_vision_matches_jax(case):
    args, kw, grad = VISION[case]
    _run(_fname(case), args, kw, atol=1e-5, grad=grad)


# ------------------------------------------------------------- attention
def test_flash_attention_is_unmasked_sdpa_like_jax():
    rs = _rs(100)
    q, k, v = (rs.randn(2, 8, 2, 16).astype(np.float32) for _ in range(3))
    for causal in (False, True):
        want, _ = JF.flash_attention(_j(q), _j(k), _j(v), causal=causal)
        got, none = TF.flash_attention(_t(q), _t(k), _t(v), causal=causal)
        assert none is None
        _close(got, want, atol=1e-5)


def test_sdp_kernel_policy_as_in_jax():
    rs = _rs(101)
    q = rs.randn(1, 4, 2, 8).astype(np.float32)
    # the default context disables math: the CPU has no flash kernel
    with JF.sdp_kernel():
        with pytest.raises(RuntimeError, match="math backend disabled"):
            JF.scaled_dot_product_attention(_j(q), _j(q), _j(q))
    with TF.sdp_kernel():
        with pytest.raises(RuntimeError, match="math backend disabled"):
            TF.scaled_dot_product_attention(_t(q), _t(q), _t(q))
    with TF.sdp_kernel(enable_math=False, enable_flash=False,
                       enable_mem_efficient=False):
        with pytest.raises(RuntimeError, match="also disabled"):
            TF.scaled_dot_product_attention(_t(q), _t(q), _t(q))
    with JF.sdp_kernel(enable_math=True, enable_flash=False,
                       enable_mem_efficient=False), \
            TF.sdp_kernel(enable_math=True, enable_flash=False,
                          enable_mem_efficient=False):
        want = JF.scaled_dot_product_attention(_j(q), _j(q), _j(q))
        got = TF.scaled_dot_product_attention(_t(q), _t(q), _t(q))
    _close(got, want, atol=1e-5)
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def test_every_jax_function_resolves_in_the_port():
    missing = [n for n in dir(JF) if not n.startswith("_")
               and callable(getattr(JF, n))
               and not inspect.ismodule(getattr(JF, n))
               and not hasattr(TF, n)]
    assert missing == []
