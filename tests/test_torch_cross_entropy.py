"""`cross_entropy` / `CrossEntropyLoss` / `softmax_with_cross_entropy`
of the port (``paddle_tpu_torch/nn/functional/loss.py``) against the JAX
package's (``paddle_tpu/nn/functional/loss.py:28``, :73), on the CPU in
float32: every option and their combinations (class weight x reduction
x hard / column / soft labels, recognised by shape or flagged x label
smoothing x axis x ``use_softmax`` x ``ignore_index``), the value and
the gradient with respect to the input, within rtol 1e-6 (atol 1e-7
for entries near zero).
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores
torch.set_num_threads(1)

C = 5
LABELS = ("hard", "column", "soft", "soft_flag")
CASES = list(itertools.product(
    (False, True),                  # class weight
    ("mean", "sum", "none"),        # reduction
    LABELS,
    (0.0, 0.1),                     # label smoothing
    (-1, 1),                        # axis (1: a [N, C, L] input)
    (True, False),                  # use_softmax
    (-100, 2),                      # ignore_index
))
# ignore_index reads hard labels only
CASES = [c for c in CASES if c[2] in ("hard", "column") or c[6] == -100]


def _inputs(weighted, labels, axis, use_softmax, ignore_index, seed):
    rs = np.random.RandomState(seed)
    shape = (6, C) if axis == -1 else (3, C, C)
    x = (rs.randn(*shape) * 2).astype(np.float32)
    if not use_softmax:
        # probabilities along the axis
        e = np.exp(x - x.max(axis=axis, keepdims=True))
        x = (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)
    lab_shape = list(shape)
    del lab_shape[axis]
    if labels in ("soft", "soft_flag"):
        s = rs.rand(*shape).astype(np.float32)
        label = (s / s.sum(axis=axis, keepdims=True)).astype(np.float32)
    else:
        label = rs.randint(0, C, lab_shape).astype(np.int32)
        label.reshape(-1)[[0, 3]] = ignore_index \
            if ignore_index == -100 else 2
        if labels == "column":
            label = np.expand_dims(label, axis)
    weight = (rs.rand(C) + 0.5).astype(np.float32) if weighted else None
    return x, label, weight


def _jax(x, label, weight, kw, g):
    jx = P.to_tensor(x, stop_gradient=False)
    jlab = P.to_tensor(label, "int32" if label.dtype == np.int32
                       else "float32")
    loss = JF.cross_entropy(jx, jlab, weight=None if weight is None
                            else P.to_tensor(weight), **kw)
    (loss * P.to_tensor(g)).sum().backward()
    return np.asarray(loss.numpy()), np.asarray(jx.grad.numpy())


def _port(x, label, weight, kw, g):
    tx = torch.from_numpy(x).requires_grad_()
    loss = TF.cross_entropy(tx, torch.from_numpy(label), weight=None
                            if weight is None else torch.from_numpy(weight),
                            **kw)
    (loss * torch.from_numpy(g)).sum().backward()
    return loss.detach().numpy(), tx.grad.numpy()


@pytest.mark.parametrize(
    "weighted,reduction,labels,smoothing,axis,use_softmax,ignore_index",
    CASES)
def test_cross_entropy_matches_jax(weighted, reduction, labels, smoothing,
                                   axis, use_softmax, ignore_index):
    seed = CASES.index((weighted, reduction, labels, smoothing, axis,
                        use_softmax, ignore_index))
    x, label, weight = _inputs(weighted, labels, axis, use_softmax,
                               ignore_index, seed)
    kw = dict(reduction=reduction, soft_label=labels == "soft_flag",
              axis=axis, use_softmax=use_softmax, label_smoothing=smoothing,
              ignore_index=ignore_index)
    g_shape = () if reduction != "none" else \
        tuple(s for i, s in enumerate(x.shape) if i != axis % x.ndim)
    g = np.asarray(np.random.RandomState(seed + 1000).randn(*g_shape),
                   np.float32)
    jl, jg = _jax(x, label, weight, kw, g)
    tl, tg = _port(x, label, weight, kw, g)
    assert tl.shape == jl.shape
    np.testing.assert_allclose(tl, jl, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kw", [
    dict(), dict(reduction="sum", label_smoothing=0.2),
    dict(soft_label=True, reduction="none"), dict(axis=1),
    dict(use_softmax=False, ignore_index=1), dict(weight="w"),
])
def test_cross_entropy_loss_layer_matches_jax_layer(kw):
    rs = np.random.RandomState(len(kw))
    shape = (3, C, C) if kw.get("axis") == 1 else (6, C)
    axis = kw.get("axis", -1)
    x = rs.rand(*shape).astype(np.float32) + 0.1
    if kw.get("soft_label"):
        s = rs.rand(*shape).astype(np.float32)
        label = s / s.sum(axis=axis, keepdims=True)
        jlab = P.to_tensor(label)
    else:
        lab_shape = list(shape)
        del lab_shape[axis]
        label = rs.randint(0, C, lab_shape).astype(np.int32)
        jlab = P.to_tensor(label, "int32")
    tkw, jkw = dict(kw), dict(kw)
    if kw.get("weight") == "w":
        w = (rs.rand(C) + 0.5).astype(np.float32)
        tkw["weight"], jkw["weight"] = torch.from_numpy(w), P.to_tensor(w)
    want = P.nn.CrossEntropyLoss(**jkw)(P.to_tensor(x), jlab).numpy()
    got = tnn.CrossEntropyLoss(**tkw)(torch.from_numpy(x),
                                      torch.from_numpy(label))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("soft", [False, True])
def test_softmax_with_cross_entropy_matches_jax(soft):
    rs = np.random.RandomState(8)
    x = rs.randn(4, C).astype(np.float32)
    if soft:
        s = rs.rand(4, C).astype(np.float32)
        label = s / s.sum(-1, keepdims=True)
        jlab = P.to_tensor(label)
    else:
        label = rs.randint(0, C, (4, 1)).astype(np.int32)
        jlab = P.to_tensor(label, "int32")
    jl, js = JF.softmax_with_cross_entropy(P.to_tensor(x), jlab,
                                           soft_label=soft,
                                           return_softmax=True)
    tl, ts = TF.softmax_with_cross_entropy(torch.from_numpy(x),
                                           torch.from_numpy(label),
                                           soft_label=soft,
                                           return_softmax=True)
    assert tuple(tl.shape) == tuple(jl.shape) == (4, 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl.numpy()),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js.numpy()),
                               rtol=1e-6, atol=1e-7)
