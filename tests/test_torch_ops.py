"""Paddle's top-level op surface on the port against the JAX package, on
the CPU: one parametrised case per public op of the JAX op table
(``PUBLIC_OPS["paddle_tpu"]``), more for ops with options, and one for
each in-place twin (``tools_torch/op_cases.py`` holds the seeded
cases; ``chip_smoke.py``'s `ops_card` runs the same cases on the card).

* ``value`` cases: the port's outputs equal JAX's in shape and within
  the case's tolerance (rtol = atol = 1e-5 unless the case states 1e-4:
  the special functions and the solvers);
* dtypes equal, but for the pinned pairs of `DTYPE_PAIRS` (ROADMAP
  C2.40: the JAX package demotes int64 to int32, the port keeps it);
* ``decomp`` cases (`qr`, `svd`, `eig`, `eigh`, `eigvals`,
  `pca_lowrank`): the invariants (reconstruction, orthogonality, the
  singular values or eigenvalues against JAX's) within 1e-4;
* ``random`` cases: JAX's shape, the port's draw inside the support,
  and a draw that repeats after `seed(n)`; then the case's law
  (`op_cases.LAWS`): the case's parameters repeated 20,000 times (or
  its call made 2,000 times), the
  sample mean and variance of every element (or each outcome's
  frequency) within 5 standard errors of the law's, for the port's
  draw and for the JAX package's (which holds the law itself);
* in-place twins: the port writes into the argument and returns it,
  with the value JAX's twin gives;
* ``GRAD_CHECKED`` ops: the gradients of sum(out * g) with respect to
  the float inputs within 1e-4 of the JAX package's tape.
"""
from __future__ import annotations

import os
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.ops._op_table import GRAD_CHECKED, INPLACE_OPS, PUBLIC_OPS

import paddle_tpu_torch as PT
from paddle_tpu_torch.core import device as D

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from tools_torch import op_cases  # noqa: E402

torch.set_num_threads(1)

CASES = {c.name: c for c in op_cases.cases(PUBLIC_OPS["paddle_tpu"],
                                           INPLACE_OPS)}
# (JAX dtype, port dtype) pairs allowed to differ: x64 is off in the JAX
# package, so its int64 requests give int32 (ROADMAP C2.40)
DTYPE_PAIRS = {("int32", "int64")}


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = D._default
    D.set_device("cpu")
    yield
    D._default = prev


def _seed(name):
    return zlib.crc32(name.encode()) % 2**31


def to_jax(a, grad=False):
    if isinstance(a, np.ndarray):
        if a.dtype == np.int64:
            a = a.astype(np.int32)
        return Tensor(jnp.asarray(a), stop_gradient=not (
            grad and a.dtype.kind == "f"))
    if isinstance(a, list):
        return [to_jax(v, grad) for v in a]
    if isinstance(a, tuple):
        return tuple(to_jax(v, grad) for v in a)
    return a


def to_port(a, grad=False):
    if isinstance(a, np.ndarray):
        t = torch.from_numpy(np.array(a))
        return t.requires_grad_() if grad and t.is_floating_point() else t
    if isinstance(a, list):
        return [to_port(v, grad) for v in a]
    if isinstance(a, tuple):
        return tuple(to_port(v, grad) for v in a)
    return a


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in _leaves(e)]
    return [x]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(getattr(x, "_value", x))


def _dtype(x):
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(getattr(x, "_value", x)).dtype)


def _compare(got, want, tol, what):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), (what, len(g), len(w))
    for a, b in zip(g, w):
        if isinstance(b, (bool, int, float, str)) or b is None:
            assert a == b, (what, a, b)
            continue
        assert (_dtype(b), _dtype(a)) in DTYPE_PAIRS \
            or _dtype(b).replace("bool_", "bool") == _dtype(a), \
            (what, _dtype(b), _dtype(a))
        an, bn = _np(a), _np(b)
        assert an.shape == bn.shape, (what, an.shape, bn.shape)
        if bn.dtype.kind in "biu":
            np.testing.assert_array_equal(an, bn, err_msg=what)
        else:
            np.testing.assert_allclose(an, bn, rtol=tol, atol=tol,
                                       err_msg=what, equal_nan=True)


def _call(mod, case, args, kw):
    return getattr(mod, case.op)(*args, **kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    case = CASES[name]
    args, kw = case.make(np.random.RandomState(_seed(name)))
    jargs, targs = to_jax(args), to_port(args)
    P.seed(0)
    PT.seed(0)
    want = _call(P, case, jargs, kw)
    got = _call(PT, case, targs, kw)
    if case.written is not None:
        assert got is targs[case.written], f"{name}: not written in place"
    if case.kind == "value":
        _compare(got, want, case.tol, name)
    elif case.kind == "decomp":
        assert [_np(a).shape for a in _leaves(got)] == \
            [_np(b).shape for b in _leaves(want)]
        err = case.check([_np(a) for a in _leaves(got)] if isinstance(
            got, (tuple, list)) else _np(got), args,
            [_np(b) for b in _leaves(want)] if isinstance(
                want, (tuple, list)) else _np(want))
        assert err <= case.tol, (name, err)
    else:
        assert [_np(a).shape for a in _leaves(got)] == \
            [_np(b).shape for b in _leaves(want)], name
        for a, b in zip(_leaves(got), _leaves(want)):
            assert (_dtype(b), _dtype(a)) in DTYPE_PAIRS \
                or _dtype(b) == _dtype(a), (name, _dtype(b), _dtype(a))
        outs = [_np(a) for a in _leaves(got)]
        assert case.check(outs if len(outs) > 1 else outs[0], args,
                          None) == 0, name
        PT.seed(0)
        again = _call(PT, case, to_port(args), kw)
        for a, b in zip(_leaves(again), _leaves(got)):
            np.testing.assert_array_equal(_np(a), _np(b))


RANDOM_CASES = sorted(n for n, c in CASES.items() if c.kind == "random")


@pytest.mark.parametrize("name", RANDOM_CASES)
def test_random_op_follows_its_law(name):
    case = CASES[name]
    args, kw = case.make(np.random.RandomState(_seed(name)))
    P.seed(1)
    PT.seed(1)
    for mod, conv in ((PT, to_port), (P, to_jax)):
        z = op_cases.moment_z(case, args, kw, lambda a, k: [
            _np(o) for o in _leaves(_call(mod, case, conv(a), k))])
        assert z <= op_cases.Z_LIMIT, (name, mod.__name__, z)


def test_every_random_case_has_a_law():
    assert set(RANDOM_CASES) == set(op_cases.LAWS)


GRAD_CASES = sorted(n for n in CASES if n in GRAD_CHECKED)


@pytest.mark.parametrize("name", GRAD_CASES)
def test_grad_checked_op_gradients_match_jax(name):
    """The JAX op table's GRAD_CHECKED ops: d sum(out * g) / d inputs
    from the port's autograd against the JAX package's tape."""
    case = CASES[name]
    args, kw = case.make(np.random.RandomState(_seed(name)))
    jargs, targs = to_jax(args, grad=True), to_port(args, grad=True)
    jout = _call(P, case, jargs, kw)
    g = np.random.RandomState(1).randn(*_np(jout).shape).astype(np.float32)
    (jout * Tensor(jnp.asarray(g))).sum().backward()
    tout = _call(PT, case, targs, kw)
    (tout * torch.from_numpy(g)).sum().backward()
    checked = 0
    for j, t in zip(jargs, targs):
        if isinstance(t, torch.Tensor) and t.requires_grad:
            np.testing.assert_allclose(_np(t.grad), _np(j.grad), rtol=1e-4,
                                       atol=1e-4, err_msg=name)
            checked += 1
    assert checked


def test_every_public_op_has_a_case():
    """Each name of PUBLIC_OPS["paddle_tpu"] and each in-place twin the
    top level resolves is held by a case above."""
    ops = {c.op for c in CASES.values()}
    assert set(PUBLIC_OPS["paddle_tpu"]) <= ops, \
        sorted(set(PUBLIC_OPS["paddle_tpu"]) - ops)
    twins = {n + "_" for n in INPLACE_OPS if hasattr(PT, n + "_")}
    assert twins <= ops, sorted(twins - ops)
    assert set(GRAD_CHECKED) <= set(GRAD_CASES)


@pytest.mark.parametrize("op,args", [
    ("arange", (5,)), ("argmax", (np.arange(6.0),)),
    ("nonzero", (np.array([0.0, 1.0, 2.0]),)),
    ("shape", (np.zeros((2, 3), np.float32),)),
    ("numel", (np.zeros((2, 3), np.float32),)),
    ("bincount", (np.array([0, 2, 2]),)),
])
def test_index_outputs_are_int64_where_jax_gives_int32(op, args):
    """ROADMAP C2.40: Paddle's 64-bit index dtype is kept by the port;
    the JAX package (x64 off) demotes it to int32."""
    want = getattr(P, op)(*to_jax(args))
    got = getattr(PT, op)(*to_port(args))
    assert got.dtype == torch.int64 and _dtype(want) == "int32"
    np.testing.assert_array_equal(_np(got), _np(want))
    assert PT.to_tensor([1, 2]).dtype == torch.int64
    assert P.to_tensor([1, 2]).dtype == jnp.int32


def test_in_place_on_a_leaf_that_requires_grad_raises():
    """ROADMAP C2.45: the JAX package's in-place form rebinds the handle,
    so a leaf that requires grad takes it; torch refuses an in-place
    write into such a leaf.  On a tensor without grad, or a non-leaf,
    the port writes in place and returns its argument."""
    jx = Tensor(jnp.ones(3), stop_gradient=False)
    assert P.exp_(jx) is jx
    tx = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="leaf"):
        PT.exp_(tx)
    y = tx * 1.0
    assert PT.exp_(y) is y
    y.sum().backward()
    torch.testing.assert_close(tx.grad, torch.full((3,), np.e))
    z = torch.zeros(2, 3)
    assert PT.reshape_(z, [3, 2]) is z and z.shape == (3, 2)


def test_scatter_drops_out_of_range_and_keeps_the_last_duplicate():
    """JAX's ``mode="drop"``: index 7 of a 5-row tensor is dropped, -1 is
    the last row, and of two writes to row 1 the later one stays, as in
    the JAX package on the CPU (torch's index_put raises on 7)."""
    x = np.zeros((5, 2), np.float32)
    idx = np.array([1, 7, 1, -1])
    upd = np.arange(8, dtype=np.float32).reshape(4, 2)
    got = PT.scatter(torch.from_numpy(x), torch.from_numpy(idx),
                     torch.from_numpy(upd))
    want = P.scatter(to_jax(x), to_jax(idx), to_jax(upd))
    np.testing.assert_array_equal(_np(got), _np(want))
    assert got[1].tolist() == [4.0, 5.0] and got[4].tolist() == [6.0, 7.0]


def test_topk_and_argsort_order_ties_as_jax():
    x = np.array([[1.0, 3.0, 3.0, 0.0, 3.0]], np.float32)
    for op, kw in (("topk", dict(k=3)), ("argsort", {}),
                   ("argsort", dict(descending=True))):
        got = getattr(PT, op)(torch.from_numpy(x), **kw)
        want = getattr(P, op)(to_jax(x), **kw)
        for a, b in zip(_leaves(got), _leaves(want)):
            np.testing.assert_array_equal(_np(a), _np(b))
