"""The port's top-level surface against the JAX package's names, and the
top-level helpers, on the CPU.

* every name of the JAX op table's ``PUBLIC_OPS["paddle_tpu"]``,
  ``["paddle_tpu.linalg"]`` and ``["paddle_tpu.nn.quant"]`` resolves on
  the port, and each in-place twin of ``INPLACE_OPS`` at the top level
  or on `nn.functional`; every public top-level name of the JAX package
  resolves too, but the ones listed in `WAITING` with their ROADMAP
  queue;
* `import paddle_tpu_torch` stays light (the DataLoader's workers import
  it): the ops load at first use;
* the creation ops default to the card (C2.35): on a host without CUDA
  they raise, naming ``device="cpu"``, unless ``set_device("cpu")`` or
  ``place=`` says otherwise;
* `torch.Tensor` is not patched (C2.41): the op table's Tensor methods
  that torch lacks are listed in `TENSOR_ONLY_FUNCTIONS` and each is a
  top-level function of the port;
* `grad`, `no_grad`, `seed` and the random state, the flags, the
  dtype names with `iinfo` / `finfo`, the places, `version` and the
  helpers of the JAX ``__init__`` against the JAX package's.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.ops._op_table import (
    INPLACE_OPS, PUBLIC_OPS, TENSOR_METHODS,
)

import paddle_tpu_torch as PT
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.core import device as D

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX top-level names the port does not have yet, by ROADMAP queue
WAITING = {
    "DataParallel": "A7",
    "autograd": "A9", "cost_model": "A9", "device": "A9", "signal": "A9",
    "distribution": "A9", "sparse": "A9", "fft": "A9", "geometric": "A9",
    "text": "A9", "audio": "A9", "quantization": "A9", "onnx": "A9",
    "profiler": "A9", "utils": "A9", "sysconfig": "A9", "hub": "A9",
    "dataset": "A9", "reader": "A9",
}
# the subpackages the JAX package imports at its import or at first use
# (`paddle_tpu/__init__.py:38-62`), and its internal modules
JAX_MODULES = {
    "amp", "autograd", "device", "framework", "io", "jit", "metric", "nn",
    "optimizer", "vision", "distributed", "hapi", "incubate", "models",
    "profiler", "distribution", "sparse", "text", "audio", "quantization",
    "geometric", "fft", "signal", "linalg", "regularizer", "static",
    "inference", "onnx", "utils", "sysconfig", "hub", "cost_model",
    "dataset", "reader", "observability", "resilience",
}
# the JAX package's internal modules, and `extra` (its `ops.extra`,
# which its `from .ops import *` leaks to the top level)
INTERNAL = {"core", "ops", "analysis", "backend_guard", "native", "extra"}
# the op table's Tensor methods that torch.Tensor lacks: the port's
# functions of these names take their place (C2.41)
TENSOR_ONLY_FUNCTIONS = {
    "add_n", "as_complex", "as_real", "assign", "atleast_1d", "atleast_2d",
    "atleast_3d", "auc", "binomial", "broadcast_shape",
    "broadcast_tensors", "bucketize", "cast", "cast_", "cdist",
    "clip_by_norm", "combinations", "complex", "concat", "cond",
    "create_tensor", "crop", "cumulative_trapezoid", "dirichlet",
    "edit_distance", "eigh", "eigvals", "eigvalsh", "einsum", "empty_like",
    "equal_", "equal_all", "fill", "fill_diagonal", "fill_diagonal_tensor",
    "flatten_", "floor_mod", "floor_mod_", "full_like", "gammaln",
    "gammaln_", "gather_nd", "gather_tree", "gaussian", "greater_than",
    "greater_than_", "histogramdd", "householder_product", "i0e", "i1",
    "i1e", "identity_loss", "increment", "index_sample", "is_empty",
    "is_integer", "is_tensor", "less_than", "less_than_", "lu_unpack",
    "matrix_rank", "mod", "mod_", "multi_dot", "multigammaln",
    "multigammaln_", "multiplex", "one_hot", "ones_like", "pad",
    "pca_lowrank", "pinv", "poisson", "polar", "put_along_axis",
    "put_along_axis_", "rank", "reshape_", "reverse", "scale", "scale_",
    "scatter_nd", "scatter_nd_add", "searchsorted", "shard_index", "slice",
    "split_with_num", "stack", "standard_gamma", "stanh", "strided_slice",
    "take_along_axis", "temporal_shift", "tensordot", "top_p_sampling",
    "trapezoid", "tril_indices", "triu_indices", "unstack", "vander",
    "viterbi_decode", "where_", "zeros_like",
}


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = D._default
    D.set_device("cpu")
    yield
    D._default = prev


def test_op_table_names_resolve():
    missing = [n for n in PUBLIC_OPS["paddle_tpu"]
               if getattr(PT, n, None) is None]
    assert not missing, missing
    for where, mod in (("paddle_tpu.linalg", PT.linalg),
                       ("paddle_tpu.nn.quant", PT.nn.quant)):
        assert not [n for n in PUBLIC_OPS[where]
                    if getattr(mod, n, None) is None], where
    twins = [n + "_" for n in INPLACE_OPS
             if getattr(PT, n + "_", None) is None
             and getattr(TF, n + "_", None) is None]
    assert not twins, twins


def test_every_jax_top_level_name_resolves_but_the_waiting_ones():
    names = {n for n in dir(P) if not n.startswith("_")} | JAX_MODULES
    missing = {n for n in names - INTERNAL
               if getattr(PT, n, None) is None}
    assert missing == set(WAITING), sorted(missing ^ set(WAITING))
    for n in names - INTERNAL - set(WAITING):
        if isinstance(getattr(P, n, None), types.ModuleType) \
                or n in JAX_MODULES:
            assert isinstance(getattr(PT, n), types.ModuleType), n


def test_top_level_resolves_the_surface_and_nothing_else():
    """Module-level helpers of the op and surface modules (`torch`,
    `write`, `gated`, ...) are not top-level names."""
    for name in ("torch", "np", "write", "gated", "pair", "builtins",
                 "resolve_device", "math", "creation"):
        with pytest.raises(AttributeError):
            getattr(PT, name)
    assert PT.shape(torch.zeros(2, 3)).tolist() == [2, 3]


def test_linalg_namespace_is_the_ops():
    jax_names = [n for n in dir(P.linalg) if not n.startswith("_")
                 and callable(getattr(P.linalg, n))]
    assert sorted(PT.linalg.__all__) == sorted(P.linalg.__all__)
    assert {n for n in jax_names if n in P.linalg.__all__} <= set(
        PT.linalg.__all__)
    assert PT.linalg.inv is PT.inverse and PT.linalg.cond is PT.cond_number
    a = np.array([[2.0, 1.0], [1.0, 3.0]], np.float32)
    np.testing.assert_allclose(
        PT.linalg.inv(torch.from_numpy(a)).numpy(),
        np.asarray(P.linalg.inv(Tensor(jnp.asarray(a)))._value), rtol=1e-6)


def test_package_import_stays_light():
    code = textwrap.dedent("""
        import sys
        import paddle_tpu_torch as PT
        assert "paddle_tpu_torch.ops" not in sys.modules
        assert "torch" not in sys.modules
        PT.concat
        assert "paddle_tpu_torch.ops.manipulation" in sys.modules
        assert "paddle_tpu_torch.nn" not in sys.modules
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("make", [
    lambda **kw: PT.zeros([2, 3], **kw), lambda **kw: PT.ones([2], **kw),
    lambda **kw: PT.full([2], 1.0, **kw), lambda **kw: PT.arange(4, **kw),
    lambda **kw: PT.linspace(0, 1, 3, **kw), lambda **kw: PT.eye(2, **kw),
    lambda **kw: PT.rand([2], **kw), lambda **kw: PT.randn([2], **kw),
    lambda **kw: PT.randint(0, 3, [2], **kw),
    lambda **kw: PT.randperm(3, **kw), lambda **kw: PT.uniform([2], **kw),
    lambda **kw: PT.to_tensor([1.0, 2.0], **kw),
    lambda **kw: PT.gaussian([2], **kw),
])
def test_creation_ops_default_to_the_card(make):
    """ROADMAP C2.35 for the creation ops: with no place they make their
    tensor on `resolve_device(None)`, the card unless `set_device` said
    otherwise; `place` names another."""
    D._default = None
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
        assert make(place="cpu").device.type == "cpu"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make()
    assert make(place="cpu").device.type == "cpu"
    assert make(place=PT.CPUPlace()).device.type == "cpu"
    D.set_device("cpu")
    assert make().device.type == "cpu"


def test_to_tensor_copies_and_as_tensor_keeps():
    """`to_tensor` makes a new tensor (a numpy array or a tensor given
    to it is not aliased, as in Paddle); `as_tensor` returns a tensor of
    the asked dtype as it is."""
    a = np.zeros(3, np.float32)
    t = PT.to_tensor(a)
    a[0] = 1.0
    assert t[0].item() == 0.0
    u = PT.to_tensor(t)
    u[1] = 2.0
    assert t[1].item() == 0.0
    assert PT.as_tensor(t) is t and PT.as_tensor(t, "float64") is not t
    assert PT.to_tensor(np.zeros(2)).dtype == torch.float32
    assert PT.to_tensor(1.5, stop_gradient=False).requires_grad


def test_torch_tensor_is_not_patched():
    """ROADMAP C2.41: the op table's Tensor methods are torch's own on a
    port tensor.  Those torch lacks are the pinned list, and each is a
    function of the port's top level."""
    lacking = {m for m in TENSOR_METHODS if not hasattr(torch.Tensor, m)}
    assert lacking == TENSOR_ONLY_FUNCTIONS, sorted(
        lacking ^ TENSOR_ONLY_FUNCTIONS)
    for m in lacking - {"cond"}:
        assert callable(getattr(PT, m)), m
    assert callable(PT.linalg.cond)


def test_grad_matches_jax():
    x = np.array([0.5, -1.0, 2.0], np.float32)
    jx = Tensor(jnp.asarray(x), stop_gradient=False)
    jy = (jx * jx * jx).sum()
    (jg,) = P.grad(jy, jx)
    tx = torch.from_numpy(x).requires_grad_()
    (tg,) = PT.grad((tx * tx * tx).sum(), tx)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg._value), rtol=1e-6)
    assert tx.grad is None
    # non-scalar output: grad_outputs default to ones, as in JAX
    (tg2,) = PT.grad(tx * 2, [tx])
    torch.testing.assert_close(tg2, torch.full((3,), 2.0))
    ty = torch.zeros(1, requires_grad=True)
    assert PT.grad((tx * 2).sum(), [tx, ty], allow_unused=True)[1] is None
    with pytest.raises(RuntimeError):
        PT.grad((tx * 2).sum(), [ty])


def test_no_grad_and_grad_switches():
    x = torch.ones(2, requires_grad=True)
    with PT.no_grad():
        assert not (x * 2).requires_grad
    with PT.no_grad:
        assert not PT.is_grad_enabled()

    @PT.no_grad()
    def f(v):
        return v * 2

    assert not f(x).requires_grad
    with PT.no_grad():
        with PT.enable_grad():
            assert (x * 2).requires_grad
    PT.set_grad_enabled(False)
    try:
        assert not PT.is_grad_enabled()
    finally:
        PT.set_grad_enabled(True)
    assert PT.is_grad_enabled()


def test_seed_repeats_a_run_and_rng_state_round_trips():
    PT.seed(11)
    a = (PT.rand([4]), PT.randn([3]), PT.randint(0, 9, [5]),
         PT.randperm(6), PT.bernoulli(torch.full((6,), 0.5)))
    PT.seed(11)
    b = (PT.rand([4]), PT.randn([3]), PT.randint(0, 9, [5]),
         PT.randperm(6), PT.bernoulli(torch.full((6,), 0.5)))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    state = PT.get_rng_state()
    c = PT.rand([3])
    PT.set_rng_state(state)
    assert torch.equal(PT.rand([3]), c)
    assert isinstance(PT.get_cuda_rng_state(), list)


def test_flags_dtypes_and_info():
    assert PT.get_flags("FLAGS_check_nan_inf") == {
        "FLAGS_check_nan_inf": False}
    PT.set_flags({"FLAGS_check_nan_inf": False})
    prev = os.environ.get("FLAGS_flash_layout")
    try:
        PT.set_flags({"FLAGS_flash_layout": "kv"})
        assert os.environ["FLAGS_flash_layout"] == "kv"
        assert PT.get_flags(["FLAGS_flash_layout"]) == {
            "FLAGS_flash_layout": "kv"}
    finally:
        if prev is None:
            os.environ.pop("FLAGS_flash_layout", None)
        else:
            os.environ["FLAGS_flash_layout"] = prev
    for n in ("bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
              "bfloat16", "float32", "float64", "complex64", "complex128"):
        assert getattr(PT, n) == getattr(torch, n.rstrip("_")), n
    assert PT.bool is torch.bool and PT.dtype is torch.dtype
    assert PT.get_default_dtype() == torch.float32
    PT.set_default_dtype("float64")
    try:
        assert PT.to_tensor([1.5]).dtype == torch.float64
        assert PT.zeros([1]).dtype == torch.float64
    finally:
        PT.set_default_dtype("float32")
    with pytest.raises(TypeError):
        PT.set_default_dtype("int32")
    for dt in ("int8", "int32", "int64", "uint8"):
        assert (PT.iinfo(dt).min, PT.iinfo(dt).max, PT.iinfo(dt).bits) == \
            (P.iinfo(dt).min, P.iinfo(dt).max, P.iinfo(dt).bits)
    for dt in ("float16", "bfloat16", "float32", "float64"):
        j, t = P.finfo(dt), PT.finfo(dt)
        assert (float(j.eps), float(j.max), float(j.tiny), j.bits) == \
            (t.eps, t.max, t.tiny, t.bits), dt



@pytest.mark.parametrize("flags,error", [
    ({"FLAGS_check_nan_inf": True}, NotImplementedError),
    ({"FLAGS_check_nan_inf": 1}, NotImplementedError),
    ({"FLAGS_disable_pallas": True}, ValueError),
    ({"FLAGS_flash_layout": "kv", "FLAGS_no_such_flag": 1}, ValueError),
])
def test_set_flags_refuses_the_flags_the_port_does_not_honour(flags, error):
    """ROADMAP C2.47: the nan/inf watcher (FLAGS_check_nan_inf) is not
    ported, and nothing reads any other flag but FLAGS_flash_layout, so
    set_flags raises for them and writes nothing of the call."""
    prev = os.environ.get("FLAGS_flash_layout")
    with pytest.raises(error):
        PT.set_flags(flags)
    assert os.environ.get("FLAGS_flash_layout") == prev
    assert PT.get_flags("FLAGS_check_nan_inf") == {
        "FLAGS_check_nan_inf": False}

def test_places_version_and_build_queries():
    assert repr(PT.CPUPlace()) == "Place(cpu)"
    assert PT.CUDAPlace(1).torch_device() == torch.device("cuda", 1)
    assert isinstance(PT.TPUPlace(), PT.CUDAPlace)
    assert isinstance(PT.CUDAPinnedPlace(), PT.CPUPlace)
    assert PT.version.full_version == P.version.full_version
    assert PT.is_compiled_with_cuda() == (torch.version.cuda is not None)
    assert not PT.is_compiled_with_tpu() and not PT.is_compiled_with_xpu()
    assert PT.device_count() == torch.cuda.device_count()
    PT.synchronize()
    assert PT.Tensor is torch.Tensor
    assert issubclass(PT.Parameter, torch.nn.Parameter)
    assert PT.ParamAttr is PT.nn.ParamAttr
    with PT.LazyGuard():
        pass
    PT.disable_signal_handler()


@pytest.mark.parametrize("name,args", [
    ("pdist", (np.random.RandomState(0).randn(4, 3).astype(np.float32),)),
    ("column_stack", ([np.arange(3.0, dtype=np.float32),
                       np.ones((3, 2), np.float32)],)),
    ("row_stack", ([np.arange(3.0, dtype=np.float32),
                    np.ones((2, 3), np.float32)],)),
    ("check_shape", (np.zeros((2, 5), np.float32),)),
    ("unfold", (np.arange(16.0, dtype=np.float32).reshape(2, 8), 1, 3, 2)),
    ("expm1_", (np.arange(3.0, dtype=np.float32),)),
    ("square_", (np.arange(3.0, dtype=np.float32),)),
    ("erf_", (np.arange(3.0, dtype=np.float32),)),
    ("fill_", (np.zeros((2, 2), np.float32), 3.0)),
    ("fill_diagonal_", (np.zeros((3, 3), np.float32), 2.0)),
])
def test_init_helpers_match_jax(name, args):
    def conv(a, f):
        if isinstance(a, np.ndarray):
            return f(a)
        if isinstance(a, list):
            return [conv(v, f) for v in a]
        return a

    want = getattr(P, name)(*(conv(a, lambda v: Tensor(jnp.asarray(v)))
                              for a in args))
    targs = [conv(a, lambda v: torch.from_numpy(v.copy())) for a in args]
    got = getattr(PT, name)(*targs)
    if name.endswith("_"):
        assert got is targs[0]
    np.testing.assert_allclose(np.asarray(got if isinstance(got, list)
                                          else got.numpy()),
                               np.asarray(getattr(want, "_value", want)),
                               rtol=1e-5, atol=1e-6)


def test_randint_like_batch_and_printoptions():
    x = torch.zeros(2, 3, dtype=torch.int64)
    r = PT.randint_like(x, 0, 4)
    assert r.shape == x.shape and r.dtype == torch.int64
    assert ((r >= 0) & (r < 4)).all()
    reader = PT.batch(lambda: iter(range(5)), 2)
    assert list(reader()) == list(P.batch(lambda: iter(range(5)), 2)())
    PT.set_printoptions(precision=3)
    PT.set_printoptions(precision=4)
