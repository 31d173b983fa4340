"""The port's `nn.utils` and `nn.quant` against the JAX package's, on
the CPU.

`nn.utils`: the clip helpers on the same gradients (totals and clipped
gradients within 1e-6), `parameters_to_vector` / `vector_to_parameters`
exactly, `weight_norm` / `remove_weight_norm` and `spectral_norm` on a
`Linear` and a `Conv2D` with the JAX weights: outputs within 1e-5 over
three forwards (spectral norm's power-iteration vector advancing in
both), gradients of every parameter within 1e-4 of ``jax.grad`` of the
JAX layer's `functional_call`.

`nn.quant`: the int8 / int4 / LLM.int8 codes of `weight_quantize` bit
for bit against JAX's, per channel and with groups of 64 and 128 (a
width that is not a multiple of the group included), the scales within
1 ulp, `weight_dequantize`, `weight_only_linear`, `llm_int8_linear`
(with outlier channels) and `WeightOnlyLinear.from_linear` within 1e-5
relative to the largest output, and `Stub`.
"""
from __future__ import annotations

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
from paddle_tpu_torch.nn.layer_base import load_reference_state

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = D._default
    D.set_device("cpu")
    yield
    D._default = prev


def _f(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(getattr(x, "_value", x))


def _pair(make_j, make_t):
    P.seed(0)
    jm, tm = make_j(), make_t()
    load_reference_state(tm, *jm.functional_state())
    return jm, tm


def _linear_pair(seed=0):
    return _pair(lambda: JN.Linear(6, 4), lambda: TN.Linear(6, 4))


def _backward_both(jm, tm, x):
    out = jm(Tensor(jnp.asarray(x)))
    out.sum().backward()
    tm(torch.from_numpy(x)).sum().backward()


# ------------------------------------------------------------ clip helpers
@pytest.mark.parametrize("norm_type,max_norm", [(2.0, 0.5), (1.0, 0.3),
                                                (float("inf"), 0.2),
                                                (2.0, 1e3)])
def test_clip_grad_norm_matches_jax(norm_type, max_norm):
    jm, tm = _linear_pair()
    _backward_both(jm, tm, _f(3, 6, seed=1, scale=3.0))
    jp, tp = jm.parameters(), list(tm.parameters())
    jt = JN.utils.clip_grad_norm_(jp, max_norm, norm_type)
    tt = TN.utils.clip_grad_norm_(tp, max_norm, norm_type)
    np.testing.assert_allclose(_np(tt), _np(jt), rtol=1e-6)
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(_np(b.grad), _np(a.grad), rtol=1e-6,
                                   atol=1e-7)


def test_clip_grad_value_matches_jax():
    jm, tm = _linear_pair()
    _backward_both(jm, tm, _f(3, 6, seed=2, scale=3.0))
    JN.utils.clip_grad_value_(jm.parameters(), 0.7)
    TN.utils.clip_grad_value_(list(tm.parameters()), 0.7)
    for a, b in zip(jm.parameters(), tm.parameters()):
        np.testing.assert_array_equal(_np(b.grad), _np(a.grad))
    assert TN.utils.clip_grad_norm_([torch.zeros(2)], 1.0).item() == 0.0


def test_parameters_to_vector_and_back():
    jm, tm = _linear_pair()
    jv = JN.utils.parameters_to_vector(jm.parameters())
    tv = TN.utils.parameters_to_vector(tm.parameters())
    np.testing.assert_array_equal(_np(tv), _np(jv))
    new = torch.arange(tv.numel(), dtype=torch.float32)
    TN.utils.vector_to_parameters(new, tm.parameters())
    JN.utils.vector_to_parameters(Tensor(jnp.asarray(new.numpy())),
                                  jm.parameters())
    for a, b in zip(jm.parameters(), tm.parameters()):
        np.testing.assert_array_equal(_np(b), _np(a))
    with pytest.raises(ValueError):
        TN.utils.vector_to_parameters(torch.zeros(3), tm.parameters())


# ------------------------------------------------------------ reparametrised
def _norm_pair(kind, layer, dim):
    make = {"linear": (lambda nn: nn.Linear(6, 4)),
            "conv": (lambda nn: nn.Conv2D(3, 4, 3))}[layer]

    # the JAX weights are moved first, then both layers are wrapped:
    # spectral norm's first power iteration (at wrap time) reads them
    jm, tm = _pair(lambda: make(JN), lambda: make(TN))
    if kind == "weight_norm":
        return (JN.utils.weight_norm(jm, dim=dim),
                TN.utils.weight_norm(tm, dim=dim))
    return (JN.utils.spectral_norm(jm, dim=dim),
            TN.utils.spectral_norm(tm, dim=dim))


NORM_CASES = [("weight_norm", "linear", 0), ("weight_norm", "linear", None),
              ("weight_norm", "conv", 0), ("weight_norm", "conv", 1),
              ("spectral_norm", "linear", None),
              ("spectral_norm", "linear", 1),
              ("spectral_norm", "conv", None)]


def _input(layer, seed):
    return _f(2, 6, seed=seed) if layer == "linear" else _f(2, 3, 7, 7,
                                                            seed=seed)


@pytest.mark.parametrize("kind,layer,dim", NORM_CASES)
def test_norm_reparametrisation_matches_jax(kind, layer, dim):
    jm, tm = _norm_pair(kind, layer, dim)
    assert sorted(jm.functional_state()[0]) == sorted(
        n for n, _ in tm.named_parameters())
    for step in range(3):
        x = _input(layer, step)
        np.testing.assert_allclose(
            _np(tm(torch.from_numpy(x))), _np(jm(Tensor(jnp.asarray(x)))),
            rtol=1e-5, atol=1e-5, err_msg=f"{kind} step {step}")
    # gradients at a fresh pair's first forward (spectral norm's vector
    # one iteration past the wrap in both)
    jm, tm = _norm_pair(kind, layer, dim)
    x = _input(layer, 7)
    g = _f(*((2, 4) if layer == "linear" else (2, 4, 5, 5)), seed=8)
    params, buffers = jm.functional_state()

    def loss(p):
        out, _ = jm.functional_call(p, buffers, Tensor(jnp.asarray(x)))
        return jnp.sum(getattr(out, "_value", out) * g)

    jg = jax.grad(loss)(params)
    tm.zero_grad()
    (tm(torch.from_numpy(x)) * torch.from_numpy(g)).sum().backward()
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(_np(p.grad), np.asarray(jg[n]),
                                   rtol=1e-4, atol=1e-4, err_msg=n)


def test_remove_weight_norm_keeps_the_effective_weight():
    jm, tm = _norm_pair("weight_norm", "linear", 0)
    x = _f(2, 6, seed=3)
    want = _np(tm(torch.from_numpy(x)))
    TN.utils.remove_weight_norm(tm)
    JN.utils.remove_weight_norm(jm)
    assert sorted(n for n, _ in tm.named_parameters()) == ["bias", "weight"]
    assert isinstance(tm.weight, TN.Parameter)
    np.testing.assert_allclose(_np(tm(torch.from_numpy(x))), want,
                               rtol=1e-6)
    np.testing.assert_allclose(_np(tm.weight), _np(jm.weight), rtol=1e-6)
    with pytest.raises(ValueError):
        TN.utils.remove_weight_norm(tm)


def test_spectral_norm_vector_is_a_non_persistent_buffer():
    """`_sn_u` moves with the layer (`.to`) and stays out of its state
    dict, as JAX keeps it out of `functional_state()`."""
    tm = TN.utils.spectral_norm(TN.Linear(6, 4))
    assert "_sn_u" in dict(tm.named_buffers())
    assert "_sn_u" not in tm.state_dict()
    before = tm._sn_u.clone()
    tm(torch.from_numpy(_f(2, 6)))
    assert not torch.equal(before, tm._sn_u)


# ------------------------------------------------------------ quant
QUANT_CASES = [(algo, g, n_in) for algo in ("weight_only_int8",
                                            "weight_only_int4", "llm.int8")
               for g in (-1, 64, 128) for n_in in (256, 200)]


@pytest.mark.parametrize("algo,group,n_in", QUANT_CASES)
def test_weight_quantize_codes_bit_for_bit(algo, group, n_in):
    w = _f(n_in, 48, seed=n_in + group, scale=0.05)
    jq, js = JN.quant.weight_quantize(Tensor(jnp.asarray(w)), algo=algo,
                                      group_size=group)
    tq, ts = TN.quant.weight_quantize(torch.from_numpy(w), algo=algo,
                                      group_size=group)
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), _np(jq))
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    jd = JN.quant.weight_dequantize(jq, js, algo=algo, group_size=group)
    td = TN.quant.weight_dequantize(tq, ts, algo=algo, group_size=group)
    np.testing.assert_array_equal(td.numpy(), _np(jd))
    assert np.abs(td.numpy() - w).max() <= np.abs(ts.numpy()).max() * 0.5 \
        + 1e-7


@pytest.mark.parametrize("wdtype,group", [("int8", -1), ("int8", 128),
                                          ("int4", -1), ("int4", 64)])
def test_weight_only_linear_matches_jax(wdtype, group):
    algo = "weight_only_int4" if wdtype == "int4" else "weight_only_int8"
    w = _f(256, 40, seed=1, scale=0.05)
    x = _f(3, 5, 256, seed=2)
    b = _f(40, seed=3)
    jq, js = JN.quant.weight_quantize(Tensor(jnp.asarray(w)), algo=algo,
                                      group_size=group)
    tq, ts = TN.quant.weight_quantize(torch.from_numpy(w), algo=algo,
                                      group_size=group)
    want = _np(JN.quant.weight_only_linear(
        Tensor(jnp.asarray(x)), jq, Tensor(jnp.asarray(b)), js, wdtype,
        group_size=group))
    got = TN.quant.weight_only_linear(torch.from_numpy(x), tq,
                                      torch.from_numpy(b), ts, wdtype,
                                      group_size=group).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("threshold", [6.0, 1.5])
def test_llm_int8_linear_matches_jax(threshold):
    w = _f(128, 32, seed=4, scale=0.05)
    x = _f(4, 128, seed=5)
    x[:, 7] *= 20.0                      # an outlier channel
    b = _f(32, seed=6)
    jq, js = JN.quant.weight_quantize(Tensor(jnp.asarray(w)), "llm.int8")
    tq, ts = TN.quant.weight_quantize(torch.from_numpy(w), "llm.int8")
    want = _np(JN.quant.llm_int8_linear(
        Tensor(jnp.asarray(x)), jq, Tensor(jnp.asarray(b)), js, threshold))
    got = TN.quant.llm_int8_linear(torch.from_numpy(x), tq,
                                   torch.from_numpy(b), ts, threshold)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("wdtype,group", [("int8", -1), ("int4", 128)])
def test_weight_only_linear_layer_from_linear(wdtype, group):
    jlin, tlin = _pair(lambda: JN.Linear(256, 24), lambda: TN.Linear(256, 24))
    jq = JN.quant.WeightOnlyLinear.from_linear(jlin, wdtype, group)
    tq = TN.quant.WeightOnlyLinear.from_linear(tlin, wdtype, group)
    np.testing.assert_array_equal(tq.quant_weight.numpy(),
                                  _np(jq.quant_weight))
    assert not tq.quant_weight.requires_grad
    x = _f(3, 256, seed=9)
    want = _np(jq(Tensor(jnp.asarray(x))))
    np.testing.assert_allclose(_np(tq(torch.from_numpy(x))), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    fresh = TN.quant.WeightOnlyLinear(256, 24, wdtype, group)
    assert tuple(fresh.quant_weight.shape) == tuple(jq.quant_weight.shape)
    assert tuple(fresh.weight_scale.shape) == tuple(jq.weight_scale.shape)


def test_quant_refusals_match_jax():
    w = torch.zeros(8, 4)
    for bad in (dict(algo="int3"), dict(group_size=32)):
        with pytest.raises(ValueError):
            TN.quant.weight_quantize(w, **bad)
        with pytest.raises(ValueError):
            JN.quant.weight_quantize(Tensor(jnp.zeros((8, 4))), **bad)
    with pytest.raises(ValueError, match="even"):
        TN.quant.weight_quantize(torch.zeros(7, 4), "weight_only_int4")
    with pytest.raises(ValueError, match="even"):
        TN.quant.WeightOnlyLinear(7, 4, "int4")


def test_stub_is_identity_until_given_an_observer():
    x = torch.from_numpy(_f(2, 3))
    assert TN.quant.Stub()(x) is x

    class Twice:
        def instance(self):
            return lambda v: v * 2

    torch.testing.assert_close(TN.quant.Stub(Twice())(x), x * 2)
