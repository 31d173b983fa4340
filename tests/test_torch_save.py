"""`paddle_tpu_torch.save` / `load` against the JAX package's, on the CPU.

A `.pdparams` file written by either package loads in the other: f32,
bf16 (raw uint16 words on the wire, no `ml_dtypes` on the port's side),
f16 and integer tensors, nested dicts, lists and tuples, and plain
values beside them.  Tensors compare bit for bit.  A JAX `gpt_tiny`
state written by `paddle_tpu.save` and loaded into the port's model
gives the JAX model's logits within 1e-4 (f32 matmul reduction order,
as `tests/test_torch_gpt.py` holds the two models).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as P
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT

import paddle_tpu_torch as PT
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

torch.set_num_threads(1)

CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=64)


def _words(x):
    """A tensor of either package as comparable numpy: bf16 as its uint16
    words, everything else as is."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x._value)
    return a.view(np.uint16) if str(a.dtype) == "bfloat16" else a


def _nested(rs):
    """(port object, JAX object, structure) of one seeded nesting."""
    f32 = rs.randn(3, 5).astype(np.float32)
    bf = rs.randn(4, 6).astype(np.float32)
    f16 = rs.randn(7).astype(np.float16)
    i32 = rs.randint(-9, 9, (2, 3)).astype(np.int32)
    port = {"w": torch.from_numpy(f32),
            "blocks": [{"b": torch.from_numpy(bf).bfloat16(),
                        "h": torch.from_numpy(f16)},
                       (torch.from_numpy(i32), 3, "name")],
            "step": 7, "lr": 0.5}
    jax = {"w": Tensor(jnp.asarray(f32)),
           "blocks": [{"b": Tensor(jnp.asarray(bf, jnp.bfloat16)),
                       "h": Tensor(jnp.asarray(f16))},
                      (Tensor(jnp.asarray(i32)), 3, "name")],
           "step": 7, "lr": 0.5}
    return port, jax


def _assert_same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, (torch.Tensor, Tensor)):
        wa, wb = _words(a), _words(b)
        assert wa.dtype == wb.dtype and wa.shape == wb.shape
        assert np.array_equal(wa, wb)
    else:
        assert a == b


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pdparams_cross_packages(tmp_path, writer):
    port, jax = _nested(np.random.RandomState(0))
    path = str(tmp_path / "state.pdparams")
    if writer == "port":
        PT.save(port, path)
        got = P.load(path)
        _assert_same(got, jax)
    else:
        P.save(jax, path)
        got = PT.load(path, device="cpu")
        _assert_same(got, port)
    # the round trip through the other package and back is bit for bit
    again = str(tmp_path / "again.pdparams")
    if writer == "port":
        P.save(got, again)
        _assert_same(PT.load(again, device="cpu"), port)
    else:
        PT.save(got, again)
        _assert_same(P.load(again), jax)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16",
                                   "int64", "bool"])
def test_port_round_trip_is_bit_for_bit(tmp_path, dtype):
    rs = np.random.RandomState(1)
    t = torch.from_numpy(rs.randn(5, 3).astype(np.float32))
    t = {"bool": t > 0, "int64": (t * 100).long()}.get(
        dtype, t.to(getattr(torch, dtype)))
    path = str(tmp_path / "t.pdparams")
    PT.save({"t": t, "nested": [t, {"u": t}]}, path)
    back = PT.load(path, device="cpu")
    for x in (back["t"], back["nested"][0], back["nested"][1]["u"]):
        assert x.dtype == t.dtype and torch.equal(x, t)


def test_bf16_words_travel_without_ml_dtypes(tmp_path):
    """The payload holds uint16 words under the dtype name "bfloat16";
    the loaded words are the original tensor's bit for bit, including
    the ones numpy's float conversion would disturb (NaN payloads,
    subnormals, signed zero)."""
    from paddle_tpu_torch.framework import io_utils

    words = np.array([0x0000, 0x8000, 0x0001, 0x7FC1, 0xFF80, 0x3F80],
                     np.uint16)
    t = torch.from_numpy(words.view(np.int16)).view(torch.bfloat16)
    path = str(tmp_path / "w.pdparams")
    PT.save({"t": t}, path)
    with open(path, "rb") as f:
        raw = io_utils._Unpickler(f).load()["t"]
    assert raw.dtype == "bfloat16" and raw.data.dtype == np.uint16
    assert np.array_equal(raw.data, words)
    assert np.array_equal(_words(PT.load(path, device="cpu")["t"]), words)
    assert np.array_equal(_words(P.load(path)["t"]), words)


def test_jax_gpt_state_file_gives_jax_logits(tmp_path):
    P.seed(0)
    jm = JGPT(JGPTConfig(**CFG))
    jm.eval()
    path = str(tmp_path / "gpt.pdparams")
    P.save(jm.state_dict(), path)
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu", seed=5)
    state = PT.load(path, device="cpu")
    assert list(state) == list(tm.state_dict())
    tm.load_state_dict(state)
    ids = np.random.RandomState(0).randint(0, 128, (3, 11)).astype(np.int32)
    jl = np.asarray(jm(P.to_tensor(ids, "int32"))._value)
    with torch.inference_mode():
        tl = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)


def test_port_gpt_state_file_loads_in_jax(tmp_path):
    """The port's state dict written by `save` sets the JAX model's
    state: every tensor arrives bit for bit, the logits within 1e-4."""
    tm = GPTForCausalLM(GPTConfig(**CFG), device="cpu", seed=3)
    path = str(tmp_path / "gpt.pdparams")
    PT.save(tm.state_dict(), path)
    P.seed(1)
    jm = JGPT(JGPTConfig(**CFG))
    jm.eval()
    missing, unexpected = jm.set_state_dict(P.load(path))
    assert not missing and not unexpected
    for name, t in tm.state_dict().items():
        assert np.array_equal(np.asarray(jm.state_dict()[name]._value),
                              t.numpy()), name
    ids = np.random.RandomState(2).randint(0, 128, (2, 9)).astype(np.int32)
    jl = np.asarray(jm(P.to_tensor(ids, "int32"))._value)
    with torch.inference_mode():
        tl = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)


def test_save_refuses_old_protocols_and_makes_directories(tmp_path):
    path = str(tmp_path / "a" / "b" / "s.pdparams")
    PT.save({"x": torch.ones(2)}, path)
    assert torch.equal(PT.load(path, device="cpu")["x"], torch.ones(2))
    with pytest.raises(ValueError, match="protocol"):
        PT.save({"x": torch.ones(2)}, path, protocol=2)
