"""`paddle_tpu_torch.jit.save` / `jit.load` against the JAX package's, on
the CPU in float32.

The port exports the layer's forward as a pure function of (params,
buffers, *inputs) through `torch.export`; the JAX package through
`jax.export`.  With the same weights (carried from the JAX model) and
the same seeded inputs, the loaded programs agree within 1e-4 of the
largest output (f32 reduction order; the f32 tolerance of
`tests/test_torch_gpt.py` and `tests/test_torch_vision.py`): gpt_tiny,
llama_tiny and a small ResNet.  The port's loaded program equals its
eager forward bit for bit.  `.pdmeta` carries JAX's keys and names;
without an `input_spec` both packages raise the same error at load.
The program holds the kernels as ``paddle_tpu_torch::<kernel>`` nodes
(and no weights), also after `move_to_device_pass`.
"""
from __future__ import annotations

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import paddle_tpu as P
from paddle_tpu.models import llama as JL
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.vision import models as JV

from paddle_tpu_torch import jit
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.models.gpt import load_reference_state
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.vision import models as TV

torch.set_num_threads(1)

GPT = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=64)
LLAMA = dict(vocab_size=128, max_seq_len=64)
SWIN_SMALL = dict(img_size=56, embed_dim=24, depths=(2, 2), num_heads=(1, 2),
                  window_size=7, num_classes=10)


def _seed_bn_stats(jm, seed):
    rs = np.random.RandomState(seed)
    for name, b in jm.named_buffers():
        if name.endswith("_mean"):
            b.set_value(rs.normal(0, 0.1, b.shape).astype(np.float32))
        elif name.endswith("_variance"):
            b.set_value(rs.uniform(0.5, 2.0, b.shape).astype(np.float32))


def _pair(name):
    """(JAX model, port model with its weights, numpy input)."""
    P.seed(0)
    rs = np.random.RandomState(1)
    if name == "gpt_tiny":
        jm = JGPT(JGPTConfig(**GPT))
        tm = GPTForCausalLM(GPTConfig(**GPT), device="cpu")
        x = rs.randint(0, 128, (2, 12)).astype(np.int64)
    elif name == "llama_tiny":
        jm = JL.LlamaForCausalLM(JL.llama_tiny(**LLAMA))
        tm = TL.LlamaForCausalLM(TL.llama_tiny(**LLAMA), device="cpu")
        x = rs.randint(0, 128, (2, 12)).astype(np.int64)
    else:
        jm = JV.resnet18(num_classes=10)
        tm = TV.resnet18(num_classes=10, device="cpu")
        x = rs.randn(2, 3, 32, 32).astype(np.float32)
    jm.eval()
    _seed_bn_stats(jm, 2)
    params, buffers = jm.functional_state()
    load_reference_state(tm, params, buffers)
    return jm, tm, x


def _jax_loaded(path, x):
    """The JAX `TranslatedLayer` at `path` called on `x`.  The language
    models' mpu layers annotate shardings over every host device (8 in
    the test run), and a program exported over 8 devices runs only under
    `jit` with its arguments on those 8: replicated, as the layer's
    `forward` would pass them on one device."""
    layer = P.jit.load(path)
    vals = {k: v._value for k, v in layer._state.items()}
    p = {k: vals[k] for k in layer._param_names if k in vals}
    b = {k: vals[k] for k in layer._buffer_names if k in vals}
    n = layer._exported.nr_devices
    rep = NamedSharding(Mesh(np.array(jax.devices()[:n]), ("d",)),
                        PartitionSpec())
    args = jax.device_put((p, b, layer._key, x), rep)
    return np.asarray(jax.jit(layer._exported.call)(*args))


def _graph_ops(layer):
    return {str(n.target).split(".")[1] for n in layer._exported.graph.nodes
            if str(n.target).startswith("paddle_tpu_torch.")}


@pytest.mark.parametrize("name,ops", [("gpt_tiny", set()),
                                      ("llama_tiny", {"rope"}),
                                      ("resnet18", {"conv_bn_act"})])
def test_loaded_program_matches_jax_and_eager(tmp_path, name, ops):
    jm, tm, x = _pair(name)
    jx = jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)
    P.jit.save(jm, str(tmp_path / "jax"), input_spec=[jx])
    want = _jax_loaded(str(tmp_path / "jax"), jx)
    jit.save(tm, str(tmp_path / "port"), input_spec=[torch.from_numpy(x)])
    loaded = jit.load(str(tmp_path / "port"), device="cpu")
    got = loaded(torch.from_numpy(x))
    with torch.no_grad():
        eager = tm(torch.from_numpy(x))
    assert torch.equal(got, eager)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4 * scale
    # the CPU runs the plain versions inside the program, as the eager
    # model does (GPT's attention on the CPU is the plain `_sdpa_ref`)
    assert _graph_ops(loaded) == ops
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def test_pdmeta_carries_jax_keys_and_names(tmp_path):
    jm, tm, x = _pair("gpt_tiny")
    P.jit.save(jm, str(tmp_path / "jax"),
               input_spec=[jnp.asarray(x.astype(np.int32))])
    jit.save(tm, str(tmp_path / "port"), input_spec=[torch.from_numpy(x)])
    metas = []
    for which in ("jax", "port"):
        with open(str(tmp_path / which) + ".pdmeta", "rb") as f:
            metas.append(pickle.load(f))
    assert set(metas[0]) == set(metas[1]) == {
        "exported", "class", "param_names", "buffer_names"}
    for key in ("exported", "class", "param_names", "buffer_names"):
        assert metas[0][key] == metas[1][key], key
    # the port's .pdparams is the JAX package's state, bit for bit
    state = P.load(str(tmp_path / "port") + ".pdparams")
    for k, v in tm.state_dict().items():
        assert np.array_equal(np.asarray(state[k]._value), v.numpy()), k


def test_no_input_spec_writes_params_and_meta_only(tmp_path):
    jm, tm, _ = _pair("gpt_tiny")
    P.jit.save(jm, str(tmp_path / "jax"))
    jit.save(tm, str(tmp_path / "port"))
    for which, load in (("jax", lambda p: P.jit.load(p)),
                        ("port", lambda p: jit.load(p, device="cpu"))):
        path = str(tmp_path / which)
        assert os.path.exists(path + ".pdparams")
        assert not os.path.exists(path + ".pdmodel")
        with pytest.raises(FileNotFoundError,
                           match=r"no exported program at .*\.pdmodel; "
                                 r"load params with"):
            load(path)


class _Kernels(torch.nn.Module):
    """Every forward op a served model reaches, on small CPU inputs:
    flash (dense and packed), rope, the fused norm, conv + BN + act and
    window attention."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.w = torch.nn.Parameter(torch.randn(8, 4, 3, 3, generator=g))
        self.scale = torch.nn.Parameter(torch.rand(8, generator=g) + 0.5)
        self.norm_w = torch.nn.Parameter(torch.rand(16, generator=g))
        self.bias = torch.nn.Parameter(torch.randn(2, 16, 16, generator=g))

    def forward(self, q, img, qkv):
        fa, ro, fn, cn, wa, va = (
            K.flash_attention, K.rope, K.fused_norm, K.conv_norm,
            K.window_attention, K.varlen_attention)
        cos, sin = q[:, :, :1].cos(), q[:, :, :1].sin()
        r = ro.RoPE.apply(q, cos, sin)
        o = fa.FlashAttention.apply(r, q, q, None, True)
        y = fn.FusedNorm.apply(o.reshape(-1, 16), self.norm_w, None, None,
                               None, 1e-6, "rms")
        cu = torch.tensor([0, 3, 8], dtype=torch.int32)
        p = va.VarlenAttention.apply(o[0], o[0], o[0], cu, cu, None, False)
        c = cn.ConvBNAct.apply(img, self.w, self.scale, self.scale, [1, 1],
                               [1, 1], "relu")
        w = wa.window_attention(qkv, self.bias, None, 4, 0, 2)
        return y.sum() + p.sum() + c.sum() + w.sum()


def _kernel_inputs():
    g = torch.Generator().manual_seed(1)
    return (torch.randn(1, 8, 2, 16, generator=g),
            torch.randn(1, 4, 6, 6, generator=g),
            torch.randn(1, 4, 4, 24, generator=g))


def test_program_holds_every_kernel_op_and_no_weights(tmp_path):
    from torch.export.passes import move_to_device_pass

    m = _Kernels()
    xs = _kernel_inputs()
    jit.save(m, str(tmp_path / "k"), input_spec=list(xs))
    with open(str(tmp_path / "k") + ".pdmodel", "rb") as f:
        program = torch.export.load(f)
    want = {"flash_fwd", "rope", "fused_norm", "varlen_fwd", "conv_bn_act",
            "window_attention"}
    ops = {str(n.target).split(".")[1] for n in program.graph.nodes
           if str(n.target).startswith("paddle_tpu_torch.")}
    assert ops == want
    assert not program.state_dict     # the weights stay in .pdparams
    moved = move_to_device_pass(program, "meta")
    assert {str(n.target).split(".")[1] for n in moved.graph.nodes
            if str(n.target).startswith("paddle_tpu_torch.")} == want
    loaded = jit.load(str(tmp_path / "k"), device="cpu")
    with torch.no_grad():
        assert torch.equal(loaded(*xs), m(*xs))
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def test_pdmodel_size_is_independent_of_the_weights(tmp_path):
    """ROADMAP C1.3: the exported program keeps no example inputs, so
    the parameters travel only in .pdparams: a model 64x wider writes a
    .pdmodel of about the same size, far under its weights, and
    `jit.load` still runs it bit for bit."""
    sizes = {}
    for width in (32, 256):
        net = torch.nn.Sequential(torch.nn.Linear(width, width),
                                  torch.nn.ReLU(),
                                  torch.nn.Linear(width, 4))
        x = torch.randn(2, width)
        path = str(tmp_path / f"w{width}")
        jit.save(net, path, input_spec=[x])
        sizes[width] = os.path.getsize(path + ".pdmodel")
        loaded = jit.load(path, device="cpu")
        with torch.no_grad():
            assert torch.equal(loaded(x), net(x))
    weights = 256 * 256 * 4
    assert sizes[256] - sizes[32] < 16 * 1024, sizes
    assert sizes[256] < weights / 4, sizes


def test_swin_program_holds_window_attention(tmp_path):
    P.seed(0)
    tm = TV.SwinTransformer(**SWIN_SMALL, device="cpu")
    x = torch.from_numpy(np.random.RandomState(3).randn(
        1, 3, 56, 56).astype(np.float32))
    jit.save(tm, str(tmp_path / "swin"), input_spec=[x])
    loaded = jit.load(str(tmp_path / "swin"), device="cpu")
    assert _graph_ops(loaded) == {"window_attention"}
    with torch.no_grad():
        assert torch.equal(loaded(x), tm(x))


def test_save_restores_training_mode_and_a_static_forward(tmp_path):
    """Export runs in eval mode and restores training mode after; a
    `to_static`-wrapped forward is exported as the layer's own forward
    (JAX :275-280), and the wrapper is back on the layer after."""
    _, tm, x = _pair("resnet18")
    tm.train()
    jit.to_static(tm)
    static = tm.forward
    jit.save(tm, str(tmp_path / "r"), input_spec=[torch.from_numpy(x)])
    assert tm.training and tm.forward is static
    tm.eval()
    loaded = jit.load(str(tmp_path / "r"), device="cpu")
    with torch.no_grad():
        assert torch.equal(loaded(torch.from_numpy(x)),
                           tm(torch.from_numpy(x)))
    # a StaticFunction saves its layer
    jit.save(static, str(tmp_path / "s"), input_spec=[torch.from_numpy(x)])
    assert _graph_ops(jit.load(str(tmp_path / "s"), device="cpu")) == {
        "conv_bn_act"}


def test_input_spec_takes_shape_and_dtype_objects(tmp_path):
    class Spec:
        def __init__(self, shape, dtype):
            self.shape, self.dtype = shape, dtype

    _, tm, x = _pair("gpt_tiny")
    for i, dtype in enumerate(("int64", np.dtype("int64"), torch.int64)):
        path = str(tmp_path / f"g{i}")
        jit.save(tm, path, input_spec=[Spec(list(x.shape), dtype)])
        with torch.no_grad():
            assert torch.equal(jit.load(path, device="cpu")(
                torch.from_numpy(x)), tm(torch.from_numpy(x)))
