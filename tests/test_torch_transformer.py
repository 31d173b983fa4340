"""The port's `nn.Transformer` family against the JAX package's, on the
CPU at 2 + 2 layers, d_model 32, 4 heads, feed-forward 64, f32.

With the JAX layers' weights (`load_reference_state`), the same seeded
inputs and masks (a [B, 1, 1, S] source pad mask, the causal
`generate_square_subsequent_mask`), `Transformer`'s output agrees within
1e-5 of the largest value and every parameter's gradient, the inputs'
and a trainable mask's within 1e-4 of ``jax.grad``, post-LN and pre-LN
(`normalize_before`, the stacks' final norms).  `TransformerDecoder`'s
incremental decoding through `gen_cache` (a `Cache` that grows a step at
a time, a `StaticCache` of the memory) gives JAX's cached outputs step
by step and the full decoder's last rows.  `TransformerDecoderLayer`
alone, the stacks' deep copies, the per-sublayer `weight_attr` /
`bias_attr` lists, and the square mask are held too.
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
from paddle_tpu_torch.models.gpt import load_reference_state
from paddle_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

W, H, FF, B, S, T = 32, 4, 64, 2, 10, 7
TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = D._default
    D.set_device("cpu")
    K.reset_launches()
    yield
    D._default = prev
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def _f(*shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(getattr(want, "_value", want))
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale, what


def _pair(normalize_before=False, **kw):
    P.seed(0)
    args = (W, H, 2, 2, FF, 0.0)
    jm = JN.Transformer(*args, normalize_before=normalize_before, **kw)
    tm = TN.Transformer(*args, normalize_before=normalize_before, **kw)
    params, _ = jm.functional_state()
    rs = np.random.RandomState(1)
    # move the weights off their initial values (biases start at zero)
    params = {n: (np.asarray(v) + 0.1 * rs.randn(*np.shape(v)))
              .astype(np.float32) for n, v in params.items()}
    own = dict(jm.named_parameters())
    for n, v in params.items():
        own[n].set_value(v)
    load_reference_state(tm, params)
    return jm, tm, params


def _masks():
    lens = np.array([S, 6])
    src = np.where(np.arange(S)[None] < lens[:, None], 0.0, -1e9) \
        .astype(np.float32).reshape(B, 1, 1, S)
    tgt = np.triu(np.full((T, T), -np.inf, np.float32), 1)
    return src, tgt


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_forward_and_grads_match_jax(normalize_before):
    jm, tm, params = _pair(normalize_before)
    jm.eval()
    tm.eval()
    src, tgt = _f(B, S, W, seed=2), _f(B, T, W, seed=3)
    smask, tmask = _masks()
    assert np.array_equal(
        TN.Transformer.generate_square_subsequent_mask(T).numpy(), tmask)
    assert np.array_equal(
        np.asarray(JN.Transformer.generate_square_subsequent_mask(T)._value),
        tmask)
    g = _f(B, T, W, seed=4)

    def loss(p, s_, t_, m_):
        out, _ = jm.functional_call(p, {}, Tensor(s_), Tensor(t_),
                                    Tensor(m_), Tensor(jnp.asarray(tmask)),
                                    Tensor(m_))
        return jnp.sum(out * g), out

    (_, want), jg = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                       has_aux=True)(
        params, *(jnp.asarray(a) for a in (src, tgt, smask)))
    ts, tt, tmk = (torch.from_numpy(a).requires_grad_()
                   for a in (src, tgt, smask))
    out = tm(ts, tt, tmk, torch.from_numpy(tmask), tmk)
    _close(out, want, TOL, "out")
    (out * torch.from_numpy(g)).sum().backward()
    for t, w, what in zip((ts, tt, tmk), jg[1:], ("dsrc", "dtgt", "dmask")):
        _close(t.grad, w, GRAD_TOL, what)
    for n, p in tm.named_parameters():
        _close(p.grad, jg[0][n], GRAD_TOL, n)
    names = sorted(n for n, _ in tm.named_parameters())
    assert names == sorted(params)
    if normalize_before:
        assert "encoder.norm.weight" in names and \
            "decoder.norm.weight" in names


def test_cached_decoding_matches_jax_and_the_full_decoder():
    jm, tm, _ = _pair()
    jm.eval()
    tm.eval()
    src = _f(B, S, W, seed=5)
    smask, _ = _masks()
    steps = _f(B, T, W, seed=6)
    with torch.no_grad():
        memory = tm.encoder(torch.from_numpy(src), torch.from_numpy(smask))
    jmem = jm.encoder(Tensor(jnp.asarray(src)), Tensor(jnp.asarray(smask)))
    _close(memory, jmem, TOL, "memory")
    tcache = tm.decoder.gen_cache(memory)
    jcache = jm.decoder.gen_cache(jmem)
    assert isinstance(tcache[0][0], TN.MultiHeadAttention.Cache)
    assert isinstance(tcache[0][1], TN.MultiHeadAttention.StaticCache)
    tmask = torch.from_numpy(smask)
    outs = []
    with torch.no_grad():
        for i in range(T):
            x = torch.from_numpy(steps[:, i:i + 1])
            out, tcache = tm.decoder(x, memory, None, tmask, tcache)
            jout, jcache = jm.decoder(Tensor(jnp.asarray(steps[:, i:i + 1])),
                                      jmem, None, Tensor(jnp.asarray(smask)),
                                      jcache)
            _close(out, jout, TOL, f"step {i}")
            outs.append(out)
        assert tcache[0][0].k.shape == (B, T, H, W // H)
        full = tm.decoder(torch.from_numpy(steps), memory,
                          TN.Transformer.generate_square_subsequent_mask(T),
                          tmask)
    _close(torch.cat(outs, 1), full.numpy(), TOL, "cached == full")


def test_decoder_layer_and_stack_copies():
    P.seed(0)
    jl = JN.TransformerDecoderLayer(W, H, FF, 0.0, "gelu",
                                    normalize_before=True)
    tl = TN.TransformerDecoderLayer(W, H, FF, 0.0, "gelu",
                                    normalize_before=True)
    load_reference_state(tl, jl.functional_state()[0])
    tgt, mem = _f(B, T, W, seed=7), _f(B, S, W, seed=8)
    _, tmask = _masks()
    want = jl(*(Tensor(jnp.asarray(a)) for a in (tgt, mem, tmask)))
    got = tl(*(torch.from_numpy(a) for a in (tgt, mem, tmask)))
    _close(got, want, TOL)
    stack = TN.TransformerDecoder(tl, 3, TN.LayerNorm(W))
    assert stack.layers[0] is tl
    for layer in stack.layers[1:]:
        for (n, a), (_, b) in zip(tl.named_parameters(),
                                  layer.named_parameters()):
            assert torch.equal(a, b) and a is not b, n


def test_weight_and_bias_attrs_per_sublayer():
    from paddle_tpu_torch.nn import initializer as I

    attrs = [TN.ParamAttr(initializer=I.Constant(0.1)),
             TN.ParamAttr(initializer=I.Constant(0.2)),
             TN.ParamAttr(initializer=I.Constant(0.3))]
    dec = TN.TransformerDecoderLayer(W, H, FF, weight_attr=attrs,
                                     bias_attr=False)
    assert (dec.self_attn.q_proj.weight == 0.1).all()
    assert (dec.cross_attn.out_proj.weight == 0.2).all()
    assert (dec.linear1.weight == 0.3).all() and dec.linear1.bias is None
    enc = TN.TransformerEncoderLayer(W, H, FF, weight_attr=attrs[:2])
    assert (enc.self_attn.k_proj.weight == 0.1).all()
    assert (enc.linear2.weight == 0.2).all()
    one = TN.Transformer(W, H, 1, 1, FF, weight_attr=attrs[2])
    assert all((p == 0.3).all() for n, p in one.named_parameters()
               if n.endswith("proj.weight") or "linear" in n and
               n.endswith("weight"))


def test_defaults_are_transformer_base():
    """`Transformer()`'s defaults: d_model 512, 8 heads, 6 + 6 layers,
    feed-forward 2048, dropout 0.1 (JAX :272), on the meta device."""
    tm = TN.Transformer(device="meta")
    assert len(tm.encoder.layers) == 6 and len(tm.decoder.layers) == 6
    layer = tm.decoder.layers[0]
    assert layer.linear1.weight.shape == (512, 2048)
    assert layer.self_attn.num_heads == 8 and layer.dropout.p == 0.1
    n = sum(p.numel() for p in tm.parameters())
    jn = sum(int(np.prod(p.shape)) for p in JN.Transformer().parameters())
    assert n == jn
