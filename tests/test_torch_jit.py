"""The port's `jit.to_static` (``paddle_tpu_torch/jit/api.py``) against
the JAX package's, on the CPU in float32.

On the CPU a `StaticFunction` runs its function eagerly (on the card it
replays one CUDA graph per input signature; ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` phase 14 hold the replay to the eager forward bit
for bit there, and ``tests/test_torch_graphs.py`` its replay path here).
Covered: `to_static(model)` equals the eager forward bit for bit and the
JAX `paddle_tpu.jit.to_static` of the same model with the same weights
within 1e-4 of the largest reference logit (``test_torch_vision.py``'s
model tolerance: f32 reduction order); the signature keys have the JAX
`_sig_of`'s classes; the decorator forms; training mode, grad enabled
and ``backend="sot"`` raise.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.jit import api as JJA
from paddle_tpu.vision import models as JV
from paddle_tpu_torch import jit as TJ
from paddle_tpu_torch.jit import api as TJA
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.vision import models as TV
from test_torch_vision import MODELS, _seed_bn_stats


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


@pytest.mark.parametrize("name", ["resnet18", "mobilenetv2_x0.25",
                                  "swin_2stage"])
def test_to_static_equals_eager_and_jax_to_static(name):
    jm, tm, size = _pair(name)
    x = np.random.RandomState(3).randn(2, 3, size, size).astype(np.float32)
    with torch.inference_mode():
        eager = tm(torch.from_numpy(x))
        assert TJ.to_static(tm) is tm
        assert isinstance(tm.forward, TJ.StaticFunction)
        assert tm.forward.layer is tm
        got = [tm(torch.from_numpy(x)) for _ in range(2)]
    for g in got:
        assert torch.equal(g, eager)
    ref = np.asarray(P.jit.to_static(jm)(P.to_tensor(x)).numpy())
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got[0].numpy() - ref).max()) <= 1e-4 * scale


def test_signature_keys_have_the_jax_classes():
    """Tensors by shape and dtype, sequences and dicts item by item (dict
    keys sorted), anything else by its repr: the same key as the JAX
    `_sig_of` for the same values."""
    rs = np.random.RandomState(4)
    a = rs.randn(2, 3).astype(np.float32)
    ids = rs.randint(0, 9, (4,)).astype(np.int32)
    cases = [lambda t: t(a), lambda t: [t(a), 3, "x"],
             lambda t: {"b": t(ids), "a": (t(a), None)}, lambda t: 2.5]
    for case in cases:
        assert TJA._sig_of(case(torch.from_numpy)) == \
            JJA._sig_of(case(P.to_tensor))
    assert TJA._sig_of(torch.zeros(2, dtype=torch.bfloat16)) == \
        JJA._sig_of(P.to_tensor(np.zeros(2, np.float32)).astype("bfloat16"))


def test_decorator_forms_and_plain_functions():
    calls = []

    @TJ.to_static
    def double(x, k=2):
        calls.append(k)
        return x * k

    @TJ.to_static(input_spec=None)
    def add(x, y):
        return x + y

    x = torch.arange(4.0)
    with torch.no_grad():
        assert torch.equal(double(x, k=3), x * 3)
        assert torch.equal(add(x, x), x + x)
    assert calls == [3] and double.layer is None


def test_training_grad_and_sot_raise():
    """Not ported (ROADMAP A6, A9), and nothing runs eagerly instead."""
    model = TV.resnet18(num_classes=10, device="cpu")
    TJ.to_static(model)
    x = torch.zeros(1, 3, 32, 32)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A6"):
        model(x)                                   # grad enabled
    model.train()
    with torch.no_grad(), pytest.raises(NotImplementedError,
                                        match="ROADMAP Queue A6"):
        model(x)                                   # training mode
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A9"):
        TJ.to_static(TV.resnet18(num_classes=10, device="cpu"),
                     backend="sot")
