"""Dropout in the port (`nn.functional.dropout`, `dropout2d`,
`dropout3d`, `alpha_dropout`, the `Dropout` layers and `core.rng`),
on the CPU.

The two packages draw from different random streams, so dropout is held
by its properties and, where the JAX package is deterministic (p = 0,
inference), against it: the identity at p = 0 and in eval mode, the
scaling of each mode, masks broadcast along the axes `axis` leaves out,
the keep rate within 6 binomial standard deviations of 1 - p, the same
mask from the same seed, the forward's mask in the backward, the dtype
kept, and the kept values rounded as the JAX package rounds them
(``x / (1 - p)`` in x's dtype, bit for bit).  Also the documented
departure of ROADMAP C2.6: attention-probability dropout is applied on
neither device, so `scaled_dot_product_attention` with ``dropout_p=0.1``
in training equals its ``dropout_p=0`` output exactly.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.nn import functional as TF

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)


def _x(*shape, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dtype)


def test_identity_at_p0_and_in_eval_mode():
    x = _x(4, 8)
    assert TF.dropout(x, 0.0) is x
    assert TF.dropout(x, 0.5, training=False) is x
    layer = tnn.Dropout(0.5)
    layer.eval()
    assert layer(x) is x
    for cls in (tnn.Dropout2D, tnn.Dropout3D):
        assert cls(0.5).eval()(x) is x
    assert tnn.Dropout().p == 0.5          # JAX's default rate
    # eval in downscale_in_infer scales by 1 - p, as JAX does
    want = P.nn.functional.dropout(P.to_tensor(x.numpy()), 0.3,
                                   training=False,
                                   mode="downscale_in_infer").numpy()
    got = TF.dropout(x, 0.3, training=False, mode="downscale_in_infer")
    np.testing.assert_array_equal(got.numpy(), want)
    layer = tnn.Dropout(0.3, mode="downscale_in_infer").eval()
    assert torch.equal(layer(x), got)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_modes_scale_the_kept_values(mode):
    x = _x(64, 64) + 3.0            # no zeros of its own
    p = 0.25
    out = TF.dropout(x, p, mode=mode)
    keep = out != 0
    scale = 1 / (1 - p) if mode == "upscale_in_train" else 1.0
    assert torch.equal(out[keep], x[keep] * scale if scale == 1.0
                       else x[keep] / (1 - p))
    assert 0 < int(keep.sum()) < x.numel()


def test_kept_values_round_as_jax_rounds_them():
    """``where(keep, x / (1 - p), 0)`` in x's dtype: at the positions both
    packages keep, the values are equal bit for bit (f32 and bf16)."""
    for dtype, jdt in ((torch.float32, "float32"),
                       (torch.bfloat16, "bfloat16")):
        x = _x(128, 64, seed=1, dtype=dtype)
        p = 0.1
        got = TF.dropout(x, p)
        jx = P.to_tensor(x.float().numpy()).astype(jdt)
        want = torch.from_numpy(np.array(
            P.nn.functional.dropout(jx, p).astype("float32").numpy()))
        both = (got.float() != 0) & (want != 0)
        assert int(both.sum()) > 1000
        assert got.dtype == dtype
        assert torch.equal(got.float()[both], want[both]), dtype


@pytest.mark.parametrize("axis", [0, 1, [0, 2]])
def test_axis_broadcasts_the_mask(axis):
    """The mask has x's size on `axis` and 1 elsewhere: every slice
    along the other axes is kept or dropped whole."""
    x = _x(6, 5, 7, seed=2) + 3.0
    out = TF.dropout(x, 0.5, axis=axis)
    keep = out != 0
    axes = [axis] if isinstance(axis, int) else axis
    others = tuple(i for i in range(3) if i not in axes)
    first = keep.narrow(others[0], 0, 1)
    assert torch.equal(keep, first.expand_as(keep))
    assert 0 < int(keep.sum()) < keep.numel()


def test_dropout2d_and_3d_drop_whole_channels():
    x = _x(4, 16, 5, 5, seed=3) + 3.0
    keep = TF.dropout2d(x, 0.5) != 0
    assert torch.equal(keep, keep[:, :, :1, :1].expand_as(keep))
    xl = _x(4, 5, 5, 16, seed=3) + 3.0
    keep = TF.dropout2d(xl, 0.5, data_format="NHWC") != 0
    assert torch.equal(keep, keep[:, :1, :1, :].expand_as(keep))
    x3 = _x(2, 8, 3, 3, 3, seed=4) + 3.0
    keep = tnn.Dropout3D(0.5).train()(x3) != 0
    assert torch.equal(keep, keep[:, :, :1, :1, :1].expand_as(keep))


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_keep_rate_within_binomial_bounds(p):
    n = 200_000
    kept = int((TF.dropout(torch.ones(n), p) != 0).sum())
    sd = (n * p * (1 - p)) ** 0.5
    assert abs(kept - n * (1 - p)) <= 6 * sd


def test_same_seed_same_mask_and_draws_advance():
    x = _x(32, 32, seed=5)
    rng.seed(11)
    a = TF.dropout(x, 0.5)
    b = TF.dropout(x, 0.5)
    rng.seed(11)
    assert torch.equal(TF.dropout(x, 0.5), a)
    assert not torch.equal(a, b)
    state = rng.get_rng_state("cpu")
    c = TF.dropout(x, 0.5)
    rng.set_rng_state(state, "cpu")
    assert torch.equal(TF.dropout(x, 0.5), c)
    assert rng.generator("cpu") is rng.generator(torch.device("cpu"))


def test_backward_uses_the_forward_mask():
    x = _x(16, 16, seed=6).requires_grad_()
    p = 0.3
    out = TF.dropout(x, p)
    g = _x(16, 16, seed=7)
    (out * g).sum().backward()
    keep = out.detach() != 0
    assert torch.equal(x.grad, torch.where(keep, g / (1 - p), 0.0))


def test_alpha_dropout_matches_jax_where_both_keep():
    """Dropped elements take one constant and kept ones an affine map of
    x (JAX :82-95, with its 1 / scale in the factor): at the positions
    both packages keep, and for the dropped constant, the port's values
    equal JAX's; the drop rate is within 6 binomial deviations of p."""
    x = torch.nn.functional.selu(_x(100_000, seed=8))
    p = 0.2
    out = TF.alpha_dropout(x, p)
    want = torch.from_numpy(np.array(P.nn.functional.alpha_dropout(
        P.to_tensor(x.numpy()), p).numpy()))
    const = torch.mode(out).values
    assert torch.isclose(const, torch.mode(want).values, rtol=1e-6)
    dropped, jdropped = out == const, want == torch.mode(want).values
    both = ~dropped & ~jdropped
    assert torch.allclose(out[both], want[both], rtol=0, atol=1e-6)
    sd = (x.numel() * p * (1 - p)) ** 0.5
    assert abs(int(dropped.sum()) - x.numel() * p) <= 6 * sd
    assert out.dtype == x.dtype


def test_dtype_is_kept():
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        x = _x(8, 8, dtype=dtype)
        assert TF.dropout(x, 0.5).dtype == dtype
        assert TF.dropout(x, 0.5, axis=1,
                          mode="downscale_in_infer").dtype == dtype


def test_attention_dropout_is_applied_to_nothing():
    """ROADMAP C2.6: the JAX entry passes no dropout to its flash kernels
    and its plain version ignores the rate, so the port's attention
    gives, in training, the dropout_p=0 output exactly; an encoder layer
    whose only rate is the attention's equals its eval forward."""
    q, k, v = (_x(2, 9, 4, 8, seed=s) for s in (9, 10, 11))
    want = TF.scaled_dot_product_attention(q, k, v)
    for p in (0.1, 0.9):
        assert torch.equal(TF.scaled_dot_product_attention(
            q, k, v, dropout_p=p, training=True), want)
    layer = tnn.TransformerEncoderLayer(32, 4, 64, dropout=0.0,
                                        attn_dropout=0.5, device="cpu")
    x = _x(2, 9, 32, seed=12)
    with torch.no_grad():
        assert torch.equal(layer.train()(x), layer.eval()(x))


def test_layers_drop_in_training_mode():
    """The encoder layer and the ViT and ERNIE models at their default
    rates: training mode draws masks (two forwards differ), eval does
    not."""
    from paddle_tpu_torch.models import ernie as TE
    from paddle_tpu_torch.vision.models import vit as TV

    layer = tnn.TransformerEncoderLayer(32, 4, 64, device="cpu")  # 0.1
    x = _x(2, 9, 32, seed=13)
    ernie = TE.ErnieForPretraining(TE.ernie_tiny(num_layers=1),
                                   device="cpu")
    ids = torch.randint(1, 1024, (2, 16),
                        generator=torch.Generator().manual_seed(0))
    vit = TV.VisionTransformer(img_size=16, patch_size=8, embed_dim=32,
                               depth=1, num_heads=4, num_classes=3,
                               drop_rate=0.1, device="cpu")
    img = _x(2, 3, 16, 16, seed=14)
    with torch.no_grad():
        for model, inp in ((layer, x), (ernie, ids), (vit, img)):
            model.eval()
            first = model(inp)
            first = first[0] if isinstance(first, tuple) else first
            again = model(inp)
            again = again[0] if isinstance(again, tuple) else again
            assert torch.equal(first, again)
            model.train()
            a, b = model(inp), model(inp)
            a = a[0] if isinstance(a, tuple) else a
            b = b[0] if isinstance(b, tuple) else b
            assert not torch.equal(a, b)
