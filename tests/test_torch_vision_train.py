"""The port's vision training path against the JAX package's, on the CPU.

The same seeded numpy inputs (and, for the models, the same weights,
moved from ``functional_state()`` by `load_reference_state`) go through
both packages, in float32 unless stated:

  (a) the plain window-attention backward `window_attention_bwd_reference`
      against the Pallas `_bwd_pallas` in interpret mode and against
      ``jax.grad`` of `window_attention_ref` (unshifted, shifted with the
      mask, one window, a Swin-sized 7x7 window), atol = rtol = 1e-5 (f32
      reduction order); against torch autograd of the plain forward; the
      `WindowAttentionCore` autograd function's plumbing (dbias in the
      bias's dtype, no gradient for the mask, whose JAX cotangent is
      zero);
  (b) one `Momentum` update (plain and Nesterov, with and without weight
      decay) against the JAX `apply_gradients`, 1e-6;
  (c) `CrossEntropyLoss` against the JAX layer, and its refusals;
  (d) batch norm in training mode (outputs, running statistics) against
      the JAX functional and layer, f32 and bf16;
  (e) 5-step loss trajectories of the train step with `Momentum` and
      `CrossEntropyLoss` against the JAX `build_train_step`, for a small
      two-stage Swin and for ResNet-18 at 32x32, f32 within 1e-4 and
      bf16 O2 within the tolerance the test states, and ResNet's running
      statistics after the steps against the JAX step's buffers (the
      ResNet-18 cases run from ``tests/test_torch_vision_train_resnet.py``,
      a file of their own so that the suite spreads over its workers);
  (f) the O2 input cast of the train step.

On the CPU the kernel wrappers run their plain versions, so nothing here
launches a kernel.  The kernels are held against these plain versions on
the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.distributed import fleet, topology
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import window_attention as JWA
from paddle_tpu.optimizer.optimizer import Momentum as JMomentum
from paddle_tpu.vision import models as JV
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed import build_train_step
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import window_attention as WA
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import models as TV
from paddle_tpu_torch.vision.models import swin as TSW

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _no_launches():
    K.reset_launches()
    yield
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------ (a) the window backward
WIN_CASES = {
    # (B, H, W, C, heads, ws, shift)
    "unshifted": (2, 8, 8, 12, 3, 4, 0),
    "shifted_masked": (2, 8, 8, 8, 2, 4, 2),
    "single_window": (1, 4, 4, 8, 2, 4, 0),
    "swin_ws7_shifted": (1, 14, 14, 16, 2, 7, 3),
}


def _win_inputs(case):
    b, h, w, c, heads, ws, shift = WIN_CASES[case]
    rs = np.random.RandomState(10 + sorted(WIN_CASES).index(case))
    qkv = rs.randn(b, h, w, 3 * c).astype(np.float32)
    bias = rs.randn(heads, ws * ws, ws * ws).astype(np.float32)
    g = rs.randn(b, h, w, c).astype(np.float32)
    mask = TSW._shift_mask((h, w), ws, shift) if shift else None
    return qkv, bias, mask, g, ws, shift, heads


@pytest.mark.parametrize("case", sorted(WIN_CASES))
def test_window_bwd_plain_matches_pallas_bwd_and_jax_grad(case):
    qkv, bias, mask, g, ws, shift, heads = _win_inputs(case)
    jmask = None if mask is None else jnp.asarray(mask)
    pallas = JWA._bwd_pallas(jnp.asarray(qkv), jnp.asarray(bias), jmask,
                             jnp.asarray(g), ws, shift, heads)

    def loss(qv, bv):
        out = JWA.window_attention_ref(qv, bv, jmask, window_size=ws,
                                       shift=shift, num_heads=heads)
        return (out * jnp.asarray(g)).sum()

    grad = jax.grad(loss, argnums=(0, 1))(jnp.asarray(qkv),
                                          jnp.asarray(bias))
    got = WA.window_attention_bwd_reference(
        _t(qkv), _t(bias), None if mask is None else _t(mask), _t(g), ws,
        shift, heads)
    assert got[0].shape == qkv.shape and got[1].shape == bias.shape
    for want in (pallas, grad):
        for a, r in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL)
    # the wrapper takes the plain version for CPU tensors
    wrapped = WA.window_attention_bwd(
        _t(qkv), _t(bias), None if mask is None else _t(mask), _t(g), ws,
        shift, heads)
    assert all(torch.equal(a, r) for a, r in zip(wrapped, got))


@pytest.mark.parametrize("case", sorted(WIN_CASES))
def test_window_bwd_plain_matches_autograd_of_plain_forward(case):
    qkv, bias, mask, g, ws, shift, heads = _win_inputs(case)
    tq, tb = _t(qkv).requires_grad_(), _t(bias).requires_grad_()
    tmask = None if mask is None else _t(mask)
    out = WA.window_attention_reference(tq, tb, tmask, ws, shift, heads)
    want = torch.autograd.grad(out, (tq, tb), _t(g))
    got = WA.window_attention_bwd_reference(tq.detach(), tb.detach(), tmask,
                                            _t(g), ws, shift, heads)
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, **TOL)


def test_window_core_function_gives_plain_grads_and_no_mask_grad():
    """`WindowAttentionCore` (the card's route under autograd) on CPU
    tensors: its forward is the wrapper, its backward the backward
    wrapper, so here both plain versions run.  dbias comes back in the
    bias's dtype; the mask, a stop-gradient constant, gets none, as the
    JAX custom VJP gives it a zero cotangent (`_build_core`, run here in
    interpret mode)."""
    qkv, bias, mask, g, ws, shift, heads = _win_inputs("shifted_masked")
    tq = _t(qkv).requires_grad_()
    tm = _t(mask).requires_grad_()
    for bias_dtype in (torch.float32, torch.bfloat16):
        tb = _t(bias).to(bias_dtype).requires_grad_()
        out = WA.WindowAttentionCore.apply(tq, tb, tm, ws, shift, heads)
        dq, db, dm = torch.autograd.grad(out, (tq, tb, tm), _t(g),
                                         allow_unused=True)
        want = WA.window_attention_bwd_reference(
            tq.detach(), tb.detach(), tm.detach(), _t(g), ws, shift, heads)
        assert dm is None and db.dtype == bias_dtype
        assert torch.equal(dq, want[0])
        assert torch.equal(db, want[1].to(bias_dtype))
    core = JWA._build_core(ws, shift, heads, qkv.shape[1] // ws, True)
    jdm = jax.grad(lambda m: (core(jnp.asarray(qkv), jnp.asarray(bias), m)
                              * jnp.asarray(g)).sum())(jnp.asarray(mask))
    assert not np.asarray(jdm).any()


# ------------------------------------------------------ (b) the optimizer
@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("wd", [None, 0.01])
def test_momentum_update_matches_apply_gradients(nesterov, wd):
    rs = np.random.RandomState(3)
    shapes = {"w": (5, 7), "b": (7,)}
    params = {n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = {n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
    vel = {n: rs.randn(*s).astype(np.float32) * 0.1
           for n, s in shapes.items()}
    kw = dict(learning_rate=3e-3, momentum=0.9, use_nesterov=nesterov,
              weight_decay=wd)
    jp, js = JMomentum(**kw).apply_gradients(
        {n: jnp.asarray(x) for n, x in params.items()},
        {n: jnp.asarray(x) for n, x in grads.items()},
        {"slots": {n: {"velocity": jnp.asarray(x)} for n, x in vel.items()},
         "step": jnp.asarray(4, jnp.int32)})
    opt = Momentum(**kw)
    tp = {n: _t(x) for n, x in params.items()}
    ts = opt.init_state(tp)
    assert all(float(s["velocity"].abs().max()) == 0
               for s in ts["slots"].values())
    for n, x in vel.items():
        ts["slots"][n]["velocity"].copy_(_t(x))
    ts["step"] = 4
    opt.apply_gradients(tp, {n: _t(x) for n, x in grads.items()}, ts)
    assert ts["step"] == int(js["step"]) == 5
    for n in shapes:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(ts["slots"][n]["velocity"].numpy(),
                                   np.asarray(js["slots"][n]["velocity"]),
                                   atol=1e-6, rtol=1e-6)


# ----------------------------------------------------------- (c) the loss
@pytest.mark.parametrize("ignore_index", [-100, 3])
def test_cross_entropy_loss_matches_jax_layer(ignore_index):
    rs = np.random.RandomState(5)
    logits = (rs.randn(6, 11) * 3).astype(np.float32)
    labels = rs.randint(0, 11, (6,)).astype(np.int32)
    labels[2] = ignore_index
    ref = P.nn.CrossEntropyLoss(ignore_index=ignore_index)(
        P.to_tensor(logits), P.to_tensor(labels, "int32")).numpy()
    got = tnn.CrossEntropyLoss(ignore_index=ignore_index)(_t(logits),
                                                          _t(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("ignore_index", [-100, 3])
def test_cross_entropy_takes_paddle_column_labels(ignore_index):
    """[N, 1] labels, Paddle's usual layout (the reference's datasets
    yield ``np.array([label])``): the trailing size-1 axis is squeezed,
    as JAX ``loss.py:50-51`` does, in the functional and the layer."""
    rs = np.random.RandomState(6)
    logits = (rs.randn(6, 11) * 3).astype(np.float32)
    labels = rs.randint(0, 11, (6, 1)).astype(np.int32)
    labels[4, 0] = ignore_index
    ref = P.nn.CrossEntropyLoss(ignore_index=ignore_index)(
        P.to_tensor(logits), P.to_tensor(labels, "int32")).numpy()
    got = tnn.CrossEntropyLoss(ignore_index=ignore_index)(_t(logits),
                                                          _t(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    fn = TF.cross_entropy(_t(logits), _t(labels), ignore_index=ignore_index)
    np.testing.assert_allclose(fn.numpy(), np.asarray(ref), **TOL)
    # the same loss as the [N] form
    flat = TF.cross_entropy(_t(logits), _t(labels[:, 0]),
                            ignore_index=ignore_index)
    assert float(fn) == float(flat)


def test_cross_entropy_loss_refuses_what_is_not_ported():
    """Nothing of the layer is refused any more: each option that once
    raised builds, runs and gives the JAX layer's loss (every option and
    combination is held to JAX in tests/test_torch_cross_entropy.py)."""
    rs = np.random.RandomState(9)
    logits = rs.rand(2, 4).astype(np.float32) + 0.1
    soft = rs.rand(2, 4).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    hard = np.array([1, 3], np.int32)
    w = np.array([0.5, 1.0, 1.5, 2.0], np.float32)
    for kw, label in ((dict(weight=w), hard), (dict(reduction="sum"), hard),
                      (dict(soft_label=True), soft), (dict(axis=1), hard),
                      (dict(use_softmax=False), hard),
                      (dict(label_smoothing=0.1), hard), ({}, soft)):
        tkw = {k: _t(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        jkw = {k: P.to_tensor(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        jlab = P.to_tensor(label, "int32") if label.dtype == np.int32 \
            else P.to_tensor(label)
        ref = P.nn.CrossEntropyLoss(**jkw)(P.to_tensor(logits), jlab).numpy()
        got = tnn.CrossEntropyLoss(**tkw)(_t(logits), _t(label))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


# --------------------------------------------- (d) batch norm in training
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_training_matches_jax(dtype):
    rs = np.random.RandomState(6)
    x = (rs.randn(3, 6, 5, 4) * 2 + 1).astype(np.float32)
    mean = rs.randn(6).astype(np.float32)
    var = (rs.rand(6) + 0.5).astype(np.float32)
    w = (rs.rand(6) + 0.5).astype(np.float32)
    b = rs.randn(6).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jm, jv = P.to_tensor(mean), P.to_tensor(var)
    ref = JF.batch_norm(P.to_tensor(jnp.asarray(x, jd)), jm, jv,
                        P.to_tensor(jnp.asarray(w, jd)),
                        P.to_tensor(jnp.asarray(b, jd)), training=True,
                        momentum=0.8)
    tm, tv = _t(mean), _t(var)
    got = TF.batch_norm(_t(x).to(td), tm, tv, _t(w).to(td), _t(b).to(td),
                        training=True, momentum=0.8)
    assert got.dtype == td and tm.dtype == tv.dtype == torch.float32
    # bf16: one rounding of O(1) outputs, in another order of the sums
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=0)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.numpy()).astype(np.float32),
                               **tol)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm.numpy()), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv.numpy()), **TOL)


def test_batch_norm_layer_training_updates_running_stats_like_jax():
    """`BatchNorm2D(momentum=...)` in training mode against the JAX layer
    over three batches: the outputs, then the running statistics (the
    unbiased variance); in eval mode both normalise with them."""
    P.seed(0)
    jbn = P.nn.BatchNorm2D(5, momentum=0.7)
    tbn = tnn.BatchNorm2D(5, momentum=0.7, device="cpu")
    rs = np.random.RandomState(8)
    for _ in range(3):
        x = (rs.randn(2, 5, 3, 3) * 3 - 1).astype(np.float32)
        ref = jbn(P.to_tensor(x)).numpy()
        got = tbn(_t(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   **TOL)
    np.testing.assert_allclose(tbn._mean.numpy(), jbn._mean.numpy(), **TOL)
    np.testing.assert_allclose(tbn._variance.numpy(),
                               jbn._variance.numpy(), **TOL)
    jbn.eval()
    tbn.eval()
    x = rs.randn(1, 5, 3, 3).astype(np.float32)
    np.testing.assert_allclose(tbn(_t(x)).detach().numpy(),
                               np.asarray(jbn(P.to_tensor(x)).numpy()),
                               **TOL)


# ------------------------------------------------ (e) train trajectories
SWIN_SMALL = dict(img_size=56, embed_dim=24, depths=(2, 2), num_heads=(1, 2),
                  window_size=7, num_classes=10)
# (constructor, kwargs, image size, batch).  ResNet-18 takes a batch of 8:
# at 32x32 its last stage is 1x1, so its batch norms normalise one value
# per image and channel, and over a batch of 2 that is x / sqrt(x^2 +
# eps) up to sign, an ill-conditioned function whose f32 rounding alone
# (4e-2 on the logits, in both frameworks' own order) decides the
# trajectory; over 8 values the two agree to 6e-5.
TRAIN_MODELS = {"swin_2stage": ("SwinTransformer", SWIN_SMALL, 56, 2),
                "resnet18": ("resnet18", dict(num_classes=10), 32, 8)}


def _jax_train(name, amp, imgs, labels, steps):
    """The JAX `build_train_step` of bench.py's vision rows (Momentum lr
    1e-3 and 0.9, CrossEntropyLoss): per-step losses, the final buffers,
    and the port's copy of the initial model."""
    ctor, kw, _, _ = TRAIN_MODELS[name]
    topology.reset_topology()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1, "sep_degree": 1,
                               "sharding_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    try:
        P.seed(0)
        jm = getattr(JV, ctor)(**kw)
        tm = getattr(TV, ctor)(**kw, device="cpu")
        params, buffers = jm.functional_state()
        load_reference_state(tm, params, buffers)
        model = fleet.distributed_model(jm)
        opt = fleet.distributed_optimizer(
            P.optimizer.Momentum(parameters=model.parameters(),
                                 learning_rate=1e-3, momentum=0.9))
        step = model.build_train_step(opt, P.nn.CrossEntropyLoss(),
                                      amp_dtype=amp)
        ji, jl = P.to_tensor(imgs), P.to_tensor(labels, "int32")
        losses = [float(np.asarray(step(ji, jl)._value))
                  for _ in range(steps)]
        bufs = {n: np.asarray(v) for n, v in step._state["buffers"].items()}
    finally:
        topology.reset_topology()
    return losses, bufs, tm


# (model, amp) -> (loss tolerance, buffer tolerance: relative L2 per
# buffer); see the test's docstring for the measured gaps
TRAIN_TOL = {("swin_2stage", None): (1e-4, None),
             ("resnet18", None): (1e-4, 1e-4),
             ("swin_2stage", "bfloat16"): (3e-2, None),
             ("resnet18", "bfloat16"): (1e-1, 0.25)}


@pytest.mark.parametrize("name,amp", [k for k in sorted(TRAIN_TOL, key=str)
                                      if k[0] == "swin_2stage"])
def test_vision_train_step_trajectory_matches_jax(name, amp):
    """The Swin cases of `check_trajectory` (ResNet-18's are in
    ``tests/test_torch_vision_train_resnet.py``)."""
    check_trajectory(name, amp)


def check_trajectory(name, amp):
    """5 Momentum steps on one fixed batch (images and labels seeded with
    numpy, as bench.py:262-264 makes them), both models in training
    mode: ResNet-18's batch norms take batch statistics and update their
    running ones, Swin's window attention differentiates the plain
    version.  Then ResNet-18's running statistics against the JAX step's
    buffers.  Measured largest gaps over the 5 steps (x86 CPU, torch
    2.13, jax 0.9.0):
      * f32: losses Swin 2.4e-7, ResNet-18 3.9e-6 (losses 3.9 -> 0.018);
        buffers 5.4e-6 relative.  Held at 1e-4.
      * bf16 O2: the losses are bf16 values, so their resolution is one
        bf16 ulp (0.0156 at 2-4).  Swin 0.0156, one ulp: held at 3e-2.
        ResNet-18 0.070 (0.684 against 0.613 at step 2) and buffers
        0.12 relative L2 (layer4's batch means, near zero, after 5
        steps; 0.019 after one): its loss falls from 3.9 to 0.6 in one
        step, so the bf16 roundings of the two frameworks, which differ
        in place (conv accumulation, batch norm's casts), move the
        trajectory by more than an ulp.  Held at 0.1 and 0.25, room for
        another CPU's bf16 kernels; the f32 case is the exact check."""
    loss_tol, buf_tol = TRAIN_TOL[(name, amp)]
    _, _, size, batch = TRAIN_MODELS[name]
    rs = np.random.RandomState(0)
    imgs = rs.randn(batch, 3, size, size).astype(np.float32)
    labels = rs.randint(0, 10, (batch,)).astype(np.int32)
    jl, jbufs, tm = _jax_train(name, amp, imgs, labels, 5)
    step = build_train_step(tm, Momentum(learning_rate=1e-3, momentum=0.9),
                            tnn.CrossEntropyLoss(), amp_dtype=amp)
    tl = step.run_steps(imgs, labels, repeat=5)
    assert tl.dtype == torch.float32 and tl.shape == (5,)
    np.testing.assert_allclose(tl.numpy(), jl, atol=loss_tol, rtol=0)
    assert tl[-1] < tl[0]
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    own = {n: b for n, b in tm.named_buffers() if n in tm.state_dict()}
    assert set(own) == set(jbufs)
    assert bool(own) == (buf_tol is not None)
    for n, b in own.items():
        assert b.dtype == torch.float32
        err = np.linalg.norm(b.numpy() - jbufs[n]) / np.linalg.norm(jbufs[n])
        assert err <= buf_tol, (n, err)
        if n.endswith("_mean"):       # moved off its zero start
            assert float(b.abs().max()) > 0


# ----------------------------------------------------- (f) the O2 input cast
def test_train_step_casts_floating_inputs_under_amp():
    """Under `amp_dtype` the floating model input enters in that dtype
    and integer labels stay as they are (the JAX step's `_amp_in`):
    without the cast an f32 image meets the bf16 conv weight and the
    conv raises."""
    tm = TV.resnet18(num_classes=10, device="cpu")
    seen = []
    tm.register_forward_pre_hook(lambda mod, args: seen.append(args[0].dtype))
    crit = tnn.CrossEntropyLoss()
    labels_seen = []

    def loss_fn(logits, labels):
        labels_seen.append(labels.dtype)
        return crit(logits, labels)

    imgs = np.random.RandomState(1).randn(2, 3, 32, 32).astype(np.float32)
    labels = np.array([1, 7], np.int32)
    for amp, want in ((None, torch.float32), ("bfloat16", torch.bfloat16)):
        step = build_train_step(tm, Momentum(), loss_fn, amp_dtype=amp)
        loss = step(imgs, labels)
        assert seen[-1] == want and labels_seen[-1] == torch.int32
        assert loss.dtype == torch.float32 and torch.isfinite(loss)
