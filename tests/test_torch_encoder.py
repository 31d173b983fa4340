"""The port's encoder family against the JAX package's, on the CPU:
`nn.MultiHeadAttention` (no mask, a 3-D and a 4-D mask, `Cache`,
`StaticCache`), `TransformerEncoderLayer` post-LN and pre-LN,
`TransformerEncoder`, ERNIE (`ernie_tiny`: MLM and NSP logits, the
pretraining criterion with and without NSP labels, padding that does not
leak into real tokens) and ViT, and three train steps of ERNIE and of a
small ViT through each package's `build_train_step` under a learning-rate
scheduler and ``grad_clip_norm=1.0``.

The same seeded numpy inputs go through both packages, and the weights
move from ``functional_state()`` by `load_reference_state` (seeded
perturbations keep LayerNorm scales and biases away from their ones and
zeros).  JAX runs its CPU path: attention is its plain `_sdpa_ref`.
Dropout is 0 (or the models are in eval mode): the two packages' random
streams differ, and `tests/test_torch_dropout.py` holds dropout by its
properties.  Tolerances, f32: forwards and gradients within 1e-5
relative L2; losses of the train steps within 1e-4 relative and the
parameters after them within 1e-4 relative L2 each.  Nothing here
launches a kernel.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu.distributed import fleet, topology
from paddle_tpu.models import ernie as JE
from paddle_tpu.vision.models import vit as JV
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed import build_train_step
from paddle_tpu_torch.models import ernie as TE
from paddle_tpu_torch.models import load_reference_state
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.optimizer import AdamW, lr as tlr
from paddle_tpu_torch.vision.models import vit as TV

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)

REL = 1e-5
WIDTH, HEADS = 32, 4


@pytest.fixture(autouse=True)
def _no_launches():
    K.reset_launches()
    yield
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(x):
    return np.asarray(x._value if hasattr(x, "_value") else x)


def _carry(jm, tm, seed=7, scale=0.1):
    """JAX's weights, each moved off its initial value by a seeded
    perturbation, into both models."""
    params, _ = jm.functional_state()
    rs = np.random.RandomState(seed)
    params = {n: (np.asarray(v) + rs.randn(*np.shape(v)) * scale)
              .astype(np.float32) for n, v in params.items()}
    own = dict(jm.named_parameters())
    for n, v in params.items():
        own[n].set_value(v)
    load_reference_state(tm, params)
    return params


def _grads_close(tm, jgrads):
    """Every parameter's gradient within REL relative L2 of JAX's; one
    that is zero in exact arithmetic (a key projection's bias: softmax
    ignores a shift shared by a row's scores) within 1e-5 of the largest
    gradient, the scale of both packages' f32 noise there."""
    scale = max(float(np.abs(g).max()) for g in jgrads.values())
    for n, p in tm.named_parameters():
        got, want = p.grad.numpy(), jgrads[n]
        assert _rel(got, want) <= REL or \
            np.abs(got - want).max() <= 1e-5 * scale, n


def _x(*shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# --------------------------------------------------- MultiHeadAttention
def _mha_pair(**kw):
    P.seed(0)
    jm = P.nn.MultiHeadAttention(WIDTH, HEADS, **kw)
    tm = tnn.MultiHeadAttention(WIDTH, HEADS, device="cpu", **kw)
    _carry(jm, tm)
    return jm, tm


def _masks():
    rs = np.random.RandomState(3)
    bias3 = np.where(rs.rand(2, 5, 5) < 0.3, -1e4, 0.0).astype(np.float32)
    bias4 = np.where(rs.rand(2, HEADS, 5, 5) < 0.3, -1e4,
                     0.0).astype(np.float32)
    return {"none": None, "3d": bias3, "4d": bias4}


@pytest.mark.parametrize("mask", ["none", "3d", "4d"])
def test_multi_head_attention_matches_jax(mask):
    """Self-attention with no mask, a [B, Sq, Sk] mask (a head axis is
    added, JAX :72-73) and a [B, H, Sq, Sk] mask: output and the
    gradients of every parameter and of the query."""
    jm, tm = _mha_pair()
    m = _masks()[mask]
    x = _x(2, 5, WIDTH, seed=1)
    g = _x(2, 5, WIDTH, seed=2)
    jx = P.to_tensor(x)
    jx.stop_gradient = False
    jmask = None if m is None else P.to_tensor(m)
    out_j = jm(jx, jx, jx, jmask)
    (out_j * P.to_tensor(g)).sum().backward()
    tx = _t(x).requires_grad_()
    out = tm(tx, tx, tx, None if m is None else _t(m))
    (out * _t(g)).sum().backward()
    assert _rel(out.detach().numpy(), _np(out_j)) <= REL
    _grads_close(tm, {n: _np(p.grad) for n, p in jm.named_parameters()})
    assert _rel(tx.grad.numpy(), _np(jx.grad)) <= REL


def test_multi_head_attention_caches_match_jax():
    """`Cache`: two calls grow the cache along S (the cached path is not
    causal); `StaticCache`: cross-attention over projected memory."""
    jm, tm = _mha_pair()
    x1, x2 = _x(2, 3, WIDTH, seed=4), _x(2, 2, WIDTH, seed=5)
    mem = _x(2, 6, WIDTH, seed=6)
    jc = jm.gen_cache(P.to_tensor(x1))
    tc = tm.gen_cache(_t(x1))
    assert tuple(tc.k.shape) == (2, 0, HEADS, WIDTH // HEADS)
    with torch.no_grad():
        for x in (x1, x2):
            oj, jc = jm(P.to_tensor(x), cache=jc)
            ot, tc = tm(_t(x), cache=tc)
            assert _rel(ot.numpy(), _np(oj)) <= REL
        assert tuple(tc.k.shape) == (2, 5, HEADS, WIDTH // HEADS)
        assert _rel(tc.v.numpy(), _np(jc.v)) <= REL
        js = jm.gen_cache(P.to_tensor(mem),
                          type=P.nn.MultiHeadAttention.StaticCache)
        ts = tm.gen_cache(_t(mem), type=tnn.MultiHeadAttention.StaticCache)
        assert isinstance(ts, tnn.MultiHeadAttention.StaticCache)
        oj = jm(P.to_tensor(x2), cache=js)
        ot = tm(_t(x2), cache=ts)
        assert _rel(ot.numpy(), _np(oj)) <= REL


# ----------------------------------------------- the encoder layers
def _encoder_layer(M, normalize_before, **kw):
    return M.TransformerEncoderLayer(WIDTH, HEADS, 64, dropout=0.0,
                                     activation="gelu",
                                     normalize_before=normalize_before,
                                     **kw)


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post_ln", "pre_ln"])
@pytest.mark.parametrize("stack", [False, True], ids=["layer", "encoder"])
def test_encoder_layers_match_jax(normalize_before, stack):
    """`TransformerEncoderLayer` post-LN and pre-LN, alone and as a
    3-layer `TransformerEncoder` with a final norm, in training mode
    (dropout 0) with a [B, 1, 1, S] pad bias: output and every gradient.
    The stack starts from deep copies of one layer in both packages."""
    P.seed(0)
    if stack:
        jm = P.nn.TransformerEncoder(_encoder_layer(P.nn, normalize_before),
                                     3, norm=P.nn.LayerNorm(WIDTH))
        tm = tnn.TransformerEncoder(
            _encoder_layer(tnn, normalize_before, device="cpu"), 3,
            norm=tnn.LayerNorm(WIDTH, device="cpu"))
    else:
        jm = _encoder_layer(P.nn, normalize_before)
        tm = _encoder_layer(tnn, normalize_before, device="cpu")
    assert {n: tuple(p.shape) for n, p in tm.named_parameters()} == \
        {n: tuple(np.shape(v)) for n, v in jm.functional_state()[0].items()}
    _carry(jm, tm)
    jm.train()
    tm.train()
    x = _x(2, 6, WIDTH, seed=8)
    bias = np.zeros((2, 1, 1, 6), np.float32)
    bias[1, ..., 4:] = -1e4
    g = _x(2, 6, WIDTH, seed=9)
    jb = P.to_tensor(bias)
    jb.stop_gradient = True
    jx = P.to_tensor(x)
    jx.stop_gradient = False
    out_j = jm(jx, jb)
    (out_j * P.to_tensor(g)).sum().backward()
    tx = _t(x).requires_grad_()
    out = tm(tx, _t(bias))
    (out * _t(g)).sum().backward()
    assert _rel(out.detach().numpy(), _np(out_j)) <= REL
    _grads_close(tm, {n: np.zeros(tuple(p.shape)) if p.grad is None
                      else _np(p.grad) for n, p in jm.named_parameters()})
    assert _rel(tx.grad.numpy(), _np(jx.grad)) <= REL


# ---------------------------------------------------------------- ERNIE
def _ernie_batch(cfg, B=4, S=32, seed=0):
    """JAX tests/test_models.py:630: ids with 4 pad positions at the
    end, MLM labels on positions 2-5 (-100 elsewhere), NSP labels."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, cfg.vocab_size, (B, S)).astype(np.int32)
    ids[:, -4:] = cfg.pad_token_id
    labels = np.full((B, S), -100, np.int64)
    labels[:, 2:6] = rs.randint(1, cfg.vocab_size, (B, 4))
    nsp = rs.randint(0, 2, (B,)).astype(np.int64)
    return ids, labels, nsp


def _ernie_pair(**kw):
    cfg_kw = dict(dropout=0.0, **kw)
    P.seed(1)
    jm = JE.ErnieForPretraining(JE.ernie_tiny(**cfg_kw))
    tm = TE.ErnieForPretraining(TE.ernie_tiny(**cfg_kw), device="cpu")
    params = _carry(jm, tm, scale=0.05)
    return jm, tm, params


def test_ernie_tiny_matches_jax():
    """MLM logits [B, S, V] (the decoder tied to the word embeddings),
    NSP logits, the pooled output, and the criterion with and without
    NSP labels, in eval mode."""
    jm, tm, _ = _ernie_pair()
    jm.eval()
    ids, labels, nsp = _ernie_batch(tm.cfg)
    lj, nj = jm(P.to_tensor(ids, "int32"))
    with torch.no_grad():
        lt, nt = tm(_t(ids))
        _, pooled = tm.ernie(_t(ids))
    _, pj = jm.ernie(P.to_tensor(ids, "int32"))
    assert lt.shape == (4, 32, tm.cfg.vocab_size) and nt.shape == (4, 2)
    assert _rel(lt.numpy(), _np(lj)) <= REL
    assert _rel(nt.numpy(), _np(nj)) <= REL
    assert _rel(pooled.numpy(), _np(pj)) <= REL
    jc, tc = JE.ErniePretrainingCriterion(), TE.ErniePretrainingCriterion()
    for args in ((labels, nsp), (labels,)):
        want = float(_np(jc(lj, nj, *(P.to_tensor(a) for a in args))))
        got = float(tc(lt, nt, *(_t(a) for a in args)))
        np.testing.assert_allclose(got, want, rtol=REL)
    assert float(tc(lt, nt, _t(labels))) < float(tc(lt, nt, _t(labels),
                                                     _t(nsp)))


def test_ernie_padding_tokens_do_not_leak():
    """JAX tests/test_models.py:672: changing a padding token's id
    changes no real token's logits (the pad bias masks it as a key),
    and the port's logits equal JAX's on both batches."""
    jm, tm, _ = _ernie_pair()
    jm.eval()
    ids, _, _ = _ernie_batch(tm.cfg, seed=2)
    mask = (ids != tm.cfg.pad_token_id).astype(np.float32)
    ids2 = ids.copy()
    ids2[0, -1] = 7
    with torch.no_grad():
        l1, _ = tm(_t(ids), attention_mask=_t(mask))
        l2, _ = tm(_t(ids2), attention_mask=_t(mask))
    real = np.s_[:, :-4]
    np.testing.assert_allclose(l1.numpy()[real], l2.numpy()[real],
                               atol=1e-4)
    assert not np.allclose(l1.numpy()[0, -1], l2.numpy()[0, -1])
    for a, b in ((ids, l1), (ids2, l2)):
        lj, _ = jm(P.to_tensor(a, "int32"), attention_mask=P.to_tensor(mask))
        assert _rel(b.numpy(), _np(lj)) <= REL


def test_ernie_builds_in_eval_mode_with_the_jax_names():
    tm = TE.ErnieForPretraining(TE.ernie_tiny(num_layers=1), device="cpu")
    assert not tm.training and not any(m.training for m in tm.modules())
    P.seed(0)
    jm = JE.ErnieForPretraining(JE.ernie_tiny(num_layers=1))
    assert {n: tuple(p.shape) for n, p in tm.named_parameters()} == \
        {n: tuple(np.shape(v)) for n, v in jm.functional_state()[0].items()}
    # the decoder is tied: one parameter for the gather and the logits
    names = [n for n, _ in tm.named_parameters()]
    assert "ernie.embeddings.word_embeddings.weight" in names
    assert not any("decoder" in n for n in names)
    assert TE.ernie_base().vocab_size == 40000
    assert TE.ernie_3_0_medium().num_layers == 6
    assert TE.ernie_base().dropout == 0.1


# ------------------------------------------------------------------ ViT
VIT = dict(img_size=32, patch_size=8, embed_dim=WIDTH, depth=2,
           num_heads=HEADS, num_classes=10)


def _vit_pair():
    P.seed(2)
    jm = JV.VisionTransformer(**VIT)
    tm = TV.VisionTransformer(**VIT, device="cpu")
    _carry(jm, tm, scale=0.05)
    return jm, tm


def test_vit_matches_jax():
    """img 32, patch 8: 16 patches and the class token, S = 17 (odd, the
    native flash tier on the card); logits and every gradient in
    training mode (dropout 0)."""
    jm, tm = _vit_pair()
    assert {n: tuple(p.shape) for n, p in tm.named_parameters()} == \
        {n: tuple(np.shape(v)) for n, v in jm.functional_state()[0].items()}
    jm.train()
    tm.train()
    x = _x(3, 3, 32, 32, seed=11)
    g = _x(3, 10, seed=12)
    out_j = jm(P.to_tensor(x))
    (out_j * P.to_tensor(g)).sum().backward()
    out = tm(_t(x))
    (out * _t(g)).sum().backward()
    assert _rel(out.detach().numpy(), _np(out_j)) <= REL
    _grads_close(tm, {n: _np(p.grad) for n, p in jm.named_parameters()})


def test_vit_presets_and_initialiser(monkeypatch):
    tm = TV.VisionTransformer(depth=1, device="cpu")        # B/16 widths
    assert tm.pos_embed.shape == (1, 197, 768)
    assert tm.patch_embed.proj.weight.shape == (768, 3, 16, 16)
    assert not tm.training
    # U(+-1/sqrt(fan_in)), fan_in = 197 * 768 and 768 (JAX's default)
    pos, cls = tm.pos_embed.detach(), tm.cls_token.detach()
    assert float(pos.abs().max()) <= 1 / np.sqrt(197 * 768)
    assert float(cls.abs().max()) <= 1 / np.sqrt(768)
    # each preset builds what JAX's builds (the constructors recorded)
    made = {"t": [], "j": []}
    monkeypatch.setattr(TV, "VisionTransformer",
                        lambda **kw: made["t"].append(kw))
    monkeypatch.setattr(JV, "VisionTransformer",
                        lambda **kw: made["j"].append(kw))
    for name in ("vit_b_16", "vit_b_32", "vit_l_16", "vit_l_32", "vit_h_14"):
        getattr(TV, name)(num_classes=7)
        getattr(JV, name)(num_classes=7)
    assert made["t"] == made["j"] and len(made["t"]) == 5


# ------------------------------------------------- train steps vs JAX
class _JErnieLoss(P.nn.Layer):
    """The model that returns its own loss (the JAX step's
    ``loss_fn=None``)."""

    def __init__(self, model):
        super().__init__()
        self.model = model
        self.crit = JE.ErniePretrainingCriterion()

    def forward(self, ids, labels, nsp):
        logits, nsp_logits = self.model(ids)
        return self.crit(logits, nsp_logits, labels, nsp)


class _TErnieLoss(torch.nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model
        self.crit = TE.ErniePretrainingCriterion()

    def forward(self, ids, labels, nsp):
        logits, nsp_logits = self.model(ids)
        return self.crit(logits, nsp_logits, labels, nsp)


def _schedule(L):
    """LinearWarmup over PolynomialDecay (ERNIE's recipe), 2 warm-up
    steps."""
    return L.LinearWarmup(L.PolynomialDecay(3e-3, decay_steps=10,
                                            end_lr=1e-4),
                          warmup_steps=2, start_lr=0.0, end_lr=3e-3)


def _jax_run(jm, loss_fn, batch, steps, **kw):
    """`steps` steps of the JAX `build_train_step` (single device) with
    AdamW under `_schedule` through `run_steps(repeat=)`; the losses and
    the parameters after them."""
    topology.reset_topology()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1, "sep_degree": 1,
                               "sharding_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    try:
        model = fleet.distributed_model(jm)
        opt = fleet.distributed_optimizer(P.optimizer.AdamW(
            parameters=model.parameters(),
            learning_rate=_schedule(P.optimizer.lr)))
        step = model.build_train_step(opt, loss_fn, **kw)
        losses = _np(step.run_steps(*batch, repeat=steps))
        step.sync_to_model()
    finally:
        topology.reset_topology()
    return losses, {n: _np(p) for n, p in jm.named_parameters()}


def _hold_trajectory(tm, loss_fn, batch, steps, jl, jp):
    """The port's `steps` steps against JAX's losses `jl` and parameters
    `jp`.  A key projection's bias (ViT: the middle third of `qkv.bias`)
    has a gradient that is zero in exact arithmetic, whose f32 noise Adam
    scales to a full step in either package: it is held within twice the
    summed rates, the other parameters within 1e-4 relative L2."""
    probe, rates = _schedule(tlr), []
    for _ in range(steps):
        rates.append(probe())
        probe.step()
    sched = _schedule(tlr)
    step = build_train_step(tm, AdamW(learning_rate=sched), loss_fn,
                            grad_clip_norm=1.0)
    tl = step.run_steps(*batch, repeat=steps).numpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=0)
    assert sched.last_epoch == steps       # stepped once a step, as JAX
    for n, p in tm.named_parameters():
        got, want = p.detach().numpy(), jp[n]
        noise = np.zeros(got.shape, bool)
        if n.endswith("k_proj.bias"):
            noise[:] = True
        elif n.endswith("qkv.bias"):
            third = got.shape[0] // 3
            noise[third:2 * third] = True
        assert _rel(got[~noise], want[~noise]) <= 1e-4, n
        assert np.abs(got[noise] - want[noise]).max(initial=0.0) <= \
            2 * sum(rates), n
    return tl


def test_ernie_train_steps_match_jax():
    """Three steps of `ernie_tiny` (dropout 0) through `loss_fn=None` on
    a model that returns the pretraining criterion: AdamW under
    LinearWarmup(PolynomialDecay), ``grad_clip_norm=1.0`` (the gradient
    norm here is well above 1, so every step clips)."""
    jm, tm, _ = _ernie_pair()
    ids, labels, nsp = _ernie_batch(tm.cfg)
    jw = _JErnieLoss(jm)
    jl, jp = _jax_run(jw, None, (P.to_tensor(ids, "int32"),
                                 P.to_tensor(labels), P.to_tensor(nsp)),
                      3, grad_clip_norm=1.0)
    tl = _hold_trajectory(_TErnieLoss(tm), None, (ids, labels, nsp), 3,
                          jl, jp)
    assert tl[-1] < tl[0]


def test_vit_train_steps_match_jax():
    """Three steps of the small ViT (S = 17) with CrossEntropyLoss,
    AdamW under the same schedule and ``grad_clip_norm=1.0``."""
    jm, tm = _vit_pair()
    rs = np.random.RandomState(13)
    x = rs.randn(4, 3, 32, 32).astype(np.float32)
    y = rs.randint(0, 10, (4,)).astype(np.int64)
    jl, jp = _jax_run(jm, P.nn.CrossEntropyLoss(),
                      (P.to_tensor(x), P.to_tensor(y)), 3,
                      grad_clip_norm=1.0)
    tl = _hold_trajectory(tm, tnn.CrossEntropyLoss(), (x, y), 3, jl, jp)
    assert tl[-1] < tl[0]


def test_train_step_clips_by_the_global_norm():
    """The clip itself: one step with a clip far below the gradient norm
    equals a step on the gradients scaled by clip / norm (plain SGD
    momentum 0 makes the update the gradient times the rate)."""
    from paddle_tpu_torch.optimizer import Momentum

    def model():
        torch.manual_seed(0)
        return torch.nn.Sequential(torch.nn.Linear(4, 3))

    x = torch.randn(5, 4, generator=torch.Generator().manual_seed(1))
    target = torch.randn(5, 3, generator=torch.Generator().manual_seed(2))

    class MSE(torch.nn.Module):
        def forward(self, out, label):
            return (out - label).square().mean()

    ref = model()
    loss = MSE()(ref(x), target)
    grads = torch.autograd.grad(loss, list(ref.parameters()))
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    clipped = model()
    step = build_train_step(clipped, Momentum(learning_rate=0.5,
                                              momentum=0.0), MSE(),
                            grad_clip_norm=1e-3)
    before = [p.detach().clone() for p in clipped.parameters()]
    step(x, target)
    for p0, p, g in zip(before, clipped.parameters(), grads):
        want = p0 - 0.5 * g * (1e-3 / norm)
        assert torch.allclose(p.detach(), want, rtol=0, atol=1e-7)
