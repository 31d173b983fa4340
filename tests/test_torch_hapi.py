"""`paddle_tpu_torch.hapi` and `metric` against the JAX package's, on the
CPU in float32.

The same seeded numpy data and the same weights (the JAX model's state
carried into the port's) go through `Model.fit` / `evaluate` /
`predict` of both packages: per-step losses within 1e-5 (f32, a few
Adam / AdamW steps), with `accumulate_grad_batches` and `num_iters`; a
small MLP and `gpt_tiny`.  The shuffled loaders draw from numpy's
global generator in both, so one seed gives both the same batches.
`amp_configs` O1 / O2 run in bf16 on both sides: losses within 3e-2
(bf16 rounds at other places in the two frameworks), the O2 network
cast and given master weights.  The four metrics and the functional
`accuracy` equal JAX's on the same scores; the callbacks (a copy of the
JAX module) take JAX's decisions on the same losses through each
package's optimizer and `Model`; `summary` / `flops` count what JAX
counts.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.hapi.callbacks as JC
import paddle_tpu.io as JIO
import paddle_tpu.metric as JM
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT

import paddle_tpu_torch as PT
import paddle_tpu_torch.hapi.callbacks as TC
import paddle_tpu_torch.io as TIO
import paddle_tpu_torch.metric as TM
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn.layers_common import Linear as TLinear
from paddle_tpu_torch.nn.layers_conv_pool import Conv2D as TConv2D

torch.set_num_threads(1)


# ------------------------------------------------------------ fixtures
def _mlp_pair(seed=0):
    P.seed(seed)
    jnet = P.nn.Sequential(P.nn.Linear(6, 16), P.nn.ReLU(),
                           P.nn.Linear(16, 4))
    tnet = torch.nn.Sequential(TLinear(6, 16, device="cpu"),
                               torch.nn.ReLU(),
                               TLinear(16, 4, device="cpu"))
    tnet.load_state_dict({k: torch.from_numpy(np.asarray(v._value))
                          for k, v in jnet.state_dict().items()})
    return jnet, tnet


def _mlp_data(n=20, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 6).astype(np.float32),
            rs.randint(0, 4, (n,)).astype(np.int64))


class _Losses:
    """Per-step train losses, as either package's callback."""

    def __init__(self):
        self.losses, self.lrs = [], []

    def attach(self, base):
        rec = self

        class Rec(base):
            def on_train_batch_end(self, step, logs=None):
                rec.losses.append(logs["loss"][0])
                rec.lrs.append(self.model._optimizer.get_lr())

        return Rec()


def _fit_both(jnet, tnet, x, y, *, jopt, topt_, amp=None, metrics=True,
              seed=0, **fit_kw):
    jm = P.Model(jnet)
    jm.prepare(jopt(jnet.parameters()), P.nn.CrossEntropyLoss(),
               JM.Accuracy(topk=(1, 2)) if metrics else None,
               amp_configs=amp)
    tm = PT.Model(tnet)
    tm.prepare(topt_(tnet.parameters()), tnn.CrossEntropyLoss(),
               TM.Accuracy(topk=(1, 2)) if metrics else None,
               amp_configs=amp)
    jl, tl = _Losses(), _Losses()
    np.random.seed(seed)
    jm.fit(JIO.TensorDataset([x, y]), callbacks=[jl.attach(JC.Callback)],
           **fit_kw)
    np.random.seed(seed)
    tm.fit(TIO.TensorDataset([x, y]), callbacks=[tl.attach(TC.Callback)],
           **fit_kw)
    assert len(jl.losses) == len(tl.losses) > 0
    return jm, tm, jl, tl


def _adam(lib):
    return lambda params: lib.Adam(learning_rate=1e-2, parameters=params)


def _sgd(lib):
    return lambda params: lib.SGD(learning_rate=0.1, parameters=params)


# ------------------------------------------------------------ the loops
# Adam turns a gradient near 0 into a step of ~lr whose sign is the
# gradient's rounding noise; summed micro-batch gradients meet that, so
# the accumulation case steps with SGD, whose update is linear in them
@pytest.mark.parametrize("opt,kw", [
    (_adam, dict(batch_size=4, epochs=2)),
    (_adam, dict(batch_size=4, epochs=2, shuffle=False)),
    (_sgd, dict(batch_size=4, epochs=1, accumulate_grad_batches=2)),
    (_adam, dict(batch_size=3, epochs=3, num_iters=5)),
])
def test_mlp_fit_evaluate_predict_match_jax(opt, kw):
    jnet, tnet = _mlp_pair()
    x, y = _mlp_data()
    jm, tm, jl, tl = _fit_both(jnet, tnet, x, y, jopt=opt(P.optimizer),
                               topt_=opt(topt), **kw)
    np.testing.assert_allclose(tl.losses, jl.losses, atol=1e-5, rtol=0)
    if "num_iters" in kw:
        assert len(tl.losses) == kw["num_iters"]
    je = jm.evaluate(JIO.TensorDataset([x, y]), batch_size=6)
    te = tm.evaluate(TIO.TensorDataset([x, y]), batch_size=6)
    assert set(je) == set(te) == {"loss", "acc"}
    np.testing.assert_allclose(te["loss"], je["loss"], atol=1e-5, rtol=0)
    assert te["acc"] == je["acc"]
    jp = jm.predict(JIO.TensorDataset([x, y]), batch_size=6,
                    stack_outputs=True)
    tp = tm.predict(TIO.TensorDataset([x, y]), batch_size=6,
                    stack_outputs=True)
    assert len(tp) == len(jp) == 1 and tp[0].shape == (20, 4)
    np.testing.assert_allclose(tp[0], np.asarray(jp[0]), atol=1e-5, rtol=0)


def test_single_batch_calls_take_numpy_and_match_jax():
    jnet, tnet = _mlp_pair(1)
    x, y = _mlp_data(8, 1)
    jm = P.Model(jnet)
    jm.prepare(_adam(P.optimizer)(jnet.parameters()),
               P.nn.CrossEntropyLoss(), JM.Accuracy())
    tm = PT.Model(tnet)
    tm.prepare(_adam(topt)(tnet.parameters()), tnn.CrossEntropyLoss(),
               TM.Accuracy())
    for _ in range(3):
        jl, jmet = jm.train_batch([P.to_tensor(x)], [P.to_tensor(y)])
        tl, tmet = tm.train_batch([x], [y])
        np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
        assert tmet == jmet
    (jl,), _ = jm.eval_batch([P.to_tensor(x)], [P.to_tensor(y)])
    (tl,), _ = tm.eval_batch([x], [y])
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tm.predict_batch([x])[0],
                               np.asarray(jm.predict_batch(
                                   [P.to_tensor(x)])[0]), atol=1e-5)
    assert tm.summary()["total_params"] == jm.summary()["total_params"]


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_amp_configs_run_bf16_like_jax(level):
    jnet, tnet = _mlp_pair(2)
    x, y = _mlp_data(16, 2)
    amp = {"level": level, "dtype": "bfloat16"}
    jm, tm, jl, tl = _fit_both(jnet, tnet, x, y, jopt=_adam(P.optimizer),
                               topt_=_adam(topt), amp=amp, batch_size=4,
                               epochs=1, metrics=False)
    np.testing.assert_allclose(tl.losses, jl.losses, atol=3e-2, rtol=0)
    dtypes = {p.dtype for p in tm.network.parameters()}
    if level == "O2":
        assert dtypes == {torch.bfloat16}
        assert tm._optimizer._multi_precision
    else:
        assert dtypes == {torch.float32}


def _gpt_pair(cfg, seed=0):
    P.seed(seed)
    jm = JGPT(JGPTConfig(**cfg))
    tm = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    tm.load_state_dict({k: torch.from_numpy(np.asarray(v._value))
                        for k, v in jm.state_dict().items()})
    return jm, tm


def test_gpt_tiny_fit_matches_jax():
    cfg = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
               max_seq_len=64)
    jnet, tnet = _gpt_pair(cfg)
    toks = np.random.RandomState(3).randint(0, 128, (6, 17)).astype(
        np.int64)
    x, y = toks[:, :-1], toks[:, 1:]

    def adamw(lib):
        return lambda params: lib.AdamW(learning_rate=1e-3,
                                        parameters=params)

    jm, tm, jl, tl = _fit_both(jnet, tnet, x, y, jopt=adamw(P.optimizer),
                               topt_=adamw(topt), metrics=False,
                               batch_size=2, epochs=1, shuffle=False)
    assert len(tl.losses) == 3
    np.testing.assert_allclose(tl.losses, jl.losses, atol=1e-5, rtol=0)
    je = jm.evaluate(JIO.TensorDataset([x, y]), batch_size=3)
    te = tm.evaluate(TIO.TensorDataset([x, y]), batch_size=3)
    np.testing.assert_allclose(te["loss"], je["loss"], atol=1e-5, rtol=0)


def test_model_save_load_round_trip_and_cross_package(tmp_path):
    jnet, tnet = _mlp_pair(4)
    x, y = _mlp_data(12, 4)
    tm = PT.Model(tnet)
    tm.prepare(_adam(topt)(tnet.parameters()), tnn.CrossEntropyLoss(),
               TM.Accuracy())
    tm.fit(TIO.TensorDataset([x, y]), batch_size=4, epochs=1,
           shuffle=False, verbose=0)
    path = str(tmp_path / "ckpt" / "final")
    tm.save(path)
    assert os.path.exists(path + ".pdparams") and \
        os.path.exists(path + ".pdopt")
    want = tm.evaluate(TIO.TensorDataset([x, y]), batch_size=4)
    _, fresh = _mlp_pair(9)
    tm2 = PT.Model(fresh)
    tm2.prepare(_adam(topt)(fresh.parameters()), tnn.CrossEntropyLoss(),
                TM.Accuracy())
    tm2.load(path)
    assert tm2.evaluate(TIO.TensorDataset([x, y]), batch_size=4) == want
    assert tm2._optimizer.state_dict()["@step"] == \
        tm._optimizer.state_dict()["@step"]
    for a, b in zip(tm.network.parameters(), tm2.network.parameters()):
        assert torch.equal(a, b)
    # the JAX Model reads the port's parameters
    jm = P.Model(jnet)
    jm.load(path, reset_optimizer=True)
    for name, t in tm.network.state_dict().items():
        assert np.array_equal(np.asarray(jnet.state_dict()[name]._value),
                              t.numpy()), name


# ------------------------------------------------------------ metrics
def _scores(seed, n=64, c=5):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, c).astype(np.float32), rs.randint(0, c, (n,)),
            rs.rand(n).astype(np.float32), rs.randint(0, 2, (n,)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    logits, labels, probs, binary = _scores(seed)
    for topk in ((1,), (1, 3)):
        ja, ta = JM.Accuracy(topk=topk), TM.Accuracy(topk=topk)
        for lo in (0, 32):
            sl = slice(lo, lo + 32)
            jr = ja.update(ja.compute(P.to_tensor(logits[sl]),
                                      P.to_tensor(labels[sl])))
            tr = ta.update(ta.compute(torch.from_numpy(logits[sl]),
                                      torch.from_numpy(labels[sl])))
            assert tr == pytest.approx(jr, abs=1e-12)
        assert ta.accumulate() == pytest.approx(ja.accumulate(), abs=1e-12)
    for jcls, tcls in ((JM.Precision, TM.Precision), (JM.Recall, TM.Recall),
                       (JM.Auc, TM.Auc)):
        jm_, tm_ = jcls(), tcls()
        for lo in (0, 32):
            sl = slice(lo, lo + 32)
            jm_.update(P.to_tensor(probs[sl]), P.to_tensor(binary[sl]))
            tm_.update(torch.from_numpy(probs[sl]),
                       torch.from_numpy(binary[sl]))
        assert tm_.accumulate() == pytest.approx(jm_.accumulate(),
                                                 abs=1e-12)
        assert tm_.name() == jm_.name()
    two = np.stack([1 - probs, probs], 1)
    ja, ta = JM.Auc(), TM.Auc()
    ja.update(P.to_tensor(two), P.to_tensor(binary))
    ta.update(torch.from_numpy(two), torch.from_numpy(binary))
    assert ta.accumulate() == pytest.approx(ja.accumulate(), abs=1e-12)
    for k in (1, 2):
        j = float(JM.accuracy(P.to_tensor(logits), P.to_tensor(labels),
                              k=k))
        t = TM.accuracy(torch.from_numpy(logits), torch.from_numpy(labels),
                        k=k)
        assert t.dtype == torch.float32 and float(t) == pytest.approx(j)


def test_accuracy_reads_the_last_axis_of_any_rank():
    """[B, S, V] logits against [B, S] labels: the rows of the flattened
    batch, as a language model's accuracy counts tokens."""
    rs = np.random.RandomState(5)
    logits = rs.randn(2, 7, 11).astype(np.float32)
    labels = rs.randint(0, 11, (2, 7))
    acc = TM.Accuracy()
    c = acc.compute(torch.from_numpy(logits), torch.from_numpy(labels))
    assert c.shape == (14, 1)
    want = (logits.argmax(-1) == labels).mean()
    assert acc.update(c) == pytest.approx(want)


# ------------------------------------------------------------ callbacks
class _Stub:
    def __init__(self, opt):
        self._optimizer = opt
        self.stop_training = False


@pytest.mark.parametrize("mode", ["early_stopping", "plateau"])
def test_monitor_callbacks_take_jax_decisions(mode):
    losses = [1.0, 0.9, 0.95, 0.97, 0.8, 0.85, 0.86, 0.9, 0.91, 0.92]
    trace = []
    for cb_mod, opt_mod, params in (
            (JC, P.optimizer, P.nn.Linear(2, 2).parameters()),
            (TC, topt, [torch.nn.Parameter(torch.zeros(2))])):
        model = _Stub(opt_mod.SGD(learning_rate=0.1, parameters=params))
        cb = cb_mod.EarlyStopping(patience=2) if mode == "early_stopping" \
            else cb_mod.ReduceLROnPlateau(patience=1, factor=0.5,
                                          cooldown=1, verbose=0)
        cb.set_model(model)
        mine = []
        for loss in losses:
            cb.on_eval_end({"loss": [loss]})
            mine.append((model.stop_training, model._optimizer.get_lr()))
        trace.append(mine)
    assert trace[0] == trace[1]
    assert any(s for s, _ in trace[1]) or len({lr for _, lr in trace[1]}) > 1


def test_lr_scheduler_and_checkpoint_callbacks_match_jax(tmp_path):
    jnet, tnet = _mlp_pair(6)
    x, y = _mlp_data(12, 6)

    def sched(lib, params):
        return lib.SGD(learning_rate=lib.lr.StepDecay(0.1, step_size=2),
                       parameters=params)

    rec = []
    for pkg, net, cb_mod, io, opt_mod, model_cls, ce in (
            ("jax", jnet, JC, JIO, P.optimizer, P.Model, P.nn.CrossEntropyLoss),
            ("port", tnet, TC, TIO, topt, PT.Model, tnn.CrossEntropyLoss)):
        losses = _Losses()
        m = model_cls(net)
        m.prepare(sched(opt_mod, net.parameters()), ce())
        save_dir = str(tmp_path / pkg)
        m.fit(io.TensorDataset([x, y]), batch_size=4, epochs=2,
              shuffle=False,
              callbacks=[cb_mod.LRScheduler(by_step=True),
                         cb_mod.ModelCheckpoint(save_dir=save_dir),
                         losses.attach(cb_mod.Callback)])
        assert sorted(os.listdir(save_dir)) == [
            "0.pdopt", "0.pdparams", "1.pdopt", "1.pdparams"]
        rec.append(losses)
    assert rec[0].lrs == rec[1].lrs and len(set(rec[1].lrs)) > 1
    np.testing.assert_allclose(rec[1].losses, rec[0].losses, atol=1e-5)
    jstate = P.load(str(tmp_path / "jax" / "1.pdparams"))
    tstate = PT.load(str(tmp_path / "port" / "1.pdparams"), device="cpu")
    for k, v in tstate.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate[k]._value),
                                   atol=1e-5)


# ------------------------------------------------------------ summary
def test_summary_and_flops_count_what_jax_counts(capsys):
    jnet, tnet = _mlp_pair(7)
    assert PT.summary(tnet, (1, 6)) == P.summary(jnet, (1, 6))
    assert PT.flops(tnet, [3, 6]) == P.flops(jnet, [3, 6])
    P.seed(0)
    jconv = P.nn.Sequential(P.nn.Conv2D(3, 8, 3, padding=1), P.nn.ReLU(),
                            P.nn.Conv2D(8, 4, 3, stride=2, groups=4),
                            P.nn.Flatten(), P.nn.Linear(4 * 3 * 3, 5))
    tconv = torch.nn.Sequential(TConv2D(3, 8, 3, padding=1, device="cpu"),
                                torch.nn.ReLU(),
                                TConv2D(8, 4, 3, stride=2, groups=4,
                                        device="cpu"),
                                torch.nn.Flatten(),
                                TLinear(4 * 3 * 3, 5, device="cpu"))
    assert PT.summary(tconv, (1, 3, 8, 8)) == P.summary(jconv, (1, 3, 8, 8))
    assert PT.flops(tconv, [2, 3, 8, 8], print_detail=True) == \
        P.flops(jconv, [2, 3, 8, 8])
    out = capsys.readouterr().out
    assert "Total params" in out and "Total FLOPs (MACs)" in out
