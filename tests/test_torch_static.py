"""The port's static programs (`paddle_tpu_torch.static`) against the JAX
package's (`paddle_tpu.static`) on the CPU.

The same Program is built in both packages on the same seeded numpy
inputs, the port's weights carried from the JAX layers
(`load_reference_state`), and `Executor.run` of each agrees within the
f32 tolerance 1e-5 of the largest output: `Linear` + softmax on a
declared ``[-1, 4]`` (batches 2 and 8), `gpt_tiny` on a declared
``[2, 16]``, a narrow conv + BN + ReLU net (composed, and through the
vision models' fused `conv_bn_act`) and the `static.nn` builders.  The
port's program equals the port's eager forward bit for bit.  Also held
here: the Variable properties, `program_guard` isolation (per thread),
the prune and the missing-feed KeyError, the ``[-1, 16]`` `gpt_tiny`
pinned against JAX's TypeError (ROADMAP C2.31), the recorded op
boundary (``paddle_tpu_torch::flash_fwd`` / ``::conv_bn_act``), the
static file API, and bfloat16 fetches as uint16 words (C2.32).
"""
from __future__ import annotations

import os
import threading
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import static as JS
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.vision.models import _fused as JF

import paddle_tpu_torch as PT
from paddle_tpu_torch import nn as TN
from paddle_tpu_torch import static
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.models.gpt import load_reference_state
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.vision.models import _fused as TF

torch.set_num_threads(1)

F32_TOL = 1e-5
GPT = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=64)


@pytest.fixture(autouse=True)
def _fresh_programs():
    static.reset_default_programs()
    JS.reset_default_programs()
    yield
    # a failure must not leave static mode on for later tests
    PT.disable_static()
    P.disable_static()
    static.reset_default_programs()
    JS.reset_default_programs()


def _close(got, want, tol=F32_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def _jax_run(build, feed, fetch_names=None):
    """Record `build(static)` (returns the fetch Variable) in the JAX
    package and run it on `feed` in one Executor."""
    P.enable_static()
    try:
        out = build()
        exe = JS.Executor()
        return [exe.run(feed=f, fetch_list=[out])[0] for f in feed]
    finally:
        P.disable_static()


def _port_run(build, feed):
    PT.enable_static()
    try:
        out = build()
        exe = static.Executor("cpu")
        return [exe.run(feed=f, fetch_list=[out])[0] for f in feed]
    finally:
        PT.disable_static()


def test_linear_softmax_program_matches_jax():
    P.seed(0)
    jlin = P.nn.Linear(4, 3)
    tlin = TN.Linear(4, 3, device="cpu")
    load_reference_state(tlin, *jlin.functional_state())
    rs = np.random.RandomState(0)
    feeds = [{"x": rs.rand(b, 4).astype(np.float32)} for b in (2, 8)]
    want = _jax_run(lambda: P.nn.functional.softmax(
        jlin(JS.data("x", [-1, 4], "float32"))), feeds)
    got = _port_run(lambda: torch.softmax(
        tlin(static.data("x", [-1, 4], "float32")), -1), feeds)
    for g, w, f in zip(got, want, feeds):
        _close(g, w)
        with torch.no_grad():
            eager = torch.softmax(tlin(torch.from_numpy(f["x"])), -1)
        assert np.array_equal(g, eager.numpy())


def _gpt_pair():
    P.seed(0)
    jm = JGPT(JGPTConfig(**GPT))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**GPT), device="cpu")
    load_reference_state(tm, *jm.functional_state())
    ids = np.random.RandomState(1).randint(0, 128, (2, 16)).astype(np.int64)
    return jm, tm, ids


def test_gpt_tiny_program_matches_jax_and_eager():
    jm, tm, ids = _gpt_pair()
    feeds = [{"ids": ids}]
    want = _jax_run(lambda: jm(JS.data("ids", [2, 16], "int64")), feeds)
    K.reset_launches()
    got = _port_run(lambda: tm(static.data("ids", [2, 16], "int64")), feeds)
    _close(got[0], want[0])
    with torch.no_grad():
        eager = tm(torch.from_numpy(ids)).numpy()
    assert np.array_equal(got[0], eager)
    # recorded at the op boundary, replayed through the op's CPU version:
    # nothing launched, nothing counted
    names = [op.name for op in static.default_main_program().ops]
    assert names.count("flash_fwd.default") == GPT["num_layers"]
    assert K.launch_counts() == {k: 0 for k in K.KERNELS}


class _JNet(P.nn.Layer):
    def __init__(self):
        super().__init__()
        self.conv = P.nn.Conv2D(3, 8, 3, padding=1)
        self.bn = P.nn.BatchNorm2D(8)


class _TNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = TN.Conv2D(3, 8, 3, padding=1, device="cpu")
        self.bn = TN.BatchNorm2D(8, device="cpu")


@pytest.mark.parametrize("route", ["composed", "fused"])
def test_conv_bn_relu_net_matches_jax(route):
    P.seed(0)
    jnet, tnet = _JNet(), _TNet()
    jnet.eval()
    tnet.eval()
    rs = np.random.RandomState(2)
    for name, b in jnet.named_buffers():
        b.set_value((rs.uniform(0.5, 2.0, b.shape) if "var" in name
                     else rs.normal(0, 0.1, b.shape)).astype(np.float32))
    load_reference_state(tnet, *jnet.functional_state())
    feeds = [{"img": rs.randn(2, 3, 8, 8).astype(np.float32)}]
    if route == "composed":
        jb = lambda x: P.nn.functional.relu(jnet.bn(jnet.conv(x)))  # noqa
        tb = lambda x: TN.functional.relu(tnet.bn(tnet.conv(x)))  # noqa
    else:
        jb = lambda x: JF.conv_bn_act(x, jnet.conv, jnet.bn, "relu")  # noqa
        tb = lambda x: TF.conv_bn_act(x, tnet.conv, tnet.bn, "relu")  # noqa
    want = _jax_run(lambda: jb(JS.data("img", [-1, 3, 8, 8], "float32")),
                    feeds)
    got = _port_run(lambda: tb(static.data("img", [-1, 3, 8, 8],
                                           "float32")), feeds)
    _close(got[0], want[0])
    ops = {op.name for op in static.default_main_program().ops}
    assert ("conv_bn_act.default" in ops) == (route == "fused")
    with torch.no_grad():
        eager = tb(torch.from_numpy(feeds[0]["img"])).numpy()
    assert np.array_equal(got[0], eager)


def _builders(S, Fn, bn_layer, **dev):
    """One program of the static.nn builders (`S` a static module, `Fn`
    the package's relu, `bn_layer` an eval-mode BatchNorm2D(4) call):
    returns the fetch."""
    ids = S.data("ids", [2, 6], "int64")
    img = S.data("img", [2, 3, 8, 8], "float32")
    h = S.nn.embedding(ids, [32, 8], **dev)
    h = S.nn.layer_norm(h, begin_norm_axis=2, **dev)
    h = S.nn.fc(h, 5, num_flatten_dims=2, activation="relu", **dev)
    c = S.nn.conv2d(img, 4, 3, padding=1, **dev)
    c = Fn(bn_layer(c))
    c = S.nn.fc(c, 5, **dev)
    return h.sum(axis=1) + c if S is JS else h.sum(1) + c


def test_static_nn_builders_match_jax():
    """fc, embedding, layer_norm, conv2d in both packages (the JAX
    builders' parameters carried into the port's by order), with an
    eval-mode batch norm layer: the JAX `batch_norm` builder cannot
    record (below)."""
    P.seed(0)
    rs = np.random.RandomState(3)
    feed = {"ids": rs.randint(0, 32, (2, 6)).astype(np.int64),
            "img": rs.randn(2, 3, 8, 8).astype(np.float32)}
    jbn = P.nn.BatchNorm2D(4)
    jbn.eval()
    P.enable_static()
    try:
        jout = _builders(JS, P.nn.functional.relu, jbn)
        (want,) = JS.Executor().run(feed=feed, fetch_list=[jout])
        # the port folds the eval-mode norm's reshaped weight and bias
        # at record time (calls on eager tensors run at once): they are
        # constants of its program, not parameters
        jparams = [np.asarray(p._value) for p in
                   JS.default_main_program().all_parameters()
                   if p is not jbn.weight and p is not jbn.bias]
    finally:
        P.disable_static()
    tbn = TN.BatchNorm2D(4, device="cpu")
    tbn.eval()
    load_reference_state(tbn, *jbn.functional_state())
    PT.enable_static()
    try:
        tout = _builders(static, TN.functional.relu, tbn, device="cpu")
        tparams = static.default_main_program().all_parameters()
        # the builders made their own parameters: carry JAX's, in the
        # order both programs first read them
        assert [tuple(p.shape) for p in tparams] == \
            [j.shape for j in jparams]
        with torch.no_grad():
            for p, j in zip(tparams, jparams):
                p.copy_(torch.from_numpy(np.array(j)))
        (got,) = static.Executor("cpu").run(feed=feed, fetch_list=[tout])
    finally:
        PT.disable_static()
    _close(got, want)


def test_batch_norm_builder_refuses_training_mode():
    """JAX's builder fails at record time (a TypeError: it updates its
    running statistics from a symbolic value); the port's names the
    fix."""
    P.enable_static()
    try:
        with pytest.raises(TypeError):
            JS.nn.batch_norm(JS.data("x", [2, 4, 3, 3], "float32"))
    finally:
        P.disable_static()
    PT.enable_static()
    x = static.data("x", [2, 4, 3, 3], "float32")
    with pytest.raises(NotImplementedError, match="is_test=True"):
        static.nn.batch_norm(x, device="cpu")
    y = static.nn.batch_norm(x, is_test=True, act="relu", device="cpu")
    (out,) = static.Executor("cpu").run(
        feed={"x": -np.ones((2, 4, 3, 3), np.float32)}, fetch_list=[y])
    PT.disable_static()
    assert out.shape == (2, 4, 3, 3) and not out.any()


def test_variable_properties():
    PT.enable_static()
    x = static.data("img", [-1, 1, 28, 28], "float32")
    # symbolic (batch) dims surface as -1, as in JAX
    assert x.shape == [-1, 1, 28, 28]
    assert x.declared_shape == [-1, 1, 28, 28]
    assert x.name == "img" and x.is_data and x.vid > 0
    assert x.program is static.default_main_program()
    assert x.dtype == torch.float32 and x.device.type == "meta"
    with pytest.raises(RuntimeError, match="symbolic"):
        x.numpy()
    y = x * 2.0
    assert isinstance(y, static.Variable) and y.vid > x.vid
    assert list(y.shape) == [1, 1, 28, 28]      # the placeholder 1
    assert "Variable(name=img" in repr(x)
    assert static.default_main_program().feed_vars == {"img": x}


def test_program_guard_isolation_and_mixing():
    PT.enable_static()
    main1 = static.Program()
    with static.program_guard(main1):
        a = static.data("a", [2, 2], "float32")
        b = a * 2.0
    assert static.default_main_program() is not main1
    assert len(main1.ops) == 1 and not static.default_main_program().ops
    (r,) = static.Executor("cpu").run(
        main1, feed={"a": np.eye(2, dtype=np.float32)}, fetch_list=[b])
    np.testing.assert_allclose(r, 2 * np.eye(2))
    # a call that mixes Variables of two Programs raises
    c = static.data("c", [2, 2], "float32")
    with pytest.raises(ValueError, match="different Programs"):
        a + c
    # the default programs and the guard are per thread
    seen = {}

    def other():
        seen["main"] = static.default_main_program()

    with static.program_guard(main1):
        th = threading.Thread(target=other)
        th.start()
        th.join()
    assert seen["main"] is not main1


def test_prune_and_missing_feed():
    PT.enable_static()
    x = static.data("x", [2, 3], "float32")
    y = static.data("y", [2, 3], "float32")
    only_x = torch.relu(x) + 1.0
    both = only_x * y
    exe = static.Executor("cpu")
    xv = np.arange(6, dtype=np.float32).reshape(2, 3) - 3
    # y is not fed: fine while the fetch needs only x
    (r,) = exe.run(feed={"x": xv}, fetch_list=[only_x])
    np.testing.assert_allclose(r, np.maximum(xv, 0) + 1)
    with pytest.raises(KeyError, match="feed missing"):
        exe.run(feed={"x": xv}, fetch_list=[both])
    # by name, and the pruned program's replay leaves the rest out
    from paddle_tpu_torch.static.executor import _backward_reach

    prog = static.default_main_program()
    kept, _ = _backward_reach(prog.ops, [only_x.vid])
    assert len(kept) == 2 and len(prog.ops) == 3
    (r2,) = exe.run(feed={"x": xv, "y": xv}, fetch_list=[both.name])
    np.testing.assert_allclose(r2, (np.maximum(xv, 0) + 1) * xv)
    with pytest.raises(KeyError, match="not found"):
        exe.run(feed={"x": xv}, fetch_list=["nope"])
    # a declared dim the feed does not match: a new signature, run as the
    # JAX Executor retraces it (ROADMAP C1.5)
    x3 = np.arange(9, dtype=np.float32).reshape(3, 3) - 4
    (r3,) = exe.run(feed={"x": x3}, fetch_list=[only_x])
    np.testing.assert_allclose(r3, np.maximum(x3, 0) + 1)


def test_feed_at_a_new_shape_runs_as_in_jax():
    """ROADMAP C1.5: `static.data("x", [2, 4])` + `static.nn.fc(x, 3)` fed
    [3, 4] gives (3, 3) in both packages (JAX retraces; the port runs
    the new signature through its meta replay and captures its own
    graph), with the weights carried."""
    P.seed(0)
    rs = np.random.RandomState(5)
    feeds = [{"x": rs.rand(2, 4).astype(np.float32)},
             {"x": rs.rand(3, 4).astype(np.float32)}]
    P.enable_static()
    try:
        jout = JS.nn.fc(JS.data("x", [2, 4], "float32"), 3)
        jexe = JS.Executor()
        want = [jexe.run(feed=f, fetch_list=[jout])[0] for f in feeds]
        (jw, jb) = [np.asarray(p._value) for p in
                    JS.default_main_program().all_parameters()]
    finally:
        P.disable_static()
    PT.enable_static()
    try:
        tout = static.nn.fc(static.data("x", [2, 4], "float32"), 3,
                            device="cpu")
        tw, tb = static.default_main_program().all_parameters()
        with torch.no_grad():
            tw.copy_(torch.from_numpy(jw))
            tb.copy_(torch.from_numpy(jb))
        exe = static.Executor("cpu")
        got = [exe.run(feed=f, fetch_list=[tout])[0] for f in feeds]
    finally:
        PT.disable_static()
    assert [g.shape for g in got] == [w.shape for w in want] == \
        [(2, 3), (3, 3)]
    for g, w in zip(got, want):
        _close(g, w)
    (_, _, sigs, _), = exe._cache.values()
    assert len(sigs) == 2


def test_loaded_state_reaches_the_next_run_across_devices(tmp_path):
    """ROADMAP C1.4: an Executor on another device than the program's
    captures copies them once per program version; `static.load`,
    `set_program_state` and `deserialize_persistables` write the
    parameters in place and move the version on, so the next run copies
    the new values.  (The Executor's device is the meta device here, the
    only other device on this host: its slot's copies are read.)"""
    PT.enable_static()
    try:
        lin = TN.Linear(4, 2, device="cpu")
        y = lin(static.data("x", [1, 4], "float32"))
    finally:
        PT.disable_static()
    prog = static.default_main_program()
    path = str(tmp_path / "prog")
    static.save(prog, path)
    state = static.load_program_state(path)
    exe = static.Executor("cpu")
    x = np.ones((1, 4), np.float32)
    (before,) = exe.run(feed={"x": x}, fetch_list=[y])
    other = static.Executor("cpu")
    other.device = torch.device("meta")
    for write in (
            lambda: static.load(prog, path),
            lambda: static.set_program_state(
                prog, {k: v * 0 for k, v in state.items()}),
            lambda: static.deserialize_persistables(
                prog, static.serialize_persistables([], []))):
        slot = other._slot(prog)
        assert slot[3][0].device.type == "meta"
        write()
        assert other._slot(prog) is not slot
    static.set_program_state(prog, {k: v * 0 for k, v in state.items()})
    (after,) = exe.run(feed={"x": x}, fetch_list=[y])
    assert before.any() and not after.any()


def test_channel_last_builders():
    """ROADMAP C1.1: `static.nn.conv2d(data_format="NHWC")` against the
    JAX builder (weights carried), and `static.nn.batch_norm(data_layout=
    "NHWC")` against the eager NHWC layer (JAX's builder records no
    batch norm: it updates its statistics in training mode)."""
    P.seed(0)
    x = np.random.RandomState(6).randn(2, 6, 5, 3).astype(np.float32)
    P.enable_static()
    try:
        jout = JS.nn.conv2d(JS.data("img", [2, 6, 5, 3], "float32"), 4, 3,
                            padding=1, data_format="NHWC", act="relu")
        (want,) = JS.Executor().run(feed={"img": x}, fetch_list=[jout])
        jparams = [np.asarray(p._value) for p in
                   JS.default_main_program().all_parameters()]
    finally:
        P.disable_static()
    PT.enable_static()
    try:
        img = static.data("img", [2, 6, 5, 3], "float32")
        tout = static.nn.conv2d(img, 4, 3, padding=1, data_format="NHWC",
                                act="relu", device="cpu")
        bn = static.nn.batch_norm(img, is_test=True, data_layout="NHWC",
                                  device="cpu")
        tparams = static.default_main_program().all_parameters()
        with torch.no_grad():
            for p, j in zip(tparams, jparams):
                p.copy_(torch.from_numpy(j))
        exe = static.Executor("cpu")
        got, norm = exe.run(feed={"img": x}, fetch_list=[tout, bn])
    finally:
        PT.disable_static()
    _close(got, want)
    layer = TN.BatchNorm2D(3, data_format="NHWC", device="cpu").eval()
    with torch.no_grad():
        _close(norm, layer(torch.from_numpy(x)).numpy())


def test_signatures_cached_per_feed_shape():
    PT.enable_static()
    x = static.data("x", [-1, 4], "float32")
    y = x.sum(-1)
    exe = static.Executor("cpu")
    for b in (1, 2, 8, 2):
        (r,) = exe.run(feed={"x": np.ones((b, 4), np.float32)},
                       fetch_list=[y])
        assert r.shape == (b,) and (r == 4).all()
    (_, _, sigs, _), = exe._cache.values()
    assert len(sigs) == 3
    # a new op bumps the version: the cache starts again
    z = y * 2
    exe.run(feed={"x": np.ones((2, 4), np.float32)}, fetch_list=[z])
    (_, _, sigs, _), = exe._cache.values()
    assert len(sigs) == 1


def test_minus_one_batch_gpt_tiny_is_refused_naming_the_baked_shape(
        tmp_path):
    """ROADMAP C2.31: the GPT's attention reads the batch of an
    intermediate value (the placeholder 1) and bakes it into its
    reshape.  JAX raises TypeError at the trace of a feed of batch 2;
    the port raises TypeError at its meta replay of the new signature,
    naming the baked shape, before any work.  Saved, the program is
    narrowed to batch 1 with a RuntimeWarning, and the loaded program
    refuses batch 2 with a ValueError naming [1, 16]."""
    jm, tm, ids = _gpt_pair()
    P.enable_static()
    try:
        jy = jm(JS.data("ids", [-1, 16], "int64"))
        with pytest.raises(TypeError, match=r"1, 16, 3, 4, 8"):
            JS.Executor().run(feed={"ids": ids}, fetch_list=[jy])
    finally:
        P.disable_static()
    PT.enable_static()
    x = static.data("ids", [-1, 16], "int64")
    y = tm(x)
    exe = static.Executor("cpu")
    with pytest.raises(TypeError, match=r"\[1, 16, 3, 4, 8\]"):
        exe.run(feed={"ids": ids}, fetch_list=[y])
    # batch 1 runs, and equals the eager forward
    (one,) = exe.run(feed={"ids": ids[:1]}, fetch_list=[y])
    with torch.no_grad():
        assert np.array_equal(one, tm(torch.from_numpy(ids[:1])).numpy())
    prefix = str(tmp_path / "gpt")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        static.save_inference_model(prefix, [x], [y])
    assert any(issubclass(w.category, RuntimeWarning)
               and "[[1, 16]]" in str(w.message) for w in caught)
    PT.disable_static()
    prog, _, _ = static.load_inference_model(prefix, device="cpu")
    with pytest.raises(ValueError, match=r"\[1, 16\]"):
        prog._run({"ids": ids})
    assert np.array_equal(prog._run({"ids": ids[:1]})[0], one)


def test_calls_on_eager_tensors_run_at_once():
    """Only calls with a Variable (or the meta device one reports) are
    recorded: a parameter initialiser or a folded constant runs now."""
    PT.enable_static()
    assert not PT.in_dynamic_mode()
    w = torch.ones(3) * 2.0          # eager
    assert not isinstance(w, static.Variable) and w.sum().item() == 6.0
    x = static.data("x", [3], "float32")
    pos = torch.arange(3, device=x.device)   # a factory on x's device
    assert isinstance(pos, static.Variable)
    y = x * w + pos
    prog = static.default_main_program()
    assert [op.name for op in prog.ops] == ["arange", "mul", "add"]
    assert len(prog.captures) == 1 and prog.captures[0] is w
    (r,) = static.Executor("cpu").run(
        feed={"x": np.ones(3, np.float32)}, fetch_list=[y])
    np.testing.assert_allclose(r, [2.0, 3.0, 4.0])
    PT.disable_static()
    assert PT.in_dynamic_mode()
    assert not torch.overrides._get_current_function_mode_stack()


def test_bfloat16_fetch_is_its_uint16_words():
    """ROADMAP C2.32: numpy has no bfloat16; a bf16 fetch leaves as its
    raw uint16 words, as the port's files carry bf16 (C2.17)."""
    PT.enable_static()
    x = static.data("x", [4], "float32")
    y = x.to(torch.bfloat16) * 3
    exe = static.Executor("cpu")
    xv = np.array([1.0, 0.1, -2.5, 7.0], np.float32)
    (r,) = exe.run(feed={"x": xv}, fetch_list=[y])
    (t,) = exe.run(feed={"x": xv}, fetch_list=[y], return_numpy=False)
    PT.disable_static()
    want = torch.from_numpy(xv).to(torch.bfloat16) * 3
    assert r.dtype == np.uint16 and torch.equal(t, want)
    assert np.array_equal(r, want.view(torch.int16).numpy().view(np.uint16))


def test_static_file_api(tmp_path):
    PT.enable_static()
    lin = TN.Linear(4, 2, device="cpu")
    x = static.data("x", [1, 4], "float32")
    y = lin(x)
    prog = static.default_main_program()
    path = str(tmp_path / "prog")
    static.save(prog, path)
    state = static.load_program_state(path)
    assert sorted(state) == ["p0", "p1"]
    with torch.no_grad():
        lin.weight.zero_()
    static.load(prog, path)
    assert np.array_equal(lin.weight.detach().numpy(), state["p0"])
    blob = static.serialize_persistables([x], [y])
    static.save_to_file(str(tmp_path / "blob"), blob)
    with torch.no_grad():
        lin.bias.fill_(5.0)
    static.deserialize_persistables(
        prog, static.load_from_file(str(tmp_path / "blob")))
    assert np.array_equal(lin.bias.detach().numpy(), state["p1"])
    meta = static.deserialize_program(static.serialize_program([x], [y]))
    assert meta == {"n_ops": 2, "feeds": ["x"], "fetches": [y.name]}
    assert static.normalize_program(prog, [x], [y]) is prog
    assert static.CompiledProgram(prog) is prog
    g = static.create_global_var([2], 3.0, "float32", device="cpu")
    assert g.tolist() == [3.0, 3.0]
    p = static.create_parameter([4, 2], "float32", device="cpu")
    assert isinstance(p, torch.nn.Parameter) and p.abs().max() > 0
    assert static.cpu_places() == [torch.device("cpu")]
    PT.disable_static()


def test_forward_surface_only():
    """The forward surface is exported; the training surface is the next
    slice (ROADMAP)."""
    for name in ("CompiledProgram", "BuildStrategy", "ExecutionStrategy",
                 "name_scope", "device_guard", "cpu_places", "cuda_places",
                 "xpu_places", "save", "load", "serialize_program",
                 "serialize_persistables", "save_to_file", "load_from_file",
                 "deserialize_program", "deserialize_persistables",
                 "normalize_program", "load_program_state",
                 "set_program_state", "create_global_var",
                 "create_parameter", "data", "Program", "Executor",
                 "InputSpec", "program_guard", "global_scope",
                 "scope_guard", "save_inference_model",
                 "load_inference_model"):
        assert hasattr(static, name), name
        assert hasattr(JS, name), name
    for name in ("append_backward", "gradients", "minimize_static",
                 "ExponentialMovingAverage", "py_func", "Print"):
        assert not hasattr(static, name) and hasattr(JS, name), name
    for name in ("fc", "embedding", "conv2d", "batch_norm", "layer_norm"):
        assert hasattr(static.nn, name) and hasattr(JS.nn, name)
    for name in ("cond", "while_loop", "switch_case", "case", "py_func"):
        assert not hasattr(static.nn, name) and hasattr(JS.nn, name), name
    spec = static.InputSpec([None, 3], "bfloat16", "x")
    assert spec.declared_shape == [-1, 3] and spec.dtype == torch.bfloat16
    assert os.path.basename(static.__file__) == "__init__.py"
