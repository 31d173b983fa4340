"""The port's saved inference models and predictors
(`static.save_inference_model` / `load_inference_model`,
`inference.Config` / `create_predictor` / `Predictor` / `PredictorPool`,
the C inference ABI) on the CPU, against the JAX package's.

Covered: a save -> load round trip whose loaded program equals the
recorded program's `Executor.run` bit for bit (dynamic batch included);
the `.pdiparams` pickle has JAX's keys, feed and fetch names and
capture shapes for the same program; JAX's and the port's predictors
agree on `gpt_tiny` with carried weights within the f32 tolerance 1e-5;
the handle API, `run(list)` and `PredictorPool`; the C ABI built with
`g++` here and driven through `ctypes` as `tests/test_native.py` drives
JAX's (a bfloat16 output as code 6, its uint16 words); the config
surface and the refusals.
"""
from __future__ import annotations

import ctypes
import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import inference as JI
from paddle_tpu import static as JS
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT

import paddle_tpu_torch as PT
from paddle_tpu_torch import inference as TI
from paddle_tpu_torch import nn as TN
from paddle_tpu_torch import static
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.models.gpt import load_reference_state
from paddle_tpu_torch.native import capi

torch.set_num_threads(1)

F32_TOL = 1e-5
GPT = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=64)


@pytest.fixture(autouse=True)
def _fresh_programs():
    static.reset_default_programs()
    JS.reset_default_programs()
    yield
    PT.disable_static()
    P.disable_static()
    static.reset_default_programs()
    JS.reset_default_programs()


def _cpu_config(prefix):
    cfg = TI.Config(prefix)
    cfg.disable_gpu()
    return cfg


def _linear_pair():
    P.seed(0)
    jlin = P.nn.Linear(4, 3)
    tlin = TN.Linear(4, 3, device="cpu")
    load_reference_state(tlin, *jlin.functional_state())
    return jlin, tlin


def _save_linear(prefix, tlin, shape=(-1, 4)):
    """The port's Linear + softmax program saved at `prefix`; returns the
    program, its feed and fetch, and an Executor."""
    PT.enable_static()
    try:
        x = static.data("x", list(shape), "float32")
        y = torch.softmax(tlin(x), -1)
        y.name = "prob"
        exe = static.Executor("cpu")
        static.save_inference_model(prefix, [x], [y], exe)
        return static.default_main_program(), x, y, exe
    finally:
        PT.disable_static()


def test_round_trip_equals_the_recorded_program(tmp_path):
    _, tlin = _linear_pair()
    prefix = str(tmp_path / "lin")
    prog, x, y, exe = _save_linear(prefix, tlin)
    loaded, feeds, fetches = static.load_inference_model(prefix,
                                                         executor=exe)
    assert feeds == ["x"] and fetches == ["prob"]
    rs = np.random.RandomState(0)
    for b in (1, 3, 8):
        xv = rs.rand(b, 4).astype(np.float32)
        (want,) = exe.run(prog, feed={"x": xv}, fetch_list=[y])
        (got,) = exe.run(loaded, feed={"x": xv})
        assert np.array_equal(got, want)
    with pytest.raises(KeyError, match="missing feed"):
        exe.run(loaded, feed={})


def test_pdiparams_has_jax_keys_names_and_capture_shapes(tmp_path):
    jlin, tlin = _linear_pair()
    P.enable_static()
    try:
        jx = JS.data("x", [-1, 4], "float32")
        jy = P.nn.functional.softmax(jlin(jx))
        jy.name = "prob"
        JS.save_inference_model(str(tmp_path / "jax"), [jx], [jy])
    finally:
        P.disable_static()
    _save_linear(str(tmp_path / "port"), tlin)
    with open(tmp_path / "jax.pdiparams", "rb") as f:
        want = pickle.load(f)
    with open(tmp_path / "port.pdiparams", "rb") as f:
        got = pickle.load(f)
    assert sorted(got) == sorted(want)
    assert got["format"] == want["format"] == "static_inference"
    for key in ("feed_names", "fetch_names"):
        assert got[key] == want[key]
    assert [c.shape for c in got["caps"]] == \
        [np.asarray(c).shape for c in want["caps"]]
    for g, w in zip(got["caps"], want["caps"]):
        assert np.array_equal(g, np.asarray(w))


def test_unresolved_fetch_raises(tmp_path):
    PT.enable_static()
    x = static.data("x", [2], "float32")
    y = static.data("y", [2], "float32")
    z = x + y
    with pytest.raises(ValueError, match="unresolved vids"):
        static.save_inference_model(str(tmp_path / "m"), [x], [z])
    PT.disable_static()


def _gpt_saved(tmp_path):
    P.seed(0)
    jm = JGPT(JGPTConfig(**GPT))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**GPT), device="cpu")
    load_reference_state(tm, *jm.functional_state())
    P.enable_static()
    try:
        jx = JS.data("ids", [2, 16], "int64")
        JS.save_inference_model(str(tmp_path / "jgpt"), [jx], [jm(jx)])
    finally:
        P.disable_static()
    PT.enable_static()
    try:
        x = static.data("ids", [2, 16], "int64")
        static.save_inference_model(str(tmp_path / "tgpt"), [x], [tm(x)])
    finally:
        PT.disable_static()
    return tm


def test_predictor_matches_jax_predictor_on_gpt_tiny(tmp_path):
    tm = _gpt_saved(tmp_path)
    ids = np.random.RandomState(1).randint(0, 128, (2, 16)).astype(np.int64)
    (want,) = JI.create_predictor(JI.Config(str(tmp_path / "jgpt"))).run(
        [ids])
    pred = TI.create_predictor(_cpu_config(str(tmp_path / "tgpt")))
    (got,) = pred.run([ids])
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - np.asarray(want)).max()) <= F32_TOL * scale
    with torch.no_grad():
        assert np.array_equal(got, tm(torch.from_numpy(ids)).numpy())
    # the saved program holds the kernel as its op, not a plain version
    targets = {str(n.target) for n in pred._prog.exported.graph.nodes}
    assert "paddle_tpu_torch.flash_fwd.default" in targets
    assert not any("einsum" in t for t in targets)


def test_handles_run_list_and_pool(tmp_path):
    _, tlin = _linear_pair()
    prefix = str(tmp_path / "lin")
    prog, x, y, exe = _save_linear(prefix, tlin)
    xv = np.random.RandomState(4).rand(5, 4).astype(np.float32)
    (want,) = exe.run(prog, feed={"x": xv}, fetch_list=[y])
    pred = TI.create_predictor(_cpu_config(prefix))
    assert pred.get_input_names() == ["x"]
    assert pred.get_output_names() == ["prob"]
    assert pred.input_specs() == {"x": ([-1, 4], torch.float32)}
    h = pred.get_input_handle("x")
    h.copy_from_cpu(xv.astype(np.float64))      # cast to the feed's dtype
    assert h.shape() == [5, 4]
    assert pred.run() is True
    out = pred.get_output_handle("prob")
    assert np.array_equal(out.copy_to_cpu(), want)
    assert np.array_equal(pred.run([xv])[0], want)
    with pytest.raises(ValueError, match="inputs"):
        pred.run([xv, xv])
    pool = TI.PredictorPool(_cpu_config(prefix), size=2)
    p0, p1 = pool.retrive(0), pool.retrieve(1)
    assert p0 is not p1
    for p in (p0, p1):
        assert np.array_equal(p.run([xv])[0], want)


def test_c_abi_mirrors_the_native_test(tmp_path, monkeypatch):
    """`tests/test_native.py::test_c_inference_api` against the port:
    build the library, load it with ctypes, run a saved model through
    the raw C structs; bad handles fail with an error message."""
    monkeypatch.setenv("PADDLE_TPU_CAPI_DEVICE", "cpu")
    _, tlin = _linear_pair()
    prefix = str(tmp_path / "cmodel")
    prog, x, y, exe = _save_linear(prefix, tlin)
    lib = capi.load()
    h = lib.PD_PredictorCreate(prefix.encode())
    assert h > 0, lib.PD_LastError().decode()
    assert lib.PD_PredictorInputNum(h) == 1
    assert lib.PD_PredictorOutputNum(h) == 1
    buf = ctypes.create_string_buffer(64)
    assert lib.PD_PredictorInputName(h, 0, buf, 64) > 0 and buf.value == b"x"
    assert lib.PD_PredictorOutputName(h, 0, buf, 64) > 0 \
        and buf.value == b"prob"
    xv = np.random.RandomState(0).rand(2, 4).astype(np.float32)
    td_in = capi.np_to_td(xv)
    outs = (capi.PD_TensorData * 4)()
    n_out = lib.PD_PredictorRun(h, ctypes.byref(td_in), 1, outs, 4)
    assert n_out == 1, lib.PD_LastError().decode()
    got = capi.td_to_np(outs[0])
    lib.PD_ReleaseOutputs(outs, n_out)
    (ref,) = exe.run(prog, feed={"x": xv}, fetch_list=[y])
    assert np.array_equal(got, ref)
    assert lib.PD_PredictorRun(9999, ctypes.byref(td_in), 1, outs, 4) < 0
    assert b"9999" in lib.PD_LastError()
    assert lib.PD_PredictorDestroy(h) == 1
    assert lib.PD_PredictorDestroy(h) == 0
    # a device the ABI does not know fails the create, with its message
    monkeypatch.setenv("PADDLE_TPU_CAPI_DEVICE", "tpu")
    assert lib.PD_PredictorCreate(prefix.encode()) < 0
    assert b"PADDLE_TPU_CAPI_DEVICE" in lib.PD_LastError()


def test_bfloat16_through_handles_and_the_c_abi(tmp_path, monkeypatch):
    """ROADMAP C2.32: a bfloat16 feed or fetch crosses numpy as its uint16
    words, and the C ABI's code 6 as the same raw bits."""
    monkeypatch.setenv("PADDLE_TPU_CAPI_DEVICE", "cpu")
    prefix = str(tmp_path / "bf16")
    PT.enable_static()
    try:
        x = static.data("x", [3], "bfloat16")
        y = x * 2 + 1
        static.save_inference_model(prefix, [x], [y])
    finally:
        PT.disable_static()
    xt = torch.tensor([1.5, -0.3, 7.0], dtype=torch.bfloat16)
    words = xt.view(torch.int16).numpy().view(np.uint16)
    want = (xt * 2 + 1).view(torch.int16).numpy().view(np.uint16)
    pred = TI.create_predictor(_cpu_config(prefix))
    h = pred.get_input_handle("x")
    h.copy_from_cpu(words)
    pred.run()
    out = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    assert out.dtype == np.uint16 and np.array_equal(out, want)
    lib = capi.load()
    hd = lib.PD_PredictorCreate(prefix.encode())
    assert hd > 0, lib.PD_LastError().decode()
    td_in = capi.np_to_td(words, bfloat16=True)
    outs = (capi.PD_TensorData * 2)()
    assert lib.PD_PredictorRun(hd, ctypes.byref(td_in), 1, outs, 2) == 1
    assert outs[0].dtype == TI.DataType.BFLOAT16 == 6
    got = capi.td_to_np(outs[0])
    lib.PD_ReleaseOutputs(outs, 1)
    lib.PD_PredictorDestroy(hd)
    assert got.dtype == np.uint16 and np.array_equal(got, want)


def test_capi_build_failure_raises(monkeypatch, tmp_path):
    """A failed build of capi.cc raises (OSError), never a stale or
    missing library loaded quietly."""
    monkeypatch.setattr(capi, "_lib", None)
    monkeypatch.setattr(capi, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(capi, "_SO", str(tmp_path / "build" / "x.so"))
    monkeypatch.setattr(capi, "_HASH_FILE", str(tmp_path / "build" / "h"))
    monkeypatch.setattr(capi, "_SRC_DIR", str(tmp_path / "nosrc"))
    os.makedirs(tmp_path / "nosrc")
    for f in capi._SRCS:
        (tmp_path / "nosrc" / f).write_text("#error broken\n")
    with pytest.raises(OSError, match="cannot build"):
        capi.load()


def test_config_surface_and_refusals():
    cfg = TI.Config("/some/model")
    assert cfg.path_prefix == "/some/model" and cfg.use_gpu()
    cfg.enable_use_gpu(device_id=3)
    assert cfg.gpu_device_id() == 3
    cfg.disable_gpu()
    assert not cfg.use_gpu() and cfg.device() == torch.device("cpu")
    assert TI.Config("/m/x.pdmodel", "/m/x.pdiparams").path_prefix == "/m/x"
    with pytest.raises(NotImplementedError):
        TI.convert_to_mixed_precision("a", "b")
    with pytest.raises(NotImplementedError):
        TI.XpuConfig()
    with pytest.raises(NotImplementedError):
        cfg.enable_xpu()
    for name in ("FLOAT32", "INT64", "INT32", "UINT8", "INT8", "FLOAT16",
                 "BFLOAT16", "BOOL"):
        assert getattr(TI.DataType, name) == getattr(JI.DataType, name)
        code = getattr(TI.DataType, name)
        assert TI.get_num_bytes_of_data_type(code) == \
            JI.get_num_bytes_of_data_type(code)
    assert TI.Tensor is TI.PredictorTensor
    assert TI.PlaceType.GPU == JI.PlaceType.GPU
    assert TI.PrecisionType.Bfloat16 == JI.PrecisionType.Bfloat16
    assert "paddle_tpu_torch" in TI.get_version()
