"""Saved-model serving in the port on the CPU: `InferenceServer(model_path=)`
answering `POST /predict` from a program `static.save_inference_model`
wrote, held against the JAX package's server on the same weights, and
a fleet replica of kind ``model``.

Covered: `/predict` of `gpt_tiny` (weights carried from the JAX model)
equals JAX's server within the f32 tolerance 1e-5 and the in-process
`Predictor` bit for bit; a program whose batch is fixed (the ``[-1,
16]`` `gpt_tiny`, ROADMAP C2.31) refuses a batch of 2 with 400 on both
servers, without the batch-halving path; a bfloat16 output travels in
the npz as its uint16 words (C2.32); a `kind="model"` replica with
``--device cpu`` warms up at the saved signature before it announces
and serves `/predict` through the router equal to the in-process
predictor, counting its runs on /debug/telemetry.  Every server and
fleet is shut down in a `finally`.
"""
from __future__ import annotations

import json
import urllib.error
import urllib.request
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import static as JS
from paddle_tpu.inference.serving import InferenceServer as JServer
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT

import paddle_tpu_torch as PT
from paddle_tpu_torch import inference as TI
from paddle_tpu_torch import static
from paddle_tpu_torch.inference import serving as S
from paddle_tpu_torch.inference.fleet import ReplicaFleet
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.models.gpt import load_reference_state
from paddle_tpu_torch.observability import metrics

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


def _save_both(tmp_path, shape):
    """gpt_tiny saved at `shape` by both packages (the fetch named
    "logits"), the port's weights carried from JAX's; returns (JAX
    prefix, port prefix)."""
    P.seed(0)
    jm = JGPT(JGPTConfig(**GPT))
    jm.eval()
    tm = GPTForCausalLM(GPTConfig(**GPT), device="cpu")
    load_reference_state(tm, *jm.functional_state())
    jp, tp = str(tmp_path / "jgpt"), str(tmp_path / "tgpt")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        P.enable_static()
        try:
            jx = JS.data("ids", shape, "int64")
            jy = jm(jx)
            jy.name = "logits"
            JS.save_inference_model(jp, [jx], [jy])
        finally:
            P.disable_static()
        PT.enable_static()
        try:
            x = static.data("ids", shape, "int64")
            y = tm(x)
            y.name = "logits"
            static.save_inference_model(tp, [x], [y])
        finally:
            PT.disable_static()
    return jp, tp


def _post(address, **arrays):
    """(status, arrays or error body) of one /predict, no client retry."""
    try:
        return 200, S.InferenceClient(address, timeout=60,
                                      retries=0).predict(**arrays)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_model_path_predict_equals_jax_server(tmp_path):
    jp, tp = _save_both(tmp_path, [2, 16])
    ids = np.random.RandomState(1).randint(0, 128, (2, 16)).astype(np.int64)
    jsrv = JServer(jp)
    tsrv = S.InferenceServer(model_path=tp, device="cpu")
    jsrv.start()
    tsrv.start()
    try:
        code, want = _post(jsrv.address, ids=ids)
        assert code == 200
        code, got = _post(tsrv.address, ids=ids)
        assert code == 200 and list(got) == list(want)
        (name,) = got
        w = np.asarray(want[name])
        scale = max(1.0, float(np.abs(w).max()))
        assert float(np.abs(got[name] - w).max()) <= F32_TOL * scale
        cfg = TI.Config(tp)
        cfg.disable_gpu()
        (inproc,) = TI.create_predictor(cfg).run([ids])
        assert np.array_equal(got[name], inproc)
        assert tsrv.predictor_runs == 1
        # positional arrays (np.savez's arr_0) feed in order
        code, again = _post(tsrv.address, arr_0=ids)
        assert code == 200 and np.array_equal(again[name], inproc)
    finally:
        jsrv.shutdown()
        tsrv.shutdown()


def test_fixed_batch_program_is_a_client_error_on_both(tmp_path):
    """ROADMAP C2.31 at the server: the `[-1, 16]` gpt_tiny takes batch 1
    only (JAX's export keeps the symbol and fails to refine it at the
    call; the port's is narrowed at save).  Both refuse batch 2 with a
    ValueError, a client error (400): the deterministic class skips
    the batch-halving path, which would otherwise serve the halves."""
    jp, tp = _save_both(tmp_path, [-1, 16])
    ids = np.random.RandomState(1).randint(0, 128, (2, 16)).astype(np.int64)
    jsrv = JServer(jp)
    tsrv = S.InferenceServer(model_path=tp, device="cpu")
    jsrv.start()
    tsrv.start()
    was_on = metrics.enabled()
    metrics.enable()
    try:
        before = metrics.snapshot()["counters"].get(
            "resilience.degraded_batches", 0)
        jcode, jbody = _post(jsrv.address, ids=ids)
        tcode, tbody = _post(tsrv.address, ids=ids)
        assert jcode == tcode == 400
        assert "ValueError" in jbody["error"]
        assert "ValueError" in tbody["error"] and "[1, 16]" in tbody["error"]
        assert metrics.snapshot()["counters"].get(
            "resilience.degraded_batches", 0) == before
        assert tsrv.predictor_runs == 0
        code, _ = _post(tsrv.address, ids=ids[:1])
        assert code == 200
    finally:
        if not was_on:
            metrics.disable()
        jsrv.shutdown()
        tsrv.shutdown()


def test_bfloat16_output_travels_as_uint16_words(tmp_path):
    prefix = str(tmp_path / "bf16")
    PT.enable_static()
    try:
        x = static.data("x", [-1, 3], "float32")
        static.save_inference_model(prefix, [x], [(x * 3).to(
            torch.bfloat16)])
    finally:
        PT.disable_static()
    srv = S.InferenceServer(model_path=prefix, device="cpu")
    srv.start()
    try:
        xv = np.array([[0.1, 2.0, -7.3]], np.float32)
        code, got = _post(srv.address, x=xv)
        assert code == 200
        (out,) = got.values()
        want = (torch.from_numpy(xv) * 3).to(torch.bfloat16)
        assert out.dtype == np.uint16
        assert np.array_equal(out, want.view(torch.int16).numpy().view(
            np.uint16))
    finally:
        srv.shutdown()


def test_model_replica_serves_on_cpu(tmp_path):
    """A `kind="model"` replica with device="cpu" loads the saved program,
    runs one predict at the saved signature before it announces, and
    serves /predict through the router: equal to the in-process
    predictor, its runs counted on /debug/telemetry from its announce."""
    _, tp = _save_both(tmp_path, [2, 16])
    ids = np.random.RandomState(5).randint(0, 128, (2, 16)).astype(np.int64)
    cfg = TI.Config(tp)
    cfg.disable_gpu()
    (want,) = TI.create_predictor(cfg).run([ids])
    fleet = ReplicaFleet(num_replicas=1, kind="model", model_path=tp,
                         device="cpu", launch_timeout=120, heartbeat=False,
                         workdir=str(tmp_path / "fleet"))
    fleet.start(ready_timeout=120)
    try:
        for _ in range(2):
            code, got = _post(fleet.router.address, ids=ids)
            assert code == 200
            (out,) = got.values()
            assert np.array_equal(out, want)
        addr = fleet._handles[0].address
        with urllib.request.urlopen(addr + "/debug/telemetry",
                                    timeout=30) as r:
            kern = json.loads(r.read())["kernels"]
        # the warm-up's run is not counted: the server starts after it
        assert kern["predictor_runs"] == 2
        assert not any(kern["launches"].values())      # the CPU: plain
        (rec,) = fleet.lifecycle.fleet_view()["records"]
        phases = rec["replica"]["phases"]
        assert phases["weight_load"]["mono_ms"] \
            <= phases["warmup"]["mono_ms"] <= phases["announce"]["mono_ms"]
    finally:
        fleet.stop()
