"""The port's resilience pieces of a long training job against the JAX
package's, on the CPU: the guard's escalation ladder, the checkpoint
format and `CheckpointManager`, the watchdog and `StepTimer`, the
telemetry schema's training keys.

  * `StepGuard`: the same verdicts give the same actions, counters and
    rollbacks in both packages (``tests/test_resilience.py:337-391``);
  * checkpoints (``tests/test_resilience.py:223-321``): the CRC round
    trip, a kill mid-write keeping the previous checkpoint, corruption
    falling back and quarantined, rotation with the `latest` pointer,
    async-save errors; a file either package writes the other loads,
    with the same keys and the same bytes, bf16 included (the port
    reads and writes bf16 as its raw words, without ``ml_dtypes``), and
    the metadata pickle resolves in each package without importing the
    other;
  * the watchdog (``tests/test_resilience.py:426-470``): a stall dumps
    the flight ring and re-arms, a `StepTimer` record beats it, `check`
    raises past the timeout;
  * `attach()` declares the training keys the JAX package declares.

Everything here is host code: no model, no kernel.
"""
from __future__ import annotations

import io
import os
import pickle
import subprocess
import sys
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed import checkpoint as JC
from paddle_tpu.resilience import guards as JGD
from paddle_tpu_torch.distributed import checkpoint as TC
from paddle_tpu_torch.distributed.checkpoint import _pickle as TP
from paddle_tpu_torch.observability import flight, metrics
from paddle_tpu_torch.resilience import (
    InjectedFault, StepGuard, Watchdog, WatchdogStall, faults,
)
from paddle_tpu_torch.resilience.guards import RollbackError

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def clean_faults():
    faults.clear()
    yield
    faults.clear()


# ------------------------------------------------------------ the ladder
@pytest.mark.parametrize("oks,k", [
    ([True, False, True, False, False, True], 3),
    ([False, False, False, False, True, False], 3),
    ([False] * 7, 2),
    ([False, True] * 3, 1),
])
def test_step_guard_ladder_matches_jax(oks, k):
    """One verdict sequence through both packages' guards: the same
    action per step, the same counters and the same rollback calls."""
    calls = {"t": 0, "j": 0}
    tg = StepGuard(max_consecutive_bad=k,
                   on_rollback=lambda: calls.__setitem__("t", calls["t"] + 1))
    jg = JGD.StepGuard(max_consecutive_bad=k,
                       on_rollback=lambda: calls.__setitem__(
                           "j", calls["j"] + 1))
    got = [tg.observe(ok) for ok in oks]
    want = [jg.observe(ok) for ok in oks]
    assert got == want
    assert tg.state_dict() == jg.state_dict()
    assert calls["t"] == calls["j"] == tg.rollbacks


def test_guard_without_rollback_target_raises_in_both():
    for cls, err in ((StepGuard, RollbackError),
                     (JGD.StepGuard, JGD.RollbackError)):
        g = cls(max_consecutive_bad=1)
        with pytest.raises(err):
            g.observe(False)
        quiet = cls(max_consecutive_bad=1, raise_without_rollback=False)
        assert quiet.observe(False) == "rollback" and quiet.rollbacks == 1


def test_guard_rollback_callback_failure_is_a_rollback_error():
    def boom():
        raise OSError("disk gone")

    g = StepGuard(max_consecutive_bad=1, on_rollback=boom)
    with pytest.raises(RollbackError, match="disk gone"):
        g.observe(False)


def test_tree_finite_and_select_match_jax():
    """The device half: one bool over the loss and every floating grad,
    and the per-tensor select, against `jnp`'s on the same values."""
    rs = np.random.RandomState(0)
    grads = [rs.randn(3, 4).astype(np.float32), rs.randn(5).astype(np.float32)]
    for poison in (None, (0, 1, 2), (1, 3)):
        gs = [g.copy() for g in grads]
        if poison is not None:
            gs[poison[0]].flat[poison[1]] = np.inf if len(poison) == 3 \
                else np.nan
        from paddle_tpu_torch.resilience import guards as TGD

        ok_t = TGD.tree_finite(torch.tensor(1.5),
                               [torch.from_numpy(g) for g in gs])
        ok_j = JGD.tree_finite(jnp.float32(1.5), [jnp.asarray(g) for g in gs])
        assert ok_t.dtype == torch.bool and ok_t.dim() == 0
        assert bool(ok_t) == bool(ok_j) == (poison is None)
        new = [torch.from_numpy(g) for g in gs]
        old = [torch.zeros_like(t) for t in new]
        sel = TGD.tree_select(ok_t, new, old)
        ref = JGD.tree_select(ok_j, [jnp.asarray(g) for g in gs],
                              [jnp.zeros_like(jnp.asarray(g)) for g in gs])
        for a, b in zip(sel, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not bool(TGD.tree_finite(torch.tensor(float("nan"))))


# ------------------------------------------------------------ checkpoints
def _sd(v=1.0):
    return {"w": torch.full((3, 4), v, dtype=torch.float32),
            "step": torch.tensor(7, dtype=torch.int32)}


def _zeros_like_sd():
    return {"w": torch.zeros(3, 4), "step": torch.tensor(0,
                                                         dtype=torch.int32)}


def test_checkpoint_crc_roundtrip(tmp_path):
    path = str(tmp_path / "ck")
    src = _sd()
    TC.save_state_dict(src, path)
    rep = TC.verify_checkpoint(path)
    assert rep["shards"] == 2 and rep["unverified"] == 0
    tgt = _zeros_like_sd()
    w = tgt["w"]
    TC.load_state_dict(tgt, path)
    assert tgt["w"] is w                     # loaded in place
    assert torch.equal(tgt["w"], src["w"]) and int(tgt["step"]) == 7
    assert not any(n.endswith(".tmp") for n in os.listdir(path))


def test_checkpoint_load_refuses_another_shape(tmp_path):
    path = str(tmp_path / "ck")
    TC.save_state_dict(_sd(), path)
    with pytest.raises(ValueError, match="shape"):
        TC.load_state_dict({"w": torch.zeros(4, 3)}, path)
    with pytest.raises(ValueError, match="no checkpoint metadata"):
        TC.load_state_dict(_zeros_like_sd(), str(tmp_path))


def test_checkpoint_mid_write_kill_preserves_previous(tmp_path):
    mgr = TC.CheckpointManager(str(tmp_path), keep_last_k=3)
    mgr.save(_sd(), step=0)
    with faults.inject("checkpoint.write", kind="torn", at=1):
        with pytest.raises(InjectedFault):
            mgr.save(_sd(2.0), step=1)
    assert mgr.checkpoints() == [0] and mgr.latest_step() == 0
    tgt = _zeros_like_sd()
    assert mgr.restore(tgt) == 0
    assert torch.equal(tgt["w"], _sd()["w"])


def test_checkpoint_corruption_rolls_back(tmp_path):
    mgr = TC.CheckpointManager(str(tmp_path), keep_last_k=3)
    mgr.save(_sd(), step=0)
    with faults.inject("checkpoint.write", kind="corrupt", at=1):
        mgr.save(_sd(2.0), step=1)
    with pytest.raises(TC.CheckpointCorruptionError):
        TC.verify_checkpoint(mgr._dir(1))
    metrics.enable()
    metrics.reset()
    try:
        tgt = _zeros_like_sd()
        assert mgr.restore(tgt) == 0
        assert torch.equal(tgt["w"], _sd()["w"])
        assert metrics.snapshot()["counters"].get(
            "resilience.rollbacks", 0) >= 1
    finally:
        metrics.disable()
    assert os.path.isdir(mgr._dir(1) + ".corrupt")
    assert 1 not in mgr.checkpoints()


def test_checkpoint_rotation_and_latest_pointer(tmp_path):
    mgr = TC.CheckpointManager(str(tmp_path), keep_last_k=2)
    for s in range(4):
        mgr.save(_sd(float(s + 1)), step=s)
    assert mgr.checkpoints() == [2, 3] and mgr.latest_step() == 3
    with open(os.path.join(str(tmp_path), "latest")) as f:
        assert f.read().strip() == "ckpt_00000003"
    tgt = _zeros_like_sd()
    assert mgr.restore(tgt) == 3
    assert torch.equal(tgt["w"], _sd(4.0)["w"])
    # the next save without a step number follows the newest
    assert mgr.save(_sd(9.0)).endswith("ckpt_00000004")


def test_failed_async_save_does_not_block_restore(tmp_path):
    mgr = TC.CheckpointManager(str(tmp_path), keep_last_k=3)
    mgr.save(_sd(), step=0)
    with faults.inject("checkpoint.write", kind="torn", at=1):
        mgr.save(_sd(2.0), step=1, async_save=True)
        tgt = _zeros_like_sd()
        assert mgr.restore(tgt) == 0
    assert torch.equal(tgt["w"], _sd()["w"])
    TC.wait_async_save()


def test_async_save_error_reraised_on_next_wait(tmp_path):
    path = str(tmp_path / "ck")
    with faults.inject("checkpoint.write", kind="torn", at=1):
        TC.save_state_dict(_sd(), path, async_save=True)
        with pytest.raises(InjectedFault):
            TC.wait_async_save()
    TC.wait_async_save()
    src = _sd(3.0)
    TC.save_state_dict(src, path, async_save=True)
    src["w"].zero_()              # the host snapshot was taken already
    TC.wait_async_save()
    assert TC.verify_checkpoint(path)["shards"] == 2
    tgt = _zeros_like_sd()
    TC.load_state_dict(tgt, path)
    assert torch.equal(tgt["w"], _sd(3.0)["w"])


def _mixed():
    rs = np.random.RandomState(4)
    w = rs.randn(5, 6).astype(np.float32)
    return w, {"param.w": w, "param.b16": w[:2],
               "opt.step": np.int32(11), "buffer.mask": w[0] > 0}


def test_jax_checkpoint_loads_into_the_port_bit_for_bit(tmp_path):
    """The JAX writer (bf16 through ml_dtypes) and the port's reader: the
    same values bit for bit, and the port rewrites the same bytes."""
    w, vals = _mixed()
    jsd = {"param.w": Tensor(jnp.asarray(w)),
           "param.b16": Tensor(jnp.asarray(w[:2], jnp.bfloat16)),
           "opt.step": Tensor(jnp.asarray(11, jnp.int32)),
           "buffer.mask": Tensor(jnp.asarray(vals["buffer.mask"]))}
    JC.save_state_dict(jsd, str(tmp_path / "jax"))
    tsd = {"param.w": torch.zeros(5, 6),
           "param.b16": torch.zeros(2, 6, dtype=torch.bfloat16),
           "opt.step": torch.tensor(0, dtype=torch.int32),
           "buffer.mask": torch.zeros(6, dtype=torch.bool)}
    TC.load_state_dict(tsd, str(tmp_path / "jax"))
    assert torch.equal(tsd["param.w"], torch.from_numpy(w))
    jb = np.asarray(jsd["param.b16"]._value).view(np.uint16)
    assert np.array_equal(tsd["param.b16"].view(torch.int16).numpy()
                          .view(np.uint16), jb)
    assert int(tsd["opt.step"]) == 11
    assert torch.equal(tsd["buffer.mask"],
                       torch.from_numpy(vals["buffer.mask"]))
    TC.save_state_dict(tsd, str(tmp_path / "port"))
    for name in ("0.distcp",):
        with open(tmp_path / "jax" / name, "rb") as a, \
                open(tmp_path / "port" / name, "rb") as b:
            assert a.read() == b.read()
    jm = JC.api._load_metadata(str(tmp_path / "jax"))
    tm = TC.api._load_metadata(str(tmp_path / "port"))
    assert {k: (tuple(v["global_shape"]), v["dtype"])
            for k, v in jm.state_dict_metadata.items()} == \
        {k: (tuple(v["global_shape"]), v["dtype"])
         for k, v in tm.state_dict_metadata.items()}


def test_port_checkpoint_loads_into_jax_bit_for_bit(tmp_path):
    w, vals = _mixed()
    tsd = {"param.w": torch.from_numpy(w),
           "param.b16": torch.from_numpy(w[:2]).to(torch.bfloat16),
           "opt.step": torch.tensor(11, dtype=torch.int32),
           "buffer.mask": torch.from_numpy(vals["buffer.mask"])}
    TC.save_state_dict(tsd, str(tmp_path))
    assert JC.verify_checkpoint(str(tmp_path))["unverified"] == 0
    jsd = {"param.w": Tensor(jnp.zeros((5, 6), jnp.float32)),
           "param.b16": Tensor(jnp.zeros((2, 6), jnp.bfloat16)),
           "opt.step": Tensor(jnp.asarray(0, jnp.int32)),
           "buffer.mask": Tensor(jnp.zeros((6,), bool))}
    JC.load_state_dict(jsd, str(tmp_path))
    np.testing.assert_array_equal(np.asarray(jsd["param.w"]._value), w)
    assert jsd["param.b16"]._value.dtype == jnp.bfloat16
    assert np.array_equal(
        np.asarray(jsd["param.b16"]._value).view(np.uint16),
        tsd["param.b16"].view(torch.int16).numpy().view(np.uint16))
    assert int(np.asarray(jsd["opt.step"]._value)) == 11
    np.testing.assert_array_equal(np.asarray(jsd["buffer.mask"]._value),
                                  vals["buffer.mask"])


def test_metadata_pickle_names_the_jax_module_and_maps_back():
    """The port writes the JAX package's module name for the metadata
    classes and reads it back as its own copy; unpickling in a fresh
    interpreter with only the port imported pulls in no JAX module."""
    meta = TC.Metadata()
    meta.storage_metadata[TC.LocalTensorIndex("a", (0,))] = {"nbytes": 4}
    buf = io.BytesIO()
    TP.dump(meta, buf)
    raw = buf.getvalue()
    assert b"paddle_tpu.distributed.checkpoint.metadata" in raw
    assert b"paddle_tpu_torch" not in raw
    back = TP.load(io.BytesIO(raw))
    assert type(back) is TC.Metadata
    assert back.storage_metadata[TC.LocalTensorIndex("a", (0,))] == \
        {"nbytes": 4}
    jax_side = pickle.loads(raw)
    assert type(jax_side) is JC.Metadata
    code = textwrap.dedent(f"""
        import io, sys
        from paddle_tpu_torch.distributed.checkpoint import _pickle
        m = _pickle.load(io.BytesIO({raw!r}))
        assert type(m).__module__.startswith("paddle_tpu_torch"), m
        bad = [k for k in sys.modules
               if k.split(".")[0] in ("jax", "paddle_tpu", "ml_dtypes")]
        sys.exit(1 if bad else 0)
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


# ------------------------------------------------------------ watchdog
def test_watchdog_stall_dumps_and_rearms(tmp_path):
    flight.record("pre_stall_marker", detail=1)
    stalls = []
    wd = Watchdog(timeout=0.15, poll=0.03, dump_dir=str(tmp_path),
                  on_stall=stalls.append, name="t")
    with wd:
        wd.beat()
        deadline = time.time() + 5.0
        while not stalls and time.time() < deadline:
            time.sleep(0.02)
    assert stalls, "watchdog never tripped"
    assert wd.trips >= 1
    dump_path, _ = wd.last_dump
    assert dump_path and os.path.exists(dump_path)
    with open(dump_path) as f:
        assert "watchdog_stall" in f.read()
    wd.stop()
    wd.stop()


def test_watchdog_fed_by_step_timer():
    from paddle_tpu_torch.observability import StepTimer, step_stats

    clock = {"t": 0.0}
    wd = Watchdog(timeout=60.0, clock=lambda: clock["t"],
                  name="timer-fed").watch_step_timer()
    try:
        wd.beat()
        clock["t"] += 10.0
        assert wd.stalled_for() == 10.0
        t = StepTimer(run_id="wd-test", read_device_memory=False)
        t.record(0.01)
        assert wd.stalled_for() == 0.0
    finally:
        wd.stop()
    assert wd._hook is None and not step_stats._record_hooks


def test_watchdog_check_raises():
    clock = {"t": 0.0}
    wd = Watchdog(timeout=1.0, clock=lambda: clock["t"], name="sync")
    wd.beat()
    clock["t"] += 5.0
    with pytest.raises(WatchdogStall):
        wd.check()
    assert wd.trips == 1


def test_step_timer_reads_no_device_memory_on_the_cpu():
    """The port's `_device_peak_bytes` reads the CUDA allocator, and on a
    host without CUDA nothing: no record carries a peak."""
    from paddle_tpu_torch.observability import StepTimer, step_stats

    if not torch.cuda.is_available():
        assert step_stats._device_peak_bytes() is None
    t = StepTimer(run_id="mem", tokens_per_step=100)
    rec = t.record(0.5, n_steps=2)
    assert rec["tokens_per_s"] == 400.0 and rec["n_steps"] == 2
    assert ("peak_bytes_in_use" in rec) == torch.cuda.is_available()
    assert not step_stats.validate_stream(t.records)


# ------------------------------------------------------------ telemetry
def test_attach_declares_the_training_keys_jax_declares():
    from paddle_tpu import observability as JO
    from paddle_tpu_torch import observability as TO

    keys = [("resilience.faults", {"point": "train.step"}),
            ("resilience.faults", {"point": "checkpoint.write"}),
            ("resilience.skipped_steps", {"source": "guard"}),
            ("resilience.skipped_steps", {"source": "amp"}),
            ("resilience.skipped_steps", {"source": "amp_floor"}),
            ("resilience.rollbacks", {}), ("resilience.watchdog_trips", {}),
            ("preemption.checkpoints", {})]
    for key in keys:
        assert key in TO._SCHEMA_COUNTERS and key in JO._SCHEMA_COUNTERS
    TO.attach(crash_hook=False)
    try:
        counters = TO.metrics.snapshot()["counters"]
        for name, _ in keys:
            assert any(k.startswith(name) for k in counters), name
    finally:
        TO.detach()
