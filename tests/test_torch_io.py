"""`paddle_tpu_torch.io` against the JAX package's `io`, on the CPU.

The samplers draw from numpy's global generator in both packages, so one
numpy seed gives both the same order.  `DataLoader` batches hold the
same values as the JAX loader's for the same seed with no workers, with
thread workers and with the shared-memory workers (spawned processes
over the native ring, whose route the loader names).  The port keeps
numpy's dtypes (int64 labels stay int64); the JAX loader's tensors are
32-bit where jax runs without x64, so values are compared, not dtypes.
The `dataloader.batch` fault point fires and retries as in JAX, and its
counters are in the telemetry schema.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu.io as JIO
from paddle_tpu.resilience import faults as jfaults

import paddle_tpu_torch.io as TIO
from paddle_tpu_torch.io import dataloader as tdl
from paddle_tpu_torch.resilience import faults as tfaults

torch.set_num_threads(1)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "_value"):
        return np.asarray(x._value)
    return x


def _flat(batch):
    if isinstance(batch, (list, tuple)):
        return [v for b in batch for v in _flat(b)]
    if isinstance(batch, dict):
        return [v for k in sorted(batch) for v in _flat(batch[k])]
    return [_np(batch)]


def _data(n=22, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 3).astype(np.float32),
            rs.randint(0, 5, (n,)).astype(np.int64))


def _same_batches(jit, tit):
    jb, tb = list(jit), list(tit)
    assert len(jb) == len(tb) and jb
    for a, b in zip(jb, tb):
        fa, fb = _flat(a), _flat(b)
        assert len(fa) == len(fb)
        for x, y in zip(fa, fb):
            assert np.array_equal(np.asarray(x), np.asarray(y))
    return tb


@pytest.mark.parametrize("name,kw", [
    ("SequenceSampler", {}),
    ("RandomSampler", {}),
    ("RandomSampler", {"replacement": True, "num_samples": 30}),
    ("SubsetRandomSampler", None),
    ("WeightedRandomSampler", None),
])
def test_sampler_orders_match_jax(name, kw):
    ds = list(range(17))
    order = []
    for mod in (JIO, TIO):
        np.random.seed(3)
        cls = getattr(mod, name)
        if name == "SubsetRandomSampler":
            s = cls([2, 5, 7, 11, 13])
        elif name == "WeightedRandomSampler":
            s = cls([0.1, 0.5, 0.2, 0.2], 12)
        else:
            s = cls(ds, **kw)
        order.append((list(s), len(s)))
    assert order[0] == order[1]


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False),
                                               (True, True)])
def test_batch_sampler_and_random_split_match_jax(shuffle, drop_last):
    got = []
    for mod in (JIO, TIO):
        np.random.seed(4)
        bs = mod.BatchSampler(list(range(23)), shuffle=shuffle,
                              batch_size=5, drop_last=drop_last)
        parts = mod.random_split(list(range(10)), [0.3, 0.7])
        got.append((list(bs), len(bs), [list(p.indices) for p in parts]))
    assert got[0] == got[1]


@pytest.mark.parametrize("shuffle", [False, True])
def test_distributed_batch_sampler_shards_like_jax(shuffle):
    shards = []
    for mod in (JIO, TIO):
        mine = []
        for rank in range(3):
            s = mod.DistributedBatchSampler(list(range(20)), batch_size=3,
                                            num_replicas=3, rank=rank,
                                            shuffle=shuffle)
            s.set_epoch(2)
            mine.append((list(s), len(s), list(s)))
        shards.append(mine)
    assert shards[0] == shards[1]
    # the ranks cover the padded dataset once
    seen = sorted(i for _, _, bat in shards[1][:1] for b in bat for i in b)
    assert len(seen) == 7


def test_distributed_batch_sampler_reads_the_launcher_env(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    j = JIO.DistributedBatchSampler(list(range(9)), batch_size=2)
    t = TIO.DistributedBatchSampler(list(range(9)), batch_size=2)
    assert (t.local_rank, t.nranks) == (1, 2)
    assert list(t) == list(j)
    monkeypatch.delenv("PADDLE_TRAINER_ID")
    monkeypatch.delenv("PADDLE_TRAINERS_NUM")
    from paddle_tpu_torch.distributed import env

    # no launcher and no process group: rank 0 of 1
    assert (env.get_rank(), env.get_world_size()) == (0, 1)
    assert env.ParallelEnv().nranks == 1


@pytest.mark.parametrize("workers,shm,route", [
    (0, True, "single"), (2, False, "threads"), (2, True, "shm")])
@pytest.mark.parametrize("shuffle", [False, True])
def test_dataloader_batches_match_jax(workers, shm, route, shuffle):
    x, y = _data()
    np.random.seed(7)
    jl = JIO.DataLoader(JIO.TensorDataset([x, y]), batch_size=4,
                        shuffle=shuffle, num_workers=workers,
                        use_shared_memory=shm)
    jb = list(jl)
    np.random.seed(7)
    tl = TIO.DataLoader(TIO.TensorDataset([x, y]), batch_size=4,
                        shuffle=shuffle, num_workers=workers,
                        use_shared_memory=shm, device="cpu")
    tb = _same_batches(jb, tl)
    assert tl.route == route and len(tl) == len(jl) == 6
    for xs, ys in tb:
        assert xs.dtype == torch.float32 and ys.dtype == torch.int64
        assert xs.device.type == "cpu"


def test_dataloader_collates_structures_like_jax():
    class Pairs(JIO.Dataset):
        def __len__(self):
            return 6

        def __getitem__(self, i):
            return {"x": np.full(2, i, np.float32), "id": i,
                    "pair": (float(i) / 2, np.int64(i))}

    class TPairs(TIO.Dataset):
        __len__ = Pairs.__len__
        __getitem__ = Pairs.__getitem__

    tb = _same_batches(JIO.DataLoader(Pairs(), batch_size=4),
                       TIO.DataLoader(TPairs(), batch_size=4, device="cpu"))
    assert set(tb[0]) == {"x", "id", "pair"}
    assert tb[0]["x"].shape == (4, 2) and tb[1]["x"].shape == (2, 2)
    assert tb[0]["pair"][0].dtype == torch.float64     # numpy's own dtype


def test_dataloader_iterable_dataset_matches_jax():
    class Stream(JIO.IterableDataset):
        def __iter__(self):
            return iter(np.arange(11, dtype=np.float32).reshape(11, 1))

    class TStream(TIO.IterableDataset):
        __iter__ = Stream.__iter__

    for drop_last in (False, True):
        _same_batches(JIO.DataLoader(Stream(), batch_size=3,
                                     drop_last=drop_last),
                      TIO.DataLoader(TStream(), batch_size=3,
                                     drop_last=drop_last, device="cpu"))


def test_dataloader_without_batching_yields_samples():
    x, y = _data(5)
    tl = TIO.DataLoader(TIO.TensorDataset([x, y]), batch_size=None,
                        device="cpu")
    jl = JIO.DataLoader(JIO.TensorDataset([x, y]), batch_size=None)
    assert len(tl) == len(jl) == 5
    for (a, b), (c, d) in zip(tl, jl):
        assert np.array_equal(a, c) and b == d


def test_shm_workers_surface_dataset_errors():
    """A worker process that fails ships its traceback through the ring:
    the loader raises it, naming the dataset's error, in both
    packages."""
    x, _ = _data(4)
    for io, kw in ((JIO, {}), (TIO, {"device": "cpu"})):
        ds = io.Subset(io.TensorDataset([x]), [0, 1, 99, 3])
        loader = io.DataLoader(ds, batch_size=2, num_workers=2, **kw)
        with pytest.raises(RuntimeError, match="IndexError"):
            list(loader)
    assert loader.route == "shm"


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_batch_fault_point_retries_like_jax(pkg, monkeypatch):
    """One injected fault at the second fetch: the batch is fetched again
    (three calls of the point for two batches) and the epoch completes
    with the same data, in both packages."""
    io, faults = (JIO, jfaults) if pkg == "jax" else (TIO, tfaults)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    x, y = _data(8)
    faults.clear()
    try:
        with faults.inject("dataloader.batch", at=2):
            got = list(io.DataLoader(io.TensorDataset([x, y]),
                                     batch_size=4, **kw))
        assert faults.call_count("dataloader.batch") == 3
        assert [p for p, _, _ in faults.injected_log()] == \
            ["dataloader.batch"]
    finally:
        faults.clear()
    assert np.array_equal(_np(got[1][0]), x[4:])


def test_batch_fault_point_gives_up_as_jax():
    """Three faults in a row exhaust the two attempts in both
    packages."""
    x, y = _data(4)
    for io, faults, kw in ((JIO, jfaults, {}),
                           (TIO, tfaults, {"device": "cpu"})):
        faults.clear()
        try:
            with faults.inject("dataloader.batch", every=1, times=3):
                with pytest.raises(Exception, match="dataloader.batch"):
                    list(io.DataLoader(io.TensorDataset([x, y]),
                                       batch_size=4, **kw))
        finally:
            faults.clear()


def test_dataloader_keys_are_in_the_telemetry_schema():
    from paddle_tpu import observability as JO
    from paddle_tpu_torch import observability as TO

    for key in [("resilience.faults", {"point": "dataloader.batch"}),
                ("resilience.retries", {"policy": "dataloader"}),
                ("resilience.giveups", {"policy": "dataloader"})]:
        assert key in TO._SCHEMA_COUNTERS and key in JO._SCHEMA_COUNTERS


def test_to_device_on_the_cpu_returns_the_batch():
    batch = (torch.ones(2), {"s": ["a", "b"], "t": torch.zeros(3)})
    assert tdl.to_device(batch, torch.device("cpu")) is batch
    assert TIO.get_worker_info() is None
