"""Python wrapper over the native shared-memory ring + multiprocess
DataLoader workers (``paddle_tpu/io/shm_queue.py`` counterpart;
reference role: multiprocess dataloader_iter with mmap-allocator tensor
transport, `python/paddle/io/dataloader/dataloader_iter.py:358`).

A copy of the JAX module but for `run_process_workers`, which spawns
its workers without the JAX package's accelerator environment (a
spawned interpreter imports torch, which claims no card until a tensor
is put on one), and the numpy trees, whose tensors are torch's: a
worker ships each collated batch as numpy arrays through the ring (the
port's ``native/src/shm_ring.cc``), and the parent rebuilds CPU torch
tensors on them without a copy.
"""
from __future__ import annotations

import os
import pickle
import uuid

from .. import native
from ..observability import metrics as _metrics


class ShmQueue:
    """Fixed-slot shared-memory message queue usable across fork()."""

    def __init__(self, n_slots=8, slot_size=32 << 20, name=None, create=True):
        self.lib = native.load()
        self.name = (name or f"/ptpu_{os.getpid()}_{uuid.uuid4().hex[:8]}")
        self._owner = create
        if create:
            self.ring = self.lib.shm_ring_create(
                self.name.encode(), n_slots, slot_size)
        else:
            self.ring = self.lib.shm_ring_attach(self.name.encode())
        if not self.ring:
            raise OSError(f"shm ring setup failed for {self.name}")
        self.slot_size = int(self.lib.shm_ring_slot_size(self.ring))
        self._buf = None  # lazy reusable pop buffer (hot path: no per-pop
                          # slot_size alloc+memset)

    def attach(self):
        return ShmQueue(name=self.name, create=False)

    def put(self, obj, timeout=60.0):
        payload = pickle.dumps(obj, protocol=4)
        if len(payload) > self.slot_size:
            raise ValueError(
                f"message of {len(payload)}B exceeds slot size "
                f"{self.slot_size}B; raise slot_size")
        rc = self.lib.shm_ring_push(self.ring, payload, len(payload),
                                    float(timeout))
        if rc == -1:
            raise TimeoutError("shm push timeout")
        if rc == -2:
            raise BrokenPipeError("shm ring closed")

    def get(self, timeout=60.0):
        import ctypes

        if self._buf is None:
            self._buf = ctypes.create_string_buffer(self.slot_size)
        n = self.lib.shm_ring_pop(self.ring, self._buf, self.slot_size,
                                  float(timeout))
        if n == -1:
            raise TimeoutError("shm pop timeout")
        if n == -2:
            raise EOFError("shm ring closed and drained")
        return pickle.loads(ctypes.string_at(self._buf, n))

    def qsize(self):
        return int(self.lib.shm_ring_count(self.ring))

    def close(self):
        self.lib.shm_ring_close(self.ring)

    def __del__(self):
        try:
            if getattr(self, "ring", None):
                self.lib.shm_ring_detach(self.ring)
                if self._owner:
                    self.lib.shm_ring_unlink(self.name.encode())
        except Exception:
            # module-top import on purpose: importing inside a __del__
            # handler can itself raise at interpreter shutdown
            _metrics.inc("io.shm_del_errors")


def _worker_main(dataset, batches, indices, collate_path, queue_name,
                 worker_init_fn, wid):
    """Spawned worker entry: fetch+collate assigned batches into the ring.
    Exceptions are shipped back through the ring (index -1) so the parent
    surfaces the real dataset error instead of timing out."""
    import importlib
    import traceback

    q = ShmQueue(name=queue_name, create=False)
    try:
        mod_name, fn_name = collate_path
        collate_fn = getattr(importlib.import_module(mod_name), fn_name)
        if worker_init_fn is not None:
            worker_init_fn(wid)
        for i in indices:
            samples = [dataset[j] for j in batches[i]]
            payload = _to_numpy_tree(collate_fn(samples))
            q.put((i, payload))
    except Exception:
        q.put((-1, f"DataLoader worker {wid} died:\n"
                   f"{traceback.format_exc()}"))
        raise


def run_process_workers(dataset, batches, collate_fn, num_workers,
                        queue_slots=8, slot_size=32 << 20,
                        worker_init_fn=None):
    """Spawned worker processes fetch+collate batches into the shm ring;
    yields batches in order. True multiprocess loading: the transport is the
    native ring (no pipe/pickle through the parent's GIL); spawn (not fork)
    keeps a parent with CUDA and threads safe."""
    import multiprocessing as mp

    # validation + native load + spawn happen eagerly at call time (NOT
    # inside the generator) so DataLoader.__iter__ can catch OSError /
    # ValueError and fall back to thread workers
    collate_path = (collate_fn.__module__, collate_fn.__qualname__)
    if "." in collate_path[1] or "<" in collate_path[1]:
        raise ValueError(
            "collate_fn must be a module-level function for process workers")

    q = ShmQueue(n_slots=queue_slots, slot_size=slot_size)
    n = len(batches)
    ctx = mp.get_context("spawn")
    procs = []
    for w in range(num_workers):
        idxs = list(range(w, n, num_workers))
        p = ctx.Process(target=_worker_main,
                        args=(dataset, batches, idxs, collate_path,
                              q.name, worker_init_fn, w), daemon=True)
        p.start()
        procs.append(p)

    return _consume(q, procs, n)


def _consume(q, procs, n, deadline_s=300.0):
    import time

    pending = {}
    next_idx = 0
    received = 0
    deadline = time.monotonic() + deadline_s
    try:
        while received < n:
            try:
                # short poll so worker death is noticed promptly; the
                # deadline bounds total wait even if workers stay alive
                i, payload = q.get(timeout=5.0)
                deadline = time.monotonic() + deadline_s
            except TimeoutError:
                crashed = [p for p in procs
                           if not p.is_alive() and p.exitcode not in (0, None)]
                if crashed and q.qsize() == 0:
                    raise RuntimeError(
                        f"DataLoader worker(s) "
                        f"{[p.pid for p in crashed]} exited with "
                        f"{[p.exitcode for p in crashed]} before finishing")
                if q.qsize() == 0 and not any(p.is_alive() for p in procs):
                    raise RuntimeError(
                        f"DataLoader workers all exited but only "
                        f"{received}/{n} batches arrived")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"DataLoader stalled: {received}/{n} batches after "
                        f"{deadline_s:.0f}s without progress")
                continue
            if i == -1:  # worker shipped its traceback
                raise RuntimeError(payload)
            pending[i] = payload
            received += 1
            while next_idx in pending:
                yield _from_numpy_tree(pending.pop(next_idx))
                next_idx += 1
    finally:
        q.close()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()


def _to_numpy_tree(obj):
    import numpy as np
    import torch

    if isinstance(obj, torch.Tensor):
        return ("T", obj.numpy())
    if isinstance(obj, np.ndarray):
        return ("T", obj)
    if isinstance(obj, (list, tuple)):
        return ("L", type(obj).__name__,
                [_to_numpy_tree(v) for v in obj])
    if isinstance(obj, dict):
        return ("D", {k: _to_numpy_tree(v) for k, v in obj.items()})
    return ("V", obj)


def _from_numpy_tree(node):
    import torch

    tag = node[0]
    if tag == "T":
        return torch.from_numpy(node[1])
    if tag == "L":
        seq = [_from_numpy_tree(v) for v in node[2]]
        return tuple(seq) if node[1] == "tuple" else seq
    if tag == "D":
        return {k: _from_numpy_tree(v) for k, v in node[1].items()}
    return node[1]
