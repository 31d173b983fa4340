"""DataLoader (``paddle_tpu/io/dataloader.py`` counterpart; paddle.io.
DataLoader parity: `python/paddle/io/reader.py:216`, iterators
`dataloader_iter.py:150,358`).

Collation builds CPU torch tensors from numpy (`default_collate_fn`),
keeping numpy's dtypes.  Each batch then reaches the loader's device in
one copy: its tensors are packed into one pinned host buffer, copied
with one asynchronous host-to-device copy, and handed out as views of
the device buffer.  That takes the place of the JAX package's one
`jax.device_put` per batch.  The loader runs on the CUDA device unless
the caller passes ``device="cpu"``; on the CPU the collated tensors are
the batch.

Workers: with ``num_workers > 0`` and ``use_shared_memory`` (the
default), spawned worker processes fetch and collate batches into the
native shared-memory ring (`shm_queue.py`); where that route cannot
start (no `g++` to build the ring, a `collate_fn` that is not a
module-level function), thread workers prefetch instead, as in the JAX
package (:117-129).  `route` names the route of the newest iterator:
``"shm"``, ``"threads"`` or ``"single"``.

Each fetch passes the `dataloader.batch` fault point and retries under
the `dataloader` policy (`resilience`), as in JAX (:22-41).
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch
from torch.utils import _pytree

from ..core.device import resolve_device
from .dataset import IterableDataset
from .sampler import BatchSampler

_ALIGN = 64     # bytes between the tensors packed into one copy


def _fetch_retry():
    """Retry policy for `dataloader.batch`: a flaky storage read (or an
    injected fault) re-fetches the same indices instead of killing the
    epoch.  PADDLE_TPU_DATALOADER_RETRIES tunes attempts (default 2)."""
    from ..resilience.retry import env_policy

    return env_policy(
        "dataloader", "PADDLE_TPU_DATALOADER_RETRIES", 2,
        base_delay=0.01, max_delay=0.2,
        # deterministic dataset bugs (bad index math, type errors in
        # collate) fail the same way twice — don't re-fetch.  ValueError
        # is DELIBERATELY retryable here: truncated/corrupt reads often
        # surface as decode ValueErrors and deserve one re-fetch.
        give_up_on=(TypeError, KeyError, AttributeError, IndexError))


def _fire_batch_fault(n):
    from ..resilience import faults as _faults

    _faults.fire("dataloader.batch", n=int(n))


def default_collate_fn(batch):
    """Stack a list of samples into a batch of CPU tensors, structure by
    structure (tuples, lists and dicts of tensors, arrays or numbers);
    strings stay a list."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack([b.cpu() for b in batch])
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return torch.from_numpy(np.asarray(batch))
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn([b[i] for b in batch])
                            for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, str):
        return list(batch)
    return torch.from_numpy(np.asarray(batch))


def to_device(batch, device):
    """The tensors of `batch` (any nesting of lists, tuples and dicts) on
    `device` in one copy: packed into one pinned buffer, copied
    asynchronously, split into views.  Other leaves stay as they are; on
    the CPU the batch is returned as it is."""
    leaves, spec = _pytree.tree_flatten(batch)
    idx = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
    if device.type == "cpu" or not idx:
        return batch
    offs, total = [], 0
    for i in idx:
        offs.append(total)
        nbytes = leaves[i].numel() * leaves[i].element_size()
        total += -(-nbytes // _ALIGN) * _ALIGN
    host = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=True)
    for i, off in zip(idx, offs):
        t = leaves[i].contiguous().reshape(-1).view(torch.uint8)
        host[off:off + t.numel()].copy_(t)
    dev = host.to(device, non_blocking=True)
    for i, off in zip(idx, offs):
        t = leaves[i]
        nbytes = t.numel() * t.element_size()
        leaves[i] = dev[off:off + nbytes].view(t.dtype).view(t.shape)
    return _pytree.tree_unflatten(leaves, spec)


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, device=None):
        self.dataset = dataset
        self.device = resolve_device(device)
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.use_shared_memory = use_shared_memory
        self.prefetch_factor = max(2, prefetch_factor)
        self.worker_init_fn = worker_init_fn
        self.route = None
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif batch_size is None:
            self.batch_sampler = None
            self.batch_size = None
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no deterministic length")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def _fetch(self, indices):
        def _once():
            _fire_batch_fault(len(indices))
            samples = [self.dataset[i] for i in indices]
            return self.collate_fn(samples)

        return _fetch_retry().call(_once)

    def _iter_single(self):
        if self._iterable_mode:
            batch = []
            for sample in self.dataset:
                batch.append(sample)
                if len(batch) == self.batch_size:
                    # fault point only (no retry: an iterable source
                    # cannot be re-asked for the same items)
                    _fire_batch_fault(len(batch))
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                _fire_batch_fault(len(batch))
                yield self.collate_fn(batch)
            return
        if self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield self.dataset[i]
            return
        for indices in self.batch_sampler:
            yield self._fetch(indices)

    def _iter_workers(self):
        """Thread-pool prefetch: index batches fan out to workers; results are
        re-ordered to preserve determinism."""
        assert not self._iterable_mode, \
            "num_workers>0 with IterableDataset not supported yet"
        index_q = queue.Queue()
        out_q = queue.Queue(maxsize=self.num_workers * self.prefetch_factor)
        batches = list(self.batch_sampler)
        for i, b in enumerate(batches):
            index_q.put((i, b))
        stop = object()

        def worker(wid):
            if self.worker_init_fn is not None:
                self.worker_init_fn(wid)
            while True:
                try:
                    i, idxs = index_q.get_nowait()
                except queue.Empty:
                    out_q.put(stop)
                    return
                try:
                    out_q.put((i, self._fetch(idxs)))
                except Exception as e:  # surface worker errors
                    out_q.put((i, e))

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        pending = {}
        next_idx = 0
        finished_workers = 0
        total = len(batches)
        while next_idx < total:
            item = out_q.get()
            if item is stop:
                finished_workers += 1
                if finished_workers == len(threads) and next_idx < total \
                        and not pending:
                    break
                continue
            i, data = item
            if isinstance(data, Exception):
                raise data
            pending[i] = data
            while next_idx in pending:
                yield pending.pop(next_idx)
                next_idx += 1

    def _batches(self):
        if self.num_workers > 0 and self.use_shared_memory and \
                not self._iterable_mode and self.batch_sampler is not None:
            # process workers + native shm ring (GIL-free transport)
            from .shm_queue import run_process_workers

            try:
                it = run_process_workers(
                    self.dataset, list(self.batch_sampler), self.collate_fn,
                    self.num_workers, worker_init_fn=self.worker_init_fn)
                self.route = "shm"
                return it
            except (OSError, ValueError):
                # no native toolchain / non-module-level collate_fn:
                # fall through to thread workers
                pass
        if self.num_workers > 0:
            self.route = "threads"
            return self._iter_workers()
        self.route = "single"
        return self._iter_single()

    def __iter__(self):
        batches = self._batches()
        # without a batch sampler the dataset's own samples come out
        raw = self.batch_sampler is None and not self._iterable_mode
        if self.device.type == "cpu" or raw:
            return batches
        return (to_device(b, self.device) for b in batches)


def get_worker_info():
    """paddle.io.get_worker_info: None in the main process; the worker
    processes set no info either, as in the JAX package."""
    return None
