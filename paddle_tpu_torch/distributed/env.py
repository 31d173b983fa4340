"""Distributed environment (``paddle_tpu/distributed/env.py``
counterpart; parity: `paddle.distributed.parallel.ParallelEnv` + launcher
env conventions `PADDLE_TRAINER_*`).

The launcher's variables come first, as in the JAX package; without them
a rank and a world size come from `torch.distributed` when a process
group is initialized (JAX asks `jax.process_index()` / `process_count()`),
else 0 and 1.  `ParallelEnv` is a copy of the JAX class.
"""
from __future__ import annotations

import os

import torch.distributed as dist


def _group_initialized():
    return dist.is_available() and dist.is_initialized()


def get_rank(group=None):
    if group is not None:
        return group.get_rank()
    n = os.environ.get("PADDLE_TRAINER_ID")
    if n is not None:
        return int(n)
    if _group_initialized():
        return dist.get_rank()
    return 0


def get_world_size(group=None):
    if group is not None:
        return group.get_world_size()
    n = os.environ.get("PADDLE_TRAINERS_NUM")
    if n is not None:
        return int(n)
    if _group_initialized():
        return dist.get_world_size()
    return 1


class ParallelEnv:
    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def local_rank(self):
        return int(os.environ.get("PADDLE_LOCAL_RANK", 0))

    @property
    def dev_id(self):
        return self.local_rank

    @property
    def nranks(self):
        return self.world_size

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:6170")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else [self.current_endpoint]
