"""``paddle_tpu/distributed`` counterpart: the training step (single
device so far), the rendezvous `store` and `fleet.elastic`'s heartbeats
(the serving fleet's liveness plane)."""
from __future__ import annotations

from .train_step import DistributedTrainStep, build_train_step  # noqa: F401

__all__ = ["DistributedTrainStep", "build_train_step"]
