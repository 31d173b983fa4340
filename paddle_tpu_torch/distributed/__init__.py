"""Training step of the port (``paddle_tpu/distributed`` counterpart):
single device so far."""
from __future__ import annotations

from .train_step import DistributedTrainStep, build_train_step  # noqa: F401

__all__ = ["DistributedTrainStep", "build_train_step"]
