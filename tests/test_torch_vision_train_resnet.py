"""ResNet-18's cases of the vision train step's 5-step trajectory against
the JAX `build_train_step` (``tests/test_torch_vision_train.py`` (e),
whose `check_trajectory` they run): f32 and bf16 O2, with the running
statistics after the steps.  A file of their own so that the tier-1
suite, one file to a worker, spreads their ~200 s over another worker.
"""
from __future__ import annotations

import pytest

from test_torch_vision_train import (  # noqa: F401
    TRAIN_TOL, _no_launches, check_trajectory,
)
import torch

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)


@pytest.mark.parametrize("name,amp", [k for k in sorted(TRAIN_TOL, key=str)
                                      if k[0] == "resnet18"])
def test_vision_train_step_trajectory_matches_jax(name, amp):
    check_trajectory(name, amp)
