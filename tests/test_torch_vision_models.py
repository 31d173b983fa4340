"""ResNet-50's, ResNeXt-50's and the two-stage Swin's eval logits
against the JAX models' (``tests/test_torch_vision.py``, whose
`check_eval_logits` they run: the same weights and seeded batch-norm
statistics, 1e-4 of the largest logit).  A file of their own so that the
tier-1 suite, one file to a worker, spreads them over another worker.
"""
from __future__ import annotations

import pytest

from test_torch_vision import (  # noqa: F401
    SPLIT_MODELS, _no_launches, check_eval_logits,
)
import torch

# one intra-op thread a worker: the tier-1 run's xdist workers share
# the host's cores, and torch's default pool (a thread a core in each
# worker) oversubscribes them
torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(SPLIT_MODELS))
def test_model_eval_logits_match_jax(name):
    check_eval_logits(name)
