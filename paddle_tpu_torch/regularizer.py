"""paddle.regularizer counterpart (``paddle_tpu/regularizer.py``): the
L1 / L2 weight-decay descriptors the optimizers read (an `L2Decay`'s
coefficient is the decay of the rule; an `L1Decay` applies nothing, as
in the JAX package)."""
from .optimizer.optimizer import L1Decay, L2Decay  # noqa: F401


class WeightDecayRegularizer:
    """Base marker class (reference `python/paddle/regularizer.py:23`)."""


L1DecayRegularizer = L1Decay
L2DecayRegularizer = L2Decay

__all__ = ["L1Decay", "L2Decay", "WeightDecayRegularizer"]
