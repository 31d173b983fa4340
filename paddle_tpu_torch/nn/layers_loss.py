"""CrossEntropyLoss (``paddle_tpu/nn/layers_loss.py:21`` counterpart)."""
from __future__ import annotations

from torch import nn

from .functional.loss import check_ported, cross_entropy


class CrossEntropyLoss(nn.Module):
    """`cross_entropy` of the logits against hard integer labels, with
    the JAX layer's arguments.  The options `cross_entropy` does not
    port raise when the layer is built, not at the first step."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        check_ported(weight, reduction, soft_label, axis, use_softmax,
                     label_smoothing)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return cross_entropy(input, label, ignore_index=self.ignore_index)
