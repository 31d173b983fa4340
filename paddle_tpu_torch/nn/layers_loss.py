"""CrossEntropyLoss (``paddle_tpu/nn/layers_loss.py:21`` counterpart)."""
from __future__ import annotations

from torch import nn

from .functional.loss import cross_entropy


class CrossEntropyLoss(nn.Module):
    """`cross_entropy` of the input against the label with the layer's
    arguments, every option of the JAX layer."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return cross_entropy(input, label, self.weight, self.ignore_index,
                             self.reduction, self.soft_label, self.axis,
                             self.use_softmax, self.label_smoothing)
