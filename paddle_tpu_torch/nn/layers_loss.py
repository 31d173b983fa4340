"""Loss layers (``paddle_tpu/nn/layers_loss.py`` counterpart): each holds
its options and calls its functional; `HSigmoidLoss` owns the internal
nodes' weight table [num_classes - 1, feature_size] (Paddle's default
initializer) and bias."""
from __future__ import annotations

import torch

from . import functional as F
from .layer_base import Layer

__all__ = [
    "CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
    "BCEWithLogitsLoss", "KLDivLoss", "SmoothL1Loss", "MarginRankingLoss",
    "CosineEmbeddingLoss", "TripletMarginLoss", "SoftMarginLoss",
    "MultiLabelSoftMarginLoss", "HingeEmbeddingLoss", "PoissonNLLLoss",
]


class _LossBase(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction


class CrossEntropyLoss(_LossBase):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__(reduction)
        self.weight = weight
        self.ignore_index = ignore_index
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(input, label, self.weight, self.ignore_index,
                               self.reduction, self.soft_label, self.axis,
                               self.use_softmax, self.label_smoothing)


class MSELoss(_LossBase):
    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(_LossBase):
    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class NLLLoss(_LossBase):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__(reduction)
        self.weight = weight
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return F.nll_loss(input, label, self.weight, self.ignore_index,
                          self.reduction)


class BCELoss(_LossBase):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__(reduction)
        self.weight = weight

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class BCEWithLogitsLoss(_LossBase):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__(reduction)
        self.weight = weight
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class KLDivLoss(_LossBase):
    def __init__(self, reduction="mean", log_target=False):
        super().__init__(reduction)
        self.log_target = log_target

    def forward(self, input, label):
        return F.kl_div(input, label, self.reduction, self.log_target)


class SmoothL1Loss(_LossBase):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__(reduction)
        self.delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class MarginRankingLoss(_LossBase):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__(reduction)
        self.margin = margin

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class CosineEmbeddingLoss(_LossBase):
    def __init__(self, margin=0, reduction="mean", name=None):
        super().__init__(reduction)
        self.margin = margin

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class TripletMarginLoss(_LossBase):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__(reduction)
        self.margin = margin
        self.p = p
        self.epsilon = epsilon
        self.swap = swap

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, self.margin,
                                     self.p, self.epsilon, self.swap,
                                     self.reduction)


class SoftMarginLoss(_LossBase):
    def forward(self, input, label):
        return F.soft_margin_loss(input, label, self.reduction)


class MultiLabelSoftMarginLoss(_LossBase):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__(reduction)
        self.weight = weight

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(input, label, self.weight,
                                              self.reduction)


class HingeEmbeddingLoss(_LossBase):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__(reduction)
        self.margin = margin

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class PoissonNLLLoss(_LossBase):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__(reduction)
        self.log_input = log_input
        self.full = full
        self.epsilon = epsilon

    def forward(self, input, label):
        return F.poisson_nll_loss(input, label, self.log_input, self.full,
                                  self.epsilon, self.reduction)


class CTCLoss(_LossBase):
    """Layer over `F.ctc_loss`."""

    def __init__(self, blank=0, reduction="mean"):
        super().__init__(reduction)
        self.blank = blank

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=self.blank, reduction=self.reduction,
                          norm_by_times=norm_by_times)


class RNNTLoss(_LossBase):
    def __init__(self, blank=0, fastemit_lambda=0.001, reduction="mean"):
        super().__init__(reduction)
        self.blank = blank
        self.fastemit_lambda = fastemit_lambda

    def forward(self, logits, labels, input_lengths, label_lengths):
        return F.rnnt_loss(logits, labels, input_lengths, label_lengths,
                           blank=self.blank, reduction=self.reduction,
                           fastemit_lambda=self.fastemit_lambda)


class HSigmoidLoss(Layer):
    """Layer over `F.hsigmoid_loss`: owns the internal-node weight
    table."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__(dtype=dtype, device=device, generator=generator)
        if is_custom:
            raise NotImplementedError(
                "custom-tree hsigmoid is not wired (default "
                "complete-binary-tree paths only)")
        self.num_classes = num_classes
        self.weight = self.create_parameter([num_classes - 1, feature_size])
        self.bias = None if bias_attr is False else \
            self.create_parameter([num_classes - 1], is_bias=True)

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias)


class MultiMarginLoss(_LossBase):
    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__(reduction)
        self.p = p
        self.margin = margin
        self.weight = weight

    def forward(self, input, label):
        return F.multi_margin_loss(input, label, p=self.p,
                                   margin=self.margin, weight=self.weight,
                                   reduction=self.reduction)


class TripletMarginWithDistanceLoss(_LossBase):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__(reduction)
        self.distance_function = distance_function
        self.margin = margin
        self.swap = swap

    def forward(self, input, positive, negative):
        return F.triplet_margin_with_distance_loss(
            input, positive, negative,
            distance_function=self.distance_function, margin=self.margin,
            swap=self.swap, reduction=self.reduction)


class GaussianNLLLoss(_LossBase):
    def __init__(self, full=False, epsilon=1e-6, reduction="mean",
                 name=None):
        super().__init__(reduction)
        self.full = full
        self.epsilon = epsilon

    def forward(self, input, label, variance):
        return F.gaussian_nll_loss(input, label, variance, full=self.full,
                                   epsilon=self.epsilon,
                                   reduction=self.reduction)


__all__ += ["CTCLoss", "RNNTLoss", "HSigmoidLoss", "MultiMarginLoss",
            "TripletMarginWithDistanceLoss", "GaussianNLLLoss"]
