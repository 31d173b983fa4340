"""Optimizers of the port (``paddle_tpu/optimizer`` counterpart)."""
from __future__ import annotations

from . import lr  # noqa: F401
from .optimizer import (  # noqa: F401
    LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, L1Decay, L2Decay,
    Lamb, Momentum, Optimizer, RMSProp, Rprop,
)

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "Adam", "AdamW",
           "Adamax", "RMSProp", "Lamb", "Adadelta", "Rprop", "LBFGS",
           "L1Decay", "L2Decay", "lr"]
