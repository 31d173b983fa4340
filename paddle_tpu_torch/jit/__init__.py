"""``paddle_tpu/jit`` counterpart: `to_static` and `StaticFunction`, a
function or a layer's forward replayed as one CUDA graph per input
signature, and `save` / `load` / `TranslatedLayer`, a layer for
deployment as an exported program with its state (`api.py`)."""
from __future__ import annotations

from .api import StaticFunction, TranslatedLayer, load, save, to_static

__all__ = ["StaticFunction", "TranslatedLayer", "load", "save",
           "to_static"]
