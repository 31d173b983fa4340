"""``paddle_tpu/jit`` counterpart: `to_static` and `StaticFunction`, a
function or a layer's forward replayed as one CUDA graph per input
signature (`api.py`)."""
from __future__ import annotations

from .api import StaticFunction, to_static

__all__ = ["StaticFunction", "to_static"]
