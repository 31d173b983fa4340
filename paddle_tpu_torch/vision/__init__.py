"""Vision of the port (``paddle_tpu/vision`` counterpart): the models
only; transforms, datasets and the detection ops are not ported yet."""
from __future__ import annotations

from . import models  # noqa: F401
