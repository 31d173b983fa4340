"""Environment knobs read on the ported path.

Only what the serving slice reads: `_env_num` (the JAX package keeps it
in ``resilience/overload.py``), used by `EngineConfig` for its
``PADDLE_TPU_ENGINE_*`` defaults and by the engine's timeline cap.
"""
from __future__ import annotations

import os


def _env_num(var, default, cast):
    raw = os.environ.get(var)
    if raw is None or raw == "":
        return default
    try:
        return cast(raw)
    except ValueError:
        raise ValueError(f"{var} must parse as {cast.__name__}, "
                         f"got {raw!r}") from None
