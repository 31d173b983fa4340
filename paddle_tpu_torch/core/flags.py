"""Environment knobs and modes read on the ported path.

`_env_num` (the JAX package keeps it in ``resilience/overload.py``),
used by `EngineConfig` for its ``PADDLE_TPU_ENGINE_*`` defaults and by
the engine's timeline cap; and the static-mode bit that
`paddle_tpu_torch.enable_static()` sets (`static.recorder`).
"""
from __future__ import annotations

import os
import threading


def _env_num(var, default, cast):
    raw = os.environ.get(var)
    if raw is None or raw == "":
        return default
    try:
        return cast(raw)
    except ValueError:
        raise ValueError(f"{var} must parse as {cast.__name__}, "
                         f"got {raw!r}") from None


# paddle.enable_static() graph-build mode (``paddle_tpu/core/flags.py``
# :19, :56-61): a per-thread bit.  The port has no trace mode (no
# `jax.jit` tracing), so static mode is the bit alone.
class _State(threading.local):
    def __init__(self):
        self.static_mode = False


_state = _State()


def in_static_mode() -> bool:
    return _state.static_mode


def set_static_mode(on: bool):
    _state.static_mode = bool(on)
