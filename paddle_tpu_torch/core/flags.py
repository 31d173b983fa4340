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


# paddle.set_flags / get_flags (``paddle_tpu/core/flags.py:131-140``).
# The port keeps only the flags it honours: FLAGS_flash_layout, which
# the attention dispatch reads from the environment at each call (so
# set_flags writes it there).  FLAGS_check_nan_inf, the JAX package's
# nan/inf watcher, is not ported: it reads False and set_flags refuses
# to turn it on.  set_flags refuses every other flag (the JAX package's
# Pallas switches among them), since nothing here would read it
# (ROADMAP C2.47).
_ENV_FLAGS = ("FLAGS_flash_layout",)
_OFF_FLAGS = {"FLAGS_check_nan_inf": False}
_FALSE = (False, 0, "0", "false", "False")


def set_flags(d: dict):
    for k, v in d.items():
        if k in _OFF_FLAGS:
            if v not in _FALSE:
                raise NotImplementedError(
                    f"{k} is not ported: the port has no nan/inf watcher")
        elif k not in _ENV_FLAGS:
            raise ValueError(f"unknown flag {k!r}: the port honours "
                             f"{sorted(_ENV_FLAGS + tuple(_OFF_FLAGS))}")
    for k, v in d.items():
        if k in _ENV_FLAGS:
            os.environ[k] = str(v)


def get_flags(keys=None):
    if keys is None:
        keys = sorted(_ENV_FLAGS + tuple(_OFF_FLAGS))
    elif isinstance(keys, str):
        keys = [keys]
    return {k: os.environ.get(k) if k in _ENV_FLAGS else _OFF_FLAGS.get(k)
            for k in keys}
