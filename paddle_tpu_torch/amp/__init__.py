"""AMP (``paddle_tpu/amp/__init__.py`` counterpart: `auto_cast` :83 and
`amp_guard`, `decorate` :102, `is_float16_supported` /
`is_bfloat16_supported`, `debugging` :131; `GradScaler` in
`grad_scaler`).

`auto_cast` sets the cast gate (`amp.gate`) that the port's listed ops
call under the JAX op names: white-listed ops run in the AMP dtype,
black-listed ones in f32, every other op in its inputs' dtypes, with
the custom lists moving names between the two.  ``level`` is stored and
not read by the gate, so O1 and O2 cast alike inside `auto_cast`, as in
the JAX package.  `decorate(level="O2")` casts the models' floating
parameters and buffers to the AMP dtype and turns on the optimizers'
``multi_precision`` f32 masters.

In float16 every op of the path must take float16: the flash kernels do
(causal, full and biased); a kernel that does not raises TypeError
rather than compute in another dtype.
"""
from __future__ import annotations

import contextlib

import torch

from . import gate as _gate
from .gate import BLACK_LIST, WHITE_LIST  # noqa: F401
from .grad_scaler import GradScaler, OptimizerState  # noqa: F401

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler",
           "OptimizerState", "is_float16_supported", "is_bfloat16_supported",
           "debugging", "WHITE_LIST", "BLACK_LIST"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def _dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    key = str(dtype).lower().replace("torch.", "")
    if key not in _DTYPES:
        raise ValueError(f"Unknown AMP dtype: {dtype!r}")
    return _DTYPES[key]


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """Inside the block the gated ops run at the AMP dtypes; the gate's
    earlier state comes back after it."""
    st = _gate.state
    old = (st.enabled, st.level, st.dtype, st.custom_white, st.custom_black)
    st.enabled = enable
    st.level = level
    st.dtype = _dtype(dtype)
    st.custom_white = frozenset(custom_white_list or ())
    st.custom_black = frozenset(custom_black_list or ())
    try:
        yield
    finally:
        (st.enabled, st.level, st.dtype, st.custom_white,
         st.custom_black) = old


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False):
    """O2: cast the models' floating parameters and buffers to `dtype`
    (in place of their data: the Parameter objects an optimizer holds
    stay theirs) and give the optimizers f32 master weights
    (``multi_precision``).  Returns the models, and the optimizers when
    given."""
    dtype = _dtype(dtype)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        for m in model_list:
            m.to(dtype=dtype)
        if optimizers is not None:
            opts = [optimizers] if not isinstance(optimizers, (list, tuple)) \
                else optimizers
            for o in opts:
                o._multi_precision = True if master_weight is None \
                    else master_weight
    if optimizers is None:
        return models
    return models, optimizers


def is_float16_supported(device=None):
    return True


def is_bfloat16_supported(device=None):
    return True


class debugging:
    """``paddle.amp.debugging`` (JAX :131-199): `check_numerics` and the
    operator-stats collection (counted at the cast gate: (op, output
    dtype) of each gated op)."""

    @staticmethod
    def check_numerics(tensor, op_type="", var_name="", debug_mode=None):
        """Raise FloatingPointError if `tensor` holds a NaN or an Inf (one
        host read)."""
        n_nan = int(torch.isnan(tensor).sum())
        n_inf = int(torch.isinf(tensor).sum())
        if n_nan or n_inf:
            raise FloatingPointError(
                f"check_numerics failed for {op_type}:{var_name}: "
                f"{n_nan} NaN, {n_inf} Inf")
        return True

    @classmethod
    def enable_operator_stats_collection(cls):
        _gate.stats = {}

    @classmethod
    def disable_operator_stats_collection(cls):
        """Stop collecting; print and return {op: {dtype: count}}."""
        stats, _gate.stats = _gate.stats or {}, None
        by_op = {}
        for (name, dtype), cnt in sorted(stats.items()):
            by_op.setdefault(name, {})[dtype] = cnt
        if by_op:
            print("<------------------- op list ------------------->")
            for name, dts in by_op.items():
                print(f"  {name}: " + ", ".join(
                    f"{d}={c}" for d, c in dts.items()))
        return by_op

    @classmethod
    @contextlib.contextmanager
    def collect_operator_stats(cls):
        cls.enable_operator_stats_collection()
        try:
            yield
        finally:
            cls.disable_operator_stats_collection()
