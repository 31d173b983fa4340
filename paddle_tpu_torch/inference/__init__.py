"""Serving side of the port: the deployment predictor API (``paddle_tpu/
inference/__init__.py`` counterpart: `Config` :19, `PredictorTensor` :70,
`Predictor` :91, `create_predictor` :128, the constants and helpers
:132-200, `PredictorPool` :202), QoS classes (copy of
``paddle_tpu/inference/qos.py``), the continuous-batching engine, the
HTTP server and client (`serving`), the replica `router` and
`autoscaler` (copies), the replica `fleet` and the Python side of the C
inference ABI (`capi_bridge`).

A `Predictor` loads what `static.save_inference_model` wrote
(`static.load_inference_model`) onto its device: the CUDA device unless
the config says otherwise (`Config.disable_gpu()`; `enable_use_gpu(
device_id=)` picks a card).  Its run is the counterpart of XLA's AOT
executable: on the card each input signature's first run is eager and
is captured into one CUDA graph that every later run replays
(`static/io.py`).  `copy_from_cpu` puts an array on that device and
`copy_to_cpu` returns numpy; a bfloat16 output comes out as its raw
uint16 words (ROADMAP C2.32), as a bfloat16 input may go in.
"""
from __future__ import annotations

import os


class Config:
    """Predictor configuration (paths, device; graph-optimisation toggles
    are accepted no-ops: the program is replayed as recorded)."""

    def __init__(self, prog_file=None, params_file=None):
        if prog_file is not None and params_file is None:
            # single path prefix form
            self.path_prefix = prog_file
        else:
            self.path_prefix = None
            if prog_file is not None:
                self.path_prefix = os.path.splitext(prog_file)[0]
        self.prog_file = prog_file
        self.params_file = params_file
        self._use_device = "gpu"
        self._device_id = 0
        self.mem_optim = True
        self.ir_optim = True

    def set_model(self, prog_file, params_file=None):
        self.path_prefix = os.path.splitext(prog_file)[0]
        self.prog_file = prog_file
        self.params_file = params_file

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._use_device = "gpu"
        self._device_id = int(device_id)

    def disable_gpu(self):
        self._use_device = "cpu"

    def use_gpu(self) -> bool:
        return self._use_device == "gpu"

    def gpu_device_id(self) -> int:
        return self._device_id

    def device(self):
        """The torch device a predictor of this config runs on (raises on
        a host without CUDA unless `disable_gpu()` was called)."""
        from ..core.device import resolve_device

        return resolve_device("cpu" if self._use_device == "cpu"
                              else f"cuda:{self._device_id}")

    def enable_xpu(self, *a, **kw):
        raise NotImplementedError(
            "XPU is not a device of the port: the CUDA card or the CPU")

    def switch_ir_optim(self, x=True):
        self.ir_optim = x

    def enable_memory_optim(self, x=True):
        self.mem_optim = x

    def set_cpu_math_library_num_threads(self, n):
        pass

    def disable_glog_info(self):
        pass

    def enable_tensorrt_engine(self, *a, **kw):
        pass  # the saved program's own kernels are the engine

    def summary(self):
        return f"Config(path={self.path_prefix}, device={self._use_device})"


class PredictorTensor:
    """Input/output handle (parity: paddle.inference zero-copy Tensor):
    an input holds its tensor on the predictor's device."""

    def __init__(self, name, device=None, dtype=None):
        self.name = name
        self._device = device
        self._dtype = dtype     # an input's: the saved feed's dtype
        self._value = None

    def copy_from_cpu(self, arr):
        from ..static.executor import to_tensor

        self._value = to_tensor(arr, self._dtype, self._device)

    def copy_to_cpu(self):
        from ..framework.io_utils import to_numpy

        return to_numpy(self._value)

    def reshape(self, shape):
        if self._value is not None:
            self._value = self._value.reshape(shape)

    def shape(self):
        return list(self._value.shape) if self._value is not None else []


class Predictor:
    def __init__(self, config):
        from ..static.io import load_inference_model

        self.config = config
        self.device = config.device()
        prog, feed_names, fetch_names = load_inference_model(
            config.path_prefix, device=self.device)
        self._prog = prog
        self._inputs = {n: PredictorTensor(n, self.device, dtype)
                        for n, (_, dtype) in zip(feed_names,
                                                 prog.feed_specs)}
        self._outputs = {n: PredictorTensor(n, self.device)
                         for n in fetch_names}

    def get_input_names(self):
        return list(self._inputs)

    def get_output_names(self):
        return list(self._outputs)

    def get_input_handle(self, name):
        return self._inputs[name]

    def get_output_handle(self, name):
        return self._outputs[name]

    def input_specs(self):
        """{name: (shape with -1 on a dynamic dim, torch dtype)} of the
        saved program's feeds."""
        return dict(zip(self._prog.feed_names, self._prog.feed_specs))

    def run(self, inputs=None):
        """Run: either a positional list of numpy arrays (returns the
        outputs as numpy), or the pre-filled input handles (returns
        True; read the output handles)."""
        from ..framework.io_utils import to_numpy

        if inputs is not None:
            if len(inputs) != len(self._inputs):
                raise ValueError(f"Predictor.run: {len(inputs)} inputs for "
                                 f"{len(self._inputs)} feeds")
            feed = dict(zip(self._prog.feed_names, inputs))
        else:
            feed = {n: h._value for n, h in self._inputs.items()}
        outs = self._prog.run_tensors(self._prog.feed_tensors(feed))
        for n, v in zip(self._prog.fetch_names, outs):
            self._outputs[n]._value = v
        if inputs is not None:
            return [to_numpy(o) for o in outs]
        return True


def create_predictor(config):
    return Predictor(config)


def convert_to_mixed_precision(*a, **kw):
    raise NotImplementedError(
        "mixed-precision conversion happens at save time: record and "
        "save the program under amp.auto_cast instead")


class DataType:
    FLOAT32 = 0
    INT64 = 1
    INT32 = 2
    UINT8 = 3
    INT8 = 4
    FLOAT16 = 5
    BFLOAT16 = 6
    BOOL = 7


class PlaceType:
    UNK = -1
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM = 3


class PrecisionType:
    Float32 = 0
    Half = 1
    Int8 = 2
    Bfloat16 = 3


Tensor = PredictorTensor  # reference paddle.inference.Tensor


def get_version():
    import torch

    return f"paddle_tpu_torch (torch {torch.__version__}, CUDA graphs)"


def _get_phi_kernel_name(op_name):
    return op_name  # one op layer here; names are already kernel names


def get_num_bytes_of_data_type(dtype):
    import numpy as np

    sizes = {DataType.FLOAT32: 4, DataType.INT64: 8, DataType.INT32: 4,
             DataType.UINT8: 1, DataType.INT8: 1, DataType.FLOAT16: 2,
             DataType.BFLOAT16: 2, DataType.BOOL: 1}
    return sizes.get(dtype, 4)


def get_trt_compile_version():
    return (0, 0, 0)  # no TensorRT tier


def get_trt_runtime_version():
    return (0, 0, 0)


class XpuConfig:
    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "XPU is not a device of the port: the CUDA card or the CPU")


class PredictorPool:
    """Pool of predictors over one config (reference PredictorPool):
    size-many independently steppable predictors."""

    def __init__(self, config, size=1):
        self._predictors = [Predictor(config) for _ in range(size)]

    def retrive(self, idx):
        return self._predictors[idx]

    retrieve = retrive  # reference spells it 'retrive'
