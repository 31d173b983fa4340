"""Build + ctypes harness of the C inference ABI (``src/capi.cc``;
``paddle_tpu/native/capi.py`` counterpart, :42-127).

``src/capi.cc`` is the JAX package's source with the bridge module's
name changed (`paddle_tpu_torch.inference.capi_bridge`); the header
``src/paddle_tpu_capi.h`` is the JAX package's.  `load()` builds the
library with `g++` at first use into ``paddle_tpu_torch/_build/``
(git-ignored): a content hash decides whether a build is stale, and an
`fcntl` lock with an atomic rename keeps concurrent processes from
loading a half-written library, as `native/__init__.py` does for the
ring.  A failed build raises.  Inside a Python process the library rides
the host interpreter's GIL (`Py_IsInitialized` short-circuits its
embedding).

C consumers: include ``src/paddle_tpu_capi.h``, link
``libpaddle_tpu_torch_capi.so`` and libpython, and set PYTHONPATH to
reach `paddle_tpu_torch`.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import sysconfig
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_HERE, "src")
_SRCS = ("capi.cc", "paddle_tpu_capi.h")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_SO = os.path.join(_BUILD, "libpaddle_tpu_torch_capi.so")
_HASH_FILE = os.path.join(_BUILD, "capi.srchash")
_lock = threading.Lock()
_lib = None

PD_MAX_NDIM = 8


class PD_TensorData(ctypes.Structure):
    _fields_ = [
        ("dtype", ctypes.c_int32),
        ("ndim", ctypes.c_int32),
        ("shape", ctypes.c_int64 * PD_MAX_NDIM),
        ("data", ctypes.c_void_p),
        ("nbytes", ctypes.c_int64),
    ]


def _src_hash():
    h = hashlib.sha256()
    for f in _SRCS:
        with open(os.path.join(_SRC_DIR, f), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def _stale():
    if not os.path.exists(_SO) or not os.path.exists(_HASH_FILE):
        return True
    with open(_HASH_FILE) as fh:
        return fh.read().strip() != _src_hash()


def _python_link_flags():
    inc = sysconfig.get_path("include")
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ver = sysconfig.get_config_var("LDVERSION") or \
        sysconfig.get_config_var("VERSION")
    flags = [f"-I{inc}"]
    if libdir:
        flags += [f"-L{libdir}", f"-Wl,-rpath,{libdir}"]
    flags.append(f"-lpython{ver}")
    return flags


def _compile():
    os.makedirs(_BUILD, exist_ok=True)
    with open(os.path.join(_BUILD, "capi.buildlock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if not _stale():  # another process built it while we waited
                return
            tmp = f"{_SO}.tmp.{os.getpid()}"
            cmd = (["g++", "-O2", "-fPIC", "-shared", "-std=c++17",
                    "-pthread", "-o", tmp,
                    os.path.join(_SRC_DIR, "capi.cc"), f"-I{_SRC_DIR}"]
                   + _python_link_flags())
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            os.rename(tmp, _SO)
            with open(_HASH_FILE + ".tmp", "w") as fh:
                fh.write(_src_hash())
            os.rename(_HASH_FILE + ".tmp", _HASH_FILE)
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)


def load():
    """Build (if stale) and load the C API with typed ctypes signatures.
    Raises OSError when it cannot be built (no `g++`, a compile error)
    or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            try:
                _compile()
            except (FileNotFoundError, subprocess.CalledProcessError) as e:
                detail = getattr(e, "stderr", "") or ""
                raise OSError(f"cannot build {_SRC_DIR}/capi.cc: {e} "
                              f"{detail}") from e
        lib = ctypes.CDLL(_SO)
        lib.PD_PredictorCreate.restype = ctypes.c_int
        lib.PD_PredictorCreate.argtypes = [ctypes.c_char_p]
        for f in (lib.PD_PredictorInputNum, lib.PD_PredictorOutputNum,
                  lib.PD_PredictorDestroy):
            f.restype = ctypes.c_int
            f.argtypes = [ctypes.c_int]
        for f in (lib.PD_PredictorInputName, lib.PD_PredictorOutputName):
            f.restype = ctypes.c_int
            f.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                          ctypes.c_size_t]
        lib.PD_PredictorRun.restype = ctypes.c_int
        lib.PD_PredictorRun.argtypes = [
            ctypes.c_int, ctypes.POINTER(PD_TensorData), ctypes.c_int,
            ctypes.POINTER(PD_TensorData), ctypes.c_int]
        lib.PD_ReleaseOutputs.restype = None
        lib.PD_ReleaseOutputs.argtypes = [ctypes.POINTER(PD_TensorData),
                                          ctypes.c_int]
        lib.PD_LastError.restype = ctypes.c_char_p
        lib.PD_LastError.argtypes = []
        _lib = lib
        return _lib


# bfloat16 travels as its uint16 words (code 6 both ways)
_NP_CODES = {"float32": 0, "int64": 1, "int32": 2, "uint8": 3, "int8": 4,
             "float16": 5, "bool": 7}
_BF16_CODE = 6


def np_to_td(arr, bfloat16=False):
    """Pack a numpy array into a PD_TensorData (keeps a ref to the bytes:
    hold the return value alive for the duration of the call).  With
    `bfloat16`, `arr` holds uint16 words sent under code 6."""
    arr = np.ascontiguousarray(arr)
    if bfloat16:
        if arr.dtype != np.uint16:
            raise TypeError("bfloat16 data must be uint16 words")
        code = _BF16_CODE
    else:
        code = _NP_CODES.get(arr.dtype.name)
    if code is None:
        raise TypeError(f"unsupported dtype {arr.dtype}")
    td = PD_TensorData()
    td.dtype = code
    td.ndim = arr.ndim
    for i, s in enumerate(arr.shape):
        td.shape[i] = s
    buf = arr.tobytes()
    td.data = ctypes.cast(ctypes.create_string_buffer(buf, len(buf)),
                          ctypes.c_void_p)
    td.nbytes = len(buf)
    return td


def td_to_np(td):
    """Copy a PD_TensorData (filled by PD_PredictorRun) into numpy; a
    bfloat16 output as its uint16 words."""
    code = int(td.dtype)
    if code == _BF16_CODE:
        dt = np.dtype(np.uint16)
    else:
        dt = np.dtype({v: k for k, v in _NP_CODES.items()}[code])
    raw = ctypes.string_at(td.data, td.nbytes)
    shape = tuple(td.shape[i] for i in range(td.ndim))
    return np.frombuffer(raw, dtype=dt).reshape(shape).copy()
