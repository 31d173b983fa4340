"""Build and load the port's CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` is compiled by `nvcc` for
``sm_90a`` into its own shared library with a plain C interface
(``paddle_tpu_torch/_build/<name>-<hash>.so``) and loaded with `ctypes`.
The hash covers the source, every ``csrc/*.cuh`` header and the flags,
so an edited source rebuilds and an unchanged one loads at once.
Nothing here runs at import time: the CPU tests import every module on
a host with no `nvcc`.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo"]

_libs = {}
_bound = set()   # (library, function) pairs whose signature is set
# seconds each library took to build in this process (0.0 = loaded from
# an earlier build of the same hash)
build_seconds = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"  # the toolkit's standard prefix
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the paddle_tpu_torch CUDA kernels")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fn in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, fn), "rb") as f:
            h.update(fn.encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def _target(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}-{_digest(name)}.so")


def _start(name: str):
    """Start nvcc for one source (or return None when the library of this
    hash exists).  Returns (Popen, tmp_path, final_path, t0)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = _target(name)
    if os.path.exists(out):
        return None
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ([nvcc_path()] + ARCH_FLAGS + NVCC_FLAGS
           + ["-I", CSRC, "-o", tmp, os.path.join(CSRC, f"{name}.cu")])
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> None:
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(rc={proc.returncode}):\n{log[-4000:]}")
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0


def build(names) -> dict:
    """Build every named source in parallel (one nvcc each, all started
    together), under a lock so concurrent processes do not race.
    Returns {name: seconds} (0.0 for a library that was already built)."""
    names = list(dict.fromkeys(names))     # one nvcc per source
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        started = {n: _start(n) for n in names}
        for n, s in started.items():
            if s is None:
                build_seconds.setdefault(n, 0.0)
            else:
                _finish(n, s)
    return {n: build_seconds[n] for n in names}


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed.
    `signatures` maps each C function to its argtypes; every function
    returns the launch's cudaGetLastError() as an int.  One source may
    export several functions, each wrapper naming its own (flash_fwd.cu:
    `flash_fwd` and `varlen_fwd`)."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(_target(name))
        _libs[name] = lib
    for fn, argtypes in signatures.items():
        if (name, fn) not in _bound:
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            _bound.add((name, fn))
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
