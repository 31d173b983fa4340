"""Native runtime tier of the port (``paddle_tpu/native`` counterpart):
the shared-memory ring of the DataLoader's worker processes, behind
`ctypes`.

``src/shm_ring.cc`` is a copy of the JAX package's source.  `load()`
builds it with `g++` at first use into ``paddle_tpu_torch/_build/``
(git-ignored) and loads it; a content hash decides whether a build is
stale, and an `fcntl` lock with an atomic rename keeps concurrent
processes from loading a half-written library, as in the JAX package
(`native/__init__.py:21-70`).  The JAX package's `tcp_store.cc` has no
counterpart: the port's store is `torch.distributed.TCPStore`
(`distributed/store.py`).
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "shm_ring.cc")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_SO = os.path.join(_BUILD, "libpaddle_tpu_torch_native.so")
_HASH_FILE = os.path.join(_BUILD, "native.srchash")
_lock = threading.Lock()
_lib = None


def _src_hash():
    with open(_SRC, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _stale():
    if not os.path.exists(_SO) or not os.path.exists(_HASH_FILE):
        return True
    with open(_HASH_FILE) as fh:
        return fh.read().strip() != _src_hash()


def _compile():
    os.makedirs(_BUILD, exist_ok=True)
    with open(os.path.join(_BUILD, "native.buildlock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if not _stale():  # another process built it while we waited
                return
            tmp = f"{_SO}.tmp.{os.getpid()}"
            cmd = ["g++", "-O2", "-fPIC", "-shared", "-std=c++17",
                   "-pthread", "-o", tmp, _SRC, "-lrt"]
            subprocess.run(cmd, check=True, capture_output=True)
            os.rename(tmp, _SO)
            with open(_HASH_FILE + ".tmp", "w") as fh:
                fh.write(_src_hash())
            os.rename(_HASH_FILE + ".tmp", _HASH_FILE)
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)


def load():
    """The ring library, built on first use.  Raises OSError when it
    cannot be built (no `g++`) or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            try:
                _compile()
            except (FileNotFoundError, subprocess.CalledProcessError) as e:
                raise OSError(f"cannot build {_SRC}: {e}") from e
        lib = ctypes.CDLL(_SO)
        lib.shm_ring_create.restype = ctypes.c_void_p
        lib.shm_ring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                        ctypes.c_uint64]
        lib.shm_ring_attach.restype = ctypes.c_void_p
        lib.shm_ring_attach.argtypes = [ctypes.c_char_p]
        lib.shm_ring_push.restype = ctypes.c_int
        lib.shm_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_uint64, ctypes.c_double]
        lib.shm_ring_pop.restype = ctypes.c_int64
        lib.shm_ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_uint64, ctypes.c_double]
        lib.shm_ring_slot_size.restype = ctypes.c_uint64
        lib.shm_ring_slot_size.argtypes = [ctypes.c_void_p]
        lib.shm_ring_count.restype = ctypes.c_uint64
        lib.shm_ring_count.argtypes = [ctypes.c_void_p]
        lib.shm_ring_close.restype = None
        lib.shm_ring_close.argtypes = [ctypes.c_void_p]
        lib.shm_ring_detach.restype = None
        lib.shm_ring_detach.argtypes = [ctypes.c_void_p]
        lib.shm_ring_unlink.restype = None
        lib.shm_ring_unlink.argtypes = [ctypes.c_char_p]
        _lib = lib
        return _lib
