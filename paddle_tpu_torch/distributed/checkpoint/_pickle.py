"""`dump` / `load` of the checkpoint metadata in the JAX package's
format.

The metadata file is a pickle of the dataclasses of `metadata`, and a
pickle names each class by its module.  The JAX package's loader
resolves ``paddle_tpu.distributed.checkpoint.metadata``; the port's
copy of those classes lives in another module.  `dump` writes the
JAX package's module name for them, and `load` maps that name back to
the port's copy, so neither side imports the other.
"""
from __future__ import annotations

import pickle as _std

from . import metadata as _metadata

_JAX_MODULE = "paddle_tpu.distributed.checkpoint.metadata"


class _Pickler(_std._Pickler):
    """The pure-Python pickler, with the metadata classes saved under
    the JAX package's module name."""

    def save_global(self, obj, name=None):
        if getattr(obj, "__module__", None) != _metadata.__name__:
            return super().save_global(obj, name)
        qual = obj.__qualname__
        if self.proto >= 4:
            self.save(_JAX_MODULE)
            self.save(qual)
            self.write(_std.STACK_GLOBAL)
        else:
            self.write(_std.GLOBAL + f"{_JAX_MODULE}\n{qual}\n".encode())
        self.memoize(obj)


class _Unpickler(_std.Unpickler):
    def find_class(self, module, name):
        if module == _JAX_MODULE:
            module = _metadata.__name__
        return super().find_class(module, name)


def dump(obj, f, protocol=4):
    _Pickler(f, protocol=protocol).dump(obj)


def load(f):
    return _Unpickler(f).load()
