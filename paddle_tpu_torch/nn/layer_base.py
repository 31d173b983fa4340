"""nn.Layer, Parameter and ParamAttr (``paddle_tpu/nn/layer_base.py``
counterpart; `ParamAttr` is ``paddle_tpu/nn/__init__.py:21``, `Parameter`
``paddle_tpu/core/tensor.py:360``).

`Layer` is a `torch.nn.Module` with Paddle's methods on top, so a port
layer is both: `state_dict`, `named_parameters`, `train` / `eval`,
`to`, hooks and `apply` keep torch's behaviour, and their names are the
JAX package's (children and parameters registered under the same
attribute names give the same dotted keys, so `load_reference_state`
moves any JAX layer's ``functional_state()`` into its port).  Added:
`create_parameter` (Paddle's initializer defaults, drawn from the
layer's `torch.Generator` on its device), `add_parameter`,
`add_sublayer`, `sublayers` / `named_sublayers`, `register_buffer(...,
persistable=)`, `set_state_dict` / `load_dict`, `clear_gradients`,
`full_name`, `to(dtype="float16")` and Paddle's hook helpers.

A layer's parameters are made on its device: the `device` keyword of
its constructor, else the default of `core.device` (the card unless
`set_device` said otherwise).  `parameters()` stays torch's iterator
(ROADMAP C2.36: Paddle returns a list; ``list(layer.parameters())`` is
that list).
"""
from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn
from torch.utils.hooks import RemovableHandle

from ..core.device import resolve_device
from ..core.dtypes import torch_dtype

__all__ = ["HookRemoveHelper", "Layer", "ParamAttr", "Parameter",
           "load_reference_state"]


class ParamAttr:
    """Bundles a parameter's name, initializer, learning rate multiplier,
    regularizer, `trainable` and clipping flag (JAX ``nn/__init__.py:21``).
    `learning_rate` reaches the optimizers through the parameter's
    ``optimize_attr``."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


class Parameter(nn.Parameter):
    """A trainable tensor with Paddle's attributes: `stop_gradient` and
    `trainable` read and set ``requires_grad``; `name`, `optimize_attr`
    (``{"learning_rate": 1.0}``), `regularizer` and `need_clip` as on a
    JAX `Parameter`."""

    def __new__(cls, data=None, requires_grad=True):
        return super().__new__(cls, data, requires_grad)

    def __init__(self, data=None, requires_grad=True):
        self.name = None
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True

    @property
    def name(self):
        # Paddle's parameter name (a torch tensor's own `name` is
        # read-only)
        return self.__dict__.get("_param_name")

    @name.setter
    def name(self, value):
        self.__dict__["_param_name"] = value

    @property
    def stop_gradient(self):
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        self.requires_grad_(not value)

    @property
    def trainable(self):
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.requires_grad_(bool(value))

    def __deepcopy__(self, memo):
        out = type(self)(self.data.clone(memory_format=torch.preserve_format),
                         self.requires_grad)
        memo[id(self)] = out
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return out


# what `register_forward_pre_hook` / `register_forward_post_hook` return:
# `remove()` takes the hook off (JAX :21)
HookRemoveHelper = RemovableHandle


class Layer(nn.Module):
    """Base class of the port's layers (JAX :34).  `dtype` is the default
    dtype of `create_parameter`; `device` and `generator` (keywords of
    the port) say where parameters are made and what draws them."""

    def __init__(self, name_scope=None, dtype="float32", *, device=None,
                 generator=None):
        super().__init__()
        self._dtype = torch_dtype(dtype)
        self._name_scope = name_scope or type(self).__name__.lower()
        self._init_device = device
        self._generator = generator

    # --- registration --------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A `Parameter` of `shape` in `dtype` (the layer's by default)
        on the layer's device, drawn by `attr`'s initializer, else
        `default_initializer`, else Paddle's default (zeros for a bias,
        U(-1/sqrt(fan_in), 1/sqrt(fan_in)) otherwise).  `attr` False
        means no parameter (None)."""
        from .initializer import Constant, _resolve_initializer

        if attr is False:
            return None
        dtype = torch_dtype(dtype, self._dtype)
        init = name = None
        learning_rate, trainable = 1.0, True
        if attr is not None:
            if isinstance(attr, str):
                attr = ParamAttr(name=attr)
            init = getattr(attr, "initializer", None)
            name = getattr(attr, "name", None)
            learning_rate = getattr(attr, "learning_rate", 1.0)
            trainable = getattr(attr, "trainable", True)
        if init is None:
            init = default_initializer
        if init is None and is_bias:
            init = Constant(0.0)
        init = _resolve_initializer(init, shape, is_bias)
        data = init([int(s) for s in shape], dtype,
                    device=resolve_device(self._init_device),
                    generator=self._generator)
        p = Parameter(data, requires_grad=bool(trainable))
        p.name = name
        p.optimize_attr["learning_rate"] = learning_rate
        if attr is not None:
            p.regularizer = getattr(attr, "regularizer", None)
            p.need_clip = getattr(attr, "need_clip", True)
        return p

    def add_parameter(self, name, parameter):
        if parameter is not None and not isinstance(parameter,
                                                    nn.Parameter):
            raise TypeError("add_parameter expects a Parameter")
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        if not isinstance(sublayer, nn.Module):
            raise TypeError("add_sublayer expects a Layer")
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        """Paddle's `persistable` (torch's `persistent`, which torch's own
        attribute assignment passes): a non-persistable buffer stays out
        of `state_dict`.  A numpy array becomes a tensor."""
        if persistent is not None:
            persistable = persistent
        if tensor is not None and not isinstance(tensor, torch.Tensor):
            tensor = torch.as_tensor(np.asarray(tensor))
        super().register_buffer(name, tensor, persistent=bool(persistable))
        return tensor

    # --- iteration -----------------------------------------------------
    def named_sublayers(self, prefix="", include_self=False):
        for name, m in self.named_modules(prefix=prefix):
            if m is self and not include_self:
                continue
            yield name, m

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    # --- state ---------------------------------------------------------
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy `state_dict` (name -> tensor or array) into this layer's
        parameters and persistable buffers in place, each cast to the
        target's dtype and device; a shape mismatch raises.  Returns
        (missing, unexpected) names."""
        own = self.state_dict(keep_vars=True)
        missing = [k for k in own if k not in state_dict]
        unexpected = [k for k in state_dict if k not in own]
        with torch.no_grad():
            for k, v in state_dict.items():
                if k not in own:
                    continue
                tgt = own[k]
                val = v if isinstance(v, torch.Tensor) \
                    else torch.as_tensor(np.asarray(v))
                if tuple(tgt.shape) != tuple(val.shape):
                    raise ValueError(f"shape mismatch for {k}: "
                                     f"{list(tgt.shape)} vs "
                                     f"{list(val.shape)}")
                tgt.copy_(val.to(device=tgt.device, dtype=tgt.dtype))
        return missing, unexpected

    load_dict = set_state_dict

    def clear_gradients(self, set_to_zero=True):
        """Zero every parameter's gradient (drop it with
        ``set_to_zero=False``)."""
        self.zero_grad(set_to_none=not set_to_zero)

    # --- dtype / device ------------------------------------------------
    def to(self, *args, **kwargs):
        """torch's `to`, with Paddle's dtype names (``"float16"``, ...)
        and its ignored `blocking`."""
        kwargs.pop("blocking", None)
        if isinstance(kwargs.get("dtype"), str):
            kwargs["dtype"] = torch_dtype(kwargs["dtype"])
        args = list(args)
        if args and isinstance(args[0], str) and args[0] not in (
                "cpu", "cuda", "meta") and not args[0].startswith(
                    ("cuda:", "gpu")):
            args[0] = torch_dtype(args[0])
        elif args and isinstance(args[0], str):
            args[0] = resolve_device(args[0])
        return super().to(*args, **kwargs)

    def astype(self, dtype):
        return self.to(dtype=torch_dtype(dtype))

    # --- hooks ---------------------------------------------------------
    def register_forward_post_hook(self, hook):
        return self.register_forward_hook(hook)

    def full_name(self):
        return self._name_scope


def load_reference_state(model, params, buffers=None) -> None:
    """Copy the JAX model's ``functional_state()`` params (name -> array,
    numpy or anything `np.asarray` takes) into `model`, onto its device
    and dtype; with `buffers` (the second dict of ``functional_state()``)
    the model's persistent buffers too, such as batch norm's `_mean` and
    `_variance`.  Every name and shape must match: a missing or extra
    name raises, as does a shape mismatch."""
    own = dict(model.named_parameters())
    targets = [(own, params)]
    if buffers is not None:
        state = model.state_dict(keep_vars=True)
        targets.append(({n: b for n, b in model.named_buffers()
                         if n in state}, buffers))
    for dst, src_dict in targets:
        missing = sorted(set(dst) - set(src_dict))
        extra = sorted(set(src_dict) - set(dst))
        if missing or extra:
            raise KeyError(f"load_reference_state: missing {missing}, "
                           f"unexpected {extra}")
    with torch.no_grad():
        for dst, src_dict in targets:
            for name, p in dst.items():
                src = np.asarray(src_dict[name])
                if tuple(src.shape) != tuple(p.shape):
                    raise ValueError(
                        f"load_reference_state: {name} has shape "
                        f"{tuple(src.shape)}, model expects "
                        f"{tuple(p.shape)}")
                p.copy_(torch.from_numpy(np.array(src)).to(
                    device=p.device, dtype=p.dtype))
