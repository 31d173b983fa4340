"""paddle.summary / paddle.flops (``paddle_tpu/hapi/summary.py``
counterpart; parity: `python/paddle/hapi/model_summary.py`,
`python/paddle/hapi/dynamic_flops.py`): a layer table and parameter /
multiply-accumulate counts from forward hooks, over one forward of
zeros on the network's device."""
from __future__ import annotations

import torch

from ..nn.layers_common import Linear
from ..nn.layers_conv_pool import Conv2D


def _device(net):
    p = next(net.parameters(), None)
    return torch.device("cpu") if p is None else p.device


def _make_input(input_size, dtypes, device):
    if isinstance(input_size, (list, tuple)) and input_size and \
            isinstance(input_size[0], (list, tuple)):
        return [_make_input(s, dtypes, device) for s in input_size]
    shape = [1 if (s is None or s == -1) else int(s) for s in input_size]
    dt = dtypes or "float32"
    if "int" in str(dt):
        return torch.zeros(shape, dtype=torch.int64, device=device)
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _run(net, x):
    with torch.no_grad():
        if isinstance(x, (list, tuple)):
            net(*x)
        else:
            net(x)


def summary(net, input_size=None, dtypes=None, input=None):
    """Print a per-layer table; return dict with total/trainable params."""
    records = []
    hooks = []

    def hook(l, inputs, output):
        out_shape = None
        out = output
        if isinstance(out, (list, tuple)) and out:
            out = out[0]
        if isinstance(out, torch.Tensor):
            out_shape = list(out.shape)
        n_params = sum(p.numel() for p in l.parameters(recurse=False))
        records.append((type(l).__name__, out_shape, n_params))

    for l in net.modules():
        if not any(True for _ in l.children()):
            hooks.append(l.register_forward_hook(hook))
    try:
        x = input if input is not None else _make_input(
            input_size, dtypes, _device(net))
        _run(net, x)
    finally:
        for h in hooks:
            h.remove()

    total = sum(p.numel() for p in net.parameters())
    trainable = sum(p.numel() for p in net.parameters() if p.requires_grad)
    line = "-" * 64
    print(line)
    print(f"{'Layer (type)':<24}{'Output Shape':<24}{'Param #':<12}")
    print(line)
    for name, shape, n in records:
        print(f"{name:<24}{str(shape):<24}{n:<12,}")
    print(line)
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(line)
    return {"total_params": total, "trainable_params": trainable}


def _conv_flops(l, inp, out):
    k = l.kernel_size[0] * l.kernel_size[1]
    cin = l.in_channels // l.groups
    return out.numel() * cin * k


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Total multiply-accumulate count of one forward (paddle.flops)."""
    total = [0]
    hooks = []

    def hook(l, inputs, output):
        out = output[0] if isinstance(output, (list, tuple)) else output
        if custom_ops and type(l) in custom_ops:
            total[0] += int(custom_ops[type(l)](l, inputs, out))
        elif isinstance(l, Conv2D):
            total[0] += _conv_flops(l, inputs, out)
        elif isinstance(l, Linear):
            total[0] += l.weight.numel() * (out.numel() // out.shape[-1])

    for l in net.modules():
        hooks.append(l.register_forward_hook(hook))
    try:
        _run(net, _make_input(input_size, None, _device(net)))
    finally:
        for h in hooks:
            h.remove()
    if print_detail:
        print(f"Total FLOPs (MACs): {total[0]:,}")
    return total[0]
