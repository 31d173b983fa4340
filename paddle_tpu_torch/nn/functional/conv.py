"""conv2d (``paddle_tpu/nn/functional/conv.py:77`` counterpart), NCHW
input and OIHW weight.

The JAX package runs this conv through `lax.conv` outside any Pallas
kernel: ResNet's downsample projection, MobileNetV2's projection conv,
Swin's patch embedding and every conv that `conv_bn_act`'s gate
refuses.  The port leaves it to `torch.nn.functional.conv2d` in the
same way; the conv inside `conv_bn_act` is the port's own kernel
(``ops/kernels/conv_norm.py``).
"""
from __future__ import annotations

import torch.nn.functional as F

from ...amp import gate as _amp


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           groups=1):
    """x [B, Cin, H, W], weight [Cout, Cin/groups, kh, kw]; int or pair
    stride / padding / dilation (symmetric padding).  In the AMP dtype
    under `amp.auto_cast`."""
    x, weight, bias = _amp.cast("conv2d", x, weight, bias)
    return _amp.seen("conv2d", F.conv2d(x, weight, bias, stride, padding,
                                        dilation, groups))
