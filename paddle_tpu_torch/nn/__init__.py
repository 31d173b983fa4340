"""Layers of the port (``paddle_tpu/nn`` counterpart): `Layer`,
`Parameter`, `ParamAttr`, the initializers, every layer class of the JAX
package (the recurrent family with `dynamic_decode` among them), the
functionals, gradient clipping, `nn.utils` and `nn.quant`."""
from __future__ import annotations

from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_,
    clip_grad_value_,
)
from .layer_base import HookRemoveHelper, Layer, ParamAttr, Parameter  # noqa: F401
from .layers_activation import *  # noqa: F401,F403
from .layers_common import (  # noqa: F401
    AlphaDropout, Bilinear, ChannelShuffle, CosineSimilarity, Dropout,
    Dropout2D, Dropout3D, Embedding, Flatten, Fold, Identity, LayerDict,
    LayerList, LayerNorm, Linear, Pad1D, Pad2D, Pad3D, PairwiseDistance,
    ParameterList, PixelShuffle, PixelUnshuffle, RMSNorm, Sequential,
    Softmax2D, Unflatten, Unfold, Upsample, UpsamplingBilinear2D,
    UpsamplingNearest2D, ZeroPad2D, weight_in_use, weights_in_use,
)
from .layers_conv_pool import *  # noqa: F401,F403
from .layers_loss import *  # noqa: F401,F403
from .layers_norm import *  # noqa: F401,F403
from .layers_rnn import *  # noqa: F401,F403
from . import quant  # noqa: F401
from . import utils  # noqa: F401
from .layers_transformer import *  # noqa: F401,F403
