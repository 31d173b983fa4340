"""``paddle_tpu/hapi`` counterpart: `Model` (prepare / fit / evaluate /
predict / save / load), the callbacks (a copy of the JAX module), and
`summary` / `flops`."""
from .callbacks import Callback, EarlyStopping, LRScheduler, ModelCheckpoint, ProgBarLogger  # noqa: F401
from .model import Model  # noqa: F401
from .summary import flops, summary  # noqa: F401
