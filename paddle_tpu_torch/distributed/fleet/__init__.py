"""Fleet side of the port's ``distributed`` package
(``paddle_tpu/distributed/fleet`` counterpart): so far only `elastic`,
the heartbeat registry the serving fleet's replicas beat into (a copy
of the JAX module, over the port's `distributed.store.TCPStore`).  The
JAX package's fleet facade (`init`, `distributed_model`, the hybrid
topology) comes with ROADMAP Queue A7."""
from __future__ import annotations

from . import elastic  # noqa: F401
