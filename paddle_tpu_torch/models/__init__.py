"""Model families of the port (``paddle_tpu/models`` counterpart)."""
from __future__ import annotations

from .gpt import (  # noqa: F401
    GPTConfig, GPTForCausalLM, gpt_1p3b, gpt_tiny, load_reference_state,
)
