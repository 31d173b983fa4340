"""Model families of the port (``paddle_tpu/models`` counterpart)."""
from __future__ import annotations

from .ernie import (  # noqa: F401
    ErnieConfig, ErnieForPretraining, ErnieModel, ErniePretrainingCriterion,
    ernie_3_0_medium, ernie_base, ernie_tiny,
)
from .gpt import (  # noqa: F401
    GPTConfig, GPTForCausalLM, GPTPretrainingCriterion, gpt_1p3b, gpt_6p7b,
    gpt_tiny, load_reference_state,
)
from .gpt import llama_7b as gpt_llama_7b  # noqa: F401 (legacy alias)
from .llama import (  # noqa: F401
    LlamaConfig, LlamaForCausalLM, LlamaModel, LlamaPretrainingCriterion,
    llama2_70b_shapes, llama_7b, llama_13b, llama_tiny,
)
