from .llama import (  # noqa: F401
    CONFIGS,
    LlamaConfig,
    LlamaForCausalLM,
    causal_lm_loss,
    chunked_causal_lm_loss,
    lm_head_weight,
)
from .gpt import CONFIGS as GPT_CONFIGS  # noqa: F401
from .gpt import GPTConfig, GPTForCausalLM  # noqa: F401
from .mixtral import CONFIGS as MIXTRAL_CONFIGS  # noqa: F401
from .mixtral import (  # noqa: F401
    MixtralConfig,
    MixtralForCausalLM,
    MoELayer,
    moe_lm_loss,
    resolve_moe_dispatch,
)
