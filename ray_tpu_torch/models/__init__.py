from .llama import (  # noqa: F401
    CONFIGS,
    LlamaConfig,
    LlamaForCausalLM,
    causal_lm_loss,
    chunked_causal_lm_loss,
    lm_head_weight,
)
