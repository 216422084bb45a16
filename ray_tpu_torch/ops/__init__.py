"""Ops of the port: flash attention with hand-written CUDA kernels."""
from .attention import (  # noqa: F401
    LAUNCHES,
    attention_reference,
    flash_attention,
    flash_bwd,
    flash_fwd,
    reset_launch_counts,
)
