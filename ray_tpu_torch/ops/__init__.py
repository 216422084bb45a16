"""Ops of the port: flash attention and the grouped matmul of sparse-MoE
dispatch, each on hand-written CUDA kernels. The grouped matmul with its
gradient is `ops.gmm.gmm` (the module keeps the name `gmm`)."""
from .attention import (  # noqa: F401
    LAUNCHES,
    attention_reference,
    flash_attention,
    flash_bwd,
    flash_fwd,
    reset_launch_counts,
)
from .gmm import (  # noqa: F401
    aligned_group_layout,
    grouped_matmul,
    transposed_grouped_matmul,
)
