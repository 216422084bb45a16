"""ray_tpu_torch.train: distributed training on CUDA cards.

Reference: python/ray/train — trainers, session contract,
checkpointing. See trainer.py for the architecture mapping. The train
step of the port's models and its timing loop (`step`) are re-exported
here, where they lived before this package existed.
"""
from .checkpoint import AsyncCheckpointer, Checkpoint, load_pytree, save_pytree  # noqa: F401
from .config import (  # noqa: F401
    CheckpointConfig,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from .session import get_context, report  # noqa: F401
from .step import (  # noqa: F401
    LossFn,
    forward_backward,
    lm_loss,
    make_optimizer,
    timed_steps,
    train_step,
)
from .trainer import TorchTrainer, get_checkpoint  # noqa: F401

from ray_tpu_torch._private import usage_stats as _usage

_usage.record_library_usage("train")
