"""NVIDIA GPU accelerator manager.

Reference: _private/accelerators/nvidia_gpu.py — the GPU count of the
node, and CUDA_VISIBLE_DEVICES as the per-worker visibility variable.
It takes the place of the reference's TPU manager (chip detection,
TPU_VISIBLE_CHIPS).

Nothing here calls into CUDA: the count comes from the driver's
/proc entries or `nvidia-smi -L`, never from `torch.cuda`. The node's
zygote imports this module and forks workers afterwards, and CUDA does
not survive a fork.
"""
from __future__ import annotations

import os
import subprocess
from typing import Dict, List, Optional

from .accelerator import AcceleratorManager

CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"
# Fakes the node's GPU count (tests on hosts without a card).
NUM_GPUS_ENV = "RAY_TPU_TORCH_NUM_GPUS"
_PROC_GPUS = "/proc/driver/nvidia/gpus"


def _visible_env() -> Optional[List[str]]:
    """The ids in CUDA_VISIBLE_DEVICES, or None when it is unset."""
    env = os.environ.get(CUDA_VISIBLE_DEVICES_ENV)
    if env is None:
        return None
    return [d.strip() for d in env.split(",") if d.strip()]


def _count_physical() -> int:
    try:
        return len(os.listdir(_PROC_GPUS))
    except OSError:
        pass
    try:
        out = subprocess.run(
            ["nvidia-smi", "-L"], capture_output=True, text=True, timeout=30,
            check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return 0
    return sum(1 for line in out.stdout.splitlines() if line.startswith("GPU "))


class GPUAcceleratorManager(AcceleratorManager):
    @staticmethod
    def get_resource_name() -> str:
        return "GPU"

    @staticmethod
    def get_current_node_num_accelerators() -> int:
        """$RAY_TPU_TORCH_NUM_GPUS if set; otherwise the node's cards,
        restricted to CUDA_VISIBLE_DEVICES when that is set."""
        env = os.environ.get(NUM_GPUS_ENV)
        if env is not None:
            return int(env)
        n = _count_physical()
        visible = _visible_env()
        if visible is not None:
            return min(n, len(visible))
        return n

    @staticmethod
    def get_visible_accelerator_ids_env_var() -> Optional[str]:
        return CUDA_VISIBLE_DEVICES_ENV

    @staticmethod
    def node_device_ids(count: int) -> List[str]:
        """The ids a worker may be given, in slot order: the node's own
        CUDA_VISIBLE_DEVICES where it names enough of them, else 0..n-1."""
        visible = _visible_env()
        if visible is not None and len(visible) >= count:
            return visible[:count]
        return [str(i) for i in range(count)]

    @staticmethod
    def set_visible_accelerator_ids(env: Dict[str, str],
                                    ids: List[str]) -> None:
        """Pin a worker to `ids`; an empty list hides every card."""
        env[CUDA_VISIBLE_DEVICES_ENV] = ",".join(ids)
