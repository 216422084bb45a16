"""Device resolution for the port's entry points.

Entry points run on the card. The CPU is taken only when a caller asks
for it (`device="cpu"`, as the tests do); with no card and no explicit
device they raise instead of quietly running somewhere slower.
"""
from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` as a `torch.device`; None means the current CUDA card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def card_description() -> Optional[str]:
    """The card's name and power limit as nvidia-smi prints them
    (`NVIDIA H100 80GB HBM3, 700.00 W`), or None without nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    index = torch.cuda.current_device() if torch.cuda.is_available() else 0
    lines = out.stdout.strip().splitlines()
    return lines[index].strip() if index < len(lines) else None
