"""ray_tpu_torch: the PyTorch and CUDA port of ray_tpu, for NVIDIA Hopper.

It grows slice by slice beside `ray_tpu`, which stays the reference, and
imports nothing of it. This slice is the Llama training step:
`models.llama` on the flash-attention kernels of `ops.attention`, driven
by `bench` (`python -m ray_tpu_torch.bench`).
"""
from ._device import resolve_device  # noqa: F401
