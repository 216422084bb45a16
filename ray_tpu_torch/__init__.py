"""ray_tpu_torch: the PyTorch and CUDA port of ray_tpu, for NVIDIA Hopper.

It grows slice by slice beside `ray_tpu`, which stays the reference, and
imports nothing of it. Slice 1 is the Llama training step: `models.llama`
on the flash-attention kernels of `ops.attention`. Slice 2 is the
Mixtral sparse-MoE training step: `models.mixtral` on the grouped-matmul
kernels of `ops.gmm`. Slice 6 adds GPT (`models.gpt`), on the same
attention kernels as Llama. Slice 7 adds the device mesh and its train
steps on torch.distributed (`parallel`) and ring attention over a
sequence-sharded group (`ops.ring_attention`), each block on the same
kernels. Slice 8 adds the GPipe pipeline (`parallel.pipeline`), expert
parallelism for Mixtral (its `mesh` argument), `seq` together with FSDP2
and tensor parallelism, and the multi-device dryrun that runs them all
(`dryrun`, `python -m ray_tpu_torch.dryrun --cpu`). `bench` (`python
-m ray_tpu_torch.bench`) drives Llama, its long-context sweep and
Mixtral; `profile` breaks a step's device time down by kernel.
"""
from ._device import resolve_device  # noqa: F401
