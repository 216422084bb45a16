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
Mixtral; `profile` breaks a step's device time down by kernel. Slice 9
adds the runtime itself — tasks, actors, the shared-memory object store
(torch tensors through it, CUDA ones copied to the host), the GCS,
raylets and placement groups, with one card per GPU worker
(`_private`, `util`) — and Train on it (`train.TorchTrainer`). Slice 10
adds Data (`data`, imported where used: a Dataset's batches reach the
card through `iter_torch_batches`) and the out-of-graph collectives on
torch tensors (`util.collective`). Slice 11 adds Tune (`tune`, whose
`Tuner` wraps a `TorchTrainer`) and RLlib as far as PPO (`rllib`, its
learner on the card unless `num_gpus_per_learner=0` asks for the CPU),
both imported where used. Later slices add Serve, the cluster tooling and
the rest of the surface: DAGs and compiled DAGs (`dag`, `.bind`),
`workflow`, the thin client (`ray_tpu_torch://`), the pip, conda and
container runtime_env plugins, `util.pubsub`, the pool adapters
(`util.multiprocessing`, `util.joblib`), `experimental.tqdm_ray` and the
microbenchmarks (`python -m ray_tpu_torch._private.ray_perf`). Its API
mirrors the reference's `ray` package:

    import ray_tpu_torch

    ray_tpu_torch.init()          # resources {"CPU": n, "GPU": cards}

    @ray_tpu_torch.remote(num_gpus=1)
    def f(x):
        return x.cuda() * 2       # this worker's one card

    ray_tpu_torch.get(f.remote(torch.ones(2)))  # a CPU tensor
"""
from __future__ import annotations

import inspect as _inspect

# Lock-order witness (RAY_TPU_TORCH_lock_witness=1), installed before the
# runtime imports below so their module-level locks are witnessed too.
from ._private import lock_witness as _lock_witness

_lock_witness.maybe_install()

from ._private.worker import (  # noqa: F401,E402
    available_resources,
    cancel,
    client_server_address,
    cluster_resources,
    drain_node,
    free,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    nodes,
    put,
    shutdown,
    wait,
)
from ._private.state import timeline  # noqa: F401,E402
from .actor import ActorClass, ActorHandle  # noqa: F401,E402
from .object_ref import ObjectRef, ObjectRefGenerator  # noqa: F401,E402
from .remote_function import RemoteFunction  # noqa: F401,E402
from . import exceptions  # noqa: F401,E402

__version__ = "0.1.0"


def __getattr__(name):
    # torch is imported where it is used, not by the runtime: the zygote,
    # and every worker forked from it, would otherwise pay its import
    # (seconds, and hundreds of MB) before any task needs it.
    if name == "resolve_device":
        from ._device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def remote(*args, **kwargs):
    """Turn a function into a remote task or a class into an actor class.

    Usable bare (``@remote``) or with options
    (``@remote(num_cpus=2, num_gpus=1)``) — reference:
    _private/worker.py:132-376 overloads.
    """

    def _make(target):
        if _inspect.isclass(target):
            return ActorClass(target, **kwargs)
        if callable(target):
            return RemoteFunction(target, **kwargs)
        raise TypeError(f"@remote target must be a function or class: {target}")

    if len(args) == 1 and not kwargs and (callable(args[0]) or _inspect.isclass(args[0])):
        return _make(args[0])
    if args:
        raise TypeError("@remote options must be keyword arguments")
    return _make


def method(**kwargs):
    """Decorator for actor methods carrying default options
    (reference: ray.method)."""

    def deco(fn):
        fn.__ray_method_options__ = kwargs
        return fn

    return deco
