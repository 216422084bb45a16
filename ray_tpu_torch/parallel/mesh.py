"""Device meshes and sharding rules on torch.distributed.

The port of `ray_tpu/parallel/mesh.py`. The reference declares a
`jax.sharding.Mesh` with five named axes and lets XLA compile the
collectives into the program; here the same five axes name the dims of a
`torch.distributed.device_mesh.DeviceMesh`, one rank per mesh position,
and the collectives are explicit (`parallel.ring`, `parallel.step`) or
come from FSDP2 and tensor parallelism (`shard_params`):

  data    -- data parallelism (gradient all-reduce)
  fsdp    -- data parallelism with sharded parameters (FSDP2)
  seq     -- sequence parallelism (ring attention)
  tensor  -- Megatron-style tensor parallelism within a layer
  expert  -- expert parallelism for MoE layers

torch has no `PartitionSpec`. A spec here is a plain tuple with one entry
per tensor dim: None (replicated), a mesh axis name, or a tuple of names
(the dim is split over those axes, major first). `to_placements` turns it
into DTensor placements, one per mesh dim.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

AXIS_ORDER = ("data", "fsdp", "seq", "tensor", "expert")

# logical axis -> mesh axis (or tuple of mesh axes). First matching rule
# wins; None means replicate.
LOGICAL_RULES: List[Tuple[str, Any]] = [
    ("batch", ("data", "fsdp")),
    ("seq", "seq"),
    ("embed", "fsdp"),
    ("heads", "tensor"),
    ("kv_heads", "tensor"),
    ("qkv", None),
    ("mlp", "tensor"),
    ("vocab", "tensor"),
    ("expert", "expert"),
    ("norm", None),
    ("head_dim", None),
]

Spec = Tuple[Any, ...]


@dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape: the size of each of the five axes."""

    data: int = 1
    fsdp: int = 1
    seq: int = 1
    tensor: int = 1
    expert: int = 1

    def axis_sizes(self) -> Dict[str, int]:
        return {
            "data": self.data,
            "fsdp": self.fsdp,
            "seq": self.seq,
            "tensor": self.tensor,
            "expert": self.expert,
        }

    @property
    def num_devices(self) -> int:
        return self.data * self.fsdp * self.seq * self.tensor * self.expert

    @classmethod
    def for_devices(cls, n: int, *, strategy: str = "fsdp") -> "MeshSpec":
        """Fill one axis with all devices (simple presets)."""
        if strategy not in AXIS_ORDER:
            raise ValueError(f"strategy must be one of {AXIS_ORDER}")
        return cls(**{strategy: n})

    def build(self, device_type: str = "cuda") -> DeviceMesh:
        """The mesh over ranks 0..num_devices-1 of the default process
        group, dims in `AXIS_ORDER`, size-1 axes kept (so `mesh["seq"]`
        always exists). Every rank of the world calls it. On a world
        larger than the mesh the first `num_devices` ranks form it, as the
        reference takes the first devices; the others hold no coordinate
        (`get_coordinate()` is None)."""
        world = dist.get_world_size()
        if world < self.num_devices:
            raise ValueError(
                f"MeshSpec needs {self.num_devices} devices, have {world}"
            )
        shape = tuple(self.axis_sizes()[a] for a in AXIS_ORDER)
        return init_device_mesh(device_type, shape, mesh_dim_names=AXIS_ORDER)


def mesh_axes_for_logical(logical: str) -> Any:
    for name, axes in LOGICAL_RULES:
        if name == logical:
            return axes
    return None


def logical_to_spec(logical_axes: Sequence[Optional[str]]) -> Spec:
    """("batch", "seq", "embed") -> (("data", "fsdp"), "seq", None): a mesh
    axis shards at most one dim, so "embed" replicates once "batch" has
    taken "fsdp"."""
    out = []
    used: set = set()
    for ax in logical_axes:
        mesh_axes = mesh_axes_for_logical(ax) if ax is not None else None
        if mesh_axes is not None:
            flat = mesh_axes if isinstance(mesh_axes, tuple) else (mesh_axes,)
            if any(a in used for a in flat):
                mesh_axes = None
            else:
                used.update(flat)
        out.append(mesh_axes)
    return tuple(out)


def to_placements(spec: Spec, mesh: DeviceMesh) -> List[Any]:
    """DTensor placements of `spec` on `mesh`, one per mesh dim: `Shard(d)`
    on every mesh axis that splits tensor dim d (a dim split over
    ("data", "fsdp") is `Shard(d)` on both), `Replicate()` elsewhere."""
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("to_placements needs a mesh with named dims")
    placements: List[Any] = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in entry if isinstance(entry, tuple) else (entry,):
            if axis in names:
                placements[names.index(axis)] = Shard(dim)
    return placements


def with_logical_constraint(x, logical_axes: Sequence[Optional[str]], mesh=None):
    """Places a DTensor `x` as `logical_axes` say on `mesh`. A no-op when
    there is no mesh or `x` is a plain tensor, so model code can annotate
    unconditionally; the reference's is a no-op without an ambient mesh."""
    if mesh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, to_placements(logical_to_spec(logical_axes), mesh))


def spec_for_param(path: Tuple[str, ...], shape: Tuple[int, ...]) -> Spec:
    """Spec of a parameter by name and shape, on the port's layouts.
    Every 2-D weight reads ("tensor", "fsdp"): embedding tables [V, H]
    (vocab=tensor, embed=fsdp), and `Dense` weights [out, in], where the
    reference's [in, out] layout gives (in=fsdp, out=tensor). Stacked MoE
    experts ([E, in, out], as in the reference): experts on `expert`,
    then (fsdp, tensor), or (tensor, fsdp) for `w_down`. A 3-D (heads, head_dim, embed) projection:
    ("tensor", None, "fsdp"). 1-D scales replicate."""
    if len(shape) <= 1:
        return ()
    name = "/".join(str(p) for p in path).lower()
    if len(shape) == 2:
        return ("tensor", "fsdp")
    if len(shape) == 3 and ("expert" in name or "w_gate" in name
                            or "w_up" in name or "w_down" in name):
        if "w_down" in name:
            return ("expert", "tensor", "fsdp")
        return ("expert", "fsdp", "tensor")
    if len(shape) == 3:
        return ("tensor", None, "fsdp")
    return (None,) * len(shape)


def shard_params(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Places a Llama (`models.llama.LlamaForCausalLM`) on the mesh, in
    place: tensor parallelism over "tensor" (`parallelize_module`:
    column-parallel q, k, v, gate and up projections, row-parallel o and
    down projections, the embedding sharded over the vocabulary), then
    FSDP2 over ("data", "fsdp") (`fully_shard` per decoder layer and at
    the root; with both axes larger than 1, HSDP: replicated over "data",
    sharded over "fsdp"). FSDP2 shards each parameter on the dim that
    `spec_for_param` gives to "fsdp". Gradients come out reduced: summed
    over "tensor" where the layer needs it, averaged over "data" and
    "fsdp". On a mesh with "seq" the model must have been built on it
    (its attention runs the ring over the TP-local heads), and
    `parallel.step.reduce_gradients` adds the sum over "seq". The
    reference's `shard_params` only places arrays and leaves the
    collectives to GSPMD."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
        parallelize_module,
    )

    if mesh["expert"].size() > 1:
        raise ValueError("shard_params places a Llama; experts are split over the "
                         "expert axis by models.mixtral.MixtralForCausalLM(cfg, mesh)")
    if mesh["seq"].size() > 1 and any(layer.attn.ring_mesh is None for layer in model.layers):
        raise ValueError("a mesh with seq > 1 needs a model built on it "
                         "(LlamaForCausalLM(cfg, mesh)), whose attention runs the ring")
    if mesh["tensor"].size() > 1:
        plan: Dict[str, Any] = {
            "embed_tokens": RowwiseParallel(input_layouts=Replicate(),
                                            output_layouts=Replicate()),
        }
        for i in range(len(model.layers)):
            pre = f"layers.{i}."
            for name in ("attn.q_proj", "attn.k_proj", "attn.v_proj",
                         "mlp.gate_proj", "mlp.up_proj"):
                plan[pre + name] = ColwiseParallel()
            for name in ("attn.o_proj", "mlp.down_proj"):
                plan[pre + name] = RowwiseParallel()
        parallelize_module(model, mesh["tensor"], plan)

    names = {id(p): name for name, p in model.named_parameters()}

    def fsdp_dim(param):
        spec = spec_for_param(tuple(names[id(param)].split(".")), tuple(param.shape))
        return Shard(spec.index("fsdp") if "fsdp" in spec else 0)

    dp_mesh = mesh["data", "fsdp"]
    for layer in model.layers:
        fully_shard(layer, mesh=dp_mesh, shard_placement_fn=fsdp_dim)
    fully_shard(model, mesh=dp_mesh, shard_placement_fn=fsdp_dim)
    return model


def pad_to_multiple(n: int, k: int) -> int:
    return int(math.ceil(n / k) * k)
