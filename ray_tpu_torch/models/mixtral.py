"""Mixtral-style sparse-MoE causal LM in PyTorch: the port of
`ray_tpu/models/mixtral.py`.

The decoder is Llama's (`models.llama`: RMSNorm, rotary GQA attention on
the flash kernels) with the dense MLP replaced by a top-k routed mixture of
SwiGLU experts. Numerics mirror the flax model, so the two can be held
against each other with the same weights (`convert.mixtral_params_from_flax`):
the router runs in float32, the top-k gates are renormalised, the experts
compute in `dtype`, and the head is always tied (`Embed.attend`), whatever
`tie_embeddings` says.

Three dispatch backends (`MixtralConfig.moe_dispatch`):

- "gmm": tile-aligned, expert-sorted rows through the grouped-matmul
  kernels of `ops.gmm` (K4, K5): at most E * 128 rows of padding, no
  drops. The main path.
- "capacity": capacity-bounded [E, B, C, D] buffers and batched einsums;
  a pair past its expert's capacity is dropped.
- "ragged": exact groups, each expert's product over all rows with the
  rows of other experts masked out: the semantic oracle (E times the
  work), used in tests and the smoke. Nothing on any path waits for the
  device.

The router's load-balancing loss is returned by each layer and collected by
the model (the flax model sows it), so a checkpointed layer's recompute
changes no state.

With a `mesh` (`parallel.mesh.MeshSpec.build`), rows split over ("data",
"fsdp") and the sequence over "seq" (the ring, as in Llama); the router's
batch statistics are summed over those axes, so the load-balancing loss is
the global batch's, as under the reference's GSPMD. Capacity positions run
over the whole sequence: each seq rank adds the arrivals of the shards
before it (`capacity_slots`), so a pair drops where it drops on one device.

Two axes split the MoE layer's work, and every split weight is drawn whole
from the same seed and cut, so the weights are the single-device model's:

- `expert` (size ep): rank e holds experts [e E/ep, (e+1) E/ep) of every
  layer. "auto" is "capacity" there, as the reference's
  `resolve_moe_dispatch` returns; an explicit "gmm" or "ragged" runs over
  the pairs routed to this rank's experts only (for "gmm" a layout of
  those pairs alone, through K4/K5 on every rank), so it drops nothing;
- `tensor` (size tp): rank r holds F/tp columns of each expert's gate and
  up projections and the matching rows of its down projection (the
  reference's P("expert", "fsdp", "tensor") and P("expert", "tensor",
  "fsdp")). Attention takes the plan that `parallel.mesh.shard_params`
  gives a Llama's (`parallel.mesh.layer_plan`: column-parallel q, k and v,
  row-parallel o, as DTensors over mesh["tensor"]), so it holds H/tp query
  and Hkv/tp key-value heads.

The ranks of these groups see the same rows. Each routes all of them and
runs its share; partial outputs are summed over the groups
(`parallel.collectives.reduce_from_group`) and the gradients of the inputs
and gates summed back (`copy_to_group`), so every replicated gradient comes
out whole on each rank and the router's loss counts once. Every exchange
is an all-reduce, which gloo carries for CUDA tensors. Over "tensor" the
experts' partial outputs are summed before the combine, the expert
ranks' combined outputs after it. All products compute in `dtype`, as on
one device.
"""
from __future__ import annotations

import functools
import json
import math
import os
import statistics
import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import DeviceLike, resolve_device
from ..ops.gmm import aligned_group_layout, gmm
from ..parallel.collectives import (
    all_reduce_sum_,
    copy_to_group,
    reduce_from_group,
    sum_over_groups,
)
from .llama import (
    Attention,
    Dense,
    Embed,
    LlamaConfig,
    RMSNorm,
    _param,
    _uses_ring,
    causal_lm_loss,
    init_parameters,
    run_layer,
)

DISPATCHES = ("ragged", "capacity", "gmm")
EXPERT_PARAMS = ("w_gate", "w_up", "w_down")


@dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    num_experts: int = 8
    num_experts_per_tok: int = 2  # top-k routing
    # Save matmul outputs in remat, recompute the elementwise work.
    remat_policy: str = "dots"
    # Per-expert token capacity = capacity_factor * T * k / E (capacity
    # dispatch only).
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.02
    # "auto": the backend `resolve_moe_dispatch` measured for this shape,
    # else "capacity"; or one of DISPATCHES.
    moe_dispatch: str = "auto"

    def num_params(self) -> int:
        """Llama's count without its dense MLP, plus E stacked experts and
        the router. As in the reference, Llama's count includes an untied
        head (V * H) unless `tie_embeddings`, though the model's head is
        always tied: the count stays the reference's, so MFU compares."""
        h, i, l = self.hidden_size, self.intermediate_size, self.num_layers
        dense_mlp = 3 * h * i
        moe_mlp = self.num_experts * 3 * h * i + h * self.num_experts
        return super().num_params() + l * (moe_mlp - dense_mlp)

    def active_params_per_token(self) -> int:
        """Parameters a token's FLOPs touch: only the top-k experts (what an
        MFU estimate uses); the head is counted as in `num_params`."""
        h, i, l = self.hidden_size, self.intermediate_size, self.num_layers
        dense_mlp = 3 * h * i
        active_mlp = self.num_experts_per_tok * 3 * h * i + h * self.num_experts
        return super().num_params() + l * (active_mlp - dense_mlp)


CONFIGS: Dict[str, MixtralConfig] = {
    "mixtral-tiny": MixtralConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, num_experts=4, num_experts_per_tok=2,
        max_seq_len=256,
    ),
    "mixtral-small": MixtralConfig(
        vocab_size=32000, hidden_size=1024, intermediate_size=3584,
        num_layers=8, num_heads=16, num_kv_heads=8, num_experts=8,
        num_experts_per_tok=2, max_seq_len=4096,
    ),
}


# ------------------------------------------------------------ dispatch choice

# moe_dispatch="auto" resolutions by _shape_key, set by resolve_moe_dispatch
# and read by MoELayer.
_RESOLVED: Dict[str, str] = {}
# The probe's median seconds per forward + backward step of each backend, by
# disk-cache key, for every probe this process ran.
PROBE_SECONDS: Dict[str, Dict[str, float]] = {}
# "capacity" is picked only when its median step is this much shorter than
# "gmm"'s: the two differ by a few percent at mixtral-small, less than one
# round of host-bound eager steps varies, and "gmm" drops no tokens.
PROBE_MARGIN = 0.1
PROBE_REPEATS = 5


def _shape_key(cfg: MixtralConfig) -> str:
    return (f"E{cfg.num_experts}-K{cfg.num_experts_per_tok}-"
            f"D{cfg.hidden_size}-F{cfg.intermediate_size}")


def _cache_path() -> str:
    return os.path.join(os.path.expanduser("~"), ".cache", "ray_tpu_torch",
                        "moe_dispatch.json")


def _probe_step(cfg: MixtralConfig, name: str, tokens: int, device: torch.device):
    """One forward + backward pass of one MoE layer with dispatch `name`
    over `tokens` tokens, as a function of no arguments."""
    layer = MoELayer(replace(cfg, moe_dispatch=name), device=device,
                     generator=torch.Generator(device=device).manual_seed(0))
    x = torch.as_tensor(np.random.RandomState(0).randn(1, tokens, cfg.hidden_size),
                        dtype=cfg.dtype, device=device)

    def step():
        out, _ = layer(x)
        return torch.autograd.grad(out.float().pow(2).sum(), list(layer.parameters()))

    return step


def _probe_seconds(cfg: MixtralConfig, tokens: int, steps: int,
                   device: torch.device) -> Dict[str, float]:
    """Median seconds per step of "capacity" and "gmm": PROBE_REPEATS rounds of
    `steps` steps each, the backends taking turns so that both see the
    same drift of the host. Raises if a backend fails."""
    runs = {name: _probe_step(cfg, name, tokens, device) for name in ("capacity", "gmm")}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rounds: Dict[str, List[float]] = {name: [] for name in runs}
    for step in runs.values():
        step()
    for _ in range(PROBE_REPEATS):
        for name, step in runs.items():
            sync()
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            sync()
            rounds[name].append((time.perf_counter() - t0) / steps)
    return {name: statistics.median(r) for name, r in rounds.items()}


# An axis that splits work: (its group, this rank's index on it, its size).
Split = Tuple[object, int, int]


def _split(mesh, axis: str) -> Optional[Split]:
    """The mesh's `axis` as a `Split`, or None without a mesh or when the
    axis has one rank."""
    if mesh is None or mesh[axis].size() == 1:
        return None
    return mesh.get_group(axis), mesh[axis].get_local_rank(), mesh[axis].size()


def _expert_parallel(mesh) -> bool:
    return _split(mesh, "expert") is not None


def resolve_moe_dispatch(cfg: MixtralConfig, tokens: int = 4096, steps: int = 10,
                         device: DeviceLike = None, mesh=None) -> str:
    """The MoE dispatch backend for this config on this device.

    A config's explicit backend wins, on any mesh. On a mesh whose
    "expert" axis is larger than 1, "auto" is "capacity", cached for the
    shape without a probe, as the reference returns it. Otherwise the env
    override `RAY_TPU_MOE_DISPATCH` comes next. For "auto", a timed probe of "capacity" against
    "gmm" (forward and backward of one layer at this config's widths over
    `tokens` tokens, the median of PROBE_REPEATS rounds of `steps` steps) takes
    "capacity" only if it is faster by more than `PROBE_MARGIN`, else
    "gmm"; the reference takes whichever is faster. Resolutions are kept
    per process and on disk in `~/.cache/ray_tpu_torch/moe_dispatch.json`,
    keyed by the device's name (or "cpu") and the shape, so a machine
    probes once. A backend that fails in the probe raises: the reference
    would quietly take "capacity", which on the card would hide a failing
    kernel.
    """
    skey = _shape_key(cfg)
    if cfg.moe_dispatch != "auto":
        return cfg.moe_dispatch
    if _expert_parallel(mesh):
        _RESOLVED[skey] = "capacity"
        return "capacity"
    env = os.environ.get("RAY_TPU_MOE_DISPATCH")
    if env:
        if env not in DISPATCHES:
            raise ValueError(f"RAY_TPU_MOE_DISPATCH must be one of {DISPATCHES}, got {env!r}")
        _RESOLVED[skey] = env
        return env
    if skey in _RESOLVED:
        return _RESOLVED[skey]
    device = resolve_device(device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    cache_key = f"{kind}-{skey}-N{tokens}"
    path = _cache_path()
    try:
        with open(path) as f:
            disk = json.load(f)
    except (OSError, ValueError):
        disk = {}
    if cache_key in disk:
        _RESOLVED[skey] = disk[cache_key]
        return disk[cache_key]

    probe_cfg = replace(cfg, vocab_size=256, num_layers=1, num_heads=4,
                        num_kv_heads=4, remat=False)
    seconds = _probe_seconds(probe_cfg, tokens, steps, device)
    PROBE_SECONDS[cache_key] = seconds
    faster = seconds["capacity"] < (1.0 - PROBE_MARGIN) * seconds["gmm"]
    winner = "capacity" if faster else "gmm"
    _RESOLVED[skey] = winner
    disk[cache_key] = winner
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(disk, f)
    return winner


# ------------------------------------------------------------ the MoE layer


def _expert_ffn(x, w_gate, w_up, w_down):
    """SwiGLU through one expert's [D, F], [D, F], [F, D] matrices."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def capacity_slots(gate_idx: torch.Tensor, expert_mask: torch.Tensor,
                   cfg: MixtralConfig, seq: Optional[Split] = None) -> Tuple[torch.Tensor, int]:
    """Each (token, k) pair's slot in the capacity buffers [B, E * C]: the
    first C = capacity_factor * T * K / E arrivals per expert in each batch
    row (by a cumsum over T) keep expert * C + position, later pairs are
    dropped to dump slots E * C + pair. Returns (slot [B, T * K], C). Rows
    are routed apart, so splitting the batch moves no drop.

    With `seq`, the tokens are this rank's contiguous shard of a sequence
    split over its group, and T and the positions are the whole
    sequence's: each expert's arrivals on the shards before this one (an
    exclusive prefix of every shard's counts, which an all-reduce of a
    zero-padded [n, B, E] buffer gives each rank) are added to the
    shard's own. So a pair is dropped exactly where it is on one device."""
    b, t, k = gate_idx.shape
    e = cfg.num_experts
    # Arrival position of each token within its expert, per batch row.
    position = torch.cumsum(expert_mask, dim=1) - expert_mask  # [B, T, E]
    t_all = t
    if seq is not None:
        group, rank, n = seq
        with torch.no_grad():
            counts = expert_mask.new_zeros((n, b, e))
            counts[rank] = expert_mask.sum(1)
            all_reduce_sum_(counts, group)
        position = position + counts[:rank].sum(0)[:, None, :]
        t_all = t * n
    c = max(1, int(cfg.capacity_factor * t_all * k / e))
    pos = position.gather(2, gate_idx).reshape(b, t * k).long()
    e_flat = gate_idx.reshape(b, t * k)
    pair = torch.arange(t * k, device=gate_idx.device)
    return torch.where(pos < c, e_flat * c + pos, e * c + pair), c


def take_parts(full: torch.Tensor, parts: List[Tuple[int, int, int]]) -> torch.Tensor:
    """`full` narrowed by each (dim, start, length) of `parts` in turn."""
    for dim, start, length in parts:
        full = full.narrow(dim, start, length)
    return full


def is_expert_param(name: str) -> bool:
    """Whether the parameter `name` holds experts, split over "expert"."""
    return name.rsplit(".", 1)[-1] in EXPERT_PARAMS


class MoELayer(nn.Module):
    """Top-k router and E SwiGLU experts. `forward(x)` returns the layer's
    output [B, T, D] and the router's load-balancing loss (Switch
    Transformer: E * sum over experts of token fraction * mean gate
    probability). Weights are stored as the reference's: router [E, D],
    experts w_gate, w_up [E, D, F] and w_down [E, F, D]; on a mesh, this
    rank's E / ep experts of each, and of each expert its F / tp part."""

    def __init__(self, cfg: MixtralConfig, *, mesh=None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        e, d, f = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
        # The groups the router's batch statistics are summed over.
        self.batch_groups = [mesh.get_group(a) for a in ("data", "fsdp", "seq")
                             if mesh is not None and mesh[a].size() > 1]
        self.batch_ranks = math.prod(mesh[a].size() for a in ("data", "fsdp", "seq")) \
            if mesh is not None else 1
        self.seq = _split(mesh, "seq")
        # The groups that split the layer's work, this rank's first expert
        # and its part of F.
        expert, tensor = _split(mesh, "expert"), _split(mesh, "tensor")
        self.expert_group = expert[0] if expert is not None else None
        self.tensor_group = tensor[0] if tensor is not None else None
        self.first_expert, local = 0, e
        if expert is not None:
            _, rank, ep = expert
            if e % ep:
                raise ValueError(f"{e} experts do not split over an expert axis of {ep}")
            local = e // ep
            self.first_expert = rank * local
        self.f_part = (0, 1)
        if tensor is not None:
            _, rank, tp = tensor
            if f % tp:
                raise ValueError(f"intermediate size {f} does not split over a tensor "
                                 f"axis of {tp}")
            self.f_part = (rank, tp)
        fl = f // self.f_part[1]
        self.router = Dense(d, e, torch.float32, cfg.param_dtype, device)
        self.w_gate = _param((local, d, fl), cfg.param_dtype, device)
        self.w_up = _param((local, d, fl), cfg.param_dtype, device)
        self.w_down = _param((local, fl, d), cfg.param_dtype, device)
        self.dispatch()
        if generator is not None:
            init_parameters(self, generator)
            self.init_experts(generator)

    def experts(self) -> Tuple[torch.Tensor, ...]:
        return (self.w_gate, self.w_up, self.w_down)

    def local_experts(self) -> slice:
        """This rank's experts among all E."""
        return slice(self.first_expert, self.first_expert + self.w_gate.shape[0])

    def expert_parts(self, name: str) -> List[Tuple[int, int, int]]:
        """The narrows (`take_parts`) that cut this rank's part of
        the expert weight `name` out of the whole [E, ...] one: its experts,
        then its part of F (dim 2 of w_gate and w_up, dim 1 of w_down)."""
        experts, (index, parts) = self.local_experts(), self.f_part
        out = []
        if experts.stop - experts.start < self.cfg.num_experts:
            out.append((0, experts.start, experts.stop - experts.start))
        if parts > 1:
            fl = self.cfg.intermediate_size // parts
            out.append((1 if name == "w_down" else 2, index * fl, fl))
        return out

    @torch.no_grad()
    def init_experts(self, generator: torch.Generator) -> None:
        """All E experts of each weight drawn whole in turn, this rank's
        part kept."""
        e, d, f = self.cfg.num_experts, self.cfg.hidden_size, self.cfg.intermediate_size
        for name, w in zip(EXPERT_PARAMS, self.experts()):  # [E, fan_in, fan_out]
            shape = (e, f, d) if name == "w_down" else (e, d, f)
            full = torch.empty(shape, dtype=w.dtype, device=w.device)
            full.normal_(0.0, shape[1] ** -0.5, generator=generator)
            w.copy_(take_parts(full, self.expert_parts(name)))

    def dispatch(self) -> str:
        cfg = self.cfg
        name = cfg.moe_dispatch
        if name == "auto":
            name = "capacity" if self.expert_group is not None else \
                _RESOLVED.get(_shape_key(cfg), "capacity")
        if name not in DISPATCHES:
            raise ValueError(f"moe_dispatch must be 'auto' or one of {DISPATCHES}, "
                             f"got {cfg.moe_dispatch!r}")
        return name

    def forward(self, x):
        cfg = self.cfg
        dispatch = self.dispatch()
        e, k = cfg.num_experts, cfg.num_experts_per_tok
        probs = torch.softmax(self.router(x.float()), dim=-1)  # [B, T, E]
        gate_vals, gate_idx = torch.topk(probs, k, dim=-1)    # [B, T, K]
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
        # Top-k ids are distinct, so this is the one-hot summed over k.
        expert_mask = torch.zeros_like(probs).scatter_(-1, gate_idx, 1.0)
        fractions = torch.stack([expert_mask.mean(dim=(0, 1)), probs.mean(dim=(0, 1))])
        if self.batch_groups:
            # The global batch's means: every rank holds as many rows.
            fractions = sum_over_groups(fractions / self.batch_ranks, self.batch_groups)
        frac_tokens, frac_probs = fractions
        aux = e * (frac_tokens * frac_probs).sum()

        xd = x.to(cfg.dtype)
        weights = [w.to(cfg.dtype) for w in self.experts()]
        gates = gate_vals.to(cfg.dtype)
        # The experts' inputs meet a part of every product on each rank of
        # both groups; the gates meet only this expert rank's pairs (the
        # tensor ranks combine whole outputs, `_expert_outputs`).
        for group in (self.expert_group, self.tensor_group):
            if group is not None:
                xd = copy_to_group(xd, group)
        if self.expert_group is not None:
            gates = copy_to_group(gates, self.expert_group)
        if dispatch == "capacity":
            out = self._capacity(xd, gate_idx, gates, expert_mask, weights)
        else:
            fn = self._gmm if dispatch == "gmm" else self._ragged
            out = fn(xd, gate_idx, gates, weights)
        if self.expert_group is not None:
            out = reduce_from_group(out, self.expert_group)
        return out, aux

    def _expert_outputs(self, eo):
        """The experts' outputs, whole: where F is split over "tensor", the
        partials summed over the group."""
        if self.tensor_group is None:
            return eo
        return reduce_from_group(eo, self.tensor_group)

    def _gmm(self, x, gate_idx, gates, weights):
        """Expert-sorted rows in the tile-aligned layout through K4/K5. On
        an expert mesh, only the pairs routed to this rank's experts, with
        their local expert ids: their count, read back to the host, sizes
        the layout."""
        b, t, d = x.shape
        k = self.cfg.num_experts_per_tok
        n = b * t * k
        dev = x.device
        group = gate_idx.reshape(n)
        tok = torch.arange(n, device=dev) // k
        gate = gates.reshape(n)
        experts = self.local_experts()
        if self.expert_group is not None:
            pairs = ((group >= experts.start) & (group < experts.stop)).nonzero().squeeze(1)
            group, tok, gate = group[pairs] - experts.start, tok[pairs], gate[pairs]
        m = group.shape[0]
        order, dst, tile_group, m_pad = aligned_group_layout(
            group, experts.stop - experts.start)
        tok_sorted = tok[order]
        # Row gather into the layout: slot -> sorted pair, padding slots
        # reading the zero row b * t.
        inv = torch.full((m_pad,), m, dtype=torch.long, device=dev).scatter_(
            0, dst, torch.arange(m, device=dev))
        src_tok = torch.cat([tok_sorted, torch.full((1,), b * t, device=dev)])[inv]
        x_pad = torch.cat([x.reshape(b * t, d), x.new_zeros((1, d))])
        lhs = x_pad[src_tok]  # [m_pad, D]
        w_gate, w_up, w_down = weights
        act = F.silu(gmm(lhs, w_gate, tile_group)) * gmm(lhs, w_up, tile_group)
        eo = self._expert_outputs(gmm(act, w_down, tile_group))
        pair_out = eo[dst] * gate[order][:, None]
        out = x.new_zeros((b * t, d)).index_add_(0, tok_sorted, pair_out)
        return out.reshape(b, t, d)

    def _ragged(self, x, gate_idx, gates, weights):
        """Exact groups: every pair through its own expert. Each of this
        rank's experts runs its product over all rows and keeps its own: a
        loop with no group size read back to the host; the pairs of other
        ranks' experts keep a zero row."""
        b, t, d = x.shape
        k = self.cfg.num_experts_per_tok
        n = b * t * k
        e_flat = gate_idx.reshape(n)
        order = torch.argsort(e_flat, stable=True)
        tok_sorted = (torch.arange(n, device=x.device) // k)[order]
        xs = x.reshape(b * t, d)[tok_sorted]
        e_sorted = e_flat[order][:, None]
        eo = torch.zeros_like(xs)
        for i in range(weights[0].shape[0]):
            ffn = _expert_ffn(xs, *(w[i] for w in weights))
            eo = torch.where(e_sorted == self.first_expert + i, ffn, eo)
        pair_out = self._expert_outputs(eo) * gates.reshape(n)[order][:, None]
        out = x.new_zeros((b * t, d)).index_add_(0, tok_sorted, pair_out)
        return out.reshape(b, t, d)

    def _capacity(self, x, gate_idx, gates, expert_mask, weights):
        """Capacity-bounded [E, B, C, D] buffers (`capacity_slots`), of this
        rank's experts only; pairs of other experts and dropped pairs read
        a zero row in the combine."""
        b, t, d = x.shape
        k = self.cfg.num_experts_per_tok
        nk = t * k
        slot, c = capacity_slots(gate_idx, expert_mask, self.cfg, self.seq)
        experts = self.local_experts()
        lo, n_local = experts.start * c, (experts.stop - experts.start) * c
        dev = x.device
        pair = torch.arange(nk, device=dev)
        inv = torch.full((b, self.cfg.num_experts * c + nk), t, dtype=torch.long,
                         device=dev).scatter_(1, slot, (pair // k).expand(b, nk))
        rows = torch.arange(b, device=dev)[:, None]
        x_pad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
        buf = x_pad[rows, inv[:, lo:lo + n_local]]  # [B, E_local*C, D] row gather
        expert_in = buf.reshape(b, -1, c, d).transpose(0, 1)  # [E_local, B, C, D]
        w_gate, w_up, w_down = weights
        h = torch.einsum("ebcd,edf->ebcf", expert_in, w_gate)
        u = torch.einsum("ebcd,edf->ebcf", expert_in, w_up)
        expert_out = self._expert_outputs(
            torch.einsum("ebcf,efd->ebcd", F.silu(h) * u, w_down))
        expert_out = expert_out.transpose(0, 1).reshape(b, n_local, d)
        eo_pad = torch.cat([expert_out, x.new_zeros((b, 1, d))], dim=1)
        mine = (slot >= lo) & (slot < lo + n_local)
        local_slot = torch.where(mine, slot - lo, n_local)
        pair_out = eo_pad[rows, local_slot] * gates.reshape(b, nk)[..., None]
        return pair_out.reshape(b, t, k, d).sum(2)


class MoEDecoderLayer(nn.Module):
    def __init__(self, cfg: MixtralConfig, device, mesh=None):
        super().__init__()
        norm = functools.partial(RMSNorm, cfg.hidden_size, cfg.rms_eps,
                                 cfg.param_dtype, device)
        self.input_norm = norm()
        self.attn = Attention(cfg, device, mesh)
        self.post_attn_norm = norm()
        self.moe = MoELayer(cfg, mesh=mesh, device=device)

    def forward(self, x, positions):
        h = x + self.attn(self.input_norm(x), positions)
        out, aux = self.moe(self.post_attn_norm(h))
        return h + out, aux


class MixtralForCausalLM(nn.Module):
    """The sparse-MoE causal LM. Parameters are made on `device` (the CUDA
    card unless the caller passes one) from `generator`, seed 0 by default:
    normal with std 1/sqrt(fan_in) for projections, router and experts,
    1/sqrt(hidden) for the embedding, ones for norm scales. Every rank of
    a `mesh` draws the same weights and keeps its part of the split ones
    (`split_parts`); over "tensor" the attention's projections are then
    DTensors (`parallel.mesh.layer_plan`). `forward` takes this rank's rows
    (and sequence shard; `parallel.step.shard_batch`)."""

    def __init__(self, cfg: MixtralConfig, mesh=None, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.seq_rank = mesh["seq"].get_local_rank() if _uses_ring(mesh) else 0
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size, cfg.dtype,
                                  cfg.param_dtype, device)
        self.layers = nn.ModuleList(
            MoEDecoderLayer(cfg, device, mesh) for _ in range(cfg.num_layers)
        )
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps,
                                  cfg.param_dtype, device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.reset_parameters(generator)
        tensor = _split(mesh, "tensor")
        self.tensor_rank = 0 if tensor is None else tensor[1]
        if tensor is not None:
            from torch.distributed.tensor.parallel import parallelize_module

            from ..parallel.mesh import layer_plan

            plan = {}
            for i in range(cfg.num_layers):
                plan.update(layer_plan(f"layers.{i}.", mlp=False))
            # Every rank drew the same weights: each keeps its part, with
            # no exchange.
            parallelize_module(self, mesh["tensor"], plan, src_data_rank=None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_parameters(self, generator)
        for layer in self.layers:
            layer.moe.init_experts(generator)

    def forward(self, input_ids, positions=None, return_aux: bool = False):
        """Logits [B, T, V] in `dtype`, and with `return_aux=True` also the
        list of each layer's router loss."""
        cfg = self.cfg
        if positions is None:
            t = input_ids.shape[1]
            positions = torch.arange(
                self.seq_rank * t, (self.seq_rank + 1) * t, device=input_ids.device
            ).expand(input_ids.shape)
        x = self.embed_tokens(input_ids)
        aux: List[torch.Tensor] = []
        for layer in self.layers:
            x, layer_aux = run_layer(cfg, layer, x, positions)
            aux.append(layer_aux)
        x = self.final_norm(x)
        # Always tied, as the reference's `emb.attend(x.astype(param_dtype))`,
        # which casts both operands to `dtype`.
        logits = F.linear(x.to(cfg.param_dtype).to(cfg.dtype),
                          self.embed_tokens.weight.to(cfg.dtype))
        return (logits, aux) if return_aux else logits


def moe_lm_loss(model: MixtralForCausalLM, input_ids: torch.Tensor,
                targets: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal LM loss plus `router_aux_loss_coef` times the layers' mean
    router loss."""
    logits, aux = model(input_ids, return_aux=True)
    loss = causal_lm_loss(logits, targets, mask)
    if aux:
        loss = loss + model.cfg.router_aux_loss_coef * (sum(aux) / len(aux))
    return loss


def split_parts(model: MixtralForCausalLM) -> Dict[str, List[Tuple[int, int, int]]]:
    """For each parameter that `model`'s mesh splits, the narrows
    (`take_parts`) that cut this rank's part out of the single-device
    parameter: the experts and their part of F, and under tensor
    parallelism the attention's DTensor shards."""
    from torch.distributed.tensor import DTensor, Shard

    parts = {}
    for prefix, module in model.named_modules():
        if isinstance(module, MoELayer):
            for name in EXPERT_PARAMS:
                parts[f"{prefix}.{name}"] = module.expert_parts(name)
    for name, p in model.named_parameters():
        if isinstance(p, DTensor):
            (place,) = p.placements
            assert isinstance(place, Shard), (name, place)
            n = p.to_local().shape[place.dim]
            parts[name] = [(place.dim, model.tensor_rank * n, n)]
    return {name: p for name, p in parts.items() if p}


def shard_state(state: Dict[str, torch.Tensor], model: MixtralForCausalLM) -> Dict[str, torch.Tensor]:
    """A single-device state dict cut to `model`'s parts (`split_parts`),
    a DTensor parameter's as a DTensor of its placements, everything else
    as it is."""
    from torch.distributed.tensor import DTensor

    params = dict(model.named_parameters())
    parts = split_parts(model)
    out = {}
    for name, w in state.items():
        w, p = take_parts(w, parts.get(name, [])), params.get(name)
        if isinstance(p, DTensor):
            w = DTensor.from_local(w.to(p.device), p.device_mesh, p.placements, run_check=False)
        out[name] = w
    return out
