"""Llama-family causal LM in PyTorch: the port of `ray_tpu/models/llama.py`.

Architecture follows Llama-2: RMSNorm, rotary embeddings, GQA attention
on the flash kernels, SwiGLU MLP, untied or tied LM head. Numerics mirror
the flax model so the two can be held against each other with the same
weights (`ray_tpu_torch.convert`): weights are stored in `param_dtype`
and cast to `dtype` at each use, as flax's `dtype=` does (the embedding
table and both operands of every projection); norms and rotary angles are
computed in float32; the untied LM head computes in float32.

With a `mesh` (a `DeviceMesh` from `parallel.mesh.MeshSpec.build`) whose
`seq` axis is larger than 1, each rank holds a contiguous shard of the
sequence: attention runs `ring_self_attention` over the `seq` group, and
positions default to the shard's global ones. The reference's one-hot
embedding lookup on a mesh (`llama.py:210-222`) gives exactly the gather's
values (a one-hot row times the table), so the port keeps the gather. Its
sharding constraints are GSPMD hints with no counterpart here: tensor and
data parallelism come from `parallel.mesh.shard_params`.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from .._device import DeviceLike, resolve_device
from ..ops.attention import flash_attention
from ..ops.ring_attention import ring_self_attention


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    # "nothing": full per-layer recompute in backward (minimum memory).
    # "dots": save matmul outputs, recompute only the elementwise work.
    remat_policy: str = "nothing"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    def num_params(self) -> int:
        h, i, v, l = self.hidden_size, self.intermediate_size, self.vocab_size, self.num_layers
        hd = self.head_dim_
        attn = h * (self.num_heads * hd) * 2 + h * (self.num_kv_heads * hd) * 2
        mlp = 3 * h * i
        per_layer = attn + mlp + 2 * h
        emb = v * h * (1 if self.tie_embeddings else 2)
        return l * per_layer + emb + h


CONFIGS: Dict[str, LlamaConfig] = {
    # test-size
    "llama-tiny": LlamaConfig(
        vocab_size=512, hidden_size=128, intermediate_size=352, num_layers=2,
        num_heads=4, num_kv_heads=2, max_seq_len=256,
    ),
    "llama-125m": LlamaConfig(
        vocab_size=32000, hidden_size=768, intermediate_size=2048, num_layers=12,
        num_heads=12, num_kv_heads=12, max_seq_len=2048,
    ),
    "llama-1b": LlamaConfig(
        vocab_size=32000, hidden_size=2048, intermediate_size=5504, num_layers=22,
        num_heads=16, num_kv_heads=16, max_seq_len=4096,
    ),
    "llama-3b": LlamaConfig(
        vocab_size=32000, hidden_size=2560, intermediate_size=6912, num_layers=32,
        num_heads=20, num_kv_heads=20, max_seq_len=4096,
    ),
    "llama-2-7b": LlamaConfig(),  # the Llama-2-7B shape
}

_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    if op in _MATMULS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(cfg: LlamaConfig):
    if cfg.remat_policy == "dots":
        return functools.partial(create_selective_checkpoint_contexts, _save_dots)
    if cfg.remat_policy != "nothing":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    return None


def run_layer(cfg: LlamaConfig, layer: nn.Module, x, positions):
    """`layer(x, positions)`, checkpointed under the config's remat policy
    when gradients are on."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return layer(x, positions)
    context = _remat_context(cfg)
    if context is None:
        return checkpoint(layer, x, positions, use_reentrant=False)
    return checkpoint(layer, x, positions, use_reentrant=False, context_fn=context)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embeddings, half-split, angles in float32. x [B, H, T, D],
    positions [B, T]."""
    d = x.shape[-1]
    exponents = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    freqs = 1.0 / (theta ** exponents)
    angles = positions[:, None, :, None].float() * freqs  # [B, 1, T, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class Dense(nn.Linear):
    """y = x W^T with input and weight cast to `dtype` (flax's
    `Dense(dtype=...)`); the weight is stored [out, in] in `param_dtype`,
    no bias. An `nn.Linear`, so that tensor parallelism's
    `ColwiseParallel` and `RowwiseParallel` take it; `nn.Linear`'s own
    initialisation is skipped (`init_parameters` sets the weight)."""

    def __init__(self, in_features, out_features, dtype, param_dtype, device):
        nn.Module.__init__(self)
        self.in_features, self.out_features = in_features, out_features
        self.dtype = dtype
        self.weight = _param((out_features, in_features), param_dtype, device)
        self.register_parameter("bias", None)

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


class Embed(nn.Embedding):
    """Token lookup; the table [V, H] is stored in `param_dtype` and the
    rows come out in `dtype` (flax casts the table before the gather). An
    `nn.Embedding`, so that tensor parallelism can shard the vocabulary;
    `nn.Embedding`'s own initialisation is skipped."""

    def __init__(self, num_embeddings, features, dtype, param_dtype, device):
        nn.Module.__init__(self)
        self.num_embeddings, self.embedding_dim = num_embeddings, features
        self.padding_idx, self.max_norm, self.norm_type = None, None, 2.0
        self.scale_grad_by_freq, self.sparse = False, False
        self.dtype = dtype
        self.weight = _param((num_embeddings, features), param_dtype, device)

    def forward(self, ids):
        return F.embedding(ids, self.weight).to(self.dtype)


class RMSNorm(nn.Module):
    def __init__(self, features, eps, param_dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = _param((features,), param_dtype, device)

    def forward(self, x):
        xf = x.float()
        norm = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + self.eps)
        return (norm * self.scale.float()).to(x.dtype)


def _uses_ring(mesh) -> bool:
    return mesh is not None and mesh["seq"].size() > 1


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.ring_mesh = mesh if _uses_ring(mesh) else None
        hd, h = cfg.head_dim_, cfg.hidden_size
        dense = functools.partial(Dense, dtype=cfg.dtype,
                                  param_dtype=cfg.param_dtype, device=device)
        self.q_proj = dense(h, cfg.num_heads * hd)
        self.k_proj = dense(h, cfg.num_kv_heads * hd)
        self.v_proj = dense(h, cfg.num_kv_heads * hd)
        self.o_proj = dense(cfg.num_heads * hd, h)

    def forward(self, x, positions):
        cfg = self.cfg
        b, t, _ = x.shape
        hd = cfg.head_dim_
        # [B, T, H*D] -> [B, H, T, D]; under tensor parallelism the rank's
        # projections hold only its share of the heads.
        q = self.q_proj(x).view(b, t, -1, hd).transpose(1, 2)
        k = self.k_proj(x).view(b, t, -1, hd).transpose(1, 2)
        v = self.v_proj(x).view(b, t, -1, hd).transpose(1, 2)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        if self.ring_mesh is not None:
            o = ring_self_attention(q, k, v, self.ring_mesh, causal=True)
        else:
            o = flash_attention(q, k, v, causal=True)
        return self.o_proj(o.transpose(1, 2).reshape(b, t, -1))


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, device):
        super().__init__()
        dense = functools.partial(Dense, dtype=cfg.dtype,
                                  param_dtype=cfg.param_dtype, device=device)
        self.gate_proj = dense(cfg.hidden_size, cfg.intermediate_size)
        self.up_proj = dense(cfg.hidden_size, cfg.intermediate_size)
        self.down_proj = dense(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device, mesh=None):
        super().__init__()
        norm = functools.partial(RMSNorm, cfg.hidden_size, cfg.rms_eps,
                                 cfg.param_dtype, device)
        self.input_norm = norm()
        self.attn = Attention(cfg, device, mesh)
        self.post_attn_norm = norm()
        self.mlp = MLP(cfg, device)

    def forward(self, x, positions):
        h = x + self.attn(self.input_norm(x), positions)
        return h + self.mlp(self.post_attn_norm(h))


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Normal with std 1/sqrt(fan_in) for every `Dense` and `Embed` weight
    ([out, in] or [V, H]), ones for every `RMSNorm` scale."""
    for module in model.modules():
        if isinstance(module, (Dense, Embed)):
            std = module.weight.shape[1] ** -0.5
            module.weight.normal_(0.0, std, generator=generator)
        elif isinstance(module, RMSNorm):
            module.scale.fill_(1.0)


class LlamaForCausalLM(nn.Module):
    """The causal LM. Parameters are made on `device` (the CUDA card
    unless the caller passes one) from `generator`, seed 0 by default:
    normal with std 1/sqrt(fan_in) for projections and the LM head,
    1/sqrt(hidden) for the embedding, ones for norm scales, as flax's
    default initializers scale them. Every rank of a `mesh` draws the same
    weights from the same generator.

    With a `mesh` whose `seq` axis is larger than 1, `forward` takes this
    rank's contiguous shard of the sequence (`parallel.step.shard_batch`)
    and attention runs over the ring."""

    def __init__(self, cfg: LlamaConfig, mesh=None, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        # This rank's shard of the sequence, in order (0 without a ring).
        self.seq_rank = mesh["seq"].get_local_rank() if _uses_ring(mesh) else 0
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size, cfg.dtype,
                                  cfg.param_dtype, device)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device, mesh) for _ in range(cfg.num_layers)
        )
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps,
                                  cfg.param_dtype, device)
        self.lm_head = None
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size,
                                 torch.float32, cfg.param_dtype, device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_parameters(self, generator)

    def forward(self, input_ids, positions=None, return_hidden=False):
        """Logits [B, T, V], or with `return_hidden=True` the final-norm
        hidden states, so a chunked loss can apply the LM head per
        sequence chunk and the full logits never exist. On a sequence
        shard, positions default to the shard's global ones, which the
        rotary embeddings must see."""
        cfg = self.cfg
        if positions is None:
            t = input_ids.shape[1]
            positions = torch.arange(
                self.seq_rank * t, (self.seq_rank + 1) * t, device=input_ids.device
            ).expand(input_ids.shape)
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = run_layer(cfg, layer, x, positions)
        x = self.final_norm(x)
        if return_hidden:
            return x
        if self.lm_head is None:
            # flax's Embed.attend casts both operands to `dtype`.
            return F.linear(x.to(cfg.param_dtype).to(cfg.dtype),
                            self.embed_tokens.weight.to(cfg.dtype))
        return self.lm_head(x)


def lm_head_weight(model: LlamaForCausalLM) -> torch.Tensor:
    """[V, H] output-projection weight (the tied embedding table or the
    dedicated LM head)."""
    if model.lm_head is not None:
        return model.lm_head.weight
    return model.embed_tokens.weight


def _chunk_nll(h, head, targets, mask):
    # float32 logits whatever the parameter dtype, as the full path's LM
    # head computes them, so the two losses stay comparable.
    logits = torch.matmul(h.to(head.dtype).float(), head.float().T)  # [B, C, V]
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None])[..., 0]
    return ((logz - gold) * mask).sum(), mask.sum()


def chunked_causal_lm_loss(
    model: LlamaForCausalLM,
    input_ids: torch.Tensor,
    targets: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    chunk_size: int = 2048,
) -> torch.Tensor:
    """Next-token cross-entropy without materializing the full logits.

    The LM head and softmax cross-entropy run over sequence chunks of
    `chunk_size`; each chunk's logits are recomputed in backward, so only
    [B, chunk, V] is alive at a time. Padded rows of the last chunk carry
    mask 0.
    """
    b, t = targets.shape
    hidden = model(input_ids, return_hidden=True)
    head = lm_head_weight(model)  # [V, H]
    if mask is None:
        m_full = torch.ones((b, t), dtype=torch.float32, device=targets.device)
    else:
        m_full = mask.float().expand(b, t)
    chunk_size = min(chunk_size, t)
    pad = (-t) % chunk_size
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        m_full = F.pad(m_full, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=targets.device)
    count = torch.zeros((), dtype=torch.float32, device=targets.device)
    for start in range(0, t + pad, chunk_size):
        part = slice(start, start + chunk_size)
        args = (hidden[:, part], head, targets[:, part], m_full[:, part])
        if torch.is_grad_enabled():
            nll, cnt = checkpoint(_chunk_nll, *args, use_reentrant=False)
        else:
            nll, cnt = _chunk_nll(*args)
        total = total + nll
        count = count + cnt
    return total / count.clamp_min(1.0)


def causal_lm_loss(logits: torch.Tensor, targets: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross-entropy in float32. logits [B, T, V], targets
    [B, T] (already shifted by the data pipeline)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        # Broadcast before the sums: a shared [1, T] mask must weight the
        # denominator per batch row too.
        mask = mask.to(nll.dtype).expand_as(nll)
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
