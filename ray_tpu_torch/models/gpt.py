"""GPT-2 causal LM in PyTorch: the port of `ray_tpu/models/gpt.py`.

The second dense family beside Llama: LayerNorm with scale and bias,
learned position embeddings, a fused qkv projection, plain multi-head
causal attention on the flash kernels (`ops.attention`: K1-K3), a
tanh-GELU MLP, and the head tied to the token table. Numerics mirror the
flax model, so the two can be held against each other with the same
weights (`convert.gpt_params_from_flax`): weights are stored in
`param_dtype` and cast to `dtype` at each use, LayerNorm takes its
statistics in float32 as flax's does, the residual stream stays in
`dtype`, and the tied head casts both operands to `dtype` as flax's
`Embed.attend` does, so the logits come out in `dtype` (bf16 by default).

Two places where the port and the reference part on purpose:

- Past `max_seq_len` (a sequence longer than the position table, or a
  position outside it) the port raises a `ValueError`; flax's lookup fills
  the missing rows with NaN, and causal attention spreads them to every row.
- `GPTConfig.num_params()` keeps the reference's count, which leaves out
  every bias and LayerNorm parameter, so that the MFU compares with the
  reference's.

This slice is single-device; the reference's sharding constraints are
no-ops without a mesh and are dropped.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import DeviceLike, resolve_device
from ..ops.attention import flash_attention
from .llama import Embed, _param

# flax's lecun_normal truncates at two standard deviations and divides by
# this (the standard deviation of a unit normal truncated there), so that
# the kept values have a standard deviation of 1/sqrt(fan_in).
_TRUNCATED_STD = 0.87962566103423978


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None  # default 4x hidden
    max_seq_len: int = 1024
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True

    @property
    def mlp_dim(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def num_params(self) -> int:
        """The reference's count: the projections' weights and both
        tables, without the biases and LayerNorms."""
        h, l, v = self.hidden_size, self.num_layers, self.vocab_size
        per_layer = 4 * h * h + 2 * h * self.mlp_dim
        return l * per_layer + v * h + self.max_seq_len * h


CONFIGS: Dict[str, GPTConfig] = {
    "gpt2-tiny": GPTConfig(vocab_size=512, hidden_size=64, num_layers=2,
                           num_heads=4, max_seq_len=256),
    "gpt2": GPTConfig(),
    "gpt2-medium": GPTConfig(hidden_size=1024, num_layers=24, num_heads=16),
    "gpt2-large": GPTConfig(hidden_size=1280, num_layers=36, num_heads=20),
}


class Linear(nn.Module):
    """flax's `Dense` (and `DenseGeneral` over flattened axes): y = x W^T
    + b with input, weight and bias cast to `dtype`; the weight is stored
    [out, in] and the bias [out], in `param_dtype`."""

    def __init__(self, in_features, out_features, dtype, param_dtype, device):
        super().__init__()
        self.dtype = dtype
        self.weight = _param((out_features, in_features), param_dtype, device)
        self.bias = _param((out_features,), param_dtype, device)

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class LayerNorm(nn.Module):
    """flax's `nn.LayerNorm`: mean and variance in float32 whatever the
    input's dtype, the variance as E[x^2] - E[x]^2 clipped at 0 (flax's
    fast variance), scale and bias applied in float32, the result in
    `dtype`."""

    def __init__(self, features, eps, dtype, param_dtype, device):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.scale = _param((features,), param_dtype, device)
        self.bias = _param((features,), param_dtype, device)

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf.square().mean(dim=-1, keepdim=True) - mean.square()).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.float()
        return ((xf - mean) * mul + self.bias.float()).to(self.dtype)


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig, device):
        super().__init__()
        self.cfg = cfg
        h, width = cfg.hidden_size, cfg.num_heads * cfg.head_dim
        linear = functools.partial(Linear, dtype=cfg.dtype,
                                   param_dtype=cfg.param_dtype, device=device)
        norm = functools.partial(LayerNorm, h, cfg.layer_norm_eps, cfg.dtype,
                                 cfg.param_dtype, device)
        self.ln_1 = norm()
        self.c_attn = linear(h, 3 * width)  # flax kernel [h, 3, H, D]
        self.c_proj = linear(width, h)  # flax kernel [H, D, h]
        self.ln_2 = norm()
        self.c_fc = linear(h, cfg.mlp_dim)
        self.c_proj_mlp = linear(cfg.mlp_dim, h)

    def forward(self, x):
        cfg = self.cfg
        b, t, _ = x.shape
        qkv = self.c_attn(self.ln_1(x)).view(b, t, 3, cfg.num_heads, cfg.head_dim)
        # [B, T, H, D] -> [B, H, T, D]
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        o = flash_attention(q, k, v, causal=True).transpose(1, 2)
        x = x + self.c_proj(o.reshape(b, t, cfg.num_heads * cfg.head_dim))
        # flax's nn.gelu is the tanh approximation.
        m = F.gelu(self.c_fc(self.ln_2(x)), approximate="tanh")
        return x + self.c_proj_mlp(m)


def run_block(cfg: GPTConfig, block: Block, x):
    """`block(x)`, checkpointed when `cfg.remat` is set and gradients are
    on: the reference's `nothing_saveable`, so the backward recomputes the
    whole block (K1 included)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(block, x, use_reentrant=False)
    return block(x)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """flax's default initializers: every `Linear` weight ([out, in])
    truncated normal with standard deviation 1/sqrt(in) (lecun_normal),
    every `Embed` table ([rows, H]) normal with 1/sqrt(H); biases zero,
    LayerNorm scales one."""
    for module in model.modules():
        if isinstance(module, Linear):
            std = module.weight.shape[1] ** -0.5 / _TRUNCATED_STD
            nn.init.trunc_normal_(module.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            module.bias.zero_()
        elif isinstance(module, Embed):
            module.weight.normal_(0.0, module.weight.shape[1] ** -0.5,
                                  generator=generator)
        elif isinstance(module, LayerNorm):
            module.scale.fill_(1.0)
            module.bias.zero_()


class GPTForCausalLM(nn.Module):
    """The causal LM. Parameters are made on `device` (the CUDA card unless
    the caller passes one) from `generator`, seed 0 by default, as flax's
    default initializers make them (`init_parameters`). On the `meta`
    device the parameters are only shapes and are left uninitialised."""

    def __init__(self, cfg: GPTConfig, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.wte = Embed(cfg.vocab_size, cfg.hidden_size, cfg.dtype,
                         cfg.param_dtype, device)
        self.wpe = Embed(cfg.max_seq_len, cfg.hidden_size, cfg.dtype,
                         cfg.param_dtype, device)
        self.h = nn.ModuleList(Block(cfg, device) for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype,
                              cfg.param_dtype, device)
        if device.type == "meta":
            return
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_parameters(self, generator)

    def forward(self, input_ids, positions=None):
        """Logits [B, T, V] in `dtype`. Raises `ValueError` for a sequence
        longer than `max_seq_len` or a position outside [0, max_seq_len)
        (checking given positions waits for the device)."""
        cfg = self.cfg
        t = input_ids.shape[1]
        if positions is None:
            if t > cfg.max_seq_len:
                raise ValueError(f"sequence of {t} tokens is longer than "
                                 f"max_seq_len={cfg.max_seq_len}")
            positions = torch.arange(t, device=input_ids.device).expand(input_ids.shape)
        elif bool(((positions < 0) | (positions >= cfg.max_seq_len)).any()):
            raise ValueError(f"positions must lie in [0, {cfg.max_seq_len}) "
                             f"(max_seq_len); got {int(positions.min())}..{int(positions.max())}")
        x = self.wte(input_ids) + self.wpe(positions)
        for block in self.h:
            x = run_block(cfg, block, x)
        x = self.ln_f(x)
        # flax's Embed.attend casts both operands to `dtype`.
        return F.linear(x.to(cfg.param_dtype).to(cfg.dtype), self.wte.weight.to(cfg.dtype))
