"""RLModule: the neural-network abstraction of the new API stack.

Reference: rllib/core/rl_module/rl_module.py — a framework-native module
with three forward passes (inference / exploration / train). The port
keeps the reference's calling shape: parameters live outside the module
object, as a `torch.nn.ModuleDict` that `init_params(generator)` builds,
and every forward is ``forward_*(params, batch)``, so the learner owns
one set of weights on its device and an env runner another on the CPU,
each loading the other's host copy (a state dict). Batches may be numpy:
a forward moves them to the module's device as float32 first.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn


class Columns:
    """Batch column names (reference: rllib/core/columns.py)."""

    OBS = "obs"
    ACTIONS = "actions"
    REWARDS = "rewards"
    NEXT_OBS = "next_obs"
    TERMINATEDS = "terminateds"
    TRUNCATEDS = "truncateds"
    ACTION_LOGP = "action_logp"
    ACTION_DIST_INPUTS = "action_dist_inputs"
    VF_PREDS = "vf_preds"
    ADVANTAGES = "advantages"
    VALUE_TARGETS = "value_targets"
    LOSS_MASK = "loss_mask"


class RLModule:
    """Subclass and implement ``setup`` + the forward methods.

    All forwards are functions of (params, batch) returning a dict of
    tensors on the module's device; ``init_params(generator)`` builds
    fresh parameters there.
    """

    def __init__(self, observation_space, action_space, model_config: dict,
                 device: Any = "cpu"):
        self.observation_space = observation_space
        self.action_space = action_space
        self.model_config = dict(model_config or {})
        self.device = torch.device(device)
        self.setup()

    # ------------------------------------------------------------- hooks
    def setup(self) -> None:  # pragma: no cover - default no-op
        pass

    def init_params(self, generator: torch.Generator) -> nn.ModuleDict:
        raise NotImplementedError

    def forward_inference(self, params, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Greedy/deterministic forward for evaluation & serving."""
        return self.forward_exploration(params, batch)

    def forward_exploration(self, params, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Stochastic forward used for sample collection."""
        raise NotImplementedError

    def forward_train(self, params, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Forward used inside the loss."""
        raise NotImplementedError

    # --------------------------------------------------------- utilities
    def input_dim(self) -> int:
        space = self.observation_space
        return int(np.prod(space.shape))

    def num_actions(self) -> int:
        """A discrete space's count, else the size of the space's shape:
        for every gymnasium space what the reference's isinstance check on
        `Discrete` gives, and without importing gymnasium, so a learner
        can run where gymnasium is not installed."""
        n = getattr(self.action_space, "n", None)
        if isinstance(n, (int, np.integer)):
            return int(n)
        return int(np.prod(self.action_space.shape))

    def to_device(self, x) -> torch.Tensor:
        """A batch column as float32 on the module's device."""
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)


@dataclass
class RLModuleSpec:
    """Builds an RLModule from spaces + config (reference:
    rllib/core/rl_module/rl_module.py RLModuleSpec)."""

    module_class: Optional[type] = None
    observation_space: Any = None
    action_space: Any = None
    model_config: Dict[str, Any] = field(default_factory=dict)

    def build(self, device: Any = "cpu") -> RLModule:
        if self.module_class is None:
            raise ValueError("RLModuleSpec.module_class not set")
        return self.module_class(
            self.observation_space, self.action_space, self.model_config, device
        )


# ------------------------------------------------------------------ MLPs
# jax's truncated normal draws in [-2, 2] standard deviations and divides
# the stddev by the std of a standard normal truncated there.
_TRUNC_STD = 0.87962566103423978


def _variance_scaling_(weight: torch.Tensor, scale: float,
                       generator: torch.Generator) -> None:
    """flax's variance_scaling(scale, "fan_in", "truncated_normal") on a
    torch [out, in] weight, drawn from `generator` (so the same seed
    gives other numbers than jax's)."""
    std = math.sqrt(scale / weight.shape[1]) / _TRUNC_STD
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


class MLP(nn.Module):
    """The reference's flax `_mlp`: tanh hidden layers, then a linear head
    whose weights start at variance scaling `out_scale` (near-uniform
    initial policy and near-zero initial values — bootstrapped targets
    start unbiased instead of propagating init noise). Hidden layers
    start as flax's Dense does (lecun normal), every bias at zero.
    `layers.i` is flax's `Dense_i`."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out: int,
                 generator: torch.Generator, out_scale: float = 0.01):
        super().__init__()
        dims = [in_dim, *hidden, out]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims, dims[1:]))
        with torch.no_grad():
            for i, layer in enumerate(self.layers):
                last = i == len(self.layers) - 1
                _variance_scaling_(layer.weight, out_scale if last else 1.0, generator)
                layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for layer in self.layers[:-1]:
            x = torch.tanh(layer(x))
        return self.layers[-1](x)


class DiscretePolicyModule(RLModule):
    """Categorical policy + value head over an MLP trunk — the default
    module for discrete-action envs (reference: rllib default
    PPO/IMPALA catalog MLP models)."""

    def setup(self) -> None:
        self._hidden = tuple(self.model_config.get("fcnet_hiddens", (64, 64)))

    def init_params(self, generator):
        # Drawn on the CPU, so a seed gives the same weights on any device.
        params = nn.ModuleDict({
            "pi": MLP(self.input_dim(), self._hidden, self.num_actions(), generator),
            "vf": MLP(self.input_dim(), self._hidden, 1, generator),
        })
        return params.to(self.device)

    def forward_exploration(self, params, batch):
        logits = params["pi"](self.to_device(batch[Columns.OBS]))
        return {Columns.ACTION_DIST_INPUTS: logits}

    def forward_train(self, params, batch):
        obs = self.to_device(batch[Columns.OBS])
        logits = params["pi"](obs)
        vf = params["vf"](obs)[..., 0]
        return {Columns.ACTION_DIST_INPUTS: logits, Columns.VF_PREDS: vf}

    def compute_values(self, params, obs):
        return params["vf"](self.to_device(obs))[..., 0]


class QNetworkModule(RLModule):
    """Q-network (+ target handled by the learner) for DQN."""

    def setup(self) -> None:
        self._hidden = tuple(self.model_config.get("fcnet_hiddens", (64, 64)))

    def init_params(self, generator):
        return nn.ModuleDict({
            "q": MLP(self.input_dim(), self._hidden, self.num_actions(), generator),
        }).to(self.device)

    def forward_exploration(self, params, batch):
        q = params["q"](self.to_device(batch[Columns.OBS]))
        return {"q_values": q, Columns.ACTION_DIST_INPUTS: q}

    def forward_train(self, params, batch):
        return {"q_values": params["q"](self.to_device(batch[Columns.OBS]))}
