"""MultiRLModule: a dict of RLModules keyed by module id.

Reference: rllib/core/rl_module/multi_rl_module.py — the container the
multi-agent stack trains; each policy ("module") has its own params and
forward. Params here are a plain dict {module_id: nn.ModuleDict}, so the
learner side can update each module independently and weight sync ships
one dict.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch

from .rl_module import RLModule, RLModuleSpec


@dataclass
class MultiRLModuleSpec:
    module_specs: Dict[str, RLModuleSpec] = field(default_factory=dict)

    def build(self, device: Any = "cpu") -> "MultiRLModule":
        return MultiRLModule(
            {mid: spec.build(device) for mid, spec in self.module_specs.items()}
        )


class MultiRLModule:
    def __init__(self, modules: Dict[str, RLModule]):
        self._modules = dict(modules)

    def __getitem__(self, module_id: str) -> RLModule:
        return self._modules[module_id]

    def __contains__(self, module_id: str) -> bool:
        return module_id in self._modules

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def init_params(self, generator: torch.Generator) -> Dict[str, Any]:
        """Each module in id order from its own generator, seeded by a draw
        from `generator` (the reference splits its jax key)."""
        seeds = torch.randint(0, 2**62, (len(self._modules),), generator=generator)
        return {
            mid: m.init_params(torch.Generator().manual_seed(int(seed)))
            for (mid, m), seed in zip(sorted(self._modules.items()), seeds)
        }
