"""Learner: owns params + optimizer, runs the update.

Reference: rllib/core/learner/learner.py + torch_learner.py:56. The
reference jits its whole update into one XLA program; here the update is
eager torch on the learner's device: the card, unless the caller asked
for the CPU with `num_gpus_per_learner=0`. A learner that sees no card
raises; it never runs on the CPU instead.
Learners of a group (one process each) average their gradients out of
graph through ray_tpu_torch.util.collective, as the reference's do.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


class Learner:
    """Subclasses implement ``compute_loss(params, batch, noise)``.

    A loss that samples takes its random draws as the argument `noise`
    (the reference splits a jax key inside its loss): `draw_noise(batch)`
    makes them on the learner's device from the learner's seed, and a
    caller may pass its own to `update`, so that two learners, or the
    port and the reference, see the same draws."""

    def __init__(self, *, module_spec, config: Dict[str, Any]):
        self._module_spec = module_spec
        self.config = dict(config)
        self.module = None
        self.params: Optional[torch.nn.Module] = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.device: Optional[torch.device] = None
        self._generator: Optional[torch.Generator] = None
        self._noise_generator: Optional[torch.Generator] = None
        self._collective_group: Optional[str] = None

    # ------------------------------------------------------------- build
    def build(self) -> None:
        self.device = _learner_device(self.config)
        self.module = self._module_spec.build(self.device)
        seed = int(self.config.get("seed") or 0)
        self._generator = torch.Generator().manual_seed(seed)
        self.params = self.module.init_params(self._generator)
        # Draws for the losses that sample, made where the loss runs.
        self._noise_generator = torch.Generator(self.device).manual_seed(seed)
        self._np_rng = np.random.default_rng(seed)
        # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8 (no eps_root).
        self.optimizer = torch.optim.Adam(
            self.params.parameters(), lr=self.config.get("lr", 3e-4),
            betas=(0.9, 0.999), eps=1e-8,
        )

    # -------------------------------------------------------------- loss
    def compute_loss(
        self, params, batch: Dict[str, Any], noise: Any
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def draw_noise(self, batch: Dict[str, Any]) -> Any:
        """The draws one step's loss takes; None for a loss that draws
        nothing."""
        return None

    def _normal(self, *shape: int) -> torch.Tensor:
        return torch.randn(shape, generator=self._noise_generator, device=self.device)

    def _uniform(self, *shape: int) -> torch.Tensor:
        return torch.rand(shape, generator=self._noise_generator, device=self.device)

    # ------------------------------------------------------------ update
    def _update_step(self, batch: Dict[str, Any], noise: Any = None) -> Dict[str, torch.Tensor]:
        """One gradient step: loss, backward, the group's gradient mean
        (when there is a group), global-norm clip, Adam."""
        self.optimizer.zero_grad(set_to_none=True)
        if noise is None:
            noise = self.draw_noise(batch)
        loss, metrics = self.compute_loss(self.params, batch, noise)
        loss.backward()
        params = [p for p in self.params.parameters() if p.grad is not None]
        if self._collective_group:
            self._average_gradients(params)
        clip = self.config.get("grad_clip")
        if clip:
            torch.nn.utils.clip_grad_norm_(params, clip)
        self.optimizer.step()
        metrics["total_loss"] = loss
        return {k: v.detach() for k, v in metrics.items()}

    def _average_gradients(self, params: List[torch.nn.Parameter]) -> None:
        """Every learner's gradients, averaged: one allreduce of them all,
        flattened (the reference sends one allreduce per leaf)."""
        from ...util import collective

        flat = torch.cat([p.grad.reshape(-1) for p in params])
        mean = collective.allreduce(flat, group_name=self._collective_group, op="mean")
        offset = 0
        for p in params:
            n = p.grad.numel()
            p.grad.copy_(mean[offset:offset + n].view_as(p.grad))
            offset += n

    def device_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The batch's columns on the learner's device, copied there once;
        dict-valued entries as they are."""
        return {
            k: (v if isinstance(v, dict) else _column(v, self.device))
            for k, v in batch.items()
        }

    def update(self, batch: Dict[str, np.ndarray], noise: Any = None) -> Dict[str, Any]:
        """Run minibatch SGD over the batch; returns averaged metrics.
        `noise`, where given, is the draws of the one step this update
        takes, in place of the learner's own."""
        minibatch = self.config.get("minibatch_size")
        epochs = self.config.get("num_epochs", 1)
        # The batch goes to the device once; minibatches are cut there.
        batch = self.device_batch(batch)
        n = len(
            next(v for v in batch.values() if not isinstance(v, dict) and v.ndim)
        )
        if noise is not None and (epochs != 1 or (minibatch and minibatch < n)):
            raise ValueError("noise is given for one step, and this update takes several")
        all_metrics: List[Dict[str, Any]] = []
        for _ in range(epochs):
            if minibatch and minibatch < n:
                perm = self._np_rng.permutation(n)
                # Full minibatches only, as the reference (whose static
                # shapes keep XLA from recompiling per ragged tail).
                num_mb = n // minibatch
                idxs = [
                    torch.as_tensor(perm[i * minibatch : (i + 1) * minibatch],
                                    device=self.device)
                    for i in range(num_mb)
                ]
            else:
                idxs = [None]
            for idx in idxs:
                # dict-valued entries and scalars (a coefficient that
                # changes between updates) ride along unsliced.
                mb = {
                    k: (v if idx is None or isinstance(v, dict) or not v.ndim else v[idx])
                    for k, v in batch.items()
                }
                all_metrics.append(self._update_step(mb, noise))
        # float32 means, as numpy takes them over the reference's float32
        # device scalars.
        return {
            k: float(np.mean([m[k].cpu().numpy() for m in all_metrics]))
            for k in all_metrics[0]
        }

    # ----------------------------------------------------------- weights
    def get_weights(self) -> Dict[str, torch.Tensor]:
        """A host copy of the parameters: their state dict on the CPU."""
        return _to_host(self.params.state_dict())

    def set_weights(self, weights) -> None:
        self.params.load_state_dict(weights)

    def get_state(self) -> Dict[str, Any]:
        return {
            "params": self.get_weights(),
            "opt_state": _to_host(self.optimizer.state_dict()),
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        self.set_weights(state["params"])
        # load_state_dict moves the moments onto the parameters' device.
        self.optimizer.load_state_dict(state["opt_state"])

    # ------------------------------------------------------- collective
    def setup_collective(self, group_name: str, world_size: int, rank: int):
        from ...util import collective

        collective.init_collective_group(
            world_size=world_size, rank=rank, group_name=group_name
        )
        self._collective_group = group_name

    def leave_collective(self) -> None:
        if self._collective_group:
            from ...util import collective

            collective.destroy_collective_group(self._collective_group)
            self._collective_group = None


def _learner_device(config: Dict[str, Any]) -> torch.device:
    """The CPU when `num_gpus_per_learner` is 0, else the current card. No
    fallback: a learner that sees no card raises."""
    gpus = config.get("num_gpus_per_learner")
    if gpus == 0:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        import os

        held = "holds a GPU" if gpus else "runs on the card by default"
        raise RuntimeError(
            f"the learner {held} but sees no CUDA device "
            f"(CUDA_VISIBLE_DEVICES={os.environ.get('CUDA_VISIBLE_DEVICES')!r}); "
            "pass num_gpus_per_learner=0 to train on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def _column(values, device: torch.device) -> torch.Tensor:
    """A batch column on the device; floats in float32, as the reference's
    jnp.asarray makes them. A tensor already there stays as it is."""
    if isinstance(values, torch.Tensor):
        t = values
    else:
        t = torch.tensor(np.asarray(values))  # a copy: the batch may be read-only
    return (t.float() if t.is_floating_point() else t).to(device)


def _to_host(tree):
    """A state dict (nested dicts and lists of tensors) copied to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class LearnerActor:
    """Hosts a Learner in a worker process (on the card its actor holds,
    unless it was given none); thin RPC surface for LearnerGroup."""

    def __init__(self, learner_cls_blob: bytes, module_spec_blob: bytes,
                 config_blob: bytes):
        import pickle

        learner_cls = pickle.loads(learner_cls_blob)
        self._learner: Learner = learner_cls(
            module_spec=pickle.loads(module_spec_blob),
            config=pickle.loads(config_blob),
        )
        self._learner.build()

    def setup_collective(self, group_name: str, world_size: int, rank: int):
        self._learner.setup_collective(group_name, world_size, rank)
        return rank

    def leave_collective(self) -> None:
        self._learner.leave_collective()

    def update_from_episodes(self, episodes):
        batch = self._learner.build_batch(episodes)  # type: ignore[attr-defined]
        return self._learner.update(batch)

    def update(self, batch):
        return self._learner.update(batch)

    def get_weights(self):
        return self._learner.get_weights()

    def set_weights(self, weights):
        self._learner.set_weights(weights)

    def get_state(self):
        return self._learner.get_state()

    def set_state(self, state):
        self._learner.set_state(state)

    def device(self) -> str:
        return str(self._learner.device)

    def call(self, method: str, *args, **kwargs):
        return getattr(self._learner, method)(*args, **kwargs)
