"""IMPALA: asynchronous sampling + V-trace off-policy correction.

Reference: rllib/algorithms/impala/impala.py:530 — env runners sample
continuously (no barrier with the learner), and the learner takes
whichever result arrives first; here the oldest request first while it
is on time, so a seeded run repeats. Sample batches carry the
behavior policy's logp, and the learner corrects the policy lag with
V-trace (Espeholt et al. 2018) clipped importance weights. The learner
update is eager torch on the learner's device; the V-trace recursion
is a reverse loop over T in float32 (the reference's reverse
``lax.scan``).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

import ray_tpu_torch

from ..core.learner import Learner
from ..core.rl_module import Columns
from .algorithm import Algorithm
from .algorithm_config import AlgorithmConfig

# How long the learner waits for its oldest sample request, from the
# request's call, before it takes whichever arrives first. A CartPole
# request of 50 steps x 4 envs takes well under a second on a loaded CPU.
IN_ORDER_GRACE_S = 10.0


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        # Defaults follow the reference's tuned CartPole config
        # (rllib/tuned_examples/impala/cartpole_impala.py): small vf
        # coefficient and global-norm grad clipping are what keep
        # V-trace from collapsing the policy early.
        self.lr = 5e-4
        self.train_batch_size = 500
        self.grad_clip = 40.0
        self.vf_loss_coeff = 0.05
        self.entropy_coeff = 0.005
        self.vtrace_clip_rho_threshold = 1.0
        self.vtrace_clip_c_threshold = 1.0
        # Standardize PG advantages within the batch. Not in the
        # original V-trace, but it prevents the early positive-feedback
        # policy collapse when every reward is positive and the value
        # net hasn't converged yet.
        self.standardize_advantages = True
        self.rollout_fragment_length = 50
        self.num_env_runners = 2
        self.max_requests_in_flight_per_env_runner = 2
        self.broadcast_interval = 1  # sync weights every N learner steps

    @property
    def algo_class(self):
        return IMPALA

    def learner_config(self):
        cfg = super().learner_config()
        cfg.update(
            gamma=self.gamma,
            vf_loss_coeff=self.vf_loss_coeff,
            entropy_coeff=self.entropy_coeff,
            vtrace_clip_rho_threshold=self.vtrace_clip_rho_threshold,
            vtrace_clip_c_threshold=self.vtrace_clip_c_threshold,
            rollout_fragment_length=self.rollout_fragment_length,
            standardize_advantages=self.standardize_advantages,
        )
        return cfg


def _pad_episodes(episodes, T: int):
    """Episodes → [B, T] padded arrays + mask."""
    cols = {
        "obs": [],
        "actions": [],
        "rewards": [],
        "terminateds": [],
        "action_logp": [],
        "bootstrap_obs": [],
        "mask": [],
    }
    for ep in episodes:
        L = min(len(ep), T)
        obs = np.asarray(ep.observations, np.float32)
        pad = T - L
        cols["obs"].append(
            np.concatenate([obs[:L], np.zeros((pad,) + obs.shape[1:], np.float32)])
        )
        cols["bootstrap_obs"].append(obs[L])
        acts = np.asarray(ep.actions[:L])
        cols["actions"].append(np.concatenate([acts, np.zeros(pad, acts.dtype)]))
        rew = np.asarray(ep.rewards[:L], np.float32)
        cols["rewards"].append(np.concatenate([rew, np.zeros(pad, np.float32)]))
        term = np.zeros(T, np.float32)
        if ep.is_terminated and L == len(ep):
            term[L - 1] = 1.0
        cols["terminateds"].append(term)
        logp = np.asarray(ep.extra_model_outputs["action_logp"][:L], np.float32)
        cols["action_logp"].append(np.concatenate([logp, np.zeros(pad, np.float32)]))
        mask = np.zeros(T, np.float32)
        mask[:L] = 1.0
        cols["mask"].append(mask)
    return {k: np.stack(v) for k, v in cols.items()}


def vtrace(values, bootstrap, target_logp, batch, cfg):
    """V-trace targets and policy-gradient advantages, float32, taking no
    gradient (rho = exp(pi - mu) carries d/d_logits even where it is 1
    on-policy; leaking it through the value loss corrupts the policy).

    values [B, T] (detached), bootstrap [B]: V(s_L) of each row.
    Returns (vs, pg_adv, rho), each [B, T]."""
    with torch.no_grad():
        mask = batch["mask"]
        rho = torch.exp(target_logp - batch["action_logp"])
        rho_clip = torch.clamp(rho, max=cfg["vtrace_clip_rho_threshold"])
        c_clip = torch.clamp(rho, max=cfg["vtrace_clip_c_threshold"])
        discounts = cfg["gamma"] * (1.0 - batch["terminateds"]) * mask
        # next-step value: V(s_{t+1}) while t+1 is still a valid step of
        # this chunk, else the bootstrap value V(s_L) (for rows shorter
        # than T, position t+1 holds padding, not the next obs).
        next_valid = torch.cat([mask[:, 1:], torch.zeros_like(mask[:, :1])], dim=1)
        v_shift = torch.cat([values[:, 1:], torch.zeros_like(bootstrap)[:, None]], dim=1)
        v_tp1 = next_valid * v_shift + (1.0 - next_valid) * bootstrap[:, None]
        deltas = mask * rho_clip * (batch["rewards"] + discounts * v_tp1 - values)
        # The reference's reverse scan: acc_t = delta_t + disc_t c_t acc_{t+1}.
        decay = discounts * c_clip
        acc = torch.zeros_like(bootstrap)
        accs = []
        for t in range(values.shape[1] - 1, -1, -1):
            acc = deltas[:, t] + decay[:, t] * acc
            accs.append(acc)
        vs = values + torch.stack(accs[::-1], dim=1)
        vs_shift = torch.cat([vs[:, 1:], torch.zeros_like(bootstrap)[:, None]], dim=1)
        vs_tp1 = next_valid * vs_shift + (1.0 - next_valid) * bootstrap[:, None]
        pg_adv = rho_clip * (batch["rewards"] + discounts * vs_tp1 - values)
    return vs, pg_adv, rho


class IMPALALearner(Learner):
    def build(self):
        super().build()
        self.config.setdefault("minibatch_size", None)
        self.config["num_epochs"] = 1

    def build_batch(self, episodes) -> Dict[str, np.ndarray]:
        # The reference pads B to a multiple of 8 (mask-0 rows) so that XLA
        # sees few shapes; eager torch needs none, and such rows change
        # no loss term.
        return _pad_episodes(episodes, self.config["rollout_fragment_length"])

    def _forward(self, params, batch):
        """(z, target_logp, values, bootstrap): log-softmax [B, T, A], the
        taken actions' logp, V [B, T] and V(bootstrap_obs) [B]."""
        B, T = batch["actions"].shape
        obs_flat = batch["obs"].reshape((B * T,) + batch["obs"].shape[2:])
        out = self.module.forward_train(params, {Columns.OBS: obs_flat})
        logits = out[Columns.ACTION_DIST_INPUTS].reshape(B, T, -1)
        values = out[Columns.VF_PREDS].reshape(B, T)
        bootstrap = self.module.compute_values(params, batch["bootstrap_obs"])
        z = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
        actions = batch["actions"].long()
        target_logp = torch.take_along_dim(z, actions[..., None], dim=-1)[..., 0]
        return z, target_logp, values, bootstrap

    def _advantages(self, params, batch):
        cfg = self.config
        z, target_logp, values, bootstrap = self._forward(params, batch)
        vs, pg_adv, rho = vtrace(values.detach(), bootstrap.detach(),
                                 target_logp.detach(), batch, cfg)
        mask = batch["mask"]
        denom = torch.clamp(mask.sum(), min=1.0)
        if cfg.get("standardize_advantages", True):
            adv_mean = torch.sum(pg_adv * mask) / denom
            adv_var = torch.sum(torch.square(pg_adv - adv_mean) * mask) / denom
            pg_adv = (pg_adv - adv_mean) / torch.clamp(torch.sqrt(adv_var), min=1e-4)
        vf_loss = 0.5 * torch.sum(torch.square(vs - values) * mask) / denom
        entropy = -torch.sum(torch.exp(z) * z * mask[..., None]) / denom
        return z, target_logp, pg_adv, vf_loss, entropy, rho, denom

    def compute_loss(self, params, batch, noise) -> Tuple[Any, Dict[str, Any]]:
        cfg = self.config
        _, target_logp, pg_adv, vf_loss, entropy, rho, denom = self._advantages(params, batch)
        mask = batch["mask"]
        policy_loss = -torch.sum(target_logp * pg_adv * mask) / denom
        total = (
            policy_loss
            + cfg["vf_loss_coeff"] * vf_loss
            - cfg["entropy_coeff"] * entropy
        )
        return total, {
            "policy_loss": policy_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
            "mean_rho": torch.sum(rho * mask) / denom,
        }


class IMPALA(Algorithm):
    learner_class = IMPALALearner

    def setup(self, config_dict) -> None:
        super().setup(config_dict)
        self._inflight: Dict[Any, int] = {}  # ref -> actor index
        self._issued: Dict[Any, float] = {}  # ref -> time.monotonic() of its call
        self._learner_steps = 0
        self._episode_buffer: List = []  # accumulate to train_batch_size
        self._buffered_steps = 0

    def _runner_sample_async(self, idx: int):
        mgr = self.env_runner_group._manager
        actor = mgr.actor(idx)
        frag = self.config.rollout_fragment_length
        n_envs = self.config.num_envs_per_env_runner
        ref = actor.sample.remote(num_timesteps=frag * n_envs)
        self._inflight[ref] = idx
        self._issued[ref] = time.monotonic()

    def training_step(self) -> Dict[str, Any]:
        if self.env_runner_group._manager is None:
            # Synchronous degenerate mode (num_env_runners=0): still
            # V-trace, but no async pipeline.
            episodes = self.env_runner_group.sample(
                num_timesteps=self.config.train_batch_size
            )
            self._record_episodes(episodes)
            metrics = self.learner_group.update_from_episodes(episodes)
            self.env_runner_group.sync_weights(self.learner_group.get_weights())
            return metrics

        # ---- async path: keep every runner busy; learn on arrival ----
        mgr = self.env_runner_group._manager
        in_flight_target = self.config.max_requests_in_flight_per_env_runner
        for idx in mgr.healthy_actor_ids():
            while (
                sum(1 for i in self._inflight.values() if i == idx)
                < in_flight_target
            ):
                self._runner_sample_async(idx)
        # The oldest request first while it is on time: each runner then
        # sees the same sequence of calls (its samples and weight syncs)
        # in every run, so a seeded run repeats, where arrival order
        # varies with the host's load. Past IN_ORDER_GRACE_S from its
        # call, whichever arrives first, as the reference takes them, so
        # a slow or hung runner holds the learner back once, for the
        # grace at most.
        oldest = next(iter(self._inflight))
        on_time = self._issued[oldest] + IN_ORDER_GRACE_S - time.monotonic()
        ready, _ = ray_tpu_torch.wait(
            [oldest], num_returns=1, timeout=max(0.0, on_time)
        )
        if not ready:
            ready, _ = ray_tpu_torch.wait(
                list(self._inflight), num_returns=1, timeout=60.0
            )
        all_metrics: List[Dict[str, Any]] = []
        updated_runners = []
        for ref in ready:
            idx = self._inflight.pop(ref)
            del self._issued[ref]
            try:
                episodes = ray_tpu_torch.get(ref)
            except Exception:
                # Runner died: drop its OTHER in-flight refs too, or a
                # stale ref failing later would restart (kill) the
                # healthy replacement actor.
                for stale in [
                    r for r, i in self._inflight.items() if i == idx
                ]:
                    del self._inflight[stale]
                    del self._issued[stale]
                mgr._restart(idx)
                continue
            self._record_episodes(episodes)
            self._episode_buffer.extend(episodes)
            self._buffered_steps += sum(len(e) for e in episodes)
            if self._buffered_steps >= self.config.train_batch_size:
                all_metrics.append(
                    self.learner_group.update_from_episodes(
                        self._episode_buffer
                    )
                )
                self._episode_buffer = []
                self._buffered_steps = 0
                self._learner_steps += 1
            updated_runners.append(idx)
            self._runner_sample_async(idx)
        if all_metrics and self._learner_steps % self.config.broadcast_interval == 0:
            w_ref = ray_tpu_torch.put(self.learner_group.get_weights())
            for idx in set(updated_runners):
                mgr.actor(idx).set_weights.remote(w_ref)
        if not all_metrics:
            return {}
        return {
            k: float(np.mean([m[k] for m in all_metrics]))
            for k in all_metrics[0]
        }
