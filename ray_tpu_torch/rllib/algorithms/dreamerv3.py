"""DreamerV3: world-model RL — learn in imagination.

Reference: rllib/algorithms/dreamerv3/ (tf world model + imagination
actor-critic). The reference compiles its whole training step into one
XLA program; here it is eager torch on the learner's device (the card
unless `num_gpus_per_learner=0` asks for the CPU): the RSSM posterior
over T and the imagined rollout over the horizon are Python loops, the
losses are summed with `.detach()` where the reference stops gradients,
and one backward feeds three Adam optimizers (world model, actor,
critic), each clipped to its own group's global norm. Nothing in the
step waits on the host: its metrics and the return normalizer stay on
the device until an iteration ends.

The v3 signatures are kept: categorical latents (groups x classes)
with 1% unimix and straight-through gradients, symlog regression for
observations, twohot symexp bins for reward and value, free-bits KL
with the 0.1 representation-loss weighting, lambda-returns on imagined
trajectories, percentile-EMA return normalization, and an
EMA-regularized slow critic.

Every categorical draw is Gumbel-max (the reference's
`jax.random.categorical`), and the Gumbel noise is an argument of the
train step and of acting (`DreamerV3Learner.draw_noise`), so a caller
can give both sides the same draws.

Like the reference, DreamerV3 does not use the shared env-runner
machinery: acting is recurrent (the RSSM state threads through the
episode), so the algorithm owns its vectorized collection loop and a
sequence-replay buffer of whole episodes.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..core.learner import _learner_device, _to_host
from ..core.rl_module import _variance_scaling_
from .algorithm import Algorithm
from .algorithm_config import AlgorithmConfig

# flax's LayerNorm epsilon (torch's default is 1e-5).
LN_EPS = 1e-6
WM_PREFIXES = ("enc", "gru", "prior", "post", "dec", "rew", "cont")


def _symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def _symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


class _TwoHot:
    """Twohot encoding over symlog-spaced bins (reference:
    dreamerv3/utils/two_hot.py): scalars become a categorical CE
    target, killing reward/value scale sensitivity."""

    def __init__(self, n_bins: int = 41, low: float = -20.0,
                 high: float = 20.0, device: Any = "cpu"):
        self.bins = torch.linspace(low, high, n_bins, device=device)
        self.n = n_bins

    def encode(self, x):
        x = torch.clamp(_symlog(x), self.bins[0], self.bins[-1])
        idx = torch.clamp(
            torch.searchsorted(self.bins, x.contiguous(), right=True) - 1, 0, self.n - 2
        )
        lo, hi = self.bins[idx], self.bins[idx + 1]
        w_hi = (x - lo) / (hi - lo)
        oh_lo = F.one_hot(idx, self.n) * (1.0 - w_hi)[..., None]
        oh_hi = F.one_hot(idx + 1, self.n) * w_hi[..., None]
        return oh_lo + oh_hi

    def decode(self, logits):
        probs = torch.softmax(logits, dim=-1)
        return _symexp(torch.sum(probs * self.bins, dim=-1))


class DreamerV3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        # World model (tiny-by-default: CI trains on CPU; scale via
        # model_config for real runs).
        self.model_config = {
            "deter": 256,
            "stoch_groups": 8,
            "stoch_classes": 8,
            "units": 256,
            "bins": 41,
        }
        self.lr = 1e-4  # world model
        self.actor_lr = 3e-5
        self.critic_lr = 3e-5
        self.grad_clip = 100.0
        self.gamma = 0.997
        self.gae_lambda = 0.95
        self.horizon = 15
        self.entropy_coef = 3e-4
        self.free_bits = 1.0
        self.rep_loss_scale = 0.1
        self.dyn_loss_scale = 0.5
        self.critic_ema_decay = 0.98
        self.critic_ema_reg = 1.0
        self.batch_size_B = 8
        self.batch_length_T = 32
        self.train_ratio = 64.0  # replayed steps per env step
        self.num_envs = 4
        self.sample_timesteps_per_iteration = 400
        self.num_steps_sampled_before_learning_starts = 1000
        self.replay_capacity_steps = 100_000

    @property
    def algo_class(self):
        return DreamerV3


class _EpisodeReplay:
    """Stores whole episodes; samples (B, T) subsequences with
    `is_first` flags (reference: dreamerv3 EpisodeReplayBuffer)."""

    def __init__(self, capacity_steps: int, seed=None):
        self.capacity = capacity_steps
        self._eps: List[Dict[str, np.ndarray]] = []
        self._steps = 0
        self._rng = np.random.default_rng(seed)

    def add(self, obs, actions, rewards, terminateds):
        ep = {
            "obs": np.asarray(obs, np.float32),  # T+1 observations
            "actions": np.asarray(actions, np.int64),  # T
            "rewards": np.asarray(rewards, np.float32),  # T
            "terminated": bool(terminateds),
        }
        self._eps.append(ep)
        self._steps += len(ep["actions"])
        while self._steps > self.capacity and len(self._eps) > 1:
            old = self._eps.pop(0)
            self._steps -= len(old["actions"])

    def __len__(self):
        return self._steps

    def sample(self, B: int, T: int) -> Dict[str, np.ndarray]:
        """Each row: T steps; crossing an episode start sets is_first.
        Short episodes are padded by wrapping into another episode
        (standard dreamer replay semantics: the RSSM resets at
        is_first, so stitching is sound)."""
        obs_dim = self._eps[0]["obs"].shape[-1]
        out = {
            "obs": np.zeros((B, T, obs_dim), np.float32),
            "actions": np.zeros((B, T), np.int64),
            "rewards": np.zeros((B, T), np.float32),
            "continues": np.ones((B, T), np.float32),
            "is_first": np.zeros((B, T), np.float32),
        }
        for b in range(B):
            t = 0
            while t < T:
                ep = self._eps[self._rng.integers(len(self._eps))]
                n = len(ep["actions"])
                start = int(self._rng.integers(n)) if t == 0 else 0
                take = min(T - t, n - start)
                sl = slice(start, start + take)
                out["obs"][b, t : t + take] = ep["obs"][:-1][sl]
                out["actions"][b, t : t + take] = ep["actions"][sl]
                out["rewards"][b, t : t + take] = ep["rewards"][sl]
                if ep["terminated"] and start + take == n:
                    out["continues"][b, t + take - 1] = 0.0
                out["is_first"][b, t] = 1.0 if t == 0 or start == 0 else 0.0
                t += take
        return out


# ---------------------------------------------------------------- networks
class _MLP(nn.Module):
    """The reference's `Nets._mlp`: `layers` x (Dense(units) → LayerNorm →
    SiLU), then a Dense head at variance scaling 0.1. `dense.i`,
    `norm.i` and `out` are flax's `<name>_d<i>`, `<name>_ln<i>` and
    `<name>_out`."""

    def __init__(self, in_dim: int, units: int, out: int, generator: torch.Generator,
                 layers: int = 2):
        super().__init__()
        dims = [in_dim] + [units] * layers
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims, dims[1:]))
        self.norm = nn.ModuleList(nn.LayerNorm(units, eps=LN_EPS) for _ in range(layers))
        self.out = nn.Linear(units, out)
        with torch.no_grad():
            for layer in self.dense:
                _variance_scaling_(layer.weight, 1.0, generator)  # flax's lecun normal
                layer.bias.zero_()
            _variance_scaling_(self.out.weight, 0.1, generator)
            self.out.bias.zero_()

    def forward(self, x):
        for dense, norm in zip(self.dense, self.norm):
            x = F.silu(norm(dense(x)))
        return self.out(x)


def _gru_cell(in_dim: int, hidden: int, generator: torch.Generator) -> nn.GRUCell:
    """flax's GRUCell as torch's: the gates' order (r, z, n) and update
    `(1 - z) * n + z * h` are the same; flax has no bias on the hidden
    projections of r and z, so those of `bias_hh` are zeros (a carried
    cell gets zeros there), and a hook keeps their gradient at zero, so
    Adam never moves them. Input kernels start lecun normal, recurrent
    ones orthogonal per gate, biases at zero, as flax's."""
    cell = nn.GRUCell(in_dim, hidden)
    with torch.no_grad():
        for g in range(3):
            rows = slice(g * hidden, (g + 1) * hidden)
            _variance_scaling_(cell.weight_ih[rows], 1.0, generator)
            cell.weight_hh[rows].copy_(
                nn.init.orthogonal_(torch.empty(hidden, hidden), generator=generator).T
            )
        cell.bias_ih.zero_()
        cell.bias_hh.zero_()
    cell.bias_hh.register_hook(_FlaxHiddenBias(hidden))
    return cell


class _FlaxHiddenBias:
    """A gradient hook for `bias_hh`: zero on the r and z gates' rows."""

    def __init__(self, hidden: int):
        self.hidden = hidden

    def __call__(self, grad):
        grad = grad.clone()
        grad[: 2 * self.hidden] = 0
        return grad


class DreamerNets(nn.Module):
    """Every net of the reference's `Nets`, by its name: the world model
    (enc, gru_in, gru_in_ln, gru, prior, post, dec, rew, cont), the actor
    and the critic."""

    def __init__(self, obs_dim: int, n_actions: int, mc: Dict[str, int],
                 generator: torch.Generator):
        super().__init__()
        D, G, C, U = mc["deter"], mc["stoch_groups"], mc["stoch_classes"], mc["units"]
        self.D, self.G, self.C, self.n_actions = D, G, C, n_actions
        feat = D + G * C
        self.enc = _MLP(obs_dim, U, U, generator)
        self.gru_in = nn.Linear(G * C + n_actions, U)
        with torch.no_grad():
            _variance_scaling_(self.gru_in.weight, 1.0, generator)
            self.gru_in.bias.zero_()
        self.gru_in_ln = nn.LayerNorm(U, eps=LN_EPS)
        self.gru = _gru_cell(U, D, generator)
        self.prior = _MLP(D, U, G * C, generator)
        self.post = _MLP(D + U, U, G * C, generator)
        self.dec = _MLP(feat, U, obs_dim, generator)
        self.rew = _MLP(feat, U, mc["bins"], generator)
        self.cont = _MLP(feat, U, 1, generator)
        self.actor = _MLP(feat, U, n_actions, generator)
        self.critic = _MLP(feat, U, mc["bins"], generator)

    def encode(self, obs):
        return self.enc(_symlog(obs))

    def seq(self, deter, stoch, action):
        x = torch.cat(
            [stoch.reshape(stoch.shape[0], -1), F.one_hot(action, self.n_actions).float()], -1
        )
        x = F.silu(self.gru_in_ln(self.gru_in(x)))
        return self.gru(x, deter)

    def prior_logits(self, deter):
        return self.prior(deter).reshape(-1, self.G, self.C)

    def posterior_logits(self, deter, embed):
        return self.post(torch.cat([deter, embed], -1)).reshape(-1, self.G, self.C)

    @staticmethod
    def feat(deter, stoch):
        return torch.cat([deter, stoch.reshape(stoch.shape[0], -1)], -1)


def unimix_sample(logits, gumbel, classes: int):
    """A one-hot draw from the 1%-unimix categorical (Gumbel-max on its
    log-probabilities, as `jax.random.categorical`), with straight-through
    gradients to the logits."""
    probs = torch.softmax(logits, -1)
    probs = 0.99 * probs + 0.01 / classes  # 1% unimix
    logp = torch.log(probs)
    idx = torch.argmax(logp + gumbel, dim=-1)
    hot = F.one_hot(idx, classes).to(probs.dtype)
    return hot + probs - probs.detach(), logp


def _kl_cat(logp_a, logp_b):
    pa = torch.exp(logp_a)
    return torch.sum(pa * (logp_a - logp_b), dim=(-2, -1))


def _logp_unimix(logits, classes: int):
    p = torch.softmax(logits, -1)
    return torch.log(0.99 * p + 0.01 / classes)


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(u)) for u uniform in [tiny, 1)
    (jax.random.gumbel's)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device) * (1.0 - tiny) + tiny
    return -torch.log(-torch.log(u))


class DreamerV3Learner:
    """The nets, the slow critic, the three optimizers and the return
    normalizer on one device, with `train_step` (one update on a replayed
    [B, T] batch) and `act` (one recurrent acting step). Built without
    gymnasium: the algorithm gives it the spaces' sizes."""

    def __init__(self, obs_dim: int, n_actions: int, config: DreamerV3Config):
        self.config = config
        self.device = _learner_device(config.learner_config())
        seed = int(config.seed or 0)
        mc = config.model_config
        self.G, self.C, self.D = mc["stoch_groups"], mc["stoch_classes"], mc["deter"]
        self.obs_dim, self.n_actions = obs_dim, n_actions
        self.twohot = _TwoHot(mc["bins"], device=self.device)
        self.nets = DreamerNets(obs_dim, n_actions, mc,
                                torch.Generator().manual_seed(seed)).to(self.device)
        self.slow_critic = _frozen(self.nets.critic)
        groups: Dict[str, List[nn.Parameter]] = {"wm": [], "actor": [], "critic": []}
        for name, p in self.nets.named_parameters():
            groups[_group_of(name)].append(p)
        self.groups = groups
        lrs = {"wm": config.lr, "actor": config.actor_lr, "critic": config.critic_lr}
        # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8; one
        # multi-tensor step per group, on the CPU too.
        self.optimizers = {
            g: torch.optim.Adam(ps, lr=lrs[g], betas=(0.9, 0.999), eps=1e-8, foreach=True)
            for g, ps in groups.items()
        }
        # Return-normalization percentile EMA, kept on the device.
        self.ret_lo = torch.zeros((), device=self.device)
        self.ret_hi = torch.ones((), device=self.device)
        self._generator = torch.Generator(self.device).manual_seed(seed)

    # ----------------------------------------------------------- draws
    def draw_noise(self, B: int, T: int) -> Dict[str, torch.Tensor]:
        """The Gumbel draws of one train step: the posterior's [T, B, G,
        C], and the imagined actions' [H, T*B, A] and latents' [H, T*B,
        G, C]."""
        H, TB = self.config.horizon, T * B
        g = self._generator
        return {
            "post": gumbel((T, B, self.G, self.C), g, self.device),
            "img_act": gumbel((H, TB, self.n_actions), g, self.device),
            "img_stoch": gumbel((H, TB, self.G, self.C), g, self.device),
        }

    def draw_act_noise(self, n: int) -> Dict[str, torch.Tensor]:
        g = self._generator
        return {"post": gumbel((n, self.G, self.C), g, self.device),
                "act": gumbel((n, self.n_actions), g, self.device)}

    # ------------------------------------------------------------ loss
    def loss(self, batch: Dict[str, torch.Tensor], noise: Dict[str, torch.Tensor]):
        """(total, metrics): the world-model, actor and critic losses on
        one [B, T] batch, the reference's `loss_fn` step for step."""
        cfg, nets, twohot = self.config, self.nets, self.twohot
        G, C = self.G, self.C
        obs = batch["obs"]  # [B, T, obs]
        B, T = obs.shape[:2]
        acts = batch["actions"]
        is_first = batch["is_first"]

        embed = nets.encode(obs.reshape(B * T, -1)).reshape(B, T, -1)
        deter = torch.zeros((B, self.D), device=obs.device)
        stoch = torch.zeros((B, G, C), device=obs.device)
        act_prev = torch.cat([torch.zeros_like(acts[:, :1]), acts[:, :-1]], 1)
        deters, stochs, posts = [], [], []
        for t in range(T):
            # Episode boundary: reset state (v3 resets to zeros).
            keep = 1.0 - is_first[:, t]
            deter = deter * keep[:, None]
            stoch = stoch * keep[:, None, None]
            a = (act_prev[:, t] * keep).long()
            deter = nets.seq(deter, stoch, a)
            post_logits = nets.posterior_logits(deter, embed[:, t])
            stoch, _ = unimix_sample(post_logits, noise["post"][t], C)
            deters.append(deter)
            stochs.append(stoch)
            posts.append(post_logits)
        # [T, B, ...] -> flat [T*B, ...]
        TB = T * B
        deters_f = torch.stack(deters).reshape(TB, -1)
        # The prior feeds nothing inside the scan: one call over all steps.
        prior_logits = nets.prior_logits(deters_f)
        stochs_f = torch.stack(stochs).reshape(TB, G, C)
        feat = nets.feat(deters_f, stochs_f)

        # ---- world-model losses
        dec = nets.dec(feat)
        obs_t = _symlog(obs.transpose(0, 1).reshape(TB, -1))
        recon_loss = torch.mean(torch.sum((dec - obs_t) ** 2, -1))
        rew_target = twohot.encode(batch["rewards"].T.reshape(TB))
        reward_loss = -torch.mean(
            torch.sum(rew_target * torch.log_softmax(nets.rew(feat), -1), -1)
        )
        cont_logits = nets.cont(feat)[..., 0]
        cont_target = batch["continues"].T.reshape(TB)
        cont_loss = torch.mean(
            F.binary_cross_entropy_with_logits(cont_logits, cont_target, reduction="none")
        )
        lp_post = _logp_unimix(torch.stack(posts).reshape(TB, G, C), C)
        lp_prior = _logp_unimix(prior_logits, C)
        dyn = torch.clamp(_kl_cat(lp_post.detach(), lp_prior), min=cfg.free_bits).mean()
        rep = torch.clamp(_kl_cat(lp_post, lp_prior.detach()), min=cfg.free_bits).mean()
        wm_loss = (
            recon_loss
            + reward_loss
            + cont_loss
            + cfg.dyn_loss_scale * dyn
            + cfg.rep_loss_scale * rep
        )

        # ---- imagination rollout from the (detached) posterior states,
        # through the frozen world model. It takes no gradient: actions
        # are discrete draws and the states hold none, so only the
        # actor's logits need one, taken in one call over the whole
        # trajectory below.
        H = cfg.horizon
        deter, stoch = deters_f.detach(), stochs_f.detach()
        tr_deter, tr_stoch, tr_act = [], [], []
        with torch.no_grad():
            for h in range(H):
                a_logits = nets.actor(nets.feat(deter, stoch))
                act = torch.argmax(a_logits + noise["img_act"][h], dim=-1)
                tr_deter.append(deter)
                tr_stoch.append(stoch)
                tr_act.append(act)
                deter = nets.seq(deter, stoch, act)
                stoch, _ = unimix_sample(nets.prior_logits(deter), noise["img_stoch"][h], C)
        all_feat = nets.feat(
            torch.stack(tr_deter + [deter]).reshape((H + 1) * TB, -1),
            torch.stack(tr_stoch + [stoch]).reshape((H + 1) * TB, G, C),
        )
        with torch.no_grad():
            rew = twohot.decode(nets.rew(all_feat)).reshape(H + 1, TB)
            cont = torch.sigmoid(nets.cont(all_feat)[..., 0]).reshape(H + 1, TB)
            slow_vals = twohot.decode(self.slow_critic(all_feat)).reshape(H + 1, TB)
        val_logits = nets.critic(all_feat)
        with torch.no_grad():
            values = twohot.decode(val_logits).reshape(H + 1, TB)
            disc = cfg.gamma * cont
            # Lambda returns, backwards.
            nxt = values[H]
            rets = []
            for t in range(H - 1, -1, -1):
                nxt = rew[t + 1] + disc[t + 1] * (
                    (1 - cfg.gae_lambda) * values[t + 1] + cfg.gae_lambda * nxt
                )
                rets.append(nxt)
            returns = torch.stack(rets[::-1])  # [H, TB], target for values[0..H-1]
            # Return normalization: percentile EMA scale.
            scale = torch.clamp(self.ret_hi - self.ret_lo, min=1.0)
            adv = (returns - values[:H]) / scale
            # Weight by in-horizon continuation probability.
            live = torch.cat(
                [torch.ones((1, TB), device=cont.device), torch.cumprod(cont[:H], 0)[:-1]], 0
            )

        a_logp_all = torch.log_softmax(nets.actor(all_feat[: H * TB]), -1)
        act_logp = torch.take_along_dim(
            a_logp_all, torch.stack(tr_act).reshape(H * TB, 1), 1
        )[:, 0].reshape(H, TB)
        entropy = -torch.sum(torch.exp(a_logp_all) * a_logp_all, -1).reshape(H, TB)
        actor_loss = -torch.mean(live * (adv * act_logp + cfg.entropy_coef * entropy))

        # Critic: twohot CE to lambda returns + slow-critic reg.
        v_logp = torch.log_softmax(val_logits.reshape(H + 1, TB, -1)[:H], -1)
        critic_ce = -torch.sum(twohot.encode(returns) * v_logp, -1)
        critic_reg = -torch.sum(twohot.encode(slow_vals[:H]) * v_logp, -1)
        critic_loss = torch.mean(live * (critic_ce + cfg.critic_ema_reg * critic_reg))

        total = wm_loss + actor_loss + critic_loss
        flat_returns = returns.reshape(-1)
        metrics = {
            "wm_loss": wm_loss,
            "recon_loss": recon_loss,
            "reward_loss": reward_loss,
            "cont_loss": cont_loss,
            "kl_dyn": dyn,
            "actor_loss": actor_loss,
            "critic_loss": critic_loss,
            "entropy": torch.mean(entropy),
            "imagined_return_mean": torch.mean(returns),
            "ret_p5": torch.quantile(flat_returns, 0.05),
            "ret_p95": torch.quantile(flat_returns, 0.95),
        }
        return total, metrics

    def train_step(self, batch: Dict[str, Any],
                   noise: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """One update of all three groups on a replayed batch (numpy or
        tensors; moved to the device once), the slow critic's EMA and the
        return normalizer's; the metrics stay on the device."""
        batch = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                                    device=self.device) for k, v in batch.items()}
        if noise is None:
            B, T = batch["actions"].shape
            noise = self.draw_noise(B, T)
        for opt in self.optimizers.values():
            opt.zero_grad(set_to_none=True)
        total, metrics = self.loss(batch, noise)
        total.backward()
        clip = self.config.grad_clip
        for g, opt in self.optimizers.items():
            if clip:
                torch.nn.utils.clip_grad_norm_(self.groups[g], clip)
            opt.step()
        d = self.config.critic_ema_decay
        with torch.no_grad():
            slow = list(self.slow_critic.parameters())
            torch._foreach_mul_(slow, d)
            torch._foreach_add_(slow, list(self.nets.critic.parameters()), alpha=1 - d)
            self.ret_lo = 0.99 * self.ret_lo + 0.01 * metrics.pop("ret_p5")
            self.ret_hi = 0.99 * self.ret_hi + 0.01 * metrics.pop("ret_p95")
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def act(self, deter, stoch, obs, prev_action, first, noise=None):
        """One acting step for n envs: reset where `first`, advance the
        RSSM on the previous action, take the posterior on `obs`, and draw
        an action from the actor. Returns (deter, stoch, action), on the
        device."""
        nets = self.nets
        obs = torch.as_tensor(obs, dtype=torch.float32, device=self.device)
        if noise is None:
            noise = self.draw_act_noise(obs.shape[0])
        keep = 1.0 - torch.as_tensor(first, dtype=torch.float32, device=self.device)
        deter = deter * keep[:, None]
        stoch = stoch * keep[:, None, None]
        prev = torch.tensor(np.asarray(prev_action), device=self.device)
        prev_action = (prev * keep).long()
        deter = nets.seq(deter, stoch, prev_action)
        post = nets.posterior_logits(deter, nets.encode(obs))
        stoch, _ = unimix_sample(post, noise["post"], self.C)
        logits = nets.actor(nets.feat(deter, stoch))
        action = torch.argmax(logits + noise["act"], dim=-1)
        return deter, stoch, action

    # ----------------------------------------------------------- state
    def get_state(self) -> Dict[str, Any]:
        return {
            "params": _to_host(self.nets.state_dict()),
            "slow_critic": _to_host(self.slow_critic.state_dict()),
            "opt_state": {g: _to_host(o.state_dict()) for g, o in self.optimizers.items()},
            "ret_lo": float(self.ret_lo),
            "ret_hi": float(self.ret_hi),
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        self.nets.load_state_dict(state["params"])
        self.slow_critic.load_state_dict(state["slow_critic"])
        for g, o in self.optimizers.items():
            o.load_state_dict(state["opt_state"][g])
        self.ret_lo = torch.tensor(state["ret_lo"], device=self.device)
        self.ret_hi = torch.tensor(state["ret_hi"], device=self.device)


def _group_of(param_name: str) -> str:
    if param_name.startswith(WM_PREFIXES):
        return "wm"
    return "actor" if param_name.startswith("actor") else "critic"


def _frozen(module: nn.Module) -> nn.Module:
    import copy

    out = copy.deepcopy(module)
    out.requires_grad_(False)
    return out


class DreamerV3(Algorithm):
    """Owns collection (recurrent acting), replay, and the learner."""

    learner_class = None  # self-contained: no shared Learner machinery

    def setup(self, config_dict) -> None:
        import gymnasium as gym

        # Same config unpacking as Algorithm.setup, WITHOUT the shared
        # env-runner/learner groups (recurrent acting owns its loop).
        self.config = config_dict["__algorithm_config__"].copy()
        for k, v in config_dict.items():
            if k != "__algorithm_config__" and hasattr(self.config, k):
                setattr(self.config, k, v)
        cfg = self.config
        env_spec = cfg.env
        self._envs = [
            (env_spec() if callable(env_spec) else gym.make(env_spec))
            for _ in range(cfg.num_envs)
        ]
        obs_space = self._envs[0].observation_space
        act_space = self._envs[0].action_space
        self._obs_dim = int(np.prod(obs_space.shape))
        self._n_actions = int(act_space.n)
        self.replay = _EpisodeReplay(cfg.replay_capacity_steps, cfg.seed)
        try:
            self.learner = DreamerV3Learner(self._obs_dim, self._n_actions, cfg)
        except BaseException:
            self.stop()
            raise
        self._G, self._C, self._D = self.learner.G, self.learner.C, self.learner.D
        # Per-env recurrent state + open episode accumulators.
        self._reset_collection()
        self._total_env_steps = 0
        self._updates = 0
        self._ep_returns: List[float] = []

    # ---------------------------------------------------------- collection
    def _reset_collection(self):
        n, dev = self.config.num_envs, self.learner.device
        self._deter = torch.zeros((n, self._D), device=dev)
        self._stoch = torch.zeros((n, self._G, self._C), device=dev)
        self._prev_action = np.zeros((n,), np.int64)
        self._first = np.ones((n,), np.float32)
        self._cur_obs = []
        self._acc = []
        for i, env in enumerate(self._envs):
            obs, _ = env.reset(seed=(self.config.seed or 0) + i)
            self._cur_obs.append(np.asarray(obs, np.float32))
            self._acc.append(
                {"obs": [self._cur_obs[i]], "actions": [], "rewards": []}
            )

    def _collect(self, n_steps: int):
        steps = 0
        while steps < n_steps:
            obs = np.stack(self._cur_obs)
            self._deter, self._stoch, action = self.learner.act(
                self._deter, self._stoch, obs, self._prev_action, self._first
            )
            actions = action.cpu().numpy()
            self._first = np.zeros_like(self._first)
            for i, env in enumerate(self._envs):
                o, r, term, trunc, _ = env.step(int(actions[i]))
                acc = self._acc[i]
                acc["actions"].append(int(actions[i]))
                acc["rewards"].append(float(r))
                acc["obs"].append(np.asarray(o, np.float32))
                steps += 1
                self._total_env_steps += 1
                if term or trunc:
                    self.replay.add(
                        acc["obs"], acc["actions"], acc["rewards"], term
                    )
                    self._ep_returns.append(float(np.sum(acc["rewards"])))
                    o, _ = self._envs[i].reset()
                    self._acc[i] = {
                        "obs": [np.asarray(o, np.float32)],
                        "actions": [],
                        "rewards": [],
                    }
                    self._first[i] = 1.0
                self._cur_obs[i] = np.asarray(o, np.float32)
            self._prev_action = actions

    # ------------------------------------------------------------ training
    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        self._collect(cfg.sample_timesteps_per_iteration)
        if len(self.replay) < cfg.num_steps_sampled_before_learning_starts:
            return {"buffer_steps": float(len(self.replay))}
        n_updates = max(
            1,
            int(
                cfg.sample_timesteps_per_iteration
                * cfg.train_ratio
                / (cfg.batch_size_B * cfg.batch_length_T)
            ),
        )
        metrics_list = []
        for _ in range(n_updates):
            batch = self.replay.sample(cfg.batch_size_B, cfg.batch_length_T)
            metrics_list.append(self.learner.train_step(batch))
            self._updates += 1
        # One copy to the host per iteration.
        means = {k: torch.stack([m[k] for m in metrics_list]).mean()
                 for k in metrics_list[0]}
        out = {k: float(v) for k, v in _to_host(means).items()}
        out["buffer_steps"] = float(len(self.replay))
        out["num_updates"] = float(self._updates)
        return out

    def step(self) -> Dict[str, Any]:
        # Self-contained metrics (no shared env-runner group).
        learner_metrics = self.training_step()
        self._iteration = getattr(self, "_iteration", 0) + 1
        recent = self._ep_returns[-100:]
        return {
            "training_iteration": self._iteration,
            "num_env_steps_sampled_lifetime": self._total_env_steps,
            "episode_return_mean": (
                float(np.mean(recent)) if recent else float("nan")
            ),
            "learners": learner_metrics,
        }

    def train(self) -> Dict[str, Any]:
        return self.step()

    def evaluate(self, num_episodes: int = 10) -> Dict[str, Any]:
        recent = self._ep_returns[-num_episodes:]
        return {
            "episode_return_mean": (
                float(np.mean(recent)) if recent else float("nan")
            ),
            "num_episodes": len(recent),
        }

    def save_checkpoint(self, checkpoint_dir: str) -> str:
        import os
        import pickle

        state = {
            **self.learner.get_state(),
            "iteration": getattr(self, "_iteration", 0),
            "total_env_steps": self._total_env_steps,
            "updates": self._updates,
        }
        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        with open(path, "wb") as f:
            pickle.dump(state, f)
        return checkpoint_dir

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        import os
        import pickle

        with open(
            os.path.join(checkpoint_dir, "algorithm_state.pkl"), "rb"
        ) as f:
            state = pickle.load(f)
        self.learner.set_state(state)
        self._iteration = state["iteration"]
        self._total_env_steps = state["total_env_steps"]
        self._updates = state["updates"]

    save = save_checkpoint
    restore = load_checkpoint

    def stop(self) -> None:
        for env in self._envs:
            env.close()
