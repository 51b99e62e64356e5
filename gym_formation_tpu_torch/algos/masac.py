"""MASAC: multi-agent Soft Actor-Critic with centralized twin critics.

Counterpart of ``gym_formation_tpu/algos/masac.py``, on the chassis of
:class:`~gym_formation_tpu_torch.algos.maddpg.OffPolicy`: per-agent
tanh-Gaussian actors sampled by reparameterization, the minimum of twin
critics in a soft target, and a temperature ``α_i = exp(log_alpha[i])`` per
agent tuned by its own Adam toward the entropy target ``−act_dim``.  On a
discrete env the actors give logits: a straight-through Gumbel-softmax
sample stands in for the action, the soft value and the α terms take the
exact categorical entropy (the one-sample log-probability has unbounded
variance), and the entropy target is ``target_entropy_ratio · log |A|``.
Actions are uniform until ``warmup_random_steps`` env steps are taken.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from ..env import FormationEnv
from ..models.networks import (
    StackedActor,
    StackedSquashedGaussianActor,
    StackedTwinQCritic,
    categorical_entropy,
    categorical_logp,
    gumbel,
    gumbel_softmax_st,
    onehot_from_logits,
    squashed_actor_from_flax,
    stacked_actor_from_flax,
    twin_q_critic_from_flax,
)
from .maddpg import OffPolicy, ReplayBuffer, soft_update
from .optim import AdamState, ClipAdam

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class MASACConfig:
    """The JAX package's fields and defaults; see
    ``gym_formation_tpu/algos/masac.py:MASACConfig``."""

    lr: float = 3e-4
    alpha_lr: float = 3e-4
    gamma: float = 0.95
    tau: float = 0.01
    buffer_size: int = 500_000
    batch_size: int = 256
    hidden: Tuple[int, ...] = (64, 64, 64)
    high_action: float = 1.0
    init_alpha: float = 0.2
    autotune_alpha: bool = True
    mask_done: bool = False
    target_entropy_ratio: float = 0.6  # discrete entropy target = ratio · log|A|
    steps_per_iter: int = 32
    updates_per_iter: int = 32
    warmup_random_steps: int = 256


def sample_squashed(eps: torch.Tensor, mean: torch.Tensor, log_std: torch.Tensor,
                    high_action: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tanh-Gaussian sample of the standard normal ``eps`` (scaled to
    ±high_action) and its log-probability, with the tanh's change of
    variables."""
    pre = mean + torch.exp(log_std) * eps
    logp = (-0.5 * eps ** 2 - log_std - 0.5 * _LOG_2PI).sum(-1)
    a = torch.tanh(pre)
    logp = logp - torch.log(torch.clamp(1 - a ** 2, min=1e-6)).sum(-1)
    return a * high_action, logp


@dataclasses.dataclass
class MASACState:
    actor: torch.nn.Module  # stacked over the agents
    critic: torch.nn.Module  # twin
    target_critic: torch.nn.Module
    log_alpha: torch.nn.Parameter  # [N]
    actor_opt: AdamState
    critic_opt: AdamState
    alpha_opt: AdamState
    env_steps: int


class MASAC(OffPolicy):
    loss_keys = ("critic_loss", "actor_loss", "alpha", "entropy")

    def __init__(self, env: FormationEnv, cfg: MASACConfig = MASACConfig(), num_envs: int = 32,
                 device="cuda", dtype: torch.dtype = torch.float32):
        super().__init__(env, cfg, num_envs, device, dtype)
        self.target_entropy = (cfg.target_entropy_ratio * math.log(self.act_dim) if self.discrete
                               else -float(self.act_dim))
        self.actor_tx = ClipAdam(cfg.lr)
        self.critic_tx = ClipAdam(cfg.lr)
        self.alpha_tx = ClipAdam(cfg.alpha_lr)

    # -- setup --------------------------------------------------------------
    def _networks(self, generator: Optional[torch.Generator] = None) -> Dict[str, torch.nn.Module]:
        cfg, N, do, da = self.cfg, self.n_agents, self.obs_dim, self.act_dim
        actor = (StackedActor(N, do, da, cfg.hidden, discrete=True, generator=generator) if self.discrete
                 else StackedSquashedGaussianActor(N, do, da, cfg.hidden, generator))
        return {"actor": actor, "critic": StackedTwinQCritic(N, N * (do + da), cfg.high_action, cfg.hidden, generator)}

    def init_state(self, actor: torch.nn.Module, critic: torch.nn.Module,
                   target_critic: Optional[torch.nn.Module] = None,
                   log_alpha: Optional[torch.Tensor] = None) -> MASACState:
        """A fresh training state around the given networks: the target a
        copy unless given, ``log_alpha`` ``log(init_alpha)`` unless given,
        each Adam at step 0."""
        actor, critic = self._to(actor), self._to(critic)
        la = (torch.full((self.n_agents,), math.log(self.cfg.init_alpha)) if log_alpha is None
              else torch.as_tensor(log_alpha))
        la = torch.nn.Parameter(la.to(device=self.device, dtype=self.dtype))
        return MASACState(
            actor=actor, critic=critic, target_critic=self._target(critic, target_critic), log_alpha=la,
            actor_opt=self.actor_tx.init(list(actor.parameters())),
            critic_opt=self.critic_tx.init(list(critic.parameters())),
            alpha_opt=self.alpha_tx.init([la]), env_steps=0,
        )

    def state_from_flax(self, params: Dict) -> MASACState:
        """A fresh training state holding the JAX package's stacked trees
        ``{'actor', 'critic'[, 'target_critic', 'log_alpha']}``."""
        actor_fn = stacked_actor_from_flax if self.discrete else squashed_actor_from_flax
        critic_fn = lambda t: twin_q_critic_from_flax(t, self.cfg.high_action, self.dtype)
        tc = params.get("target_critic")
        return self.init_state(actor_fn(params["actor"], self.dtype), critic_fn(params["critic"]),
                               None if tc is None else critic_fn(tc), params.get("log_alpha"))

    # -- the policy ---------------------------------------------------------
    def _policy_sample(self, dist, noise: torch.Tensor):
        """The reparameterized sample and its log-probability on the draw
        ``noise``: tanh-Gaussian on standard normals, or (discrete) the
        straight-through Gumbel-softmax one-hot and its categorical mass."""
        if self.discrete:
            a = gumbel_softmax_st(noise, dist)
            return a, categorical_logp(dist, a.detach())
        return sample_squashed(noise, *dist, self.cfg.high_action)

    def _noise(self, generator: torch.Generator, shape) -> torch.Tensor:
        if self.discrete:
            return gumbel(generator, shape, self.dtype, self.device)
        return torch.randn(shape, generator=generator, dtype=self.dtype, device=self.device)

    def _explore(self, ts: MASACState, obs: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        return self._policy_sample(ts.actor(obs.to(self.dtype)), noise)[0]

    @torch.no_grad()
    def explore_actions(self, ts: MASACState, obs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """A policy sample, or uniform actions (one-hots) during the warm-up."""
        shape = obs.shape[:2] + (self.act_dim,)
        if ts.env_steps < self.cfg.warmup_random_steps:
            if self.discrete:
                idx = torch.randint(0, self.act_dim, shape[:2], generator=generator, device=self.device)
                return torch.nn.functional.one_hot(idx, self.act_dim).to(self.dtype)
            h = self.cfg.high_action
            return torch.rand(shape, generator=generator, dtype=self.dtype, device=self.device) * (2 * h) - h
        return self._explore(ts, obs, self._noise(generator, shape))

    @torch.no_grad()
    def eval_actions(self, ts: MASACState, obs: torch.Tensor) -> torch.Tensor:
        dist = ts.actor(obs.to(self.dtype))
        if self.discrete:
            return onehot_from_logits(dist)
        return torch.tanh(dist[0]) * self.cfg.high_action

    # -- losses and the update ----------------------------------------------
    def _losses(self, ts: MASACState, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor]):
        """Per-agent critic, actor and temperature losses and entropies [N],
        on the next actions' draw ``draws['next']`` and the fresh actions'
        ``draws['new']`` ([M, N, da] each).  The target carries no
        gradient; the actor loss holds α and the critics fixed; the α loss
        the entropy term."""
        cfg = self.cfg
        obs, act = batch["obs"], batch["action"]
        alpha = torch.exp(ts.log_alpha)
        with torch.no_grad():
            dist_n = ts.actor(batch["next_obs"])
            a_next, logp_next = self._policy_sample(dist_n, draws["next"])
            if self.discrete:
                logp_next = -categorical_entropy(dist_n)
            q1n, q2n = ts.target_critic(self._joint(batch["next_obs"]), self._joint(a_next))
            nonterm = (1.0 - batch["done"].to(q1n.dtype))[:, None] if cfg.mask_done else 1.0
            target = batch["reward"] + cfg.gamma * (torch.minimum(q1n, q2n) - alpha * logp_next) * nonterm
        dist_c = ts.actor(obs)
        a_new, logp_new = self._policy_sample(dist_c, draws["new"])
        if self.discrete:
            logp_new = -categorical_entropy(dist_c)
        o_all = self._joint(obs)
        q1, q2 = ts.critic(o_all, self._joint(act))
        critic_loss = ((target - q1) ** 2).mean(0) + ((target - q2) ** 2).mean(0)
        q1p, q2p = ts.critic(o_all, self._substitute(act, a_new))
        actor_loss = (alpha.detach() * logp_new - torch.minimum(q1p, q2p)).mean(0)
        alpha_loss = -(ts.log_alpha * (logp_new.detach() + self.target_entropy)).mean(0)
        return critic_loss, actor_loss, alpha_loss, -logp_new.detach().mean(0)

    def _update_draws(self, generator: torch.Generator, M: int) -> Dict[str, torch.Tensor]:
        shape = (M, self.n_agents, self.act_dim)
        return {"next": self._noise(generator, shape), "new": self._noise(generator, shape)}

    def _update_once(self, ts: MASACState, batch: Dict[str, torch.Tensor],
                     draws: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update: critics, actors and (``autotune_alpha``) the
        temperatures, each from its own loss, every gradient taken before
        any parameter moves; then the soft target."""
        c_l, a_l, al_l, ent = self._losses(ts, batch, draws)
        alpha = torch.exp(ts.log_alpha.detach())
        c_params, a_params = list(ts.critic.parameters()), list(ts.actor.parameters())
        g_c = torch.autograd.grad(c_l.sum(), c_params)
        g_a = torch.autograd.grad(a_l.sum(), a_params)
        if self.cfg.autotune_alpha:
            g_al = torch.autograd.grad(al_l.sum(), [ts.log_alpha])
        ts.critic_opt = self.critic_tx.step(c_params, g_c, ts.critic_opt)
        ts.actor_opt = self.actor_tx.step(a_params, g_a, ts.actor_opt)
        if self.cfg.autotune_alpha:
            ts.alpha_opt = self.alpha_tx.step([ts.log_alpha], g_al, ts.alpha_opt)
        soft_update(ts.target_critic, ts.critic, self.cfg.tau)
        return {"critic_loss": c_l.detach().mean(), "actor_loss": a_l.detach().mean(), "alpha": alpha.mean(),
                "entropy": ent.mean()}

    def _train_once(self, ts: MASACState, buffer: ReplayBuffer, generator: torch.Generator):
        M = self.cfg.batch_size
        return self._update_once(ts, buffer.sample(generator, M), self._update_draws(generator, M))
