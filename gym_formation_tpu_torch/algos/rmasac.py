"""RMASAC: recurrent multi-agent Soft Actor-Critic.

Counterpart of ``gym_formation_tpu/algos/rmasac.py``, on the chassis of
:class:`~gym_formation_tpu_torch.algos.rmaddpg.Episodic`: per-agent GRU
actors with a tanh-Gaussian head (one stacked network), twin centralized MLP
critics with a soft target, and a temperature ``α_i = exp(log_alpha[i])``
per agent tuned toward the entropy target ``−act_dim`` when
``autotune_alpha``.  There is no target actor: the next actions and the
fresh ones both come from the online actors, rolled over whole episodes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from ..env import FormationEnv
from ..models.networks import (
    StackedRecurrentSquashedActor, StackedTwinQCritic, recurrent_squashed_actor_from_flax, twin_q_critic_from_flax,
)
from .maddpg import soft_update
from .masac import sample_squashed
from .optim import AdamState, ClipAdam
from .rmaddpg import Episodic


@dataclasses.dataclass(frozen=True)
class RMASACConfig:
    """The JAX package's fields and defaults; see
    ``gym_formation_tpu/algos/rmasac.py:RMASACConfig``."""

    lr: float = 3e-4
    alpha_lr: float = 3e-4
    gamma: float = 0.95
    tau: float = 0.01
    buffer_episodes: int = 4096
    batch_episodes: int = 32
    gru_hidden: int = 64
    critic_hidden: Tuple[int, ...] = (64, 64, 64)
    high_action: float = 1.0
    init_alpha: float = 0.2
    autotune_alpha: bool = True
    episodes_per_iter: int = 8
    updates_per_iter: int = 4


@dataclasses.dataclass
class RMASACState:
    actor: torch.nn.Module  # stacked over the agents
    critic: torch.nn.Module  # twin
    target_critic: torch.nn.Module
    log_alpha: torch.nn.Parameter  # [N]
    actor_opt: AdamState
    critic_opt: AdamState
    alpha_opt: AdamState
    env_steps: int


class RMASAC(Episodic):
    loss_keys = ("critic_loss", "actor_loss", "alpha", "entropy")

    def __init__(self, env: FormationEnv, cfg: RMASACConfig = RMASACConfig(), num_envs: int = 8,
                 device="cuda", dtype: torch.dtype = torch.float32):
        super().__init__(env, cfg, num_envs, device, dtype)
        self.target_entropy = -float(self.act_dim)
        self.actor_tx = ClipAdam(cfg.lr)
        self.critic_tx = ClipAdam(cfg.lr)
        self.alpha_tx = ClipAdam(cfg.alpha_lr)

    # -- setup --------------------------------------------------------------
    def _networks(self, generator: Optional[torch.Generator] = None) -> Dict[str, torch.nn.Module]:
        cfg, N, do, da = self.cfg, self.n_agents, self.obs_dim, self.act_dim
        return {"actor": StackedRecurrentSquashedActor(N, do, da, cfg.gru_hidden, generator),
                "critic": StackedTwinQCritic(N, N * (do + da), cfg.high_action, cfg.critic_hidden, generator)}

    def init_state(self, actor: torch.nn.Module, critic: torch.nn.Module,
                   target_critic: Optional[torch.nn.Module] = None,
                   log_alpha: Optional[torch.Tensor] = None) -> RMASACState:
        """A fresh training state around the given networks: the target a
        copy unless given, ``log_alpha`` ``log(init_alpha)`` unless given,
        each Adam at step 0."""
        actor, critic = self._to(actor), self._to(critic)
        la = (torch.full((self.n_agents,), math.log(self.cfg.init_alpha)) if log_alpha is None
              else torch.as_tensor(log_alpha))
        la = torch.nn.Parameter(la.to(device=self.device, dtype=self.dtype))
        return RMASACState(
            actor=actor, critic=critic, target_critic=self._target(critic, target_critic), log_alpha=la,
            actor_opt=self.actor_tx.init(list(actor.parameters())),
            critic_opt=self.critic_tx.init(list(critic.parameters())),
            alpha_opt=self.alpha_tx.init([la]), env_steps=0,
        )

    def state_from_flax(self, params: Dict) -> RMASACState:
        """A fresh training state holding the JAX package's stacked trees
        ``{'actor', 'critic'[, 'target_critic', 'log_alpha']}``."""
        critic_fn = lambda t: twin_q_critic_from_flax(t, self.cfg.high_action, self.dtype)
        tc = params.get("target_critic")
        return self.init_state(recurrent_squashed_actor_from_flax(params["actor"], self.dtype),
                               critic_fn(params["critic"]), None if tc is None else critic_fn(tc),
                               params.get("log_alpha"))

    # -- the actors ---------------------------------------------------------
    def _actor_step(self, actor: torch.nn.Module, carry: torch.Tensor, obs: torch.Tensor,
                    reset: Optional[torch.Tensor] = None):
        """carry [.., N, H], obs [.., N, do], reset [..] → (carry, (mean,
        log_std))."""
        reset_n = None if reset is None else reset[..., None].expand(obs.shape[:-1])
        return actor(carry, obs, reset_n)

    def _actor_rollout(self, actor: torch.nn.Module, obs_seq: torch.Tensor, eps: torch.Tensor):
        """Samples over episodes [M, T', N, do] on the standard normals
        ``eps`` [M, T', N, da] → actions [M, T', N, da] and their
        log-probabilities [M, T', N]."""
        def step(h, o, e):
            h, (mean, log_std) = self._actor_step(actor, h, o)
            return h, sample_squashed(e, mean, log_std, self.cfg.high_action)

        return self._scan(step, obs_seq, eps)

    # -- exploration --------------------------------------------------------
    def _episode_draws(self, generator: torch.Generator, B: int) -> Dict[str, torch.Tensor]:
        shape = (B, self.T, self.n_agents, self.act_dim)
        return {"eps": torch.randn(shape, generator=generator, dtype=self.dtype, device=self.device)}

    def _act(self, ts: RMASACState, carry, obs, draws):
        """A policy sample on the standard normals ``draws['eps']``."""
        carry, (mean, log_std) = self._actor_step(ts.actor, carry, obs.to(self.dtype))
        return carry, sample_squashed(draws["eps"], mean, log_std, self.cfg.high_action)[0]

    # -- losses and the update ----------------------------------------------
    def _losses(self, ts: RMASACState, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor]):
        """Per-agent critic, actor and temperature losses and entropies [N]
        over a batch of M episodes.  The next actions are sampled over the
        whole ``T+1``-step episode on ``draws['next']`` [M, T+1, N, da] and
        sliced; the fresh ones over the first T steps on ``draws['new']``
        [M, T, N, da].  The last step's bootstrap is masked.  The target
        carries no gradient; the actor loss holds α and the critics fixed;
        the α loss the entropy term."""
        cfg = self.cfg
        obs, act = batch["obs"], batch["action"]
        M, T, N = act.shape[:3]
        flat = lambda x: x.reshape(M * T, N, -1)
        alpha = torch.exp(ts.log_alpha)
        with torch.no_grad():
            a_next, logp_next = self._actor_rollout(ts.actor, obs, draws["next"])
            q1n, q2n = ts.target_critic(self._joint(flat(obs[:, 1:])), self._joint(flat(a_next[:, 1:])))
            soft_q = (torch.minimum(q1n, q2n) - alpha * logp_next[:, 1:].reshape(M * T, N)).reshape(M, T, N)
            target = (batch["reward"] + cfg.gamma * soft_q * self._nonterm(T)).reshape(M * T, N)
        o_in, u_flat = self._joint(flat(obs[:, :-1])), flat(act)
        q1, q2 = ts.critic(o_in, self._joint(u_flat))
        critic_loss = ((target - q1) ** 2).mean(0) + ((target - q2) ** 2).mean(0)
        a_new, logp_new = self._actor_rollout(ts.actor, obs[:, :-1], draws["new"])
        lp = logp_new.reshape(M * T, N)
        q1p, q2p = ts.critic(o_in, self._substitute(u_flat, flat(a_new)))
        actor_loss = (alpha.detach() * lp - torch.minimum(q1p, q2p)).mean(0)
        alpha_loss = -(ts.log_alpha * (lp.detach() + self.target_entropy)).mean(0)
        return critic_loss, actor_loss, alpha_loss, -lp.detach().mean(0)

    def _update_draws(self, generator: torch.Generator, M: int) -> Dict[str, torch.Tensor]:
        kw = dict(generator=generator, dtype=self.dtype, device=self.device)
        N, da = self.n_agents, self.act_dim
        return {"next": torch.randn((M, self.T + 1, N, da), **kw), "new": torch.randn((M, self.T, N, da), **kw)}

    def _update_once(self, ts: RMASACState, batch: Dict[str, torch.Tensor],
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
