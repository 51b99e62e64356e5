"""QMIX and VDN: value factorization over the discrete (5-way one-hot)
actions.

Counterpart of ``gym_formation_tpu/algos/qmix.py``, on the chassis of
:class:`~gym_formation_tpu_torch.algos.maddpg.OffPolicy`: one Q network
shared by every agent (a :class:`~gym_formation_tpu_torch.models.networks.LogitsActor`
over ``obs ⊕ one-hot agent id``, the JAX package's ``AgentQNet``), ε-greedy
exploration on a linear schedule, and the agents' chosen Q's mixed into
``Q_tot`` by :class:`~gym_formation_tpu_torch.models.networks.QMixer`
(``mixer="qmix"``) or by their sum (``"vdn"``).  The TD target takes double
Q (the online network picks, the target evaluates), the shared reward of
agent 0, and soft target updates, or hard ones every ``hard_interval``
updates.  The Q network and the mixer share one Adam with a global-norm
clip at 10.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..env import FormationEnv
from ..models.networks import LogitsActor, QMixer, logits_actor_from_flax, qmixer_from_flax
from .maddpg import OffPolicy, ReplayBuffer, hard_update, soft_update
from .optim import AdamState, ClipAdam

MIXERS = ("qmix", "vdn")


@dataclasses.dataclass(frozen=True)
class QMixConfig:
    """The JAX package's fields and defaults; see
    ``gym_formation_tpu/algos/qmix.py:QMixConfig``."""

    mixer: str = "qmix"  # 'qmix' | 'vdn'
    lr: float = 5e-4
    gamma: float = 0.99
    tau: float = 0.005
    hard_interval: int = 0  # > 0: hard target updates every this many updates
    buffer_size: int = 200_000
    batch_size: int = 256
    hidden: Tuple[int, ...] = (64, 64)
    mixer_embed: int = 32
    eps_start: float = 1.0
    eps_finish: float = 0.05
    eps_anneal_steps: int = 50_000
    double_q: bool = True
    mask_done: bool = False
    steps_per_iter: int = 32
    updates_per_iter: int = 8


@dataclasses.dataclass
class QMixState:
    q: torch.nn.Module  # shared over the agents
    mixer: Optional[QMixer]  # None for VDN
    target_q: torch.nn.Module
    target_mixer: Optional[QMixer]
    opt: AdamState
    env_steps: int
    grad_updates: int


class Mixing:
    """What QMix and the recurrent RQMix share: the learner's checks and
    optimizer, its state around a Q network and a mixer, the ε schedule and
    the mixing.  A learner names its Q network's converter
    (``q_from_flax``)."""

    N_ACTIONS = 5
    loss_keys = ("q_loss", "q_tot")
    q_from_flax = None

    def __init__(self, env: FormationEnv, cfg, num_envs: int, device, dtype: torch.dtype):
        if not env.discrete_action:
            raise ValueError(f"{type(self).__name__} requires a discrete_action env")
        if cfg.mixer not in MIXERS:
            raise ValueError(f"unknown mixer {cfg.mixer!r}; choose from {MIXERS}")
        super().__init__(env, cfg, num_envs, device, dtype)
        self.act_dim = self.N_ACTIONS
        self.tx = ClipAdam(cfg.lr, 10.0)

    def _mixer(self, generator: Optional[torch.Generator]) -> Optional[QMixer]:
        N, cfg = self.n_agents, self.cfg
        return QMixer(N, N * self.obs_dim, cfg.mixer_embed, generator) if cfg.mixer == "qmix" else None

    @staticmethod
    def _params(q: torch.nn.Module, mixer: Optional[QMixer]) -> List[torch.nn.Parameter]:
        return list(q.parameters()) + (list(mixer.parameters()) if mixer is not None else [])

    def init_state(self, q: torch.nn.Module, mixer: Optional[QMixer] = None,
                   target_q: Optional[torch.nn.Module] = None,
                   target_mixer: Optional[QMixer] = None) -> QMixState:
        """A fresh training state: targets copies unless given, Adam (over
        the Q network and the mixer together) at step 0."""
        q = self._to(q)
        mixer = None if mixer is None else self._to(mixer)
        return QMixState(q=q, mixer=mixer, target_q=self._target(q, target_q),
                         target_mixer=None if mixer is None else self._target(mixer, target_mixer),
                         opt=self.tx.init(self._params(q, mixer)), env_steps=0, grad_updates=0)

    def state_from_flax(self, params: Dict) -> QMixState:
        """A fresh training state holding the JAX package's trees ``{'q',
        'mixer'[, 'target_q', 'target_mixer']}`` (``mixer`` empty for VDN)."""
        q_fn = lambda t: self.q_from_flax(t, self.dtype)
        mix_fn = lambda t: qmixer_from_flax(t, self.dtype) if t else None
        opt = lambda k, fn: fn(params[k]) if k in params else None
        return self.init_state(q_fn(params["q"]), mix_fn(params["mixer"]), opt("target_q", q_fn),
                               opt("target_mixer", mix_fn))

    def _with_ids(self, obs: torch.Tensor) -> torch.Tensor:
        """``obs`` [..., N, do] ⊕ the one-hot agent id."""
        N = self.n_agents
        return torch.cat([obs, torch.eye(N, dtype=obs.dtype, device=obs.device).expand(obs.shape[:-1] + (N,))], -1)

    def epsilon(self, ts: QMixState) -> float:
        """Linear from ``eps_start`` to ``eps_finish`` over
        ``eps_anneal_steps`` env steps, then flat."""
        cfg = self.cfg
        frac = min(max(ts.env_steps / cfg.eps_anneal_steps, 0.0), 1.0)
        return cfg.eps_start + (cfg.eps_finish - cfg.eps_start) * frac

    def _mix(self, mixer: Optional[QMixer], q_chosen: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
        return mixer(q_chosen, state) if mixer is not None else q_chosen.sum(-1)


class QMix(Mixing, OffPolicy):
    """QMIX and VDN (``cfg.mixer``)."""

    q_from_flax = staticmethod(logits_actor_from_flax)

    def __init__(self, env: FormationEnv, cfg: QMixConfig = QMixConfig(), num_envs: int = 32,
                 device="cuda", dtype: torch.dtype = torch.float32):
        super().__init__(env, cfg, num_envs, device, dtype)

    # -- setup --------------------------------------------------------------
    def _networks(self, generator: Optional[torch.Generator] = None) -> Dict[str, Optional[torch.nn.Module]]:
        q = LogitsActor(self.obs_dim + self.n_agents, self.N_ACTIONS, self.cfg.hidden, generator)
        return {"q": q, "mixer": self._mixer(generator)}

    # -- acting -------------------------------------------------------------
    def _q_all(self, q: torch.nn.Module, obs: torch.Tensor) -> torch.Tensor:
        """obs [..., N, do] → Q [..., N, A] by the shared network on
        ``obs ⊕ one-hot agent id``."""
        return q(self._with_ids(obs))

    def _explore(self, ts: QMixState, obs: torch.Tensor, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
        """ε-greedy over Q on the draws ``uniform`` [B, N] (against ε) and
        ``rand`` [B, N] (random actions), as one-hots."""
        greedy = self._q_all(ts.q, obs.to(self.dtype)).argmax(-1)
        pick = torch.where(draws["uniform"] < self.epsilon(ts), draws["rand"], greedy)
        return torch.nn.functional.one_hot(pick, self.N_ACTIONS).to(self.dtype)

    @torch.no_grad()
    def explore_actions(self, ts: QMixState, obs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        shape = obs.shape[:2]
        draws = {"uniform": torch.rand(shape, generator=generator, dtype=self.dtype, device=self.device),
                 "rand": torch.randint(0, self.N_ACTIONS, shape, generator=generator, device=self.device)}
        return self._explore(ts, obs, draws)

    @torch.no_grad()
    def eval_actions(self, ts: QMixState, obs: torch.Tensor) -> torch.Tensor:
        q = self._q_all(ts.q, obs.to(self.dtype))
        return torch.nn.functional.one_hot(q.argmax(-1), self.N_ACTIONS).to(self.dtype)

    def _iteration_metrics(self, ts: QMixState, buffer: ReplayBuffer) -> Dict:
        return {"epsilon": self.epsilon(ts)}

    # -- the update ---------------------------------------------------------
    def _loss(self, ts: QMixState, batch: Dict[str, torch.Tensor]):
        """The mean squared TD error of ``Q_tot``; the target (double Q,
        agent 0's reward) carries no gradient."""
        cfg = self.cfg
        obs, nobs = batch["obs"], batch["next_obs"]
        M = obs.shape[0]
        chosen = lambda q, idx: q.gather(-1, idx[..., None]).squeeze(-1)
        q_tot = self._mix(ts.mixer, chosen(self._q_all(ts.q, obs), batch["action"].argmax(-1)), obs.reshape(M, -1))
        with torch.no_grad():
            q_next_target = self._q_all(ts.target_q, nobs)
            sel = (self._q_all(ts.q, nobs) if cfg.double_q else q_next_target).argmax(-1)
            q_tot_next = self._mix(ts.target_mixer, chosen(q_next_target, sel), nobs.reshape(M, -1))
            r = batch["reward"][:, 0]  # the shared reward: every agent's is the same
            nonterm = (1.0 - batch["done"].to(r.dtype)) if cfg.mask_done else 1.0
            y = r + cfg.gamma * q_tot_next * nonterm
        loss = ((y - q_tot) ** 2).mean()
        return loss, {"q_loss": loss, "q_tot": q_tot.mean()}

    def _update_once(self, ts: QMixState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        loss, aux = self._loss(ts, batch)
        params = self._params(ts.q, ts.mixer)
        ts.opt = self.tx.step(params, torch.autograd.grad(loss, params), ts.opt)
        ts.grad_updates += 1
        pairs = [(ts.target_q, ts.q)] + ([(ts.target_mixer, ts.mixer)] if ts.mixer is not None else [])
        for target, online in pairs:
            if cfg.hard_interval <= 0:
                soft_update(target, online, cfg.tau)
            elif ts.grad_updates % cfg.hard_interval == 0:
                hard_update(target, online)
        return {k: v.detach() for k, v in aux.items()}

    def _train_once(self, ts: QMixState, buffer: ReplayBuffer, generator: torch.Generator):
        return self._update_once(ts, buffer.sample(generator, self.cfg.batch_size))
