"""Recurrent QMIX and VDN: a GRU agent Q network over whole episodes.

Counterpart of ``gym_formation_tpu/algos/rqmix.py``, on the chassis of
:class:`~gym_formation_tpu_torch.algos.rmaddpg.Episodic`: one GRU Q network
shared by every agent (the JAX package's ``RecurrentQNet``, which is the
tree of :class:`~gym_formation_tpu_torch.models.networks.GRUPolicy` with
its logits head, over ``obs ⊕ one-hot agent id``), ε-greedy collection on a
linear schedule, and the agents' chosen Q's mixed into ``Q_tot`` step by
step by :class:`~gym_formation_tpu_torch.models.networks.QMixer`
(``mixer="qmix"``) or by their sum (``"vdn"``).  The TD target takes double
Q (the online network picks, the target evaluates), agent 0's reward (the
shared one), the last step's bootstrap masked, and soft targets after every
update.  The Q network and the mixer share one Adam with a global-norm clip
at 10.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..env import FormationEnv
from ..models.networks import GRUPolicy, gru_policy_from_flax
from .maddpg import soft_update
from .qmix import Mixing, QMixState
from .rmaddpg import Episodic


@dataclasses.dataclass(frozen=True)
class RQMixConfig:
    """The JAX package's fields and defaults; see
    ``gym_formation_tpu/algos/rqmix.py:RQMixConfig``."""

    mixer: str = "qmix"  # 'qmix' | 'vdn'
    lr: float = 5e-4
    gamma: float = 0.99
    tau: float = 0.005
    buffer_episodes: int = 4096
    batch_episodes: int = 32
    gru_hidden: int = 64
    mixer_embed: int = 32
    eps_start: float = 1.0
    eps_finish: float = 0.05
    eps_anneal_steps: int = 50_000
    double_q: bool = True
    episodes_per_iter: int = 8
    updates_per_iter: int = 4


class RQMix(Mixing, Episodic):
    """Recurrent QMIX and VDN (``cfg.mixer``).  The training state is
    :class:`~gym_formation_tpu_torch.algos.qmix.QMixState`, the JAX
    package's ``RQMixState`` field for field."""

    q_from_flax = staticmethod(gru_policy_from_flax)

    def __init__(self, env: FormationEnv, cfg: RQMixConfig = RQMixConfig(), num_envs: int = 8,
                 device="cuda", dtype: torch.dtype = torch.float32):
        super().__init__(env, cfg, num_envs, device, dtype)

    def _networks(self, generator: Optional[torch.Generator] = None) -> Dict[str, Optional[torch.nn.Module]]:
        q = GRUPolicy(self.obs_dim + self.n_agents, self.N_ACTIONS, self.cfg.gru_hidden, discrete=True,
                      generator=generator)
        return {"q": q, "mixer": self._mixer(generator)}

    # -- acting -------------------------------------------------------------
    def _q_step(self, q: torch.nn.Module, carry: torch.Tensor, obs: torch.Tensor,
                reset: Optional[torch.Tensor] = None):
        """carry [.., N, H], obs [.., N, do], reset [..] (None: no episode
        starts) → (carry, Q [.., N, A]) of the shared network on ``obs ⊕
        one-hot agent id``."""
        reset_n = None if reset is None else reset[..., None].expand(obs.shape[:-1])
        return q(carry, self._with_ids(obs), reset_n)

    def _q_rollout(self, q: torch.nn.Module, obs_seq: torch.Tensor) -> torch.Tensor:
        """Q over episodes [M, T', N, do] → [M, T', N, A]."""
        return self._scan(lambda h, o: self._q_step(q, h, o), obs_seq)

    def _episode_draws(self, generator: torch.Generator, B: int) -> Dict[str, torch.Tensor]:
        """``uniform`` [B, T, N] (against ε) and ``rand`` [B, T, N] (the
        random actions)."""
        shape = (B, self.T, self.n_agents)
        return {"uniform": torch.rand(shape, generator=generator, dtype=self.dtype, device=self.device),
                "rand": torch.randint(0, self.N_ACTIONS, shape, generator=generator, device=self.device)}

    def _act(self, ts: QMixState, carry, obs, draws):
        """ε-greedy over Q (ε of the env steps before this collection), as
        one-hots."""
        carry, q = self._q_step(ts.q, carry, obs.to(self.dtype))
        pick = torch.where(draws["uniform"] < self.epsilon(ts), draws["rand"], q.argmax(-1))
        return carry, torch.nn.functional.one_hot(pick, self.N_ACTIONS).to(self.dtype)

    def _iteration_metrics(self, ts: QMixState, buffer) -> Dict:
        return {"epsilon": self.epsilon(ts), "buffer_episodes": buffer.size}

    # -- the update ---------------------------------------------------------
    def _loss(self, ts: QMixState, batch: Dict[str, torch.Tensor]):
        """The mean squared TD error of ``Q_tot`` over a batch of M episodes;
        the target (double Q, agent 0's reward, the last step masked)
        carries no gradient."""
        cfg = self.cfg
        obs = batch["obs"]
        M, T, N = batch["action"].shape[:3]
        chosen = lambda q, idx: q.gather(-1, idx[..., None]).squeeze(-1)
        state = lambda o: o.reshape(M * T, -1)
        q_all = self._q_rollout(ts.q, obs)  # [M, T+1, N, A]
        q_chosen = chosen(q_all[:, :-1], batch["action"].argmax(-1)).reshape(M * T, N)
        q_tot = self._mix(ts.mixer, q_chosen, state(obs[:, :-1])).reshape(M, T)
        with torch.no_grad():
            q_next_target = self._q_rollout(ts.target_q, obs)[:, 1:]
            sel = (q_all[:, 1:] if cfg.double_q else q_next_target).argmax(-1)
            q_tot_next = self._mix(ts.target_mixer, chosen(q_next_target, sel).reshape(M * T, N),
                                   state(obs[:, 1:])).reshape(M, T)
            y = batch["reward"][..., 0] + cfg.gamma * q_tot_next * self._nonterm(T)[:, 0]
        loss = ((y - q_tot) ** 2).mean()
        return loss, {"q_loss": loss, "q_tot": q_tot.mean()}

    def _update_once(self, ts: QMixState, batch: Dict[str, torch.Tensor],
                     draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """One update of the Q network and the mixer, then the soft targets
        (``draws`` unused: the update draws nothing)."""
        loss, aux = self._loss(ts, batch)
        params = self._params(ts.q, ts.mixer)
        ts.opt = self.tx.step(params, torch.autograd.grad(loss, params), ts.opt)
        ts.grad_updates += 1
        soft_update(ts.target_q, ts.q, self.cfg.tau)
        if ts.mixer is not None:
            soft_update(ts.target_mixer, ts.mixer, self.cfg.tau)
        return {k: v.detach() for k, v in aux.items()}
