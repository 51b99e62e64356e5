"""RMADDPG and RMATD3: per-agent GRU actors trained off-policy from a buffer
of whole episodes.

Counterpart of ``gym_formation_tpu/algos/rmaddpg.py``: every agent has its
own GRU actor (one stacked network, as the JAX package's ``vmap`` of
``GRUPolicy``) and its own centralized MLP Q critic, twin with ``twin=True``
(RMATD3: the minimum of the twin targets and clipped target smoothing; the
actor moves on every update, as the JAX package's has no policy delay).

This module also holds the chassis of the recurrent off-policy learners
(RMASAC and RQMix build on it, as the JAX package's import the buffer from
its ``rmaddpg.py``):

- :class:`EpisodeBuffer`, an episode-major ring on the learner's device;
- :class:`Episodic`, the training tuple ``(ts, buffer)`` and its iteration:
  ``episodes_per_iter`` collections, each of ``num_envs`` fresh episodes of
  ``world_length`` steps from a zero hidden state, then ``updates_per_iter``
  updates on sampled batches of whole episodes once the buffer holds
  ``batch_episodes``; and the checkpoint of the whole tuple.

Draws come in as tensors, as in the feed-forward zoo: a collection takes its
exploration draws for every step, ``_update_once(ts, batch, draws)`` its
noise, and ``_episode_draws``/``_update_draws`` make them from the
generator.  A stored episode's last observation ``obs[:, T]`` is the true
terminal observation (the env's ``terminal_obs``); the JAX package stores
the next episode's first one, its auto-reset having acted.  Every loss
masks the last step's bootstrap by default, so the two agree on every
default result.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..env import FormationEnv, benchmark_means
from ..models.networks import (
    StackedGRUPolicy,
    StackedQCritic,
    StackedTwinQCritic,
    q_critic_from_flax,
    stacked_gru_policy_from_flax,
    twin_q_critic_from_flax,
)
from .maddpg import ReplayBuffer, ReplayLearner, _state_tree, soft_update
from .optim import AdamState, ClipAdam


@dataclasses.dataclass(frozen=True)
class RMADDPGConfig:
    """The JAX package's fields and defaults; see
    ``gym_formation_tpu/algos/rmaddpg.py:RMADDPGConfig``."""

    lr_actor: float = 1e-4
    lr_critic: float = 1e-3
    gamma: float = 0.95
    tau: float = 0.01
    buffer_episodes: int = 4096
    batch_episodes: int = 32
    gru_hidden: int = 64
    critic_hidden: Tuple[int, ...] = (64, 64, 64)
    high_action: float = 1.0
    noise_rate: float = 0.1
    explore_min: float = 0.05
    explore_decay: float = 5e-6
    mask_done: bool = True  # the last step of an episode bootstraps to 0
    episodes_per_iter: int = 8  # collections of num_envs episodes a train_step
    updates_per_iter: int = 4
    twin: bool = False  # True: RMATD3
    target_noise: float = 0.2
    target_noise_clip: float = 0.5


class EpisodeBuffer(ReplayBuffer):
    """A ring of ``cap`` whole episodes of ``T`` steps on ``device``:
    ``obs`` [cap, T+1, N, do] (the first observation to the terminal one),
    ``action`` [cap, T, N, da], ``reward`` [cap, T, N].  ``ptr`` and
    ``size`` count episodes and are Python ints."""

    _rows = _tensors = ("obs", "action", "reward")

    def __init__(self, cap: int, T: int, n_agents: int, obs_dim: int, act_dim: int, device=None,
                 dtype: torch.dtype = torch.float32):
        self.cap = cap
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        self.obs = z(cap, T + 1, n_agents, obs_dim)
        self.action = z(cap, T, n_agents, act_dim)
        self.reward = z(cap, T, n_agents)
        self.ptr = 0
        self.size = 0


class Episodic(ReplayLearner):
    """The chassis of the recurrent off-policy learners.  A learner adds, to
    :class:`ReplayLearner`'s, one collection step (``_act`` on the draws of
    ``_episode_draws``), what changes after a collection
    (``_after_collection``), and one update (``_update_once`` on the draws
    of ``_update_draws``)."""

    def __init__(self, env: FormationEnv, cfg, num_envs: int, device, dtype: torch.dtype):
        super().__init__(env, cfg, num_envs, device, dtype)
        self.T = env.world_length

    def _buffer(self) -> EpisodeBuffer:
        return EpisodeBuffer(self.cfg.buffer_episodes, self.T, self.n_agents, self.obs_dim, self.act_dim,
                             self.device, self.dtype)

    def init(self, generator: torch.Generator):
        """Random networks, the training state and an empty buffer.  Returns
        ``(ts, buffer)``."""
        return self._init_state(generator), self._buffer()

    def _hidden(self, batch: int) -> torch.Tensor:
        return torch.zeros(batch, self.n_agents, self.cfg.gru_hidden, dtype=self.dtype, device=self.device)

    def _scan(self, step, obs_seq: torch.Tensor, *xs: torch.Tensor):
        """``step(carry, obs_t, *x_t) -> (carry, out)`` over the episodes
        ``obs_seq`` [M, T', N, do] (and the per-step inputs ``xs``, [M, T',
        ...] each) from a zero carry, as the first step's reset leaves it:
        the outputs stacked on axis 1."""
        h, outs = self._hidden(obs_seq.shape[0]), []
        for t in range(obs_seq.shape[1]):
            h, out = step(h, obs_seq[:, t], *(x[:, t] for x in xs))
            outs.append(out)
        if isinstance(outs[0], tuple):
            return tuple(torch.stack(o, 1) for o in zip(*outs))
        return torch.stack(outs, 1)

    def _nonterm(self, T: int, mask: bool = True):
        """[T, 1]: 1, and 0 at an episode's last step when ``mask``."""
        if not mask:
            return 1.0
        return (torch.arange(T, device=self.device) < T - 1).to(self.dtype)[:, None]

    # -- the iteration ------------------------------------------------------
    def _episode_draws(self, generator: torch.Generator, B: int) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def _act(self, ts, carry: torch.Tensor, obs: torch.Tensor, draws: Dict[str, torch.Tensor]):
        raise NotImplementedError

    def _after_collection(self, ts) -> None:
        """What changes once a collection (RMADDPG: the noise decay)."""

    def _iteration_metrics(self, ts, buffer: EpisodeBuffer) -> Dict:
        return {"buffer_episodes": buffer.size}

    def _collect_episodes(self, ts, env_state, obs: torch.Tensor, draws: Dict[str, torch.Tensor],
                          generator: torch.Generator):
        """``T`` steps of the fresh episodes ``(env_state, obs)`` from a zero
        hidden state, step t on the draws ``[:, t]``.  Returns the episodes
        (``obs`` [B, T+1, N, do], the last the terminal observation,
        ``action`` [B, T, N, da], ``reward`` [B, T, N]), the step reward
        means and the benchmark means."""
        h = self._hidden(obs.shape[0])
        obs_seq, acts, rews, rewards, bench = [obs], [], [], [], []
        for t in range(self.T):
            h, action = self._act(ts, h, obs, {k: v[:, t] for k, v in draws.items()})
            env_state, out = self.env.step(env_state, action, generator)
            obs = out.info.get("terminal_obs", out.obs)  # no episode ends before step T
            obs_seq.append(obs)
            acts.append(action)
            rews.append(out.reward)
            rewards.append(out.reward.mean())
            bench.append(benchmark_means(out.info))
        return (torch.stack(obs_seq, 1), torch.stack(acts, 1), torch.stack(rews, 1)), rewards, bench

    def _collect(self, ts, buffer: EpisodeBuffer, generator: torch.Generator):
        """One collection of ``num_envs`` fresh episodes into ``buffer``.
        Returns the step reward means and the benchmark means."""
        B = self.num_envs
        env_state, obs = self.env.reset(generator, B)
        episodes, rewards, bench = self._collect_episodes(ts, env_state, obs, self._episode_draws(generator, B),
                                                          generator)
        buffer.insert(*episodes)
        ts.env_steps += B * self.T
        self._after_collection(ts)
        return rewards, bench

    def _update_draws(self, generator: torch.Generator, M: int) -> Dict[str, torch.Tensor]:
        return {}

    def _train_once(self, ts, buffer: EpisodeBuffer, generator: torch.Generator):
        M = self.cfg.batch_episodes
        return self._update_once(ts, buffer.sample(generator, M), self._update_draws(generator, M))

    def train_step(self, ts, buffer: EpisodeBuffer, generator: torch.Generator):
        """One iteration: ``episodes_per_iter`` collections into the buffer,
        then ``updates_per_iter`` updates once it holds ``batch_episodes``
        episodes (zero losses before).  ``generator`` draws the episodes,
        the exploration, the batches and the updates' noise.  Returns
        ``(ts, buffer, metrics)``, the metrics as 0-dim tensors on the
        device or numbers."""
        rewards: List[torch.Tensor] = []
        bench: List[Dict] = []
        with torch.no_grad():
            for _ in range(self.cfg.episodes_per_iter):
                r, b = self._collect(ts, buffer, generator)
                rewards += r
                bench += b
        ms = []
        if buffer.size >= self.cfg.batch_episodes:
            ms = [self._train_once(ts, buffer, generator) for _ in range(self.cfg.updates_per_iter)]
        metrics = self._metrics(ms, rewards, bench)
        metrics.update(self._iteration_metrics(ts, buffer))
        return ts, buffer, metrics

    # -- checkpoints --------------------------------------------------------
    def checkpoint_tree(self, ts, buffer: EpisodeBuffer, generator: torch.Generator) -> Dict:
        """The whole training tuple (networks, targets, Adam states,
        counters, the buffer, the generator's state) for
        :func:`~gym_formation_tpu_torch.utils.checkpoint.save_checkpoint`."""
        return {"config": dataclasses.asdict(self.cfg), "state": _state_tree(ts), "buffer": buffer.state_dict(),
                "generator": generator.get_state()}

    def restore_tree(self, tree: Dict, generator: torch.Generator):
        """Inverse of :meth:`checkpoint_tree` into fresh objects: returns
        ``(ts, buffer)`` and sets the generator's state."""
        ts = self.state_from_tree(tree)
        buffer = self._buffer()
        buffer.load_state_dict(tree["buffer"])
        generator.set_state(tree["generator"])
        return ts, buffer


def grads_of(loss: torch.Tensor, params: List[torch.Tensor]) -> List[torch.Tensor]:
    """``d loss / d params``, zeros for a parameter the loss does not use
    (the stacked GRU actor's ``log_std``: JAX's gradient of it is 0)."""
    return list(torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True))


@dataclasses.dataclass
class RMADDPGState:
    actor: torch.nn.Module  # stacked over the agents
    critic: torch.nn.Module
    target_actor: torch.nn.Module
    target_critic: torch.nn.Module
    actor_opt: AdamState
    critic_opt: AdamState
    noise: float
    env_steps: int
    grad_updates: int


class RMADDPG(Episodic):
    """RMADDPG, or RMATD3 with ``twin=True``."""

    loss_keys = ("critic_loss", "actor_loss")

    def __init__(self, env: FormationEnv, cfg: RMADDPGConfig = RMADDPGConfig(), num_envs: int = 8,
                 device="cuda", dtype: torch.dtype = torch.float32):
        super().__init__(env, cfg, num_envs, device, dtype)
        self.actor_tx = ClipAdam(cfg.lr_actor)
        self.critic_tx = ClipAdam(cfg.lr_critic)

    # -- setup --------------------------------------------------------------
    def _networks(self, generator: Optional[torch.Generator] = None) -> Dict[str, torch.nn.Module]:
        cfg, N, do, da = self.cfg, self.n_agents, self.obs_dim, self.act_dim
        critic_cls = StackedTwinQCritic if cfg.twin else StackedQCritic
        return {"actor": StackedGRUPolicy(N, do, da, cfg.gru_hidden, generator),
                "critic": critic_cls(N, N * (do + da), cfg.high_action, cfg.critic_hidden, generator)}

    def init_state(self, actor: torch.nn.Module, critic: torch.nn.Module,
                   target_actor: Optional[torch.nn.Module] = None,
                   target_critic: Optional[torch.nn.Module] = None) -> RMADDPGState:
        """A fresh training state around the given networks (targets: copies
        unless given), Adam at step 0, the noise at ``noise_rate``."""
        actor, critic = self._to(actor), self._to(critic)
        return RMADDPGState(
            actor=actor, critic=critic,
            target_actor=self._target(actor, target_actor), target_critic=self._target(critic, target_critic),
            actor_opt=self.actor_tx.init(list(actor.parameters())),
            critic_opt=self.critic_tx.init(list(critic.parameters())),
            noise=self.cfg.noise_rate, env_steps=0, grad_updates=0,
        )

    def state_from_flax(self, params: Dict) -> RMADDPGState:
        """A fresh training state holding the JAX package's stacked trees
        ``{'actor', 'critic'[, 'target_actor', 'target_critic']}``."""
        critic_from_flax = twin_q_critic_from_flax if self.cfg.twin else q_critic_from_flax
        actor_fn = lambda t: stacked_gru_policy_from_flax(t, self.dtype)
        critic_fn = lambda t: critic_from_flax(t, self.cfg.high_action, self.dtype)
        opt = lambda k, fn: fn(params[k]) if k in params else None
        return self.init_state(actor_fn(params["actor"]), critic_fn(params["critic"]),
                               opt("target_actor", actor_fn), opt("target_critic", critic_fn))

    # -- the actors ---------------------------------------------------------
    def _actor_step(self, actor: torch.nn.Module, carry: torch.Tensor, obs: torch.Tensor,
                    reset: Optional[torch.Tensor] = None):
        """carry [.., N, H], obs [.., N, do], reset [..] (None: no episode
        starts) → (carry, ``tanh(mean) · high_action``)."""
        reset_n = None if reset is None else reset[..., None].expand(obs.shape[:-1])
        carry, (mean, _) = actor(carry, obs, reset_n)
        return carry, torch.tanh(mean) * self.cfg.high_action

    def _actor_rollout(self, actor: torch.nn.Module, obs_seq: torch.Tensor) -> torch.Tensor:
        """The stacked actors over episodes [M, T', N, do] → [M, T', N, da]."""
        return self._scan(lambda h, o: self._actor_step(actor, h, o), obs_seq)

    @torch.no_grad()
    def eval_actions_episode(self, ts: RMADDPGState, obs_seq: torch.Tensor) -> torch.Tensor:
        """Greedy recurrent actions over episodes [B, T, N, do]."""
        return self._actor_rollout(ts.actor, obs_seq.to(self.dtype))

    # -- exploration --------------------------------------------------------
    def _episode_draws(self, generator: torch.Generator, B: int) -> Dict[str, torch.Tensor]:
        """The action noise's standard normals [B, T, N, da]."""
        shape = (B, self.T, self.n_agents, self.act_dim)
        return {"normal": torch.randn(shape, generator=generator, dtype=self.dtype, device=self.device)}

    def _act(self, ts: RMADDPGState, carry, obs, draws):
        """The actors' actions plus ``noise · high_action · normal``,
        clipped to ±high_action."""
        high = self.cfg.high_action
        carry, a = self._actor_step(ts.actor, carry, obs.to(self.dtype))
        return carry, torch.clamp(a + ts.noise * high * draws["normal"], -high, high)

    def _after_collection(self, ts: RMADDPGState) -> None:
        cfg = self.cfg
        ts.noise = max(cfg.explore_min, ts.noise - cfg.explore_decay * self.num_envs * self.T)

    # -- losses and the update ----------------------------------------------
    def _q(self, critic: torch.nn.Module, o: torch.Tensor, u: torch.Tensor):
        """``(q1, q2)`` of a twin critic, ``(q, q)`` of a single one."""
        q = critic(o, u)
        return q if self.cfg.twin else (q, q)

    def _losses(self, ts: RMADDPGState, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor]):
        """Per-agent losses [N] over a batch of M episodes: agent i's critic,
        the mean squared error (each twin's, summed) to ``r_i + γ Q'_i(o',
        u')`` with the last step's bootstrap masked under ``mask_done``, and
        its actor, ``−Q_i`` with its own action sequence re-chosen.  The
        target actions ``u'`` come from the target actors rolled over the
        whole ``T+1``-step episode and sliced, so that their hidden state at
        step t+1 has seen ``obs_0 .. obs_t+1``; RMATD3 adds the smoothing
        noise ``draws['target_noise']`` [M, T, N, da].  The target carries
        no gradient."""
        cfg = self.cfg
        obs, act = batch["obs"], batch["action"]
        M, T, N = act.shape[:3]
        flat = lambda x: x.reshape(M * T, N, -1)
        o_in, u_flat = self._joint(flat(obs[:, :-1])), flat(act)
        with torch.no_grad():
            u_next = self._actor_rollout(ts.target_actor, obs)[:, 1:]
            if cfg.twin:
                noise = torch.clamp(cfg.target_noise * draws["target_noise"], -cfg.target_noise_clip,
                                    cfg.target_noise_clip)
                u_next = torch.clamp(u_next + noise, -cfg.high_action, cfg.high_action)
            q1n, q2n = self._q(ts.target_critic, self._joint(flat(obs[:, 1:])), self._joint(flat(u_next)))
            q_next = (torch.minimum(q1n, q2n) if cfg.twin else q1n).reshape(M, T, N)
            target = (batch["reward"] + cfg.gamma * q_next * self._nonterm(T, cfg.mask_done)).reshape(M * T, N)
        q1, q2 = self._q(ts.critic, o_in, self._joint(u_flat))
        critic_loss = ((target - q1) ** 2).mean(0)
        if cfg.twin:
            critic_loss = critic_loss + ((target - q2) ** 2).mean(0)
        u_new = self._actor_rollout(ts.actor, obs[:, :-1])
        qp, _ = self._q(ts.critic, o_in, self._substitute(u_flat, flat(u_new)))
        return critic_loss, -qp.mean(0)

    def _update_draws(self, generator: torch.Generator, M: int) -> Dict[str, torch.Tensor]:
        """RMATD3's smoothing normals [M, T, N, da] (none for RMADDPG)."""
        if not self.cfg.twin:
            return {}
        shape = (M, self.T, self.n_agents, self.act_dim)
        return {"target_noise": torch.randn(shape, generator=generator, dtype=self.dtype, device=self.device)}

    def _update_once(self, ts: RMADDPGState, batch: Dict[str, torch.Tensor],
                     draws: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update of every agent: the critics from their loss and the
        actors from theirs (the critics held fixed), both gradients taken
        before either network moves, then both soft targets."""
        critic_loss, actor_loss = self._losses(ts, batch, draws)
        c_params, a_params = list(ts.critic.parameters()), list(ts.actor.parameters())
        g_c = torch.autograd.grad(critic_loss.sum(), c_params)
        g_a = grads_of(actor_loss.sum(), a_params)
        ts.critic_opt = self.critic_tx.step(c_params, g_c, ts.critic_opt)
        ts.actor_opt = self.actor_tx.step(a_params, g_a, ts.actor_opt)
        soft_update(ts.target_actor, ts.actor, self.cfg.tau)
        soft_update(ts.target_critic, ts.critic, self.cfg.tau)
        ts.grad_updates += 1
        return {"critic_loss": critic_loss.detach().mean(), "actor_loss": actor_loss.detach().mean()}
