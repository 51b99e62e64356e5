"""MADDPG (and DDPG): per-agent deterministic actors and Q critics, trained
off-policy from a replay buffer on the card.

Counterpart of ``gym_formation_tpu/algos/maddpg.py``.  Every agent has its
own actor and critic, held as one stacked network each (leading agent axis,
one batched product a layer), so that an update trains all agents at once.
A centralized critic sees every agent's observations and actions (MADDPG);
``centralized=False`` gives each agent a local critic ``Q(o_i, u_i)``
(DDPG).  A discrete env gets logits actors: exploration takes a Gumbel-max
sample and the actor loss a straight-through Gumbel-softmax.

This module also holds what the feed-forward off-policy learners share
(MATD3, MASAC and QMix build on it, as the JAX package's import the
buffer from its ``maddpg.py``):

- :class:`ReplayBuffer`, a ring of transitions on the learner's device;
- :class:`ReplayLearner`, what every off-policy learner shares, the
  recurrent ones of ``rmaddpg.py`` too: networks from a seed, targets,
  the state in and out of a checkpoint, the joint critic input;
- :class:`OffPolicy`, the training tuple ``(ts, buffer, env_state, obs)``
  and its iteration: ``steps_per_iter`` vectorised env steps into the
  buffer, then ``updates_per_iter`` sampled updates once the buffer holds a
  batch; and the checkpoint of the whole tuple, buffer included.

Under a data-parallel mesh (the env's ``mesh``) each rank steps its
``num_envs / W`` envs with the exploration's draws made at the global shape,
and every env step's transitions are gathered, so that every rank inserts
the whole global batch into its own ring: the buffers, the sampled batches,
the updates' draws and so the parameters are the same on every rank, and
the single process's.  The JAX package shards the ring over its capacity
instead; the results are the same.

Where the JAX package passes PRNG keys, the port splits drawing from using:
``_update_once(ts, batch, draws)`` takes the Gumbel noise (and MATD3's and
MASAC's normal draws) as tensors, and ``train_step`` draws them from its
generator.  The buffer's pointer and size, the noise and ε decay, the env
step and update counts follow from the number of iterations alone, so they
are Python numbers: deciding whether to train reads no device value.
"""

from __future__ import annotations

import copy
import dataclasses
from functools import partial
from typing import Dict, Optional, Tuple

import torch

from .. import _device
from ..env import FormationEnv, benchmark_means
from ..parallel import mesh as dp
from ..models.networks import (
    StackedActor,
    StackedDeterministicActor,
    StackedQCritic,
    deterministic_actor_from_flax,
    gumbel,
    gumbel_softmax_st,
    onehot_from_logits,
    q_critic_from_flax,
    stacked_actor_from_flax,
)
from .optim import AdamState, ClipAdam


@dataclasses.dataclass(frozen=True)
class MADDPGConfig:
    """The JAX package's fields and defaults (the reference v1 zoo); see
    ``gym_formation_tpu/algos/maddpg.py:MADDPGConfig`` for each one."""

    lr_actor: float = 1e-4
    lr_critic: float = 1e-4
    epsilon: float = 0.1
    noise_rate: float = 0.25
    explore_decay: float = 5e-7
    explore_min: float = 0.05
    ou_noise: bool = False  # Ornstein-Uhlenbeck exploration noise, reset at episode ends
    ou_theta: float = 0.15
    ou_sigma: float = 0.2
    ou_mu: float = 0.0
    gamma: float = 0.95
    tau: float = 0.01
    buffer_size: int = 500_000
    batch_size: int = 256
    hidden: Tuple[int, ...] = (64, 64, 64)
    high_action: float = 1.0
    mask_done: bool = False  # the reference's TD target has no done mask
    use_per: bool = False  # prioritized replay (per.py)
    per_alpha: float = 0.6
    per_beta0: float = 0.4
    per_beta_anneal: int = 100_000
    centralized: bool = True  # False: a local critic Q(o_i, u_i), DDPG
    steps_per_iter: int = 32
    updates_per_iter: int = 32


class ReplayBuffer:
    """A ring of ``cap`` transitions on ``device``: ``obs``, ``next_obs``
    [cap, N, do], ``action`` [cap, N, da], ``reward`` [cap, N], ``done``
    [cap].  A batch of B transitions goes in at the pointer, wrapping at the
    end.  ``ptr`` and ``size`` are Python ints."""

    _rows: Tuple[str, ...] = ("obs", "action", "reward", "next_obs", "done")  # what a row holds
    _tensors: Tuple[str, ...] = _rows  # what a checkpoint holds

    def __init__(self, cap: int, n_agents: int, obs_dim: int, act_dim: int, device=None,
                 dtype: torch.dtype = torch.float32):
        self.cap = cap
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        self.obs, self.next_obs = z(cap, n_agents, obs_dim), z(cap, n_agents, obs_dim)
        self.action = z(cap, n_agents, act_dim)
        self.reward = z(cap, n_agents)
        self.done = torch.zeros(cap, dtype=torch.bool, device=device)
        self.ptr = 0
        self.size = 0

    def _ring_write(self, buf: torch.Tensor, x: torch.Tensor) -> None:
        """``x`` [B, ...] into ``buf`` from the pointer on, wrapping."""
        b = x.shape[0]
        first = min(b, self.cap - self.ptr)
        buf[self.ptr:self.ptr + first] = x[:first]
        if first < b:
            buf[:b - first] = x[first:]

    def insert(self, *rows: torch.Tensor) -> None:
        """A [B, ...] batch of rows at the pointer (B ≤ cap), one tensor for
        each name of ``_rows`` in its order."""
        b = rows[0].shape[0]
        if b > self.cap:
            raise ValueError(f"a batch of {b} rows exceeds the buffer's {self.cap}")
        for name, x in zip(self._rows, rows, strict=True):
            self._ring_write(getattr(self, name), x)
        self.ptr = (self.ptr + b) % self.cap
        self.size = min(self.size + b, self.cap)

    def gather(self, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name)[idx] for name in self._rows}

    def sample(self, generator: torch.Generator, batch_size: int) -> Dict[str, torch.Tensor]:
        """``batch_size`` transitions drawn uniformly, with replacement."""
        idx = torch.randint(0, max(self.size, 1), (batch_size,), generator=generator, device=self.obs.device)
        return self.gather(idx)

    def state_dict(self) -> Dict:
        return {**{k: getattr(self, k) for k in self._tensors}, "ptr": self.ptr, "size": self.size}

    def load_state_dict(self, tree: Dict) -> None:
        for k in self._tensors:
            setattr(self, k, tree[k].to(self.obs.device))
        self.ptr, self.size = int(tree["ptr"]), int(tree["size"])


def soft_update(target: torch.nn.Module, source: torch.nn.Module, tau: float) -> None:
    """``target ← (1 − tau) · target + tau · source``, parameter by parameter."""
    with torch.no_grad():
        t = list(target.parameters())
        torch._foreach_mul_(t, 1.0 - tau)
        torch._foreach_add_(t, list(source.parameters()), alpha=tau)


def hard_update(target: torch.nn.Module, source: torch.nn.Module) -> None:
    with torch.no_grad():
        torch._foreach_copy_(list(target.parameters()), list(source.parameters()))


def _state_tree(ts) -> Dict:
    """A learner state dataclass as a tree of tensors and numbers."""
    out = {}
    for f in dataclasses.fields(ts):
        v = getattr(ts, f.name)
        if isinstance(v, torch.nn.Module):
            v = v.state_dict()
        elif isinstance(v, AdamState):
            v = v._asdict()
        elif isinstance(v, torch.Tensor):
            v = v.detach()
        out[f.name] = v
    return out


def _load_state(ts, tree: Dict, device) -> None:
    """Inverse of :func:`_state_tree` into the fields of a fresh ``ts``."""
    for f in dataclasses.fields(ts):
        cur, saved = getattr(ts, f.name), tree[f.name]
        if isinstance(cur, torch.nn.Module):
            cur.load_state_dict(saved)
        elif isinstance(cur, AdamState):
            setattr(ts, f.name, AdamState(mu=[t.to(device) for t in saved["mu"]],
                                          nu=[t.to(device) for t in saved["nu"]], count=int(saved["count"])))
        elif isinstance(cur, torch.nn.Parameter):
            with torch.no_grad():
                cur.copy_(saved)
        elif isinstance(cur, torch.Tensor):
            setattr(ts, f.name, saved.to(device))
        else:
            setattr(ts, f.name, saved)


class ReplayLearner:
    """What the off-policy chassis share (:class:`OffPolicy`, step-wise, and
    ``rmaddpg.Episodic``, whole episodes): a batch of ``num_envs``
    :class:`FormationEnv` envs on ``device`` (the card unless
    ``device="cpu"`` is given), parameters in ``dtype``, networks drawn from
    a seed of the caller's generator, target copies, and the training state
    in and out of a checkpoint.  A learner defines its networks
    (``_networks``, ``init_state``) and the names of its loss metrics
    (``loss_keys``).  Its state is mutable: ``train_step`` updates it in
    place and returns it.  Under the env's data-parallel mesh ``num_envs``
    is the global batch, and :attr:`num_envs` this rank's share."""

    loss_keys: Tuple[str, ...] = ()

    def __init__(self, env: FormationEnv, cfg, num_envs: int, device, dtype: torch.dtype):
        self.env = env
        self.cfg = cfg
        self.mesh = env.mesh
        self.global_envs = num_envs
        self.num_envs = dp.per_rank(num_envs, self.mesh)
        self.device = _device.resolve(device)
        self.dtype = dtype
        self.n_agents = env.num_agents
        self.obs_dim = env.scenario.obs_dim
        self.act_dim = env.act_dim
        # a discrete env takes one-hots; the index input stays continuous
        self.discrete = bool(env.discrete_action and not env.discrete_action_input)

    # -- setup --------------------------------------------------------------
    def _networks(self, generator: Optional[torch.Generator] = None) -> Dict[str, torch.nn.Module]:
        raise NotImplementedError

    def init_state(self, **networks):
        raise NotImplementedError

    def _to(self, module: torch.nn.Module) -> torch.nn.Module:
        return module.to(device=self.device, dtype=self.dtype)

    def _target(self, online: torch.nn.Module, given: Optional[torch.nn.Module]) -> torch.nn.Module:
        """A target network: ``given``, or a copy of ``online``."""
        target = self._to(given) if given is not None else copy.deepcopy(online)
        return target.requires_grad_(False)

    def _init_state(self, generator: torch.Generator):
        """A training state around random networks, their init drawn from a
        CPU generator seeded from ``generator``."""
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator, device=generator.device))
        g = torch.Generator()
        g.manual_seed(seed)
        return self.init_state(**self._networks(g))

    def state_from_tree(self, tree: Dict):
        """The training state of a checkpoint tree (``tree['state']``), on
        the learner's device."""
        ts = self.init_state(**self._networks())
        _load_state(ts, tree["state"], self.device)
        return ts

    def _metrics(self, ms, rewards, bench) -> Dict:
        """An iteration's metrics: each of ``loss_keys`` averaged over the
        updates' ``ms`` (0 where none ran), ``mean_step_reward`` over the
        reward means ``rewards``, and the benchmark means ``bench``."""
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        metrics = {k: torch.stack([m[k] for m in ms]).mean() if ms else zero for k in self.loss_keys}
        envs = {"mean_step_reward": torch.stack(rewards).mean()}
        envs.update({k: torch.stack([b[k] for b in bench]).mean() for k in (bench[0] if bench else {})})
        metrics.update(dp.rank_mean(envs, self.mesh))  # the rank's envs → the global batch's
        return metrics

    def _joint(self, x: torch.Tensor) -> torch.Tensor:
        """[M, N, d] → each agent's critic input [M, N, N·d]: every agent's
        row is the joint one."""
        M = x.shape[0]
        return x.reshape(M, 1, -1).expand(M, self.n_agents, -1)

    def _substitute(self, action: torch.Tensor, own: torch.Tensor) -> torch.Tensor:
        """Agent i's row of the joint action [M, N, N·da]: the batch's
        ``action`` with agent i's own replaced by ``own[:, i]``."""
        M, N = action.shape[:2]
        eye = torch.eye(N, dtype=torch.bool, device=action.device)[:, :, None]
        return torch.where(eye, own[:, None], action[:, None]).reshape(M, N, -1)


class OffPolicy(ReplayLearner):
    """The chassis of the feed-forward off-policy learners: a learner adds
    its exploration (``explore_actions``) and one update from the buffer
    (``_train_once``) to :class:`ReplayLearner`'s."""

    def _buffer(self) -> ReplayBuffer:
        return ReplayBuffer(self.cfg.buffer_size, self.n_agents, self.obs_dim, self.act_dim, self.device, self.dtype)

    def init(self, generator: torch.Generator):
        """Random networks, the training state, an empty buffer and the first
        episodes.  Returns ``(ts, buffer, env_state, obs)``."""
        ts = self._init_state(generator)
        env_state, obs = self.env.reset(generator, self.num_envs)
        return ts, self._buffer(), env_state, obs

    # -- the iteration ------------------------------------------------------
    def _after_env_step(self, ts, out) -> None:
        """Per-step bookkeeping of the exploration (MADDPG: decay, OU reset)."""

    def _iteration_metrics(self, ts, buffer: ReplayBuffer) -> Dict:
        return {"buffer_size": buffer.size}

    def _collect(self, ts, buffer: ReplayBuffer, env_state, obs, generator: torch.Generator):
        """``steps_per_iter`` env steps into ``buffer``; each transition's
        ``next_obs`` is the step's true observation (``terminal_obs``), not
        the next episode's first one.  Returns ``(env_state, obs, step
        reward means, benchmark means)``."""
        rewards, bench = [], []
        for _ in range(self.cfg.steps_per_iter):
            actions = self.explore_actions(ts, obs, generator)
            env_state, out = self.env.step(env_state, actions, generator)
            self._after_env_step(ts, out)
            rows = (obs, actions, out.reward, out.info.get("terminal_obs", out.obs), out.done[:, 0])
            buffer.insert(*dp.gather_rows(rows, self.mesh))  # every rank's envs into every rank's ring
            ts.env_steps += self.global_envs
            rewards.append(out.reward.mean())
            bench.append(benchmark_means(out.info))
            obs = out.obs
        return env_state, obs, rewards, bench

    def train_step(self, ts, buffer: ReplayBuffer, env_state, obs, generator: torch.Generator):
        """One iteration: collect into the buffer, then ``updates_per_iter``
        updates once it holds ``batch_size`` transitions (zero losses
        before).  ``generator`` draws the exploration, the env's resets,
        the batches and the updates' noise.  Returns ``(ts, buffer,
        env_state, obs, metrics)``, the metrics as 0-dim tensors on the
        device or numbers."""
        with torch.no_grad():
            env_state, obs, rewards, bench = self._collect(ts, buffer, env_state, obs, generator)
        ms = []
        if buffer.size >= self.cfg.batch_size:
            ms = [self._train_once(ts, buffer, generator) for _ in range(self.cfg.updates_per_iter)]
        metrics = self._metrics(ms, rewards, bench)
        metrics.update(self._iteration_metrics(ts, buffer))
        return ts, buffer, env_state, obs, metrics

    # -- checkpoints --------------------------------------------------------
    def checkpoint_tree(self, ts, buffer: ReplayBuffer, env_state, obs, generator: torch.Generator) -> Dict:
        """The whole training tuple (networks, targets, Adam states,
        counters, the buffer, env state, observations, the generator's
        state) for :func:`~gym_formation_tpu_torch.utils.checkpoint.save_checkpoint`."""
        return {
            "config": dataclasses.asdict(self.cfg),
            "state": _state_tree(ts),
            "buffer": buffer.state_dict(),
            "env_state": dataclasses.asdict(env_state),
            "obs": obs,
            "generator": generator.get_state(),
        }

    def restore_tree(self, tree: Dict, generator: torch.Generator):
        """Inverse of :meth:`checkpoint_tree` into fresh objects: returns
        ``(ts, buffer, env_state, obs)`` and sets the generator's state."""
        from ..core.types import EnvState

        ts = self.state_from_tree(tree)
        buffer = self._buffer()
        buffer.load_state_dict(tree["buffer"])
        env_state = EnvState(**{k: v.to(self.device) for k, v in tree["env_state"].items()})
        generator.set_state(tree["generator"])
        return ts, buffer, env_state, tree["obs"].to(self.device)


@dataclasses.dataclass
class MADDPGState:
    actor: torch.nn.Module  # stacked over the agents
    critic: torch.nn.Module
    target_actor: torch.nn.Module
    target_critic: torch.nn.Module
    actor_opt: AdamState
    critic_opt: AdamState
    noise: float
    epsilon: float
    env_steps: int
    grad_updates: int
    ou_state: torch.Tensor  # [B, N, da], the OU process (ou_mu when unused)

    def adam_params(self) -> Dict[str, list]:
        """Each Adam state's field → the parameters its moments follow, in order."""
        return {"actor_opt": list(self.actor.parameters()), "critic_opt": list(self.critic.parameters())}


class MADDPG(OffPolicy):
    """MADDPG, or DDPG with ``centralized=False``."""

    loss_keys = ("critic_loss", "actor_loss")
    critic_cls = StackedQCritic
    critic_from_flax = staticmethod(q_critic_from_flax)

    def __init__(self, env: FormationEnv, cfg: MADDPGConfig = MADDPGConfig(), num_envs: int = 32,
                 device="cuda", dtype: torch.dtype = torch.float32):
        super().__init__(env, cfg, num_envs, device, dtype)
        self.actor_tx = ClipAdam(cfg.lr_actor)
        self.critic_tx = ClipAdam(cfg.lr_critic)

    # -- setup --------------------------------------------------------------
    def _networks(self, generator: Optional[torch.Generator] = None) -> Dict[str, torch.nn.Module]:
        cfg, N, do, da = self.cfg, self.n_agents, self.obs_dim, self.act_dim
        actor = (StackedActor(N, do, da, cfg.hidden, discrete=True, generator=generator) if self.discrete
                 else StackedDeterministicActor(N, do, da, cfg.high_action, cfg.hidden, generator))
        width = (do + da) * (N if cfg.centralized else 1)
        return {"actor": actor, "critic": self.critic_cls(N, width, cfg.high_action, cfg.hidden, generator)}

    def init_state(self, actor: torch.nn.Module, critic: torch.nn.Module,
                   target_actor: Optional[torch.nn.Module] = None,
                   target_critic: Optional[torch.nn.Module] = None) -> MADDPGState:
        """A fresh training state around the given networks (targets: copies
        unless given), Adam at step 0, the exploration at its start."""
        cfg = self.cfg
        actor, critic = self._to(actor), self._to(critic)
        return MADDPGState(
            actor=actor, critic=critic,
            target_actor=self._target(actor, target_actor), target_critic=self._target(critic, target_critic),
            actor_opt=self.actor_tx.init(list(actor.parameters())),
            critic_opt=self.critic_tx.init(list(critic.parameters())),
            noise=cfg.noise_rate, epsilon=cfg.epsilon, env_steps=0, grad_updates=0,
            ou_state=torch.full((self.num_envs, self.n_agents, self.act_dim), cfg.ou_mu, dtype=self.dtype,
                                device=self.device),
        )

    def state_from_flax(self, params: Dict) -> MADDPGState:
        """A fresh training state holding the JAX package's stacked trees
        ``{'actor', 'critic'[, 'target_actor', 'target_critic']}``."""
        high = self.cfg.high_action
        actor_fn = (partial(stacked_actor_from_flax, dtype=self.dtype) if self.discrete
                    else partial(deterministic_actor_from_flax, max_action=high, dtype=self.dtype))
        critic_fn = partial(self.critic_from_flax, max_action=high, dtype=self.dtype)
        opt = lambda k, fn: fn(params[k]) if k in params else None
        return self.init_state(actor_fn(params["actor"]), critic_fn(params["critic"]),
                               opt("target_actor", actor_fn), opt("target_critic", critic_fn))

    def _buffer(self) -> ReplayBuffer:
        if not self.cfg.use_per:
            return super()._buffer()
        from .per import PrioritizedReplayBuffer

        return PrioritizedReplayBuffer(self.cfg.buffer_size, self.n_agents, self.obs_dim, self.act_dim,
                                       self.device, self.dtype)

    # -- exploration --------------------------------------------------------
    def _explore_draws(self, generator: torch.Generator, B: int) -> Dict[str, torch.Tensor]:
        """The draws of one exploration step: Gumbel noise (discrete), or the
        normals of the action noise, the ε-branch's uniform actions in
        ±high_action and its [B, N, 1] uniforms."""
        shape = (B, self.n_agents, self.act_dim)
        kw = dict(generator=generator, dtype=self.dtype, device=self.device)
        if self.discrete:
            return {"gumbel": gumbel(generator, shape, self.dtype, self.device)}
        h = self.cfg.high_action
        return {"normal": torch.randn(shape, **kw), "uniform": torch.rand(shape, **kw) * (2 * h) - h,
                "take": torch.rand((B, self.n_agents, 1), **kw)}

    def _explore(self, ts: MADDPGState, obs: torch.Tensor, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
        """ε-greedy uniform actions against the actor's plus noise (Gaussian,
        or OU with ``ou_noise``, whose state advances), clipped to
        ±high_action; discrete: the Gumbel-max one-hot of the logits."""
        cfg = self.cfg
        pi = ts.actor(obs.to(self.dtype))
        if self.discrete:
            return onehot_from_logits(pi + draws["gumbel"])
        if cfg.ou_noise:
            x = ts.ou_state
            ts.ou_state = x + cfg.ou_theta * (cfg.ou_mu - x) + cfg.ou_sigma * draws["normal"]
            noise_term = ts.noise * ts.ou_state
        else:
            noise_term = ts.noise * cfg.high_action * draws["normal"]
        noisy = torch.clamp(pi + noise_term, -cfg.high_action, cfg.high_action)
        return torch.where(draws["take"] < ts.epsilon, draws["uniform"], noisy)

    @torch.no_grad()
    def explore_actions(self, ts: MADDPGState, obs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        draws = self._explore_draws(generator, obs.shape[0] * dp.size(self.mesh))
        return self._explore(ts, obs, dp.local_rows(draws, self.mesh))

    def _after_env_step(self, ts: MADDPGState, out) -> None:
        cfg = self.cfg
        if cfg.ou_noise:
            ts.ou_state = torch.where(out.done[:, :1, None], cfg.ou_mu, ts.ou_state)
        decay = cfg.explore_decay * self.global_envs
        ts.noise = max(cfg.explore_min, ts.noise - decay)
        ts.epsilon = max(cfg.explore_min, ts.epsilon - decay)

    @torch.no_grad()
    def eval_actions(self, ts: MADDPGState, obs: torch.Tensor) -> torch.Tensor:
        out = ts.actor(obs.to(self.dtype))
        return onehot_from_logits(out) if self.discrete else out

    # -- losses -------------------------------------------------------------
    def _critic_input(self, x: torch.Tensor) -> torch.Tensor:
        return self._joint(x) if self.cfg.centralized else x

    # hooks that MATD3 specializes (twin critics, target smoothing)
    def _target_actions(self, ts, batch, draws):
        out = ts.target_actor(batch["next_obs"])
        return onehot_from_logits(out) if self.discrete else out

    def _q_target(self, ts, o, u):
        return ts.target_critic(o, u)

    def _critic_bellman_err(self, critic, o, u, target):
        """Per-sample squared Bellman error and |TD| (PER's priority)."""
        q = critic(o, u)
        return (target - q) ** 2, (target - q).abs()

    def _q_policy(self, critic, o, u):
        return critic(o, u)

    def _actor_due(self, ts) -> bool:
        return True

    def _losses(self, ts: MADDPGState, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor],
                weights: Optional[torch.Tensor] = None):
        """Per-agent losses [N]: agent i's critic, the (weighted) mean
        squared error to ``r_i + γ Q'_i(o', u'_targets)``, and its actor,
        ``−Q_i`` with its own action re-chosen (the others' from the batch);
        and the per-sample |TD| [M], averaged over the agents.  The target
        carries no gradient."""
        cfg = self.cfg
        obs, act = batch["obs"], batch["action"]
        o_in, u_in = self._critic_input(obs), self._critic_input(act)
        with torch.no_grad():
            u_next = self._target_actions(ts, batch, draws)
            q_next = self._q_target(ts, self._critic_input(batch["next_obs"]), self._critic_input(u_next))
            nonterm = (1.0 - batch["done"].to(q_next.dtype))[:, None] if cfg.mask_done else 1.0
            target = batch["reward"] + cfg.gamma * q_next * nonterm
        sq_err, td_abs = self._critic_bellman_err(ts.critic, o_in, u_in, target)
        w = 1.0 if weights is None else weights[:, None]
        critic_loss = (w * sq_err).mean(0)
        a = ts.actor(obs)
        reg = 0.0
        if self.discrete:
            # the straight-through sample lets ∂Q/∂logits flow; the logits
            # are regularized as the reference v2 does
            reg = 1e-3 * (a ** 2).mean((0, 2))
            a = gumbel_softmax_st(draws["gumbel"], a)
        u_sub = self._substitute(act, a) if cfg.centralized else a
        actor_loss = reg - self._q_policy(ts.critic, o_in, u_sub).mean(0)
        return critic_loss, actor_loss, td_abs.mean(1)

    # -- the update ---------------------------------------------------------
    def _update_draws(self, generator: torch.Generator, M: int) -> Dict[str, torch.Tensor]:
        """The draws of one update: the actor loss's Gumbel noise [M, N, A]
        (discrete)."""
        if not self.discrete:
            return {}
        return {"gumbel": gumbel(generator, (M, self.n_agents, self.act_dim), self.dtype, self.device)}

    def _update_once(self, ts: MADDPGState, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor],
                     weights: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One update of every agent: the critics from their loss, the actors
        from theirs (the critics held fixed), then the soft targets.  Both
        gradients are taken before either network moves.  Returns the mean
        losses and the per-sample |TD|."""
        critic_loss, actor_loss, td_abs = self._losses(ts, batch, draws, weights)
        c_params, a_params = list(ts.critic.parameters()), list(ts.actor.parameters())
        g_c = torch.autograd.grad(critic_loss.sum(), c_params)
        do_actor = self._actor_due(ts)
        if do_actor:
            g_a = torch.autograd.grad(actor_loss.sum(), a_params)
        ts.critic_opt = self.critic_tx.step(c_params, g_c, ts.critic_opt)
        if do_actor:
            ts.actor_opt = self.actor_tx.step(a_params, g_a, ts.actor_opt)
            soft_update(ts.target_actor, ts.actor, self.cfg.tau)
            soft_update(ts.target_critic, ts.critic, self.cfg.tau)
        ts.grad_updates += 1
        return {"critic_loss": critic_loss.detach().mean(), "actor_loss": actor_loss.detach().mean(),
                "td_abs": td_abs.detach()}

    def _train_once(self, ts: MADDPGState, buffer: ReplayBuffer, generator: torch.Generator):
        cfg = self.cfg
        M = cfg.batch_size
        if cfg.use_per:
            from .per import beta_schedule

            beta = beta_schedule(ts.env_steps, cfg.per_beta0, cfg.per_beta_anneal)
            batch, idx, weights = buffer.sample_prioritized(generator, M, cfg.per_alpha, beta)
        else:
            batch, weights = buffer.sample(generator, M), None
        aux = self._update_once(ts, batch, self._update_draws(generator, M), weights)
        td_abs = aux.pop("td_abs")
        if cfg.use_per:
            buffer.update_priorities(idx, td_abs)
        return aux
