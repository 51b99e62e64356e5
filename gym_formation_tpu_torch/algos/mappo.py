"""MAPPO: multi-agent PPO with a centralized critic.

Counterpart of ``gym_formation_tpu/algos/mappo.py``: collection of
``rollout_len`` steps on ``num_envs`` envs, GAE in raw return space with a
running value normalizer, then ``ppo_epochs`` × ``num_minibatches`` clipped
PPO updates of the actor and the critic by one global-norm clipped Adam.
The actor is a diagonal Gaussian, or a categorical head on a
``discrete_action`` env; with ``share_policy=False`` every agent has its own
actor and critic, stacked into batched products, and the critic gives one
value an agent.  The JAX package jits the whole iteration into one program;
here :meth:`MAPPO.train_step` is eager PyTorch (no ``torch.compile``) and
keeps every metric on the device, so an iteration never waits for the host.

Unlike the JAX package, the learner's state is mutable: ``train_step``
updates the modules and the optimizer moments in place and returns the same
:class:`MAPPOState`.

Three collection paths, chosen as the JAX package chooses them:

- ``_collect``: the step-by-step env with the actor and critic in PyTorch;
- ``_collect_fused``: kernel K5 (``ops/kernels/fused_collect.py``), the
  whole collection in one launch, at small n on the card;
- ``_collect_structured``: the obs-free path at N >= 32, which stores O(N)
  state parts instead of the [T·B, N, 6N] observation and evaluates the first
  layers factorized (``models/structured_obs.py``).

and two update paths: autograd of :meth:`MAPPO._loss` (with ``grad_accum``,
``remat`` and minibatches), or kernel K9 (``ops/kernels/fused_ppo_grad.py``)
for each epoch's whole gradient (``fused_update``).  K5, K9 and the
structured path hold the shared Gaussian policy only: their auto gates stay
off for a categorical head or per-agent networks, and forcing one there
raises ``ValueError`` (the JAX package asserts).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import _device
from ..env import FormationEnv, benchmark_means
from ..models.networks import (
    GaussianActor,
    LogitsActor,
    StackedActor,
    StackedValueCritic,
    ValueCritic,
    actor_from_flax,
    categorical_entropy,
    categorical_logp,
    categorical_sample,
    critic_from_flax,
    gaussian_entropy,
    gaussian_logp,
    gaussian_sample,
    logits_actor_from_flax,
    onehot_from_logits,
    soft_bound,
    stacked_actor_from_flax,
    stacked_critic_from_flax,
)
from ..models.structured_obs import actor_forward_structured, critic_forward_structured
from ..ops.kernels import fused_collect as k5
from ..ops.kernels import fused_ppo_grad as k9
from ..ops.kernels.fused_rollout import soa_to_state, state_to_soa
from .optim import AdamState, ClipAdam

@dataclasses.dataclass(frozen=True)
class MAPPOConfig:
    """The JAX package's fields and defaults (the reference's tuned run);
    see ``gym_formation_tpu/algos/mappo.py:MAPPOConfig`` for each one."""

    lr: float = 7e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    ppo_epochs: int = 10
    num_minibatches: int = 1
    entropy_coef: float = 0.01
    value_coef: float = 1.0
    max_grad_norm: float = 10.0
    hidden: Tuple[int, ...] = (64, 64)
    rollout_len: int = 25
    use_value_norm: bool = True
    huber_delta: float = 10.0
    adam_eps: float = 1e-5
    share_policy: bool = True
    # None = auto: on where every precondition of K5 holds (see MAPPO)
    fused_collect: Optional[bool] = None
    # None = auto: on for formation_hd + shared continuous policy + silent
    # agents + N >= 32
    structured_obs: Optional[bool] = None
    fused_update: bool = False
    grad_accum: int = 1
    remat: bool = False
    auto_entropy: bool = False
    alpha_max: float = 0.05
    entropy_target: Optional[float] = None
    structured_bf16: bool = False


@dataclasses.dataclass
class ValueNorm:
    """Running return normalizer: the critic learns in normalized space, GAE
    runs in raw space.  Fields are 0-dim tensors on the learner's device."""

    mean: torch.Tensor
    mean_sq: torch.Tensor
    count: torch.Tensor

    @classmethod
    def create(cls, device=None, dtype=torch.float32) -> "ValueNorm":
        f = lambda v: torch.tensor(v, dtype=dtype, device=device)
        return cls(mean=f(0.0), mean_sq=f(1.0), count=f(1e-4))

    def update(self, x: torch.Tensor) -> "ValueNorm":
        b_mean, b_sq, b_n = x.mean(), (x * x).mean(), x.numel()
        n = self.count + b_n
        w = b_n / n
        return ValueNorm(mean=self.mean * (1 - w) + b_mean * w,
                         mean_sq=self.mean_sq * (1 - w) + b_sq * w, count=n)

    @property
    def std(self) -> torch.Tensor:
        return torch.sqrt(torch.clamp(self.mean_sq - self.mean ** 2, min=1e-8))

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) / self.std

    def denormalize(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.std + self.mean


@dataclasses.dataclass
class MAPPOState:
    actor: torch.nn.Module
    critic: torch.nn.Module
    log_alpha: Optional[torch.nn.Parameter]  # the auto_entropy coefficient (signed)
    opt_state: AdamState
    value_norm: ValueNorm
    update_i: int

    def params(self) -> List[torch.nn.Parameter]:
        """Every trained leaf, in the optimizer's order."""
        ps = list(self.actor.parameters()) + list(self.critic.parameters())
        return ps + ([self.log_alpha] if self.log_alpha is not None else [])


def huber(x: torch.Tensor, delta: float) -> torch.Tensor:
    a = x.abs()
    return torch.where(a <= delta, 0.5 * x ** 2, delta * (a - 0.5 * delta))


class MAPPO:
    """MAPPO over a batch of ``num_envs`` :class:`FormationEnv` envs on
    ``device`` (the card unless ``device="cpu"`` is given), with parameters
    in ``dtype``."""

    # K5, K9 and the structured path may serve this learner (RMAPPO: never)
    kernel_paths = True

    def __init__(self, env: FormationEnv, cfg: MAPPOConfig = MAPPOConfig(), num_envs: int = 128,
                 device="cuda", dtype: torch.dtype = torch.float32):
        self.env = env
        self.cfg = cfg
        self.num_envs = num_envs
        self.device = _device.resolve(device)
        self.dtype = dtype
        self.n_agents = env.num_agents
        self.obs_dim = env.scenario.obs_dim
        self.act_dim = env.act_dim
        # a discrete env gets a categorical head; the index input stays a
        # Gaussian over the one index column, as in the JAX package
        self.discrete = bool(env.discrete_action and not env.discrete_action_input)
        hd = env.scenario.name == "formation_hd_env"
        # the policy K5, K9 and the structured path hold
        shared_gauss = self.kernel_paths and cfg.share_policy and not self.discrete
        kernel_free = ("RMAPPO takes the autograd paths only" if not self.kernel_paths else
                       "needs the shared continuous policy (share_policy=True, a continuous env)")
        for flag in ("fused_collect", "structured_obs", "fused_update"):
            if getattr(cfg, flag) and not shared_gauss:
                raise ValueError(f"{flag}=True {kernel_free}")
        fc = cfg.fused_collect
        if fc is None:
            # auto: on exactly where K5's preconditions hold.  The JAX gate's
            # num_envs % 512 == 0 is the TPU kernel's block size; K5 on the
            # card takes any batch, so it is dropped here.
            fc = (hd and shared_gauss and env.auto_reset and not env.benchmark
                  and self.device.type == "cuda" and self.n_agents in k5.KERNEL_AGENTS)
        self.fused_collect = bool(fc)
        so = cfg.structured_obs
        if so is None:
            so = (hd and shared_gauss and env._all_silent and env.scenario.obs_dim == 6 * self.n_agents
                  and self.n_agents >= 32 and not cfg.fused_update)
        self.structured_obs = bool(so)
        if self.structured_obs:
            assert hd and env._all_silent, "structured_obs needs the hd obs layout + shared continuous policy"
            assert not cfg.fused_update, "structured_obs excludes fused_update"
            self.fused_collect = False  # structured collection subsumes it
        if cfg.auto_entropy and self.discrete and cfg.entropy_target is None:
            raise ValueError("set an explicit entropy_target for categorical policies")
        if cfg.fused_update:
            assert cfg.grad_accum == 1 and not cfg.remat, (
                "fused_update computes whole-batch gradients in one kernel; "
                "grad_accum/remat apply to the autograd path only")
            assert not cfg.auto_entropy, "auto_entropy needs the autograd update path"
        self.entropy_target = (cfg.entropy_target if cfg.entropy_target is not None
                               else float(self.act_dim) * (1.41894 + math.log(0.5)))
        self.tx = ClipAdam(cfg.lr, cfg.max_grad_norm, eps=cfg.adam_eps)
        # CPU generator of K5's seeds: drawing a seed never waits for the card
        self.seed_generator = torch.Generator()

    # -- setup --------------------------------------------------------------
    def _networks(self, generator: Optional[torch.Generator] = None):
        """A fresh (actor, critic) of the configured kind."""
        cfg, N, do = self.cfg, self.n_agents, self.obs_dim
        if not cfg.share_policy:
            return (StackedActor(N, do, self.act_dim, cfg.hidden, self.discrete, generator),
                    StackedValueCritic(N, do * N, cfg.hidden, generator))
        actor = (LogitsActor(do, self.act_dim, cfg.hidden, generator) if self.discrete
                 else GaussianActor(do, self.act_dim, cfg.hidden, generator=generator))
        return actor, ValueCritic(do * N, cfg.hidden, generator=generator)

    def init_state(self, actor: torch.nn.Module, critic: torch.nn.Module,
                   log_alpha: Optional[float] = None) -> MAPPOState:
        """A fresh training state around the given networks (moved to the
        learner's device and dtype): Adam at step 0, a fresh value norm."""
        actor = actor.to(device=self.device, dtype=self.dtype)
        critic = critic.to(device=self.device, dtype=self.dtype)
        la = None
        if self.cfg.auto_entropy:
            v = self.cfg.entropy_coef if log_alpha is None else float(log_alpha)
            la = torch.nn.Parameter(torch.tensor(v, dtype=self.dtype, device=self.device))
        ts = MAPPOState(actor=actor, critic=critic, log_alpha=la, opt_state=None,
                        value_norm=ValueNorm.create(self.device, self.dtype), update_i=0)
        ts.opt_state = self.tx.init(ts.params())
        return ts

    def state_from_flax(self, params: Dict) -> MAPPOState:
        """A fresh training state holding the JAX package's ``params``
        (``{'actor': flax tree, 'critic': flax tree[, 'log_alpha']}``)."""
        la = params.get("log_alpha")
        if not self.cfg.share_policy:
            actor_fn, critic_fn = stacked_actor_from_flax, stacked_critic_from_flax
        else:
            actor_fn = logits_actor_from_flax if self.discrete else actor_from_flax
            critic_fn = critic_from_flax
        return self.init_state(actor_fn(params["actor"], self.dtype), critic_fn(params["critic"], self.dtype),
                               None if la is None else float(la))

    def init(self, generator: torch.Generator):
        """Random networks (orthogonal init), the training state and the
        first episodes.  Returns ``(ts, env_state, obs)``; ``obs`` is None on
        the structured path, which never reads it (at N=243 and B=1024 it
        would be 1.45 GB)."""
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator, device=generator.device))
        self.seed_generator.manual_seed(seed)
        ts = self.init_state(*self._networks(self.seed_generator))
        if self.structured_obs:
            return ts, self.env.reset_state(generator, self.num_envs), None
        env_state, obs = self.env.reset(generator, self.num_envs)
        return ts, env_state, obs

    def _next_seed(self) -> int:
        """K5's PRNG seed for one collection."""
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.seed_generator))

    # distribution ops dispatched on the head: a Gaussian's dist is
    # (mean, log_std), a categorical's its logits
    def _dist_sample(self, generator, dist):
        if self.discrete:
            return categorical_sample(generator, dist)
        return gaussian_sample(generator, *dist)

    def _dist_logp(self, dist, action):
        if self.discrete:
            return categorical_logp(dist, action)
        return gaussian_logp(*dist, action)

    def _dist_entropy(self, dist):
        if self.discrete:
            return categorical_entropy(dist).mean()
        return gaussian_entropy(dist[1]).mean()

    def _dist_mode(self, dist):
        return onehot_from_logits(dist) if self.discrete else dist[0]

    @torch.no_grad()
    def act(self, ts: MAPPOState, obs: torch.Tensor, generator: Optional[torch.Generator] = None,
            deterministic: bool = True) -> torch.Tensor:
        dist = ts.actor(obs.to(self.dtype))
        if deterministic or generator is None:
            return self._dist_mode(dist)
        return self._dist_sample(generator, dist)

    # -- rollout ------------------------------------------------------------
    def _env_reward(self, out) -> torch.Tensor:
        """Env-level reward: agent 0's entry under a shared reward, else the
        agent mean."""
        return out.reward[:, 0] if self.env.shared_reward else out.reward.mean(1)

    @staticmethod
    def _stack(steps: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
        return {k: torch.stack([s[k] for s in steps]) for k in (steps[0] if steps else {})}

    def _collect(self, ts: MAPPOState, env_state, obs, generator):
        """Step-by-step collection: the actor samples, the env steps."""
        B, N = self.num_envs, self.n_agents
        steps, bench = [], []
        for _ in range(self.cfg.rollout_len):
            x = obs.to(self.dtype)
            value = ts.critic(x.reshape(B, N * self.obs_dim))  # [B], or [B, N] per agent
            dist = ts.actor(x)
            action = self._dist_sample(generator, dist)
            logp = self._dist_logp(dist, action)
            env_state, out = self.env.step(env_state, action, generator)
            # share_obs is not stored: the update derives it from obs
            steps.append(dict(obs=x, action=action, logp=logp, value=value,
                              reward=self._env_reward(out).to(self.dtype), done=out.done[:, 0]))
            bench.append(benchmark_means(out.info))
            obs = out.obs
        last_value = ts.critic(obs.to(self.dtype).reshape(B, N * self.obs_dim))
        return env_state, obs, self._stack(steps), self._stack(bench), last_value

    def _collect_fused(self, ts: MAPPOState, env_state, obs, generator):
        """Collection by kernel K5 (its plain version on the CPU): the same
        trajectory contract as :meth:`_collect`, sampled from K5's counter
        PRNG, keyed by a seed from :attr:`seed_generator`."""
        scen = self.env.scenario
        assert scen.name == "formation_hd_env", scen.name
        assert self.env.auto_reset and not self.env.benchmark
        B, N = self.num_envs, self.n_agents
        soa, traj = k5.fused_collect_hd(
            state_to_soa(env_state), k5.actor_planes(ts.actor), k5.critic_planes(ts.critic),
            self._next_seed(), length=self.cfg.rollout_len, ep_len=self.env.world_length, n=N,
        )
        # the JAX package also refreshes per-env PRNG keys here; the port's
        # env keeps none
        env_state = soa_to_state(soa, env_state)
        obs = scen.observe(env_state)
        last_value = ts.critic(obs.to(self.dtype).reshape(B, N * self.obs_dim))
        traj = {k: (v if k == "done" else v.to(self.dtype)) for k, v in traj.items()}
        return env_state, obs, traj, {}, last_value

    def _parts(self, env_state) -> Dict[str, torch.Tensor]:
        """O(N) state parts that linearly determine the hd observation."""
        n = self.n_agents
        f = lambda t: t.to(self.dtype)
        return dict(apos=f(env_state.pos[:, :n]), avel=f(env_state.vel[:, :n]),
                    ishape=f(env_state.ideal_shape), ivel=f(env_state.ideal_vel))

    def _structured_dist_value(self, ts: MAPPOState, parts):
        p = (parts["apos"], parts["avel"], parts["ishape"], parts["ivel"])
        dist = actor_forward_structured(ts.actor, *p,
                                        dtype=torch.bfloat16 if self.cfg.structured_bf16 else None)
        return dist, critic_forward_structured(ts.critic, *p)

    def _collect_structured(self, ts: MAPPOState, env_state, obs, generator):
        """Obs-free collection: the trajectory stores the state parts, and
        the env runs its state-only step (``step_state``), so no [B, N, 6N]
        observation is ever built.  ``obs`` passes through untouched."""
        steps, bench = [], []
        for _ in range(self.cfg.rollout_len):
            parts = self._parts(env_state)
            (mean, log_std), value = self._structured_dist_value(ts, parts)
            action = gaussian_sample(generator, mean, log_std)
            logp = gaussian_logp(mean, log_std, action)
            env_state, out = self.env.step_state(env_state, action, generator)
            steps.append(dict(parts, action=action, logp=logp, value=value,
                              reward=self._env_reward(out).to(self.dtype), done=out.done[:, 0]))
            bench.append(benchmark_means(out.info))
        _, last_value = self._structured_dist_value(ts, self._parts(env_state))
        return env_state, obs, self._stack(steps), self._stack(bench), last_value

    def _gae(self, ts: MAPPOState, traj, last_value):
        """GAE over the time axis in raw return space (values are stored
        normalized when value_norm is on).  Returns (adv, returns) [T, B]."""
        vn = ts.value_norm
        values = traj["value"]
        if self.cfg.use_value_norm:
            values, last_value = vn.denormalize(values), vn.denormalize(last_value)
        gamma, lam = self.cfg.gamma, self.cfg.gae_lambda
        reward, done = traj["reward"], traj["done"]
        if values.dim() == 3:  # per-agent critics: the env's reward and done for every agent
            reward, done = reward[..., None], done[..., None]
        gae = torch.zeros_like(last_value)
        next_value = last_value
        adv = [None] * values.shape[0]
        for t in reversed(range(values.shape[0])):
            nonterm = 1.0 - done[t].to(values.dtype)
            delta = reward[t] + gamma * next_value * nonterm - values[t]
            gae = delta + gamma * lam * nonterm * gae
            adv[t] = gae
            next_value = values[t]
        adv = torch.stack(adv)
        return adv, adv + values

    # -- update -------------------------------------------------------------
    def _loss(self, ts: MAPPOState, batch: Dict[str, torch.Tensor], vn: ValueNorm):
        """The PPO loss and its metrics (0-dim tensors)."""
        cfg = self.cfg
        if "obs" in batch:
            obs = batch["obs"]
            dist = ts.actor(obs)
            value = ts.critic(obs.reshape(obs.shape[0], -1))  # share_obs, derived
        else:  # structured: state parts instead of observations
            dist, value = self._structured_dist_value(ts, batch)
        logp = self._dist_logp(dist, batch["action"])
        # the clamp keeps exp() finite when the policy has moved far
        ratio = torch.exp(torch.clamp(logp - batch["logp"], -20.0, 20.0))
        adv = batch["adv"]
        if adv.dim() == 1:
            adv = adv[:, None]  # env-level advantage → all agents
        pg1 = ratio * adv
        pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
        pg_loss = -torch.minimum(pg1, pg2).mean()
        entropy = self._dist_entropy(dist)
        target, v_old = batch["target"], batch["value"]
        v_clip = v_old + torch.clamp(value - v_old, -cfg.clip_eps, cfg.clip_eps)
        v_loss = torch.maximum(huber(value - target, cfg.huber_delta),
                               huber(v_clip - target, cfg.huber_delta)).mean()
        if cfg.auto_entropy:
            alpha_raw = ts.log_alpha  # the raw signed coefficient
            coef = torch.clamp(alpha_raw, -cfg.alpha_max, cfg.alpha_max).detach()
            # descent on α · (H − H*): α falls while H > H*, rises while H < H*
            alpha_loss = alpha_raw * (entropy.detach() - self.entropy_target)
            ent_term = coef * entropy - alpha_loss
        else:
            ent_term = cfg.entropy_coef * entropy
        total = pg_loss - ent_term + cfg.value_coef * v_loss
        metrics = {"pg_loss": pg_loss, "v_loss": v_loss, "entropy": entropy,
                   "approx_kl": (batch["logp"] - logp).mean()}
        if cfg.auto_entropy:
            metrics["alpha"] = ts.log_alpha.detach().clone()  # the optimizer updates it in place
        return total, metrics

    def _grads(self, ts: MAPPOState, batch):
        """(gradients in ``ts.params()`` order, metrics) of one minibatch by
        autograd, chunked by ``grad_accum`` and rematerialized by ``remat``."""
        cfg, params = self.cfg, ts.params()

        def one(chunk):
            if cfg.remat:
                # the backward recomputes the forward instead of holding the
                # activations (torch.utils.checkpoint for jax.checkpoint)
                total, met = checkpoint(lambda c: self._loss(ts, c, ts.value_norm), chunk,
                                        use_reentrant=False)
            else:
                total, met = self._loss(ts, chunk, ts.value_norm)
            grads = torch.autograd.grad(total, params)
            return list(grads), {k: v.detach() for k, v in met.items()}

        K = cfg.grad_accum
        if K <= 1:
            return one(batch)
        m = batch["action"].shape[0]
        assert m % K == 0, (m, K)
        gsum, msum = None, None
        for c in range(K):
            g, met = one({k: v[c * (m // K):(c + 1) * (m // K)] for k, v in batch.items()})
            if gsum is None:
                # the metric keys are the loss's own (the JAX package lists them)
                gsum, msum = g, met
            else:
                gsum = [a + b for a, b in zip(gsum, g)]
                msum = {k: msum[k] + met[k] for k in msum}
        inv = 1.0 / K  # equal chunks: the mean of chunk means is the global mean
        return [g * inv for g in gsum], {k: v * inv for k, v in msum.items()}

    def _apply(self, ts: MAPPOState, grads) -> None:
        ts.opt_state = self.tx.step(ts.params(), grads, ts.opt_state)

    @staticmethod
    def _mean_metrics(ms: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
        return {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}

    def _update(self, ts: MAPPOState, data, generator=None,
                perms: Optional[Sequence[torch.Tensor]] = None):
        """``ppo_epochs`` × ``num_minibatches`` autograd updates.  Each
        epoch's minibatches come from a permutation drawn from
        ``generator``, or from ``perms[epoch]`` where given."""
        cfg = self.cfg
        M = cfg.rollout_len * self.num_envs
        mb = M // cfg.num_minibatches
        ms = []
        for epoch in range(cfg.ppo_epochs):
            if cfg.num_minibatches == 1:
                # one minibatch: shuffling changes nothing, and a gather
                # would copy the whole trajectory
                batches = [data]
            else:
                perm = perms[epoch] if perms is not None else torch.randperm(
                    M, generator=generator, device=generator.device)
                perm = perm.to(data["action"].device)
                batches = [{k: v[perm[i * mb:(i + 1) * mb]] for k, v in data.items()}
                           for i in range(cfg.num_minibatches)]
            for batch in batches:
                grads, met = self._grads(ts, batch)
                self._apply(ts, grads)
                ms.append(met)
        return ts, self._mean_metrics(ms)

    def _update_fused(self, ts: MAPPOState, data, generator=None):
        """PPO epochs with each epoch's gradient from kernel K9: the math of
        :meth:`_update` at one minibatch."""
        assert self.cfg.num_minibatches == 1
        ms = []
        for _ in range(self.cfg.ppo_epochs):
            grads, met = self._fused_epoch_grads(ts, data)
            self._apply(ts, grads)
            ms.append(met)
        return ts, self._mean_metrics(ms)

    def _fused_epoch_grads(self, ts: MAPPOState, data):
        """One epoch's (gradients in ``ts.params()`` order, metrics) by K9,
        gradient-matched to autograd of :meth:`_loss`."""
        cfg = self.cfg
        M = cfg.rollout_len * self.num_envs
        actor, critic = ts.actor, ts.critic
        f = lambda t: t.detach().to(torch.float32).contiguous()
        (a1, a2), (c1, c2) = actor.mlp.layers, critic.mlp.layers
        ls_raw = actor.log_std.detach().requires_grad_(True)
        with torch.enable_grad():
            ls_b = soft_bound(ls_raw, -5.0, 2.0)
        actor_ops = (f(a1.weight.T), f(a1.bias), f(a2.weight.T), f(a2.bias),
                     f(actor.head.weight.T), f(actor.head.bias), f(ls_b))
        critic_ops = (f(c1.weight.T), f(c1.bias), f(c2.weight.T), f(c2.bias),
                      f(critic.head.weight.T), f(critic.head.bias))
        ga, gc, met = k9.fused_ppo_grads(
            {k: data[k] for k in ("obs", "action", "logp", "adv", "value", "target")},
            actor_ops, critic_ops, n_agents=self.n_agents, act_dim=self.act_dim,
            clip_eps=cfg.clip_eps, huber_delta=cfg.huber_delta, value_coef=cfg.value_coef,
        )
        # entropy term: d(-ce · mean Σ_d ls_d)/d ls_d = -ce; then the chain
        # through the soft_bound the actor applies to its raw parameter
        d_ls_b = (ga[6] - cfg.entropy_coef).to(ls_b.dtype)
        (d_ls_raw,) = torch.autograd.grad(ls_b, ls_raw, d_ls_b)
        by_name = {
            "mlp.layers.0.weight": ga[0].T, "mlp.layers.0.bias": ga[1],
            "mlp.layers.1.weight": ga[2].T, "mlp.layers.1.bias": ga[3],
            "head.weight": ga[4].T, "head.bias": ga[5], "log_std": d_ls_raw,
        }
        cby_name = {
            "mlp.layers.0.weight": gc[0].T, "mlp.layers.0.bias": gc[1],
            "mlp.layers.1.weight": gc[2].T, "mlp.layers.1.bias": gc[3],
            "head.weight": gc[4].T, "head.bias": gc[5],
        }
        grads = [by_name[k].to(p.dtype) for k, p in actor.named_parameters()]
        grads += [cby_name[k].to(p.dtype) for k, p in critic.named_parameters()]
        N = self.n_agents
        metrics = {
            "pg_loss": met[0] / (M * N),
            "v_loss": met[1] / M,
            "entropy": gaussian_entropy(ls_b.detach()),
            "approx_kl": met[2] / (M * N),
        }
        return grads, metrics

    @torch.no_grad()
    def _targets(self, ts: MAPPOState, traj, last_value):
        """GAE and the value-norm update (in ``ts``): the normalized
        advantages and the value targets, [T, B] (or [T, B, N] per agent)."""
        adv, returns = self._gae(ts, traj, last_value)
        vn = ts.value_norm
        if self.cfg.use_value_norm:
            vn = vn.update(returns)
            target = vn.normalize(returns)
        else:
            target = returns
        ts.value_norm = vn
        return (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-5), target

    @torch.no_grad()
    def _prepare(self, ts: MAPPOState, traj, last_value):
        """GAE, the value-norm update and flattening: the trajectory → the
        flat update batch."""
        adv_n, target = self._targets(ts, traj, last_value)
        M = self.cfg.rollout_len * self.num_envs
        flat = lambda x: x.reshape((M,) + tuple(x.shape[2:]))
        keys = (("apos", "avel", "ishape", "ivel") if self.structured_obs else ("obs",)) + (
            "action", "logp", "value")
        data = {k: flat(traj[k]) for k in keys}
        data["adv"] = flat(adv_n)
        data["target"] = flat(target)
        return ts, data

    # -- public api ---------------------------------------------------------
    def train_step(self, ts: MAPPOState, env_state, obs, generator: torch.Generator):
        """One MAPPO iteration: collect, GAE, PPO epochs.  ``generator``
        draws the policy's samples and the env's resets.  Returns
        ``(ts, env_state, obs, metrics)``, the metrics as 0-dim tensors on
        the device."""
        if self.structured_obs:
            collect = self._collect_structured
        elif self.fused_collect:
            collect = self._collect_fused
        else:
            collect = self._collect
        with torch.no_grad():
            env_state, obs, traj, bench, last_value = collect(ts, env_state, obs, generator)
        ts, data = self._prepare(ts, traj, last_value)
        update = self._update_fused if self.cfg.fused_update else self._update
        ts, metrics = update(ts, data, generator)
        metrics["mean_step_reward"] = traj["reward"].mean()
        metrics.update({k: v.mean() for k, v in bench.items()})
        ts.update_i += 1
        return ts, env_state, obs, metrics

    # -- checkpoints --------------------------------------------------------
    def checkpoint_tree(self, ts: MAPPOState, env_state, obs, generator: torch.Generator) -> Dict:
        """The whole training tuple as a dict of tensors and ints, for
        :func:`~gym_formation_tpu_torch.utils.checkpoint.save_checkpoint`."""
        vn = ts.value_norm
        return {
            "config": dataclasses.asdict(self.cfg),
            "actor": ts.actor.state_dict(), "critic": ts.critic.state_dict(),
            "log_alpha": None if ts.log_alpha is None else ts.log_alpha.detach(),
            "adam": {"mu": ts.opt_state.mu, "nu": ts.opt_state.nu, "count": ts.opt_state.count},
            "value_norm": {"mean": vn.mean, "mean_sq": vn.mean_sq, "count": vn.count},
            "update_i": ts.update_i,
            "env_state": dataclasses.asdict(env_state),
            "obs": obs,
            "generator": generator.get_state(),
            "seed_generator": self.seed_generator.get_state(),
        }

    def state_from_tree(self, tree: Dict) -> MAPPOState:
        """The training state (networks, Adam, value norm, iteration) of a
        :meth:`checkpoint_tree`, on the learner's device."""
        actor, critic = self._networks()
        actor.load_state_dict(tree["actor"])
        critic.load_state_dict(tree["critic"])
        la = tree["log_alpha"]
        ts = self.init_state(actor, critic, None if la is None else float(la))
        dev = lambda t: t.to(self.device)
        a = tree["adam"]
        ts.opt_state = AdamState(mu=[dev(t) for t in a["mu"]], nu=[dev(t) for t in a["nu"]],
                                 count=int(a["count"]))
        ts.value_norm = ValueNorm(**{k: dev(v) for k, v in tree["value_norm"].items()})
        ts.update_i = int(tree["update_i"])
        return ts

    def restore_tree(self, tree: Dict, generator: torch.Generator):
        """Inverse of :meth:`checkpoint_tree` into fresh objects: returns
        ``(ts, env_state, obs)`` and sets both generators' states."""
        from ..core.types import EnvState

        ts = self.state_from_tree(tree)
        env_state = EnvState(**{k: v.to(self.device) for k, v in tree["env_state"].items()})
        obs = None if tree["obs"] is None else tree["obs"].to(self.device)
        generator.set_state(tree["generator"])
        self.seed_generator.set_state(tree["seed_generator"])
        return ts, env_state, obs
