"""Batched multi-agent environment API.

PyTorch counterpart of ``gym_formation_tpu/env.py``.  :class:`FormationEnv`
works on a whole batch at once: ``reset(generator, num_envs)`` and
``step(state, actions, generator)`` take and return tensors with a leading
env axis B, where the JAX package ``vmap``-s single-env functions.  The
random draws of a reset come from an explicit ``torch.Generator``;
:class:`VecFormationEnv` owns one on its device.

A step has a state+reward core and an observation stage.  :meth:`step_state`
runs the core only, so state-consuming policies (the BFS expansion) never
build the [B, N, 6N] observation, which at N=243 and B=4096 would be 5.8 GB
per step.  :meth:`step` adds the observation.

The in-step auto-reset draws a fresh batch of episodes every step and picks
it with ``torch.where`` where an episode ended, as the JAX package does.
Branching on ``done.any()`` instead would wait for the device every step.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import _device, spaces
from .core.physics import world_step
from .core.types import EnvState, StepOut
from .envs.scenario import Scenario


def _select(flag: torch.Tensor, a: EnvState, b: EnvState) -> EnvState:
    """Per env: ``a`` where ``flag`` [B] is True, else ``b``."""
    pick = lambda x, y: torch.where(flag.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)
    return EnvState(
        pos=pick(a.pos, b.pos),
        vel=pick(a.vel, b.vel),
        c=pick(a.c, b.c),
        ideal_shape=pick(a.ideal_shape, b.ideal_shape),
        ideal_vel=pick(a.ideal_vel, b.ideal_vel),
        t=pick(a.t, b.t),
    )


class FormationEnv:
    """A batch of formation-control environments.

    Args:
      scenario: scenario instance (see :mod:`gym_formation_tpu_torch.envs`).
      benchmark: include the benchmark_data quartet in ``info``.
      auto_reset: draw a fresh episode inside ``step`` where one ends.

    Only the continuous action decoding is ported; the discrete decodings
    of the JAX package raise ``NotImplementedError``.
    """

    def __init__(
        self,
        scenario: Scenario,
        benchmark: bool = False,
        auto_reset: bool = True,
        discrete_action: bool = False,
        discrete_action_input: bool = False,
        force_discrete_action: bool = False,
    ):
        if discrete_action or discrete_action_input or force_discrete_action:
            raise NotImplementedError(
                "discrete and forced-discrete action decodings are not yet ported"
            )
        self.scenario = scenario
        self.cfg = cfg = scenario.cfg
        self.benchmark = benchmark
        self.auto_reset = auto_reset
        n = cfg.n_agents
        self.num_agents = n
        self.world_length = cfg.world_length
        self.shared_reward = cfg.collaborative
        self._sensitivity = np.asarray(cfg.sensitivity)
        self._all_silent = bool(np.all(cfg.silent))

        self.action_space = []
        self.observation_space = []
        for i in range(n):
            u_space = spaces.Box(-cfg.u_range, cfg.u_range, (cfg.dim_p,))
            if cfg.silent[i]:
                self.action_space.append(u_space)
            else:
                c_space = spaces.Box(0.0, 1.0, (cfg.dim_c,))
                self.action_space.append(spaces.Tuple((u_space, c_space)))
            self.observation_space.append(
                spaces.Box(-np.inf, np.inf, (scenario.obs_dim,))
            )
        share_dim = scenario.obs_dim * n
        self.share_observation_space = [
            spaces.Box(-np.inf, np.inf, (share_dim,)) for _ in range(n)
        ]

    @property
    def act_dim(self) -> int:
        """Flat per-agent action width fed to :meth:`step`."""
        return self.cfg.dim_p + (0 if self._all_silent else self.cfg.dim_c)

    def _decode_actions(self, actions: torch.Tensor):
        """[B, N, act_dim] → control u [B, N, dim_p] (sensitivity-scaled)
        and the comm action (or None)."""
        cfg = self.cfg
        u = actions[..., : cfg.dim_p]
        comm = None if self._all_silent else actions[..., cfg.dim_p : cfg.dim_p + cfg.dim_c]
        return u * _device.const(self._sensitivity, u)[:, None], comm

    def reset_state(self, generator: torch.Generator, num_envs: int) -> EnvState:
        """Fresh episodes, without observations."""
        return self.scenario.pre_obs(self.scenario.reset(generator, num_envs))

    def reset(self, generator: torch.Generator, num_envs: int) -> Tuple[EnvState, torch.Tensor]:
        """Fresh episodes and their initial observations [B, N, obs_dim]."""
        state = self.reset_state(generator, num_envs)
        return state, self.scenario.observe(state)

    def _step(self, state, actions, generator, with_obs: bool):
        scen, cfg = self.scenario, self.cfg
        if generator is None and (self.auto_reset or cfg.has_noise()):
            raise ValueError("this env draws random numbers in step: pass a generator")
        u, comm = self._decode_actions(actions)
        pos, vel = world_step(
            state.pos, state.vel, u.to(state.pos.dtype), cfg,
            generator if cfg.has_noise() else None,
        )
        if comm is None:
            c = torch.zeros_like(state.c)
        else:
            silent = _device.const(cfg.silent, state.c, torch.bool)[:, None]
            c = torch.where(silent, 0.0, comm.to(state.c.dtype))
        state = state.replace(pos=pos, vel=vel, c=c, t=state.t + 1)

        state = scen.pre_obs(state)
        obs = scen.observe(state) if with_obs else None
        indiv = scen.reward(state)
        if self.shared_reward:
            reward = indiv.sum(-1, keepdim=True).expand_as(indiv)
        else:
            reward = indiv
        done_flag = state.t >= self.world_length  # [B]
        done = done_flag[:, None].expand(-1, cfg.n_agents)
        info = {"individual_reward": indiv}
        if self.benchmark:
            info.update(scen.benchmark(state))
        state = scen.post_step(state)

        if self.auto_reset:
            fresh = self.reset_state(generator, state.pos.shape[0])
            if with_obs:
                info["terminal_obs"] = obs
                obs = torch.where(done_flag[:, None, None], scen.observe(fresh), obs)
            state = _select(done_flag, fresh, state)
        return state, StepOut(obs=obs, reward=reward, done=done, info=info)

    def step(
        self, state: EnvState, actions: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> Tuple[EnvState, StepOut]:
        """Advance one step.  ``actions`` [B, N, act_dim]; ``generator``
        draws the auto-reset episodes (and motor noise, if any)."""
        return self._step(state, actions, generator, with_obs=True)

    def step_state(
        self, state: EnvState, actions: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> Tuple[EnvState, StepOut]:
        """:meth:`step` without the observation stage (``out.obs`` is None)."""
        return self._step(state, actions, generator, with_obs=False)

    def sample_actions(self, generator: torch.Generator, num_envs: int) -> torch.Tensor:
        """Uniform random joint actions [B, N, act_dim]."""
        u = torch.rand(
            (num_envs, self.num_agents, self.act_dim),
            generator=generator, device=generator.device, dtype=self.scenario.dtype,
        )
        return (u * 2.0 - 1.0) * self.cfg.u_range


class VecFormationEnv:
    """A batch of ``num_envs`` environments on one device, with the
    ``torch.Generator`` that draws their episodes."""

    def __init__(self, env: FormationEnv, num_envs: int, device="cpu", seed: int = 0):
        self.env = env
        self.num_envs = num_envs
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def reset(self):
        return self.env.reset(self.generator, self.num_envs)

    def reset_state(self) -> EnvState:
        """Fresh episodes without the [B, N, 6N] observations."""
        return self.env.reset_state(self.generator, self.num_envs)

    def step(self, state: EnvState, actions: torch.Tensor):
        """state, actions [B, N, act_dim] → (state, StepOut)."""
        return self.env.step(state, actions, self.generator)

    def step_state(self, state: EnvState, actions: torch.Tensor):
        return self.env.step_state(state, actions, self.generator)

    def sample_actions(self) -> torch.Tensor:
        return self.env.sample_actions(self.generator, self.num_envs)


def _stack_outs(outs):
    return StepOut(
        obs=torch.stack([o.obs for o in outs]),
        reward=torch.stack([o.reward for o in outs]),
        done=torch.stack([o.done for o in outs]),
        info={k: torch.stack([o.info[k] for o in outs]) for k in outs[0].info},
    )


def rollout(
    env: FormationEnv,
    policy_fn: Callable,
    state: EnvState,
    obs: torch.Tensor,
    generator: torch.Generator,
    length: int,
):
    """``length`` steps with ``policy_fn(obs, generator) -> actions``.
    Returns ``(state, obs)`` and the :class:`StepOut` stacked over time
    (leading axis T)."""
    outs = []
    for _ in range(length):
        state, out = env.step(state, policy_fn(obs, generator), generator)
        obs = out.obs
        outs.append(out)
    return (state, obs), _stack_outs(outs)


def rollout_statepolicy(
    env: FormationEnv,
    state_policy_fn: Callable,
    state: EnvState,
    generator: torch.Generator,
    length: int,
):
    """Rollout for policies that read the state
    (``state_policy_fn(state, generator) -> actions``), e.g. closures over
    :func:`~gym_formation_tpu_torch.models.bfs.bfs_actions_from_state`.  No
    observation tensor is built.  Returns the final state and the per-step
    rewards [T, B, N]."""
    rewards = []
    for _ in range(length):
        actions = state_policy_fn(env.scenario.pre_obs(state), generator)
        state, out = env.step_state(state, actions, generator)
        rewards.append(out.reward)
    return state, torch.stack(rewards)


def rollout_statepolicy_rewardsum(
    env: FormationEnv,
    state_policy_fn: Callable,
    state: EnvState,
    generator: torch.Generator,
    length: int,
):
    """:func:`rollout_statepolicy` keeping only each env's reward sum over
    steps and agents.  Returns (state, reward sum [B])."""
    acc = torch.zeros(state.pos.shape[0], dtype=state.pos.dtype, device=state.pos.device)
    for _ in range(length):
        actions = state_policy_fn(env.scenario.pre_obs(state), generator)
        state, out = env.step_state(state, actions, generator)
        acc = acc + out.reward.sum(-1)
    return state, acc
