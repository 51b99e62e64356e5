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
from .core.physics import _collide_subset, world_step
from .core.types import EnvState, StepOut
from .envs.scenario import Scenario
from .models.bfs import num_layers
from .ops.kernels import fused_step, reward_sym


# Discrete action index → movement direction, the ``discrete_action_input``
# decoding (0: noop, 1: −x, 2: +x, 3: −y, 4: +y).
_DISCRETE_MOVES = np.array(
    [[0.0, 0.0], [-1.0, 0.0], [1.0, 0.0], [0.0, -1.0], [0.0, 1.0]]
)

BENCHMARK_KEYS = ("reward", "collisions", "min_dists", "occupied_landmarks")


def benchmark_means(info: dict) -> dict:
    """Scalar means of the benchmark quartet in a step's ``info`` (present
    when the env was built with ``benchmark=True``) under ``bench_*`` keys;
    empty otherwise, so collection loops can thread it unconditionally."""
    return {f"bench_{k}": info[k].mean() for k in BENCHMARK_KEYS if k in info}


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
      discrete_action: 5-way one-hot movement actions, ``u = (a1 − a2,
        a3 − a4)``, followed by the comm slice.
      discrete_action_input: actions are integer indices [B, N, 1] into
        the five moves (noop, −x, +x, −y, +y).
      force_discrete_action: continuous actions snapped to a one-hot over
        the first ``dim_p`` entries (their argmax) before scaling.
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
        self.scenario = scenario
        self.cfg = cfg = scenario.cfg
        self.benchmark = benchmark
        self.auto_reset = auto_reset
        self.discrete_action = discrete_action
        self.discrete_action_input = discrete_action_input
        self.force_discrete_action = force_discrete_action
        n = cfg.n_agents
        self.num_agents = n
        self.world_length = cfg.world_length
        self.shared_reward = cfg.collaborative
        self._sensitivity = np.asarray(cfg.sensitivity)
        self._all_silent = bool(np.all(cfg.silent))

        self.action_space = []
        self.observation_space = []
        for i in range(n):
            if discrete_action:
                u_space = spaces.Discrete(cfg.dim_p * 2 + 1)
            else:
                u_space = spaces.Box(-cfg.u_range, cfg.u_range, (cfg.dim_p,))
            if cfg.silent[i]:
                self.action_space.append(u_space)
            else:
                c_space = (spaces.Discrete(cfg.dim_c) if discrete_action
                           else spaces.Box(0.0, 1.0, (cfg.dim_c,)))
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
        if self.discrete_action_input:
            return 1
        move = 5 if self.discrete_action else self.cfg.dim_p
        return move + (0 if self._all_silent else self.cfg.dim_c)

    def _decode_actions(self, actions: torch.Tensor):
        """[B, N, act_dim] → control u [B, N, dim_p] (sensitivity-scaled)
        and the comm action (or None)."""
        cfg = self.cfg
        comm = None
        if self.discrete_action_input:
            moves = _device.const(_DISCRETE_MOVES, actions, self.scenario.dtype)
            u = moves[actions[..., 0].long()]
        elif self.discrete_action:
            u = torch.stack([actions[..., 1] - actions[..., 2], actions[..., 3] - actions[..., 4]], -1)
            if not self._all_silent:
                comm = actions[..., 5 : 5 + cfg.dim_c]
        else:
            u = actions[..., : cfg.dim_p]
            if self.force_discrete_action:
                u = torch.nn.functional.one_hot(u.argmax(-1), cfg.dim_p).to(u.dtype)
            if not self._all_silent:
                comm = actions[..., cfg.dim_p : cfg.dim_p + cfg.dim_c]
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
        if scen.scripted_mask is not None:
            # scripted agents override the policy's control
            mask = _device.const(scen.scripted_mask, u, torch.bool)[:, None]
            u = torch.where(mask, scen.scripted_actions(state).to(u.dtype), u)
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
        """Uniform random joint actions [B, N, act_dim]: move indices
        [B, N, 1] in 0..4 under ``discrete_action_input``."""
        if self.discrete_action_input:
            return torch.randint(0, 5, (num_envs, self.num_agents, 1), generator=generator,
                                 device=generator.device)
        u = torch.rand(
            (num_envs, self.num_agents, self.act_dim),
            generator=generator, device=generator.device, dtype=self.scenario.dtype,
        )
        return (u * 2.0 - 1.0) * self.cfg.u_range


class VecFormationEnv:
    """A batch of ``num_envs`` environments on one device (the card unless
    ``device="cpu"`` is given), with the ``torch.Generator`` that draws
    their episodes."""

    def __init__(self, env: FormationEnv, num_envs: int, device="cuda", seed: int = 0):
        self.env = env
        self.num_envs = num_envs
        self.device = _device.resolve(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def reset(self):
        return self.env.reset(self.generator, self.num_envs)

    def reset_state(self) -> EnvState:
        """Fresh episodes without the [B, N, 6N] observations."""
        return self.env.reset_state(self.generator, self.num_envs)

    def reset_choose(self, state: EnvState, obs: torch.Tensor, choose: torch.Tensor):
        """Fresh episodes for the envs where ``choose`` [B] is True; the
        others keep their state and observation bit for bit.

        The generator is consumed as by one :meth:`reset`: one draw of
        ``reset_state`` for all B envs, whether chosen or not, then a select
        on the device (as the in-step auto-reset does), so that no host
        read of ``choose`` is needed.  Returns ``(state, obs)``."""
        choose = torch.as_tensor(choose, dtype=torch.bool, device=self.device)
        fresh = self.env.reset_state(self.generator, self.num_envs)
        obs = torch.where(choose[:, None, None], self.env.scenario.observe(fresh), obs)
        return _select(choose, fresh, state), obs

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


def rollout_stateonly(
    env: FormationEnv,
    policy_fn: Callable,
    state: EnvState,
    generator: torch.Generator,
    length: int,
):
    """:func:`rollout` carrying only the state: the observation is rebuilt
    from the state each step (``policy_fn(obs, generator) -> actions``)
    instead of carried between steps, so one observation is alive at a
    time.  Returns the final state and the per-step rewards [T, B, N]."""
    scen, rewards = env.scenario, []
    for _ in range(length):
        actions = policy_fn(scen.observe(scen.pre_obs(state)), generator)
        state, out = env.step_state(state, actions, generator)
        rewards.append(out.reward)
    return state, torch.stack(rewards)


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


def rollout_statepolicy_fused(
    env: FormationEnv,
    state_policy_fn: Optional[Callable],
    state: EnvState,
    generator: torch.Generator,
    length: int,
    stats: str = "pre",
    policy: str = "external",
):
    """Rollout driving the fused physics + reward step kernel K3
    (:func:`~gym_formation_tpu_torch.ops.kernels.fused_step.fused_hd_step`).

    The same steps as :func:`rollout_statepolicy`: physics, the hd reward
    with the shared-reward broadcast, and the time-limit auto-reset.  The
    generator is consumed in the same order (the policy's draws, then a
    fresh episode batch every step), so with the same generator state the
    two rollouts give the same trajectories across resets, to the kernel's
    float32 rounding.

    ``stats="post"`` takes each step's reward statistics from K3 on the
    integrated positions.  ``stats="pre"`` takes them from K3 on the *input*
    positions, which are the previous step's integrated ones, so step t
    finalizes the reward of step t-1.  Where an env auto-reset in between,
    K2 recomputes its statistics from the carried pre-reset positions; it is
    launched every step with the reset mask (envs that did not reset copy
    and return), so no step waits for the host to ask whether any env
    reset.  The last step is finalized after the loop.

    ``policy="bfs_ez"`` runs the arity-3 BFS + ezpolicy expansion inside
    K3, and ``state_policy_fn`` is unused; ``policy="external"`` calls
    ``state_policy_fn(state, generator)`` every step for the actions.

    The JAX package also has a planes body of this function, which keeps
    the state in ``[E, B]`` planes between steps so that the TPU's lanes
    stay full; its steps are those of the arrays body, so the port has this
    one body and none of the ``layout``, ``tile`` and ``interpret``
    arguments.

    Returns ``(state, rewards [T, B])``, ``rewards[t, b]`` the sum over
    agents of env b's step-t reward vector.
    """
    scen, cfg = env.scenario, env.cfg
    n = cfg.n_agents
    if stats not in ("pre", "post"):
        raise ValueError(f"stats must be 'pre' or 'post', got {stats!r}")
    if policy not in ("external", "bfs_ez"):
        raise ValueError(f"policy must be 'external' or 'bfs_ez', got {policy!r}")
    sub = _collide_subset(cfg)
    if sub is None:
        sub_cfg = cfg
    else:
        lo, hi, idx, sub_cfg = sub
        if idx is not None or (lo, hi) != (0, n):
            raise ValueError("the fused rollout wants the agents as the colliding subset")
    if not (env.shared_reward and env.auto_reset):
        raise ValueError("the fused rollout wants a shared reward and auto-reset")
    if cfg.has_noise() or not bool(np.all(cfg.silent)):
        raise ValueError("the fused rollout wants silent agents without noise")
    thresh = float(2.0 * cfg.size[0] * scen.collision_factor)
    B = state.pos.shape[0]
    if policy == "bfs_ez":
        bfs_L = num_layers(n, 3)
        sens, coef = np.unique(env._sensitivity), np.unique(cfg.act_coef[:n])
        if len(sens) != 1 or len(coef) != 1:
            raise ValueError("policy='bfs_ez' wants one sensitivity and act_coef for all agents")
        act_scale = float(sens[0] * coef[0])
    else:
        act_mult = env._sensitivity * cfg.act_coef[:n]

    def phys_reward(st):
        """Policy and K3.  Returns the state after the physics (before the
        reset), the new agent positions, the statistics and the velocity
        term."""
        if policy == "bfs_ez":
            aforce, kw = None, dict(bfs_L=bfs_L, ideal_vel=st.ideal_vel, act_scale=act_scale)
        else:
            actions = state_policy_fn(scen.pre_obs(st), generator)
            mult = _device.const(act_mult, st.pos, torch.float32)[:, None]
            aforce, kw = actions[..., : cfg.dim_p].to(torch.float32) * mult, {}
        npos, nvel, haus, ncoll = fused_step.fused_hd_step(
            st.pos[:, :n], st.vel[:, :n], aforce, st.ideal_shape, sub_cfg,
            thresh=thresh, stats=stats, **kw,
        )
        st = st.replace(
            pos=torch.cat([npos.to(st.pos.dtype), st.pos[:, n:]], 1),
            vel=torch.cat([nvel.to(st.vel.dtype), st.vel[:, n:]], 1),
            c=torch.zeros_like(st.c),
            t=st.t + 1,
        )
        dv = st.ideal_vel - nvel.mean(1)
        return scen.pre_obs(st), npos, haus, ncoll, -torch.sqrt((dv * dv).sum(-1))

    def finalize(haus, ncoll, velterm):
        """Sum over agents of the step's reward vector, shared broadcast
        included: n * (n * (velterm - haus) - sum ncoll)."""
        return n * (n * (velterm - haus) - ncoll.sum(-1))

    def auto_reset(st):
        done = st.t >= env.world_length
        return _select(done, env.reset_state(generator, B), st), done

    rewards = []
    if stats == "post":
        for _ in range(length):
            state, _, haus, ncoll, velterm = phys_reward(state)
            rewards.append(finalize(haus, ncoll, velterm))
            state, _ = auto_reset(state)
        return state, torch.stack(rewards)

    # "pre": step t finalizes step t-1 (rewards[0] is a placeholder for
    # step -1 and is dropped)
    prev_pos = state.pos[:, :n].contiguous()
    prev_ishape = state.ideal_shape
    prev_velterm = state.pos.new_zeros(B)
    prev_done = torch.zeros(B, dtype=torch.bool, device=state.pos.device)
    for _ in range(length):
        ishape_t = state.ideal_shape
        state, npos, haus_in, ncoll_in, velterm = phys_reward(state)
        haus, ncoll = reward_sym.hd_reward_stats_sym(
            prev_pos, prev_ishape, thresh=thresh, mask=prev_done, fallback=(haus_in, ncoll_in)
        )
        rewards.append(finalize(haus, ncoll, prev_velterm))
        prev_pos, prev_ishape, prev_velterm = npos, ishape_t, velterm  # pre-reset
        state, prev_done = auto_reset(state)
    haus, ncoll = reward_sym.hd_reward_stats_sym(prev_pos, prev_ishape, thresh=thresh)
    rewards.append(finalize(haus, ncoll, prev_velterm))
    return state, torch.stack(rewards[1:])
