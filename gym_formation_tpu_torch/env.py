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

Under a data-parallel mesh (``FormationEnv(..., mesh=...)``, see
:mod:`gym_formation_tpu_torch.parallel`) the env's batch is the rank's rows
of the global one, and every random draw (the episodes of a reset, the
motor noise, ``sample_actions``) is made at the global shape and cut to the
rank's rows, so that W ranks consume the generator as one process does.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import _device, spaces
from .parallel.mesh import draw_rows, local_rows, rank, size
from .core.physics import _collide_subset, world_step
from .core.types import EnvState, StepOut
from .envs.formation_hd import FormationHDScenario
from .envs.scenario import Scenario
from .models.bfs import num_layers
from .ops.kernels import fused_step, reward_sym, step_reset
from .utils.profiling import mark


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
      mesh: a data-parallel mesh: the batch is this rank's rows, and the
        draws are made at the global shape (None: one process).
    """

    def __init__(
        self,
        scenario: Scenario,
        benchmark: bool = False,
        auto_reset: bool = True,
        discrete_action: bool = False,
        discrete_action_input: bool = False,
        force_discrete_action: bool = False,
        mesh=None,
    ):
        self.scenario = scenario
        self.cfg = cfg = scenario.cfg
        self.benchmark = benchmark
        self.auto_reset = auto_reset
        self.discrete_action = discrete_action
        self.discrete_action_input = discrete_action_input
        self.force_discrete_action = force_discrete_action
        self.mesh = mesh
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
        """Fresh episodes, without observations.  Under a mesh ``num_envs``
        is the rank's count: the episodes are drawn for all ranks' envs and
        the rank's rows kept."""
        state = self.scenario.reset(generator, num_envs * size(self.mesh))
        return self.scenario.pre_obs(local_rows(state, self.mesh))

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
            generator if cfg.has_noise() else None, self.mesh,
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
            info.update(scen.benchmark(state, indiv))
        state = scen.post_step(state)

        if self.auto_reset:
            with mark("env.reset"):
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
            return draw_rows(lambda s: torch.randint(0, 5, s, generator=generator, device=generator.device),
                             (num_envs, self.num_agents, 1), self.mesh)
        u = draw_rows(lambda s: torch.rand(s, generator=generator, device=generator.device,
                                           dtype=self.scenario.dtype),
                      (num_envs, self.num_agents, self.act_dim), self.mesh)
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
    fresh episode batch every step, at the global shape under a mesh), so
    with the same generator state the two rollouts give the same
    trajectories across resets, to the kernels' float32 rounding.

    A step is the policy and K3, then one launch of
    :func:`~gym_formation_tpu_torch.ops.kernels.step_reset.step_reset`,
    which builds the next state from K3's agents: the landmarks recentred
    onto the agents' centroid (``pre_obs``), the velocity term of the
    reward, and a fresh episode from the step's draws where one ended.  The
    draws are made into buffers reused between steps.

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
    if not isinstance(scen, FormationHDScenario):
        raise ValueError("the fused rollout runs the formation_hd scenario")
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
        state = scen.pre_obs(state)  # later steps' states come recentred
    # the auto-reset's draws (FormationHDScenario.reset's, in its order) for
    # the global batch; the rank's rows start at row0
    Bg, row0 = B * size(env.mesh), B * rank(env.mesh)
    draw_kw = dict(dtype=scen.dtype, device=generator.device)
    draws = (torch.empty((Bg, n, 2), **draw_kw), torch.empty((Bg, n, 2), **draw_kw),
             torch.empty((Bg, 2), **draw_kw))
    c = torch.zeros_like(state.c)  # the stepped states' utterances: silent agents
    state = state.replace(**{k: getattr(state, k).contiguous()
                             for k in ("pos", "vel", "ideal_shape", "ideal_vel", "t")})

    def k3(st):
        """The policy and K3: the new agents and the statistics."""
        if policy == "bfs_ez":
            aforce, kw = None, dict(bfs_L=bfs_L, ideal_vel=st.ideal_vel, act_scale=act_scale)
        else:
            actions = state_policy_fn(st, generator)
            mult = _device.const(act_mult, st.pos, torch.float32)[:, None]
            aforce, kw = actions[..., : cfg.dim_p].to(torch.float32) * mult, {}
        return fused_step.fused_hd_step(
            st.pos[:, :n], st.vel[:, :n], aforce, st.ideal_shape, sub_cfg,
            thresh=thresh, stats=stats, **kw,
        )

    def auto_reset(st, npos, nvel):
        """The draws and the glue kernel: the next state, the step's
        velocity term and its done flag."""
        for u in draws:
            u.uniform_(generator=generator)
        pos, vel, ishape, ivel, t, velterm, done = step_reset.step_reset(
            st.pos, st.vel, st.ideal_shape, st.ideal_vel, st.t, npos, nvel, *draws,
            row0=row0, world_length=env.world_length,
        )
        return EnvState(pos=pos, vel=vel, c=c, ideal_shape=ishape, ideal_vel=ivel, t=t), velterm, done

    def finalize(haus, ncoll, velterm):
        """Sum over agents of the step's reward vector, shared broadcast
        included: n * (n * (velterm - haus) - sum ncoll)."""
        return n * (n * (velterm - haus) - ncoll.sum(-1))

    # each step's parts are marks (utils.profiling), with no span around
    # the chunk: the policy and K3, K2 (which "post" does not launch), and
    # the auto-reset.  "pre": step t finalizes step t-1 (rewards[0] is a
    # placeholder for step -1 and is dropped)
    rewards = []
    prev_pos = state.pos[:, :n].contiguous()
    prev_ishape = state.ideal_shape
    prev_velterm = state.pos.new_zeros(B)
    prev_done = torch.zeros(B, dtype=torch.bool, device=state.pos.device)
    for _ in range(length):
        with mark("rollout.k3"):
            npos, nvel, haus_in, ncoll_in = k3(state)
        if stats == "pre":
            with mark("rollout.k2"):
                haus, ncoll = reward_sym.hd_reward_stats_sym(
                    prev_pos, prev_ishape, thresh=thresh, mask=prev_done, fallback=(haus_in, ncoll_in)
                )
                rewards.append(finalize(haus, ncoll, prev_velterm))
            prev_pos, prev_ishape = npos, state.ideal_shape  # pre-reset
        with mark("env.reset"):
            state, velterm, done = auto_reset(state, npos, nvel)
        if stats == "pre":
            prev_velterm, prev_done = velterm, done
        else:
            rewards.append(finalize(haus_in, ncoll_in, velterm))
    if stats == "post":
        return state, torch.stack(rewards)
    haus, ncoll = reward_sym.hd_reward_stats_sym(prev_pos, prev_ishape, thresh=thresh)
    rewards.append(finalize(haus, ncoll, prev_velterm))
    return state, torch.stack(rewards[1:])


def rollout_statepolicy_fused_sharded(
    env: FormationEnv,
    state_policy_fn: Optional[Callable],
    state: EnvState,
    generator: torch.Generator,
    length: int,
    mesh,
    **kw,
):
    """:func:`rollout_statepolicy_fused` on this rank's rows of a batch
    split over the data-parallel ``mesh``: ``state`` is the rank's rows
    (:func:`~gym_formation_tpu_torch.parallel.shard_batch` of the global
    state), the auto-reset's episodes are drawn at the global shape and cut
    to the rank's rows, and K3 and the masked K2 run on the rank's envs.
    Every rank calls it with the same generator state; an external
    ``state_policy_fn`` that draws makes its draws at the global shape too
    (:func:`~gym_formation_tpu_torch.parallel.mesh.draw_rows`).

    Returns the rank's ``(state, rewards [T, B/W])``;
    :func:`~gym_formation_tpu_torch.parallel.host_local_to_global` gathers
    them into what :func:`rollout_statepolicy_fused` returns for the whole
    batch in one process.  Nothing is traced, so there is nothing to cache
    between calls."""
    sharded = copy.copy(env)
    sharded.mesh = mesh
    return rollout_statepolicy_fused(sharded, state_policy_fn, state, generator, length, **kw)


def make_receptor_locations(receptor_type: str = "polar") -> np.ndarray:
    """Receptor-field offsets in the agent's local frame, the original
    environment's (unused) observation helper, kept for its surface.
    ``polar``: 8 angles × 3 radii in [0.1, 1.0] plus the origin (25
    points); ``grid``: a 5×5 lattice over [-1, 1]².  Returns [K, 2]."""
    if receptor_type == "polar":
        angles = np.linspace(-np.pi, np.pi, 8, endpoint=False)
        radii = np.linspace(0.05 * 2.0, 1.0, 3)
        pts = [r * np.array([np.cos(a), np.sin(a)]) for a in angles for r in radii]
        pts.append(np.zeros(2))
    elif receptor_type == "grid":
        xs = np.linspace(-1.0, 1.0, 5)
        pts = [np.array([x, y]) for x in xs for y in xs]
    else:
        raise ValueError(f"unknown receptor_type: {receptor_type!r}")
    return np.stack(pts)
