"""RMAPPO: recurrent MAPPO with a GRU actor and critic and chunked BPTT.

Counterpart of ``gym_formation_tpu/algos/rmappo.py``, the reference's tuned
configuration (``--algo rmappo``: N=3, 128 envs, 25-step rollouts).  The
collection threads the GRU carries beside the env state and zeroes them at
episode starts; it records each step's pre-step carries, so that the PPO
update can run its BPTT over chunks of ``data_chunk_length`` steps from the
carries the collection had at each chunk's start.

RMAPPO has the shared GRU actor only, as the JAX package has, and takes
neither the fused collection (K5) nor the fused gradient (K9) nor the
structured path: their gates stay off, and forcing one raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from ..env import FormationEnv, benchmark_means
from ..models.networks import GRUCritic, GRUPolicy, gru_critic_from_flax, gru_policy_from_flax
from .mappo import MAPPO, MAPPOConfig, MAPPOState, huber


@dataclasses.dataclass(frozen=True)
class RMAPPOConfig(MAPPOConfig):
    gru_hidden: int = 64
    data_chunk_length: int = 5  # BPTT chunk


@dataclasses.dataclass
class RunnerCarry:
    """The recurrent state carried across iterations."""

    h_actor: torch.Tensor  # [B, N, H]
    h_critic: torch.Tensor  # [B, H]
    done_prev: torch.Tensor  # [B] bool: the last step ended an episode


class RMAPPO(MAPPO):
    kernel_paths = False

    def __init__(self, env: FormationEnv, cfg: RMAPPOConfig = RMAPPOConfig(), num_envs: int = 128,
                 device="cuda", dtype: torch.dtype = torch.float32):
        # fields of MAPPOConfig that the recurrent update has no use for
        unused = [name for name, on in (("share_policy=False", not cfg.share_policy),
                                        ("auto_entropy", cfg.auto_entropy),
                                        ("grad_accum", cfg.grad_accum != 1), ("remat", cfg.remat)) if on]
        if unused:
            raise ValueError(f"RMAPPO does not take {', '.join(unused)}")
        if cfg.rollout_len % cfg.data_chunk_length:
            raise ValueError("rollout_len must be a multiple of data_chunk_length")
        super().__init__(env, cfg, num_envs, device, dtype)

    # -- setup --------------------------------------------------------------
    def _networks(self, generator: Optional[torch.Generator] = None):
        H = self.cfg.gru_hidden
        return (GRUPolicy(self.obs_dim, self.act_dim, H, self.discrete, generator),
                GRUCritic(self.obs_dim * self.n_agents, H, generator))

    def state_from_flax(self, params: Dict) -> MAPPOState:
        """A fresh training state holding the JAX package's ``params``."""
        return self.init_state(gru_policy_from_flax(params["actor"], self.dtype),
                               gru_critic_from_flax(params["critic"], self.dtype))

    def initial_carry(self, num_envs: int) -> RunnerCarry:
        z = lambda *s: torch.zeros(s, dtype=self.dtype, device=self.device)
        return RunnerCarry(h_actor=z(num_envs, self.n_agents, self.cfg.gru_hidden),
                           h_critic=z(num_envs, self.cfg.gru_hidden),
                           done_prev=torch.zeros(num_envs, dtype=torch.bool, device=self.device))

    def init(self, generator: torch.Generator):
        """Random networks, the training state, the first episodes and zero
        carries.  Returns ``(ts, env_state, obs, carry)``."""
        ts, env_state, obs = super().init(generator)
        return ts, env_state, obs, self.initial_carry(self.num_envs)

    @torch.no_grad()
    def act(self, ts: MAPPOState, obs: torch.Tensor, carry: RunnerCarry,
            generator: Optional[torch.Generator] = None, deterministic: bool = True):
        """Recurrent action selection: returns ``(actions, new carry)``."""
        reset = carry.done_prev[:, None].expand(obs.shape[:2])
        h_a, dist = ts.actor(carry.h_actor, obs.to(self.dtype), reset)
        a = (self._dist_mode(dist) if deterministic or generator is None
             else self._dist_sample(generator, dist))
        return a, dataclasses.replace(carry, h_actor=h_a, done_prev=torch.zeros_like(carry.done_prev))

    # -- rollout ------------------------------------------------------------
    def _collect_recurrent(self, ts: MAPPOState, env_state, obs, carry: RunnerCarry, generator):
        """Step-by-step collection with the carries reset by ``done_prev``.
        The trajectory stores each step's reset flags and pre-step carries
        (the chunks' initial states), not ``share_obs``."""
        B, N = self.num_envs, self.n_agents
        steps, bench = [], []
        for _ in range(self.cfg.rollout_len):
            x = obs.to(self.dtype)
            reset = carry.done_prev
            h_c, value = ts.critic(carry.h_critic, x.reshape(B, N * self.obs_dim), reset)
            h_a, dist = ts.actor(carry.h_actor, x, reset[:, None].expand(B, N))
            action = self._dist_sample(generator, dist)
            logp = self._dist_logp(dist, action)
            env_state, out = self.env.step(env_state, action, generator)
            done = out.done[:, 0]
            steps.append(dict(obs=x, action=action, logp=logp, value=value,
                              reward=self._env_reward(out).to(self.dtype), done=done, reset=reset,
                              h_actor=carry.h_actor, h_critic=carry.h_critic))
            bench.append(benchmark_means(out.info))
            carry = RunnerCarry(h_actor=h_a, h_critic=h_c, done_prev=done)
            obs = out.obs
        _, last_value = ts.critic(carry.h_critic, obs.to(self.dtype).reshape(B, N * self.obs_dim),
                                  carry.done_prev)
        return env_state, obs, carry, self._stack(steps), self._stack(bench), last_value

    # -- update -------------------------------------------------------------
    def _loss(self, ts: MAPPOState, batch: Dict[str, torch.Tensor], vn):
        """The PPO loss over BPTT chunks: ``batch`` leaves [L, m, ...] and
        the chunks' initial carries ``h_actor0`` [m, N, H], ``h_critic0``
        [m, H]."""
        cfg = self.cfg
        h_a, h_c = batch["h_actor0"], batch["h_critic0"]
        dists, values = [], []
        for obs, reset in zip(batch["obs"], batch["reset"]):
            h_a, dist = ts.actor(h_a, obs, reset[:, None].expand(obs.shape[:2]))
            h_c, value = ts.critic(h_c, obs.reshape(obs.shape[0], -1), reset)
            dists.append(dist)
            values.append(value)
        dist = (torch.stack(dists) if self.discrete
                else tuple(torch.stack(d) for d in zip(*dists)))
        value = torch.stack(values)
        logp = self._dist_logp(dist, batch["action"])  # [L, m, N]
        # the clamp keeps exp() finite when the policy has moved far
        ratio = torch.exp(torch.clamp(logp - batch["logp"], -20.0, 20.0))
        adv = batch["adv"][..., None]
        pg1 = ratio * adv
        pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
        pg_loss = -torch.minimum(pg1, pg2).mean()
        entropy = self._dist_entropy(dist)
        target, v_old = batch["target"], batch["value"]
        v_clip = v_old + torch.clamp(value - v_old, -cfg.clip_eps, cfg.clip_eps)
        v_loss = torch.maximum(huber(value - target, cfg.huber_delta),
                               huber(v_clip - target, cfg.huber_delta)).mean()
        total = pg_loss - cfg.entropy_coef * entropy + cfg.value_coef * v_loss
        return total, {"pg_loss": pg_loss, "v_loss": v_loss, "entropy": entropy,
                       "approx_kl": (batch["logp"] - logp).mean()}

    @torch.no_grad()
    def _prepare(self, ts: MAPPOState, traj, last_value):
        """GAE and the value-norm update; the batch keeps the [T, B] layout
        that :meth:`_update_recurrent` cuts into chunks."""
        adv_n, target = self._targets(ts, traj, last_value)
        return ts, dict(traj, adv=adv_n, target=target)

    def _chunks(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """[T, B, ...] → [K, L, B, ...] → [L, K·B, ...] BPTT chunks, and
        each chunk's initial carries, element [k·L, b] of the stored ones."""
        L, B = self.cfg.data_chunk_length, self.num_envs
        K = self.cfg.rollout_len // L

        def chunk(x):
            return x.reshape((K, L, B) + x.shape[2:]).transpose(0, 1).reshape((L, K * B) + x.shape[2:])

        def inits(x):
            return x.reshape((K, L, B) + x.shape[2:])[:, 0].reshape((K * B,) + x.shape[2:])

        out = {k: chunk(data[k]) for k in ("obs", "action", "logp", "value", "adv", "target", "reset")}
        out["h_actor0"] = inits(data["h_actor"])
        out["h_critic0"] = inits(data["h_critic"])
        return out

    def _update_recurrent(self, ts: MAPPOState, data, generator=None,
                          perms: Optional[Sequence[torch.Tensor]] = None):
        """``ppo_epochs`` × ``num_minibatches`` updates, the minibatches
        over chunks: from a permutation drawn from ``generator``, or from
        ``perms[epoch]`` where given."""
        cfg = self.cfg
        chunked = self._chunks(data)
        M = chunked["h_critic0"].shape[0]
        mb = M // cfg.num_minibatches
        ms = []
        for epoch in range(cfg.ppo_epochs):
            if cfg.num_minibatches == 1:
                batches = [chunked]  # shuffling one minibatch changes nothing
            else:
                perm = perms[epoch] if perms is not None else torch.randperm(
                    M, generator=generator, device=generator.device)
                perm = perm.to(self.device)
                batches = [{k: v[idx] if k.endswith("0") else v[:, idx] for k, v in chunked.items()}
                           for idx in perm.reshape(cfg.num_minibatches, mb)]
            for batch in batches:
                grads, met = self._grads(ts, batch)
                self._apply(ts, grads)
                ms.append(met)
        return ts, self._mean_metrics(ms)

    # -- public api ---------------------------------------------------------
    def train_step(self, ts: MAPPOState, env_state, obs, carry: RunnerCarry, generator: torch.Generator):
        """One RMAPPO iteration.  Returns ``(ts, env_state, obs, carry,
        metrics)``, the metrics as 0-dim tensors on the device."""
        with torch.no_grad():
            env_state, obs, carry, traj, bench, last_value = self._collect_recurrent(
                ts, env_state, obs, carry, generator)
        ts, data = self._prepare(ts, traj, last_value)
        ts, metrics = self._update_recurrent(ts, data, generator)
        metrics["mean_step_reward"] = traj["reward"].mean()
        metrics.update({k: v.mean() for k, v in bench.items()})
        ts.update_i += 1
        return ts, env_state, obs, carry, metrics

    # -- checkpoints --------------------------------------------------------
    def checkpoint_tree(self, ts: MAPPOState, env_state, obs, carry: RunnerCarry,
                        generator: torch.Generator) -> Dict:
        """MAPPO's training tuple and the :class:`RunnerCarry`."""
        tree = super().checkpoint_tree(ts, env_state, obs, generator)
        tree["carry"] = dataclasses.asdict(carry)
        return tree

    def restore_tree(self, tree: Dict, generator: torch.Generator):
        """Returns ``(ts, env_state, obs, carry)``."""
        ts, env_state, obs = super().restore_tree(tree, generator)
        carry = RunnerCarry(**{k: v.to(self.device) for k, v in tree["carry"].items()})
        return ts, env_state, obs, carry
