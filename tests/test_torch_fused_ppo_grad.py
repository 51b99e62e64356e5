"""K9 on the CPU: the port's ``fused_ppo_grads_plain`` (the hand-derived
backward in PyTorch operations) against the JAX package's
``fused_ppo_grads(interpret=True)`` and against autograd of the port's
``MAPPO._loss``; and the fused update against the autograd update."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_formation_tpu as ft
from gym_formation_tpu.algos import MAPPO as JMAPPO, MAPPOConfig as JMAPPOConfig
from gym_formation_tpu.models.networks import gaussian_logp as jgaussian_logp
from gym_formation_tpu.ops.pallas import fused_ppo_grad as jk9

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch.algos import MAPPO, MAPPOConfig
from gym_formation_tpu_torch.models.networks import to_flax
from gym_formation_tpu_torch.ops.kernels import fused_ppo_grad as k9

# tests/test_fused_ppo_grad.py's tolerance a gradient leaf
RTOL, ATOL = 2e-3, 2e-6


def _setup(M, **cfg):
    env = ft.FormationEnv(ft.make_env("formation_hd_env", num_agents=3).scenario)
    jalgo = JMAPPO(env, JMAPPOConfig(rollout_len=8, fused_update=True, **cfg), num_envs=M // 8)
    ts, _, _ = jalgo.init(jax.random.PRNGKey(0))
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), ts.params)
    rng = np.random.RandomState(1)
    obs = rng.uniform(-1.5, 1.5, (M, 3, 18)).astype(np.float32)
    mean, ls = jalgo.actor.apply(params["actor"], jnp.asarray(obs))
    action = mean + jnp.exp(ls) * rng.normal(size=mean.shape)
    logp = jgaussian_logp(mean, ls, action) + 0.2 * rng.normal(size=(M, 3))
    value = jalgo.critic.apply(params["critic"], jnp.asarray(obs.reshape(M, -1)))
    data = {"obs": obs, "action": action, "logp": logp, "value": value,
            "target": value + rng.normal(size=M), "adv": rng.normal(size=M)}
    data = {k: np.array(v, np.float32) for k, v in data.items()}
    talgo = MAPPO(gt.make_env("formation_hd_env", num_agents=3),
                  MAPPOConfig(rollout_len=8, fused_update=True, **cfg), num_envs=M // 8, device="cpu")
    return jalgo, ts, params, data, talgo


def _ops(ts):
    f = lambda t: t.detach().contiguous()
    (a1, a2), (c1, c2) = ts.actor.mlp.layers, ts.critic.mlp.layers
    actor = (f(a1.weight.T), f(a1.bias), f(a2.weight.T), f(a2.bias), f(ts.actor.head.weight.T),
             f(ts.actor.head.bias), f(ts.actor.bounded_log_std()))
    critic = (f(c1.weight.T), f(c1.bias), f(c2.weight.T), f(c2.bias), f(ts.critic.head.weight.T),
              f(ts.critic.head.bias))
    return actor, critic


KW = dict(n_agents=3, act_dim=2, clip_eps=0.2, huber_delta=10.0, value_coef=1.0)


def test_k9_plain_matches_jax():
    """Every gradient leaf at M=512; the metric sums as per-row means."""
    M = 512
    _, _, params, data, talgo = _setup(M)
    ts = talgo.state_from_flax(params)
    aops, cops = _ops(ts)
    jops = lambda ops: tuple(jnp.asarray(o.numpy()).reshape((-1, o.shape[-1]) if o.dim() == 2 else (1, -1))
                             for o in ops)
    jga, jgc, jmet = jk9.fused_ppo_grads({k: jnp.asarray(v) for k, v in data.items()}, jops(aops),
                                         jops(cops), interpret=True, **KW)
    ga, gc, met = k9.fused_ppo_grads({k: torch.as_tensor(v) for k, v in data.items()}, aops, cops, **KW)
    assert k9.launches == 0
    for i, (t, j) in enumerate(zip(ga + gc, tuple(jga) + tuple(jgc))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j).reshape(t.shape), rtol=RTOL, atol=ATOL,
                                   err_msg=f"leaf {i}")
    per_row = np.array([3 * M, M, 3 * M])
    np.testing.assert_allclose(met.numpy() / per_row, np.asarray(jmet) / per_row, rtol=RTOL, atol=1e-6)


def test_k9_plain_matches_autograd():
    """MAPPO._fused_epoch_grads (K9's plain version, the entropy and
    soft_bound chain added by the learner) against autograd of _loss: every
    parameter leaf and the four metrics."""
    M = 512
    _, _, params, data, talgo = _setup(M)
    ts = talgo.state_from_flax(params)
    batch = {k: torch.as_tensor(v) for k, v in data.items()}
    grads, met = talgo._fused_epoch_grads(ts, batch)
    total, ref_met = talgo._loss(ts, batch, ts.value_norm)
    ref = torch.autograd.grad(total, ts.params())
    names = [k for k, _ in ts.actor.named_parameters()] + [k for k, _ in ts.critic.named_parameters()]
    for name, g, r in zip(names, grads, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=RTOL, atol=ATOL, err_msg=name)
    for k, v in ref_met.items():
        np.testing.assert_allclose(float(met[k]), float(v.detach()), rtol=1e-4, atol=1e-6, err_msg=k)


def test_fused_update_matches_autograd_update():
    """Three epochs of the fused update against the autograd update from
    the same state and data (tests/test_fused_ppo_grad.py's one-step match:
    parameters rtol 5e-3, atol 5e-5; v_loss rtol 1e-3)."""
    M = 256
    _, _, params, data, fused = _setup(M, ppo_epochs=3)
    plain = MAPPO(gt.make_env("formation_hd_env", num_agents=3),
                  MAPPOConfig(rollout_len=8, ppo_epochs=3), num_envs=M // 8, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in data.items()}
    ts_f, m_f = fused._update_fused(fused.state_from_flax(params), batch)
    ts_p, m_p = plain._update(plain.state_from_flax(params), batch)
    for a, b in ((to_flax(ts_f.actor), to_flax(ts_p.actor)),
                 (to_flax(ts_f.critic), to_flax(ts_p.critic))):
        for (path, x), (_, y) in zip(jax.tree_util.tree_flatten_with_path(a)[0],
                                     jax.tree_util.tree_flatten_with_path(b)[0]):
            np.testing.assert_allclose(x, y, rtol=5e-3, atol=5e-5, err_msg=jax.tree_util.keystr(path))
    np.testing.assert_allclose(float(m_f["v_loss"]), float(m_p["v_loss"]), rtol=1e-3)


@pytest.mark.parametrize("adv_per_agent", [False, True])
def test_k9_plain_env_and_agent_advantages(adv_per_agent):
    """adv [M] broadcasts to every agent, as adv [M, N] with equal columns."""
    M = 64
    _, _, params, data, talgo = _setup(M)
    ts = talgo.state_from_flax(params)
    aops, cops = _ops(ts)
    batch = {k: torch.as_tensor(v) for k, v in data.items()}
    ref = k9.fused_ppo_grads(batch, aops, cops, **KW)
    if adv_per_agent:
        batch["adv"] = batch["adv"][:, None].expand(M, 3).contiguous()
    got = k9.fused_ppo_grads(batch, aops, cops, **KW)
    for x, y in zip(got[0] + got[1] + (got[2],), ref[0] + ref[1] + (ref[2],)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("G", [1, 7, 132, 264])
def test_k9_chunk_assignment_covers_each_row_once(G):
    """The card kernel's walk of chunks (block b takes chunks b, b + G, ...:
    chunk_rows_plain, its loop in numpy) takes every row once, at row
    counts below a chunk, ragged, one over a full wave and the N=3 epoch's."""
    for rows in (1, 63, 64, 65, 777, 64 * G, 64 * G + 1, 307200):
        owner, visits = k9.chunk_rows_plain(rows, G)
        assert (visits == 1).all(), rows
        assert owner.min() >= 0 and owner.max() < G


def test_k9_grid_is_one_wave_of_busy_blocks():
    """Each launch is at most one wave (the plan's blocks an SM on each of
    the card's 132 SMs), and every block takes a chunk."""
    for per_sm in (1, 2, 3):
        for rows in (1, 64, 65, 16896, 102400, 307200):
            G = k9._grid(rows, per_sm, 132)
            assert G <= 132 * per_sm
            assert G == 132 * per_sm or G * 64 >= rows
            owner, _ = k9.chunk_rows_plain(rows, G)
            assert len(np.unique(owner)) == G


def _zero_batch(M, n, A):
    do, H = 6 * n, 64
    z = lambda *s: torch.zeros(*s)
    data = {"obs": z(M, n, do), "action": z(M, n, A), "logp": z(M, n), "adv": z(M), "value": z(M),
            "target": z(M)}
    aops = (z(do, H), z(H), z(H, H), z(H), z(H, A), z(A), z(A))
    cops = (z(n * do, H), z(H), z(H, H), z(H), z(H, 1), z(1))
    return data, aops, cops


def test_k9_wrapper_limits_on_a_simulated_card(monkeypatch):
    """On a (simulated) card the wrapper sizes each role's launch by the
    launcher's plan and launches once for every n whose rows fit (here up
    to n=8: the critic's rows of 384); it raises where the plan fits no
    block (the shared memory of rows too wide), for an act_dim other than 1
    or 2, and for a W1 not aligned to 16 bytes (read in 16-byte loads)."""
    from test_torch_physics import fake_card

    calls = fake_card(monkeypatch)
    monkeypatch.setattr(k9, "_sm_count", lambda dev: 132)
    asked = []

    def plan(K, actor, device):
        asked.append((K, actor))
        return (2 if K <= 64 else 1, 1) if K <= 485 else (0, 1)

    monkeypatch.setattr(k9, "_plan", plan)
    kw = dict(clip_eps=0.2, huber_delta=1.0, value_coef=0.5)
    before = k9.launches
    for n, A in ((3, 2), (4, 1), (5, 2), (7, 1), (8, 2)):
        k9.fused_ppo_grads(*_zero_batch(10, n, A), n_agents=n, act_dim=A, **kw)
    assert calls == ["fused_ppo_grad_launch"] * 5 and k9.launches == before + 5
    assert asked[:2] == [(18, True), (54, False)] and asked[-1] == (384, False)
    with pytest.raises(ValueError, match="shared memory"):
        k9.fused_ppo_grads(*_zero_batch(10, 9, 2), n_agents=9, act_dim=2, **kw)
    with pytest.raises(ValueError, match="act_dim"):
        k9.fused_ppo_grads(*_zero_batch(10, 3, 3), n_agents=3, act_dim=3, **kw)
    data, aops, cops = _zero_batch(10, 3, 2)
    aops = (torch.zeros(18 * 64 + 1)[1:].view(18, 64),) + aops[1:]
    with pytest.raises(ValueError, match="16 bytes"):
        k9.fused_ppo_grads(data, aops, cops, n_agents=3, act_dim=2, **kw)
