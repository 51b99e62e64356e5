"""The port's registry and entry points: ``eval_policy`` against the JAX
package's on the same parameters in float64 (mappo with both heads, greedy
and stochastic; rmappo with its carry over 4 steps across a reset; the six
feed-forward off-policy names; the five recurrent off-policy names with
their carries), ``make_algo``, the ``train`` and ``eval`` entry points on
the CPU in a subprocess, and eval's refusal to BFS-expand a per-agent
checkpoint."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_formation_tpu as ft
from gym_formation_tpu.algos import registry as jreg

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch import eval as teval
from gym_formation_tpu_torch import train as ttrain
from gym_formation_tpu_torch.algos import (
    EPISODIC, MADDPG, MAPPO, MASAC, MATD3, RMADDPG, RMASAC, QMix, RMAPPO, RQMix, MAPPOConfig, RMAPPOConfig,
    eval_policy, make_algo,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
TOL = dict(rtol=1e-10, atol=1e-10)


def _pair(name, discrete, B):
    """The JAX learner (its params in float64, the actor's head gains up so
    that the clip and the argmax see spread) and the port's in float64
    holding the same parameters."""
    jenv = ft.make_env("formation_hd_env", num_agents=3, episode_length=8, discrete_action=discrete)
    sets = ["rollout_len=4", "ppo_epochs=1"] + (["data_chunk_length=2", "gru_hidden=16"] if name == "rmappo" else [])
    jalgo = jreg.make_algo(name, jenv, num_envs=B, sets=sets)
    params = jax.tree.map(lambda x: np.asarray(x, np.float64), jalgo.init(jax.random.PRNGKey(0))[0].params)
    head = "Dense_1" if name == "rmappo" else "Dense_0"
    params["actor"]["params"][head]["kernel"] = params["actor"]["params"][head]["kernel"] * 200.0
    tenv = gt.make_env("formation_hd_env", num_agents=3, episode_length=8, discrete_action=discrete)
    cls, cfg = (RMAPPO, RMAPPOConfig) if name == "rmappo" else (MAPPO, MAPPOConfig)
    talgo = cls(tenv, cfg(rollout_len=4, ppo_epochs=1, **({"data_chunk_length": 2, "gru_hidden": 16}
                                                          if name == "rmappo" else {})),
                num_envs=B, device="cpu", dtype=F64)
    return jalgo, params, talgo, talgo.state_from_flax(params)


def _obs(B, seed):
    return np.random.RandomState(seed).uniform(-1.5, 1.5, (B, 3, 18))


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("discrete", [False, True])
def test_eval_policy_mappo_greedy_matches_jax(discrete, clip):
    B = 5
    jalgo, params, talgo, ts = _pair("mappo", discrete, B)
    jpol, jcarry = jreg.eval_policy("mappo", jalgo, {"params": params}, B, clip_continuous=clip)
    tpol, tcarry = eval_policy("mappo", talgo, ts, B, clip_continuous=clip)
    assert jcarry is None and tcarry is None
    obs = _obs(B, 1)
    a_j, _ = jpol(jnp.asarray(obs), None)
    a_t, _ = tpol(torch.as_tensor(obs), None)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), **TOL)
    if not discrete:
        assert (np.abs(a_t.numpy()) > 1.0).any() != clip  # the clip acts, and only when asked


@pytest.mark.parametrize("discrete", [False, True])
def test_eval_policy_mappo_stochastic(discrete):
    """Samples of JAX's distribution on the same parameters, drawn from a
    generator seeded by ``seed`` (the carry, threaded from step to step):
    the same seed gives the same draws, the next step new ones."""
    B, seed = 6, 11
    jalgo, params, talgo, ts = _pair("mappo", discrete, B)
    tpol, g = eval_policy("mappo", talgo, ts, B, stochastic=True, seed=seed)
    obs = _obs(B, 2)
    dist = jalgo._apply_actor(params["actor"], jnp.asarray(obs))
    ref = torch.Generator()
    ref.manual_seed(seed)
    for _ in range(2):
        a_t, g = tpol(torch.as_tensor(obs), g)
        if discrete:
            u = torch.rand((B, 3, 5), generator=ref, dtype=F64)
            want = np.eye(5)[np.argmax(np.asarray(dist) - np.log(-np.log(u.numpy())), -1)]
            assert set(a_t.unique().tolist()) == {0.0, 1.0}
        else:
            noise = torch.randn((B, 3, 2), generator=ref, dtype=F64).numpy()
            want = np.clip(np.asarray(dist[0]) + np.exp(np.asarray(dist[1])) * noise, -1.0, 1.0)
        np.testing.assert_allclose(a_t.numpy(), want, **TOL)
    again, _ = eval_policy("mappo", talgo, ts, B, stochastic=True, seed=seed)[0](
        torch.as_tensor(obs), eval_policy("mappo", talgo, ts, B, stochastic=True, seed=seed)[1])
    first, _ = tpol(torch.as_tensor(obs), g)
    assert not torch.equal(again, first)  # a new draw on the third step


@pytest.mark.parametrize("discrete", [False, True])
def test_eval_policy_rmappo_carry_matches_jax(discrete):
    """The carry threaded over 4 steps: hidden states zeroed at the start,
    and again for the envs whose reset flags are set before step 2 (an
    episode start), against JAX's eval policy (1e-10)."""
    B = 4
    jalgo, params, talgo, ts = _pair("rmappo", discrete, B)
    jpol, (hj, rj) = jreg.eval_policy("rmappo", jalgo, {"params": params}, B)
    tpol, (ht, rt) = eval_policy("rmappo", talgo, ts, B)
    assert ht.shape == (B, 3, 16) and bool(rt.all())
    hj, ht = hj + 0.3, ht + 0.3  # a stale carry that the first step's resets must clear
    for step in range(4):
        if step == 2:
            rj, rt = jnp.asarray([True, False, True, False]), torch.tensor([True, False, True, False])
        obs = _obs(B, 10 + step)
        a_j, (hj, rj) = jpol(jnp.asarray(obs), (hj, rj))
        a_t, (ht, rt) = tpol(torch.as_tensor(obs), (ht, rt))
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), **TOL)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
        assert not bool(rt.any())
    with pytest.raises(SystemExit, match="mappo only"):
        eval_policy("rmappo", talgo, ts, B, stochastic=True)


def test_make_algo():
    env = gt.make_env("formation_hd_env", num_agents=3)
    a = make_algo("mappo", env, 8, sets=["ppo_epochs=3"], lr=1e-3, device="cpu")
    assert type(a) is MAPPO and (a.cfg.ppo_epochs, a.cfg.lr, a.num_envs) == (3, 1e-3, 8)
    r = make_algo("rmappo", env, 4, sets=["data_chunk_length=5", "lr=2e-4"], lr=1e-3, device="cpu")
    assert type(r) is RMAPPO and (r.cfg.gru_hidden, r.cfg.data_chunk_length, r.cfg.lr) == (64, 5, 2e-4)
    with pytest.raises(ValueError, match="unknown algorithm"):
        make_algo("ppo", env, 4, device="cpu")


def test_make_algo_offpolicy():
    """The six feed-forward off-policy names: ``ddpg`` implies local
    critics, ``qmix``/``vdn`` their mixer, ``lr`` both of the MADDPG
    family's rates; ``--set`` wins over what the name implies."""
    env = gt.make_env("formation_hd_env", num_agents=3)
    denv = gt.make_env("formation_hd_env", num_agents=3, discrete_action=True)
    m = make_algo("maddpg", env, 8, lr=3e-3, device="cpu")
    assert type(m) is MADDPG and m.cfg.centralized and (m.cfg.lr_actor, m.cfg.lr_critic) == (3e-3, 3e-3)
    d = make_algo("ddpg", env, 8, sets=["use_per=True"], device="cpu")
    assert type(d) is MADDPG and not d.cfg.centralized and d.cfg.use_per
    assert make_algo("ddpg", env, 8, sets=["centralized=True"], device="cpu").cfg.centralized
    t3 = make_algo("matd3", env, 8, sets=["policy_delay=3"], lr=2e-3, device="cpu")
    assert type(t3) is MATD3 and (t3.cfg.policy_delay, t3.cfg.lr_actor, t3.cfg.lr_critic) == (3, 2e-3, 2e-3)
    s = make_algo("masac", env, 8, lr=1e-3, device="cpu")
    assert type(s) is MASAC and (s.cfg.lr, s.cfg.alpha_lr) == (1e-3, 3e-4)
    for name in ("qmix", "vdn"):
        q = make_algo(name, denv, 8, lr=1e-3, device="cpu")
        assert type(q) is QMix and (q.cfg.mixer, q.cfg.lr, q.act_dim) == (name, 1e-3, 5)
    assert {a.device.type for a in (m, d, t3, s)} == {"cpu"}


def _jax_offpolicy_params(name, jalgo):
    ts = jalgo.init(jax.random.PRNGKey(0))[0]
    if name in ("qmix", "vdn"):
        return {"q": ts.q_params, "mixer": ts.mixer_params}, {"q_params": ts.q_params}
    return {"actor": ts.actor_params, "critic": ts.critic_params}, {"actor_params": ts.actor_params}


@pytest.mark.parametrize("name,discrete", [("maddpg", False), ("maddpg", True), ("ddpg", False),
                                           ("matd3", False), ("masac", False), ("masac", True),
                                           ("qmix", True), ("vdn", True)])
def test_eval_policy_offpolicy_matches_jax(name, discrete):
    """JAX's eval branches and the port's on the same parameters (float64,
    the actors' head gains up): the actors' actions clipped to ±high_action
    (maddpg, ddpg, matd3), ``tanh(mean) · high_action`` (masac), one-hots
    of the logits or of the shared Q (qmix, vdn)."""
    B = 5
    jenv = ft.make_env("formation_hd_env", num_agents=3, discrete_action=discrete)
    jalgo = jreg.make_algo(name, jenv, num_envs=B, sets=["buffer_size=64", "high_action=0.5"]
                           if name not in ("qmix", "vdn") else ["buffer_size=64"])
    params, raw = _jax_offpolicy_params(name, jalgo)
    params = jax.tree.map(lambda x: np.array(x, np.float64), params)
    head = params["q" if name in ("qmix", "vdn") else "actor"]["params"]["Dense_0"]
    head["kernel"] = head["kernel"] * 200.0
    raw = {k: params[k.split("_")[0]] for k in raw}
    jpol, jcarry = jreg.eval_policy(name, jalgo, raw, B)
    talgo = make_algo(name, gt.make_env("formation_hd_env", num_agents=3, discrete_action=discrete), B,
                      config=jalgo.cfg.__dict__, device="cpu")
    talgo.dtype = F64
    tpol, tcarry = eval_policy(name, talgo, talgo.state_from_flax(params), B)
    assert jcarry is None and tcarry is None
    obs = _obs(B, 3)
    a_j, _ = jpol(jnp.asarray(obs), None)
    a_t, _ = tpol(torch.as_tensor(obs), None)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), **TOL)
    if talgo.discrete:
        assert set(a_t.unique().tolist()) == {0.0, 1.0} and torch.equal(a_t.sum(-1), torch.ones(B, 3, dtype=F64))
    else:
        assert float(a_t.abs().max()) <= 0.5


def test_make_algo_recurrent():
    """The five recurrent off-policy names: ``rmatd3`` implies the twin
    critics, ``rqmix``/``rvdn`` their mixer, ``lr`` both rates of
    RMADDPG/RMATD3 and the one ``lr`` of the others; ``--set`` wins."""
    env = gt.make_env("formation_hd_env", num_agents=3, episode_length=25)
    denv = gt.make_env("formation_hd_env", num_agents=3, episode_length=25, discrete_action=True)
    r = make_algo("rmaddpg", env, 32, lr=3e-3, device="cpu")
    assert type(r) is RMADDPG and not r.cfg.twin and (r.cfg.lr_actor, r.cfg.lr_critic) == (3e-3, 3e-3)
    t3 = make_algo("rmatd3", env, 32, sets=["mask_done=False"], device="cpu")
    assert type(t3) is RMADDPG and t3.cfg.twin and not t3.cfg.mask_done
    assert not make_algo("rmatd3", env, 32, sets=["twin=False"], device="cpu").cfg.twin
    s = make_algo("rmasac", env, 32, lr=1e-3, sets=["autotune_alpha=False"], device="cpu")
    assert type(s) is RMASAC and (s.cfg.lr, s.cfg.alpha_lr, s.cfg.autotune_alpha) == (1e-3, 3e-4, False)
    for name in ("rqmix", "rvdn"):
        q = make_algo(name, denv, 32, lr=1e-3, device="cpu")
        assert type(q) is RQMix and (q.cfg.mixer, q.cfg.lr, q.act_dim) == (name[1:], 1e-3, 5)
    assert (r.T, r.num_envs, r.cfg.buffer_episodes, r.cfg.gru_hidden) == (25, 32, 4096, 64)
    assert set(EPISODIC) == {"rmaddpg", "rmatd3", "rmasac", "rqmix", "rvdn"}


@pytest.mark.parametrize("name", EPISODIC)
def test_eval_policy_recurrent_matches_jax(name):
    """JAX's recurrent eval branches and the port's on the same parameters
    (float64, the heads' gains up) over 3 steps from a stale carry, the
    hidden states zeroed by the first step's reset flags and again for the
    envs flagged before step 2: ``tanh(mean) · high_action`` (rmaddpg,
    rmatd3, rmasac; unclipped, in range), the greedy one-hots of the shared
    Q (rqmix, rvdn), and the carries (1e-10)."""
    B, discrete = 4, name in ("rqmix", "rvdn")
    jenv = ft.make_env("formation_hd_env", num_agents=3, episode_length=8, discrete_action=discrete)
    sets = ["buffer_episodes=8", "gru_hidden=16"] + ([] if discrete else ["high_action=0.5"])
    jalgo = jreg.make_algo(name, jenv, num_envs=B, sets=sets)
    ts = jax.jit(lambda k: jalgo.init(k)[0])(jax.random.PRNGKey(0))
    key = "q" if discrete else "actor"
    tree = np_f64(getattr(ts, f"{key}_params"))
    tree["params"]["Dense_1"]["kernel"] = tree["params"]["Dense_1"]["kernel"] * 300.0
    jpol, (hj, rj) = jreg.eval_policy(name, jalgo, {f"{key}_params": tree}, B)
    talgo = make_algo(name, gt.make_env("formation_hd_env", num_agents=3, episode_length=8, discrete_action=discrete),
                      B, config=jalgo.cfg.__dict__, device="cpu")
    talgo.dtype = F64
    params = {"q": tree, "mixer": {}} if discrete else {"actor": tree, "critic": np_f64(ts.critic_params)}
    tpol, (ht, rt) = eval_policy(name, talgo, talgo.state_from_flax(params), B)
    assert ht.shape == (B, 3, 16) and bool(rt.all())
    hj, ht = hj + 0.3, ht + 0.3  # a stale carry that the first step's resets must clear
    for step in range(3):
        if step == 2:
            rj, rt = jnp.asarray([True, False, True, False]), torch.tensor([True, False, True, False])
        obs = _obs(B, 20 + step)
        a_j, (hj, rj) = jpol(jnp.asarray(obs), (hj, rj))
        a_t, (ht, rt) = tpol(torch.as_tensor(obs), (ht, rt))
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), **TOL)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
        assert not bool(rt.any())
    if discrete:
        assert set(a_t.unique().tolist()) == {0.0, 1.0} and torch.equal(a_t.sum(-1), torch.ones(B, 3, dtype=F64))
    else:
        assert 0.4 < float(a_t.abs().max()) <= 0.5


def np_f64(tree):
    return jax.tree.map(lambda x: np.array(x, np.float64), tree)


def test_eval_refusals():
    for argv, match in ((["--gif", "x.gif"], "renderer is not yet ported"),
                        (["--per-agent-view"], "renderer is not yet ported"),
                        (["--discrete-action"], "only applies to trained checkpoints"),
                        (["--policy", "ckpt", "--discrete-action", "--num-layer", "2"], "can't be BFS-expanded"),
                        (["--stochastic"], "--stochastic applies"),
                        (["--policy", "ckpt", "--algo", "rmappo", "--num-layer", "2"], "shared stateless actor"),
                        (["--policy", "ckpt", "--algo", "rqmix"], "--ckpt is required")):
        with pytest.raises(SystemExit, match=match):
            teval.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit, match="is supported by"):
        ttrain.main(["--algo", "rmaddpg", "--discrete-action", "--device", "cpu"])


def _run(module, args):
    """The entry point in a process of its own, on one intra-op thread
    (other test workers hold the host's cores)."""
    cmd = [sys.executable, "-m", f"gym_formation_tpu_torch.{module}", "--device", "cpu", *args]
    return subprocess.run(cmd, cwd=REPO, check=True, timeout=300, capture_output=True, text=True,
                          env={**os.environ, "OMP_NUM_THREADS": "1"}).stdout


ONPOLICY_SETS = ["--set", "rollout_len=4", "--set", "ppo_epochs=1"]
OFFPOLICY_SETS = ["--set", "buffer_size=256", "--set", "batch_size=16", "--set", "steps_per_iter=4",
                  "--set", "updates_per_iter=2"]
EPISODIC_SETS = ["--episode-length", "4", "--set", "buffer_episodes=64", "--set", "batch_episodes=8",
                 "--set", "episodes_per_iter=1", "--set", "updates_per_iter=2", "--set", "gru_hidden=16"]


@pytest.mark.parametrize("algo,extra,eval_extra", [
    ("rmappo", ONPOLICY_SETS + ["--set", "data_chunk_length=2"], []),
    ("mappo", ONPOLICY_SETS + ["--discrete-action"], ["--discrete-action"]),
    ("mappo", ONPOLICY_SETS + ["--set", "share_policy=False"], []),
    ("maddpg", OFFPOLICY_SETS + ["--set", "use_per=True"], []),
    ("matd3", OFFPOLICY_SETS, []),
    ("masac", OFFPOLICY_SETS + ["--set", "warmup_random_steps=32"], []),
    ("qmix", OFFPOLICY_SETS, []),
    ("rmaddpg", EPISODIC_SETS, ["--episode-length", "4"]),
    ("rmasac", EPISODIC_SETS, ["--episode-length", "4"]),
    ("rqmix", EPISODIC_SETS, ["--episode-length", "4"]),
])
def test_train_and_eval_entry_points_cpu(algo, extra, eval_extra, tmp_path):
    """Two iterations with a checkpoint each, a restored third, then eval
    of the checkpoint: finite returns for 2 episodes.  Each run ends with
    its reward curve, ``mean_step_reward.png``."""
    run = tmp_path / "run"
    base = ["--algo", algo, "--num-envs", "8", "--episode-length", "6", "--log-every", "1", "--save-every", "1",
            "--run-dir", str(run), *extra]
    _run("train", base + ["--iters", "2"])
    out = _run("train", base + ["--iters", "1", "--restore"])
    assert "restored checkpoint at iteration 2" in out
    assert sorted(os.listdir(run / "ckpt")) == ["2.pt", "3.pt"]
    assert (run / "mean_step_reward.png").stat().st_size > 0
    out = _run("eval", ["--policy", "ckpt", "--algo", algo, "--ckpt", str(run / "ckpt"), "--episodes", "2",
                        "--episode-length", "6", *eval_extra])
    returns = [float(line.split("return=")[1].split()[0]) for line in out.splitlines() if "return=" in line]
    assert len(returns) == 2 and np.isfinite(returns).all()
    assert "collisions" in out and "mean return over 2 episodes" in out


def test_eval_refuses_bfs_expansion_of_per_agent_checkpoint(tmp_path):
    """One iteration of MAPPO with per-agent networks, then ``eval
    --num-layer 2`` on its checkpoint: the refusal, not an einsum error
    (the stacked actor holds 3 agents' weights, the expansion feeds 9
    rows)."""
    run = tmp_path / "run"
    ttrain.main(["--algo", "mappo", "--num-envs", "4", "--iters", "1", "--episode-length", "4", "--save-every", "1",
                 "--run-dir", str(run), "--set", "rollout_len=4", "--set", "ppo_epochs=1",
                 "--set", "share_policy=False", "--device", "cpu"])
    with pytest.raises(SystemExit, match="per-agent stacked actors have no meta-agent assignment"):
        teval.main(["--policy", "ckpt", "--algo", "mappo", "--ckpt", str(run / "ckpt"), "--num-layer", "2",
                    "--device", "cpu"])
