"""Helpers of the off-policy parity tests (``test_torch_{maddpg,matd3,masac,
qmix}.py`` and the recurrent ``test_torch_{rmaddpg,rmasac,rqmix}.py``):
float64 trees, numpy batches and episodes, the JAX draws of a key, and the
checks that every test file shares."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import pytest

import gym_formation_tpu_torch as gt
from gym_formation_tpu.core.types import EnvState as JEnvState
from gym_formation_tpu_torch.models.networks import to_flax, to_flax_tree
from gym_formation_tpu_torch.utils import restore_checkpoint, save_checkpoint

F64 = torch.float64
H = (16, 16)  # hidden widths of the parity tests


def f64(tree):
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), tree)


def np_tree(tree):
    return jax.tree.map(np.array, tree)


def perturbed(tree, seed, scale=0.05):
    """``tree`` plus normal noise: a target network that differs from its
    online one, so that a swap of the two shows."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: x + scale * rng.normal(size=np.shape(x)), tree)


def scaled_head(tree, head="Dense_0", by=30.0):
    """The head's kernel scaled up, so that actions and argmaxes spread."""
    tree = jax.tree.map(lambda x: x, tree)
    tree["params"][head]["kernel"] = tree["params"][head]["kernel"] * by
    return tree


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_trees(got, want, rtol, atol):
    g, w = leaves(got), leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol, err_msg=k)


def grads_tree(module, grads):
    """Gradients in the order of ``module.parameters()`` as a flax tree."""
    return to_flax_tree(dict(zip([k for k, _ in module.named_parameters()], grads)))


def batch(seed, M, n, do, da, discrete):
    """A numpy batch of M transitions: one-hot actions when ``discrete``,
    a quarter of them terminal."""
    rng = np.random.RandomState(seed)
    if discrete:
        action = np.eye(da)[rng.randint(0, da, (M, n))]
    else:
        action = rng.uniform(-1.0, 1.0, (M, n, da))
    return {"obs": rng.uniform(-1.5, 1.5, (M, n, do)), "action": action, "reward": rng.normal(size=(M, n)) - 3.0,
            "next_obs": rng.uniform(-1.5, 1.5, (M, n, do)), "done": rng.uniform(size=M) < 0.25}


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    return {k: torch.as_tensor(v, dtype=torch.bool if k == "done" else F64) for k, v in b.items()}


def jgumbel(key, shape):
    return np.asarray(jax.random.gumbel(key, shape, jnp.float64))


def jnormal(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float64))


def t(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def assert_module(module, tree, rtol=1e-9, atol=1e-9):
    assert_trees(to_flax(module), tree, rtol, atol)


def assert_round_trip(jmodule, inputs, from_flax, stacked=True, **kw):
    """A flax init of ``jmodule`` (stacked over 3 agents by ``vmap``, as the
    JAX learners build it, unless ``stacked`` is False) through
    ``from_flax`` and back by ``to_flax``: the same tree, leaf for leaf.
    Leaves are float32 (under x64 a ``self.param`` of flax's constant init,
    GRUPolicy's ``log_std``, comes out float64 beside the float32 Dense
    parameters)."""
    def init(k):
        return jmodule.init(k, *inputs)

    key = jax.random.PRNGKey(11)
    tree = jax.jit(jax.vmap(init))(jax.random.split(key, 3)) if stacked else jax.jit(init)(key)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
    back = to_flax(from_flax(np_tree(tree), **kw))
    g, w = leaves(back), leaves(tree)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def jstate(state):
    """A port env state as the JAX package's (per-env PRNG keys added; the
    JAX step's own resets are never compared)."""
    st = gt.state_to_numpy(state)
    keys = jax.random.split(jax.random.PRNGKey(0), st["pos"].shape[0])
    return JEnvState(**{k: jnp.asarray(v) for k, v in st.items()}, key=keys)


def f64_episodes(B, n, ep, seed):
    """B envs of ``formation_hd_env`` in float64 with their episode
    counters spread, so that episodes end at different steps."""
    venv = gt.make_vec_env("formation_hd_env", num_envs=B, num_agents=n, device="cpu", seed=seed,
                           episode_length=ep)
    state, _ = venv.reset()
    state = gt.state_from_numpy(gt.state_to_numpy(state), dtype=F64)
    return state.replace(t=torch.arange(B, dtype=torch.int32) % ep)


def replay_collection(talgo, jenv, ts, steps, B, n, ep):
    """``steps`` env steps of the port's collection (from the spread
    episodes of :func:`f64_episodes`) into a fresh buffer, each replayed
    through JAX's ``env.step`` from the port's pre-step state with the
    port's actions: the stored rows (obs, action, reward, next_obs, done)
    against JAX's (1e-9), next_obs the true terminal observation, not the
    next episode's first one.  Returns the buffer."""
    state = f64_episodes(B, n, ep, 2)
    obs = talgo.env.scenario.observe(state)
    pre, step = [], talgo.env.step

    def recording_step(st, actions, generator):
        pre.append((st, actions))
        return step(st, actions, generator)

    talgo.env.step = recording_step
    buf = talgo._buffer()
    g = torch.Generator()
    g.manual_seed(7)
    with torch.no_grad():
        talgo._collect(ts, buf, state, obs, g)
    talgo.env.step = step
    assert len(pre) == steps and buf.size == steps * B
    np.testing.assert_array_equal(buf.obs[:B].numpy(), obs.numpy())
    ended, jstep = 0, jax.jit(jax.vmap(jenv.step))
    for k, (st, actions) in enumerate(pre):
        rows = slice(k * B, (k + 1) * B)
        np.testing.assert_array_equal(buf.action[rows].numpy(), actions.numpy())
        _, out = jstep(jstate(st), jnp.asarray(actions.numpy()))
        done = np.asarray(out.done[:, 0])
        np.testing.assert_allclose(buf.reward[rows].numpy(), np.asarray(out.reward), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(buf.next_obs[rows].numpy(), np.asarray(out.info["terminal_obs"]),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_array_equal(buf.done[rows].numpy(), done)
        if k + 1 < steps:
            nxt = buf.obs[(k + 1) * B:(k + 2) * B].numpy()
            # where no episode ended, the next row's obs is this step's
            np.testing.assert_allclose(nxt[~done], np.asarray(out.obs)[~done], rtol=1e-9, atol=1e-9)
            # where one did, the next row starts the new episode: not next_obs
            for b in np.flatnonzero(done):
                assert not np.allclose(nxt[b], buf.next_obs[rows][b].numpy())
        ended += int(done.sum())
    assert ended >= B  # every env crossed an episode end
    return buf


def checkpoint_round_trip(make, tmp_path, iters=2):
    """Save after ``iters`` iterations, restore into fresh objects, and the
    next iteration equals the uninterrupted run's bit for bit: every
    state leaf, the buffer and the metrics."""
    from gym_formation_tpu_torch.algos.maddpg import _state_tree

    algo, g = make(), torch.Generator()
    g.manual_seed(3)
    state = algo.init(g)
    for _ in range(iters):
        *state, _ = algo.train_step(*state, g)
    save_checkpoint(str(tmp_path), iters, algo.checkpoint_tree(*state, g))
    *state, m = algo.train_step(*state, g)
    algo2, g2 = make(), torch.Generator()
    state2 = algo2.restore_tree(restore_checkpoint(str(tmp_path)), g2)
    *state2, m2 = algo2.train_step(*state2, g2)
    a, b = leaves(_state_tree(state[0])), leaves(_state_tree(state2[0]))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k, v in state[1].state_dict().items():
        w = state2[1].state_dict()[k]
        assert torch.equal(v, w) if isinstance(v, torch.Tensor) else v == w, k
    assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in m2.items()}
    return algo, state


@functools.lru_cache(maxsize=None)
def _jax_ddpg(jcls, jcfg, discrete, B, kw):
    import gym_formation_tpu as ft
    from gym_formation_tpu.algos.maddpg import MADDPGState as JState

    jenv = ft.make_env("formation_hd_env", num_agents=3, discrete_action=discrete)
    jalgo = jcls(jenv, jcfg(**dict(kw)), num_envs=B)
    a, c = f64(jax.jit(jalgo._init_stacked)(jax.random.PRNGKey(0)))
    a = scaled_head(a)
    ta, tc = perturbed(a, 1), perturbed(c, 2)
    cfg = jalgo.cfg
    ts_j = JState(actor_params=a, critic_params=c, target_actor_params=ta, target_critic_params=tc,
                  actor_opt=jalgo.actor_tx.init(a), critic_opt=jalgo.critic_tx.init(c),
                  noise=jnp.asarray(cfg.noise_rate, jnp.float32), epsilon=jnp.asarray(cfg.epsilon, jnp.float32),
                  env_steps=jnp.zeros((), jnp.int32), grad_updates=jnp.zeros((), jnp.int32),
                  ou_state=jnp.zeros((B, 3, jalgo.act_dim)))
    return jalgo, ts_j, np_tree({"actor": a, "critic": c, "target_actor": ta, "target_critic": tc})


def ddpg_pair(jcls, jcfg, tcls, tcfg, discrete=False, B=4, **cfg_kw):
    """A JAX MADDPG-family learner and its state in float64 (head gains up;
    the targets perturbed away from the online networks; built once for
    each configuration), and the port's learner holding the same
    parameters."""
    kw = dict(hidden=H, buffer_size=64, **cfg_kw)
    jalgo, ts_j, params = _jax_ddpg(jcls, jcfg, discrete, B, tuple(sorted(kw.items())))
    talgo = tcls(gt.make_env("formation_hd_env", num_agents=3, discrete_action=discrete), tcfg(**kw), num_envs=B,
                 device="cpu", dtype=F64)
    return jalgo, ts_j, talgo, talgo.state_from_flax(params)


def assert_ddpg_state(ts, ts_j, rtol=1e-9, atol=1e-9):
    for mod, tree in ((ts.actor, ts_j.actor_params), (ts.critic, ts_j.critic_params),
                      (ts.target_actor, ts_j.target_actor_params), (ts.target_critic, ts_j.target_critic_params)):
        assert_module(mod, tree, rtol, atol)


# -- the recurrent (episodic) learners -------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The module's tests on one intra-op thread.  A learner's iteration is
    thousands of small ops, and MKL's threads (``bmm``, ``tanh``) wait for
    each other at every one: on a host whose cores other test workers
    hold, a 30-iteration run took 751 s on the default threads against 6 s
    on one.  Imported by the recurrent learners' test files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


EP_T = 5  # episode length of the recurrent parity tests


def episodes(seed, M, T, n, do, da, discrete):
    """A numpy batch of M episodes of T steps (T+1 observations): one-hot
    actions when ``discrete``."""
    rng = np.random.RandomState(seed)
    action = np.eye(da)[rng.randint(0, da, (M, T, n))] if discrete else rng.uniform(-1.0, 1.0, (M, T, n, da))
    return {"obs": rng.uniform(-1.5, 1.5, (M, T + 1, n, do)), "action": action,
            "reward": rng.normal(size=(M, T, n)) - 3.0}


def jenv_f64(discrete=False, T=EP_T):
    """The JAX package's formation_hd_env in float64 (so that its scanned
    collection keeps one dtype in x64), episodes of T steps."""
    import gym_formation_tpu as ft

    return ft.make_env("formation_hd_env", num_agents=3, episode_length=T, dtype=jnp.float64,
                       discrete_action=discrete)


def step_keys(key, T):
    """The per-step keys of a JAX scan over T steps: ``split(key, T)``."""
    return jax.random.split(key, T)


def per_step(keys, draw):
    """``draw(k)`` for each step key, stacked on axis 1 ([B, T, ...])."""
    return t(np.stack([np.asarray(draw(k)) for k in keys], 1))


def replay_episodes(jalgo, ts_j, talgo, ts, key, draws_of):
    """JAX's ``_collect_episodes(ts_j, key)`` against the port's from the
    same reset states (JAX's, ``split(k_reset, B)``) on the draws
    ``draws_of(k_roll)``: ``obs[:, :T]``, actions and rewards (1e-9); the
    port's ``obs[:, T]`` is the true terminal observation, JAX's
    ``info['terminal_obs']`` of the last step replayed through its
    ``env.step`` from the port's last pre-step state (1e-9), which the
    JAX package's stored ``obs[:, T]`` (the next episode's first) is not.
    Returns the port's episodes."""
    B, T = jalgo.num_envs, jalgo.T
    obs_j, act_j, rew_j, _ = jax.jit(jalgo._collect_episodes)(ts_j, key)
    k_reset, k_roll = jax.random.split(key)
    es_j, obs0_j = jax.vmap(jalgo.env.reset)(jax.random.split(k_reset, B))
    state = gt.state_from_numpy(es_j, dtype=F64)
    obs0 = talgo.env.scenario.observe(state)
    np.testing.assert_allclose(obs0.numpy(), np.asarray(obs0_j), rtol=1e-12, atol=1e-12)
    pre, step = [], talgo.env.step

    def recording_step(st, actions, generator):
        pre.append((st, actions))
        return step(st, actions, generator)

    talgo.env.step = recording_step
    try:
        with torch.no_grad():
            (obs, act, rew), rewards, _ = talgo._collect_episodes(ts, state, obs0, draws_of(k_roll), torch.Generator())
    finally:
        talgo.env.step = step
    assert obs.shape == (B, T + 1, 3, talgo.obs_dim) and len(pre) == len(rewards) == T
    tol = dict(rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(obs[:, :T].numpy(), np.asarray(obs_j[:, :T]), **tol)
    np.testing.assert_allclose(act.numpy(), np.asarray(act_j), **tol)
    np.testing.assert_allclose(rew.numpy(), np.asarray(rew_j), **tol)
    st, actions = pre[-1]
    _, out = jax.jit(jax.vmap(jalgo.env.step))(jstate(st), jnp.asarray(actions.numpy()))
    assert bool(np.all(np.asarray(out.done)))  # every episode ends at step T
    terminal = np.asarray(out.info["terminal_obs"])
    np.testing.assert_allclose(obs[:, T].numpy(), terminal, **tol)
    assert not np.allclose(np.asarray(obs_j[:, T]), terminal, atol=1e-3)
    return obs, act, rew


def assert_ignores_terminal_obs(losses, batch_np, seed=0):
    """``losses(batch)`` → a list of tensors (losses and gradients): the same
    bits when every episode's last observation is replaced."""
    other = dict(batch_np, obs=batch_np["obs"].copy())
    other["obs"][:, -1] = np.random.RandomState(seed).uniform(-5.0, 5.0, other["obs"][:, -1].shape)
    a, b = losses({k: t(v) for k, v in batch_np.items()}), losses({k: t(v) for k, v in other.items()})
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
