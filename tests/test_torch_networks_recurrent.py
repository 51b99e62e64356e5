"""The port's categorical and recurrent networks against flax, on the same
parameters (carried over by the converters) and the same numpy inputs, in
float64: ``LogitsActor`` and the categorical ops, ``GRUPolicy`` (both heads)
and ``GRUCritic`` over 6 steps with resets in between (1e-10), the
per-agent stacked actor and critic, and the converters' round trips."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_formation_tpu.models import networks as jn

from gym_formation_tpu_torch.models import networks as tn

F64 = torch.float64
TOL = dict(rtol=1e-10, atol=1e-10)


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


def _assert_tree_equal(got, want):
    g = jax.tree_util.tree_flatten_with_path(got)[0]
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [jax.tree_util.keystr(p) for p, _ in g] == [jax.tree_util.keystr(p) for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=jax.tree_util.keystr(p))


def test_logits_actor_and_categorical_ops():
    rng = np.random.RandomState(0)
    m = jn.LogitsActor(5, (32, 32))
    p = _f64(m.init(jax.random.PRNGKey(1), jnp.zeros((1, 18))))
    p["params"]["Dense_0"]["kernel"] *= 300.0  # logits of order 1, so the ops see spread
    t = tn.logits_actor_from_flax(p, F64)
    _assert_tree_equal(tn.to_flax(t), p)
    obs = rng.uniform(-1.5, 1.5, (7, 3, 18))
    lj = m.apply(p, jnp.asarray(obs))
    with torch.no_grad():
        lt = t(torch.as_tensor(obs))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    onehot = np.eye(5)[rng.randint(0, 5, (7, 3))]
    pairs = ((tn.categorical_logp(lt, torch.as_tensor(onehot)), jn.categorical_logp(lj, jnp.asarray(onehot))),
             (tn.categorical_entropy(lt), jn.categorical_entropy(lj)),
             (tn.onehot_from_logits(lt), jn.onehot_from_logits(lj)))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_categorical_sample_is_a_onehot_draw_of_softmax():
    """Exact one-hots, reproducible from the generator's state, with
    frequencies of softmax(logits) (20,000 draws: 4 standard errors)."""
    logits = torch.tensor([0.3, -1.0, 1.2, 0.0, -0.5], dtype=F64)
    g = torch.Generator()
    g.manual_seed(5)
    a = tn.categorical_sample(g, logits.expand(20000, 5))
    assert set(a.unique().tolist()) == {0.0, 1.0} and torch.equal(a.sum(-1), torch.ones(20000, dtype=F64))
    p = torch.softmax(logits, -1)
    assert torch.all((a.mean(0) - p).abs() <= 4 * torch.sqrt(p * (1 - p) / 20000))
    g.manual_seed(5)
    assert torch.equal(tn.categorical_sample(g, logits.expand(20000, 5)), a)


def _unroll(jmod, jp, tmod, in_dim, B, lead, seed):
    """6 steps of a recurrent core on both sides, with resets at step 0 and
    at random (env, step) pairs; the carries and outputs compared each step."""
    rng = np.random.RandomState(seed)
    H = tmod.hidden
    hj = jnp.asarray(rng.normal(size=lead + (H,)))
    ht = torch.as_tensor(np.array(hj))
    for s in range(6):
        x = rng.uniform(-1.5, 1.5, lead + (in_dim,))
        reset = np.ones(lead, bool) if s == 0 else rng.uniform(size=lead) < 0.3
        hj, out_j = jmod.apply(jp, hj, jnp.asarray(x), jnp.asarray(reset))
        with torch.no_grad():
            ht, out_t = tmod(ht, torch.as_tensor(x), torch.as_tensor(reset))
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
        for got, want in zip(jax.tree.leaves(out_t), jax.tree.leaves(out_j)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("discrete", [False, True])
def test_gru_policy_matches_flax(discrete):
    m = jn.GRUPolicy(5 if discrete else 2, 16, discrete=discrete)
    p = _f64(m.init(jax.random.PRNGKey(2), jnp.zeros((1, 16)), jnp.zeros((1, 18)), jnp.zeros((1,), bool)))
    if not discrete:
        p["params"]["log_std"] = np.array([-0.4, 0.3])
    t = tn.gru_policy_from_flax(p, F64)
    assert t.discrete == discrete
    _assert_tree_equal(tn.to_flax(t), p)
    _unroll(m, p, t, 18, 4, (4, 3), 3)


def test_gru_critic_matches_flax():
    m = jn.GRUCritic(16)
    p = _f64(m.init(jax.random.PRNGKey(3), jnp.zeros((1, 16)), jnp.zeros((1, 54)), jnp.zeros((1,), bool)))
    t = tn.gru_critic_from_flax(p, F64)
    _assert_tree_equal(tn.to_flax(t), p)
    _unroll(m, p, t, 54, 5, (5,), 4)


def test_gru_cell_is_torch_gru_cell_with_zero_rz_hidden_bias():
    """The layout claim: torch.nn.GRUCell with the port's weights, bias_hh's
    r and z thirds zero and its n third the port's bias_hn, is the same
    function."""
    g = torch.Generator()
    g.manual_seed(0)
    cell = tn.GRUCell(7, 8, generator=g).to(F64)
    with torch.no_grad():
        cell.bias_ih.normal_(generator=g)
        cell.bias_hn.normal_(generator=g)
        ref = torch.nn.GRUCell(7, 8).to(F64)
        ref.weight_ih.copy_(cell.weight_ih)
        ref.weight_hh.copy_(cell.weight_hh)
        ref.bias_ih.copy_(cell.bias_ih)
        ref.bias_hh.copy_(torch.cat([torch.zeros(16, dtype=F64), cell.bias_hn]))
        x, h = torch.randn(4, 7, generator=g, dtype=F64), torch.randn(4, 8, generator=g, dtype=F64)
        torch.testing.assert_close(cell(h, x), ref(x, h), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("discrete", [False, True])
def test_stacked_networks_match_vmapped_flax(discrete):
    """share_policy=False: the per-agent actors and critics the JAX package
    vmaps over stacked parameters, as one batched product each."""
    n, do = 3, 18
    actor = jn.LogitsActor(5, (32, 32)) if discrete else jn.GaussianActor(2, (32, 32))
    critic = jn.ValueCritic((32, 32))
    keys = jax.random.split(jax.random.PRNGKey(4), n)
    pa = _f64(jax.vmap(lambda k: actor.init(k, jnp.zeros((1, do))))(keys))
    pc = _f64(jax.vmap(lambda k: critic.init(k, jnp.zeros((1, do * n))))(keys))
    pa["params"]["Dense_0"]["kernel"] *= 100.0
    ta, tc = tn.stacked_actor_from_flax(pa, F64), tn.stacked_critic_from_flax(pc, F64)
    assert ta.discrete == discrete
    _assert_tree_equal(tn.to_flax(ta), pa)
    _assert_tree_equal(tn.to_flax(tc), pc)
    obs = np.random.RandomState(5).uniform(-1.5, 1.5, (6, n, do))
    dist_j = jax.vmap(actor.apply, in_axes=(0, -2), out_axes=-2)(pa, jnp.asarray(obs))
    v_j = jnp.moveaxis(jax.vmap(lambda p: critic.apply(p, jnp.asarray(obs.reshape(6, -1))))(pc), 0, -1)
    with torch.no_grad():
        dist_t = ta(torch.as_tensor(obs))
        v_t = tc(torch.as_tensor(obs.reshape(6, -1)))
    for got, want in zip(jax.tree.leaves(dist_t), jax.tree.leaves(dist_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert v_t.shape == (6, n)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), **TOL)


def test_converters_round_trip_from_torch():
    """Port module → flax tree → port module: every parameter equal, for
    each network kind the converters take."""
    g = torch.Generator()
    g.manual_seed(1)
    cases = [
        (tn.GaussianActor(18, 2, (16, 16), generator=g), tn.actor_from_flax),
        (tn.ValueCritic(54, (16, 16), generator=g), tn.critic_from_flax),
        (tn.LogitsActor(18, 5, (16, 16), generator=g), tn.logits_actor_from_flax),
        (tn.StackedActor(3, 18, 2, (16, 16), generator=g), tn.stacked_actor_from_flax),
        (tn.StackedActor(3, 18, 5, (16, 16), discrete=True, generator=g), tn.stacked_actor_from_flax),
        (tn.StackedValueCritic(3, 54, (16, 16), generator=g), tn.stacked_critic_from_flax),
        (tn.GRUPolicy(18, 2, 16, generator=g), tn.gru_policy_from_flax),
        (tn.GRUPolicy(18, 5, 16, discrete=True, generator=g), tn.gru_policy_from_flax),
        (tn.GRUCritic(54, 16, generator=g), tn.gru_critic_from_flax),
    ]
    for module, from_flax in cases:
        with torch.no_grad():
            for p in module.parameters():
                p.add_(torch.randn(p.shape, generator=g))  # every leaf nonzero, biases too
        back = from_flax(tn.to_flax(module))
        assert type(back) is type(module)
        got, want = dict(back.named_parameters()), dict(module.named_parameters())
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (type(module).__name__, k)
