"""The port's tensor parallelism (the ``'model'`` axis of the mesh,
``gym_formation_tpu_torch.parallel.tensor``) on the CPU.

- The layout against the JAX package: for each of the 13 learners at N=3
  and MAPPO at N=243, the port cuts exactly the flax leaves that
  ``model_sharding_for_params`` shards on a (4, 2) ``('data', 'model')``
  mesh of the conftest's 8 virtual devices, to the same slice shapes.
- The building blocks in a world of TP=2: a cut ``Dense`` against
  ``nn.Linear`` (output and every gradient), the GRU cells' strided cut
  against the whole cells, a ``ClipAdam`` step under active clipping, a
  state's cut and gather round trip, and the elements each rank holds of
  MAPPO N=243.
- Worlds of TP=2 and DP=2 × TP=2 (``gloo``, ``tests/_torch_tp_worker.py``,
  one launch for both) against the port's single process, in float64:
  MAPPO (autograd with two minibatches; K5 and K9's plain versions on
  gathered weights; structured at N=33 with ``grad_accum``), RMAPPO,
  MADDPG, MASAC, QMIX and RQMIX over their iterations, the other seven
  names for one iteration; and every rank of a model group holding the same
  replicated leaves, bit for bit.
- ``train --mesh 1,2`` and ``--mesh 2,2`` against ``--mesh 1``, their
  checkpoints restored without a mesh and under the other TP mesh (held to
  the ``--mesh 1`` checkpoint's restored iteration) and evaluated; the dry
  run on (2, 2).

Tolerances are those of ``tests/test_torch_parallel.py``: metrics rtol
1e-6, parameters rtol 1e-6 with atol 1e-9 (float64: only the order of the
collectives' sums differs), the fused family's float32 metrics an atol of
1e-7 and the float32 CLI's PPO metrics 1e-6 beside the rtol.
"""

import json
import os
import signal
import subprocess
import sys
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("mappo", "mappo_fused", "mappo_structured", "rmappo", "maddpg", "masac", "qmix", "rqmix")
OTHERS = ("ddpg", "matd3", "vdn", "rmaddpg", "rmatd3", "rmasac", "rvdn")
WORLDS = {"tp2": 2, "dp2tp2": 4}
NAMES = ("mappo", "rmappo", "maddpg", "ddpg", "matd3", "masac", "qmix", "vdn", "rmaddpg", "rmatd3", "rmasac",
         "rqmix", "rvdn")


def start(args):
    """A subprocess in its own session (its ranks included)."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    return subprocess.Popen([sys.executable, *args], cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)


def finish(p, timeout):
    """The CompletedProcess of ``p``, killed whole if it outlives ``timeout``."""
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise
    return subprocess.CompletedProcess(p.args, p.returncode, out, err)


def run_all(chains, timeout=300, parallel=6):
    """``{key: [(name, args), ...]}``: each chain's processes one after the
    other, at most ``parallel`` chains at a time → ``{name:
    CompletedProcess}``."""
    def chain(steps):
        return {name: finish(start(args), timeout) for name, args in steps}

    with ThreadPoolExecutor(parallel) as pool:
        futures = [pool.submit(chain, steps) for steps in chains]
        return {k: v for f in futures for k, v in f.result().items()}


# -- the CLI runs, the worlds and the dry run, launched together --------------------

CLI = {
    "mappo": ["--set", "rollout_len=4", "--set", "ppo_epochs=2", "--set", "num_minibatches=2"],
    "maddpg": ["--set", "buffer_size=256", "--set", "steps_per_iter=4", "--set", "updates_per_iter=2",
               "--set", "batch_size=16"],
}
MESHES = ("1", "1,2", "2,2")
OTHER_MESH = {"1": "1", "1,2": "2,2", "2,2": "1,2"}  # the mesh a checkpoint is restored under


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worker (W=1, TP=2 and DP=2 × TP=2), ``train --mesh`` 1, 1,2 and
    2,2 for mappo and maddpg (8 envs, 2 iterations, a checkpoint at the
    end) and the dry run on 4 ranks; then each TP checkpoint restored for
    one more iteration without ``--mesh`` and under the other TP mesh, and
    evaluated; the ``--mesh 1`` checkpoint restored under ``--mesh 1``."""
    root = tmp_path_factory.mktemp("tp")
    chains = [[(w, ["tests/_torch_tp_worker.py", str(root), w])] for w in ("dp2tp2", "tp2", "w1")]
    for algo, extra in CLI.items():
        for mesh in MESHES:
            d = root / f"{algo}_{mesh}"
            steps = [((algo, mesh), ["-m", "gym_formation_tpu_torch.train", "--algo", algo, "--device", "cpu",
                                     "--mesh", mesh, "--num-envs", "8", "--iters", "2", "--log-every", "1",
                                     "--save-every", "2", "--run-dir", str(d), *extra])]
            restore = ["-m", "gym_formation_tpu_torch.train", "--algo", algo, "--device", "cpu", "--num-envs",
                       "8", "--iters", "1", "--save-every", "0", "--restore", "--run-dir", str(d), *extra]
            if mesh != "1":
                steps += [((algo, mesh, "restore"), restore)]
            steps += [((algo, mesh, "restore_mesh"), [*restore, "--mesh", OTHER_MESH[mesh]])]
            if mesh != "1":
                steps += [((algo, mesh, "eval"), ["-m", "gym_formation_tpu_torch.eval", "--policy", "ckpt", "--algo",
                                                  algo, "--ckpt", str(d / "ckpt"), "--episodes", "1", "--device",
                                                  "cpu"])]
            chains.append(steps)
    chains.append([("dryrun", ["-m", "gym_formation_tpu_torch.graft_entry", "4", "--device", "cpu"])])
    out = run_all(chains)
    out["root"] = root
    return out


@pytest.fixture(scope="module")
def worlds(runs):
    for w in ("w1", *WORLDS):
        assert runs[w].returncode == 0, runs[w].stderr[-3000:]
    load = lambda f: torch.load(runs["root"] / f, weights_only=False)
    return {"w1": load("w1.pt"), **{w: [load(f"{w}_rank{r}.pt") for r in range(n)] for w, n in WORLDS.items()}}


# -- (a) the layout against the JAX package -------------------------------------------

LAYOUT_SETS = {"maddpg": ["buffer_size=64"], "ddpg": ["buffer_size=64"], "matd3": ["buffer_size=64"],
               "masac": ["buffer_size=64"], "qmix": ["buffer_size=64"], "vdn": ["buffer_size=64"],
               "rmaddpg": ["buffer_episodes=8"], "rmatd3": ["buffer_episodes=8"], "rmasac": ["buffer_episodes=8"],
               "rqmix": ["buffer_episodes=8"], "rvdn": ["buffer_episodes=8"]}


class _Rank0Of2:
    """The three methods of a (4, 2) ``('data', 'model')`` DeviceMesh that
    cutting a state reads, at model index 0 (no process group)."""

    mesh_dim_names = ("data", "model")

    def size(self, dim=0):
        return (4, 2)[dim]

    def get_local_rank(self, name):
        return 0


def _paths(tree, prefix=()):
    """The leaves of nested mappings and lists by path (the ``params``
    level dropped)."""
    if isinstance(tree, (list, tuple)):
        tree = dict(enumerate(tree))
    if not isinstance(tree, Mapping):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_paths(v, prefix if k == "params" else prefix + (k,)))
    return out


def jax_layout(name, n):
    """path → (whole shape, shard shape) of every leaf of the JAX learner's
    parameter fields under ``model_sharding_for_params``, the path led by
    the port's field name (``params``' actor and critic; ``<x>_params`` →
    x)."""
    import gym_formation_tpu as ft
    from gym_formation_tpu.algos.registry import DISCRETE_ONLY, make_algo
    from gym_formation_tpu.parallel import make_mesh, model_sharding_for_params
    from gym_formation_tpu.parallel.mesh import _PARAM_FIELDS

    env = ft.make_env("formation_hd_env", num_agents=n, discrete_action=name in DISCRETE_ONLY)
    algo = make_algo(name, env, num_envs=8, sets=LAYOUT_SETS.get(name, []))
    ts = jax.eval_shape(lambda k: algo.init(k)[0], jax.random.PRNGKey(0))
    mesh = make_mesh((4, 2), ("data", "model"))
    out = {}
    for field in _PARAM_FIELDS:
        tree = getattr(ts, field, None)
        if not tree:
            continue
        shard = model_sharding_for_params(tree, mesh)
        named = tree if field == "params" else {field[:-len("_params")]: tree}
        shards = shard if field == "params" else {field[:-len("_params")]: shard}
        leaves, specs = _paths(named), _paths(shards)
        out.update({p: (tuple(x.shape), tuple(specs[p].shard_shape(x.shape))) for p, x in leaves.items()})
    return out


def port_layout(name, n):
    """The same for the port's learner: each network's flax leaves before
    and after :func:`shard_params_` at model index 0 of 2."""
    import gym_formation_tpu_torch as gt
    from gym_formation_tpu_torch.algos import DISCRETE_ONLY, make_algo
    from gym_formation_tpu_torch.models.networks import to_flax
    from gym_formation_tpu_torch.parallel import tensor

    env = gt.make_env("formation_hd_env", num_agents=n, discrete_action=name in DISCRETE_ONLY)
    algo = make_algo(name, env, 8, LAYOUT_SETS.get(name, []), device="cpu")
    ts = algo.init(torch.Generator().manual_seed(0))[0]
    shapes = lambda: {(f,) + p: a.shape for f, m in tensor._modules(ts).items()
                      for p, a in _paths(to_flax(m)).items()}
    whole = shapes()
    tensor.shard_params_(ts, _Rank0Of2())
    return {p: (whole[p], s) for p, s in shapes().items()}, ts


@pytest.mark.parametrize("name,n", [(name, 3) for name in NAMES] + [("mappo", 243)])
def test_layout_equals_jax(name, n):
    want = jax_layout(name, n)
    got, ts = port_layout(name, n)
    assert got.keys() == want.keys()
    cut = lambda d: sorted(p for p, (whole, part) in d.items() if whole != part)
    assert cut(got) == cut(want)
    assert got == want
    # every Adam state of the learner is named with its parameters, and
    # each cut leaf's moments are cut alike
    import dataclasses

    from gym_formation_tpu_torch.algos.optim import AdamState

    adam = ts.adam_params()
    assert sorted(adam) == sorted(f.name for f in dataclasses.fields(ts) if isinstance(getattr(ts, f.name), AdamState))
    for st_name, params in adam.items():
        st = getattr(ts, st_name)
        for p, m, v in zip(params, st.mu, st.nu, strict=True):
            assert m.shape == v.shape == p.shape


# -- (b), (c) the building blocks in the TP=2 world ------------------------------------

@pytest.mark.parametrize("block", ["dense", "gru", "stacked_gru"])
def test_cut_layers_equal_whole(worlds, block):
    """Output, input gradients and every parameter gradient (the rank's
    slice) of the cut layer against the whole one, on both ranks."""
    for r in worlds["tp2"]:
        assert r["blocks"][block] < 1e-12, r["blocks"][block]
    assert worlds["tp2"][0]["blocks"]["dense_cut"] == [True, False]  # the weight cut, the bias whole


def test_gru_cuts_each_gate():
    """The strided cut: rank r holds rows ``g·H + [r·H/2, (r+1)·H/2)`` of
    each gate g; a stacked cell's biases alike, an unstacked cell's whole."""
    from gym_formation_tpu_torch.parallel.tensor import Cut

    H = 4
    w = torch.arange(3 * H * 2, dtype=torch.float64).reshape(3 * H, 2)
    mesh = _Rank0Of2()
    want = torch.cat([w[g * H:g * H + H // 2] for g in range(3)])
    assert torch.equal(Cut(mesh, 0, 3).local(w), want)
    stacked = w.T[None].expand(3, 2, 3 * H)
    assert torch.equal(Cut(mesh, 2, 3).local(stacked), want.T[None].expand(3, 2, 3 * H // 2))


def test_gru_local_shapes(worlds):
    b = worlds["tp2"][0]["blocks"]
    assert b["gru_local"] == {"weight_ih": (12, 6), "weight_hh": (12, 8), "bias_ih": (24,), "bias_hn": (8,)}
    assert b["stacked_gru_local"] == {"weight_ih": (4, 12, 6), "weight_hh": (4, 12, 8), "bias_ih": (4, 12),
                                      "bias_hn": (4, 4)}


def test_clip_adam_under_active_clipping_equals_whole(worlds):
    for r in worlds["tp2"]:
        assert r["blocks"]["clip_active"]
        assert r["blocks"]["clip_adam"] < 1e-15, r["blocks"]["clip_adam"]


def test_state_cut_and_gather_round_trip(worlds):
    for r in worlds["tp2"]:
        assert r["blocks"]["round_trip"] and r["blocks"]["moments_cut"]


def test_n243_rank_holds_half(worlds):
    """MAPPO N=243 at TP=2: 11,388,549 parameter elements a rank against
    22,776,773 whole (the critic's first kernel, 22,674,816 of them, cut in
    two), and the moments likewise."""
    for r in worlds["tp2"]:
        h = r["n243"]
        assert h["whole"] == (22_776_773, 2 * 22_776_773)
        assert h["local"] == (11_388_549, 2 * 11_388_549)
        assert h["bytes"] == {"params": 4 * 11_388_549, "moments": 8 * 11_388_549}


# -- (d) the worlds against one process ---------------------------------------------

CASES = [(w, f) for w in WORLDS for f in FAMILIES]


@pytest.mark.parametrize("world,family", CASES)
def test_metrics_equal_w1(worlds, world, family):
    w1, r0 = worlds["w1"][family], worlds[world][0][family]
    atol = 1e-7 if family == "mappo_fused" else 0.0
    assert len(w1["metrics"]) == len(r0["metrics"])
    for m1, m2 in zip(w1["metrics"], r0["metrics"]):
        assert m1.keys() == m2.keys()
        for k in m1:
            np.testing.assert_allclose(m2[k], m1[k], rtol=1e-6, atol=atol, err_msg=k)


@pytest.mark.parametrize("world,family", CASES + [(w, f) for w in WORLDS for f in OTHERS])
def test_params_equal_w1(worlds, world, family):
    """The gathered parameters (online and target networks) of every rank
    against the single process's; at least one leaf is cut."""
    w1 = worlds["w1"][family]
    for rank in worlds[world]:
        assert any(rank[family]["cut"])
        for a, b in zip(w1["params"], rank[family]["params"], strict=True):
            torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("world,family", [(w, f) for w in WORLDS for f in OTHERS])
def test_other_names_one_iteration(worlds, world, family):
    w1, r0 = worlds["w1"][family], worlds[world][0][family]
    for k in w1["metrics"][0]:
        np.testing.assert_allclose(r0["metrics"][0][k], w1["metrics"][0][k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("world,family", CASES)
def test_model_ranks_agree_on_replicated_leaves(worlds, world, family):
    """The ranks of a model group hold the same replicated leaves bit for
    bit, and the slices of a cut one differ."""
    ranks = worlds[world]
    for first in range(0, len(ranks), 2):
        a, b = ranks[first][family], ranks[first + 1][family]
        assert ranks[first]["coords"][0] == ranks[first + 1]["coords"][0]
        for x, y, cut in zip(a["local"], b["local"], a["cut"], strict=True):
            if not cut:
                assert torch.equal(x, y)
        assert any(not torch.equal(x, y) for x, y, cut in zip(a["local"], b["local"], a["cut"]) if cut)


# -- (e), (f) the entry points ---------------------------------------------------------

def _rows(runs, algo, mesh):
    r = runs[algo, mesh]
    assert r.returncode == 0, r.stderr[-3000:]
    return r, [json.loads(line) for line in open(runs["root"] / f"{algo}_{mesh}" / "metrics.jsonl")]


@pytest.mark.parametrize("algo,mesh", [(a, m) for a in CLI for m in MESHES[1:]])
def test_train_mesh_tp_cli_equals_mesh_1(runs, algo, mesh):
    _, want = _rows(runs, algo, "1")
    r, got = _rows(runs, algo, mesh)
    dp_size, tp_size = (int(x) for x in mesh.split(","))
    assert f"mesh: {{'data': {dp_size}, 'model': {tp_size}}} over {dp_size * tp_size} devices" in r.stdout
    assert "model all_gather" in r.stdout
    assert len(want) == 3  # two iterations, then the restored third
    atol = 1e-6 if algo == "mappo" else 0.0  # float32 PPO losses: differences of nearly equal sums
    for a, b in zip(want[:2], got[:2], strict=True):
        assert a.keys() == b.keys()
        for k in a:
            if k != "wall":
                np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=atol, err_msg=k)


@pytest.mark.parametrize("algo,mesh", [(a, m) for a in CLI for m in MESHES[1:]])
def test_tp_checkpoint_is_whole_restores_unsharded_and_evaluates(runs, algo, mesh):
    load = lambda m: torch.load(runs["root"] / f"{algo}_{m}" / "ckpt" / "2.pt", weights_only=False)
    got, want = load(mesh), load("1")
    flat = lambda t: {k: v.shape for k, v in _paths(t).items() if isinstance(v, torch.Tensor)}
    nets = ("actor", "critic", "adam") if algo == "mappo" else ("state",)
    for key in nets:
        assert flat(got[key]) == flat(want[key]), key
    r = runs[algo, mesh, "restore"]
    assert r.returncode == 0, r.stderr[-3000:]
    assert "restored checkpoint at iteration 2" in r.stdout and "mesh:" not in r.stdout
    r = runs[algo, mesh, "eval"]
    assert r.returncode == 0, r.stderr[-3000:]
    assert "return" in r.stdout.lower()


@pytest.mark.parametrize("algo,mesh", [(a, m) for a in CLI for m in MESHES[1:]])
def test_tp_checkpoint_restores_under_another_mesh(runs, algo, mesh):
    """A TP run's checkpoint, restored without a mesh and under the other
    TP mesh, runs its third iteration as the ``--mesh 1`` checkpoint
    restored under ``--mesh 1`` does."""
    for key in ((algo, "1", "restore_mesh"), (algo, mesh, "restore"), (algo, mesh, "restore_mesh")):
        assert runs[key].returncode == 0, runs[key].stderr[-3000:]
        assert "restored checkpoint at iteration 2" in runs[key].stdout
    other = OTHER_MESH[mesh]
    dp_size, tp_size = (int(x) for x in other.split(","))
    assert f"mesh: {{'data': {dp_size}, 'model': {tp_size}}}" in runs[algo, mesh, "restore_mesh"].stdout
    # the restored whole state is cut to the rank's slices as a fresh one is
    held = lambda r: [line for line in r.stdout.splitlines() if line.startswith("held a rank:")]
    assert held(runs[algo, mesh, "restore_mesh"]) == held(runs[algo, other]) != []
    _, (*_, want) = _rows(runs, algo, "1")
    _, got = _rows(runs, algo, mesh)
    assert len(got) == 4  # two iterations, then a third without a mesh and under the other mesh
    atol = 1e-6 if algo == "mappo" else 0.0
    for row in got[2:]:
        assert row["step"] == want["step"] and row.keys() == want.keys()
        for k in want:
            if k != "wall":
                np.testing.assert_allclose(row[k], want[k], rtol=1e-6, atol=atol, err_msg=k)


def test_dryrun_multichip_on_two_by_two(runs):
    r = runs["dryrun"]
    assert r.returncode == 0, r.stderr[-3000:]
    for label in ("mappo", "maddpg", "mappo-n243-structured"):
        assert f"dryrun_multichip {label} ok: mesh={{'data': 2, 'model': 2}}" in r.stdout


# -- (g) --------------------------------------------------------------------------------

def test_new_modules_import_no_jax():
    r = finish(start(["-c", "import sys\n"
                            "import gym_formation_tpu_torch.parallel.tensor, gym_formation_tpu_torch.graft_entry\n"
                            "import gym_formation_tpu_torch.train, gym_formation_tpu_torch.models.structured_obs\n"
                            "assert not any(m == 'jax' or m.startswith(('jax.', 'gym_formation_tpu.')) "
                            "or m == 'gym_formation_tpu' for m in sys.modules), sorted(sys.modules)\n"]), 120)
    assert r.returncode == 0, r.stderr[-3000:]
