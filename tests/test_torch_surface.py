"""The port's user-facing surface against the JAX package's:
``get_action_BFS``, ``make_receptor_locations``, ``InteractivePolicy``,
``Throughput``, ``assert_finite``, ``trace``, and the ``demo`` and ``eval``
entry points with ``--gif`` (the interactive demo loop headless on Agg)."""

import argparse
import glob
import importlib.util
import itertools
import os
import subprocess
import sys

import imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_formation_tpu as ft
from gym_formation_tpu import compat as jcompat
from gym_formation_tpu.env import make_receptor_locations as jreceptors
from gym_formation_tpu.policy import InteractivePolicy as JInteractivePolicy
from gym_formation_tpu.utils import profiling as jprof

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch import compat as tcompat
from gym_formation_tpu_torch import demo as tdemo
from gym_formation_tpu_torch import eval as teval
from gym_formation_tpu_torch.env import make_receptor_locations
from gym_formation_tpu_torch.policy import InteractivePolicy
from gym_formation_tpu_torch.utils import Throughput, assert_finite, named_scope, trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# left out of the port on purpose (ROADMAP Queue 1): the batch axis is
# bfs_actions' own, the sharded rollout waits for parallel/, and the
# compilation cache is JAX's
LEFT_OUT = {"bfs_actions_batched", "rollout_statepolicy_fused_sharded", "enable_compilation_cache"}


@pytest.mark.parametrize("module", ["", ".render", ".compat", ".utils", ".models", ".envs", ".algos", ".core",
                                    ".wrappers", ".policy", ".utils.profiling"])
def test_public_names_have_counterparts(module):
    """Every public name of a JAX module (its ``__all__``, or the names it
    defines) exists in the port's module of the same name."""
    jmod = importlib.import_module("gym_formation_tpu" + module)
    tmod = importlib.import_module("gym_formation_tpu_torch" + module)
    names = getattr(jmod, "__all__", None) or [
        n for n in dir(jmod) if not n.startswith("_")
        and getattr(getattr(jmod, n), "__module__", "") == jmod.__name__]
    assert names
    assert sorted(set(names) - set(dir(tmod)) - LEFT_OUT) == []


def _obs_rows(n, seed):
    """The N per-agent observations of one host_reset formation_hd state,
    in float64 (the same rows in both packages)."""
    scen = gt.make_scenario("formation_hd_env", num_agents=n, dtype=torch.float64)
    st = tcompat.host_reset(scen, seed, device="cpu")
    jscen = ft.make_scenario("formation_hd_env", num_agents=n, dtype=jnp.float64)
    jrows = np.asarray(jscen.observe(jscen.pre_obs(jcompat.host_reset(jscen, seed))))
    rows = scen.observe(scen.pre_obs(st))[0].numpy()
    np.testing.assert_allclose(rows, jrows, rtol=1e-12, atol=1e-12)
    return list(rows)


@pytest.mark.parametrize("layers", [1, 2])
def test_get_action_bfs_matches_jax(layers):
    obs = _obs_rows(3 ** layers, layers)
    want = ft.get_action_BFS(ft.ezpolicy, obs, 3)
    got = gt.get_action_BFS(gt.ezpolicy, obs, 3, device="cpu")
    assert isinstance(got, list) and len(got) == 3 ** layers
    assert all(isinstance(a, np.ndarray) and a.shape == (2,) and a.dtype == np.float64 for a in got)
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=1e-12, atol=1e-12)
    # a policy that returns numpy rows
    numpy_policy = lambda row: gt.ezpolicy(row).numpy()
    np.testing.assert_allclose(np.stack(gt.get_action_BFS(numpy_policy, obs, 3, device="cpu")), np.stack(got))


def test_get_action_bfs_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        gt.get_action_BFS(gt.ezpolicy, _obs_rows(3, 0), 3)


@pytest.mark.parametrize("kind", ["polar", "grid"])
def test_receptor_locations_match_jax(kind):
    got = make_receptor_locations(kind)
    assert got.shape == (25, 2)
    np.testing.assert_array_equal(got, jreceptors(kind))


def test_receptor_locations_refuse_an_unknown_layout():
    with pytest.raises(ValueError, match="hex"):
        make_receptor_locations("hex")


def test_interactive_policy_matches_jax_for_every_held_key_set():
    for held in itertools.product([False, True], repeat=4):
        for dim_c in (0, 2):
            tp, jp = InteractivePolicy(dim_c), JInteractivePolicy(dim_c)
            tp.move, jp.move = list(held), list(held)
            np.testing.assert_array_equal(tp.action(), jp.action())
    # the key handlers: press, then release
    pol = InteractivePolicy(0)
    pol._on_press(argparse.Namespace(key="left"))
    pol._on_press(argparse.Namespace(key="up"))
    pol._on_press(argparse.Namespace(key="q"))  # not an arrow: ignored
    np.testing.assert_array_equal(pol.action(), [0, 1, 0, 0, 1])
    pol._on_release(argparse.Namespace(key="left"))
    pol._on_release(argparse.Namespace(key="up"))
    np.testing.assert_array_equal(pol.action(), [1, 0, 0, 0, 0])


def test_throughput_matches_jax_under_one_clock(monkeypatch):
    times = [0.0, 0.5, 1.25, 2.0, 2.5, 4.0, 4.25, 5.0, 7.5, 8.0]
    reports = []
    for cls in (jprof.Throughput, Throughput):
        clock = iter(times)
        monkeypatch.setattr("time.perf_counter", lambda: next(clock))
        tp = cls(report_every=3)
        reports.append(([tp.tick(64 * (k + 1)) for k in range(len(times))], tp.last_rate))
    assert reports[0] == reports[1]
    # the first tick starts the clock; a report every 3 ticks after it
    assert [r for r in reports[1][0] if r is not None] == [(128 + 192 + 256) / 2.0, (320 + 384 + 448) / 2.25,
                                                          (512 + 576 + 640) / 3.75]


def test_assert_finite_names_the_same_leaves_as_jax():
    jscen = ft.make_scenario("formation_hd_env", num_agents=3, dtype=jnp.float64)
    tscen = gt.make_scenario("formation_hd_env", num_agents=3, dtype=torch.float64)
    jst, tst = jcompat.host_reset(jscen, 2), tcompat.host_reset(tscen, 2, device="cpu")
    jax_tree = {"b": [np.array([1.0, np.nan]), 2.0, np.array([1, 2])], "a": jst.replace(vel=jst.vel.at[1, 0].set(np.inf))}
    vel = tst.vel.clone()
    vel[0, 1, 0] = float("inf")
    port_tree = {"b": [torch.tensor([1.0, float("nan")]), 2.0, torch.tensor([1, 2])], "a": tst.replace(vel=vel)}
    with pytest.raises(FloatingPointError) as want:
        jprof.assert_finite(jax_tree, "tree")
    with pytest.raises(FloatingPointError) as got:
        assert_finite(port_tree, "tree")
    assert str(got.value) == str(want.value) == "non-finite values in tree: [\"['a'].vel\", \"['b'][0]\"]"
    with pytest.raises(FloatingPointError, match=r"\['\.vel'\]"):
        assert_finite(tst.replace(vel=vel))
    assert_finite(tst)  # all finite: no raise
    jprof.assert_finite(jst)


def test_trace_on_the_cpu_writes_a_trace_with_the_scope(tmp_path):
    env = gt.make_env("formation_hd_env", num_agents=3)
    g = torch.Generator()
    g.manual_seed(0)
    state, obs = env.reset(g, 2)
    with trace(str(tmp_path)):
        with named_scope("formation_step"):
            env.step(state, gt.ezpolicy_batched(obs), g)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        text = f.read()
    assert '"formation_step"' in text and "traceEvents" in text


def test_demo_interactive_loop_headless():
    import matplotlib

    matplotlib.use("Agg")
    env = gt.make_env("formation_hd_env", num_agents=3, auto_reset=False, episode_length=2)
    g = torch.Generator()
    g.manual_seed(0)
    tdemo.run_interactive(env, argparse.Namespace(steps=3), g)


def test_demo_writes_a_gif(tmp_path, capsys):
    path = str(tmp_path / "demo.gif")
    tdemo.main(["--device", "cpu", "--steps", "5", "--gif", path, "--num-layer", "2"])
    out = capsys.readouterr().out
    assert "9 agents, 5 steps" in out and f"gif → {path}" in out
    frames = imageio.mimread(path)
    assert len(frames) == 5 and np.asarray(frames[0]).shape[:2] == (350, 350)
    tdemo.main(["--device", "cpu", "--steps", "3", "-r", "-s", "basic_formation_env"])
    assert "basic_formation_env: 3 agents, 3 steps" in capsys.readouterr().out


def _root_eval(argv, monkeypatch):
    """Root ``eval.py`` (the JAX package's) in this process."""
    spec = importlib.util.spec_from_file_location("root_eval", os.path.join(REPO, "eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["eval.py"] + argv)
    mod.main()


def test_eval_gif_per_agent_view_frames_match_root_eval(tmp_path, monkeypatch):
    args = ["--episodes", "2", "--episode-length", "3", "--per-agent-view"]
    tpath, jpath = str(tmp_path / "port.gif"), str(tmp_path / "jax.gif")
    teval.main(["--device", "cpu", "--gif", tpath] + args)
    _root_eval(["--gif", jpath] + args, monkeypatch)
    got, want = imageio.mimread(tpath), imageio.mimread(jpath)
    assert len(got) == len(want) == 6  # a frame a step
    # three agents' views of 233 px tiled 2 x 2
    assert np.asarray(got[0]).shape[:2] == np.asarray(want[0]).shape[:2] == (466, 466)


def test_surface_imports_no_jax_and_keeps_optional_packages_lazy():
    """The surface's modules import neither JAX nor the JAX package, and
    leave imageio and matplotlib (absent on the card machine) to the calls
    that need them."""
    code = (
        "import sys, gym_formation_tpu_torch.demo, gym_formation_tpu_torch.eval, gym_formation_tpu_torch.render,"
        " gym_formation_tpu_torch.compat, gym_formation_tpu_torch.policy, gym_formation_tpu_torch.wrappers,"
        " gym_formation_tpu_torch.utils.profiling, gym_formation_tpu_torch.examples.dqn_cartpole;"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'orbax', 'gym_formation_tpu',"
        " 'imageio', 'matplotlib')];"
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
