"""The port's renderer against the JAX package's: ``render_state``,
``render_state_per_agent`` and ``tile_images`` give the same frames bit for
bit from the same ``host_reset`` state, for all five scenarios (the obs
scenario's green targets and obstacles included), and ``save_gif`` writes a
GIF that ``imageio`` reads back as the same frames."""

import imageio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_formation_tpu as ft
from gym_formation_tpu import compat as jcompat
from gym_formation_tpu import render as jrender

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch import compat as tcompat
from gym_formation_tpu_torch import render as trender

SCENARIOS = [("formation_hd_env", 4), ("basic_formation_env", 3), ("formation_hd_partial_env", 5),
             ("formation_hd_partial_range_env", 5), ("formation_hd_obs_env", 4)]


def pair(name, n, seed=3):
    jscen = ft.make_scenario(name, num_agents=n, dtype=jnp.float64)
    tscen = gt.make_scenario(name, num_agents=n, dtype=torch.float64)
    return jscen, jcompat.host_reset(jscen, seed), tscen, tcompat.host_reset(tscen, seed, device="cpu")


@pytest.mark.parametrize("name,n", SCENARIOS)
def test_frames_equal_jax_bit_for_bit(name, n):
    jscen, jst, tscen, tst = pair(name, n)
    want = jrender.render_state(jscen, jst, size=96)
    got = trender.render_state(tscen, tst, size=96)
    assert got.dtype == np.uint8 and got.shape == (96, 96, 3)
    np.testing.assert_array_equal(got, want)
    assert (got != 255).any()  # something was drawn
    # a camera of its own, and the per-agent views tiled
    centre = np.array([0.3, -0.2])
    np.testing.assert_array_equal(trender.render_state(tscen, tst, size=64, cam_range=1.0, center=centre),
                                  jrender.render_state(jscen, jst, size=64, cam_range=1.0, center=centre))
    jviews = jrender.render_state_per_agent(jscen, jst, size=40)
    tviews = trender.render_state_per_agent(tscen, tst, size=40)
    assert len(tviews) == n
    for g, w in zip(tviews, jviews):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(trender.tile_images(np.stack(tviews)), jrender.tile_images(np.stack(jviews)))


def test_obs_scenario_draws_green_targets():
    _, _, tscen, tst = pair("formation_hd_obs_env", 4)
    frame = trender.render_state(tscen, tst, size=200)
    green = (frame == np.array([0, 153, 0], np.uint8)).all(-1)  # TARGET_COLOR, solid
    assert green.any()


def test_float32_state_on_any_device_reads_as_float64():
    """A float32 state renders as the same state cast to float64 on the
    host: the renderer reads positions once, in float64."""
    _, _, tscen, tst = pair("formation_hd_env", 9)
    f32 = tst.replace(pos=tst.pos.float())
    want = trender.render_state(tscen, tst.replace(pos=f32.pos.double()), size=80)
    np.testing.assert_array_equal(trender.render_state(tscen, f32, size=80), want)


def test_render_refuses_a_batch_of_more_than_one():
    _, _, tscen, tst = pair("formation_hd_env", 3)
    two = tst.replace(pos=tst.pos.expand(2, -1, -1))
    with pytest.raises(ValueError, match=r"\[i:i\+1\]"):
        trender.render_state(tscen, two, size=16)
    with pytest.raises(ValueError):
        trender.render_state_per_agent(tscen, two, size=16)


def test_tile_images_grid_matches_jax():
    frames = np.arange(5 * 4 * 6 * 3, dtype=np.uint8).reshape(5, 4, 6, 3)
    big = trender.tile_images(frames)
    assert big.shape == (3 * 4, 2 * 6, 3)  # 5 -> a 3x2 grid, one blank slot
    np.testing.assert_array_equal(big, jrender.tile_images(frames))
    np.testing.assert_array_equal(big[8:, 6:], 0)


def test_save_gif_round_trip(tmp_path):
    _, _, tscen, tst = pair("formation_hd_env", 3)
    step = torch.zeros_like(tst.pos)
    step[:, 0] = 0.2  # one agent moves, so that no two frames are alike
    frames = [trender.render_state(tscen, tst.replace(pos=tst.pos + k * step), size=48) for k in range(3)]
    assert not np.array_equal(frames[0], frames[1])
    path = str(tmp_path / "f.gif")
    assert trender.save_gif(frames, path) == path
    back = imageio.mimread(path)
    assert len(back) == 3
    for got, want in zip(back, frames):
        np.testing.assert_array_equal(np.asarray(got)[..., :3], want)


def test_save_gif_without_imageio(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "imageio", None)  # import imageio raises ImportError
    assert trender.save_gif([np.zeros((4, 4, 3), np.uint8)], str(tmp_path / "x.gif")) is None
    assert not (tmp_path / "x.gif").exists()
