"""The port's config and logging utilities, as the JAX package's
``tests/test_utils.py`` holds its own: the YAML round trip of a config
(``save_config``, ``to_dict``), ``metrics.jsonl``, the history reloaded by a
reopened logger so that a resumed run's plot keeps the whole curve, the
``plot`` png, and ``plot`` on a host without matplotlib."""

import dataclasses
import json
import sys

import pytest

from gym_formation_tpu_torch.algos import MAPPOConfig, RMADDPGConfig, RQMixConfig
from gym_formation_tpu_torch.utils import MetricsLogger, load_config, save_config, to_dict


@pytest.mark.parametrize("cfg", [MAPPOConfig(lr=1e-3, ppo_epochs=5),
                                 RMADDPGConfig(twin=True, critic_hidden=(32, 16), lr_actor=3e-4),
                                 RQMixConfig(mixer="vdn", double_q=False)])
def test_config_yaml_round_trip(cfg, tmp_path):
    path = str(tmp_path / "cfg.yaml")
    save_config(cfg, path)
    assert load_config(type(cfg), path) == cfg
    assert to_dict(cfg) == dataclasses.asdict(cfg)


def test_metrics_logger(tmp_path):
    logger = MetricsLogger(str(tmp_path / "run"), use_tensorboard=False)
    logger.log(10, {"reward": -1.5})
    logger.log(20, {"reward": -1.0})
    logger.plot("reward")
    logger.close()
    rows = [json.loads(line) for line in open(tmp_path / "run" / "metrics.jsonl")]
    assert rows[0]["reward"] == -1.5 and rows[1]["step"] == 20 and set(rows[0]) == {"step", "wall", "reward"}
    assert (tmp_path / "run" / "reward.png").stat().st_size > 0


def test_history_reloads_after_reopen(tmp_path):
    """A reopened logger (a resumed run) appends to the file and plots the
    rows of both runs; a line cut short by a killed run is skipped."""
    run = tmp_path / "run"
    first = MetricsLogger(str(run), use_tensorboard=False)
    first.log(10, {"mean_step_reward": -4.0, "loss": 2.0})
    first.close()
    with open(run / "metrics.jsonl", "a") as f:
        f.write('{"step": 15, "mean_st')
        f.write("\n")
    second = MetricsLogger(str(run), use_tensorboard=True)
    second.log(20, {"mean_step_reward": -3.0})
    assert second._history["mean_step_reward"] == [(10, -4.0), (20, -3.0)]
    assert second._history["loss"] == [(10, 2.0)]
    second.plot("mean_step_reward", str(tmp_path / "curve.png"))
    second.plot("never_logged")
    second.close()
    assert (tmp_path / "curve.png").stat().st_size > 0 and not (run / "never_logged.png").exists()
    assert len(open(run / "metrics.jsonl").readlines()) == 3
    assert (run / "tb").is_dir()  # tensorboardX is on this host


def test_plot_without_matplotlib(tmp_path, monkeypatch):
    """``plot`` returns without error where matplotlib does not import."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    logger = MetricsLogger(str(tmp_path / "run"), use_tensorboard=False, use_wandb=False)
    logger.log(1, {"mean_step_reward": -2.0})
    logger.plot()
    logger.close()
    assert not (tmp_path / "run" / "mean_step_reward.png").exists()


def test_wandb_only_when_asked(tmp_path, monkeypatch):
    """Without ``GFT_WANDB`` no wandb run starts; with it and no wandb to
    import, the JSON rows carry on."""
    monkeypatch.delenv("GFT_WANDB", raising=False)
    assert MetricsLogger(str(tmp_path / "a"), use_tensorboard=False)._wandb is None
    monkeypatch.setenv("GFT_WANDB", "1")
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.warns(UserWarning, match="wandb is off"):
        logger = MetricsLogger(str(tmp_path / "b"), use_tensorboard=False)
    assert logger._wandb is None
    logger.log(5, {"x": 1.0})
    logger.close()
    assert json.loads(open(tmp_path / "b" / "metrics.jsonl").readline())["x"] == 1.0
