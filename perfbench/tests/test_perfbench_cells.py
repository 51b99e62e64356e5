"""Each cell's entry driven on the CPU at a small size through the
program's plain paths: a sound run comes out correct against the plain
reference, and each fault planted under the timed path comes out not
correct.  The control (the reference in the precision below the
configuration's) needs the card and runs there at the cell's size."""

import pytest
import torch

from perfbench import faults, harness

SMALL = {
    "formation_hd_n3.mappo_fused": {"workload": {"num_envs": 8}},
    "formation_hd_n243.mappo": {"workload": {"num_envs": 4, "reference_block_rows": 64},
                                "config": {"num_agents": 9}},
    "formation_hd_n243.bfs_rollout": {"workload": {"num_envs": 16, "chunk": 56, "sample_range": 3, "sample": 2},
                                      "config": {"num_agents": 9}},
}
CELLS = sorted(w["name"] for w in harness.benchmark()["workloads"])
FAULTS = [(c, f) for c in CELLS for f in faults.of_cell(harness.cell(c)["workload"])]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = harness.run(cell, 2 ** 33 + 17, 0.2, False, device="cpu", overrides=SMALL[cell])
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["checks"]) == set(harness.cell(cell)["limits"]["limits"])


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(cell, fault):
    drv = harness.cell(cell)["workload"]["driver"]
    res = harness.run(cell, 2 ** 33 + 17, 0.2, False, device="cpu", overrides=SMALL[cell],
                      fault=faults.by_name(drv, fault))
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell):
    """At the cell's own size, where its limits were set: a run is correct
    and the control (the reference in the precision below) is not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = harness.run(cell, 2 ** 33 + 5, 1.0, False, control=True)
    assert res["correct"], res["checks"]
    limits = harness.cell(cell)["limits"]["limits"]
    ok, _ = harness.checks_block(res["control"], limits)
    assert not ok, res["control"]


WORLD = {"workload": {"num_envs": 8, "chips": 4, "reference_block_rows": 64}, "config": {"num_agents": 9}}


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_world_of_four_ranks(fault):
    """The training driver's data-parallel world (gloo, four processes),
    held to the same single-process reference; the exchange between the
    ranks left out comes out not correct."""
    extra = {} if fault is None else {"fault": faults.by_name("train", fault)}
    res = harness.run("formation_hd_n243.mappo", 2 ** 33 + 17, 0.2, False, device="cpu", overrides=WORLD, **extra)
    assert res["correct"] == (fault is None), res["checks"]
    assert res["device"]["count"] == 4
