"""The readers of the program's spans on a synthetic trace and span totals,
against values computed by hand; each gives None without a trace, and
where the program has no spans (a program older than them)."""

import collections

import pytest

from gym_formation_tpu_torch.utils import profiling
from perfbench import harness

READERS = ["prepare_ms.train", "optim_ms.train", "collect_idle_ms.train", "collect_launches.train",
           "reset_host_ms.rollout"]
TIMED = ["prepare_ms.train", "optim_ms.train"]

# the program's totals over two iterations: collection 10 ms each,
# preparation 3 and 5 ms, the clipped Adam 1-4 ms four times; three
# rollout steps and their auto-resets, marks: counted, not timed
TOTALS = {
    "mappo.collect": [2, 20.0], "mappo.prepare": [2, 8.0], "mappo.update": [2, 17.0],
    "mappo.grad": [4, None], "mappo.apply": [4, 1.0 + 2.0 + 3.0 + 4.0],
    "rollout.k3": [3, None], "rollout.k2": [3, None], "env.reset": [3, None],
}

ann = lambda name, s, e: ("user_annotation", name, float(s), float(e))  # a span
op = lambda name, s, e: ("cpu_op", name, float(s), float(e))  # a mark, listed with the operators
run = lambda name, s: ("cuda_runtime", name, float(s), float(s) + 1.0)
HOST = [
    ann("mappo.collect", 0, 100), ann("mappo.collect", 200, 300), ann("collect", 1, 99),
    run("cudaLaunchKernel", 10), run("cudaLaunchKernel", 50), run("cudaMemcpyAsync", 60),
    run("cudaLaunchKernel", 150), run("cudaLaunchKernelExC", 220), run("cudaLaunchKernel", 250),
    run("cudaLaunchKernel", 299), run("cudaLaunchKernel", 300), ("cpu_op", "aten::mm", 210.0, 230.0),
    op("rollout.k3", 400, 500), op("env.reset", 500, 600), op("rollout.k3", 600, 700),
    op("env.reset", 700, 900), op("rollout.k3", 900, 1000), op("env.reset", 1000, 1300),
    ann("env.reset", 1400, 1500), ("cuda_runtime", "rollout.k3", 1400.0, 1500.0),
]
# idle gaps: across the first collection's end (10 µs inside), between the
# collections (none), inside the second (10), across its end (20)
GAPS = [(90.0, 110.0), (120.0, 180.0), (250.0, 260.0), (280.0, 320.0)]
WANT = {
    "prepare_ms.train": (3 + 5) / 2,
    "optim_ms.train": (1 + 2 + 3 + 4) / 2,
    "collect_idle_ms.train": 1e-3 * (10 + 10 + 20) / 2,
    "collect_launches.train": 5 / 2,  # 10, 50, 220 (ExC), 250, 299; 300 is the end
    # the rollout's marks; an annotation of the name counts as well, a
    # record of another category does not
    "reset_host_ms.rollout": 1e-3 * (100 + 200 + 300 + 100) / 3,
}


def _ctx():
    return dict(trace=dict(host=HOST, kernels=[], device=[(0.0, 1.0)], start=0.0, end=1500.0), gaps=GAPS)


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(profiling, "_TOTALS", {k: list(v) for k, v in TOTALS.items()})
    monkeypatch.setattr(profiling, "_PENDING", collections.deque())


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_spans(name, recorded):
    assert harness.reader(name)(_ctx()) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_without_a_trace(name, recorded):
    assert harness.reader(name)(dict(trace=None)) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_for_a_program_without_spans(name, monkeypatch):
    """No span totals in the program and no span annotations in the trace
    (a program older than its spans, whose trace has only outside labels)."""
    monkeypatch.delattr(profiling, "span_totals")
    ctx = _ctx()
    ctx["trace"]["host"] = [h for h in HOST if not h[1].startswith(("mappo.", "rollout.", "env."))]
    assert harness.reader(name)(ctx) is None


@pytest.mark.parametrize("lack", ["untimed", "no iterations"])
@pytest.mark.parametrize("name", TIMED)
def test_timed_reader_gives_none_without_its_times(name, lack, recorded):
    """A span the program counts but does not time, or a stretch with no
    iteration in it, gives no time an iteration."""
    if lack == "untimed":
        for span in ("mappo.prepare", "mappo.apply"):
            profiling._TOTALS[span][1] = None
    else:
        del profiling._TOTALS["mappo.collect"]
    assert harness.reader(name)(_ctx()) is None
