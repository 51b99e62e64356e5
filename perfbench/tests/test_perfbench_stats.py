"""The window's arithmetic: whole-window rates and tails, the idle share
from overlapping intervals, the gaps' labels."""

import numpy as np
import pytest

from perfbench import harness


def _iters(stall_ms):
    # ten iterations of 10 ms, the sixth stalled
    d = [10.0] * 10
    d[5] += stall_ms
    return list(np.cumsum([0.0] + d))


def test_rate_and_tail_move_with_a_stall():
    calm, stalled = _iters(0.0), _iters(200.0)
    r = lambda s: harness.rate(10, (s[-1] - s[0]) / 1e3)
    p95 = lambda s: harness.percentile(harness.interval_durations(s), 95)
    assert r(calm) == pytest.approx(100.0)
    assert r(stalled) == pytest.approx(10 / 0.3)
    assert p95(calm) == pytest.approx(10.0)
    # sorted: nine of 10 and one of 210; position 9 × 0.95 = 8.55
    assert p95(stalled) == pytest.approx(10.0 + 0.55 * 200.0)


def test_percentile_is_numpys_linear():
    v = list(np.random.RandomState(0).uniform(0, 100, 57))
    for q in (0, 5, 50, 95, 100):
        assert harness.percentile(v, q) == pytest.approx(float(np.percentile(v, q)))


def test_idle_share_of_overlapping_intervals():
    dev = [(0.0, 10.0), (5.0, 15.0), (20.0, 30.0), (25.0, 28.0), (38.0, 50.0)]
    busy, gaps = harness.busy_idle(dev, 0.0, 40.0)
    assert busy == pytest.approx(27e-6)  # [0, 15] ∪ [20, 30] ∪ [38, 40] µs
    assert gaps == [(15.0, 20.0), (30.0, 38.0)]
    busy, gaps = harness.busy_idle(dev, -5.0, 40.0)
    assert gaps[0] == (-5.0, 0.0)


def test_gap_labels_name_the_host():
    trace = dict(kernels=[("void k<1>(float*)", 0.0, 10.0), ("void k<1>(float*)", 20.0, 10.0)],
                 device=[(0.0, 10.0), (20.0, 30.0)],
                 host=[("user_annotation", "update", 0.0, 40.0), ("cpu_op", "aten::mul", 11.0, 19.0)],
                 start=0.0, end=40.0)
    ctx = harness.trace_context(trace)
    out = harness.breakdown(trace, ctx["gaps"])
    assert out["device_ops"] == [["void k<1>", pytest.approx(20e-6)]]
    labels = dict(out["idle_gaps"])
    assert labels["update/aten::mul"] == pytest.approx(10e-6)
    assert labels["update"] == pytest.approx(10e-6)


def test_kernel_names_lose_their_arguments():
    assert harness.short("void (anonymous namespace)::ppo_grad_kernel<3>(Role)") == "void ppo_grad_kernel<3>"
