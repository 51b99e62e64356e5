"""The program's spans (``utils/profiling.py: span``): nothing counted
and no ``record_function`` opened while no profiler runs; under a
profiler, each layer of a MAPPO iteration (on each collection path) and
each part of a fused rollout step counted, a span timed, and written into
the trace inside the span it opened in; the totals start anew with each
profiler; the events of timed spans read in order and reused; and the
results the same bit for bit with spans on and off."""

import glob
import json

import pytest
import torch

import gym_formation_tpu_torch as gt
from gym_formation_tpu_torch.algos import MAPPO, MAPPOConfig
from gym_formation_tpu_torch.utils import profiling

T, EPOCHS = 4, 2
# the learner's collection paths (the fused one with K9's update, one
# minibatch), and the fused rollout
PATHS = {
    "step": dict(n=3, cfg=dict(fused_collect=False, num_minibatches=2)),
    "fused": dict(n=3, cfg=dict(fused_collect=True, fused_update=True)),
    "structured": dict(n=4, cfg=dict(structured_obs=True, num_minibatches=2)),
}
CASES = sorted(PATHS) + ["rollout"]
ITERS = 2


@pytest.fixture(autouse=True)
def one_torch_thread_and_no_spans():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.clear_spans()
    yield
    profiling.clear_spans()
    torch.set_num_threads(threads)


def _learner(path):
    p = PATHS[path]
    env = gt.make_env("formation_hd_env", num_agents=p["n"], episode_length=3)
    algo = MAPPO(env, MAPPOConfig(rollout_len=T, ppo_epochs=EPOCHS, **p["cfg"]), num_envs=4, device="cpu")
    assert algo.fused_collect == (path == "fused") and algo.structured_obs == (path == "structured")
    return algo


def _run(case):
    """The case's results: parameters, collections and metrics of ITERS
    iterations, or the rollout's state and rewards."""
    g = torch.Generator().manual_seed(7)
    if case == "rollout":
        env = gt.make_env("formation_hd_env", num_agents=9, episode_length=4)
        state = env.reset_state(g, 3)
        state, rew = gt.rollout_statepolicy_fused(env, None, state, g, 6, stats="pre", policy="bfs_ez")
        return [rew, state.pos, state.vel, state.t]
    algo = _learner(case)
    ts, es, obs = algo.init(g)
    name = "_collect_structured" if case == "structured" else "_collect_fused" if case == "fused" else "_collect"
    collect, trajs = getattr(algo, name), []

    def keep(*a):
        out = collect(*a)
        trajs.append(out[2])
        return out
    setattr(algo, name, keep)
    out = []
    for _ in range(ITERS):
        ts, es, obs, m = algo.train_step(ts, es, obs, g)
        out += [p.detach().clone() for p in ts.params()] + list(m.values())
    return out + [v for traj in trajs for v in traj.values()] + [es.pos, es.vel]


def _profiled(case):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        return _run(case)


SPANS = {"mappo.collect", "mappo.prepare", "mappo.update", "mappo.apply"}
MARKS = {"mappo.policy", "env.step", "env.reset", "mappo.grad", "rollout.k3", "rollout.k2"}


def _traced(case, tmp_path):
    """The case under ``trace``: the trace's records of the program's spans
    and marks [(name, start, end)] in the order they opened, each span a
    ``user_annotation`` and each mark listed with the operators."""
    with profiling.trace(str(tmp_path)):
        _run(case)
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if e.get("name") in SPANS | MARKS and "dur" in e]
    assert all(e["cat"] == ("user_annotation" if e["name"] in SPANS else "cpu_op") for e in ours)
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in ours), key=lambda a: (a[1], -a[2]))


def _inside(anns, name):
    """For each annotation ``name``, the name of the innermost annotation
    holding it (None for none)."""
    out = []
    for n, s, e in anns:
        if n == name:
            holders = [(hs, h) for h, hs, he in anns if hs <= s and e <= he and (h, hs, he) != (n, s, e)]
            out.append(max(holders)[1] if holders else None)
    return out


@pytest.mark.parametrize("case", CASES)
def test_no_profiler_records_nothing_and_opens_no_range(case, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span opened a profiler range with no profiler running")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_mark_record", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    _run(case)
    assert profiling.span_totals() == {}


@pytest.mark.parametrize("case", sorted(PATHS))
def test_learner_layers_recorded_with_parent_and_count(case, tmp_path):
    anns = _traced(case, tmp_path)
    minibatches = PATHS[case]["cfg"].get("num_minibatches", 1)
    stepwise = case != "fused"
    tot = profiling.span_totals()
    assert set(tot) == {"mappo.collect", "mappo.prepare", "mappo.update", "mappo.grad", "mappo.apply"} | (
        {"mappo.policy", "env.step", "env.reset"} if stepwise else set())
    for name in ("mappo.collect", "mappo.prepare", "mappo.update"):
        assert tot[name][0] == ITERS and tot[name][1] >= 0.0
        assert _inside(anns, name) == [None] * ITERS
    for name in ("mappo.grad", "mappo.apply"):
        assert tot[name][0] == ITERS * EPOCHS * minibatches
        assert _inside(anns, name) == ["mappo.update"] * ITERS * EPOCHS * minibatches
    assert tot["mappo.apply"][1] >= 0.0 and tot["mappo.grad"][1] is None
    if stepwise:
        for name in ("mappo.policy", "env.step"):
            assert tot[name] == (ITERS * T, None)
            assert _inside(anns, name) == ["mappo.collect"] * ITERS * T
        # episodes of 3 steps: every step's auto-reset runs, inside the step
        assert tot["env.reset"] == (ITERS * T, None)
        assert _inside(anns, "env.reset") == ["env.step"] * ITERS * T


def test_rollout_layers_recorded_once_a_step(tmp_path):
    anns = _traced("rollout", tmp_path)
    assert [a[0] for a in anns] == ["rollout.k3", "rollout.k2", "env.reset"] * 6
    assert profiling.span_totals() == {name: (6, None) for name in ("rollout.k3", "rollout.k2", "env.reset")}


def test_timed_span_takes_the_host_clock_without_a_card(monkeypatch):
    """Without a card a span takes the host's clock; a mark is counted
    alone."""
    clock = iter([0.0, 4.0, 6.5, 10.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock) * 1e-3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("outer"):
            for _ in range(2):
                with profiling.mark("mark"):
                    pass
        with profiling.span("outer"):
            pass
    tot = profiling.span_totals()
    assert tot == {"outer": (2, pytest.approx(4.0 + 3.5)), "mark": (2, None)}


def test_a_new_profiler_starts_the_totals_anew():
    for name in ("first", "second"):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with profiling.span(name):
                pass
        assert set(profiling.span_totals()) == {name}
        with profiling.span("between"):  # no profiler: not counted
            pass
    assert set(profiling.span_totals()) == {"second"}


class _Card:
    """A card's stream as CUDA events see it: an event records the time it
    is enqueued at, and is passed once the card's time reaches it."""

    def __init__(self, lag):
        self.now, self.lag, self.made = 0.0, lag, 0
        card = self

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing
                card.made += 1

            def record(self):
                card.now += 1.0
                self.at = card.now

            def query(self):
                return self.at <= card.now - card.lag

            def synchronize(self):
                card.lag = 0.0  # the host waits until the card has caught up

            def elapsed_time(self, end):
                assert self.query() and end.query()
                return end.at - self.at

        self.Event = Event


@pytest.mark.parametrize("lag", [0.0, 1e9], ids=["card keeps up", "card lags"])
def test_timed_spans_read_in_order_and_reuse_their_events(lag, monkeypatch):
    """Each span records two events, a mark none; a span's time is read
    once the card has passed its end (at the latest by ``span_totals``),
    and its events then serve later spans."""
    card = _Card(lag)
    monkeypatch.setattr(profiling, "_FREE", [])
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", card.Event)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(50):
            with profiling.span("outer"):
                with profiling.mark("mark"):
                    with profiling.span("inner"):
                        pass
    assert len(profiling._PENDING) == (0 if lag == 0.0 else 100)
    # each outer span's events are 3 records apart, each inner's 1
    assert profiling.span_totals() == {"outer": (50, 150.0), "inner": (50, 50.0), "mark": (50, None)}
    assert card.made == (3 if lag == 0.0 else 200)
    assert not profiling._PENDING and len(profiling._FREE) == card.made


@pytest.mark.parametrize("case", CASES)
def test_trace_writes_the_spans_and_starts_the_records_anew(case, tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("before"):
            pass
    anns = _traced(case, tmp_path)
    names = set(profiling.span_totals())
    assert "before" not in names and names
    assert names <= {a[0] for a in anns}


@pytest.mark.parametrize("case", CASES)
def test_spans_change_no_result(case):
    off = _run(case)
    on = _profiled(case)
    assert profiling.span_totals()
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a, b)
