"""The benchmark's frame: cells by name, seeds, the window's statistics,
the profiler's trace, the per-layer readers and the result line.

A cell is ``workloads/<cell>.json``: its configuration's name, its driver
(``drivers/<driver>.py``, the general generator of its kind of traffic) and
the traffic's parameters.  The configuration is ``configs/<config>.json``,
the limits of the comparison that decides ``correct`` are
``limits/<cell>.json``, and each per-layer metric is read by
``metrics/<metric>.py``.  ``BENCHMARK.json`` says which metrics a cell
reports.  Adding a cell, a configuration or a metric adds files; nothing
here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gym_formation_tpu")


class NoCard(SystemExit):
    pass


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    """The cell's traffic, its configuration and its limits."""
    wl = read_json(HERE / "workloads" / f"{name}.json")
    cfg = read_json(HERE / "configs" / f"{wl['config']}.json")
    limits = read_json(HERE / "limits" / f"{name}.json")
    return dict(name=name, workload=wl, config=cfg, limits=limits)


def metrics_of(name: str, bench: dict, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries of BENCHMARK.json that
    cell ``name`` reports."""
    out = []
    for m in bench[kind]:
        if "workloads" in m and name not in m["workloads"]:
            continue
        out.append(m)
    return out


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read(ctx)``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    return importlib.import_module(f"perfbench.drivers.{name}")


def seeds(seed: int, k: int = 4) -> List[int]:
    """``k`` independent 62-bit seeds from the run's ``--seed``."""
    import numpy as np

    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(k, dtype=np.uint64) >> 2]


# -- the window's statistics ------------------------------------------------------

def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    sorted values (numpy's default)."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def rate(units: float, seconds: float) -> float:
    """Work over the whole window's wall time."""
    return units / seconds


def interval_durations(stamps_ms: Sequence[float]) -> List[float]:
    """Durations between consecutive stamps (the first stamp is the window's
    start)."""
    return [b - a for a, b in zip(stamps_ms[:-1], stamps_ms[1:])]


# -- the profiler's trace -----------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals, sorted and merged."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_idle(device: List[Tuple[float, float]], start: float, end: float):
    """(busy seconds, idle gaps [(start, end)]) of the device over
    [start, end], from its activity intervals in microseconds."""
    merged = [(max(s, start), min(e, end)) for s, e in union(device) if e > start and s < end]
    busy = sum(e - s for s, e in merged)
    gaps, t = [], start
    for s, e in merged:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if end > t:
        gaps.append((t, end))
    return busy * 1e-6, gaps


def parse_trace(path: Path) -> dict:
    """Device activity and host ops of a chrome trace that
    ``torch.profiler`` exported: ``kernels`` [(name, start µs, dur µs)],
    ``device`` [(start, end)], ``host`` [(cat, name, start, end)], and the
    stretch's start and end (µs)."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    kernels, device, host = [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, ts, dur = ev.get("cat", ""), float(ev["ts"]), float(ev["dur"])
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur))
            if cat == "kernel":
                kernels.append((ev.get("name", "?"), ts, dur))
        elif cat in HOST_CATS:
            host.append((cat, ev.get("name", "?"), ts, ts + dur))
    starts = [h[2] for h in host] + [d[0] for d in device]
    ends = [d[1] for d in device] + [h[3] for h in host]
    return dict(kernels=kernels, device=device, host=host,
                start=min(starts) if starts else 0.0, end=max(ends) if ends else 0.0)


def kernel_seconds(trace: dict, names: Sequence[str]) -> float:
    """Summed device time of the kernels whose name holds one of ``names``."""
    return sum(d for n, _, d in trace["kernels"] if any(k in n for k in names)) * 1e-6


def short(name: str, width: int = 96) -> str:
    """A kernel's name without its arguments."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name if len(name) <= width else name[: width - 3] + "..."


def breakdown(trace: dict, gaps, labelled: int = 2000) -> dict:
    """The ten device operations that took most time, and the idle time by
    what the host was doing (the outermost annotation and the innermost
    operation running at each gap's midpoint; the ``labelled`` longest
    gaps are labelled, the rest counted as short gaps)."""
    import numpy as np

    ops: Dict[str, float] = {}
    for n, _, d in trace["kernels"]:
        ops[short(n)] = ops.get(short(n), 0.0) + d * 1e-6
    idle: Dict[str, float] = {}
    host = trace["host"]
    starts = np.array([h[2] for h in host]) if host else np.zeros(0)
    ends = np.array([h[3] for h in host]) if host else np.zeros(0)
    is_ann = np.array([h[0] == "user_annotation" for h in host], bool)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    for k, (s, e) in enumerate(gaps):
        if k >= labelled:
            label = "shorter gaps"
        else:
            mid = 0.5 * (s + e)
            over = np.nonzero((starts <= mid) & (ends >= mid))[0]
            if len(over) == 0:
                label = "host idle"
            else:
                inner = host[over[np.argmin(ends[over] - starts[over])]][1]
                ann = over[is_ann[over]]
                outer = host[ann[np.argmin(starts[ann])]][1] if len(ann) else None
                label = short(inner if outer is None or outer == inner else f"{outer}/{inner}")
        idle[label] = idle.get(label, 0.0) + (e - s) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return dict(device_ops=top(ops), idle_gaps=top(idle))


class Profiled:
    """``torch.profiler`` over a stretch of the window: ``start()`` waits for
    the card and starts it, ``stop(path)`` stops it after the window has
    closed and reads the trace."""

    def __init__(self):
        import torch

        self.torch = torch
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)

    @staticmethod
    def warm():
        """A first profiled op, so that the tracer's start-up is set-up."""
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts):
            x = torch.ones(1024, device="cuda")
            (x * 2).sum().item()

    def start(self):
        self.torch.cuda.synchronize()
        self.prof.start()

    def stop(self, path: Path) -> dict:
        self.prof.stop()
        path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(path))
        try:
            return parse_trace(path)
        finally:
            path.unlink(missing_ok=True)


def trace_context(trace: Optional[dict]) -> dict:
    """The device's busy seconds, the stretch and its idle gaps."""
    if trace is None or not trace["device"]:
        return dict(trace=None)
    busy, gaps = busy_idle(trace["device"], trace["start"], trace["end"])
    return dict(trace=trace, busy_s=busy, stretch_s=(trace["end"] - trace["start"]) * 1e-6, gaps=gaps)


# -- the run ----------------------------------------------------------------------------

def require_card(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: the benchmark measures the card and does not fall back to the CPU")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, {torch.cuda.device_count()} present")


def forbidden_modules() -> List[str]:
    """Modules loaded whose top-level name is the JAX package's or JAX's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def checks_block(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}) for the numbers compared."""
    out, ok = {}, True
    for k, lim in limits.items():
        v = numbers.get(k, float("nan"))
        out[k] = {"value": v, "limit": lim}
        if not (isinstance(v, (int, float)) and math.isfinite(v) and v <= lim):
            ok = False
    return ok, out


def result_line(res: dict) -> str:
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if "breakdown" in res:
        keys.append("breakdown")
    keys.append("checks")
    return json.dumps({k: res[k] for k in keys})


def run(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        overrides: Optional[dict] = None, t0: Optional[float] = None, **extra) -> dict:
    """One run of cell ``name``: set-up, the window, the check.  Returns the
    result (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
    ``checks``, and with ``trace`` ``breakdown``).  ``device="cpu"`` drives
    the program's plain paths at the sizes ``overrides`` gives
    (``{"workload": {...}, "config": {...}}``, merged into the cell's
    files); the tests use it, the command line never does.  ``extra``
    goes to the driver (``fault``, ``control``: the tests' and the
    calibration's), and the result then holds the driver's ``numbers`` and
    ``control``."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = benchmark()
    c = cell(name)
    for part, given in (overrides or {}).items():
        c[part] = dict(c[part], **given)
    wl = c["workload"]
    if device != "cpu":
        require_card(int(wl.get("chips", 1)))
    out = driver(wl["driver"]).run(c, int(seed), float(seconds), bool(trace), device, t0, **extra)
    ctx = out["ctx"]
    if trace:
        metrics = {}
        for m in metrics_of(name, bench, "per_layer"):
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                   for m in metrics_of(name, bench, "end_to_end")}
    res = dict(correct=out["correct"], attempted=out["attempted"], failed=out["failed"],
               metrics=metrics, device=out["device"], checks=out["checks"], numbers=out["numbers"],
               control=out.get("control"))
    if trace and ctx.get("trace") is not None:
        res["device"] = dict(res["device"], busy_s=ctx["busy_s"], window_s=ctx["stretch_s"])
        res["breakdown"] = breakdown(ctx["trace"], ctx["gaps"])
    return res
