"""Profiling and numeric-safety instrumentation.

Counterpart of ``gym_formation_tpu/utils/profiling.py``: :func:`trace`
records a ``torch.profiler`` trace (``jax.profiler`` there),
:data:`named_scope` labels a section in it, :class:`Throughput` counts
steps/s, and :func:`assert_finite` guards the zero-distance NaN of the
original environment with an explicit check for debug runs.

:func:`span` marks a layer of the program (the learner's collection,
preparation and update), :func:`mark` a part of a step (the rollout's
kernels and its auto-reset).  While no profiler runs they do nothing;
while one runs they label the section in the profiler's trace, on the
clock of the card's activity, and count it, and a span takes its time on
the card's stream (:func:`span_totals`).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import time
from typing import Deque, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """``with trace('/tmp/torchtrace'): ...`` records the host's operators
    and, where a card is present, its kernels (CUPTI), and writes one
    ``<host>_<pid>.<ms>.pt.trace.json`` under ``log_dir`` that TensorBoard's
    PyTorch profiler plugin or Perfetto loads.  The totals of
    :func:`span_totals` start anew with it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    clear_spans()
    with torch.profiler.profile(activities=activities) as prof:
        yield
    torch.profiler.tensorboard_trace_handler(log_dir)(prof)


named_scope = torch.profiler.record_function  # labels a section of a trace


# {name: [count, ms or None]} of the spans and marks closed since a profiler started
_TOTALS: Dict[str, list] = {}
# spans whose stream time is not read yet: (name, start, end), oldest first
_PENDING: Deque[tuple] = collections.deque()
_FREE: List[object] = []  # CUDA events read and free for another span
_live = False  # whether the last span or mark found a profiler running


def _stamp():
    """A CUDA event recorded on the current stream where the process uses a
    card (a freed one if any), else the host's clock in ms."""
    if torch.cuda.is_initialized():
        ev = _FREE.pop() if _FREE else torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter() * 1e3


def _settle(wait: bool) -> None:
    """Add the pending spans' times to the totals, oldest first, and free
    their events; without ``wait`` only as far as the card has passed."""
    while _PENDING:
        name, start, end = _PENDING[0]
        if isinstance(start, float):
            ms = end - start
        else:
            if wait:
                end.synchronize()
            elif not end.query():
                return
            ms = start.elapsed_time(end)
            _FREE.extend((start, end))
        _PENDING.popleft()
        tot = _TOTALS[name]
        tot[1] = ms if tot[1] is None else tot[1] + ms


# a mark's record: listed in the trace with the operators, at a fraction
# of ``record_function``'s cost on the host (where this build has it)
_mark_record = getattr(torch._C._profiler, "_RecordFunctionFast", torch.profiler.record_function)


class _Span:
    """A span or mark while a profiler runs: a record in the trace, counted,
    and a span also timed on the current stream."""

    __slots__ = ("name", "timed", "_range", "_start")

    def __init__(self, name: str, timed: bool):
        self.name, self.timed = name, timed

    def __enter__(self):
        self._range = (torch.profiler.record_function if self.timed else _mark_record)(self.name)
        self._range.__enter__()
        if self.timed:
            self._start = _stamp()

    def __exit__(self, *exc):
        _TOTALS.setdefault(self.name, [0, None])[0] += 1
        if self.timed:
            _PENDING.append((self.name, self._start, _stamp()))
            _settle(wait=False)
        self._range.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()  # reused by every span and mark while no profiler runs
_profiler_enabled = torch.autograd._profiler_enabled  # the off path's one check


def _recording() -> bool:
    """Whether a profiler runs; the totals start anew under a new one."""
    global _live
    if not _profiler_enabled():
        _live = False
        return False
    if not _live:
        _live = True
        clear_spans()
    return True


def span(name: str):
    """``with span("mappo.update"): ...`` marks a layer of an iteration.
    With no profiler running it returns one shared context that does
    nothing.  With one running it opens a ``record_function`` range named
    ``name`` (the trace's ``user_annotation``), counts the span and takes
    its time between two CUDA events on the current stream (the host's
    clock without a card).  Where the host paces the card, that time holds
    the card's waits for the host."""
    return _Span(name, True) if _recording() else _OFF


def mark(name: str):
    """``with mark("env.reset"): ...`` marks a part of a step, inside a
    step's loop: as :func:`span`, but its record is the cheaper one the
    trace lists with the operators (``cpu_op``), and it is counted, not
    timed.  Under a profiler a ``record_function`` range costs the host
    tens of µs a use (76 inside the fused rollout's step, on an H100's
    host), and an event record more: where the host sets the step's pace,
    each lengthens the step."""
    return _Span(name, False) if _recording() else _OFF


def clear_spans() -> None:
    _TOTALS.clear()
    for _, start, end in _PENDING:
        if not isinstance(start, float):
            _FREE.extend((start, end))
    _PENDING.clear()


def span_totals() -> Dict[str, Tuple[int, Optional[float]]]:
    """{name: (count, ms)} of the spans and marks closed since the profiler
    started (or :func:`trace`): a span's ms summed over its calls, None for
    a mark.  Waits for the card to pass the last span."""
    _settle(wait=True)
    return {name: (n, ms) for name, (n, ms) in _TOTALS.items()}


class Throughput:
    """Steps/s counter, reporting every ``report_every`` ticks."""

    def __init__(self, report_every: int = 10):
        self.report_every = report_every
        self._t0: Optional[float] = None
        self._steps = 0
        self._iters = 0
        self.last_rate = 0.0

    def tick(self, env_steps: int) -> Optional[float]:
        """Record ``env_steps`` done; returns steps/s when a report is due."""
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
            return None
        self._steps += env_steps
        self._iters += 1
        if self._iters % self.report_every == 0:
            self.last_rate = self._steps / (now - self._t0)
            self._t0, self._steps = now, 0
            return self.last_rate
        return None


def _leaves(tree, path: str = ""):
    """(path, leaf) of a tree of dataclasses, dicts, lists and tuples, the
    paths spelled as JAX's ``keystr`` spells them (``.vel``, ``['a']``,
    ``[0]``), dict keys in sorted order as JAX flattens them."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _finite(leaf) -> Optional[bool]:
    """Whether a floating-point leaf is all finite; None for any other."""
    if isinstance(leaf, torch.Tensor):
        return bool(torch.isfinite(leaf).all()) if leaf.is_floating_point() else None
    if isinstance(leaf, float):
        return math.isfinite(leaf)
    a = np.asarray(leaf)
    return bool(np.isfinite(a).all()) if np.issubdtype(a.dtype, np.floating) else None


def assert_finite(tree, name: str = "state") -> None:
    """Host-side finiteness check over a tree (an ``EnvState``, dicts,
    lists, tuples and tensors; leaves that are not floating point are
    skipped).  Raises ``FloatingPointError`` naming the bad leaves."""
    bad: List[str] = [path for path, leaf in _leaves(tree) if _finite(leaf) is False]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")
