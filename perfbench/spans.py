"""The program's spans and marks (``gym_formation_tpu_torch.utils.profiling``)
as the per-layer readers take them: the totals the program keeps over
the traced stretch, and their records in the profiler's trace.
A program without spans, or a run without a trace, gives None."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


def totals(ctx) -> Optional[Dict[str, Tuple[int, Optional[float]]]]:
    """{name: (count, ms on the card's stream, or None for a mark)} of the
    spans and marks the program closed while the profiler ran, or None."""
    if ctx.get("trace") is None:
        return None
    from gym_formation_tpu_torch.utils import profiling

    read = getattr(profiling, "span_totals", None)
    return read() if read is not None else None


def per(ctx, name: str, unit: str) -> Optional[float]:
    """Span ``name``'s ms over the count of span ``unit`` (the iterations
    or steps of the stretch)."""
    t = totals(ctx)
    if not t or t.get(name, (0, None))[1] is None or not t.get(unit, (0,))[0]:
        return None
    return t[name][1] / t[unit][0]


def annotations(ctx, name: str) -> List[Tuple[float, float]]:
    """[(start µs, end µs)] of the trace's records named ``name``, in
    order: a span's ``user_annotation``, or a mark's, which the trace
    lists with the operators (``cpu_op``)."""
    return sorted((s, e) for cat, n, s, e in ctx["trace"]["host"]
                  if n == name and cat in ("user_annotation", "cpu_op"))


def overlap_us(gaps: Sequence[Tuple[float, float]], spans: Sequence[Tuple[float, float]]) -> float:
    """µs of the gaps that lie inside the spans (neither list overlaps
    itself): a gap across a span's edge counts its part inside."""
    return sum(max(0.0, min(ge, se) - max(gs, ss)) for gs, ge in gaps for ss, se in spans)
