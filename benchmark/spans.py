"""The benchmark's arithmetic over passes and spans: self time (a copy of
the program's ``obs/tracer.py`` ``phase_millis``, kept here so the
yardstick cannot move with the program), percentiles over every pass, and
the window's time per pass.

A span here is a plain record ``(name, start, end, parent)`` with
``parent`` the index of its parent in the pass's list (-1 for the root),
as ``plain_spans`` copies them out of a program trace."""

from __future__ import annotations

import math


def plain_spans(trace) -> list:
    """(name, start, end, parent) of each span of a program PassTrace."""
    if trace is None:
        return []
    return [(sp.name, sp.start, sp.end, sp.parent) for sp in trace.spans]


def self_seconds(spans: list) -> dict:
    """Seconds of each span name outside its children, summed over the
    spans of that name; the root is left out. A child that overlaps its
    parent only discounts the part inside the parent's interval."""
    child = [0.0] * len(spans)
    for name, start, end, parent in spans:
        if parent >= 0:
            _, p_start, p_end, _ = spans[parent]
            child[parent] += max(0.0, min(end, p_end) - max(start, p_start))
    out: dict = {}
    for i, (name, start, end, parent) in enumerate(spans):
        if parent < 0:
            continue
        own = max(0.0, max(0.0, end - start) - child[i])
        out[name] = out.get(name, 0.0) + own
    return out


def self_ms_per_pass(passes: list, names) -> "float | None":
    """Mean over passes of the self milliseconds of the spans ``names``;
    None when no pass holds any of them."""
    total, found = 0.0, False
    for spans in passes:
        own = self_seconds(spans)
        for n in names:
            if n in own:
                found = True
                total += own[n]
    if not found or not passes:
        return None
    return total * 1e3 / len(passes)


def percentile(values: list, q: float) -> float:
    """The nearest-rank q-quantile (0 < q <= 1) of every value: the
    smallest value with at least q of them at or below it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def per_pass(starts: list, ends: list) -> float:
    """Seconds per pass over the whole window: from the first pass's start
    to the last one's end, over the passes."""
    return (ends[-1] - starts[0]) / len(starts)


def innermost(passes: list, t: float) -> str:
    """The name of the innermost span open at time ``t`` over the passes'
    spans (the one that started last among those containing it)."""
    best, best_start = "", -math.inf
    for spans in passes:
        if not spans or not spans[0][1] <= t <= spans[0][2]:
            continue
        for name, start, end, _ in spans:
            if start <= t <= end and start >= best_start:
                best, best_start = name, start
    return best
