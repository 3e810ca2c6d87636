"""The program's counters in a traced run: attributes that the program's
tracer puts on its spans, read from the tracer's ring of completed traces.

The window's traces are those whose root starts within the first pass's
start and the last pass's end; the harness and the tracer both read
``time.perf_counter``. The ring keeps the newest 64 traces (the tracer's
default capacity), so a window of more passes is read over its last 64.
Where no trace carries the attribute, as in a program that lacks the
counter, a reader finds nothing and returns None."""

from __future__ import annotations


def window_traces(ctx) -> list:
    """The program's completed traces whose root starts inside the window."""
    from karpenter_tpu_torch.obs.tracer import TRACER
    if not ctx.starts:
        return []
    lo, hi = ctx.starts[0], ctx.ends[-1]
    return [t for t in TRACER.traces() if lo <= t.root.start <= hi]


def mean_attr(ctx, span: "str | None", attr: str) -> "float | None":
    """Mean over the window's traces of ``attr`` summed over their spans
    named ``span`` (the root when None). A trace in which no such span
    carries it counts 0, once some trace of the window does; None when
    none does."""
    traces = window_traces(ctx)
    total, found = 0.0, False
    for t in traces:
        spans = [t.root] if span is None else [s for s in t.spans
                                               if s.name == span]
        for s in spans:
            if attr in s.attrs:
                found = True
                total += float(s.attrs[attr])
    if not found:
        return None
    return total / len(traces)
