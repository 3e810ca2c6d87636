"""solve_p80_s: the 80th percentile (nearest rank) of every solve of the
window, in seconds: the slow pass a burst's pods wait behind. A window of
about 60 solves leaves 12 beyond it (a 90th percentile would have 6)."""

from benchmark.spans import percentile


def read(ctx):
    if not ctx.starts:
        return None
    return percentile([e - s for s, e in zip(ctx.starts, ctx.ends)], 0.8)
