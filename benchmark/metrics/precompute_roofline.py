"""precompute_roofline.<suffix>: the least time the traced passes'
precomputes (of solves or decisions) need (benchmark/roofline.py, from
each call's shapes) over the device's busy time for all device work
launched inside them, in percent (layer: kernels)."""

from benchmark.roofline import least_seconds


def read(ctx):
    d = ctx.device
    if not d or not ctx.shapes or d["precompute_busy_s"] <= 0:
        return None
    least = sum(least_seconds(s) for s in ctx.shapes)
    return 100.0 * least / d["precompute_busy_s"]
