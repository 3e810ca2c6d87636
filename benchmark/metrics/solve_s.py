"""solve_s: seconds a provisioning solve takes, over the whole window:
from the first solve's start to the last one's end, over the solves."""

from benchmark.spans import per_pass


def read(ctx):
    return per_pass(ctx.starts, ctx.ends) if ctx.starts else None
