"""decision_s: seconds a consolidation decision takes, over the whole
window: from the first decision's start to the last one's end, over the
decisions."""

from benchmark.spans import per_pass


def read(ctx):
    return per_pass(ctx.starts, ctx.ends) if ctx.starts else None
