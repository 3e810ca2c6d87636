"""taints_ms.solve: milliseconds a solve spends building its existing-node
toleration matrix, the self time of the program's span ``encode.taints``,
per solve (layer: encode). A program without that span reads nothing."""

from benchmark.spans import self_ms_per_pass


def read(ctx):
    return self_ms_per_pass(ctx.spans, ("encode.taints",))
