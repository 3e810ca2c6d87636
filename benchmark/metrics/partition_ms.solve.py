"""partition_ms.solve: milliseconds a solve spends grouping and
partitioning its pods, the self time of the program's span ``partition``
(the existing nodes' host-port usage and ``partition_pods``), per solve
(layer: grouping)."""

from benchmark.spans import self_ms_per_pass


def read(ctx):
    return self_ms_per_pass(ctx.spans, ("partition",))
