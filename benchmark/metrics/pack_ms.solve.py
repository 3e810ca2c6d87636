"""pack_ms.solve: milliseconds a solve spends in the host greedy and in
building its results, the self time of the program's spans ``pack`` and
``materialize``, per solve (layer: pack)."""

from benchmark.spans import self_ms_per_pass

SPANS = ("pack", "materialize")


def read(ctx):
    return self_ms_per_pass(ctx.spans, SPANS)
