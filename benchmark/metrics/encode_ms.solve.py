"""encode_ms.solve: milliseconds a solve spends encoding its problem, the
self time of the program's spans ``build_problem``, ``encode.catalog``,
``encode.groups`` and ``encode.nodes``, per solve (layer: encode)."""

from benchmark.spans import self_ms_per_pass

SPANS = ("build_problem", "encode.catalog", "encode.groups", "encode.nodes")


def read(ctx):
    return self_ms_per_pass(ctx.spans, SPANS)
