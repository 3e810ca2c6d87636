"""encode_ms.decision: milliseconds a consolidation decision spends taking
its snapshot and encoding it, the self time of the program's spans
``disruption.snapshot``, ``disruption.encode``, ``build_problem``,
``encode.catalog``, ``encode.groups`` and ``encode.nodes``, per decision
(layer: disruption snapshot and encode)."""

from benchmark.spans import self_ms_per_pass

SPANS = ("disruption.snapshot", "disruption.encode", "build_problem",
         "encode.catalog", "encode.groups", "encode.nodes")


def read(ctx):
    return self_ms_per_pass(ctx.spans, SPANS)
