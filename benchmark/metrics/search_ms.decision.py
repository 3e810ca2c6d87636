"""search_ms.decision: milliseconds a consolidation decision spends
finding candidates and searching their prefixes, the self time of the
benchmark's span ``bench.candidates`` around ``get_candidates`` and of the
program's spans ``disruption.candidates``, ``disruption.sim``,
``disruption.mnloo`` and ``disruption.loo``, per decision (layer:
disruption search)."""

from benchmark.spans import self_ms_per_pass

SPANS = ("bench.candidates", "disruption.candidates", "disruption.sim",
         "disruption.mnloo", "disruption.loo")


def read(ctx):
    return self_ms_per_pass(ctx.spans, SPANS)
