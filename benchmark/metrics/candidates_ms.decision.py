"""candidates_ms.decision: milliseconds a consolidation decision spends
finding its candidates, the self time of the program's span
``disruption.candidates`` (``get_candidates``), per decision (layer:
disruption search)."""

from benchmark.spans import self_ms_per_pass


def read(ctx):
    return self_ms_per_pass(ctx.spans, ("disruption.candidates",))
