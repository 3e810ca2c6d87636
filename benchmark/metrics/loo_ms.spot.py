"""loo_ms.spot: milliseconds a single-node consolidation decision spends in
its batched leave-one-out classifier over every candidate, the self time
of the program's span ``disruption.loo``, per decision (layer: disruption
search). The price vectors the classifier builds are ``prices_ms.spot``'s,
in their own span."""

from benchmark.spans import self_ms_per_pass


def read(ctx):
    return self_ms_per_pass(ctx.spans, ("disruption.loo",))
