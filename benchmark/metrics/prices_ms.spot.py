"""prices_ms.spot: milliseconds a spot consolidation decision spends on
worst-launch-price vectors, the self time of the program's span
``disruption.prices`` (the classifier's vectors and the winner's price
filter), per decision (layer: disruption search). A program without the
span reads nothing."""

from benchmark.spans import self_ms_per_pass


def read(ctx):
    return self_ms_per_pass(ctx.spans, ("disruption.prices",))
