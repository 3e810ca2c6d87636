"""gc_ms.decision: milliseconds the cyclic garbage collector paused a
consolidation decision, the root's ``gc_ms`` attribute that the program's
tracer sums from its ``gc.callbacks`` hook, per decision (layer: host
collector). A pause also stays in the self time of the span it fell in,
so this overlaps the decision's other per-layer metrics (a full collection
inside ``get_candidates`` is in ``candidates_ms.decision`` too): it is not
added to them."""

from benchmark.counters import mean_attr


def read(ctx):
    return mean_attr(ctx, None, "gc_ms")
