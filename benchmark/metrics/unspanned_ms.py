"""unspanned_ms.<suffix>: milliseconds a pass (a solve or a decision)
spends outside every program span but the root, per pass: the harness's
pass wall time less the self time of every non-root span of the pass's
trace. It holds the root's own work and what the pass does outside its
trace (layer: host outside program spans)."""

from benchmark.spans import self_seconds


def read(ctx):
    if not ctx.spans:
        return None
    total = 0.0
    for start, end, spans in zip(ctx.starts, ctx.ends, ctx.spans):
        total += (end - start) - sum(self_seconds(spans).values())
    return total * 1e3 / len(ctx.spans)
