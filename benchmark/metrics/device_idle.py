"""device_idle.<suffix>: the share of the profiled window of whole passes
(solves or decisions) in which the device ran nothing (1 - busy /
window), in percent (layer: device)."""


def read(ctx):
    d = ctx.device
    if not d or d["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
