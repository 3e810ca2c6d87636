"""The device's side of a traced run: one ``torch.profiler`` session over
the measured passes, read back from its Chrome trace.

Each pass runs inside a ``bench.pass`` range and each precompute inside a
``bench.precompute`` range (``probe.py``). From the trace this gives:

- the profiled window: the first pass's start to the last pass's end;
- the device's busy time: the union of its kernel, copy and set
  intervals inside the window, and the idle share beside it;
- the busy time of the device work launched inside a precompute (a launch
  is matched to its device interval by the profiler's correlation id),
  whatever the kernels are named;
- the device operations that took most time, and the longest idle gaps,
  each labelled with the innermost program span open on the host then.

A trace that holds no device interval while the program counted kernel
launches cannot say what the device did: ``read`` raises then."""

from __future__ import annotations

import json
import statistics

from . import spans as S

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class TraceError(RuntimeError):
    pass


def session():
    """A profiler session of the host's torch calls and the device's
    work."""
    import torch
    from torch.profiler import ProfilerActivity
    return torch.profiler.profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _union(intervals: list) -> list:
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _length(intervals: list) -> float:
    return sum(end - start for start, end in intervals)


def read(path: str, host_starts: list, host_spans: list,
         launches: int) -> dict:
    """Read an exported trace. ``host_starts``: each pass's start on the
    host clock (perf_counter seconds), in order; ``host_spans``: each
    pass's program spans; ``launches``: kernel launches the program
    counted over the passes. Times come back in seconds."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    passes, precomputes, device, launch_at = [], [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e.get("dur", 0))
        if cat == "user_annotation":
            if e["name"] == "bench.pass":
                passes.append((ts, ts + dur))
            elif e["name"] == "bench.precompute":
                precomputes.append((ts, ts + dur))
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur, e["name"],
                           e.get("args", {}).get("correlation")))
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_at[corr] = ts
    if not passes:
        raise TraceError("the trace holds no bench.pass range")
    if launches and not device:
        raise TraceError(f"the profiler gave no device events while the "
                         f"program counted {launches} kernel launches")
    passes.sort()
    lo, hi = passes[0][0], passes[-1][1]
    inside = [(max(s, lo), min(e, hi), name, corr)
              for s, e, name, corr in device if e > lo and s < hi]
    busy = _union([(s, e) for s, e, _, _ in inside])
    in_pre = [(s, e) for s, e, _, corr in inside
              if corr in launch_at and any(
                  a <= launch_at[corr] <= b for a, b in precomputes)]
    by_name: dict = {}
    for s, e, name, _ in inside:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    # the profiler's clock against the host's, from the passes' starts
    n = min(len(passes), len(host_starts))
    offset = statistics.median(passes[i][0] * 1e-6 - host_starts[i]
                               for i in range(n))
    gaps, edge = [], lo
    for s, e in busy + [[hi, hi]]:
        if s > edge:
            gaps.append((s - edge, edge, s))
        edge = max(edge, e)
    gaps.sort(reverse=True)
    labelled = []
    for length, s, e in gaps[:10]:
        mid = (s + e) / 2 * 1e-6 - offset
        labelled.append([S.innermost(host_spans, mid) or "harness",
                         length * 1e-6])
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": _length(busy) * 1e-6,
        "precompute_busy_s": _length(_union(in_pre)) * 1e-6,
        "device_ops": [[k, v * 1e-6] for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": labelled,
    }
