"""Trace-dump CLI.

    python -m karpenter_tpu_torch.obs dump --url http://host:8080 [--out f]
    python -m karpenter_tpu_torch.obs dump --out trace.json   # in-process ring
    python -m karpenter_tpu_torch.obs show trace.json

``dump --url`` fetches ``/debug/traces?format=chrome`` from a live
operator's metrics port; without ``--url`` it exports this process's own
tracer ring (drivers/tests that ran solves in-process). The output is
Chrome trace-event JSON — open it in Perfetto (ui.perfetto.dev) or
chrome://tracing. ``show`` prints a per-phase wall-clock breakdown of a
dumped file without leaving the terminal.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _cmd_dump(url: Optional[str], out: Optional[str], n: Optional[int]) -> int:
    if url:
        import urllib.request
        q = "?format=chrome" + (f"&n={n}" if n else "")
        with urllib.request.urlopen(f"{url.rstrip('/')}/debug/traces{q}",
                                    timeout=30) as resp:
            body = resp.read().decode()
    else:
        from .tracer import TRACER, dumps_chrome
        traces = TRACER.traces(n)
        if not traces:
            print("no completed traces in the in-process ring "
                  "(use --url against a live operator)", file=sys.stderr)
            return 1
        body = dumps_chrome(traces)
    if out and out != "-":
        with open(out, "w") as f:
            f.write(body)
        doc = json.loads(body)
        print(f"wrote {len(doc.get('traceEvents', []))} events to {out}")
    else:
        print(body)
    return 0


def _exclusive_micros(evs: list) -> dict:
    """EXCLUSIVE µs per span name (child time subtracted from parents),
    reconstructed from ts/dur containment per thread — the same breakdown
    tracer.phase_millis computes from live spans, so `obs show` and the
    bench's `phases:` line agree on identical data.

    Spans that do NOT nest cleanly (a mid-span exception recovery can
    close out of order, leaving a span that starts inside one parent and
    ends after it) get a deterministic rendering: a child only discounts
    the part of its duration that lies INSIDE the enclosing span's
    interval, so an overlapping child can never drive a parent's exclusive
    time negative (or silently inflate a sibling by over-discounting), and
    the same dump always renders the same table."""
    child: dict = {}
    by_tid: dict = {}
    for e in evs:
        by_tid.setdefault(e.get("tid"), []).append(e)
    for tid_evs in by_tid.values():
        tid_evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        stack: list = []   # (event id, start, end) of open enclosing spans
        for e in tid_evs:
            start = e["ts"]
            end = start + e.get("dur", 0)
            while stack and start > stack[-1][2] - 1e-6:
                stack.pop()   # fully past: not enclosing anymore
            if stack:
                pid, pstart, pend = stack[-1]
                child[pid] = child.get(pid, 0.0) + max(
                    0.0, min(end, pend) - max(start, pstart))
            stack.append((id(e), start, end))
    totals: dict = {}
    for e in evs:
        excl = max(0.0, e.get("dur", 0) - child.get(id(e), 0.0))
        totals[e["name"]] = totals.get(e["name"], 0.0) + excl
    return totals


def _cmd_profile(url: str, seconds: float) -> int:
    """Drive a device-profile session on a live operator: start the
    torch.profiler session via /debug/profile?device=start, wait, stop it.
    The Chrome trace lands in the operator's $KARPENTER_PROFILE_DIR (the
    server picks the directory — a debug port is not a write-anywhere
    primitive); open it in Perfetto (ui.perfetto.dev)."""
    import time
    import urllib.error
    import urllib.request

    def hit(action: str) -> str:
        req = f"{url.rstrip('/')}/debug/profile?device={action}"
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.read().decode().strip()
        except urllib.error.HTTPError as e:
            raise SystemExit(
                f"profile {action} rejected: {e.read().decode().strip()}")
    print(hit("start"))
    try:
        time.sleep(max(0.0, seconds))
    finally:
        print(hit("stop"))
    return 0


def _cmd_show(path: str) -> int:
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", [])
    if not events:
        print("no traceEvents in file", file=sys.stderr)
        return 1
    by_trace: dict = {}
    for e in events:
        by_trace.setdefault(e.get("args", {}).get("trace_id", "?"),
                            []).append(e)
    for tid, evs in by_trace.items():
        root = min(evs, key=lambda e: e["ts"])
        print(f"{tid} root={root['name']} "
              f"dur={root.get('dur', 0) / 1e6:.4f}s spans={len(evs)}")
        totals = _exclusive_micros([e for e in evs if e is not root])
        for name, dur in sorted(totals.items(), key=lambda kv: -kv[1]):
            print(f"  {name:<24} {dur / 1e3:10.3f} ms")
    print(f"{len(by_trace)} traces, {len(events)} events")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch.obs")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_dump = sub.add_parser("dump", help="export traces as Chrome trace JSON")
    p_dump.add_argument("--url", default=None,
                        help="live operator metrics base URL "
                             "(http://host:port); omitted = in-process ring")
    p_dump.add_argument("--out", default=None, help="output file (- = stdout)")
    p_dump.add_argument("-n", type=int, default=None,
                        help="last N traces only")
    p_show = sub.add_parser("show", help="per-phase breakdown of a dump")
    p_show.add_argument("trace")
    p_prof = sub.add_parser(
        "profile", help="device-profile a live operator (torch.profiler "
                        "start/wait/stop via /debug/profile?device=)")
    p_prof.add_argument("--url", required=True,
                        help="live operator metrics base URL "
                             "(http://host:port; needs --enable-profiling "
                             "and $KARPENTER_PROFILE_DIR server-side)")
    p_prof.add_argument("--seconds", type=float, default=5.0,
                        help="capture window (default 5)")
    args = parser.parse_args(argv)
    if args.cmd == "dump":
        return _cmd_dump(args.url, args.out, args.n)
    if args.cmd == "profile":
        return _cmd_profile(args.url, args.seconds)
    return _cmd_show(args.trace)


if __name__ == "__main__":
    sys.exit(main())
