#!/usr/bin/env python3
"""Run one benchmark cell of karpenter_tpu_torch once, on NVIDIA GPUs.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout. The cell (BENCHMARK.json ``workloads``)
names its configuration, traffic mix and metrics. The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``, each number the check compared beside
its limit (also the last lines of standard error). Without CUDA, with
fewer devices than the cell asks for, or with JAX or the JAX package
loaded, it exits non-zero and prints no result.
"""

from __future__ import annotations

import os
import time


def _process_age() -> float:
    """Seconds since this process started (Linux /proc; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


STARTED = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _host_threads(workload: str) -> None:
    """Hold the program's numpy and torch to the host cores the cell's
    configuration gives the controller (``controller.cpu_limit``). Set
    before numpy or torch loads, as their thread pools read it then."""
    from benchmark import harness
    n = str(harness.load_cell(workload)[1]["controller"]["cpu_limit"])
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _host_threads(args.workload)
    import torch
    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    from benchmark import harness
    try:
        out = harness.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), STARTED)
    except (harness.NoDevice, harness.Forbidden) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
