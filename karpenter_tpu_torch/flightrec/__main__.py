"""Flight-recorder trace CLI.

    python -m karpenter_tpu_torch.flightrec show   trace.jsonl
    python -m karpenter_tpu_torch.flightrec replay trace.jsonl [--index N]
        [--device cpu]

`replay` exits 0 only when every replayed record is verdict-clean
(deterministic vs the recorded decision AND tensor/host parity), so a
dumped production trace drops straight into CI as a regression gate. The
solvers run on the card unless ``--device`` names another device; a trace
recorded by the JAX package replays here as it does there.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .record import load_trace
from .recorder import FlightRecord
from .replay import replay_record


def _cmd_show(path: str) -> int:
    records = load_trace(path)
    for i, rec in enumerate(records):
        fr = FlightRecord(rec["kind"], rec["at"], rec["elapsed"],
                          rec.get("meta", {}), rec.get("decision"),
                          solve=rec.get("solve"))
        print(f"{i}: {fr.summary()}")
    print(f"{len(records)} records")
    return 0


def _cmd_replay(path: str, index: Optional[int], device: Optional[str]
                ) -> int:
    records = load_trace(path)
    if index is not None:
        if not 0 <= index < len(records):
            print(f"--index {index} out of range (trace has "
                  f"{len(records)} records)", file=sys.stderr)
            return 2
        records = [(index, records[index])]
    else:
        records = list(enumerate(records))
    failed = 0
    for i, rec in records:
        report = replay_record(rec, i, device)
        print(report.render())
        if not report.ok:
            failed += 1
    replayed = sum(1 for _, r in records if r.get("solve") is not None)
    print(f"replayed {replayed}/{len(records)} records, "
          f"{failed} verdict failures")
    return 1 if failed else 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch.flightrec")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_show = sub.add_parser("show", help="summarize a trace")
    p_show.add_argument("trace")
    p_replay = sub.add_parser(
        "replay", help="re-run tensor + host oracle, diff decisions")
    p_replay.add_argument("trace")
    p_replay.add_argument("--index", type=int, default=None,
                          help="replay only this record")
    p_replay.add_argument("--device", default=None,
                          help="torch device of the solves (default cuda; "
                               "cpu runs the kernels' plain versions)")
    args = parser.parse_args(argv)
    from .record import TraceVersionError
    try:
        if args.cmd == "show":
            return _cmd_show(args.trace)
        return _cmd_replay(args.trace, args.index, args.device)
    except TraceVersionError as e:
        print(str(e), file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
