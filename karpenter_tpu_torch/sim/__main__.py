"""Fleet-simulator CLI.

    python -m karpenter_tpu_torch.sim run scenario.yaml [--out report.json]
        [--ledger ledger.jsonl] [--flightrec-dir DIR] [--seed N] [--json]
        [--device cuda|cpu|cuda:N]
    python -m karpenter_tpu_torch.sim report report.json
    python -m karpenter_tpu_torch.sim validate scenario.yaml

``run`` replays the scenario and prints the human-readable SLO report
(``--json`` prints the report dict instead); ``--out``/``--ledger`` write
the report and the deterministic event ledger to disk. SLO-breach flight
dumps land in ``--flightrec-dir`` (default: the system tempdir).
``validate`` only loads + schema-checks the scenario — a CI-friendly
loud-failure gate for scenario edits. ``run`` solves on ``--device``
(default: the card; without one it exits non-zero unless ``cpu`` is
named) and prints that device on a line of its own before the report.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .report import render_report
from .scenario import ScenarioError, load_scenario


def _cmd_run(args) -> int:
    try:
        scenario = load_scenario(args.scenario)
    except ScenarioError as exc:
        print(f"scenario rejected: {exc}", file=sys.stderr)
        return 2
    if args.seed is not None:
        scenario.seed = args.seed
    from ..ops.binpack import resolve_device
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:
        print(f"device rejected: {exc}", file=sys.stderr)
        return 2
    from .engine import FleetSimulator
    sim = FleetSimulator(scenario, flightrec_dir=args.flightrec_dir,
                         device=device)
    print(f"fleet simulator device: {sim.device}", flush=True)
    report = sim.run()
    if args.ledger:
        n = sim.ledger.dump(args.ledger)
        print(f"ledger: {n} entries -> {args.ledger}", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        print(f"report -> {args.out}", file=sys.stderr)
    print(json.dumps(report, indent=2, sort_keys=True) if args.json
          else render_report(report))
    return 0


def _cmd_report(args) -> int:
    try:
        with open(args.report) as f:
            report = json.load(f)
        rendered = render_report(report)
    except OSError as exc:
        print(f"report rejected: {exc}", file=sys.stderr)
        return 2
    except (json.JSONDecodeError, KeyError, TypeError, AttributeError) as exc:
        print(f"report rejected: {args.report}: not a report JSON "
              f"(expected the `run --out` file, not the ledger): {exc}",
              file=sys.stderr)
        return 2
    print(rendered)
    return 0


def _cmd_validate(args) -> int:
    try:
        scenario = load_scenario(args.scenario)
    except ScenarioError as exc:
        print(f"scenario rejected: {exc}", file=sys.stderr)
        return 2
    print(f"{scenario.source}: ok — {scenario.name!r}, "
          f"{len(scenario.events)} events over "
          f"{scenario.duration / 3600.0:g} h, seed {scenario.seed}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m karpenter_tpu_torch.sim")
    sub = parser.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="replay a scenario, print the report")
    run.add_argument("scenario")
    run.add_argument("--out", help="write the report JSON here")
    run.add_argument("--ledger", help="write the event ledger JSONL here")
    run.add_argument("--flightrec-dir",
                     help="directory for SLO-breach flight dumps")
    run.add_argument("--seed", type=int, default=None,
                     help="override the scenario seed")
    run.add_argument("--json", action="store_true",
                     help="print the report as JSON")
    run.add_argument("--device", default=None,
                     help="device the solves run on (default: the card; "
                          "name cpu to run without one)")
    rep = sub.add_parser("report", help="render a saved report JSON")
    rep.add_argument("report")
    val = sub.add_parser("validate", help="schema-check a scenario file")
    val.add_argument("scenario")
    args = parser.parse_args(argv)
    return {"run": _cmd_run, "report": _cmd_report,
            "validate": _cmd_validate}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
