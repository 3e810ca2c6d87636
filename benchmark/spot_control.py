#!/usr/bin/env python3
"""The spot cell's check readings, at the cell's own size: sound seeds,
the control, and three faults planted in the program's answer.

    python3 benchmark/spot_control.py --workload spot-consolidation-2k6z \
        --sound N [N ...] --control N [N ...] [--plant KIND] [--device cuda]

Each ``--sound`` seed runs the cell's passes as the timed path does, each
judged. Each ``--control`` seed serves the launch-time prices ``p0`` to
the program while the check judges under the current ``p1``; with
``--plant`` the control seeds instead carry one of PLANTS in every answer,
the decision rewritten from the reference's own records:

- ``uncapped``: a replacement whose options are every cheaper type, not
  the 15 cheapest, of a winnable candidate with more than 15;
- ``under_floor``: a spot replacement of a candidate with 1 to 14 cheaper
  types;
- ``costlier``: the least costly winnable candidates skipped for the
  correct command of a costlier one.

Each seed prints one JSON line: the check's numbers and, from the
program's trace of its last pass, the classifier's verdict counts and the
price vectors it built. The last line gives, for each number, the largest
sound reading and the smallest control reading. The benchmark's own runs
never run this."""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.reference import spot_check  # noqa: E402


def _command(driver, i: int, options: list) -> dict:
    """Node i's replacement by a claim of all its pods, with ``options``."""
    node = driver.fleet["nodes"][i]
    return {"decision": "replace", "candidates": [node["name"]],
            "placements": {},
            "claims": [{"pods": list(node["pods"]), "capacity_types": ["spot"],
                        "options": [driver.types[t]["name"]
                                    for t in options]}]}


def _winners(driver) -> list:
    """The reference's replaceable candidates, least costly first, as
    (cost, node, options uncapped)."""
    fl, verdicts = driver.reference()
    rem = fl.remainders()
    return sorted((int(fl.reps[i]), i, fl.options(i, int(rem[i])))
                  for i, v in verdicts.items() if v == "replace")


def uncapped(driver, answer: dict) -> dict:
    for cost, i, options in _winners(driver):
        if len(options) > spot_check.MIN_SPOT_TYPES:
            return _command(driver, i, options)
    raise LookupError("no winnable candidate has more than 15 cheaper types")


def under_floor(driver, answer: dict) -> dict:
    fl, verdicts = driver.reference()
    rem = fl.remainders()
    for i, node in enumerate(driver.fleet["nodes"]):
        if node["do_not_disrupt"] or i in verdicts or rem[i] == 0:
            continue
        options = fl.options(i, int(rem[i]))
        if options:
            return _command(driver, i, options)
    raise LookupError("no candidate has 1 to 14 cheaper types")


def costlier(driver, answer: dict) -> dict:
    winners = _winners(driver)
    for cost, i, options in winners:
        if cost > winners[0][0]:
            return _command(driver, i, options[:spot_check.MIN_SPOT_TYPES])
    raise LookupError("every winnable candidate has the least cost")


PLANTS = {"uncapped": uncapped, "under_floor": under_floor,
          "costlier": costlier}


def counters() -> dict:
    """The last decision's classifier counts and price vectors, from the
    program's trace."""
    from karpenter_tpu_torch.obs.tracer import TRACER
    trace = TRACER.last()
    out: dict = {}
    for sp in (trace.spans if trace is not None else []):
        if sp.name == "disruption.loo":
            out.update(sp.attrs)
        elif sp.name == "disruption.prices":
            out["prices_spans"] = out.get("prices_spans", 0) + 1
            out["vectors"] = out.get("vectors", 0) + sp.attrs.get("vectors", 0)
    return out


def readings(workload: str, seed: int, control: bool, device: str,
             cell=None, plant: str = "") -> tuple:
    """(the check's numbers, the last pass's counters) for one seed."""
    from benchmark import harness
    from benchmark.probe import Probe
    _, cfg, traffic, _, _ = cell or harness.load_cell(workload)
    driver = importlib.import_module(
        f"benchmark.drivers.{traffic['driver']}").Driver(
            cfg, traffic, seed, device, control=control and not plant)
    probe = Probe()
    answers = []
    with probe.installed():
        for i in range(max(driver.distinct, driver.judged)):
            probe.new_pass(True)
            why, kept = driver.step(i)
            if why:
                raise RuntimeError(f"pass {i}: {why}")
            answers.append(driver.answer(kept, probe.calls))
    if plant:
        answers = [PLANTS[plant](driver, a) for a in answers]
    return driver.judge(answers), counters()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="spot-consolidation-2k6z")
    ap.add_argument("--sound", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--plant", choices=sorted(PLANTS), default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    lower, upper = {}, {}
    for control, seeds in ((False, args.sound), (True, args.control)):
        for seed in seeds:
            t0 = time.perf_counter()
            nums, counts = readings(args.workload, seed, control, args.device,
                                    plant=control and args.plant)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": control, "plant": args.plant,
                              "numbers": nums, "counters": counts,
                              "s": time.perf_counter() - t0}), flush=True)
            for k, v in {**nums, "faults": sum(nums.values())}.items():
                if control:
                    upper[k] = min(upper.get(k, v), v)
                else:
                    lower[k] = max(lower.get(k, v), v)
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
