#!/usr/bin/env python3
"""The readings the check's limits are set from, at a cell's own size.

    python3 benchmark/control.py --workload NAME --sound N [N ...] \
        --control N [N ...] [--plant KIND] [--device cuda]

For each ``--sound`` seed the program serves the cell's inputs as the
timed path does (one pass for each distinct input, each judged); for each
``--control`` seed it serves them with one stated guarantee broken (the
burst's hostname spreads and anti-affinities left out; the fleet's
do-not-disrupt annotations ignored) and is judged against the inputs as
stated. With ``--plant`` the control seeds instead carry one fault of the
pack's planted in each solve's answer, the reference put in the program's
place where the fault needs new options: ``claim_per_pod`` gives every pod
a claim of its own, ``existing_ignored`` moves each existing node's pods
onto a new claim in that node's zone. Each seed prints one JSON line of
the numbers the check compares;
the last line gives, for each number, the largest sound reading (the
lower end of its limit) and the smallest control reading (the upper end).
The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def readings(workload: str, seed: int, control: bool, device: str,
             cell=None, plant: str = "") -> dict:
    """The check's numbers for one seed: sound, the control, or with
    ``plant`` one of PLANTS in every answer."""
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
    return driver.judge(answers)


def _claim(driver, pods: list, zones, cts, requirements: dict, k: int) -> dict:
    """A claim of ``pods`` of burst ``k`` with the reference's options."""
    from benchmark.reference import solve_check as ref
    burst = driver.bursts[k]
    cat = getattr(driver, "_ref_catalog", None) or ref.Catalog(driver.types)
    driver._ref_catalog = cat
    total = sum(ref.requests(burst["deployments"][burst["pod_deployment"][p]])
                for p in pods)
    labels = {key: set(v) for key, v in requirements.items()
              if key in ref.TYPE_LABELS}
    return {"pods": list(pods), "zones": zones, "capacity_types": cts,
            "requirements": requirements,
            "options": cat.options(total, zones, cts, labels)}


def claim_per_pod(driver, answer: dict) -> dict:
    """Every pod of a new claim on a claim of its own."""
    claims = [_claim(driver, [p], c["zones"], c["capacity_types"],
                     c["requirements"], answer["burst"])
              for c in answer["claims"] for p in c["pods"]]
    return {**answer, "claims": claims}


def existing_ignored(driver, answer: dict) -> dict:
    """Each existing node's pods on a new claim in the node's zone."""
    zone = {n["name"]: n["zone"] for n in driver.nodes}
    moved = [_claim(driver, pods, [zone[name]], None, {}, answer["burst"])
             for name, pods in answer["existing"].items() if pods]
    return {**answer, "claims": answer["claims"] + moved, "existing": {}}


PLANTS = {"claim_per_pod": claim_per_pod, "existing_ignored": existing_ignored}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sound", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--plant", choices=sorted(PLANTS), default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    lower, upper = {}, {}
    for control, seeds in ((False, args.sound), (True, args.control)):
        for seed in seeds:
            t0 = time.perf_counter()
            nums = readings(args.workload, seed, control, args.device,
                            plant=control and args.plant)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": control, "plant": args.plant,
                              "numbers": nums,
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
