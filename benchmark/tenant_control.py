#!/usr/bin/env python3
"""The tenant cell's check readings, at the cell's own size: sound seeds,
the control, and three faults planted in the program's answer.

    python3 benchmark/tenant_control.py --sound N [N ...] \
        --control N [N ...] [--plant KIND] [--device cuda]

Each ``--sound`` seed runs the cell's passes as the timed path does, each
judged. Each ``--control`` seed gives every pod a toleration of every
taint while the check judges the burst as stated; with ``--plant`` the
control seeds instead carry one of PLANTS in every answer, rewritten from
the reference's own records:

- ``foreign_node``: one team pod moved onto another team's existing node;
- ``lower_pool``: a claim of the highest-weight pool moved to a pool of
  lower weight that also admits its pods, with that pool's options;
- ``selector_dropped``: a claim whose pods select an architecture given
  the options of every architecture, the selector's requirement dropped.

Each seed prints one JSON line of the check's numbers and, from the
program's trace of its last pass, the ``encode.taints`` counts; the last
line gives, for each number, the largest sound reading and the smallest
control reading. The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WORKLOAD = "solve-tenants-5k-nodes"


def readings(seed: int, control: bool, device: str, cell=None,
             plant: str = ""):
    """(the check's numbers, the last pass's ``encode.taints`` attributes)
    for one seed: sound, the control, or with ``plant`` one of PLANTS in
    every answer."""
    from benchmark import harness
    from benchmark.drivers.tenant_solve import Driver
    from benchmark.probe import Probe
    from karpenter_tpu_torch.obs.tracer import TRACER
    _, cfg, traffic, _, _ = cell or harness.load_cell(WORKLOAD)
    driver = Driver(cfg, traffic, seed, device, control=control and not plant)
    probe = Probe()
    answers = []
    with probe.installed():
        for i in range(max(driver.distinct, driver.judged)):
            probe.new_pass(True)
            why, kept = driver.step(i)
            if why:
                raise RuntimeError(f"pass {i}: {why}")
            answers.append(driver.answer(kept, probe.calls))
    trace = TRACER.last()
    taints = next((dict(s.attrs) for s in trace.spans
                   if s.name == "encode.taints"), {}) if trace else {}
    if plant:
        answers = [PLANTS[plant](driver, a) for a in answers]
    return driver.judge(answers), taints


def _deps(driver, answer: dict, pods: list) -> list:
    burst = driver.bursts[answer["burst"]]
    return [burst["deployments"][burst["pod_deployment"][p]] for p in pods]


def foreign_node(driver, answer: dict) -> dict:
    """One team pod moved onto an existing node of another team."""
    burst = driver.bursts[answer["burst"]]
    placed = [p for pods in answer["existing"].values() for p in pods] + \
        [p for c in answer["claims"] for p in c["pods"]]
    pod = next(p for p in placed
               if burst["deployments"][burst["pod_deployment"][p]]["team"])
    team = burst["deployments"][burst["pod_deployment"][pod]]["team"]
    node = next(n["name"] for n in driver.nodes
                if n["taints"] and team not in n["labels"].values())
    claims = [{**c, "pods": [p for p in c["pods"] if p != pod]}
              for c in answer["claims"]]
    existing = {name: [p for p in pods if p != pod]
                for name, pods in answer["existing"].items()}
    existing[node] = existing.get(node, []) + [pod]
    return {**answer, "claims": claims, "existing": existing}


def _reoption(driver, c: dict, pool: dict, deps: list, labels=None) -> dict:
    """Claim ``c`` moved to ``pool``, with the reference's options for its
    pods there (type labels ``labels`` in place of what they select)."""
    from benchmark.reference import solve_check, tenant_check
    ref = tenant_check.Reference(driver.types, driver.pools, [])
    cts, want = ref.allowed(pool, deps)
    total = sum(solve_check.requests(d) for d in deps)
    reqs = {k: v for k, v in c["requirements"].items()
            if k not in solve_check.TYPE_LABELS}
    reqs["karpenter.sh/nodepool"] = [pool["name"]]
    return {**c, "pool": pool["name"], "taints": list(pool["taints"]),
            "capacity_types": cts, "requirements": reqs,
            "options": ref.cat.options(total, c["zones"], cts,
                                       want if labels is None else labels)}


def lower_pool(driver, answer: dict) -> dict:
    """The pods of a claim of the highest-weight pool that a lower pool
    admits, moved onto a claim of that pool with its options; the rest
    stay, with their own options."""
    from benchmark import tenant_spec
    from benchmark.reference import tenant_check
    order = tenant_spec.by_weight(driver.pools)
    ref = tenant_check.Reference(driver.types, driver.pools, [])
    for i, c in enumerate(answer["claims"]):
        if c["pool"] != order[0]["name"]:
            continue
        for lower in order[1:]:
            moved = [p for p, d in zip(c["pods"], _deps(driver, answer,
                                                        c["pods"]))
                     if ref.admits(lower, d)]
            if not moved:
                continue
            kept = [p for p in c["pods"] if p not in set(moved)]
            claims = list(answer["claims"])
            claims[i:i + 1] = [
                _reoption(driver, {**c, "pods": pods}, pool,
                          _deps(driver, answer, pods))
                for pods, pool in ((kept, order[0]), (moved, lower)) if pods]
            return {**answer, "claims": claims}
    raise LookupError("no pod of a claim of the first pool is admitted by "
                      "another")


def selector_dropped(driver, answer: dict) -> dict:
    """A claim whose pods select an architecture, given every
    architecture's options."""
    arch = "kubernetes.io/arch"
    pools = {p["name"]: p for p in driver.pools}
    for i, c in enumerate(answer["claims"]):
        deps = _deps(driver, answer, c["pods"])
        if any(arch in d["selector"] for d in deps):
            claims = list(answer["claims"])
            claims[i] = _reoption(driver, c, pools[c["pool"]], deps,
                                  labels={})
            return {**answer, "claims": claims}
    raise LookupError("no claim holds pods that select an architecture")


PLANTS = {"foreign_node": foreign_node, "lower_pool": lower_pool,
          "selector_dropped": selector_dropped}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sound", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--plant", choices=sorted(PLANTS), default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    lower, upper = {}, {}
    for control, seeds in ((False, args.sound), (True, args.control)):
        for seed in seeds:
            t0 = time.perf_counter()
            nums, taints = readings(seed, control, args.device,
                                    plant=control and args.plant)
            print(json.dumps({"workload": WORKLOAD, "seed": seed,
                              "control": control, "plant": args.plant,
                              "numbers": nums, "encode.taints": taints,
                              "s": time.perf_counter() - t0}), flush=True)
            for k, v in {**nums, "faults": sum(nums.values())}.items():
                if control:
                    upper[k] = min(upper.get(k, v), v)
                else:
                    lower[k] = max(lower.get(k, v), v)
    print(json.dumps({"workload": WORKLOAD, "lower": lower, "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
