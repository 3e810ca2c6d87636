"""Driver ``solve``: a provisioning solve of a pending burst, as the
Provisioner makes one each pass: ``TensorScheduler([pool], {pool: catalog},
state_nodes=nodes, device=...)`` built anew, then ``.solve(pods)``, the
device synchronised.

Traffic keys: ``bursts`` (distinct bursts a seed draws; the window cycles
through them), ``existing_nodes`` (solve against the configuration's
existing nodes, or from zero), ``judged`` (passes the check keeps, drawn
from the seed). A pass fails when it raises, falls back to the host
oracle, or leaves any pod off the tensor path."""

from __future__ import annotations

import numpy as np

from .. import objects, spec
from ..reference import solve_check


class Driver:
    numbers = ("feasibility_mismatch", "option_mismatch",
               "placement_violation", "unaccounted_pods",
               "existing_room_unused", "claims_mergeable")
    # the check compares the sum of the fault counts; a sound pass has none
    limit = 0

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 control: bool = False):
        self.cfg, self.device = cfg, device
        self.pool_name = cfg["nodepool"]
        self.types = spec.catalog(cfg)
        self.catalog = objects.instance_types(self.types)
        self.pool = objects.nodepool(self.pool_name)
        self.bursts = [spec.burst(cfg, seed, k)
                       for k in range(traffic["bursts"])]
        self.pods = [objects.pods(b, drop_host_rules=control)
                     for b in self.bursts]
        self.nodes, self.state_nodes = [], []
        if traffic["existing_nodes"]:
            self.nodes = spec.existing_nodes(cfg, self.types, seed)
            self.state_nodes = objects.state_nodes(
                self.nodes, {it.name: it for it in self.catalog},
                self.pool_name)
        self.judged = traffic["judged"]
        self.distinct = len(self.bursts)

    def step(self, i: int):
        """Pass ``i``: solve burst i mod bursts. Returns (failure reason or
        "", what the check reads of it)."""
        from karpenter_tpu_torch.provisioning.tensor_scheduler import \
            TensorScheduler
        k = i % len(self.bursts)
        pods = self.pods[k]
        ts = TensorScheduler([self.pool], {self.pool_name: self.catalog},
                             state_nodes=self.state_nodes, device=self.device)
        results = ts.solve(pods)
        _sync(ts.device)
        why = ""
        if ts.fallback_reason:
            why = f"fell back: {ts.fallback_reason}"
        elif ts.partition != (len(pods), 0):
            why = f"pods off the tensor path: {ts.partition}"
        return why, (k, results)

    # -- the check ------------------------------------------------------------

    def answer(self, kept, calls) -> dict:
        """The program's answer to one kept pass as plain data."""
        k, results = kept
        return {"burst": k, "claims": _claims(results),
                "existing": {en.name: [p.name for p in en.pods]
                             for en in results.existing_nodes},
                "errors": {_pod_name(uid): msg
                           for uid, msg in results.pod_errors.items()},
                "feasibility": self._feasibility(k, calls)}

    def _feasibility(self, k: int, calls):
        kept = [c for c in calls if "tensors" in c]
        if len(kept) != 1 or kept[0]["groups"] is None:
            return None
        c = kept[0]
        dep_of = self.bursts[k]["pod_deployment"]
        t, p = c["tensors"], c["problem"]
        zone_names = p.vocab.values[p.zone_key]
        out = {"groups": [dep_of[g.pods[0].name] for g in c["groups"]],
               "types": [it.name for it in c["catalog"]],
               "zones": [zone_names[z] for z in p.zone_values],
               "it_ok": t.it_ok[:, 0, :], "ppn": t.ppn[:, 0, :],
               "it_ok_z": t.it_ok_z[:, 0, :, :],
               "zone_adm": t.zone_adm[:, 0, :]}
        if self.nodes:
            out.update(exist_ok=np.asarray(t.exist_ok),
                       exist_cap=np.asarray(t.exist_cap),
                       nodes=[n["name"] for n in self.nodes])
        return out

    def judge(self, answers: list) -> dict:
        """Fault counts summed over the kept passes."""
        total = dict.fromkeys(self.numbers, 0)
        for a in answers:
            faults = solve_check.check(self.types, self.bursts[a["burst"]],
                                       self.nodes, a, self.pool_name)
            for key, v in faults.items():
                total[key] += v
        return total


def _pod_name(uid: str) -> str:
    return uid[len("uid-"):] if uid.startswith("uid-") else uid


_ZONE = "topology.kubernetes.io/zone"
_CT = "karpenter.sh/capacity-type"


def _claims(results) -> list:
    """Each new claim's pods, requirements and options by name; the option
    lists of one cohort are one object, so each is named once."""
    names: dict = {}
    out = []
    for c in results.new_nodeclaims:
        opts = c.instance_type_options
        if id(opts) not in names:
            names[id(opts)] = (opts, [it.name for it in opts])
        reqs, zones, cts = {}, None, None
        for key in c.requirements:
            r = c.requirements.get(key)
            values = r.values_list() if r.operator() == "In" else [
                f"{r.operator()}:{v}" for v in r.values_list()] or \
                [r.operator()]
            if key == _ZONE:
                zones = values
            elif key == _CT:
                cts = values
            else:
                reqs[key] = values
        out.append({"pods": [p.name for p in c.pods], "zones": zones,
                    "capacity_types": cts, "requirements": reqs,
                    "options": names[id(opts)][1]})
    return out


def _sync(device) -> None:
    if getattr(device, "type", str(device)).startswith("cuda"):
        import torch
        torch.cuda.synchronize()
