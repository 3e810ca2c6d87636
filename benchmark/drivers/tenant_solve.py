"""Driver ``tenant_solve``: a provisioning solve of a pending burst over
several weighted NodePools, as the Provisioner makes one each pass:
``TensorScheduler(order_by_weight(pools), {pool: catalog, ...},
state_nodes=nodes, device=...)`` built anew, then ``.solve(pods)``, the
device synchronised.

Traffic keys: ``bursts`` (distinct bursts a seed draws; the window cycles
through them), ``judged`` (passes the check keeps, drawn from the seed).
The solve always runs against the configuration's existing nodes. A pass
fails when it raises, falls back to the host oracle, or leaves any pod off
the tensor path.

The control gives every pod a toleration of every taint, while the check
judges the burst as stated: it breaks "no pod on a node or claim whose
taints it does not tolerate"."""

from __future__ import annotations

import numpy as np

from .. import objects, spec, tenant_objects, tenant_spec
from ..reference import tenant_check
from .solve import _claims, _pod_name, _sync


class Driver:
    numbers = tenant_check.FAULTS
    # the check compares the sum of the fault counts; a sound pass has none
    limit = 0

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 control: bool = False):
        from karpenter_tpu_torch.api.nodepool import order_by_weight
        self.device = device
        self.types = spec.catalog(cfg)
        self.catalog = objects.instance_types(self.types)
        self.pools = tenant_spec.nodepools(cfg)
        self.nodepools = order_by_weight(tenant_objects.nodepools(self.pools))
        self.bursts = [tenant_spec.burst(cfg, seed, k)
                       for k in range(traffic["bursts"])]
        self.pods = [tenant_objects.pods(b, tolerate_all=control)
                     for b in self.bursts]
        self.nodes = tenant_spec.existing_nodes(cfg, self.types, seed)
        self.state_nodes = tenant_objects.state_nodes(
            self.nodes, {it.name: it for it in self.catalog})
        self.judged = traffic["judged"]
        self.distinct = len(self.bursts)

    def step(self, i: int):
        """Pass ``i``: solve burst i mod bursts. Returns (failure reason or
        "", what the check reads of it)."""
        from karpenter_tpu_torch.provisioning.tensor_scheduler import \
            TensorScheduler
        k = i % len(self.bursts)
        pods = self.pods[k]
        ts = TensorScheduler(self.nodepools,
                             {p.name: self.catalog for p in self.nodepools},
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
        """The program's answer to one kept pass as plain data: each claim
        also with its NodePool and the taints it would launch with."""
        k, results = kept
        claims = _claims(results)
        for c, claim in zip(results.new_nodeclaims, claims):
            claim.update(pool=c.template.nodepool_name,
                         taints=[(t.key, t.value, t.effect)
                                 for t in c.template.taints])
        return {"burst": k, "claims": claims,
                "existing": {en.name: [p.name for p in en.pods]
                             for en in results.existing_nodes},
                "errors": {_pod_name(uid): msg
                           for uid, msg in results.pod_errors.items()},
                "feasibility": self._feasibility(k, calls)}

    def _feasibility(self, k: int, calls):
        """The device's existing-node fit and capacity of the kept pass,
        its rows named by deployment and its columns by node."""
        kept = [c for c in calls if "tensors" in c]
        if len(kept) != 1 or kept[0]["groups"] is None:
            return None
        c = kept[0]
        dep_of = self.bursts[k]["pod_deployment"]
        t = c["tensors"]
        return {"groups": [dep_of[g.pods[0].name] for g in c["groups"]],
                "nodes": [n["name"] for n in self.nodes],
                "exist_ok": np.asarray(t.exist_ok),
                "exist_cap": np.asarray(t.exist_cap)}

    def judge(self, answers: list) -> dict:
        """Fault counts summed over the kept passes."""
        total = dict.fromkeys(self.numbers, 0)
        ref = tenant_check.Reference(self.types, self.pools, self.nodes)
        for a in answers:
            for key, v in ref.check(self.bursts[a["burst"]], a).items():
                total[key] += v
        return total
