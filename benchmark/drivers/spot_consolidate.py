"""Driver ``spot_consolidate``: one single-node consolidation decision over
the standing spot fleet after its prices moved, as the disruption poll
makes it with SpotToSpotConsolidation on: ``get_candidates`` then
``SingleNodeConsolidation(..., spot_to_spot_enabled=True)
.compute_command`` with the budget lifted to the fleet, the device
synchronised. The command is computed, never executed, so every pass
decides over the same fleet.

Traffic keys: ``method`` ("single"), ``spot_to_spot`` (the feature gate),
``judged`` (passes the check keeps, drawn from the seed). A pass fails when
it raises, or when the method decided without its batched leave-one-out
classifier.

The control serves the launch-time prices ``p0`` in place of the current
``p1`` the check judges under: it breaks "cheaper under the current
prices"."""

from __future__ import annotations

from .. import spot_objects, spot_spec
from ..reference import spot_check
from .solve import _sync


class Driver:
    numbers = spot_check.FAULTS
    # the check compares the sum of the fault counts; a sound pass has none
    limit = 0

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 control: bool = False):
        from karpenter_tpu_torch.disruption.methods import \
            SingleNodeConsolidation
        if traffic["method"] != "single":
            raise ValueError(f"unknown consolidation method "
                             f"{traffic['method']!r}")
        self.types = spot_spec.catalog(cfg, seed)
        self.fleet = spot_spec.fleet(cfg, self.types, seed)
        self.served = "p0" if control else "p1"
        self.env = spot_objects.live_fleet(
            self.fleet, spot_objects.instance_types(self.types, self.served),
            cfg["nodepool"], device)
        self.pool_name = cfg["nodepool"]
        self.method = SingleNodeConsolidation(
            self.env.cluster, self.env.provisioner,
            spot_to_spot_enabled=traffic["spot_to_spot"])
        self.judged = traffic["judged"]
        self.distinct = 1
        self._ref = None

    def step(self, i: int):
        from karpenter_tpu_torch.disruption.helpers import get_candidates
        from karpenter_tpu_torch.obs.tracer import TRACER
        with TRACER.span("bench.decision"):
            cands = get_candidates(self.env.cluster, self.env.provisioner,
                                   self.method.should_disrupt)
            cmd, results = self.method.compute_command(
                {self.pool_name: len(cands)}, cands)
        _sync(self.env.provisioner.device)
        if self.method.last_engine_stats is None:
            return "decided without the batched classifier", None
        return "", (cmd, results)

    def answer(self, kept, calls) -> dict:
        cmd, results = kept
        out = {"decision": cmd.decision,
               "candidates": [c.name for c in cmd.candidates],
               "placements": {}, "claims": []}
        if results is not None:
            out["placements"] = {en.name: [p.name for p in en.pods]
                                 for en in results.existing_nodes}
        for r in cmd.replacements:
            ct = r.requirements.get("karpenter.sh/capacity-type")
            out["claims"].append({
                "pods": [p.name for p in r.pods],
                "capacity_types": (ct.values_list() if ct.operator() == "In"
                                   else [ct.operator()]),
                "options": [it.name for it in r.instance_type_options]})
        return out

    def reference(self) -> spot_check.Fleet:
        """The reference's view of the fleet under the current prices, and
        its verdicts, worked out once."""
        if self._ref is None:
            fl = spot_check.Fleet(self.types, self.fleet, "p1")
            self._ref = (fl, fl.verdicts())
        return self._ref

    def judge(self, answers: list) -> dict:
        fl, verdicts = self.reference()
        total = dict.fromkeys(self.numbers, 0)
        for a in answers:
            for key, v in spot_check.check(fl, a, verdicts).items():
                total[key] += v
        return total
