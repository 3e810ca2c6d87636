"""Driver ``consolidate``: one multi-node consolidation decision over the
standing fleet, as the disruption poll makes it: ``get_candidates`` then
``MultiNodeConsolidation.compute_command`` with the budget lifted to the
fleet, the device synchronised. The command is computed, never executed,
so every pass decides over the same fleet.

Traffic keys: ``method`` ("multi"), ``judged`` (passes the check keeps,
drawn from the seed). A pass fails when it raises."""

from __future__ import annotations

from .. import objects, spec
from ..reference import consolidate_check
from .solve import _claims, _sync


class Driver:
    numbers = ("protected_candidates", "candidate_shortfall",
               "wrong_decision", "placement_violation")
    # the check compares the sum of the fault counts; a sound pass has none
    limit = 0

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 control: bool = False):
        from karpenter_tpu_torch.disruption.methods import \
            MultiNodeConsolidation
        if traffic["method"] != "multi":
            raise ValueError(f"unknown consolidation method "
                             f"{traffic['method']!r}")
        self.types = spec.catalog(cfg)
        self.fleet = spec.fleet(cfg, self.types, seed)
        self.env = objects.live_fleet(
            self.fleet, objects.instance_types(self.types), cfg["nodepool"],
            device, honour_do_not_disrupt=not control)
        self.pool_name = cfg["nodepool"]
        self.method = MultiNodeConsolidation(self.env.cluster,
                                             self.env.provisioner)
        self.judged = traffic["judged"]
        self.distinct = 1

    def step(self, i: int):
        from karpenter_tpu_torch.disruption.helpers import get_candidates
        from karpenter_tpu_torch.obs.tracer import TRACER
        with TRACER.span("bench.decision"):
            with TRACER.span("bench.candidates"):
                cands = get_candidates(self.env.cluster,
                                       self.env.provisioner,
                                       self.method.should_disrupt)
            cmd, results = self.method.compute_command(
                {self.pool_name: len(cands)}, cands)
        _sync(self.env.provisioner.device)
        return "", (cmd, results)

    def answer(self, kept, calls) -> dict:
        cmd, results = kept
        out = {"decision": cmd.decision,
               "candidates": [c.name for c in cmd.candidates],
               "placements": {}, "claims": []}
        if results is not None:
            out["placements"] = {en.name: [p.name for p in en.pods]
                                 for en in results.existing_nodes}
            out["claims"] = _claims(results)
        return out

    def judge(self, answers: list) -> dict:
        total = dict.fromkeys(self.numbers, 0)
        for a in answers:
            for key, v in consolidate_check.check(self.types, self.fleet,
                                                  a).items():
                total[key] += v
        return total
