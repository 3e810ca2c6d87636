"""Command validation after the consolidation TTL.

Mirrors karpenter's pkg/controllers/disruption/validation.go:83-215: a
computed command executes only after a 15 s TTL (consolidation.go:44) and
re-validation: the candidates must still be disruptable, the budgets must
still admit them, and for replace commands a fresh simulation must produce
at most one replacement whose instance types are a subset of the original
options (so the cluster didn't move under the decision).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..provisioning.provisioner import Provisioner
from ..state.cluster import Cluster
from .helpers import build_disruption_budget_mapping
from .types import Candidate, CandidateError, Command, new_candidate

CONSOLIDATION_TTL_SECONDS = 15.0  # consolidation.go:44


def validate_command(cluster: Cluster, provisioner: Provisioner,
                     command: Command, reason: str,
                     disrupting_provider_ids=(), snapshot=None) -> bool:
    """validation.go ValidateCandidates + ValidateCommand.

    `snapshot` (disruption.prefix.DisruptionSnapshot) shares the validation
    pass's encode: the fresh-candidate context comes from one store pass
    and the re-check simulation replays over the shared tensors instead of
    rebuilding the solver; None builds one here."""
    from .prefix import DisruptionSnapshot

    now = cluster.clock.now()
    if snapshot is None:
        snapshot = DisruptionSnapshot(cluster, provisioner)

    fresh: List[Candidate] = []
    for c in command.candidates:
        sn = cluster.nodes.get(c.provider_id)
        if sn is None:
            return False
        try:
            fresh.append(new_candidate(
                now, sn, snapshot.pods_by_node_map.get(sn.name(), []),
                snapshot.pdb_limits, snapshot.all_nodepools,
                snapshot.it_maps, disrupting_provider_ids))
        except CandidateError:
            return False

    budgets = build_disruption_budget_mapping(cluster, reason)
    per_pool: Dict[str, int] = {}
    for c in fresh:
        per_pool[c.nodepool_name] = per_pool.get(c.nodepool_name, 0) + 1
    for pool, n in per_pool.items():
        if n > budgets.get(pool, 0):
            return False

    if not command.replacements:
        # delete-only: candidates must still pack onto the rest of the
        # cluster with zero new nodes (emptiness: zero reschedulable pods)
        if all(not c.reschedulable_pods for c in fresh):
            return True
        try:
            results, sim_errors = snapshot.simulate(fresh)
        except CandidateError:
            return False
        return not sim_errors and not results.new_nodeclaims

    # replace: the fresh sim must still want exactly one new node, and the
    # command's (price-filtered) instance types must be a subset of the fresh
    # (unfiltered) options — otherwise the cluster moved and the launch could
    # be as or more expensive (validation.go:155-215)
    try:
        results, sim_errors = snapshot.simulate(fresh)
    except CandidateError:
        return False
    if sim_errors:
        return False
    if len(results.new_nodeclaims) != 1:
        return False  # 0 => better option exists now; >1 => never valid
    command_names = {it.name for r in command.replacements
                     for it in r.instance_type_options}
    fresh_names = {it.name
                   for it in results.new_nodeclaims[0].instance_type_options}
    return bool(command_names) and command_names.issubset(fresh_names)
