"""Candidate collection, budgets, and the simulation bridge.

Mirrors karpenter's pkg/controllers/disruption/helpers.go:
- SimulateScheduling (:49-113): re-run the provisioning solver with the
  candidates' nodes removed and their reschedulable pods in the pending set;
- GetCandidates (:144-161): every disruptable StateNode as a Candidate;
- BuildDisruptionBudgetMapping (:197-245): per-nodepool allowed disruptions
  minus nodes already disrupting.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..api.nodeclaim import COND_INSTANCE_TERMINATING
from ..api.nodepool import NodePool
from ..api.objects import Pod
from ..api.policy import PodDisruptionBudget
from ..events import catalog as events_catalog
from ..obs.tracer import TRACER
from ..provisioning.provisioner import Provisioner
from ..state.cluster import Cluster
from ..utils import node as node_utils
from ..utils import pod as pod_utils
from ..utils.pdb import Limits
from .types import Candidate, CandidateError, new_candidate


def pods_by_node(cluster: Cluster) -> Dict[str, List[Pod]]:
    """One store pass -> node name -> active pods (avoids the O(nodes x pods)
    scan the per-node lookup would cost at 5k nodes)."""
    out: Dict[str, List[Pod]] = {}
    for p in cluster.store.list(Pod):
        if p.spec.node_name and pod_utils.is_active(p):
            out.setdefault(p.spec.node_name, []).append(p)
    return out


def pods_on_node(cluster: Cluster, sn) -> List[Pod]:
    from ..api.objects import Pod as PodKind
    return cluster.store.list(
        PodKind, predicate=lambda p: p.spec.node_name == sn.name()
        and pod_utils.is_active(p))


def build_pdb_limits(cluster: Cluster) -> Limits:
    store = cluster.store
    return Limits(store.list(PodDisruptionBudget), store.list(Pod))


def get_candidates(cluster: Cluster, provisioner: Provisioner,
                   should_disrupt, disrupting_provider_ids=(),
                   disruption_class: str = "graceful",
                   recorder=None, context=None) -> List[Candidate]:
    """helpers.go:144-161: candidates from disruptable cluster nodes that the
    method's ShouldDisrupt predicate accepts. Blocked candidates publish
    DisruptionBlocked for managed nodes (types.go:74-101: events only when
    NodeClaim != nil, so unmanaged nodes stay silent).

    `context` (a disruption.prefix.DisruptionSnapshot) supplies the
    pass-shared nodepool/instance-type/PDB/pod indexes so the four methods
    of one pass don't each re-list the store and re-fetch the catalog."""
    with TRACER.span("disruption.candidates") as sp:
        now = cluster.clock.now()
        if context is not None:
            nodepools = context.all_nodepools
            instance_types = context.it_maps
            pdb_limits = context.pdb_limits
            by_node = context.pods_by_node_map
        else:
            nodepools = {np.name: np for np in cluster.store.list(NodePool)}
            instance_types = {
                name: {it.name: it for it in
                       provisioner.cloud_provider.get_instance_types(np)}
                for name, np in nodepools.items()}
            pdb_limits = build_pdb_limits(cluster)
            by_node = pods_by_node(cluster)
        out: List[Candidate] = []
        nodes = blocked = 0
        # no deep copy here: new_candidate deep-copies the accepted nodes
        for sn in cluster.state_nodes(deep_copy=False):
            nodes += 1
            try:
                cand = new_candidate(now, sn, by_node.get(sn.name(), []),
                                     pdb_limits, nodepools, instance_types,
                                     disrupting_provider_ids,
                                     disruption_class)
            except CandidateError as err:
                blocked += 1
                if recorder is not None and sn.nodeclaim is not None:
                    recorder.publish(*events_catalog.disruption_blocked(
                        sn.name(), sn.nodeclaim.name, str(err)))
                continue
            if should_disrupt(cand):
                out.append(cand)
        sp.set(nodes=nodes, candidates=len(out), blocked=blocked)
    return out


def _node_not_ready(sn) -> bool:
    cond = node_utils.get_condition(sn.node, "Ready")
    # no Ready condition recorded: assume healthy (the in-process kubelet
    # sim doesn't stamp Ready; a real apiserver always does)
    return cond is not None and cond[0] != "True"


def build_disruption_budget_mapping(cluster: Cluster, reason: str,
                                    recorder=None) -> Dict[str, int]:
    """helpers.go:197-245: allowed = budget - already-disrupting, per pool.
    Only managed+initialized nodes count toward the total (uninitialized
    replacements must not inflate percentage budgets); claims with the
    InstanceTerminating condition are already gone; NotReady or
    marked-for-deletion nodes consume budget."""
    now = cluster.clock.now()
    allowed: Dict[str, int] = {}
    nodes_per_pool: Dict[str, int] = {}
    disrupting_per_pool: Dict[str, int] = {}
    for sn in cluster.state_nodes(deep_copy=False):
        pool = sn.nodepool_name()
        if not pool or not sn.managed() or not sn.initialized():
            continue
        if sn.nodeclaim is not None and \
                sn.nodeclaim.conditions.is_true(COND_INSTANCE_TERMINATING):
            continue
        nodes_per_pool[pool] = nodes_per_pool.get(pool, 0) + 1
        if sn.deleting() or _node_not_ready(sn):
            disrupting_per_pool[pool] = disrupting_per_pool.get(pool, 0) + 1
    for np in cluster.store.list(NodePool):
        total = np.allowed_disruptions(now, nodes_per_pool.get(np.name, 0), reason)
        allowed[np.name] = max(0, total - disrupting_per_pool.get(np.name, 0))
        # helpers.go:240-242: a populated pool whose budget is zero for this
        # reason tells the operator disruption is deliberately blocked
        if recorder is not None and nodes_per_pool.get(np.name, 0) != 0 \
                and total == 0:
            recorder.publish(
                events_catalog.nodepool_blocked_for_reason(np.name, reason))
    return allowed


def stamp_uninitialized_errors(results, exempt_uids) -> None:
    """helpers.go:93-111: a scheduling decision must not rest on managed
    nodes still mid-initialization — pods placed there become errors so the
    command is rejected, EXCEPT exempt pods (from deleting nodes, whose
    replacement node is assumed to come up). The ONE implementation of this
    rule: both the host-path simulate_scheduling and the snapshot replay
    (disruption/prefix.py) apply it, so they can never diverge."""
    for en in results.existing_nodes:
        sn = en.state_node if hasattr(en, "state_node") else None
        if sn is None or not sn.managed() or sn.initialized():
            continue
        for p in en.pods:
            if p.uid not in exempt_uids:
                results.pod_errors[p.uid] = (
                    f"would schedule against uninitialized node "
                    f"{sn.name()}")


def simulate_scheduling(cluster: Cluster, provisioner: Provisioner,
                        candidates: List[Candidate],
                        ride_along: Optional[List[Pod]] = None):
    """helpers.go:49-113: the bridge into the provisioning solver. Removes the
    candidates from the packable node set, marks their reschedulable pods
    pending, and solves. deleted-candidate races surface as CandidateError.

    `ride_along` is the deleting-node reschedulable-pod list when the caller
    already scanned it (the shared DisruptionSnapshot computes it once per
    disruption pass); None re-scans here for standalone callers."""
    candidate_ids = {c.provider_id for c in candidates}
    for c in candidates:
        sn = cluster.nodes.get(c.provider_id)
        if sn is None or sn.deleting():
            raise CandidateError("candidate is deleting")
    # read-only view: the solve never mutates StateNodes and the dispatch
    # loop is single-threaded, so the reference's defensive deep copy
    # (cluster.go:188-195) is unnecessary here — it costs O(nodes) per
    # consolidation probe
    state_nodes = [sn for sn in cluster.state_nodes(deep_copy=False)
                   if not sn.deleting() and sn.provider_id not in candidate_ids]
    pods = provisioner.get_pending_pods()
    # pods already being rescheduled from deleting nodes ride along
    if ride_along is None:
        ride_along = [p for sn in cluster.deleting_nodes()
                      for p in pods_on_node(cluster, sn)
                      if pod_utils.is_reschedulable(p)]
    deleting_pod_uids = set()
    for p in ride_along:
        pods.append(p)
        deleting_pod_uids.add(p.uid)
    reschedulable = [p for c in candidates for p in c.reschedulable_pods]
    results = provisioner.schedule_with(pods + reschedulable, state_nodes)
    stamp_uninitialized_errors(results, deleting_pod_uids)
    # pods that only became pending for the simulation must all land
    # (AllNonPendingPodsScheduled)
    sim_uids = {p.uid for p in reschedulable}
    non_pending_errors = {uid: e for uid, e in results.pod_errors.items()
                          if uid in sim_uids}
    return results, non_pending_errors
