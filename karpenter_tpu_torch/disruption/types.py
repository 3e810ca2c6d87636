"""Disruption solver core types.

Mirrors karpenter's pkg/controllers/disruption/types.go: the Method
interface shape, Candidate (StateNode + pricing context + disruptionCost),
and Command (candidates to delete + replacements to launch).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..api import labels as api_labels
from ..api.nodepool import NodePool
from ..api.objects import Pod
from ..cloudprovider.types import InstanceType
from ..scheduling.requirements import label_requirements
from ..state.statenode import StateNode
from ..utils import disruption as disruption_utils
from ..utils import pod as pod_utils
from ..utils.pdb import Limits

GRACEFUL = "graceful"   # respects blocking PDBs + do-not-disrupt
EVENTUAL = "eventual"   # bounded by TerminationGracePeriod instead


class CandidateError(Exception):
    pass


class PodBlockEvictionError(CandidateError):
    pass


@dataclass
class Candidate:
    """types.go:105-114."""
    state_node: StateNode
    nodepool: NodePool
    instance_type: Optional[InstanceType]
    zone: str
    capacity_type: str
    reschedulable_pods: List[Pod]
    disruption_cost: float

    @property
    def provider_id(self) -> str:
        return self.state_node.provider_id

    @property
    def name(self) -> str:
        return self.state_node.name()

    @property
    def nodepool_name(self) -> str:
        return self.state_node.nodepool_name()

    def price(self) -> Optional[float]:
        """Current offering price (consolidation.go getCandidatePrices)."""
        if self.instance_type is None:
            return None
        reqs = label_requirements(self.state_node.labels())
        offs = self.instance_type.offerings.compatible(reqs)
        if not offs:
            return None
        return max(o.price for o in offs)


def new_candidate(now: float, node: StateNode, pods_on_node: List[Pod],
                  pdb_limits: Limits, nodepools: Dict[str, NodePool],
                  instance_types: Dict[str, Dict[str, InstanceType]],
                  disrupting_provider_ids=(),
                  disruption_class: str = GRACEFUL) -> Candidate:
    """types.go NewCandidate: every gate raises CandidateError with the
    blocking reason."""
    err = node.validate_node_disruptable(now)
    if err is not None:
        raise CandidateError(err)
    if node.provider_id in disrupting_provider_ids:
        raise CandidateError("candidate is already being disrupted")
    pool = nodepools.get(node.nodepool_name())
    it_map = instance_types.get(node.nodepool_name())
    if pool is None or it_map is None:
        raise CandidateError(
            f'nodepool "{node.nodepool_name()}" can\'t be resolved for state node')
    err = _validate_pods_disruptable(pods_on_node, pdb_limits)
    if err is not None:
        tgp = node.nodeclaim.spec.termination_grace_period \
            if node.nodeclaim is not None else None
        if not (disruption_class == EVENTUAL and tgp is not None
                and isinstance(err, PodBlockEvictionError)):
            raise err
    nc = node.nodeclaim
    return Candidate(
        state_node=node.deep_copy(),
        nodepool=pool,
        instance_type=it_map.get(
            node.labels().get(api_labels.LABEL_INSTANCE_TYPE, "")),
        zone=node.labels().get(api_labels.LABEL_TOPOLOGY_ZONE, ""),
        capacity_type=node.labels().get(api_labels.CAPACITY_TYPE_LABEL_KEY, ""),
        reschedulable_pods=[p for p in pods_on_node
                            if pod_utils.is_reschedulable(p)],
        disruption_cost=(disruption_utils.rescheduling_cost(pods_on_node)
                         * disruption_utils.lifetime_remaining(now, nc)))


def _validate_pods_disruptable(pods: List[Pod], pdb_limits: Limits):
    """statenode.go:215-232: blocking do-not-disrupt pods, then PDBs.

    The do-not-disrupt sweep covers EVERY active pod — the reference
    explicitly lets mirror pods and daemonsets block disruption through
    the annotation (statenode.go:221-223) while terminal/terminating pods
    never do. The PDB sweep then covers only evictable pods (mirror pods
    are exempt; daemonset pods are not)."""
    for p in pods:
        if pod_utils.is_active(p) and not pod_utils.is_disruptable(p):
            return PodBlockEvictionError(
                f"pod {p.namespace}/{p.name} has the "
                f'"{api_labels.DO_NOT_DISRUPT_ANNOTATION_KEY}" annotation')
    for p in pods:
        if not pod_utils.is_evictable(p):
            continue
        ok, pdb = pdb_limits.can_evict(p)
        if not ok:
            return PodBlockEvictionError(
                f'pdb "{pdb.namespace}/{pdb.name}" prevents pod evictions')
    return None


@dataclass
class Command:
    """types.go:150+: what a method decided."""
    candidates: List[Candidate] = field(default_factory=list)
    replacements: list = field(default_factory=list)  # in-flight nodeclaims
    reason: str = ""
    consolidation_type: str = ""
    # pass trace_id of the disruption pass that computed this command
    # ("" when tracing is off): joins the execute-time log line with the
    # compute-time trace and flight-recorder record
    trace_id: str = ""

    @property
    def decision(self) -> str:
        if not self.candidates:
            return "no-op"
        return "replace" if self.replacements else "delete"

    def is_empty(self) -> bool:
        return not self.candidates
