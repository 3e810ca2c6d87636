"""Lightweight Kubernetes-shaped object model.

This framework is standalone (no apiserver); these dataclasses carry exactly the
fields the solvers and controllers consume. Shapes mirror core/v1 Pod/Node and
the usage sites in karpenter (pkg/utils/pod, pkg/scheduling).
"""

from __future__ import annotations

import itertools
import uuid as _uuid
from dataclasses import dataclass, field
from typing import Optional

from ..utils import resources as res

_seq = itertools.count()


def _gen_uid() -> str:
    return f"{next(_seq):08d}-{_uuid.uuid4().hex[:12]}"


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = field(default_factory=_gen_uid)
    labels: dict = field(default_factory=dict)
    annotations: dict = field(default_factory=dict)
    finalizers: list = field(default_factory=list)
    owner_refs: list = field(default_factory=list)  # list[OwnerReference]
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None
    resource_version: int = 0
    generation: int = 0


@dataclass
class OwnerReference:
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: bool = False
    block_owner_deletion: bool = False
    api_version: str = ""  # owner's real group/version (e.g. apps/v1)


# Taint effects
NO_SCHEDULE = "NoSchedule"
PREFER_NO_SCHEDULE = "PreferNoSchedule"
NO_EXECUTE = "NoExecute"


@dataclass(frozen=True)
class Taint:
    key: str
    effect: str = NO_SCHEDULE
    value: str = ""

    def matches(self, other: "Taint") -> bool:
        """MatchTaint: same key and effect (value ignored)."""
        return self.key == other.key and self.effect == other.effect


@dataclass(frozen=True)
class Toleration:
    key: str = ""
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # "" tolerates all effects
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: Taint) -> bool:
        """core/v1 Toleration.ToleratesTaint semantics."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator == "Exists":
            return True
        return self.value == taint.value


@dataclass(frozen=True)
class NodeSelectorRequirement:
    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: tuple = ()

    def __post_init__(self):
        if not isinstance(self.values, tuple):
            object.__setattr__(self, "values", tuple(self.values))


@dataclass(frozen=True)
class NodeSelectorTerm:
    match_expressions: tuple = ()  # tuple[NodeSelectorRequirement]

    def __post_init__(self):
        if not isinstance(self.match_expressions, tuple):
            object.__setattr__(self, "match_expressions", tuple(self.match_expressions))


@dataclass(frozen=True)
class PreferredSchedulingTerm:
    weight: int
    preference: NodeSelectorTerm


@dataclass
class NodeAffinity:
    # requiredDuringSchedulingIgnoredDuringExecution: OR of terms
    required_terms: list = field(default_factory=list)  # list[NodeSelectorTerm]
    preferred: list = field(default_factory=list)  # list[PreferredSchedulingTerm]


@dataclass(frozen=True)
class LabelSelector:
    """metav1.LabelSelector: match_labels AND match_expressions."""
    match_labels: tuple = ()  # tuple[(key, value)]
    match_expressions: tuple = ()  # tuple[NodeSelectorRequirement] (In/NotIn/Exists/DoesNotExist)

    def __post_init__(self):
        if isinstance(self.match_labels, dict):
            object.__setattr__(self, "match_labels", tuple(sorted(self.match_labels.items())))
        elif not isinstance(self.match_labels, tuple):
            object.__setattr__(self, "match_labels", tuple(self.match_labels))
        if not isinstance(self.match_expressions, tuple):
            object.__setattr__(self, "match_expressions", tuple(self.match_expressions))

    def matches(self, labels: dict) -> bool:
        for k, v in self.match_labels:
            if labels.get(k) != v:
                return False
        for expr in self.match_expressions:
            val = labels.get(expr.key)
            if expr.operator == "In":
                if val is None or val not in expr.values:
                    return False
            elif expr.operator == "NotIn":
                if val is not None and val in expr.values:
                    return False
            elif expr.operator == "Exists":
                if val is None:
                    return False
            elif expr.operator == "DoesNotExist":
                if val is not None:
                    return False
            else:
                return False
        return True


@dataclass(frozen=True)
class PodAffinityTerm:
    topology_key: str
    label_selector: Optional[LabelSelector] = None
    namespaces: tuple = ()

    def __post_init__(self):
        if not isinstance(self.namespaces, tuple):
            object.__setattr__(self, "namespaces", tuple(self.namespaces))


@dataclass(frozen=True)
class WeightedPodAffinityTerm:
    weight: int
    term: PodAffinityTerm


@dataclass
class PodAffinity:
    required: list = field(default_factory=list)  # list[PodAffinityTerm]
    preferred: list = field(default_factory=list)  # list[WeightedPodAffinityTerm]


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAffinity] = None


# whenUnsatisfiable values
DO_NOT_SCHEDULE = "DoNotSchedule"
SCHEDULE_ANYWAY = "ScheduleAnyway"


@dataclass(frozen=True)
class TopologySpreadConstraint:
    topology_key: str
    max_skew: int = 1
    when_unsatisfiable: str = DO_NOT_SCHEDULE
    label_selector: Optional[LabelSelector] = None
    min_domains: Optional[int] = None


@dataclass(frozen=True)
class HostPort:
    port: int
    protocol: str = "TCP"
    host_ip: str = ""


@dataclass(frozen=True)
class PVCRef:
    """A pod volume backed by a PVC. For generic ephemeral volumes
    (pod.spec.volumes[].ephemeral), claim_name is the VOLUME name — the
    controller-created claim is '<pod-name>-<volume-name>' — and
    storage_class_name carries the volumeClaimTemplate's class."""
    claim_name: str
    ephemeral: bool = False
    storage_class_name: str = ""


@dataclass
class PodSpec:
    node_selector: dict = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: list = field(default_factory=list)  # list[Toleration]
    topology_spread_constraints: list = field(default_factory=list)
    node_name: str = ""
    priority: Optional[int] = None
    priority_class_name: str = ""
    host_ports: list = field(default_factory=list)  # list[HostPort]
    volumes: list = field(default_factory=list)  # list[PVCRef]
    termination_grace_period_seconds: Optional[int] = None
    scheduler_name: str = "default-scheduler"
    preemption_policy: str = "PreemptLowerPriority"


@dataclass
class PodCondition:
    type: str
    status: str = "True"
    reason: str = ""
    last_transition_time: float = 0.0


@dataclass
class PodStatus:
    phase: str = "Pending"
    conditions: list = field(default_factory=list)
    nominated_node_name: str = ""


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)
    # Resource requests: one dict per container / init container (milliunits).
    container_requests: list = field(default_factory=list)
    init_container_requests: list = field(default_factory=list)
    is_daemonset_pod: bool = False

    @property
    def uid(self) -> str:
        return self.metadata.uid

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    @property
    def labels(self) -> dict:
        return self.metadata.labels

    def requests(self) -> dict:
        return res.pod_requests(self)


@dataclass
class NodeStatus:
    capacity: dict = field(default_factory=dict)  # ResourceList milliunits
    allocatable: dict = field(default_factory=dict)
    conditions: list = field(default_factory=list)
    phase: str = ""


@dataclass
class NodeSpec:
    provider_id: str = ""
    taints: list = field(default_factory=list)
    unschedulable: bool = False


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def labels(self) -> dict:
        return self.metadata.labels
