"""NodePool: a template + policy for a class of provisionable nodes.

Mirrors karpenter's pkg/apis/v1/nodepool.go — spec (NodeClaim template,
disruption policy with budgets, resource limits, weight), static-drift hash,
and budget window arithmetic (nodepool.go:304-367).
"""

from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Optional

from ..utils import cron
from .objects import ObjectMeta, Taint

MAX_INT32 = 2**31 - 1

# Consolidation policies (nodepool.go)
WHEN_EMPTY = "WhenEmpty"
WHEN_EMPTY_OR_UNDERUTILIZED = "WhenEmptyOrUnderutilized"

# Disruption reasons (shared vocabulary with the disruption solver)
REASON_UNDERUTILIZED = "Underutilized"
REASON_EMPTY = "Empty"
REASON_DRIFTED = "Drifted"

NODEPOOL_HASH_VERSION = "v3"


@dataclass
class Budget:
    """Per-reason rate limit on simultaneous disruptions (nodepool.go:86-138).

    nodes is either an absolute count string ("10") or a percent ("10%");
    schedule (cron, UTC) plus duration (seconds) define active windows.
    """
    nodes: str = "10%"
    schedule: Optional[str] = None
    duration: Optional[float] = None
    reasons: Optional[list] = None  # None == all reasons

    def is_active(self, now: float) -> bool:
        """nodepool.go:353-367 — walk back `duration` and check whether the next
        schedule hit lands at-or-before now."""
        if self.schedule is None and self.duration is None:
            return True
        sched = cron.Schedule(self.schedule or "* * * * *")
        now_dt = datetime.fromtimestamp(now, tz=timezone.utc)
        checkpoint = datetime.fromtimestamp(now - (self.duration or 0.0), tz=timezone.utc)
        # next() is strictly-after; the reference's Next includes a hit exactly at
        # the checkpoint's following minute, so step back one minute.
        from datetime import timedelta
        next_hit = sched.next(checkpoint - timedelta(minutes=1))
        return next_hit <= now_dt

    def allowed_disruptions(self, now: float, num_nodes: int) -> int:
        """nodepool.go:323-345 — MaxInt32 when inactive; percent rounds up."""
        try:
            active = self.is_active(now)
        except ValueError:
            return 0  # misconfigured: fail closed
        if not active:
            return MAX_INT32
        v = self.nodes.strip()
        if v.endswith("%"):
            pct = int(v[:-1])
            return math.ceil(num_nodes * pct / 100.0)
        return int(v)


@dataclass
class Disruption:
    """nodepool.go:60-84."""
    consolidate_after: Optional[float] = 0.0  # seconds; None == Never
    consolidation_policy: str = WHEN_EMPTY_OR_UNDERUTILIZED
    budgets: list = field(default_factory=lambda: [Budget(nodes="10%")])


@dataclass
class NodeClassRef:
    group: str = ""
    kind: str = ""
    name: str = ""


@dataclass
class NodeClaimTemplateSpec:
    """The NodeClaim spec stamped out by this pool (nodeclaim.go:27-77 fields
    that are templated)."""
    requirements: list = field(default_factory=list)  # list[NodeSelectorRequirement-like] w/ optional min_values
    taints: list = field(default_factory=list)  # list[Taint]
    startup_taints: list = field(default_factory=list)
    node_class_ref: NodeClassRef = field(default_factory=NodeClassRef)
    expire_after: Optional[float] = None  # seconds; None == Never
    termination_grace_period: Optional[float] = None


@dataclass
class NodeClaimTemplate:
    metadata_labels: dict = field(default_factory=dict)
    metadata_annotations: dict = field(default_factory=dict)
    spec: NodeClaimTemplateSpec = field(default_factory=NodeClaimTemplateSpec)


@dataclass
class NodePoolSpec:
    template: NodeClaimTemplate = field(default_factory=NodeClaimTemplate)
    disruption: Disruption = field(default_factory=Disruption)
    limits: dict = field(default_factory=dict)  # ResourceList milliunits
    weight: Optional[int] = None


@dataclass
class NodePoolStatus:
    resources: dict = field(default_factory=dict)  # in-use resources
    conditions: list = field(default_factory=list)


@dataclass
class NodePool:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodePoolSpec = field(default_factory=NodePoolSpec)
    status: NodePoolStatus = field(default_factory=NodePoolStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    def static_hash(self) -> str:
        """Static-drift hash over the launch-relevant template fields
        (nodepool.go:277-283). Field changes here mark existing NodeClaims Drifted."""
        spec = self.spec.template.spec
        payload = {
            "labels": sorted(self.spec.template.metadata_labels.items()),
            "annotations": sorted(self.spec.template.metadata_annotations.items()),
            "taints": sorted((t.key, t.value, t.effect) for t in spec.taints),
            "startupTaints": sorted((t.key, t.value, t.effect) for t in spec.startup_taints),
            "expireAfter": spec.expire_after,
            "terminationGracePeriod": spec.termination_grace_period,
        }
        return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]

    def allowed_disruptions(self, now: float, num_nodes: int, reason: str) -> int:
        """Min across budgets matching the reason (nodepool.go:305-318); errors
        fail closed to 0 per budget."""
        allowed = MAX_INT32
        for budget in self.spec.disruption.budgets:
            val = budget.allowed_disruptions(now, num_nodes)
            if budget.reasons is None or reason in budget.reasons:
                allowed = min(allowed, val)
        return allowed


def order_by_weight(pools: list) -> list:
    """Highest weight first, name as tiebreak — utils/nodepool OrderByWeight."""
    return sorted(pools, key=lambda p: (-(p.spec.weight or 0), p.name))
