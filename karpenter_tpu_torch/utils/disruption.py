"""Disruption cost functions (karpenter's pkg/utils/disruption/disruption.go).

disruptionCost(candidate) = ReschedulingCost(all pods) x LifetimeRemaining:
cheap-to-move, soon-to-expire nodes are disrupted first.
"""

from __future__ import annotations

from typing import List, Optional

from ..api.objects import Pod

POD_DELETION_COST_ANNOTATION = "controller.kubernetes.io/pod-deletion-cost"


def lifetime_remaining(now: float, nodeclaim) -> float:
    """Fraction of node lifetime left in [0, 1]; 1.0 without expireAfter
    (disruption.go:37-47)."""
    expire_after = nodeclaim.spec.expire_after if nodeclaim is not None else None
    if not expire_after:
        return 1.0
    age = now - nodeclaim.metadata.creation_timestamp
    return min(max((expire_after - age) / expire_after, 0.0), 1.0)


def eviction_cost(pod: Pod) -> float:
    """disruption.go:50-72: 1.0 base, deletion-cost annotation / 2^27,
    priority / 2^25, clamped to [-10, 10]."""
    cost = 1.0
    raw = pod.metadata.annotations.get(POD_DELETION_COST_ANNOTATION)
    if raw is not None:
        try:
            cost += float(raw) / (2 ** 27)
        except ValueError:
            pass
    if pod.spec.priority is not None:
        cost += pod.spec.priority / (2 ** 25)
    return min(max(cost, -10.0), 10.0)


def rescheduling_cost(pods: List[Pod]) -> float:
    return sum(eviction_cost(p) for p in pods)
