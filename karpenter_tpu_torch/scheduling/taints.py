"""Taint toleration checks (mirrors karpenter's pkg/scheduling/taints.go)."""

from __future__ import annotations

from typing import Iterable, List

from ..api import labels as api_labels
from ..api.objects import NO_EXECUTE, NO_SCHEDULE, Pod, Taint

# Taints expected on a node while it initializes; ignored for scheduling on
# uninitialized Karpenter-managed nodes (taints.go:32-40).
KNOWN_EPHEMERAL_TAINTS = (
    Taint(key="node.kubernetes.io/not-ready", effect=NO_SCHEDULE),
    Taint(key="node.kubernetes.io/unreachable", effect=NO_SCHEDULE),
    Taint(key="node.cloudprovider.kubernetes.io/uninitialized", effect=NO_SCHEDULE, value="true"),
    Taint(key=api_labels.UNREGISTERED_TAINT_KEY, effect=NO_EXECUTE),
)

DISRUPTED_NO_SCHEDULE_TAINT = Taint(key=api_labels.DISRUPTED_TAINT_KEY, effect=NO_SCHEDULE)
UNREGISTERED_NO_EXECUTE_TAINT = Taint(key=api_labels.UNREGISTERED_TAINT_KEY, effect=NO_EXECUTE)


def tolerates(taints: Iterable[Taint], pod: Pod) -> "list[str]":
    """Error per non-tolerated taint; empty list means the pod tolerates all
    (taints.go:46-58)."""
    errs = []
    for taint in taints:
        if not any(t.tolerates(taint) for t in pod.spec.tolerations):
            errs.append(f"did not tolerate {taint.key}={taint.value}:{taint.effect}")
    return errs


def merge(taints: Iterable[Taint], with_taints: Iterable[Taint]) -> List[Taint]:
    """taints.go:61-73 — append taints not already matched by key+effect."""
    out = list(taints)
    for taint in with_taints:
        if not any(taint.matches(t) for t in out):
            out.append(taint)
    return out
