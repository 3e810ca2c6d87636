"""Pod classification predicates.

Mirrors karpenter's pkg/utils/pod/scheduling.go. In the standalone runtime
there is no kube-scheduler stamping Unschedulable conditions, so
"provisionable" reduces to: unbound, not terminating, not a daemonset pod,
and not preempting (IsProvisionable / IsReschedulable / IsEvictable /
IsWaitingEviction / IsOwnedByDaemonSet analogs)."""

from __future__ import annotations

from ..api import labels as api_labels
from ..api.objects import Pod

TERMINAL_PHASES = ("Succeeded", "Failed")


def is_terminal(pod: Pod) -> bool:
    return pod.status.phase in TERMINAL_PHASES


def is_terminating(pod: Pod) -> bool:
    return pod.metadata.deletion_timestamp is not None


def is_active(pod: Pod) -> bool:
    return not is_terminal(pod) and not is_terminating(pod)


def is_scheduled(pod: Pod) -> bool:
    return bool(pod.spec.node_name)


def is_provisionable(pod: Pod) -> bool:
    """utils/pod IsProvisionable: pending, unbound, not terminating, not
    preempting, not owned by a daemonset/node."""
    return (is_active(pod)
            and not is_scheduled(pod)
            and not pod.is_daemonset_pod
            and not pod.status.nominated_node_name)


def is_reschedulable(pod: Pod) -> bool:
    """Pods that must be re-placed when their node is disrupted
    (pod.go IsReschedulable). Terminating STATEFULSET pods still count:
    their sticky identity means the replacement pod can't be created until
    the old one dies, so capacity must be modeled for it now — higher
    availability than waiting for the recreate."""
    return ((is_active(pod)
             or (is_terminating(pod) and is_owned_by_statefulset(pod)))
            and not is_owned_by_daemonset(pod)
            and not is_owned_by_node(pod))


def is_evictable(pod: Pod) -> bool:
    return is_active(pod) and not is_owned_by_node(pod)


def is_disruptable(pod: Pod) -> bool:
    """Blocks node disruption when annotated do-not-disrupt
    (pod.go IsDisruptable)."""
    return pod.metadata.annotations.get(
        api_labels.DO_NOT_DISRUPT_ANNOTATION_KEY) != "true"


def is_owned_by_node(pod: Pod) -> bool:
    return any(ref.kind == "Node" for ref in pod.metadata.owner_refs)


def is_owned_by_daemonset(pod: Pod) -> bool:
    return pod.is_daemonset_pod or any(
        ref.kind == "DaemonSet" for ref in pod.metadata.owner_refs)


def is_owned_by_statefulset(pod: Pod) -> bool:
    return any(ref.kind == "StatefulSet" for ref in pod.metadata.owner_refs)
