"""Event constructors for every controller flow.

The reference defines per-flow event packages; this module is their single
catalog, one constructor per reference event:

- provisioning: karpenter's pkg/controllers/provisioning/scheduling/
  events.go:34-62 (Nominated, FailedScheduling)
- disruption: karpenter's pkg/controllers/disruption/events/
  events.go:31-140 (DisruptionLaunching, DisruptionWaitingReadiness,
  DisruptionTerminating, Unconsolidatable, DisruptionBlocked,
  NodePool budget blocks)
- termination: karpenter's pkg/controllers/node/termination/terminator/
  events/events.go:30-77 (Evicted, Disrupted, FailedDraining,
  TerminationGracePeriodExpiring)
- lifecycle: karpenter's pkg/controllers/nodeclaim/lifecycle/
  events.go:28-36 (InsufficientCapacityError)
- health: karpenter's pkg/controllers/node/health/events.go:28-76
  (NodeRepairBlocked)

Messages follow the reference strings so operators migrating from the
reference can keep their event-based alerting.
"""

from __future__ import annotations

from typing import List, Optional

from .recorder import Event

NORMAL = "Normal"
WARNING = "Warning"

_MAX_MESSAGE = 700  # lifecycle/events.go truncateMessage bound


def _truncate(msg: str) -> str:
    if len(msg) <= _MAX_MESSAGE:
        return msg
    return msg[:_MAX_MESSAGE] + "..."


def _title(reason: str) -> str:
    """cases.Title(NoLower) analog: upper-case the first rune only."""
    return reason[:1].upper() + reason[1:] if reason else reason


# -- provisioning (scheduling/events.go) ------------------------------------

def nominate_pod(pod, node_name: str = "", nodeclaim_name: str = "") -> Event:
    """scheduling/events.go:34-50 NominatePodEvent."""
    info = []
    if nodeclaim_name:
        info.append(f"nodeclaim/{nodeclaim_name}")
    if node_name:
        info.append(f"node/{node_name}")
    return Event(
        object_kind="Pod", object_name=pod.metadata.name,
        namespace=pod.metadata.namespace,
        type=NORMAL, reason="Nominated",
        message=f"Pod should schedule on: {', '.join(info)}",
        dedupe_values=(pod.uid,))


def pod_failed_to_schedule(pod, err: str) -> Event:
    """scheduling/events.go:52-61 PodFailedToScheduleEvent (5 min dedupe)."""
    return Event(
        object_kind="Pod", object_name=pod.metadata.name,
        namespace=pod.metadata.namespace,
        type=WARNING, reason="FailedScheduling",
        message=f"Failed to schedule pod, {err}",
        dedupe_ttl=5 * 60.0, dedupe_values=(pod.uid,))


# -- disruption (disruption/events/events.go) --------------------------------

def disruption_launching(nodeclaim, reason: str) -> Event:
    """events.go:31-39 Launching."""
    return Event(
        object_kind="NodeClaim", object_name=nodeclaim.name,
        type=NORMAL, reason="DisruptionLaunching",
        message=f"Launching NodeClaim: {_title(reason)}",
        dedupe_values=(nodeclaim.name, reason))


def disruption_waiting_on_readiness(nodeclaim) -> Event:
    """events.go:41-48 WaitingOnReadiness."""
    return Event(
        object_kind="NodeClaim", object_name=nodeclaim.name,
        type=NORMAL, reason="DisruptionWaitingReadiness",
        message="Waiting on readiness to continue disruption",
        dedupe_values=(nodeclaim.name,))


def disruption_terminating(node_name: str, nodeclaim_name: str,
                           reason: str) -> List[Event]:
    """events.go:51-69 Terminating: one event on the Node, one on the
    NodeClaim."""
    return [
        Event(object_kind="Node", object_name=node_name,
              type=NORMAL, reason="DisruptionTerminating",
              message=f"Disrupting Node: {_title(reason)}",
              dedupe_values=(node_name, reason)),
        Event(object_kind="NodeClaim", object_name=nodeclaim_name,
              type=NORMAL, reason="DisruptionTerminating",
              message=f"Disrupting NodeClaim: {_title(reason)}",
              dedupe_values=(nodeclaim_name, reason)),
    ]


def unconsolidatable(node_name: str, nodeclaim_name: str,
                     reason: str) -> List[Event]:
    """events.go:73-92 Unconsolidatable (15 min dedupe)."""
    return [
        Event(object_kind="Node", object_name=node_name,
              type=NORMAL, reason="Unconsolidatable", message=reason,
              dedupe_ttl=15 * 60.0, dedupe_values=(node_name,)),
        Event(object_kind="NodeClaim", object_name=nodeclaim_name,
              type=NORMAL, reason="Unconsolidatable", message=reason,
              dedupe_ttl=15 * 60.0, dedupe_values=(nodeclaim_name,)),
    ]


def disruption_blocked(node_name: Optional[str],
                       nodeclaim_name: Optional[str],
                       reason: str) -> List[Event]:
    """events.go:96-116 Blocked."""
    evs = []
    if node_name:
        evs.append(Event(
            object_kind="Node", object_name=node_name,
            type=NORMAL, reason="DisruptionBlocked",
            message=f"Cannot disrupt Node: {reason}",
            dedupe_values=(node_name,)))
    if nodeclaim_name:
        evs.append(Event(
            object_kind="NodeClaim", object_name=nodeclaim_name,
            type=NORMAL, reason="DisruptionBlocked",
            message=f"Cannot disrupt NodeClaim: {reason}",
            dedupe_values=(nodeclaim_name,)))
    return evs


def nodepool_blocked_for_reason(nodepool_name: str, reason: str) -> Event:
    """events.go:118-127 NodePoolBlockedForDisruptionReason (1 min dedupe:
    budgets can change every minute)."""
    return Event(
        object_kind="NodePool", object_name=nodepool_name,
        type=NORMAL, reason="DisruptionBlocked",
        message=(f"No allowed disruptions for disruption reason {reason} "
                 "due to blocking budget"),
        dedupe_ttl=60.0, dedupe_values=(nodepool_name, reason))


def nodepool_blocked(nodepool_name: str) -> Event:
    """events.go:129-140 NodePoolBlocked (1 min dedupe)."""
    return Event(
        object_kind="NodePool", object_name=nodepool_name,
        type=NORMAL, reason="DisruptionBlocked",
        message="No allowed disruptions due to blocking budget",
        dedupe_ttl=60.0, dedupe_values=(nodepool_name,))


# -- termination (terminator/events/events.go) -------------------------------

def evict_pod(pod) -> Event:
    """events.go:30-38 EvictPod."""
    return Event(
        object_kind="Pod", object_name=pod.metadata.name,
        namespace=pod.metadata.namespace,
        type=NORMAL, reason="Evicted", message="Evicted pod",
        dedupe_values=(pod.metadata.name,))


def disrupt_pod_delete(pod, grace_period_seconds, termination_time) -> Event:
    """events.go:40-48 DisruptPodDelete: forced delete when the node's
    terminationGracePeriod expires, bypassing PDBs + do-not-disrupt."""
    return Event(
        object_kind="Pod", object_name=pod.metadata.name,
        namespace=pod.metadata.namespace,
        type=NORMAL, reason="Disrupted",
        message=(f"Deleting the pod to accommodate the terminationTime "
                 f"{termination_time} of the node. The pod was granted "
                 f"{grace_period_seconds} seconds of grace-period of its "
                 f"{pod.spec.termination_grace_period_seconds} "
                 "terminationGracePeriodSeconds. This bypasses the PDB of "
                 "the pod and the do-not-disrupt annotation."),
        dedupe_values=(pod.metadata.name,))


def node_failed_to_drain(node_name: str, err: str) -> Event:
    """events.go:50-58 NodeFailedToDrain."""
    return Event(
        object_kind="Node", object_name=node_name,
        type=WARNING, reason="FailedDraining",
        message=f"Failed to drain node, {err}",
        dedupe_values=(node_name,))


def node_tgp_expiring(node_name: str, termination_time: str) -> Event:
    """events.go:60-68 NodeTerminationGracePeriodExpiring."""
    return Event(
        object_kind="Node", object_name=node_name,
        type=WARNING, reason="TerminationGracePeriodExpiring",
        message=f"All pods will be deleted by {termination_time}",
        dedupe_values=(node_name,))


def nodeclaim_tgp_expiring(nodeclaim_name: str, termination_time: str) -> Event:
    """events.go:70-77 NodeClaimTerminationGracePeriodExpiring."""
    return Event(
        object_kind="NodeClaim", object_name=nodeclaim_name,
        type=WARNING, reason="TerminationGracePeriodExpiring",
        message=f"All pods will be deleted by {termination_time}",
        dedupe_values=(nodeclaim_name,))


# -- nodeclaim lifecycle (lifecycle/events.go) -------------------------------

def insufficient_capacity(nodeclaim, err: str) -> Event:
    """lifecycle/events.go:28-36 InsufficientCapacityErrorEvent."""
    return Event(
        object_kind="NodeClaim", object_name=nodeclaim.name,
        type=WARNING, reason="InsufficientCapacityError",
        message=f"NodeClaim {nodeclaim.name} event: {_truncate(err)}",
        dedupe_values=(nodeclaim.name,))


def registration_timeout(nodeclaim, ttl: float) -> Event:
    """Warning published when liveness deletes a claim that never
    registered within the TTL (liveness.go:41-66 deletes silently; a
    registration drought must be observable, not a disappearing claim)."""
    return Event(
        object_kind="NodeClaim", object_name=nodeclaim.name,
        type=WARNING, reason="FailedRegistration",
        message=(f"NodeClaim {nodeclaim.name} not registered within "
                 f"{int(ttl)}s, deleting"),
        dedupe_values=(nodeclaim.name,))


def offerings_exhausted(pod, detail: str) -> Event:
    """Warning published when every offering compatible with a pod is
    masked by the unavailable-offerings registry: the pod waits for the
    TTL (or fresh capacity), it is not hot-looped through doomed solves.
    Distinct reason from FailedScheduling so drought alerting can key on
    it; deduped per pod so the backoff requeues don't spam."""
    return Event(
        object_kind="Pod", object_name=pod.metadata.name,
        namespace=pod.metadata.namespace,
        type=WARNING, reason="AllOfferingsUnavailable",
        message=("Failed to schedule pod, every compatible offering is "
                 f"marked unavailable: {_truncate(detail)}"),
        dedupe_ttl=5 * 60.0, dedupe_values=(pod.uid,))


# -- fault-tolerant runtime --------------------------------------------------

def reconcile_quarantined(kind: str, name: str, namespace: str,
                          controller: str, err: str) -> Event:
    """Warning published when the manager dead-letters a work item after
    exhausting its retry budget (no reference analog: controller-runtime
    retries forever; see DEVIATIONS.md)."""
    return Event(
        object_kind=kind, object_name=name, namespace=namespace,
        type=WARNING, reason="ReconcileQuarantined",
        message=(f"Quarantined after repeated reconcile failures in "
                 f"{controller}: {_truncate(err)}"),
        dedupe_values=(controller, name))


# -- SLO watcher (obs/slo.py) ------------------------------------------------

def slo_breached(slo: str, trace_id: str, duration: float, budget: float,
                 dump_path: str) -> Event:
    """Warning published when a pass trace exceeds a configured SLO budget
    (no reference analog). Deduped per breaching trace so a replayed
    observation can never double-publish; the message carries the
    flight-recorder dump path so the incident snapshot is one click away."""
    detail = f" (flight recorder: {dump_path})" if dump_path else ""
    return Event(
        object_kind="SLO", object_name=slo,
        type=WARNING, reason="SLOBreached",
        message=(f"Pass {trace_id} took {duration:.3f}s against the "
                 f"{budget:.3f}s {slo} budget{detail}"),
        dedupe_values=(slo, trace_id))


# -- node health (health/events.go) ------------------------------------------

def node_repair_blocked(node_name: str, nodeclaim_name: str,
                        reason: str) -> List[Event]:
    """health/events.go:28-76 NodeRepairBlocked (15 min dedupe). The
    reference emits both events with InvolvedObject=node (events.go:31,39 —
    the second differs only in dedupe key); one per object is the evident
    intent and what operators need. Bare nodes (no NodeClaim) publish the
    Node event only."""
    evs = [Event(object_kind="Node", object_name=node_name,
                 type=WARNING, reason="NodeRepairBlocked", message=reason,
                 dedupe_ttl=15 * 60.0, dedupe_values=(node_name,))]
    if nodeclaim_name:
        evs.append(Event(object_kind="NodeClaim", object_name=nodeclaim_name,
                         type=WARNING, reason="NodeRepairBlocked",
                         message=reason, dedupe_ttl=15 * 60.0,
                         dedupe_values=(nodeclaim_name,)))
    return evs


# -- warm-state integrity (state/audit.py, no reference analog) ---------------

def state_corruption(layer: str, detail: str, seq: int) -> Event:
    """The StateAuditor detected a corrupted warm-cache layer and
    quarantined it to a cold rebuild for the pass. No reference analog:
    the reference re-derives state every pass and has no warm caches to
    corrupt. The incident sequence number rides the dedupe key so every
    DISTINCT incident publishes exactly once — without it the recorder's
    TTL dedupe would swallow a second corruption of the same layer."""
    return Event(
        object_kind="EncodePlane", object_name=layer,
        type=WARNING, reason="StateCorruption",
        message=_truncate(
            f"Warm-state audit: corrupted {layer} quarantined to a cold "
            f"rebuild ({detail or 'content digest mismatch'})"),
        dedupe_values=(layer, str(seq)))
