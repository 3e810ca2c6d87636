"""Node termination: finalizer-driven graceful drain.

Mirrors karpenter's pkg/controllers/node/termination/: on
deletionTimestamp, delete owning NodeClaims (controller.go:178-188), taint
disrupted:NoSchedule (terminator.go:55-92), drain pods in priority groups —
noncritical non-daemonset first (terminator.go:119-138) — wait for
VolumeAttachments of drainable pods to detach unless past the termination
grace deadline (controller.go:141-150,190-240), then remove the finalizer
(controller.go:242-270).

Eviction runs through a per-pod exponential-backoff queue
(terminator/eviction.go:49-50,94: 100ms base / 10s cap): a PDB-blocked
eviction (the Eviction API's 429) backs that pod off instead of hammering
the budget every pass.

Standalone-runtime deviation: the reference evicts via the Eviction API and
relies on workload controllers (Deployments) to recreate pods, with the
kube-scheduler re-binding them. Here eviction of a reschedulable pod *unbinds*
it (clears spec.node_name), returning it to the provisionable pool the
Provisioner watches; non-reschedulable pods are deleted. Net behavior matches:
disrupted pods land on replacement capacity.
"""

from __future__ import annotations

from typing import List, Optional

from ..api import labels as api_labels
from ..api.nodeclaim import NodeClaim
from ..api.objects import Node, Pod
from ..api.storage import PersistentVolumeClaim, VolumeAttachment
from ..events import catalog as events_catalog
from ..kube.store import Store
from ..logging import get_logger
from ..scheduling.taints import DISRUPTED_NO_SCHEDULE_TAINT
from ..state.cluster import Cluster
from ..utils import pod as pod_utils
from ..utils.backoff import ItemBackoff
from ..utils.clock import Clock
from .manager import Controller, Result

CRITICAL_PRIORITY = 2_000_000_000  # system-cluster-critical floor

EVICTION_BASE_DELAY = 0.1   # terminator/eviction.go:49
EVICTION_MAX_DELAY = 10.0   # terminator/eviction.go:50
DEFAULT_POD_GRACE_SECONDS = 30.0  # core/v1 terminationGracePeriodSeconds default

log = get_logger("node.termination")


def _fmt_time(ts: float) -> str:
    """RFC3339 rendering of a runtime timestamp for event messages."""
    from ..kube.k8s_codec import ts_to_k8s
    return ts_to_k8s(ts) or ""


class NodeTermination(Controller):
    name = "node.termination"
    kinds = (Node,)

    def __init__(self, store: Store, cluster: Cluster,
                 clock: Optional[Clock] = None, cloud_provider=None,
                 recorder=None):
        from ..events.recorder import Recorder
        self.store = store
        self.cluster = cluster
        self.clock = clock or store.clock
        self.recorder = recorder or Recorder(self.clock)
        # for the instance-already-gone shortcut; None skips the check
        self.cloud_provider = cloud_provider
        # pod key -> eviction backoff state (the eviction queue's rate
        # limiter); next_try gates when a blocked pod may be retried
        self._backoff = ItemBackoff(EVICTION_BASE_DELAY, EVICTION_MAX_DELAY)
        self._next_try: dict = {}

    def _node_ready(self, node: Node) -> bool:
        from ..utils import node as node_utils
        cond = node_utils.get_condition(node, "Ready")
        # absent Ready = simulated/condition-less node: treat as healthy so
        # the instance-gone shortcut NEVER skips the drain without explicit
        # NotReady evidence (consistent with nodeclaim_lifecycle._initialize)
        return cond is None or cond[0] == "True"

    def _release_pods(self, node: Node) -> None:
        """The node is going away without a drain (instance already gone):
        reschedulable pods unbind so the provisioner replaces their
        capacity; everything else is deleted (the reference leans on kube
        pod-GC + workload controllers here; this runtime has no analog)."""
        for p in self._pods_on(node):
            self._force_delete(p)

    def reconcile(self, node: Node) -> Optional[Result]:
        if node.metadata.deletion_timestamp is None:
            return None
        if api_labels.TERMINATION_FINALIZER not in node.metadata.finalizers:
            return None
        # delete owning NodeClaims so instance teardown starts in parallel
        owning = None
        for nc in self.store.list(NodeClaim):
            if nc.status.node_name == node.name:
                owning = nc
                if nc.metadata.deletion_timestamp is None:
                    self.store.delete(nc)
        # the cloud instance is already gone (manual delete, spot reclaim):
        # draining waits on evictions that can never make progress on a dead
        # kubelet — finalize immediately, UNLESS the node still reports
        # Ready (the kubelet is heartbeating, so the instance plainly
        # exists; trust the drain) (controller.go:151-176)
        if self.cloud_provider is not None and not self._node_ready(node):
            from ..cloudprovider.types import NodeClaimNotFoundError
            try:
                pid = node.spec.provider_id
                if pid:
                    self.cloud_provider.get(pid)
            except NodeClaimNotFoundError:
                log.info("instance already terminated; releasing node",
                         node=node.name)
                self._release_pods(node)
                self._record_terminated(node)
                self.store.remove_finalizer(
                    node, api_labels.TERMINATION_FINALIZER)
                return None
        self._taint(node)
        self._annotate_termination_time(node, owning)
        term_ts = self._termination_time(node)
        if term_ts is not None:
            # controller.go:272-280: surface the hard deadline every pass
            # (the recorder's dedupe collapses repeats)
            self.recorder.publish(events_catalog.node_tgp_expiring(
                node.name, _fmt_time(term_ts)))
            if owning is not None:
                self.recorder.publish(events_catalog.nodeclaim_tgp_expiring(
                    owning.name, _fmt_time(term_ts)))
        remaining = self._drain(node)
        if remaining:
            # controller.go:115-119: a drain pass that leaves pods behind is
            # a NodeDrainError -> FailedDraining warning
            self.recorder.publish(events_catalog.node_failed_to_drain(
                node.name, f"{remaining} pods are waiting to be evicted"))
            log.debug("draining node", node=node.name, pods_remaining=remaining)
            return Result(requeue_after=1.0)
        # drained: wait for volumes to detach unless past the TGP deadline
        # (controller.go:141-150)
        term_time = self._termination_time(node)
        if term_time is None or self.clock.now() < term_time:
            attached = self._attached_volumes(node)
            if attached:
                log.debug("waiting on volume detach", node=node.name,
                          volume_attachments=attached)
                return Result(requeue_after=1.0)
        log.info("terminated node", node=node.name)
        self._record_terminated(node)
        self.store.remove_finalizer(node, api_labels.TERMINATION_FINALIZER)
        return None

    def _record_terminated(self, node: Node) -> None:
        """termination/metrics.go:30-62: counter + drain-duration summary +
        node-lifetime histogram, all by nodepool."""
        from ..metrics import registry as metrics
        labels = {"nodepool": node.metadata.labels.get(
            api_labels.NODEPOOL_LABEL_KEY, "")}
        now = self.clock.now()
        metrics.NODES_TERMINATED.inc(labels)
        if node.metadata.deletion_timestamp is not None:
            metrics.NODE_TERMINATION_DURATION.observe(
                max(0.0, now - node.metadata.deletion_timestamp), labels)
        if node.metadata.creation_timestamp:
            metrics.NODE_LIFETIME_DURATION.observe(
                max(0.0, now - node.metadata.creation_timestamp), labels)

    def _annotate_termination_time(self, node: Node, nc) -> None:
        """controller.go: stamp the hard deadline from the claim's
        terminationGracePeriod so the drain can force-expire."""
        key = api_labels.NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION_KEY
        if key in node.metadata.annotations:
            return
        tgp = nc.spec.termination_grace_period if nc is not None else None
        if tgp is not None:
            node.metadata.annotations[key] = str(
                node.metadata.deletion_timestamp + tgp)
            self.store.update(node)

    def _termination_time(self, node: Node) -> Optional[float]:
        raw = node.metadata.annotations.get(
            api_labels.NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION_KEY)
        return float(raw) if raw else None

    def _taint(self, node: Node) -> None:
        if not any(t.matches(DISRUPTED_NO_SCHEDULE_TAINT) for t in node.spec.taints):
            node.spec.taints.append(DISRUPTED_NO_SCHEDULE_TAINT)
            self.store.update(node)

    def _pods_on(self, node: Node) -> List[Pod]:
        return self.store.list(Pod, predicate=lambda p: p.spec.node_name == node.name)

    def _drain(self, node: Node) -> int:
        """Evict in priority groups; returns evictable pods still bound.

        PDB-blocked and do-not-disrupt pods are retried with per-pod
        exponential backoff (the Eviction API's 429 path,
        terminator/eviction.go) until the TerminationGracePeriod deadline,
        after which everything is force-deleted (terminator.go:140-177)."""
        now = self.clock.now()
        term_time = self._termination_time(node)
        expired = term_time is not None and now >= term_time

        # kubelet-sim: a pod already terminating finishes dying once its own
        # grace period elapses (nothing else removes it in the standalone
        # runtime; with a real kubelet this is its SIGKILL)
        for p in self._pods_on(node):
            if p.metadata.deletion_timestamp is not None:
                grace = p.spec.termination_grace_period_seconds
                grace = DEFAULT_POD_GRACE_SECONDS if grace is None else grace
                # the node's terminationGracePeriod is a HARD deadline: past
                # it, even a long pod grace is cut short (terminator.go
                # :140-177 force-deletes everything after expiry)
                if expired or now >= p.metadata.deletion_timestamp + grace:
                    self.store.delete(p)

        pods = [p for p in self._pods_on(node) if self._drainable(p)]

        # TGP preemptive deletes: pods whose own grace period no longer fits
        # before the node deadline start terminating immediately
        if term_time is not None and not expired:
            for p in list(pods):
                grace = p.spec.termination_grace_period_seconds or 0
                if now + grace >= term_time:
                    # terminator.go:140-157: proactive delete with clamped
                    # grace, bypassing PDB + do-not-disrupt
                    self.recorder.publish(events_catalog.disrupt_pod_delete(
                        p, int(max(0.0, term_time - now)),
                        _fmt_time(term_time)))
                    self._force_delete(p)
                    pods.remove(p)

        from ..utils.pdb import Limits
        from ..api.policy import PodDisruptionBudget
        limits = Limits(self.store.list(PodDisruptionBudget),
                        self.store.list(Pod))
        groups = ([p for p in pods if not self._critical(p) and not p.is_daemonset_pod],
                  [p for p in pods if not self._critical(p) and p.is_daemonset_pod],
                  [p for p in pods if self._critical(p) and not p.is_daemonset_pod],
                  [p for p in pods if self._critical(p) and p.is_daemonset_pod])
        for group in groups:
            if not group:
                continue
            for p in group:
                if expired:
                    self._force_delete(p)
                    continue
                key = (p.namespace, p.name, p.uid)
                if not pod_utils.is_disruptable(p):
                    continue  # do-not-disrupt: wait for the TGP deadline
                if self._next_try.get(key, 0.0) > now:
                    continue  # backing off after a PDB rejection
                ok, pdb = limits.can_evict(p)
                if not ok:
                    # 429: exponential backoff before the next attempt
                    delay = self._backoff.next_delay(key)
                    self._next_try[key] = now + delay
                    log.debug("eviction blocked by PDB", node=node.name,
                              pod=f"{p.namespace}/{p.name}",
                              pdb=f"{pdb.namespace}/{pdb.name}",
                              retry_in=round(delay, 3))
                    continue
                self._evict(p)
                limits.record_eviction(p)
            # one priority group per pass (terminator.go:119-138)
            break
        # the node is drained only when nothing is still WAITING on it:
        # evictable pods AND already-terminating (non-daemonset) pods that
        # haven't finished dying (IsWaitingEviction — the reference keeps
        # the node alive while a terminating StatefulSet pod lingers, which
        # is exactly the window the provisioner uses to model its
        # replacement capacity)
        return len([p for p in self._pods_on(node)
                    if self._drainable(p)
                    or (p.metadata.deletion_timestamp is not None
                        and not pod_utils.is_terminal(p)
                        and not pod_utils.is_owned_by_daemonset(p)
                        and not pod_utils.is_owned_by_node(p))])

    def _attached_volumes(self, node: Node) -> List[str]:
        """VolumeAttachments that must detach before instance delete
        (controller.go:190-240): attachments whose PV belongs to a
        NON-drainable pod are filtered out — they will never detach, so they
        must not block termination."""
        vas = self.store.list(
            VolumeAttachment,
            predicate=lambda va: va.spec.node_name == node.name)
        if not vas:
            return []
        blocked_pvs = set()
        for p in self._pods_on(node):
            # same drainable predicate as _drain: a disrupted-taint-
            # tolerating pod is never evicted, so its attachments will never
            # detach and must not hold the node (controller.go:216)
            if self._drainable(p) and pod_utils.is_disruptable(p):
                continue
            for ref in p.spec.volumes:
                pvc = self.store.get(PersistentVolumeClaim, ref.claim_name,
                                     p.namespace)
                if pvc is not None and pvc.spec.volume_name:
                    blocked_pvs.add(pvc.spec.volume_name)
        return [va.name for va in vas
                if va.spec.persistent_volume_name
                and va.spec.persistent_volume_name not in blocked_pvs]

    def _force_delete(self, pod: Pod) -> None:
        # the pod leaves the node either way: drop its eviction-queue state
        key = (pod.namespace, pod.name, pod.uid)
        self._backoff.forget(key)
        self._next_try.pop(key, None)
        if pod_utils.is_reschedulable(pod):
            pod.spec.node_name = ""
            pod.status.nominated_node_name = ""
            self.store.update(pod)
        else:
            self.store.delete(pod)

    def _drainable(self, pod: Pod) -> bool:
        """Evictable AND does NOT tolerate the disrupted taint — a
        tolerating pod opted into riding the node down: never evicted,
        never blocks the drain (terminator.go:86-99). (tolerates() returns
        untolerated-taint errors: non-empty = does not tolerate.)"""
        from ..scheduling import taints as scheduling_taints
        return pod_utils.is_evictable(pod) and bool(
            scheduling_taints.tolerates([DISRUPTED_NO_SCHEDULE_TAINT], pod))

    def _critical(self, pod: Pod) -> bool:
        return (pod.spec.priority or 0) >= CRITICAL_PRIORITY or \
            pod.spec.priority_class_name in ("system-cluster-critical",
                                             "system-node-critical")

    def _evict(self, pod: Pod) -> None:
        # mechanically identical to force-delete in the standalone runtime;
        # the distinction is the caller's gates (PDB / do-not-disrupt)
        self.recorder.publish(events_catalog.evict_pod(pod))  # eviction.go:208
        self._force_delete(pod)
