"""NodeClaim lifecycle state machine: launch -> register -> initialize, with
liveness TTL and the termination finalizer flow.

Mirrors karpenter's pkg/controllers/nodeclaim/lifecycle/:
- Launch (launch.go:45-121): cloudProvider.Create, Launched condition, status
  capacity/allocatable; insufficient-capacity errors delete the claim.
- Registration (registration.go:43-114): match the Node by providerID, sync
  labels/taints, drop the unregistered:NoExecute taint, stamp the registered
  label, record status.node_name.
- Initialization (initialization.go:47-136): node present with ephemeral +
  startup taints cleared and capacity registered -> initialized label +
  condition.
- Liveness (liveness.go:41-66): claims not registered within the TTL are
  deleted.
- Termination (controller.go:171-285): on deletionTimestamp, delete the cloud
  instance, delete the Node, then drop the finalizer.
"""

from __future__ import annotations

from typing import Optional

from ..api import labels as api_labels
from ..api.nodeclaim import (COND_INITIALIZED, COND_LAUNCHED, COND_REGISTERED,
                             NodeClaim)
from ..api.objects import Node
from ..cloudprovider.types import (CloudProviderError, InsufficientCapacityError,
                                   NodeClaimNotFoundError)
from ..kube.store import NotFoundError, Store
from ..logging import get_logger
from ..scheduling.taints import KNOWN_EPHEMERAL_TAINTS
from ..state.cluster import Cluster
from ..utils.clock import Clock
from .manager import Controller, Result

REGISTRATION_TTL_SECONDS = 15 * 60  # liveness.go registrationTTL
LAUNCH_RETRY_SECONDS = 15.0

log = get_logger("nodeclaim.lifecycle")


class NodeClaimLifecycle(Controller):
    name = "nodeclaim.lifecycle"
    kinds = (NodeClaim,)

    def __init__(self, store: Store, cluster: Cluster, cloud_provider,
                 clock: Optional[Clock] = None,
                 registration_ttl: float = REGISTRATION_TTL_SECONDS,
                 recorder=None, unavailable=None, trigger=None):
        from ..events.recorder import Recorder
        self.store = store
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.clock = clock or store.clock
        self.recorder = recorder or Recorder(self.clock)
        self.registration_ttl = registration_ttl
        # UnavailableOfferings registry: ICE launch failures record their
        # exhausted offering keys here so the next solve routes around them
        self.unavailable = unavailable
        # provisioner.trigger: an ICE-deleted claim is pre-registration (no
        # Node exists), so NodeDeletionTrigger can never fire for it — the
        # stranded pods must re-provision NOW, not on the next unrelated
        # batch window
        self.trigger = trigger

    def reconcile(self, nc: NodeClaim) -> Optional[Result]:
        if self.store.get(NodeClaim, nc.metadata.name,
                          nc.metadata.namespace) is None:
            # already fully deleted (finalizer dropped); the manager hands us
            # the stale event snapshot — controller-runtime's NotFound->ignore
            return None
        if nc.metadata.deletion_timestamp is not None:
            return self._finalize(nc)
        if api_labels.TERMINATION_FINALIZER not in nc.metadata.finalizers:
            nc.metadata.finalizers.append(api_labels.TERMINATION_FINALIZER)
            self.store.update(nc)
        if not nc.launched():
            r = self._launch(nc)
            if r is not None:
                return r
        if not nc.registered():
            self._register(nc)
        if not nc.registered():
            return self._liveness(nc)
        if not nc.initialized():
            self._initialize(nc)
            if not nc.initialized():
                return Result(requeue_after=5.0)
        return None

    # -- launch -------------------------------------------------------------

    def _launch(self, nc: NodeClaim) -> Optional[Result]:
        try:
            self.cloud_provider.create(nc)
        except InsufficientCapacityError as e:
            # launch.go:78-86: ICE deletes the claim so the provisioner
            # retries — but first the exhausted offering keys feed the
            # registry (escalating TTL per repeated key) so the retry
            # solves AROUND the drought instead of re-picking it
            from ..events import catalog as events_catalog
            keys = getattr(e, "offerings", ())
            if self.unavailable is not None:
                for it_name, zone, capacity_type in keys:
                    ttl = self.unavailable.mark(
                        it_name, zone, capacity_type,
                        reason="insufficient_capacity")
                    log.warning("offering marked unavailable",
                                instance_type=it_name, zone=zone,
                                capacity_type=capacity_type, ttl=ttl)
            log.warning("insufficient capacity, deleting nodeclaim",
                        nodeclaim=nc.name, error=str(e))
            self.recorder.publish(
                events_catalog.insufficient_capacity(nc, str(e)))
            self.store.delete(nc)
            if self.trigger is not None:
                self.trigger()
            return Result()
        except CloudProviderError as e:
            log.error("launching nodeclaim failed", nodeclaim=nc.name,
                      error=str(e))
            # only write when the condition actually flips: an unconditional
            # status update fires a watch event that re-reconciles this very
            # claim immediately, turning the requeue_after backoff into a
            # hot retry storm
            prev = nc.conditions.get(COND_LAUNCHED)
            if prev is None or prev.status != "False" or \
                    prev.message != str(e):
                nc.conditions.set_false(COND_LAUNCHED, reason="LaunchFailed",
                                        message=str(e), now=self.clock.now())
                self.store.update(nc)
            return Result(requeue_after=LAUNCH_RETRY_SECONDS)
        log.info("launched nodeclaim", nodeclaim=nc.name,
                 nodepool=nc.nodepool_name,
                 provider_id=nc.status.provider_id)
        nc.conditions.set_true(COND_LAUNCHED, reason="Launched",
                               now=self.clock.now())
        self.store.update(nc)
        self.cluster.update_nodeclaim(nc)
        return None

    # -- registration -------------------------------------------------------

    def _node_for(self, nc: NodeClaim) -> Optional[Node]:
        pid = nc.status.provider_id
        if not pid:
            return None
        for node in self.store.list(Node):
            if node.spec.provider_id == pid:
                return node
        return None

    def _register(self, nc: NodeClaim) -> None:
        from ..api.objects import OwnerReference
        node = self._node_for(nc)
        if node is None:
            return
        # invariant (registration.go:55-61): a Karpenter-managed node must
        # come up with the unregistered NoExecute taint — workloads would
        # otherwise race onto it before its labels/taints are synced. A node
        # missing both the taint and the registered label fails registration.
        has_unregistered = any(t.key == api_labels.UNREGISTERED_TAINT_KEY
                               for t in node.spec.taints)
        if not has_unregistered and \
                api_labels.NODE_REGISTERED_LABEL_KEY not in node.metadata.labels:
            prev = nc.conditions.get(COND_REGISTERED)
            # update only on transition — an unconditional write would fire
            # a watch event that re-reconciles this claim in a hot loop
            if prev is None or prev.status != "False" or \
                    prev.reason != "UnregisteredTaintNotFound":
                nc.conditions.set_false(
                    COND_REGISTERED, reason="UnregisteredTaintNotFound",
                    message=(f"invariant violated, "
                             f"{api_labels.UNREGISTERED_TAINT_KEY} taint must "
                             "be present on Karpenter-managed nodes"),
                    now=self.clock.now())
                self.store.update(nc)
            return
        # sync: claim labels/annotations/taints win (registration.go:74-101);
        # startup taints sync only HERE — their later removal by the workload
        # must not be undone by a re-sync
        node.metadata.labels.update(nc.metadata.labels)
        node.metadata.labels[api_labels.NODE_REGISTERED_LABEL_KEY] = "true"
        node.metadata.annotations.update(nc.metadata.annotations)
        from ..scheduling.taints import merge as merge_taints
        node.spec.taints = [
            t for t in merge_taints(node.spec.taints,
                                    list(nc.spec.taints)
                                    + list(nc.spec.startup_taints))
            if t.key != api_labels.UNREGISTERED_TAINT_KEY]
        if not any(r.kind == "NodeClaim" for r in node.metadata.owner_refs):
            node.metadata.owner_refs.append(OwnerReference(
                kind="NodeClaim", name=nc.name, uid=nc.uid,
                block_owner_deletion=True))
        if api_labels.TERMINATION_FINALIZER not in node.metadata.finalizers:
            node.metadata.finalizers.append(api_labels.TERMINATION_FINALIZER)
        self.store.update(node)
        nc.status.node_name = node.name
        log.info("registered nodeclaim", nodeclaim=nc.name, node=node.name)
        nc.conditions.set_true(COND_REGISTERED, reason="Registered",
                               now=self.clock.now())
        self.store.update(nc)
        from ..metrics import registry as metrics
        metrics.NODES_CREATED.inc({"nodepool": nc.nodepool_name})

    # -- initialization -----------------------------------------------------

    def _initialize(self, nc: NodeClaim) -> None:
        from ..utils import node as node_utils
        node = self._node_for(nc)
        if node is None:
            return
        # a NotReady kubelet blocks initialization (initialization.go:75-80);
        # absent Ready condition = simulated node, treated healthy
        ready = node_utils.get_condition(node, "Ready")
        if ready is not None and ready[0] != "True":
            return
        startup = list(nc.spec.startup_taints)
        for t in node.spec.taints:
            if any(t.matches(e) for e in KNOWN_EPHEMERAL_TAINTS):
                return  # still starting up
            if any(t.matches(s) for s in startup):
                return
        # resources registered (initialization.go:103-121)
        for rname, req in nc.status.allocatable.items():
            if node.status.allocatable.get(rname, 0) <= 0 < req:
                return
        node.metadata.labels[api_labels.NODE_INITIALIZED_LABEL_KEY] = "true"
        self.store.update(node)
        log.info("initialized nodeclaim", nodeclaim=nc.name, node=node.name)
        nc.conditions.set_true(COND_INITIALIZED, reason="Initialized",
                               now=self.clock.now())
        self.store.update(nc)

    # -- liveness -----------------------------------------------------------

    def _liveness(self, nc: NodeClaim) -> Optional[Result]:
        age = self.clock.now() - nc.metadata.creation_timestamp
        if age >= self.registration_ttl:
            from ..events import catalog as events_catalog
            from ..metrics import registry as metrics
            log.warning("nodeclaim not registered within TTL, deleting",
                        nodeclaim=nc.name, ttl=self.registration_ttl)
            # observable, not silent: registration droughts show up as a
            # warning event + counter, not just vanishing claims
            self.recorder.publish(
                events_catalog.registration_timeout(nc, self.registration_ttl))
            metrics.NODECLAIMS_LIVENESS_TERMINATED.inc(
                {"nodepool": nc.nodepool_name})
            self.store.delete(nc)  # liveness.go:55-62
            return Result()
        return Result(requeue_after=self.registration_ttl - age)

    # -- termination --------------------------------------------------------

    def _finalize(self, nc: NodeClaim) -> Optional[Result]:
        node = self._node_for(nc)
        if node is not None and node.metadata.deletion_timestamp is None:
            self.store.delete(node)
            return Result(requeue_after=1.0)
        if node is not None:
            # node termination controller is still draining
            return Result(requeue_after=1.0)
        try:
            self.cloud_provider.delete(nc)
        except NodeClaimNotFoundError:
            pass
        from ..metrics import registry as metrics
        metrics.NODECLAIMS_TERMINATED.inc({"nodepool": nc.nodepool_name})
        self.store.remove_finalizer(nc, api_labels.TERMINATION_FINALIZER)
        return None
