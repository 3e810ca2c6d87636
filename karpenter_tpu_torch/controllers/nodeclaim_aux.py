"""Auxiliary NodeClaim controllers: expiration, garbage collection, pod
events, consistency.

Mirrors karpenter's pkg/controllers/nodeclaim/{expiration,
garbagecollection,podevents,consistency}/.
"""

from __future__ import annotations

from typing import Optional

from ..api import labels as api_labels
from ..api.nodeclaim import NodeClaim
from ..api.objects import Node, Pod
from ..cloudprovider.types import NodeClaimNotFoundError
from ..events.recorder import Event, Recorder
from ..kube.store import Store
from ..state.cluster import Cluster
from ..utils.clock import Clock
from .manager import Controller, Result, SingletonController

GC_POLL_SECONDS = 120.0          # garbagecollection/controller.go:59 (2 min)
POD_EVENT_DEDUPE_SECONDS = 5.0   # podevents/controller.go:63


class Expiration(Controller):
    """expiration/controller.go:54-89: forcefully delete claims older than
    expireAfter (no sim, no budget — expiration is a contract)."""

    name = "nodeclaim.expiration"
    kinds = (NodeClaim,)

    def __init__(self, store: Store, clock: Optional[Clock] = None):
        self.store = store
        self.clock = clock or store.clock

    def reconcile(self, nc: NodeClaim) -> Optional[Result]:
        if nc.metadata.deletion_timestamp is not None:
            return None
        expire_after = nc.spec.expire_after
        if not expire_after:
            return None
        age = self.clock.now() - nc.metadata.creation_timestamp
        if age >= expire_after:
            self.store.delete(nc)
            return None
        return Result(requeue_after=expire_after - age)


class GarbageCollection(SingletonController):
    """garbagecollection/controller.go:59-118: 2-minute poll deleting
    (a) claims whose cloud instance vanished after launch, and (b) untracked
    cloud instances with no matching claim."""

    name = "nodeclaim.garbagecollection"

    def __init__(self, store: Store, cloud_provider,
                 clock: Optional[Clock] = None):
        self.store = store
        self.cloud_provider = cloud_provider
        self.clock = clock or store.clock

    def reconcile(self) -> Optional[Result]:
        cloud_ids = {nc.status.provider_id for nc in self.cloud_provider.list()}
        tracked_ids = set()
        for nc in self.store.list(NodeClaim):
            pid = nc.status.provider_id
            tracked_ids.add(pid)
            if nc.launched() and pid and pid not in cloud_ids \
                    and nc.metadata.deletion_timestamp is None:
                self.store.delete(nc)
        for cloud_nc in self.cloud_provider.list():
            pid = cloud_nc.status.provider_id
            if pid and pid not in tracked_ids:
                try:
                    self.cloud_provider.delete(cloud_nc)
                except NodeClaimNotFoundError:
                    pass
        return Result(requeue_after=GC_POLL_SECONDS)


class PodEvents(Controller):
    """podevents/controller.go:63-98: stamp status.lastPodEventTime on the
    claim backing a pod's node (5 s dedupe) to drive consolidateAfter."""

    name = "nodeclaim.podevents"
    kinds = (Pod,)

    def __init__(self, store: Store, cluster: Cluster,
                 clock: Optional[Clock] = None):
        self.store = store
        self.cluster = cluster
        self.clock = clock or store.clock

    def reconcile(self, pod: Pod) -> Optional[Result]:
        node_name = pod.spec.node_name
        if not node_name:
            return None
        for nc in self.store.list(NodeClaim):
            if nc.status.node_name == node_name:
                now = self.clock.now()
                if now - nc.status.last_pod_event_time >= POD_EVENT_DEDUPE_SECONDS:
                    nc.status.last_pod_event_time = now
                    self.store.update(nc)
                break
        return None


class Consistency(Controller):
    """consistency/controller.go:78-145: sanity invariants between claim and
    node, surfaced as events rather than mutations."""

    name = "nodeclaim.consistency"
    kinds = (NodeClaim,)

    def __init__(self, store: Store, recorder: Recorder,
                 clock: Optional[Clock] = None):
        self.store = store
        self.recorder = recorder
        self.clock = clock or store.clock

    def reconcile(self, nc: NodeClaim) -> Optional[Result]:
        if nc.metadata.deletion_timestamp is not None or not nc.registered():
            return None
        node = self.store.get(Node, nc.status.node_name) \
            if nc.status.node_name else None
        if node is None:
            return None
        # node shape must cover what the claim promised
        for rname, req in nc.status.allocatable.items():
            if req > 0 and node.status.allocatable.get(rname, 0) <= 0:
                self.recorder.publish(Event(
                    object_kind="NodeClaim", object_name=nc.name,
                    type="Warning", reason="FailedConsistencyCheck",
                    message=f"expected resource \"{rname}\" didn't register "
                            "on the node"))
        # claim taints the node never observed (post-registration)
        if nc.initialized():
            node_taints = {(t.key, t.effect) for t in node.spec.taints}
            for t in nc.spec.taints:
                if (t.key, t.effect) not in node_taints:
                    self.recorder.publish(Event(
                        object_kind="NodeClaim", object_name=nc.name,
                        type="Warning", reason="FailedConsistencyCheck",
                        message=f"expected taint \"{t.key}:{t.effect}\" "
                                "didn't register on the node"))
        return None
