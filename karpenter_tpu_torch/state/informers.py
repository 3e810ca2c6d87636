"""Informer wiring: store watch events -> Cluster updates.

The reference runs five trivial informer controllers pumping API-server watch
events into state.Cluster (pkg/controllers/state/informer/{pod,node,nodeclaim,
nodepool,daemonset}.go). Here the store's watch fan-out is synchronous, so the
Cluster is always consistent with the store before any controller reconciles —
the property the reference approximates with Synced() (cluster.go:96-150).
"""

from __future__ import annotations

from ..api.nodeclaim import NodeClaim
from ..api.nodepool import NodePool
from ..api.objects import Node, Pod
from ..kube.store import ADDED, DELETED, MODIFIED, Event, Store
from .cluster import Cluster


def wire_informers(store: Store, cluster: Cluster) -> None:
    def on_event(ev: Event) -> None:
        if ev.kind is Pod:
            if ev.type == DELETED:
                cluster.delete_pod(ev.obj)
            else:
                cluster.update_pod(ev.obj)
        elif ev.kind is Node:
            if ev.type == DELETED:
                cluster.delete_node(ev.obj.name)
            else:
                cluster.update_node(ev.obj)
            cluster.mark_unconsolidated()
        elif ev.kind is NodeClaim:
            if ev.type == DELETED:
                cluster.delete_nodeclaim(ev.obj.name)
            else:
                cluster.update_nodeclaim(ev.obj)
            cluster.mark_unconsolidated()
        elif ev.kind is NodePool:
            cluster.mark_unconsolidated()

    store.watch(on_event)
