"""Hydration: backfill labels/fields on objects created by older versions.

Mirrors karpenter's pkg/controllers/{nodeclaim,node}/hydration/: objects
from before a label/scheme change get the current fields stamped so the rest
of the controllers can assume the invariants (e.g. every managed node
carries the nodepool label and the termination finalizer).
"""

from __future__ import annotations

from typing import Optional

from ..api import labels as api_labels
from ..api.nodeclaim import NodeClaim
from ..api.objects import Node
from ..kube.store import Store
from .manager import Controller, Result


class NodeClaimHydration(Controller):
    name = "nodeclaim.hydration"
    kinds = (NodeClaim,)

    def __init__(self, store: Store):
        self.store = store

    def reconcile(self, nc: NodeClaim) -> Optional[Result]:
        if nc.metadata.deletion_timestamp is not None:
            return None
        changed = False
        pool = nc.metadata.labels.get(api_labels.NODEPOOL_LABEL_KEY)
        for ref in nc.metadata.owner_refs:
            if ref.kind == "NodePool" and not pool:
                nc.metadata.labels[api_labels.NODEPOOL_LABEL_KEY] = ref.name
                changed = True
        if api_labels.TERMINATION_FINALIZER not in nc.metadata.finalizers:
            nc.metadata.finalizers.append(api_labels.TERMINATION_FINALIZER)
            changed = True
        if changed:
            self.store.update(nc)
        return None


class NodeHydration(Controller):
    name = "node.hydration"
    kinds = (Node,)

    def __init__(self, store: Store):
        self.store = store

    def reconcile(self, node: Node) -> Optional[Result]:
        if node.metadata.deletion_timestamp is not None:
            return None
        nc = next((c for c in self.store.list(NodeClaim)
                   if c.status.node_name == node.name
                   or (c.status.provider_id
                       and c.status.provider_id == node.spec.provider_id)),
                  None)
        if nc is None:
            return None
        changed = False
        for key in (api_labels.NODEPOOL_LABEL_KEY,
                    api_labels.CAPACITY_TYPE_LABEL_KEY):
            v = nc.metadata.labels.get(key)
            if v and key not in node.metadata.labels:
                node.metadata.labels[key] = v
                changed = True
        if changed:
            self.store.update(node)
        return None
