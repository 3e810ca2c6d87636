"""NodePool controllers: hash maintenance, resource counting, readiness,
validation.

Mirrors karpenter's pkg/controllers/nodepool/{hash,counter,readiness,
validation}/.
"""

from __future__ import annotations

from typing import Optional

from ..api import labels as api_labels
from ..api.nodeclaim import NodeClaim
from ..api.nodepool import NODEPOOL_HASH_VERSION, NodePool
from ..kube.store import Store
from ..metrics import registry as metrics
from ..state.cluster import Cluster
from ..utils import resources as res
from ..utils.clock import Clock
from .manager import Controller, Result

COND_VALIDATION_SUCCEEDED = "ValidationSucceeded"
COND_NODECLASS_READY = "NodeClassReady"


class NodePoolHash(Controller):
    """hash/controller.go:54-118: keep the static-drift hash annotation
    current on the pool and backfill claims across hash-version bumps."""

    name = "nodepool.hash"
    kinds = (NodePool,)

    def __init__(self, store: Store):
        self.store = store

    def reconcile(self, pool: NodePool) -> Optional[Result]:
        h = pool.static_hash()
        ann = pool.metadata.annotations
        if ann.get(api_labels.NODEPOOL_HASH_ANNOTATION_KEY) != h or \
                ann.get(api_labels.NODEPOOL_HASH_VERSION_ANNOTATION_KEY) != \
                NODEPOOL_HASH_VERSION:
            ann[api_labels.NODEPOOL_HASH_ANNOTATION_KEY] = h
            ann[api_labels.NODEPOOL_HASH_VERSION_ANNOTATION_KEY] = \
                NODEPOOL_HASH_VERSION
            self.store.update(pool)
        # version-bump backfill: claims at an older hash version adopt the
        # pool's current hash instead of being treated as drifted
        for nc in self.store.list(NodeClaim):
            if nc.nodepool_name != pool.name:
                continue
            nc_ann = nc.metadata.annotations
            if nc_ann.get(api_labels.NODEPOOL_HASH_VERSION_ANNOTATION_KEY) != \
                    NODEPOOL_HASH_VERSION:
                nc_ann[api_labels.NODEPOOL_HASH_ANNOTATION_KEY] = h
                nc_ann[api_labels.NODEPOOL_HASH_VERSION_ANNOTATION_KEY] = \
                    NODEPOOL_HASH_VERSION
                self.store.update(nc)
        return None


class NodePoolCounter(Controller):
    """counter/controller.go:69-113: aggregate in-use resources of the pool's
    nodes into NodePool.status.resources (+ usage/limit gauges)."""

    name = "nodepool.counter"
    kinds = (NodePool, NodeClaim)

    def __init__(self, store: Store, cluster: Cluster):
        self.store = store
        self.cluster = cluster

    def reconcile(self, obj) -> Optional[Result]:
        pools = ([obj] if isinstance(obj, NodePool)
                 else self.store.list(NodePool))
        for pool in pools:
            total: dict = {}
            count = 0
            for sn in self.cluster.state_nodes(deep_copy=False):
                if sn.nodepool_name() != pool.name or sn.deleting():
                    continue
                total = res.merge(total, sn.capacity())
                count += 1
            total["nodes"] = count * 1000  # milliunit convention
            if pool.status.resources != total:
                pool.status.resources = total
                self.store.update(pool)
            for rname, v in total.items():
                metrics.NODEPOOL_USAGE.set(
                    v, {"nodepool": pool.name, "resource_type": rname})
            for rname, v in pool.spec.limits.items():
                metrics.NODEPOOL_LIMIT.set(
                    v, {"nodepool": pool.name, "resource_type": rname})
        return None


class NodePoolValidation(Controller):
    """validation/controller.go:51-76: runtime validation -> condition."""

    name = "nodepool.validation"
    kinds = (NodePool,)

    def __init__(self, store: Store):
        self.store = store

    def reconcile(self, pool: NodePool) -> Optional[Result]:
        from ..api.validation import validate_nodeclaim_template_spec
        errs = []
        for b in pool.spec.disruption.budgets:
            v = b.nodes.strip()
            if v.endswith("%"):
                v = v[:-1]
            if not v.isdigit():
                errs.append(f"invalid budget nodes {b.nodes!r}")
        # the webhook battery (nodeclaim_validation.go:62-151): operators,
        # restricted labels, qualified names, minValues, Gt/Lt, taint shape
        errs.extend(validate_nodeclaim_template_spec(pool.spec.template.spec))
        status = "False" if errs else "True"
        self._set_condition(pool, COND_VALIDATION_SUCCEEDED, status,
                            "; ".join(errs))
        return None

    def _set_condition(self, pool: NodePool, ctype: str, status: str,
                       message: str = "") -> None:
        for c in pool.status.conditions:
            if c.get("type") == ctype:
                # message alone can change (e.g. one of several validation
                # errors fixed while others remain) — stale text misleads
                if c.get("status") != status or c.get("message") != message:
                    c["status"] = status
                    c["message"] = message
                    self.store.update(pool)
                return
        pool.status.conditions.append(
            {"type": ctype, "status": status, "message": message})
        self.store.update(pool)


class NodePoolReadiness(NodePoolValidation):
    """readiness/controller.go:54-103: NodePool Ready from NodeClass
    readiness. Without a NodeClass CRD system, a pool referencing no class is
    ready; one naming a class is ready when the provider says so."""

    name = "nodepool.readiness"
    kinds = (NodePool,)

    def __init__(self, store: Store, cloud_provider=None):
        super().__init__(store)
        self.cloud_provider = cloud_provider

    def reconcile(self, pool: NodePool) -> Optional[Result]:
        ready = True
        ref = pool.spec.template.spec.node_class_ref
        checker = getattr(self.cloud_provider, "node_class_ready", None)
        if ref.name and checker is not None:
            ready = bool(checker(ref))
        self._set_condition(pool, "Ready", "True" if ready else "False")
        return None
