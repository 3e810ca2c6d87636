"""NodeClaim disruption markers: the status conditions the disruption solver
consumes.

Mirrors karpenter's pkg/controllers/nodeclaim/disruption/:
- Consolidatable (consolidation.go:41-100): set once consolidateAfter has
  elapsed since the last pod event; cleared while pods churn.
- Drifted (drift.go:46-110): static drift via the nodepool-hash annotation
  diff, requirements drift via nodepool requirements vs claim labels, plus
  cloudProvider.IsDrifted.
"""

from __future__ import annotations

from typing import Optional

from ..api import labels as api_labels
from ..api.nodeclaim import (COND_CONSOLIDATABLE, COND_DRIFTED, COND_INITIALIZED,
                             COND_LAUNCHED, NodeClaim)
from ..api.nodepool import NodePool
from ..kube.store import Store
from ..scheduling.requirements import label_requirements, node_selector_requirements
from ..state.cluster import Cluster
from ..utils.clock import Clock
from .manager import Controller, Result

DRIFT_RECHECK_SECONDS = 300.0  # drift.go:68,76 — 5 min cache TTL


class NodeClaimDisruptionMarker(Controller):
    name = "nodeclaim.disruption"
    kinds = (NodeClaim,)

    def __init__(self, store: Store, cluster: Cluster, cloud_provider,
                 clock: Optional[Clock] = None):
        self.store = store
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.clock = clock or store.clock

    def reconcile(self, nc: NodeClaim) -> Optional[Result]:
        if nc.metadata.deletion_timestamp is not None:
            return None
        requeue = None
        if nc.initialized():
            requeue = self._consolidatable(nc)
        # Drift only needs Launched, not Initialized; an unlaunched claim
        # sheds any stale Drifted condition (drift.go:46-57)
        if not nc.conditions.is_true(COND_LAUNCHED):
            if nc.conditions.get(COND_DRIFTED) is not None:
                nc.conditions.clear(COND_DRIFTED)
                self.store.update(nc)
        else:
            self._drifted(nc)
        # drift inputs are external (catalog, cloud provider): re-check on a
        # timer even with no claim events (drift.go:68,76 — 5 min cache TTL)
        return Result(requeue_after=min(requeue or DRIFT_RECHECK_SECONDS,
                                        DRIFT_RECHECK_SECONDS))

    # -- Consolidatable -----------------------------------------------------

    def _consolidatable(self, nc: NodeClaim) -> Optional[float]:
        pool = self.store.get(NodePool, nc.nodepool_name)
        if pool is None:
            return None
        after = pool.spec.disruption.consolidate_after
        if after is None:  # Never
            if nc.conditions.is_true(COND_CONSOLIDATABLE):
                nc.conditions.clear(COND_CONSOLIDATABLE)
                self.store.update(nc)
            return None
        last_event = nc.status.last_pod_event_time or \
            nc.metadata.creation_timestamp
        elapsed = self.clock.now() - last_event
        if elapsed >= after:
            if not nc.conditions.is_true(COND_CONSOLIDATABLE):
                nc.conditions.set_true(COND_CONSOLIDATABLE,
                                       reason="PodsHaveSettled",
                                       now=self.clock.now())
                self.store.update(nc)
                self.cluster.mark_unconsolidated()
            return None
        if nc.conditions.is_true(COND_CONSOLIDATABLE):
            nc.conditions.clear(COND_CONSOLIDATABLE)
            self.store.update(nc)
        return after - elapsed

    # -- Drifted ------------------------------------------------------------

    def _drifted(self, nc: NodeClaim) -> None:
        pool = self.store.get(NodePool, nc.nodepool_name)
        if pool is None:
            return
        reason = self._static_drift(nc, pool) or \
            self._requirements_drift(nc, pool) or \
            self._instance_type_drift(nc, pool) or \
            self.cloud_provider.is_drifted(nc)
        if reason:
            if not nc.conditions.is_true(COND_DRIFTED):
                nc.conditions.set_true(COND_DRIFTED, reason=reason,
                                       now=self.clock.now())
                self.store.update(nc)
                self.cluster.mark_unconsolidated()
        elif nc.conditions.is_true(COND_DRIFTED):
            nc.conditions.clear(COND_DRIFTED)
            self.store.update(nc)

    def _static_drift(self, nc: NodeClaim, pool: NodePool) -> str:
        """drift.go NodePoolHash: annotation hash mismatch at same hash
        version."""
        nc_hash = nc.metadata.annotations.get(
            api_labels.NODEPOOL_HASH_ANNOTATION_KEY)
        nc_ver = nc.metadata.annotations.get(
            api_labels.NODEPOOL_HASH_VERSION_ANNOTATION_KEY)
        from ..api.nodepool import NODEPOOL_HASH_VERSION
        if nc_hash is None or nc_ver != NODEPOOL_HASH_VERSION:
            return ""
        return "NodePoolDrifted" if nc_hash != pool.static_hash() else ""

    def _instance_type_drift(self, nc: NodeClaim, pool: NodePool) -> str:
        """drift.go instanceTypeNotFound (:104-135): the claim's instance
        type — or any offering matching its zone/capacity-type labels, over
        the FULL offering list including temporarily-unavailable ones — no
        longer exists in the provider catalog."""
        it_name = nc.metadata.labels.get(api_labels.LABEL_INSTANCE_TYPE)
        if not it_name:
            return "InstanceTypeNotFound"
        its = self.cloud_provider.get_instance_types(pool)
        it = next((i for i in its if i.name == it_name), None)
        if it is None:
            return "InstanceTypeNotFound"
        if not it.offerings.has_compatible(
                label_requirements(nc.metadata.labels)):
            return "InstanceTypeNotFound"
        return ""

    def _requirements_drift(self, nc: NodeClaim, pool: NodePool) -> str:
        """drift.go RequirementsDrifted: pool requirements no longer admit the
        claim's labels."""
        pool_reqs = node_selector_requirements(
            pool.spec.template.spec.requirements)
        claim_reqs = label_requirements(nc.metadata.labels)
        # Compatible (not Intersects): a pool requirement on a key the claim
        # has no label for is drift too (drift.go:144-154)
        if claim_reqs.compatible(pool_reqs):
            return "RequirementsDrifted"
        return ""
