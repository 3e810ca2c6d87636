"""Node auto-repair (feature-gated).

Mirrors karpenter's pkg/controllers/node/health/controller.go:74-203:
match cloudprovider RepairPolicies against node conditions, force-delete
unhealthy nodes once the toleration elapses, and trip a circuit breaker when
more than 20% of the cluster is unhealthy.
"""

from __future__ import annotations

from typing import Optional

from ..api.objects import Node
from ..kube.store import Store
from ..state.cluster import Cluster
from ..utils import node as node_utils
from ..utils.clock import Clock
from .manager import Controller, Result

UNHEALTHY_CLUSTER_THRESHOLD = 0.2  # health/controller.go circuit breaker


class NodeHealth(Controller):
    name = "node.health"
    kinds = (Node,)

    def __init__(self, store: Store, cluster: Cluster, cloud_provider,
                 clock: Optional[Clock] = None, recorder=None):
        from ..events.recorder import Recorder
        self.store = store
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.clock = clock or store.clock
        self.recorder = recorder or Recorder(self.clock)

    def reconcile(self, node: Node) -> Optional[Result]:
        if node.metadata.deletion_timestamp is not None:
            return None
        policies = self.cloud_provider.repair_policies()
        if not policies:
            return None
        matched = None
        for p in policies:
            cond = node_utils.get_condition(node, p.condition_type)
            if cond is not None and cond[0] == p.condition_status:
                matched = (p, cond[1])
                break
        if matched is None:
            return None
        policy, since = matched
        elapsed = self.clock.now() - since
        if elapsed < policy.toleration_duration:
            return Result(requeue_after=policy.toleration_duration - elapsed)
        from ..api.nodeclaim import NodeClaim
        nc = next((c for c in self.store.list(NodeClaim)
                   if c.status.node_name == node.name), None)
        if self._circuit_broken():
            # controller.go:207-210: tell the operator WHY repair stalled
            from ..events import catalog as events_catalog
            self.recorder.publish(*events_catalog.node_repair_blocked(
                node.name, nc.name if nc is not None else "",
                "more than 20% nodes are unhealthy in the cluster"))
            return Result(requeue_after=60.0)
        # delete the backing claim (controller.go:121-126); bare nodes delete
        # directly
        if nc is not None:
            if nc.metadata.deletion_timestamp is None:
                self.store.delete(nc)
        else:
            self.store.delete(node)
        return None

    def _circuit_broken(self) -> bool:
        """Unhealthy count above ceil(20% of nodes) blocks repair
        (controller.go:168-201: up to 20%, rounded up, may be unhealthy)."""
        import math
        nodes = self.store.list(Node)
        if not nodes:
            return False
        policies = self.cloud_provider.repair_policies()
        unhealthy = 0
        for n in nodes:
            for p in policies:
                cond = node_utils.get_condition(n, p.condition_type)
                if cond is not None and cond[0] == p.condition_status:
                    unhealthy += 1
                    break
        threshold = math.ceil(UNHEALTHY_CLUSTER_THRESHOLD * len(nodes))
        return unhealthy > threshold
