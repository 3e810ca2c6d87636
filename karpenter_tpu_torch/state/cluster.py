"""Cluster: the in-memory mirror both solvers read.

Mirrors karpenter's pkg/controllers/state/cluster.go: nodes/nodeclaims
unified into StateNodes keyed by providerID (with name-keyed aliases while a
providerID is still unknown), pod->node bindings, the consolidated-state
timestamp that memoizes "nothing to consolidate" (cluster.go:397-423), pod
scheduling ack/decision timestamps feeding latency metrics (:321-376), the
daemonset pod cache (:437-468), and the Synced() superset check against the
store standing in for the API server (:96-150).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..api import labels as api_labels
from ..api.nodeclaim import NodeClaim
from ..api.objects import Node, Pod
from ..kube.store import Store
from ..utils.clock import Clock
from ..utils.pod import is_terminal
from .statenode import StateNode

# nomination window: how long a node is reserved for a nominated pod
# (cluster.go nominationWindow ~ 20s)
NOMINATION_WINDOW_SECONDS = 20.0
# forced consolidation revalidation period (cluster.go:404-410)
CONSOLIDATION_TIMEOUT_SECONDS = 300.0


def _pod_key(pod: Pod) -> str:
    return f"{pod.namespace}/{pod.name}"


class Cluster:
    def __init__(self, store: Store, clock: Optional[Clock] = None):
        self.store = store
        self.clock = clock or store.clock
        self.nodes: Dict[str, StateNode] = {}          # providerID -> StateNode
        self.node_name_to_provider_id: Dict[str, str] = {}
        self.nodeclaim_name_to_provider_id: Dict[str, str] = {}
        # pod key -> (node name, pod uid). The uid rides along so a pod that
        # was deleted and re-created under the same name on a different node
        # (missed DELETE event) can still be cleaned off the old node
        # (cluster.go cleanupOldBindings:630-646).
        self.bindings: Dict[str, Tuple[str, str]] = {}
        self.daemonset_pods: Dict[str, Pod] = {}       # daemonset key -> sample pod
        self.pod_acks: Dict[str, float] = {}
        self.pod_scheduling_decisions: Dict[str, float] = {}
        self.pod_to_nominated_node: Dict[str, str] = {}
        self._anti_affinity_pods: Dict[str, Pod] = {}  # pod key -> pod
        self._unsynced_start: Optional[float] = None
        # timestamp of the last consolidation-relevant cluster change
        # (cluster.go clusterState); methods memoize it per-method
        self._cluster_state: float = 0.0
        # monotone revision of everything topology counting reads: the
        # scheduled-pod set (bindings) and node identity/labels. The
        # persistent ProblemState memoizes per-group cluster topology
        # counts against this; an unchanged revision proves the counts.
        # Conservative over-bumping is safe (just a recompute).
        self.topo_revision: int = 0

    # -- sync ---------------------------------------------------------------

    def synced(self) -> bool:
        """Superset check (cluster.go:96-150): every Node/NodeClaim the store
        knows must be tracked here. With synchronous informers this is always
        true after a drain; kept for API parity and for tests that bypass
        informers."""
        for nc in self.store.list(NodeClaim):
            name = nc.name
            pid = nc.status.provider_id
            if pid:
                if pid not in self.nodes:
                    return False
            elif name not in self.nodeclaim_name_to_provider_id:
                return False
        for node in self.store.list(Node):
            pid = node.spec.provider_id
            if pid:
                if pid not in self.nodes:
                    return False
            elif node.name not in self.node_name_to_provider_id:
                return False
        return True

    # -- node / nodeclaim tracking -----------------------------------------

    def update_nodeclaim(self, nodeclaim: NodeClaim) -> None:
        pid = nodeclaim.status.provider_id or f"nodeclaim://{nodeclaim.name}"
        self.nodeclaim_name_to_provider_id[nodeclaim.name] = pid
        # migrate a placeholder entry once the real providerID appears
        placeholder = f"nodeclaim://{nodeclaim.name}"
        if pid != placeholder and placeholder in self.nodes:
            sn = self.nodes.pop(placeholder)
            self.nodes[pid] = sn
        sn = self.nodes.get(pid)
        if sn is None:
            sn = StateNode(nodeclaim=nodeclaim)
            self.nodes[pid] = sn
        else:
            sn.nodeclaim = nodeclaim
        sn.bump()
        if sn.node is None and nodeclaim.status.node_name:
            node = self.store.get(Node, nodeclaim.status.node_name)
            if node is not None:
                sn.node = node
        self.topo_revision += 1

    def delete_nodeclaim(self, name: str) -> None:
        pid = self.nodeclaim_name_to_provider_id.pop(name, None)
        if pid is None:
            return
        sn = self.nodes.get(pid)
        if sn is None:
            return
        sn.nodeclaim = None
        sn.bump()
        if sn.node is None:
            del self.nodes[pid]
        self.topo_revision += 1

    def update_node(self, node: Node) -> None:
        pid = node.spec.provider_id or f"node://{node.name}"
        first_seen = node.name not in self.node_name_to_provider_id
        self.node_name_to_provider_id[node.name] = pid
        placeholder = f"node://{node.name}"
        if pid != placeholder and placeholder in self.nodes:
            self.nodes[pid] = self.nodes.pop(placeholder)
        sn = self.nodes.get(pid)
        if sn is None:
            # match an existing nodeclaim-only entry by nodeclaim providerID
            sn = StateNode(node=node)
            self.nodes[pid] = sn
        else:
            sn.node = node
        sn.bump()
        self.topo_revision += 1
        if first_seen:
            self._populate_resource_requests(sn, node.name)

    def _populate_resource_requests(self, sn: StateNode, node_name: str) -> None:
        """Hydrate usage from pods that bound before the node was tracked
        (cluster.go populateResourceRequests:574-593)."""
        from ..scheduling.volumeusage import get_volumes
        for pod in self.store.list(Pod,
                                   field_selector=f"spec.nodeName={node_name}"):
            if is_terminal(pod):
                continue
            sn.update_pod(pod, get_volumes(self.store, pod))
            self.bindings[_pod_key(pod)] = (node_name, pod.uid)

    def delete_node(self, name: str) -> None:
        pid = self.node_name_to_provider_id.pop(name, None)
        if pid is None:
            return
        sn = self.nodes.get(pid)
        if sn is None:
            return
        sn.node = None
        sn.bump()
        if sn.nodeclaim is None:
            del self.nodes[pid]
        self.topo_revision += 1

    # -- pods ---------------------------------------------------------------

    def update_pod(self, pod: Pod) -> None:
        key = _pod_key(pod)
        if pod.metadata.deletion_timestamp is not None and pod.spec.node_name == "":
            self.delete_pod(pod)
            return
        self._update_anti_affinity_index(pod)
        if pod.spec.node_name or key in self.bindings:
            # the scheduled-pod set (or a scheduled pod's content) changed:
            # memoized topology counts are no longer proven
            self.topo_revision += 1
        if is_terminal(pod):
            # a Failed/Succeeded pod no longer consumes node resources
            # (cluster.go UpdatePod:312 -> updateNodeUsageFromPodCompletion)
            binding = self.bindings.pop(key, None)
            if binding:
                self._unbind(binding[1], binding[0])
            return
        old = self.bindings.get(key)
        if pod.spec.node_name:
            if old and (old[0] != pod.spec.node_name or old[1] != pod.uid):
                # pod name re-used (missed DELETE) on a different node — or on
                # the SAME node under a new uid: clean the old binding with
                # the uid we tracked, not the new pod's uid
                self._unbind(old[1], old[0])
            self.bindings[key] = (pod.spec.node_name, pod.uid)
            sn = self._node_by_name(pod.spec.node_name)
            if sn is not None:
                from ..scheduling.volumeusage import get_volumes
                sn.update_pod(pod, get_volumes(self.store, pod))
            self.mark_pod_schedulable(pod)
        elif old:
            self._unbind(old[1], old[0])
            del self.bindings[key]
        if pod.is_daemonset_pod:
            dkey = self._daemonset_key(pod)
            cached = self.daemonset_pods.get(dkey)
            # keep the newest pod as the daemonset exemplar (daemonset.go)
            if cached is None or pod.metadata.creation_timestamp >= \
                    cached.metadata.creation_timestamp:
                self.daemonset_pods[dkey] = pod

    def delete_pod(self, pod: Pod) -> None:
        key = _pod_key(pod)
        binding = self.bindings.pop(key, None)
        if binding:
            self._unbind(binding[1], binding[0])
            self.topo_revision += 1
        self._anti_affinity_pods.pop(key, None)
        self.pod_acks.pop(key, None)
        self.pod_scheduling_decisions.pop(key, None)
        self.pod_to_nominated_node.pop(key, None)
        if pod.is_daemonset_pod:
            dkey = self._daemonset_key(pod)
            cached = self.daemonset_pods.get(dkey)
            if cached is not None and cached.uid == pod.uid:
                # the exemplar died: fall back to any surviving sibling, else
                # drop the cache entry (daemonset deleted)
                siblings = [p for p in self.store.list(Pod,
                                                       namespace=pod.namespace)
                            if p.is_daemonset_pod and p.uid != pod.uid
                            and self._daemonset_key(p) == dkey]
                if siblings:
                    self.daemonset_pods[dkey] = max(
                        siblings, key=lambda p: p.metadata.creation_timestamp)
                else:
                    del self.daemonset_pods[dkey]
        self.mark_unconsolidated()

    def _unbind(self, pod_uid: str, node_name: str) -> None:
        sn = self._node_by_name(node_name)
        if sn is not None:
            sn.cleanup_pod(pod_uid)

    def _node_by_name(self, name: str) -> Optional[StateNode]:
        pid = self.node_name_to_provider_id.get(name)
        if pid is None:
            return None
        return self.nodes.get(pid)

    def _daemonset_key(self, pod: Pod) -> str:
        for ref in pod.metadata.owner_refs:
            if ref.kind == "DaemonSet":
                return f"{pod.namespace}/{ref.name}"
        return _pod_key(pod)

    def _update_anti_affinity_index(self, pod: Pod) -> None:
        aff = pod.spec.affinity
        has_required_anti = (aff is not None and aff.pod_anti_affinity is not None
                             and bool(aff.pod_anti_affinity.required))
        key = _pod_key(pod)
        if has_required_anti:
            self._anti_affinity_pods[key] = pod
        else:
            self._anti_affinity_pods.pop(key, None)

    def anti_affinity_pods(self) -> List[Pod]:
        return list(self._anti_affinity_pods.values())

    def daemonset_pod_list(self) -> List[Pod]:
        return list(self.daemonset_pods.values())

    # -- scheduling latency bookkeeping (cluster.go:321-376) ----------------

    def ack_pods(self, pods: List[Pod]) -> None:
        now = self.clock.now()
        for p in pods:
            self.pod_acks.setdefault(_pod_key(p), now)

    def mark_pod_scheduling_decisions(self, pod_errors: Dict[str, str],
                                      nominations: Dict[str, str]) -> None:
        now = self.clock.now()
        for key in nominations:
            self.pod_scheduling_decisions.setdefault(key, now)
            self.pod_to_nominated_node[key] = nominations[key]
        for key in pod_errors:
            self.pod_scheduling_decisions.setdefault(key, now)

    def mark_pod_schedulable(self, pod: Pod) -> None:
        self.pod_acks.pop(_pod_key(pod), None)

    def pod_ack_duration(self, pod: Pod) -> Optional[float]:
        t = self.pod_acks.get(_pod_key(pod))
        return None if t is None else self.clock.since(t)

    # -- disruption coordination -------------------------------------------

    def mark_for_deletion(self, *provider_ids: str) -> None:
        for pid in provider_ids:
            sn = self.nodes.get(pid)
            if sn is not None:
                sn.mark_for_deletion = True
        self.mark_unconsolidated()

    def unmark_for_deletion(self, *provider_ids: str) -> None:
        for pid in provider_ids:
            sn = self.nodes.get(pid)
            if sn is not None:
                sn.mark_for_deletion = False
        self.mark_unconsolidated()

    def nominate_node_for_pod(self, node_name: str, pod: Pod) -> None:
        sn = self._node_by_name(node_name)
        if sn is not None:
            sn.nominated_until = self.clock.now() + NOMINATION_WINDOW_SECONDS
        self.pod_to_nominated_node[_pod_key(pod)] = node_name

    def consolidation_state(self) -> float:
        """Timestamp of the last time the cluster changed with respect to
        consolidation. Consolidation methods memoize this token per-method
        and skip work while it's unchanged; after 5 minutes of no change the
        token is force-bumped so watchers revalidate against external drift
        (e.g. instance-type availability) we can't observe
        (cluster.go:404-423)."""
        if self.clock.since(self._cluster_state) < CONSOLIDATION_TIMEOUT_SECONDS:
            return self._cluster_state
        return self.mark_unconsolidated()

    def mark_unconsolidated(self) -> float:
        """Called on any change that could make the cluster consolidatable
        (cluster.go:394-403)."""
        self._cluster_state = self.clock.now()
        return self._cluster_state

    # -- views --------------------------------------------------------------

    def state_nodes(self, deep_copy: bool = True) -> List[StateNode]:
        """cluster.Nodes(): deep copies so a solve can't race informer updates
        (cluster.go:188-195)."""
        out = [sn.deep_copy() if deep_copy else sn for sn in self.nodes.values()]
        out.sort(key=lambda sn: sn.name())
        return out

    def deleting_nodes(self) -> List[StateNode]:
        return [sn for sn in self.nodes.values() if sn.deleting()]

    def reset(self) -> None:
        self.__init__(self.store, self.clock)
