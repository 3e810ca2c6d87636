"""Metric-exporter controllers for pods and nodes.

Mirrors karpenter's pkg/controllers/metrics/{pod,node}/: pod phase
gauges and scheduling latency histograms (pod/controller.go:208-404), node
allocatable/used utilization gauges (node/controller.go:162-260). The
nodepool exporter lives in nodepool_aux.NodePoolCounter.

Both exporters set the series the reference's do, to the same values, but
in work linear in the events: the reference lists every pod of the store
per pod event and recomputes every state node's pod-request total per pod
or node event, which makes an operator pass quadratic in pods. Here
PodMetrics keeps each pod's (phase, scheduled) key and moves one count per
reconcile; NodeMetrics refreshes the state nodes that the cluster journaled
as changed since its last reconcile (state/cluster.py ``node_journal``),
keeping each one's request totals by pod. Each does one full scan, the
reference's, on its first reconcile, and NodeMetrics again whenever another
exporter wrote the node gauges last (two operators in one process share
the registry).
"""

from __future__ import annotations

from typing import Dict, Optional

from ..api.objects import Node, Pod
from ..kube.store import Store
from ..metrics.registry import REGISTRY
from ..state.cluster import Cluster
from ..state.statenode import StateNode
from ..utils.clock import Clock
from .manager import Controller, Result

POD_STATE = REGISTRY.gauge(
    "karpenter_pods_state", "Pod count by phase/binding",
    ("phase", "scheduled"))
POD_SCHEDULING_DECISION = REGISTRY.histogram(
    "karpenter_pods_provisioning_scheduling_decision_duration_seconds",
    "Time from pod ack to scheduling decision")
POD_BOUND_DURATION = REGISTRY.histogram(
    "karpenter_pods_bound_duration_seconds",
    "Time from pod creation to binding")
NODE_ALLOCATABLE = REGISTRY.gauge(
    "karpenter_nodes_allocatable", "Node allocatable per resource",
    ("node_name", "nodepool", "resource_type"))
NODE_USED = REGISTRY.gauge(
    "karpenter_nodes_total_pod_requests", "Requested resources per node",
    ("node_name", "nodepool", "resource_type"))


def _state_key(pod: Pod) -> tuple:
    return pod.status.phase, str(bool(pod.spec.node_name)).lower()


class PodMetrics(Controller):
    name = "metrics.pod"
    kinds = (Pod,)

    def __init__(self, store: Store, cluster: Cluster,
                 clock: Optional[Clock] = None):
        self.store = store
        self.cluster = cluster
        self.clock = clock or store.clock
        self._bound_seen: set = set()
        # (namespace, name) -> (phase, scheduled) of each pod in the store,
        # as of its last reconcile; None until the first reconcile's scan
        self._keys: Optional[Dict[tuple, tuple]] = None
        self._counts: Dict[tuple, int] = {}

    def reconcile(self, pod: Pod) -> Optional[Result]:
        self._refresh_state_gauge(pod)
        key = f"{pod.namespace}/{pod.name}"
        if pod.spec.node_name and pod.uid not in self._bound_seen:
            self._bound_seen.add(pod.uid)
            POD_BOUND_DURATION.observe(
                self.clock.now() - pod.metadata.creation_timestamp)
            decided = self.cluster.pod_scheduling_decisions.get(key)
            acked = self.cluster.pod_acks.get(key)
            if decided is not None and acked is not None:
                POD_SCHEDULING_DECISION.observe(max(0.0, decided - acked))
        return None

    def _refresh_state_gauge(self, pod: Pod) -> None:
        counts = self._counts
        if self._keys is None:
            # the reference's scan, once: every later change to a pod
            # reaches this controller as that pod's own reconcile
            self._keys = {}
            for p in self.store.list(Pod):
                k = _state_key(p)
                self._keys[(p.namespace, p.name)] = k
                counts[k] = counts.get(k, 0) + 1
        else:
            # the manager reconciles a deleted pod with its last snapshot:
            # the store says whether it is still there (the workqueue keys
            # by name, so a re-created pod replaces its predecessor)
            name = (pod.namespace, pod.name)
            live = self.store.get(Pod, pod.name, pod.namespace)
            new = _state_key(live) if live is not None else None
            old = self._keys.pop(name, None)
            if new is not None:
                self._keys[name] = new
            if old != new:
                if old is not None:
                    counts[old] -= 1
                    if not counts[old]:
                        del counts[old]
                if new is not None:
                    counts[new] = counts.get(new, 0) + 1
        for (phase, scheduled), n in counts.items():
            POD_STATE.set(n, {"phase": phase, "scheduled": scheduled})
        # combos that emptied out are deleted, not left at their last value
        # (metrics/pod suite: the state metric disappears with the pod);
        # pruning against the gauge's own series also clears leftovers from
        # a previous controller instance on the shared registry object
        POD_STATE.prune([{"phase": p, "scheduled": s} for p, s in counts])


class _NodeSeries:
    """What NodeMetrics knows of one state node: its request totals, kept
    by pod (resource quantities are integers, so sums and differences are
    exact), and the series it last wrote."""

    __slots__ = ("sn", "requests", "totals", "holders", "labels", "alloc",
                 "used")

    def __init__(self, sn: StateNode):
        self.sn = sn
        self.requests: Dict[str, dict] = {}   # pod uid -> its requests
        self.totals: Dict[str, int] = {}      # resource -> sum over pods
        self.holders: Dict[str, int] = {}     # resource -> pods naming it
        self.labels: Optional[dict] = None
        self.alloc: dict = {}
        self.used: dict = {}
        for uid, requests in sn.pod_requests.items():
            self.move(uid, requests)

    def move(self, uid: str, requests: Optional[dict]) -> None:
        """Make the pod ``uid``'s requests ``requests`` (None: gone)."""
        old = self.requests.pop(uid, None)
        if old is requests:
            if requests is not None:
                self.requests[uid] = requests
            return
        if old is not None:
            for r, v in old.items():
                self.totals[r] -= v
                self.holders[r] -= 1
                if not self.holders[r]:
                    del self.holders[r], self.totals[r]
        if requests is not None:
            self.requests[uid] = requests
            for r, v in requests.items():
                self.totals[r] = self.totals.get(r, 0) + v
                self.holders[r] = self.holders.get(r, 0) + 1


class NodeMetrics(Controller):
    name = "metrics.node"
    kinds = (Node, Pod)

    def __init__(self, store: Store, cluster: Cluster):
        self.store = store
        self.cluster = cluster
        self._journal: Optional[dict] = None
        self._nodes: Dict[int, _NodeSeries] = {}
        # series key -> id of the state node that wrote it last: two state
        # nodes can name one series (a node and another's claim of the same
        # name), and a series goes only when the node that owns it stops
        # naming it
        self._owner_alloc: Dict[tuple, int] = {}
        self._owner_used: Dict[tuple, int] = {}

    def reconcile(self, obj) -> Optional[Result]:
        global _NODE_SERIES_WRITER
        journal = self.cluster.node_journal
        if journal is None or journal is not self._journal \
                or _NODE_SERIES_WRITER is not self:
            self._refresh_all()
            _NODE_SERIES_WRITER = self
            return None
        touched = list(journal.values())
        journal.clear()
        for sn, uids in touched:
            self._refresh(sn, uids)
        return None

    def _refresh_all(self) -> None:
        """The reference's reconcile: every state node's series, and a
        prune of every other series of the two gauges."""
        self._journal = self.cluster.node_journal = {}
        self._nodes = {}
        self._owner_alloc = {}
        self._owner_used = {}
        for sn in self.cluster.state_nodes(deep_copy=False):
            entry = self._nodes[id(sn)] = _NodeSeries(sn)
            self._write(entry)
        NODE_ALLOCATABLE.prune([dict(k) for k in self._owner_alloc])
        NODE_USED.prune([dict(k) for k in self._owner_used])

    def _refresh(self, sn: StateNode, uids: set) -> None:
        entry = self._nodes.get(id(sn))
        if not self._held(sn):
            if entry is not None:
                del self._nodes[id(sn)]
                self._drop(entry, (), ())
            return
        if entry is None:
            entry = self._nodes[id(sn)] = _NodeSeries(sn)
        else:
            for uid in uids:
                entry.move(uid, sn.pod_requests.get(uid))
        self._write(entry)

    def _held(self, sn: StateNode) -> bool:
        """Whether the cluster still tracks ``sn``, under one of the keys
        that cluster.update_node / update_nodeclaim file a node by."""
        nodes = self.cluster.nodes
        keys = []
        if sn.node is not None:
            keys += [sn.node.spec.provider_id, f"node://{sn.node.name}"]
        if sn.nodeclaim is not None:
            keys += [sn.nodeclaim.status.provider_id,
                     f"nodeclaim://{sn.nodeclaim.name}"]
        return any(key and nodes.get(key) is sn for key in keys)

    def _write(self, entry: _NodeSeries) -> None:
        sn = entry.sn
        labels = {"node_name": sn.name(), "nodepool": sn.nodepool_name()}
        alloc = sn.allocatable()
        used = entry.totals
        if labels == entry.labels and alloc == entry.alloc \
                and used == entry.used:
            return
        me = id(sn)
        alloc_keys, used_keys = [], []
        for gauge, values, owner, keys in (
                (NODE_ALLOCATABLE, alloc, self._owner_alloc, alloc_keys),
                (NODE_USED, used, self._owner_used, used_keys)):
            for rname, v in values.items():
                series = {**labels, "resource_type": rname}
                gauge.set(v, series)
                key = tuple(sorted(series.items()))
                owner[key] = me
                keys.append(key)
        self._drop(entry, alloc_keys, used_keys)
        entry.labels, entry.alloc, entry.used = labels, dict(alloc), dict(used)

    def _drop(self, entry: _NodeSeries, alloc_keys, used_keys) -> None:
        """Delete the series ``entry`` wrote before and names no more."""
        if entry.labels is None:
            return
        me = id(entry.sn)
        for gauge, values, owner, keep in (
                (NODE_ALLOCATABLE, entry.alloc, self._owner_alloc,
                 set(alloc_keys)),
                (NODE_USED, entry.used, self._owner_used, set(used_keys))):
            for rname in values:
                key = tuple(sorted({**entry.labels,
                                    "resource_type": rname}.items()))
                if key not in keep and owner.get(key) == me:
                    del owner[key]
                    gauge.delete(dict(key))


# the NodeMetrics that wrote the node gauges last: another one's writes
# (a second operator in the process) send the next reconcile to a full scan
_NODE_SERIES_WRITER: Optional[NodeMetrics] = None
