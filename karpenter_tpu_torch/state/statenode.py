"""StateNode: the Node + NodeClaim union tracked by cluster state.

Mirrors karpenter's pkg/controllers/state/statenode.go: per-pod request
tracking, daemonset accounting, the taint view that hides ephemeral/startup
taints before initialization (statenode.go:279-309), Available() =
Allocatable - PodRequests (:364-366), and the disruption validation gates
(:183-232).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional

from ..api import labels as api_labels
from ..api.nodeclaim import COND_INITIALIZED, NodeClaim
from ..api.objects import Node, Pod, Taint
from ..scheduling.hostports import HostPortUsage, get_host_ports
from ..scheduling.taints import KNOWN_EPHEMERAL_TAINTS
from ..scheduling.volumeusage import Volumes, VolumeUsage
from ..utils import resources as res


class StateNode:
    def __init__(self, node: Optional[Node] = None, nodeclaim: Optional[NodeClaim] = None):
        self.node = node
        self.nodeclaim = nodeclaim
        self.pod_requests: Dict[str, dict] = {}
        self.pod_limits: Dict[str, dict] = {}
        self.daemonset_pod_requests: Dict[str, dict] = {}
        self._host_port_usage = HostPortUsage()
        self._volume_usage = VolumeUsage()
        self.pod_volumes: Dict[str, Volumes] = {}
        self.mark_for_deletion = False
        self.nominated_until: float = 0.0
        # monotone content revision, bumped by Cluster on every mutation
        # that can change what a solver encode reads off this node (labels,
        # taints, allocatable, pod usage, ports, volumes), paired with a
        # process-unique creation identity. The persistent ProblemState
        # keys its per-node encoded rows on (identity, revision): the
        # identity makes a deleted-and-recreated node under the same name
        # a NEW cache key even when its event sequence replays the same
        # revision count (revision alone would collide and serve the old
        # node's stale row). deep_copy preserves both.
        self.revision: int = 0
        self.identity: int = next(StateNode._IDENT_SEQ)

    _IDENT_SEQ = itertools.count(1)

    def bump(self) -> None:
        self.revision += 1

    # --- identity ----------------------------------------------------------

    @property
    def provider_id(self) -> str:
        if self.node is not None and self.node.spec.provider_id:
            return self.node.spec.provider_id
        if self.nodeclaim is not None:
            return self.nodeclaim.status.provider_id
        return ""

    def name(self) -> str:
        if self.node is not None:
            return self.node.name
        if self.nodeclaim is not None:
            return self.nodeclaim.name
        return ""

    def hostname(self) -> str:
        return self.labels().get(api_labels.LABEL_HOSTNAME, self.name())

    def labels(self) -> dict:
        if self.node is not None:
            return self.node.labels
        if self.nodeclaim is not None:
            return self.nodeclaim.metadata.labels
        return {}

    def annotations(self) -> dict:
        if self.node is not None:
            return self.node.metadata.annotations
        if self.nodeclaim is not None:
            return self.nodeclaim.metadata.annotations
        return {}

    def managed(self) -> bool:
        """A node is Karpenter-managed when owned by a NodeClaim or labeled with
        a nodepool."""
        return self.nodeclaim is not None or \
            api_labels.NODEPOOL_LABEL_KEY in self.labels()

    def nodepool_name(self) -> str:
        return self.labels().get(api_labels.NODEPOOL_LABEL_KEY, "")

    # --- lifecycle views ---------------------------------------------------

    def initialized(self) -> bool:
        """Node registered + initialized label set (statenode.go semantics: the
        lifecycle controller stamps karpenter.sh/initialized on the node)."""
        if self.node is not None:
            return self.node.labels.get(api_labels.NODE_INITIALIZED_LABEL_KEY) == "true"
        return False

    def deleting(self) -> bool:
        if self.mark_for_deletion:
            return True
        if self.node is not None and self.node.metadata.deletion_timestamp is not None:
            return True
        if self.nodeclaim is not None and self.nodeclaim.metadata.deletion_timestamp is not None:
            return True
        return False

    def nominated(self, now: float) -> bool:
        return now < self.nominated_until

    def taints(self) -> List[Taint]:
        """statenode.go:279-309 — before initialization, ephemeral taints and the
        nodepool's startup taints are expected to disappear, so hide them."""
        source = []
        if self.node is not None:
            source = list(self.node.spec.taints)
        elif self.nodeclaim is not None:
            source = list(self.nodeclaim.spec.taints) + list(self.nodeclaim.spec.startup_taints)
        if self.initialized() or not self.managed():
            return source
        startup = list(self.nodeclaim.spec.startup_taints) if self.nodeclaim is not None else []
        out = []
        for t in source:
            if any(t.matches(e) for e in KNOWN_EPHEMERAL_TAINTS):
                continue
            if any(t.matches(s) for s in startup):
                continue
            out.append(t)
        return out

    # --- resources ---------------------------------------------------------

    def capacity(self) -> dict:
        if self.node is not None and self.node.status.capacity:
            return self.node.status.capacity
        if self.nodeclaim is not None:
            return self.nodeclaim.status.capacity
        return {}

    def allocatable(self) -> dict:
        if self.node is not None and self.node.status.allocatable:
            return self.node.status.allocatable
        if self.nodeclaim is not None:
            return self.nodeclaim.status.allocatable
        return {}

    def pod_request_total(self) -> dict:
        return res.merge(*self.pod_requests.values()) if self.pod_requests else {}

    def daemonset_requests(self) -> dict:
        return res.merge(*self.daemonset_pod_requests.values()) \
            if self.daemonset_pod_requests else {}

    def available(self) -> dict:
        """Allocatable minus everything scheduled here (statenode.go:364-366)."""
        return res.subtract(self.allocatable(), self.pod_request_total())

    def host_port_usage(self) -> HostPortUsage:
        return self._host_port_usage

    # --- pod tracking ------------------------------------------------------

    def update_pod(self, pod: Pod, volumes: Optional[Volumes] = None) -> None:
        self.revision += 1
        requests = pod.requests()
        self.pod_requests[pod.uid] = requests
        if pod.is_daemonset_pod:
            self.daemonset_pod_requests[pod.uid] = requests
        self._host_port_usage.delete_pod(pod.uid)
        self._host_port_usage.add(pod, get_host_ports(pod))
        if volumes:
            old = self.pod_volumes.pop(pod.uid, None)
            if old:
                self._volume_usage.delete_pod_volumes(old)
            self.pod_volumes[pod.uid] = volumes
            self._volume_usage.add(volumes)

    def cleanup_pod(self, pod_uid: str) -> None:
        self.revision += 1
        self.pod_requests.pop(pod_uid, None)
        self.pod_limits.pop(pod_uid, None)
        self.daemonset_pod_requests.pop(pod_uid, None)
        self._host_port_usage.delete_pod(pod_uid)
        old = self.pod_volumes.pop(pod_uid, None)
        if old:
            self._volume_usage.delete_pod_volumes(old)

    def volume_usage(self) -> VolumeUsage:
        return self._volume_usage

    # --- disruption gates --------------------------------------------------

    def validate_node_disruptable(self, now: float) -> Optional[str]:
        """statenode.go:183-208: do-not-disrupt annotation, nomination, missing
        nodeclaim, uninitialized all block disruption."""
        if self.nodeclaim is None:
            return "node isn't managed by a nodeclaim"
        if self.annotations().get(api_labels.DO_NOT_DISRUPT_ANNOTATION_KEY) == "true":
            return f"disruption is blocked through the {api_labels.DO_NOT_DISRUPT_ANNOTATION_KEY} annotation"
        if not self.initialized():
            return "node is not initialized"
        if self.nominated(now):
            return "node is nominated for a pending pod"
        if self.deleting():
            return "node is deleting or marked for deletion"
        return None

    def deep_copy(self) -> "StateNode":
        out = StateNode(node=self.node, nodeclaim=self.nodeclaim)
        out.pod_requests = dict(self.pod_requests)
        out.pod_limits = dict(self.pod_limits)
        out.daemonset_pod_requests = dict(self.daemonset_pod_requests)
        out._host_port_usage = self._host_port_usage.copy()
        out._volume_usage = self._volume_usage.copy()
        out.pod_volumes = dict(self.pod_volumes)
        out.mark_for_deletion = self.mark_for_deletion
        out.nominated_until = self.nominated_until
        out.revision = self.revision
        out.identity = self.identity
        return out
