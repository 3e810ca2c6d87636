"""kwok-style synthetic instance-type catalog and simulated cloud provider.

Catalog mirrors karpenter's kwok/tools/gen_instance_types.go:52-113:
144 instance types (12 cpu sizes x 3 memory factors x 2 OS x 2 arch), each with
8 offerings (4 zones x {spot, on-demand}); price = 0.025/vCPU + 0.001/GiB,
spot = 0.7x. The provider fabricates Node objects directly, the way the kwok
provider does (kwok/cloudprovider/cloudprovider.go:53-64,143-191).
"""

from __future__ import annotations

import itertools
from typing import List, Optional

from ..api import labels as api_labels
from ..api.nodeclaim import NodeClaim
from ..api.objects import Node, NodeSpec, NodeStatus, ObjectMeta, Taint
from ..scheduling.requirement import IN, Requirement
from ..scheduling.requirements import Requirements, node_selector_requirements
from ..scheduling.taints import UNREGISTERED_NO_EXECUTE_TAINT
from ..utils import resources as res
from .types import (CloudProvider, InsufficientCapacityError, InstanceType,
                    InstanceTypeOverhead, NodeClaimNotFoundError,
                    Offering, Offerings, usable_offerings)

KWOK_ZONES = ["test-zone-a", "test-zone-b", "test-zone-c", "test-zone-d"]
KWOK_REGION = "test-region"
_CPU_SIZES = [1, 2, 4, 8, 16, 32, 48, 64, 96, 128, 192, 256]
_MEM_FACTORS = [2, 4, 8]
_OSES = ["linux", "windows"]
_ARCHES = [api_labels.ARCHITECTURE_AMD64, api_labels.ARCHITECTURE_ARM64]
_FAMILY = {2: "c", 3: "cs", 4: "s", 6: "sm", 8: "m"}

GROUP_INSTANCE_SIZE = "karpenter.kwok.sh/instance-size"
GROUP_INSTANCE_FAMILY = "karpenter.kwok.sh/instance-family"


def price_for(cpu: int, mem_gib: int) -> float:
    return 0.025 * cpu + 0.001 * mem_gib


def instance_type_name(cpu: int, mem_factor: int, arch: str, os: str) -> str:
    return f"{_FAMILY.get(mem_factor, 'e')}-{cpu}x-{arch}-{os}"


def make_instance_type(cpu: int, mem_factor: int, arch: str, os: str,
                       zones: Optional[List[str]] = None) -> InstanceType:
    zones = zones if zones is not None else KWOK_ZONES
    name = instance_type_name(cpu, mem_factor, arch, os)
    mem_gib = cpu * mem_factor
    pods = min(cpu * 16, 1024)
    capacity = res.parse_list({
        res.CPU: str(cpu),
        res.MEMORY: f"{mem_gib}Gi",
        res.PODS: str(pods),
        res.EPHEMERAL_STORAGE: "20Gi",
    })
    price = price_for(cpu, mem_gib)
    offerings = Offerings()
    for zone in zones:
        for ct in (api_labels.CAPACITY_TYPE_SPOT, api_labels.CAPACITY_TYPE_ON_DEMAND):
            offerings.append(Offering(
                requirements=Requirements([
                    Requirement(api_labels.CAPACITY_TYPE_LABEL_KEY, IN, [ct]),
                    Requirement(api_labels.LABEL_TOPOLOGY_ZONE, IN, [zone]),
                ]),
                price=price * 0.7 if ct == api_labels.CAPACITY_TYPE_SPOT else price,
                available=True,
            ))
    # Requirements must be defined for every well-known label (types.go:89-91).
    requirements = Requirements([
        Requirement(api_labels.LABEL_INSTANCE_TYPE, IN, [name]),
        Requirement(api_labels.LABEL_ARCH, IN, [arch]),
        Requirement(api_labels.LABEL_OS, IN, [os]),
        Requirement(api_labels.LABEL_TOPOLOGY_ZONE, IN, zones),
        Requirement(api_labels.LABEL_TOPOLOGY_REGION, IN, [KWOK_REGION]),
        Requirement(api_labels.CAPACITY_TYPE_LABEL_KEY, IN,
                    [api_labels.CAPACITY_TYPE_SPOT, api_labels.CAPACITY_TYPE_ON_DEMAND]),
        Requirement(GROUP_INSTANCE_SIZE, IN, [f"{cpu}x"]),
        Requirement(GROUP_INSTANCE_FAMILY, IN, [_FAMILY.get(mem_factor, "e")]),
    ])
    return InstanceType(
        name=name, requirements=requirements, offerings=offerings, capacity=capacity,
        overhead=InstanceTypeOverhead(
            kube_reserved=res.parse_list({res.CPU: "100m", res.MEMORY: "120Mi"})),
    )


def construct_instance_types(zones: Optional[List[str]] = None) -> "list[InstanceType]":
    return [make_instance_type(cpu, mf, arch, os, zones)
            for cpu in _CPU_SIZES for mf in _MEM_FACTORS for os in _OSES for arch in _ARCHES]


def construct_catalog(n: int, zones: Optional[List[str]] = None) -> "list[InstanceType]":
    """Synthetic catalog of exactly n instance types for scale testing (the
    north-star 2k-type config, BASELINE.md): a denser cpu ladder crossed with
    extra memory factors, same offering structure and price formula as the
    kwok 144."""
    import math
    mfs = [2, 3, 4, 6, 8]
    per_cpu = len(mfs) * len(_OSES) * len(_ARCHES)
    cpu_sizes = range(1, math.ceil(n / per_cpu) + 1)
    out = []
    for cpu in cpu_sizes:
        for mf in mfs:
            for os in _OSES:
                for arch in _ARCHES:
                    if len(out) >= n:
                        return out
                    out.append(make_instance_type(cpu, mf, arch, os, zones))
    return out


class KwokCloudProvider(CloudProvider):
    """Simulated fleet: Create() fabricates a Node with the unregistered taint;
    a store (if attached) receives the Node so informers/kubelet-sim can see it."""

    def __init__(self, instance_types: Optional[List[InstanceType]] = None, store=None):
        self._instance_types = instance_types if instance_types is not None else construct_instance_types()
        self._seq = itertools.count(1)
        self.store = store  # optional in-memory kube store
        self.created: dict = {}  # provider_id -> (NodeClaim, Node)
        # capacity-drought schedule (utils/chaos.CapacityDrought): a create
        # whose chosen offering matches a live window raises
        # InsufficientCapacityError carrying the matched pattern
        self.drought = None
        # UnavailableOfferings registry: when wired, create() never targets
        # an offering the registry has cached as dry
        self.unavailable = None

    @property
    def name(self) -> str:
        return "kwok"

    def create(self, nodeclaim: NodeClaim) -> NodeClaim:
        reqs = node_selector_requirements(nodeclaim.spec.requirements)
        compatible = [it for it in self._instance_types
                      if not it.requirements.intersects(reqs)
                      and res.fits(nodeclaim.spec.resources_requests, it.allocatable())
                      and it.offerings.available().has_compatible(reqs)]
        if not compatible:
            raise NodeClaimNotFoundError(f"no instance type satisfied {nodeclaim.name}")
        usable = {it.name: usable_offerings(it, reqs, self.unavailable)
                  for it in compatible}
        launchable = [it for it in compatible if usable[it.name]]
        if not launchable:
            # every compatible offering is cached dry: nothing new to learn,
            # the registry already covers them all
            raise InsufficientCapacityError(
                f"all compatible offerings for {nodeclaim.name} are marked "
                "unavailable")
        # cheapest usable offering wins, name tiebreak (order_by_price over
        # the registry-filtered offering sets)
        it = min(launchable,
                 key=lambda t: (usable[t.name].cheapest().price, t.name))
        offering = usable[it.name].cheapest()
        if self.drought is not None:
            hit = self.drought.match(it.name, offering.zone,
                                     offering.capacity_type)
            if hit is not None:
                raise InsufficientCapacityError(
                    f"capacity exhausted launching {nodeclaim.name}: "
                    f"{it.name} in {offering.zone}/{offering.capacity_type}",
                    offerings=(hit,))
        n = next(self._seq)
        provider_id = f"kwok://node-{n:05d}"
        node_name = f"kwok-node-{n:05d}"
        labels = dict(nodeclaim.metadata.labels)
        labels.update(reqs.labels())
        # the launched instance's own facts override requirement
        # representatives: a multi-valued claim requirement (arch In
        # [amd64, arm64]) must not stamp a value contradicting the chosen
        # type (launch.go merges instanceType.Requirements.Labels())
        labels.update(it.requirements.labels())
        labels[api_labels.LABEL_INSTANCE_TYPE] = it.name
        labels[api_labels.LABEL_TOPOLOGY_ZONE] = offering.zone
        labels[api_labels.CAPACITY_TYPE_LABEL_KEY] = offering.capacity_type
        labels[api_labels.LABEL_HOSTNAME] = node_name
        node = Node(
            metadata=ObjectMeta(name=node_name, labels=labels,
                                annotations=dict(nodeclaim.metadata.annotations)),
            spec=NodeSpec(
                provider_id=provider_id,
                taints=list(nodeclaim.spec.taints) + list(nodeclaim.spec.startup_taints)
                + [UNREGISTERED_NO_EXECUTE_TAINT],
            ),
            status=NodeStatus(capacity=dict(it.capacity), allocatable=dict(it.allocatable())),
        )
        nodeclaim.status.provider_id = provider_id
        nodeclaim.status.capacity = dict(it.capacity)
        nodeclaim.status.allocatable = dict(it.allocatable())
        nodeclaim.status.image_id = "kwok-image"
        # the created claim carries the launched instance's labels (the
        # reference's Create response does; launch.go merges them) — drift
        # detection reads instance-type/zone/capacity-type off the CLAIM
        claim_labels = {k: v for k, v in labels.items()
                        if k != api_labels.LABEL_HOSTNAME}
        nodeclaim.metadata.labels.update(claim_labels)
        self.created[provider_id] = (nodeclaim, node)
        if self.store is not None:
            self.store.create(node)
        return nodeclaim

    def resync(self) -> int:
        """Rebuild the simulated fleet after a store restore (restart =
        resync, cluster.go:96-150): kwok's "cloud" is the store's Node
        objects, so instances survive an operator restart the way real cloud
        instances do. Returns instances recovered."""
        if self.store is None:
            return 0
        def pid_seq(pid) -> int:
            if not pid or not pid.startswith("kwok://"):
                return -1
            try:
                return int(pid.rsplit("-", 1)[1])
            except (ValueError, IndexError):
                return -1

        claims = {nc.status.provider_id: nc
                  for nc in self.store.list(NodeClaim)
                  if nc.status.provider_id}
        # claims whose Node is already reaped still pin their sequence
        # number: a restart mid-termination must not reissue a live claim's
        # provider_id to the next create()
        hi = max((pid_seq(pid) for pid in claims), default=0)
        hi = max(hi, 0)
        n = 0
        for node in self.store.list(Node):
            pid = node.spec.provider_id
            if not pid or not pid.startswith("kwok://"):
                continue
            hi = max(hi, pid_seq(pid))
            nc = claims.get(pid)
            if nc is None:
                # claim-less instance: garbagecollection only sees instances
                # in self.created and claims in the store, so an orphan node
                # would otherwise survive forever as phantom capacity — reap
                # it here, the way GC reaps untracked cloud instances
                self.store.delete(node)
                continue
            if pid not in self.created:
                self.created[pid] = (nc, node)
                n += 1
        self._seq = itertools.count(hi + 1)
        return n

    def delete(self, nodeclaim: NodeClaim) -> None:
        pid = nodeclaim.status.provider_id
        if pid not in self.created:
            raise NodeClaimNotFoundError(pid or nodeclaim.name)
        del self.created[pid]
        if self.store is not None:
            node = self.store.get(Node, nodeclaim.status.node_name)
            if node is not None:
                self.store.delete(node)

    def get(self, provider_id: str) -> NodeClaim:
        if provider_id not in self.created:
            raise NodeClaimNotFoundError(provider_id)
        return self.created[provider_id][0]

    def list(self) -> "list[NodeClaim]":
        return [nc for nc, _ in self.created.values()]

    def get_instance_types(self, nodepool) -> "list[InstanceType]":
        return list(self._instance_types)

    def is_drifted(self, nodeclaim) -> str:
        return ""


from ..controllers.manager import Controller as _Controller


class KwokKubelet(_Controller):
    """Kubelet/node-lifecycle simulation for the kwok fleet, standing in for
    the out-of-band machinery the reference's kwok environment provides (the
    kwok controller-manager fakes node heartbeats; the workload's node agent
    removes its own startup taints once ready). After `ready_delay` seconds
    of a node being REGISTERED, this controller clears the known ephemeral
    taints and the owning claim's startup taints and stamps Ready=True — the
    inputs NodeClaimLifecycle._initialize waits for.

    A manager Controller (kinds=Node); keep it OUT of envs that assert on
    pre-initialization taint states."""

    name = "kwok.kubelet"

    def __init__(self, store, clock, ready_delay: float = 2.0):
        from ..api.objects import Node as NodeKind
        self.kinds = (NodeKind,)
        self.store = store
        self.clock = clock
        self.ready_delay = ready_delay
        self._registered_at: dict = {}
        self._last_prune_at = 0.0

    def reconcile(self, node):
        from ..api import labels as api_labels
        from ..api.nodeclaim import NodeClaim
        from ..controllers.manager import Result
        from ..scheduling.taints import KNOWN_EPHEMERAL_TAINTS
        from ..utils import node as node_utils
        pid = node.spec.provider_id
        if not pid or not pid.startswith("kwok://"):
            return None
        if node.metadata.deletion_timestamp is not None:
            self._registered_at.pop(node.metadata.uid, None)
            return None
        if node.metadata.labels.get(
                api_labels.NODE_REGISTERED_LABEL_KEY) != "true":
            return None
        # keyed by uid so a re-used node NAME never inherits a stale window;
        # entries for nodes deleted between passes are pruned opportunistically
        # (rate-limited: at 4096+ LIVE nodes an every-reconcile prune would
        # make each pass O(N^2))
        now = self.clock.now()
        if len(self._registered_at) > 4096 and \
                now - self._last_prune_at > 60.0:
            from ..api.objects import Node as NodeKind
            live = {n.metadata.uid for n in self.store.list(NodeKind)}
            self._registered_at = {u: t for u, t in self._registered_at.items()
                                   if u in live}
            self._last_prune_at = now
        first = self._registered_at.setdefault(node.metadata.uid,
                                               self.clock.now())
        elapsed = self.clock.now() - first
        if elapsed < self.ready_delay:
            return Result(requeue_after=self.ready_delay - elapsed)
        startup = []
        for nc in self.store.list(NodeClaim):
            if nc.status.provider_id == pid:
                startup = list(nc.spec.startup_taints)
                break
        kept = [t for t in node.spec.taints
                if not any(t.matches(e) for e in KNOWN_EPHEMERAL_TAINTS)
                and not any(t.matches(s) for s in startup)]
        ready = node_utils.get_condition(node, "Ready")
        changed = len(kept) != len(node.spec.taints)
        if ready is None:
            # stamp Ready once; a node someone marked NotReady stays broken
            # (node-repair scenarios depend on the failure persisting)
            node_utils.set_condition(node, "Ready", "True",
                                     now=self.clock.now())
            changed = True
        if changed:
            node.spec.taints = kept
            self.store.update(node)
        return None
