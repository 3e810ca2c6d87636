"""Recording fake CloudProvider for tests.

Mirrors karpenter's pkg/cloudprovider/fake/cloudprovider.go:45-282 — call
recording, injectable errors, capacity caps, and a synthetic catalog generator
(fake/instancetype.go InstanceTypes(n))."""

from __future__ import annotations

import itertools
from typing import List, Optional

from ..api import labels as api_labels
from ..api.nodeclaim import NodeClaim
from ..scheduling.requirement import IN, Requirement
from ..scheduling.requirements import Requirements, node_selector_requirements
from ..utils import resources as res
from .types import (CloudProvider, InsufficientCapacityError, InstanceType,
                    InstanceTypeOverhead, NodeClaimNotFoundError, Offering, Offerings,
                    RepairPolicy, usable_offerings)

FAKE_ZONES = ["test-zone-1", "test-zone-2", "test-zone-3"]


def fake_instance_types(n: int = 6) -> "list[InstanceType]":
    """Synthetic catalog: doubling cpu/mem sizes across zones and capacity types,
    shaped like fake/instancetype.go InstanceTypes(n)."""
    out = []
    for i in range(n):
        cpu = 2 ** (i % 8)
        mem_gib = cpu * 4
        name = f"fake-it-{i}-{cpu}cpu-{mem_gib}gi"
        price = 0.025 * cpu + 0.001 * mem_gib + i * 1e-5
        offerings = Offerings()
        for zone in FAKE_ZONES:
            for ct in (api_labels.CAPACITY_TYPE_SPOT, api_labels.CAPACITY_TYPE_ON_DEMAND):
                offerings.append(Offering(
                    requirements=Requirements([
                        Requirement(api_labels.CAPACITY_TYPE_LABEL_KEY, IN, [ct]),
                        Requirement(api_labels.LABEL_TOPOLOGY_ZONE, IN, [zone]),
                    ]),
                    price=price * (0.7 if ct == api_labels.CAPACITY_TYPE_SPOT else 1.0),
                ))
        out.append(InstanceType(
            name=name,
            requirements=Requirements([
                Requirement(api_labels.LABEL_INSTANCE_TYPE, IN, [name]),
                Requirement(api_labels.LABEL_ARCH, IN, [api_labels.ARCHITECTURE_AMD64]),
                Requirement(api_labels.LABEL_OS, IN, ["linux"]),
                Requirement(api_labels.LABEL_TOPOLOGY_ZONE, IN, FAKE_ZONES),
                Requirement(api_labels.LABEL_TOPOLOGY_REGION, IN, ["test-region"]),
                Requirement(api_labels.CAPACITY_TYPE_LABEL_KEY, IN,
                            [api_labels.CAPACITY_TYPE_SPOT, api_labels.CAPACITY_TYPE_ON_DEMAND]),
            ]),
            offerings=offerings,
            capacity=res.parse_list({
                res.CPU: str(cpu), res.MEMORY: f"{mem_gib}Gi",
                res.PODS: "110", res.EPHEMERAL_STORAGE: "20Gi"}),
            overhead=InstanceTypeOverhead(),
        ))
    return out


class FakeCloudProvider(CloudProvider):
    def __init__(self, instance_types: Optional[List[InstanceType]] = None):
        self.instance_types = instance_types if instance_types is not None else fake_instance_types()
        self.create_calls: list = []
        self.delete_calls: list = []
        self.next_create_err: Optional[Exception] = None
        self.next_delete_err: Optional[Exception] = None
        self.next_get_err: Optional[Exception] = None
        self.allowed_create_calls: Optional[int] = None
        self.drifted: str = ""
        self._repair_policies: list = []
        self.created: dict = {}
        self._seq = itertools.count(1)
        # seeded fault hook (utils/chaos.FaultInjector): when set, each SPI
        # call below consults it FIRST and raises injected transient or
        # terminal errors at the injector's rate — the fake's analog of the
        # one-shot next_*_err knobs, but schedule-driven for chaos tests
        self.chaos = None
        # capacity-drought schedule (utils/chaos.CapacityDrought): a create
        # whose chosen offering matches a live window raises
        # InsufficientCapacityError carrying the matched pattern
        self.drought = None
        # UnavailableOfferings registry: when wired, create() never targets
        # an offering the registry has cached as dry (the AWS provider
        # filters its CreateFleet launch templates the same way)
        self.unavailable = None

    def _chaos(self, method: str, name: str = "") -> None:
        if self.chaos is not None:
            self.chaos.maybe_raise(f"fake.{method}", name)

    @property
    def name(self) -> str:
        return "fake"

    def reset(self):
        self.__init__(self.instance_types)

    def create(self, nodeclaim: NodeClaim) -> NodeClaim:
        self._chaos("create", nodeclaim.name)
        self.create_calls.append(nodeclaim)
        if self.next_create_err is not None:
            err, self.next_create_err = self.next_create_err, None
            raise err
        if self.allowed_create_calls is not None and len(self.create_calls) > self.allowed_create_calls:
            raise InsufficientCapacityError("exceeded AllowedCreateCalls")
        reqs = node_selector_requirements(nodeclaim.spec.requirements)
        usable: dict = {}
        compatible = []
        for it in self.instance_types:
            if it.requirements.intersects(reqs):
                continue
            if not res.fits(nodeclaim.spec.resources_requests, it.allocatable()):
                continue
            offs = usable_offerings(it, reqs, self.unavailable)
            if offs:
                compatible.append(it)
                usable[it.name] = offs
        if not compatible:
            raise InsufficientCapacityError(f"no instance type satisfied {nodeclaim.name}")
        # cheapest usable offering wins, name tiebreak (order_by_price over
        # the registry-filtered offering sets)
        it = min(compatible,
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
        provider_id = f"fake://instance-{next(self._seq):05d}"
        nodeclaim.status.provider_id = provider_id
        nodeclaim.status.capacity = dict(it.capacity)
        nodeclaim.status.allocatable = dict(it.allocatable())
        nodeclaim.metadata.labels.setdefault(api_labels.LABEL_INSTANCE_TYPE, it.name)
        nodeclaim.metadata.labels.setdefault(api_labels.LABEL_TOPOLOGY_ZONE, offering.zone)
        nodeclaim.metadata.labels.setdefault(api_labels.CAPACITY_TYPE_LABEL_KEY, offering.capacity_type)
        self.created[provider_id] = nodeclaim
        return nodeclaim

    def delete(self, nodeclaim: NodeClaim) -> None:
        self._chaos("delete", nodeclaim.name)
        self.delete_calls.append(nodeclaim)
        if self.next_delete_err is not None:
            err, self.next_delete_err = self.next_delete_err, None
            raise err
        if nodeclaim.status.provider_id not in self.created:
            raise NodeClaimNotFoundError(nodeclaim.status.provider_id or nodeclaim.name)
        del self.created[nodeclaim.status.provider_id]

    def get(self, provider_id: str) -> NodeClaim:
        self._chaos("get", provider_id)
        if self.next_get_err is not None:
            err, self.next_get_err = self.next_get_err, None
            raise err
        if provider_id not in self.created:
            raise NodeClaimNotFoundError(provider_id)
        return self.created[provider_id]

    def list(self) -> "list[NodeClaim]":
        return list(self.created.values())

    def get_instance_types(self, nodepool) -> "list[InstanceType]":
        self._chaos("get_instance_types",
                    getattr(nodepool, "name", "") or "")
        return list(self.instance_types)

    def is_drifted(self, nodeclaim) -> str:
        return self.drifted

    def repair_policies(self) -> "list[RepairPolicy]":
        return list(self._repair_policies)
