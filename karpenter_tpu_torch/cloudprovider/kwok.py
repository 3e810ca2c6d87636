"""kwok-style synthetic instance-type catalog.

Catalog mirrors karpenter's kwok/tools/gen_instance_types.go:52-113:
144 instance types (12 cpu sizes x 3 memory factors x 2 OS x 2 arch), each with
8 offerings (4 zones x {spot, on-demand}); price = 0.025/vCPU + 0.001/GiB,
spot = 0.7x. Only the catalog constructors live here; the simulated provider
class stays with the operator, which this package does not carry.
"""

from __future__ import annotations

from typing import List, Optional

from ..api import labels as api_labels
from ..scheduling.requirement import IN, Requirement
from ..scheduling.requirements import Requirements
from ..utils import resources as res
from .types import InstanceType, InstanceTypeOverhead, Offering, Offerings

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
