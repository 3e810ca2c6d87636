"""ResourceList arithmetic over exact integer milliunits.

A ResourceList here is a plain ``dict[str, int]`` mapping resource name ("cpu",
"memory", "pods", ...) to integer milliunits (see utils/quantity.py).

Mirrors the semantics of the reference helpers in
karpenter's pkg/utils/resources/resources.go (Merge, Subtract, Fits:217-231,
MaxResources, RequestsForPods) without the apimachinery Quantity machinery.
"""

from __future__ import annotations

from typing import Iterable, Mapping

from . import quantity

ResourceList = dict

CPU = "cpu"
MEMORY = "memory"
PODS = "pods"
EPHEMERAL_STORAGE = "ephemeral-storage"


def parse_list(spec: Mapping[str, "int | float | str"]) -> ResourceList:
    return {k: quantity.parse(v) for k, v in spec.items()}


def add(*lists: Mapping[str, int]) -> ResourceList:
    out: ResourceList = {}
    for rl in lists:
        for k, v in rl.items():
            out[k] = out.get(k, 0) + v
    return out


def merge(*lists: Mapping[str, int]) -> ResourceList:
    """Alias used where the reference calls resources.Merge (summing requests)."""
    return add(*lists)


def subtract(a: Mapping[str, int], b: Mapping[str, int]) -> ResourceList:
    """a - b over the union of keys (missing treated as zero). May go negative,
    matching the reference's Subtract which lets callers observe deficits."""
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) - v
    return out


def max_resources(lists: Iterable[Mapping[str, int]]) -> ResourceList:
    """Element-wise max — reference resources.MaxResources, used by subtractMax
    pessimism in scheduler.go:388-405."""
    out: ResourceList = {}
    for rl in lists:
        for k, v in rl.items():
            if v > out.get(k, 0):
                out[k] = v
    return out


def fits(requests: Mapping[str, int], available: Mapping[str, int]) -> bool:
    """True if every requested resource fits in available (missing available == 0,
    but zero-valued requests always fit). Reference resources.Fits:217-231."""
    for k, v in requests.items():
        if v <= 0:
            continue
        if v > available.get(k, 0):
            return False
    return True


def any_positive(rl: Mapping[str, int]) -> bool:
    return any(v > 0 for v in rl.values())


def exceeds(usage: Mapping[str, int], limits: Mapping[str, int]) -> "list[str]":
    """Resource names whose usage strictly exceeds the limit (only keys present in
    limits are checked) — reference Limits.ExceededBy (apis/v1/nodepool.go:140-154)."""
    return [k for k, lim in limits.items() if usage.get(k, 0) > lim]


def init_entry(entry) -> "tuple[ResourceList, bool]":
    """Normalize a pod.init_container_requests entry to
    (requests, restart_always)."""
    if isinstance(entry, tuple):
        return entry
    return entry, False


def pod_requests(pod) -> ResourceList:
    """Total requests for a pod (reference resources.podRequests:95-125):
    sum of containers plus native sidecars (init containers with
    restartPolicy=Always), element-wise maxed against each regular init
    container combined with the sidecars declared BEFORE it (sidecars are
    already running while later init containers execute — order matters),
    plus one 'pods' slot.

    Entries in pod.init_container_requests are either a plain ResourceList
    (regular init container) or a (ResourceList, restart_always) tuple."""
    requests = add(*(c for c in pod.container_requests)) if pod.container_requests else {}
    restartable: ResourceList = {}
    max_init: ResourceList = {}
    for entry in pod.init_container_requests:
        req, always = init_entry(entry)
        if always:
            requests = add(requests, req)
            restartable = add(restartable, req)
            max_init = max_resources([max_init, restartable])
        else:
            max_init = max_resources([max_init, add(req, restartable)])
    out = max_resources([requests, max_init])
    out[PODS] = out.get(PODS, 0) + 1000  # one pod slot, in milliunits
    return out
