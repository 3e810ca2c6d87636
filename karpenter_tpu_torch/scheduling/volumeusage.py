"""Per-node CSI volume attach-limit tracking.

Mirrors karpenter's pkg/scheduling/volumeusage.go: resolve each pod
volume through PVC -> bound PV's CSI driver or StorageClass provisioner
(:83-151), track per-driver unique volume keys per node, and check CSINode
attach limits (:187-220).
"""

from __future__ import annotations

from typing import Dict, Optional, Set

from ..api.objects import Pod
from ..api.storage import (CSINode, PersistentVolume, PersistentVolumeClaim,
                           StorageClass)


class Volumes(dict):
    """driver -> set of volume keys (volumeusage.go Volumes)."""

    def add(self, driver: str, key: str) -> None:
        self.setdefault(driver, set()).add(key)

    def union(self, other: "Volumes") -> "Volumes":
        out = Volumes({d: set(s) for d, s in self.items()})
        for d, s in other.items():
            out.setdefault(d, set()).update(s)
        return out


def get_volumes(store, pod: Pod) -> Volumes:
    """volumeusage.go:83-115: pod -> PVC -> driver resolution; missing PVCs
    are skipped (manually-deleted PVC must not wedge state) EXCEPT ephemeral
    ones, whose claim is derived from the volumeClaimTemplate before the
    ephemeral controller creates it."""
    from ..api.storage import ephemeral_claim_name, resolve_volume
    out = Volumes()
    for ref in pod.spec.volumes:
        pvc, sc_name = resolve_volume(store, pod, ref)
        if pvc is None and not ref.ephemeral:
            continue
        driver = _resolve_driver(store, pvc, sc_name)
        if driver:
            name = pvc.name if pvc is not None else \
                ephemeral_claim_name(pod, ref)
            out.add(driver, f"{pod.namespace}/{name}")
    return out


def _resolve_driver(store, pvc: "Optional[PersistentVolumeClaim]",
                    sc_name: str = "") -> str:
    """volumeusage.go:117-151: bound PV's CSI driver wins, else the
    (resolved) StorageClass provisioner."""
    if pvc is not None and pvc.spec.volume_name:
        pv = store.get(PersistentVolume, pvc.spec.volume_name)
        if pv is not None and pv.spec.csi is not None:
            return pv.spec.csi.driver
    if sc_name:
        sc = store.get(StorageClass, sc_name)
        if sc is not None:
            return sc.provisioner
    return ""


class VolumeUsage:
    """Per-node usage + limit check (volumeusage.go:153-226)."""

    def __init__(self):
        self.volumes = Volumes()

    def add(self, volumes: Volumes) -> None:
        self.volumes = self.volumes.union(volumes)

    def delete_pod_volumes(self, volumes: Volumes) -> None:
        for d, s in volumes.items():
            if d in self.volumes:
                self.volumes[d] -= s

    def exceeds_limits(self, proposed: Volumes,
                       limits: Dict[str, Optional[int]]) -> Optional[str]:
        """volumeusage.go:201-208: would adding `proposed` break a driver's
        attach limit?"""
        merged = self.volumes.union(proposed)
        for driver, keys in merged.items():
            limit = limits.get(driver)
            if limit is not None and len(keys) > limit:
                return (f"would exceed CSI driver {driver} volume limit "
                        f"({len(keys)} > {limit})")
        return None

    def copy(self) -> "VolumeUsage":
        out = VolumeUsage()
        out.volumes = Volumes({d: set(s) for d, s in self.volumes.items()})
        return out


def node_volume_limits(store, node_name: str) -> Dict[str, Optional[int]]:
    """CSINode allocatable counts for a node (volumeusage.go:187-199)."""
    csinode = store.get(CSINode, node_name)
    if csinode is None:
        return {}
    return {d.name: d.allocatable_count for d in csinode.drivers}
