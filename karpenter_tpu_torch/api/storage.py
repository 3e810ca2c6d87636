"""Storage objects: the PVC/PV/StorageClass/CSINode fields the volume
tracking consumes (karpenter's pkg/scheduling/volumeusage.go and
provisioning/scheduling/volumetopology.go)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .objects import NodeSelectorTerm, ObjectMeta


@dataclass
class CSIVolumeSource:
    driver: str = ""


@dataclass
class PersistentVolumeSpec:
    csi: Optional[CSIVolumeSource] = None
    # PV node affinity restricting where the volume attaches (zonal PVs)
    node_affinity_terms: List[NodeSelectorTerm] = field(default_factory=list)
    storage_class_name: str = ""
    # volume source kind: local/hostPath volumes die with their node, so
    # their hostname affinity is ignored when (re)scheduling
    # (volumetopology.go:139-144)
    local: bool = False
    host_path: bool = False


@dataclass
class PersistentVolume:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeSpec = field(default_factory=PersistentVolumeSpec)

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class PVCSpec:
    storage_class_name: Optional[str] = None
    volume_name: str = ""  # bound PV name ("" == unbound)


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PVCSpec = field(default_factory=PVCSpec)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace


# storageclass.kubernetes.io/is-default-class (suite_test.go:2981-3282)
DEFAULT_SC_ANNOTATION = "storageclass.kubernetes.io/is-default-class"


def default_storage_class(store) -> "Optional[StorageClass]":
    """The cluster's default StorageClass; with several annotated, the
    NEWEST wins (suite_test.go:3076-3180)."""
    cands = [sc for sc in store.list(StorageClass)
             if sc.metadata.annotations.get(DEFAULT_SC_ANNOTATION) == "true"]
    if not cands:
        return None
    return max(cands, key=lambda sc: sc.metadata.creation_timestamp or 0)


def ephemeral_claim_name(pod, ref) -> str:
    """Generic-ephemeral-volume claim naming: '<pod-name>-<volume-name>'."""
    return f"{pod.name}-{ref.claim_name}"


def resolve_volume(store, pod, ref):
    """-> (pvc_or_None, storage_class_name). Honors ephemeral naming
    (ephemeral_claim_name), the ephemeral template's class, and
    default-class fallback when no class is named anywhere."""
    ephemeral = getattr(ref, "ephemeral", False)
    name = ephemeral_claim_name(pod, ref) if ephemeral else ref.claim_name
    pvc = store.get(PersistentVolumeClaim, name, pod.namespace)
    if pvc is None and not ephemeral:
        # callers treat a missing non-ephemeral claim as skip/error; don't
        # pay the default-class scan for a result they discard
        return None, ""
    sc_name = ""
    if pvc is not None:
        sc_name = pvc.spec.storage_class_name or ""
    else:
        sc_name = ref.storage_class_name or ""
    if not sc_name and (pvc is None or not pvc.spec.volume_name):
        sc = default_storage_class(store)
        sc_name = sc.metadata.name if sc is not None else ""
    return pvc, sc_name


@dataclass
class TopologySelector:
    """StorageClass.allowedTopologies entry: key -> allowed values."""
    key: str = ""
    values: List[str] = field(default_factory=list)


@dataclass
class StorageClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    provisioner: str = ""
    allowed_topologies: List[TopologySelector] = field(default_factory=list)

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class VolumeAttachmentSpec:
    node_name: str = ""
    # VolumeAttachment.spec.source.persistentVolumeName
    persistent_volume_name: Optional[str] = None


@dataclass
class VolumeAttachment:
    """storagev1.VolumeAttachment — node termination waits for these to be
    cleaned up before deleting the instance
    (node/termination/controller.go:141-150,190-240)."""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: VolumeAttachmentSpec = field(default_factory=VolumeAttachmentSpec)

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class CSINodeDriver:
    name: str = ""
    allocatable_count: Optional[int] = None  # attach limit


@dataclass
class CSINode:
    """Attach limits per driver on one node (volumeusage.go:187-220)."""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    drivers: List[CSINodeDriver] = field(default_factory=list)

    @property
    def name(self) -> str:
        return self.metadata.name
