"""Well-known labels, annotations, taint keys and label normalization.

Mirrors karpenter's pkg/apis/v1/labels.go:39-105 and taints.go:27-41.
"""

from __future__ import annotations

GROUP = "karpenter.sh"

# Kubernetes upstream label keys
LABEL_HOSTNAME = "kubernetes.io/hostname"
LABEL_TOPOLOGY_ZONE = "topology.kubernetes.io/zone"
LABEL_TOPOLOGY_REGION = "topology.kubernetes.io/region"
LABEL_INSTANCE_TYPE = "node.kubernetes.io/instance-type"
LABEL_ARCH = "kubernetes.io/arch"
LABEL_OS = "kubernetes.io/os"
LABEL_WINDOWS_BUILD = "node.kubernetes.io/windows-build"

# Architecture / capacity-type values
ARCHITECTURE_AMD64 = "amd64"
ARCHITECTURE_ARM64 = "arm64"
CAPACITY_TYPE_SPOT = "spot"
CAPACITY_TYPE_ON_DEMAND = "on-demand"
CAPACITY_TYPE_RESERVED = "reserved"

# Karpenter-specific labels
NODEPOOL_LABEL_KEY = f"{GROUP}/nodepool"
NODE_INITIALIZED_LABEL_KEY = f"{GROUP}/initialized"
NODE_REGISTERED_LABEL_KEY = f"{GROUP}/registered"
CAPACITY_TYPE_LABEL_KEY = f"{GROUP}/capacity-type"

# Annotations
DO_NOT_DISRUPT_ANNOTATION_KEY = f"{GROUP}/do-not-disrupt"
NODEPOOL_HASH_ANNOTATION_KEY = f"{GROUP}/nodepool-hash"
NODEPOOL_HASH_VERSION_ANNOTATION_KEY = f"{GROUP}/nodepool-hash-version"
NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION_KEY = f"{GROUP}/nodeclaim-termination-timestamp"
NODECLAIM_MIN_VALUES_RELAXED_ANNOTATION_KEY = f"{GROUP}/nodeclaim-min-values-relaxed"

# Finalizers
TERMINATION_FINALIZER = f"{GROUP}/termination"

# Taint keys
DISRUPTED_TAINT_KEY = f"{GROUP}/disrupted"
UNREGISTERED_TAINT_KEY = f"{GROUP}/unregistered"

RESTRICTED_LABEL_DOMAINS = frozenset({"kubernetes.io", "k8s.io", GROUP})

LABEL_DOMAIN_EXCEPTIONS = frozenset({
    "kops.k8s.io",
    "node.kubernetes.io",
    "node-restriction.kubernetes.io",
})

WELL_KNOWN_LABELS = frozenset({
    NODEPOOL_LABEL_KEY,
    LABEL_TOPOLOGY_ZONE,
    LABEL_TOPOLOGY_REGION,
    LABEL_INSTANCE_TYPE,
    LABEL_ARCH,
    LABEL_OS,
    CAPACITY_TYPE_LABEL_KEY,
    LABEL_WINDOWS_BUILD,
})

RESTRICTED_LABELS = frozenset({LABEL_HOSTNAME})

# Aliased label keys translated to the canonical well-known key on requirement
# construction (labels.go:96-104, applied in requirement.go:45-47).
NORMALIZED_LABELS = {
    "failure-domain.beta.kubernetes.io/zone": LABEL_TOPOLOGY_ZONE,
    "beta.kubernetes.io/arch": LABEL_ARCH,
    "beta.kubernetes.io/os": LABEL_OS,
    "beta.kubernetes.io/instance-type": LABEL_INSTANCE_TYPE,
    "failure-domain.beta.kubernetes.io/region": LABEL_TOPOLOGY_REGION,
}


def _domain(key: str) -> str:
    return key.split("/", 1)[0] if "/" in key else ""


def is_restricted_node_label(key: str) -> bool:
    """True if Karpenter must not inject this label onto nodes (labels.go:119-128)."""
    if key in WELL_KNOWN_LABELS:
        return False
    dom = _domain(key)
    in_restricted = any(dom == d or dom.endswith("." + d) for d in RESTRICTED_LABEL_DOMAINS)
    in_exception = any(dom == d or dom.endswith("." + d) for d in LABEL_DOMAIN_EXCEPTIONS)
    return (in_restricted and not in_exception) or key in RESTRICTED_LABELS


def is_restricted_label(key: str) -> "str | None":
    """Returns an error string if the label may not be used in requirements."""
    if key in WELL_KNOWN_LABELS:
        return None
    if is_restricted_node_label(key):
        return f"label {key} is restricted; use a well-known label or an unrestricted custom domain"
    return None
