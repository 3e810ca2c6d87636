"""Volume topology injection: PV/StorageClass zone constraints become pod
node-affinity before the solve.

Mirrors karpenter's pkg/controllers/provisioning/scheduling/
volumetopology.go: for each pod volume, a bound PV's node-affinity terms or
an unbound PVC's StorageClass allowedTopologies are ANDed into the pod's
required node affinity (:42-78); ValidatePersistentVolumeClaims rejects pods
referencing missing PVCs/StorageClasses (:152-199).
"""

from __future__ import annotations

import copy
from typing import List, Optional

from ..api.objects import (Affinity, NodeAffinity, NodeSelectorRequirement,
                           NodeSelectorTerm, Pod)
from ..api.storage import (PersistentVolume, PersistentVolumeClaim,
                           StorageClass)


def _volume_requirements(store, pod: Pod) -> List[NodeSelectorRequirement]:
    from ..api.storage import resolve_volume
    reqs: List[NodeSelectorRequirement] = []
    for ref in pod.spec.volumes:
        pvc, sc_name = resolve_volume(store, pod, ref)
        if pvc is None and not ref.ephemeral:
            continue
        if pvc is not None and pvc.spec.volume_name:
            pv = store.get(PersistentVolume, pvc.spec.volume_name)
            if pv is not None and pv.spec.node_affinity_terms:
                # terms are ORed — only the first is used
                # (volumetopology.go:136-138)
                exprs = list(pv.spec.node_affinity_terms[0].match_expressions)
                if pv.spec.local or pv.spec.host_path:
                    # a local/hostPath volume dies with its node: keeping its
                    # hostname pin would make the pod unschedulable anywhere
                    # else (volumetopology.go:139-144)
                    from ..api import labels as api_labels
                    exprs = [r for r in exprs
                             if r.key != api_labels.LABEL_HOSTNAME]
                reqs.extend(exprs)
        elif sc_name:
            sc = store.get(StorageClass, sc_name)
            if sc is not None:
                for topo in sc.allowed_topologies:
                    reqs.append(NodeSelectorRequirement(
                        topo.key, "In", tuple(topo.values)))
    return reqs


def inject_volume_topology_requirements(store, pod: Pod) -> Pod:
    """volumetopology.go:42-78: AND the volume requirements into every
    required node-affinity term (returns a copy; the stored pod is not
    mutated)."""
    reqs = _volume_requirements(store, pod)
    if not reqs:
        return pod
    pod = copy.deepcopy(pod)
    aff = pod.spec.affinity
    if aff is None:
        aff = Affinity()
        pod.spec.affinity = aff
    if aff.node_affinity is None:
        aff.node_affinity = NodeAffinity()
    na = aff.node_affinity
    if not na.required_terms:
        na.required_terms = [NodeSelectorTerm()]
    na.required_terms = [
        NodeSelectorTerm(match_expressions=tuple(term.match_expressions)
                         + tuple(reqs))
        for term in na.required_terms]
    return pod


def validate_persistent_volume_claims(store, pod: Pod) -> Optional[str]:
    """volumetopology.go:152-199: a pod referencing a missing PVC or a PVC
    with a missing StorageClass can't schedule. Ephemeral volumes validate
    against their template's (or the default) class instead of an existing
    claim — the ephemeral controller creates the claim after scheduling."""
    from ..api.storage import resolve_volume
    for ref in pod.spec.volumes:
        pvc, sc_name = resolve_volume(store, pod, ref)
        if pvc is None:
            if not ref.ephemeral:
                return f'pvc "{pod.namespace}/{ref.claim_name}" not found'
            if sc_name and store.get(StorageClass, sc_name) is None:
                return f'storageclass "{sc_name}" not found'
            continue
        if pvc.spec.volume_name:
            if store.get(PersistentVolume, pvc.spec.volume_name) is None:
                return f'volume "{pvc.spec.volume_name}" not found'
            continue
        if sc_name and store.get(StorageClass, sc_name) is None:
            return f'storageclass "{sc_name}" not found'
    return None
