"""Kubernetes JSON wire shapes <-> the framework's dataclasses.

The adapter layer for a REAL apiserver (kube/apiserver.py): Pods and Nodes
in core/v1 shape, NodePools/NodeClaims in the karpenter.sh/v1 shape the
generated CRDs (the JAX package's api/crds.py) describe. Mirrors the
object model the reference reads/writes through controller-runtime
(karpenter's pkg/operator/operator.go:105-206).

Quantities: the framework stores milliunit ints; the wire carries k8s
quantity strings. Durations: seconds floats <-> "300s"/"5m"/"Never".
Timestamps: epoch floats <-> RFC3339.
"""

from __future__ import annotations

import re
from datetime import datetime, timezone
from typing import List, Optional

from ..api import labels as api_labels
from ..api.nodeclaim import (Condition, NodeClaim, NodeClaimSpec,
                             NodeClaimStatus)
from ..api.nodepool import (Budget, Disruption, NodeClaimTemplate,
                            NodeClaimTemplateSpec, NodeClassRef, NodePool,
                            NodePoolSpec)
from ..api.objects import (Affinity, HostPort, LabelSelector, Node,
                           NodeAffinity, NodeSelectorRequirement,
                           NodeSelectorTerm, NodeSpec, NodeStatus, ObjectMeta,
                           OwnerReference, Pod, PodAffinity, PodAffinityTerm,
                           PodSpec, PodStatus, PreferredSchedulingTerm,
                           PVCRef, Taint, Toleration,
                           TopologySpreadConstraint, WeightedPodAffinityTerm)
from ..utils import quantity

GROUP_VERSION = "karpenter.sh/v1"


# -- scalars -----------------------------------------------------------------


def ts_to_k8s(t: Optional[float]) -> Optional[str]:
    if not t:
        return None
    return datetime.fromtimestamp(t, tz=timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ")


def ts_from_k8s(s) -> float:
    if not s:
        return 0.0
    return datetime.strptime(s, "%Y-%m-%dT%H:%M:%SZ").replace(
        tzinfo=timezone.utc).timestamp()


_DUR_RE = re.compile(r"([0-9]+)(h|m|s)")
_DUR_UNITS = {"h": 3600.0, "m": 60.0, "s": 1.0}


def duration_to_k8s(seconds: Optional[float]) -> Optional[str]:
    if seconds is None:
        return "Never"
    s = int(seconds)
    out = ""
    for unit, width in (("h", 3600), ("m", 60), ("s", 1)):
        if s >= width and (unit != "s" or s or not out):
            n, s = divmod(s, width)
            if n or (unit == "s" and not out):
                out += f"{n}{unit}"
    return out or "0s"


def duration_from_k8s(s) -> Optional[float]:
    if s is None or s == "Never":
        return None
    total = 0.0
    for n, unit in _DUR_RE.findall(str(s)):
        total += int(n) * _DUR_UNITS[unit]
    return total


def resources_to_k8s(rl: dict) -> dict:
    return {k: quantity.format_milli(v) for k, v in rl.items()}


def resources_from_k8s(d: Optional[dict]) -> dict:
    return {k: quantity.parse(v) for k, v in (d or {}).items()}


# -- metadata ----------------------------------------------------------------


_OWNER_API_VERSIONS = {
    "DaemonSet": "apps/v1", "Deployment": "apps/v1", "StatefulSet": "apps/v1",
    "ReplicaSet": "apps/v1", "Job": "batch/v1", "CronJob": "batch/v1",
    "Node": "v1", "Pod": "v1",
    "NodeClaim": GROUP_VERSION, "NodePool": GROUP_VERSION,
}


def _owner_api_version(kind: str) -> str:
    return _OWNER_API_VERSIONS.get(kind, "v1")


def meta_to_k8s(m: ObjectMeta, namespaced: bool) -> dict:
    out: dict = {"name": m.name}
    if namespaced:
        out["namespace"] = m.namespace
    if m.uid:
        out["uid"] = m.uid
    if m.labels:
        out["labels"] = dict(m.labels)
    if m.annotations:
        out["annotations"] = dict(m.annotations)
    if m.finalizers:
        out["finalizers"] = list(m.finalizers)
    if m.resource_version:
        out["resourceVersion"] = str(m.resource_version)
    if m.owner_refs:
        out["ownerReferences"] = [
            {"apiVersion": o.api_version or _owner_api_version(o.kind),
             "kind": o.kind, "name": o.name,
             "uid": o.uid, "blockOwnerDeletion": o.block_owner_deletion,
             "controller": o.controller}
            for o in m.owner_refs]
    ct = ts_to_k8s(m.creation_timestamp)
    if ct:
        out["creationTimestamp"] = ct
    return out


def meta_from_k8s(d: dict) -> ObjectMeta:
    rv = d.get("resourceVersion", 0)
    try:
        rv = int(rv)
    except (TypeError, ValueError):
        rv = 0
    return ObjectMeta(
        name=d.get("name", ""), namespace=d.get("namespace", ""),
        uid=d.get("uid", ""), labels=dict(d.get("labels") or {}),
        annotations=dict(d.get("annotations") or {}),
        finalizers=list(d.get("finalizers") or []),
        owner_refs=[OwnerReference(kind=o.get("kind", ""),
                                   name=o.get("name", ""),
                                   uid=o.get("uid", ""),
                                   controller=o.get("controller", False),
                                   block_owner_deletion=o.get(
                                       "blockOwnerDeletion", False),
                                   api_version=o.get("apiVersion", ""))
                    for o in d.get("ownerReferences") or []],
        creation_timestamp=ts_from_k8s(d.get("creationTimestamp")),
        deletion_timestamp=(ts_from_k8s(d["deletionTimestamp"])
                            if d.get("deletionTimestamp") else None),
        resource_version=rv,
        generation=d.get("generation", 0))


# -- shared spec fragments ---------------------------------------------------


def _req_to_k8s(r) -> dict:
    out = {"key": r.key, "operator": r.operator,
           "values": list(r.values)}
    mv = getattr(r, "min_values", None)
    if mv is not None:
        out["minValues"] = mv
    return out


def _req_from_k8s(d: dict):
    from ..provisioning.scheduler import _SelectorReq
    return _SelectorReq(d["key"], d["operator"],
                        tuple(d.get("values") or ()),
                        d.get("minValues"))


def _taint_to_k8s(t: Taint) -> dict:
    out = {"key": t.key, "effect": t.effect}
    if t.value:
        out["value"] = t.value
    return out


def _taint_from_k8s(d: dict) -> Taint:
    return Taint(key=d.get("key", ""), effect=d.get("effect", ""),
                 value=d.get("value", ""))


def _toleration_from_k8s(d: dict) -> Toleration:
    return Toleration(key=d.get("key", ""),
                      operator=d.get("operator", "Equal"),
                      value=d.get("value", ""), effect=d.get("effect", ""))


def _toleration_to_k8s(t: Toleration) -> dict:
    out: dict = {}
    if t.key:
        out["key"] = t.key
    if t.operator:
        out["operator"] = t.operator
    if t.value:
        out["value"] = t.value
    if t.effect:
        out["effect"] = t.effect
    return out


def _selector_to_k8s(sel: Optional[LabelSelector]) -> Optional[dict]:
    if sel is None:
        return None
    out: dict = {}
    if sel.match_labels:
        out["matchLabels"] = dict(sel.match_labels)
    if sel.match_expressions:
        out["matchExpressions"] = [
            {"key": e.key, "operator": e.operator, "values": list(e.values)}
            for e in sel.match_expressions]
    return out


def _selector_from_k8s(d: Optional[dict]) -> Optional[LabelSelector]:
    if d is None:
        return None
    return LabelSelector(
        match_labels=tuple((d.get("matchLabels") or {}).items()),
        match_expressions=tuple(
            NodeSelectorRequirement(e["key"], e["operator"],
                                    tuple(e.get("values") or ()))
            for e in d.get("matchExpressions") or []))


def _nsterm_from_k8s(d: dict) -> NodeSelectorTerm:
    return NodeSelectorTerm(match_expressions=tuple(
        NodeSelectorRequirement(e["key"], e["operator"],
                                tuple(e.get("values") or ()))
        for e in d.get("matchExpressions") or []))


def _nsterm_to_k8s(t: NodeSelectorTerm) -> dict:
    return {"matchExpressions": [
        {"key": e.key, "operator": e.operator, "values": list(e.values)}
        for e in t.match_expressions]}


def _pa_term_from_k8s(d: dict) -> PodAffinityTerm:
    return PodAffinityTerm(topology_key=d.get("topologyKey", ""),
                           label_selector=_selector_from_k8s(
                               d.get("labelSelector")),
                           namespaces=tuple(d.get("namespaces") or ()))


def _pa_term_to_k8s(t: PodAffinityTerm) -> dict:
    out: dict = {"topologyKey": t.topology_key}
    sel = _selector_to_k8s(t.label_selector)
    if sel is not None:
        out["labelSelector"] = sel
    if t.namespaces:
        out["namespaces"] = list(t.namespaces)
    return out


def _affinity_from_k8s(d: Optional[dict]) -> Optional[Affinity]:
    if not d:
        return None
    na = pa = anti = None
    n = d.get("nodeAffinity")
    if n:
        req = n.get("requiredDuringSchedulingIgnoredDuringExecution") or {}
        na = NodeAffinity(
            required_terms=[_nsterm_from_k8s(t)
                            for t in req.get("nodeSelectorTerms") or []],
            preferred=[PreferredSchedulingTerm(
                p.get("weight", 1), _nsterm_from_k8s(p.get("preference", {})))
                for p in n.get(
                    "preferredDuringSchedulingIgnoredDuringExecution") or []])
    for src, name in (("podAffinity", "pa"), ("podAntiAffinity", "anti")):
        a = d.get(src)
        if a:
            val = PodAffinity(
                required=[_pa_term_from_k8s(t) for t in a.get(
                    "requiredDuringSchedulingIgnoredDuringExecution") or []],
                preferred=[WeightedPodAffinityTerm(
                    w.get("weight", 1),
                    _pa_term_from_k8s(w.get("podAffinityTerm", {})))
                    for w in a.get(
                        "preferredDuringSchedulingIgnoredDuringExecution")
                    or []])
            if name == "pa":
                pa = val
            else:
                anti = val
    if na is None and pa is None and anti is None:
        return None
    return Affinity(node_affinity=na, pod_affinity=pa, pod_anti_affinity=anti)


def _affinity_to_k8s(a: Optional[Affinity]) -> Optional[dict]:
    if a is None:
        return None
    out: dict = {}
    if a.node_affinity is not None:
        out["nodeAffinity"] = {
            "requiredDuringSchedulingIgnoredDuringExecution": {
                "nodeSelectorTerms": [
                    _nsterm_to_k8s(t)
                    for t in a.node_affinity.required_terms]},
            "preferredDuringSchedulingIgnoredDuringExecution": [
                {"weight": p.weight, "preference": _nsterm_to_k8s(p.preference)}
                for p in a.node_affinity.preferred]}
    for attr, key in ((a.pod_affinity, "podAffinity"),
                      (a.pod_anti_affinity, "podAntiAffinity")):
        if attr is not None:
            out[key] = {
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    _pa_term_to_k8s(t) for t in attr.required],
                "preferredDuringSchedulingIgnoredDuringExecution": [
                    {"weight": w.weight,
                     "podAffinityTerm": _pa_term_to_k8s(w.term)}
                    for w in attr.preferred]}
    return out or None


# -- Pod ---------------------------------------------------------------------


def pod_to_k8s(p: Pod) -> dict:
    spec: dict = {}
    if p.spec.node_name:
        spec["nodeName"] = p.spec.node_name
    if p.spec.node_selector:
        spec["nodeSelector"] = dict(p.spec.node_selector)
    if p.spec.tolerations:
        spec["tolerations"] = [_toleration_to_k8s(t)
                               for t in p.spec.tolerations]
    aff = _affinity_to_k8s(p.spec.affinity)
    if aff:
        spec["affinity"] = aff
    if p.spec.topology_spread_constraints:
        spec["topologySpreadConstraints"] = [
            {"topologyKey": c.topology_key, "maxSkew": c.max_skew,
             "whenUnsatisfiable": c.when_unsatisfiable,
             **({"labelSelector": _selector_to_k8s(c.label_selector)}
                if c.label_selector is not None else {}),
             **({"minDomains": c.min_domains}
                if c.min_domains is not None else {})}
            for c in p.spec.topology_spread_constraints]
    if p.spec.priority is not None:
        spec["priority"] = p.spec.priority
    containers = []
    ports = [{"hostPort": hp.port, "containerPort": hp.port,
              "protocol": hp.protocol,
              **({"hostIP": hp.host_ip} if hp.host_ip else {})}
             for hp in p.spec.host_ports]
    for i, req in enumerate(p.container_requests or [{}]):
        c = {"name": f"c{i}", "image": "pause",
             "resources": {"requests": resources_to_k8s(req)}}
        if i == 0 and ports:
            c["ports"] = ports
        containers.append(c)
    spec["containers"] = containers
    if p.init_container_requests:
        inits = []
        for i, entry in enumerate(p.init_container_requests):
            req, always = entry if isinstance(entry, tuple) else (entry, False)
            c = {"name": f"i{i}", "image": "pause",
                 "resources": {"requests": resources_to_k8s(req)}}
            if always:  # native sidecar
                c["restartPolicy"] = "Always"
            inits.append(c)
        spec["initContainers"] = inits
    if p.spec.volumes:
        spec["volumes"] = [
            ({"name": f"v{i}", "ephemeral": {
                "volumeClaimTemplate": {"spec": {
                    "storageClassName": v.storage_class_name or None}}}}
             if v.ephemeral else
             {"name": f"v{i}",
              "persistentVolumeClaim": {"claimName": v.claim_name}})
            for i, v in enumerate(p.spec.volumes)]
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": meta_to_k8s(p.metadata, namespaced=True),
            "spec": spec,
            "status": {"phase": p.status.phase}}


def pod_from_k8s(d: dict) -> Pod:
    spec = d.get("spec") or {}
    status = d.get("status") or {}
    containers = spec.get("containers") or []
    host_ports: List[HostPort] = []
    for c in containers:
        for port in c.get("ports") or []:
            if port.get("hostPort"):
                host_ports.append(HostPort(
                    port=port["hostPort"],
                    protocol=port.get("protocol", "TCP"),
                    host_ip=port.get("hostIP", "")))
    volumes: List[PVCRef] = []
    for v in spec.get("volumes") or []:
        if "persistentVolumeClaim" in v:
            volumes.append(PVCRef(
                claim_name=v["persistentVolumeClaim"].get("claimName", "")))
        elif "ephemeral" in v:
            tmpl = (v["ephemeral"].get("volumeClaimTemplate") or {}).get(
                "spec") or {}
            volumes.append(PVCRef(
                claim_name=v.get("name", ""), ephemeral=True,
                storage_class_name=tmpl.get("storageClassName") or ""))
    return Pod(
        metadata=meta_from_k8s(d.get("metadata") or {}),
        spec=PodSpec(
            node_selector=dict(spec.get("nodeSelector") or {}),
            affinity=_affinity_from_k8s(spec.get("affinity")),
            tolerations=[_toleration_from_k8s(t)
                         for t in spec.get("tolerations") or []],
            topology_spread_constraints=[
                TopologySpreadConstraint(
                    topology_key=c.get("topologyKey", ""),
                    max_skew=c.get("maxSkew", 1),
                    when_unsatisfiable=c.get("whenUnsatisfiable",
                                             "DoNotSchedule"),
                    label_selector=_selector_from_k8s(c.get("labelSelector")),
                    min_domains=c.get("minDomains"))
                for c in spec.get("topologySpreadConstraints") or []],
            host_ports=host_ports,
            volumes=volumes,
            priority=spec.get("priority"),
            node_name=spec.get("nodeName", ""),
            termination_grace_period_seconds=spec.get(
                "terminationGracePeriodSeconds")),
        status=PodStatus(phase=status.get("phase", "Pending"),
                         nominated_node_name=status.get(
                             "nominatedNodeName", "")),
        container_requests=[
            resources_from_k8s((c.get("resources") or {}).get("requests"))
            for c in containers],
        init_container_requests=[
            (resources_from_k8s((c.get("resources") or {}).get("requests")),
             True) if c.get("restartPolicy") == "Always" else
            resources_from_k8s((c.get("resources") or {}).get("requests"))
            for c in spec.get("initContainers") or []],
        is_daemonset_pod=any(o.get("kind") == "DaemonSet" for o in
                             (d.get("metadata") or {}).get(
                                 "ownerReferences") or []))


# -- Node --------------------------------------------------------------------


def node_to_k8s(n: Node) -> dict:
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": meta_to_k8s(n.metadata, namespaced=False),
            "spec": {
                **({"providerID": n.spec.provider_id}
                   if n.spec.provider_id else {}),
                **({"taints": [_taint_to_k8s(t) for t in n.spec.taints]}
                   if n.spec.taints else {}),
                **({"unschedulable": True} if getattr(
                    n.spec, "unschedulable", False) else {}),
            },
            "status": {
                "capacity": resources_to_k8s(n.status.capacity),
                "allocatable": resources_to_k8s(n.status.allocatable),
                **({"phase": n.status.phase} if n.status.phase else {}),
                **({"conditions": [
                    {"type": (c.get("type") if isinstance(c, dict)
                              else c.type),
                     "status": (c.get("status") if isinstance(c, dict)
                                else c.status),
                     "lastTransitionTime": ts_to_k8s(
                         c.get("last_transition_time", 0.0)
                         if isinstance(c, dict)
                         else getattr(c, "last_transition_time", 0.0))}
                    for c in n.status.conditions]}
                   if n.status.conditions else {}),
            }}


def node_from_k8s(d: dict) -> Node:
    spec = d.get("spec") or {}
    status = d.get("status") or {}
    return Node(
        metadata=meta_from_k8s(d.get("metadata") or {}),
        spec=NodeSpec(provider_id=spec.get("providerID", ""),
                      taints=[_taint_from_k8s(t)
                              for t in spec.get("taints") or []]),
        status=NodeStatus(
            capacity=resources_from_k8s(status.get("capacity")),
            allocatable=resources_from_k8s(status.get("allocatable")),
            # kubelet conditions feed NotReady budget accounting and the
            # node-repair policies (helpers._node_not_ready, node_health)
            conditions=[
                {"type": c.get("type", ""), "status": c.get("status", ""),
                 "last_transition_time": ts_from_k8s(
                     c.get("lastTransitionTime"))}
                for c in status.get("conditions") or []]))


# -- NodeClaim ---------------------------------------------------------------


def _conditions_to_k8s(conds) -> list:
    out = []
    for c in conds._conds.values():
        out.append({"type": c.type, "status": c.status,
                    "reason": c.reason or c.type, "message": c.message or "",
                    "lastTransitionTime": ts_to_k8s(c.last_transition_time)
                    or ts_to_k8s(0.000001)})
    return out


def _conditions_from_k8s(items, conds) -> None:
    for c in items or []:
        conds._conds[c["type"]] = Condition(
            type=c["type"], status=c.get("status", "Unknown"),
            reason=c.get("reason", ""), message=c.get("message", ""),
            last_transition_time=ts_from_k8s(c.get("lastTransitionTime")))


def nodeclaim_to_k8s(nc: NodeClaim) -> dict:
    spec: dict = {
        "requirements": [_req_to_k8s(r) for r in nc.spec.requirements],
        "nodeClassRef": {"group": nc.spec.node_class_ref.group or "karpenter.kwok.sh",
                         "kind": nc.spec.node_class_ref.kind or "KWOKNodeClass",
                         "name": nc.spec.node_class_ref.name or "default"},
    }
    if nc.spec.resources_requests:
        spec["resources"] = {
            "requests": resources_to_k8s(nc.spec.resources_requests)}
    if nc.spec.taints:
        spec["taints"] = [_taint_to_k8s(t) for t in nc.spec.taints]
    if nc.spec.startup_taints:
        spec["startupTaints"] = [_taint_to_k8s(t)
                                 for t in nc.spec.startup_taints]
    if nc.spec.expire_after is not None:
        spec["expireAfter"] = duration_to_k8s(nc.spec.expire_after)
    if nc.spec.termination_grace_period is not None:
        spec["terminationGracePeriod"] = duration_to_k8s(
            nc.spec.termination_grace_period)
    status: dict = {}
    if nc.status.provider_id:
        status["providerID"] = nc.status.provider_id
    if nc.status.node_name:
        status["nodeName"] = nc.status.node_name
    if nc.status.capacity:
        status["capacity"] = resources_to_k8s(nc.status.capacity)
    if nc.status.allocatable:
        status["allocatable"] = resources_to_k8s(nc.status.allocatable)
    conds = _conditions_to_k8s(nc.conditions)
    if conds:
        status["conditions"] = conds
    return {"apiVersion": GROUP_VERSION, "kind": "NodeClaim",
            "metadata": meta_to_k8s(nc.metadata, namespaced=False),
            "spec": spec, "status": status}


def nodeclaim_from_k8s(d: dict) -> NodeClaim:
    spec = d.get("spec") or {}
    status = d.get("status") or {}
    ncr = spec.get("nodeClassRef") or {}
    nc = NodeClaim(
        metadata=meta_from_k8s(d.get("metadata") or {}),
        spec=NodeClaimSpec(
            requirements=[_req_from_k8s(r)
                          for r in spec.get("requirements") or []],
            resources_requests=resources_from_k8s(
                (spec.get("resources") or {}).get("requests")),
            taints=[_taint_from_k8s(t) for t in spec.get("taints") or []],
            startup_taints=[_taint_from_k8s(t)
                            for t in spec.get("startupTaints") or []],
            node_class_ref=NodeClassRef(group=ncr.get("group", ""),
                                        kind=ncr.get("kind", ""),
                                        name=ncr.get("name", "")),
            expire_after=duration_from_k8s(spec.get("expireAfter")),
            termination_grace_period=duration_from_k8s(
                spec.get("terminationGracePeriod"))))
    nc.status.provider_id = status.get("providerID", "")
    nc.status.node_name = status.get("nodeName", "")
    nc.status.capacity = resources_from_k8s(status.get("capacity"))
    nc.status.allocatable = resources_from_k8s(status.get("allocatable"))
    _conditions_from_k8s(status.get("conditions"), nc.conditions)
    return nc


# -- NodePool ----------------------------------------------------------------


def nodepool_to_k8s(np: NodePool) -> dict:
    t = np.spec.template
    tmpl_spec: dict = {
        "requirements": [_req_to_k8s(r) for r in t.spec.requirements],
        "nodeClassRef": {"group": "karpenter.kwok.sh",
                         "kind": "KWOKNodeClass", "name": "default"},
    }
    if t.spec.taints:
        tmpl_spec["taints"] = [_taint_to_k8s(x) for x in t.spec.taints]
    if t.spec.startup_taints:
        tmpl_spec["startupTaints"] = [_taint_to_k8s(x)
                                      for x in t.spec.startup_taints]
    if t.spec.expire_after is not None:
        tmpl_spec["expireAfter"] = duration_to_k8s(t.spec.expire_after)
    disruption = {
        "consolidateAfter": duration_to_k8s(
            np.spec.disruption.consolidate_after),
        "consolidationPolicy": np.spec.disruption.consolidation_policy,
        "budgets": [
            {"nodes": str(b.nodes),
             **({"schedule": b.schedule} if b.schedule else {}),
             **({"duration": duration_to_k8s(b.duration)}
                if b.duration is not None else {})}
            for b in np.spec.disruption.budgets],
    }
    spec: dict = {
        "template": {
            "metadata": {
                **({"labels": dict(t.metadata_labels)}
                   if t.metadata_labels else {}),
                **({"annotations": dict(t.metadata_annotations)}
                   if t.metadata_annotations else {}),
            },
            "spec": tmpl_spec,
        },
        "disruption": disruption,
    }
    if np.spec.limits:
        spec["limits"] = resources_to_k8s(np.spec.limits)
    if np.spec.weight is not None:
        spec["weight"] = np.spec.weight
    status: dict = {}
    if np.status.resources:
        status["resources"] = resources_to_k8s(np.status.resources)
    if np.status.conditions:
        status["conditions"] = [
            {"type": c.get("type", ""), "status": c.get("status", "Unknown"),
             "reason": c.get("reason") or c.get("type", ""),
             "message": c.get("message", ""),
             "lastTransitionTime":
                 ts_to_k8s(c.get("last_transition_time"))
                 or ts_to_k8s(0.000001)}
            for c in np.status.conditions]
    return {"apiVersion": GROUP_VERSION, "kind": "NodePool",
            "metadata": meta_to_k8s(np.metadata, namespaced=False),
            "spec": spec, "status": status}


def nodepool_from_k8s(d: dict) -> NodePool:
    from ..api.nodepool import NodePoolStatus
    spec = d.get("spec") or {}
    tmpl = spec.get("template") or {}
    tmeta = tmpl.get("metadata") or {}
    tspec = tmpl.get("spec") or {}
    dis = spec.get("disruption") or {}
    status = d.get("status") or {}
    np_status = NodePoolStatus(
        resources=resources_from_k8s(status.get("resources")),
        conditions=[
            {"type": c.get("type", ""), "status": c.get("status", "Unknown"),
             "reason": c.get("reason", ""), "message": c.get("message", ""),
             "last_transition_time": ts_from_k8s(
                 c.get("lastTransitionTime"))}
            for c in status.get("conditions") or []])
    return NodePool(
        status=np_status,
        metadata=meta_from_k8s(d.get("metadata") or {}),
        spec=NodePoolSpec(
            template=NodeClaimTemplate(
                metadata_labels=dict(tmeta.get("labels") or {}),
                metadata_annotations=dict(tmeta.get("annotations") or {}),
                spec=NodeClaimTemplateSpec(
                    requirements=[_req_from_k8s(r)
                                  for r in tspec.get("requirements") or []],
                    taints=[_taint_from_k8s(t)
                            for t in tspec.get("taints") or []],
                    startup_taints=[_taint_from_k8s(t)
                                    for t in tspec.get("startupTaints")
                                    or []],
                    expire_after=duration_from_k8s(
                        tspec.get("expireAfter")))),
            disruption=Disruption(
                consolidate_after=duration_from_k8s(
                    dis.get("consolidateAfter", "0s")),
                consolidation_policy=dis.get(
                    "consolidationPolicy", "WhenEmptyOrUnderutilized"),
                budgets=[Budget(nodes=b.get("nodes", "10%"),
                                schedule=b.get("schedule"),
                                duration=duration_from_k8s(b["duration"])
                                if b.get("duration") else None)
                         for b in dis.get("budgets") or []] or
                [Budget(nodes="10%")]),
            limits=resources_from_k8s(spec.get("limits")),
            weight=spec.get("weight")))


# -- storage + policy kinds --------------------------------------------------
# The solver reads these (volume topology, CSI limits, PDB gating); the
# operator never writes them, but the codec round-trips both directions so
# tests and the kwok harness can seed them through the same adapter.

def pvc_to_k8s(pvc) -> dict:
    # accessModes/resources aren't modeled (the solver doesn't read them)
    # but a real apiserver requires both — emit serviceable defaults
    spec: dict = {"accessModes": ["ReadWriteOnce"],
                  "resources": {"requests": {"storage": "1Gi"}}}
    if pvc.spec.storage_class_name is not None:
        spec["storageClassName"] = pvc.spec.storage_class_name
    if pvc.spec.volume_name:
        spec["volumeName"] = pvc.spec.volume_name
    return {"apiVersion": "v1", "kind": "PersistentVolumeClaim",
            "metadata": meta_to_k8s(pvc.metadata, True), "spec": spec}


def pvc_from_k8s(d: dict):
    from ..api.storage import PersistentVolumeClaim, PVCSpec
    spec = d.get("spec") or {}
    return PersistentVolumeClaim(
        metadata=meta_from_k8s(d.get("metadata") or {}),
        spec=PVCSpec(storage_class_name=spec.get("storageClassName"),
                     volume_name=spec.get("volumeName", "")))


def pv_to_k8s(pv) -> dict:
    spec: dict = {"capacity": {"storage": "1Gi"},
                  "accessModes": ["ReadWriteOnce"]}
    if pv.spec.storage_class_name:
        spec["storageClassName"] = pv.spec.storage_class_name
    if pv.spec.csi is not None:
        spec["csi"] = {"driver": pv.spec.csi.driver,
                       "volumeHandle": pv.metadata.name}
    elif pv.spec.local:
        spec["local"] = {"path": f"/mnt/{pv.metadata.name}"}
        if not pv.spec.node_affinity_terms:
            # the apiserver REQUIRES nodeAffinity on local PVs; a hostname
            # pin is the canonical shape (and the scheduler drops hostname
            # affinity for local PVs anyway, so decode behavior is unchanged)
            spec["nodeAffinity"] = {"required": {"nodeSelectorTerms": [
                {"matchExpressions": [
                    {"key": "kubernetes.io/hostname", "operator": "In",
                     "values": [f"{pv.metadata.name}-host"]}]}]}}
    elif pv.spec.host_path:
        spec["hostPath"] = {"path": f"/tmp/{pv.metadata.name}"}
    else:
        # a PV must carry SOME volume source or the apiserver 422s; non-CSI
        # non-local fixtures ride as NFS placeholders (hostPath would imply
        # ignore-hostname-affinity semantics on decode)
        spec["nfs"] = {"server": "placeholder.invalid",
                       "path": f"/{pv.metadata.name}"}
    if pv.spec.node_affinity_terms:
        spec["nodeAffinity"] = {"required": {"nodeSelectorTerms": [
            _nsterm_to_k8s(t) for t in pv.spec.node_affinity_terms]}}
    return {"apiVersion": "v1", "kind": "PersistentVolume",
            "metadata": meta_to_k8s(pv.metadata, False), "spec": spec}


def pv_from_k8s(d: dict):
    from ..api.storage import (CSIVolumeSource, PersistentVolume,
                               PersistentVolumeSpec)
    spec = d.get("spec") or {}
    csi = spec.get("csi")
    terms = (((spec.get("nodeAffinity") or {}).get("required") or {})
             .get("nodeSelectorTerms") or [])
    return PersistentVolume(
        metadata=meta_from_k8s(d.get("metadata") or {}),
        spec=PersistentVolumeSpec(
            csi=CSIVolumeSource(driver=csi.get("driver", "")) if csi else None,
            node_affinity_terms=[_nsterm_from_k8s(t) for t in terms],
            storage_class_name=spec.get("storageClassName", ""),
            local="local" in spec,
            host_path="hostPath" in spec))


def storageclass_to_k8s(sc) -> dict:
    out = {"apiVersion": "storage.k8s.io/v1", "kind": "StorageClass",
           "metadata": meta_to_k8s(sc.metadata, False),
           "provisioner": sc.provisioner}
    if sc.allowed_topologies:
        out["allowedTopologies"] = [
            {"matchLabelExpressions": [{"key": t.key,
                                        "values": list(t.values)}]}
            for t in sc.allowed_topologies]
    return out


def storageclass_from_k8s(d: dict):
    from ..api.storage import StorageClass, TopologySelector
    topos = []
    for sel in d.get("allowedTopologies") or []:
        for e in sel.get("matchLabelExpressions") or []:
            topos.append(TopologySelector(key=e.get("key", ""),
                                          values=list(e.get("values") or [])))
    return StorageClass(metadata=meta_from_k8s(d.get("metadata") or {}),
                        provisioner=d.get("provisioner", ""),
                        allowed_topologies=topos)


def csinode_to_k8s(cn) -> dict:
    return {"apiVersion": "storage.k8s.io/v1", "kind": "CSINode",
            "metadata": meta_to_k8s(cn.metadata, False),
            "spec": {"drivers": [
                {"name": dr.name, "nodeID": cn.metadata.name,
                 **({"allocatable": {"count": dr.allocatable_count}}
                    if dr.allocatable_count is not None else {})}
                for dr in cn.drivers]}}


def csinode_from_k8s(d: dict):
    from ..api.storage import CSINode, CSINodeDriver
    drivers = []
    for dr in ((d.get("spec") or {}).get("drivers")) or []:
        alloc = dr.get("allocatable") or {}
        drivers.append(CSINodeDriver(name=dr.get("name", ""),
                                     allocatable_count=alloc.get("count")))
    return CSINode(metadata=meta_from_k8s(d.get("metadata") or {}),
                   drivers=drivers)


def volumeattachment_to_k8s(va) -> dict:
    return {"apiVersion": "storage.k8s.io/v1", "kind": "VolumeAttachment",
            "metadata": meta_to_k8s(va.metadata, False),
            "spec": {"nodeName": va.spec.node_name,
                     "source": {"persistentVolumeName":
                                va.spec.persistent_volume_name},
                     "attacher": "csi.unknown"}}


def volumeattachment_from_k8s(d: dict):
    from ..api.storage import VolumeAttachment, VolumeAttachmentSpec
    spec = d.get("spec") or {}
    return VolumeAttachment(
        metadata=meta_from_k8s(d.get("metadata") or {}),
        spec=VolumeAttachmentSpec(
            node_name=spec.get("nodeName", ""),
            persistent_volume_name=(spec.get("source")
                                    or {}).get("persistentVolumeName")))


def pdb_to_k8s(pdb) -> dict:
    spec: dict = {}
    if pdb.spec.selector is not None:
        spec["selector"] = _selector_to_k8s(pdb.spec.selector)
    for attr, key in (("min_available", "minAvailable"),
                      ("max_unavailable", "maxUnavailable")):
        v = getattr(pdb.spec, attr)
        if v is not None:
            # int-ish strings ride as ints, percents as strings
            spec[key] = int(v) if str(v).lstrip("-").isdigit() else v
    return {"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
            "metadata": meta_to_k8s(pdb.metadata, True), "spec": spec}


def pdb_from_k8s(d: dict):
    from ..api.policy import PDBSpec, PDBStatus, PodDisruptionBudget
    spec = d.get("spec") or {}
    status = d.get("status") or {}

    def intstr(v):
        return None if v is None else str(v)

    return PodDisruptionBudget(
        metadata=meta_from_k8s(d.get("metadata") or {}),
        spec=PDBSpec(selector=_selector_from_k8s(spec.get("selector")),
                     min_available=intstr(spec.get("minAvailable")),
                     max_unavailable=intstr(spec.get("maxUnavailable"))),
        status=PDBStatus(
            disruptions_allowed=status.get("disruptionsAllowed", 0),
            current_healthy=status.get("currentHealthy", 0),
            desired_healthy=status.get("desiredHealthy", 0),
            expected_pods=status.get("expectedPods", 0)))


# -- registry ----------------------------------------------------------------

from ..api.policy import PodDisruptionBudget  # noqa: E402
from ..api.storage import (CSINode, PersistentVolume,  # noqa: E402
                           PersistentVolumeClaim, StorageClass,
                           VolumeAttachment)

# kind -> (api prefix, plural, namespaced, encoder, decoder)
ROUTES = {
    Pod: ("api/v1", "pods", True, pod_to_k8s, pod_from_k8s),
    Node: ("api/v1", "nodes", False, node_to_k8s, node_from_k8s),
    NodeClaim: (f"apis/{GROUP_VERSION}", "nodeclaims", False,
                nodeclaim_to_k8s, nodeclaim_from_k8s),
    NodePool: (f"apis/{GROUP_VERSION}", "nodepools", False,
               nodepool_to_k8s, nodepool_from_k8s),
    PersistentVolumeClaim: ("api/v1", "persistentvolumeclaims", True,
                            pvc_to_k8s, pvc_from_k8s),
    PersistentVolume: ("api/v1", "persistentvolumes", False,
                       pv_to_k8s, pv_from_k8s),
    StorageClass: ("apis/storage.k8s.io/v1", "storageclasses", False,
                   storageclass_to_k8s, storageclass_from_k8s),
    CSINode: ("apis/storage.k8s.io/v1", "csinodes", False,
              csinode_to_k8s, csinode_from_k8s),
    VolumeAttachment: ("apis/storage.k8s.io/v1", "volumeattachments",
                       False, volumeattachment_to_k8s,
                       volumeattachment_from_k8s),
    PodDisruptionBudget: ("apis/policy/v1", "poddisruptionbudgets", True,
                          pdb_to_k8s, pdb_from_k8s),
}

# kinds the operator watches (the rest are read on demand)
WATCH_KINDS = (Pod, Node, NodeClaim, NodePool, PodDisruptionBudget)
