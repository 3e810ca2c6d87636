"""The program's API objects for the tenant cell, built from the plain
records of ``tenant_spec.py``: weighted NodePools with template labels,
taints and capacity-type requirements, pending pods with their tenancy
(nodeSelector and tolerations), and running nodes with their pool's labels
and taints. With ``objects.py`` and the drivers, the only modules of the
benchmark that import the program."""

from __future__ import annotations

from . import objects


def nodepools(pools: list) -> list:
    """NodePool objects of the records, in the records' order."""
    from karpenter_tpu_torch.api import labels as L
    from karpenter_tpu_torch.api import nodepool as np_
    from karpenter_tpu_torch.api.objects import (NodeSelectorRequirement,
                                                 ObjectMeta, Taint)
    out = []
    for p in pools:
        reqs = []
        if p["capacity_types"]:
            reqs.append(NodeSelectorRequirement(
                key=L.CAPACITY_TYPE_LABEL_KEY, operator="In",
                values=tuple(p["capacity_types"])))
        out.append(np_.NodePool(
            metadata=ObjectMeta(name=p["name"], uid=f"nodepool-{p['name']}"),
            spec=np_.NodePoolSpec(
                template=np_.NodeClaimTemplate(
                    metadata_labels=dict(p["labels"]),
                    spec=np_.NodeClaimTemplateSpec(
                        requirements=reqs,
                        taints=[Taint(key=k, value=v, effect=e)
                                for k, v, e in p["taints"]])),
                weight=p["weight"] or None)))
    return out


def pods(burst: dict, tolerate_all: bool = False) -> list:
    """The burst's pending pods in the order they arrive, each with its
    kind's spreads and affinities, its deployment's nodeSelector and
    tolerations. With ``tolerate_all`` every pod also tolerates every
    taint (an ``Exists`` toleration with no key): the control's broken
    guarantee."""
    from karpenter_tpu_torch.api import objects as o
    specs = []
    for dep in burst["deployments"]:
        spread, affinity = objects._pod_spec(dep)
        tolerations = [o.Toleration(key=k, operator="Equal", value=v,
                                    effect=e)
                       for k, v, e in dep["tolerations"]]
        if tolerate_all:
            tolerations.append(o.Toleration(operator="Exists"))
        specs.append((spread, affinity, tolerations,
                      {"cpu": dep["cpu"], "memory": dep["memory"]}))
    out = []
    for name in burst["pods"]:
        d = burst["pod_deployment"][name]
        dep = burst["deployments"][d]
        spread, affinity, tolerations, requests = specs[d]
        out.append(o.Pod(
            metadata=o.ObjectMeta(name=name, namespace="default",
                                  uid=f"uid-{name}",
                                  labels={"app": dep["app"]}),
            spec=o.PodSpec(node_selector=dict(dep["selector"]),
                           tolerations=list(tolerations),
                           topology_spread_constraints=list(spread),
                           affinity=affinity),
            container_requests=[dict(requests)]))
    return out


def state_nodes(nodes: list, types: dict) -> list:
    """StateNodes of the node records: initialized nodes of their pools,
    with the pool's labels and taints and one bound pod each."""
    from karpenter_tpu_torch.api import labels as L, objects as o
    from karpenter_tpu_torch.state.statenode import StateNode
    out = []
    for n in nodes:
        it = types[n["type"]]
        labels = objects._labels(it)
        labels.update({
            L.LABEL_HOSTNAME: n["name"], L.NODEPOOL_LABEL_KEY: n["pool"],
            L.NODE_INITIALIZED_LABEL_KEY: "true",
            L.LABEL_TOPOLOGY_ZONE: n["zone"],
            L.CAPACITY_TYPE_LABEL_KEY: n["capacity_type"], **n["labels"]})
        sn = StateNode(node=o.Node(
            metadata=o.ObjectMeta(name=n["name"], namespace="",
                                  uid=f"uid-{n['name']}", labels=labels),
            spec=o.NodeSpec(provider_id=f"bench://{n['name']}",
                            taints=[o.Taint(key=k, value=v, effect=e)
                                    for k, v, e in n["taints"]]),
            status=o.NodeStatus(capacity=dict(it.capacity),
                                allocatable=dict(it.allocatable()))))
        sn.update_pod(o.Pod(
            metadata=o.ObjectMeta(name=n["pod"], namespace="default",
                                  uid=f"uid-{n['pod']}"),
            spec=o.PodSpec(node_name=n["name"]),
            container_requests=[dict(n["used"])]))
        out.append(sn)
    return out
