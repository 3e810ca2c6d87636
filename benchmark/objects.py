"""The program's API objects built from the plain records of ``spec.py``:
the catalog, the NodePool, pending pods, existing nodes and a live
consolidation fleet, as the kwok provider and chip_smoke.py's fleet
builders make them. This is the one module of the benchmark, with the
drivers, that imports the program."""

from __future__ import annotations

from types import SimpleNamespace

from . import spec as S


def instance_types(types: list) -> list:
    """InstanceType objects of the catalog records (kwok's
    make_instance_type: one requirement for every well-known label)."""
    from karpenter_tpu_torch.api import labels as L
    from karpenter_tpu_torch.cloudprovider.kwok import (GROUP_INSTANCE_FAMILY,
                                                        GROUP_INSTANCE_SIZE)
    from karpenter_tpu_torch.cloudprovider.types import (InstanceType,
                                                         InstanceTypeOverhead,
                                                         Offering, Offerings)
    from karpenter_tpu_torch.scheduling.requirement import IN, Requirement
    from karpenter_tpu_torch.scheduling.requirements import Requirements
    out = []
    for it in types:
        offerings = Offerings()
        for zone, ct, price, available in it["offerings"]:
            offerings.append(Offering(
                requirements=Requirements([
                    Requirement(L.CAPACITY_TYPE_LABEL_KEY, IN, [ct]),
                    Requirement(L.LABEL_TOPOLOGY_ZONE, IN, [zone])]),
                price=price, available=available))
        out.append(InstanceType(
            name=it["name"],
            requirements=Requirements([
                Requirement(L.LABEL_INSTANCE_TYPE, IN, [it["name"]]),
                Requirement(L.LABEL_ARCH, IN, [it["arch"]]),
                Requirement(L.LABEL_OS, IN, [it["os"]]),
                Requirement(L.LABEL_TOPOLOGY_ZONE, IN, it["zones"]),
                Requirement(L.LABEL_TOPOLOGY_REGION, IN, [it["region"]]),
                Requirement(L.CAPACITY_TYPE_LABEL_KEY, IN,
                            list(S.CAPACITY_TYPES)),
                Requirement(GROUP_INSTANCE_SIZE, IN, [it["size"]]),
                Requirement(GROUP_INSTANCE_FAMILY, IN, [it["family"]])]),
            offerings=offerings, capacity=dict(it["capacity"]),
            overhead=InstanceTypeOverhead(
                kube_reserved=dict(it["overhead"]))))
    return out


def nodepool(name: str, budget: str = ""):
    """A NodePool with no requirements and no limits; with ``budget`` the
    consolidation tests' disruption budget and no consolidation wait."""
    from karpenter_tpu_torch.api import nodepool as np_
    from karpenter_tpu_torch.api.objects import ObjectMeta
    pool = np_.NodePool(
        metadata=ObjectMeta(name=name, uid=f"nodepool-{name}"),
        spec=np_.NodePoolSpec(template=np_.NodeClaimTemplate(
            spec=np_.NodeClaimTemplateSpec())))
    if budget:
        pool.spec.disruption.budgets = [np_.Budget(nodes=budget)]
        pool.spec.disruption.consolidate_after = 0.0
    return pool


def _pod_spec(dep: dict):
    """The spec of a deployment's pods: its kind's spreads and affinities
    (chip_smoke.bench_pods)."""
    from karpenter_tpu_torch.api import labels as L, objects as o
    sel = o.LabelSelector(match_labels={"app": dep["app"]})
    zone_spread = o.TopologySpreadConstraint(
        topology_key=L.LABEL_TOPOLOGY_ZONE, max_skew=1, label_selector=sel)
    host_anti = o.Affinity(pod_anti_affinity=o.PodAffinity(required=[
        o.PodAffinityTerm(topology_key=L.LABEL_HOSTNAME, label_selector=sel)]))
    kind = dep["kind"]
    spread, affinity = [], None
    if kind == "zone_spread":
        spread = [zone_spread]
    elif kind == "host_spread":
        spread = [o.TopologySpreadConstraint(
            topology_key=L.LABEL_HOSTNAME, max_skew=1, label_selector=sel)]
    elif kind == "host_affinity":
        affinity = o.Affinity(pod_affinity=o.PodAffinity(required=[
            o.PodAffinityTerm(topology_key=L.LABEL_HOSTNAME,
                              label_selector=sel)]))
    elif kind == "zone_affinity":
        affinity = o.Affinity(pod_affinity=o.PodAffinity(required=[
            o.PodAffinityTerm(topology_key=L.LABEL_TOPOLOGY_ZONE,
                              label_selector=sel)]))
    elif kind == "host_anti":
        affinity = host_anti
    elif kind == "zone_spread_min_domains":
        spread = [o.TopologySpreadConstraint(
            topology_key=L.LABEL_TOPOLOGY_ZONE, max_skew=1, min_domains=4,
            label_selector=sel)]
    elif kind == "zone_spread_host_anti":
        spread, affinity = [zone_spread], host_anti
    elif kind == "zone_spread_other":
        spread = [o.TopologySpreadConstraint(
            topology_key=L.LABEL_TOPOLOGY_ZONE, max_skew=1,
            label_selector=o.LabelSelector(
                match_labels={"app": dep["other_app"]}))]
    return spread, affinity


def pods(burst: dict, drop_host_rules: bool = False) -> list:
    """The burst's pending pods in the order they arrive. With
    ``drop_host_rules`` the hostname spreads and anti-affinities are left
    out: the control's broken guarantee."""
    from karpenter_tpu_torch.api import objects as o
    specs = []
    for dep in burst["deployments"]:
        spread, affinity = _pod_spec(dep)
        if drop_host_rules and S.constraints(dep["kind"])["one_per_host"]:
            spread = [c for c in spread
                      if c.topology_key != "kubernetes.io/hostname"]
            if affinity is not None:
                affinity = None
        specs.append((spread, affinity,
                      {"cpu": dep["cpu"], "memory": dep["memory"]}))
    out = []
    for name in burst["pods"]:
        d = burst["pod_deployment"][name]
        spread, affinity, requests = specs[d]
        out.append(o.Pod(
            metadata=o.ObjectMeta(
                name=name, namespace="default", uid=f"uid-{name}",
                labels={"app": burst["deployments"][d]["app"]}),
            spec=o.PodSpec(topology_spread_constraints=list(spread),
                           affinity=affinity),
            container_requests=[dict(requests)]))
    return out


def _labels(it) -> dict:
    """The single-valued labels an instance type's requirements give."""
    return {key: it.requirements.get(key).values_list()[0]
            for key in it.requirements
            if len(it.requirements.get(key).values_list()) == 1}


def state_nodes(nodes: list, types: dict, pool: str) -> list:
    """StateNodes of the existing-node records (chip_smoke.existing_nodes):
    initialized nodes of ``pool``, each with its one bound pod."""
    from karpenter_tpu_torch.api import labels as L, objects as o
    from karpenter_tpu_torch.state.statenode import StateNode
    out = []
    for n in nodes:
        it = types[n["type"]]
        labels = _labels(it)
        labels.update({
            L.LABEL_HOSTNAME: n["name"], L.NODEPOOL_LABEL_KEY: pool,
            L.NODE_INITIALIZED_LABEL_KEY: "true",
            L.LABEL_TOPOLOGY_ZONE: n["zone"],
            L.CAPACITY_TYPE_LABEL_KEY: n["capacity_type"]})
        alloc = it.allocatable()
        sn = StateNode(node=o.Node(
            metadata=o.ObjectMeta(name=n["name"], namespace="",
                                  uid=f"uid-{n['name']}", labels=labels),
            spec=o.NodeSpec(provider_id=f"bench://{n['name']}"),
            status=o.NodeStatus(capacity=dict(it.capacity),
                                allocatable=dict(alloc))))
        sn.update_pod(o.Pod(
            metadata=o.ObjectMeta(name=n["pod"], namespace="default",
                                  uid=f"uid-{n['pod']}"),
            spec=o.PodSpec(node_name=n["name"]),
            container_requests=[dict(n["used"])]))
        out.append(sn)
    return out


def live_fleet(fleet: dict, types: list, pool_name: str, device,
               honour_do_not_disrupt: bool = True):
    """A live cluster holding the fleet (chip_smoke.live_cluster,
    fab_node, fab_pod): a kube store whose informers feed the cluster
    state on a fake clock, the kwok provider over ``types``, a Provisioner
    on ``device``, the pool with the fleet's budget, and every node an
    initialized, consolidatable on-demand claim with its one running pod.
    Without ``honour_do_not_disrupt`` no pod carries the annotation: the
    control's broken guarantee."""
    from karpenter_tpu_torch.api import labels as L
    from karpenter_tpu_torch.api import nodeclaim as nc_mod
    from karpenter_tpu_torch.api import nodepool as np_
    from karpenter_tpu_torch.api import objects as o
    from karpenter_tpu_torch.cloudprovider.kwok import KwokCloudProvider
    from karpenter_tpu_torch.kube.store import Store
    from karpenter_tpu_torch.provisioning.provisioner import Provisioner
    from karpenter_tpu_torch.state.cluster import Cluster
    from karpenter_tpu_torch.state.informers import wire_informers
    from karpenter_tpu_torch.utils.clock import FakeClock
    clock = FakeClock()
    store = Store(clock)
    cluster = Cluster(store, clock)
    wire_informers(store, cluster)
    provider = KwokCloudProvider(instance_types=types, store=store)
    provisioner = Provisioner(store, cluster, provider, clock, device=device)
    store.create(nodepool(pool_name, fleet["budget"]))
    by_name = {it.name: it for it in types}
    pool = store.get(np_.NodePool, pool_name)
    annotations = {
        L.NODEPOOL_HASH_ANNOTATION_KEY: pool.static_hash(),
        L.NODEPOOL_HASH_VERSION_ANNOTATION_KEY: np_.NODEPOOL_HASH_VERSION}
    # every node first, then the pods: bound pods then take the informer's
    # per-pod path instead of a pod-store scan per node
    for n in fleet["nodes"]:
        it = by_name[n["type"]]
        alloc = it.allocatable()
        name = n["name"]
        labels = {L.NODEPOOL_LABEL_KEY: pool_name,
                  L.LABEL_INSTANCE_TYPE: it.name,
                  L.CAPACITY_TYPE_LABEL_KEY: n["capacity_type"],
                  L.LABEL_TOPOLOGY_ZONE: n["zone"], L.LABEL_HOSTNAME: name}
        pid = f"bench://{name}"
        nc = nc_mod.NodeClaim(
            metadata=o.ObjectMeta(name=name, uid=f"uid-claim-{name}",
                                  labels=dict(labels),
                                  annotations=dict(annotations)),
            spec=nc_mod.NodeClaimSpec(startup_taints=[]),
            status=nc_mod.NodeClaimStatus(provider_id=pid, node_name=name,
                                          capacity=dict(alloc),
                                          allocatable=dict(alloc)))
        for cond in (nc_mod.COND_LAUNCHED, nc_mod.COND_REGISTERED,
                     nc_mod.COND_INITIALIZED, nc_mod.COND_CONSOLIDATABLE):
            nc.conditions.set_true(cond, now=clock.now())
        store.create(nc)
        store.create(o.Node(
            metadata=o.ObjectMeta(
                name=name, uid=f"uid-{name}",
                labels={**labels, L.NODE_INITIALIZED_LABEL_KEY: "true"},
                finalizers=[L.TERMINATION_FINALIZER]),
            spec=o.NodeSpec(provider_id=pid, taints=[]),
            status=o.NodeStatus(capacity=dict(alloc),
                                allocatable=dict(alloc))))
    for n in fleet["nodes"]:
        ann = ({L.DO_NOT_DISRUPT_ANNOTATION_KEY: "true"}
               if n["do_not_disrupt"] and honour_do_not_disrupt else {})
        p = o.Pod(metadata=o.ObjectMeta(name=n["pod"], namespace="default",
                                        uid=f"uid-{n['pod']}",
                                        annotations=ann),
                  spec=o.PodSpec(node_name=n["name"]),
                  container_requests=[dict(n["pod_requests"])])
        p.status.phase = "Running"
        store.create(p)
    clock.step(600)
    return SimpleNamespace(clock=clock, store=store, cluster=cluster,
                           provider=provider, provisioner=provisioner)
