"""The program's API objects for the spot fleet of ``spot_spec.py``: the
catalog priced from one spot vector, and a live cluster of spot nodes each
holding its replicas, as ``objects.py`` builds the on-demand fleet.
With the drivers and ``objects.py``, the one module of the benchmark that
imports the program."""

from __future__ import annotations

from types import SimpleNamespace

from . import objects
from . import spot_spec as SS


def instance_types(types: list, vector: str) -> list:
    """InstanceType objects of the catalog, spot offerings priced from
    ``vector``."""
    return objects.instance_types(
        [{**it, "offerings": SS.offerings(it, vector)} for it in types])


def live_fleet(fleet: dict, types: list, pool_name: str, device):
    """A live cluster holding the fleet: a kube store whose informers feed
    the cluster state on a fake clock, the kwok provider over ``types``, a
    Provisioner on ``device``, the pool with the fleet's budget, and every
    node an initialized, consolidatable spot claim with its running
    replicas, which select the fleet's OS."""
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
    store.create(objects.nodepool(pool_name, fleet["budget"]))
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
                  L.LABEL_TOPOLOGY_ZONE: n["zone"], L.LABEL_HOSTNAME: name,
                  L.LABEL_OS: fleet["os"]}
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
        dep = fleet["deployments"][n["deployment"]]
        for j, pod in enumerate(n["pods"]):
            ann = ({L.DO_NOT_DISRUPT_ANNOTATION_KEY: "true"}
                   if j == 0 and n["do_not_disrupt"] else {})
            p = o.Pod(metadata=o.ObjectMeta(name=pod, namespace="default",
                                            uid=f"uid-{pod}",
                                            labels={"app": dep["app"]},
                                            annotations=ann),
                      spec=o.PodSpec(node_name=n["name"],
                                     node_selector={L.LABEL_OS: fleet["os"]}),
                      container_requests=[dict(n["pod_requests"])])
            p.status.phase = "Running"
            store.create(p)
    clock.step(600)
    return SimpleNamespace(clock=clock, store=store, cluster=cluster,
                           provider=provider, provisioner=provisioner)
