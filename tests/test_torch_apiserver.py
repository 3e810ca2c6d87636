"""The port's kube backend over HTTP, against the reference: the port's
``KubeApiStore`` and ``KubeLease`` (karpenter_tpu_torch/kube/apiserver.py,
operator/leaderelection.py) drive the JAX package's in-process apiserver
(``karpenter_tpu.kube.envtest.EnvtestServer``, which the port does not
copy), and the port's ``k8s_codec`` writes the same wire dicts as the
reference's for the objects of tests/test_apiserver_adapter.py, and reads
them back to the same objects."""

import time

import pytest

from karpenter_tpu.kube import k8s_codec as jkc
from karpenter_tpu.kube.envtest import EnvtestServer
from karpenter_tpu_torch.api import labels as api_labels
from karpenter_tpu_torch.api.nodeclaim import NodeClaim
from karpenter_tpu_torch.api.nodepool import Budget, NodePool
from karpenter_tpu_torch.api.objects import Node, NodeSpec, ObjectMeta, Pod
from karpenter_tpu_torch.kube import k8s_codec as pkc
from karpenter_tpu_torch.kube.apiserver import KubeApiStore
from karpenter_tpu_torch.kube.store import ConflictError, InvalidError
from karpenter_tpu_torch.operator.leaderelection import KubeLease
from karpenter_tpu_torch.utils.clock import Clock, FakeClock

import test_torch_support as support
from test_torch_support import JAX, PORT, ROOTS, factories
from test_torch_support import device_series_kept  # noqa: F401 (autouse)
from test_torch_support import tracer_kept  # noqa: F401 (autouse)

make_nodepool = factories(PORT).make_nodepool
make_pod = factories(PORT).make_pod


# -- the codec, object for object ----------------------------------------------

def _objects(root: str) -> dict:
    """The objects tests/test_apiserver_adapter.py round-trips, built in
    ``root``'s package with fixed names, uids and timestamps."""
    f = factories(root)
    m = lambda name: support.importlib.import_module(  # noqa: E731
        f"{root}.{name}")
    o, L, nc_mod = m("api.objects"), m("api.labels"), m("api.nodeclaim")
    res = m("utils.resources")
    sel = m("provisioning.scheduler")._SelectorReq
    pool_mod = m("api.nodepool")
    pod = f.make_pod(cpu="500m", memory="1Gi", labels={"app": "x"},
                     node_selector={"zone": "a"},
                     tolerations=[o.Toleration(key="k", operator="Exists",
                                               effect="NoSchedule")],
                     spread=[f.spread_zone(key="app", value="x")],
                     pod_anti_affinity=[f.affinity_term(
                         L.LABEL_HOSTNAME, key="app", value="x")],
                     host_ports=[o.HostPort(port=8080)], name="full-pod")
    pod.spec.volumes.append(o.PVCRef(claim_name="data"))
    pod.spec.volumes.append(o.PVCRef(claim_name="scratch", ephemeral=True,
                                     storage_class_name="fast"))
    alloc = res.parse_list({"cpu": "4", "memory": "8Gi"})
    node = o.Node(metadata=o.ObjectMeta(name="n1", namespace="",
                                        labels={L.LABEL_HOSTNAME: "n1"}),
                  spec=o.NodeSpec(provider_id="kwok://n1",
                                  taints=[o.Taint(key="k",
                                                  effect="NoSchedule")]),
                  status=o.NodeStatus(capacity=dict(alloc),
                                      allocatable=alloc, conditions=[
                                          {"type": "Ready",
                                           "status": "False",
                                           "last_transition_time": 12345.0}
                                      ]))
    nc = nc_mod.NodeClaim(
        metadata=o.ObjectMeta(name="nc1", namespace="",
                              labels={L.NODEPOOL_LABEL_KEY: "default"}),
        spec=nc_mod.NodeClaimSpec(
            requirements=[sel(L.LABEL_ARCH, "In", ("amd64",)),
                          sel(L.LABEL_INSTANCE_TYPE, "In", ("a", "b"), 2)],
            resources_requests=res.parse_list({"cpu": "2"}),
            taints=[o.Taint(key="t", effect="NoSchedule")],
            expire_after=720 * 3600.0, termination_grace_period=300.0))
    nc.status.provider_id = "kwok://x"
    nc.conditions.set_true(nc_mod.COND_LAUNCHED, now=123.0)
    pool = f.make_nodepool(name="p1", limits={"cpu": "100"}, weight=7,
                           taints=[o.Taint(key="k", effect="NoSchedule")])
    pool.spec.disruption.budgets = [pool_mod.Budget(
        nodes="10%", schedule="0 9 * * 1", duration=3600.0)]
    out = {"pod": pod, "node": node, "nodeclaim": nc, "nodepool": pool}
    for i, obj in enumerate(out.values()):
        obj.metadata.uid = f"uid-{i}"
        obj.metadata.creation_timestamp = 1_700_000_000.0 + i
    return out


@pytest.mark.parametrize("kind", ["pod", "node", "nodeclaim", "nodepool"])
def test_codec_writes_the_reference_wire_dicts(kind):
    want = getattr(jkc, f"{kind}_to_k8s")(_objects(JAX)[kind])
    got = getattr(pkc, f"{kind}_to_k8s")(_objects(PORT)[kind])
    assert got == want


@pytest.mark.parametrize("kind", ["pod", "node", "nodeclaim", "nodepool"])
def test_codec_reads_the_reference_wire_dicts(kind):
    """The port decodes the reference's wire dict to an object that it
    encodes back to the same dict, as the reference does."""
    wire = getattr(jkc, f"{kind}_to_k8s")(_objects(JAX)[kind])
    back_j = getattr(jkc, f"{kind}_to_k8s")(
        getattr(jkc, f"{kind}_from_k8s")(wire))
    back_p = getattr(pkc, f"{kind}_to_k8s")(
        getattr(pkc, f"{kind}_from_k8s")(wire))
    assert back_p == back_j


def test_daemonset_owner_detected():
    d = jkc.pod_to_k8s(_objects(JAX)["pod"])
    d["metadata"]["ownerReferences"] = [{"kind": "DaemonSet",
                                         "name": "ds", "uid": "u1"}]
    assert pkc.pod_from_k8s(d).is_daemonset_pod
    assert jkc.pod_from_k8s(d).is_daemonset_pod


@pytest.mark.parametrize("value", [None, 0.0, 300.0, 3661.0, 720 * 3600.0])
def test_durations_match(value):
    assert pkc.duration_to_k8s(value) == jkc.duration_to_k8s(value)
    text = jkc.duration_to_k8s(value)
    assert pkc.duration_from_k8s(text) == jkc.duration_from_k8s(text)


@pytest.mark.parametrize("value", [0.0, 1_700_000_000.0, 1_700_000_000.25])
def test_timestamps_match(value):
    assert pkc.ts_to_k8s(value) == jkc.ts_to_k8s(value)
    assert pkc.ts_from_k8s(jkc.ts_to_k8s(value)) == \
        jkc.ts_from_k8s(jkc.ts_to_k8s(value))


def test_quantities_match():
    for root, kc in ((JAX, jkc), (PORT, pkc)):
        res = support.pkg(root).res
        rl = res.parse_list({"cpu": "500m", "memory": "1Gi", "pods": "110"})
        assert kc.resources_from_k8s(kc.resources_to_k8s(rl)) == rl
    rl = support.pkg(JAX).res.parse_list({"cpu": "1500m", "memory": "3Gi"})
    assert pkc.resources_to_k8s(rl) == jkc.resources_to_k8s(rl)


# -- the port's store over the reference's apiserver ---------------------------

@pytest.fixture
def env_store():
    with EnvtestServer() as srv:
        store = KubeApiStore(srv.url, clock=Clock())
        store._envtest = srv
        yield store
        store.stop_watches()


def test_crud_round_trip_over_http(env_store):
    pod = make_pod(cpu="250m", name="envtest-pod", labels={"app": "x"})
    env_store.create(pod)
    live = env_store.get(Pod, "envtest-pod", "default")
    assert live is not None and live.labels == {"app": "x"}
    assert live.metadata.uid and live.metadata.resource_version
    live.spec.node_name = "some-node"
    env_store.update(live)
    again = env_store.get(Pod, "envtest-pod", "default")
    assert again.spec.node_name == "some-node"
    env_store.delete(again)
    assert env_store.get(Pod, "envtest-pod", "default") is None


def test_stale_resource_version_conflicts(env_store):
    node = Node(metadata=ObjectMeta(name="rv-node", namespace=""),
                spec=NodeSpec(provider_id="t://rv"))
    env_store.create(node)
    first = env_store.get(Node, "rv-node")
    env_store.update(env_store.get(Node, "rv-node"))  # bumps RV
    first.metadata.labels["stale"] = "write"
    with pytest.raises(ConflictError):
        env_store.update(first)


def test_finalizer_gates_deletion(env_store):
    node = Node(metadata=ObjectMeta(name="fin-node", namespace="",
                                    finalizers=["karpenter.sh/test"]),
                spec=NodeSpec(provider_id="t://fin"))
    env_store.create(node)
    env_store.delete(env_store.get(Node, "fin-node"))
    live = env_store.get(Node, "fin-node")
    assert live is not None, "finalized object removed prematurely"
    assert live.metadata.deletion_timestamp is not None
    env_store.remove_finalizer(live, "karpenter.sh/test")
    assert env_store.get(Node, "fin-node") is None


def test_admission_rejects_over_http(env_store):
    bad = make_nodepool(name="bad-pool")
    bad.spec.disruption.budgets = [Budget(nodes="150%")]
    with pytest.raises(InvalidError):
        env_store.create(bad)
    assert env_store.get(NodePool, "bad-pool") is None


def test_recorder_sink_posts_real_events(env_store):
    from karpenter_tpu_torch.events.catalog import evict_pod
    from karpenter_tpu_torch.events.recorder import Recorder
    rec = Recorder(FakeClock(), sink=env_store.post_event)
    rec.publish(evict_pod(make_pod(name="evicted-pod")))
    [ev] = env_store._envtest.state.events
    assert ev["reason"] == "Evicted"
    assert ev["involvedObject"]["name"] == "evicted-pod"
    assert ev["source"] == {"component": "karpenter"}


def test_watch_streams_store_changes(env_store):
    seen = []
    env_store.watch(seen.append)
    env_store.start_watches(kinds=(Pod,))
    env_store.create(make_pod(cpu="100m", name="watched-pod"))
    deadline = time.time() + 10
    while time.time() < deadline:
        env_store.pump_events()
        if any(e.obj.metadata.name == "watched-pod" for e in seen):
            break
        time.sleep(0.05)
    assert any(e.obj.metadata.name == "watched-pod" for e in seen), \
        "watch stream never delivered the pod"


def test_operator_provision_loop_e2e(env_store):
    """The port's control loop against the live wire: NodePool + pending
    Pod in, NodeClaim launched, Node fabricated, pod bound."""
    from karpenter_tpu_torch.cloudprovider.kwok import KwokCloudProvider
    from karpenter_tpu_torch.controllers.manager import Manager
    from karpenter_tpu_torch.controllers.nodeclaim_lifecycle import \
        NodeClaimLifecycle
    from karpenter_tpu_torch.provisioning.provisioner import (Binder,
                                                              PodTrigger,
                                                              Provisioner)
    from karpenter_tpu_torch.state.cluster import Cluster
    from karpenter_tpu_torch.state.informers import wire_informers

    store = env_store
    clock = Clock()
    cluster = Cluster(store, clock)
    wire_informers(store, cluster)
    provider = KwokCloudProvider(store=store)
    mgr = Manager(store, clock)
    provisioner = Provisioner(store, cluster, provider, clock, device="cpu")
    mgr.register(provisioner, PodTrigger(provisioner),
                 Binder(store, cluster, provisioner),
                 NodeClaimLifecycle(store, cluster, provider, clock))
    store.start_watches()
    store.apply(make_nodepool(name="envtest-default"))
    pod = make_pod(cpu="100m", name="envtest-e2e-pod")
    store.apply(pod)
    deadline = time.time() + 60
    bound = None
    while time.time() < deadline:
        store.pump_events()
        mgr.run_until_quiet()
        live = store.get(Pod, pod.metadata.name, pod.metadata.namespace)
        if live is not None and live.spec.node_name:
            bound = live
            break
        time.sleep(0.2)
    assert bound is not None, "pod never bound through the apiserver"
    claims = store.list(NodeClaim)
    assert any(c.metadata.labels.get(api_labels.NODEPOOL_LABEL_KEY)
               == "envtest-default" for c in claims)
    assert store.list(Node), "no node materialized through the wire"


# -- the port's lease over the reference's apiserver ---------------------------

@pytest.fixture
def lease_pair(env_store):
    clock = FakeClock(start=1_700_000_000.0)
    a = KubeLease(env_store, "replica-a", lease_duration=15.0, clock=clock)
    b = KubeLease(env_store, "replica-b", lease_duration=15.0, clock=clock)
    return env_store, clock, a, b


def test_lease_first_candidate_acquires(lease_pair):
    _, _, a, b = lease_pair
    assert a.try_acquire()
    assert a.holder() == "replica-a"
    assert not b.try_acquire()


def test_lease_renewal_and_expiry_over_http(lease_pair):
    store, clock, a, b = lease_pair
    assert a.try_acquire()
    assert not b.try_acquire()      # b's observation window starts
    clock.step(10)
    assert a.renew()                # a new record restarts b's window
    clock.step(10)
    assert not b.try_acquire()
    clock.step(16)                  # unchanged for longer than the lease
    assert b.try_acquire()
    assert b.holder() == "replica-b"
    assert not a.renew()            # the deposed leader learns on renew
    live = store._request("GET", b._url(b.name))
    assert live["spec"]["leaseTransitions"] == 1


def test_lease_release_hands_over_at_once(lease_pair):
    _, _, a, b = lease_pair
    assert a.try_acquire()
    b.release()                     # a non-holder's release is a no-op
    assert a.holder() == "replica-a"
    a.release()
    assert b.try_acquire()
    assert b.holder() == "replica-b"


def test_operator_picks_the_kube_lease_for_the_kube_backend(env_store):
    from karpenter_tpu_torch.operator.operator import Operator
    from karpenter_tpu_torch.operator.options import Options
    op = Operator.__new__(Operator)
    op.options = Options(leader_elect=True, store_backend="kube")
    op.store = env_store
    op.clock = FakeClock()
    lease = op._lease()
    assert isinstance(lease, KubeLease)
    assert lease.try_acquire()


@pytest.mark.parametrize("root", ROOTS)
def test_both_packages_codecs_agree_on_a_live_object(env_store, root):
    """An object the port wrote over HTTP reads back through either
    package's codec to the same wire dict."""
    env_store.create(make_pod(cpu="300m", name=f"wire-{root}",
                              labels={"app": "w"}))
    wire = env_store._request(
        "GET", f"{env_store.base_url}/api/v1/namespaces/default/pods/"
        f"wire-{root}")
    kc = jkc if root == JAX else pkc
    back = kc.pod_to_k8s(kc.pod_from_k8s(wire))
    assert back == pkc.pod_to_k8s(pkc.pod_from_k8s(wire))
