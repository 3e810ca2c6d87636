"""The port's pod and node metric exporters
(karpenter_tpu_torch/controllers/metrics_exporters.py) on the CPU:
tests/test_metrics_exporters.py pointed at the port; a seeded fuzzer that
drives the same store events through both packages' exporters and holds
the two gauges' exposition equal after every drain (pods moving between
nodes, claims that have no node yet, nodes that outlive their claim,
terminal phases, two exporters writing one registry); and the check that
the port's exporters stay linear: their store listings and request-total
recomputations in a 2,000-pod binding step do not grow with the pods."""

import collections

import numpy as np
import pytest

from karpenter_tpu_torch.api.objects import Node
from karpenter_tpu_torch.cloudprovider.kwok import KwokCloudProvider
from karpenter_tpu_torch.controllers.manager import Manager
from karpenter_tpu_torch.controllers.metrics_exporters import (
    NODE_ALLOCATABLE, POD_BOUND_DURATION, POD_STATE, NodeMetrics, PodMetrics)
from karpenter_tpu_torch.kube.store import Store
from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.state.informers import wire_informers
from karpenter_tpu_torch.utils.clock import FakeClock

import test_torch_support as support
from test_torch_support import JAX, PORT, ROOTS, factories, fresh_registry
from test_torch_support import device_series_kept  # noqa: F401 (autouse)
from test_torch_support import tracer_kept  # noqa: F401 (autouse)

make_nodepool = factories(PORT).make_nodepool
make_pod = factories(PORT).make_pod


# -- tests/test_metrics_exporters.py on the port -------------------------------

@pytest.fixture
def env():
    clock = FakeClock()
    store = Store(clock)
    cluster = Cluster(store, clock)
    wire_informers(store, cluster)
    mgr = Manager(store, clock)
    pod_metrics = PodMetrics(store, cluster, clock)
    mgr.register(pod_metrics, NodeMetrics(store, cluster))

    class Env:
        pass

    e = Env()
    e.clock, e.store, e.cluster, e.mgr = clock, store, cluster, mgr
    e.pod_metrics = pod_metrics
    return e


class TestPodStateGauge:
    def test_counts_by_phase_and_binding(self, env):
        p1 = make_pod(name="a")
        p2 = make_pod(name="b")
        p2.status.phase = "Running"
        p2.spec.node_name = "n1"
        env.store.create(p1)
        env.store.create(p2)
        env.mgr.run_until_quiet()
        assert POD_STATE.value({"phase": "Pending",
                                "scheduled": "false"}) == 1
        assert POD_STATE.value({"phase": "Running", "scheduled": "true"}) == 1

    def test_state_combo_deleted_when_emptied(self, env):
        """metrics/pod suite_test.go:368+: the state metric disappears with
        the pod instead of freezing at its last value."""
        pod = make_pod(name="only")
        env.store.create(pod)
        env.mgr.run_until_quiet()
        assert POD_STATE.value({"phase": "Pending",
                                "scheduled": "false"}) == 1
        env.store.delete(pod)
        # another pod event refreshes the gauge
        other = make_pod(name="other")
        other.status.phase = "Running"
        other.spec.node_name = "n1"
        env.store.create(other)
        env.mgr.run_until_quiet()
        assert POD_STATE.value({"phase": "Pending",
                                "scheduled": "false"}) == 0

    def test_phase_transition_moves_the_count(self, env):
        pod = make_pod(name="mover")
        env.store.create(pod)
        env.mgr.run_until_quiet()
        pod.status.phase = "Running"
        pod.spec.node_name = "n1"
        env.store.update(pod)
        env.mgr.run_until_quiet()
        assert POD_STATE.value({"phase": "Pending",
                                "scheduled": "false"}) == 0
        assert POD_STATE.value({"phase": "Running", "scheduled": "true"}) == 1


class TestPodBoundDuration:
    def test_bound_observed_once(self, env):
        pod = make_pod(name="bindme")
        env.store.create(pod)
        env.mgr.run_until_quiet()
        before = POD_BOUND_DURATION.count()
        env.clock.step(5)
        pod.spec.node_name = "n1"
        env.store.update(pod)
        env.mgr.run_until_quiet()
        env.store.update(pod)  # a second MODIFIED must not re-observe
        env.mgr.run_until_quiet()
        assert POD_BOUND_DURATION.count() == before + 1


class TestNodeAllocatableGauge:
    def test_node_allocatable_exported(self, env):
        provider = KwokCloudProvider(store=env.store)
        from karpenter_tpu_torch.api import labels as api_labels
        from karpenter_tpu_torch.api.nodeclaim import NodeClaim
        from karpenter_tpu_torch.api.objects import ObjectMeta
        nc = NodeClaim(metadata=ObjectMeta(
            name="m-1", namespace="",
            labels={api_labels.NODEPOOL_LABEL_KEY: "default",
                    api_labels.LABEL_INSTANCE_TYPE: "c-1x-amd64-linux"}))
        provider.create(nc)
        env.mgr.run_until_quiet()
        [node] = env.store.list(Node)
        labels = {"node_name": node.name, "nodepool": "default",
                  "resource_type": "cpu"}
        got = NODE_ALLOCATABLE.value(labels)
        assert got == node.status.allocatable["cpu"]


class TestTerminationMetrics:
    """node/termination/suite_test.go:840-877: terminated counters, the
    termination-duration summary, and the lifetime histogram fire with the
    nodepool label when a node finalizes."""

    def test_termination_metrics_fire_on_finalize(self):
        from karpenter_tpu_torch.api.objects import Node as NodeKind
        from karpenter_tpu_torch.metrics.registry import (
            NODE_LIFETIME_DURATION, NODE_TERMINATION_DURATION,
            NODECLAIMS_TERMINATED, NODES_CREATED, NODES_TERMINATED)
        from karpenter_tpu_torch.operator.operator import Operator
        from test_torch_operator import settle
        op = Operator(clock=FakeClock(), device="cpu")
        labels = {"nodepool": "default"}
        created0 = NODES_CREATED.value(labels)
        term0 = NODES_TERMINATED.value(labels)
        nct0 = NODECLAIMS_TERMINATED.value(labels)
        dur0 = NODE_TERMINATION_DURATION.count(labels)
        life0 = NODE_LIFETIME_DURATION.count(labels)
        op.store.create(make_nodepool(name="default"))
        pod = make_pod(cpu="500m")
        op.store.create(pod)
        settle(op)
        assert NODES_CREATED.value(labels) == created0 + 1
        op.store.delete(pod)
        [node] = op.store.list(NodeKind)
        op.clock.step(120)
        op.store.delete(node)
        settle(op)
        assert op.store.get(NodeKind, node.name) is None
        assert NODES_TERMINATED.value(labels) == term0 + 1
        assert NODECLAIMS_TERMINATED.value(labels) == nct0 + 1
        assert NODE_TERMINATION_DURATION.count(labels) == dur0 + 1
        assert NODE_LIFETIME_DURATION.count(labels) == life0 + 1
        # the lifetime observation reflects the node's ~120 s of life
        assert NODE_LIFETIME_DURATION.sum(labels) >= 100


# -- the same events through both packages' exporters -------------------------

GAUGES = ("karpenter_pods_state", "karpenter_nodes_allocatable",
          "karpenter_nodes_total_pod_requests")


class ExporterCluster:
    """One package's store, cluster and manager with the two exporters, and
    the objects of a fuzz run by name, so both packages apply an action to
    their own objects."""

    def __init__(self, root: str):
        self.root = root
        k = support.pkg(root)
        w = support.warm_pkg(root)
        mx = support.importlib.import_module(
            f"{root}.controllers.metrics_exporters")
        self.k, self.nc_mod = k, w.nodeclaim
        self.clock = w.clock.FakeClock()
        self.store = w.store.Store(self.clock)
        self.cluster = w.cluster.Cluster(self.store, self.clock)
        w.informers.wire_informers(self.store, self.cluster)
        mgr_mod = support.importlib.import_module(
            f"{root}.controllers.manager")
        self.mgr = mgr_mod.Manager(self.store, self.clock)
        self.mgr.register(mx.PodMetrics(self.store, self.cluster, self.clock),
                          mx.NodeMetrics(self.store, self.cluster))
        self.objs = {}

    def resources(self, cpu: int):
        return self.k.res.parse_list({"cpu": f"{cpu}", "memory": f"{cpu}Gi",
                                      "pods": "110"})

    def claim(self, name, pool, pid, cpu):
        L, o = self.k.labels, self.k.objects
        nc = self.nc_mod.NodeClaim(
            metadata=o.ObjectMeta(name=name, namespace="",
                                  labels={L.NODEPOOL_LABEL_KEY: pool}),
            spec=self.nc_mod.NodeClaimSpec())
        nc.status.provider_id = pid
        nc.status.allocatable = self.resources(cpu)
        self.store.create(nc)
        self.objs[name] = nc

    def node(self, name, pool, pid, cpu):
        L, o = self.k.labels, self.k.objects
        node = o.Node(
            metadata=o.ObjectMeta(name=name, namespace="",
                                  labels={L.NODEPOOL_LABEL_KEY: pool,
                                          L.LABEL_HOSTNAME: name}),
            spec=o.NodeSpec(provider_id=pid),
            status=o.NodeStatus(capacity=self.resources(cpu),
                                allocatable=self.resources(cpu)))
        self.store.create(node)
        self.objs[name] = node

    def pod(self, name, node_name, cpu_m):
        p = support.pod(self.root, name, cpu=f"{cpu_m}m")
        p.spec.node_name = node_name
        self.store.create(p)
        self.objs[name] = p

    def update(self, name, fn):
        obj = self.objs[name]
        fn(obj)
        self.store.update(obj)

    def delete(self, name):
        self.store.delete(self.objs.pop(name))


def fuzz_actions(seed: int, n: int = 160) -> list:
    """A seeded list of store actions over a few claims, nodes and pods;
    each is (verb, args) and names only objects that exist then."""
    rng = np.random.default_rng(seed)
    claims, nodes, pods = {}, {}, {}
    seq = collections.Counter()
    out = []
    for _ in range(n):
        verb = rng.choice(["claim", "node", "launch", "pod", "pod", "pod",
                           "bind", "move", "phase", "delete_pod",
                           "delete_node", "delete_claim", "resize",
                           "relabel", "drain", "drain"])
        if verb == "claim" and len(claims) < 6:
            seq["c"] += 1
            name = f"nc-{seq['c']}"
            pid = f"fz://{seq['c']}" if rng.random() < 0.5 else ""
            claims[name] = pid
            out.append(("claim", (name, "pool-a", pid,
                                  int(rng.integers(2, 9)))))
        elif verb == "launch" and claims:
            name = sorted(claims)[int(rng.integers(0, len(claims)))]
            if not claims[name]:
                claims[name] = f"fz://{name}"
                out.append(("launch", (name, claims[name])))
        elif verb == "node" and len(nodes) < 6:
            seq["n"] += 1
            name = f"node-{seq['n']}"
            # half the nodes register against a claim's provider id
            launched = sorted(c for c, pid in claims.items() if pid)
            pid = launched[int(rng.integers(0, len(launched)))] \
                if launched and rng.random() < 0.5 else f"fzn://{name}"
            pid = claims.get(pid, pid)
            nodes[name] = pid
            out.append(("node", (name, ["pool-a", "pool-b"][
                int(rng.integers(0, 2))], pid, int(rng.integers(2, 9)))))
        elif verb == "pod" and len(pods) < 40:
            seq["p"] += 1
            name = f"p-{seq['p']}"
            where = [""] + sorted(nodes) + ["nowhere"]
            target = where[int(rng.integers(0, len(where)))]
            pods[name] = target
            out.append(("pod", (name, target,
                                int(rng.integers(1, 9)) * 125)))
        elif verb in ("bind", "move") and pods and nodes:
            name = sorted(pods)[int(rng.integers(0, len(pods)))]
            target = sorted(nodes)[int(rng.integers(0, len(nodes)))]
            if verb == "bind" and pods[name]:
                continue
            pods[name] = target
            out.append(("bind", (name, target)))
        elif verb == "phase" and pods:
            name = sorted(pods)[int(rng.integers(0, len(pods)))]
            phase = ["Running", "Succeeded", "Failed", "Pending"][
                int(rng.integers(0, 4))]
            out.append(("phase", (name, phase)))
        elif verb == "delete_pod" and pods:
            name = sorted(pods)[int(rng.integers(0, len(pods)))]
            del pods[name]
            out.append(("delete", (name,)))
        elif verb == "delete_node" and nodes:
            name = sorted(nodes)[int(rng.integers(0, len(nodes)))]
            del nodes[name]
            out.append(("delete", (name,)))
        elif verb == "delete_claim" and claims:
            name = sorted(claims)[int(rng.integers(0, len(claims)))]
            del claims[name]
            out.append(("delete", (name,)))
        elif verb == "resize" and nodes:
            name = sorted(nodes)[int(rng.integers(0, len(nodes)))]
            out.append(("resize", (name, int(rng.integers(2, 9)))))
        elif verb == "relabel" and nodes:
            name = sorted(nodes)[int(rng.integers(0, len(nodes)))]
            out.append(("relabel", (name, ["pool-a", "pool-b"][
                int(rng.integers(0, 2))])))
        elif verb == "drain":
            out.append(("drain", ()))
    out.append(("drain", ()))
    return out


def apply(env: ExporterCluster, verb: str, args: tuple) -> None:
    L = env.k.labels
    if verb == "claim":
        env.claim(*args)
    elif verb == "launch":
        name, pid = args
        env.update(name, lambda nc: setattr(nc.status, "provider_id", pid))
    elif verb == "node":
        env.node(*args)
    elif verb == "pod":
        env.pod(*args)
    elif verb == "bind":
        name, target = args
        env.update(name, lambda p: setattr(p.spec, "node_name", target))
    elif verb == "phase":
        name, phase = args
        env.update(name, lambda p: setattr(p.status, "phase", phase))
    elif verb == "delete":
        env.delete(*args)
    elif verb == "resize":
        name, cpu = args

        def resize(node):
            node.status.allocatable = env.resources(cpu)
        env.update(name, resize)
    elif verb == "relabel":
        name, pool = args
        env.update(name, lambda node: node.metadata.labels.__setitem__(
            L.NODEPOOL_LABEL_KEY, pool))


def gauge_lines(root: str) -> list:
    reg = support.importlib.import_module(f"{root}.metrics.registry")
    return sorted(line for line in reg.REGISTRY.expose().splitlines()
                  if line.startswith(GAUGES))


@pytest.mark.parametrize("seed", range(12))
def test_exporters_match_the_reference_after_every_drain(seed):
    actions = fuzz_actions(seed)
    with fresh_registry(JAX), fresh_registry(PORT):
        envs = {root: ExporterCluster(root) for root in ROOTS}
        drains = 0
        for verb, args in actions:
            for env in envs.values():
                if verb == "drain":
                    env.mgr.drain()
                else:
                    apply(env, verb, args)
            if verb == "drain":
                drains += 1
                assert gauge_lines(JAX) == gauge_lines(PORT), (seed, drains)
        assert drains > 5 and gauge_lines(JAX)


@pytest.mark.parametrize("seed", range(3))
def test_two_clusters_on_one_registry_match_the_reference(seed):
    """Two operators in one process write the same gauges: each exporter's
    reconcile after the other's rewrites every series of its own cluster,
    as the reference's does."""
    actions = fuzz_actions(100 + seed)
    with fresh_registry(JAX), fresh_registry(PORT):
        envs = {root: [ExporterCluster(root), ExporterCluster(root)]
                for root in ROOTS}
        for i, (verb, args) in enumerate(actions):
            which = i % 2 if verb == "drain" else None
            for root in ROOTS:
                for j, env in enumerate(envs[root]):
                    if verb != "drain":
                        apply(env, verb, args)
                    elif j == which:
                        env.mgr.drain()
            if verb == "drain":
                assert gauge_lines(JAX) == gauge_lines(PORT), (seed, i)


# -- linear work ----------------------------------------------------------------

def test_exporters_work_does_not_grow_with_the_pods(monkeypatch):
    """One operator binds 2,000 pods. The exporters list the store and
    recompute a node's pod-request total a bounded number of times — once,
    on their first reconcile — not once per event as the reference's do;
    their reconciles still see every pod event."""
    from karpenter_tpu_torch.operator.operator import Operator
    from karpenter_tpu_torch.state.statenode import StateNode
    from karpenter_tpu_torch.utils.injection import controller_name
    calls = collections.Counter()
    real_list, real_total = Store.list, StateNode.pod_request_total
    real_states = Cluster.state_nodes

    def counted(kind, real):
        def fn(*args, **kw):
            calls[(controller_name(), kind)] += 1
            return real(*args, **kw)
        return fn
    monkeypatch.setattr(Store, "list", counted("list", real_list))
    monkeypatch.setattr(StateNode, "pod_request_total",
                        counted("total", real_total))
    monkeypatch.setattr(Cluster, "state_nodes",
                        counted("state_nodes", real_states))
    reconciles = collections.Counter()
    op = Operator(clock=FakeClock(), device="cpu")
    for c in op.manager.controllers:
        if c.name in ("metrics.pod", "metrics.node"):
            real = c.reconcile

            def wrapped(obj, _real=real, _name=c.name):
                reconciles[_name] += 1
                return _real(obj)
            c.reconcile = wrapped
    f = factories(PORT)
    op.store.create(f.make_nodepool(name="default"))
    for i in range(2000):
        op.store.create(f.make_pod(cpu="500m", name=f"lin-{i:04d}"))
    steps = 0
    while not all(p.spec.node_name for p in real_list(op.store, f.Pod)):
        op.step()
        op.clock.step(1.1)
        steps += 1
        assert steps <= 20, "2,000 pods did not bind in 20 steps"
    assert reconciles["metrics.pod"] >= 4000  # created, then bound
    assert reconciles["metrics.node"] >= 4000
    for name in ("metrics.pod", "metrics.node"):
        for kind in ("list", "total", "state_nodes"):
            assert calls[(name, kind)] <= 1, (name, kind, calls)
