"""Shared workload constructors for the JAX-package-versus-port parity tests.

Every constructor takes the package root to build from ("karpenter_tpu" or
"karpenter_tpu_torch"), so both packages get the identical workload from
the same seeds. bench_pods, default_pool and existing_nodes rebuild
chip_smoke.py's north-star workload for either package
(test_torch_solve_parity.py holds the two equal for the port). The port's schedulers run on the CPU (``device="cpu"``),
where its kernel wrappers take their plain PyTorch versions.
"""

import importlib
from contextlib import contextmanager
from types import SimpleNamespace

import numpy as np
import pytest

JAX = "karpenter_tpu"
PORT = "karpenter_tpu_torch"
ROOTS = (JAX, PORT)


#: the per-launch device metric families, in either package's registry
DEVICE_FAMILIES = ("DEVICE_DISPATCHES", "DEVICE_DISPATCH_SECONDS",
                   "DEVICE_EXECUTE_SECONDS", "DEVICE_MEMORY_PEAK")


@pytest.fixture(autouse=True, scope="module")
def device_series_kept():
    """Each package's device metric series as they were before a module's
    tests, once they end (autouse where a module imports it). Those
    families keep 64 series a process, one a launch shape, and under xdist
    one worker runs modules of both packages: a module's solves must not
    fill them for the device tests of the modules after it, the JAX
    package's ``tests/test_obs_device.py`` among them."""
    families = [getattr(importlib.import_module(f"{root}.metrics.registry"),
                        name)
                for root in ROOTS for name in DEVICE_FAMILIES]
    saved = [dict(m._values) for m in families]
    yield
    for m, values in zip(families, saved):
        m._values.clear()
        m._values.update(values)


@pytest.fixture(autouse=True, scope="module")
def tracer_kept():
    """Each package's process-wide pass tracer as it was before a module's
    tests, once they end (autouse where a module imports it): every
    ``Operator`` configures its package's TRACER (enabled flag, ring size,
    SLO watcher), and a later module of either package in the same worker
    must not run with what an operator test left there."""
    tracers = [importlib.import_module(f"{root}.obs.tracer").TRACER
               for root in ROOTS]
    saved = [(t.enabled, t.capacity, t.watcher) for t in tracers]
    yield
    for t, (enabled, capacity, watcher) in zip(tracers, saved):
        t.enabled, t.watcher = enabled, watcher
        t.set_capacity(capacity)


@contextmanager
def fresh_registry(root: str):
    """``root``'s process-wide metric registry emptied for one timeline and
    restored after it, so the exposition is the timeline's alone."""
    reg = importlib.import_module(f"{root}.metrics.registry").REGISTRY
    saved = []
    for m in reg._metrics.values():
        state = {a: dict(getattr(m, a)) for a in ("_values", "_counts",
                                                  "_sums")
                 if hasattr(m, a)}
        saved.append((m, state))
        for a in state:
            getattr(m, a).clear()
    try:
        yield reg
    finally:
        for m, state in saved:
            for a, values in state.items():
                getattr(m, a).clear()
                getattr(m, a).update(values)



_FACTORIES = {}


def factories(root: str):
    """tests/factories.py for either package: make_pod, make_pods,
    make_nodepool (and the rest of it) building the objects of ``root``.
    The port's copy is factories.py's own source with the package name
    swapped, so the two build the same objects; each keeps its own pod
    name sequence."""
    if root not in _FACTORIES:
        if root == JAX:
            _FACTORIES[root] = importlib.import_module("factories")
        else:
            import types
            from pathlib import Path
            src = (Path(__file__).with_name("factories.py").read_text()
                   .replace("karpenter_tpu.", f"{root}."))
            mod = types.ModuleType(f"{root}_factories")
            exec(compile(src, f"<factories for {root}>", "exec"),
                 mod.__dict__)
            _FACTORIES[root] = mod
    return _FACTORIES[root]


PACK_FIELDS = ("compat_tm", "it_ok", "ppn", "it_ok_z", "zone_adm",
               "exist_ok", "exist_cap")


def pkg(root: str) -> SimpleNamespace:
    imp = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    return SimpleNamespace(
        labels=imp("api.labels"), objects=imp("api.objects"),
        nodepool=imp("api.nodepool"), kwok=imp("cloudprovider.kwok"),
        res=imp("utils.resources"), statenode=imp("state.statenode"),
        requirement=imp("scheduling.requirement"),
        requirements=imp("scheduling.requirements"),
        ts=imp("provisioning.tensor_scheduler"),
        grouping=imp("provisioning.grouping"),
        binpack=imp("ops.binpack"), encode=imp("ops.encode"))


def scheduler(root: str, nodepools, instance_types, **kw):
    if root == PORT:
        kw.setdefault("device", "cpu")
    return pkg(root).ts.TensorScheduler(nodepools, instance_types, **kw)


def nodepool(root: str, name="default", requirements=(), taints=(),
             limits=None, weight=None):
    k = pkg(root)
    return k.nodepool.NodePool(
        metadata=k.objects.ObjectMeta(name=name),
        spec=k.nodepool.NodePoolSpec(
            template=k.nodepool.NodeClaimTemplate(
                spec=k.nodepool.NodeClaimTemplateSpec(
                    requirements=list(requirements), taints=list(taints))),
            limits=k.res.parse_list(limits) if limits else {},
            weight=weight))


def pod(root: str, name: str, cpu="100m", memory="128Mi", labels=None,
        node_selector=None, tolerations=None, spread=None, pod_affinity=None,
        pod_anti_affinity=None):
    o = pkg(root).objects
    affinity = None
    if pod_affinity or pod_anti_affinity:
        affinity = o.Affinity(
            pod_affinity=(o.PodAffinity(required=list(pod_affinity))
                          if pod_affinity else None),
            pod_anti_affinity=(o.PodAffinity(required=list(pod_anti_affinity))
                               if pod_anti_affinity else None))
    return o.Pod(
        metadata=o.ObjectMeta(name=name, namespace="default",
                              labels=dict(labels or {})),
        spec=o.PodSpec(node_selector=dict(node_selector or {}),
                       tolerations=list(tolerations or []),
                       topology_spread_constraints=list(spread or []),
                       affinity=affinity),
        container_requests=[pkg(root).res.parse_list(
            {"cpu": cpu, "memory": memory})])


def state_node(root: str, name: str, nodepool_name: str, cpu: str,
               memory: str, initialized: bool, zone="test-zone-a"):
    k = pkg(root)
    L, o = k.labels, k.objects
    labels = {L.LABEL_HOSTNAME: name, L.NODEPOOL_LABEL_KEY: nodepool_name,
              L.LABEL_TOPOLOGY_ZONE: zone,
              L.CAPACITY_TYPE_LABEL_KEY: "on-demand"}
    if initialized:
        labels[L.NODE_INITIALIZED_LABEL_KEY] = "true"
    alloc = k.res.parse_list({"cpu": cpu, "memory": memory, "pods": "110"})
    return k.statenode.StateNode(node=o.Node(
        metadata=o.ObjectMeta(name=name, namespace="", labels=labels),
        spec=o.NodeSpec(provider_id=f"t://{name}"),
        status=o.NodeStatus(capacity=dict(alloc), allocatable=alloc)))


def mini_workload(root: str, n_deploys=6, pods_per=20, n_its=24):
    """__graft_entry__._mini_scheduler's workload: two weighted pools (one
    cpu-limited), existing nodes initialized and not, a zonal-spread mix.
    Returns (nodepools, instance_types, state_nodes, pods)."""
    k = pkg(root)
    its = k.kwok.construct_instance_types()[:n_its]
    pools = [nodepool(root, "default", weight=10),
             nodepool(root, "limited", limits={"cpu": "8"}, weight=1)]
    pods = []
    for d in range(n_deploys):
        labels = {"app": f"deploy-{d}"}
        spread = None
        if d % 2:
            spread = [k.objects.TopologySpreadConstraint(
                topology_key=k.labels.LABEL_TOPOLOGY_ZONE, max_skew=1,
                label_selector=k.objects.LabelSelector(
                    match_labels=dict(labels)))]
        for i in range(pods_per):
            n = d * pods_per + i
            pods.append(pod(root, f"graft-pod-{n:04d}", f"{100 * (d + 1)}m",
                            f"{128 * (d + 1)}Mi", labels, spread=spread))
    nodes = [state_node(root, "graft-node-init", "default", "4", "8Gi", True),
             state_node(root, "graft-node-uninit", "default", "2", "4Gi",
                        False)]
    return pools, {"default": its, "limited": its}, nodes, pods


def restricted_workload(root):
    """Pools restricted by zone and capacity type, pods pinned by node
    selectors: zone admission and the capacity-type bit test decide."""
    k = pkg(root)
    L, o = k.labels, k.objects
    req = lambda key, *vals: o.NodeSelectorRequirement(  # noqa: E731
        key=key, operator="In", values=tuple(vals))
    pools = [nodepool(root, "spot-ab", weight=10, requirements=[
                 req(L.LABEL_TOPOLOGY_ZONE, "test-zone-a", "test-zone-b"),
                 req(L.CAPACITY_TYPE_LABEL_KEY, L.CAPACITY_TYPE_SPOT)]),
             nodepool(root, "od-cd", requirements=[
                 req(L.LABEL_TOPOLOGY_ZONE, "test-zone-c", "test-zone-d"),
                 req(L.CAPACITY_TYPE_LABEL_KEY,
                     L.CAPACITY_TYPE_ON_DEMAND)])]
    its = k.kwok.construct_catalog(200)
    selectors = [{}, {L.LABEL_TOPOLOGY_ZONE: "test-zone-a"},
                 {L.LABEL_TOPOLOGY_ZONE: "test-zone-d"},
                 {L.CAPACITY_TYPE_LABEL_KEY: L.CAPACITY_TYPE_ON_DEMAND},
                 {L.LABEL_TOPOLOGY_ZONE: "test-zone-b",
                  L.CAPACITY_TYPE_LABEL_KEY: L.CAPACITY_TYPE_ON_DEMAND}]
    pods = [pod(root, f"r-{d}-{i}", cpu=f"{250 * (d + 1)}m",
                labels={"app": f"r{d}"}, node_selector=sel)
            for d, sel in enumerate(selectors) for i in range(6)]
    return pools, {"spot-ab": its, "od-cd": its}, [], pods


_CPUS = ["50m", "100m", "250m", "500m", "1000m"]
_MEMS = ["64Mi", "128Mi", "256Mi", "512Mi", "1Gi"]


def bench_pods(root: str, n_pods: int, n_deploys: int = 120) -> list:
    """The benchmark pod mix: n_deploys deployments of n_pods // n_deploys
    identical pods, cycling through nine kinds — generic, zonal spread,
    hostname spread, hostname affinity, zonal affinity, hostname
    anti-affinity (the reference's scheduling benchmark mix), minDomains
    spread, zonal spread + hostname anti-affinity, and a spread whose
    selector matches other pods."""
    k = pkg(root)
    o, L = k.objects, k.labels
    pods = []
    n_deploys = min(n_deploys, max(1, n_pods))
    per = max(1, n_pods // n_deploys)
    for d in range(n_deploys):
        labels = {"app": f"deploy-{d}"}
        sel = o.LabelSelector(match_labels=dict(labels))
        spread, affinity = [], None
        kind = d % 9
        zone_spread = o.TopologySpreadConstraint(
            topology_key=L.LABEL_TOPOLOGY_ZONE, max_skew=1, label_selector=sel)
        host_anti = o.Affinity(pod_anti_affinity=o.PodAffinity(required=[
            o.PodAffinityTerm(topology_key=L.LABEL_HOSTNAME,
                              label_selector=sel)]))
        if kind == 1:
            spread = [zone_spread]
        elif kind == 2:
            spread = [o.TopologySpreadConstraint(
                topology_key=L.LABEL_HOSTNAME, max_skew=1, label_selector=sel)]
        elif kind == 3:
            affinity = o.Affinity(pod_affinity=o.PodAffinity(required=[
                o.PodAffinityTerm(topology_key=L.LABEL_HOSTNAME,
                                  label_selector=sel)]))
        elif kind == 4:
            affinity = o.Affinity(pod_affinity=o.PodAffinity(required=[
                o.PodAffinityTerm(topology_key=L.LABEL_TOPOLOGY_ZONE,
                                  label_selector=sel)]))
        elif kind == 5:
            affinity = host_anti
        elif kind == 6:
            spread = [o.TopologySpreadConstraint(
                topology_key=L.LABEL_TOPOLOGY_ZONE, max_skew=1, min_domains=4,
                label_selector=sel)]
        elif kind == 7:
            spread, affinity = [zone_spread], host_anti
        elif kind == 8:
            spread = [o.TopologySpreadConstraint(
                topology_key=L.LABEL_TOPOLOGY_ZONE, max_skew=1,
                label_selector=o.LabelSelector(
                    match_labels={"app": f"unrelated-{d}"}))]
        requests = k.res.parse_list({"cpu": _CPUS[d % 5],
                                     "memory": _MEMS[d % 5]})
        for i in range(per):
            pods.append(o.Pod(
                metadata=o.ObjectMeta(name=f"p-{d}-{i}", namespace="default",
                                      labels=dict(labels)),
                spec=o.PodSpec(topology_spread_constraints=list(spread),
                               affinity=affinity),
                container_requests=[requests]))
    return pods


def default_pool(root: str):
    k = pkg(root)
    return k.nodepool.NodePool(
        metadata=k.objects.ObjectMeta(name="default"),
        spec=k.nodepool.NodePoolSpec(template=k.nodepool.NodeClaimTemplate(
            spec=k.nodepool.NodeClaimTemplateSpec())))


def existing_nodes(root: str, catalog, n: int, seed: int = 7) -> list:
    """n initialized nodes of the default pool: instance types drawn (seeded)
    from the catalog, spread round-robin over the four kwok zones and both
    capacity types, each carrying one bound pod that uses 30-90% of its cpu
    and memory."""
    import random
    k = pkg(root)
    o, L = k.objects, k.labels
    rng = random.Random(seed)
    zones = list(k.kwok.KWOK_ZONES)
    cts = [L.CAPACITY_TYPE_SPOT, L.CAPACITY_TYPE_ON_DEMAND]
    nodes = []
    for i in range(n):
        it = catalog[rng.randrange(len(catalog))]
        name = f"node-{i:05d}"
        labels = {key: it.requirements.get(key).values_list()[0]
                  for key in it.requirements
                  if len(it.requirements.get(key).values_list()) == 1}
        labels.update({
            L.LABEL_HOSTNAME: name,
            L.NODEPOOL_LABEL_KEY: "default",
            L.NODE_INITIALIZED_LABEL_KEY: "true",
            L.LABEL_TOPOLOGY_ZONE: zones[i % len(zones)],
            L.CAPACITY_TYPE_LABEL_KEY: cts[(i // len(zones)) % 2],
        })
        alloc = it.allocatable()
        sn = k.statenode.StateNode(node=o.Node(
            metadata=o.ObjectMeta(name=name, namespace="", labels=labels),
            spec=o.NodeSpec(provider_id=f"smoke://{name}"),
            status=o.NodeStatus(capacity=dict(it.capacity),
                                allocatable=dict(alloc))))
        used = rng.uniform(0.3, 0.9)
        sn.update_pod(o.Pod(
            metadata=o.ObjectMeta(name=f"bound-{i:05d}", namespace="default"),
            spec=o.PodSpec(node_name=name),
            container_requests=[{
                k.res.CPU: int(alloc[k.res.CPU] * used),
                k.res.MEMORY: int(alloc[k.res.MEMORY] * used)}]))
        nodes.append(sn)
    return nodes


def bench_workload(root: str, n_pods: int, n_its: int, n_nodes: int = 0,
                   zones=None, n_deploys: int = 120):
    """chip_smoke's north-star workload at a chosen size: the benchmark pod
    mix, one default pool, a construct_catalog(n_its) catalog over `zones`,
    and n_nodes existing nodes."""
    k = pkg(root)
    catalog = k.kwok.construct_catalog(n_its, zones=zones)
    nodes = existing_nodes(root, catalog, n_nodes) if n_nodes else []
    return ([default_pool(root)], {"default": catalog}, nodes,
            bench_pods(root, n_pods, n_deploys))


def build_problem(root: str, workload):
    """(scheduler, problem) for a workload: its pods partitioned into groups
    and encoded by the package's own build_problem."""
    pools, its, nodes, pods = workload
    ts = scheduler(root, pools, its, state_nodes=nodes)
    groups, leftover, reason = pkg(root).grouping.partition_pods(pods)
    assert groups and not leftover, reason
    problem, _, _ = ts.build_problem(groups)
    return ts, problem


def assert_tensors_equal(want, got):
    for name in PACK_FIELDS:
        a, b = getattr(want, name), getattr(got, name)
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (name, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=name)


# --------------------------------------------------------------------------
# the warm path: a live cluster (store + informers + state) per package
# --------------------------------------------------------------------------

def warm_pkg(root: str) -> SimpleNamespace:
    imp = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    return SimpleNamespace(
        nodeclaim=imp("api.nodeclaim"), store=imp("kube.store"),
        cluster=imp("state.cluster"), informers=imp("state.informers"),
        unavailable=imp("state.unavailable"), clock=imp("utils.clock"),
        pod_utils=imp("utils.pod"), topology=imp("provisioning.topology"),
        problem_state=imp("provisioning.problem_state"),
        plane=imp("state.plane"), audit=imp("state.audit"),
        mesh=imp("parallel.mesh"), registry=imp("metrics.registry"),
        tracer=imp("obs.tracer"))


def state_cluster_view(root: str, store, cluster):
    """The provisioner's StateClusterView over a store + cluster state: the
    JAX package's own class, and for the port the same few lines over the
    port's ClusterView (the port's provisioner is not carried yet)."""
    if root == JAX:
        from karpenter_tpu.provisioning.provisioner import StateClusterView
        return StateClusterView(store, cluster)
    w = warm_pkg(root)
    o = pkg(root).objects

    class StateClusterView(w.topology.ClusterView):
        def __init__(self, store, cluster):
            self.store = store
            self.cluster = cluster

        def list_pods(self, namespace, selector):
            return self.store.list(
                o.Pod, namespace=namespace,
                predicate=lambda p: selector.matches(p.labels)
                and w.pod_utils.is_active(p) and w.pod_utils.is_scheduled(p))

        def node_labels(self, node_name):
            sn = self.cluster._node_by_name(node_name)
            return sn.labels() if sn is not None else None

        def for_pods_with_anti_affinity(self):
            for p in self.cluster.anti_affinity_pods():
                if w.pod_utils.is_scheduled(p):
                    labels = self.node_labels(p.spec.node_name)
                    if labels is not None:
                        yield p, labels

    return StateClusterView(store, cluster)


def cpu_mesh(root: str, n: int):
    """An n-slot solver mesh on the CPU: the JAX package's over the
    conftest's virtual CPU devices, the port's over one CPU device
    repeated."""
    m = warm_pkg(root).mesh
    if root == JAX:
        return m.make_solver_mesh(n)
    import torch
    return m.make_solver_mesh(devices=[torch.device("cpu")] * n)


def digest(r, batch):
    """Full decision digest by pod NAME (uids differ across packages):
    launch claims, existing-node fills, errors."""
    by_uid = {p.uid: p.metadata.name for p in batch}
    return (sorted(
        (nc.template.nodepool_name,
         tuple(sorted(nc.requirements.get(
             "topology.kubernetes.io/zone").values)),
         tuple(it.name for it in nc.instance_type_options),
         len(nc.pods),
         tuple(sorted(p.metadata.name for p in nc.pods)))
        for nc in r.new_nodeclaims),
        sorted((en.name, tuple(sorted(p.metadata.name for p in en.pods)))
               for en in r.existing_nodes if en.pods),
        sorted((by_uid[u], msg) for u, msg in r.pod_errors.items()))


def deployment(root: str, name, n, cpu="250m", spread_key=None,
               host_spread=False):
    k = pkg(root)
    o, L = k.objects, k.labels
    labels = {"app": name}
    sel = o.LabelSelector(match_labels=dict(labels))
    spread = []
    if spread_key == "zone":
        spread = [o.TopologySpreadConstraint(
            topology_key=L.LABEL_TOPOLOGY_ZONE, max_skew=1,
            label_selector=sel)]
    elif host_spread:
        spread = [o.TopologySpreadConstraint(
            topology_key=L.LABEL_HOSTNAME, max_skew=1, label_selector=sel)]
    return [o.Pod(metadata=o.ObjectMeta(name=f"{name}-{i}",
                                        namespace="default",
                                        labels=dict(labels)),
                  spec=o.PodSpec(topology_spread_constraints=list(spread)),
                  container_requests=[k.res.parse_list(
                      {"cpu": cpu, "memory": "128Mi"})])
            for i in range(n)]


class ChurnEnv:
    """tests/test_problem_state.py's ChurnEnv for either package: a live
    cluster (store + informers + state) plus a persistent ProblemState;
    solve_pair() runs the delta path and a cold control on identical
    inputs and asserts identical decisions. ``mesh`` (from cpu_mesh) puts
    both solves on a mesh."""

    def __init__(self, root: str, n_nodes=4, pods_per_node=2, catalog=None,
                 mesh=None):
        k, w = pkg(root), warm_pkg(root)
        self.root, self.k, self.w = root, k, w
        self.mesh = mesh
        self.clock = w.clock.FakeClock()
        self.store = w.store.Store(self.clock)
        self.cluster = w.cluster.Cluster(self.store, self.clock)
        w.informers.wire_informers(self.store, self.cluster)
        self.catalog = catalog if catalog is not None \
            else k.kwok.construct_instance_types()
        self.pool = nodepool(root, "default")
        self.ps = w.problem_state.ProblemState()
        self.registry = w.unavailable.UnavailableOfferings(clock=self.clock)
        self.bound = {}
        self._seq = 0
        self.node_type = next(it for it in self.catalog
                              if it.capacity.get("cpu") == 4000)
        for i in range(n_nodes):
            self.add_node(i, pods_per_node)

    def add_node(self, i, pods_per_node=0):
        k, w = self.k, self.w
        L, o, nc_mod = k.labels, k.objects, w.nodeclaim
        name = f"churn-node-{i:03d}"
        labels = {
            L.LABEL_HOSTNAME: name,
            L.NODEPOOL_LABEL_KEY: "default",
            L.NODE_INITIALIZED_LABEL_KEY: "true",
            L.NODE_REGISTERED_LABEL_KEY: "true",
            L.LABEL_INSTANCE_TYPE: self.node_type.name,
            L.LABEL_TOPOLOGY_ZONE: f"test-zone-{'abc'[i % 3]}",
            L.CAPACITY_TYPE_LABEL_KEY: L.CAPACITY_TYPE_ON_DEMAND,
        }
        nc = nc_mod.NodeClaim(
            metadata=o.ObjectMeta(name=f"churn-nc-{i:03d}", namespace="",
                                  labels=dict(labels)),
            spec=nc_mod.NodeClaimSpec())
        nc.status.provider_id = f"churn://{i}"
        nc.status.node_name = name
        for cond in (nc_mod.COND_LAUNCHED, nc_mod.COND_REGISTERED,
                     nc_mod.COND_INITIALIZED):
            nc.conditions.set_true(cond, now=self.clock.now())
        self.store.create(nc)
        self.store.create(o.Node(
            metadata=o.ObjectMeta(name=name, namespace="", labels=labels),
            spec=o.NodeSpec(provider_id=f"churn://{i}"),
            status=o.NodeStatus(capacity=dict(self.node_type.capacity),
                                allocatable=self.node_type.allocatable())))
        self.bound.setdefault(name, [])
        for _ in range(pods_per_node):
            self.bind_pod(name)
        return name

    def bind_pod(self, node_name, labels=None):
        o = self.k.objects
        self._seq += 1
        p = o.Pod(metadata=o.ObjectMeta(name=f"bound-{self._seq}",
                                        namespace="default",
                                        labels=dict(labels or {"warm": "w"})),
                  spec=o.PodSpec(node_name=node_name),
                  container_requests=[self.k.res.parse_list(
                      {"cpu": "200m", "memory": "128Mi"})])
        self.store.create(p)
        self.bound[node_name].append(p)
        return p

    def complete_bound(self, node_name):
        if self.bound.get(node_name):
            self.store.delete(self.bound[node_name].pop())

    def delete_node(self, name):
        o, nc_mod = self.k.objects, self.w.nodeclaim
        node = self.store.get(o.Node, name)
        if node is not None:
            self.store.delete(node)
        nc = self.store.get(nc_mod.NodeClaim, name.replace("node", "nc"))
        if nc is not None:
            self.store.delete(nc)
        self.bound.pop(name, None)

    def live_nodes(self):
        return [sn for sn in self.cluster.state_nodes() if not sn.deleting()]

    def scheduler(self, ps, unavailable=True, state_nodes=None, **kw):
        kw.setdefault("mesh", self.mesh)
        return scheduler(
            self.root, [self.pool], {"default": self.catalog},
            state_nodes=(self.live_nodes() if state_nodes is None
                         else state_nodes),
            cluster=state_cluster_view(self.root, self.store, self.cluster),
            unavailable=self.registry if unavailable else None,
            problem_state=ps, **kw)

    def solve_pair(self, batch):
        """(delta results, delta scheduler): decisions asserted identical
        to a ProblemState-free cold solve of the same inputs."""
        ts = self.scheduler(self.ps)
        r = ts.solve(batch)
        cold = self.scheduler(None)
        r_cold = cold.solve(batch)
        assert digest(r, batch) == digest(r_cold, batch), \
            "delta solve diverged from cold solve"
        assert ts.fallback_reason == cold.fallback_reason
        return r, ts


class ChurnPair:
    """One ChurnEnv per package, driven in lockstep: every operation runs on
    both, and every solve_pair asserts delta == cold inside each package and
    the same decisions across the two."""

    def __init__(self, mesh_slots=0, **kw):
        self.envs = {}
        for root in ROOTS:
            mesh = cpu_mesh(root, mesh_slots) if mesh_slots else None
            self.envs[root] = ChurnEnv(root, mesh=mesh, **kw)

    def __iter__(self):
        return iter(self.envs.values())

    def do(self, fn):
        for env in self.envs.values():
            fn(env)

    def solve_pair(self, make_batch):
        """make_batch(root) -> the pods; returns {root: scheduler}."""
        digests, schedulers = {}, {}
        for root, env in self.envs.items():
            batch = make_batch(root)
            r, ts = env.solve_pair(batch)
            digests[root] = digest(r, batch)
            schedulers[root] = ts
        assert digests[JAX] == digests[PORT], \
            "the port's warm solve diverged from the JAX package's"
        return schedulers

    def last(self, key):
        got = {root: env.ps.last.get(key) for root, env in self.envs.items()}
        assert got[JAX] == got[PORT], (key, got)
        return got[PORT]

    def encode_kind(self, schedulers):
        kinds = {root: ts.encode_kind for root, ts in schedulers.items()}
        assert kinds[JAX] == kinds[PORT], kinds
        return kinds[PORT]


# --------------------------------------------------------------------------
# the provisioner and disruption loops: a live cluster per package, its
# objects fabricated directly (no controller roster), so both packages see
# the same store from the same calls
# --------------------------------------------------------------------------

def live_pkg(root: str) -> SimpleNamespace:
    imp = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    return SimpleNamespace(
        provisioner=imp("provisioning.provisioner"),
        controller=imp("disruption.controller"),
        helpers=imp("disruption.helpers"), methods=imp("disruption.methods"),
        prefix=imp("disruption.prefix"), validation=imp("disruption.validation"),
        policy=imp("api.policy"), types=imp("cloudprovider.types"))


class CatalogProvider:
    """The one cloud-provider call the provisioner and the disruption
    methods make: each pool's instance types (``its`` by pool name, or one
    list for every pool)."""

    def __init__(self, its):
        self.its = its

    def get_instance_types(self, nodepool):
        if isinstance(self.its, dict):
            return self.its.get(nodepool.name, [])
        return self.its


class LiveEnv:
    """Store + informers + cluster state on a FakeClock, a Provisioner (the
    port's on the CPU) and a DisruptionController over them. Nodes, claims
    and pods are created straight into the store under the names given, so
    two packages' envs hold the same objects."""

    def __init__(self, root: str, its, pools=(), spot_to_spot=False):
        k, w, lv = pkg(root), warm_pkg(root), live_pkg(root)
        self.root, self.k, self.w, self.lv = root, k, w, lv
        self.clock = w.clock.FakeClock()
        self.store = w.store.Store(self.clock)
        self.cluster = w.cluster.Cluster(self.store, self.clock)
        w.informers.wire_informers(self.store, self.cluster)
        self.provider = CatalogProvider(its)
        self.unavailable = w.unavailable.UnavailableOfferings(
            clock=self.clock)
        kw = {"device": "cpu"} if root == PORT else {}
        self.provisioner = lv.provisioner.Provisioner(
            self.store, self.cluster, self.provider, self.clock,
            unavailable=self.unavailable, **kw)
        self.queue = lv.controller.OrchestrationQueue(self.store,
                                                      self.cluster, self.clock)
        self.disruption = lv.controller.DisruptionController(
            self.store, self.cluster, self.provisioner, self.queue,
            self.clock, spot_to_spot_enabled=spot_to_spot)
        for p in pools:
            self.store.create(p)

    def pool(self, requirements=()):
        """consolidation_test.go's default pool: WhenEmptyOrUnderutilized,
        a 100% budget, consolidateAfter 0."""
        p = nodepool(self.root, "default", requirements=requirements)
        p.spec.disruption.budgets = [self.k.nodepool.Budget(nodes="100%")]
        p.spec.disruption.consolidate_after = 0.0
        self.store.create(p)
        return p

    def node(self, name, it, capacity_type="on-demand", zone="test-zone-a",
             alloc=None, initialized=True, consolidatable=True,
             drifted=False, labels=None):
        """expectations.make_nodeclaim_and_node: a claim carrying its pool's
        hash (or the Drifted condition) and a linked node; an uninitialized
        node keeps a startup taint. ``alloc``: quantities as strings, or
        resources already parsed; ``labels``: more labels of both."""
        k, L, o = self.k, self.k.labels, self.k.objects
        nc_mod = self.w.nodeclaim
        alloc = alloc or {"cpu": "32", "memory": "128Gi", "pods": "110"}
        if any(isinstance(v, str) for v in alloc.values()):
            alloc = k.res.parse_list(alloc)
        labels = {L.NODEPOOL_LABEL_KEY: "default",
                  L.LABEL_INSTANCE_TYPE: it if isinstance(it, str)
                  else it.name,
                  L.CAPACITY_TYPE_LABEL_KEY: capacity_type,
                  L.LABEL_TOPOLOGY_ZONE: zone, L.LABEL_HOSTNAME: name,
                  **(labels or {})}
        annotations = {}
        live_pool = self.store.get(k.nodepool.NodePool, "default")
        if live_pool is not None and not drifted:
            annotations[L.NODEPOOL_HASH_ANNOTATION_KEY] = \
                live_pool.static_hash()
            annotations[L.NODEPOOL_HASH_VERSION_ANNOTATION_KEY] = \
                k.nodepool.NODEPOOL_HASH_VERSION
        taints = [] if initialized else [
            o.Taint(key="fab.test/uninitialized", value="true")]
        pid = f"fab://{name}"
        nc = nc_mod.NodeClaim(
            metadata=o.ObjectMeta(name=name, labels=dict(labels),
                                  annotations=annotations),
            spec=nc_mod.NodeClaimSpec(startup_taints=list(taints)),
            status=nc_mod.NodeClaimStatus(provider_id=pid, node_name=name,
                                          capacity=dict(alloc),
                                          allocatable=dict(alloc)))
        now = self.clock.now()
        conds = [nc_mod.COND_LAUNCHED, nc_mod.COND_REGISTERED]
        if initialized:
            conds.append(nc_mod.COND_INITIALIZED)
        if consolidatable:
            conds.append(nc_mod.COND_CONSOLIDATABLE)
        if drifted:
            conds.append(nc_mod.COND_DRIFTED)
        for cond in conds:
            nc.conditions.set_true(cond, now=now)
        node_labels = dict(labels)
        if initialized:
            node_labels[L.NODE_INITIALIZED_LABEL_KEY] = "true"
        node = o.Node(
            metadata=o.ObjectMeta(name=name, labels=node_labels,
                                  finalizers=[L.TERMINATION_FINALIZER]),
            spec=o.NodeSpec(provider_id=pid, taints=list(taints)),
            status=o.NodeStatus(capacity=dict(alloc),
                                allocatable=dict(alloc)))
        self.store.create(nc)
        self.store.create(node)
        return nc, node

    def bind(self, node_name, name, cpu="100m", memory="128Mi", labels=None):
        p = pod(self.root, name, cpu, memory, labels)
        p.spec.node_name = node_name
        p.status.phase = "Running"
        self.store.create(p)
        return p

    def pending(self, name, cpu="100m", memory="128Mi"):
        p = pod(self.root, name, cpu, memory)
        self.store.create(p)
        return p

    def provision(self):
        """One provisioning pass, run once the batcher window has passed:
        the first reconcile opens the window, the clock steps past its idle
        time, the second reconcile solves."""
        self.provisioner.reconcile()
        self.clock.step(self.lv.provisioner.BATCH_IDLE_SECONDS + 0.1)
        return self.provisioner.reconcile()


def underutilized_fleet(root: str, n: int) -> LiveEnv:
    """chip_smoke.py's underutilized_fleet (BASELINE config 4) at n nodes:
    consolidatable 4-cpu amd64 nodes over the kwok catalog, each holding
    one 200m / 128Mi pod."""
    its = pkg(root).kwok.construct_instance_types()
    env = LiveEnv(root, its)
    env.pool()
    big = next(it for it in its if it.capacity.get("cpu") == 4000
               and "amd64-linux" in it.name)
    for i in range(n):
        env.node(f"bench-node-{i:05d}", big, alloc=big.allocatable())
    for i in range(n):
        env.bind(f"bench-node-{i:05d}", f"bench-pod-{i}", cpu="200m")
    env.clock.step(600)
    return env


def stuck_fleet(root: str, n: int, prefix: str = "single") -> LiveEnv:
    """chip_smoke.py's stuck_fleet (bench.py's single-node and
    disruption-scale shape) at n nodes: an on-demand catalog, n - 1 nodes
    each holding one pod that fits nowhere else, and one last node whose
    two small pods fit the others' headroom."""
    k = pkg(root)
    its = k.kwok.construct_instance_types()
    for it in its:
        it.offerings = k.kwok.Offerings(
            [o for o in it.offerings
             if o.capacity_type == k.labels.CAPACITY_TYPE_ON_DEMAND])
    env = LiveEnv(root, its)
    env.pool()

    def od_price(it):
        return min((o.price for o in it.offerings if o.available),
                   default=float("inf"))

    ref = next(it for it in its
               if it.capacity.get("cpu") == 4000 and "amd64-linux" in it.name)
    stuck = ref.allocatable()["cpu"] - 300
    big = min((it for it in its if it.allocatable().get("cpu", 0) >= stuck),
              key=od_price)
    small = min((it for it in its if it.capacity.get("cpu") == 1000),
                key=od_price)
    for i in range(n):
        it = big if i < n - 1 else small
        env.node(f"{prefix}-node-{i:05d}", it, alloc=it.allocatable())
    for i in range(n - 1):
        env.bind(f"{prefix}-node-{i:05d}", f"{prefix}-pod-{i}",
                 cpu=f"{stuck}m")
    for j in range(2):
        env.bind(f"{prefix}-node-{n - 1:05d}", f"{prefix}-winner-{j}",
                 cpu="200m")
    env.clock.step(600)
    return env


def provisioning_digest(env: LiveEnv) -> tuple:
    """What provisioning passes left behind, by name: the NodeClaims they
    created (their numbered names aside: pool, requirements, requests) with
    the pods nominated to each, the pods bound to existing nodes, and the
    last pass's pod errors."""
    k = env.k
    nominated: dict = {}
    for pod_key, nc_name in env.provisioner.nominations.items():
        nominated.setdefault(nc_name, []).append(pod_key)
    claims = sorted(
        (nc.metadata.labels.get(k.labels.NODEPOOL_LABEL_KEY, ""),
         tuple(sorted((r.key, r.operator, tuple(sorted(r.values)))
                      for r in nc.spec.requirements)),
         tuple(sorted(nc.spec.resources_requests.items())),
         tuple(sorted(nominated.get(nc.name, ()))))
        for nc in env.store.list(env.w.nodeclaim.NodeClaim)
        if not nc.status.provider_id)
    bound = sorted((p.metadata.name, p.spec.node_name)
                   for p in env.store.list(k.objects.Pod)
                   if p.spec.node_name)
    results = env.provisioner.last_results
    by_uid = {p.uid: p.metadata.name
              for p in env.store.list(k.objects.Pod)}
    errors = sorted((by_uid.get(u, u), msg)
                    for u, msg in (results.pod_errors.items()
                                   if results is not None else ()))
    return claims, bound, errors


def command_summary(env: LiveEnv, cmd, results=None) -> dict:
    """A disruption command by name: decision, candidates, replacement
    instance-type options and the simulation's pod errors by pod name."""
    errors = []
    if results is not None and getattr(results, "pod_errors", None):
        names = {p.uid: p.metadata.name
                 for p in env.store.list(env.k.objects.Pod)}
        errors = sorted(names.get(u, u) for u in results.pod_errors)
    return {"decision": cmd.decision,
            "candidates": [c.name for c in cmd.candidates],
            "replacements": [[it.name for it in r.instance_type_options]
                             for r in cmd.replacements],
            "pod_errors": errors}


class MinValuesReq:
    """A pool template requirement with minValues (expectations.py's
    MinValuesReq: NodeSelectorRequirement is frozen and has no min_values;
    template ingestion reads it with getattr)."""

    def __init__(self, key: str, operator: str, values=(), min_values=None):
        self.key = key
        self.operator = operator
        self.values = tuple(values)
        self.min_values = min_values


# -- the solver sidecar, for either package -----------------------------------

@contextmanager
def sidecar_server(root: str, replica=None, **kw):
    """A solver sidecar of ``root``'s package on 127.0.0.1 (the port's on
    the CPU unless ``device`` is given), yielding (server, address). Once
    the block ends the server is stopped, its replica's sessions dropped
    and the collector unfrozen as it was: serve() freezes and disables it
    for the process, and one test worker runs many modules."""
    import gc
    srv = importlib.import_module(f"{root}.sidecar.server")
    if root == PORT:
        kw.setdefault("device", "cpu")
    frozen = gc.get_freeze_count()
    server, port = srv.serve(port=0, replica=replica, **kw)
    try:
        yield server, f"127.0.0.1:{port}"
    finally:
        server.stop(grace=None)
        rep = replica if replica is not None else srv.DEFAULT_REPLICA
        with rep.sessions_lock:
            rep.sessions.clear()
        if not frozen:
            gc.unfreeze()


#: the response riders that carry a wall time or a trace id: the rest of a
#: response frame is a function of the session's state alone
TIMING_RIDERS = ("queue_wait_ms", "trace_id")


def response_content(root: str, frame: bytes) -> tuple:
    """A SolveSession response frame without its timing riders: (header,
    blobs), the fallback attribution's seconds dropped too."""
    wire = importlib.import_module(f"{root}.sidecar.wire")
    header, blobs = wire.unpack(frame)
    header = {k: v for k, v in header.items() if k not in TIMING_RIDERS}
    attribution = dict(header.get("fallback_attribution") or {})
    for k in ("tensor_seconds", "host_seconds"):
        attribution.pop(k, None)
    header["fallback_attribution"] = attribution
    return header, {k: bytes(v) for k, v in blobs.items()}


def keep_responses(session) -> list:
    """The raw responses a SolverSession (either package's) receives from
    here on, in order."""
    kept, call = [], session._call

    def keeping(method, payload):
        out = call(method, payload)
        kept.append((method, out))
        return out
    session._call = keeping
    return kept


def reset_claim_names(monkeypatch, roots=ROOTS) -> None:
    """Both packages' claim-name sequences (which name claims wherever
    results are decoded) restart at 1."""
    import itertools
    for root in roots:
        for name in ("provisioning.scheduler",
                     "provisioning.tensor_scheduler"):
            monkeypatch.setattr(importlib.import_module(f"{root}.{name}"),
                                "claim_name_seq", itertools.count(1))


@pytest.fixture(autouse=True, scope="module")
def sidecar_state_kept():
    """The process as a module that serves sidecars found it, once its
    tests end (autouse where a module imports it): serve() freezes and
    disables the collector for the process, and a server started on a
    package's default replica leaves its sessions in that module-global
    table."""
    import gc
    enabled, frozen = gc.isenabled(), gc.get_freeze_count()
    yield
    for root in ROOTS:
        srv = importlib.import_module(f"{root}.sidecar.server")
        with srv.DEFAULT_REPLICA.sessions_lock:
            srv.DEFAULT_REPLICA.sessions.clear()
    if enabled:
        gc.enable()
    if not frozen:
        gc.unfreeze()


@contextmanager
def plain_calls_counted(names):
    """Inside the block the port's wrappers ``names`` count their plain
    calls in kernels.LAUNCHES, as their kernels count launches on the card
    (chip_smoke.py's phases rehearsed on the CPU)."""
    kernels = importlib.import_module(f"{PORT}.ops.kernels")
    saved = {name: getattr(kernels, name) for name in names}

    def counting(name, wrapper):
        def call(*a, **kw):
            kernels.LAUNCHES[name] += 1
            return wrapper(*a, **kw)
        return call
    for name, wrapper in saved.items():
        setattr(kernels, name, counting(name, wrapper))
    try:
        yield kernels
    finally:
        for name, wrapper in saved.items():
            setattr(kernels, name, wrapper)
