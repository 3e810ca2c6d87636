"""Tenant-isolated NodePools on the port, on the CPU.

- The existing-node toleration matrix, built once per distinct taint set
  (``tensor_scheduler._tol_exist_matrix`` over ``NodeTaints``), equals the
  per-pair loop bit for bit on fuzzed fleets: all three effects, ``Equal``
  and ``Exists`` tolerations, tolerations with no key or no effect, nodes
  with 0-3 taints in varied order, padded columns; through the cold encode
  and through a ``ProblemState`` delta pass.
- The whole solve on a cut of the benchmark's ``kwok500-tenants10k``
  configuration (eight weighted NodePools, six of them tainted team pools,
  pods with tolerations and nodeSelectors, tainted running nodes) gives
  the JAX package's decisions (``decision_digest``)."""

import json
import os
import random
import sys

import numpy as np
import pytest

from karpenter_tpu.flightrec.record import decision_digest as jdigest
from karpenter_tpu_torch.flightrec.record import decision_digest as tdigest
from karpenter_tpu_torch.provisioning import tensor_scheduler as port_ts
from karpenter_tpu_torch.provisioning.problem_state import ProblemState
from karpenter_tpu_torch.scheduling.taints import tolerates

import test_torch_support as support
from test_torch_support import JAX, PORT, ROOTS, nodepool, pod
from test_torch_support import device_series_kept  # noqa: F401 (autouse)
from test_torch_support import tracer_kept  # noqa: F401 (autouse)

ROOT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT_DIR)
from benchmark import spec, tenant_spec  # noqa: E402 (plain records only)
EFFECTS = ("NoSchedule", "PreferNoSchedule", "NoExecute")
KEYS = ("team", "dedicated", "gpu")
VALUES = ("a", "b", "")
HOSTNAME = "kubernetes.io/hostname"
ZONE = "topology.kubernetes.io/zone"


# -- the toleration matrix -----------------------------------------------------

def _pair_loop(groups, taint_lists, total_cols):
    """The toleration matrix one (group, node) pair at a time."""
    out = np.zeros((len(groups), total_cols), dtype=bool)
    out[:, :len(taint_lists)] = True
    for i, nt in enumerate(taint_lists):
        if nt:
            for gi, g in enumerate(groups):
                out[gi, i] = not tolerates(nt, g.pods[0])
    return out


def _taint(o, rng):
    return o.Taint(key=rng.choice(KEYS), value=rng.choice(VALUES),
                   effect=rng.choice(EFFECTS))


def _node_taints(o, rng, shapes):
    """0-3 taints; a node often repeats another's set in another order."""
    if shapes and rng.random() < 0.6:
        nt = list(rng.choice(shapes))
        rng.shuffle(nt)
        return nt
    nt = [_taint(o, rng) for _ in range(rng.choice((0, 0, 1, 1, 2, 3)))]
    shapes.append(nt)
    return nt


def _toleration(o, rng):
    op = rng.choice(("Equal", "Exists"))
    return o.Toleration(
        key="" if op == "Exists" and rng.random() < 0.2 else rng.choice(KEYS),
        operator=op, value=rng.choice(VALUES) if op == "Equal" else "",
        effect=rng.choice(EFFECTS + ("",)))


def _fleet(seed: int, n_nodes: int = 40, n_groups: int = 10):
    """(pools, catalog, state nodes, pods) of the port: seeded taints on
    the nodes, seeded tolerations on each deployment's pods."""
    k = support.pkg(PORT)
    o = k.objects
    rng = random.Random(seed)
    its = k.kwok.construct_instance_types()[:24]
    shapes: list = []
    nodes = []
    for i in range(n_nodes):
        sn = support.state_node(PORT, f"tn-{i:03d}", "default", "8", "32Gi",
                                True, zone=f"test-zone-{'abcd'[i % 4]}")
        sn.node.spec.taints = _node_taints(o, rng, shapes)
        nodes.append(sn)
    pods = []
    for d in range(n_groups):
        tols = [_toleration(o, rng) for _ in range(rng.choice((0, 1, 2, 3)))]
        for j in range(3):
            pods.append(pod(PORT, f"tp-{d}-{j}", cpu=f"{100 * (d + 1)}m",
                            labels={"app": f"d{d}"}, tolerations=tols))
    return [nodepool(PORT)], {"default": its}, nodes, pods


def _groups(pods):
    groups, leftover, reason = port_ts.partition_pods(pods)
    assert groups and not leftover, reason
    return groups


def _assert_tol_exist(problem, groups, nodes):
    cols = problem.exist_avail.shape[0]
    want = _pair_loop(groups, [sn.taints() for sn in nodes], cols)
    got = problem.tol_exist
    assert got.dtype == bool and got.shape[1] == cols > len(nodes)
    np.testing.assert_array_equal(got[:len(groups)], want)
    # pow2-padded group rows never tolerate
    assert not got[len(groups):].any()


@pytest.mark.parametrize("seed", range(12))
def test_grouped_matrix_equals_the_pair_loop_cold(seed):
    pools, its, nodes, pods = _fleet(seed)
    ts = support.scheduler(PORT, pools, its, state_nodes=nodes)
    groups = _groups(pods)
    problem, _, _ = ts.build_problem(groups)
    _assert_tol_exist(problem, groups, nodes)
    # the codes name the same multiset of (key, value, effect) per set
    table = port_ts.NodeTaints([sn.taints() for sn in nodes])
    canon = [sorted((t.key, t.value, t.effect) for t in nt)
             for nt in table.sets]
    assert len({tuple(c) for c in canon}) == len(canon)
    for sn, code in zip(nodes, table.codes):
        nt = sorted((t.key, t.value, t.effect) for t in sn.taints())
        assert (canon[code - 1] if code else []) == nt


@pytest.mark.parametrize("seed", range(100, 112))
def test_grouped_matrix_equals_the_pair_loop_through_a_delta_pass(seed):
    pools, its, nodes, pods = _fleet(seed)
    o = support.pkg(PORT).objects
    rng = random.Random(seed)
    ps = ProblemState()
    groups = _groups(pods)
    first, _, _ = support.scheduler(PORT, pools, its, state_nodes=nodes,
                                    problem_state=ps).build_problem(groups)
    _assert_tol_exist(first, groups, nodes)
    # retaint a few nodes: the next pass re-encodes only those rows
    moved = rng.sample(range(len(nodes)), 5)
    for i in moved:
        nodes[i].node.spec.taints = [_taint(o, rng)
                                     for _ in range(rng.choice((0, 1, 2, 3)))]
        nodes[i].revision += 1
    second, _, _ = support.scheduler(PORT, pools, its, state_nodes=nodes,
                                     problem_state=ps).build_problem(groups)
    assert ps.last["node_rows_reencoded"] == len(moved)
    _assert_tol_exist(second, groups, nodes)
    # and equals the cold path on the same fleet
    cold, _, _ = support.scheduler(PORT, pools, its,
                                   state_nodes=nodes).build_problem(groups)
    np.testing.assert_array_equal(second.tol_exist[:len(groups)],
                                  cold.tol_exist)


def test_the_fuzzed_fleets_cover_the_taint_space():
    saw = set()
    for seed in list(range(12)) + list(range(100, 112)):
        pools, its, nodes, pods = _fleet(seed)
        groups = _groups(pods)
        taints = [sn.taints() for sn in nodes]
        ok = _pair_loop(groups, taints, len(nodes))
        tainted = np.array([bool(nt) for nt in taints])
        saw |= {f"taints:{len(nt)}" for nt in taints}
        saw |= {t.effect for nt in taints for t in nt}
        saw |= {f"tol:{t.operator}:{'key' if t.key else 'nokey'}"
                f":{'effect' if t.effect else 'noeffect'}"
                for p in pods for t in p.spec.tolerations}
        saw |= {"tolerated"} if ok[:, tainted].any() else set()
        saw |= {"refused"} if not ok[:, tainted].all() else set()
        saw |= {"reordered"} if len({tuple(nt) for nt in taints}) > len(
            {tuple(sorted((t.key, t.value, t.effect) for t in nt))
             for nt in taints}) else set()
    assert {"taints:0", "taints:1", "taints:2", "taints:3", *EFFECTS,
            "tol:Equal:key:effect", "tol:Equal:key:noeffect",
            "tol:Exists:key:effect", "tol:Exists:nokey:noeffect",
            "tolerated", "refused", "reordered"} <= saw, saw


def test_an_untainted_fleet_tolerates_every_node():
    pools, its, nodes, pods = _fleet(0)
    for sn in nodes:
        sn.node.spec.taints = []
    groups = _groups(pods)
    problem, _, _ = support.scheduler(PORT, pools, its, state_nodes=nodes
                                      ).build_problem(groups)
    assert problem.tol_exist[:, :len(nodes)].all()
    assert not problem.tol_exist[:, len(nodes):].any()


# -- the whole solve on a cut of the configuration ----------------------------

def _cut_config():
    """kwok500-tenants10k cut to 48 types, 37 nodes a pool (296) and 50
    deployments of 12 pods (600)."""
    with open(os.path.join(ROOT_DIR, "benchmark", "configs",
                           "kwok500-tenants10k.json")) as f:
        cfg = json.load(f)
    cfg["catalog"]["count"] = 48
    cfg["pods"].update(deployments=50, replicas=12)
    cfg["existing_nodes"]["per_pool"] = 37
    return cfg


def _tenant_case(root: str, seed: int):
    """(pools in weight order, catalogs, pods, state nodes) of either
    package, from the benchmark's plain records of the cut configuration."""
    k = support.pkg(root)
    o, L = k.objects, k.labels
    cfg = _cut_config()
    types = spec.catalog(cfg)
    its = k.kwok.construct_catalog(len(types))
    assert [it.name for it in its] == [t["name"] for t in types]
    by_name = {it.name: it for it in its}
    pools = []
    for p in tenant_spec.nodepools(cfg):
        reqs = ([o.NodeSelectorRequirement(key=L.CAPACITY_TYPE_LABEL_KEY,
                                           operator="In",
                                           values=tuple(p["capacity_types"]))]
                if p["capacity_types"] else [])
        pool = nodepool(root, p["name"], requirements=reqs,
                        taints=[o.Taint(key=a, value=b, effect=c)
                                for a, b, c in p["taints"]],
                        weight=p["weight"] or None)
        pool.spec.template.metadata_labels = dict(p["labels"])
        pools.append(pool)
    pools = k.nodepool.order_by_weight(pools)
    burst = tenant_spec.burst(cfg, seed, 0)
    pods = []
    for name in burst["pods"]:
        dep = burst["deployments"][burst["pod_deployment"][name]]
        spread, affinity = _kind_rules(root, dep)
        p = pod(root, name, cpu=f"{dep['cpu']}m",
                memory=str(dep["memory"] // 1000), labels={"app": dep["app"]},
                node_selector=dep["selector"],
                tolerations=[o.Toleration(key=a, value=b, effect=c)
                             for a, b, c in dep["tolerations"]],
                spread=spread)
        p.spec.affinity = affinity
        pods.append(p)
    nodes = []
    for n in tenant_spec.existing_nodes(cfg, types, seed):
        it = by_name[n["type"]]
        labels = {key: it.requirements.get(key).values_list()[0]
                  for key in it.requirements
                  if len(it.requirements.get(key).values_list()) == 1}
        labels.update({HOSTNAME: n["name"], L.NODEPOOL_LABEL_KEY: n["pool"],
                       L.NODE_INITIALIZED_LABEL_KEY: "true", ZONE: n["zone"],
                       L.CAPACITY_TYPE_LABEL_KEY: n["capacity_type"],
                       **n["labels"]})
        sn = k.statenode.StateNode(node=o.Node(
            metadata=o.ObjectMeta(name=n["name"], namespace="",
                                  labels=labels),
            spec=o.NodeSpec(provider_id=f"t://{n['name']}",
                            taints=[o.Taint(key=a, value=b, effect=c)
                                    for a, b, c in n["taints"]]),
            status=o.NodeStatus(capacity=dict(it.capacity),
                                allocatable=dict(it.allocatable()))))
        sn.update_pod(o.Pod(
            metadata=o.ObjectMeta(name=n["pod"], namespace="default"),
            spec=o.PodSpec(node_name=n["name"]),
            container_requests=[dict(n["used"])]))
        nodes.append(sn)
    return pools, {p.name: its for p in pools}, pods, nodes


def _kind_rules(root: str, dep: dict):
    """(spreads, affinity) of a deployment's kind, as the benchmark's
    ``objects._pod_spec`` gives them."""
    o = support.pkg(root).objects
    sel = o.LabelSelector(match_labels={"app": dep["app"]})
    zone_spread = o.TopologySpreadConstraint(topology_key=ZONE, max_skew=1,
                                             label_selector=sel)
    host_anti = o.Affinity(pod_anti_affinity=o.PodAffinity(required=[
        o.PodAffinityTerm(topology_key=HOSTNAME, label_selector=sel)]))
    return {
        "generic": ([], None),
        "zone_spread": ([zone_spread], None),
        "host_spread": ([o.TopologySpreadConstraint(
            topology_key=HOSTNAME, max_skew=1, label_selector=sel)], None),
        "host_affinity": ([], o.Affinity(pod_affinity=o.PodAffinity(
            required=[o.PodAffinityTerm(topology_key=HOSTNAME,
                                        label_selector=sel)]))),
        "zone_affinity": ([], o.Affinity(pod_affinity=o.PodAffinity(
            required=[o.PodAffinityTerm(topology_key=ZONE,
                                        label_selector=sel)]))),
        "host_anti": ([], host_anti),
        "zone_spread_min_domains": ([o.TopologySpreadConstraint(
            topology_key=ZONE, max_skew=1, min_domains=4,
            label_selector=sel)], None),
        "zone_spread_host_anti": ([zone_spread], host_anti),
        "zone_spread_other": ([o.TopologySpreadConstraint(
            topology_key=ZONE, max_skew=1, label_selector=o.LabelSelector(
                match_labels={"app": dep["other_app"]}))], None),
    }[dep["kind"]]


@pytest.mark.parametrize("seed", (1, 2, 2**33 + 7))
def test_tenant_solve_equals_the_jax_package(seed):
    got = {}
    for root in ROOTS:
        pools, its, pods, nodes = _tenant_case(root, seed)
        ts = support.scheduler(root, pools, its, state_nodes=nodes)
        results = ts.solve(pods)
        assert ts.fallback_reason == "" and ts.partition == (len(pods), 0)
        got[root] = (jdigest(results, pods, ts.fallback_reason,
                             ts.partition), results, ts, pods)
    want, _, _, _ = got[JAX]
    have, results, ts, pods = got[PORT]
    assert have == want
    assert tdigest(results, pods, ts.fallback_reason, ts.partition) == have
    # the cut reaches what the cell is for: claims of several pools, pods
    # on the tainted nodes
    pools = {c.template.nodepool_name for c in results.new_nodeclaims}
    assert len(pools) >= 4, pools
    assert any(en.state_node.taints() and en.pods
               for en in results.existing_nodes)
