"""Whole-solve parity: the port's TensorScheduler (device="cpu", i.e. the
kernels' plain versions) against the JAX package's on the same inputs,
compared through the JAX package's decision_digest — launch claims,
existing-node placements, errors by pod name, fallback reason and the
tensor/host partition."""

import dataclasses
import random

import pytest

from karpenter_tpu.flightrec.record import decision_digest as jdigest
from karpenter_tpu_torch.flightrec.record import decision_digest as tdigest

from test_torch_support import (JAX, PORT, ROOTS, bench_pods, bench_workload,
                                default_pool, existing_nodes, mini_workload,
                                nodepool, pkg, pod, restricted_workload,
                                scheduler)
from test_torch_support import device_series_kept  # noqa: F401 (autouse)

ZONES = ("test-zone-a", "test-zone-b", "test-zone-c")
CPUS = ("100m", "250m", "500m", "1", "1500m", "2", "3")
MEMS = ("128Mi", "256Mi", "512Mi", "1Gi", "2Gi", "4Gi")
# every seed of test_parity_fuzzer.py's corpus: between them they cover
# several pools, taints, zone requirements, limits, selectors, spreads,
# affinities and unschedulable pods
SEEDS = tuple(range(1000, 1040))


def _spread(root, key, max_skew, label_val, min_domains=None):
    o = pkg(root).objects
    kw = {} if min_domains is None else {"min_domains": min_domains}
    return o.TopologySpreadConstraint(
        topology_key=key, max_skew=max_skew,
        label_selector=o.LabelSelector(match_labels={"app": label_val}), **kw)


def _term(root, key, label_val):
    o = pkg(root).objects
    return o.PodAffinityTerm(topology_key=key, label_selector=o.LabelSelector(
        match_labels={"app": label_val}))


# -- test_parity_fuzzer.py's generator, for either package -------------------

def gen_nodepools(rng: random.Random, root: str):
    k = pkg(root)
    pools = []
    for i in range(rng.choice((1, 1, 1, 2, 2, 3))):
        kwargs = {"name": f"pool-{i}"}
        if rng.random() < 0.35:
            kwargs["taints"] = [k.objects.Taint(key=f"team-{i}", value="x")]
        if rng.random() < 0.3:
            zones = rng.sample(ZONES, rng.choice((1, 2)))
            kwargs["requirements"] = [k.objects.NodeSelectorRequirement(
                key=k.labels.LABEL_TOPOLOGY_ZONE, operator="In",
                values=tuple(zones))]
        if rng.random() < 0.25:
            kwargs["limits"] = {"cpu": str(rng.choice((8, 16, 64)))}
        kwargs["weight"] = rng.choice((None, 1, 10, 50))
        pools.append(nodepool(root, **kwargs))
    return pools


def gen_pods(rng: random.Random, pools, root: str):
    k = pkg(root)
    L = k.labels
    pods = []
    for d in range(rng.randint(2, 6)):
        n = rng.randint(3, 18)
        label_val = f"d{d}"
        kwargs = {"cpu": rng.choice(CPUS), "memory": rng.choice(MEMS),
                  "labels": {"app": label_val}}
        tainted = [p for p in pools if p.spec.template.spec.taints]
        if tainted and rng.random() < 0.5:
            kwargs["tolerations"] = [
                k.objects.Toleration(key=t.key, operator="Exists")
                for p in tainted for t in p.spec.template.spec.taints]
        if rng.random() < 0.25:
            kwargs["node_selector"] = {L.LABEL_TOPOLOGY_ZONE: rng.choice(ZONES)}
        shape = rng.random()
        if shape < 0.2:
            kwargs["spread"] = [_spread(root, L.LABEL_TOPOLOGY_ZONE,
                                        rng.choice((1, 1, 2)), label_val)]
        elif shape < 0.3:
            kwargs["spread"] = [_spread(root, L.LABEL_HOSTNAME, 1, label_val)]
        elif shape < 0.4:
            kwargs["pod_affinity"] = [_term(
                root, rng.choice((L.LABEL_TOPOLOGY_ZONE, L.LABEL_HOSTNAME)),
                label_val)]
        elif shape < 0.5:
            kwargs["pod_anti_affinity"] = [_term(root, L.LABEL_HOSTNAME,
                                                 label_val)]
        if rng.random() < 0.06:
            kwargs["cpu"] = "1000"  # unschedulable: no type holds 1000 cores
        for i in range(n):
            pods.append(pod(root, f"fz-{d}-{i:03d}", **kwargs))
    return pods


def gen_catalog(rng: random.Random, root: str):
    its = pkg(root).kwok.construct_instance_types()
    n = rng.choice((24, 48, 96, 144))
    if n >= len(its):
        return its
    off = rng.choice((0, 0, 4, 8))
    return its[off:off + n]


def fuzz_case(seed: int, root: str):
    rng = random.Random(seed)
    pools = gen_nodepools(rng, root)
    its = {p.name: gen_catalog(rng, root) for p in pools}
    return pools, its, gen_pods(random.Random(seed + 1), pools, root)


def solve_digest(root: str, pools, its, pods, **kw):
    ts = scheduler(root, pools, its, **kw)
    results = ts.solve(pods)
    return jdigest(results, pods, ts.fallback_reason, ts.partition), \
        (results, ts)


def assert_same_decisions(make, **kw):
    """make(root) -> (pools, its, pods[, state_nodes]); solve on both."""
    got = {}
    for root in ROOTS:
        case = make(root)
        pools, its, pods = case[:3]
        nodes = case[3] if len(case) > 3 else ()
        got[root] = solve_digest(root, pools, its, pods, state_nodes=nodes,
                                 **kw) + (pods,)
    want, (_, jts), _ = got[JAX]
    have, (results, tts), pods = got[PORT]
    assert have == want
    assert (tts.fallback_reason, tts.partition) == \
        (jts.fallback_reason, jts.partition)
    # the port's own copy of the digest agrees with the reference's
    assert tdigest(results, pods, tts.fallback_reason, tts.partition) == have
    return have


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_seed_decisions(seed):
    """Production configuration (fallback armed), as the fuzzer runs it."""
    assert_same_decisions(lambda root: fuzz_case(seed, root))


def test_fuzz_seeds_cover_the_feature_space():
    saw = set()
    for seed in SEEDS:
        pools, _, pods = fuzz_case(seed, PORT)
        saw |= {"multi_pool"} if len(pools) > 1 else set()
        saw |= {"taints"} if any(p.spec.template.spec.taints
                                 for p in pools) else set()
        saw |= {"limits"} if any(p.spec.limits for p in pools) else set()
        saw |= {"selector"} if any(p.spec.node_selector for p in pods) \
            else set()
        saw |= {"spread"} if any(p.spec.topology_spread_constraints
                                 for p in pods) else set()
        saw |= {"affinity"} if any(p.spec.affinity is not None
                                   for p in pods) else set()
        saw |= {"unschedulable"} if any(p.requests().get("cpu", 0) >= 10**6
                                        for p in pods) else set()
    assert saw == {"multi_pool", "taints", "limits", "selector", "spread",
                   "affinity", "unschedulable"}


# -- test_kernel_coverage.py shapes, forced onto the tensor path -------------

def _coverage(root, pods_of):
    its = pkg(root).kwok.construct_instance_types()[:48]
    return [nodepool(root)], {"default": its}, pods_of(root)


def _min_domains_pods(root):
    """minDomains above the zone count floors the global minimum to zero:
    one pod per zone, the rest unschedulable."""
    L = pkg(root).labels
    return [pod(root, f"md-{i}", labels={"app": "demo"},
                spread=[_spread(root, L.LABEL_TOPOLOGY_ZONE, 1, "demo",
                                min_domains=6)]) for i in range(8)]


def _multi_constraint_pods(root):
    """Zonal spread plus hostname anti-affinity: one pod per node, zones
    balanced."""
    L = pkg(root).labels
    return [pod(root, f"mc-{i}", labels={"app": "demo"},
                spread=[_spread(root, L.LABEL_TOPOLOGY_ZONE, 1, "demo")],
                pod_anti_affinity=[_term(root, L.LABEL_HOSTNAME, "demo")])
            for i in range(8)]


@pytest.mark.parametrize("pods_of", [_min_domains_pods,
                                     _multi_constraint_pods],
                         ids=["min_domains", "multi_constraint"])
def test_kernel_coverage_decisions(pods_of):
    d = assert_same_decisions(lambda root: _coverage(root, pods_of),
                              force_tensor=True)
    assert d["fallback_reason"] == "" and d["partition"][1] == 0
    assert d["claims"]


# -- the slice's own workloads ------------------------------------------------

def test_mini_workload_decisions():
    """Two pools (one limited) with existing nodes initialized and not."""
    def make(root):
        pools, its, nodes, pods = mini_workload(root)
        return pools, its, pods, nodes
    d = assert_same_decisions(make, force_tensor=True)
    assert d["existing"], "no pod placed on an existing node"


def test_restricted_workload_decisions():
    """Zone- and capacity-type-restricted pools against node selectors."""
    def make(root):
        pools, its, nodes, pods = restricted_workload(root)
        return pools, its, pods, nodes
    d = assert_same_decisions(make, force_tensor=True)
    assert d["claims"] and d["partition"][1] == 0


def test_bench_mix_with_existing_nodes_decisions():
    """chip_smoke's workload at a small size: the benchmark mix against
    existing nodes on four zones and both capacity types."""
    def make(root):
        pools, its, nodes, pods = bench_workload(root, 540, 120, n_nodes=24,
                                                 n_deploys=18)
        return pools, its, pods, nodes
    d = assert_same_decisions(make, force_tensor=True)
    assert d["existing"] and d["claims"]


def test_bench_mix_absorbed_by_existing_nodes_decisions():
    """Existing nodes with room for every pod, as in chip_smoke's solve
    against 5,000 nodes: no new claims, and the only errors are hostname
    self-affinity pods (kind 3) past the capacity of the one existing node
    their deployment's first pod landed on — the same on both packages."""
    def make(root):
        pools, its, nodes, pods = bench_workload(root, 1080, 2000,
                                                 n_nodes=150)
        return pools, its, pods, nodes
    d = assert_same_decisions(make, force_tensor=True)
    assert d["existing"] and not d["claims"] and d["errors"]
    for name, msg in d["errors"].items():
        assert int(name.split("-")[1]) % 9 == 3, name
        assert msg == "hostname pod affinity: node capacity exhausted", msg


@pytest.mark.parametrize("n_nodes,claims,existing,errors",
                         [(0, 513, 0, 1336), (5000, 0, 1352, 4204)],
                         ids=["cold", "existing_nodes"])
def test_north_star_workload_decisions(n_nodes, claims, existing, errors):
    """chip_smoke.py's north-star solve at full size: 49,920 pods of the
    benchmark mix x 2,000 types, cold and against 5,000 existing nodes,
    forced onto the tensor path."""
    def make(root):
        pools, its, nodes, pods = bench_workload(root, 49920, 2000,
                                                 n_nodes=n_nodes)
        return pools, its, pods, nodes
    d = assert_same_decisions(make, force_tensor=True)
    assert d["fallback_reason"] == "" and d["partition"] == [49920, 0]
    assert (len(d["claims"]), len(d["existing"]), len(d["errors"])) == \
        (claims, existing, errors)


def _plain(obj):
    """A dataclass as nested plain values, object ids left out."""
    if dataclasses.is_dataclass(obj):
        obj = dataclasses.asdict(obj)
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items() if k != "uid"}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def test_smoke_workload_equals_the_parity_builders():
    """chip_smoke.py builds the port's workload alone; the builders above
    rebuild it for either package, so the two must stay equal."""
    import chip_smoke
    k = pkg(PORT)
    catalog = k.kwok.construct_catalog(40)
    assert _plain(chip_smoke.bench_pods(180, 18)) == \
        _plain(bench_pods(PORT, 180, 18))
    assert _plain(chip_smoke.default_pool()) == _plain(default_pool(PORT))
    mine = chip_smoke.existing_nodes(catalog, 12)
    theirs = existing_nodes(PORT, catalog, 12)
    assert [(_plain(sn.node), sn.pod_request_total()) for sn in mine] == \
        [(_plain(sn.node), sn.pod_request_total()) for sn in theirs]
