"""The port's warm path held against the JAX package's: a persistent
ProblemState over the EncodePlane, driven through TensorScheduler.

Every case runs one ChurnEnv per package in lockstep (ChurnPair): each
solve asserts, inside each package, that the delta solve equals a cold solve
of the same inputs, and across the packages that the decisions are the same.
The counters each case checks (rows re-encoded, topology groups counted,
warm prefix restored, cold/delta encode) must also agree between the two.
The cases are tests/test_problem_state.py's, on the port's side by side.
"""

import random

import pytest

from test_torch_support import (JAX, PORT, ROOTS, ChurnEnv, ChurnPair, digest,
                                deployment, nodepool, pkg, scheduler,
                                warm_pkg)
from test_torch_support import device_series_kept  # noqa: F401 (autouse)


def dep(name, n, **kw):
    """A batch maker: the same deployment built for either package."""
    return lambda root: deployment(root, name, n, **kw)


def batch_of(*makers):
    return lambda root: [p for m in makers for p in m(root)]


def plain_pod(root, name, cpu="100m", labels=None, node_selector=None,
              host_ports=None):
    k = pkg(root)
    o = k.objects
    return o.Pod(
        metadata=o.ObjectMeta(name=name, namespace="default",
                              labels=dict(labels or {})),
        spec=o.PodSpec(node_selector=dict(node_selector or {}),
                       host_ports=list(host_ports or [])),
        container_requests=[k.res.parse_list({"cpu": cpu,
                                              "memory": "128Mi"})])


# -- signatures --------------------------------------------------------------


@pytest.mark.parametrize("root", ROOTS)
def test_group_signature_stable_across_passes(root):
    part = pkg(root).grouping.partition_pods
    sig = pkg(root).grouping.group_signature
    g1, _, _ = part(deployment(root, "sig", 3))
    g2, _, _ = part(deployment(root, "sig", 5))
    g3, _, _ = part(deployment(root, "sig", 3, cpu="300m"))
    assert sig(g1[0]) == sig(g2[0])
    assert sig(g1[0]) != sig(g3[0])


# -- node rows ---------------------------------------------------------------


class TestNodeRows:
    def test_dirty_rows_only_reencode(self):
        pair = ChurnPair(n_nodes=4, pods_per_node=1)
        pair.solve_pair(dep("a", 4))
        assert pair.last("node_rows_reencoded") == 4
        pair.solve_pair(dep("a", 5))
        assert pair.last("node_rows_reencoded") == 0
        pair.do(lambda e: e.complete_bound("churn-node-001"))
        pair.solve_pair(dep("a", 5))
        assert pair.last("node_rows_reencoded") == 1

    def test_node_add_and_remove_invalidate_their_rows_only(self):
        pair = ChurnPair(n_nodes=3, pods_per_node=1)
        pair.solve_pair(dep("a", 3))
        pair.do(lambda e: e.add_node(7, pods_per_node=0))
        pair.solve_pair(dep("a", 3))
        assert pair.last("node_rows_reencoded") == 1
        pair.do(lambda e: e.delete_node("churn-node-000"))
        pair.solve_pair(dep("a", 3))
        assert pair.last("node_rows_reencoded") == 0

    def test_daemonset_change_reencodes_all_rows(self):
        pair = ChurnPair(n_nodes=3, pods_per_node=1)
        pair.solve_pair(dep("a", 3))
        for env in pair:
            ds = plain_pod(env.root, "ds-0", cpu="50m")
            ts = env.scheduler(env.ps)
            ts.daemonset_pods = [ds]
            ts.solve(deployment(env.root, "a", 3))
        assert pair.last("node_rows_reencoded") == 3


# -- topology memo -----------------------------------------------------------


def test_topology_counts_memoized_until_revision_bump():
    pair = ChurnPair(n_nodes=3, pods_per_node=1)
    pair.solve_pair(dep("t", 4, spread_key="zone"))
    assert pair.last("topo_groups_counted") == 1
    pair.solve_pair(dep("t", 6, spread_key="zone"))
    assert pair.last("topo_groups_counted") == 0
    pair.do(lambda e: e.bind_pod("churn-node-000", labels={"app": "t"}))
    pair.solve_pair(dep("t", 6, spread_key="zone"))
    assert pair.last("topo_groups_counted") == 1


# -- warm-started packing ----------------------------------------------------


class TestWarmPack:
    def test_identical_batch_full_replay(self):
        pair = ChurnPair(n_nodes=2, pods_per_node=1)
        batch = batch_of(dep("w", 4), dep("x", 3, cpu="500m"))
        pair.solve_pair(batch)
        ts = pair.solve_pair(batch)
        assert pair.encode_kind(ts) == "delta"
        assert pair.last("warm_matched") == 2
        assert pair.last("warm_restored") == 2

    def test_dirty_group_cuts_prefix(self):
        pair = ChurnPair(n_nodes=2, pods_per_node=1)
        pair.solve_pair(batch_of(dep("big", 3, cpu="500m"),
                                 dep("small", 3, cpu="100m")))
        pair.solve_pair(batch_of(dep("big", 3, cpu="500m"),
                                 dep("small", 5, cpu="100m")))
        assert pair.last("warm_matched") == 1
        assert pair.last("warm_restored") == 1

    def test_error_groups_replay_onto_fresh_pods(self):
        pair = ChurnPair(n_nodes=2, pods_per_node=1)
        pair.solve_pair(batch_of(dep("impossible", 3, cpu="900"),
                                 dep("ok", 2)))
        pair.solve_pair(batch_of(dep("impossible", 3, cpu="900"),
                                 dep("ok", 2)))
        assert pair.last("warm_restored") >= 1

    def test_node_churn_disables_warm_pack_for_the_pass(self):
        pair = ChurnPair(n_nodes=2, pods_per_node=2)
        pair.solve_pair(dep("w", 4))
        pair.do(lambda e: e.complete_bound("churn-node-000"))
        ts = pair.solve_pair(dep("w", 4))
        assert pair.last("warm_restored") == 0
        assert pair.encode_kind(ts) == "delta"
        pair.solve_pair(dep("w", 4))
        assert pair.last("warm_restored") > 0


# -- invalidation matrix: directed vectors -----------------------------------


class TestInvalidationMatrix:
    def test_vocab_overflow_falls_back_to_cold_encode(self):
        pair = ChurnPair(n_nodes=2, pods_per_node=1)
        pair.solve_pair(dep("v", 3))
        ts = pair.solve_pair(dep("v", 3))
        assert pair.encode_kind(ts) == "delta"

        def novel(name):
            return lambda root: [plain_pod(
                root, name, labels={"app": "v"},
                node_selector={"brand-new-key": "brand-new-val"})]
        ts = pair.solve_pair(batch_of(dep("v", 3), novel("novel-1")))
        assert pair.encode_kind(ts) == "cold"
        ts = pair.solve_pair(batch_of(dep("v", 3), novel("novel-2")))
        assert pair.encode_kind(ts) == "delta"

    def test_catalog_change_falls_back_to_cold_encode(self):
        pair = ChurnPair(n_nodes=2, pods_per_node=1)
        for env in pair:
            env.full_catalog = env.catalog
            env.catalog = env.full_catalog[:40]
        pair.solve_pair(dep("c", 3))
        for env in pair:
            env.catalog = env.full_catalog[:44]
        ts = pair.solve_pair(dep("c", 3))
        assert pair.encode_kind(ts) == "cold"

    def test_drought_mark_and_expiry(self):
        pair = ChurnPair(n_nodes=2, pods_per_node=1)
        pair.solve_pair(dep("d", 4))
        pair.do(lambda e: e.registry.mark(zone="test-zone-a"))
        ts = pair.solve_pair(dep("d", 4))
        assert pair.encode_kind(ts) == "delta"

        def expire(e):
            e.clock.step(10_000)
            e.registry.expire()
        pair.do(expire)
        pair.solve_pair(dep("d", 4))

    def test_minvalues_disables_warm_pack_not_delta_encode(self):
        pair = ChurnPair(n_nodes=2, pods_per_node=1)
        for env in pair:
            L = env.k.labels
            env.pool = nodepool(env.root, "default", requirements=[
                type("R", (), {"key": L.LABEL_INSTANCE_TYPE,
                               "operator": "Exists", "values": (),
                               "min_values": 5})()])
        pair.solve_pair(dep("m", 3))
        ts = pair.solve_pair(dep("m", 3))
        assert pair.encode_kind(ts) == "delta"
        assert pair.last("warm") == "disabled:inexpressible"
        assert pair.last("warm_restored") == 0

    def test_conflicting_host_ports_disable_warm_pack(self):
        pair = ChurnPair(n_nodes=2, pods_per_node=1)

        def ported(prefix):
            return lambda root: [
                plain_pod(root, f"{prefix}-{i}", labels={"app": "hp"},
                          host_ports=[pkg(root).objects.HostPort(port=8080)])
                for i in range(3)]
        pair.solve_pair(ported("hp"))
        pair.solve_pair(ported("hp2"))
        assert pair.last("warm_restored") == 0
        assert pair.last("warm") == "disabled:inexpressible"

    def test_coupled_topology_demotes_to_host_on_both_paths(self):
        pair = ChurnPair(n_nodes=2, pods_per_node=1)

        def coupled(root):
            k = pkg(root)
            o, L = k.objects, k.labels
            sel = o.LabelSelector(match_labels={"app": "couple-a"})
            b = [o.Pod(metadata=o.ObjectMeta(name=f"couple-b-{i}",
                                             namespace="default",
                                             labels={"app": "couple-b"}),
                       spec=o.PodSpec(topology_spread_constraints=[
                           o.TopologySpreadConstraint(
                               topology_key=L.LABEL_TOPOLOGY_ZONE,
                               max_skew=1, label_selector=sel)]),
                       container_requests=[k.res.parse_list(
                           {"cpu": "100m", "memory": "64Mi"})])
                 for i in range(2)]
            return deployment(root, "couple-a", 2) + b
        ts = pair.solve_pair(coupled)
        assert ts[JAX].fallback_reason and \
            ts[PORT].fallback_reason == ts[JAX].fallback_reason

    def test_registry_version_in_warm_token(self):
        pair = ChurnPair(n_nodes=2, pods_per_node=1)
        pair.solve_pair(dep("rv", 4))
        pair.solve_pair(dep("rv", 4))
        assert pair.last("warm_restored") > 0
        pair.do(lambda e: e.registry.mark(instance_type=e.catalog[0].name))
        pair.solve_pair(dep("rv", 4))
        assert pair.last("warm_restored") == 0


# -- review-hardening regressions --------------------------------------------


class TestReviewRegressions:
    def test_topo_memo_overflow_recomputes_all_groups(self, monkeypatch):
        for root in ROOTS:
            monkeypatch.setattr(warm_pkg(root).problem_state,
                                "MAX_SIG_ENTRIES", 3)
        pair = ChurnPair(n_nodes=2, pods_per_node=1)
        pair.solve_pair(batch_of(dep("ov-a", 2), dep("ov-b", 2)))
        ts = pair.solve_pair(batch_of(dep("ov-a", 2), dep("ov-b", 2),
                                      dep("ov-c", 2), dep("ov-d", 2)))
        assert ts[PORT].fallback_reason == ""
        assert pair.last("topo_groups_counted") == 4

    def test_recreated_node_same_name_never_reuses_stale_row(self):
        pair = ChurnPair(n_nodes=3, pods_per_node=0)
        pair.solve_pair(dep("rz", 6, spread_key="zone"))
        before = {}
        for env in pair:
            before[env.root] = {sn.name(): sn.identity
                                for sn in env.cluster.state_nodes()}
            env.delete_node("churn-node-001")
            o = env.k.objects
            name = env.add_node(1 + 3 * 1000, pods_per_node=0)
            node = env.store.get(o.Node, name)
            renamed = o.Node(
                metadata=o.ObjectMeta(name="churn-node-001", namespace="",
                                      labels=dict(node.metadata.labels)),
                spec=o.NodeSpec(provider_id=node.spec.provider_id),
                status=o.NodeStatus(capacity=dict(node.status.capacity),
                                    allocatable=dict(node.status.allocatable)))
            env.store.delete(node)
            env.store.create(renamed)
        pair.solve_pair(dep("rz", 6, spread_key="zone"))
        for env in pair:
            after = {sn.name(): sn.identity
                     for sn in env.cluster.state_nodes()}
            assert before[env.root]["churn-node-001"] != \
                after["churn-node-001"]

    def test_daemonset_change_on_empty_cluster_invalidates_warm_seed(self):
        restored = {}
        for root in ROOTS:
            its = pkg(root).kwok.construct_instance_types()
            pool = nodepool(root, "default")
            ps = warm_pkg(root).problem_state.ProblemState()
            seen = []

            def solve(ds_pods):
                batch = deployment(root, "ds", 6)
                ts = scheduler(root, [pool], {"default": its},
                               daemonset_pods=ds_pods, problem_state=ps)
                r = ts.solve(batch)
                cold = scheduler(root, [pool], {"default": its},
                                 daemonset_pods=ds_pods)
                assert digest(r, batch) == digest(cold.solve(batch), batch)
                seen.append((digest(r, batch), ps.last["warm_restored"]))

            solve([])
            solve([])
            solve([plain_pod(root, "ds-pod", cpu="2")])
            restored[root] = seen
        assert restored[JAX] == restored[PORT]
        assert restored[PORT][1][1] > 0
        assert restored[PORT][2][1] == 0

    def test_seed_checkpoints_stay_bounded_across_passes(self):
        pair = ChurnPair(n_nodes=2, pods_per_node=1)
        bound = {root: warm_pkg(root).problem_state.binpack
                 .MAX_SEED_CHECKPOINTS for root in ROOTS}
        for w in range(30):
            def batch(root, w=w):
                return deployment(root, "core", 4, cpu="800m") + [
                    p for d in range(w + 1)
                    for p in deployment(root, f"tail-{d}", 1, cpu="50m")]
            pair.solve_pair(batch)
            for env in pair:
                assert len(env.ps.seed.checkpoints) <= bound[env.root]
        assert pair.last("warm_restored") > 0


# -- seeded churn fuzzers ----------------------------------------------------


_SHAPES = [dict(cpu="100m"), dict(cpu="250m", spread_key="zone"),
           dict(cpu="500m", host_spread=True), dict(cpu="750m")]


def _pending_batch(pending):
    return lambda root: [p for d in sorted(pending)
                         for name, n, kw in pending[d]
                         for p in deployment(root, name, n, **kw)]


@pytest.mark.parametrize("seed", [11, 23, 47])
def test_churn_fuzzer_port_matches_jax_every_step(seed):
    """tests/test_problem_state.py's churn fuzzer on both packages from the
    same seed: arrivals, completions, node churn, drought marks and
    expiries, node adds. At every step each package's delta solve equals
    its cold solve, and the port's decisions equal the JAX package's."""
    rng = random.Random(seed)
    pair = ChurnPair(n_nodes=5, pods_per_node=2)
    pending = {}
    step_seq = 0
    for step in range(24):
        op = rng.choice(["arrive", "arrive", "arrive", "complete",
                         "node-churn", "drought", "expire", "node-add"])
        if op == "arrive":
            d = rng.randrange(6)
            step_seq += 1
            pending.setdefault(d, []).append(
                (f"fz-{d}-{step_seq}", rng.randrange(1, 5),
                 dict(_SHAPES[d % len(_SHAPES)])))
        elif op == "complete" and pending:
            d = rng.choice(list(pending))
            total = sum(n for _, n, _ in pending[d])
            drop = rng.randrange(0, total + 1)
            kept = []
            for name, n, kw in pending[d]:
                cut = min(n, drop)
                drop -= cut
                if n - cut:
                    kept.append((name, n - cut, kw))
            if kept:
                pending[d] = kept
            else:
                del pending[d]
        elif op == "node-churn":
            node = f"churn-node-{rng.randrange(5):03d}"
            pair.do(lambda e: e.complete_bound(node))
        elif op == "drought":
            name = rng.choice(pair.envs[PORT].catalog).name
            zone = rng.choice(["test-zone-a", "test-zone-b"])
            pair.do(lambda e: e.registry.mark(instance_type=name, zone=zone))
        elif op == "expire":
            dt = rng.choice([30, 400, 2000])

            def expire(e):
                e.clock.step(dt)
                e.registry.expire()
            pair.do(expire)
        elif op == "node-add":
            pair.do(lambda e: e.add_node(10 + step, pods_per_node=1))
        if not pending:
            continue
        pair.solve_pair(_pending_batch(pending))
    for env in pair:
        assert env.ps.stats["delta_encodes"] > 0, env.ps.stats


@pytest.mark.parametrize("seed", [7, 31, 61])
def test_sharded_churn_fuzzer_port_matches_jax_every_step(seed):
    """The sharded churn fuzzer on both packages: every solve on an 8-slot
    (4 x 2) mesh with the sharded ProblemState, so node churn dirties one
    shard's rows, the port splices that span into its resident buffers
    (row_splice, the plain version on the CPU), and each step's decisions
    equal a cold mesh solve and the JAX package's."""
    rng = random.Random(seed)
    splice = warm_pkg(PORT).registry.EXIST_SPLICE_BYTES
    skipped0 = splice.value({"outcome": "skipped"})
    pair = ChurnPair(n_nodes=6, pods_per_node=2, mesh_slots=8)
    pending = {}
    step_seq = 0
    saw_shard_dirty = False
    for step in range(24):
        op = rng.choice(["arrive", "arrive", "complete", "node-churn",
                         "group-move", "drought", "expire", "vocab-grow"])
        if op == "arrive":
            d = rng.randrange(6)
            step_seq += 1
            pending.setdefault(d, []).append(
                (f"fzm-{d}-{step_seq}", rng.randrange(1, 5),
                 dict(_SHAPES[d % len(_SHAPES)])))
        elif op == "complete" and pending:
            d = rng.choice(list(pending))
            total = sum(n for _, n, _ in pending[d])
            drop = rng.randrange(0, total + 1)
            kept = []
            for name, n, kw in pending[d]:
                cut = min(n, drop)
                drop -= cut
                if n - cut:
                    kept.append((name, n - cut, kw))
            if kept:
                pending[d] = kept
            else:
                del pending[d]
        elif op == "node-churn":
            node = f"churn-node-{rng.randrange(6):03d}"
            pair.do(lambda e: e.complete_bound(node))
        elif op == "group-move" and pending:
            d = rng.choice(list(pending))
            step_seq += 1
            total = max(1, sum(n for _, n, _ in pending[d]))
            pending[d] = [(f"fzm-{d}-{step_seq}", total,
                           dict(cpu=f"{rng.choice([150, 350, 650])}m"))]
        elif op == "drought":
            name = rng.choice(pair.envs[PORT].catalog).name
            zone = rng.choice(["test-zone-a", "test-zone-b"])
            pair.do(lambda e: e.registry.mark(instance_type=name, zone=zone))
        elif op == "expire":
            dt = rng.choice([30, 400, 2000])

            def expire(e):
                e.clock.step(dt)
                e.registry.expire()
            pair.do(expire)
        elif op == "vocab-grow":
            pair.do(lambda e: e.add_node(10 + step, pods_per_node=1))
        if not pending:
            continue
        pair.solve_pair(_pending_batch(pending))
        sd = pair.last("shard_dirty")
        if sd and sum(sd.values()) > 0:
            saw_shard_dirty = True
    for env in pair:
        assert env.ps.stats["delta_encodes"] > 0, env.ps.stats
    assert saw_shard_dirty, "no step ever dirtied a shard's rows"
    # clean spans were skipped by the port's delta upload: the row-splice
    # path of the mesh placer ran
    assert splice.value({"outcome": "skipped"}) > skipped0


def test_churn_env_is_the_same_cluster_in_both_packages():
    """The lockstep harness's premise: both packages' ChurnEnvs hold the
    same nodes, revisions aside, and the port's runs on the CPU."""
    envs = {root: ChurnEnv(root, n_nodes=3, pods_per_node=1)
            for root in ROOTS}
    names = {root: sorted(sn.name() for sn in env.live_nodes())
             for root, env in envs.items()}
    assert names[JAX] == names[PORT] and len(names[PORT]) == 3
    assert envs[PORT].scheduler(None).device.type == "cpu"
