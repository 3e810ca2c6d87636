"""The port's EncodePlane held against the JAX package's: several
subscribers consuming one refcounted plane make the decisions a private
ProblemState makes, rows encode once and are served shared, and both
packages count the same encodes, shares, stack builds and stack hits.

The cases are tests/test_state_plane.py's combined-loop fuzzer, subscriber
lifecycle and two-generation row cases, run on both packages side by side.
"""

import random

import pytest

from test_torch_support import (JAX, PORT, ROOTS, ChurnPair, deployment,
                                digest, warm_pkg)
from test_torch_support import device_series_kept  # noqa: F401 (autouse)


def _solve(env, ps, batch, state_nodes=None):
    """One pass through a fresh scheduler bound to `ps`."""
    ts = env.scheduler(ps, state_nodes=state_nodes)
    return ts.solve(batch)


@pytest.mark.parametrize("seed", [0, 7])
def test_three_subscribers_one_plane_port_matches_jax(seed):
    """Provisioning, disruption and sidecar passes over ONE plane while the
    cluster churns, each shadowed by the same pass over a private
    ProblemState: in each package shared == private, and across the
    packages the decisions and the plane's reuse ledger are the same."""
    rng = random.Random(seed)
    pair = ChurnPair(n_nodes=6, pods_per_node=2)
    names = ("provisioning", "disruption", "sidecar")
    planes, shared, private = {}, {}, {}
    for env in pair:
        w = env.w
        planes[env.root] = w.plane.EncodePlane(name=f"torch-fuzz-{seed}")
        shared[env.root] = {n: planes[env.root].subscribe(n) for n in names}
        private[env.root] = {n: w.problem_state.ProblemState()
                             for n in names}
        assert planes[env.root].subscribers == {n: 1 for n in names}

    next_node = 100
    for step in range(12):
        op = rng.choice(["arrive", "complete", "node-add", "node-remove",
                         "arrive"])
        port_env = pair.envs[PORT]
        if op == "complete":
            bound = [n for n, pods in port_env.bound.items() if pods]
            if bound:
                node = rng.choice(bound)
                pair.do(lambda e: e.complete_bound(node))
        elif op == "node-add":
            pair.do(lambda e: e.add_node(next_node, pods_per_node=1))
            next_node += 1
        elif op == "node-remove":
            nodes = sorted(port_env.bound)
            if len(nodes) > 3:
                node = rng.choice(nodes)
                pair.do(lambda e: e.delete_node(node))
        shapes = [(f"std-{k}", rng.randint(1, 3), {})
                  for k in rng.sample(range(4), 2)]
        if step % 3 == 0:
            shapes.append((f"roll-{step}", 2, {"cpu": f"{201 + step}m"}))
        n_live = len(port_env.live_nodes())
        victim = rng.randrange(n_live)
        digests = {}
        for env in pair:
            root = env.root
            pods = [p for name, n, kw in shapes
                    for p in deployment(root, name, n, **kw)]
            all_nodes = sorted(env.live_nodes(), key=lambda sn: sn.name())
            views = {"provisioning": all_nodes,
                     "disruption": all_nodes[:victim] + all_nodes[victim + 1:],
                     "sidecar": all_nodes}
            digests[root] = []
            for name in names:
                r_sh = _solve(env, shared[root][name], pods, views[name])
                r_pr = _solve(env, private[root][name], pods, views[name])
                d = digest(r_sh, pods)
                assert d == digest(r_pr, pods), (root, step, name)
                digests[root].append(d)
        assert digests[JAX] == digests[PORT], f"step {step}"

    stats = {root: dict(plane.stats) for root, plane in planes.items()}
    assert stats[JAX] == stats[PORT]
    plane = planes[PORT]
    assert plane.stats["node_rows_shared"] > 0
    assert plane.stats["group_rows_shared"] > 0
    assert plane.stats["stack_hits"] > 0
    private_encoded = sum(ps.plane.stats["node_rows_encoded"]
                          for ps in private[PORT].values())
    assert plane.stats["node_rows_encoded"] < private_encoded
    rows = warm_pkg(PORT).registry.STATE_PLANE_ROWS
    for name in names:
        assert rows.value({"subscriber": name, "outcome": "shared"}) > 0


# -- subscriber lifecycle ----------------------------------------------------


@pytest.mark.parametrize("root", ROOTS)
def test_refcounts_and_gauge(root):
    w = warm_pkg(root)
    plane = w.plane.EncodePlane(name=f"torch-lifecycle-{root}")
    gauge = w.registry.STATE_PLANE_SUBSCRIBERS
    label = {"plane": plane.name}
    h1 = plane.subscribe("provisioning")
    h2 = plane.subscribe("provisioning")
    h3 = plane.subscribe("disruption")
    assert plane.subscribers == {"provisioning": 2, "disruption": 1}
    assert gauge.value(label) == 3.0
    h2.close()
    assert plane.subscribers == {"provisioning": 1, "disruption": 1}
    h1.close()
    h3.close()
    assert plane.subscribers == {}
    w.plane.refresh_subscriber_gauge()
    assert gauge.value(label) == 0.0


@pytest.mark.parametrize("root", ROOTS)
def test_bare_problem_state_gets_private_plane(root):
    w = warm_pkg(root)
    ps1 = w.problem_state.ProblemState()
    ps2 = w.problem_state.ProblemState()
    assert ps1.plane is not ps2.plane
    assert ps1.plane.subscribers == {"private": 1}
    assert ps1.plane.name.startswith("private:")
    assert ps1.plane in w.plane.live_planes()
    assert ps1.plane.bump_topo_revision() == 1


# -- two-generation node rows and stack slots --------------------------------


def test_full_subset_full_alternation_reencodes_nothing():
    pair = ChurnPair(n_nodes=5, pods_per_node=1)
    counts = {}
    for env in pair:
        plane = env.w.plane.EncodePlane(name="torch-twogen")
        prov = plane.subscribe("provisioning")
        dis = plane.subscribe("disruption")
        pods = deployment(env.root, "a", 3)
        all_nodes = sorted(env.live_nodes(), key=lambda sn: sn.name())
        seen = [_solve(env, prov, pods, all_nodes)]
        got = [prov.last["node_rows_reencoded"]]
        seen.append(_solve(env, dis, pods, all_nodes[:3]))
        got.append(dis.last["node_rows_reencoded"])
        seen.append(_solve(env, prov, pods, all_nodes))
        got.append(prov.last["node_rows_reencoded"])
        got.append(plane.stats["node_rows_encoded"])
        counts[env.root] = (got, [digest(r, pods) for r in seen])
    assert counts[JAX] == counts[PORT]
    assert counts[PORT][0] == [5, 0, 0, 5]


def test_stack_slots_keep_both_views_resident():
    pair = ChurnPair(n_nodes=4, pods_per_node=1)
    ledgers = {}
    for env in pair:
        plane = env.w.plane.EncodePlane(name="torch-stacks")
        prov = plane.subscribe("provisioning")
        dis = plane.subscribe("disruption")
        pods = deployment(env.root, "a", 2)
        all_nodes = sorted(env.live_nodes(), key=lambda sn: sn.name())
        _solve(env, prov, pods, all_nodes)
        _solve(env, dis, pods, all_nodes[:2])
        builds = plane.stats["stack_builds"]
        _solve(env, prov, pods, all_nodes)
        _solve(env, dis, pods, all_nodes[:2])
        assert plane.stats["stack_builds"] == builds
        assert plane.stats["stack_hits"] >= 2
        ledgers[env.root] = dict(plane.stats)
    assert ledgers[JAX] == ledgers[PORT]


def test_debug_view_reports_caches_and_stats():
    pair = ChurnPair(n_nodes=3, pods_per_node=1)
    views = {}
    for env in pair:
        plane = env.w.plane.EncodePlane(name="torch-view")
        ps = plane.subscribe("provisioning")
        _solve(env, ps, deployment(env.root, "a", 2))
        view = plane.debug_view()
        assert view["node_caches"][0]["rows_cur"] == 3
        views[env.root] = (view["name"], view["subscribers"],
                           view["stats"], len(view["node_caches"]))
    assert views[JAX] == views[PORT]
