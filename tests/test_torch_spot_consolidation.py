"""Spot-to-spot single-node consolidation: the port against the JAX
package over the same spot fleet after a spot price move, and the port's
keyed worst-launch-price vectors against the per-type loop.

The fleet is the benchmark's ``kwok2k6z-spot5k`` configuration cut to 200
nodes of 24 deployments on 500 types (``benchmark/spot_spec.py`` builds
its plain records; each package's objects are built from them here): six
zones, every type offered as spot and on-demand in each, the spot prices
moved from the launch-time vector p0 to the current p1, every node full
and of the cheapest type under p0 that its pods fill. Commands are
compared by name: decision, candidate, replacement options in order and
the simulated placements."""

import dataclasses
import importlib
import json
import random
from pathlib import Path

import numpy as np
import pytest

from test_torch_support import (JAX, PORT, ROOTS, LiveEnv, MinValuesReq,
                                live_pkg, nodepool, pkg, pod)
from test_torch_support import device_series_kept, tracer_kept  # noqa: F401

from benchmark import spot_spec
from benchmark.reference import spot_check

CONFIG = Path(__file__).resolve().parents[1] / "benchmark" / "configs" / \
    "kwok2k6z-spot5k.json"
SEEDS = (1, 2, 3, 2**31 + 5)


def small_config() -> dict:
    cfg = json.loads(CONFIG.read_text())
    cfg["catalog"]["count"] = 500
    cfg["fleet"].update(nodes=200, deployments=24)
    return cfg


def instance_types(root: str, types: list, vector: str) -> list:
    """Each package's InstanceType objects of the catalog records
    (benchmark/objects.py's instance_types), spot priced from ``vector``."""
    k = pkg(root)
    L, R = k.labels, k.requirement
    t = live_pkg(root).types
    req = lambda key, values: R.Requirement(key, R.IN, values)  # noqa: E731
    out = []
    for it in types:
        offerings = t.Offerings(
            t.Offering(requirements=k.requirements.Requirements([
                req(L.CAPACITY_TYPE_LABEL_KEY, [ct]),
                req(L.LABEL_TOPOLOGY_ZONE, [zone])]),
                price=price, available=available)
            for zone, ct, price, available in spot_spec.offerings(it, vector))
        out.append(t.InstanceType(
            name=it["name"],
            requirements=k.requirements.Requirements([
                req(L.LABEL_INSTANCE_TYPE, [it["name"]]),
                req(L.LABEL_ARCH, [it["arch"]]), req(L.LABEL_OS, [it["os"]]),
                req(L.LABEL_TOPOLOGY_ZONE, it["zones"]),
                req(L.LABEL_TOPOLOGY_REGION, [it["region"]]),
                req(L.CAPACITY_TYPE_LABEL_KEY, ["spot", "on-demand"]),
                req(k.kwok.GROUP_INSTANCE_SIZE, [it["size"]]),
                req(k.kwok.GROUP_INSTANCE_FAMILY, [it["family"]])]),
            offerings=offerings, capacity=dict(it["capacity"]),
            overhead=t.InstanceTypeOverhead(
                kube_reserved=dict(it["overhead"]))))
    return out


def spot_env(root: str, seed: int):
    """The fleet as a live cluster of ``root``, the provider serving p1."""
    cfg = small_config()
    types = spot_spec.catalog(cfg, seed)
    fleet = spot_spec.fleet(cfg, types, seed)
    its = instance_types(root, types, "p1")
    by_name = {it.name: it for it in its}
    env = LiveEnv(root, its, spot_to_spot=True)
    env.pool()
    L = env.k.labels
    for n in fleet["nodes"]:
        it = by_name[n["type"]]
        env.node(n["name"], it, capacity_type="spot", zone=n["zone"],
                 alloc=it.allocatable(), labels={L.LABEL_OS: fleet["os"]})
    for n in fleet["nodes"]:
        dep = fleet["deployments"][n["deployment"]]
        for j, name in enumerate(n["pods"]):
            p = pod(root, name, labels={"app": dep["app"]},
                    node_selector={L.LABEL_OS: fleet["os"]})
            p.container_requests = [dict(n["pod_requests"])]
            if j == 0 and n["do_not_disrupt"]:
                p.metadata.annotations[L.DO_NOT_DISRUPT_ANNOTATION_KEY] = \
                    "true"
            p.spec.node_name = n["name"]
            p.status.phase = "Running"
            env.store.create(p)
    env.clock.step(600)
    return env, types, fleet


def single_pass(env):
    """One cold SingleNodeConsolidation pass with spot-to-spot on."""
    lv = env.lv
    m = lv.methods.SingleNodeConsolidation(
        env.cluster, env.provisioner, spot_to_spot_enabled=True,
        clock=env.clock)
    snap = lv.prefix.DisruptionSnapshot(env.cluster, env.provisioner)
    m.attach_snapshot(snap)
    cands = lv.helpers.get_candidates(env.cluster, env.provisioner,
                                      m.should_disrupt, context=snap)
    budgets = lv.helpers.build_disruption_budget_mapping(env.cluster,
                                                         m.reason)
    cmd, results = m.compute_command(budgets, cands)
    return m, cands, cmd, results


def summary(cmd, results) -> dict:
    """The command by name, as the benchmark's check reads it."""
    claims = []
    for r in cmd.replacements:
        ct = r.requirements.get("karpenter.sh/capacity-type")
        claims.append({"pods": sorted(p.metadata.name for p in r.pods),
                       "capacity_types": ct.values_list(),
                       "options": [it.name for it in r.instance_type_options]})
    placements = {}
    if results is not None:
        placements = {en.name: sorted(p.metadata.name for p in en.pods)
                      for en in results.existing_nodes if en.pods}
    return {"decision": cmd.decision,
            "candidates": [c.name for c in cmd.candidates],
            "placements": placements, "claims": claims}


@pytest.mark.parametrize("seed", SEEDS)
def test_spot_single_node_command_matches(seed):
    """Decision, candidate, replacement options in order and placements:
    equal in both packages, a spot replacement of at most 15 options, and
    no fault by the benchmark's plain reference."""
    got = {}
    for root in ROOTS:
        env, types, fleet = spot_env(root, seed)
        m, cands, cmd, results = single_pass(env)
        assert m.last_engine_stats is not None, root
        got[root] = ([c.name for c in cands], summary(cmd, results))
    assert got[PORT] == got[JAX]
    names, answer = got[PORT]
    assert answer["decision"] == "replace", answer
    (claim,) = answer["claims"]
    assert claim["capacity_types"] == ["spot"]
    assert 1 <= len(claim["options"]) <= 15
    fl = spot_check.Fleet(types, fleet, "p1")
    faults = spot_check.check(fl, answer)
    assert sum(faults.values()) == 0, faults


# -- the keyed worst-launch-price vectors -------------------------------------

def _catalog(root: str) -> list:
    """60 six-zone types, spot priced from p1, every seventh offering
    unavailable and zone f offered by every third type alone."""
    cfg = json.loads(CONFIG.read_text())
    cfg["catalog"]["count"] = 60
    types = spot_spec.catalog(cfg, 11)
    for t, it in enumerate(types):
        it["offerings"] = [
            (zone, ct, price, (t * 12 + o) % 7 != 0)
            for o, (zone, ct, price, _) in enumerate(it["offerings"])
            if zone != "test-zone-f" or t % 3 == 0]
    return instance_types(root, types, "p1")


REQUIREMENTS = {
    "every offering": [],
    "one zone": [("topology.kubernetes.io/zone", ["test-zone-f"])],
    "on-demand only": [("karpenter.sh/capacity-type", ["on-demand"])],
    "spot only": [("karpenter.sh/capacity-type", ["spot"])],
    "spot in two zones": [("karpenter.sh/capacity-type", ["spot"]),
                          ("topology.kubernetes.io/zone",
                           ["test-zone-a", "test-zone-f"])],
}


@pytest.mark.parametrize("case", sorted(REQUIREMENTS))
def test_keyed_worst_prices_equal_the_per_type_loop(case):
    """WorstLaunchPrices' vector equals Offerings.worst_launch_price type
    by type, in the port and in the JAX package, float for float."""
    loops = {}
    for root in ROOTS:
        k = pkg(root)
        reqs = k.requirements.Requirements([
            k.requirement.Requirement(key, k.requirement.IN, values)
            for key, values in REQUIREMENTS[case]])
        catalog = _catalog(root)
        loops[root] = np.array(
            [it.offerings.available().worst_launch_price(reqs)
             for it in catalog], dtype=np.float64)
        if root == PORT:
            keyed = live_pkg(root).types.WorstLaunchPrices(catalog)
            vector = keyed.vector(reqs)
            assert np.array_equal(keyed.vector(reqs), vector)
            assert keyed.built == 1
            again = live_pkg(root).types.WorstLaunchPrices(
                catalog[::-1]).vector(reqs)
    assert np.array_equal(vector, loops[PORT])
    assert np.array_equal(vector, loops[JAX])
    assert np.array_equal(again, vector[::-1])
    if case == "one zone":
        assert 0 < np.isinf(vector).sum() < len(vector)


def _claim(root: str, kind: str, catalog: list):
    """A claim of ``kind`` in ``root`` whose options are ``catalog``."""
    imp = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    if kind == "host":
        sched = imp("provisioning.scheduler")
        topo = imp("provisioning.topology")
        claim = sched.InFlightNodeClaim(
            sched.NodeClaimTemplate(nodepool(root)),
            topo.Topology(topo.ClusterView(), {}, []), {}, catalog)
        claim._min_alloc = {"cpu": 1}
        return claim
    if kind == "sidecar":
        return imp("sidecar.client").RemoteNodeClaim(
            api_nodeclaim=None, pods=[], instance_type_options=list(catalog))
    return imp("provisioning.tensor_scheduler").TensorNodeClaim(
        None, None, list(catalog), [], {})


@pytest.mark.parametrize("kind", ["host", "sidecar", "tensor"])
def test_every_claims_price_filter_is_the_loop(kind):
    """Each claim kind's consolidation price filter keeps, in order, the
    options whose per-type worst launch price is below the bound, and
    makes the JAX package's same claim's answer, minValues verdict
    included."""
    got = {}
    for root in ROOTS:
        k = pkg(root)
        catalog = _catalog(root)
        names = [it.name for it in catalog]
        cases = dict(REQUIREMENTS)
        cases["instance-type minValues"] = [
            (k.labels.LABEL_INSTANCE_TYPE, names, len(names))]
        answers = []
        for case in sorted(cases):
            reqs = k.requirements.Requirements([
                k.requirement.Requirement(key, k.requirement.IN, values,
                                          min_values=mv[0] if mv else None)
                for key, values, *mv in cases[case]])
            loop = [it.offerings.available().worst_launch_price(reqs)
                    for it in catalog]
            finite = sorted(w for w in loop if w < np.inf)
            for max_price in (finite[len(finite) // 2], np.inf):
                claim = _claim(root, kind, catalog)
                kept, err = claim.remove_instance_types_by_price_and_min_values(
                    reqs, max_price)
                options = [it.name for it in claim.instance_type_options]
                assert options == [it.name for it, w in zip(catalog, loop)
                                   if w < max_price]
                assert 0 < len(options) < len(catalog) or max_price == np.inf
                assert (kept is None) == (err is not None)
                assert kept is None or kept is claim
                if kind == "host":
                    assert claim._min_alloc is None
                answers.append((case, max_price, options, err))
        got[root] = answers
    assert got[PORT] == got[JAX]
    assert any(err for *_, err in got[PORT])


def test_a_won_verdict_names_its_tally():
    """The classifier's counts: a REJECT without a tally is rejected, a
    NEEDS_SIM needs_sim, and a WIN has to say whether it deletes or
    replaces."""
    from karpenter_tpu_torch.disruption import batch
    assert batch._tally(batch.LooVerdict(batch.REJECT)) == "rejected"
    assert batch._tally(batch.LooVerdict(batch.NEEDS_SIM)) == "needs_sim"
    assert batch._tally(batch.LooVerdict(
        batch.REJECT, tally="spot_floor")) == "spot_floor"
    assert batch._tally(batch.LooVerdict(
        batch.WIN, tally="won_delete")) == "won_delete"
    with pytest.raises(ValueError):
        batch._tally(batch.LooVerdict(batch.WIN))


def test_groups_that_allow_the_same_offerings_share_one_vector():
    """Every deployment of the spot fleet allows the same offerings: one
    vector serves them all, and the winner's price filter builds one of
    its options. The classifier resolves each distinct price lookup (a
    type and the node's zone and capacity type) once, and counts them."""
    from karpenter_tpu_torch.obs.tracer import TRACER
    env, _, _ = spot_env(PORT, SEEDS[0])
    TRACER.enabled = True
    with TRACER.span("test.pass"):
        m, cands, cmd, _ = single_pass(env)
    spans = TRACER.last().spans
    prices = [sp for sp in spans if sp.name == "disruption.prices"]
    (loo,) = [sp for sp in spans if sp.name == "disruption.loo"]
    assert cmd.decision == "replace"
    assert sum(sp.attrs["vectors"] for sp in prices) == 2
    assert prices[0].attrs == {"vectors": 1, "types": 500}
    # every other group reads the first one's vector
    assert all(sp.attrs == {"vectors": 0, "types": 500}
               for sp in prices[1:-1])
    # the winner's filter: one vector of its options
    assert prices[-1].attrs["vectors"] == 1
    assert prices[-1].attrs["types"] >= len(
        cmd.replacements[0].instance_type_options)
    counts = {k: loo.attrs[k] for k in ("won_delete", "won_replace",
                                        "rejected", "spot_floor",
                                        "needs_sim")}
    assert sum(counts.values()) == loo.attrs["candidates"] == len(
        [c for c in cands if c.reschedulable_pods])
    assert counts["won_replace"] >= 1 and counts["spot_floor"] >= 1
    assert counts["won_delete"] == counts["needs_sim"] == 0
    lookups = {(c.instance_type.name, c.zone, c.capacity_type)
               for c in cands if c.reschedulable_pods}
    assert loo.attrs["price_keys"] == len(lookups) <= loo.attrs["candidates"]


# -- the classifier's verdicts and the candidates' price vector --------------

def _engines(root: str, monkeypatch) -> list:
    """Every LeaveOneOutEngine ``root``'s single-node pass builds. The JAX
    package's verdicts carry no tally, so its engine notes the candidates
    whose verdict the replacement pricing gave: a WIN there replaces, any
    other WIN deletes."""
    batch = importlib.import_module(f"{root}.disruption.batch")
    built = []

    class Engine(batch.LeaveOneOutEngine):
        def __init__(self, *args, **kwargs):
            self.replaced = set()
            super().__init__(*args, **kwargs)
            built.append(self)

        if root == JAX:
            def _classify_replacement(self, c, g, m0, r):
                self.replaced.add(c.name)
                return super()._classify_replacement(c, g, m0, r)

    monkeypatch.setattr(batch, "LeaveOneOutEngine", Engine)
    return built


def _rows(engine) -> list:
    """(kind, reason, tally) of every candidate, in candidate order."""
    out = []
    for i, c in enumerate(engine.candidates):
        v = engine.verdict(i)
        if hasattr(v, "tally"):
            tally = v.tally or ("needs_sim" if v.kind == "sim"
                                else "rejected")
        elif v.kind == "win":
            tally = "won_replace" if c.name in engine.replaced \
                else "won_delete"
        elif v.kind == "sim":
            tally = "needs_sim"
        elif v.reason.startswith("SpotToSpotConsolidation requires"):
            tally = "spot_floor"
        else:
            tally = "rejected"
        out.append((v.kind, v.reason, tally))
    return out


def _fuzz_rows(root: str, seed: int, monkeypatch) -> list:
    from test_torch_disruption import fuzz_cluster, run_single_node
    built = _engines(root, monkeypatch)
    env, spot_to_spot = fuzz_cluster(seed, root)
    run_single_node(env, spot_to_spot, batched=True)
    return [_rows(e) for e in built]


def _spot_rows(root: str, seed: int, monkeypatch) -> list:
    built = _engines(root, monkeypatch)
    env, _, _ = spot_env(root, seed)
    single_pass(env)
    return [_rows(e) for e in built]


FLEETS = [("spot", seed) for seed in SEEDS] + \
    [("fuzz", seed) for seed in range(7000, 7012)] + \
    [("priced", seed) for seed in (1, 2, 3)]


@pytest.mark.parametrize("fleet,seed", FLEETS)
def test_verdicts_match_the_jax_engine_row_for_row(fleet, seed, monkeypatch):
    """The port's group-at-a-time verdicts equal the JAX package's
    row-at-a-time engine's: kind, reason (the cheaper-type count included)
    and tally, candidate by candidate."""
    rows = {"spot": _spot_rows, "fuzz": _fuzz_rows,
            "priced": _priced_rows}[fleet]
    got = {root: rows(root, seed, monkeypatch) for root in ROOTS}
    assert got[PORT] == got[JAX]
    if fleet == "spot":
        (verdicts,) = got[PORT]
        tallies = {tally for _, _, tally in verdicts}
        assert {"won_replace", "spot_floor"} <= tallies


def test_fleets_reach_every_branch(monkeypatch):
    """The fuzz seeds 7000-7011 and the priced fleets reach every verdict
    the group arithmetic gives."""
    reasons = set()
    for seed in range(7000, 7012):
        for verdicts in _fuzz_rows(PORT, seed, monkeypatch):
            reasons.update((kind, reason.split(",")[0], tally)
                           for kind, reason, tally in verdicts)
    for seed in (1, 2, 3):
        for verdicts in _priced_rows(PORT, seed, monkeypatch):
            reasons.update((kind, reason.split(",")[0], tally)
                           for kind, reason, tally in verdicts)
    floor = "SpotToSpotConsolidation requires 15 cheaper instance type " \
        "options than the current candidate to consolidate"
    assert {("win", "", "won_delete"), ("win", "", "won_replace"),
            ("sim", "", "needs_sim"), ("reject", "", "rejected"),
            ("reject", "not all pods would schedule", "rejected"),
            ("reject", "Can't replace with a cheaper node", "rejected"),
            ("reject", "Can't remove without creating 2 candidates",
             "rejected"),
            ("reject", "SpotToSpotConsolidation is disabled", "rejected"),
            ("reject", floor, "spot_floor"),
            } <= reasons, sorted(reasons)


def _priced_env(seed: int, root: str = PORT):
    """Nodes of ``_catalog``'s types (every seventh offering unavailable,
    zone f on every third type alone) in five zones, spot and on-demand,
    each 80% full by the cpu of one pod, which no other node has room for:
    every row prices a replacement. Node ``pr-00`` sits in zone f on a
    type without it, ``pr-01`` carries a beta zone label that disagrees
    with its zone (its twin ``pr-03`` has none), and ``pr-02``, of the
    largest type, has the room of two such pods and holds two, which no
    type holds together. ``pr-04`` (1,350m) holds one 650m pod and room for
    one more, which only the uninitialized ``pr-24`` also has. On odd seeds the pool allows on-demand alone, so
    a spot candidate is priced against on-demand replacements."""
    rng = random.Random(seed)
    its = _catalog(root)
    env = LiveEnv(root, its, spot_to_spot=True)
    env.pool(requirements=[MinValuesReq(
        env.k.labels.CAPACITY_TYPE_LABEL_KEY, "In", ["on-demand"])]
        if seed % 2 else ())
    zones = [f"test-zone-{z}" for z in "abcde"]
    for i in range(24):
        it = its[rng.randrange(len(its))]
        labels, zone = {}, rng.choice(zones)
        capacity_type = rng.choice(("spot", "on-demand"))
        if i == 0:
            it, zone = its[1], "test-zone-f"
        elif i in (1, 3):
            it, zone, capacity_type = its[4], "test-zone-a", "spot"
            if i == 1:
                labels["failure-domain.beta.kubernetes.io/zone"] = \
                    "test-zone-b"
        elif i == 2:
            it = max(its, key=lambda t: t.allocatable()["cpu"])
        alloc = dict(it.allocatable())
        cpu = 650 if i == 4 else int(alloc["cpu"] * 0.8)
        if i == 2:
            alloc["cpu"] = 2 * cpu
        elif i == 4:
            alloc["cpu"] = 1350
        name = f"pr-{i:02d}"
        env.node(name, it, zone=zone, alloc=alloc, labels=labels,
                 capacity_type=capacity_type)
        for j in range(2 if i == 2 else 1):
            env.bind(name, f"pr-pod-{i}-{j}", cpu=f"{cpu}m")
    env.node("pr-24", its[0], initialized=False, consolidatable=False,
             alloc={"cpu": "700m", "memory": "16Gi", "pods": "110"})
    env.clock.step(600)
    return env


def _priced_rows(root: str, seed: int, monkeypatch) -> list:
    built = _engines(root, monkeypatch)
    env = _priced_env(seed, root)
    single_pass(env)
    return [_rows(e) for e in built]


@pytest.mark.parametrize("seed", (1, 2, 3))
def test_price_vector_is_candidate_price(seed):
    """The engine's price vector equals Candidate.price() candidate by
    candidate, float for float and None where None: on-demand and spot
    nodes in several zones, a node whose labels match no offering, one
    whose zone labels disagree, and a candidate with no instance type."""
    from karpenter_tpu_torch.disruption import batch
    env = _priced_env(seed)
    lv = env.lv
    m = lv.methods.SingleNodeConsolidation(
        env.cluster, env.provisioner, spot_to_spot_enabled=True,
        clock=env.clock)
    snap = lv.prefix.DisruptionSnapshot(env.cluster, env.provisioner)
    cands = lv.helpers.get_candidates(env.cluster, env.provisioner,
                                      m.should_disrupt, context=snap)
    engine = batch.LeaveOneOutEngine(snap, cands, True)

    def as_list(vector):
        return [None if np.isnan(p) else float(p) for p in vector]

    want = [c.price() for c in cands]
    assert as_list(engine.prices) == want
    by_name = dict(zip((c.name for c in cands), want))
    assert by_name["pr-00"] is None and by_name["pr-01"] is None
    assert by_name["pr-03"] is not None
    assert {c.capacity_type for c, p in zip(cands, want) if p} == \
        {"spot", "on-demand"}
    assert len({c.zone for c, p in zip(cands, want) if p}) >= 3
    # the memo keys a lookup by the labels the offerings read: a candidate
    # without an instance type is never looked up
    odd = cands + [dataclasses.replace(cands[2], instance_type=None)]
    vector, keys = batch.current_prices(odd)
    assert as_list(vector) == want + [None]
    assert keys == engine.price_keys == len(
        {(c.instance_type.name, c.zone, c.capacity_type,
          c.state_node.labels().get("failure-domain.beta.kubernetes.io/zone"))
         for c in cands})
