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

import importlib
import json
from pathlib import Path

import numpy as np
import pytest

from test_torch_support import (JAX, PORT, ROOTS, LiveEnv, live_pkg, nodepool,
                                pkg, pod)
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
    its options."""
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
