"""The inputs: deterministic in the seed, four distinct bursts, the same
work for every seed, and the catalog the kwok provider builds."""

import collections
import json
import os

import bench_support  # noqa: F401 (the repository root on the path)
from benchmark import spec

CFG = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs")


def _cfg(name):
    with open(os.path.join(CFG, f"{name}.json")) as f:
        return json.load(f)


def test_bursts_are_deterministic_in_the_seed_and_distinct():
    cfg = _cfg("kwok2k-burst50k")
    seed = 2**33 + 5
    a = [spec.burst(cfg, seed, k) for k in range(4)]
    b = [spec.burst(cfg, seed, k) for k in range(4)]
    assert a == b
    assert len({tuple(x["pods"]) for x in a}) == 4
    assert len({tuple((d["cpu"], d["memory"]) for d in x["deployments"])
                for x in a}) == 4
    assert all(len(x["pods"]) == 120 * 416 for x in a)
    assert spec.burst(cfg, seed + 1, 0) != a[0]


def test_every_seed_carries_the_same_shapes_per_kind():
    cfg = _cfg("kwok2k-burst50k")

    def mix(seed, k):
        return collections.Counter(
            (d["kind"], d["cpu"], d["memory"])
            for d in spec.burst(cfg, seed, k)["deployments"])

    assert mix(1, 0) == mix(2**40 + 3, 3) == mix(7, 1)


def test_nodes_and_fleet_are_deterministic_in_the_seed():
    cfg = _cfg("kwok2k-burst50k")
    types = spec.catalog(cfg)
    assert spec.existing_nodes(cfg, types, 9) == spec.existing_nodes(
        cfg, types, 9)
    assert spec.existing_nodes(cfg, types, 9) != spec.existing_nodes(
        cfg, types, 10)
    fcfg = _cfg("kwok144-consolidate5k")
    ftypes = spec.catalog(fcfg)
    f = spec.fleet(fcfg, ftypes, 3)
    assert f == spec.fleet(fcfg, ftypes, 3)
    assert sum(n["do_not_disrupt"] for n in f["nodes"]) == 500
    assert collections.Counter(
        tuple(n["pod_requests"].values()) for n in f["nodes"]) == \
        collections.Counter(tuple(n["pod_requests"].values())
                            for n in spec.fleet(fcfg, ftypes, 4)["nodes"])


def test_catalogs_equal_the_kwok_providers():
    from benchmark import objects
    from karpenter_tpu_torch.cloudprovider.kwok import (
        construct_catalog, construct_instance_types)
    for name, ref in (("kwok2k-burst50k", construct_catalog(2000)),
                      ("kwok144-consolidate5k", construct_instance_types())):
        ours = objects.instance_types(spec.catalog(_cfg(name)))
        assert [a.name for a in ours] == [b.name for b in ref]
        for a, b in zip(ours, ref):
            assert a.capacity == b.capacity
            assert a.allocatable() == b.allocatable()
            assert [(o.zone, o.capacity_type, o.price, o.available)
                    for o in a.offerings] == \
                [(o.zone, o.capacity_type, o.price, o.available)
                 for o in b.offerings]
            assert {k: a.requirements.get(k).values_list()
                    for k in a.requirements} == \
                {k: b.requirements.get(k).values_list()
                 for k in b.requirements}


def test_quantities_parse_as_kubernetes_milliunits():
    assert spec.quantity("250m") == 250
    assert spec.quantity("2") == 2000
    assert spec.quantity(3) == 3000
    assert spec.quantity("1Gi") == 2**30 * 1000
    assert spec.quantity("64Mi") == 2**26 * 1000
