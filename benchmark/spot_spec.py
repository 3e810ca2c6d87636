"""The spot fleet's inputs as plain data, drawn from a configuration file
and ``--seed``: the catalog with two spot price vectors, and a fleet of
spot nodes each launched at the cheapest fit under the first of them.

As in ``spec.py``, nothing here imports the program: the same records
feed the program (``spot_objects.py``) and the reference
(``reference/spot_check.py``). Quantities are integer milliunits.

Every spot offering (type, zone) carries two multipliers, each a whole
number of thousandths drawn by the seed from ``price_shift``: ``p0``, the
launch-time vector the fleet was bought at, and ``p1``, the current one
the provider serves. A spot price is the catalog's on-demand formula times
``spot_factor`` times the multiplier, kept as an exact fraction; the float
the provider serves is that fraction correctly rounded, so floats order
exactly as the fractions do and equal fractions give equal floats."""

from __future__ import annotations

from fractions import Fraction

from . import spec as S

VECTORS = ("p0", "p1")
# the fleet's ``node_type`` rules: the cheapest type that holds a node's
# pods, or the cheapest that holds them and that they fill
NODE_TYPES = ("cheapest", "cheapest_filled")


def catalog(cfg: dict, seed: int) -> list:
    """The configuration's kwok catalog (``spec.catalog``), each type with
    ``spot_exact``: {vector: {zone: exact spot price}}."""
    c = cfg["catalog"]
    lo, hi = (round(Fraction(str(x)) * 1000) for x in c["price_shift"])
    types = S.catalog(cfg)
    for v in VECTORS:
        rng = S.rng_for(seed, "spot-prices", v)
        for it in types:
            spot = it["exact_prices"][S.SPOT]
            it.setdefault("spot_exact", {})[v] = {
                zone: spot * Fraction(rng.randint(lo, hi), 1000)
                for zone in c["zones"]}
    return types


def offerings(it: dict, vector: str) -> list:
    """(zone, capacity type, price, available) of a type, its spot prices
    from ``vector``."""
    return [(zone, ct, float(it["spot_exact"][vector][zone])
             if ct == S.SPOT else price, available)
            for zone, ct, price, available in it["offerings"]]


def deployments(cfg: dict, seed: int) -> list:
    """The fleet's deployments: deployment d's (cpu, memory) request starts
    as shape (d mod 5, (d div 5) mod 5) of the 5 x 5 shapes and the seed
    permutes those shapes among the deployments."""
    f = cfg["fleet"]
    cpus, mems = f["pod_cpu_shapes"], f["pod_memory_shapes"]
    n = f["deployments"]
    shapes = [(d % len(cpus), (d // len(cpus)) % len(mems)) for d in range(n)]
    S.rng_for(seed, "spot-shapes").shuffle(shapes)
    return [{"name": f"spot-deploy-{d:03d}", "app": f"spot-deploy-{d:03d}",
             "cpu": S.quantity(cpus[ci]), "memory": S.quantity(mems[mi])}
            for d, (ci, mi) in enumerate(shapes)]


def holds(it: dict, pods: int, cpu: int, memory: int) -> bool:
    """Whether a type's allocatable holds ``pods`` pods of one request."""
    a = S.allocatable(it)
    return (a["cpu"] >= pods * cpu and a["memory"] >= pods * memory
            and a["pods"] >= pods * 1000)


def filled(it: dict, pods: int, cpu: int, memory: int, least: dict) -> bool:
    """Whether ``pods`` pods of one request leave a type's allocatable too
    little room for any pod of the fleet (``least``: the smallest cpu and
    memory requests)."""
    a = S.allocatable(it)
    return (a["cpu"] - pods * cpu < least["cpu"]
            or a["memory"] - pods * memory < least["memory"]
            or a["pods"] - pods * 1000 < 1000)


def fleet(cfg: dict, types: list, seed: int) -> dict:
    """``nodes`` initialized, consolidatable spot nodes of one NodePool,
    round-robin over the zones. Node i holds 1 to ``max_replicas``
    replicas of one deployment, both drawn by the seed; its type is the
    cheapest offering of the pods' OS in its zone under ``p0`` whose
    allocatable holds them (ties by exact price, then name). Under the
    ``node_type`` "cheapest_filled" it is also one that they fill, leaving
    room for no pod of the fleet: a fleet packed full, in which no node's
    pods fit on the others. The seed picks the
    ``protected_share`` of nodes whose first pod is annotated
    do-not-disrupt."""
    f = cfg["fleet"]
    if f["node_type"] not in NODE_TYPES:
        raise ValueError(f"unknown node_type {f['node_type']!r}")
    fill = f["node_type"] == "cheapest_filled"
    zones = cfg["catalog"]["zones"]
    deps = deployments(cfg, seed)
    rng = S.rng_for(seed, "spot-fleet")
    n = f["nodes"]
    picks = [(rng.randrange(len(deps)), rng.randint(1, f["max_replicas"]))
             for _ in range(n)]
    protected = set(rng.sample(range(n), round(f["protected_share"] * n)))
    eligible = [it for it in types if it["os"] == f["os"]]
    least = {"cpu": min(d["cpu"] for d in deps),
             "memory": min(d["memory"] for d in deps)}
    cheapest: dict = {}
    nodes = []
    for i, (d, reps) in enumerate(picks):
        zone = zones[i % len(zones)]
        dep = deps[d]
        key = (dep["cpu"], dep["memory"], reps, zone)
        if key not in cheapest:
            cheapest[key] = min(
                (it for it in eligible
                 if holds(it, reps, dep["cpu"], dep["memory"])
                 and (not fill
                      or filled(it, reps, dep["cpu"], dep["memory"], least))),
                key=lambda it: (it["spot_exact"]["p0"][zone], it["name"]))
        name = f"spot-node-{i:05d}"
        nodes.append({
            "name": name, "type": cheapest[key]["name"], "zone": zone,
            "capacity_type": S.SPOT, "deployment": d,
            "pods": [f"spot-pod-{i:05d}-{j}" for j in range(reps)],
            "pod_requests": {"cpu": dep["cpu"], "memory": dep["memory"]},
            "do_not_disrupt": i in protected})
    return {"nodes": nodes, "deployments": deps, "budget": f["budget"],
            "os": f["os"]}
