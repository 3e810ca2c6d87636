"""The tenant cell's inputs as plain data, drawn from a configuration file
and ``--seed``: weighted NodePools, six of them tainted team pools, a
pending burst whose deployments belong to a team or are general, and the
running nodes of every pool.

As in ``spec.py``, nothing here imports the program: the same records
feed the program (``tenant_objects.py``) and the reference
(``reference/tenant_check.py``). Quantities are integer milliunits. A
taint or a toleration is a (key, value, effect) triple; a toleration is
of the ``Equal`` operator unless its value is None (``Exists``)."""

from __future__ import annotations

from . import spec as S

CAPACITY_TYPE = "karpenter.sh/capacity-type"


def nodepools(cfg: dict) -> list:
    """Each NodePool of the configuration: name, weight (0 without one),
    template labels, template taints and the capacity types its
    requirements allow (None: any)."""
    ten = cfg["tenancy"]
    out = []
    for p in cfg["nodepools"]:
        team = p.get("team")
        out.append({
            "name": p["name"], "weight": p.get("weight") or 0,
            "labels": {ten["label"]: team} if team else {},
            "taints": [(ten["label"], team, ten["taint_effect"])]
            if team else [],
            "capacity_types": p.get("capacity_types")})
    return out


def by_weight(pools: list) -> list:
    """Highest weight first, name breaking ties, as Karpenter orders them."""
    return sorted(pools, key=lambda p: (-p["weight"], p["name"]))


def burst(cfg: dict, seed: int, k: int) -> dict:
    """Burst ``k`` of a seed: ``spec.burst``'s deployments and arrival
    order, each deployment also carrying its tenancy. Every
    ``general_every``-th deployment is general and takes the next of
    ``general_selectors`` as its nodeSelector; the others belong to the
    teams in turn, each tolerating its team's taint and selecting its
    team's label."""
    b = S.burst(cfg, seed, k)
    p, ten = cfg["pods"], cfg["tenancy"]
    teams = [q["team"] for q in cfg["nodepools"] if q.get("team")]
    every, selectors = p["general_every"], p["general_selectors"]
    n_general = n_team = 0
    for d, dep in enumerate(b["deployments"]):
        if d % every == every - 1:
            dep.update(team=None,
                       selector=dict(selectors[n_general % len(selectors)]),
                       tolerations=[])
            n_general += 1
        else:
            team = teams[n_team % len(teams)]
            dep.update(team=team, selector={ten["label"]: team},
                       tolerations=[(ten["label"], team,
                                     ten["taint_effect"])])
            n_team += 1
    return b


def existing_nodes(cfg: dict, types: list, seed: int) -> list:
    """The cluster's initialized nodes, ``per_pool`` of each NodePool:
    types of at most ``max_cpu`` vCPUs drawn by the seed, round-robin over
    the zones and the pool's capacity types, each carrying its pool's
    template labels and taints and one bound pod that uses a seeded share
    ``used`` of its cpu and memory."""
    e = cfg["existing_nodes"]
    lo, hi = e["used"]
    zones = cfg["catalog"]["zones"]
    small = [it for it in types if it["cpu"] <= e["max_cpu"]]
    rng = S.rng_for(seed, "tenant-nodes")
    out = []
    for pool in nodepools(cfg):
        cts = pool["capacity_types"] or list(S.CAPACITY_TYPES)
        for i in range(e["per_pool"]):
            it = small[rng.randrange(len(small))]
            alloc = S.allocatable(it)
            used = rng.uniform(lo, hi)
            name = f"{pool['name']}-node-{i:04d}"
            out.append({
                "name": name, "type": it["name"], "pool": pool["name"],
                "zone": zones[i % len(zones)],
                "capacity_type": cts[(i // len(zones)) % len(cts)],
                "labels": dict(pool["labels"]),
                "taints": list(pool["taints"]),
                "pod": f"bound-{name}",
                "used": {"cpu": int(alloc["cpu"] * used),
                         "memory": int(alloc["memory"] * used)}})
    return out


def node_labels(node: dict, it: dict) -> dict:
    """The labels a node's selectors are held to: its type's, its zone,
    capacity type and NodePool, and its pool's template labels."""
    return {"node.kubernetes.io/instance-type": it["name"],
            "kubernetes.io/arch": it["arch"], "kubernetes.io/os": it["os"],
            "topology.kubernetes.io/zone": node["zone"],
            "topology.kubernetes.io/region": it["region"],
            CAPACITY_TYPE: node["capacity_type"],
            "karpenter.sh/nodepool": node["pool"], **node["labels"]}


def tolerates(tolerations: list, taints: list) -> bool:
    """Whether tolerations of (key, value, effect) tolerate every taint: an
    empty key or effect matches any, a value of None is the ``Exists``
    operator's (any value)."""
    return all(any((not k or k == t[0]) and (not e or e == t[2])
                   and (v is None or v == t[1]) for k, v, e in tolerations)
               for t in taints)
