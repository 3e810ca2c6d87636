"""The benchmark's inputs as plain data, drawn from a configuration file and
``--seed``.

Nothing here imports the program: the same plain records feed the program
(through ``objects.py``, which builds its API objects from them) and the
reference (``reference/``), so both sides judge the same inputs. Every
quantity is an integer in milliunits, as Kubernetes quantities are parsed:
cpu "250m" -> 250, memory "1Gi" -> 1073741824000, pods "64" -> 64000.
"""

from __future__ import annotations

import math
import random
import re
from fractions import Fraction

SPOT = "spot"
ON_DEMAND = "on-demand"
CAPACITY_TYPES = (SPOT, ON_DEMAND)

# the nine deployment kinds of the pod mix, in the order deployment d takes
# kind d % 9: the reference scheduling benchmark's six, then a minDomains
# spread, a zonal spread with hostname anti-affinity, and a spread whose
# selector matches other pods
KINDS = ("generic", "zone_spread", "host_spread", "host_affinity",
         "zone_affinity", "host_anti", "zone_spread_min_domains",
         "zone_spread_host_anti", "zone_spread_other")

_BINARY = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40}
_QTY = re.compile(r"^([0-9.]+)(m|Ki|Mi|Gi|Ti)?$")


def quantity(value) -> int:
    """A Kubernetes quantity in integer milliunits ("100m" -> 100, "2" ->
    2000, "1Gi" -> 1073741824000); fractions round up."""
    if isinstance(value, int):
        return value * 1000
    m = _QTY.match(str(value).strip())
    if not m:
        raise ValueError(f"invalid quantity {value!r}")
    num, suffix = Fraction(m.group(1)), m.group(2)
    if suffix == "m":
        return math.ceil(num)
    return math.ceil(num * _BINARY.get(suffix, 1) * 1000)


def rng_for(seed: int, *what) -> random.Random:
    """A generator for one part of the inputs: the same seed and part give
    the same draws whatever else a run makes."""
    return random.Random(":".join(map(str, (seed,) + what)))


# --------------------------------------------------------------------------
# the instance-type catalog
# --------------------------------------------------------------------------

def catalog(cfg: dict) -> list:
    """The kwok-style catalog a configuration names (kwok's
    gen_instance_types.go: cpu sizes x memory factors x OS x arch, each
    type offered in every zone as spot and on-demand). With ``cpu_sizes``
    absent the cpu ladder counts up from 1 until ``count`` types exist.
    Each type: name, labels, capacity, overhead (kube-reserved) and its
    offerings as (zone, capacity type, price, available)."""
    c = cfg["catalog"]
    mfs, oses, arches = c["memory_factors"], c["oses"], c["arches"]
    count = c.get("count")
    sizes = c.get("cpu_sizes") or range(
        1, math.ceil(count / (len(mfs) * len(oses) * len(arches))) + 1)
    out = []
    for cpu in sizes:
        for mf in mfs:
            for os_ in oses:
                for arch in arches:
                    if count is not None and len(out) >= count:
                        return out
                    out.append(_instance_type(c, cpu, mf, os_, arch))
    return out


def _instance_type(c: dict, cpu: int, mf: int, os_: str, arch: str) -> dict:
    family = c["families"].get(str(mf), "e")
    name = f"{family}-{cpu}x-{arch}-{os_}"
    mem_gib = cpu * mf
    # the provider's price formula, in its own order of operations; the
    # exact decimal price beside it, where two types can tie
    price = c["price_per_vcpu"] * cpu + c["price_per_gib"] * mem_gib
    exact = (Fraction(str(c["price_per_vcpu"])) * cpu
             + Fraction(str(c["price_per_gib"])) * mem_gib)
    offerings = [(zone, ct, price * c["spot_factor"] if ct == SPOT else price,
                  True)
                 for zone in c["zones"] for ct in CAPACITY_TYPES]
    exact_prices = {ct: exact * Fraction(str(c["spot_factor"]))
                    if ct == SPOT else exact for ct in CAPACITY_TYPES}
    return {
        "name": name, "cpu": cpu, "memory_gib": mem_gib, "arch": arch,
        "os": os_, "size": f"{cpu}x", "family": family,
        "zones": list(c["zones"]), "region": c["region"],
        "capacity": {
            "cpu": cpu * 1000,
            "memory": quantity(f"{mem_gib}Gi"),
            "pods": min(cpu * c["pods_per_cpu"], c["max_pods"]) * 1000,
            "ephemeral-storage": quantity(c["ephemeral_storage"])},
        "overhead": {k: quantity(v) for k, v in c["kube_reserved"].items()},
        "offerings": offerings, "exact_prices": exact_prices,
    }


# --------------------------------------------------------------------------
# a pending burst
# --------------------------------------------------------------------------

def burst(cfg: dict, seed: int, k: int) -> dict:
    """Burst ``k`` of a seed: ``deployments`` x ``replicas`` pods cycling
    through KINDS. Deployment d's (cpu, memory) request starts as shape
    (d mod 5, (d div 5) mod 5) of the mix's 5 x 5; the seed permutes those
    shapes among the deployments of each kind, so every burst of every
    seed carries the same multiset of (kind, shape) pairs, and it draws the
    order the pods arrive in."""
    p = cfg["pods"]
    rng = rng_for(seed, "burst", k)
    cpus, mems = p["cpu_shapes"], p["memory_shapes"]
    n_dep, reps = p["deployments"], p["replicas"]
    shape = {}
    for kind in range(len(KINDS)):
        members = [d for d in range(n_dep) if d % len(KINDS) == kind]
        shapes = [(d % len(cpus), (d // len(cpus)) % len(mems))
                  for d in members]
        rng.shuffle(shapes)
        shape.update(zip(members, shapes))
    deployments = []
    for d in range(n_dep):
        ci, mi = shape[d]
        deployments.append({
            "name": f"b{k}-d{d}", "app": f"b{k}-deploy-{d}",
            "kind": KINDS[d % len(KINDS)],
            "other_app": f"b{k}-unrelated-{d}",
            "cpu": quantity(cpus[ci]), "memory": quantity(mems[mi]),
            "replicas": reps})
    order = [(d, i) for d in range(n_dep) for i in range(reps)]
    rng.shuffle(order)
    return {"deployments": deployments,
            "pods": [f"b{k}-d{d}-{i}" for d, i in order],
            "pod_deployment": {f"b{k}-d{d}-{i}": d for d, i in order}}


def constraints(kind: str) -> dict:
    """What a deployment of ``kind`` asks of its placement, in the terms
    the reference checks: a zonal spread (max skew, min domains, whether
    its selector matches the deployment itself), one pod a host, all pods
    on one host, all pods in one zone."""
    zone_spread = None
    if kind in ("zone_spread", "zone_spread_host_anti"):
        zone_spread = {"max_skew": 1, "min_domains": None, "self": True}
    elif kind == "zone_spread_min_domains":
        zone_spread = {"max_skew": 1, "min_domains": 4, "self": True}
    elif kind == "zone_spread_other":
        zone_spread = {"max_skew": 1, "min_domains": None, "self": False}
    return {"zone_spread": zone_spread,
            "one_per_host": kind in ("host_spread", "host_anti",
                                     "zone_spread_host_anti"),
            "one_host": kind == "host_affinity",
            "one_zone": kind == "zone_affinity"}


# --------------------------------------------------------------------------
# existing nodes and the consolidation fleet
# --------------------------------------------------------------------------

def allocatable(it: dict) -> dict:
    return {k: v - it["overhead"].get(k, 0) for k, v in it["capacity"].items()}


def existing_nodes(cfg: dict, types: list, seed: int) -> list:
    """The cluster's initialized nodes: types drawn from the catalog by the
    seed, round-robin over the zones and both capacity types, each carrying
    one bound pod that uses a seeded 30-90% of its cpu and memory."""
    n = cfg["existing_nodes"]["count"]
    lo, hi = cfg["existing_nodes"]["used"]
    zones = cfg["catalog"]["zones"]
    rng = rng_for(seed, "nodes")
    out = []
    for i in range(n):
        it = types[rng.randrange(len(types))]
        alloc = allocatable(it)
        used = rng.uniform(lo, hi)
        out.append({
            "name": f"node-{i:05d}", "type": it["name"],
            "zone": zones[i % len(zones)],
            "capacity_type": CAPACITY_TYPES[(i // len(zones)) % 2],
            "pod": f"bound-{i:05d}",
            "used": {"cpu": int(alloc["cpu"] * used),
                     "memory": int(alloc["memory"] * used)}})
    return out


def fleet(cfg: dict, types: list, seed: int) -> dict:
    """The consolidation fleet: ``nodes`` initialized, consolidatable
    on-demand nodes of one type in one zone, one running pod each. The
    seed permutes a fixed multiset of pod shapes over the nodes and picks
    which ``protected`` nodes hold a pod with the do-not-disrupt
    annotation."""
    f = cfg["fleet"]
    n = f["nodes"]
    rng = rng_for(seed, "fleet")
    node_type = next(it for it in types if it["name"] == f["node_type"])
    shapes = [(quantity(c), quantity(m))
              for c in f["pod_cpu_shapes"] for m in f["pod_memory_shapes"]]
    pods = [shapes[i % len(shapes)] for i in range(n)]
    rng.shuffle(pods)
    protected = set(rng.sample(range(n), round(f["protected_share"] * n)))
    nodes = []
    for i in range(n):
        cpu, mem = pods[i]
        nodes.append({
            "name": f"fleet-node-{i:05d}", "type": node_type["name"],
            "zone": f["zone"], "capacity_type": ON_DEMAND,
            "pod": f"fleet-pod-{i:05d}",
            "pod_requests": {"cpu": cpu, "memory": mem},
            "do_not_disrupt": i in protected})
    return {"nodes": nodes, "budget": f["budget"],
            "batch": f["max_candidates"]}
