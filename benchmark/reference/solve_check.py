"""The plain reference for a provisioning solve: what Karpenter's scheduling
semantics say of a solve over the benchmark's inputs, worked out again in
NumPy from the plain records of ``spec.py``, and held against what the
program answered.

It imports neither JAX, nor the JAX package, nor the program. It reads the
program's answer only to judge it: the claims (their pods, the zones and
other requirements they carry, their instance-type options in order), the
pods placed on existing nodes, the pod errors, and the feasibility tensors
the device computed for the solve.

Every number it returns counts faults, so each limit is 0:

- ``feasibility_mismatch``: entries of the device's feasibility outputs
  (it_ok, pods-per-node, it_ok by zone, zone admission, existing-node fit
  and capacity) that differ from the same quantities worked out here from
  the catalog, the requests and the nodes;
- ``option_mismatch``: claims whose instance-type options are not exactly
  the types whose allocatable holds the claim's pods and that are offered
  in its zones and capacity types, cheapest first (name breaks ties), or
  whose requirements name a label the catalog cannot satisfy;
- ``placement_violation``: zonal spreads skewed past their max skew, or
  placed on a claim not pinned to one zone; two pods of a one-per-host
  deployment on one node; a hostname affinity split over nodes; a zonal
  affinity whose placements share no zone; an existing node filled past
  its allocatable;
- ``unaccounted_pods``: pods placed twice, never answered, unknown, or
  reported as errors though a node could still take them;
- ``existing_room_unused``: pods that ask nothing of their placement but
  room, put on a new claim though an existing node still has room for one
  of them once the solve's placements are in. A node's room only shrinks
  as a solve goes on, so it had that room when the pod was placed, and
  Karpenter's scheduler tries existing nodes before new claims;
- ``claims_mergeable``: claims holding only such pods, one of whose pods
  a type compatible with both of them would hold together with another
  such claim's pods. Whichever of the two claims opened later, the other
  was open then with a part of its final pods, and that type (among its
  options, which only narrow) held those and the first pod of the later
  one: the scheduler tries open claims before it opens one.
"""

from __future__ import annotations

import math

import numpy as np

from ..spec import constraints as _constraints

RESOURCES = ("cpu", "memory", "pods")
NODEPOOL = "karpenter.sh/nodepool"
# type labels a claim's requirements may narrow, by the catalog record's key
TYPE_LABELS = {"node.kubernetes.io/instance-type": "name",
               "kubernetes.io/arch": "arch", "kubernetes.io/os": "os",
               "topology.kubernetes.io/region": "region",
               "karpenter.kwok.sh/instance-size": "size",
               "karpenter.kwok.sh/instance-family": "family"}
PPN_MAX = 32767    # the pods-per-node output is int16
# what a deployment that asks nothing of its placement but room asks
_FREE = _constraints("generic")


class Catalog:
    """The catalog's arrays: allocatable [T, R] in milliunits, offerings
    as (zone, capacity type) availability and price. Prices are compared
    as exact decimals: the provider's formula gives some types equal
    prices that binary floats split, and those ties go by name."""

    def __init__(self, types: list):
        self.types = types
        self.names = [t["name"] for t in types]
        self.index = {n: i for i, n in enumerate(self.names)}
        self.alloc = np.array(
            [[t["capacity"].get(r, 0) - t["overhead"].get(r, 0)
              for r in RESOURCES] for t in types], dtype=np.int64)
        self.zones = sorted({o[0] for t in types for o in t["offerings"]})
        self.cts = sorted({o[1] for t in types for o in t["offerings"]})
        shape = (len(types), len(self.zones), len(self.cts))
        self.offered = np.zeros(shape, dtype=bool)
        exact = np.full(shape, None, dtype=object)
        for i, t in enumerate(types):
            for zone, ct, _, available in t["offerings"]:
                if available:
                    zi, ci = self.zones.index(zone), self.cts.index(ct)
                    self.offered[i, zi, ci] = True
                    exact[i, zi, ci] = t["exact_prices"][ct]
        # the exact prices as integers of their common denominator
        scale = math.lcm(*(p.denominator for p in exact[self.offered]))
        self.price = np.full(shape, np.iinfo(np.int64).max, dtype=np.int64)
        self.price[self.offered] = [int(p * scale)
                                    for p in exact[self.offered]]
        self.name_rank = np.argsort(np.argsort(np.array(self.names)))
        self._memo: dict = {}

    def options(self, total: np.ndarray, zones, cts, labels: dict) -> list:
        """Names of the types that hold ``total`` [R] and are offered in
        one of ``zones`` as one of ``cts`` (None: any), whose labels take
        the values ``labels`` allows, cheapest compatible offering first,
        name breaking ties."""
        key = (total.tobytes(), None if zones is None else tuple(zones),
               None if cts is None else tuple(cts),
               tuple(sorted((k, tuple(sorted(v))) for k, v in labels.items())))
        if key not in self._memo:
            self._memo[key] = self._options(total, zones, cts, labels)
        return self._memo[key]

    def _offered_in(self, zones, cts) -> np.ndarray:
        """Offerings [T, Z, C] in one of ``zones`` as one of ``cts``."""
        zmask = np.array([zones is None or z in zones for z in self.zones])
        cmask = np.array([cts is None or c in cts for c in self.cts])
        return self.offered & zmask[None, :, None] & cmask[None, None, :]

    def allowed(self, zones, cts, labels: dict) -> np.ndarray:
        """Types [T] offered in ``zones`` as ``cts`` whose labels take the
        values ``labels`` allows, whatever they hold."""
        ok = self._offered_in(zones, cts).any(axis=(1, 2))
        for key, values in labels.items():
            field = TYPE_LABELS[key]
            ok &= np.array([t[field] in values for t in self.types])
        return ok

    def _options(self, total, zones, cts, labels) -> list:
        sel = self._offered_in(zones, cts)
        ok = np.all(self.alloc >= total[None, :], axis=1) & self.allowed(
            zones, cts, labels)
        idx = np.flatnonzero(ok)
        price = np.where(sel, self.price, np.iinfo(np.int64).max
                         ).min(axis=(1, 2))[idx]
        return [self.names[i]
                for i in idx[np.lexsort((self.name_rank[idx], price))]]


def _floor_div(avail: np.ndarray, req: np.ndarray) -> np.ndarray:
    """min over resources of avail // req, requests of 0 unconstrained;
    avail [..., R], req [R] -> [...]."""
    per = np.where(req > 0, np.maximum(avail, 0) // np.maximum(req, 1),
                   np.iinfo(np.int64).max)
    return per.min(axis=-1)


def requests(dep: dict) -> np.ndarray:
    """One pod's requests [R]: its cpu and memory, and one pod."""
    return np.array([dep["cpu"], dep["memory"], 1000], dtype=np.int64)


def feasibility(cat: Catalog, deps: list, nodes: list) -> dict:
    """The feasibility quantities of each deployment [D] against each type
    [T], zone [Z] and existing node [N]: pods of it a fresh node of each
    type holds, which types and zones can take one, and each node's room
    for them."""
    req = np.stack([requests(d) for d in deps])                  # [D, R]
    ppn = np.stack([_floor_div(cat.alloc, r) for r in req])      # [D, T]
    offered_z = cat.offered.any(axis=2)                          # [T, Z]
    it_ok = (ppn >= 1) & offered_z.any(axis=1)[None, :]
    out = {"ppn": np.minimum(ppn, PPN_MAX), "it_ok": it_ok,
           "it_ok_z": it_ok[:, :, None] & offered_z[None, :, :],
           "zone_adm": np.ones((len(deps), len(cat.zones)), dtype=bool)}
    if nodes:
        avail = node_room(cat, nodes)                            # [N, R]
        cap = np.stack([_floor_div(avail, r) for r in req])      # [D, N]
        out["exist_cap"] = np.minimum(cap, 2**31 - 1)
        out["exist_ok"] = cap >= 1
    return out


def node_room(cat: Catalog, nodes: list) -> np.ndarray:
    """Each existing node's room [N, R]: allocatable less its bound pod."""
    return np.stack([
        cat.alloc[cat.index[n["type"]]]
        - np.array([n["used"]["cpu"], n["used"]["memory"], 1000])
        for n in nodes])


def _feasibility_mismatch(cat, deps, nodes, feas: dict) -> int:
    """Entries of the device's outputs that differ from the reference's.
    The rows are the program's groups (each a deployment), the columns its
    type, zone and node orders, which are mapped here by name."""
    rows = [deps[d] for d in feas["groups"]]
    ref = feasibility(cat, rows, nodes)
    t_idx = [cat.index[n] for n in feas["types"]]
    z_idx = [cat.zones.index(z) for z in feas["zones"]]
    bad = 0
    bad += int(np.sum(feas["it_ok"] != ref["it_ok"][:, t_idx]))
    bad += int(np.sum(feas["ppn"] != ref["ppn"][:, t_idx]))
    bad += int(np.sum(feas["it_ok_z"]
                      != ref["it_ok_z"][:, t_idx][:, :, z_idx]))
    bad += int(np.sum(feas["zone_adm"] != ref["zone_adm"][:, z_idx]))
    if nodes:
        n_idx = {n["name"]: i for i, n in enumerate(nodes)}
        cols = [n_idx[n] for n in feas["nodes"]]
        n = len(cols)
        bad += int(np.sum(feas["exist_ok"][:, :n] != ref["exist_ok"][:, cols]))
        bad += int(np.sum(feas["exist_cap"][:, :n]
                          != ref["exist_cap"][:, cols]))
        # rows past the cluster's nodes are padding: nothing may fit there
        bad += int(np.sum(feas["exist_ok"][:, n:]))
    return bad


def check(types: list, burst: dict, nodes: list, answer: dict,
          pool: str) -> dict:
    """Judge one solve. ``answer`` holds the program's ``claims`` (each:
    pods, zones or None, capacity_types or None, other requirements as
    {key: values}, options), ``existing`` ({node: pods}), ``errors``
    ({pod: message}) and ``feasibility`` (see _feasibility_mismatch).
    Returns the four fault counts."""
    from . import topology
    cat = Catalog(types)
    deps = burst["deployments"]
    dep_of = burst["pod_deployment"]
    req = np.stack([requests(d) for d in deps])
    faults = {"feasibility_mismatch": 0, "option_mismatch": 0,
              "placement_violation": 0, "unaccounted_pods": 0,
              "existing_room_unused": 0, "claims_mergeable": 0}
    if answer.get("feasibility") is not None:
        faults["feasibility_mismatch"] = _feasibility_mismatch(
            cat, deps, nodes, answer["feasibility"])
    else:
        faults["feasibility_mismatch"] = 1

    seen: dict = {}
    locations = []     # (kind, key, zones, pods)
    claimed = []       # (claim, labels, counts [D], total [R])
    for ci, c in enumerate(answer["claims"]):
        counts = np.zeros(len(deps), dtype=np.int64)
        for p in c["pods"]:
            if p not in dep_of:
                faults["unaccounted_pods"] += 1
                continue
            counts[dep_of[p]] += 1
            seen[p] = seen.get(p, 0) + 1
        total = counts @ req
        labels = {}
        for key, values in c["requirements"].items():
            if key == NODEPOOL:
                if pool not in values:
                    faults["option_mismatch"] += 1
            elif key in TYPE_LABELS:
                labels[key] = set(values)
            else:
                faults["option_mismatch"] += 1
        want = cat.options(total, c["zones"], c["capacity_types"], labels)
        if not want or want != c["options"]:
            faults["option_mismatch"] += 1
        locations.append(("claim", ci, c["zones"], counts))
        claimed.append((c, labels, counts, total))
    room = node_room(cat, nodes) if nodes else None
    left = None if room is None else room.copy()
    n_idx = {n["name"]: i for i, n in enumerate(nodes)}
    for name, pods in answer["existing"].items():
        counts = np.zeros(len(deps), dtype=np.int64)
        for p in pods:
            if p not in dep_of:
                faults["unaccounted_pods"] += 1
                continue
            counts[dep_of[p]] += 1
            seen[p] = seen.get(p, 0) + 1
        if name not in n_idx:
            faults["placement_violation"] += 1
            continue
        i = n_idx[name]
        left[i] -= counts @ req
        if np.any(left[i] < 0):
            faults["placement_violation"] += 1
        locations.append(("node", i, [nodes[i]["zone"]], counts))
    faults["unaccounted_pods"] += sum(v - 1 for v in seen.values())
    errors = answer["errors"]
    for p in errors:
        if p not in dep_of or p in seen:
            faults["unaccounted_pods"] += 1
    faults["unaccounted_pods"] += sum(
        1 for p in burst["pods"] if p not in seen and p not in errors)
    faults["placement_violation"] += topology.violations(
        deps, cat.zones, locations)
    faults["unaccounted_pods"] += topology.unexplained_errors(
        cat, deps, req, errors, dep_of, locations, answer["claims"],
        room)
    free = np.array([_constraints(d["kind"]) == _FREE for d in deps])
    faults["existing_room_unused"] = existing_room_unused(
        req, free, claimed, left)
    faults["claims_mergeable"] = claims_mergeable(cat, free, claimed)
    return faults


def existing_room_unused(req: np.ndarray, free: np.ndarray, claimed: list,
                         left) -> int:
    """Pods of the deployments ``free`` marks [D] on new claims while some
    existing node's room ``left`` [N, R], after the solve, holds one."""
    if left is None or not claimed:
        return 0
    on_claims = sum(counts for _, _, counts, _ in claimed)
    fits = np.array([bool(np.any(np.all(left >= r[None, :], axis=1)))
                     for r in req])
    return int(on_claims[free & fits].sum())


def claims_mergeable(cat: Catalog, free: np.ndarray, claimed: list,
                     block: int = 512) -> int:
    """Claims of only ``free`` deployments' pods whose pods, with those of
    another such claim of the same zones, capacity types and labels, a
    type allowed there would hold."""
    cohorts: dict = {}
    for c, labels, counts, total in claimed:
        if counts[~free].any():
            continue
        key = (None if c["zones"] is None else tuple(sorted(c["zones"])),
               None if c["capacity_types"] is None
               else tuple(sorted(c["capacity_types"])),
               tuple(sorted((k, tuple(sorted(v))) for k, v in labels.items())))
        cohorts.setdefault(key, []).append(total)
    bad = 0
    for (zones, cts, labels), totals in cohorts.items():
        if len(totals) < 2:
            continue
        allowed = cat.allowed(zones, cts, dict(labels))
        tops = _pareto(cat.alloc[allowed])
        tot = np.stack(totals)                                     # [C, R]
        for lo in range(0, len(tot), block):
            rows = tot[lo:lo + block]
            hit = np.zeros(len(rows), dtype=bool)
            for top in tops:
                slack = top[None, :] - rows                        # [b, R]
                fit = np.all(tot[None, :, :] <= slack[:, None, :], axis=2)
                fit[np.arange(len(rows)), lo + np.arange(len(rows))] = False
                hit |= fit.any(axis=1)
            bad += int(hit.sum())
    return bad


def _pareto(alloc: np.ndarray) -> np.ndarray:
    """The allocatables [P, R] that no other of ``alloc`` [T, R] holds."""
    alloc = np.unique(alloc, axis=0)
    keep = [a for a in alloc
            if not np.any(np.all(alloc >= a, axis=1) & np.any(alloc > a, axis=1))]
    return np.array(keep).reshape(-1, alloc.shape[1])
