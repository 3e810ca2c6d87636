"""The plain reference for a provisioning solve over tenant NodePools: what
Karpenter's scheduling semantics say of a solve of the tenant cell's
inputs, worked out again from the plain records of ``tenant_spec.py`` and
held against what the program answered.

It imports neither JAX, nor the JAX package, nor the program; besides
NumPy it uses the other reference modules. It reads the program's answer
only to judge it: the claims (their pods, NodePool, taints, zones, other
requirements and instance-type options in order), the pods placed on
existing nodes, the pod errors, and the device's existing-node fit and
capacity for the solve.

Every number it returns counts faults, so each limit is 0:

- ``feasibility_mismatch``: entries of the device's existing-node fit and
  capacity that differ from the same quantities worked out here: a group
  fits a node when it tolerates the node's taints, its nodeSelector holds
  on the node's labels and the node has room for one of its pods;
- ``taint_violation``: pods on an existing node, or on a claim, whose
  taints (the claim's, and its NodePool's template taints, which must be
  the same) they do not tolerate;
- ``selector_violation``: pods whose nodeSelector does not hold on their
  node's labels, or on their claim: a key the claim's requirements pin to
  other values or leave open, or an option whose type labels differ;
- ``pool_mismatch``: claims whose NodePool is not the first, in weight
  order, that admits every pod on them. A pool admits a pod when the pod
  tolerates its template taints and each nodeSelector key is the pool's
  template label of that value, a capacity type its requirements allow,
  or a label of its types that some type takes at that value;
- ``option_mismatch``: claims whose options are not exactly the pool's
  types that hold the claim's pods, whose labels take the values the pods
  select, offered in the claim's zones and in the capacity types that the
  pool and the pods allow, cheapest first (name breaks ties); or whose
  capacity types leave that set;
- ``placement_violation``: zonal spreads skewed or on claims not pinned
  to one zone, two pods of a one-per-host deployment on one node, a
  hostname affinity split, a zonal affinity with no common zone, an
  existing node filled past its allocatable or unknown;
- ``unaccounted_pods``: pods placed twice, never answered, unknown, or
  reported as errors though a node could still take them;
- ``existing_room_unused``: pods that ask nothing of their placement but
  room, put on a new claim while an existing node they may use (whose
  taints they tolerate and whose labels their nodeSelector holds on)
  still has room for one of them after the solve. A node's room only
  shrinks as a solve goes on, and Karpenter's scheduler tries existing
  nodes before claims.
"""

from __future__ import annotations

import numpy as np

from .. import tenant_spec as TS
from ..spec import constraints as _constraints
from . import solve_check as SC
from . import topology

FAULTS = ("feasibility_mismatch", "taint_violation", "selector_violation",
          "pool_mismatch", "option_mismatch", "placement_violation",
          "unaccounted_pods", "existing_room_unused")
ZONE = "topology.kubernetes.io/zone"
# what a deployment that asks nothing of its placement but room asks
_FREE = _constraints("generic")


class Reference:
    """The judge of one configuration's solves: its catalog, NodePools
    (in weight order) and existing nodes, with each node's room and
    labels."""

    def __init__(self, types: list, pools: list, nodes: list):
        self.cat = SC.Catalog(types)
        self.order = TS.by_weight(pools)
        self.pools = {p["name"]: p for p in pools}
        self.nodes = nodes
        by_name = {t["name"]: t for t in types}
        self.labels = [TS.node_labels(n, by_name[n["type"]]) for n in nodes]
        self.room = SC.node_room(self.cat, nodes) if nodes else None
        self.n_idx = {n["name"]: i for i, n in enumerate(nodes)}
        self.all_cts = set(self.cat.cts)
        self._usable: dict = {}

    # -- what a deployment may use -------------------------------------------

    @staticmethod
    def _key(dep: dict) -> tuple:
        return (tuple(dep["tolerations"]), tuple(sorted(dep["selector"].items())))

    def usable(self, dep: dict) -> np.ndarray:
        """Existing nodes [N] whose taints ``dep`` tolerates and whose
        labels its nodeSelector holds on."""
        key = self._key(dep)
        if key not in self._usable:
            self._usable[key] = np.array([
                TS.tolerates(dep["tolerations"], n["taints"])
                and all(lab.get(k) == v for k, v in dep["selector"].items())
                for n, lab in zip(self.nodes, self.labels)], dtype=bool)
        return self._usable[key]

    def admits(self, pool: dict, dep: dict) -> bool:
        """Whether the NodePool ``pool`` may hold a pod of ``dep``."""
        if not TS.tolerates(dep["tolerations"], pool["taints"]):
            return False
        for k, v in dep["selector"].items():
            if k in pool["labels"]:
                ok = pool["labels"][k] == v
            elif k == TS.CAPACITY_TYPE:
                ok = v in (pool["capacity_types"] or self.all_cts)
            elif k in SC.TYPE_LABELS:
                field = SC.TYPE_LABELS[k]
                ok = any(t[field] == v for t in self.cat.types)
            else:
                ok = False
            if not ok:
                return False
        return True

    def allowed(self, pool: dict, deps: list):
        """(capacity types or None for any, {type label: values}) that the
        pool and the pods of ``deps`` leave a claim."""
        cts = set(pool["capacity_types"] or self.all_cts)
        labels: dict = {}
        for dep in deps:
            for k, v in dep["selector"].items():
                if k == TS.CAPACITY_TYPE:
                    cts &= {v}
                elif k in SC.TYPE_LABELS:
                    labels[k] = labels.get(k, {v}) & {v}
        return (None if cts == self.all_cts else sorted(cts)), labels

    # -- the check -----------------------------------------------------------

    def check(self, burst: dict, answer: dict) -> dict:
        """Judge one solve; returns the fault counts of FAULTS."""
        cat = self.cat
        deps = burst["deployments"]
        dep_of = burst["pod_deployment"]
        req = np.stack([SC.requests(d) for d in deps])
        faults = dict.fromkeys(FAULTS, 0)
        feas = answer.get("feasibility")
        faults["feasibility_mismatch"] = (
            self._feasibility_mismatch(deps, req, feas) if feas is not None
            else 1)

        seen: dict = {}
        locations = []     # (kind, key, zones, counts [D])
        claimed = []       # counts [D] of each claim

        def count(pods) -> np.ndarray:
            counts = np.zeros(len(deps), dtype=np.int64)
            for p in pods:
                if p not in dep_of:
                    faults["unaccounted_pods"] += 1
                    continue
                counts[dep_of[p]] += 1
                seen[p] = seen.get(p, 0) + 1
            return counts

        for ci, c in enumerate(answer["claims"]):
            counts = count(c["pods"])
            self._judge_claim(c, deps, counts, req, faults)
            locations.append(("claim", ci, c["zones"], counts))
            claimed.append(counts)
        left = None if self.room is None else self.room.copy()
        for name, pods in answer["existing"].items():
            counts = count(pods)
            if name not in self.n_idx:
                faults["placement_violation"] += 1
                continue
            i = self.n_idx[name]
            left[i] -= counts @ req
            if np.any(left[i] < 0):
                faults["placement_violation"] += 1
            node, lab = self.nodes[i], self.labels[i]
            for d in np.flatnonzero(counts):
                dep = deps[d]
                if not TS.tolerates(dep["tolerations"], node["taints"]):
                    faults["taint_violation"] += int(counts[d])
                if any(lab.get(k) != v for k, v in dep["selector"].items()):
                    faults["selector_violation"] += int(counts[d])
            locations.append(("node", i, [node["zone"]], counts))
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
            self.room)
        faults["existing_room_unused"] = self._room_unused(
            deps, req, claimed, left)
        return faults

    def _judge_claim(self, c: dict, deps: list, counts: np.ndarray,
                     req: np.ndarray, faults: dict) -> None:
        """The faults of one claim holding ``counts`` [D] pods."""
        on = np.flatnonzero(counts)
        pool = self.pools.get(c["pool"])
        if pool is None:
            faults["pool_mismatch"] += 1
            faults["taint_violation"] += int(counts.sum())
            return
        taints = list(c["taints"])
        if sorted(taints) != sorted(pool["taints"]):
            faults["taint_violation"] += 1
        types = [self.cat.types[self.cat.index[n]]
                 for n in c["options"] if n in self.cat.index]
        for d in on:
            if not TS.tolerates(deps[d]["tolerations"],
                                taints + pool["taints"]):
                faults["taint_violation"] += int(counts[d])
            if not self._selected(deps[d], c, types):
                faults["selector_violation"] += int(counts[d])
        first = next((p["name"] for p in self.order
                      if all(self.admits(p, deps[d]) for d in on)), None)
        if first != pool["name"]:
            faults["pool_mismatch"] += 1
        cts, labels = self.allowed(pool, [deps[d] for d in on])
        if c["capacity_types"] is not None and cts is not None and \
                not set(c["capacity_types"]) <= set(cts):
            faults["option_mismatch"] += 1
        want = self.cat.options(counts @ req, c["zones"], cts, labels)
        if not want or want != c["options"]:
            faults["option_mismatch"] += 1

    @staticmethod
    def _selected(dep: dict, c: dict, types: list) -> bool:
        """Whether a claim keeps ``dep``'s nodeSelector: each key pinned to
        its value by the claim's requirements (zones and capacity types
        apart), and every option's type labels taking it."""
        for k, v in dep["selector"].items():
            if k == ZONE:
                held = c["zones"]
            elif k == TS.CAPACITY_TYPE:
                held = c["capacity_types"]
            else:
                held = c["requirements"].get(k)
            if k in SC.TYPE_LABELS:
                field = SC.TYPE_LABELS[k]
                if any(t[field] != v for t in types):
                    return False
                if held is not None and set(held) != {v}:
                    return False
            elif held is None or set(held) != {v}:
                return False
        return True

    def _feasibility_mismatch(self, deps: list, req: np.ndarray,
                              feas: dict) -> int:
        """Entries of the device's existing-node fit and capacity that
        differ from the reference's; padding columns must not fit."""
        cols = [self.n_idx[n] for n in feas["nodes"]]
        n = len(cols)
        room = self.room[cols]
        bad = 0
        for g, d in enumerate(feas["groups"]):
            cap = SC._floor_div(room, req[d])
            ok = self.usable(deps[d])[cols] & (cap >= 1)
            bad += int(np.sum(feas["exist_ok"][g, :n] != ok))
            bad += int(np.sum(feas["exist_cap"][g, :n]
                              != np.minimum(cap, 2**31 - 1)))
            bad += int(np.sum(feas["exist_ok"][g, n:]))
        return bad

    def _room_unused(self, deps: list, req: np.ndarray, claimed: list,
                     left) -> int:
        """Pods of free deployments on new claims while an existing node
        they may use, after the solve, has room ``left`` for one."""
        if left is None or not claimed:
            return 0
        on_claims = sum(claimed)
        bad = 0
        for d, dep in enumerate(deps):
            if not on_claims[d] or _constraints(dep["kind"]) != _FREE:
                continue
            fits = np.all(left >= req[d][None, :], axis=1)
            if np.any(fits & self.usable(dep)):
                bad += int(on_claims[d])
        return bad
