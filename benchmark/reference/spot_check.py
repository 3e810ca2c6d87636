"""The plain reference for a single-node spot consolidation decision over
the spot fleet, worked out again from the plain records of
``spot_spec.py`` and held against the command the program computed.

It imports neither JAX, nor the JAX package, nor the program. A node holds
identical pods, so the room the other nodes leave for a candidate's pods
is the sum over those nodes of the least, over resources, of room /
request rounded down, whatever order they are filled in: that gives each
candidate's remainder, the pods no other node takes, exactly. A candidate
can win in one of two ways:

- **delete**: its remainder is 0;
- **spot replace**: the remainder fits one new claim, and at least
  ``MIN_SPOT_TYPES`` spot types that the pods' selector allows and that
  hold the remainder have a worst launch price (the most expensive spot
  offering over the zones) below the candidate's own spot price, all
  under the current vector.

Prices are compared as exact fractions. Every number counts faults, so
each limit is 0:

- ``protected_candidates``: candidates that hold a do-not-disrupt pod, are
  not in the fleet, or appear twice;
- ``wrong_candidate``: a candidate beyond the first, a chosen candidate
  that cannot win, or one with a winnable candidate of strictly lower
  disruption cost (its pod count: every pod's eviction cost is 1) beside
  it; candidates of equal cost may go either way;
- ``wrong_decision``: the verdict is not the one the remainder calls for
  (no-op when no candidate can win);
- ``option_mismatch``: a replacement not pinned to spot, or whose options
  are not the at most ``MIN_SPOT_TYPES`` cheapest such types, cheapest
  first by exact price, ties by name;
- ``placement_violation``: moved pods not placed exactly once, pods that
  did not move placed, pods placed on a candidate, or a node overfilled.
"""

from __future__ import annotations

import math

import numpy as np

MIN_SPOT_TYPES = 15
RESOURCES = ("cpu", "memory", "pods")
FAULTS = ("protected_candidates", "wrong_candidate", "wrong_decision",
          "option_mismatch", "placement_violation")


def _alloc(it: dict) -> np.ndarray:
    return np.array([it["capacity"][r] - it["overhead"].get(r, 0)
                     for r in RESOURCES], dtype=np.int64)


def _request(node: dict) -> np.ndarray:
    r = node["pod_requests"]
    return np.array([r["cpu"], r["memory"], 1000], dtype=np.int64)


class Fleet:
    """The fleet's arrays: each node's room and request, and for each
    type its allocatable and its worst and cheapest spot price under one
    vector, as exact integers over one common denominator."""

    def __init__(self, types: list, fleet: dict, vector: str):
        self.types, self.fleet, self.vector = types, fleet, vector
        self.index = {it["name"]: t for t, it in enumerate(types)}
        self.alloc = np.stack([_alloc(it) for it in types])
        self.allowed = np.array([it["os"] == fleet["os"] for it in types])
        prices = [p for it in types for p in it["spot_exact"][vector].values()]
        den = math.lcm(*(p.denominator for p in prices))
        units = [{z: int(p * den) for z, p in it["spot_exact"][vector].items()}
                 for it in types]
        # int64 where the units fit it, Python integers past that
        kind = np.int64 if max(max(u.values()) for u in units) < 2**62 \
            else object
        self.worst = np.array([max(u.values()) for u in units], dtype=kind)
        self.cheapest = np.array([min(u.values()) for u in units],
                                 dtype=kind)
        self.units = units
        nodes = fleet["nodes"]
        self.node_index = {n["name"]: i for i, n in enumerate(nodes)}
        self.reps = np.array([len(n["pods"]) for n in nodes], dtype=np.int64)
        self.req = np.stack([_request(n) for n in nodes])
        self.room = (np.stack([self.alloc[self.index[n["type"]]]
                               for n in nodes])
                     - self.reps[:, None] * self.req)
        self.pod_node = {p: i for i, n in enumerate(nodes) for p in n["pods"]}

    def caps(self, req: np.ndarray) -> np.ndarray:
        """Pods of request ``req`` each node's room takes."""
        return (self.room // req[None, :]).min(axis=1)

    def remainders(self) -> np.ndarray:
        """Each node's pods that no other node has room for."""
        out = np.zeros(len(self.reps), dtype=np.int64)
        shapes: dict = {}
        for i, req in enumerate(self.req):
            shapes.setdefault(tuple(req), []).append(i)
        for shape, members in shapes.items():
            caps = self.caps(np.array(shape, dtype=np.int64))
            total = int(caps.sum())
            for i in members:
                out[i] = max(0, int(self.reps[i]) - (total - int(caps[i])))
        return out

    def options(self, i: int, remainder: int) -> list:
        """The spot types a replacement of node i may launch: allowed, hold
        the remainder, worst price below node i's own, cheapest first,
        ties by name; all of them, uncapped."""
        node = self.fleet["nodes"][i]
        own = self.units[self.index[node["type"]]][node["zone"]]
        need = remainder * self.req[i]
        fits = self.allowed & np.all(self.alloc >= need[None, :], axis=1)
        cheaper = np.flatnonzero(fits & (self.worst < own))
        return sorted(cheaper.tolist(), key=lambda t: (
            self.cheapest[t], self.types[t]["name"]))

    def verdicts(self) -> dict:
        """{node: "delete" | "replace"} of the candidates that can win."""
        rem = self.remainders()
        out = {}
        for i, node in enumerate(self.fleet["nodes"]):
            if node["do_not_disrupt"]:
                continue
            if rem[i] == 0:
                out[i] = "delete"
            elif len(self.options(i, int(rem[i]))) >= MIN_SPOT_TYPES:
                out[i] = "replace"
        return out


def check(fl: Fleet, answer: dict, verdicts: dict = None) -> dict:
    """Judge one decision. ``answer``: ``decision``, ``candidates`` (node
    names), ``placements`` ({node: pods placed there}), ``claims`` (each
    with ``pods``, ``capacity_types`` and ``options``). ``verdicts``:
    ``fl.verdicts()``, when the caller has it already."""
    nodes = fl.fleet["nodes"]
    verdicts = fl.verdicts() if verdicts is None else verdicts
    faults = dict.fromkeys(FAULTS, 0)
    chosen = []
    for name in answer["candidates"]:
        i = fl.node_index.get(name)
        if i is None or i in chosen or nodes[i]["do_not_disrupt"]:
            faults["protected_candidates"] += 1
        else:
            chosen.append(i)
    faults["wrong_candidate"] += max(0, len(chosen) - 1)
    least = min((int(fl.reps[i]) for i in verdicts), default=None)
    if not chosen:
        faults["wrong_decision"] += int(answer["decision"] != "no-op"
                                        or least is not None)
        return faults
    i = chosen[0]
    if i not in verdicts or int(fl.reps[i]) > least:
        faults["wrong_candidate"] += 1
    want = verdicts.get(i)
    faults["wrong_decision"] += int(answer["decision"] != want)
    claims = answer["claims"]
    if want == "replace":
        rem = int(fl.remainders()[i])
        expected = [fl.types[t]["name"]
                    for t in fl.options(i, rem)[:MIN_SPOT_TYPES]]
        if len(claims) != 1 or claims[0]["capacity_types"] != ["spot"] \
                or claims[0]["options"] != expected:
            faults["option_mismatch"] += 1

    # where the candidate's pods go
    gone = set(chosen)
    moving = {p for j in chosen for p in nodes[j]["pods"]}
    placed: dict = {}
    for name, pods in answer["placements"].items():
        j = fl.node_index.get(name)
        if j is None or j in gone:
            faults["placement_violation"] += len(pods)
            continue
        used = np.zeros(len(RESOURCES), dtype=np.int64)
        for p in pods:
            placed[p] = placed.get(p, 0) + 1
            if p in fl.pod_node:
                used += fl.req[fl.pod_node[p]]
        if np.any(fl.room[j] - used < 0):
            faults["placement_violation"] += 1
    for c in claims:
        for p in c["pods"]:
            placed[p] = placed.get(p, 0) + 1
    faults["placement_violation"] += sum(
        1 for p in moving if placed.get(p, 0) != 1)
    faults["placement_violation"] += sum(
        v for p, v in placed.items() if p not in moving)
    return faults
