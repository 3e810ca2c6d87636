"""The plain reference for a multi-node consolidation decision over the
benchmark's fleet, worked out again from the plain records of ``spec.py``
and held against the command the program computed.

It imports neither JAX, nor the JAX package, nor the program. It reads the
program's command (decision, candidates, replacements) and the simulated
placement of the candidates' pods only to judge them. Every number counts
faults, so each limit is 0:

- ``protected_candidates``: candidates that hold a do-not-disrupt pod, are
  not in the fleet, or appear twice;
- ``candidate_shortfall``: how many fewer candidates the command takes than
  the method's batch (the largest prefix it may take, here every one of
  min(max_candidates, eligible nodes)) when the reference finds room on the
  nodes that stay for every pod of such a batch;
- ``wrong_decision``: 1 when the command is not the deletion that room
  calls for (or, without room, deletes anyway);
- ``placement_violation``: pods of the candidates placed twice, never
  placed, placed on a candidate or on a node they overfill, and
  replacements whose options are not exactly the types that hold their
  pods.
"""

from __future__ import annotations

import numpy as np

from .solve_check import RESOURCES, Catalog


def _pod_requests(node: dict) -> np.ndarray:
    r = node["pod_requests"]
    return np.array([r["cpu"], r["memory"], 1000], dtype=np.int64)


def room_for(cat: Catalog, fleet: dict, staying: list) -> np.ndarray:
    """Room [len(staying), R] on each staying node: its allocatable less
    its own pod."""
    nodes = fleet["nodes"]
    return np.stack([cat.alloc[cat.index[nodes[i]["type"]]]
                     - _pod_requests(nodes[i]) for i in staying])


def fits_elsewhere(cat: Catalog, fleet: dict, leaving: list,
                   staying: list) -> bool:
    """Whether the pods of the ``leaving`` nodes fit on the ``staying``
    ones: first fit, largest pod first. A fit found proves room exists."""
    nodes = fleet["nodes"]
    room = room_for(cat, fleet, staying)
    pods = sorted((_pod_requests(nodes[i]) for i in leaving),
                  key=lambda r: tuple(-r))
    for r in pods:
        ok = np.flatnonzero(np.all(room >= r[None, :], axis=1))
        if ok.size == 0:
            return False
        room[ok[0]] -= r
    return True


def check(types: list, fleet: dict, answer: dict) -> dict:
    """Judge one decision. ``answer``: ``decision``, ``candidates`` (node
    names), ``placements`` ({node: pods placed there}), ``claims`` (new
    claims as the solve check reads them: pods, zones, capacity_types,
    requirements, options)."""
    cat = Catalog(types)
    nodes = fleet["nodes"]
    index = {n["name"]: i for i, n in enumerate(nodes)}
    pod_node = {n["pod"]: i for i, n in enumerate(nodes)}
    faults = {"protected_candidates": 0, "candidate_shortfall": 0,
              "wrong_decision": 0, "placement_violation": 0}
    chosen = []
    for name in answer["candidates"]:
        i = index.get(name)
        if i is None or i in chosen or nodes[i]["do_not_disrupt"]:
            faults["protected_candidates"] += 1
        else:
            chosen.append(i)
    eligible = [i for i, n in enumerate(nodes) if not n["do_not_disrupt"]]
    want = min(fleet["batch"], len(eligible))
    # the program's candidates, topped up in fleet order to a full batch
    batch = chosen + [i for i in eligible if i not in set(chosen)
                      ][:max(0, want - len(chosen))]
    leaving = set(batch)
    room = fits_elsewhere(cat, fleet, batch,
                          [i for i in range(len(nodes)) if i not in leaving])
    if room:
        faults["candidate_shortfall"] = max(0, want - len(chosen))
        faults["wrong_decision"] = int(answer["decision"] != "delete")
    else:
        faults["wrong_decision"] = int(answer["decision"] == "delete")

    # where the candidates' pods go
    gone = set(chosen)
    placed: dict = {}
    staying = [i for i in range(len(nodes)) if i not in gone]
    room_left = dict(zip(staying, room_for(cat, fleet, staying)))
    for name, pods in answer["placements"].items():
        i = index.get(name)
        if i is None or i in gone:
            faults["placement_violation"] += len(pods)
            continue
        for p in pods:
            placed[p] = placed.get(p, 0) + 1
            if p in pod_node:
                room_left[i] = room_left[i] - _pod_requests(nodes[pod_node[p]])
        if np.any(room_left[i] < 0):
            faults["placement_violation"] += 1
    for c in answer["claims"]:
        total = np.zeros(len(RESOURCES), dtype=np.int64)
        for p in c["pods"]:
            placed[p] = placed.get(p, 0) + 1
            if p in pod_node:
                total += _pod_requests(nodes[pod_node[p]])
        labels = {k: set(v) for k, v in c["requirements"].items()
                  if k != "karpenter.sh/nodepool"}
        try:
            options = cat.options(total, c["zones"], c["capacity_types"],
                                  labels)
        except KeyError:
            options = []
        if not options or options != c["options"]:
            faults["placement_violation"] += 1
    moving = {nodes[i]["pod"] for i in chosen}
    faults["placement_violation"] += sum(
        1 for p in moving if placed.get(p, 0) != 1)
    faults["placement_violation"] += sum(
        v for p, v in placed.items() if p not in moving)
    return faults
