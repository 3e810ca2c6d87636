"""PDB limit evaluation (karpenter's pkg/utils/pdb/pdb.go:33-112).

Limits answers: can this pod be evicted right now, and which PDB blocks it?
A pod is blocked when any matching PDB has disruptionsAllowed == 0. The
reference reads status computed by the disruption controller; standalone we
compute it live from current pod health.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

from ..api.objects import Pod
from ..api.policy import PodDisruptionBudget
from . import pod as pod_utils


def _parse_intstr(v: str, total: int) -> int:
    v = v.strip()
    if v.endswith("%"):
        return int(math.ceil(total * int(v[:-1]) / 100.0))
    return int(v)


class Limits:
    def __init__(self, pdbs: List[PodDisruptionBudget], pods: List[Pod]):
        self.pdbs = pdbs
        self.pods = pods
        # evictions granted THROUGH this Limits instance, counted against
        # each PDB's headroom: the API server sees each eviction reflected in
        # PDB status before the next one, so a one-shot snapshot must track
        # its own grants to avoid over-evicting within a single drain pass
        self._granted: dict = {}
        # selector-match memo per PDB: a Limits instance snapshots one
        # pass, and pod labels/namespaces don't move within it — without
        # the memo a disruption pass over N candidates re-scans every pod
        # per (candidate pod, PDB), O(pdbs x pods^2) (the fleet simulator
        # surfaced this at ~90 ms per pass on a 200-pod cluster). Health
        # is still recomputed per call: in-pass evictions mutate bindings.
        self._matching: dict = {}

    def _matching_pods(self, pdb: PodDisruptionBudget) -> List[Pod]:
        cached = self._matching.get(id(pdb))
        if cached is not None:
            return cached
        sel = pdb.spec.selector
        out = [p for p in self.pods
               if p.namespace == pdb.namespace
               and sel is not None and sel.matches(p.labels)]
        self._matching[id(pdb)] = out
        return out

    def disruptions_allowed(self, pdb: PodDisruptionBudget) -> int:
        matching = self._matching_pods(pdb)
        expected = len(matching)
        healthy = len([p for p in matching
                       if pod_utils.is_active(p) and p.spec.node_name])
        if pdb.spec.max_unavailable is not None:
            max_unavail = _parse_intstr(pdb.spec.max_unavailable, expected)
            unhealthy = expected - healthy
            return max(0, max_unavail - unhealthy)
        if pdb.spec.min_available is not None:
            min_avail = _parse_intstr(pdb.spec.min_available, expected)
            return max(0, healthy - min_avail)
        return expected

    def can_evict(self, pod: Pod) -> Tuple[bool, Optional[PodDisruptionBudget]]:
        """pdb.go CanEvictPods: blocked when ANY matching PDB has no headroom
        (pdb.go:56-86) — a pod covered by several PDBs must clear all of them.
        Fully-blocking PDBs (maxUnavailable 0/0%) block even unhealthy pods."""
        for pdb in self.pdbs:
            if pdb.namespace != pod.namespace:
                continue
            sel = pdb.spec.selector
            if sel is None or not sel.matches(pod.labels):
                continue
            allowed = self.disruptions_allowed(pdb) - \
                self._granted.get(id(pdb), 0)
            if allowed <= 0:
                return False, pdb
        return True, None

    def record_eviction(self, pod: Pod) -> None:
        """Count a granted eviction against every matching PDB so the next
        can_evict in the same pass sees the reduced headroom."""
        for pdb in self.pdbs:
            if pdb.namespace != pod.namespace:
                continue
            sel = pdb.spec.selector
            if sel is not None and sel.matches(pod.labels):
                self._granted[id(pdb)] = self._granted.get(id(pdb), 0) + 1
