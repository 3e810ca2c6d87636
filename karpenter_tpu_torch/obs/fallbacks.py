"""Fallback cost ledger: what the host-oracle floor actually costs, and why.

The tensor kernel's degradation floor (forced host-oracle solving at ~12.2k
pods/sec vs ~160k on the tensor path) taxes every inexpressible shape, but
until this ledger the system recorded only a bare ``fallback_reason``
string — no pod counts, no cost, no aggregation. ROADMAP item 1 ("tensorize
every shape the host oracle still owns") needs a PRIORITY ORDERING: which
shape classes force the most pods through the slow path, how often, and at
what wall cost on realistic traffic. This module is that measurement plane:

- :func:`classify_reason` maps every demotion/fallback reason string the
  partitioner, the tensor scheduler, and the LOO consolidation engine
  produce onto a closed vocabulary of SHAPE CLASSES (volumes, topo, ports,
  minvalues, multi_group, limits, base_pods, circuit_open, device_error,
  other);
- :class:`FallbackLedger` (process-wide ``LEDGER``) aggregates per-solve
  attribution records — pod counts per class, host-vs-tensor wall seconds
  — into the ``karpenter_fallback_*{shape,subsystem}`` metric families and
  a bounded recent-solve ring served by ``/debug/fallbacks``;
- the fleet simulator reads the SAME per-solve attribution off the
  scheduler (``TensorScheduler.fallback_attribution``) for its ledger
  entries (deterministic pod counts only) and its report's ``fallbacks``
  section (counts + wall cost).

Classification happens HERE, not in grouping.py — the partitioner emits
its human-readable reasons and stays free of observability vocabulary; a
new reason string falls into "other" (visible in /debug/fallbacks) rather
than silently vanishing.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

SHAPE_CLASSES = ("volumes", "topo", "ports", "minvalues", "multi_group",
                 "limits", "base_pods", "circuit_open", "device_error",
                 "other")


def classify_reason(reason: str) -> str:
    """Shape class of one demotion/fallback reason string. Order matters:
    'persistent volume claims ... host-side limit tracking' must land in
    volumes (not limits), 'host ports with hostname pod-affinity' in ports
    (not topo)."""
    r = (reason or "").lower()
    if not r:
        return "other"
    if r.startswith("tensor solve failed"):
        # FIRST: the embedded exception text is arbitrary — a device OOM
        # saying "memory limit exceeded" must not land in `limits`
        return "device_error"
    if "circuit_open" in r:
        return "circuit_open"
    if "couples multiple pod groups" in r:
        return "multi_group"
    if "volume" in r:
        return "volumes"
    if "minvalues" in r:
        return "minvalues"
    if "host port" in r:  # NOT bare "port": "unsupported" contains it
        return "ports"
    if "limit" in r:
        return "limits"
    if "base pod" in r:
        return "base_pods"
    if "topolog" in r or "affinity" in r or "spread" in r \
            or "relaxable" in r:
        return "topo"
    return "other"


def classify_breakdown(breakdown) -> Dict[str, int]:
    """Fold the partitioner's per-group (reason, pod_count) breakdown into
    {shape_class: pods}."""
    classes: Dict[str, int] = {}
    for reason, count in breakdown:
        c = classify_reason(reason)
        classes[c] = classes.get(c, 0) + int(count)
    return classes


class FallbackLedger:
    """Process-wide aggregation of host-oracle escapes (schedulers are
    per-solve, the cost story is per-process — the solver-circuit-breaker
    scoping rule)."""

    def __init__(self, keep: int = 256):
        self._lock = threading.Lock()
        # (subsystem, shape) -> {"solves", "pods", "host_seconds"}
        self._totals: Dict[tuple, dict] = {}
        self.solves = 0             # provisioning solves recorded
        self.tensor_pods = 0
        self.host_pods = 0
        self.tensor_seconds = 0.0
        self.host_seconds = 0.0
        self._recent: "deque[dict]" = deque(maxlen=keep)

    # -- write side ----------------------------------------------------------

    def record_solve(self, classes: Dict[str, int], tensor_pods: int,
                     host_pods: int, tensor_seconds: float,
                     host_seconds: float, trace_id: str = "",
                     encode_kind: str = "",
                     subsystem: str = "provisioning") -> None:
        """One solve's attribution: per-class host-path pod counts, the
        tensor/host wall split. Host seconds are attributed pro-rata by
        pod count across the solve's escape classes. Only provisioning-
        subsystem solves move the headline totals (fallback_fraction must
        describe live traffic); disruption candidate-build probes record
        into their own class rows."""
        from ..metrics.registry import (FALLBACK_HOST_SECONDS, FALLBACK_PODS,
                                        FALLBACK_SOLVES,
                                        FALLBACK_TENSOR_SECONDS)
        total_class_pods = sum(classes.values()) or 1
        provisioning = subsystem == "provisioning"
        with self._lock:
            if provisioning:
                self.solves += 1
                self.tensor_pods += tensor_pods
                self.host_pods += host_pods
                self.tensor_seconds += tensor_seconds
                self.host_seconds += host_seconds
            for shape, pods in classes.items():
                tot = self._totals.setdefault(
                    (subsystem, shape),
                    {"solves": 0, "pods": 0, "host_seconds": 0.0})
                tot["solves"] += 1
                tot["pods"] += pods
                tot["host_seconds"] += host_seconds * pods / total_class_pods
            if provisioning and (classes or host_pods):
                self._recent.append({
                    "trace_id": trace_id,
                    "encode_kind": encode_kind,
                    "classes": dict(classes),
                    "tensor_pods": tensor_pods,
                    "host_pods": host_pods,
                    "tensor_seconds": round(tensor_seconds, 6),
                    "host_seconds": round(host_seconds, 6),
                })
        if provisioning:
            FALLBACK_TENSOR_SECONDS.inc(value=tensor_seconds)
        for shape, pods in classes.items():
            labels = {"shape": shape, "subsystem": subsystem}
            FALLBACK_SOLVES.inc(labels)
            FALLBACK_PODS.inc(labels, pods)
            FALLBACK_HOST_SECONDS.inc(
                labels, host_seconds * pods / total_class_pods)

    def record_disruption(self, classes: Dict[str, int]) -> None:
        """LOO consolidation rows the closed form punted to exact replay
        sims, by shape class — the disruption half of the escape story
        (counts are candidate rows; the wall cost of the replays already
        rides the disruption span tree)."""
        from ..metrics.registry import FALLBACK_PODS, FALLBACK_SOLVES
        if not classes:
            return
        with self._lock:
            for shape, count in classes.items():
                tot = self._totals.setdefault(
                    ("disruption", shape),
                    {"solves": 0, "pods": 0, "host_seconds": 0.0})
                tot["solves"] += 1
                tot["pods"] += count
        for shape, count in classes.items():
            labels = {"shape": shape, "subsystem": "disruption"}
            FALLBACK_SOLVES.inc(labels)
            FALLBACK_PODS.inc(labels, count)

    # -- read side (/debug/fallbacks, sim report) ----------------------------

    def snapshot(self, recent: int = 20) -> dict:
        with self._lock:
            totals = {f"{sub}/{shape}": dict(v)
                      for (sub, shape), v in sorted(self._totals.items())}
            for v in totals.values():
                v["host_seconds"] = round(v["host_seconds"], 6)
            solved = self.tensor_pods + self.host_pods
            return {
                "solves": self.solves,
                "tensor_pods": self.tensor_pods,
                "host_pods": self.host_pods,
                "fallback_fraction": round(self.host_pods / solved, 6)
                if solved else 0.0,
                "tensor_seconds": round(self.tensor_seconds, 6),
                "host_seconds": round(self.host_seconds, 6),
                "classes": totals,
                # NB -0 slices the whole list: n=0 must mean "none"
                "recent": (list(self._recent)[-recent:]
                           if recent > 0 else []),
            }

    def reset(self) -> None:
        """Test/bench isolation only — the live ledger is append-only."""
        with self._lock:
            self._totals.clear()
            self._recent.clear()
            self.solves = 0
            self.tensor_pods = 0
            self.host_pods = 0
            self.tensor_seconds = 0.0
            self.host_seconds = 0.0


LEDGER = FallbackLedger()
