"""Batched leave-one-out candidate evaluation for single-node consolidation.

The reference's SingleNodeConsolidation (singlenodeconsolidation.go:44-101)
walks the fair order calling a FULL scheduling simulation per candidate —
at 5,000 candidates that is 5,000 solver rebuilds racing the 3-minute
timeout. The tensor design evaluates every candidate's deletion from ONE
shared `DisruptionSnapshot` encode: the device feasibility precompute
already yields, for every (group, node) and (group, template, instance
type) pair at once, exactly the quantities each leave-one-out row needs —
each row just masks out one candidate's node and marks its reschedulable
pods pending. The per-row decision (delete feasible / replaceable by one
cheaper node / unconsolidatable) is then closed-form host array math over
those shared tensors.

Exactness contract, mirroring the PrefixSimulator fallback contract:

- rows the math can express are classified without any simulation;
- rows it can't (multi-group candidates, topology constraints, host ports,
  volumes, nodepool limits, minValues, pending base pods) report
  `needs_sim` and run through the exact shared-snapshot replay;
- a `win` classification is never trusted blindly: the caller re-derives
  the actual Command through the replay + `decide()`, so a classifier bug
  can only cost one extra probe, never a wrong command;
- the seeded parity fuzzer (tests/test_single_consolidation_fuzzer.py)
  pins decision equality against the per-candidate host oracle.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..api import labels as api_labels
from ..scheduling.requirement import IN, Requirement
from .prefix import DisruptionSnapshot, SnapshotFallback, exist_fill_order
from .types import Candidate

_INF = math.inf

WIN = "win"          # a simulation probe is expected to yield a command
REJECT = "reject"    # provably unconsolidatable: skip the probe entirely
NEEDS_SIM = "sim"    # row inexpressible in the batched math: probe to know


@dataclass
class LooVerdict:
    kind: str
    reason: str = ""  # decide()-shaped reason for REJECT rows


class _GroupView:
    """Per-group leave-one-out arrays over the shared exist tensors, in the
    packer's existing-node fill order (initialized first, name tiebreak)."""

    def __init__(self, enc, g: int, order: np.ndarray, pos_of: np.ndarray,
                 err: np.ndarray):
        t = enc.tensors
        N = order.size
        self.cap = np.where(t.exist_ok[g, :N],
                            t.exist_cap[g, :N].astype(np.int64), 0)
        cap_o = self.cap[order]
        self.cum = np.concatenate(([0], np.cumsum(cap_o)))
        self.total = int(self.cum[-1])
        # positions (in fill order) of uninitialized MANAGED nodes this
        # group could land on — any pod reaching one becomes a sim error
        # (helpers.go:93-111), so the row is rejected
        self.err_pos = np.nonzero(err[order] & (cap_o > 0))[0]
        self.pos_of = pos_of


class LeaveOneOutEngine:
    """Classifies every candidate of one single-node consolidation pass."""

    def __init__(self, snapshot: DisruptionSnapshot,
                 candidates: Sequence[Candidate],
                 spot_to_spot_enabled: bool = False):
        self.snapshot = snapshot
        self.enc = snapshot.encoding_for(candidates)  # may raise
        self.candidates = list(candidates)
        self.spot_to_spot_enabled = spot_to_spot_enabled
        self.stats = {"classified": 0, "needs_sim": 0, "probes": 0}
        # shape-class attribution of the NEEDS_SIM rows (obs/fallbacks
        # vocabulary): which inexpressible shapes force exact replay sims —
        # the disruption half of the fallback cost ledger
        self.sim_classes: Dict[str, int] = {}
        self._worst_memo: Dict[tuple, np.ndarray] = {}
        self._reqs_memo: Dict[tuple, object] = {}
        from ..obs.tracer import TRACER
        with TRACER.span("disruption.loo", candidates=len(self.candidates)):
            self._verdicts = self._classify()
        self.stats["classified"] = sum(
            1 for v in self._verdicts if v.kind != NEEDS_SIM)
        self.stats["needs_sim"] = sum(
            1 for v in self._verdicts if v.kind == NEEDS_SIM)
        from ..obs.fallbacks import LEDGER
        LEDGER.record_disruption(self.sim_classes)

    # -- public -------------------------------------------------------------

    def verdict(self, i: int) -> LooVerdict:
        return self._verdicts[i]

    def probe(self, i: int):
        """The exact shared-snapshot replay for candidate i."""
        self.stats["probes"] += 1
        return self.enc.simulate_subset([i])

    # -- classification ------------------------------------------------------

    def _count_sim(self, shape: str, n: int = 1) -> None:
        self.sim_classes[shape] = self.sim_classes.get(shape, 0) + n

    def _classify(self) -> List[LooVerdict]:
        enc = self.enc
        snap = self.snapshot
        n = len(self.candidates)
        sim = [LooVerdict(NEEDS_SIM)] * n
        # global gates: shapes whose leave-one-out packs interact in ways
        # the closed-form math doesn't model go through the replay
        if snap.base_pods:
            self._count_sim("base_pods", n)
            return sim  # every row re-packs the shared pending set
        if enc.problem.min_its is not None:
            self._count_sim("minvalues", n)
            return sim  # minValues floors change fills and claim counts
        if any(np_.spec.limits for np_ in snap.ts.nodepools):
            self._count_sim("limits", n)
            return sim  # subtractMax pessimism is order-dependent
        t = enc.tensors
        state_nodes = snap.ts.state_nodes
        N = len(state_nodes)
        if N == 0:
            self._count_sim("other", n)
            return sim
        simple = [not g.topo and not g.host_ports
                  and not (g.pods and g.pods[0].spec.volumes)
                  for g in enc.groups]
        order = np.array(exist_fill_order(state_nodes), dtype=np.int64)
        pos_of = np.empty(N, dtype=np.int64)
        pos_of[order] = np.arange(N)
        err = np.array([sn.managed() and not sn.initialized()
                        for sn in state_nodes], dtype=bool)

        views: Dict[int, _GroupView] = {}
        out: List[LooVerdict] = []
        for i, c in enumerate(self.candidates):
            counts: Dict[int, int] = {}
            unknown = False
            for uid in enc.pod_uids_by_candidate[i]:
                gi = enc.uid_group.get(uid)
                if gi is None:
                    unknown = True
                    break
                counts[gi] = counts.get(gi, 0) + 1
            n_idx = enc.node_index.get(c.state_node.name())
            if unknown or n_idx is None or len(counts) != 1:
                self._count_sim("multi_group" if not unknown
                                and n_idx is not None else "other")
                out.append(LooVerdict(NEEDS_SIM))
                continue
            (g, k), = counts.items()
            if not simple[g]:
                grp = enc.groups[g]
                self._count_sim(
                    "topo" if grp.topo else
                    "ports" if grp.host_ports else "volumes")
                out.append(LooVerdict(NEEDS_SIM))
                continue
            view = views.get(g)
            if view is None:
                view = _GroupView(enc, g, order, pos_of, err)
                views[g] = view
            out.append(self._classify_row(c, g, k, n_idx, view))
        return out

    def _classify_row(self, c: Candidate, g: int, k: int, n_idx: int,
                      view: _GroupView) -> LooVerdict:
        cap_c = int(view.cap[n_idx])
        p_pos = int(view.pos_of[n_idx])
        total_i = view.total - cap_c
        # the greedy existing-node fill reaches an uninitialized managed
        # node (=> sim error => rejection) iff the demand exceeds the
        # capacity accumulated before the first such node in fill order,
        # with the candidate's own column removed
        thr = _INF
        ep = view.err_pos
        if ep.size:
            j = int(np.searchsorted(ep, p_pos))
            if j > 0:
                thr = float(view.cum[ep[0]])
            jj = j + 1 if j < ep.size and ep[j] == p_pos else j
            if jj < ep.size:
                thr = min(thr, float(view.cum[ep[jj]] - cap_c))
        if k <= thr and k <= total_i:
            return LooVerdict(WIN)  # delete: zero new nodes, no errors
        if k > thr:
            return LooVerdict(REJECT, (
                "not all pods would schedule, would schedule against "
                "an uninitialized node"))
        # remainder opens fresh capacity: first viable template takes all
        r = k - total_i
        t = self.enc.tensors
        m0 = next((m for m in range(len(self.enc.templates))
                   if t.it_ok[g, m].any()), None)
        if m0 is None:
            return LooVerdict(REJECT, (
                "not all pods would schedule, no instance type satisfied "
                "the pod"))
        per = int(t.ppn[g, m0][t.it_ok[g, m0]].max())
        claims = -(-r // per)
        if claims != 1:
            return LooVerdict(REJECT, (
                f"Can't remove without creating {claims} candidates"))
        return self._classify_replacement(c, g, m0, r)

    # -- replacement pricing (consolidation.go:176-302 closed form) ---------

    def _combined_reqs(self, g: int, m: int, spot_pinned: bool):
        key = (g, m, spot_pinned)
        reqs = self._reqs_memo.get(key)
        if reqs is None:
            reqs = self.enc.templates[m].requirements.copy()
            reqs.add(*self.enc.groups[g].requirements.values())
            if spot_pinned:
                reqs.add(Requirement(api_labels.CAPACITY_TYPE_LABEL_KEY, IN,
                                     [api_labels.CAPACITY_TYPE_SPOT]))
            self._reqs_memo[key] = reqs
        return reqs

    def _worst_prices(self, g: int, m: int, spot_pinned: bool) -> np.ndarray:
        """[T] worst launch price per catalog instance type under the
        replacement's combined requirements — the exact
        Offerings.worst_launch_price the price filter uses
        (nodeclaim.go:136-145), vectorized once per (group, template)."""
        key = (g, m, spot_pinned)
        worst = self._worst_memo.get(key)
        if worst is None:
            reqs = self._combined_reqs(g, m, spot_pinned)
            worst = np.array(
                [it.offerings.available().worst_launch_price(reqs)
                 for it in self.enc.catalog], dtype=np.float64)
            self._worst_memo[key] = worst
        return worst

    def _classify_replacement(self, c: Candidate, g: int, m0: int,
                              r: int) -> LooVerdict:
        from .methods import MIN_SPOT_TO_SPOT_INSTANCE_TYPES
        t = self.enc.tensors
        it_set = t.it_ok[g, m0] & (t.ppn[g, m0] >= r)
        price = c.price()
        if price is None:
            return LooVerdict(REJECT)
        base_reqs = self._combined_reqs(g, m0, False)
        ct_req = base_reqs.get(api_labels.CAPACITY_TYPE_LABEL_KEY)
        if c.capacity_type == api_labels.CAPACITY_TYPE_SPOT \
                and ct_req.has(api_labels.CAPACITY_TYPE_SPOT):
            if not self.spot_to_spot_enabled:
                return LooVerdict(REJECT, (
                    "SpotToSpotConsolidation is disabled, can't replace a "
                    "spot node with a spot node"))
            worst = self._worst_prices(g, m0, True)
            cheaper = int((it_set & (worst < price)).sum())
            if cheaper < MIN_SPOT_TO_SPOT_INSTANCE_TYPES:
                return LooVerdict(REJECT, (
                    "SpotToSpotConsolidation requires "
                    f"{MIN_SPOT_TO_SPOT_INSTANCE_TYPES} cheaper instance "
                    "type options than the current candidate to "
                    f"consolidate, got {cheaper}"))
            return LooVerdict(WIN)
        worst = self._worst_prices(g, m0, False)
        if not bool((it_set & (worst < price)).any()):
            return LooVerdict(REJECT, "Can't replace with a cheaper node")
        return LooVerdict(WIN)


class MultiNodeLooEngine:
    """Ranked multi-node subset search: closed-form verdicts for the
    prefix subsets the multi-node binary search probes.

    The reference's multi-node consolidation binary-searches the largest
    cost-ordered candidate PREFIX replaceable by at most one cheaper node
    (multinodeconsolidation.go:110-162), paying a full host replay per
    midpoint. This engine scores every prefix length over the SAME shared
    snapshot tensors the single-node LeaveOneOutEngine reads:

    - prefixes whose pods all land in ONE simple group generalize the
      single-node closed form exactly (multiple excluded exist columns,
      summed demand, summed candidate price, the same uninitialized-node
      threshold / claims-count / price-filter math);
    - multi-group prefixes get SOUND rejection bounds only: a group whose
      solo demand provably reaches an uninitialized managed node (any
      contention only brings that node closer), and a resource-volume
      lower bound proving >= 2 fresh claims (any node's usable capacity
      is bounded by the catalog's per-resource max);
    - everything else is NEEDS_SIM: the midpoint replays exactly as the
      reference search would.

    Exactness contract (the single-node contract, verbatim): a REJECT is
    only ever returned when the replay's decide() would provably return an
    empty command, so the binary search can skip that midpoint's replay
    without changing ITS decision; a WIN is never trusted — the search
    replays it to derive the actual command. The multi-node parity fuzzer
    (tests/test_single_consolidation_fuzzer.py) pins decision equality
    against the engine-off binary search seed by seed.
    """

    def __init__(self, snapshot: DisruptionSnapshot,
                 candidates: Sequence[Candidate],
                 spot_to_spot_enabled: bool = False):
        self.snapshot = snapshot
        self.enc = snapshot.encoding_for(candidates)  # may raise
        self.candidates = list(candidates)
        self.spot_to_spot_enabled = spot_to_spot_enabled
        self.stats = {"classified": 0, "needs_sim": 0, "probes_saved": 0}
        self._worst_memo: Dict[tuple, np.ndarray] = {}
        self._reqs_memo: Dict[tuple, object] = {}
        self._verdicts: Dict[int, LooVerdict] = {}
        from ..obs.tracer import TRACER
        with TRACER.span("disruption.mnloo", candidates=len(self.candidates)):
            self._prepare()

    # the single-node engine's replacement-pricing memos, shared verbatim
    _combined_reqs = LeaveOneOutEngine._combined_reqs
    _worst_prices = LeaveOneOutEngine._worst_prices

    def _prepare(self) -> None:
        enc = self.enc
        snap = self.snapshot
        self._global_sim = None
        if snap.base_pods:
            self._global_sim = "base_pods"
        elif enc.problem.min_its is not None:
            self._global_sim = "minvalues"
        elif any(np_.spec.limits for np_ in snap.ts.nodepools):
            self._global_sim = "limits"
        state_nodes = snap.ts.state_nodes
        N = len(state_nodes)
        if N == 0:
            self._global_sim = self._global_sim or "other"
        if self._global_sim is not None:
            return
        self._order = np.array(exist_fill_order(state_nodes), dtype=np.int64)
        pos_of = np.empty(N, dtype=np.int64)
        pos_of[self._order] = np.arange(N)
        self._pos_of = pos_of
        self._err = np.array([sn.managed() and not sn.initialized()
                              for sn in state_nodes], dtype=bool)
        self._simple = [not g.topo and not g.host_ports
                        and not (g.pods and g.pods[0].spec.volumes)
                        for g in enc.groups]
        self._views: Dict[int, _GroupView] = {}
        # per-candidate (group->count, node index); the first candidate the
        # tensors can't express makes every prefix containing it NEEDS_SIM
        self._cand: List[Optional[tuple]] = []
        for i, c in enumerate(self.candidates):
            counts: Dict[int, int] = {}
            bad = False
            for uid in enc.pod_uids_by_candidate[i]:
                gi = enc.uid_group.get(uid)
                if gi is None:
                    bad = True
                    break
                counts[gi] = counts.get(gi, 0) + 1
            n_idx = enc.node_index.get(c.state_node.name())
            if bad or n_idx is None or bool(self._err[n_idx]) \
                    or any(not self._simple[g] for g in counts):
                self._cand.append(None)
            else:
                self._cand.append((counts, n_idx))

    def _view(self, g: int) -> _GroupView:
        v = self._views.get(g)
        if v is None:
            v = _GroupView(self.enc, g, self._order, self._pos_of, self._err)
            self._views[g] = v
        return v

    def verdict(self, n: int) -> LooVerdict:
        """Closed-form verdict for the prefix candidates[:n]."""
        v = self._verdicts.get(n)
        if v is None:
            v = self._verdict(n)
            self._verdicts[n] = v
            self.stats["classified" if v.kind != NEEDS_SIM
                       else "needs_sim"] += 1
            from ..metrics import registry as metrics
            metrics.DISRUPTION_SUBSET_VERDICTS.inc({"kind": v.kind})
            if v.kind == REJECT:
                self.stats["probes_saved"] += 1
        return v

    def _verdict(self, n: int) -> LooVerdict:
        if self._global_sim is not None:
            return LooVerdict(NEEDS_SIM)
        prefix = self._cand[:n]
        if any(c is None for c in prefix):
            return LooVerdict(NEEDS_SIM)
        # per-group aggregates over the prefix: demand, removed capacity,
        # capacity removed before each group's first uninitialized position
        k: Dict[int, int] = {}
        removed: Dict[int, int] = {}
        removed_pre_err: Dict[int, int] = {}
        groups = set()
        for counts, _ in prefix:
            groups.update(counts)
        for g in groups:
            view = self._view(g)
            kg = rg = rpe = 0
            e0 = int(view.err_pos[0]) if view.err_pos.size else -1
            for counts, n_idx in prefix:
                kg += counts.get(g, 0)
                cap = int(view.cap[n_idx])
                rg += cap
                if e0 >= 0 and int(view.pos_of[n_idx]) < e0:
                    rpe += cap
            k[g], removed[g], removed_pre_err[g] = kg, rg, rpe

        # sound uninit rejection per group: contention from other groups
        # only brings the first error node closer (see class docstring)
        for g in groups:
            view = self._view(g)
            if view.err_pos.size:
                thr = float(view.cum[view.err_pos[0]]) - removed_pre_err[g]
                if k[g] > thr:
                    return LooVerdict(REJECT, (
                        "not all pods would schedule, would schedule "
                        "against an uninitialized node"))

        overflow = {g: k[g] - (self._view(g).total - removed[g])
                    for g in groups}
        overflow = {g: r for g, r in overflow.items() if r > 0}
        if not overflow:
            if len(groups) == 1:
                return LooVerdict(WIN)  # exact: delete, zero new nodes
            # multi-group: solo totals are optimistic — contention could
            # still overflow, so a delete is plausible but not proven
            return LooVerdict(NEEDS_SIM)

        if len(groups) > 1:
            return self._multi_group_claims_bound(overflow)
        (g,) = groups
        return self._single_group_replacement(n, g, overflow[g])

    def _multi_group_claims_bound(self, overflow: Dict[int, int]
                                  ) -> LooVerdict:
        """Resource-volume lower bound on fresh claims: every node's
        usable capacity per resource is bounded by the catalog max, so
        ceil(total overflow volume / max node) >= 2 proves the replay
        would create >= 2 claims — decide() rejects those."""
        t = self.enc.tensors
        p = self.enc.problem
        need = np.zeros(p.group_req.shape[1], dtype=np.float64)
        for g, r in overflow.items():
            need += r * p.group_req[g].astype(np.float64)
        max_alloc = p.it_alloc.max(axis=0).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            per_res = np.where(max_alloc > 0, need / max_alloc,
                               np.where(need > 0, np.inf, 0.0))
        claims_lb = int(np.ceil(per_res.max())) if per_res.size else 0
        if claims_lb >= 2:
            return LooVerdict(REJECT, (
                f"Can't remove without creating {claims_lb} candidates"))
        return LooVerdict(NEEDS_SIM)

    def _single_group_replacement(self, n: int, g: int, r: int) -> LooVerdict:
        """The single-node replacement classification with summed demand
        and summed candidate price (consolidation.go:176-302 closed form,
        multi-candidate decide() semantics: no spot-to-spot >= 15 floor
        for len(candidates) > 1)."""
        t = self.enc.tensors
        m0 = next((m for m in range(len(self.enc.templates))
                   if t.it_ok[g, m].any()), None)
        if m0 is None:
            return LooVerdict(REJECT, (
                "not all pods would schedule, no instance type satisfied "
                "the pod"))
        per = int(t.ppn[g, m0][t.it_ok[g, m0]].max())
        claims = -(-r // per)
        if claims != 1:
            return LooVerdict(REJECT, (
                f"Can't remove without creating {claims} candidates"))
        prefix = self.candidates[:n]
        price = 0.0
        for c in prefix:
            p_ = c.price()
            if p_ is None:
                return LooVerdict(REJECT)
            price += p_
        it_set = t.it_ok[g, m0] & (t.ppn[g, m0] >= r)
        base_reqs = self._combined_reqs(g, m0, False)
        ct_req = base_reqs.get(api_labels.CAPACITY_TYPE_LABEL_KEY)
        all_spot = all(c.capacity_type == api_labels.CAPACITY_TYPE_SPOT
                       for c in prefix)
        if all_spot and ct_req.has(api_labels.CAPACITY_TYPE_SPOT):
            if not self.spot_to_spot_enabled:
                return LooVerdict(REJECT, (
                    "SpotToSpotConsolidation is disabled, can't replace a "
                    "spot node with a spot node"))
            worst = self._worst_prices(g, m0, True)
            if not bool((it_set & (worst < price)).any()):
                return LooVerdict(REJECT, "Can't replace with a cheaper node")
            return LooVerdict(WIN)  # len > 1: no MIN_SPOT_TO_SPOT floor
        worst = self._worst_prices(g, m0, False)
        if not bool((it_set & (worst < price)).any()):
            return LooVerdict(REJECT, "Can't replace with a cheaper node")
        return LooVerdict(WIN)
