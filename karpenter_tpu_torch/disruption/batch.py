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
those shared tensors, worked out for a group's rows at once, with the
candidates' current prices as one vector.

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
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api import labels as api_labels
from ..scheduling.requirement import IN, Requirement
from .prefix import DisruptionSnapshot, SnapshotFallback, exist_fill_order
from .types import Candidate

# the fill threshold of a row no uninitialized managed node bounds
_NO_ERR_NODE = np.iinfo(np.int64).max

WIN = "win"          # a simulation probe is expected to yield a command
REJECT = "reject"    # provably unconsolidatable: skip the probe entirely
NEEDS_SIM = "sim"    # row inexpressible in the batched math: probe to know


@dataclass
class LooVerdict:
    kind: str
    reason: str = ""  # decide()-shaped reason for REJECT rows
    # the disruption.loo count the row adds to; "" counts a REJECT as
    # rejected and a NEEDS_SIM as needs_sim, and a WIN must name its own
    tally: str = ""


TALLIES = ("won_delete", "won_replace", "rejected", "spot_floor", "needs_sim")


def _tally(v: LooVerdict) -> str:
    if v.tally:
        return v.tally
    if v.kind == WIN:
        raise ValueError("a WIN verdict names its tally: won_delete or "
                         "won_replace")
    return "needs_sim" if v.kind == NEEDS_SIM else "rejected"


def current_prices(candidates: Sequence[Candidate]) -> Tuple[np.ndarray, int]:
    """``Candidate.price()`` of every candidate as one float64 vector, NaN
    where it is None, and the number of distinct lookups resolved.

    A price reads only the instance type's offerings and the node's labels
    on the keys those offerings' requirements name (a deprecated alias
    normalises onto its key), so each distinct (type, those labels) is
    resolved once, by the first candidate that has it. Prices move between
    passes: nothing here outlives the call."""
    out = np.full(len(candidates), math.nan)
    keys_of: Dict[int, tuple] = {}
    memo: Dict[tuple, float] = {}
    for i, c in enumerate(candidates):
        it = c.instance_type
        if it is None:
            continue
        keys = keys_of.get(id(it))
        if keys is None:
            keys = keys_of[id(it)] = _offering_label_keys(it)
        labels = c.state_node.labels()
        key = (id(it), tuple(labels.get(k) for k in keys))
        price = memo.get(key)
        if price is None:
            p = c.price()
            price = memo[key] = math.nan if p is None else p
        out[i] = price
    return out, len(memo)


def _offering_label_keys(it) -> tuple:
    """The node label keys that decide which of ``it``'s offerings a
    node's label requirements are compatible with."""
    named = set()
    for o in it.offerings:
        named.update(o.requirements.keys())
    named.update(alias for alias, key in api_labels.NORMALIZED_LABELS.items()
                 if key in named)
    return tuple(sorted(named))


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
        self._prices = None
        from ..obs.tracer import TRACER
        with TRACER.span("disruption.loo",
                         candidates=len(self.candidates)) as sp:
            # the candidates' current prices (NaN: no price) and the
            # distinct lookups that resolved them
            self.prices, self.price_keys = current_prices(self.candidates)
            self._spot = np.array(
                [c.capacity_type == api_labels.CAPACITY_TYPE_SPOT
                 for c in self.candidates], dtype=bool)
            self._verdicts = self._classify()
            if TRACER.enabled:
                counts = dict.fromkeys(TALLIES, 0)
                for v in self._verdicts:
                    counts[_tally(v)] += 1
                sp.set(price_keys=self.price_keys, **counts)
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

        out: List[Optional[LooVerdict]] = [None] * n
        # group -> its simple single-group rows as (candidate, pods, node)
        rows: Dict[int, List[tuple]] = {}
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
                out[i] = LooVerdict(NEEDS_SIM)
                continue
            (g, k), = counts.items()
            if not simple[g]:
                grp = enc.groups[g]
                self._count_sim(
                    "topo" if grp.topo else
                    "ports" if grp.host_ports else "volumes")
                out[i] = LooVerdict(NEEDS_SIM)
                continue
            rows.setdefault(g, []).append((i, k, n_idx))
        for g, grp_rows in rows.items():
            idx, k, n_idx = (np.array(col, dtype=np.int64)
                             for col in zip(*grp_rows))
            view = _GroupView(enc, g, order, pos_of, err)
            for i, v in zip(idx.tolist(),
                            self._classify_group(g, view, idx, k, n_idx)):
                out[i] = v
        return out

    def _classify_group(self, g: int, view: _GroupView, idx: np.ndarray,
                        k: np.ndarray, n_idx: np.ndarray) -> List[LooVerdict]:
        """The verdicts of one simple group's rows (candidates ``idx``,
        ``k`` pods of the group each, on exist columns ``n_idx``), worked
        out over the group's rows at once."""
        cap_c = view.cap[n_idx]
        p_pos = view.pos_of[n_idx]
        total_i = view.total - cap_c
        # the greedy existing-node fill reaches an uninitialized managed
        # node (=> sim error => rejection) iff the demand exceeds the
        # capacity accumulated before the first such node in fill order,
        # with the candidate's own column removed
        thr = np.full(idx.size, _NO_ERR_NODE, dtype=np.int64)
        ep = view.err_pos
        if ep.size:
            last = ep.size - 1
            j = np.searchsorted(ep, p_pos)
            thr = np.where(j > 0, view.cum[ep[0]], thr)
            jj = j + ((j <= last) & (ep[np.minimum(j, last)] == p_pos))
            thr = np.where(jj <= last, np.minimum(
                thr, view.cum[ep[np.minimum(jj, last)]] - cap_c), thr)
        out = np.empty(idx.size, dtype=object)
        uninit = k > thr
        # delete: zero new nodes, no errors
        out[~uninit & (k <= total_i)] = LooVerdict(WIN, tally="won_delete")
        out[uninit] = LooVerdict(REJECT, (
            "not all pods would schedule, would schedule against "
            "an uninitialized node"))
        rest = np.nonzero(~uninit & (k > total_i))[0]
        if rest.size:
            self._classify_remainders(g, idx[rest], k[rest] - total_i[rest],
                                      out, rest)
        return out.tolist()

    def _classify_remainders(self, g: int, idx: np.ndarray, r: np.ndarray,
                             out: np.ndarray, at: np.ndarray) -> None:
        """Rows whose remainder ``r`` opens fresh capacity: the first
        viable template takes all of it (consolidation.go:176-302 closed
        form). Writes each row's verdict into ``out[at]``."""
        from .methods import MIN_SPOT_TO_SPOT_INSTANCE_TYPES
        t = self.enc.tensors
        m0 = next((m for m in range(len(self.enc.templates))
                   if t.it_ok[g, m].any()), None)
        if m0 is None:
            out[at] = LooVerdict(REJECT, (
                "not all pods would schedule, no instance type satisfied "
                "the pod"))
            return
        it_ok, ppn = t.it_ok[g, m0], t.ppn[g, m0]
        per = int(ppn[it_ok].max())
        claims = -(-r // per)
        for n_claims in np.unique(claims[claims != 1]).tolist():
            out[at[claims == n_claims]] = LooVerdict(REJECT, (
                f"Can't remove without creating {n_claims} candidates"))
        one = claims == 1
        idx, r, at = idx[one], r[one], at[one]
        price = self.prices[idx]
        unpriced = np.isnan(price)
        out[at[unpriced]] = LooVerdict(REJECT)
        if unpriced.all():
            return
        ct_req = self._combined_reqs(g, m0, False).get(
            api_labels.CAPACITY_TYPE_LABEL_KEY)
        spot = ~unpriced & self._spot[idx] \
            & ct_req.has(api_labels.CAPACITY_TYPE_SPOT)
        if spot.any() and not self.spot_to_spot_enabled:
            out[at[spot]] = LooVerdict(REJECT, (
                "SpotToSpotConsolidation is disabled, can't replace a "
                "spot node with a spot node"))
        elif spot.any():
            # per distinct remainder, the replacement's options sorted by
            # worst price: the options cheaper than a row's price are the
            # ones before its left insertion point
            worst = self._worst_prices(g, m0, True)
            cheaper = np.zeros(r.size, dtype=np.int64)
            for rv in np.unique(r[spot]).tolist():
                rows = spot & (r == rv)
                options = np.sort(worst[it_ok & (ppn >= rv)])
                cheaper[rows] = np.searchsorted(options, price[rows],
                                                side="left")
            floor = cheaper < MIN_SPOT_TO_SPOT_INSTANCE_TYPES
            out[at[spot & ~floor]] = LooVerdict(WIN, tally="won_replace")
            for n_cheaper in np.unique(cheaper[spot & floor]).tolist():
                out[at[spot & (cheaper == n_cheaper)]] = LooVerdict(REJECT, (
                    "SpotToSpotConsolidation requires "
                    f"{MIN_SPOT_TO_SPOT_INSTANCE_TYPES} cheaper instance "
                    "type options than the current candidate to "
                    f"consolidate, got {n_cheaper}"), tally="spot_floor")
        other = ~unpriced & ~spot
        if other.any():
            worst = self._worst_prices(g, m0, False)
            won = np.zeros(r.size, dtype=bool)
            for rv in np.unique(r[other]).tolist():
                rows = other & (r == rv)
                options = worst[it_ok & (ppn >= rv)]
                if options.size:
                    won[rows] = options.min() < price[rows]
            out[at[other & won]] = LooVerdict(WIN, tally="won_replace")
            out[at[other & ~won]] = LooVerdict(
                REJECT, "Can't replace with a cheaper node")

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

    def _price_vectors(self):
        """The catalog's worst-launch-price vectors, built on first use."""
        if self._prices is None:
            from ..cloudprovider.types import WorstLaunchPrices
            self._prices = WorstLaunchPrices(self.enc.catalog)
        return self._prices

    def _worst_prices(self, g: int, m: int, spot_pinned: bool) -> np.ndarray:
        """[T] worst launch price per catalog instance type under the
        replacement's combined requirements — the exact
        Offerings.worst_launch_price the price filter uses
        (nodeclaim.go:136-145). Every (group, template) whose requirements
        allow the same offerings shares one vector. The memo by (group,
        template) sits in front of the vectors' own, which is keyed by
        the offering sets allowed: working that key out costs a
        compatibility check per offering set, and the classifier asks
        once per candidate."""
        key = (g, m, spot_pinned)
        worst = self._worst_memo.get(key)
        if worst is None:
            from ..obs.tracer import TRACER
            with TRACER.span("disruption.prices") as sp:
                prices = self._price_vectors()
                built = prices.built
                worst = prices.vector(
                    self._combined_reqs(g, m, spot_pinned))
                sp.set(vectors=prices.built - built, types=worst.size)
            self._worst_memo[key] = worst
        return worst


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
        self._prices = None
        self._verdicts: Dict[int, LooVerdict] = {}
        from ..obs.tracer import TRACER
        with TRACER.span("disruption.mnloo", candidates=len(self.candidates)):
            self._prepare()

    # the single-node engine's replacement-pricing memos, shared verbatim
    _combined_reqs = LeaveOneOutEngine._combined_reqs
    _price_vectors = LeaveOneOutEngine._price_vectors
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
                # exact: delete, zero new nodes
                return LooVerdict(WIN, tally="won_delete")
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
            # len > 1: no MIN_SPOT_TO_SPOT floor
            return LooVerdict(WIN, tally="won_replace")
        worst = self._worst_prices(g, m0, False)
        if not bool((it_set & (worst < price)).any()):
            return LooVerdict(REJECT, "Can't replace with a cheaper node")
        return LooVerdict(WIN, tally="won_replace")
