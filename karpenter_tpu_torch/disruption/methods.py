"""Disruption methods: Drift, Emptiness, Multi/Single-node consolidation.

Mirrors karpenter's pkg/controllers/disruption/{drift,emptiness,
multinodeconsolidation,singlenodeconsolidation,consolidation}.go. The compute
order, ≤1-replacement rule, price filter, spot-to-spot floor, and budget
handling match the reference; the multi-node prefix search differs in
mechanics (see MultiNodeConsolidation docstring) while preserving the
decision rule: the largest low-disruption-cost candidate prefix replaceable
by at most one cheaper node.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..api import labels as api_labels
from ..api.nodeclaim import COND_CONSOLIDATABLE, COND_DRIFTED
from ..api.nodepool import (REASON_DRIFTED, REASON_EMPTY, REASON_UNDERUTILIZED,
                            WHEN_EMPTY, WHEN_EMPTY_OR_UNDERUTILIZED)
from ..events import catalog as events_catalog
from ..events.recorder import Recorder
from ..scheduling.requirement import IN, Requirement
from ..state.cluster import Cluster
from .helpers import simulate_scheduling
from .types import Candidate, CandidateError, Command


def format_sim_errors(sim_errors: Dict[str, str]) -> str:
    """Results.NonPendingPodSchedulingErrors() analog
    (scheduling/scheduler.go:163-177): one string naming every
    simulation-only pod that failed to reschedule."""
    if not sim_errors:
        return ""
    return "not all pods would schedule, " + "; ".join(
        sorted(sim_errors.values()))


def _nodeclaim_name(c: Candidate) -> str:
    nc = c.state_node.nodeclaim
    return nc.name if nc is not None else ""

MULTI_NODE_CONSOLIDATION_CANDIDATES = 100   # multinodeconsolidation.go:35
MIN_SPOT_TO_SPOT_INSTANCE_TYPES = 15        # consolidation.go:47
MULTI_NODE_CONSOLIDATION_TIMEOUT = 60.0     # multinodeconsolidation.go:35
SINGLE_NODE_CONSOLIDATION_TIMEOUT = 180.0   # singlenodeconsolidation.go:30


def _loo_min_candidates_from_env(default: int = 16) -> int:
    """KARPENTER_LOO_MIN_CANDIDATES: the eligible-candidate floor below
    which the batched leave-one-out engine's device encode costs more than
    the handful of serial probes it replaces. Rejects loudly at import —
    a typo'd knob must never silently fall back to the default."""
    import os
    raw = os.environ.get("KARPENTER_LOO_MIN_CANDIDATES")
    if raw is None:
        return default
    try:
        value = int(raw)
    except ValueError:
        raise SystemExit(
            f"invalid KARPENTER_LOO_MIN_CANDIDATES={raw!r}: must be a "
            "non-negative integer")
    if value < 0:
        raise SystemExit(
            f"invalid KARPENTER_LOO_MIN_CANDIDATES={raw!r}: must be a "
            "non-negative integer")
    return value


# below this many eligible candidates the batched leave-one-out engine's
# device encode costs more than the handful of serial probes it replaces
# (env-overridable: KARPENTER_LOO_MIN_CANDIDATES)
SINGLE_NODE_BATCH_MIN_CANDIDATES = _loo_min_candidates_from_env()
# the closed-form multi-node subset engine is near-free (no device work on
# top of the prefix encode the search builds anyway); the floor exists for
# the fuzzer's engine-off oracle runs
MULTI_NODE_BATCH_MIN_CANDIDATES = 2


class Method:
    """types.go:46-52."""

    reason: str = ""
    consolidation_type: str = ""
    disruption_class: str = "graceful"

    def should_disrupt(self, candidate: Candidate) -> bool:
        raise NotImplementedError

    def compute_command(self, budgets: Dict[str, int],
                        candidates: List[Candidate]) -> Tuple[Command, object]:
        raise NotImplementedError


def _within_budget(budgets: Dict[str, int], candidates: List[Candidate]) -> List[Candidate]:
    """Trim a candidate list so no pool exceeds its allowed disruptions."""
    used: Dict[str, int] = {}
    out = []
    for c in candidates:
        pool = c.nodepool_name
        if used.get(pool, 0) >= budgets.get(pool, 0):
            continue
        used[pool] = used.get(pool, 0) + 1
        out.append(c)
    return out


class Emptiness(Method):
    """emptiness.go:57-122: nodes with zero reschedulable pods delete without
    simulation."""

    reason = REASON_EMPTY
    consolidation_type = "empty"

    def __init__(self, cluster: Cluster, provisioner=None, recorder=None):
        self.cluster = cluster
        self.recorder = recorder or Recorder(cluster.clock)

    def should_disrupt(self, c: Candidate) -> bool:
        policy = c.nodepool.spec.disruption.consolidation_policy
        if policy not in (WHEN_EMPTY, WHEN_EMPTY_OR_UNDERUTILIZED):
            return False
        if c.nodepool.spec.disruption.consolidate_after is None:
            # emptiness.go:46-49
            self.recorder.publish(*events_catalog.unconsolidatable(
                c.name, _nodeclaim_name(c),
                f'NodePool "{c.nodepool_name}" has consolidation disabled'))
            return False
        if c.state_node.nodeclaim is None or \
                not c.state_node.nodeclaim.conditions.is_true(COND_CONSOLIDATABLE):
            return False
        return not c.reschedulable_pods

    def compute_command(self, budgets, candidates):
        empty = [c for c in candidates if not c.reschedulable_pods]
        fitting = _within_budget(budgets, empty)
        return Command(candidates=fitting, reason=self.reason,
                       consolidation_type=self.consolidation_type), None


class Drift(Method):
    """drift.go:57-113: Drifted claims go first, oldest first; empty drifted
    nodes delete en masse, the rest one-at-a-time with a replacement sim."""

    reason = REASON_DRIFTED
    disruption_class = "eventual"

    def __init__(self, cluster: Cluster, provisioner, recorder=None):
        self.cluster = cluster
        self.provisioner = provisioner
        self.recorder = recorder or Recorder(cluster.clock)

    def should_disrupt(self, c: Candidate) -> bool:
        nc = c.state_node.nodeclaim
        return nc is not None and nc.conditions.is_true(COND_DRIFTED)

    def compute_command(self, budgets, candidates):
        candidates = sorted(
            candidates,
            key=lambda c: c.state_node.nodeclaim.metadata.creation_timestamp
            if c.state_node.nodeclaim is not None else 0.0)
        candidates = _within_budget(budgets, candidates)
        empty = [c for c in candidates if not c.reschedulable_pods]
        if empty:
            return Command(candidates=empty, reason=self.reason), None
        for c in candidates:
            try:
                results, sim_errors = simulate_scheduling(
                    self.cluster, self.provisioner, [c])
            except CandidateError:
                continue
            if sim_errors:
                # drift.go:101-106: report WHY the drifted node can't move
                self.recorder.publish(*events_catalog.disruption_blocked(
                    c.name, _nodeclaim_name(c),
                    format_sim_errors(sim_errors)))
                continue
            return Command(candidates=[c],
                           replacements=list(results.new_nodeclaims),
                           reason=self.reason), results
        return Command(reason=self.reason), None


def filter_out_same_type(replacement, candidates: List[Candidate]):
    """multinodeconsolidation.go:180-217: when the replacement's instance-type
    options include a type currently being deleted, drop every option at or
    above the cheapest such type's current price. Replacing [2xlarge, 2xlarge,
    small] with one `small` is really just deleting the two 2xlarges — the
    consolidation must be rejected (or constrained to strictly cheaper types).
    Returns the surviving instance-type options (possibly empty)."""
    from ..scheduling.requirements import label_requirements

    existing_types = set()
    price_by_type: Dict[str, float] = {}
    for c in candidates:
        if c.instance_type is None:
            continue
        existing_types.add(c.instance_type.name)
        offs = c.instance_type.offerings.compatible(
            label_requirements(c.state_node.labels()))
        if not offs:
            continue
        p = offs.cheapest().price
        if p < price_by_type.get(c.instance_type.name, float("inf")):
            price_by_type[c.instance_type.name] = p

    max_price = float("inf")
    for it in replacement.instance_type_options:
        if it.name in existing_types:
            # a candidate type with no compatible offering recorded (e.g. a
            # spot offering just pulled) prices at 0 in the reference's map
            # lookup, forcing rejection — mirror that, not +inf
            p = price_by_type.get(it.name, 0.0)
            if p < max_price:
                max_price = p
    filtered, err = replacement.remove_instance_types_by_price_and_min_values(
        replacement.requirements, max_price)
    if err is not None or filtered is None:
        return []
    return filtered.instance_type_options


class consolidation(Method):
    """consolidation.go:77-302 shared base."""

    reason = REASON_UNDERUTILIZED

    def __init__(self, cluster: Cluster, provisioner,
                 spot_to_spot_enabled: bool = False, clock=None,
                 recorder=None):
        self.cluster = cluster
        self.provisioner = provisioner
        self.spot_to_spot_enabled = spot_to_spot_enabled
        self.clock = clock or cluster.clock
        self.recorder = recorder or Recorder(self.clock)
        # per-method memoized cluster token (consolidation.go:60): each
        # method tracks the last cluster state IT found nothing in, so one
        # method marking consolidated never suppresses the others
        self._last_state: Optional[float] = None
        # the pass-shared DisruptionSnapshot, attached by the controller so
        # all methods of one pass share a single encode; None for standalone
        # callers (tests, direct use) — sims then build their own state
        self._pass_snapshot = None
        # closed-form multi-node subset engine stats of the last search
        self.last_multi_engine_stats = None

    def attach_snapshot(self, snapshot) -> None:
        self._pass_snapshot = snapshot

    def should_disrupt(self, c: Candidate) -> bool:
        """consolidation.go:85-117: the price-comparison prerequisites and
        policy gates publish Unconsolidatable so operators can see WHY a
        node never consolidates."""
        ncn = _nodeclaim_name(c)
        if c.instance_type is None:
            it_label = c.state_node.labels().get(
                api_labels.LABEL_INSTANCE_TYPE, "")
            self.recorder.publish(*events_catalog.unconsolidatable(
                c.name, ncn, f'Instance Type "{it_label}" not found'))
            return False
        if not c.capacity_type:
            self.recorder.publish(*events_catalog.unconsolidatable(
                c.name, ncn, 'Node does not have label '
                f'"{api_labels.CAPACITY_TYPE_LABEL_KEY}"'))
            return False
        if not c.zone:
            self.recorder.publish(*events_catalog.unconsolidatable(
                c.name, ncn, 'Node does not have label '
                f'"{api_labels.LABEL_TOPOLOGY_ZONE}"'))
            return False
        if c.nodepool.spec.disruption.consolidate_after is None:
            self.recorder.publish(*events_catalog.unconsolidatable(
                c.name, ncn,
                f'NodePool "{c.nodepool_name}" has consolidation disabled'))
            return False
        if c.nodepool.spec.disruption.consolidation_policy != \
                WHEN_EMPTY_OR_UNDERUTILIZED:
            self.recorder.publish(*events_catalog.unconsolidatable(
                c.name, ncn, f'NodePool "{c.nodepool_name}" has non-empty '
                'consolidation disabled'))
            return False
        nc = c.state_node.nodeclaim
        return nc is not None and nc.conditions.is_true(COND_CONSOLIDATABLE)

    def is_consolidated(self) -> bool:
        """True when nothing changed since this method last found nothing
        (consolidation.go:76-79)."""
        return self._last_state is not None and \
            self._last_state == self.cluster.consolidation_state()

    def mark_consolidated(self) -> None:
        """Record (not set) the cluster token (consolidation.go:81-84)."""
        self._last_state = self.cluster.consolidation_state()

    def _filter_disruptable(self, budgets: Dict[str, int],
                            candidates: List[Candidate]):
        """The shared pre-filter (multinodeconsolidation.go:59-77,
        singlenodeconsolidation.go:55-68): drop candidates whose nodepool
        budget is exhausted (order-preserving, decrementing as we go) and
        empty candidates (an empty node here means Emptiness was budget-
        blocked; consolidating it would bypass the `empty` budget). Returns
        (disruptable, constrained_by_budgets)."""
        remaining = dict(budgets)
        out: List[Candidate] = []
        constrained = False
        for c in candidates:
            if remaining.get(c.nodepool_name, 0) <= 0:
                constrained = True
                continue
            if not c.reschedulable_pods:
                continue
            remaining[c.nodepool_name] -= 1
            out.append(c)
        return out, constrained

    # -- core decision (consolidation.go:131-222) ---------------------------

    def compute_consolidation(self, candidates: List[Candidate]
                              ) -> Tuple[Command, object]:
        try:
            if self._pass_snapshot is not None:
                # pass-shared encode (falls back to the host solver inside
                # when the batch isn't expressible)
                results, sim_errors = self._pass_snapshot.simulate(candidates)
            else:
                results, sim_errors = simulate_scheduling(
                    self.cluster, self.provisioner, candidates)
        except CandidateError:
            return Command(reason=self.reason), None
        return self.decide(candidates, results, sim_errors)

    def _unconsolidatable_single(self, candidates: List[Candidate],
                                 reason: str) -> None:
        """consolidation.go publishes decide-stage events only in the
        single-candidate case (multi-node probes would spam every prefix)."""
        if len(candidates) == 1:
            self.recorder.publish(*events_catalog.unconsolidatable(
                candidates[0].name, _nodeclaim_name(candidates[0]), reason))

    def decide(self, candidates: List[Candidate], results, sim_errors
               ) -> Tuple[Command, object]:
        """The post-simulation decision (consolidation.go:144-222)."""
        if sim_errors:
            self._unconsolidatable_single(
                candidates, format_sim_errors(sim_errors))  # :146-149
            return Command(reason=self.reason), None
        if not results.new_nodeclaims:
            return Command(candidates=list(candidates), reason=self.reason,
                           consolidation_type=self.consolidation_type), results
        if len(results.new_nodeclaims) != 1:
            self._unconsolidatable_single(
                candidates, "Can't remove without creating "
                f"{len(results.new_nodeclaims)} candidates")  # :160-164
            return Command(reason=self.reason), None

        candidate_price = 0.0
        for c in candidates:
            p = c.price()
            if p is None:
                return Command(reason=self.reason), None
            candidate_price += p

        replacement = results.new_nodeclaims[0]
        # sort by price FIRST (consolidation.go:183): the ≥15-cheaper gate,
        # the minValues prefix, and the launch-list slice are all prefix
        # operations over a price-ordered list — host-path claims carry
        # catalog-ordered options (the tensor path happens to pre-sort)
        from ..cloudprovider.types import order_by_price
        replacement.instance_type_options = order_by_price(
            replacement.instance_type_options, replacement.requirements)
        all_spot = all(c.capacity_type == api_labels.CAPACITY_TYPE_SPOT
                       for c in candidates)
        ct_req = replacement.requirements.get(api_labels.CAPACITY_TYPE_LABEL_KEY)
        if all_spot and ct_req.has(api_labels.CAPACITY_TYPE_SPOT):
            return self._spot_to_spot(candidates, results, candidate_price)

        filtered, err = replacement.remove_instance_types_by_price_and_min_values(
            replacement.requirements, candidate_price)
        if err is not None or filtered is None:
            self._unconsolidatable_single(
                candidates, f"Filtering by price: {err}")  # :196-200
            return Command(reason=self.reason), None
        if not filtered.instance_type_options:
            self._unconsolidatable_single(
                candidates, "Can't replace with a cheaper node")  # :202-206
            return Command(reason=self.reason), None
        # OD->[OD,spot] must pin spot so a failed spot launch doesn't upgrade
        # to pricier on-demand (consolidation.go:212-219)
        ct_req = filtered.requirements.get(api_labels.CAPACITY_TYPE_LABEL_KEY)
        if ct_req.has(api_labels.CAPACITY_TYPE_SPOT) and \
                ct_req.has(api_labels.CAPACITY_TYPE_ON_DEMAND):
            filtered.requirements.add(Requirement(
                api_labels.CAPACITY_TYPE_LABEL_KEY, IN,
                [api_labels.CAPACITY_TYPE_SPOT]))
        return Command(candidates=list(candidates), replacements=[filtered],
                       reason=self.reason,
                       consolidation_type=self.consolidation_type), results

    def _spot_to_spot(self, candidates, results, candidate_price
                      ) -> Tuple[Command, object]:
        """consolidation.go:229-302."""
        if not self.spot_to_spot_enabled:
            self._unconsolidatable_single(
                candidates, "SpotToSpotConsolidation is disabled, can't "
                "replace a spot node with a spot node")  # :233-237
            return Command(reason=self.reason), None
        replacement = results.new_nodeclaims[0]
        replacement.requirements.add(Requirement(
            api_labels.CAPACITY_TYPE_LABEL_KEY, IN,
            [api_labels.CAPACITY_TYPE_SPOT]))
        filtered, err = replacement.remove_instance_types_by_price_and_min_values(
            replacement.requirements, candidate_price)
        if err is not None or filtered is None:
            self._unconsolidatable_single(
                candidates, f"Filtering by price: {err}")  # :248-252
            return Command(reason=self.reason), None
        if not filtered.instance_type_options:
            self._unconsolidatable_single(
                candidates, "Can't replace with a cheaper node")  # :254-258
            return Command(reason=self.reason), None
        if len(candidates) > 1:
            return Command(candidates=list(candidates), replacements=[filtered],
                           reason=self.reason,
                           consolidation_type=self.consolidation_type), results
        if len(filtered.instance_type_options) < MIN_SPOT_TO_SPOT_INSTANCE_TYPES:
            self._unconsolidatable_single(
                candidates, "SpotToSpotConsolidation requires "
                f"{MIN_SPOT_TO_SPOT_INSTANCE_TYPES} cheaper instance type "
                "options than the current candidate to consolidate, got "
                f"{len(filtered.instance_type_options)}")  # :274-278
            return Command(reason=self.reason), None
        # cap the launch list so the launched type is always inside it (no
        # continual-consolidation ping-pong); with minValues the cap is the
        # MAX of the default 15 and the prefix needed to satisfy minValues
        # (consolidation.go:281-296)
        cap = MIN_SPOT_TO_SPOT_INSTANCE_TYPES
        if filtered.requirements.has_min_values():
            from ..cloudprovider.types import satisfies_min_values
            needed, _ = satisfies_min_values(filtered.instance_type_options,
                                             filtered.requirements)
            cap = max(cap, needed)
        filtered.instance_type_options = filtered.instance_type_options[:cap]
        return Command(candidates=list(candidates), replacements=[filtered],
                       reason=self.reason,
                       consolidation_type=self.consolidation_type), results


class MultiNodeConsolidation(consolidation):
    """multinodeconsolidation.go:79-162.

    The reference binary-searches the largest prefix of cost-sorted candidates
    replaceable by ≤1 node, paying a full scheduling simulation per probe
    (O(log N) sims, each rebuilding scheduler state). Here the probes share
    ONE device feasibility program (disruption/prefix.py PrefixSimulator):
    prefixes differ only in which nodes are excluded and which pods are
    pending — host-side packer inputs — so the search costs one precompute
    plus O(log N) host greedy replays. Same decision, amortized device work;
    batches the kernel can't express fall back to per-probe simulation.
    """

    consolidation_type = "multi"

    def compute_command(self, budgets, candidates):
        candidates = sorted(candidates, key=lambda c: c.disruption_cost)
        candidates, constrained = self._filter_disruptable(budgets, candidates)
        candidates = candidates[:MULTI_NODE_CONSOLIDATION_CANDIDATES]
        cmd, results = self._first_n_consolidation_option(candidates)
        if cmd.is_empty() and not constrained:
            # budget-blocked candidates may free up next pass: only memoize
            # a genuine nothing-to-do (multinodeconsolidation.go:89-96)
            self.mark_consolidated()
        return cmd, results

    def _first_n_consolidation_option(self, candidates: List[Candidate]
                                      ) -> Tuple[Command, object]:
        """multinodeconsolidation.go:110-162 with shared-precompute probes
        and closed-form midpoint verdicts: a prefix the ranked subset
        engine PROVABLY rejects skips its replay entirely (the engine's
        exactness contract guarantees the replay's decide() would return
        an empty command), so the search replays only plausible prefixes
        — in the common ranked case, only the winner."""
        from ..metrics import registry as metrics
        from .prefix import PrefixFallback, PrefixSimulator

        # single candidates are SingleNodeConsolidation's job: always operate
        # on >= 2 at once (multinodeconsolidation.go:111-115)
        if len(candidates) < 2:
            return Command(reason=self.reason), None
        sim = None
        engine = None
        self.last_multi_engine_stats = None
        try:
            sim = PrefixSimulator(self.cluster, self.provisioner, candidates,
                                  snapshot=self._pass_snapshot)
        except PrefixFallback:
            pass
        except CandidateError:
            return Command(reason=self.reason), None
        if sim is not None and \
                len(candidates) >= MULTI_NODE_BATCH_MIN_CANDIDATES:
            from .batch import MultiNodeLooEngine
            from .prefix import SnapshotFallback
            try:
                engine = MultiNodeLooEngine(sim.snapshot, candidates,
                                            self.spot_to_spot_enabled)
            except (SnapshotFallback, CandidateError):
                engine = None
        deadline = self.clock.now() + MULTI_NODE_CONSOLIDATION_TIMEOUT
        # binary search on prefix size (multinodeconsolidation.go:110-162);
        # floor of 2 per the >= 2 rule above
        lo, hi = 2, len(candidates)
        best: Tuple[Command, object] = (Command(reason=self.reason), None)
        while lo <= hi:
            if self.clock.now() > deadline:
                # the shared-precompute probes are fast, but inexpressible
                # batches fall back to full per-probe simulation — bound it
                # (multinodeconsolidation.go:123-135)
                metrics.CONSOLIDATION_TIMEOUTS.inc(
                    {"consolidation_type": self.consolidation_type})
                return best
            mid = (lo + hi) // 2
            if engine is not None and engine.verdict(mid).kind == "reject":
                # provably empty without a replay (exactness contract)
                self.last_multi_engine_stats = dict(engine.stats)
                hi = mid - 1
                continue
            if sim is not None:
                results, sim_errors = sim.simulate(mid)
                cmd, results = self.decide(candidates[:mid], results,
                                           sim_errors)
            else:
                cmd, results = self.compute_consolidation(candidates[:mid])
            if not cmd.is_empty() and cmd.replacements:
                # a replacement whose type is already being deleted must be
                # strictly cheaper, else this "replace" is a worse "delete"
                cmd.replacements[0].instance_type_options = \
                    filter_out_same_type(cmd.replacements[0],
                                         candidates[:mid])
                if not cmd.replacements[0].instance_type_options:
                    cmd = Command(reason=self.reason)
            if cmd.is_empty():
                hi = mid - 1
                continue
            best = (cmd, results)
            lo = mid + 1
        if engine is not None:
            self.last_multi_engine_stats = dict(engine.stats)
        return best


class SingleNodeConsolidation(consolidation):
    """singlenodeconsolidation.go:44-101: linear scan, first win, 3-min
    timeout. Candidates are interleaved round-robin across nodepools (each
    pool's own candidates stay cost-ordered) so that when the timeout fires,
    every nodepool got a fair share of the evaluation window instead of the
    cheapest pool starving the rest."""

    consolidation_type = "single"

    @staticmethod
    def _fair_order(candidates: List[Candidate]) -> List[Candidate]:
        by_pool: Dict[str, List[Candidate]] = {}
        for c in sorted(candidates, key=lambda c: c.disruption_cost):
            by_pool.setdefault(c.nodepool_name, []).append(c)
        # pools ordered by their cheapest candidate; then round-robin
        pools = sorted(by_pool.values(), key=lambda cs: cs[0].disruption_cost)
        out: List[Candidate] = []
        for i in range(max((len(cs) for cs in pools), default=0)):
            out.extend(cs[i] for cs in pools if i < len(cs))
        return out

    def compute_command(self, budgets, candidates):
        from ..metrics import registry as metrics
        deadline = self.clock.now() + SINGLE_NODE_CONSOLIDATION_TIMEOUT
        # budget gate UP FRONT over the full fair order: the `constrained`
        # signal must cover pools the deadline would otherwise hide, so a
        # timed-out pass can never read as an exhaustive "nothing to do".
        # NOT _filter_disruptable: a single-node command disrupts exactly
        # one node, so the reference only skips zero-budget pools and never
        # decrements (singlenodeconsolidation.go:55-68) — decrementing
        # would cap the scan at B candidates per pool and starve wins
        # sitting past the cap
        eligible: List[Candidate] = []
        constrained = False
        for c in self._fair_order(candidates):
            if budgets.get(c.nodepool_name, 0) <= 0:
                constrained = True
                continue
            if not c.reschedulable_pods:
                # empty nodes are Emptiness' (budget-gated) job
                continue
            eligible.append(c)
        engine = None
        engine_tried = False
        self.last_engine_stats = None
        timed_out = False
        for idx, c in enumerate(eligible):
            if self.clock.now() > deadline:
                metrics.CONSOLIDATION_TIMEOUTS.inc(
                    {"consolidation_type": self.consolidation_type})
                timed_out = True
                break
            if not engine_tried:
                engine_tried = True
                engine = self._build_engine(eligible)
            if engine is not None:
                verdict = engine.verdict(idx)
                if verdict.kind == "reject":
                    # provably unconsolidatable without a simulation; the
                    # reason mirrors what decide() would have published
                    if verdict.reason:
                        self.recorder.publish(*events_catalog.unconsolidatable(
                            c.name, _nodeclaim_name(c), verdict.reason))
                    continue
                try:
                    results, sim_errors = engine.probe(idx)
                except CandidateError:
                    continue
                cmd, results = self.decide([c], results, sim_errors)
                self.last_engine_stats = dict(engine.stats)
                if not cmd.is_empty():
                    return cmd, results
                continue
            cmd, results = self.compute_consolidation([c])
            if not cmd.is_empty():
                return cmd, results
        if engine is not None:
            self.last_engine_stats = dict(engine.stats)
        if timed_out or constrained:
            # a timed-out or budget-constrained pass proved nothing about
            # the unseen candidates: memoizing would suppress a later pass
            # that could succeed against unchanged cluster state
            return Command(reason=self.reason), None
        self.mark_consolidated()
        return Command(reason=self.reason), None

    def _build_engine(self, eligible: List[Candidate]):
        """The batched leave-one-out classifier over the pass snapshot, or
        None when the candidate set is too small to amortize the encode or
        the batch isn't expressible (per-candidate sims take over)."""
        if len(eligible) < SINGLE_NODE_BATCH_MIN_CANDIDATES:
            return None
        from .batch import LeaveOneOutEngine
        from .prefix import DisruptionSnapshot, SnapshotFallback
        try:
            snapshot = self._pass_snapshot or DisruptionSnapshot(
                self.cluster, self.provisioner)
            return LeaveOneOutEngine(snapshot, eligible,
                                     self.spot_to_spot_enabled)
        except (SnapshotFallback, CandidateError):
            return None
