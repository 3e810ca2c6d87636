"""GPU-accelerated scheduler front end.

Builds the encoded PackProblem from the same inputs the host Scheduler takes,
runs the device feasibility precompute + grouped packer (ops/binpack.py), and
materializes results in the host Results shape. Falls back to the host oracle
scheduler (provisioning/scheduler.py) whenever the batch isn't expressible in
the tensor kernel or when packing left relaxable pods unscheduled — so observable
semantics always match the reference (scheduler.go) either way.

The precompute runs on ``device`` (default ``cuda``; ``"cpu"`` runs the
kernels' plain PyTorch versions), or once per slot of a ``mesh``
(parallel/mesh.py). The persistent cross-pass ProblemState and the flight
recorder (every solve captured as a replayable record, flightrec/) are
carried as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..api import labels as api_labels
from ..api.nodeclaim import NodeClaim as APINodeClaim, NodeClaimSpec
from ..api.objects import ObjectMeta, OwnerReference, Pod
from ..cloudprovider.types import InstanceType
from ..obs.tracer import TRACER
from ..ops import binpack
from ..ops import encode as enc
from ..ops import kernels
from ..scheduling import taints as scheduling_taints
from ..scheduling.requirement import IN, Requirement
from ..scheduling.requirements import (ALLOW_UNDEFINED_WELL_KNOWN, Requirements,
                                       label_requirements)
from ..utils import resources as res
from .grouping import PodGroup, group_pods, partition_pods
# claim_name_seq: ONE process-wide claim-name sequence shared with the host
# oracle (independent counters minted colliding claim names)
from .scheduler import (MAX_INSTANCE_TYPES, NodeClaimTemplate, Results, Scheduler,
                        _daemon_overhead, _req_to_selector, claim_name_seq)
from .topology import ClusterView, Topology


def _pow2_bucket(n: int, minimum: int) -> int:
    """Next power of two >= max(n, minimum): bounded distinct jit shapes
    (shared implementation: ops/encode.pow2_bucket)."""
    return enc.pow2_bucket(n, minimum)


@dataclass
class _CatalogEncoding:
    """Catalog-side tensors shared across solves. The instance-type catalog
    is stable between reconcile passes (providers refresh it on the order of
    minutes), while the solver runs every batch window — so the vocabulary,
    the encoded IT requirement masks, the offering tensors, AND their
    device-resident copies are all reusable. Reuse is only legal when the
    new solve introduces no vocabulary entries (checked by _fits_vocab):
    complement-encoded masks enumerate the value universe, so any new value
    would invalidate every cached row."""
    vocab: object
    zone_key: int
    captype_key: int
    it_enc: object
    it_alloc: np.ndarray
    it_capacity: np.ndarray
    it_price: np.ndarray
    off_zone: np.ndarray
    off_captype: np.ndarray
    off_available: np.ndarray
    off_price: np.ndarray
    zone_values: np.ndarray
    allow_undefined: np.ndarray
    device_cache: dict
    # offering identities as strings [T] / [T, O] ("" = absent slot):
    # the unavailable-offerings registry mask is built by matching its
    # (instance_type, zone, capacity_type) patterns against these in a few
    # vectorized passes per solve — no per-offering Python on the hot path
    off_names: np.ndarray = None
    off_zone_names: np.ndarray = None
    off_ct_names: np.ndarray = None


import threading
import time
from collections import OrderedDict


class SolverCircuitBreaker:
    """Circuit breaker on the tensor solve path.

    The host oracle is always a correct (slower) fallback, so a *crashing*
    tensor path — a host-side bug on an unforeseen batch — degrades the
    solver to the oracle instead of failing every provisioning pass
    through its retry budget. A failure of the kernels on the card
    (``kernels.KernelError``: build, launch, device OOM, a CUDA error at
    upload or fetch) is raised to the caller and never counted: the card's
    work is not moved to the CPU. Classic three-state
    breaker: CLOSED counts consecutive tensor-path exceptions; at
    `threshold` it OPENs (every solve goes straight to the host with
    fallback_reason="circuit_open", no tensor attempt, no device touch);
    after `cooldown` seconds the next solve HALF-OPENs as a probe — one
    success re-closes, one failure re-opens for another cooldown.

    The closed-state hot path is a single attribute compare — zero
    measurable overhead on the headline solve (BENCH_MODE=faults pins
    this). State transitions publish the solver_circuit_state gauge
    (0=closed, 1=open, 2=half-open) — only when constructed with
    `publish=True`: the gauge is a single series, so exactly one breaker
    (the process-wide SOLVER_CIRCUIT) owns it; ad-hoc breakers (bench,
    tests, experiments) must not stomp the production export. `now` is
    injectable for fake-clock tests; the default is monotonic wall time.
    Thread-safe: the sidecar serves solves from a thread pool, so failure
    counting and transitions take a lock (concurrent half-open probes are
    allowed — worst case a few extra probes race, all of which must
    succeed to matter)."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
    _GAUGE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}

    def __init__(self, threshold: int = 5, cooldown: float = 30.0,
                 now=None, publish: bool = False):
        self.threshold = threshold
        self.cooldown = cooldown
        self._now = now or time.monotonic
        self._lock = threading.Lock()
        self._failures = 0
        self._opened_at = 0.0
        self._publish_metric = publish
        self.state = self.CLOSED
        self._publish()

    def _publish(self) -> None:
        if not self._publish_metric:
            return
        from ..metrics.registry import SOLVER_CIRCUIT_STATE
        SOLVER_CIRCUIT_STATE.set(self._GAUGE[self.state])

    def allow(self) -> bool:
        """May this solve attempt the tensor path?"""
        if self.state == self.CLOSED:
            return True
        with self._lock:
            if self.state == self.OPEN \
                    and self._now() - self._opened_at >= self.cooldown:
                self.state = self.HALF_OPEN
                self._publish()
            return self.state != self.OPEN

    def record_success(self) -> None:
        if self._failures == 0 and self.state == self.CLOSED:
            return  # hot path: nothing to reset, skip the lock
        with self._lock:
            self._failures = 0
            if self.state != self.CLOSED:
                self.state = self.CLOSED
                self._publish()

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self.state == self.HALF_OPEN \
                    or self._failures >= self.threshold:
                self._opened_at = self._now()
                if self.state != self.OPEN:
                    self.state = self.OPEN
                    self._publish()

    def reset(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = 0.0
            if self.state != self.CLOSED:
                self.state = self.CLOSED
                self._publish()


# Process-wide breaker: TensorScheduler instances are constructed per solve
# (provisioner scheduler_factory), so breaker state MUST outlive them. Sole
# owner of the solver_circuit_state gauge.
SOLVER_CIRCUIT = SolverCircuitBreaker(publish=True)

_CATALOG_CACHE: "OrderedDict[tuple, _CatalogEncoding]" = OrderedDict()
_CATALOG_CACHE_MAX = 4
# the sidecar serves concurrent solves from a thread pool; the cache (and
# its LRU reordering) is the only cross-request mutable state on this path
_CATALOG_CACHE_LOCK = threading.Lock()


def _reqs_digest(reqs) -> tuple:
    return tuple(sorted(
        (r.key, r.complement, frozenset(r.values), r.greater_than, r.less_than)
        for r in reqs.values()))


def _catalog_cache_key(catalog: List[InstanceType]) -> tuple:
    """Content key over every fact the encoding depends on: name, requirement
    set, capacity/allocatable, and offerings. Requirements are keyed
    explicitly (not assumed stable per name) so a provider mutating an IT's
    requirement set in place can never reuse stale complement-encoded masks."""
    return tuple(
        (it.name, _reqs_digest(it.requirements),
         tuple(sorted(it.allocatable().items())),
         tuple(sorted(it.capacity.items())),
         tuple((o.zone, o.capacity_type, o.price, o.available)
               for o in it.offerings))
        for it in catalog)


def _ordered_union(its_lists) -> "Tuple[List[InstanceType], Dict[str, int]]":
    """Name-deduped instance-type union in first-seen order — THE union
    order behind the order-dependent catalog encodings."""
    catalog: List[InstanceType] = []
    it_index: Dict[str, int] = {}
    for its in its_lists:
        for it in its:
            if it.name not in it_index:
                it_index[it.name] = len(catalog)
                catalog.append(it)
    return catalog, it_index


def catalog_cache_token(nodepools, instance_types) -> tuple:
    """Precomputed catalog cache key for callers whose catalog is immutable
    for their lifetime (the sidecar session, a disruption snapshot, the
    streaming disruption state): hashing 2k instance types per solve is
    pure overhead when the owner guarantees no in-place mutation. Uses
    build_problem's union order (_ordered_union; pools with no instance
    types contribute nothing either way)."""
    catalog, _ = _ordered_union(
        instance_types.get(np_.name, []) for np_ in nodepools)
    return _catalog_cache_key(catalog)


def catalog_encoding_pin(token):
    """Strong reference to the live CatalogEncoding for `token` (None when
    nothing is cached yet). Multi-tenant sidecar sessions pin their
    tenant's encoding: vocab IDENTITY gates every ProblemState row cache,
    so an LRU eviction forced by ANOTHER tenant's catalog traffic would
    silently demote this tenant's next solve to a cold re-encode.

    The pin holds the encoding's ``device_cache`` too, the catalog's
    tensors uploaded to each device that solved with it: a pinned session
    keeps its catalog on the card for as long as it lives. Sessions are
    bounded by the sidecar's session cap (``KARPENTER_SIDECAR_MAX_SESSIONS``,
    default 8), so at most that many catalogs stay resident beyond the
    LRU's own four."""
    with _CATALOG_CACHE_LOCK:
        return _CATALOG_CACHE.get(token)


def restore_catalog_encoding(token, ce) -> None:
    """Reinstate a pinned encoding the LRU evicted under other tenants'
    traffic — the PINNED object, never a re-encode, so vocab identity (and
    with it every delta cache keyed on it, and its device uploads) survives.
    May briefly push the cache past its LRU cap; bounded by the sidecar's
    session cap."""
    if ce is None:
        return
    with _CATALOG_CACHE_LOCK:
        if token not in _CATALOG_CACHE:
            _CATALOG_CACHE[token] = ce
        _CATALOG_CACHE.move_to_end(token)


class TensorNodeClaim:
    """A launch decision produced by the tensor packer; interface-compatible
    with provisioning.scheduler.InFlightNodeClaim for downstream consumers."""

    def __init__(self, template: NodeClaimTemplate, requirements: Requirements,
                 instance_types: List[InstanceType], pods: List[Pod], requests: dict):
        self.template = template
        self.requirements = requirements
        self.instance_type_options = instance_types
        self.pods = pods
        self.requests = requests

    def finalize(self) -> None:
        self.requirements.delete(api_labels.LABEL_HOSTNAME)

    def remove_instance_types_by_price_and_min_values(self, reqs, max_price: float):
        """Consolidation price filter (nodeclaim.go:136-145)."""
        from ..cloudprovider.types import (below_worst_launch_price,
                                           satisfies_min_values)
        with TRACER.span("disruption.prices") as sp:
            self.instance_type_options, prices = below_worst_launch_price(
                self.instance_type_options, reqs, max_price)
            sp.set(vectors=prices.built, types=len(prices.catalog))
        _, err = satisfies_min_values(self.instance_type_options, reqs)
        if err is not None:
            return None, err
        return self, None

    def to_nodeclaim(self) -> APINodeClaim:
        t = self.template
        reqs = self.requirements.copy()
        instance_types = self.instance_type_options[:MAX_INSTANCE_TYPES]
        mv = reqs.get(api_labels.LABEL_INSTANCE_TYPE).min_values
        reqs.add(Requirement(api_labels.LABEL_INSTANCE_TYPE, IN,
                             [it.name for it in instance_types], min_values=mv))
        return APINodeClaim(
            metadata=ObjectMeta(
                name=f"{t.nodepool_name}-{next(claim_name_seq):05d}",
                labels=dict(t.labels), annotations=dict(t.annotations),
                owner_refs=[OwnerReference(kind="NodePool", name=t.nodepool_name,
                                           uid=t.nodepool_uid, block_owner_deletion=True)]),
            spec=NodeClaimSpec(
                requirements=[_req_to_selector(r) for r in reqs.values()],
                resources_requests=dict(self.requests),
                taints=list(t.taints), startup_taints=list(t.startup_taints),
                node_class_ref=t.node_class_ref, expire_after=t.expire_after,
                termination_grace_period=t.termination_grace_period))


@dataclass
class TensorExistingNode:
    state_node: object
    pods: List[Pod]

    @property
    def name(self):
        return self.state_node.name()


class TensorScheduler:
    def __init__(self, nodepools, instance_types: Dict[str, List[InstanceType]],
                 state_nodes=(), daemonset_pods: List[Pod] = (),
                 cluster: Optional[ClusterView] = None,
                 initial_zone_counts=None, force_tensor: bool = False,
                 mesh=None, catalog_token: Optional[tuple] = None,
                 circuit: Optional[SolverCircuitBreaker] = None,
                 unavailable=None, problem_state=None, device=None):
        # where the feasibility precompute runs: cuda unless the caller
        # names another device (with a mesh: the device of its first slot,
        # which also runs the exist-only delta); raises here when CUDA is
        # asked for and absent, before any solve could fall back to the
        # host oracle
        if device is None and mesh is not None:
            device = mesh.devices.flat[0].device
        self.device = binpack.resolve_device(device)
        self.nodepools = list(nodepools)
        self.instance_types = instance_types
        self.state_nodes = list(state_nodes)
        self.daemonset_pods = list(daemonset_pods)
        self.cluster = cluster or ClusterView()
        self.initial_zone_counts = initial_zone_counts  # callable (group, zones)->counts
        self.force_tensor = force_tensor
        # optional parallel.mesh.Mesh: run the feasibility precompute once
        # per mesh slot (parallel/mesh.py) instead of on one device
        self.mesh = mesh
        # precomputed catalog cache key (_catalog_cache_key of the union
        # catalog): ONLY valid when the caller guarantees the catalog is
        # never mutated in place
        self.catalog_token = catalog_token
        # shared breaker by default: schedulers are per-solve, trips aren't
        self.circuit = circuit if circuit is not None else SOLVER_CIRCUIT
        # state.unavailable.UnavailableOfferings: live entries are masked
        # out of off_available / it_price before every solve (tensor path)
        # and out of the catalog copies the host fallback sees, so neither
        # solver ever places onto an offering known to be dry
        self.unavailable = unavailable
        # the pattern set the LAST solve actually masked with: consumers
        # that must reproduce this solve's view read these instead of the
        # live registry, whose TTLs keep ticking under a real clock.
        # _drought_pinned marks that THIS solve already snapshotted them
        # (tensor build), so a host fallback later in the same solve reuses
        # the identical view.
        self.drought_patterns: tuple = ()
        self._drought_pinned = False
        # optional flightrec.FlightRecorder: every solve() is captured as a
        # replayable DecisionRecord. None (the default) costs one attribute
        # compare per solve.
        self.flight_recorder = None
        self.fallback_reason: str = ""
        # trace id of the pass this scheduler's last solve() ran under
        # ("" when tracing is disabled): stamped onto flight-recorder
        # records and the provisioner's summary log line
        self.last_trace_id = ""
        # "cold" | "delta": how this solve's problem encode was produced
        # (delta = cached rows against an unchanged vocabulary). Recorded on
        # every flight-recorder DecisionRecord; replay re-encodes cold, so a
        # byte-identical replay verdict on a delta record pins the delta
        # path's determinism contract.
        self.encode_kind = "cold"
        # (pods solved on the tensor path, pods handed to the host pass)
        self.partition = (0, 0)
        # per-solve fallback cost attribution (obs/fallbacks.py): shape-
        # class pod counts + the host-vs-tensor wall split of the LAST
        # solve — the fleet simulator and /debug/fallbacks read this
        self.fallback_attribution: dict = {}
        # which subsystem's traffic this scheduler's solves represent in
        # the fallback ledger: the provisioner's simulation entry point
        # (schedule_with(record=False)) and the DisruptionSnapshot flip
        # this to "disruption" EXPLICITLY, so candidate-build probes never
        # pollute the headline provisioning totals even with tracing off
        # (the root-span heuristic in _record_fallbacks is a backstop,
        # not the source of truth)
        self.ledger_subsystem = "provisioning"
        self._breakdown: list = []     # partition_pods (reason, count) rows
        self._tensor_seconds = 0.0
        self._host_seconds = 0.0
        # per-instance state-node encoding memo keyed by vocab identity:
        # the disruption snapshot builds several problems against the SAME
        # frozen node set + catalog vocab per pass, and re-encoding 5k node
        # label sets per build was the dominant host cost (group-side work
        # is tiny). Provisioning constructs a scheduler per solve, so the
        # memo is exactly one-pass-scoped there too.
        self._exist_memo: dict = {}
        # the state nodes' labels column by column (enc.NodeLabelTable),
        # built on first use by the vocab check, the catalog encode or the
        # node encode, and shared by all three for this scheduler's life
        self._node_labels: Optional[enc.NodeLabelTable] = None
        # provisioning.problem_state.ProblemState: the persistent cross-pass
        # delta cache (node rows, group rows, topology-count memo, warm-pack
        # seed). None (the default) keeps the self-contained cold path —
        # disruption simulation probes and ad-hoc schedulers never share it.
        self.problem_state = problem_state
        if problem_state is not None:
            # bind the state to this scheduler's mesh/shard identity: a
            # flip (mesh recreated over other devices, shard count change,
            # mesh dropped) drops the per-shard exist tokens + tensors memo
            # so a mesh<->single-device swap in one process can never reuse
            # artifacts recorded under the other carve
            if mesh is not None:
                from ..parallel.mesh import (PODS_GROUPS_AXIS,
                                             mesh_cache_key)
                problem_state.attach_mesh(
                    mesh_cache_key(mesh),
                    int(dict(mesh.shape).get(PODS_GROUPS_AXIS, 0)))
            else:
                problem_state.attach_mesh(None, 0)

    # -- public -------------------------------------------------------------

    def solve(self, pods: List[Pod], prebuckets=None) -> Results:
        from ..utils.gcpause import no_gc
        rec = self.flight_recorder
        # roots its own PassTrace when no pass span is active (bench, sims);
        # nests under a pass loop otherwise
        with TRACER.span("solve", pods=len(pods)) as sp:
            started = time.perf_counter() if rec is not None else 0.0
            with no_gc():
                results = self._solve(pods, prebuckets)
            sp.set(encode_kind=self.encode_kind,
                   fallback_reason=self.fallback_reason)
            TRACER.annotate(encode_kind=self.encode_kind)
            # the pass trace_id joins this solve's trace, its flight-recorder
            # record, and the provisioner's log line
            self.last_trace_id = TRACER.current_trace_id()
            self._record_fallbacks(len(pods))
            if rec is not None:
                rec.capture_provisioning(self, pods, results,
                                         time.perf_counter() - started)
        return results

    def _solve(self, pods: List[Pod], prebuckets=None) -> Results:
        # fresh registry snapshot per solve (see drought_patterns)
        self._drought_pinned = False
        self.encode_kind = "cold"
        self._breakdown = []
        self._tensor_seconds = 0.0
        self._host_seconds = 0.0
        if self.problem_state is not None:
            self.problem_state.begin_solve()
        # port eligibility needs existing-node usage: a port occupied on a
        # live node makes its pods CONFLICTED (capped groups with per-node
        # exclusion) instead of constraint-free
        with TRACER.span("partition") as psp:
            if self.state_nodes:
                usages = [sn.host_port_usage() for sn in self.state_nodes]

                def port_occupied(triples):
                    return any(u.conflicts_triples(triples) for u in usages)
            else:
                port_occupied = lambda triples: False  # noqa: E731
            groups, leftover, reason = partition_pods(
                pods, prebuckets=prebuckets, port_occupied=port_occupied,
                breakdown=self._breakdown)
            psp.set(groups=len(groups), leftover=len(leftover))
        self.partition = (sum(g.count for g in groups), len(leftover))
        if not groups:
            return self._host_solve(pods, reason)
        if not self.force_tensor and not self.circuit.allow():
            # breaker open: the tensor path's host code crashed repeatedly
            # (kernel failures raise and are never counted) — serve from
            # the host oracle until the cooldown's half-open probe
            return self._host_solve(pods, "circuit_open")
        eligible = [p for g in groups for p in g.pods]
        t0 = time.perf_counter()
        try:
            try:
                results = self._tensor_solve(groups, eligible)
            finally:
                self._tensor_seconds += time.perf_counter() - t0
        except _FallbackError as e:
            # expected expressibility fallback: the kernel worked as
            # designed, so the breaker doesn't count it either way
            return self._host_solve(pods, str(e))
        except kernels.KernelError:
            # the kernels failed on the card (build, launch, or a CUDA error
            # at upload or fetch): the caller sees it — the work is never
            # moved to the CPU, and the breaker does not count it
            raise
        except Exception as e:  # noqa: BLE001 — host-side degradation
            from ..parallel.mesh import DeviceLadderExhausted
            if isinstance(e, DeviceLadderExhausted):
                # every ladder rung is gone: each lost device already fed
                # its OWN breaker, so the global one must not double-trip
                # — serve the host oracle and let the next pass's
                # half-open probes re-test the fleet
                return self._host_solve(pods,
                                        f"device ladder exhausted: {e}")
            self.circuit.record_failure()
            if self.force_tensor:
                raise
            return self._host_solve(pods, f"tensor solve failed: {e!r}")
        self.circuit.record_success()
        # the host pass only adds value over the packer for pods whose group
        # carries relaxable preferences (the relaxation ladder,
        # preferences.go:38-57) — for everything else it re-derives the same
        # verdict at O(pods x claims) host cost, so packer errors on
        # non-relaxable groups are final
        relaxable_err = None
        if results.pod_errors and not self.force_tensor:
            # errors minted while a nodepool LIMIT was excluding capacity
            # aren't oracle-final: the greedy order decides who gets the
            # scarce budget, and the packer's group order can strand a pod
            # the host's pod order would place — re-solve on the host path
            # (the oracle). Bounded cost: limits+errors batches are rare.
            if results.limit_constrained:
                return self._host_solve(
                    pods, "pack errors under nodepool limit pressure")
            err_uids = set(results.pod_errors)
            relaxable_err = [
                g for g in groups
                if g.has_relaxable and any(p.uid in err_uids for p in g.pods)]
        if not leftover:
            if relaxable_err:
                return self._host_solve(
                    pods, "unscheduled pods with relaxable preferences")
            return results
        # partitioned: the tensor bulk is committed; stragglers (plus any
        # relaxable-group pods the packer couldn't place — they get the
        # host's relaxation ladder) run through a host scheduler seeded with
        # the tensor placements, so capacity and in-flight nodes are shared
        # (scheduler.go:267-283 semantics: existing -> in-flight -> new)
        retry = [p for g in (relaxable_err or []) for p in g.pods
                 if p.uid in results.pod_errors]
        retry_uids = {p.uid for p in retry}
        kept_errors = {uid: err for uid, err in results.pod_errors.items()
                       if uid not in retry_uids}
        final = self._host_solve_remainder(leftover + retry, results)
        for uid, err in kept_errors.items():
            final.pod_errors.setdefault(uid, err)
        return final

    def _explain_errors(self, errors: Dict[str, str], groups, templates
                        ) -> None:
        """Error-message parity for the kernel's generic verdicts: when a
        group failed because NO template's requirements admit it, rewrite
        'no instance type satisfied the pod' into the host oracle's
        per-nodepool incompatibility string (scheduler.py:600-621) —
        including the near-miss label hints (requirements.go:189-251) that
        operators debug typos with."""
        explained: Dict[int, Optional[str]] = {}
        uid_group = {p.uid: gi for gi, g in enumerate(groups)
                     for p in g.pods}
        for uid, msg in errors.items():
            if msg != "no instance type satisfied the pod":
                continue
            gi = uid_group.get(uid)
            if gi is None:
                continue
            if gi not in explained:
                parts = []
                for nct in templates:
                    errs = nct.requirements.compatible(
                        groups[gi].requirements, ALLOW_UNDEFINED_WELL_KNOWN)
                    if errs:
                        # byte-for-byte the host oracle's string:
                        # scheduler.py:614 wraps scheduler.py:122's
                        # "incompatible requirements, {first error}"
                        # (nodeclaim.go:83 wraps the same way)
                        parts.append(
                            f'incompatible with nodepool '
                            f'"{nct.nodepool_name}", incompatible '
                            f'requirements, {errs[0]}')
                # only a FULLY requirement-incompatible group gets the
                # rewrite: with any compatible template the failure is
                # resource-shaped and the generic message is the truth
                explained[gi] = ("; ".join(parts)
                                 if len(parts) == len(templates) else None)
            if explained[gi]:
                errors[uid] = explained[gi]

    def _host_solve(self, pods: List[Pod], reason: str) -> Results:
        self.fallback_reason = reason
        with TRACER.span("host.solve", pods=len(pods), reason=reason):
            t0 = time.perf_counter()
            try:
                return self._make_host(pods).solve(pods)
            finally:
                self._host_seconds += time.perf_counter() - t0

    def _record_fallbacks(self, n_pods: int) -> None:
        """Assemble this solve's fallback cost attribution and feed the
        process-wide ledger. Per-class pod counts come from the
        partitioner's breakdown; a whole-batch fallback (circuit open,
        device error, an expressibility _FallbackError, limit-pressure or
        relaxable-preference re-solves) additionally charges the
        tensor-eligible pods to the fallback's own class, since they ran
        host too. A solve under a disruption.pass root is a candidate-build
        probe, not provisioning traffic — attributed to the disruption
        subsystem so ROADMAP item-1 priorities read clean."""
        from ..obs.fallbacks import (LEDGER, classify_breakdown,
                                     classify_reason)
        classes = classify_breakdown(self._breakdown)
        tensor_pods, host_pods = self.partition
        if self.fallback_reason:
            if tensor_pods:
                c = classify_reason(self.fallback_reason)
                classes[c] = classes.get(c, 0) + tensor_pods
            tensor_pods, host_pods = 0, n_pods
        self.fallback_attribution = {
            "classes": classes,
            "tensor_pods": tensor_pods,
            "host_pods": host_pods,
            "tensor_seconds": self._tensor_seconds,
            "host_seconds": self._host_seconds,
        }
        subsystem = self.ledger_subsystem
        if subsystem == "provisioning" \
                and TRACER.current_root_name().startswith("disruption"):
            # backstop for unflagged schedulers running under a disruption
            # pass (the explicit flag is the source of truth — it also
            # works with tracing disabled)
            subsystem = "disruption"
        LEDGER.record_solve(
            classes, tensor_pods, host_pods,
            self._tensor_seconds, self._host_seconds,
            trace_id=self.last_trace_id, encode_kind=self.encode_kind,
            subsystem=subsystem)

    def _make_host(self, pods: List[Pod]) -> Scheduler:
        from .domains import build_topology_domains
        instance_types = self.instance_types
        if self.unavailable is not None:
            # the host oracle reads offering availability off the catalog
            # objects, so the registry mask rides in as available=False
            # copies — fallback solves route around droughts exactly like
            # the tensor path's off_available mask. Patterns are pinned
            # once per solve so a tensor attempt, its host remainder, and
            # the capture/replay view all share ONE registry snapshot.
            from ..state.unavailable import mask_catalog
            if not self._drought_pinned:
                self.drought_patterns = self.unavailable.live()
                self._drought_pinned = True
            instance_types = mask_catalog(instance_types,
                                          self.drought_patterns)
        domains = build_topology_domains(self.nodepools, instance_types)
        topo = Topology(self.cluster, domains, pods)
        return Scheduler(self.nodepools, instance_types, topo,
                         state_nodes=self.state_nodes,
                         daemonset_pods=self.daemonset_pods)

    def _host_solve_remainder(self, pods: List[Pod], tensor_results: Results
                              ) -> Results:
        """Run the host oracle over the straggler pods with the tensor bulk's
        placements already committed: existing-node usage is seeded so
        capacity isn't double-booked, the tensor launch decisions become
        in-flight claims the host greedy can keep packing
        (scheduler.go:267-283), and every tensor-placed pod is recorded into
        the host Topology's domain counts. The recording matters for RETRY
        pods — tensor-eligible pods the packer failed to place share labels
        and self-selecting spread/affinity selectors with their tensor-placed
        groupmates, so the host solve's skew arithmetic must see the tensor
        half. (Leftover pods can't couple by construction — partition_pods
        demotes any group whose selectors touch host-side pods.)"""
        with TRACER.span("host.remainder", pods=len(pods)):
            t0 = time.perf_counter()
            try:
                return self._host_remainder(pods, tensor_results)
            finally:
                self._host_seconds += time.perf_counter() - t0

    def _host_remainder(self, pods: List[Pod], tensor_results: Results
                        ) -> Results:
        from .scheduler import InFlightNodeClaim, _subtract_max
        host = self._make_host(pods)
        by_name = {en.name: en for en in host.existing_nodes}
        for ten in tensor_results.existing_nodes:
            en = by_name.get(ten.name)
            if en is None or not ten.pods:
                continue
            en.pods.extend(ten.pods)
            en.requests = res.merge(en.requests,
                                    *(p.requests() for p in ten.pods))
            for p in ten.pods:
                host.topology.record(p, en.requirements)
                # seed CSI attach usage too, or a host-side volume pod
                # double-books the slots the tensor pass just consumed
                # (volumeusage.go:201-208)
                if p.spec.volumes and en._volume_usage is not None \
                        and en._store is not None:
                    from ..scheduling.volumeusage import get_volumes
                    en._volume_usage.add(get_volumes(en._store, p))
                # seed port usage too: a host-side port pod must see the
                # slots the tensor pass just bound (hostportusage.go:34-90)
                if p.spec.host_ports:
                    from ..scheduling.hostports import get_host_ports
                    en._host_port_usage.add(p, get_host_ports(p))
        tmpl_idx = {t.nodepool_name: i for i, t in enumerate(host.templates)}
        for tnc in tensor_results.new_nodeclaims:
            i = tmpl_idx.get(tnc.template.nodepool_name)
            if i is None:
                continue
            nct = host.templates[i]
            nc = InFlightNodeClaim(nct, host.topology, host.daemon_overhead[i],
                                   tnc.instance_type_options)
            nc.requirements.add(*tnc.requirements.values())
            nc.pods = list(tnc.pods)
            nc.requests = res.merge(nc.requests, tnc.requests)
            for p in nc.pods:
                host.topology.record(p, nc.requirements,
                                     ALLOW_UNDEFINED_WELL_KNOWN)
                if p.spec.host_ports:
                    from ..scheduling.hostports import get_host_ports
                    nc.host_port_usage.add(p, get_host_ports(p))
            host.new_nodeclaims.append(nc)
            remaining = host.remaining_resources.get(nct.nodepool_name)
            if remaining is not None:
                host.remaining_resources[nct.nodepool_name] = _subtract_max(
                    remaining, nc.instance_type_options)
        return host.solve(pods)

    # -- tensor path ----------------------------------------------------------

    def precompute(self, problem) -> binpack.PackTensors:
        """Device feasibility precompute, run once per slot of self.mesh
        when set (behind the device-loss degradation ladder: a device lost
        mid-dispatch re-places the solve on the surviving carve instead of
        failing the pass), else on this scheduler's device."""
        if self.mesh is not None:
            from ..parallel.mesh import resilient_precompute
            return resilient_precompute(problem, self.mesh)
        return binpack.precompute(problem, device=self.device)

    def build_problem(self, groups: List[PodGroup]):
        """Encode groups + catalog + state into a PackProblem; returns
        (problem, templates, catalog). Raises _FallbackError when the batch
        isn't expressible."""
        with TRACER.span("build_problem", groups=len(groups),
                         nodes=len(self.state_nodes)) as sp:
            out = self._build_problem(groups)
            sp.set(encode_kind=self.encode_kind)
            return out

    def _build_problem(self, groups: List[PodGroup]):
        templates: List[NodeClaimTemplate] = []
        for np_ in self.nodepools:
            nct = NodeClaimTemplate(np_)
            nct.instance_type_options = self.instance_types.get(np_.name, [])
            if nct.instance_type_options:
                templates.append(nct)
        if not templates:
            raise _FallbackError("no nodepools with instance types")

        # union instance-type catalog (shared order contract: _ordered_union)
        catalog, it_index = _ordered_union(
            nct.instance_type_options for nct in templates)
        T = len(catalog)
        M = len(templates)
        G = len(groups)

        ckey = (self.catalog_token if self.catalog_token is not None
                else _catalog_cache_key(catalog))
        with _CATALOG_CACHE_LOCK:
            ce = _CATALOG_CACHE.get(ckey)
        if ce is not None and not self._fits_vocab(ce.vocab, templates, groups):
            ce = None
        if ce is None:
            ce = self._encode_catalog(catalog, templates, groups)
        with _CATALOG_CACHE_LOCK:
            existing = _CATALOG_CACHE.get(ckey)
            if existing is not None and existing is not ce and \
                    self._fits_vocab(existing.vocab, templates, groups):
                ce = existing  # a concurrent request encoded it first
            else:
                if ckey not in _CATALOG_CACHE and \
                        len(_CATALOG_CACHE) >= _CATALOG_CACHE_MAX:
                    # LRU: catalogs alternate under multi-provider or prefix
                    # probing — evicting the least-recently-USED entry keeps
                    # the hot ones device-resident (was: arbitrary pop)
                    _CATALOG_CACHE.popitem(last=False)
                _CATALOG_CACHE[ckey] = ce
            # mark most-recently-used on hit AND on (re-)encode: a vocab-
            # overflow re-encode overwrites in place, which alone preserves
            # LRU position
            _CATALOG_CACHE.move_to_end(ckey)
        vocab = ce.vocab
        zone_key, captype_key = ce.zone_key, ce.captype_key
        it_enc, it_alloc, it_capacity = ce.it_enc, ce.it_alloc, ce.it_capacity
        it_price = ce.it_price
        off_zone, off_captype = ce.off_zone, ce.off_captype
        off_available, off_price = ce.off_available, ce.off_price
        zone_values, allow_undefined = ce.zone_values, ce.allow_undefined
        device_cache = ce.device_cache
        masked = self._drought_arrays(ce)
        if masked is not None:
            off_available, off_price, it_price, device_cache = masked

        ps = self.problem_state
        with TRACER.span("encode.groups", groups=G) as gsp:
            if ps is not None:
                # (_drought_arrays above already pinned this solve's registry
                # snapshot, so the warm-pack global token reads a stable view)
                self.encode_kind = ps.note_encode(vocab)
                g_rows = [ps.group_row(vocab, g) for g in groups]
                group_enc = enc.stack_encoded([r[0] for r in g_rows])
                group_req = np.stack([r[1] for r in g_rows])
                gsp.set(encoded=ps.last["group_rows_encoded"])
            else:
                group_enc = enc.stack_encoded(
                    [enc.encode_requirements(vocab, g.requirements)
                     for g in groups])
                group_req = np.stack(
                    [enc.encode_resource_vector(vocab, g.requests,
                                                capacity=False)
                     for g in groups])
        template_enc = enc.stack_encoded(
            [enc.encode_requirements(vocab, t.requirements) for t in templates])
        daemon = np.stack([
            enc.encode_resource_vector(vocab, _daemon_overhead(t, self.daemonset_pods),
                                       capacity=False)
            for t in templates])
        template_its = np.zeros((M, T), dtype=bool)
        for m, nct in enumerate(templates):
            for it in nct.instance_type_options:
                template_its[m, it_index[it.name]] = True

        # taints: host-checked per (group, template) and (group, existing node)
        tol_template = np.zeros((G, M), dtype=bool)
        for gi, g in enumerate(groups):
            probe = g.pods[0]
            for m, nct in enumerate(templates):
                tol_template[gi, m] = not scheduling_taints.tolerates(nct.taints, probe)

        min_its = self._min_its_floor(templates, groups)

        exist_enc = exist_avail = exist_zone = tol_exist = None
        exist_token = None
        if self.state_nodes and ps is not None:
            # persistent per-node rows: only dirty rows re-encode, and the
            # padded stack (plus its device upload, via exist_token) is
            # reused while the node set is unchanged
            with TRACER.span("encode.nodes",
                             nodes=len(self.state_nodes)) as nsp:
                (exist_enc, exist_avail, exist_zone, taint_lists,
                 exist_token) = ps.node_rows(vocab, zone_key,
                                             self.state_nodes,
                                             self.daemonset_pods)
                tol_exist = _tol_exist_matrix(groups, taint_lists,
                                              exist_enc.mask.shape[0])
                nsp.set(dirty=ps.last["node_rows_reencoded"])
                sd = ps.last.get("shard_dirty")
                if sd is not None:
                    # per-shard dirty-row counts, "shard:count" pairs —
                    # the sharded state's delta-residency trace signal
                    nsp.set(shard_dirty=",".join(
                        f"{s}:{d}" for s, d in sorted(sd.items())))
        elif self.state_nodes:
            with TRACER.span("encode.nodes",
                             nodes=len(self.state_nodes)) as nsp:
                exist_enc, exist_avail, exist_zone, tol_exist = \
                    self._cold_node_rows(vocab, zone_key, groups, nsp)

        group_count = np.array([g.count for g in groups], dtype=np.int64)
        if ps is not None:
            # group-axis pow2 bucket: steady-state churn nudges G every
            # pass; stable padded shapes keep the compiled-executable cache
            # hitting (the node axis is already bucketed). Padded rows are
            # empty-Requirements with zero requests — never packable, and
            # the packer only iterates the real G anyway.
            Gp = _pow2_bucket(G, 16)
            if Gp > G:
                pad = Gp - G
                zero = enc.encode_requirements(vocab, Requirements())
                group_enc = enc.pad_stacked(group_enc, Gp, zero)
                group_req = np.concatenate(
                    [group_req, np.zeros((pad,) + group_req.shape[1:],
                                         group_req.dtype)])
                group_count = np.concatenate(
                    [group_count, np.zeros(pad, np.int64)])
                tol_template = np.concatenate(
                    [tol_template, np.zeros((pad, M), bool)])
                if tol_exist is not None:
                    tol_exist = np.concatenate(
                        [tol_exist,
                         np.zeros((pad, tol_exist.shape[1]), bool)])

        problem = binpack.PackProblem(
            vocab=vocab, group_enc=group_enc, group_req=group_req,
            group_count=group_count,
            template_enc=template_enc, daemon_overhead=daemon,
            tol_template=tol_template, it_enc=it_enc, it_alloc=it_alloc,
            it_capacity=it_capacity, it_price=it_price, template_its=template_its,
            off_zone=off_zone, off_captype=off_captype, off_available=off_available,
            zone_key=zone_key, captype_key=captype_key, zone_values=zone_values,
            off_price=off_price,
            exist_enc=exist_enc, exist_avail=exist_avail, exist_zone=exist_zone,
            tol_exist=tol_exist, allow_undefined=allow_undefined,
            device_cache=device_cache, min_its=min_its,
            exist_token=exist_token,
            exist_shard_tokens=(ps.exist_shard_tokens
                                if ps is not None and exist_token is not None
                                else None))
        return problem, templates, catalog

    def _cold_node_rows(self, vocab, zone_key: int, groups, nsp):
        """State-node encode for the self-contained (no ProblemState) path,
        memoized per vocab identity; returns the pow2-padded
        (exist_enc, exist_avail, exist_zone, tol_exist). ``nsp`` (the
        ``encode.nodes`` span) gets the rows this call built: ``columnar``
        from the label table alone, ``per_node`` through a per-node step
        (the daemonset overhead check); both 0 on a memo hit, which hands
        out copies of the arrays the first call returned."""
        memo = self._exist_memo.get(id(vocab))
        if memo is None:
            N = len(self.state_nodes)
            # bucket the node-batch axis: padded rows have undefined masks
            # and zero capacity, so they are never packable (exist_cap < 1)
            (exist_enc, exist_avail, exist_zone, taint_lists,
             per_node) = encode_node_rows(
                vocab, zone_key, self.state_nodes, self.daemonset_pods,
                _pow2_bucket(N, 16), self._label_table())
            nsp.set(columnar=N - per_node, per_node=per_node)
            # the memo holds the vocab itself so its id() can never be
            # recycled by a new object while the entry is alive
            self._exist_memo[id(vocab)] = (vocab, exist_enc, exist_avail,
                                           exist_zone, taint_lists)
        else:
            nsp.set(columnar=0, per_node=0)
            _, exist_enc, exist_avail, exist_zone, taint_lists = memo
            exist_enc = enc.copy_encoded(exist_enc)
            exist_avail, exist_zone = exist_avail.copy(), exist_zone.copy()
        tol_exist = _tol_exist_matrix(groups, taint_lists,
                                      exist_zone.shape[0])
        return exist_enc, exist_avail, exist_zone, tol_exist

    def _label_table(self) -> enc.NodeLabelTable:
        if self._node_labels is None:
            self._node_labels = enc.NodeLabelTable(self.state_nodes)
        return self._node_labels

    def _drought_arrays(self, ce: _CatalogEncoding):
        """Registry-masked (off_available, off_price, it_price,
        device_cache) for this solve, or None when no live entry touches
        the catalog. The mask is built by matching the registry's live
        (instance_type, zone, capacity_type) patterns against the
        encoding's cached identity arrays in a few vectorized passes — a
        zone-wide drought is one [T, O] compare, not 16k Python checks.
        A fully masked type's it_price becomes +inf (the empty-offerings
        contract, types.go:117-134). The masked device upload is cached
        per live-pattern set so repeated solves under the same drought
        state stay as upload-free as the unmasked path."""
        from ..state.unavailable import WILDCARD
        reg = self.unavailable
        if reg is None:
            return None
        # pinned once per solve/pass (like _make_host): a disruption
        # snapshot builds MANY problems through this one scheduler, and a
        # TTL lapsing mid-pass must not price candidate sets of the same
        # decision under different masks — nor leave drought_patterns
        # disagreeing with the mask the recorded winner sim actually used
        if not self._drought_pinned:
            self.drought_patterns = reg.live()
            self._drought_pinned = True
        patterns = self.drought_patterns
        if not patterns:
            return None
        hit = np.zeros(ce.off_available.shape, dtype=bool)
        for pit, pz, pct in patterns:
            m = np.ones(ce.off_available.shape, dtype=bool)
            if pit != WILDCARD:
                m &= (ce.off_names == pit)[:, None]
            if pz != WILDCARD:
                m &= ce.off_zone_names == pz
            if pct != WILDCARD:
                m &= ce.off_ct_names == pct
            hit |= m
        hit &= ce.off_available
        if not hit.any():
            return None
        off_available = ce.off_available & ~hit
        off_price = np.where(off_available, ce.off_price,
                             np.inf).astype(np.float32)
        it_price = off_price.min(axis=1)
        slot = ce.device_cache.get("drought")
        if slot is None or slot[0] != patterns:
            slot = (patterns, {})
            ce.device_cache["drought"] = slot
        return off_available, off_price, it_price, slot[1]

    @staticmethod
    def _min_its_floor(templates, groups) -> Optional[np.ndarray]:
        """[M, G] int32 minValues floor on distinct instance types for each
        combined (template, group) requirement set (intersection takes the
        max of both sides' minValues, requirement.py:86), or None when no
        floor exists anywhere. The packer enforces it per fill — the tensor
        twin of the per-add SatisfiesMinValues gate. minValues on any OTHER
        key needs per-key distinct-value counting over the surviving set;
        that stays on the host oracle."""
        def floor_of(reqs) -> int:
            mv = 0
            for r in reqs.values():
                if r.min_values:
                    if r.key != api_labels.LABEL_INSTANCE_TYPE:
                        raise _FallbackError(
                            f"minValues on {r.key} needs host-side "
                            "distinct-value tracking")
                    mv = max(mv, r.min_values)
            return mv

        mv_t = [floor_of(nct.requirements) for nct in templates]
        mv_g = [floor_of(g.requirements) for g in groups]
        if not any(mv_t) and not any(mv_g):
            return None
        return np.maximum(np.array(mv_t, dtype=np.int32)[:, None],
                          np.array(mv_g, dtype=np.int32)[None, :])

    def _fits_vocab(self, vocab, templates, groups) -> bool:
        """True when this solve introduces NO new vocabulary entry — the
        cache-reuse condition: every key/value a fresh build would observe
        from templates, groups, and state nodes is already present, so the
        cached masks (incl. complement rows, which enumerate the value
        universe) stay exact."""
        def reqs_fit(reqs: Requirements) -> bool:
            for key in reqs:
                norm = api_labels.NORMALIZED_LABELS.get(key, key)
                k = vocab.key_idx.get(norm)
                if k is None:
                    return False
                vi = vocab.value_idx[k]
                for v in reqs.get(key).values:
                    if v not in vi:
                        return False
            return True

        for nct in templates:
            if not reqs_fit(nct.requirements):
                return False
        for g in groups:
            if not reqs_fit(g.requirements):
                return False
            if any(r not in vocab.resource_idx for r in g.requests):
                return False
        if not self.state_nodes:
            return True
        table = self._label_table()
        for key, values in table.values.items():
            k = vocab.key_idx.get(key)
            if k is None:
                continue  # node-only keys are never admitted (see below)
            vi = vocab.value_idx[k]
            if any(v not in vi for v in values):
                return False
        return all(r in vocab.resource_idx for r in table.resources)

    def _encode_catalog(self, catalog, templates, groups) -> _CatalogEncoding:
        """Fresh vocabulary + catalog-side tensors (the cacheable part of
        build_problem). Only COLD solves reach this — its span's absence is
        how a delta pass shows up in a trace."""
        with TRACER.span("encode.catalog", instance_types=len(catalog)):
            return self._encode_catalog_inner(catalog, templates, groups)

    def _encode_catalog_inner(self, catalog, templates, groups
                              ) -> _CatalogEncoding:
        vocab = enc.Vocab()
        zone_key = vocab.add_key(api_labels.LABEL_TOPOLOGY_ZONE)
        captype_key = vocab.add_key(api_labels.CAPACITY_TYPE_LABEL_KEY)
        for it in catalog:
            vocab.observe_requirements(it.requirements)
            vocab.observe_resources(it.capacity)
            for off in it.offerings:
                vocab.observe_requirements(off.requirements)
        for nct in templates:
            vocab.observe_requirements(nct.requirements)
        for g in groups:
            vocab.observe_requirements(g.requirements)
            vocab.observe_resources(g.requests)
        # Existing nodes only contribute VALUES for keys some group/template/
        # instance type already defines. A key defined solely by nodes (e.g.
        # kubernetes.io/hostname with one distinct value per node) can never
        # fail a compatibility check — the checked set is
        # a.defined & b.defined, and undefined-key violations only fire for
        # pod-side-defined keys (requirements.go:175-187) — so admitting it
        # would just blow the mask domain up to O(nodes) for nothing.
        # Each key's values go in in their first appearance over the nodes:
        # the order sets the bit positions, and the JAX package's
        # node-by-node walk adds them in that order.
        if self.state_nodes:
            table = self._label_table()
            for key, values in table.values.items():
                if key in vocab.key_idx:
                    for v in values:
                        vocab.add_value(key, v)
            vocab.observe_resources(table.resources)
        # power-of-two domain bucket: consolidation's prefix probes vary the
        # value counts per simulation; bucketing keeps mask shapes (and so
        # the jit cache) stable across probes
        vocab.freeze(domain_bucket=_pow2_bucket(vocab.D, 64))

        T = len(catalog)
        it_enc = enc.stack_encoded(
            [enc.encode_requirements(vocab, it.requirements) for it in catalog])
        it_alloc = np.stack([enc.encode_resource_vector(vocab, it.allocatable(), capacity=True)
                             for it in catalog])
        it_capacity = np.stack([enc.encode_resource_vector(vocab, it.capacity, capacity=True)
                                for it in catalog])
        O = max((len(it.offerings) for it in catalog), default=1)
        off_zone = np.full((T, O), -1, dtype=np.int32)
        off_captype = np.full((T, O), -1, dtype=np.int32)
        off_available = np.zeros((T, O), dtype=bool)
        off_price = np.full((T, O), np.inf, dtype=np.float32)
        it_price = np.full(T, np.inf, dtype=np.float32)
        off_names = np.array([it.name for it in catalog], dtype=object)
        off_zone_names = np.full((T, O), "", dtype=object)
        off_ct_names = np.full((T, O), "", dtype=object)
        for t, it in enumerate(catalog):
            for o, off in enumerate(it.offerings):
                if not off.available:
                    continue
                off_available[t, o] = True
                off_price[t, o] = off.price
                z = off.zone
                ct = off.capacity_type
                off_zone_names[t, o] = z
                off_ct_names[t, o] = ct
                if z:
                    off_zone[t, o] = vocab.value_idx[zone_key].get(z, -1)
                if ct:
                    off_captype[t, o] = vocab.value_idx[captype_key].get(ct, -1)
                it_price[t] = min(it_price[t], off.price)
        zone_values = np.arange(len(vocab.values[zone_key]), dtype=np.int32)
        allow_undefined = np.array([k in ALLOW_UNDEFINED_WELL_KNOWN
                                    for k in vocab.keys])
        return _CatalogEncoding(
            vocab=vocab, zone_key=zone_key, captype_key=captype_key,
            it_enc=it_enc, it_alloc=it_alloc, it_capacity=it_capacity,
            it_price=it_price, off_zone=off_zone, off_captype=off_captype,
            off_available=off_available, off_price=off_price,
            zone_values=zone_values, allow_undefined=allow_undefined,
            device_cache={}, off_names=off_names,
            off_zone_names=off_zone_names, off_ct_names=off_ct_names)

    def cluster_topology_counts(self, groups: List[PodGroup], zone_names,
                                exclude_uids):
        """The tensor twin of Topology countDomains (topology.go:268-321):
        initial domain occupancy from scheduled cluster pods matching each
        group's topology selectors, excluding the batch itself. Returns
        (izc [G, Z] per-zone counts for the group's zone-level constraint,
        exist_counts [G, N] per-packable-node counts for its hostname-level
        constraint, host_total [G] total hostname-level matches anywhere
        with a known node — the affinity no-bootstrap signal). The spread
        node filter (topologynodefilter.go) applies to spread constraints
        only; affinity groups count every matching pod."""
        from .grouping import HOST_KINDS, SPREAD_HOST, SPREAD_ZONE, ZONE_KINDS
        from .topology import TopologyNodeFilter, ignored_for_topology

        zone_idx = {z: i for i, z in enumerate(zone_names)}
        node_idx = {sn.name(): i for i, sn in enumerate(self.state_nodes)}
        G = len(groups)
        izc = np.zeros((G, len(zone_names)), dtype=np.int64)
        exist_counts = np.zeros((G, max(1, len(self.state_nodes))),
                                dtype=np.int64)
        host_total = np.zeros(G, dtype=np.int64)

        # the flagship two-constraint combo reuses one selector for both
        # specs: memoize list_pods per (namespace, selector shape) and
        # node_labels per node within the call
        def sel_key(namespace: str, sel) -> tuple:
            # LabelSelector normalizes match_labels to a tuple of pairs
            ml = getattr(sel, "match_labels", None) or ()
            if hasattr(ml, "items"):
                ml = tuple(sorted(ml.items()))
            me = getattr(sel, "match_expressions", None) or ()
            try:
                return (namespace, tuple(sorted(ml)), tuple(me))
            except TypeError:
                return (namespace, id(sel))

        pods_memo: dict = {}
        labels_memo: dict = {}

        def matched(namespace: str, sel):
            k = sel_key(namespace, sel)
            out = pods_memo.get(k)
            if out is None:
                out = []
                for p in self.cluster.list_pods(namespace, sel):
                    if p.uid in exclude_uids or ignored_for_topology(p):
                        continue
                    name = p.spec.node_name
                    if name not in labels_memo:
                        labels_memo[name] = self.cluster.node_labels(name)
                    if labels_memo[name] is not None:
                        out.append(p)
                pods_memo[k] = out
            return out

        for gi, g in enumerate(groups):
            # prefix probes can empty a group (all its pods belong to
            # non-prefix candidates); nothing pending means nothing to place
            if not g.topo or not g.pods:
                continue
            probe = g.pods[0]
            spread_filter = TopologyNodeFilter.for_pod(probe)
            for spec in g.topo:
                if spec.selector is None:
                    continue  # a nil selector selects nothing
                is_spread = spec.kind in (SPREAD_ZONE, SPREAD_HOST)
                for p in matched(probe.namespace, spec.selector):
                    labels = labels_memo[p.spec.node_name]
                    if is_spread and not spread_filter.matches_labels(labels):
                        continue
                    if spec.kind in ZONE_KINDS:
                        zone = labels.get(api_labels.LABEL_TOPOLOGY_ZONE)
                        if zone in zone_idx:
                            izc[gi, zone_idx[zone]] += 1
                    elif spec.kind in HOST_KINDS:
                        host_total[gi] += 1
                        n = node_idx.get(p.spec.node_name)
                        if n is not None:
                            exist_counts[gi, n] += 1
        return izc, exist_counts, host_total

    def _tensor_solve(self, groups: List[PodGroup], pods: List[Pod]) -> Results:
        self.fallback_reason = ""
        if any(p.spec.host_ports for p in self.daemonset_pods) and any(
                p.spec.host_ports for p in pods):
            # daemonset ports occupy EVERY node of a template; modeling
            # that per-template exclusion stays host-side (rare combo).
            # Checked against PODS, not groups: a batch-unique port pod
            # carries group.host_ports=() yet still binds its port — it
            # must not slip past this guard onto a daemonset's port
            raise _FallbackError(
                "daemonset host ports need per-pod conflict tracking")
        problem, templates, catalog = self.build_problem(groups)
        vocab = problem.vocab
        zone_key = problem.zone_key

        ps = self.problem_state
        with TRACER.span("precompute") as pcs:
            # persistent tensors memo (sharded-state churn fast path): the
            # device kernel's group side reads nothing that changes on a
            # pure count-wobble/node-churn pass, and the exist side feeds
            # ONLY exist_ok/exist_cap — so a group-part hit with a dirty
            # exist part runs the exist-only delta kernel (bit-identical
            # ops to the full kernel's exist branch) and splices the pair
            tensors = None
            memo_tok = None
            if ps is not None:
                memo_tok = (
                    (vocab, tuple(ps.sig(g) for g in groups), len(groups),
                     ps._daemon_token(self.daemonset_pods),
                     ps._templates_token(templates),
                     tuple(self.drought_patterns),
                     None if problem.min_its is None
                     else problem.min_its.tobytes(),
                     zone_key, problem.captype_key),
                    problem.exist_token)
                memo = ps.tensors_memo
                if memo is not None and memo[0] == memo_tok:
                    tensors = memo[1]
                    ps.last["precompute"] = "reused"
                elif (memo is not None and memo[0][0] == memo_tok[0]
                      and memo_tok[1] is not None
                      and problem.exist_enc is not None):
                    import dataclasses
                    exist_ok, exist_cap = binpack.exist_delta(
                        problem, device=self.device)
                    tensors = dataclasses.replace(
                        memo[1], exist_ok=exist_ok, exist_cap=exist_cap)
                    ps.last["precompute"] = "delta"
            if tensors is None:
                tensors = self.precompute(problem)
                if ps is not None:
                    ps.last["precompute"] = "computed"
            if ps is not None:
                ps.tensors_memo = (memo_tok, tensors)
                pcs.set(reused=ps.last["precompute"])

        Z = len(problem.zone_values)
        zone_names = vocab.values[zone_key]
        exist_counts = host_total = None
        with TRACER.span("topo.counts", groups=len(groups)) as tsp:
            if self.initial_zone_counts is not None:
                izc = np.zeros((len(groups), Z), dtype=np.int64)
                for gi, g in enumerate(groups):
                    counts = self.initial_zone_counts(g, zone_names)
                    for z, cnt in enumerate(counts):
                        izc[gi, z] = cnt
            elif self.problem_state is not None:
                # per-group counts memoized against Cluster.topo_revision:
                # the scheduled-pod selector scans run only for groups the
                # revision can no longer vouch for
                izc, exist_counts, host_total = \
                    self.problem_state.topology_counts(self, groups,
                                                       zone_names, pods)
                tsp.set(counted=self.problem_state.last[
                    "topo_groups_counted"])
            else:
                # default: count scheduled cluster pods matching each
                # group's topology selectors so a deployment scale-up
                # spreads against its existing replicas exactly like the
                # host path does
                izc, exist_counts, host_total = self.cluster_topology_counts(
                    groups, zone_names, {p.uid for p in pods})

        # the pack's inputs from the cluster: the nodepools' remaining
        # limits, the existing nodes' order, their volume and port state
        with TRACER.span("pack.inputs", nodes=len(self.state_nodes)):
            # nodepool limits (scaled), minus existing node capacity per pool
            limits: List[Optional[dict]] = []
            for nct in templates:
                np_obj = next(p for p in self.nodepools if p.name == nct.nodepool_name)
                if not np_obj.spec.limits:
                    limits.append(None)
                    continue
                rem = dict(np_obj.spec.limits)
                for sn in self.state_nodes:
                    if sn.labels().get(api_labels.NODEPOOL_LABEL_KEY) == nct.nodepool_name:
                        rem = res.subtract(rem, sn.capacity())
                limits.append({k: enc.scale_capacity(k, v) for k, v in rem.items()})
            limit_resources = sorted({k for lm in limits if lm for k in lm})
            sn_order = sorted(range(len(self.state_nodes)),
                              key=lambda i: (not self.state_nodes[i].initialized(),
                                             self.state_nodes[i].name()))
            if exist_counts is not None:
                exist_counts = pad_exist_counts(problem, exist_counts)
            vol_group_counts, vol_node_remaining = \
                self._volume_limit_state(groups)
            group_ports = None
            exist_port_block = None
            if any(g.host_ports for g in groups):
                group_ports = [g.host_ports for g in groups]
                if self.state_nodes:
                    # indexed by the problem's exist-node order (= state_nodes
                    # position, the space _fill_existing's node_caps[n] uses)
                    exist_port_block = np.zeros(
                        (len(groups), len(self.state_nodes)), dtype=bool)
                    for gi, gp in enumerate(group_ports):
                        if not gp:
                            continue
                        for ni, sn in enumerate(self.state_nodes):
                            exist_port_block[gi, ni] = \
                                sn.host_port_usage().conflicts_triples(gp)
        warm = None
        if self.problem_state is not None:
            warm = self.problem_state.warm_start(
                self, vocab, groups, templates, limits,
                izc, exist_counts, host_total, problem.exist_token)
        with TRACER.span("pack", groups=len(groups)) as psp:
            packer = binpack.Packer(problem, tensors, groups, limits,
                                    limit_resources,
                                    initial_zone_counts=izc,
                                    exist_order=sn_order,
                                    exist_counts=exist_counts,
                                    host_match_total=host_total,
                                    vol_group_counts=vol_group_counts,
                                    vol_node_remaining=vol_node_remaining,
                                    group_ports=group_ports,
                                    exist_port_block=exist_port_block,
                                    warm=warm)
            pr = packer.pack()
            psp.set(existing_ms=packer.existing_ms,
                    existing_scanned=packer.existing_scanned)
            if self.problem_state is not None:
                self.problem_state.finish_pack(warm)
                psp.set(warm=self.problem_state.last["warm"],
                        warm_restored=self.problem_state.last[
                            "warm_restored"])
        with TRACER.span("materialize"):
            return self._materialize(pr, problem, groups, templates, catalog,
                                     vocab, zone_key)

    def _volume_limit_state(self, groups):
        """CSI attach-limit inputs for the packer's existing-node pass
        (volumeusage.go:187-220 linearized). Groups reaching the tensor path
        carry only EPHEMERAL volumes (grouping demotes the rest), so each
        pod consumes {driver: count} fresh attach slots on its node.
        Returns (vol_group_counts[g] = {driver: per-pod claims} | None,
        vol_node_remaining[n] = {driver: remaining slots} for limited
        drivers | None). Resolution order mirrors the host oracle: a wire
        pre-resolution rider when present, else the store reachable through
        the cluster view; unresolvable volumes impose no limits, exactly as
        a missing CSINode imposes none (volumeusage.go:187-199)."""
        vol_gis = [gi for gi, g in enumerate(groups)
                   if g.pods and g.pods[0].spec.volumes]
        if not vol_gis or not self.state_nodes:
            return None, None
        store = getattr(self.cluster, "store", None)
        group_counts: List[Optional[dict]] = [None] * len(groups)
        any_counts = False
        for gi in vol_gis:
            probe = groups[gi].pods[0]
            counts = getattr(probe.spec, "_volume_drivers", None)
            if counts is None and store is not None:
                from ..scheduling.volumeusage import get_volumes
                counts = {d: len(keys)
                          for d, keys in get_volumes(store, probe).items()}
            if counts:
                group_counts[gi] = dict(counts)
                any_counts = True
        if not any_counts:
            return None, None
        remaining: List[Optional[dict]] = []
        for sn in self.state_nodes:
            limits = getattr(sn, "volume_limits", None)
            if limits is None and store is not None:
                from ..scheduling.volumeusage import node_volume_limits
                limits = node_volume_limits(store, sn.name())
            limits = {d: lm for d, lm in (limits or {}).items()
                      if lm is not None}
            if not limits:
                remaining.append(None)
                continue
            used = getattr(sn, "volume_used", None)
            if used is None:
                vu = getattr(sn, "volume_usage", None)
                used = ({d: len(s) for d, s in vu().volumes.items()}
                        if vu is not None else {})
            remaining.append({d: max(0, lm - used.get(d, 0))
                              for d, lm in limits.items()})
        if all(r is None for r in remaining):
            return None, None
        return group_counts, remaining

    @staticmethod
    def _cohort_price_order(problem, it_set: np.ndarray, enc_mask: np.ndarray,
                            it_names: np.ndarray) -> np.ndarray:
        """Surviving instance types of a cohort ordered by cheapest admitted
        offering with name tiebreak — the vectorized OrderByPrice
        (types.go:117-134): an offering counts when available and its
        zone/captype value is admitted by the cohort's accumulated
        requirement mask (a [K, W] row of the pack's CohortSet)."""
        t_idx = np.where(it_set)[0]
        if t_idx.size == 0:
            return t_idx

        def admits(key: int, vals: np.ndarray) -> np.ndarray:
            mask = enc_mask[key]                           # [W] uint32
            word = np.where(vals >= 0, vals // 32, 0)
            bit = np.where(vals >= 0, vals % 32, 0).astype(np.uint32)
            has = (mask[word] >> bit) & np.uint32(1)
            return np.where(vals >= 0, has == 1, True)

        off_zone = problem.off_zone[t_idx]
        off_cap = problem.off_captype[t_idx]
        ok = (problem.off_available[t_idx]
              & admits(problem.zone_key, off_zone)
              & admits(problem.captype_key, off_cap))
        price = np.where(ok, problem.off_price[t_idx], np.inf).min(axis=1)
        # lexsort: price primary, name tiebreak (types.go:128-130)
        return t_idx[np.lexsort((it_names[t_idx], price))]

    def _materialize(self, pr: binpack.PackResult, problem, groups, templates,
                     catalog, vocab, zone_key) -> Results:
        # hand out pod objects per group in order
        cursors = [0] * len(groups)

        def take(g: int, n: int) -> List[Pod]:
            out = groups[g].pods[cursors[g]:cursors[g] + n]
            cursors[g] += n
            return out

        new_claims: List[TensorNodeClaim] = []
        it_names = np.array([it.name for it in catalog])
        # cohorts from one solve overwhelmingly share (it_set, zone/captype
        # admission) — memoize the ordering per distinct key
        order_cache: dict = {}
        cs = pr.cohorts  # the packer's columnar CohortSet
        for ci in range(cs.C if cs is not None else 0):
            it_set = cs.it_set[ci]
            enc_mask = cs.enc_mask[ci]
            okey = (it_set.tobytes(),
                    enc_mask[problem.zone_key].tobytes(),
                    enc_mask[problem.captype_key].tobytes())
            ordered = order_cache.get(okey)
            if ordered is None:
                ordered = [catalog[t]
                           for t in self._cohort_price_order(
                               problem, it_set, enc_mask, it_names)]
                order_cache[okey] = ordered
            m = int(cs.m[ci])
            pods_by_group = cs.pods_by_group[ci]
            base_reqs = templates[m].requirements.copy()
            for g in pods_by_group:
                base_reqs.add(*groups[g].requirements.values())
            zi = int(cs.zone[ci])
            if zi >= 0:
                zone_name = vocab.values[zone_key][zi]
                base_reqs.add(Requirement(api_labels.LABEL_TOPOLOGY_ZONE, IN,
                                          [zone_name]))
            # all pods of a group are identical: node requests = per-pod
            # requests scaled by fill (no per-pod re-merge), plus the
            # template's daemonset overhead — the claim's recorded resources
            # must match what the node will actually host
            # (scheduler.go:356-382; the packer already budgeted for it)
            requests: dict = dict(
                _daemon_overhead(templates[m], self.daemonset_pods))
            for g, fill in pods_by_group.items():
                for rname, v in groups[g].requests.items():
                    requests[rname] = requests.get(rname, 0) + v * fill
            for _ in range(int(cs.n[ci])):
                reqs = base_reqs.copy()
                pods: List[Pod] = []
                for g, fill in pods_by_group.items():
                    pods.extend(take(g, fill))
                tnc = TensorNodeClaim(
                    templates[m], reqs, ordered, pods, dict(requests))
                # sibling claims of one cohort differ only in their pods —
                # the sidecar result codec interns the claim shape by this
                # id so n identical nodes encode once (codec.py
                # encode_solve_response_rows)
                tnc.cohort_id = ci
                new_claims.append(tnc)
        existing: List[TensorExistingNode] = []
        for n, fills in pr.existing.items():
            pods = []
            for g, fill in fills:
                pods.extend(take(g, fill))
            existing.append(TensorExistingNode(self.state_nodes[n], pods))
        errors = dict(pr.errors)
        if errors:
            self._explain_errors(errors, groups, templates)
        return Results(new_nodeclaims=new_claims, existing_nodes=existing,
                       pod_errors=errors,
                       limit_constrained=pr.limit_constrained)


class _FallbackError(Exception):
    pass


def pad_exist_counts(problem, exist_counts: np.ndarray) -> np.ndarray:
    """Align [G, N] matching-pod counts with the packer's (pow2-padded)
    existing-node axis; padded rows are unpackable anyway (zero capacity)."""
    Np = (problem.exist_avail.shape[0]
          if problem.exist_avail is not None else 0)
    if exist_counts.shape[1] < max(Np, 1):
        exist_counts = np.pad(
            exist_counts, ((0, 0), (0, max(Np, 1) - exist_counts.shape[1])))
    return exist_counts


def _tol_exist_matrix(groups, taint_lists, total_cols: int) -> np.ndarray:
    """[G, total_cols] group x existing-node toleration matrix — THE one
    construction both the cold and delta encode paths share (a divergence
    would break the delta path's bit-identical contract). True = the
    group's probe pod tolerates node i's taints (tolerates() returns the
    error list, so untainted nodes default True); columns past
    len(taint_lists) are pow2 padding and stay False (never packable)."""
    G = len(groups)
    out = np.zeros((G, total_cols), dtype=bool)
    out[:, :len(taint_lists)] = True
    for i, nt in enumerate(taint_lists):
        if not nt:
            continue
        for gi, g in enumerate(groups):
            out[gi, i] = not scheduling_taints.tolerates(nt, g.pods[0])
    return out


def encode_node_rows(vocab, zone_key: int, state_nodes, daemonset_pods,
                     total: int, table=None) -> tuple:
    """(exist_enc, exist_avail, exist_zone, taint_lists, per_node): the
    state nodes' rows padded to ``total`` — THE one construction of the
    cold path and the plane's dirty rows (state/plane.py), so the two stay
    byte-identical. The requirement rows come from the nodes' label table
    (``table``, built here when not given); only the daemonset overhead
    takes a per-node step, and only with daemonset pods to place:
    ``per_node`` counts those nodes. taint_lists covers the real nodes."""
    if table is None:
        table = enc.NodeLabelTable(state_nodes)
    exist_enc = enc.encode_node_labels(vocab, table, total)
    avails = []
    for sn in state_nodes:
        avail = sn.available()
        overhead = _node_remaining_daemons(sn, daemonset_pods)
        avails.append(res.subtract(avail, overhead) if overhead else avail)
    exist_avail = enc.encode_capacity_rows(vocab, avails, total)
    vi = vocab.value_idx[zone_key]
    exist_zone = np.full(total, -1, dtype=np.int32)
    exist_zone[:table.n] = [vi.get(z, -1) for z in table.zones]
    taint_lists = [sn.taints() for sn in state_nodes]
    per_node = len(state_nodes) if daemonset_pods else 0
    return exist_enc, exist_avail, exist_zone, taint_lists, per_node


def _node_remaining_daemons(sn, daemonset_pods) -> dict:
    """Remaining daemonset overhead a node must still absorb
    (existingnode.go:44-54). With no daemonset pod to place it is the
    clamp of minus what the node's daemonset pods request, and the node's
    requirements are not built."""
    if not daemonset_pods:
        return {k: max(-v, 0) for k, v in sn.daemonset_requests().items()}
    from ..scheduling.requirements import pod_requirements as preqs
    daemons = []
    node_taints = sn.taints()
    node_reqs = label_requirements(sn.labels())
    for p in daemonset_pods:
        if scheduling_taints.tolerates(node_taints, p):
            continue
        if node_reqs.compatible(preqs(p)):
            continue
        daemons.append(p)
    total = res.merge(*(p.requests() for p in daemons)) if daemons else {}
    remaining = res.subtract(total, sn.daemonset_requests())
    return {k: max(v, 0) for k, v in remaining.items()}
