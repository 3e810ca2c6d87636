"""Prometheus-style metrics registry.

Mirrors the metric families of karpenter's pkg/metrics/metrics.go (the
karpenter_ namespace counters for nodeclaims/nodes/pods) plus the solver
timing metrics (provisioning/scheduling/metrics.go:39-94, disruption/
metrics.go:44-85), with text exposition for scraping.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

NAMESPACE = "karpenter"


def _label_key(labels: dict) -> Tuple:
    return tuple(sorted(labels.items()))


def _count_series_drop(metric_name: str) -> None:
    # SERIES_DROPPED is defined at module bottom (it needs REGISTRY); it is
    # itself uncapped, so this can never recurse
    sd = globals().get("SERIES_DROPPED")
    if sd is not None:
        sd.inc({"metric": metric_name})


class Metric:
    def __init__(self, name: str, help: str, label_names: Iterable[str] = (),
                 max_series: int = 0):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        # cardinality cap (0 = unbounded): a pathological label mix (one
        # series per pod uid, per dynamic phase name, ...) must not grow
        # the registry without bound — new series past the cap are dropped
        # and counted on karpenter_metrics_series_dropped_total{metric}
        self.max_series = max_series
        self._values: Dict[Tuple, float] = {}

    def _admit(self, container: dict, k: Tuple) -> bool:
        if not self.max_series or k in container \
                or len(container) < self.max_series:
            return True
        _count_series_drop(self.name)
        return False

    def labels_dict(self, key: Tuple) -> dict:
        return dict(key)


class Counter(Metric):
    kind = "counter"

    def inc(self, labels: Optional[dict] = None, value: float = 1.0) -> None:
        k = _label_key(labels or {})
        if not self._admit(self._values, k):
            return
        self._values[k] = self._values.get(k, 0.0) + value

    def value(self, labels: Optional[dict] = None) -> float:
        return self._values.get(_label_key(labels or {}), 0.0)


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, labels: Optional[dict] = None) -> None:
        k = _label_key(labels or {})
        if not self._admit(self._values, k):
            return
        self._values[k] = value

    def delete(self, labels: Optional[dict] = None) -> None:
        self._values.pop(_label_key(labels or {}), None)

    def prune(self, live: "list[dict]") -> None:
        """Drop every series not in `live` — exporters that mirror object
        state call this so deleted objects' series disappear instead of
        freezing at their last value (and cardinality stays bounded)."""
        keep = {_label_key(d) for d in live}
        for k in [k for k in self._values if k not in keep]:
            del self._values[k]

    def value(self, labels: Optional[dict] = None) -> float:
        return self._values.get(_label_key(labels or {}), 0.0)


class Histogram(Metric):
    kind = "histogram"
    DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                       1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

    def __init__(self, name, help, label_names=(), buckets=None,
                 max_series: int = 0):
        super().__init__(name, help, label_names, max_series=max_series)
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}

    def observe(self, value: float, labels: Optional[dict] = None) -> None:
        k = _label_key(labels or {})
        if not self._admit(self._counts, k):
            return
        counts = self._counts.setdefault(k, [0] * (len(self.buckets) + 1))
        for i, b in enumerate(self.buckets):
            if value <= b:
                counts[i] += 1
        counts[-1] += 1  # +Inf
        self._sums[k] = self._sums.get(k, 0.0) + value

    def count(self, labels: Optional[dict] = None) -> int:
        k = _label_key(labels or {})
        return self._counts.get(k, [0])[-1]

    def sum(self, labels: Optional[dict] = None) -> float:
        return self._sums.get(_label_key(labels or {}), 0.0)


class Registry:
    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()
        # measure() duration clock, injectable (the set_condition_clock
        # pattern): fake-clock tests assert exact bucket placement instead
        # of sleeping
        self._measure_clock = time.perf_counter

    def set_measure_clock(self, now) -> "Callable[[], float]":
        """Swap the measure() timing clock; returns the previous one so
        tests can restore it."""
        prev = self._measure_clock
        self._measure_clock = now
        return prev

    def counter(self, name: str, help: str = "", label_names=(),
                max_series: int = 0) -> Counter:
        return self._register(Counter, name, help, label_names, max_series)

    def gauge(self, name: str, help: str = "", label_names=(),
              max_series: int = 0) -> Gauge:
        return self._register(Gauge, name, help, label_names, max_series)

    def histogram(self, name: str, help: str = "", label_names=(),
                  buckets=None, max_series: int = 0) -> Histogram:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Histogram(name, help, label_names, buckets,
                              max_series=max_series)
                self._metrics[name] = m
            return m

    def _register(self, cls, name, help, label_names, max_series=0):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, label_names, max_series=max_series)
                self._metrics[name] = m
            return m

    def measure(self, histogram_name: str, labels: Optional[dict] = None):
        """metrics.Measure() duration helper (metrics.go:88-96), timed on
        the injectable measure clock."""
        h = self.histogram(histogram_name)
        start = self._measure_clock()

        def done():
            h.observe(self._measure_clock() - start, labels)

        return done

    # -- exposition ---------------------------------------------------------

    def expose(self) -> str:
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                for k, counts in m._counts.items():
                    lbl = dict(k)
                    cum = 0
                    for b, c in zip(m.buckets, counts[:-1]):
                        cum = c
                        lines.append(_line(f"{name}_bucket",
                                           {**lbl, "le": _fmt(b)}, cum))
                    lines.append(_line(f"{name}_bucket",
                                       {**lbl, "le": "+Inf"}, counts[-1]))
                    lines.append(_line(f"{name}_sum", lbl, m._sums.get(k, 0.0)))
                    lines.append(_line(f"{name}_count", lbl, counts[-1]))
            else:
                for k, v in m._values.items():
                    lines.append(_line(name, dict(k), v))
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    return repr(v) if not math.isinf(v) else "+Inf"


def _escape(v) -> str:
    """Prometheus text-format label-value escaping (exposition format spec:
    backslash, double-quote, and line feed must be escaped)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _line(name: str, labels: dict, value) -> str:
    if labels:
        body = ",".join(f'{k}="{_escape(v)}"'
                        for k, v in sorted(labels.items()))
        return f"{name}{{{body}}} {value}"
    return f"{name} {value}"


REGISTRY = Registry()

# -- metric families mirrored from the reference ---------------------------

NODECLAIMS_CREATED = REGISTRY.counter(
    "karpenter_nodeclaims_created_total",
    "Number of nodeclaims created", ("nodepool",))
NODECLAIMS_TERMINATED = REGISTRY.counter(
    "karpenter_nodeclaims_terminated_total",
    "Number of nodeclaims terminated", ("nodepool",))
NODECLAIMS_DISRUPTED = REGISTRY.counter(
    "karpenter_nodeclaims_disrupted_total",
    "Number of nodeclaims disrupted", ("nodepool", "reason"))
NODES_CREATED = REGISTRY.counter(
    "karpenter_nodes_created_total", "Number of nodes created", ("nodepool",))
NODES_TERMINATED = REGISTRY.counter(
    "karpenter_nodes_terminated_total", "Number of nodes terminated",
    ("nodepool",))
NODE_TERMINATION_DURATION = REGISTRY.histogram(
    "karpenter_nodes_termination_duration_seconds",
    "Deletion-timestamp to finalizer removal (drain + detach + instance)",
    ("nodepool",),
    buckets=(1, 5, 10, 30, 60, 120, 300, 600, 1800, 3600))
NODE_LIFETIME_DURATION = REGISTRY.histogram(
    "karpenter_nodes_lifetime_duration_seconds",
    "Node creation to termination",
    ("nodepool",),
    buckets=(60, 300, 1800, 3600, 6 * 3600, 24 * 3600, 7 * 24 * 3600))
PODS_STARTUP_DURATION = REGISTRY.histogram(
    "karpenter_pods_startup_duration_seconds",
    "Time from pod creation to running")
SCHEDULING_DURATION = REGISTRY.histogram(
    "karpenter_provisioner_scheduling_duration_seconds",
    "Duration of one scheduling solve")
SCHEDULING_QUEUE_DEPTH = REGISTRY.gauge(
    "karpenter_provisioner_scheduling_queue_depth",
    "Pending pods in the scheduling queue")
UNSCHEDULABLE_PODS = REGISTRY.gauge(
    "karpenter_ignored_pod_count", "Pods the solver could not place")
DISRUPTION_EVAL_DURATION = REGISTRY.histogram(
    "karpenter_voluntary_disruption_decision_evaluation_duration_seconds",
    "Duration of disruption decision evaluation", ("method",))
DISRUPTION_DECISIONS = REGISTRY.counter(
    "karpenter_voluntary_disruption_decisions_total",
    "Disruption decisions made", ("decision", "reason", "consolidation_type"))
DISRUPTION_ELIGIBLE_NODES = REGISTRY.gauge(
    "karpenter_voluntary_disruption_eligible_nodes",
    "Nodes eligible for disruption", ("reason",))
CONSOLIDATION_TIMEOUTS = REGISTRY.counter(
    "karpenter_voluntary_disruption_consolidation_timeouts_total",
    "Consolidation searches abandoned at their timeout",
    ("consolidation_type",))
# -- streaming disruption engine: cross-pass delta residency ----

DISRUPTION_STREAM_LAYERS = REGISTRY.counter(
    "karpenter_disruption_stream_reuse_total",
    "Streaming-snapshot layer outcomes per disruption pass",
    ("layer", "outcome"))
DISRUPTION_STREAM_ROWS = REGISTRY.counter(
    "karpenter_disruption_candidate_rows_total",
    "Cached candidate-row outcomes per disruption pass", ("outcome",))
DISRUPTION_CANDIDATE_BUILD = REGISTRY.histogram(
    "karpenter_disruption_candidate_build_seconds",
    "Wall clock of the streaming candidate/snapshot refresh per pass")
DISRUPTION_SUBSET_VERDICTS = REGISTRY.counter(
    "karpenter_disruption_subset_verdicts_total",
    "Closed-form multi-node subset verdicts (ranked prefix search)",
    ("kind",))

NODEPOOL_USAGE = REGISTRY.gauge(
    "karpenter_nodepools_usage", "In-use resources per nodepool",
    ("nodepool", "resource_type"))
NODEPOOL_LIMIT = REGISTRY.gauge(
    "karpenter_nodepools_limit", "Resource limits per nodepool",
    ("nodepool", "resource_type"))

# -- fault-tolerant runtime (controller-runtime's
# controller_runtime_reconcile_errors_total analog plus the quarantine /
# circuit-breaker state this runtime adds on top) -------------------------

RECONCILE_ERRORS = REGISTRY.counter(
    "karpenter_reconcile_errors_total",
    "Reconcile invocations that raised, per controller", ("controller",))
RECONCILE_QUARANTINED = REGISTRY.gauge(
    "karpenter_reconcile_quarantined",
    "Work items quarantined in the dead-letter set after exhausting "
    "retries", ("controller",))
EVENTS_DROPPED = REGISTRY.counter(
    "karpenter_events_dropped_total",
    "Events dropped by best-effort delivery", ("reason",))
SOLVER_CIRCUIT_STATE = REGISTRY.gauge(
    "karpenter_solver_circuit_state",
    "Tensor-solver circuit breaker state (0=closed, 1=open, 2=half-open)")
SOLVER_COMPILE_CACHE_HITS = REGISTRY.counter(
    "karpenter_solver_compile_cache_hits_total",
    "Feasibility-precompute solves served by an already-compiled "
    "executable for their padded shape bucket")
SOLVER_COMPILE_CACHE_MISSES = REGISTRY.counter(
    "karpenter_solver_compile_cache_misses_total",
    "Feasibility-precompute solves that had to compile a fresh executable "
    "for a new padded shape bucket")
OFFERINGS_UNAVAILABLE = REGISTRY.gauge(
    "karpenter_offerings_unavailable",
    "Offering keys currently cached as unavailable (TTL live) in the "
    "capacity-failure feedback registry")
OFFERINGS_MARKED = REGISTRY.counter(
    "karpenter_offerings_marked_total",
    "Offering keys marked unavailable by capacity failures", ("reason",))
NODECLAIMS_LIVENESS_TERMINATED = REGISTRY.counter(
    "karpenter_nodeclaims_liveness_terminated_total",
    "NodeClaims deleted because they failed to register within the "
    "liveness TTL", ("nodepool",))
FLIGHTREC_RECORDS = REGISTRY.counter(
    "karpenter_flightrecorder_records_total",
    "Decision records captured by the flight recorder", ("kind",))
FLIGHTREC_DROPPED = REGISTRY.counter(
    "karpenter_flightrecorder_dropped_total",
    "Decision records dropped (ring eviction or capture failure)",
    ("reason",))
PROBLEM_STATE_SHARD_ROWS = REGISTRY.counter(
    "karpenter_problem_state_shard_rows_total",
    "Existing-node rows handled per mesh shard of the sharded "
    "ProblemState, by outcome: reencoded/clean at encode time, "
    "uploaded/upload_skipped at device-placement time",
    ("shard", "outcome"), max_series=256)
STATE_PLANE_SUBSCRIBERS = REGISTRY.gauge(
    "karpenter_state_plane_subscribers",
    "Live subscriber handles per shared EncodePlane (state/plane.py); "
    "pruned to the live-plane set on every refresh",
    ("plane",), max_series=256)
STATE_PLANE_ROWS = REGISTRY.counter(
    "karpenter_state_plane_rows_total",
    "Node/group rows served by the shared EncodePlane per subscriber, "
    "by outcome: shared (cache hit, possibly encoded by another "
    "subscriber) vs reencoded",
    ("subscriber", "outcome"), max_series=256)
STATE_AUDIT = REGISTRY.counter(
    "karpenter_state_audit_total",
    "Warm-state integrity audits (state/audit.py StateAuditor) by cache "
    "layer and outcome: audited (shadow re-encode / digest verify "
    "matched) vs corrupt (mismatch -> the layer quarantined to a cold "
    "rebuild for the pass). layer=device carries the mesh degradation "
    "ladder: killed (device lost mid-dispatch), carve/single (the pass "
    "completed on a degraded rung), readmitted (half-open probe "
    "succeeded and the breaker re-closed)",
    ("layer", "outcome"), max_series=64)
EXIST_SPLICE_BYTES = REGISTRY.counter(
    "karpenter_exist_splice_bytes_total",
    "Exist-side per-shard delta placement bytes, by outcome: uploaded "
    "(dirty spans spliced host->device) vs skipped (clean spans left "
    "resident in the donated device buffer)",
    ("outcome",), max_series=4)

def phase_seconds_by_name() -> Dict[str, float]:
    """Total observed seconds per phase (span name) across every label
    combination of karpenter_solver_phase_duration_seconds — the sim
    report's per-subsystem attribution source (snapshot at run start,
    delta at the end)."""
    out: Dict[str, float] = {}
    # list() snapshot: solver threads may observe new series mid-iteration
    for k, s in list(SOLVER_PHASE_DURATION._sums.items()):
        phase = dict(k).get("phase", "")
        out[phase] = out.get(phase, 0.0) + s
    return out


# -- bounded tenant label ---------------------------------------------------
# The sidecar serves many tenant clusters from one process; tenant-labeled
# series (queue depth/wait, phase histograms) must stay bounded no matter
# what tenant names clients send. First-come tenants keep their name; past
# the cap every new tenant maps to the shared overflow value, so a
# tenant-per-request caller can't explode series cardinality (the PR-7
# max_series cap then never has to silently drop real phase series).

TENANT_LABEL_CAP = 32
TENANT_OVERFLOW = "_other"
_TENANT_LABELS: set = set()


def tenant_label(tenant) -> str:
    """Bounded tenant label value (see TENANT_LABEL_CAP above)."""
    t = str(tenant)
    if t in _TENANT_LABELS:
        return t
    if len(_TENANT_LABELS) < TENANT_LABEL_CAP:
        _TENANT_LABELS.add(t)
        return t
    return TENANT_OVERFLOW


# -- pass-level tracing + end-to-end SLO layer (obs/) ----------------------

SOLVER_PHASE_DURATION = REGISTRY.histogram(
    "karpenter_solver_phase_duration_seconds",
    "Per-phase solver wall clock, derived from the pass tracer's span data "
    "(phase = span name: encode.catalog, encode.groups, encode.nodes, "
    "device.upload, compile, device.execute, pack, materialize, ...); "
    "sidecar-served solves add a bounded tenant label",
    ("phase", "encode_kind", "tenant"),
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0, 2.5, 5.0, 10.0),
    # phases are a fixed vocabulary (~40 span names) x {cold, delta, ""} x
    # bounded tenants (TENANT_LABEL_CAP + overflow + the in-process "") —
    # worst case ~4k legitimate series, so the cap is sized as a backstop
    # against a DYNAMIC span name leaking in, not a lid real tenants hit
    max_series=8192)
PODS_TIME_TO_SCHEDULE = REGISTRY.histogram(
    "karpenter_pods_time_to_schedule_seconds",
    "First seen pending to capacity decision (NodeClaim created or "
    "existing-node placement) per pod — the operator-side end-to-end "
    "scheduling SLO",
    buckets=(0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0,
             1800.0))
SLO_BREACHES = REGISTRY.counter(
    "karpenter_slo_breaches_total",
    "Pass traces that exceeded a configured SLO budget (slo = the watched "
    "span name); each breach also publishes an SLOBreached warning event "
    "and dumps the pass's flight-recorder records",
    ("slo",), max_series=64)
SERIES_DROPPED = REGISTRY.counter(
    "karpenter_metrics_series_dropped_total",
    "Label sets dropped by a metric's cardinality cap (max_series)",
    ("metric",))

# -- multi-tenant solver sidecar (sidecar/server.py admission layer) -------

SIDECAR_QUEUE_DEPTH = REGISTRY.gauge(
    "karpenter_sidecar_queue_depth",
    "Solve requests waiting in the sidecar's admission queue, per tenant "
    "(bounded tenant label)",
    ("tenant",), max_series=64)
SIDECAR_QUEUE_WAIT = REGISTRY.histogram(
    "karpenter_sidecar_queue_wait_seconds",
    "Admission-queue wait before a sidecar solve reaches the device, per "
    "tenant (bounded tenant label)",
    ("tenant",),
    buckets=(0.0005, 0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0),
    max_series=64)
SIDECAR_RESYNCS = REGISTRY.counter(
    "karpenter_sidecar_session_resyncs_total",
    "Delta-session resync triggers: content-digest mismatches, LRU/idle "
    "session evictions, unknown-session hits from stale clients",
    ("reason",), max_series=16)

# -- fault-tolerant service path: crash-safe server + resilient
# client. Server side: tenant-fair load shedding, drain state, and the
# request-digest dedupe cache that makes retries/hedges idempotent. Client
# side: deadline/backoff retries and hedged solves. ---------------------------

SIDECAR_SHED = REGISTRY.counter(
    "karpenter_sidecar_shed_total",
    "Solve requests shed from the sidecar admission queue: 'fairness' = a "
    "burst tenant's newest waiter evicted so an under-share tenant could "
    "enqueue, 'overload' = rejected at the saturated bound, 'draining' = "
    "NACKed during graceful drain (all retryable client-side)",
    ("tenant", "reason"), max_series=128)
SIDECAR_DEDUP_HITS = REGISTRY.counter(
    "karpenter_sidecar_dedup_hits_total",
    "Session solve requests served from the request-digest response cache "
    "(a retry or hedge of a request the server already applied — the "
    "at-most-once-apply guarantee), per tenant (bounded label)",
    ("tenant",), max_series=64)
SIDECAR_DRAINING = REGISTRY.gauge(
    "karpenter_sidecar_draining",
    "1 while the sidecar is draining (new RPCs NACKed UNAVAILABLE, "
    "in-flight solves finishing), 0 otherwise")
SIDECAR_CLIENT_RETRIES = REGISTRY.counter(
    "karpenter_sidecar_client_retries_total",
    "Client-side RPC retries by status code that triggered them "
    "(unavailable, deadline_exceeded, resource_exhausted; jittered "
    "exponential backoff under a token retry budget)",
    ("code",), max_series=16)
SIDECAR_CLIENT_HEDGES = REGISTRY.counter(
    "karpenter_sidecar_client_hedges_total",
    "Hedged solve RPCs: 'fired' = a second identical request launched "
    "after hedge_delay with no response, 'won' = the hedge answered first "
    "(safe: solves are pure functions of session state and the server "
    "dedupes by request digest)",
    ("outcome",), max_series=8)

# -- replicated sidecar fleet: session checkpoint/migration,
# consistent-hash tenant routing, zero-downtime rolling restarts. ------------

SIDECAR_MIGRATIONS = REGISTRY.counter(
    "karpenter_sidecar_migrations_total",
    "Session checkpoint movements in a sidecar fleet: 'drain' = exported "
    "to the handoff store by a draining replica, 'restore' = rebuilt warm "
    "on a peer from its checkpoint, 'rollback' = a digest-mismatched "
    "session reloaded from its last acked checkpoint for delta catch-up, "
    "'restore_rejected' = a checkpoint the codec loudly refused "
    "(corrupt/truncated/version skew), 'export_error' = a post-solve "
    "checkpoint write that failed",
    ("reason",), max_series=16)
SIDECAR_HANDOFF_EVICTED = REGISTRY.counter(
    "karpenter_sidecar_handoff_evicted_total",
    "Fleet handoff-store session checkpoints evicted, by reason: 'cap' "
    "= LRU-dropped past the entry bound, 'ttl' = orphaned past the "
    "expiry (the owning replica died without a successor restoring it)",
    ("reason",), max_series=4)
SIDECAR_REPLICA_SESSIONS = REGISTRY.gauge(
    "karpenter_sidecar_replica_sessions",
    "Live delta sessions held by each sidecar fleet replica (bounded "
    "replica label)",
    ("replica",), max_series=32)
SIDECAR_REPLICA_FAILOVERS = REGISTRY.counter(
    "karpenter_sidecar_replica_failovers_total",
    "Client-side replica switches by the consistent-hash fleet router: "
    "'migrated' = followed a draining replica's migrated_to rider, "
    "'unavailable' = re-routed to the ring successor after consecutive "
    "UNAVAILABLE answers marked the replica down",
    ("reason",), max_series=8)

# -- whole-fleet causal observability ---------------------------
# Fallback cost ledger: every host-oracle escape classified by the shape
# class that forced it (obs/fallbacks.py), so ROADMAP item 1 gets its
# priority ordering from measurements instead of guesses. Device truth:
# per-executable dispatch-vs-device time split and XLA memory watermarks
# (obs/device.py). Profile lifecycle: obs/profile.py.

FALLBACK_PODS = REGISTRY.counter(
    "karpenter_fallback_pods_total",
    "Pods solved on the host-oracle path instead of the tensor kernel "
    "(subsystem=provisioning) or LOO consolidation candidate rows punted "
    "to exact replay sims (subsystem=disruption), by the shape class that "
    "forced the escape (volumes, topo, ports, minvalues, multi_group, "
    "limits, base_pods, circuit_open, ...)",
    ("shape", "subsystem"), max_series=64)
FALLBACK_SOLVES = REGISTRY.counter(
    "karpenter_fallback_solves_total",
    "Solves (or disruption passes) in which at least one pod/candidate "
    "escaped the batched math, by shape class (a mixed solve increments "
    "every class it contains)",
    ("shape", "subsystem"), max_series=64)
FALLBACK_HOST_SECONDS = REGISTRY.counter(
    "karpenter_fallback_host_seconds_total",
    "Wall seconds spent in the host-oracle path (full fallbacks and "
    "remainder passes), attributed pro-rata by pod count across the "
    "solve's escape shape classes",
    ("shape", "subsystem"), max_series=64)
FALLBACK_TENSOR_SECONDS = REGISTRY.counter(
    "karpenter_fallback_tensor_seconds_total",
    "Wall seconds spent in the tensor path across all solves — the "
    "denominator for host-vs-tensor cost comparisons on mixed batches")
DEVICE_DISPATCHES = REGISTRY.counter(
    "karpenter_device_dispatches_total",
    "Dispatches of a cached compiled executable, per executable label "
    "(the binpack padded-shape-bucket cache key's digest)",
    ("executable",), max_series=64)
DEVICE_DISPATCH_SECONDS = REGISTRY.counter(
    "karpenter_device_dispatch_seconds_total",
    "Host-side dispatch overhead (exe(*args) enqueue time) per executable "
    "— the host half of the device-time attribution split",
    ("executable",), max_series=64)
DEVICE_EXECUTE_SECONDS = REGISTRY.counter(
    "karpenter_device_execute_seconds_total",
    "Measured device completion time (block_until_ready delta after "
    "dispatch) per executable — the accelerator half of the split; only "
    "collected while tracing is enabled",
    ("executable",), max_series=64)
DEVICE_MEMORY_PEAK = REGISTRY.gauge(
    "karpenter_device_memory_peak_bytes",
    "Per-device XLA memory watermark: the max memory_analysis() peak "
    "(args + temps + output) across every executable compiled so far",
    ("device",), max_series=64)
PROFILE_ACTIVE = REGISTRY.gauge(
    "karpenter_profile_active",
    "1 while a jax.profiler device-trace session is running "
    "(/debug/profile?device=start or python -m karpenter_tpu.obs profile)")

# -- trace-driven fleet simulator (sim/) -----------------------------------
# The simulator's own aggregate truth lives in its report/ledger (those are
# digested for determinism); these families exist so a sim run serves the
# SAME /metrics surface an operator does — dashboards built against a live
# cluster read identically against a replay.

SIM_EVENTS_APPLIED = REGISTRY.counter(
    "karpenter_sim_events_applied_total",
    "Scenario timeline events the fleet simulator has actuated, by event "
    "kind (deploy, scale, rolling_update, pdb, spot_reclaim, zonal_outage, "
    "drought, drain, flaky, slo)",
    ("kind",), max_series=32)
SIM_TICKS = REGISTRY.counter(
    "karpenter_sim_ticks_total",
    "Simulator loop iterations (one full operator quiesce per tick; the "
    "adaptive stepper jumps straight to the next scenario event, manager "
    "timer, or batcher deadline)")
SIM_CLOCK_SECONDS = REGISTRY.gauge(
    "karpenter_sim_clock_seconds",
    "Simulated seconds elapsed since scenario start (the accelerated "
    "FakeClock's progress through the timeline)")
SIM_POD_HOURS = REGISTRY.counter(
    "karpenter_sim_pod_hours_total",
    "Bound-pod hours integrated over simulated time (the denominator of "
    "the cost-per-pod-hour SLO)")
SIM_FLEET_COST = REGISTRY.counter(
    "karpenter_sim_fleet_cost_dollars_total",
    "Fleet cost integrated from per-node offering prices over simulated "
    "time (the numerator of the cost-per-pod-hour SLO)")
