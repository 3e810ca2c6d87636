"""Provisioner: the singleton loop that turns pending pods into NodeClaims.

Mirrors karpenter's pkg/controllers/provisioning/provisioner.go:
batching window (batcher.go:33-110), pending-pod collection (:159-176),
deleting-node pod carryover (:316-320), scheduler construction per solve
(:215-299), NodeClaim creation (:354-392), and pod->node nomination recording
(scheduling/scheduler.go:117-151). The solve itself runs on the tensor path
(provisioning/tensor_scheduler.py) on ``device`` — ``cuda`` unless the caller
names another; ``"cpu"`` runs the kernels' plain PyTorch versions — with the
host oracle as semantic authority. ``profile_dir`` profiles each pass's solve
through obs.profile.PROFILER, and ``flight_recorder`` captures each live
solve as a replayable record (flightrec/).

The Binder controller closes the loop the kube-scheduler closes in the
reference: once a nominated NodeClaim's node is initialized, bind the pods.
"""

from __future__ import annotations

import itertools
from collections import OrderedDict
from typing import Dict, List, Optional

from ..api import labels as api_labels
from ..api.nodeclaim import NodeClaim
from ..api.nodepool import NodePool, order_by_weight
from ..api.objects import Node, Pod
from ..controllers.manager import Controller, Result, SingletonController
from ..events import catalog as events_catalog
from ..kube.store import Store
from ..logging import get_logger
from ..obs.tracer import TRACER
from ..scheduling.taints import DISRUPTED_NO_SCHEDULE_TAINT
from ..state.cluster import Cluster
from ..utils import pod as pod_utils
from ..utils.clock import Clock
from .domains import build_topology_domains
from .tensor_scheduler import TensorScheduler
from .topology import ClusterView

BATCH_IDLE_SECONDS = 1.0   # options.go:99 batchIdleDuration
BATCH_MAX_SECONDS = 10.0   # options.go:100 batchMaxDuration

log = get_logger("provisioner")


class Batcher:
    """Batching window (batcher.go:33-110): the solve fires once pod arrivals
    go idle for BATCH_IDLE_SECONDS, or BATCH_MAX_SECONDS after the first
    arrival, whichever comes first."""

    def __init__(self, clock: Clock, idle: float = BATCH_IDLE_SECONDS,
                 max_duration: float = BATCH_MAX_SECONDS):
        self.clock = clock
        self.idle = idle
        self.max_duration = max_duration
        self._first: Optional[float] = None
        self._last: Optional[float] = None

    def trigger(self) -> None:
        now = self.clock.now()
        if self._first is None:
            self._first = now
        self._last = now

    def ready(self) -> bool:
        if self._first is None:
            return False
        now = self.clock.now()
        return (now - self._last >= self.idle
                or now - self._first >= self.max_duration)

    def time_until_ready(self) -> float:
        if self._first is None:
            return self.idle
        now = self.clock.now()
        return max(0.0, min(self._last + self.idle - now,
                            self._first + self.max_duration - now))

    def reset(self) -> None:
        self._first = self._last = None


class StateClusterView(ClusterView):
    """Topology's view of scheduled pods / node labels, backed by the store +
    cluster state (topology.go countDomains inputs)."""

    def __init__(self, store: Store, cluster: Cluster):
        self.store = store
        self.cluster = cluster

    def list_pods(self, namespace: str, selector) -> List[Pod]:
        return self.store.list(
            Pod, namespace=namespace,
            predicate=lambda p: selector.matches(p.labels)
            and pod_utils.is_active(p) and pod_utils.is_scheduled(p))

    def node_labels(self, node_name: str) -> Optional[dict]:
        sn = self.cluster._node_by_name(node_name)
        return sn.labels() if sn is not None else None

    def for_pods_with_anti_affinity(self):
        for p in self.cluster.anti_affinity_pods():
            if pod_utils.is_scheduled(p):
                labels = self.node_labels(p.spec.node_name)
                if labels is not None:
                    yield p, labels


class PodTrigger(Controller):
    """Pod watch -> batcher trigger (provisioning/controller.go:38-76)."""

    name = "provisioning.pod-trigger"
    kinds = (Pod,)

    def __init__(self, provisioner: "Provisioner"):
        self.provisioner = provisioner

    def reconcile(self, pod) -> None:
        if pod_utils.is_provisionable(pod):
            self.provisioner.trigger()


class NodeDeletionTrigger(Controller):
    """Node watch -> batcher trigger for disrupted/deleting nodes
    (provisioning/controller.go:92-113): pods on a node that starts
    disrupting must re-provision without waiting for an unrelated pod
    event. Requeues every 10s while the node stays disrupted, matching the
    reference's RequeueAfter loop."""

    name = "provisioner.trigger.node"
    kinds = (Node,)

    def __init__(self, provisioner: "Provisioner"):
        self.provisioner = provisioner

    def reconcile(self, node) -> Optional[Result]:
        live = self.provisioner.store.get(Node, node.name)
        if live is None:
            return None
        disrupted = any(t.matches(DISRUPTED_NO_SCHEDULE_TAINT)
                        for t in live.spec.taints)
        if not disrupted and live.metadata.deletion_timestamp is None:
            return None
        self.provisioner.trigger()
        return Result(requeue_after=10.0)


class Provisioner(SingletonController):
    name = "provisioner"

    # cap on the exhausted-pod hold: when every pending pod is drought-
    # blocked, the solve loop sleeps until the next registry expiry but
    # never longer than this, so out-of-band capacity changes (a node
    # freeing up) are picked up promptly even without a trigger
    EXHAUSTED_HOLD_MAX_SECONDS = 30.0

    def __init__(self, store: Store, cluster: Cluster, cloud_provider,
                 clock: Optional[Clock] = None, batcher: Optional[Batcher] = None,
                 scheduler_factory=None, recorder=None, flight_recorder=None,
                 unavailable=None, problem_state=None, device=None):
        from ..events.recorder import Recorder
        from ..ops.binpack import resolve_device
        self.store = store
        # where every solve's feasibility precompute runs, the disruption
        # snapshot's included (disruption/prefix.py): cuda unless the caller
        # names another device; raises here when CUDA is asked for and absent
        self.device = resolve_device(device)
        # persistent cross-pass solver state (delta encode + warm-started
        # packing): attached to LIVE provisioning solves only — disruption
        # simulation probes solve hypothetical node subsets and must not
        # thrash the caches (see schedule_with). The handle subscribes to
        # the cluster's shared EncodePlane (state/plane.py); the disruption
        # controller subscribes its streaming engine to the SAME plane so
        # node/group rows encode once per revision bump for both loops.
        if problem_state is not None:
            self.problem_state = problem_state
        else:
            from ..state.plane import EncodePlane
            self.problem_state = EncodePlane(name="cluster").subscribe(
                "provisioning")
        self.state_plane = self.problem_state.plane
        # state.unavailable.UnavailableOfferings: expired at the top of
        # every pass (an expiry re-triggers a solve via the hold signature)
        # and handed to every scheduler the default factory builds
        self.unavailable = unavailable
        # (until, registry_version, pending_uids) while every pending pod
        # is drought-blocked: identical inputs re-solve nothing, so hold
        self._exhausted_hold = None
        # optional flightrec.FlightRecorder: live provisioning solves (NOT
        # disruption simulation probes — those would flood the ring) are
        # captured as replayable DecisionRecords
        self.flight_recorder = flight_recorder
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.clock = clock or store.clock
        self.recorder = recorder or Recorder(self.clock)
        self.batcher = batcher or Batcher(self.clock)
        # scheduler_factory(nodepools, instance_types, state_nodes,
        # daemonset_pods, cluster) -> object with solve(pods); defaults to the
        # in-process tensor scheduler on this provisioner's device
        self.scheduler_factory = scheduler_factory or (
            lambda nodepools, instance_types, state_nodes, daemonset_pods,
            cluster: TensorScheduler(
                nodepools, instance_types, state_nodes=state_nodes,
                daemonset_pods=daemonset_pods, cluster=cluster,
                unavailable=self.unavailable, device=self.device))
        # pod key -> nodeclaim name, consumed by the Binder
        self.nominations: Dict[str, str] = {}
        # pod uid -> clock.now() when the pod was FIRST observed pending:
        # the start of the karpenter_pods_time_to_schedule_seconds window,
        # closed at the capacity decision (claim created / existing-node
        # placement). Bounded by the pending set — entries for pods that
        # scheduled or vanished are dropped each pass.
        self._pending_first_seen: Dict[str, float] = {}
        # uid -> original first-seen of pods whose window just closed: a
        # pod recycled back to pending by a FAILED claim (ICE delete,
        # liveness TTL) must resume its ORIGINAL window, not start a fresh
        # one — otherwise a capacity drought reads as a stream of healthy
        # ~10s samples instead of the real 10-minute wait. Bounded FIFO
        # (successfully-bound pods never come back to claim their entry).
        self._observed_first_seen: "OrderedDict[str, float]" = OrderedDict()
        self.last_results = None
        self.last_scheduler = None
        # optional hook called after EVERY live provisioning pass with
        # (scheduler, results): the fleet simulator (sim/engine.py) rides
        # it for per-pass ledger entries and fallback-fraction accounting —
        # run_until_quiet can fire several passes per simulator tick, so
        # polling last_scheduler would miss all but the final one
        self.solve_observer = None
        # --enable-profiling analog (operator.go:159-175): a torch.profiler
        # session around each pass's solve when set
        self.profile_dir: Optional[str] = None

    # -- trigger path (provisioning/controller.go:38-119) -------------------

    def trigger(self) -> None:
        self.batcher.trigger()

    def get_pending_pods(self) -> List[Pod]:
        """provisioner.go:159-176: provisionable pods minus already-nominated
        and PVC-invalid ones."""
        from .volumetopology import validate_persistent_volume_claims
        out = []
        for p in self.store.list(Pod):
            if not pod_utils.is_provisionable(p):
                continue
            if f"{p.namespace}/{p.name}" in self.nominations:
                continue
            if p.spec.volumes and \
                    validate_persistent_volume_claims(self.store, p) is not None:
                continue
            out.append(p)
        return out

    # -- main loop ----------------------------------------------------------

    def reconcile(self) -> Optional[Result]:
        if self.unavailable is not None:
            # prune expired unavailable-offering entries FIRST: an expiry
            # bumps the registry version, which releases the exhausted-pod
            # hold below — capacity recovery is picked up within one TTL
            self.unavailable.expire()
        pods = self.get_pending_pods()
        # pods on deleting nodes must be rescheduled too, even when nothing
        # is pending — their replacement capacity has to exist before the
        # drain unbinds them (provisioner.go:316-335: the empty-batch exit
        # comes AFTER the deleting-node pods are gathered)
        deleting_pods: List[Pod] = []
        seen = {p.uid for p in pods}
        for sn in self.cluster.deleting_nodes():
            for uid in sn.pod_requests:
                if uid in seen:
                    continue
                p = self._pod_by_uid(uid)
                if p is not None and pod_utils.is_reschedulable(p):
                    deleting_pods.append(p)
        if not pods and not deleting_pods:
            self.batcher.reset()
            self._exhausted_hold = None
            self._pending_first_seen.clear()
            return None
        # first-seen-pending watermark (time-to-schedule window start):
        # stamped before the batcher gate so batching latency counts, and
        # pruned to the live pending view so vanished pods can't
        # accumulate. PENDING pods only — deleting-node ride-alongs are
        # still bound and re-enter the batch every drain pass; stamping
        # them would observe one bogus ~0s sample per pass (their real
        # window opens when the drain unbinds them into the pending set).
        now = self.clock.now()
        pending = {p.uid for p in pods}
        for uid in [u for u in self._pending_first_seen if u not in pending]:
            del self._pending_first_seen[uid]
        for uid in pending:
            if uid not in self._pending_first_seen:
                # a failed-claim recycle resumes its original window
                self._pending_first_seen[uid] = \
                    self._observed_first_seen.pop(uid, now)
        hold = self._check_exhausted_hold(pods, deleting_pods)
        if hold is not None:
            return hold
        if self.batcher._first is None:
            # pods may predate trigger wiring; start the window now
            self.batcher.trigger()
        if not self.batcher.ready():
            return Result(requeue_after=self.batcher.time_until_ready())
        self.batcher.reset()
        self.cluster.ack_pods(pods)
        from ..metrics import registry as metrics
        with TRACER.span("provisioner.pass",
                         pods=len(pods) + len(deleting_pods)) as psp:
            done = metrics.REGISTRY.measure(metrics.SCHEDULING_DURATION.name)
            started = self.clock.now()
            if self.profile_dir:
                # per-pass device profile through the ONE process-wide
                # profiler facility: a session already capturing makes
                # this a no-op instead of a second session
                from ..obs.profile import PROFILER
                with PROFILER.pass_scope(self.profile_dir):
                    results = self.schedule(pods + deleting_pods)
            else:
                results = self.schedule(pods + deleting_pods)
            done()
            metrics.UNSCHEDULABLE_PODS.set(len(results.pod_errors))
            self.last_results = results
            with TRACER.span("commit",
                             claims=len(results.new_nodeclaims)):
                self._create_nodeclaims(results)
                self._record(results)
            psp.set(claims=len(results.new_nodeclaims),
                    errors=len(results.pod_errors))
            trace_id = TRACER.current_trace_id()
        ts = self.last_scheduler
        log.info("scheduled pod batch",
                 pods=len(pods) + len(deleting_pods),
                 nodeclaims=len(results.new_nodeclaims),
                 existing_nodes=sum(1 for en in results.existing_nodes
                                    if en.pods),
                 unschedulable=len(results.pod_errors),
                 duration=round(self.clock.now() - started, 4),
                 tensor_pods=getattr(ts, "partition", (0, 0))[0],
                 host_pods=getattr(ts, "partition", (0, 0))[1],
                 fallback_reason=getattr(ts, "fallback_reason", ""),
                 trace_id=trace_id)
        if results.pod_errors:
            for uid, err in list(results.pod_errors.items())[:10]:
                log.debug("pod failed to schedule", pod_uid=uid, error=err)
        if self.solve_observer is not None:
            try:
                self.solve_observer(ts, results)
            except Exception:  # noqa: BLE001 — an observer never costs a pass
                pass
        return self._handle_exhausted(results, deleting_pods)

    def _pod_by_uid(self, uid: str) -> Optional[Pod]:
        return self.store.get_by_uid(Pod, uid)

    # -- capacity-exhaustion backoff ----------------------------------------

    def _check_exhausted_hold(self, pods, deleting_pods) -> Optional[Result]:
        """While every pending pod is drought-blocked and nothing changed
        (same pending set, same registry state), a re-solve is a doomed hot
        loop — sleep until the hold expires. Any new pod, any registry mark
        or expiry, or the hold lapsing releases it."""
        hold = self._exhausted_hold
        if hold is None:
            return None
        until, version, held_uids = hold
        now = self.clock.now()
        pending = frozenset(p.uid for p in pods).union(
            p.uid for p in deleting_pods)
        if now >= until or pending != held_uids \
                or self.unavailable is None \
                or self.unavailable.version != version:
            self._exhausted_hold = None
            return None
        return Result(requeue_after=until - now)

    def _handle_exhausted(self, results, deleting_pods) -> Optional[Result]:
        """Post-solve drought handling: pods whose every compatible
        offering is masked get ONE distinct warning event (deduped per
        pod) and, when they are the only failures, a backoff requeue to
        the next registry expiry instead of a hot solve loop."""
        exhausted = self._offerings_exhausted_pods(results)
        if not exhausted:
            self._exhausted_hold = None
            return None
        live = self.unavailable.snapshot()
        detail = ", ".join(
            f"{e['instance_type']}/{e['zone']}/{e['capacity_type']}"
            for e in live[:5]) or "registry"
        if len(live) > 5:
            detail += f" (+{len(live) - 5} more)"
        for p in exhausted:
            self.recorder.publish(
                events_catalog.offerings_exhausted(p, detail))
        if len(exhausted) != len(results.pod_errors):
            # mixed failures: the non-drought errors keep the normal
            # re-solve cadence, no hold
            self._exhausted_hold = None
            return None
        now = self.clock.now()
        until = now + self.EXHAUSTED_HOLD_MAX_SECONDS
        nxt = self.unavailable.next_expiry()
        if nxt is not None:
            until = min(until, nxt)
        until = max(until, now + 1.0)
        # the hold signature must equal NEXT pass's pending view: errored
        # pods stay pending, and deleting-node pods reappear in the
        # deleting set whether or not this pass placed them — omitting
        # them would invalidate the hold every cycle and run the doomed
        # solve loop the hold exists to prevent
        self._exhausted_hold = (
            until, self.unavailable.version,
            frozenset(results.pod_errors).union(
                p.uid for p in deleting_pods))
        log.info("all pending pods blocked on unavailable offerings; "
                 "holding solves", pods=len(exhausted),
                 hold_seconds=round(until - now, 1))
        return Result(requeue_after=until - now)

    def _offerings_exhausted_pods(self, results) -> List[Pod]:
        """Errored pods that some nodepool could otherwise host — taints
        tolerated, pool and instance-type requirements compatible,
        resources fit — but whose every admissible offering is covered by
        a live registry entry: waiting on capacity, not misconfigured.
        Pods no pool admits, or that fit no type, keep the plain
        FailedScheduling path even under a wildcard drought."""
        reg = self.unavailable
        if reg is None or not results.pod_errors or not len(reg):
            return []
        ts = self.last_scheduler
        its_by_pool = getattr(ts, "instance_types", None)
        nodepools = getattr(ts, "nodepools", None)
        if not its_by_pool or not nodepools:
            return []
        from ..scheduling import taints as scheduling_taints
        from ..scheduling.requirements import (ALLOW_UNDEFINED_WELL_KNOWN,
                                               pod_requirements)
        from ..utils import resources as res
        from .scheduler import NodeClaimTemplate
        from .tensor_scheduler import _reqs_digest
        pools = [(NodeClaimTemplate(np_), its_by_pool.get(np_.name, []))
                 for np_ in nodepools]
        by_uid = {p.uid: p for p in self.store.list(Pod)}
        # drought batches are overwhelmingly homogeneous (one deployment's
        # replicas share a spec): memoize the verdict per pod SHAPE so the
        # catalog scan runs once per distinct (requirements, requests,
        # tolerations), not once per errored pod — and cap the distinct
        # shapes scanned so a pathological batch can't stall the pass
        verdict_memo: dict = {}
        MAX_SHAPES = 64
        out: List[Pod] = []
        for uid in results.pod_errors:
            p = by_uid.get(uid)
            if p is None:
                continue
            reqs = pod_requirements(p)
            requests = p.requests()
            shape = (_reqs_digest(reqs), tuple(sorted(requests.items())),
                     tuple((t.key, t.operator, t.value, t.effect)
                           for t in p.spec.tolerations))
            verdict = verdict_memo.get(shape)
            if verdict is None:
                if len(verdict_memo) >= MAX_SHAPES:
                    continue  # scan budget spent: keep FailedScheduling
                verdict = self._shape_is_exhausted(p, reqs, requests, pools,
                                                   reg, scheduling_taints,
                                                   ALLOW_UNDEFINED_WELL_KNOWN,
                                                   res)
                verdict_memo[shape] = verdict
            if verdict:
                out.append(p)
        return out

    @staticmethod
    def _shape_is_exhausted(p, reqs, requests, pools, reg, scheduling_taints,
                            allow_undefined, res) -> bool:
        compatible = False
        for nct, its in pools:
            # tolerates() returns the error list: truthy = blocked
            if scheduling_taints.tolerates(nct.taints, p):
                continue
            if nct.requirements.compatible(reqs, allow_undefined):
                continue  # pool-level requirements exclude the pod
            for it in its:
                if it.requirements.intersects(reqs):
                    continue
                if not res.fits(requests, it.allocatable()):
                    continue
                offs = (it.offerings.available().compatible(reqs)
                        .compatible(nct.requirements))
                if not offs:
                    continue
                compatible = True
                if any(not reg.is_unavailable(it.name, o.zone,
                                              o.capacity_type)
                       for o in offs):
                    return False  # an unmasked offering exists
        return compatible

    def schedule(self, pods: List[Pod]):
        # exclude deleting nodes from pack targets (NewScheduler filters them)
        state_nodes = [sn for sn in self.cluster.state_nodes()
                       if not sn.deleting()]
        return self.schedule_with(pods, state_nodes, record=True)

    def schedule_with(self, pods: List[Pod], state_nodes, record: bool = False):
        """Solve against an explicit packable-node set; the disruption
        solver's SimulateScheduling entry point (helpers.go:49-113)."""
        from .volumetopology import inject_volume_topology_requirements
        pods = [inject_volume_topology_requirements(self.store, p)
                if p.spec.volumes else p for p in pods]
        # a deleting NodePool must not receive new capacity
        # (provisioning/suite_test.go:216-226)
        nodepools = order_by_weight(
            [np for np in self.store.list(NodePool)
             if np.metadata.deletion_timestamp is None])
        instance_types = {np.name: self.cloud_provider.get_instance_types(np)
                          for np in nodepools}
        nodepools = [np for np in nodepools if instance_types.get(np.name)]
        ts = self.scheduler_factory(
            nodepools, instance_types, state_nodes,
            self.cluster.daemonset_pod_list(),
            StateClusterView(self.store, self.cluster))
        if record and self.problem_state is not None \
                and hasattr(ts, "problem_state"):
            # live solves share the persistent delta state; simulation
            # probes (record=False) stay cold so their hypothetical node
            # subsets can't poison the caches or the warm-pack seed
            ts.problem_state = self.problem_state
        if record and self.flight_recorder is not None \
                and hasattr(ts, "flight_recorder"):
            # the in-process TensorScheduler captures inside solve()
            ts.flight_recorder = self.flight_recorder
        if not record and hasattr(ts, "ledger_subsystem"):
            # simulation probes are disruption candidate-build traffic:
            # flag them for the fallback ledger so the headline
            # provisioning totals describe LIVE solves only (explicit —
            # works with tracing disabled, unlike the root-span backstop)
            ts.ledger_subsystem = "disruption"
        self.last_scheduler = ts
        return ts.solve(pods)

    # bound on the observed-window memory: pods whose claims bound never
    # reclaim their entry, so old ones age out FIFO
    OBSERVED_FIRST_SEEN_MAX = 4096

    def _observe_scheduled(self, pod) -> None:
        """Close the pod's time-to-schedule window: first seen pending ->
        this pass's capacity decision (claim created / existing-node
        placement). The original first-seen is remembered so a failed
        claim recycling the pod resumes the SAME window — each retry then
        observes the cumulative wait, and p99 surfaces a drought instead
        of averaging it away."""
        from ..metrics import registry as metrics
        first = self._pending_first_seen.pop(pod.uid, None)
        if first is not None:
            metrics.PODS_TIME_TO_SCHEDULE.observe(
                max(0.0, self.clock.now() - first))
            while len(self._observed_first_seen) >= \
                    self.OBSERVED_FIRST_SEEN_MAX:
                self._observed_first_seen.popitem(last=False)
            self._observed_first_seen[pod.uid] = first

    def _create_nodeclaims(self, results) -> None:
        from ..metrics import registry as metrics
        for nc in results.new_nodeclaims:
            api_nc = nc.to_nodeclaim()
            api_nc.metadata.namespace = ""
            self.store.create(api_nc)
            self.cluster.update_nodeclaim(api_nc)
            metrics.NODECLAIMS_CREATED.inc(
                {"nodepool": api_nc.nodepool_name})
            for p in nc.pods:
                self._observe_scheduled(p)
                self.nominations[f"{p.namespace}/{p.name}"] = api_nc.name
                # provisioner.go:388: pods bound for a brand-new claim are
                # nominated against the claim (no node exists yet)
                self.recorder.publish(
                    events_catalog.nominate_pod(p, nodeclaim_name=api_nc.name))

    def _record(self, results) -> None:
        """Results.Record analog (scheduling/scheduler.go:117-151): publish
        FailedScheduling per pod error and Nominated per existing-node pod,
        then persist the nomination state."""
        nominations: Dict[str, str] = {}
        if results.pod_errors:
            # one LIST builds the uid index (a per-uid get_by_uid would be a
            # full cluster pod LIST per unschedulable pod on a kube backend)
            by_uid = {p.uid: p for p in self.store.list(Pod)}
            for uid, err in results.pod_errors.items():
                p = by_uid.get(uid)
                if p is not None:
                    self.recorder.publish(
                        events_catalog.pod_failed_to_schedule(p, err))
        for existing in results.existing_nodes:
            for p in existing.pods:
                self._observe_scheduled(p)
                self.cluster.nominate_node_for_pod(existing.name, p)
                nominations[f"{p.namespace}/{p.name}"] = existing.name
                self.recorder.publish(
                    events_catalog.nominate_pod(p, node_name=existing.name))
        self.cluster.mark_pod_scheduling_decisions(results.pod_errors, nominations)
        # bind pods packed onto live existing nodes immediately
        for existing in results.existing_nodes:
            for p in existing.pods:
                live = self.store.get(Pod, p.name, p.namespace)
                if live is not None and not live.spec.node_name:
                    live.spec.node_name = existing.name
                    self.store.update(live)
                # bound = this scheduling episode is OVER: a later unbind
                # (drain, disruption) opens a fresh window, it does not
                # resume this one
                self._observed_first_seen.pop(p.uid, None)


class Binder(SingletonController):
    """Binds pods to the nodes their NodeClaims became (the kube-scheduler's
    job in the reference; here nominations carry pod->nodeclaim intent)."""

    name = "binder"

    def __init__(self, store: Store, cluster: Cluster, provisioner: Provisioner):
        self.store = store
        self.cluster = cluster
        self.provisioner = provisioner

    def reconcile(self) -> Optional[Result]:
        done: List[str] = []
        for pod_key, nc_name in self.provisioner.nominations.items():
            nc = self.store.get(NodeClaim, nc_name)
            if nc is None:
                done.append(pod_key)
                continue
            if not nc.status.node_name:
                continue
            node = self.store.get(Node, nc.status.node_name)
            if node is None:
                continue
            ns, name = pod_key.split("/", 1)
            pod = self.store.get(Pod, name, ns)
            if pod is None or pod.spec.node_name:
                done.append(pod_key)
                continue
            # bind-time taint check: the kube-scheduler the
            # reference delegates to honors taints when it binds — a node
            # tainted disrupted:NoSchedule between nomination and bind must
            # NOT receive the pod. Ephemeral and the claim's own startup
            # taints don't block (they clear during initialization; dropping
            # the nomination on them would re-plan forever). Dropping the
            # nomination puts the pod back in the pending pool; the next
            # provisioning pass re-plans it.
            from ..scheduling import taints as scheduling_taints
            from ..scheduling.taints import KNOWN_EPHEMERAL_TAINTS
            blocking = [t for t in node.spec.taints
                        if not any(t.matches(e)
                                   for e in KNOWN_EPHEMERAL_TAINTS)
                        and not any(t.matches(s)
                                    for s in nc.spec.startup_taints)]
            if node.metadata.deletion_timestamp is not None or \
                    scheduling_taints.tolerates(blocking, pod):
                done.append(pod_key)
                self.provisioner.trigger()
                continue
            pod.spec.node_name = node.name
            self.store.update(pod)
            # the episode closed at bind: a future unbind starts a fresh
            # time-to-schedule window (see _observe_scheduled)
            self.provisioner._observed_first_seen.pop(pod.uid, None)
            nc.status.last_pod_event_time = self.store.clock.now()
            done.append(pod_key)
        for k in done:
            self.provisioner.nominations.pop(k, None)
        return None
