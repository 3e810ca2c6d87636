"""FleetSimulator: replay a scenario against the FULL operator loop.

One simulator run boots a complete Operator — provisioner, disruption
controller, nodeclaim lifecycle, termination drains, the kwok fabricated
fleet wrapped in ChaosCloudProvider — on an accelerated FakeClock, and
actuates the scenario's event timeline at its simulated instants. The
chaos substrate is REUSED, never reimplemented: capacity droughts are
``utils.chaos.CapacityDrought`` windows installed through
``ChaosCloudProvider.exhaust()``, flaky windows move the seeded
``FaultInjector`` rate, and SLO breaches ride the
``SLOWatcher``/``FlightRecorder.dump_matching`` path so every breach
lands as a replayable flight dump.

Every solve of a run happens on one torch device, resolved once when the
simulator is built (``cuda`` unless the caller names another; without a
card and without a device named, construction raises): the operator's
provisioning and disruption passes, every sidecar replica (restarts
included) and the solver mesh a ``kill_device`` event degrades. That mesh
is eight slots over the one device, the 4x2 grid of the JAX package's
eight-device mesh, so killing one slot leaves the ladder a carve to serve
from, as it does there.

Time is advanced ADAPTIVELY: after each operator quiesce the clock jumps
straight to the next interesting instant — the next scenario event, the
manager's earliest requeue timer (eviction backoffs, kubelet ready
delays, liveness TTLs), the provisioner's batch deadline, a paced
controller's next slot — capped by the scenario ``tick``. A 24-hour
timeline replays in minutes (the BENCH_MODE=sim line asserts >= 100x
compression) without skipping a single scheduled reconcile.

Determinism: same seed + same scenario => byte-identical ledger digest
(report.Ledger strips the process-volatile join fields). Everything the
ledger digests derives from the FakeClock, the seeded RNGs, and the
manager's deterministic single-dispatch ordering.
"""

from __future__ import annotations

import gc
import heapq
import itertools
import math
import random
import time
from collections import Counter as _Counter
from collections import deque
from typing import Dict, List, Optional

from ..api import labels as api_labels
from ..api.nodeclaim import NodeClaim
from ..api.nodepool import (Disruption, NodeClaimTemplate,
                            NodeClaimTemplateSpec, NodePool, NodePoolSpec)
from ..api.objects import (LabelSelector, Node, ObjectMeta, Pod, PodSpec,
                           TopologySpreadConstraint)
from ..api.policy import PDBSpec, PodDisruptionBudget
from ..cloudprovider.chaos import ChaosCloudProvider
from ..cloudprovider.kwok import (KwokCloudProvider, construct_catalog,
                                  construct_instance_types)
from ..controllers.manager import SingletonController
from ..logging import get_logger
from ..metrics import registry as metrics
from ..operator.operator import Operator
from ..operator.options import Options
from ..utils import resources as res
from ..utils.chaos import FaultInjector
from ..utils.clock import FakeClock
from .report import Ledger, build_report
from .scenario import Scenario

log = get_logger("sim")

# smallest simulated advance per loop iteration: a zero-progress wake
# target (a timer armed for "now") must never stall the timeline
MIN_STEP_SECONDS = 0.01


class _PacedSingleton(SingletonController):
    """Cadence gate around an expensive singleton (the disruption
    controller): under the accelerated clock the manager runs singletons
    once per simulator tick, so an unpaced disruption pass would run
    thousands of consolidation solves per simulated day. The gate holds
    the inner controller to ``interval`` simulated seconds — the
    reference's poll cadence — while still honoring the SHORTER requeues
    the controller itself asks for (the 15 s consolidation-TTL
    revalidation, the 1 s not-synced retry). DEVIATIONS 21."""

    def __init__(self, inner, clock, interval: float):
        self.inner = inner
        self.clock = clock
        self.interval = interval
        self.name = inner.name
        self.next_due = -math.inf

    def reconcile(self):
        from ..disruption.controller import POLL_INTERVAL_SECONDS
        now = self.clock.now()
        if now < self.next_due:
            return None
        result = self.inner.reconcile()
        # the controller's NORMAL cadence answer (the reference 10 s poll)
        # maps to the scenario interval; genuinely urgent requeues — the
        # not-synced 1 s retry, and ANY wait while a command awaits its
        # consolidation-TTL revalidation — keep their own clock
        wait = self.interval
        if result is not None and result.requeue_after is not None:
            if getattr(self.inner, "pending", None) is not None \
                    or result.requeue_after < POLL_INTERVAL_SECONDS:
                wait = min(wait, result.requeue_after)
        self.next_due = now + wait
        return result


class _Workload:
    """Sim-side deployment controller: the reference relies on real
    workload controllers to keep replicas alive; the simulator plays that
    role with deterministic pod naming (name-g<generation>-<seq>)."""

    def __init__(self, name: str, replicas: int, cpu: str, memory: str,
                 spread: Optional[str], capacity_type: Optional[str],
                 zone: Optional[str]):
        self.name = name
        self.replicas = replicas
        self.cpu = cpu
        self.memory = memory
        self.spread = spread
        self.capacity_type = capacity_type
        self.zone = zone
        self.generation = 1
        self._seq = itertools.count(1)

    def make_pod(self) -> Pod:
        labels = {"app": self.name, "sim/gen": str(self.generation)}
        selector = {}
        if self.capacity_type:
            ct = (api_labels.CAPACITY_TYPE_SPOT
                  if self.capacity_type == "spot"
                  else api_labels.CAPACITY_TYPE_ON_DEMAND)
            selector[api_labels.CAPACITY_TYPE_LABEL_KEY] = ct
        if self.zone:
            selector[api_labels.LABEL_TOPOLOGY_ZONE] = self.zone
        spread = []
        if self.spread:
            key = (api_labels.LABEL_TOPOLOGY_ZONE if self.spread == "zone"
                   else api_labels.LABEL_HOSTNAME)
            spread = [TopologySpreadConstraint(
                topology_key=key, max_skew=1,
                label_selector=LabelSelector(
                    match_labels={"app": self.name}))]
        return Pod(
            metadata=ObjectMeta(
                name=f"{self.name}-g{self.generation}-{next(self._seq):05d}",
                namespace="default", labels=labels),
            spec=PodSpec(node_selector=selector,
                         topology_spread_constraints=spread),
            container_requests=[res.parse_list(
                {"cpu": self.cpu, "memory": self.memory})])

    @staticmethod
    def pod_generation(pod: Pod) -> int:
        try:
            return int(pod.metadata.labels.get("sim/gen", "0"))
        except ValueError:
            return 0


class FleetSimulator:
    """Replay one Scenario. ``run()`` returns the SLO report dict; the
    deterministic ledger is on ``self.ledger``."""

    def __init__(self, scenario: Scenario, flightrec_dir: Optional[str] = None,
                 options: Optional[Options] = None, device=None):
        from ..ops.binpack import resolve_device
        self.device = resolve_device(device)
        self.scenario = scenario
        # process-wide state a run changes, put back as it was when run()
        # ends: the pass tracer the operator configures (and the SLO
        # watcher set on it below), and the collector that serve()
        # freezes and disables for the process
        from ..obs.tracer import TRACER
        self._tracer_was = (TRACER.enabled, TRACER.capacity, TRACER.watcher)
        self._gc_was = (gc.isenabled(), gc.get_freeze_count())
        self.clock = FakeClock()
        self.t0 = self.clock.now()
        self.rng = random.Random(scenario.seed)
        self.injector = FaultInjector(seed=scenario.seed, rate=0.0)
        catalog = (construct_catalog(scenario.catalog) if scenario.catalog
                   else construct_instance_types())
        self.kwok = KwokCloudProvider(instance_types=catalog)
        self.chaos = ChaosCloudProvider(self.kwok, self.injector)
        # offering price per (instance type, capacity type): the kwok
        # formula prices every zone identically, so one entry per pair
        self._price: Dict[tuple, float] = {}
        for it in catalog:
            for off in it.offerings:
                self._price[(it.name, off.capacity_type)] = off.price
        opts = options or Options()
        opts.slo_budgets = scenario.slo_budgets
        opts.batch_idle_duration = scenario.batch_idle
        opts.batch_max_duration = scenario.batch_max
        opts.kwok_ready_delay = scenario.ready_delay
        # solver_backend=sidecar (ROADMAP item 5): boot a REAL in-process
        # gRPC sidecar and point the operator's provisioning at it — the
        # whole session wire + admission stack runs under the accelerated
        # clock, and wire_chaos events can fault the wire itself
        self.sidecar_server = None
        self._sidecar_port = None
        self.wire_injector = None
        self.solver_session = None
        self._wire_windows: List[dict] = []
        # fleet mode (scenario.replicas >= 1): N isolated Replica serving
        # states sharing ONE handoff checkpoint store, so kills/drains of
        # any replica resume warm on a peer. replicas == 0 keeps the
        # legacy single module-global server byte-identical to before.
        self.fleet = scenario.backend == "sidecar" and scenario.replicas > 0
        self.sidecar_replicas: List[list] = []   # [server, port, Replica]
        self.replica_addresses: List[str] = []
        self.handoff = None
        self.fleet_restarts = 0
        if scenario.backend == "sidecar":
            from ..sidecar import server as sidecar_server
            if self.fleet:
                self.handoff = sidecar_server.HandoffStore()
                for i in range(scenario.replicas):
                    rep = sidecar_server.Replica(name=f"replica-{i}",
                                                 handoff=self.handoff,
                                                 device=self.device)
                    server, port = sidecar_server.serve(port=0, replica=rep)
                    self.sidecar_replicas.append([server, port, rep])
                self.replica_addresses = [
                    f"127.0.0.1:{p}" for _, p, _ in self.sidecar_replicas]
                for i, (_, _, rep) in enumerate(self.sidecar_replicas):
                    rep.peers = tuple(a for j, a
                                      in enumerate(self.replica_addresses)
                                      if j != i)
                self.sidecar_server = self.sidecar_replicas[0][0]
                self._sidecar_port = self.sidecar_replicas[0][1]
            else:
                self.sidecar_server, self._sidecar_port = \
                    sidecar_server.serve(port=0, device=self.device)
            opts.solver_backend = "sidecar"
            opts.solver_address = f"127.0.0.1:{self._sidecar_port}"
        self.op = Operator(options=opts, cloud_provider=self.chaos,
                           clock=self.clock, device=self.device)
        if scenario.backend == "sidecar":
            from ..sidecar.client import RetryPolicy
            from ..sidecar.wire_chaos import ChaosChannel
            from ..utils.chaos import WireFaultInjector
            self.wire_injector = WireFaultInjector(seed=scenario.seed)
            sess = self.op.solver_session
            if self.fleet:
                # the consistent-hash router owns the channel; every
                # replica it dials is wrapped in the SAME seeded injector,
                # so the fault stream (and with it the ledger digest) is
                # replica-count-invariant
                from ..sidecar.wire_chaos import chaos_channel_factory
                sess.enable_fleet(
                    self.replica_addresses,
                    channel_factory=chaos_channel_factory(
                        self.wire_injector))
            else:
                sess._channel = ChaosChannel(sess._channel,
                                             self.wire_injector)
            # wire retries sleep WALL seconds while the FakeClock stands
            # still: a tight backoff keeps fault recovery from costing
            # the compression headline, and a deep retry budget reflects
            # that the sim's whole point is surviving the fault windows
            sess.retry = RetryPolicy(deadline=15.0, max_attempts=6,
                                     backoff_base=0.01, backoff_cap=0.25,
                                     retry_budget=64.0, refund=1.0)
            sess._retry_tokens = sess.retry.retry_budget
            self.solver_session = sess
        # anti-entropy chaos (requires `backend: tensor`): boot a
        # StateAuditor on the provisioner's state plane when the scenario
        # corrupts warm state, and a DeviceKiller + solver mesh when it
        # kills devices. Both event kinds are deliberately UNLEDGERED
        # (the per-replica rolling_restart precedent): the audit contract
        # is that a chaos run's ledger digest equals the fault-free run's.
        self.state_corruptor = None
        self.state_auditor = None
        self.device_killer = None
        self._prev_device_chaos = None
        self.mesh = None
        kinds = {e.kind for e in scenario.events}
        if "corrupt_state" in kinds:
            from ..state.audit import StateAuditor
            from ..utils.chaos import StateCorruptor
            self.state_corruptor = StateCorruptor(seed=scenario.seed)
            self.state_auditor = StateAuditor(
                seed=scenario.seed, recorder=self.op.recorder,
                flightrec=self.op.flightrec, now=self.clock.now)
            self.state_auditor.attach(self.op.provisioner.state_plane)
        if "kill_device" in kinds:
            from ..ops import binpack
            from ..parallel.mesh import make_solver_mesh
            from ..utils.chaos import DeviceKiller
            self.device_killer = DeviceKiller()
            self._prev_device_chaos = binpack.install_device_chaos(
                self.device_killer)
            # the ladder needs a mesh to degrade from; decision parity is
            # free (sharded_precompute is bit-identical to the host
            # precompute for any mesh, pinned by the parity tests). Eight
            # slots over the run's device: one slot lost leaves a carve
            mesh = self.mesh = make_solver_mesh(devices=[self.device] * 8)
            prov = self.op.provisioner
            base_factory = prov.scheduler_factory

            def mesh_factory(*a, **kw):
                ts = base_factory(*a, **kw)
                ts.mesh = mesh
                return ts

            prov.scheduler_factory = mesh_factory
        self.kwok.store = self.op.store
        # pre-install the drought schedule CLOCK so duration'd windows
        # (zonal outages) expire at their simulated instant
        from ..utils.chaos import CapacityDrought
        self.kwok.drought = CapacityDrought(clock=self.clock)
        self.flightrec_dir = flightrec_dir
        if scenario.needs_slo_watcher and self.op.slo is None:
            # `slo` events open budget windows mid-run; boot an (initially
            # budget-less, hence inert) watcher on the operator's wiring
            from ..obs.slo import SLOWatcher
            from ..obs.tracer import TRACER
            self.op.slo = SLOWatcher({}, recorder=self.op.recorder,
                                     flightrec=self.op.flightrec,
                                     clock=self.clock)
            TRACER.watcher = self.op.slo
        if self.op.slo is not None and flightrec_dir:
            self.op.slo.dump_dir = flightrec_dir
        # breaches arrive through the watcher's on_breach hook, not by
        # slicing its `breaches` deque: that ring keeps only the last 64,
        # so a long scenario breaching every pass would silently drop
        # entry #65+ from the ledger and report
        self._fresh_breaches: list = []
        if self.op.slo is not None:
            self.op.slo.on_breach = self._fresh_breaches.append
        # `slo` events are WINDOWS over these baseline budgets: effective
        # budgets are the most recently opened still-active window's, the
        # baseline again once every window has closed (a per-window
        # saved-previous snapshot would resurrect an overlapping earlier
        # window's budgets at the later window's close)
        self._slo_baseline: dict = (dict(self.op.slo.budgets)
                                    if self.op.slo is not None else {})
        self._slo_windows: List[dict] = []
        self._flaky_windows: List[dict] = []
        # pace the disruption pass to the scenario's cadence
        self._paced: List[_PacedSingleton] = []
        singles = self.op.manager.singletons
        for i, s in enumerate(singles):
            if s is self.op.disruption:
                paced = _PacedSingleton(s, self.clock,
                                        scenario.disruption_interval)
                singles[i] = paced
                self._paced.append(paced)
        self.op.provisioner.solve_observer = self._on_solve

        # -- run state -------------------------------------------------------
        self.ledger = Ledger()
        self.tts_samples: List[float] = []
        self.counts = _Counter(claims_created=0, claims_terminated=0,
                               nodes_created=0, nodes_terminated=0,
                               pods_evicted=0, pods_replaced=0)
        self.solver_stats = _Counter(passes=0, tensor_pods=0, host_pods=0,
                                     pod_errors=0)
        # fallback cost ledger: per-shape-class host-oracle pod
        # counts (deterministic — digested in the ledger entries) and the
        # host/tensor wall split (measurement context, report-only)
        self.fallback_classes: Dict[str, int] = {}
        self.fallback_host_seconds = 0.0
        self.fallback_tensor_seconds = 0.0
        self.phase_attribution: Dict[str, float] = {}
        self.events_applied: "_Counter[str]" = _Counter()
        self.breaches: list = []
        self.workloads: Dict[str, _Workload] = {}
        self._pending_since: Dict[str, float] = {}
        self._bound: Dict[str, str] = {}   # pod name -> node name
        self._bound_count = 0
        self._cost_rate = 0.0              # $/hour across live nodes
        self.fleet_cost = 0.0
        self.pod_hours = 0.0
        self.sim_seconds = 0.0
        self.wall_seconds = 0.0
        self.final_state: dict = {}
        # internal action heap: (fire_at_abs, seq, fn) — rolling-update
        # steps, flaky/slo window closings
        self._actions: list = []
        self._action_seq = itertools.count(1)
        self._running = False
        self.op.store.watch(self._on_store_event)

    # -- sim-time helpers ----------------------------------------------------

    def _rel(self) -> float:
        return self.clock.now() - self.t0

    def _after(self, delay: float, fn) -> None:
        heapq.heappush(self._actions,
                       (self.clock.now() + delay, next(self._action_seq), fn))

    # -- observers -----------------------------------------------------------

    def _on_store_event(self, ev) -> None:
        if not self._running:
            return
        kind = ev.kind.__name__
        obj = ev.obj
        t = self._rel()
        if kind == "Pod":
            name = obj.metadata.name
            node = obj.spec.node_name or ""
            if ev.type == "ADDED":
                if node:
                    self._bound[name] = node
                    self._bound_count += 1
                else:
                    self._pending_since.setdefault(name, self.clock.now())
            elif ev.type == "MODIFIED":
                was = self._bound.get(name, "")
                if node and not was:
                    since = self._pending_since.pop(name, self.clock.now())
                    wait = self.clock.now() - since
                    self.tts_samples.append(wait)
                    self._bound[name] = node
                    self._bound_count += 1
                    self.ledger.append(t, "pod_bound", pod=name, node=node,
                                       wait=round(wait, 3))
                elif was and not node:
                    self._bound.pop(name, None)
                    self._bound_count -= 1
                    self.counts["pods_evicted"] += 1
                    self._pending_since[name] = self.clock.now()
                    self.ledger.append(t, "pod_unbound", pod=name, node=was)
            elif ev.type == "DELETED":
                if self._bound.pop(name, None):
                    self._bound_count -= 1
                self._pending_since.pop(name, None)
        elif kind == "Node":
            labels = obj.metadata.labels
            price = self._price.get(
                (labels.get(api_labels.LABEL_INSTANCE_TYPE, ""),
                 labels.get(api_labels.CAPACITY_TYPE_LABEL_KEY, "")), 0.0)
            if ev.type == "ADDED":
                self._cost_rate += price
                self.counts["nodes_created"] += 1
                self.ledger.append(
                    t, "node_added", node=obj.metadata.name,
                    instance_type=labels.get(
                        api_labels.LABEL_INSTANCE_TYPE, ""),
                    zone=labels.get(api_labels.LABEL_TOPOLOGY_ZONE, ""),
                    capacity_type=labels.get(
                        api_labels.CAPACITY_TYPE_LABEL_KEY, ""),
                    price=round(price, 5))
            elif ev.type == "DELETED":
                self._cost_rate -= price
                self.counts["nodes_terminated"] += 1
                self.ledger.append(t, "node_gone", node=obj.metadata.name)
        elif kind == "NodeClaim":
            if ev.type == "ADDED":
                self.counts["claims_created"] += 1
            elif ev.type == "DELETED":
                self.counts["claims_terminated"] += 1

    def _on_solve(self, ts, results) -> None:
        part = getattr(ts, "partition", (0, 0)) or (0, 0)
        self.solver_stats["passes"] += 1
        self.solver_stats["tensor_pods"] += part[0]
        self.solver_stats["host_pods"] += part[1]
        self.solver_stats["pod_errors"] += len(results.pod_errors)
        entry = dict(
            pods=part[0] + part[1],
            claims=len(results.new_nodeclaims),
            existing=sum(1 for en in results.existing_nodes if en.pods),
            errors=len(results.pod_errors),
            encode_kind=getattr(ts, "encode_kind", "cold"),
            fallback=getattr(ts, "fallback_reason", ""),
            trace_id=getattr(ts, "last_trace_id", ""))
        # the solve's fallback cost attribution: shape-class pod counts
        # are deterministic (digested — same seed, same escapes); the wall
        # split is measurement context and stays out of the ledger
        attr = getattr(ts, "fallback_attribution", None)
        if attr:
            classes = attr.get("classes") or {}
            for shape, pods in classes.items():
                self.fallback_classes[shape] = \
                    self.fallback_classes.get(shape, 0) + pods
            self.fallback_host_seconds += attr.get("host_seconds", 0.0)
            self.fallback_tensor_seconds += attr.get("tensor_seconds", 0.0)
            if classes:
                entry["fallbacks"] = dict(sorted(classes.items()))
        self.ledger.append(self._rel(), "solve", **entry)

    def _collect_breaches(self) -> None:
        # drain IN PLACE: the watcher's on_breach hook holds a reference
        # to this exact list's append — rebinding would orphan it
        fresh = self._fresh_breaches[:]
        del self._fresh_breaches[:]
        for b in fresh:
            self.breaches.append(b)
            self.ledger.append(b.at - self.t0, "breach", slo=b.slo,
                               budget=b.budget, trace_id=b.trace_id,
                               dump=b.dump_path)

    # -- workload model ------------------------------------------------------

    def _live_pods(self, w: _Workload) -> List[Pod]:
        from ..utils import pod as pod_utils
        return [p for p in self.op.store.list(Pod, namespace="default")
                if p.metadata.labels.get("app") == w.name
                and pod_utils.is_active(p)]

    def _reconcile_workloads(self) -> None:
        store = self.op.store
        for w in self.workloads.values():
            live = self._live_pods(w)
            # a pod bound to a VANISHED node (spot reclaim, zonal outage)
            # lost its kubelet: the workload controller replaces it
            for p in list(live):
                nn = p.spec.node_name
                if nn and store.get(Node, nn) is None:
                    store.delete(p)
                    live.remove(p)
                    self.counts["pods_replaced"] += 1
            if len(live) < w.replicas:
                for _ in range(w.replicas - len(live)):
                    store.create(w.make_pod())
            elif len(live) > w.replicas:
                # scale-down kills the newest generation/sequence first
                doomed = sorted(
                    live, key=lambda p: (w.pod_generation(p),
                                         p.metadata.name))
                for p in doomed[w.replicas:]:
                    store.delete(p)

    # -- event actuators -----------------------------------------------------

    def _apply_event(self, ev) -> None:
        t = self._rel()
        self.events_applied[ev.kind] += 1
        metrics.SIM_EVENTS_APPLIED.inc({"kind": ev.kind})
        getattr(self, f"_ev_{ev.kind}")(ev, t)

    def _ev_deploy(self, ev, t: float) -> None:
        w = _Workload(ev.name, ev.replicas, ev.cpu, ev.memory,
                      ev.params.get("spread"),
                      ev.params.get("capacity_type"), ev.params.get("zone"))
        self.workloads[ev.name] = w
        self.ledger.append(t, "event", event="deploy", name=ev.name,
                           replicas=ev.replicas)

    def _ev_scale(self, ev, t: float) -> None:
        self.workloads[ev.name].replicas = ev.replicas
        self.ledger.append(t, "event", event="scale", name=ev.name,
                           replicas=ev.replicas)

    def _ev_rolling_update(self, ev, t: float) -> None:
        w = self.workloads[ev.name]
        w.generation += 1
        target = w.generation
        batch, interval = ev.params["batch"], ev.params["interval"]
        self.ledger.append(t, "event", event="rolling_update", name=ev.name,
                           generation=target, batch=batch)

        def step():
            if w.generation != target:
                return  # superseded by a newer rollout
            old = sorted(
                (p for p in self._live_pods(w)
                 if w.pod_generation(p) < target),
                key=lambda p: (w.pod_generation(p), p.metadata.name))
            for p in old[:batch]:
                self.op.store.delete(p)
                self.counts["pods_replaced"] += 1
            if len(old) > batch:
                self._after(interval, step)
            else:
                self.ledger.append(self._rel(), "rollout_done", name=w.name,
                                   generation=target)

        step()

    def _ev_pdb(self, ev, t: float) -> None:
        self.op.store.create(PodDisruptionBudget(
            metadata=ObjectMeta(name=ev.name, namespace="default"),
            spec=PDBSpec(
                selector=LabelSelector(match_labels={"app": ev.app}),
                max_unavailable=ev.params.get("max_unavailable"),
                min_available=ev.params.get("min_available"))))
        self.ledger.append(t, "event", event="pdb", name=ev.name, app=ev.app)

    def _sim_nodes(self, zone: Optional[str] = None,
                   capacity_type: Optional[str] = None) -> List[Node]:
        out = []
        for n in self.op.store.list(Node):
            if not (n.spec.provider_id or "").startswith("kwok://"):
                continue
            labels = n.metadata.labels
            if zone and labels.get(api_labels.LABEL_TOPOLOGY_ZONE) != zone:
                continue
            if capacity_type and labels.get(
                    api_labels.CAPACITY_TYPE_LABEL_KEY) != capacity_type:
                continue
            out.append(n)
        return sorted(out, key=lambda n: n.metadata.name)

    def _reclaim_node(self, node: Node, reason: str) -> None:
        """Abrupt instance loss (spot interruption / zonal outage): the
        cloud takes the VM, the kubelet vanishes — no graceful drain. The
        claim is reaped by the garbage collector, the pods by the workload
        reconciler."""
        self.kwok.created.pop(node.spec.provider_id, None)
        node.metadata.finalizers = []
        self.op.store.delete(node)
        self.ledger.append(self._rel(), "reclaim", node=node.metadata.name,
                           reason=reason)

    def _ev_spot_reclaim(self, ev, t: float) -> None:
        spot = self._sim_nodes(zone=ev.params.get("zone"),
                               capacity_type=api_labels.CAPACITY_TYPE_SPOT)
        n = ev.params.get("count")
        if n is None:
            n = int(math.ceil(ev.params["fraction"] * len(spot)))
        doomed = self.rng.sample(spot, min(n, len(spot)))
        self.ledger.append(t, "event", event="spot_reclaim",
                           nodes=len(doomed))
        for node in sorted(doomed, key=lambda x: x.metadata.name):
            self._reclaim_node(node, "spot")

    def _ev_zonal_outage(self, ev, t: float) -> None:
        zone, duration = ev.zone, ev.params["duration"]
        self.chaos.exhaust(zone=zone, duration=duration, clock=self.clock)
        victims = self._sim_nodes(zone=zone) if ev.params["reclaim"] else []
        self.ledger.append(t, "event", event="zonal_outage", zone=zone,
                           duration=duration, nodes=len(victims))
        for node in victims:
            self._reclaim_node(node, "zonal_outage")

    def _ev_drought(self, ev, t: float) -> None:
        self.chaos.exhaust(instance_type=ev.params["instance_type"],
                           zone=ev.params["zone"],
                           capacity_type=ev.params["capacity_type"],
                           duration=ev.params["duration"], clock=self.clock)
        self.ledger.append(t, "event", event="drought",
                           pattern="/".join((ev.params["instance_type"],
                                             ev.params["zone"],
                                             ev.params["capacity_type"])),
                           duration=ev.params["duration"])

    def _ev_drain(self, ev, t: float) -> None:
        nodes = [n for n in self._sim_nodes(zone=ev.params.get("zone"))
                 if n.metadata.deletion_timestamp is None]
        nodes.sort(key=lambda n: (n.metadata.creation_timestamp,
                                  n.metadata.name))
        doomed = nodes[:ev.params["count"]]
        self.ledger.append(t, "event", event="drain",
                           nodes=[n.metadata.name for n in doomed])
        for node in doomed:
            # graceful: deletionTimestamp only — the termination
            # controller taints, drains under PDB limits, then releases
            # the finalizer
            self.op.store.delete(node)

    def _sim_claims(self, zone: Optional[str] = None) -> List[NodeClaim]:
        """Live kwok-backed claims, oldest first — the deterministic wave
        target order for drift/expiration events."""
        out = []
        for nc in self.op.store.list(NodeClaim):
            if not (nc.status.provider_id or "").startswith("kwok://"):
                continue
            if nc.metadata.deletion_timestamp is not None:
                continue
            if zone and nc.metadata.labels.get(
                    api_labels.LABEL_TOPOLOGY_ZONE) != zone:
                continue
            out.append(nc)
        return sorted(out, key=lambda nc: (nc.metadata.creation_timestamp,
                                           nc.metadata.name))

    def _wave_targets(self, ev) -> List[NodeClaim]:
        claims = self._sim_claims(zone=ev.params.get("zone"))
        n = ev.params.get("count")
        if n is None:
            n = int(math.ceil(ev.params["fraction"] * len(claims)))
        return claims[:min(n, len(claims))]

    def _ev_drift(self, ev, t: float) -> None:
        """Drift wave: stamp a stale nodepool-hash annotation onto the
        targeted claims — the NodeClaimDisruptionMarker controller flags
        them Drifted through its normal static-drift path, and the Drift
        method replaces them under the pool's disruption budgets."""
        from ..api.nodepool import NODEPOOL_HASH_VERSION
        doomed = self._wave_targets(ev)
        for nc in doomed:
            nc.metadata.annotations[
                api_labels.NODEPOOL_HASH_ANNOTATION_KEY] = "sim-drift-wave"
            nc.metadata.annotations[
                api_labels.NODEPOOL_HASH_VERSION_ANNOTATION_KEY] = \
                NODEPOOL_HASH_VERSION
            self.op.store.update(nc)
        self.ledger.append(t, "event", event="drift", claims=len(doomed))

    def _ev_expire(self, ev, t: float) -> None:
        """Expiration wave: give the targeted claims a finite expireAfter
        so the expiration controller retires them as they age out — a
        rolling graceful replacement front."""
        doomed = self._wave_targets(ev)
        for nc in doomed:
            nc.spec.expire_after = ev.params["expire_after"]
            self.op.store.update(nc)
        self.ledger.append(t, "event", event="expire", claims=len(doomed),
                           expire_after=ev.params["expire_after"])

    def _ev_flaky(self, ev, t: float) -> None:
        rate, duration = ev.params["rate"], ev.params["duration"]
        # window stack, the _ev_slo shape: an earlier window's close must
        # restore the most recently opened still-active window's rates,
        # not unconditionally calm a timeline another window still owns
        window = {"rate": rate, "terminal_rate": ev.params["terminal_rate"]}
        self._flaky_windows.append(window)
        self.injector.rate = window["rate"]
        self.injector.terminal_rate = window["terminal_rate"]
        self.ledger.append(t, "event", event="flaky", rate=rate,
                           duration=duration)

        def calm():
            self._flaky_windows.remove(window)
            live = (self._flaky_windows[-1] if self._flaky_windows
                    else {"rate": 0.0, "terminal_rate": 0.0})
            self.injector.rate = live["rate"]
            self.injector.terminal_rate = live["terminal_rate"]
            self.ledger.append(self._rel(), "flaky_end")

        self._after(duration, calm)

    def _ev_wire_chaos(self, ev, t: float) -> None:
        """Wire-fault window on the solver gRPC channel (scenario
        validation guarantees backend=sidecar). The same window-stack
        shape as `flaky`/`slo`: an earlier window's close restores the
        most recently opened still-active window's rates."""
        inj = self.wire_injector
        p = ev.params
        if p["kill_server"]:
            # fleet: the scenario's `replica` index picks the victim
            # (modulo the fleet size, so the same scenario runs at any
            # replica count); legacy single-server mode ignores it
            idx = (int(p.get("replica", 0)) % len(self.sidecar_replicas)
                   if self.fleet else 0)
            self._restart_sidecar(idx)
        window = {k: p[k] for k in ("drop", "delay", "duplicate",
                                    "disconnect", "delay_seconds")}
        self._wire_windows.append(window)
        inj.set_rates(**window)
        self.ledger.append(t, "event", event="wire_chaos", drop=p["drop"],
                           delay=p["delay"], duplicate=p["duplicate"],
                           disconnect=p["disconnect"],
                           kill_server=p["kill_server"],
                           duration=p["duration"])

        def calm():
            self._wire_windows.remove(window)
            live = (self._wire_windows[-1] if self._wire_windows else
                    {"drop": 0.0, "delay": 0.0, "duplicate": 0.0,
                     "disconnect": 0.0,
                     "delay_seconds": inj.delay_seconds})
            inj.set_rates(**live)
            self.ledger.append(self._rel(), "wire_chaos_end")

        self._after(p["duration"], calm)

    def _restart_sidecar(self, idx: int = 0, ledgered: bool = True) -> None:
        """Server-kill fault: the listener dies and every session dies
        with it (the session table is per-replica state), then a fresh
        server binds the same port. Clients must recover transparently —
        UNAVAILABLE retries while the listener is down, then either a warm
        handoff-store restore (fleet) or NOT_FOUND -> session recreate +
        full resync (legacy single server). `ledgered=False` is the
        rolling-restart path: its per-replica restarts are intentionally
        absent from the ledger, which must stay byte-identical across
        replica counts (the scenario-level event entry IS ledgered)."""
        from ..sidecar import server as sidecar_server
        if self.fleet:
            entry = self.sidecar_replicas[idx]
            server, port, rep = entry
            done = server.stop(0)
            if done is not None:
                done.wait(5.0)
            with rep.sessions_lock:
                rep.sessions.clear()
            new_server, new_port = sidecar_server.serve(port=port,
                                                        replica=rep,
                                                        device=self.device)
            if new_port != port:
                # a silent rebind failure (add_insecure_port returns 0)
                # would surface as an unrelated retry-exhaustion RpcError
                # minutes later — name the replica loudly instead
                raise RuntimeError(
                    f"sidecar replica-{idx} restart could not rebind "
                    f"127.0.0.1:{port} (got port {new_port}): the "
                    "kill_server window cannot be simulated")
            entry[0] = new_server
            if idx == 0:
                self.sidecar_server = new_server
            if ledgered:
                # `replica` is volatile (report.VOLATILE_KEYS): the victim
                # index depends on the fleet size, and the digest must not
                self.ledger.append(self._rel(), "sidecar_restart",
                                   replica=idx)
            return
        done = self.sidecar_server.stop(0)
        if done is not None:
            done.wait(5.0)
        with sidecar_server._SESSIONS_LOCK:
            sidecar_server._SESSIONS.clear()
        port = self._sidecar_port
        self.sidecar_server, self._sidecar_port = sidecar_server.serve(
            port=port, device=self.device)
        if self._sidecar_port != port:
            # the client still dials the old address; a silent rebind
            # failure (add_insecure_port returns 0) would surface as an
            # unrelated retry-exhaustion RpcError minutes later
            raise RuntimeError(
                f"sidecar restart could not rebind 127.0.0.1:{port} "
                f"(got port {self._sidecar_port}): the kill_server "
                "window cannot be simulated")
        self.ledger.append(self._rel(), "sidecar_restart")

    def _ev_rolling_restart(self, ev, t: float) -> None:
        """Zero-downtime rolling restart of the whole fleet (scenario
        validation guarantees fleet mode): replica i drains at
        t + i*interval — exporting every session checkpoint to the handoff
        store — then restarts on the same port. A tenant whose solve lands
        mid-drain follows the NACK's migrated_to rider to a peer and
        resumes warm; one whose replica already restarted is restored from
        its checkpoint on first contact. Per-replica restarts are NOT
        ledgered (their count depends on the fleet size; the digest must
        not) — only this scenario event entry is."""
        p = ev.params
        interval = p["interval"]
        grace = p["drain_grace"]
        self.ledger.append(t, "event", event="rolling_restart",
                           interval=interval, drain_grace=grace)

        def restart(idx):
            self.sidecar_replicas[idx][0].drain(grace)
            self._restart_sidecar(idx, ledgered=False)
            self.fleet_restarts += 1

        restart(0)
        for i in range(1, len(self.sidecar_replicas)):
            self._after(i * interval, lambda idx=i: restart(idx))

    def _ev_corrupt_state(self, ev, t: float) -> None:
        """Seeded warm-state corruption. NOT ledgered: the acceptance
        contract is ledger-digest equality with the fault-free run — the
        auditor must detect the fault before the corrupt entry is served
        and quarantine-heal it without any decision difference, so the
        only admissible trace is metrics/events, never the ledger."""
        prov = self.op.provisioner
        self.state_corruptor.corrupt(prov.state_plane,
                                     handle=prov.problem_state,
                                     layer=ev.params["layer"],
                                     count=ev.params["count"])

    def _ev_kill_device(self, ev, t: float) -> None:
        """Device-loss window: mesh slot `device` (modulo the mesh's slot
        count) dies now and revives after `duration`. NOT ledgered — the
        degradation ladder must keep the decisions (hence the ledger
        digest) identical to the fault-free run."""
        ids = sorted(int(s.id) for s in self.mesh.devices.flat)
        dev = ids[ev.params["device"] % len(ids)]
        self.device_killer.kill(dev)
        self._after(ev.params["duration"],
                    lambda: self.device_killer.revive(dev))

    def _ev_slo(self, ev, t: float) -> None:
        watcher = self.op.slo
        budgets = dict(ev.params["budgets"])
        window = {"budgets": budgets}
        self._slo_windows.append(window)
        watcher.budgets = dict(budgets)
        self.ledger.append(t, "event", event="slo",
                           budgets={k: budgets[k] for k in sorted(budgets)})
        duration = ev.params.get("duration")
        if duration is not None:
            def close():
                self._slo_windows.remove(window)
                watcher.budgets = dict(
                    self._slo_windows[-1]["budgets"] if self._slo_windows
                    else self._slo_baseline)
                self.ledger.append(self._rel(), "slo_end")
            self._after(duration, close)

    # -- main loop -----------------------------------------------------------

    def _boot(self) -> None:
        for pool in self.scenario.nodepools:
            self.op.store.create(NodePool(
                metadata=ObjectMeta(name=pool.name),
                spec=NodePoolSpec(
                    template=NodeClaimTemplate(spec=NodeClaimTemplateSpec()),
                    disruption=Disruption(
                        consolidate_after=pool.consolidate_after),
                    weight=pool.weight)))

    def run(self) -> dict:
        try:
            return self._run()
        finally:
            if self.device_killer is not None:
                # restore the process-global chaos hook and drop the
                # per-device breakers this run may have opened — device
                # identity (and with it breaker state) outlives the sim
                from ..ops import binpack
                from ..parallel import mesh as _mesh
                binpack.install_device_chaos(self._prev_device_chaos)
                _mesh.reset_device_breakers()
            if self.sidecar_server is not None:
                if self.solver_session is not None:
                    self.solver_session.close()
                if self.fleet:
                    # every replica's server + session table is per-replica
                    # state: stop and clear each one (a single-server clear
                    # would leak the siblings' fleet-sized ProblemStates)
                    for entry in self.sidecar_replicas:
                        entry[0].stop(0)
                        rep = entry[2]
                        with rep.sessions_lock:
                            rep.sessions.clear()
                    self.sidecar_replicas = []
                    self.sidecar_server = None
                else:
                    self.sidecar_server.stop(0)
                    self.sidecar_server = None
                    # the session table is process-global and this server's
                    # idle-GC reaper died with it: drop the run's sessions
                    # (each holds a fleet-sized ProblemState) instead of
                    # leaking them for the life of the process
                    from ..sidecar import server as sidecar_server
                    with sidecar_server._SESSIONS_LOCK:
                        sidecar_server._SESSIONS.clear()
            from ..obs.tracer import TRACER
            enabled, capacity, watcher = self._tracer_was
            TRACER.enabled, TRACER.watcher = enabled, watcher
            TRACER.set_capacity(capacity)
            gc_enabled, frozen = self._gc_was
            if not frozen:
                gc.unfreeze()
            (gc.enable if gc_enabled else gc.disable)()

    def _run(self) -> dict:
        wall0 = time.perf_counter()
        # per-subsystem attribution baseline: the phase histogram is
        # process-global, so the run's share is the delta from here
        phase_base = metrics.phase_seconds_by_name()
        self._boot()
        self._running = True
        sc = self.scenario
        timeline = deque(sorted(
            ((e.at, i, e) for i, e in enumerate(sc.events)),
            key=lambda x: (x[0], x[1])))
        end = self.t0 + sc.duration
        while True:
            now = self.clock.now()
            while timeline and self.t0 + timeline[0][0] <= now:
                self._apply_event(timeline.popleft()[2])
            while self._actions and self._actions[0][0] <= now:
                heapq.heappop(self._actions)[2]()
            self._reconcile_workloads()
            self.op.step()
            self._collect_breaches()
            metrics.SIM_TICKS.inc()
            metrics.SIM_CLOCK_SECONDS.set(now - self.t0)
            if now >= end:
                break
            # adaptive stepping: jump to the next interesting instant
            nxt = now + sc.tick
            if timeline:
                nxt = min(nxt, self.t0 + timeline[0][0])
            if self._actions:
                nxt = min(nxt, self._actions[0][0])
            mt = self.op.manager.next_timer_at()
            if mt is not None:
                nxt = min(nxt, mt)
            for paced in self._paced:
                if paced.next_due > now:
                    nxt = min(nxt, paced.next_due)
            batcher = self.op.provisioner.batcher
            if batcher._first is not None:
                nxt = min(nxt, now + batcher.time_until_ready())
            nxt = min(max(nxt, now + MIN_STEP_SECONDS), end)
            self._integrate(nxt - now)
            self.clock.set_time(nxt)
        self._running = False
        self.sim_seconds = self.clock.now() - self.t0
        self.wall_seconds = time.perf_counter() - wall0
        phase_now = metrics.phase_seconds_by_name()
        self.phase_attribution = {
            k: round(max(0.0, phase_now.get(k, 0.0) - phase_base.get(k, 0.0)),
                     6)
            for k in phase_now}
        store = self.op.store
        self.final_state = {
            "nodes": len(store.list(Node)),
            "claims": len(store.list(NodeClaim)),
            "pods_bound": self._bound_count,
            "pods_pending": sum(1 for p in store.list(Pod)
                                if not p.spec.node_name),
        }
        report = build_report(self)
        log.info("scenario replayed", scenario=sc.name,
                 sim_hours=round(self.sim_seconds / 3600.0, 2),
                 wall_seconds=round(self.wall_seconds, 1),
                 compression=report["compression"],
                 ledger_digest=report["ledger_digest"][:16])
        return report

    def _integrate(self, dt: float) -> None:
        """Accumulate cost and pod-hours over a constant-state interval
        (fleet composition only changes at step boundaries)."""
        hours = dt / 3600.0
        cost = self._cost_rate * hours
        pod_hours = self._bound_count * hours
        self.fleet_cost += cost
        self.pod_hours += pod_hours
        if cost:
            metrics.SIM_FLEET_COST.inc(value=cost)
        if pod_hours:
            metrics.SIM_POD_HOURS.inc(value=pod_hours)
