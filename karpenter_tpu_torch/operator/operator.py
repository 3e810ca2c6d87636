"""Operator: wires store, state, and every controller into one runtime.

Mirrors karpenter's pkg/operator/operator.go:105-206 (bootstrap) and
pkg/controllers/controllers.go:61-111 (the full controller roster). The
deterministic manager replaces controller-runtime; `run()` drives it in real
time against a cloud provider (kwok by default), `step()` drives it under a
fake clock for tests and simulations. Every in-process solve, the disruption
snapshot's included, runs its feasibility precompute on ``device``: ``cuda``
unless the caller names another; ``"cpu"`` runs the kernels' plain PyTorch
versions. With ``solver_backend="sidecar"`` the provisioning solves go to
the solver sidecar at ``solver_address`` (sidecar/server.py, on its own
device) through one SolverSession for the operator's lifetime.
"""

from __future__ import annotations

from typing import Optional

from ..cloudprovider.kwok import KwokCloudProvider
from ..controllers.hydration import NodeClaimHydration, NodeHydration
from ..controllers.manager import Manager
from ..controllers.metrics_exporters import NodeMetrics, PodMetrics
from ..controllers.node_health import NodeHealth
from ..controllers.node_termination import NodeTermination
from ..controllers.nodeclaim_aux import (Consistency, Expiration,
                                         GarbageCollection, PodEvents)
from ..controllers.nodeclaim_disruption import NodeClaimDisruptionMarker
from ..controllers.nodeclaim_lifecycle import NodeClaimLifecycle
from ..controllers.nodepool_aux import (NodePoolCounter, NodePoolHash,
                                        NodePoolReadiness, NodePoolValidation)
from ..cloudprovider.metrics import decorate as decorate_cloud_provider
from ..disruption.controller import DisruptionController, OrchestrationQueue
from ..events.recorder import Recorder
from ..kube.store import Store
from ..logging import configure as configure_logging, get_logger
from ..provisioning.provisioner import Binder, NodeDeletionTrigger, PodTrigger, Provisioner
from ..state.cluster import Cluster
from ..state.informers import wire_informers
from ..utils.clock import Clock
from .options import Options
from .server import ServingGroup


class Operator:
    def __init__(self, options: Optional[Options] = None, cloud_provider=None,
                 clock: Optional[Clock] = None, device=None):
        from ..ops.binpack import resolve_device
        self.options = options or Options()
        # checked before the tracer is configured too: with CUDA asked for
        # and absent the boot fails here and never runs on the CPU. The
        # sidecar backend needs it as well: the disruption loop's
        # precompute runs in this process
        self.device = resolve_device(device)
        configure_logging(self.options.log_level)
        self.log = get_logger("operator")
        self.clock = clock or Clock()
        if self.options.store_backend == "kube":
            from ..kube.apiserver import KubeApiStore
            self.store = KubeApiStore.from_kubeconfig(
                self.options.kubeconfig or None, clock=self.clock)
        else:
            self.store = Store(self.clock)
        self.cluster = Cluster(self.store, self.clock)
        wire_informers(self.store, self.cluster)
        # capacity-failure feedback: launch ICEs mark offering keys here
        # (nodeclaim lifecycle), both solvers mask live entries out of
        # their offering tensors, and providers that support it skip dry
        # offerings at create — one registry closes the whole loop
        from ..state.unavailable import UnavailableOfferings
        self.unavailable = UnavailableOfferings(clock=self.clock)
        # every SPI call is timed + error-counted (cloudprovider/metrics.py)
        raw_provider = cloud_provider or KwokCloudProvider(store=self.store)
        if hasattr(raw_provider, "unavailable"):
            raw_provider.unavailable = self.unavailable
        self.cloud_provider = decorate_cloud_provider(raw_provider)
        self.recorder = Recorder(self.clock)
        if self.options.store_backend == "kube":
            # publish real v1.Event objects through the adapter so operators
            # see karpenter's narrative in `kubectl get events` — buffered
            # off-thread (the reference's client-go event-broadcaster path):
            # a slow apiserver must never stall the reconcile loop
            from ..events.recorder import AsyncSink
            self.recorder.sink = AsyncSink(self.store.post_event)
        self.manager = Manager(self.store, self.clock,
                               recorder=self.recorder)
        # decision flight recorder: provisioning solves + disruption
        # decisions land in one bounded ring, served at
        # /debug/flightrecorder and replayable offline (flightrec/)
        self.flightrec = None
        if self.options.flightrec_ring > 0:
            from ..flightrec import FlightRecorder
            self.flightrec = FlightRecorder(
                capacity=self.options.flightrec_ring, clock=self.clock)
        # pass tracer + SLO watcher (obs/): the tracer is process-wide (the
        # instrumented hot paths reach it directly), so this operator
        # CONFIGURES it — ring size, enabled flag — and owns the single
        # watcher slot (re-wiring replaces any previous operator's watcher;
        # tests construct many operators per process)
        from ..obs.tracer import TRACER
        if self.options.slo_budgets and self.options.trace_ring <= 0:
            # an SLO that can never fire (no traces complete with the
            # tracer off) is worse than a boot failure — same philosophy as
            # parse_budgets rejecting typo'd entries. Checked BEFORE any
            # tracer mutation so a failed boot leaves the process-wide
            # tracer untouched.
            raise ValueError(
                "--slo-budgets requires --trace-ring > 0: SLO breaches "
                "are detected on completed pass traces")
        self.tracer = TRACER
        TRACER.enabled = self.options.trace_ring > 0
        if self.options.trace_ring > 0:
            TRACER.set_capacity(self.options.trace_ring)
        self.slo = None
        if self.options.slo_budgets:
            from ..obs.slo import SLOWatcher, parse_budgets
            self.slo = SLOWatcher(parse_budgets(self.options.slo_budgets),
                                  recorder=self.recorder,
                                  flightrec=self.flightrec,
                                  clock=self.clock)
        TRACER.watcher = self.slo
        self.serving: Optional[ServingGroup] = None

        gates = self.options.gates
        scheduler_factory = None
        self.solver_session = None
        if self.options.solver_backend == "sidecar":
            from ..sidecar.client import RemoteScheduler, SolverSession
            address = self.options.solver_address
            # one persistent session for the operator's lifetime: the
            # catalog/nodepools ride the wire once, state nodes as deltas
            self.solver_session = SolverSession(address)
            session = self.solver_session

            def scheduler_factory(nodepools, instance_types, state_nodes,
                                  daemonset_pods, cluster):
                return RemoteScheduler(address, nodepools, instance_types,
                                       state_nodes=state_nodes,
                                       daemonset_pods=daemonset_pods,
                                       cluster=cluster, session=session)
        self.provisioner = Provisioner(self.store, self.cluster,
                                       self.cloud_provider, self.clock,
                                       scheduler_factory=scheduler_factory,
                                       recorder=self.recorder,
                                       flight_recorder=self.flightrec,
                                       unavailable=self.unavailable,
                                       device=self.device)
        self.provisioner.batcher.idle = self.options.batch_idle_duration
        self.provisioner.batcher.max_duration = self.options.batch_max_duration
        self.queue = OrchestrationQueue(self.store, self.cluster, self.clock,
                                        recorder=self.recorder)
        self.disruption = DisruptionController(
            self.store, self.cluster, self.provisioner, self.queue, self.clock,
            spot_to_spot_enabled=gates.spot_to_spot_consolidation,
            recorder=self.recorder, flight_recorder=self.flightrec)

        controllers = [
            self.provisioner,
            PodTrigger(self.provisioner),
            NodeDeletionTrigger(self.provisioner),
            Binder(self.store, self.cluster, self.provisioner),
            self.queue,
            self.disruption,
            NodeClaimLifecycle(self.store, self.cluster, self.cloud_provider,
                               self.clock, recorder=self.recorder,
                               unavailable=self.unavailable,
                               trigger=self.provisioner.trigger),
            NodeClaimDisruptionMarker(self.store, self.cluster,
                                      self.cloud_provider, self.clock),
            NodeTermination(self.store, self.cluster, self.clock,
                            cloud_provider=self.cloud_provider,
                            recorder=self.recorder),
            Expiration(self.store, self.clock),
            GarbageCollection(self.store, self.cloud_provider, self.clock),
            PodEvents(self.store, self.cluster, self.clock),
            Consistency(self.store, self.recorder, self.clock),
            NodePoolHash(self.store),
            NodePoolCounter(self.store, self.cluster),
            NodePoolValidation(self.store),
            NodePoolReadiness(self.store, self.cloud_provider),
            PodMetrics(self.store, self.cluster, self.clock),
            NodeMetrics(self.store, self.cluster),
            NodeClaimHydration(self.store),
            NodeHydration(self.store),
        ]
        if self.options.enable_profiling:
            import os
            import tempfile
            self.provisioner.profile_dir = os.path.join(
                tempfile.gettempdir(), "karpenter-tpu-profile")
        if gates.node_repair:
            controllers.append(NodeHealth(self.store, self.cluster,
                                          self.cloud_provider, self.clock,
                                          recorder=self.recorder))
        kwok_delegate = self.cloud_provider
        while kwok_delegate is not None and \
                not isinstance(kwok_delegate, KwokCloudProvider):
            # unwrap the whole decorator stack (metrics over chaos over
            # kwok, sim/engine.py's shape), not just one level
            kwok_delegate = getattr(kwok_delegate, "_delegate", None)
        if self.options.kwok_kubelet and kwok_delegate is not None:
            # the simulated fleet needs a kubelet analog to clear startup/
            # ephemeral taints and stamp Ready (out-of-band machinery in the
            # reference's kwok environment); --kwok-kubelet=false for
            # scenarios asserting on pre-initialization taint states
            from ..cloudprovider.kwok import KwokKubelet
            controllers.append(KwokKubelet(
                self.store, self.clock,
                ready_delay=self.options.kwok_ready_delay))
        self.manager.register(*controllers)

        # restart = resync (cluster.go:96-150): replay the durable snapshot
        # through the watch fan-out AFTER controllers are registered, so the
        # cluster cache rebuilds and every object re-reconciles
        self._saved_rv = -1
        if self.options.state_file:
            import os
            if os.path.exists(self.options.state_file):
                try:
                    n = self.store.load(self.options.state_file)
                except Exception as exc:
                    # a corrupt snapshot must not crash-loop the operator;
                    # restart = resync means booting fresh is always legal
                    self.log.error("snapshot unreadable, booting fresh",
                                   file=self.options.state_file,
                                   error=str(exc))
                else:
                    resync = getattr(self.cloud_provider, "resync", None)
                    recovered = resync() if resync is not None else 0
                    self.log.info("restored state from snapshot",
                                  file=self.options.state_file, objects=n,
                                  cloud_instances=recovered,
                                  synced=self.cluster.synced())

    # -- serving (operator.go:142-175) --------------------------------------

    def start_serving(self) -> ServingGroup:
        """Start the /metrics + healthz/readyz HTTP servers on the
        configured ports (port 0 = ephemeral, for tests)."""
        if self.serving is None:
            self.serving = ServingGroup(
                self.options.metrics_port, self.options.health_probe_port,
                healthy=lambda: True,
                ready=lambda: self.cluster.synced(),
                profiling=self.options.enable_profiling,
                manager=self.manager, flightrec=self.flightrec,
                unavailable=self.unavailable,
                tracer=self.tracer if self.options.trace_ring > 0 else None,
                slo=self.slo).start()
            self.log.info("serving metrics and health probes",
                          metrics_port=self.serving.metrics_port,
                          health_port=self.serving.health_port)
        return self.serving

    def stop_serving(self) -> None:
        if self.serving is not None:
            self.serving.stop()
            self.serving = None

    def checkpoint(self) -> None:
        """Persist the store when a state file is configured; no-op while
        nothing changed since the last save (resourceVersion watermark)."""
        if self.options.state_file and self.store._rv != self._saved_rv:
            self.store.save(self.options.state_file)
            self._saved_rv = self.store._rv

    # -- drive --------------------------------------------------------------

    def step(self) -> bool:
        """One full pass: watch fallout + singleton loops (tests/sim).
        Returns whether the manager quiesced (run_until_quiet)."""
        return self.manager.run_until_quiet()

    def _lease(self):
        """Leader-election lease when enabled (operator.go:137-141)."""
        if not self.options.leader_elect:
            return None
        import os
        import socket
        import uuid
        from .leaderelection import FileLease
        path = self.options.lease_file or \
            (self.options.state_file or "karpenter-tpu") + ".lease"
        # pid + random suffix: two replicas (even forked, same heap layout)
        # must never share an identity — FileLease treats a matching holder
        # as "already mine", so a collision would be split-brain
        identity = (f"{socket.gethostname()}-{os.getpid()}-"
                    f"{uuid.uuid4().hex[:8]}")
        if self.options.store_backend == "kube":
            # multi-replica HA: the coordination API's resourceVersion CAS
            # is the serialization point (operator.go:137-141) — the fcntl
            # FileLease only serializes within one host
            from ..kube.apiserver import KubeApiStore
            from .leaderelection import KubeLease
            if isinstance(self.store, KubeApiStore):
                return KubeLease(self.store, identity,
                                 lease_duration=self.options.lease_duration,
                                 clock=self.clock)
        return FileLease(path, identity,
                         lease_duration=self.options.lease_duration,
                         clock=self.clock)

    def _start_renewal(self, lease):
        """Background lease renewal, independent of reconcile duration: a
        reconcile pass longer than the lease duration must not let a
        standby steal the lease mid-pass (client-go renews on its own
        goroutine with renewDeadline < leaseDuration for the same reason).
        Sets _lease_lost when a renewal fails; _renew_deadline_passed()
        additionally covers a wedged renewal thread — client-go aborts
        leadership when RenewDeadline elapses without a successful renew,
        even if no renew attempt ever returned."""
        import threading
        lost = self._lease_lost = threading.Event()
        stop = self._renew_stop = threading.Event()
        # 2/3 of the lease, mirroring client-go's 15 s lease / 10 s renew
        # deadline ratio: leadership is surrendered BEFORE the lease can
        # legitimately be stolen by a standby
        self._renew_deadline = lease.lease_duration * (2.0 / 3.0)
        self._last_renew = lease.clock.now()

        def loop():
            # the closure captures ITS OWN events: a thread that wedged past
            # its deadline and later unwedges must not renew against (or
            # flip the lost flag of) a successor generation's events
            period = max(0.2, lease.lease_duration / 3.0)
            while not stop.wait(period):
                try:
                    if not lease.renew():
                        lost.set()
                        return
                except Exception:
                    lost.set()
                    return
                if stop.is_set() or self._renew_stop is not stop:
                    return  # stood down while this renew was in flight
                self._last_renew = lease.clock.now()

        t = threading.Thread(target=loop, daemon=True,
                             name="karpenter-lease-renewal")
        self._renew_thread = t
        t.start()
        return t

    def _renew_deadline_passed(self, lease) -> bool:
        return (lease.clock.now() - self._last_renew) > self._renew_deadline

    def _stop_renewal(self) -> None:
        ev = getattr(self, "_renew_stop", None)
        if ev is not None:
            ev.set()

    def run(self, stop=None, tick_seconds: float = 1.0) -> None:
        """Real-time loop (kwok/main.go:33-48 equivalent). With leader
        election enabled, probes/metrics serve immediately but controllers
        only run while this process holds the lease — a standby that
        acquires it (crash or graceful release of the leader) takes over."""
        self.log.info("starting operator",
                      cluster_name=self.options.cluster_name,
                      solver_backend=self.options.solver_backend,
                      feature_gates=self.options.feature_gates)
        self.start_serving()
        start_watches = getattr(self.store, "start_watches", None)
        if start_watches is not None:
            start_watches()
        lease = self._lease()
        leading = lease is None
        try:
            while stop is None or not stop():
                if lease is not None:
                    lease_ref = getattr(lease, "path", None) or \
                        getattr(lease, "name", "")
                    if leading and (self._lease_lost.is_set()
                                    or self._renew_deadline_passed(lease)):
                        self.log.error("lost leadership lease; standing by",
                                       lease=lease_ref)
                        self._stop_renewal()
                        leading = False
                    # after a stand-down, do not re-acquire while the old
                    # renewal thread is still alive (wedged in renew()):
                    # try_acquire would re-renew our own still-valid lease
                    # and flip-flop leadership with an untrustworthy renewal
                    # mechanism. If the thread never exits, the lease expires
                    # naturally and a healthy standby takes over.
                    prev = getattr(self, "_renew_thread", None)
                    if not leading and (prev is None or not prev.is_alive()):
                        try:
                            acquired = lease.try_acquire()
                        except Exception as exc:
                            # a transient apiserver/network error must not
                            # kill a standby — keep polling (client-go
                            # retries acquire indefinitely)
                            self.log.error("lease acquire attempt failed",
                                           lease=lease_ref, error=str(exc))
                            acquired = False
                        if acquired:
                            self.log.info("acquired leadership",
                                          lease=lease_ref,
                                          identity=lease.identity)
                            leading = True
                            self._start_renewal(lease)
                # apiserver backend: watch streams queue events on their own
                # threads; deliver them HERE so the deterministic single-
                # dispatch model holds (kube/apiserver.py). Standbys pump
                # too — informers stay warm for fast takeover and the queue
                # stays bounded (client-go runs informers on non-leaders for
                # the same reason); only reconciling is leader-gated.
                pump = getattr(self.store, "pump_events", None)
                if pump is not None:
                    pump()
                if leading:
                    self.manager.run_until_quiet()
                    self.checkpoint()
                # the injected clock paces the loop: real Clock sleeps wall
                # time; a FakeClock parks on its condition variable until a
                # simulator thread advances it (sim/ drives run() this way)
                self.clock.sleep(tick_seconds)
        finally:
            self._stop_renewal()
            try:
                if leading:
                    self.checkpoint()
            except Exception as exc:  # must not mask the loop's exception
                self.log.error("final checkpoint failed", error=str(exc))
            if lease is not None and leading:
                try:
                    lease.release()
                except Exception as exc:  # ditto: never mask or block exit
                    self.log.error("lease release failed", error=str(exc))
            self.stop_serving()

    def metrics_text(self) -> str:
        from ..metrics.registry import REGISTRY
        return REGISTRY.expose()
