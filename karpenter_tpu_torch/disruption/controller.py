"""Disruption controller + orchestration queue.

Mirrors karpenter's pkg/controllers/disruption/controller.go and
orchestration/queue.go: a 10s singleton loop trying methods in order
Drift -> Emptiness -> MultiNodeConsolidation -> SingleNodeConsolidation,
first success wins (:84-94,137-149); execution taints candidates, launches
replacements, marks for deletion, and hands the command to the async queue,
which waits for replacements to initialize before deleting the candidates,
rolling back (untaint + unmark) on timeout (queue.go:163-281).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..api import labels as api_labels
from ..api.nodeclaim import NodeClaim
from ..api.objects import Node
from ..controllers.manager import Result, SingletonController
from ..events import catalog as events_catalog
from ..kube.store import Store
from ..logging import get_logger
from ..obs.tracer import TRACER
from ..provisioning.provisioner import Provisioner
from ..scheduling.taints import DISRUPTED_NO_SCHEDULE_TAINT
from ..state.cluster import Cluster
from ..utils.backoff import ItemBackoff
from ..utils.clock import Clock
from .methods import (Drift, Emptiness, Method, MultiNodeConsolidation,
                      SingleNodeConsolidation)
from .types import Command
from .validation import CONSOLIDATION_TTL_SECONDS, validate_command

POLL_INTERVAL_SECONDS = 10.0         # controller.go:68
COMMAND_TIMEOUT_SECONDS = 10 * 60.0  # queue.go commandTimeout

log = get_logger("disruption")


@dataclass
class QueuedCommand:
    command: Command
    replacement_names: List[str]
    enqueued_at: float
    provider_ids: List[str] = field(default_factory=list)
    next_at: float = 0.0  # rate-limited retry gate

    @property
    def key(self) -> tuple:
        return tuple(self.provider_ids)


QUEUE_BASE_DELAY = 1.0   # orchestration/queue.go:51
QUEUE_MAX_DELAY = 10.0   # orchestration/queue.go:52


class OrchestrationQueue(SingletonController):
    """orchestration/queue.go:108-281 (deterministic-runtime version).
    Commands still waiting on replacements retry with per-item exponential
    backoff (queue.go:128-132: 1s base / 10s cap) instead of a flat 1s."""

    name = "disruption.queue"

    def __init__(self, store: Store, cluster: Cluster,
                 clock: Optional[Clock] = None, recorder=None):
        from ..events.recorder import Recorder
        self.store = store
        self.cluster = cluster
        self.clock = clock or store.clock
        self.recorder = recorder or Recorder(self.clock)
        self.items: List[QueuedCommand] = []
        self._backoff = ItemBackoff(QUEUE_BASE_DELAY, QUEUE_MAX_DELAY)

    def has_any(self, provider_id: str) -> bool:
        return any(provider_id in qc.provider_ids for qc in self.items)

    def add(self, qc: QueuedCommand) -> None:
        qc.provider_ids = [c.provider_id for c in qc.command.candidates]
        self.items.append(qc)

    def reconcile(self) -> Optional[Result]:
        now = self.clock.now()
        remaining: List[QueuedCommand] = []
        delays: List[float] = []
        for qc in self.items:
            if qc.next_at > now:
                remaining.append(qc)
                delays.append(qc.next_at - now)
                continue
            state = self._process(qc)
            if state == "wait":
                delay = self._backoff.next_delay(qc.key)
                qc.next_at = now + delay
                remaining.append(qc)
                delays.append(delay)
            else:
                self._backoff.forget(qc.key)
        self.items = remaining
        return Result(requeue_after=min(delays)) if remaining else None

    def _process(self, qc: QueuedCommand) -> str:
        if self.clock.now() - qc.enqueued_at > COMMAND_TIMEOUT_SECONDS:
            self._rollback(qc)
            return "done"
        for name in qc.replacement_names:
            nc = self.store.get(NodeClaim, name)
            if nc is None:
                # replacement died (launch failure / liveness): roll back
                self._rollback(qc)
                return "done"
            # queue.go:243-249: narrate replacement progress (dedupe
            # collapses the per-pass repeats)
            self.recorder.publish(
                events_catalog.disruption_launching(nc, qc.command.reason))
            if not nc.initialized():
                self.recorder.publish(
                    events_catalog.disruption_waiting_on_readiness(nc))
                return "wait"
        # all replacements ready: delete the candidates (queue.go:258-274)
        for c in qc.command.candidates:
            nc = c.state_node.nodeclaim
            live = self.store.get(NodeClaim, nc.name) if nc is not None else None
            if live is not None and live.metadata.deletion_timestamp is None:
                self.recorder.publish(*events_catalog.disruption_terminating(
                    c.state_node.name(), live.name, qc.command.reason))
                self.store.delete(live)
        return "done"

    def _rollback(self, qc: QueuedCommand) -> None:
        """queue.go:181-223: untaint + unmark so the nodes return to service."""
        log.warning("disruption command failed, rolling back",
                    reason=qc.command.reason,
                    candidates=[c.state_node.name()
                                for c in qc.command.candidates])
        for c in qc.command.candidates:
            node = self.store.get(Node, c.state_node.name())
            if node is not None:
                before = len(node.spec.taints)
                node.spec.taints = [
                    t for t in node.spec.taints
                    if not t.matches(DISRUPTED_NO_SCHEDULE_TAINT)]
                if len(node.spec.taints) != before:
                    self.store.update(node)
        self.cluster.unmark_for_deletion(*qc.provider_ids)


class DisruptionController(SingletonController):
    name = "disruption"

    def __init__(self, store: Store, cluster: Cluster, provisioner: Provisioner,
                 queue: OrchestrationQueue, clock: Optional[Clock] = None,
                 spot_to_spot_enabled: bool = False, recorder=None,
                 flight_recorder=None):
        from ..events.recorder import Recorder
        self.store = store
        # optional flightrec.FlightRecorder: every non-empty disruption
        # command is captured with its winner-simulation inputs for replay
        self.flight_recorder = flight_recorder
        self.cluster = cluster
        self.provisioner = provisioner
        self.queue = queue
        self.clock = clock or store.clock
        self.recorder = recorder or Recorder(self.clock)
        self.methods: List[Method] = [
            Drift(cluster, provisioner, recorder=self.recorder),
            Emptiness(cluster, provisioner, recorder=self.recorder),
            MultiNodeConsolidation(cluster, provisioner, spot_to_spot_enabled,
                                   clock=self.clock, recorder=self.recorder),
            SingleNodeConsolidation(cluster, provisioner, spot_to_spot_enabled,
                                    clock=self.clock, recorder=self.recorder),
        ]
        self.last_command: Optional[Command] = None
        # command awaiting the consolidation-TTL re-validation
        # (validation.go:83-215); (command, computed_at)
        self.pending: Optional[tuple] = None
        # the per-pass shared DisruptionSnapshot (reconcile scope only)
        self._snapshot = None
        # the cross-pass streaming state: delta-applied snapshot layers,
        # cached candidate rows, columnar budget accounting (stream.py).
        # It subscribes to the provisioner's shared EncodePlane, so a
        # disruption pass reuses the node/group rows the provisioning pass
        # just encoded (and vice versa) instead of keeping a third copy.
        from .stream import StreamingDisruptionState
        self.stream = StreamingDisruptionState(
            plane=getattr(provisioner, "state_plane", None))

    def reconcile(self) -> Optional[Result]:
        if not self.cluster.synced():
            return Result(requeue_after=1.0)
        self._cleanup_stale_taints()
        if self.pending is not None:
            return self._reconcile_pending()
        # ONE DisruptionSnapshot per pass: every method's candidate
        # collection and simulation shares the same encode. Built on the
        # first _disrupt call — even an idle pass pays its store scans,
        # but that replaces the per-METHOD context rebuild (4x nodepool +
        # catalog + PDB + pod listings) the old get_candidates cost; the
        # expensive tensor encode itself stays lazy inside the snapshot.
        self._snapshot = None
        try:
            for method in self.methods:
                if getattr(method, "is_consolidated", None) and \
                        method.is_consolidated():
                    continue
                # consolidation methods self-memoize inside compute_command
                # (skipped when budget-constrained — consolidation.go:89-96)
                executed = self._disrupt(method)
                if executed:
                    return Result(requeue_after=POLL_INTERVAL_SECONDS)
            return Result(requeue_after=POLL_INTERVAL_SECONDS)
        finally:
            self._snapshot = None
            for method in self.methods:
                if hasattr(method, "attach_snapshot"):
                    method.attach_snapshot(None)

    def _pass_snapshot(self):
        if self._snapshot is None:
            # the stream keeps the snapshot object across passes and
            # rebuilds only the layers whose invalidation tokens moved
            self._snapshot = self.stream.refresh(self.cluster,
                                                 self.provisioner)
        return self._snapshot

    def _cleanup_stale_taints(self) -> None:
        """controller.go:124-135: a crash mid-disruption can leave nodes
        tainted disrupted:NoSchedule with no queue entry driving them —
        idempotently untaint every node not in the orchestration queue."""
        for sn in self.cluster.state_nodes(deep_copy=False):
            if self.queue.has_any(sn.provider_id) or sn.node is None:
                continue
            # a deleting/terminating node is the NodeTermination controller's
            # to manage — untainting it would let pods bind back onto a
            # draining node (statenode.go:461-479 skips these)
            if sn.deleting() or sn.nodeclaim is None:
                continue
            node = self.store.get(Node, sn.name())
            if node is None or node.metadata.deletion_timestamp is not None:
                continue
            kept = [t for t in node.spec.taints
                    if not t.matches(DISRUPTED_NO_SCHEDULE_TAINT)]
            if len(kept) != len(node.spec.taints):
                node.spec.taints = kept
                self.store.update(node)

    def _reconcile_pending(self) -> Optional[Result]:
        cmd, computed_at = self.pending
        elapsed = self.clock.now() - computed_at
        if elapsed < CONSOLIDATION_TTL_SECONDS:
            return Result(
                requeue_after=CONSOLIDATION_TTL_SECONDS - elapsed)
        self.pending = None
        disrupting = {pid for qc in self.queue.items for pid in qc.provider_ids}
        # the validation pass gets its OWN snapshot: the cluster had a TTL's
        # worth of time to move since the compute pass encoded it
        if validate_command(self.cluster, self.provisioner, cmd, cmd.reason,
                            disrupting_provider_ids=disrupting):
            self._execute(cmd)
        return Result(requeue_after=POLL_INTERVAL_SECONDS)

    def _disrupt(self, method: Method) -> bool:
        """controller.go:155-190."""
        with TRACER.span("disruption.pass", method=method.reason) as sp:
            return self._disrupt_traced(method, sp)

    def _disrupt_traced(self, method: Method, sp) -> bool:
        from ..metrics import registry as metrics
        disrupting = {pid for qc in self.queue.items for pid in qc.provider_ids}
        snapshot = self._pass_snapshot()
        if hasattr(method, "attach_snapshot"):
            method.attach_snapshot(snapshot)
        # columnar candidate construction over the stream's cached rows
        # (bit-identical to helpers.get_candidates against this snapshot)
        candidates = self.stream.candidates_for(
            method.should_disrupt, disrupting_provider_ids=disrupting,
            disruption_class=method.disruption_class,
            recorder=self.recorder)
        metrics.DISRUPTION_ELIGIBLE_NODES.set(
            len(candidates), {"reason": method.reason})
        if not candidates:
            # idle pass: up to 4 of these every 10s poll would flood the
            # trace ring and evict the interesting traces — don't ring it
            TRACER.drop_current()
            return False
        sp.set(candidates=len(candidates))
        budgets = self.stream.budget_mapping(method.reason,
                                             recorder=self.recorder)
        started = self.clock.now()
        cmd, results = method.compute_command(budgets, candidates)
        metrics.DISRUPTION_EVAL_DURATION.observe(
            self.clock.now() - started,
            {"method": getattr(method, "consolidation_type", "") or
             method.reason})
        if cmd.is_empty():
            return False
        # the pass trace_id rides the command so the execute-time log line
        # (possibly a TTL validation later) can still join the trace
        cmd.trace_id = TRACER.current_trace_id()
        if self.flight_recorder is not None:
            # capture at decision time (before the TTL validation pass): the
            # record must hold the inputs the decision was COMPUTED from
            self.flight_recorder.capture_disruption(
                snapshot, method, budgets, candidates, cmd, results,
                self.clock.now() - started)
        # graceful methods revalidate after the consolidation TTL; eventual
        # (drift) executes immediately (drift.go has no validation pass)
        if method.disruption_class == "graceful":
            self.pending = (cmd, self.clock.now())
            return True
        self._execute(cmd)
        return True

    def _execute(self, cmd: Command) -> None:
        """controller.go:196-246: taint -> launch replacements -> mark ->
        enqueue."""
        self.last_command = cmd
        log.info("disrupting nodes",
                 reason=cmd.reason, decision=cmd.decision,
                 consolidation_type=cmd.consolidation_type,
                 candidates=[c.state_node.name() for c in cmd.candidates],
                 replacements=len(cmd.replacements),
                 trace_id=cmd.trace_id)
        from ..metrics import registry as metrics
        metrics.DISRUPTION_DECISIONS.inc({
            "decision": cmd.decision, "reason": cmd.reason,
            "consolidation_type": cmd.consolidation_type})
        for c in cmd.candidates:
            metrics.NODECLAIMS_DISRUPTED.inc({
                "nodepool": c.nodepool_name, "reason": cmd.reason})
        for c in cmd.candidates:
            node = self.store.get(Node, c.state_node.name())
            if node is not None and not any(
                    t.matches(DISRUPTED_NO_SCHEDULE_TAINT)
                    for t in node.spec.taints):
                node.spec.taints.append(DISRUPTED_NO_SCHEDULE_TAINT)
                self.store.update(node)
        replacement_names: List[str] = []
        for nc in cmd.replacements:
            nc.finalize()
            api_nc = nc.to_nodeclaim()
            api_nc.metadata.namespace = ""
            self.store.create(api_nc)
            self.cluster.update_nodeclaim(api_nc)
            replacement_names.append(api_nc.name)
        self.cluster.mark_for_deletion(*(c.provider_id for c in cmd.candidates))
        self.queue.add(QueuedCommand(
            command=cmd, replacement_names=replacement_names,
            enqueued_at=self.clock.now()))
