"""Bounded in-memory flight-recorder ring.

Capture cost is the design constraint: the recorder rides INSIDE the
headline `Solve()`, so a provisioning capture snapshots the error dict and
only PINS the solver inputs and the results — the digest (O(claims)) and
the heavy sidecar-codec encode of a 50k-pod batch are deferred to
`materialize()`, which runs at dump/replay time outside any solve.
Disruption decisions are rare (at most one per 10 s pass) and their
candidate state nodes are LIVE cluster references that later reconciles
mutate in place, so disruption captures materialize eagerly instead.

The deferred provisioning encode is safe for the solve-private inputs: the
provisioner hands the scheduler a deep-copied state-node list
(cluster.state_nodes()), pod/catalog/nodepool objects are replaced (not
rewritten) by the store on update, and the two systematic post-decision
mutations — the provisioner binding `pod.spec.node_name`, and the bound
batch then surfacing in the LIVE cluster view as scheduled topology
occupancy — are both normalized away by the encode (recorded batches are
pending by definition; batch uids are filtered from the cluster-view
snapshot). What the encode canNOT freeze is unrelated cluster churn
between capture and dump (new deployments scheduling, CSI limits moving):
dump promptly — a trace is a snapshot, not a ledger.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import List, Optional

from ..utils.clock import Clock
from . import record as rec_codec

# a deferred record pins its whole solver input graph (pod list, deep-
# copied state nodes, Results, catalog refs) until dumped — the default
# ring is sized for incident context, not history, so an idle operator
# retains at most a few dozen superseded object generations
DEFAULT_CAPACITY = 32


def _masked_instance_types(ts) -> dict:
    """The catalog AS THE SOLVE SAW IT: when an unavailable-offerings
    registry masked offerings out of a solve, the captured catalog must
    carry those offerings as available=False copies — otherwise replay
    would re-solve against the unmasked catalog and flag the recorded
    drought-routing decision as nondeterministic. Reads the scheduler's
    PINNED pattern snapshot (drought_patterns), never the live registry:
    a TTL lapsing between solve and capture must not shift the mask."""
    from ..state.unavailable import mask_catalog
    patterns = getattr(ts, "drought_patterns", ())
    if not patterns:
        return dict(ts.instance_types)
    return mask_catalog(dict(ts.instance_types), patterns)


class FlightRecord:
    """One captured decision. `solve` inputs — and for provisioning
    captures the decision digest too — may still be pinned object
    references until materialize() encodes them."""

    __slots__ = ("v", "kind", "at", "elapsed", "meta", "decision", "_solve",
                 "_refs", "_digest_refs", "_mat_lock")

    def __init__(self, kind: str, at: float, elapsed: float, meta: dict,
                 decision: Optional[dict], solve: Optional[dict] = None,
                 refs: Optional[tuple] = None,
                 digest_refs: Optional[tuple] = None):
        self.v = rec_codec.SCHEMA_VERSION
        self.kind = kind
        self.at = at
        self.elapsed = elapsed
        self.meta = meta
        self.decision = decision
        self._solve = solve
        self._refs = refs
        self._digest_refs = digest_refs
        self._mat_lock = threading.Lock()

    def materialize(self) -> None:
        """Encode pinned solver inputs + digest into JSON-able form
        (idempotent; serialized — concurrent /debug requests can reach the
        same un-materialized record from separate serving threads)."""
        with self._mat_lock:
            if self._digest_refs is not None:
                results, errors, pods, fallback, partition = \
                    self._digest_refs
                self.decision = rec_codec.decision_digest(
                    results, pods, fallback_reason=fallback,
                    partition=partition, errors=errors)
                self._digest_refs = None
            if self._refs is None:
                return
            nodepools, instance_types, pods, state_nodes, daemons, cluster, \
                store, drought_patterns = self._refs
            # apply the solve's pinned unavailable-offerings view at
            # materialize time (the O(T*O) copy stays OFF the capture hot
            # path): catalog objects are replaced, never rewritten, so the
            # deferred mask sees exactly what the solve saw
            from ..state.unavailable import mask_catalog
            instance_types = mask_catalog(instance_types, drought_patterns)
            for attempt in range(3):
                # the /debug endpoint materializes on the serving thread
                # while the operator loop mutates the (deliberately
                # lock-free) store; the store replaces objects on update,
                # so a read is never half-written — but dict iteration can
                # still observe a concurrent insert. Retry; three straight
                # losses means the loop is churning and the caller gets
                # the error.
                try:
                    self._solve = rec_codec.encode_solve_payload(
                        nodepools, instance_types, pods,
                        state_nodes=state_nodes, daemonset_pods=daemons,
                        cluster=cluster, store=store)
                    break
                except RuntimeError:
                    if attempt == 2:
                        raise
            self._refs = None

    def to_dict(self) -> dict:
        self.materialize()
        return {"v": self.v, "kind": self.kind, "at": self.at,
                "elapsed": self.elapsed, "meta": self.meta,
                "decision": self.decision, "solve": self._solve}

    def summary(self) -> str:
        # counts come from meta, not the digest: a summary render (the
        # /debug endpoint) must not force the deferred materialization
        parts = [f"{self.at:.3f} {self.kind}",
                 f"elapsed={self.elapsed:.4f}s"]
        if self.kind == "provisioning":
            parts.append(f"pods={self.meta.get('pods', 0)}")
            parts.append(f"claims={self.meta.get('claims', 0)}")
            parts.append(f"existing={self.meta.get('existing', 0)}")
            parts.append(f"errors={self.meta.get('errors', 0)}")
            if self.meta.get("fallback_reason"):
                parts.append(f"fallback={self.meta['fallback_reason']!r}")
        else:
            cmd = self.meta.get("command", {})
            parts.append(f"method={self.meta.get('reason', '')}")
            parts.append(f"decision={cmd.get('decision', '')}")
            parts.append(f"candidates={len(cmd.get('candidates', []))}")
            parts.append(f"replacements={len(cmd.get('replacements', []))}")
            parts.append(f"rejections={len(self.meta.get('rejections', []))}")
        return " ".join(parts)


class FlightRecorder:
    """Thread-safe bounded ring of FlightRecords with the
    flightrecorder_records_total / flightrecorder_dropped_total metric pair.
    A capture failure can never break the solve that triggered it — it
    counts as a drop (reason="capture_error") instead."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 clock: Optional[Clock] = None):
        self.capacity = max(1, int(capacity))
        self.clock = clock or Clock()
        self._records: "deque[FlightRecord]" = deque()
        self._lock = threading.Lock()

    # -- capture ------------------------------------------------------------

    def capture_provisioning(self, ts, pods, results, elapsed: float) -> None:
        """Hot-path capture of one TensorScheduler.solve(): eager digest,
        deferred input encode (see module docstring)."""
        from ..metrics import registry as metrics
        try:
            meta = {
                "pods": len(pods),
                "state_nodes": len(ts.state_nodes),
                "nodepools": [np_.name for np_ in ts.nodepools],
                "circuit": ts.circuit.state,
                "fallback_reason": ts.fallback_reason,
                # cold vs delta problem encode (ProblemState): replay always
                # re-encodes cold, so a byte-identical replay verdict on a
                # delta-kind record is the delta path's determinism proof
                "encode_kind": getattr(ts, "encode_kind", "cold"),
                # the pass trace id (obs/tracer): joins this record with
                # its /debug/traces span tree and log lines; the SLO
                # watcher's breach dump selects records by it
                "trace_id": getattr(ts, "last_trace_id", ""),
                "partition": list(ts.partition),
                "claims": len(results.new_nodeclaims),
                "existing": sum(1 for en in results.existing_nodes
                                if en.pods),
                "errors": len(results.pod_errors),
            }
            pinned = list(pods)
            # the drought pattern snapshot rides the refs so the O(T*O)
            # catalog mask is applied at materialize time, not here
            refs = (list(ts.nodepools), dict(ts.instance_types), pinned,
                    list(ts.state_nodes), list(ts.daemonset_pods), ts.cluster,
                    getattr(ts.cluster, "store", None),
                    tuple(getattr(ts, "drought_patterns", ())))
            # digest deferred too: its per-claim option-list hashing costs
            # milliseconds at headline scale. Claim/option objects are
            # immutable after the solve; the error dict is snapshotted now.
            digest_refs = (results, dict(results.pod_errors), pinned,
                           ts.fallback_reason, tuple(ts.partition))
            self._append(FlightRecord("provisioning", self.clock.now(),
                                      elapsed, meta, None, refs=refs,
                                      digest_refs=digest_refs))
        except Exception:  # noqa: BLE001 — recording must never cost a solve
            metrics.FLIGHTREC_DROPPED.inc({"reason": "capture_error"})

    def capture_disruption(self, snapshot, method, budgets, candidates, cmd,
                           results, elapsed: float) -> None:
        """Capture one disruption decision (non-empty Command): the method
        context, the winner and its simulation digest, the rejected
        candidates, and — when the method simulated — the full solver inputs
        of the winner's simulation (base pods + winner pods over the
        surviving nodes), eagerly encoded (candidate state nodes are live)."""
        from ..metrics import registry as metrics
        try:
            from ..obs.tracer import TRACER
            ts = snapshot.ts
            winner_nodes = {c.state_node.name() for c in cmd.candidates}
            meta = {
                "trace_id": TRACER.current_trace_id(),
                "reason": cmd.reason,
                "consolidation_type": cmd.consolidation_type,
                "disruption_class": method.disruption_class,
                "budgets": dict(budgets),
                "candidates": [
                    {"name": c.name, "nodepool": c.nodepool_name,
                     "zone": c.zone, "capacity_type": c.capacity_type,
                     "disruption_cost": c.disruption_cost,
                     "pods": len(c.reschedulable_pods)}
                    for c in candidates],
                "command": {
                    "decision": cmd.decision,
                    "candidates": [c.name for c in cmd.candidates],
                    "replacements": [rec_codec.replacement_digest(nc)
                                     for nc in cmd.replacements],
                },
                "rejections": [c.name for c in candidates
                               if c.name not in winner_nodes],
                "exempt_uids": sorted(snapshot.deleting_pod_uids),
            }
            solve = digest = None
            if results is not None:
                sim_pods = snapshot.base_pods + [
                    p for c in cmd.candidates for p in c.reschedulable_pods]
                survivors = [sn for sn in ts.state_nodes
                             if sn.name() not in winner_nodes]
                digest = rec_codec.decision_digest(results, sim_pods)
                solve = rec_codec.encode_solve_payload(
                    ts.nodepools, _masked_instance_types(ts), sim_pods,
                    state_nodes=survivors, daemonset_pods=ts.daemonset_pods,
                    cluster=ts.cluster,
                    store=getattr(ts.cluster, "store", None))
            self._append(FlightRecord("disruption", self.clock.now(), elapsed,
                                      meta, digest, solve=solve))
        except Exception:  # noqa: BLE001
            metrics.FLIGHTREC_DROPPED.inc({"reason": "capture_error"})

    def capture_corruption(self, layer: str, detail: str,
                           seq: int = 0) -> None:
        """Capture one warm-state corruption incident (state/audit.py).
        The record is tiny — there are no solver inputs to pin, only the
        quarantine context — so it encodes eagerly."""
        from ..metrics import registry as metrics
        try:
            self._append(FlightRecord(
                "state_corruption", self.clock.now(), 0.0,
                {"layer": layer, "detail": detail, "seq": int(seq)}, None))
        except Exception:  # noqa: BLE001 — recording must never cost a pass
            metrics.FLIGHTREC_DROPPED.inc({"reason": "capture_error"})

    def _append(self, rec: FlightRecord) -> None:
        from ..metrics import registry as metrics
        with self._lock:
            if len(self._records) >= self.capacity:
                self._records.popleft()
                metrics.FLIGHTREC_DROPPED.inc({"reason": "evicted"})
            self._records.append(rec)
        metrics.FLIGHTREC_RECORDS.inc({"kind": rec.kind})

    # -- read side ----------------------------------------------------------

    def records(self, n: Optional[int] = None) -> List[FlightRecord]:
        with self._lock:
            out = list(self._records)
        return out if n is None else out[-n:]

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def lines(self, n: Optional[int] = None) -> List[str]:
        return [rec_codec.dumps_record(r.to_dict()) for r in self.records(n)]

    def dump(self, path: str) -> int:
        """Write the ring as JSONL (oldest first); returns the record count."""
        lines = self.lines()
        with open(path, "w") as f:
            for line in lines:
                f.write(line + "\n")
        return len(lines)

    def dump_matching(self, path: str, trace_id: str) -> int:
        """Write only the records of ONE pass (meta.trace_id match) — the
        SLO watcher's breach dump. Returns the count; nothing is written
        when no record matches (recorder unhooked, ring already evicted).
        All lines are encoded BEFORE the file opens (like dump()): a
        mid-materialize failure must not leave a truncated dump on disk
        that the watcher's file cap never learns about."""
        matched = [r for r in self.records()
                   if r.meta.get("trace_id") == trace_id]
        if not matched:
            return 0
        lines = [rec_codec.dumps_record(r.to_dict()) for r in matched]
        with open(path, "w") as f:
            for line in lines:
                f.write(line + "\n")
        return len(lines)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
