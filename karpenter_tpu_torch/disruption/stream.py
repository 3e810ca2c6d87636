"""Streaming disruption engine: persistent delta-applied snapshots +
columnar candidate construction.

Every disruption pass used to rebuild the whole world from scratch: one
full `DisruptionSnapshot` (pod store scan, nodepool + catalog fetch, PDB
limits, a fresh TensorScheduler whose every encode re-encoded 50k node
label sets), then FOUR `get_candidates` sweeps — each one deep-copying
every state node and re-running the per-pod do-not-disrupt + PDB scans —
and one `build_disruption_budget_mapping` fleet scan per method. At fleet
scale the simulator's attribution shows this candidate build
dominating the pass.

`StreamingDisruptionState` lives across passes (owned by the
`DisruptionController`) and turns the pass into a delta application, keyed
on the same change signals the provisioning `ProblemState` already uses:

- **snapshot layers** — the pass-shared `DisruptionSnapshot` persists; its
  layers rebuild independently: the pod maps (pods-by-node, ride-along,
  base pods) against ``Cluster.topo_revision`` + the pending-pod token,
  the candidate context (nodepools, instance types, PDB limits) against
  store resource-version tokens + the content-keyed catalog token, and the
  TensorScheduler against the node/pool/catalog/daemonset tokens.
- **node-row encodes** — the snapshot's scheduler owns a persistent
  `provisioning.problem_state.ProblemState`: per-node encoded rows keyed
  by ``StateNode.revision`` bumps, group rows keyed by content-stable
  ``grouping.group_signature``, so a warm pass re-encodes only dirty rows
  and reuses the pow2-padded exist stack + its device upload.
- **encodings** — the per-candidate-set `SnapshotEncoding` memo (problem +
  device feasibility tensors) survives passes whose inputs are untouched:
  a fully idle 10s poll re-simulates over last pass's tensors at zero
  encode cost.
- **candidate rows** — the expensive per-node candidate work (the state
  node deep copy, the per-pod do-not-disrupt + PDB eviction scans, the
  rescheduling-cost fold, condition flags) is cached per node keyed on
  ``(identity, revision)`` + the node's pod token + the PDB token. The
  cheap, time-varying gates (nomination windows, deletion marks,
  already-disrupting membership) are evaluated live each pass as masks
  over the row columns, and per-pool budget accounting is one vectorized
  ``bincount`` over the pool-index column instead of a fleet scan per
  method.

Invalidation matrix — every delta a pass can carry, and what it re-derives
(DEVIATIONS 24; anything outside the matrix falls back to a cold rebuild,
which is always decision-equivalent by construction):

| delta                                | effect                            |
|--------------------------------------|-----------------------------------|
| nothing changed (idle poll)           | everything reused: pod maps,      |
|                                       | context, scheduler, encodings,    |
|                                       | candidate rows                    |
| scheduled-pod change (topo_revision)  | pod maps + PDB limits + encodings |
|                                       | rebuilt; only the bound node's    |
|                                       | candidate row + encode row        |
|                                       | re-derive (its available()        |
|                                       | moved); all other node encodes    |
|                                       | reused via ProblemState           |
| pending-pod change (pending token)    | base pods + encodings rebuilt;    |
|                                       | candidate rows untouched unless   |
|                                       | PDB-sensitive                     |
| node add/remove/update (revision)     | that node's candidate row +       |
|                                       | encode row re-derive; exist stack |
|                                       | restacks; encodings rebuilt       |
| PDB change (resource version)         | PDB limits rebuilt + every row's  |
|                                       | eviction verdict re-derives (a    |
|                                       | new PDB can block any node);      |
|                                       | encodings KEPT (sims never read   |
|                                       | PDBs)                             |
| nodepool edit / budget change         | context + scheduler + encodings   |
|                                       | rebuilt; budget columns re-derive |
|                                       | (budgets themselves are computed  |
|                                       | per pass — schedules are          |
|                                       | time-dependent)                   |
| catalog/vocab change (content token)  | cold: context + scheduler +       |
|                                       | encodings rebuilt, ProblemState   |
|                                       | node/group rows re-encode against |
|                                       | the new vocabulary                |
| daemonset set change                  | scheduler + encodings rebuilt     |
| unavailable-offerings version bump    | encodings rebuilt (drought masks  |
|                                       | ride every encode)                |
| nomination / deletion-mark flips      | never cached: evaluated live as   |
|                                       | per-pass mask columns             |

Decisions are bit-identical to a cold `DisruptionSnapshot` +
`helpers.get_candidates` rebuild BY CONTRACT: the streaming fuzzer
(tests/test_streaming_disruption.py) interleaves pod churn, node churn,
PDB edits, nodepool edits and drift marks and asserts command equality at
every step, and the disruption-scale bench samples cold-vs-warm parity
in-line.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from ..api import labels as api_labels
from ..api.nodeclaim import COND_INSTANCE_TERMINATING
from ..api.nodepool import NodePool
from ..api.policy import PodDisruptionBudget
from ..events import catalog as events_catalog
from ..obs.tracer import TRACER
from ..utils import disruption as disruption_utils
from ..utils import pod as pod_utils
from .types import (EVENTUAL, Candidate, CandidateError,
                    PodBlockEvictionError, _validate_pods_disruptable)


class _NodeRow:
    """Cached per-node candidate derivation: everything expensive about
    `types.new_candidate` that the row tokens can prove unchanged."""

    __slots__ = ("token", "static_err", "pool_name", "zone", "capacity_type",
                 "it_name", "sn_copy", "resched", "resched_cost", "pods_err",
                 "tgp", "managed_init", "terminating", "not_ready")

    def __init__(self):
        self.token = None


class StreamingDisruptionState:
    """Cross-pass disruption memory. NOT thread-safe: owned by the
    single-threaded disruption controller loop (or a bench or fuzzer).
    """

    def __init__(self, plane=None):
        # subscribe to the cluster's shared EncodePlane when the controller
        # hands one over (node/group rows encoded once for provisioning AND
        # disruption); a bare construction keeps a private plane, byte-
        # identical to the historical private ProblemState (standalone
        # callers, fuzzers).
        from ..provisioning.problem_state import ProblemState
        self.problem_state = (plane.subscribe("disruption")
                              if plane is not None else ProblemState())
        self._snapshot = None
        self._cluster = None
        self._provisioner = None
        # layer tokens of the snapshot currently held
        self._tok: dict = {}
        # (name, identity) -> _NodeRow
        self._rows: Dict[tuple, _NodeRow] = {}
        # per-pass working state
        self._nodes: list = []                 # sorted live StateNodes
        self._deleting: Optional[np.ndarray] = None
        self._pods_tok_by_node: Dict[str, tuple] = {}
        self._col_tok = None
        self._pool_names: List[str] = []
        self._col_pool: Optional[np.ndarray] = None
        self._col_counted: Optional[np.ndarray] = None
        self._col_notready: Optional[np.ndarray] = None
        self.last: dict = {}
        self.stats = {
            "passes": 0, "rows_reused": 0, "rows_rebuilt": 0,
            "layer_pods_reused": 0, "layer_context_reused": 0,
            "layer_scheduler_reused": 0, "encodings_kept": 0,
        }

    # -- pass refresh --------------------------------------------------------

    def refresh(self, cluster, provisioner):
        """Per-pass entry point: delta-apply every layer and return the
        pass-shared DisruptionSnapshot."""
        with TRACER.span("disruption.stream") as sp:
            snap = self._refresh(cluster, provisioner, sp)
        return snap

    def _refresh(self, cluster, provisioner, sp):
        from ..metrics import registry as metrics
        from ..provisioning.problem_state import ProblemState
        from ..provisioning.tensor_scheduler import catalog_cache_token
        from .prefix import DisruptionSnapshot

        t0 = time.perf_counter()
        self.stats["passes"] += 1
        self.last = {"layers": {}, "rows_reused": 0, "rows_rebuilt": 0}

        nodes = cluster.state_nodes(deep_copy=False)
        deleting = np.fromiter((sn.deleting() for sn in nodes), dtype=bool,
                               count=len(nodes))
        node_tok = tuple(
            (sn.name(), sn.identity, sn.revision, bool(d))
            for sn, d in zip(nodes, deleting))
        pools = sorted(cluster.store.list(NodePool), key=lambda p: p.name)
        pool_tok = tuple((p.name, p.metadata.uid,
                          p.metadata.resource_version,
                          p.metadata.deletion_timestamp is None)
                         for p in pools)
        pdbs = cluster.store.list(PodDisruptionBudget)
        pdb_tok = tuple(sorted((p.metadata.uid, p.metadata.resource_version)
                               for p in pdbs))
        pending = provisioner.get_pending_pods()
        pending_tok = tuple((p.uid, p.metadata.resource_version)
                            for p in pending)
        ds_tok = ProblemState._daemon_token(cluster.daemonset_pod_list())
        topo = cluster.topo_revision
        ua = getattr(provisioner, "unavailable", None)
        # live() PRUNES lapsed TTL entries before reading: the token must
        # describe the pattern set an encode built right now would mask
        # with — the raw version counter only bumps when something prunes
        # it, so a lapsed entry with no intervening provisioner reconcile
        # would otherwise keep a stale drought mask alive in reused
        # encodings (diverging from a cold rebuild)
        ua_ver = ua.live() if ua is not None else None
        # the catalog is content-keyed every pass (providers may mutate
        # instance types in place — same contract as build_problem's
        # per-call hashing, computed once here and pinned on the
        # scheduler). The token MUST be computed over the SAME pool
        # ordering _build_scheduler hands the scheduler (weight order,
        # IT-less pools dropped): _ordered_union is order-sensitive, and a
        # token for a differently-ordered union would key the device
        # encoding cache with misaligned instance-type columns.
        from ..api.nodepool import order_by_weight
        its_by_pool = {p.name: provisioner.cloud_provider.get_instance_types(p)
                       for p in pools}
        solver_pools = [
            p for p in order_by_weight(
                [p for p in pools if p.metadata.deletion_timestamp is None])
            if its_by_pool.get(p.name)]
        catalog_tok = catalog_cache_token(solver_pools, its_by_pool)

        old = self._tok
        snap = self._snapshot
        cold = (snap is None or self._cluster is not cluster
                or self._provisioner is not provisioner)

        pods_valid = (not cold and old.get("topo") == topo
                      and old.get("node") == node_tok
                      and old.get("pending") == pending_tok)
        ctx_valid = (not cold and old.get("pool") == pool_tok
                     and old.get("catalog") == catalog_tok
                     and old.get("pdb") == pdb_tok
                     and old.get("topo") == topo
                     and old.get("pending") == pending_tok)
        ts_valid = (not cold and old.get("node") == node_tok
                    and old.get("pool") == pool_tok
                    and old.get("catalog") == catalog_tok
                    and old.get("ds") == ds_tok)
        enc_valid = (pods_valid and ts_valid
                     and old.get("ua") == ua_ver)

        self.problem_state.begin_solve()
        if cold:
            snap = DisruptionSnapshot(cluster, provisioner, stream=self,
                                      prefetched=(pools, its_by_pool,
                                                  pending, catalog_tok))
            self._snapshot = snap
            self._cluster = cluster
            self._provisioner = provisioner
            pods_valid = ctx_valid = ts_valid = enc_valid = False
        else:
            snap._prefetched = (pools, its_by_pool, pending, catalog_tok)
            if not pods_valid:
                snap._build_pods(cluster, provisioner)
            if not ctx_valid:
                snap._build_context(cluster, provisioner)
            if not ts_valid:
                snap._build_scheduler(cluster, provisioner)
            if not enc_valid:
                snap._encodings = {}
            snap._prefetched = None

        for layer, valid in (("pods", pods_valid), ("context", ctx_valid),
                             ("scheduler", ts_valid),
                             ("encodings", enc_valid)):
            outcome = "reused" if valid else "rebuilt"
            self.last["layers"][layer] = outcome
            metrics.DISRUPTION_STREAM_LAYERS.inc(
                {"layer": layer, "outcome": outcome})
            if valid:
                self.stats[f"layer_{layer}_reused" if layer != "encodings"
                           else "encodings_kept"] += 1

        self._nodes = nodes
        self._deleting = deleting
        self._refresh_rows(cluster, snap, node_tok, topo, pdb_tok,
                           pending_tok)
        self._tok = {"node": node_tok, "pool": pool_tok, "pdb": pdb_tok,
                     "pending": pending_tok, "ds": ds_tok, "topo": topo,
                     "catalog": catalog_tok, "ua": ua_ver}
        elapsed = time.perf_counter() - t0
        metrics.DISRUPTION_CANDIDATE_BUILD.observe(elapsed)
        self.last["seconds"] = elapsed
        sp.set(nodes=len(nodes), rows_rebuilt=self.last["rows_rebuilt"],
               rows_reused=self.last["rows_reused"],
               encodings="kept" if enc_valid else "cleared")
        return snap

    # -- candidate rows ------------------------------------------------------

    def _refresh_rows(self, cluster, snap, node_tok, topo, pdb_tok,
                      pending_tok) -> None:
        if self._tok.get("topo") == topo and self._pods_tok_by_node:
            pods_tok_by_node = self._pods_tok_by_node
        else:
            pods_tok_by_node = {
                name: tuple((p.uid, p.metadata.resource_version)
                            for p in pods)
                for name, pods in snap.pods_by_node_map.items()}
            self._pods_tok_by_node = pods_tok_by_node

        rebuilt = reused = 0
        fresh: Dict[tuple, _NodeRow] = {}
        rows = self._rows
        for sn in self._nodes:
            key = (sn.name(), sn.identity)
            ptok = pods_tok_by_node.get(sn.name(), ())
            row = rows.get(key)
            tok = (sn.revision, ptok, pdb_tok)
            if row is not None and row.token == tok:
                fresh[key] = row
                reused += 1
                continue
            row = self._build_row(sn, snap, tok)
            fresh[key] = row
            rebuilt += 1
        self._rows = fresh
        self.last["rows_rebuilt"] = rebuilt
        self.last["rows_reused"] = reused
        self.stats["rows_rebuilt"] += rebuilt
        self.stats["rows_reused"] += reused
        from ..metrics import registry as metrics
        if rebuilt:
            metrics.DISRUPTION_STREAM_ROWS.inc({"outcome": "rebuilt"},
                                               rebuilt)
        if reused:
            metrics.DISRUPTION_STREAM_ROWS.inc({"outcome": "reused"}, reused)
        self._assemble_columns()

    def _build_row(self, sn, snap, tok) -> _NodeRow:
        row = _NodeRow()
        row.token = tok
        labels = sn.labels()
        nc = sn.nodeclaim
        row.pool_name = sn.nodepool_name()
        row.zone = labels.get(api_labels.LABEL_TOPOLOGY_ZONE, "")
        row.capacity_type = labels.get(api_labels.CAPACITY_TYPE_LABEL_KEY, "")
        row.it_name = labels.get(api_labels.LABEL_INSTANCE_TYPE, "")
        # the static slice of validate_node_disruptable (statenode.go:183-
        # 208 order); nomination and deletion are time/mark-varying and
        # evaluated live each pass
        if nc is None:
            row.static_err = "node isn't managed by a nodeclaim"
        elif sn.annotations().get(
                api_labels.DO_NOT_DISRUPT_ANNOTATION_KEY) == "true":
            row.static_err = (
                "disruption is blocked through the "
                f"{api_labels.DO_NOT_DISRUPT_ANNOTATION_KEY} annotation")
        elif not sn.initialized():
            row.static_err = "node is not initialized"
        else:
            row.static_err = None
        pods = snap.pods_by_node_map.get(sn.name(), [])
        row.pods_err = _validate_pods_disruptable(pods, snap.pdb_limits)
        row.tgp = (nc.spec.termination_grace_period
                   if nc is not None else None)
        row.resched = [p for p in pods if pod_utils.is_reschedulable(p)]
        row.resched_cost = disruption_utils.rescheduling_cost(pods)
        row.sn_copy = sn.deep_copy()
        row.managed_init = bool(row.pool_name) and sn.managed() and \
            sn.initialized()
        row.terminating = nc is not None and \
            nc.conditions.is_true(COND_INSTANCE_TERMINATING)
        from .helpers import _node_not_ready
        row.not_ready = _node_not_ready(sn)
        return row

    def _assemble_columns(self) -> None:
        """The budget-accounting mask columns: pool index, counted
        (managed+initialized+not-terminating), and not-ready — one
        ``bincount`` replaces the per-method fleet scan."""
        nodes = self._nodes
        rows = self._rows
        pool_idx: Dict[str, int] = {}
        names: List[str] = []
        col_pool = np.empty(len(nodes), dtype=np.int64)
        col_counted = np.zeros(len(nodes), dtype=bool)
        col_notready = np.zeros(len(nodes), dtype=bool)
        for i, sn in enumerate(nodes):
            row = rows[(sn.name(), sn.identity)]
            pool = row.pool_name
            j = pool_idx.get(pool)
            if j is None:
                j = pool_idx[pool] = len(names)
                names.append(pool)
            col_pool[i] = j
            col_counted[i] = row.managed_init and not row.terminating
            col_notready[i] = row.not_ready
        self._pool_names = names
        self._col_pool = col_pool
        self._col_counted = col_counted
        self._col_notready = col_notready

    # -- columnar budget mapping --------------------------------------------

    def budget_mapping(self, reason: str, recorder=None) -> Dict[str, int]:
        """helpers.build_disruption_budget_mapping over the assembled
        columns: allowed = budget - already-disrupting per pool, with the
        node counting done as masked bincounts instead of a fleet scan."""
        cluster = self._cluster
        now = cluster.clock.now()
        P = len(self._pool_names)
        counted = self._col_counted
        disrupting_mask = counted & (self._deleting | self._col_notready)
        per_pool = np.bincount(self._col_pool[counted], minlength=P) \
            if counted.any() else np.zeros(P, dtype=np.int64)
        disrupting = np.bincount(self._col_pool[disrupting_mask],
                                 minlength=P) \
            if disrupting_mask.any() else np.zeros(P, dtype=np.int64)
        idx = {name: i for i, name in enumerate(self._pool_names)}
        allowed: Dict[str, int] = {}
        for np_ in cluster.store.list(NodePool):
            i = idx.get(np_.name)
            n_nodes = int(per_pool[i]) if i is not None else 0
            total = np_.allowed_disruptions(now, n_nodes, reason)
            dis = int(disrupting[i]) if i is not None else 0
            allowed[np_.name] = max(0, total - dis)
            if recorder is not None and n_nodes != 0 and total == 0:
                recorder.publish(
                    events_catalog.nodepool_blocked_for_reason(np_.name,
                                                               reason))
        return allowed

    # -- columnar candidate construction ------------------------------------

    def candidates_for(self, should_disrupt, disrupting_provider_ids=(),
                       disruption_class: str = "graceful",
                       recorder=None) -> List[Candidate]:
        """helpers.get_candidates over the cached rows: the per-node deep
        copies, pod scans and PDB verdicts come from the row cache; only
        the cheap time-varying gates evaluate live. Bit-identical output
        (candidates, order, blocked events) to the cold path."""
        snap = self._snapshot
        cluster = self._cluster
        now = cluster.clock.now()
        with TRACER.span("disruption.candidates") as sp:
            out = self._candidates(should_disrupt, disrupting_provider_ids,
                                   disruption_class, recorder, snap,
                                   cluster, now)
            sp.set(candidates=len(out))
        return out

    def _candidates(self, should_disrupt, disrupting_provider_ids,
                    disruption_class, recorder, snap, cluster, now):
        out: List[Candidate] = []
        rows = self._rows
        nodepools = snap.all_nodepools
        it_maps = snap.it_maps
        for i, sn in enumerate(self._nodes):
            row = rows[(sn.name(), sn.identity)]
            err = row.static_err
            if err is None:
                if sn.nominated(now):
                    err = "node is nominated for a pending pod"
                elif self._deleting[i]:
                    err = "node is deleting or marked for deletion"
                elif sn.provider_id in disrupting_provider_ids:
                    err = "candidate is already being disrupted"
                elif row.pool_name not in nodepools or \
                        row.pool_name not in it_maps:
                    err = (f'nodepool "{row.pool_name}" can\'t be resolved '
                           "for state node")
                elif row.pods_err is not None and not (
                        disruption_class == EVENTUAL
                        and row.tgp is not None
                        and isinstance(row.pods_err, PodBlockEvictionError)):
                    err = str(row.pods_err)
            if err is not None:
                if recorder is not None and sn.nodeclaim is not None:
                    recorder.publish(*events_catalog.disruption_blocked(
                        sn.name(), sn.nodeclaim.name, err))
                continue
            nc = sn.nodeclaim
            cand = Candidate(
                state_node=row.sn_copy,
                nodepool=nodepools[row.pool_name],
                instance_type=it_maps[row.pool_name].get(row.it_name),
                zone=row.zone,
                capacity_type=row.capacity_type,
                reschedulable_pods=row.resched,
                disruption_cost=(row.resched_cost *
                                 disruption_utils.lifetime_remaining(now, nc)))
            if should_disrupt(cand):
                out.append(cand)
        return out
