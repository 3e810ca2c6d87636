"""Persistent ProblemState: a subscriber handle over the shared EncodePlane.

Every reconcile pass used to rebuild the whole solve input from scratch:
re-encode 5k state-node label sets, re-scan 50k scheduled cluster pods per
topology selector, re-encode every pod group, re-upload the node tensors,
and re-pack every group — even when the pass differed from the previous one
by a handful of pod arrivals. ProblemState lives across passes (owned by the
Provisioner, handed to each per-solve TensorScheduler) and turns the solve
into a delta application.

Since the state-plane unification the encode caches themselves live on a
shared, refcounted ``state.plane.EncodePlane``: node rows, node stacks,
group rows, and topology memos are encoded once per revision bump and
shared by every subscriber of the same plane (provisioning passes, the
streaming disruption engine, a sidecar session). ``ProblemState`` IS the
PlaneHandle: constructed bare it subscribes to a fresh private plane
(byte-identical to the historical private-state behavior); constructed via
``plane.subscribe(name)`` it shares. The merged invalidation matrix —
which delta invalidates what, and who pays — is documented ONCE on
``state/plane.py`` (DEVIATIONS 25).

What remains HANDLE-private (per subscriber):

- **warm-started packing** — after each pack the packer's state is
  checkpointed along the FFD group order (ops/binpack.py PackSeed); the
  next solve restores the longest clean prefix (groups whose signature,
  count, and topology rows are unchanged under an unchanged global input
  token) and re-packs only from there. Decisions are bit-identical to a
  cold solve by construction: the packer is sequentially deterministic, so
  equal inputs up to position P imply byte-equal state at P. Packer state
  is one solver's memory — it is never shared across subscribers.
- **mesh attachment** (attach_mesh) + per-shard exist tokens — bound to
  this subscriber's mesh carve.
- **tensors memo** — the ((group_part, exist_part), PackTensors) of the
  last precompute, a single slot keyed by this subscriber's own group set.
- **reporting** — ``last``/``stats`` and the cold/delta ``encode_kind``,
  tracked against this handle's OWN previous pass.

Sharded-state rows (attach_mesh: the existing-node rows carved along the
mesh's pods_groups axis into per-shard exist-row tokens):

| delta (sharded state)                   | effect                         |
|-----------------------------------------|--------------------------------|
| node churn within one shard's row span  | that shard's rows re-encode    |
|                                         | and re-upload; every other     |
|                                         | shard's device block is reused |
|                                         | (mesh placer exist_shards)     |
| mesh attach / detach / shard-count flip | exist tokens + tensors memo    |
|                                         | dropped (attach_mesh);         |
|                                         | row + stack caches unaffected  |
| new vocab entry (overflow) /            | cold everywhere — same as the  |
| catalog change                          | plane matrix, per shard too    |
|                                         | (tokens carry vocab)           |

Anything the matrix cannot express falls back to a cold encode/pack; the
fallback is always decision-equivalent, never semantic. The churn fuzzer
(tests/test_problem_state.py) interleaves arrivals/deletions/node churn/
drought marks and asserts delta == cold at every step; its sharded variant
replays the same matrix against an attached mesh and asserts byte-identical
decisions vs a cold mesh solve per window; the combined-loop fuzzer
(tests/test_state_plane.py) replays the matrix with three subscribers on
ONE plane.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..ops import binpack
from ..state import audit as _audit
from ..state.plane import MAX_SIG_ENTRIES, EncodePlane  # noqa: F401
from .grouping import group_signature

# _pow2_bucket is THE shape-bucketing policy — shared with the cold path
# (build_problem) so the delta-built stacks stay byte-identical to it
# (re-exported here: bench/tests import it alongside ProblemState)
from .tensor_scheduler import _pow2_bucket  # noqa: E402,F401


class ProblemState:
    """Cross-pass solver state: one subscriber's handle on an EncodePlane.
    NOT thread-safe: owned by a single-threaded solver loop (or a bench/
    fuzzer driver); per-solve TensorSchedulers borrow it one at a time."""

    def __init__(self, plane: Optional[EncodePlane] = None,
                 subscriber: str = "private"):
        # bare construction = a private plane: byte-identical behavior to
        # the historical per-owner ProblemState for every existing caller
        if plane is None:
            plane = EncodePlane(name=f"private:{subscriber}")
        self.plane = plane
        self.subscriber = subscriber
        plane._attach(subscriber)
        # cold/delta reporting is per-HANDLE: "delta" iff the catalog
        # encoding is the one THIS subscriber's previous pass used, exactly
        # as the private states reported before the plane unification.
        # (Row validity is vocab-gated on the plane, not by this field.)
        self._last_vocab = None
        # warm-start seed from the previous pack
        self.seed: Optional[binpack.PackSeed] = None
        # content digest over the warm seed, recorded by finish_pack and
        # verified by warm_start when a StateAuditor is attached (None
        # otherwise — the unaudited path never pays for it)
        self._warm_digest: Optional[int] = None
        # sharded-state attachment (attach_mesh): the per-shard exist-row
        # tokens and the tensors memo are only meaningful against ONE
        # (mesh identity, exist-shard count) pair
        self._attach_key: tuple = (None, 0)
        # per-shard exist-row tokens of the LAST node_rows call (None when
        # unsharded / the padded axis doesn't divide): build_problem copies
        # them onto PackProblem.exist_shard_tokens for the mesh placer
        self.exist_shard_tokens: Optional[tuple] = None
        # ((group_part, exist_part), PackTensors) of the last precompute:
        # the device kernel is factored so group_count is NOT an input and
        # the exist side only feeds exist_ok/exist_cap — a node-churn pass
        # under an unchanged group part re-runs ONLY the exist-only delta
        # kernel (binpack.exist_delta) and splices the pair in
        self.tensors_memo: Optional[tuple] = None
        # cumulative
        self.stats = {
            "solves": 0, "cold_encodes": 0, "delta_encodes": 0,
            "node_rows_reencoded": 0, "group_rows_encoded": 0,
            "topo_groups_counted": 0, "warm_restored_groups": 0,
        }
        # per-solve (begin_solve resets; initialized here so a direct
        # build_problem call outside a solve can't hit missing keys)
        self._sig_memo: Dict[int, tuple] = {}
        self.last: dict = {}
        self.begin_solve()
        self.stats["solves"] = 0

    def close(self) -> None:
        """Drop this handle's plane refcount (accounting only — plane
        caches are content-gated and never die with a subscriber)."""
        self.plane.release(self.subscriber)

    # -- per-solve lifecycle -------------------------------------------------

    def begin_solve(self) -> None:
        self._sig_memo = {}
        self.last = {"encode_kind": "cold", "node_rows_reencoded": 0,
                     "group_rows_encoded": 0, "topo_groups_counted": 0,
                     "warm": "none", "warm_restored": 0, "warm_matched": 0,
                     "precompute": "computed"}
        self.stats["solves"] += 1
        if self.plane.auditor is not None:
            self.plane.auditor.begin_pass()

    def attach_mesh(self, mesh_token, exist_shards: int) -> None:
        """Bind the handle to a mesh/shard-count identity (called by each
        TensorScheduler construction). A flip — mesh recreated over other
        devices, shard count changed, mesh dropped — invalidates the
        per-shard exist-row tokens and the tensors memo, neither of which
        can describe the new carve. Row, stack and topology caches live on
        the plane, are shard-independent, and survive untouched."""
        key = (mesh_token, int(exist_shards))
        if key == self._attach_key:
            return
        self._attach_key = key
        self.exist_shard_tokens = None
        self.tensors_memo = None

    def note_encode(self, vocab) -> str:
        """cold vs delta for this solve: delta iff the catalog encoding
        (and with it the whole vocabulary) is the one THIS handle's
        previous pass used — the condition under which every cached row
        stays exact."""
        kind = "delta" if self._last_vocab is vocab else "cold"
        self._last_vocab = vocab
        self.last["encode_kind"] = kind
        self.stats["delta_encodes" if kind == "delta"
                   else "cold_encodes"] += 1
        return kind

    def sig(self, g) -> tuple:
        s = self._sig_memo.get(id(g))
        if s is None:
            s = group_signature(g)
            self._sig_memo[id(g)] = s
        return s

    # -- node rows -----------------------------------------------------------

    @staticmethod
    def _daemon_token(daemonset_pods) -> tuple:
        return tuple(sorted(
            (p.uid, tuple(sorted(p.requests().items())))
            for p in daemonset_pods))

    def node_rows(self, vocab, zone_key: int, state_nodes, daemonset_pods
                  ) -> tuple:
        """(exist_enc, exist_avail, exist_zone, taint_lists, exist_token)
        with the node axis pow2-padded — byte-identical to what
        build_problem's cold path constructs, with only dirty rows
        re-encoded (once, on the plane, for every subscriber).
        taint_lists covers the REAL nodes only."""
        ds_token = self._daemon_token(daemonset_pods)
        (exist_enc, exist_avail, exist_zone, taint_lists, exist_token,
         reencoded, shard_tokens, shard_dirty) = self.plane.node_rows(
            vocab, zone_key, state_nodes, daemonset_pods, ds_token,
            self._attach_key[1], self.subscriber)
        self.last["node_rows_reencoded"] = reencoded
        self.stats["node_rows_reencoded"] += reencoded
        self.exist_shard_tokens = shard_tokens
        if shard_dirty is not None:
            self.last["shard_dirty"] = shard_dirty
        return exist_enc, exist_avail, exist_zone, taint_lists, exist_token

    # -- group rows ----------------------------------------------------------

    def group_row(self, vocab, g) -> tuple:
        """(enc_row, req_vec) for one group, signature-cached per vocab on
        the plane (shared by every subscriber)."""
        row, encoded = self.plane.group_row(vocab, self.sig(g), g,
                                            self.subscriber)
        if encoded:
            self.last["group_rows_encoded"] += 1
            self.stats["group_rows_encoded"] += 1
        return row

    # -- topology counts -----------------------------------------------------

    def topology_counts(self, ts, groups, zone_names, pods):
        """cluster_topology_counts with a per-group memo proven by
        Cluster.topo_revision: the scheduled-pod selector scans run only
        for groups whose counts the revision can no longer vouch for."""
        cl = getattr(ts.cluster, "cluster", None)
        rev = getattr(cl, "topo_revision", None)
        if rev is None:
            return ts.cluster_topology_counts(groups, zone_names,
                                              {p.uid for p in pods})
        # (the 50k-element uid exclusion set is only consumed by the
        # selector scans — built in the miss branch so fully-memoized
        # solves never pay it)
        # the memo excludes scheduled batch pods by identity (deleting-node
        # pods are both scheduled and in the batch), so the token carries
        # them; pending pods never count either way
        sched_excl = frozenset(p.uid for p in pods if p.spec.node_name)
        token = (rev, tuple(zone_names),
                 tuple(sn.name() for sn in ts.state_nodes), sched_excl)
        memo = self.plane.topo_memo(token)
        sigs = [self.sig(g) for g in groups]
        auditor = self.plane.auditor
        if auditor is not None and memo:
            # lazy digest check on every served entry (entries grow a 4th
            # digest element; the assembly below reads fields 0-2 by index
            # so it never sees it), plus ONE sampled entry recounted fresh
            # from the cluster — quarantine wipes the memo in place so
            # this solve recomputes cold
            hit_idx = [i for i, s in enumerate(sigs) if s in memo]
            corrupt = False
            for i in hit_idx:
                row = memo[sigs[i]]
                if len(row) <= 3:
                    # adopted: counted while no auditor was attached —
                    # digest on first audited serve so later serves verify
                    memo[sigs[i]] = row + (_audit.content_digest(row),)
                elif _audit.content_digest(row[:3]) != row[3]:
                    auditor.incident("topo_memo",
                                     "entry failed its serve-time digest")
                    memo.clear()
                    corrupt = True
                    break
            if not corrupt and hit_idx and auditor.take_topo_audit():
                i = hit_idx[auditor.rng.randrange(len(hit_idx))]
                f_izc, f_exist, f_host = ts.cluster_topology_counts(
                    [groups[i]], zone_names, {p.uid for p in pods})
                fresh = (f_izc[0], f_exist[0], int(f_host[0]))
                if _audit.content_digest(fresh) != \
                        _audit.content_digest(memo[sigs[i]][:3]):
                    auditor.incident("topo_memo",
                                     "entry diverged from a fresh recount")
                    memo.clear()
                else:
                    auditor.audited("topo_memo")
        miss = [i for i, s in enumerate(sigs) if s not in memo]
        if miss:
            if len(memo) + len(miss) > MAX_SIG_ENTRIES:
                # overflow wipes the memo, so EVERY group of this solve
                # must recompute — recomputing only the misses would leave
                # the wiped hit entries dangling for the assembly below
                # (wiped IN PLACE: the plane holds the dict by token)
                memo.clear()
                miss = list(range(len(groups)))
            excl = {p.uid for p in pods}
            sub_izc, sub_exist, sub_host = ts.cluster_topology_counts(
                [groups[i] for i in miss], zone_names, excl)
            for j, i in enumerate(miss):
                entry = (sub_izc[j], sub_exist[j], int(sub_host[j]))
                if auditor is not None:
                    entry = entry + (_audit.content_digest(entry),)
                memo[sigs[i]] = entry
            self.last["topo_groups_counted"] += len(miss)
            self.stats["topo_groups_counted"] += len(miss)
        G = len(groups)
        Z = len(zone_names)
        N = max(1, len(ts.state_nodes))
        izc = np.zeros((G, Z), dtype=np.int64)
        exist_counts = np.zeros((G, N), dtype=np.int64)
        host_total = np.zeros(G, dtype=np.int64)
        for i, s in enumerate(sigs):
            row = memo[s]
            izc[i] = row[0]
            exist_counts[i] = row[1]
            host_total[i] = row[2]
        return izc, exist_counts, host_total

    # -- warm-started packing ------------------------------------------------

    def _templates_token(self, templates) -> tuple:
        from .tensor_scheduler import _reqs_digest
        return tuple(
            (nct.nodepool_name, _reqs_digest(nct.requirements),
             tuple(nct.taints), tuple(nct.startup_taints),
             tuple(it.name for it in nct.instance_type_options))
            for nct in templates)

    def warm_start(self, ts, vocab, groups, templates, limits,
                   izc, exist_counts, host_total, exist_token
                   ) -> Optional[binpack.WarmStart]:
        """Build the per-solve WarmStart context, or None when the solve
        shape can't warm-start (explicit initial_zone_counts injection)."""
        if ts.initial_zone_counts is not None:
            self.last["warm"] = "disabled:initial_zone_counts"
            return None
        auditor = self.plane.auditor
        if auditor is not None and self._warm_digest is not None:
            # restore-time digest check: a corrupted checkpoint would
            # otherwise replay wrong packer state as "warm" decisions
            if _audit.warm_digest(self.seed) != self._warm_digest:
                auditor.incident(
                    "warm_checkpoint",
                    "seed failed its restore-time digest")
                self.seed = None
                self._warm_digest = None
            else:
                auditor.audited("warm_checkpoint")
        global_token = (
            vocab,                      # identity: the whole encoding
            tuple(ts.drought_patterns),
            exist_token,
            # daemonset overhead shapes daemon_overhead/ppn even with ZERO
            # existing nodes (exist_token None), so it must ride the token
            # on its own, not only inside exist_token
            self._daemon_token(ts.daemonset_pods),
            self._templates_token(templates),
            tuple(None if lm is None else tuple(sorted(lm.items()))
                  for lm in limits),
        )
        tokens: List[tuple] = []
        for i, g in enumerate(groups):
            tokens.append((
                self.sig(g), len(g.pods), izc[i].tobytes(),
                None if exist_counts is None else exist_counts[i].tobytes(),
                None if host_total is None else int(host_total[i])))
        return binpack.WarmStart(global_token=global_token, tokens=tokens,
                                 seed=self.seed)

    def finish_pack(self, warm: Optional[binpack.WarmStart]) -> None:
        if warm is None:
            return
        if warm.result_seed is not None:
            self.seed = warm.result_seed
            self.last["warm"] = (f"prefix:{warm.restored_pos}"
                                 if warm.restored_pos else "recorded")
            self.last["warm_restored"] = warm.restored_pos
            self.last["warm_matched"] = warm.matched
            self.stats["warm_restored_groups"] += warm.restored_pos
        else:
            # the packer declined (ports/volumes/minValues): conservative
            # full pack, and the stale seed must not survive — its
            # checkpoints no longer describe the latest decisions
            self.seed = None
            self.last["warm"] = "disabled:inexpressible"
        if self.plane.auditor is not None:
            self._warm_digest = _audit.warm_digest(self.seed)
        else:
            # keep the recorded digest in lockstep with the seeds: an
            # auditor detached for a few passes (bench off-phase) must not
            # leave a stale digest that reads as corruption on re-attach
            self._warm_digest = None


# the subscriber API's name for what `plane.subscribe` returns
PlaneHandle = ProblemState
