"""EncodePlane: ONE shared, refcounted encode/cache plane under every solver.

Provisioning passes, the streaming disruption engine, and
sidecar delta sessions all solve over the SAME fleet, yet each used
to own a private ProblemState — three dirty-row trackers, three exist-side
stacks, three invalidation matrices (DEVIATIONS 19/20/24) kept honest
independently. The EncodePlane is the one place the fleet is encoded: a
per-cluster-view, refcounted cache that every subscriber consumes through a
``ProblemState`` handle (``plane.subscribe(name) -> PlaneHandle``; the
handle class IS ``provisioning.problem_state.ProblemState``, so every
existing call site keeps working). Rows are encoded once per revision bump
and shared across subscribers; per-subscriber state shrinks to warm-pack
checkpoints and wire mirrors.

What the PLANE owns (shared across subscribers, content/token-gated so
sharing can never change a decision):

- **node rows** — per-node encoded requirement rows / available vectors /
  zone indices / taint views, keyed ``(name, identity)`` with validity
  token ``(identity, revision)``. TWO generations are kept (``cur`` +
  ``prev``): provisioning encodes the full node list while disruption
  encodes the non-deleting subset, and a single-generation replace (the
  old private-state behavior) would drop the complement on every
  alternation. A row served from either generation is still revision-
  checked, so a stale generation can never leak an outdated encode.
- **node stacks** — the pow2-padded stacked exist tensors, an LRU of the
  last ``MAX_STACKS`` distinct ``exist_token``s (one slot per live node
  subset: provisioning's and disruption's alternating views both stay
  resident instead of rebuilding each other's stack every pass).
- **group rows** — encoded requirement rows + request vectors keyed by the
  content-stable ``grouping.group_signature``; a deployment shape encoded
  by ANY subscriber is a cache hit for every other.
- **topology memos** — per-group cluster topology occupancy keyed by the
  FULL topology token ``(topo_revision, zone_names, node_names,
  scheduled-batch uids)``, an LRU of ``MAX_TOPO_TOKENS`` tokens.
  Provisioning and disruption carry different node tuples / exclusion
  sets, so each gets its own memo dict; the token proves validity, so a
  revisited token may serve its memo (the old single-slot state merely
  discarded it).
- **drought masks + device uploads** — already shared through the
  content-keyed catalog-encoding cache: the masked-offering device slot
  (``device_cache["drought"]``, keyed per live-pattern set) and the
  exist-side device upload (``("exist_side",) + placer namespace`` slot,
  keyed by ``(exist_token, device_token)`` in ``ops/binpack._device_args``)
  live on the vocab's ``device_cache``, so equal content means ONE upload
  serving every subscriber. The plane's row/stack sharing is what makes
  the tokens collide in the first place.
- **topo_revision** — a monotonic revision for WIRE-backed cluster views
  (sidecar sessions): the plane itself is the ``cluster`` object hung off
  the session's WireClusterView, replacing the old per-session
  ``_ClusterRev`` shim. Real ``state.cluster.Cluster`` views carry their
  own revision; this field is only read where no Cluster exists.

What each SUBSCRIBER HANDLE keeps private (see ProblemState):

- warm-pack checkpoints (``seed``) — packer state is
  sequential solver memory, valid only against the subscriber's own last
  pack; sharing would replay another solver's decisions.
- mesh attachment (``attach_mesh``) + per-shard exist tokens — bound to
  the subscriber's mesh carve.
- the tensors memo (group-part/exist-part device tensors of the LAST
  precompute) — a single slot keyed by the subscriber's own group set;
  shared, it would thrash between provisioning's and disruption's group
  axes every alternation.
- per-solve signature memo and ``last``/``stats`` reporting, including
  ``encode_kind`` (cold/delta): reported against the subscriber's OWN
  previous pass, byte-identical to the private-state behavior.

Merged invalidation matrix — every delta a pass can carry, what it costs,
and WHO pays (supersedes the overlap of DEVIATIONS 19/20/24; the sharded
and wire-delta specifics remain in those entries):

| delta                          | plane effect           | subscriber effect |
|--------------------------------|------------------------|-------------------|
| pod arrival/completion         | group rows reused      | warm prefix cut   |
| (known signature)              | (shared hit)           | at first dirty    |
|                                |                        | FFD position      |
| new deployment shape           | ONE group row encoded, | warm prefix cut   |
|                                | shared by all          |                   |
| new vocab entry / catalog      | new vocab object: all  | cold encode       |
| change (masks enumerate the    | row caches for the old | reported per      |
| value universe)                | vocab age out of the   | handle            |
|                                | per-vocab LRUs         |                   |
| node add/remove/update         | dirty rows re-encode   | warm pack         |
|                                | ONCE; clean rows serve | disabled for the  |
|                                | every subscriber; new  | pass (exist_avail |
|                                | exist_token stacks +   | is shared mutable |
|                                | uploads                | packer state)     |
| subscriber node-subset change  | rows shared via the    | none (token-      |
| (provision all / disrupt       | two-generation cache;  | exact)            |
| non-deleting alternation)      | per-subset stack slots |                   |
| scheduled-pod/binding change   | per-token topo memo    | none              |
| (topo_revision bump)           | recomputes misses only |                   |
| daemonset set change           | node caches for that   | warm token        |
|                                | vocab wiped (overhead  | changes           |
|                                | rides avail vectors)   |                   |
| drought mark/expiry            | masked device slot     | warm pack         |
| (unavailable-offerings bump)   | re-keyed per pattern   | invalidated via   |
|                                | set (vocab-shared)     | global token      |
| mesh attach/detach/shard flip  | none (rows, stacks,    | exist tokens +    |
|                                | memos shard-agnostic)  | tensors memo      |
|                                |                        | dropped           |
| subscriber join/leave          | refcount only — caches | fresh handle      |
|                                | never invalidate       | starts cold on    |
|                                |                        | its private state |

Anything the matrix cannot express falls back to a cold encode/pack; the
fallback is always decision-equivalent, never semantic. Pinned by: the
churn fuzzer (tests/test_problem_state.py), the streaming-disruption
fuzzer, the sidecar parity probes, the sim-regression goldens, and the
combined-loop fuzzer (tests/test_state_plane.py) which interleaves all
three subscribers over ONE plane and asserts bit-identical decisions vs
three private states.

NOT thread-safe (same contract as ProblemState): a plane is owned by one
single-threaded solver loop — or one sidecar session whose lock serializes
solves — and handles borrow it one at a time. Only the process-wide live-
plane registry (the subscriber gauge + /debug/stateplane) is locked.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from ..ops import encode as enc
from ..scheduling.requirements import Requirements
from . import audit as _audit

# bound on signature-keyed caches: distinct deployment shapes seen across
# the plane's lifetime. Past it the cache clears wholesale (simple + rare:
# a production cluster cycles far fewer shapes than this).
MAX_SIG_ENTRIES = 4096
# distinct vocab objects kept resident per cache family: provisioning and
# disruption normally share ONE content-keyed catalog encoding, so 2 covers
# a catalog roll (old + new) without thrash
MAX_NODE_VOCABS = 2
# distinct exist_token stacks kept per vocab: the provisioning (all nodes)
# and disruption (non-deleting) views alternate, so both stay resident
MAX_STACKS = 2
# distinct full topology tokens kept resident (provisioning + disruption
# carry different node tuples/exclusion sets, plus one catalog-roll spare)
MAX_TOPO_TOKENS = 4

# process-wide registry of live planes: feeds the subscriber gauge and the
# /debug/stateplane endpoint; weak so an evicted session's plane vanishes
_LIVE_PLANES: "weakref.WeakSet" = weakref.WeakSet()
_LIVE_LOCK = threading.Lock()


def live_planes() -> list:
    with _LIVE_LOCK:
        return sorted(_LIVE_PLANES, key=lambda p: p.name)


def refresh_subscriber_gauge() -> None:
    """Re-derive karpenter_state_plane_subscribers from the live planes:
    prune-then-set so a garbage-collected plane's series disappears instead
    of freezing at its last value."""
    from ..metrics.registry import STATE_PLANE_SUBSCRIBERS
    planes = live_planes()
    STATE_PLANE_SUBSCRIBERS.prune([{"plane": p.name} for p in planes])
    for p in planes:
        STATE_PLANE_SUBSCRIBERS.set(
            float(sum(p.subscribers.values())), {"plane": p.name})


class _NodeCache:
    """Per-vocab node-row state: two row generations + the stack LRU."""

    __slots__ = ("ds_token", "cur", "prev", "stacks")

    def __init__(self, ds_token):
        self.ds_token = ds_token
        self.cur: Dict[tuple, tuple] = {}
        self.prev: Dict[tuple, tuple] = {}
        self.stacks: "OrderedDict[tuple, tuple]" = OrderedDict()


class EncodePlane:
    """The shared encode/cache plane. Subscribers hold ProblemState handles
    (``subscribe``); every cache below is content/token-gated, so sharing
    is invisible to scheduling truth by construction."""

    def __init__(self, name: str = "private"):
        self.name = name
        # optional StateAuditor (state/audit.py): when attached, every row
        # serve is digest-verified and each pass runs sampled shadow
        # audits; None keeps the pre-audit fast path byte-identical
        self.auditor = None
        # monotonic revision for wire-backed cluster views (sidecar): the
        # plane IS the `cluster` object on the session's WireClusterView
        self.topo_revision = 0
        # subscriber name -> live handle count (refcount)
        self.subscribers: Dict[str, int] = {}
        # vocab -> _NodeCache (strong vocab refs keep ids from recycling,
        # exactly like the old per-state `_node_vocab` field did)
        self._node_caches: "OrderedDict" = OrderedDict()
        # vocab -> {signature -> (enc_row, req_vec)}
        self._group_caches: "OrderedDict" = OrderedDict()
        # full topology token -> {signature -> (izc, exist, host_total)}
        self._topo_memos: "OrderedDict" = OrderedDict()
        self.stats = {
            "node_rows_encoded": 0, "node_rows_shared": 0,
            "group_rows_encoded": 0, "group_rows_shared": 0,
            "stack_builds": 0, "stack_hits": 0,
        }
        with _LIVE_LOCK:
            _LIVE_PLANES.add(self)

    # -- subscriber lifecycle ------------------------------------------------

    def subscribe(self, subscriber: str = "subscriber"):
        """New PlaneHandle (a ProblemState bound to this plane)."""
        from ..provisioning.problem_state import ProblemState
        return ProblemState(plane=self, subscriber=subscriber)

    def _attach(self, subscriber: str) -> None:
        self.subscribers[subscriber] = self.subscribers.get(subscriber, 0) + 1
        refresh_subscriber_gauge()

    def release(self, subscriber: str) -> None:
        """Drop one refcount; caches are never invalidated by membership
        (they are content-gated), so release only updates accounting."""
        n = self.subscribers.get(subscriber, 0) - 1
        if n <= 0:
            self.subscribers.pop(subscriber, None)
        else:
            self.subscribers[subscriber] = n
        refresh_subscriber_gauge()

    def bump_topo_revision(self) -> int:
        self.topo_revision += 1
        return self.topo_revision

    # -- node rows -----------------------------------------------------------

    def _node_cache(self, vocab, ds_token) -> _NodeCache:
        cache = self._node_caches.get(vocab)
        if cache is None:
            cache = _NodeCache(ds_token)
            self._node_caches[vocab] = cache
            while len(self._node_caches) > MAX_NODE_VOCABS:
                self._node_caches.popitem(last=False)
        else:
            self._node_caches.move_to_end(vocab)
            if cache.ds_token != ds_token:
                # daemonset overhead rides inside every avail vector
                cache.cur = {}
                cache.prev = {}
                cache.stacks.clear()
                cache.ds_token = ds_token
        return cache

    @staticmethod
    def _encode_node_rows(vocab, zone_key: int, nodes, daemonset_pods,
                          revs) -> list:
        """Cold-encode node rows, one (rev, enc_row, avail_row, zone,
        taints) per node, through build_problem's own cold construction
        (tensor_scheduler.encode_node_rows); the auditor's shadow audits
        reuse exactly this path, so a shadow compare is a true cold
        replay."""
        from ..provisioning.tensor_scheduler import encode_node_rows
        e, avail, zones, taints, _ = encode_node_rows(
            vocab, zone_key, nodes, daemonset_pods, len(nodes))
        return [(rev,
                 enc.EncodedRequirements(
                     mask=e.mask[j], defined=e.defined[j],
                     complement=e.complement[j], exempt=e.exempt[j],
                     gt=e.gt[j], lt=e.lt[j]),
                 avail[j], int(zones[j]), taints.lists[j])
                for j, rev in enumerate(revs)]

    def _quarantine_node_layer(self, cache: _NodeCache, auditor) -> None:
        """Per-layer quarantine: one corrupted row means neither
        generation (nor any stack built from them) can be trusted — drop
        them all and rebuild cold within the same pass."""
        cache.cur = {}
        cache.prev = {}
        cache.stacks.clear()
        auditor.quarantine_stacks()

    def node_rows(self, vocab, zone_key: int, state_nodes, daemonset_pods,
                  ds_token: tuple, exist_shards: int, subscriber: str
                  ) -> tuple:
        """(exist_enc, exist_avail, exist_zone, taints, exist_token,
        reencoded, shard_tokens, shard_dirty) — byte-identical to what
        build_problem's cold path constructs, with only dirty rows
        re-encoded ONCE for every subscriber. With an auditor attached,
        rows carry a trailing content digest (consumers index fields 0-4,
        so the extra element is invisible to them) verified on every
        serve; a mismatch quarantines the layer and the outer loop
        restarts ONCE over the now-cold caches — the second attempt
        re-encodes everything, so it cannot quarantine again."""
        from ..provisioning.tensor_scheduler import NodeTaints, _pow2_bucket
        auditor = self.auditor
        cache = self._node_cache(vocab, ds_token)
        for _attempt in (0, 1):
            cur, prev = cache.cur, cache.prev
            dirty_idx: List[int] = []
            dirty_revs: List[tuple] = []
            picked: List[Optional[tuple]] = []
            keys = []
            quarantined = False
            for i, sn in enumerate(state_nodes):
                # cache key (name, identity); row-validity token (identity,
                # revision). The identity distinguishes both a deleted-and-
                # recreated node under the same name (whose replayed event
                # sequence can land on the same revision count) and two live
                # StateNodes sharing a name (placeholder + claim entries) —
                # name alone would alias their rows in the stacked tensors.
                key = (sn.name(), getattr(sn, "identity", None))
                keys.append(key)
                rev = (key[1], getattr(sn, "revision", None))
                row = cur.get(key)
                if row is None:
                    row = prev.get(key)
                if row is None or rev[0] is None or rev[1] is None \
                        or row[0] != rev:
                    # encoded below, with the other dirty rows at once
                    row = None
                    dirty_idx.append(i)
                    dirty_revs.append(rev)
                elif auditor is not None and len(row) > 5 \
                        and _audit.row_digest(row) != row[5]:
                    auditor.incident("node_rows",
                                     f"row {key[0]!r} failed its serve-time "
                                     "digest")
                    self._quarantine_node_layer(cache, auditor)
                    quarantined = True
                    break
                elif auditor is not None and len(row) <= 5:
                    # adopted: encoded while no auditor was attached, so
                    # digest it on first audited serve (verify_group's
                    # adopt semantics) — from here on it is verifiable
                    row = row + (_audit.row_digest(row),)
                picked.append(row)
            reencoded = len(dirty_idx)
            if not quarantined and dirty_idx:
                rows = self._encode_node_rows(
                    vocab, zone_key, [state_nodes[i] for i in dirty_idx],
                    daemonset_pods, dirty_revs)
                for i, row in zip(dirty_idx, rows):
                    if auditor is not None:
                        row = row + (_audit.row_digest(row),)
                    picked[i] = row
            fresh: Dict[tuple, tuple] = dict(zip(keys, picked))
            if not quarantined and auditor is not None \
                    and reencoded < len(state_nodes):
                # sampled shadow audit: re-encode K clean rows cold and
                # byte-compare — catches a row whose digest was recorded
                # over already-wrong content (the lazy check cannot)
                dirty = set(dirty_idx)
                clean = [i for i in range(len(state_nodes))
                         if i not in dirty]
                for j in auditor.sample_indices(len(clean)):
                    i = clean[j]
                    sn = state_nodes[i]
                    row = fresh[keys[i]]
                    (cold,) = self._encode_node_rows(vocab, zone_key, [sn],
                                                     daemonset_pods,
                                                     [row[0]])
                    if _audit.row_digest(cold) != _audit.row_digest(row):
                        auditor.incident(
                            "node_rows",
                            f"row {sn.name()!r} diverged from its cold "
                            "shadow re-encode")
                        self._quarantine_node_layer(cache, auditor)
                        quarantined = True
                        break
                    auditor.audited("node_rows")
            if not quarantined:
                break
        cache.prev = cache.cur
        cache.cur = fresh
        self.stats["node_rows_encoded"] += reencoded
        shared = len(state_nodes) - reencoded
        self.stats["node_rows_shared"] += shared
        if reencoded or shared:
            from ..metrics.registry import STATE_PLANE_ROWS
            if reencoded:
                STATE_PLANE_ROWS.inc({"subscriber": subscriber,
                                      "outcome": "reencoded"},
                                     value=reencoded)
            if shared:
                STATE_PLANE_ROWS.inc({"subscriber": subscriber,
                                      "outcome": "shared"}, value=shared)
        revs = tuple((k, getattr(sn, "revision", None))
                     for k, sn in zip(keys, state_nodes))
        exist_token = (vocab, ds_token, revs)
        N = len(state_nodes)
        Np = _pow2_bucket(N, 16)
        # per-shard exist tokens over contiguous Np/S row spans: a dirty
        # row only breaks ITS span's token, so the mesh placer re-uploads
        # one shard's block (rows past N are padding — constant, so they
        # ride the span token implicitly via s/S/Np)
        S = int(exist_shards)
        shard_tokens = None
        shard_dirty = None
        if S > 1 and Np % S == 0:
            from ..metrics.registry import PROBLEM_STATE_SHARD_ROWS
            shard_dirty = {}
            toks = []
            for s, (start, stop) in enumerate(enc.shard_spans(Np, S)):
                real = max(0, min(stop, N) - start)
                d = sum(1 for i in dirty_idx if start <= i < stop)
                shard_dirty[s] = d
                toks.append((vocab, ds_token, revs[start:start + real],
                             s, S, Np))
                if d:
                    PROBLEM_STATE_SHARD_ROWS.inc(
                        {"shard": str(s), "outcome": "reencoded"}, value=d)
                if real - d:
                    PROBLEM_STATE_SHARD_ROWS.inc(
                        {"shard": str(s), "outcome": "clean"},
                        value=real - d)
            shard_tokens = tuple(toks)
        stack = cache.stacks.get(exist_token)
        if stack is not None and auditor is not None:
            # the slot digest guards the stacked tensors themselves: rows
            # are verified above, but a stack is a cached COPY of them
            if auditor.verify_stack(exist_token, stack):
                auditor.audited("exist_stack")
            else:
                auditor.incident("exist_stack",
                                 f"slot of {N} rows failed its digest")
                cache.stacks.clear()
                auditor.quarantine_stacks()
                stack = None
        if stack is not None:
            cache.stacks.move_to_end(exist_token)
            self.stats["stack_hits"] += 1
            return stack + (exist_token, reencoded, shard_tokens,
                            shard_dirty)
        encs = [fresh[k][1] for k in keys]
        taints = NodeTaints([fresh[k][4] for k in keys])
        if Np > N:
            zero = enc.encode_requirements(vocab, Requirements())
            encs = encs + [zero] * (Np - N)
        exist_enc = enc.stack_encoded(encs)
        avail = np.stack([fresh[k][2] for k in keys])
        exist_avail = np.concatenate(
            [avail, np.zeros((Np - N,) + avail.shape[1:], avail.dtype)]) \
            if Np > N else avail
        zones = np.array([fresh[k][3] for k in keys], dtype=np.int32)
        exist_zone = np.concatenate([zones, np.full(Np - N, -1, np.int32)]) \
            if Np > N else zones
        stack = (exist_enc, exist_avail, exist_zone, taints)
        cache.stacks[exist_token] = stack
        while len(cache.stacks) > MAX_STACKS:
            cache.stacks.popitem(last=False)
        self.stats["stack_builds"] += 1
        if auditor is not None:
            auditor.record_stack(exist_token, stack)
        return stack + (exist_token, reencoded, shard_tokens, shard_dirty)

    # -- group rows ----------------------------------------------------------

    def group_row(self, vocab, sig: tuple, g, subscriber: str) -> tuple:
        """((enc_row, req_vec), encoded) for one group, signature-cached
        per vocab and shared by every subscriber."""
        from ..metrics.registry import STATE_PLANE_ROWS
        rows = self._group_caches.get(vocab)
        if rows is None:
            rows = {}
            self._group_caches[vocab] = rows
            while len(self._group_caches) > MAX_NODE_VOCABS:
                self._group_caches.popitem(last=False)
        else:
            self._group_caches.move_to_end(vocab)
        auditor = self.auditor
        row = rows.get(sig)
        if row is not None and auditor is not None:
            # lazy digest check on reuse; group rows must stay 2-tuples
            # (callers unpack them), so digests live in the auditor's
            # side table rather than on the row
            if not auditor.verify_group(vocab, sig, row):
                auditor.incident("group_rows",
                                 "cached row failed its serve-time digest")
                rows.clear()
                auditor.quarantine_groups(vocab)
                row = None
            elif auditor.take_group_audit():
                cold = (enc.encode_requirements(vocab, g.requirements),
                        enc.encode_resource_vector(vocab, g.requests,
                                                   capacity=False))
                if _audit.content_digest(cold) != _audit.content_digest(row):
                    auditor.incident(
                        "group_rows",
                        "cached row diverged from its cold shadow re-encode")
                    rows.clear()
                    auditor.quarantine_groups(vocab)
                    row = None
                else:
                    auditor.audited("group_rows")
        if row is not None:
            self.stats["group_rows_shared"] += 1
            STATE_PLANE_ROWS.inc({"subscriber": subscriber,
                                  "outcome": "shared"})
            return row, False
        if len(rows) >= MAX_SIG_ENTRIES:
            rows.clear()
        row = (enc.encode_requirements(vocab, g.requirements),
               enc.encode_resource_vector(vocab, g.requests,
                                          capacity=False))
        rows[sig] = row
        if auditor is not None:
            auditor.record_group(vocab, sig, row)
        self.stats["group_rows_encoded"] += 1
        STATE_PLANE_ROWS.inc({"subscriber": subscriber,
                              "outcome": "reencoded"})
        return row, True

    # -- topology memos ------------------------------------------------------

    def topo_memo(self, token: tuple) -> dict:
        """The signature->counts memo dict for one FULL topology token.
        The token (topo_revision, zone names, node names, scheduled-batch
        uids) proves validity on its own, so distinct subscribers' tokens
        coexist and a revisited token may serve its memo. Callers mutate
        the returned dict in place (including the overflow wipe)."""
        memo = self._topo_memos.get(token)
        if memo is None:
            memo = {}
            self._topo_memos[token] = memo
            while len(self._topo_memos) > MAX_TOPO_TOKENS:
                self._topo_memos.popitem(last=False)
        else:
            self._topo_memos.move_to_end(token)
        return memo

    # -- introspection (/debug/stateplane) -----------------------------------

    def debug_view(self) -> dict:
        # iterate COPIED views: the owning solver loop mutates these
        # OrderedDicts mid-pass while the /debug/stateplane HTTP thread
        # renders them (the caller still retries a lost race, see
        # operator/server._debug_stateplane)
        node_caches = []
        for vocab, cache in list(self._node_caches.items()):
            node_caches.append({
                "vocab": hex(id(vocab)),
                "rows_cur": len(cache.cur), "rows_prev": len(cache.prev),
                "stacks": len(cache.stacks),
            })
        view = {
            "name": self.name,
            "subscribers": dict(self.subscribers),
            "topo_revision": self.topo_revision,
            "node_caches": node_caches,
            "group_rows": {hex(id(v)): len(rows)
                           for v, rows in list(self._group_caches.items())},
            "topo_tokens": len(self._topo_memos),
            "stats": dict(self.stats),
        }
        if self.auditor is not None:
            view["audit"] = {
                "passes": self.auditor.passes,
                "incidents": len(self.auditor.incidents),
                "stats": dict(self.auditor.stats),
            }
        return view
