"""Sidecar client: a Scheduler-shaped proxy over the gRPC boundary.

RemoteScheduler mirrors TensorScheduler's solve() contract so the
Provisioner can swap it in (options.solver_backend = "sidecar") without any
controller change — the hiding-behind-the-interface requirement of the north
star.
"""

from __future__ import annotations

import bisect
import hashlib
import os
import random
import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import grpc

from ..api.objects import Pod
from . import codec
from .server import SERVICE

# gRPC codes the resilient client treats as RETRYABLE: the request (or
# its response) plausibly never made it, or the server shed it from the
# admission queue BEFORE applying it (RESOURCE_EXHAUSTED — the "back off
# and retry here" contract the shed reasons document). A retry of the
# identical bytes is safe because the server dedupes session solves by
# request digest (at-most-once apply) and the one-shot Solve is stateless.
_RETRYABLE = (grpc.StatusCode.UNAVAILABLE, grpc.StatusCode.DEADLINE_EXCEEDED,
              grpc.StatusCode.RESOURCE_EXHAUSTED)
# fleet mode additionally retries CANCELLED: a replica hard-stopping mid-RPC
# cancels the in-flight call, and the request-digest dedupe makes resending
# the identical bytes to the ring successor at-most-once apply. Single-server
# clients keep the narrow set — there is nowhere else to send the retry.
_RETRYABLE_FLEET = _RETRYABLE + (grpc.StatusCode.CANCELLED,)
_RETRY_LABELS = {
    grpc.StatusCode.UNAVAILABLE: "unavailable",
    grpc.StatusCode.DEADLINE_EXCEEDED: "deadline_exceeded",
    grpc.StatusCode.RESOURCE_EXHAUSTED: "resource_exhausted",
    grpc.StatusCode.CANCELLED: "cancelled",
}


@dataclass
class RetryPolicy:
    """Fault policy for every sidecar RPC: a per-RPC deadline
    so a stalled server can never hang the caller, jittered exponential
    backoff between retries of retryable codes (UNAVAILABLE /
    DEADLINE_EXCEEDED), a token retry BUDGET so a down server gets a
    bounded retry storm instead of max_attempts per caller forever
    (retries spend a token, successes refund `refund` up to the budget —
    the SRE retry-budget shape), and optional HEDGING: after
    ``hedge_delay`` seconds with no response a second identical request
    races the first (safe: a solve is a pure function of session state
    and the server dedupes by request digest). ``sleep`` is injectable so
    tests and the simulator never wait wall-clock backoff."""

    deadline: float = 120.0      # per-RPC seconds; <= 0 disables. Sized
    #                              well above the worst legitimate
    #                              service-path solve (headline 50k-pod
    #                              bootstrap is ~2s; the repo's largest
    #                              solver runs are ~2min) — a deadline a
    #                              slow-but-healthy solve can exceed turns
    #                              it into a hard failure that re-solving
    #                              cannot fix
    max_attempts: int = 4        # total attempts per RPC (1 = no retry)
    backoff_base: float = 0.05
    backoff_mult: float = 2.0
    backoff_cap: float = 2.0
    jitter: float = 0.5          # +/- fraction of the delay
    hedge_delay: float = 0.0     # seconds; <= 0 disables hedging
    retry_budget: float = 8.0    # token bucket ceiling
    refund: float = 0.5          # tokens refunded per successful RPC
    sleep: "object" = time.sleep

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        return cls(
            deadline=float(os.environ.get("KARPENTER_SIDECAR_DEADLINE",
                                          "120")),
            max_attempts=int(os.environ.get(
                "KARPENTER_SIDECAR_MAX_ATTEMPTS", "4")),
            hedge_delay=float(os.environ.get(
                "KARPENTER_SIDECAR_HEDGE_DELAY", "0")))


def _retry_attempts(attempt, rp: RetryPolicy, rng: random.Random,
                    spend_token, refund_token, retryable=_RETRYABLE):
    """The one attempt loop both client surfaces share: retryable wire
    faults (UNAVAILABLE / DEADLINE_EXCEEDED) back off with jitter and
    resend the IDENTICAL bytes until max_attempts or the token retry
    budget runs dry; every other status propagates to the caller's
    structural handling. Returns (response, retries_taken)."""
    from ..metrics.registry import SIDECAR_CLIENT_RETRIES
    delay = rp.backoff_base
    attempt_no = 1
    retries = 0
    while True:
        try:
            response = attempt()
        except grpc.RpcError as e:
            code = getattr(e, "code", lambda: None)()
            if code not in retryable or attempt_no >= rp.max_attempts \
                    or not spend_token():
                raise
            SIDECAR_CLIENT_RETRIES.inc({"code": _RETRY_LABELS[code]})
            retries += 1
            jittered = delay * (1.0 + rp.jitter
                                * (2.0 * rng.random() - 1.0))
            rp.sleep(max(0.0, jittered))
            delay = min(delay * rp.backoff_mult, rp.backoff_cap)
            attempt_no += 1
            continue
        refund_token()
        return response, retries


class _RetryBudgetMixin:
    """The token retry budget both client surfaces hang off `self.retry`:
    retries spend a token, successes refund `retry.refund` up to the
    `retry.retry_budget` ceiling (`_retry_tokens` is the live level —
    harnesses reset it directly when swapping policies)."""

    def _spend_retry_token(self) -> bool:
        if self._retry_tokens < 1.0:
            return False
        self._retry_tokens -= 1.0
        return True

    def _refund_retry_token(self) -> None:
        self._retry_tokens = min(self.retry.retry_budget,
                                 self._retry_tokens + self.retry.refund)


# -- sidecar fleet routing -----------------------------------------------------


def _parse_rider(details: str, key: str) -> str:
    """Extract a `[key=value]` rider from a gRPC status detail string — the
    fleet servers attach structured hints (migrated_to on a draining NACK,
    server_digest on a digest-mismatch abort) inside the human-readable
    message so no wire schema change is needed for error metadata."""
    m = re.search(rf"\[{re.escape(key)}=([^\]\s]+)\]", details or "")
    return m.group(1) if m else ""


def _default_channel_factory(address: str) -> grpc.Channel:
    from .server import GRPC_OPTIONS
    return grpc.insecure_channel(address, options=GRPC_OPTIONS)


class ConsistentHashRouter:
    """Consistent-hash ring over the fleet's replica addresses: a tenant
    always lands on the same replica while the fleet is stable (session
    affinity keeps the server-side delta mirrors warm), adding/removing a
    replica only moves ~1/N of tenants, and a down replica's tenants walk
    to the ring SUCCESSOR — the same replica every client picks without
    coordination, so the handoff-store restore happens exactly once.
    mark_down() is a cooldown, not a tombstone: after `cooldown` seconds
    the replica is routable again (a restarted process rejoins without any
    control-plane signal)."""

    def __init__(self, addresses, vnodes: int = 64, cooldown: float = 5.0,
                 clock=time.monotonic):
        self.addresses = tuple(dict.fromkeys(addresses))
        if not self.addresses:
            raise ValueError("fleet router needs at least one replica "
                             "address")
        self.vnodes = max(1, int(vnodes))
        self.cooldown = float(cooldown)
        self._clock = clock
        self._down: Dict[str, float] = {}
        ring = sorted((self._point(f"{addr}#{v}"), addr)
                      for addr in self.addresses
                      for v in range(self.vnodes))
        self._ring = ring
        self._keys = [k for k, _ in ring]

    @staticmethod
    def _point(key: str) -> int:
        return int.from_bytes(hashlib.sha256(key.encode()).digest()[:8],
                              "big")

    def mark_down(self, address: str) -> None:
        self._down[address] = self._clock()

    def mark_up(self, address: str) -> None:
        self._down.pop(address, None)

    def _alive(self, address: str) -> bool:
        stamp = self._down.get(address)
        if stamp is None:
            return True
        if self._clock() - stamp >= self.cooldown:
            del self._down[address]
            return True
        return False

    def _walk(self, key: str, exclude=()) -> str:
        start = bisect.bisect(self._keys, self._point(key))
        seen = set()
        for step in range(len(self._ring)):
            addr = self._ring[(start + step) % len(self._ring)][1]
            if addr in seen:
                continue
            seen.add(addr)
            if addr not in exclude and self._alive(addr):
                return addr
        # the whole fleet is down/excluded: hand back the raw ring owner —
        # retry backoff (not the router) is the right tool from here
        return self._ring[start % len(self._ring)][1]

    def route(self, tenant: str) -> str:
        return self._walk(tenant or "default")

    def successor(self, tenant: str, exclude=()) -> str:
        return self._walk(tenant or "default", exclude=tuple(exclude))


@dataclass
class RemoteNodeClaim:
    """Launch decision reconstructed from the wire; satisfies both consumer
    contracts — the provisioner's (to_nodeclaim() + pods) and the disruption
    solver's (requirements + instance_type_options + the price filter)."""
    api_nodeclaim: object
    pods: List[Pod]
    requirements: object = None          # scheduling.Requirements
    instance_type_options: list = field(default_factory=list)

    def finalize(self) -> None:
        pass  # server already finalized before encoding

    def to_nodeclaim(self):
        # reflect any client-side instance-type filtering back into the claim
        if self.instance_type_options:
            from ..api import labels as api_labels
            names = tuple(it.name
                          for it in self.instance_type_options[:60])
            for r in self.api_nodeclaim.spec.requirements:
                if r.key == api_labels.LABEL_INSTANCE_TYPE:
                    r.values = names
        return self.api_nodeclaim

    def remove_instance_types_by_price_and_min_values(self, reqs, max_price):
        from ..cloudprovider.types import (below_worst_launch_price,
                                           satisfies_min_values)
        self.instance_type_options, _ = below_worst_launch_price(
            self.instance_type_options, reqs, max_price)
        _, err = satisfies_min_values(self.instance_type_options, reqs)
        if err is not None:
            return None, err
        return self, None

    @property
    def template(self):
        return self  # nodepool_name passthrough

    @property
    def nodepool_name(self):
        from ..api import labels as api_labels
        return self.api_nodeclaim.metadata.labels.get(
            api_labels.NODEPOOL_LABEL_KEY, "")


@dataclass
class RemoteExistingNode:
    name: str
    pods: List[Pod]


@dataclass
class RemoteResults:
    new_nodeclaims: list = field(default_factory=list)
    existing_nodes: list = field(default_factory=list)
    pod_errors: Dict[str, str] = field(default_factory=dict)
    fallback_reason: str = ""
    # delta-session response riders: how the server produced this solve
    encode_kind: str = ""        # "cold" | "delta" (delta wire only)
    parity: str = ""             # parity_check samples: "byte-identical"
    queue_wait_ms: float = 0.0   # admission-queue wait server-side
    warm: str = ""               # warm-pack outcome (ProblemState.last)
    # fault-path riders: how this answer survived the wire
    degraded: str = ""           # "host_oracle" when the circuit breaker
    #                              forced the fallback path server-side
    partition: tuple = (0, 0)    # (tensor_pods, host_pods) server-side
    deadline_s: float = 0.0      # per-RPC deadline this solve ran under
    retries: int = 0             # wire retries this solve needed
    hedged: bool = False         # a hedged request produced this answer
    # causal-observability riders: the trace id the server's
    # span tree ran under — equal to the client's own trace id when the
    # wire carried trace_ctx (the cross-process join worked) — and the
    # solve's fallback cost attribution (obs/fallbacks shape)
    trace_id: str = ""
    fallback_attribution: dict = field(default_factory=dict)

    def all_pods_scheduled(self) -> bool:
        return not self.pod_errors


class SolverSession(_RetryBudgetMixin):
    """Persistent DELTA solver session over one gRPC channel.

    The heavy, slow-changing inputs — nodepools, the instance-type catalog,
    state nodes, daemonset pods, the topology cluster snapshot AND the pod
    batch itself — live server-side; each solve ships only what changed
    since the last ACKED solve: new pod templates, pod row add/removes
    (keyed by the template-dedup tokens), node upserts keyed by
    ``StateNode.revision``, and daemonset/cluster snapshots on token bumps.
    Every request carries a content digest of the client's post-apply view;
    the server verifies it against its own state and a mismatch (or a
    session eviction) triggers a transparent full-snapshot resync. Commit
    of every mirror happens ONLY after the solve RPC succeeds — committing
    optimistically would let a transient RPC failure permanently desync
    the two sides (the next diff would see nothing to resend).

    Catalog identity is tracked by object ids (with strong refs held so ids
    can't be recycled) and falls back to a content digest when the provider
    hands over fresh objects with unchanged content."""

    def __init__(self, address: str, channel: Optional[grpc.Channel] = None,
                 tenant: str = "", parity_every: int = 0,
                 retry: Optional[RetryPolicy] = None):
        from .server import GRPC_OPTIONS
        self.address = address
        self.tenant = tenant
        # fault policy: deadline + jittered backoff + retry budget +
        # optional hedging for every RPC this session issues. The jitter
        # RNG is entropy-seeded: identical replicas retrying the same
        # outage must NOT share a schedule (synchronized retry waves are
        # what jitter exists to prevent). Jitter only shapes wall-clock
        # sleeps, so the simulator's ledger digest is unaffected.
        self.retry = retry if retry is not None else RetryPolicy.from_env()
        self._rng = random.Random()
        self._retry_tokens = self.retry.retry_budget
        # every Nth solve carries parity_check: the server re-solves the
        # identical session state COLD (no ProblemState) and compares
        # canonical decision digests — the sampled delta-vs-cold audit
        self.parity_every = parity_every
        self._channel = channel or grpc.insecure_channel(
            address, options=GRPC_OPTIONS)
        self._session_id: Optional[str] = None
        self._id_sig = None
        self._id_refs = None      # strong refs backing _id_sig
        self._content_key = None
        # -- delta mirrors of the server-side session state ------------------
        self._tmpl_ids: dict = {}    # template content key -> server id
        self._tmpl_keys: list = []   # server id -> content key
        self._tmpl_constrained: list = []  # server id -> carries topo/aff
        self._tmpl_digest = codec.templates_digest(())
        self._rows: list = []        # [(uid, tid, ts)] in server batch order
        self._synced = False         # False -> next solve ships a snapshot
        # pod-identity row cache: id(pod) -> (pod ref, resource_version,
        # row). A pod object unchanged since the last acked solve skips
        # template re-encoding entirely — the dominant client cost on a
        # steady 50k batch. The strong pod ref keeps the id from being
        # recycled; a store update bumps resource_version and invalidates.
        self._pod_rows: dict = {}
        self._node_tokens: dict = {} # name -> opaque rev token (digest input)
        self._node_revs: dict = {}   # name -> (identity, revision, limits)
        self._node_dicts: dict = {}  # content-compare fallback (no revision)
        self._ds_sent: Optional[list] = None
        self._ds_token = ""
        self._cluster_token = ""
        self._solve_seq = 0
        import itertools
        self._req_seq = itertools.count(1)  # idempotency nonce sequence
        # -- observability ---------------------------------------------------
        self.resyncs = 0             # error-driven full resyncs
        self.retries = 0             # wire-fault retries (UNAVAILABLE/
        #                              DEADLINE_EXCEEDED, backoff path)
        self.hedges = 0              # hedged requests fired
        self.hedges_won = 0          # hedges that answered first
        self.last_encode_kind = ""
        self.last_parity = ""
        self.last_queue_wait_ms = 0.0
        self._hedged_last = False
        # -- fleet routing ----------------------------------------------------
        # consistent-hash router over N replica addresses (enable_fleet);
        # committed-state history backs the digest-rider catch-up: when a
        # restored replica reports an OLDER digest we roll the mirrors back
        # to that acked state and resend only the delta since — a bounded
        # catch-up instead of a full resync
        self.router: Optional[ConsistentHashRouter] = None
        self._channel_factory = _default_channel_factory
        self._unavailable_streak = 0
        self.failovers = 0           # replica switches (fleet mode)
        self.catchups = 0            # digest-rider rollbacks that avoided
        #                              a full resync
        self._digest_history: deque = deque(maxlen=8)

    def close(self) -> None:
        self._channel.close()

    # -- fleet routing ---------------------------------------------------------

    def enable_fleet(self, addresses, channel_factory=None) -> None:
        """Route this session's tenant across a replica fleet: build the
        consistent-hash ring, dial the tenant's home replica, and make
        every subsequent UNAVAILABLE answer failover-aware (migrated_to
        rider → follow the drain's named peer; repeated connection-level
        UNAVAILABLE → mark the replica down and walk to the ring
        successor). Safe to call on a live session — the existing retry/
        hedge/dedupe machinery is unchanged, only the channel management
        moves under the router."""
        if channel_factory is not None:
            self._channel_factory = channel_factory
        self.router = ConsistentHashRouter(addresses)
        self._switch_address(self.router.route(self.tenant))

    def _switch_address(self, address: str) -> None:
        old = self._channel
        self.address = address
        self._channel = self._channel_factory(address)
        try:
            old.close()
        except Exception:
            pass

    def _failover(self, address: str, reason: str) -> None:
        from ..metrics.registry import SIDECAR_REPLICA_FAILOVERS
        SIDECAR_REPLICA_FAILOVERS.inc({"reason": reason})
        self.failovers += 1
        self._unavailable_streak = 0
        self._switch_address(address)

    def _fleet_attempt(self, method: str, payload: bytes) -> bytes:
        """One attempt through the router: an UNAVAILABLE answer re-aims
        the channel BEFORE _retry_attempts' backoff fires, so the retry of
        the identical bytes lands on a live replica (the server-side
        handoff restore + request-digest dedupe make that seamless — the
        peer either replays the cached response or applies the delta onto
        the checkpointed state)."""
        try:
            response = self._call_hedged(method, payload)
        except grpc.RpcError as e:
            code = getattr(e, "code", lambda: None)()
            if code == grpc.StatusCode.UNAVAILABLE:
                details = getattr(e, "details", lambda: "")() or ""
                target = _parse_rider(details, "migrated_to")
                if target:
                    # a draining replica told us exactly where its
                    # sessions went: follow it, and keep the drainer off
                    # the ring until the cooldown (its restart) passes
                    self.router.mark_down(self.address)
                    self._failover(target, "migrated")
                else:
                    self._unavailable_streak += 1
                    if self._unavailable_streak >= 2:
                        # connection-level failure (killed process, no
                        # drain): mark it down and walk the ring
                        self.router.mark_down(self.address)
                        succ = self.router.successor(
                            self.tenant, exclude=(self.address,))
                        if succ != self.address:
                            self._failover(succ, "unavailable")
            elif code == grpc.StatusCode.CANCELLED:
                # a replica stopping mid-RPC cancels the in-flight call:
                # same treatment as a connection-level UNAVAILABLE — the
                # dedupe cache makes the resend at-most-once apply
                self._unavailable_streak += 1
                if self._unavailable_streak >= 2:
                    self.router.mark_down(self.address)
                    succ = self.router.successor(
                        self.tenant, exclude=(self.address,))
                    if succ != self.address:
                        self._failover(succ, "unavailable")
            raise
        self._unavailable_streak = 0
        self.router.mark_up(self.address)
        return response

    def _rollback_to(self, digest: str) -> bool:
        """Roll the delta mirrors back to the acked state whose digest a
        restored replica reported (the server_digest rider): the next
        _delta_request diffs against THAT state, producing the bounded
        catch-up delta instead of a full snapshot."""
        for past, state in reversed(self._digest_history):
            if past == digest:
                (self._tmpl_ids, self._tmpl_keys, self._tmpl_constrained,
                 self._tmpl_digest, self._rows, self._pod_rows,
                 self._node_tokens, self._node_revs, self._node_dicts,
                 self._ds_sent, self._ds_token,
                 self._cluster_token) = state
                self._synced = True
                return True
        return False

    def force_resync(self) -> None:
        """Drop every delta mirror: the next solve ships a full snapshot
        with the ``full_state`` flag (the server session and its device/
        compile caches survive; its delta state is rebuilt)."""
        self._tmpl_ids = {}
        self._tmpl_keys = []
        self._tmpl_constrained = []
        self._tmpl_digest = codec.templates_digest(())
        self._rows = []
        self._synced = False
        self._pod_rows = {}
        self._node_tokens = {}
        self._node_revs = {}
        self._node_dicts = {}
        self._ds_sent = None
        self._ds_token = ""
        self._cluster_token = ""

    # -- session management --------------------------------------------------

    def _call(self, method: str, payload: bytes) -> bytes:
        """One raw RPC attempt under the per-RPC deadline."""
        call = self._channel.unary_unary(
            f"/{SERVICE}/{method}",
            request_serializer=None, response_deserializer=None)
        rp = self.retry
        timeout = rp.deadline if rp.deadline and rp.deadline > 0 else None
        return call(payload, timeout=timeout)

    def _call_hedged(self, method: str, payload: bytes) -> bytes:
        """One attempt, optionally hedged: if the primary hasn't answered
        within hedge_delay, fire an identical request and take whichever
        answers first (the server's request-digest dedupe makes the
        duplicate free — at most one delta apply + solve happens)."""
        rp = self.retry
        if not rp.hedge_delay or rp.hedge_delay <= 0:
            return self._call(method, payload)
        call = self._channel.unary_unary(
            f"/{SERVICE}/{method}",
            request_serializer=None, response_deserializer=None)
        timeout = rp.deadline if rp.deadline and rp.deadline > 0 else None
        f1 = call.future(payload, timeout=timeout)
        try:
            return f1.result(timeout=rp.hedge_delay)
        except grpc.FutureTimeoutError:
            pass  # no answer yet: hedge
        from ..metrics.registry import SIDECAR_CLIENT_HEDGES
        SIDECAR_CLIENT_HEDGES.inc({"outcome": "fired"})
        self.hedges += 1
        f2 = call.future(payload, timeout=timeout)
        done = threading.Event()
        f1.add_done_callback(lambda _f: done.set())
        f2.add_done_callback(lambda _f: done.set())
        while True:
            done.wait()
            done.clear()
            for f, other in ((f1, f2), (f2, f1)):
                if f.done() and f.exception() is None:
                    other.cancel()
                    if f is f2:
                        SIDECAR_CLIENT_HEDGES.inc({"outcome": "won"})
                        self.hedges_won += 1
                        self._hedged_last = True
                    return f.result()
            if f1.done() and f2.done():
                raise f1.exception()  # both failed: surface the primary's

    def _call_resilient(self, method: str, payload: bytes) -> bytes:
        """Shared attempt loop (_retry_attempts) over the hedged call;
        non-retryable statuses propagate to the structural handler in
        solve() (NOT_FOUND -> session recreate, FAILED_PRECONDITION ->
        resync)."""
        attempt = ((lambda: self._fleet_attempt(method, payload))
                   if self.router is not None
                   else (lambda: self._call_hedged(method, payload)))
        response, retries = _retry_attempts(
            attempt, self.retry,
            self._rng, self._spend_retry_token, self._refund_retry_token,
            retryable=(_RETRYABLE_FLEET if self.router is not None
                       else _RETRYABLE))
        self.retries += retries
        return response

    def _catalog_signature(self, nodepools, instance_types):
        ids = tuple(id(np_) for np_ in nodepools) + tuple(
            (pool,) + tuple(id(it) for it in its)
            for pool, its in sorted(instance_types.items()))
        return ids

    def _content_digest(self, nodepools, instance_types):
        from ..provisioning.tensor_scheduler import _catalog_cache_key
        pools = tuple(_freeze(codec.nodepool_to_dict(np_))
                      for np_ in nodepools)
        cats = tuple((pool, _catalog_cache_key(its))
                     for pool, its in sorted(instance_types.items()))
        return (pools, cats)

    def _ensure_session(self, nodepools, instance_types) -> None:
        """Create/refresh the server session (catalog change = new session;
        a fresh session always starts from a full-snapshot resync)."""
        sig = self._catalog_signature(nodepools, instance_types)
        recreate = self._session_id is None
        key = None
        if not recreate and sig != self._id_sig:
            key = self._content_digest(nodepools, instance_types)
            recreate = key != self._content_key
        if recreate:
            payload = codec.encode_session_request(nodepools, instance_types,
                                                   tenant=self.tenant)
            import json as _json
            resp = _json.loads(
                self._call_resilient("CreateSession", payload).decode())
            self._session_id = resp["session"]
            self._content_key = (key if key is not None else
                                 self._content_digest(nodepools,
                                                      instance_types))
            self.force_resync()
        self._id_sig = sig
        self._id_refs = (list(nodepools), dict(instance_types))

    # -- delta request assembly ----------------------------------------------

    @staticmethod
    def _resolve_volume_riders(templates, tmpl_idx, pods, store) -> None:
        """Pre-resolve volume->CSI-driver counts per template BEFORE the
        templates are content-keyed: the server has no store to run the
        PVC/StorageClass resolution (volumeusage.go:83-151), and a changed
        resolution must mint a NEW template id, not mutate an old one."""
        if store is None:
            return
        vol_templates = {t for t, d in enumerate(templates)
                         if d.get("volumes")}
        if not vol_templates:
            return
        from ..scheduling.volumeusage import get_volumes
        probes: dict = {}
        need = set(vol_templates)
        for i, t in enumerate(tmpl_idx.tolist()):
            if t in need:
                probes[t] = pods[i]
                need.discard(t)
                if not need:
                    break
        for t in vol_templates:
            counts = {dr: len(keys) for dr, keys
                      in get_volumes(store, probes[t]).items()}
            if counts:
                templates[t]["volume_drivers"] = counts

    def _node_delta(self, state_nodes, store):
        """(upserts, revs, removals, node_tokens, node_revs, node_dicts):
        nodes with live ``identity``/``revision`` stamps re-serialize ONLY
        on a revision bump (plus the store-derived CSI attach limits, which
        don't bump the node but are O(1) to read); stamp-less nodes fall
        back to the old full content compare."""
        from . import wire
        node_tokens = dict(self._node_tokens)
        node_revs = dict(self._node_revs)
        node_dicts = dict(self._node_dicts)
        upserts, revs = [], {}
        current = set()
        for sn in state_nodes:
            name = sn.name()
            current.add(name)
            identity = getattr(sn, "identity", None)
            revision = getattr(sn, "revision", None)
            if identity is not None and revision is not None:
                limits = ()
                if store is not None:
                    from ..scheduling.volumeusage import node_volume_limits
                    limits = tuple(sorted(
                        node_volume_limits(store, name).items()))
                tok = (identity, revision, limits)
                if node_revs.get(name) == tok:
                    continue
                d = codec.state_node_to_dict(sn, store=store)
                node_revs[name] = tok
                node_dicts.pop(name, None)
                token = f"{identity}:{revision}:{limits!r}"
            else:
                d = codec.state_node_to_dict(sn, store=store)
                if node_dicts.get(name) == d:
                    continue
                node_dicts[name] = d
                node_revs.pop(name, None)
                token = wire.content_digest(codec.template_content_key(d))
            upserts.append(d)
            revs[name] = token
            node_tokens[name] = token
        removals = [n for n in self._node_tokens if n not in current]
        for n in removals:
            node_tokens.pop(n, None)
            node_revs.pop(n, None)
            node_dicts.pop(n, None)
        return upserts, revs, removals, node_tokens, node_revs, node_dicts

    def _delta_request(self, pods: List[Pod], state_nodes, daemonset_pods,
                       cluster, store, parity: bool):
        """Build one delta SolveSession request; returns (header, blobs,
        commit, order) where `order` is the pod list in SERVER batch order
        (results reference rows in that order) and commit() publishes every
        mirror — call it only after the RPC succeeds."""
        import json as _json

        from . import wire
        header: dict = {"session": self._session_id,
                        "v": codec.DELTA_SCHEMA_VERSION}
        if parity:
            header["parity_check"] = 1
        blobs: dict = {}

        # pod rows: unchanged pod OBJECTS reuse their acked row outright
        # (no re-encode); only fresh/changed pods run the template encoder.
        # Volume-bearing pods always re-encode when a store is present —
        # their CSI-driver resolution can change without the pod changing.
        prev_rows = self._pod_rows if self._synced else {}
        new_rows: list = [None] * len(pods)
        new_pod_rows: dict = {}
        fresh_idx: list = []
        for i, p in enumerate(pods):
            ent = prev_rows.get(id(p))
            if ent is not None and ent[1] == p.metadata.resource_version \
                    and (store is None or not p.spec.volumes):
                new_rows[i] = ent[2]
                new_pod_rows[id(p)] = ent
            else:
                fresh_idx.append(i)
        tmpl_ids = dict(self._tmpl_ids)
        tmpl_keys = list(self._tmpl_keys)
        tmpl_constrained = list(self._tmpl_constrained)
        new_templates = []
        if fresh_idx:
            fresh = ([pods[i] for i in fresh_idx]
                     if len(fresh_idx) < len(pods) else pods)
            templates, tmpl_idx, ts = codec.encode_pod_rows(fresh)
            self._resolve_volume_riders(templates, tmpl_idx, fresh, store)
            # local template index -> persistent server template id.
            # Identity-keyed local templates with equal content collapse
            # onto one id.
            local_to_srv = []
            for d in templates:
                k = codec.template_content_key(d)
                tid = tmpl_ids.get(k)
                if tid is None:
                    tid = len(tmpl_keys)
                    tmpl_ids[k] = tid
                    tmpl_keys.append(k)
                    tmpl_constrained.append(
                        bool(d.get("spread") or d.get("affinity")))
                    new_templates.append([tid, d])
                local_to_srv.append(tid)
            for j, i in zip(range(len(fresh_idx)), fresh_idx):
                p = pods[i]
                row = (p.uid, local_to_srv[int(tmpl_idx[j])],
                       float(ts[j]))
                new_rows[i] = row
                new_pod_rows[id(p)] = (p, p.metadata.resource_version, row)
        if new_templates:
            header["templates_new"] = new_templates
        tmpl_digest = (codec.templates_digest(tmpl_keys) if new_templates
                       else self._tmpl_digest)
        full = not self._synced
        if not full:
            removals, additions, merged = codec.diff_pod_rows(self._rows,
                                                              new_rows)
            if len(removals) + len(additions) > len(new_rows):
                # degenerate diff (most of the batch churned): the snapshot
                # is smaller than the delta and cheaper to apply
                full = True
        if full:
            removals, additions, merged = [], list(new_rows), list(new_rows)
            header["pods_full"] = 1
            if not self._synced:
                # mirrors were dropped (fresh session / resync): the server
                # must drop its delta state too, or stale entries the
                # client no longer tracks would fail every digest forever
                header["full_state"] = 1
        if removals:
            blobs["pod_remove"] = wire.pack_u32(removals)
        if additions:
            blobs["pod_add_tid"] = wire.pack_u32([r[1] for r in additions])
            blobs["pod_add_ts"] = wire.pack_f64([r[2] for r in additions])

        (upserts, revs, node_removals, node_tokens, node_revs,
         node_dicts) = self._node_delta(state_nodes, store)
        if upserts:
            header["state_upsert"] = upserts
            header["state_revs"] = revs
        if node_removals:
            header["state_remove"] = node_removals

        ds = [codec.pod_to_dict(p) for p in daemonset_pods]
        if ds != self._ds_sent:
            ds_token = wire.content_digest(_json.dumps(ds, sort_keys=True))
            header["daemonset"] = ds
            header["ds_token"] = ds_token
        else:
            ds_token = self._ds_token

        cluster_token = self._cluster_token
        if cluster is None:
            if cluster_token != "":
                header["cluster"] = None
                header["cluster_token"] = cluster_token = ""
        else:
            rev = getattr(getattr(cluster, "cluster", None),
                          "topo_revision", None)
            if rev is not None:
                # live cluster with a topology revision: the snapshot's
                # content is (cluster state, constraint-bearing templates)
                # — skip the 50k-pod selector scans entirely while neither
                # changed
                used = sorted({r[1] for r in new_rows
                               if tmpl_constrained[r[1]]})
                want = f"r{rev}/" + ",".join(map(str, used))
            else:
                want = None
            if want is None or want != cluster_token:
                d = codec.cluster_view_to_dict(cluster, pods)
                if want is None:
                    # revision-less view (tests, stubs): content-compare
                    want = wire.content_digest(
                        _json.dumps(d, sort_keys=True))
                if want != cluster_token:
                    header["cluster"] = d
                    header["cluster_token"] = cluster_token = want

        header["digest"] = codec.batch_digest(
            [r[1] for r in merged], [r[2] for r in merged],
            tmpl_digest, node_tokens, ds_token, cluster_token)

        def commit():
            self._tmpl_ids = tmpl_ids
            self._tmpl_keys = tmpl_keys
            self._tmpl_constrained = tmpl_constrained
            self._tmpl_digest = tmpl_digest
            self._rows = merged
            self._pod_rows = new_pod_rows
            self._synced = True
            self._node_tokens = node_tokens
            self._node_revs = node_revs
            self._node_dicts = node_dicts
            self._ds_sent = ds
            self._ds_token = ds_token
            self._cluster_token = cluster_token
            # committed-state history for the fleet digest catch-up:
            # aliasing is safe — every value above is freshly built per
            # request (_delta_request copies the mirrors before mutating)
            # and commit only ever REBINDS the attributes
            self._digest_history.append((header["digest"], (
                tmpl_ids, tmpl_keys, tmpl_constrained, tmpl_digest,
                merged, new_pod_rows, node_tokens, node_revs, node_dicts,
                ds, ds_token, cluster_token)))

        by_uid = {p.uid: p for p in pods}
        order = [by_uid[r[0]] for r in merged]
        return header, blobs, commit, order

    # -- solve ----------------------------------------------------------------

    def solve(self, nodepools, instance_types, pods: List[Pod],
              state_nodes=(), daemonset_pods=(), cluster=None,
              subsystem: str = "provisioning"):
        from ..obs.tracer import TRACER
        # operator-side view of the remote solve: one span covering request
        # assembly + the wire round trip(s). Roots a client PassTrace when
        # nothing is active (bench, tests); nests under the provisioner
        # pass otherwise — and its trace ctx rides the wire so the SERVER's
        # session/queue/solve span tree joins the same trace_id.
        with TRACER.span("sidecar.rpc", pods=len(pods),
                         tenant=self.tenant or "default") as rpc_span:
            results = self._solve_traced(nodepools, instance_types, pods,
                                         state_nodes, daemonset_pods,
                                         cluster, subsystem)
            rpc_span.set(encode_kind=results.encode_kind,
                         retries=results.retries,
                         hedged=results.hedged)
        return results

    def _solve_traced(self, nodepools, instance_types, pods: List[Pod],
                      state_nodes=(), daemonset_pods=(), cluster=None,
                      subsystem: str = "provisioning"):
        from . import wire
        from ..obs.tracer import TRACER
        store = getattr(cluster, "store", None)
        self._ensure_session(nodepools, instance_types)
        self._solve_seq += 1
        parity = bool(self.parity_every
                      and self._solve_seq % self.parity_every == 0)
        retries_before = self.retries
        # structural-recovery budget: each entry is a mirror rebuild, not a
        # wire retry (those live inside _call_resilient). Two covers the
        # worst healthy chain — a server restart (NOT_FOUND -> recreate)
        # whose fresh session then still needs a digest-driven resync; a
        # third structural failure means something is genuinely broken.
        rebuilds_left = 2
        while True:
            header, blobs, commit, order = self._delta_request(
                pods, state_nodes, daemonset_pods, cluster, store, parity)
            # idempotency nonce: every LOGICAL request gets a fresh id;
            # wire retries and hedges resend the identical bytes (same
            # id), so the server's dedupe cache recognizes them — while
            # two logically distinct requests that happen to carry the
            # same state bytes (a resync rebuilding the exact bootstrap
            # snapshot) can never collide into a stale cached response
            header["req"] = f"q{next(self._req_seq)}"
            # trace propagation (wire v2): the active operator-side trace
            # rides the request so the server's span tree adopts the same
            # trace_id. Wire retries and hedges resend these identical
            # bytes and are answered from the server's nonce-keyed dedupe
            # cache BEFORE any span opens — one logical request can never
            # mint two server span trees.
            ctx = TRACER.current_ctx()
            if ctx is not None:
                header["trace_ctx"] = ctx
            # fallback-ledger subsystem rider: a disruption candidate
            # probe served over the wire must not pollute the SERVER
            # process's headline provisioning totals (the in-process
            # ledger_subsystem flag, carried across the boundary)
            if subsystem != "provisioning":
                header["subsystem"] = subsystem
            # reset HERE, not before the loop: a hedged CreateSession
            # inside a NOT_FOUND recovery also sets the flag, and the
            # rider must report whether THIS solve's answer came from a
            # hedge, not whether any RPC on the way did
            self._hedged_last = False
            try:
                # retryable wire faults (UNAVAILABLE / DEADLINE_EXCEEDED)
                # are retried INSIDE _call_resilient with the identical
                # bytes: the server's request-digest dedupe makes that
                # at-most-once apply, so a lost RESPONSE is recovered from
                # the cache instead of desyncing the session
                response = self._call_resilient("SolveSession",
                                                wire.pack(header, blobs))
                break
            except grpc.RpcError as e:
                code = getattr(e, "code", lambda: None)()
                if rebuilds_left <= 0:
                    raise
                rebuilds_left -= 1
                if code == grpc.StatusCode.NOT_FOUND:
                    # server restarted / session evicted: recreate the
                    # session and resync transparently
                    self._session_id = None
                    self.resyncs += 1
                    self._ensure_session(nodepools, instance_types)
                elif code in (grpc.StatusCode.FAILED_PRECONDITION,
                              grpc.StatusCode.INVALID_ARGUMENT):
                    # FAILED_PRECONDITION = content-digest mismatch;
                    # INVALID_ARGUMENT = a malformed delta the server
                    # rejected BEFORE the handshake (e.g. a retry-budget
                    # exhaustion left our template/row mirrors behind the
                    # server's, so re-sent registrations violate
                    # contiguity). Both mean the mirrors can't be trusted.
                    # Fleet catch-up first: a restored/rolled-back replica
                    # reports the digest of the acked state it HOLDS in a
                    # [server_digest=..] rider — if that state is in our
                    # committed history, roll the mirrors back to it and
                    # resend only the delta since (bounded catch-up). A
                    # full-snapshot resync is the last resort.
                    server_digest = ""
                    if code == grpc.StatusCode.FAILED_PRECONDITION:
                        server_digest = _parse_rider(
                            getattr(e, "details", lambda: "")() or "",
                            "server_digest")
                    if server_digest and self._rollback_to(server_digest):
                        self.catchups += 1
                    else:
                        self.resyncs += 1
                        self.force_resync()
                else:
                    raise
        commit()
        results = decode_results_rows(response, order,
                                      codec.union_catalog(instance_types))
        results.deadline_s = self.retry.deadline
        results.retries = self.retries - retries_before
        results.hedged = self._hedged_last
        self.last_encode_kind = results.encode_kind
        self.last_parity = results.parity
        self.last_queue_wait_ms = results.queue_wait_ms
        return results


def _freeze(obj):
    """Recursively hashable view of a JSON-shaped object."""
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_freeze(v) for v in obj)
    return obj


def _stamp_api_claim(proto, name: str):
    """Cheap per-claim clone of an interned shape's API NodeClaim: fresh
    metadata (name, label/annotation dicts) and a fresh requirements list
    whose instance-type entry is claim-private (to_nodeclaim narrows it in
    place after client-side price filtering)."""
    import dataclasses

    from ..api import labels as api_labels
    from ..api.nodeclaim import NodeClaim
    from ..provisioning.scheduler import _SelectorReq
    reqs = []
    for r in proto.spec.requirements:
        if r.key == api_labels.LABEL_INSTANCE_TYPE:
            r = _SelectorReq(r.key, r.operator, tuple(r.values), r.min_values)
        reqs.append(r)
    return NodeClaim(
        metadata=dataclasses.replace(
            proto.metadata, name=name,
            labels=dict(proto.metadata.labels),
            annotations=dict(proto.metadata.annotations),
            owner_refs=list(proto.metadata.owner_refs)),
        spec=dataclasses.replace(proto.spec, requirements=reqs))


def decode_results_rows(data: bytes, pods: List[Pod], catalog: list
                        ) -> "RemoteResults":
    """Rebuild RemoteResults from a row-referencing response frame."""
    from . import wire
    from ..provisioning.scheduler import claim_name_seq
    header, blobs = wire.unpack(data)
    all_rows = wire.unpack_u32(blobs["rows"]).tolist()
    all_its = (wire.unpack_u16(blobs["its"]) if header.get("its_u16", True)
               else wire.unpack_u32(blobs["its"])).tolist()
    results = RemoteResults()
    results.fallback_reason = header["fallback_reason"]
    results.encode_kind = header.get("encode_kind", "")
    results.parity = header.get("parity", "")
    results.queue_wait_ms = float(header.get("queue_wait_ms", 0.0))
    results.warm = header.get("warm", "")
    results.degraded = header.get("degraded", "")
    results.partition = tuple(header.get("partition", (0, 0)))
    results.trace_id = header.get("trace_id", "")
    results.fallback_attribution = header.get("fallback_attribution", {})
    shape_protos = []
    shape_reqs = []
    shape_its = []
    its_memo: dict = {}
    for s in header["shapes"]:
        d = dict(s["nodeclaim"])
        d["name"] = ""
        shape_protos.append(codec.api_nodeclaim_from_dict(d))
        shape_reqs.append(codec.reqs_from_list(s["requirements"]))
        off, n = s["its"]
        its = its_memo.get((off, n))
        if its is None:
            its = its_memo[(off, n)] = [catalog[i]
                                        for i in all_its[off:off + n]]
        shape_its.append(its)
    for si, off, n in header["claims"]:
        proto = shape_protos[si]
        pool = header["shapes"][si]["nodepool"]
        name = f"{pool}-{next(claim_name_seq):05d}"
        results.new_nodeclaims.append(RemoteNodeClaim(
            api_nodeclaim=_stamp_api_claim(proto, name),
            pods=[pods[r] for r in all_rows[off:off + n]],
            requirements=shape_reqs[si],
            instance_type_options=shape_its[si]))
    for name, off, n in header["existing"]:
        results.existing_nodes.append(RemoteExistingNode(
            name=name, pods=[pods[r] for r in all_rows[off:off + n]]))
    err_rows = wire.unpack_u32(blobs["err_rows"]).tolist()
    for msg, off, n in header["errors"]:
        for r in err_rows[off:off + n]:
            results.pod_errors[pods[r].uid] = msg
    return results


class RemoteScheduler(_RetryBudgetMixin):
    def __init__(self, address: str, nodepools, instance_types,
                 state_nodes=(), daemonset_pods=(), cluster=None,
                 channel: Optional[grpc.Channel] = None,
                 session: Optional[SolverSession] = None,
                 retry: Optional[RetryPolicy] = None):
        self.address = address
        self.nodepools = list(nodepools)
        self.instance_types = instance_types
        self.state_nodes = list(state_nodes)
        self.daemonset_pods = list(daemonset_pods)
        # topology's cluster view: serialized into every request so the
        # server counts existing spread/anti-affinity domain occupancy the
        # same way an in-process solve would (topology.go:268-321)
        self.cluster = cluster
        self.fallback_reason = ""
        # mirrors TensorScheduler.ledger_subsystem so the provisioner's
        # simulation entry point can flag disruption probes on THIS
        # scheduler too; rides the wire so the server-side ledger
        # attributes them correctly
        self.ledger_subsystem = "provisioning"
        self.session = session
        self._last: Optional[RemoteResults] = None
        if session is not None:
            self._channel = session._channel
            if retry is not None:
                # the session issues every RPC on this path, so the
                # caller's policy must land ON the session — stored only
                # here it would silently never apply
                session.retry = retry
                session._retry_tokens = retry.retry_budget
            self.retry = session.retry
        else:
            from .server import GRPC_OPTIONS
            self._channel = channel or grpc.insecure_channel(
                address, options=GRPC_OPTIONS)
            self.retry = retry if retry is not None else \
                RetryPolicy.from_env()
        self._rng = random.Random()  # entropy-seeded: see SolverSession
        self._retry_tokens = self.retry.retry_budget

    # observer-facing mirrors of the TensorScheduler surface, so a solve
    # observer (the fleet simulator) reads the same fields either way
    @property
    def encode_kind(self) -> str:
        return self._last.encode_kind if self._last is not None else ""

    @property
    def fallback_attribution(self) -> dict:
        return (self._last.fallback_attribution
                if self._last is not None else {})

    @property
    def partition(self) -> tuple:
        if self._last is not None and any(self._last.partition):
            return tuple(self._last.partition)
        return (0, 0)

    def solve(self, pods: List[Pod]) -> RemoteResults:
        if self.session is not None:
            results = self.session.solve(
                self.nodepools, self.instance_types, pods,
                state_nodes=self.state_nodes,
                daemonset_pods=self.daemonset_pods, cluster=self.cluster,
                subsystem=self.ledger_subsystem)
            self.fallback_reason = results.fallback_reason
            self._last = results
            return results
        results = self._solve_oneshot(pods)
        self._last = results
        return results

    def _solve_oneshot(self, pods: List[Pod]) -> RemoteResults:
        request = codec.encode_solve_request(
            self.nodepools, self.instance_types, pods,
            state_nodes=self.state_nodes, daemonset_pods=self.daemonset_pods,
            cluster=self.cluster)
        call = self._channel.unary_unary(
            f"/{SERVICE}/Solve",
            request_serializer=None, response_deserializer=None)
        # the one-shot contract is stateless and pure, so retrying the
        # identical bytes under the deadline/backoff policy needs no
        # server-side dedupe to be safe; the token budget still bounds a
        # long-lived scheduler's total retry storm against a down server
        rp = self.retry
        timeout = rp.deadline if rp.deadline and rp.deadline > 0 else None
        response, retries = _retry_attempts(
            lambda: call(request, timeout=timeout), rp, self._rng,
            self._spend_retry_token, self._refund_retry_token)
        d = codec.decode_solve_response(response)
        self.fallback_reason = d["fallback_reason"]
        by_uid = {p.uid: p for p in pods}
        it_by_name = {it.name: it for its in self.instance_types.values()
                      for it in its}
        results = RemoteResults(pod_errors=dict(d["pod_errors"]))
        for item in d["new_nodeclaims"]:
            results.new_nodeclaims.append(RemoteNodeClaim(
                api_nodeclaim=codec.api_nodeclaim_from_dict(item["nodeclaim"]),
                pods=[by_uid[u] for u in item["pod_uids"] if u in by_uid],
                requirements=codec.reqs_from_list(item["requirements"]),
                instance_type_options=[
                    it_by_name[n] for n in item["instance_type_names"]
                    if n in it_by_name]))
        for item in d["existing_nodes"]:
            results.existing_nodes.append(RemoteExistingNode(
                name=item["name"],
                pods=[by_uid[u] for u in item["pod_uids"] if u in by_uid]))
        results.deadline_s = rp.deadline
        results.retries = retries
        return results
