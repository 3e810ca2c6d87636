"""Solver sidecar server: the accelerator process.

The north-star deployment (BASELINE.json) keeps the controllers in their own
process and calls the solver through a gRPC boundary hidden behind the
Scheduler interface. This server owns the device — the card (``cuda``)
unless ``serve(device=...)`` / ``--device`` names another; ``cpu`` runs the
kernels' plain PyTorch versions — keeps each session's encodings and
device uploads warm across solves, and exposes:

    /karpenter.v1.Solver/CreateSession  JSON in (catalog + nodepools +
                                        tenant), JSON out {"session": id}
    /karpenter.v1.Solver/SolveSession   KTPW frame in (delta-session wire:
                                        pod row add/remove + state deltas +
                                        a content-digest handshake), KTPW
                                        frame out (interned row-referencing
                                        results)
    /karpenter.v1.Solver/Solve          legacy one-shot JSON contract

Sessions are the unit of tenancy: each one owns its decoded catalog,
nodepools, a persistent pod-row batch + template table, the state nodes and
daemonset pods, AND a persistent provisioning ProblemState — so a
steady-state solve re-encodes only dirty node rows, reuses cached group
rows/topology counts/device uploads and warm-restores the previous pack,
exactly like an in-process provisioner loop (the delta engine, fed over
the wire). A bounded, tenant-fair admission queue shares the device across
N concurrent tenant sessions without head-of-line blocking, and each
session pins its catalog encoding so another tenant's traffic can't evict
it (vocab identity gates every delta cache). Generic byte-level gRPC
handlers keep the contract free of generated stubs; the message schemas
live in codec.py / wire.py.

A kernel failure on the card (``ops.kernels.KernelError``: a failed build,
a refused launch, a CUDA error) is never answered from the host: the solve
fails and the client sees an INTERNAL status that names the kernel.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import OrderedDict, deque
from concurrent import futures
from typing import Dict, List, Optional

import grpc

from ..ops.binpack import resolve_device
from ..ops.kernels import KernelError
from ..provisioning.tensor_scheduler import (TensorScheduler,
                                             catalog_encoding_pin,
                                             restore_catalog_encoding)
from . import codec, wire

SERVICE = "karpenter.v1.Solver"

# a session whose client went away must not pin its catalog + ProblemState
# forever: the idle loop reaps sessions untouched for this long (never one
# with a queued or in-flight solve — see _reap_idle_sessions)
SESSION_IDLE_SECONDS = float(
    os.environ.get("KARPENTER_SIDECAR_SESSION_TTL", "900"))


class _Session:
    def __init__(self, session_id: str, nodepools, instance_types,
                 tenant: str = "", device=None):
        from ..provisioning.tensor_scheduler import catalog_cache_token
        from ..state.plane import EncodePlane
        self.id = session_id
        self.tenant = tenant or "default"
        # the replica's device: every scheduler of this session solves there
        self.device = device
        self.nodepools = nodepools
        self.instance_types = instance_types
        # the session owns its decoded catalog (nothing mutates it), so the
        # content hash that guards the device encoding cache is computed
        # once here instead of on every solve
        self.catalog_token = catalog_cache_token(nodepools, instance_types)
        # union catalog + index maps for result encoding (codec.union_catalog
        # defines the index space shared with the client decoder)
        self.catalog = codec.union_catalog(instance_types)
        self.it_idx_by_id = {id(it): i for i, it in enumerate(self.catalog)}
        self.it_idx_by_name = {it.name: i for i, it in enumerate(self.catalog)}
        self.state_nodes: "OrderedDict[str, codec.WireStateNode]" = OrderedDict()
        self.daemonset_pods: list = []
        self.lock = threading.Lock()
        # -- delta-session state (codec wire v1) ------------------------------
        # persistent cross-solve encode plane + subscriber handle: dirty-row
        # node re-encode, group-row/topology memos, exist-tensor upload
        # reuse, warm pack. The plane also carries the session's
        # topo_revision (the WIRE cluster view has no Cluster object — the
        # plane is hung off it below, retiring the old _ClusterRev shim;
        # the client bumps the revision by re-sending cluster state).
        self.plane = EncodePlane(name=f"session:{session_id}")
        self.problem_state = self.plane.subscribe("sidecar")
        self.template_list: list = []     # tid -> template dict (append-only)
        self.template_keys: list = []     # tid -> canonical content key
        self.tmpl_digest = codec.templates_digest(())
        self.proto_cache: list = []       # tid -> decoded prototype Pod
        self.rows: list = []              # [(tid, ts)] == the current batch
        # built wire pods, parallel to rows (None = rebuild): building 50k
        # Pod objects costs as much as the warm solve itself, so survivors
        # keep their objects across solves and only added rows are built.
        # Invalidated whenever a solve touched the host path (the
        # relaxation ladder mutates pod specs in place).
        self.wire_pods: Optional[list] = []
        self.state_tokens: Dict[str, str] = {}   # name -> client rev token
        self.ds_token = ""
        self.cluster_token = ""
        self.cluster_view = codec.WireClusterView(None)
        self.cluster_view.cluster = self.plane
        self._node_identity = itertools.count(1)
        # pinned catalog encoding (vocab identity): restored into the global
        # LRU before each solve so other tenants' churn can't cold-start us
        self._ce_pin = None
        # queued-or-in-flight solve count: eviction (LRU overflow or idle
        # reap) must never tear state out from under a live request
        self.active = 0
        self.last_used = time.monotonic()
        # request-digest response cache: a retry or hedge of request bytes
        # the server ALREADY applied must be served the original response,
        # never re-applied (re-applying a pod delta would corrupt the
        # session; a solve is a pure function of session state, so the
        # cached response IS the correct answer). Two entries cover the
        # worst interleaving (a hedge racing a retry of the prior solve).
        self.response_cache: "OrderedDict[str, bytes]" = OrderedDict()
        # highest idempotency nonce applied: a cache-missing request with
        # a LOWER nonce is a zombie (hedge/retry loser of a superseded
        # solve) and must be rejected, never re-applied
        self.last_req_seq = 0
        # -- /debug/sessions counters -----------------------------------------
        self.solves = 0              # completed delta solves
        self.resyncs = 0             # full_state applies after bootstrap
        self.dedup_hits = 0
        self.last_digest = ""        # post-apply state digest of the last solve
        self.last_solve_at = 0.0     # monotonic stamp of the last solve
        # -- fleet checkpoint sources (export_session_checkpoint) -------------
        # the exact CreateSession payload bytes plus the RAW daemonset /
        # cluster dicts off the wire, kept by reference: the per-solve
        # checkpoint export reuses them instead of re-serializing
        # catalog-sized state on every solve
        self.bootstrap: bytes = b""
        self.daemonset_raw: list = []
        self.cluster_raw: Optional[dict] = None


def _max_sessions_from_env(default: int = 8) -> int:
    """Session-table bound from $KARPENTER_SIDECAR_MAX_SESSIONS. A typo'd
    value must fail LOUDLY at boot (the KARPENTER_LOO_MIN_CANDIDATES
    contract): silently falling back to the default would let an operator
    believe a larger fleet of tenants fits than the LRU will actually
    keep."""
    raw = os.environ.get("KARPENTER_SIDECAR_MAX_SESSIONS")
    if raw is None:
        return default
    try:
        value = int(raw)
    except ValueError:
        raise SystemExit(
            f"invalid KARPENTER_SIDECAR_MAX_SESSIONS={raw!r}: must be a "
            "positive integer (concurrent delta sessions one replica keeps "
            "before LRU eviction)")
    if value <= 0:
        raise SystemExit(
            f"invalid KARPENTER_SIDECAR_MAX_SESSIONS={raw!r}: must be a "
            "positive integer (concurrent delta sessions one replica keeps "
            "before LRU eviction)")
    return value


_SESSIONS: "OrderedDict[str, _Session]" = OrderedDict()
_SESSIONS_LOCK = threading.Lock()
_SESSIONS_MAX = _max_sessions_from_env()
_session_seq = itertools.count(1)


def _count_resync(reason: str) -> None:
    from ..metrics.registry import SIDECAR_RESYNCS
    SIDECAR_RESYNCS.inc({"reason": reason})


def _count_migration(reason: str) -> None:
    from ..metrics.registry import SIDECAR_MIGRATIONS
    SIDECAR_MIGRATIONS.inc({"reason": reason})


# -- admission: bounded, tenant-fair device sharing ---------------------------


class QueueFullError(Exception):
    pass


class ShedError(QueueFullError):
    """A waiter (or would-be waiter) was shed from the admission queue;
    ``reason`` picks the gRPC status the handler NACKs with: 'draining'
    maps to UNAVAILABLE (retry against the replacement server), everything
    else to RESOURCE_EXHAUSTED (back off and retry here)."""

    def __init__(self, message: str, reason: str = "overload"):
        super().__init__(message)
        self.reason = reason


def _shed_status(e: QueueFullError) -> grpc.StatusCode:
    """The one shed-to-status mapping both handlers NACK with: a drain
    shed is UNAVAILABLE (retry the replacement server), an overload or
    fairness shed is RESOURCE_EXHAUSTED (back off, retry here)."""
    return (grpc.StatusCode.UNAVAILABLE
            if getattr(e, "reason", "") == "draining"
            else grpc.StatusCode.RESOURCE_EXHAUSTED)


class _Waiter:
    __slots__ = ("event", "shed_reason")

    def __init__(self):
        self.event = threading.Event()
        self.shed_reason: Optional[str] = None


class AdmissionQueue:
    """Bounded admission in front of the device with round-robin tenant
    fairness: at most `max_concurrent` solves run (the device is serial, so
    the default is 1 — concurrency above that only helps multi-device
    hosts), at most `max_queued` wait, and when a slot frees the next grant
    rotates across tenants with waiters — one tenant's burst can never
    head-of-line-block another's steady stream.

    Saturation sheds by TENANT FAIRNESS, not globally: when the queue is
    full, a tenant still under its fair share (max_queued / tenants with
    waiters) evicts the NEWEST waiter of the tenant furthest over its
    share instead of being bounced — a burst tenant absorbs its own
    overload, a steady tenant keeps flowing. Only when every tenant sits
    at fair share (the queue is fairly saturated) does the requester get
    the RESOURCE_EXHAUSTED bounce. Queue depth, wait time and sheds are
    published per tenant (bounded label) on the karpenter_sidecar_*
    families."""

    def __init__(self, max_concurrent: int = 1, max_queued: int = 64):
        self.max_concurrent = max(1, int(max_concurrent))
        self.max_queued = max(1, int(max_queued))
        self._lock = threading.Lock()
        # tenant -> deque of _Waiters, in round-robin rotation order:
        # a granted tenant's (possibly emptied) queue moves to the back
        self._queues: "OrderedDict[str, deque]" = OrderedDict()
        self._active = 0
        self._queued = 0

    def _set_depth(self, tenant: str) -> None:
        from ..metrics.registry import SIDECAR_QUEUE_DEPTH, tenant_label
        q = self._queues.get(tenant)
        SIDECAR_QUEUE_DEPTH.set(float(len(q) if q else 0),
                                {"tenant": tenant_label(tenant)})

    def depth(self, tenant: str) -> int:
        with self._lock:
            q = self._queues.get(tenant)
            return len(q) if q else 0

    def _count_shed(self, tenant: str, reason: str) -> None:
        from ..metrics.registry import SIDECAR_SHED, tenant_label
        SIDECAR_SHED.inc({"tenant": tenant_label(tenant), "reason": reason})

    def _shed_for(self, tenant: str) -> bool:
        """Called under self._lock with the queue at its bound: try to make
        room for `tenant` by evicting the newest waiter of the tenant
        furthest over fair share. Returns False when the requester is at or
        over its own share, or nobody is over share (fair saturation) —
        the requester is the one shed then."""
        tenants = set(self._queues) | {tenant}
        share = max(1, self.max_queued // len(tenants))
        mine = len(self._queues.get(tenant, ()))
        if mine + 1 > share:
            return False
        victim_tenant, victim_len = None, share
        for t, q in self._queues.items():
            if len(q) > victim_len:
                victim_tenant, victim_len = t, len(q)
        if victim_tenant is None:
            return False
        w = self._queues[victim_tenant].pop()  # newest waiter
        self._queued -= 1
        w.shed_reason = "fairness"
        w.event.set()
        self._count_shed(victim_tenant, "fairness")
        self._set_depth(victim_tenant)
        return True

    def acquire(self, tenant: str) -> float:
        """Block until a device slot is granted; returns the wait in
        seconds. Raises ShedError (a QueueFullError) when shed: at the
        saturated bound, by a fairness eviction, or by a drain."""
        from ..metrics.registry import SIDECAR_QUEUE_WAIT, tenant_label
        t0 = time.monotonic()
        with self._lock:
            if self._active < self.max_concurrent and self._queued == 0:
                self._active += 1
                SIDECAR_QUEUE_WAIT.observe(
                    0.0, {"tenant": tenant_label(tenant)})
                return 0.0
            if self._queued >= self.max_queued and not self._shed_for(tenant):
                self._count_shed(tenant, "overload")
                raise ShedError(
                    f"solver admission queue full ({self._queued} waiting, "
                    f"bound {self.max_queued}) and tenant {tenant!r} is at "
                    "fair share", reason="overload")
            w = _Waiter()
            self._queues.setdefault(tenant, deque()).append(w)
            self._queued += 1
            self._set_depth(tenant)
        w.event.wait()
        wait = time.monotonic() - t0
        if w.shed_reason is not None:
            raise ShedError(
                f"solve request shed from the admission queue after "
                f"{wait:.3f}s ({w.shed_reason})", reason=w.shed_reason)
        SIDECAR_QUEUE_WAIT.observe(wait, {"tenant": tenant_label(tenant)})
        return wait

    def shed_all(self, reason: str) -> int:
        """NACK every queued waiter (graceful drain: stop accepting,
        finish in-flight, bounce the queue with a retryable code)."""
        with self._lock:
            shed = 0
            for tenant, q in list(self._queues.items()):
                while q:
                    w = q.pop()
                    w.shed_reason = reason
                    w.event.set()
                    shed += 1
                    self._count_shed(tenant, reason)
                del self._queues[tenant]
                self._set_depth(tenant)
            self._queued = 0
        return shed

    def release(self) -> None:
        with self._lock:
            # round-robin: first tenant in rotation order with a waiter is
            # granted and rotated to the back; empty queues are dropped
            granted = None
            for tenant in list(self._queues):
                q = self._queues[tenant]
                if not q:
                    del self._queues[tenant]
                    continue
                granted = q.popleft()
                self._queued -= 1
                if q:
                    self._queues.move_to_end(tenant)
                else:
                    del self._queues[tenant]
                self._set_depth(tenant)
                break
            if granted is None:
                self._active -= 1
        if granted is not None:
            granted.event.set()  # the slot is handed over, _active unchanged


ADMISSION = AdmissionQueue(
    max_concurrent=1,
    max_queued=int(os.environ.get("KARPENTER_SIDECAR_MAX_QUEUED", "64")))


# -- fleet replication: handoff store + per-replica state ---------------------


#: HandoffStore bounds: checkpoints are fleet-sized state with no natural
#: death signal — a replica that dies without a successor restoring its
#: sessions would otherwise pin them forever. LRU cap + TTL expiry bound
#: the store; both evictions count karpenter_sidecar_handoff_evicted_total.
HANDOFF_MAX_ENTRIES = int(os.environ.get(
    "KARPENTER_SIDECAR_HANDOFF_MAX", "1024"))
HANDOFF_TTL_SECONDS = float(os.environ.get(
    "KARPENTER_SIDECAR_HANDOFF_TTL", "3600"))


class HandoffStore:
    """Shared session-checkpoint plane for a sidecar fleet: each replica
    writes a checkpoint frame after every acked delta solve and a draining
    replica exports its whole table, so ANY peer can rebuild a session
    warm on first contact (lazy restore in _get_session) instead of
    NACKing the client into a cold bootstrap. In-process fleets (the
    simulator, tests, bench) share one instance; a real deployment would
    back the same three-method contract with an external store.

    Bounded: at most ``max_entries`` checkpoints, LRU-evicted
    on overflow (reason="cap"), and entries older than ``ttl_seconds``
    expire lazily on read plus via ``sweep()`` from the idle-GC loop
    (reason="ttl") — an orphaned checkpoint whose owner died without a
    successor can no longer pin fleet-sized state forever. ``now`` is
    injectable for fake-clock tests; a restore refreshes both recency and
    the TTL clock (the session is evidently still wanted)."""

    def __init__(self, max_entries: Optional[int] = None,
                 ttl_seconds: Optional[float] = None, now=None):
        self._lock = threading.Lock()
        self._ckpts: "OrderedDict[str, tuple]" = OrderedDict()
        self.max_entries = (HANDOFF_MAX_ENTRIES if max_entries is None
                            else int(max_entries))
        self.ttl_seconds = (HANDOFF_TTL_SECONDS if ttl_seconds is None
                            else float(ttl_seconds))
        self._now = now or time.monotonic
        self.puts = 0       # checkpoint writes (post-solve + drain export)
        self.restores = 0   # checkpoints handed to a restoring replica
        self.evicted = 0

    def _evict(self, session_id: str, reason: str) -> None:
        # caller holds self._lock
        from ..metrics.registry import SIDECAR_HANDOFF_EVICTED
        self._ckpts.pop(session_id, None)
        self.evicted += 1
        SIDECAR_HANDOFF_EVICTED.inc({"reason": reason})

    def put(self, session_id: str, data: bytes) -> None:
        with self._lock:
            self._ckpts.pop(session_id, None)
            self._ckpts[session_id] = (data, self._now())
            self.puts += 1
            while len(self._ckpts) > self.max_entries:
                self._evict(next(iter(self._ckpts)), "cap")

    def get(self, session_id: str) -> Optional[bytes]:
        with self._lock:
            entry = self._ckpts.get(session_id)
            if entry is None:
                return None
            data, stored_at = entry
            if self.ttl_seconds and \
                    self._now() - stored_at >= self.ttl_seconds:
                self._evict(session_id, "ttl")
                return None
            self._ckpts.move_to_end(session_id)
            self._ckpts[session_id] = (data, self._now())
            self.restores += 1
            return data

    def sweep(self) -> int:
        """TTL-expire orphaned checkpoints (called from the replica's
        idle-GC cadence); returns how many were dropped."""
        if not self.ttl_seconds:
            return 0
        with self._lock:
            now = self._now()
            stale = [sid for sid, (_, at) in self._ckpts.items()
                     if now - at >= self.ttl_seconds]
            for sid in stale:
                self._evict(sid, "ttl")
            return len(stale)

    def discard(self, session_id: str) -> None:
        with self._lock:
            self._ckpts.pop(session_id, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ckpts)


class Replica:
    """One sidecar replica's isolated serving state: its session table,
    admission queue, in-flight request counters and (optionally) the fleet
    handoff store + peer addresses. Every handler below reads through a
    Replica so N replicas can serve from ONE process (the simulator's
    fleet) without sharing the session table the way the old process
    globals forced — a kill or drain of one replica must never clear a
    sibling's sessions. ``device`` is where its sessions solve: None until
    serve() resolves it (``cuda`` unless named), so a replica driven
    without serve() solves on the card too."""

    def __init__(self, name: str = "replica-0",
                 max_sessions: Optional[int] = None,
                 max_concurrent: int = 1,
                 max_queued: Optional[int] = None,
                 handoff: Optional[HandoffStore] = None,
                 peers=(), device=None):
        self.name = name
        self.device = device
        self.sessions: "OrderedDict[str, _Session]" = OrderedDict()
        self.sessions_lock = threading.Lock()
        self.max_sessions = (_max_sessions_from_env() if max_sessions is None
                             else max(1, int(max_sessions)))
        self.session_seq = itertools.count(1)
        self.admission = AdmissionQueue(
            max_concurrent=max_concurrent,
            max_queued=(int(os.environ.get("KARPENTER_SIDECAR_MAX_QUEUED",
                                           "64"))
                        if max_queued is None else int(max_queued)))
        self.handoff = handoff
        self.peers = tuple(peers)
        self.last_request_at = 0.0
        self.active_requests = 0
        self.request_lock = threading.Lock()

    def request_started(self) -> None:
        with self.request_lock:
            self.active_requests += 1
            self.last_request_at = time.monotonic()

    def request_finished(self) -> None:
        with self.request_lock:
            self.active_requests -= 1
            self.last_request_at = time.monotonic()

    def active_count(self) -> int:
        with self.request_lock:
            return self.active_requests

    def idle_for(self, seconds: float) -> bool:
        with self.request_lock:
            return (self.active_requests == 0 and bool(self.last_request_at)
                    and time.monotonic() - self.last_request_at > seconds)

    def _set_session_gauge(self, count: int) -> None:
        from ..metrics.registry import SIDECAR_REPLICA_SESSIONS
        SIDECAR_REPLICA_SESSIONS.set(float(count), {"replica": self.name})


class _ModuleReplica(Replica):
    """The DEFAULT replica: its state IS the module globals. Single-process
    deployments (and every pre-fleet test/bench harness) reach _SESSIONS /
    _SESSIONS_LOCK / _SESSIONS_MAX / ADMISSION directly — monkeypatching or
    clearing those module names must keep working, so this replica reads
    them through properties at call time instead of snapshotting them."""

    def __init__(self):
        self.name = "default"
        self.handoff = None
        self.peers = ()
        self.device = None

    sessions = property(lambda self: _SESSIONS)
    sessions_lock = property(lambda self: _SESSIONS_LOCK)
    max_sessions = property(lambda self: _SESSIONS_MAX)
    session_seq = property(lambda self: _session_seq)
    admission = property(lambda self: ADMISSION)
    request_lock = property(lambda self: _request_lock)

    def request_started(self) -> None:
        _request_started()

    def request_finished(self) -> None:
        _request_finished()

    def active_count(self) -> int:
        with _request_lock:
            return _active_requests

    def idle_for(self, seconds: float) -> bool:
        with _request_lock:
            return (_active_requests == 0 and bool(_last_request_at)
                    and time.monotonic() - _last_request_at > seconds)


DEFAULT_REPLICA = _ModuleReplica()


def _replica(replica: Optional[Replica]) -> Replica:
    return replica if replica is not None else DEFAULT_REPLICA


# -- session lifecycle --------------------------------------------------------


def _evict_for_insert_locked(rep: Replica) -> None:
    """LRU eviction under rep.sessions_lock that NEVER reaps a session
    with a queued or in-flight solve: tearing live state out from under a
    request would crash it mid-flight — briefly exceeding the cap when
    every session is busy is the cheaper failure."""
    while len(rep.sessions) >= rep.max_sessions:
        victim = next((s for s in rep.sessions.values() if s.active == 0),
                      None)
        if victim is None:
            break
        del rep.sessions[victim.id]
        _count_resync("evicted_lru")


def _create_session(request: bytes, context=None, replica=None) -> bytes:
    import uuid
    rep = _replica(replica)
    nodepools, instance_types, tenant = codec.decode_session_request(request)
    # random id: sequential ids reset on restart, letting a stale client
    # silently attach to a DIFFERENT client's new session instead of
    # getting the NOT_FOUND that triggers its recreate-and-retry path
    sid = f"s{next(rep.session_seq)}-{uuid.uuid4().hex[:12]}"
    session = _Session(sid, nodepools, instance_types, tenant=tenant,
                       device=rep.device)
    session.bootstrap = bytes(request)
    with rep.sessions_lock:
        _evict_for_insert_locked(rep)
        rep.sessions[sid] = session
        rep._set_session_gauge(len(rep.sessions))
    return json.dumps({"session": sid}).encode()


def _restore_from_handoff(rep: Replica, sid: str) -> Optional[_Session]:
    """Lazy fleet restore: an unknown session id is looked up in the
    shared handoff store before the NOT_FOUND that would cost the client a
    cold bootstrap. A checkpoint that fails its loud decode checks is
    rejected (counted), never half-restored."""
    data = rep.handoff.get(sid)
    if data is None:
        return None
    try:
        session = restore_session_checkpoint(data, device=rep.device)
    except ValueError:
        _count_migration("restore_rejected")
        return None
    with rep.sessions_lock:
        existing = rep.sessions.get(sid)
        if existing is not None:
            # a concurrent request restored it first: use the winner
            rep.sessions.move_to_end(sid)
            existing.active += 1
            existing.last_used = time.monotonic()
            return existing
        _evict_for_insert_locked(rep)
        rep.sessions[sid] = session
        session.active += 1
        session.last_used = time.monotonic()
        rep._set_session_gauge(len(rep.sessions))
    _count_migration("restore")
    return session


def _get_session(sid: str, context=None, replica=None) -> _Session:
    rep = _replica(replica)
    with rep.sessions_lock:
        session = rep.sessions.get(sid)
        if session is not None:
            rep.sessions.move_to_end(sid)
            session.active += 1
            session.last_used = time.monotonic()
    if session is None and rep.handoff is not None:
        session = _restore_from_handoff(rep, sid)
    if session is None:
        _count_resync("unknown_session")
        if context is not None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"unknown session {sid}")
        raise KeyError(f"unknown session {sid}")
    return session


def _release_session(session: _Session, replica=None) -> None:
    rep = _replica(replica)
    with rep.sessions_lock:
        session.active -= 1
        session.last_used = time.monotonic()


def _reap_idle_sessions(now: Optional[float] = None,
                        replica=None) -> List[str]:
    """Drop sessions untouched for SESSION_IDLE_SECONDS — but never one
    with a queued or in-flight solve (`active > 0`): the idle clock only
    starts once the last request releases. Runs from the idle-GC loop; the
    client recovers from a reap transparently (NOT_FOUND -> recreate +
    full-snapshot resync)."""
    rep = _replica(replica)
    now = time.monotonic() if now is None else now
    with rep.sessions_lock:
        stale = [s for s in rep.sessions.values()
                 if s.active == 0 and now - s.last_used > SESSION_IDLE_SECONDS]
        for s in stale:
            del rep.sessions[s.id]
        if stale:
            rep._set_session_gauge(len(rep.sessions))
    for _ in stale:
        _count_resync("evicted_idle")
    return [s.id for s in stale]


# -- session checkpoint/restore (fleet migration) ------------------------------


def export_session_checkpoint(session: _Session) -> bytes:
    """Serialize everything the session IS into one versioned checkpoint
    frame (codec.encode_session_checkpoint). Caches — wire_pods, the
    ProblemState, the pinned catalog encoding — are deliberately absent:
    they rebuild from content on the restoring replica; only the state the
    digest handshake covers (plus dedupe nonces and the response cache)
    must migrate. Call under session.lock."""
    return codec.encode_session_checkpoint({
        "session": session.id,
        "tenant": session.tenant,
        "bootstrap": session.bootstrap or codec.encode_session_request(
            session.nodepools, session.instance_types,
            tenant=session.tenant),
        "templates": session.template_list,
        "rows": session.rows,
        "state_nodes": [sn._d for sn in session.state_nodes.values()],
        "state_revs": session.state_tokens,
        "daemonset": session.daemonset_raw,
        "ds_token": session.ds_token,
        "cluster": session.cluster_raw,
        "cluster_token": session.cluster_token,
        "topo_revision": session.plane.topo_revision,
        "last_req_seq": session.last_req_seq,
        "responses": list(session.response_cache.items()),
        "counters": {"solves": session.solves, "resyncs": session.resyncs,
                     "dedup_hits": session.dedup_hits},
        "digest": session.last_digest,
    })


def _load_checkpoint_state(session: _Session, st: dict,
                           counters: bool = True) -> None:
    """Overwrite the session's delta state from a decoded checkpoint dict.
    Caches reset: wire pods rebuild from the restored rows, state nodes get
    fresh identity stamps (the ProblemState re-encodes them dirty — its
    caches are content-keyed, so correctness never depended on them)."""
    session.template_list = list(st["templates"])
    session.template_keys = [codec.template_content_key(d)
                             for d in session.template_list]
    session.tmpl_digest = codec.templates_digest(session.template_keys)
    session.proto_cache = []
    session.rows = list(st["rows"])
    session.wire_pods = None
    session.state_nodes = OrderedDict()
    for d in st["state_nodes"]:
        sn = codec.WireStateNode(d)
        sn.identity = next(session._node_identity)
        sn.revision = 0
        session.state_nodes[d["name"]] = sn
    session.state_tokens = dict(st["state_revs"])
    session.daemonset_pods = [codec.pod_from_dict(p)
                              for p in st["daemonset"]]
    session.daemonset_raw = list(st["daemonset"])
    session.ds_token = st["ds_token"]
    session.cluster_view = codec.WireClusterView(st["cluster"])
    session.plane.topo_revision = int(st["topo_revision"])
    session.cluster_view.cluster = session.plane
    session.cluster_raw = st["cluster"]
    session.cluster_token = st["cluster_token"]
    session.last_req_seq = st["last_req_seq"]
    session.response_cache = OrderedDict(st["responses"])
    session.last_digest = st["digest"]
    if counters:
        c = st.get("counters", {})
        session.solves = int(c.get("solves", 0))
        session.resyncs = int(c.get("resyncs", 0))
        session.dedup_hits = int(c.get("dedup_hits", 0))


def restore_session_checkpoint(data: bytes, device=None) -> _Session:
    """Rebuild a live _Session from a checkpoint frame on ANY replica —
    the client never re-sends full state. The frame holds host bytes only,
    so a checkpoint of either package restores here; the session solves on
    ``device`` (the restoring replica's). Loud-reject rules are the
    codec's (ValueError / CheckpointVersionError / DeltaVersionError /
    DigestMismatchError propagate)."""
    st = codec.decode_session_checkpoint(data)
    nodepools, instance_types, tenant = codec.decode_session_request(
        st["bootstrap"])
    session = _Session(st["session"], nodepools, instance_types,
                       tenant=tenant or st["tenant"], device=device)
    session.bootstrap = st["bootstrap"]
    _load_checkpoint_state(session, st)
    return session


def _rollback_session_to_checkpoint(rep: Replica, session: _Session) -> bool:
    """Digest-mismatch recovery on a fleet replica: reload the session's
    state from its last acked checkpoint (the apply that just failed its
    handshake mutated the session in place). Returns False when no usable
    checkpoint exists — the caller falls back to the full-resync answer."""
    data = rep.handoff.get(session.id)
    if data is None:
        return False
    try:
        st = codec.decode_session_checkpoint(data)
    except ValueError:
        _count_migration("restore_rejected")
        return False
    _load_checkpoint_state(session, st, counters=False)
    _count_migration("rollback")
    return True


def _checkpoint_session(rep: Replica, session: _Session) -> None:
    """Post-solve checkpoint write (under session.lock): the handoff store
    always holds the session's LAST ACKED state, so a kill at any instant
    costs a restoring peer nothing but cache warmth. An export failure
    must not fail the solve that already produced its answer — it is
    counted loudly instead."""
    try:
        rep.handoff.put(session.id, export_session_checkpoint(session))
    except Exception:
        _count_migration("export_error")


# -- solve paths --------------------------------------------------------------


def _bad_request(context, message: str):
    if context is not None:
        context.abort(grpc.StatusCode.INVALID_ARGUMENT, message)
    raise ValueError(message)


def _reject_inapplicable_delta(session: _Session, replica, context,
                               message: str):
    """A delta whose structure cannot apply to the session (out-of-order
    template id, row pointing past the template table, row-column skew).
    On a standalone replica that is a client bug: loud INVALID_ARGUMENT.
    On a fleet replica holding an acked checkpoint it is usually restore
    lag — the session was rebuilt from an OLDER checkpoint than the state
    the client's delta was diffed against, so the delta's template ids and
    row indices don't line up. The digest handshake would catch the same
    divergence, but these deltas die before reaching it. Recover the same
    way: roll the session back to its checkpoint and NACK with the
    server-digest rider so the client can ship a bounded catch-up delta
    instead of a full resync."""
    if replica is not None and replica.handoff is not None \
            and _rollback_session_to_checkpoint(replica, session):
        _count_resync("restore_skew")
        full = (f"session delta inapplicable to restored state ({message}):"
                f" full resync required [server_digest={session.last_digest}]")
        if context is not None:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, full)
        raise codec.DigestMismatchError(full)
    _bad_request(context, message)


def _solve_session(request: bytes, context=None, replica=None) -> bytes:
    rep = _replica(replica)
    header, blobs = wire.unpack(request)
    session = _get_session(header["session"], context, replica=rep)
    try:
        legacy = "v" not in header
        if not legacy:
            try:
                codec.check_delta_version(header)
            except codec.DeltaVersionError as e:
                _bad_request(context, str(e))

        def admitted(run, traced=False):
            # ONE copy of the admission semantics for both wire paths
            # (shed abort, client-cancel check, acquire/release pairing —
            # the _demotion_reason single-copy rule). session.lock is
            # taken BEFORE the admission slot: a request serialized behind
            # a same-session sibling must not occupy a device slot while
            # it waits (with max_concurrent > 1 that would idle a device
            # another tenant is queued for).
            #
            # `traced` (the delta path): adopt the client's trace ctx
            # (wire v2) so ONE trace_id names both sides, and root the
            # sidecar.solve span BEFORE the admission queue so queue-wait
            # is a real span inside the trace, not just a metric. Sheds
            # and client-cancels drop the trace (drop_current): the client
            # retries the identical bytes and the completed retry — served
            # past the nonce dedupe — is the one real span tree.
            from contextlib import nullcontext

            from ..obs.tracer import TRACER
            if traced:
                from ..metrics.registry import tenant_label
                tctx = header.get("trace_ctx") or {}
                if tctx.get("id"):
                    TRACER.adopt(str(tctx["id"]), str(tctx.get("span", "")))
                root = TRACER.span("sidecar.solve",
                                   tenant=tenant_label(session.tenant),
                                   session=session.id)
            else:
                root = nullcontext()
            with root:
                try:
                    with (TRACER.span("sidecar.queue") if traced
                          else nullcontext()) as qsp:
                        wait = rep.admission.acquire(session.tenant)
                        if qsp is not None:
                            qsp.set(wait_ms=round(wait * 1e3, 3))
                except QueueFullError as e:
                    if traced:
                        TRACER.drop_current()
                    if context is not None:
                        context.abort(_shed_status(e), str(e))
                    raise
                try:
                    if context is not None and not context.is_active():
                        # the client gave up (deadline/cancel) while we
                        # were queued: don't burn the device on a response
                        # nobody will receive — hand the slot to a live
                        # request
                        if traced:
                            TRACER.drop_current()
                        context.abort(grpc.StatusCode.CANCELLED,
                                      "client cancelled while queued for "
                                      "the device")
                    return run(wait)
                finally:
                    rep.admission.release()

        if legacy:
            return admitted(lambda wait: _solve_session_legacy(
                session, header, blobs))
        # dedupe keys on the request's idempotency nonce + full bytes: a
        # retry or hedge resends IDENTICAL bytes (same nonce) and must be
        # served the original response without re-applying; a logically
        # fresh request always carries a fresh nonce, so identical state
        # bytes (a resync rebuilding the exact bootstrap snapshot) can
        # never alias into a stale answer. Nonce-less requests (older
        # clients) skip the cache entirely — their retry semantics are
        # the resync path.
        req_digest = (wire.content_digest(request)
                      if header.get("req") else None)
        req_seq = 0
        if req_digest is not None:
            try:
                req_seq = int(str(header["req"]).lstrip("q"))
            except ValueError:
                req_seq = 0
        with session.lock:
            if req_digest is not None:
                cached = session.response_cache.get(req_digest)
                if cached is not None:
                    from ..metrics.registry import SIDECAR_DEDUP_HITS, \
                        tenant_label
                    SIDECAR_DEDUP_HITS.inc(
                        {"tenant": tenant_label(session.tenant)})
                    session.dedup_hits += 1
                    return cached
                if req_seq and req_seq <= session.last_req_seq:
                    # a ZOMBIE: a hedge/retry loser of an OLDER logical
                    # request arriving after later solves evicted its
                    # response from the cache. The client long since took
                    # the winner's answer, so nobody reads this response —
                    # the only wrong move is applying the stale delta on
                    # top of newer state (corrupting the session and
                    # forcing the resync DEVIATIONS 23 promises cannot
                    # happen). Reject WITHOUT touching state.
                    if context is not None:
                        context.abort(
                            grpc.StatusCode.FAILED_PRECONDITION,
                            f"stale request nonce q{req_seq} (session is "
                            f"at q{session.last_req_seq}): hedge/retry "
                            "loser of a superseded solve")
                    raise ValueError("stale request nonce")
            response = admitted(lambda wait: _solve_session_delta(
                session, header, blobs, context, wait, replica=rep),
                traced=True)
            if req_digest is not None:
                session.response_cache[req_digest] = response
                session.last_req_seq = max(session.last_req_seq, req_seq)
                while len(session.response_cache) > 2:
                    session.response_cache.popitem(last=False)
            if rep.handoff is not None:
                # checkpoint AFTER the response is cached: a failover
                # retry of this exact request against the restoring peer
                # must hit the dedupe cache, never re-apply the delta
                _checkpoint_session(rep, session)
            return response
    finally:
        _release_session(session, replica=rep)


def _apply_session_delta(session: _Session, header: dict, blobs,
                         context, replica: Optional[Replica] = None) -> str:
    """Apply the request's delta fields to the session state and verify the
    content-digest handshake; returns the server-computed digest. Must run
    under session.lock."""
    if header.get("full_state"):
        # client-initiated resync (fresh session, digest mismatch, forced):
        # drop every piece of delta state so stale entries the client no
        # longer tracks can't fail the handshake forever. The ProblemState
        # and the pinned catalog encoding survive — their caches are
        # content/identity-keyed and simply go dirty where the state did.
        if session.solves:
            session.resyncs += 1  # bootstrap full_state is not a resync
        session.template_list = []
        session.template_keys = []
        session.proto_cache = []
        session.tmpl_digest = codec.templates_digest(())
        session.rows = []
        session.wire_pods = []
        session.state_nodes = OrderedDict()
        session.state_tokens = {}
        session.daemonset_pods = []
        session.daemonset_raw = []
        session.ds_token = ""
        session.cluster_token = ""
        session.cluster_raw = None
        session.plane.bump_topo_revision()
        session.cluster_view = codec.WireClusterView(None)
        session.cluster_view.cluster = session.plane
    new_templates = header.get("templates_new", ())
    for tid, d in new_templates:
        if tid != len(session.template_list):
            _reject_inapplicable_delta(session, replica, context, (
                f"template id {tid} out of order (table has "
                f"{len(session.template_list)} entries; registrations must "
                "be contiguous)"))
        session.template_list.append(d)
        session.template_keys.append(codec.template_content_key(d))
    if new_templates:
        session.tmpl_digest = codec.templates_digest(session.template_keys)
    try:
        session.rows = codec.apply_pod_delta(session.rows, header, blobs)
    except ValueError as e:
        _reject_inapplicable_delta(session, replica, context, str(e))
    n_added = _n_added(blobs)
    if n_added:
        n_templates = len(session.template_list)
        for tid, _ts in session.rows[-n_added:]:
            if tid >= n_templates:
                _reject_inapplicable_delta(session, replica, context, (
                    f"pod row references template {tid} but the table has "
                    f"{n_templates} entries"))
    # mirror the row delta onto the built wire-pod batch: survivors keep
    # their Pod objects (renumbered into their new rows), only added rows
    # are constructed
    cache = session.wire_pods
    if cache is not None:
        if header.get("pods_full"):
            cache = []
        elif "pod_remove" in blobs:
            gone = set(wire.unpack_u32(blobs["pod_remove"]).tolist())
            cache = [p for i, p in enumerate(cache) if i not in gone]
            # row indices only shift when rows were removed — an add-only
            # window must not pay an O(batch) renumber scan
            codec.renumber_wire_pods(cache)
        if n_added:
            protos = codec.wire_pod_protos(session.template_list,
                                           session.proto_cache)
            codec.append_wire_pods(
                protos, wire.unpack_u32(blobs["pod_add_tid"]).tolist(),
                wire.unpack_f64(blobs["pod_add_ts"]).tolist(), cache)
        session.wire_pods = cache
    revs = header.get("state_revs", {})
    for d in header.get("state_upsert", ()):
        sn = codec.WireStateNode(d)
        # identity/revision stamps: the session's ProblemState keys its
        # per-node encoded rows on (identity, revision) — a replaced node
        # gets a fresh identity (dirty row), an untouched one keeps its
        # object and its cached row
        sn.identity = next(session._node_identity)
        sn.revision = 0
        session.state_nodes[d["name"]] = sn
        session.state_tokens[d["name"]] = str(revs.get(d["name"], ""))
    for name in header.get("state_remove", ()):
        session.state_nodes.pop(name, None)
        session.state_tokens.pop(name, None)
    if "daemonset" in header:
        session.daemonset_pods = [codec.pod_from_dict(p)
                                  for p in header["daemonset"]]
        session.daemonset_raw = header["daemonset"]
    if "ds_token" in header:
        session.ds_token = str(header["ds_token"])
    if "cluster" in header:
        cv = codec.WireClusterView(header["cluster"])
        session.plane.bump_topo_revision()
        cv.cluster = session.plane
        session.cluster_view = cv
        session.cluster_raw = header["cluster"]
    if "cluster_token" in header:
        session.cluster_token = str(header["cluster_token"])
    digest = codec.batch_digest(
        [r[0] for r in session.rows], [r[1] for r in session.rows],
        session.tmpl_digest, session.state_tokens,
        session.ds_token, session.cluster_token)
    want = header.get("digest")
    if want and digest != want:
        _count_resync("digest_mismatch")
        # the FULL server digest rides the abort details: a fleet client
        # that still holds an acked mirror snapshot with this digest rolls
        # back to it and sends a bounded forward delta (catch-up) instead
        # of a full resync — the last-resort path stays available either
        # way. The apply above already mutated the session, so a fleet
        # replica first rolls the session back to its last acked
        # checkpoint: the digest it reports must name a state it actually
        # HOLDS, or the client's catch-up delta would land on the
        # franken-state the failed apply left behind.
        report = digest
        if replica is not None and replica.handoff is not None \
                and _rollback_session_to_checkpoint(replica, session):
            report = session.last_digest
        msg = (f"session state digest mismatch (client {want[:12]}.. != "
               f"server {digest[:12]}..): full resync required "
               f"[server_digest={report}]")
        if context is not None:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, msg)
        raise codec.DigestMismatchError(msg)
    return digest


def _n_added(blobs) -> int:
    return (len(blobs["pod_add_tid"]) // 4) if "pod_add_tid" in blobs else 0


def _session_scheduler(session: _Session, state_nodes, daemonset_pods,
                       problem_state) -> TensorScheduler:
    return TensorScheduler(session.nodepools, session.instance_types,
                           state_nodes=state_nodes,
                           daemonset_pods=daemonset_pods,
                           cluster=session.cluster_view,
                           catalog_token=session.catalog_token,
                           problem_state=problem_state,
                           device=session.device)


def _build_session_batch(session: _Session, use_cache: bool = False):
    """(pods, prebuckets) for the session's current row set. With
    `use_cache` the session's incrementally-maintained wire-pod batch is
    served (and repopulated after an invalidation); without it the batch
    is built fresh — the cold parity probe must never share pod objects
    with the live solve."""
    tids = [r[0] for r in session.rows]
    if use_cache and session.wire_pods is not None \
            and len(session.wire_pods) == len(session.rows):
        pods = session.wire_pods
    else:
        tss = [r[1] for r in session.rows]
        pods = codec.build_wire_pods(
            session.template_list, tids, tss,
            proto_cache=session.proto_cache if use_cache else None)
        if use_cache:
            session.wire_pods = pods
    buckets: List[list] = [[] for _ in session.template_list]
    for p, t in zip(pods, tids):
        buckets[t].append(p)
    return pods, buckets


def _parity_probe(session: _Session, results, ts_sched, pods) -> str:
    """Sampled delta-vs-cold audit (the DEVIATIONS-19 contract over the
    wire): re-solve the IDENTICAL session state with a fresh, ProblemState-
    free scheduler on freshly-rebuilt wire pods and compare canonical
    decision digests. Returns "byte-identical" or a loud mismatch text the
    client asserts on."""
    from ..flightrec import decision_digest
    cold_pods, cold_buckets = _build_session_batch(session)  # fresh protos
    cold = _session_scheduler(session,
                              list(session.state_nodes.values()),
                              list(session.daemonset_pods),
                              problem_state=None)
    cold_results = cold.solve(cold_pods, prebuckets=cold_buckets)
    d_live = decision_digest(results, pods, ts_sched.fallback_reason,
                             ts_sched.partition)
    d_cold = decision_digest(cold_results, cold_pods, cold.fallback_reason,
                             cold.partition)
    if json.dumps(d_live, sort_keys=True) == json.dumps(d_cold,
                                                        sort_keys=True):
        return "byte-identical"
    return (f"MISMATCH live={json.dumps(d_live, sort_keys=True)[:400]} "
            f"cold={json.dumps(d_cold, sort_keys=True)[:400]}")


def _solve_session_delta(session: _Session, header: dict, blobs,
                         context, queue_wait: float,
                         replica: Optional[Replica] = None) -> bytes:
    from ..obs.tracer import TRACER
    # runs INSIDE the sidecar.solve root span traced_admitted opened (the
    # queue wait is already a sibling span); annotate the root so the SLO
    # watcher and phase histograms see how the pass was produced
    TRACER.annotate(queue_wait_ms=round(queue_wait * 1e3, 3))
    with TRACER.span("sidecar.apply"):
        digest = _apply_session_delta(session, header, blobs, context,
                                      replica=replica)
    # another tenant's catalog traffic may have LRU-evicted our
    # encoding; reinstating the PINNED object keeps vocab identity
    # (and with it every ProblemState row cache and the warm-pack
    # token) valid
    restore_catalog_encoding(session.catalog_token, session._ce_pin)
    with TRACER.span("sidecar.batch", pods=len(session.rows)):
        pods, buckets = _build_session_batch(session, use_cache=True)
    state_nodes = list(session.state_nodes.values())
    daemonset_pods = list(session.daemonset_pods)
    ts_sched = _session_scheduler(session, state_nodes, daemonset_pods,
                                  session.problem_state)
    if header.get("subsystem") == "disruption":
        # fallback-ledger rider: a remote disruption candidate probe must
        # not move THIS process's headline provisioning totals (whitelist
        # — an unknown value stays provisioning)
        ts_sched.ledger_subsystem = "disruption"
    results = ts_sched.solve(pods, prebuckets=buckets)
    if ts_sched.fallback_reason or ts_sched.partition[1]:
        # the host path ran: its relaxation ladder may have mutated
        # pod specs in place — the cached batch is no longer a
        # faithful rebuild, so the next solve reconstructs it
        session.wire_pods = None
    session._ce_pin = catalog_encoding_pin(session.catalog_token) \
        or session._ce_pin
    extra = {
        "encode_kind": ts_sched.encode_kind,
        "digest": digest,
        "queue_wait_ms": round(queue_wait * 1e3, 3),
        "warm": session.problem_state.last.get("warm", ""),
        "partition": list(ts_sched.partition),
        # the trace id this solve's server span tree ran under — equal to
        # the client's own id when the request carried trace_ctx, so the
        # client can assert the cross-process join end to end
        "trace_id": TRACER.current_trace_id(),
        # the fallback cost attribution rider: shape-class pod counts +
        # host/tensor wall split (obs/fallbacks), so a remote caller (the
        # fleet simulator's sidecar backend) reads the same per-solve
        # attribution an in-process scheduler exposes
        "fallback_attribution": ts_sched.fallback_attribution,
    }
    if ts_sched.fallback_reason == "circuit_open":
        # the circuit breaker forced the host oracle: say so on
        # the wire — a client must see `degraded=host_oracle`, not a
        # silently slower answer (the breaker state is server-process
        # truth the client has no other window into)
        extra["degraded"] = "host_oracle"
    if header.get("parity_check"):
        extra["parity"] = _parity_probe(session, results, ts_sched,
                                        pods)
    session.solves += 1
    session.last_digest = digest
    session.last_solve_at = time.monotonic()
    with TRACER.span("sidecar.encode"):
        return codec.encode_solve_response_rows(
            results, ts_sched.fallback_reason,
            session.it_idx_by_id, session.it_idx_by_name,
            extra_header=extra)


def _solve_session_legacy(session: _Session, header: dict, blobs) -> bytes:
    """Pre-delta session wire: the full template list + row columns ride on
    every solve and nothing persists between solves but catalog/state — kept
    for wire compatibility with old clients."""
    tmpl_list = wire.unpack_u32(blobs["tmpl_idx"]).tolist()
    ts = wire.unpack_f64(blobs["ts"])
    pods = codec.build_wire_pods(header["templates"], tmpl_list, ts)

    with session.lock:
        for d in header.get("state_upsert", ()):
            session.state_nodes[d["name"]] = codec.WireStateNode(d)
        for name in header.get("state_remove", ()):
            session.state_nodes.pop(name, None)
        if "daemonset" in header:
            session.daemonset_pods = [codec.pod_from_dict(p)
                                      for p in header["daemonset"]]
        state_nodes = list(session.state_nodes.values())
        daemonset_pods = list(session.daemonset_pods)

    cluster = codec.WireClusterView(header.get("cluster"))
    ts_sched = TensorScheduler(session.nodepools, session.instance_types,
                               state_nodes=state_nodes,
                               daemonset_pods=daemonset_pods,
                               cluster=cluster,
                               catalog_token=session.catalog_token,
                               device=session.device)
    # the wire's template column already buckets identical-spec pods:
    # hand the buckets to partition_pods so grouping is O(templates)
    buckets: List[list] = [[] for _ in header["templates"]]
    for p, t in zip(pods, tmpl_list):
        buckets[t].append(p)
    results = ts_sched.solve(pods, prebuckets=buckets)
    return codec.encode_solve_response_rows(
        results, ts_sched.fallback_reason,
        session.it_idx_by_id, session.it_idx_by_name)


def _solve(request: bytes, context=None, replica=None) -> bytes:
    rep = _replica(replica)
    nodepools, instance_types, pods, state_nodes, daemonset_pods, cluster = \
        codec.decode_solve_request(request)
    try:
        rep.admission.acquire("")
    except QueueFullError as e:
        if context is not None:
            context.abort(_shed_status(e), str(e))
        raise
    try:
        if context is not None and not context.is_active():
            context.abort(grpc.StatusCode.CANCELLED,
                          "client cancelled while queued for the device")
        ts = TensorScheduler(nodepools, instance_types,
                             state_nodes=state_nodes,
                             daemonset_pods=daemonset_pods, cluster=cluster,
                             device=rep.device)
        results = ts.solve(pods)
    finally:
        rep.admission.release()
    return codec.encode_solve_response(results, ts.fallback_reason)


_METHODS = {
    f"/{SERVICE}/Solve": _solve,
    f"/{SERVICE}/CreateSession": _create_session,
    f"/{SERVICE}/SolveSession": _solve_session,
}


class SolverServicer(grpc.GenericRpcHandler):
    """Byte-level servicer; with a `draining` event set, every new RPC is
    NACKed UNAVAILABLE before touching any session state — the retryable
    code the resilient client backs off on and re-aims at the replacement
    server (in-flight requests entered before the drain and finish)."""

    def __init__(self, draining: Optional[threading.Event] = None,
                 replica: Optional[Replica] = None):
        self.draining = draining if draining is not None \
            else threading.Event()
        self.replica = _replica(replica)

    def service(self, handler_call_details):
        fn = _METHODS.get(handler_call_details.method)
        if fn is not None:
            def handler(request, context, fn=fn):
                # count the request BEFORE the draining check: a request
                # that passes the check is already visible to drain()'s
                # in-flight wait, so drain can never sample zero and
                # return while an admitted solve is still starting
                rep = self.replica
                rep.request_started()
                try:
                    if self.draining.is_set():
                        msg = ("sidecar draining: not accepting new "
                               "solves; retry against the replacement "
                               "server")
                        if rep.peers:
                            # migrated_to rider: the drain exported every
                            # session to the handoff store, so the named
                            # peer can rebuild them warm — the fleet
                            # client re-aims there instead of waiting
                            # out retry backoff against a dying process
                            msg += f" [migrated_to={rep.peers[0]}]"
                        context.abort(grpc.StatusCode.UNAVAILABLE, msg)
                    try:
                        return fn(request, context, replica=rep)
                    except KernelError as e:
                        # the device failed: a status that names the
                        # kernel, never an answer from the host
                        context.abort(grpc.StatusCode.INTERNAL,
                                      f"solver kernel failed on "
                                      f"{rep.device}: {e}")
                finally:
                    rep.request_finished()
            return grpc.unary_unary_rpc_method_handler(
                handler,
                request_deserializer=None,   # raw bytes
                response_serializer=None)
        return None


# a 50k-pod one-shot solve request is ~30 MB of codec JSON; the gRPC default
# (4 MB) would cap the solver at ~7k pods per call. Session solves are ~2 MB
# full, and a steady-state DELTA solve is a few KB.
MAX_MESSAGE_BYTES = 256 * 1024 * 1024

GRPC_OPTIONS = [
    ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
    ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
]


_last_request_at = 0.0
_active_requests = 0
_request_lock = threading.Lock()


def _request_started() -> None:
    global _last_request_at, _active_requests
    with _request_lock:
        _active_requests += 1
        _last_request_at = time.monotonic()


def _request_finished() -> None:
    global _last_request_at, _active_requests
    with _request_lock:
        _active_requests -= 1
        _last_request_at = time.monotonic()


def _idle_gc_loop(stop: threading.Event,
                  replica: Optional[Replica] = None) -> None:
    """Cyclic GC is disabled in the solver process: a 50k-pod solve allocates
    ~10^5 short-lived objects and the collector's unpredictable pauses cost
    up to 400 ms MID-SOLVE (measured: 990 ms vs 545 ms steady-state).
    Refcounting reclaims the per-solve garbage; cycles are swept here, only
    while NO request is in flight and the server has been idle, so the
    pause never lands inside a request. Idle sessions are reaped on the
    same cadence (never one with a queued/in-flight solve — the `active`
    guard in _reap_idle_sessions)."""
    import gc
    rep = _replica(replica)
    while not stop.wait(1.0):
        _reap_idle_sessions(replica=rep)
        if rep.handoff is not None:
            # TTL-expire orphaned fleet checkpoints on the same cadence
            rep.handoff.sweep()
        if rep.idle_for(0.5):
            gc.collect()


def sessions_snapshot(replica: Optional[Replica] = None) -> List[dict]:
    """Point-in-time view of every live session for /debug/sessions (the
    /debug/offerings snapshot pattern: HTTP threads race the solve
    threads, so the session list is copied under the lock and per-session
    fields read as GIL-atomic scalars afterwards)."""
    rep = _replica(replica)
    with rep.sessions_lock:
        sessions = list(rep.sessions.values())
    now = time.monotonic()
    out = []
    for s in sessions:
        out.append({
            "session": s.id,
            "tenant": s.tenant,
            "digest": (s.last_digest[:12] if s.last_digest else ""),
            "rows": len(s.rows),
            "nodes": len(s.state_nodes),
            "templates": len(s.template_list),
            "in_flight": s.active,
            "queue_depth": rep.admission.depth(s.tenant),
            "last_solve_age_s": (round(now - s.last_solve_at, 3)
                                 if s.last_solve_at else -1.0),
            "solves": s.solves,
            "resyncs": s.resyncs,
            "dedup_hits": s.dedup_hits,
        })
    return out


def start_serving(metrics_port: int = 0, health_port: int = 0,
                  draining: Optional[threading.Event] = None):
    """Health/readiness + /metrics + /debug/sessions for the sidecar
    process: readyz flips 503 the moment a drain begins (a load balancer
    stops routing new solves there) while healthz stays 200 as long as the
    process lives — in-flight solves are still finishing and killing the
    pod early would waste them. Returns the started ServingGroup."""
    from ..operator.server import ServingGroup
    return ServingGroup(
        metrics_port, health_port,
        healthy=lambda: True,
        ready=lambda: draining is None or not draining.is_set(),
        sessions=sessions_snapshot).start()


def serve(port: int = 0, max_workers: int = 4,
          max_concurrent: Optional[int] = None,
          max_queued: Optional[int] = None,
          replica: Optional[Replica] = None,
          handoff: Optional[HandoffStore] = None,
          peers=(), device=None):
    """Start the sidecar; returns (server, bound_port). `device` is where
    every session solves: ``cuda`` unless named (or unless `replica`
    already names one); it is resolved before anything binds, and with
    CUDA asked for and absent serve() raises. `max_concurrent` /
    `max_queued` reconfigure the replica's admission queue (the device
    is shared, so the queue is too). `replica` serves an isolated Replica
    (fleet mode) instead of the module-global default; `handoff` / `peers`
    attach a fleet checkpoint store and the peer addresses the draining
    NACK's `migrated_to` rider names. The returned server additionally
    carries `server.drain(grace)` — graceful drain: stop accepting
    (UNAVAILABLE NACKs), NACK the queued waiters with the same retryable
    code, wait up to `grace` seconds for in-flight solves, then export
    every session checkpoint to the handoff store (when one is attached)
    so a peer resumes them warm — and `server.draining` (the event
    start_serving's readiness probe reads)."""
    import gc
    rep = _replica(replica)
    # resolved first: without the card asked for, nothing else moves
    rep.device = resolve_device(device if device is not None
                                else rep.device)
    if handoff is not None:
        rep.handoff = handoff
    if peers:
        rep.peers = tuple(peers)
    if max_concurrent is not None:
        rep.admission.max_concurrent = max(1, int(max_concurrent))
    if max_queued is not None:
        rep.admission.max_queued = max(1, int(max_queued))
    gc.collect()
    gc.freeze()     # baseline objects never participate in collection
    gc.disable()    # idle-time sweeps only (see _idle_gc_loop)
    stop = threading.Event()
    t = threading.Thread(target=_idle_gc_loop, args=(stop, rep), daemon=True,
                         name=f"sidecar-idle-gc-{rep.name}")
    t.start()
    draining = threading.Event()
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers),
                         options=GRPC_OPTIONS)
    server.add_generic_rpc_handlers((SolverServicer(draining, replica=rep),))
    bound = server.add_insecure_port(f"127.0.0.1:{port}")
    server.start()
    _orig_stop = server.stop

    def drain(grace: float = 10.0) -> int:
        """Graceful drain; returns how many queued waiters were NACKed.
        The admission queue is replica-wide (it guards the device), so
        the drain of its waiters is too. With a handoff store attached,
        every live session is exported AFTER the in-flight wait (the
        checkpoints capture final acked state) — the peer named in the
        draining NACK rebuilds them without a cold bootstrap."""
        from ..metrics.registry import SIDECAR_DRAINING
        draining.set()
        SIDECAR_DRAINING.set(1.0)
        shed = rep.admission.shed_all("draining")
        deadline = time.monotonic() + max(0.0, grace)
        while time.monotonic() < deadline:
            if rep.active_count() == 0:
                break
            time.sleep(0.01)
        if rep.handoff is not None:
            with rep.sessions_lock:
                sessions = list(rep.sessions.values())
            for session in sessions:
                with session.lock:
                    _checkpoint_session(rep, session)
                _count_migration("drain")
        return shed

    def stop_server(grace):
        stop.set()
        import gc
        gc.enable()
        from ..metrics.registry import SIDECAR_DRAINING
        if draining.is_set():
            SIDECAR_DRAINING.set(0.0)  # this server is gone, not draining
        return _orig_stop(grace)

    server.drain = drain
    server.draining = draining
    server.stop = stop_server
    return server, bound


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(prog="karpenter-solver")
    parser.add_argument("--port", type=int, default=50551)
    parser.add_argument("--device", default=None,
                        help="device the sessions solve on (default: the "
                             "card, cuda; refuses to start without one "
                             "unless given 'cpu')")
    parser.add_argument("--max-queued", type=int, default=None,
                        help="admission queue bound (default: "
                             "$KARPENTER_SIDECAR_MAX_QUEUED or 64)")
    parser.add_argument("--metrics-port", type=int, default=None,
                        help="serve /metrics + /debug/sessions on this "
                             "port (0 = ephemeral; omit to disable)")
    parser.add_argument("--health-port", type=int, default=None,
                        help="serve /healthz + /readyz on this port "
                             "(readyz flips 503 during drain; omit to "
                             "disable)")
    parser.add_argument("--drain-grace", type=float, default=10.0,
                        help="seconds to wait for in-flight solves on "
                             "SIGINT before stopping")
    args = parser.parse_args(argv)
    server, bound = serve(args.port, max_queued=args.max_queued,
                          device=args.device)
    serving = None
    if args.metrics_port is not None or args.health_port is not None:
        serving = start_serving(args.metrics_port or 0, args.health_port or 0,
                                draining=server.draining)
        print(f"sidecar metrics on :{serving.metrics_port}, health probes "
              f"on :{serving.health_port}", flush=True)
    print(f"solver sidecar device: {_replica(None).device}", flush=True)
    print(f"solver sidecar listening on 127.0.0.1:{bound}", flush=True)
    try:
        server.wait_for_termination()
    except KeyboardInterrupt:
        print("draining: NACKing queued solves, finishing in-flight",
              flush=True)
        server.drain(args.drain_grace)
        server.stop(0)
    finally:
        if serving is not None:
            serving.stop()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
