"""tests/test_sidecar_fleet.py pointed at the port (its replicas on the
CPU): the client-side consistent-hash tenant router, drain-to-peer
migration behind the `migrated_to` NACK rider, warm restore from the
shared handoff store after a replica kill, the stale-checkpoint digest
catch-up path and the handoff store's bounds. The reference's fleet
scenario schema and fleet sim smoke run through the port's simulator in
tests/test_torch_sim.py (TestFleetScenarioSchema, TestFleetSimSmoke)."""

import contextlib
from collections import Counter

import pytest

from karpenter_tpu_torch.cloudprovider.kwok import construct_instance_types
from karpenter_tpu_torch.sidecar import server as srv
from karpenter_tpu_torch.sidecar.client import (ConsistentHashRouter,
                                                RemoteScheduler, RetryPolicy,
                                                SolverSession)

from test_torch_support import PORT, factories, sidecar_server
from test_torch_support import device_series_kept  # noqa: F401 (autouse)
from test_torch_support import sidecar_state_kept  # noqa: F401 (autouse)
from test_torch_support import tracer_kept  # noqa: F401 (autouse)

make_nodepool = factories(PORT).make_nodepool
make_pods = factories(PORT).make_pods

pytestmark = pytest.mark.fleet


class TestConsistentHashRouter:
    ADDRS = ("127.0.0.1:7001", "127.0.0.1:7002", "127.0.0.1:7003")

    def test_empty_fleet_rejected(self):
        with pytest.raises(ValueError, match="at least one replica"):
            ConsistentHashRouter([])

    def test_routing_is_deterministic_and_coordination_free(self):
        """Two independent routers over the same fleet agree on every
        tenant's home — no control plane, no shared state."""
        a = ConsistentHashRouter(self.ADDRS)
        b = ConsistentHashRouter(list(self.ADDRS))
        for i in range(64):
            assert a.route(f"tenant-{i}") == b.route(f"tenant-{i}")

    def test_tenants_spread_across_the_fleet(self):
        counts = Counter(ConsistentHashRouter(self.ADDRS).route(f"t{i}")
                         for i in range(300))
        assert set(counts) == set(self.ADDRS)
        assert min(counts.values()) >= 300 * 0.15  # no starved replica

    def test_growing_the_fleet_moves_a_bounded_slice(self):
        """Consistent hashing's point: adding a replica re-homes ~1/N of
        tenants, never a wholesale reshuffle."""
        small = ConsistentHashRouter(self.ADDRS)
        grown = ConsistentHashRouter(self.ADDRS + ("127.0.0.1:7004",))
        moved = sum(small.route(f"t{i}") != grown.route(f"t{i}")
                    for i in range(400))
        assert 0 < moved <= 400 * 0.45

    def test_down_replica_walks_to_the_same_successor_everywhere(self):
        a = ConsistentHashRouter(self.ADDRS)
        b = ConsistentHashRouter(self.ADDRS)
        home = a.route("acme")
        a.mark_down(home)
        b.mark_down(home)
        assert a.route("acme") == b.route("acme") != home
        assert a.successor("acme", exclude=(home,)) == a.route("acme")

    def test_mark_down_is_a_cooldown_not_a_tombstone(self):
        clock = [0.0]
        r = ConsistentHashRouter(self.ADDRS, cooldown=5.0,
                                 clock=lambda: clock[0])
        home = r.route("acme")
        r.mark_down(home)
        assert r.route("acme") != home
        clock[0] = 5.1  # the restarted process rejoins, signal-free
        assert r.route("acme") == home

    def test_mark_up_restores_immediately(self):
        r = ConsistentHashRouter(self.ADDRS)
        home = r.route("acme")
        r.mark_down(home)
        r.mark_up(home)
        assert r.route("acme") == home

    def test_whole_fleet_down_hands_back_the_ring_owner(self):
        r = ConsistentHashRouter(self.ADDRS)
        for a in self.ADDRS:
            r.mark_down(a)
        assert r.route("acme") in self.ADDRS


# -- live fleets: migration, failover, catch-up -------------------------------


@contextlib.contextmanager
def _boot(n):
    """N isolated replicas sharing one handoff store, peers wired; each
    stopped (again, if a test killed it) once the block ends."""
    handoff = srv.HandoffStore()
    entries = []
    with contextlib.ExitStack() as stack:
        for i in range(n):
            rep = srv.Replica(name=f"fleet-test-{i}", handoff=handoff)
            server, address = stack.enter_context(
                sidecar_server(PORT, replica=rep))
            entries.append([server, int(address.rsplit(":", 1)[1]), rep])
        addrs = [f"127.0.0.1:{p}" for _, p, _ in entries]
        for i, entry in enumerate(entries):
            entry[2].peers = tuple(a for j, a in enumerate(addrs) if j != i)
        yield entries, addrs, handoff


def _fleet_session(addrs, tenant):
    policy = RetryPolicy(deadline=10.0, max_attempts=6, backoff_base=0.01,
                         backoff_cap=0.05, retry_budget=32.0, refund=1.0)
    session = SolverSession(addrs[0], tenant=tenant, retry=policy)
    session.enable_fleet(addrs)
    rs = RemoteScheduler(addrs[0], [make_nodepool()],
                         {"default": construct_instance_types()[:32]},
                         session=session)
    return rs, session


def _entry_for(entries, address):
    return next(e for e in entries if f"127.0.0.1:{e[1]}" == address)


class TestFleetMigration:
    def test_drain_names_the_peer_and_the_tenant_follows_warm(self):
        """server.drain() NACKs with a `migrated_to` rider; the client
        follows it to the named peer, which rebuilds the session from the
        drained replica's checkpoint — no cold bootstrap anywhere."""
        with _boot(2) as (entries, addrs, handoff):
            rs, session = _fleet_session(addrs, "drain-tenant")
            pods = make_pods(6, cpu="500m")
            rs.solve(pods)
            home = session.address
            _entry_for(entries, home)[0].drain(grace=2.0)
            rs.solve(pods[1:] + make_pods(1, cpu="250m"))
            assert session.address != home
            assert session.failovers == 1
            assert session.resyncs == 0, "the migration cost a cold resync"
            assert handoff.restores >= 1
            session.close()

    def test_killed_replica_resumes_warm_on_the_ring_successor(self):
        """A hard kill (no drain, no rider): repeated UNAVAILABLE marks
        the replica down, the ring successor restores the session from
        its last post-solve checkpoint, and the tenant never resyncs."""
        with _boot(3) as (entries, addrs, handoff):
            rs, session = _fleet_session(addrs, "kill-tenant")
            pods = make_pods(8, cpu="500m")
            rs.solve(pods)
            rs.solve(pods[:6])
            home = session.address
            _entry_for(entries, home)[0].stop(grace=None)
            rs.solve(pods[:6] + make_pods(2, cpu="750m"))
            assert session.address != home
            assert session.failovers >= 1
            assert session.resyncs == 0, "the kill cost a cold resync"
            assert handoff.restores >= 1
            session.close()

    def test_stale_checkpoint_catches_up_with_a_bounded_delta(self):
        """The successor restored an OLDER acked state (checkpoint lag):
        the digest handshake rejects, the server names its digest in the
        rider, and the client rolls its mirrors back and ships the
        bounded catch-up delta — counted as a catchup, NOT a resync."""
        with _boot(2) as (entries, addrs, handoff):
            rs, session = _fleet_session(addrs, "stale-tenant")
            pods = make_pods(6, cpu="500m")
            rs.solve(pods)
            sid = session._session_id
            stale = handoff.get(sid)
            assert stale is not None  # post-solve checkpoint write
            rs.solve(pods[:4])
            rs.solve(pods[:4] + make_pods(2, cpu="250m"))
            handoff.put(sid, stale)  # rewind the store to solve-1 state
            home = session.address
            _entry_for(entries, home)[0].stop(grace=None)
            rs.solve(pods[:4] + make_pods(3, cpu="300m"))
            assert session.catchups == 1, \
                "the stale restore did not take the bounded catch-up path"
            assert session.resyncs == 0, \
                "the stale restore fell back to a full resync"
            session.close()

    def test_draining_replica_without_peers_still_nacks_retryably(self):
        """A single-replica 'fleet' drain has nowhere to point the rider;
        the retry lands back on the SAME (restarted) address. Here the
        server never restarts, so the solve must fail loudly after the
        budget — not hang, not corrupt."""
        import grpc
        with _boot(1) as (entries, addrs, _):
            rs, session = _fleet_session(addrs, "lonely")
            rs.solve(make_pods(3, cpu="500m"))
            entries[0][0].drain(grace=1.0)
            with pytest.raises(grpc.RpcError):
                rs.solve(make_pods(4, cpu="500m"))
            session.close()


class TestHandoffStoreBounds:
    """The shared checkpoint plane is BOUNDED: an orphaned session (owner
    died without a successor ever touching the checkpoint) must not pin
    fleet-sized state forever, so the store LRU-evicts past max_entries and TTL-expires stale entries both
    lazily on read and from the idle-GC sweep — every eviction counted
    on karpenter_sidecar_handoff_evicted_total{reason}."""

    def _metric(self, reason):
        from karpenter_tpu_torch.metrics.registry import SIDECAR_HANDOFF_EVICTED
        return SIDECAR_HANDOFF_EVICTED.value({"reason": reason})

    def test_cap_evicts_least_recently_used(self):
        store = srv.HandoffStore(max_entries=3, ttl_seconds=0)
        before = self._metric("cap")
        for i in range(3):
            store.put(f"s{i}", b"ck%d" % i)
        assert store.get("s0") == b"ck0"  # refresh: s1 is now the LRU
        store.put("s3", b"ck3")
        assert len(store) == 3
        assert store.get("s1") is None, "cap eviction must drop the LRU"
        assert store.get("s0") == b"ck0"
        assert store.evicted == 1
        assert self._metric("cap") == before + 1

    def test_ttl_expires_lazily_on_get(self):
        clock = {"t": 0.0}
        store = srv.HandoffStore(max_entries=8, ttl_seconds=60,
                                 now=lambda: clock["t"])
        before = self._metric("ttl")
        store.put("sess", b"ck")
        clock["t"] = 59.0
        assert store.get("sess") == b"ck"
        # the restore refreshed the TTL clock: still alive at t=118
        clock["t"] = 118.0
        assert store.get("sess") == b"ck"
        clock["t"] = 178.0
        assert store.get("sess") is None
        assert len(store) == 0
        assert self._metric("ttl") == before + 1

    def test_sweep_expires_orphans_in_bulk(self):
        clock = {"t": 0.0}
        store = srv.HandoffStore(max_entries=8, ttl_seconds=60,
                                 now=lambda: clock["t"])
        before = self._metric("ttl")
        for i in range(4):
            store.put(f"s{i}", b"ck")
        clock["t"] = 30.0
        store.put("fresh", b"ck")
        clock["t"] = 61.0
        assert store.sweep() == 4
        assert len(store) == 1 and store.get("fresh") == b"ck"
        assert store.evicted == 4
        assert self._metric("ttl") == before + 4

    def test_zero_ttl_disables_expiry(self):
        clock = {"t": 0.0}
        store = srv.HandoffStore(max_entries=8, ttl_seconds=0,
                                 now=lambda: clock["t"])
        store.put("sess", b"ck")
        clock["t"] = 1e9
        assert store.sweep() == 0
        assert store.get("sess") == b"ck"
