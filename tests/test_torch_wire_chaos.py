"""tests/test_wire_chaos.py pointed at the port (its servers on the CPU):
the fault-tolerant service path — the wire-level chaos layer, the
resilient client (deadlines, jittered backoff + retry budget, hedging,
transparent resync on restart), the crash-safe server (graceful drain,
tenant-fair shedding, request-digest dedupe, degraded rider), /debug/
sessions, and the seeded soak asserting decisions byte-identical to a
fault-free run. The hedge test's margin does not depend on the machine's
load: only the injected attempt may hedge, and its primary is held for
seconds before it is dropped, against a solve of milliseconds."""

import json
import threading
import time
import urllib.request

import grpc
import pytest

from karpenter_tpu_torch.cloudprovider.kwok import construct_instance_types
from karpenter_tpu_torch.sidecar import server as srv
from karpenter_tpu_torch.sidecar.client import (RemoteScheduler, RetryPolicy,
                                          SolverSession)
from karpenter_tpu_torch.sidecar.wire_chaos import ChaosChannel
from karpenter_tpu_torch.utils.chaos import WireFaultInjector

from test_torch_support import PORT, factories, sidecar_server
from test_torch_support import device_series_kept  # noqa: F401 (autouse)
from test_torch_support import sidecar_state_kept  # noqa: F401 (autouse)
from test_torch_support import tracer_kept  # noqa: F401 (autouse)

make_nodepool = factories(PORT).make_nodepool
make_pods = factories(PORT).make_pods

pytestmark = pytest.mark.chaos


def _fast_policy(**over):
    kw = dict(deadline=10.0, max_attempts=5, backoff_base=0.002,
              backoff_cap=0.01, retry_budget=32.0, refund=1.0,
              sleep=lambda _s: None)
    kw.update(over)
    return RetryPolicy(**kw)


def _pair(addr, its, pool, tenant="", injector=None, **kw):
    channel = None
    if injector is not None:
        channel = ChaosChannel(
            grpc.insecure_channel(addr, options=srv.GRPC_OPTIONS), injector)
    kw.setdefault("retry", _fast_policy())
    session = SolverSession(addr, channel=channel, tenant=tenant, **kw)
    rs = RemoteScheduler(addr, [pool], {"default": its}, session=session)
    return rs, session


def _digest(results):
    """Canonical decision digest for RemoteResults, stable across server
    restarts and processes: claim names carry a process-global sequence,
    so identity is (nodepool, ITs, zone requirement, pod uids)."""
    from karpenter_tpu_torch.api import labels as api_labels
    claims = sorted(
        (nc.nodepool_name,
         tuple(sorted(it.name for it in nc.instance_type_options)),
         tuple(sorted(r.values) for r in nc.api_nodeclaim.spec.requirements
               if r.key == api_labels.LABEL_TOPOLOGY_ZONE),
         tuple(sorted(p.uid for p in nc.pods)))
        for nc in results.new_nodeclaims)
    existing = sorted((en.name, tuple(sorted(p.uid for p in en.pods)))
                      for en in results.existing_nodes)
    return json.dumps([claims, existing, sorted(results.pod_errors.items())],
                      sort_keys=True)


@pytest.fixture()
def sidecar():
    with sidecar_server(PORT) as (server, address):
        yield address, server


class TestWireFaultInjector:
    def test_seeded_schedule_is_deterministic(self):
        a = WireFaultInjector(seed=7, drop=0.3, delay=0.3, duplicate=0.3,
                              disconnect=0.3)
        b = WireFaultInjector(seed=7, drop=0.3, delay=0.3, duplicate=0.3,
                              disconnect=0.3)
        assert [a.draw() for _ in range(50)] == [b.draw() for _ in range(50)]
        assert a.fired() == b.fired() > 0

    def test_at_most_one_delivery_altering_fault_per_attempt(self):
        inj = WireFaultInjector(seed=3, drop=0.9, duplicate=0.9,
                                disconnect=0.9)
        for _ in range(100):
            verdict = inj.draw()
            assert len([k for k in verdict if k != "delay"]) <= 1

    def test_disabled_draws_nothing_and_burns_no_rng(self):
        inj = WireFaultInjector(seed=1, drop=1.0)
        inj.enabled = False
        state = inj.rng.getstate()
        assert inj.draw() == []
        assert inj.rng.getstate() == state

    def test_forced_faults_preempt_random_draws(self):
        inj = WireFaultInjector(seed=1)
        inj.inject_next("drop")
        inj.inject_next("delay", "disconnect")
        assert inj.draw() == ["drop"]
        assert inj.draw() == ["delay", "disconnect"]
        assert inj.draw() == []
        assert inj.counts["drop"] == 1 and inj.counts["disconnect"] == 1

    def test_unknown_forced_kind_rejected(self):
        with pytest.raises(ValueError, match="unknown wire fault kind"):
            WireFaultInjector().inject_next("blackhole")

    def test_forced_fault_burns_the_same_rng_draws(self):
        # a run using inject_next() must see the SAME background schedule
        # as a same-seed run without it: the forced path burns its 4 RNG
        # draws too (review fix — it returned early, shifting every
        # verdict after the forced attempt)
        base = WireFaultInjector(seed=11, drop=0.3, duplicate=0.3)
        forced = WireFaultInjector(seed=11, drop=0.3, duplicate=0.3)
        baseline = [base.draw() for _ in range(10)]
        forced.inject_next("disconnect")
        assert forced.draw() == ["disconnect"]
        assert [forced.draw() for _ in range(9)] == baseline[1:]


class TestResilientClient:
    def test_drop_is_retried_transparently(self, sidecar):
        addr, _ = sidecar
        inj = WireFaultInjector(seed=1)
        rs, session = _pair(addr, construct_instance_types()[:12],
                            make_nodepool(name="default"), injector=inj)
        pods = make_pods(5, cpu="500m")
        r1 = rs.solve(pods)
        inj.inject_next("drop")
        r2 = rs.solve(pods)
        assert r2.retries == 1 and session.retries == 1
        assert session.resyncs == 0
        assert _digest(r2) == _digest(r1)
        session.close()

    def test_lost_response_recovers_from_dedupe_without_resync(self, sidecar):
        addr, _ = sidecar
        inj = WireFaultInjector(seed=1)
        rs, session = _pair(addr, construct_instance_types()[:12],
                            make_nodepool(name="default"), injector=inj)
        pods = make_pods(6, cpu="500m")
        rs.solve(pods)
        pods[0:1] = make_pods(1, cpu="500m")
        inj.inject_next("disconnect")
        r = rs.solve(pods)
        # the server APPLIED the delta on the lost-response attempt; the
        # retry of identical bytes must be served from the dedupe cache —
        # no resync, no double apply (a double apply would fail the digest
        # handshake), and the session stays delta-resident
        assert r.retries == 1
        assert session.resyncs == 0
        assert session.last_encode_kind == "delta"
        with srv._SESSIONS_LOCK:
            s = [x for x in srv._SESSIONS.values()
                 if x.id == session._session_id][0]
        assert s.dedup_hits >= 1
        session.close()

    def test_duplicate_delivery_is_deduped(self, sidecar):
        addr, _ = sidecar
        inj = WireFaultInjector(seed=1)
        rs, session = _pair(addr, construct_instance_types()[:12],
                            make_nodepool(name="default"), injector=inj)
        pods = make_pods(4, cpu="500m")
        rs.solve(pods)
        pods[0:1] = make_pods(1, cpu="500m")
        inj.inject_next("duplicate")
        r = rs.solve(pods)
        assert r.retries == 0 and session.resyncs == 0
        with srv._SESSIONS_LOCK:
            s = [x for x in srv._SESSIONS.values()
                 if x.id == session._session_id][0]
        assert s.dedup_hits >= 1  # the second delivery never re-applied
        session.close()

    def test_deadline_exceeded_on_stalled_wire_then_recovery(self, sidecar):
        addr, _ = sidecar
        inj = WireFaultInjector(seed=1, delay_seconds=0.5)
        rs, session = _pair(addr, construct_instance_types()[:12],
                            make_nodepool(name="default"), injector=inj,
                            retry=_fast_policy(deadline=0.1))
        pods = make_pods(4, cpu="500m")
        rs.solve(pods)
        pods[0:1] = make_pods(1, cpu="500m")
        from karpenter_tpu_torch.metrics.registry import SIDECAR_CLIENT_RETRIES
        before = SIDECAR_CLIENT_RETRIES.value({"code": "deadline_exceeded"})
        inj.inject_next("delay")  # 0.5s wire vs 0.1s deadline
        r = rs.solve(pods)
        assert r.retries == 1
        assert r.deadline_s == 0.1
        assert SIDECAR_CLIENT_RETRIES.value(
            {"code": "deadline_exceeded"}) == before + 1
        assert session.resyncs == 0
        session.close()

    def test_retry_budget_exhaustion_fails_fast_then_session_heals(
            self, sidecar):
        addr, _ = sidecar
        inj = WireFaultInjector(seed=1)
        rs, session = _pair(addr, construct_instance_types()[:12],
                            make_nodepool(name="default"), injector=inj,
                            retry=_fast_policy(max_attempts=2,
                                               retry_budget=1.0,
                                               refund=0.0))
        pods = make_pods(5, cpu="500m")
        r1 = rs.solve(pods)
        # a DISTINGUISHABLE replacement (different cpu -> different wire
        # template): if the stale-mirror delta double-applies after the
        # failed solve, the row multiset visibly diverges and the digest
        # handshake must catch it
        pods[0:1] = make_pods(1, cpu="250m")
        # attempt 1 disconnects (server APPLIES, response lost), the single
        # budgeted retry drops too: the solve raises
        inj.inject_next("disconnect")
        inj.inject_next("drop")
        with pytest.raises(grpc.RpcError):
            rs.solve(pods)
        # budget dry: the next fault is not retried at all
        inj.inject_next("drop")
        with pytest.raises(grpc.RpcError):
            rs.solve(pods)
        # fault-free now: the session heals transparently — the server is
        # AHEAD of the client mirrors (the applied-but-unacked delta), so
        # the recovery path is a digest-mismatch resync, never a wedge
        r3 = rs.solve(pods)
        assert session.resyncs >= 1
        d1 = _digest(r1)
        assert isinstance(d1, str) and _digest(r3) != ""
        r4 = rs.solve(pods)
        assert session.last_encode_kind == "delta"
        assert _digest(r4) == _digest(r3)
        session.close()

    def test_hedged_solve_wins_on_dropped_primary(self, sidecar):
        addr, _ = sidecar
        inj = WireFaultInjector(seed=1)
        rs, session = _pair(
            addr, construct_instance_types()[:12],
            make_nodepool(name="default"), injector=inj,
            retry=_fast_policy(deadline=60.0))
        pods = make_pods(5, cpu="500m")
        # no hedging on the bootstrap: however slow the machine, it cannot
        # fire a hedge of its own
        rs.solve(pods)
        pods[0:1] = make_pods(1, cpu="500m")
        # the primary is held 30 s and then dropped, so the hedge (fired
        # at +50 ms, a solve of milliseconds) answers first and wins
        session.retry.hedge_delay = 0.05
        inj.delay_seconds = 30.0
        inj.inject_next("delay", "drop")
        r = rs.solve(pods)
        assert r.hedged is True
        assert session.hedges == 1 and session.hedges_won == 1
        assert session.resyncs == 0
        from karpenter_tpu_torch.metrics.registry import SIDECAR_CLIENT_HEDGES
        assert SIDECAR_CLIENT_HEDGES.value({"outcome": "won"}) >= 1
        session.close()

    def test_default_deadline_rider_on_results(self, sidecar):
        addr, _ = sidecar
        rs, session = _pair(addr, construct_instance_types()[:12],
                            make_nodepool(name="default"))
        r = rs.solve(make_pods(3, cpu="500m"))
        assert r.deadline_s == session.retry.deadline > 0
        assert r.retries == 0 and r.hedged is False
        session.close()

    def test_degraded_rider_when_circuit_open(self, sidecar):
        from karpenter_tpu_torch.provisioning.tensor_scheduler import SOLVER_CIRCUIT
        addr, _ = sidecar
        rs, session = _pair(addr, construct_instance_types()[:12],
                            make_nodepool(name="default"))
        pods = make_pods(4, cpu="500m")
        r1 = rs.solve(pods)
        assert r1.degraded == ""
        for _ in range(SOLVER_CIRCUIT.threshold):
            SOLVER_CIRCUIT.record_failure()
        try:
            pods[0:1] = make_pods(1, cpu="500m")
            r2 = rs.solve(pods)
            # the breaker forced the host oracle server-side: the client
            # sees degraded=host_oracle instead of a silently slow answer
            assert r2.degraded == "host_oracle"
            assert r2.fallback_reason == "circuit_open"
            assert sum(r2.partition) == len(pods)  # partition rider rode too
        finally:
            SOLVER_CIRCUIT.reset()
        session.close()


class TestCrashSafeServer:
    def test_drain_nacks_new_rpcs_unavailable_and_readyz_flips(self):
        server, port = srv.serve(device="cpu", port=0)
        serving = srv.start_serving(0, 0, draining=server.draining)
        addr = f"127.0.0.1:{port}"
        try:
            rs, session = _pair(addr, construct_instance_types()[:12],
                                make_nodepool(name="default"),
                                retry=_fast_policy(max_attempts=1))
            rs.solve(make_pods(3, cpu="500m"))
            hp = serving.health_port
            assert urllib.request.urlopen(
                f"http://127.0.0.1:{hp}/readyz").status == 200
            shed = server.drain(grace=1.0)
            assert shed == 0  # nothing was queued
            with pytest.raises(urllib.request.HTTPError) as exc:
                urllib.request.urlopen(f"http://127.0.0.1:{hp}/readyz")
            assert exc.value.code == 503
            assert urllib.request.urlopen(
                f"http://127.0.0.1:{hp}/healthz").status == 200
            with pytest.raises(grpc.RpcError) as rpc_exc:
                rs.solve(make_pods(3, cpu="500m"))
            assert rpc_exc.value.code() == grpc.StatusCode.UNAVAILABLE
            assert "draining" in rpc_exc.value.details()
            from karpenter_tpu_torch.metrics.registry import SIDECAR_DRAINING
            assert SIDECAR_DRAINING.value() == 1.0
            session.close()
        finally:
            serving.stop()
            server.stop(grace=None)
        from karpenter_tpu_torch.metrics.registry import SIDECAR_DRAINING
        assert SIDECAR_DRAINING.value() == 0.0

    def test_drain_nacks_queued_waiters_with_retryable_shed(self):
        q = srv.AdmissionQueue(max_concurrent=1, max_queued=8)
        q.acquire("a")  # hold the device
        results = []

        def waiter():
            try:
                q.acquire("b")
                results.append("granted")
            except srv.ShedError as e:
                results.append(e.reason)

        t = threading.Thread(target=waiter)
        t.start()
        for _ in range(200):
            if q.depth("b") == 1:
                break
            time.sleep(0.005)
        assert q.shed_all("draining") == 1
        t.join(2.0)
        assert results == ["draining"]
        q.release()

    def test_saturated_queue_sheds_burst_tenant_for_fair_one(self):
        q = srv.AdmissionQueue(max_concurrent=1, max_queued=4)
        q.acquire("burst")  # device held
        outcomes = {}

        def enqueue(tenant, key):
            def run():
                try:
                    q.acquire(tenant)
                    outcomes[key] = "granted"
                    q.release()
                except srv.ShedError as e:
                    outcomes[key] = e.reason
            t = threading.Thread(target=run, daemon=True)
            t.start()
            return t

        threads = []
        for i in range(4):
            threads.append(enqueue("burst", f"burst-{i}"))
            # serialize enqueue order so "newest waiter" is burst-3
            for _ in range(200):
                if q.depth("burst") == i + 1:
                    break
                time.sleep(0.005)
        assert q.depth("burst") == 4  # the queue is at its bound
        # a steady tenant under fair share (4 // 2 tenants = 2) evicts the
        # burst tenant's NEWEST waiter instead of being bounced
        t_steady = enqueue("steady", "steady-0")
        for _ in range(200):
            if q.depth("steady") == 1:
                break
            time.sleep(0.005)
        assert q.depth("steady") == 1
        # the shed THREAD publishes its outcome after waking: poll for it
        deadline = time.monotonic() + 5.0
        while "burst-3" not in outcomes and time.monotonic() < deadline:
            time.sleep(0.005)
        assert outcomes.get("burst-3") == "fairness"  # newest burst waiter
        from karpenter_tpu_torch.metrics.registry import SIDECAR_SHED
        assert SIDECAR_SHED.value({"tenant": "burst",
                                   "reason": "fairness"}) >= 1
        # drain everything so the threads exit
        q.release()
        deadline = time.monotonic() + 5.0
        while any(t.is_alive() for t in threads + [t_steady]) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert outcomes.get("steady-0") == "granted"

    def test_fairly_saturated_queue_bounces_over_share_requester(self):
        q = srv.AdmissionQueue(max_concurrent=1, max_queued=2)
        q.acquire("a")
        held = []

        def hold(tenant):
            def run():
                try:
                    q.acquire(tenant)
                    held.append(tenant)
                    q.release()
                except srv.ShedError:
                    held.append(f"{tenant}-shed")
            t = threading.Thread(target=run, daemon=True)
            t.start()
            return t

        threads = [hold("b"), hold("c")]
        for _ in range(200):
            if q.depth("b") + q.depth("c") == 2:
                break
            time.sleep(0.005)
        # bound 2, three tenants -> fair share 1 for everyone, and tenant
        # "a" (the requester) would exceed it: global RESOURCE_EXHAUSTED
        with pytest.raises(srv.ShedError) as exc:
            q.acquire("a")
        assert exc.value.reason == "overload"
        q.release()
        deadline = time.monotonic() + 5.0
        while any(t.is_alive() for t in threads) \
                and time.monotonic() < deadline:
            time.sleep(0.01)

    def test_debug_sessions_endpoint(self, sidecar):
        addr, _server = sidecar
        rs, session = _pair(addr, construct_instance_types()[:12],
                            make_nodepool(name="default"), tenant="acme")
        rs.solve(make_pods(4, cpu="500m"))
        serving = srv.start_serving(0, 0)
        try:
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{serving.metrics_port}/debug/sessions"
            ).read().decode()
        finally:
            serving.stop()
        assert body.startswith("sessions ")
        line = next(l for l in body.splitlines()
                    if f"tenant=acme" in l)
        assert session._session_id in line
        assert "solves=1" in line and "resyncs=0" in line
        assert "queue_depth=0" in line and "in_flight=0" in line
        assert "last_solve_age_s=" in line and "dedup_hits=0" in line
        session.close()

    def test_sessions_snapshot_fields(self, sidecar):
        addr, _server = sidecar
        rs, session = _pair(addr, construct_instance_types()[:12],
                            make_nodepool(name="default"), tenant="t9")
        rs.solve(make_pods(3, cpu="500m"))
        snap = [s for s in srv.sessions_snapshot()
                if s["session"] == session._session_id]
        assert len(snap) == 1
        s = snap[0]
        assert s["tenant"] == "t9" and s["rows"] == 3
        assert s["solves"] == 1 and s["digest"]
        assert s["last_solve_age_s"] >= 0
        session.close()

    def test_zombie_request_rejected_without_corrupting_state(self, sidecar):
        # a hedge/retry loser of an OLD solve that arrives after later
        # solves evicted its response from the 2-entry dedupe cache must
        # be REJECTED (stale nonce), never re-applied on top of newer
        # state (review fix — a re-apply corrupted the session and forced
        # the resync DEVIATIONS 23 promises cannot happen)
        addr, _server = sidecar
        recorded = []

        class _Recording:
            def __init__(self, channel):
                self._channel = channel

            def unary_unary(self, method, request_serializer=None,
                            response_deserializer=None, **kw):
                inner = self._channel.unary_unary(
                    method, request_serializer=request_serializer,
                    response_deserializer=response_deserializer, **kw)
                if not method.endswith("SolveSession"):
                    return inner

                def call(request, timeout=None):
                    recorded.append(request)
                    return inner(request, timeout=timeout)
                return call

            def close(self):
                self._channel.close()

            def __getattr__(self, item):
                return getattr(self._channel, item)

        channel = _Recording(
            grpc.insecure_channel(addr, options=srv.GRPC_OPTIONS))
        session = SolverSession(addr, channel=channel,
                                retry=_fast_policy())
        rs = RemoteScheduler(addr, [make_nodepool(name="default")],
                             {"default": construct_instance_types()[:12]},
                             session=session)
        rs.solve(make_pods(4, cpu="500m"))
        zombie = recorded[0]
        rs.solve(make_pods(6, cpu="250m"))
        rs.solve(make_pods(8, cpu="250m"))  # q1 evicted from the cache
        with pytest.raises(grpc.RpcError) as exc:
            session._call("SolveSession", zombie)
        assert exc.value.code() == grpc.StatusCode.FAILED_PRECONDITION
        assert "stale request nonce" in exc.value.details()
        # the zombie touched nothing: the next delta solve flows clean
        r = rs.solve(make_pods(5, cpu="500m"))
        assert session.resyncs == 0 and r.all_pods_scheduled()
        session.close()


class TestRestartRecovery:
    def _churn(self, rs, pods, rounds, tag):
        out = []
        for w in range(rounds):
            pods[w % len(pods)] = make_pods(1, cpu="500m")[0]
            out.append(_digest(rs.solve(pods)))
        return out

    def test_server_restart_mid_churn_resyncs_and_matches_oracle(self):
        """Kill and restart the server mid-churn with live tenant sessions:
        every client resyncs transparently (zero raised errors) and the
        post-recovery decisions match a never-restarted oracle run."""
        its = construct_instance_types()[:12]
        pool = make_nodepool(name="default")
        server, port = srv.serve(device="cpu", port=0)
        addr = f"127.0.0.1:{port}"
        tenants = {name: make_pods(n, cpu="500m")
                   for name, n in (("t-a", 6), ("t-b", 9))}
        sessions = {name: _pair(addr, its, pool, tenant=name)
                    for name in tenants}
        post = {}
        try:
            for name, pods in tenants.items():
                sessions[name][0].solve(pods)
            # kill: the listener dies, every session dies with it; a new
            # server binds the SAME port (the client channel reconnects)
            done = server.stop(0)
            if done is not None:
                done.wait(5.0)
            with srv._SESSIONS_LOCK:
                srv._SESSIONS.clear()
            server, port2 = srv.serve(device="cpu", port=port)
            assert port2 == port
            for name, pods in tenants.items():
                rs, session = sessions[name]
                post[name] = self._churn(rs, pods, 3, "post")
                assert session.resyncs >= 1, (
                    f"tenant {name} never resynced across the restart")
                # and the session is delta-resident again afterwards
                rs.solve(pods)
                assert session.last_encode_kind == "delta"
        finally:
            for rs, session in sessions.values():
                session.close()
            server.stop(grace=None)
        # oracle: identical churn against a never-restarted server
        oracle_server, oracle_port = srv.serve(device="cpu", port=0)
        oaddr = f"127.0.0.1:{oracle_port}"
        try:
            for name, n in (("t-a", 6), ("t-b", 9)):
                pods = make_pods(n, cpu="500m")
                rs, session = _pair(oaddr, its, pool, tenant=name)
                rs.solve(pods)
                want = self._churn(rs, pods, 3, "post")
                # digests are uid-based and make_pods mints fresh uids per
                # call, so compare SHAPE equality: same claim/existing/
                # error structure per round
                for got, exp in zip(post[name], want):
                    g, e = json.loads(got), json.loads(exp)
                    assert [(c[0], c[1]) for c in g[0]] == \
                        [(c[0], c[1]) for c in e[0]]
                    assert len(g[1]) == len(e[1]) and g[2] == e[2] == []
                session.close()
        finally:
            oracle_server.stop(grace=None)


class TestWireChaosSoak:
    def test_seeded_soak_converges_byte_identical_to_fault_free(self):
        """The soak: a seeded 5%-per-kind fault schedule over a
        churn stream — the client/server converge with zero wedged
        sessions and decisions byte-identical to a fault-free run of the
        SAME churn schedule (same pods, same order)."""
        import random as _random
        its = construct_instance_types()[:12]
        pool = make_nodepool(name="default")
        # ONE pod universe shared by both runs: decision digests key on
        # pod uids, so the fault-free oracle must churn the same objects
        # through the same schedule
        base0 = make_pods(12, cpu="500m")
        spare = make_pods(30, cpu="250m")

        def run(faulty: bool):
            server, port = srv.serve(device="cpu", port=0)
            addr = f"127.0.0.1:{port}"
            inj = WireFaultInjector(seed=99, drop=0.05, delay=0.05,
                                    duplicate=0.05, disconnect=0.05,
                                    delay_seconds=0.005)
            inj.enabled = faulty
            rs, session = _pair(addr, its, pool, injector=inj,
                                retry=_fast_policy())
            rng = _random.Random(1234)
            base = list(base0)
            digests = []
            try:
                for round_ in range(14):
                    i = rng.randrange(len(base))
                    base[i] = spare[round_ % len(spare)]
                    digests.append(_digest(rs.solve(base)))
                # convergence probe: fault-free parity re-solve of the
                # final state, cold, server-side
                inj.enabled = False
                session.parity_every = 1
                rs.solve(base)
                parity = session.last_parity
            finally:
                session.close()
                server.stop(grace=None)
            return digests, parity, session, inj

        faulted, parity_f, session_f, inj = run(faulty=True)
        clean, parity_c, session_c, _ = run(faulty=False)
        assert session_c.retries == 0
        assert inj.fired() > 0, "the 5% schedule never fired — no soak"
        assert faulted == clean, (
            "decisions diverged from the fault-free run")
        assert parity_f == "byte-identical" == parity_c
        # zero wedged sessions: every solve completed (asserted by the
        # loop finishing) and no resync was ever needed — drop retries +
        # dedupe recovery healed every fault in place
        assert session_f.resyncs == 0
        assert session_f.retries > 0
