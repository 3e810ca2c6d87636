"""tests/test_sidecar_delta.py pointed at the port: delta-aware sidecar
sessions — codec round-trips for every delta message kind (seeded from the
parity fuzzer's generator corpus), the content-digest handshake + resync
paths, a loud failure on unknown delta schema versions, session eviction
under load, tenant-fair admission, and per-tenant observability. The
port's server solves on the CPU (``device="cpu"``); under churn each
round's decisions equal the JAX package's sidecar's round."""

import json
import random
import threading

import grpc
import pytest

from karpenter_tpu_torch.cloudprovider.kwok import construct_instance_types
from karpenter_tpu_torch.provisioning.tensor_scheduler import TensorScheduler
from karpenter_tpu_torch.sidecar import codec, wire
from karpenter_tpu_torch.sidecar import server as srv
from karpenter_tpu_torch.sidecar.client import RemoteScheduler, SolverSession

from test_torch_support import JAX, PORT, factories, sidecar_server
from test_torch_support import device_series_kept  # noqa: F401 (autouse)
from test_torch_support import sidecar_state_kept  # noqa: F401 (autouse)
from test_torch_support import tracer_kept  # noqa: F401 (autouse)
import test_torch_solve_parity as fuzz

make_nodepool = factories(PORT).make_nodepool
make_pods = factories(PORT).make_pods
make_state_node = factories(PORT).make_state_node


def gen_nodepools(rng):
    return fuzz.gen_nodepools(rng, PORT)


def gen_pods(rng, pools):
    return fuzz.gen_pods(rng, pools, PORT)


def cpu_scheduler(*args, **kw):
    """The port's in-process TensorScheduler on the CPU."""
    return TensorScheduler(*args, device="cpu", **kw)


@pytest.fixture(scope="module")
def sidecar():
    with sidecar_server(PORT) as (_, address):
        yield address


@pytest.fixture(scope="module")
def jax_sidecar():
    with sidecar_server(JAX) as (_, address):
        yield address


def _session_pair(sidecar, its, pool, tenant="", **kw):
    session = SolverSession(sidecar, tenant=tenant)
    return RemoteScheduler(sidecar, [pool], {"default": its},
                           session=session, **kw), session


def _mirror_apply(mirror, header, blobs):
    """Server-side shadow of _apply_session_delta's pod/template half, over
    plain dicts — the codec property tests run the wire WITHOUT grpc."""
    if header.get("full_state"):
        mirror.update(template_list=[], template_keys=[], rows=[],
                      state_tokens={}, ds_token="", cluster_token="")
    for tid, d in header.get("templates_new", ()):
        assert tid == len(mirror["template_list"])
        mirror["template_list"].append(d)
        mirror["template_keys"].append(codec.template_content_key(d))
    mirror["rows"] = codec.apply_pod_delta(mirror["rows"], header, blobs)
    for d in header.get("state_upsert", ()):
        mirror["state_tokens"][d["name"]] = str(
            header.get("state_revs", {}).get(d["name"], ""))
    for name in header.get("state_remove", ()):
        mirror["state_tokens"].pop(name, None)
    if "ds_token" in header:
        mirror["ds_token"] = str(header["ds_token"])
    if "cluster_token" in header:
        mirror["cluster_token"] = str(header["cluster_token"])
    return codec.batch_digest(
        [r[0] for r in mirror["rows"]], [r[1] for r in mirror["rows"]],
        codec.templates_digest(mirror["template_keys"]),
        mirror["state_tokens"], mirror["ds_token"], mirror["cluster_token"])


def _offline_session():
    """A SolverSession used purely as the delta-request assembler (no RPC
    ever issued; the channel never connects)."""
    s = SolverSession("127.0.0.1:1")
    s._session_id = "offline"
    return s


class TestDeltaCodec:
    """Pure-codec property tests: the client's request assembly and the
    server's apply must agree on state and digest through arbitrary churn
    (the wire equivalent of the ProblemState churn fuzzer)."""

    @pytest.mark.parametrize("seed", [3, 11, 29])
    def test_churned_batches_round_trip_and_digest_agree(self, seed):
        rng = random.Random(seed)
        pools = gen_nodepools(rng)
        pods = gen_pods(rng, pools)
        sess = _offline_session()
        mirror = dict(template_list=[], template_keys=[], rows=[],
                      state_tokens={}, ds_token="", cluster_token="")
        for round_ in range(6):
            header, blobs, commit, order = sess._delta_request(
                pods, [], [], None, None, False)
            digest = _mirror_apply(mirror, header, blobs)
            assert digest == header["digest"], f"round {round_} diverged"
            commit()
            # decoded server batch must be content-identical to a direct
            # encode of the same pod order
            tids = [r[0] for r in mirror["rows"]]
            tss = [r[1] for r in mirror["rows"]]
            back = codec.build_wire_pods(mirror["template_list"], tids, tss)
            assert len(back) == len(order)
            for wp, p in zip(back, order):
                assert wp.requests() == p.requests()
                assert wp.metadata.labels == p.metadata.labels
                assert wp.namespace == p.namespace
            # churn: drop a slice, add fresh shapes, keep the rest
            rng.shuffle(pods)
            pods = pods[rng.randint(0, max(1, len(pods) // 3)):]
            pods += gen_pods(rng, pools)[:rng.randint(1, 20)]

    def test_pod_remove_only_delta(self):
        sess = _offline_session()
        pods = make_pods(6, cpu="500m")
        h1, b1, commit, _ = sess._delta_request(pods, [], [], None, None,
                                                False)
        assert h1.get("pods_full") == 1 and h1.get("full_state") == 1
        commit()
        h2, b2, commit2, order = sess._delta_request(pods[:4], [], [], None,
                                                     None, False)
        assert "pods_full" not in h2 and "templates_new" not in h2
        assert wire.unpack_u32(b2["pod_remove"]).tolist() == [4, 5]
        assert "pod_add_tid" not in b2
        assert [p.uid for p in order] == [p.uid for p in pods[:4]]

    def test_pod_add_only_delta_reuses_templates(self):
        sess = _offline_session()
        pods = make_pods(4, cpu="500m")
        _, _, commit, _ = sess._delta_request(pods, [], [], None, None,
                                              False)
        commit()
        grown = pods + make_pods(2, cpu="500m")
        h, b, _, order = sess._delta_request(grown, [], [], None, None,
                                             False)
        # same deployment shape: the existing template id is reused, only
        # the two new rows ride the wire
        assert "templates_new" not in h
        assert "pod_remove" not in b
        assert len(wire.unpack_u32(b["pod_add_tid"])) == 2
        assert [p.uid for p in order] == [p.uid for p in grown]

    def test_degenerate_diff_falls_back_to_snapshot(self):
        sess = _offline_session()
        pods = make_pods(8, cpu="500m")
        _, _, commit, _ = sess._delta_request(pods, [], [], None, None,
                                              False)
        commit()
        replaced = make_pods(8, cpu="250m")  # every row churned
        h, b, _, _ = sess._delta_request(replaced, [], [], None, None,
                                         False)
        assert h.get("pods_full") == 1
        # the template table is still valid: NOT a full_state resync
        assert "full_state" not in h
        assert "pod_remove" not in b

    def test_state_and_ds_tokens_move_the_digest(self):
        sess = _offline_session()
        pods = make_pods(3, cpu="250m")
        h1, _, commit, _ = sess._delta_request(pods, [], [], None, None,
                                               False)
        commit()
        sn = make_state_node("delta-n1", zone="test-zone-a")
        h2, _, commit2, _ = sess._delta_request(pods, [sn], [], None, None,
                                                False)
        assert [d["name"] for d in h2["state_upsert"]] == ["delta-n1"]
        assert "delta-n1" in h2["state_revs"]
        assert h2["digest"] != h1["digest"]
        commit2()
        ds = make_pods(1, cpu="100m")
        h3, _, _, _ = sess._delta_request(pods, [sn], ds, None, None, False)
        assert "daemonset" in h3 and h3["ds_token"]
        assert h3["digest"] != h2["digest"]
        # removing the node flows as a remove + digest move
        h4, _, _, _ = sess._delta_request(pods, [], [], None, None, False)
        assert h4["state_remove"] == ["delta-n1"]
        assert h4["digest"] != h2["digest"]

    def test_apply_pod_delta_rejects_malformed_removals(self):
        rows = [(0, 1.0), (0, 2.0), (1, 3.0)]
        for bad in ([2, 1], [3], [1, 1]):
            with pytest.raises(ValueError):
                codec.apply_pod_delta(
                    rows, {}, {"pod_remove": wire.pack_u32(bad)})
        with pytest.raises(ValueError):
            codec.apply_pod_delta(rows, {}, {
                "pod_add_tid": wire.pack_u32([0, 1]),
                "pod_add_ts": wire.pack_f64([1.0])})

    def test_unknown_schema_version_is_loud(self):
        with pytest.raises(codec.DeltaVersionError):
            codec.check_delta_version({"v": 99})
        with pytest.raises(codec.DeltaVersionError):
            codec.check_delta_version({})
        codec.check_delta_version({"v": codec.DELTA_SCHEMA_VERSION})


class TestDeltaSession:
    """The delta wire against a live server: parity under churn, delta
    residency, digest-mismatch + eviction resyncs, parity probes."""

    def test_parity_with_local_under_churn(self, sidecar, jax_sidecar):
        """Each round's remote answer equals the port's in-process solve
        and, by decision digest, the same round through the JAX package's
        client and sidecar (the same churn built with its objects)."""
        from karpenter_tpu.flightrec.record import decision_digest as jdig
        from karpenter_tpu_torch.flightrec.record import \
            decision_digest as tdig
        from karpenter_tpu.cloudprovider.kwok import \
            construct_instance_types as jax_instance_types
        from karpenter_tpu.sidecar import client as jclient
        J = factories(JAX)
        jits = jax_instance_types()[:48]
        its = construct_instance_types()[:48]
        pool = make_nodepool(name="default")
        rs, session = _session_pair(sidecar, its, pool, tenant="parity-t")
        jsession = jclient.SolverSession(jax_sidecar, tenant="parity-t")
        jrs = jclient.RemoteScheduler(jax_sidecar, [J.make_nodepool(
            name="default")], {"default": jits}, session=jsession)

        def batch(make):
            return (make(12, cpu="500m")
                    + make(5, cpu="1000m", labels={"app": "x"}))
        pods, jpods = batch(make_pods), batch(J.make_pods)
        key = lambda nc: (tuple(it.name for it in nc.instance_type_options),
                          len(nc.pods))
        for round_ in range(4):
            remote = rs.solve(pods)
            local = cpu_scheduler([pool], {"default": its}).solve(pods)
            assert remote.pod_errors == local.pod_errors
            assert sorted(map(key, remote.new_nodeclaims)) == \
                sorted(map(key, local.new_nodeclaims)), f"round {round_}"
            jremote = jrs.solve(jpods)
            assert tdig(remote, pods, remote.fallback_reason,
                        tuple(remote.partition)) == \
                jdig(jremote, jpods, jremote.fallback_reason,
                     tuple(jremote.partition)), f"round {round_}"
            if round_ > 0:
                assert session.last_encode_kind == "delta"
                assert jsession.last_encode_kind == "delta"
            cpu = f"{250 + round_ * 50}m"
            pods = pods[2:] + make_pods(3, cpu=cpu)
            jpods = jpods[2:] + J.make_pods(3, cpu=cpu)
        assert session.resyncs == 0 and jsession.resyncs == 0
        session.close()
        jsession.close()

    def test_steady_state_wire_shrinks(self, sidecar):
        its = construct_instance_types()[:16]
        pool = make_nodepool(name="default")
        rs, session = _session_pair(sidecar, its, pool)
        sizes = []
        orig_call = session._call

        def spy(method, payload, _orig=orig_call):
            if method == "SolveSession":
                sizes.append(len(payload))
            return _orig(method, payload)

        session._call = spy
        pods = make_pods(200, cpu="500m")
        rs.solve(pods)
        pods[0:2] = make_pods(2, cpu="500m")  # 1% churn
        rs.solve(pods)
        assert len(sizes) == 2
        # the steady-state delta ships a handful of rows, not the batch
        assert sizes[1] < sizes[0] / 4, sizes
        session.close()

    def test_digest_mismatch_transparent_resync(self, sidecar):
        from karpenter_tpu_torch.metrics.registry import SIDECAR_RESYNCS
        its = construct_instance_types()[:16]
        pool = make_nodepool(name="default")
        rs, session = _session_pair(sidecar, its, pool)
        pods = make_pods(6, cpu="500m")
        r1 = rs.solve(pods)
        before = SIDECAR_RESYNCS.value({"reason": "digest_mismatch"})
        session._rows = session._rows[1:]  # corrupt the client mirror
        r2 = rs.solve(pods)
        assert session.resyncs == 1
        assert SIDECAR_RESYNCS.value({"reason": "digest_mismatch"}) == \
            before + 1
        assert r2.pod_errors == r1.pod_errors
        assert len(r2.new_nodeclaims) == len(r1.new_nodeclaims)
        # and the session is delta-resident again right after
        r3 = rs.solve(pods)
        assert session.last_encode_kind == "delta"
        assert session.resyncs == 1
        session.close()

    def test_eviction_transparent_resync(self, sidecar):
        its = construct_instance_types()[:16]
        pool = make_nodepool(name="default")
        rs, session = _session_pair(sidecar, its, pool)
        r1 = rs.solve(make_pods(4, cpu="500m"))
        assert not r1.pod_errors
        with srv._SESSIONS_LOCK:
            srv._SESSIONS.clear()  # server restart / eviction
        r2 = rs.solve(make_pods(4, cpu="500m"))
        assert not r2.pod_errors
        assert session.resyncs == 1
        assert session._session_id is not None
        rs.solve(make_pods(4, cpu="500m"))
        assert session.last_encode_kind == "delta"
        session.close()

    def test_lost_response_desync_heals_via_resync(self, sidecar):
        """A solve whose RESPONSE is lost leaves the client mirrors BEHIND
        the server (the server applied the delta; commit never ran). The
        re-sent template registrations then violate the server's
        contiguity check (INVALID_ARGUMENT, fired before the digest
        handshake) — the client must treat that as a resync trigger, not
        a hard failure."""
        its = construct_instance_types()[:16]
        pool = make_nodepool(name="default")
        rs, session = _session_pair(sidecar, its, pool)
        rs.solve(make_pods(4, cpu="500m"))
        # snapshot the mirrors, advance the server with a NEW template,
        # then roll the mirrors back — exactly a lost response
        saved = (dict(session._tmpl_ids), list(session._tmpl_keys),
                 list(session._tmpl_constrained), session._tmpl_digest,
                 list(session._rows), dict(session._pod_rows))
        grown = make_pods(4, cpu="500m") + make_pods(2, cpu="123m")
        rs.solve(grown)
        (session._tmpl_ids, session._tmpl_keys, session._tmpl_constrained,
         session._tmpl_digest, session._rows, session._pod_rows) = saved
        r = rs.solve(grown)  # re-registers an already-known template id
        assert not r.pod_errors
        assert session.resyncs == 1
        r2 = rs.solve(grown)
        assert session.last_encode_kind == "delta"
        assert session.resyncs == 1
        session.close()

    def test_parity_probe_is_byte_identical(self, sidecar):
        its = construct_instance_types()[:48]
        pool = make_nodepool(name="default")
        rs, session = _session_pair(sidecar, its, pool)
        session.parity_every = 1
        pods = (make_pods(8, cpu="500m")
                + make_pods(4, cpu="250m", labels={"app": "s"}))
        for _ in range(3):
            rs.solve(pods)
            assert session.last_parity == "byte-identical", \
                session.last_parity
            pods = pods[1:] + make_pods(1, cpu="750m")
        session.close()

    def test_state_node_revision_skips_reserialization(self, sidecar,
                                                       monkeypatch):
        its = construct_instance_types()[:16]
        pool = make_nodepool(name="default")
        rs, session = _session_pair(sidecar, its, pool)
        sn = make_state_node("rev-n1", zone="test-zone-a")
        assert sn.identity is not None and sn.revision is not None
        calls = []
        orig = codec.state_node_to_dict
        monkeypatch.setattr(codec, "state_node_to_dict",
                            lambda s, store=None: calls.append(s.name())
                            or orig(s, store=store))
        rs2 = RemoteScheduler(rs.address, [pool], {"default": its},
                              state_nodes=[sn], session=session)
        rs2.solve(make_pods(2, cpu="500m"))
        assert calls == ["rev-n1"]
        rs2.solve(make_pods(2, cpu="500m"))
        assert calls == ["rev-n1"], "unchanged revision re-serialized"
        sn.revision += 1  # a cluster mutation would bump this
        rs2.solve(make_pods(2, cpu="500m"))
        assert calls == ["rev-n1", "rev-n1"]
        assert session.resyncs == 0
        session.close()

    def test_unknown_version_over_the_wire(self, sidecar):
        its = construct_instance_types()[:8]
        pool = make_nodepool(name="default")
        rs, session = _session_pair(sidecar, its, pool)
        rs.solve(make_pods(2, cpu="500m"))  # establishes the session
        bad = wire.pack({"session": session._session_id, "v": 99,
                         "digest": ""}, {})
        with pytest.raises(grpc.RpcError) as exc:
            session._call("SolveSession", bad)
        assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        assert "schema version" in exc.value.details()
        session.close()

    def test_noncontiguous_template_registration_rejected(self, sidecar):
        its = construct_instance_types()[:8]
        pool = make_nodepool(name="default")
        rs, session = _session_pair(sidecar, its, pool)
        rs.solve(make_pods(2, cpu="500m"))
        bad = wire.pack({"session": session._session_id,
                         "v": codec.DELTA_SCHEMA_VERSION,
                         "templates_new": [[57, {"bogus": True}]]}, {})
        with pytest.raises(grpc.RpcError) as exc:
            session._call("SolveSession", bad)
        assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        assert "out of order" in exc.value.details()
        session.close()

    def test_legacy_session_wire_still_served(self, sidecar):
        """Pre-delta clients (no "v" in the header) keep working: full
        template list + row columns per solve."""
        its = construct_instance_types()[:16]
        pool = make_nodepool(name="default")
        session = SolverSession(sidecar)
        payload = codec.encode_session_request([pool], {"default": its})
        sid = json.loads(
            session._call("CreateSession", payload).decode())["session"]
        pods = make_pods(5, cpu="500m")
        templates, tmpl_idx, ts = codec.encode_pod_rows(pods)
        request = wire.pack({"session": sid, "templates": templates},
                            {"tmpl_idx": wire.pack_u32(tmpl_idx),
                             "ts": wire.pack_f64(ts)})
        response = session._call("SolveSession", request)
        from karpenter_tpu_torch.sidecar.client import decode_results_rows
        results = decode_results_rows(response, pods,
                                      codec.union_catalog({"default": its}))
        assert not results.pod_errors
        assert results.new_nodeclaims
        session.close()


class TestEvictionUnderLoad:
    """Satellite: eviction must never reap a session with a queued or
    in-flight solve, and idle reaping respects the same guard."""

    def _mk_session(self, name):
        its = construct_instance_types()[:4]
        pool = make_nodepool(name="default")
        payload = codec.encode_session_request([pool], {"default": its},
                                               tenant=name)
        sid = json.loads(srv._create_session(payload).decode())["session"]
        with srv._SESSIONS_LOCK:
            return srv._SESSIONS[sid]

    def test_create_overflow_skips_busy_sessions(self, monkeypatch):
        with srv._SESSIONS_LOCK:
            saved = dict(srv._SESSIONS)
            srv._SESSIONS.clear()
        monkeypatch.setattr(srv, "_SESSIONS_MAX", 2)
        try:
            s1 = self._mk_session("busy")
            s1.active = 1  # a queued/in-flight solve
            s2 = self._mk_session("idle")
            s3 = self._mk_session("new")
            with srv._SESSIONS_LOCK:
                alive = set(srv._SESSIONS)
            # the busy session survives; the idle LRU one was evicted
            assert s1.id in alive
            assert s2.id not in alive
            assert s3.id in alive
            # all-busy: the cap is exceeded rather than reaping live state
            s3.active = 1
            s4 = self._mk_session("another")
            with srv._SESSIONS_LOCK:
                assert {s1.id, s3.id, s4.id} <= set(srv._SESSIONS)
        finally:
            with srv._SESSIONS_LOCK:
                srv._SESSIONS.clear()
                srv._SESSIONS.update(saved)

    def test_idle_reap_skips_busy_sessions(self):
        with srv._SESSIONS_LOCK:
            saved = dict(srv._SESSIONS)
            srv._SESSIONS.clear()
        try:
            busy = self._mk_session("busy")
            idle = self._mk_session("idle")
            busy.active = 1
            old = busy.last_used
            reaped = srv._reap_idle_sessions(
                now=old + srv.SESSION_IDLE_SECONDS + 60)
            assert reaped == [idle.id]
            with srv._SESSIONS_LOCK:
                assert busy.id in srv._SESSIONS
                assert idle.id not in srv._SESSIONS
            # once released AND idle long enough, it goes too
            busy.active = 0
            reaped = srv._reap_idle_sessions(
                now=busy.last_used + srv.SESSION_IDLE_SECONDS + 60)
            assert reaped == [busy.id]
        finally:
            with srv._SESSIONS_LOCK:
                srv._SESSIONS.clear()
                srv._SESSIONS.update(saved)

    def test_concurrent_tenants_share_the_server(self, sidecar):
        """N tenant sessions solving concurrently: every solve lands, no
        resyncs, every tenant's admission wait is measured."""
        from karpenter_tpu_torch.metrics.registry import SIDECAR_QUEUE_WAIT
        its = construct_instance_types()[:16]
        pool = make_nodepool(name="default")
        errors = []

        def tenant(name):
            try:
                rs, session = _session_pair(sidecar, its, pool, tenant=name)
                pods = make_pods(10, cpu="500m")
                for w in range(4):
                    r = rs.solve(pods)
                    assert not r.pod_errors
                    pods[w] = make_pods(1, cpu="500m")[0]
                assert session.resyncs == 0
                assert session.last_encode_kind == "delta"
                session.close()
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append((name, repr(e)))

        names = [f"load-{i}" for i in range(3)]
        threads = [threading.Thread(target=tenant, args=(n,))
                   for n in names]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        for n in names:
            assert SIDECAR_QUEUE_WAIT.count({"tenant": n}) >= 4


class TestAdmissionQueue:
    def test_round_robin_fairness_across_tenants(self):
        q = srv.AdmissionQueue(max_concurrent=1, max_queued=16)
        assert q.acquire("A") == 0.0  # slot taken
        grants = []

        def waiter(tag, tenant):
            q.acquire(tenant)
            grants.append(tag)
            q.release()  # hand the slot down the chain

        threads = []
        for tag, tenant in (("A2", "A"), ("A3", "A"), ("B1", "B")):
            t = threading.Thread(target=waiter, args=(tag, tenant))
            t.start()
            threads.append(t)
            while True:  # deterministic enqueue order
                with q._lock:
                    if q._queued == len(threads):
                        break
        # the holder releases ONCE; each granted waiter records its grant
        # and releases in turn, so the recorded order IS the grant order
        q.release()
        for t in threads:
            t.join()
        # one tenant's burst never head-of-line-blocks the other: the
        # grant order interleaves A and B instead of draining A first
        assert grants == ["A2", "B1", "A3"]

    def test_queue_bound_rejects_loudly(self):
        q = srv.AdmissionQueue(max_concurrent=1, max_queued=1)
        assert q.acquire("A") == 0.0
        t = threading.Thread(target=q.acquire, args=("A",))
        t.start()
        while True:
            with q._lock:
                if q._queued == 1:
                    break
        with pytest.raises(srv.QueueFullError):
            q.acquire("B")
        q.release()
        t.join()
        q.release()

    def test_overload_and_cancellation_surface_as_grpc_codes(self,
                                                             monkeypatch):
        """A full queue must map to RESOURCE_EXHAUSTED (not UNKNOWN) on
        BOTH solve paths, and a request whose client cancelled while
        queued must be skipped (CANCELLED) instead of burning the device."""
        class _Abort(Exception):
            pass

        class _Ctx:
            def __init__(self, active=True):
                self.active = active
                self.code = None

            def is_active(self):
                return self.active

            def abort(self, code, msg):
                self.code = code
                raise _Abort(msg)

        its = construct_instance_types()[:4]
        pool = make_nodepool(name="default")
        payload = codec.encode_session_request([pool], {"default": its})
        sid = json.loads(srv._create_session(payload).decode())["session"]
        frame = wire.pack({"session": sid, "v": codec.DELTA_SCHEMA_VERSION,
                           "pods_full": 1, "full_state": 1}, {})
        # saturate the admission queue: slot held + queue full
        q = srv.AdmissionQueue(max_concurrent=1, max_queued=1)
        monkeypatch.setattr(srv, "ADMISSION", q)
        q.acquire("holder")
        t = threading.Thread(target=q.acquire, args=("holder",))
        t.start()
        while True:
            with q._lock:
                if q._queued == 1:
                    break
        ctx = _Ctx()
        with pytest.raises(_Abort):
            srv._solve_session(frame, ctx)
        assert ctx.code == grpc.StatusCode.RESOURCE_EXHAUSTED
        ctx2 = _Ctx()
        with pytest.raises(_Abort):
            srv._solve(codec.encode_solve_request([pool], {"default": its},
                                                  make_pods(1, cpu="100m")),
                       ctx2)
        assert ctx2.code == grpc.StatusCode.RESOURCE_EXHAUSTED
        q.release()   # holder done: grants the queued waiter
        t.join()
        q.release()   # the granted waiter's slot
        # cancelled-while-queued: the slot is granted but the solve is
        # skipped and the slot freed for live requests
        ctx3 = _Ctx(active=False)
        with pytest.raises(_Abort):
            srv._solve_session(frame, ctx3)
        assert ctx3.code == grpc.StatusCode.CANCELLED
        with q._lock:
            assert q._active == 0 and q._queued == 0

    def test_depth_gauge_tracks_waiters(self):
        from karpenter_tpu_torch.metrics.registry import SIDECAR_QUEUE_DEPTH
        q = srv.AdmissionQueue(max_concurrent=1, max_queued=8)
        q.acquire("depth-t")
        t = threading.Thread(target=q.acquire, args=("depth-t",))
        t.start()
        while True:
            with q._lock:
                if q._queued == 1:
                    break
        assert SIDECAR_QUEUE_DEPTH.value({"tenant": "depth-t"}) == 1.0
        q.release()
        t.join()
        assert SIDECAR_QUEUE_DEPTH.value({"tenant": "depth-t"}) == 0.0
        q.release()


class TestTenantObservability:
    def test_tenant_label_is_bounded(self, monkeypatch):
        from karpenter_tpu_torch.metrics import registry as reg
        # fresh bound set: the real one is process-lifetime, and filling
        # its cap here would demote every later test's tenants to overflow
        monkeypatch.setattr(reg, "_TENANT_LABELS", set())
        out = {reg.tenant_label(f"cap-tenant-{i}") for i in range(100)}
        # at most the cap's worth of real names; the rest collapse
        assert len(out) <= reg.TENANT_LABEL_CAP + 1
        assert reg.TENANT_OVERFLOW in out
        # established names stay stable
        first = reg.tenant_label("cap-tenant-0")
        assert first == reg.tenant_label("cap-tenant-0")

    def test_sidecar_solve_emits_tenant_phase_series(self, sidecar):
        from karpenter_tpu_torch.metrics.registry import REGISTRY
        its = construct_instance_types()[:8]
        pool = make_nodepool(name="default")
        rs, session = _session_pair(sidecar, its, pool, tenant="obs-t")
        rs.solve(make_pods(3, cpu="500m"))
        session.close()
        text = REGISTRY.expose()
        assert 'tenant="obs-t"' in text
        # the sidecar root span itself lands in the phase histogram
        assert 'phase="sidecar.solve"' in text

    def test_slo_snapshot_filters_by_tenant(self):
        from karpenter_tpu_torch.obs.slo import SLOWatcher
        from karpenter_tpu_torch.obs.tracer import Tracer
        tracer = Tracer()
        watcher = SLOWatcher({"sidecar.solve": 10.0})
        tracer.watcher = watcher
        with tracer.span("sidecar.solve", tenant="a"):
            pass
        with tracer.span("sidecar.solve", tenant="a"):
            pass
        with tracer.span("sidecar.solve", tenant="b"):
            pass
        snap_all = watcher.snapshot()
        assert snap_all["budgets"]["sidecar.solve"]["observed"] == 3
        snap_a = watcher.snapshot(tenant="a")
        assert snap_a["budgets"]["sidecar.solve"]["observed"] == 2
        assert snap_a["tenant"] == "a"
        assert watcher.snapshot(
            tenant="zzz")["budgets"]["sidecar.solve"]["observed"] == 0

    def test_debug_traces_filters_by_tenant_and_session(self):
        from karpenter_tpu_torch.obs.tracer import Tracer
        from karpenter_tpu_torch.operator.server import _debug_traces_factory
        tracer = Tracer()
        with tracer.span("sidecar.solve", tenant="a", session="s1"):
            pass
        with tracer.span("sidecar.solve", tenant="b", session="s2"):
            pass
        fn = _debug_traces_factory(tracer)
        status, _, body = fn({"tenant": ["a"]})
        assert status == 200
        assert "traces 1" in body
        status, _, body = fn({"session": ["s2"]})
        assert "traces 1" in body
        status, _, body = fn({"tenant": ["a"], "session": ["s2"]})
        assert "traces 0" in body

    def test_debug_slo_accepts_tenant_query(self):
        from karpenter_tpu_torch.obs.slo import SLOWatcher
        from karpenter_tpu_torch.operator.server import _debug_slo_factory
        watcher = SLOWatcher({"solve": 1.0})
        fn = _debug_slo_factory(watcher)
        status, ctype, body = fn({"tenant": ["a"]})
        assert status == 200 and ctype == "application/json"
        assert json.loads(body)["tenant"] == "a"
        status, _, body = fn({})
        assert json.loads(body)["tenant"] is None
