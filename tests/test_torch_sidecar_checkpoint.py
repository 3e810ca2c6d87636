"""tests/test_sidecar_checkpoint.py pointed at the port (its servers on
the CPU): session checkpoints over the wire codec — round-trips of
everything a server-side session IS — template table, pod row columns,
state-node mirrors and revision tokens, dedupe nonces, the response cache
and the last acked digest — seeded from the parity fuzzer's generator
corpus, plus the loud-reject matrix (truncation, wrong kind, unknown
checkpoint schema version, delta-wire skew, corrupt digests, stripped
fields/blobs) and the KARPENTER_SIDECAR_MAX_SESSIONS boot contract. Then
the cross-package handoff: a checkpoint exported by a JAX replica restores
on a port replica and the reverse, and the next delta solve there gives the
digest of the session that never moved, with no resync."""

import random

import pytest

from karpenter_tpu_torch.cloudprovider.kwok import construct_instance_types
from karpenter_tpu_torch.sidecar import codec, wire
from karpenter_tpu_torch.sidecar import server as srv
from karpenter_tpu_torch.sidecar.client import RemoteScheduler, SolverSession

from test_torch_support import (JAX, PORT, factories, reset_claim_names,
                                sidecar_server)
from test_torch_support import device_series_kept  # noqa: F401 (autouse)
from test_torch_support import sidecar_state_kept  # noqa: F401 (autouse)
from test_torch_support import tracer_kept  # noqa: F401 (autouse)
import test_torch_solve_parity as fuzz

make_pods = factories(PORT).make_pods
make_nodepool = factories(PORT).make_nodepool
make_state_node = factories(PORT).make_state_node


def gen_nodepools(rng):
    return fuzz.gen_nodepools(rng, PORT)


def gen_pods(rng, pools):
    return fuzz.gen_pods(rng, pools, PORT)


@pytest.fixture(scope="module")
def fleet_one():
    """One isolated Replica (NOT the module default) with a handoff store
    attached, so drain/export tests cannot leak into other modules."""
    rep = srv.Replica(name="ckpt-test", handoff=srv.HandoffStore())
    with sidecar_server(PORT, replica=rep) as (_, address):
        yield address, rep


def _live_session(address, rep, tenant, pods, rounds=3, seed=5):
    """Drive a real session to a non-trivial state: bootstrap + churned
    delta solves so rows, templates, state nodes, the response cache and
    the dedupe nonce are all populated. Returns the SERVER-side _Session."""
    rng = random.Random(seed)
    session = SolverSession(address, tenant=tenant)
    rs = RemoteScheduler(address, [make_nodepool()],
                         {"default": construct_instance_types()},
                         state_nodes=[make_state_node(f"{tenant}-n1",
                                                      zone="test-zone-a")],
                         session=session)
    for round_ in range(rounds):
        rs.solve(pods)
        rng.shuffle(pods)
        pods = pods[:max(2, len(pods) - 2)] + make_pods(
            2, cpu=f"{200 + 100 * round_}m")
    with rep.sessions_lock:
        server_session = rep.sessions[session._session_id]
    return server_session, session


class TestCheckpointRoundTrip:
    """encode -> decode -> re-encode over REAL session state must be
    lossless and byte-stable; the restored session must be
    indistinguishable from the one that was exported."""

    @pytest.mark.parametrize("seed", [3, 11, 29])
    def test_fuzzer_corpus_sessions_round_trip(self, fleet_one, seed):
        address, rep = fleet_one
        rng = random.Random(seed)
        pods = gen_pods(rng, gen_nodepools(rng))[:24]
        live, _ = _live_session(address, rep, f"fuzz-{seed}", pods,
                                seed=seed)
        with live.lock:
            data = srv.export_session_checkpoint(live)
        st = codec.decode_session_checkpoint(data)
        assert st["session"] == live.id
        assert st["tenant"] == live.tenant
        assert st["templates"] == live.template_list
        assert st["rows"] == [(int(t), float(ts)) for t, ts in live.rows]
        assert st["state_revs"] == live.state_tokens
        assert st["ds_token"] == live.ds_token
        assert st["cluster_token"] == live.cluster_token
        assert st["last_req_seq"] == live.last_req_seq
        assert st["digest"] == live.last_digest
        assert st["counters"]["solves"] == live.solves
        assert st["responses"] == list(live.response_cache.items())

    def test_restore_rebuilds_an_equivalent_session(self, fleet_one):
        address, rep = fleet_one
        live, _ = _live_session(address, rep, "restore-me",
                                make_pods(8, cpu="250m"))
        with live.lock:
            data = srv.export_session_checkpoint(live)
        restored = srv.restore_session_checkpoint(data)
        assert restored.id == live.id
        assert restored.tenant == live.tenant
        assert restored.last_digest == live.last_digest
        assert restored.last_req_seq == live.last_req_seq
        assert restored.template_list == live.template_list
        assert restored.tmpl_digest == live.tmpl_digest
        assert restored.state_tokens == live.state_tokens
        assert list(restored.response_cache) == list(live.response_cache)
        assert restored.solves == live.solves
        # a restored session re-exports BYTE-IDENTICAL: the checkpoint is
        # a fixed point, so a session can migrate replica-to-replica any
        # number of times without drift
        with restored.lock:
            again = srv.export_session_checkpoint(restored)
        assert again == data

    def test_empty_session_round_trips(self):
        """A session that never solved still checkpoints (rows/templates/
        responses empty) — and with no bootstrap payload captured, the
        export re-serializes the CreateSession request itself."""
        live = srv._Session("empty-1", [make_nodepool()],
                            {"default": construct_instance_types()[:8]},
                            tenant="empty")
        with live.lock:
            data = srv.export_session_checkpoint(live)
        st = codec.decode_session_checkpoint(data)
        assert st["rows"] == [] and st["templates"] == []
        assert st["responses"] == [] and st["tenant"] == "empty"
        restored = srv.restore_session_checkpoint(data)
        assert restored.id == live.id and restored.rows == []
        assert restored.tenant == "empty"

    def test_drain_exports_every_session_to_the_handoff(self):
        """server.drain() with a handoff store attached checkpoints every
        live session — the migration a rolling restart rides on."""
        rep = srv.Replica(name="ckpt-drain", handoff=srv.HandoffStore())
        with sidecar_server(PORT, replica=rep) as (server, address):
            live, _ = _live_session(address, rep, "drainee",
                                    make_pods(6, cpu="500m"))
            sid, digest = live.id, live.last_digest
            server.drain(grace=2.0)
            data = rep.handoff.get(sid)
            assert data is not None and rep.handoff.puts >= 1
            assert srv.restore_session_checkpoint(data).last_digest == digest


# -- the loud-reject matrix ---------------------------------------------------


def _synthetic_checkpoint(seed=7):
    """A valid checkpoint frame built WITHOUT a server: the offline
    session assembles a fuzzer-corpus delta, the codec mirror applies it,
    and the mirror state becomes the session-state dict."""
    rng = random.Random(seed)
    pools = gen_nodepools(rng)
    pods = gen_pods(rng, pools)[:16]
    sess = SolverSession("127.0.0.1:1")
    sess._session_id = "offline"
    header, blobs, commit, _ = sess._delta_request(pods, [], [], None, None,
                                                   False)
    commit()
    template_list = [d for _tid, d in header.get("templates_new", ())]
    template_keys = [codec.template_content_key(d) for d in template_list]
    rows = codec.apply_pod_delta([], header, blobs)
    state_revs = {"n1": "3", "n2": "7"}
    digest = codec.batch_digest(
        [r[0] for r in rows], [r[1] for r in rows],
        codec.templates_digest(template_keys), state_revs, "ds9", "c4")
    st = {
        "session": "synthetic-1",
        "tenant": "acme",
        "bootstrap": b"opaque bootstrap payload bytes",
        "templates": template_list,
        "rows": rows,
        "state_nodes": [{"name": "n1"}, {"name": "n2"}],
        "state_revs": state_revs,
        "daemonset": [],
        "ds_token": "ds9",
        "cluster": None,
        "cluster_token": "c4",
        "topo_revision": 4,
        "last_req_seq": 9,
        "responses": [("a" * 16, b"first response"),
                      ("b" * 16, b""),
                      ("c" * 16, b"third")],
        "counters": {"solves": 5, "resyncs": 0, "dedup_hits": 2},
        "digest": digest,
    }
    return codec.encode_session_checkpoint(st), st


def _mutate(data, header_fn=None, blob_fn=None):
    header, blobs = wire.unpack(data)
    blobs = {k: bytes(v) for k, v in blobs.items()}
    if header_fn is not None:
        header_fn(header)
    if blob_fn is not None:
        blob_fn(blobs)
    return wire.pack(header, blobs)


class TestCheckpointRejects:
    """Every malformed frame refuses LOUDLY — a checkpoint that cannot be
    proven whole must never become a live session."""

    def test_synthetic_frame_decodes_clean(self):
        data, st = _synthetic_checkpoint()
        out = codec.decode_session_checkpoint(data)
        assert out["digest"] == st["digest"]
        assert out["rows"] == st["rows"]
        assert out["responses"] == st["responses"]
        assert out["bootstrap"] == st["bootstrap"]
        assert out["counters"] == st["counters"]

    def test_garbage_rejects(self):
        with pytest.raises(ValueError):
            codec.decode_session_checkpoint(b"not a frame at all")

    @pytest.mark.parametrize("cut", [1, 7, 64])
    def test_truncated_frame_rejects(self, cut):
        data, _ = _synthetic_checkpoint()
        with pytest.raises(ValueError):
            codec.decode_session_checkpoint(data[:-cut])

    def test_wrong_message_kind_rejects(self):
        data, _ = _synthetic_checkpoint()
        bad = _mutate(data, lambda h: h.update(kind="delta_solve"))
        with pytest.raises(ValueError, match="not a session checkpoint"):
            codec.decode_session_checkpoint(bad)

    def test_unknown_checkpoint_version_rejects(self):
        """The v1-downgrade skew vector: a frame from a NEWER replica
        (ckpt=2) reaching a v1 reader mid-roll must refuse, not misparse
        half-understood session state."""
        data, _ = _synthetic_checkpoint()
        bad = _mutate(data, lambda h: h.update(ckpt=2))
        with pytest.raises(codec.CheckpointVersionError,
                           match="roll every sidecar replica"):
            codec.decode_session_checkpoint(bad)

    def test_missing_checkpoint_version_rejects(self):
        data, _ = _synthetic_checkpoint()
        bad = _mutate(data, lambda h: h.pop("ckpt"))
        with pytest.raises(codec.CheckpointVersionError):
            codec.decode_session_checkpoint(bad)

    def test_delta_wire_skew_rejects(self):
        """A checkpoint whose MIRRORS speak a newer delta schema cannot be
        restored onto this replica — reject at restore, not on every
        subsequent solve."""
        data, _ = _synthetic_checkpoint()
        bad = _mutate(data,
                      lambda h: h.update(v=codec.DELTA_SCHEMA_VERSION + 1))
        with pytest.raises(codec.DeltaVersionError):
            codec.decode_session_checkpoint(bad)

    @pytest.mark.parametrize("field", ["session", "templates", "state_revs",
                                       "ds_token", "last_req_seq", "digest"])
    def test_stripped_header_field_rejects(self, field):
        data, _ = _synthetic_checkpoint()
        bad = _mutate(data, lambda h: h.pop(field))
        with pytest.raises(ValueError, match="missing field"):
            codec.decode_session_checkpoint(bad)

    @pytest.mark.parametrize("blob", ["row_tid", "row_ts", "bootstrap"])
    def test_stripped_blob_rejects(self, blob):
        data, _ = _synthetic_checkpoint()
        bad = _mutate(data, blob_fn=lambda b: b.pop(blob))
        with pytest.raises(ValueError, match="missing blob"):
            codec.decode_session_checkpoint(bad)

    def test_row_column_disagreement_rejects(self):
        data, _ = _synthetic_checkpoint()
        bad = _mutate(data, blob_fn=lambda b: b.update(
            row_ts=b["row_ts"][:-8]))
        with pytest.raises(ValueError, match="row columns disagree"):
            codec.decode_session_checkpoint(bad)

    def test_row_template_reference_out_of_range_rejects(self):
        data, st = _synthetic_checkpoint()
        n = len(st["templates"])
        bad = _mutate(data, blob_fn=lambda b: b.update(
            row_tid=wire.pack_u32([n + 3] + [r[0] for r in st["rows"][1:]])))
        with pytest.raises(ValueError, match="references template"):
            codec.decode_session_checkpoint(bad)

    def test_response_cache_blob_length_mismatch_rejects(self):
        data, _ = _synthetic_checkpoint()
        bad = _mutate(data, blob_fn=lambda b: b.update(
            responses=b["responses"] + b"trailing junk"))
        with pytest.raises(ValueError, match="length mismatch"):
            codec.decode_session_checkpoint(bad)

    def test_corrupt_digest_rejects(self):
        data, _ = _synthetic_checkpoint()
        bad = _mutate(data, lambda h: h.update(digest="deadbeef" * 8))
        with pytest.raises(codec.DigestMismatchError,
                           match="refusing to resurrect"):
            codec.decode_session_checkpoint(bad)

    def test_tampered_state_rev_flips_the_digest_check(self):
        """The digest covers the revision tokens: silently rewinding one
        node's revision inside the frame is caught, not restored."""
        data, _ = _synthetic_checkpoint()
        bad = _mutate(data, lambda h: h["state_revs"].update(n1="999"))
        with pytest.raises(codec.DigestMismatchError):
            codec.decode_session_checkpoint(bad)

    def test_empty_frame_digest_is_recomputed(self):
        """A frame with no digest field VALUE (legacy empty string) still
        decodes — the restored digest is recomputed from the parts, so the
        handshake on the next solve stays sound."""
        data, st = _synthetic_checkpoint()
        tolerated = _mutate(data, lambda h: h.update(digest=""))
        out = codec.decode_session_checkpoint(tolerated)
        assert out["digest"] == st["digest"]


# -- $KARPENTER_SIDECAR_MAX_SESSIONS ------------------------------------------


class TestMaxSessionsEnv:
    """The session-table bound is configurable and a typo fails LOUDLY at
    boot — the KARPENTER_LOO_MIN_CANDIDATES contract."""

    def test_default_without_env(self, monkeypatch):
        monkeypatch.delenv("KARPENTER_SIDECAR_MAX_SESSIONS", raising=False)
        assert srv._max_sessions_from_env() == 8

    def test_env_overrides(self, monkeypatch):
        monkeypatch.setenv("KARPENTER_SIDECAR_MAX_SESSIONS", "17")
        assert srv._max_sessions_from_env() == 17

    def test_replica_reads_the_env(self, monkeypatch):
        monkeypatch.setenv("KARPENTER_SIDECAR_MAX_SESSIONS", "3")
        assert srv.Replica(name="env-read").max_sessions == 3

    @pytest.mark.parametrize("bad", ["0", "-3", "abc", "8.5", ""])
    def test_invalid_values_exit_loudly(self, monkeypatch, bad):
        monkeypatch.setenv("KARPENTER_SIDECAR_MAX_SESSIONS", bad)
        with pytest.raises(SystemExit) as exc:
            srv._max_sessions_from_env()
        assert "KARPENTER_SIDECAR_MAX_SESSIONS" in str(exc.value)



# -- cross-package handoff ----------------------------------------------------


def _pkg_mod(root: str, name: str):
    import importlib
    return importlib.import_module(f"{root}.{name}")


def _rounds(root: str):
    """Three solves of one session, built with ``root``'s objects: a
    cold batch over one state node, the batch churned, and churned again
    with a second node; pools named as their uids so two packages' builds
    are equal."""
    F = factories(root)
    its = _pkg_mod(root, "cloudprovider.kwok").construct_instance_types()[:32]
    pool = F.make_nodepool(name="default")
    pool.metadata.uid = "uid-default"
    n1 = F.make_state_node("hand-n1", zone="test-zone-a")
    n2 = F.make_state_node("hand-n2", zone="test-zone-b", cpu="8",
                           memory="16Gi")
    pods = [F.make_pod(name=f"h-{i}", cpu="500m") for i in range(8)]
    more = [F.make_pod(name=f"h-x{i}", cpu="750m", labels={"app": "x"})
            for i in range(4)]
    last = [F.make_pod(name=f"h-y{i}", cpu="250m") for i in range(3)]
    return pool, its, [(pods, [n1]), (pods[2:] + more, [n1]),
                       (pods[2:] + more[:2] + last, [n1, n2])]


def _solve(client, session, pool, its, batch, nodes):
    r = client.RemoteScheduler(session.address, [pool], {"default": its},
                               state_nodes=nodes, session=session
                               ).solve(batch)
    digest = _pkg_mod(session.__module__.split(".")[0],
                      "flightrec.record").decision_digest(
        r, batch, r.fallback_reason, tuple(r.partition))
    return r, digest


@pytest.mark.parametrize("src,dst", [(JAX, PORT), (PORT, JAX)])
def test_checkpoint_restores_across_packages_without_resync(
        src, dst, monkeypatch):
    """Two solves on a ``src`` replica, its last checkpoint handed to a
    ``dst`` replica, the client re-aimed there: the third (delta) solve
    restores the session from the other package's frame, passes the state
    digest handshake and gives the decision digest of the third solve of a
    session that stayed on ``src``: no resync on either side."""
    client = _pkg_mod(src, "sidecar.client")
    src_srv, dst_srv = _pkg_mod(src, "sidecar.server"), \
        _pkg_mod(dst, "sidecar.server")
    src_rep = src_srv.Replica(name=f"x-{src}", handoff=src_srv.HandoffStore())
    dst_rep = dst_srv.Replica(name=f"x-{dst}", handoff=dst_srv.HandoffStore())
    with sidecar_server(src, replica=src_rep) as (_, src_addr), \
            sidecar_server(dst, replica=dst_rep) as (_, dst_addr):
        reset_claim_names(monkeypatch)
        pool, its, rounds = _rounds(src)
        stay = client.SolverSession(src_addr, tenant="stay")
        for batch, nodes in rounds[:2]:
            _solve(client, stay, pool, its, batch, nodes)
        _, want = _solve(client, stay, pool, its, *rounds[2])
        stay.close()

        reset_claim_names(monkeypatch)
        pool, its, rounds = _rounds(src)
        moved = client.SolverSession(src_addr, tenant="moved")
        for batch, nodes in rounds[:2]:
            _solve(client, moved, pool, its, batch, nodes)
        sid = moved._session_id
        frame = src_rep.handoff.get(sid)
        assert frame is not None, "no post-solve checkpoint"
        dst_rep.handoff.put(sid, frame)
        moved._switch_address(dst_addr)
        r, got = _solve(client, moved, pool, its, *rounds[2])
        assert dst_rep.handoff.restores == 1, "the session was not restored"
        restored = dst_rep.sessions[sid]
        assert got == want
        assert moved.resyncs == 0 and moved.catchups == 0
        assert restored.resyncs == 0 and restored.solves == 3
        # the frame carries no ProblemState: the restoring replica encodes
        # the restored rows afresh
        assert r.encode_kind == "cold"
        moved.close()
