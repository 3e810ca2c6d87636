"""The port's flight recorder (karpenter_tpu_torch.flightrec), on the CPU,
against the JAX package's: one record format shared by the two packages
(schema version, JSON keys, decision digest), so a solve recorded by
either package replays on the other to the same verdicts; and the cases of
tests/test_flightrec.py on the port — codec round trip, schema versioning,
the ring, the provisioner's and the disruption controller's hooks, the
CLI, the deferred encode. The port's solves and replays run with
``device="cpu"`` (the kernels' plain versions)."""

import json
import random

import pytest

from karpenter_tpu.flightrec import FlightRecorder as JFlightRecorder
from karpenter_tpu.flightrec import replay_record as jreplay_record
from karpenter_tpu.flightrec.record import loads_record as jloads_record
from karpenter_tpu_torch.flightrec import (SCHEMA_VERSION, FlightRecorder,
                                           TraceVersionError, loads_record,
                                           replay_record, replay_trace)
from karpenter_tpu_torch.flightrec.record import (decode_solve_payload,
                                                  encode_solve_payload,
                                                  load_trace)
from karpenter_tpu_torch.metrics.registry import (FLIGHTREC_DROPPED,
                                                  FLIGHTREC_RECORDS)
from karpenter_tpu_torch.utils.clock import FakeClock

import test_torch_support as support
from test_torch_support import JAX, PORT, ROOTS, LiveEnv, nodepool, pod
from test_torch_support import device_series_kept  # noqa: F401 (autouse)
from test_torch_solve_parity import fuzz_case

#: the fuzzer seeds tests/test_flightrec.py records and replays
SEEDS = (1000, 1004, 1011, 1019, 1027, 1033)


def _norm(d):
    return json.loads(json.dumps(d))


def record_solve(root: str, seed: int, recorder=None):
    """One solve of the fuzzer's seed in ``root``'s package, captured by a
    recorder of the same package; returns (recorder, scheduler, pods)."""
    pools, its, pods = fuzz_case(seed, root)
    rec = recorder if recorder is not None else (
        FlightRecorder if root == PORT else JFlightRecorder)(capacity=8)
    ts = support.scheduler(root, pools, its)
    ts.flight_recorder = rec
    ts.solve(pods)
    return rec, ts, pods


def replay(root: str, line: str):
    """A record's JSONL line replayed by ``root``'s package."""
    if root == PORT:
        return replay_record(loads_record(line), device="cpu")
    return jreplay_record(jloads_record(line))


# -- across the packages -----------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("made_by", ROOTS)
def test_records_replay_on_the_other_package(made_by, seed):
    """A JAX record replays on the port, a port record on the JAX package:
    byte-identical to the recorded digest, tensor/host parity held."""
    rec, _, _ = record_solve(made_by, seed)
    other = PORT if made_by == JAX else JAX
    report = replay(other, rec.lines()[-1])
    assert report.deterministic is True, report.render()
    assert report.parity is True, report.render()


def _named_uids(obj, names: dict):
    """``obj`` with every object uid (drawn per process) replaced by the
    object's name."""
    if isinstance(obj, dict):
        return {k: _named_uids(v, names) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_named_uids(v, names) for v in obj]
    return names.get(obj, obj) if isinstance(obj, str) else obj


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_the_two_packages_record_the_same_payloads(seed):
    """One solve recorded by each package: the same schema version and
    kind, and the `solve` and `decision` payloads equal key for key (the
    objects' uids, drawn per process, read as the objects' names)."""
    lines = {}
    for root in ROOTS:
        rec, ts, pods = record_solve(root, seed)
        names = {o.metadata.uid: f"uid:{o.metadata.name}"
                 for o in list(pods) + list(ts.nodepools)}
        lines[root] = _named_uids(json.loads(rec.lines()[-1]), names)
    jax_rec, port_rec = lines[JAX], lines[PORT]
    assert set(port_rec) == set(jax_rec)
    assert (port_rec["v"], port_rec["kind"]) == (jax_rec["v"],
                                                 jax_rec["kind"])
    for part in ("solve", "decision"):
        assert set(port_rec[part]) == set(jax_rec[part]), part
        for key in jax_rec[part]:
            assert port_rec[part][key] == jax_rec[part][key], (part, key)
    assert set(port_rec["meta"]) == set(jax_rec["meta"])


@pytest.mark.parametrize("made_by", ROOTS)
def test_disruption_records_replay_on_the_other_package(made_by):
    """A consolidation decision over twelve underutilized nodes, recorded by
    either package's DisruptionController, replays on the other."""
    env = support.underutilized_fleet(made_by, 12)
    rec = (FlightRecorder if made_by == PORT else JFlightRecorder)(
        capacity=4, clock=env.clock)
    env.disruption.flight_recorder = rec
    env.disruption.reconcile()
    assert len(rec) == 1 and rec.records()[-1].kind == "disruption"
    report = replay(PORT if made_by == JAX else JAX, rec.lines()[-1])
    assert report.deterministic is True, report.render()
    assert report.parity is True, report.render()


# -- codec round trip --------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_record_roundtrip_and_replay(seed):
    rec, _, _ = record_solve(PORT, seed)
    loaded = loads_record(rec.lines()[-1])
    assert loaded["v"] == SCHEMA_VERSION
    assert loaded["kind"] == "provisioning"
    # decode -> re-encode is byte-identical (JSON-normalized): the wire
    # codec loses nothing the solver reads
    payload = loaded["solve"]
    nodepools, its, pods, sns, daemons, _cv = decode_solve_payload(payload)
    re_encoded = encode_solve_payload(nodepools, its, pods, state_nodes=sns,
                                      daemonset_pods=daemons)
    for key in ("nodepools", "catalog", "pool_instance_types", "pods",
                "state_nodes", "daemonset_pods"):
        assert _norm(re_encoded[key]) == _norm(payload[key]), key
    report = replay_record(loaded, device="cpu")
    assert report.deterministic is True, report.render()
    assert report.parity is True, report.render()


def test_unknown_schema_version_is_rejected():
    rec, _, _ = record_solve(PORT, 1002)
    d = json.loads(rec.lines()[-1])
    d["v"] = SCHEMA_VERSION + 1
    with pytest.raises(TraceVersionError) as exc:
        loads_record(json.dumps(d))
    assert f"v{SCHEMA_VERSION + 1}" in str(exc.value)
    with pytest.raises(TraceVersionError):
        loads_record(json.dumps({"kind": "provisioning"}))  # v missing


def test_replay_runs_on_the_card_unless_asked():
    """The default device is the card: without one, replay raises instead
    of falling back to the CPU."""
    import torch
    rec, _, _ = record_solve(PORT, 1000)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default replay runs")
    with pytest.raises(Exception, match="CUDA|cuda"):
        replay_record(loads_record(rec.lines()[-1]))


# -- the ring ----------------------------------------------------------------

def test_ring_is_bounded_and_counts_drops():
    records0 = sum(FLIGHTREC_RECORDS.value({"kind": k})
                   for k in ("provisioning", "disruption"))
    evicted0 = FLIGHTREC_DROPPED.value({"reason": "evicted"})
    rec = FlightRecorder(capacity=2)
    for seed in (1000, 1001, 1002):
        record_solve(PORT, seed, recorder=rec)
    assert len(rec) == 2
    records1 = sum(FLIGHTREC_RECORDS.value({"kind": k})
                   for k in ("provisioning", "disruption"))
    assert records1 - records0 == 3
    assert FLIGHTREC_DROPPED.value({"reason": "evicted"}) - evicted0 == 1
    # the survivors are the two NEWEST captures, oldest-first eviction
    assert [r.meta["pods"] for r in rec.records()] == \
        [len(fuzz_case(seed, PORT)[2]) for seed in (1001, 1002)]


def test_capture_failure_never_raises():
    dropped0 = FLIGHTREC_DROPPED.value({"reason": "capture_error"})
    rec = FlightRecorder(capacity=2)
    rec.capture_provisioning(object(), [], object(), 0.0)  # not a scheduler
    assert FLIGHTREC_DROPPED.value({"reason": "capture_error"}) == dropped0 + 1
    assert len(rec) == 0


# -- hooks -------------------------------------------------------------------

def test_provisioner_reconcile_records_the_solve():
    its = support.pkg(PORT).kwok.construct_instance_types()
    env = LiveEnv(PORT, its, pools=[nodepool(PORT)])
    rec = FlightRecorder(capacity=4)
    env.provisioner.flight_recorder = rec
    env.pending("p-0", cpu="500m")
    env.provision()
    assert len(rec) == 1
    r = rec.records()[-1]
    assert r.kind == "provisioning"
    assert r.meta["pods"] == 1
    assert r.meta["claims"] == 1
    report = replay_record(loads_record(rec.lines()[-1]), device="cpu")
    assert report.deterministic is True and report.parity is True, \
        report.render()


def test_provisioner_takes_the_recorder_at_construction():
    """Provisioner(flight_recorder=) as the operator wires it; a disruption
    simulation probe (schedule_with(record=False)) records nothing."""
    k = support.live_pkg(PORT)
    env = LiveEnv(PORT, support.pkg(PORT).kwok.construct_instance_types(),
                  pools=[nodepool(PORT)])
    rec = FlightRecorder(capacity=4)
    prov = k.provisioner.Provisioner(env.store, env.cluster, env.provider,
                                     env.clock, flight_recorder=rec,
                                     device="cpu")
    assert prov.flight_recorder is rec
    prov.schedule_with([pod(PORT, "probe")], [], record=False)
    assert len(rec) == 0


def test_disruption_pass_records_the_decision():
    env = support.underutilized_fleet(PORT, 12)
    rec = FlightRecorder(capacity=4, clock=env.clock)
    ctrl = env.lv.controller.DisruptionController(
        env.store, env.cluster, env.provisioner, env.queue, env.clock,
        flight_recorder=rec)
    ctrl.reconcile()
    assert len(rec) == 1
    r = rec.records()[-1]
    assert r.kind == "disruption"
    cmd = r.meta["command"]
    assert cmd["decision"] in ("delete", "replace")
    assert cmd["candidates"]
    assert len(r.meta["rejections"]) == 12 - len(cmd["candidates"])
    report = replay_record(loads_record(rec.lines()[-1]), device="cpu")
    assert report.deterministic is True, report.render()
    assert report.parity is True, report.render()


def test_replace_decision_replays_deterministically():
    """One underutilized node: its pod has nowhere to go, so the decision
    is a replacement launch, whose recorded instance-type signatures the
    consolidation post-processed after the solve; the replay judges the
    solver-level decision."""
    env = support.underutilized_fleet(PORT, 1)
    rec = FlightRecorder(capacity=4, clock=env.clock)
    env.disruption.flight_recorder = rec
    env.disruption.reconcile()
    assert len(rec) == 1
    r = rec.records()[-1]
    assert r.meta["command"]["decision"] == "replace"
    assert r.meta["command"]["replacements"]
    report = replay_record(loads_record(rec.lines()[-1]), device="cpu")
    assert report.deterministic is True, report.render()
    assert report.parity is True, report.render()


# -- CLI ---------------------------------------------------------------------

def test_cli_replay_smoke(tmp_path, capsys):
    from karpenter_tpu_torch.flightrec.__main__ import main
    rec, _, _ = record_solve(PORT, 1005)
    path = str(tmp_path / "trace.jsonl")
    assert rec.dump(path) == 1
    assert main(["show", path]) == 0
    assert "1 records" in capsys.readouterr().out
    assert main(["replay", path, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "deterministic=ok" in out and "parity=ok" in out
    assert "0 verdict failures" in out
    reports = replay_trace(path, device="cpu")
    assert len(reports) == 1 and reports[0].ok


def test_cli_replays_a_jax_trace(tmp_path, capsys):
    """`python -m karpenter_tpu_torch.flightrec replay` on a trace the JAX
    package dumped."""
    from karpenter_tpu_torch.flightrec.__main__ import main
    rec, _, _ = record_solve(JAX, 1011)
    path = str(tmp_path / "jax.jsonl")
    assert rec.dump(path) == 1
    assert main(["replay", path, "--device", "cpu"]) == 0
    assert "0 verdict failures" in capsys.readouterr().out


def test_cli_replay_delta_record_byte_identical(tmp_path, capsys):
    """A record of a solve encoded through a persistent ProblemState (a
    delta encode) replays byte-identically: replay always rebuilds the
    problem cold."""
    from karpenter_tpu_torch.flightrec.__main__ import main
    from karpenter_tpu_torch.provisioning.problem_state import ProblemState
    pools, its, pods = fuzz_case(2026, PORT)
    ps = ProblemState()
    support.scheduler(PORT, pools, its, problem_state=ps).solve(pods)
    rec = FlightRecorder(capacity=4)
    ts2 = support.scheduler(PORT, pools, its, problem_state=ps)
    ts2.flight_recorder = rec
    ts2.solve(pods)
    assert ts2.encode_kind == "delta", ts2.fallback_reason
    assert loads_record(rec.lines()[-1])["meta"]["encode_kind"] == "delta"
    path = str(tmp_path / "delta.jsonl")
    assert rec.dump(path) == 1
    assert main(["replay", path, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "deterministic=ok" in out and "0 verdict failures" in out


def test_cli_rejects_future_schema(tmp_path, capsys):
    from karpenter_tpu_torch.flightrec.__main__ import main
    path = str(tmp_path / "future.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"v": 99, "kind": "provisioning"}) + "\n")
    assert main(["replay", path, "--device", "cpu"]) == 2
    assert "v99" in capsys.readouterr().err


def test_load_trace_names_the_bad_line(tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text(json.dumps({"v": SCHEMA_VERSION, "kind": "x"})
                    + "\n\nnot json\n")
    with pytest.raises(ValueError, match="bad.jsonl:3"):
        load_trace(str(path))


# -- the deferred encode -----------------------------------------------------

def test_deferred_encode_filters_bound_batch_from_cluster_view():
    """A deferred materialize sees the LIVE cluster view — including the
    solve's own pods after the provisioner binds them. The encode drops
    them (they were pending at solve time)."""
    o = support.pkg(PORT).objects
    L = support.pkg(PORT).labels
    spread = [o.TopologySpreadConstraint(
        topology_key=L.LABEL_TOPOLOGY_ZONE, max_skew=1,
        label_selector=o.LabelSelector(match_labels={"app": "cv"}))]
    pods = [pod(PORT, f"cv-{i}", labels={"app": "cv"}, spread=spread)
            for i in range(2)]
    bystander = pod(PORT, "cv-other", labels={"app": "cv"})
    bystander.spec.node_name = "node-a"
    for p in pods:
        p.spec.node_name = "node-a"  # bound AFTER the solve, pre-dump

    class LiveView:
        def list_pods(self, namespace, selector):
            return [p for p in pods + [bystander]
                    if selector.matches(p.labels)]

        def node_labels(self, node_name):
            return {L.LABEL_TOPOLOGY_ZONE: "test-zone-a"}

        def for_pods_with_anti_affinity(self):
            return iter(())

    payload = encode_solve_payload([nodepool(PORT)], {"default": []}, pods,
                                   cluster=LiveView())
    uids = {p["uid"] for p in payload["cluster"]["pods"]}
    assert bystander.uid in uids
    assert not ({p.uid for p in pods} & uids)


def test_state_node_host_ports_roundtrip():
    from karpenter_tpu_torch.sidecar.codec import (WireStateNode,
                                                   state_node_to_dict)
    d = {"name": "n1", "labels": {}, "taints": [], "allocatable": {},
         "capacity": {}, "pod_requests": {}, "daemonset_requests": {},
         "initialized": True, "managed": False,
         "host_ports": [["uid-1", "0.0.0.0", 8080, "TCP"]]}
    sn = WireStateNode(d)
    assert sn.host_port_usage().conflicts_triples([("0.0.0.0", 8080, "TCP")])
    assert not sn.host_port_usage().conflicts_triples(
        [("0.0.0.0", 9090, "TCP")])
    assert sn.managed() is False
    d2 = state_node_to_dict(sn)
    assert d2["host_ports"] == [["uid-1", "0.0.0.0", 8080, "TCP"]]
    assert d2["managed"] is False


def test_condition_default_timestamp_follows_injected_clock():
    from karpenter_tpu_torch.api import nodeclaim as nc_api
    prev = nc_api.set_condition_clock(FakeClock(42.0))
    try:
        cs = nc_api.ConditionSet()
        cs.set_true("Launched", reason="Test")  # no explicit now
        assert cs.get("Launched").last_transition_time == 42.0
    finally:
        nc_api.set_condition_clock(prev)


def test_codec_is_the_reference_codec():
    """The port's copies of the wire codec and framing are the JAX
    package's, line for line past their docstrings, but for the one scan
    per distinct selector in cluster_view_to_dict (held equal to the
    reference's output below): the shared record format rests on them."""
    import inspect

    import karpenter_tpu.sidecar.codec as jcodec
    import karpenter_tpu.sidecar.wire as jwire
    import karpenter_tpu_torch.sidecar.codec as tcodec
    import karpenter_tpu_torch.sidecar.wire as twire

    def body(mod):
        src = inspect.getsource(mod)
        return src[src.index('"""', 3) + 3:]

    def without_view(mod):
        src = body(mod)
        fn = inspect.getsource(mod.cluster_view_to_dict)
        assert src.count(fn) == 1
        return src.replace(fn, "")
    assert without_view(tcodec) == without_view(jcodec)
    assert body(twire) == body(jwire)


def test_cluster_view_encodes_as_the_reference_does():
    """cluster_view_to_dict over a live store: the port's (one scan per
    distinct selector) and the reference's (one a pod) give the same
    snapshot, in the same order, for the benchmark mix's spreads and
    affinities with bound pods of their own workloads beside them."""
    from karpenter_tpu.sidecar.codec import cluster_view_to_dict as jview
    from karpenter_tpu_torch.sidecar.codec import cluster_view_to_dict as tview
    got = {}
    for root in ROOTS:
        env = LiveEnv(root, [], pools=[nodepool(root)])
        env.node("n-0", "it-a")
        pods = support.bench_pods(root, 180, 18)
        for i, p in enumerate(pods[::4]):
            env.bind("n-0", f"bound-{i}", labels=dict(p.metadata.labels))
        view = env.lv.provisioner.StateClusterView(env.store, env.cluster)
        d = (tview if root == PORT else jview)(view, pods)
        names = {p.metadata.uid: p.metadata.name
                 for p in env.store.list(env.k.objects.Pod)}
        got[root] = _named_uids(d, names)
    assert got[PORT] == got[JAX]
    # the bound pods of the 14 workloads whose selectors select their own
    assert len(got[PORT]["pods"]) == 35
