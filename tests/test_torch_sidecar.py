"""tests/test_sidecar.py pointed at the port: codec round-trip, remote
solve parity, the operator loop over the gRPC backend — the port's sidecar
server solving on the CPU (``device="cpu"``: the kernels' plain PyTorch
versions). Then the cross-package matrix: each package's client against
each package's server over a seeded batch fuzzer, every pair giving the
JAX package's in-process decisions and the same response frames."""

import random

import pytest

from karpenter_tpu_torch.api import labels as api_labels
from karpenter_tpu_torch.api.objects import Node, Pod
from karpenter_tpu_torch.cloudprovider.kwok import construct_instance_types
from karpenter_tpu_torch.operator.operator import Operator
from karpenter_tpu_torch.operator.options import Options
from karpenter_tpu_torch.provisioning.tensor_scheduler import TensorScheduler
from karpenter_tpu_torch.sidecar import codec
from karpenter_tpu_torch.sidecar.client import RemoteScheduler
from karpenter_tpu_torch.utils.clock import FakeClock

from test_torch_support import (JAX, PORT, ROOTS, factories, keep_responses,
                                pkg, reset_claim_names, response_content,
                                sidecar_server)
from test_torch_support import device_series_kept  # noqa: F401 (autouse)
from test_torch_support import sidecar_state_kept  # noqa: F401 (autouse)
from test_torch_support import tracer_kept  # noqa: F401 (autouse)

affinity_term = factories(PORT).affinity_term
make_nodepool = factories(PORT).make_nodepool
make_pod = factories(PORT).make_pod
make_pods = factories(PORT).make_pods
spread_zone = factories(PORT).spread_zone


def cpu_scheduler(*args, **kw):
    """The port's in-process TensorScheduler on the CPU."""
    return TensorScheduler(*args, device="cpu", **kw)


@pytest.fixture(scope="module")
def sidecar():
    with sidecar_server(PORT) as (_, address):
        yield address


class TestCodec:
    def test_pod_round_trip(self):
        pod = make_pod(cpu="500m", memory="1Gi", labels={"app": "x"},
                       node_selector={"zone": "a"},
                       spread=[spread_zone(key="app", value="x")],
                       pod_anti_affinity=[
                           affinity_term(api_labels.LABEL_HOSTNAME,
                                         key="app", value="x")])
        d = codec.pod_to_dict(pod)
        back = codec.pod_from_dict(d)
        assert back.uid == pod.uid
        assert back.requests() == pod.requests()
        assert back.spec.node_selector == pod.spec.node_selector
        assert len(back.spec.topology_spread_constraints) == 1
        assert back.spec.affinity.pod_anti_affinity.required[0].topology_key \
            == api_labels.LABEL_HOSTNAME
        assert codec.pod_to_dict(back) == d

    def test_pod_batch_dedup_round_trip(self):
        """encode_pod_batch collapses deployment-stamped pods to one
        template and rebuilds them with SHARED spec sub-objects, so the
        server-side grouping signature bucketing stays O(1) per pod."""
        spread = [spread_zone(key="app", value="d0")]
        a = [make_pod(cpu="500m", labels={"app": "d0"}, spread=spread,
                      name=f"a-{i}") for i in range(5)]
        b = [make_pod(cpu="250m", labels={"app": "d1"}, name=f"b-{i}")
             for i in range(3)]
        wire = codec.encode_pod_batch(a + b)
        assert len(wire["templates"]) == 2
        assert len(wire["rows"]) == 8
        back = codec.decode_pod_batch(wire)
        assert [p.name for p in back] == [p.name for p in a + b]
        assert [p.uid for p in back] == [p.uid for p in a + b]
        assert back[0].requests() == a[0].requests()
        assert len(back[0].spec.topology_spread_constraints) == 1
        # same-template pods share spec sub-objects after decode
        assert back[0].spec.topology_spread_constraints[0] is \
            back[1].spec.topology_spread_constraints[0]
        assert back[5].spec.affinity is back[6].spec.affinity
        # distinct host ports force distinct templates (conflict tracking)
        from karpenter_tpu_torch.api.objects import HostPort
        ported = [make_pod(cpu="100m", host_ports=[HostPort(port=9000 + i)])
                  for i in range(2)]
        wire2 = codec.encode_pod_batch(ported)
        assert len(wire2["templates"]) == 2
        # volumes survive the batch path and key the templates: dropping
        # them server-side would bypass CSI attach-limit tracking entirely
        from karpenter_tpu_torch.api.objects import PVCRef
        vol = make_pod(cpu="100m")
        vol.spec.volumes.append(PVCRef(claim_name="data"))
        plain = make_pod(cpu="100m")
        wire3 = codec.encode_pod_batch([vol, plain])
        assert len(wire3["templates"]) == 2
        back3 = codec.decode_pod_batch(wire3)
        assert back3[0].spec.volumes[0].claim_name == "data"
        assert not back3[1].spec.volumes

    def test_relax_after_decode_does_not_strip_siblings(self):
        """decode_pod_batch rebuilds pods of one template with SHARED
        affinity/spread objects; the host-fallback relaxation ladder pops
        terms in place. Relaxing one pod must not narrow its siblings'
        constraints (ADVICE r3: shared-mutable wire decode vs
        preferences.go:38-57 semantics)."""
        from karpenter_tpu_torch.api.objects import SCHEDULE_ANYWAY, NodeSelectorRequirement
        from karpenter_tpu_torch.provisioning.preferences import Preferences
        spread_zone = factories(PORT).spread_zone

        term = [NodeSelectorRequirement(api_labels.LABEL_TOPOLOGY_ZONE,
                                        "In", ("test-zone-a",))]
        tsc = spread_zone(key="app", value="d0")
        object.__setattr__(tsc, "when_unsatisfiable", SCHEDULE_ANYWAY)
        proto = make_pod(cpu="100m", labels={"app": "d0"}, spread=[tsc],
                         preferred_affinity=[(10, term)], name="rx-0")
        # deployment stamping: siblings share the SAME spec sub-objects
        from karpenter_tpu_torch.api.objects import ObjectMeta, Pod, PodSpec
        pods = [proto] + [
            Pod(metadata=ObjectMeta(name=f"rx-{i}", namespace="default",
                                    labels=dict(proto.labels)),
                spec=PodSpec(
                    affinity=proto.spec.affinity,
                    topology_spread_constraints=
                        proto.spec.topology_spread_constraints),
                container_requests=list(proto.container_requests))
            for i in (1, 2)]
        back = codec.decode_pod_batch(codec.encode_pod_batch(pods))
        assert back[0].spec.affinity is back[1].spec.affinity  # wire sharing
        prefs = Preferences()
        assert prefs.relax(back[0])  # pops back[0]'s preferred node affinity
        assert prefs.relax(back[0])  # then its ScheduleAnyway spread
        for sibling in back[1:]:
            assert len(sibling.spec.topology_spread_constraints) == 1
            assert len(sibling.spec.affinity.node_affinity.preferred) == 1

    def test_instance_type_round_trip(self):
        it = construct_instance_types()[0]
        back = codec.instance_type_from_dict(codec.instance_type_to_dict(it))
        assert back.name == it.name
        assert back.capacity == it.capacity
        assert len(back.offerings) == len(it.offerings)
        assert back.allocatable() == it.allocatable()

    def test_nodepool_round_trip(self):
        pool = make_nodepool(name="p1", limits={"cpu": "100"}, weight=7)
        back = codec.nodepool_from_dict(codec.nodepool_to_dict(pool))
        assert back.name == "p1"
        assert back.spec.limits == pool.spec.limits
        assert back.spec.weight == 7


class TestRemoteSolve:
    def test_parity_with_local(self, sidecar):
        its = construct_instance_types()[:48]
        pool = make_nodepool(name="default")
        pods = (make_pods(10, cpu="500m", memory="256Mi")
                + make_pods(6, cpu="1000m", labels={"app": "s"},
                            spread=[spread_zone(key="app", value="s")]))
        local = cpu_scheduler([pool], {"default": its}).solve(pods)
        remote = RemoteScheduler(sidecar, [pool], {"default": its}).solve(pods)
        assert len(remote.new_nodeclaims) == len(local.new_nodeclaims)
        assert remote.pod_errors == local.pod_errors
        # per-claim pod partitions match sizes
        assert sorted(len(nc.pods) for nc in remote.new_nodeclaims) == \
            sorted(len(nc.pods) for nc in local.new_nodeclaims)
        # the emitted API claims carry instance-type requirements
        api_nc = remote.new_nodeclaims[0].to_nodeclaim()
        keys = {r.key for r in api_nc.spec.requirements}
        assert api_labels.LABEL_INSTANCE_TYPE in keys

    def test_operator_over_sidecar_backend(self, sidecar):
        op = Operator(options=Options(solver_backend="sidecar",
                                      solver_address=sidecar),
                      clock=FakeClock(), device="cpu")
        op.store.create(make_nodepool(name="default"))
        for p in make_pods(5, cpu="500m"):
            op.store.create(p)
        for _ in range(6):
            op.step()
            op.clock.step(1.1)
        op.step()
        assert all(p.spec.node_name for p in op.store.list(Pod))
        assert op.store.list(Node)


StaticClusterView = factories(PORT).StaticClusterView  # shared stub


def _scaleup_fixture():
    """A deployment scale-up: 4 replicas of app=s already running in
    test-zone-a, 8 new spread-constrained replicas pending. The solver must
    count the existing replicas (topology.go:268-321) and skew new pods
    toward the other zones."""
    its = construct_instance_types()[:48]
    pool = make_nodepool(name="default")
    existing = make_pods(4, cpu="500m", labels={"app": "s"},
                         spread=[spread_zone(key="app", value="s")])
    for i, p in enumerate(existing):
        p.spec.node_name = "existing-node-a"
        p.status.phase = "Running"
    view = StaticClusterView(existing, {
        "existing-node-a": {api_labels.LABEL_TOPOLOGY_ZONE: "test-zone-a"}})
    pending = make_pods(8, cpu="500m", labels={"app": "s"},
                        spread=[spread_zone(key="app", value="s")])
    return its, pool, view, pending


def _zones_of(results):
    zones = []
    for nc in results.new_nodeclaims:
        req = nc.requirements.get(api_labels.LABEL_TOPOLOGY_ZONE)
        zs = sorted(req.values_list())
        zones.extend(zs * len(nc.pods) if len(zs) == 1 else [])
    return sorted(zones)


class TestClusterViewOverWire:
    def test_cluster_counts_shift_the_solution(self, sidecar):
        its, pool, view, pending = _scaleup_fixture()
        with_view = cpu_scheduler([pool], {"default": its},
                                    cluster=view).solve(pending)
        assert not with_view.pod_errors
        # existing 4 pods in zone a: new 8 must backfill b/c/d first --
        # zone a receives strictly fewer new pods than the other zones' max
        zones = _zones_of(with_view)
        assert zones, "expected zonal placements"
        count_a = zones.count("test-zone-a")
        others = [zones.count(z) for z in
                  ("test-zone-b", "test-zone-c", "test-zone-d")]
        assert count_a < max(others)
        # host-oracle parity: same per-zone fill multiset (tie-break zone
        # naming may differ, as in the reference's map iteration)
        make_scheduler = factories(PORT).make_scheduler
        host = make_scheduler([pool], {"default": its}, pending, cluster=view)
        host_zones = _zones_of(host.solve(pending))
        multiset = lambda zs: sorted(
            zs.count(z) for z in set(zs))
        assert multiset(zones) == multiset(host_zones)

    def test_remote_matches_local_with_cluster_view(self, sidecar):
        its, pool, view, pending = _scaleup_fixture()
        local = cpu_scheduler([pool], {"default": its},
                                cluster=view).solve(pending)
        remote = RemoteScheduler(sidecar, [pool], {"default": its},
                                 cluster=view).solve(pending)
        assert remote.pod_errors == local.pod_errors
        assert len(remote.new_nodeclaims) == len(local.new_nodeclaims)
        # zone assignment parity: the wire snapshot must carry the counts
        local_zones = _zones_of(local)
        remote_zones = []
        for nc in remote.new_nodeclaims:
            req = nc.requirements.get(api_labels.LABEL_TOPOLOGY_ZONE)
            zs = sorted(req.values_list())
            remote_zones.extend(zs * len(nc.pods) if len(zs) == 1 else [])
        assert sorted(remote_zones) == local_zones


class TestSessionProtocol:
    """The session wire (VERDICT r3 #1): catalog/nodepools sent once,
    columnar pod rows per solve, row-referencing interned results."""

    def _session_pair(self, sidecar, its, pool, **kw):
        from karpenter_tpu_torch.sidecar.client import SolverSession
        session = SolverSession(sidecar)
        return RemoteScheduler(sidecar, [pool], {"default": its},
                               session=session, **kw), session

    def test_session_parity_with_local(self, sidecar):
        its = construct_instance_types()[:48]
        pool = make_nodepool(name="default")
        pods = (make_pods(10, cpu="500m", memory="256Mi")
                + make_pods(6, cpu="1000m", labels={"app": "s"},
                            spread=[spread_zone(key="app", value="s")])
                + make_pods(3, cpu="250m", labels={"app": "anti"},
                            pod_anti_affinity=[
                                affinity_term(api_labels.LABEL_HOSTNAME,
                                              key="app", value="anti")]))
        local = cpu_scheduler([pool], {"default": its}).solve(pods)
        rs, session = self._session_pair(sidecar, its, pool)
        remote = rs.solve(pods)
        assert rs.fallback_reason == ""
        assert remote.pod_errors == local.pod_errors
        key = lambda nc: (tuple(it.name for it in nc.instance_type_options),
                          len(nc.pods))
        assert sorted(map(key, remote.new_nodeclaims)) == \
            sorted(map(key, local.new_nodeclaims))
        # API claims are complete: instance-type values filled from options
        api_nc = remote.new_nodeclaims[0].to_nodeclaim()
        it_req = next(r for r in api_nc.spec.requirements
                      if r.key == api_labels.LABEL_INSTANCE_TYPE)
        assert 0 < len(it_req.values) <= 60
        assert it_req.values[0] == \
            remote.new_nodeclaims[0].instance_type_options[0].name
        # errors map back to REAL pod uids (server side is synthetic rows)
        for uid in remote.pod_errors:
            assert any(p.uid == uid for p in pods)
        session.close()

    def test_session_reused_across_solves(self, sidecar):
        from karpenter_tpu_torch.sidecar import server as srv
        its = construct_instance_types()[:16]
        pool = make_nodepool(name="default")
        rs, session = self._session_pair(sidecar, its, pool)
        rs.solve(make_pods(4, cpu="500m"))
        sid = session._session_id
        assert sid is not None
        rs.solve(make_pods(5, cpu="250m"))
        assert session._session_id == sid  # no re-create
        # same catalog content in NEW list objects: still no re-create
        its2 = construct_instance_types()[:16]
        rs2 = RemoteScheduler(rs.address, [pool], {"default": its2},
                              session=session)
        rs2.solve(make_pods(2, cpu="100m"))
        assert session._session_id == sid
        # changed catalog content: a new session is created
        rs3 = RemoteScheduler(rs.address, [pool],
                              {"default": construct_instance_types()[:8]},
                              session=session)
        rs3.solve(make_pods(2, cpu="100m"))
        assert session._session_id != sid
        session.close()

    def test_session_eviction_recovery(self, sidecar):
        from karpenter_tpu_torch.sidecar import server as srv
        its = construct_instance_types()[:16]
        pool = make_nodepool(name="default")
        rs, session = self._session_pair(sidecar, its, pool)
        r1 = rs.solve(make_pods(4, cpu="500m"))
        assert not r1.pod_errors
        # simulate server restart: drop all sessions
        with srv._SESSIONS_LOCK:
            srv._SESSIONS.clear()
        r2 = rs.solve(make_pods(4, cpu="500m"))  # NOT_FOUND -> retry once
        assert not r2.pod_errors
        assert session._session_id is not None
        session.close()

    def test_state_node_delta_updates(self, sidecar):
        """An existing node added between solves must be visible server-side
        via the delta (VERDICT: delta-update state nodes instead of
        re-sending)."""
        make_state_node = factories(PORT).make_state_node
        its = construct_instance_types()[:16]
        pool = make_nodepool(name="default")
        rs, session = self._session_pair(sidecar, its, pool)
        r1 = rs.solve(make_pods(2, cpu="500m"))
        assert r1.new_nodeclaims and not r1.existing_nodes
        sn = make_state_node("live-node-1", zone="test-zone-a")
        rs2 = RemoteScheduler(rs.address, [pool], {"default": its},
                              state_nodes=[sn], session=session)
        r2 = rs2.solve(make_pods(2, cpu="500m"))
        assert [en.name for en in r2.existing_nodes] == ["live-node-1"]
        assert not r2.new_nodeclaims
        # removing the node flows through as a delete delta
        rs3 = RemoteScheduler(rs.address, [pool], {"default": its},
                              session=session)
        r3 = rs3.solve(make_pods(2, cpu="500m"))
        assert r3.new_nodeclaims and not r3.existing_nodes
        session.close()

    def test_session_host_fallback_relax(self, sidecar):
        """Pods whose preferences must relax ride the host ladder server-side
        over FULLY-SHARED specs (build_wire_pods): relaxation must not strip
        siblings, and results must match the in-process solve."""
        from karpenter_tpu_torch.api.objects import NodeSelectorRequirement
        term = [NodeSelectorRequirement(api_labels.LABEL_TOPOLOGY_ZONE,
                                        "In", ("no-such-zone",))]
        pods = make_pods(4, cpu="500m", labels={"app": "px"},
                         preferred_affinity=[(10, term)])
        its = construct_instance_types()[:16]
        pool = make_nodepool(name="default")
        local = cpu_scheduler([pool], {"default": its}).solve(
            [p for p in pods])
        rs, session = self._session_pair(sidecar, its, pool)
        remote = rs.solve(pods)
        assert remote.pod_errors == local.pod_errors == {}
        assert sorted(len(nc.pods) for nc in remote.new_nodeclaims) == \
            sorted(len(nc.pods) for nc in local.new_nodeclaims)
        session.close()

    def test_encode_pod_rows_dedup(self):
        spread = [spread_zone(key="app", value="d0")]
        a = [make_pod(cpu="500m", labels={"app": "d0"}, spread=spread,
                      name=f"a-{i}") for i in range(5)]
        b = [make_pod(cpu="250m", labels={"app": "d1"}, name=f"b-{i}")
             for i in range(3)]
        templates, tmpl_idx, ts = codec.encode_pod_rows(a + b)
        assert len(templates) <= 3  # shared elements may still merge content
        assert list(tmpl_idx[:5]) == [tmpl_idx[0]] * 5
        assert list(tmpl_idx[5:]) == [tmpl_idx[5]] * 3
        back = codec.build_wire_pods(templates, tmpl_idx, ts)
        assert len(back) == 8
        assert back[0].spec is back[1].spec  # fully shared spec per template
        assert back[0]._row == 0 and back[7]._row == 7
        assert back[0].requests() == a[0].requests()


class TestEncodeRowsFastPath:
    """encode_pod_rows' run-length fast path must stay exactly as
    discriminating as the slow-path key: consecutive pods differing in ANY
    keyed field must not merge, and a shuffled batch (no runs, pure slow
    path) must produce content-identical per-pod templates."""

    def _variants(self):
        from karpenter_tpu_torch.api.objects import HostPort, PVCRef, Toleration
        affinity_term = factories(PORT).affinity_term
        make_pod = factories(PORT).make_pod
        spread_zone = factories(PORT).spread_zone
        base = dict(cpu="100m", memory="128Mi")
        return [
            make_pod(**base),
            make_pod(cpu="200m", memory="128Mi"),
            make_pod(**base, labels={"app": "x"}),
            make_pod(**base, node_selector={"k": "v"}),
            make_pod(**base, tolerations=[Toleration(key="t",
                                                     operator="Exists")]),
            make_pod(**base, labels={"app": "s"},
                     spread=[spread_zone(key="app", value="s")]),
            make_pod(**base, labels={"app": "a"},
                     pod_affinity=[affinity_term(
                         "topology.kubernetes.io/zone", key="app",
                         value="a")]),
            make_pod(**base, host_ports=[HostPort(port=9000)]),
            make_pod(**base, namespace="other"),
        ]

    def test_adjacent_differing_pods_never_merge(self):
        from karpenter_tpu_torch.sidecar.codec import encode_pod_rows
        variants = self._variants()
        templates, idx, _ts = encode_pod_rows(variants)
        assert len(set(idx.tolist())) == len(variants), (
            "fast path merged pods the slow-path key separates")

    def test_shuffled_batch_agrees_with_run_ordered(self):
        import random
        from karpenter_tpu_torch.sidecar.codec import encode_pod_rows
        rng = random.Random(7)
        runs = []
        for v in self._variants():
            runs.extend([v] * 5)  # contiguous runs: fast path exercised
        shuffled = list(runs)
        rng.shuffle(shuffled)  # no runs: slow path everywhere
        t1, i1, _ = encode_pod_rows(runs)
        t2, i2, _ = encode_pod_rows(shuffled)
        by_pod_1 = {id(p): t1[t] for p, t in zip(runs, i1.tolist())}
        by_pod_2 = {id(p): t2[t] for p, t in zip(shuffled, i2.tolist())}
        for pid in by_pod_1:
            assert by_pod_1[pid] == by_pod_2[pid], (
                "fast path assigned different template CONTENT than the "
                "slow path for the same pod")


# -- cross-package: each client against each server --------------------------

#: (client package, server package)
PAIRS = tuple((c, s) for c in ROOTS for s in ROOTS)
#: seeds of the batch fuzzer (tests/test_torch_solve_parity.py's generator)
MATRIX_SEEDS = tuple(range(1000, 1010))


def _fuzz_case(seed: int, root: str):
    """The solve-parity fuzzer's pools and pods for ``seed`` over the
    first 48 kwok types, built with ``root``'s package; each pool's uid
    (which claims name as their owner) is its name, so that two packages'
    builds of a case are equal."""
    from test_torch_solve_parity import gen_nodepools, gen_pods
    pools = gen_nodepools(random.Random(seed), root)
    for pool in pools:
        pool.metadata.uid = f"uid-{pool.name}"
    its = pkg(root).kwok.construct_instance_types()[:48]
    return pools, {p.name: its for p in pools}, \
        gen_pods(random.Random(seed + 1), pools, root)


def _digest(root: str, results, pods, fallback_reason, partition):
    import importlib
    record = importlib.import_module(f"{root}.flightrec.record")
    return record.decision_digest(results, pods, fallback_reason,
                                  tuple(partition))


@pytest.fixture(scope="module")
def servers():
    """One sidecar of each package (the port's on the CPU)."""
    with sidecar_server(JAX) as (_, jax_address), \
            sidecar_server(PORT) as (_, port_address):
        yield {JAX: jax_address, PORT: port_address}


@pytest.mark.parametrize("seed", MATRIX_SEEDS)
def test_every_client_server_pair_gives_the_reference_decisions(
        seed, servers, monkeypatch):
    """JAX client -> port server, port client -> JAX server and port ->
    port each give the decision digest of JAX client -> JAX server on the
    same batch, and with the claim-name sequences restarted the same
    response frame, byte for byte but for the riders that carry a wall
    time or a trace id. (The reference is the JAX package's sidecar, not
    its in-process solve: the server solves the batch in its template-row
    order, so under limit pressure the pod of a deployment left without a
    node can differ by name from the in-process order's.)"""
    import importlib
    digests, frames = {}, {}
    for client, server in ((JAX, JAX),) + tuple(
            p for p in PAIRS if p != (JAX, JAX)):
        reset_claim_names(monkeypatch)
        cl = importlib.import_module(f"{client}.sidecar.client")
        pools, its, pods = _fuzz_case(seed, client)
        session = cl.SolverSession(servers[server], tenant=f"m{seed}")
        kept = keep_responses(session)
        try:
            r = cl.RemoteScheduler(servers[server], pools, its,
                                   session=session).solve(pods)
        finally:
            session.close()
        digests[(client, server)] = _digest(client, r, pods,
                                            r.fallback_reason, r.partition)
        assert [m for m, _ in kept] == ["CreateSession", "SolveSession"]
        frames[(client, server)] = response_content(client, kept[-1][1])
    for pair in PAIRS:
        assert digests[pair] == digests[(JAX, JAX)], \
            f"{pair[0]} client -> {pair[1]} server, seed {seed}"
        assert frames[pair] == frames[(JAX, JAX)], pair


def test_matrix_covers_host_and_tensor_solves(servers):
    """The fuzzer's seeds reach both sides of the solve: batches wholly
    on the tensor path and batches that take the host oracle."""
    from karpenter_tpu.provisioning.tensor_scheduler import \
        TensorScheduler as JaxScheduler
    kinds = set()
    for seed in MATRIX_SEEDS:
        pools, its, pods = _fuzz_case(seed, JAX)
        ts = JaxScheduler(pools, its)
        ts.solve(pods)
        kinds.add("host" if ts.fallback_reason or ts.partition[1]
                  else "tensor")
    assert kinds == {"host", "tensor"}, kinds
