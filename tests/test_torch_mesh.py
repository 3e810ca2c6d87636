"""parallel/mesh.py on torch devices, held against the JAX package's mesh:
the sharded precompute (K1-K3 per mesh slot) on 1-, 2-, 4- and 8-slot CPU
meshes, the padding edges, the sharded pack's contract, the exist-side
upload caches, and the device-loss ladder. The port's meshes repeat the CPU
device (make_solver_mesh(devices=[cpu] * n)); the JAX package's run on the
conftest's virtual CPU devices. All outputs are bool or integer: equality
is exact."""

import dataclasses

import numpy as np
import pytest
import torch

from karpenter_tpu.ops import binpack as jbinpack
from karpenter_tpu.parallel import mesh as jmesh
from karpenter_tpu.utils.chaos import DeviceKiller
from karpenter_tpu_torch.metrics.registry import STATE_AUDIT
from karpenter_tpu_torch.obs.tracer import TRACER
from karpenter_tpu_torch.ops import binpack as tbinpack
from karpenter_tpu_torch.ops import kernels
from karpenter_tpu_torch.parallel import mesh as tmesh
from karpenter_tpu_torch.provisioning.problem_state import ProblemState

from test_torch_support import (JAX, PORT, PACK_FIELDS, ROOTS,
                                assert_tensors_equal, bench_workload,
                                build_problem, cpu_mesh, digest, nodepool,
                                pkg, pod, scheduler, state_node)
from test_torch_support import device_series_kept  # noqa: F401 (autouse)

CPU = torch.device("cpu")


def spread_zone(root, value):
    k = pkg(root)
    return k.objects.TopologySpreadConstraint(
        topology_key=k.labels.LABEL_TOPOLOGY_ZONE, max_skew=1,
        label_selector=k.objects.LabelSelector(match_labels={"app": value}))


def problem_workload(root, n_groups=5, n_its=30, n_nodes=0):
    """tests/test_parallel_mesh.py's _problem: n_groups deployments of 7
    pods (every second one zone-spread) against the first n_its kwok
    types, plus n_nodes existing nodes."""
    its = pkg(root).kwok.construct_instance_types()[:n_its]
    pods = []
    for d in range(n_groups):
        spread = [spread_zone(root, f"d{d}")] if d % 2 else None
        pods += [pod(root, f"mp-{d}-{i}", cpu=f"{(d + 1) * 100}m",
                     memory=f"{(d + 1) * 64}Mi", labels={"app": f"d{d}"},
                     spread=spread) for i in range(7)]
    nodes = [state_node(root, f"exist-{i}", "default", "16", "64Gi", True,
                        zone=f"test-zone-{'abc'[i % 3]}")
             for i in range(n_nodes)]
    return [nodepool(root, "default")], {"default": its}, nodes, pods


def mix_pods(root, n_deploys, pods_per=7):
    pods = []
    for d in range(n_deploys):
        spread = [spread_zone(root, f"d{d}")] if d % 3 == 1 else None
        pods += [pod(root, f"mix-{d}-{i}", cpu=f"{100 + (d % 7) * 150}m",
                     memory=f"{64 * (1 + d % 5)}Mi", labels={"app": f"d{d}"},
                     spread=spread) for i in range(pods_per)]
    return pods


def solve(root, pods, its, mesh=None, pack_shards=0, state_nodes=(),
          problem_state=None):
    ts = scheduler(root, [nodepool(root, "default")], {"default": its},
                   state_nodes=list(state_nodes), mesh=mesh,
                   pack_shards=pack_shards, problem_state=problem_state)
    results = ts.solve(pods)
    assert ts.fallback_reason == "", ts.fallback_reason
    return results


def last_span(name):
    spans = [s for s in TRACER.last().spans if s.name == name]
    assert len(spans) == 1, [s.name for s in TRACER.last().spans]
    return spans[0]


# -- the mesh itself ---------------------------------------------------------


@pytest.mark.parametrize("n,grid", [(1, (1, 1)), (2, (2, 1)), (3, (3, 1)),
                                    (4, (2, 2)), (6, (3, 2)), (8, (4, 2))])
def test_mesh_grid_factoring_matches_jax(n, grid):
    m = tmesh.make_solver_mesh(devices=[CPU] * n)
    assert m.devices.shape == grid == jmesh.make_solver_mesh(n).devices.shape
    assert [s.id for s in m.devices.flat] == list(range(n))
    assert m.shape == {"pods_groups": grid[0], "catalog": grid[1]}
    key = tmesh.mesh_cache_key(m)
    assert key == tmesh.mesh_cache_key(
        tmesh.make_solver_mesh(devices=[CPU] * n))
    assert key[2] == grid and not tmesh.is_multiprocess(m)


def test_mesh_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.make_solver_mesh()


# -- B4: the sharded precompute ----------------------------------------------


@pytest.fixture(scope="module")
def problems():
    out = {}
    for name, kw in {"plain": {}, "nodes": {"n_nodes": 5},
                     "two_groups": {"n_groups": 2},
                     "one_group": {"n_groups": 1, "n_its": 24}}.items():
        _, jp = build_problem(JAX, problem_workload(JAX, **kw))
        _, tp = build_problem(PORT, problem_workload(PORT, **kw))
        out[name] = (jp, tp)
    return out


@pytest.mark.parametrize("n_slots", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["plain", "nodes", "two_groups",
                                  "one_group"])
def test_sharded_precompute_matches_jax_and_single(problems, name, n_slots):
    jp, tp = problems[name]
    got = tmesh.sharded_precompute(tp, cpu_mesh(PORT, n_slots))
    assert_tensors_equal(tbinpack.precompute(tp, device="cpu"), got)
    want = jmesh.sharded_precompute(jp, cpu_mesh(JAX, n_slots))
    assert_tensors_equal(want, got)


def test_sharded_precompute_local_single_process(problems):
    _, tp = problems["plain"]
    tensors, spans = tmesh.sharded_precompute_local(tp, cpu_mesh(PORT, 8))
    G = tensors.it_ok.shape[0]
    assert spans == [(0, G)]
    assert_tensors_equal(tbinpack.precompute(tp, device="cpu"), tensors)


def test_all_padding_shard_precompute_rows_are_inert(problems):
    """G=2 on the (4, 2) grid pads the group axis to 32 rows: shards 1-3
    are all padding, and no padded row admits a zone."""
    _, tp = problems["two_groups"]
    m = cpu_mesh(PORT, 8)
    g_mult, t_mult = m.shape["pods_groups"], m.shape["catalog"]
    Gp, _ = tmesh.padded_sizes(2, 30, g_mult, t_mult)
    assert Gp >= 4 * g_mult
    assert (Gp, _) == jmesh.padded_sizes(2, 30, g_mult, t_mult)
    padded, G, _ = tmesh.pad_problem(tp, g_mult, t_mult)
    assert G == 2
    assert not tbinpack.precompute(padded, device="cpu").zone_adm[G:].any()


def test_recreated_mesh_reuses_the_catalog_upload(problems):
    """A NEW Mesh object over the same slots keys the same cached catalog
    upload (mesh_cache_key, not the Mesh object)."""
    _, tp = problems["plain"]
    p = dataclasses.replace(tp, device_cache={})
    tmesh.sharded_precompute(p, cpu_mesh(PORT, 8))
    slots = {k for k in p.device_cache if k[0] == "it_side"}
    first = {k: p.device_cache[k] for k in slots}
    out = tmesh.sharded_precompute(p, cpu_mesh(PORT, 8))
    assert {k for k in p.device_cache if k[0] == "it_side"} == slots
    assert all(p.device_cache[k] is first[k] for k in slots)
    assert_tensors_equal(tbinpack.precompute(tp, device="cpu"), out)


# -- mesh solves: padding edges ----------------------------------------------


@pytest.mark.parametrize("n_deploys,n_its", [(13, 37), (2, 30), (1, 24)])
def test_mesh_solve_exact_parity_padding_edges(n_deploys, n_its):
    """Group/catalog counts that don't divide the (4, 2) grid, shards made
    of padding only, one group on 8 slots: the port's mesh solve equals
    its single-device solve and the JAX package's mesh solve."""
    got = {}
    for root in ROOTS:
        its = pkg(root).kwok.construct_instance_types()[:n_its]
        pods = mix_pods(root, n_deploys)
        r_mesh = solve(root, pods, its, mesh=cpu_mesh(root, 8))
        r_single = solve(root, pods, its)
        assert digest(r_mesh, pods) == digest(r_single, pods)
        got[root] = digest(r_mesh, pods)
    assert got[JAX] == got[PORT]


# -- the sharded pack --------------------------------------------------------


def test_sharded_pack_contract_vs_sequential_oracle():
    """Pod errors exact, placed pods exact, node count in the reconcile
    envelope, the hierarchical path engaged — and the port's sharded pack
    makes the JAX package's decisions."""
    got = {}
    for root in ROOTS:
        its = pkg(root).kwok.construct_instance_types()[:48]
        pods = mix_pods(root, 40, pods_per=25)
        pods += [pod(root, f"impossible-{i}", cpu="1000",
                     labels={"app": "impossible"}) for i in range(3)]
        r_seq = solve(root, pods, its)
        r_sh = solve(root, pods, its, pack_shards=4)
        if root == PORT:
            assert last_span("pack").attrs.get("sharded") == 4
        assert r_sh.pod_errors == r_seq.pod_errors and r_seq.pod_errors
        placed = lambda r: sum(len(nc.pods) for nc in r.new_nodeclaims)  # noqa: E731
        assert placed(r_sh) == placed(r_seq)
        n_seq, n_sh = len(r_seq.new_nodeclaims), len(r_sh.new_nodeclaims)
        assert n_sh <= int(np.ceil(n_seq * 1.05)) + 4, (n_sh, n_seq)
        got[root] = digest(r_sh, pods)
    assert got[JAX] == got[PORT]


def test_sharded_pack_bench_mix_matches_jax():
    """chip_smoke's sharded-pack phase at a small size: the benchmark mix
    (topology-heavy) through pack_shards=4 makes the JAX package's
    decisions, and its pod errors are the sequential pack's."""
    got = {}
    for root in ROOTS:
        pools, its, _, pods = bench_workload(root, 900, 200, n_deploys=18)
        r_seq = scheduler(root, pools, its).solve(pods)
        ts = scheduler(root, pools, its, pack_shards=4)
        r_sh = ts.solve(pods)
        assert ts.fallback_reason == ""
        assert r_sh.pod_errors == r_seq.pod_errors
        got[root] = (digest(r_sh, pods), len(r_sh.new_nodeclaims),
                     len(r_seq.new_nodeclaims))
    assert got[JAX] == got[PORT]


def test_sharded_pack_single_shard_and_single_group_degenerate():
    its = pkg(PORT).kwok.construct_instance_types()[:24]
    for pods, shards in ((mix_pods(PORT, 6), 1),
                         (mix_pods(PORT, 1, pods_per=40), 4)):
        r_seq = solve(PORT, pods, its)
        r_sh = solve(PORT, pods, its, pack_shards=shards)
        assert digest(r_sh, pods) == digest(r_seq, pods)


def test_sharded_pack_gate_existing_nodes_forces_sequential():
    its = pkg(PORT).kwok.construct_instance_types()[:24]
    pods = mix_pods(PORT, 8, pods_per=10)
    nodes = [state_node(PORT, f"existing-{i}", "default", "8", "32Gi", True)
             for i in range(3)]
    r_sh = solve(PORT, pods, its, pack_shards=4, state_nodes=nodes)
    assert "sharded" not in last_span("pack").attrs
    r_seq = solve(PORT, pods, its, state_nodes=nodes)
    assert digest(r_sh, pods) == digest(r_seq, pods)


def test_pack_shardable_gate_direct():
    _, p = build_problem(PORT, problem_workload(PORT, n_groups=3, n_its=12))
    assert tmesh.pack_shardable(p, [None], None, None)
    assert not tmesh.pack_shardable(p, [{"cpu": 100}], None, None)
    assert not tmesh.pack_shardable(p, [None], [set(), {80}, set()], None)
    assert not tmesh.pack_shardable(p, [None], None, {0: 2})


def test_sharded_pack_reconcile_memo_reused_on_unchanged_warm():
    its = pkg(PORT).kwok.construct_instance_types()[:24]
    pods = mix_pods(PORT, 12, pods_per=9)
    ps = ProblemState()
    oracle = solve(PORT, pods, its, pack_shards=4)
    assert last_span("pack").attrs.get("sharded") == 4
    r1 = solve(PORT, pods, its, pack_shards=4, problem_state=ps)
    assert last_span("pack.reconcile").attrs.get("merged") == "fold"
    r2 = solve(PORT, pods, its, pack_shards=4, problem_state=ps)
    span2 = last_span("pack.reconcile")
    assert span2.attrs.get("merged") == "memo"
    assert span2.attrs.get("donor_rows") is not None
    for r in (r1, r2):
        assert digest(r, pods) == digest(oracle, pods)


class TestMultihostHelpers:
    def test_init_multihost_single_host_noop(self, monkeypatch):
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        assert tmesh.init_multihost() == 1
        assert tmesh.init_multihost(num_processes=1) == 1
        with pytest.raises(NotImplementedError):
            tmesh.init_multihost(num_processes=2)

    def test_local_result_slice_covers_all_groups(self):
        assert tmesh.local_result_slice(cpu_mesh(PORT, 8), 101) == [(0, 101)]


# -- exist-side uploads ------------------------------------------------------


def test_exist_upload_reuse_keyed_on_device_identity(monkeypatch):
    """The cached exist-side upload keys on (content token, placement):
    the same content on the same device is served from its slot; a flip
    of the placement identity re-places, and so does flipping back."""
    nodes = [state_node(PORT, f"exist-{i}", "default", "16", "64Gi", True)
             for i in range(3)]
    its = pkg(PORT).kwok.construct_instance_types()[:24]
    _, problem = build_problem(PORT, ([nodepool(PORT, "default")],
                                      {"default": its}, nodes,
                                      mix_pods(PORT, 4)))
    p = dataclasses.replace(problem, exist_token=("content", 1),
                            device_cache={})
    placer = tbinpack.ArgPlacer(CPU)
    args1, _ = tbinpack.device_args(p, placer)
    args2, _ = tbinpack.device_args(p, placer)
    assert args2[-3] is args1[-3] and args2[-2] is args1[-2]
    monkeypatch.setattr(tbinpack.ArgPlacer, "device_token",
                        lambda self: ("dev", "elsewhere", 999))
    args3, _ = tbinpack.device_args(p, placer)
    assert args3[-3] is not args1[-3]
    monkeypatch.undo()
    args4, _ = tbinpack.device_args(p, placer)
    assert args4[-3] is not args3[-3]


def test_mesh_exist_side_one_copy_per_distinct_device():
    """On a mesh that repeats a device, every slot shares that device's one
    resident copy of the node side."""
    _, p = build_problem(PORT, problem_workload(PORT, n_nodes=5))
    args, _, _, _, _, _ = tmesh._sharded_dispatch(p, cpu_mesh(PORT, 8))
    exist, exist_avail = args[13], args[14]
    assert list(exist) == ["cpu"] and list(exist_avail) == ["cpu"]


def test_mesh_single_device_flip_shared_problem_state_parity():
    """One ProblemState driven through a mesh solve, a single-device solve
    and the mesh again: every hop equals a state-free cold solve."""
    its = pkg(PORT).kwok.construct_instance_types()[:24]
    nodes = [state_node(PORT, f"exist-{i}", "default", "16", "64Gi", True)
             for i in range(3)]
    pods = mix_pods(PORT, 6)
    oracle = digest(solve(PORT, pods, its, state_nodes=nodes), pods)
    ps = ProblemState()
    mesh = cpu_mesh(PORT, 8)
    for hop, m in (("mesh", mesh), ("single", None), ("mesh-again", mesh)):
        r = solve(PORT, pods, its, mesh=m, state_nodes=nodes,
                  problem_state=ps)
        assert digest(r, pods) == oracle, hop


def test_sharded_state_splices_only_the_dirty_span():
    """The sharded ProblemState on a 4 x 2 mesh: a rollout pass with one
    node changed re-uploads only that node's shard span through the row
    splice, skips the clean spans, and the spliced resident buffers equal a
    fresh upload of the new node side."""
    from karpenter_tpu_torch.metrics.registry import EXIST_SPLICE_BYTES
    its = pkg(PORT).kwok.construct_instance_types()[:24]
    nodes = [state_node(PORT, f"exist-{i:02d}", "default", "16", "64Gi",
                        True) for i in range(20)]
    mesh = cpu_mesh(PORT, 8)
    ps = ProblemState()
    pods = mix_pods(PORT, 4)
    solve(PORT, pods, its, mesh=mesh, state_nodes=nodes, problem_state=ps)
    assert ps.exist_shard_tokens is not None and \
        len(ps.exist_shard_tokens) == 4
    calls = []
    real = kernels.row_splice
    kernels.row_splice = lambda *a: (calls.append(a[2]), real(*a))[1]
    try:
        skipped0 = EXIST_SPLICE_BYTES.value({"outcome": "skipped"})
        nodes[1].update_pod(pod(PORT, "churn-0", cpu="1"))
        rollout = pods + mix_pods(PORT, 5)[4 * 7:]
        r = solve(PORT, rollout, its, mesh=mesh, state_nodes=nodes,
                  problem_state=ps)
    finally:
        kernels.row_splice = real
    assert ps.last["precompute"] == "computed"
    assert calls == [0]  # shard 0's span, once for the one device
    assert EXIST_SPLICE_BYTES.value({"outcome": "skipped"}) > skipped0
    cold = solve(PORT, rollout, its, mesh=mesh, state_nodes=nodes)
    assert digest(r, rollout) == digest(cold, rollout)


# -- the device-loss ladder --------------------------------------------------


@pytest.fixture
def killer():
    k = DeviceKiller()
    prev = tbinpack.install_device_chaos(k)
    tmesh.reset_device_breakers()
    yield k
    tbinpack.install_device_chaos(prev)
    tmesh.reset_device_breakers()


def _ids(mesh):
    return sorted(int(s.id) for s in mesh.devices.flat)


PARITY_FIELDS = ("compat_tm", "it_ok", "ppn", "it_ok_z", "zone_adm")


def _assert_parity(ref, out):
    for f in PARITY_FIELDS:
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f))


class TestDeviceLadder:
    def test_mid_solve_kill_degrades_to_carve_with_parity(self, problems,
                                                          killer):
        _, p = problems["plain"]
        mesh = cpu_mesh(PORT, 8)
        ids = _ids(mesh)
        ref = tbinpack.precompute(p, device="cpu")
        before = STATE_AUDIT.value({"layer": "device", "outcome": "killed"})
        killer.kill(ids[0])
        _assert_parity(ref, tmesh.resilient_precompute(p, mesh))
        assert STATE_AUDIT.value(
            {"layer": "device", "outcome": "killed"}) == before + 1
        assert tmesh.device_breaker(ids[0])._failures == 1
        assert all(tmesh.device_breaker(i)._failures == 0 for i in ids[1:])

    def test_all_but_one_dead_lands_on_single_rung(self, problems, killer):
        _, p = problems["plain"]
        mesh = cpu_mesh(PORT, 8)
        ids = _ids(mesh)
        ref = tbinpack.precompute(p, device="cpu")
        before = STATE_AUDIT.value({"layer": "device", "outcome": "single"})
        for i in ids[:-1]:
            killer.kill(i)
        _assert_parity(ref, tmesh.resilient_precompute(p, mesh))
        assert STATE_AUDIT.value(
            {"layer": "device", "outcome": "single"}) == before + 1

    def test_breaker_opens_for_dead_device_only(self, problems, killer):
        _, p = problems["plain"]
        mesh = cpu_mesh(PORT, 8)
        ids = _ids(mesh)
        killer.kill(ids[0])
        for _ in range(tmesh.DEVICE_BREAKER_THRESHOLD):
            tmesh.resilient_precompute(p, mesh)
        assert tmesh.device_breaker(ids[0]).state == "open"
        assert all(tmesh.device_breaker(i).state == "closed"
                   for i in ids[1:])
        counted = killer.counts[ids[0]]
        tmesh.resilient_precompute(p, mesh)
        assert killer.counts[ids[0]] == counted

    def test_half_open_probe_readmits_revived_device(self, problems, killer):
        from karpenter_tpu_torch.utils.clock import FakeClock
        _, p = problems["plain"]
        mesh = cpu_mesh(PORT, 8)
        ids = _ids(mesh)
        clock = FakeClock()
        b = tmesh.device_breaker(ids[0], now=clock.now)
        killer.kill(ids[0])
        for _ in range(tmesh.DEVICE_BREAKER_THRESHOLD):
            tmesh.resilient_precompute(p, mesh)
        assert b.state == "open"
        killer.revive(ids[0])
        tmesh.resilient_precompute(p, mesh)
        assert b.state == "open"
        clock.step(tmesh.DEVICE_BREAKER_COOLDOWN + 1)
        before = STATE_AUDIT.value(
            {"layer": "device", "outcome": "readmitted"})
        _assert_parity(tbinpack.precompute(p, device="cpu"),
                       tmesh.resilient_precompute(p, mesh))
        assert b.state == "closed"
        assert STATE_AUDIT.value(
            {"layer": "device", "outcome": "readmitted"}) == before + 1

    def test_exhausted_ladder_raises(self, problems, killer):
        _, p = problems["plain"]
        mesh = cpu_mesh(PORT, 8)
        for i in _ids(mesh):
            killer.kill(i)
        with pytest.raises(tmesh.DeviceLadderExhausted):
            tmesh.resilient_precompute(p, mesh)

    def test_exhausted_ladder_serves_host_without_global_breaker(self,
                                                                 killer):
        its = pkg(PORT).kwok.construct_instance_types()[:30]
        ts = scheduler(PORT, [nodepool(PORT, "default")], {"default": its})
        ts.mesh = cpu_mesh(PORT, 8)
        for i in _ids(ts.mesh):
            killer.kill(i)
        pods = [pod(PORT, f"ex-{i}", cpu="500m") for i in range(5)]
        results = ts.solve(pods)
        assert "device ladder exhausted" in ts.fallback_reason
        assert not results.pod_errors and results.new_nodeclaims
        assert ts.circuit.state == "closed" and ts.circuit._failures == 0


def test_kernel_error_in_a_mesh_dispatch_reaches_the_caller(monkeypatch):
    """A KernelError raised inside one slot's launch is not a device loss:
    it leaves the ladder, reaches the caller of solve() even without
    force_tensor, and no breaker counts it."""
    tmesh.reset_device_breakers()
    its = pkg(PORT).kwok.construct_instance_types()[:30]
    ts = scheduler(PORT, [nodepool(PORT, "default")], {"default": its},
                   mesh=cpu_mesh(PORT, 8))
    assert not ts.force_tensor

    def refused(*a, **k):
        raise kernels.KernelError("catalog_feasibility kernel launch "
                                  "failed: too many resources requested")
    monkeypatch.setattr(kernels, "catalog_feasibility", refused)
    with pytest.raises(kernels.KernelError, match="too many resources"):
        ts.solve([pod(PORT, f"ke-{i}", cpu="500m") for i in range(5)])
    assert ts.circuit._failures == 0 and ts.circuit.state == "closed"
    assert all(tmesh.device_breaker(i)._failures == 0
               for i in _ids(ts.mesh))
    tmesh.reset_device_breakers()


def test_pack_fields_cover_every_precompute_output():
    assert set(PACK_FIELDS) == {
        f.name for f in dataclasses.fields(tbinpack.PackTensors)} == {
        f.name for f in dataclasses.fields(jbinpack.PackTensors)}
