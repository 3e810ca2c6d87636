"""The multi-process half of parallel/mesh.py on the CPU: two processes
joined by ``init_multihost`` (torch.distributed, gloo over 127.0.0.1), each
with four CPU slots, so ``make_solver_mesh`` spans them as one 4x2 grid.
The sharded precompute over that grid must equal the single-process 8-slot
mesh and the JAX package's precompute on the same problem, array for
array; ``sharded_precompute_local`` must fill exactly the spans of
``local_result_slice``; a 3+3-slot grid, whose middle row spans both
processes, gathers right and refuses a local fetch. Each child has a time
limit of its own, so a rendezvous that hangs fails the test instead of
holding the run.

The children import this module (and test_torch_support) without jax:
everything here that reaches the JAX package does so inside a test."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_support import (JAX, PACK_FIELDS, PORT, assert_tensors_equal,
                                build_problem, cpu_mesh, digest, nodepool,
                                pkg, pod, scheduler, state_node)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
CPU = torch.device("cpu")
#: seconds each child may take, rendezvous included
CHILD_TIMEOUT_S = 60
#: the problems: (groups, existing nodes). The group axis pads to 8 rows a
#: pods_groups row, so the 5 groups of "plain" all sit in process 0's rows
#: and the 20 of "nodes" reach process 1's
PROBLEMS = {"plain": (5, 0), "nodes": (20, 5)}


def workload(root: str, n_groups: int, n_nodes: int):
    """n_groups deployments of 7 pods (every second one zone-spread) against
    the first 30 kwok types, plus n_nodes existing nodes."""
    k = pkg(root)
    pods = []
    for d in range(n_groups):
        spread = ([k.objects.TopologySpreadConstraint(
            topology_key=k.labels.LABEL_TOPOLOGY_ZONE, max_skew=1,
            label_selector=k.objects.LabelSelector(
                match_labels={"app": f"d{d}"}))] if d % 2 else None)
        pods += [pod(root, f"mp-{d}-{i}", cpu=f"{(d + 1) * 100}m",
                     memory=f"{(d + 1) * 64}Mi", labels={"app": f"d{d}"},
                     spread=spread) for i in range(7)]
    nodes = [state_node(root, f"exist-{i}", "default", "16", "64Gi", True,
                        zone=f"test-zone-{'abc'[i % 3]}")
             for i in range(n_nodes)]
    its = k.kwok.construct_instance_types()[:30]
    return [nodepool(root, "default")], {"default": its}, nodes, pods


def _arrays(tensors, prefix: str) -> dict:
    return {f"{prefix}.{f}": np.asarray(getattr(tensors, f))
            for f in PACK_FIELDS}


def child(rank: int, port: int, out: str) -> None:
    """One process of the fleet: joins it, builds the spanning meshes and
    writes what it computed to ``out`` (.npz, with a JSON summary)."""
    from karpenter_tpu_torch.parallel import mesh as tmesh
    address = f"127.0.0.1:{port}"
    assert tmesh.init_multihost(address, 2, rank) == 2
    assert tmesh.init_multihost(address, 2, rank) == 2  # idempotent
    m = tmesh.make_solver_mesh(devices=[CPU] * 4)
    m6 = tmesh.make_solver_mesh(devices=[CPU] * 3)
    arrays, summary = {}, {
        "shape": list(m.devices.shape), "shape6": list(m6.devices.shape),
        "ids": [s.id for s in m.devices.flat],
        "procs": [s.process_index for s in m.devices.flat],
        "procs6": [s.process_index for s in m6.devices.flat],
        "multiprocess": tmesh.is_multiprocess(m),
        "local": {}, "slices": {}, "spanning_row": None}
    for name, (n_groups, n_nodes) in PROBLEMS.items():
        _, p = build_problem(PORT, workload(PORT, n_groups, n_nodes))
        arrays.update(_arrays(tmesh.sharded_precompute(p, m), f"{name}.full"))
        arrays.update(_arrays(tmesh.sharded_precompute(p, m6),
                              f"{name}.full6"))
        local, spans = tmesh.sharded_precompute_local(p, m)
        arrays.update(_arrays(local, f"{name}.local"))
        summary["local"][name] = spans
        summary["slices"][name] = [
            tmesh.local_result_slice(m, n_groups, process_index=i)
            for i in range(2)]
    _, p = build_problem(PORT, workload(PORT, *PROBLEMS["plain"]))
    try:
        tmesh.sharded_precompute_local(p, m6)
    except ValueError as exc:
        summary["spanning_row"] = str(exc)
    # a whole solve over the spanning mesh: every process packs the full
    # result to the same decisions
    pools, its, nodes, pods = workload(PORT, *PROBLEMS["nodes"])
    ts = scheduler(PORT, pools, its, state_nodes=nodes, mesh=m,
                   force_tensor=True)
    results = ts.solve(pods)
    summary["solve"] = {"fallback": ts.fallback_reason,
                        "digest": repr(digest(results, pods))}
    np.savez(out, **arrays)
    with open(out + ".json", "w") as f:
        json.dump(summary, f)
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """Both children's outputs, by rank."""
    root = tmp_path_factory.mktemp("fleet")
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = []
    for rank in range(2):
        code = (f"import sys; sys.path[:0] = [{REPO!r}, {TESTS!r}]; "
                "import test_torch_mesh_multiprocess as t; "
                f"t.child({rank}, {port}, {str(root / f'r{rank}.npz')!r})")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=CHILD_TIMEOUT_S)
            logs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"rank {rank}:\n{log[-4000:]}"
    out = []
    for rank in range(2):
        path = str(root / f"r{rank}.npz")
        with open(path + ".json") as f:
            summary = json.load(f)
        out.append((dict(np.load(path)), summary))
    return out


@pytest.fixture(scope="module")
def problems():
    return {name: tuple(build_problem(root, workload(root, *sizes))[1]
                        for root in (JAX, PORT))
            for name, sizes in PROBLEMS.items()}


def _tensors(arrays: dict, prefix: str):
    from karpenter_tpu_torch.ops.binpack import PackTensors
    return PackTensors(**{f: arrays[f"{prefix}.{f}"] for f in PACK_FIELDS})


def test_the_mesh_spans_both_processes(fleet):
    for _, s in fleet:
        assert s["shape"] == [4, 2] and s["shape6"] == [3, 2]
        assert s["ids"] == list(range(8))
        assert s["procs"] == [0] * 4 + [1] * 4
        assert s["procs6"] == [0] * 3 + [1] * 3
        assert s["multiprocess"]


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_sharded_precompute_equals_one_process_and_jax(fleet, problems,
                                                       name):
    from karpenter_tpu.parallel import mesh as jmesh
    from karpenter_tpu_torch.parallel import mesh as tmesh
    jp, tp = problems[name]
    one = tmesh.sharded_precompute(tp, cpu_mesh(PORT, 8))
    assert_tensors_equal(jmesh.sharded_precompute(jp, cpu_mesh(JAX, 8)), one)
    for arrays, _ in fleet:
        assert_tensors_equal(one, _tensors(arrays, f"{name}.full"))
        # the 3+3 grid: its middle row is one slot of each process
        assert_tensors_equal(one, _tensors(arrays, f"{name}.full6"))


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_local_precompute_fills_exactly_its_spans(fleet, problems, name):
    from karpenter_tpu_torch.parallel import mesh as tmesh
    _, tp = problems[name]
    one = tmesh.sharded_precompute(tp, cpu_mesh(PORT, 8))
    G = one.it_ok.shape[0]
    covered = []
    for rank, (arrays, s) in enumerate(fleet):
        spans = [tuple(x) for x in s["local"][name]]
        assert spans or (name, rank) == ("plain", 1), rank
        local = _tensors(arrays, f"{name}.local")
        mine = np.zeros(G, dtype=bool)
        for start, stop in spans:
            mine[start:stop] = True
        covered.append(mine)
        for f in PACK_FIELDS:
            want, got = getattr(one, f), getattr(local, f)
            axis = 1 if f == "compat_tm" else 0
            assert np.array_equal(np.compress(mine, want, axis),
                                  np.compress(mine, got, axis)), f
            assert not np.compress(~mine, got, axis).any(), f
    # the two processes' rows tile the groups, with no row in both
    assert not (covered[0] & covered[1]).any()
    assert (covered[0] | covered[1]).all()


def test_local_result_slice_reads_the_slots_processes(fleet):
    n_groups = PROBLEMS["nodes"][0]
    for _, s in fleet:
        # 20 groups over 4 rows of 5: rows 0-1 are process 0's, rows 2-3
        # process 1's
        assert s["slices"]["nodes"] == [[[0, 10]], [[10, n_groups]]]


def test_local_fetch_refuses_a_row_that_spans_processes(fleet):
    for _, s in fleet:
        assert s["spanning_row"] is not None
        assert "row 1 spans processes [0, 1]" in s["spanning_row"]


def test_a_solve_over_the_fleet_decides_as_one_process(fleet):
    pools, its, nodes, pods = workload(PORT, *PROBLEMS["nodes"])
    results = scheduler(PORT, pools, its, state_nodes=nodes,
                        force_tensor=True).solve(pods)
    for _, s in fleet:
        assert s["solve"] == {"fallback": "",
                              "digest": repr(digest(results, pods))}


def test_init_multihost_without_a_bootstrap_is_one_process(monkeypatch):
    from karpenter_tpu_torch.parallel import mesh as tmesh
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert tmesh.init_multihost() == 1
    assert tmesh.init_multihost() == 1
    assert tmesh.init_multihost(num_processes=1) == 1
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tmesh.init_multihost(auto=True) == 1
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="coordinator address"):
        tmesh.init_multihost()
    assert not torch.distributed.is_initialized()


def test_chip_smoke_mesh_multiprocess_phase_on_the_cpu():
    """chip_smoke.py's mesh_multiprocess phase at 540 pods x 40 types on
    the CPU: two processes of chip_smoke.mesh_child, each's decisions equal
    to the one-process cold solve's."""
    import chip_smoke
    from karpenter_tpu_torch.cloudprovider.kwok import construct_catalog
    from karpenter_tpu_torch.provisioning import tensor_scheduler as ts_mod
    sizes = dict(n_pods=540, n_deploys=12, n_its=40)
    pods = chip_smoke.bench_pods(540, 12)
    _, results, s = chip_smoke._solve(ts_mod, chip_smoke.default_pool(),
                                      construct_catalog(40), pods, (), "cpu")
    line, launches, held = chip_smoke.mesh_multiprocess_phase(
        chip_smoke._local_digest(results, pods), s, device="cpu", **sizes)
    assert line["digest_equals_single_process"]
    assert line["pods"] == len(pods) and line["instance_types"] == 40
    assert [sl[1] for sl in line["slots"]] == [0] * 4 + [1] * 4
    assert len(line["best_s"]) == 2 and set(launches) >= set(
        chip_smoke.FEASIBILITY)
    assert {name for name, _ in held} == {"combine_compat",
                                          "catalog_feasibility"}
