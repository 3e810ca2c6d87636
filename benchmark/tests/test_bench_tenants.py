"""The tenant cell's check, on the CPU at a small size: sound runs read no
fault; the control (every pod tolerating every taint) reads faults; the
three plants (a team pod on another team's node, a claim in a
lower-weight pool that a higher one admits, a nodeSelector dropped) read
faults; and the three faults a solve's timed path can have come out not
correct: a pass that returns its state unchanged, half of the batch left
out, an answer altered where it is produced. Beside them: the cell loads
neither JAX nor the JAX package, its reference and spec load no part of
the program, and ``taints_ms.solve`` reads its span's self time."""

import time
from types import SimpleNamespace

import pytest

import bench_support  # noqa: F401 (the repository root on the path)
from test_bench_check import _solve_fault
from test_bench_imports import _run as _guarded

from benchmark import harness, tenant_control

WORKLOAD = "solve-tenants-5k-nodes"


def small():
    """The cell as BENCHMARK.json states it, cut to 36 deployments of 12
    pods, 60 types and 40 nodes a pool."""
    cell, cfg, traffic, e2e, layer = harness.load_cell(WORKLOAD)
    cfg["pods"].update(deployments=36, replicas=12)
    cfg["catalog"]["count"] = 60
    cfg["existing_nodes"]["per_pool"] = 40
    return cell, cfg, traffic, e2e, layer


def _run():
    return harness.run(WORKLOAD, 2**32 + 11, 0.3, False, time.perf_counter(),
                       device="cpu", cell=small())


def test_sound_runs_read_no_fault():
    for seed in (3, 2**35 + 1):
        nums, taints = tenant_control.readings(seed, False, "cpu",
                                               cell=small())
        assert sum(nums.values()) == 0, nums
        # six team taints over the 240 team nodes; a check a group and set
        assert taints["nodes"] == 240 and taints["taint_sets"] == 6
        assert taints["checks"] == 36 * 6
    out = _run()
    assert out["correct"] and out["checks"]["faults"]["value"] == 0
    assert out["judged"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("seed", (4, 2**35 + 2, 77))
def test_the_control_reads_faults(seed):
    nums, _ = tenant_control.readings(seed, True, "cpu", cell=small())
    assert nums["taint_violation"] > 0, nums


PLANTED = (("foreign_node", "taint_violation"),
           ("foreign_node", "selector_violation"),
           ("lower_pool", "pool_mismatch"),
           ("selector_dropped", "selector_violation"))


@pytest.mark.parametrize("plant,kind", PLANTED)
def test_each_plant_reads_faults(plant, kind):
    nums, _ = tenant_control.readings(5, True, "cpu", cell=small(),
                                      plant=plant)
    assert nums[kind] > 0, nums


@pytest.mark.parametrize("kind", ("unchanged", "half", "altered"))
def test_a_broken_solve_is_not_correct(monkeypatch, kind):
    _solve_fault(monkeypatch, kind)
    out = _run()
    assert not out["correct"], out["fault_kinds"]
    assert out["checks"]["faults"]["value"] > 0


def test_the_cell_loads_neither_jax_nor_the_jax_package():
    r = _guarded(("jax", "jaxlib", "flax", "karpenter_tpu"), """
        import time
        sys.path.insert(0, sys.argv[2] + "/benchmark/tests")
        from test_bench_tenants import small
        from benchmark import harness
        out = harness.run("solve-tenants-5k-nodes", 5, 0.5, False,
                          time.perf_counter(), device="cpu", cell=small())
        assert out["correct"], out
        loaded = {m.split(".")[0] for m in sys.modules}
        assert "karpenter_tpu_torch" in loaded
        assert not loaded & {"jax", "jaxlib", "flax", "karpenter_tpu"}
        print("ok")
    """)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")


def test_the_reference_and_spec_load_no_part_of_the_program():
    r = _guarded(("jax", "jaxlib", "flax", "karpenter_tpu",
                  "karpenter_tpu_torch"), """
        import benchmark.reference.tenant_check
        import benchmark.tenant_spec
        print("ok")
    """)
    assert r.returncode == 0, r.stderr[-3000:]


def test_taints_ms_reads_the_spans_self_time():
    read = harness.reader("taints_ms.solve")
    one = [("solve", 0.0, 10.0, -1), ("encode.nodes", 1.0, 3.0, 0),
           ("encode.taints", 2.0, 2.004, 1)]
    ctx = SimpleNamespace(spans=[one, one], starts=[0.0, 10.0],
                          ends=[10.0, 20.0])
    assert read(ctx) == pytest.approx(4.0)
    # a program without the span reads nothing
    assert read(SimpleNamespace(spans=[one[:2]], starts=[0.0],
                                ends=[10.0])) is None
