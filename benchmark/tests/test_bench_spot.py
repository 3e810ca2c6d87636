"""The spot cell's check, on the CPU at a small size: sound runs read no
fault; the control (the launch-time prices served in place of the current
ones) reads faults; the three plants of the spot rules (options not
capped at 15, a replacement under the 15-type floor, the least costly
winnable candidates skipped) come out not correct; and so do the three
faults a decision's timed path can have: a pass that returns its state
unchanged, half of the command left out, an answer altered where it is
produced. Beside them: the cell loads neither JAX nor the JAX package,
its reference and spec load no part of the program, and its readers take
their spans' self time."""

import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import pytest

import bench_support  # noqa: F401 (the repository root on the path)
from test_bench_imports import _run as _guarded

from benchmark import harness, spot_control
from benchmark.reference import spot_check

WORKLOAD = "spot-consolidation-2k6z"


def small():
    """The cell as BENCHMARK.json states it, cut to 200 nodes of 24
    deployments on 500 types."""
    cell, cfg, traffic, e2e, layer = harness.load_cell(WORKLOAD)
    cfg["catalog"]["count"] = 500
    cfg["fleet"].update(nodes=200, deployments=24)
    return cell, cfg, traffic, e2e, layer


def _run():
    return harness.run(WORKLOAD, 2**32 + 11, 0.3, False, time.perf_counter(),
                       device="cpu", cell=small())


def test_sound_runs_read_no_fault():
    for seed in (3, 2**35 + 1):
        nums, counts = spot_control.readings(WORKLOAD, seed, False, "cpu",
                                             cell=small())
        assert sum(nums.values()) == 0, nums
        # one vector for every group, one of the winner's options
        assert counts["won_replace"] >= 1 and counts["vectors"] == 2, counts
    out = _run()
    assert out["correct"] and out["checks"]["faults"]["value"] == 0
    assert out["judged"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("seed", (4, 2**35 + 2, 77))
def test_the_control_reads_faults(seed):
    nums, _ = spot_control.readings(WORKLOAD, seed, True, "cpu", cell=small())
    assert sum(nums.values()) > 0, nums


PLANTED = (("uncapped", "option_mismatch"),
           ("under_floor", "wrong_candidate"),
           ("costlier", "wrong_candidate"))


@pytest.mark.parametrize("plant,kind", PLANTED)
def test_a_planted_spot_fault_is_not_correct(monkeypatch, plant, kind):
    nums, _ = spot_control.readings(WORKLOAD, 5, True, "cpu", cell=small(),
                                    plant=plant)
    assert nums[kind] > 0, nums
    from benchmark.drivers import spot_consolidate
    answer = spot_consolidate.Driver.answer
    monkeypatch.setattr(spot_consolidate.Driver, "answer",
                        lambda d, kept, calls: spot_control.PLANTS[plant](
                            d, answer(d, kept, calls)))
    out = _run()
    assert not out["correct"] and out["fault_kinds"][kind] > 0


def test_a_fleet_of_cheapest_fits_is_judged_on_deletes_and_placements():
    """Under the ``node_type`` "cheapest" the nodes keep room, so a
    candidate's pods fit on the others: the command is a delete whose pods
    go to standing nodes, which the reference's room sums and placement
    checks judge. A pod placed twice, a pod left out and a node overfilled
    each read a placement fault."""
    from benchmark.drivers import spot_consolidate
    _, cfg, traffic, _, _ = small()
    cfg["fleet"]["node_type"] = "cheapest"
    d = spot_consolidate.Driver(cfg, traffic, 2**33 + 9, "cpu")
    why, kept = d.step(0)
    assert not why
    a = d.answer(kept, None)
    fl, verdicts = d.reference()
    assert a["decision"] == "delete" and a["placements"] and not a["claims"]
    assert "delete" in verdicts.values()
    assert sum(spot_check.check(fl, a, verdicts).values()) == 0
    (name, pods), *rest = a["placements"].items()
    full = next(n["name"] for j, n in enumerate(d.fleet["nodes"])
                if n["name"] not in a["placements"]
                and n["name"] not in a["candidates"]
                and np.any(fl.room[j] < fl.req[fl.pod_node[pods[0]]]))
    for bad in ({name: pods + pods[:1]}, {name: pods[1:]},
                {name: pods[1:], full: pods[:1]}):
        broken = {**a, "placements": {**dict(rest), **bad}}
        faults = spot_check.check(fl, broken, verdicts)
        assert faults["placement_violation"] > 0, (bad, faults)


def test_an_unknown_node_type_is_refused():
    from benchmark import spot_spec
    _, cfg, _, _, _ = small()
    cfg["fleet"]["node_type"] = "largest"
    with pytest.raises(ValueError):
        spot_spec.fleet(cfg, spot_spec.catalog(cfg, 1), 1)


def _decision_fault(monkeypatch, kind):
    from karpenter_tpu_torch.disruption.methods import \
        SingleNodeConsolidation
    from karpenter_tpu_torch.disruption.types import Command
    compute = SingleNodeConsolidation.compute_command

    def broken(method, budgets, candidates):
        cmd, results = compute(method, budgets, candidates)
        if kind == "unchanged":
            return Command(reason=cmd.reason), None
        if kind == "half":
            return dataclasses.replace(
                cmd, candidates=cmd.candidates[: len(cmd.candidates) // 2]
            ), results
        from karpenter_tpu_torch.api.objects import Pod
        held = next(p.spec.node_name for p in method.cluster.store.list(Pod)
                    if p.metadata.annotations)
        protected = next(sn for sn in method.cluster.state_nodes()
                         if sn.name() == held)
        swapped = list(cmd.candidates)
        swapped[0] = dataclasses.replace(swapped[0], state_node=protected)
        return dataclasses.replace(cmd, candidates=swapped), results

    monkeypatch.setattr(SingleNodeConsolidation, "compute_command", broken)


@pytest.mark.parametrize("kind", ("unchanged", "half", "altered"))
def test_a_broken_decision_is_not_correct(monkeypatch, kind):
    _decision_fault(monkeypatch, kind)
    out = _run()
    assert not out["correct"], out["fault_kinds"]
    assert out["checks"]["faults"]["value"] > 0


# -- imports and readers -------------------------------------------------------

def test_a_spot_run_loads_neither_jax_nor_the_jax_package():
    r = _guarded(("jax", "jaxlib", "flax", "karpenter_tpu"), """
        sys.path.insert(0, sys.argv[2] + "/benchmark/tests")
        from test_bench_spot import _run
        assert _run()["correct"]
        loaded = {m.split(".")[0] for m in sys.modules}
        assert "karpenter_tpu_torch" in loaded
        print("ok")
    """)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")


def test_the_spot_reference_loads_no_part_of_the_program():
    r = _guarded(("jax", "jaxlib", "flax", "karpenter_tpu",
                  "karpenter_tpu_torch"), """
        import benchmark.reference.spot_check, benchmark.spot_spec
        print("ok")
    """)
    assert r.returncode == 0, r.stderr[-3000:]


def test_spot_readers_take_their_spans_self_time():
    dec = [("bench.decision", 0, 5, -1), ("disruption.snapshot", 0, 1, 0),
           ("encode.nodes", 0.2, 0.6, 1), ("disruption.loo", 1, 3, 0),
           ("disruption.prices", 1.5, 2, 3), ("disruption.prices", 2, 2.25, 3)]
    ctx = SimpleNamespace(starts=[0.0, 5.0], ends=[5.0, 10.0],
                          spans=[dec, dec], shapes=[], device=None,
                          setup_s=0.0)
    assert harness.reader("loo_ms.spot")(ctx) == pytest.approx(1.25e3)
    assert harness.reader("prices_ms.spot")(ctx) == pytest.approx(0.75e3)
    assert harness.reader("encode_ms.spot")(ctx) == pytest.approx(1e3)
    assert harness.reader("encode_ms.decision")(ctx) == pytest.approx(1e3)
    assert harness.reader("search_ms.decision")(ctx) == pytest.approx(1.25e3)
    # a program without the price span, as the parent: nothing to read
    ctx.spans = [[sp for sp in dec if sp[0] != "disruption.prices"]] * 2
    assert harness.reader("prices_ms.spot")(ctx) is None
