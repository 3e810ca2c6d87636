"""The check that decides ``correct``: sound runs read no fault, the
control (a stated guarantee broken) reads faults, and a run whose timed
path is broken underneath comes out not correct, once for each fault the
cells can have: a pass that returns its state unchanged, half of the
batch left out, an answer altered where it is produced. (No cell spans
chips, so no exchange between chips can be left out.) A pack that wastes
nodes with valid placements, a claim for every pod or the existing nodes
left empty, comes out not correct too."""

import dataclasses
import time

import pytest

from bench_support import cuda_device, small  # noqa: F401 (fixtures)

from benchmark import control, harness

SOLVES = ("solve-burst-cold", "solve-burst-5k-nodes")
CELLS = SOLVES + ("consolidate-multi-5k",)


def _run(small, workload):
    return harness.run(workload, 2**32 + 11, 0.3, False, time.perf_counter(),
                       device="cpu", cell=small(workload))


@pytest.mark.parametrize("workload", CELLS)
def test_sound_runs_read_no_fault(small, workload):
    for seed in (3, 2**35 + 1):
        assert sum(control.readings(workload, seed, False, "cpu",
                                    cell=small(workload)).values()) == 0
    out = _run(small, workload)
    assert out["correct"] and out["checks"]["faults"]["value"] == 0
    assert out["judged"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_reads_faults(small, workload):
    for seed in (4, 2**35 + 2, 77):
        assert sum(control.readings(workload, seed, True, "cpu",
                                    cell=small(workload)).values()) > 0


# -- faults planted under the timed path --------------------------------------

def _solve_fault(monkeypatch, kind):
    from karpenter_tpu_torch.provisioning.tensor_scheduler import \
        TensorScheduler
    solve = TensorScheduler.solve
    first = {}

    def broken(ts, pods, *a, **kw):
        if kind == "unchanged":
            if "results" not in first:
                first["results"] = solve(ts, pods, *a, **kw)
            ts.partition = (len(pods), 0)
            return first["results"]
        if kind == "half":
            results = solve(ts, pods[: len(pods) // 2], *a, **kw)
            ts.partition = (len(pods), 0)
            return results
        results = solve(ts, pods, *a, **kw)
        claim = results.new_nodeclaims[0]
        claim.instance_type_options = claim.instance_type_options[:-1]
        return results

    monkeypatch.setattr(TensorScheduler, "solve", broken)


@pytest.mark.parametrize("kind", ("unchanged", "half", "altered"))
@pytest.mark.parametrize("workload", SOLVES)
def test_a_broken_solve_is_not_correct(small, monkeypatch, workload, kind):
    _solve_fault(monkeypatch, kind)
    out = _run(small, workload)
    assert not out["correct"], out["fault_kinds"]
    assert out["checks"]["faults"]["value"] > 0


def _decision_fault(monkeypatch, kind):
    from karpenter_tpu_torch.disruption.methods import \
        MultiNodeConsolidation
    from karpenter_tpu_torch.disruption.types import Command
    compute = MultiNodeConsolidation.compute_command

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

    monkeypatch.setattr(MultiNodeConsolidation, "compute_command", broken)


@pytest.mark.parametrize("kind", ("unchanged", "half", "altered"))
def test_a_broken_decision_is_not_correct(small, monkeypatch, kind):
    _decision_fault(monkeypatch, kind)
    out = _run(small, "consolidate-multi-5k")
    assert not out["correct"], out["fault_kinds"]
    assert out["checks"]["faults"]["value"] > 0


# -- faults of the pack's, planted in its answer ------------------------------

PLANTED = (("solve-burst-cold", "claim_per_pod", "claims_mergeable"),
           ("solve-burst-5k-nodes", "claim_per_pod", "claims_mergeable"),
           ("solve-burst-5k-nodes", "existing_ignored",
            "existing_room_unused"))


@pytest.mark.parametrize("workload,plant,kind", PLANTED)
def test_a_wasteful_pack_is_not_correct(small, monkeypatch, workload, plant,
                                        kind):
    """A claim for every pod, or the existing nodes left empty, each claim
    with the right options: valid placements, caught by the pack's own
    rules."""
    nums = control.readings(workload, 5, True, "cpu", cell=small(workload),
                            plant=plant)
    assert nums[kind] > 0 and nums["option_mismatch"] == 0, nums
    from benchmark.drivers import solve
    answer = solve.Driver.answer
    monkeypatch.setattr(solve.Driver, "answer",
                        lambda d, kept, calls: control.PLANTS[plant](
                            d, answer(d, kept, calls)))
    out = _run(small, workload)
    assert not out["correct"] and out["fault_kinds"][kind] > 0
