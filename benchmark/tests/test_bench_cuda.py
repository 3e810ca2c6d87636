"""The harness on the card at a small size: a traced run of each cell is
correct, sees the device busy, and reads its per-layer metrics. Skips
without a card; on one: ``python -m pytest benchmark/tests -m cuda``."""

import time

import pytest

from bench_support import cuda_device, small  # noqa: F401 (fixtures)

CELLS = ("solve-burst-cold", "solve-burst-5k-nodes", "consolidate-multi-5k")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_run_on_the_card(small, cuda_device, workload):
    from benchmark import harness
    out = harness.run(workload, 2**31 + 9, 1.0, True, time.perf_counter(),
                      device=cuda_device, cell=small(workload))
    assert out["correct"], out["fault_kinds"]
    assert out["device"]["busy_s"] > 0
    assert 0 < out["device"]["busy_s"] < out["device"]["window_s"]
    for name, m in out["metrics"].items():
        if "roofline" in name:
            assert 0 < m["value"] <= 105, name
    assert out["breakdown"]["device_ops"]
