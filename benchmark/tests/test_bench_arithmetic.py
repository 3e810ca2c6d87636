"""The yardstick's arithmetic on fixed inputs: self time, percentiles,
time per pass, the frozen cost functions and the reading of a device
trace."""

import json

import pytest

import bench_support  # noqa: F401 (the repository root on the path)
from benchmark import devtrace, roofline, spans as S

# root [0, 10]; a [1, 4] with child b [2, 3]; c [5, 9]; a second a [9.5, 10]
SPANS = [("solve", 0.0, 10.0, -1), ("a", 1.0, 4.0, 0), ("b", 2.0, 3.0, 1),
         ("c", 5.0, 9.0, 0), ("a", 9.5, 10.0, 0)]


def test_self_time_discounts_children_and_sums_names():
    own = S.self_seconds(SPANS)
    assert own == pytest.approx({"a": 2.5, "b": 1.0, "c": 4.0})
    assert "solve" not in own


def test_self_time_of_an_overlapping_child_counts_only_the_inside():
    own = S.self_seconds([("r", 0.0, 4.0, -1), ("p", 1.0, 2.0, 0),
                          ("q", 1.5, 3.0, 1)])
    assert own == pytest.approx({"p": 0.5, "q": 1.5})


def test_self_ms_per_pass_averages_over_every_pass():
    assert S.self_ms_per_pass([SPANS, SPANS[:2]], ("a", "b")) == \
        pytest.approx((3.5 + 3.0) * 1e3 / 2)
    assert S.self_ms_per_pass([SPANS], ("nothing",)) is None


def test_percentile_is_nearest_rank_over_all_passes():
    values = list(range(1, 61))          # 60 passes
    assert S.percentile(values, 0.8) == 48
    assert S.percentile(values, 0.9) == 54
    assert S.percentile([5.0], 0.8) == 5.0
    assert S.percentile([3, 1, 2], 0.5) == 2


def test_time_per_pass_covers_the_whole_window():
    assert S.per_pass([0.0, 1.0, 2.5], [0.9, 2.4, 3.0]) == pytest.approx(1.0)


def test_innermost_span_at_a_time():
    assert S.innermost([SPANS], 2.5) == "b"
    assert S.innermost([SPANS], 4.5) == "solve"
    assert S.innermost([SPANS], 11.0) == ""


SHAPE = dict(G=120, M=1, T=2000, N=8192, K=9, W=64, R=4, O=8, Z=4)


def test_cost_functions_count_the_shapes_work():
    G, M, T, N, K, W, R, O, Z = (SHAPE[k] for k in "GMTNKWROZ")
    enc = lambda rows: rows * K * (4 * W + 3 + 8)  # noqa: E731
    assert roofline.combine_compat(M, G, K, W) == (
        2 * M * G * K * W + 12 * M * G * K,
        enc(M) + enc(G) + K + enc(M * G) + M * G)
    ops, nbytes = roofline.exist_feasibility(G, N, K, W, R)
    assert ops == G * N * (2 * K * W + 9 * K + 2 * R)
    assert nbytes == enc(G) + 4 * G * R + enc(N) + 4 * N * R + G * N \
        + 5 * G * N
    ops, nbytes = roofline.catalog_feasibility(M, G, T, K, W, R, O, Z)
    assert ops == M * G * T * (2 * K * W + 8 * K + 3 * R + 2 * O * Z)
    assert roofline.zone_words_bytes(4) == 1
    assert roofline.zone_words_bytes(9) == 2
    assert roofline.zone_words_bytes(20) == 4


def test_frozen_costs_equal_the_programs_counts_today():
    from karpenter_tpu_torch.ops import kernels
    G, M, T, N, K, W, R, O, Z = (SHAPE[k] for k in "GMTNKWROZ")
    assert roofline.combine_compat(M, G, K, W) == tuple(
        kernels.combine_compat_cost(M, G, K, W))
    assert roofline.catalog_feasibility(M, G, T, K, W, R, O, Z) == tuple(
        kernels.catalog_feasibility_cost(M, G, T, K, W, R, O, Z))
    assert roofline.exist_feasibility(G, N, K, W, R) == tuple(
        kernels.exist_feasibility_cost(G, N, K, W, R))


def test_least_time_sums_each_kernels_bound():
    s = dict(SHAPE, N=0)
    k1 = roofline.combine_compat(1, 120, 9, 64)
    k2 = roofline.catalog_feasibility(1, 120, 2000, 9, 64, 4, 8, 4)
    want = sum(max(b / roofline.HBM_BYTES_PER_S, o / roofline.INT32_OPS_PER_S)
               for o, b in (k1, k2))
    assert roofline.least_seconds(s) == pytest.approx(want)
    assert roofline.least_seconds(SHAPE) > want


def _trace(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def test_device_trace_reading(tmp_path):
    # two passes (host us 1000-2000 and 2000-3000); a precompute in each;
    # kernels launched inside them, one copy launched outside
    events = [
        _x("user_annotation", "bench.pass", 1000, 1000),
        _x("user_annotation", "bench.pass", 2000, 1000),
        _x("user_annotation", "bench.precompute", 1100, 100),
        _x("user_annotation", "bench.precompute", 2100, 100),
        _x("cuda_runtime", "cudaLaunchKernel", 1110, 5, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 2110, 5, correlation=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 1500, 5, correlation=3),
        _x("kernel", "k2", 1120, 30, correlation=1),
        _x("kernel", "k2", 2120, 50, correlation=2),
        _x("gpu_memcpy", "Memcpy HtoD", 1510, 20, correlation=3),
        _x("gpu_memcpy", "Memcpy HtoD", 1515, 20, correlation=3),
    ]
    host = [[("solve", 1.0, 2.0, -1), ("pack", 1.2, 1.9, 0)],
            [("solve", 2.0, 3.0, -1), ("pack", 2.2, 2.9, 0)]]
    d = devtrace.read(_trace(tmp_path, events), [1.0, 2.0], host, 2)
    assert d["window_s"] == pytest.approx(2000e-6)
    assert d["busy_s"] == pytest.approx((30 + 50 + 25) * 1e-6)
    assert d["precompute_busy_s"] == pytest.approx(80e-6)
    assert d["device_ops"][0] == ["k2", pytest.approx(80e-6)]
    length, = [g[1] for g in d["idle_gaps"][:1]]
    assert length == pytest.approx((3000 - 2170) * 1e-6)
    assert d["idle_gaps"][0][0] == "pack"


def test_device_trace_without_device_events_fails(tmp_path):
    events = [_x("user_annotation", "bench.pass", 0, 10)]
    with pytest.raises(devtrace.TraceError):
        devtrace.read(_trace(tmp_path, events), [0.0], [[]], launches=3)
    d = devtrace.read(_trace(tmp_path, events), [0.0], [[]], launches=0)
    assert d["busy_s"] == 0.0
