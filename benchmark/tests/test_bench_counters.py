"""The readers of the program's own spans and counters on hand-built
inputs: the time outside every program span, the self time of
``partition`` and ``disruption.candidates``, and the attributes of the
window's traces (``benchmark/counters.py``), a trace outside the window
left out. On a card (``-m cuda``): the program's ``precompute`` range holds
every K1-K3 launch of a profiled solve."""

import json
from types import SimpleNamespace

import pytest

from bench_support import cuda_device, small  # noqa: F401 (fixtures)
from benchmark import counters, harness

# a pass [0, 10]: root solve [0.5, 9.5]; partition [1, 3] with a child
# [2, 2.5]; pack [4, 8]
PASS = [("solve", 0.5, 9.5, -1), ("partition", 1.0, 3.0, 0),
        ("x", 2.0, 2.5, 1), ("pack", 4.0, 8.0, 0)]


def _ctx(starts, ends, spans=()):
    return SimpleNamespace(starts=list(starts), ends=list(ends),
                           spans=list(spans), shapes=[], device=None,
                           setup_s=0.0)


def test_unspanned_is_the_pass_less_every_non_root_self_time():
    read = harness.reader("unspanned_ms.solve")
    # self time 1.5 + 0.5 + 4 = 6 of a 10 s pass, then a 4 s pass holding
    # only its root
    ctx = _ctx([0.0, 10.0], [10.0, 14.0], [PASS, [("solve", 10, 14, -1)]])
    assert read(ctx) == pytest.approx((4.0 + 4.0) * 1e3 / 2)
    assert harness.reader("unspanned_ms.decision") is not None
    assert read(_ctx([0.0], [1.0])) is None


def test_stage_readers_take_their_spans_self_time():
    ctx = _ctx([0.0], [10.0], [PASS])
    assert harness.reader("partition_ms.solve")(ctx) == pytest.approx(1.5e3)
    assert harness.reader("candidates_ms.decision")(ctx) is None
    dec = [("bench.decision", 0, 5, -1), ("bench.candidates", 0, 3, 0),
           ("disruption.candidates", 0.5, 2.5, 1)]
    ctx = _ctx([0.0, 5.0], [5.0, 9.0], [dec, dec])
    assert harness.reader("candidates_ms.decision")(ctx) == \
        pytest.approx(2e3)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture
def ring(monkeypatch):
    """A tracer of the program's on a manual clock, standing in for the
    process-wide one the readers read."""
    from karpenter_tpu_torch.obs import tracer as tracer_mod
    clock = _Clock()
    tracer = tracer_mod.Tracer(now=clock)
    monkeypatch.setattr(tracer_mod, "TRACER", tracer)

    def trace(at, gc_ms=None, existing_ms=None):
        clock.t = at
        with tracer.span("solve") as root:
            if gc_ms is not None:
                root.set(gc_ms=gc_ms)
            with tracer.span("pack") as sp:
                if existing_ms is not None:
                    sp.set(existing_ms=existing_ms)
                clock.t = at + 0.5
    return trace


def test_counters_read_the_windows_traces_alone(ring):
    ring(1.0, gc_ms=1000.0, existing_ms=1000.0)   # before the window
    ring(10.0, gc_ms=30.0, existing_ms=200.0)
    ring(11.0, existing_ms=100.0)                 # no collection
    ring(12.0, gc_ms=60.0, existing_ms=300.0)
    ring(20.0, gc_ms=1000.0, existing_ms=1000.0)  # after the window
    ctx = _ctx([10.0, 11.0, 12.0], [11.0, 12.0, 13.0])
    assert [t.root.start for t in counters.window_traces(ctx)] == \
        [10.0, 11.0, 12.0]
    assert harness.reader("gc_ms.decision")(ctx) == pytest.approx(30.0)
    assert harness.reader("pack_existing_ms.solve")(ctx) == \
        pytest.approx(200.0)


def test_counters_find_nothing_where_the_program_has_no_counter(ring):
    ring(10.0)
    ring(11.0)
    ctx = _ctx([10.0, 11.0], [11.0, 12.0])
    assert harness.reader("gc_ms.decision")(ctx) is None
    assert harness.reader("pack_existing_ms.solve")(ctx) is None
    assert counters.window_traces(_ctx([], [])) == []


KERNELS = ("combine_compat", "catalog_feasibility", "exist_feasibility")


@pytest.mark.cuda
def test_every_kernel_launch_lies_inside_the_programs_precompute_range(
        small, cuda_device, tmp_path):
    from benchmark import devtrace
    from benchmark.drivers.solve import Driver
    _, cfg, traffic, _, _ = small("solve-burst-5k-nodes")
    driver = Driver(cfg, traffic, 2**31 + 11, cuda_device)
    assert driver.step(0)[0] == ""                # warm: the library, shapes
    session = devtrace.session()
    with session:
        assert driver.step(1)[0] == ""
    path = tmp_path / "solve.json"
    session.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events if e.get("cat") == "user_annotation"
              and e["name"] == "precompute"]
    launch_at = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("cat") in devtrace.LAUNCH_CATS
                 and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"
               and any(k in e["name"] for k in KERNELS)]
    assert len(ranges) == 1
    assert {k for k in KERNELS if any(k in e["name"] for e in kernels)} \
        == set(KERNELS)
    for e in kernels:
        at = launch_at[e["args"]["correlation"]]
        assert any(lo <= at <= hi for lo, hi in ranges), e["name"]
