"""The port's stage spans and counters (karpenter_tpu_torch.obs.tracer), on
the CPU: the solve's ``partition`` span, ``get_candidates``'s
``disruption.candidates``, the collector's pauses on the trace's root, the
pack's inputs and its existing-node fill time and scan on the ``pack``
span, the existing-node encode's row counts on ``encode.nodes``, the
toleration matrix's counts on ``encode.taints`` and the NodePools on the
root, and the spans as ``user_annotation`` ranges of a ``torch.profiler``
session."""

import gc
import json

import pytest
import torch

from karpenter_tpu_torch.api import labels as L
from karpenter_tpu_torch.metrics.registry import GC_PAUSE_SECONDS
from karpenter_tpu_torch.obs.tracer import TRACER

import test_torch_support as support
from test_torch_support import (PORT, mini_workload, pod,
                                underutilized_fleet)
from test_torch_support import device_series_kept  # noqa: F401 (autouse)
from test_torch_support import tracer_kept  # noqa: F401 (autouse)


def _span(trace, name):
    return next(s for s in trace.spans if s.name == name)


def _mini_solve(**kw):
    pools, its, nodes, pods = mini_workload(PORT)
    ts = support.scheduler(PORT, pools, its, state_nodes=nodes, **kw)
    results = ts.solve(pods)
    assert ts.fallback_reason == ""
    return ts, results, pods


# -- the solve's partition ---------------------------------------------------

def test_solve_trace_holds_partition_under_solve():
    ts, _, pods = _mini_solve()
    trace = TRACER.last()
    assert trace.root.name == "solve"
    part = _span(trace, "partition")
    assert part.parent == trace.root.index
    assert part.attrs == {"groups": 6, "leftover": 0}
    assert ts.partition == (len(pods), 0)
    # it comes first: the encode and the pack start after it ends
    assert part.end <= _span(trace, "build_problem").start


def test_solve_trace_holds_the_pack_inputs_before_the_pack():
    _mini_solve()
    trace = TRACER.last()
    inputs = _span(trace, "pack.inputs")
    assert inputs.parent == trace.root.index
    nodes = len(mini_workload(PORT)[2])
    assert nodes > 0 and inputs.attrs == {"nodes": nodes}
    assert _span(trace, "topo.counts").end <= inputs.start
    assert inputs.end <= _span(trace, "pack").start


# -- get_candidates ----------------------------------------------------------

def test_get_candidates_opens_disruption_candidates_with_its_counts():
    env = underutilized_fleet(PORT, 6)
    # one node kept by a do-not-disrupt pod: a blocked candidate
    env.store.create(env.k.objects.Pod(
        metadata=env.k.objects.ObjectMeta(
            name="kept", namespace="default",
            annotations={L.DO_NOT_DISRUPT_ANNOTATION_KEY: "true"}),
        spec=env.k.objects.PodSpec(node_name="bench-node-00003"),
        status=env.k.objects.PodStatus(phase="Running")))
    method = env.lv.methods.MultiNodeConsolidation(env.cluster,
                                                   env.provisioner)
    with TRACER.span("caller"):
        cands = env.lv.helpers.get_candidates(env.cluster, env.provisioner,
                                              method.should_disrupt)
    trace = TRACER.last()
    sp = _span(trace, "disruption.candidates")
    assert sp.parent == trace.root.index
    assert sp.attrs == {"nodes": 6, "candidates": len(cands), "blocked": 1}
    assert len(cands) == 5
    assert "bench-node-00003" not in {c.name for c in cands}


# -- the collector -----------------------------------------------------------

def _pauses() -> dict:
    return {g: GC_PAUSE_SECONDS.value({"generation": g}) for g in "012"}


def test_a_collection_inside_a_trace_is_charged_to_its_root():
    before = _pauses()
    with TRACER.span("gc.root"):
        with TRACER.span("gc.inner"):
            gc.collect(2)
    attrs = TRACER.last().root.attrs
    assert attrs["gc_full"] >= 1
    assert attrs["gc_ms"] > 0.0
    assert "gc_ms" not in _span(TRACER.last(), "gc.inner").attrs
    after = _pauses()
    assert after["2"] > before["2"]
    assert sum(after.values()) - sum(before.values()) == pytest.approx(
        attrs["gc_ms"] * 1e-3)


def test_no_collection_is_charged_outside_a_trace_or_with_the_tracer_off():
    before = _pauses()
    gc.collect(2)                       # no trace open on this thread
    saved = TRACER.enabled
    try:
        TRACER.enabled = False
        with TRACER.span("gc.off"):
            gc.collect(2)
        TRACER.enabled = True
        with TRACER.span("gc.switched"):
            TRACER.enabled = False      # a trace open, the tracer off
            gc.collect(2)
            TRACER.enabled = True
    finally:
        TRACER.enabled = saved
    assert _pauses() == before
    attrs = TRACER.last().root.attrs
    assert not {"gc_ms", "gc_full", "gc_young"} & set(attrs)


# -- the pack's existing-node fill ------------------------------------------

def test_pack_span_carries_the_existing_fill_time(monkeypatch):
    from karpenter_tpu_torch.ops import binpack
    calls = []
    fill = binpack.Packer._fill_existing

    def counted(packer, *a, **kw):
        calls.append(len(packer.exist_order))
        return fill(packer, *a, **kw)
    monkeypatch.setattr(binpack.Packer, "_fill_existing", counted)
    ts, results, pods = _mini_solve()
    pack = _span(TRACER.last(), "pack")
    assert any(en.pods for en in results.existing_nodes)
    assert 0.0 < pack.attrs["existing_ms"] < pack.duration * 1e3
    # the nodes whose cap a fill computed, at most all nodes a call
    assert 0 < pack.attrs["existing_scanned"] <= sum(calls)


def test_pack_is_not_timed_with_the_tracer_off():
    from karpenter_tpu_torch.ops import binpack
    pools, its, nodes, pods = mini_workload(PORT)
    ts = support.scheduler(PORT, pools, its, state_nodes=nodes)
    seen = []
    pack = binpack.Packer.pack

    def kept(packer, *a, **kw):
        out = pack(packer, *a, **kw)
        seen.append((packer._timed, packer.existing_ms,
                     packer.existing_scanned, out))
        return out
    saved = TRACER.enabled
    try:
        binpack.Packer.pack = kept
        TRACER.enabled = False
        ts.solve(pods)
    finally:
        binpack.Packer.pack = pack
        TRACER.enabled = saved
    ((timed, existing_ms, scanned, out),) = seen
    assert not timed and existing_ms == 0.0 and scanned == 0
    assert out.existing    # the fill ran, untimed


# -- the existing-node encode ------------------------------------------------

@pytest.mark.parametrize("daemons", [0, 1])
def test_node_encode_span_counts_its_columnar_and_per_node_rows(daemons):
    pools, its, nodes, pods = mini_workload(PORT)
    ds = [pod(PORT, "ds", "100m")] if daemons else []
    ts = support.scheduler(PORT, pools, its, state_nodes=nodes,
                           daemonset_pods=ds)
    ts.solve(pods)
    assert ts.fallback_reason == ""
    sp = _span(TRACER.last(), "encode.nodes")
    n = len(nodes)
    assert n > 0 and sp.attrs["nodes"] == n
    # every row from the label table; with a daemonset pod to place, each
    # node's overhead check is a per-node step
    assert (sp.attrs["columnar"], sp.attrs["per_node"]) == \
        ((0, n) if daemons else (n, 0))


def test_a_memo_hit_of_the_node_encode_builds_no_row():
    pools, its, nodes, pods = mini_workload(PORT)
    ts = support.scheduler(PORT, pools, its, state_nodes=nodes)
    groups, _, _ = support.pkg(PORT).grouping.partition_pods(pods)
    first, _, _ = ts.build_problem(groups)
    second, _, _ = ts.build_problem(groups)
    sp = _span(TRACER.last(), "encode.nodes")
    assert (sp.attrs["columnar"], sp.attrs["per_node"]) == (0, 0)
    # a hit hands out copies of the first call's arrays
    assert second.exist_enc.mask is not first.exist_enc.mask
    assert (second.exist_enc.mask == first.exist_enc.mask).all()
    assert (second.exist_avail == first.exist_avail).all()


# -- the existing-node toleration matrix -------------------------------------

def _tainted_solve(taints_of):
    """A solve of mini_workload's pods (two of its six deployments
    tolerating ``dedicated``) against its nodes and ten more, each node
    with the taints ``taints_of(i)``."""
    k = support.pkg(PORT)
    o = k.objects
    pools, its, nodes, pods = mini_workload(PORT)
    nodes = nodes + [support.state_node(PORT, f"extra-{i}", "default", "4",
                                        "8Gi", True) for i in range(10)]
    for i, sn in enumerate(nodes):
        sn.node.spec.taints = [o.Taint(key=key, value=v, effect="NoSchedule")
                               for key, v in taints_of(i)]
    for p in pods:
        if p.metadata.labels["app"] in ("deploy-0", "deploy-3"):
            p.spec.tolerations = [o.Toleration(key="dedicated",
                                               operator="Exists")]
    ts = support.scheduler(PORT, pools, its, state_nodes=nodes)
    ts.solve(pods)
    assert ts.fallback_reason == ""
    return TRACER.last(), nodes, pools


def test_taint_span_counts_tainted_nodes_distinct_sets_and_checks():
    # three sets, one of them in two orders: (a), (b), (a, b) = (b, a)
    sets = ([], [("dedicated", "a")], [("dedicated", "b")],
            [("dedicated", "a"), ("dedicated", "b")],
            [("dedicated", "b"), ("dedicated", "a")])
    trace, nodes, pools = _tainted_solve(lambda i: sets[i % len(sets)])
    spans = [s for s in trace.spans if s.name == "encode.taints"]
    assert len(spans) == 1
    sp = spans[0]
    assert sp.parent == _span(trace, "encode.nodes").index
    groups = _span(trace, "partition").attrs["groups"]
    tainted = sum(1 for i in range(len(nodes)) if sets[i % len(sets)])
    assert sp.attrs == {"nodes": tainted, "taint_sets": 3,
                        "checks": groups * 3}
    assert trace.root.attrs["nodepools"] == len(pools) == 2


def test_taint_span_of_an_untainted_fleet_makes_no_check():
    trace, _, _ = _tainted_solve(lambda i: [])
    sp = _span(trace, "encode.taints")
    assert sp.attrs == {"nodes": 0, "taint_sets": 0, "checks": 0}


# -- the profiler's ranges ---------------------------------------------------

def _ranges(path) -> list:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_a_profiled_solve_carries_its_spans_as_nested_ranges(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as session:
        _mini_solve()
    path = tmp_path / "solve.json"
    session.export_chrome_trace(str(path))
    ranges = _ranges(path)
    by_name = {}
    for name, start, end in ranges:
        by_name.setdefault(name, []).append((start, end))
    for name in ("solve", "partition", "precompute", "pack"):
        assert len(by_name.get(name, ())) == 1, (name, sorted(by_name))
    (solve,) = by_name["solve"]
    order = []
    for name in ("partition", "precompute", "pack"):
        ((start, end),) = by_name[name]
        assert solve[0] <= start <= end <= solve[1], name
        order.append(start)
    assert order == sorted(order)
    # every span of the solve's trace became a range
    assert {s.name for s in TRACER.last().spans} <= set(by_name)


def test_no_range_is_opened_without_a_session_and_a_mispaired_exit_closes(
        tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with TRACER.span("quiet") as quiet:
        assert quiet._range is None
    with profile(activities=[ProfilerActivity.CPU]) as session:
        outer_ctx = TRACER.span("outer")
        outer = outer_ctx.__enter__()
        child = TRACER.span("abandoned").__enter__()
        assert outer._range is not None and child._range is not None
        outer_ctx.__exit__(None, None, None)   # closes over the open child
        assert outer._range is None and child._range is None
    path = tmp_path / "mispaired.json"
    session.export_chrome_trace(str(path))
    assert {"outer", "abandoned"} <= {name for name, _, _ in _ranges(path)}
