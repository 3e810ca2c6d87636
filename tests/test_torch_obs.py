"""The port's device observability (karpenter_tpu_torch.obs), on the CPU:
per-launch-shape device-time attribution (obs/device.py) on the single-
device and the mesh precompute, the memory watermarks, the per-kernel
costs it and chip_smoke.py share (ops/kernels.py), the torch.profiler
session facility (obs/profile.py) and Provisioner.profile_dir, the
SLOWatcher (obs/slo.py) with the port's flight recorder, and the trace
CLI. The cases of tests/test_obs_device.py and the SLOWatcher and dump-CLI
cases of tests/test_obs_tracing.py, on the port; those that need the
operator's HTTP server wait for the operator's port."""

import dataclasses
import json
import os

import pytest
import torch

from karpenter_tpu_torch.metrics.registry import SLO_BREACHES
from karpenter_tpu_torch.obs import device as obs_device
from karpenter_tpu_torch.obs.device import DEVICE_TIME, LaunchTimer
from karpenter_tpu_torch.obs.profile import PROFILER, ProfileError, Profiler
from karpenter_tpu_torch.obs.slo import SLOWatcher, parse_budgets
from karpenter_tpu_torch.obs.tracer import TRACER, Tracer, dumps_chrome
from karpenter_tpu_torch.ops import binpack, kernels
from karpenter_tpu_torch.utils.clock import FakeClock

import test_torch_support as support
from test_torch_support import (PORT, LiveEnv, build_problem, cpu_mesh,
                                mini_workload, nodepool, pod)
from test_torch_support import device_series_kept  # noqa: F401 (autouse)


class _StepClock:
    """Manual monotonic clock for duration injection."""

    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        return self.t

    def step(self, s: float) -> None:
        self.t += s


def _solve(n=12, **kw):
    its = support.pkg(PORT).kwok.construct_instance_types()[:n]
    ts = support.scheduler(PORT, [nodepool(PORT)], {"default": its}, **kw)
    ts.solve([pod(PORT, f"p-{i}", cpu="250m") for i in range(8)])
    assert ts.fallback_reason == ""
    return ts


def _nbytes(*tensors) -> int:
    flat = []
    for t in tensors:
        flat.extend(_nbytes_leaves(t))
    return sum(x.numel() * x.element_size() for x in flat)


def _nbytes_leaves(t):
    if isinstance(t, torch.Tensor):
        return [t]
    return [x for item in t for x in _nbytes_leaves(item)]


# -- device-time attribution -------------------------------------------------

class TestDeviceTimeAttribution:
    def test_solve_records_per_launch_stats(self):
        DEVICE_TIME.clear()
        _solve()
        snap = DEVICE_TIME.snapshot()
        assert snap, "no launch registered by the solve"
        st = snap[0]
        assert st["executable"].startswith("x")
        assert st["kind"] == "single"
        assert st["devices"] == ["cpu"]
        assert st["dispatches"] >= 1
        assert st["dispatch_seconds"] >= 0.0
        # on the CPU the plain versions run inside the launch calls
        assert st["device_seconds"] > 0.0
        assert st["peak_bytes"] > 0
        assert st["flops"] > 0 and st["bytes_accessed"] > 0
        assert st["shapes"].startswith("G")

    def test_spans_split_dispatch_from_execute(self):
        _solve()
        trace = TRACER.last()
        names = [s.name for s in trace.spans]
        assert "device.dispatch" in names
        assert "device.execute" in names
        dispatch = next(s for s in trace.spans
                        if s.name == "device.dispatch")
        execute = next(s for s in trace.spans if s.name == "device.execute")
        assert dispatch.attrs["executable"] == execute.attrs["executable"]

    def test_memory_watermark_gauges_set(self):
        from karpenter_tpu_torch.metrics.registry import DEVICE_MEMORY_PEAK
        DEVICE_TIME.clear()
        _solve()
        marks = DEVICE_TIME.watermarks()
        assert marks, "no per-device watermark recorded"
        for dev, peak in marks.items():
            assert peak > 0
            assert DEVICE_MEMORY_PEAK.value({"device": dev}) == float(peak)

    def test_watermark_is_monotonic_max(self):
        DEVICE_TIME.clear()
        _solve(n=12)
        first = dict(DEVICE_TIME.watermarks())
        _solve(n=24)  # a bigger catalog, a bigger launch
        second = DEVICE_TIME.watermarks()
        for dev in first:
            assert second.get(dev, 0) >= first[dev]
        assert len(DEVICE_TIME.snapshot()) == 2

    def test_repeated_shape_adds_dispatches_to_one_entry(self):
        DEVICE_TIME.clear()
        _solve()
        _solve()
        (st,) = DEVICE_TIME.snapshot()
        assert st["dispatches"] == 2

    def test_disabled_tracer_records_nothing_and_adds_no_wait(
            self, monkeypatch):
        """Tracing off: no entry, and no LaunchTimer (no event, no
        synchronize) on the solve's path."""
        DEVICE_TIME.clear()

        def refuse(*a, **kw):
            raise AssertionError("a LaunchTimer with tracing off")
        monkeypatch.setattr(obs_device, "LaunchTimer", refuse)
        saved = TRACER.enabled
        try:
            TRACER.enabled = False
            _solve()
            _solve(mesh=cpu_mesh(PORT, 8))
        finally:
            TRACER.enabled = saved
        assert DEVICE_TIME.snapshot() == []

    def test_metrics_families_move(self):
        from karpenter_tpu_torch.metrics.registry import (
            DEVICE_DISPATCH_SECONDS, DEVICE_DISPATCHES,
            DEVICE_EXECUTE_SECONDS)
        DEVICE_TIME.clear()
        _solve()
        st = DEVICE_TIME.snapshot()[0]
        labels = {"executable": st["executable"]}
        assert DEVICE_DISPATCHES.value(labels) >= 1
        assert DEVICE_DISPATCH_SECONDS.value(labels) >= 0.0
        assert DEVICE_EXECUTE_SECONDS.value(labels) > 0.0

    def test_peak_bytes_are_the_launch_arguments_and_outputs(self):
        """precompute_cost's peak, counted from the tensors of one launch:
        its device arguments, K1's combined rows, the six outputs and
        their packed copy."""
        for n_nodes in (0, 1):
            workload = mini_workload(PORT)
            if not n_nodes:
                workload = workload[:2] + ([],) + workload[3:]
            _, problem = build_problem(PORT, workload)
            args, statics = binpack.device_args(
                dataclasses.replace(problem, device_cache=None),
                binpack.ArgPlacer(torch.device("cpu")))
            outs = binpack.precompute_kernel(*args, **statics)
            cmb, _ = kernels.combine_compat_plain(args[1], args[0], args[11])
            real = (_nbytes([a for a in args if a is not None]) + _nbytes(cmb)
                    + 2 * _nbytes(outs))
            shape = binpack.launch_shape(problem, statics["has_exist"])
            assert bool(shape["N"]) == statics["has_exist"]
            _, _, peak = binpack.precompute_cost(**shape)
            assert peak == real

    def test_mesh_launch_registers_a_mesh_entry(self):
        """The 4x2 CPU mesh: one "mesh" entry over its eight slots, whose
        peak sharded_memory_analysis reports for the same problem."""
        DEVICE_TIME.clear()
        mesh = cpu_mesh(PORT, 8)
        ts = _solve(mesh=mesh)
        mesh_entries = [s for s in DEVICE_TIME.snapshot()
                        if s["kind"] == "mesh"]
        assert len(mesh_entries) == 1
        st = mesh_entries[0]
        assert st["devices"] == ["cpu"] * 8
        assert st["dispatches"] >= 1 and st["device_seconds"] > 0.0
        assert st["peak_bytes"] > 0
        from karpenter_tpu_torch.parallel.mesh import sharded_memory_analysis
        from karpenter_tpu_torch.provisioning.grouping import partition_pods
        groups, _, _ = partition_pods(
            [pod(PORT, f"p-{i}", cpu="250m") for i in range(8)])
        problem, _, _ = ts.build_problem(groups)
        assert sharded_memory_analysis(problem, mesh) == st["peak_bytes"]
        assert len([s for s in DEVICE_TIME.snapshot()
                    if s["kind"] == "mesh"]) == 1

    def test_launch_timer_on_the_cpu_is_the_host_time(self):
        timer = LaunchTimer([torch.device("cpu")])
        sum(range(10000))
        dispatch = timer.launched()
        assert dispatch > 0 and timer.wait() == dispatch


# -- the per-kernel costs ----------------------------------------------------

def test_kernel_costs_count_the_bytes_of_real_launches():
    """Each kernel's cost (ops/kernels.py) moves the bytes of the inputs
    and outputs of one launch on the mini workload, with nodes."""
    _, problem = build_problem(PORT, mini_workload(PORT))
    args, statics = binpack.device_args(
        dataclasses.replace(problem, device_cache=None),
        binpack.ArgPlacer(torch.device("cpu")))
    (group, template, it, group_req, daemon, alloc, template_its, off_zone,
     off_captype, off_avail, zone_values, allow_undef, tol_template, exist,
     exist_avail, tol_exist) = args
    G, K, W = group.mask.shape
    M, T, N = template.mask.shape[0], it.mask.shape[0], exist.mask.shape[0]
    R, O, Z = group_req.shape[1], off_zone.shape[1], zone_values.shape[0]
    k1_in = (template, group, allow_undef)
    k1_out = kernels.combine_compat_plain(*k1_in)
    k2_in = (*k1_out, it, group_req, daemon, alloc, template_its, off_zone,
             off_captype, off_avail, zone_values, tol_template)
    kw = dict(zone_key=statics["zone_key"],
              captype_key=statics["captype_key"])
    k3_in = (group, group_req, exist, exist_avail, tol_exist)
    assert kernels.combine_compat_cost(M, G, K, W).bytes == \
        _nbytes(k1_in, k1_out)
    assert kernels.catalog_feasibility_cost(M, G, T, K, W, R, O, Z).bytes \
        == _nbytes(k2_in, kernels.catalog_feasibility_plain(*k2_in, **kw))
    assert kernels.exist_feasibility_cost(G, N, K, W, R).bytes == \
        _nbytes(k3_in, kernels.exist_feasibility_plain(*k3_in))
    fits = kernels.fits_matrix(group_req, exist_avail)
    assert kernels.fits_matrix_cost(N, G, R).bytes == \
        _nbytes((group_req, exist_avail, fits))
    assert kernels.fits_matrix_cost(N, G, R).ops == \
        2 * N * G * R + 2 * G * R
    assert kernels.row_splice_cost(_nbytes(exist_avail)) == \
        kernels.Cost(0, 2 * _nbytes(exist_avail))
    ops, accessed, _ = binpack.precompute_cost(G, M, T, N, K, W, R, O, Z)
    assert accessed == (_nbytes(k1_in, k1_out)
                        + kernels.catalog_feasibility_cost(
                            M, G, T, K, W, R, O, Z).bytes
                        + _nbytes(k3_in,
                                  kernels.exist_feasibility_plain(*k3_in)))
    assert ops == sum(c.ops for c in (
        kernels.combine_compat_cost(M, G, K, W),
        kernels.catalog_feasibility_cost(M, G, T, K, W, R, O, Z),
        kernels.exist_feasibility_cost(G, N, K, W, R)))


# -- the profiler ------------------------------------------------------------

class TestProfiler:
    def test_start_without_sanctioned_dir_rejected(self, monkeypatch):
        monkeypatch.delenv("KARPENTER_PROFILE_DIR", raising=False)
        p = Profiler()
        with pytest.raises(ProfileError, match="KARPENTER_PROFILE_DIR"):
            p.start()

    def test_start_stop_lifecycle(self, tmp_path):
        from karpenter_tpu_torch.metrics.registry import PROFILE_ACTIVE
        p = Profiler()
        out = p.start(str(tmp_path / "prof"))
        try:
            assert p.active and out == str(tmp_path / "prof")
            assert PROFILE_ACTIVE.value() == 1.0
            with pytest.raises(ProfileError, match="already running"):
                p.start(str(tmp_path / "other"))
            torch.ones(4) + 1
        finally:
            stopped = p.stop()
        assert stopped == out and not p.active
        assert PROFILE_ACTIVE.value() == 0.0
        assert os.path.dirname(p.last_trace) == out
        doc = json.loads(open(p.last_trace).read())
        assert doc["traceEvents"]
        with pytest.raises(ProfileError, match="no device profile"):
            p.stop()

    def test_env_dir_is_the_default(self, tmp_path, monkeypatch):
        monkeypatch.setenv("KARPENTER_PROFILE_DIR", str(tmp_path / "env"))
        p = Profiler()
        assert p.start() == str(tmp_path / "env")
        p.stop()

    def test_pass_scope_noop_while_session_active(self, tmp_path):
        p = Profiler()
        p.start(str(tmp_path / "ses"))
        try:
            with p.pass_scope(str(tmp_path / "pass")):
                pass
            assert not os.path.exists(str(tmp_path / "pass"))
        finally:
            p.stop()

    def test_provisioner_profile_dir_profiles_the_pass(self, tmp_path):
        """Provisioner.profile_dir: the pass runs inside one profiler
        session, whose Chrome trace lands in the directory; the gauge reads
        0 after; the decisions equal those of the unprofiled pass."""
        from karpenter_tpu_torch.metrics.registry import PROFILE_ACTIVE
        digests = []
        for profiled in (False, True):
            its = support.pkg(PORT).kwok.construct_instance_types()[:24]
            env = LiveEnv(PORT, its, pools=[nodepool(PORT)])
            for i in range(6):
                env.pending(f"p-{i}", cpu="500m")
            if profiled:
                env.provisioner.profile_dir = str(tmp_path / "pass")
            env.provision()
            digests.append(support.provisioning_digest(env))
        assert digests[0] == digests[1] and digests[0][0]
        files = os.listdir(tmp_path / "pass")
        assert len(files) == 1 and files[0].endswith(".json")
        assert PROFILE_ACTIVE.value() == 0.0 and not PROFILER.active


# -- the SLO watcher ---------------------------------------------------------

class TestSLOWatcher:
    def test_parse_budgets(self):
        assert parse_budgets("a=1.5, b=2") == {"a": 1.5, "b": 2.0}
        assert parse_budgets("") == {}
        with pytest.raises(ValueError):
            parse_budgets("nobudget")
        with pytest.raises(ValueError):
            parse_budgets("a=notanumber")
        for bad in ("a=0", "a=-1", "a=nan", "a=inf"):
            with pytest.raises(ValueError):
                parse_budgets(bad)

    def test_dump_files_bounded_and_restart_unique(self, tmp_path):
        class FakeRec:
            def dump_matching(self, path, trace_id):
                with open(path, "w") as f:
                    f.write(trace_id + "\n")
                return 1

        clk = _StepClock()
        tr = Tracer(now=clk.now)
        watcher = SLOWatcher({"pass": 0.5}, flightrec=FakeRec(),
                             dump_dir=str(tmp_path))
        watcher.MAX_DUMP_FILES = 2
        tr.watcher = watcher
        for _ in range(5):
            with tr.span("pass"):
                clk.step(1.0)  # every pass breaches
        files = sorted(tmp_path.iterdir())
        assert len(files) == 2  # oldest three deleted
        assert all(f.name.startswith(f"slo-breach-{watcher._file_tag}-")
                   for f in files)
        kept_ids = {f.read_text().strip() for f in files}
        assert kept_ids == {b.trace_id for b in list(watcher.breaches)[-2:]}

    def test_induced_breach_exactly_once(self, tmp_path):
        """A fake-clock inflated pass: exactly one breach increment, one
        warning event, and one flight-recorder dump of the port's record
        of the breaching pass."""
        from karpenter_tpu_torch.events.recorder import Recorder
        from karpenter_tpu_torch.flightrec import FlightRecorder
        clk = _StepClock()
        events_clock = FakeClock()
        recorder = Recorder(events_clock)
        rec = FlightRecorder(capacity=8)
        watcher = SLOWatcher({"provisioner.pass": 2.0}, recorder=recorder,
                             flightrec=rec, clock=events_clock,
                             dump_dir=str(tmp_path))
        before = SLO_BREACHES.value({"slo": "provisioner.pass"})
        prev_clock = TRACER.set_clock(clk.now)
        prev_watcher, TRACER.watcher = TRACER.watcher, watcher
        try:
            with TRACER.span("provisioner.pass"):
                its = support.pkg(PORT).kwok.construct_instance_types()[:12]
                ts = support.scheduler(PORT, [nodepool(PORT)],
                                       {"default": its})
                ts.flight_recorder = rec
                ts.solve([pod(PORT, f"p-{i}") for i in range(4)])
                clk.step(10.0)  # inflate the pass past its 2s budget
            trace = TRACER.last()
        finally:
            TRACER.set_clock(prev_clock)
            TRACER.watcher = prev_watcher
        assert trace.name == "provisioner.pass"
        assert SLO_BREACHES.value({"slo": "provisioner.pass"}) == before + 1
        breaches = [e for e in recorder.events if e.reason == "SLOBreached"]
        assert len(breaches) == 1
        assert trace.trace_id in breaches[0].message
        import pathlib
        dump = pathlib.Path(watcher.breaches[0].dump_path)
        assert dump.parent == tmp_path and dump.exists()
        dumped = [json.loads(line) for line in dump.read_text().splitlines()]
        assert len(dumped) == 1
        assert dumped[0]["meta"]["trace_id"] == trace.trace_id
        watcher.observe(trace)  # re-observation is a no-op
        assert SLO_BREACHES.value({"slo": "provisioner.pass"}) == before + 1
        assert len(watcher.breaches) == 1
        snap = watcher.snapshot()
        assert snap["breaches"][0]["trace_id"] == trace.trace_id
        assert snap["budgets"]["provisioner.pass"]["observed"] == 1

    def test_multiple_budgets_each_counted_one_dump(self, tmp_path):
        clk = _StepClock()
        tr = Tracer(now=clk.now)
        watcher = SLOWatcher({"pass": 2.0, "solve": 1.0},
                             dump_dir=str(tmp_path))
        tr.watcher = watcher
        before_pass = SLO_BREACHES.value({"slo": "pass"})
        before_solve = SLO_BREACHES.value({"slo": "solve"})
        with tr.span("pass"):
            clk.step(3.0)
            with tr.span("solve"):
                clk.step(1.5)
        assert SLO_BREACHES.value({"slo": "pass"}) == before_pass + 1
        assert SLO_BREACHES.value({"slo": "solve"}) == before_solve + 1
        assert {b.slo for b in watcher.breaches} == {"pass", "solve"}

    def test_dump_matching_failure_leaves_no_partial_file(self, tmp_path,
                                                          monkeypatch):
        import karpenter_tpu_torch.flightrec.record as rec_codec
        from karpenter_tpu_torch.flightrec import FlightRecorder
        from karpenter_tpu_torch.flightrec.recorder import FlightRecord
        rec = FlightRecorder(capacity=4)
        for i in range(2):
            rec._append(FlightRecord("provisioning", 0.0, 0.1,
                                     {"trace_id": "tX"}, {"d": i}))
        real = rec_codec.dumps_record
        calls = {"n": 0}

        def flaky(d):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("boom")
            return real(d)

        monkeypatch.setattr(rec_codec, "dumps_record", flaky)
        path = tmp_path / "dump.jsonl"
        with pytest.raises(RuntimeError):
            rec.dump_matching(str(path), "tX")
        assert not path.exists()

    def test_within_budget_no_breach(self):
        clk = _StepClock()
        tr = Tracer(now=clk.now)
        watcher = SLOWatcher({"pass": 5.0})
        tr.watcher = watcher
        with tr.span("pass"):
            clk.step(1.0)
        assert not watcher.breaches
        assert watcher.snapshot()["budgets"]["pass"]["observed"] == 1
        assert watcher.snapshot()["budgets"]["pass"]["p99"] == \
            pytest.approx(1.0)

    def test_unwatched_spans_ignored(self):
        clk = _StepClock()
        tr = Tracer(now=clk.now)
        watcher = SLOWatcher({"other": 0.1})
        tr.watcher = watcher
        with tr.span("pass"):
            clk.step(10.0)
        assert not watcher.breaches


# -- the package surface and the trace CLI -------------------------------------

def test_obs_exports_what_the_reference_exports():
    import karpenter_tpu.obs as jobs
    import karpenter_tpu_torch.obs as tobs
    assert sorted(tobs.__all__) == sorted(jobs.__all__)
    for name in tobs.__all__:
        assert getattr(tobs, name) is not None


class TestDumpCLI:
    def test_dump_and_show_roundtrip(self, tmp_path, capsys):
        from karpenter_tpu_torch.obs.__main__ import main
        _solve()
        out = tmp_path / "trace.json"
        assert main(["dump", "--out", str(out)]) == 0
        doc = json.loads(out.read_text())
        assert doc["traceEvents"]
        assert all(e["ph"] == "X" for e in doc["traceEvents"])
        assert main(["show", str(out)]) == 0
        text = capsys.readouterr().out
        assert "root=" in text and "traces" in text

    def test_dump_out_dash_means_stdout(self, tmp_path, capsys, monkeypatch):
        from karpenter_tpu_torch.obs.__main__ import main
        _solve()
        monkeypatch.chdir(tmp_path)
        assert main(["dump", "--out", "-"]) == 0
        assert json.loads(capsys.readouterr().out)["traceEvents"]
        assert not (tmp_path / "-").exists()

    def test_show_prints_exclusive_times(self, tmp_path, capsys):
        from karpenter_tpu_torch.obs.__main__ import main
        clk = _StepClock()
        tr = Tracer(now=clk.now)
        with tr.span("root"):
            with tr.span("parent"):
                clk.step(1.0)
                with tr.span("child"):
                    clk.step(3.0)
            clk.step(0.5)
        out = tmp_path / "t.json"
        out.write_text(dumps_chrome(tr.traces()))
        assert main(["show", str(out)]) == 0
        lines = capsys.readouterr().out.splitlines()
        parent = next(ln for ln in lines if ln.strip().startswith("parent"))
        child = next(ln for ln in lines if ln.strip().startswith("child"))
        assert "1000.000 ms" in parent
        assert "3000.000 ms" in child

    def test_exclusive_micros_clips_overlap_to_parent_interval(self):
        from karpenter_tpu_torch.obs.__main__ import _exclusive_micros
        evs = [
            {"name": "a", "ts": 0.0, "dur": 10_000.0, "tid": 1},
            {"name": "b", "ts": 5_000.0, "dur": 10_000.0, "tid": 1},
            {"name": "c", "ts": 12_000.0, "dur": 2_000.0, "tid": 1},
        ]
        totals = _exclusive_micros(evs)
        assert totals["a"] == pytest.approx(5_000.0)
        assert totals["b"] == pytest.approx(8_000.0)
        assert totals["c"] == pytest.approx(2_000.0)
        assert _exclusive_micros(list(reversed(evs))) == totals

