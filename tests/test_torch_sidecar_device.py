"""The port's sidecar owns a device: ``serve()`` and ``python -m
karpenter_tpu_torch.sidecar.server`` run on the card unless given
``device="cpu"`` / ``--device cpu`` and refuse to start without one; every
scheduler a replica builds (session, parity probe, legacy wire, one-shot)
and every session it restores solves on the replica's device; a kernel
failure reaches the client as a gRPC status that names the kernel, never
as an answer from the host. Then chip_smoke.py's sidecar phases on the
CPU at a small size, the plain versions counted as launches."""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import grpc
import pytest
import torch

import chip_smoke
from karpenter_tpu_torch.cloudprovider.kwok import (construct_catalog,
                                                    construct_instance_types)
from karpenter_tpu_torch.ops import kernels
from karpenter_tpu_torch.provisioning import tensor_scheduler as ts_mod
from karpenter_tpu_torch.sidecar import codec, wire
from karpenter_tpu_torch.sidecar import server as srv
from karpenter_tpu_torch.sidecar.client import RemoteScheduler, SolverSession

from test_torch_support import PORT, factories, fresh_registry, \
    plain_calls_counted, sidecar_server
from test_torch_support import device_series_kept  # noqa: F401 (autouse)
from test_torch_support import sidecar_state_kept  # noqa: F401 (autouse)
from test_torch_support import tracer_kept  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
F = factories(PORT)


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


class TestServeDevice:
    def test_serve_runs_on_the_card_unless_asked(self, monkeypatch):
        """Without CUDA, serve() with no device raises before it binds
        or touches the process (the collector stays enabled)."""
        import gc
        _no_card(monkeypatch)
        rep = srv.Replica(name="no-card")
        enabled = gc.isenabled()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            srv.serve(port=0, replica=rep)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            srv.serve(port=0, replica=rep, device="cuda")
        assert rep.device is None and gc.isenabled() == enabled

    def test_replica_device_reaches_every_scheduler(self, monkeypatch):
        """The session scheduler, the cold parity probe, the legacy wire
        and the one-shot Solve each build their TensorScheduler on the
        replica's device."""
        seen = []
        init = ts_mod.TensorScheduler.__init__

        def noting(self, *a, **kw):
            init(self, *a, **kw)
            seen.append(self.device)
        monkeypatch.setattr(ts_mod.TensorScheduler, "__init__", noting)
        rep = srv.Replica(name="device-reach")
        its = construct_instance_types()[:8]
        pool = F.make_nodepool()
        with sidecar_server(PORT, replica=rep) as (_, address):
            assert rep.device == torch.device("cpu")
            session = SolverSession(address, parity_every=1)
            rs = RemoteScheduler(address, [pool], {"default": its},
                                 session=session)
            assert rs.solve(F.make_pods(3, cpu="500m")).parity == \
                "byte-identical"
            # the legacy session wire and the one-shot contract
            sid = session._session_id
            pods = F.make_pods(2, cpu="250m")
            templates, tmpl_idx, ts = codec.encode_pod_rows(pods)
            session._call("SolveSession", wire.pack(
                {"session": sid, "templates": templates},
                {"tmpl_idx": wire.pack_u32(tmpl_idx),
                 "ts": wire.pack_f64(ts)}))
            RemoteScheduler(address, [pool], {"default": its}).solve(pods)
            session.close()
        # session solve, its parity probe, legacy, one-shot
        assert len(seen) == 4 and set(seen) == {torch.device("cpu")}

    def test_restored_session_solves_on_the_replica_device(self):
        live = srv._Session("dev-1", [F.make_nodepool()],
                            {"default": construct_instance_types()[:8]},
                            device=torch.device("cpu"))
        with live.lock:
            data = srv.export_session_checkpoint(live)
        restored = srv.restore_session_checkpoint(
            data, device=torch.device("cpu"))
        assert restored.device == torch.device("cpu")
        sched = srv._session_scheduler(restored, [], [], None)
        assert sched.device == torch.device("cpu")

    def test_kernel_failure_reaches_the_client_naming_the_kernel(
            self, monkeypatch):
        """A KernelError inside the session solve is an INTERNAL status
        that names the kernel: no host re-solve, no answer."""
        def failing(*a, **kw):
            raise kernels.KernelError(
                "combine_compat kernel launch failed: injected (1)")
        monkeypatch.setattr(kernels, "combine_compat", failing)
        host = []
        monkeypatch.setattr(ts_mod.TensorScheduler, "_host_solve",
                            lambda self, pods, reason: host.append(reason))
        with sidecar_server(PORT) as (_, address):
            session = SolverSession(address)
            rs = RemoteScheduler(address, [F.make_nodepool()],
                                 {"default": construct_instance_types()[:8]},
                                 session=session)
            with pytest.raises(grpc.RpcError) as exc:
                rs.solve(F.make_pods(3, cpu="500m"))
            session.close()
        assert exc.value.code() == grpc.StatusCode.INTERNAL
        assert "combine_compat" in exc.value.details()
        assert "kernel launch failed" in exc.value.details()
        assert not host, "the solve was answered from the host"


def test_launch_counts_survive_concurrent_launches(monkeypatch):
    """The sidecar's worker threads (and two replicas of one process)
    launch kernels at once: no count is lost. Sixteen threads launch
    through kernels._launch (a stand-in library that accepts every call)
    with the interpreter switching threads every microsecond."""
    import contextlib
    import threading
    from types import SimpleNamespace

    class Lib:
        def kt_row_splice(self, *args):
            return 0
    monkeypatch.setattr(kernels, "_lib", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=0))
    saved = dict(kernels.LAUNCHES)
    interval = sys.getswitchinterval()
    threads = [threading.Thread(target=lambda: [
        kernels._launch("row_splice", "cuda") for _ in range(2000)])
        for _ in range(16)]
    try:
        kernels.reset_launches()
        sys.setswitchinterval(1e-6)
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert kernels.LAUNCHES["row_splice"] == 16 * 2000
    finally:
        sys.setswitchinterval(interval)
        kernels.LAUNCHES.update(saved)


class TestMain:
    def _run(self, *args, env_over=None):
        env = dict(os.environ, **(env_over or {}))
        env.pop("PYTHONPATH", None)
        return subprocess.Popen(
            [sys.executable, "-m", "karpenter_tpu_torch.sidecar.server",
             "--port", "0", *args], cwd=str(REPO), env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)

    def test_main_without_a_card_exits_non_zero(self):
        """With no card visible and no --device the process refuses to
        start."""
        proc = self._run(env_over={"CUDA_VISIBLE_DEVICES": ""})
        out, err = proc.communicate(timeout=120)
        assert proc.returncode != 0
        assert "CUDA is not available" in err
        assert "listening" not in out

    def test_main_on_the_cpu_serves_and_stops_on_interrupt(self):
        """``--device cpu`` names its device, prints the port line a
        deployment reads, answers a solve, and drains and exits 0 on
        SIGINT."""
        proc = self._run("--device", "cpu")
        try:
            port = chip_smoke._child_port(proc, chip_smoke.time.perf_counter()
                                          + 120)
            address = f"127.0.0.1:{port}"
            session = SolverSession(address)
            r = RemoteScheduler(address, [F.make_nodepool()],
                                {"default": construct_instance_types()[:8]},
                                session=session).solve(
                F.make_pods(3, cpu="500m"))
            session.close()
            assert r.new_nodeclaims and r.fallback_reason == ""
            proc.send_signal(signal.SIGINT)
            assert proc.wait(timeout=60) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


# -- chip_smoke.py's sidecar phases on the CPU ---------------------------------

N_PODS, N_DEPLOYS, N_ITS, N_NODES = 540, 12, 40, 24


@pytest.fixture(scope="module")
def counted():
    """The feasibility wrappers count their plain calls in
    kernels.LAUNCHES, as their kernels count launches on the card."""
    with plain_calls_counted(chip_smoke.FEASIBILITY):
        yield


@pytest.fixture(scope="module")
def workload(counted):
    catalog = construct_catalog(N_ITS)
    pool = chip_smoke.default_pool()
    pods = chip_smoke.bench_pods(N_PODS, N_DEPLOYS)
    nodes = chip_smoke.existing_nodes(catalog, N_NODES)
    runs, best = {}, {}
    for label, state in (("cold", ()), ("existing_nodes", nodes)):
        _, runs[label], best[label] = chip_smoke._solve(
            ts_mod, pool, catalog, pods, state, "cpu")
    return catalog, pool, pods, runs, best


@pytest.fixture()
def small(monkeypatch):
    monkeypatch.setattr(chip_smoke.existing_nodes, "__defaults__",
                        (N_NODES, chip_smoke.SEED))


def test_chip_smoke_sidecar_phases_on_the_cpu(workload, small):
    """The sidecar, fleet and child-process phases hold every answer to
    the in-process solves, launch K1-K3 on the sidecar's paths and print
    their lines."""
    catalog, pool, pods, runs, best = workload
    span = (0, N_NODES)
    with fresh_registry(PORT):
        chip_smoke._reset_counts(kernels)
        lines, want = chip_smoke.sidecar_phase(
            "cpu", pool, catalog, pods, span, runs, best, ts_mod)
        launched = dict(kernels.LAUNCHES)
        chip_smoke._reset_counts(kernels)
        fleet = chip_smoke.sidecar_fleet_phase("cpu", pool, catalog, pods,
                                               span, runs, want)
        fleet_launched = dict(kernels.LAUNCHES)
        child = chip_smoke.sidecar_process_phase(
            "cpu", pool, catalog, pods,
            chip_smoke._local_digest(runs["cold"], pods))
    steps = [ln for ln in lines if ln["phase"] == "sidecar_step"]
    assert [s["window"] for s in steps] == \
        ["cold", "cold"] + list(chip_smoke.WINDOW_KINDS)
    assert all(s["parity"] == "byte-identical" for s in steps[2:])
    assert steps[0]["request_bytes"] > steps[2]["request_bytes"]
    summary = lines[-1]
    assert summary["phase"] == "sidecar" and summary["sessions"][0][
        "resyncs"] == 0
    for name in chip_smoke.FEASIBILITY:
        assert launched[name] > 0 and fleet_launched[name] > 0, name
    assert fleet["failovers"] == 1 and fleet["restore_s"] > 0
    assert child["exit_code"] == 0 and child["digest_equals_step_1"]
    json.dumps(lines + [fleet, child])


def test_chip_smoke_operator_sidecar_phase_on_the_cpu(workload, small):
    paths = {}

    def record():
        paths["operator_sidecar"] = dict(kernels.LAUNCHES)
        return paths["operator_sidecar"]
    with fresh_registry(PORT):
        lines = chip_smoke.operator_sidecar_phase(
            "cpu", record, n_pods=N_PODS, n_deploys=N_DEPLOYS, n_its=N_ITS)
    summary = lines[-1]
    assert summary["phase"] == "operator_sidecar"
    assert summary["digest_equals_cpu_every_step"]
    assert summary["final_store_equals_tensor_backend"]
    assert summary["solves"] and summary["fallbacks"] == 0
    for name in chip_smoke.FEASIBILITY:
        assert paths["operator_sidecar"][name] > 0, name
