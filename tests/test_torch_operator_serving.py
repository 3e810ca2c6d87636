"""The port's operator HTTP surface (karpenter_tpu_torch.operator.server) on
the CPU: the four reference tests that waited for it
(tests/test_flightrec.py::test_debug_flightrecorder_endpoint,
tests/test_obs_device.py::TestProfiler::test_debug_profile_device_start_stop
and ::test_obs_profile_cli, tests/test_obs_tracing.py::TestSLOWatcher::
test_slo_budgets_require_tracing_enabled) pointed at the port, then every
route an operator serves. Servers bind ephemeral ports on 127.0.0.1 and
each test stops what it starts."""

import json
import os
import urllib.error
import urllib.request

import pytest

from karpenter_tpu_torch.flightrec import loads_record
from karpenter_tpu_torch.flightrec.record import load_trace
from karpenter_tpu_torch.obs.profile import PROFILER
from karpenter_tpu_torch.obs.tracer import TRACER
from karpenter_tpu_torch.operator.operator import Operator
from karpenter_tpu_torch.operator.options import Options
from karpenter_tpu_torch.operator.server import ServingGroup
from karpenter_tpu_torch.utils.clock import FakeClock

from test_torch_flightrec import record_solve
from test_torch_support import PORT, factories
from test_torch_support import device_series_kept  # noqa: F401 (autouse)
from test_torch_support import sidecar_state_kept  # noqa: F401 (autouse)
from test_torch_support import tracer_kept  # noqa: F401 (autouse)


def _get(url: str):
    """(status, body) of one GET, HTTP errors included."""
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


# -- the reference tests that waited for the operator's server ---------------

def test_debug_flightrecorder_endpoint(tmp_path, monkeypatch):
    rec, _, _ = record_solve(PORT, 1000)
    serving = ServingGroup(0, 0, flightrec=rec).start()
    try:
        base = f"http://127.0.0.1:{serving.metrics_port}"
        body = urllib.request.urlopen(
            f"{base}/debug/flightrecorder").read().decode()
        assert "provisioning" in body and "records 1" in body
        jl = urllib.request.urlopen(
            f"{base}/debug/flightrecorder?format=jsonl").read().decode()
        assert loads_record(jl.strip().splitlines()[-1])["kind"] == \
            "provisioning"
        # dump=0 is NOT a dump request (parse_qs truthiness trap)
        body = urllib.request.urlopen(
            f"{base}/debug/flightrecorder?dump=0").read().decode()
        assert "records 1" in body and "dumped" not in body
        # endpoint-triggered dump lands in the configured directory only
        monkeypatch.setenv("KARPENTER_FLIGHTREC_DIR", str(tmp_path))
        body = urllib.request.urlopen(
            f"{base}/debug/flightrecorder?dump=1&name=../../esc.jsonl"
        ).read().decode()
        assert "dumped 1 records" in body
        assert (tmp_path / "esc.jsonl").exists()  # basename-only: no escape
        assert len(load_trace(str(tmp_path / "esc.jsonl"))) == 1
    finally:
        serving.stop()


def test_debug_profile_device_start_stop(tmp_path, monkeypatch):
    monkeypatch.setenv("KARPENTER_PROFILE_DIR", str(tmp_path / "ep"))
    group = ServingGroup(0, 0, profiling=True).start()
    base = f"http://127.0.0.1:{group.metrics_port}/debug/profile"
    try:
        with urllib.request.urlopen(f"{base}?device=start",
                                    timeout=10) as resp:
            body = resp.read().decode()
        assert "started" in body and str(tmp_path / "ep") in body
        assert PROFILER.active
        # double start: 409, not a crash
        req = urllib.request.Request(f"{base}?device=start")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 409
        with urllib.request.urlopen(f"{base}?device=stop",
                                    timeout=10) as resp:
            assert "stopped" in resp.read().decode()
        assert not PROFILER.active
    finally:
        if PROFILER.active:
            PROFILER.stop()
        group.stop()


def test_obs_profile_cli(tmp_path, monkeypatch):
    from karpenter_tpu_torch.obs.__main__ import main as obs_main
    monkeypatch.setenv("KARPENTER_PROFILE_DIR", str(tmp_path / "cli"))
    group = ServingGroup(0, 0, profiling=True).start()
    try:
        rc = obs_main(["profile",
                       "--url", f"http://127.0.0.1:{group.metrics_port}",
                       "--seconds", "0.05"])
        assert rc == 0
        assert not PROFILER.active
        assert os.path.isdir(str(tmp_path / "cli"))
    finally:
        if PROFILER.active:
            PROFILER.stop()
        group.stop()


def test_slo_budgets_require_tracing_enabled():
    """Budgets that can never fire (tracer off) are a boot failure, not a
    silent no-op."""
    before = (TRACER.enabled, TRACER.capacity, TRACER.watcher)
    with pytest.raises(ValueError, match="trace-ring"):
        Operator(options=Options(metrics_port=0, health_probe_port=0,
                                 trace_ring=0,
                                 slo_budgets="provisioner.pass=2.0"),
                 clock=FakeClock(), device="cpu")
    # the failed boot left the process-wide tracer untouched
    assert (TRACER.enabled, TRACER.capacity, TRACER.watcher) == before


# -- an operator's routes ------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    """A settled operator (one pod bound through kwok) serving on ephemeral
    ports, with profiling and an SLO budget on; the route tests only
    read it."""
    f = factories(PORT)
    op = Operator(Options(metrics_port=0, health_probe_port=0,
                          log_level="error", enable_profiling=True,
                          slo_budgets="provisioner.pass=30.0"),
                  clock=FakeClock(), device="cpu")
    op.store.create(f.make_nodepool(name="default"))
    op.store.create(f.make_pod(cpu="500m"))
    for _ in range(6):
        op.step()
        op.clock.step(1.1)
    assert op.step()
    group = op.start_serving()
    try:
        yield op, f"http://127.0.0.1:{group.metrics_port}", \
            f"http://127.0.0.1:{group.health_port}"
    finally:
        op.stop_serving()


def test_metrics_and_probes(served):
    op, metrics, health = served
    status, body = _get(f"{metrics}/metrics")
    assert status == 200
    assert "karpenter_nodeclaims_created_total" in body
    assert 'karpenter_pods_state{phase="Pending",scheduled="true"} 1' in body
    assert "karpenter_nodes_allocatable{" in body
    assert _get(f"{health}/healthz") == (200, "ok")
    assert _get(f"{health}/readyz") == (200, "ok")
    assert _get(f"{metrics}/nothing-here")[0] == 404
    # start_serving is idempotent: the same group, the same ports
    assert op.start_serving() is op.serving


@pytest.mark.parametrize("route, expect", [
    ("/debug/deadletter", "quarantined 0"),
    ("/debug/flightrecorder", "records 1"),
    ("/debug/offerings", "unavailable 0"),
    ("/debug/traces", "traces "),
    ("/debug/traces?format=chrome", "traceEvents"),
    ("/debug/traces?trace_id=no-such-trace", "not in the ring"),
    ("/debug/slo", "provisioner.pass"),
    ("/debug/fallbacks", "recent"),
    ("/debug/stateplane", "cluster"),
    ("/debug/stacks", "Thread "),
    ("/debug/timers", "pending_timers"),
    ("/debug/profile?seconds=0.1", "folded stacks"),
    ("/debug/profile?device=sideways", "device must be"),
    ("/debug/flightrecorder?n=x", "n must be an integer"),
])
def test_debug_routes(served, route, expect):
    _, metrics, _ = served
    status, body = _get(metrics + route)
    assert expect in body, (route, status, body[:300])
    bad = ("sideways" in route or "n=x" in route or "no-such" in route)
    assert (status >= 400) == bad, (route, status)


def test_sessions_route_waits_for_the_remote_solver(served):
    """``/debug/sessions`` lives with the solver: the operator's own
    server has no session table (404, and the factory answers 404 when
    handed None), and the port's sidecar serves its table from
    ``sessions_snapshot`` once a session has solved there."""
    from karpenter_tpu_torch.cloudprovider.kwok import \
        construct_instance_types
    from karpenter_tpu_torch.operator.server import _debug_sessions_factory
    from karpenter_tpu_torch.sidecar import server as srv
    from karpenter_tpu_torch.sidecar.client import (RemoteScheduler,
                                                    SolverSession)
    from test_torch_support import sidecar_server
    _, metrics, _ = served
    assert _get(f"{metrics}/debug/sessions")[0] == 404
    assert _debug_sessions_factory(None)()[0] == 404
    F = factories(PORT)
    with sidecar_server(PORT) as (server, address):
        session = SolverSession(address, tenant="route-t")
        RemoteScheduler(address, [F.make_nodepool()],
                        {"default": construct_instance_types()[:8]},
                        session=session).solve(F.make_pods(3, cpu="500m"))
        session.close()
        group = srv.start_serving(0, 0, draining=server.draining)
        try:
            status, body = _get(
                f"http://127.0.0.1:{group.metrics_port}/debug/sessions")
        finally:
            group.stop()
        table = srv.sessions_snapshot()
    assert status == 200 and body.startswith("sessions 1")
    assert "tenant=route-t" in body and "solves=1" in body
    assert len(table) == 1 and table[0]["tenant"] == "route-t"
    assert table[0]["solves"] == 1 and table[0]["rows"] == 3


def test_slo_route_is_json(served):
    _, metrics, _ = served
    status, body = _get(f"{metrics}/debug/slo")
    assert status == 200
    assert "provisioner.pass" in json.dumps(json.loads(body))


def test_readyz_follows_cluster_sync():
    """readyz asks the cluster cache whether it is synced, per request."""
    op = Operator(Options(metrics_port=0, health_probe_port=0,
                          log_level="error"), clock=FakeClock(),
                  device="cpu")
    group = op.start_serving()
    try:
        ready = f"http://127.0.0.1:{group.health_port}/readyz"
        assert _get(ready) == (200, "ok")
        op.cluster.synced = lambda: False
        assert _get(ready) == (503, "unhealthy")
        assert _get(f"http://127.0.0.1:{group.health_port}/healthz") == \
            (200, "ok")
    finally:
        op.stop_serving()
    assert op.serving is None
