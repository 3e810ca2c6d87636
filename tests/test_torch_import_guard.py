"""The port stands alone: no module of karpenter_tpu_torch, nor chip_smoke.py,
imports jax or the JAX package — checked in a fresh interpreter whose
import system refuses both (tests/conftest.py imports jax into every test
process, so the check cannot run in-process), which also drives a solve,
the loops, the operator, a solver sidecar and the fleet simulator on the
CPU, and by reading the sources."""

import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_GUARDED = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "karpenter_tpu"):
            raise ImportError("refused import of " + name)
        return None

sys.meta_path.insert(0, Refuse())
import karpenter_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(karpenter_tpu_torch.__path__,
                                              "karpenter_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
import chip_smoke
import join_ablation

# a small solve through the plain versions reaches the imports made inside
# functions too
from karpenter_tpu_torch.cloudprovider.kwok import construct_catalog
from karpenter_tpu_torch.provisioning.tensor_scheduler import TensorScheduler
catalog = construct_catalog(40)
pods = chip_smoke.bench_pods(90, 9)
ts = TensorScheduler([chip_smoke.default_pool()], {{"default": catalog}},
                     state_nodes=chip_smoke.existing_nodes(catalog, 6),
                     force_tensor=True, device="cpu")
# recorded, with the device time attributed, and replayed
from karpenter_tpu_torch.flightrec import (FlightRecorder, loads_record,
                                           replay_record)
from karpenter_tpu_torch.obs import DEVICE_TIME
ts.flight_recorder = FlightRecorder()
results = ts.solve(pods)
assert ts.fallback_reason == "" and ts.partition == (len(pods), 0)
assert results.new_nodeclaims
assert DEVICE_TIME.snapshot()
report = replay_record(loads_record(ts.flight_recorder.lines()[-1]),
                       device="cpu")
assert report.ok, report.render()

# the provisioner and disruption loops of chip_smoke.py at a small fleet
env = chip_smoke.stuck_fleet("cpu", 12, "dscale")
ctrl = chip_smoke.new_controller(env)
_, cmd = chip_smoke.controller_pass(ctrl)
assert cmd[1] == ["dscale-node-00011"], cmd
_, cmd, _, _, _, _ = chip_smoke.multi_consolidation(
    chip_smoke.underutilized_fleet("cpu", 12), repeats=0)
assert cmd.candidates

# the operator: its whole roster settles a small burst on the CPU, serves
# its routes, and its lazily imported kube backend and codec load too
import urllib.request
from karpenter_tpu_torch.operator.operator import Operator
from karpenter_tpu_torch.operator.options import Options
from karpenter_tpu_torch.utils.clock import FakeClock
op = Operator(Options(metrics_port=0, health_probe_port=0, log_level="error",
                      enable_profiling=True, feature_gates="NodeRepair"),
              clock=FakeClock(), device="cpu")
op.store.create(chip_smoke.default_pool())
for p in chip_smoke.bench_pods(90, 9):
    op.store.create(p)
for _ in range(12):
    op.step()
    op.clock.step(1.1)
assert all(p.spec.node_name for p in op.store.list(type(pods[0])))
group = op.start_serving()
for route in ("/metrics", "/debug/stateplane", "/debug/traces"):
    urllib.request.urlopen(f"http://127.0.0.1:{{group.metrics_port}}{{route}}",
                           timeout=10).read()
op.stop_serving()
import karpenter_tpu_torch.operator.__main__
from karpenter_tpu_torch.kube import apiserver, k8s_codec
assert k8s_codec.pod_from_k8s(k8s_codec.pod_to_k8s(pods[0])).name

# the solver sidecar: a server on the CPU and one session solve through
# the port's client over a wire-chaos channel (its first attempt dropped
# and retried), the parity probe byte-identical; then the server stopped
import grpc
from karpenter_tpu_torch.sidecar import server as srv
from karpenter_tpu_torch.sidecar.client import RemoteScheduler, SolverSession
from karpenter_tpu_torch.sidecar.wire_chaos import ChaosChannel
from karpenter_tpu_torch.utils.chaos import WireFaultInjector
server, port = srv.serve(port=0, device="cpu")
address = f"127.0.0.1:{{port}}"
injector = WireFaultInjector(seed=3)
injector.inject_next("drop")
session = SolverSession(address, parity_every=1, channel=ChaosChannel(
    grpc.insecure_channel(address, options=srv.GRPC_OPTIONS), injector))
batch = chip_smoke.bench_pods(90, 9)
remote = RemoteScheduler(address, [chip_smoke.default_pool()],
                         {{"default": catalog}}, session=session).solve(batch)
assert remote.fallback_reason == "" and remote.new_nodeclaims
assert remote.parity == "byte-identical" and session.retries == 1
session.close()
server.stop(None)

# the fleet simulator: a short timeline with a state corruption and a
# device-loss window on the simulator's eight-slot CPU mesh; and a process
# alone, which joins no fleet
from karpenter_tpu_torch.parallel.mesh import init_multihost
from karpenter_tpu_torch.sim import FleetSimulator, parse_scenario
doc = {{"name": "guard", "seed": 3, "duration": 300, "tick": 20, "events": [
    {{"at": 5, "kind": "deploy", "name": "web", "replicas": 4, "cpu": "500m",
      "memory": "256Mi"}},
    {{"at": 60, "kind": "corrupt_state"}},
    {{"at": 90, "kind": "kill_device", "duration": 60}},
    {{"at": 100, "kind": "deploy", "name": "api", "replicas": 3,
      "cpu": "250m", "memory": "256Mi"}}]}}
sim = FleetSimulator(parse_scenario(doc), device="cpu")
report = sim.run()
assert report["final"]["pods_pending"] == 0, report["final"]
assert sim.state_corruptor.injected and sim.device_killer.counts
assert init_multihost() == 1
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "karpenter_tpu"))
assert not bad, bad
print("imported", len(mods), "modules")
"""


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", _GUARDED.format(repo=str(REPO))],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=str(REPO))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    n = int(r.stdout.split("imported", 1)[1].split()[0])
    assert n >= 30, r.stdout


_IMPORT = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|karpenter_tpu)(?:\.|\s|$)"
    r"|import_module\(\s*['\"](?:jax|karpenter_tpu)['\".]", re.M)


def test_sources_name_no_jax_or_reference_import():
    files = sorted((REPO / "karpenter_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "join_ablation.py"]
    assert len(files) > 30
    offenders = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
                 for f in files for m in _IMPORT.finditer(f.read_text())]
    assert not offenders, offenders
