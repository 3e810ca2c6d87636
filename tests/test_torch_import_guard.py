"""The port stands alone: no module of karpenter_tpu_torch, nor chip_smoke.py,
imports jax or the JAX package — checked in a fresh interpreter whose
import system refuses both (tests/conftest.py imports jax into every test
process, so the check cannot run in-process), and by reading the sources."""

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
