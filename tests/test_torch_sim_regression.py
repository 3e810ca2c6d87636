"""The simulator's pinned clips replayed through the port on the CPU: the
four (scenario, clip) pairs of tests/goldens/sim-regression.json, each held
to the pinned ledger digest, entry count and report shape, which the JAX
package wrote. The golden is read as data. state-chaos replays its device
loss on the simulator's eight-slot mesh over the CPU. Then mixed-day
clipped at a quarter of its day through both packages, with equal
digests."""

import json
import os

import pytest

import karpenter_tpu.sim as ref_sim
from karpenter_tpu_torch.sim import FleetSimulator, load_scenario

from test_torch_support import plain_calls_counted
from test_torch_support import device_series_kept  # noqa: F401 (autouse)
from test_torch_support import sidecar_state_kept  # noqa: F401 (autouse)
from test_torch_support import tracer_kept  # noqa: F401 (autouse)

pytestmark = pytest.mark.sim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "goldens", "sim-regression.json")
SCENARIOS_DIR = os.path.join(REPO, "karpenter_tpu_torch", "sim", "scenarios")
REF_SCENARIOS_DIR = os.path.join(REPO, "karpenter_tpu", "sim", "scenarios")

# report sections whose keys are data, compared as one opaque leaf
_OPAQUE = {"events_applied", "fallbacks.classes", "attribution", "final"}


def report_shape(obj, prefix: str = "") -> list:
    """Sorted dotted key paths with value-type names: the report's
    structure without its values."""
    out = []
    if isinstance(obj, dict):
        if prefix.rstrip(".") in _OPAQUE:
            return [f"{prefix.rstrip('.')}:dict"]
        for k in sorted(obj):
            out.extend(report_shape(obj[k], f"{prefix}{k}."))
        return out
    path = prefix.rstrip(".")
    if isinstance(obj, list):
        return [f"{path}:list"]
    if isinstance(obj, bool):
        return [f"{path}:bool"]
    if isinstance(obj, (int, float)):
        return [f"{path}:number"]
    if obj is None:
        return [f"{path}:null"]
    return [f"{path}:str"]


def clipped(load, path: str, clip: float):
    sc = load(path)
    clip = min(clip, sc.duration)
    sc.events = [e for e in sc.events if e.at <= clip]
    sc.duration = clip
    return sc


with open(GOLDEN) as f:
    PINS = json.load(f)["pins"]


@pytest.mark.parametrize("pin", PINS, ids=[p["scenario"] for p in PINS])
def test_pinned_clip_matches_the_golden(pin):
    sim = FleetSimulator(clipped(load_scenario, os.path.join(
        SCENARIOS_DIR, pin["scenario"]), pin["clip_seconds"]), device="cpu")
    report = sim.run()
    assert report["ledger_digest"] == pin["ledger_digest"]
    assert report["ledger_entries"] == pin["ledger_entries"]
    assert report_shape(report) == pin["report_shape"]
    if sim.mesh is not None:
        # the device-loss window went through the ladder of an eight-slot
        # mesh over the CPU, and the corruptions were injected and caught:
        # the same faults, detections and ladder hits as the reference's
        assert sim.mesh.devices.size == 8
        ref = ref_sim.FleetSimulator(clipped(ref_sim.load_scenario,
                                             os.path.join(REF_SCENARIOS_DIR,
                                                          pin["scenario"]),
                                             pin["clip_seconds"]))
        assert ref.run()["ledger_digest"] == pin["ledger_digest"]
        assert sim.state_corruptor.injected == ref.state_corruptor.injected
        assert sim.state_auditor.stats == ref.state_auditor.stats
        assert sim.device_killer.counts == ref.device_killer.counts
        assert sim.device_killer.counts
        assert any(k.startswith("corrupt:") for k in sim.state_auditor.stats)


def test_golden_pins_the_four_library_clips():
    assert [(p["scenario"], p["clip_seconds"]) for p in PINS] == [
        ("mixed-day.yaml", 7200.0), ("disruption-wave.yaml", 9000.0),
        ("service-fleet.yaml", 7200.0), ("state-chaos.yaml", 2400.0)]


def test_report_shape_is_value_free():
    a = {"x": 1.5, "churn": {"n": 3}, "events_applied": {"deploy": 2},
         "name": "a", "flag": True, "items": [1, 2], "service": None}
    b = {"x": 99.0, "churn": {"n": 7}, "events_applied": {"pdb": 9},
         "name": "b", "flag": False, "items": [], "service": None}
    assert report_shape(a) == report_shape(b) == [
        "churn.n:number", "events_applied:dict", "flag:bool",
        "items:list", "name:str", "service:null", "x:number"]


def test_mixed_day_quarter_matches_the_reference():
    """mixed-day's first 21,600 s (its morning deploys, the traffic spike,
    the api rollout and the midday spot-reclaim wave) through both
    packages: equal digests and entry counts, the ones chip_smoke.py pins
    for its second sim_mixed_day run."""
    import chip_smoke
    name = "mixed-day.yaml"
    report = FleetSimulator(clipped(load_scenario, os.path.join(
        SCENARIOS_DIR, name), 21600.0), device="cpu").run()
    ref = ref_sim.FleetSimulator(clipped(ref_sim.load_scenario, os.path.join(
        REF_SCENARIOS_DIR, name), 21600.0)).run()
    assert report["ledger_digest"] == ref["ledger_digest"] == \
        chip_smoke.MIXED_DAY_CLIP_DIGEST
    assert report["ledger_entries"] == ref["ledger_entries"] == \
        chip_smoke.MIXED_DAY_CLIP_ENTRIES
    assert chip_smoke.MIXED_DAY_CLIP == 21600.0
    assert report["solver"] == ref["solver"]
    assert report["events_applied"]["spot_reclaim"] == 1


def test_chip_smoke_sim_pinned_phase_on_the_cpu():
    """chip_smoke.py's sim_pinned phase through the plain versions: every
    pin held, state-chaos's chaos counts equal between its two replays,
    K1-K3 counted on the path and held at each of its shapes."""
    import chip_smoke
    paths = {}

    def record():
        paths["sim_pinned"] = dict(kernels.LAUNCHES)
        return paths["sim_pinned"]
    with plain_calls_counted(chip_smoke.FEASIBILITY) as kernels, \
            chip_smoke._process_state_kept():
        lines = chip_smoke.sim_pinned_phase("cpu", record)
    pinned = [x for x in lines if x["phase"] == "sim_pinned"]
    assert [x["scenario"] for x in pinned] == [p["scenario"] for p in PINS]
    assert all(x["digest_equals_pin"] for x in pinned)
    chaos = next(x for x in pinned if x["scenario"] == "state-chaos.yaml")
    assert chaos["chaos"]["injected"] == 8 and chaos["chaos_equals_cpu"]
    assert chaos["chaos"]["detected"] == 3 and chaos["chaos"]["healed"] == 4
    launches = lines[-1]["launches"]
    assert set(launches) == set(chip_smoke.FEASIBILITY), launches
    assert launches == {k: v for k, v in paths["sim_pinned"].items() if v}
