"""tests/test_sim.py's tier-1 classes pointed at the port's fleet simulator
(its solves on the CPU), with the simulator parts of
tests/test_sidecar_fleet.py (the fleet scenario schema and the fleet sim
smoke) and of tests/test_state_audit.py (the chaos events). Wherever a test
replays a scenario, the same document replays through the JAX package too,
and the two ledger digests and entry counts must be equal: the ledger is
the run's every decision, so equal digests mean the port decided as the
reference did over the whole timeline. Also: the port's scenario library
byte-equal to the reference's, the device rules, and the process state a
run must leave as it found it."""

import copy
import filecmp
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque

import pytest
import torch

import karpenter_tpu.sim as ref_sim
from karpenter_tpu_torch.sim import (FleetSimulator, ScenarioError,
                                     load_scenario, parse_scenario)
from karpenter_tpu_torch.utils.clock import FakeClock

from test_sim import _doc
from test_torch_support import PORT, factories
from test_torch_support import device_series_kept  # noqa: F401 (autouse)
from test_torch_support import sidecar_state_kept  # noqa: F401 (autouse)
from test_torch_support import tracer_kept  # noqa: F401 (autouse)

pytestmark = pytest.mark.sim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS_DIR = os.path.join(REPO, "karpenter_tpu_torch", "sim", "scenarios")
REF_SCENARIOS_DIR = os.path.join(REPO, "karpenter_tpu", "sim", "scenarios")


def _reference(doc) -> dict:
    """The JAX package's report for ``doc`` (its flight dumps, if any, in a
    directory of their own)."""
    with tempfile.TemporaryDirectory() as dumps:
        return ref_sim.FleetSimulator(ref_sim.parse_scenario(
            copy.deepcopy(doc)), flightrec_dir=dumps).run()


def _held(report, ref) -> None:
    assert report["ledger_digest"] == ref["ledger_digest"]
    assert report["ledger_entries"] == ref["ledger_entries"]
    assert report["final"] == ref["final"]


def _run(doc, **kw):
    """The port's replay of ``doc`` on the CPU, held to the JAX package's
    replay of the same document."""
    sim = FleetSimulator(parse_scenario(copy.deepcopy(doc)), device="cpu",
                         **kw)
    report = sim.run()
    _held(report, _reference(doc))
    return sim, report


# -- scenario schema: loud rejects -------------------------------------------

class TestScenarioValidation:
    def test_minimal_document_parses(self):
        sc = parse_scenario(_doc())
        assert sc.name == "t" and len(sc.events) == 1
        assert sc.nodepools[0].name == "default"

    def test_unknown_top_level_key_rejected(self):
        with pytest.raises(ScenarioError, match=r"unknown key 'tikc'"):
            parse_scenario(_doc(tikc=5))

    def test_unknown_event_kind_rejected(self):
        doc = _doc()
        doc["events"].append({"at": 9, "kind": "depoy", "name": "x"})
        with pytest.raises(ScenarioError,
                           match=r"unknown event kind 'depoy'.*deploy"):
            parse_scenario(doc)

    def test_unknown_event_field_names_field_and_kind(self):
        doc = _doc()
        doc["events"][0]["fractoin"] = 0.5
        with pytest.raises(ScenarioError,
                           match=r"unknown key 'fractoin' in deploy event"):
            parse_scenario(doc)

    def test_missing_required_field_rejected(self):
        doc = _doc()
        del doc["events"][0]["cpu"]
        with pytest.raises(ScenarioError, match=r"missing required field "
                                                r"'cpu'"):
            parse_scenario(doc)

    def test_bad_type_names_field_and_value(self):
        doc = _doc()
        doc["events"][0]["replicas"] = "many"
        with pytest.raises(ScenarioError,
                           match=r"field 'replicas' in deploy event #1 "
                                 r"must be an integer"):
            parse_scenario(doc)

    def test_pdb_needs_exactly_one_constraint(self):
        for extra in ({}, {"max_unavailable": 1, "min_available": 1}):
            doc = _doc()
            doc["events"].append(
                {"at": 9, "kind": "pdb", "name": "p", "app": "web", **extra})
            with pytest.raises(ScenarioError, match="exactly one of"):
                parse_scenario(doc)

    def test_spot_reclaim_needs_fraction_or_count(self):
        doc = _doc()
        doc["events"].append({"at": 9, "kind": "spot_reclaim"})
        with pytest.raises(ScenarioError, match="at least one of"):
            parse_scenario(doc)

    def test_event_beyond_duration_rejected(self):
        doc = _doc()
        doc["events"].append({"at": 6000, "kind": "drain"})
        with pytest.raises(ScenarioError, match="beyond the scenario "
                                                "duration"):
            parse_scenario(doc)

    def test_scale_of_unknown_deployment_rejected(self):
        doc = _doc()
        doc["events"].append(
            {"at": 9, "kind": "scale", "name": "api", "replicas": 2})
        with pytest.raises(ScenarioError, match="unknown deployment 'api'"):
            parse_scenario(doc)

    def test_deploy_references_checked_in_execution_order(self):
        # the engine executes by (at, file index), not file order: a
        # scale listed BEFORE its deploy but timed after it is valid...
        doc = _doc()
        doc["events"] = [
            {"at": 9, "kind": "scale", "name": "web", "replicas": 2},
            {"at": 5, "kind": "deploy", "name": "web", "replicas": 3,
             "cpu": "500m", "memory": "256Mi"},
        ]
        assert len(parse_scenario(doc).events) == 2
        # ...and a scale timed BEFORE its deploy is rejected even with
        # the deploy first in the file (it would KeyError mid-run)
        doc["events"] = [
            {"at": 100, "kind": "deploy", "name": "web", "replicas": 3,
             "cpu": "500m", "memory": "256Mi"},
            {"at": 50, "kind": "scale", "name": "web", "replicas": 2},
        ]
        with pytest.raises(ScenarioError, match="unknown deployment 'web'"):
            parse_scenario(doc)

    def test_bad_slo_budget_rejected(self):
        with pytest.raises(ScenarioError, match="bad 'slo_budgets'"):
            parse_scenario(_doc(slo_budgets="pass=-1"))

    def test_unknown_backend_rejected(self):
        with pytest.raises(ScenarioError,
                           match=r"'backend'.*\"tensor\" or \"sidecar\""):
            parse_scenario(_doc(backend="grpc"))

    def test_wire_chaos_without_sidecar_backend_rejected(self):
        doc = _doc()
        doc["events"].append({"at": 10, "kind": "wire_chaos", "drop": 0.1,
                              "duration": 60})
        with pytest.raises(ScenarioError,
                           match=r"requires 'backend: sidecar'"):
            parse_scenario(doc)

    def test_wire_chaos_without_any_fault_rejected(self):
        doc = _doc(backend="sidecar")
        doc["events"].append({"at": 10, "kind": "wire_chaos",
                              "duration": 60})
        with pytest.raises(ScenarioError,
                           match=r"needs at least one fault"):
            parse_scenario(doc)

    def test_wire_chaos_bad_rate_names_field(self):
        doc = _doc(backend="sidecar")
        doc["events"].append({"at": 10, "kind": "wire_chaos", "drop": 1.7,
                              "duration": 60})
        with pytest.raises(ScenarioError,
                           match=r"field 'drop' in wire_chaos event #2 "
                                 r"must be a number in \[0, 1\]"):
            parse_scenario(doc)

    def test_wire_chaos_unknown_field_rejected(self):
        doc = _doc(backend="sidecar")
        doc["events"].append({"at": 10, "kind": "wire_chaos", "dorp": 0.1,
                              "duration": 60})
        with pytest.raises(ScenarioError, match=r"unknown key 'dorp'"):
            parse_scenario(doc)

    def test_wire_chaos_sidecar_backend_accepted(self):
        doc = _doc(backend="sidecar")
        doc["events"].append({"at": 10, "kind": "wire_chaos",
                              "kill_server": True, "duration": 60})
        sc = parse_scenario(doc)
        assert sc.backend == "sidecar"
        assert sc.events[-1].params["kill_server"] is True

    def test_yaml_reject_names_file_and_line(self, tmp_path):
        p = tmp_path / "bad.yaml"
        p.write_text("name: x\n"
                     "duration: 600\n"
                     "events:\n"
                     "  - at: 5\n"
                     "    kind: deploy\n"
                     "    name: web\n"
                     "    replicas: 2\n"
                     "    cpu: 500m\n"
                     "    memory: 256Mi\n"
                     "    fractoin: 1\n")
        with pytest.raises(ScenarioError,
                           match=r"bad\.yaml:10: unknown key 'fractoin'"):
            load_scenario(str(p))

    def test_yaml_unknown_kind_names_its_line(self, tmp_path):
        p = tmp_path / "bad2.yaml"
        p.write_text("name: x\nduration: 600\nevents:\n"
                     "  - at: 5\n"
                     "    kind: depoy\n")
        with pytest.raises(ScenarioError, match=r"bad2\.yaml:5: unknown "
                                                r"event kind 'depoy'"):
            load_scenario(str(p))

    def test_invalid_yaml_syntax_rejected(self, tmp_path):
        p = tmp_path / "syntax.yaml"
        p.write_text("name: [unclosed\nduration: 600\n")
        with pytest.raises(ScenarioError, match="invalid YAML"):
            load_scenario(str(p))

    def test_json_scenario_loads(self, tmp_path):
        p = tmp_path / "s.json"
        p.write_text(json.dumps(_doc()))
        sc = load_scenario(str(p))
        assert sc.events[0].kind == "deploy"

    def test_library_scenarios_all_validate(self):
        names = sorted(os.listdir(SCENARIOS_DIR))
        assert len(names) >= 4
        for name in names:
            sc = load_scenario(os.path.join(SCENARIOS_DIR, name))
            assert sc.events and sc.duration > 0

    def test_library_is_the_references_byte_for_byte(self):
        """The port carries its own copy of the nine library scenarios
        (it never reads the JAX package's directory), equal to the
        reference's byte for byte."""
        names = sorted(os.listdir(REF_SCENARIOS_DIR))
        assert sorted(os.listdir(SCENARIOS_DIR)) == names
        assert len(names) == 9
        match, mismatch, errors = filecmp.cmpfiles(
            REF_SCENARIOS_DIR, SCENARIOS_DIR, names, shallow=False)
        assert match == names, (mismatch, errors)


# -- FakeClock: condition-variable sleepers ----------------------------------

class TestFakeClockSleepers:
    def test_zero_and_negative_sleep_return_immediately(self):
        clock = FakeClock()
        clock.sleep(0)
        clock.sleep(-5)
        assert clock.sleepers == 0

    def test_sleeper_blocks_until_step_crosses_deadline(self):
        clock = FakeClock()
        woke = threading.Event()

        def sleeper():
            clock.sleep(10.0)
            woke.set()

        t = threading.Thread(target=sleeper, daemon=True)
        t.start()
        deadline = time.time() + 5.0
        while clock.sleepers == 0 and time.time() < deadline:
            time.sleep(0.001)
        assert clock.sleepers == 1
        clock.step(9.0)
        time.sleep(0.02)
        assert not woke.is_set()
        clock.step(1.0)
        assert woke.wait(5.0)
        t.join(5.0)
        assert clock.sleepers == 0

    def test_multiple_sleepers_wake_only_past_their_deadlines(self):
        clock = FakeClock()
        woke = {}

        def sleeper(name, seconds):
            clock.sleep(seconds)
            woke[name] = True

        threads = [threading.Thread(target=sleeper, args=("a", 5.0),
                                    daemon=True),
                   threading.Thread(target=sleeper, args=("b", 50.0),
                                    daemon=True)]
        for t in threads:
            t.start()
        deadline = time.time() + 5.0
        while clock.sleepers < 2 and time.time() < deadline:
            time.sleep(0.001)
        assert clock.sleepers == 2
        clock.step(10.0)
        threads[0].join(5.0)
        assert woke.get("a") and not woke.get("b")
        assert clock.sleepers == 1
        clock.set_time(clock.now() + 100.0)
        threads[1].join(5.0)
        assert woke.get("b") and clock.sleepers == 0

    def test_thread_safe_step_returns_new_now(self):
        clock = FakeClock(start=100.0)
        assert clock.step(5.0) == 105.0
        assert clock.now() == 105.0
        clock.set_time(42.0)
        assert clock.now() == 42.0

    def test_operator_run_loop_paced_by_fake_clock(self):
        """Operator.run sleeps on the injected clock, so a simulator thread
        advancing a FakeClock drives the real-time loop without wall-clock
        waits."""
        from karpenter_tpu_torch.api.objects import Pod
        from karpenter_tpu_torch.operator.operator import Operator
        from karpenter_tpu_torch.operator.options import Options
        f = factories(PORT)
        clock = FakeClock()
        op = Operator(options=Options(metrics_port=0, health_probe_port=0),
                      clock=clock, device="cpu")
        op.store.create(f.make_nodepool(name="default"))
        op.store.create(f.make_pod(cpu="100m"))
        stop = threading.Event()
        t = threading.Thread(
            target=lambda: op.run(stop=stop.is_set, tick_seconds=1.0),
            daemon=True)
        t.start()
        deadline = time.time() + 10.0
        while time.time() < deadline:
            clock.step(1.1)
            if all(p.spec.node_name for p in op.store.list(Pod)) \
                    and op.store.list(Pod):
                break
            time.sleep(0.005)
        stop.set()
        deadline = time.time() + 10.0
        while t.is_alive() and time.time() < deadline:
            clock.step(2.0)
            time.sleep(0.01)
        t.join(1.0)
        assert not t.is_alive()
        op.stop_serving()
        assert all(p.spec.node_name for p in op.store.list(Pod))


# -- engine ------------------------------------------------------------------

class TestEngine:
    def test_smoke_deploy_scale_drain(self):
        doc = _doc(duration=900.0)
        doc["events"] += [
            {"at": 300, "kind": "scale", "name": "web", "replicas": 6},
            {"at": 600, "kind": "drain", "count": 1},
        ]
        sim, report = _run(doc)
        assert report["final"]["pods_pending"] == 0
        assert report["final"]["pods_bound"] == 6
        assert report["churn"]["claims_created"] > 0
        tts = report["time_to_schedule"]
        assert tts["samples"] >= 6 and tts["p50_s"] > 0
        assert report["cost"]["per_pod_hour"] > 0
        assert report["solver"]["fallback_fraction"] == 0.0
        assert report["compression"] > 10
        kinds = {e["kind"] for e in sim.ledger.entries}
        assert {"event", "solve", "node_added", "pod_bound"} <= kinds

    def test_same_seed_byte_identical_ledger_digest(self):
        doc = _doc(duration=900.0, seed=7)
        doc["events"] += [
            {"at": 200, "kind": "spot_reclaim", "fraction": 0.5},
            {"at": 400, "kind": "rolling_update", "name": "web", "batch": 2,
             "interval": 30},
        ]
        _, r1 = _run(doc)
        r2 = FleetSimulator(parse_scenario(doc), device="cpu").run()
        assert r1["ledger_digest"] == r2["ledger_digest"]

    def test_digest_stable_across_processes_and_hash_seeds(self, tmp_path):
        """Two processes under different hash seeds, through the port's
        command line on the CPU, give the JAX package's digest."""
        sc = tmp_path / "spread.yaml"
        sc.write_text(
            "name: spread\nseed: 1\nduration: 600\nevents:\n"
            "  - {at: 10, kind: deploy, name: web, replicas: 6,"
            " cpu: \"2\", memory: 2Gi, spread: zone}\n")
        digests = []
        for hashseed in ("17", "4242"):
            env = dict(os.environ, PYTHONHASHSEED=hashseed)
            proc = subprocess.run(
                [sys.executable, "-m", "karpenter_tpu_torch.sim", "run",
                 str(sc), "--device", "cpu", "--json"],
                capture_output=True, text=True, env=env, timeout=120,
                cwd=REPO)
            assert proc.returncode == 0, proc.stderr
            assert "fleet simulator device: cpu\n" in proc.stdout
            m = re.search(r'"ledger_digest": "([0-9a-f]{64})"', proc.stdout)
            assert m, proc.stdout + proc.stderr
            digests.append(m.group(1))
        ref = ref_sim.FleetSimulator(ref_sim.load_scenario(str(sc))).run()
        assert digests == [ref["ledger_digest"]] * 2, digests

    def test_different_seed_diverges_under_chaos(self):
        base = _doc(duration=900.0)
        base["events"][0].update(replicas=6, cpu="100")
        base["events"].append(
            {"at": 300, "kind": "spot_reclaim", "fraction": 0.4})
        doc_a = json.loads(json.dumps(base))
        doc_b = json.loads(json.dumps(base))
        doc_b["seed"] = 4
        sim_a, ra = _run(doc_a)
        sim_b, rb = _run(doc_b)
        victims = [sorted(e["node"] for e in s.ledger.entries
                          if e["kind"] == "reclaim")
                   for s in (sim_a, sim_b)]
        assert victims[0] and victims[1]
        assert victims[0] != victims[1], victims
        assert ra["ledger_digest"] != rb["ledger_digest"]

    def test_spot_reclaim_replaces_capacity(self):
        doc = _doc(duration=1200.0)
        doc["events"][0]["replicas"] = 6
        doc["events"].append(
            {"at": 300, "kind": "spot_reclaim", "fraction": 1.0})
        sim, report = _run(doc)
        reclaims = [e for e in sim.ledger.entries if e["kind"] == "reclaim"]
        assert reclaims, "no spot node was reclaimed"
        assert report["churn"]["pods_replaced"] >= 1
        assert report["final"]["pods_pending"] == 0
        assert report["final"]["pods_bound"] == 6

    def test_zonal_outage_masks_zone_until_recovery(self):
        doc = _doc(duration=3600.0, tick=15)
        doc["events"][0]["replicas"] = 6
        doc["events"].append({"at": 600, "kind": "zonal_outage",
                              "zone": "test-zone-a", "duration": 900})
        sim, report = _run(doc)
        outage_nodes = [
            e for e in sim.ledger.entries
            if e["kind"] == "node_added" and e["zone"] == "test-zone-a"
            and 600 <= e["t"] < 1500]
        assert outage_nodes == [], outage_nodes
        assert report["events_applied"]["zonal_outage"] == 1
        assert report["final"]["pods_pending"] == 0

    def test_pdb_constrained_drain_completes(self):
        doc = _doc(duration=1800.0)
        doc["events"][0]["replicas"] = 6
        doc["events"] += [
            {"at": 60, "kind": "pdb", "name": "web-pdb", "app": "web",
             "max_unavailable": 1},
            {"at": 600, "kind": "drain", "count": 1},
        ]
        sim, report = _run(doc)
        drained = [e for e in sim.ledger.entries if e["kind"] == "event"
                   and e.get("event") == "drain"]
        assert drained and drained[0]["nodes"]
        gone = {e["node"] for e in sim.ledger.entries
                if e["kind"] == "node_gone"}
        assert set(drained[0]["nodes"]) <= gone, "drain never completed"
        assert report["final"]["pods_pending"] == 0
        assert report["churn"]["pods_evicted"] >= 1

    def test_induced_slo_breach_dumps_exactly_one_flight_record(self, tmp_path):
        doc = _doc(duration=900.0)
        doc["events"] += [
            {"at": 300, "kind": "slo",
             "budgets": {"provisioner.pass": 1e-9}, "duration": 60},
            {"at": 310, "kind": "deploy", "name": "canary", "replicas": 2,
             "cpu": "100m", "memory": "128Mi"},
        ]
        sim, report = _run(doc, flightrec_dir=str(tmp_path))
        assert len(report["breaches"]) == 1, report["breaches"]
        breach = report["breaches"][0]
        assert breach["slo"] == "provisioner.pass"
        files = os.listdir(tmp_path)
        assert len(files) == 1
        lines = [json.loads(line)
                 for line in open(tmp_path / files[0]) if line.strip()]
        assert lines
        assert all(rec["meta"]["trace_id"] == breach["trace_id"]
                   for rec in lines)
        assert breach["trace_id"] in {
            e.get("trace_id") for e in sim.ledger.entries
            if e["kind"] == "solve"}

    def test_overlapping_slo_windows_restore_baseline(self):
        doc = _doc(duration=900.0)
        doc["events"] += [
            {"at": 100, "kind": "slo", "budgets": {"span.a": 100.0},
             "duration": 200},
            {"at": 200, "kind": "slo", "budgets": {"span.b": 100.0},
             "duration": 200},
        ]
        sim, _ = _run(doc)
        assert sim.op.slo.budgets == {}, sim.op.slo.budgets
        assert len([e for e in sim.ledger.entries
                    if e["kind"] == "slo_end"]) == 2

    def test_breaches_beyond_watcher_ring_reach_ledger(self, tmp_path):
        doc = _doc(duration=900.0, slo_budgets="provisioner.pass=1e-9")
        doc["events"] += [
            {"at": 200, "kind": "scale", "name": "web", "replicas": 5},
            {"at": 400, "kind": "scale", "name": "web", "replicas": 7},
        ]
        sims = []
        for mod, out in ((ref_sim, tmp_path / "jax"), (None, tmp_path)):
            out.mkdir(exist_ok=True)
            sim = (mod.FleetSimulator(mod.parse_scenario(doc),
                                      flightrec_dir=str(out))
                   if mod is not None else
                   FleetSimulator(parse_scenario(doc), device="cpu",
                                  flightrec_dir=str(out)))
            sim.op.slo.breaches = deque(maxlen=1)
            sims.append((sim, sim.run()))
        (_, ref), (sim, report) = sims
        _held(report, ref)
        assert len(report["breaches"]) >= 3, report["breaches"]
        assert len([e for e in sim.ledger.entries
                    if e["kind"] == "breach"]) == len(report["breaches"])
        assert len(sim.op.slo.breaches) == 1

    def test_flaky_window_injects_then_recovers(self):
        doc = _doc(duration=1200.0, seed=5)
        doc["events"] += [
            {"at": 120, "kind": "flaky", "rate": 0.4, "duration": 300},
            {"at": 180, "kind": "scale", "name": "web", "replicas": 8},
        ]
        sim, report = _run(doc)
        assert sim.injector.fired() > 0, "flaky window never fired a fault"
        assert sim.injector.rate == 0.0, "flaky window never closed"
        assert report["final"]["pods_pending"] == 0
        assert report["final"]["pods_bound"] == 8

    def test_overlapping_flaky_windows_restore_live_window(self):
        doc = _doc(duration=900.0)
        doc["events"] += [
            {"at": 100, "kind": "flaky", "rate": 0.2, "terminal_rate": 0.1,
             "duration": 200},
            {"at": 200, "kind": "flaky", "rate": 0.05, "duration": 5000},
        ]
        sim, _ = _run(doc)
        assert sim.injector.rate == 0.05, sim.injector.rate
        assert sim.injector.terminal_rate == 0.0
        ends = [e for e in sim.ledger.entries if e["kind"] == "flaky_end"]
        assert len(ends) == 1

    def test_rolling_update_reaches_new_generation(self):
        from karpenter_tpu_torch.api.objects import Pod
        doc = _doc(duration=1800.0)
        doc["events"][0]["replicas"] = 6
        doc["events"].append({"at": 300, "kind": "rolling_update",
                              "name": "web", "batch": 2, "interval": 60})
        sim, report = _run(doc)
        done = [e for e in sim.ledger.entries if e["kind"] == "rollout_done"]
        assert done and done[0]["generation"] == 2
        gens = {p.metadata.labels.get("sim/gen")
                for p in sim.op.store.list(Pod, namespace="default")}
        assert gens == {"2"}, gens

    def test_sim_metrics_families_exported(self):
        from karpenter_tpu_torch.metrics.registry import REGISTRY
        _run(_doc(duration=300.0))
        text = REGISTRY.expose()
        for family in ("karpenter_sim_events_applied_total",
                       "karpenter_sim_ticks_total",
                       "karpenter_sim_clock_seconds",
                       "karpenter_sim_pod_hours_total",
                       "karpenter_sim_fleet_cost_dollars_total"):
            assert family in text, family


# -- the device, and what a run leaves behind --------------------------------

class TestDevice:
    def test_card_unless_cpu_is_named(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is usable")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            FleetSimulator(parse_scenario(_doc()))
        assert FleetSimulator(parse_scenario(_doc()),
                              device="cpu").device == torch.device("cpu")

    def test_cli_refuses_without_a_card_unless_cpu_is_named(self, tmp_path,
                                                            capsys):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is usable")
        from karpenter_tpu_torch.sim.__main__ import main
        p = tmp_path / "s.json"
        p.write_text(json.dumps(_doc(duration=120.0)))
        assert main(["run", str(p)]) == 2
        assert "device rejected: CUDA is not available" in \
            capsys.readouterr().err
        assert main(["run", str(p), "--device", "cuda:0"]) == 2
        assert main(["run", str(p), "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert out.startswith("fleet simulator device: cpu\n")

    def test_every_solve_runs_on_the_named_device(self):
        """The operator, every sidecar replica and the kill_device mesh get
        the simulator's one device; the mesh is eight slots over it."""
        doc = _doc()
        doc["events"] += [{"at": 50, "kind": "kill_device", "device": 9,
                           "duration": 120},
                          {"at": 60, "kind": "deploy", "name": "api",
                           "replicas": 4, "cpu": "250m",
                           "memory": "256Mi"}]
        sim = FleetSimulator(parse_scenario(doc), device="cpu")
        assert sim.op.device == torch.device("cpu")
        assert sim.mesh.devices.shape == (4, 2)
        assert {s.device for s in sim.mesh.devices.flat} == \
            {torch.device("cpu")}
        report = sim.run()
        assert dict(sim.device_killer.counts) == {1: 1}  # slot 9 % 8
        assert report["solver"]["fallback_fraction"] == 0.0
        fleet = FleetSimulator(parse_scenario(_doc(
            backend="sidecar", replicas=2)), device="cpu")
        try:
            assert [rep.device for _, _, rep in fleet.sidecar_replicas] == \
                [torch.device("cpu")] * 2
        finally:
            fleet.run()

    def test_run_restores_the_process_state_it_changed(self):
        """The tracer the operator configures, the collector the sidecar
        freezes, the device-chaos hook and the breakers, and the module
        session table are as they were once a run ends."""
        from karpenter_tpu_torch.obs.tracer import TRACER
        from karpenter_tpu_torch.ops import binpack
        from karpenter_tpu_torch.parallel import mesh
        from karpenter_tpu_torch.sidecar import server as srv
        tracer = (TRACER.enabled, TRACER.capacity, TRACER.watcher)
        gc.unfreeze()
        collector = (gc.isenabled(), 0)
        hook = binpack.install_device_chaos(None)
        binpack.install_device_chaos(hook)
        for backend in ("sidecar", "tensor"):
            doc = _doc(duration=300.0, backend=backend)
            doc["events"].append({"at": 40, "kind": "slo",
                                  "budgets": {"span.a": 1.0}})
            if backend == "tensor":
                doc["events"].append({"at": 50, "kind": "kill_device",
                                      "duration": 600})
            FleetSimulator(parse_scenario(doc), device="cpu").run()
            assert (TRACER.enabled, TRACER.capacity, TRACER.watcher) == \
                tracer
            assert (gc.isenabled(), gc.get_freeze_count()) == collector
            assert binpack.install_device_chaos(hook) is hook
            assert not mesh._DEVICE_BREAKERS
            assert not srv._SESSIONS


# -- solver_backend=sidecar --------------------------------------------------

class TestServiceBackend:
    DOC = {
        "name": "svc", "seed": 5, "duration": 900.0, "tick": 20,
        "backend": "sidecar",
        "events": [
            {"at": 5, "kind": "deploy", "name": "web", "replicas": 4,
             "cpu": "500m", "memory": "256Mi"},
            {"at": 120, "kind": "wire_chaos", "drop": 0.1,
             "disconnect": 0.1, "duration": 300},
            {"at": 300, "kind": "scale", "name": "web", "replicas": 8},
            {"at": 500, "kind": "wire_chaos", "kill_server": True,
             "duration": 60},
            {"at": 700, "kind": "scale", "name": "web", "replicas": 6},
        ],
    }

    def test_sidecar_backend_with_faults_completes_and_heals(self):
        sim, report = _run(self.DOC)
        assert report["backend"] == "sidecar"
        assert report["final"]["pods_pending"] == 0
        assert report["final"]["pods_bound"] == 6
        tts = report["time_to_schedule"]
        assert tts["samples"] > 0 and tts["p99_s"] > 0
        svc = report["service"]
        assert svc["backend"] == "sidecar" and svc["deadline_s"] > 0
        assert svc["resyncs"] >= 1
        kinds = [e["kind"] for e in sim.ledger.entries]
        assert "sidecar_restart" in kinds and "wire_chaos_end" in kinds
        assert any(e.get("event") == "wire_chaos"
                   for e in sim.ledger.entries)
        assert sim.sidecar_server is None

    def test_sidecar_backend_same_seed_byte_identical_digest(self):
        _, r1 = _run(self.DOC)
        r2 = FleetSimulator(parse_scenario(copy.deepcopy(self.DOC)),
                            device="cpu").run()
        assert r1["ledger_digest"] == r2["ledger_digest"]

    def test_tensor_backend_reports_no_service_section(self):
        _, report = _run(_doc())
        assert report["backend"] == "tensor"
        assert report["service"] is None

    def test_service_faults_library_scenario_validates(self):
        sc = load_scenario(os.path.join(SCENARIOS_DIR,
                                        "service-faults.yaml"))
        assert sc.backend == "sidecar"
        assert any(e.kind == "wire_chaos" and e.params["kill_server"]
                   for e in sc.events)


# -- CLI ---------------------------------------------------------------------

class TestCli:
    def test_validate_accepts_library_scenario(self, capsys):
        from karpenter_tpu_torch.sim.__main__ import main
        path = os.path.join(SCENARIOS_DIR, "rolling-deploy.yaml")
        assert main(["validate", path]) == 0
        assert "rolling-deploy" in capsys.readouterr().out

    def test_validate_rejects_loudly(self, tmp_path, capsys):
        from karpenter_tpu_torch.sim.__main__ import main
        p = tmp_path / "bad.yaml"
        p.write_text("name: x\nduration: 600\nevents:\n  - at: 5\n"
                     "    kind: nope\n")
        assert main(["validate", str(p)]) == 2
        assert "unknown event kind" in capsys.readouterr().err

    def test_run_writes_report_and_ledger(self, tmp_path, capsys):
        from karpenter_tpu_torch.sim.__main__ import main
        doc = _doc(duration=300.0)
        p = tmp_path / "s.json"
        p.write_text(json.dumps(doc))
        out = tmp_path / "report.json"
        ledger = tmp_path / "ledger.jsonl"
        assert main(["run", str(p), "--out", str(out),
                     "--ledger", str(ledger),
                     "--flightrec-dir", str(tmp_path), "--device",
                     "cpu"]) == 0
        report = json.loads(out.read_text())
        assert report["scenario"] == "t"
        assert len(ledger.read_text().splitlines()) \
            == report["ledger_entries"]
        _held(report, _reference(doc))
        rendered = capsys.readouterr().out
        assert "compression" in rendered and "pod-hour" in rendered
        assert main(["report", str(out)]) == 0
        assert "scenario    t" in capsys.readouterr().out
        assert main(["report", str(ledger)]) == 2
        err = capsys.readouterr().err
        assert "report rejected" in err and "run --out" in err
        assert main(["report", str(tmp_path / "missing.json")]) == 2
        assert "report rejected" in capsys.readouterr().err


# -- drift / expiration waves ------------------------------------------------

class TestDisruptionWaveEvents:
    def test_drift_and_expire_need_fraction_or_count(self):
        for kind, extra in (("drift", {}),
                            ("expire", {"expire_after": 600})):
            doc = _doc()
            doc["events"].append({"at": 9, "kind": kind, **extra})
            with pytest.raises(ScenarioError, match="at least one of"):
                parse_scenario(doc)

    def test_expire_requires_expire_after(self):
        doc = _doc()
        doc["events"].append({"at": 9, "kind": "expire", "count": 1})
        with pytest.raises(ScenarioError,
                           match="missing required field 'expire_after'"):
            parse_scenario(doc)

    def test_drift_wave_replaces_flagged_claims(self):
        _, report = _run({
            "name": "drift-wave-e2e", "seed": 7, "duration": 2400,
            "tick": 20, "disruption_interval": 60,
            "events": [
                {"at": 30, "kind": "deploy", "name": "web", "replicas": 9,
                 "cpu": "8", "memory": "8Gi", "spread": "zone"},
                {"at": 600, "kind": "drift", "count": 2},
            ]})
        assert report["events_applied"].get("drift") == 1
        assert report["churn"]["claims_terminated"] >= 2
        assert report["final"]["pods_pending"] == 0

    def test_expire_wave_retires_oldest_claims(self):
        _, report = _run({
            "name": "expire-wave-e2e", "seed": 7, "duration": 3600,
            "tick": 20, "disruption_interval": 60,
            "events": [
                {"at": 30, "kind": "deploy", "name": "web", "replicas": 9,
                 "cpu": "8", "memory": "8Gi", "spread": "zone"},
                {"at": 600, "kind": "expire", "count": 2,
                 "expire_after": 700},
            ]})
        assert report["events_applied"].get("expire") == 1
        assert report["churn"]["claims_terminated"] >= 2
        assert report["final"]["pods_pending"] == 0


# -- the sidecar fleet (tests/test_sidecar_fleet.py's simulator classes) -----

@pytest.mark.fleet
class TestFleetScenarioSchema:
    def test_replicas_require_the_sidecar_backend(self):
        with pytest.raises(ScenarioError,
                           match="requires 'backend: sidecar'"):
            parse_scenario(_doc(replicas=3))

    def test_rolling_restart_requires_a_fleet(self):
        doc = _doc(backend="sidecar")
        doc["events"].append({"at": 50, "kind": "rolling_restart"})
        with pytest.raises(ScenarioError, match="requires 'replicas: 1'"):
            parse_scenario(doc)

    def test_service_fleet_library_scenario_validates(self):
        sc = load_scenario(os.path.join(SCENARIOS_DIR, "service-fleet.yaml"))
        assert sc.backend == "sidecar" and sc.replicas == 3
        assert any(e.kind == "rolling_restart" for e in sc.events)
        assert any(e.kind == "wire_chaos" and e.params.get("kill_server")
                   for e in sc.events)


@pytest.mark.fleet
class TestFleetSimSmoke:
    DOC = {
        "name": "fleet-smoke", "seed": 23, "duration": 900.0, "tick": 20,
        "backend": "sidecar", "replicas": 2,
        "events": [
            {"at": 5, "kind": "deploy", "name": "web", "replicas": 4,
             "cpu": "500m", "memory": "256Mi"},
            {"at": 200, "kind": "wire_chaos", "kill_server": True,
             "replica": 1, "duration": 60},
            {"at": 400, "kind": "rolling_restart", "interval": 20,
             "drain_grace": 0.5},
            {"at": 700, "kind": "scale", "name": "web", "replicas": 7},
        ],
    }

    def _doc(self, **over):
        doc = copy.deepcopy(self.DOC)
        doc.update(over)
        return doc

    def test_fleet_run_restores_warm_and_never_resyncs(self):
        _, report = _run(self._doc())
        svc = report["service"]
        assert svc["replicas"] == 2
        assert svc["rolling_restarts"] == 2
        assert svc["checkpoint_restores"] >= 1
        assert svc["resyncs"] == 0, \
            "a kill or roll cost a cold bootstrap despite the checkpoints"
        assert report["final"]["pods_pending"] == 0

    def test_replica_count_is_digest_invisible(self):
        _, two = _run(self._doc())
        one = FleetSimulator(parse_scenario(self._doc(replicas=1)),
                             device="cpu").run()
        assert two["ledger_digest"] == one["ledger_digest"]


# -- anti-entropy chaos (tests/test_state_audit.py's simulator class) --------

def audit_counts(sim) -> dict:
    """What a chaos run injected and what its auditor and the device
    ladder saw: faults injected per layer, incidents detected per layer
    (each quarantined and rebuilt cold), and the killed slots' hits."""
    return {
        "injected": dict(sim.state_corruptor.counts),
        "detected": {k.split(":", 1)[1]: v
                     for k, v in sim.state_auditor.stats.items()
                     if k.startswith("corrupt:")},
        "killed": dict(sim.device_killer.counts),
    }


@pytest.mark.audit
class TestSimChaosEvents:
    def test_corrupt_state_requires_tensor_backend(self):
        doc = _doc(backend="sidecar")
        doc["events"].append({"at": 50, "kind": "corrupt_state"})
        with pytest.raises(ScenarioError,
                           match=r"requires 'backend: tensor'"):
            parse_scenario(doc)

    def test_kill_device_requires_tensor_backend(self):
        doc = _doc(backend="sidecar")
        doc["events"].append({"at": 50, "kind": "kill_device",
                              "duration": 60})
        with pytest.raises(ScenarioError,
                           match=r"requires 'backend: tensor'"):
            parse_scenario(doc)

    def test_bad_layer_rejected(self):
        doc = _doc()
        doc["events"].append({"at": 50, "kind": "corrupt_state",
                              "layer": "node_rowz"})
        with pytest.raises(ScenarioError,
                           match=r"'layer'.*one of 'node_rows'"):
            parse_scenario(doc)

    def test_kill_device_missing_duration_rejected(self):
        doc = _doc()
        doc["events"].append({"at": 50, "kind": "kill_device"})
        with pytest.raises(ScenarioError, match=r"'duration'"):
            parse_scenario(doc)

    def test_chaos_run_ledger_digest_matches_fault_free_run(self):
        """A scenario with corrupt_state and kill_device events gives the
        ledger digest of the same scenario with the chaos stripped, in the
        port as in the reference, and the port's faults, detections and
        ladder hits are the reference's."""
        def doc(with_chaos):
            events = [
                {"at": 5, "kind": "deploy", "name": "web", "replicas": 8,
                 "cpu": "500m", "memory": "256Mi"},
                {"at": 180, "kind": "scale", "name": "web", "replicas": 11},
                {"at": 330, "kind": "scale", "name": "web", "replicas": 14},
                {"at": 480, "kind": "scale", "name": "web", "replicas": 9},
            ]
            if with_chaos:
                events += [
                    {"at": 150, "kind": "corrupt_state", "count": 2},
                    {"at": 300, "kind": "kill_device", "device": 0,
                     "duration": 150},
                ]
            return _doc(duration=600.0, seed=20, events=events)

        reports = {}
        for with_chaos in (True, False):
            sim = FleetSimulator(parse_scenario(doc(with_chaos)),
                                 device="cpu")
            reports[with_chaos] = sim.run()
            if with_chaos:
                assert sim.state_corruptor.injected, \
                    "chaos run injected nothing"
                ref = ref_sim.FleetSimulator(
                    ref_sim.parse_scenario(doc(True)))
                _held(reports[True], ref.run())
                assert audit_counts(sim) == audit_counts(ref)
                assert sim.state_corruptor.injected == \
                    ref.state_corruptor.injected
        assert reports[True]["ledger_digest"] == \
            reports[False]["ledger_digest"]
        assert reports[True]["final"] == reports[False]["final"]
