"""Trace-driven fleet simulator: replay a day of production in minutes.

Composes the existing chaos/fault/drought/flight-recorder subsystems into
a cluster-lifetime simulator (ROADMAP item 5): a seeded scenario timeline
(scenario.py) replayed against the full operator loop on an accelerated
FakeClock (engine.py), emitting an end-to-end SLO report and a
deterministic event ledger (report.py). CLI: ``python -m
karpenter_tpu_torch.sim run|report|validate``.
"""

from .engine import FleetSimulator
from .report import Ledger, build_report, render_report
from .scenario import (Scenario, ScenarioError, SimEvent, load_scenario,
                       parse_scenario)

__all__ = ["FleetSimulator", "Ledger", "Scenario", "ScenarioError",
           "SimEvent", "build_report", "load_scenario", "parse_scenario",
           "render_report"]
