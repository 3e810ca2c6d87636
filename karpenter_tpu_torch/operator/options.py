"""Flat options struct with flag + env fallback.

Mirrors karpenter's pkg/operator/options/options.go:49-157: a single
Options dataclass, every field settable by CLI flag or KARPENTER_-prefixed
environment variable (flag wins), feature gates as a comma-separated string.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional


@dataclass
class FeatureGates:
    """options.go:127-144."""
    spot_to_spot_consolidation: bool = False
    node_repair: bool = False

    @classmethod
    def parse(cls, raw: str) -> "FeatureGates":
        fg = cls()
        for part in raw.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, value = part.partition("=")
            val = value.lower() in ("true", "1", "")
            if name == "SpotToSpotConsolidation":
                fg.spot_to_spot_consolidation = val
            elif name == "NodeRepair":
                fg.node_repair = val
        return fg


@dataclass
class Options:
    """The reference's flag set, minus the kube-client tuning that has no
    analog here (options.go:49-102)."""
    metrics_port: int = 8080
    health_probe_port: int = 8081
    log_level: str = "info"
    batch_max_duration: float = 10.0
    batch_idle_duration: float = 1.0
    feature_gates: str = ""
    cpu_requests: str = ""  # reserved
    cluster_name: str = "karpenter-tpu"
    enable_profiling: bool = False
    # durable-state snapshot path ("" = in-memory only). The reference's
    # durable state is the apiserver; standalone, the store checkpoints here
    # and restores on boot (restart = resync, state/cluster.go:96-150)
    state_file: str = ""
    # decision flight recorder ring size (records kept in memory for
    # /debug/flightrecorder and offline replay); 0 disables recording.
    # Each record pins its full solver inputs until dumped — size for
    # incident context, not history.
    flightrec_ring: int = 32
    # pass tracer ring size (completed pass traces kept for /debug/traces
    # and the obs dump CLI); 0 disables span tracing entirely. Traces are
    # a few KB each (span names + timings, no object pins).
    trace_ring: int = 64
    # SLO budgets as "span=seconds,..." (e.g.
    # "provisioner.pass=2.0,disruption.pass=5.0,solve=1.0"); "" disables
    # the watcher. A breaching pass increments
    # karpenter_slo_breaches_total{slo}, publishes an SLOBreached warning
    # event, and dumps its flight-recorder records to
    # $KARPENTER_FLIGHTREC_DIR.
    slo_budgets: str = ""
    # solver knobs (new surface: no reference analog)
    solver_backend: str = "tensor"   # tensor | sidecar
    solver_address: str = "127.0.0.1:50551"  # sidecar gRPC endpoint
    solver_devices: int = 0          # 0 = all visible
    # state backend: "memory" = in-process store (DEVIATIONS #6),
    # "kube" = a real Kubernetes apiserver via kube/apiserver.py
    # (operator.go:105-206 deployment model; requires the generated CRDs)
    store_backend: str = "memory"    # memory | kube
    kubeconfig: str = ""             # "" = $KUBECONFIG / ~/.kube/config
    # HA: only the lease holder runs controllers (operator.go:137-141)
    leader_elect: bool = False
    lease_file: str = ""             # default: <state_file>.lease
    lease_duration: float = 15.0
    # kwok simulation: the kubelet analog that clears startup/ephemeral
    # taints and stamps Ready after kwok_ready_delay. Disable for scenarios
    # that assert on pre-initialization taint states.
    kwok_kubelet: bool = True
    kwok_ready_delay: float = 2.0

    @property
    def gates(self) -> FeatureGates:
        return FeatureGates.parse(self.feature_gates)


_ENV_PREFIX = "KARPENTER_"


def _env_name(flag: str) -> str:
    return _ENV_PREFIX + flag.upper().replace("-", "_")


def parse_options(argv: Optional[List[str]] = None) -> Options:
    """Flag > env > default (options.go BoolVarWithEnv pattern)."""
    defaults = Options()
    parser = argparse.ArgumentParser(prog="karpenter-tpu")
    for f in fields(Options):
        flag = "--" + f.name.replace("_", "-")
        env = os.environ.get(_env_name(f.name))
        default = getattr(defaults, f.name)
        if env is not None:
            if f.type in ("bool", bool):
                default = env.lower() in ("true", "1")
            elif f.type in ("int", int):
                default = int(env)
            elif f.type in ("float", float):
                default = float(env)
            else:
                default = env
        if isinstance(default, bool):
            # --flag / --no-flag always mean what they say; env only moves
            # the default (a store_false flip would make e.g.
            # KARPENTER_ENABLE_PROFILING=true + --enable-profiling DISABLE
            # profiling)
            parser.add_argument(flag, action=argparse.BooleanOptionalAction,
                                default=default, dest=f.name)
        else:
            parser.add_argument(flag, type=type(default), default=default,
                                dest=f.name)
    ns = parser.parse_args(argv or [])
    return Options(**vars(ns))
