"""The Operator over the apiserver wire (``store_backend="kube"``), on the
CPU, against the JAX package:

- the JAX package's Operator over the JAX package's EnvtestServer beside
  the port's Operator over the port's EnvtestServer, each driven by
  chip_smoke.KubeWire on a fake clock to quiescence before every step (the
  watch events delivered in the server's order): a small burst of the
  benchmark mix (nine deployments of three pods over construct_catalog(40))
  and a seeded scale-down. After every step the normalised state of the
  server (uids and resourceVersions blanked, claims named by creation
  order) and the commands so far are equal, and so is every solve's decision
  digest;
- chip_smoke.py's two kube phases at a small size: ``operator_kube`` (the
  card's drive on the CPU against the CPU's, the plain versions counted as
  launches) and ``operator_kube_process`` (``python -m
  karpenter_tpu_torch.operator --device cpu --store-backend kube
  --leader-elect`` as a child: every pod bound, the first record replayed,
  exit 0 on SIGINT);
- the CLI refuses to start without a card unless a device is named, and a
  kernel failure inside a kube-backed solve reaches the caller.
"""

import collections
import importlib
import itertools
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
import test_torch_support as support
from test_torch_support import (JAX, PORT, ROOTS, fresh_registry,
                                plain_calls_counted)
from test_torch_support import device_series_kept  # noqa: F401 (autouse)
from test_torch_support import tracer_kept  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
#: nine deployments of three pods: every kind of the benchmark mix
N_PODS, N_DEPLOYS, N_ITS = 27, 9, 40
BURST_STEPS, SCALE_DOWN_STEPS = 8, 12


def mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


def _fresh_sequences(monkeypatch):
    """Both packages' claim names restart at 1, and their catalog-encode
    caches are empty, for each drive."""
    for root in ROOTS:
        for name in ("provisioning.scheduler",
                     "provisioning.tensor_scheduler"):
            monkeypatch.setattr(mod(root, name), "claim_name_seq",
                                itertools.count(1))
        monkeypatch.setattr(mod(root, "provisioning.tensor_scheduler"),
                            "_CATALOG_CACHE", collections.OrderedDict())


def drive(root: str, seed: int, monkeypatch) -> dict:
    """``root``'s Operator over ``root``'s EnvtestServer: the burst for
    BURST_STEPS steps, then a half of each deployment (drawn from
    ``seed``) deleted, the clock past the consolidation TTL and
    SCALE_DOWN_STEPS steps. Returns the digest after every step, each
    solve's decision digest and the commands."""
    k = support.pkg(root)
    clock = mod(root, "utils.clock").FakeClock()
    record = mod(root, "flightrec.record")
    ts_cls = k.ts.TensorScheduler
    solves = []
    solve = ts_cls.solve

    def noting(self, pods, *a, **kw):
        results = solve(self, pods, *a, **kw)
        solves.append((self.fallback_reason,
                       record.decision_digest(results, pods,
                                              self.fallback_reason)))
        return results
    monkeypatch.setattr(ts_cls, "solve", noting)
    with tempfile.TemporaryDirectory() as tmp:
        wire = chip_smoke.KubeWire(
            clock, tmp, envtest=mod(root, "kube.envtest"),
            apiserver=mod(root, "kube.apiserver"),
            manifests=mod(root, "api.crds").manifests())
        provider = k.kwok.KwokCloudProvider(
            instance_types=k.kwok.construct_catalog(N_ITS))
        opts = mod(root, "operator.options").Options(
            metrics_port=0, health_probe_port=0, log_level="error",
            store_backend="kube", kubeconfig=wire.kubeconfig)
        kw = {"device": "cpu"} if root == PORT else {}
        op = mod(root, "operator.operator").Operator(
            opts, cloud_provider=provider, clock=clock, **kw)
        provider.store = op.store
        NodeClaim = mod(root, "api.nodeclaim").NodeClaim
        order, commands, digests, counts = [], [], [], []
        op.store.watch(lambda ev: ev.kind is NodeClaim
                       and ev.type == "ADDED" and order.append(ev.obj.name))
        add = op.queue.add

        def queued(qc):
            commands.append((qc.command.reason, tuple(sorted(
                c.state_node.name() for c in qc.command.candidates)),
                len(qc.replacement_names)))
            return add(qc)
        op.queue.add = queued
        try:
            wire.attach(op.store, mod(root, "kube.k8s_codec").WATCH_KINDS)
            wire.client.create(support.default_pool(root))
            pods = support.bench_pods(root, N_PODS, N_DEPLOYS)
            for p in pods:
                wire.client.create(p)

            def step():
                wire.step(op)
                digests.append((wire.state_digest(order), tuple(commands)))
                counts.append(wire.counts())
                op.clock.step(1.1)
            for _ in range(BURST_STEPS):
                step()
            rng = np.random.default_rng(seed)
            by_app = collections.defaultdict(list)
            for p in pods:
                by_app[p.labels["app"]].append(p)
            for group in by_app.values():
                for i in rng.choice(len(group), size=len(group) // 2 + 1,
                                    replace=False):
                    wire.client.delete(group[i])
            step()
            op.clock.step(mod(root, "disruption.validation")
                          .CONSOLIDATION_TTL_SECONDS + 1.0)
            for _ in range(SCALE_DOWN_STEPS):
                step()
        finally:
            op.stop_serving()
            wire.close(op)
    return {"digests": digests, "solves": solves, "commands": commands,
            "counts": counts}


@pytest.mark.parametrize("seed", [0, 1])
def test_kube_operator_matches_the_reference_every_step(seed, monkeypatch):
    _fresh_sequences(monkeypatch)
    runs = {}
    for root in ROOTS:
        with fresh_registry(JAX), fresh_registry(PORT):
            runs[root] = drive(root, seed, monkeypatch)
        monkeypatch.undo()
        _fresh_sequences(monkeypatch)
    want, got = runs[JAX], runs[PORT]
    assert len(got["digests"]) == len(want["digests"]) == \
        BURST_STEPS + SCALE_DOWN_STEPS + 1
    for i, (w, g) in enumerate(zip(want["digests"], got["digests"])):
        assert g == w, f"step {i}: the apiserver states differ"
    assert got["counts"] == want["counts"]
    assert got["solves"] == want["solves"] and got["solves"]
    assert not any(reason for reason, _ in got["solves"])
    # the burst bound pods and the scale-down consolidated
    last = got["counts"][-1]
    assert last["claims"] and last["nodes"] and last["bound"]
    assert got["digests"][-1][1] == tuple(want["commands"])
    assert got["commands"], "the scale-down executed no command"


# -- chip_smoke.py's kube phases on the CPU -----------------------------------

@pytest.fixture()
def counted():
    with plain_calls_counted(chip_smoke.FEASIBILITY):
        yield


def test_chip_smoke_operator_kube_phase_on_the_cpu(counted, monkeypatch):
    from karpenter_tpu_torch.ops import kernels
    _fresh_sequences(monkeypatch)
    paths = {}

    def record():
        paths["operator_kube"] = dict(kernels.LAUNCHES)
        return paths["operator_kube"]
    with fresh_registry(PORT):
        lines = chip_smoke.operator_phase(
            "cpu", record, phase="operator_kube", kube=True,
            n_pods=54, n_deploys=9, n_its=N_ITS)
    summary = lines[-1]
    assert summary["phase"] == "operator_kube"
    assert summary["digest_equals_cpu_every_step"]
    assert summary["state_digest_equals_cpu_every_step"]
    assert summary["solves"] and summary["fallbacks"] == 0
    assert summary["commands"]
    for name in chip_smoke.FEASIBILITY:
        assert paths["operator_kube"][name] > 0, name
    wire = summary["wire"]
    assert wire["requests"] > 0 and wire["watch_events"] > 0
    assert 0 < wire["wire_share"] <= 1 and wire["apply_requests"] >= 55
    steps = [ln for ln in lines if ln["phase"] == "operator_kube_step"]
    assert len(steps) == summary["steps"]
    assert all(s["rounds"] >= 1 and "events" in s for s in steps)


def test_chip_smoke_operator_kube_process_phase_on_the_cpu():
    out = chip_smoke.operator_kube_process_phase("cpu", n_pods=18,
                                                 n_deploys=9)
    assert out["exit_code"] == 0 and out["bound"] == out["pods"] == 18
    assert "device=cpu" in out["started"]
    assert out["replayed"]["match"] and out["replayed"]["kind"] == \
        "provisioning"
    assert out["crds"] == ["nodeclaims.karpenter.sh", "nodepools.karpenter.sh"]
    assert len(out["lease_holder"]) == 1


def test_cli_without_a_card_exits_non_zero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch.operator",
         "--store-backend", "kube", "--kubeconfig", "/nonexistent",
         "--log-level", "error"], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "operator starting" not in proc.stdout


def test_kernel_failure_in_a_kube_backed_solve_reaches_the_caller(
        monkeypatch):
    from karpenter_tpu_torch.api.objects import Pod
    from karpenter_tpu_torch.kube.k8s_codec import WATCH_KINDS
    from karpenter_tpu_torch.operator.operator import Operator
    from karpenter_tpu_torch.operator.options import Options
    from karpenter_tpu_torch.ops import kernels
    from karpenter_tpu_torch.utils.clock import FakeClock
    clock = FakeClock()
    with tempfile.TemporaryDirectory() as tmp:
        wire = chip_smoke.KubeWire(clock, tmp)
        op = Operator(Options(metrics_port=0, health_probe_port=0,
                              log_level="error", store_backend="kube",
                              kubeconfig=wire.kubeconfig),
                      clock=clock, device="cpu")
        try:
            wire.attach(op.store, WATCH_KINDS)
            wire.client.create(chip_smoke.default_pool())
            for p in chip_smoke.bench_pods(18, 9):
                wire.client.create(p)
            wire.settle()
            wire.pump()

            def broken(*a, **kw):
                raise kernels.KernelError("catalog_feasibility: launch "
                                          "refused")
            monkeypatch.setattr(kernels, "catalog_feasibility", broken)
            pending = [p for p in op.store.list(Pod) if not p.spec.node_name]
            with pytest.raises(kernels.KernelError, match="launch refused"):
                op.provisioner.schedule(pending)
        finally:
            wire.close(op)
