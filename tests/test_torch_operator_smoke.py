"""chip_smoke.py's operator path, on the CPU at a small size, against the
JAX package: the same burst of the benchmark mix and the same scale-down
through each package's ``Operator`` (kwok over ``construct_catalog``, the
provider attached to the operator's own store, a fake clock) give the
same store after every step — the digest chip_smoke.py holds the card's
run to against the CPU's — and chip_smoke.operator_run gives that same
sequence of digests. Both packages' claim-name sequences restart at 1 for
each run."""

import collections
import hashlib
import importlib
import itertools

import pytest

import chip_smoke
import test_torch_support as support
from test_torch_support import JAX, PORT, ROOTS, fresh_registry
from test_torch_support import device_series_kept  # noqa: F401 (autouse)
from test_torch_support import tracer_kept  # noqa: F401 (autouse)

SIZES = dict(n_pods=540, n_deploys=12, n_its=40)


def mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


def drive(root: str, n_pods: int, n_deploys: int, n_its: int) -> list:
    """chip_smoke.operator_run's sequence for ``root``'s package; returns
    the digest after every step."""
    k = support.pkg(root)
    NodeClaim = mod(root, "api.nodeclaim").NodeClaim
    provider = k.kwok.KwokCloudProvider(
        instance_types=k.kwok.construct_catalog(n_its))
    opts = mod(root, "operator.options").Options(
        metrics_port=0, health_probe_port=0, log_level="error")
    kw = {"device": "cpu"} if root == PORT else {}
    op = mod(root, "operator.operator").Operator(
        opts, cloud_provider=provider,
        clock=mod(root, "utils.clock").FakeClock(), **kw)
    provider.store = op.store
    order, commands = [], []
    op.store.watch(lambda ev: ev.kind is NodeClaim and ev.type == "ADDED"
                   and order.append(ev.obj.name))
    add = op.queue.add

    def queued(qc):
        commands.append((qc.command.reason, tuple(sorted(
            c.state_node.name() for c in qc.command.candidates)),
            len(qc.replacement_names)))
        return add(qc)
    op.queue.add = queued
    L, Pod, Node = k.labels, k.objects.Pod, k.objects.Node

    def digest():
        live = {nc.name: nc.metadata.labels
                for nc in op.store.list(NodeClaim)}
        claims = tuple((live[n].get(L.LABEL_INSTANCE_TYPE),
                        live[n].get(L.LABEL_TOPOLOGY_ZONE),
                        live[n].get(L.CAPACITY_TYPE_LABEL_KEY))
                       for n in order if n in live)
        pods = hashlib.sha256("\n".join(
            f"{p.namespace}/{p.name} {p.spec.node_name}"
            for p in op.store.list(Pod)).encode()).hexdigest()
        nodes = tuple(sorted(n.name for n in op.store.list(Node)))
        return claims, pods, nodes, tuple(commands)

    def settled() -> bool:
        pods = op.store.list(Pod)
        r = op.provisioner.last_results
        return sum(1 for p in pods if p.spec.node_name) + \
            (len(r.pod_errors) if r else 0) == len(pods)

    out = []

    def step() -> bool:
        quiet = op.step()
        out.append(digest())
        op.clock.step(1.1)
        return quiet

    op.store.create(support.default_pool(root))
    pods = support.bench_pods(root, n_pods, n_deploys)
    for p in pods:
        op.store.create(p)
    calm = 0
    for _ in range(chip_smoke.OPERATOR_BURST_STEPS):
        calm = calm + 1 if step() else 0
        if calm >= 2 and settled():
            break
    by_app = collections.defaultdict(list)
    for p in pods:
        by_app[p.labels["app"]].append(p)
    for group in by_app.values():
        for p in group[::2]:
            op.store.delete(p)
    step()
    op.clock.step(mod(root, "disruption.validation")
                  .CONSOLIDATION_TTL_SECONDS + 1.0)
    calm = 0
    for _ in range(chip_smoke.OPERATOR_SCALE_DOWN_STEPS):
        calm = calm + 1 if step() else 0
        if calm >= 2 and commands and not op.queue.items and settled():
            break
    assert commands, f"{root}: the scale-down executed no command"
    return out


def _fresh_sequences(monkeypatch):
    for root in ROOTS:
        for name in ("provisioning.scheduler",
                     "provisioning.tensor_scheduler"):
            monkeypatch.setattr(mod(root, name), "claim_name_seq",
                                itertools.count(1))


def test_operator_path_matches_the_reference_every_step(monkeypatch):
    _fresh_sequences(monkeypatch)
    with fresh_registry(JAX), fresh_registry(PORT):
        want = drive(JAX, **SIZES)
        got = drive(PORT, **SIZES)
    assert len(want) == len(got) >= 5
    for i, (w, g) in enumerate(zip(want, got)):
        assert w == g, f"step {i}"


def test_chip_smoke_operator_run_is_that_path(monkeypatch):
    _fresh_sequences(monkeypatch)
    with fresh_registry(PORT):
        want = drive(PORT, **SIZES)
        run = chip_smoke.operator_run("cpu", **SIZES)
    assert run["digests"] == want
    assert run["fallbacks"] and not any(run["fallbacks"])
    stages = [s["stage"] for s in run["steps"]]
    assert stages[0] == "burst" and stages[-1] == "scale_down"
    assert run["commands"] and run["unschedulable"]
    # every pod left pending is one the provisioner could not place: the
    # mix's hostname-affinity deployments
    assert set(run["unschedulable"]) == {
        "hostname pod affinity: no co-located capacity"}


@pytest.mark.parametrize("stage", ["burst", "scale_down"])
def test_chip_smoke_operator_steps_report_their_work(stage, monkeypatch):
    _fresh_sequences(monkeypatch)
    with fresh_registry(PORT):
        run = chip_smoke.operator_run("cpu", **SIZES)
    steps = [s for s in run["steps"] if s["stage"] == stage]
    assert steps and all(s["s"] > 0 for s in steps)
    assert all(s["pods"] >= s["bound"] for s in steps)
    # the exporters run on every step that moved a pod
    assert sum(s["exporters_s"] for s in steps) > 0
    assert any(s["spans_ms"] for s in steps)
