"""The whole control loop, the port against the JAX package: one seeded
timeline drives each package's ``Operator`` (FakeClock, the kwok provider
over its default catalog, node repair on) in lockstep, and after every
step the two clusters must agree exactly — the store (claims by creation
order, pods to nodes, nodes, the disruption commands), the published
events, and the exposition of every metric family the controllers move.

The timeline: a burst of deployments, a rollout of one, a scale-down that
consolidates, an expired claim, an unhealthy node. Timelines stay at 300
pods or fewer (the reference's exporters rescan the cluster per event).
Both packages' claim-name sequences restart at 1 for each timeline, so
claims, nodes and events carry the same names. The port solves on the CPU
(``device="cpu"``)."""

import collections
import importlib
import itertools

import numpy as np
import pytest

import test_torch_support as support
from test_torch_support import JAX, PORT, ROOTS, fresh_registry
from test_torch_support import device_series_kept  # noqa: F401 (autouse)
from test_torch_support import tracer_kept  # noqa: F401 (autouse)

SEEDS = (3, 11, 29)

#: histograms timed on the host's clock: their observations agree in
#: number (the ``_count`` samples are compared), not in seconds
WALL_TIMED = (
    "karpenter_cloudprovider_duration_seconds",
    "karpenter_disruption_candidate_build_seconds",
    "karpenter_provisioner_scheduling_duration_seconds",
    "karpenter_solver_phase_duration_seconds",
    "karpenter_voluntary_disruption_decision_evaluation_duration_seconds",
)
#: counters of host seconds (the fallback ledger's tensor-path cost, the
#: port's collector pauses inside traced passes), and a gauge of the whole
#: process: the subscribers of every live state plane, other operators'
#: planes that the garbage collector has not reached yet included
NOT_COMPARED = ("karpenter_fallback_tensor_seconds_total",
                "karpenter_gc_pause_seconds_total",
                "karpenter_state_plane_subscribers")
#: families and samples of each package's own device programs (the JAX
#: package's jit dispatches, compile cache, compile phase and its wait for
#: the device, device.execute, the port's kernel launches): what runs on
#: the device differs by design, the decisions do not
DEVICE_OWN = (
    "karpenter_device_", "karpenter_solver_compile_cache_",
    "karpenter_solver_device_",
)
DEVICE_OWN_LABELS = ('phase="compile"', 'phase="device.execute"')
#: samples of the stage spans only the port's tracer has
PORT_OWN_LABELS = ('phase="partition"', 'phase="pack.inputs"',
                   'phase="encode.taints"')


def mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


def exposition(reg) -> list:
    """The sample lines of every family, sorted (series order within a
    family is not part of the format), with the wall-timed histograms cut
    to their counts and each package's device families and own spans left
    out."""
    out = []
    for line in reg.expose().splitlines():
        if line.startswith("#"):
            continue
        name = line.split("{", 1)[0].split(" ", 1)[0]
        if name.startswith(DEVICE_OWN) or name in NOT_COMPARED \
                or any(label in line
                       for label in DEVICE_OWN_LABELS + PORT_OWN_LABELS):
            continue
        if name.startswith(WALL_TIMED) and not name.endswith("_count"):
            continue
        out.append(line)
    return sorted(out)


class Run:
    """One package's operator through the timeline."""

    def __init__(self, root: str, seed: int):
        self.root = root
        k = support.pkg(root)
        opmod = mod(root, "operator.operator")
        options = mod(root, "operator.options").Options(
            metrics_port=0, health_probe_port=0, log_level="error",
            feature_gates="NodeRepair")
        policy = mod(root, "cloudprovider.types").RepairPolicy

        class RepairingKwok(k.kwok.KwokCloudProvider):
            def repair_policies(self):
                return [policy(condition_type="Ready",
                               condition_status="False",
                               toleration_duration=300.0)]

        provider = RepairingKwok()
        kw = {"device": "cpu"} if root == PORT else {}
        self.op = opmod.Operator(options, cloud_provider=provider,
                                 clock=mod(root, "utils.clock").FakeClock(),
                                 **kw)
        # a caller's provider launches into the operator's own store
        provider.store = self.op.store
        self.clock = self.op.clock
        self.store = self.op.store
        self.o = k.objects
        self.NodeClaim = mod(root, "api.nodeclaim").NodeClaim
        self.claims_in_order = []
        self.commands = []
        kinds = (self.NodeClaim,)
        self.store.watch(lambda ev: ev.kind in kinds and ev.type == "ADDED"
                         and self.claims_in_order.append(ev.obj.name))
        add = self.op.queue.add

        def record(qc):
            self.commands.append((
                qc.command.reason,
                tuple(sorted(c.state_node.name()
                             for c in qc.command.candidates)),
                len(qc.replacement_names)))
            return add(qc)
        self.op.queue.add = record

    # -- the state compared after every step --------------------------------

    def digest(self) -> dict:
        L = support.pkg(self.root).labels
        live = {nc.name: nc for nc in self.store.list(self.NodeClaim)}
        claims = [(name,
                   live[name].metadata.labels.get(L.LABEL_INSTANCE_TYPE),
                   live[name].metadata.labels.get(L.LABEL_TOPOLOGY_ZONE),
                   live[name].metadata.labels.get(L.CAPACITY_TYPE_LABEL_KEY))
                  for name in self.claims_in_order if name in live]
        return {
            "claims": claims,
            "pods": sorted((p.name, p.spec.node_name)
                           for p in self.store.list(self.o.Pod)),
            "nodes": sorted(n.name for n in self.store.list(self.o.Node)),
            "commands": list(self.commands),
            "events": [(e.reason, e.object_kind, e.object_name, e.message)
                       for e in self.op.recorder.events],
        }


def deployments(root: str, seed: int) -> dict:
    """The burst: four or five deployments from the seed, at most 300 pods,
    each generic or spread over zones or hosts."""
    rng = np.random.default_rng(seed)
    out = {}
    for d in range(int(rng.integers(4, 6))):
        n = int(rng.integers(12, 60))
        cpu = ["250m", "500m", "1", "1500m"][int(rng.integers(0, 4))]
        kind = int(rng.integers(0, 3))
        out[f"app{d}"] = support.deployment(
            root, f"seed{seed}-app{d}", n, cpu=cpu,
            spread_key="zone" if kind == 1 else None,
            host_spread=kind == 2)
    assert sum(len(p) for p in out.values()) <= 300
    return out


class Lockstep:
    """The two runs, stepped together and compared after every step."""

    def __init__(self, seed: int):
        self.seed = seed
        self.runs = {root: Run(root, seed) for root in ROOTS}
        self.steps = 0

    def each(self, fn):
        for root, run in self.runs.items():
            fn(root, run)

    def step(self, seconds: float = 1.1) -> bool:
        quiet = {root: run.op.step() for root, run in self.runs.items()}
        self.steps += 1
        self.compare()
        assert quiet[JAX] == quiet[PORT], (self.steps, quiet)
        for run in self.runs.values():
            run.clock.step(seconds)
        return quiet[JAX]

    def compare(self):
        want = self.runs[JAX].digest()
        got = self.runs[PORT].digest()
        for key in want:
            assert want[key] == got[key], (self.seed, self.steps, key)
        want = exposition(self.runs[JAX].registry)
        got = exposition(self.runs[PORT].registry)
        assert want == got, (self.seed, self.steps, "metrics",
                             sorted(set(want) ^ set(got))[:12])

    def settle(self, max_steps: int = 20, seconds: float = 1.1) -> None:
        """Step until quiet twice in a row (the reference's ``settle``)."""
        calm = 0
        for _ in range(max_steps):
            calm = calm + 1 if self.step(seconds) else 0
            if calm == 2:
                return
        raise AssertionError(f"seed {self.seed}: no quiet in {max_steps}")

    def run_for(self, seconds: float, step: float = 1.1) -> None:
        """Step through ``seconds`` of fake time."""
        for _ in range(int(seconds / step) + 1):
            self.step(step)


def run_timeline(seed: int, monkeypatch) -> Lockstep:
    for root in ROOTS:
        for name in ("provisioning.scheduler", "provisioning.tensor_scheduler"):
            monkeypatch.setattr(mod(root, name), "claim_name_seq",
                                itertools.count(1))
        monkeypatch.setattr(mod(root, "provisioning.scheduler"),
                            "_hostname_seq", itertools.count(1))
        # an empty catalog-encode cache in both: whether the first solve
        # encodes the catalog (a solver phase span, counted in the
        # exposition) must not depend on what ran before in the process
        monkeypatch.setattr(mod(root, "provisioning.tensor_scheduler"),
                            "_CATALOG_CACHE", collections.OrderedDict())
    with fresh_registry(JAX) as jreg, fresh_registry(PORT) as preg:
        ls = Lockstep(seed)
        ls.runs[JAX].registry, ls.runs[PORT].registry = jreg, preg
        apps = {root: deployments(root, seed) for root in ROOTS}
        jrun = ls.runs[JAX]

        # burst
        def burst(root, run):
            run.store.create(support.nodepool(root, "default"))
            for pods in apps[root].values():
                for p in pods:
                    run.store.create(p)
        ls.each(burst)
        ls.settle()
        assert all(p.spec.node_name for p in jrun.store.list(jrun.o.Pod))
        assert jrun.digest()["claims"]

        # rollout: app0 is replaced by a bigger revision
        def rollout(root, run):
            for p in apps[root]["app0"]:
                run.store.delete(p)
            apps[root]["app0"] = support.deployment(
                root, f"seed{seed}-app0-v2", len(apps[root]["app0"]),
                cpu="2")
            for p in apps[root]["app0"]:
                run.store.create(p)
        ls.each(rollout)
        ls.settle()

        # scale-down: every other pod of each deployment goes; past the
        # consolidation TTL the nodes left underused are consolidated
        def scale_down(root, run):
            for pods in apps[root].values():
                for p in pods[::2]:
                    run.store.delete(p)
        ls.each(scale_down)
        ls.run_for(60.0)
        ls.settle()
        assert jrun.commands, "the scale-down consolidated nothing"

        # an expired claim: the oldest live claim's lifetime runs out
        def expire(root, run):
            nc = run.store.get(run.NodeClaim, victim)
            nc.spec.expire_after = run.clock.now() - \
                nc.metadata.creation_timestamp - 1.0
            run.store.update(nc)
        victim = jrun.digest()["claims"][0][0]
        ls.each(expire)
        ls.run_for(30.0)
        ls.settle()
        assert jrun.store.get(jrun.NodeClaim, victim) is None

        # an unhealthy node: Ready=False past its 300 s toleration
        sick = min(n.name for n in jrun.store.list(jrun.o.Node))

        def sicken(root, run):
            node = run.store.get(run.o.Node, sick)
            mod(root, "utils.node").set_condition(
                node, "Ready", "False", now=run.clock.now())
            run.store.update(node)
        ls.each(sicken)
        ls.step(301.0)
        ls.run_for(30.0)
        ls.settle()
        assert jrun.store.get(jrun.o.Node, sick) is None
        assert all(p.spec.node_name for p in jrun.store.list(jrun.o.Pod))
        for run in ls.runs.values():
            run.op.stop_serving()
        return ls


@pytest.mark.parametrize("seed", SEEDS)
def test_operator_timeline_matches_the_reference(seed, monkeypatch):
    ls = run_timeline(seed, monkeypatch)
    assert ls.steps > 10
