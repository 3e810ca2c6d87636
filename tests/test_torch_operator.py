"""tests/test_operator.py pointed at the port: operator wiring, options,
events recorder, metrics, aux controllers. Every operator runs its solves
on the CPU (``device="cpu"``: the kernels' plain PyTorch versions); the
port's own operator rules (CUDA unless asked, the sidecar backend held to
the JAX package's) are at the end."""

import time

import pytest

from karpenter_tpu_torch.api import labels as api_labels
from karpenter_tpu_torch.api.nodeclaim import NodeClaim
from karpenter_tpu_torch.api.nodepool import NodePool
from karpenter_tpu_torch.api.objects import Node, Pod
from karpenter_tpu_torch.cloudprovider.kwok import KwokCloudProvider
from karpenter_tpu_torch.cloudprovider.types import RepairPolicy
from karpenter_tpu_torch.events.recorder import Event, Recorder
from karpenter_tpu_torch.metrics.registry import REGISTRY, Registry
from karpenter_tpu_torch.operator.operator import Operator
from karpenter_tpu_torch.operator.options import FeatureGates, Options, parse_options
from karpenter_tpu_torch.utils.clock import FakeClock

from test_torch_support import PORT, factories
from test_torch_support import device_series_kept  # noqa: F401 (autouse)
from test_torch_support import sidecar_state_kept  # noqa: F401 (autouse)
from test_torch_support import tracer_kept  # noqa: F401 (autouse)

make_nodepool = factories(PORT).make_nodepool
make_pod = factories(PORT).make_pod
make_pods = factories(PORT).make_pods


@pytest.fixture
def op():
    return Operator(clock=FakeClock(), device="cpu")


def settle(op, rounds=6):
    for _ in range(rounds):
        op.step()
        op.clock.step(1.1)
    assert op.step(), "operator did not quiesce"


class TestOperator:
    def test_full_wiring_provisions(self, op):
        op.store.create(make_nodepool(name="default"))
        for p in make_pods(4, cpu="500m"):
            op.store.create(p)
        settle(op)
        assert all(p.spec.node_name for p in op.store.list(Pod))
        assert op.store.list(Node)

    def test_nodepool_hash_annotation_maintained(self, op):
        pool = make_nodepool(name="default")
        op.store.create(pool)
        op.step()
        assert pool.metadata.annotations[
            api_labels.NODEPOOL_HASH_ANNOTATION_KEY] == pool.static_hash()

    def test_nodepool_counter_aggregates(self, op):
        pool = make_nodepool(name="default")
        op.store.create(pool)
        op.store.create(make_pod(cpu="500m"))
        settle(op)
        assert pool.status.resources.get("nodes") == 1000
        assert pool.status.resources.get("cpu", 0) > 0

    def test_expiration_deletes_old_claims(self, op):
        pool = make_nodepool(name="default")
        pool.spec.template.spec.expire_after = 3600.0
        op.store.create(pool)
        op.store.create(make_pod(cpu="500m"))
        settle(op)
        assert len(op.store.list(NodeClaim)) == 1
        op.clock.step(3700)
        settle(op)
        # claim expired; replacement provisioned for the rescheduled pod
        for p in op.store.list(Pod):
            assert p.spec.node_name
        claims = op.store.list(NodeClaim)
        assert all(op.clock.now() -
                   c.metadata.creation_timestamp < 3600 for c in claims)

    def test_garbage_collection_removes_vanished_instances(self, op):
        op.store.create(make_nodepool(name="default"))
        op.store.create(make_pod(cpu="500m"))
        settle(op)
        nc = op.store.list(NodeClaim)[0]
        # instance vanishes behind karpenter's back
        del op.cloud_provider.created[nc.status.provider_id]
        settle(op)  # gc singleton runs as part of step()
        assert op.store.get(NodeClaim, nc.name) is None

    def test_metrics_exposed(self, op):
        op.store.create(make_nodepool(name="default"))
        op.store.create(make_pod(cpu="500m"))
        settle(op)
        text = op.metrics_text()
        assert "karpenter_nodeclaims_created_total" in text
        assert "karpenter_provisioner_scheduling_duration_seconds_count" in text
        assert "karpenter_pods_bound_duration_seconds" in text
        assert "karpenter_nodes_allocatable" in text


class TestNodeRepair:
    def test_unhealthy_node_repaired(self):
        class RepairingKwok(KwokCloudProvider):
            def repair_policies(self):
                return [RepairPolicy(condition_type="Ready",
                                     condition_status="False",
                                     toleration_duration=300.0)]

        clock = FakeClock()
        op = Operator(options=Options(feature_gates="NodeRepair"),
                      cloud_provider=RepairingKwok(), clock=clock,
                      device="cpu")
        op.cloud_provider.store = op.store
        op.store.create(make_nodepool(name="default"))
        op.store.create(make_pod(cpu="500m"))
        settle(op)
        node = op.store.list(Node)[0]
        from karpenter_tpu_torch.utils.node import set_condition
        set_condition(node, "Ready", "False", now=clock.now())
        op.store.update(node)
        clock.step(301)
        settle(op)
        # node force-deleted and replaced; pod rescheduled
        live = op.store.list(Node)
        assert all(n.name != node.name for n in live)
        for p in op.store.list(Pod):
            assert p.spec.node_name


class TestOptions:
    def test_env_fallback(self, monkeypatch):
        monkeypatch.setenv("KARPENTER_BATCH_IDLE_DURATION", "2.5")
        opts = parse_options([])
        assert opts.batch_idle_duration == 2.5

    def test_flag_wins(self, monkeypatch):
        monkeypatch.setenv("KARPENTER_LOG_LEVEL", "debug")
        opts = parse_options(["--log-level", "error"])
        assert opts.log_level == "error"

    def test_feature_gates(self):
        fg = FeatureGates.parse("SpotToSpotConsolidation=true,NodeRepair")
        assert fg.spot_to_spot_consolidation and fg.node_repair
        assert not FeatureGates.parse("").node_repair


class TestRecorder:
    def test_dedupes_identical_events(self):
        clock = FakeClock()
        r = Recorder(clock)
        ev = lambda: Event(object_kind="Node", object_name="n1",
                           type="Normal", reason="Test", message="hi")
        r.publish(ev())
        r.publish(ev())
        assert len(r.events) == 1
        clock.step(121)
        r.publish(ev())
        assert len(r.events) == 2

    def test_different_messages_pass(self):
        r = Recorder(FakeClock())
        r.publish(Event("Node", "n1", "Normal", "Test", "a"))
        r.publish(Event("Node", "n1", "Normal", "Test", "b"))
        assert len(r.events) == 2


class TestMetrics:
    def test_counter_gauge_histogram(self):
        reg = Registry()
        c = reg.counter("test_total", "t", ("l",))
        c.inc({"l": "x"})
        c.inc({"l": "x"}, 2)
        assert c.value({"l": "x"}) == 3
        g = reg.gauge("test_gauge", "t")
        g.set(7.5)
        assert g.value() == 7.5
        h = reg.histogram("test_seconds", "t")
        h.observe(0.05)
        h.observe(3.0)
        assert h.count() == 2
        text = reg.expose()
        assert 'test_total{l="x"} 3' in text
        assert "test_seconds_bucket" in text


class TestBooleanFlags:
    """Flags must always mean what they say; env only moves the default
    (ADVICE round-1: store_false flip made --enable-profiling disable when
    KARPENTER_ENABLE_PROFILING=true)."""

    def test_flag_agrees_with_env(self, monkeypatch):
        from karpenter_tpu_torch.operator.options import parse_options
        monkeypatch.setenv("KARPENTER_ENABLE_PROFILING", "true")
        assert parse_options(["--enable-profiling"]).enable_profiling is True
        assert parse_options([]).enable_profiling is True

    def test_no_flag_disables(self, monkeypatch):
        from karpenter_tpu_torch.operator.options import parse_options
        monkeypatch.setenv("KARPENTER_ENABLE_PROFILING", "true")
        assert parse_options(["--no-enable-profiling"]).enable_profiling \
            is False


class TestConsistencyTaintCheck:
    def test_missing_taint_publishes_event(self):
        from karpenter_tpu_torch.api.nodeclaim import (COND_INITIALIZED,
                                                 COND_LAUNCHED,
                                                 COND_REGISTERED, NodeClaim,
                                                 NodeClaimSpec)
        from karpenter_tpu_torch.api.objects import (Node, NodeSpec, NodeStatus,
                                               ObjectMeta, Taint)
        from karpenter_tpu_torch.controllers.nodeclaim_aux import Consistency
        from karpenter_tpu_torch.events.recorder import Recorder
        from karpenter_tpu_torch.kube.store import Store
        from karpenter_tpu_torch.utils.clock import FakeClock
        from karpenter_tpu_torch.utils import resources as res

        clock = FakeClock()
        store = Store(clock)
        recorder = Recorder(clock)
        alloc = res.parse_list({"cpu": "4"})
        nc = NodeClaim(metadata=ObjectMeta(name="nc1", namespace=""),
                       spec=NodeClaimSpec(
                           taints=[Taint(key="dedicated", value="x",
                                         effect="NoSchedule")]))
        nc.status.node_name = "n1"
        nc.status.allocatable = dict(alloc)
        for cond in (COND_LAUNCHED, COND_REGISTERED, COND_INITIALIZED):
            nc.conditions.set_true(cond)
        store.create(nc)
        store.create(Node(metadata=ObjectMeta(name="n1", namespace=""),
                          spec=NodeSpec(),  # taint missing on the node
                          status=NodeStatus(capacity=dict(alloc),
                                            allocatable=dict(alloc))))
        Consistency(store, recorder, clock).reconcile(store.get(NodeClaim, "nc1"))
        msgs = [e.message for e in recorder.for_object("nc1")]
        assert any("taint" in m for m in msgs), msgs


class TestManagerTimerDedup:
    def test_requeue_coalesces_per_object(self):
        """workqueue AddAfter dedup: repeated requeue_after results from
        event-driven reconciles must keep ONE pending timer per
        (controller, object) — the earliest — not spawn a chain per event."""
        from karpenter_tpu_torch.controllers.manager import Controller, Manager, Result
        from karpenter_tpu_torch.kube.store import Store
        from karpenter_tpu_torch.utils.clock import FakeClock

        clock = FakeClock()
        store = Store(clock)
        fired = []

        class Periodic(Controller):
            name = "test.periodic"
            kinds = (Pod,)

            def reconcile(self, obj):
                fired.append(clock.now())
                return Result(requeue_after=300.0)

        mgr = Manager(store, clock)
        mgr.register(Periodic())
        pod = make_pod(cpu="100m")
        store.create(pod)
        mgr.drain()
        # a burst of unrelated events re-reconciles the pod repeatedly
        for _ in range(5):
            store.update(pod)
            mgr.drain()
        assert len(mgr._timer_pending) == 1
        n = len(fired)
        clock.step(301)
        mgr.drain()
        assert len(fired) == n + 1          # ONE timer fired, not six
        assert len(mgr._timer_pending) == 1  # and it rearmed exactly once

    def test_earlier_requeue_wins(self):
        from karpenter_tpu_torch.controllers.manager import Controller, Manager, Result
        from karpenter_tpu_torch.kube.store import Store
        from karpenter_tpu_torch.utils.clock import FakeClock

        clock = FakeClock()
        store = Store(clock)
        delays = iter([300.0, 5.0])
        fired = []

        class C(Controller):
            name = "test.varying"
            kinds = (Pod,)

            def reconcile(self, obj):
                fired.append(clock.now())
                return Result(requeue_after=next(delays, None))

        mgr = Manager(store, clock)
        mgr.register(C())
        pod = make_pod(cpu="100m")
        store.create(pod)
        mgr.drain()          # schedules +300
        store.update(pod)
        mgr.drain()          # schedules +5 -> fires first; +300 stays pending
        clock.step(6)
        mgr.drain()
        assert len(fired) == 3  # the 5s timer fired without waiting out 300s

    def test_later_requeue_not_dropped(self):
        """A later AddAfter must still fire even when an earlier timer is
        pending (client-go delivers every AddAfter time; dedup happens at
        queue insertion, not by discarding delays) — otherwise a controller
        relying on a later periodic recheck silently misses it."""
        from karpenter_tpu_torch.controllers.manager import Controller, Manager, Result
        from karpenter_tpu_torch.kube.store import Store
        from karpenter_tpu_torch.utils.clock import FakeClock

        clock = FakeClock()
        store = Store(clock)
        delays = iter([5.0, 300.0])
        fired = []

        class C(Controller):
            name = "test.later"
            kinds = (Pod,)

            def reconcile(self, obj):
                fired.append(clock.now())
                return Result(requeue_after=next(delays, None))

        mgr = Manager(store, clock)
        mgr.register(C())
        pod = make_pod(cpu="100m")
        store.create(pod)
        mgr.drain()          # schedules +5
        store.update(pod)
        mgr.drain()          # schedules +300 — must NOT be dropped
        clock.step(6)
        mgr.drain()          # +5 fires; reconcile returns no new requeue
        assert len(fired) == 3
        clock.step(300)
        mgr.drain()          # the later +300 intent still fires
        assert len(fired) == 4

    def test_latest_intent_survives_multiple_displacements(self):
        """Periodic recheck +300, then retry backoffs +5 and +1: the
        earliest fires first and the LATEST intent (the periodic recheck)
        must still fire even after two displacements; the sandwiched +5 is
        subsumed by the +1 reconcile, which saw newer state."""
        from karpenter_tpu_torch.controllers.manager import Controller, Manager, Result
        from karpenter_tpu_torch.kube.store import Store
        from karpenter_tpu_torch.utils.clock import FakeClock

        clock = FakeClock()
        store = Store(clock)
        delays = iter([300.0, 5.0, 1.0])
        fired = []

        class C(Controller):
            name = "test.displaced"
            kinds = (Pod,)

            def reconcile(self, obj):
                fired.append(clock.now())
                return Result(requeue_after=next(delays, None))

        mgr = Manager(store, clock)
        mgr.register(C())
        pod = make_pod(cpu="100m")
        store.create(pod)
        mgr.drain()          # schedules +300
        store.update(pod)
        mgr.drain()          # schedules +5 (displaces the +300 to deferred)
        store.update(pod)
        mgr.drain()          # schedules +1 (the +300 stays deferred)
        clock.step(2)
        mgr.drain()          # +1 fires; reconcile returns no requeue
        assert len(fired) == 4
        clock.step(300)
        mgr.drain()          # the +300 periodic recheck still fires
        assert len(fired) == 5
        # bounded: at most one live + one deferred timer per object, ever
        assert len(mgr._timer_pending) <= 1
        assert len(mgr._timer_deferred) <= 1


class TestExpirationSuite:
    """expiration/suite_test.go:149-199."""

    def _env(self):
        from karpenter_tpu_torch.controllers.nodeclaim_aux import Expiration
        from karpenter_tpu_torch.kube.store import Store
        clock = FakeClock()
        store = Store(clock)
        return store, clock, Expiration(store, clock)

    def _claim(self, store, expire_after):
        from karpenter_tpu_torch.api.nodeclaim import NodeClaim
        from karpenter_tpu_torch.api.objects import ObjectMeta
        nc = NodeClaim(metadata=ObjectMeta(name="exp-1", namespace=""))
        nc.spec.expire_after = expire_after
        store.create(nc)
        return nc

    def test_disabled_expiration_never_removes(self):
        store, clock, ctrl = self._env()
        nc = self._claim(store, None)  # Never
        clock.step(10**6)
        assert ctrl.reconcile(nc) is None
        from karpenter_tpu_torch.api.nodeclaim import NodeClaim
        assert store.get(NodeClaim, "exp-1", "") is not None

    def test_non_expired_claim_kept_with_requeue_at_expiry(self):
        store, clock, ctrl = self._env()
        nc = self._claim(store, 300.0)
        clock.step(100)
        result = ctrl.reconcile(nc)
        from karpenter_tpu_torch.api.nodeclaim import NodeClaim
        assert store.get(NodeClaim, "exp-1", "") is not None
        # requeue lands exactly at the remaining lifetime
        assert result is not None and abs(result.requeue_after - 200.0) < 1.0

    def test_expired_claim_deleted(self):
        store, clock, ctrl = self._env()
        nc = self._claim(store, 300.0)
        clock.step(301)
        ctrl.reconcile(nc)
        from karpenter_tpu_torch.api.nodeclaim import NodeClaim
        assert store.get(NodeClaim, "exp-1", "") is None

    def test_already_deleting_claim_not_expired_again(self):
        """expiration/suite_test.go:181-199."""
        store, clock, ctrl = self._env()
        nc = self._claim(store, 300.0)
        nc.metadata.finalizers.append("karpenter.sh/termination")
        clock.step(301)
        ctrl.reconcile(nc)   # starts deletion (finalizer holds the object)
        assert nc.metadata.deletion_timestamp is not None
        stamped = nc.metadata.deletion_timestamp
        clock.step(50)
        assert ctrl.reconcile(nc) is None  # no re-delete / no restamp
        assert nc.metadata.deletion_timestamp == stamped


class TestGarbageCollectionSuite:
    """garbagecollection/suite_test.go: both sweep directions."""

    def _env(self):
        from karpenter_tpu_torch.cloudprovider.kwok import KwokCloudProvider
        from karpenter_tpu_torch.controllers.nodeclaim_aux import GarbageCollection
        from karpenter_tpu_torch.kube.store import Store
        clock = FakeClock()
        store = Store(clock)
        provider = KwokCloudProvider(store=store)
        return store, clock, provider, GarbageCollection(store, provider, clock)

    def test_claim_with_vanished_instance_deleted(self):
        from karpenter_tpu_torch.api import labels as api_labels
        from karpenter_tpu_torch.api.nodeclaim import COND_LAUNCHED, NodeClaim
        from karpenter_tpu_torch.api.objects import ObjectMeta
        store, clock, provider, gc_ctrl = self._env()
        nc = NodeClaim(metadata=ObjectMeta(
            name="gc-1", namespace="",
            labels={api_labels.LABEL_INSTANCE_TYPE: "c-1x-amd64-linux"}))
        provider.create(nc)
        nc.conditions.set_true(COND_LAUNCHED, reason="Launched")
        store.create(nc)
        # instance vanishes out from under the claim (manual console delete)
        del provider.created[nc.status.provider_id]
        gc_ctrl.reconcile()
        assert store.get(NodeClaim, "gc-1", "") is None

    def test_untracked_instance_reaped(self):
        from karpenter_tpu_torch.api import labels as api_labels
        from karpenter_tpu_torch.api.nodeclaim import NodeClaim
        from karpenter_tpu_torch.api.objects import ObjectMeta
        store, clock, provider, gc_ctrl = self._env()
        ghost = NodeClaim(metadata=ObjectMeta(
            name="ghost", namespace="",
            labels={api_labels.LABEL_INSTANCE_TYPE: "c-1x-amd64-linux"}))
        provider.create(ghost)  # instance exists, claim never stored
        assert len(provider.list()) == 1
        gc_ctrl.reconcile()
        assert provider.list() == []

    def test_matched_pairs_left_alone(self):
        from karpenter_tpu_torch.api import labels as api_labels
        from karpenter_tpu_torch.api.nodeclaim import COND_LAUNCHED, NodeClaim
        from karpenter_tpu_torch.api.objects import ObjectMeta
        store, clock, provider, gc_ctrl = self._env()
        nc = NodeClaim(metadata=ObjectMeta(
            name="ok-1", namespace="",
            labels={api_labels.LABEL_INSTANCE_TYPE: "c-1x-amd64-linux"}))
        provider.create(nc)
        nc.conditions.set_true(COND_LAUNCHED, reason="Launched")
        store.create(nc)
        gc_ctrl.reconcile()
        assert store.get(NodeClaim, "ok-1", "") is not None
        assert len(provider.list()) == 1


class TestPodEventsSuite:
    """podevents/controller.go:63-98: lastPodEventTime with 5 s dedupe."""

    def test_pod_event_stamps_with_dedupe(self):
        from karpenter_tpu_torch.api.nodeclaim import NodeClaim
        from karpenter_tpu_torch.api.objects import ObjectMeta
        from karpenter_tpu_torch.controllers.nodeclaim_aux import PodEvents
        from karpenter_tpu_torch.kube.store import Store
        from karpenter_tpu_torch.state.cluster import Cluster
        clock = FakeClock()
        store = Store(clock)
        cluster = Cluster(store, clock)
        ctrl = PodEvents(store, cluster, clock)
        nc = NodeClaim(metadata=ObjectMeta(name="pe-1", namespace=""))
        nc.status.node_name = "n1"
        store.create(nc)
        pod = make_pod()
        pod.spec.node_name = "n1"
        store.create(pod)
        clock.step(10)
        ctrl.reconcile(pod)
        t1 = nc.status.last_pod_event_time
        assert t1 == clock.now()
        clock.step(2)  # inside the dedupe window
        ctrl.reconcile(pod)
        assert nc.status.last_pod_event_time == t1
        clock.step(4)  # past it
        ctrl.reconcile(pod)
        assert nc.status.last_pod_event_time == clock.now()


class TestHydration:
    """nodeclaim/node hydration: objects from older versions get current
    invariant fields backfilled."""

    def test_nodeclaim_hydrated_with_pool_label_and_finalizer(self):
        from karpenter_tpu_torch.api.objects import ObjectMeta, OwnerReference
        from karpenter_tpu_torch.controllers.hydration import NodeClaimHydration
        from karpenter_tpu_torch.kube.store import Store
        store = Store(FakeClock())
        nc = NodeClaim(metadata=ObjectMeta(
            name="old-nc", namespace="",
            owner_refs=[OwnerReference(kind="NodePool", name="default")]))
        nc.metadata.finalizers.clear()
        store.create(nc)
        NodeClaimHydration(store).reconcile(nc)
        assert nc.metadata.labels[api_labels.NODEPOOL_LABEL_KEY] == "default"
        assert api_labels.TERMINATION_FINALIZER in nc.metadata.finalizers

    def test_hydration_idempotent(self):
        from karpenter_tpu_torch.api.objects import ObjectMeta, OwnerReference
        from karpenter_tpu_torch.controllers.hydration import NodeClaimHydration
        from karpenter_tpu_torch.kube.store import Store
        store = Store(FakeClock())
        nc = NodeClaim(metadata=ObjectMeta(
            name="old-nc", namespace="",
            owner_refs=[OwnerReference(kind="NodePool", name="default")]))
        store.create(nc)
        h = NodeClaimHydration(store)
        h.reconcile(nc)
        rv = nc.metadata.resource_version
        h.reconcile(nc)  # second pass: nothing to backfill, no write
        assert nc.metadata.resource_version == rv


# -- the port's own rules --------------------------------------------------------

class TestDevice:
    def test_runs_on_cuda_unless_asked(self, monkeypatch):
        """With no device named the operator's solves go to CUDA; without a
        card it refuses to boot instead of running on the CPU, and leaves
        the process-wide tracer as it found it."""
        import torch
        from karpenter_tpu_torch.obs.tracer import TRACER
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        before = (TRACER.enabled, TRACER.capacity, TRACER.watcher)
        TRACER.enabled = False
        try:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                Operator(clock=FakeClock())
            assert TRACER.enabled is False
        finally:
            TRACER.enabled = before[0]

    def test_device_reaches_every_solver(self, op):
        import torch
        assert op.device == torch.device("cpu")
        assert op.provisioner.device == torch.device("cpu")
        assert op.disruption.provisioner is op.provisioner

    def test_sidecar_backend_refused_at_construction(self, monkeypatch):
        """With the solves on the sidecar the disruption loop still solves
        in this process: with no device named and no card, the operator
        refuses to start, before the tracer moves."""
        import torch
        from karpenter_tpu_torch.obs.tracer import TRACER
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        before = (TRACER.enabled, TRACER.capacity, TRACER.watcher)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Operator(options=Options(solver_backend="sidecar",
                                     solver_address="127.0.0.1:1",
                                     trace_ring=7),
                     clock=FakeClock())
        assert (TRACER.enabled, TRACER.capacity, TRACER.watcher) == before

    def test_sidecar_backend_matches_the_reference_every_step(
            self, monkeypatch):
        """The operator over the port's sidecar (both on the CPU) binds
        every pod of a small batch, and after every step its store equals
        the JAX operator's over the JAX package's sidecar."""
        from test_torch_support import (JAX, fresh_registry,
                                        reset_claim_names, sidecar_server)
        reset_claim_names(monkeypatch)
        runs = {}
        with sidecar_server(JAX) as (_, jax_address), \
                sidecar_server(PORT) as (_, port_address):
            for root, address in ((JAX, jax_address), (PORT, port_address)):
                with fresh_registry(root):
                    runs[root] = _sidecar_operator_steps(root, address)
        assert len(runs[PORT]) == len(runs[JAX])
        for i, (want, got) in enumerate(zip(runs[JAX], runs[PORT])):
            assert got == want, f"step {i}"
        claims, bound, nodes = runs[PORT][-1]
        assert claims and nodes
        assert all(node for _, node in bound), "a pod was left pending"

    def test_operator_configures_the_tracer(self):
        from karpenter_tpu_torch.obs.tracer import TRACER
        op = Operator(options=Options(trace_ring=9), clock=FakeClock(),
                      device="cpu")
        assert op.tracer is TRACER and TRACER.enabled
        assert TRACER.capacity == 9
        op = Operator(options=Options(trace_ring=0), clock=FakeClock(),
                      device="cpu")
        assert not TRACER.enabled


def _sidecar_operator_steps(root: str, address: str, steps: int = 7):
    """``root``'s Operator with ``solver_backend="sidecar"`` against the
    sidecar at ``address``: a pool and twelve pods (eight plain, four
    zone-spread), stepped under a fake clock; after each step the claims'
    instance types, zones and capacity types, each pod's node and the
    nodes. Pod names restart at 1."""
    import importlib
    import itertools
    F = factories(root)
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    L = mod("api.labels")
    saved, F._seq = F._seq, itertools.count(1)
    try:
        kw = {"device": "cpu"} if root == PORT else {}
        op = mod("operator.operator").Operator(
            mod("operator.options").Options(
                solver_backend="sidecar", solver_address=address,
                log_level="error"),
            clock=mod("utils.clock").FakeClock(), **kw)
        op.store.create(F.make_nodepool(name="default"))
        for p in (F.make_pods(8, cpu="500m")
                  + F.make_pods(4, cpu="1", labels={"app": "s"},
                                spread=[F.spread_zone(key="app",
                                                      value="s")])):
            op.store.create(p)
    finally:
        F._seq = saved
    NodeClaim = mod("api.nodeclaim").NodeClaim
    objects = mod("api.objects")
    out = []
    try:
        for _ in range(steps):
            op.step()
            claims = sorted((nc.metadata.labels.get(L.LABEL_INSTANCE_TYPE),
                             nc.metadata.labels.get(L.LABEL_TOPOLOGY_ZONE),
                             nc.metadata.labels.get(
                                 L.CAPACITY_TYPE_LABEL_KEY))
                            for nc in op.store.list(NodeClaim))
            bound = sorted((p.name, p.spec.node_name or "")
                           for p in op.store.list(objects.Pod))
            nodes = sorted(n.name for n in op.store.list(objects.Node))
            out.append((claims, bound, nodes))
            op.clock.step(1.1)
    finally:
        op.solver_session.close()
    return out


class TestCli:
    def test_main_takes_device_and_the_reference_flags(self, monkeypatch,
                                                       capsys):
        from karpenter_tpu_torch.operator import __main__ as cli
        seen = {}
        monkeypatch.setattr(cli.Operator, "run",
                            lambda self: seen.update(op=self))
        assert cli.main(["--device", "cpu", "--log-level", "error",
                         "--batch-idle-duration", "2.5",
                         "--feature-gates", "NodeRepair"]) == 0
        op = seen["op"]
        assert str(op.device) == "cpu"
        assert op.options.batch_idle_duration == 2.5
        assert op.options.gates.node_repair
        assert "device=cpu" in capsys.readouterr().out

    def test_main_without_a_card_refuses(self, monkeypatch):
        import torch
        from karpenter_tpu_torch.operator import __main__ as cli
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--log-level", "error"])

    def test_module_runs_on_the_cpu_and_stops_on_interrupt(self, tmp_path):
        """``python -m karpenter_tpu_torch.operator --device cpu`` serves its
        probes, and exits 0 on SIGINT, lease released."""
        import os
        import select
        import signal
        import socket
        import subprocess
        import sys
        import urllib.request
        from pathlib import Path

        def free_port():
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                return s.getsockname()[1]
        metrics, health = free_port(), free_port()
        repo = Path(__file__).resolve().parents[1]
        env = dict(os.environ, PYTHONPATH=str(repo))
        proc = subprocess.Popen(
            [sys.executable, "-m", "karpenter_tpu_torch.operator",
             "--device", "cpu", "--metrics-port", str(metrics),
             "--health-probe-port", str(health), "--log-level", "error",
             "--leader-elect", "--lease-file", str(tmp_path / "op.lease")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=str(tmp_path), env=env)
        try:
            ready, _, _ = select.select([proc.stdout], [], [], 120)
            assert ready, "the operator printed nothing in 120 s"
            assert "device=cpu" in proc.stdout.readline()
            deadline = time.time() + 60
            while True:
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{health}/healthz",
                            timeout=5) as resp:
                        assert resp.read() == b"ok"
                    break
                except OSError:
                    assert time.time() < deadline, "no /healthz in 60 s"
                    time.sleep(0.2)
            proc.send_signal(signal.SIGINT)
            assert proc.wait(timeout=60) == 0, proc.stderr.read()[-2000:]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        from karpenter_tpu_torch.operator.leaderelection import FileLease
        lease = FileLease(str(tmp_path / "op.lease"), "next",
                          clock=FakeClock())
        assert lease.try_acquire(), "the stopped leader kept its lease"
