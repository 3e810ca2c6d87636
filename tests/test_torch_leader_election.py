"""tests/test_leader_election.py pointed at the port. Leader election
(operator.go:137-141 analog): file-lease acquire, renew, expiry steal,
graceful handoff — and the operator only reconciles while it holds the
lease. The operators solve on the CPU (``device="cpu"``); every join and
wait has its own bound."""

import threading
import time

import pytest

from karpenter_tpu_torch.api.objects import Node
from karpenter_tpu_torch.operator.leaderelection import FileLease
from karpenter_tpu_torch.operator.operator import Operator
from karpenter_tpu_torch.operator.options import Options
from karpenter_tpu_torch.utils.clock import FakeClock

from test_torch_support import PORT, factories
from test_torch_support import device_series_kept  # noqa: F401 (autouse)
from test_torch_support import tracer_kept  # noqa: F401 (autouse)

make_nodepool = factories(PORT).make_nodepool
make_pod = factories(PORT).make_pod


class TestFileLease:
    def test_acquire_then_rival_blocked(self, tmp_path):
        clock = FakeClock()
        path = str(tmp_path / "lease")
        a = FileLease(path, "op-a", lease_duration=15, clock=clock)
        b = FileLease(path, "op-b", lease_duration=15, clock=clock)
        assert a.try_acquire()
        assert not b.try_acquire()
        assert a.holder() == "op-a"

    def test_renew_extends(self, tmp_path):
        clock = FakeClock()
        a = FileLease(str(tmp_path / "lease"), "op-a", lease_duration=15,
                      clock=clock)
        b = FileLease(str(tmp_path / "lease"), "op-b", lease_duration=15,
                      clock=clock)
        assert a.try_acquire()
        clock.step(10)
        assert a.renew()
        clock.step(10)  # 20s since acquire, 10s since renew: still held
        assert not b.try_acquire()

    def test_expired_lease_stolen(self, tmp_path):
        clock = FakeClock()
        a = FileLease(str(tmp_path / "lease"), "op-a", lease_duration=15,
                      clock=clock)
        b = FileLease(str(tmp_path / "lease"), "op-b", lease_duration=15,
                      clock=clock)
        assert a.try_acquire()
        clock.step(16)  # op-a died: no renewal within the lease duration
        assert b.try_acquire()
        assert b.holder() == "op-b"
        # the late-waking old leader discovers the loss on renew
        assert not a.renew()

    def test_release_enables_immediate_takeover(self, tmp_path):
        clock = FakeClock()
        a = FileLease(str(tmp_path / "lease"), "op-a", lease_duration=15,
                      clock=clock)
        b = FileLease(str(tmp_path / "lease"), "op-b", lease_duration=15,
                      clock=clock)
        assert a.try_acquire()
        a.release()
        assert b.try_acquire()  # no expiry wait after graceful handoff

    def test_release_of_non_holder_is_noop(self, tmp_path):
        clock = FakeClock()
        a = FileLease(str(tmp_path / "lease"), "op-a", clock=clock)
        b = FileLease(str(tmp_path / "lease"), "op-b", clock=clock)
        assert a.try_acquire()
        b.release()
        assert a.holder() == "op-a"


class TestRenewDeadline:
    def test_wedged_renewal_thread_surrenders_leadership(self, tmp_path):
        """client-go aborts leadership when RenewDeadline elapses without a
        successful renew. A renewal thread that is blocked (wedged fcntl
        lock, scheduling stall) never flips _lease_lost — the run loop's
        deadline check must catch it BEFORE the lease expires and a standby
        legitimately steals it, or two leaders reconcile concurrently."""
        clock = FakeClock()
        op = Operator(options=Options(leader_elect=True,
                                      lease_file=str(tmp_path / "l")),
                      clock=clock, device="cpu")
        lease = op._lease()
        assert lease.try_acquire()
        t = op._start_renewal(lease)
        op._renew_stop.set()  # wedge: no renew attempt will ever complete
        t.join(timeout=5)
        assert not op._lease_lost.is_set()
        assert not op._renew_deadline_passed(lease)
        clock.step(9)   # renew deadline = 2/3 * 15 s = 10 s
        assert not op._renew_deadline_passed(lease)
        clock.step(2)   # 11 s since last renew: deadline passed...
        assert op._renew_deadline_passed(lease)
        clock.step(5)   # ...and only at 16 s could a standby steal the lease
        rival = FileLease(lease.path, "rival", lease_duration=15, clock=clock)
        assert rival.try_acquire()


class TestOperatorLeadership:
    def test_standby_does_not_reconcile(self, tmp_path):
        """Two operators over one lease: only the leader provisions; the
        standby serves probes but runs no controllers."""
        lease = str(tmp_path / "op.lease")
        leader = Operator(options=Options(
            metrics_port=0, health_probe_port=0, leader_elect=True,
            lease_file=lease), device="cpu")
        standby = Operator(options=Options(
            metrics_port=0, health_probe_port=0, leader_elect=True,
            lease_file=lease), device="cpu")
        stop = {"v": False}

        def run(op):
            op.run(stop=lambda: stop["v"], tick_seconds=0.02)

        t1 = threading.Thread(target=run, args=(leader,), daemon=True)
        t1.start()
        time.sleep(0.3)
        t2 = threading.Thread(target=run, args=(standby,), daemon=True)
        t2.start()
        time.sleep(0.3)
        # work lands in BOTH stores (separate processes in real life);
        # only the leader's controllers may act on it
        for op in (leader, standby):
            op.store.create(make_nodepool(name="default"))
            op.store.create(make_pod(cpu="500m"))
        deadline = time.time() + 60
        while time.time() < deadline and not leader.store.list(Node):
            time.sleep(0.2)
        stop["v"] = True
        t1.join(timeout=5)
        t2.join(timeout=5)
        assert leader.store.list(Node), "leader must provision"
        assert not standby.store.list(Node), "standby must not reconcile"


class FakeLeaseApi:
    """In-memory coordination-API double with resourceVersion CAS — the
    serialization semantics KubeLease depends on."""

    base_url = "https://fake"

    def __init__(self):
        self.lease = None
        self._rv = 0

    def _request(self, method, url, body=None):
        import urllib.error

        def err(code):
            return urllib.error.HTTPError(url, code, "", {}, None)

        if method == "GET":
            if self.lease is None:
                raise err(404)
            import copy
            return copy.deepcopy(self.lease)
        if method == "POST":
            if self.lease is not None:
                raise err(409)
            self._rv += 1
            body.setdefault("metadata", {})["resourceVersion"] = str(self._rv)
            self.lease = body
            return body
        if method == "PUT":
            if self.lease is None:
                raise err(404)
            if body.get("metadata", {}).get("resourceVersion") != \
                    self.lease["metadata"]["resourceVersion"]:
                raise err(409)
            self._rv += 1
            body["metadata"]["resourceVersion"] = str(self._rv)
            self.lease = body
            return body
        if method == "DELETE":
            self.lease = None
            return None
        raise AssertionError(method)


class TestKubeLease:
    def _pair(self):
        from karpenter_tpu_torch.operator.leaderelection import KubeLease
        from karpenter_tpu_torch.utils.clock import FakeClock
        api = FakeLeaseApi()
        clock = FakeClock()
        a = KubeLease(api, "replica-a", lease_duration=15.0, clock=clock)
        b = KubeLease(api, "replica-b", lease_duration=15.0, clock=clock)
        return api, clock, a, b

    def test_first_candidate_acquires(self):
        _, _, a, b = self._pair()
        assert a.try_acquire()
        assert a.holder() == "replica-a"
        assert not b.try_acquire()  # lease held and fresh

    def test_renewal_extends(self):
        _, clock, a, b = self._pair()
        assert a.try_acquire()
        clock.step(10)
        assert a.renew()
        clock.step(10)  # 20s since acquire but only 10 since renew
        assert not b.try_acquire()

    def test_expired_lease_stolen_with_transition_count(self):
        api, clock, a, b = self._pair()
        assert a.try_acquire()
        # b must OBSERVE the record unchanged for a full lease_duration by
        # its own clock before stealing — the remote renewTime is never
        # trusted directly (clock skew would allow stealing from a healthy
        # leader otherwise)
        assert not b.try_acquire()  # first observation starts b's window
        clock.step(16)              # record unchanged for > lease_duration
        assert b.try_acquire()
        assert b.holder() == "replica-b"
        assert api.lease["spec"]["leaseTransitions"] == 1
        # the deposed leader's renew must fail
        assert not a.renew()

    def test_renewing_leader_is_never_stolen_from(self, ):
        _, clock, a, b = self._pair()
        assert a.try_acquire()
        for _ in range(6):
            assert not b.try_acquire()  # each renew restarts b's window
            clock.step(10)
            assert a.renew()
        assert a.holder() == "replica-a"

    def test_concurrent_steal_loses_cas(self):
        api, clock, a, b = self._pair()
        assert a.try_acquire()
        clock.step(16)
        # b reads the expired lease, then a renews-revives it first
        live = api._request("GET", "u")
        assert a.try_acquire()  # holder==a: renew path revives it
        # now b's PUT carries a stale resourceVersion
        live["spec"]["holderIdentity"] = "replica-b"
        import urllib.error
        try:
            api._request("PUT", "u", live)
            raised = False
        except urllib.error.HTTPError as e:
            raised = e.code == 409
        assert raised

    def test_release_lets_next_acquire_immediately(self):
        _, _, a, b = self._pair()
        assert a.try_acquire()
        a.release()
        assert b.try_acquire()
        assert b.holder() == "replica-b"

    def test_release_by_non_holder_is_noop(self):
        _, _, a, b = self._pair()
        assert a.try_acquire()
        b.release()
        assert a.holder() == "replica-a"

    def test_operator_picks_kube_lease_for_kube_backend(self):
        from karpenter_tpu_torch.kube.apiserver import KubeApiStore
        from karpenter_tpu_torch.operator.leaderelection import KubeLease
        from karpenter_tpu_torch.operator.operator import Operator
        from karpenter_tpu_torch.operator.options import Options
        store = KubeApiStore("https://fake:6443")
        op = Operator.__new__(Operator)
        op.options = Options(leader_elect=True, store_backend="kube")
        op.store = store
        from karpenter_tpu_torch.utils.clock import FakeClock
        op.clock = FakeClock()
        assert isinstance(op._lease(), KubeLease)
