"""tests/test_binpack_parity.py pointed at the port: every case runs once
with the JAX package's objects and TensorScheduler and once with the
port's (``device="cpu"``: the kernels' plain PyTorch versions). Inside
each run the reference's own assertions hold (tensor packer against the
package's host oracle); across the two runs every tensor solve gives the
same decision digest and the same fallback reason. Both packages' pod
name sequences restart at 1 for each run, so the pods of the two runs
carry the same names."""

import itertools
from types import SimpleNamespace

import pytest

from test_torch_support import JAX, PORT, ROOTS, factories, pkg
from test_torch_support import device_series_kept  # noqa: F401 (autouse)

FACTORY_NAMES = ("affinity_term", "make_nodepool", "make_pod", "make_pods",
                 "make_scheduler", "spread_hostname", "spread_zone")


def package(root: str) -> SimpleNamespace:
    """``root``'s objects, factories and solves; every tensor solve is
    recorded in ``solves`` as (decision digest, fallback reason)."""
    import importlib
    F = factories(root)
    k = pkg(root)
    digest = importlib.import_module(f"{root}.flightrec.record")\
        .decision_digest
    Scheduler = importlib.import_module(
        f"{root}.provisioning.tensor_scheduler").TensorScheduler
    device = {"device": "cpu"} if root == PORT else {}
    ns = SimpleNamespace(root=root, kwok=k.kwok, L=k.labels, o=k.objects,
                         solves=[],
                         **{n: getattr(F, n) for n in FACTORY_NAMES})

    def scheduler(nodepools, its, **kw):
        return Scheduler(nodepools, its, **device, **kw)

    def solved(ts, pods):
        results = ts.solve(pods)
        ns.solves.append((digest(results, pods, ts.fallback_reason,
                                 ts.partition), ts.fallback_reason))
        return results

    def tensor_solve(nodepools, its, pods, **kw):
        if not isinstance(its, dict):
            its = {np_.name: list(its) for np_ in nodepools}
        ts = scheduler(nodepools, its, force_tensor=True, **kw)
        results = solved(ts, pods)
        assert ts.fallback_reason == "", \
            f"unexpected fallback: {ts.fallback_reason}"
        return results

    def host_solve(nodepools, its, pods, **kw):
        return F.make_scheduler(nodepools, its, pods, **kw).solve(pods)

    def both(pods_fn, nodepools=None, its=None):
        nodepools = nodepools or [F.make_nodepool()]
        its = its if its is not None else k.kwok.construct_instance_types()
        t = tensor_solve(nodepools, its, pods_fn())
        h = host_solve(nodepools, its, pods_fn())
        return t, h

    ns.scheduler, ns.solved = scheduler, solved
    ns.tensor_solve, ns.host_solve, ns.both = tensor_solve, host_solve, both
    return ns


def run_case(body) -> None:
    """``body(k)`` with each package's ``k``, the pod name sequences
    restarted for each; the two runs' tensor solves must agree."""
    runs = {}
    for root in ROOTS:
        F = factories(root)
        saved = F._seq
        F._seq = itertools.count(1)
        try:
            k = package(root)
            body(k)
        finally:
            F._seq = saved
        runs[root] = k.solves
    assert runs[JAX], "the case made no tensor solve"
    assert len(runs[JAX]) == len(runs[PORT])
    for i, (want, got) in enumerate(zip(runs[JAX], runs[PORT])):
        assert got[1] == want[1], f"solve {i}: fallback reason"
        assert got[0] == want[0], f"solve {i}: decision digest"


class TestPlainParity:
    def test_single_group(self):
        def body(k):
            t, h = k.both(lambda: k.make_pods(50, cpu="500m",
                                              memory="512Mi"))
            assert len(t.pod_errors) == len(h.pod_errors) == 0
            assert len(t.new_nodeclaims) == len(h.new_nodeclaims)
        run_case(body)

    def test_mixed_sizes(self):
        def body(k):
            def pods():
                return (k.make_pods(20, cpu="2", memory="4Gi")
                        + k.make_pods(30, cpu="500m", memory="1Gi")
                        + k.make_pods(10, cpu="100m", memory="128Mi"))
            t, h = k.both(pods)
            assert len(t.pod_errors) == len(h.pod_errors) == 0
            th, hh = len(t.new_nodeclaims), len(h.new_nodeclaims)
            assert abs(th - hh) <= max(1, round(0.02 * hh)), (th, hh)
        run_case(body)

    def test_unschedulable(self):
        def body(k):
            t, h = k.both(lambda: k.make_pods(3, cpu="1000"))
            assert len(t.pod_errors) == len(h.pod_errors) == 3
        run_case(body)

    def test_tainted_pool_toleration(self):
        def body(k):
            np_ = k.make_nodepool(taints=[k.o.Taint(key="dedicated",
                                                    value="x")])
            tol = [k.o.Toleration(key="dedicated", operator="Exists")]
            t, h = k.both(lambda: k.make_pods(10, tolerations=tol),
                          nodepools=[np_])
            assert len(t.pod_errors) == len(h.pod_errors) == 0
            assert len(t.new_nodeclaims) == len(h.new_nodeclaims)
        run_case(body)

    def test_zone_selector(self):
        def body(k):
            zone = k.L.LABEL_TOPOLOGY_ZONE

            def pods():
                return k.make_pods(12, cpu="1",
                                   node_selector={zone: "test-zone-c"})
            t, h = k.both(pods)
            assert len(t.pod_errors) == len(h.pod_errors) == 0
            assert len(t.new_nodeclaims) == len(h.new_nodeclaims)
            for nc in t.new_nodeclaims:
                assert nc.requirements.get(zone).values == {"test-zone-c"}
        run_case(body)


def _zones(k, results):
    return sorted(nc.requirements.get(k.L.LABEL_TOPOLOGY_ZONE)
                  .values_list()[0] for nc in results.new_nodeclaims)


class TestTopologyParity:
    def test_zonal_spread(self):
        def body(k):
            t, h = k.both(lambda: k.make_pods(16, labels={"app": "demo"},
                                              spread=[k.spread_zone()]))
            assert len(t.pod_errors) == len(h.pod_errors) == 0
            assert len(t.new_nodeclaims) == len(h.new_nodeclaims)
            assert _zones(k, t) == _zones(k, h)
        run_case(body)

    def test_hostname_spread(self):
        def body(k):
            t, h = k.both(lambda: k.make_pods(
                6, labels={"app": "demo"},
                spread=[k.spread_hostname(max_skew=1)]))
            assert len(t.pod_errors) == len(h.pod_errors) == 0
            assert len(t.new_nodeclaims) == len(h.new_nodeclaims) == 6
        run_case(body)

    def test_hostname_anti_affinity(self):
        def body(k):
            t, h = k.both(lambda: k.make_pods(
                7, labels={"app": "demo"},
                pod_anti_affinity=[k.affinity_term(k.L.LABEL_HOSTNAME)]))
            assert len(t.pod_errors) == len(h.pod_errors) == 0
            assert len(t.new_nodeclaims) == len(h.new_nodeclaims) == 7
        run_case(body)

    def test_zonal_affinity(self):
        def body(k):
            t, h = k.both(lambda: k.make_pods(
                9, labels={"app": "demo"},
                pod_affinity=[k.affinity_term(k.L.LABEL_TOPOLOGY_ZONE)]))
            assert len(t.pod_errors) == len(h.pod_errors) == 0
            assert len(t.new_nodeclaims) == len(h.new_nodeclaims)
            assert len(set(_zones(k, t))) == 1
        run_case(body)

    def test_zonal_anti_affinity_late_committal(self):
        def body(k):
            t, h = k.both(lambda: k.make_pods(
                3, labels={"app": "demo"},
                pod_anti_affinity=[k.affinity_term(
                    k.L.LABEL_TOPOLOGY_ZONE)]))
            assert len(t.pod_errors) == len(h.pod_errors) == 2
            assert len(t.new_nodeclaims) == len(h.new_nodeclaims) == 1
        run_case(body)

    def test_hostname_affinity_single_node(self):
        def body(k):
            t, h = k.both(lambda: k.make_pods(
                5, cpu="100m", labels={"app": "demo"},
                pod_affinity=[k.affinity_term(k.L.LABEL_HOSTNAME)]))
            assert len(t.pod_errors) == len(h.pod_errors) == 0
            assert len(t.new_nodeclaims) == len(h.new_nodeclaims) == 1
        run_case(body)


class TestBenchmarkMixParity:
    """The reference benchmark's diverse mix: 1/6 each generic, zone-spread,
    host-spread, host-affinity, zone-affinity, host-anti-affinity."""

    @staticmethod
    def _mix(k, n_per_kind):
        host, zone = k.L.LABEL_HOSTNAME, k.L.LABEL_TOPOLOGY_ZONE
        pods = []
        pods += k.make_pods(n_per_kind, cpu="1", memory="2Gi")
        pods += k.make_pods(n_per_kind, cpu="500m", memory="1Gi",
                            labels={"app": "spread-z"},
                            spread=[k.spread_zone(value="spread-z")])
        pods += k.make_pods(n_per_kind, cpu="500m", memory="1Gi",
                            labels={"app": "spread-h"},
                            spread=[k.spread_hostname(value="spread-h")])
        pods += k.make_pods(n_per_kind, cpu="250m", memory="512Mi",
                            labels={"app": "aff-h"},
                            pod_affinity=[k.affinity_term(host,
                                                          value="aff-h")])
        pods += k.make_pods(n_per_kind, cpu="250m", memory="512Mi",
                            labels={"app": "aff-z"},
                            pod_affinity=[k.affinity_term(zone,
                                                          value="aff-z")])
        pods += k.make_pods(n_per_kind, cpu="250m", memory="512Mi",
                            labels={"app": "anti-h"},
                            pod_anti_affinity=[k.affinity_term(
                                host, value="anti-h")])
        return pods

    @pytest.mark.parametrize("n", [6, 18])
    def test_mix_parity(self, n):
        def body(k):
            its = k.kwok.construct_instance_types()
            np_ = [k.make_nodepool()]
            t = k.tensor_solve(np_, its, self._mix(k, n))
            h = k.host_solve(np_, its, self._mix(k, n))
            assert len(t.pod_errors) == len(h.pod_errors), \
                (t.pod_errors, h.pod_errors)
            th, hh = len(t.new_nodeclaims), len(h.new_nodeclaims)
            # BASELINE.md north star: within 2% of the oracle
            assert abs(th - hh) <= max(1, round(0.02 * hh)), (th, hh)
        run_case(body)


class TestInstanceTypePruning:
    def test_cohort_drops_outgrown_instance_types(self):
        """nodeclaim.go:108-117 parity: an instance type that fit the first
        pod must leave the claim's option list once the accumulated load
        outgrows it."""
        def body(k):
            its = k.kwok.construct_instance_types()
            t = k.tensor_solve([k.make_nodepool()], its,
                               k.make_pods(2, cpu="1500m", memory="256Mi"))
            assert not t.pod_errors
            for nc in t.new_nodeclaims:
                total = sum(p.requests().get("cpu", 0) for p in nc.pods)
                for it in nc.instance_type_options:
                    assert it.allocatable().get("cpu", 0) >= total, \
                        (it.name, total)
        run_case(body)

    def test_oversized_daemon_overhead_excludes_type(self):
        """A daemonset whose overhead outgrows every instance type in a
        resource the pods never request makes those types infeasible on
        both paths."""
        def body(k):
            its = k.kwok.construct_instance_types()[:24]
            daemon = k.make_pod(cpu="100m", memory="64Mi")
            daemon.container_requests[0]["ephemeral-storage"] = \
                100 * 1024**3 * 1000  # exceeds every type
            pods = k.make_pods(4, cpu="250m")
            t = k.tensor_solve([k.make_nodepool()], its, pods,
                               daemonset_pods=[daemon])
            h = k.host_solve([k.make_nodepool()], its, pods,
                             daemonset_pods=[daemon])
            assert len(t.pod_errors) == len(h.pod_errors) == 4
            assert not t.new_nodeclaims and not h.new_nodeclaims
        run_case(body)

    def test_limit_filtered_fill_keeps_viable_options(self):
        """With nodepool limits excluding the max-capacity type, the fill
        is sized from the limit-filtered set."""
        def body(k):
            its = k.kwok.construct_instance_types()
            pool = k.make_nodepool(limits={"cpu": "4"})
            t = k.tensor_solve([pool], its, k.make_pods(16, cpu="250m"))
            for nc in t.new_nodeclaims:
                assert nc.pods and nc.instance_type_options
                total = sum(p.requests().get("cpu", 0) for p in nc.pods)
                assert any(it.allocatable().get("cpu", 0) >= total
                           for it in nc.instance_type_options)
            h = k.host_solve([k.make_nodepool(limits={"cpu": "4"})], its,
                             k.make_pods(16, cpu="250m"))
            assert len(t.pod_errors) == len(h.pod_errors)
        run_case(body)


class TestDeterminism:
    def test_identical_batches_solve_identically(self):
        """Two solves of the same batch (fresh scheduler each) make
        identical decisions (validation.go:83-215)."""
        def body(k):
            its = k.kwok.construct_instance_types()
            zone = k.L.LABEL_TOPOLOGY_ZONE

            def batch():
                return (k.make_pods(40, cpu="500m", memory="512Mi")
                        + k.make_pods(12, labels={"app": "s"},
                                      spread=[k.spread_zone(key="app",
                                                            value="s")])
                        + k.make_pods(8, labels={"app": "a"},
                                      pod_anti_affinity=[k.affinity_term(
                                          k.L.LABEL_HOSTNAME, value="a")]))

            def key(results):
                return sorted(
                    (nc.template.nodepool_name,
                     tuple(sorted(nc.requirements.get(zone).values)),
                     tuple(it.name for it in nc.instance_type_options),
                     len(nc.pods))
                    for nc in results.new_nodeclaims)

            r1 = k.tensor_solve([k.make_nodepool()], its, batch())
            r2 = k.tensor_solve([k.make_nodepool()], its, batch())
            assert key(r1) == key(r2)
            assert len(r1.pod_errors) == len(r2.pod_errors)
        run_case(body)


class TestFallback:
    def test_unsupported_topology_falls_back(self):
        # region-key spread isn't kernel-supported -> host path
        def body(k):
            pods = [k.make_pod(labels={"app": "x"}, spread=[
                k.o.TopologySpreadConstraint(
                    topology_key=k.L.LABEL_TOPOLOGY_REGION,
                    label_selector=k.o.LabelSelector(
                        match_labels={"app": "x"}))])]
            its = {"default": k.kwok.construct_instance_types()}
            ts = k.scheduler([k.make_nodepool()], its)
            results = k.solved(ts, pods)
            assert ts.fallback_reason != ""
            assert results.pod_errors == {}
        run_case(body)

    def test_cross_group_selector_falls_back(self):
        def body(k):
            pods = (k.make_pods(2, labels={"app": "x"},
                                spread=[k.spread_zone(key="app", value="x")])
                    + k.make_pods(2, cpu="200m",
                                  labels={"app": "x", "extra": "y"}))
            its = {"default": k.kwok.construct_instance_types()}
            ts = k.scheduler([k.make_nodepool()], its)
            k.solved(ts, pods)
            assert ts.fallback_reason != ""
        run_case(body)
