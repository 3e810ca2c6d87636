"""The port's existing-node encode (the label table and its column-wise rows,
``ops/encode.NodeLabelTable``) against the JAX package's own
``TensorScheduler``, which builds a Requirements object per node: on the
same fleet, built from one spec for each package, ``build_problem``'s
``exist_enc`` (all six fields), ``exist_avail``, ``exist_zone`` and
``tol_exist`` are equal array for array, and so are the vocab (keys, values
in order, D, W) and the ``_fits_vocab`` verdict."""

from collections import OrderedDict

import numpy as np
import pytest

import test_torch_support as support
from test_torch_support import JAX, PORT, ROOTS, existing_nodes, nodepool, pod
from test_torch_support import device_series_kept  # noqa: F401 (autouse)
from test_torch_support import tracer_kept  # noqa: F401 (autouse)

ZONE = "topology.kubernetes.io/zone"
BETA_ZONE = "failure-domain.beta.kubernetes.io/zone"
ARCH = "kubernetes.io/arch"
BETA_ARCH = "beta.kubernetes.io/arch"
HOSTNAME = "kubernetes.io/hostname"
GPUS = "example.com/gpus"
TEAM = "example.com/team"
ENC_FIELDS = ("mask", "defined", "complement", "exempt", "gt", "lt")


# -- fleets from one spec -----------------------------------------------------

def _node(root, i, labels, cpu="8", memory="32Gi", taints=(), bound=()):
    """A StateNode of ``root`` named node-i with these labels (its hostname
    added) and taints, holding the bound pods ``bound``: (cpu, memory,
    is a daemonset pod)."""
    k = support.pkg(root)
    o = k.objects
    name = f"node-{i:05d}"
    alloc = k.res.parse_list({"cpu": cpu, "memory": memory, "pods": "110"})
    sn = k.statenode.StateNode(node=o.Node(
        metadata=o.ObjectMeta(name=name, namespace="",
                              labels={HOSTNAME: name, **labels}),
        spec=o.NodeSpec(provider_id=f"t://{name}",
                        taints=[o.Taint(key=t, effect="NoSchedule")
                                for t in taints]),
        status=o.NodeStatus(capacity=dict(alloc), allocatable=alloc)))
    for j, (c, m, daemon) in enumerate(bound):
        p = o.Pod(metadata=o.ObjectMeta(name=f"{name}-b{j}",
                                        namespace="default"),
                  spec=o.PodSpec(node_name=name),
                  container_requests=[k.res.parse_list(
                      {"cpu": c, "memory": m})],
                  is_daemonset_pod=daemon)
        sn.update_pod(p)
    return sn


def _zones(i):
    return {ZONE: f"test-zone-{'abcd'[i % 4]}"}


def _labels_fleet(make_labels, n=12):
    return lambda root: [_node(root, i, make_labels(i)) for i in range(n)]


def _tainted(root):
    return [_node(root, i, _zones(i),
                  taints=(("dedicated",) if i % 3 == 0 else
                          ("gpu",) if i % 3 == 1 else ()))
            for i in range(12)]


def _with_daemons(root):
    return [_node(root, i, {**_zones(i), TEAM: f"t{i % 2}"},
                  taints=("dedicated",) if i % 4 == 0 else (),
                  bound=(("100m", "128Mi", True),) if i % 3 == 0 else
                  (("500m", "1Gi", False),))
            for i in range(12)]


def _kwok(n):
    def make(root):
        catalog = support.pkg(root).kwok.construct_instance_types()[:24]
        return existing_nodes(root, catalog, n)
    return make


FLEETS = {
    # support.existing_nodes: types of the catalog, kwok zones, one bound pod
    "kwok": _kwok(40),
    # both the beta and the GA key of zone and arch, agreeing
    "beta_ga_equal": _labels_fleet(lambda i: {
        **_zones(i), BETA_ZONE: _zones(i)[ZONE],
        ARCH: "amd64", BETA_ARCH: "amd64"}),
    # ... and disagreeing on some nodes (an empty In set: DoesNotExist)
    "beta_ga_unequal": _labels_fleet(lambda i: {
        **_zones(i), BETA_ZONE: "test-zone-b" if i % 3 else _zones(i)[ZONE],
        BETA_ARCH: "arm64", ARCH: "amd64" if i % 2 else "arm64"}),
    # the beta zone key alone: a zone requirement, but no GA zone label
    "beta_only": _labels_fleet(lambda i: {BETA_ZONE: _zones(i)[ZONE]}
                               if i % 2 else _zones(i)),
    # values no instance type offers, first met out of sorted order
    "values_outside": _labels_fleet(lambda i: {
        ZONE: ("zone-y", "zone-x", _zones(i)[ZONE])[i % 3],
        ARCH: ("s390x", "amd64", "ppc64le")[i % 3]}),
    # keys no group, template or type defines (hostname, a team label)
    "keys_outside": _labels_fleet(lambda i: {**_zones(i), TEAM: f"t{i}"}),
    # a node with no zone label at all
    "no_zone": _labels_fleet(lambda i: {} if i == 5 else _zones(i)),
    # integer values, under a key a pod bounds with Gt
    "integer": _labels_fleet(lambda i: {**_zones(i),
                                        GPUS: str(7 * i % 5)}),
    "tainted": _tainted,
    # daemonset pods to place (a nodeSelector, a toleration) and bound ones
    "daemonsets": _with_daemons,
    # the pow2 node axis: below, at and past a bucket edge, and full size
    "n15": _labels_fleet(_zones, 15),
    "n16": _labels_fleet(_zones, 16),
    "n17": _labels_fleet(_zones, 17),
    "n5000": _labels_fleet(_zones, 5000),
    "empty": lambda root: [],
}


def _pods(root, case):
    o = support.pkg(root).objects
    pods = [pod(root, f"p-{i}", f"{100 * (1 + i % 3)}m",
                labels={"app": f"d{i % 3}"}) for i in range(9)]
    if case == "integer":
        gt = o.Affinity(node_affinity=o.NodeAffinity(required_terms=[
            o.NodeSelectorTerm(match_expressions=(
                o.NodeSelectorRequirement(GPUS, "Gt", ("1",)),))]))
        for i in range(3):
            p = pod(root, f"gpu-{i}", "200m", labels={"app": "gpu"})
            p.spec.affinity = gt
            pods.append(p)
    if case in ("tainted", "daemonsets"):
        tol = [o.Toleration(key="dedicated", operator="Exists")]
        pods += [pod(root, f"tol-{i}", "300m", labels={"app": "tol"},
                     tolerations=tol) for i in range(3)]
    return pods


def _daemons(root, case):
    if case != "daemonsets":
        return []
    o = support.pkg(root).objects
    return [
        pod(root, "ds-team", "200m", "256Mi", node_selector={TEAM: "t0"}),
        pod(root, "ds-tol", "150m", "128Mi",
            tolerations=[o.Toleration(key="dedicated", operator="Exists")]),
    ]


def _encode(root, case):
    """(scheduler, problem, templates, groups) of one case in ``root``."""
    k = support.pkg(root)
    its = k.kwok.construct_instance_types()[:24]
    ts = support.scheduler(root, [nodepool(root)], {"default": its},
                           state_nodes=FLEETS[case](root),
                           daemonset_pods=_daemons(root, case))
    groups, leftover, reason = k.grouping.partition_pods(_pods(root, case))
    assert groups and not leftover, reason
    problem, templates, _ = ts.build_problem(groups)
    return ts, problem, templates, groups


@pytest.fixture
def fresh_catalog_caches(monkeypatch):
    """Each package's catalog-encoding cache emptied for the test, so both
    build their vocab from this fleet and not from an earlier test's."""
    for root in ROOTS:
        monkeypatch.setattr(support.pkg(root).ts, "_CATALOG_CACHE",
                            OrderedDict())


def _assert_vocab_equal(want, got):
    assert got.keys == want.keys
    assert got.values == want.values
    assert got.resources == want.resources
    assert (got.D, got.W) == (want.D, want.W)


@pytest.mark.parametrize("case", sorted(FLEETS))
def test_node_encode_matches_reference(case, fresh_catalog_caches):
    jts, jp, jtemplates, jgroups = _encode(JAX, case)
    pts, pp, ptemplates, pgroups = _encode(PORT, case)
    n = len(pts.state_nodes)
    if n == 0:
        assert jp.exist_enc is None and pp.exist_enc is None
        assert pp.exist_avail is None and pp.tol_exist is None
    else:
        for f in ENC_FIELDS:
            a, b = getattr(jp.exist_enc, f), getattr(pp.exist_enc, f)
            assert a.dtype == b.dtype, f
            assert np.array_equal(a, b), f
        for f in ("exist_avail", "exist_zone", "tol_exist"):
            a, b = getattr(jp, f), getattr(pp, f)
            assert a.dtype == b.dtype, f
            assert np.array_equal(a, b), f
        assert pp.exist_avail.shape[0] == support.pkg(PORT).encode \
            .pow2_bucket(n, 16)
    _assert_vocab_equal(jp.vocab, pp.vocab)
    # the vocab check on the fleet that built the vocab
    assert jts._fits_vocab(jp.vocab, jtemplates, jgroups) is True
    assert pts._fits_vocab(pp.vocab, ptemplates, pgroups) is True
    if case == "beta_ga_unequal":
        # the DoesNotExist rows are there, and exempt
        assert pp.exist_enc.exempt[:n].any()
    if case == "integer":
        # values in their first appearance over the nodes, not sorted
        assert pp.vocab.values[pp.vocab.key_idx[GPUS]] == \
            ["0", "2", "4", "1", "3"]


@pytest.mark.parametrize("extra", ["zone_value", "arch_value", "resource",
                                   "beta_conflict"])
def test_fits_vocab_and_cached_vocab_match_reference(extra,
                                                     fresh_catalog_caches):
    """A vocab built from one fleet, asked about that fleet plus one node:
    a node value or resource the vocab lacks makes the verdict False in
    both packages (and the solve re-encodes), one it holds keeps it True.
    A disagreeing beta key adds no value, so it keeps the verdict True.
    The cached vocab's own encode of the grown fleet, the new node's value
    outside the vocab, is equal too."""
    extra_labels = {
        "zone_value": {ZONE: "zone-new"},
        "arch_value": {**_zones(0), ARCH: "riscv64"},
        "resource": _zones(0),
        "beta_conflict": {**_zones(0), BETA_ZONE: "zone-new"},
    }[extra]
    verdicts, cold = {}, {}
    for root in ROOTS:
        ts, p, templates, groups = _encode(root, "keys_outside")
        grown = FLEETS["keys_outside"](root) + [
            _node(root, 99, extra_labels)]
        if extra == "resource":
            grown[-1].node.status.allocatable = {
                **grown[-1].node.status.allocatable,
                "example.com/fpga": 1000}
        ts2 = support.scheduler(root, [nodepool(root)], {
            "default": support.pkg(root).kwok.construct_instance_types()[:24]},
            state_nodes=grown)
        verdicts[root] = ts2._fits_vocab(p.vocab, templates, groups)
        cold[root] = _cold_rows(root, ts2, p, groups)
    want = extra == "beta_conflict"
    assert verdicts[JAX] is want and verdicts[PORT] is want
    (jenc, javail, jzone, jtol), (penc, pavail, pzone, ptol) = \
        cold[JAX], cold[PORT]
    for f in ENC_FIELDS:
        assert np.array_equal(getattr(jenc, f), getattr(penc, f)), f
    assert np.array_equal(javail, pavail)
    assert np.array_equal(jzone, pzone)
    assert np.array_equal(jtol, ptol)


class _Span:
    def set(self, **attrs):
        self.attrs = attrs


def _cold_rows(root, ts, problem, groups):
    if root == JAX:
        return ts._cold_node_rows(problem.vocab, problem.zone_key, groups,
                                  len(groups))
    return ts._cold_node_rows(problem.vocab, problem.zone_key, groups,
                              _Span())
