"""ops/binpack.py device half: the port's precompute and exist_delta (kernel
wrappers on the CPU, i.e. their plain PyTorch versions) against the JAX
package's on the same encoded problem, carried across with
problem_from_numpy. All outputs are bool or integer: equality is exact."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from karpenter_tpu.ops import binpack as jbinpack
from karpenter_tpu_torch.ops import binpack as tbinpack
from karpenter_tpu_torch.ops import kernels
from karpenter_tpu_torch.ops.binpack import INT32_MAX

from test_torch_support import (JAX, PORT, assert_tensors_equal,
                                bench_workload, build_problem, mini_workload,
                                restricted_workload)
from test_torch_support import device_series_kept  # noqa: F401 (autouse)

ZONES_12 = [f"zone-{i:02d}" for i in range(12)]
ZONES_40 = [f"zone-{i:02d}" for i in range(40)]

WORKLOADS = {
    # zone- and capacity-type-restricted pools and node selectors
    "restricted": restricted_workload,
    # two pools (one limited), existing nodes initialized and not
    "mini": lambda root: mini_workload(root),
    # the benchmark mix at 2,000 pods against 2,000 types: W = 64 mask words
    "bench_2k_types": lambda root: bench_workload(root, 2000, 2000),
    # the same mix with existing nodes on several zones and capacity types
    "bench_nodes": lambda root: bench_workload(root, 900, 300, n_nodes=40),
    # 12 and 40 zones: uint16 and uint32 zone words (Wz = 1 and 2)
    "zones_12": lambda root: bench_workload(root, 180, 60, zones=ZONES_12,
                                            n_deploys=18),
    "zones_40": lambda root: bench_workload(root, 180, 30, zones=ZONES_40,
                                            n_deploys=18),
}


@pytest.fixture(scope="module")
def problems():
    """name -> (JAX problem, port problem carried across, port problem
    encoded by the port's own build_problem)."""
    out = {}
    for name, make in WORKLOADS.items():
        _, jp = build_problem(JAX, make(JAX))
        _, own = build_problem(PORT, make(PORT))
        out[name] = (jp, tbinpack.problem_from_numpy(jp), own)
    return out


def _numpy_fields(p):
    for f in dataclasses.fields(p):
        val = getattr(p, f.name)
        if isinstance(val, np.ndarray):
            yield f.name, val
        elif dataclasses.is_dataclass(val):
            for sub in dataclasses.fields(val):
                yield f"{f.name}.{sub.name}", getattr(val, sub.name)


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_build_problem_matches_reference(problems, name):
    """The port's encode (its own copies of the host modules) produces the
    reference's PackProblem arrays for the same workload."""
    jp, _, own = problems[name]
    want = dict(_numpy_fields(jp))
    got = dict(_numpy_fields(own))
    assert want.keys() <= got.keys() | {"exist_shard_tokens"}
    for key, a in want.items():
        np.testing.assert_array_equal(a, got[key], err_msg=key)
    assert own.vocab.keys == jp.vocab.keys
    assert own.vocab.values == jp.vocab.values
    assert (own.zone_key, own.captype_key) == (jp.zone_key, jp.captype_key)


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_precompute_matches_reference(problems, name):
    jp, tp, _ = problems[name]
    want = jbinpack.precompute(jp)
    got = tbinpack.precompute(tp, device="cpu")
    assert_tensors_equal(want, got)
    assert want.it_ok.any(), "workload has no feasible pair"
    if name == "restricted":
        # zone admission and the per-zone offering bits both bind
        assert (~want.zone_adm).any()
        assert (want.it_ok[..., None] & ~want.it_ok_z).any()


def test_zone_word_layouts(problems):
    for name, Z, dtype, Wz in (("zones_12", 12, np.uint16, 1),
                               ("zones_40", 40, np.uint32, 2),
                               ("mini", 4, np.uint8, 1)):
        jp = problems[name][0]
        assert jp.zone_values.shape[0] == Z
        assert tbinpack.zone_pack_layout(Z) == (dtype, Wz)
        assert jbinpack.zone_pack_layout(Z) == (dtype, Wz)


def test_problem_from_numpy_copies(problems):
    jp, tp, _ = problems["mini"]
    assert type(tp.vocab).__module__.startswith("karpenter_tpu_torch.")
    assert type(tp.group_enc).__module__.startswith("karpenter_tpu_torch.")
    assert tp.device_cache is None
    assert tp.group_req is not jp.group_req
    np.testing.assert_array_equal(tp.group_req, jp.group_req)
    assert tp.vocab.W == jp.vocab.W and tp.vocab.D == jp.vocab.D


def _with_negative_avail(p):
    p = dataclasses.replace(p, exist_avail=p.exist_avail.copy())
    # avail below zero (daemon overhead above what is left), and a row whose
    # floor and truncation differ: -1 // 2 == -1 but trunc(-1 / 2) == 0
    p.exist_avail[0, :] = -1
    p.exist_avail[1, 0] = -7
    return p


@pytest.mark.parametrize("name", ["mini", "bench_nodes"])
def test_exist_delta_matches_reference(problems, name):
    jp, tp, _ = problems[name]
    for j, t in ((jp, tp), (_with_negative_avail(jp),
                            _with_negative_avail(tp))):
        want_ok, want_cap = jbinpack.exist_delta(j)
        got_ok, got_cap = tbinpack.exist_delta(t, device="cpu")
        np.testing.assert_array_equal(np.asarray(want_ok), got_ok)
        np.testing.assert_array_equal(np.asarray(want_cap), got_cap)
        # the fused precompute's exist outputs are the same numbers
        full = tbinpack.precompute(t, device="cpu")
        np.testing.assert_array_equal(full.exist_ok, got_ok)
        np.testing.assert_array_equal(full.exist_cap, got_cap)
        assert_tensors_equal(jbinpack.precompute(j), full)
    # padded rows (pow2 bucket) never pack
    n_real = 2 if name == "mini" else 40
    assert tp.exist_avail.shape[0] > n_real
    ok, _ = tbinpack.exist_delta(tp, device="cpu")
    assert not ok[:, n_real:].any()


def test_exist_feasibility_floor_rows():
    """Rows where floor and truncation disagree clip to the same 0 capacity
    as the reference, with the clip after the minimum."""
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    G, N, K, W, R = 5, 9, 3, 2, 3
    mask = rng.integers(0, 2**32, (G + N, K, W), dtype=np.uint64) \
        .astype(np.uint32)
    enc = dict(mask=mask, defined=rng.random((G + N, K)) < 0.6,
               complement=rng.random((G + N, K)) < 0.5,
               exempt=rng.random((G + N, K)) < 0.2,
               gt=np.full((G + N, K), -2**31, np.int64),
               lt=np.full((G + N, K), 2**31 - 1, np.int64))
    req = rng.integers(0, 4, (G, R)).astype(np.int32)
    avail = rng.integers(-9, 12, (N, R)).astype(np.int32)
    tol = rng.random((G, N)) < 0.8

    from karpenter_tpu.ops import feasibility as jfeas
    from karpenter_tpu.ops.encode import EncodedRequirements as JEnc
    from karpenter_tpu_torch.ops import feasibility as tfeas
    from karpenter_tpu_torch.ops.encode import EncodedRequirements as TEnc
    rows = lambda cls, sl: cls(**{k: v[sl] for k, v in enc.items()})  # noqa: E731
    want_ok, want_cap = jbinpack._exist_delta_jit(
        jfeas.to_device(rows(JEnc, slice(0, G))), req,
        jfeas.to_device(rows(JEnc, slice(G, None))), avail, tol,
        jnp.zeros(K, bool))
    got_ok, got_cap = kernels.exist_feasibility(
        tfeas.to_device(rows(TEnc, slice(0, G)), "cpu"),
        torch.from_numpy(req),
        tfeas.to_device(rows(TEnc, slice(G, None)), "cpu"),
        torch.from_numpy(avail), torch.from_numpy(tol))
    np.testing.assert_array_equal(np.asarray(want_ok), got_ok.numpy())
    np.testing.assert_array_equal(np.asarray(want_cap), got_cap.numpy())
    assert (np.asarray(want_cap) == 0).any() and (avail < 0).any()


def test_device_cache_keyed_by_device(problems):
    _, tp, _ = problems["mini"]
    p = dataclasses.replace(tp, device_cache={}, exist_token=("nodes", 1))
    first = tbinpack.precompute(p, device="cpu")
    assert ("it_side", "cpu") in p.device_cache
    assert ("exist_side", "cpu") in p.device_cache
    tok, _ = p.device_cache[("exist_side", "cpu")]
    assert tok == (("nodes", 1), ("dev", "cpu", 0))
    assert_tensors_equal(first, tbinpack.precompute(p, device="cpu"))


def test_entry_points_refuse_missing_cuda(problems, monkeypatch):
    """Without CUDA an entry point that was not asked for the CPU raises;
    it never carries on with the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tp, _ = problems["mini"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbinpack.precompute(tp)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbinpack.exist_delta(tp, device="cuda")
    from karpenter_tpu_torch.provisioning.tensor_scheduler import \
        TensorScheduler
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TensorScheduler([], {})


# -- the pack's existing-node fill -------------------------------------------

FILL_CASES = {
    "plain": {},
    "zone": {"zone": True},
    "exist_zone_none": {"zone": True, "no_exist_zone": True},
    "node_caps": {"node_caps": True},
    "per_node_cap": {"per_node_cap": True},
    "max_nodes_1": {"max_nodes": 1},
    "zero_request": {"zero_request": True},
    "negative_room": {"negative": True},
    "csi": {"csi": True},
    "order_subset_permuted": {"subset": True},
    "longer_than_a_block": {"long": True},
    "fills_in_turn": {"calls": 16, "zone": True, "node_caps": True,
                      "per_node_cap": True, "csi": True, "subset": True,
                      "negative": True},
}


def _fill_packers(base, tensors, case, rng, n_nodes=400):
    """Two port packers over the same seeded nodes, requests and budgets:
    the JAX package's fill runs on the first, the port's on the second."""
    G, R = base.group_req.shape
    Z = len(base.zone_values)
    req = rng.integers(0, 4, (G, R))
    req[np.arange(G), rng.integers(0, R, G)] += 1    # each asks for some
    if case.get("zero_request"):
        req[0] = 0
    lo, hi = (1, 6) if case.get("long") else (-4 if case.get("negative")
                                              else 0, 40)
    avail = rng.integers(lo, hi, (n_nodes, R))
    zones = None if case.get("no_exist_zone") else \
        rng.integers(-1, Z, n_nodes).astype(np.int32)
    p = dataclasses.replace(base, group_req=req, exist_avail=avail,
                            exist_zone=zones)
    t = dataclasses.replace(
        tensors, exist_ok=rng.random((G, n_nodes)) < 0.8,
        exist_cap=np.zeros((G, n_nodes), np.int32))
    order = rng.permutation(n_nodes)
    if case.get("subset"):
        order = order[:n_nodes * 2 // 3]
    vol_counts = vol_rem = None
    if case.get("csi"):
        vol_counts = [None if g % 3 == 0 else
                      {"ebs": 1 + g % 2} if g % 3 == 1 else
                      {"ebs": 1, "efs": 2} for g in range(G)]
        vol_rem = []
        for n in range(n_nodes - 25):   # the last nodes have no budget
            kind = n % 4
            vol_rem.append(None if kind == 0 else {} if kind == 1 else
                           {"gcs": 9} if kind == 2 else
                           {"ebs": int(rng.integers(0, 30)),
                            "efs": int(rng.integers(0, 30))})
    return [tbinpack.Packer(p, t, [None] * G, [None] * base.it_alloc.shape[0],
                            [], exist_order=order.tolist(),
                            vol_group_counts=vol_counts,
                            vol_node_remaining=copy.deepcopy(vol_rem))
            for _ in range(2)]


def _fill_args(case, rng, G, Z, n_nodes):
    zone = int(rng.integers(0, Z)) if case.get("zone") and \
        rng.random() < 0.7 else None
    per_node_cap = int(rng.integers(1, 5)) if case.get("per_node_cap") \
        and rng.random() < 0.7 else 0
    node_caps = None
    if case.get("node_caps") and rng.random() < 0.8:
        node_caps = rng.choice([0, 1, 2, 7, INT32_MAX], n_nodes)
    remaining = int(rng.integers(1, 3000 if case.get("long") else 400))
    return (int(rng.integers(0, G)), remaining, zone, per_node_cap,
            node_caps, case.get("max_nodes", 0))


@pytest.mark.parametrize("name", sorted(FILL_CASES))
def test_block_fill_equals_the_node_loop(problems, name):
    """Packer._fill_existing's block scan places exactly what the JAX
    package's per-node loop places on the same packer state: the same
    count, room left, placements in the same order and CSI budgets, on
    seeded packers and across fills in turn."""
    case = FILL_CASES[name]
    _, _, base = problems["mini"]
    tensors = tbinpack.precompute(base, device="cpu")
    G, Z, n_nodes = base.group_req.shape[0], len(base.zone_values), 400
    widest = total = 0
    for seed in range(6):
        rng = np.random.default_rng([seed, len(name)])
        want, got = _fill_packers(base, tensors, case, rng, n_nodes)
        for _ in range(case.get("calls", 3)):
            args = _fill_args(case, rng, G, Z, n_nodes)
            if case.get("zero_request") and rng.random() < 0.5:
                args = (0,) + args[1:]
            before = sum(map(len, want.result.existing.values()))
            placed = jbinpack.Packer._fill_existing(want, *args)
            assert got._fill_existing(*args) == placed
            np.testing.assert_array_equal(got.exist_avail, want.exist_avail)
            assert list(got.result.existing.items()) == \
                list(want.result.existing.items())
            assert got.vol_node_remaining == want.vol_node_remaining
            widest = max(widest,
                         sum(map(len, want.result.existing.values())) - before)
            total += placed
    assert total > 0
    if name == "longer_than_a_block":
        assert widest > 3 * tbinpack.EXIST_BLOCK   # past the second block
