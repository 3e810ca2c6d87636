"""ops/feasibility.py: every plain PyTorch function against its JAX twin on
the same encoded inputs (the random requirement pairs of
test_ops_feasibility.py, rebuilt here), at W = 1, 3 and 64 mask words.
Outputs are bool or integer: equality is exact."""

import random

import numpy as np
import pytest
import torch

from karpenter_tpu.ops import encode as jenc
from karpenter_tpu.ops import feasibility as jfeas
from karpenter_tpu.scheduling.requirement import Requirement
from karpenter_tpu.scheduling.requirements import (ALLOW_UNDEFINED_WELL_KNOWN,
                                                   Requirements)
from karpenter_tpu_torch.ops import feasibility as tfeas

from test_torch_support import device_series_kept  # noqa: F401 (autouse)

KEYS = ["topology.kubernetes.io/zone", "kubernetes.io/arch", "example.com/team",
        "example.com/tier", "example.com/gen"]
VALUES = {
    "topology.kubernetes.io/zone": ["z1", "z2", "z3", "z4"],
    "kubernetes.io/arch": ["amd64", "arm64"],
    "example.com/team": ["a", "b", "c"],
    "example.com/tier": ["1", "2", "7", "12"],
    "example.com/gen": ["1", "3", "5", "9", "x"],
}
INT_KEYS = ["example.com/tier", "example.com/gen"]
# domain bucket -> mask words per key: D = 6 -> W = 1, 96 -> 3, 2048 -> 64
BUCKETS = {1: None, 3: 96, 64: 2048}


def random_requirements(rng: random.Random) -> Requirements:
    """Undefined keys, In / NotIn / Exists / DoesNotExist, and Gt / Lt
    bounds on the integer-valued keys."""
    reqs = Requirements()
    for key in KEYS:
        roll = rng.random()
        if roll < 0.35:
            continue  # undefined
        vals = VALUES[key]
        if roll < 0.55:
            reqs.add(Requirement(key, "In", rng.sample(vals, rng.randint(1, len(vals)))))
        elif roll < 0.7:
            reqs.add(Requirement(key, "NotIn", rng.sample(vals, rng.randint(1, len(vals)))))
        elif roll < 0.78:
            reqs.add(Requirement(key, "Exists"))
        elif roll < 0.84:
            reqs.add(Requirement(key, "DoesNotExist"))
        elif key in INT_KEYS:
            op = "Gt" if rng.random() < 0.5 else "Lt"
            reqs.add(Requirement(key, op, [str(rng.randint(0, 13))]))
        else:
            reqs.add(Requirement(key, "In", rng.sample(vals, 1)))
    return reqs


def build_vocab(all_reqs, bucket):
    v = jenc.Vocab()
    for key in KEYS:
        v.add_key(key)
        for val in VALUES[key]:
            v.add_value(key, val)
    for r in all_reqs:
        v.observe_requirements(r)
    v.freeze(domain_bucket=bucket)
    return v


@pytest.fixture(scope="module", params=sorted(BUCKETS))
def encoded(request):
    """(W, vocab, a, b): 40 x 40 random requirement sets, encoded."""
    rng = random.Random(42)
    a_sets = [random_requirements(rng) for _ in range(40)]
    b_sets = [random_requirements(rng) for _ in range(40)]
    vocab = build_vocab(a_sets + b_sets, BUCKETS[request.param])
    assert vocab.W == request.param
    stack = lambda sets: jenc.stack_encoded(  # noqa: E731
        [jenc.encode_requirements(vocab, r) for r in sets])
    return request.param, vocab, stack(a_sets), stack(b_sets)


def both(e):
    """(JAX Enc, port Enc on the CPU) of one encoded batch."""
    return jfeas.to_device(e), tfeas.to_device(e, "cpu")


def same(want, got: torch.Tensor):
    want = np.asarray(want)
    got = got.numpy()
    assert want.shape == got.shape
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    assert want.dtype == got.dtype, (want.dtype, got.dtype)
    np.testing.assert_array_equal(want, got)


def test_bounds_and_gt_lt_present(encoded):
    _, _, a, b = encoded
    gts = np.concatenate([a.gt, b.gt])
    lts = np.concatenate([a.lt, b.lt])
    assert (gts > -2**31).any() and (lts < 2**31 - 1).any()
    assert np.concatenate([a.exempt, b.exempt]).any()
    assert (~np.concatenate([a.defined, b.defined])).any()


def test_to_device_and_host_enc(encoded):
    _, _, a, _ = encoded
    ja, ta = both(a)
    for want, got in zip(ja, ta):
        same(want, got)
    for want, got in zip(jfeas.host_enc(a), tfeas.host_enc(a)):
        assert want.dtype == got.dtype
        np.testing.assert_array_equal(want, got)


def test_pairwise_nonempty(encoded):
    _, _, a, b = encoded
    (ja, ta), (jb, tb) = both(a), both(b)
    same(jfeas._pairwise_nonempty(ja, jb), tfeas._pairwise_nonempty(ta, tb))


def test_intersects_matrix(encoded):
    _, _, a, b = encoded
    (ja, ta), (jb, tb) = both(a), both(b)
    got = tfeas.intersects_matrix(ta, tb)
    same(jfeas.intersects_matrix(ja, jb), got)
    assert got.any() and not got.all()


def test_compatible_matrix(encoded):
    _, vocab, a, b = encoded
    (ja, ta), (jb, tb) = both(a), both(b)
    for allow in (np.array([k in ALLOW_UNDEFINED_WELL_KNOWN
                            for k in vocab.keys]),
                  np.zeros(vocab.K, bool)):
        got = tfeas.compatible_matrix(ta, tb, torch.from_numpy(allow))
        same(jfeas.compatible_matrix(ja, jb, allow), got)
        assert got.any() and not got.all()


def test_combine(encoded):
    _, _, a, b = encoded
    (ja, ta), (jb, tb) = both(a), both(b)
    # aligned rows, and the [A, 1] x [1, B] broadcast the precompute uses
    for jx, jy, tx, ty in (
            (ja, jb, ta, tb),
            (jfeas.Enc(*(x[:, None] for x in ja)),
             jfeas.Enc(*(x[None, :] for x in jb)),
             tfeas.Enc(*(x[:, None] for x in ta)),
             tfeas.Enc(*(x[None, :] for x in tb)))):
        for want, got in zip(jfeas.combine(jx, jy), tfeas.combine(tx, ty)):
            same(want, got)


def test_fits_matrix():
    rng = np.random.default_rng(5)
    req = rng.integers(-2, 50, (17, 4)).astype(np.int32)
    req[3] = 0
    avail = rng.integers(-5, 60, (11, 4)).astype(np.int32)
    got = tfeas.fits_matrix(torch.from_numpy(req), torch.from_numpy(avail))
    same(jfeas.fits_matrix(req, avail), got)
    assert got.any() and not got.all()


def test_offering_compat(encoded):
    _, vocab, a, _ = encoded
    rng = np.random.default_rng(11)
    zk = vocab.key_idx["topology.kubernetes.io/zone"]
    ck = vocab.key_idx["kubernetes.io/arch"]
    T, O = 13, 6
    # -1: the offering does not constrain that key
    off_zone = rng.integers(-1, len(vocab.values[zk]), (T, O)).astype(np.int32)
    off_ct = rng.integers(-1, len(vocab.values[ck]), (T, O)).astype(np.int32)
    off_avail = rng.random((T, O)) < 0.7
    ja, ta = both(a)
    got = tfeas.offering_compat(ta.mask, zk, ck, torch.from_numpy(off_zone),
                                torch.from_numpy(off_ct),
                                torch.from_numpy(off_avail))
    same(jfeas.offering_compat(ja.mask, zk, ck, off_zone, off_ct, off_avail),
         got)
    assert got.any() and not got.all()


def test_pods_per_node():
    rng = np.random.default_rng(9)
    T, M, G, R = 23, 3, 19, 4
    alloc = rng.integers(0, 5000, (T, R)).astype(np.int32)
    overhead = rng.integers(0, 400, (M, R)).astype(np.int32)
    overhead[2, 1] = 10**6      # a daemon that fits no type
    req = rng.integers(0, 900, (G, R)).astype(np.int32)
    req[0] = 0                  # zero requests constrain nothing
    req[1, :2] = 0
    got = tfeas.pods_per_node(torch.from_numpy(alloc),
                              torch.from_numpy(overhead),
                              torch.from_numpy(req))
    same(jfeas.pods_per_node(alloc, overhead, req), got)
    assert (got[:, 2] == 0).all() and (got[0] == 2**30).any()


# -- value indices at and past 32 * W ----------------------------------------
#
# The reference reads a mask word at a value index in two ways. Its
# feasibility.offering_compat (and the precompute's zone admission) gather
# with jnp.take_along_axis / jnp.take, whose out-of-range fill for uint32 is
# all ones: such an index is admitted. The precompute's capacity-type test
# (binpack._offering_value_ok) indexes masks[:, word], which JAX clamps to
# the last word. The port's value_bit_ok / value_bit_ok_clamped give each.

def _offering_compat_both(mask, zone_key, captype_key, off_zone, off_ct,
                          off_avail):
    mask = np.asarray(mask, np.uint32)
    args = [np.asarray(a, np.int32) for a in (off_zone, off_ct)] + [
        np.asarray(off_avail, bool)]
    want = jfeas.offering_compat(mask, zone_key, captype_key, *args)
    got = tfeas.offering_compat(torch.from_numpy(mask.view(np.int32)),
                                zone_key, captype_key,
                                *map(torch.from_numpy, args))
    same(want, got)
    return got


def test_offering_compat_out_of_range_index_is_admitted():
    """A zone index of 32 * W against an all-zero mask: the reference
    admits it (its fill), where the port used to raise IndexError."""
    mask = np.zeros((1, 2, 1))
    got = _offering_compat_both(mask, 0, 1, [[32]], [[-1]], [[True]])
    assert got.tolist() == [[True]]
    # in range, the same mask admits nothing; past the word boundary of a
    # wider mask, the capacity-type key too
    got = _offering_compat_both(mask, 0, 1, [[31]], [[-1]], [[True]])
    assert got.tolist() == [[False]]
    mask = np.zeros((2, 2, 2))
    mask[1, 0, 1] = 1 << 3
    got = _offering_compat_both(mask, 0, 1, [[35, 35], [64, 35]],
                                [[-1, 70], [64, 0]],
                                [[True, True], [True, False]])
    assert got.tolist() == [[False, True], [True, True]]


@pytest.mark.parametrize("W", [1, 2, 3])
def test_offering_compat_random_indices_straddle_words(W):
    rng = np.random.default_rng(W)
    B, K, T, O = 9, 4, 23, 5
    mask = rng.integers(0, 2**32, (B, K, W), dtype=np.uint64)
    vals = lambda: rng.integers(-1, 32 * W + 9, (T, O))  # noqa: E731
    got = _offering_compat_both(mask, 1, 3, vals(), vals(),
                                rng.random((T, O)) < 0.6)
    assert got.any() and not got.all()


def test_capacity_type_test_clamps_as_the_precompute_does():
    """The precompute's capacity-type test reads an index past 32 * W from
    the last word (binpack._offering_value_ok), not as admitted."""
    import jax.numpy as jnp
    from karpenter_tpu.ops import binpack as jbinpack
    rng = np.random.default_rng(4)
    W = 2
    mask = rng.integers(0, 2**32, (7, 3, W), dtype=np.uint64).astype(
        np.uint32)
    idx = rng.integers(-1, 32 * W + 40, (11, 4)).astype(np.int32)
    want = jbinpack._offering_value_ok(jnp.asarray(mask), 1,
                                       jnp.asarray(idx))
    masks = torch.from_numpy(mask.view(np.int32))[:, 1, :]
    same(want, tfeas.value_bit_ok_clamped(masks, torch.from_numpy(idx)))
    filled = tfeas.value_bit_ok(masks, torch.from_numpy(idx))
    assert not torch.equal(filled, tfeas.value_bit_ok_clamped(
        masks, torch.from_numpy(idx)))


def test_precompute_with_out_of_range_values_matches_reference():
    """The whole precompute (K2's plain path) on a problem whose last zone
    and some capacity-type values lie past the mask words: zone admission
    fills, the capacity-type test clamps, as in the reference."""
    import dataclasses
    from karpenter_tpu.ops import binpack as jbinpack
    from karpenter_tpu_torch.ops import binpack as tbinpack
    from test_torch_support import JAX, build_problem, restricted_workload
    _, jp = build_problem(JAX, restricted_workload(JAX))
    W = jp.template_enc.mask.shape[-1]
    zone_values = jp.zone_values.copy()
    off_zone = jp.off_zone.copy()
    off_zone[off_zone == zone_values[-1]] = 32 * W + 3
    zone_values[-1] = 32 * W + 3
    off_captype = jp.off_captype.copy()
    off_captype[::3, ::2] = 32 * W + 33
    jp = dataclasses.replace(jp, zone_values=zone_values, off_zone=off_zone,
                             off_captype=off_captype, device_cache=None)
    want = jbinpack.precompute(jp)
    got = tbinpack.precompute(tbinpack.problem_from_numpy(jp), device="cpu")
    for name in ("it_ok_z", "zone_adm", "ppn"):
        np.testing.assert_array_equal(getattr(want, name), getattr(got, name),
                                      err_msg=name)
    assert want.zone_adm[..., -1].all()
