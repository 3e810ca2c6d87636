"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, at small shapes: every output equal, bit for bit. Needs a CUDA device
and nvcc; skips without a device. On a machine with a card and without jax
it runs without the repository's conftest:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from karpenter_tpu_torch.flightrec.record import decision_digest  # noqa: E402
from karpenter_tpu_torch.ops import binpack, kernels  # noqa: E402
from karpenter_tpu_torch.ops import feasibility as feas  # noqa: E402
from karpenter_tpu_torch.ops.encode import EncodedRequirements  # noqa: E402

from test_torch_support import (PORT, assert_tensors_equal,  # noqa: E402
                                bench_workload, build_problem, mini_workload,
                                restricted_workload, scheduler)

# the condition is a string so that it is evaluated when each test is set
# up, never while the module is imported
pytestmark = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device and nvcc")

INT_MIN, INT_MAX = -2**31, 2**31 - 1


def rand_enc(rng, rows, K, W, device="cuda") -> feas.Enc:
    """Sparse masks (about two nonzero words of four bits per key), so
    intersections come out both empty and nonempty; some Gt/Lt bounds."""
    mask = (rng.integers(0, 16, (rows, K, W))
            * (rng.random((rows, K, W)) < 2.0 / W)).astype(np.uint32)
    mask[..., 0] |= (rng.random((rows, K)) < 0.3).astype(np.uint32) << 31
    gt = np.where(rng.random((rows, K)) < 0.2, rng.integers(-3, 9, (rows, K)),
                  INT_MIN)
    lt = np.where(rng.random((rows, K)) < 0.2, rng.integers(-3, 9, (rows, K)),
                  INT_MAX)
    e = EncodedRequirements(mask=mask, defined=rng.random((rows, K)) < 0.6,
                            complement=rng.random((rows, K)) < 0.5,
                            exempt=rng.random((rows, K)) < 0.2, gt=gt, lt=lt)
    return feas.to_device(e, device)


def i32(a, device="cuda"):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)


def flags(rng, shape, p, device="cuda"):
    return torch.from_numpy(rng.random(shape) < p).to(device)


def assert_same(kernel_out, plain_out):
    def flat(out):
        for x in out:
            yield from (x if isinstance(x, tuple) else (x,))
    for a, b in zip(flat(kernel_out), flat(plain_out), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("W", [1, 3, 64])
def test_combine_compat_matches_plain(W):
    rng = np.random.default_rng(W)
    K = 9
    template, group = rand_enc(rng, 3, K, W), rand_enc(rng, 37, K, W)
    allow = flags(rng, (K,), 0.4)
    before = kernels.LAUNCHES["combine_compat"]
    out = kernels.combine_compat(template, group, allow)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["combine_compat"] == before + 1
    assert_same(out, kernels.combine_compat_plain(template, group, allow))
    assert out[1].any() and not out[1].all()


def combine_case(rng, M, G, K, W):
    """K1's inputs: random rows, the first group defining no key (so every
    template is compatible with it), a seeded allow-undefined set."""
    template, group = rand_enc(rng, M, K, W), rand_enc(rng, G, K, W)
    group.defined[:1] = False
    return template, group, flags(rng, (K,), 0.4)


def assert_combine_matches_plain(template, group, allow):
    """One launch (none at M * G == 0), every output equal to the plain
    version's."""
    before = kernels.LAUNCHES["combine_compat"]
    out = kernels.combine_compat(template, group, allow)
    torch.cuda.synchronize()
    pairs = template.mask.shape[0] * group.mask.shape[0]
    assert kernels.LAUNCHES["combine_compat"] == before + (pairs > 0)
    assert_same(out, kernels.combine_compat_plain(template, group, allow))
    return out


@pytest.mark.parametrize("K", [1, 9, 33])
@pytest.mark.parametrize("W", [1, 3, 4, 8, 64, 65])
def test_combine_compat_matches_plain_at_the_key_and_word_edges(K, W):
    """Keys around a warp and words per key around a 16-byte vector and
    past 32 lanes (a lane loops over several words of its key)."""
    rng = np.random.default_rng(K * 100 + W)
    out = assert_combine_matches_plain(*combine_case(rng, 3, 43, K, W))
    assert out[1].any() and not out[1].all()


@pytest.mark.parametrize("M,G", [(1, 0), (1, 1), (1, 8), (1, 32), (3, 43),
                                 (2, 1000)])
@pytest.mark.parametrize("W", [8, 64])
def test_combine_compat_matches_plain_at_the_pair_edges(M, G, W):
    """No pair (no launch), one, the disruption encodes' 8, a mesh slot's
    32, 129, and 2,000: more blocks than one wave on the card."""
    rng = np.random.default_rng(M * G + W)
    assert_combine_matches_plain(*combine_case(rng, M, G, 9, W))


def test_combine_compat_matches_plain_on_unaligned_rows():
    """Masks that start 4 bytes past a 16-byte boundary take word loads
    instead of 16-byte ones."""
    rng = np.random.default_rng(12)
    template, group, allow = combine_case(rng, 2, 37, 9, 64)
    flat = torch.empty(group.mask.numel() + 1, dtype=torch.int32,
                       device="cuda")
    shifted = flat[1:].view(group.mask.shape)
    shifted.copy_(group.mask)
    group = group._replace(mask=shifted)
    assert group.mask.data_ptr() % 16 == 4
    assert_combine_matches_plain(template, group, allow)


@pytest.mark.parametrize("Z", [4, 12, 40])
def test_catalog_feasibility_matches_plain(Z):
    rng = np.random.default_rng(Z)
    K, W, M, G, T, R = 6, 3, 2, 11, 77, 4
    O = 2 * Z + 1
    template, group = rand_enc(rng, M, K, W), rand_enc(rng, G, K, W)
    # dense zone / capacity-type masks so offerings pass often
    for e in (template, group):
        e.mask[:, :2, :] |= i32(rng.integers(0, 2**31, (e.mask.shape[0], 2,
                                                         W)))
    cmb, compat_tm = kernels.combine_compat_plain(
        template, group, flags(rng, (K,), 0.5))
    it = rand_enc(rng, T, K, W)
    daemon = rng.integers(0, 300, (M, R))
    daemon[1, 2] = 10**6                      # a daemon no type holds
    req = rng.integers(0, 500, (G, R))
    req[0] = 0                                # zero requests
    args = (cmb, torch.ones_like(compat_tm), it, i32(req), i32(daemon),
            i32(rng.integers(0, 4000, (T, R))), flags(rng, (M, T), 0.9),
            i32(rng.integers(-1, Z, (T, O))), i32(rng.integers(-1, 2, (T, O))),
            flags(rng, (T, O), 0.8), i32(np.arange(Z)),
            flags(rng, (G, M), 0.9))
    kw = dict(zone_key=0, captype_key=1)
    out = kernels.catalog_feasibility(*args, **kw)
    torch.cuda.synchronize()
    assert_same(out, kernels.catalog_feasibility_plain(*args, **kw))
    assert (out[0] != 0).any() and (out[0] == 0).any()


def test_catalog_feasibility_out_of_range_values_match_plain():
    """Zone and capacity-type value indices at and past 32 * W: the kernel
    reads no word past the row, admits the zone (jnp.take's fill) and reads
    the capacity type's last word (the plain gather's clamp), as the plain
    version does."""
    rng = np.random.default_rng(3)
    K, W, M, G, T, R, Z, O = 4, 2, 1, 5, 40, 2, 3, 6
    template, group = rand_enc(rng, M, K, W), rand_enc(rng, G, K, W)
    cmb, compat_tm = kernels.combine_compat_plain(
        template, group, flags(rng, (K,), 0.5))
    cmb.mask[:, :2, :] = i32(rng.integers(0, 2**31, (M * G, 2, W)))
    cmb.defined[:] = False
    zone_values = i32([1, 32 * W, 32 * W + 7])
    off_zone = zone_values.cpu()[rng.integers(0, Z, (T, O))].cuda()
    off_captype = i32(rng.choice([-1, 0, 33, 32 * W, 32 * W + 31], (T, O)))
    args = (cmb, torch.ones_like(compat_tm), rand_enc(rng, T, K, W),
            i32(rng.integers(1, 5, (G, R))), i32(np.zeros((M, R))),
            i32(rng.integers(10, 40, (T, R))), flags(rng, (M, T), 1.0),
            off_zone, off_captype, flags(rng, (T, O), 0.8), zone_values,
            flags(rng, (G, M), 1.0))
    kw = dict(zone_key=0, captype_key=1)
    out = kernels.catalog_feasibility(*args, **kw)
    torch.cuda.synchronize()
    assert_same(out, kernels.catalog_feasibility_plain(*args, **kw))
    assert out[2][:, :, 1:].all()


@pytest.mark.parametrize("A,B,R", [(1, 1, 1), (33, 17, 4), (8192, 120, 4),
                                   (100, 300, 7)])
def test_fits_matrix_matches_plain(A, B, R):
    rng = np.random.default_rng(A + B)
    req = rng.integers(-3, 60, (B, R))
    req[: max(1, B // 4)] = 0                 # zero requests always fit
    args = (i32(req), i32(rng.integers(-5, 80, (A, R))))
    before = kernels.LAUNCHES["fits_matrix"]
    out = kernels.fits_matrix(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fits_matrix"] == before + 1
    assert_same((out,), (feas.fits_matrix(*args),))
    assert out.any()


def fits_edge_inputs(A, B, R, seed):
    """Requests and avail rows with zero, negative, INT_MIN and INT_MAX
    entries; an avail row of INT_MAX every 13th word."""
    rng = np.random.default_rng(seed)
    req = rng.integers(-5, 60, (B, R)).astype(np.int64)
    flat = req.reshape(-1)
    flat[::5], flat[1::7], flat[2::11] = 0, INT_MIN, INT_MAX
    avail = rng.integers(-5, 80, (A, R)).astype(np.int64)
    avail.reshape(-1)[::13] = INT_MAX
    avail.reshape(-1)[3::17] = INT_MIN
    return i32(req), i32(avail)


@pytest.mark.parametrize("A,B,R", [(A, B, R) for A in (1, 8192)
                                   for B in (1, 7, 120, 121, 4096)
                                   for R in (1, 4, 9)])
def test_fits_matrix_edges_match_plain(A, B, R):
    """Every store width (16 at B = 4,096, 8 at 120, bytes at 1, 7, 121),
    request tiles at B = 4,096 x R = 9, the int4 path at R = 4."""
    req, avail = fits_edge_inputs(A, B, R, A + B + R)
    out = kernels.fits_matrix(req, avail)
    torch.cuda.synchronize()
    assert_same((out,), (feas.fits_matrix(req, avail),))


@pytest.mark.parametrize("B", [120, 121])
def test_fits_matrix_unaligned_avail_matches_plain(B):
    """An avail view one word in from its storage, not 16-byte aligned: the
    launch takes the runtime-R path at R = 4."""
    req, avail = fits_edge_inputs(8192, B, 4, B)
    buf = torch.cat([avail.new_zeros(1), avail.reshape(-1)])
    view = buf[1:].view(8192, 4)
    assert view.data_ptr() % 16 != 0
    assert not kernels.fits_plan(8192, B, 4,
                                 aligned=view.data_ptr() % 16 == 0).vec4
    out = kernels.fits_matrix(req, view)
    torch.cuda.synchronize()
    assert_same((out,), (feas.fits_matrix(req, view),))


@pytest.mark.parametrize("W", [1, 2, 64])
def test_offering_compat_matches_plain(W):
    """Value indices from -1 to past 32 * W, across word boundaries."""
    rng = np.random.default_rng(W)
    B, K, T, O = 37, 5, 301, 8
    mask = i32(rng.integers(-2**31, 2**31, (B, K, W)))
    vals = lambda: i32(rng.integers(-1, 32 * W + 40, (T, O)))  # noqa: E731
    args = (mask, 2, 4, vals(), vals(), flags(rng, (T, O), 0.6))
    before = kernels.LAUNCHES["offering_compat"]
    out = kernels.offering_compat(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["offering_compat"] == before + 1
    assert_same((out,), (feas.offering_compat(*args),))
    assert out.any() and not out.all()


@pytest.mark.parametrize("B,T,O", [(1, 1, 1), (5, 129, 3), (33, 300, 8),
                                   (4, 128, 1), (120, 2000, 8), (7, 77, 11),
                                   (3, 127, 12)])
@pytest.mark.parametrize("W", [2, 64])
def test_offering_compat_matches_plain_at_the_tile_edges(B, T, O, W):
    """Rows and types around the 4-row x 128-type tile, O around the
    8-offering chunk (16-byte reads of a type's offerings when O % 4 == 0),
    value indices from -1 to past 32 * W."""
    rng = np.random.default_rng(B * T + O * W)
    K = 4
    mask = i32(rng.integers(-2**31, 2**31, (B, K, W)))
    vals = lambda: i32(rng.integers(-1, 32 * W + 40, (T, O)))  # noqa: E731
    args = (mask, 1, 3, vals(), vals(), flags(rng, (T, O), 0.5))
    out = kernels.offering_compat(*args)
    torch.cuda.synchronize()
    assert_same((out,), (feas.offering_compat(*args),))


def test_offering_compat_matches_plain_on_unaligned_inputs():
    """Offerings and masks that start 4 bytes past a 16-byte boundary take
    word copies instead of 16-byte ones."""
    rng = np.random.default_rng(13)
    B, K, W, T, O = 21, 3, 8, 200, 4

    def shifted(a):
        flat = torch.empty(a.numel() + 1, dtype=a.dtype, device="cuda")
        out = flat[1:].view(a.shape)
        out.copy_(a)
        assert out.data_ptr() % 16 == 4
        return out
    def vals():
        return shifted(i32(rng.integers(-1, 32 * W + 9, (T, O))))
    mask = shifted(i32(rng.integers(-2**31, 2**31, (B, K, W))))
    args = (mask, 0, 2, vals(), vals(), flags(rng, (T, O), 0.6))
    out = kernels.offering_compat(*args)
    torch.cuda.synchronize()
    assert_same((out,), (feas.offering_compat(*args),))
    assert out.any() and not out.all()


def catalog_case(rng, M, G, T, W, Z, K=9, R=4):
    """K2's inputs: rows with dense zone / capacity-type masks (keys 0 and 1)
    so offerings pass often, a daemon no type holds (of the last of several
    templates), zero requests, zone
    indices from -1 and capacity types from -1 to past 32 * W."""
    O = 8
    template, group = rand_enc(rng, M, K, W), rand_enc(rng, G, K, W)
    for e in (template, group):
        e.mask[:, :2, :] |= i32(rng.integers(0, 2**31, (e.mask.shape[0], 2,
                                                         W)))
    cmb, compat_tm = kernels.combine_compat_plain(
        template, group, flags(rng, (K,), 0.5))
    it = rand_enc(rng, T, K, W)
    it.defined[:, 2:] &= flags(rng, (T, K - 2), 0.3)   # some pairs intersect
    daemon = rng.integers(0, 300, (M, R))
    if M > 1:
        daemon[-1, 2] = 10**6
    req = rng.integers(0, 500, (G, R))
    req[0] = 0
    return (cmb, flags(rng, (M, G), 0.9), it, i32(req), i32(daemon),
            i32(rng.integers(0, 4000, (T, R))), flags(rng, (M, T), 0.9),
            i32(rng.integers(-1, Z, (T, O))),
            i32(rng.integers(-1, 32 * W + 3, (T, O))),
            flags(rng, (T, O), 0.8), i32(np.arange(Z)),
            flags(rng, (G, M), 0.9))


# (M, G, T, W, Z): row counts on and off the tiles' edges (the B tile holds
# 8, 16 or 32 rows, the A tile 16 to 128 types), W of 1, 8 and 64 words,
# 8-, 16- and 32-bit zone words, the disruption shape (MG = 8, T = 144,
# W = 8) and the north-star shape (MG = 120, T = 2,000, W = 64)
CATALOG_EDGES = [(1, 1, 1, 64, 4), (1, 7, 333, 8, 4), (1, 8, 144, 8, 4),
                 (1, 9, 517, 1, 12), (3, 3, 129, 8, 33),
                 (1, 120, 2000, 64, 4), (2, 60, 1001, 64, 40)]


@pytest.mark.parametrize("M,G,T,W,Z", CATALOG_EDGES)
def test_catalog_feasibility_matches_plain_at_tile_edges(M, G, T, W, Z):
    rng = np.random.default_rng(M * 1000 + G + T)
    args = catalog_case(rng, M, G, T, W, Z)
    kw = dict(zone_key=0, captype_key=1)
    before = kernels.LAUNCHES["catalog_feasibility"]
    out = kernels.catalog_feasibility(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["catalog_feasibility"] == before + 1
    assert_same(out, kernels.catalog_feasibility_plain(*args, **kw))
    if M * G * T > 64:
        assert (out[0] != 0).any() and (out[0] == 0).any()


def test_catalog_feasibility_writes_zone_adm_for_an_empty_catalog():
    rng = np.random.default_rng(5)
    args = catalog_case(rng, 2, 9, 0, 8, 4)
    kw = dict(zone_key=0, captype_key=1)
    out = kernels.catalog_feasibility(*args, **kw)
    torch.cuda.synchronize()
    assert_same(out, kernels.catalog_feasibility_plain(*args, **kw))


def exist_case(rng, G, N, W, K=9, R=4):
    """K3's inputs: a third of the nodes define every key with every value
    (and every group mask holds value 0), negative avail (floor != trunc),
    and padded rows at the end."""
    group, exist = rand_enc(rng, G, K, W), rand_enc(rng, N, K, W)
    group.mask[:, :, 0] |= 1          # the full nodes can meet every group
    req = rng.integers(0, 6, (G, R))
    avail = rng.integers(-20, 40, (N, R))
    full = rng.random(N) < 0.35
    exist.defined[full] = True
    exist.exempt[full] = False
    exist.mask[full] = -1
    exist.gt[full] = INT_MIN
    exist.lt[full] = INT_MAX
    pad = N // 10
    if pad:
        avail[-pad:] = 0
        exist.defined[-pad:] = False
        exist.mask[-pad:] = -1
    return group, i32(req), exist, i32(avail), flags(rng, (G, N), 0.9)


# (G, N, W): group counts on and off the B tile's edges, node counts that
# are not multiples of any A tile, W of 1, 8 and 64 words, the disruption
# shape (G = 8, N = 8,192, W = 8) and the north-star shape (G = 120,
# N = 8,192, W = 64), whose block needs the shared-memory opt-in
EXIST_EDGES = [(1, 1000, 64), (7, 333, 8), (8, 8192, 8), (9, 517, 1),
               (33, 129, 3), (120, 8192, 64), (120, 1037, 64)]


@pytest.mark.parametrize("G,N,W", EXIST_EDGES)
def test_exist_feasibility_matches_plain_at_tile_edges(G, N, W):
    rng = np.random.default_rng(G * 10000 + N)
    args = exist_case(rng, G, N, W)
    before = kernels.LAUNCHES["exist_feasibility"]
    out = kernels.exist_feasibility(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["exist_feasibility"] == before + 1
    assert_same(out, kernels.exist_feasibility_plain(*args))
    assert out[0].any() and not out[0].all()


@pytest.mark.parametrize("ra,rb", [(8, 4), (2, 1), (1, 1)])
@pytest.mark.parametrize("K,W,R,O,Wz,Z,stages", [(9, 64, 4, 8, 1, 4, 2),
                                                 (9, 8, 4, 8, 1, 4, 9),
                                                 (40, 3, 7, 5, 2, 33, 2)])
def test_join_smem_matches_the_kernels_layout(ra, rb, K, W, R, O, Wz, Z,
                                              stages):
    """kernels.join_smem (the plan's fit test) equals the bytes the C
    launchers ask for."""
    lib = kernels._lib()
    ta, tb = 16 * ra, 8 * rb
    assert lib.kt_exist_feasibility_smem(ta, tb, K, W, R, stages) == \
        kernels.join_smem("exist_feasibility", ta, tb, K, W, stages, R=R)
    assert lib.kt_catalog_feasibility_smem(ta, tb, K, W, R, O, Wz, Z,
                                           stages) == \
        kernels.join_smem("catalog_feasibility", ta, tb, K, W, stages, R=R,
                          O=O, Wz=Wz, Z=Z)


def test_north_star_exist_plan_needs_the_shared_memory_opt_in():
    plan = kernels.join_plan("exist_feasibility", 8192, 120, 9, 64, R=4)
    assert plan.smem > 48 * 1024


def test_exist_feasibility_matches_plain_on_unaligned_rows():
    """A mask that starts 4 bytes past a 16-byte boundary takes the word
    copies instead of the 16-byte ones."""
    rng = np.random.default_rng(11)
    group, req, exist, avail, tol = exist_case(rng, 9, 301, 8)
    flat = torch.empty(exist.mask.numel() + 1, dtype=torch.int32,
                       device="cuda")
    shifted = flat[1:].view(exist.mask.shape)
    shifted.copy_(exist.mask)
    exist = exist._replace(mask=shifted)
    assert exist.mask.data_ptr() % 16 == 4
    out = kernels.exist_feasibility(group, req, exist, avail, tol)
    torch.cuda.synchronize()
    assert_same(out, kernels.exist_feasibility_plain(group, req, exist, avail,
                                                     tol))


def test_exist_feasibility_matches_plain():
    rng = np.random.default_rng(1)
    K, W, G, N, R = 9, 64, 13, 300, 3
    group, exist = rand_enc(rng, G, K, W), rand_enc(rng, N, K, W)
    req = rng.integers(0, 6, (G, R))
    avail = rng.integers(-20, 40, (N, R))     # negative: floor != trunc
    # nodes that define every key with every value, so some pairs pass
    exist.defined[:100] = True
    exist.exempt[:100] = False
    exist.mask[:100] = -1
    exist.gt[:100] = INT_MIN
    exist.lt[:100] = INT_MAX
    # padded rows: undefined keys (all ones) and zero capacity
    avail[-50:] = 0
    exist.defined[-50:] = False
    exist.mask[-50:] = -1
    args = (group, i32(req), exist, i32(avail), flags(rng, (G, N), 0.9))
    out = kernels.exist_feasibility(*args)
    torch.cuda.synchronize()
    assert_same(out, kernels.exist_feasibility_plain(*args))
    assert not out[0][:, -50:].any()
    assert out[0].any()


WORKLOADS = {
    "mini": lambda: mini_workload(PORT),
    "restricted": lambda: restricted_workload(PORT),
    "bench_nodes": lambda: bench_workload(PORT, 900, 300, n_nodes=40),
    "zones_40": lambda: bench_workload(
        PORT, 180, 30, zones=[f"zone-{i:02d}" for i in range(40)],
        n_deploys=18),
}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_precompute_cuda_matches_cpu(name):
    _, problem = build_problem(PORT, WORKLOADS[name]())
    kernels.reset_launches()
    got = binpack.precompute(problem, device="cuda")
    has_exist = problem.exist_enc is not None
    assert kernels.LAUNCHES == dict.fromkeys(kernels.KERNELS, 0) | {
        "combine_compat": 1, "catalog_feasibility": 1,
        "exist_feasibility": int(has_exist)}
    assert_tensors_equal(binpack.precompute(problem, device="cpu"), got)
    if has_exist:
        ok, cap = binpack.exist_delta(problem, device="cuda")
        np.testing.assert_array_equal(ok, got.exist_ok)
        np.testing.assert_array_equal(cap, got.exist_cap)


def test_solve_on_cuda_matches_cpu():
    pools, its, nodes, pods = bench_workload(PORT, 900, 300, n_nodes=40)
    digests = []
    for device in ("cuda", "cpu"):
        ts = scheduler(PORT, pools, its, state_nodes=nodes, force_tensor=True,
                       device=device)
        results = ts.solve(pods)
        assert ts.fallback_reason == "" and ts.partition == (len(pods), 0)
        digests.append(decision_digest(results, pods, ts.fallback_reason,
                                       ts.partition))
    assert digests[0] == digests[1]


def test_wrappers_refuse_what_the_kernels_do_not_take():
    rng = np.random.default_rng(0)
    template, group = rand_enc(rng, 2, 4, 2), rand_enc(rng, 5, 4, 2)
    allow = flags(rng, (4,), 0.5)
    with pytest.raises(ValueError, match="dtype"):
        kernels.combine_compat(template, group, allow.to(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.combine_compat(template._replace(mask=template.mask.transpose(
            1, 2).contiguous().transpose(1, 2)), group, allow)
    with pytest.raises(ValueError, match="on cpu"):
        kernels.combine_compat(template, group, allow.cpu())


def test_refused_launch_raises():
    """A mask row too wide for one block's shared memory: the launcher's
    CUDA error surfaces as an exception, not as unwritten outputs."""
    rng = np.random.default_rng(2)
    group, exist = rand_enc(rng, 1, 1, 60000), rand_enc(rng, 1, 1, 60000)
    before = kernels.LAUNCHES["exist_feasibility"]
    with pytest.raises(kernels.KernelError,
                       match="exist_feasibility kernel launch failed"):
        kernels.exist_feasibility(group, i32([[1]]), exist, i32([[1]]),
                                  flags(rng, (1, 1), 1.0))
    assert kernels.LAUNCHES["exist_feasibility"] == before


def exist_leaves(rng, rows, K, W, R, device="cuda"):
    """The 7 exist-side leaves the mesh placer keeps resident."""
    e = rand_enc(rng, rows, K, W, device)
    return list(e) + [i32(rng.integers(-5, 1 << 20, (rows, R)), device)]


@pytest.mark.parametrize("rows,start,span,K", [
    (64, 16, 16, 9),      # 16-byte aligned everywhere
    (64, 3, 5, 9),        # bool leaves start at an odd byte: byte path
    (8192, 2048, 2048, 9),  # the north-star span
    (33, 32, 1, 3),       # one row at the end
])
def test_row_splice_matches_plain(rows, start, span, K):
    rng = np.random.default_rng(rows + start)
    W, R = 64, 4
    bufs = exist_leaves(rng, rows, K, W, R)
    block = [x.cpu() for x in exist_leaves(rng, span, K, W, R)]
    want = [b.clone() for b in bufs]
    kernels.row_splice_plain(want, [b.to("cuda") for b in block], start)
    before = kernels.LAUNCHES["row_splice"]
    kernels.row_splice(bufs, block, start)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["row_splice"] == before + 1
    for a, b in zip(bufs, want, strict=True):
        assert torch.equal(a, b)


def test_mesh_precompute_on_one_card_matches_cpu():
    """An 8-slot mesh over cuda:0 launches K1 + K2 on every slot and K3
    once per pods_groups row; the result equals the CPU precompute."""
    from karpenter_tpu_torch.parallel import mesh as tmesh
    _, problem = build_problem(PORT, bench_workload(PORT, 900, 300,
                                                    n_nodes=40))
    m = tmesh.make_solver_mesh(devices=[torch.device("cuda", 0)] * 8)
    kernels.reset_launches()
    got = tmesh.sharded_precompute(problem, m)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.KERNELS, 0) | {
        "combine_compat": 8, "catalog_feasibility": 8, "exist_feasibility": 4}
    assert_tensors_equal(binpack.precompute(problem, device="cpu"), got)


def test_launch_timer_device_time_is_the_wait_after_dispatch():
    """LaunchTimer's device time is the host's wait for the launches after
    ``launched()``: a spin enqueued before it is waited for there, and a
    wait for work already done is short."""
    import time

    from karpenter_tpu_torch.obs.device import LaunchTimer
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.synchronize()
    timer = LaunchTimer([dev])
    torch.cuda._sleep(200_000_000)  # about 0.1 s of spinning
    dispatch = timer.launched()
    waited = timer.wait()
    assert dispatch < 0.05 < waited, (dispatch, waited)
    timer = LaunchTimer([dev])
    torch.cuda._sleep(1000)
    timer.launched()
    time.sleep(0.05)
    assert timer.wait() < 0.01
