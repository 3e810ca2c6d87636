"""ops/kernels.py loader and wrappers, on the CPU: the build is keyed on the
sources and raises with nvcc's own output when nvcc is missing or fails,
and CPU tensors take the plain versions without counting launches."""

import dataclasses
import re
import shutil
import stat

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.ops import binpack, kernels

from karpenter_tpu_torch.provisioning.tensor_scheduler import (
    SolverCircuitBreaker)

from test_torch_support import PORT, build_problem, mini_workload, scheduler
from test_torch_support import device_series_kept  # noqa: F401 (autouse)

FAKE_NVCC = """#!/bin/sh
echo "$@" >> "$(dirname "$0")/calls"
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo built > "$out"
"""


def _script(path, body):
    path.write_text(body)
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


@pytest.fixture
def scratch_build(tmp_path, monkeypatch):
    """kernels.build against a copy of the sources and an empty build dir."""
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    return csrc


def test_build_raises_without_nvcc(scratch_build, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(kernels.KernelError, match="nvcc not found"):
        kernels.build()


def test_build_raises_with_nvcc_output(scratch_build, tmp_path, monkeypatch):
    nvcc = _script(tmp_path / "nvcc",
                   "#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 3\n")
    monkeypatch.setattr(kernels, "_nvcc", lambda: nvcc)
    with pytest.raises(kernels.KernelError, match="(?s)rc=3.*no sm_90a here"):
        kernels.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_is_keyed_on_the_sources(scratch_build, tmp_path, monkeypatch):
    nvcc = _script(tmp_path / "nvcc", FAKE_NVCC)
    monkeypatch.setattr(kernels, "_nvcc", lambda: nvcc)
    assert kernels.build() is True
    calls = (tmp_path / "calls").read_text().splitlines()
    assert len(calls) == 1                      # one nvcc call, one library
    assert all(f"{name}.cu" in calls[0] for name in kernels.KERNELS)
    assert kernels.build() is False             # cached by hash
    src = scratch_build / "exist_feasibility.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert kernels.build() is True
    hdr = scratch_build / "feasibility_common.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    assert kernels.build() is True
    assert len(list((tmp_path / "build").glob("*.so"))) == 3


def test_device_failures_become_kernel_errors_on_cuda_only():
    with pytest.raises(kernels.KernelError, match="illegal memory access"):
        with kernels.device_failures(torch.device("cuda")):
            raise RuntimeError("CUDA error: an illegal memory access")
    with pytest.raises(ValueError):
        with kernels.device_failures(torch.device("cpu")):
            raise ValueError("plain version")


def test_kernel_failure_raises_from_default_solve(monkeypatch):
    """A refused launch reaches the caller of a default solve (no
    force_tensor): it is not answered by the host oracle and does not count
    toward the breaker."""
    pools, its, nodes, pods = mini_workload(PORT)
    circuit = SolverCircuitBreaker(threshold=1)
    ts = scheduler(PORT, pools, its, state_nodes=nodes, circuit=circuit)

    def refuse(name, device, *args):
        raise kernels.KernelError(f"{name} kernel launch failed: refused")

    monkeypatch.setattr(kernels, "_on_cuda", lambda t: True)
    monkeypatch.setattr(kernels, "_launch", refuse)
    for _ in range(2):
        with pytest.raises(kernels.KernelError, match="launch failed"):
            ts.solve(pods)
    assert circuit.state == circuit.CLOSED and circuit.allow()
    assert ts.fallback_reason == ""


def test_cpu_tensors_take_the_plain_versions():
    _, problem = build_problem(PORT, mini_workload(PORT))
    kernels.reset_launches()
    tensors = binpack.precompute(problem, device="cpu")
    assert kernels.LAUNCHES == dict.fromkeys(kernels.KERNELS, 0)
    assert tensors.it_ok.any() and tensors.exist_ok.any()
    assert problem.exist_enc is not None


def test_other_devices_are_refused():
    _, problem = build_problem(PORT, mini_workload(PORT))
    placer = binpack.ArgPlacer(torch.device("meta"))
    args, statics = binpack.device_args(
        dataclasses.replace(problem, device_cache=None), placer)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        binpack.precompute_kernel(*args, **statics)
    with pytest.raises(ValueError, match="unsupported device"):
        binpack.precompute(problem, device="meta")


# -- B3 row_splice -----------------------------------------------------------

LEAF_KINDS = {
    "mask": lambda rng, n: rng.integers(0, 2**32, (n, 3, 5),
                                        dtype=np.uint64).astype(np.uint32),
    "bool": lambda rng, n: rng.random((n, 9)) < 0.5,
    "bounds": lambda rng, n: rng.integers(-2**31, 2**31 - 1, (n, 9),
                                          dtype=np.int64).astype(np.int32),
    "avail": lambda rng, n: rng.integers(-9, 1 << 20, (n, 4)).astype(
        np.int32),
}


def _as_torch(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("kind", sorted(LEAF_KINDS))
@pytest.mark.parametrize("seed", range(4))
def test_row_splice_plain_matches_jax_donated_row_splice(kind, seed):
    """The plain version equals the JAX package's _donated_row_splice on
    random buffers, blocks and starts of every exist-side leaf type."""
    from karpenter_tpu.parallel.mesh import _donated_row_splice
    rng = np.random.default_rng(seed)
    rows = int(rng.integers(1, 40))
    span = int(rng.integers(1, rows + 1))
    start = int(rng.integers(0, rows - span + 1))
    make = LEAF_KINDS[kind]
    buf, block = make(rng, rows), make(rng, span)
    want = np.asarray(_donated_row_splice(buf.copy(), block, start))
    got = _as_torch(buf)
    kernels.row_splice_plain([got], [_as_torch(block)], start)
    np.testing.assert_array_equal(
        got.numpy().view(want.dtype) if kind == "mask" else got.numpy(), want)


def test_row_splice_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(5)
    bufs = [_as_torch(make(rng, 16)) for make in LEAF_KINDS.values()]
    blocks = [make(rng, 4) for make in LEAF_KINDS.values()]
    want = [b.clone() for b in bufs]
    kernels.row_splice_plain(want, [_as_torch(b) for b in blocks], 8)
    before = dict(kernels.LAUNCHES)
    kernels.row_splice(bufs, blocks, 8)
    assert kernels.LAUNCHES == before
    for a, b in zip(bufs, want):
        assert torch.equal(a, b)


def test_row_splice_refuses_what_it_does_not_take():
    buf = torch.zeros((8, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="dtype"):
        kernels.row_splice([buf], [np.zeros((2, 3), np.int64)], 0)
    with pytest.raises(ValueError, match="rows"):
        kernels.row_splice([buf], [np.zeros((2, 4), np.int32)], 0)
    with pytest.raises(ValueError, match="outside"):
        kernels.row_splice([buf], [np.zeros((2, 3), np.int32)], 7)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.row_splice([torch.zeros((3, 8), dtype=torch.int32).T],
                           [np.zeros((2, 3), np.int32)], 0)


# -- K1 combine_compat: its plain version and its geometry -------------------

#: K1's geometry edges: keys around a warp, words per key around a 16-byte
#: vector and past 32 lanes, pair counts around the launch shapes (0, 8 at
#: the disruption encodes, 32 at a 4x2 mesh slot, 120-128 at the north star)
K1_KEYS = (1, 9, 33)
K1_WORDS = (1, 3, 4, 8, 64, 65)
K1_PAIRS = ((1, 0), (1, 1), (1, 8), (1, 32), (3, 43))


def rand_encoded(rng, rows, K, W):
    """Random encoded rows (numpy, as the encoder gives them): sparse masks
    (about two nonzero words of four bits per key), so intersections come
    out both empty and nonempty, and some Gt/Lt bounds."""
    from karpenter_tpu_torch.ops.encode import EncodedRequirements
    mask = (rng.integers(0, 16, (rows, K, W))
            * (rng.random((rows, K, W)) < 2.0 / W)).astype(np.uint32)
    mask[..., 0] |= (rng.random((rows, K)) < 0.3).astype(np.uint32) << 31
    bound = lambda fill: np.where(  # noqa: E731
        rng.random((rows, K)) < 0.2, rng.integers(-3, 9, (rows, K)),
        fill).astype(np.int32)
    return EncodedRequirements(
        mask=mask, defined=rng.random((rows, K)) < 0.6,
        complement=rng.random((rows, K)) < 0.5,
        exempt=rng.random((rows, K)) < 0.2, gt=bound(-2**31),
        lt=bound(2**31 - 1))


def _combine_compat_both(M, G, K, W, seed):
    """(JAX compatible_matrix + combine flattened m-major, the port's
    combine_compat_plain) on the same random rows."""
    from karpenter_tpu.ops import feasibility as jfeas
    from karpenter_tpu_torch.ops import feasibility as tfeas
    rng = np.random.default_rng(seed)
    template, group = rand_encoded(rng, M, K, W), rand_encoded(rng, G, K, W)
    group.defined[:1] = False       # a group every template is compatible with
    allow = rng.random(K) < 0.4
    jt, jg = jfeas.to_device(template), jfeas.to_device(group)
    want_tm = np.asarray(jfeas.compatible_matrix(jt, jg, allow))
    want = [np.asarray(x).reshape((M * G,) + x.shape[2:]) for x in
            jfeas.combine(jfeas.Enc(*(x[:, None] for x in jt)),
                          jfeas.Enc(*(x[None, :] for x in jg)))]
    cmb, compat_tm = kernels.combine_compat_plain(
        tfeas.to_device(template, "cpu"), tfeas.to_device(group, "cpu"),
        torch.from_numpy(allow))
    got = [x.numpy() for x in cmb]
    got[0] = got[0].view(np.uint32)
    for name, w, g in zip(("mask",) + tfeas.Enc._fields[1:], want, got):
        assert w.dtype == g.dtype and np.array_equal(w, g), name
    assert np.array_equal(want_tm, compat_tm.numpy())
    return compat_tm


@pytest.mark.parametrize("K", K1_KEYS)
@pytest.mark.parametrize("W", K1_WORDS)
def test_combine_compat_plain_matches_jax_at_the_key_and_word_edges(K, W):
    compat_tm = _combine_compat_both(3, 43, K, W, seed=K * 100 + W)
    assert compat_tm.any() and not compat_tm.all()


@pytest.mark.parametrize("M,G", K1_PAIRS)
@pytest.mark.parametrize("W", [3, 64])
def test_combine_compat_plain_matches_jax_at_the_pair_edges(M, G, W):
    _combine_compat_both(M, G, 9, W, seed=M * G + W)


def _combine_word_counts(plan, M, G, K, W):
    """How many lanes of the launch move each word of the combined rows
    [M * G, K, W], by the kernel's thread mapping: block (x, y) takes m = y
    and g = x; thread t is lane t % lanes of
    key slot t // lanes, which takes key r * slots + slot in round r (k <
    K); its j-th unit is lane + j * lanes (< W // vec), words [unit * vec,
    unit * vec + vec)."""
    t = np.arange(plan.threads)
    k = (np.arange(plan.rounds)[:, None] * plan.slots
         + (t // plan.lanes)[None, :])                        # [R, T]
    u = (np.arange(plan.units)[:, None] * plan.lanes
         + (t % plan.lanes)[None, :])                         # [N, T]
    g = np.arange(plan.grid_g)
    m = np.arange(plan.grid_m)
    k, u = np.broadcast_arrays(k[:, None, :], u[None, :, :])  # [R, N, T]
    keep = (k < K) & (u < W // plan.vec)
    k, u = k[keep], u[keep]
    g = g[g < G]
    pair = (m[:, None] * G + g[None, :]).ravel()
    words = ((pair[:, None, None] * K + k[None, :, None]) * W
             + u[None, :, None] * plan.vec
             + np.arange(plan.vec)[None, None, :]).ravel()
    return np.bincount(words, minlength=M * G * K * W)


@pytest.mark.parametrize("K", K1_KEYS)
@pytest.mark.parametrize("W", K1_WORDS)
@pytest.mark.parametrize("M,G", K1_PAIRS[1:] + ((2, 1000),))
@pytest.mark.parametrize("aligned", [True, False])
def test_combine_plan_moves_every_word_of_every_pair_once(K, W, M, G,
                                                          aligned):
    plan = kernels.combine_plan(M, G, K, W, aligned=aligned)
    assert plan.vec == (4 if aligned and W % 4 == 0 else 1)
    assert plan.lanes in (1, 2, 4, 8, 16, 32)
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    assert plan.slots * plan.lanes == plan.threads
    assert (plan.grid_g, plan.grid_m) == (G, M)
    assert (_combine_word_counts(plan, M, G, K, W) == 1).all()


def test_combine_plan_at_the_main_path_shapes():
    """One round trip a lane at the three launch shapes: the north star
    (120 pairs, 9 keys of 64 words: 16 lanes of 16-byte loads a key), a 4x2
    mesh slot (32 pairs) and a disruption encode (8 pairs of 8 words: 2
    lanes a key, one warp a pair), a pair a block."""
    north = kernels.combine_plan(1, 120, 9, 64)
    assert north == kernels.CombinePlan(vec=4, lanes=16, units=1,
                                        threads=160, slots=10, rounds=1,
                                        grid_g=120, grid_m=1)
    assert kernels.combine_plan(1, 32, 9, 64) == north._replace(grid_g=32)
    assert kernels.combine_plan(1, 8, 9, 8) == kernels.CombinePlan(
        vec=4, lanes=2, units=1, threads=32, slots=16, rounds=1,
        grid_g=8, grid_m=1)
    wide = kernels.combine_plan(2, 1000, 9, 64)
    assert (wide.grid_g, wide.grid_m) == (1000, 2)
    # unaligned rows take words: two loads a lane of 32 lanes a key
    assert kernels.combine_plan(1, 120, 9, 64, aligned=False)[:4] == (
        1, 32, 2, 288)


# -- B5a fits_matrix, B5b offering_compat ------------------------------------

@pytest.mark.parametrize("A,B,R", [(1, 1, 1), (31, 33, 4), (64, 17, 3)])
def test_fits_matrix_wrapper_matches_jax_on_the_cpu(A, B, R):
    from karpenter_tpu.ops import feasibility as jfeas
    rng = np.random.default_rng(A * B)
    req = rng.integers(-3, 60, (B, R)).astype(np.int32)
    req[0] = 0
    avail = rng.integers(-5, 80, (A, R)).astype(np.int32)
    before = dict(kernels.LAUNCHES)
    got = kernels.fits_matrix(torch.from_numpy(req), torch.from_numpy(avail))
    assert kernels.LAUNCHES == before
    np.testing.assert_array_equal(np.asarray(jfeas.fits_matrix(req, avail)),
                                  got.numpy())


#: B5a's edge shapes: B around the store widths and a tile of 4,096 rows,
#: A of one row and of the padded node axis, R of 1, 4 (the int4 path) and 9
FITS_EDGES = [(A, B, R) for A in (1, 8192) for B in (1, 7, 120, 121, 4096)
              for R in (1, 4, 9)]


def _fits_emulated(plan, req: np.ndarray, avail: np.ndarray) -> np.ndarray:
    """csrc/fits_matrix.cu's work split, run in numpy: every block stages
    its request tile into the padded run layout (a request of zero or less
    as INT_MIN), every thread item (avail row, run) writes its run's
    `width` bytes. Fails on a staged slot or an
    output byte written twice, or a staged tile past the plan's smem."""
    A, R = avail.shape
    B = req.shape[0]
    out = np.full(A * B, 255, dtype=np.uint8)
    stride = plan.width * R + (4 if plan.vec4 else 1)
    for by in range(plan.grid_b):
        b0 = by * plan.tile_b
        runs = min(plan.tile_b, B - b0) // plan.width
        smem = np.full(max(1, plan.smem // 4), -7, dtype=np.int64)
        flat = req[b0:b0 + runs * plan.width].reshape(-1)
        flat = np.where(flat <= 0, np.iinfo(np.int32).min, flat)
        for w in range(runs * plan.width * R):
            col = w // R
            slot = (col // plan.width) * stride + (col % plan.width) * R \
                + w - col * R
            assert slot * 4 < plan.smem and smem[slot] == -7
            smem[slot] = flat[w]
        for bx in range(plan.grid_a):
            a0 = bx * plan.rows
            for i in range(min(plan.rows, A - a0) * runs):
                a, c = a0 + i // runs, i % runs
                s = smem[c * stride:c * stride + plan.width * R]
                q = s.reshape(plan.width, R)
                fit = np.all(q <= avail[a], axis=1)
                at = a * B + b0 + c * plan.width
                assert at % plan.width == 0
                assert (out[at:at + plan.width] == 255).all()
                out[at:at + plan.width] = fit
    assert (out != 255).all(), "an output byte was never written"
    return out.reshape(A, B).astype(bool)


@pytest.mark.parametrize("A,B,R", [(A, B, R) for A, B, R in FITS_EDGES
                                   if A == 1 or B <= 7]
                         + [(8192, 120, 4)])
def test_fits_plan_writes_every_output_once(A, B, R):
    """The kernel's work split, emulated at B5a's edge shapes (the large
    ones at one avail row, whose split is the same per row), equals the
    plain version: zero, negative, INT_MIN and INT_MAX requests included."""
    rng = np.random.default_rng(A * B * R)
    req = rng.integers(-5, 60, (B, R)).astype(np.int32)
    req.reshape(-1)[::5] = 0
    req.reshape(-1)[1::7] = -2**31
    req.reshape(-1)[2::11] = 2**31 - 1
    avail = rng.integers(-5, 80, (A, R)).astype(np.int32)
    avail.reshape(-1)[::13] = 2**31 - 1
    want = kernels.feas.fits_matrix(torch.from_numpy(req),
                                    torch.from_numpy(avail)).numpy()
    for aligned in (True, False):
        plan = kernels.fits_plan(A, B, R, aligned=aligned)
        assert plan.vec4 == (R == 4 and aligned)
        assert plan.smem <= kernels.FITS_SMEM_BYTES
        np.testing.assert_array_equal(_fits_emulated(plan, req, avail), want)


def test_fits_plan_at_the_solve_shape():
    """8-byte stores (the widest width dividing 120), one tile of all 120
    request rows, 17 avail rows a block: 482 blocks of 255 busy threads."""
    plan = kernels.fits_plan(8192, 120, 4)
    assert plan == kernels.FitsPlan(width=8, vec4=True, tile_b=120, rows=17,
                                    grid_a=482, grid_b=1, smem=15 * 36 * 4)
    assert kernels.fits_plan(8192, 4096, 4).width == 16
    assert kernels.fits_plan(8192, 12, 4).width == 4
    assert kernels.fits_plan(8192, 121, 4).width == 1
    wide = kernels.fits_plan(8192, 4096, 9)
    assert wide.grid_b > 1 and wide.tile_b % 16 == 0


def test_fits_matrix_refuses_sizes_past_32_bit_indexing():
    req = torch.empty((70_000, 4), dtype=torch.int32)
    avail = torch.empty((40_000, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="32-bit"):
        kernels._fits_matrix_args(req, avail)


@pytest.mark.parametrize("W", [1, 2, 5])
def test_offering_compat_wrapper_matches_jax_on_the_cpu(W):
    """Value indices from -1 to past 32 * W: the 32-bit word boundaries and
    the out-of-range fill."""
    from karpenter_tpu.ops import feasibility as jfeas
    rng = np.random.default_rng(W)
    B, K, T, O = 13, 6, 40, 8
    mask = rng.integers(0, 2**32, (B, K, W), dtype=np.uint64).astype(
        np.uint32)
    off_zone, off_ct = (rng.integers(-1, 32 * W + 33, (T, O)).astype(
        np.int32) for _ in range(2))
    off_avail = rng.random((T, O)) < 0.5
    before = dict(kernels.LAUNCHES)
    got = kernels.offering_compat(
        torch.from_numpy(mask.view(np.int32)), 2, 5,
        torch.from_numpy(off_zone), torch.from_numpy(off_ct),
        torch.from_numpy(off_avail))
    assert kernels.LAUNCHES == before
    want = jfeas.offering_compat(mask, 2, 5, off_zone, off_ct, off_avail)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert got.any() and not got.all()


@pytest.mark.parametrize("B,T,O", [(1, 1, 1), (3, 127, 3), (4, 128, 8),
                                   (5, 129, 8), (33, 300, 1), (40, 257, 3),
                                   (7, 50, 9)])
def test_offering_compat_wrapper_matches_jax_at_the_tile_edges(B, T, O):
    """Row and type counts around the kernel's 4-row x 128-type tile, O
    around its 8-offering chunk, and indices from -1 to past 32 * W."""
    from karpenter_tpu.ops import feasibility as jfeas
    rng = np.random.default_rng(B * T * O)
    K, W = 4, 2
    mask = rng.integers(0, 2**32, (B, K, W), dtype=np.uint64).astype(
        np.uint32)
    off_zone, off_ct = (rng.integers(-1, 32 * W + 9, (T, O)).astype(
        np.int32) for _ in range(2))
    off_avail = rng.random((T, O)) < 0.6
    got = kernels.offering_compat(
        torch.from_numpy(mask.view(np.int32)), 1, 3,
        torch.from_numpy(off_zone), torch.from_numpy(off_ct),
        torch.from_numpy(off_avail))
    want = jfeas.offering_compat(mask, 1, 3, off_zone, off_ct, off_avail)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_offering_compat_refuses_sizes_past_32_bit_indexing():
    mask = torch.empty((70_000, 1, 1), dtype=torch.int32)
    offers = torch.empty((40_000, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="32-bit"):
        kernels._offering_compat_args(mask, 0, 0, offers, offers,
                                      offers.bool())


# -- the tile plan of K2 / K3 (kernels.join_plan) -----------------------------

#: the four launch shapes the plan must fill the card at: K3 and K2 at the
#: north star (5,000 nodes / 2,000 types, 120 groups, W = 64) and at the
#: disruption encodes (8 padded groups, W = 8)
JOIN_SHAPES = [("exist_feasibility", 8192, 120, 9, 64, 4, 0, 0, 0),
               ("exist_feasibility", 8192, 8, 9, 8, 4, 0, 0, 0),
               ("catalog_feasibility", 2000, 120, 9, 64, 4, 8, 1, 4),
               ("catalog_feasibility", 144, 8, 9, 8, 4, 8, 1, 4)]


def _random_join_shape(seed):
    rng = np.random.default_rng(seed)
    kind = ("exist_feasibility", "catalog_feasibility")[seed % 2]
    return (kind, int(rng.integers(0, 20000)) if kind[0] == "c"
            else int(rng.integers(1, 20000)), int(rng.integers(1, 300)),
            int(rng.integers(0, 13)), int(rng.integers(1, 80)),
            int(rng.integers(0, 7)), int(rng.integers(1, 11)),
            int(rng.integers(1, 3)), int(rng.integers(1, 65)))


def _pair_counts(plan, A, B):
    """How many threads of the launch own each pair (a, b), by the kernels'
    thread mapping: block (x, y), thread (ta, tb) = (tid % 16, tid / 16)
    owns A-rows x * tile_a + ta + 16 i (i < ra) and B-rows y * tile_b + tb
    + 8 j (j < rb); pairs outside [0, A) x [0, B) are skipped."""
    def rows(grid, tile, threads, r, limit):
        idx = (np.arange(grid)[:, None, None] * tile
               + np.arange(threads)[None, :, None]
               + threads * np.arange(r)[None, None, :]).ravel()
        return idx[idx < limit]
    a = rows(plan.grid_a, plan.tile_a, kernels.JOIN_THREADS_A, plan.ra, A)
    b = rows(plan.grid_b, plan.tile_b, kernels.JOIN_THREADS_B, plan.rb, B)
    return np.bincount((a[:, None] * B + b[None, :]).ravel(),
                       minlength=A * B)


@pytest.mark.parametrize("shape", JOIN_SHAPES + [
    _random_join_shape(seed) for seed in range(24)])
def test_join_plan_covers_every_pair_once_and_fills_the_card(shape):
    kind, A, B, K, W, R, O, Wz, Z = shape
    plan = kernels.join_plan(kind, A, B, K, W, R=R, O=O, Wz=Wz, Z=Z)
    assert (plan.ra, plan.rb) in kernels.JOIN_MICRO_TILES[kind]
    assert plan.tile_a == kernels.JOIN_THREADS_A * plan.ra
    assert plan.tile_b == kernels.JOIN_THREADS_B * plan.rb
    assert plan.stages in (K, 2)
    assert plan.smem == kernels.join_smem(kind, plan.tile_a, plan.tile_b, K,
                                          W, plan.stages, R=R, O=O, Wz=Wz,
                                          Z=Z)
    assert plan.smem <= kernels.SMEM_PER_BLOCK
    if A:
        assert (_pair_counts(plan, A, B) == 1).all()
    else:
        assert plan.grid_a == 1     # zone_adm is written by the first column
    smallest = kernels.JOIN_THREADS_A * kernels.JOIN_THREADS_B
    if A * B >= kernels.SM_COUNT * smallest:
        assert plan.grid_a * plan.grid_b >= kernels.SM_COUNT


def test_join_plan_at_the_main_path_shapes():
    """Every SM gets a block at three of the four shapes; the fourth (MG = 8
    x T = 144) has fewer pairs than 132 blocks of the smallest tile."""
    plans = [kernels.join_plan(kind, A, B, K, W, R=R, O=O, Wz=Wz, Z=Z)
             for kind, A, B, K, W, R, O, Wz, Z in JOIN_SHAPES]
    assert [p.grid_a * p.grid_b >= kernels.SM_COUNT for p in plans] == [
        True, True, True, False]
    # the north-star K3 block holds 128 nodes x 32 groups in a two-stage
    # ring above the 48 KB default; the disruption blocks keep every key
    assert (plans[0].tile_a, plans[0].tile_b, plans[0].stages) == (128, 32, 2)
    assert plans[0].smem > 48 * 1024
    assert plans[1].stages == plans[3].stages == 9


def test_join_plan_leaves_the_smallest_tile_when_nothing_fits():
    """A row too wide for any block: the launch is refused on the card and
    the wrapper raises KernelError (tests/test_torch_kernels_cuda.py)."""
    plan = kernels.join_plan("exist_feasibility", 1, 1, 1, 60000, R=1)
    assert (plan.ra, plan.rb) == (1, 1)
    assert plan.smem > kernels.SMEM_PER_BLOCK


@pytest.mark.parametrize("name", ["exist_feasibility",
                                  "catalog_feasibility"])
def test_join_tiles_match_the_kernel_sources(name):
    """join_plan picks among the register tiles the kernel is built for:
    the KtTiles list of its source."""
    src = (kernels.CSRC / f"{name}.cu").read_text()
    built = re.search(r"using \w+Tiles =\s*KtTiles<(.*?)>;", src, re.S)
    tiles = tuple((int(a), int(b)) for a, b in
                  re.findall(r"KtTile<(\d+), (\d+)>", built.group(1)))
    assert tiles == kernels.JOIN_MICRO_TILES[name]


@pytest.mark.parametrize("table", ["VARIANTS", "FITS_VARIANTS"])
def test_join_ablation_edits_apply_to_the_sources(table):
    """Every source edit of join_ablation.py's variants (K2 / K3, and
    fits_matrix) still finds its text, once, in the kernel sources."""
    import join_ablation
    for variant, edits in getattr(join_ablation, table).items():
        for name, text, _ in edits:
            count = (kernels.CSRC / name).read_text().count(text)
            assert count == 1, (variant, name, text, count)


@pytest.mark.parametrize("name", kernels.KERNELS)
def test_launch_arguments_match_the_c_signatures(name):
    """The prepared arguments of every kernel (launcher, wrappers) are one
    fewer than the C entry point's parameters: the stream comes last."""
    _, problem = build_problem(PORT, mini_workload(PORT))
    args, statics = binpack.device_args(
        dataclasses.replace(problem, device_cache=None),
        binpack.ArgPlacer(torch.device("cpu")))
    (group, template, it, group_req, daemon, alloc, template_its, off_zone,
     off_captype, off_avail, zone_values, allow_undef, tol_template, exist,
     exist_avail, tol_exist) = args
    cmb, compat_tm = kernels.combine_compat_plain(template, group,
                                                  allow_undef)
    inputs = {
        "combine_compat": ((template, group, allow_undef), {}),
        "catalog_feasibility": (
            (cmb, compat_tm, it, group_req, daemon, alloc, template_its,
             off_zone, off_captype, off_avail, zone_values, tol_template),
            dict(zone_key=statics["zone_key"],
                 captype_key=statics["captype_key"])),
        "exist_feasibility": ((group, group_req, exist, exist_avail,
                               tol_exist), {}),
        "row_splice": (([exist_avail.clone()],
                        (torch.zeros(16, dtype=torch.uint8), [0], [16]), 0),
                       {}),
        "fits_matrix": ((group_req, exist_avail), {}),
        "offering_compat": ((group.mask, statics["zone_key"],
                             statics["captype_key"], off_zone, off_captype,
                             off_avail), {}),
    }
    a, kw = inputs[name]
    _, launch_args, _ = kernels._PREPARE[name](*a, **kw)
    assert len(launch_args) + 1 == len(kernels._ARGTYPES[name])
