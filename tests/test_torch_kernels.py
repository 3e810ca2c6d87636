"""ops/kernels.py loader and wrappers, on the CPU: the build is keyed on the
sources and raises with nvcc's own output when nvcc is missing or fails,
and CPU tensors take the plain versions without counting launches."""

import dataclasses
import shutil
import stat

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.ops import binpack, kernels

from karpenter_tpu_torch.provisioning.tensor_scheduler import (
    SolverCircuitBreaker)

from test_torch_support import PORT, build_problem, mini_workload, scheduler

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
