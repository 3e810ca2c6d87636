"""Hand-written CUDA kernels of the feasibility tensors, their loader, their
wrappers and their plain PyTorch versions.

Six kernels (sources in ``csrc/``, built together into one shared library
by one nvcc call for sm_90a at first use and loaded through ctypes):

- ``combine_compat``       (K1): template x group compatibility [M, G] and
  the combined requirement rows [M*G, K, W];
- ``catalog_feasibility``  (K2): the packed zone bitfield [G, M, T, Wz],
  int16 pods-per-node [G, M, T] and zone admission [G, M, Z];
- ``exist_feasibility``    (K3): exist_ok / exist_cap [G, N];
- ``row_splice``           (B3): a dirty row span of the resident
  existing-node buffers, overwritten in place from one staged upload;
- ``fits_matrix``          (B5a): the int32 resource fit [A, B];
- ``offering_compat``      (B5b): "any available offering admitted by the
  zone and capacity-type masks" [B, T].

Each wrapper takes the plain version for tensors on the CPU and launches its
kernel for tensors on a CUDA device, or raises ``KernelError``: there is no
fallback from a failed build or launch. ``LAUNCHES`` counts kernel launches
per wrapper.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import feasibility as feas
from .feasibility import Enc

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
KERNELS = ("combine_compat", "catalog_feasibility", "exist_feasibility",
           "row_splice", "fits_matrix", "offering_compat")

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
# solves run on server threads (the sidecar's gRPC workers; two replicas in
# one process can launch at once), so a count moves under this lock
_LAUNCHES_LOCK = threading.Lock()

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()

_VP = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "combine_compat": [_VP] * 13 + [_I] * 7 + [_VP] * 8,
    "catalog_feasibility": [_VP] * 20 + [_I] * 15 + [_VP] * 4,
    "exist_feasibility": [_VP] * 13 + [_I] * 8 + [_VP] * 3,
    "row_splice": [_VP] * 3 + [_I] + [_VP],
    "fits_matrix": [_VP] * 2 + [_I] * 7 + [_VP] * 2,
    "offering_compat": [_VP] * 4 + [_I] * 7 + [_VP] * 2,
}


class KernelError(RuntimeError):
    """Device work of the kernels failed on a CUDA device: nvcc
    missing or failing, a refused launch, or a CUDA error surfacing while
    the kernels' inputs are uploaded or their outputs fetched. Never
    answered from the CPU: the caller sees it."""


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


@contextlib.contextmanager
def device_failures(device: torch.device):
    """On a CUDA device, any failure inside the block is a KernelError (a
    kernel's fault can surface asynchronously, at the next copy); on the
    CPU, failures pass through unchanged."""
    try:
        yield
    except KernelError:
        raise
    except Exception as e:  # noqa: BLE001 — re-raised as a device failure
        if device.type != "cuda":
            raise
        raise KernelError(f"device work on {device} failed: {e!r}") from e


# --------------------------------------------------------------------------
# build + load
# --------------------------------------------------------------------------

def _nvcc() -> str:
    path = shutil.which("nvcc") or shutil.which("/usr/local/cuda/bin/nvcc")
    if path is None:
        raise KernelError("nvcc not found (PATH or /usr/local/cuda/bin): "
                          "the feasibility kernels cannot be built")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _lib_path() -> Path:
    """The library's path, keyed on the flags and every file of csrc/."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfeasibility-{h.hexdigest()[:16]}.so"


def build() -> bool:
    """Build the kernels' library unless this version of the sources is
    already built; True when this call built it. Raises KernelError with
    nvcc's output when the build fails."""
    out = _lib_path()
    if out.exists():
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                        *map(str, _sources())],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise KernelError(f"nvcc failed (rc={r.returncode}):\n{r.stdout}\n"
                          f"{r.stderr}")
    os.replace(tmp, out)
    return True


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is None:
            build()
            lib = ctypes.CDLL(str(_lib_path()))
            for name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, f"kt_{name}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            for name, n in (("exist", 6), ("catalog", 9)):
                fn = getattr(lib, f"kt_{name}_feasibility_smem")
                fn.argtypes = [_I] * n
                fn.restype = ctypes.c_size_t
            lib.kt_error_string.argtypes = [ctypes.c_int]
            lib.kt_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


# --------------------------------------------------------------------------
# wrapper plumbing
# --------------------------------------------------------------------------

def _on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other
    device — and for a CUDA tensor when no CUDA runtime is present."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"feasibility kernels take CPU or CUDA tensors, "
                         f"not {t.device}")
    if not torch.cuda.is_available():
        raise KernelError("CUDA tensor given but CUDA is not available")
    return True


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> int:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t.data_ptr()


def _check_enc(name: str, e: Enc, rows: int, K: int, W: int, device):
    return [
        _check(f"{name}.mask", e.mask, torch.int32, (rows, K, W), device),
        _check(f"{name}.defined", e.defined, torch.bool, (rows, K), device),
        _check(f"{name}.complement", e.complement, torch.bool, (rows, K),
               device),
        _check(f"{name}.exempt", e.exempt, torch.bool, (rows, K), device),
        _check(f"{name}.gt", e.gt, torch.int32, (rows, K), device),
        _check(f"{name}.lt", e.lt, torch.int32, (rows, K), device),
    ]


def _raise_for(name: str, rc: int) -> None:
    if rc != 0:
        msg = _lib().kt_error_string(rc).decode()
        raise KernelError(f"{name} kernel launch failed: {msg} ({rc})")


def _launch(name: str, device, *args) -> None:
    """Launch on the device's current stream; the C launcher returns
    cudaGetLastError(), so a refused launch (grid, shared memory) raises
    here rather than vanishing."""
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"kt_{name}")(*args, stream)
    _raise_for(name, rc)
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def launcher(name: str, *inputs, **kw):
    """(launch, outputs) for any of the kernels (row_splice on staged rows:
    row_splice_staged's arguments) on CUDA inputs: the wrapper's
    checks and output allocation done once, and a callable that launches
    the kernel on them again with nothing else around it (no checks, no
    allocation, no count in LAUNCHES) — the kernel's own time, for a
    measurement."""
    dev, args, outs = _PREPARE[name](*inputs, **kw)
    fn = getattr(_lib(), f"kt_{name}")

    def launch():
        # the stream current at the call, so a CUDA graph can capture it
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_for(name, fn(*args, stream))
    return launch, outs


# numpy storage dtype of the packed zone words -> the torch dtype of the
# same width (torch's uint16/uint32 lack most kernels on the CPU)
_ZONE_STORAGE = {np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.uint16): torch.int16,
                 np.dtype(np.uint32): torch.int32}


def zone_pack_layout(Z: int):
    """(storage dtype, word count) for the packed zone bitfield — the ONE
    place this is decided: the kernel packs with it and _output_layout
    decodes with it, so they can never drift apart."""
    dtype = np.uint8 if Z <= 8 else (np.uint16 if Z <= 16 else np.uint32)
    return dtype, -(-Z // np.iinfo(dtype).bits)


# --------------------------------------------------------------------------
# the tile plan of the mask join (K2, K3; csrc/feasibility_common.cuh)
# --------------------------------------------------------------------------

#: the register micro-tiles (A-rows x B-rows a thread owns) each join kernel
#: is built for, as its source's KtTiles list holds them: the tiles the
#: launches of chip_smoke.py's paths pick (its join_plans line)
JOIN_MICRO_TILES = {
    "exist_feasibility": ((8, 4), (4, 2), (2, 2), (2, 1), (1, 1)),
    "catalog_feasibility": ((2, 4), (1, 1)),
}
#: a block's threads along the A side and the B side (KT_JOIN_TX, _TY)
JOIN_THREADS_A, JOIN_THREADS_B = 16, 8
#: streaming multiprocessors of an H100 SXM, and the dynamic shared memory
#: one block may opt in to
SM_COUNT = 132
SMEM_PER_BLOCK = 232_448
#: the ring holds every key at once (one wait instead of one per key) when
#: the whole join fits in this much shared memory: at the launch shapes of
#: chip_smoke.py that do, 1-6% faster than the two-stage ring (PERF.md §6)
RESIDENT_SMEM = 64 * 1024


class JoinPlan(NamedTuple):
    ra: int          # A-rows per thread
    rb: int          # B-rows per thread
    stages: int      # ring stages: K (every key resident) or 2
    tile_a: int      # A-rows per block
    tile_b: int      # B-rows per block
    grid_a: int      # blocks along A (at least 1)
    grid_b: int      # blocks along B
    smem: int        # dynamic shared memory per block, bytes


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def join_smem(kind: str, tile_a: int, tile_b: int, K: int, W: int,
              stages: int, *, R: int, O: int = 0, Wz: int = 0,
              Z: int = 0) -> int:
    """Dynamic shared memory of one block, as the kernels lay it out
    (kt_join_layout, then the kernel's own staging)."""
    row_chunks = (-(-W // 4)) | 1
    groups = -(-K // 32)
    join = (_align16(stages * (tile_a + tile_b) * row_chunks * 16)
            + _align16(K * tile_a * 8) + _align16(K * tile_b * 8)
            + 2 * _align16(K * tile_a) + 2 * _align16(K * tile_b)
            + _align16(groups * tile_a * 8) + _align16(groups * tile_b * 8)
            + _align16(groups * 4))
    if kind == "exist_feasibility":
        return (join + tile_b * R * 8 + (tile_a + tile_b) * R * 4
                + tile_b * tile_a)
    if kind == "catalog_feasibility":
        return (join + tile_b * R * 8
                + 4 * (tile_a * (R + 2 * O + O * Wz)
                       + tile_b * (2 * R + 2 * W + Wz) + Z)
                + tile_a * O + tile_b * tile_a + tile_b)
    raise ValueError(f"no join kernel named {kind!r}")


def _join_cost(ra: int, rb: int) -> float:
    """SM clocks per pair and 4 mask words: the larger of the LOP3 rate
    (4 * ra * rb ANDs per thread at 2 warp instructions a clock) and the
    16-byte shared loads (ra + rb per thread, 4 clocks a warp each)."""
    return max(2 * ra * rb, 4 * (ra + rb)) / (ra * rb)


def join_plan(kind: str, rows_a: int, rows_b: int, K: int, W: int, *,
              R: int, O: int = 0, Wz: int = 0, Z: int = 0) -> JoinPlan:
    """The micro-tile, ring depth and grid of one K2 / K3 launch over
    rows_a x rows_b pairs (A: types or nodes, B: combined rows or groups).
    Among the kernel's micro-tiles whose block fits in shared memory, and
    that give every SM a block where any does, the one with the least
    estimated time: the blocks one SM runs in turn times a block's pairs
    times _join_cost. At every launch shape of chip_smoke.py's paths that
    is the fastest tile built (join_ablation.py plans, PERF.md §6). No fit
    at all leaves the smallest tile, whose launch the card then refuses."""
    def plan(ra, rb):
        ta, tb = JOIN_THREADS_A * ra, JOIN_THREADS_B * rb
        stages = K
        if (K > 2 and join_smem(kind, ta, tb, K, W, K, R=R, O=O, Wz=Wz, Z=Z)
                > RESIDENT_SMEM):
            stages = 2
        return JoinPlan(ra, rb, stages, ta, tb, max(1, -(-rows_a // ta)),
                        -(-rows_b // tb),
                        join_smem(kind, ta, tb, K, W, stages, R=R, O=O,
                                  Wz=Wz, Z=Z))

    if kind not in JOIN_MICRO_TILES:
        raise ValueError(f"no join kernel named {kind!r}")
    plans = [plan(ra, rb) for ra, rb in JOIN_MICRO_TILES[kind]]
    fits = [p for p in plans if p.smem <= SMEM_PER_BLOCK]
    if not fits:
        return plans[-1]
    full = [p for p in fits if p.grid_a * p.grid_b >= SM_COUNT]

    def cost(p):
        blocks = p.grid_a * p.grid_b
        return (-(-blocks // SM_COUNT) * p.tile_a * p.tile_b
                * _join_cost(p.ra, p.rb),
                blocks * p.tile_a * p.tile_b, -p.tile_a * p.tile_b)
    return min(full or fits, key=cost)


# --------------------------------------------------------------------------
# K1 combine_compat
# --------------------------------------------------------------------------

class CombinePlan(NamedTuple):
    vec: int         # mask words a load / store moves: 4 (16 bytes) or 1
    lanes: int       # lanes of a warp that share one key (a power of two)
    units: int       # loads of vec words a lane makes per key
    threads: int     # threads a block (a multiple of 32)
    slots: int       # keys a block takes at once: threads // lanes
    rounds: int      # passes of a block over the keys
    grid_g: int      # blocks along g
    grid_m: int      # blocks along m


def combine_plan(M: int, G: int, K: int, W: int, *,
                 aligned: bool = True) -> CombinePlan:
    """The geometry of one K1 launch over M x G pairs of K keys of W words
    (csrc/combine_compat.cu), one pair a block. A key's words go to a
    power-of-two group of lanes of one warp, enough for one load each up to
    32 lanes (16-byte loads when ``aligned`` (every row starts 16-byte
    aligned) and W % 4 == 0, words otherwise); a block holds every key of
    its pair, or 1,024 threads' worth at a time."""
    vec = 4 if aligned and W % 4 == 0 else 1
    units = W // vec
    lanes = min(32, 1 << max(0, units - 1).bit_length())
    threads = min(1024, -(-max(K, 1) * lanes // 32) * 32)
    slots = threads // lanes
    return CombinePlan(vec, lanes, -(-units // lanes), threads, slots,
                       -(-K // slots), G, M)


def combine_compat_plain(template: Enc, group: Enc,
                         allow_undefined: torch.Tensor
                         ) -> Tuple[Enc, torch.Tensor]:
    """(cmb [M*G, ...] m-major, compat_tm [M, G])."""
    M = template.mask.shape[0]
    G = group.mask.shape[0]
    compat_tm = feas.compatible_matrix(template, group, allow_undefined)
    cmb = feas.combine(Enc(*(x[:, None] for x in template)),
                       Enc(*(x[None, :] for x in group)))      # [M, G, K, ...]
    return (Enc(*(x.reshape((M * G,) + x.shape[2:]).contiguous()
                  for x in cmb)), compat_tm)


def combine_compat(template: Enc, group: Enc, allow_undefined: torch.Tensor
                   ) -> Tuple[Enc, torch.Tensor]:
    if not _on_cuda(template.mask):
        return combine_compat_plain(template, group, allow_undefined)
    dev, args, (cmb, compat_tm) = _combine_compat_args(template, group,
                                                       allow_undefined)
    if args is not None:
        _launch("combine_compat", dev, *args)
    return cmb, compat_tm


def _combine_compat_args(template: Enc, group: Enc,
                         allow_undefined: torch.Tensor):
    """(device, launch arguments or None when there is nothing to launch,
    outputs) of K1 on CUDA inputs."""
    dev = template.mask.device
    M, K, W = template.mask.shape
    G = group.mask.shape[0]
    ptrs = (_check_enc("template", template, M, K, W, dev)
            + _check_enc("group", group, G, K, W, dev)
            + [_check("allow_undefined", allow_undefined, torch.bool, (K,),
                      dev)])
    MG = M * G
    cmb = Enc(mask=torch.empty((MG, K, W), dtype=torch.int32, device=dev),
              defined=torch.empty((MG, K), dtype=torch.bool, device=dev),
              complement=torch.empty((MG, K), dtype=torch.bool, device=dev),
              exempt=torch.empty((MG, K), dtype=torch.bool, device=dev),
              gt=torch.empty((MG, K), dtype=torch.int32, device=dev),
              lt=torch.empty((MG, K), dtype=torch.int32, device=dev))
    compat_tm = torch.empty((M, G), dtype=torch.bool, device=dev)
    args = None
    if MG:
        aligned = all(x.data_ptr() % 16 == 0
                      for x in (template.mask, group.mask, cmb.mask))
        plan = combine_plan(M, G, K, W, aligned=aligned)
        args = (*ptrs, M, G, K, W, plan.vec, plan.lanes, plan.threads,
                *(x.data_ptr() for x in cmb),
                compat_tm.data_ptr())
    return dev, args, (cmb, compat_tm)


# --------------------------------------------------------------------------
# K2 catalog_feasibility
# --------------------------------------------------------------------------

def _pack_zone_bits(it_ok_z: torch.Tensor, Z: int) -> torch.Tensor:
    """[G, M, T, Z] bool -> [G, M, T, Wz] zone words, built in int64 and
    narrowed to the storage dtype's bit pattern at the end."""
    np_dtype, Wz = zone_pack_layout(Z)
    bits = np.iinfo(np_dtype).bits
    G, M, T = it_ok_z.shape[:3]
    padded = torch.zeros((G, M, T, Wz * bits), dtype=torch.int64,
                         device=it_ok_z.device)
    padded[..., :Z] = it_ok_z.to(torch.int64)
    weights = torch.ones((), dtype=torch.int64, device=it_ok_z.device) \
        << torch.arange(bits, dtype=torch.int64, device=it_ok_z.device)
    words = (padded.reshape(G, M, T, Wz, bits) * weights).sum(dim=-1)
    if bits > 8:
        words = torch.where(words >= 2**(bits - 1), words - 2**bits, words)
    return words.to(_ZONE_STORAGE[np.dtype(np_dtype)])


def catalog_feasibility_plain(cmb: Enc, compat_tm: torch.Tensor, it: Enc,
                              group_req, daemon, alloc, template_its,
                              off_zone, off_captype, off_available,
                              zone_values, tol_template, *, zone_key: int,
                              captype_key: int):
    """(it_okz_packed [G,M,T,Wz], ppn int16 [G,M,T], zone_adm [G,M,Z])."""
    M, G = compat_tm.shape
    T = it.mask.shape[0]
    Z = zone_values.shape[0]
    it_compat = feas.intersects_matrix(it, cmb)                # [T, MG]
    it_compat = it_compat.T.reshape(M, G, T).permute(1, 0, 2)  # [G, M, T]
    zone_adm = feas.value_bit_ok(cmb.mask[:, zone_key, :],
                                 zone_values[None, :])[:, 0, :]  # [MG, Z]
    cap_bit_ok = feas.value_bit_ok_clamped(cmb.mask[:, captype_key, :],
                                           off_captype)        # [MG, T, O]
    zmatch = off_zone[None, :, :, None] == zone_values[None, None, None, :]
    off_ok_z = torch.any(off_available[None, :, :, None] & zmatch
                         & cap_bit_ok[:, :, :, None], dim=2)   # [MG, T, Z]
    off_ok_z = off_ok_z & zone_adm[:, None, :]
    ppn = feas.pods_per_node(alloc, daemon, group_req)         # [G, M, T]
    ok_base = (it_compat
               & template_its[None, :, :]
               & tol_template[:, :, None]
               & compat_tm.T[:, :, None]
               & (ppn >= 1))
    it_ok_z = (ok_base[:, :, :, None]
               & off_ok_z.reshape(M, G, T, Z).permute(1, 0, 2, 3))
    return (_pack_zone_bits(it_ok_z, Z),
            ppn.clamp(0, 32767).to(torch.int16),
            zone_adm.reshape(M, G, Z).permute(1, 0, 2).contiguous())


def catalog_feasibility(cmb: Enc, compat_tm: torch.Tensor, it: Enc,
                        group_req, daemon, alloc, template_its, off_zone,
                        off_captype, off_available, zone_values, tol_template,
                        *, zone_key: int, captype_key: int):
    if not _on_cuda(cmb.mask):
        return catalog_feasibility_plain(
            cmb, compat_tm, it, group_req, daemon, alloc, template_its,
            off_zone, off_captype, off_available, zone_values, tol_template,
            zone_key=zone_key, captype_key=captype_key)
    dev, args, outs = _catalog_feasibility_args(
        cmb, compat_tm, it, group_req, daemon, alloc, template_its, off_zone,
        off_captype, off_available, zone_values, tol_template,
        zone_key=zone_key, captype_key=captype_key)
    if args is not None:
        _launch("catalog_feasibility", dev, *args)
    return outs


def _catalog_feasibility_args(cmb: Enc, compat_tm, it: Enc, group_req, daemon,
                              alloc, template_its, off_zone, off_captype,
                              off_available, zone_values, tol_template, *,
                              zone_key: int, captype_key: int):
    """(device, launch arguments or None, outputs) of K2 on CUDA inputs."""
    dev = cmb.mask.device
    M, G = compat_tm.shape
    MG, K, W = cmb.mask.shape
    T = it.mask.shape[0]
    R = group_req.shape[1]
    O = off_zone.shape[1]
    Z = zone_values.shape[0]
    c = _check_enc("cmb", cmb, MG, K, W, dev)
    i = _check_enc("it", it, T, K, W, dev)
    ptrs = [c[0], c[1], c[3], c[4], c[5],
            _check("compat_tm", compat_tm, torch.bool, (M, G), dev),
            i[0], i[1], i[3], i[4], i[5],
            _check("group_req", group_req, torch.int32, (G, R), dev),
            _check("daemon", daemon, torch.int32, (M, R), dev),
            _check("alloc", alloc, torch.int32, (T, R), dev),
            _check("template_its", template_its, torch.bool, (M, T), dev),
            _check("off_zone", off_zone, torch.int32, (T, O), dev),
            _check("off_captype", off_captype, torch.int32, (T, O), dev),
            _check("off_available", off_available, torch.bool, (T, O), dev),
            _check("zone_values", zone_values, torch.int32, (Z,), dev),
            _check("tol_template", tol_template, torch.bool, (G, M), dev)]
    np_dtype, Wz = zone_pack_layout(Z)
    okz = torch.empty((G, M, T, Wz), dtype=_ZONE_STORAGE[np.dtype(np_dtype)],
                      device=dev)
    ppn = torch.empty((G, M, T), dtype=torch.int16, device=dev)
    zone_adm = torch.empty((G, M, Z), dtype=torch.bool, device=dev)
    args = None
    if MG:
        plan = join_plan("catalog_feasibility", T, MG, K, W, R=R, O=O, Wz=Wz,
                         Z=Z)
        args = (*ptrs, G, M, T, K, W, R, O, Z, zone_key, captype_key,
                np.iinfo(np_dtype).bits, Wz, plan.ra, plan.rb, plan.stages,
                okz.data_ptr(), ppn.data_ptr(), zone_adm.data_ptr())
    return dev, args, (okz, ppn, zone_adm)


# --------------------------------------------------------------------------
# K3 exist_feasibility
# --------------------------------------------------------------------------

INT32_MAX = 2**31 - 1


def exist_feasibility_plain(group: Enc, group_req, exist: Enc, exist_avail,
                            tol_exist):
    """(exist_ok bool [G, N], exist_cap int32 [G, N])."""
    no_undefined = torch.zeros(group.mask.shape[1], dtype=torch.bool,
                               device=group.mask.device)
    exist_ok = feas.compatible_matrix(exist, group, no_undefined).T & tol_exist
    req = group_req[:, None, :]
    per = torch.where(req > 0,
                      torch.div(exist_avail[None, :, :], req.clamp_min(1),
                                rounding_mode="floor"),
                      INT32_MAX)
    exist_cap = per.amin(dim=-1).clamp(0, INT32_MAX).to(torch.int32)
    return exist_ok & (exist_cap >= 1), exist_cap


def exist_feasibility(group: Enc, group_req, exist: Enc, exist_avail,
                      tol_exist):
    if not _on_cuda(group.mask):
        return exist_feasibility_plain(group, group_req, exist, exist_avail,
                                       tol_exist)
    dev, args, outs = _exist_feasibility_args(group, group_req, exist,
                                              exist_avail, tol_exist)
    if args is not None:
        _launch("exist_feasibility", dev, *args)
    return outs


def _exist_feasibility_args(group: Enc, group_req, exist: Enc, exist_avail,
                            tol_exist):
    """(device, launch arguments or None, outputs) of K3 on CUDA inputs."""
    dev = group.mask.device
    G, K, W = group.mask.shape
    N = exist.mask.shape[0]
    R = group_req.shape[1]
    g = _check_enc("group", group, G, K, W, dev)
    e = _check_enc("exist", exist, N, K, W, dev)
    ptrs = [g[0], g[1], g[3], g[4], g[5],
            _check("group_req", group_req, torch.int32, (G, R), dev),
            e[0], e[1], e[3], e[4], e[5],
            _check("exist_avail", exist_avail, torch.int32, (N, R), dev),
            _check("tol_exist", tol_exist, torch.bool, (G, N), dev)]
    exist_ok = torch.empty((G, N), dtype=torch.bool, device=dev)
    exist_cap = torch.empty((G, N), dtype=torch.int32, device=dev)
    args = None
    if G and N:
        plan = join_plan("exist_feasibility", N, G, K, W, R=R)
        args = (*ptrs, G, N, K, W, R, plan.ra, plan.rb, plan.stages,
                exist_ok.data_ptr(), exist_cap.data_ptr())
    return dev, args, (exist_ok, exist_cap)


# --------------------------------------------------------------------------
# B3 row_splice
# --------------------------------------------------------------------------

#: most leaves one launch splices (the kernel's table size)
ROW_SPLICE_MAX_LEAVES = 16
#: staging offsets are rounded up to this, so a leaf's source agrees with an
#: aligned destination modulo 16 and the kernel takes its vector path
_STAGE_ALIGN = 16


def _host_block(block, buf: torch.Tensor) -> torch.Tensor:
    """A CPU tensor of ``buf``'s dtype over the rows of ``block`` (a numpy
    array or a CPU tensor; uint32 masks are read as their int32 bits)."""
    if isinstance(block, np.ndarray):
        block = np.ascontiguousarray(block)
        if block.dtype == np.uint32:
            block = block.view(np.int32)
        block = torch.from_numpy(block)
    if block.device.type != "cpu":
        raise ValueError(f"row_splice: block on {block.device}, expected "
                         "host memory")
    if block.dtype != buf.dtype:
        raise ValueError(f"row_splice: block dtype {block.dtype}, buffer "
                         f"dtype {buf.dtype}")
    if tuple(block.shape[1:]) != tuple(buf.shape[1:]):
        raise ValueError(f"row_splice: block rows {tuple(block.shape[1:])}, "
                         f"buffer rows {tuple(buf.shape[1:])}")
    return block.contiguous()


def row_splice_plain(bufs, blocks, start: int) -> None:
    """``buf[start:start + rows].copy_(block)`` for each leaf, in place."""
    for buf, block in zip(bufs, blocks):
        buf[start:start + block.shape[0]].copy_(block)


def row_splice(bufs, blocks, start: int) -> None:
    """Overwrite rows [start, start + rows) of every resident tensor in
    ``bufs`` with the matching host block, in place. On the CPU that is
    the plain version; on CUDA the blocks are written back to back into one
    pinned staging buffer, copied to the device with one non-blocking copy
    and spliced by one kernel launch."""
    bufs = list(bufs)
    if len(bufs) != len(blocks):
        raise ValueError(f"row_splice: {len(bufs)} buffers, "
                         f"{len(blocks)} blocks")
    if not bufs:
        return
    host = [_host_block(b, buf) for buf, b in zip(bufs, blocks)]
    rows = host[0].shape[0]
    dev = bufs[0].device
    for buf, h in zip(bufs, host):
        if buf.device != dev:
            raise ValueError(f"row_splice: buffers on {buf.device} and {dev}")
        if not buf.is_contiguous():
            raise ValueError("row_splice: buffer not contiguous")
        if h.shape[0] != rows or start < 0 or start + rows > buf.shape[0]:
            raise ValueError(f"row_splice: rows [{start}, {start + h.shape[0]})"
                             f" outside a buffer of {buf.shape[0]}")
    if not _on_cuda(bufs[0]):
        row_splice_plain(bufs, host, start)
        return
    if len(bufs) > ROW_SPLICE_MAX_LEAVES:
        raise ValueError(f"row_splice: {len(bufs)} leaves, at most "
                         f"{ROW_SPLICE_MAX_LEAVES}")
    if rows == 0:
        return
    row_splice_staged(bufs, stage_rows(host, dev), start)


def stage_rows(host, device: torch.device):
    """The host blocks written back to back (each at a 16-byte offset) into
    one pinned buffer and copied to ``device`` with one non-blocking copy:
    (device staging tensor, byte offsets, byte counts)."""
    offsets, nbytes = [], []
    total = 0
    for h in host:
        total = -(-total // _STAGE_ALIGN) * _STAGE_ALIGN
        offsets.append(total)
        nbytes.append(h.numel() * h.element_size())
        total += nbytes[-1]
    staging = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    stage_np = staging.numpy()
    for h, off in zip(host, offsets):
        raw = h.numpy().reshape(-1).view(np.uint8)
        stage_np[off:off + raw.size] = raw
    with torch.cuda.device(device):
        dstage = torch.empty(total, dtype=torch.uint8, device=device)
        dstage.copy_(staging, non_blocking=True)
    return dstage, offsets, nbytes


def row_splice_staged(bufs, staged, start: int) -> None:
    """One launch of the kernel: the staged leaves (stage_rows) into rows
    from ``start`` of every buffer, in place."""
    dev, args, _ = _row_splice_args(bufs, staged, start)
    _launch("row_splice", dev, *args)


def _row_splice_args(bufs, staged, start: int):
    """(device, launch arguments, no outputs) of one row_splice launch."""
    dstage, offsets, nbytes = staged
    n = len(bufs)
    dst = (ctypes.c_ulonglong * n)(*(
        buf.data_ptr() + start * buf.stride(0) * buf.element_size()
        for buf in bufs))
    src = (ctypes.c_ulonglong * n)(*(dstage.data_ptr() + off
                                     for off in offsets))
    count = (ctypes.c_ulonglong * n)(*nbytes)
    return dstage.device, (dst, src, count, n), None


# --------------------------------------------------------------------------
# B5a fits_matrix, B5b offering_compat
# --------------------------------------------------------------------------

#: threads of a fits_matrix block (FM_THREADS) and the shared memory its
#: staged request tile may take
FITS_THREADS = 256
FITS_SMEM_BYTES = 16 * 1024
#: the store widths (outputs a thread writes with one store), widest first
FITS_WIDTHS = (16, 8, 4)


class FitsPlan(NamedTuple):
    width: int       # outputs a thread stores at once: 16, 8, 4 or 1
    vec4: bool       # R == 4 and avail 16-byte aligned: an avail row is an int4
    tile_b: int      # request rows a block stages (a multiple of width)
    rows: int        # avail rows a block takes
    grid_a: int      # blocks along A
    grid_b: int      # blocks along B (request tiles)
    smem: int        # the staged tile's shared memory, bytes


def fits_plan(A: int, B: int, R: int, *, aligned: bool = True) -> FitsPlan:
    """The geometry of one fits_matrix launch over A avail rows x B request
    rows of R resources (csrc/fits_matrix.cu). The store width is the
    widest of FITS_WIDTHS that divides B (every output row starts at byte
    a * B), else 1; a block stages as many runs of `width` request rows as
    FITS_SMEM_BYTES holds (each run's words padded as the kernel pads them)
    and takes enough avail rows for one run a thread."""
    width = next((v for v in FITS_WIDTHS if B % v == 0), 1)
    vec4 = R == 4 and aligned
    stride = width * R + (4 if vec4 else 1)
    runs = max(1, min(B // width, FITS_SMEM_BYTES // (4 * stride)))
    rows = max(1, FITS_THREADS // runs)
    return FitsPlan(width, vec4, runs * width, rows, -(-A // rows),
                    -(-B // (runs * width)), runs * stride * 4)


def fits_matrix(requests: torch.Tensor, available: torch.Tensor
                ) -> torch.Tensor:
    """requests int32 [B, R] x available int32 [A, R] -> bool [A, B]: all
    over r of (req <= 0 or req <= avail)."""
    if not _on_cuda(requests):
        return feas.fits_matrix(requests, available)
    dev, args, out = _fits_matrix_args(requests, available)
    if args is not None:
        _launch("fits_matrix", dev, *args)
    return out


def _fits_matrix_args(requests: torch.Tensor, available: torch.Tensor):
    """(device, launch arguments or None, output) of B5a on CUDA inputs.
    The kernel indexes in 32 bits: the output and both inputs must hold
    fewer than 2^31 elements."""
    dev = requests.device
    B, R = requests.shape
    A = available.shape[0]
    if max(A * B, A * R, B * R) > INT32_MAX:
        raise ValueError(f"fits_matrix: [{B}, {R}] requests x [{A}, {R}] "
                         f"avail exceed 32-bit indexing")
    ptrs = [_check("requests", requests, torch.int32, (B, R), dev),
            _check("available", available, torch.int32, (A, R), dev)]
    out = torch.empty((A, B), dtype=torch.bool, device=dev)
    args = None
    if A and B:
        plan = fits_plan(A, B, R, aligned=available.data_ptr() % 16 == 0)
        args = (*ptrs, A, B, R, plan.width, int(plan.vec4), plan.tile_b,
                plan.rows, out.data_ptr())
    return dev, args, out


def offering_compat(mask_b: torch.Tensor, zone_key: int, captype_key: int,
                    off_zone: torch.Tensor, off_captype: torch.Tensor,
                    off_available: torch.Tensor) -> torch.Tensor:
    """mask_b int32 [B, K, W] (uint32 bits), off_zone / off_captype int32
    [T, O] value indices (-1 == unconstrained), off_available bool [T, O]
    -> bool [B, T]: does any available offering of type t have a zone and
    a capacity type that row b admits."""
    if not _on_cuda(mask_b):
        return feas.offering_compat(mask_b, zone_key, captype_key, off_zone,
                                     off_captype, off_available)
    dev, args, out = _offering_compat_args(mask_b, zone_key, captype_key,
                                           off_zone, off_captype,
                                           off_available)
    if args is not None:
        _launch("offering_compat", dev, *args)
    return out


def _offering_compat_args(mask_b: torch.Tensor, zone_key: int,
                          captype_key: int, off_zone: torch.Tensor,
                          off_captype: torch.Tensor,
                          off_available: torch.Tensor):
    """(device, launch arguments or None, output) of B5b on CUDA inputs.
    The kernel indexes in 32 bits: every tensor must hold fewer than 2^31
    elements."""
    dev = mask_b.device
    B, K, W = mask_b.shape
    T, O = off_zone.shape
    for name, key in (("zone_key", zone_key), ("captype_key", captype_key)):
        if not 0 <= key < K:
            raise ValueError(f"offering_compat: {name} {key} outside "
                             f"[0, {K})")
    if max(B * K * W, B * T, T * O) > INT32_MAX:
        raise ValueError(f"offering_compat: [{B}, {K}, {W}] masks x [{T}, "
                         f"{O}] offerings exceed 32-bit indexing")
    ptrs = [_check("mask_b", mask_b, torch.int32, (B, K, W), dev),
            _check("off_zone", off_zone, torch.int32, (T, O), dev),
            _check("off_captype", off_captype, torch.int32, (T, O), dev),
            _check("off_available", off_available, torch.bool, (T, O), dev)]
    out = torch.empty((B, T), dtype=torch.bool, device=dev)
    args = ((*ptrs, B, T, K, W, O, zone_key, captype_key, out.data_ptr())
            if B and T else None)
    return dev, args, out


# --------------------------------------------------------------------------
# the work of one launch: the integer operations its bound counts and the
# bytes it must move (each input read once, each output written once). The
# device-time tracker (obs/device.py) and chip_smoke.py's bounds read these
# --------------------------------------------------------------------------

class Cost(NamedTuple):
    ops: int         # 32-bit integer operations (acc |= x & y counts two)
    bytes: int       # inputs read once + outputs written once


def enc_bytes(rows: int, K: int, W: int) -> int:
    """Bytes of an Enc of ``rows`` rows: the int32 mask words, three bool
    flags and the two int32 bounds of each key."""
    return rows * K * (4 * W + 3 + 8)


def zone_words_bytes(Z: int) -> int:
    """Bytes of one packed zone bitfield (zone_pack_layout)."""
    dtype, words = zone_pack_layout(Z)
    return np.dtype(dtype).itemsize * words


def precompute_arg_bytes(G: int = 0, M: int = 0, T: int = 0, N: int = 0,
                         K: int = 0, W: int = 0, R: int = 0, O: int = 0,
                         Z: int = 0) -> Dict[str, int]:
    """Bytes of each device argument of a precompute launch
    (binpack.device_args), by name: G groups, M templates, T types and N
    nodes over K keys of W words, R resources, O offerings a type, Z
    zones. The kernels' costs below and binpack.precompute_cost's peak
    sum the entries they read."""
    enc = enc_bytes
    return dict(group=enc(G, K, W), template=enc(M, K, W), it=enc(T, K, W),
                group_req=4 * G * R, daemon=4 * M * R, alloc=4 * T * R,
                template_its=M * T, offerings=9 * T * O, zone_values=4 * Z,
                allow_undefined=K, tol_template=G * M, exist=enc(N, K, W),
                exist_avail=4 * N * R, tol_exist=G * N)


def combine_compat_outputs(M: int, G: int, K: int, W: int) -> int:
    """Bytes of K1's outputs: the combined rows and compat_tm."""
    return enc_bytes(M * G, K, W) + M * G


def combine_compat_cost(M: int, G: int, K: int, W: int) -> Cost:
    """K1: an AND and an OR per mask word of a pair, about twelve
    operations per key of a pair for its flags, bounds and verdict."""
    MG = M * G
    a = precompute_arg_bytes(G=G, M=M, K=K, W=W)
    return Cost(2 * MG * K * W + 12 * MG * K,
                a["template"] + a["group"] + a["allow_undefined"]
                + combine_compat_outputs(M, G, K, W))


def catalog_feasibility_outputs(M: int, G: int, T: int, Z: int) -> int:
    """Bytes of K2's outputs: it_okz packed, ppn (int16), zone_adm."""
    return G * M * T * (zone_words_bytes(Z) + 2) + G * M * Z


def catalog_feasibility_cost(M: int, G: int, T: int, K: int, W: int, R: int,
                             O: int, Z: int) -> Cost:
    """K2: per (pair, type) the mask join, the per-key verdicts, the
    resource fit and the offerings x zones admission. It reads K1's
    outputs and the catalog and pair-side arguments."""
    a = precompute_arg_bytes(G=G, M=M, T=T, K=K, W=W, R=R, O=O, Z=Z)
    inputs = combine_compat_outputs(M, G, K, W) + sum(a[k] for k in (
        "it", "group_req", "daemon", "alloc", "template_its", "offerings",
        "zone_values", "tol_template"))
    return Cost(M * G * T * (2 * K * W + 8 * K + 3 * R + 2 * O * Z),
                inputs + catalog_feasibility_outputs(M, G, T, Z))


def exist_feasibility_outputs(G: int, N: int) -> int:
    """Bytes of K3's outputs: exist_ok (bool) and exist_cap (int32)."""
    return 5 * G * N


def exist_feasibility_cost(G: int, N: int, K: int, W: int, R: int) -> Cost:
    """K3: per (group, node) the mask join, the per-key verdicts and the
    capacity's floor divisions."""
    a = precompute_arg_bytes(G=G, N=N, K=K, W=W, R=R)
    inputs = sum(a[k] for k in ("group", "group_req", "exist", "exist_avail",
                                "tol_exist"))
    return Cost(G * N * (2 * K * W + 9 * K + 2 * R),
                inputs + exist_feasibility_outputs(G, N))


def fits_matrix_cost(A: int, B: int, R: int) -> Cost:
    """B5a: a compare and an AND per (avail row, request row, resource);
    the "request of zero or less" test depends on (request row, resource)
    alone: a compare and a select per request word."""
    return Cost(2 * A * B * R + 2 * B * R, 4 * B * R + 4 * A * R + A * B)


def offering_compat_cost(B: int, T: int, W: int, O: int,
                         examined: int) -> Cost:
    """B5b: about twelve operations per offering the early-exit reference
    examines (``examined``, data-dependent); of the masks only the zone and
    capacity-type rows are read."""
    return Cost(12 * examined, 2 * B * W * 4 + 9 * T * O + B * T)


def row_splice_cost(nbytes: int) -> Cost:
    """B3: the staged rows read once and written once."""
    return Cost(0, 2 * nbytes)


_PREPARE = {"combine_compat": _combine_compat_args,
            "catalog_feasibility": _catalog_feasibility_args,
            "exist_feasibility": _exist_feasibility_args,
            "row_splice": _row_splice_args,
            "fits_matrix": _fits_matrix_args,
            "offering_compat": _offering_compat_args}
