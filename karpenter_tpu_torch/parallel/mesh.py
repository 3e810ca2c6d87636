"""Mesh-sharded execution of the feasibility precompute on torch devices.

The solve's device work (ops/binpack.py precompute_kernel: K1
combine_compat, K2 catalog_feasibility, K3 exist_feasibility) is an outer
product over (pod groups x templates x instance types x zones): every axis
is embarrassingly shardable. It is mapped over a 2-D grid of slots, the
``Mesh``:

- ``pods_groups`` axis — data parallelism over pod equivalence classes (the
  workload dimension; 50k pods collapse to O(100) groups but adversarial
  batches can be group-heavy, e.g. a million pods over thousands of
  deployments);
- ``catalog`` axis — model parallelism over the instance-type catalog (2k-4k
  instance types at the north-star scales).

Each slot has an id and a ``torch.device``. Slot (r, c) launches K1 over
group block r x every template and K2 over group block r x catalog block c
on its own device; K3 runs over group block r x every existing node once per
row (the node side is replicated along the catalog axis, as the reference
shards ``exist_ok``/``exist_cap`` by pods_groups only). Every slot is
launched before any is fetched, then each slot's packed outputs come back in
one device-to-host copy and the padded global arrays are assembled on the
host. The kernels have no contractions over sharded axes, so the slots never
talk to each other. Both axes pad to power-of-two PER-SHARD stacks, so
group/catalog count wobble stays within a bucket.

The catalog side is uploaded once per column block to each slot's device
and cached on the catalog encoding's device cache; the existing-node side is
uploaded once per distinct device, and a sharded ProblemState's dirty row
spans are spliced into the resident buffers in place by the ``row_splice``
kernel (ops/kernels.py). A mesh may list one device several times: its slots
then share that device's resident copies (the CPU tests build an 8-slot mesh
over the CPU this way, and one card can host an 8-slot mesh the same way).

A mesh may also span processes: after ``init_multihost`` joins a fleet
(``torch.distributed`` over gloo), ``make_solver_mesh`` gathers every
process's device list once and gives each slot the index of the process
that owns it. Every process holds the same problem, as every reference
scheduler replica sees the same apiserver, so each one uploads and launches
only its own slots; ``sharded_precompute`` then gathers the slots' host
results over gloo (CPU tensors: gloo's CUDA collectives are not relied on),
and ``sharded_precompute_local`` keeps only this process's rows.

Reference analog: none — the Go scheduler is single-threaded per solve
(scheduler.go:207-265); sharding the feasibility precompute is
the device-native scale-out replacing the reference's pre-filter/truncate/
timeout coping strategies (SURVEY.md §5 long-context note).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import binpack
from ..ops import encode as enc
from ..ops import feasibility as feas
from ..ops import kernels

PODS_GROUPS_AXIS = "pods_groups"
CATALOG_AXIS = "catalog"

# per-shard pow2 floors: small enough that toy problems stay cheap, large
# enough that real group/catalog counts land in few distinct buckets
_GROUP_SHARD_MIN = 8
_CATALOG_SHARD_MIN = 64


@dataclasses.dataclass(frozen=True)
class Slot:
    """One cell of a solver mesh: its id (distinct within the mesh, the key
    of its per-device breaker), the torch device it launches on, and the
    index of the process that owns it (``device`` names a device of that
    process)."""
    id: int
    device: torch.device
    process_index: int = 0


class Mesh:
    """A (pods_groups, catalog) grid of slots."""

    axis_names = (PODS_GROUPS_AXIS, CATALOG_AXIS)

    def __init__(self, slots: np.ndarray):
        if slots.ndim != 2:
            raise ValueError(f"a solver mesh is 2-D, got {slots.shape}")
        ids = [int(s.id) for s in slots.flat]
        if len(set(ids)) != len(ids):
            raise ValueError(f"slot ids must be distinct: {ids}")
        #: 2-D object array of Slot, named after jax.sharding.Mesh.devices
        self.devices = slots

    @property
    def shape(self) -> Dict[str, int]:
        return {PODS_GROUPS_AXIS: int(self.devices.shape[0]),
                CATALOG_AXIS: int(self.devices.shape[1])}

    def __repr__(self) -> str:
        return (f"Mesh({self.devices.shape[0]}x{self.devices.shape[1]}: "
                + ", ".join(f"{s.id}@{s.device}" for s in self.devices.flat)
                + ")")


def _grid(slots: List[Slot]) -> Mesh:
    """The (pods_groups, catalog) factoring of a slot list: the pods_groups
    axis gets the larger factor (group count dominates at scale)."""
    n = len(slots)
    if n == 0:
        raise ValueError("a solver mesh needs at least one device")
    catalog = 1
    for f in (2, 3):
        if n % f == 0 and n // f > 1:
            catalog = f
            break
    grid = np.empty((n // catalog, catalog), dtype=object)
    for i, s in enumerate(slots):
        grid[i // catalog, i % catalog] = s
    return Mesh(grid)


def _fleet():
    """(this process's index, process count): (0, 1) outside a fleet."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_solver_mesh(n_devices: Optional[int] = None,
                     devices=None) -> Mesh:
    """A (pods_groups, catalog) mesh over ``devices`` (default: every CUDA
    device). ``devices`` may repeat a device: the slots still get distinct
    ids 0..n-1 and share that device. In a fleet joined by
    ``init_multihost`` every process calls this with its own local
    devices, and the mesh spans them all in process order (one gather of
    the device lists); ``n_devices`` keeps the first n of the whole
    list."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass devices=[...] to build a "
                "solver mesh over other devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    local = [str(torch.device(d)) for d in devices]
    _, world = _fleet()
    if world > 1:
        lists: list = [None] * world
        torch.distributed.all_gather_object(lists, local)
    else:
        lists = [local]
    owned = [(proc, torch.device(d))
             for proc, names in enumerate(lists) for d in names]
    if n_devices is not None:
        owned = owned[:n_devices]
    return _grid([Slot(i, d, proc) for i, (proc, d) in enumerate(owned)])


def mesh_cache_key(mesh: Mesh) -> tuple:
    """Slot identity + device placement + grid shape: what the resident
    uploads depend on. Two Mesh OBJECTS over the same slots in the same grid
    are interchangeable, so keying caches on this (not the Mesh) means a
    recreated mesh reuses every upload."""
    return (tuple(int(s.id) for s in mesh.devices.flat),
            tuple(f"{s.process_index}/{s.device}" for s in mesh.devices.flat),
            tuple(int(x) for x in mesh.devices.shape))


def _distinct_devices(slots) -> List[torch.device]:
    """The distinct devices of ``slots`` that this process owns: a process
    uploads to and launches on its own slots only."""
    me, _ = _fleet()
    out: Dict[str, torch.device] = {}
    for s in slots:
        if s.process_index == me:
            out.setdefault(str(s.device), s.device)
    return list(out.values())


def _pad_to(a: np.ndarray, axis: int, size: int, fill=0) -> np.ndarray:
    cur = a.shape[axis]
    if cur >= size:
        return a
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, size - cur)
    return np.pad(a, pad, constant_values=fill)


def _pad_enc(e, axis: int, size: int):
    from ..ops.encode import EncodedRequirements
    return EncodedRequirements(
        mask=_pad_to(e.mask, axis, size),
        defined=_pad_to(e.defined, axis, size),
        complement=_pad_to(e.complement, axis, size),
        exempt=_pad_to(e.exempt, axis, size),
        gt=_pad_to(e.gt, axis, size),
        lt=_pad_to(e.lt, axis, size))


def padded_sizes(G: int, T: int, g_mult: int, t_mult: int) -> Tuple[int, int]:
    """(Gp, Tp): both mesh axes padded to ``mult x pow2`` per-shard stacks.
    Pow2 bucketing (not plain next-multiple) keeps the padded shapes stable
    when group or catalog counts wobble between solves — the same contract
    the single-device path gets from the ProblemState's group-axis
    bucket."""
    Gp = g_mult * enc.pow2_bucket(-(-G // g_mult), _GROUP_SHARD_MIN)
    Tp = t_mult * enc.pow2_bucket(-(-T // t_mult), _CATALOG_SHARD_MIN)
    return Gp, Tp


def pad_problem(p: binpack.PackProblem, g_mult: int, t_mult: int,
                pad_catalog: bool = True
                ) -> Tuple[binpack.PackProblem, int, int]:
    """Pad the group-major and catalog axes up to pow2 per-shard stacks for
    the mesh grid. Padded groups have empty masks (never compatible); padded
    instance types are excluded via template_its=False / off_available=False.
    ``pad_catalog=False`` skips the catalog-side copies — the caller only
    does that when the padded catalog upload is already cached (device_args
    never reads the host catalog arrays on a cache hit). Returns (padded,
    G, T) with the original sizes for un-padding results.

    The existing-node side is NOT padded: it is replicated across the
    mesh, exactly as every reference scheduler replica holds the full
    cluster state."""
    G = p.group_req.shape[0]
    T = p.it_alloc.shape[0]
    Gp, Tp = padded_sizes(G, T, g_mult, t_mult)
    if Gp == G and Tp == T:
        return p, G, T
    fields = dict(
        group_enc=_pad_enc(p.group_enc, 0, Gp),
        group_req=_pad_to(p.group_req, 0, Gp),
        group_count=_pad_to(p.group_count, 0, Gp),
        tol_template=_pad_to(p.tol_template, 0, Gp),
        template_its=_pad_to(p.template_its, 1, Tp),
        tol_exist=(_pad_to(p.tol_exist, 0, Gp)
                   if p.tol_exist is not None else None),
        min_its=(_pad_to(p.min_its, 1, Gp)
                 if p.min_its is not None else None))
    if pad_catalog and Tp > T:
        fields.update(
            it_enc=_pad_enc(p.it_enc, 0, Tp),
            it_alloc=_pad_to(p.it_alloc, 0, Tp),
            it_capacity=_pad_to(p.it_capacity, 0, Tp),
            it_price=_pad_to(p.it_price, 0, Tp, fill=np.inf),
            off_zone=_pad_to(p.off_zone, 0, Tp, fill=-1),
            off_captype=_pad_to(p.off_captype, 0, Tp, fill=-1),
            off_available=_pad_to(p.off_available, 0, Tp),
            off_price=(_pad_to(p.off_price, 0, Tp, fill=np.inf)
                       if p.off_price is not None else None))
    return dataclasses.replace(p, **fields), G, T


def _to(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload one host leaf (uint32 masks travel as their int32 bits)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def _enc_to(e: feas.Enc, device: torch.device, rows=slice(None)) -> feas.Enc:
    return feas.Enc(*(_to(x[rows], device) for x in e))


class _MeshPlacer(binpack.ArgPlacer):
    """device_args placement for a mesh dispatch: group-side arrays stay
    host numpy (each slot uploads its own row block), the catalog side is
    uploaded once per column block to each slot's device and cached under a
    mesh-identity slot, and the existing-node side is uploaded once per
    distinct device; in a mesh across processes, to this process's own
    slots' devices only."""

    def __init__(self, mesh: Mesh, Tp: int):
        self.mesh = mesh
        self.Tp = Tp
        # Tp in the namespace: the cached upload's shapes depend on it, and
        # two catalog paddings must never collide in one slot
        self.cache_ns = ("mesh", mesh_cache_key(mesh), Tp)

    def enc(self, e) -> feas.Enc:
        return feas.host_enc(e)

    def i32(self, a):
        return np.clip(a, -binpack.INT32_MAX - 1,
                       binpack.INT32_MAX).astype(np.int32)

    def array(self, a):
        return np.asarray(a)

    def put_it_side(self, it_side):
        """7 leaves, each a dict (column block, device) -> tensor: the
        catalog leaves hold rows [c*Tb, (c+1)*Tb) of the padded catalog;
        zone_values and allow_undefined are whole on every device."""
        (it_enc, it_alloc, off_zone, off_captype, off_available,
         zone_values, allow_undefined) = it_side
        t = self.mesh.shape[CATALOG_AXIS]
        Tb = self.Tp // t
        out = tuple({} for _ in range(7))
        for c in range(t):
            rows = slice(c * Tb, (c + 1) * Tb)
            for dev in _distinct_devices(self.mesh.devices[:, c]):
                key = (c, str(dev))
                out[0][key] = _enc_to(it_enc, dev, rows)
                out[1][key] = _to(it_alloc[rows], dev)
                out[2][key] = _to(off_zone[rows], dev)
                out[3][key] = _to(off_captype[rows], dev)
                out[4][key] = _to(off_available[rows], dev)
                out[5][key] = _to(zone_values, dev)
                out[6][key] = _to(allow_undefined, dev)
        return out

    def put_exist_side(self, exist, exist_avail, p=None):
        """(device -> Enc, device -> avail): one resident copy per distinct
        device of the mesh."""
        devices = _distinct_devices(self.mesh.devices.flat)
        host_leaves = tuple(exist) + (exist_avail,)
        tokens = getattr(p, "exist_shard_tokens", None) \
            if p is not None else None
        cache = getattr(p, "device_cache", None) if p is not None else None
        N = int(exist_avail.shape[0])
        if (not tokens or len(tokens) < 2 or cache is None
                or N % len(tokens) != 0):
            return self._split({str(d): tuple(_to(x, d) for x in host_leaves)
                                for d in devices})
        # delta upload: the sharded ProblemState carved the exist stack into
        # contiguous per-shard row blocks (encode.shard_spans) with one
        # content token each. Only blocks whose token changed cross the
        # host->device boundary: dirty spans are SPLICED into the resident
        # full device buffers by the row_splice kernel; clean spans never
        # move. This only runs on a full-token MISS (all-clean passes reuse
        # the whole cached pair via device_args' exist_side slot).
        from ..metrics.registry import (EXIST_SPLICE_BYTES,
                                        PROBLEM_STATE_SHARD_ROWS)
        spans = enc.shard_spans(N, len(tokens))
        key = ("exist_shards",) + self.cache_ns
        layout = tuple((np.shape(h), np.asarray(h).dtype.str)
                       for h in host_leaves)
        prev = cache.get(key)
        if prev is not None and (len(prev[0]) != len(tokens)
                                 or prev[2] != layout):
            # padded axis or vocab width moved: the resident buffers can't
            # host a row splice — fall through to a whole-stack upload
            prev = None
        if prev is None:
            dev = {str(d): tuple(_to(x, d) for x in host_leaves)
                   for d in devices}
            for s, (start, stop) in enumerate(spans):
                PROBLEM_STATE_SHARD_ROWS.inc(
                    {"shard": str(s), "outcome": "uploaded"},
                    value=stop - start)
            EXIST_SPLICE_BYTES.inc(
                {"outcome": "uploaded"},
                value=float(sum(np.asarray(h).nbytes for h in host_leaves)))
        else:
            # the resident tensors are modified IN PLACE, so the cached
            # exist_side slot (device_args) and this exist_shards slot both
            # hold the spliced buffers afterwards
            dev = prev[1]
            for s, (start, stop) in enumerate(spans):
                if prev[0][s] == tokens[s]:
                    PROBLEM_STATE_SHARD_ROWS.inc(
                        {"shard": str(s), "outcome": "upload_skipped"},
                        value=stop - start)
                    EXIST_SPLICE_BYTES.inc(
                        {"outcome": "skipped"},
                        value=float(sum(np.asarray(h)[start:stop].nbytes
                                        for h in host_leaves)))
                    continue
                PROBLEM_STATE_SHARD_ROWS.inc(
                    {"shard": str(s), "outcome": "uploaded"},
                    value=stop - start)
                blocks = [np.asarray(h)[start:stop] for h in host_leaves]
                for leaves in dev.values():
                    kernels.row_splice(leaves, blocks, start)
                EXIST_SPLICE_BYTES.inc(
                    {"outcome": "uploaded"},
                    value=float(sum(b.nbytes for b in blocks)))
        cache[key] = (tuple(tokens), dev, layout)
        return self._split(dev)

    @staticmethod
    def _split(dev: dict):
        return ({d: feas.Enc(*leaves[:6]) for d, leaves in dev.items()},
                {d: leaves[6] for d, leaves in dev.items()})

    def device_token(self) -> tuple:
        return ("mesh", mesh_cache_key(self.mesh))

    def it_side_valid(self, p, it_side) -> bool:
        # the slot key embeds (mesh identity, Tp): a hit under a
        # pad_catalog=False fast path sees the UNPADDED problem, so the
        # default shape check would falsely invalidate it
        return True


def is_multiprocess(mesh: Mesh) -> bool:
    """True when the mesh's slots span more than this process."""
    me, _ = _fleet()
    return any(s.process_index != me for s in mesh.devices.flat)


def _sharded_dispatch(p: binpack.PackProblem, mesh: Mesh):
    """Pad to the mesh grid's pow2 per-shard stacks and place the inputs.
    Returns (args, statics, padded, G, T, Tp)."""
    g_mult = mesh.shape[PODS_GROUPS_AXIS]
    t_mult = mesh.shape[CATALOG_AXIS]
    G = p.group_req.shape[0]
    T = p.it_alloc.shape[0]
    _, Tp = padded_sizes(G, T, g_mult, t_mult)
    placer = _MeshPlacer(mesh, Tp)
    # the padded catalog-side copies are only consumed when the mesh upload
    # cache misses; skip them entirely on a hit (they are the bulk of
    # pad_problem's host cost at 2k-4k instance types)
    cache = p.device_cache
    cached = (cache is not None
              and cache.get(("it_side",) + placer.cache_ns) is not None)
    padded, G, T = pad_problem(p, g_mult, t_mult, pad_catalog=not cached)
    # a CUDA error while uploading (or splicing) is a KernelError, which the
    # ladder re-raises instead of re-placing the solve
    with kernels.device_failures(_failure_device(mesh)):
        args, statics = binpack.device_args(padded, placer)
    return args, statics, padded, G, T, Tp


def _failure_device(mesh: Mesh) -> torch.device:
    """The device a CUDA error of this process's share of a mesh dispatch
    is attributed to: its first CUDA device, else its first device."""
    devices = _distinct_devices(mesh.devices.flat)
    cuda = [d for d in devices if d.type == "cuda"]
    return (cuda or devices)[0]


def _slot_layout(M: int, Gb: int, Tb: int, Z: int, N: int, has_exist: bool):
    """(shape, storage dtype, logical) of one slot's packed outputs, in
    precompute_kernel's order."""
    pack_dtype, Wz = kernels.zone_pack_layout(Z)
    Ne = N if has_exist else 1
    return [((M, Gb), np.uint8, "bool"),
            ((Gb, M, Tb, Wz), pack_dtype, "raw"),
            ((Gb, M, Tb), np.int16, "raw"),
            ((Gb, M, Z), np.uint8, "bool"),
            ((Gb, Ne), np.uint8, "bool"),
            ((Gb, Ne), np.int32, "raw")]


def _launch_slots(mesh: Mesh, args, statics, Gp: int, Tp: int):
    """Launch K1 + K2 on every slot this process owns (and K3 once per
    pods_groups row) on the slot's own device, without fetching anything.
    Returns [(r, c, device, packed uint8 outputs on the device)]."""
    group, template, group_req, daemon, template_its = (
        args[0], args[1], args[3], args[4], args[6])
    tol_template, exist, exist_avail, tol_exist = args[12:16]
    # the catalog-side leaves in put_it_side's order, each a dict
    # (column block, device) -> tensor
    it_side = (args[2], args[5]) + args[7:12]
    has_exist = statics["has_exist"]
    g, t = mesh.devices.shape
    Gb, Tb = Gp // g, Tp // t
    kw = dict(zone_key=statics["zone_key"],
              captype_key=statics["captype_key"])
    per_dev: Dict[str, tuple] = {}
    per_row: Dict[Tuple[int, str], tuple] = {}
    launched = []
    me, _ = _fleet()
    for (r, c), slot in np.ndenumerate(mesh.devices):
        if slot.process_index != me:
            continue
        dev = slot.device
        dkey = str(dev)
        rows = slice(r * Gb, (r + 1) * Gb)
        with kernels.device_failures(dev):
            if dkey not in per_dev:
                per_dev[dkey] = (_enc_to(template, dev), _to(daemon, dev))
            tmpl_d, daemon_d = per_dev[dkey]
            if (r, dkey) not in per_row:
                per_row[(r, dkey)] = (
                    _enc_to(group, dev, rows), _to(group_req[rows], dev),
                    _to(tol_template[rows], dev))
            group_d, req_d, tol_t_d = per_row[(r, dkey)]
            (it_d, alloc_d, zone_d, cap_d, avail_d, zvals_d,
             allow_d) = (leaf[(c, dkey)] for leaf in it_side)
            its_d = _to(template_its[:, c * Tb:(c + 1) * Tb], dev)
            with_exist = has_exist and c == 0
            outs = binpack.precompute_kernel(
                group_d, tmpl_d, it_d, req_d, daemon_d, alloc_d, its_d,
                zone_d, cap_d, avail_d, zvals_d, allow_d, tol_t_d,
                exist[dkey] if with_exist else None,
                exist_avail[dkey] if with_exist else None,
                _to(tol_exist[rows], dev) if with_exist else None,
                has_exist=with_exist, **kw)
            launched.append((r, c, dev, binpack._pack_outputs(outs)))
    return launched


def _fetch(launched) -> list:
    """One device-to-host copy per launched slot: [(r, c, host bytes)]."""
    out = []
    for r, c, dev, flat in launched:
        with kernels.device_failures(dev):
            out.append((r, c, flat.cpu().numpy()))
    return out


def _gather_slots(mesh: Mesh, fetched, layout) -> list:
    """Every slot's host bytes on every process of a fleet, through one
    gloo all-gather of CPU tensors: each process sends its own slots' bytes
    joined in grid order, padded to the largest share, and every process
    can split every share because every process holds the same problem
    (``layout(c)`` is a slot's output layout)."""
    def nbytes(c: int) -> int:
        return sum(int(np.prod(shape)) * np.dtype(dt).itemsize
                   for shape, dt, _ in layout(c))
    _, world = _fleet()
    owned: List[list] = [[] for _ in range(world)]
    for (r, c), slot in np.ndenumerate(mesh.devices):
        owned[slot.process_index].append((r, c))
    sizes = [sum(nbytes(c) for _, c in cells) for cells in owned]
    mine = np.concatenate([h for _, _, h in fetched]) if fetched \
        else np.zeros(0, np.uint8)
    buf = torch.zeros(max(sizes), dtype=torch.uint8)
    buf[:mine.size] = torch.from_numpy(mine)
    shares = [torch.empty_like(buf) for _ in range(world)]
    torch.distributed.all_gather(shares, buf)
    out = []
    for cells, share in zip(owned, shares):
        host, off = share.numpy(), 0
        for r, c in cells:
            out.append((r, c, host[off:off + nbytes(c)]))
            off += nbytes(c)
    return out


def _slot_layouts(mesh: Mesh, padded: binpack.PackProblem, Gp: int,
                  Tp: int, has_exist: bool):
    """A slot's output layout by its catalog column (K3's outputs ride
    the first column's slots)."""
    g, t = mesh.devices.shape
    M = padded.daemon_overhead.shape[0]
    Z = padded.zone_values.shape[0]
    N = padded.exist_avail.shape[0] if has_exist else 1
    return lambda c: _slot_layout(M, Gp // g, Tp // t, Z, N,
                                  has_exist and c == 0)


def _assemble(fetched, mesh: Mesh, padded: binpack.PackProblem,
              Gp: int, Tp: int, has_exist: bool):
    """The padded global arrays in precompute_kernel's order from the
    slots' host bytes; the rows of slots not in ``fetched`` stay zero."""
    g, t = mesh.devices.shape
    Gb, Tb = Gp // g, Tp // t
    M = padded.daemon_overhead.shape[0]
    Z = padded.zone_values.shape[0]
    N = padded.exist_avail.shape[0] if has_exist else 1
    pack_dtype, Wz = kernels.zone_pack_layout(Z)
    layout = _slot_layouts(mesh, padded, Gp, Tp, has_exist)
    compat_tm = np.zeros((M, Gp), dtype=bool)
    okz = np.zeros((Gp, M, Tp, Wz), dtype=pack_dtype)
    ppn = np.zeros((Gp, M, Tp), dtype=np.int16)
    zone_adm = np.zeros((Gp, M, Z), dtype=bool)
    exist_ok = np.zeros((Gp, N), dtype=bool)
    exist_cap = np.zeros((Gp, N), dtype=np.int32)
    for r, c, host in fetched:
        parts = binpack._split_packed(host, layout(c))
        rows = slice(r * Gb, (r + 1) * Gb)
        cols = slice(c * Tb, (c + 1) * Tb)
        okz[rows, :, cols] = parts[1]
        ppn[rows, :, cols] = parts[2]
        if c == 0:
            compat_tm[:, rows] = parts[0]
            zone_adm[rows] = parts[3]
            if has_exist:
                exist_ok[rows] = parts[4]
                exist_cap[rows] = parts[5]
    return compat_tm, okz, ppn, zone_adm, exist_ok, exist_cap


def _mesh_shape(mesh: Mesh, statics, padded: binpack.PackProblem, Gp: int,
                Tp: int) -> dict:
    """The padded shapes that pick a sharded launch's plans."""
    shape = binpack.launch_shape(padded, statics["has_exist"])
    shape.update(G=Gp, T=Tp)
    return dict(slots=int(mesh.devices.size), **shape)


def _mesh_stats(mesh: Mesh, statics, padded: binpack.PackProblem,
                Gp: int, Tp: int):
    """The sharded launch's obs.device.DEVICE_TIME entry (kind "mesh",
    the slots' devices), registered at its first launch: operations and
    bytes summed over the slots, and as peak the largest sum of the slots'
    peaks on one device."""
    from ..obs.device import DEVICE_TIME, device_label
    shape = _mesh_shape(mesh, statics, padded, Gp, Tp)
    key = ("mesh", mesh_cache_key(mesh), statics["zone_key"],
           statics["captype_key"], *shape.values())
    st = DEVICE_TIME.get(key)
    if st is not None:
        return st
    g, t = mesh.devices.shape
    ops = accessed = 0
    per_dev: Dict[str, int] = {}
    for (r, c), slot in np.ndenumerate(mesh.devices):
        # K3 runs once a pods_groups row, on its first column's slot
        o, a, peak = binpack.precompute_cost(
            Gp // g, shape["M"], Tp // t, shape["N"] if c == 0 else 0,
            shape["K"], shape["W"], shape["R"], shape["O"], shape["Z"])
        dkey = str(slot.device)
        ops, accessed = ops + o, accessed + a
        per_dev[dkey] = per_dev.get(dkey, 0) + peak
    return DEVICE_TIME.register(
        key, "mesh", shapes=binpack.shape_summary(shape),
        devices=[device_label(s.device) for s in mesh.devices.flat],
        cost=(ops, accessed, max(per_dev.values())))


def _run_sharded(p: binpack.PackProblem, mesh: Mesh, gather: bool = True):
    """Place, launch every slot this process owns, fetch them. Returns
    (raw outputs, padded, G, T). In a fleet, ``gather`` brings every
    process's slots to every process; without it the rows of other
    processes' slots stay zero. With tracing on, the launches get a span of
    their own (device.dispatch), and their host and device time
    (obs.device.LaunchTimer, read after the fetch) are attributed to the
    sharded launch in obs.device.DEVICE_TIME."""
    from ..obs.tracer import TRACER
    args, statics, padded, G, T, Tp = _sharded_dispatch(p, mesh)
    Gp = padded.group_req.shape[0]
    timer = None
    if not TRACER.enabled:
        launched = _launch_slots(mesh, args, statics, Gp, Tp)
    else:
        from ..obs.device import DEVICE_TIME, LaunchTimer
        st = _mesh_stats(mesh, statics, padded, Gp, Tp)
        devices = _distinct_devices(mesh.devices.flat)
        with TRACER.span("device.dispatch", slots=int(mesh.devices.size),
                         executable=st.label):
            timer = LaunchTimer(devices)
            launched = _launch_slots(mesh, args, statics, Gp, Tp)
            dispatch_s = timer.launched()
    has_exist = statics["has_exist"]
    with TRACER.span("device.fetch"):
        fetched = _fetch(launched)
        if timer is not None:
            # the fetch has completed every slot's launches; a CUDA error
            # the events surface is a KernelError, as one at the fetch is
            with kernels.device_failures(_failure_device(mesh)):
                DEVICE_TIME.record(st, dispatch_s, timer.elapsed())
        if gather and is_multiprocess(mesh):
            fetched = _gather_slots(
                mesh, fetched, _slot_layouts(mesh, padded, Gp, Tp, has_exist))
        raw = _assemble(fetched, mesh, padded, Gp, Tp, has_exist)
    return raw, padded, G, T


def sharded_memory_analysis(p: binpack.PackProblem, mesh: Mesh) -> int:
    """Per-device peak bytes (arguments + outputs, summed over the slots a
    device holds) of the sharded precompute of this problem: the memory
    ceiling the mesh exists to lower. Places the inputs as a launch would
    (the mesh's upload cache is filled, nothing is launched) and registers
    the launch's entry in obs.device.DEVICE_TIME, whose per-device
    watermark gauges the live launches feed too."""
    _, statics, padded, _, _, Tp = _sharded_dispatch(p, mesh)
    return _mesh_stats(mesh, statics, padded,
                       padded.group_req.shape[0], Tp).peak_bytes


def _unpad_tensors(raw, padded: binpack.PackProblem, G: int, T: int
                   ) -> binpack.PackTensors:
    compat_tm, it_okz_packed, ppn, zone_adm, exist_ok, exist_cap = raw
    t = binpack.unpack_tensors(compat_tm, it_okz_packed, ppn, zone_adm,
                               exist_ok, exist_cap,
                               padded.zone_values.shape[0])
    return binpack.PackTensors(
        compat_tm=t.compat_tm[:, :G],
        it_ok=t.it_ok[:G, :, :T],
        ppn=t.ppn[:G, :, :T],
        it_ok_z=t.it_ok_z[:G, :, :T],
        zone_adm=t.zone_adm[:G],
        exist_ok=t.exist_ok[:G],
        exist_cap=t.exist_cap[:G])


def sharded_precompute(p: binpack.PackProblem, mesh: Mesh
                       ) -> binpack.PackTensors:
    """precompute() over a mesh: pads to the mesh grid, launches the kernels
    per slot on each slot's device, gathers + un-pads the result. Bit-
    identical to binpack.precompute for any mesh: each output element is
    computed by the same kernel from the same inputs, whichever slot owns
    it. Over a mesh that spans processes every process launches its own
    slots and receives the FULL result (one gloo all-gather of the slots'
    host bytes), so every process reaches the same decisions with no
    leader, as the reference's scheduler replicas converge through the
    shared apiserver."""
    raw, padded, G, T = _run_sharded(p, mesh)
    return _unpad_tensors(raw, padded, G, T)


def sharded_precompute_local(p: binpack.PackProblem, mesh: Mesh
                             ) -> "Tuple[binpack.PackTensors, list]":
    """The sharded precompute with ONLY this process's group rows, for
    callers that post-process per group row: no gather between processes.
    Returns ``(tensors, spans)`` where ``spans`` is local_result_slice()'s
    [start, stop) group-row list; tensor rows outside the spans are zeros
    and must not be read. Every pods_groups row this process holds a slot
    of must be wholly its own (true of make_solver_mesh grids, where a
    process's slots tile whole rows); raises ValueError otherwise rather
    than returning rows with holes."""
    me, _ = _fleet()
    for r in range(mesh.devices.shape[0]):
        row_procs = {s.process_index for s in mesh.devices[r]}
        if me in row_procs and row_procs != {me}:
            raise ValueError(
                f"pods_groups-axis row {r} spans processes "
                f"{sorted(row_procs)}; local fetch needs catalog-"
                "complete rows — use sharded_precompute() (replicated "
                "gather) instead")
    raw, padded, G, T = _run_sharded(p, mesh, gather=False)
    tensors = _unpad_tensors(raw, padded, G, T)
    Gp = padded.group_req.shape[0]
    spans = [(start, min(stop, G))
             for start, stop in local_result_slice(mesh, Gp)
             if start < G]
    return tensors, spans


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   auto: bool = False) -> int:
    """Join a multi-process solver fleet through ``torch.distributed``
    (gloo over TCP), the analog of the reference's NCCL/MPI bootstrap.
    Idempotent; returns the process count.

    Each process contributes its local devices; ``make_solver_mesh()``
    then builds the (pods_groups x catalog) mesh over every process's
    slots, and the sharded precompute launches each slot on its owner.
    The kernels have no cross-shard contractions, so the only traffic is
    the result gather (one all-gather of packed host bytes a solve).

    Parameters default to torch's own environment: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (the coordinator, ``host:port``), ``WORLD_SIZE`` and
    ``RANK``. ``auto=True`` hands the whole bootstrap to torch's
    ``env://``. Call before any other collective; a process that is
    evidently alone (no coordinator, size or rank given, or a size of 1)
    starts no service and gets 1."""
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    bootstrap_available = (auto or coordinator_address is not None
                           or num_processes is not None
                           or process_id is not None)
    if num_processes == 1 or not bootstrap_available:
        return 1  # explicitly (or evidently) one process: no service
    dist = torch.distributed
    if not dist.is_initialized():
        if auto and coordinator_address is None:
            dist.init_process_group("gloo", init_method="env://")
        elif coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError(
                "a solver fleet needs a coordinator address, a process "
                "count and this process's id (arguments, or MASTER_ADDR / "
                "MASTER_PORT, WORLD_SIZE and RANK); got "
                f"{coordinator_address!r}, {num_processes!r}, "
                f"{process_id!r}")
        else:
            dist.init_process_group(
                "gloo", init_method=f"tcp://{coordinator_address}",
                world_size=int(num_processes), rank=int(process_id))
    return dist.get_world_size()


def local_result_slice(mesh: Mesh, n_groups: int,
                       process_index: Optional[int] = None
                       ) -> "list[Tuple[int, int]]":
    """The [start, stop) group-row spans this process computed — multi-host
    callers that shard the DOWNSTREAM packing per host use these to skip
    rows another host owns. Returns a list of contiguous spans: one
    process's pods_groups-axis rows need not be contiguous, and collapsing
    them to a single [min, max) range would overlap other hosts' slices and
    double-pack their groups."""
    if process_index is None:
        process_index, _ = _fleet()
    n_shards = mesh.shape[PODS_GROUPS_AXIS]
    per = math.ceil(n_groups / n_shards)
    local_rows = sorted(
        {idx[0] for idx, dev in np.ndenumerate(mesh.devices)
         if dev.process_index == process_index})
    spans: "list[Tuple[int, int]]" = []
    for row in local_rows:
        start = row * per
        stop = min((row + 1) * per, n_groups)
        if start >= stop:
            continue
        if spans and spans[-1][1] == start:
            spans[-1] = (spans[-1][0], stop)  # merge adjacent rows
        else:
            spans.append((start, stop))
    return spans


# -- device-loss degradation ladder ------------------------------------------
# A device error mid-dispatch would otherwise fail the whole mesh pass and
# trip the GLOBAL solver breaker (host fallback for every subsequent pass
# until cooldown). The ladder instead re-places the solve WITHIN the same
# pass: full mesh -> the largest pow2 carve of surviving slots -> a single
# surviving slot -> (exhausted) the caller's host oracle. Each lost slot
# feeds its OWN SolverCircuitBreaker, keyed on the slot id, so a healthy
# fleet minus one card keeps solving on silicon, and the half-open probe
# re-admits the slot once it answers again. Decision parity across rungs is
# free: sharded_precompute is bit-identical to binpack.precompute for ANY
# mesh (pinned by the parity tests), so every rung yields the same tensors.
#
# One deliberate difference from the JAX package: a kernels.KernelError (a
# failed build, a refused launch, a CUDA error at upload or fetch) re-raises
# out of the ladder, counts against no breaker and never becomes
# DeviceLadderExhausted — the caller would then serve the host oracle, even
# under force_tensor, and hide a failure of the kernels.

#: per-device breaker tuning: a lost card usually stays lost for seconds
#: (preemption, link flap), so a short threshold opens fast and the
#: half-open probe re-admits on the first healthy dispatch
DEVICE_BREAKER_THRESHOLD = int(os.environ.get(
    "KARPENTER_DEVICE_BREAKER_THRESHOLD", "3"))
DEVICE_BREAKER_COOLDOWN = float(os.environ.get(
    "KARPENTER_DEVICE_BREAKER_COOLDOWN", "30"))

_DEVICE_BREAKERS: dict = {}
_CARVE_CACHE: dict = {}


class DeviceLadderExhausted(Exception):
    """Every rung of the device-loss ladder failed this pass. The caller
    (TensorScheduler._solve) serves the host oracle WITHOUT counting the
    global breaker — each lost device already fed its own."""


def device_breaker(device_id: int, now=None):
    """The per-slot SolverCircuitBreaker (process-wide: a slot id outlives
    any one mesh object). publish=False — only the global solver breaker
    owns the circuit-state gauge."""
    from ..provisioning.tensor_scheduler import SolverCircuitBreaker
    b = _DEVICE_BREAKERS.get(int(device_id))
    if b is None:
        b = SolverCircuitBreaker(threshold=DEVICE_BREAKER_THRESHOLD,
                                 cooldown=DEVICE_BREAKER_COOLDOWN, now=now)
        _DEVICE_BREAKERS[int(device_id)] = b
    return b


def reset_device_breakers() -> None:
    """Test/bench isolation: drop every per-device breaker (and the carve
    cache, whose meshes may reference revived devices)."""
    _DEVICE_BREAKERS.clear()
    _CARVE_CACHE.clear()


def _carve_mesh(live) -> Mesh:
    """A mesh over the largest power-of-two prefix of the surviving slots
    (pow2 keeps the padded shard shapes in their buckets; the carve is
    cached by slot identity so a repeated degradation never rebuilds
    it)."""
    n = 1 << (len(live).bit_length() - 1)
    picked = tuple(sorted(live, key=lambda d: int(d.id))[:n])
    key = tuple((int(d.id), str(d.device)) for d in picked)
    m = _CARVE_CACHE.get(key)
    if m is None:
        m = _grid(list(picked))
        _CARVE_CACHE[key] = m
    return m


def resilient_precompute(p: binpack.PackProblem, mesh: Mesh
                         ) -> binpack.PackTensors:
    """sharded_precompute behind the degradation ladder: on a device loss
    the pass re-places itself on the surviving carve (then a single
    survivor) instead of failing. Raises DeviceLadderExhausted only when
    no device is willing to solve, and re-raises a kernels.KernelError."""
    from ..metrics.registry import STATE_AUDIT
    devices = list(mesh.devices.flat)
    down: set = set()
    while True:
        live = [d for d in devices
                if int(d.id) not in down and device_breaker(d.id).allow()]
        probing = [d for d in live
                   if device_breaker(d.id).state != "closed"]
        try:
            if len(live) == len(devices):
                binpack.check_devices([int(d.id) for d in live])
                out = sharded_precompute(p, mesh)
                rung = "mesh"
            elif len(live) >= 1:
                carve = _carve_mesh(live)
                live = list(carve.devices.flat)
                probing = [d for d in live
                           if device_breaker(d.id).state != "closed"]
                binpack.check_devices([int(d.id) for d in live])
                out = sharded_precompute(p, carve)
                rung = "carve" if len(live) > 1 else "single"
            else:
                raise DeviceLadderExhausted(
                    f"all {len(devices)} mesh devices down or "
                    "breaker-open")
        except (DeviceLadderExhausted, kernels.KernelError):
            raise
        except binpack.DeviceLossError as e:
            device_breaker(e.device_id).record_failure()
            down.add(int(e.device_id))
            STATE_AUDIT.inc({"layer": "device", "outcome": "killed"})
            continue
        except Exception:
            # un-attributed dispatch failure: every participant takes the
            # blame and the pass drops a rung. Over-counting is safe — a
            # healthy device's breaker re-closes on the next pass's
            # half-open probe — while under-counting would retry the same
            # dead rung forever.
            for d in live:
                device_breaker(d.id).record_failure()
                down.add(int(d.id))
            STATE_AUDIT.inc({"layer": "device", "outcome": "killed"},
                            len(live))
            if not live:
                raise
            continue
        for d in live:
            device_breaker(d.id).record_success()
        if probing:
            STATE_AUDIT.inc({"layer": "device", "outcome": "readmitted"},
                            len(probing))
        if rung != "mesh":
            STATE_AUDIT.inc({"layer": "device", "outcome": rung})
        return out
