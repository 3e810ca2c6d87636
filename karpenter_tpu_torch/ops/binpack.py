"""Grouped first-fit-decreasing bin-pack solver with GPU-resident feasibility.

Replaces the reference's per-pod greedy loop (scheduler.go:207-315, O(pods x
instance-types) with full refiltering per pod) by:

1. ``precompute`` — every pairwise feasibility quantity the greedy needs,
   over all (group, template, instance type, zone, existing node)
   combinations at once, computed on the device by the hand-written kernels
   of ops/kernels.py (combine_compat -> catalog_feasibility, plus
   exist_feasibility when the cluster has nodes) and fetched in ONE
   device-to-host copy: requirement compatibility (bitpacked mask algebra),
   offering availability per zone, int32 pods-per-node. This is the
   O(G*M*T*Z + G*N) hot math.
2. ``pack`` — a host-side greedy over *groups* (dozens, not tens of thousands)
   in first-fit-decreasing order, making the same decisions the reference
   makes per pod but in closed form per group: zone water-fill for topology
   spreads, per-node caps for hostname spread/anti-affinity, cohort tracking
   for cross-group node mixing, subtractMax limit pessimism per opened node.
   Cohort state lives in a columnar ``CohortSet`` so the in-flight-node scan
   (eligibility, prospective zone commits, capacity) is batched array math
   per group instead of per-cohort Python.

Entry points take an explicit ``device`` (default ``cuda``); without CUDA
they raise unless the caller asks for ``"cpu"``, where the kernels' plain
PyTorch versions run instead.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..api import labels as api_labels
from . import encode as enc
from . import feasibility as feas
from . import kernels
from .encode import EncodedRequirements
from .kernels import zone_pack_layout

INT32_MAX = 2**31 - 1


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default) and
    not available — the port never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the feasibility kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


# --------------------------------------------------------------------------
# numpy mini-algebra over EncodedRequirements rows (host-side cohort updates;
# same rules as feasibility.py kernels, scalar-shaped)
# --------------------------------------------------------------------------

def np_compatible(a: EncodedRequirements, b: EncodedRequirements,
                  allow_undefined: np.ndarray) -> bool:
    gt = np.maximum(a.gt, b.gt)
    lt = np.minimum(a.lt, b.lt)
    crossed = (gt > -2**31) & (lt < 2**31 - 1) & (gt >= lt)
    nonempty = np.any(a.mask & b.mask, axis=-1) & ~crossed
    checked = a.defined & b.defined
    exempt = a.exempt & b.exempt
    bad = checked & ~nonempty & ~exempt
    undef_bad = b.defined & ~a.defined & ~allow_undefined & ~b.exempt
    return not np.any(bad | undef_bad)


def np_combine(a: EncodedRequirements, b: EncodedRequirements) -> EncodedRequirements:
    gt = np.maximum(a.gt, b.gt)
    lt = np.minimum(a.lt, b.lt)
    crossed = (gt > -2**31) & (lt < 2**31 - 1) & (gt >= lt)
    mask = np.where(crossed[..., None], np.uint32(0), a.mask & b.mask)
    complement = a.complement & b.complement & ~crossed
    empty = ~np.any(mask != 0, axis=-1)
    exempt = np.where(complement, a.exempt | b.exempt, empty)
    gt = np.where(complement, gt, -2**31)
    lt = np.where(complement, lt, 2**31 - 1)
    return EncodedRequirements(mask=mask, defined=a.defined | b.defined,
                               complement=complement, exempt=exempt, gt=gt, lt=lt)


# --------------------------------------------------------------------------
# problem + device precompute
# --------------------------------------------------------------------------

@dataclass
class PackProblem:
    """Fully encoded solve input. Build via provisioning.tensor_scheduler."""
    vocab: enc.Vocab
    # groups
    group_enc: EncodedRequirements        # stacked [G, ...]
    group_req: np.ndarray                 # int64 [G, R] scaled requests
    group_count: np.ndarray               # int64 [G]
    # templates
    template_enc: EncodedRequirements     # [M, ...]
    daemon_overhead: np.ndarray           # int64 [M, R]
    tol_template: np.ndarray              # bool [G, M] pod tolerates template taints
    # instance types (union catalog)
    it_enc: EncodedRequirements           # [T, ...]
    it_alloc: np.ndarray                  # int64 [T, R]
    it_capacity: np.ndarray               # int64 [T, R]
    it_price: np.ndarray                  # float32 [T] cheapest available offering
    template_its: np.ndarray              # bool [M, T]
    off_zone: np.ndarray                  # int32 [T, O] zone value idx or -1
    off_captype: np.ndarray               # int32 [T, O]
    off_available: np.ndarray             # bool [T, O]
    # zones
    zone_key: int                         # key index of topology zone
    captype_key: int
    zone_values: np.ndarray               # int32 [Z] value indices
    # existing nodes (may be empty)
    exist_enc: Optional[EncodedRequirements] = None  # [N, ...]
    exist_avail: Optional[np.ndarray] = None         # int64 [N, R]
    exist_zone: Optional[np.ndarray] = None          # int32 [N] zone idx or -1
    tol_exist: Optional[np.ndarray] = None           # bool [G, N]
    allow_undefined: Optional[np.ndarray] = None     # bool [K] well-known keys
    off_price: Optional[np.ndarray] = None           # float32 [T, O] (inf absent)
    # int32 [M, G]: minValues floor on DISTINCT INSTANCE TYPES for the
    # combined (template, group) requirement set, 0 = none. The packer caps
    # every fill so at least this many types survive each claim's it_set —
    # the tensor twin of the per-add SatisfiesMinValues gate
    # (scheduler.py:159-162, types.go:178-212). minValues on other keys
    # stays on the host path (build_problem falls back).
    min_its: Optional[np.ndarray] = None
    # shared mutable slot (from the catalog-encoding cache): device-resident
    # copies of the catalog-side arrays, keyed by device, so repeat solves
    # against the same instance-type catalog skip the host->device upload
    device_cache: Optional[dict] = None
    # content token of the existing-node tensors. When set, device_args
    # caches the exist-side device upload in device_cache under this token
    # plus the device's identity, so passes against an unchanged node set
    # skip the [N, ...] host->device upload exactly like the catalog side.
    # None (the default) preserves per-call uploads.
    exist_token: Optional[tuple] = None
    # per-shard content tokens of the existing-node rows (sharded
    # ProblemState over the mesh pods_groups axis): tuple of S tokens, one
    # per contiguous Np/S row span (encode.shard_spans). When set, the mesh
    # placer's put_exist_side re-uploads ONLY the spans whose token changed
    # (a node revision bump splices its shard's rows, not all N). None
    # keeps the whole-side exist_token cache behaviour.
    exist_shard_tokens: Optional[tuple] = None


@dataclass
class PackTensors:
    """Fetched results of the device precompute."""
    compat_tm: np.ndarray      # bool [M, G] template x group requirement compat
    it_ok: np.ndarray          # bool [G, M, T]
    ppn: np.ndarray            # int32 [G, M, T] pods-per-fresh-node
    it_ok_z: np.ndarray        # bool [G, M, T, Z]
    zone_adm: np.ndarray       # bool [G, M, Z] combined reqs admit zone
    exist_ok: np.ndarray       # bool [G, N]
    exist_cap: np.ndarray      # int32 [G, N]


def _encoded_from(obj) -> Optional[EncodedRequirements]:
    if obj is None:
        return None
    return EncodedRequirements(**{
        f.name: np.array(getattr(obj, f.name))
        for f in dataclasses.fields(EncodedRequirements)})


def _vocab_from(obj) -> enc.Vocab:
    v = enc.Vocab()
    v.keys = list(obj.keys)
    v.key_idx = dict(obj.key_idx)
    v.values = [list(vals) for vals in obj.values]
    v.value_idx = [dict(vi) for vi in obj.value_idx]
    v.resources = list(obj.resources)
    v.resource_idx = dict(obj.resource_idx)
    v._frozen = bool(getattr(obj, "_frozen", False))
    v._domain_bucket = getattr(obj, "_domain_bucket", None)
    return v


def problem_from_numpy(obj) -> PackProblem:
    """Copy any object carrying PackProblem's fields as numpy arrays (duck-
    typed: an encoded problem from another implementation) into this
    package's PackProblem, vocabulary included. Device caches are never
    carried over."""
    kw = {}
    for f in dataclasses.fields(PackProblem):
        val = getattr(obj, f.name, None)
        if f.name == "vocab":
            val = _vocab_from(val)
        elif f.name.endswith("_enc"):
            val = _encoded_from(val)
        elif f.name == "device_cache":
            val = None
        elif isinstance(val, np.ndarray):
            val = val.copy()
        kw[f.name] = val
    return PackProblem(**kw)


def precompute_kernel(group, template, it, group_req, daemon, alloc,
                      template_its, off_zone, off_captype, off_available,
                      zone_values, allow_undefined, tol_template,
                      exist, exist_avail, tol_exist,
                      *, zone_key: int, captype_key: int, has_exist: bool):
    """The six precompute outputs, in the order _output_layout decodes:
    (compat_tm, it_okz_packed, ppn16, zone_adm, exist_ok, exist_cap). Every
    piece of math runs in a kernel wrapper (plain versions on the CPU)."""
    G = group.mask.shape[0]
    cmb, compat_tm = kernels.combine_compat(template, group, allow_undefined)
    it_okz_packed, ppn16, zone_adm = kernels.catalog_feasibility(
        cmb, compat_tm, it, group_req, daemon, alloc, template_its,
        off_zone, off_captype, off_available, zone_values, tol_template,
        zone_key=zone_key, captype_key=captype_key)
    if has_exist:
        exist_ok, exist_cap = kernels.exist_feasibility(
            group, group_req, exist, exist_avail, tol_exist)
    else:
        dev = group.mask.device
        exist_ok = torch.zeros((G, 1), dtype=torch.bool, device=dev)
        exist_cap = torch.zeros((G, 1), dtype=torch.int32, device=dev)
    return (compat_tm, it_okz_packed, ppn16, zone_adm, exist_ok, exist_cap)


def _pack_outputs(outs) -> torch.Tensor:
    """Flatten the six outputs into ONE uint8 buffer on the device, so the
    fetch is a single device-to-host copy. The byte offsets of
    _output_layout are not aligned (compat_tm is M*G bytes), so every
    output is written typed by its kernel and only its bytes are joined."""
    return torch.cat([o.reshape(-1).view(torch.uint8) for o in outs])


def _split_packed(flat: np.ndarray, shapes_dtypes):
    """Host-side inverse of _pack_outputs."""
    out = []
    off = 0
    for shape, dtype, logical in shapes_dtypes:
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        chunk = flat[off:off + n].view(dtype).reshape(shape)
        off += n
        out.append(chunk.astype(bool) if logical == "bool" else chunk)
    assert off == flat.size, \
        f"packed output layout desync: consumed {off} of {flat.size} bytes"
    return out


class ArgPlacer:
    """Placement policy for device_args uploads onto one device: the
    catalog side is cached in device_cache under a slot named for the
    device, and the exist side under its content token plus the device's
    identity. A mesh placer (parallel/mesh._MeshPlacer) overrides the
    hooks: group-side arrays stay host numpy (each mesh slot uploads its
    own block), the catalog side is uploaded once per column block to each
    slot's device, and the exist side once per distinct device, with dirty
    row spans spliced in place. One device_args serves both paths."""

    def __init__(self, device: torch.device):
        self.device = device
        #: appended to device_cache slot names so uploads to different
        #: devices of the same catalog never collide
        self.cache_ns: tuple = (str(device),)

    def enc(self, e) -> feas.Enc:
        return feas.to_device(e, self.device)

    def i32(self, a) -> torch.Tensor:
        return torch.from_numpy(np.clip(a, -INT32_MAX - 1, INT32_MAX)
                                .astype(np.int32)).to(self.device)

    def array(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def put_it_side(self, it_side):
        """Final placement for the 7 catalog-side leaves (already through
        enc/i32/array). The single-device placer leaves them as they are."""
        return it_side

    def put_exist_side(self, exist, exist_avail, p=None):
        """``p`` is the (padded) problem: a mesh placer reads its
        exist_shard_tokens to re-upload only dirty per-shard row blocks."""
        return exist, exist_avail

    def device_token(self) -> tuple:
        """Placement identity folded into the cached exist-upload's token:
        the content token (PackProblem.exist_token) says WHAT the rows are,
        this says WHERE they live."""
        return ("dev", self.device.type, self.device.index or 0)

    def it_side_valid(self, p: "PackProblem", it_side) -> bool:
        """Guards the cached catalog upload against a differently-shaped
        problem reusing the slot (the output layout is sized from the
        problem)."""
        return tuple(it_side[1].shape) == p.it_alloc.shape


def device_args(p: PackProblem, placer: ArgPlacer):
    """Build the positional-array / static-kwarg split for precompute_kernel."""
    from ..obs.tracer import TRACER
    with TRACER.span("device.upload"):
        return _device_args(p, placer)


def _device_args(p: PackProblem, placer: ArgPlacer):
    has_exist = p.exist_enc is not None and p.exist_enc.mask.shape[0] > 0
    dev = placer.enc
    i32 = placer.i32
    arr = placer.array
    if has_exist:
        # tol_exist is group-dependent and uploads fresh every call; the
        # node-only (exist_enc, exist_avail) pair is cacheable per
        # exist_token (see PackProblem.exist_token)
        ex_key = ("exist_side",) + placer.cache_ns
        ex_tok = (p.exist_token, placer.device_token()) \
            if p.exist_token is not None else None
        ex_slot = (p.device_cache.get(ex_key)
                   if p.device_cache is not None and ex_tok is not None
                   else None)
        if ex_slot is not None and ex_slot[0] == ex_tok:
            exist, exist_avail = ex_slot[1]
        else:
            exist, exist_avail = placer.put_exist_side(
                dev(p.exist_enc), i32(p.exist_avail), p=p)
            if p.device_cache is not None and ex_tok is not None:
                p.device_cache[ex_key] = (ex_tok, (exist, exist_avail))
        tol_exist = arr(p.tol_exist)
    else:
        exist = exist_avail = tol_exist = None
    cache = p.device_cache
    it_key = ("it_side",) + placer.cache_ns
    it_side = cache.get(it_key) if cache is not None else None
    if it_side is not None and not placer.it_side_valid(p, it_side):
        it_side = None
    if it_side is None:
        it_side = placer.put_it_side(
            (dev(p.it_enc), i32(p.it_alloc), arr(p.off_zone),
             arr(p.off_captype), arr(p.off_available),
             arr(p.zone_values), arr(p.allow_undefined)))
        if cache is not None:
            cache[it_key] = it_side
    (it_enc_d, it_alloc_d, off_zone_d, off_captype_d, off_avail_d,
     zone_values_d, allow_undef_d) = it_side
    args = (dev(p.group_enc), dev(p.template_enc), it_enc_d,
            i32(p.group_req), i32(p.daemon_overhead),
            it_alloc_d, arr(p.template_its),
            off_zone_d, off_captype_d,
            off_avail_d, zone_values_d,
            allow_undef_d, arr(p.tol_template),
            exist, exist_avail, tol_exist)
    statics = dict(zone_key=p.zone_key, captype_key=p.captype_key,
                   has_exist=has_exist)
    return args, statics


def _output_layout(p: PackProblem, has_exist: bool):
    """(shape, storage-dtype, logical) per kernel output, matching
    precompute_kernel's return order."""
    G = p.group_req.shape[0]
    M = p.daemon_overhead.shape[0]
    T = p.it_alloc.shape[0]
    Z = p.zone_values.shape[0]
    N = p.exist_avail.shape[0] if has_exist else 1
    pack_dtype, Wz = zone_pack_layout(Z)
    return [
        ((M, G), np.uint8, "bool"),            # compat_tm
        ((G, M, T, Wz), pack_dtype, "raw"),    # it_okz_packed
        ((G, M, T), np.int16, "raw"),          # ppn
        ((G, M, Z), np.uint8, "bool"),         # zone_adm
        ((G, N), np.uint8, "bool"),            # exist_ok
        ((G, N), np.int32, "raw"),             # exist_cap
    ]


def launch_shape(p: PackProblem, has_exist: bool) -> dict:
    """The shapes that pick one precompute launch's plans: G, M, T, N (0
    without existing nodes), K, W, R, O, Z."""
    G, K, W = p.group_enc.mask.shape
    return dict(G=G, M=p.template_enc.mask.shape[0],
                T=p.it_enc.mask.shape[0],
                N=p.exist_avail.shape[0] if has_exist else 0,
                K=K, W=W, R=p.group_req.shape[1], O=p.off_zone.shape[1],
                Z=p.zone_values.shape[0])


def precompute_cost(G: int, M: int, T: int, N: int, K: int, W: int, R: int,
                    O: int, Z: int) -> "Tuple[int, int, int]":
    """(operations, bytes accessed, peak bytes) of one precompute launch:
    K1 + K2, and K3 when N > 0 (kernels' per-kernel costs). The peak is the
    launch's device arguments, every output it allocates (K1's combined
    rows included) and the packed copy the fetch reads."""
    costs = [kernels.combine_compat_cost(M, G, K, W),
             kernels.catalog_feasibility_cost(M, G, T, K, W, R, O, Z)]
    if N:
        costs.append(kernels.exist_feasibility_cost(G, N, K, W, R))
    args = sum(kernels.precompute_arg_bytes(G, M, T, N, K, W, R, O,
                                            Z).values())
    # without nodes K3 is not launched; two [G, 1] zero outputs stand in
    k2_k3 = (kernels.catalog_feasibility_outputs(M, G, T, Z)
             + kernels.exist_feasibility_outputs(G, max(N, 1)))
    fetched = M * G + k2_k3
    peak = args + kernels.combine_compat_outputs(M, G, K, W) + k2_k3 + fetched
    return (sum(c.ops for c in costs), sum(c.bytes for c in costs), peak)


def shape_summary(shape: dict) -> str:
    return ",".join(f"{k}{v}" for k, v in shape.items())


def _run_precompute(p: PackProblem, args, statics, device: torch.device
                    ) -> np.ndarray:
    """Launch the precompute and fetch its packed outputs. With tracing on,
    the launches (device.dispatch) and the wait for the device
    (device.execute) get spans of their own, attributed to the launch
    shape in obs.device.DEVICE_TIME; with it off the fetch's copy absorbs
    the device time, and no event or synchronize is added."""
    from ..obs.tracer import TRACER
    if not TRACER.enabled:
        return _pack_outputs(precompute_kernel(*args, **statics)).cpu().numpy()
    from ..obs.device import DEVICE_TIME, LaunchTimer, device_label
    shape = launch_shape(p, statics["has_exist"])
    key = ("single", device_label(device), statics["zone_key"],
           statics["captype_key"], *shape.values())
    st = DEVICE_TIME.get(key)
    if st is None:
        st = DEVICE_TIME.register(key, "single", shapes=shape_summary(shape),
                                  devices=[key[1]],
                                  cost=precompute_cost(**shape))
    with TRACER.span("device.dispatch", executable=st.label):
        timer = LaunchTimer([device])
        flat = _pack_outputs(precompute_kernel(*args, **statics))
        dispatch_s = timer.launched()
    with TRACER.span("device.execute", executable=st.label):
        device_s = timer.wait()
    DEVICE_TIME.record(st, dispatch_s, device_s)
    return flat.cpu().numpy()


# -- injected device-loss verdicts (utils/chaos.DeviceKiller) ----------------
# A real device loss surfaces as a runtime error mid-dispatch; chaos injects
# the same failure deterministically so a degradation ladder can be driven
# in tests and sim runs.

_DEVICE_CHAOS = None


class DeviceLossError(Exception):
    """A device participating in this dispatch is gone (link drop,
    preempted donor chip, injected kill verdict). Carries the lost
    device's id so the mesh ladder can feed its per-device breaker."""

    def __init__(self, device_id, detail: str = ""):
        super().__init__(f"device {device_id} lost"
                         + (f": {detail}" if detail else ""))
        self.device_id = device_id


def install_device_chaos(killer):
    """Install (or clear, with None) the seeded device-kill verdict source
    consulted before every device dispatch; returns the previous hook so
    callers can restore it."""
    global _DEVICE_CHAOS
    prev = _DEVICE_CHAOS
    _DEVICE_CHAOS = killer
    return prev


def check_devices(device_ids) -> None:
    """Raise DeviceLossError if the installed chaos verdict kills any of
    the devices about to participate in a dispatch. No-op (one global
    read) when no chaos is installed."""
    killer = _DEVICE_CHAOS
    if killer is not None:
        hit = killer.verdict(device_ids)
        if hit is not None:
            raise DeviceLossError(hit, "injected kill verdict")


def precompute(p: PackProblem, device=None) -> PackTensors:
    # deliberately NOT chaos-checked: the single-device precompute is the
    # rung below a device-loss ladder, which assumes this device alive
    from ..obs.tracer import TRACER
    device = resolve_device(device)
    with kernels.device_failures(device):
        args, statics = device_args(p, ArgPlacer(device))
        # single packed fetch: one device-to-host copy for all six outputs
        with TRACER.span("device.fetch"):
            flat = _run_precompute(p, args, statics, device)
    compat_tm, it_okz_packed, ppn, zone_adm, exist_ok, exist_cap = \
        _split_packed(flat, _output_layout(p, statics["has_exist"]))
    return unpack_tensors(compat_tm, it_okz_packed, ppn, zone_adm,
                          exist_ok, exist_cap, p.zone_values.shape[0])


def exist_delta(p: PackProblem, device=None
                ) -> "Tuple[np.ndarray, np.ndarray]":
    """(exist_ok, exist_cap) for this problem, computed by the exist-only
    slice of the precompute — the same kernel precompute launches for its
    existing-node outputs, so the two are bit-identical. A refresh when
    ONLY the existing-node side changed costs O(G*N) instead of the full
    O(G*M*T*Z) precompute."""
    from ..obs.tracer import TRACER
    device = resolve_device(device)
    placer = ArgPlacer(device)
    with TRACER.span("device.exist_delta",
                     nodes=int(p.exist_avail.shape[0])), \
            kernels.device_failures(device):
        exist_ok, exist_cap = kernels.exist_feasibility(
            placer.enc(p.group_enc), placer.i32(p.group_req),
            placer.enc(p.exist_enc), placer.i32(p.exist_avail),
            placer.array(p.tol_exist))
        return exist_ok.cpu().numpy(), exist_cap.cpu().numpy()


def unpack_tensors(compat_tm, it_okz_packed, ppn, zone_adm, exist_ok,
                   exist_cap, Z: int) -> PackTensors:
    """Expand the packed zone bitfield [G,M,T,Wz] back into the packer's bool
    views."""
    word_bits = np.iinfo(it_okz_packed.dtype).bits
    bits = (it_okz_packed[..., None] >> np.arange(word_bits).astype(
        it_okz_packed.dtype)) & 1                      # [G,M,T,Wz,word_bits]
    shape = it_okz_packed.shape[:3] + (-1,)
    it_ok_z = bits.astype(bool).reshape(shape)[..., :Z]
    return PackTensors(compat_tm=compat_tm,
                       it_ok=np.any(it_okz_packed != 0, axis=-1),
                       ppn=ppn.astype(np.int32), it_ok_z=it_ok_z,
                       zone_adm=zone_adm, exist_ok=exist_ok,
                       exist_cap=exist_cap)


# --------------------------------------------------------------------------
# host greedy over groups
# --------------------------------------------------------------------------

class CohortSet:
    """Columnar store of in-flight cohorts (a cohort = n identical planned
    nodes: same template, zone restriction, cumulative requests, surviving
    instance-type set). Round 5's per-object ``Cohort`` list forced the
    group packer into a Python ``for cohort in cohorts`` scan per group —
    re-running the requirement-compat, zone-commit and capacity math one
    cohort at a time — which cost the sub-second flagship Solve()
    (BENCH_r05 1.197 s vs r4 0.499 s). Stacking every per-cohort quantity
    row-wise lets ``Packer._fill_cohorts`` evaluate ALL candidate cohorts
    for a group in a handful of vectorized passes with identical placement
    semantics (the parity fuzzer pins them).

    Incremental aggregates maintained per row, AND-folded as groups board
    (order-independent, so equal to the scan the old code re-ran per probe):

    - ``zadm[c, z]``  — every aboard group admits zone z
      (``zone_adm[gp, m, z]`` reduced over the aboard set);
    - ``okz[c, t, w]`` — bitpacked (encode.pack_bits layout) zone-
      feasibility intersection ``AND_gp it_ok_z[gp, m, t, :]``, the
      prospective zone-commit mask of the round-5 fix;
    - ``aboard[c, g]`` — the aboard-group bitset (host-port conflict gate);
    - ``enc_*``       — the accumulated requirement row, stacked so
      requirement compatibility is one batched mask reduction.
    """

    _ROW_FIELDS = ("m", "zone", "n", "fill", "it_set", "requests", "aboard",
                   "zadm", "okz", "enc_mask", "enc_defined", "enc_complement",
                   "enc_exempt", "enc_gt", "enc_lt")

    def __init__(self, p: PackProblem, t: PackTensors, G: int, cap: int = 64):
        self.T = p.it_alloc.shape[0]
        self.R = p.group_req.shape[1]
        self.Z = p.zone_values.shape[0]
        K, W = p.group_enc.mask.shape[1:]
        self.C = 0
        self._cap = cap
        self._t = t
        self.m = np.zeros(cap, np.int32)
        self.zone = np.full(cap, -1, np.int32)          # -1 == zone-free
        self.n = np.zeros(cap, np.int64)
        self.fill = np.zeros(cap, np.int64)             # pods per node
        self.it_set = np.zeros((cap, self.T), bool)
        self.requests = np.zeros((cap, self.R), np.int64)
        self.aboard = np.zeros((cap, G), bool)
        self.zadm = np.zeros((cap, self.Z), bool)
        self.okz = np.zeros((cap, self.T, (self.Z + 7) // 8), np.uint8)
        self.enc_mask = np.zeros((cap, K, W), np.uint32)
        self.enc_defined = np.zeros((cap, K), bool)
        self.enc_complement = np.zeros((cap, K), bool)
        self.enc_exempt = np.zeros((cap, K), bool)
        self.enc_gt = np.zeros((cap, K), np.int64)
        self.enc_lt = np.zeros((cap, K), np.int64)
        self.pods_by_group: List[Dict[int, int]] = []   # per-node fill
        self._okz_rows: Dict[tuple, np.ndarray] = {}

    def _grow(self) -> None:
        self._cap *= 2
        for name in self._ROW_FIELDS:
            a = getattr(self, name)
            out = np.zeros((self._cap,) + a.shape[1:], a.dtype)
            out[:self.C] = a[:self.C]
            setattr(self, name, out)

    def _okz_row(self, g: int, m: int) -> np.ndarray:
        """[T, ceil(Z/8)] bitpacked ``it_ok_z[g, m]`` (memoized: boarding
        the same group repeatedly must not re-pack)."""
        key = (g, m)
        row = self._okz_rows.get(key)
        if row is None:
            row = enc.pack_bits(self._t.it_ok_z[g, m])
            self._okz_rows[key] = row
        return row

    def append(self, g: int, m: int, zone: Optional[int], it_set: np.ndarray,
               requests: np.ndarray, n: int, enc_row: EncodedRequirements,
               fill: int) -> int:
        ci = self.C
        if ci == self._cap:
            self._grow()
        self.m[ci] = m
        self.zone[ci] = -1 if zone is None else zone
        self.n[ci] = n
        self.fill[ci] = fill
        self.it_set[ci] = it_set
        self.requests[ci] = requests
        self.aboard[ci] = False
        self.aboard[ci, g] = True
        self.zadm[ci] = self._t.zone_adm[g, m]
        self.okz[ci] = self._okz_row(g, m)
        self.set_enc(ci, enc_row)
        self.pods_by_group.append({g: fill})
        self.C += 1
        return ci

    def split(self, ci: int, n_new: int) -> int:
        """Copy row ci into a fresh row with node count ``n_new`` (the
        caller shrinks ci's own count): remainder/last-node cohorts inherit
        every aggregate, exactly like the old object copy did."""
        cj = self.C
        if cj == self._cap:
            self._grow()
        for name in self._ROW_FIELDS:
            a = getattr(self, name)
            a[cj] = a[ci]
        self.n[cj] = n_new
        self.pods_by_group.append(dict(self.pods_by_group[ci]))
        self.C += 1
        return cj

    def append_row_from(self, other: "CohortSet", ci: int) -> int:
        """Copy row ``ci`` of ``other`` (built over the same problem,
        tensors and group count) into this set: the sharded pack's merge
        step. Row aggregates copy verbatim — they are order-independent
        AND-folds, so a merged set scans exactly like one that boarded the
        same groups sequentially."""
        cj = self.C
        if cj == self._cap:
            self._grow()
        for name in self._ROW_FIELDS:
            getattr(self, name)[cj] = getattr(other, name)[ci]
        self.pods_by_group.append(dict(other.pods_by_group[ci]))
        self.C += 1
        return cj

    def enc_row(self, ci: int) -> EncodedRequirements:
        """Row VIEWS — callers combine them into fresh arrays (np_combine
        never mutates) and write back via set_enc."""
        return EncodedRequirements(
            mask=self.enc_mask[ci], defined=self.enc_defined[ci],
            complement=self.enc_complement[ci], exempt=self.enc_exempt[ci],
            gt=self.enc_gt[ci], lt=self.enc_lt[ci])

    def set_enc(self, ci: int, e: EncodedRequirements) -> None:
        self.enc_mask[ci] = e.mask
        self.enc_defined[ci] = e.defined
        self.enc_complement[ci] = e.complement
        self.enc_exempt[ci] = e.exempt
        self.enc_gt[ci] = e.gt
        self.enc_lt[ci] = e.lt

    def compatible_rows(self, b: EncodedRequirements,
                        allow_undefined: np.ndarray) -> np.ndarray:
        """[C] bool: np_compatible(row, b) for every cohort row at once —
        the batched twin of the old per-cohort scan check."""
        C = self.C
        gt = np.maximum(self.enc_gt[:C], b.gt)
        lt = np.minimum(self.enc_lt[:C], b.lt)
        crossed = (gt > -2**31) & (lt < 2**31 - 1) & (gt >= lt)
        nonempty = np.any(self.enc_mask[:C] & b.mask, axis=-1) & ~crossed
        checked = self.enc_defined[:C] & b.defined
        exempt = self.enc_exempt[:C] & b.exempt
        bad = checked & ~nonempty & ~exempt
        undef_bad = (b.defined & ~self.enc_defined[:C]
                     & ~allow_undefined & ~b.exempt)
        return ~np.any(bad | undef_bad, axis=-1)


# cap on checkpoints retained in a PackSeed: each holds full copies of the
# cohort arrays + exist_avail, and restored seeds carry their usable prefix
# forward every pass — without a bound a long-lived provisioner would
# accumulate them without limit
MAX_SEED_CHECKPOINTS = 12


@dataclass
class PackCheckpoint:
    """Complete mutable packer state after the first ``pos`` groups of the
    FFD order were packed: the warm-start restore point. Group references
    inside (aboard columns, pods_by_group keys, existing fills, error-log
    rows, g_of_pos) are group INDICES of the pack that recorded it;
    _remap_checkpoint translates them into the next pass's index space."""
    pos: int
    C: int
    rows: dict                      # CohortSet field name -> array copy [:C]
    pods_by_group: list
    existing: dict                  # node idx -> [(g, fill), ...]
    error_log: list                 # [(g, tail_count, msg), ...] in order
    exist_avail: np.ndarray
    limits: list                    # template_limits deep copy
    limit_constrained: bool
    g_of_pos: list                  # group index packed at FFD position p


@dataclass
class PackSeed:
    """One pack's replayable skeleton, stored by the ProblemState across
    passes. Valid for a later pack exactly when that pack's global token
    matches AND a prefix of its FFD-ordered per-group tokens matches —
    the packer is sequentially deterministic over the FFD order, so equal
    inputs up to position P imply byte-equal state at P."""
    global_token: tuple
    ffd_tokens: list                # per-FFD-position (sig, token)
    checkpoints: list               # PackCheckpoints, ascending pos


@dataclass
class WarmStart:
    """Per-solve warm-start context built by the ProblemState: the global
    input token (everything the packer reads that is not per-group), the
    per-group tokens indexed by current group index, and the previous
    pass's seed. After pack() the packer leaves the new seed in
    ``result_seed`` and its restore stats in restored_pos/matched."""
    global_token: tuple
    tokens: list
    seed: Optional[PackSeed] = None
    result_seed: Optional[PackSeed] = None
    restored_pos: int = 0
    matched: int = 0
    # sharded hierarchical pack composition (parallel/mesh.sharded_pack):
    # one PackSeed per round-robin FFD block. Each shard's Packer runs the
    # SAME warm machinery over its block order (the seed's ffd_tokens are
    # that block's per-group tokens), so a shard whose groups kept their
    # tokens AND their block replays its whole pack; a group that moved
    # shards breaks both affected blocks' prefixes from its position on.
    shard_seeds: Optional[list] = None
    result_shard_seeds: Optional[list] = None
    # cross-shard reconcile fold memo (mesh._reconcile), carried across
    # passes by the ProblemState; replaced in place when the fold re-runs
    reconcile_memo: Optional[dict] = None


@dataclass
class PackResult:
    # (template m, zone idx or None, it_set bool [T], [pod,...]) per new node
    nodes: List[tuple] = field(default_factory=list)
    existing: Dict[int, list] = field(default_factory=dict)  # node idx -> pods
    errors: Dict[str, str] = field(default_factory=dict)     # pod uid -> error
    cohorts: Optional[CohortSet] = None
    # a nodepool limit excluded capacity during this pack: WHO gets the
    # scarce budget is order-dependent, so pack errors under limit pressure
    # are not oracle-final (the production scheduler re-solves on the host
    # path instead of trusting them; see TensorScheduler._solve)
    limit_constrained: bool = False


# -- donor-row headroom policy (sharded hierarchical pack) --------------------

# the old fixed bar, kept as the ceiling for dense many-node groups
DONOR_HEADROOM_DENSE = 0.25
DONOR_HEADROOM_MEDIUM = 0.15
DONOR_HEADROOM_SMALL = 0.05


def donor_headroom(group_count: int, shards: int) -> float:
    """Group-size-aware donor bar for the sharded pack's cross-shard
    reconcile (retires the fixed 0.25, ROADMAP item 3): a single-node row
    donates its pods to the merge mini-pack when its best surviving
    instance type still has this much relative headroom over the
    accumulated requests.

    A group of ``group_count`` pods round-robined over ``shards`` blocks
    leaves ~count/shards pods per shard — SMALL groups fragment into
    per-shard tails that are each a large fraction of the whole group, so
    coalescing them wins whole nodes and they donate at a low bar; HUGE
    groups produce dense rows whose tail is one node in hundreds, so only
    a clearly underfilled row is worth the re-pack. Deterministic pure
    function of (group size, shard count): the sharded pack stays
    seed-free and the policy is pinned by a directed vector
    (tests/test_parallel_mesh.py)."""
    if shards <= 1 or group_count <= 0:
        return DONOR_HEADROOM_DENSE
    frag = group_count / shards
    if frag <= 16:
        return DONOR_HEADROOM_SMALL
    if frag <= 128:
        return DONOR_HEADROOM_MEDIUM
    return DONOR_HEADROOM_DENSE


def waterfill(counts: np.ndarray, viable: np.ndarray, admitted: np.ndarray,
              c: int, max_skew: int,
              min_domains: Optional[int] = None,
              zone_names: Optional[np.ndarray] = None,
              min_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Distribute c pods over zones the way the reference's min-count domain
    selection does (topologygroup.go:181-227): each pod goes to the lowest-count
    admitted+viable zone subject to count+1-min <= maxSkew. The global min is
    taken over `min_mask` — the POD's view of the domain universe
    (topologygroup.go:229-250), which can include zones no template reaches
    (e.g. a cluster pod in a zone the pool excludes pins the min there) —
    defaulting to `admitted`. With minDomains set and fewer min_mask domains
    than it, the global min floors to zero (topologygroup.go:240-247), so the
    skew check binds against absolute counts. Returns per-zone allocation
    (pods that can't place anywhere are simply not allocated; caller errors
    them)."""
    counts = counts.astype(np.int64).copy()
    alloc = np.zeros_like(counts)
    remaining = c
    if min_mask is None:
        min_mask = admitted
    floor_zero = (min_domains is not None
                  and int(min_mask.sum()) < min_domains)
    # fast path: every admitted zone viable AND the pod's min universe is
    # exactly the placement set -> sequential min-fill equals a closed-form
    # water-fill (skew never binds when always filling the min; invalid
    # under the minDomains zero floor or when an unreachable domain pins
    # the global min below the fill level)
    if not floor_zero and admitted.any() and (viable | ~admitted).all() \
            and bool((min_mask == admitted).all()):
        idx = np.where(admitted)[0]
        cz = counts[idx]
        # largest level L with sum(max(0, L - cz)) <= remaining
        lo, hi = int(cz.min()), int(cz.max()) + remaining
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if int(np.maximum(0, mid - cz).sum()) <= remaining:
                lo = mid
            else:
                hi = mid - 1
        add = np.maximum(0, lo - cz)
        rem = remaining - int(add.sum())
        at_level = np.where(cz + add == lo)[0]  # lex order == index order
        for pos in at_level[:rem]:
            add[pos] += 1
        alloc[idx] = add
        return alloc
    while remaining > 0:
        if floor_zero:
            m0 = 0
        else:
            m0 = counts[min_mask].min() if min_mask.any() else 0
        eligible = viable & admitted & (counts + 1 - m0 <= max_skew)
        if not eligible.any():
            break
        cand = np.where(eligible)[0]
        # min count, ties by domain NAME — the host oracle's deterministic
        # tie-break (_next_domain_spread iterates sorted(candidates))
        tie = zone_names[cand] if zone_names is not None else cand
        zi = cand[np.lexsort((tie, counts[cand]))[0]]
        alloc[zi] += 1
        counts[zi] += 1
        remaining -= 1
    return alloc


class Packer:
    """Greedy group packer consuming PackTensors."""

    def __init__(self, p: PackProblem, t: PackTensors, groups,
                 template_limits: List[Optional[dict]],
                 limit_resources: List[str],
                 initial_zone_counts: Optional[np.ndarray] = None,
                 exist_order: Optional[List[int]] = None,
                 exist_counts: Optional[np.ndarray] = None,
                 host_match_total: Optional[np.ndarray] = None,
                 vol_group_counts: Optional[list] = None,
                 vol_node_remaining: Optional[list] = None,
                 group_ports: Optional[list] = None,
                 exist_port_block: Optional[np.ndarray] = None,
                 warm: Optional[WarmStart] = None):
        self.p = p
        self.t = t
        self.groups = groups
        self.G = len(groups)
        self.Z = len(p.zone_values)
        self.T = p.it_alloc.shape[0]
        self.M = p.daemon_overhead.shape[0]
        self.template_limits = template_limits  # remaining ResourceList (scaled) or None
        self.limit_resources = limit_resources
        self.zone_counts = (initial_zone_counts.copy() if initial_zone_counts is not None
                            else np.zeros((self.G, self.Z), dtype=np.int64))
        self.exist_order = exist_order if exist_order is not None else (
            list(range(p.exist_avail.shape[0])) if p.exist_avail is not None else [])
        self.exist_avail = (p.exist_avail.copy() if p.exist_avail is not None
                            else np.zeros((0, p.group_req.shape[1]), dtype=np.int64))
        # scheduled cluster pods matching each group's hostname-level
        # selector, per packable existing node [G, N] and in total [G] (the
        # countDomains analog for hostname topologies, topology.go:268-321)
        self.exist_counts = exist_counts
        self.host_match_total = host_match_total
        # CSI attach limits for per-pod (ephemeral) claims, linearized
        # (volumeusage.go:201-208): vol_group_counts[g] = {driver: claims
        # per pod} or None; vol_node_remaining[n] = {driver: remaining
        # slots} for limited drivers only, or None for unlimited nodes.
        # Shared MUTABLE per-node dicts: every group placing on a node
        # draws down the same driver budget.
        self.vol_group_counts = vol_group_counts
        self.vol_node_remaining = vol_node_remaining
        # host-port semantics, tensorized (hostportusage.go:34-90):
        # group_ports[g] = (ip, port, protocol) triples or (); identical
        # specs mean any two pods of a port group conflict -> one pod per
        # node; a precomputed GxG matrix gates cross-group co-location and
        # exist_port_block[G, N] excludes nodes already using the ports
        self.group_ports = group_ports
        self.exist_port_block = exist_port_block
        if group_ports is not None and any(group_ports):
            from ..scheduling.hostports import triples_conflict
            pg = [g for g in range(self.G) if group_ports[g]]
            self._port_conflict = np.zeros((self.G, self.G), dtype=bool)
            for i, gi in enumerate(pg):
                for gj in pg[i:]:
                    if triples_conflict(group_ports[gi], group_ports[gj]):
                        self._port_conflict[gi, gj] = True
                        self._port_conflict[gj, gi] = True
        else:
            self._port_conflict = None
        # domain-name tie-break order for zone selection (host parity)
        self._zone_names = np.array(p.vocab.values[p.zone_key], dtype=object)
        self.result = PackResult()
        self.cohorts = CohortSet(p, t, self.G)
        # per-group nonzero request columns + request-restricted catalog
        # slices, so the per-probe capacity math touches only the resources
        # the group actually requests (hot path: _cohort_caps)
        self._req_nz = [np.nonzero(p.group_req[g])[0] for g in range(self.G)]
        self._req_vals = [p.group_req[g][self._req_nz[g]] for g in range(self.G)]
        # a group whose requirement row defines NO key is compatible with
        # every accumulated cohort requirement set (np_compatible's bad /
        # undef_bad terms both need b.defined) — the common case in large
        # batches, so the whole batched compat pass is skipped for it
        self._g_trivial = ~p.group_enc.defined.any(axis=1)
        # minValues floor on distinct instance types per (template, group):
        # every fill is capped so at least this many types survive the claim
        # (the host oracle refuses per-pod adds that would drop below it,
        # scheduler.py:159-162) — zero-cost when no floor is set
        self._min_its = p.min_its
        self._has_min_its = (p.min_its is not None
                             and bool((p.min_its > 0).any()))
        # warm-start context (ProblemState): restore the previous pass's
        # packer state at the longest clean FFD prefix and re-pack only the
        # suffix. The machinery is disabled (full pack) for any shape whose
        # shared mutable state is not checkpointed: host-port groups,
        # volume attach budgets, and minValues floors — the invalidation
        # matrix rows that conservatively fall back to a full pack.
        self._warm = warm
        self._error_log: List[tuple] = []
        self._alloc_nz_cache: Dict[int, np.ndarray] = {}
        self._adj_nz_cache: Dict[tuple, np.ndarray] = {}
        self._madj_cache: Dict[int, np.ndarray] = {}
        self._dfits_cache: Dict[int, np.ndarray] = {}
        self._gz_grid_cache: Dict[int, np.ndarray] = {}
        self._node_enc_cache: Dict[tuple, EncodedRequirements] = {}
        self._zone_enc_cache: Dict[int, EncodedRequirements] = {}

    def _it_alloc_nz(self, g: int) -> np.ndarray:
        """[T, nnz(g)] raw allocatable restricted to group g's requested
        resources (daemon overhead enters per candidate template in
        _cohort_caps)."""
        out = self._alloc_nz_cache.get(g)
        if out is None:
            out = self.p.it_alloc[:, self._req_nz[g]]
            self._alloc_nz_cache[g] = out
        return out

    def _gz_grid(self, g: int) -> np.ndarray:
        """[M, T, Z+1] group-side feasibility with the any-zone plane
        appended at index Z, so mixed zone-committed / zone-free candidate
        cohorts gather their per-IT admission in ONE fancy index."""
        grid = self._gz_grid_cache.get(g)
        if grid is None:
            grid = np.concatenate(
                [self.t.it_ok_z[g], self.t.it_ok[g][:, :, None]], axis=2)
            self._gz_grid_cache[g] = grid
        return grid

    # -- helpers ------------------------------------------------------------

    def _viable_templates(self, g: int) -> List[int]:
        return [m for m in range(self.M) if self.t.it_ok[g, m].any()]

    def _open_nodes(self, g: int, m: int, zone: Optional[int], n_pods: int,
                    per_node: int) -> int:
        """Open as many nodes as limits allow for n_pods; returns pods placed."""
        if per_node <= 0:
            return 0
        it_ok = (self.t.it_ok_z[g, m, :, zone] if zone is not None
                 else self.t.it_ok[g, m])
        it_set = it_ok & (self.t.ppn[g, m] >= 1)
        if not it_set.any():
            return 0
        limits = self.template_limits[m]
        cohort_enc = self._node_enc(g, m, zone)
        if limits is None:
            full_nodes, rem = divmod(n_pods, per_node)
            placed = 0
            if full_nodes and self._append_cohort(g, m, zone, it_set, per_node,
                                                  cohort_enc, n=full_nodes):
                placed += full_nodes * per_node
            if rem and self._append_cohort(g, m, zone, it_set, rem,
                                           cohort_enc, n=1):
                placed += rem
            return placed
        placed = 0
        while placed < n_pods:
            it_fit = it_set & self._under_limits(m, it_set)
            if not it_fit.any():
                self.result.limit_constrained = True
                break
            # size the fill from the LIMIT-FILTERED set: per_node came from
            # the unfiltered max-capacity type, which limits may have
            # excluded — overfilling would prune the cohort's options empty
            per_fit = min(per_node,
                          self._fill_ceiling(g, m, self.t.ppn[g, m], it_fit))
            if per_fit <= 0:
                break
            fill = min(per_fit, n_pods - placed)
            # append BEFORE consuming limits: a fill-sizing failure must not
            # leak a phantom node's worth of limit capacity (subtractMax
            # models only nodes that actually open, scheduler.go:388-405)
            if not self._append_cohort(g, m, zone, it_fit, fill, cohort_enc,
                                       n=1):
                break
            self._subtract_max(m, it_fit)
            placed += fill
        return placed

    def _under_limits(self, m: int, it_set: np.ndarray) -> np.ndarray:
        limits = self.template_limits[m]
        ok = np.ones(self.T, dtype=bool)
        for rname in self.limit_resources:
            if rname not in limits:
                continue  # this pool doesn't limit rname (limits.ExceededBy)
            ridx = self.p.vocab.resource_idx.get(rname)
            if ridx is None:
                continue
            ok &= self.p.it_capacity[:, ridx] <= limits[rname]
        return ok

    def _subtract_max(self, m: int, it_set: np.ndarray) -> None:
        """subtractMax pessimism (scheduler.go:388-405)."""
        limits = self.template_limits[m]
        for rname in list(limits):
            ridx = self.p.vocab.resource_idx.get(rname)
            if ridx is None:
                continue
            limits[rname] = limits[rname] - int(self.p.it_capacity[it_set, ridx].max())

    def _node_enc(self, g: int, m: int, zone: Optional[int]) -> EncodedRequirements:
        """Fresh-cohort requirement row; memoized (pure in (g, m, zone), and
        append copies it into the cohort store so sharing is safe)."""
        key = (g, m, zone)
        e = self._node_enc_cache.get(key)
        if e is None:
            e = np_combine(_row(self.p.template_enc, m), _row(self.p.group_enc, g))
            if zone is not None:
                e = np_combine(e, self._zone_enc(zone))
            self._node_enc_cache[key] = e
        return e

    def _zone_enc(self, zone: int) -> EncodedRequirements:
        e = self._zone_enc_cache.get(zone)
        if e is None:
            e = self._build_zone_enc(zone)
            self._zone_enc_cache[zone] = e
        return e

    def _build_zone_enc(self, zone: int) -> EncodedRequirements:
        K, W = self.p.group_enc.mask.shape[1:]
        mask = np.full((K, W), 0xFFFFFFFF, dtype=np.uint32)
        defined = np.zeros(K, dtype=bool)
        complement = np.ones(K, dtype=bool)
        exempt = np.zeros(K, dtype=bool)
        zk = self.p.zone_key
        row = np.zeros(W, dtype=np.uint32)
        vi = int(self.p.zone_values[zone])
        row[vi // 32] |= np.uint32(1 << (vi % 32))
        mask[zk] = row
        defined[zk] = True
        complement[zk] = False
        return EncodedRequirements(mask=mask, defined=defined, complement=complement,
                                   exempt=exempt,
                                   gt=np.full(K, -2**31, dtype=np.int64),
                                   lt=np.full(K, 2**31 - 1, dtype=np.int64))

    def _adjusted_alloc(self, m: int) -> np.ndarray:
        """[T, R] allocatable minus template m's daemon overhead, memoized
        (pure function of m; _commit_to_cohort sits on the remainder hot
        path)."""
        out = self._madj_cache.get(m)
        if out is None:
            out = self.p.it_alloc - self.p.daemon_overhead[m]
            self._madj_cache[m] = out
        return out

    def _fill_ceiling(self, g: int, m: int, vals: np.ndarray,
                      mask: np.ndarray) -> int:
        """Max per-node fill of group g on a fresh template-m node honoring
        the minValues floor: the k-th largest masked per-IT capacity (plain
        max when no floor — k ITs hold >= fill pods iff fill <= k-th
        largest). Callers guarantee mask.any()."""
        sel = vals[mask]
        k = int(self._min_its[m, g]) if self._has_min_its else 0
        if k <= 1:
            return int(sel.max())
        if sel.size < k:
            return 0
        return int(np.partition(sel, sel.size - k)[sel.size - k])

    def _daemon_fits(self, m: int) -> np.ndarray:
        """[T] bool: daemon-adjusted allocatable is nonnegative in EVERY
        resource — the request-independent part of _fits_requests, memoized
        so the hot fit check only touches the requested columns."""
        out = self._dfits_cache.get(m)
        if out is None:
            out = (self._adjusted_alloc(m) >= 0).all(axis=1)
            self._dfits_cache[m] = out
        return out

    def _adj_nz(self, m: int, nz: np.ndarray) -> np.ndarray:
        """[T, len(nz)] daemon-adjusted allocatable restricted to columns
        nz, memoized per (template, column-set)."""
        key = (m, nz.tobytes())
        out = self._adj_nz_cache.get(key)
        if out is None:
            out = self._adjusted_alloc(m)[:, nz]
            self._adj_nz_cache[key] = out
        return out

    def _fits_requests(self, m: int, requests: np.ndarray) -> np.ndarray:
        """[T] bool: instance types whose daemon-adjusted allocatable holds
        the cumulative request vector — the tensor twin of the per-pod
        instance-type refiltering (nodeclaim.go:108-117): an IT that fit the
        first pod must leave the set once the accumulated load outgrows it,
        or downstream consumers (price ordering, the consolidation price
        filter, the provider's cheapest-offering pick) see phantom options.
        Split as (all columns >= 0) AND (requested columns hold the load):
        equal to the full [T, R] compare because requests are nonnegative,
        at a fraction of the width."""
        nz = np.nonzero(requests)[0]
        fit = self._daemon_fits(m)
        if nz.size:
            fit = fit & (self._adj_nz(m, nz) >= requests[nz]).all(axis=1)
        return fit

    def _append_cohort(self, g: int, m: int, zone: Optional[int],
                       it_set: np.ndarray, fill: int,
                       cohort_enc: EncodedRequirements, n: int = 1) -> bool:
        """Returns False (placing nothing) when the fill-sizing invariant is
        violated — the fill outgrew every surviving instance type. Callers
        treat that as 0 pods placed, so the group's remainder flows to the
        normal unplaced-pods error path instead of an assert crashing the
        whole batch (and `python -O` silently materializing an empty
        it_set)."""
        req = self.p.group_req[g] * fill
        it_set = it_set & self._fits_requests(m, req)
        if not it_set.any():
            return False
        if self._has_min_its:
            k = int(self._min_its[m, g])
            if k > 1 and int(it_set.sum()) < k:
                return False  # fresh claim can't keep the minValues floor
        self.cohorts.append(g=g, m=m, zone=zone, it_set=it_set, requests=req,
                            n=n, enc_row=cohort_enc, fill=fill)
        return True

    def _cohort_caps(self, g: int, cand: np.ndarray, zone: Optional[int],
                     prospect: Optional[np.ndarray]
                     ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """Batched cohort capacity: (caps [nc], surviving it-set ts [nc, T],
        per-IT capacities per [nc, T] or None when g requests nothing) for
        EVERY candidate row in ``cand`` at once (the round-5 code re-derived
        this per cohort in Python). Negative free capacity floors the per-IT
        min below zero, which the caller's cap<=0 gate treats identically to
        the old clamp-to-zero; rows whose surviving set is empty report cap
        0. ``prospect`` rows evaluate a PROSPECTIVE zone commitment of a
        zone-free cohort (see _fill_cohorts) without mutating it: their
        admission additionally intersects the cohort's accumulated
        aboard-group zone-feasibility bitfield (CohortSet.okz). ``per`` rows
        let commits derive the post-commit instance-type set as
        ``ts & (per >= fill)`` — exactly the _fits_requests refiltering,
        because ts only holds types that fit the PRE-commit load."""
        cs = self.cohorts
        m_c = cs.m[cand]
        grid = self._gz_grid(g)                             # [M, T, Z+1]
        if zone is not None:
            ez = np.full(cand.size, zone, np.int64)
        else:
            cz = cs.zone[cand]
            ez = np.where(cz < 0, self.Z, cz)               # Z == any-zone
        ts = cs.it_set[cand] & grid[m_c, :, ez]             # [nc, T]
        if prospect is not None:
            pm = prospect[cand]
            if pm.any():
                ts[pm] = ts[pm] & enc.bit_column(cs.okz[cand[pm]], zone)
        any_ts = ts.any(axis=1)
        k_c = self._min_its[m_c, g] if self._has_min_its else None
        nz = self._req_nz[g]
        if nz.size == 0:
            ok = (any_ts if k_c is None
                  else ts.sum(axis=1) >= np.maximum(k_c, 1))
            return np.where(ok, np.int64(INT32_MAX), np.int64(0)), ts, None
        need = (self.p.daemon_overhead[m_c][:, nz]
                + cs.requests[cand][:, nz])                 # [nc, nnz]
        alloc = self._it_alloc_nz(g)
        rv = self._req_vals[g]
        # per-resource [nc, T] floordivs + running min: same arithmetic as
        # the 3-D broadcast, without materializing the [nc, T, nnz] temp
        per = (alloc[None, :, 0] - need[:, 0:1]) // rv[0]
        for r in range(1, nz.size):
            per = np.minimum(per, (alloc[None, :, r] - need[:, r:r + 1])
                             // rv[r])
        masked = np.where(ts, per, np.iinfo(np.int64).min)
        caps = masked.max(axis=1)
        if k_c is not None and (k_c > 1).any():
            # minValues floor: cap at the k-th largest surviving capacity so
            # >= k instance types outlive the commit's it_set refiltering
            count = ts.sum(axis=1)
            T = masked.shape[1]
            for j in np.nonzero(k_c > 1)[0]:
                k = int(k_c[j])
                caps[j] = (np.partition(masked[j], T - k)[T - k]
                           if count[j] >= k else 0)
        return np.where(any_ts, caps, 0), ts, per

    def _fill_cohorts(self, g: int, remaining: int, zone: Optional[int],
                      per_node_cap: int) -> int:
        """Mix pods of g into compatible existing cohorts (the reference's
        fewest-pods-first in-flight node pass, scheduler.go:276-283).

        One vectorized eligibility pass over the whole cohort matrix —
        zone admission (incl. the prospective zone-commit gate via the
        incrementally AND-folded zadm/okz aggregates), template compat +
        toleration, accumulated-requirement compatibility, host-port
        exclusion — then capacities in geometrically growing fill-order
        chunks so the common few-cohorts fill never pays for the full
        matrix while an exhausting scan stays one batched pass. Placement
        semantics are unchanged: eligibility and capacity of a cohort are
        independent of commits to OTHER cohorts within one call, and
        split-off rows land past the scan snapshot exactly like the old
        list appends, so precomputing matches the sequential scan
        decision-for-decision."""
        if remaining <= 0:
            return 0
        cs = self.cohorts
        C = cs.C
        if C == 0:
            return 0
        m_all = cs.m[:C]
        elig = self.t.compat_tm[m_all, g] & self.p.tol_template[g, m_all]
        prospect = None
        if zone is not None:
            czone = cs.zone[:C]
            # a zone-free cohort may take zonal pods only by COMMITTING to
            # the zone (nodeclaim.go Add intersects requirements): allowed
            # iff every group already aboard admits the zone (zadm)
            prospect = (czone < 0) & cs.zadm[:C, zone]
            elig &= (czone == zone) | prospect
        # a cohort committed to SOME zone takes zone-free pods whenever the
        # group's requirements admit that zone — the enc-compat pass below
        # (or triviality) covers it, as before
        if not self._g_trivial[g] and elig.any():
            elig &= cs.compatible_rows(_row(self.p.group_enc, g),
                                       self.p.allow_undefined)
        if self._port_conflict is not None:
            conf = self._port_conflict[g]
            if conf.any():
                # a conflicting host port is already bound aboard
                elig &= ~(cs.aboard[:C] & conf).any(axis=1)
        if not elig.any():
            return 0
        order = np.argsort(cs.fill[:C], kind="stable")
        cand = order[elig[order]]
        placed_total = 0
        pos = 0
        chunk = 8
        while remaining > 0 and pos < cand.size:
            ch = cand[pos:pos + chunk]
            pos += ch.size
            chunk = min(chunk * 4, 512)
            caps, ts, per = self._cohort_caps(g, ch, zone, prospect)
            if per_node_cap:
                base = np.fromiter(
                    (cs.pods_by_group[ci].get(g, 0) for ci in ch),
                    dtype=np.int64, count=ch.size)
                caps = np.minimum(caps, np.maximum(0, per_node_cap - base))
            for j in np.nonzero(caps > 0)[0]:
                if remaining <= 0:
                    break
                ci = int(ch[j])
                cap = int(caps[j])
                commit_zone = prospect is not None and bool(prospect[ci])
                ts_row = ts[j]
                per_row = per[j] if per is not None else None
                # fill each node of the cohort up to cap; split if not all
                # consumed
                n_ci = int(cs.n[ci])
                fill_nodes = min(n_ci, -(-remaining // cap))
                if fill_nodes < n_ci:
                    # the UNFILLED nodes keep the cohort's original zone
                    # state: only nodes actually receiving zonal pods
                    # narrow their zone
                    cs.split(ci, n_ci - fill_nodes)
                    cs.n[ci] = fill_nodes
                # take at most cap per node: when demand exceeds the
                # cohort's total capacity (remaining > cap * n), every node
                # takes exactly cap and the leftover moves on — per_last
                # derived from the raw remaining overfilled the last node
                # past the per-node cap (e.g. 14 hostname-spread pods on
                # one node at maxSkew=1)
                take = min(remaining, cap * fill_nodes)
                per_last = take - cap * (fill_nodes - 1)
                if per_last != cap and fill_nodes > 1:
                    # last node takes the remainder; split it off
                    last = cs.split(ci, 1)
                    cs.n[ci] = fill_nodes - 1
                    if commit_zone:
                        self._commit_cohort_zone(ci, zone)
                        self._commit_cohort_zone(last, zone)
                    self._commit_to_cohort(last, g, per_last, ts_row, per_row)
                    self._commit_to_cohort(ci, g, cap, ts_row, per_row)
                    placed = take
                else:
                    fill = per_last if fill_nodes == 1 else cap
                    if commit_zone:
                        self._commit_cohort_zone(ci, zone)
                    self._commit_to_cohort(ci, g, fill, ts_row, per_row)
                    placed = fill * fill_nodes
                placed_total += placed
                remaining -= placed
        return placed_total

    def _commit_cohort_zone(self, ci: int, zone: int) -> None:
        """Pin a zone-free cohort to a zone: both the zone field AND the
        encoded requirements narrow (the enc drives offering admission in
        price ordering and keys the materialize order-cache — a stale
        all-zones enc would rank unreachable offerings and collide cache
        entries across differently-pinned cohorts)."""
        cs = self.cohorts
        cs.zone[ci] = zone
        cs.set_enc(ci, np_combine(cs.enc_row(ci), self._zone_enc(zone)))

    def _commit_to_cohort(self, ci: int, g: int, fill: int, ts: np.ndarray,
                          per: Optional[np.ndarray] = None):
        cs = self.cohorts
        cs.requests[ci] += self.p.group_req[g] * fill
        m = int(cs.m[ci])
        if per is not None:
            # ts only holds types fitting the pre-commit load, so the
            # _fits_requests refiltering against the grown request vector
            # reduces to the per-IT capacity bound (see _cohort_caps)
            cs.it_set[ci] = ts & (per >= fill)
        else:
            cs.it_set[ci] = ts & self._fits_requests(m, cs.requests[ci])
        pbg = cs.pods_by_group[ci]
        pbg[g] = pbg.get(g, 0) + fill
        cs.fill[ci] += fill
        if not cs.aboard[ci, g]:
            # first boarding of g: fold its planes into the aggregates.
            # Re-boarding is a no-op for all three — requirement combine
            # and the AND-folds are idempotent — which the old code paid
            # for anyway on every repeat commit.
            cs.aboard[ci, g] = True
            cs.zadm[ci] &= self.t.zone_adm[g, m]
            cs.okz[ci] &= cs._okz_row(g, m)
            if not self._g_trivial[g]:
                # combining with a no-requirements row is the identity
                cs.set_enc(ci, np_combine(cs.enc_row(ci),
                                          _row(self.p.group_enc, g)))

    def _fill_existing(self, g: int, remaining: int, zone: Optional[int],
                       per_node_cap: int,
                       node_caps: Optional[np.ndarray] = None,
                       max_nodes: int = 0) -> int:
        """Pack into live nodes. node_caps[n] (when given) hard-caps each
        node individually — the hostname-topology cap derived from already-
        scheduled matching pods (0 = excluded); max_nodes > 0 limits how many
        distinct nodes may be used (hostname pod affinity: all on one)."""
        placed_total = 0
        used_nodes = 0
        for n in self.exist_order:
            if remaining <= 0:
                break
            if max_nodes and used_nodes >= max_nodes:
                break
            if not self.t.exist_ok[g, n]:
                continue
            if zone is not None and (self.p.exist_zone is None
                                     or self.p.exist_zone[n] != zone):
                continue
            req = self.p.group_req[g]
            with np.errstate(divide="ignore"):
                per = np.where(req > 0, self.exist_avail[n] // np.maximum(req, 1),
                               INT32_MAX)
            cap = int(per.min()) if per.size else 0
            if per_node_cap:
                cap = min(cap, per_node_cap)
            if node_caps is not None:
                cap = min(cap, int(node_caps[n]))
            vol_counts = (self.vol_group_counts[g]
                          if self.vol_group_counts is not None else None)
            vol_rem = None
            if vol_counts:
                vol_rem = (self.vol_node_remaining[n]
                           if self.vol_node_remaining is not None
                           and n < len(self.vol_node_remaining) else None)
                if vol_rem:
                    cap = min(cap, min(
                        (vol_rem[d] // c for d, c in vol_counts.items()
                         if d in vol_rem), default=INT32_MAX))
            fill = min(cap, remaining)
            if fill <= 0:
                continue
            if vol_counts and vol_rem:
                for d, c in vol_counts.items():
                    if d in vol_rem:
                        vol_rem[d] -= c * fill
            self.exist_avail[n] = self.exist_avail[n] - req * fill
            self.result.existing.setdefault(n, []).append((g, fill))
            placed_total += fill
            remaining -= fill
            used_nodes += 1
        return placed_total

    # -- main ---------------------------------------------------------------

    def ffd_order(self) -> List[int]:
        """The first-fit-decreasing group order the sequential pack walks —
        exposed so the sharded pack (parallel/mesh.sharded_pack) can carve
        the SAME order into per-shard blocks."""
        cpu_idx = self.p.vocab.resource_idx.get("cpu", 0)
        mem_idx = self.p.vocab.resource_idx.get("memory", 0)
        return sorted(range(self.G), key=lambda g: (
            -self.p.group_req[g][cpu_idx], -self.p.group_req[g][mem_idx]))

    def pack(self, order: Optional[List[int]] = None) -> PackResult:
        """Pack every group of ``order`` (default: the full FFD order) into
        this packer's cohort set. An explicit order is the sharded-pack
        entry: it packs only that block of groups. The warm-start machinery
        is order-generic — checkpoints record state after a prefix of
        WHATEVER order this pack walks — so a per-shard WarmStart (its
        global token carries the shard identity, its seed that block's
        ffd_tokens) composes with an explicit block; callers that want a
        cold block pack simply construct the Packer without ``warm``."""
        if order is None:
            order = self.ffd_order()
        warm = self._warm if self._warm_usable() else None
        start = 0
        cks: List[PackCheckpoint] = []
        if warm is not None:
            start, cks = self._warm_restore(order, warm)
        step = max(1, (len(order) + 7) // 8)
        for pos in range(start, len(order)):
            self._pack_group(order[pos])
            if warm is not None and ((pos + 1) % step == 0
                                     or pos + 1 == len(order)):
                cks.append(self._checkpoint(pos + 1, order))
        if warm is not None:
            # bound the seed: carried + fresh checkpoints would otherwise
            # accumulate across passes (each holds full cohort-array
            # copies). Thin evenly, always keeping the LAST checkpoint so
            # an unchanged next pass still full-replays.
            if len(cks) > MAX_SEED_CHECKPOINTS:
                stride = -(-len(cks) // MAX_SEED_CHECKPOINTS)
                cks = cks[::-1][::stride][::-1]
            warm.result_seed = PackSeed(
                global_token=warm.global_token,
                ffd_tokens=[warm.tokens[g] for g in order],
                checkpoints=cks)
        self.result.cohorts = self.cohorts
        return self.result

    # -- warm start ---------------------------------------------------------

    def _warm_usable(self) -> bool:
        """Shapes whose shared mutable state is NOT checkpointed fall back
        to a full pack (delta encode still applies upstream): host ports
        (cross-group conflict state in result.existing), volume attach
        budgets (shared per-node dicts), minValues floors."""
        return (self._warm is not None
                and self.vol_group_counts is None
                and (self.group_ports is None
                     or not any(self.group_ports))
                and not self._has_min_its)

    def _warm_restore(self, order, warm: WarmStart
                      ) -> Tuple[int, List[PackCheckpoint]]:
        """Match the longest clean FFD prefix against the seed, restore the
        latest checkpoint inside it, and return (resume position, carried
        checkpoints remapped into the current group-index space)."""
        seed = warm.seed
        if seed is None or seed.global_token != warm.global_token:
            return 0, []
        n = 0
        for pos, g in enumerate(order):
            if pos >= len(seed.ffd_tokens) \
                    or seed.ffd_tokens[pos] != warm.tokens[g]:
                break
            n = pos + 1
        warm.matched = n
        usable = [c for c in seed.checkpoints if c.pos <= n]
        if not usable:
            return 0, []
        ck = max(usable, key=lambda c: c.pos)
        # position p of the seed's order packed old group ck.g_of_pos[p];
        # the current pack has order[p] there — token equality at every
        # prefix position makes the pairing exact
        remap = {ck.g_of_pos[p]: order[p] for p in range(ck.pos)}
        carried = [self._remap_checkpoint(c, remap) for c in usable]
        self._restore(carried[-1])
        warm.restored_pos = ck.pos
        return ck.pos, carried

    def _remap_checkpoint(self, ck: PackCheckpoint, remap: dict
                          ) -> PackCheckpoint:
        aboard = ck.rows["aboard"]
        new_aboard = np.zeros((ck.C, self.G), dtype=bool)
        for og, ng in remap.items():
            new_aboard[:, ng] = aboard[:ck.C, og]
        rows = dict(ck.rows)
        rows["aboard"] = new_aboard
        return PackCheckpoint(
            pos=ck.pos, C=ck.C, rows=rows,
            pods_by_group=[{remap[g]: f for g, f in d.items()}
                           for d in ck.pods_by_group],
            existing={n: [(remap[g], f) for g, f in fills]
                      for n, fills in ck.existing.items()},
            error_log=[(remap[g], c, m) for g, c, m in ck.error_log],
            exist_avail=ck.exist_avail, limits=ck.limits,
            limit_constrained=ck.limit_constrained,
            g_of_pos=[remap[g] for g in ck.g_of_pos])

    def _checkpoint(self, pos: int, order) -> PackCheckpoint:
        cs = self.cohorts
        C = cs.C
        return PackCheckpoint(
            pos=pos, C=C,
            rows={name: getattr(cs, name)[:C].copy()
                  for name in CohortSet._ROW_FIELDS},
            pods_by_group=[dict(d) for d in cs.pods_by_group],
            existing={n: list(f) for n, f in self.result.existing.items()},
            error_log=list(self._error_log),
            exist_avail=self.exist_avail.copy(),
            limits=[None if lm is None else dict(lm)
                    for lm in self.template_limits],
            limit_constrained=self.result.limit_constrained,
            g_of_pos=[order[p] for p in range(pos)])

    def _restore(self, ck: PackCheckpoint) -> None:
        cs = self.cohorts
        cap = cs._cap
        while cap < ck.C:
            cap *= 2
        cs._cap = cap
        for name in CohortSet._ROW_FIELDS:
            src = ck.rows[name]
            out = np.zeros((cap,) + src.shape[1:], src.dtype)
            out[:ck.C] = src[:ck.C]
            setattr(cs, name, out)
        cs.C = ck.C
        cs.pods_by_group = [dict(d) for d in ck.pods_by_group]
        cs._okz_rows = {}
        self.result.existing = {n: list(f) for n, f in ck.existing.items()}
        self.result.limit_constrained = ck.limit_constrained
        # error replay re-binds the recorded tail spans to CURRENT pod
        # objects (uids change across passes; group identity + count don't)
        self._error_log = list(ck.error_log)
        for g, count, msg in ck.error_log:
            pods = self.groups[g].pods
            for pod in pods[len(pods) - count:]:
                self.result.errors[pod.uid] = msg
        self.exist_avail[:] = ck.exist_avail
        self.template_limits = [None if lm is None else dict(lm)
                                for lm in ck.limits]

    def _error_group(self, g: int, count: int, msg: str) -> None:
        self._error_log.append((g, count, msg))
        pods = self.groups[g].pods
        start = len(pods) - count
        for pod in pods[start:]:
            self.result.errors[pod.uid] = msg

    def _host_caps(self, g: int, host_spec) -> Tuple[int, Optional[np.ndarray]]:
        """Per-fresh-node cap (0 = unlimited) and per-existing-node caps from
        the group's hostname-level constraint. Self-selecting constraints
        budget against already-scheduled matching pods per node
        (exist_counts); non-self constraints never budget batch pods (they
        don't match the selector) — they only admit or exclude nodes by their
        static matching counts (topologygroup.go:181-227, 316-342 with the
        hostname global-min floored at 0, :232-234)."""
        if host_spec is None:
            return 0, None
        N = self.exist_avail.shape[0]
        cnt = (self.exist_counts[g] if self.exist_counts is not None
               else np.zeros(N, dtype=np.int64))
        if host_spec.kind == "spread-host":
            skew = host_spec.max_skew
            if host_spec.self_select:
                return skew, np.maximum(0, skew - cnt)
            return 0, np.where(cnt > skew, 0, INT32_MAX)
        # anti-host
        if host_spec.self_select:
            return 1, np.where(cnt > 0, 0, 1)
        return 0, np.where(cnt > 0, 0, INT32_MAX)

    def _apply_port_caps(self, g: int, per_node_cap: int,
                         node_caps: Optional[np.ndarray]
                         ) -> Tuple[int, Optional[np.ndarray]]:
        """Identical host-port specs all conflict pairwise, so a port group
        holds at most ONE pod per node (fresh or existing), and nodes whose
        current pods already bind a conflicting port are out entirely."""
        if not self.group_ports or not self.group_ports[g]:
            return per_node_cap, node_caps
        per_node_cap = 1 if per_node_cap == 0 else min(per_node_cap, 1)
        caps = np.ones(self.exist_avail.shape[0], dtype=np.int64)
        if self.exist_port_block is not None:
            # the block covers the REAL nodes; exist_avail may be padded
            blocked = np.nonzero(self.exist_port_block[g])[0]
            caps[blocked] = 0
        # ports bound onto existing nodes EARLIER IN THIS PACK (the
        # pre-solve block can't know them): any conflicting group already
        # placed on a node takes that node out (scheduler.py:329 semantics
        # — the oracle updates usage per placement)
        if self._port_conflict is not None:
            for n, fills in self.result.existing.items():
                for g2, _fill in fills:
                    if self._port_conflict[g, g2]:
                        caps[n] = 0
                        break
        if node_caps is not None:
            caps = np.minimum(caps, node_caps)
        return per_node_cap, caps

    def _pack_group(self, g: int) -> None:
        group = self.groups[g]
        c = group.count
        if c == 0:
            return
        specs = group.topo or []
        zone_spec = next((s for s in specs
                          if s.kind in ("spread-zone", "affinity-zone",
                                        "anti-zone")), None)
        host_spec = next((s for s in specs
                          if s.kind in ("spread-host", "anti-host",
                                        "affinity-host")), None)

        if host_spec is not None and host_spec.kind == "affinity-host":
            self._pack_affinity_host(g, c)  # always alone (grouping)
            return
        per_node_cap, node_caps = self._host_caps(g, host_spec)
        per_node_cap, node_caps = self._apply_port_caps(g, per_node_cap,
                                                        node_caps)

        if zone_spec is None:
            placed = self._fill_existing(g, c, None, per_node_cap, node_caps)
            placed += self._fill_cohorts(g, c - placed, None, per_node_cap)
            placed += self._place_new(g, c - placed, None, per_node_cap)
            if placed < c:
                msg = "no instance type satisfied the pod"
                if host_spec is not None:
                    msg = ("unsatisfiable hostname topology spread"
                           if host_spec.kind == "spread-host"
                           else "unsatisfiable hostname anti-affinity")
                self._error_group(g, c - placed, msg)
        elif zone_spec.kind == "spread-zone":
            if zone_spec.self_select:
                self._pack_spread_zone(g, c, zone_spec, per_node_cap, node_caps)
            else:
                self._pack_spread_zone_static(g, c, zone_spec, per_node_cap,
                                              node_caps)
        elif zone_spec.kind == "affinity-zone":
            self._pack_affinity_zone(g, c, zone_spec, per_node_cap, node_caps)
        else:  # anti-zone (always alone among zone kinds)
            self._pack_anti_zone(g, c, zone_spec, per_node_cap, node_caps)

    def _place_new(self, g: int, remaining: int, zone: Optional[int],
                   per_node_cap: int) -> int:
        if remaining <= 0:
            return 0
        placed = 0
        for m in range(self.M):
            if remaining - placed <= 0:
                break
            ppn_all = self.t.ppn[g, m]
            it_ok = (self.t.it_ok_z[g, m, :, zone] if zone is not None
                     else self.t.it_ok[g, m])
            if not it_ok.any():
                continue
            per = self._fill_ceiling(g, m, ppn_all, it_ok)
            if per_node_cap:
                per = min(per, per_node_cap)
            placed += self._open_nodes(g, m, zone, remaining - placed, per)
        return placed

    def _place_one_node(self, g: int, c: int) -> int:
        for m in range(self.M):
            it_ok = self.t.it_ok[g, m]
            if not it_ok.any():
                continue
            limits = self.template_limits[m]
            limit_pruned = False
            if limits is not None:
                it_fit = it_ok & self._under_limits(m, it_ok)
                if not it_fit.any():
                    self.result.limit_constrained = True
                    continue
                limit_pruned = bool((it_fit != it_ok).any())
                it_ok = it_fit
            # fill sized from the (limit-filtered) surviving set
            per = self._fill_ceiling(g, m, self.t.ppn[g, m], it_ok)
            fill = min(per, c)
            if fill <= 0:
                if limit_pruned:
                    # the surviving (smaller) types hold zero pods: this
                    # failure exists only because limits pruned the big
                    # ones — not an oracle-final verdict
                    self.result.limit_constrained = True
                continue
            if not self._append_cohort(g, m, None, it_ok, fill,
                                       self._node_enc(g, m, None)):
                continue
            if limits is not None:
                self._subtract_max(m, it_ok)
            return fill
        return 0

    def _zone_admitted_viable(self, g: int) -> Tuple[np.ndarray, np.ndarray]:
        # admitted zones: group+any template admits; viable: some IT offering
        admitted = np.zeros(self.Z, dtype=bool)
        viable = np.zeros(self.Z, dtype=bool)
        for m in self._viable_templates(g):
            admitted |= self.t.zone_adm[g, m]
            viable |= self.t.it_ok_z[g, m].any(axis=0)
        return admitted, viable

    def _zone_min_mask(self, g: int) -> np.ndarray:
        """The pod's view of the domain universe for global-min/minDomains
        arithmetic (topologygroup.go:229-250): every registered domain the
        POD's own requirements admit. The universe spans ALL templates'
        admitted zones — including templates the group can't actually use
        (tainted pools, incompatible requirements): a zero-count zone behind
        an intolerable taint still pins the reference's global min at 0 —
        plus zones holding recorded cluster pods (izc) that no template
        reaches at all."""
        greq = self.groups[g].requirements.get(api_labels.LABEL_TOPOLOGY_ZONE)
        pod_admits = np.fromiter((greq.has(z) for z in self._zone_names),
                                 dtype=bool, count=self.Z)
        # zone_adm[g, m] is already pod-side-intersected (combined reqs)
        return self.t.zone_adm[g].any(axis=0) | \
            (pod_admits & (self.zone_counts[g] > 0))

    def _fill_zone(self, g: int, a: int, z: int, per_node_cap: int,
                   node_caps: Optional[np.ndarray]) -> int:
        placed = self._fill_existing(g, a, z, per_node_cap, node_caps)
        placed += self._fill_cohorts(g, a - placed, z, per_node_cap)
        placed += self._place_new(g, a - placed, z, per_node_cap)
        return placed

    def _pack_spread_zone(self, g: int, c: int, spec, per_node_cap: int = 0,
                          node_caps: Optional[np.ndarray] = None) -> None:
        admitted, viable = self._zone_admitted_viable(g)
        if not admitted.any():
            self._error_group(g, c, "no zone admitted for topology spread")
            return
        alloc = waterfill(self.zone_counts[g], viable, admitted, c,
                          spec.max_skew, spec.min_domains,
                          zone_names=self._zone_names,
                          min_mask=self._zone_min_mask(g))
        placed_total = 0
        for z in np.argsort(-alloc):
            a = int(alloc[z])
            if a <= 0:
                continue
            placed = self._fill_zone(g, a, int(z), per_node_cap, node_caps)
            self.zone_counts[g, z] += placed
            placed_total += placed
        if placed_total < c:
            self._error_group(g, c - placed_total, "unsatisfiable zonal topology spread")

    def _pack_spread_zone_static(self, g: int, c: int, spec,
                                 per_node_cap: int,
                                 node_caps: Optional[np.ndarray]) -> None:
        """Non-self-selecting zonal spread: placing batch pods never changes
        the domain counts, so the skew arithmetic is static. Existing nodes
        in any skew-eligible zone may take pods; fresh nodes all commit to
        the min-count eligible zone, exactly the domain nextDomain would
        return for an unconstrained node (topologygroup.go:181-227)."""
        admitted, viable = self._zone_admitted_viable(g)
        if not admitted.any():
            self._error_group(g, c, "no zone admitted for topology spread")
            return
        counts = self.zone_counts[g]
        min_mask = self._zone_min_mask(g)
        floor_zero = (spec.min_domains is not None
                      and int(min_mask.sum()) < spec.min_domains)
        gmin = 0 if floor_zero else (int(counts[min_mask].min())
                                     if min_mask.any() else 0)
        eligible = admitted & (counts - gmin <= spec.max_skew)
        if not eligible.any():
            self._error_group(g, c, "unsatisfiable zonal topology spread")
            return
        placed = 0
        for z in np.where(eligible)[0]:
            if placed >= c:
                break
            placed += self._fill_existing(g, c - placed, int(z),
                                          per_node_cap, node_caps)
        fresh = eligible & viable
        if placed < c and fresh.any():
            cand = np.where(fresh)[0]
            z = int(cand[np.lexsort((self._zone_names[cand],
                                     counts[cand]))[0]])
            placed += self._fill_cohorts(g, c - placed, z, per_node_cap)
            placed += self._place_new(g, c - placed, z, per_node_cap)
        if placed < c:
            self._error_group(g, c - placed, "unsatisfiable zonal topology spread")

    def _pack_affinity_zone(self, g: int, c: int, spec, per_node_cap: int = 0,
                            node_caps: Optional[np.ndarray] = None) -> None:
        admitted, viable = self._zone_admitted_viable(g)
        counts = self.zone_counts[g]
        # occupancy is judged through the POD's domain view: a matching pod
        # in a zone no template reaches still blocks the bootstrap
        # (nextDomainAffinity returns empty options, not a fresh domain)
        occupied = (counts > 0) & self._zone_min_mask(g)
        if occupied.any():
            occupied &= admitted
            # pods must join an occupied domain (topologygroup.go:253-300);
            # if none of those domains has a viable instance type the pods
            # fail — there is NO bootstrap while matching pods exist
            candidates = np.where(occupied & viable)[0]
            if len(candidates) == 0:
                self._error_group(
                    g, c, "zonal pod affinity: no viable occupied zone")
                return
        elif not spec.self_select:
            # non-self affinity can never self-satisfy (the bootstrap at
            # topologygroup.go:283-287 requires the pod to match its own
            # selector): nothing matches anywhere -> unschedulable
            self._error_group(
                g, c, "zonal pod affinity: no pods match the affinity selector")
            return
        else:
            candidates = np.where(viable)[0]
            if len(candidates) == 0:
                self._error_group(g, c, "no viable zone for zonal pod affinity")
                return
        # host-parity tie-break: first domain by NAME (the oracle's affinity
        # bootstrap iterates sorted(self.domains)), not by vocab index
        z = int(min(candidates, key=self._zone_names.__getitem__))
        placed = self._fill_zone(g, c, z, per_node_cap, node_caps)
        self.zone_counts[g, z] += placed
        if placed < c:
            self._error_group(g, c - placed, "zonal pod affinity: zone capacity exhausted")

    def _pack_anti_zone(self, g: int, c: int, spec,
                        per_node_cap: int = 0,
                        node_caps: Optional[np.ndarray] = None) -> None:
        """Zonal anti-affinity: pods may only land in EMPTY domains
        (topologygroup.go:316-342). Self-selecting: each placement occupies a
        zone, and peers in the same batch are mutually excluded but not yet
        recorded — late committal places one pod per batch
        (topology_test.go:2150-2176). Non-self: batch pods never occupy
        domains, so every pod can go to any statically-empty zone."""
        admitted, viable = self._zone_admitted_viable(g)
        counts = self.zone_counts[g]
        empty = admitted & (counts == 0)
        if spec.self_select:
            placed = 0
            for z in np.where(empty)[0]:
                placed = self._fill_zone(g, 1, int(z), per_node_cap, node_caps)
                if placed:
                    self.zone_counts[g, z] += 1
                    break
            if placed < 1:
                self._error_group(g, c, "unsatisfiable zonal anti-affinity")
            elif c > 1:
                self._error_group(
                    g, c - 1, "zonal anti-affinity: domain undetermined until next batch")
            return
        placed = 0
        for z in np.where(empty)[0]:
            if placed >= c:
                break
            placed += self._fill_zone(g, c - placed, int(z), per_node_cap,
                                      node_caps)
        if placed < c:
            self._error_group(g, c - placed, "unsatisfiable zonal anti-affinity")

    def _pack_affinity_host(self, g: int, c: int) -> None:
        """Hostname pod affinity (self-selecting; grouping keeps non-self on
        the host path). With matching pods already scheduled, the batch must
        join their nodes (no bootstrap, topologygroup.go:253-287); otherwise
        the hostname domain is fixed by the first placement, so everything
        lands on ONE node and overflow is unschedulable."""
        total = (int(self.host_match_total[g])
                 if self.host_match_total is not None else 0)
        if total > 0:
            cnt = (self.exist_counts[g] if self.exist_counts is not None
                   else np.zeros(self.exist_avail.shape[0], dtype=np.int64))
            node_caps = np.where(cnt > 0, INT32_MAX, 0)
            placed = self._fill_existing(g, c, None, 0, node_caps)
            if placed < c:
                self._error_group(
                    g, c - placed,
                    "hostname pod affinity: no co-located capacity")
            return
        placed = self._fill_existing(g, c, None, 0, None, max_nodes=1)
        if placed == 0:
            placed = self._place_one_node(g, c)
        if placed < c:
            self._error_group(g, c - placed,
                              "hostname pod affinity: node capacity exhausted")


def _row(e: EncodedRequirements, i: int) -> EncodedRequirements:
    return EncodedRequirements(mask=e.mask[i], defined=e.defined[i],
                               complement=e.complement[i], exempt=e.exempt[i],
                               gt=e.gt[i], lt=e.lt[i])
