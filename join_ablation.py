#!/usr/bin/env python3
"""Where the time of K2 (catalog_feasibility), K3 (exist_feasibility) and
B5a (fits_matrix) goes on the card, and what the K2 / K3 tile plan
(kernels.join_plan) picks. Run from the repo root on a machine with a CUDA
card:

    python3 join_ablation.py variants
    python3 join_ablation.py plans SMOKE_OUTPUT
    python3 join_ablation.py fits

``variants`` times each kernel on the north-star inputs of chip_smoke.py
(49,920 pods x 2,000 types, 5,000 nodes) for the sources as they are and
for copies of them with one part taken out. Each variant is built from a
copy of ops/csrc under build/kernels/ablation/ and loaded in place of the
kernels for its own measurement. A variant's outputs are wrong by
construction, so only the sources' outputs are held to the plain versions;
a variant keeps the join's result live (the outputs still depend on it),
so the compiler cannot drop the ANDs it leaves in.

``fits`` does the same for fits_matrix at chip_smoke.py's solve shape (the
120 groups' requests against the 8,192 padded node rows, R = 4), with the
FITS_VARIANTS edits of csrc/fits_matrix.cu.

``plans`` reads the ``join_plans`` line of a chip_smoke.py run's output
(the shape and plan of every K2 / K3 launch of its paths) and, at each
shape, times every register tile the kernels are built for and, where the
plan holds every key in shared memory at once, the same tile with the
two-stage ring. Its inputs are the north-star inputs (W = 64) or those of
the multi-node consolidation encode (W = 8): their first rows, repeated
where the shape has more. Every timed launch is first held equal to the
plain version.

Prints the card, then one JSON line per variant or shape. Times are ms per
launch (chip_smoke._kernel_ms: CUDA events around CUDA-graph replays); a
shape's times are the least and the most of three such measurements.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys

import chip_smoke as cs

NO_ANDS = [("feasibility_common.cuh", "for (int c = 0; c < chunks; ++c) {",
            "for (int c = 0; c < (chunks & 0); ++c) {")]
NO_MASK_COPIES = [("feasibility_common.cuh",
                   "  if (W == 0) return;\n  const uint32_t* sa = A.mask",
                   "  return;\n  const uint32_t* sa = A.mask")]
#: what is left of the skeleton: the kernels' own staging and derived
#: inputs, the flags and bounds, their packing and the key loop's barriers
NO_STAGING = [
    ("catalog_feasibility.cu", "[&] {\n        kt_copy_words(s.alloc,",
     "[&] { return;\n        kt_copy_words(s.alloc,"),
    ("exist_feasibility.cu", "[&] {\n        kt_copy_words(s_avail,",
     "[&] { return;\n        kt_copy_words(s_avail,"),
    ("catalog_feasibility.cu",
     "[&] {\n        for (int i = threadIdx.x; i < nt * O;",
     "[&] { return;\n        for (int i = threadIdx.x; i < nt * O;"),
    ("feasibility_common.cuh", "  kt_copy_meta(A, a0, na, K, gt_a",
     "  if (0) kt_copy_meta(A, a0, na, K, gt_a"),
    ("feasibility_common.cuh", "  kt_copy_meta(B, b0, nb, K, gt_b",
     "  if (0) kt_copy_meta(B, b0, nb, K, gt_b"),
    ("feasibility_common.cuh", "  kt_pack_rows(na, nb, TA, TB, K, L, smem);",
     "  if (0) kt_pack_rows(na, nb, TA, TB, K, L, smem);"),
    ("feasibility_common.cuh",
     "      __syncthreads();\n      stage = ring + (k & 1) * stage_words;",
     "      stage = ring + (k & 1) * stage_words;"),
    ("feasibility_common.cuh", "if (!resident) __syncthreads();",
     "if (0) __syncthreads();")]

#: variant -> (file, text, replacement) edits of the sources
VARIANTS = {
    "sources": [],
    "no ANDs": NO_ANDS,
    "no mask copies": NO_MASK_COPIES,
    "no ANDs, no mask copies": NO_ANDS + NO_MASK_COPIES,
    "nothing but the launch, the key loop and the epilogues":
        NO_ANDS + NO_MASK_COPIES + NO_STAGING,
    "K2 without its offering loop": [
        ("catalog_feasibility.cu", "for (int o = 0; o < O; ++o) {",
         "for (int o = 0; o < (O & 0); ++o) {"),
        ("catalog_feasibility.cu",
         "for (int j = 0; j < RB; ++j) word[i][j] = 0u;",
         "for (int j = 0; j < RB; ++j) word[i][j] = ~0u;")],
    "K2 and K3 without their resource loops": [
        ("catalog_feasibility.cu",
         "for (int r = 0; r < R; ++r) {\n    int32_t alloc[RA];",
         "for (int r = 0; r < (R & 0); ++r) {\n    int32_t alloc[RA];"),
        ("exist_feasibility.cu",
         "for (int r = 0; r < R; ++r) {\n    int32_t avail[RA];",
         "for (int r = 0; r < (R & 0); ++r) {\n    int32_t avail[RA];")],
}


#: fits_matrix variants: the launch and nothing else; without the staging of
#: the requests (the tests read whatever shared memory holds); without the
#: avail loads (a constant row); without either
FITS_LAUNCH_ONLY = [("fits_matrix.cu", "  const int b0 = blockIdx.y * tile_b;",
                     "  if (R >= 0) return;\n"
                     "  const int b0 = blockIdx.y * tile_b;")]
FITS_NO_STAGING = [("fits_matrix.cu",
                    "    sreq[(col / V) * stride + (col % V) * R"
                    " + (w - col * R)] =\n        q <= 0 ? INT32_MIN : q;"
                    "\n  }\n  __syncthreads();",
                    "  }")]
FITS_NO_AVAIL = [
    ("fits_matrix.cu",
     "    av4 = __ldg(avail4 + a0 + threadIdx.x / runs);",
     "    av4 = make_int4(a0, 1, 2, 3);"),
    ("fits_matrix.cu",
     "        av4 = __ldg(avail4 + a0 + (i + FM_THREADS) / runs);",
     "        av4 = make_int4(i, 1, 2, 3);")]
FITS_VARIANTS = {
    "sources": [],
    "launch only": FITS_LAUNCH_ONLY,
    "no staging": FITS_NO_STAGING,
    "no avail loads": FITS_NO_AVAIL,
    "no staging, no avail loads": FITS_NO_STAGING + FITS_NO_AVAIL,
}


def _cases(problem, dev):
    """K2's and K3's inputs of one problem on ``dev``, as the precompute
    gives them: {name: (inputs, keywords)}."""
    from karpenter_tpu_torch.ops import binpack, kernels
    args, st = binpack.device_args(problem, binpack.ArgPlacer(dev))
    (group, template, it, group_req, daemon, alloc, template_its, off_zone,
     off_captype, off_avail, zone_values, allow_undef, tol_template, exist,
     exist_avail, tol_exist) = args
    cmb, compat_tm = kernels.combine_compat_plain(template, group,
                                                  allow_undef)
    return {
        "catalog_feasibility": (
            (cmb, compat_tm, it, group_req, daemon, alloc, template_its,
             off_zone, off_captype, off_avail, zone_values, tol_template),
            dict(zone_key=st["zone_key"], captype_key=st["captype_key"])),
        "exist_feasibility": ((group, group_req, exist, exist_avail,
                               tol_exist), {}),
    }


def north_star(dev):
    """The solve with nodes of chip_smoke.py: 49,920 pods x 2,000 types
    against 5,000 nodes."""
    from karpenter_tpu_torch.cloudprovider.kwok import construct_catalog
    from karpenter_tpu_torch.provisioning.grouping import partition_pods
    from karpenter_tpu_torch.provisioning.tensor_scheduler import \
        TensorScheduler
    catalog = construct_catalog(cs.N_ITS)
    groups, _, _ = partition_pods(cs.bench_pods())
    ts = TensorScheduler([cs.default_pool()], {"default": catalog},
                         state_nodes=cs.existing_nodes(catalog),
                         force_tensor=True, device=str(dev))
    problem, _, _ = ts.build_problem(groups)
    return _cases(problem, dev)


def disruption(dev):
    """The encode of chip_smoke.py's multi-node consolidation: the 100
    cheapest of 5,000 underutilized nodes x the kwok 144-type catalog."""
    env = cs.underutilized_fleet(str(dev))
    cands = cs.multi_consolidation(env, repeats=0)[0]
    cands = sorted(cands, key=lambda c: c.disruption_cost)[:100]
    return _cases(cs.disruption_encoding(env, cands).problem, dev)


def _shaped(name, inputs, kw, rows_a, rows_b):
    """The inputs at rows_a x rows_b pairs (K3: nodes x groups, K2: types x
    combined rows of one template): their first rows, repeated from the
    start where the shape has more; None for K2 inputs of more than one
    template."""
    import torch
    from karpenter_tpu_torch.ops.feasibility import Enc

    def take(n, have, dev):
        return torch.arange(n, device=dev) % have

    def rows(e, idx):
        return Enc(*(x[idx].contiguous() for x in e))
    if name == "exist_feasibility":
        group, group_req, exist, exist_avail, tol_exist = inputs
        g = take(rows_b, group.mask.shape[0], tol_exist.device)
        n = take(rows_a, exist.mask.shape[0], tol_exist.device)
        return (rows(group, g), group_req[g].contiguous(), rows(exist, n),
                exist_avail[n].contiguous(),
                tol_exist[g][:, n].contiguous()), kw
    (cmb, compat_tm, it, group_req, daemon, alloc, template_its, off_zone,
     off_captype, off_avail, zone_values, tol_template) = inputs
    if compat_tm.shape[0] != 1:
        return None
    g = take(rows_b, compat_tm.shape[1], compat_tm.device)
    t = take(rows_a, it.mask.shape[0], compat_tm.device)
    return (rows(cmb, g), compat_tm[:, g].contiguous(), rows(it, t),
            group_req[g].contiguous(), daemon, alloc[t].contiguous(),
            template_its[:, t].contiguous(), off_zone[t].contiguous(),
            off_captype[t].contiguous(), off_avail[t].contiguous(),
            zone_values, tol_template[g].contiguous()), kw


@contextlib.contextmanager
def _patched(module, **values):
    old = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def _held_ms(name, inputs, kw):
    """(least, most) of three kernel_ms measurements of one launch plan,
    after its outputs are held equal to the plain version."""
    import torch
    from karpenter_tpu_torch.ops import kernels
    launch, outs = kernels.launcher(name, *inputs, **kw)
    launch()
    torch.cuda.synchronize()
    # B5's plain versions are the feasibility module's own functions
    plain = getattr(kernels, f"{name}_plain", None) or getattr(kernels.feas,
                                                              name)
    want = plain(*inputs, **kw)
    assert all(torch.equal(a, b) for a, b in zip(outs, want)), \
        f"{name}: kernel and plain version disagree"
    times = [cs._kernel_ms(launch) for _ in range(3)]
    return [min(times), max(times)]


def plans(smoke_output: str, dev) -> None:
    from karpenter_tpu_torch.ops import kernels
    line = next(json.loads(x) for x in open(smoke_output)
                if x.startswith('{"phase": "join_plans"'))
    shapes: dict = {}
    for path_tiles in line["paths"].values():
        for name, ra_, rb_, K, W, ra, rb, stages, n in path_tiles:
            key = (name, ra_, rb_, K, W)
            shapes.setdefault(key, [f"{ra}x{rb}", stages, 0])[2] += n
    bases = {}
    for make in (north_star, disruption):
        made = make(dev)
        inputs = made["exist_feasibility"][0]
        bases[tuple(inputs[0].mask.shape[1:])] = made
    for (name, rows_a, rows_b, K, W), (tile, stages, n) in sorted(
            shapes.items()):
        row = {"kernel": name, "rows_a": rows_a, "rows_b": rows_b, "K": K,
               "W": W, "launches": n, "plan": tile, "stages": stages}
        base = bases.get((K, W))
        cut = base and _shaped(name, *base[name], rows_a, rows_b)
        if not cut:
            print(json.dumps({**row, "ms": "no inputs of this shape"}),
                  flush=True)
            continue
        row["ms"] = {}
        for ra, rb in kernels.JOIN_MICRO_TILES[name]:
            with _patched(kernels, JOIN_MICRO_TILES={
                    **kernels.JOIN_MICRO_TILES, name: ((ra, rb),)}):
                try:
                    row["ms"][f"{ra}x{rb}"] = _held_ms(name, *cut)
                except kernels.KernelError as e:
                    row["ms"][f"{ra}x{rb}"] = f"refused: {e}"
        if stages == K:
            ra, rb = map(int, tile.split("x"))
            with _patched(kernels, RESIDENT_SMEM=0, JOIN_MICRO_TILES={
                    **kernels.JOIN_MICRO_TILES, name: ((ra, rb),)}):
                row["two_stage_ms"] = _held_ms(name, *cut)
        print(json.dumps(row), flush=True)


def _variant_times(variants: dict, cases: dict) -> None:
    """One JSON line per variant: each case's kernel_ms on a build of the
    sources with the variant's edits (the sources' own launch held equal to
    the plain version first)."""
    from karpenter_tpu_torch.ops import kernels
    sources = kernels.CSRC
    try:
        for variant, edits in variants.items():
            csrc = kernels.BUILD_DIR / "ablation" / variant.replace(" ", "_")
            shutil.rmtree(csrc, ignore_errors=True)
            shutil.copytree(sources, csrc)
            for name, text, replacement in edits:
                src = (csrc / name).read_text()
                assert text in src, f"{variant}: {text!r} not in {name}"
                (csrc / name).write_text(src.replace(text, replacement))
            kernels.CSRC, kernels._LIB = csrc, None
            row = {"variant": variant}
            for name, (inputs, kw) in cases.items():
                if edits:
                    launch, _ = kernels.launcher(name, *inputs, **kw)
                    row[f"{name}_ms"] = cs._kernel_ms(launch)
                else:
                    row[f"{name}_ms"] = _held_ms(name, inputs, kw)[0]
            print(json.dumps(row), flush=True)
    finally:
        kernels.CSRC, kernels._LIB = sources, None


def variants(dev) -> None:
    _variant_times(VARIANTS, north_star(dev))


def fits(dev) -> None:
    """fits_matrix at chip_smoke.py's solve shape: the groups' requests
    against the padded node rows of the solve with nodes."""
    _, group_req, _, exist_avail, _ = north_star(dev)[
        "exist_feasibility"][0]
    _variant_times(FITS_VARIANTS,
                   {"fits_matrix": ((group_req, exist_avail), {})})


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("join_ablation: CUDA is not available")
    if sys.argv[1:2] not in (["variants"], ["plans"], ["fits"]) \
            or len(sys.argv) != 2 + (sys.argv[1] == "plans"):
        sys.exit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    if sys.argv[1] == "plans":
        plans(sys.argv[2], dev)
    elif sys.argv[1] == "fits":
        fits(dev)
    else:
        variants(dev)


if __name__ == "__main__":
    main()
