#!/usr/bin/env python3
"""End-to-end smoke run of karpenter_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written feasibility kernels from ops/csrc (nvcc, sm_90a,
into build/kernels), holds each kernel against its plain PyTorch version on
the card at the north-star shapes, then drives the provisioning solve the
way a user calls it — TensorScheduler(...).solve(pods) on cuda — for 49,920
pending pods of the benchmark mix against a 2,000-type catalog, cold and
against 5,000 existing nodes. It checks that the kernels carried the solve
(launch counts), that nothing fell back to the host oracle, and that the
decisions equal the same solves run on the CPU through the plain versions.

Each phase prints one JSON line. The line before last is the kernel table;
the last line is {"ok": true, "device": {...}}. Any failure raises and exits
non-zero; without CUDA it exits non-zero before printing a result.
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import subprocess
import sys
import time

DEVICE = "cuda"
N_PODS = 50_000
N_DEPLOYS = 120
N_ITS = 2_000
N_NODES = 5_000
SEED = 7
REPEATS = 3
KERNEL_RUNS = 20

# NVIDIA H100 SXM: the HBM rate of the data sheet, and the peak INT32 rate
# outside the tensor cores of NVIDIA's H100 architecture whitepaper (33.5
# TOPS: 64 INT32 lanes per SM x 132 SMs x 1.98 GHz x 2, a multiply-add
# counted as two operations). The feasibility kernels do 32-bit integer
# work; acc |= x & y is one three-input LOP3 instruction, counted as its two
# operations, which keeps the count in the peak's unit.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12

_CPUS = ["50m", "100m", "250m", "500m", "1000m"]
_MEMS = ["64Mi", "128Mi", "256Mi", "512Mi", "1Gi"]


# --------------------------------------------------------------------------
# workload
# --------------------------------------------------------------------------

def bench_pods(n_pods: int = N_PODS, n_deploys: int = N_DEPLOYS) -> list:
    """The benchmark pod mix: n_deploys deployments of n_pods // n_deploys
    identical pods, cycling through nine kinds — generic, zonal spread,
    hostname spread, hostname affinity, zonal affinity, hostname
    anti-affinity (the reference's scheduling benchmark mix), minDomains
    spread, zonal spread + hostname anti-affinity, and a spread whose
    selector matches other pods."""
    from karpenter_tpu_torch.api import labels as L, objects as o
    from karpenter_tpu_torch.utils import resources as res
    pods = []
    n_deploys = min(n_deploys, max(1, n_pods))
    per = max(1, n_pods // n_deploys)
    for d in range(n_deploys):
        labels = {"app": f"deploy-{d}"}
        sel = o.LabelSelector(match_labels=dict(labels))
        spread, affinity = [], None
        kind = d % 9
        zone_spread = o.TopologySpreadConstraint(
            topology_key=L.LABEL_TOPOLOGY_ZONE, max_skew=1, label_selector=sel)
        host_anti = o.Affinity(pod_anti_affinity=o.PodAffinity(required=[
            o.PodAffinityTerm(topology_key=L.LABEL_HOSTNAME,
                              label_selector=sel)]))
        if kind == 1:
            spread = [zone_spread]
        elif kind == 2:
            spread = [o.TopologySpreadConstraint(
                topology_key=L.LABEL_HOSTNAME, max_skew=1, label_selector=sel)]
        elif kind == 3:
            affinity = o.Affinity(pod_affinity=o.PodAffinity(required=[
                o.PodAffinityTerm(topology_key=L.LABEL_HOSTNAME,
                                  label_selector=sel)]))
        elif kind == 4:
            affinity = o.Affinity(pod_affinity=o.PodAffinity(required=[
                o.PodAffinityTerm(topology_key=L.LABEL_TOPOLOGY_ZONE,
                                  label_selector=sel)]))
        elif kind == 5:
            affinity = host_anti
        elif kind == 6:
            spread = [o.TopologySpreadConstraint(
                topology_key=L.LABEL_TOPOLOGY_ZONE, max_skew=1, min_domains=4,
                label_selector=sel)]
        elif kind == 7:
            spread, affinity = [zone_spread], host_anti
        elif kind == 8:
            spread = [o.TopologySpreadConstraint(
                topology_key=L.LABEL_TOPOLOGY_ZONE, max_skew=1,
                label_selector=o.LabelSelector(
                    match_labels={"app": f"unrelated-{d}"}))]
        requests = res.parse_list({"cpu": _CPUS[d % 5],
                                     "memory": _MEMS[d % 5]})
        for i in range(per):
            pods.append(o.Pod(
                metadata=o.ObjectMeta(name=f"p-{d}-{i}", namespace="default",
                                      labels=dict(labels)),
                spec=o.PodSpec(topology_spread_constraints=list(spread),
                               affinity=affinity),
                container_requests=[requests]))
    return pods


def default_pool():
    from karpenter_tpu_torch.api import nodepool as np_
    from karpenter_tpu_torch.api.objects import ObjectMeta
    return np_.NodePool(
        metadata=ObjectMeta(name="default"),
        spec=np_.NodePoolSpec(template=np_.NodeClaimTemplate(
            spec=np_.NodeClaimTemplateSpec())))


def existing_nodes(catalog, n: int = N_NODES, seed: int = SEED) -> list:
    """n initialized nodes of the default pool: instance types drawn (seeded)
    from the catalog, spread round-robin over the four kwok zones and both
    capacity types, each carrying one bound pod that uses 30-90% of its cpu
    and memory."""
    import random
    from karpenter_tpu_torch.api import labels as L, objects as o
    from karpenter_tpu_torch.cloudprovider.kwok import KWOK_ZONES
    from karpenter_tpu_torch.state.statenode import StateNode
    from karpenter_tpu_torch.utils import resources as res
    rng = random.Random(seed)
    zones = list(KWOK_ZONES)
    cts = [L.CAPACITY_TYPE_SPOT, L.CAPACITY_TYPE_ON_DEMAND]
    nodes = []
    for i in range(n):
        it = catalog[rng.randrange(len(catalog))]
        name = f"node-{i:05d}"
        labels = {key: it.requirements.get(key).values_list()[0]
                  for key in it.requirements
                  if len(it.requirements.get(key).values_list()) == 1}
        labels.update({
            L.LABEL_HOSTNAME: name,
            L.NODEPOOL_LABEL_KEY: "default",
            L.NODE_INITIALIZED_LABEL_KEY: "true",
            L.LABEL_TOPOLOGY_ZONE: zones[i % len(zones)],
            L.CAPACITY_TYPE_LABEL_KEY: cts[(i // len(zones)) % 2],
        })
        alloc = it.allocatable()
        sn = StateNode(node=o.Node(
            metadata=o.ObjectMeta(name=name, namespace="", labels=labels),
            spec=o.NodeSpec(provider_id=f"smoke://{name}"),
            status=o.NodeStatus(capacity=dict(it.capacity),
                                allocatable=dict(alloc))))
        used = rng.uniform(0.3, 0.9)
        sn.update_pod(o.Pod(
            metadata=o.ObjectMeta(name=f"bound-{i:05d}", namespace="default"),
            spec=o.PodSpec(node_name=name),
            container_requests=[{
                res.CPU: int(alloc[res.CPU] * used),
                res.MEMORY: int(alloc[res.MEMORY] * used)}]))
        nodes.append(sn)
    return nodes


# --------------------------------------------------------------------------
# measurement helpers
# --------------------------------------------------------------------------

def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _time_ms(fn, runs: int = KERNEL_RUNS, warmup: int = 3) -> float:
    """Median of `runs` CUDA-event-timed calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _flat(out) -> list:
    """Nested tuples of tensors (a wrapper's inputs or outputs) as one flat
    list."""
    flat = []
    for x in out:
        flat.extend(_flat(x) if isinstance(x, tuple) else (x,))
    return flat


def _compare(kernel_out, plain_out):
    """(equal, max_abs_err) over every output tensor, compared as int64."""
    import torch
    equal, err = True, 0
    for a, b in zip(_flat(kernel_out), _flat(plain_out), strict=True):
        equal &= a.dtype == b.dtype and a.shape == b.shape \
            and torch.equal(a, b)
        if a.shape == b.shape and a.numel():
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                               .abs().max()))
    return bool(equal), err


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in _flat(tensors))


def _bound(bytes_moved: int, ops: int):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _profile(fn) -> dict:
    """One call of fn under torch.profiler: device time and event count by
    kernel name, and the device's idle share of the call's wall time (busy
    = the summed durations of the device events; they do not overlap on
    one stream)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (ms + ev.time_range.elapsed_us() / 1e3, n + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if by_name else None,
            "device_ms_by_name": {k[:60]: v for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1][0])}}


def _errors_by_kind(pods, results) -> dict:
    """{"kind K: message": pods} over the solve's pod errors, K the
    bench_pods kind (deployment index mod 9) of the failing pod."""
    kind = {p.uid: int(p.metadata.labels["app"].split("-")[1]) % 9
            for p in pods}
    return dict(collections.Counter(
        f"kind {kind[uid]}: {msg}" for uid, msg in results.pod_errors.items()))


def _solve(ts_mod, pool, catalog, pods, nodes, device):
    ts = ts_mod.TensorScheduler([pool], {"default": catalog},
                                state_nodes=nodes, force_tensor=True,
                                device=device)
    t0 = time.perf_counter()
    results = ts.solve(pods)
    if device != "cpu":
        import torch
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    assert ts.fallback_reason == "", f"fell back: {ts.fallback_reason}"
    assert ts.partition == (len(pods), 0), ts.partition
    return ts, results, elapsed


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from karpenter_tpu_torch.flightrec.record import decision_digest
    from karpenter_tpu_torch.obs.tracer import TRACER, phase_millis
    from karpenter_tpu_torch.ops import binpack, kernels
    from karpenter_tpu_torch.provisioning import tensor_scheduler as ts_mod
    from karpenter_tpu_torch.provisioning.grouping import partition_pods
    from karpenter_tpu_torch.cloudprovider.kwok import construct_catalog

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    _emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
           "count": torch.cuda.device_count(),
           "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build
    t0 = time.perf_counter()
    built = kernels.build()
    _emit({"phase": "build", "seconds": time.perf_counter() - t0,
           "built": built})

    # the north-star problems: 49,920 pods x 2,000 types, cold and with
    # 5,000 existing nodes
    catalog = construct_catalog(N_ITS)
    pool = default_pool()
    pods = bench_pods()
    nodes = existing_nodes(catalog)
    dev = torch.device(DEVICE)
    groups, leftover, _ = partition_pods(pods)
    assert not leftover, f"{len(leftover)} pods left for the host path"
    ts_cold = ts_mod.TensorScheduler([pool], {"default": catalog},
                                     force_tensor=True, device=DEVICE)
    problem, _, _ = ts_cold.build_problem(groups)
    ts_exist = ts_mod.TensorScheduler([pool], {"default": catalog},
                                      state_nodes=nodes, force_tensor=True,
                                      device=DEVICE)
    problem_x, _, _ = ts_exist.build_problem(groups)
    args, statics = binpack.device_args(problem, binpack.ArgPlacer(dev))
    (group, template, it, group_req, daemon, alloc, template_its, off_zone,
     off_captype, off_avail, zone_values, allow_undef, tol_template,
     _, _, _) = args
    args_x, statics_x = binpack.device_args(problem_x, binpack.ArgPlacer(dev))
    assert statics_x["has_exist"]
    exist, exist_avail, tol_exist = args_x[13:]
    G, M, T = group.mask.shape[0], template.mask.shape[0], it.mask.shape[0]
    K, W = group.mask.shape[1:]
    R, O, Z = group_req.shape[1], off_zone.shape[1], zone_values.shape[0]
    N = exist.mask.shape[0]
    shapes = dict(G=G, M=M, T=T, K=K, W=W, R=R, O=O, Z=Z, N=N)
    _emit({"phase": "shapes", **shapes, "pods": len(pods),
           "nodes": len(nodes)})

    # 3. each kernel against its plain version on the same CUDA tensors
    cat = dict(zone_key=problem.zone_key, captype_key=problem.captype_key)
    k1 = lambda: kernels.combine_compat(template, group, allow_undef)  # noqa: E731
    k1p = lambda: kernels.combine_compat_plain(template, group, allow_undef)  # noqa: E731
    cmb, compat_tm = k1()
    k2_in = (cmb, compat_tm, it, group_req, daemon, alloc, template_its,
             off_zone, off_captype, off_avail, zone_values, tol_template)
    k2 = lambda: kernels.catalog_feasibility(*k2_in, **cat)  # noqa: E731
    k2p = lambda: kernels.catalog_feasibility_plain(*k2_in, **cat)  # noqa: E731
    k3_in = (group, group_req, exist, exist_avail, tol_exist)
    k3 = lambda: kernels.exist_feasibility(*k3_in)  # noqa: E731
    k3p = lambda: kernels.exist_feasibility_plain(*k3_in)  # noqa: E731
    MG = M * G
    checks = {
        "combine_compat": dict(
            fns=(k1, k1p), replaces="karpenter_tpu/ops/binpack.py:160",
            bytes_in=_nbytes(template, group, allow_undef),
            ops=2 * MG * K * W + 12 * MG * K),
        "catalog_feasibility": dict(
            fns=(k2, k2p), replaces="karpenter_tpu/ops/binpack.py:160",
            bytes_in=_nbytes(*k2_in),
            ops=MG * T * (2 * K * W + 8 * K + 3 * R + 2 * O * Z)),
        "exist_feasibility": dict(
            fns=(k3, k3p), replaces="karpenter_tpu/ops/binpack.py:616",
            bytes_in=_nbytes(*k3_in),
            ops=G * N * (2 * K * W + 9 * K + 2 * R)),
    }
    rows = {}
    for name, c in checks.items():
        kern, plain = c["fns"]
        out_k = kern()
        out_p = plain()
        torch.cuda.synchronize()
        equal, err = _compare(out_k, out_p)
        assert equal, f"{name}: kernel and plain version disagree (max " \
                      f"abs err {err})"
        bound_ms, bound_by = _bound(c["bytes_in"] + _nbytes(out_k), c["ops"])
        rows[name] = {
            "name": name, "route": "cuda",
            "source": f"karpenter_tpu_torch/ops/csrc/{name}.cu",
            "replaces": c["replaces"], "launches": None,
            "max_abs_err": err, "equal": equal,
            "ms": _time_ms(kern), "plain_ms": _time_ms(plain),
            "device_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": c["bytes_in"] + _nbytes(out_k), "ops": c["ops"],
            "library_ms": None}
    _emit({"phase": "kernels_vs_plain", "kernels": [
        {"name": r["name"], "replaces": r["replaces"],
         "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
         "equal": r["equal"]} for r in rows.values()]})

    # 4 + 5. the main path: cold solve, then against existing nodes; the
    # launch counts are zeroed just before and read just after
    kernels.reset_launches()
    runs = {}
    for label, state in (("cold", ()), ("existing_nodes", nodes)):
        _solve(ts_mod, pool, catalog, pods, state, DEVICE)  # warm-up
        best = None
        for _ in range(REPEATS):
            ts, results, elapsed = _solve(ts_mod, pool, catalog, pods, state,
                                          DEVICE)
            if best is None or elapsed < best[0]:
                best = (elapsed, TRACER.last(), results)
        elapsed, trace, results = best
        runs[label] = results
        _emit({"phase": f"solve_{label}", "pods": len(pods),
               "instance_types": len(catalog), "existing_nodes": len(state),
               "best_s": elapsed, "pods_per_s": len(pods) / elapsed,
               "nodes_launched": len(results.new_nodeclaims),
               "existing_used": sum(1 for en in results.existing_nodes
                                    if en.pods),
               "errors": len(results.pod_errors),
               "errors_by_kind": _errors_by_kind(pods, results),
               "phases_ms": phase_millis(trace) if trace else {}})
    launches = dict(kernels.LAUNCHES)
    _emit({"phase": "main_path_launches", **launches})
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the main path"
        rows[name]["launches"] = n

    # device time and idle share of one solve of each kind, from a trace;
    # each kernel's device time per launch from the solve with nodes, which
    # launches all three
    for label, state in (("cold", ()), ("existing_nodes", nodes)):
        prof = _profile(
            lambda: _solve(ts_mod, pool, catalog, pods, state, DEVICE))
        _emit({"phase": f"profile_{label}", **prof})
    for name, row in rows.items():
        ms, n = next((v for k, v in prof["device_ms_by_name"].items()
                      if k.startswith(f"{name}_kernel")), (None, 0))
        row["device_ms"] = ms / n if n else None

    # exist_delta on the card against the plain version
    ok_d, cap_d = binpack.exist_delta(problem_x, device=DEVICE)
    ok_p, cap_p = kernels.exist_feasibility_plain(*k3_in)
    delta_equal = bool((ok_d == ok_p.cpu().numpy()).all()
                       and (cap_d == cap_p.cpu().numpy()).all())
    assert delta_equal, "exist_delta disagrees with the plain version"
    _emit({"phase": "exist_delta", "N": N, "equal": delta_equal})

    # 6. decisions on the card == decisions through the plain versions on
    # the CPU
    digests = {}
    for label, state in (("cold", ()), ("existing_nodes", nodes)):
        _, cpu_results, cpu_s = _solve(ts_mod, pool, catalog, pods, state,
                                       "cpu")
        d_gpu = decision_digest(runs[label], pods, "", (len(pods), 0))
        d_cpu = decision_digest(cpu_results, pods, "", (len(pods), 0))
        assert d_gpu == d_cpu, f"{label}: cuda and cpu decisions differ"
        digests[label] = {"equal": True, "claims": len(d_gpu["claims"]),
                          "cpu_solve_s": cpu_s}
    _emit({"phase": "decisions", **digests})

    # 7. the kernel table and the verdict
    _emit({"kernels": list(rows.values())})
    _emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                  "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
