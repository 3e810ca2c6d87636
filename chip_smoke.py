#!/usr/bin/env python3
"""End-to-end smoke run of karpenter_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ops/csrc (nvcc, sm_90a, into
build/kernels), holds each kernel against its plain PyTorch version on the
card at the north-star shapes, then drives the provisioning solve the way a
user calls it — TensorScheduler(...).solve(pods) on cuda — for 49,920
pending pods of the benchmark mix against a 2,000-type catalog:

- cold and against 5,000 existing nodes on one device;
- against the nodes through a 1x1 solver mesh (``make_solver_mesh()``);
- pass after pass through a persistent ProblemState, on one device and on
  an 8-slot mesh over the one card (a 4x2 grid: four exist-row shards), in
  windows of three kinds: a wobble of the batch, node churn inside one
  shard's rows, and a rollout (a new deployment plus node churn), each
  held to a cold solve of the same inputs;
- cold with the pods/groups-sharded pack (``pack_shards=4``).

Then it drives the loops that call the solve, on a live cluster (a kube
store whose informers feed the cluster state, the kwok provider, a fake
clock):

- the Provisioner: the same 49,920 pending pods through
  ``Provisioner.reconcile``, cold and then warm after a rollout arrives;
- multi-node consolidation over 5,000 underutilized nodes x the kwok
  144-type catalog (BASELINE.json config 4);
- single-node consolidation over 5,000 candidates of which only the last
  can go;
- the DisruptionController (all four methods) over such a fleet: a cold
  pass, then warm passes served by its streaming state;
- the Operator, as its users run it: the whole controller roster over the
  kwok provider (2,000 types, attached to the operator's own store) and
  the 49,920 pods of the benchmark mix, stepped until every pod that can
  be placed is bound, then every other pod of each deployment deleted and
  the clock moved past the consolidation TTL until a disruption command
  has executed and the cluster is quiet again; every step's store held to
  the same step of the same operator on the CPU.

Then the solver sidecar, the process the north-star deployment calls over
gRPC (karpenter_tpu_torch/sidecar), on the card:

- ``sidecar``: a SolverSession over 127.0.0.1 to an in-process server on
  cuda: the 49,920-pod batch cold, then with the 5,000 nodes as state
  deltas (each equal to the in-process solve), then one window of each
  kind, each carrying the server's parity re-solve and equal to a cold
  in-process solve of the same inputs; request and response bytes, the
  server's spans and launches per step;
- ``sidecar_fleet``: two replicas sharing a handoff store; after the first
  two steps the home replica drains, the client follows the
  ``migrated_to`` rider, and the peer restores the session from its
  checkpoint with no resync, its next solve equal to the in-process one;
- ``sidecar_process``: ``python -m karpenter_tpu_torch.sidecar.server
  --device cuda --port 0`` as a child process, one cold full-width
  session solve equal to the sidecar's first, then SIGINT;
- ``operator_sidecar``: the Operator with ``solver_backend="sidecar"``
  against an in-process server, at 1,248 pods (6 deployments x 208, cut
  from the operator phase's 49,920) x 2,000 types, burst and scale-down,
  every step's store equal to the same run on the CPU, beside the tensor
  backend's final store.

Then the fleet simulator (karpenter_tpu_torch/sim), which drives the whole
operator through a timeline of events on an accelerated clock, on the
card:

- ``sim_pinned``: the four clips pinned in tests/goldens/sim-regression.json
  (mixed-day, disruption-wave, service-fleet with its three sidecar
  replicas, state-chaos with its warm-state corruptions and a device-loss
  window on an 8-slot mesh over the card), each ledger digest and entry
  count equal to the JAX package's pin; state-chaos replayed on the CPU
  too, its injected, detected and healed counts equal to the card's;
- ``sim_mixed_day``: mixed-day's whole 24 h, the JAX package's digest, at
  least 100x faster than simulated time, one SLO breach with one flight
  dump that joins the ledger; then its first 21,600 s again, the JAX
  package's digest of that clip and the day's first ledger entries.

And the mesh across processes: ``mesh_multiprocess``, two processes joined
by ``init_multihost`` (gloo over 127.0.0.1), each with its own CUDA context
on the card and four slots of one 4x2 mesh, solving the 49,920-pod batch
cold, each process's decisions equal to the one-process cold solve's.

Then the Operator as Karpenter is deployed, over a kube-apiserver's REST
and watch wire (``store_backend="kube"``) against the port's in-process
EnvtestServer on 127.0.0.1, with the CRDs of ``python -m
karpenter_tpu_torch.api.crds`` posted and a kubeconfig naming it:

- ``operator_kube``: the burst and the scale-down of the operator phase at
  KUBE_PODS = 480 pods (all 120 deployments and nine kinds of the mix, so
  K1-K3 run at the north star's widths) x 2,000 types, on the server's fake
  clock, each step driven to quiescence over the wire (KubeWire); every
  step's normalised apiserver state equal to the same drive on the CPU,
  with the requests, their milliseconds, the watch events and the wire's
  seconds beside the solve's;
- ``operator_kube_process``: ``python -m karpenter_tpu_torch.operator
  --device cuda --store-backend kube --kubeconfig <file> --leader-elect``
  as a child process (the CLI's kwok catalog, the real clock, a KubeLease
  over the wire): every pod of a 480-pod burst bound, the child's first
  provisioning record fetched from /debug/flightrecorder and replayed here
  on the card to a match, exit code 0 on SIGINT.

It checks that the kernels carried every path (launch counts, zeroed just
before each path and read just after; the sidecar's gRPC worker threads
launch them too, and the mesh processes count their own), that nothing
fell back to the host
oracle, and that the decisions equal the same solves, passes and commands
run on the CPU through the plain versions, or cold solves on the card. The
two kernels with no caller on any path (fits_matrix, offering_compat) are
held against their plain versions at the solve's shapes and count no
launches.

Every kernel is also timed alone (``kernel_ms``: back-to-back launches on
prepared inputs, replayed from a CUDA graph; ``cold_ms``: one launch after a
128 MB buffer is written, so the inputs come from HBM) beside its bound; K1
once more on the inputs of a 4x2 mesh slot (32 groups), and K1-K3 at the
disruption encode's shapes (G padded to 8, W = 8), held against their plain
versions there too. The register tile of each K2 / K3 launch of the paths,
and the geometry of each K1 launch, are printed by path and shape
(``join_plans``). The redesigned fits_matrix (B5a) is held at its edge
shapes too (``fits_matrix``: B of 1, 7, 120, 121 and 4,096, A of 1 and
8,192, R of 1, 4 and 9; zero, negative, INT_MIN and INT_MAX requests).

After the paths, the port's observability on the card:

- ``device_attribution``: the cold solve and the solve with nodes traced
  and untraced (equal digests and launches), obs.device.DEVICE_TIME's
  entries, each peak held within 2x of the allocator's growth over a first
  launch;
- ``profile_provisioner_pass``: one north-star Provisioner pass with
  ``profile_dir`` under build/, its Chrome trace naming K1 and K2, its
  decisions equal to the unprofiled pass's;
- ``flight_recorder``: a FlightRecorder on the north-star Provisioner passes
  and on DisruptionController passes over 5,000 nodes (each record's
  decision equal to its pass's, the capture's cost, the JSONL bytes), and
  every disruption record and one 1,248-pod provisioning record replayed on
  the card to a match.

Each phase prints JSON lines. The line before last is the kernel table; the
last line is {"ok": true, "device": {...}}. Any failure raises and exits
non-zero; without CUDA it exits non-zero before printing a result.

``python3 chip_smoke.py --operator-kube-pods N [N ...]`` builds the kernels
and runs only ``operator_kube`` at N pods (120 deployments) for each N,
with the same holds, then stops: a probe of the wire's cost at other
sizes, with no kernel table and no result line.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import statistics
import subprocess
import sys
import threading
import time

DEVICE = "cuda"
N_PODS = 50_000
N_DEPLOYS = 120
N_ITS = 2_000
N_NODES = 5_000
SEED = 7
REPEATS = 3
KERNEL_RUNS = 20
# the warm passes (bench.py's meshchurn and stateplane modes): after a cold
# pass 0, WINDOW_REPEATS rounds of the three window kinds; every window
# moves WOBBLE pods between deployments, and node_churn and rollout windows
# give CHURN_ROWS nodes of one exist shard's rows one more bound pod (3
# rounds until the script's length needed the time)
WINDOW_KINDS = ("wobble", "node_churn", "rollout")
WINDOW_REPEATS = 2
WOBBLE = 24
CHURN_ROWS = 64
CHURN_SHARD = 1
# the warm mesh: MESH_SLOTS slots on the one card, a 4x2 grid
MESH_SLOTS = 8
PACK_SHARDS = 4

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


def _more_pods(p, names) -> list:
    """Pods of p's deployment (same labels, spec and requests) named
    ``names``."""
    import dataclasses
    from karpenter_tpu_torch.api import objects as o
    return [o.Pod(metadata=o.ObjectMeta(name=name, namespace=p.namespace,
                                        labels=dict(p.metadata.labels)),
                  spec=dataclasses.replace(p.spec),
                  container_requests=list(p.container_requests))
            for name in names]


def rollout_deployment(window: int, n_pods: int) -> list:
    """A new generic deployment of n_pods pods, its requests a shape the
    benchmark mix does not have."""
    from karpenter_tpu_torch.api import objects as o
    from karpenter_tpu_torch.utils import resources as res
    probe = o.Pod(metadata=o.ObjectMeta(
        name=f"r-{window}-0", namespace="default",
        labels={"app": f"rollout-{window}"}),
        container_requests=[res.parse_list(
            {"cpu": "750m", "memory": f"{640 + window}Mi"})])
    return [probe] + _more_pods(probe, [f"r-{window}-{j}"
                                        for j in range(1, n_pods)])


def churn_node_rows(nodes, span, window: int) -> int:
    """One more bound pod on CHURN_ROWS nodes whose exist rows lie in
    ``span`` (a node's row is its index); returns the distinct nodes
    touched."""
    from karpenter_tpu_torch.api import objects as o
    from karpenter_tpu_torch.utils import resources as res
    start, stop = span[0], min(span[1], len(nodes))
    touched = set()
    for j in range(CHURN_ROWS):
        i = start + (window * 131 + j * 977) % (stop - start)
        sn = nodes[i]
        sn.update_pod(o.Pod(
            metadata=o.ObjectMeta(name=f"churn-{window}-{j}",
                                  namespace="default"),
            spec=o.PodSpec(node_name=sn.name()),
            container_requests=[res.parse_list({"cpu": "50m",
                                                "memory": "64Mi"})]))
        touched.add(i)
    return len(touched)


def churn_windows(pods, nodes, span):
    """(pass, window kind, batch, node rows changed) for pass 0 (the base
    batch) and then WINDOW_REPEATS rounds of WINDOW_KINDS, changing
    ``nodes`` in place before a node_churn or rollout window. Every window
    moves WOBBLE pods: three deployments lose WOBBLE // 3 pods each and
    three others gain as many. Rollout deployments stay once they arrive.
    Each window is a function of its index alone, so two runs over fresh
    copies of the nodes see the same inputs."""
    by_app: dict = {}
    for p in pods:
        by_app.setdefault(p.metadata.labels["app"], []).append(p)
    apps = list(by_app)
    per = len(pods) // len(apps)
    step = WOBBLE // 3
    rollouts: list = []
    yield 0, "cold", list(pods), 0
    for i in range(1, 1 + WINDOW_REPEATS * len(WINDOW_KINDS)):
        kind = WINDOW_KINDS[(i - 1) % len(WINDOW_KINDS)]
        dirty = churn_node_rows(nodes, span, i) if kind != "wobble" else 0
        if kind == "rollout":
            rollouts.extend(rollout_deployment(i, per))
        batch = dict(by_app)
        for k in range(3):
            a = apps[(7 * i + 41 * k) % len(apps)]
            b = apps[(7 * i + 41 * k + 13) % len(apps)]
            batch[a] = batch[a][:-step]
            batch[b] = batch[b] + _more_pods(
                batch[b][0], [f"{b}-w{i}-{k}-{j}" for j in range(step)])
        yield i, kind, [p for ps in batch.values() for p in ps] + rollouts, \
            dirty


# --------------------------------------------------------------------------
# measurement helpers
# --------------------------------------------------------------------------

#: seconds from the start of the script to each phase's first line
PHASE_AT: dict = {}
_T0 = time.perf_counter()
#: the checkout this script runs from
_ROOT = os.path.dirname(os.path.abspath(__file__))


def _emit(obj) -> None:
    PHASE_AT.setdefault(obj.get("phase"), time.perf_counter() - _T0)
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


def _kernel_ms(launch, launches: int = KERNEL_RUNS, replays: int = 10
               ) -> float:
    """A kernel's own time: ``launches`` back-to-back launches of it
    (kernels.launcher: no checks, allocation or count) captured in one CUDA
    graph, so the host's launch cost does not pace them; CUDA events around
    ``replays`` replays of the graph, per launch."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            launch()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (launches * replays)


#: SM clocks of the spin after the flush write in _cold_ms (about half a
#: millisecond at 1.98 GHz): longer than the host takes to enqueue an event
#: and a launch, which the write alone (about 40 us) need not be. The spin
#: is torch.cuda._sleep, a private PyTorch call (one kernel that counts
#: clocks); should a PyTorch release drop it, _cold_ms fails loudly
COLD_SPIN_CYCLES = 1_000_000


def _cold_ms(launch, flush, runs: int = KERNEL_RUNS) -> float:
    """Median time of one launch after ``flush`` (a device buffer larger
    than the 50 MB L2) has been written, so the inputs come from HBM. The
    write and a spin kernel after it keep the card busy while the host
    enqueues the start event and the launch, so the events time the kernel
    and not the host."""
    import torch
    launch()
    times = []
    for i in range(runs):
        flush.fill_(i)
        torch.cuda._sleep(COLD_SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(prof: dict, name: str):
    """Device ms per launch of the kernel ``name`` in a _profile() result,
    over every instantiation of a template kernel (whose names start with
    their return type), or None when the trace holds none."""
    hits = [v for k, v in prof["device_ms_by_name"].items()
            if f"{name}_kernel" in k.split("(")[0]]
    n = sum(count for _, count in hits)
    return sum(ms for ms, _ in hits) / n if n else None


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


def _solve(ts_mod, pool, catalog, pods, nodes, device, **kw):
    """One solve as a user makes it, forced onto the tensor path; ``kw``
    passes mesh=, problem_state= or pack_shards= through. Returns
    (scheduler, results, seconds)."""
    ts = ts_mod.TensorScheduler([pool], {"default": catalog},
                                state_nodes=nodes, force_tensor=True,
                                device=device, **kw)
    t0 = time.perf_counter()
    results = ts.solve(pods)
    if ts.device.type == "cuda":
        import torch
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    assert ts.fallback_reason == "", f"fell back: {ts.fallback_reason}"
    assert ts.partition == (len(pods), 0), ts.partition
    return ts, results, elapsed


def _top_spans(trace, n: int = 8) -> dict:
    """The n largest exclusive span times (ms) of a solve's trace."""
    from karpenter_tpu_torch.obs.tracer import phase_millis
    ms = phase_millis(trace) if trace else {}
    return dict(sorted(ms.items(), key=lambda kv: -kv[1])[:n])


def _rungs() -> dict:
    """The device-loss ladder's counters: a solve that stayed on the mesh
    rung moves none of them."""
    from karpenter_tpu_torch.metrics.registry import STATE_AUDIT
    return {oc: STATE_AUDIT.value({"layer": "device", "outcome": oc})
            for oc in ("killed", "carve", "single")}


def resident_exist_equal(ts_mod, pool, catalog, batch, nodes, mesh) -> int:
    """Hold the sharded state's resident exist-side buffers (what the mesh
    placer uploaded and row_splice patched in place) to the host rows of
    the same nodes, encoded cold; returns the devices checked."""
    import numpy as np
    import torch
    from karpenter_tpu_torch.ops import binpack, feasibility as feas
    from karpenter_tpu_torch.parallel.mesh import mesh_cache_key
    from karpenter_tpu_torch.provisioning.grouping import partition_pods
    ts = ts_mod.TensorScheduler([pool], {"default": catalog},
                                state_nodes=nodes, force_tensor=True,
                                mesh=mesh)
    problem, _, _ = ts.build_problem(partition_pods(batch)[0])
    key = mesh_cache_key(mesh)
    slots = [v for k, v in problem.device_cache.items()
             if k[0] == "exist_shards" and k[2] == key]
    assert len(slots) == 1, "no resident sharded exist side"
    e = feas.host_enc(problem.exist_enc)
    host = [e.mask.view(np.int32), e.defined, e.complement, e.exempt, e.gt,
            e.lt, np.clip(problem.exist_avail, -binpack.INT32_MAX - 1,
                          binpack.INT32_MAX).astype(np.int32)]
    resident = slots[0][1]
    for leaves in resident.values():
        for buf, want in zip(leaves, host, strict=True):
            assert torch.equal(buf.cpu(), torch.from_numpy(want)), \
                "a resident exist leaf differs from the host rows"
    return len(resident)


#: what the precompute of each window kind must be served by
_PRECOMPUTE = {"cold": "computed", "wobble": "reused", "node_churn": "delta",
               "rollout": "computed"}


def warm_churn(ts_mod, pool, catalog, pods, nodes, span, device, mesh=None,
               cold_digests=None, phase="warm_churn"):
    """Drive churn_windows through one persistent ProblemState (on
    ``device``, or on ``mesh`` when given) and hold every pass to a cold
    solve of the same inputs: a fresh scheduler with no state, on the same
    device or mesh, and to ``cold_digests[pass]`` when given (the
    single-device cold digests). The last pass (a rollout) runs under the
    profiler. Prints one line per pass; returns (the cold digests, the
    per-pass records)."""
    from karpenter_tpu_torch.flightrec.record import decision_digest
    from karpenter_tpu_torch.metrics.registry import EXIST_SPLICE_BYTES
    from karpenter_tpu_torch.obs.tracer import TRACER
    from karpenter_tpu_torch.ops import kernels
    from karpenter_tpu_torch.parallel.mesh import PODS_GROUPS_AXIS
    from karpenter_tpu_torch.provisioning.problem_state import ProblemState
    ps = ProblemState()
    kw = dict(mesh=mesh) if mesh is not None else {}
    dev = None if mesh is not None else device
    slots = int(mesh.devices.size) if mesh is not None else 1
    rows = mesh.shape[PODS_GROUPS_AXIS] if mesh is not None else 1
    digests, records = [], []
    last_pass = WINDOW_REPEATS * len(WINDOW_KINDS)
    for i, kind, batch, dirty in churn_windows(pods, nodes, span):
        before = dict(kernels.LAUNCHES)
        spliced = {oc: EXIST_SPLICE_BYTES.value({"outcome": oc})
                   for oc in ("uploaded", "skipped")}
        out = {}
        prof = _profile(lambda: out.update(solved=_solve(
            ts_mod, pool, catalog, batch, nodes, dev, problem_state=ps,
            **kw))) if i == last_pass else None
        ts, r, s = out["solved"] if prof else _solve(
            ts_mod, pool, catalog, batch, nodes, dev, problem_state=ps, **kw)
        trace = TRACER.last()
        launched = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        spliced = {oc: EXIST_SPLICE_BYTES.value({"outcome": oc}) - v
                   for oc, v in spliced.items()}
        last = dict(ps.last)
        _, r_cold, cold_s = _solve(ts_mod, pool, catalog, batch, nodes, dev,
                                   **kw)
        cold_trace = TRACER.last()
        d = decision_digest(r, batch, "", ts.partition)
        d_cold = decision_digest(r_cold, batch, "", ts.partition)
        assert d == d_cold, f"{phase} pass {i} ({kind}): warm != cold"
        if cold_digests is not None:
            assert d == cold_digests[i], \
                f"{phase} pass {i} ({kind}): != the single-device cold solve"
        digests.append(d_cold)
        # what each window kind must take: the tensors memo whole, the
        # exist-only delta (K3 alone), or the full precompute (K1-K3 on
        # every slot, and on a sharded mesh one row_splice of the dirty
        # span while the clean spans stay resident)
        assert last["precompute"] == _PRECOMPUTE[kind], (phase, i, last)
        if i:
            assert last["encode_kind"] == "delta", (phase, i, last)
            assert last["node_rows_reencoded"] == dirty, (phase, i, last)
        want = {k: 0 for k in launched}
        if kind == "node_churn":
            want["exist_feasibility"] = 1
        elif kind in ("cold", "rollout"):
            want.update(combine_compat=slots, catalog_feasibility=slots,
                        exist_feasibility=rows)
            if kind == "rollout" and rows > 1:
                want["row_splice"] = 1
        assert launched == want, (phase, i, kind, launched, want)
        if kind == "rollout" and rows > 1:
            assert spliced["uploaded"] > 0, (phase, i, spliced)
            assert spliced["skipped"] == (rows - 1) * spliced["uploaded"], \
                (phase, i, spliced)
        resident = None
        if mesh is not None and rows > 1 and kind in ("cold", "rollout"):
            resident = resident_exist_equal(ts_mod, pool, catalog, batch,
                                            nodes, mesh)
        rec = {"pass": i, "window": kind, "s": s, "cold_s": cold_s,
               "pods": len(batch), "digest_equals_cold": True,
               **{k: last[k] for k in ("encode_kind", "node_rows_reencoded",
                                       "precompute", "warm",
                                       "warm_restored")},
               "shard_dirty": last.get("shard_dirty"),
               "launches": {k: v for k, v in launched.items() if v},
               "splice_bytes": spliced,
               "resident_devices_equal": resident,
               "spans_ms": _top_spans(trace, 16),
               "cold_spans_ms": _top_spans(cold_trace, 16)}
        if prof:
            rec["profile"] = prof
        _emit({"phase": phase, **rec})
        records.append(rec)
    ps.close()
    return digests, records


def _summary(records) -> dict:
    """Per window kind: the passes' wall seconds beside their cold solves',
    the medians, the median of the per-pass warm/cold ratios, and the
    median exclusive ms of each span of the warm passes and the cold
    ones; the profiled pass counts in none of the medians."""
    out: dict = {}
    for kind in ("cold",) + WINDOW_KINDS:
        recs = [r for r in records if r["window"] == kind
                and "profile" not in r]

        def spans(key):
            names = {n for r in recs for n in r[key]}
            return {n: statistics.median(r[key].get(n, 0.0) for r in recs)
                    for n in sorted(names)}

        out[kind] = {
            "s": [r["s"] for r in records if r["window"] == kind],
            "cold_s": [r["cold_s"] for r in records if r["window"] == kind],
            "s_median": statistics.median(r["s"] for r in recs),
            "cold_s_median": statistics.median(r["cold_s"] for r in recs),
            "ratio_median": statistics.median(r["s"] / r["cold_s"]
                                              for r in recs),
            "spans_ms_median": spans("spans_ms"),
            "cold_spans_ms_median": spans("cold_spans_ms")}
    return out


def _random_rows(rng, like, rows: int):
    """A CPU tensor of ``rows`` random rows shaped and typed like ``like``'s."""
    import numpy as np
    import torch
    shape = (rows,) + tuple(like.shape[1:])
    if like.dtype == torch.bool:
        return torch.from_numpy(rng.random(shape) < 0.5)
    return torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, shape,
                                         dtype=np.int64).astype(np.int32))


#: the feasibility kernels of the precompute (K1-K3)
FEASIBILITY = ("combine_compat", "catalog_feasibility", "exist_feasibility")

#: the tile plan of every K2 / K3 launch since the last _reset_counts():
#: (kernel, rows_a, rows_b, K, W, ra, rb, stages) -> launches
TILES: collections.Counter = collections.Counter()
#: the geometry of every K1 launch since the last _reset_counts():
#: (M, G, K, W, vec, lanes, threads) -> launches
K1_PLANS: collections.Counter = collections.Counter()


def _record_tiles(kernels) -> None:
    """Count in TILES the plan (kernels.join_plan) of every K2 / K3 launch
    from here on, and in K1_PLANS the geometry (kernels.combine_plan) of
    every K1 launch: the wrappers look both up at each launch."""
    plan, combine_plan = kernels.join_plan, kernels.combine_plan

    def recording(kind, rows_a, rows_b, K, W, **kw):
        p = plan(kind, rows_a, rows_b, K, W, **kw)
        TILES[(kind, rows_a, rows_b, K, W, p.ra, p.rb, p.stages)] += 1
        return p

    def recording_k1(M, G, K, W, **kw):
        p = combine_plan(M, G, K, W, **kw)
        K1_PLANS[(M, G, K, W, p.vec, p.lanes, p.threads)] += 1
        return p
    kernels.join_plan = recording
    kernels.combine_plan = recording_k1


@contextlib.contextmanager
def _keeping_k1_inputs(kernels):
    """Inside the block, a copy of the inputs of K1's first call at each
    (M, G, K, W) goes into the dict it yields (the paths call the wrapper
    through the kernels module); the wrapper is restored after it."""
    combine, kept = kernels.combine_compat, {}

    def keeping(template, group, allow_undefined):
        shape = (template.mask.shape[0], *group.mask.shape)
        if shape not in kept:
            kept[shape] = (type(template)(*(x.clone() for x in template)),
                           type(group)(*(x.clone() for x in group)),
                           allow_undefined.clone())
        return combine(template, group, allow_undefined)
    kernels.combine_compat = keeping
    try:
        yield kept
    finally:
        kernels.combine_compat = combine


def _reset_counts(kernels) -> None:
    kernels.reset_launches()
    TILES.clear()
    K1_PLANS.clear()


def _tiles(launches: dict) -> tuple:
    """(TILES as [kernel, rows_a, rows_b, K, W, ra, rb, stages, launches]
    rows, K1_PLANS as [M, G, K, W, vec, lanes, threads, launches]
    rows), checked against the path's launch counts."""
    counts = {name: sum(v for k, v in TILES.items() if k[0] == name)
              for name in FEASIBILITY[1:]}
    counts["combine_compat"] = sum(K1_PLANS.values())
    for name, n in counts.items():
        assert n == launches[name], f"{name}: {n} plans, {launches[name]} " \
                                    f"launches"
    return ([[*k, v] for k, v in sorted(TILES.items())],
            [[*k, v] for k, v in sorted(K1_PLANS.items())])


def _alone(name: str, inputs, kw: dict, bound_ms: float, flush) -> dict:
    """A kernel's own time on prepared inputs (kernels.launcher): kernel_ms
    (hot L2), cold_ms (after ``flush``) and each one's share of the
    bound."""
    from karpenter_tpu_torch.ops import kernels
    launch, _ = kernels.launcher(name, *inputs, **kw)
    hot, cold = _kernel_ms(launch), _cold_ms(launch, flush)
    return {"kernel_ms": hot, "cold_ms": cold, "share": bound_ms / hot,
            "cold_share": bound_ms / cold}


def hold(name: str, inputs, kw: dict, cost, flush, shape: dict,
         plan=None) -> dict:
    """One kernel on prepared CUDA inputs: held equal to its plain version,
    the wrapper's and the kernel's own times, the bound of ``cost`` (the
    kernel's kernels.*_cost) and its share."""
    import torch
    from karpenter_tpu_torch.ops import kernels
    wrapper = getattr(kernels, name)
    plain = getattr(kernels, f"{name}_plain")
    got, want = wrapper(*inputs, **kw), plain(*inputs, **kw)
    torch.cuda.synchronize()
    equal, err = _compare(got, want)
    assert equal, f"{name} at {shape}: kernel and plain version disagree " \
                  f"(max abs err {err})"
    assert cost.bytes == _nbytes(*inputs) + _nbytes(got), \
        f"{name}: its cost does not count the bytes it moves"
    bound_ms, bound_by = _bound(cost.bytes, cost.ops)
    rec = {"shape": shape, "equal": equal, "max_abs_err": err,
           "ms": _time_ms(lambda: wrapper(*inputs, **kw)),
           "plain_ms": _time_ms(lambda: plain(*inputs, **kw)),
           **_alone(name, inputs, kw, bound_ms, flush),
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": cost.bytes,
           "ops": cost.ops}
    if plan is not None:
        rec["plan"] = plan._asdict()
    return rec


def join_holds(problem, dev, flush) -> dict:
    """K1, K2 and K3 at one problem's shapes on the card, each through
    hold() on the same device inputs (K1's output feeds K2)."""
    from karpenter_tpu_torch.ops import binpack, kernels
    args, statics = binpack.device_args(problem, binpack.ArgPlacer(dev))
    (group, template, it, group_req, daemon, alloc, template_its, off_zone,
     off_captype, off_avail, zone_values, allow_undef, tol_template,
     exist, exist_avail, tol_exist) = args
    assert statics["has_exist"], "the problem has no existing nodes"
    k1_in = (template, group, allow_undef)
    cmb, compat_tm = kernels.combine_compat(*k1_in)
    kw = dict(zone_key=statics["zone_key"],
              captype_key=statics["captype_key"])
    G, K, W = group.mask.shape
    M, T, N = template.mask.shape[0], it.mask.shape[0], exist.mask.shape[0]
    R, O, Z = group_req.shape[1], off_zone.shape[1], zone_values.shape[0]
    MG = M * G
    shape = problem_shape(G, M, T, N, K, W)
    k2_in = (cmb, compat_tm, it, group_req, daemon, alloc, template_its,
             off_zone, off_captype, off_avail, zone_values, tol_template)
    k3_in = (group, group_req, exist, exist_avail, tol_exist)
    return {
        "combine_compat": hold(
            "combine_compat", k1_in, {}, kernels.combine_compat_cost(
                M, G, K, W), flush, shape,
            kernels.combine_plan(M, G, K, W)),
        "catalog_feasibility": hold(
            "catalog_feasibility", k2_in, kw,
            kernels.catalog_feasibility_cost(M, G, T, K, W, R, O, Z), flush,
            shape,
            kernels.join_plan("catalog_feasibility", T, MG, K, W, R=R, O=O,
                              Wz=kernels.zone_pack_layout(Z)[1], Z=Z)),
        "exist_feasibility": hold(
            "exist_feasibility", k3_in, {},
            kernels.exist_feasibility_cost(G, N, K, W, R), flush, shape,
            kernels.join_plan("exist_feasibility", N, G, K, W, R=R)),
    }


def problem_shape(G, M, T, N, K, W) -> dict:
    return {"G": G, "M": M, "T": T, "N": N, "K": K, "W": W}


# --------------------------------------------------------------------------
# the provisioner and disruption loops on a live cluster
# --------------------------------------------------------------------------

def live_cluster(catalog, device, pool=None):
    """A kube store with informers feeding the cluster state on a fake
    clock, the kwok provider over ``catalog``, ``pool`` (default_pool()),
    and a Provisioner on ``device``: what an operator wires."""
    from types import SimpleNamespace
    from karpenter_tpu_torch.cloudprovider.kwok import KwokCloudProvider
    from karpenter_tpu_torch.kube.store import Store
    from karpenter_tpu_torch.provisioning.provisioner import Provisioner
    from karpenter_tpu_torch.state.cluster import Cluster
    from karpenter_tpu_torch.state.informers import wire_informers
    from karpenter_tpu_torch.utils.clock import FakeClock
    clock = FakeClock()
    store = Store(clock)
    cluster = Cluster(store, clock)
    wire_informers(store, cluster)
    provider = KwokCloudProvider(instance_types=catalog, store=store)
    provisioner = Provisioner(store, cluster, provider, clock, device=device)
    store.create(pool or default_pool())
    return SimpleNamespace(clock=clock, store=store, cluster=cluster,
                           provider=provider, provisioner=provisioner,
                           catalog=catalog)


# The fleets below are built as tests/test_torch_support.py builds them
# through LiveEnv (pool, node, bind) for both packages;
# tests/test_torch_disruption.py holds the two stores equal.

def consolidation_pool():
    """default_pool() with the consolidation tests' 100% budget."""
    from karpenter_tpu_torch.api import nodepool as np_
    pool = default_pool()
    pool.spec.disruption.budgets = [np_.Budget(nodes="100%")]
    pool.spec.disruption.consolidate_after = 0.0
    return pool


def fab_node(env, name: str, it) -> None:
    """An initialized, registered, consolidatable on-demand claim of type
    ``it`` in test-zone-a, carrying its pool's hash, and its node."""
    from karpenter_tpu_torch.api import labels as L
    from karpenter_tpu_torch.api import nodeclaim as nc_mod
    from karpenter_tpu_torch.api import nodepool as np_
    from karpenter_tpu_torch.api import objects as o
    alloc = it.allocatable()
    labels = {L.NODEPOOL_LABEL_KEY: "default",
              L.LABEL_INSTANCE_TYPE: it.name,
              L.CAPACITY_TYPE_LABEL_KEY: L.CAPACITY_TYPE_ON_DEMAND,
              L.LABEL_TOPOLOGY_ZONE: "test-zone-a", L.LABEL_HOSTNAME: name}
    pool = env.store.get(np_.NodePool, "default")
    annotations = {
        L.NODEPOOL_HASH_ANNOTATION_KEY: pool.static_hash(),
        L.NODEPOOL_HASH_VERSION_ANNOTATION_KEY: np_.NODEPOOL_HASH_VERSION}
    pid = f"fab://{name}"
    nc = nc_mod.NodeClaim(
        metadata=o.ObjectMeta(name=name, labels=dict(labels),
                              annotations=annotations),
        spec=nc_mod.NodeClaimSpec(startup_taints=[]),
        status=nc_mod.NodeClaimStatus(provider_id=pid, node_name=name,
                                      capacity=dict(alloc),
                                      allocatable=dict(alloc)))
    for cond in (nc_mod.COND_LAUNCHED, nc_mod.COND_REGISTERED,
                 nc_mod.COND_INITIALIZED, nc_mod.COND_CONSOLIDATABLE):
        nc.conditions.set_true(cond, now=env.clock.now())
    env.store.create(nc)
    env.store.create(o.Node(
        metadata=o.ObjectMeta(
            name=name, labels={**labels, L.NODE_INITIALIZED_LABEL_KEY: "true"},
            finalizers=[L.TERMINATION_FINALIZER]),
        spec=o.NodeSpec(provider_id=pid, taints=[]),
        status=o.NodeStatus(capacity=dict(alloc), allocatable=dict(alloc))))


def fab_pod(env, node_name: str, name: str, cpu: str) -> None:
    """A running pod bound to ``node_name`` requesting ``cpu`` and 128Mi."""
    from karpenter_tpu_torch.api import objects as o
    from karpenter_tpu_torch.utils.resources import parse_list
    p = o.Pod(metadata=o.ObjectMeta(name=name, namespace="default"),
              spec=o.PodSpec(node_name=node_name),
              container_requests=[parse_list({"cpu": cpu,
                                              "memory": "128Mi"})])
    p.status.phase = "Running"
    env.store.create(p)


def underutilized_fleet(device, n: int = N_NODES):
    """BASELINE config 4 (bench.py bench_consolidation): n initialized,
    consolidatable 4-cpu amd64 nodes over the kwok 144-type catalog, each
    holding one 200m / 128Mi pod."""
    from karpenter_tpu_torch.cloudprovider.kwok import \
        construct_instance_types
    catalog = construct_instance_types()
    env = live_cluster(catalog, device, consolidation_pool())
    big = next(it for it in catalog if it.capacity.get("cpu") == 4000
               and "amd64-linux" in it.name)
    for i in range(n):
        fab_node(env, f"bench-node-{i:05d}", big)
    for i in range(n):
        fab_pod(env, f"bench-node-{i:05d}", f"bench-pod-{i}", "200m")
    env.clock.step(600)
    return env


def stuck_fleet(device, n: int = N_NODES, prefix: str = "single"):
    """bench.py's single-node and disruption-scale shape: an on-demand-only
    kwok catalog, n - 1 nodes each holding one pod that fits nowhere else
    and on no cheaper type, and one last node whose two 200m pods fit the
    others' headroom — the only win, last in the fair order."""
    from karpenter_tpu_torch.api import labels as L
    from karpenter_tpu_torch.cloudprovider.kwok import \
        construct_instance_types
    from karpenter_tpu_torch.cloudprovider.types import Offerings
    catalog = construct_instance_types()
    for it in catalog:
        it.offerings = Offerings(
            [o for o in it.offerings
             if o.capacity_type == L.CAPACITY_TYPE_ON_DEMAND])
    env = live_cluster(catalog, device, consolidation_pool())

    def od_price(it):
        return min((o.price for o in it.offerings if o.available),
                   default=float("inf"))

    ref = next(it for it in catalog if it.capacity.get("cpu") == 4000
               and "amd64-linux" in it.name)
    stuck_req = ref.allocatable()["cpu"] - 300  # 300m headroom per node
    big = min((it for it in catalog
               if it.allocatable().get("cpu", 0) >= stuck_req), key=od_price)
    assert big.allocatable()["cpu"] - stuck_req < stuck_req
    small = min((it for it in catalog if it.capacity.get("cpu") == 1000),
                key=od_price)
    # every node first, then the pods: bound pods then take the informer's
    # per-pod path instead of a pod-store scan per node
    for i in range(n):
        fab_node(env, f"{prefix}-node-{i:05d}", big if i < n - 1 else small)
    for i in range(n - 1):
        fab_pod(env, f"{prefix}-node-{i:05d}", f"{prefix}-pod-{i}",
                f"{stuck_req}m")
    for j in range(2):
        fab_pod(env, f"{prefix}-node-{n - 1:05d}", f"{prefix}-winner-{j}",
                "200m")
    env.clock.step(600)
    return env


def command_digest(cmd) -> tuple:
    """A disruption command by name: decision, candidates, replacement
    instance-type options."""
    return (cmd.decision, sorted(c.name for c in cmd.candidates),
            [[it.name for it in r.instance_type_options]
             for r in cmd.replacements])


def _sync(device) -> None:
    if str(device).startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def provisioner_passes(device, n_pods: int = N_PODS,
                       n_deploys: int = N_DEPLOYS, passes: int = 2,
                       profile_dir=None, flight_recorder=None):
    """The north-star pending batch (bench_pods(n_pods, n_deploys) over
    construct_catalog(N_ITS)) through Provisioner.reconcile on a live
    cluster: a cold pass, then (``passes`` = 2) a warm pass after a rollout
    deployment arrives, packed against the first pass's claims (in flight,
    so existing nodes of the solve). Each pass is one reconcile after the
    batcher window has passed, timed on the host clock ending in a device
    synchronize; the provisioner profiles each pass into ``profile_dir``
    and captures each solve into ``flight_recorder`` when given. Returns
    one record per pass: seconds, claims created, pod errors, existing
    nodes used, the decision digest, ps.last and the trace."""
    from karpenter_tpu_torch.api.nodeclaim import NodeClaim
    from karpenter_tpu_torch.api.objects import Pod
    from karpenter_tpu_torch.cloudprovider.kwok import construct_catalog
    from karpenter_tpu_torch.flightrec.record import decision_digest
    from karpenter_tpu_torch.obs.tracer import TRACER
    from karpenter_tpu_torch.provisioning.provisioner import \
        BATCH_IDLE_SECONDS
    env = live_cluster(construct_catalog(N_ITS), device)
    env.provisioner.profile_dir = profile_dir
    env.provisioner.flight_recorder = flight_recorder
    pods = bench_pods(n_pods, n_deploys)
    for p in pods:
        env.store.create(p)
    out = []
    arrivals = ([], rollout_deployment(1, n_pods // n_deploys))[:passes]
    for i, arriving in enumerate(arrivals):
        for p in arriving:
            env.store.create(p)
        env.provisioner.reconcile()         # opens the batcher window
        env.clock.step(BATCH_IDLE_SECONDS + 0.1)
        before = len(env.store.list(NodeClaim))
        t0 = time.perf_counter()
        env.provisioner.reconcile()
        _sync(device)
        s = time.perf_counter() - t0
        trace = TRACER.last()
        r = env.provisioner.last_results
        ts = env.provisioner.last_scheduler
        assert ts.fallback_reason == "", ts.fallback_reason
        out.append({
            "pass": i, "s": s,
            "claims_created": len(env.store.list(NodeClaim)) - before,
            "errors": len(r.pod_errors),
            "existing_used": sum(1 for en in r.existing_nodes if en.pods),
            "digest": decision_digest(r, env.store.list(Pod), "",
                                      ts.partition),
            "ps_last": {k: env.provisioner.problem_state.last.get(k)
                        for k in ("encode_kind", "node_rows_reencoded",
                                  "precompute")},
            "trace": trace})
    return out


def multi_consolidation(env, repeats: int = REPEATS):
    """get_candidates + MultiNodeConsolidation.compute_command with the
    budget lifted to the fleet: a cold pass, then ``repeats`` more; returns
    (candidates, command, per-pass seconds, probes and trace of the last
    pass)."""
    from karpenter_tpu_torch.disruption.helpers import get_candidates
    from karpenter_tpu_torch.disruption.methods import \
        MultiNodeConsolidation
    from karpenter_tpu_torch.obs.tracer import TRACER
    method = MultiNodeConsolidation(env.cluster, env.provisioner)
    seconds, cmd, cands = [], None, None
    for _ in range(1 + repeats):
        t0 = time.perf_counter()
        with TRACER.span("consolidation_multi"):
            cands = get_candidates(env.cluster, env.provisioner,
                                   method.should_disrupt)
            cmd, _ = method.compute_command({"default": len(cands)}, cands)
        _sync(env.provisioner.device)
        seconds.append(time.perf_counter() - t0)
    trace = TRACER.last()
    probes = sum(1 for sp in trace.spans if sp.name == "disruption.sim")
    return cands, cmd, seconds, probes, trace, method


def single_consolidation(env, repeats: int = REPEATS - 1):
    """SingleNodeConsolidation.compute_command over every candidate: a
    cold pass, then ``repeats`` more (the memo dropped before each)."""
    from karpenter_tpu_torch.disruption.helpers import get_candidates
    from karpenter_tpu_torch.disruption.methods import \
        SingleNodeConsolidation
    from karpenter_tpu_torch.obs.tracer import TRACER
    method = SingleNodeConsolidation(env.cluster, env.provisioner)
    seconds, cmds, cands = [], [], None
    for _ in range(1 + repeats):
        method._last_state = None
        t0 = time.perf_counter()
        with TRACER.span("consolidation_single"):
            cands = get_candidates(env.cluster, env.provisioner,
                                   method.should_disrupt)
            cmd, _ = method.compute_command({"default": len(cands)}, cands)
        _sync(env.provisioner.device)
        seconds.append(time.perf_counter() - t0)
        cmds.append(command_digest(cmd))
        assert cmds[-1] == cmds[0], "the decision moved between passes"
    return cands, cmds[0], seconds, method.last_engine_stats, TRACER.last()


def controller_pass(ctrl):
    """One DisruptionController.reconcile through all four methods, the
    TTL wait and the methods' memos dropped first; returns (seconds, the
    command awaiting validation)."""
    ctrl.pending = None
    for m in ctrl.methods:
        if hasattr(m, "_last_state"):
            m._last_state = None
    t0 = time.perf_counter()
    ctrl.reconcile()
    _sync(ctrl.provisioner.device)
    s = time.perf_counter() - t0
    assert ctrl.pending is not None, "the pass made no decision"
    return s, command_digest(ctrl.pending[0])


def traces_since(mark):
    """The traces completed after the one named ``mark`` (a trace id, or
    None for every trace in the ring)."""
    from karpenter_tpu_torch.obs.tracer import TRACER
    traces = TRACER.traces()
    ids = [t.trace_id for t in traces]
    return traces[ids.index(mark) + 1:] if mark in ids else traces


def merged_spans(traces, n: int = 12) -> dict:
    """The n largest exclusive span times (ms) summed over ``traces``."""
    from karpenter_tpu_torch.obs.tracer import phase_millis
    total: dict = {}
    for t in traces:
        for k, v in phase_millis(t).items():
            total[k] = total.get(k, 0.0) + v
    return dict(sorted(total.items(), key=lambda kv: -kv[1])[:n])


def disruption_encoding(env, candidates):
    """One disruption encode of ``candidates`` over a fresh snapshot."""
    from karpenter_tpu_torch.disruption.prefix import DisruptionSnapshot
    return DisruptionSnapshot(env.cluster, env.provisioner).encoding_for(
        candidates)


def encoding_shapes(env, candidates) -> dict:
    """The tensor shapes of one disruption encode of ``candidates`` over a
    fresh snapshot (G is padded to a power of two of at least 8, N is the
    pow2 bucket of the packable nodes)."""
    enc = disruption_encoding(env, candidates)
    p = enc.problem
    G, K, W = p.group_enc.mask.shape
    return {"G": G, "M": p.template_enc.mask.shape[0],
            "T": p.it_enc.mask.shape[0], "K": K, "W": W,
            "O": p.off_zone.shape[1], "Z": p.zone_values.shape[0],
            "N": enc.tensors.exist_ok.shape[1]}


def new_controller(env, flight_recorder=None):
    from karpenter_tpu_torch.disruption.controller import (
        DisruptionController, OrchestrationQueue)
    return DisruptionController(
        env.store, env.cluster, env.provisioner,
        OrchestrationQueue(env.store, env.cluster, env.clock), env.clock,
        flight_recorder=flight_recorder)


# --------------------------------------------------------------------------
# the operator: the whole control loop as its users run it
# --------------------------------------------------------------------------

#: the burst settles in at most this many steps of 1.1 s
OPERATOR_BURST_STEPS = 20
#: the scale-down: steps of 1.1 s after the TTL has passed
OPERATOR_SCALE_DOWN_STEPS = 40


def _operator_digest(op, claims_in_order, commands) -> tuple:
    """What the card's and the CPU's operators must agree on after every
    step: claims by creation order (instance type, zone, capacity type),
    each pod's node (by pod creation order), the nodes, and the disruption
    commands so far."""
    from karpenter_tpu_torch.api import labels as L
    from karpenter_tpu_torch.api.nodeclaim import NodeClaim
    from karpenter_tpu_torch.api.objects import Node, Pod
    import hashlib
    live = {nc.name: nc.metadata.labels for nc in op.store.list(NodeClaim)}
    claims = tuple((live[n].get(L.LABEL_INSTANCE_TYPE),
                    live[n].get(L.LABEL_TOPOLOGY_ZONE),
                    live[n].get(L.CAPACITY_TYPE_LABEL_KEY))
                   for n in claims_in_order if n in live)
    pods = hashlib.sha256("\n".join(
        f"{p.namespace}/{p.name} {p.spec.node_name}"
        for p in op.store.list(Pod)).encode()).hexdigest()
    nodes = tuple(sorted(n.name for n in op.store.list(Node)))
    return claims, pods, nodes, tuple(commands)


def operator_run(device, n_pods: int = N_PODS, n_deploys: int = N_DEPLOYS,
                 n_its: int = N_ITS, sidecar: str = None,
                 kube: bool = False) -> dict:
    """The port's Operator as a user runs it — the whole controller roster,
    the flight recorder and the tracer at their default rings — over the
    kwok provider with construct_catalog(n_its) and the operator's own
    store, default_pool() and bench_pods(n_pods, n_deploys), on a fake
    clock; with ``sidecar`` (an address) its provisioning solves go to the
    solver sidecar there (``solver_backend="sidecar"``); with ``kube`` its
    store is a KubeApiStore over the port's EnvtestServer on 127.0.0.1
    (``store_backend="kube"``, a KubeWire on the same fake clock: the
    workload applied through a client store, each step driven to
    quiescence over the wire; the counts, and the digest of the server's
    whole state beside the commands, read from the server):

    - burst: every pod pending; step() and 1.1 s, until step() is quiet
      twice in a row with every pod bound that can be: the pods still
      pending are exactly the last provisioning pass's pod errors (the
      mix's hostname-affinity deployments put 416 pods on one host, more
      than any node holds) (OPERATOR_BURST_STEPS at most);
    - scale-down: every other pod of each deployment deleted, the clock
      moved past the 15 s consolidation TTL, then step() and 1.1 s until a
      disruption command has executed, its queue is empty, every pod that
      can be is bound and step() is quiet twice in a row.

    Returns each step's record (wall seconds, launches, claims, nodes,
    bound pods, commands, the host seconds of the exporters and of the
    costliest controllers, the top spans), the digest after each step, and
    every solve's fallback reason."""
    from karpenter_tpu_torch.api.nodeclaim import NodeClaim
    from karpenter_tpu_torch.api.objects import Node, Pod
    from karpenter_tpu_torch.cloudprovider.kwok import (KwokCloudProvider,
                                                        construct_catalog)
    from karpenter_tpu_torch.disruption.validation import \
        CONSOLIDATION_TTL_SECONDS
    from karpenter_tpu_torch.obs.tracer import TRACER
    from karpenter_tpu_torch.operator.operator import Operator
    from karpenter_tpu_torch.operator.options import Options
    from karpenter_tpu_torch.ops import kernels
    from karpenter_tpu_torch.provisioning import tensor_scheduler as ts_mod
    from karpenter_tpu_torch.utils.clock import FakeClock
    import tempfile
    provider = KwokCloudProvider(instance_types=construct_catalog(n_its))
    backend = dict(solver_backend="sidecar", solver_address=sidecar) \
        if sidecar else {}
    clock, wire, tmp = FakeClock(), None, None
    if kube:
        from karpenter_tpu_torch.kube.k8s_codec import WATCH_KINDS
        tmp = tempfile.TemporaryDirectory(prefix="karpenter-kube-")
        wire = KubeWire(clock, tmp.name)
        backend.update(store_backend="kube", kubeconfig=wire.kubeconfig)
    op = Operator(Options(metrics_port=0, health_probe_port=0,
                          log_level="error", **backend),
                  cloud_provider=provider, clock=clock, device=device)
    # a caller's provider launches into the operator's own store
    provider.store = op.store
    if wire is not None:
        wire.attach(op.store, WATCH_KINDS)
    writer = wire.client if wire is not None else op.store
    claims_in_order, commands, fallbacks = [], [], []
    op.store.watch(lambda ev: ev.kind is NodeClaim and ev.type == "ADDED"
                   and claims_in_order.append(ev.obj.name))
    add = op.queue.add

    def queued(qc):
        commands.append((qc.command.reason, tuple(sorted(
            c.state_node.name() for c in qc.command.candidates)),
            len(qc.replacement_names)))
        return add(qc)
    op.queue.add = queued
    # host seconds by controller (the watch controllers and the
    # singletons), the exporters among them
    spent: collections.Counter = collections.Counter()
    for c in op.manager.controllers + op.manager.singletons:
        def timed(*obj, _inner=c.reconcile, _name=c.name):
            t0 = time.perf_counter()
            try:
                return _inner(*obj)
            finally:
                spent[_name] += time.perf_counter() - t0
        c.reconcile = timed

    def exporters_s() -> float:
        return spent["metrics.pod"] + spent["metrics.node"]
    solve = ts_mod.TensorScheduler.solve
    solve_s = [0.0]

    def solve_noting(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return solve(self, *a, **kw)
        finally:
            solve_s[0] += time.perf_counter() - t0
            fallbacks.append(self.fallback_reason)

    pods = bench_pods(n_pods, n_deploys)
    t0 = time.perf_counter()
    writer.create(default_pool())
    for p in pods:
        writer.create(p)
    apply_s = time.perf_counter() - t0
    steps, digests = [], []

    def counts() -> dict:
        """The live claims, nodes, pods and bound pods (the server's, with
        the wire)."""
        if wire is not None:
            return wire.counts()
        pods = op.store.list(Pod)
        return {"claims": len(op.store.list(NodeClaim)),
                "nodes": len(op.store.list(Node)), "pods": len(pods),
                "bound": sum(1 for p in pods if p.spec.node_name)}

    def settled(last) -> bool:
        """Every pod bound but the last provisioning pass's pod errors."""
        r = op.provisioner.last_results
        return last["bound"] + (len(r.pod_errors) if r else 0) == \
            last["pods"]

    def step(stage: str) -> bool:
        before = dict(kernels.LAUNCHES)
        spent0, last = dict(spent), TRACER.last()
        wire0 = wire.totals() if wire is not None else None
        solve0 = solve_s[0]
        t0 = time.perf_counter()
        if wire is not None:
            quiet, rounds = wire.step(op)
        else:
            quiet, rounds = op.step(), None
        _sync(device)
        s = time.perf_counter() - t0
        steps.append({
            "stage": stage, "step": len(steps), "s": s, "quiet": quiet,
            "launches": {k: kernels.LAUNCHES[k] - before[k] for k in before
                         if kernels.LAUNCHES[k] - before[k]},
            **counts(), "commands": len(commands),
            "queued": len(op.queue.items),
            "exporters_s": exporters_s() - spent0.get("metrics.pod", 0.0)
            - spent0.get("metrics.node", 0.0),
            "controllers_s": dict(sorted(
                ((k, v - spent0.get(k, 0.0)) for k, v in spent.items()),
                key=lambda kv: -kv[1])[:6]),
            "spans_ms": merged_spans(traces_since(
                last.trace_id if last else None), 8)})
        if wire is not None:
            steps[-1].update(rounds=rounds, solve_s=solve_s[0] - solve0,
                             **{k: v - wire0[k]
                                for k, v in wire.totals().items()})
            digests.append((wire.state_digest(claims_in_order),
                            tuple(commands)))
        else:
            digests.append(_operator_digest(op, claims_in_order, commands))
        op.clock.step(1.1)
        return quiet

    ts_mod.TensorScheduler.solve = solve_noting
    try:
        calm = 0
        for _ in range(OPERATOR_BURST_STEPS):
            calm = calm + 1 if step("burst") else 0
            if calm >= 2 and settled(steps[-1]):
                break
        else:
            raise AssertionError(
                f"operator burst: not settled in {OPERATOR_BURST_STEPS} "
                f"steps: {steps[-1]}")
        by_app: dict = {}
        for p in pods:
            by_app.setdefault(p.labels["app"], []).append(p)
        for group in by_app.values():
            for p in group[::2]:
                writer.delete(p)
        step("scale_down")
        op.clock.step(CONSOLIDATION_TTL_SECONDS + 1.0)
        calm = 0
        for _ in range(OPERATOR_SCALE_DOWN_STEPS):
            calm = calm + 1 if step("scale_down") else 0
            last = steps[-1]
            if calm >= 2 and commands and not op.queue.items and \
                    settled(last):
                break
        else:
            raise AssertionError(
                f"operator scale-down: not settled with a command executed "
                f"in {OPERATOR_SCALE_DOWN_STEPS} steps: {steps[-1]}")
    finally:
        ts_mod.TensorScheduler.solve = solve
        op.stop_serving()
        if op.solver_session is not None:
            op.solver_session.close()
        if wire is not None:
            wire.close(op)
            tmp.cleanup()
    errors = op.provisioner.last_results.pod_errors
    out = {"steps": steps, "digests": digests, "fallbacks": fallbacks,
           "exporters_s": exporters_s(), "commands": commands,
           "controllers_s": dict(spent.most_common()),
           "pods": len(pods), "unschedulable": dict(collections.Counter(
               errors.values())), "apply_s": apply_s, "solve_s": solve_s[0]}
    if wire is not None:
        out["wire"] = wire.totals()
        out["apply_requests"] = wire.client_requests()
    return out


@contextlib.contextmanager
def _held_at_each_shape(kernels):
    """Inside the block, the first call of each feasibility kernel at each
    set of input shapes is held against its plain version on the same
    CUDA inputs (the path's own launch; the plain version counts none).
    Yields the holds by kernel and shapes."""
    held: dict = {}
    saved = {name: getattr(kernels, name) for name in FEASIBILITY}

    def holding(name, wrapper):
        plain = getattr(kernels, f"{name}_plain")

        def call(*args, **kw):
            out = wrapper(*args, **kw)
            shapes = tuple(tuple(t.shape) for t in _flat(args))
            if (name, shapes) not in held:
                equal, err = _compare(out, plain(*args, **kw))
                assert equal, f"{name} at {shapes}: kernel and plain " \
                              f"version disagree (max abs err {err})"
                held[(name, shapes)] = err
            return out
        return call
    for name, wrapper in saved.items():
        setattr(kernels, name, holding(name, wrapper))
    try:
        yield held
    finally:
        for name, wrapper in saved.items():
            setattr(kernels, name, wrapper)


@contextlib.contextmanager
def _process_state_kept():
    """The port's process-wide tracer settings and metric registry as they
    were before the block, once it ends: an Operator configures the tracer
    and its controllers write the registry, and no later phase may read
    what the operator phase left there."""
    from karpenter_tpu_torch.metrics.registry import REGISTRY
    from karpenter_tpu_torch.obs.tracer import TRACER
    tracer = (TRACER.enabled, TRACER.capacity, TRACER.watcher)
    saved = [(m, {a: dict(getattr(m, a)) for a in ("_values", "_counts",
                                                     "_sums")
                  if hasattr(m, a)}) for m in REGISTRY._metrics.values()]
    try:
        yield
    finally:
        TRACER.enabled, TRACER.watcher = tracer[0], tracer[2]
        TRACER.set_capacity(tracer[1])
        for m, state in saved:
            for a, values in state.items():
                getattr(m, a).clear()
                getattr(m, a).update(values)


def operator_phase(device, record, phase: str = "operator",
                   **sizes) -> list:
    """operator_run on ``device`` and on the CPU: the digests equal after
    every step, no solve fell back, K1-K3 launched on the card. ``record``
    is called just after the card's run (the path's launch counts).
    ``sizes`` go to operator_run (``kube=True`` for the operator over the
    apiserver wire, phase ``operator_kube``). Returns the JSON lines to
    print."""
    from karpenter_tpu_torch.ops import kernels
    with _process_state_kept():
        _reset_counts(kernels)
        t0 = time.perf_counter()
        with _held_at_each_shape(kernels) as held:
            card = operator_run(device, **sizes)
        card_s = time.perf_counter() - t0
        launches = record()
        t0 = time.perf_counter()
        cpu = operator_run("cpu", **sizes)
        cpu_s = time.perf_counter() - t0
    assert len(card["digests"]) == len(cpu["digests"]), \
        (len(card["digests"]), len(cpu["digests"]))
    for i, (g, c) in enumerate(zip(card["digests"], cpu["digests"])):
        assert g == c, f"{phase} step {i}: the card's and the CPU's " \
                       f"stores differ"
    bad = [r for r in card["fallbacks"] if r]
    assert not bad and card["fallbacks"], \
        f"{phase}: solves fell back to the host oracle: {bad[:3]}"
    for name in FEASIBILITY:
        assert launches[name] > 0, f"{phase}: {name} never launched"
        assert any(k[0] == name for k in held), name
    down = [s for s in card["steps"] if s["stage"] == "scale_down"]
    assert card["commands"], f"{phase}: no disruption command executed"
    host_s = sum(s["s"] for s in card["steps"])
    lines = []
    for g, c in zip(card["steps"], cpu["steps"], strict=True):
        lines.append({"phase": f"{phase}_step", **g, "cpu_s": c["s"],
                      "digest_equals_cpu": True})
    slowest = {stage: max((s for s in card["steps"] if s["stage"] == stage),
                          key=lambda s: s["s"])
               for stage in ("burst", "scale_down")}
    last = card["steps"][-1]
    lines.append({
        "phase": phase, "pods": card["pods"],
        "steps": len(card["steps"]),
        "burst_steps": len(card["steps"]) - len(down),
        "scale_down_steps": len(down),
        "s": card_s, "cpu_s": cpu_s,
        "steps_s": host_s, "cpu_steps_s": sum(s["s"] for s in cpu["steps"]),
        "launches": {k: v for k, v in launches.items() if v},
        "claims": last["claims"], "nodes": last["nodes"],
        "bound": last["bound"], "pods_left": last["pods"],
        "unschedulable": card["unschedulable"],
        "commands": [list(c) for c in card["commands"]],
        "solves": len(card["fallbacks"]), "fallbacks": 0,
        "exporters_s": card["exporters_s"],
        "exporters_share": card["exporters_s"] / host_s,
        "controllers_s": card["controllers_s"],
        "cpu_exporters_share": cpu["exporters_s"] / sum(
            s["s"] for s in cpu["steps"]),
        "top_spans": {stage: {"step": s["step"], "s": s["s"],
                              "spans_ms": s["spans_ms"]}
                      for stage, s in slowest.items()},
        "digest_equals_cpu_every_step": True,
        # each kernel held against its plain version at every set of input
        # shapes the path gave it (the G axis of the disruption encodes on
        # the 2,000-type catalog, the node axis of the operator's fleet)
        "held_equal_at_path_shapes": [
            {"name": name, "shapes": [list(x) for x in shapes],
             "max_abs_err": err}
            for (name, shapes), err in sorted(held.items())]})
    if "wire" in card:
        lines[-1].update(_wire_summary(card, cpu, sizes))
    return lines


# --------------------------------------------------------------------------
# the operator over the apiserver wire
# --------------------------------------------------------------------------

#: operator_kube: all 120 deployments and nine pod kinds of the benchmark
#: mix (the widths of the north star), 4 pods each (the operator phase runs
#: 416 each). Over the wire the reference's operator makes about 30
#: requests a pod, most of them the manager's re-fetch of every queued item
#: and whole-collection lists; with the CPU's run beside the card's, 4
#: pods each is what the script's time allows (PERF.md)
KUBE_PODS = 480
KUBE_DEPLOYS = 120
#: operator_kube_process: the CLI as a child process, 4 pods a deployment
KUBE_PROCESS_PODS = 480
#: seconds the child may take to bind every pod once they are applied
KUBE_BIND_S = 300
#: wire rounds (settle, pump, step) one step may take to go quiet
KUBE_ROUNDS = 64
#: seconds the operator's watches may take to catch up with the server
KUBE_SETTLE_S = 120
#: the CRD route a `kubectl apply -f crds/` posts to
_CRD_ROUTE = "/apis/apiextensions.k8s.io/v1/customresourcedefinitions"


def write_kubeconfig(url: str, directory: str) -> str:
    """A minimal kubeconfig naming ``url``: one cluster, one user with no
    credentials, one context, current. Returns its path."""
    import yaml
    cfg = {"apiVersion": "v1", "kind": "Config",
           "clusters": [{"name": "envtest", "cluster": {"server": url}}],
           "users": [{"name": "envtest", "user": {}}],
           "contexts": [{"name": "envtest", "context": {
               "cluster": "envtest", "user": "envtest"}}],
           "current-context": "envtest"}
    path = os.path.join(directory, "kubeconfig")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def post_crds(url: str, manifests: dict) -> list:
    """Each CRD manifest POSTed to the server at ``url``, as `kubectl apply
    -f crds/` would; returns the CRDs' names."""
    import urllib.request
    import yaml
    names = []
    for _, text in sorted(manifests.items()):
        crd = yaml.safe_load(text)
        req = urllib.request.Request(
            url + _CRD_ROUTE, data=json.dumps(crd).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.status == 201, resp.status
        names.append(crd["metadata"]["name"])
    return names


class KubeWire:
    """An in-process apiserver on 127.0.0.1 on the run's clock, with the
    CRDs posted, a kubeconfig naming it and a client store to apply the
    workload; ``attach`` meters an operator's KubeApiStore and ``step``
    drives it to quiescence over the wire. The modules are the port's
    unless others are given (a test hands the JAX package's).

    Watch delivery is asynchronous, so a step first waits until the store
    has received every log entry the server holds for the watched routes
    (``srv.state.log`` and ``rv`` read under ``srv.state.lock``), then
    delivers the queued events in the server's order (by resourceVersion:
    the five watch threads interleave at random), then steps; it repeats
    until a step writes nothing. Runs of it are then alike event for
    event."""

    def __init__(self, clock, directory: str, envtest=None, apiserver=None,
                 manifests=None):
        if envtest is None:
            from karpenter_tpu_torch.kube import envtest
        if apiserver is None:
            from karpenter_tpu_torch.kube import apiserver
        if manifests is None:
            from karpenter_tpu_torch.api.crds import manifests as crds
            manifests = crds()
        self.server = envtest.EnvtestServer(clock=clock).start()
        self.crds = post_crds(self.server.url, manifests)
        self.kubeconfig = write_kubeconfig(self.server.url, directory)
        self.client = apiserver.KubeApiStore(self.server.url, clock=clock)
        self._client_requests = [0]
        request = self.client._request

        def counted(*a, **kw):
            self._client_requests[0] += 1
            return request(*a, **kw)
        self.client._request = counted
        self.store = None
        self._lock = threading.Lock()
        self._totals = {"requests": 0, "request_s": 0.0, "settle_s": 0.0,
                        "events": 0}

    def client_requests(self) -> int:
        return self._client_requests[0]

    def totals(self) -> dict:
        with self._lock:
            return dict(self._totals)

    def attach(self, store, kinds) -> None:
        """Meter ``store``'s requests (any thread: the event sink posts
        from its own), note the resourceVersion each watch event carries,
        start the watches on ``kinds`` and wait until each has listed its
        route, before any object is applied."""
        self.store = store
        self.routes = {kind: tuple(store._route(kind)[:2]) for kind in kinds}
        self._want = set(self.routes.values())
        self._cursor, self._last = 0, {}
        self.seen: dict = {}
        listed: set = set()
        request = store._request

        def metered(method, url, body=None):
            t0 = time.perf_counter()
            try:
                return request(method, url, body)
            finally:
                with self._lock:
                    self._totals["requests"] += 1
                    self._totals["request_s"] += time.perf_counter() - t0
                    if method == "GET" and "?" not in url:
                        listed.add(url)
        store._request = metered
        put = store._events.put

        def noting(ev, *a, **kw):
            route = self.routes[ev.kind]
            with self._lock:
                self.seen[route] = max(self.seen.get(route, 0),
                                       ev.obj.metadata.resource_version)
            return put(ev, *a, **kw)
        store._events.put = noting
        store.start_watches(kinds)
        deadline = time.perf_counter() + KUBE_SETTLE_S
        while True:
            with self._lock:
                if len(listed) >= len(kinds):
                    break
            assert time.perf_counter() < deadline, "the watches never listed"
            time.sleep(0.005)

    def _last_rvs(self) -> dict:
        """The newest resourceVersion the server logged on each watched
        route that has a log: the entries appended to the log since the
        last call folded into those of the calls before."""
        st, last = self.server.state, self._last
        with st.lock:
            tail = st.log[self._cursor:]
            self._cursor += len(tail)
        for rv, route, _, _ in tail:
            if route in self._want:
                last[route] = rv
        return dict(last)

    def settle(self) -> None:
        """Wait until the store has received every entry of the log."""
        t0 = time.perf_counter()
        while True:
            last = self._last_rvs()
            with self._lock:
                if all(self.seen.get(r, 0) >= rv for r, rv in last.items()):
                    break
            assert time.perf_counter() - t0 < KUBE_SETTLE_S, \
                f"the watches fell behind the server: {last} {self.seen}"
            time.sleep(0.002)
        with self._lock:
            self._totals["settle_s"] += time.perf_counter() - t0

    def pump(self) -> int:
        """Deliver the queued watch events in the server's order."""
        store, got = self.store, []
        watchers = store._watchers
        store._watchers = [got.append]
        try:
            while store.pump_events():
                pass
        finally:
            store._watchers = watchers
        got.sort(key=lambda ev: ev.obj.metadata.resource_version)
        for ev in got:
            for cb in watchers:
                cb(ev)
        with self._lock:
            self._totals["events"] += len(got)
        return len(got)

    def _rv(self) -> int:
        with self.server.state.lock:
            return self.server.state.rv

    def step(self, op) -> tuple:
        """(quiet, rounds): settle, pump and ``op.step()`` until a step
        writes nothing to the server."""
        for rounds in range(1, KUBE_ROUNDS + 1):
            self.settle()
            self.pump()
            rv = self._rv()
            quiet = op.step()
            if self._rv() == rv:
                return quiet, rounds
        raise AssertionError(f"the wire was not quiet in {KUBE_ROUNDS} "
                             f"rounds")

    def counts(self) -> dict:
        """The server's claims, nodes, pods and bound pods."""
        st = self.server.state
        with st.lock:
            live = {plural: [o for route, coll in st.objects.items()
                             if route[1] == plural for o in coll.values()]
                    for plural in ("nodeclaims", "nodes", "pods")}
            return {"claims": len(live["nodeclaims"]),
                    "nodes": len(live["nodes"]), "pods": len(live["pods"]),
                    "bound": sum(1 for o in live["pods"]
                                 if (o.get("spec") or {}).get("nodeName"))}

    def state_digest(self, claims_in_order) -> str:
        """sha256 of every object the server holds, normalised: every
        ``uid`` (the server's uuid4, or a random one the client sent) and
        ``resourceVersion`` blanked, each claim named by its creation order
        (the claim-name sequence is process-wide). Timestamps stay: the
        server and the operator share the run's fake clock."""
        import hashlib
        import re
        names = {f'"{n}"': f'"claim-{i}"'
                 for i, n in enumerate(claims_in_order)}
        st = self.server.state
        with st.lock:
            text = [json.dumps(o, sort_keys=True) for _, coll in
                    sorted(st.objects.items()) for o in coll.values()]
        text = [re.sub(r'"(uid|resourceVersion)": "[^"]*"', r'"\1": ""', t)
                for t in text]
        if names:
            pattern = re.compile("|".join(map(re.escape, names)))
            text = [pattern.sub(lambda m: names[m.group(0)], t)
                    for t in text]
        return hashlib.sha256("\n".join(sorted(text)).encode()).hexdigest()

    def close(self, op=None) -> None:
        """Stop the operator's event sink and watches, then the server."""
        if op is not None:
            close = getattr(op.recorder.sink, "close", None)
            if close is not None:
                close()
            op.store.stop_watches()
        self.server.stop()


def _wire_summary(card: dict, cpu: dict, sizes: dict) -> dict:
    """The operator_kube line's wire figures: the apply, the operator's
    requests and watch events, and the wire's seconds beside the solve's,
    on the card and on the CPU."""
    def figures(run: dict) -> dict:
        w = run["wire"]
        steps_s = sum(s["s"] for s in run["steps"])
        return {"requests": w["requests"],
                "ms_per_request": 1e3 * w["request_s"] / max(1,
                                                             w["requests"]),
                "request_s": w["request_s"], "settle_s": w["settle_s"],
                "wire_s": w["request_s"] + w["settle_s"],
                "watch_events": w["events"], "solve_s": run["solve_s"],
                "steps_s": steps_s,
                "wire_share": (w["request_s"] + w["settle_s"]) / steps_s,
                "rounds": sum(s["rounds"] for s in run["steps"]),
                "apply_s": run["apply_s"],
                "apply_requests": run["apply_requests"],
                "apply_ms_per_pod": 1e3 * run["apply_s"] / run["pods"]}
    n = sizes.get("n_pods", KUBE_PODS)
    d = sizes.get("n_deploys", KUBE_DEPLOYS)
    return {"wire": figures(card), "cpu_wire": figures(cpu),
            "reduced": f"pods: {n} ({d} deployments x {n // d}; the "
                       f"operator phase runs "
                       f"{N_PODS // N_DEPLOYS * N_DEPLOYS})",
            "state_digest_equals_cpu_every_step": True}


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url: str, timeout: float = 60) -> str:
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


def operator_kube_process_phase(device, n_pods: int = KUBE_PROCESS_PODS,
                                n_deploys: int = KUBE_DEPLOYS) -> dict:
    """The operator as a deployment runs it: ``python -m
    karpenter_tpu_torch.operator --device <device> --store-backend kube
    --kubeconfig <file> --leader-elect`` as a child process against the
    port's EnvtestServer (real clock, the CRDs posted), with the CLI's
    default kwok catalog and a KubeLease over the wire. Its starting line
    must name ``device``; default_pool() and bench_pods(n_pods, n_deploys)
    are applied; every pod must be bound within KUBE_BIND_S; every
    provisioning record of the child (``/debug/flightrecorder?format=jsonl``)
    must carry no fallback reason and its precompute must have dispatched
    (``karpenter_device_dispatches_total`` on ``/metrics``); its first
    provisioning record is replayed here on ``device`` to a match; SIGINT
    must end the child with exit code 0. On any failure the child's stderr
    is printed."""
    import re
    import signal
    import tempfile
    from karpenter_tpu_torch.utils.clock import Clock
    with tempfile.TemporaryDirectory(prefix="karpenter-kube-") as tmp, \
            tempfile.TemporaryFile(mode="w+") as err:
        wire = KubeWire(Clock(), tmp)
        metrics_port, health_port = _free_port(), _free_port()
        command = ["--device", device, "--store-backend", "kube",
                   "--kubeconfig", wire.kubeconfig, "--leader-elect",
                   "--metrics-port", str(metrics_port),
                   "--health-probe-port", str(health_port),
                   "--log-level", "error"]
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "karpenter_tpu_torch.operator", *command],
            cwd=_ROOT, stdout=subprocess.PIPE, stderr=err, text=True)
        try:
            started = _child_line(
                proc, t0 + CHILD_BOOT_S,
                r"karpenter-tpu operator starting \(.*device=([^)]*)\)",
                "the operator")
            assert started.group(1).split(":")[0] == \
                device.split(":")[0], started.group(0)
            boot_s = time.perf_counter() - t0
            t1 = time.perf_counter()
            wire.client.create(default_pool())
            pods = bench_pods(n_pods, n_deploys)
            for p in pods:
                wire.client.create(p)
            apply_s = time.perf_counter() - t1
            while True:
                bound = wire.counts()["bound"]
                if bound == len(pods):
                    break
                assert time.perf_counter() - t1 < KUBE_BIND_S, \
                    f"the child bound {bound} of {len(pods)} pods in " \
                    f"{KUBE_BIND_S} s"
                assert proc.poll() is None, \
                    f"the child exited with {proc.returncode}"
                time.sleep(0.25)
            bind_s = time.perf_counter() - t1
            base = f"http://127.0.0.1:{metrics_port}"
            records = [ln for ln in _get(
                f"{base}/debug/flightrecorder?format=jsonl&n=1000"
            ).splitlines() if ln.strip()]
            solves = [(i, json.loads(ln)) for i, ln in enumerate(records)]
            solves = [(i, r) for i, r in solves
                      if r.get("kind") == "provisioning"]
            assert solves, "the child recorded no provisioning solve"
            fell_back = [r["meta"].get("fallback_reason") for _, r in solves
                         if r["meta"].get("fallback_reason")]
            assert not fell_back, \
                f"the child's solves fell back to the host oracle: " \
                f"{fell_back[:3]}"
            first = solves[0][0]
            replay = _replayed(records[first], first, device)
            dispatches = sum(
                float(m.group(1)) for m in re.finditer(
                    r"^karpenter_device_dispatches_total\{[^}]*\} (\S+)$",
                    _get(f"{base}/metrics"), re.M))
            assert dispatches > 0, "the child dispatched no solve"
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=60)
            assert rc == 0, f"the operator exited with {rc} on SIGINT"
        except BaseException:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            err.seek(0)
            print(f"operator child stderr:\n{err.read()[-8000:]}",
                  file=sys.stderr, flush=True)
            raise
        finally:
            wire.close()
        st = wire.server.state
        with st.lock:
            leases = [o for route, coll in st.objects.items()
                      if route[1] == "leases" for o in coll.values()]
    return {"phase": "operator_kube_process", "device": device,
            "started": started.group(0),
            "command": "python -m karpenter_tpu_torch.operator "
                       + " ".join(command),
            "crds": wire.crds, "boot_s": boot_s, "pods": len(pods),
            "reduced": f"pods: {n_pods} ({n_deploys} deployments x "
                       f"{n_pods // n_deploys})",
            "apply_s": apply_s, "apply_requests": wire.client_requests(),
            "bound": len(pods), "bind_s": bind_s,
            "records": len(records), "provisioning_records": len(solves),
            "fallbacks": 0, "replayed": replay,
            "device_dispatches": dispatches,
            "lease_holder": [(o.get("spec") or {}).get("holderIdentity")
                             for o in leases],
            "exit_code": rc}

# --------------------------------------------------------------------------

#: the operator over the sidecar: 6 deployments of 208 pods (the operator
#: phase runs 120 of 416); 416 each until the kube phases needed the time
OPERATOR_SIDECAR_PODS = 1_248
OPERATOR_SIDECAR_DEPLOYS = 6
#: seconds the sidecar child process may take to print its port
CHILD_BOOT_S = 300


@contextlib.contextmanager
def _uncounted(kernels):
    """Launches inside the block (a reference solve to compare with) leave
    kernels.LAUNCHES, TILES and K1_PLANS as they were before it."""
    saved = dict(kernels.LAUNCHES), TILES.copy(), K1_PLANS.copy()
    try:
        yield
    finally:
        kernels.LAUNCHES.update(saved[0])
        for counter, kept in zip((TILES, K1_PLANS), saved[1:]):
            counter.clear()
            counter.update(kept)


@contextlib.contextmanager
def _plain_kernels(kernels):
    """Inside the block the feasibility wrappers are their plain versions
    (which launch and count nothing)."""
    saved = {name: getattr(kernels, name) for name in FEASIBILITY}
    for name in FEASIBILITY:
        setattr(kernels, name, getattr(kernels, f"{name}_plain"))
    try:
        yield
    finally:
        for name, wrapper in saved.items():
            setattr(kernels, name, wrapper)


@contextlib.contextmanager
def _restored(module, name: str, value):
    """``module.name`` set back to ``value`` once the block ends."""
    try:
        yield
    finally:
        setattr(module, name, value)


@contextlib.contextmanager
def _serving(device, replica=None):
    """A port sidecar server on ``device`` over 127.0.0.1 (its own Replica
    unless one is given), yielding (server, address, replica). Once the
    block ends the server is stopped, its sessions dropped and the
    collector as it was: serve() freezes and disables it for the
    process."""
    import gc
    from karpenter_tpu_torch.sidecar import server as srv
    rep = replica or srv.Replica(name=f"smoke-{device}")
    frozen = gc.get_freeze_count()
    server, port = srv.serve(port=0, replica=rep, device=device)
    try:
        yield server, f"127.0.0.1:{port}", rep
    finally:
        server.stop(None)
        with rep.sessions_lock:
            rep.sessions.clear()
        if not frozen:
            gc.unfreeze()


class _Wire:
    """The request and response bytes of a SolverSession's RPCs since the
    last take()."""

    def __init__(self, session):
        self.sent = self.received = 0
        call = session._call

        def counting(method, payload):
            self.sent += len(payload)
            out = call(method, payload)
            self.received += len(out)
            return out
        session._call = counting

    def take(self) -> tuple:
        out = (self.sent, self.received)
        self.sent = self.received = 0
        return out


def _sidecar_digest(results, batch) -> dict:
    """The decision digest of a sidecar's answer (its fallback and
    partition riders included)."""
    from karpenter_tpu_torch.flightrec.record import decision_digest
    return decision_digest(results, batch, results.fallback_reason,
                           tuple(results.partition))


def _local_digest(results, batch) -> dict:
    """The decision digest of an in-process tensor-path solve (_solve
    asserts it took no fallback and no host pods)."""
    from karpenter_tpu_torch.flightrec.record import decision_digest
    return decision_digest(results, batch, "", (len(batch), 0))


def sidecar_step(session, wire, pool, catalog, batch, nodes=()) -> tuple:
    """One solve through ``session`` as the operator makes it; the answer
    must come from the tensor path (no fallback, no host pods, no degraded
    rider). Returns (results, its record: client wall s, wire bytes, the
    server's sidecar.* spans and the solve's own, queue wait, encode kind,
    warm outcome, launches)."""
    from karpenter_tpu_torch.obs.tracer import TRACER, phase_millis
    from karpenter_tpu_torch.ops import kernels
    before = dict(kernels.LAUNCHES)
    last = TRACER.last()
    t0 = time.perf_counter()
    r = session.solve([pool], {"default": catalog}, batch,
                      state_nodes=nodes)
    s = time.perf_counter() - t0
    sent, received = wire.take()
    traces = traces_since(last.trace_id if last else None)
    server = [t for t in traces
              if any(sp.name == "sidecar.apply" for sp in t.spans)]
    assert len(server) == 1, f"{len(server)} server traces for one solve"
    spans = phase_millis(server[0])
    assert r.fallback_reason == "" and not r.degraded, \
        f"sidecar: fell back ({r.fallback_reason!r}, {r.degraded!r})"
    assert tuple(r.partition) == (len(batch), 0), r.partition
    assert r.encode_kind in ("cold", "delta"), r.encode_kind
    return r, {
        "pods": len(batch), "nodes": len(nodes), "s": s,
        "request_bytes": sent, "response_bytes": received,
        "sidecar_ms": {k: v for k, v in spans.items()
                       if k.startswith("sidecar.")},
        "solve_spans_ms": dict(sorted(
            ((k, v) for k, v in spans.items()
             if not k.startswith("sidecar.")), key=lambda kv: -kv[1])[:8]),
        "queue_wait_ms": r.queue_wait_ms, "encode_kind": r.encode_kind,
        "warm": r.warm, "parity": r.parity,
        "launches": {k: kernels.LAUNCHES[k] - before[k] for k in before
                     if kernels.LAUNCHES[k] - before[k]}}


def sidecar_phase(device, pool, catalog, pods, span, runs, solve_s,
                  ts_mod) -> tuple:
    """The north-star solves through the port's sidecar on ``device``: a
    SolverSession over 127.0.0.1 to an in-process server. Step 1 the cold
    batch, step 2 the batch with the 5,000 nodes (seed 7) sent as state
    deltas, each equal to the in-process solve of phase solve_cold /
    solve_existing_nodes (``runs``, ``solve_s`` their best seconds); then
    the first window of each kind churn_windows builds, each carrying
    parity_check (the server's cold re-solve: byte-identical) and equal to
    a cold in-process solve of the same inputs (which counts no launch).
    K1-K3 are held against their plain versions at each launch shape.
    A window's wall time includes the server's parity re-solve, timed
    apart as ``parity_s``. Returns (the lines to print, the window digests
    by pass)."""
    from karpenter_tpu_torch.ops import kernels
    from karpenter_tpu_torch.sidecar import server as srv
    from karpenter_tpu_torch.sidecar.client import SolverSession
    lines, want = [], {}
    probe, probed = srv._parity_probe, []

    def timed_probe(*args):
        t0 = time.perf_counter()
        try:
            return probe(*args)
        finally:
            probed.append(time.perf_counter() - t0)
    srv._parity_probe = timed_probe
    with _restored(srv, "_parity_probe", probe), _process_state_kept(), \
            _held_at_each_shape(kernels) as held, \
            _serving(device) as (_, address, rep):
        session = SolverSession(address, tenant="smoke")
        wire = _Wire(session)
        nodes = existing_nodes(catalog)
        windows = churn_windows(pods, nodes, span)
        for i, kind, batch, dirty in itertools.islice(
                windows, 1 + len(WINDOW_KINDS)):
            if i == 0:
                r, rec = sidecar_step(session, wire, pool, catalog, pods)
                assert _sidecar_digest(r, pods) == _local_digest(
                    runs["cold"], pods), "sidecar step 1: != solve_cold"
                lines.append({"phase": "sidecar_step", "step": 1,
                              "window": "cold", "in_process_s":
                              solve_s["cold"], "digest_equals": "solve_cold",
                              **rec})
                label = "solve_existing_nodes"
                local_s = solve_s["existing_nodes"]
            else:
                session.parity_every = 1
                with _uncounted(kernels):
                    _, r_cold, local_s = _solve(ts_mod, pool, catalog, batch,
                                                nodes, device)
                want[i] = _local_digest(r_cold, batch)
                label = "cold in-process solve"
            r, rec = sidecar_step(session, wire, pool, catalog, batch, nodes)
            if i == 0:
                assert _sidecar_digest(r, batch) == _local_digest(
                    runs["existing_nodes"], batch), \
                    "sidecar step 2: != solve_existing_nodes"
            else:
                rec["parity_s"] = probed.pop()
                assert r.parity == "byte-identical", \
                    f"sidecar window {i} ({kind}): parity {r.parity[:400]}"
                assert _sidecar_digest(r, batch) == want[i], \
                    f"sidecar window {i} ({kind}): != the cold solve"
            lines.append({"phase": "sidecar_step", "step": 2 + i,
                          "window": kind, "node_rows_changed": dirty,
                          "in_process_s": local_s, "digest_equals": label,
                          **rec})
        sessions = srv.sessions_snapshot(rep)
        session.close()
    steps = list(lines)
    lines.append({
        "phase": "sidecar", "device": device, "pods": len(pods),
        "instance_types": len(catalog), "nodes": len(nodes),
        "steps": len(steps),
        # a window's wall less its parity re-solve, over the cold step's
        "warm_share_of_cold": {
            ln["window"]: (ln["s"] - ln["parity_s"]) / steps[0]["s"]
            for ln in steps[2:]},
        "sessions": sessions,
        "held_equal_at_path_shapes": _held_lines(held)})
    for name in FEASIBILITY:
        assert any(k[0] == name for k in held), name
    return lines, want


def _held_lines(held) -> list:
    return [{"name": name, "shapes": [list(x) for x in shapes],
             "max_abs_err": err}
            for (name, shapes), err in sorted(held.items())]


def sidecar_fleet_phase(device, pool, catalog, pods, span, runs,
                        want) -> dict:
    """Two Replicas of the port's sidecar on ``device`` with one shared
    HandoffStore, each naming the other its peer. A fleet SolverSession
    solves step 1 and step 2 of the sidecar phase on its home replica;
    the home drains (every session exported to the store), the client
    follows the draining NACK's ``migrated_to`` rider, and the peer
    restores the session from the checkpoint for the next solve (the
    wobble window): a migration, no resync, the digest of the cold
    in-process solve of the same inputs (``want``)."""
    from karpenter_tpu_torch.metrics.registry import SIDECAR_MIGRATIONS
    from karpenter_tpu_torch.ops import kernels
    from karpenter_tpu_torch.sidecar import server as srv
    from karpenter_tpu_torch.sidecar.client import RetryPolicy, SolverSession
    handoff = srv.HandoffStore()
    reps = [srv.Replica(name=f"smoke-fleet-{i}", handoff=handoff)
            for i in range(2)]
    restore = srv.restore_session_checkpoint
    restored: list = []

    def timed_restore(data, device=None):
        t0 = time.perf_counter()
        out = restore(data, device=device)
        restored.append(time.perf_counter() - t0)
        return out
    srv.restore_session_checkpoint = timed_restore
    with _restored(srv, "restore_session_checkpoint", restore):
        with _process_state_kept(), \
                _held_at_each_shape(kernels) as held, \
                _serving(device, reps[0]) as (server_a, addr_a, _), \
                _serving(device, reps[1]) as (server_b, addr_b, _):
            reps[0].peers, reps[1].peers = (addr_b,), (addr_a,)
            servers = {addr_a: (server_a, reps[0]),
                       addr_b: (server_b, reps[1])}
            session = SolverSession(addr_a, tenant="smoke-fleet",
                                    retry=RetryPolicy(deadline=600.0))
            session.enable_fleet([addr_a, addr_b])
            wire = _Wire(session)
            home = session.address
            nodes = existing_nodes(catalog)
            windows = churn_windows(pods, nodes, span)
            steps = []
            r, rec = sidecar_step(session, wire, pool, catalog, pods)
            assert _sidecar_digest(r, pods) == _local_digest(
                runs["cold"], pods), "fleet step 1: != solve_cold"
            steps.append({"step": 1, "replica": home, **rec})
            _, _, batch, _ = next(windows)
            r, rec = sidecar_step(session, wire, pool, catalog, batch, nodes)
            assert _sidecar_digest(r, batch) == _local_digest(
                runs["existing_nodes"], batch), "fleet step 2"
            steps.append({"step": 2, "replica": home, **rec})
            sid = session._session_id
            t0 = time.perf_counter()
            shed = servers[home][0].drain(grace=10.0)
            drain_s = time.perf_counter() - t0
            migrations = SIDECAR_MIGRATIONS.value({"reason": "restore"})
            i, kind, batch, _ = next(windows)
            r, rec = sidecar_step(session, wire, pool, catalog, batch, nodes)
            peer = session.address
            assert peer != home and session.failovers == 1, \
                (home, peer, session.failovers)
            assert SIDECAR_MIGRATIONS.value({"reason": "restore"}) == \
                migrations + 1, "the peer did not restore the session"
            assert session.resyncs == 0, "the migration cost a resync"
            restored_session = servers[peer][1].sessions[sid]
            assert restored_session.resyncs == 0
            assert _sidecar_digest(r, batch) == want[i], \
                f"fleet window {i} ({kind}): != the cold solve"
            steps.append({"step": 3, "window": kind, "replica": peer,
                          **rec})
            session.close()
    assert len(restored) == 1, restored
    for name in FEASIBILITY:
        assert any(k[0] == name for k in held), name
    return {"phase": "sidecar_fleet", "device": device, "steps": steps,
            "drain_s": drain_s, "shed": shed,
            "restore_s": restored[0], "handoff_puts": handoff.puts,
            "handoff_restores": handoff.restores,
            "failovers": 1, "resyncs": 0, "digest_equals": True,
            "held_equal_at_path_shapes": _held_lines(held)}


def _child_line(proc, deadline: float, pattern: str, who: str):
    """The match of ``pattern`` on the first line of the child's stdout
    that has one (its stdout read on a thread, so a wait never blocks past
    the deadline)."""
    import queue
    import re
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    while time.perf_counter() < deadline:
        try:
            line = lines.get(timeout=1.0)
        except queue.Empty:
            if proc.poll() is not None:
                raise RuntimeError(f"{who} exited with {proc.returncode} "
                                   f"before printing /{pattern}/")
            continue
        m = re.match(pattern, line)
        if m:
            return m
    raise RuntimeError(f"{who} printed no /{pattern}/ in {CHILD_BOOT_S} s")


def _child_port(proc, deadline: float) -> int:
    """The port the sidecar child prints on its line 'solver sidecar
    listening on 127.0.0.1:<port>'."""
    return int(_child_line(
        proc, deadline, r"solver sidecar listening on 127\.0\.0\.1:(\d+)",
        "the sidecar").group(1))


def sidecar_process_phase(device, pool, catalog, pods, want) -> dict:
    """The sidecar as a deployment runs it: ``python -m
    karpenter_tpu_torch.sidecar.server --device <device> --port 0`` as a
    child process, one full-width cold session solve from here (its digest
    ``want``), then SIGINT (drain and stop). Boot to first solve is timed
    from the child's start. On any failure the child's stderr is
    printed."""
    import signal
    import tempfile
    from karpenter_tpu_torch.sidecar.client import RetryPolicy, SolverSession
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryFile(mode="w+") as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "karpenter_tpu_torch.sidecar.server",
             "--device", device, "--port", "0"], cwd=root,
            stdout=subprocess.PIPE, stderr=err, text=True)
        try:
            port = _child_port(proc, t0 + CHILD_BOOT_S)
            listening_s = time.perf_counter() - t0
            session = SolverSession(f"127.0.0.1:{port}", tenant="child",
                                    retry=RetryPolicy(deadline=600.0))
            wire = _Wire(session)
            t1 = time.perf_counter()
            r = session.solve([pool], {"default": catalog}, pods)
            solve_s = time.perf_counter() - t1
            first_solve_s = time.perf_counter() - t0
            sent, received = wire.take()
            session.close()
            assert r.fallback_reason == "" and not r.degraded, \
                r.fallback_reason
            assert tuple(r.partition) == (len(pods), 0), r.partition
            assert _sidecar_digest(r, pods) == want, \
                "sidecar child: != sidecar step 1"
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=60)
            assert rc == 0, f"the sidecar exited with {rc} on SIGINT"
        except BaseException:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            err.seek(0)
            print(f"sidecar child stderr:\n{err.read()[-8000:]}",
                  file=sys.stderr, flush=True)
            raise
    return {"phase": "sidecar_process", "device": device,
            "command": f"python -m karpenter_tpu_torch.sidecar.server "
                       f"--device {device} --port 0",
            "listening_s": listening_s, "solve_s": solve_s,
            "boot_to_first_solve_s": first_solve_s,
            "request_bytes": sent, "response_bytes": received,
            "encode_kind": r.encode_kind, "exit_code": rc,
            "digest_equals_step_1": True}


def operator_sidecar_phase(device, record,
                           n_pods: int = OPERATOR_SIDECAR_PODS,
                           n_deploys: int = OPERATOR_SIDECAR_DEPLOYS,
                           n_its: int = N_ITS) -> list:
    """The port's Operator with ``solver_backend="sidecar"`` against an
    in-process port sidecar, both on ``device``: operator_run's burst
    until quiet and its consolidating scale-down, every step's store equal
    to the same run with both on the CPU; then
    whether the final store equals the in-process (tensor backend)
    operator's at the same size, on ``device`` (reported, not required).
    ``record`` is called just after the card's run."""
    from karpenter_tpu_torch.ops import kernels
    sizes = dict(n_pods=n_pods, n_deploys=n_deploys, n_its=n_its)
    with _process_state_kept():
        _reset_counts(kernels)
        t0 = time.perf_counter()
        with _held_at_each_shape(kernels) as held, \
                _serving(device) as (_, address, _):
            card = operator_run(device, sidecar=address, **sizes)
        card_s = time.perf_counter() - t0
        launches = record()
        t0 = time.perf_counter()
        with _serving("cpu") as (_, address, _):
            cpu = operator_run("cpu", sidecar=address, **sizes)
        cpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tensor = operator_run(device, **sizes)
        tensor_s = time.perf_counter() - t0
    assert len(card["digests"]) == len(cpu["digests"]), \
        (len(card["digests"]), len(cpu["digests"]))
    for i, (g, c) in enumerate(zip(card["digests"], cpu["digests"])):
        assert g == c, f"operator_sidecar step {i}: the card's and the " \
                       f"CPU's stores differ"
    bad = [r for r in card["fallbacks"] if r]
    assert not bad and card["fallbacks"], \
        f"operator_sidecar: solves fell back to the host oracle: {bad[:3]}"
    for name in FEASIBILITY:
        assert launches[name] > 0, f"operator_sidecar: {name} never launched"
        assert any(k[0] == name for k in held), name
    lines = [{"phase": "operator_sidecar_step", **g, "cpu_s": c["s"],
              "digest_equals_cpu": True}
             for g, c in zip(card["steps"], cpu["steps"], strict=True)]
    last = card["steps"][-1]
    lines.append({
        "phase": "operator_sidecar", "pods": card["pods"],
        "reduced": f"pods: {n_pods} ({n_deploys} deployments x "
                   f"{n_pods // n_deploys}; the operator phase runs "
                   f"{N_PODS // N_DEPLOYS * N_DEPLOYS})",
        "steps": len(card["steps"]),
        "scale_down_steps": sum(s["stage"] == "scale_down"
                                for s in card["steps"]),
        "commands": [list(c) for c in card["commands"]],
        "s": card_s, "cpu_s": cpu_s,
        "steps_s": sum(s["s"] for s in card["steps"]),
        "cpu_steps_s": sum(s["s"] for s in cpu["steps"]),
        "launches": {k: v for k, v in launches.items() if v},
        "claims": last["claims"], "nodes": last["nodes"],
        "bound": last["bound"], "unschedulable": card["unschedulable"],
        "solves": len(card["fallbacks"]), "fallbacks": 0,
        "digest_equals_cpu_every_step": True,
        "tensor_backend_s": tensor_s,
        "tensor_backend_steps": len(tensor["steps"]),
        "final_store_equals_tensor_backend":
            card["digests"][-1] == tensor["digests"][-1],
        "held_equal_at_path_shapes": _held_lines(held)})
    return lines


# --------------------------------------------------------------------------
# the fleet simulator and the mesh across processes on the card
# --------------------------------------------------------------------------

#: the simulator's pins (the JAX package's, data in the repo)
SIM_GOLDEN = os.path.join("tests", "goldens", "sim-regression.json")
#: mixed-day's whole day: its ledger digest and entries from the JAX
#: package on the CPU (python -c "import jax;
#: jax.config.update('jax_platforms', 'cpu'); from karpenter_tpu.sim
#: import FleetSimulator, load_scenario; r = FleetSimulator(load_scenario(
#: 'karpenter_tpu/sim/scenarios/mixed-day.yaml')).run();
#: print(r['ledger_digest'], r['ledger_entries'])")
MIXED_DAY_DIGEST = \
    "25b1c0ac3920642aa4c6e3132159847d3a662f235f47b7810043c94e0c157bf4"
MIXED_DAY_ENTRIES = 1390
#: the second run replays the day's first quarter only: its digest and
#: entries from the JAX package on the CPU, the same command with the
#: scenario's events and duration clipped at MIXED_DAY_CLIP (as _scenario
#: clips them)
MIXED_DAY_CLIP = 21_600.0
MIXED_DAY_CLIP_DIGEST = \
    "5bed23d9c690636e85278cd2d76f5ddd900acb5b7cacf327e054f5fbcd335496"
MIXED_DAY_CLIP_ENTRIES = 395
#: the simulated-to-wall ratio a whole day must beat (bench.py bench_sim)
SIM_COMPRESSION = 100
#: the mesh across processes: two processes, each with half the slots
MESH_PROCESSES = 2
#: seconds each mesh process may take, its boot and rendezvous included
MESH_CHILD_S = 600


def _scenario(name: str, clip=None):
    """A scenario of the port's library, clipped to its first ``clip``
    simulated seconds."""
    from karpenter_tpu_torch.sim import load_scenario
    sc = load_scenario(os.path.join(_ROOT, "karpenter_tpu_torch", "sim",
                                    "scenarios", name))
    if clip is not None:
        clip = min(clip, sc.duration)
        sc.events = [e for e in sc.events if e.at <= clip]
        sc.duration = clip
    return sc


def _ladder() -> dict:
    """The device-loss ladder's counters so far."""
    from karpenter_tpu_torch.metrics.registry import STATE_AUDIT
    return {oc: STATE_AUDIT.value({"layer": "device", "outcome": oc})
            for oc in ("killed", "carve", "single", "readmitted")}


def _chaos_counts(sim, ladder: dict) -> dict:
    """What a chaos replay injected, what its auditor detected, and what
    was healed: each detected fault's layer quarantined and rebuilt cold
    in the pass that found it, and each pass that met a killed slot
    re-placed by the ladder on a carve or a single slot (``ladder``: its
    counters before the replay)."""
    after = _ladder()
    device = {k: after[k] - ladder[k] for k in after}
    detected = {k.split(":", 1)[1]: v
                for k, v in sim.state_auditor.stats.items()
                if k.startswith("corrupt:")}
    return {"injected": len(sim.state_corruptor.injected),
            "injected_by_layer": dict(sim.state_corruptor.counts),
            "detected": sum(detected.values()),
            "detected_by_layer": detected,
            "healed": sum(detected.values()) + device["carve"]
            + device["single"],
            "ladder": device,
            "kill_hits": {str(k): v
                          for k, v in sim.device_killer.counts.items()}}


def _simulate(sc, device, **kw) -> tuple:
    """(simulator, report, seconds) of one replay on ``device``."""
    from karpenter_tpu_torch.sim import FleetSimulator
    t0 = time.perf_counter()
    sim = FleetSimulator(sc, device=device, **kw)
    report = sim.run()
    return sim, report, time.perf_counter() - t0


def sim_pinned_phase(device, record) -> list:
    """The four pinned clips of tests/goldens/sim-regression.json replayed
    on ``device``, each ledger digest and entry count equal to the pin,
    K1-K3 held at every launch shape; then state-chaos's clip once more on
    the CPU, its injected, detected and healed counts non-zero and equal
    to the card's. ``record`` is called just after the card's replays."""
    from karpenter_tpu_torch.ops import kernels
    with open(os.path.join(_ROOT, SIM_GOLDEN)) as f:
        pins = json.load(f)["pins"]
    lines, chaos = [], {}
    _reset_counts(kernels)
    with _held_at_each_shape(kernels) as held:
        for pin in pins:
            name, clip = pin["scenario"], pin["clip_seconds"]
            ladder = _ladder()
            sim, report, s = _simulate(_scenario(name, clip), device)
            assert report["ledger_digest"] == pin["ledger_digest"], \
                f"sim_pinned {name}: the ledger digest is not the pin's"
            assert report["ledger_entries"] == pin["ledger_entries"], name
            if sim.state_corruptor is not None:
                chaos[name] = (clip, _chaos_counts(sim, ladder))
            lines.append({
                "phase": "sim_pinned", "scenario": name, "clip_s": clip,
                "device": device, "s": s, "wall_s": report["wall_seconds"],
                "compression": report["compression"],
                "solver": report["solver"],
                "events_applied": report["events_applied"],
                "ledger_entries": report["ledger_entries"],
                "ledger_digest": report["ledger_digest"],
                "digest_equals_pin": True})
    launches = record()
    assert chaos, "no pinned clip injected state chaos"
    for name, (clip, card) in chaos.items():
        ladder = _ladder()
        sim, _, cpu_s = _simulate(_scenario(name, clip), "cpu")
        cpu = _chaos_counts(sim, ladder)
        assert card["injected"] and card["detected"] and card["healed"], \
            card
        assert card["ladder"]["killed"] and card["kill_hits"], card
        assert card == cpu, \
            f"sim_pinned {name}: the card's chaos {card} != the CPU's {cpu}"
        next(x for x in lines if x["scenario"] == name).update(
            chaos=card, chaos_equals_cpu=True, cpu_s=cpu_s)
    for name in FEASIBILITY:
        assert launches[name] > 0, f"sim_pinned: {name} never launched"
        assert any(k[0] == name for k in held), name
    lines.append({"phase": "sim_pinned_launches",
                  "launches": {k: v for k, v in launches.items() if v},
                  "held_equal_at_path_shapes": _held_lines(held)})
    return lines


def sim_mixed_day_phase(device, record) -> list:
    """mixed-day on ``device``, as bench.py's bench_sim holds it: the whole
    24 h (digest MIXED_DAY_DIGEST, exactly one SLO breach with exactly one
    flight dump, whose records join the ledger's solves by trace id), then
    its first MIXED_DAY_CLIP seconds again (digest MIXED_DAY_CLIP_DIGEST,
    no breach, its ledger the whole day's first entries but for trace
    ids); each a compression of at least SIM_COMPRESSION. K1-K3 held at
    every launch shape; ``record`` is called just after the runs."""
    import tempfile
    from karpenter_tpu_torch.ops import kernels
    lines, digests, ledgers = [], [], []
    _reset_counts(kernels)
    with _held_at_each_shape(kernels) as held:
        for run, clip in enumerate((None, MIXED_DAY_CLIP)):
            with tempfile.TemporaryDirectory() as dumps:
                sim, report, s = _simulate(_scenario("mixed-day.yaml", clip),
                                           device, flightrec_dir=dumps)
                files = sorted(os.listdir(dumps))
                records = [json.loads(line)
                           for name in files
                           for line in open(os.path.join(dumps, name))
                           if line.strip()]
            digests.append(report["ledger_digest"])
            ledgers.append([{k: v for k, v in e.items() if k != "trace_id"}
                            for e in sim.ledger.entries])
            breaches = report["breaches"]
            want = 1 if clip is None else 0
            assert len(breaches) == len(files) == want, \
                f"sim_mixed_day: {len(breaches)} breaches, {files}"
            if breaches:
                trace_id = breaches[0]["trace_id"]
                solves = {e.get("trace_id") for e in sim.ledger.entries
                          if e["kind"] == "solve"}
                assert records and trace_id in solves and all(
                    r["meta"]["trace_id"] == trace_id for r in records), \
                    "sim_mixed_day: the dump does not join the ledger"
            assert report["compression"] >= SIM_COMPRESSION, \
                f"sim_mixed_day: compression {report['compression']}"
            lines.append({
                "phase": "sim_mixed_day", "run": run, "device": device,
                "clip_s": clip,
                "s": s, "sim_s": report["sim_seconds"],
                "wall_s": report["wall_seconds"],
                "compression": report["compression"],
                "solver": report["solver"],
                "time_to_schedule": report["time_to_schedule"],
                "cost": report["cost"], "churn": report["churn"],
                "attribution": report["attribution"],
                "breaches": len(breaches), "dump_records": len(records),
                "dump_joins_ledger": bool(breaches),
                "ledger_entries": report["ledger_entries"],
                "ledger_digest": report["ledger_digest"]})
    launches = record()
    assert digests == [MIXED_DAY_DIGEST, MIXED_DAY_CLIP_DIGEST], \
        f"sim_mixed_day: {digests} are not the JAX package's"
    assert [ln["ledger_entries"] for ln in lines] == \
        [MIXED_DAY_ENTRIES, MIXED_DAY_CLIP_ENTRIES]
    assert ledgers[0][:MIXED_DAY_CLIP_ENTRIES] == ledgers[1], \
        "sim_mixed_day: the clipped run is not the day's beginning"
    for name in FEASIBILITY:
        assert launches[name] > 0, f"sim_mixed_day: {name} never launched"
        assert any(k[0] == name for k in held), name
    lines.append({"phase": "sim_mixed_day_launches",
                  "digest_equals_reference": True, "deterministic": True,
                  "launches": {k: v for k, v in launches.items() if v},
                  "held_equal_at_path_shapes": _held_lines(held)})
    return lines


def mesh_child(rank: int, port: int, out: str, device: str = DEVICE,
               n_pods: int = N_PODS, n_deploys: int = N_DEPLOYS,
               n_its: int = N_ITS) -> None:
    """One process of the mesh_multiprocess phase: joins the fleet over
    gloo on 127.0.0.1, builds the mesh of both processes' slots (half of
    MESH_SLOTS each, over this process's own ``device``), and solves the
    batch cold through it (the north-star's unless sizes are given), a
    warm-up and REPEATS - 1 timed solves, each kernel held at every launch
    shape. Writes its digest, times, launches and holds to ``out`` as
    JSON."""
    import torch
    from karpenter_tpu_torch.cloudprovider.kwok import construct_catalog
    from karpenter_tpu_torch.obs.tracer import TRACER
    from karpenter_tpu_torch.ops import kernels
    from karpenter_tpu_torch.parallel import mesh as tmesh
    from karpenter_tpu_torch.provisioning import tensor_scheduler as ts_mod
    t0 = time.perf_counter()
    assert tmesh.init_multihost(f"127.0.0.1:{port}", MESH_PROCESSES,
                                rank) == MESH_PROCESSES
    mesh = tmesh.make_solver_mesh(
        devices=[torch.device(device)] * (MESH_SLOTS // MESH_PROCESSES))
    assert tmesh.is_multiprocess(mesh), repr(mesh)
    joined_s = time.perf_counter() - t0
    catalog, pool, pods = construct_catalog(n_its), default_pool(), \
        bench_pods(n_pods, n_deploys)
    kernels.reset_launches()
    with _held_at_each_shape(kernels) as held:
        solves = [_solve(ts_mod, pool, catalog, pods, (), None, mesh=mesh)
                  for _ in range(REPEATS)]
        launches = dict(kernels.LAUNCHES)
    _, results, _ = min(solves[1:], key=lambda x: x[2])
    digests = {json.dumps(_local_digest(r, pods), sort_keys=True)
               for _, r, _ in solves}
    assert len(digests) == 1, "the fleet's solves differ from each other"
    with open(out, "w") as f:
        json.dump({"rank": rank, "mesh": repr(mesh), "pods": len(pods),
                   "instance_types": len(catalog),
                   "slots": [[s.id, s.process_index, str(s.device)]
                             for s in mesh.devices.flat],
                   "joined_s": joined_s, "s": [x[2] for x in solves],
                   "best_s": min(x[2] for x in solves[1:]),
                   "spans_ms": _top_spans(TRACER.last()),
                   "digest": _local_digest(results, pods),
                   "launches": launches, "held": _held_lines(held)}, f)
    torch.distributed.destroy_process_group()


def mesh_multiprocess_phase(want: dict, single_s: float,
                            device: str = DEVICE, **sizes) -> tuple:
    """The north-star cold solve (``sizes``: mesh_child's, to cut it) on
    a mesh that spans MESH_PROCESSES processes (``init_multihost`` over
    gloo on 127.0.0.1; each process its own CUDA context on the card, half
    the slots), each process's digest equal to the single-process cold
    solve's (``want``). Returns (line, the processes' launches summed,
    their holds)."""
    import socket
    import tempfile
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json")
                for r in range(MESH_PROCESSES)]
        logs = [tempfile.TemporaryFile(mode="w+", dir=tmp)
                for _ in outs]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.mesh_child({r}, {port}, "
             f"{outs[r]!r}, {device!r}, **{sizes!r})"], cwd=_ROOT, env=env, stdout=logs[r],
            stderr=subprocess.STDOUT) for r in range(MESH_PROCESSES)]
        try:
            for proc in procs:
                proc.wait(timeout=max(1.0, t0 + MESH_CHILD_S
                                      - time.perf_counter()))
            for r, proc in enumerate(procs):
                assert proc.returncode == 0, \
                    f"mesh process {r} exited with {proc.returncode}"
            wall_s = time.perf_counter() - t0
            children = []
            for path in outs:
                with open(path) as f:
                    children.append(json.load(f))
        except BaseException:
            for r, (proc, log) in enumerate(zip(procs, logs)):
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
                log.seek(0)
                print(f"mesh process {r}:\n{log.read()[-8000:]}",
                      file=sys.stderr, flush=True)
            raise
        finally:
            for log in logs:
                log.close()
    want = json.loads(json.dumps(want))
    for c in children:
        assert c["digest"] == want, \
            f"mesh process {c['rank']}: != the single-process cold solve"
    launches = {name: sum(c["launches"][name] for c in children)
                for name in children[0]["launches"]}
    held = {}
    for c in children:
        for h in c["held"]:
            held[(h["name"], tuple(map(tuple, h["shapes"])))] = \
                h["max_abs_err"]
    line = {"phase": "mesh_multiprocess", "processes": MESH_PROCESSES,
            "mesh": children[0]["mesh"], "slots": children[0]["slots"],
            "pods": children[0]["pods"],
            "instance_types": children[0]["instance_types"],
            "wall_s": wall_s,
            "joined_s": [c["joined_s"] for c in children],
            "best_s": [c["best_s"] for c in children],
            "s": [c["s"] for c in children],
            "single_process_best_s": single_s,
            "spans_ms": [c["spans_ms"] for c in children],
            "digest_equals_single_process": True,
            "launches": {k: v for k, v in launches.items() if v},
            "launches_by_process": [
                {k: v for k, v in c["launches"].items() if v}
                for c in children],
            "held_equal_at_path_shapes": _held_lines(held)}
    return line, launches, held


# --------------------------------------------------------------------------
# B5a at its edge shapes; device attribution, the profiler and the flight
# recorder on the card
# --------------------------------------------------------------------------

#: B5a's edge shapes: B around the store widths and a request tile of
#: 4,096 rows, A of one row and of the padded node axis, R of 1, 4 (the
#: int4 path) and 9
FITS_EDGES = [(A, B, R) for A in (1, 8192) for B in (1, 7, 120, 121, 4096)
              for R in (1, 4, 9)]
#: the provisioning record replayed on the card: a 1,248-pod batch (6
#: deployments x 208 pods of the benchmark mix) against the 2,000-type
#: catalog. The host oracle's greedy, which a replay runs beside the tensor
#: path, takes minutes at 4,992 pods already and grows with the batch, so
#: the 49,920-pod records are held by their digests and not replayed; the
#: batch was cut from 4,992 pods to 2,496 when the sidecar phases joined
#: the script and to 1,248 when the kube phases did, to keep it under its
#: 600 s budget (PERF.md)
REPLAY_PODS, REPLAY_DEPLOYS = 1_248, 6


def fits_matrix_edges(dev) -> list:
    """B5a held against its plain version at every edge shape, on requests
    with zero, negative, INT_MIN and INT_MAX entries (every fifth, seventh
    and eleventh word) and avail rows with INT_MAX and INT_MIN entries."""
    import numpy as np
    import torch
    from karpenter_tpu_torch.ops import feasibility as feas, kernels
    i32_min, i32_max = -2**31, 2**31 - 1
    out = []
    for A, B, R in FITS_EDGES:
        rng = np.random.default_rng(A + B + R)
        req = rng.integers(-5, 60, (B, R)).astype(np.int64)
        flat = req.reshape(-1)
        flat[::5], flat[1::7], flat[2::11] = 0, i32_min, i32_max
        avail = rng.integers(-5, 80, (A, R)).astype(np.int64)
        avail.reshape(-1)[::13] = i32_max
        avail.reshape(-1)[3::17] = i32_min
        req_d = torch.from_numpy(req.astype(np.int32)).to(dev)
        avail_d = torch.from_numpy(avail.astype(np.int32)).to(dev)
        got = kernels.fits_matrix(req_d, avail_d)
        want = feas.fits_matrix(req_d, avail_d)
        torch.cuda.synchronize()
        equal, err = _compare(got, want)
        assert equal, f"fits_matrix at A={A} B={B} R={R}: kernel and " \
                      f"plain version disagree (max abs err {err})"
        plan = kernels.fits_plan(A, B, R,
                                 aligned=avail_d.data_ptr() % 16 == 0)
        out.append({"A": A, "B": B, "R": R, "width": plan.width,
                    "vec4": plan.vec4, "tile_b": plan.tile_b,
                    "grid": [plan.grid_a, plan.grid_b], "equal": equal,
                    "fits": int(got.sum())})
    return out


def device_attribution(ts_mod, pool, catalog, pods, nodes, problems) -> dict:
    """obs.device.DEVICE_TIME on the card: the cold solve and the solve
    with nodes, each once with the tracer off and once with it on (equal
    digests and launches), then a first launch of each problem (nothing
    cached on the device) inside a reset of the allocator's peak: every
    entry has dispatches, device time and a peak within 2x of the
    allocator's growth."""
    import dataclasses
    import torch
    from karpenter_tpu_torch.flightrec.record import decision_digest
    from karpenter_tpu_torch.obs.device import DEVICE_TIME
    from karpenter_tpu_torch.obs.tracer import TRACER
    from karpenter_tpu_torch.ops import binpack, kernels
    DEVICE_TIME.clear()
    solves = {}
    for label, state in (("cold", ()), ("existing_nodes", nodes)):
        runs = {}
        for traced in (False, True):
            saved, TRACER.enabled = TRACER.enabled, traced
            kernels.reset_launches()
            try:
                _, r, s = _solve(ts_mod, pool, catalog, pods, state, DEVICE)
            finally:
                TRACER.enabled = saved
            runs[traced] = (decision_digest(r, pods, "", (len(pods), 0)),
                            dict(kernels.LAUNCHES), s)
        assert runs[True][0] == runs[False][0], \
            f"{label}: the traced solve's decisions differ"
        assert runs[True][1] == runs[False][1], \
            f"{label}: the traced solve's launches differ"
        solves[label] = {"s_traced": runs[True][2],
                         "s_untraced": runs[False][2],
                         "launches": {k: v for k, v in runs[True][1].items()
                                      if v}}
    snap = DEVICE_TIME.snapshot()
    assert len(snap) == 2, snap
    growth = {}
    for problem in problems:
        before = {e["executable"]: e["dispatches"]
                  for e in DEVICE_TIME.snapshot()}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        binpack.precompute(dataclasses.replace(problem, device_cache=None),
                           DEVICE)
        torch.cuda.synchronize()
        grew = torch.cuda.max_memory_allocated() - base
        (label,) = [e["executable"] for e in DEVICE_TIME.snapshot()
                    if e["dispatches"] != before.get(e["executable"])]
        growth[label] = grew
    entries = DEVICE_TIME.snapshot()
    for e in entries:
        assert e["dispatches"] >= 1 and e["device_seconds"] > 0, e
        ratio = e["peak_bytes"] / growth[e["executable"]]
        assert 0.5 <= ratio <= 2.0, (e, growth)
        e["allocator_growth_bytes"] = growth[e["executable"]]
        e["peak_over_growth"] = ratio
    return {"solves": solves, "device_time": entries,
            "watermarks": DEVICE_TIME.watermarks()}


def profiled_pass(device, unprofiled: dict) -> dict:
    """One Provisioner.reconcile of the north-star batch with profile_dir
    under build/ (gitignored): its Chrome trace names K1 and K2, the
    PROFILE_ACTIVE gauge reads 0 after, and its decisions equal the
    unprofiled pass's (``unprofiled``, provisioner_passes' first)."""
    import shutil
    from karpenter_tpu_torch.metrics.registry import PROFILE_ACTIVE
    from karpenter_tpu_torch.obs.profile import PROFILER
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "profile")
    shutil.rmtree(out_dir, ignore_errors=True)
    (p,) = provisioner_passes(device, passes=1, profile_dir=out_dir)
    assert p["digest"] == unprofiled["digest"], \
        "the profiled pass's decisions differ from the unprofiled pass's"
    files = os.listdir(out_dir)
    assert len(files) == 1, files
    path = os.path.join(out_dir, files[0])
    with open(path) as f:
        text = f.read()
    named = {name: text.count(f"{name}_kernel") for name in FEASIBILITY}
    assert named["combine_compat"] and named["catalog_feasibility"], \
        (named, {cat: text.count(f'"cat": "{cat}"')
                 for cat in ("kernel", "gpu_memcpy", "cuda_runtime",
                             "cpu_op")})
    assert PROFILE_ACTIVE.value() == 0.0 and not PROFILER.active
    return {"s": p["s"], "unprofiled_s": unprofiled["s"],
            "trace": os.path.relpath(path), "trace_bytes": len(text),
            "kernel_name_hits": named}


def timed_recorder():
    """A FlightRecorder whose captures are timed (``capture_seconds``)."""
    from karpenter_tpu_torch.flightrec import FlightRecorder
    rec = FlightRecorder(capacity=64)
    rec.capture_seconds = []
    for name in ("capture_provisioning", "capture_disruption"):
        def timed(*a, _inner=getattr(rec, name), **kw):
            t0 = time.perf_counter()
            _inner(*a, **kw)
            rec.capture_seconds.append(time.perf_counter() - t0)
        setattr(rec, name, timed)
    return rec


def _dumped(rec) -> tuple:
    """(JSONL lines, seconds to materialize and encode them)."""
    t0 = time.perf_counter()
    lines = rec.lines()
    return lines, time.perf_counter() - t0


def _replayed(line: str, index: int, device) -> dict:
    from karpenter_tpu_torch.flightrec import loads_record, replay_record
    t0 = time.perf_counter()
    report = replay_record(loads_record(line), index, device=device)
    s = time.perf_counter() - t0
    assert report.deterministic is True and report.parity is True, \
        report.render()
    return {"index": index, "kind": report.kind, "s": s, "match": True,
            "notes": report.notes}


def flight_recorder_phase(device) -> dict:
    """A FlightRecorder on the north-star Provisioner passes and on the
    DisruptionController passes over 5,000 nodes: every record's decision
    equals its pass's, the capture's seconds beside the pass's, the JSONL
    bytes; every disruption record and one provisioning record (a
    REPLAY_PODS batch) replayed on the card through replay_record."""
    from karpenter_tpu_torch.flightrec import FlightRecorder
    rec = timed_recorder()
    passes = provisioner_passes(device, flight_recorder=rec)
    records = rec.records()
    assert len(records) == len(passes), len(records)
    lines, dump_s = _dumped(rec)
    prov = []
    for p, r, cap in zip(passes, records, rec.capture_seconds, strict=True):
        assert r.decision == p["digest"], \
            f"provisioner pass {p['pass']}: the record's decision differs"
        prov.append({"pass": p["pass"], "s": p["s"], "capture_s": cap,
                     "capture_share": cap / p["s"], "elapsed": r.elapsed,
                     "claims": r.meta["claims"]})
    prov_bytes = sum(len(line) + 1 for line in lines)

    rec_d = timed_recorder()
    env = stuck_fleet(device, prefix="frec")
    ctrl = new_controller(env, flight_recorder=rec_d)
    dis = []
    for i in range(1 + WINDOW_REPEATS):
        s, cmd_d = controller_pass(ctrl)
        r = rec_d.records()[-1]
        assert len(rec_d) == i + 1 and r.kind == "disruption"
        assert (r.meta["command"]["decision"],
                r.meta["command"]["candidates"]) == cmd_d[:2], \
            f"controller pass {i}: the record's command differs"
        dis.append({"pass": i, "s": s, "capture_s": rec_d.capture_seconds[i],
                    "capture_share": rec_d.capture_seconds[i] / s,
                    "decision": cmd_d[0], "chosen": cmd_d[1]})
    lines_d, dump_d_s = _dumped(rec_d)
    del env, ctrl
    replays = [_replayed(line, i, device) for i, line in enumerate(lines_d)]

    rec_s = FlightRecorder()
    (small,) = provisioner_passes(device, REPLAY_PODS, REPLAY_DEPLOYS,
                                  passes=1, flight_recorder=rec_s)
    line = rec_s.lines()[-1]
    assert rec_s.records()[-1].decision == small["digest"]
    replays.append({**_replayed(line, 0, device), "pods": REPLAY_PODS,
                    "pass_s": small["s"]})
    return {"provisioner": {"passes": prov, "dump_s": dump_s,
                            "jsonl_bytes": prov_bytes},
            "disruption_controller": {
                "nodes": N_NODES, "passes": dis, "dump_s": dump_d_s,
                "jsonl_bytes": sum(len(x) + 1 for x in lines_d)},
            "replays": replays,
            "replayed_provisioning_record": {
                "pods": REPLAY_PODS, "deployments": REPLAY_DEPLOYS,
                "instance_types": N_ITS,
                "why": "the host oracle a replay runs beside the tensor "
                       "path takes minutes at 4,992 pods and grows with "
                       "the batch: the 49,920-pod records are held by "
                       "their digests"}}


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from karpenter_tpu_torch.flightrec.record import decision_digest
    from karpenter_tpu_torch.obs.tracer import TRACER, phase_millis
    from karpenter_tpu_torch.ops import binpack, kernels
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.provisioning import tensor_scheduler as ts_mod
    from karpenter_tpu_torch.provisioning.grouping import partition_pods
    from karpenter_tpu_torch.cloudprovider.kwok import construct_catalog
    from karpenter_tpu_torch.ops import encode as enc
    from karpenter_tpu_torch.parallel.mesh import (PODS_GROUPS_AXIS,
                                                   make_solver_mesh)

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
    if sys.argv[1:2] == ["--operator-kube-pods"]:
        for n in map(int, sys.argv[2:]):
            t0 = time.perf_counter()
            for line in operator_phase(DEVICE,
                                       lambda: dict(kernels.LAUNCHES),
                                       phase="operator_kube", kube=True,
                                       n_pods=n, n_deploys=KUBE_DEPLOYS):
                _emit(line)
            _emit({"phase": "operator_kube_probe", "pods": n,
                   "s": time.perf_counter() - t0})
        return

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
    # B5 at the shapes of the solve with nodes: the groups' requests
    # against the padded node rows; the groups' masks against the catalog's
    # offerings, with the masks' zone and capacity-type rows drawn from SEED
    # (a quarter of the bits set), a seeded half of the offerings available
    # and a twentieth of the zone indices moved past 32 * W, where they read
    # as admitted. Neither has a caller on a main path
    b5_rng = np.random.default_rng(SEED)

    def b5_draw(x):
        return torch.from_numpy(np.asarray(x)).to(dev)

    def b5_words():
        return b5_rng.integers(-2**31, 2**31, (G, W)).astype(np.int32)

    zk, ck = problem.zone_key, problem.captype_key
    b5_mask = group.mask.clone()
    for key in (zk, ck):
        b5_mask[:, key] = b5_draw(b5_words() & b5_words())
    b5_zone = torch.where(b5_draw(b5_rng.random((T, O)) < 0.05),
                          32 * W + b5_draw(b5_rng.integers(0, 64, (T, O))
                                           .astype(np.int32)), off_zone)
    b5_avail = off_avail & b5_draw(b5_rng.random((T, O)) < 0.5)
    b5a_in = (group_req, exist_avail)
    b5b_in = (b5_mask, zk, ck, b5_zone, off_captype, b5_avail)
    b5a = lambda: kernels.fits_matrix(*b5a_in)  # noqa: E731
    b5ap = lambda: feas.fits_matrix(*b5a_in)  # noqa: E731
    b5b = lambda: kernels.offering_compat(*b5b_in)  # noqa: E731
    b5bp = lambda: feas.offering_compat(*b5b_in)  # noqa: E731
    # offering_compat stops at the first admitted offering: count the
    # offerings these inputs make it examine
    admitted = (b5_avail[None] & feas.value_bit_ok(b5_mask[:, zk], b5_zone)
                & feas.value_bit_ok(b5_mask[:, ck], off_captype))  # [G, T, O]
    examined = int(torch.where(admitted.any(-1),
                               admitted.int().argmax(-1) + 1, O).sum())
    MG = M * G
    # each kernel's work (ops/kernels.py *_cost: the operations its bound
    # counts, each input read once and each output written once)
    checks = {
        "combine_compat": dict(
            fns=(k1, k1p), replaces="karpenter_tpu/ops/binpack.py:160",
            cost=kernels.combine_compat_cost(M, G, K, W)),
        "catalog_feasibility": dict(
            fns=(k2, k2p), replaces="karpenter_tpu/ops/binpack.py:160",
            cost=kernels.catalog_feasibility_cost(M, G, T, K, W, R, O, Z)),
        "exist_feasibility": dict(
            fns=(k3, k3p), replaces="karpenter_tpu/ops/binpack.py:616",
            cost=kernels.exist_feasibility_cost(G, N, K, W, R)),
        "fits_matrix": dict(
            fns=(b5a, b5ap), replaces="karpenter_tpu/ops/feasibility.py:120",
            cost=kernels.fits_matrix_cost(N, G, R)),
        "offering_compat": dict(
            fns=(b5b, b5bp), replaces="karpenter_tpu/ops/feasibility.py:129",
            cost=kernels.offering_compat_cost(G, T, W, O, examined)),
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
        if name in ("fits_matrix", "offering_compat"):
            # an output of one value would not tell a kernel that ignores
            # some of its inputs from a right one
            assert out_k.any() and not out_k.all(), \
                f"{name}: the inputs give an output of one value"
        bound_ms, bound_by = _bound(c["cost"].bytes, c["cost"].ops)
        rows[name] = {
            "name": name, "route": "cuda",
            "source": f"karpenter_tpu_torch/ops/csrc/{name}.cu",
            "replaces": c["replaces"], "launches": None,
            "max_abs_err": err, "equal": equal,
            "ms": _time_ms(kern), "plain_ms": _time_ms(plain),
            "device_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": c["cost"].bytes, "ops": c["cost"].ops,
            "library_ms": None}
    for name in ("fits_matrix", "offering_compat"):
        rows[name]["device_ms"] = _device_ms(
            _profile(checks[name]["fns"][0]), name)
    rows["offering_compat"]["offerings_examined"] = examined
    # each kernel alone: back-to-back launches on the inputs above, and one
    # launch at a time after a 128 MB buffer (beyond the 50 MB L2) is
    # written
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    for name, (a, kw) in {"combine_compat": ((template, group, allow_undef),
                                             {}),
                          "catalog_feasibility": (k2_in, cat),
                          "exist_feasibility": (k3_in, {}),
                          "fits_matrix": (b5a_in, {}),
                          "offering_compat": (b5b_in, {})}.items():
        rows[name].update(_alone(name, a, kw, rows[name]["bound_ms"],
                                 flush))
    rows["combine_compat"]["plan"] = kernels.combine_plan(
        M, G, K, W)._asdict()
    rows["catalog_feasibility"]["plan"] = kernels.join_plan(
        "catalog_feasibility", T, MG, K, W, R=R, O=O,
        Wz=kernels.zone_pack_layout(Z)[1], Z=Z)._asdict()
    rows["exist_feasibility"]["plan"] = kernels.join_plan(
        "exist_feasibility", N, G, K, W, R=R)._asdict()

    # B3 row_splice: the rows of one exist shard of the warm mesh (N / 4 of
    # the padded node axis) in the seven resident leaves, from host blocks.
    # "ms" is the wrapper (pinned staging, one upload, one launch),
    # "kernel_ms" and "cold_ms" the kernel alone on staged rows (as K1-K3);
    # the plain version copies each host block into its slice, the library
    # call each device block
    mesh8 = make_solver_mesh(devices=[dev] * MESH_SLOTS)
    span = enc.shard_spans(N, mesh8.shape[PODS_GROUPS_AXIS])[CHURN_SHARD]
    leaves = list(exist) + [exist_avail]
    rng = np.random.default_rng(SEED)
    blocks = [_random_rows(rng, x, span[1] - span[0]) for x in leaves]
    bufs_k = [x.clone() for x in leaves]
    bufs_p = [x.clone() for x in leaves]
    kernels.row_splice(bufs_k, blocks, span[0])
    kernels.row_splice_plain(bufs_p, blocks, span[0])
    torch.cuda.synchronize()
    equal, err = _compare(bufs_k, bufs_p)
    assert equal, f"row_splice: kernel and plain version disagree (max abs " \
                  f"err {err})"
    staged = kernels.stage_rows(blocks, dev)
    dev_blocks = [b.to(dev) for b in blocks]
    splice = kernels.row_splice_cost(_nbytes(*blocks))
    bound_ms, bound_by = _bound(splice.bytes, splice.ops)

    def library():
        for buf, b in zip(bufs_p, dev_blocks):
            buf[span[0]:span[1]].copy_(b)

    prof = _profile(lambda: kernels.row_splice(bufs_k, blocks, span[0]))
    rows["row_splice"] = {
        "name": "row_splice", "route": "cuda",
        "source": "karpenter_tpu_torch/ops/csrc/row_splice.cu",
        "replaces": "karpenter_tpu/parallel/mesh.py:264", "launches": None,
        "max_abs_err": err, "equal": equal,
        "ms": _time_ms(lambda: kernels.row_splice(bufs_k, blocks, span[0])),
        **_alone("row_splice", (bufs_k, staged, span[0]), {}, bound_ms,
                 flush),
        "plain_ms": _time_ms(
            lambda: kernels.row_splice_plain(bufs_p, blocks, span[0])),
        "device_ms": _device_ms(prof, "row_splice"),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes": splice.bytes, "ops": splice.ops, "rows": span[1] - span[0],
        "library_ms": _time_ms(library)}
    _emit({"phase": "kernels_vs_plain", "kernels": [
        {"name": r["name"], "replaces": r["replaces"],
         "ms": r["ms"], "kernel_ms": r.get("kernel_ms"),
         "cold_ms": r.get("cold_ms"), "plain_ms": r["plain_ms"],
         "equal": r["equal"]} for r in rows.values()]})

    # B5a, redesigned: held at every edge shape; its plan and numbers at the
    # solve's shape (the groups' requests against the padded node rows)
    fm = rows["fits_matrix"]
    fm["plan"] = kernels.fits_plan(
        N, G, R, aligned=exist_avail.data_ptr() % 16 == 0)._asdict()
    _emit({"phase": "fits_matrix",
           "solve_shape": {"A": N, "B": G, "R": R, **{
               k: fm[k] for k in ("plan", "kernel_ms", "cold_ms", "ms",
                                  "device_ms", "bound_ms", "bound_by",
                                  "share", "cold_share")}},
           "edges": fits_matrix_edges(dev)})

    # 4 + 5. the main path: cold solve, then against existing nodes. Each
    # path below zeroes the launch counts just before it and reads them
    # just after
    paths, tiles, k1_plans = {}, {}, {}

    def record(path: str) -> None:
        """The path's launches, K2 / K3 tiles and K1 geometries."""
        paths[path] = dict(kernels.LAUNCHES)
        tiles[path], k1_plans[path] = _tiles(paths[path])
    _record_tiles(kernels)
    _reset_counts(kernels)
    runs, best_s = {}, {}
    for label, state in (("cold", ()), ("existing_nodes", nodes)):
        _solve(ts_mod, pool, catalog, pods, state, DEVICE)  # warm-up
        best = None
        for _ in range(REPEATS):
            ts, results, elapsed = _solve(ts_mod, pool, catalog, pods, state,
                                          DEVICE)
            if best is None or elapsed < best[0]:
                best = (elapsed, TRACER.last(), results)
        elapsed, trace, results = best
        runs[label], best_s[label] = results, elapsed
        _emit({"phase": f"solve_{label}", "pods": len(pods),
               "instance_types": len(catalog), "existing_nodes": len(state),
               "best_s": elapsed, "pods_per_s": len(pods) / elapsed,
               "nodes_launched": len(results.new_nodeclaims),
               "existing_used": sum(1 for en in results.existing_nodes
                                    if en.pods),
               "errors": len(results.pod_errors),
               "errors_by_kind": _errors_by_kind(pods, results),
               "phases_ms": phase_millis(trace) if trace else {}})
    record("solve")

    # device time and idle share of one solve of each kind, from a trace;
    # each kernel's device time per launch from the solve with nodes, which
    # launches all three
    for label, state in (("cold", ()), ("existing_nodes", nodes)):
        prof = _profile(
            lambda: _solve(ts_mod, pool, catalog, pods, state, DEVICE))
        _emit({"phase": f"profile_{label}", **prof})
    for name in FEASIBILITY:
        rows[name]["device_ms"] = _device_ms(prof, name)

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

    # 7. the solve against the nodes through a 1x1 mesh (every CUDA device
    # of the machine: its one card) and through the 8-slot mesh over the
    # card: the single-device decisions, on the ladder's "mesh" rung; the
    # 8-slot solve once more under the profiler (K1 + K2 on every slot, K3
    # once per pods_groups row)
    for label, m in (("1x1", make_solver_mesh()), ("4x2", mesh8)):
        rungs = _rungs()
        _reset_counts(kernels)
        _solve(ts_mod, pool, catalog, pods, nodes, None, mesh=m)  # warm-up
        best = None
        for _ in range(REPEATS - 1):
            _, results, elapsed = _solve(ts_mod, pool, catalog, pods, nodes,
                                         None, mesh=m)
            if best is None or elapsed < best[0]:
                best = (elapsed, TRACER.last(), results)
        record(f"solve_mesh_{label}")
        assert _rungs() == rungs, f"left the mesh rung: {_rungs()}"
        same = decision_digest(best[2], pods, "", (len(pods), 0)) == \
            decision_digest(runs["existing_nodes"], pods, "", (len(pods), 0))
        assert same, f"the {label} mesh solve differs from the single-device " \
                     "solve"
        _emit({"phase": f"solve_mesh_{label}", "mesh": repr(m),
               "best_s": best[0], "pods_per_s": len(pods) / best[0],
               "digest_equals_single": same, "rung": "mesh",
               "spans_ms": _top_spans(best[1])})
    # the inputs of K1 on the first 4x2 slot (32 groups a slot), kept from
    # one more 4x2 solve outside every timed window
    with _keeping_k1_inputs(kernels) as kept:
        _solve(ts_mod, pool, catalog, pods, nodes, None, mesh=mesh8)
    assert len(kept) == 1, f"4x2 mesh K1 shapes: {set(kept)}"
    (slot_key, slot_in), = kept.items()
    prof = _profile(lambda: _solve(ts_mod, pool, catalog, pods, nodes, None,
                                   mesh=mesh8))
    _emit({"phase": "profile_mesh_4x2", **prof})
    # K1 on the inputs of the first 4x2 slot: held, timed alone, beside its
    # device time per launch in the profiled 4x2 solve
    sM, sG, sK, sW = slot_key
    slot = hold("combine_compat", slot_in, {},
                kernels.combine_compat_cost(sM, sG, sK, sW), flush,
                {"M": sM, "G": sG, "K": sK, "W": sW},
                kernels.combine_plan(sM, sG, sK, sW))
    slot["device_ms"] = _device_ms(prof, "combine_compat")
    rows["combine_compat"]["mesh_slot"] = slot
    _emit({"phase": "k1_at_mesh_slot", **slot})
    # B4 as one program: the 4x2 mesh's whole precompute of the problem
    # with nodes (uploads cached; every slot launched, fetched and
    # assembled), held against and timed beside the same with each
    # kernel's plain version on the same CUDA tensors; no launch counts
    from karpenter_tpu_torch.parallel.mesh import sharded_precompute
    b4 = lambda: sharded_precompute(problem_x, mesh8)  # noqa: E731
    with _uncounted(kernels):
        b4_out, b4_ms = b4(), _time_ms(b4, runs=5, warmup=1)
        with _plain_kernels(kernels):
            b4_plain, b4_plain_ms = b4(), _time_ms(b4, runs=5, warmup=1)
    b4_equal = all(np.array_equal(v, getattr(b4_plain, f))
                   for f, v in vars(b4_out).items())
    assert b4_equal, "B4: the sharded precompute differs from its plain " \
                     "version"
    _emit({"phase": "b4_sharded_precompute", "mesh": repr(mesh8),
           "ms": b4_ms, "plain_ms": b4_plain_ms, "equal": b4_equal})

    # 8. warm passes through one ProblemState on the card, each held to a
    # cold solve of the same inputs; the nodes are a fresh copy that the
    # windows change in place
    _reset_counts(kernels)
    cold_digests, recs = warm_churn(ts_mod, pool, catalog, pods,
                                    existing_nodes(catalog), span, DEVICE)
    record("warm_churn")
    _emit({"phase": "warm_churn_summary", "by_window": _summary(recs)})

    # 9. the same windows through the sharded ProblemState on an 8-slot
    # mesh over the card (4x2: four exist shards, so a rollout splices the
    # churned shard's rows and leaves three spans resident), held to a cold
    # mesh solve and to the single-device cold solve of each pass
    rungs = _rungs()
    _reset_counts(kernels)
    _, recs = warm_churn(ts_mod, pool, catalog, pods,
                         existing_nodes(catalog), span, DEVICE, mesh=mesh8,
                         cold_digests=cold_digests, phase="warm_churn_mesh")
    record("warm_churn_mesh")
    assert _rungs() == rungs, f"left the mesh rung: {_rungs()}"
    _emit({"phase": "warm_churn_mesh_summary", "mesh": repr(mesh8),
           "by_window": _summary(recs)})

    # 10. the cold solve with the pods/groups-sharded pack: the decisions
    # of the same solve through the plain versions on the CPU, and the pod
    # errors of the sequential pack (mesh.sharded_pack's contract)
    _reset_counts(kernels)
    _solve(ts_mod, pool, catalog, pods, (), DEVICE,
           pack_shards=PACK_SHARDS)  # warm-up
    _, sharded, elapsed = _solve(ts_mod, pool, catalog, pods, (), DEVICE,
                                 pack_shards=PACK_SHARDS)
    trace = TRACER.last()
    record("solve_sharded_pack")
    assert "pack.shards" in phase_millis(trace), "the pack was not sharded"
    _, sharded_cpu, cpu_s = _solve(ts_mod, pool, catalog, pods, (), "cpu",
                                   pack_shards=PACK_SHARDS)
    same = decision_digest(sharded, pods, "", (len(pods), 0)) == \
        decision_digest(sharded_cpu, pods, "", (len(pods), 0))
    assert same, "sharded pack: cuda and cpu decisions differ"
    assert sharded.pod_errors == runs["cold"].pod_errors, \
        "sharded pack: pod errors differ from the sequential pack's"
    _emit({"phase": "solve_sharded_pack", "shards": PACK_SHARDS,
           "s": elapsed, "cpu_solve_s": cpu_s, "digest_equals_cpu": same,
           "errors": len(sharded.pod_errors),
           "nodes_launched": len(sharded.new_nodeclaims),
           "sequential_nodes_launched": len(runs["cold"].new_nodeclaims),
           "spans_ms": _top_spans(trace)})

    # 11. the Provisioner loop: the north-star batch through
    # Provisioner.reconcile, cold and then warm after a rollout, each pass's
    # decisions equal to the same pass through the plain versions on the CPU
    _reset_counts(kernels)
    gpu_passes = provisioner_passes(DEVICE)
    record("provisioner_pass")
    cpu_passes = provisioner_passes("cpu")
    for g, c in zip(gpu_passes, cpu_passes, strict=True):
        assert g["digest"] == c["digest"], \
            f"provisioner pass {g['pass']}: cuda and cpu decisions differ"
        _emit({"phase": "provisioner_pass", "pass": g["pass"],
               "window": ("cold", "rollout")[g["pass"]], "s": g["s"],
               "cpu_s": c["s"], "claims_created": g["claims_created"],
               "errors": g["errors"], "existing_used": g["existing_used"],
               "digest_equals_cpu": True, "ps_last": g["ps_last"],
               "spans_ms": _top_spans(g["trace"])})
    _emit({"phase": "provisioner_pass_launches",
           "launches": paths["provisioner_pass"]})

    # 12. multi-node consolidation over BASELINE config 4's fleet: 5,000
    # underutilized nodes x the kwok 144-type catalog, the budget lifted;
    # the command equal to the plain versions' on the CPU
    env = underutilized_fleet(DEVICE)
    _reset_counts(kernels)
    cands, cmd, seconds, probes, trace, method = multi_consolidation(env)
    record("consolidation_multi")
    assert len(cands) == N_NODES, len(cands)
    assert cmd.candidates, "no consolidation decision found"
    multi_cands = sorted(cands, key=lambda c: c.disruption_cost)[:100]
    multi_shapes = encoding_shapes(env, multi_cands)
    before = dict(kernels.LAUNCHES)
    prof = _profile(lambda: multi_consolidation(env, repeats=0))
    profiled = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    # K1-K3 at the disruption encode's shapes (G padded to 8, W = 8): held
    # against their plain versions, timed alone, beside the device time of
    # their launches in the profiled pass
    for name, r in join_holds(disruption_encoding(env, multi_cands).problem,
                              dev, flush).items():
        r["device_ms"] = _device_ms(prof, name)
        rows[name]["disruption"] = r
    _emit({"phase": "kernels_at_disruption_shape", "kernels": {
        name: rows[name]["disruption"] for name in FEASIBILITY}})
    cpu_env = underutilized_fleet("cpu")
    _, cpu_cmd, cpu_seconds, _, _, _ = multi_consolidation(cpu_env,
                                                           repeats=0)
    assert command_digest(cmd) == command_digest(cpu_cmd), \
        "multi-node consolidation: cuda and cpu commands differ"
    _emit({"phase": "consolidation_multi", "nodes": N_NODES,
           "instance_types": len(env.catalog), "candidates": len(cands),
           "cold_s": seconds[0], "best_s": min(seconds[1:]), "s": seconds,
           "cpu_s": cpu_seconds[0], "decision": cmd.decision,
           "command_candidates": len(cmd.candidates),
           "replacements": len(cmd.replacements),
           "replacement_options": [len(r.instance_type_options)
                                   for r in cmd.replacements],
           "probes": probes, "engine": method.last_multi_engine_stats,
           "shapes": multi_shapes,
           "command_equals_cpu": True,
           "launches_per_pass": {k: v // (1 + REPEATS) for k, v in
                                 paths["consolidation_multi"].items()},
           "spans_ms": _top_spans(trace, 12),
           "profile": {**prof, "launches": profiled}})
    del env, cpu_env

    # 13. single-node consolidation at 5,000 candidates, every candidate but
    # the last unconsolidatable: the last one wins, classified with no
    # per-candidate fallback simulation, equal to the CPU's command
    env = stuck_fleet(DEVICE)
    _reset_counts(kernels)
    cands, cmd_d, seconds, stats, trace = single_consolidation(env)
    record("consolidation_single")
    single_shapes = encoding_shapes(env, cands)
    assert len(cands) == N_NODES, len(cands)
    assert cmd_d[:2] == ("delete", [f"single-node-{N_NODES - 1:05d}"]), cmd_d
    assert stats is not None and stats["needs_sim"] == 0, stats
    assert stats["probes"] == 1, stats
    cpu_env = stuck_fleet("cpu")
    _, cpu_cmd_d, cpu_seconds, _, _ = single_consolidation(cpu_env,
                                                           repeats=0)
    assert cmd_d == cpu_cmd_d, \
        "single-node consolidation: cuda and cpu commands differ"
    _emit({"phase": "consolidation_single", "candidates": len(cands),
           "instance_types": len(env.catalog), "cold_s": seconds[0],
           "best_s": min(seconds[1:]), "s": seconds, "cpu_s": cpu_seconds[0],
           "decision": cmd_d[0], "chosen": cmd_d[1], "engine": stats,
           "shapes": single_shapes,
           "command_equals_cpu": True,
           "spans_ms": _top_spans(trace, 12)})
    del cpu_env

    # 14. the DisruptionController over the same shape of fleet (a fresh
    # one, N_NODES nodes, which cuts bench.py's default of 50,000): a cold
    # pass through all four methods, then warm passes served by the
    # streaming state, each equal to a fresh controller's cold rebuild and
    # to the cold pass on the CPU
    del env
    env = stuck_fleet(DEVICE, prefix="dscale")
    ctrl = new_controller(env)
    _reset_counts(kernels)
    passes = []
    for i in range(1 + WINDOW_REPEATS):
        before = dict(kernels.LAUNCHES)
        last = TRACER.last()
        s, cmd_d = controller_pass(ctrl)
        # one trace per method that had candidates (disruption.pass roots)
        traces = traces_since(last.trace_id if last else None)
        stream = ctrl.stream
        passes.append({
            "pass": i, "kind": "warm" if i else "cold", "s": s,
            "command": cmd_d,
            "launches": {k: kernels.LAUNCHES[k] - before[k] for k in before
                         if kernels.LAUNCHES[k] - before[k]},
            "layers": stream.last.get("layers"),
            "rows_rebuilt": stream.last.get("rows_rebuilt"),
            "rows_reused": stream.last.get("rows_reused"),
            "encodes": sum(sp.name == "disruption.encode"
                           for t in traces for sp in t.spans),
            "probes": sum(sp.name == "disruption.sim"
                          for t in traces for sp in t.spans),
            "spans_ms": merged_spans(traces)})
        if i:
            assert set(stream.last["layers"].values()) == {"reused"}, \
                stream.last
            assert stream.last["rows_rebuilt"] == 0, stream.last
    record("disruption_controller")
    decision = passes[0]["command"]
    assert decision[:2] == ("delete", [f"dscale-node-{N_NODES - 1:05d}"]), \
        decision
    _, fresh = controller_pass(new_controller(env))
    cpu_env = stuck_fleet("cpu", prefix="dscale")
    cpu_s, cpu_decision = controller_pass(new_controller(cpu_env))
    for p in passes:
        assert p["command"] == fresh == cpu_decision, \
            f"controller pass {p['pass']}: != the cold rebuild or the cpu"
        p["command_equals_cold_rebuild_and_cpu"] = True
        _emit({"phase": "disruption_controller", "nodes": N_NODES,
               "reduced": f"nodes: {N_NODES} (bench.py's default is 50000)",
               **{k: v for k, v in p.items() if k != "command"},
               "decision": decision[0], "chosen": decision[1]})
    _emit({"phase": "disruption_controller_cpu", "cold_s": cpu_s})
    del env, cpu_env

    # 14b. the operator: its whole roster over the north-star burst, then a
    # scale-down that consolidates; every step's store equal to the same
    # step on the CPU
    def record_operator() -> dict:
        record("operator")
        return paths["operator"]
    for line in operator_phase(DEVICE, record_operator):
        _emit(line)

    # 14c. the solver sidecar: the north-star solves through a
    # SolverSession and gRPC on 127.0.0.1 to the port's server on the card,
    # each equal to the in-process solve of the same inputs
    _reset_counts(kernels)
    lines, window_digests = sidecar_phase(DEVICE, pool, catalog, pods, span,
                                          runs, best_s, ts_mod)
    record("sidecar")
    for line in lines:
        _emit(line)
    # 14d. two replicas and a handoff store: a drain migrates the session
    _reset_counts(kernels)
    fleet = sidecar_fleet_phase(DEVICE, pool, catalog, pods, span, runs,
                                window_digests)
    record("sidecar_fleet")
    _emit(fleet)
    # 14e. the sidecar as its own process, as a deployment starts it
    _emit(sidecar_process_phase(DEVICE, pool, catalog, pods,
                                _local_digest(runs["cold"], pods)))

    # 14f. the operator over the sidecar backend, against the CPU
    def record_operator_sidecar() -> dict:
        record("operator_sidecar")
        return paths["operator_sidecar"]
    for line in operator_sidecar_phase(DEVICE, record_operator_sidecar):
        _emit(line)

    # 14g. the fleet simulator on the card: the four pinned clips (the JAX
    # package's digests), then mixed-day's whole day and its first quarter
    def recorder(path: str):
        def record_path() -> dict:
            record(path)
            return paths[path]
        return record_path
    with _process_state_kept():
        sim_lines = sim_pinned_phase(DEVICE, recorder("sim_pinned"))
    for line in sim_lines:
        _emit(line)
    with _process_state_kept():
        sim_lines = sim_mixed_day_phase(DEVICE, recorder("sim_mixed_day"))
    for line in sim_lines:
        _emit(line)

    # 14h. the north-star cold solve on a mesh across two processes, each
    # process's decisions equal to the single-process cold solve's; their
    # launches are counted in the processes and summed here
    line, paths["mesh_multiprocess"], _ = mesh_multiprocess_phase(
        _local_digest(runs["cold"], pods), best_s["cold"])
    _emit(line)

    # 14i. the operator over the apiserver wire: store_backend="kube"
    # against the port's EnvtestServer on 127.0.0.1 (the CRDs posted, a
    # kubeconfig), each step driven to quiescence; every step's apiserver
    # state equal to the same drive on the CPU
    def record_operator_kube() -> dict:
        record("operator_kube")
        return paths["operator_kube"]
    for line in operator_phase(DEVICE, record_operator_kube,
                               phase="operator_kube", kube=True,
                               n_pods=KUBE_PODS, n_deploys=KUBE_DEPLOYS):
        _emit(line)
    # 14j. the operator's CLI against such a server, as a deployment runs
    # it: a child process on the card with a KubeLease over the wire
    _emit(operator_kube_process_phase(DEVICE))

    # 15. every path launched the kernels it runs; the table counts them
    # all (B5 has no caller on any path: its launches stay 0)
    expect = {"operator": FEASIBILITY, "sidecar": FEASIBILITY,
              "sidecar_fleet": FEASIBILITY,
              "operator_sidecar": FEASIBILITY,
              "operator_kube": FEASIBILITY,
              "sim_pinned": FEASIBILITY, "sim_mixed_day": FEASIBILITY,
              "mesh_multiprocess": FEASIBILITY[:2],
              "solve": FEASIBILITY, "solve_mesh_1x1": FEASIBILITY,
              "solve_mesh_4x2": FEASIBILITY,
              "warm_churn": FEASIBILITY,
              "warm_churn_mesh": FEASIBILITY + ("row_splice",),
              "solve_sharded_pack": FEASIBILITY[:2],
              "provisioner_pass": FEASIBILITY,
              "consolidation_multi": FEASIBILITY,
              "consolidation_single": FEASIBILITY,
              "disruption_controller": FEASIBILITY}
    for path, names in expect.items():
        for name in names:
            assert paths[path][name] > 0, \
                f"{name} was never launched on the path {path}"
    total = {name: sum(p[name] for p in paths.values())
             for name in kernels.KERNELS}
    _emit({"phase": "main_path_launches", **total, "paths": paths})
    # the register tile (ra x rb) and ring depth each K2 / K3 launch of the
    # paths used, by path and shape, and their launches per tile in all
    used: dict = {}
    for path_tiles in tiles.values():
        for name, *_, ra, rb, stages, n in path_tiles:
            by_tile = used.setdefault(name, {})
            by_tile[f"{ra}x{rb}"] = by_tile.get(f"{ra}x{rb}", 0) + n
    _emit({"phase": "join_plans", "tiles_used": used, "paths": tiles,
           "combine_plans": k1_plans})
    on_paths = {name for names in expect.values() for name in names}
    for name, n in total.items():
        assert n > 0 or name not in on_paths, \
            f"{name} was never launched on the main path"
        rows[name]["launches"] = n

    # 16. device-time attribution (obs.device.DEVICE_TIME) of the cold
    # solve and the solve with nodes, traced and not
    _emit({"phase": "device_attribution", **device_attribution(
        ts_mod, pool, catalog, pods, nodes, (problem, problem_x))})

    # 17. one north-star Provisioner pass under the profiler
    _emit({"phase": "profile_provisioner_pass",
           **profiled_pass(DEVICE, gpu_passes[0])})

    # 18. the flight recorder on the provisioner and disruption passes, and
    # replays of its records on the card
    _emit({"phase": "flight_recorder", **flight_recorder_phase(DEVICE)})

    # 19. the script's length by phase, the kernel table and the verdict
    _emit({"phase": "elapsed", "s": time.perf_counter() - _T0,
           "phase_at_s": {k: v for k, v in PHASE_AT.items() if k}})
    _emit({"kernels": list(rows.values())})
    _emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                  "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
