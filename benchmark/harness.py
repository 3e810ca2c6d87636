"""One run of one cell: everything between the command line and the result
line, driven by data.

A cell of ``BENCHMARK.json`` names a configuration (its file), a traffic
mix (``traffic/<name>.json``, whose ``driver`` names
``drivers/<driver>.py``) and its metrics; each metric is read by
``metrics/<name>.py``. Adding a cell or a metric adds files and entries
and edits none of these modules.

A run: set-up (the inputs from the seed, one warm-up pass per distinct
input), then passes back to back for ``seconds`` (a closed loop of one
caller), then, with the window closed and the device's peak read, the
plain reference judges a sample of the passes drawn from the seed."""

from __future__ import annotations

import importlib
import importlib.util
import json
import random
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TRACE_PATH = ROOT / "build" / "benchmark" / "trace.json"
# modules that may not be loaded in the process that prints a result,
# compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "karpenter_tpu")


class NoDevice(RuntimeError):
    pass


class Forbidden(RuntimeError):
    pass


def load_cell(workload: str):
    """The cell's entry in BENCHMARK.json, its configuration, its traffic
    mix, and the end-to-end and per-layer metrics it reports."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / config["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload])
             and ("workloads" in m or m["moves"] in reported)]
    return cell, cfg, traffic, e2e, layer


def reader(metric: str):
    """The ``read`` function of metrics/<metric>.py, or for a metric
    named <quantity>.<suffix> with no file of its own, of
    metrics/<quantity>.py, which serves every suffix."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    name = "benchmark_metric_" + metric.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Reservoir:
    """A sample of ``k`` passes drawn uniformly from the seed, whatever
    the number of passes the window holds."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.kept, self.seen = k, random.Random(
            f"{seed}:judged"), {}, 0

    def slot(self) -> "int | None":
        """The slot the next pass goes into, or None."""
        i, self.seen = self.seen, self.seen + 1
        if i < self.k:
            return i
        j = self.rng.randrange(i + 1)
        return j if j < self.k else None


def host_self_ms(passes: list, n: int = 12) -> dict:
    """The ``n`` program spans with the most self time, in milliseconds
    per pass."""
    from .spans import self_seconds
    total: dict = {}
    for spans in passes:
        for k, v in self_seconds(spans).items():
            total[k] = total.get(k, 0.0) + v
    top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return {k: v * 1e3 / max(1, len(passes)) for k, v in top}


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def device_info(device: str, chips: int) -> dict:
    if not device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        info["power_limit_w"] = float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return info


def run(workload: str, seed: int, seconds: float, trace: bool,
        started: float, device: str = "cuda", cell=None) -> dict:
    """One run; returns the result line's object. ``started``: the
    process's start on the perf_counter clock. ``cell`` replaces the
    cell's (entry, configuration, traffic, metrics) read from
    BENCHMARK.json (the tests run small cells on the CPU)."""
    entry, cfg, traffic, e2e, layer = cell or load_cell(workload)
    chips = entry["chips"]
    if device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            raise NoDevice("CUDA is not available")
        if torch.cuda.device_count() < chips:
            raise NoDevice(f"the cell asks for {chips} devices, "
                           f"{torch.cuda.device_count()} present")
    from karpenter_tpu_torch.obs.tracer import TRACER
    from karpenter_tpu_torch.ops import kernels

    from .probe import Probe
    driver_mod = importlib.import_module(
        f"benchmark.drivers.{traffic['driver']}")
    driver = driver_mod.Driver(cfg, traffic, seed, device)
    probe = Probe()
    metrics = layer if trace else e2e
    read = {m["name"]: reader(m["name"]) for m in metrics}
    attempted = failed = 0
    reasons: dict = {}
    starts, ends, cpu_s, host_spans, shapes = [], [], [], [], []
    sample = Reservoir(driver.judged, seed)
    # a checkout's first run builds the kernels' library inside set-up;
    # the result line says so, with the build's seconds
    build_s, b0 = None, time.perf_counter()
    if device.startswith("cuda") and kernels.build():
        build_s = time.perf_counter() - b0
    with probe.installed():
        for i in range(driver.distinct):
            probe.new_pass(False)
            why, _ = driver.step(i)
            if why:
                raise RuntimeError(f"warm-up pass {i}: {why}")
        _sync(device)
        session = None
        if trace:
            from .devtrace import session as profiler
            session = profiler()
            session.__enter__()
            probe.profiling = True
        kernels.reset_launches()
        setup_s = time.perf_counter() - started
        t0 = time.perf_counter()
        while attempted == 0 or time.perf_counter() < t0 + seconds:
            slot = sample.slot()
            probe.new_pass(keep=slot is not None)
            mark = None
            if trace:
                import torch
                mark = torch.profiler.record_function("bench.pass")
                mark.__enter__()
            s, c = time.perf_counter(), time.process_time()
            try:
                why, kept = driver.step(attempted)
            except Exception as exc:  # noqa: BLE001 — a failed pass, counted
                why, kept = f"raised {exc!r}", None
            end = time.perf_counter()
            cpu_s.append(time.process_time() - c)
            if mark is not None:
                mark.__exit__(None, None, None)
            attempted += 1
            starts.append(s)
            ends.append(end)
            if trace:
                from .spans import plain_spans
                host_spans.append(plain_spans(TRACER.last()))
                shapes.extend(c["shape"] for c in probe.calls)
            if why:
                failed += 1
                reasons[why] = reasons.get(why, 0) + 1
            elif slot is not None:
                sample.kept[slot] = (kept, probe.calls)
        probe.new_pass(False)
        _sync(device)
        launches = sum(kernels.LAUNCHES.values())
        if session is not None:
            session.__exit__(None, None, None)
    info = device_info(device, chips)
    ctx = SimpleNamespace(starts=starts, ends=ends, setup_s=setup_s,
                          spans=host_spans, shapes=shapes, device=None)
    result: dict = {}
    if trace:
        from . import devtrace
        TRACE_PATH.parent.mkdir(parents=True, exist_ok=True)
        session.export_chrome_trace(str(TRACE_PATH))
        dev = devtrace.read(str(TRACE_PATH), starts, host_spans, launches)
        TRACE_PATH.unlink()
        ctx.device = dev
        info.update(busy_s=dev["busy_s"], window_s=dev["window_s"])
        result["breakdown"] = {"device_ops": dev["device_ops"],
                               "idle_gaps": dev["idle_gaps"]}
        result["host_self_ms"] = host_self_ms(host_spans)
    found = forbidden_modules()
    if found:
        raise Forbidden(f"loaded in the measuring process: {found}")
    values = {}
    for m in metrics:
        v = read[m["name"]](ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    # the check, with the window closed and the device's peak read; the
    # reference runs on the host, so it cannot move that peak
    answers = [driver.answer(kept, calls)
               for kept, calls in sample.kept.values()]
    kinds = driver.judge(answers) if answers else {}
    checks = {"faults": {"value": sum(kinds.values()),
                         "limit": driver.limit}}
    correct = bool(answers) and checks["faults"]["value"] <= driver.limit
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": values, "device": info, "judged": len(answers),
           "fault_kinds": kinds, "kernels_built_s": build_s,
           "pass_s": [e - s for s, e in zip(starts, ends)],
           "pass_cpu_s": cpu_s}
    if reasons:
        out["failures"] = reasons
    out.update(result)
    out["checks"] = checks
    return out
