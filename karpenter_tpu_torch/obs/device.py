"""Device and memory truth: per-launch attribution of device time.

Every span the tracer records measures HOST wall clock; CUDA launches are
asynchronous, so a span around them times the enqueue and the device's
own time hides inside whatever waits first (the result fetch). This
module splits the two:

- **dispatch overhead** — host time for the launches to return (argument
  checks, the ctypes calls, the enqueue), and
- **device time** — from the card: a pair of timing CUDA events recorded
  on each device's stream around the launches (``LaunchTimer``), whose
  elapsed time is read once the fetch has completed, so reading it adds no
  wait. It spans the first launch's start to the last one's end on the
  card, gaps between launches included. On the CPU, where the plain
  versions run inside the launch calls, it is the host time of those
  calls,

attributed PER LAUNCH SHAPE: the padded shape bucket that picks K1-K3's
plans (statics, leading argument shapes, device), the port's counterpart
of the reference's compiled-executable cache key. Beside each entry stand
what the kernels must do for that shape: ``flops`` (the 32-bit integer
operations their bounds count) and ``bytes_accessed`` (each kernel's inputs
read once and outputs written once), from the per-kernel costs in
``ops/kernels.py``; and ``peak_bytes``, the launch's device arguments plus
every output it allocates, the same on the CPU and the card. The peak
feeds a continuous watermark gauge per device
(``karpenter_device_memory_peak_bytes{device}``).

The split only happens while the tracer is enabled (the same switch that
gates every other span): with tracing off no event is recorded.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple


class ExecStats:
    """Aggregate truth for one launch shape (one key)."""

    __slots__ = ("label", "kind", "shapes", "devices", "flops",
                 "bytes_accessed", "peak_bytes", "dispatches",
                 "dispatch_seconds", "device_seconds")

    def __init__(self, label: str, kind: str, shapes: str,
                 devices: List[str]):
        self.label = label
        self.kind = kind              # "single" | "mesh"
        self.shapes = shapes          # human-readable shape summary
        self.devices = devices
        self.flops = 0.0              # integer operations of the kernels
        self.bytes_accessed = 0.0
        self.peak_bytes = 0           # arguments + outputs, per device
        self.dispatches = 0
        self.dispatch_seconds = 0.0   # host enqueue overhead
        self.device_seconds = 0.0     # the wait for completion after it

    def snapshot(self) -> dict:
        return {
            "executable": self.label,
            "kind": self.kind,
            "shapes": self.shapes,
            "devices": list(self.devices),
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "peak_bytes": self.peak_bytes,
            "dispatches": self.dispatches,
            "dispatch_seconds": round(self.dispatch_seconds, 6),
            "device_seconds": round(self.device_seconds, 6),
        }


class DeviceTimeTracker:
    """Process-wide per-launch-shape device-time + memory registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: "Dict[tuple, ExecStats]" = {}
        self._watermarks: Dict[str, int] = {}

    # -- registration (first launch of a shape) ------------------------------

    def get(self, key: tuple) -> Optional[ExecStats]:
        """Fast path for the dispatch site: an already-registered key skips
        the shape walks that feed register()'s arguments."""
        with self._lock:
            return self._stats.get(key)

    def register(self, key: tuple, kind: str, shapes: str = "",
                 devices: Optional[List[str]] = None,
                 cost: Tuple[int, int, int] = (0, 0, 0)) -> ExecStats:
        """Idempotent: the first call for a key opens the stats entry with
        ``cost`` = (operations, bytes accessed, peak bytes per device);
        later calls return it. ``devices`` are the launch's device labels
        (``device_label``)."""
        with self._lock:
            st = self._stats.get(key)
        if st is not None:
            return st
        label = "x" + hashlib.sha1(repr(key).encode()).hexdigest()[:10]
        st = ExecStats(label, kind, shapes, list(devices or ["cpu"]))
        ops, accessed, peak = cost
        st.flops = float(ops)
        st.bytes_accessed = float(accessed)
        st.peak_bytes = int(peak)
        with self._lock:
            # first registration wins on a race; both computed identically
            st = self._stats.setdefault(key, st)
        if st.peak_bytes:
            self._update_watermarks(st)
        return st

    def _update_watermarks(self, st: ExecStats) -> None:
        """Continuous per-device memory watermark: the max per-device peak
        across every launch shape registered so far."""
        from ..metrics.registry import DEVICE_MEMORY_PEAK
        with self._lock:
            for dev in st.devices:
                if st.peak_bytes > self._watermarks.get(dev, 0):
                    self._watermarks[dev] = st.peak_bytes
                    DEVICE_MEMORY_PEAK.set(float(st.peak_bytes),
                                           {"device": dev})

    # -- per-dispatch recording ---------------------------------------------

    def record(self, st: ExecStats, dispatch_s: float,
               device_s: float) -> None:
        from ..metrics.registry import (DEVICE_DISPATCH_SECONDS,
                                        DEVICE_EXECUTE_SECONDS,
                                        DEVICE_DISPATCHES)
        with self._lock:
            st.dispatches += 1
            st.dispatch_seconds += dispatch_s
            st.device_seconds += device_s
        labels = {"executable": st.label}
        DEVICE_DISPATCHES.inc(labels)
        DEVICE_DISPATCH_SECONDS.inc(labels, dispatch_s)
        DEVICE_EXECUTE_SECONDS.inc(labels, device_s)

    # -- read side -----------------------------------------------------------

    def snapshot(self) -> List[dict]:
        with self._lock:
            stats = list(self._stats.values())
        return [st.snapshot() for st in stats]

    def watermarks(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._watermarks)

    def clear(self) -> None:
        with self._lock:
            self._stats.clear()
            self._watermarks.clear()


class LaunchTimer:
    """The host time of the launches made between construction and
    ``launched()``, and their time on the card. On each CUDA device a
    timing event is recorded on its current stream at construction and
    another at ``launched()``; ``elapsed()``, called once the fetch that
    follows the launches has completed, returns the longest time between
    the two on any device. Without a CUDA device the launches ran on the
    CPU inside the calls, and ``elapsed()`` returns their host time."""

    def __init__(self, devices: Iterable):
        self._devices = [d for d in dict.fromkeys(devices)
                         if d.type == "cuda"]
        self._events = []
        if self._devices:
            import torch
            for dev in self._devices:
                start = torch.cuda.Event(enable_timing=True)
                start.record(torch.cuda.current_stream(dev))
                self._events.append([start, None])
        self._t0 = time.perf_counter()
        self.dispatch_seconds = 0.0

    def launched(self) -> float:
        """Mark the end of the launches; returns their host time."""
        self.dispatch_seconds = time.perf_counter() - self._t0
        if self._devices:
            import torch
            for dev, pair in zip(self._devices, self._events):
                end = torch.cuda.Event(enable_timing=True)
                end.record(torch.cuda.current_stream(dev))
                pair[1] = end
        return self.dispatch_seconds

    def elapsed(self) -> float:
        """The launches' device seconds. Call it after the fetch: the end
        events have completed by then, so it does not wait."""
        if not self._devices:
            return self.dispatch_seconds
        longest = 0.0
        for start, end in self._events:
            # a no-op once the fetch has completed on this stream
            end.synchronize()
            longest = max(longest, start.elapsed_time(end) * 1e-3)
        return longest


def device_label(device) -> str:
    """A device's label in DEVICE_TIME and the watermark gauges:
    ``str(torch.device)`` with a CUDA device's index filled in."""
    if device.type == "cuda" and device.index is None:
        import torch
        return f"cuda:{torch.cuda.current_device()}"
    return str(device)


DEVICE_TIME = DeviceTimeTracker()
