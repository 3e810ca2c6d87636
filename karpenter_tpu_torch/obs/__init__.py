"""Observability substrate: pass-level span tracing + end-to-end SLOs.

- ``tracer``: the clock-injectable span tracer, its bounded ring of
  completed pass traces, cross-process trace-context adoption, the
  Chrome trace-event export (Perfetto / chrome://tracing compatible), its
  spans as ranges of a running ``torch.profiler`` session, and the
  collector's pauses on each trace's root.
  Instrumentation sites use the process-wide ``TRACER``.
- ``slo``: the SLOWatcher enforcing per-span wall-clock budgets over
  completed traces (breach metric + warning event + flight-recorder dump).
- ``fallbacks``: the fallback cost ledger — every host-oracle escape
  classified by shape class with pod counts and host-vs-tensor wall cost
  (process-wide ``LEDGER``).
- ``device``: per-launch-shape device-time attribution (the launches'
  host time vs their time on the card, from CUDA timing events) and
  memory watermarks (``DEVICE_TIME``).
- ``profile``: the torch.profiler session facility (``PROFILER``).
- ``python -m karpenter_tpu_torch.obs dump|show|profile``: the CLI
  workflows.
"""

from .device import DEVICE_TIME, DeviceTimeTracker
from .fallbacks import LEDGER, FallbackLedger, classify_reason
from .profile import PROFILER, ProfileError, Profiler
from .slo import SLOWatcher, parse_budgets
from .tracer import (TRACER, PassTrace, Span, Tracer, chrome_trace,
                     dumps_chrome, phase_millis)

__all__ = ["TRACER", "Tracer", "Span", "PassTrace", "chrome_trace",
           "dumps_chrome", "phase_millis", "SLOWatcher", "parse_budgets",
           "LEDGER", "FallbackLedger", "classify_reason",
           "DEVICE_TIME", "DeviceTimeTracker",
           "PROFILER", "Profiler", "ProfileError"]
