"""Pass-level span tracer: the whole-system timing layer.

The solver metrics answered "how long did the pass take"; nothing answered
"WHERE did it go" — encode vs device upload vs compile vs warm restore vs
pack. This tracer closes that gap with nested spans around every hot-path
stage (provisioning solve, disruption snapshot/sim, the controller pass
loops) while staying cheap enough to leave ON in production:

- **near-zero when disabled** — ``Tracer.span()`` is one attribute compare
  returning a shared no-op context manager; nothing allocates.
- **cheap when enabled** — spans are coarse (one per *stage*, never per
  pod/group/candidate), so a headline 50k-pod solve carries ~15 spans:
  two clock reads and one small object each. The BENCH_MODE=trace line and
  tests/test_bench_budget.py pin the <=5% envelope.
- **thread-safe** — the active span stack is thread-local (the sidecar
  serves solves from a thread pool); only the completed-trace ring takes
  a lock.
- **clock-injectable** — ``set_clock`` swaps the duration clock (default
  ``time.perf_counter``) so fake-clock tests can inflate a pass
  deterministically, the ``set_condition_clock`` pattern.

A span opened with no active trace on its thread ROOTS a new ``PassTrace``
(a standalone ``TensorScheduler.solve`` traces itself); spans opened inside
one nest under it (the provisioner/disruption pass loops own the root).
Completed traces land in a bounded ring, exportable as Chrome trace-event
JSON (``chrome_trace`` — opens directly in Perfetto / chrome://tracing) via
``/debug/traces`` and ``python -m karpenter_tpu.obs dump``.

Metrics derive FROM spans: on trace completion every span observes into
``karpenter_solver_phase_duration_seconds{phase,encode_kind}``, so the
histogram and the trace are two views of the same measurement and can
never disagree. The optional ``watcher`` slot (obs/slo.SLOWatcher) sees
every completed trace for budget enforcement.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

DEFAULT_CAPACITY = 64


class Span:
    """One timed stage. ``start``/``end`` are tracer-clock readings (seconds,
    perf_counter epoch by default); ``parent`` is the index of the parent
    span within the trace (-1 for the root); ``tid`` the capturing thread."""

    __slots__ = ("name", "start", "end", "attrs", "parent", "index", "tid")

    def __init__(self, name: str, start: float, parent: int, index: int,
                 tid: int, attrs: dict):
        self.name = name
        self.start = start
        self.end = start
        self.attrs = attrs
        self.parent = parent
        self.index = index
        self.tid = tid

    @property
    def duration(self) -> float:
        return max(0.0, self.end - self.start)

    def set(self, **attrs) -> "Span":
        """Attach attributes after entry (e.g. encode_kind known mid-span)."""
        self.attrs.update(attrs)
        return self


class PassTrace:
    """One completed root-span tree (a provisioning solve, a disruption
    method pass, ...). ``spans[0]`` is the root; ``trace_id`` is stamped
    onto flight-recorder records and log lines so operators can join the
    three views."""

    __slots__ = ("trace_id", "at", "spans")

    def __init__(self, trace_id: str, at: float, spans: List[Span]):
        self.trace_id = trace_id
        self.at = at  # wall-clock epoch at root entry (time.time)
        self.spans = spans

    @property
    def root(self) -> Span:
        return self.spans[0]

    @property
    def name(self) -> str:
        return self.spans[0].name

    @property
    def duration(self) -> float:
        return self.spans[0].duration

    def summary(self) -> str:
        r = self.root
        extras = " ".join(f"{k}={v}" for k, v in sorted(r.attrs.items()))
        return (f"{self.trace_id} {r.name} dur={r.duration:.4f}s "
                f"spans={len(self.spans)}" + (f" {extras}" if extras else ""))


class _NoopSpan:
    """Shared disabled-path span: enter/exit/set all do nothing."""

    __slots__ = ()
    duration = 0.0

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> "_NoopSpan":
        return self


_NOOP = _NoopSpan()


class _SpanCtx:
    """Context manager binding one Span to the thread's active trace."""

    __slots__ = ("_tracer", "_name", "_attrs", "span")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self.span: Optional[Span] = None

    def __enter__(self) -> Span:
        self.span = self._tracer._begin(self._name, self._attrs)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.span.attrs.setdefault("error", repr(exc))
        self._tracer._finish(self.span)


class Tracer:
    def __init__(self, capacity: int = DEFAULT_CAPACITY, enabled: bool = True,
                 now: Optional[Callable[[], float]] = None):
        self.enabled = enabled
        self.capacity = max(1, int(capacity))
        self._now = now or time.perf_counter
        self._local = threading.local()
        self._traces: "deque[PassTrace]" = deque()
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        # single watcher slot (obs/slo.SLOWatcher): the operator owns it;
        # re-wiring replaces, never accumulates (tests build many operators
        # against this process-wide tracer)
        self.watcher = None

    # -- configuration -------------------------------------------------------

    def set_clock(self, now: Callable[[], float]) -> Callable[[], float]:
        """Swap the duration clock (set_condition_clock pattern); returns
        the previous one so tests can restore it."""
        prev = self._now
        self._now = now
        return prev

    def set_capacity(self, capacity: int) -> None:
        self.capacity = max(1, int(capacity))
        with self._lock:
            while len(self._traces) > self.capacity:
                self._traces.popleft()

    # -- span lifecycle ------------------------------------------------------

    def span(self, name: str, **attrs):
        """Open a nested span; roots a new PassTrace when this thread has
        none active. Usage: ``with TRACER.span("pack", groups=G) as sp:``"""
        if not self.enabled:
            return _NOOP
        return _SpanCtx(self, name, attrs)

    def _state(self):
        st = getattr(self._local, "state", None)
        if st is None:
            # (stack of open span indices, span list, trace_id, wall epoch)
            st = self._local.state = {"stack": [], "spans": [],
                                      "trace_id": "", "at": 0.0,
                                      "drop": False, "adopt": None}
        return st

    def _begin(self, name: str, attrs: dict) -> Span:
        st = self._state()
        if not st["stack"]:
            st["spans"] = []
            adopt = st.get("adopt")
            if adopt is not None:
                # cross-process join: this root continues the REMOTE trace
                # (the sidecar wire's trace_ctx) instead of minting a local
                # id — one trace_id then names the operator-side pass, the
                # server-side session/queue/solve tree, and the flightrec
                # records on both sides
                st["trace_id"] = adopt[0]
                if adopt[1]:
                    attrs = dict(attrs)
                    attrs.setdefault("remote_parent", adopt[1])
                st["adopt"] = None
            else:
                st["trace_id"] = f"t{next(self._seq):06d}"
            st["at"] = time.time()
            st["drop"] = False
        parent = st["stack"][-1] if st["stack"] else -1
        sp = Span(name, self._now(), parent, len(st["spans"]),
                  threading.get_ident(), dict(attrs))
        st["spans"].append(sp)
        st["stack"].append(sp.index)
        return sp

    def _finish(self, sp: Span) -> None:
        sp.end = self._now()
        st = self._state()
        # tolerate mispaired exits (an exception path closing out of order
        # must not wedge the thread's tracing forever): pop to this span
        while st["stack"] and st["stack"][-1] != sp.index:
            st["stack"].pop()
        if st["stack"]:
            st["stack"].pop()
        if not st["stack"]:
            # a fully-mispaired exit can land here after the trace already
            # completed (empty span list / cleared id): never ring that
            if st["spans"] and st["trace_id"] and not st["drop"]:
                self._complete(PassTrace(st["trace_id"], st["at"],
                                         st["spans"]))
            st["spans"] = []
            st["trace_id"] = ""
            st["drop"] = False

    def _complete(self, trace: PassTrace) -> None:
        with self._lock:
            if len(self._traces) >= self.capacity:
                self._traces.popleft()
            self._traces.append(trace)
        # derived views must never break the pass that produced the trace
        try:
            self._derive_metrics(trace)
        except Exception:  # noqa: BLE001
            pass
        w = self.watcher
        if w is not None:
            try:
                w.observe(trace)
            except Exception:  # noqa: BLE001
                pass

    @staticmethod
    def _derive_metrics(trace: PassTrace) -> None:
        """Per-phase histograms FROM the span data — one measurement, two
        views. encode_kind labels ride from the root attrs (annotate());
        sidecar-served passes stamp a tenant on the root, which rides as a
        BOUNDED extra label (in-process passes keep the two-label series
        they always had, so existing dashboards/queries see no change)."""
        from ..metrics.registry import SOLVER_PHASE_DURATION, tenant_label
        kind = str(trace.root.attrs.get("encode_kind", ""))
        labels = {"phase": "", "encode_kind": kind}
        tenant = trace.root.attrs.get("tenant")
        if tenant is not None:
            labels["tenant"] = tenant_label(tenant)
        for sp in trace.spans:
            labels["phase"] = sp.name
            SOLVER_PHASE_DURATION.observe(sp.duration, dict(labels))

    # -- trace context -------------------------------------------------------

    def current_trace_id(self) -> str:
        """The active trace id on this thread ('' when none) — stamped onto
        flight-recorder records and pass log lines."""
        if not self.enabled:
            return ""
        st = getattr(self._local, "state", None)
        return st["trace_id"] if st is not None and st["stack"] else ""

    def current_root_name(self) -> str:
        """Name of the active trace's ROOT span ('' when none) — cheap
        subsystem attribution (a solve under a disruption.pass root is a
        disruption probe, not provisioning traffic)."""
        if not self.enabled:
            return ""
        st = getattr(self._local, "state", None)
        if st is not None and st["stack"]:
            return st["spans"][0].name
        return ""

    def current_ctx(self) -> Optional[dict]:
        """Wire-portable context of the ACTIVE span on this thread — the
        ``trace_ctx`` the sidecar client threads through the delta wire so
        the server can adopt() the same trace. None when tracing is off or
        no trace is active (legacy wire shape: the field is simply absent)."""
        if not self.enabled:
            return None
        st = getattr(self._local, "state", None)
        if st is None or not st["stack"]:
            return None
        return {"id": st["trace_id"],
                "span": f"{st['spans'][st['stack'][-1]].name}"
                        f"#{st['stack'][-1]}"}

    def adopt(self, trace_id: str, parent: str = "") -> None:
        """Arrange for the NEXT root span on this thread to JOIN the given
        remote trace (same trace_id, ``remote_parent`` attr naming the
        caller's span) instead of minting a local id. A no-op while a trace
        is already active; adopt("") clears a pending adoption. Retries /
        hedges / duplicate deliveries never reach this point twice — the
        server's idempotency-nonce dedupe answers them from the response
        cache before any span opens, so one logical request yields exactly
        one server span tree."""
        if not self.enabled:
            return  # span() returns the no-op ctx: a stored adoption would
            #         leak onto whatever trace roots after a re-enable
        st = self._state()
        if st["stack"]:
            return
        st["adopt"] = (trace_id, parent) if trace_id else None

    def drop_current(self) -> None:
        """Discard the current trace at completion (no ring, no derived
        metrics, no watcher): idle controller passes fire every few
        seconds and would otherwise evict the rare interesting traces
        from the bounded ring."""
        st = getattr(self._local, "state", None)
        if st is not None and st["stack"]:
            st["drop"] = True

    def annotate(self, **attrs) -> None:
        """Set attributes on the CURRENT trace's root span (e.g. the solve
        deep inside a provisioner pass stamping encode_kind)."""
        if not self.enabled:
            return
        st = getattr(self._local, "state", None)
        if st is not None and st["stack"]:
            st["spans"][0].attrs.update(attrs)

    # -- read side -----------------------------------------------------------

    def traces(self, n: Optional[int] = None) -> List[PassTrace]:
        with self._lock:
            out = list(self._traces)
        return out if n is None else out[-n:]

    def last(self) -> Optional[PassTrace]:
        with self._lock:
            return self._traces[-1] if self._traces else None

    def find(self, trace_id: str) -> Optional[PassTrace]:
        with self._lock:
            for t in self._traces:
                if t.trace_id == trace_id:
                    return t
        return None

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()


# -- export ------------------------------------------------------------------

def chrome_trace(traces: List[PassTrace]) -> dict:
    """Chrome trace-event JSON (the catapult format Perfetto and
    chrome://tracing open directly): one complete ('X') event per span,
    microsecond timestamps on the tracer clock, trace_id/attrs in args."""
    events = []
    for t in traces:
        for sp in t.spans:
            args = {str(k): v for k, v in sp.attrs.items()}
            args["trace_id"] = t.trace_id
            events.append({
                "name": sp.name,
                "cat": "karpenter",
                "ph": "X",
                "ts": sp.start * 1e6,
                "dur": sp.duration * 1e6,
                "pid": 1,
                "tid": sp.tid,
                "args": args,
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dumps_chrome(traces: List[PassTrace]) -> str:
    return json.dumps(chrome_trace(traces), default=str)


def phase_millis(trace: PassTrace) -> Dict[str, float]:
    """EXCLUSIVE wall milliseconds per span name (root excluded, child time
    subtracted from parents) — the bench's ``phases`` breakdown: the values
    sum to ~the root duration instead of double-counting nested stages.

    Mispaired spans (a mid-span exception recovery can close out of order,
    leaving a child OVERLAPPING its recorded parent instead of nesting
    inside it) are rendered deterministically: a child only discounts the
    part of its duration that actually lies INSIDE the parent's interval,
    so no parent's exclusive time can go negative and the same trace always
    renders the same table."""
    child_time = [0.0] * len(trace.spans)
    for sp in trace.spans:
        if sp.parent >= 0:
            par = trace.spans[sp.parent]
            child_time[sp.parent] += max(
                0.0, min(sp.end, par.end) - max(sp.start, par.start))
    out: Dict[str, float] = {}
    for sp in trace.spans[1:]:
        self_ms = max(0.0, sp.duration - child_time[sp.index]) * 1e3
        out[sp.name] = out.get(sp.name, 0.0) + self_ms
    return {k: round(v, 3) for k, v in sorted(out.items())}


# Process-wide tracer: instrumentation sites import this one. Schedulers
# are per-solve and controllers per-operator, so the trace ring (like the
# solver circuit breaker) must outlive them.
TRACER = Tracer()
