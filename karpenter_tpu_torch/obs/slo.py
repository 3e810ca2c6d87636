"""End-to-end SLO watcher over completed pass traces.

Budgets are keyed by SPAN NAME (``provisioner.pass``, ``solve``, ``pack``,
``disruption.pass``, ...) with a wall-clock ceiling in seconds. The watcher
sits in the tracer's ``watcher`` slot, sees every completed ``PassTrace``,
and for EACH budget the trace exceeds (its worst span of that name):

- increments ``karpenter_slo_breaches_total{slo}``,
- publishes one ``SLOBreached`` warning event (deduped per slo+trace), and
- dumps the offending pass's flight-recorder records ONCE (the ring of
  ``flightrec.FlightRecorder``: every record carries the pass
  ``trace_id``) to a JSONL file under ``$KARPENTER_FLIGHTREC_DIR`` (or the
  system tempdir) — the incident snapshot is on disk before the operator
  even looks.

Exactly-once per (slo, breaching pass): a trace is observed once (tracer
completion), and the seen-trace set guards against re-observation (the
/debug replay path); independent budgets breached by one pass each get
their own counter increment and event, so alerting on any one series
never misses a real breach because an enclosing span breached worse.
Rolling per-span duration windows feed the ``/debug/slo`` p50/p99 report;
the budgets themselves are per-pass ceilings — a p99 target is enforced by
alerting on the breach counter's rate, which is how a fleet simulator
consumes this.
"""

from __future__ import annotations

import os
import tempfile
import threading
from collections import deque
from typing import Dict, List, Optional

from ..utils.clock import Clock

WINDOW = 512  # rolling durations kept per watched span for p50/p99


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (ceiling index) over an unsorted sample;
    0.0 on empty. Shared by /debug/slo and the fleet simulator's report
    so the two p99s can never disagree on identical samples."""
    if not values:
        return 0.0
    s = sorted(values)
    return s[min(len(s) - 1, int(q * (len(s) - 1) + 0.999999))]


def parse_budgets(raw: str) -> Dict[str, float]:
    """'provisioner.pass=2.0,pack=0.5' -> {span: seconds}; bad entries
    raise ValueError (a typo'd SLO silently misbehaving is worse than a
    boot failure) — including zero/negative budgets (every pass breaches:
    a dump file per pass forever) and nan (a budget that can never fire)."""
    import math
    out: Dict[str, float] = {}
    for part in (raw or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, value = part.partition("=")
        if not sep or not name.strip():
            raise ValueError(f"bad SLO budget {part!r}; want span=seconds")
        seconds = float(value)
        if not math.isfinite(seconds) or seconds <= 0:
            raise ValueError(
                f"bad SLO budget {part!r}; seconds must be finite and > 0")
        out[name.strip()] = seconds
    return out


class Breach:
    __slots__ = ("slo", "trace_id", "duration", "budget", "at", "dump_path",
                 "tenant")

    def __init__(self, slo: str, trace_id: str, duration: float,
                 budget: float, at: float, dump_path: str,
                 tenant: str = ""):
        self.slo = slo
        self.trace_id = trace_id
        self.duration = duration
        self.budget = budget
        self.at = at
        self.dump_path = dump_path
        self.tenant = tenant


class SLOWatcher:
    # on-disk breach dumps kept (oldest deleted past this): a budget set
    # below the steady-state pass time must not exhaust the disk with one
    # multi-MB solver-input file per pass
    MAX_DUMP_FILES = 32

    def __init__(self, budgets: Dict[str, float], recorder=None,
                 flightrec=None, clock: Optional[Clock] = None,
                 dump_dir: Optional[str] = None, keep_breaches: int = 64):
        self.budgets = dict(budgets)
        self.recorder = recorder
        self.flightrec = flightrec
        self.clock = clock or Clock()
        self.dump_dir = dump_dir
        self.breaches: "deque[Breach]" = deque(maxlen=keep_breaches)
        # optional callback fired once per Breach as it happens: consumers
        # that must see EVERY breach (the fleet simulator's ledger) hook
        # this instead of polling `breaches`, whose maxlen drops the
        # oldest entries once a long run accumulates more than it keeps
        self.on_breach = None
        self._durations: Dict[str, deque] = {}
        self._seen: "deque[str]" = deque(maxlen=1024)
        self._seen_set: set = set()
        self._lock = threading.Lock()
        # trace ids restart at t000001 every process: the pid tag keeps a
        # post-restart breach from overwriting the previous incident's
        # dump of the same id
        self._file_tag = f"{os.getpid():x}"
        self._dump_files: "deque[str]" = deque()

    # -- tracer hook ---------------------------------------------------------

    def observe(self, trace) -> None:
        """Called by the tracer for every completed PassTrace."""
        from ..metrics.registry import tenant_label
        # sidecar-served passes stamp a tenant on the root span: rolling
        # windows and breaches key on (span, tenant) so /debug/slo can
        # answer "whose p99 moved" — in-process passes key on tenant ""
        tenant = trace.root.attrs.get("tenant")
        tenant = "" if tenant is None else tenant_label(tenant)
        with self._lock:
            if trace.trace_id in self._seen_set:
                return
            if len(self._seen) == self._seen.maxlen:
                self._seen_set.discard(self._seen[0])
            self._seen.append(trace.trace_id)
            self._seen_set.add(trace.trace_id)
            # per watched NAME, the worst span of that name in the trace
            # (a budget name can recur, e.g. several solves in one pass)
            worst: Dict[str, object] = {}
            for sp in trace.spans:
                budget = self.budgets.get(sp.name)
                if budget is not None:
                    self._durations.setdefault(
                        (sp.name, tenant),
                        deque(maxlen=WINDOW)).append(sp.duration)
                    cur = worst.get(sp.name)
                    if cur is None or sp.duration > cur.duration:
                        worst[sp.name] = sp
            breached = [(sp, self.budgets[name])
                        for name, sp in sorted(worst.items())
                        if sp.duration > self.budgets[name]]
        if breached:
            # one dump per breaching pass, shared by every breached budget
            dump_path = self._dump(trace)
            for sp, budget in breached:
                self._breach(trace, sp, budget, dump_path, tenant)

    def _breach(self, trace, sp, budget: float, dump_path: str,
                tenant: str = "") -> None:
        from ..logging import get_logger
        from ..metrics.registry import SLO_BREACHES
        SLO_BREACHES.inc({"slo": sp.name})
        breach = Breach(sp.name, trace.trace_id, sp.duration, budget,
                        self.clock.now(), dump_path, tenant=tenant)
        self.breaches.append(breach)
        if self.on_breach is not None:
            try:
                self.on_breach(breach)
            except Exception:  # noqa: BLE001 — an observer never costs a pass
                pass
        if self.recorder is not None:
            from ..events import catalog as events_catalog
            self.recorder.publish(events_catalog.slo_breached(
                sp.name, trace.trace_id, sp.duration, budget, dump_path))
        get_logger("slo").warning(
            "SLO breached", slo=sp.name, trace_id=trace.trace_id,
            duration=round(sp.duration, 4), budget=budget,
            flightrec_dump=dump_path)

    def _dump(self, trace) -> str:
        """Flight-recorder dump of the breaching pass (records stamped with
        its trace_id). Best-effort: a dump failure must not cost the pass,
        and an empty match (recorder off, ring evicted) writes nothing."""
        rec = self.flightrec
        if rec is None:
            return ""
        out_dir = self.dump_dir or os.environ.get(
            "KARPENTER_FLIGHTREC_DIR", tempfile.gettempdir())
        path = os.path.join(
            out_dir, f"slo-breach-{self._file_tag}-{trace.trace_id}.jsonl")
        try:
            n = rec.dump_matching(path, trace.trace_id)
        except Exception:  # noqa: BLE001
            return ""
        if not n:
            return ""
        self._dump_files.append(path)
        while len(self._dump_files) > self.MAX_DUMP_FILES:
            stale = self._dump_files.popleft()
            try:
                os.remove(stale)
            except OSError:
                pass
        return path

    # -- read side (/debug/slo) ---------------------------------------------

    _pct = staticmethod(percentile)

    def snapshot(self, tenant: Optional[str] = None) -> dict:
        """Budgets with rolling p50/p99 plus recent breaches. With no
        `tenant`, windows aggregate across every tenant (the pre-tenant
        report shape, breaches annotated); with one, both views narrow to
        that tenant's samples/breaches."""
        with self._lock:
            durations = {k: list(v) for k, v in self._durations.items()}
        spans = {}
        for name, budget in sorted(self.budgets.items()):
            vals: List[float] = []
            for (span, t), samples in durations.items():
                if span == name and (tenant is None or t == tenant):
                    vals.extend(samples)
            spans[name] = {
                "budget_seconds": budget,
                "observed": len(vals),
                "p50": round(self._pct(vals, 0.50), 6),
                "p99": round(self._pct(vals, 0.99), 6),
            }
        return {
            "budgets": spans,
            "tenant": tenant,
            "breaches": [
                {"slo": b.slo, "trace_id": b.trace_id,
                 "duration": round(b.duration, 6), "budget": b.budget,
                 "at": b.at, "dump": b.dump_path, "tenant": b.tenant}
                for b in list(self.breaches)
                if tenant is None or b.tenant == tenant],
        }
