"""HTTP serving: /metrics exposition + health probes.

Mirrors karpenter's pkg/operator/operator.go:142-175: a metrics endpoint
serving the Prometheus registry on Options.metrics_port, and healthz/readyz
probe endpoints on Options.health_probe_port. Stdlib ThreadingHTTPServer in
daemon threads — the operator loop stays single-threaded; the handlers only
read (registry text render, health predicate)."""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from ..metrics.registry import REGISTRY


def _handler(routes: dict) -> type:
    import inspect
    # arity resolved once per route: probes are hit every few seconds for
    # the process lifetime; Signature construction per request is waste
    wants_query = {path: bool(inspect.signature(fn).parameters)
                   for path, fn in routes.items()}

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib casing)
            from urllib.parse import parse_qs
            path, _, qs = self.path.partition("?")
            fn = routes.get(path)
            if fn is None:
                self.send_error(404)
                return
            try:
                if wants_query[path]:
                    status, content_type, body = fn(parse_qs(qs))
                else:
                    status, content_type, body = fn()
            except Exception as exc:  # probe handlers must never kill serving
                status, content_type, body = 500, "text/plain", str(exc)
            data = body.encode()
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *args):  # scrape spam stays out of the logs
            pass

    return Handler


class _Server:
    def __init__(self, port: int, routes: dict):
        self._httpd = ThreadingHTTPServer(("0.0.0.0", port), _handler(routes))
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]  # resolved when port=0
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def _debug_stacks():
    """The pprof goroutine-dump analog (operator.go:159-175 gates pprof
    behind --enable-profiling): every thread's current Python stack, for
    diagnosing a wedged operator without attaching a debugger."""
    import sys
    import traceback
    names = {t.ident: t.name for t in threading.enumerate()}
    parts = []
    for ident, frame in sys._current_frames().items():
        parts.append(f"Thread {names.get(ident, '?')} ({ident}):\n"
                     + "".join(traceback.format_stack(frame)))
    return 200, "text/plain", "\n".join(parts)


def _debug_profile(query: dict):
    """Sampling CPU profile across all threads (the pprof
    /debug/pprof/profile analog, operator.go:159-175): polls
    sys._current_frames at ~100 Hz for ?seconds=N (default 5, cap 60) and
    renders folded stacks ("thread;fn (file:line);... count"), the format
    flamegraph.pl / speedscope consume directly. Cheap enough to run
    against a live operator; cProfile would only see the handler thread.

    ``?device=start`` / ``?device=stop`` instead drive the DEVICE profiler
    (obs/profile.py): a torch.profiler session into the env-sanctioned
    $KARPENTER_PROFILE_DIR, the promoted form of the provisioner's old
    ad-hoc per-pass hook. `python -m karpenter_tpu_torch.obs profile`
    wraps this pair from the terminal."""
    import sys
    import time as _time
    from collections import Counter
    device = query.get("device", [""])[0]
    if device:
        from ..obs.profile import PROFILER, ProfileError
        try:
            if device == "start":
                # the session outlives this handler's thread
                out_dir = PROFILER.start(worker=True)
                return (200, "text/plain",
                        f"device profile started into {out_dir}\n")
            if device == "stop":
                out_dir = PROFILER.stop()
                return (200, "text/plain",
                        f"device profile stopped; trace in {out_dir}\n")
            return (400, "text/plain",
                    "device must be 'start' or 'stop'")
        except ProfileError as e:
            return 409, "text/plain", f"{e}\n"
    try:
        seconds = float(query.get("seconds", ["5"])[0])
    except (TypeError, ValueError):
        return 400, "text/plain", "seconds must be a number"
    seconds = max(0.1, min(60.0, seconds))
    hz = 100
    me = threading.get_ident()
    samples: Counter = Counter()
    total = 0
    end = _time.monotonic() + seconds
    while _time.monotonic() < end:
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            stack = []
            f = frame
            while f is not None and len(stack) < 64:
                code = f.f_code
                stack.append(f"{code.co_name} "
                             f"({code.co_filename.rsplit('/', 1)[-1]}:"
                             f"{f.f_lineno})")
                f = f.f_back
            samples[(names.get(ident, str(ident)),
                     tuple(reversed(stack)))] += 1
        total += 1
        _time.sleep(1.0 / hz)
    lines = [f"# folded stacks, {total} sampling rounds over "
             f"{seconds:.1f}s at ~{hz} Hz"]
    for (tname, stack), count in samples.most_common():
        lines.append(f"{tname};" + ";".join(stack) + f" {count}")
    return 200, "text/plain", "\n".join(lines) + "\n"


def _debug_deadletter_factory(manager):
    """Quarantined work items (the manager's dead-letter set): what gave
    up retrying, why, and when — the first stop when reconcile_quarantined
    is non-zero. Served unconditionally (unlike the profiling routes):
    quarantine is an operational surface, not a diagnostic one."""
    def fn():
        if manager is None:
            return 404, "text/plain", "no manager attached"
        items = dict(manager.deadletter)  # snapshot (GIL-atomic copy)
        lines = [f"quarantined {len(items)}"]
        for key, info in sorted(items.items()):
            lines.append(
                f"{info['controller']} {info['kind']}/"
                f"{(info['namespace'] + '/') if info['namespace'] else ''}"
                f"{info['name']} failures={info['failures']} "
                f"at={info['at']:.3f} error={info['error']}")
        return 200, "text/plain", "\n".join(lines) + "\n"
    return fn


def _debug_flightrec_factory(flightrec):
    """The decision flight recorder's operator surface: GET serves the
    last-N record summaries (?n=, default 50; ?format=jsonl streams the
    full records), and ?dump=1 materializes the ring to a JSONL trace file
    for `python -m karpenter_tpu_torch.flightrec replay`. Dumps land inside ONE
    operator-configured directory ($KARPENTER_FLIGHTREC_DIR or the system
    tempdir) with an optional ?name= basename — a debug port must not be a
    write-anywhere primitive."""
    def fn(query: dict):
        import os
        import tempfile
        if flightrec is None:
            return 404, "text/plain", "no flight recorder attached"
        try:
            n = max(1, int(query.get("n", ["50"])[0]))
        except (TypeError, ValueError):
            return 400, "text/plain", "n must be an integer"
        if query.get("dump", [""])[0] in ("1", "true"):
            base = os.path.basename(
                query.get("name", ["flightrec.jsonl"])[0]) or \
                "flightrec.jsonl"
            out_dir = os.environ.get("KARPENTER_FLIGHTREC_DIR",
                                     tempfile.gettempdir())
            path = os.path.join(out_dir, base)
            count = flightrec.dump(path)
            return 200, "text/plain", f"dumped {count} records to {path}\n"
        if query.get("format", [""])[0] == "jsonl":
            return (200, "application/jsonl",
                    "\n".join(flightrec.lines(n)) + "\n")
        records = flightrec.records(n)
        lines = [f"records {len(flightrec)} (showing {len(records)}, "
                 f"capacity {flightrec.capacity})"]
        lines += [r.summary() for r in records]
        return 200, "text/plain", "\n".join(lines) + "\n"
    return fn


def _debug_offerings_factory(unavailable):
    """The unavailable-offerings registry's operator surface: which
    offering keys are currently cached as dry, why, their (escalated) TTLs
    and time to expiry — the first stop when pods carry
    AllOfferingsUnavailable events or karpenter_offerings_unavailable is
    non-zero. Operational like /debug/deadletter: served whenever a
    registry exists, not gated behind profiling."""
    def fn():
        if unavailable is None:
            return 404, "text/plain", "no unavailable-offerings registry"
        entries = unavailable.snapshot()
        lines = [f"unavailable {len(entries)}"]
        for e in entries:
            lines.append(
                f"{e['instance_type']}/{e['zone']}/{e['capacity_type']} "
                f"reason={e['reason']} ttl={e['ttl']:.0f}s "
                f"strikes={e['strikes']} expires_in={e['expires_in']:.1f}s")
        return 200, "text/plain", "\n".join(lines) + "\n"
    return fn


def _debug_traces_factory(tracer):
    """The pass tracer's operator surface: GET serves trace summaries
    (?n=, default 50); ?format=chrome returns Chrome trace-event JSON of
    the last-N completed traces (open in Perfetto / chrome://tracing —
    `python -m karpenter_tpu_torch.obs dump --url` wraps this); ?trace_id=
    narrows to one pass (the id from a log line, flight-recorder record,
    or SLO breach)."""
    def fn(query: dict):
        if tracer is None:
            return 404, "text/plain", "no tracer attached"
        try:
            n = max(1, int(query.get("n", ["50"])[0]))
        except (TypeError, ValueError):
            return 400, "text/plain", "n must be an integer"
        trace_id = query.get("trace_id", [""])[0]
        if trace_id:
            t = tracer.find(trace_id)
            if t is None:
                return (404, "text/plain",
                        f"trace {trace_id} not in the ring\n")
            traces = [t]
        else:
            traces = tracer.traces(n)
        # multi-tenant narrowing: sidecar-served passes stamp tenant +
        # session onto the root span; ?tenant= / ?session= filter on them
        for key in ("tenant", "session"):
            want = query.get(key, [""])[0]
            if want:
                traces = [t for t in traces
                          if str(t.root.attrs.get(key, "")) == want]
        if query.get("format", [""])[0] == "chrome":
            from ..obs.tracer import dumps_chrome
            return 200, "application/json", dumps_chrome(traces)
        lines = [f"traces {len(traces)} (ring capacity {tracer.capacity}, "
                 f"enabled {tracer.enabled})"]
        lines += [t.summary() for t in traces]
        return 200, "text/plain", "\n".join(lines) + "\n"
    return fn


def _debug_slo_factory(slo):
    """The SLO watcher's operator surface: configured budgets with their
    rolling p50/p99, and the recent breaches (trace_id + flight-recorder
    dump path) — the first stop when karpenter_slo_breaches_total moves.
    ?tenant= narrows the windows and breaches to one sidecar tenant."""
    def fn(query: dict):
        import json
        if slo is None:
            return 404, "text/plain", "no SLO watcher attached"
        tenant = query.get("tenant", [""])[0] or None
        return (200, "application/json",
                json.dumps(slo.snapshot(tenant=tenant), indent=1) + "\n")
    return fn


def _debug_fallbacks(query: dict):
    """The fallback cost ledger's operator surface (process-global like
    /metrics): per-shape-class host-oracle escape counts, pod volumes and
    host-vs-tensor wall cost, plus the recent per-solve attribution
    records — the first stop when karpenter_fallback_pods_total moves, and
    ROADMAP item 1's priority ordering. ?n= bounds the recent list."""
    import json
    from ..obs.fallbacks import LEDGER
    try:
        n = max(0, int(query.get("n", ["20"])[0]))
    except (TypeError, ValueError):
        return 400, "text/plain", "n must be an integer"
    return (200, "application/json",
            json.dumps(LEDGER.snapshot(recent=n), indent=1) + "\n")


def _debug_stateplane(query: dict):
    """The shared encode-plane surface (process-global like /metrics and
    /debug/fallbacks): every live EncodePlane's subscriber refcounts,
    topology revision, node-row/group-row/stack cache occupancy and
    shared-vs-reencoded counters — the first stop when
    karpenter_state_plane_rows_total{outcome="reencoded"} moves. Refreshes
    karpenter_state_plane_subscribers so the gauge and this view agree."""
    import json
    from ..state.plane import live_planes, refresh_subscriber_gauge
    refresh_subscriber_gauge()
    planes = sorted(live_planes(), key=lambda p: p.name)
    # this HTTP thread races the owning solver loop, which mutates the
    # plane caches mid-pass (they are deliberately lock-free); debug_view
    # iterates copied views, but a resize can still land mid-copy — retry
    # the lost race like /debug/offerings' snapshot does. Three straight
    # losses means the loop is churning and the caller gets the error.
    for attempt in range(3):
        try:
            views = [p.debug_view() for p in planes]
            break
        except RuntimeError:
            if attempt == 2:
                raise
    return (200, "application/json",
            json.dumps(views, indent=1) + "\n")


def _debug_sessions_factory(sessions):
    """The sidecar's session-table surface (the /debug/offerings
    snapshot pattern): per-tenant session digest, queue
    depth, in-flight count, last-solve age and resync/dedupe counters —
    the first stop when karpenter_sidecar_session_resyncs_total moves or a
    tenant reports slow solves. `sessions` is a snapshot callable
    (sidecar.server.sessions_snapshot) so the HTTP thread never walks live
    state."""
    def fn():
        if sessions is None:
            return 404, "text/plain", "no sidecar session table attached"
        entries = sessions()
        lines = [f"sessions {len(entries)}"]
        for e in entries:
            lines.append(
                f"{e['session']} tenant={e['tenant']} digest={e['digest']} "
                f"rows={e['rows']} nodes={e['nodes']} "
                f"templates={e['templates']} in_flight={e['in_flight']} "
                f"queue_depth={e['queue_depth']} "
                f"last_solve_age_s={e['last_solve_age_s']} "
                f"solves={e['solves']} resyncs={e['resyncs']} "
                f"dedup_hits={e['dedup_hits']}")
        return 200, "text/plain", "\n".join(lines) + "\n"
    return fn


def _debug_timers_factory(manager):
    def fn():
        if manager is None:
            return 404, "text/plain", "no manager attached"
        # snapshot first: the manager thread mutates these while we render
        # (dict copy is atomic under the GIL)
        pending = dict(manager._timer_pending)
        lines = [f"pending_timers {len(pending)}",
                 f"queue_depth {len(manager._queue)}"]
        for key, fire_at in sorted(pending.items(),
                                   key=lambda kv: kv[1])[:200]:
            lines.append(f"{fire_at:.3f} {'/'.join(str(k) for k in key)}")
        return 200, "text/plain", "\n".join(lines) + "\n"
    return fn


class ServingGroup:
    """Metrics server + health-probe server (operator.go:142-175). Checks
    default to always-healthy; the operator wires liveness to the manager.
    Port 0 binds an ephemeral port (tests); resolved ports are exposed as
    metrics_port/health_port. With profiling enabled, /debug/stacks (thread
    dump — the pprof analog) and /debug/timers (manager work-queue state)
    serve on the metrics port."""

    def __init__(self, metrics_port: int, health_probe_port: int,
                 healthy: Callable[[], bool] = lambda: True,
                 ready: Callable[[], bool] = lambda: True,
                 registry=REGISTRY, profiling: bool = False, manager=None,
                 flightrec=None, unavailable=None, tracer=None, slo=None,
                 sessions=None):
        def probe(check: Callable[[], bool]):
            def fn():
                if check():
                    return 200, "text/plain", "ok"
                return 503, "text/plain", "unhealthy"
            return fn

        metrics_routes = {
            "/metrics": lambda: (200, "text/plain; version=0.0.4",
                                 registry.expose()),
            # the fallback cost ledger is process-global (obs/fallbacks),
            # so its surface serves wherever /metrics does
            "/debug/fallbacks": _debug_fallbacks,
            # the state plane's registry is likewise process-global
            # (state.plane._LIVE_PLANES), so its surface serves wherever
            # /metrics does
            "/debug/stateplane": _debug_stateplane,
        }
        if manager is not None:
            metrics_routes["/debug/deadletter"] = \
                _debug_deadletter_factory(manager)
        if flightrec is not None:
            # operational surface like /debug/deadletter: served whenever a
            # recorder exists, not gated behind profiling
            metrics_routes["/debug/flightrecorder"] = \
                _debug_flightrec_factory(flightrec)
        if unavailable is not None:
            metrics_routes["/debug/offerings"] = \
                _debug_offerings_factory(unavailable)
        if tracer is not None:
            # operational like /debug/flightrecorder: served whenever the
            # pass tracer exists, not gated behind profiling
            metrics_routes["/debug/traces"] = _debug_traces_factory(tracer)
        if slo is not None:
            metrics_routes["/debug/slo"] = _debug_slo_factory(slo)
        if sessions is not None:
            # the sidecar's session table (sidecar.server.sessions_snapshot
            # callable): operational like /debug/offerings
            metrics_routes["/debug/sessions"] = \
                _debug_sessions_factory(sessions)
        if profiling:
            metrics_routes["/debug/stacks"] = _debug_stacks
            metrics_routes["/debug/timers"] = _debug_timers_factory(manager)
            metrics_routes["/debug/profile"] = _debug_profile
        self._metrics = _Server(metrics_port, metrics_routes)
        self._health = _Server(health_probe_port, {
            "/healthz": probe(healthy),
            "/readyz": probe(ready),
        })
        self.metrics_port = self._metrics.port
        self.health_port = self._health.port

    def start(self) -> "ServingGroup":
        self._metrics.start()
        self._health.start()
        return self

    def stop(self) -> None:
        self._metrics.stop()
        self._health.stop()
