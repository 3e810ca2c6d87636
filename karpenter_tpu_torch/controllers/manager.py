"""Controller manager: the runtime that drives all reconcilers.

The reference uses controller-runtime (operator.go:105-206): watch-driven
per-object reconcilers plus singleton controllers (provisioner, disruption)
on their own loops. This manager reproduces that model on a deterministic
single dispatch queue:

- watch controllers subscribe to object kinds; store events enqueue
  (controller, object-ref) work items, deduped the way controller-runtime's
  workqueue dedupes;
- singleton controllers run on tick() — the test harness calls them
  explicitly (the reference's ExpectSingletonReconciled), the operator loop
  calls them on their poll cadence;
- requeue-after is honored via the injected clock, so fake clocks drive
  time-based reconciles in tests exactly like the reference's fake
  clock.Clock.

Determinism over parallelism is intentional: the reference needs 1000-way
reconcile concurrency because each reconcile blocks on API round-trips
(lifecycle/controller.go:102); here store ops are in-memory and the heavy
math lives in batched device programs, so a single dispatch loop keeps
ordering reproducible without sacrificing throughput.
"""

from __future__ import annotations

import heapq
import itertools
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ..kube.store import DELETED, Event, Store
from ..logging import get_logger
from ..metrics.registry import RECONCILE_ERRORS, RECONCILE_QUARANTINED
from ..utils.backoff import ItemBackoff, TerminalError
from ..utils.clock import Clock
from ..utils.injection import with_controller

log = get_logger("manager")

# Per-item retry schedule: workqueue.DefaultTypedControllerRateLimiter's
# ItemExponentialFailureRateLimiter parameters scaled for an operator loop
# (1s base instead of 5ms — store ops are in-memory, so sub-second retries
# would just spin the dispatch loop against a persistent fault).
RETRY_BASE_SECONDS = 1.0
RETRY_CAP_SECONDS = 300.0
# Consecutive failures before an item is quarantined to the dead-letter set.
# The reference retries forever (rate-limited); quarantine is this runtime's
# crash-only refinement — see DEVIATIONS.md.
MAX_RETRIES = 10


# TerminalError's public home is this module (the reconcile runtime, like
# the reference's reconcile.TerminalError); it is DEFINED in utils/backoff
# alongside the retry policy so leaf modules can raise it without importing
# the controller runtime. Raised from a reconciler, the error is counted
# and logged but the item is neither retried nor quarantined. Wrap a cause:
# ``raise TerminalError(str(exc)) from exc``.
__all__ = ["Controller", "Manager", "Result", "SingletonController",
           "TerminalError"]


def _never_quarantine(exc: BaseException) -> bool:
    """Typed cloudprovider errors that signal an environmental condition
    (capacity, eventual consistency) back off forever rather than dead-
    lettering the item: the item is healthy, the world is not."""
    from ..cloudprovider.types import (InsufficientCapacityError,
                                       NodeClassNotReadyError)
    return isinstance(exc, (InsufficientCapacityError,
                            NodeClassNotReadyError))


class Result:
    """Reconcile result: optional requeue delay in seconds."""

    def __init__(self, requeue_after: Optional[float] = None):
        self.requeue_after = requeue_after


class Controller:
    """Watch-driven reconciler. Subclasses set `kinds` and implement
    reconcile(obj) -> Optional[Result]."""

    name: str = "controller"
    kinds: tuple = ()

    def reconcile(self, obj) -> Optional[Result]:
        raise NotImplementedError

    def interested(self, ev: Event) -> bool:
        """Event filter; default = any event for a watched kind."""
        return True


class SingletonController:
    """Poll-loop reconciler (provisioner, disruption). reconcile() returns an
    optional Result whose requeue_after sets the next poll delay."""

    name: str = "singleton"

    def reconcile(self) -> Optional[Result]:
        raise NotImplementedError


class Manager:
    def __init__(self, store: Store, clock: Optional[Clock] = None,
                 recorder=None, max_retries: int = MAX_RETRIES):
        self.store = store
        self.clock = clock or store.clock
        self.recorder = recorder
        self.controllers: List[Controller] = []
        self.singletons: List[SingletonController] = []
        self._queue: Deque[Tuple[Controller, object]] = deque()
        self._queued: set = set()
        # crash isolation: per-(controller, object) retry backoff, the
        # dead-letter set for items that exhausted their retries, and the
        # workqueue processing/dirty state that makes failure-path requeue
        # exactly-once (an event arriving DURING a reconcile marks the item
        # dirty instead of double-queueing it)
        self.backoff = ItemBackoff(RETRY_BASE_SECONDS, RETRY_CAP_SECONDS)
        self.max_retries = max_retries
        # quarantine budget, tracked separately from the delay backoff:
        # exempt (never-quarantine) errors escalate the DELAY but reset
        # this counter, so "insufficient capacity for an hour, then one
        # apiserver flake" gets a full fresh retry budget instead of
        # instant dead-lettering
        self._q_failures: Dict[tuple, int] = {}
        self.deadletter: Dict[tuple, dict] = {}
        self._processing: Optional[tuple] = None
        self._dirty = False
        # singleton crash isolation: a raising singleton is skipped until
        # its backoff delay elapses instead of crashing tick()
        self._singleton_next: Dict[str, float] = {}
        self._timers: list = []  # heap of (fire_at, seq, controller, obj)
        self._timer_seq = itertools.count()
        # AddAfter dedup, bounded per (controller, object): one LIVE heap
        # entry (the earliest fire time) plus at most one DEFERRED later
        # intent — the LATEST requested fire time — re-armed when the live
        # timer fires. client-go's delaying queue keeps a single entry per
        # item and only moves it earlier — but silently dropping a later
        # requeue loses a controller's periodic recheck when the earlier
        # reconcile returns no requeue (ADVICE r3); keeping the latest
        # intent preserves the final recheck (intermediate intents are
        # subsumed by the earlier fire's reconcile) while still preventing
        # per-event perpetual timer chains
        self._timer_pending: Dict[tuple, float] = {}
        self._timer_deferred: Dict[tuple, tuple] = {}  # key -> (fire_at, c, obj)
        store.watch(self._on_event)

    # -- registration -------------------------------------------------------

    def register(self, *controllers) -> "Manager":
        for c in controllers:
            if isinstance(c, SingletonController):
                self.singletons.append(c)
            else:
                self.controllers.append(c)
        return self

    # -- event plumbing -----------------------------------------------------

    def _on_event(self, ev: Event) -> None:
        for c in self.controllers:
            if ev.kind in c.kinds and c.interested(ev):
                self._enqueue(c, ev.obj)

    def _enqueue(self, controller: Controller, obj) -> None:
        key = (controller.name, type(obj).__name__,
               obj.metadata.namespace, obj.metadata.name)
        if key == self._processing:
            # workqueue dirty-set semantics: new work for the item being
            # reconciled is folded into ONE post-reconcile requeue (on
            # success) or into the already-armed retry (on failure) —
            # never a second concurrent queue entry
            self._dirty = True
            return
        if key in self.deadletter:
            # new work releases a quarantined item: fresh input is the
            # crash-only recovery signal, and the failure budget restarts
            self._release(key)
        if key in self._queued:
            return
        self._queued.add(key)
        self._queue.append((controller, obj))

    def requeue(self, controller: Controller, obj, after: float) -> None:
        key = (controller.name, type(obj).__name__,
               obj.metadata.namespace, obj.metadata.name)
        fire_at = self.clock.now() + after
        pending = self._timer_pending.get(key)
        if pending is not None:
            if fire_at >= pending:
                # keep the LATEST intent to re-arm after the live timer
                # fires: earlier intermediate intents are subsumed by the
                # live timer's reconcile (which sees newer state and re-arms
                # as needed), but the final periodic recheck must survive
                if fire_at > pending:
                    deferred = self._timer_deferred.get(key)
                    if deferred is None or fire_at > deferred[0]:
                        self._timer_deferred[key] = (fire_at, controller, obj)
                return
            # earlier than the live timer: move it up (old entry goes stale);
            # the displaced time stays pending as the deferred later intent
            deferred = self._timer_deferred.get(key)
            if deferred is None or pending > deferred[0]:
                self._timer_deferred[key] = (pending, controller, obj)
        self._timer_pending[key] = fire_at
        heapq.heappush(self._timers,
                       (fire_at, next(self._timer_seq), controller, obj))

    # -- dispatch -----------------------------------------------------------

    def _fire_due_timers(self) -> None:
        now = self.clock.now()
        while self._timers and self._timers[0][0] <= now:
            fire_at, _, c, obj = heapq.heappop(self._timers)
            key = (c.name, type(obj).__name__,
                   obj.metadata.namespace, obj.metadata.name)
            if self._timer_pending.get(key) != fire_at:
                continue  # superseded by an earlier requeue; stale heap entry
            del self._timer_pending[key]
            deferred = self._timer_deferred.pop(key, None)
            if deferred is not None:
                d_at, d_c, d_obj = deferred
                self._timer_pending[key] = d_at
                heapq.heappush(self._timers,
                               (d_at, next(self._timer_seq), d_c, d_obj))
            self._enqueue(c, obj)

    def drain(self, max_items: int = 100_000) -> int:
        """Dispatch queued work until quiet. Returns items processed.

        Every item runs under recovery (controller-runtime recovers
        reconcile panics, controller.go:105-117): a raising reconciler is
        logged, counted in reconcile_errors_total, and retried through the
        per-item exponential backoff; after max_retries consecutive
        failures the item moves to the dead-letter set. The store re-fetch
        runs inside the protected region too — a flaky store read is a
        retryable failure, not a dispatch-loop crash."""
        n = 0
        self._fire_due_timers()
        while self._queue and n < max_items:
            controller, obj = self._queue.popleft()
            key = (controller.name, type(obj).__name__,
                   obj.metadata.namespace, obj.metadata.name)
            self._queued.discard(key)
            self._processing = key
            self._dirty = False
            target = obj
            try:
                with with_controller(controller.name):
                    # re-fetch: reconcile current state, not the snapshot
                    live = self.store.get(type(obj), obj.metadata.name,
                                          obj.metadata.namespace)
                    target = live if live is not None else obj
                    result = controller.reconcile(target)
            except Exception as exc:  # noqa: BLE001 — crash isolation
                dirty = self._dirty
                self._processing = None
                self._reconcile_failed(controller, target, key, exc, dirty)
            else:
                self._processing = None
                self.backoff.forget(key)
                self._q_failures.pop(key, None)
                if result is not None and result.requeue_after is not None:
                    self.requeue(controller, target, result.requeue_after)
                if self._dirty:
                    self._enqueue(controller, target)
            n += 1
            self._fire_due_timers()
        return n

    # -- failure handling ----------------------------------------------------

    def _reconcile_failed(self, controller, obj, key: tuple,
                          exc: Exception, dirty: bool = False) -> None:
        RECONCILE_ERRORS.inc({"controller": controller.name})
        log.error("reconcile failed", controller=controller.name,
                  kind=key[1], namespace=key[2], name=key[3],
                  error=f"{type(exc).__name__}: {exc}")
        if isinstance(exc, TerminalError):
            # reconcile.TerminalError semantics: never retried. A later
            # watch event still re-reconciles (new input, new verdict) —
            # including one that arrived DURING this reconcile (dirty).
            self.backoff.forget(key)
            self._q_failures.pop(key, None)
            if dirty:
                self._enqueue(controller, obj)
            return
        delay = self.backoff.next_delay(key)
        if _never_quarantine(exc):
            # environmental error: the delay keeps escalating, but the
            # quarantine budget restarts — the item itself is healthy
            self._q_failures.pop(key, None)
            self.requeue(controller, obj, delay)
            return
        n = self._q_failures.get(key, 0) + 1
        self._q_failures[key] = n
        if n >= self.max_retries:
            if dirty:
                # the event that arrived mid-reconcile is fresh input that
                # restarts the failure budget: retry immediately instead of
                # dead-lettering past it (and never publish a quarantine
                # that would last zero time)
                self.backoff.forget(key)
                self._q_failures.pop(key, None)
                self._enqueue(controller, obj)
                return
            self._quarantine(controller, obj, key, exc, n)
            return
        # dirty folds into the armed retry: exactly-once requeue
        self.requeue(controller, obj, delay)

    def _quarantine(self, controller, obj, key: tuple, exc: Exception,
                    failures: int) -> None:
        # `failures` is the quarantine budget actually consumed (consecutive
        # NON-exempt failures), not the raw backoff count — an exempt
        # capacity streak beforehand must not inflate what operators read
        self.deadletter[key] = {
            "controller": controller.name, "kind": key[1],
            "namespace": key[2], "name": key[3],
            "error": f"{type(exc).__name__}: {exc}",
            "failures": failures,
            "at": self.clock.now(), "obj": obj,
        }
        self.backoff.forget(key)
        self._q_failures.pop(key, None)
        # cancel any pre-quarantine requeue intent (a periodic recheck armed
        # by an earlier success): only a FRESH watch event may release the
        # quarantine, not a stale timer. Heap entries go stale and are
        # skipped by the _timer_pending fire check.
        self._timer_pending.pop(key, None)
        self._timer_deferred.pop(key, None)
        self._set_quarantine_gauge(controller.name)
        log.error("work item quarantined to the dead-letter set",
                  controller=controller.name, kind=key[1], name=key[3],
                  failures=self.deadletter[key]["failures"])
        if self.recorder is not None:
            from ..events import catalog as events_catalog
            self.recorder.publish(events_catalog.reconcile_quarantined(
                key[1], key[3], key[2], controller.name, str(exc)))

    def _release(self, key: tuple) -> None:
        info = self.deadletter.pop(key, None)
        if info is not None:
            self.backoff.forget(key)
            self._q_failures.pop(key, None)
            self._set_quarantine_gauge(info["controller"])

    def _set_quarantine_gauge(self, controller_name: str) -> None:
        RECONCILE_QUARANTINED.set(
            sum(1 for i in self.deadletter.values()
                if i["controller"] == controller_name),
            {"controller": controller_name})

    def _run_singleton(self, s: SingletonController) -> None:
        """One singleton pass under recovery: a raising singleton backs off
        (skipped until its retry delay elapses) instead of crashing the
        loop — the provisioner and disruption engines degrade to a slower
        cadence under faults, they do not take the operator down."""
        next_try = self._singleton_next.get(s.name)
        if next_try is not None and self.clock.now() < next_try:
            return
        try:
            with with_controller(s.name):
                s.reconcile()
        except Exception as exc:  # noqa: BLE001 — crash isolation
            RECONCILE_ERRORS.inc({"controller": s.name})
            key = (s.name, "__singleton__")
            if isinstance(exc, TerminalError):
                # a singleton is an engine — it can't be dead-lettered and
                # "never retry" would silently kill it, so terminal means
                # the SLOWEST cadence (straight to the cap, no escalation)
                self.backoff.forget(key)
                delay = RETRY_CAP_SECONDS
            else:
                delay = self.backoff.next_delay(key)
            self._singleton_next[s.name] = self.clock.now() + delay
            log.error("singleton reconcile failed", controller=s.name,
                      retry_in=delay, error=f"{type(exc).__name__}: {exc}")
        else:
            self._singleton_next.pop(s.name, None)
            self.backoff.forget((s.name, "__singleton__"))

    def tick(self) -> None:
        """Run every singleton once, then drain the fallout."""
        for s in self.singletons:
            self._run_singleton(s)
            self.drain()

    def run_until_quiet(self, max_rounds: int = 16) -> bool:
        """Drain + tick until no controller produces new work, for tests and
        the simulated operator loop. Returns True when the system quiesced,
        False on livelock (still producing work after max_rounds) — test
        callers assert the return so livelock regressions fail loudly."""
        for _ in range(max_rounds):
            moved = self.drain()
            for s in self.singletons:
                self._run_singleton(s)
            moved += self.drain()
            if moved == 0:
                return True
        log.warning("manager did not quiesce", max_rounds=max_rounds)
        return False

    def next_timer_at(self) -> Optional[float]:
        """Earliest LIVE requeue-timer fire time (None when no timer is
        armed). The fleet simulator's adaptive stepping asks this before
        each clock jump so an accelerated advance never overshoots a
        controller's scheduled recheck — eviction backoffs, liveness TTLs,
        kubelet ready delays all fire at their exact simulated instant."""
        # every deferred intent re-arms only after its key's LIVE timer
        # fires (and is never earlier than it), so the pending map alone
        # carries the earliest fire time
        pending = self._timer_pending.values()
        return min(pending) if pending else None

    def advance(self, seconds: float) -> None:
        """Step a FakeClock and fire due timers (test helper)."""
        step = getattr(self.clock, "step", None)
        if step is None:
            raise TypeError("advance() needs a FakeClock")
        step(seconds)
        self._fire_due_timers()
        self.drain()
