"""Deduplicating event recorder.

Mirrors karpenter's pkg/events/recorder.go:47-100: identical events
(involved object + reason + message) within the dedupe TTL are dropped; a
per-key rate limit (10 qps in the reference) bounds bursts.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..metrics.registry import EVENTS_DROPPED
from ..utils.clock import Clock

DEDUPE_TTL_SECONDS = 120.0   # recorder.go dedupeTimeout
RATE_LIMIT_QPS = 10.0


@dataclass
class Event:
    """events/events.go Event shape. ``dedupe_ttl`` overrides the default
    dedupe window (events.go DedupeTimeout; e.g. Unconsolidatable uses 15
    min, NodePool budget blocks 1 min). ``dedupe_values`` mirrors
    DedupeValues (recorder.go:74: the key is type+reason+values, NOT the
    message — a churning message like a shrinking pod count must still
    dedupe); when unset, the key falls back to the full identity including
    the message."""
    object_kind: str
    object_name: str
    type: str          # Normal | Warning
    reason: str
    message: str
    timestamp: float = 0.0
    namespace: str = ""
    dedupe_ttl: Optional[float] = None
    dedupe_values: tuple = ()

    def dedupe_key(self) -> str:
        if self.dedupe_values:
            return "/".join((self.type, self.reason, self.object_kind)
                            + tuple(self.dedupe_values))
        return (f"{self.object_kind}/{self.namespace}/{self.object_name}/"
                f"{self.reason}/{self.message}")


class Recorder:
    """``sink``, when set, receives every event that survives dedupe/rate
    limiting — the operator's kube backend uses it to POST real v1.Event
    objects through the apiserver adapter; sink errors are swallowed (event
    delivery is best-effort in the reference's client-go recorder too)."""

    def __init__(self, clock: Optional[Clock] = None, sink=None):
        self.clock = clock or Clock()
        self.sink = sink
        self.events: List[Event] = []
        self._last_seen: Dict[str, float] = {}
        self._bucket: Dict[str, List[float]] = {}

    def publish(self, *events: Event) -> None:
        now = self.clock.now()
        for ev in events:
            key = ev.dedupe_key()
            ttl = ev.dedupe_ttl if ev.dedupe_ttl is not None \
                else DEDUPE_TTL_SECONDS
            last = self._last_seen.get(key)
            if last is not None and now - last < ttl:
                continue
            window = [t for t in self._bucket.get(key, []) if now - t < 1.0]
            if len(window) >= RATE_LIMIT_QPS:
                continue
            window.append(now)
            self._bucket[key] = window
            self._last_seen[key] = now
            ev.timestamp = now
            self.events.append(ev)
            if self.sink is not None:
                try:
                    self.sink(ev)
                except Exception:  # noqa: BLE001 — best-effort delivery,
                    # but every drop is counted: silent loss is the one
                    # thing best-effort must not be
                    EVENTS_DROPPED.inc({"reason": "sink_error"})

    def for_object(self, name: str) -> List[Event]:
        return [e for e in self.events if e.object_name == name]

    def reasons_for(self, name: str) -> List[str]:
        return [e.reason for e in self.events if e.object_name == name]


class AsyncSink:
    """Buffered off-thread event delivery — the client-go event
    broadcaster's job (the reference never blocks a reconcile on an event
    POST; record.EventRecorder enqueues and a background watcher flushes).
    Wrap a blocking deliver callable (e.g. KubeApiStore.post_event) and use
    the instance as Recorder.sink. Overflow drops events (best-effort,
    like the broadcaster's bounded queue); delivery errors are swallowed."""

    _CLOSE = object()

    def __init__(self, deliver, maxsize: int = 1024):
        import queue
        import threading
        self._deliver = deliver
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self.dropped = 0
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="karpenter-event-sink")
        self._thread.start()

    def __call__(self, ev: Event) -> None:
        import queue
        try:
            self._q.put_nowait(ev)
        except queue.Full:
            self.dropped += 1
            EVENTS_DROPPED.inc({"reason": "queue_full"})

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is self._CLOSE:
                    return
                try:
                    self._deliver(item)
                except Exception:  # noqa: BLE001 — best-effort delivery
                    EVENTS_DROPPED.inc({"reason": "deliver_error"})
            finally:
                self._q.task_done()

    def flush(self) -> None:
        """Block until everything enqueued so far is delivered (tests and
        operator shutdown)."""
        self._q.join()

    def close(self) -> None:
        self.flush()
        self._q.put(self._CLOSE)
        self._thread.join(timeout=5)
