"""ChaosStore: the in-memory store with seeded fault injection.

A `Store` whose CRUD surface raises transient faults at the injector's
seeded rate — the standalone analog of a flaky apiserver (dropped
connections, 500s, leader churn). Faults fire BEFORE the mutation is
applied, modeling a request that never reached the server: the store is
never left half-written, watchers never see a phantom event, and a
reconciler that retries observes exactly the state its failed call left
behind.

Reads fault too: the Manager's drain() re-fetch runs inside its recovery
region, so a flaky `get` exercises the crash-isolation path the same way
a raising reconciler does.
"""

from __future__ import annotations

from typing import Optional

from ..utils.chaos import FaultInjector
from ..utils.clock import Clock
from .store import Store


class ChaosStore(Store):
    def __init__(self, clock: Optional[Clock] = None,
                 injector: Optional[FaultInjector] = None):
        super().__init__(clock)
        self.injector = injector
        self._in_notify = 0

    def _notify(self, etype: str, obj) -> None:
        # faults model the API surface CONTROLLERS call, not the watch
        # fan-out: informer callbacks re-enter the store (cluster cache
        # lookups), and a fault there would skip the remaining watchers of
        # an already-committed event — a failure mode real informers don't
        # have, and one that breaks delivery invariants the chaos harness
        # is supposed to respect
        self._in_notify += 1
        try:
            super()._notify(etype, obj)
        finally:
            self._in_notify -= 1

    def _gate(self, op: str, name: str = "") -> None:
        if self.injector is not None and not self._in_notify:
            self.injector.maybe_raise(f"store.{op}", name)

    # faults strike before the mutation: a failed request never happened

    def create(self, obj):
        self._gate("create", obj.metadata.name)
        return super().create(obj)

    def get(self, kind: type, name: str, namespace: str = ""):
        self._gate("get", name)
        return super().get(kind, name, namespace)

    def list(self, kind: type, namespace=None, predicate=None,
             field_selector=None):
        self._gate("list")
        return super().list(kind, namespace, predicate, field_selector)

    def update(self, obj):
        self._gate("update", obj.metadata.name)
        return super().update(obj)

    def delete(self, obj):
        self._gate("delete", obj.metadata.name)
        return super().delete(obj)

    def remove_finalizer(self, obj, finalizer: str):
        self._gate("remove_finalizer", obj.metadata.name)
        return super().remove_finalizer(obj, finalizer)
