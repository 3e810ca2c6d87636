"""Per-item exponential failure backoff.

The workqueue.NewItemExponentialFailureRateLimiter analog the reference's
queues are built on: each failing item's retry delay doubles from `base` up
to `cap`; success forgets the item (orchestration/queue.go:128-132 with
1s/10s, terminator/eviction.go:49-50,94 with 100ms/10s)."""

from __future__ import annotations

from typing import Dict, Hashable


class TerminalError(Exception):
    """Non-retryable failure (reconcile.TerminalError mirror): the retry
    machinery must not re-attempt it — retrying cannot help (bad spec,
    permanent rejection). Lives here with the retry policy so leaf modules
    (utils/chaos.py) can raise it without importing the controller runtime;
    controllers.manager re-exports it as its public home."""


class ItemBackoff:
    def __init__(self, base: float, cap: float):
        self.base = base
        self.cap = cap
        self._failures: Dict[Hashable, int] = {}

    def next_delay(self, key: Hashable) -> float:
        """Record a failure for key and return the delay before its retry."""
        n = self._failures.get(key, 0)
        self._failures[key] = n + 1
        return min(self.base * (2 ** n), self.cap)

    def failures(self, key: Hashable) -> int:
        return self._failures.get(key, 0)

    def forget(self, key: Hashable) -> None:
        self._failures.pop(key, None)
