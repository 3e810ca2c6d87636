"""Injectable clock, mirroring the reference's clock.Clock injection
(karpenter uses k8s.io/utils/clock everywhere; fake clocks drive
time-dependent behavior in tests — SURVEY.md §4 determinism note).

The fake clock is thread-safe and supports SLEEPERS: a thread calling
``sleep(seconds)`` blocks on a condition variable until another thread
advances the fake time past its deadline (``step``/``set_time`` wake all
sleepers; no busy-polling). This is what lets the fleet simulator (sim/)
and the real-time ``Operator.run`` loop share one code path — under a real
Clock ``sleep`` is ``time.sleep``, under a FakeClock the simulator's
accelerated advance wakes the loop instantly.
"""

from __future__ import annotations

import threading
import time


class Clock:
    def now(self) -> float:
        return time.time()

    def since(self, t: float) -> float:
        return self.now() - t

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class FakeClock(Clock):
    """Deterministic clock for tests and simulations: starts at a fixed
    epoch, moves only via step()/set_time(). Safe to read and advance from
    multiple threads; ``sleep`` parks the calling thread on a condition
    variable until the fake time crosses its deadline (every advance
    notifies — a sleeper is woken at most once per advance, never polled).
    """

    def __init__(self, start: float = 1_000_000.0):
        self._now = start
        self._cond = threading.Condition()
        # threads currently parked in sleep(): observable so tests can pin
        # "the sleeper is blocked on the condition variable, not spinning"
        self._sleepers = 0

    def now(self) -> float:
        with self._cond:
            return self._now

    def step(self, seconds: float) -> float:
        with self._cond:
            self._now += seconds
            self._cond.notify_all()
            return self._now

    def set_time(self, t: float) -> None:
        with self._cond:
            self._now = t
            self._cond.notify_all()

    @property
    def sleepers(self) -> int:
        with self._cond:
            return self._sleepers

    def sleep(self, seconds: float) -> None:
        """Block until the fake time advances to now + seconds (condition-
        variable wakeup from step/set_time — never a busy-poll). A zero or
        negative duration returns immediately without taking a ticket."""
        with self._cond:
            deadline = self._now + seconds
            if self._now >= deadline:
                return
            self._sleepers += 1
            try:
                while self._now < deadline:
                    self._cond.wait()
            finally:
                self._sleepers -= 1
