"""Scoped cyclic-GC suppression for latency-critical sections.

A 50k-pod solve allocates ~10^5 short-lived container objects; CPython's
generational collector fires unpredictably inside the solve and costs
50-400 ms per pause (measured on the north-star shape). Refcounting
reclaims essentially all of the solve's garbage, so suppressing the
cyclic collector for the duration moves the (much smaller) sweep to
whenever the process is next idle. The sidecar server goes further and
disables collection process-wide (sidecar/server.py _idle_gc_loop);
there this guard is a no-op.
"""

from __future__ import annotations

import gc
import threading
from contextlib import contextmanager

_lock = threading.Lock()
_count = 0
_was_enabled = False


@contextmanager
def no_gc():
    """Disable cyclic GC for the duration; reentrant and thread-safe (the
    collector resumes when the LAST overlapping section exits)."""
    global _count, _was_enabled
    with _lock:
        if _count == 0:
            _was_enabled = gc.isenabled()
            if _was_enabled:
                gc.disable()
        _count += 1
    try:
        yield
    finally:
        with _lock:
            _count -= 1
            if _count == 0 and _was_enabled:
                gc.enable()
