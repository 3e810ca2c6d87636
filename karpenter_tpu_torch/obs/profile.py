"""Device profiling facility: one process-wide ``torch.profiler`` session.

A profiler session is process-wide state (one profile at a time), so the
facility is too. It owns the ONE session and exposes it two ways:

- ``PROFILER.start(dir)/stop()`` — programmatic start/stop; ``stop()``
  writes the session's Chrome trace (``export_chrome_trace``) into the
  directory, one ``profile-<pid>-<n>.json`` file a session;
- ``Provisioner.profile_dir`` — a per-pass profile through
  :meth:`Profiler.pass_scope`.

The session records CUDA activity (every kernel launch and copy, with its
device time) when the card is present, and the host's PyTorch operations
always.

Env-gated: a profile lands ONLY in an operator-sanctioned directory —
``$KARPENTER_PROFILE_DIR`` or an explicit ``start(dir)`` — never a
caller-chosen path (a debug port must not be a write-anywhere primitive).

:meth:`Profiler.pass_scope` NESTS SAFELY: while a session is active the
per-pass hook is a no-op instead of a second session.
"""

from __future__ import annotations

import itertools
import os
import threading
from contextlib import contextmanager
from typing import Optional

PROFILE_DIR_ENV = "KARPENTER_PROFILE_DIR"

#: numbers the Chrome traces of this process's sessions
_SESSIONS = itertools.count(1)


class ProfileError(RuntimeError):
    """Misuse of the single profiler session (double start, stop without
    start, no sanctioned output directory)."""


def _activities():
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


class Profiler:
    def __init__(self):
        self._lock = threading.Lock()
        self._dir: Optional[str] = None
        self._session = None
        #: the Chrome trace the last stop() wrote
        self.last_trace: Optional[str] = None

    @property
    def active(self) -> bool:
        return self._dir is not None

    @property
    def out_dir(self) -> Optional[str]:
        return self._dir

    def start(self, out_dir: Optional[str] = None) -> str:
        """Begin a device profile into `out_dir` (or $KARPENTER_PROFILE_DIR).
        Returns the directory; raises ProfileError when a session is
        already running or no sanctioned directory exists."""
        out_dir = out_dir or os.environ.get(PROFILE_DIR_ENV)
        if not out_dir:
            raise ProfileError(
                "no profile directory: pass one or set "
                f"${PROFILE_DIR_ENV} (profiles only land in an "
                "operator-sanctioned directory)")
        with self._lock:
            if self._dir is not None:
                raise ProfileError(
                    f"a device profile is already running into {self._dir}; "
                    "stop it first (one profiler session at a time)")
            from torch.profiler import profile
            os.makedirs(out_dir, exist_ok=True)
            session = profile(activities=_activities())
            session.start()
            self._session, self._dir = session, out_dir
            from ..metrics.registry import PROFILE_ACTIVE
            PROFILE_ACTIVE.set(1.0)
            return out_dir

    def stop(self) -> str:
        """End the running profile and write its Chrome trace; returns the
        directory it wrote to."""
        import torch
        with self._lock:
            if self._dir is None:
                raise ProfileError("no device profile is running")
            session, out_dir = self._session, self._dir
            self._session = self._dir = None
            from ..metrics.registry import PROFILE_ACTIVE
            PROFILE_ACTIVE.set(0.0)
            if torch.cuda.is_available():
                # every launch of the session finished, so its device
                # activity is in the buffers the stop flushes
                torch.cuda.synchronize()
            session.stop()
            path = os.path.join(
                out_dir, f"profile-{os.getpid()}-{next(_SESSIONS)}.json")
            session.export_chrome_trace(path)
            self.last_trace = path
            return out_dir

    @contextmanager
    def pass_scope(self, out_dir: str):
        """The provisioner's per-pass hook: profile exactly this scope —
        unless a session is already active, in which case the pass is
        already being captured and the scope is a no-op. Registers through
        start()/stop() so the session is VISIBLE: PROFILE_ACTIVE reads 1,
        and a concurrent start() gets the clean already-running
        ProfileError."""
        try:
            self.start(out_dir)
        except ProfileError:
            # a session is already capturing this pass: nothing to do
            yield
            return
        except Exception:  # noqa: BLE001 — profiling must never cost a pass
            yield
            return
        try:
            yield
        finally:
            try:
                self.stop()
            except Exception:  # noqa: BLE001
                pass


PROFILER = Profiler()
