"""Structured, level-configurable JSON logging.

Mirrors karpenter's pkg/operator/logging/logging.go:55-124: one zap-style
JSON line per record ({"level","time","logger","message", ...key-values}),
level set from Options.log_level, a NOP logger for simulation paths that must
stay silent (logging.go:34-36 NopLogger), and named component loggers
(NewLogger(ctx, component)). Built on the stdlib logging machinery so
handlers/levels compose with anything the embedding process already does.
"""

from __future__ import annotations

import json
import logging as stdlog
import sys
import time
from typing import Optional

_LEVELS = {
    "debug": stdlog.DEBUG,
    "info": stdlog.INFO,
    "warn": stdlog.WARNING,
    "warning": stdlog.WARNING,
    "error": stdlog.ERROR,
}

_ROOT_NAME = "karpenter"


class JSONFormatter(stdlog.Formatter):
    """zap production-config encoding (logging.go:60-79): message/level/time/
    logger keys, ISO8601 time, extra key-values inlined."""

    def format(self, record: stdlog.LogRecord) -> str:
        out = {
            "level": record.levelname,
            "time": time.strftime("%Y-%m-%dT%H:%M:%S",
                                  time.localtime(record.created))
            + f".{int(record.msecs):03d}",
            "logger": record.name,
            "message": record.getMessage(),
        }
        kv = getattr(record, "kv", None)
        if kv:
            out.update(kv)
        if record.exc_info and record.exc_info[0] is not None:
            out["error"] = str(record.exc_info[1])
        return json.dumps(out, default=str)


class Logger:
    """zap.SugaredLogger-shaped wrapper: leveled methods take structured
    key-values; with_values() binds context the way zap's With does."""

    def __init__(self, py: stdlog.Logger, bound: Optional[dict] = None):
        self._py = py
        self._bound = dict(bound or {})

    def named(self, name: str) -> "Logger":
        return Logger(self._py.getChild(name), self._bound)

    def with_values(self, **kv) -> "Logger":
        merged = dict(self._bound)
        merged.update(kv)
        return Logger(self._py, merged)

    def _log(self, level: int, msg: str, kv: dict) -> None:
        if not self._py.isEnabledFor(level):
            return
        merged = dict(self._bound)
        merged.update(kv)
        self._py.log(level, msg, extra={"kv": merged})

    def debug(self, msg: str, **kv) -> None:
        self._log(stdlog.DEBUG, msg, kv)

    def info(self, msg: str, **kv) -> None:
        self._log(stdlog.INFO, msg, kv)

    def warning(self, msg: str, **kv) -> None:
        self._log(stdlog.WARNING, msg, kv)

    def error(self, msg: str, **kv) -> None:
        self._log(stdlog.ERROR, msg, kv)


def configure(level: str = "info", stream=None) -> None:
    """Install the JSON handler on the karpenter root logger (idempotent;
    reconfiguring replaces the handler). Mirrors DefaultZapConfig: level from
    options, single output stream, no propagation into the host process's
    root logger."""
    root = stdlog.getLogger(_ROOT_NAME)
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = stdlog.StreamHandler(stream or sys.stderr)
    handler.setFormatter(JSONFormatter())
    root.addHandler(handler)
    root.setLevel(_LEVELS.get(level.lower(), stdlog.INFO))
    root.propagate = False


def get_logger(component: str = "") -> Logger:
    """NewLogger(ctx, component) analog. Loggers are children of the
    karpenter root, so one configure() call governs them all."""
    name = f"{_ROOT_NAME}.{component}" if component else _ROOT_NAME
    return Logger(stdlog.getLogger(name))


# NopLogger (logging.go:34-36): consolidation simulations re-enter the
# scheduler many times per decision; they log nothing.
_nop = stdlog.getLogger(_ROOT_NAME + ".nop")
_nop.addHandler(stdlog.NullHandler())
_nop.propagate = False
_nop.setLevel(stdlog.CRITICAL + 1)
NOP = Logger(_nop)
