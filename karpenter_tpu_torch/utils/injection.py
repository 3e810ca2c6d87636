"""Controller-name injection (pkg/operator/injection/injection.go analog).

The reference stores the reconciling controller's name in the context so
cross-cutting layers (the cloudprovider metrics decorator, loggers) can label
by caller without threading a parameter through every signature. A
contextvar plays the role of context.Context here; the Manager sets it
around every reconcile dispatch."""

from __future__ import annotations

import contextlib
import contextvars

_controller: contextvars.ContextVar = contextvars.ContextVar(
    "karpenter_controller", default="")


def controller_name() -> str:
    return _controller.get()


@contextlib.contextmanager
def with_controller(name: str):
    token = _controller.set(name)
    try:
        yield
    finally:
        _controller.reset(token)
