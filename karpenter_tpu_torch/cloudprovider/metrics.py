"""CloudProvider metrics decorator.

Mirrors karpenter's pkg/cloudprovider/metrics/cloudprovider.go:33-272:
wraps any CloudProvider, timing every SPI call into
karpenter_cloudprovider_duration_seconds{controller,method,provider} and
counting failures into
karpenter_cloudprovider_errors_total{controller,method,provider,error} with
the typed-error taxonomy as the error label. The controller label comes from
the injection contextvar (utils/injection.py), matching the reference's
context-derived label."""

from __future__ import annotations

from ..metrics.registry import REGISTRY
from ..utils.injection import controller_name
from .types import (CloudProvider, CloudProviderError,
                    InsufficientCapacityError, NodeClaimNotFoundError,
                    NodeClassNotReadyError)

METHOD_DURATION = REGISTRY.histogram(
    "karpenter_cloudprovider_duration_seconds",
    "Duration of cloud provider method calls.",
    ("controller", "method", "provider"))
ERRORS_TOTAL = REGISTRY.counter(
    "karpenter_cloudprovider_errors_total",
    "Total number of errors returned from CloudProvider calls.",
    ("controller", "method", "provider", "error"))

_SPI_METHODS = ("create", "delete", "get", "list", "get_instance_types",
                "is_drifted")


def _error_label(exc: BaseException) -> str:
    """Well-known typed-error names; "" = error type unknown
    (cloudprovider.go:37-43)."""
    for cls in (NodeClaimNotFoundError, NodeClassNotReadyError,
                InsufficientCapacityError):
        if isinstance(exc, cls):
            return cls.__name__
    return ""


class MetricsCloudProvider(CloudProvider):
    """Decorate a CloudProvider with call timing + error counting. Do not
    decorate twice (cloudprovider.go:90-95). Non-SPI attributes (fake
    provider recorders, kwok internals) pass through untouched."""

    def __init__(self, delegate: CloudProvider):
        object.__setattr__(self, "_delegate", delegate)

    def __getattr__(self, item):
        return getattr(self._delegate, item)

    def __setattr__(self, key, value):
        # transparent proxy: fake-provider knobs (NextCreateErr, store=...)
        # set through the decorator land on the delegate
        setattr(self._delegate, key, value)

    @property
    def name(self) -> str:
        return self._delegate.name

    def repair_policies(self):
        return self._delegate.repair_policies()

    def _call(self, method: str, *args):
        labels = {"controller": controller_name(), "method": method,
                  "provider": self._delegate.name}
        done = REGISTRY.measure(METHOD_DURATION.name, labels)
        try:
            return getattr(self._delegate, method)(*args)
        except Exception as exc:
            ERRORS_TOTAL.inc({**labels, "error": _error_label(exc)})
            raise
        finally:
            done()

    def create(self, nodeclaim):
        return self._call("create", nodeclaim)

    def delete(self, nodeclaim):
        return self._call("delete", nodeclaim)

    def get(self, provider_id: str):
        return self._call("get", provider_id)

    def list(self):
        return self._call("list")

    def get_instance_types(self, nodepool):
        return self._call("get_instance_types", nodepool)

    def is_drifted(self, nodeclaim) -> str:
        return self._call("is_drifted", nodeclaim)


def decorate(cloud_provider: CloudProvider) -> MetricsCloudProvider:
    return MetricsCloudProvider(cloud_provider)
