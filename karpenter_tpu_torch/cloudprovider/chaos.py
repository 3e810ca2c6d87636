"""ChaosCloudProvider: seeded fault injection over any CloudProvider.

The decorator twin of metrics.MetricsCloudProvider: wraps a real provider
(kwok's simulated fleet in the soak test) and raises injected transient or
terminal faults at the injector's seeded rate before delegating — the
standalone analog of provider throttling, control-plane brownouts, and
eventual-consistency windows. Faults fire before the delegate call, so the
fleet state is exactly what the failed call left behind (an instance is
never half-created).

Stack order matters: decorate the chaos wrapper WITH the metrics decorator
(metrics outermost) so injected faults are visible in
karpenter_cloudprovider_errors_total like any real provider error.
"""

from __future__ import annotations

from ..utils.chaos import FaultInjector
from .types import CloudProvider


class ChaosCloudProvider(CloudProvider):
    def __init__(self, delegate: CloudProvider, injector: FaultInjector):
        object.__setattr__(self, "_delegate", delegate)
        object.__setattr__(self, "injector", injector)

    def __getattr__(self, item):
        return getattr(self._delegate, item)

    def __setattr__(self, key, value):
        # transparent proxy, like MetricsCloudProvider: knobs set through
        # the wrapper land on the delegate
        setattr(self._delegate, key, value)

    @property
    def name(self) -> str:
        return self._delegate.name

    def repair_policies(self):
        return self._delegate.repair_policies()

    def _gate(self, method: str, name: str = "") -> None:
        self.injector.maybe_raise(f"cloud.{method}", name)

    def exhaust(self, instance_type: str = "*", zone: str = "*",
                capacity_type: str = "*", duration=None, clock=None):
        """Capacity-drought scenario: exhaust matching offerings on the
        delegate (zone-wide with the defaults) for ``duration`` seconds —
        the wrapped provider's creates fail with an offering-keyed
        InsufficientCapacityError until the window lapses, then recover on
        their own. Installs a CapacityDrought on the delegate if one isn't
        wired yet; returns it so scenarios can assert on ``hits``."""
        from ..utils.chaos import CapacityDrought
        drought = getattr(self._delegate, "drought", None)
        if drought is None:
            drought = CapacityDrought(clock=clock)
            self._delegate.drought = drought
        if clock is not None and drought.clock is None:
            drought.clock = clock
        drought.exhaust(instance_type, zone, capacity_type,
                        duration=duration)
        return drought

    def create(self, nodeclaim):
        self._gate("create", nodeclaim.name)
        return self._delegate.create(nodeclaim)

    def delete(self, nodeclaim):
        self._gate("delete", nodeclaim.name)
        return self._delegate.delete(nodeclaim)

    def get(self, provider_id: str):
        self._gate("get", provider_id)
        return self._delegate.get(provider_id)

    def list(self):
        self._gate("list")
        return self._delegate.list()

    def get_instance_types(self, nodepool):
        self._gate("get_instance_types",
                   getattr(nodepool, "name", "") or "")
        return self._delegate.get_instance_types(nodepool)

    def is_drifted(self, nodeclaim) -> str:
        # drift checks stay clean: an injected drift-check fault would only
        # add noise on a path whose failure mode (skip this pass) is already
        # covered by the reconcile-level isolation
        return self._delegate.is_drifted(nodeclaim)
