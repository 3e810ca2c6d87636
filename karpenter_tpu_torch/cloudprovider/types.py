"""CloudProvider SPI: instance-type catalog, offerings, typed errors.

Mirrors karpenter's pkg/cloudprovider/types.go — the provider plug point
(types.go:56-82), InstanceType/Offering shapes (types.go:86-115,227-251), the
list ops OrderByPrice/Compatible/SatisfiesMinValues/Truncate (types.go:117-225),
offering ops (types.go:255-310), and the typed error taxonomy (types.go:313-399).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable, List, Optional

import numpy as np

from ..api import labels as api_labels
from ..scheduling.requirement import IN, Requirement
from ..scheduling.requirements import ALLOW_UNDEFINED_WELL_KNOWN, Requirements
from ..utils import resources as res

MAX_PRICE = math.inf

SPOT_REQUIREMENT = Requirements([
    Requirement(api_labels.CAPACITY_TYPE_LABEL_KEY, IN, [api_labels.CAPACITY_TYPE_SPOT])])
ON_DEMAND_REQUIREMENT = Requirements([
    Requirement(api_labels.CAPACITY_TYPE_LABEL_KEY, IN, [api_labels.CAPACITY_TYPE_ON_DEMAND])])


@dataclass
class Offering:
    """(zone x capacity-type) availability and price; requirements must define
    the capacity-type and zone keys (types.go:244-251)."""
    requirements: Requirements
    price: float
    available: bool = True

    @property
    def zone(self) -> str:
        return next(iter(self.requirements.get(api_labels.LABEL_TOPOLOGY_ZONE).values_list()), "")

    @property
    def capacity_type(self) -> str:
        return next(iter(self.requirements.get(api_labels.CAPACITY_TYPE_LABEL_KEY).values_list()), "")


class Offerings(list):
    def available(self) -> "Offerings":
        return Offerings(o for o in self if o.available)

    def compatible(self, reqs: Requirements) -> "Offerings":
        return Offerings(o for o in self
                         if reqs.is_compatible(o.requirements, ALLOW_UNDEFINED_WELL_KNOWN))

    def has_compatible(self, reqs: Requirements) -> bool:
        return any(reqs.is_compatible(o.requirements, ALLOW_UNDEFINED_WELL_KNOWN) for o in self)

    def cheapest(self) -> "Optional[Offering]":
        """None when empty — reachable once unavailable-offerings masking
        empties a type's offering list; callers treat it as price inf /
        unavailable instead of eating a bare ValueError."""
        return min(self, key=lambda o: o.price, default=None)

    def most_expensive(self) -> "Optional[Offering]":
        return max(self, key=lambda o: o.price, default=None)

    def worst_launch_price(self, reqs: Requirements) -> float:
        """types.go:292-310 — spot preferred, else on-demand, else +inf."""
        if reqs.get(api_labels.CAPACITY_TYPE_LABEL_KEY).has(api_labels.CAPACITY_TYPE_SPOT):
            spot = self.compatible(reqs).compatible(SPOT_REQUIREMENT)
            if spot:
                return spot.most_expensive().price
        if reqs.get(api_labels.CAPACITY_TYPE_LABEL_KEY).has(api_labels.CAPACITY_TYPE_ON_DEMAND):
            od = self.compatible(reqs).compatible(ON_DEMAND_REQUIREMENT)
            if od:
                return od.most_expensive().price
        return MAX_PRICE


class WorstLaunchPrices:
    """``Offerings.worst_launch_price`` of every type of one catalog, one
    [T] vector per distinct set of offerings that a requirement set allows.

    The worst launch price reads only which of a type's available
    offerings the requirements are compatible with, and which of those are
    spot or on-demand. A catalog's offerings carry few distinct requirement
    sets (a zone and a capacity type each), so compatibility is worked out
    once per distinct set, and each vector is the masked maximum of the
    offerings' own prices: the floats the per-type loop returns."""

    def __init__(self, catalog: Iterable[InstanceType]):
        self.catalog = list(catalog)
        index: dict = {}
        self._sets: List[Requirements] = []
        rows, sets, prices = [], [], []
        for t, it in enumerate(self.catalog):
            for o in it.offerings:
                if not o.available:
                    continue
                key = frozenset(o.requirements.values())
                s = index.get(key)
                if s is None:
                    s = index[key] = len(self._sets)
                    self._sets.append(o.requirements)
                rows.append(t)
                sets.append(s)
                prices.append(o.price)
        self._type = np.array(rows, dtype=np.int64)
        self._set = np.array(sets, dtype=np.int64)
        self._price = np.array(prices, dtype=np.float64)
        self._spot = np.array([SPOT_REQUIREMENT.is_compatible(
            r, ALLOW_UNDEFINED_WELL_KNOWN) for r in self._sets], dtype=bool)
        self._on_demand = np.array([ON_DEMAND_REQUIREMENT.is_compatible(
            r, ALLOW_UNDEFINED_WELL_KNOWN) for r in self._sets], dtype=bool)
        self._vectors: dict = {}
        self.built = 0  # vectors built so far

    def vector(self, reqs: Requirements):
        """[T] worst launch prices under ``reqs``, memoized per allowed set."""
        ct = reqs.get(api_labels.CAPACITY_TYPE_LABEL_KEY)
        key = (ct.has(api_labels.CAPACITY_TYPE_SPOT),
               ct.has(api_labels.CAPACITY_TYPE_ON_DEMAND),
               tuple(reqs.is_compatible(r, ALLOW_UNDEFINED_WELL_KNOWN)
                     for r in self._sets))
        out = self._vectors.get(key)
        if out is None:
            out = self._vectors[key] = self._build(*key)
            self.built += 1
        return out

    def _build(self, spot: bool, on_demand: bool, allowed: tuple):
        """Spot preferred, else on-demand, else MAX_PRICE (types.go:292-310)."""
        T = len(self.catalog)
        allowed = np.array(allowed, dtype=bool)
        out = np.full(T, MAX_PRICE, dtype=np.float64)
        done = np.zeros(T, dtype=bool)
        for wanted, kind in ((spot, self._spot), (on_demand, self._on_demand)):
            if not wanted:
                continue
            take = (allowed & kind)[self._set]
            worst = np.full(T, -np.inf, dtype=np.float64)
            np.maximum.at(worst, self._type[take], self._price[take])
            has = np.zeros(T, dtype=bool)
            has[self._type[take]] = True
            fill = has & ~done
            out[fill] = worst[fill]
            done |= has
        return out


def below_worst_launch_price(options: Iterable[InstanceType],
                             reqs: Requirements, max_price: float):
    """The consolidation price filter (nodeclaim.go:136-145): the options,
    in order, whose worst launch price under ``reqs`` is below
    ``max_price``, and the WorstLaunchPrices that priced them."""
    prices = WorstLaunchPrices(options)
    worst = prices.vector(reqs)
    return [it for it, w in zip(prices.catalog, worst) if w < max_price], prices


@dataclass
class InstanceTypeOverhead:
    kube_reserved: dict = field(default_factory=dict)
    system_reserved: dict = field(default_factory=dict)
    eviction_threshold: dict = field(default_factory=dict)

    def total(self) -> dict:
        return res.merge(self.kube_reserved, self.system_reserved, self.eviction_threshold)


@dataclass
class InstanceType:
    name: str
    requirements: Requirements
    offerings: Offerings
    capacity: dict  # ResourceList milliunits
    overhead: InstanceTypeOverhead = field(default_factory=InstanceTypeOverhead)
    _allocatable: Optional[dict] = field(default=None, repr=False)

    def allocatable(self) -> dict:
        """Capacity minus overhead, memoized (types.go:106-115)."""
        if self._allocatable is None:
            self._allocatable = res.subtract(self.capacity, self.overhead.total())
        return self._allocatable


def order_by_price(its: Iterable[InstanceType], reqs: Requirements) -> "list[InstanceType]":
    """types.go:117-134 — cheapest available+compatible offering, name tiebreak."""
    def key(it: InstanceType):
        ofs = it.offerings.available().compatible(reqs)
        return (ofs.cheapest().price if ofs else MAX_PRICE, it.name)
    return sorted(its, key=key)


def compatible_by_offering(its: Iterable[InstanceType], reqs: Requirements) -> "list[InstanceType]":
    return [it for it in its if it.offerings.available().has_compatible(reqs)]


def satisfies_min_values(its: List[InstanceType], reqs: Requirements):
    """Returns (min_needed, err_or_None) — types.go:178-212. Order-dependent."""
    if not reqs.has_min_values():
        return 0, None
    min_values_reqs = [r for r in reqs.values() if r.min_values is not None]
    values_for_key: dict = {r.key: set() for r in min_values_reqs}
    incompatible = ""
    for i, it in enumerate(its):
        for r in min_values_reqs:
            values_for_key[r.key].update(it.requirements.get(r.key).values_list())
        incompatible = next(
            (k for k, v in values_for_key.items() if len(v) < (reqs.get(k).min_values or 0)), "")
        if not incompatible:
            return i + 1, None
    if incompatible:
        return len(its), f'minValues requirement is not met for "{incompatible}"'
    return len(its), None


def truncate(its: List[InstanceType], reqs: Requirements, max_items: int):
    """Returns (truncated, err_or_None) — types.go:216-225."""
    truncated = order_by_price(its, reqs)[:max_items]
    if reqs.has_min_values():
        _, err = satisfies_min_values(truncated, reqs)
        if err is not None:
            return its, f"validating minValues, {err}"
    return truncated, None


def usable_offerings(it: InstanceType, reqs: Requirements,
                     unavailable=None) -> Offerings:
    """Available offerings compatible with reqs, minus any covered by a
    live unavailable-offerings registry entry — the provider-side filter
    the AWS provider applies before CreateFleet so a launch never targets
    an offering its own ICE cache already knows is dry."""
    offs = it.offerings.available().compatible(reqs)
    if unavailable is not None and len(unavailable):
        offs = Offerings(o for o in offs
                         if not unavailable.is_unavailable(
                             it.name, o.zone, o.capacity_type))
    return offs


# --- typed errors (types.go:313-399) --------------------------------------


class CloudProviderError(Exception):
    pass


class NodeClaimNotFoundError(CloudProviderError):
    def __str__(self):
        return f"nodeclaim not found, {super().__str__()}"


class InsufficientCapacityError(CloudProviderError):
    """``offerings`` carries the exhausted offering keys the provider
    attributes the failure to: ``(instance_type, zone, capacity_type)``
    tuples, "*" wildcard per position — a zone-wide drought reports
    ("*", zone, "*"). The nodeclaim-lifecycle ICE path records them into
    the UnavailableOfferings registry so the next solver pass routes
    around them; an empty tuple (legacy/unattributable failures) records
    nothing."""

    def __init__(self, *args, offerings: "tuple | list" = ()):
        super().__init__(*args)
        self.offerings = tuple(offerings)

    def __str__(self):
        return f"insufficient capacity, {super().__str__()}"


class NodeClassNotReadyError(CloudProviderError):
    def __str__(self):
        return f"NodeClassRef not ready, {super().__str__()}"


class CreateError(CloudProviderError):
    def __init__(self, msg: str, condition_message: str = ""):
        super().__init__(msg)
        self.condition_message = condition_message or msg


def ignore_nodeclaim_not_found(exc: "Exception | None"):
    if exc is None or isinstance(exc, NodeClaimNotFoundError):
        return None
    return exc


@dataclass
class RepairPolicy:
    """Node-condition match that marks a node unhealthy (types.go:45-53)."""
    condition_type: str
    condition_status: str
    toleration_duration: float  # seconds


class CloudProvider:
    """The provider SPI (types.go:56-82). Implementations: kwok (in-memory
    simulated fleet) and fake (recording test double)."""

    def create(self, nodeclaim):
        raise NotImplementedError

    def delete(self, nodeclaim):
        raise NotImplementedError

    def get(self, provider_id: str):
        raise NotImplementedError

    def list(self):
        raise NotImplementedError

    def get_instance_types(self, nodepool) -> "list[InstanceType]":
        raise NotImplementedError

    def is_drifted(self, nodeclaim) -> str:
        """Returns a drift reason or empty string."""
        raise NotImplementedError

    def repair_policies(self) -> "list[RepairPolicy]":
        return []

    @property
    def name(self) -> str:
        raise NotImplementedError
