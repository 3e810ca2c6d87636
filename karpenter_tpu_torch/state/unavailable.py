"""TTL'd unavailable-offerings registry: the capacity-failure feedback loop.

The reference's typed error taxonomy (types.go:313-399) exists so capacity
failures can change future decisions, and the solvers already consume an
``off_available`` tensor (ops/binpack.py, ops/feasibility.py) — this module
is the piece that flips it. Adapted from the AWS provider's
InsufficientCapacityError cache (aws/pkg/cache/unavailableofferings.go):
launch failures mark ``(instance_type, zone, capacity_type)`` keys —
wildcard forms included, so a zone-wide drought is ONE entry, not one per
type — and every solver pass masks live entries out of its offering
tensors, so the very next pass routes pods to surviving offerings instead
of hot-looping on the dry one.

Deviations from the AWS cache (DEVIATIONS.md):

- escalating TTL: repeated exhaustion of the SAME key within the strike
  window doubles the TTL (capped) instead of the AWS flat 3 minutes — a
  zone that keeps running dry backs off harder;
- the registry is karpenter-side (one instance shared by the lifecycle
  controller, both solvers, and the simulated providers) rather than
  buried in one provider implementation.

Clock-injected and lock-free mutation-wise (single-threaded manager owns
all writers; readers tolerate a stale view for one pass).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..utils.clock import Clock

WILDCARD = "*"

# base TTL matches the AWS provider's UnavailableOfferingsTTL (3 minutes);
# escalation doubles per repeated strike up to the cap
UNAVAILABLE_TTL_SECONDS = 3 * 60.0
UNAVAILABLE_TTL_CAP_SECONDS = 30 * 60.0
TTL_ESCALATION_FACTOR = 2.0

OfferingKey = Tuple[str, str, str]  # (instance_type, zone, capacity_type)


@dataclass
class _Entry:
    expires_at: float
    ttl: float
    reason: str
    strikes: int
    marked_at: float


class UnavailableOfferings:
    """Clock-injected TTL cache of offering keys known to be dry.

    ``version`` bumps on every state change (mark, expiry) — consumers use
    it as a cheap change signal: the provisioner's exhausted-pod hold
    releases on a bump, and the tensor scheduler keys its device-resident
    masked-offering cache on the live pattern set.
    """

    def __init__(self, clock: Optional[Clock] = None,
                 ttl: float = UNAVAILABLE_TTL_SECONDS,
                 escalation: float = TTL_ESCALATION_FACTOR,
                 max_ttl: float = UNAVAILABLE_TTL_CAP_SECONDS):
        self.clock = clock or Clock()
        self.ttl = ttl
        self.escalation = escalation
        self.max_ttl = max_ttl
        self.version = 0
        self._entries: Dict[OfferingKey, _Entry] = {}
        # strike memory outlives the entries: a key that expires and is
        # re-marked within the strike window escalates instead of starting
        # over (the drought didn't end, the TTL just guessed short).
        # Keyed as (strikes, expires_at-of-last-entry): the clearance test
        # must measure time the key STAYED CLEAR (past expiry), not time
        # since the last mark — re-probes only happen after expiry, so an
        # inter-MARK gap approximates the previous TTL and a since-mark
        # window would reset the escalation exactly when it hits the cap.
        self._strikes: Dict[OfferingKey, Tuple[int, float]] = {}

    # -- writers ------------------------------------------------------------

    def mark(self, instance_type: str = WILDCARD, zone: str = WILDCARD,
             capacity_type: str = WILDCARD,
             reason: str = "insufficient_capacity") -> float:
        """Record a key as unavailable; returns the TTL applied (escalating
        on repeated exhaustion of the same key, capped at max_ttl)."""
        now = self.clock.now()
        key = (instance_type or WILDCARD, zone or WILDCARD,
               capacity_type or WILDCARD)
        from ..metrics import registry as metrics
        strikes, prev_expiry = self._strikes.get(key, (0, -float("inf")))
        entry = self._entries.get(key)
        if entry is not None and entry.expires_at > now:
            # re-mark while the entry is LIVE (several in-flight claims
            # failing on the same drought in one episode): more failures
            # are not re-probe evidence, so refresh the window at the
            # current TTL instead of escalating — escalation is reserved
            # for a failed re-probe AFTER expiry (the AWS cache refreshes
            # the same way)
            entry.expires_at = now + entry.ttl
            entry.marked_at = now
            entry.reason = reason
            self._strikes[key] = (strikes, entry.expires_at)
            self.version += 1
            metrics.OFFERINGS_MARKED.inc({"reason": reason})
            self._publish_gauge()
            return entry.ttl
        if now - prev_expiry > self.max_ttl:
            strikes = 0  # stayed clear past the cap after expiry: over
        ttl = min(self.ttl * (self.escalation ** strikes), self.max_ttl)
        self._strikes[key] = (strikes + 1, now + ttl)
        self._entries[key] = _Entry(expires_at=now + ttl, ttl=ttl,
                                    reason=reason, strikes=strikes + 1,
                                    marked_at=now)
        self.version += 1
        metrics.OFFERINGS_MARKED.inc({"reason": reason})
        self._publish_gauge()
        return ttl

    def expire(self) -> List[OfferingKey]:
        """Prune expired entries; returns the keys that just expired so the
        caller (the provisioner pass) can react to capacity recovery."""
        now = self.clock.now()
        expired = [k for k, e in self._entries.items() if e.expires_at <= now]
        for k in expired:
            del self._entries[k]
        if expired:
            self.version += 1
            self._publish_gauge()
        return expired

    # -- readers ------------------------------------------------------------

    def live(self) -> Tuple[OfferingKey, ...]:
        """Sorted live keys (pruned). Stable across escalation re-marks of
        the same keys, so it doubles as the mask-content cache key."""
        self.expire()
        return tuple(sorted(self._entries))

    def __len__(self) -> int:
        now = self.clock.now()
        return sum(1 for e in self._entries.values() if e.expires_at > now)

    def is_unavailable(self, instance_type: str, zone: str,
                       capacity_type: str) -> bool:
        """Does any live entry — exact or wildcard — cover this offering?"""
        if not self._entries:
            return False
        now = self.clock.now()
        for it_k in (instance_type, WILDCARD):
            for z_k in (zone, WILDCARD):
                for ct_k in (capacity_type, WILDCARD):
                    e = self._entries.get((it_k, z_k, ct_k))
                    if e is not None and e.expires_at > now:
                        return True
        return False

    def next_expiry(self) -> Optional[float]:
        now = self.clock.now()
        times = [e.expires_at for e in self._entries.values()
                 if e.expires_at > now]
        return min(times) if times else None

    def snapshot(self) -> List[dict]:
        """Live entries for the /debug/offerings operator surface. Served
        from HTTP handler threads while the operator thread marks/expires:
        copy first with a retry — CPython dict iteration under concurrent
        mutation raises rather than going stale (same hazard and remedy as
        the flightrec materialize path)."""
        now = self.clock.now()
        for attempt in range(3):
            try:
                items = sorted(self._entries.items())
                break
            except RuntimeError:
                if attempt == 2:
                    raise
        out = []
        for (it, z, ct), e in items:
            if e.expires_at <= now:
                continue
            out.append({"instance_type": it, "zone": z, "capacity_type": ct,
                        "reason": e.reason, "ttl": e.ttl,
                        "strikes": e.strikes,
                        "expires_in": e.expires_at - now})
        return out

    # -- internal -----------------------------------------------------------

    def _publish_gauge(self) -> None:
        from ..metrics import registry as metrics
        metrics.OFFERINGS_UNAVAILABLE.set(float(len(self)))


def mask_instance_types_for(its, patterns) -> list:
    """Object-level mask against an EXPLICIT pattern set (no clock reads):
    offerings covered by a pattern become available=False COPIES
    (provider-owned catalog objects are never mutated); untouched instance
    types pass through as-is, so an empty pattern set is a no-op returning
    the original list. Pure on purpose — the host-oracle fallback and the
    flight recorder pin the patterns THEIR solve used, so a TTL lapsing
    mid-capture can't shift the mask under them."""
    from ..cloudprovider.types import Offering, Offerings
    if not patterns:
        return its
    pats = tuple(patterns)

    def covered(name: str, zone: str, capacity_type: str) -> bool:
        for pit, pz, pct in pats:
            if pit in (WILDCARD, name) and pz in (WILDCARD, zone) \
                    and pct in (WILDCARD, capacity_type):
                return True
        return False

    out = []
    for it in its:
        masked = None
        for i, o in enumerate(it.offerings):
            if o.available and covered(it.name, o.zone, o.capacity_type):
                if masked is None:
                    masked = list(it.offerings)
                masked[i] = Offering(requirements=o.requirements,
                                     price=o.price, available=False)
        out.append(dataclasses.replace(it, offerings=Offerings(masked))
                   if masked is not None else it)
    return out


def mask_catalog(instance_types: dict, patterns) -> dict:
    """mask_instance_types_for over a per-nodepool catalog dict — THE
    shape the host-oracle fallback and the flight recorder's captured
    catalogs share, so a future change to catalog-mask semantics lands in
    every consumer at once. No-op (same dict back) for empty patterns."""
    if not patterns:
        return instance_types
    return {name: mask_instance_types_for(its, patterns)
            for name, its in instance_types.items()}
