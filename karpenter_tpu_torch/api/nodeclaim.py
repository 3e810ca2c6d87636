"""NodeClaim: a request for exactly one node, plus its status condition machine.

Mirrors karpenter's pkg/apis/v1/nodeclaim.go and nodeclaim_status.go. The
lifecycle controllers drive the condition types through
Launched -> Registered -> Initialized; the disruption marker controllers manage
Consolidatable/Drifted.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..utils.clock import Clock
from .nodepool import NodeClassRef
from .objects import ObjectMeta

# condition transition times stamped WITHOUT an explicit `now` read this
# process-wide clock — injectable (FakeClock) so replays and fake-clock
# tests never leak wall time into transition timestamps. Controllers pass
# now=clock.now() explicitly; this default covers factories and ad-hoc
# setters.
_condition_clock: Clock = Clock()


def set_condition_clock(clock: Clock) -> Clock:
    """Swap the default condition-timestamp clock; returns the previous one
    so tests can restore it."""
    global _condition_clock
    prev = _condition_clock
    _condition_clock = clock
    return prev

# Condition types (nodeclaim_status.go)
COND_LAUNCHED = "Launched"
COND_REGISTERED = "Registered"
COND_INITIALIZED = "Initialized"
COND_CONSOLIDATABLE = "Consolidatable"
COND_DRIFTED = "Drifted"
COND_INSTANCE_TERMINATING = "InstanceTerminating"
COND_READY = "Ready"

LIVE_CONDITIONS = (COND_LAUNCHED, COND_REGISTERED, COND_INITIALIZED)


@dataclass
class Condition:
    type: str
    status: str = "True"  # True | False | Unknown
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0


class ConditionSet:
    """Small status-condition helper mirroring operatorpkg/status semantics."""

    def __init__(self):
        self._conds: dict = {}

    def get(self, cond_type: str) -> Optional[Condition]:
        return self._conds.get(cond_type)

    def is_true(self, cond_type: str) -> bool:
        c = self._conds.get(cond_type)
        return c is not None and c.status == "True"

    def set_true(self, cond_type: str, reason: str = "", message: str = "", now: Optional[float] = None):
        self._set(cond_type, "True", reason, message, now)

    def set_false(self, cond_type: str, reason: str = "", message: str = "", now: Optional[float] = None):
        self._set(cond_type, "False", reason, message, now)

    def set_unknown(self, cond_type: str, reason: str = "", message: str = "", now: Optional[float] = None):
        self._set(cond_type, "Unknown", reason, message, now)

    def clear(self, cond_type: str):
        self._conds.pop(cond_type, None)

    def _set(self, cond_type: str, status: str, reason: str, message: str, now):
        prev = self._conds.get(cond_type)
        changed = prev is None or prev.status != status
        if now is None:
            now = _condition_clock.now()
        self._conds[cond_type] = Condition(
            type=cond_type, status=status, reason=reason, message=message,
            last_transition_time=now if changed
            else prev.last_transition_time)

    def types(self):
        return list(self._conds)


@dataclass
class NodeClaimSpec:
    """nodeclaim.go:27-77."""
    requirements: list = field(default_factory=list)  # NodeSelectorRequirement-like (+ min_values attr)
    resources_requests: dict = field(default_factory=dict)  # ResourceList milliunits
    taints: list = field(default_factory=list)
    startup_taints: list = field(default_factory=list)
    node_class_ref: NodeClassRef = field(default_factory=NodeClassRef)
    expire_after: Optional[float] = None
    termination_grace_period: Optional[float] = None


@dataclass
class NodeClaimStatus:
    provider_id: str = ""
    node_name: str = ""
    image_id: str = ""
    capacity: dict = field(default_factory=dict)
    allocatable: dict = field(default_factory=dict)
    last_pod_event_time: float = 0.0


@dataclass
class NodeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeClaimSpec = field(default_factory=NodeClaimSpec)
    status: NodeClaimStatus = field(default_factory=NodeClaimStatus)
    conditions: ConditionSet = field(default_factory=ConditionSet)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def uid(self) -> str:
        return self.metadata.uid

    @property
    def nodepool_name(self) -> str:
        from . import labels as api_labels
        return self.metadata.labels.get(api_labels.NODEPOOL_LABEL_KEY, "")

    def initialized(self) -> bool:
        return self.conditions.is_true(COND_INITIALIZED)

    def registered(self) -> bool:
        return self.conditions.is_true(COND_REGISTERED)

    def launched(self) -> bool:
        return self.conditions.is_true(COND_LAUNCHED)
