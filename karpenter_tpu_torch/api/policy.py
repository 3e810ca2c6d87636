"""PodDisruptionBudget: the policy/v1 fields the disruption solver consumes
(karpenter's pkg/utils/pdb/pdb.go)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .objects import LabelSelector, ObjectMeta


@dataclass
class PDBSpec:
    selector: Optional[LabelSelector] = None
    min_available: Optional[str] = None    # int ("1") or percent ("50%")
    max_unavailable: Optional[str] = None


@dataclass
class PDBStatus:
    disruptions_allowed: int = 0
    current_healthy: int = 0
    desired_healthy: int = 0
    expected_pods: int = 0


@dataclass
class PodDisruptionBudget:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PDBSpec = field(default_factory=PDBSpec)
    status: PDBStatus = field(default_factory=PDBStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace
