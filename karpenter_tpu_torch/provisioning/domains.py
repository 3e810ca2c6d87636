"""Topology-domain universe construction.

Mirrors karpenter's pkg/controllers/provisioning/provisioner.go:236-283:
per nodepool, intersect instance-type requirements with the pool's template
requirements so e.g. zones offered by an instance type but excluded by the pool
don't expand the universe; pool-level In requirements also contribute.
"""

from __future__ import annotations

from typing import Dict, List, Set

from ..api.nodepool import NodePool
from ..cloudprovider.types import InstanceType
from ..scheduling.requirement import IN
from ..scheduling.requirements import (Requirements, label_requirements,
                                       node_selector_requirements)


def build_topology_domains(nodepools: List[NodePool],
                           instance_types: Dict[str, List[InstanceType]]) -> Dict[str, Set[str]]:
    domains: Dict[str, Set[str]] = {}
    for np in nodepools:
        pool_reqs_base = node_selector_requirements(np.spec.template.spec.requirements)
        pool_reqs_base.add(*label_requirements(np.spec.template.metadata_labels).values())
        for it in instance_types.get(np.name, []):
            reqs = Requirements(pool_reqs_base.values())
            reqs.add(*it.requirements.values())
            for key in reqs:
                domains.setdefault(key, set()).update(reqs.get(key).values_list())
        for key in pool_reqs_base:
            if pool_reqs_base.get(key).operator() == IN:
                domains.setdefault(key, set()).update(pool_reqs_base.get(key).values_list())
    return domains
