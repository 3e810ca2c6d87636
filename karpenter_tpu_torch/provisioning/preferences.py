"""Preference relaxation ladder.

Mirrors karpenter's pkg/controllers/provisioning/scheduling/preferences.go:38-57:
drop one rung per failed attempt, in order: required node-affinity term (when >1,
OR semantics) -> heaviest preferred pod-affinity -> heaviest preferred pod-anti-
affinity -> heaviest preferred node-affinity -> a ScheduleAnyway spread ->
tolerate PreferNoSchedule taints (only when some pool carries such a taint).
"""

from __future__ import annotations

from typing import Optional

from ..api.objects import (Affinity, NodeAffinity, PREFER_NO_SCHEDULE,
                           Pod, PodAffinity, SCHEDULE_ANYWAY, Toleration)


def _own_spec_containers(pod: Pod) -> None:
    """Give the pod its own PodSpec with its own mutable constraint
    containers before relaxing.

    Pods stamped from one deployment (and pods rebuilt from the sidecar
    wire, codec) can share their Affinity / spread-constraint objects — or
    their entire PodSpec; the relaxation ladder pops terms in place, so
    without this, relaxing one pod would strip constraints from every
    sibling. Term objects themselves are frozen dataclasses, so cloning the
    spec plus its mutable containers is a full copy; read-only sub-objects
    (node_selector, host_ports, volumes) stay shared.
    """
    import dataclasses
    spec = pod.spec
    if getattr(spec, "_owned_by", None) is pod:
        return
    aff = spec.affinity
    if aff is not None:
        aff = Affinity(
            node_affinity=(None if aff.node_affinity is None else NodeAffinity(
                required_terms=list(aff.node_affinity.required_terms),
                preferred=list(aff.node_affinity.preferred))),
            pod_affinity=(None if aff.pod_affinity is None else PodAffinity(
                required=list(aff.pod_affinity.required),
                preferred=list(aff.pod_affinity.preferred))),
            pod_anti_affinity=(None if aff.pod_anti_affinity is None
                               else PodAffinity(
                required=list(aff.pod_anti_affinity.required),
                preferred=list(aff.pod_anti_affinity.preferred))))
    pod.spec = dataclasses.replace(
        spec, affinity=aff,
        topology_spread_constraints=list(spec.topology_spread_constraints),
        tolerations=list(spec.tolerations))
    pod.spec._owned_by = pod


class Preferences:
    def __init__(self, tolerate_prefer_no_schedule: bool = False):
        self.tolerate_prefer_no_schedule = tolerate_prefer_no_schedule

    def relax(self, pod: Pod) -> bool:
        _own_spec_containers(pod)
        relaxations = [
            self._remove_required_node_affinity_term,
            self._remove_preferred_pod_affinity_term,
            self._remove_preferred_pod_anti_affinity_term,
            self._remove_preferred_node_affinity_term,
            self._remove_schedule_anyway_spread,
        ]
        if self.tolerate_prefer_no_schedule:
            relaxations.append(self._tolerate_prefer_no_schedule_taints)
        for fn in relaxations:
            if fn(pod) is not None:
                return True
        return False

    def _remove_required_node_affinity_term(self, pod: Pod) -> Optional[str]:
        aff = pod.spec.affinity
        if aff is None or aff.node_affinity is None or len(aff.node_affinity.required_terms) <= 1:
            return None
        removed = aff.node_affinity.required_terms.pop(0)
        return f"removed required node affinity term {removed}"

    def _remove_preferred_node_affinity_term(self, pod: Pod) -> Optional[str]:
        aff = pod.spec.affinity
        if aff is None or aff.node_affinity is None or not aff.node_affinity.preferred:
            return None
        aff.node_affinity.preferred.sort(key=lambda t: -t.weight)
        removed = aff.node_affinity.preferred.pop(0)
        return f"removed preferred node affinity term {removed}"

    def _remove_preferred_pod_affinity_term(self, pod: Pod) -> Optional[str]:
        aff = pod.spec.affinity
        if aff is None or aff.pod_affinity is None or not aff.pod_affinity.preferred:
            return None
        aff.pod_affinity.preferred.sort(key=lambda t: -t.weight)
        removed = aff.pod_affinity.preferred.pop(0)
        return f"removed preferred pod affinity term {removed}"

    def _remove_preferred_pod_anti_affinity_term(self, pod: Pod) -> Optional[str]:
        aff = pod.spec.affinity
        if aff is None or aff.pod_anti_affinity is None or not aff.pod_anti_affinity.preferred:
            return None
        aff.pod_anti_affinity.preferred.sort(key=lambda t: -t.weight)
        removed = aff.pod_anti_affinity.preferred.pop(0)
        return f"removed preferred pod anti-affinity term {removed}"

    def _remove_schedule_anyway_spread(self, pod: Pod) -> Optional[str]:
        for i, tsc in enumerate(pod.spec.topology_spread_constraints):
            if tsc.when_unsatisfiable == SCHEDULE_ANYWAY:
                pod.spec.topology_spread_constraints.pop(i)
                return f"removed ScheduleAnyway spread on {tsc.topology_key}"
        return None

    def _tolerate_prefer_no_schedule_taints(self, pod: Pod) -> Optional[str]:
        tol = Toleration(operator="Exists", effect=PREFER_NO_SCHEDULE)
        if tol in pod.spec.tolerations:
            return None
        pod.spec.tolerations = list(pod.spec.tolerations) + [tol]
        return "added toleration for PreferNoSchedule taints"
