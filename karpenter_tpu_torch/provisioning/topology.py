"""Topology tracking: spread constraints, pod (anti-)affinity, inverse anti-affinity.

Host-side oracle implementation with the semantics of
karpenter's pkg/controllers/provisioning/scheduling/{topology,topologygroup,
topologynodefilter}.go. The TPU solver (karpenter_tpu.ops.topology) reproduces
the domain-count arithmetic as dense tensors; this module is the general path
and the conformance reference.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Set

from ..api import labels as api_labels
from ..api.objects import Pod, PodAffinityTerm, TopologySpreadConstraint
from ..scheduling.requirement import (DOES_NOT_EXIST, EXISTS, IN, Requirement)
from ..scheduling.requirements import (Requirements, label_requirements,
                                       node_selector_requirements)

MAX_INT32 = 2**31 - 1

SPREAD = "spread"
POD_AFFINITY = "pod-affinity"
POD_ANTI_AFFINITY = "pod-anti-affinity"


class TopologyNodeFilter:
    """OR of requirement sets limiting which nodes count for a spread
    (topologynodefilter.go:33-73). Empty filter matches everything."""

    def __init__(self, requirement_sets: List[Requirements]):
        self.requirement_sets = requirement_sets

    @classmethod
    def for_pod(cls, pod: Pod) -> "TopologyNodeFilter":
        selector_reqs = label_requirements(pod.spec.node_selector)
        aff = pod.spec.affinity
        if aff is None or aff.node_affinity is None or not aff.node_affinity.required_terms:
            return cls([selector_reqs])
        sets_ = []
        for term in aff.node_affinity.required_terms:
            reqs = Requirements()
            reqs.add(*selector_reqs.values())
            reqs.add(*node_selector_requirements(term.match_expressions).values())
            sets_.append(reqs)
        return cls(sets_)

    def matches_requirements(self, requirements: Requirements,
                             allow_undefined: frozenset = frozenset()) -> bool:
        if not self.requirement_sets:
            return True
        return any(not requirements.compatible(r, allow_undefined)
                   for r in self.requirement_sets)

    def matches_labels(self, labels: dict) -> bool:
        return self.matches_requirements(label_requirements(labels))

    def signature(self):
        out = []
        for reqs in self.requirement_sets:
            out.append(tuple(sorted((k, reqs.get(k).complement,
                                     frozenset(reqs.get(k).values),
                                     reqs.get(k).greater_than, reqs.get(k).less_than)
                                    for k in reqs)))
        return frozenset(out)


class TopologyGroup:
    """Domain->count tracking per constraint (topologygroup.go:56-175)."""

    def __init__(self, topo_type: str, key: str, pod: Pod, namespaces: Set[str],
                 selector, max_skew: int, min_domains: Optional[int],
                 domains: Iterable[str]):
        self.type = topo_type
        self.key = key
        self.namespaces = set(namespaces)
        self.selector = selector  # LabelSelector or None (None selects nothing)
        self.node_filter = (TopologyNodeFilter.for_pod(pod)
                            if topo_type == SPREAD else TopologyNodeFilter([]))
        self.max_skew = max_skew
        self.min_domains = min_domains
        self.domains: Dict[str, int] = {d: 0 for d in domains}
        self.empty_domains: Set[str] = set(domains)
        # occupied-domain index: hostname groups accumulate thousands of
        # placeholder domains (one per in-flight claim), while the occupied
        # set stays tiny — affinity selection must not scan the whole space
        self.nonempty: Set[str] = set()
        self.owners: Set[str] = set()

    # identity hash so one group tracks many same-shaped pods (topologygroup.go:159-175)
    def signature(self):
        sel_sig = None
        if self.selector is not None:
            sel_sig = (self.selector.match_labels, frozenset(self.selector.match_expressions))
        return (self.type, self.key, frozenset(self.namespaces), sel_sig,
                self.max_skew, self.node_filter.signature())

    def selects(self, pod: Pod) -> bool:
        return pod.namespace in self.namespaces and \
            self.selector is not None and self.selector.matches(pod.labels)

    def counts(self, pod: Pod, requirements: Requirements,
               allow_undefined: frozenset = frozenset()) -> bool:
        return self.selects(pod) and \
            self.node_filter.matches_requirements(requirements, allow_undefined)

    def record(self, *domains: str) -> None:
        for d in domains:
            self.domains[d] = self.domains.get(d, 0) + 1
            self.empty_domains.discard(d)
            self.nonempty.add(d)

    def register(self, *domains: str) -> None:
        for d in domains:
            if d not in self.domains:
                self.domains[d] = 0
                self.empty_domains.add(d)

    def unregister(self, *domains: str) -> None:
        for d in domains:
            self.domains.pop(d, None)
            self.empty_domains.discard(d)
            self.nonempty.discard(d)

    def get(self, pod: Pod, pod_domains: Requirement, node_domains: Requirement) -> Requirement:
        if self.type == SPREAD:
            return self._next_domain_spread(pod, pod_domains, node_domains)
        if self.type == POD_AFFINITY:
            return self._next_domain_affinity(pod, pod_domains, node_domains)
        return self._next_domain_anti_affinity(pod_domains, node_domains)

    # --- selection rules ---------------------------------------------------

    def _domain_min_count(self, domains: Requirement) -> int:
        """topologygroup.go:229-250 — hostname topologies floor at 0 because a
        new node can always be created."""
        if self.key == api_labels.LABEL_HOSTNAME:
            return 0
        lo = MAX_INT32
        supported = 0
        for domain, count in self.domains.items():
            if domains.has(domain):
                supported += 1
                if count < lo:
                    lo = count
        if self.min_domains is not None and supported < self.min_domains:
            lo = 0
        return lo

    def _next_domain_spread(self, pod: Pod, pod_domains: Requirement,
                            node_domains: Requirement) -> Requirement:
        """Min-count domain within maxSkew of the global min (topologygroup.go:181-227).
        Deterministic tie-break on domain name keeps solves reproducible."""
        global_min = self._domain_min_count(pod_domains)
        self_selecting = self.selects(pod)
        best_domain = ""
        best_count = MAX_INT32
        if node_domains.operator() == IN:
            candidates = [d for d in node_domains.values_list() if d in self.domains]
        else:
            candidates = [d for d in self.domains if node_domains.has(d)]
        for domain in sorted(candidates):
            count = self.domains[domain]
            if self_selecting:
                count += 1
            if count - global_min <= self.max_skew and count < best_count:
                best_domain = domain
                best_count = count
        if not best_domain:
            return Requirement(pod_domains.key, DOES_NOT_EXIST)
        return Requirement(pod_domains.key, IN, [best_domain])

    def _any_compatible_pod_domain(self, pod_domains: Requirement) -> bool:
        return any(pod_domains.has(d) for d in self.nonempty)

    def _next_domain_affinity(self, pod: Pod, pod_domains: Requirement,
                              node_domains: Requirement) -> Requirement:
        """topologygroup.go:253-300."""
        options = Requirement(pod_domains.key, DOES_NOT_EXIST)
        if node_domains.operator() == IN and \
                node_domains.length() < len(self.nonempty):
            for d in node_domains.values_list():
                if d in self.nonempty and pod_domains.has(d):
                    options.insert(d)
        else:
            for d in self.nonempty:
                if pod_domains.has(d) and node_domains.has(d):
                    options.insert(d)
        if options.length() != 0:
            return options
        # bootstrap: self-selecting pod with no (compatible) scheduled pods yet
        if self.selects(pod) and (len(self.domains) == len(self.empty_domains)
                                  or not self._any_compatible_pod_domain(pod_domains)):
            intersected = pod_domains.intersection(node_domains)
            for d in sorted(self.domains):
                if intersected.has(d):
                    options.insert(d)
                    break
            for d in sorted(self.domains):
                if pod_domains.has(d):
                    options.insert(d)
                    break
        return options

    def _next_domain_anti_affinity(self, pod_domains: Requirement,
                                   node_domains: Requirement) -> Requirement:
        """Empty domains only (topologygroup.go:316-342)."""
        options = Requirement(pod_domains.key, DOES_NOT_EXIST)
        if node_domains.operator() == IN and node_domains.length() < len(self.empty_domains):
            for d in node_domains.values_list():
                if d in self.empty_domains and pod_domains.has(d):
                    options.insert(d)
        else:
            for d in self.empty_domains:
                if node_domains.has(d) and pod_domains.has(d):
                    options.insert(d)
        return options


def has_pod_anti_affinity(pod: Pod) -> bool:
    aff = pod.spec.affinity
    return aff is not None and aff.pod_anti_affinity is not None and \
        (len(aff.pod_anti_affinity.required) > 0 or len(aff.pod_anti_affinity.preferred) > 0)


def ignored_for_topology(pod: Pod) -> bool:
    """topology.go:449-451 — unscheduled/terminal/terminating pods don't count."""
    return (not pod.spec.node_name or pod.status.phase in ("Succeeded", "Failed")
            or pod.metadata.deletion_timestamp is not None)


class ClusterView:
    """Minimal view of the live cluster the topology needs: scheduled pods and
    node labels. Backed by state.Cluster in the full runtime; tests can stub it."""

    def list_pods(self, namespace: str, selector) -> List[Pod]:
        return []

    def node_labels(self, node_name: str) -> Optional[dict]:
        return None

    def for_pods_with_anti_affinity(self) -> Iterable:
        """Yields (pod, node_labels) pairs."""
        return []


class Topology:
    """topology.go:41-409."""

    def __init__(self, cluster: ClusterView, domains: Dict[str, Set[str]],
                 pods: List[Pod]):
        self.cluster = cluster
        self.domains = domains
        self.topologies: Dict = {}           # signature -> TopologyGroup
        self.inverse_topologies: Dict = {}   # signature -> TopologyGroup
        self.excluded_pods: Set[str] = {p.uid for p in pods}
        self._update_inverse_affinities()
        for p in pods:
            self.update(p)

    def update(self, pod: Pod) -> None:
        """Re-register the pod as owner of its current constraint set; called
        after preference relaxation (topology.go:99-134)."""
        for tg in self.topologies.values():
            tg.owners.discard(pod.uid)
        if has_pod_anti_affinity(pod):
            self._update_inverse_anti_affinity(pod, None)
        groups = self._new_for_topologies(pod) + self._new_for_affinities(pod)
        for tg in groups:
            sig = tg.signature()
            existing = self.topologies.get(sig)
            if existing is None:
                self._count_domains(tg)
                self.topologies[sig] = tg
            else:
                tg = existing
            tg.owners.add(pod.uid)

    def record(self, pod: Pod, requirements: Requirements,
               allow_undefined: frozenset = frozenset()) -> None:
        """topology.go:137-160."""
        for tg in self.topologies.values():
            if tg.counts(pod, requirements, allow_undefined):
                domains = requirements.get(tg.key)
                if tg.type == POD_ANTI_AFFINITY:
                    tg.record(*domains.values_list())
                elif domains.length() == 1:
                    tg.record(domains.values_list()[0])
        for tg in self.inverse_topologies.values():
            if pod.uid in tg.owners:
                tg.record(*requirements.get(tg.key).values_list())

    def add_requirements(self, pod_requirements: Requirements,
                         node_requirements: Requirements, pod: Pod,
                         allow_undefined: frozenset = frozenset()):
        """Tighten node requirements with topology domain selections; returns
        (Requirements, None) or (None, error) (topology.go:166-188). Sets
        `self.last_add_tightened` (valid until the next call — the solve is
        single-threaded) so callers can tell whether any topology group
        actually constrained this pod: a non-tightening result depends only
        on the inputs, which backs the claims' compat cache."""
        requirements = Requirements(node_requirements.values())
        self.last_add_tightened = False
        for tg in self._matching_topologies(pod, node_requirements, allow_undefined):
            pod_domains = pod_requirements.get(tg.key)
            node_domains = node_requirements.get(tg.key)
            domains = tg.get(pod, pod_domains, node_domains)
            if domains.length() == 0:
                return None, (f"unsatisfiable topology constraint for {tg.type}, "
                              f"key={tg.key}")
            requirements.add(domains)
            self.last_add_tightened = True
        return requirements, None

    def register(self, topology_key: str, domain: str) -> None:
        for tg in self.topologies.values():
            if tg.key == topology_key:
                tg.register(domain)
        for tg in self.inverse_topologies.values():
            if tg.key == topology_key:
                tg.register(domain)

    def unregister(self, topology_key: str, domain: str) -> None:
        for tg in self.topologies.values():
            if tg.key == topology_key:
                tg.unregister(domain)
        for tg in self.inverse_topologies.values():
            if tg.key == topology_key:
                tg.unregister(domain)

    # --- construction ------------------------------------------------------

    def _new_for_topologies(self, pod: Pod) -> List[TopologyGroup]:
        out = []
        for cs in pod.spec.topology_spread_constraints:
            out.append(TopologyGroup(
                SPREAD, cs.topology_key, pod, {pod.namespace}, cs.label_selector,
                cs.max_skew, cs.min_domains, self.domains.get(cs.topology_key, set())))
        return out

    def _new_for_affinities(self, pod: Pod) -> List[TopologyGroup]:
        out = []
        aff = pod.spec.affinity
        if aff is None:
            return out
        terms: List = []
        if aff.pod_affinity is not None:
            terms += [(POD_AFFINITY, t) for t in aff.pod_affinity.required]
            terms += [(POD_AFFINITY, wt.term) for wt in aff.pod_affinity.preferred]
        if aff.pod_anti_affinity is not None:
            terms += [(POD_ANTI_AFFINITY, t) for t in aff.pod_anti_affinity.required]
            terms += [(POD_ANTI_AFFINITY, wt.term) for wt in aff.pod_anti_affinity.preferred]
        for topo_type, term in terms:
            namespaces = set(term.namespaces) or {pod.namespace}
            out.append(TopologyGroup(
                topo_type, term.topology_key, pod, namespaces, term.label_selector,
                MAX_INT32, None, self.domains.get(term.topology_key, set())))
        return out

    def _update_inverse_affinities(self) -> None:
        for pod, node_labels in self.cluster.for_pods_with_anti_affinity():
            if pod.uid in self.excluded_pods:
                continue
            self._update_inverse_anti_affinity(pod, node_labels)

    def _update_inverse_anti_affinity(self, pod: Pod, node_labels: Optional[dict]) -> None:
        """Required anti-affinity terms only (topology.go:237-262)."""
        aff = pod.spec.affinity
        for term in aff.pod_anti_affinity.required:
            namespaces = set(term.namespaces) or {pod.namespace}
            tg = TopologyGroup(POD_ANTI_AFFINITY, term.topology_key, pod, namespaces,
                               term.label_selector, MAX_INT32, None,
                               self.domains.get(term.topology_key, set()))
            sig = tg.signature()
            existing = self.inverse_topologies.get(sig)
            if existing is None:
                self.inverse_topologies[sig] = tg
            else:
                tg = existing
            if node_labels is not None and tg.key in node_labels:
                tg.record(node_labels[tg.key])
            tg.owners.add(pod.uid)

    def _count_domains(self, tg: TopologyGroup) -> None:
        """Initial scan of scheduled cluster pods (topology.go:268-321)."""
        for ns in tg.namespaces:
            for p in self.cluster.list_pods(ns, tg.selector):
                if ignored_for_topology(p) or p.uid in self.excluded_pods:
                    continue
                labels = self.cluster.node_labels(p.spec.node_name)
                if labels is None:
                    continue
                domain = labels.get(tg.key)
                if domain is None and tg.key == api_labels.LABEL_HOSTNAME:
                    domain = p.spec.node_name
                if domain is None:
                    continue
                if not tg.node_filter.matches_labels(labels):
                    continue
                tg.record(domain)

    def _matching_topologies(self, pod: Pod, requirements: Requirements,
                             allow_undefined: frozenset):
        out = [tg for tg in self.topologies.values() if pod.uid in tg.owners]
        out += [tg for tg in self.inverse_topologies.values()
                if tg.counts(pod, requirements, allow_undefined)]
        return out
