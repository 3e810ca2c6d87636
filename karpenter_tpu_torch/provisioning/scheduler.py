"""Provisioning scheduler: greedy first-fit-decreasing with relaxation.

Host-side oracle with the semantics of
karpenter's pkg/controllers/provisioning/scheduling/{scheduler,nodeclaim,
existingnode,nodeclaimtemplate,queue}.go. The TPU accelerated path
(karpenter_tpu.ops.binpack) reproduces this solver's decisions on dense
tensors; Scheduler is the entry point either way — it picks the accelerated
kernel when the batch is expressible there and falls back to this loop
otherwise, so behavior is always defined by these semantics.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..api import labels as api_labels
from ..api.nodeclaim import NodeClaim as APINodeClaim, NodeClaimSpec
from ..api.nodepool import NODEPOOL_HASH_VERSION, NodePool
from ..api.objects import ObjectMeta, OwnerReference, Pod, Taint
from ..cloudprovider.types import (InstanceType, below_worst_launch_price,
                                   satisfies_min_values, truncate)
from ..scheduling import taints as scheduling_taints
from ..scheduling.hostports import HostPortUsage, get_host_ports
from ..scheduling.requirement import IN, Requirement
from ..scheduling.requirements import (ALLOW_UNDEFINED_WELL_KNOWN, Requirements,
                                       has_preferred_node_affinity, label_requirements,
                                       node_selector_requirements, pod_requirements,
                                       strict_pod_requirements)
from ..utils import resources as res
from .preferences import Preferences
from .topology import Topology

MAX_INSTANCE_TYPES = 60  # nodeclaimtemplate.go:35

_hostname_seq = itertools.count(1)
# ONE claim-name counter for every solver path (host oracle, tensor,
# sidecar decode): independent counters minted colliding names — two paths
# both producing "default-00342" in one process is a store ConflictError
claim_name_seq = itertools.count(1)


class NodeClaimTemplate:
    """NodePool -> launchable template with precomputed requirements
    (nodeclaimtemplate.go:42-68)."""

    def __init__(self, nodepool: NodePool):
        self.nodepool_name = nodepool.name
        self.nodepool_uid = nodepool.metadata.uid
        spec = nodepool.spec.template.spec
        self.taints: List[Taint] = list(spec.taints)
        self.startup_taints: List[Taint] = list(spec.startup_taints)
        self.expire_after = spec.expire_after
        self.termination_grace_period = spec.termination_grace_period
        self.node_class_ref = spec.node_class_ref
        self.labels = dict(nodepool.spec.template.metadata_labels)
        self.labels[api_labels.NODEPOOL_LABEL_KEY] = nodepool.name
        self.annotations = dict(nodepool.spec.template.metadata_annotations)
        self.annotations[api_labels.NODEPOOL_HASH_ANNOTATION_KEY] = nodepool.static_hash()
        self.annotations[api_labels.NODEPOOL_HASH_VERSION_ANNOTATION_KEY] = NODEPOOL_HASH_VERSION
        self.requirements = Requirements()
        self.requirements.add(*node_selector_requirements(spec.requirements).values())
        self.requirements.add(*label_requirements(self.labels).values())
        self.instance_type_options: List[InstanceType] = []


class InFlightNodeClaim:
    """A node being packed (scheduling/nodeclaim.go:35-122). Keeps the full set
    of instance types that could satisfy the accumulated pods."""

    def __init__(self, template: NodeClaimTemplate, topology: Topology,
                 daemon_resources: dict, instance_types: List[InstanceType]):
        self.template = template
        self.hostname = f"hostname-placeholder-{next(_hostname_seq):05d}"
        topology.register(api_labels.LABEL_HOSTNAME, self.hostname)
        self.requirements = Requirements(template.requirements.values())
        self.requirements.add(Requirement(api_labels.LABEL_HOSTNAME, IN, [self.hostname]))
        self.instance_type_options = list(instance_types)
        self.daemon_resources = dict(daemon_resources)
        self.requests = dict(daemon_resources)
        self.topology = topology
        self.host_port_usage = HostPortUsage()
        self.pods: List[Pod] = []
        # (sig, ok_ids): instance types passing the requirements-only checks
        # for the last-added pod signature. Claim requirements only TIGHTEN
        # and adding an identical pod-requirement set tightens nothing, so
        # for successive same-signature adds (with no topology-derived
        # requirements) compat/offering verdicts are invariant — only the
        # fits check moves as requests accumulate. This collapses the
        # reference's per-pod re-filter (nodeclaim.go:108-117) to a
        # fits-only pass on the deployment-stamped hot path.
        self._compat_cache: Optional[tuple] = None
        # element-wise min allocatable across surviving instance types;
        # invalidated whenever the survivor set changes
        self._min_alloc: Optional[dict] = None

    def _compute_min_alloc(self) -> dict:
        its = self.instance_type_options
        keys: set = set()
        for it in its:
            keys.update(it.allocatable())
        return {k: min(it.allocatable().get(k, 0) for it in its)
                for k in keys}

    def add(self, pod: Pod, pod_requests: dict,
            pod_reqs: Optional[Requirements] = None,
            sig=None) -> Optional[str]:
        """Returns an error string, or None on success (nodeclaim.go:67-122)."""
        errs = scheduling_taints.tolerates(self.template.taints, pod)
        if errs:
            return errs[0]
        host_ports = get_host_ports(pod)
        conflicts = self.host_port_usage.conflicts(pod, host_ports)
        if conflicts:
            return f"checking host port usage, {conflicts[0]}"
        if pod_reqs is None:
            pod_reqs = pod_requirements(pod)
        # compat is non-mutating: check BEFORE paying for the copy — a pod
        # scans many full claims per solve, and most attempts fail here
        errs = self.requirements.compatible(pod_reqs, ALLOW_UNDEFINED_WELL_KNOWN)
        if errs:
            return f"incompatible requirements, {errs[0]}"
        nodeclaim_requirements = self.requirements.copy()
        nodeclaim_requirements.add(*pod_reqs.values())

        strict_reqs = pod_reqs
        if has_preferred_node_affinity(pod):
            strict_reqs = strict_pod_requirements(pod)
        topo_reqs, err = self.topology.add_requirements(
            strict_reqs, nodeclaim_requirements, pod, ALLOW_UNDEFINED_WELL_KNOWN)
        if err is not None:
            return err
        errs = nodeclaim_requirements.compatible(topo_reqs, ALLOW_UNDEFINED_WELL_KNOWN)
        if errs:
            return errs[0]
        nodeclaim_requirements.add(*topo_reqs.values())

        requests = res.merge(self.requests, pod_requests)
        remaining = None
        cacheable = sig is not None and not self.topology.last_add_tightened
        if cacheable and self._compat_cache is not None \
                and self._compat_cache[0] == sig:
            ok = self._compat_cache[1]
            # requests only grow: if they fit the element-wise MINIMUM
            # allocatable across survivors, no type can drop out — skip the
            # per-type scan (the hot loop at 50k identical pods). Only
            # meaningful when every survivor is signature-compatible; the
            # min is computed lazily there so the disabled regime pays zero
            fast = None
            if len(ok) == len(self.instance_type_options):
                if self._min_alloc is None:
                    self._min_alloc = self._compute_min_alloc()
                if res.fits(requests, self._min_alloc):
                    fast = self.instance_type_options
            if fast is None:
                fast = [it for it in self.instance_type_options
                        if id(it) in ok
                        and res.fits(requests, it.allocatable())]
            if fast and nodeclaim_requirements.has_min_values():
                _, err = satisfies_min_values(fast, nodeclaim_requirements)
                if err is not None:
                    fast = []
            if fast:
                remaining = fast
            # empty fast result: fall through to the full filter for the
            # exact failure-attribution message
        if remaining is None:
            ok_ids: Optional[set] = set() if cacheable else None
            remaining, reason = filter_instance_types(
                self.instance_type_options, nodeclaim_requirements, requests,
                ok_ids=ok_ids)
            if not remaining:
                return (f"no instance type satisfied resources "
                        f"{res.merge(self.daemon_resources, pod_requests)} and requirements ({reason})")
            if cacheable:
                self._compat_cache = (sig, ok_ids)

        if not cacheable:
            # this add may have tightened requirements in ways the cached
            # verdicts don't reflect (different signature / topology-derived
            # requirements): drop the cache rather than serve stale compat
            self._compat_cache = None

        self.pods.append(pod)
        if len(remaining) != len(self.instance_type_options):
            # filters only REMOVE: equal length means identical contents,
            # so the cached element-wise min stays valid
            self.instance_type_options = remaining
            self._min_alloc = None
        self.requests = requests
        self.requirements = nodeclaim_requirements
        self.topology.record(pod, nodeclaim_requirements, ALLOW_UNDEFINED_WELL_KNOWN)
        self.host_port_usage.add(pod, host_ports)
        return None

    def destroy(self) -> None:
        self.topology.unregister(api_labels.LABEL_HOSTNAME, self.hostname)

    def finalize(self) -> None:
        """Strip the placeholder hostname before launch (nodeclaim.go:130-134)."""
        self.requirements.delete(api_labels.LABEL_HOSTNAME)

    def remove_instance_types_by_price_and_min_values(self, reqs: Requirements,
                                                      max_price: float):
        """Consolidation price filter (nodeclaim.go:136-145)."""
        self.instance_type_options, _ = below_worst_launch_price(
            self.instance_type_options, reqs, max_price)
        self._min_alloc = None
        _, err = satisfies_min_values(self.instance_type_options, reqs)
        if err is not None:
            return None, err
        return self, None

    def to_nodeclaim(self) -> APINodeClaim:
        """nodeclaimtemplate.go:70-95 — truncate instance types by price into an
        In requirement, emit the API NodeClaim."""
        t = self.template
        reqs = Requirements(self.requirements.values())
        instance_types = self.instance_type_options[:MAX_INSTANCE_TYPES]
        mv = reqs.get(api_labels.LABEL_INSTANCE_TYPE).min_values
        reqs.add(Requirement(api_labels.LABEL_INSTANCE_TYPE, IN,
                             [it.name for it in instance_types], min_values=mv))
        nc = APINodeClaim(
            metadata=ObjectMeta(
                name=f"{t.nodepool_name}-{next(claim_name_seq):05d}",
                labels=dict(t.labels), annotations=dict(t.annotations),
                owner_refs=[OwnerReference(kind="NodePool", name=t.nodepool_name,
                                           uid=t.nodepool_uid, block_owner_deletion=True)]),
            spec=NodeClaimSpec(
                requirements=[_req_to_selector(r) for r in reqs.values()],
                resources_requests=dict(self.requests),
                taints=list(t.taints), startup_taints=list(t.startup_taints),
                node_class_ref=t.node_class_ref, expire_after=t.expire_after,
                termination_grace_period=t.termination_grace_period))
        return nc


@dataclass
class _SelectorReq:
    key: str
    operator: str
    values: tuple
    min_values: Optional[int] = None


def _req_to_selector(r: Requirement) -> _SelectorReq:
    op = r.operator()
    if r.greater_than is not None:
        return _SelectorReq(r.key, "Gt", (str(r.greater_than),), r.min_values)
    if r.less_than is not None:
        return _SelectorReq(r.key, "Lt", (str(r.less_than),), r.min_values)
    return _SelectorReq(r.key, op, tuple(r.values_list()), r.min_values)


class ExistingNode:
    """A live/in-flight node being packed (existingnode.go:31-128)."""

    def __init__(self, state_node, topology: Topology, taints: List[Taint],
                 daemon_resources: dict, store=None):
        self.state_node = state_node
        self.cached_available = state_node.available()
        self.cached_taints = taints
        self.topology = topology
        remaining_daemons = res.subtract(daemon_resources, state_node.daemonset_requests())
        self.requests = {k: max(v, 0) for k, v in remaining_daemons.items()}
        self.requirements = label_requirements(state_node.labels())
        self.requirements.add(Requirement(api_labels.LABEL_HOSTNAME, IN,
                                          [state_node.hostname()]))
        topology.register(api_labels.LABEL_HOSTNAME, state_node.hostname())
        self.pods: List[Pod] = []
        self._host_port_usage = state_node.host_port_usage().copy()
        self._store = store
        vu = getattr(state_node, "volume_usage", None)
        self._volume_usage = vu().copy() if vu is not None else None

    @property
    def name(self):
        return self.state_node.name()

    def initialized(self) -> bool:
        return self.state_node.initialized()

    def add(self, pod: Pod, pod_requests: dict,
            pod_reqs: Optional[Requirements] = None) -> Optional[str]:
        errs = scheduling_taints.tolerates(self.cached_taints, pod)
        if errs:
            return errs[0]
        host_ports = get_host_ports(pod)
        conflicts = self._host_port_usage.conflicts(pod, host_ports)
        if conflicts:
            return f"checking host port usage, {conflicts[0]}"
        pod_vols = None
        if self._store is not None and self._volume_usage is not None \
                and pod.spec.volumes:
            from ..scheduling.volumeusage import (get_volumes,
                                                  node_volume_limits)
            pod_vols = get_volumes(self._store, pod)
            err = self._volume_usage.exceeds_limits(
                pod_vols, node_volume_limits(self._store,
                                             self.state_node.name()))
            if err is not None:
                return f"checking volume usage, {err}"
        requests = res.merge(self.requests, pod_requests)
        if not res.fits(requests, self.cached_available):
            return "exceeds node resources"
        if pod_reqs is None:
            pod_reqs = pod_requirements(pod)
        errs = self.requirements.compatible(pod_reqs)
        if errs:
            return errs[0]
        node_requirements = self.requirements.copy()
        node_requirements.add(*pod_reqs.values())
        strict_reqs = pod_reqs
        if has_preferred_node_affinity(pod):
            strict_reqs = strict_pod_requirements(pod)
        topo_reqs, err = self.topology.add_requirements(strict_reqs, node_requirements, pod)
        if err is not None:
            return err
        errs = node_requirements.compatible(topo_reqs)
        if errs:
            return errs[0]
        node_requirements.add(*topo_reqs.values())

        self.pods.append(pod)
        self.requests = requests
        self.requirements = node_requirements
        self.topology.record(pod, node_requirements)
        self._host_port_usage.add(pod, host_ports)
        if pod_vols and self._volume_usage is not None:
            self._volume_usage.add(pod_vols)
        return None


def filter_instance_types(instance_types: List[InstanceType], requirements: Requirements,
                          requests: dict, ok_ids: Optional[set] = None):
    """Per-IT compat x fits x offering filter with failure attribution
    (nodeclaim.go:248-293 + FailureReason :182-245). When `ok_ids` is
    given, it is filled with id(it) of every type passing the
    requirements-only checks (compat AND offering, regardless of fits) —
    the claim-side cache that lets successive same-signature adds skip the
    requirement re-evaluation (only fits changes as requests accumulate)."""
    remaining = []
    any_compat = any_fits = any_offer = False
    compat_and_fits = compat_and_offer = fits_and_offer = False
    for it in instance_types:
        compat = not it.requirements.intersects(requirements)
        fits_ = res.fits(requests, it.allocatable())
        offer = it.offerings.available().has_compatible(requirements)
        any_compat |= compat
        any_fits |= fits_
        any_offer |= offer
        compat_and_fits |= compat and fits_ and not offer
        compat_and_offer |= compat and offer and not fits_
        fits_and_offer |= fits_ and offer and not compat
        if compat and offer and ok_ids is not None:
            ok_ids.add(id(it))
        if compat and fits_ and offer:
            remaining.append(it)
    if requirements.has_min_values() and remaining:
        _, err = satisfies_min_values(remaining, requirements)
        if err is not None:
            return [], err
    if remaining:
        return remaining, ""
    if not any_compat and not any_fits and not any_offer:
        reason = "no instance type met the scheduling requirements or had enough resources or had a required offering"
    elif not any_compat and not any_fits:
        reason = "no instance type met the scheduling requirements or had enough resources"
    elif not any_compat and not any_offer:
        reason = "no instance type met the scheduling requirements or had a required offering"
    elif not any_fits and not any_offer:
        reason = "no instance type had enough resources or had a required offering"
    elif not any_compat:
        reason = "no instance type met all requirements"
    elif not any_fits:
        reason = "no instance type has enough resources"
    elif not any_offer:
        reason = "no instance type has the required offering"
    elif compat_and_fits:
        reason = "no instance type which met the scheduling requirements and had enough resources, had a required offering"
    elif fits_and_offer:
        reason = "no instance type which had enough resources and the required offering met the scheduling requirements"
    elif compat_and_offer:
        reason = "no instance type which met the scheduling requirements and the required offering had the required resources"
    else:
        reason = "no instance type met the requirements/resources/offering tuple"
    return [], reason


class Queue:
    """Pod retry queue with progress detection (queue.go:31-74)."""

    def __init__(self, pods: List[Pod], pod_requests: Dict[str, dict]):
        from collections import deque
        self.pods = deque(sorted(pods, key=lambda p: (
            -pod_requests[p.uid].get(res.CPU, 0),
            -pod_requests[p.uid].get(res.MEMORY, 0),
            p.metadata.creation_timestamp, p.uid)))
        self.last_len: Dict[str, int] = {}

    def pop(self):
        if not self.pods:
            return None
        p = self.pods[0]
        if self.last_len.get(p.uid) == len(self.pods):
            return None
        self.pods.popleft()
        return p

    def push(self, pod: Pod, relaxed: bool) -> None:
        self.pods.append(pod)
        if relaxed:
            self.last_len = {}
        else:
            self.last_len[pod.uid] = len(self.pods)


@dataclass
class Results:
    """scheduler.go:108-112."""
    new_nodeclaims: List[InFlightNodeClaim] = field(default_factory=list)
    existing_nodes: List[ExistingNode] = field(default_factory=list)
    pod_errors: Dict[str, str] = field(default_factory=dict)  # pod uid -> error
    # tensor path only: a nodepool limit excluded capacity during the pack,
    # so pod_errors are order-dependent rather than oracle-final
    # (PackResult.limit_constrained; drives the host re-solve guard)
    limit_constrained: bool = False

    def all_pods_scheduled(self) -> bool:
        return not self.pod_errors

    def truncate_instance_types(self, max_instance_types: int = MAX_INSTANCE_TYPES) -> "Results":
        """scheduler.go:187-205."""
        valid = []
        for nc in self.new_nodeclaims:
            truncated, err = truncate(nc.instance_type_options, nc.requirements,
                                      max_instance_types)
            if err is not None:
                for pod in nc.pods:
                    self.pod_errors[pod.uid] = (
                        f"pod didn't schedule because NodePool {nc.template.nodepool_name!r} "
                        f"couldn't meet minValues requirements, {err}")
            else:
                nc.instance_type_options = truncated
                valid.append(nc)
        self.new_nodeclaims = valid
        return self

    def node_count(self) -> int:
        return len(self.new_nodeclaims)


class Scheduler:
    """scheduler.go:47-105,207-315. Pure host loop; see ops/binpack.py for the
    accelerated path the provisioner prefers on large batches."""

    def __init__(self, nodepools: List[NodePool], instance_types: Dict[str, List[InstanceType]],
                 topology: Topology, state_nodes=(), daemonset_pods: List[Pod] = ()):
        tolerate_pns = any(
            t.effect == "PreferNoSchedule"
            for np in nodepools for t in np.spec.template.spec.taints)
        self.preferences = Preferences(tolerate_prefer_no_schedule=tolerate_pns)
        self.topology = topology
        self.templates: List[NodeClaimTemplate] = []
        for np in nodepools:
            nct = NodeClaimTemplate(np)
            nct.instance_type_options, _ = filter_instance_types(
                instance_types.get(np.name, []), nct.requirements, {})
            if nct.instance_type_options:
                self.templates.append(nct)
        self.remaining_resources: Dict[str, dict] = {
            np.name: dict(np.spec.limits) for np in nodepools if np.spec.limits}
        self.daemon_overhead: Dict[int, dict] = {}
        self.daemonset_pods = list(daemonset_pods)
        for i, nct in enumerate(self.templates):
            self.daemon_overhead[i] = _daemon_overhead(nct, self.daemonset_pods)
        self.new_nodeclaims: List[InFlightNodeClaim] = []
        self.existing_nodes: List[ExistingNode] = []
        self.cached_pod_requests: Dict[str, dict] = {}
        # pod_requirements(pod) is pure until relax() mutates the pod; memo
        # per uid saves rebuilding it on every claim attempt of the scan loop
        self._cached_pod_reqs: Dict[str, Requirements] = {}
        # content signatures backing the claims' compat caches; invalidated
        # together with _cached_pod_reqs when relax() mutates a pod
        self._pod_sigs: Dict[str, tuple] = {}
        self._calculate_existing_nodes(state_nodes)

    def _calculate_existing_nodes(self, state_nodes) -> None:
        """scheduler.go:317-353."""
        store = getattr(self.topology.cluster, "store", None)
        for node in state_nodes:
            node_taints = node.taints()
            daemons = []
            for p in self.daemonset_pods:
                if scheduling_taints.tolerates(node_taints, p):
                    continue
                if label_requirements(node.labels()).compatible(pod_requirements(p)):
                    continue
                daemons.append(p)
            daemon_requests = res.merge(*(pp.requests() for pp in daemons)) if daemons else {}
            self.existing_nodes.append(
                ExistingNode(node, self.topology, node_taints, daemon_requests,
                             store=store))
            pool = node.labels().get(api_labels.NODEPOOL_LABEL_KEY)
            if pool in self.remaining_resources:
                self.remaining_resources[pool] = res.subtract(
                    self.remaining_resources[pool], node.capacity())
        self.existing_nodes.sort(key=lambda n: (not n.initialized(), n.name))

    def solve(self, pods: List[Pod]) -> Results:
        """scheduler.go:207-265 — loop while the queue makes progress; on
        failure relax one preference rung and re-enqueue."""
        from ..utils.gcpause import no_gc
        with no_gc():
            return self._solve(pods)

    def _solve(self, pods: List[Pod]) -> Results:
        errors: Dict[str, str] = {}
        for p in pods:
            self.cached_pod_requests[p.uid] = p.requests()
        q = Queue(pods, self.cached_pod_requests)
        # establish the fewest-pods-first invariant once; _add maintains it
        # incrementally afterwards (stable-sort-equivalent repositioning)
        self.new_nodeclaims.sort(key=lambda n: len(n.pods))
        while True:
            pod = q.pop()
            if pod is None:
                break
            err = self._add(pod)
            if err is None:
                errors.pop(pod.uid, None)
                continue
            errors[pod.uid] = err
            relaxed = self.preferences.relax(pod)
            q.push(pod, relaxed)
            if relaxed:
                self._cached_pod_reqs.pop(pod.uid, None)
                self._pod_sigs.pop(pod.uid, None)
                self.topology.update(pod)
        for nc in self.new_nodeclaims:
            nc.finalize()
        return Results(new_nodeclaims=self.new_nodeclaims,
                       existing_nodes=self.existing_nodes, pod_errors=errors)

    def _pod_sig(self, pod: Pod, pod_reqs: Requirements,
                 pod_requests: dict):
        """Content signature over everything the claim compat cache depends
        on: requirement set, request vector, tolerations. Pods sharing a
        signature get identical taints/compat/offering verdicts from a
        claim in a given state."""
        sig = self._pod_sigs.get(pod.uid)
        if sig is None:
            from .grouping import _req_signature
            sig = (_req_signature(pod_reqs),
                   tuple(sorted(pod_requests.items())),
                   tuple(pod.spec.tolerations))
            self._pod_sigs[pod.uid] = sig
        return sig

    def _reposition(self, idx: int) -> None:
        """Restore sorted order after claims[idx] grew by one pod — the
        stable-sort-equivalent move: past every claim with a smaller count,
        before existing claims of the new count (they were later in the
        pre-sort order)."""
        claims = self.new_nodeclaims
        L = len(claims[idx].pods)
        j = idx
        while j + 1 < len(claims) and len(claims[j + 1].pods) < L:
            j += 1
        if j != idx:
            claims.insert(j, claims.pop(idx))

    def _insert_sorted(self, nc: "InFlightNodeClaim") -> None:
        """Append-equivalent of the stable sort: a fresh claim lands after
        existing claims with <= its count and before any larger."""
        claims = self.new_nodeclaims
        L = len(nc.pods)
        j = len(claims)
        while j > 0 and len(claims[j - 1].pods) > L:
            j -= 1
        claims.insert(j, nc)

    def _add(self, pod: Pod) -> Optional[str]:
        """scheduler.go:267-315: existing nodes -> in-flight claims (fewest pods
        first) -> new claim from templates in weight order."""
        pod_requests = self.cached_pod_requests[pod.uid]
        pod_reqs = self._cached_pod_reqs.get(pod.uid)
        if pod_reqs is None:
            pod_reqs = pod_requirements(pod)
            self._cached_pod_reqs[pod.uid] = pod_reqs
        sig = self._pod_sig(pod, pod_reqs, pod_requests)
        for node in self.existing_nodes:
            if node.add(pod, pod_requests, pod_reqs) is None:
                return None
        for i, nc in enumerate(self.new_nodeclaims):
            if nc.add(pod, pod_requests, pod_reqs, sig=sig) is None:
                self._reposition(i)
                return None
        errs = []
        for i, nct in enumerate(self.templates):
            instance_types = nct.instance_type_options
            remaining = self.remaining_resources.get(nct.nodepool_name)
            if remaining is not None:
                instance_types = [it for it in instance_types
                                  if not res.exceeds(it.capacity, remaining)]
                if not instance_types:
                    errs.append(f'all available instance types exceed limits for nodepool: "{nct.nodepool_name}"')
                    continue
            nc = InFlightNodeClaim(nct, self.topology, self.daemon_overhead[i], instance_types)
            err = nc.add(pod, pod_requests, pod_reqs, sig=sig)
            if err is not None:
                nc.destroy()
                errs.append(f'incompatible with nodepool "{nct.nodepool_name}", {err}')
                continue
            self._insert_sorted(nc)
            if remaining is not None:
                self.remaining_resources[nct.nodepool_name] = _subtract_max(
                    remaining, nc.instance_type_options)
            return None
        return "; ".join(errs) if errs else "no nodepool matched pod"


def _daemon_overhead(nct: NodeClaimTemplate, daemonset_pods: List[Pod]) -> dict:
    """scheduler.go:356-382."""
    compatible = [p for p in daemonset_pods if _daemon_pod_compatible(nct, p)]
    return res.merge(*(p.requests() for p in compatible)) if compatible else {}


def _daemon_pod_compatible(nct: NodeClaimTemplate, pod: Pod) -> bool:
    import copy
    prefs = Preferences()
    pod = copy.deepcopy(pod)
    prefs._tolerate_prefer_no_schedule_taints(pod)
    if scheduling_taints.tolerates(nct.taints, pod):
        return False
    while True:
        if nct.requirements.is_compatible(strict_pod_requirements(pod),
                                          ALLOW_UNDEFINED_WELL_KNOWN):
            return True
        if prefs._remove_required_node_affinity_term(pod) is None:
            return False


def _subtract_max(remaining: dict, instance_types: List[InstanceType]) -> dict:
    """Pessimistic limit tracking (scheduler.go:388-405)."""
    if not instance_types:
        return remaining
    it_max = res.max_resources([it.capacity for it in instance_types])
    return {k: v - it_max.get(k, 0) for k, v in remaining.items()}
