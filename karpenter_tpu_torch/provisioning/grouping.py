"""Pod equivalence-class extraction for the tensor solver.

The reference scheduler loops pod-by-pod (scheduler.go:218-254), refiltering
instance types per pod — O(pods x ITs). Pods stamped from the same deployment
are interchangeable: identical requests, requirements, tolerations, labels and
topology constraints. Grouping collapses the loop to O(groups), which is the
main algorithmic win of the TPU design (SURVEY.md §7 layer 3).

A batch is *tensor-eligible* when every group's topology constraints fall in
the kernel-supported forms below and no constraint selects pods of another
group (cross-group count coupling). Otherwise the scheduler transparently
falls back to the host solver, whose semantics are always authoritative.

Supported per-group topology forms:
- zonal topology spread        (topologygroup.go nextDomainTopologySpread,
                                incl. minDomains floor-to-zero semantics)
- hostname topology spread
- zonal pod affinity           (all pods collapse to one zone)
- hostname pod affinity        (all pods onto one node, overflow unschedulable;
                                self-selecting only — non-self has no bootstrap
                                and needs live co-location state)
- zonal pod anti-affinity      (late committal: one pod per batch schedules)
- hostname pod anti-affinity   (one pod per node)

Each form may be self-selecting (the constraint's selector matches the pod's
own labels — the deployment case) or non-self-selecting (counts come only
from already-scheduled cluster pods; the packer treats the domain counts as
static since placing batch pods never changes them). A group may carry up to
TWO constraints when they layer cleanly: one zone-level constraint (zonal
spread or zonal affinity) plus one hostname-level constraint (hostname
spread or hostname anti-affinity) — the common real-world combo of "spread
across zones AND at most one per node". Anything else (zonal anti-affinity
or hostname affinity combined with another constraint, explicit affinity
namespaces, non-zone/hostname topology keys) demotes to the host path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..api import labels as api_labels
from ..api.objects import DO_NOT_SCHEDULE, Pod
from ..scheduling.requirements import (Requirements, has_preferred_node_affinity,
                                       pod_requirements)
from ..utils import resources as res


def _init_sig(entry):
    """Canonical signature for an init-container entry: (sorted items,
    sidecar flag) — both plain dicts and (requests, always) tuples."""
    req, always = res.init_entry(entry)
    return tuple(sorted(req.items())), always

# topology kinds
TOPO_NONE = "none"
SPREAD_ZONE = "spread-zone"
SPREAD_HOST = "spread-host"
AFFINITY_ZONE = "affinity-zone"
AFFINITY_HOST = "affinity-host"
ANTI_ZONE = "anti-zone"
ANTI_HOST = "anti-host"


ZONE_KINDS = (SPREAD_ZONE, AFFINITY_ZONE, ANTI_ZONE)
HOST_KINDS = (SPREAD_HOST, AFFINITY_HOST, ANTI_HOST)


@dataclass
class TopoSpec:
    kind: str
    max_skew: int = 1
    schedule_anyway: bool = False  # relaxable on failure
    min_domains: Optional[int] = None  # spread only (topologygroup.go:240-247)
    self_select: bool = True   # selector matches the group's own labels
    selector: object = None    # LabelSelector for cluster-pod counting


@dataclass
class PodGroup:
    pods: List[Pod]
    requirements: Requirements        # NewPodRequirements view (preferred folded in)
    requests: dict                    # milliunit ResourceList (per pod)
    tolerations: tuple
    labels: dict
    topo: List[TopoSpec] = field(default_factory=list)
    has_relaxable: bool = False       # preferred affinities / ScheduleAnyway present
    # (ip, port, protocol) triples shared by every pod of the group
    # (identical specs): within the group any two pods conflict on the same
    # node, so the packer caps host-port groups at one pod per node and
    # excludes cross-group/existing-node conflicts
    # (hostportusage.go:34-90 semantics, tensorized)
    host_ports: tuple = ()

    @property
    def count(self) -> int:
        return len(self.pods)


def _req_signature(reqs: Requirements):
    return tuple(sorted(
        (k, reqs.get(k).complement, frozenset(reqs.get(k).values),
         reqs.get(k).greater_than, reqs.get(k).less_than, reqs.get(k).min_values)
        for k in reqs))


def group_signature(g: PodGroup) -> tuple:
    """Content-stable identity of a tensor group ACROSS solves — unlike
    partition_pods' per-call signature (whose tokens are call-local ints),
    this hashes actual content, so the persistent ProblemState can match
    "the same deployment arrived again" between reconcile passes. Two
    groups with equal signatures encode to identical tensor rows and make
    identical packer decisions at equal counts; everything the packer or
    the topology counter reads off a group rides in here (requirements,
    requests, tolerations, labels, topo specs incl. selectors, ports, the
    probe's namespace + raw affinity/selector shape for the spread node
    filter)."""
    probe = g.pods[0]
    return (
        _req_signature(g.requirements),
        tuple(sorted(g.requests.items())),
        tuple(g.tolerations),
        tuple(sorted(g.labels.items())),
        tuple((s.kind, s.max_skew, s.schedule_anyway, s.min_domains,
               s.self_select, s.selector) for s in g.topo),
        tuple(g.host_ports),
        g.has_relaxable,
        probe.namespace,
        tuple(sorted(probe.spec.node_selector.items())),
        _affinity_key(probe),
        () if not probe.spec.volumes else tuple(probe.spec.volumes),
    )


def _port_triples(pod: Pod) -> tuple:
    """Canonical (ip, port, protocol) triples (hostportusage.go entry shape;
    an unset hostIP binds the wildcard)."""
    from ..scheduling.hostports import WILDCARD
    return tuple((hp.host_ip or WILDCARD, hp.port, hp.protocol)
                 for hp in pod.spec.host_ports)


def _demotion_reason(pod: Pod, psig, specs) -> str:
    """The ONE place tensor-ineligibility is decided for a bucket (both the
    prebucket fast path and the per-pod loop call it — a rule added to only
    one copy would silently split their verdicts). Ordered by precedence."""
    if psig is None:
        return "host ports require per-pod conflict tracking"
    if not all(ref.ephemeral for ref in pod.spec.volumes):
        # ephemeral volumes tensorize exactly: each pod brings its own
        # per-pod claim, so a group's CSI attach consumption is a per-node
        # linear cap (volumeusage.go:187-220). Shared PVCs / pre-bound PVs
        # keep set-dedup + PV-affinity semantics only the host models.
        return ("persistent volume claims shared across pods "
                "require host-side limit tracking")
    if specs is None:
        return "unsupported topology constraint shape"
    if psig and any(sp.kind == AFFINITY_HOST for sp in specs):
        # co-location demanded, >1/node forbidden: host-path only
        return ("host ports with hostname pod-affinity need "
                "per-pod host tracking")
    if any(sp.kind in ZONE_KINDS for sp in specs) \
            and has_preferred_node_affinity(pod):
        # kube keeps preferences OUT of spread-domain arithmetic
        # (topology_test.go:1299-1322), but pod_requirements folds the
        # heaviest preferred term — on ANY key, and any folded term can
        # shrink the feasible zone set through pool interactions — into
        # the group's requirement view. Zonal topology + any preference
        # therefore rides the host relaxation ladder, whose strict
        # requirements get this exactly right.
        return ("node-affinity preferences with zonal topology need "
                "the host relaxation ladder")
    return ""


def _selector_is_self(selector, labels: dict) -> bool:
    return selector is not None and selector.matches(labels)


def _term_namespaces_ok(term, pod: Pod) -> bool:
    """Explicit cross-namespace affinity terms need host-side namespace-aware
    counting (topology.go:341)."""
    return not term.namespaces or set(term.namespaces) == {pod.namespace}


def _classify_topology(pod: Pod) -> "Tuple[Optional[List[TopoSpec]], bool]":
    """Returns (specs, relaxable) or (None, _) when unsupported by the kernel."""
    specs: List[TopoSpec] = []
    relaxable = False
    for tsc in pod.spec.topology_spread_constraints:
        anyway = tsc.when_unsatisfiable != DO_NOT_SCHEDULE
        relaxable |= anyway
        self_sel = _selector_is_self(tsc.label_selector, pod.labels)
        if tsc.topology_key == api_labels.LABEL_TOPOLOGY_ZONE:
            specs.append(TopoSpec(SPREAD_ZONE, tsc.max_skew, anyway,
                                  min_domains=tsc.min_domains,
                                  self_select=self_sel,
                                  selector=tsc.label_selector))
        elif tsc.topology_key == api_labels.LABEL_HOSTNAME:
            # minDomains is irrelevant for hostname spreads: the global min
            # floors at 0 regardless (topologygroup.go:232-234)
            specs.append(TopoSpec(SPREAD_HOST, tsc.max_skew, anyway,
                                  self_select=self_sel,
                                  selector=tsc.label_selector))
        else:
            return None, relaxable
    aff = pod.spec.affinity
    if aff is not None:
        if aff.pod_affinity is not None:
            relaxable |= bool(aff.pod_affinity.preferred)
            for term in aff.pod_affinity.required:
                self_sel = _selector_is_self(term.label_selector, pod.labels)
                if not _term_namespaces_ok(term, pod):
                    return None, relaxable
                if term.topology_key == api_labels.LABEL_TOPOLOGY_ZONE:
                    specs.append(TopoSpec(AFFINITY_ZONE, self_select=self_sel,
                                          selector=term.label_selector))
                elif term.topology_key == api_labels.LABEL_HOSTNAME:
                    if not self_sel:
                        # non-self hostname affinity has no bootstrap and
                        # pins pods to live co-location state: host path
                        return None, relaxable
                    specs.append(TopoSpec(AFFINITY_HOST, self_select=True,
                                          selector=term.label_selector))
                else:
                    return None, relaxable
        if aff.pod_anti_affinity is not None:
            relaxable |= bool(aff.pod_anti_affinity.preferred)
            for term in aff.pod_anti_affinity.required:
                self_sel = _selector_is_self(term.label_selector, pod.labels)
                if not _term_namespaces_ok(term, pod):
                    return None, relaxable
                if term.topology_key == api_labels.LABEL_TOPOLOGY_ZONE:
                    specs.append(TopoSpec(ANTI_ZONE, self_select=self_sel,
                                          selector=term.label_selector))
                elif term.topology_key == api_labels.LABEL_HOSTNAME:
                    specs.append(TopoSpec(ANTI_HOST, self_select=self_sel,
                                          selector=term.label_selector))
                else:
                    return None, relaxable
    if len(specs) == 1:
        return specs, relaxable
    if len(specs) == 2:
        # supported layering: one zone-level + one hostname-level constraint,
        # where the zone constraint is spread or affinity and the hostname
        # constraint is spread or anti-affinity (zone choice and per-node
        # caps compose independently in the packer). Normalize zone-first.
        zone = [s for s in specs if s.kind in (SPREAD_ZONE, AFFINITY_ZONE)]
        host = [s for s in specs if s.kind in (SPREAD_HOST, ANTI_HOST)]
        if len(zone) == 1 and len(host) == 1:
            return zone + host, relaxable
        return None, relaxable
    if len(specs) > 2:
        return None, relaxable
    return specs, relaxable


def _affinity_key(pod: Pod):
    """Hashable structural key over the (frozen-dataclass) affinity terms."""
    a = pod.spec.affinity
    if a is None:
        return None
    parts = []
    if a.node_affinity is not None:
        parts.append(("node", tuple(a.node_affinity.required_terms),
                      tuple(a.node_affinity.preferred)))
    if a.pod_affinity is not None:
        parts.append(("pod", tuple(a.pod_affinity.required),
                      tuple(a.pod_affinity.preferred)))
    if a.pod_anti_affinity is not None:
        parts.append(("anti", tuple(a.pod_anti_affinity.required),
                      tuple(a.pod_anti_affinity.preferred)))
    return tuple(parts)


def group_pods(pods: List[Pod]) -> "Tuple[Optional[List[PodGroup]], str]":
    """All-or-nothing view of partition_pods: (groups, "") when EVERY pod is
    tensor-eligible, else (None, reason). Callers that can't mix solver
    paths per pod (the consolidation prefix simulator, the dryrun) use this;
    the provisioning solve uses partition_pods directly."""
    groups, leftover, reason = partition_pods(pods)
    if leftover:
        return None, reason
    return groups, ""


def _batch_conflicted_port_keys(pods: List[Pod]) -> set:
    """(port, protocol) keys used by 2+ batch pods with overlapping IPs
    (wildcard or duplicate). Users of such a key pairwise conflict
    (hostportusage.go:56-60); a key used once — or by distinct specific
    IPs only — constrains nothing within the batch."""
    by_pp: Dict[tuple, list] = {}
    for pod in pods:
        for ip, port, proto in _port_triples(pod):
            by_pp.setdefault((port, proto), []).append(ip)
    from ..scheduling.hostports import WILDCARD
    bad = set()
    for key, ips in by_pp.items():
        if len(ips) > 1 and (WILDCARD in ips or len(set(ips)) < len(ips)):
            bad.add(key)
    return bad


def partition_pods(pods: List[Pod], prebuckets: Optional[List[List[Pod]]] = None,
                   port_occupied=None, breakdown: Optional[list] = None):
    """Returns (groups, leftover_pods, reason): every pod lands on exactly
    one side. `groups` are tensor-eligible equivalence classes; `leftover`
    pods carry constraint shapes only the host oracle understands (host
    ports, volumes, unsupported topology forms) PLUS any group whose
    topology counts couple to a leftover pod or another group (shared
    selector domains must be counted by one solver). `reason` describes the
    first leftover cause (empty when leftover is empty).

    `breakdown`, when given, receives one ``(reason, pod_count)`` tuple per
    host-side bucket — the fallback cost ledger's raw attribution (the
    classification into shape classes happens in obs/fallbacks.py, so this
    module stays free of observability vocabulary).

    Two-phase: a cheap structural signature buckets the pods; the expensive
    classification (Requirements construction, topology-shape analysis) runs
    once per bucket — O(groups), not O(pods).

    `prebuckets` is the sidecar fast path: the wire's template column
    already partitions the batch into identical-spec buckets, so only each
    bucket's probe needs a signature (buckets whose probes collide merge —
    the wire keys templates by sub-object identity, which can split
    equal-content specs that this signature reunifies)."""
    groups: Dict = {}
    order: List = []
    # host-port eligibility (round 5): with a ``port_occupied`` checker the
    # caller vouches for existing-node usage, and ports that conflict with
    # NOTHING (batch-unique, unoccupied) constrain nothing — their pods
    # merge into ordinary groups instead of exploding G into single-pod
    # port groups. Without the checker (prefix sim, dryrun), port pods
    # demote to the host path wholesale, exactly the round-4 behavior.
    any_ports = any(p.spec.host_ports for p in pods) or (
        prebuckets is not None and any(
            b and b[0].spec.host_ports for b in prebuckets))
    bad_port_keys = ()
    if any_ports and port_occupied is not None:
        bad_port_keys = _batch_conflicted_port_keys(
            pods if prebuckets is None else
            [p for b in prebuckets for p in b])

    _port_sig_memo: Dict[tuple, object] = {}

    def port_sig(pod):
        """() when the pod's ports constrain nothing; the triples when they
        conflict (capped per-spec group); None -> demote (no checker).
        Memoized by triples: port_occupied scans every state node's usage,
        and identical specs (a deployment) must not re-pay that per pod."""
        triples = _port_triples(pod)
        if not triples:
            return ()
        if port_occupied is None:
            return None
        out = _port_sig_memo.get(triples, _port_sig_memo)
        if out is not _port_sig_memo:
            return out
        if any((port, proto) in bad_port_keys
               for _, port, proto in triples) or port_occupied(triples):
            out = triples
        else:
            out = ()
        _port_sig_memo[triples] = out
        return out

    # structural tokens memoized by sub-object identity: pods stamped from one
    # deployment share their spec sub-objects, so the expensive structural
    # hashing runs once per deployment, not once per pod — and the per-pod
    # signature is a tuple of small ints. Structural equality is preserved:
    # distinct-but-equal objects resolve to the same token via struct_tokens.
    # The loop body is manually inlined: at 50k pods the per-call overhead of
    # a tok() helper is itself a top-line cost.
    id_memo: Dict[int, int] = {}
    struct_tokens: Dict[object, int] = {}
    id_get = id_memo.get
    tok_setdefault = struct_tokens.setdefault

    def tok(obj, builder):
        t = id_get(id(obj))
        if t is None:
            t = tok_setdefault(builder(obj), len(struct_tokens))
            id_memo[id(obj)] = t
        return t

    ident = lambda o: o
    items_key = lambda d: tuple(sorted(d.items()))
    init_key = _init_sig
    reasons: Dict[int, str] = {}  # id(bucket) -> why it's host-path

    if prebuckets is not None:
        for bucket in prebuckets:
            if not bucket:
                continue
            probe = bucket[0]
            sig = (tuple(sorted(probe.spec.node_selector.items())),
                   _affinity_key(probe),
                   tuple(probe.spec.topology_spread_constraints),
                   tuple(probe.spec.tolerations),
                   tuple(sorted(probe.labels.items())),
                   tuple(tuple(sorted(r.items()))
                         for r in probe.container_requests),
                   tuple(_init_sig(r) for r in probe.init_container_requests),
                   port_sig(probe),
                   () if not probe.spec.volumes
                   else tuple(probe.spec.volumes))
            g = groups.get(sig)
            if g is None:
                psig = port_sig(probe)
                specs, relaxable = _classify_topology(probe)
                reason = _demotion_reason(probe, psig, specs)
                g = PodGroup(pods=[], requirements=pod_requirements(probe),
                             requests=probe.requests(),
                             tolerations=tuple(probe.spec.tolerations),
                             labels=dict(probe.labels), topo=specs or [],
                             has_relaxable=relaxable
                             or has_preferred_node_affinity(probe),
                             host_ports=psig or ())
                if reason:
                    reasons[id(g)] = reason
                groups[sig] = g
                order.append(g)
            g.pods.extend(bucket)
        return _finish_partition(order, reasons, breakdown)

    for pod in pods:
        spec = pod.spec
        aff = spec.affinity
        # labels + requests dicts are distinct objects per pod (stamped
        # metadata), so their id-memo never hits: key directly by content
        labels = pod.metadata.labels
        lt = tok_setdefault(tuple(sorted(labels.items())) if len(labels) > 1
                            else tuple(labels.items()), len(struct_tokens))
        reqs = pod.container_requests
        rt = (tok(reqs[0], items_key) if len(reqs) == 1
              else tuple(tok(r, items_key) for r in reqs))
        spread = spec.topology_spread_constraints
        sig = (
            # node_selector dicts are stamped fresh per pod, so the id-memo
            # never hits; the common empty case skips the content hash
            -1 if not spec.node_selector else tok(spec.node_selector, items_key),
            -1 if aff is None else tok(aff, lambda a, p=pod: _affinity_key(p)),
            tok(spread[0], ident) if len(spread) == 1
            else tuple(tok(c, ident) for c in spread),
            # empty collections are the common case: skip the generator
            () if not spec.tolerations
            else tuple(tok(t, ident) for t in spec.tolerations),
            lt,
            rt,
            () if not pod.init_container_requests
            else tuple(tok(r, init_key) for r in pod.init_container_requests),
            # port status keys the bucket: conflicting port specs must not
            # merge; constraint-free ports vanish from the signature
            () if not spec.host_ports else port_sig(pod),
            # volume content keys the bucket: ephemeral groups with distinct
            # storage classes must not merge (different CSI drivers/caps)
            () if not spec.volumes else tuple(spec.volumes),
        )
        g = groups.get(sig)
        if g is None:
            psig = port_sig(pod)
            specs, relaxable = _classify_topology(pod)
            reason = _demotion_reason(pod, psig, specs)
            g = PodGroup(pods=[], requirements=pod_requirements(pod),
                         requests=pod.requests(),
                         tolerations=tuple(pod.spec.tolerations),
                         labels=dict(pod.labels), topo=specs or [],
                         has_relaxable=relaxable or has_preferred_node_affinity(pod),
                         host_ports=psig or ())
            if reason:
                reasons[id(g)] = reason
            groups[sig] = g
            order.append(g)
        g.pods.append(pod)

    return _finish_partition(order, reasons, breakdown)


def _finish_partition(order: List[PodGroup], reasons: Dict[int, str],
                      breakdown: Optional[list] = None):
    # cross-group selector coupling: a topology selector matching another
    # bucket's labels means shared domain counts — both sides must be solved
    # by ONE solver. Any bucket coupled (transitively) to a host-path bucket
    # or to another eligible bucket is demoted to the host side.
    sels: Dict[int, list] = {}
    for g in order:
        out = []
        p = g.pods[0]
        for tsc in p.spec.topology_spread_constraints:
            if tsc.label_selector is not None:
                out.append(tsc.label_selector)
        aff = p.spec.affinity
        if aff is not None:
            for pa in (aff.pod_affinity, aff.pod_anti_affinity):
                if pa is None:
                    continue
                for term in pa.required:
                    if term.label_selector is not None:
                        out.append(term.label_selector)
                for wt in pa.preferred:
                    if wt.term.label_selector is not None:
                        out.append(wt.term.label_selector)
        sels[id(g)] = out

    eligible = [g for g in order if id(g) not in reasons]
    host_side = [g for g in order if id(g) in reasons]
    changed = True
    while changed:
        changed = False
        still = []
        for g in eligible:
            demote = ""
            # a host-side pod inside my selector domains (or vice versa)
            for h in host_side:
                if any(s.matches(h.labels) for s in sels[id(g)]) or \
                        any(s.matches(g.labels) for s in sels[id(h)]):
                    demote = "topology selector couples to host-path pods"
                    break
            if not demote and sels[id(g)]:
                # eligible-to-eligible coupling: the kernel counts each
                # group's domains independently, so shared counts demote both
                for g2 in eligible:
                    if g2 is not g and any(s.matches(g2.labels)
                                           for s in sels[id(g)]):
                        demote = "topology selector couples multiple pod groups"
                        break
            if demote:
                reasons[id(g)] = demote
                host_side.append(g)
                changed = True
            else:
                still.append(g)
        eligible = still

    leftover = [p for g in order if id(g) in reasons for p in g.pods]
    reason = next((reasons[id(g)] for g in order if id(g) in reasons), "")
    if breakdown is not None:
        breakdown.extend((reasons[id(g)], len(g.pods))
                         for g in order if id(g) in reasons)
    return [g for g in order if id(g) not in reasons], leftover, reason
