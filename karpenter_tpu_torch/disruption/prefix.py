"""Shared disruption snapshot + prefix simulation.

One disruption pass (controller.go:84-94) used to pay a full solver rebuild
per simulation probe: every `simulate_scheduling` call re-listed pods,
re-encoded all state nodes and the instance-type catalog, and re-ran the
device feasibility precompute from scratch. The pass-level inputs are
identical across probes — only WHICH candidates are excluded and WHICH pods
are pending change, and those live entirely on the host side of the packer.

`DisruptionSnapshot` captures the pass-level inputs ONCE:

- the pending-pod set plus the deleting-node ride-along pods (previously
  re-scanned inside every `simulate_scheduling` call, helpers.go:316-320);
- the packable (non-deleting) state nodes;
- the nodepool / instance-type / PDB context every method's candidate
  collection needs (`candidate context`);
- lazily, per candidate set: the encoded PackProblem + device feasibility
  tensors (`SnapshotEncoding`), memoized so Emptiness, MultiNode,
  SingleNode, and the validation re-check share one encode per pass
  instead of four independent `simulate_scheduling` entry points.

`SnapshotEncoding.simulate_subset` generalizes the prefix simulator:
any subset of the candidate set evaluates as a host-greedy replay over the
shared tensors — prefixes for the multi-node binary search, single indices
for leave-one-out single-node probes, the full set for validation. Batches
the kernel can't express raise `SnapshotFallback` and callers degrade to
per-probe `simulate_scheduling`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..api.nodepool import NodePool, order_by_weight
from ..api.objects import ObjectMeta, Pod, PodSpec
from ..obs.tracer import TRACER
from ..ops import binpack
from ..provisioning.grouping import PodGroup, group_pods
from ..provisioning.provisioner import Provisioner, StateClusterView
from ..provisioning.tensor_scheduler import (TensorScheduler, _FallbackError,
                                             _pow2_bucket, pad_exist_counts)
from ..scheduling.requirements import Requirements
from ..state.cluster import Cluster
from ..utils import pod as pod_utils
from .types import Candidate, CandidateError


class SnapshotFallback(Exception):
    """Batch not expressible in the tensor kernel: probe-per-sim instead."""


class PrefixFallback(SnapshotFallback):
    """Back-compat name for the multi-node prefix search callers."""


def exist_fill_order(state_nodes) -> List[int]:
    """THE packer existing-node fill order (initialized first, name
    tiebreak — scheduler.go:267-275 semantics): the snapshot replay walks
    it and the leave-one-out classifier's closed-form threshold math
    assumes it, so both read this one definition."""
    return sorted(range(len(state_nodes)),
                  key=lambda i: (not state_nodes[i].initialized(),
                                 state_nodes[i].name()))


def _pad_groups(groups: List[PodGroup]) -> List[PodGroup]:
    """Pad the group axis to a power-of-two bucket so successive disruption
    passes with slightly different deployment counts share compiled
    executable shapes (the solver_compile_cache hit condition). Pad groups
    carry one probe pod whose uid is never in any probe's allowed set, so
    their replayed count is always zero — build_problem sees a probe, the
    packer never places anything."""
    G = len(groups)
    bucket = _pow2_bucket(max(G, 1), 8)
    if bucket == G:
        return groups
    out = list(groups)
    for i in range(bucket - G):
        pad_pod = Pod(metadata=ObjectMeta(name=f"snapshot-pad-{i}",
                                          namespace="__snapshot_pad__"),
                      spec=PodSpec())
        out.append(PodGroup(pods=[pad_pod], requirements=Requirements(),
                            requests={}, tolerations=(), labels={}, topo=[]))
    return out


class DisruptionSnapshot:
    """Pass-level shared state for every disruption simulation.

    `stream` (disruption.stream.StreamingDisruptionState) makes the
    snapshot PERSISTENT: the stream keeps this object across passes and
    re-invokes individual layer builds (`_build_pods`, `_build_context`,
    `_build_scheduler`) only when their invalidation tokens changed,
    and threads its cross-pass ProblemState into the scheduler so node
    and group encodes are delta-applied. `prefetched` carries the
    (nodepools, instance-types, pending-pods, catalog-token) the stream
    already fetched for token capture so the layers don't re-list."""

    def __init__(self, cluster: Cluster, provisioner: Provisioner,
                 stream=None, prefetched=None):
        self.stream = stream
        self._prefetched = prefetched
        with TRACER.span("disruption.snapshot"):
            self._build(cluster, provisioner)
        self._prefetched = None

    def _build(self, cluster: Cluster, provisioner: Provisioner):
        self.cluster = cluster
        self.provisioner = provisioner
        self._build_pods(cluster, provisioner)
        self._build_context(cluster, provisioner)
        self._build_scheduler(cluster, provisioner)
        self._encodings: Dict[tuple, object] = {}

    def _build_pods(self, cluster: Cluster, provisioner: Provisioner):
        """Pod-derived layer: valid while Cluster.topo_revision, the node
        token, and the pending-pod token are unchanged."""
        from .helpers import pods_by_node
        # one store pass -> node name -> active pods (shared by candidate
        # collection AND the ride-along scan below)
        self.pods_by_node_map: Dict[str, List[Pod]] = pods_by_node(cluster)
        # the deleting-node ride-along scan, hoisted out of
        # simulate_scheduling (helpers.go:316-320): computed once per pass
        # instead of once per probe
        self.ride_along_pods: List[Pod] = []
        for sn in cluster.deleting_nodes():
            for p in self.pods_by_node_map.get(sn.name(), []):
                if pod_utils.is_reschedulable(p):
                    self.ride_along_pods.append(p)
        self.deleting_pod_uids: Set[str] = {p.uid for p in self.ride_along_pods}
        pending = (self._prefetched[2] if self._prefetched is not None
                   else provisioner.get_pending_pods())
        self.base_pods: List[Pod] = list(pending) + self.ride_along_pods
        self.base_uids: Set[str] = {p.uid for p in self.base_pods}
        self.state_nodes = [sn for sn in cluster.state_nodes(deep_copy=False)
                            if not sn.deleting()]

    def _build_context(self, cluster: Cluster, provisioner: Provisioner):
        """Candidate context: what get_candidates / validation need, built
        once per pass instead of once per method. Valid while the nodepool,
        catalog, PDB, and pod tokens are unchanged."""
        from .helpers import build_pdb_limits
        if self._prefetched is not None:
            pools, its_by_pool = self._prefetched[0], self._prefetched[1]
            self.all_nodepools = {np_.name: np_ for np_ in pools}
            self.instance_types_by_pool = dict(its_by_pool)
        else:
            self.all_nodepools = {
                np_.name: np_ for np_ in cluster.store.list(NodePool)}
            self.instance_types_by_pool = {
                name: provisioner.cloud_provider.get_instance_types(np_)
                for name, np_ in self.all_nodepools.items()}
        self.it_maps = {name: {it.name: it for it in its}
                        for name, its in self.instance_types_by_pool.items()}
        self.pdb_limits = build_pdb_limits(cluster)

    def _build_scheduler(self, cluster: Cluster, provisioner: Provisioner):
        """Solver layer: valid while the node, nodepool, catalog, and
        daemonset tokens are unchanged."""
        # solver-side nodepool view mirrors schedule_with: deleting pools
        # receive no new capacity, IT-less pools contribute nothing
        nodepools = order_by_weight(
            [np_ for np_ in self.all_nodepools.values()
             if np_.metadata.deletion_timestamp is None])
        self.nodepools = [np_ for np_ in nodepools
                          if self.instance_types_by_pool.get(np_.name)]
        # cold snapshots (validation / standalone prefix probes, no stream)
        # used to leave catalog_token unset, re-hashing ~2k instance types
        # inside EVERY build_problem the snapshot's encodings run: compute
        # the content token ONCE per snapshot build here, over the exact
        # pool ordering handed to the scheduler (weight order, IT-less
        # dropped — the _ordered_union order contract)
        from ..provisioning.tensor_scheduler import catalog_cache_token
        catalog_token = (self._prefetched[3]
                         if self._prefetched is not None else
                         catalog_cache_token(self.nodepools,
                                             self.instance_types_by_pool))
        self.ts = TensorScheduler(
            self.nodepools,
            {np_.name: self.instance_types_by_pool[np_.name]
             for np_ in self.nodepools},
            state_nodes=self.state_nodes,
            daemonset_pods=cluster.daemonset_pod_list(),
            cluster=StateClusterView(cluster.store, cluster),
            # the unavailable-offerings mask rides into every disruption
            # encode too: consolidation must never plan a replacement onto
            # an offering a launch failure just proved dry
            unavailable=getattr(provisioner, "unavailable", None),
            # streaming: node/group encode rows are delta-applied across
            # passes through the stream's persistent ProblemState, and the
            # content-keyed catalog token computed during token capture is
            # pinned so repeated builds skip re-hashing 2k instance types
            problem_state=(self.stream.problem_state
                           if self.stream is not None else None),
            catalog_token=catalog_token,
            # the provisioner's device: a snapshot never lands on another
            device=provisioner.device)
        # candidate-build traffic: its fallback-ledger records must not
        # move the headline provisioning totals (explicit flag — the
        # tracing-based backstop is off when --trace-ring is 0)
        self.ts.ledger_subsystem = "disruption"

    # -- per-candidate-set encode (memoized) --------------------------------

    @staticmethod
    def _enc_key(candidates: Sequence[Candidate]) -> tuple:
        return tuple(sorted(
            (c.provider_id, tuple(sorted(p.uid for p in c.reschedulable_pods)))
            for c in candidates))

    def encoding_for(self, candidates: Sequence[Candidate]
                     ) -> "SnapshotEncoding":
        """Encoded problem + device tensors for base pods + these candidates'
        pods. Memoized per pod-identical candidate set; raises
        SnapshotFallback when the batch isn't expressible and CandidateError
        when a candidate's node is gone or deleting."""
        for c in candidates:
            sn = self.cluster.nodes.get(c.provider_id)
            if sn is None or sn.deleting():
                raise CandidateError("candidate is deleting")
        key = self._enc_key(candidates)
        cached = self._encodings.get(key)
        if cached is not None:
            if isinstance(cached, SnapshotFallback):
                raise cached
            cached.candidates = list(candidates)
            cached._rebind(candidates)
            return cached
        try:
            enc = SnapshotEncoding(self, candidates)
        except SnapshotFallback as e:
            self._encodings[key] = e
            raise
        self._encodings[key] = enc
        return enc

    def simulate(self, candidates: Sequence[Candidate]):
        """simulate_scheduling through the shared encode, with the host
        solver as fallback for inexpressible batches. Same (results,
        sim_errors) contract as helpers.simulate_scheduling; raises
        CandidateError on deleted/deleting candidates."""
        from .helpers import simulate_scheduling
        try:
            enc = self.encoding_for(candidates)
        except SnapshotFallback:
            return simulate_scheduling(self.cluster, self.provisioner,
                                       list(candidates),
                                       ride_along=self.ride_along_pods)
        return enc.simulate_subset(range(len(candidates)))


class SnapshotEncoding:
    """One candidate set's encoded problem over the snapshot's shared state.

    The feasibility tensors depend on group *signatures* and the node batch,
    both identical across probes — only the pod *counts* per group and the
    excluded-node set vary, and those live entirely on the host side of the
    packer (SURVEY.md §7 layer 7)."""

    def __init__(self, snapshot: DisruptionSnapshot,
                 candidates: Sequence[Candidate]):
        with TRACER.span("disruption.encode", candidates=len(candidates)):
            self._build(snapshot, candidates)

    def _build(self, snapshot: DisruptionSnapshot,
               candidates: Sequence[Candidate]):
        self.snapshot = snapshot
        self.candidates = list(candidates)
        self.pod_uids_by_candidate = [
            {p.uid for p in c.reschedulable_pods} for c in candidates]
        sim_pods = [p for c in candidates for p in c.reschedulable_pods]
        all_pods = snapshot.base_pods + sim_pods
        # PVC-carrying pods pick up their volume topology requirements
        # exactly like schedule_with does before solving
        from ..provisioning.volumetopology import \
            inject_volume_topology_requirements
        all_pods = [inject_volume_topology_requirements(
            snapshot.cluster.store, p) if p.spec.volumes else p
            for p in all_pods]

        groups, reason = group_pods(all_pods)
        if groups is None:
            raise SnapshotFallback(reason)
        if any(g.has_relaxable for g in groups):
            # relaxation interplay is host-path territory
            raise SnapshotFallback("relaxable preferences in batch")
        self.real_groups = len(groups)
        self.groups = _pad_groups(groups)
        ts = snapshot.ts
        try:
            self.problem, self.templates, self.catalog = \
                ts.build_problem(self.groups)
        except _FallbackError as e:
            raise SnapshotFallback(str(e))
        self.tensors = ts.precompute(self.problem)
        self.node_index = {sn.name(): i for i, sn in enumerate(ts.state_nodes)}
        self.zone_names = self.problem.vocab.values[self.problem.zone_key]
        self.uid_group = {p.uid: gi for gi, g in enumerate(self.groups)
                          for p in g.pods}

    def _rebind(self, candidates: Sequence[Candidate]) -> None:
        """A memo hit may carry pod-identical but object-distinct candidates
        (validation rebuilds them fresh): rebind the uid sets in order."""
        self.pod_uids_by_candidate = [
            {p.uid for p in c.reschedulable_pods} for c in candidates]

    # -- per-probe host replay ---------------------------------------------

    def simulate_subset(self, idxs) -> Tuple[object, Dict[str, str]]:
        """Evaluate the candidate subset `idxs` (positions into the encoded
        candidate list); returns (results, sim_errors) like
        helpers.simulate_scheduling, including the uninitialized-node
        rejection (helpers.go:93-111)."""
        idxs = list(idxs)
        with TRACER.span("disruption.sim", subset=len(idxs)):
            return self._simulate_subset(idxs)

    def _simulate_subset(self, idxs) -> Tuple[object, Dict[str, str]]:
        snap = self.snapshot
        ts = snap.ts
        allowed: Set[str] = set(snap.base_uids)
        excluded_nodes: Set[str] = set()
        for i in idxs:
            allowed |= self.pod_uids_by_candidate[i]
            excluded_nodes.add(self.candidates[i].state_node.name())

        probe_groups: List[PodGroup] = []
        for g in self.groups:
            pods = [p for p in g.pods if p.uid in allowed]
            probe_groups.append(PodGroup(
                pods=pods, requirements=g.requirements, requests=g.requests,
                tolerations=g.tolerations, labels=g.labels, topo=g.topo,
                has_relaxable=g.has_relaxable, host_ports=g.host_ports))

        exist_order = [i for i in exist_fill_order(ts.state_nodes)
                       if ts.state_nodes[i].name() not in excluded_nodes]

        limits, limit_resources = self._limits(excluded_nodes)
        # per-probe domain occupancy: cluster pods matching each group's
        # topology selectors that are NOT pending in this probe still count
        # (non-subset candidates' pods among them) — host countDomains parity
        izc, exist_counts, host_total = ts.cluster_topology_counts(
            probe_groups, self.zone_names, allowed)
        exist_counts = pad_exist_counts(self.problem, exist_counts)
        # CSI attach limits per probe: _volume_limit_state builds fresh
        # per-node budget dicts each call, so the packer's draw-down never
        # leaks across probes
        vol_group_counts, vol_node_remaining = \
            ts._volume_limit_state(probe_groups)
        packer = binpack.Packer(self.problem, self.tensors, probe_groups,
                                limits, limit_resources,
                                initial_zone_counts=izc,
                                exist_order=exist_order,
                                exist_counts=exist_counts,
                                host_match_total=host_total,
                                vol_group_counts=vol_group_counts,
                                vol_node_remaining=vol_node_remaining)
        pr = packer.pack()
        results = ts._materialize(
            pr, self.problem, probe_groups, self.templates, self.catalog,
            self.problem.vocab, self.problem.zone_key)
        from .helpers import stamp_uninitialized_errors
        stamp_uninitialized_errors(results, snap.deleting_pod_uids)
        sim_uids = allowed - snap.base_uids
        sim_errors = {uid: e for uid, e in results.pod_errors.items()
                      if uid in sim_uids}
        return results, sim_errors

    def _limits(self, excluded_nodes: Set[str]):
        from ..api import labels as api_labels
        from ..ops import encode as enc
        from ..utils import resources as res
        ts = self.snapshot.ts
        limits: List[Optional[dict]] = []
        for nct in self.templates:
            np_obj = next(p for p in ts.nodepools
                          if p.name == nct.nodepool_name)
            if not np_obj.spec.limits:
                limits.append(None)
                continue
            rem = dict(np_obj.spec.limits)
            for sn in ts.state_nodes:
                if sn.name() in excluded_nodes:
                    continue
                if sn.labels().get(api_labels.NODEPOOL_LABEL_KEY) == \
                        nct.nodepool_name:
                    rem = res.subtract(rem, sn.capacity())
            limits.append({k: enc.scale_capacity(k, v)
                           for k, v in rem.items()})
        limit_resources = sorted({k for lm in limits if lm for k in lm})
        return limits, limit_resources


class PrefixSimulator:
    """Prefix probes for the multi-node binary search
    (multinodeconsolidation.go:110-162) over the shared snapshot: O(log N)
    probes cost one device program + O(log N) host replays instead of
    O(log N) full simulations."""

    def __init__(self, cluster: Cluster, provisioner: Provisioner,
                 candidates: List[Candidate],
                 snapshot: Optional[DisruptionSnapshot] = None):
        self.snapshot = snapshot if snapshot is not None \
            else DisruptionSnapshot(cluster, provisioner)
        try:
            self.enc = self.snapshot.encoding_for(candidates)
        except SnapshotFallback as e:
            raise PrefixFallback(str(e))
        self.candidates = candidates

    def simulate(self, prefix_len: int):
        """Evaluate candidates[:prefix_len]; returns (results, sim_errors)
        like helpers.simulate_scheduling."""
        return self.enc.simulate_subset(range(prefix_len))
