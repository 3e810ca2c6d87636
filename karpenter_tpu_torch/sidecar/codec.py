"""Wire codec for the solver sidecar.

Serializes exactly the inputs Scheduler.Solve consumes (pods, nodepools,
instance-type catalogs, state-node views, daemonset pods) and the outputs the
controllers need (launchable API NodeClaims + pod assignments + errors).
JSON-over-gRPC keeps the schema in one reviewable place; the north-star
boundary (BASELINE.json: controllers call the accelerator via a sidecar
hidden behind the Scheduler interface) only requires the contract, not a
specific IDL.

The flight recorder (flightrec/record.py) encodes its solve payloads
through the same functions, so a record made by either package decodes in
the other.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional

from ..api import labels as api_labels
from ..api.nodeclaim import NodeClaim, NodeClaimSpec
from ..api.nodepool import (Budget, Disruption, NodeClaimTemplate,
                            NodeClaimTemplateSpec, NodeClassRef, NodePool,
                            NodePoolSpec)
from ..api.objects import (Affinity, HostPort, LabelSelector, NodeAffinity,
                           NodeSelectorRequirement, NodeSelectorTerm, ObjectMeta,
                           OwnerReference, Pod, PodAffinity, PodAffinityTerm,
                           PodSpec, PreferredSchedulingTerm, PVCRef, Taint,
                           Toleration, TopologySpreadConstraint,
                           WeightedPodAffinityTerm)
from ..cloudprovider.types import (InstanceType, InstanceTypeOverhead, Offering,
                                   Offerings)
from ..scheduling.requirement import Requirement
from ..scheduling.requirements import Requirements

# -- requirements -----------------------------------------------------------


def req_to_dict(r: Requirement) -> dict:
    return {"key": r.key, "op": r.operator(), "values": r.values_list(),
            "gt": r.greater_than, "lt": r.less_than, "min_values": r.min_values}


def req_from_dict(d: dict) -> Requirement:
    from ..scheduling.requirement import (DOES_NOT_EXIST, EXISTS, GT, IN, LT,
                                          NOT_IN)
    op = d["op"]
    if op == "Gt":
        return Requirement(d["key"], GT, [str(d["gt"])],
                           min_values=d.get("min_values"))
    if op == "Lt":
        return Requirement(d["key"], LT, [str(d["lt"])],
                           min_values=d.get("min_values"))
    return Requirement(d["key"], op, d["values"],
                       min_values=d.get("min_values"))


def reqs_to_list(reqs: Requirements) -> list:
    return [req_to_dict(reqs.get(k)) for k in reqs]


def reqs_from_list(items: list) -> Requirements:
    return Requirements([req_from_dict(d) for d in items])


# -- selectors / affinity ---------------------------------------------------


def selector_to_dict(sel: Optional[LabelSelector]) -> Optional[dict]:
    if sel is None:
        return None
    return {"match_labels": list(sel.match_labels),
            "match_expressions": [
                {"key": e.key, "op": e.operator, "values": list(e.values)}
                for e in sel.match_expressions]}


def selector_from_dict(d: Optional[dict]) -> Optional[LabelSelector]:
    if d is None:
        return None
    return LabelSelector(
        match_labels=tuple(tuple(kv) for kv in d["match_labels"]),
        match_expressions=tuple(
            NodeSelectorRequirement(e["key"], e["op"], tuple(e["values"]))
            for e in d["match_expressions"]))


def _term_to_dict(t: NodeSelectorTerm) -> list:
    return [{"key": e.key, "op": e.operator, "values": list(e.values)}
            for e in t.match_expressions]


def _term_from_dict(items: list) -> NodeSelectorTerm:
    return NodeSelectorTerm(match_expressions=tuple(
        NodeSelectorRequirement(e["key"], e["op"], tuple(e["values"]))
        for e in items))


def affinity_to_dict(a: Optional[Affinity]) -> Optional[dict]:
    if a is None:
        return None
    out: dict = {}
    if a.node_affinity is not None:
        out["node"] = {
            "required": [_term_to_dict(t) for t in a.node_affinity.required_terms],
            "preferred": [{"weight": p.weight,
                           "term": _term_to_dict(p.preference)}
                          for p in a.node_affinity.preferred]}
    for name, pa in (("pod", a.pod_affinity), ("anti", a.pod_anti_affinity)):
        if pa is not None:
            out[name] = {
                "required": [{"topology_key": t.topology_key,
                              "selector": selector_to_dict(t.label_selector),
                              "namespaces": list(t.namespaces)}
                             for t in pa.required],
                "preferred": [{"weight": w.weight,
                               "term": {
                                   "topology_key": w.term.topology_key,
                                   "selector": selector_to_dict(w.term.label_selector),
                                   "namespaces": list(w.term.namespaces)}}
                              for w in pa.preferred]}
    return out or None


def _pa_term_from(d: dict) -> PodAffinityTerm:
    return PodAffinityTerm(topology_key=d["topology_key"],
                           label_selector=selector_from_dict(d["selector"]),
                           namespaces=tuple(d.get("namespaces", ())))


def affinity_from_dict(d: Optional[dict]) -> Optional[Affinity]:
    if not d:
        return None
    na = pa = anti = None
    if "node" in d:
        na = NodeAffinity(
            required_terms=[_term_from_dict(t) for t in d["node"]["required"]],
            preferred=[PreferredSchedulingTerm(p["weight"],
                                               _term_from_dict(p["term"]))
                       for p in d["node"]["preferred"]])
    if "pod" in d:
        pa = PodAffinity(
            required=[_pa_term_from(t) for t in d["pod"]["required"]],
            preferred=[WeightedPodAffinityTerm(w["weight"],
                                               _pa_term_from(w["term"]))
                       for w in d["pod"]["preferred"]])
    if "anti" in d:
        anti = PodAffinity(
            required=[_pa_term_from(t) for t in d["anti"]["required"]],
            preferred=[WeightedPodAffinityTerm(w["weight"],
                                               _pa_term_from(w["term"]))
                       for w in d["anti"]["preferred"]])
    return Affinity(node_affinity=na, pod_affinity=pa, pod_anti_affinity=anti)


# -- taints / tolerations ---------------------------------------------------


def taint_to_dict(t: Taint) -> dict:
    return {"key": t.key, "effect": t.effect, "value": t.value}


def taint_from_dict(d: dict) -> Taint:
    return Taint(key=d["key"], effect=d["effect"], value=d["value"])


def toleration_to_dict(t: Toleration) -> dict:
    return {"key": t.key, "operator": t.operator, "value": t.value,
            "effect": t.effect}


def toleration_from_dict(d: dict) -> Toleration:
    return Toleration(key=d["key"], operator=d["operator"], value=d["value"],
                      effect=d["effect"])


# -- pods -------------------------------------------------------------------


def pod_to_dict(p: Pod) -> dict:
    return {
        "name": p.name, "namespace": p.namespace, "uid": p.uid,
        "labels": dict(p.labels),
        "annotations": dict(p.metadata.annotations),
        "creation_timestamp": p.metadata.creation_timestamp,
        "node_selector": dict(p.spec.node_selector),
        "affinity": affinity_to_dict(p.spec.affinity),
        "tolerations": [toleration_to_dict(t) for t in p.spec.tolerations],
        "spread": [{"topology_key": c.topology_key, "max_skew": c.max_skew,
                    "selector": selector_to_dict(c.label_selector),
                    "when_unsatisfiable": c.when_unsatisfiable,
                    "min_domains": c.min_domains}
                   for c in p.spec.topology_spread_constraints],
        "host_ports": [{"port": hp.port, "protocol": hp.protocol,
                        "host_ip": hp.host_ip} for hp in p.spec.host_ports],
        "volumes": [{"claim_name": v.claim_name, "ephemeral": v.ephemeral,
                     "storage_class_name": v.storage_class_name}
                    for v in p.spec.volumes],
        "priority": p.spec.priority,
        "node_name": p.spec.node_name,
        "requests": [dict(r) for r in p.container_requests],
        "init_requests": [[dict(e[0]), e[1]] if isinstance(e, tuple)
                          else dict(e) for e in p.init_container_requests],
        "daemonset": p.is_daemonset_pod,
    }


def encode_pod_batch(pods) -> dict:
    """Deployment-level dedup for large batches: pods stamped from one
    deployment share their spec sub-objects, so an identity-keyed template
    table collapses 50k pods to O(deployments) full specs + a per-pod
    [name, uid, timestamp, node_name, template] row. This is the wire-side
    twin of grouping.partition_pods' signature bucketing — and decoding
    rebuilds SHARED sub-objects, so the server-side bucketing stays O(1)
    per pod too."""
    templates: list = []
    tmpl_idx: dict = {}
    rows: list = []
    for p in pods:
        key = _pod_template_key(p)
        i = tmpl_idx.get(key)
        if i is None:
            d = pod_to_dict(p)
            for f in ("name", "uid", "creation_timestamp", "node_name"):
                d.pop(f, None)
            i = tmpl_idx[key] = len(templates)
            templates.append(d)
        rows.append([p.name, p.uid, p.metadata.creation_timestamp,
                     p.spec.node_name, i])
    return {"templates": templates, "rows": rows}


def decode_pod_batch(d: dict) -> "List[Pod]":
    protos = []
    for t in d["templates"]:
        full = dict(t)
        full.update(name="", uid="", creation_timestamp=0.0, node_name="")
        protos.append(pod_from_dict(full))
    out = []
    for name, uid, ts, node_name, i in d["rows"]:
        pr = protos[i]
        out.append(Pod(
            metadata=ObjectMeta(
                name=name, namespace=pr.namespace, uid=uid,
                labels=dict(pr.labels),
                annotations=dict(pr.metadata.annotations),
                creation_timestamp=ts),
            spec=PodSpec(
                node_selector=pr.spec.node_selector,
                affinity=pr.spec.affinity,
                tolerations=pr.spec.tolerations,
                topology_spread_constraints=
                    pr.spec.topology_spread_constraints,
                host_ports=pr.spec.host_ports,
                volumes=pr.spec.volumes,
                priority=pr.spec.priority,
                node_name=node_name),
            container_requests=pr.container_requests,
            init_container_requests=pr.init_container_requests,
            is_daemonset_pod=pr.is_daemonset_pod))
    return out


def pod_from_dict(d: dict) -> Pod:
    return Pod(
        metadata=ObjectMeta(name=d["name"], namespace=d["namespace"],
                            uid=d["uid"], labels=dict(d["labels"]),
                            annotations=dict(d["annotations"]),
                            creation_timestamp=d["creation_timestamp"]),
        spec=PodSpec(
            node_selector=dict(d["node_selector"]),
            affinity=affinity_from_dict(d["affinity"]),
            tolerations=[toleration_from_dict(t) for t in d["tolerations"]],
            topology_spread_constraints=[
                TopologySpreadConstraint(
                    topology_key=c["topology_key"], max_skew=c["max_skew"],
                    label_selector=selector_from_dict(c["selector"]),
                    when_unsatisfiable=c["when_unsatisfiable"],
                    min_domains=c["min_domains"])
                for c in d["spread"]],
            host_ports=[HostPort(port=hp["port"], protocol=hp["protocol"],
                                 host_ip=hp["host_ip"])
                        for hp in d["host_ports"]],
            volumes=[PVCRef(claim_name=v["claim_name"],
                            ephemeral=v.get("ephemeral", False),
                            storage_class_name=v.get("storage_class_name", ""))
                     for v in d.get("volumes", [])],
            priority=d["priority"],
            node_name=d.get("node_name", "")),
        container_requests=[dict(r) for r in d["requests"]],
        init_container_requests=[
            (dict(e[0]), e[1]) if isinstance(e, list) and len(e) == 2
            and isinstance(e[1], bool) else dict(e)
            for e in d["init_requests"]],
        is_daemonset_pod=d["daemonset"])


# -- columnar pod rows (session protocol) -----------------------------------


def _pod_template_key(p: Pod):
    """Identity tokens for stamped-and-shared sub-objects, insertion-order
    content for per-pod dicts: distinct-but-equal objects just cost an extra
    template, never correctness (the template holds full content)."""
    spec = p.spec
    return (id(spec.affinity),
            tuple(map(id, spec.topology_spread_constraints)),
            tuple(map(id, spec.tolerations)),
            tuple(spec.node_selector.items()),
            tuple(p.metadata.labels.items()),
            tuple(tuple(r.items()) for r in p.container_requests),
            tuple((tuple(e[0].items()), e[1]) if isinstance(e, tuple)
                  else tuple(e.items()) for e in p.init_container_requests),
            tuple((hp.port, hp.protocol, hp.host_ip)
                  for hp in spec.host_ports),
            tuple(spec.volumes),  # PVCRef is frozen/hashable
            p.metadata.namespace, spec.priority, p.is_daemonset_pod,
            tuple(p.metadata.annotations.items()))


def encode_pod_rows(pods):
    """Columnar twin of encode_pod_batch for the session protocol: returns
    (templates, tmpl_idx, timestamps). Row order == batch order; responses
    reference pods by row index, so no per-pod JSON (and no names/uids —
    server-side pod identity is synthetic, see build_wire_pods) rides the
    wire: only a uint32 template column and the creation-timestamp column
    (host-queue sort tiebreak, scheduler.py Queue). Identity-token memo
    mirrors grouping.partition_pods so the per-pod cost is a small-tuple
    hash, not a structural one."""
    import numpy as _np
    templates: list = []
    tmpl_idx_map: dict = {}
    n = len(pods)
    tmpl_idx = _np.empty(n, dtype=_np.uint32)
    ts = _np.empty(n, dtype=_np.float64)
    # content tokens memoized by sub-object identity (the partition_pods
    # trick): deployment-stamped pods share their request dicts / constraint
    # elements even when the containers are stamped fresh per pod
    id_memo: dict = {}
    struct_tokens: dict = {}
    id_get = id_memo.get
    tok_setdefault = struct_tokens.setdefault

    def tok(obj, content):
        t = id_get(id(obj))
        if t is None:
            t = tok_setdefault(content(), len(struct_tokens))
            id_memo[id(obj)] = t
        return t

    # run-length fast path: deployment stamps arrive in contiguous runs of
    # identical specs, so comparing against the PREVIOUS pod's sub-objects
    # (id for interned members, C-level dict/list equality for per-pod
    # stamped copies) resolves most rows without building the key tuple
    prev = None
    prev_t = 0
    for i, p in enumerate(pods):
        spec = p.spec
        meta = p.metadata
        labels = meta.labels
        reqs = p.container_requests
        if prev is not None and (
                spec.affinity is prev.spec.affinity
                and spec.topology_spread_constraints
                == prev.spec.topology_spread_constraints
                and spec.tolerations == prev.spec.tolerations
                and spec.node_selector == prev.spec.node_selector
                and labels == prev.metadata.labels
                and reqs == prev.container_requests
                and p.init_container_requests
                == prev.init_container_requests
                and spec.host_ports == prev.spec.host_ports
                and spec.volumes == prev.spec.volumes
                and meta.namespace == prev.metadata.namespace
                and spec.priority == prev.spec.priority
                and p.is_daemonset_pod == prev.is_daemonset_pod
                and meta.annotations == prev.metadata.annotations):
            tmpl_idx[i] = prev_t
            ts[i] = meta.creation_timestamp
            continue
        key = (
            -1 if spec.affinity is None else id(spec.affinity),
            tuple(map(id, spec.topology_spread_constraints)),
            () if not spec.tolerations else tuple(map(id, spec.tolerations)),
            -1 if not spec.node_selector
            else tok_setdefault(tuple(sorted(spec.node_selector.items())),
                                len(struct_tokens)),
            tok_setdefault(tuple(labels.items()), len(struct_tokens)),
            (tok(reqs[0], lambda: tuple(reqs[0].items()))
             if len(reqs) == 1 else
             tuple(tok(r, lambda r=r: tuple(r.items())) for r in reqs)),
            () if not p.init_container_requests
            else tuple(tok(r, lambda r=r: (tuple(r[0].items()), r[1])
                           if isinstance(r, tuple) else tuple(r.items()))
                       for r in p.init_container_requests),
            () if not spec.host_ports else tuple(map(id, spec.host_ports)),
            () if not spec.volumes else tuple(spec.volumes),
            meta.namespace, spec.priority, p.is_daemonset_pod,
            -1 if not meta.annotations
            else tok_setdefault(tuple(meta.annotations.items()),
                                len(struct_tokens)),
        )
        t = tmpl_idx_map.get(key)
        if t is None:
            d = pod_to_dict(p)
            for f in ("name", "uid", "creation_timestamp", "node_name"):
                d.pop(f, None)
            t = tmpl_idx_map[key] = len(templates)
            templates.append(d)
        tmpl_idx[i] = t
        ts[i] = p.metadata.creation_timestamp
        prev, prev_t = p, t
    return templates, tmpl_idx, ts


# -- delta session protocol (wire v1) ----------------------------------------
#
# A steady-state SolveSession ships only what changed since the session's
# last ACKED solve:
#
#   header["v"]             delta schema version (absent = legacy full-batch)
#   header["templates_new"] [[tid, template_dict], ...] — the session's
#                           template table is persistent and append-only;
#                           ids are assigned client-side in registration
#                           order and MUST be contiguous
#   blobs["pod_remove"]     u32 row indices into the server's CURRENT batch
#                           (strictly ascending), applied first
#   blobs["pod_add_tid"]/["pod_add_ts"]
#                           appended rows: template id + creation timestamp
#   header["pods_full"]     full batch resync: drop every row, then apply
#                           the adds (the template table survives)
#   header["state_upsert"]/["state_remove"]/["state_revs"]
#                           node deltas as before, plus the client's opaque
#                           per-node revision token (StateNode identity +
#                           revision) so the digest can cover node state
#                           without re-serializing unchanged nodes
#   header["daemonset"]/["ds_token"], header["cluster"]/["cluster_token"]
#                           content snapshots sent only on token change
#   header["digest"]        content digest of the client's view of the
#                           POST-apply session state; the server recomputes
#                           it from its own state and aborts with
#                           FAILED_PRECONDITION on mismatch — the client
#                           falls back to a full snapshot (resync)
#
# Decisions stay byte-identical to a fresh full-state solve by contract:
# the server solves from its reconstructed state, which digest-verifies
# against the client's, and `header["parity_check"]` samples re-solve the
# identical state cold (no ProblemState) server-side and compare canonical
# decision digests (flightrec.decision_digest) — the DEVIATIONS-19 audit
# shape applied to the wire.

# v2 adds the OPTIONAL `trace_ctx` / `subsystem` header fields: the
# operator-side pass trace rides the wire so the server's session/queue/
# solve span tree (and its flightrec records) joins the SAME trace_id, and
# disruption candidate probes flag themselves for the server's fallback
# ledger. v1 requests (no new fields) are still served — the fields are
# additive, so the server speaks both; unknown FUTURE versions still fail
# loudly.
#
# SKEW CONTRACT (deliberately one-directional, the kube convention):
# servers upgrade BEFORE clients. A v2 client against a v1-only server is
# rejected INVALID_ARGUMENT on every solve — the version gate exists so a
# server never half-parses fields it doesn't know, and the price of that
# loud failure is paid at rollout time, not at 3am as a silently-wrong
# solve. Roll the sidecar first.
DELTA_SCHEMA_VERSION = 2
DELTA_SCHEMA_ACCEPTED = (1, 2)


class DeltaVersionError(ValueError):
    """An unknown delta-session schema version: refuse loudly instead of
    misparsing half-understood delta fields into a silently-wrong solve
    (the flightrec TraceVersionError contract, applied to the wire)."""


class DigestMismatchError(ValueError):
    """Server/client session state diverged (the content-digest handshake
    failed): the client must resync with a full snapshot."""


def check_delta_version(header: dict) -> None:
    v = header.get("v")
    if v not in DELTA_SCHEMA_ACCEPTED:
        raise DeltaVersionError(
            f"unknown delta session schema version {v!r} (this end speaks "
            f"v{DELTA_SCHEMA_VERSION}, accepts "
            f"{list(DELTA_SCHEMA_ACCEPTED)}); refusing to guess at the "
            "fields")


def template_content_key(d: dict) -> str:
    """Canonical content key of one pod template dict — the identity the
    persistent template table dedups on. Identity-keyed client templates
    that carry equal content collapse onto one server id here."""
    return json.dumps(d, sort_keys=True, separators=(",", ":"))


def templates_digest(keys) -> str:
    """Running digest of the session's template table (content keys in id
    order): covers the per-id CONTENT, which the row digest alone cannot —
    a client/server disagreement about what template 7 means would
    otherwise solve the wrong specs with a clean row digest."""
    from . import wire
    return wire.content_digest(*keys)


def batch_digest(tids, ts, tmpl_digest: str, state_tokens: dict,
                 ds_token: str, cluster_token: str) -> str:
    """Content digest of the full delta-session state: pod rows (template
    id + timestamp columns), the template-table digest, the per-node
    revision tokens, and the daemonset/cluster snapshot tokens."""
    import numpy as _np

    from . import wire
    return wire.content_digest(
        _np.asarray(tids, dtype="<u4").tobytes(),
        _np.asarray(ts, dtype="<f8").tobytes(),
        tmpl_digest,
        ";".join(f"{name}={tok}" for name, tok
                 in sorted(state_tokens.items())),
        str(ds_token), str(cluster_token))


def diff_pod_rows(prev_rows, new_rows):
    """Client-side pod-batch diff. Rows are (uid, tid, ts) tuples; returns
    (removals, additions, merged) where `removals` are strictly-ascending
    indices into prev_rows, `additions` are the new rows to append, and
    `merged` is the post-apply server batch order the client must mirror:
    survivors in previous order, then additions. A pod whose template or
    timestamp changed is a remove+add."""
    prev_index = {r[0]: i for i, r in enumerate(prev_rows)}
    keep = set()
    additions = []
    for r in new_rows:
        i = prev_index.get(r[0])
        if i is not None and prev_rows[i][1] == r[1] \
                and prev_rows[i][2] == r[2]:
            keep.add(i)
        else:
            additions.append(r)
    removals = [i for i in range(len(prev_rows)) if i not in keep]
    merged = [prev_rows[i] for i in sorted(keep)] + additions
    return removals, additions, merged


def apply_pod_delta(rows, header: dict, blobs) -> list:
    """Server-side pod-batch delta application, mirroring diff_pod_rows:
    removals against the CURRENT row indices first, then appends. `rows`
    is the session's [(tid, ts)] list; returns the new list. Raises
    ValueError on malformed deltas (out-of-range/unsorted removals,
    mismatched add columns) — the caller maps that to INVALID_ARGUMENT."""
    from . import wire
    if header.get("pods_full"):
        rows = []
    elif "pod_remove" in blobs:
        removes = wire.unpack_u32(blobs["pod_remove"])
        n = len(rows)
        keep = [True] * n
        prev = -1
        for i in removes.tolist():
            if i <= prev or i >= n:
                raise ValueError(
                    f"pod_remove index {i} invalid for a batch of {n} "
                    "(indices must be strictly ascending and in range)")
            prev = i
            keep[i] = False
        rows = [r for r, k in zip(rows, keep) if k]
    else:
        rows = list(rows)
    if "pod_add_tid" in blobs:
        tids = wire.unpack_u32(blobs["pod_add_tid"]).tolist()
        tss = wire.unpack_f64(blobs["pod_add_ts"]).tolist()
        if len(tids) != len(tss):
            raise ValueError(
                f"pod_add column length mismatch: {len(tids)} template ids "
                f"vs {len(tss)} timestamps")
        rows.extend(zip(tids, tss))
    return rows


_SHARED_POD_STATUS = None

# interned "r<row>" identity strings: the delta session renumbers up to the
# whole batch after a removal, and 50k fresh f-string allocations per solve
# are measurable on the warm path. Grows to the largest batch seen; growth
# is locked because concurrent solves (serve(max_concurrent>1)) share it —
# an interleaved grow would misplace an entry in the table FOREVER.
_ROW_STRS: List[str] = []
_ROW_STRS_LOCK = threading.Lock()


def _row_strs(n: int) -> List[str]:
    if len(_ROW_STRS) < n:
        with _ROW_STRS_LOCK:
            while len(_ROW_STRS) < n:
                _ROW_STRS.append(f"r{len(_ROW_STRS)}")
    return _ROW_STRS


def build_wire_pods(templates: List[dict], tmpl_idx, ts,
                    proto_cache: Optional[list] = None) -> "List[Pod]":
    """Server-side fast rebuild of a columnar pod batch.

    One full prototype Pod is decoded per template; every row then shares
    the prototype's ENTIRE PodSpec, labels/annotations dicts, request lists
    and a common PodStatus — only ObjectMeta (uid/name/timestamp) is
    per-row. Sharing the whole spec is safe: the solver treats pod specs as
    read-only, and the one mutating path (the relaxation ladder) clones the
    spec per pod first (preferences._own_spec_containers). Pods carry their
    row index as `_row`, and a synthetic `r<row>` uid/name — results
    reference the batch by row index, and real identities never ride the
    wire (pending pods can't be topology-counted server-side anyway:
    topology.py ignored_for_topology drops node-less pods)."""
    protos = wire_pod_protos(templates, proto_cache)
    # numpy iteration yields boxed scalars; plain lists are ~3x faster here.
    # Callers that already hold the list form (server prebucketing) pass it
    # directly so the 50k-row conversion happens once.
    tmpl_list = tmpl_idx.tolist() if hasattr(tmpl_idx, "tolist") else tmpl_idx
    ts_list = ts.tolist() if hasattr(ts, "tolist") else ts
    out: list = []
    append_wire_pods(protos, tmpl_list, ts_list, out)
    return out


def wire_pod_protos(templates: List[dict],
                    proto_cache: Optional[list] = None) -> list:
    """Decode one prototype Pod per template. `proto_cache` is the
    delta-session fast path: the session's template table is append-only,
    so prototypes decoded once live for the session and only NEW templates
    pay pod_from_dict here."""
    protos = proto_cache if proto_cache is not None else []
    for t in templates[len(protos):]:
        full = dict(t)
        full.update(name="", uid="", creation_timestamp=0.0, node_name="")
        pr = pod_from_dict(full)
        if "volume_drivers" in t:
            # client-resolved CSI driver counts rider (the server has no
            # store); consumed by TensorScheduler._volume_limit_state
            pr.spec._volume_drivers = dict(t["volume_drivers"])
        protos.append(pr)
    return protos


def append_wire_pods(protos: list, tmpl_list, ts_list, out: list) -> None:
    """Append one wire Pod per (template id, timestamp) row to `out`,
    numbering rows from len(out) — build_wire_pods' row loop, reusable for
    the delta session's incremental batch maintenance (only ADDED rows are
    built; survivors keep their objects, see renumber_wire_pods)."""
    global _SHARED_POD_STATUS
    from ..api.objects import PodStatus
    if _SHARED_POD_STATUS is None:
        _SHARED_POD_STATUS = PodStatus()
    status = _SHARED_POD_STATUS
    proto_parts = [(pr.spec, pr.metadata.namespace, pr.metadata.labels,
                    pr.metadata.annotations, pr.container_requests,
                    pr.init_container_requests, pr.is_daemonset_pod)
                   for pr in protos]
    meta_new = ObjectMeta.__new__
    pod_new = Pod.__new__
    i = len(out)
    rstr = _row_strs(i + len(tmpl_list))
    for t, created in zip(tmpl_list, ts_list):
        spec, ns, labels, annotations, reqs, ireqs, is_ds = proto_parts[t]
        uid = rstr[i]
        m = meta_new(ObjectMeta)
        m.__dict__ = {
            "name": uid, "namespace": ns, "uid": uid, "labels": labels,
            "annotations": annotations, "finalizers": (), "owner_refs": (),
            "creation_timestamp": created, "deletion_timestamp": None,
            "resource_version": 0, "generation": 0}
        p = pod_new(Pod)
        p.__dict__ = {
            "metadata": m, "spec": spec, "status": status,
            "container_requests": reqs, "init_container_requests": ireqs,
            "is_daemonset_pod": is_ds, "_row": i}
        out.append(p)
        i += 1


def renumber_wire_pods(pods: list) -> None:
    """Restore the row-index invariant (`_row` == position, uid/name ==
    "r<row>") after removals shifted survivors — identity on the session
    wire is synthetic and positional, so a shifted pod must take its new
    row's identity or result/error row references would point past it."""
    rstr = _row_strs(len(pods))
    for i, p in enumerate(pods):
        if p.__dict__["_row"] != i:
            p.__dict__["_row"] = i
            uid = rstr[i]
            m = p.metadata.__dict__
            m["name"] = uid
            m["uid"] = uid


# -- row-based results (session protocol) -----------------------------------


def encode_solve_response_rows(results, fallback_reason: str,
                               it_idx_by_id: dict, it_idx_by_name: dict,
                               extra_header: Optional[dict] = None) -> bytes:
    """Interned, row-referencing response frame. Claims from one packer
    cohort share everything but their pods, so the full NodeClaim shape
    (labels/taints/requirements + the surviving instance-type set as catalog
    indices) is emitted once per cohort; per-claim data is just a span into
    one shared row-index blob. Claim NAMES are assigned client-side
    (they're fresh unique identifiers either way), so none ride the wire."""
    from ..api import labels as api_labels
    from . import wire
    shapes: list = []
    shape_idx: dict = {}
    claims: list = []
    all_rows: List[int] = []
    all_its: List[int] = []
    its_span_by_id: dict = {}

    def it_span(its) -> list:
        """Surviving instance types as catalog indices in the shared blob.
        Cohorts overwhelmingly share their price-ordered options LIST
        (tensor_scheduler's order_cache interns it), so spans dedup by list
        identity."""
        span = its_span_by_id.get(id(its))
        if span is None:
            off = len(all_its)
            for it in its:
                i = it_idx_by_id.get(id(it))
                if i is None:
                    i = it_idx_by_name[it.name]
                all_its.append(i)
            span = its_span_by_id[id(its)] = (its, [off, len(its)])
        return span[1]

    for nc in results.new_nodeclaims:
        key = getattr(nc, "cohort_id", None)
        si = shape_idx.get(key) if key is not None else None
        if si is None:
            nc.finalize()
            api_nc = nc.to_nodeclaim()
            d = api_nodeclaim_to_dict(api_nc)
            d.pop("name", None)
            # the instance-type requirement's value list (60 names) is
            # redundant: the client's to_nodeclaim() rewrites it from the
            # options list after price filtering — ship it empty
            for rd in d["requirements"]:
                if rd["key"] == api_labels.LABEL_INSTANCE_TYPE:
                    rd["values"] = []
            si = len(shapes)
            shapes.append({
                "nodeclaim": d,
                "nodepool": nc.template.nodepool_name,
                "requirements": reqs_to_list(nc.requirements),
                "its": it_span(nc.instance_type_options),
            })
            if key is not None:
                shape_idx[key] = si
        off = len(all_rows)
        rows = [p._row for p in nc.pods]
        all_rows.extend(rows)
        claims.append([si, off, len(rows)])

    existing = []
    for en in results.existing_nodes:
        off = len(all_rows)
        rows = [p._row for p in en.pods]
        all_rows.extend(rows)
        existing.append([en.name, off, len(rows)])

    # errors: intern by message (identical verdicts repeat across a group);
    # stub uids are synthetic "r<row>", so keys compress to row indices
    err_rows_by_msg: Dict[str, list] = {}
    for uid, msg in results.pod_errors.items():
        err_rows_by_msg.setdefault(msg, []).append(int(uid[1:]))
    err_rows: List[int] = []
    errors = []
    for msg, rows in err_rows_by_msg.items():
        errors.append([msg, len(err_rows), len(rows)])
        err_rows.extend(rows)

    its_u16 = not all_its or max(all_its) < 0x10000
    header = {
        "fallback_reason": fallback_reason,
        "shapes": shapes,
        "claims": claims,
        "existing": existing,
        "errors": errors,
        "its_u16": its_u16,
    }
    if extra_header:
        header.update(extra_header)
    return wire.pack(header, {
        "rows": wire.pack_u32(all_rows),
        "its": (wire.pack_u16(all_its) if its_u16
                else wire.pack_u32(all_its)),
        "err_rows": wire.pack_u32(err_rows)})


def instance_type_to_dict(it: InstanceType) -> dict:
    return {
        "name": it.name,
        "requirements": reqs_to_list(it.requirements),
        "capacity": dict(it.capacity),
        "overhead": {"kube_reserved": dict(it.overhead.kube_reserved),
                     "system_reserved": dict(it.overhead.system_reserved),
                     "eviction_threshold": dict(it.overhead.eviction_threshold)},
        "offerings": [{"requirements": reqs_to_list(o.requirements),
                       "price": o.price, "available": o.available}
                      for o in it.offerings],
    }


def instance_type_from_dict(d: dict) -> InstanceType:
    offs = Offerings(Offering(requirements=reqs_from_list(o["requirements"]),
                              price=o["price"], available=o["available"])
                     for o in d["offerings"])
    return InstanceType(
        name=d["name"], requirements=reqs_from_list(d["requirements"]),
        capacity=dict(d["capacity"]), offerings=offs,
        overhead=InstanceTypeOverhead(
            kube_reserved=dict(d["overhead"]["kube_reserved"]),
            system_reserved=dict(d["overhead"]["system_reserved"]),
            eviction_threshold=dict(d["overhead"]["eviction_threshold"])))


# -- nodepools --------------------------------------------------------------


def nodepool_to_dict(np: NodePool) -> dict:
    spec = np.spec.template.spec
    return {
        "name": np.name, "uid": np.metadata.uid,
        "labels": dict(np.spec.template.metadata_labels),
        "annotations": dict(np.spec.template.metadata_annotations),
        "requirements": [{"key": r.key, "op": r.operator,
                          "values": list(r.values),
                          "min_values": getattr(r, "min_values", None)}
                         for r in spec.requirements],
        "taints": [taint_to_dict(t) for t in spec.taints],
        "startup_taints": [taint_to_dict(t) for t in spec.startup_taints],
        "expire_after": spec.expire_after,
        "termination_grace_period": spec.termination_grace_period,
        "limits": dict(np.spec.limits),
        "weight": np.spec.weight,
    }


def nodepool_from_dict(d: dict) -> NodePool:
    reqs = []
    for r in d["requirements"]:
        nsr = NodeSelectorRequirement(r["key"], r["op"], tuple(r["values"]))
        if r.get("min_values") is not None:
            nsr = _MinValuesReq(nsr, r["min_values"])
        reqs.append(nsr)
    return NodePool(
        metadata=ObjectMeta(name=d["name"], uid=d["uid"], namespace=""),
        spec=NodePoolSpec(
            template=NodeClaimTemplate(
                metadata_labels=dict(d["labels"]),
                metadata_annotations=dict(d["annotations"]),
                spec=NodeClaimTemplateSpec(
                    requirements=reqs,
                    taints=[taint_from_dict(t) for t in d["taints"]],
                    startup_taints=[taint_from_dict(t)
                                    for t in d["startup_taints"]],
                    expire_after=d["expire_after"],
                    termination_grace_period=d["termination_grace_period"])),
            limits=dict(d["limits"]), weight=d["weight"]))


class _MinValuesReq:
    """NodeSelectorRequirement + min_values rider."""

    def __init__(self, base: NodeSelectorRequirement, min_values: int):
        self.key = base.key
        self.operator = base.operator
        self.values = base.values
        self.min_values = min_values


# -- state nodes ------------------------------------------------------------


def state_node_to_dict(sn, store=None) -> dict:
    out = {
        "name": sn.name(), "labels": dict(sn.labels()),
        "taints": [taint_to_dict(t) for t in sn.taints()],
        "allocatable": dict(sn.allocatable()),
        "capacity": dict(sn.capacity()),
        "pod_requests": {uid: dict(r) for uid, r in sn.pod_requests.items()},
        "daemonset_requests": {uid: dict(r) for uid, r
                               in sn.daemonset_pod_requests.items()},
        "initialized": sn.initialized(),
    }
    managed = getattr(sn, "managed", None)
    if managed is not None and not managed():
        out["managed"] = False
    # occupied host ports ride along so a remote/replayed solve sees the
    # same port conflicts the in-process one did (hostportusage.go:34-90);
    # pod identity is preserved for the oracle's own-port exemption
    ports = [[e.pod_uid, e.ip, e.port, e.protocol]
             for e in sn.host_port_usage().entries()]
    if ports:
        out["host_ports"] = ports
    # CSI attach-limit facts ride with the node: the server has no store to
    # resolve CSINode limits or current usage (volumeusage.go:187-220)
    vu = getattr(sn, "volume_usage", None)
    if vu is not None:
        used = {d: len(s) for d, s in vu().volumes.items()}
        if used:
            out["volume_used"] = used
    if store is not None:
        from ..scheduling.volumeusage import node_volume_limits
        limits = node_volume_limits(store, sn.name())
        if limits:
            out["volume_limits"] = {d: lm for d, lm in limits.items()}
    return out


class WireStateNode:
    """StateNode view reconstructed from the wire (duck-typed for the
    scheduler: name/labels/taints/allocatable/available/capacity/
    daemonset_requests/hostname/host_port_usage/initialized)."""

    def __init__(self, d: dict):
        from ..scheduling.hostports import HostPortUsage, _Entry
        from ..utils import resources as res
        self._d = d
        self._taints = [taint_from_dict(t) for t in d["taints"]]
        self._hpu = HostPortUsage()
        self._hpu.add_entries(
            _Entry(pod_uid=pod_uid, ip=ip, port=port, protocol=protocol)
            for pod_uid, ip, port, protocol in d.get("host_ports", ()))
        self.pod_requests = dict(d["pod_requests"])
        self.daemonset_pod_requests = dict(d["daemonset_requests"])
        # attach-limit riders consumed by TensorScheduler._volume_limit_state
        self.volume_used = dict(d.get("volume_used", {}))
        self.volume_limits = {k: v for k, v in
                              d.get("volume_limits", {}).items()}
        total = (res.merge(*self.pod_requests.values())
                 if self.pod_requests else {})
        self._available = res.subtract(dict(d["allocatable"]), total)

    def name(self):
        return self._d["name"]

    def hostname(self):
        return self._d["labels"].get(api_labels.LABEL_HOSTNAME, self._d["name"])

    def labels(self):
        return self._d["labels"]

    def taints(self):
        return self._taints

    def allocatable(self):
        return dict(self._d["allocatable"])

    def capacity(self):
        return dict(self._d["capacity"])

    def available(self):
        return dict(self._available)

    def daemonset_requests(self):
        from ..utils import resources as res
        return (res.merge(*self.daemonset_pod_requests.values())
                if self.daemonset_pod_requests else {})

    def host_port_usage(self):
        return self._hpu

    def initialized(self):
        return self._d["initialized"]

    def managed(self):
        return self._d.get("managed", True)


# -- nodeclaims (results) ---------------------------------------------------


def api_nodeclaim_to_dict(nc: NodeClaim) -> dict:
    return {
        "name": nc.name, "labels": dict(nc.metadata.labels),
        "annotations": dict(nc.metadata.annotations),
        "owner_refs": [{"kind": o.kind, "name": o.name, "uid": o.uid}
                       for o in nc.metadata.owner_refs],
        "requirements": [{"key": r.key, "op": r.operator,
                          "values": list(r.values),
                          "min_values": r.min_values}
                         for r in nc.spec.requirements],
        "requests": dict(nc.spec.resources_requests),
        "taints": [taint_to_dict(t) for t in nc.spec.taints],
        "startup_taints": [taint_to_dict(t) for t in nc.spec.startup_taints],
        "expire_after": nc.spec.expire_after,
        "termination_grace_period": nc.spec.termination_grace_period,
    }


def api_nodeclaim_from_dict(d: dict) -> NodeClaim:
    from ..provisioning.scheduler import _SelectorReq
    return NodeClaim(
        metadata=ObjectMeta(
            name=d["name"], namespace="", labels=dict(d["labels"]),
            annotations=dict(d["annotations"]),
            owner_refs=[OwnerReference(kind=o["kind"], name=o["name"],
                                       uid=o["uid"], block_owner_deletion=True)
                        for o in d["owner_refs"]]),
        spec=NodeClaimSpec(
            requirements=[_SelectorReq(r["key"], r["op"], tuple(r["values"]),
                                       r["min_values"])
                          for r in d["requirements"]],
            resources_requests=dict(d["requests"]),
            taints=[taint_from_dict(t) for t in d["taints"]],
            startup_taints=[taint_from_dict(t) for t in d["startup_taints"]],
            expire_after=d["expire_after"],
            termination_grace_period=d["termination_grace_period"]))


# -- request / response -----------------------------------------------------


def cluster_view_to_dict(cluster, pods) -> dict:
    """Topology-relevant snapshot of the live cluster for the wire
    (topology.go countDomains inputs): scheduled cluster pods matching any
    (namespace, selector) pair referenced by the batch's spread/affinity
    constraints, every scheduled pod with required anti-affinity, and the
    labels of the nodes hosting them. WireClusterView rebuilds the
    ClusterView contract from this server-side, so sidecar solves count
    existing domain occupancy exactly like in-process ones."""
    pairs = []  # (namespace, selector)
    for p in pods:
        for tsc in p.spec.topology_spread_constraints:
            pairs.append((p.namespace, tsc.label_selector))
        aff = p.spec.affinity
        if aff is None:
            continue
        terms = []
        for pa in (aff.pod_affinity, aff.pod_anti_affinity):
            if pa is not None:
                terms += list(pa.required)
                terms += [wt.term for wt in pa.preferred]
        for term in terms:
            for ns in (set(term.namespaces) or {p.namespace}):
                pairs.append((ns, term.label_selector))
    snapshot: Dict[str, object] = {}
    # one scan per distinct pair: a batch's pods repeat their workload's
    # selectors, and a store-backed view reads every pod per scan (one scan
    # per pod is quadratic in the batch: tens of minutes at 50k pods). The
    # pairs keep their first order, so the snapshot's order is unchanged
    for ns, sel in dict.fromkeys(pairs):
        if sel is None:
            continue
        for cp in cluster.list_pods(ns, sel):
            snapshot[cp.uid] = cp
    anti_uids = []
    for cp, _labels in cluster.for_pods_with_anti_affinity():
        snapshot[cp.uid] = cp
        anti_uids.append(cp.uid)
    node_labels: Dict[str, dict] = {}
    for cp in snapshot.values():
        nn = cp.spec.node_name
        if nn and nn not in node_labels:
            labels = cluster.node_labels(nn)
            if labels is not None:
                node_labels[nn] = dict(labels)
    return {"pods": [pod_to_dict(cp) for cp in snapshot.values()],
            "anti_affinity_uids": anti_uids,
            "node_labels": node_labels}


class WireClusterView:
    """provisioning.topology.ClusterView over a cluster_view_to_dict
    snapshot."""

    def __init__(self, d: Optional[dict]):
        d = d or {"pods": [], "anti_affinity_uids": [], "node_labels": {}}
        self._pods = [pod_from_dict(p) for p in d["pods"]]
        self._anti = set(d["anti_affinity_uids"])
        self._node_labels = {n: dict(l) for n, l in d["node_labels"].items()}

    def list_pods(self, namespace: str, selector):
        return [p for p in self._pods
                if p.namespace == namespace and selector.matches(p.labels)]

    def node_labels(self, node_name: str):
        return self._node_labels.get(node_name)

    def for_pods_with_anti_affinity(self):
        for p in self._pods:
            if p.uid in self._anti:
                labels = self._node_labels.get(p.spec.node_name)
                if labels is not None:
                    yield p, labels


def union_catalog(instance_types: Dict[str, List[InstanceType]]) -> list:
    """Name-deduped instance-type union in SORTED pool order — the index
    space shared by the session client and server for result instance-type
    references. Both sides MUST use this one function: a divergent order
    silently remaps every claim's surviving instance types."""
    catalog, seen = [], set()
    for pool in sorted(instance_types):
        for it in instance_types[pool]:
            if it.name not in seen:
                seen.add(it.name)
                catalog.append(it)
    return catalog


def encode_session_request(nodepools,
                           instance_types: Dict[str, List[InstanceType]],
                           tenant: str = "") -> bytes:
    """Session bootstrap: the heavy slow-changing inputs, sent once and then
    referenced by session id (state nodes/daemonset pods ride as deltas on
    each solve instead). `tenant` labels the session for the server's
    admission fairness and per-tenant metrics."""
    catalog: Dict[str, dict] = {}
    per_pool: Dict[str, List[str]] = {}
    for pool, its in instance_types.items():
        per_pool[pool] = [it.name for it in its]
        for it in its:
            if it.name not in catalog:
                catalog[it.name] = instance_type_to_dict(it)
    payload = {
        "nodepools": [nodepool_to_dict(np) for np in nodepools],
        "catalog": list(catalog.values()),
        "pool_instance_types": per_pool,
    }
    if tenant:
        payload["tenant"] = tenant
    return json.dumps(payload).encode()


def decode_session_request(data: bytes):
    d = json.loads(data.decode())
    catalog = {it["name"]: instance_type_from_dict(it) for it in d["catalog"]}
    instance_types = {pool: [catalog[n] for n in names]
                      for pool, names in d["pool_instance_types"].items()}
    return ([nodepool_from_dict(np) for np in d["nodepools"]],
            instance_types,
            d.get("tenant", ""))


def encode_solve_request(nodepools, instance_types: Dict[str, List[InstanceType]],
                         pods, state_nodes=(), daemonset_pods=(),
                         cluster=None) -> bytes:
    catalog: Dict[str, dict] = {}
    per_pool: Dict[str, List[str]] = {}
    for pool, its in instance_types.items():
        per_pool[pool] = [it.name for it in its]
        for it in its:
            if it.name not in catalog:
                catalog[it.name] = instance_type_to_dict(it)
    payload = {
        "nodepools": [nodepool_to_dict(np) for np in nodepools],
        "catalog": list(catalog.values()),
        "pool_instance_types": per_pool,
        "pods": encode_pod_batch(pods),
        "state_nodes": [state_node_to_dict(sn) for sn in state_nodes],
        "daemonset_pods": [pod_to_dict(p) for p in daemonset_pods],
        "cluster": (cluster_view_to_dict(cluster, pods)
                    if cluster is not None else None),
    }
    return json.dumps(payload).encode()


def decode_solve_request(data: bytes):
    d = json.loads(data.decode())
    catalog = {it["name"]: instance_type_from_dict(it) for it in d["catalog"]}
    instance_types = {pool: [catalog[n] for n in names]
                      for pool, names in d["pool_instance_types"].items()}
    return (
        [nodepool_from_dict(np) for np in d["nodepools"]],
        instance_types,
        decode_pod_batch(d["pods"]),
        [WireStateNode(sn) for sn in d["state_nodes"]],
        [pod_from_dict(p) for p in d["daemonset_pods"]],
        WireClusterView(d.get("cluster")),
    )


def encode_solve_response(results, fallback_reason: str = "") -> bytes:
    new_claims = []
    for nc in results.new_nodeclaims:
        nc.finalize()
        api_nc = nc.to_nodeclaim()
        new_claims.append({
            "nodeclaim": api_nodeclaim_to_dict(api_nc),
            "pod_uids": [p.uid for p in nc.pods],
            # solver-state riders so the disruption price filter can run
            # client-side (consolidation.go:169-221)
            "requirements": reqs_to_list(nc.requirements),
            "instance_type_names": [it.name for it in nc.instance_type_options],
        })
    payload = {
        "new_nodeclaims": new_claims,
        "existing_nodes": [{"name": en.name,
                            "pod_uids": [p.uid for p in en.pods]}
                           for en in results.existing_nodes],
        "pod_errors": dict(results.pod_errors),
        "fallback_reason": fallback_reason,
    }
    return json.dumps(payload).encode()


def decode_solve_response(data: bytes) -> dict:
    return json.loads(data.decode())


# -- session checkpoints (fleet migration) ------------------------------------
#
# A checkpoint serializes everything a server-side `_Session` IS — the
# template table, pod row columns, state-node mirrors and their revision
# tokens, daemonset/cluster snapshots and tokens, the dedupe nonces
# (last_req_seq + response cache) and the last acked state digest — so a
# session can be rebuilt on ANY replica without the client re-sending full
# state. Checkpoints ride the same KTPW framing as delta solves and follow
# the same loud-reject rules: a truncated frame, an unexpected message
# kind, an unknown checkpoint schema version or a digest that does not
# recompute from the restored parts all refuse loudly instead of
# resurrecting a half-understood session.
#
# Version skew is one-directional, like the delta schema above: replicas
# both PRODUCE and CONSUME checkpoints, so the whole fleet rolls before
# any replica starts emitting a newer `ckpt` version (roll servers first;
# a mixed fleet mid-roll only ever hands newer readers older frames).

CHECKPOINT_KIND = "session_checkpoint"
CHECKPOINT_SCHEMA_VERSION = 1
CHECKPOINT_SCHEMA_ACCEPTED = (1,)


class CheckpointVersionError(ValueError):
    """An unknown session-checkpoint schema version: refuse loudly instead
    of misparsing half-understood session state into a silently-wrong
    restore (the DeltaVersionError contract, applied to migration)."""


def check_checkpoint_version(header: dict) -> None:
    v = header.get("ckpt")
    if v not in CHECKPOINT_SCHEMA_ACCEPTED:
        raise CheckpointVersionError(
            f"unknown session checkpoint schema version {v!r} (this end "
            f"speaks v{CHECKPOINT_SCHEMA_VERSION}, accepts "
            f"{list(CHECKPOINT_SCHEMA_ACCEPTED)}); refusing to guess at a "
            "session's state — roll every sidecar replica before emitting "
            "newer checkpoints")


def encode_session_checkpoint(st: dict) -> bytes:
    """Serialize a session-state dict (the server's `_Session` bridged to
    plain JSON shapes + the raw bootstrap payload bytes) into one KTPW
    checkpoint frame. Pod rows ride as typed columns; the response cache
    rides as one concatenated blob with (digest, length) offsets."""
    from . import wire
    rows = st.get("rows", [])
    responses = [(k, bytes(v)) for k, v in st.get("responses", ())]
    header = {
        "kind": CHECKPOINT_KIND,
        "ckpt": CHECKPOINT_SCHEMA_VERSION,
        # the delta schema the mirrors speak: a restore onto a replica
        # that cannot speak this wire version must reject up front, not
        # fail every subsequent solve
        "v": DELTA_SCHEMA_VERSION,
        "session": st["session"],
        "tenant": st.get("tenant", ""),
        "templates": list(st.get("templates", ())),
        "state_nodes": list(st.get("state_nodes", ())),
        "state_revs": {str(k): str(v)
                       for k, v in st.get("state_revs", {}).items()},
        "daemonset": list(st.get("daemonset", ())),
        "ds_token": str(st.get("ds_token", "")),
        "cluster": st.get("cluster"),
        "cluster_token": str(st.get("cluster_token", "")),
        "topo_revision": int(st.get("topo_revision", 0)),
        "last_req_seq": int(st.get("last_req_seq", 0)),
        "responses": [[k, len(v)] for k, v in responses],
        "counters": {k: int(st.get("counters", {}).get(k, 0))
                     for k in ("solves", "resyncs", "dedup_hits")},
        "digest": str(st.get("digest", "")),
    }
    blobs = {
        "row_tid": wire.pack_u32([r[0] for r in rows]),
        "row_ts": wire.pack_f64([r[1] for r in rows]),
        "bootstrap": bytes(st["bootstrap"]),
    }
    if responses:
        blobs["responses"] = b"".join(v for _k, v in responses)
    return wire.pack(header, blobs)


def decode_session_checkpoint(data: bytes) -> dict:
    """Parse + verify one checkpoint frame back into the session-state
    dict shape encode_session_checkpoint consumed. Loud rejects: ValueError
    on truncation/bad framing/missing fields, CheckpointVersionError on an
    unknown `ckpt` version, DeltaVersionError on a delta-wire skew, and
    DigestMismatchError when the recomputed state digest disagrees with
    the frame's — a corrupt checkpoint must never become a live session."""
    from . import wire
    try:
        header, blobs = wire.unpack(data)
    except ValueError:
        raise
    except Exception as e:
        raise ValueError(f"truncated or corrupt checkpoint frame: {e}")
    if header.get("kind") != CHECKPOINT_KIND:
        raise ValueError(
            f"not a session checkpoint frame (kind={header.get('kind')!r})")
    check_checkpoint_version(header)
    check_delta_version(header)
    for key in ("session", "templates", "state_nodes", "state_revs",
                "daemonset", "ds_token", "cluster_token", "topo_revision",
                "last_req_seq", "digest"):
        if key not in header:
            raise ValueError(f"checkpoint frame missing field {key!r}")
    for blob in ("row_tid", "row_ts", "bootstrap"):
        if blob not in blobs:
            raise ValueError(f"checkpoint frame missing blob {blob!r}")
    tids = wire.unpack_u32(blobs["row_tid"]).tolist()
    tss = [float(x) for x in wire.unpack_f64(blobs["row_ts"]).tolist()]
    if len(tids) != len(tss):
        raise ValueError(
            f"checkpoint row columns disagree ({len(tids)} template ids, "
            f"{len(tss)} timestamps)")
    n_templates = len(header["templates"])
    for tid in tids:
        if tid >= n_templates:
            raise ValueError(
                f"checkpoint pod row references template {tid} but the "
                f"table has {n_templates} entries")
    buf = bytes(blobs.get("responses", b""))
    responses, off = [], 0
    for item in header.get("responses", ()):
        k, n = str(item[0]), int(item[1])
        responses.append((k, buf[off:off + n]))
        off += n
    if off != len(buf):
        raise ValueError(
            f"checkpoint response-cache blob length mismatch (offsets "
            f"cover {off} bytes, blob has {len(buf)})")
    # the content-digest handshake, applied to the restore: the frame's
    # digest must recompute from the restored parts byte-for-byte, exactly
    # as the client's next delta solve will expect
    keys = [template_content_key(d) for d in header["templates"]]
    digest = batch_digest(tids, tss, templates_digest(keys),
                          header["state_revs"], header["ds_token"],
                          header["cluster_token"])
    want = str(header.get("digest", ""))
    if want and digest != want:
        raise DigestMismatchError(
            f"checkpoint digest mismatch (frame {want[:12]}.. != restored "
            f"{digest[:12]}..): refusing to resurrect a corrupt session")
    return {
        "session": str(header["session"]),
        "tenant": str(header.get("tenant", "")),
        "templates": list(header["templates"]),
        "rows": list(zip(tids, tss)),
        "state_nodes": list(header["state_nodes"]),
        "state_revs": dict(header["state_revs"]),
        "daemonset": list(header["daemonset"]),
        "ds_token": str(header["ds_token"]),
        "cluster": header.get("cluster"),
        "cluster_token": str(header["cluster_token"]),
        "topo_revision": int(header["topo_revision"]),
        "last_req_seq": int(header["last_req_seq"]),
        "responses": responses,
        "counters": dict(header.get("counters", {})),
        "digest": want or digest,
        "bootstrap": bytes(blobs["bootstrap"]),
    }
