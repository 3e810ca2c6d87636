"""DecisionRecord schema + codec.

A record is one JSON object per JSONL line:

    {"v": 1, "kind": "provisioning" | "disruption", "at": ..., "elapsed": ...,
     "meta": {...},          # kind-specific context (never needed for replay)
     "decision": {...},      # canonical digest of what the solver decided
     "solve": {...}}         # the full solver inputs, sidecar-codec encoded

The `solve` payload reuses the sidecar wire codec (sidecar/codec.py) — the
one place that already serializes exactly what `Scheduler.Solve` consumes
(nodepools, instance-type catalog, pod batch, state-node views, daemonset
pods, topology cluster view) — so the recorder can never drift from what the
solver actually reads. `decision` is the byte-comparison target for replay:
two solves of the same inputs must produce the identical digest.

Versioning: `v` is bumped on any breaking schema change; readers reject
unknown versions loudly (TraceVersionError) instead of misparsing — a trace
is evidence, and silently wrong evidence is worse than none.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Optional, Tuple

from ..api import labels as api_labels

SCHEMA_VERSION = 1
SUPPORTED_VERSIONS = (1,)


class TraceVersionError(ValueError):
    """The trace was written by an incompatible schema version."""


# -- solve payload (sidecar-codec reuse) ------------------------------------


def encode_solve_payload(nodepools, instance_types, pods, state_nodes=(),
                         daemonset_pods=(), cluster=None, store=None) -> dict:
    """The JSON-able solver-input snapshot: the sidecar solve-request payload
    shape (codec.encode_solve_request) as a dict. Pod identities (names,
    uids, timestamps) are preserved — replay diffs decisions by pod name —
    but node_name is normalized to "": the batch was *pending* at solve
    time, and the provisioner binds pods in place afterwards, so a deferred
    encode must not leak post-decision bindings into the recorded inputs."""
    from ..sidecar import codec
    catalog: Dict[str, dict] = {}
    per_pool: Dict[str, List[str]] = {}
    for pool, its in instance_types.items():
        per_pool[pool] = [it.name for it in its]
        for it in its:
            if it.name not in catalog:
                catalog[it.name] = codec.instance_type_to_dict(it)
    batch = codec.encode_pod_batch(pods)
    for row in batch["rows"]:
        row[3] = ""
    cview = (codec.cluster_view_to_dict(cluster, pods)
             if cluster is not None else None)
    if cview is not None:
        # the batch was PENDING at solve time, so none of its pods counted
        # as existing topology occupancy — but a deferred encode can see
        # them in the live cluster view after the provisioner binds them.
        # Drop them, or replay would count the batch against itself.
        batch_uids = {row[1] for row in batch["rows"]}
        cview["pods"] = [p for p in cview["pods"]
                         if p["uid"] not in batch_uids]
        cview["anti_affinity_uids"] = [
            uid for uid in cview["anti_affinity_uids"]
            if uid not in batch_uids]
    return {
        "nodepools": [codec.nodepool_to_dict(np_) for np_ in nodepools],
        "catalog": list(catalog.values()),
        "pool_instance_types": per_pool,
        "pods": batch,
        "state_nodes": [codec.state_node_to_dict(sn, store)
                        for sn in state_nodes],
        "daemonset_pods": [codec.pod_to_dict(p) for p in daemonset_pods],
        "cluster": cview,
    }


def decode_solve_payload(d: dict):
    """Rebuild the solver inputs from a recorded payload. Returns
    (nodepools, instance_types, pods, state_nodes, daemonset_pods,
    cluster_view) — the TensorScheduler constructor signature."""
    from ..sidecar import codec
    catalog = {it["name"]: codec.instance_type_from_dict(it)
               for it in d["catalog"]}
    instance_types = {pool: [catalog[n] for n in names]
                      for pool, names in d["pool_instance_types"].items()}
    return (
        [codec.nodepool_from_dict(np_) for np_ in d["nodepools"]],
        instance_types,
        codec.decode_pod_batch(d["pods"]),
        [codec.WireStateNode(sn) for sn in d["state_nodes"]],
        [codec.pod_from_dict(p) for p in d["daemonset_pods"]],
        codec.WireClusterView(d.get("cluster")),
    )


# -- decision digest --------------------------------------------------------


def _it_sig(its, memo: dict) -> list:
    """Compact signature of a claim's surviving instance-type options:
    [count, cheapest name, md5 of the full ordered name list]. The options
    list is interned per cohort (tensor_scheduler order_cache), so the memo
    keys by identity and the digest stays O(claims), not O(claims x types)."""
    sig = memo.get(id(its))
    if sig is None:
        names = [it.name for it in its]
        sig = [len(names), names[0] if names else "",
               hashlib.md5(",".join(names).encode()).hexdigest()[:12]]
        memo[id(its)] = sig
    return sig


def decision_digest(results, pods, fallback_reason: str = "",
                    partition: Optional[Tuple[int, int]] = None,
                    errors: Optional[Dict[str, str]] = None) -> dict:
    """Canonical, order-independent digest of one solve's decision: launch
    claims as sorted [nodepool, zones, n_its, cheapest_it, its_md5, fill]
    rows, existing-node placements as sorted [node, fill], errors by
    namespace/name (uids are synthetic on some paths; names survive
    replay, and the namespace qualifier keeps same-named pods in distinct
    namespaces from collapsing into one entry). Both the tensor and host
    Results shapes digest through this one function.

    `errors` overrides results.pod_errors — the recorder snapshots the
    error dict at capture time and digests lazily (the per-claim option-
    list hashing is too expensive for the <=5% headline solve budget)."""
    memo: dict = {}
    claims = []
    for nc in results.new_nodeclaims:
        zr = nc.requirements.get(api_labels.LABEL_TOPOLOGY_ZONE)
        claims.append([nc.template.nodepool_name, sorted(zr.values)]
                      + _it_sig(nc.instance_type_options, memo)
                      + [len(nc.pods)])
    claims.sort()
    existing = sorted([en.name, len(en.pods)]
                      for en in results.existing_nodes if en.pods)
    if errors is None:
        errors = results.pod_errors
    by_uid = {p.uid: f"{p.namespace}/{p.metadata.name}" for p in pods}
    errors = {by_uid.get(uid, uid): msg
              for uid, msg in sorted(errors.items())}
    return {
        "claims": claims,
        "existing": existing,
        "errors": errors,
        "fallback_reason": fallback_reason,
        "partition": list(partition) if partition is not None else None,
    }


def replacement_digest(nc) -> list:
    """Claim-shape digest for a disruption command's replacement launches."""
    return [nc.template.nodepool_name] + _it_sig(nc.instance_type_options, {}) \
        + [len(nc.pods)]


# -- line codec -------------------------------------------------------------


def dumps_record(rec: dict) -> str:
    return json.dumps(rec, separators=(",", ":"))


def loads_record(line: str) -> dict:
    rec = json.loads(line)
    v = rec.get("v")
    if v not in SUPPORTED_VERSIONS:
        raise TraceVersionError(
            f"flight record schema v{v!r} is not supported by this build "
            f"(reads {list(SUPPORTED_VERSIONS)}); re-record the trace or "
            "replay it with a matching build")
    return rec


def load_trace(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(loads_record(line))
            except TraceVersionError:
                raise
            except ValueError as e:
                raise ValueError(f"{path}:{i + 1}: not a flight record: {e}")
    return out
