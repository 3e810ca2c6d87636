"""Decision digest: a canonical, order-independent summary of one solve's
decision, for comparing two solves of the same inputs (the full flight
recorder with its replayable records is not carried by this package)."""

from __future__ import annotations

import hashlib
from typing import Dict, Optional, Tuple

from ..api import labels as api_labels


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
