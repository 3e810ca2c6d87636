"""Admission-time validation for the in-process store.

The reference's apiserver rejects malformed NodePools/NodeClaims via the
CRD schema (CEL rules + kubebuilder markers, karpenter's pkg/apis/v1/
{nodepool,nodeclaim}.go) and the Go-side webhook battery
(nodeclaim_validation.go:1-151). DEVIATIONS #6 makes the store the API
server, so the same rules run here on create/update — a malformed object
must never reach the controllers.

Caveat (DEVIATIONS #12): the in-process store hands out LIVE references,
so a caller that mutates a fetched object in place has already changed
the stored state before update() can validate — the analog of editing
etcd directly, which no apiserver can prevent either. Admission still
rejects the update (no resourceVersion bump, no watch event — the
mutation never propagates through legitimate channels), and the runtime
validation controller (nodepool_aux.NodePoolValidation) flags whatever
slips through. Replacement-object updates — the wire-shaped
path a real client uses — get full validation including NodeClaim spec
immutability.
"""

from __future__ import annotations

import re
from typing import List, Optional

from ..api import validation as v
from ..utils import cron

# nodepool.go:101 — budget nodes: absolute count or 0-100%
_BUDGET_NODES_RE = re.compile(r"^((100|[0-9]{1,2})%|[0-9]+)$")


def _validate_schema_requirements(reqs, forbid_nodepool_key=False) -> List[str]:
    """The CRD schema's admission checks for a requirements list
    (karpenter.sh_nodepools.yaml requirement schema): key pattern +
    restricted-domain CEL, operator enum, value shape, the In/Gt-Lt/
    minValues CEL rules, Exists/DoesNotExist-forbids-values, minValues
    1..50. validate_requirement covers the battery's shared subset; what
    it does NOT cover here (duplicate taints) is deliberately runtime-only
    — the nodepool validation controller's job, not the apiserver's."""
    from ..api import labels as api_labels
    errs: List[str] = []
    for r in reqs:
        errs += v.validate_requirement(r)
        if r.operator in ("Exists", "DoesNotExist") and list(r.values):
            errs.append(f"key {r.key}: operator {r.operator} forbids values")
        mv = getattr(r, "min_values", None)
        if mv is not None and not (1 <= mv <= 50):
            errs.append(f"key {r.key}: minValues must be between 1 and 50")
        # NodePool-CRD-only CEL beyond the Go battery
        # (karpenter.sh_nodepools.yaml): a user may not pin the nodepool
        # label in a template; NodeClaims legitimately carry it (the
        # nodeclaim CRD has no such rule — Karpenter stamps it itself)
        if forbid_nodepool_key and r.key == api_labels.NODEPOOL_LABEL_KEY:
            errs.append(f'label "{api_labels.NODEPOOL_LABEL_KEY}" is '
                        "restricted")
    return errs


def _validate_taint_shapes(taints, startup_taints=()) -> List[str]:
    """Schema-level taint checks (key pattern, value shape, effect enum).
    Duplicate Key/Effect detection is NOT schema-expressible and stays a
    runtime-validation concern (nodepool_aux.NodePoolValidation)."""
    errs: List[str] = []
    for field_name, group in (("taints", taints),
                              ("startupTaints", startup_taints)):
        for t in group:
            if not t.key:
                errs.append(f"invalid value: empty key in {field_name}")
            else:
                for e in v.is_qualified_name(t.key):
                    errs.append(f"invalid value: {e} in {field_name}")
            if t.value:
                for e in v.is_valid_label_value(t.value):
                    errs.append(f"invalid value: {e} in {field_name}")
            if t.effect not in v.SUPPORTED_TAINT_EFFECTS:
                errs.append(f"invalid value: {t.effect!r} in {field_name}")
    return errs


def validate_nodepool(np, old=None) -> List[str]:
    spec = np.spec
    tmpl = spec.template.spec
    errs = _validate_schema_requirements(tmpl.requirements,
                                         forbid_nodepool_key=True)
    errs += _validate_taint_shapes(tmpl.taints, tmpl.startup_taints)
    if len(tmpl.requirements) > 100:
        errs.append("spec.template.spec.requirements: may not have more "
                    "than 100 items")  # nodeclaim.go:179 MaxItems
    if spec.weight is not None and not (1 <= spec.weight <= 100):
        errs.append(f"spec.weight: {spec.weight} must be between 1 and 100")
    budgets = spec.disruption.budgets
    if len(budgets) > 50:
        errs.append("spec.disruption.budgets: may not have more than 50 "
                    "items")  # nodepool.go:81 MaxItems
    from ..api.nodepool import (REASON_DRIFTED, REASON_EMPTY,
                                REASON_UNDERUTILIZED)
    allowed_reasons = {REASON_UNDERUTILIZED, REASON_EMPTY, REASON_DRIFTED}
    for i, b in enumerate(budgets):
        if not _BUDGET_NODES_RE.match(str(b.nodes)):
            errs.append(f"spec.disruption.budgets[{i}].nodes: {b.nodes!r} "
                        "must be an absolute count or a 0-100 percent")
        # nodepool.go:79 — 'schedule' must be set with 'duration'
        if (b.schedule is None) != (b.duration is None):
            errs.append(f"spec.disruption.budgets[{i}]: 'schedule' must be "
                        "set with 'duration'")
        if b.schedule is not None:
            try:
                cron.Schedule(b.schedule)
            except Exception:
                errs.append(f"spec.disruption.budgets[{i}].schedule: "
                            f"{b.schedule!r} is not a valid cron schedule")
        if b.reasons is not None:
            for reason in b.reasons:
                if reason not in allowed_reasons:
                    errs.append(
                        f"spec.disruption.budgets[{i}].reasons: {reason!r} "
                        f"is not one of {sorted(allowed_reasons)}")
        if b.duration is not None and b.duration < 0:
            errs.append(f"spec.disruption.budgets[{i}].duration: must be "
                        "non-negative")
    if tmpl.expire_after is not None and tmpl.expire_after < 0:
        errs.append("spec.template.spec.expireAfter: must be non-negative "
                    "(or Never)")
    if tmpl.termination_grace_period is not None \
            and tmpl.termination_grace_period < 0:
        errs.append("spec.template.spec.terminationGracePeriod: must be "
                    "non-negative")
    if spec.disruption.consolidate_after is not None \
            and spec.disruption.consolidate_after < 0:
        errs.append("spec.disruption.consolidateAfter: must be non-negative "
                    "or Never")
    for name, qty in spec.limits.items():
        for e in v.is_qualified_name(name):
            errs.append(f"spec.limits key {name!r}: {e}")
    return errs


def validate_nodeclaim(nc, old=None) -> List[str]:
    spec = nc.spec
    errs = _validate_schema_requirements(spec.requirements)
    errs += _validate_taint_shapes(spec.taints, spec.startup_taints)
    if len(spec.requirements) > 100:
        errs.append("spec.requirements: may not have more than 100 items")
    if spec.termination_grace_period is not None \
            and spec.termination_grace_period < 0:
        errs.append("spec.terminationGracePeriod: must be non-negative")
    if spec.expire_after is not None and spec.expire_after < 0:
        errs.append("spec.expireAfter: must be non-negative (or Never)")
    # nodeclaim.go:143 — spec is immutable once created
    if old is not None and old.spec != spec:
        errs.append("spec: spec is immutable")
    return errs


def validate(obj, old=None) -> List[str]:
    """Dispatch by kind; unknown kinds are admitted (no schema here)."""
    from ..api.nodeclaim import NodeClaim
    from ..api.nodepool import NodePool
    if isinstance(obj, NodePool):
        return validate_nodepool(obj, old)
    if isinstance(obj, NodeClaim):
        return validate_nodeclaim(obj, old)
    return []
