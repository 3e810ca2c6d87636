"""Requirement/taint validation battery.

Mirrors karpenter's pkg/apis/v1/nodeclaim_validation.go:1-151 — the
webhook-side rules that keep malformed NodeClaim template specs out of the
system: supported operators, restricted-label rejection, k8s qualified-name
and label-value syntax, In-needs-values, minValues sanity, Gt/Lt integer
form, taint shape + duplicate key/effect detection. Returned as error-string
lists (the multierr analog); empty list = valid."""

from __future__ import annotations

import re
from typing import Iterable, List, Optional

from . import labels as api_labels

SUPPORTED_NODE_SELECTOR_OPS = frozenset(
    {"In", "NotIn", "Gt", "Lt", "Exists", "DoesNotExist"})

SUPPORTED_TAINT_EFFECTS = frozenset(
    {"NoSchedule", "PreferNoSchedule", "NoExecute", ""})

# k8s.io/apimachinery/pkg/util/validation shapes
_NAME_RE = re.compile(r"^[A-Za-z0-9]([A-Za-z0-9\-_.]*[A-Za-z0-9])?$")
_DNS1123_SUBDOMAIN_RE = re.compile(
    r"^[a-z0-9]([a-z0-9\-]*[a-z0-9])?(\.[a-z0-9]([a-z0-9\-]*[a-z0-9])?)*$")


def is_qualified_name(key: str) -> List[str]:
    """validation.IsQualifiedName: [prefix/]name, name ≤63 chars of
    [A-Za-z0-9-_.] starting+ending alphanumeric, prefix a ≤253-char DNS
    subdomain."""
    errs: List[str] = []
    parts = key.split("/")
    if len(parts) > 2:
        return [f"a qualified name must consist of a name part and an "
                f"optional prefix: {key!r}"]
    if len(parts) == 2:
        prefix, name = parts
        if not prefix:
            errs.append("prefix part must be non-empty")
        elif len(prefix) > 253 or not _DNS1123_SUBDOMAIN_RE.match(prefix):
            errs.append(f"prefix part {prefix!r} must be a valid DNS subdomain")
    else:
        name = parts[0]
    if not name:
        errs.append("name part must be non-empty")
    elif len(name) > 63 or not _NAME_RE.match(name):
        errs.append(f"name part {name!r} must consist of alphanumeric "
                    "characters, '-', '_' or '.', and must start and end "
                    "with an alphanumeric character")
    return errs


def is_valid_label_value(value: str) -> List[str]:
    """validation.IsValidLabelValue: empty, or ≤63 chars matching the name
    shape."""
    if value == "":
        return []
    if len(value) > 63 or not _NAME_RE.match(value):
        return [f"a valid label value must be an empty string or consist of "
                f"alphanumeric characters, '-', '_' or '.', and must start "
                f"and end with an alphanumeric character: {value!r}"]
    return []


def validate_requirement(req) -> List[str]:
    """ValidateRequirement (nodeclaim_validation.go:113-151). `req` is any
    object with key/operator/values and optional min_values."""
    errs: List[str] = []
    key = api_labels.NORMALIZED_LABELS.get(req.key, req.key)
    op = req.operator
    values = list(req.values)
    min_values = getattr(req, "min_values", None)
    if op not in SUPPORTED_NODE_SELECTOR_OPS:
        errs.append(f"key {key} has an unsupported operator {op} not in "
                    f"{sorted(SUPPORTED_NODE_SELECTOR_OPS)}")
    restricted = api_labels.is_restricted_label(key)
    if restricted is not None:
        errs.append(restricted)
    for e in is_qualified_name(key):
        errs.append(f"key {key} is not a qualified name, {e}")
    for v in values:
        for e in is_valid_label_value(v):
            errs.append(f"invalid value {v} for key {key}, {e}")
    if op == "In" and not values:
        errs.append(f"key {key} with operator {op} must have a value defined")
    if op == "In" and min_values is not None and len(values) < min_values:
        errs.append(f"key {key} with operator {op} must have at least "
                    "minimum number of values defined in 'values' field")
    if op in ("Gt", "Lt"):
        # strconv.Atoi strictness (nodeclaim_validation.go:146): Python's
        # int() tolerates underscores/whitespace/Unicode digits and has no
        # int64 range, all of which Go rejects
        ok = len(values) == 1
        if ok:
            ok = (bool(re.fullmatch(r"[+-]?[0-9]+", values[0]))
                  and 0 <= int(values[0]) <= 2**63 - 1)
        if not ok:
            errs.append(f"key {key} with operator {op} must have a single "
                        "positive integer value")
    return errs


def validate_requirements(reqs: Iterable) -> List[str]:
    """validateRequirements (nodeclaim_validation.go:104-111)."""
    errs: List[str] = []
    for r in reqs:
        for e in validate_requirement(r):
            errs.append(f"invalid value: {e} in requirements, restricted")
    return errs


def validate_taints(taints: Iterable, startup_taints: Iterable = ()) -> List[str]:
    """validateTaints (nodeclaim_validation.go:62-101): shape checks plus
    duplicate key/effect detection spanning taints AND startupTaints."""
    errs: List[str] = []
    seen = set()
    for field_name, group in (("taints", taints),
                              ("startupTaints", startup_taints)):
        for t in group:
            if not t.key:
                errs.append(f"invalid value: empty key in {field_name}")
            else:
                for e in is_qualified_name(t.key):
                    errs.append(f"invalid value: {e} in {field_name}")
            if t.value:
                for e in is_valid_label_value(t.value):
                    errs.append(f"invalid value: {e} in {field_name}")
            if t.effect not in SUPPORTED_TAINT_EFFECTS:
                errs.append(f"invalid value: {t.effect!r} in {field_name}")
            pair = (t.key, t.effect)
            if pair in seen:
                errs.append(f"duplicate taint Key/Effect pair "
                            f"{t.key}={t.effect}")
            seen.add(pair)
    return errs


def validate_nodeclaim_template_spec(spec) -> List[str]:
    """The webhook's combined template-spec battery."""
    return validate_requirements(spec.requirements) + \
        validate_taints(spec.taints, spec.startup_taints)
