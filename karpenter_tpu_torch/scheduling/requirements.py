"""Keyed requirement sets with intersection-on-add and compatibility checks.

Mirrors karpenter's pkg/scheduling/requirements.go. The two load-bearing
operations used by both solvers:

- ``intersects`` (requirements.go:283-304): for every shared key the
  intersection must be non-empty, except when *both* sides' operators are in
  {NotIn, DoesNotExist}.
- ``compatible`` (requirements.go:175-187): ``intersects`` plus: keys the
  incoming side defines that this side does not are errors, unless the key is
  in the allow-undefined set (well-known labels) or the incoming operator is
  NotIn/DoesNotExist.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional

from ..api import labels as api_labels
from ..api.objects import Pod
from .requirement import (DOES_NOT_EXIST, EXISTS, IN, NOT_IN, Requirement)


class Requirements:
    __slots__ = ("_map",)

    def __init__(self, requirements: Iterable[Requirement] = ()):
        self._map: dict = {}
        self.add(*requirements)

    # --- container protocol ------------------------------------------------

    def __contains__(self, key: str) -> bool:
        return key in self._map

    def __iter__(self) -> Iterator[str]:
        return iter(self._map)

    def __len__(self) -> int:
        return len(self._map)

    def keys(self):
        return self._map.keys()

    def values(self) -> "list[Requirement]":
        return list(self._map.values())

    def get(self, key: str) -> Requirement:
        """Undefined keys behave as Exists (requirements.go:154-160)."""
        r = self._map.get(key)
        if r is None:
            return Requirement(key, EXISTS)
        return r

    def raw(self, key: str) -> Optional[Requirement]:
        return self._map.get(key)

    def delete(self, key: str) -> None:
        self._map.pop(key, None)

    def copy(self) -> "Requirements":
        out = Requirements()
        out._map = dict(self._map)
        return out

    # --- mutation ----------------------------------------------------------

    def add(self, *requirements: Requirement) -> None:
        """Per-key intersection on conflict (requirements.go:127-134)."""
        for req in requirements:
            existing = self._map.get(req.key)
            if existing is not None:
                req = req.intersection(existing)
            self._map[req.key] = req

    # --- checks ------------------------------------------------------------

    def intersects(self, incoming: "Requirements") -> "list[str]":
        """Returns error strings; empty list means compatible (requirements.go:283-304)."""
        errs = []
        small, large = (self, incoming) if len(self) <= len(incoming) else (incoming, self)
        for key in small._map:
            if key not in large._map:
                continue
            existing = self.get(key)
            inc = incoming.get(key)
            if existing.intersection(inc).length() == 0:
                if inc.operator() in (NOT_IN, DOES_NOT_EXIST) and \
                        existing.operator() in (NOT_IN, DOES_NOT_EXIST):
                    continue
                errs.append(f"key {key}, {inc!r} not in {existing!r}")
        return errs

    def compatible(self, incoming: "Requirements",
                   allow_undefined: frozenset = frozenset()) -> "list[str]":
        """requirements.go:175-187; unknown keys carry a near-miss hint
        (requirements.go:232-251)."""
        errs = []
        for key in incoming._map:
            if key in allow_undefined:
                continue
            op = incoming.get(key).operator()
            if key in self._map or op in (NOT_IN, DOES_NOT_EXIST):
                continue
            errs.append(f'label "{key}" does not have known values'
                        f'{label_hint(self, key, allow_undefined)}')
        errs.extend(self.intersects(incoming))
        return errs

    def is_compatible(self, incoming: "Requirements",
                      allow_undefined: frozenset = frozenset()) -> bool:
        return not self.compatible(incoming, allow_undefined)

    def has_min_values(self) -> bool:
        return any(r.min_values is not None for r in self._map.values())

    def labels(self) -> dict:
        """Representative labels for a node satisfying these requirements
        (requirements.go:306-316); restricted node labels are skipped."""
        out = {}
        for key, req in self._map.items():
            if api_labels.is_restricted_node_label(key):
                continue
            v = req.any_value()
            if v:
                out[key] = v
        return out

    def __repr__(self) -> str:
        parts = sorted(repr(r) for k, r in self._map.items()
                       if k not in api_labels.RESTRICTED_LABELS)
        return ", ".join(parts)


def edit_distance(s: str, t: str) -> int:
    """The reference's editDistance (requirements.go:190-226, a DPV-style
    two-row DP) transcribed EXACTLY — including its quirks: iteration from
    index 1 and a current-row first cell that is never set to i, so
    deleting a prefix of `s` costs 0. Not true Levenshtein, deliberately:
    the < len/5 hint threshold was tuned against this function's outputs,
    and "fixing" it would change which labels get hints."""
    m, n = len(s), len(t)
    if m == 0:
        return n
    if n == 0:
        return m
    prev = [0] * n
    cur = [0] * n
    for j in range(1, n):
        prev[j] = j
    for i in range(1, m):
        for j in range(1, n):
            diff = 0 if s[i] == t[j] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + diff)
        prev, cur = cur, prev
    return prev[n - 1]


def _suffix(key: str) -> str:
    """requirements.go:228-231 getSuffix: the part after the first '/'."""
    before, sep, after = key.partition("/")
    return after if sep else before


def label_hint(r: "Requirements", key: str,
               allowed_undefined=frozenset()) -> str:
    """requirements.go:233-251 labelHint: suggest the well-known (or
    already-required) key the user probably meant — substring containment,
    edit distance under a fifth of the target length, or a shared suffix."""
    for pool in (allowed_undefined, r._map):
        for known in sorted(pool):  # deterministic (Go ranges a map)
            if key in known or edit_distance(key, known) < len(known) // 5:
                return f' (typo of "{known}"?)'
            if known.endswith(_suffix(key)):
                return f' (typo of "{known}"?)'
    return ""


ALLOW_UNDEFINED_WELL_KNOWN = api_labels.WELL_KNOWN_LABELS


def label_requirements(labels: dict) -> Requirements:
    """requirements.go:64-71."""
    return Requirements(Requirement(k, IN, [v]) for k, v in labels.items())


def node_selector_requirements(exprs, min_values_map=None) -> Requirements:
    """Build from NodeSelectorRequirement-shaped objects (requirements.go:47-62)."""
    out = Requirements()
    for e in exprs:
        mv = getattr(e, "min_values", None)
        out.add(Requirement(e.key, e.operator, e.values, min_values=mv))
    return out


def pod_requirements(pod: Pod) -> Requirements:
    """NewPodRequirements: node selector + FIRST required node-affinity term +
    heaviest preferred term treated as required (requirements.go:90-110).
    The relaxation ladder later strips these if the pod can't schedule."""
    return _pod_requirements(pod, include_preferred=True)


def strict_pod_requirements(pod: Pod) -> Requirements:
    """Required constraints only (requirements.go:79-81)."""
    return _pod_requirements(pod, include_preferred=False)


def _pod_requirements(pod: Pod, include_preferred: bool) -> Requirements:
    reqs = label_requirements(pod.spec.node_selector)
    aff = pod.spec.affinity
    if aff is None or aff.node_affinity is None:
        return reqs
    na = aff.node_affinity
    if include_preferred and na.preferred:
        heaviest = max(na.preferred, key=lambda p: p.weight)
        reqs.add(*node_selector_requirements(heaviest.preference.match_expressions).values())
    if na.required_terms:
        reqs.add(*node_selector_requirements(na.required_terms[0].match_expressions).values())
    return reqs


def has_preferred_node_affinity(pod: Pod) -> bool:
    aff = pod.spec.affinity
    return (aff is not None and aff.node_affinity is not None
            and len(aff.node_affinity.preferred) > 0)
