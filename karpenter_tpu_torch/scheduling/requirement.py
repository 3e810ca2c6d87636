"""Single-key constraint as a set-or-complement with integer bounds.

Semantics mirror karpenter's pkg/scheduling/requirement.go:
- In {v...}       -> finite value set (complement=False)
- NotIn {v...}    -> complement set (complement=True, values = excluded)
- Exists          -> complement set with no exclusions
- DoesNotExist    -> empty finite set
- Gt/Lt n         -> complement set with integer bounds (requirement.go:63-83)
- MinValues       -> flexibility floor carried through intersections

Length of a complement set is "infinite" (reference uses MaxInt64,
requirement.go:237-242); we use the INF sentinel.
"""

from __future__ import annotations

import random
from typing import Iterable, Optional

from ..api import labels as api_labels

INF = 2**63 - 1

IN = "In"
NOT_IN = "NotIn"
EXISTS = "Exists"
DOES_NOT_EXIST = "DoesNotExist"
GT = "Gt"
LT = "Lt"


class Requirement:
    __slots__ = ("key", "complement", "values", "greater_than", "less_than", "min_values")

    def __init__(self, key: str, operator: str, values: Iterable[str] = (),
                 min_values: Optional[int] = None):
        key = api_labels.NORMALIZED_LABELS.get(key, key)
        self.key = key
        self.min_values = min_values
        self.greater_than: Optional[int] = None
        self.less_than: Optional[int] = None
        values = list(values)
        if operator == IN:
            self.complement = False
            self.values = set(values)
        elif operator == DOES_NOT_EXIST:
            self.complement = False
            self.values = set()
        elif operator == NOT_IN:
            self.complement = True
            self.values = set(values)
        elif operator == EXISTS:
            self.complement = True
            self.values = set()
        elif operator == GT:
            self.complement = True
            self.values = set()
            self.greater_than = int(values[0])
        elif operator == LT:
            self.complement = True
            self.values = set()
            self.less_than = int(values[0])
        else:
            raise ValueError(f"unknown operator {operator!r}")

    @classmethod
    def _raw(cls, key: str, complement: bool, values: set, greater_than=None,
             less_than=None, min_values=None) -> "Requirement":
        r = cls.__new__(cls)
        r.key = key
        r.complement = complement
        r.values = values
        r.greater_than = greater_than
        r.less_than = less_than
        r.min_values = min_values
        return r

    # --- set algebra -------------------------------------------------------

    def intersection(self, other: "Requirement") -> "Requirement":
        """requirement.go:155-188. Note: bounds merge via max/min; crossed bounds
        collapse to DoesNotExist; concrete (non-complement) results drop bounds."""
        complement = self.complement and other.complement
        greater_than = _max_opt(self.greater_than, other.greater_than)
        less_than = _min_opt(self.less_than, other.less_than)
        min_values = _max_opt(self.min_values, other.min_values)
        if greater_than is not None and less_than is not None and greater_than >= less_than:
            return Requirement(self.key, DOES_NOT_EXIST, min_values=min_values)

        if self.complement and other.complement:
            values = self.values | other.values
        elif self.complement and not other.complement:
            values = other.values - self.values
        elif not self.complement and other.complement:
            values = self.values - other.values
        else:
            values = self.values & other.values
        values = {v for v in values if _within(v, greater_than, less_than)}
        if not complement:
            greater_than, less_than = None, None
        return Requirement._raw(self.key, complement, values, greater_than, less_than, min_values)

    def has(self, value: str) -> bool:
        """requirement.go:209-214."""
        if self.complement:
            return value not in self.values and _within(value, self.greater_than, self.less_than)
        return value in self.values and _within(value, self.greater_than, self.less_than)

    def insert(self, *values: str) -> None:
        self.values.update(values)

    def operator(self) -> str:
        """requirement.go:224-235."""
        if self.complement:
            return NOT_IN if self.values else EXISTS
        return IN if self.values else DOES_NOT_EXIST

    def __len__(self) -> int:
        raise TypeError("use .length() — complement sets have infinite length")

    def length(self) -> int:
        if self.complement:
            return INF - len(self.values)
        return len(self.values)

    def any_value(self) -> str:
        """A representative allowed value (requirement.go:190-206). Used when
        materializing labels for a launched node."""
        op = self.operator()
        if op == IN:
            return min(self.values)  # deterministic where reference is random
        if op in (NOT_IN, EXISTS):
            lo = 0 if self.greater_than is None else self.greater_than + 1
            hi = (1 << 31) if self.less_than is None else self.less_than
            for _ in range(64):
                v = str(random.randrange(lo, hi))
                if v not in self.values:
                    return v
            return str(hi - 1)
        return ""

    def values_list(self) -> "list[str]":
        return sorted(self.values)

    def __eq__(self, other):
        if not isinstance(other, Requirement):
            return NotImplemented
        return (self.key == other.key and self.complement == other.complement
                and self.values == other.values and self.greater_than == other.greater_than
                and self.less_than == other.less_than and self.min_values == other.min_values)

    def __hash__(self):
        return hash((self.key, self.complement, frozenset(self.values),
                     self.greater_than, self.less_than, self.min_values))

    def __repr__(self) -> str:
        op = self.operator()
        if op in (EXISTS, DOES_NOT_EXIST):
            s = f"{self.key} {op}"
        else:
            vals = self.values_list()
            if len(vals) > 5:
                vals = vals[:5] + [f"and {len(self.values) - 5} others"]
            s = f"{self.key} {op} {vals}"
        if self.greater_than is not None:
            s += f" >{self.greater_than}"
        if self.less_than is not None:
            s += f" <{self.less_than}"
        if self.min_values is not None:
            s += f" minValues {self.min_values}"
        return s


def _within(value: str, greater_than: Optional[int], less_than: Optional[int]) -> bool:
    """requirement.go:268-284 — with bounds set, non-integer values are invalid."""
    if greater_than is None and less_than is None:
        return True
    try:
        v = int(value)
    except (TypeError, ValueError):
        return False
    if greater_than is not None and greater_than >= v:
        return False
    if less_than is not None and less_than <= v:
        return False
    return True


def _max_opt(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return max(a, b)


def _min_opt(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return min(a, b)
