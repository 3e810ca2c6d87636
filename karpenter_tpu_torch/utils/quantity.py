"""Kubernetes-style resource quantity parsing and formatting.

All quantities are held as exact integers in *milliunits* (1 unit == 1000 milli),
mirroring how apimachinery's resource.Quantity canonicalizes to milli scale. This
keeps host-side arithmetic exact (no float drift when summing "100m" cpu requests)
while staying trivially convertible to the scaled int32 tensors the TPU kernels use.

Reference behavior: k8s.io/apimachinery resource.Quantity as used throughout
karpenter (e.g. pkg/utils/resources/resources.go).
"""

from __future__ import annotations

import math
import re
from fractions import Fraction

# Binary suffixes (powers of 1024) and decimal suffixes (powers of 1000).
_BINARY = {"Ki": 1024, "Mi": 1024**2, "Gi": 1024**3, "Ti": 1024**4, "Pi": 1024**5, "Ei": 1024**6}
_DECIMAL = {
    "n": Fraction(1, 10**9), "u": Fraction(1, 10**6), "m": Fraction(1, 10**3), "": 1,
    "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15, "E": 10**18,
}

_QTY_RE = re.compile(r"^([+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)\s*([A-Za-z]*)$")


def parse(value: "int | float | str") -> int:
    """Parse a quantity into integer milliunits. "100m" -> 100, "1" -> 1000, "1Gi" -> 1073741824000."""
    if isinstance(value, bool):
        raise ValueError(f"invalid quantity {value!r}")
    if isinstance(value, int):
        return value * 1000
    if isinstance(value, float):
        return math.ceil(value * 1000)
    m = _QTY_RE.match(value.strip())
    if not m:
        raise ValueError(f"invalid quantity {value!r}")
    num_s, suffix = m.groups()
    if suffix in _BINARY:
        scale = _BINARY[suffix] * 1000
    elif suffix in _DECIMAL:
        scale = _DECIMAL[suffix] * 1000
    else:
        raise ValueError(f"invalid quantity suffix {suffix!r} in {value!r}")
    # Exact arithmetic throughout; fractional milli rounds up (k8s canonicalizes
    # sub-milli to the next milli for cpu-style resources).
    if "e" in num_s or "E" in num_s:
        num = Fraction(num_s)
    elif "." in num_s:
        whole, frac = num_s.split(".")
        sign = -1 if whole.startswith("-") else 1
        whole = whole.lstrip("+-") or "0"
        num = sign * Fraction(int(whole) * 10 ** len(frac) + int(frac), 10 ** len(frac))
    else:
        num = Fraction(int(num_s))
    return math.ceil(num * scale)


def format_milli(milli: int) -> str:
    """Render milliunits back to a human string ("1500m" style for fractional, plain int otherwise)."""
    if milli % 1000 == 0:
        return str(milli // 1000)
    return f"{milli}m"


def to_unit_float(milli: int) -> float:
    """Milliunits -> float units (for pricing/metrics, not for fits checks)."""
    return milli / 1000.0
