"""NillableDuration: a duration that can be "Never".

Mirrors karpenter's pkg/apis/v1/duration.go. Values are seconds (float);
None means "Never".
"""

from __future__ import annotations

import re
from typing import Optional

_UNITS = {"ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0}
_PART = re.compile(r"([0-9]*\.?[0-9]+)(ns|us|µs|ms|s|m|h)")

NEVER = "Never"


def parse_duration(value: "str | float | int | None") -> Optional[float]:
    """Parse a Go-style duration ("10m", "1h30m") or "Never" (-> None)."""
    if value is None:
        return None
    if isinstance(value, (int, float)):
        return float(value)
    value = value.strip()
    if value == NEVER:
        return None
    if value in ("0", "+0", "-0"):
        return 0.0
    total = 0.0
    matched = "".join(m.group(0) for m in _PART.finditer(value))
    if matched != value.lstrip("+-"):
        raise ValueError(f"invalid duration {value!r}")
    for m in _PART.finditer(value):
        total += float(m.group(1)) * _UNITS[m.group(2)]
    return -total if value.startswith("-") else total


def format_duration(seconds: Optional[float]) -> str:
    if seconds is None:
        return NEVER
    if seconds == 0:
        return "0s"
    out = []
    rem = seconds
    for unit, mult in (("h", 3600.0), ("m", 60.0), ("s", 1.0)):
        if rem >= mult:
            n = int(rem // mult)
            out.append(f"{n}{unit}")
            rem -= n * mult
    return "".join(out) or f"{seconds}s"
