"""Minimal standard 5-field cron schedule (UTC), with Next() semantics.

Used by disruption budget windows (reference: robfig/cron via
pkg/apis/v1/nodepool.go:353-367).
"""

from __future__ import annotations

import calendar
from datetime import datetime, timedelta, timezone

_ALIASES = {
    "@yearly": "0 0 1 1 *", "@annually": "0 0 1 1 *", "@monthly": "0 0 1 * *",
    "@weekly": "0 0 * * 0", "@daily": "0 0 * * *", "@midnight": "0 0 * * *",
    "@hourly": "0 * * * *",
}

_DOW_NAMES = {"sun": 0, "mon": 1, "tue": 2, "wed": 3, "thu": 4, "fri": 5, "sat": 6}
_MON_NAMES = {m.lower(): i for i, m in enumerate(calendar.month_abbr) if m}


class Schedule:
    def __init__(self, expr: str):
        expr = expr.strip()
        expr = _ALIASES.get(expr, expr)
        fields = expr.split()
        if len(fields) != 5:
            raise ValueError(f"invalid cron expression {expr!r}")
        self.minutes = _parse_field(fields[0], 0, 59)
        self.hours = _parse_field(fields[1], 0, 23)
        self.dom = _parse_field(fields[2], 1, 31, _MON_NAMES)
        self.months = _parse_field(fields[3], 1, 12, _MON_NAMES)
        self.dow = _parse_field(fields[4], 0, 6, _DOW_NAMES, dow=True)
        self.dom_star = fields[2] == "*"
        self.dow_star = fields[4] == "*"

    def matches(self, t: datetime) -> bool:
        if t.minute not in self.minutes or t.hour not in self.hours or t.month not in self.months:
            return False
        dom_ok = t.day in self.dom
        dow_ok = ((t.weekday() + 1) % 7) in self.dow  # python Mon=0 -> cron Sun=0
        # standard cron: if both dom and dow are restricted, either may match
        if not self.dom_star and not self.dow_star:
            return dom_ok or dow_ok
        return dom_ok and dow_ok

    def next(self, after: datetime) -> datetime:
        """First matching time strictly after `after` (minute granularity), UTC."""
        t = after.astimezone(timezone.utc).replace(second=0, microsecond=0) + timedelta(minutes=1)
        for _ in range(366 * 24 * 60):  # bounded scan: a year of minutes
            if self.matches(t):
                return t
            # skip forward coarsely when month/day/hour don't match
            if t.month not in self.months:
                if t.month == 12:
                    t = t.replace(year=t.year + 1, month=1, day=1, hour=0, minute=0)
                else:
                    t = t.replace(month=t.month + 1, day=1, hour=0, minute=0)
                continue
            dom_ok = t.day in self.dom
            dow_ok = ((t.weekday() + 1) % 7) in self.dow
            day_ok = (dom_ok or dow_ok) if (not self.dom_star and not self.dow_star) else (dom_ok and dow_ok)
            if not day_ok:
                t = (t + timedelta(days=1)).replace(hour=0, minute=0)
                continue
            if t.hour not in self.hours:
                t = (t + timedelta(hours=1)).replace(minute=0)
                continue
            t += timedelta(minutes=1)
        raise ValueError("no matching time found within a year")


def _parse_field(field: str, lo: int, hi: int, names=None, dow: bool = False) -> frozenset:
    out = set()
    for part in field.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
        if part == "*" or part == "?":
            start, end = lo, hi
        elif "-" in part and not part.lstrip("-").isdigit():
            a, b = part.split("-", 1)
            start, end = _val(a, names), _val(b, names)
        else:
            start = end = _val(part, names)
            if "/" in field and "-" not in field.split("/")[0] and field.split("/")[0] != "*":
                end = hi  # "5/2" means start at 5, every 2
        if dow:
            start, end = start % 7, end % 7  # cron allows 7 == Sunday
        if start > end:
            out.update(range(start, hi + 1), range(lo, end + 1))
        else:
            out.update(range(start, end + 1, step))
    return frozenset(out)


def _val(s: str, names) -> int:
    s = s.strip().lower()
    if names and s in names:
        return names[s]
    return int(s)
