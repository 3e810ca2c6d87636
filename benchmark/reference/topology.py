"""The scheduling rules a solve's placements must keep, checked over the
locations the program chose: new claims (zones they are pinned to, or None
for any) and existing nodes (their zone). Plain Python and NumPy."""

from __future__ import annotations

import numpy as np

# the benchmark's own table of what each deployment kind asks
from ..spec import constraints as _constraints


def violations(deps: list, zones: list, locations: list) -> int:
    """Placements that break a deployment's spread or affinity.
    ``locations``: (kind, key, zones or None, counts [D]) for every claim
    and every existing node that took pods."""
    bad = 0
    for d, dep in enumerate(deps):
        rule = _constraints(dep["kind"])
        at = [(zs, int(c[d])) for _, _, zs, c in locations if c[d] > 0]
        if not at:
            continue
        if rule["one_per_host"]:
            bad += sum(n - 1 for _, n in at if n > 1)
        if rule["one_host"] and len(at) > 1:
            bad += len(at) - 1
        if rule["one_zone"]:
            common = set(zones)
            for zs, _ in at:
                common &= set(zones if zs is None else zs)
            bad += 0 if common else 1
        spread = rule["zone_spread"]
        if spread is not None and spread["self"]:
            per_zone = dict.fromkeys(zones, 0)
            for zs, n in at:
                if zs is None or len(zs) != 1 or zs[0] not in per_zone:
                    bad += n
                else:
                    per_zone[zs[0]] += n
            skew = max(per_zone.values()) - min(per_zone.values())
            bad += max(0, skew - spread["max_skew"])
    return bad


def unexplained_errors(cat, deps: list, req: np.ndarray, errors: dict,
                       dep_of: dict, locations: list, claims: list,
                       room) -> int:
    """Pod errors no rule explains. A hostname affinity's pods may fail
    once the one node that holds them can take no more; any other pod
    fails only where no type can hold it at all."""
    from .solve_check import TYPE_LABELS
    failing = {}
    for p in errors:
        if p in dep_of:
            failing[dep_of[p]] = failing.get(dep_of[p], 0) + 1
    bad = 0
    for d, n in failing.items():
        one = req[d]
        fits_fresh = bool(np.any(np.all(cat.alloc >= one[None, :], axis=1)))
        if not _constraints(deps[d]["kind"])["one_host"]:
            bad += n if fits_fresh else 0
            continue
        at = [(kind, key, c) for kind, key, _, c in locations if c[d] > 0]
        if not at:
            bad += n if fits_fresh else 0
            continue
        kind, key, counts = at[0]
        total = counts @ req + one
        if kind == "node":
            bad += n if np.all(room[key] >= total) else 0
            continue
        claim = claims[key]
        labels = {k: set(v) for k, v in claim["requirements"].items()
                  if k in TYPE_LABELS}
        if cat.options(total, claim["zones"], claim["capacity_types"],
                       labels):
            bad += n
    return bad
