"""Node helpers (karpenter's pkg/utils/node/node.go)."""

from __future__ import annotations

from typing import Optional, Tuple


def set_condition(node, ctype: str, status: str, now: float = 0.0) -> None:
    """Replace-by-type (apiserver semantics: one condition per type).
    Appending a second entry of the same type would be unrepresentable in
    Kubernetes and silently masked by get_condition."""
    node.status.conditions = [
        c for c in node.status.conditions
        if (c.get("type") if isinstance(c, dict) else c.type) != ctype]
    node.status.conditions.append(
        {"type": ctype, "status": status, "last_transition_time": now})


def get_condition(node, ctype: str) -> Optional[Tuple[str, float]]:
    """(status, lastTransitionTime) of a node condition; conditions may be
    dicts (codec/test-seeded) or objects (node.go GetCondition)."""
    for cond in node.status.conditions:
        is_dict = isinstance(cond, dict)
        t = cond.get("type") if is_dict else cond.type
        if t != ctype:
            continue
        status = cond.get("status") if is_dict else cond.status
        when = (cond.get("last_transition_time", 0.0) if is_dict
                else getattr(cond, "last_transition_time", 0.0))
        return status, when
    return None
