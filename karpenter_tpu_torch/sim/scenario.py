"""Scenario language for the fleet simulator: a seeded event timeline.

A scenario file (YAML or JSON) declares the cluster's day: workloads
arriving and scaling, rolling updates, PDBs, spot-reclaim waves, zonal
outages with capacity droughts, PDB-constrained drains, node flakiness
windows, and SLO-budget windows. The simulator (engine.py) actuates each
event against the full operator loop at its simulated instant.

Validation fails LOUDLY at load time (the DeltaVersionError pattern: a
typo'd scenario silently doing the wrong experiment is worse than a boot
failure): unknown top-level keys, unknown event kinds, unknown or
mistyped event fields all raise ``ScenarioError`` naming the field and —
for YAML sources — the offending line.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["ScenarioError", "Scenario", "SimEvent", "NodePoolSpec",
           "load_scenario", "parse_scenario", "EVENT_KINDS"]


class ScenarioError(ValueError):
    """A scenario file failed schema validation (loud, at load time)."""


# Hidden metadata keys the line-aware YAML loader attaches to every
# mapping; stripped before validation, consulted for error locations.
_LINE = "__line__"
_KEY_LINES = "__key_lines__"

_MISSING = object()


# -- field validators --------------------------------------------------------

def _str(v):
    if not isinstance(v, str) or not v:
        raise TypeError("a non-empty string")
    return v


def _num(v):
    if isinstance(v, bool) or not isinstance(v, (int, float)) \
            or not math.isfinite(v):
        raise TypeError("a finite number")
    return float(v)


def _nonneg(v):
    v = _num(v)
    if v < 0:
        raise TypeError("a number >= 0")
    return v


def _pos(v):
    v = _num(v)
    if v <= 0:
        raise TypeError("a number > 0")
    return v


def _int(v):
    if isinstance(v, bool) or not isinstance(v, int):
        raise TypeError("an integer")
    return v


def _count(v):
    v = _int(v)
    if v <= 0:
        raise TypeError("an integer > 0")
    return v


def _replicas(v):
    v = _int(v)
    if v < 0:
        raise TypeError("an integer >= 0")
    return v


def _fraction(v):
    v = _num(v)
    if not 0.0 <= v <= 1.0:
        raise TypeError("a number in [0, 1]")
    return v


def _bool(v):
    if not isinstance(v, bool):
        raise TypeError("a boolean")
    return v


def _intstr(v):
    """PDB intOrString: 3, "3", or "25%"."""
    if isinstance(v, bool):
        raise TypeError('an integer or percent string like "25%"')
    if isinstance(v, int):
        return str(v)
    if isinstance(v, str):
        body = v[:-1] if v.endswith("%") else v
        try:
            int(body)
        except ValueError:
            raise TypeError('an integer or percent string like "25%"')
        return v
    raise TypeError('an integer or percent string like "25%"')


def _spread(v):
    v = _str(v)
    if v not in ("zone", "hostname"):
        raise TypeError('"zone" or "hostname"')
    return v


def _capacity_type(v):
    v = _str(v)
    if v not in ("spot", "on-demand"):
        raise TypeError('"spot" or "on-demand"')
    return v


# mirrors utils.chaos.StateCorruptor.LAYERS plus "all" (pick per injection);
# kept literal so scenario validation stays import-light
_STATE_LAYERS = ("node_rows", "group_rows", "exist_stack", "topo_memo",
                 "warm_checkpoint", "all")


def _state_layer(v):
    v = _str(v)
    if v not in _STATE_LAYERS:
        raise TypeError("one of " + ", ".join(repr(s) for s in _STATE_LAYERS))
    return v


def _budgets(v):
    if not isinstance(v, dict) or not v:
        raise TypeError("a non-empty {span: seconds} mapping")
    out = {}
    for k, s in v.items():
        if k in (_LINE, _KEY_LINES):
            continue
        if not isinstance(k, str) or not k:
            raise TypeError("a non-empty {span: seconds} mapping")
        out[k] = _pos(s)
    if not out:
        raise TypeError("a non-empty {span: seconds} mapping")
    return out


# -- schema tables -----------------------------------------------------------

# kind -> {field: (validator, required, default)}
EVENT_KINDS: Dict[str, Dict[str, tuple]] = {
    # workload arrival: a deployment of `replicas` identical pods
    "deploy": {
        "name": (_str, True, None),
        "replicas": (_replicas, True, None),
        "cpu": (_str, True, None),
        "memory": (_str, True, None),
        "spread": (_spread, False, None),          # topology spread key
        "capacity_type": (_capacity_type, False, None),  # node selector
        "zone": (_str, False, None),               # pin to one zone
    },
    # traffic spike / scale-down: retarget an existing deployment
    "scale": {
        "name": (_str, True, None),
        "replicas": (_replicas, True, None),
    },
    # rolling deploy: replace `batch` old-generation pods every `interval`
    # simulated seconds until the whole deployment is on the new generation
    "rolling_update": {
        "name": (_str, True, None),
        "batch": (_count, False, 5),
        "interval": (_pos, False, 60.0),
    },
    # PodDisruptionBudget over pods labeled app=`app` (exactly one of
    # max_unavailable / min_available, checked post-table)
    "pdb": {
        "name": (_str, True, None),
        "app": (_str, True, None),
        "max_unavailable": (_intstr, False, None),
        "min_available": (_intstr, False, None),
    },
    # spot-reclaim wave: the cloud abruptly takes back spot instances
    # (at least one of fraction / count, checked post-table)
    "spot_reclaim": {
        "fraction": (_fraction, False, None),
        "count": (_count, False, None),
        "zone": (_str, False, None),
    },
    # zonal outage: every node in the zone reclaimed (when `reclaim`) and
    # the zone's offerings exhausted for `duration` simulated seconds
    "zonal_outage": {
        "zone": (_str, True, None),
        "duration": (_pos, True, None),
        "reclaim": (_bool, False, True),
    },
    # pure capacity drought: an offering pattern goes dry (no node kills)
    "drought": {
        "instance_type": (_str, False, "*"),
        "zone": (_str, False, "*"),
        "capacity_type": (_str, False, "*"),
        "duration": (_pos, True, None),
    },
    # graceful drain: delete `count` nodes (oldest first, optionally one
    # zone) — the termination controller drains them under PDB limits
    "drain": {
        "count": (_count, False, 1),
        "zone": (_str, False, None),
    },
    # node/provider flakiness window: the seeded FaultInjector fires at
    # `rate` on cloudprovider calls for `duration` simulated seconds
    "flaky": {
        "rate": (_fraction, True, None),
        "duration": (_pos, True, None),
        "terminal_rate": (_fraction, False, 0.0),
    },
    # drift wave: stamp a stale nodepool-hash annotation onto `count` /
    # `fraction` of the fleet's claims (oldest first, optionally one zone)
    # — the disruption marker flags them Drifted and the Drift method
    # replaces them under the pool's budgets (at least one of
    # fraction / count, checked post-table)
    "drift": {
        "fraction": (_fraction, False, None),
        "count": (_count, False, None),
        "zone": (_str, False, None),
    },
    # expiration wave: set spec.expireAfter on the oldest `count` /
    # `fraction` claims so they age out through the expiration controller
    # (at least one of fraction / count, checked post-table)
    "expire": {
        "fraction": (_fraction, False, None),
        "count": (_count, False, None),
        "expire_after": (_pos, True, None),
        "zone": (_str, False, None),
    },
    # SLO-budget window: budgets applied to the live SLOWatcher at `at`,
    # restored after `duration` (None = until the end of the run)
    "slo": {
        "budgets": (_budgets, True, None),
        "duration": (_pos, False, None),
    },
    # wire-fault window (requires `backend: sidecar`): the seeded
    # WireFaultInjector fires on the solver gRPC wire at these rates for
    # `duration` simulated seconds — drop (request lost), delay (added
    # latency), duplicate (retransmit racing its original), disconnect
    # (response lost after the server applied). `kill_server` restarts
    # the sidecar at `at` (all sessions lost; clients must resync
    # transparently). At least one fault is required.
    "wire_chaos": {
        "drop": (_fraction, False, 0.0),
        "delay": (_fraction, False, 0.0),
        "duplicate": (_fraction, False, 0.0),
        "disconnect": (_fraction, False, 0.0),
        "delay_seconds": (_pos, False, 0.02),
        "duration": (_pos, True, None),
        "kill_server": (_bool, False, False),
        # fleet mode: which replica `kill_server` hits (modulo the fleet
        # size, so the same scenario runs at any replica count)
        "replica": (_replicas, False, 0),
    },
    # zero-downtime rolling restart of the whole sidecar fleet (requires
    # `replicas >= 1`): replica i drains — exporting session checkpoints
    # to the handoff store — and restarts at `at + i*interval`; clients
    # follow the drain NACK's migrated_to rider and resume warm
    "rolling_restart": {
        "interval": (_pos, False, 5.0),
        "drain_grace": (_nonneg, False, 0.5),
    },
    # anti-entropy chaos (requires `backend: tensor`): flip / stale / truncate
    # `count` cached entries in the named warm-state `layer` ("all" picks a
    # layer per injection) — the StateAuditor must detect every one before
    # the corrupt entry is served and quarantine-heal within the pass.
    # Deliberately unledgered: a run with corrupt_state events must produce
    # a ledger digest identical to the fault-free run (the audit contract).
    "corrupt_state": {
        "layer": (_state_layer, False, "all"),
        "count": (_count, False, 1),
    },
    # device-loss window (requires `backend: tensor`): solver device `device`
    # (modulo the host device count) dies at `at` and revives after
    # `duration`; mesh solves inside the window must complete through the
    # degradation ladder (surviving carve / single device) with identical
    # decisions. Unledgered for the same digest-parity contract as
    # corrupt_state.
    "kill_device": {
        "device": (_replicas, False, 0),
        "duration": (_pos, True, None),
    },
}

_EVENT_COMMON = {"at", "kind"}


def _backend(v):
    v = _str(v)
    if v not in ("tensor", "sidecar"):
        raise TypeError('"tensor" or "sidecar"')
    return v


def _weight(v):
    v = _int(v)
    if not 1 <= v <= 100:
        raise TypeError("an integer in [1, 100]")
    return v


_NODEPOOL_FIELDS: Dict[str, tuple] = {
    "name": (_str, True, None),
    "consolidate_after": (_nonneg, False, 0.0),
    "weight": (_weight, False, None),
}

_TOP_FIELDS: Dict[str, tuple] = {
    "name": (_str, True, None),
    "seed": (_int, False, 0),
    "duration": (_pos, True, None),
    # max simulated seconds between operator passes (the adaptive stepper
    # jumps earlier for scenario events, manager timers, batch deadlines)
    "tick": (_pos, False, 10.0),
    # disruption-pass cadence in simulated seconds (the reference's 10s
    # poll; raised in long scenarios to bound wall cost — DEVIATIONS 21)
    "disruption_interval": (_pos, False, 10.0),
    # synthetic catalog size (construct_catalog); 0 = the kwok 144
    "catalog": (_replicas, False, 0),
    "ready_delay": (_nonneg, False, 2.0),
    "batch_idle": (_pos, False, 1.0),
    "batch_max": (_pos, False, 10.0),
    # operator --slo-budgets applied for the whole run ("" = none; `slo`
    # events can still open budget windows mid-run)
    "slo_budgets": (lambda v: v if isinstance(v, str)
                    else (_ for _ in ()).throw(TypeError("a string")),
                    False, ""),
    # solver backend: "tensor" = in-process (the default), "sidecar" =
    # the engine boots a real in-process gRPC sidecar and the operator's
    # provisioning runs through the session wire — `wire_chaos` events
    # can then target the wire itself
    "backend": (_backend, False, "tensor"),
    # sidecar fleet size (requires `backend: sidecar`): 0 = the legacy
    # single module-global server; >= 1 boots that many isolated replicas
    # sharing one checkpoint handoff store, with the client's
    # consistent-hash router spread across them — kills and rolling
    # restarts then resume sessions warm on a peer
    "replicas": (_replicas, False, 0),
}


@dataclass
class NodePoolSpec:
    name: str
    consolidate_after: float = 0.0
    weight: Optional[int] = None


@dataclass
class SimEvent:
    at: float
    kind: str
    params: dict
    line: int = 0  # source line (0 when unknown: JSON/dict input)

    def __getattr__(self, item):
        try:
            return self.params[item]
        except KeyError:
            raise AttributeError(item)


@dataclass
class Scenario:
    name: str
    duration: float
    seed: int = 0
    tick: float = 10.0
    disruption_interval: float = 10.0
    catalog: int = 0
    ready_delay: float = 2.0
    batch_idle: float = 1.0
    batch_max: float = 10.0
    slo_budgets: str = ""
    backend: str = "tensor"
    replicas: int = 0
    nodepools: List[NodePoolSpec] = field(default_factory=list)
    events: List[SimEvent] = field(default_factory=list)
    source: str = "<dict>"

    @property
    def needs_slo_watcher(self) -> bool:
        return bool(self.slo_budgets) or \
            any(e.kind == "slo" for e in self.events)


# -- line-aware YAML ---------------------------------------------------------

def _yaml_load_with_lines(text: str):
    """PyYAML safe-load where every mapping carries its source line and a
    per-key line table (hidden keys, stripped before validation)."""
    import yaml

    class _Loader(yaml.SafeLoader):
        pass

    def construct_mapping(loader, node):
        mapping, key_lines = {}, {}
        for key_node, value_node in node.value:
            key = loader.construct_object(key_node, deep=True)
            mapping[key] = loader.construct_object(value_node, deep=True)
            if isinstance(key, str):
                key_lines[key] = key_node.start_mark.line + 1
        mapping[_LINE] = node.start_mark.line + 1
        mapping[_KEY_LINES] = key_lines
        return mapping

    _Loader.add_constructor(
        yaml.resolver.BaseResolver.DEFAULT_MAPPING_TAG, construct_mapping)
    return yaml.load(text, Loader=_Loader)


def _strip_lines(d: dict) -> Tuple[dict, int, Dict[str, int]]:
    """(payload, mapping line, per-key lines) for a loaded mapping."""
    if not isinstance(d, dict):
        return d, 0, {}
    key_lines = d.get(_KEY_LINES) or {}
    line = d.get(_LINE) or 0
    payload = {k: v for k, v in d.items() if k not in (_LINE, _KEY_LINES)}
    return payload, line, key_lines


# -- validation --------------------------------------------------------------

class _Ctx:
    """Error-location context: renders 'file:line: message'."""

    def __init__(self, source: str):
        self.source = source

    def fail(self, message: str, line: int = 0) -> None:
        loc = f"{self.source}:{line}" if line else self.source
        raise ScenarioError(f"{loc}: {message}")


def _apply_table(payload: dict, key_lines: Dict[str, int], line: int,
                 table: Dict[str, tuple], what: str, ctx: _Ctx,
                 extra_known=()) -> dict:
    """Validate one mapping against a field table: unknown keys and type
    errors name the field (and its line); required fields must be present.
    Returns the validated payload with defaults filled in."""
    known = set(table) | set(extra_known)
    for key in payload:
        if not isinstance(key, str) or key not in known:
            ctx.fail(f"unknown key {key!r} in {what} "
                     f"(known: {', '.join(sorted(known))})",
                     key_lines.get(key, line))
    out = {}
    for name, (validator, required, default) in table.items():
        v = payload.get(name, _MISSING)
        if v is _MISSING:
            if required:
                ctx.fail(f"{what} is missing required field {name!r}", line)
            out[name] = default
            continue
        try:
            out[name] = validator(v)
        except TypeError as exc:
            ctx.fail(f"field {name!r} in {what} must be {exc} "
                     f"(got {v!r})", key_lines.get(name, line))
    return out


def _validate_event(raw, index: int, ctx: _Ctx) -> SimEvent:
    payload, line, key_lines = _strip_lines(raw)
    if not isinstance(payload, dict):
        ctx.fail(f"event #{index + 1} must be a mapping, got "
                 f"{type(raw).__name__}")
    kind = payload.get("kind", _MISSING)
    if kind is _MISSING:
        ctx.fail(f"event #{index + 1} is missing required field 'kind'",
                 line)
    if not isinstance(kind, str) or kind not in EVENT_KINDS:
        ctx.fail(f"unknown event kind {kind!r} in event #{index + 1} "
                 f"(known: {', '.join(sorted(EVENT_KINDS))})",
                 key_lines.get("kind", line))
    at = payload.get("at", _MISSING)
    if at is _MISSING:
        ctx.fail(f"{kind} event #{index + 1} is missing required field "
                 "'at'", line)
    try:
        at = _nonneg(at)
    except TypeError as exc:
        ctx.fail(f"field 'at' in {kind} event #{index + 1} must be {exc} "
                 f"(got {at!r})", key_lines.get("at", line))
    what = f"{kind} event #{index + 1}"
    body = {k: v for k, v in payload.items() if k not in _EVENT_COMMON}
    params = _apply_table(body, key_lines, line, EVENT_KINDS[kind], what,
                          ctx)
    # cross-field rules the flat table can't express
    if kind == "pdb":
        have = [params.get("max_unavailable"), params.get("min_available")]
        if sum(v is not None for v in have) != 1:
            ctx.fail(f"{what} needs exactly one of 'max_unavailable' / "
                     "'min_available'", line)
    if kind in ("spot_reclaim", "drift", "expire"):
        if params.get("fraction") is None and params.get("count") is None:
            ctx.fail(f"{what} needs at least one of 'fraction' / 'count'",
                     line)
    if kind == "wire_chaos":
        if not any((params["drop"], params["delay"], params["duplicate"],
                    params["disconnect"], params["kill_server"])):
            ctx.fail(f"{what} needs at least one fault: a non-zero "
                     "'drop' / 'delay' / 'duplicate' / 'disconnect' rate "
                     "or 'kill_server: true'", line)
    return SimEvent(at=at, kind=kind, params=params, line=line)


def parse_scenario(data, source: str = "<dict>") -> Scenario:
    """Validate a loaded scenario document into a Scenario. Raises
    ScenarioError naming the offending field (and line, when the source
    was line-aware YAML)."""
    ctx = _Ctx(source)
    payload, line, key_lines = _strip_lines(data)
    if not isinstance(payload, dict):
        ctx.fail(f"scenario document must be a mapping, got "
                 f"{type(data).__name__}")
    top = _apply_table(
        {k: v for k, v in payload.items()
         if k not in ("nodepools", "events")},
        key_lines, line, _TOP_FIELDS, "scenario", ctx,
        extra_known=("nodepools", "events"))

    raw_pools = payload.get("nodepools", [{"name": "default"}])
    if not isinstance(raw_pools, list) or not raw_pools:
        ctx.fail("'nodepools' must be a non-empty list",
                 key_lines.get("nodepools", line))
    pools = []
    for i, rp in enumerate(raw_pools):
        p_payload, p_line, p_keys = _strip_lines(rp)
        if not isinstance(p_payload, dict):
            ctx.fail(f"nodepool #{i + 1} must be a mapping")
        fields_ = _apply_table(p_payload, p_keys, p_line, _NODEPOOL_FIELDS,
                               f"nodepool #{i + 1}", ctx)
        pools.append(NodePoolSpec(**fields_))
    if len({p.name for p in pools}) != len(pools):
        ctx.fail("duplicate nodepool names", key_lines.get("nodepools", line))

    raw_events = payload.get("events", _MISSING)
    if raw_events is _MISSING:
        ctx.fail("scenario is missing required field 'events'", line)
    if not isinstance(raw_events, list) or not raw_events:
        ctx.fail("'events' must be a non-empty list",
                 key_lines.get("events", line))
    events = [_validate_event(raw, i, ctx)
              for i, raw in enumerate(raw_events)]
    for ev in events:
        if ev.at > top["duration"]:
            ctx.fail(f"{ev.kind} event at t={ev.at:g}s lies beyond the "
                     f"scenario duration ({top['duration']:g}s)", ev.line)
    known_deploys = set()
    # reference checks walk EXECUTION order — the engine sorts the
    # timeline by (at, file index), so a scale listed before its deploy
    # but timed after it is valid, and a scale timed before its deploy
    # must be rejected regardless of file order
    for _, ev in sorted(enumerate(events), key=lambda p: (p[1].at, p[0])):
        if ev.kind == "deploy":
            if ev.name in known_deploys:
                ctx.fail(f"duplicate deploy name {ev.name!r}", ev.line)
            known_deploys.add(ev.name)
        elif ev.kind in ("scale", "rolling_update") \
                and ev.name not in known_deploys:
            ctx.fail(f"{ev.kind} event references unknown deployment "
                     f"{ev.name!r} (no earlier deploy event)", ev.line)
    if top["slo_budgets"]:
        from ..obs.slo import parse_budgets
        try:
            parse_budgets(top["slo_budgets"])
        except ValueError as exc:
            ctx.fail(f"bad 'slo_budgets': {exc}",
                     key_lines.get("slo_budgets", line))
    if top["backend"] != "sidecar":
        # wire chaos targets the gRPC wire; without the sidecar backend
        # there is no wire, and a window that silently does nothing is
        # the typo'd-experiment failure mode validation exists to stop
        for ev in events:
            if ev.kind == "wire_chaos":
                ctx.fail(f"wire_chaos event at t={ev.at:g}s requires "
                         "'backend: sidecar' (the tensor backend has no "
                         "wire to fault)", ev.line)
        if top["replicas"]:
            ctx.fail("'replicas' requires 'backend: sidecar' (there is no "
                     "fleet to replicate on the tensor backend)",
                     key_lines.get("replicas", line))
    else:
        # state chaos targets the in-process warm state plane and the
        # solver device mesh; on the sidecar backend both live across the
        # wire and the window would silently do nothing — reject the
        # typo'd experiment the same way wire_chaos is rejected above
        for ev in events:
            if ev.kind in ("corrupt_state", "kill_device"):
                ctx.fail(f"{ev.kind} event at t={ev.at:g}s requires "
                         "'backend: tensor' (state chaos targets the "
                         "in-process state plane and device mesh)", ev.line)
    if not top["replicas"]:
        # rolling_restart drains through the fleet handoff store; with no
        # fleet there is nothing to migrate to and the event would silently
        # cold-restart the only server — reject the typo'd experiment
        for ev in events:
            if ev.kind == "rolling_restart":
                ctx.fail(f"rolling_restart event at t={ev.at:g}s requires "
                         "'replicas: 1' or more (a fleet to roll)", ev.line)
    return Scenario(nodepools=pools, events=events, source=source, **top)


def load_scenario(path: str) -> Scenario:
    """Load + validate a scenario file. `.json` parses as JSON (errors name
    the event index); everything else parses as line-aware YAML (errors
    name file:line)."""
    with open(path) as f:
        text = f.read()
    source = os.path.basename(path)
    if path.endswith(".json"):
        try:
            data = json.loads(text)
        except json.JSONDecodeError as exc:
            raise ScenarioError(f"{source}:{exc.lineno}: invalid JSON: "
                                f"{exc.msg}") from exc
    else:
        import yaml
        try:
            data = _yaml_load_with_lines(text)
        except yaml.YAMLError as exc:
            mark = getattr(exc, "problem_mark", None)
            loc = f"{source}:{mark.line + 1}" if mark else source
            raise ScenarioError(f"{loc}: invalid YAML: {exc}") from exc
    return parse_scenario(data, source=source)
