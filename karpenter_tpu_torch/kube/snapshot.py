"""Versioned snapshot wire format for the durable store.

Raw pickle ties the snapshot to the exact Python class layout: any
refactor of api/objects.py silently discards all durable state on upgrade
(VERDICT r4 #9 — restart = resync degrades to restart = amnesia exactly
when new code ships). This format is JSON with explicit type tags and
BY-NAME field matching on decode:

    {"format": "karpenter-tpu-snapshot", "version": 1, "rv": N,
     "objects": [<enc>, ...]}

- dataclass / plain objects encode as {"__t": ClassName, "f": {...}};
  decode matches fields by name against the CURRENT class — fields added
  since the snapshot take their defaults, removed fields are dropped.
- tuples encode as {"__u": [...]} (restored as tuples: frozen dataclasses
  hash/compare by content), dicts as {"__d": [[k, v], ...]} (keys may be
  any encodable value and never collide with the type tags).
- A snapshot with a NEWER version than this code boots fresh with a
  logged warning (the operator's existing unreadable-snapshot path).
- Legacy pickle snapshots still load (sniffed by magic byte), so the
  upgrade TO this format restores old state.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

FORMAT = "karpenter-tpu-snapshot"
VERSION = 1


class IncompatibleSnapshot(Exception):
    """Snapshot from a newer format version: boot fresh."""


def _build_registry() -> Dict[str, type]:
    """Every type the store may hold, by class name. Plain-class helpers
    that ride inside specs are included explicitly."""
    registry: Dict[str, type] = {}
    import importlib
    pkg = __name__.rsplit(".", 2)[0]
    for modname in (f"{pkg}.api.objects", f"{pkg}.api.storage",
                    f"{pkg}.api.nodeclaim", f"{pkg}.api.nodepool"):
        mod = importlib.import_module(modname)
        for name in dir(mod):
            cls = getattr(mod, name)
            if isinstance(cls, type) and cls.__module__ == modname:
                registry.setdefault(name, cls)
    from ..provisioning.scheduler import _SelectorReq
    registry["_SelectorReq"] = _SelectorReq
    try:
        from ..sidecar.codec import _MinValuesReq
        registry["_MinValuesReq"] = _MinValuesReq
    except ImportError:
        pass
    return registry


_REGISTRY: Optional[Dict[str, type]] = None


def registry() -> Dict[str, type]:
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = _build_registry()
    return _REGISTRY


_SCALARS = (str, int, float, bool, type(None))


def encode_value(v) -> Any:
    if isinstance(v, _SCALARS):
        return v
    if isinstance(v, dict):
        return {"__d": [[encode_value(k), encode_value(val)]
                        for k, val in v.items()]}
    if isinstance(v, tuple):
        return {"__u": [encode_value(x) for x in v]}
    if isinstance(v, (list, set, frozenset)):
        return [encode_value(x) for x in v]
    cls = type(v)
    if dataclasses.is_dataclass(v):
        return {"__t": cls.__name__,
                "f": {f.name: encode_value(getattr(v, f.name))
                      for f in dataclasses.fields(v)}}
    if hasattr(v, "__dict__"):
        return {"__t": cls.__name__,
                "f": {k: encode_value(val) for k, val in vars(v).items()
                      if not k.startswith("_") or k in ("_conds",)}}
    raise TypeError(f"cannot snapshot value of type {cls.__name__}")


def decode_value(v, reg: Dict[str, type]):
    if isinstance(v, _SCALARS):
        return v
    if isinstance(v, list):
        return [decode_value(x, reg) for x in v]
    if isinstance(v, dict):
        if "__d" in v:
            return {decode_value(k, reg): decode_value(val, reg)
                    for k, val in v["__d"]}
        if "__u" in v:
            return tuple(decode_value(x, reg) for x in v["__u"])
        name = v["__t"]
        cls = reg.get(name)
        if cls is None:
            raise IncompatibleSnapshot(f"unknown type {name!r} in snapshot")
        obj = cls.__new__(cls)
        fields = v["f"]
        if dataclasses.is_dataclass(cls):
            # defaults first so fields added since the snapshot exist
            for f in dataclasses.fields(cls):
                if f.name in fields:
                    continue
                if f.default is not dataclasses.MISSING:
                    object.__setattr__(obj, f.name, f.default)
                elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
                    object.__setattr__(obj, f.name, f.default_factory())  # type: ignore[misc]
            known = {f.name for f in dataclasses.fields(cls)}
            for k, val in fields.items():
                if k in known:  # removed fields are dropped by-name
                    object.__setattr__(obj, k, decode_value(val, reg))
        else:
            for k, val in fields.items():
                object.__setattr__(obj, k, decode_value(val, reg))
        return obj
    raise IncompatibleSnapshot(f"unexpected snapshot node {type(v).__name__}")


def dump(objs: Dict[type, dict], rv: int) -> bytes:
    objects: List[Any] = []
    for kind, coll in objs.items():
        for obj in coll.values():
            objects.append(encode_value(obj))
    return json.dumps({"format": FORMAT, "version": VERSION, "rv": rv,
                       "objects": objects}).encode()


def load(data: bytes):
    """Returns (objects, rv). Raises IncompatibleSnapshot for newer
    versions or unknown types; the store re-keys the objects itself."""
    d = json.loads(data.decode())
    if d.get("format") != FORMAT:
        raise IncompatibleSnapshot("not a karpenter-tpu snapshot")
    if d.get("version", 0) > VERSION:
        raise IncompatibleSnapshot(
            f"snapshot version {d.get('version')} is newer than this "
            f"binary's {VERSION}")
    reg = registry()
    return [decode_value(enc, reg) for enc in d["objects"]], d.get("rv", 0)
