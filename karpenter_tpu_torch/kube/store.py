"""In-memory Kubernetes-shaped object store: the framework's state substrate.

The reference delegates durable state to the Kubernetes API server and
rebuilds everything else from watch streams (SURVEY.md §5 checkpoint note:
"restart = resync"). This store plays that role for the standalone framework:
typed collections with create/get/update/delete, resourceVersion stamping,
watch fan-out, and the API server's finalizer-aware two-phase delete
(deletionTimestamp first, object removal only after the last finalizer is
gone) that the termination controllers depend on
(node/termination/controller.go:87-176).

Single-writer semantics: controllers run on one dispatch loop (see
controllers/manager.py), so no locking here. Objects handed out are the live
instances — callers follow the reference's convention of mutating then calling
update()/status-patch helpers, which bump resourceVersion and notify watchers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Type

from ..utils.clock import Clock

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


@dataclass(frozen=True)
class Event:
    type: str              # ADDED | MODIFIED | DELETED
    kind: type             # python class of the object
    obj: object


class InvalidError(Exception):
    """Admission rejection — the apiserver's 422 (kube/admission.py)."""


class ConflictError(Exception):
    """Object already exists on create / vanished on update."""


class NotFoundError(Exception):
    pass


# Cluster-scoped kinds: namespace ignored in keys, the way the API server
# treats Node/NodeClaim/NodePool.
CLUSTER_SCOPED_KINDS = frozenset({"Node", "NodeClaim", "NodePool", "NodeClass",
                                  "PersistentVolume", "StorageClass", "CSINode",
                                  "VolumeAttachment"})


def _ns(kind: type, namespace: str) -> str:
    return "" if kind.__name__ in CLUSTER_SCOPED_KINDS else (namespace or "")


def _key(obj) -> Tuple[str, str]:
    return (_ns(type(obj), obj.metadata.namespace), obj.metadata.name)


class Store:
    def __init__(self, clock: Optional[Clock] = None):
        self.clock = clock or Clock()
        self._objs: Dict[type, Dict[Tuple[str, str], object]] = {}
        self._by_uid: Dict[type, Dict[str, object]] = {}
        self._watchers: List[Callable[[Event], None]] = []
        self._rv = 0

    def get_by_uid(self, kind: type, uid: str) -> Optional[object]:
        """O(1) UID lookup (a field-indexer analog, operator.go:177-206):
        deleting-node pod carryover resolves pods by UID per reconcile, so a
        scan here would be O(pods) per deleting node."""
        return self._by_uid.get(kind, {}).get(uid)

    # -- watch --------------------------------------------------------------

    def watch(self, cb: Callable[[Event], None]) -> None:
        self._watchers.append(cb)

    def _notify(self, etype: str, obj) -> None:
        ev = Event(type=etype, kind=type(obj), obj=obj)
        for cb in list(self._watchers):
            cb(ev)

    def _bump(self, obj) -> None:
        self._rv += 1
        obj.metadata.resource_version = self._rv

    # -- CRUD ---------------------------------------------------------------

    def create(self, obj) -> object:
        kind = type(obj)
        coll = self._objs.setdefault(kind, {})
        k = _key(obj)
        if k in coll:
            raise ConflictError(f"{kind.__name__} {k} already exists")
        from . import admission
        errs = admission.validate(obj)
        if errs:
            raise InvalidError(f"{kind.__name__} {k} is invalid: "
                               + "; ".join(errs))
        if not obj.metadata.creation_timestamp:
            obj.metadata.creation_timestamp = self.clock.now()
        self._bump(obj)
        coll[k] = obj
        if obj.metadata.uid:
            self._by_uid.setdefault(kind, {})[obj.metadata.uid] = obj
        self._notify(ADDED, obj)
        return obj

    def get(self, kind: type, name: str, namespace: str = "") -> Optional[object]:
        return self._objs.get(kind, {}).get((_ns(kind, namespace), name))

    def list(self, kind: type, namespace: Optional[str] = None,
             predicate: Optional[Callable] = None,
             field_selector: Optional[str] = None) -> List[object]:
        out = []
        if namespace is not None:
            namespace = _ns(kind, namespace)
        node_name = None
        if field_selector is not None:
            # only the selector the controllers use (spec.nodeName=<node>)
            if not field_selector.startswith("spec.nodeName="):
                raise ValueError(f"unsupported field selector {field_selector}")
            node_name = field_selector.split("=", 1)[1]
        for (ns, _), obj in self._objs.get(kind, {}).items():
            if namespace is not None and ns != namespace:
                continue
            if node_name is not None and obj.spec.node_name != node_name:
                continue
            if predicate is not None and not predicate(obj):
                continue
            out.append(obj)
        return out

    def update(self, obj) -> object:
        kind = type(obj)
        coll = self._objs.setdefault(kind, {})
        k = _key(obj)
        if k not in coll:
            raise NotFoundError(f"{kind.__name__} {k} not found")
        old = coll[k]
        from . import admission
        errs = admission.validate(obj, old if old is not obj else None)
        if errs:
            raise InvalidError(f"{kind.__name__} {k} is invalid: "
                               + "; ".join(errs))
        self._bump(obj)
        coll[k] = obj
        if obj.metadata.uid:
            self._by_uid.setdefault(kind, {})[obj.metadata.uid] = obj
        self._notify(MODIFIED, obj)
        return obj

    def apply(self, obj) -> object:
        """Create-or-update."""
        try:
            return self.create(obj)
        except ConflictError:
            return self.update(obj)

    def delete(self, obj) -> None:
        """API-server delete semantics: with finalizers present, only stamps
        deletionTimestamp; the object disappears when the last finalizer is
        removed (via remove_finalizer/update)."""
        kind = type(obj)
        coll = self._objs.get(kind, {})
        k = _key(obj)
        if k not in coll:
            raise NotFoundError(f"{kind.__name__} {k} not found")
        live = coll[k]
        if live.metadata.finalizers:
            if live.metadata.deletion_timestamp is None:
                live.metadata.deletion_timestamp = self.clock.now()
                self._bump(live)
                self._notify(MODIFIED, live)
            return
        del coll[k]
        self._by_uid.get(kind, {}).pop(live.metadata.uid, None)
        self._rv += 1  # deletions must advance the checkpoint watermark
        self._notify(DELETED, live)

    # -- durability ---------------------------------------------------------
    #
    # The reference's durable state is the Kubernetes API server; restart =
    # resync from it (state/cluster.go:96-150). Standalone, the store IS the
    # API server, so it owns durability: save() snapshots every collection
    # atomically; load() replays a snapshot through the watch fan-out so
    # informers rebuild cluster state and controllers re-reconcile, exactly
    # like a watch-stream resync.

    _REPLAY_ORDER = ("NodePool", "NodeClass", "StorageClass",
                     "PersistentVolume", "PersistentVolumeClaim", "CSINode",
                     "NodeClaim", "Node", "PodDisruptionBudget")

    def save(self, path: str) -> int:
        """Atomic snapshot (tmp + rename) in the versioned JSON wire format
        (kube/snapshot.py) — stable across code upgrades, unlike pickle.
        Returns objects written."""
        import os
        import tempfile

        from . import snapshot
        payload = snapshot.dump(self._objs, self._rv)
        d = os.path.dirname(os.path.abspath(path))
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".store-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())  # a crash must not truncate the snapshot
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return sum(len(c) for c in self._objs.values())

    def load(self, path: str) -> int:
        """Replay a snapshot: existing keys are kept (live state wins), new
        objects are announced as ADDED in dependency order (pools/claims/
        nodes before pods) so the cluster cache rebuilds coherently. Returns
        objects restored. Reads the versioned JSON format; legacy pickle
        snapshots (pre-format upgrades) still restore."""
        from . import snapshot
        with open(path, "rb") as f:
            raw = f.read()
        if raw[:1] == b"{":
            objects, rv = snapshot.load(raw)
            by_kind: Dict[type, dict] = {}
            for obj in objects:
                by_kind.setdefault(type(obj), {})[_key(obj)] = obj
            data = {"objs": by_kind, "rv": rv}
        else:
            import pickle
            data = pickle.loads(raw)
        kinds = sorted(data["objs"],
                       key=lambda k: (self._REPLAY_ORDER.index(k.__name__)
                                      if k.__name__ in self._REPLAY_ORDER
                                      else len(self._REPLAY_ORDER)))
        # stage first, then commit: a snapshot from an incompatible code
        # version must fail BEFORE any object is announced, so the caller's
        # "boot fresh" fallback starts from a genuinely empty store
        staged: List[tuple] = []
        for kind in kinds:
            coll = self._objs.get(kind, {})
            for k, obj in data["objs"][kind].items():
                if k in coll:
                    continue
                staged.append((kind, k, obj, obj.metadata.uid))
        self._rv = max(self._rv, data["rv"])
        for kind, k, obj, uid in staged:
            self._objs.setdefault(kind, {})[k] = obj
            if uid:
                self._by_uid.setdefault(kind, {})[uid] = obj
            self._notify(ADDED, obj)
        return len(staged)

    def remove_finalizer(self, obj, finalizer: str) -> None:
        if finalizer in obj.metadata.finalizers:
            obj.metadata.finalizers.remove(finalizer)
        if obj.metadata.deletion_timestamp is not None and not obj.metadata.finalizers:
            coll = self._objs.get(type(obj), {})
            k = _key(obj)
            if k in coll:
                del coll[k]
                self._by_uid.get(type(obj), {}).pop(obj.metadata.uid, None)
                self._rv += 1  # see delete(): watermark must see removals
                self._notify(DELETED, obj)
            return
        self.update(obj)
