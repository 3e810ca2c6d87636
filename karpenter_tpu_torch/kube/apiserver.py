"""Store adapter over a REAL Kubernetes apiserver.

The in-process Store (kube/store.py) is the solver-story deviation
(DEVIATIONS #6); this adapter is the path back to the reference's actual
deployment model — the operator driving a live control plane through the
generated CRDs (api/crds.py), the way the reference's controller-runtime
client does (karpenter's pkg/operator/operator.go:105-206,
kwok/main.go:33-48).

Implementation is stdlib-only (http.client + ssl + urllib): CRUD maps to
REST verbs, status rides the /status subresource, and watch() fan-out is
fed by background watch streams whose events are delivered on the
caller's thread via pump_events() — keeping the deterministic
single-dispatch manager model intact. Supported kinds are the operator's
working set (k8s_codec.ROUTES); the in-process store remains the harness
for everything else.

Durability is the apiserver's: save()/load() are no-ops (restart =
resync, state/cluster.go:96-150).
"""

from __future__ import annotations

import base64
import http.client
import io
import json
import os
import queue
import ssl
import tempfile
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, List, Optional, Tuple

from ..logging import get_logger
from ..utils.clock import Clock
from . import k8s_codec
from .store import ADDED, DELETED, MODIFIED, ConflictError, Event, NotFoundError

log = get_logger("kube.apiserver")


class KubeApiStore:
    def __init__(self, base_url: str, token: Optional[str] = None,
                 ssl_context: Optional[ssl.SSLContext] = None,
                 clock: Optional[Clock] = None):
        self.base_url = base_url.rstrip("/")
        self.clock = clock or Clock()
        self._token = token
        self._ctx = ssl_context
        self._watchers: List[Callable[[Event], None]] = []
        self._events: "queue.Queue[Event]" = queue.Queue()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._rv = 0  # monotonic event counter (checkpoint watermark analog)
        # one kept-alive connection per calling thread (the manager's, the
        # event sink's, the lease renewal's)
        self._local = threading.local()

    # -- construction --------------------------------------------------------

    @classmethod
    def from_kubeconfig(cls, path: Optional[str] = None,
                        context: Optional[str] = None,
                        clock: Optional[Clock] = None) -> "KubeApiStore":
        import yaml
        path = path or os.environ.get("KUBECONFIG",
                                      os.path.expanduser("~/.kube/config"))
        with open(path) as f:
            cfg = yaml.safe_load(f)
        ctx_name = context or cfg.get("current-context")
        ctx = next(c["context"] for c in cfg["contexts"]
                   if c["name"] == ctx_name)
        cluster = next(c["cluster"] for c in cfg["clusters"]
                       if c["name"] == ctx["cluster"])
        user = next(u["user"] for u in cfg["users"]
                    if u["name"] == ctx["user"])

        def materialize(data_key: str, file_key: str) -> Optional[str]:
            if file_key in user or file_key in cluster:
                return user.get(file_key) or cluster.get(file_key)
            blob = user.get(data_key) or cluster.get(data_key)
            if blob is None:
                return None
            fd, p = tempfile.mkstemp(prefix="kubeapi-")
            with os.fdopen(fd, "wb") as f:
                f.write(base64.b64decode(blob))
            return p

        sctx = ssl.create_default_context()
        ca = (cluster.get("certificate-authority")
              or materialize("certificate-authority-data", "__none__"))
        if ca:
            sctx.load_verify_locations(ca)
        if cluster.get("insecure-skip-tls-verify"):
            sctx.check_hostname = False
            sctx.verify_mode = ssl.CERT_NONE
        cert = user.get("client-certificate") or materialize(
            "client-certificate-data", "__none__")
        key = user.get("client-key") or materialize("client-key-data",
                                                    "__none__")
        if cert and key:
            sctx.load_cert_chain(cert, key)
        return cls(cluster["server"], token=user.get("token"),
                   ssl_context=sctx, clock=clock)

    # -- REST plumbing -------------------------------------------------------

    def _route(self, kind: type):
        route = k8s_codec.ROUTES.get(kind)
        if route is None:
            raise TypeError(f"kind {kind.__name__} not supported by the "
                            "apiserver adapter")
        return route

    def _url(self, kind: type, name: str = "", namespace: str = "",
             subresource: str = "", query: str = "",
             all_namespaces: bool = False) -> str:
        prefix, plural, namespaced, _, _ = self._route(kind)
        parts = [self.base_url, prefix]
        if namespaced and not all_namespaces:
            parts += ["namespaces", namespace or "default"]
        parts.append(plural)
        if name:
            parts.append(name)
        if subresource:
            parts.append(subresource)
        url = "/".join(parts)
        if query:
            url += "?" + query
        return url

    def _connection(self) -> Tuple[http.client.HTTPConnection, bool]:
        """This thread's kept-alive connection to the apiserver, and
        whether an earlier call has used it."""
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            return conn, True
        u = urllib.parse.urlsplit(self.base_url)
        if u.scheme == "https":
            conn = http.client.HTTPSConnection(
                u.hostname, u.port, timeout=30,
                context=self._ctx or ssl.create_default_context())
        else:
            conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
        self._local.conn = conn
        return conn, False

    def _request(self, method: str, url: str, body=None):
        """One REST call over this thread's kept-alive connection, as
        client-go keeps its connections. A connection that fails in a call
        is closed and never used again; the call is made once more on a new
        one only where a connection an earlier call used was found dropped
        by the server. A status of 400 or more raises
        ``urllib.error.HTTPError``, a fault of the transport
        ``urllib.error.URLError``, as ``urlopen`` does."""
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Accept": "application/json"}
        if data is not None:
            headers["Content-Type"] = "application/json"
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        u = urllib.parse.urlsplit(url)
        target = u.path + (f"?{u.query}" if u.query else "")
        for attempt in range(2):
            conn, reused = self._connection()
            try:
                conn.request(method, target, body=data, headers=headers)
                resp = conn.getresponse()
                payload = resp.read()
                break
            except BaseException as exc:
                # http.client leaves a connection that failed mid-call in a
                # state in which every later call on it raises
                conn.close()
                self._local.conn = None
                dropped = isinstance(exc, (http.client.RemoteDisconnected,
                                           BrokenPipeError,
                                           ConnectionResetError))
                if reused and dropped and not attempt:
                    continue
                if isinstance(exc, OSError):
                    raise urllib.error.URLError(exc) from exc
                raise
        if resp.status >= 400:
            raise urllib.error.HTTPError(url, resp.status, resp.reason,
                                         resp.headers, io.BytesIO(payload))
        return json.loads(payload.decode()) if payload else None

    # -- event posting -------------------------------------------------------

    _EVENT_API_VERSIONS = {"NodeClaim": "karpenter.sh/v1",
                           "NodePool": "karpenter.sh/v1"}
    _CLUSTER_SCOPED_KINDS = ("Node", "NodeClaim", "NodePool")

    def post_event(self, ev) -> None:
        """POST a core/v1 Event for a recorder event (the client-go
        EventRecorder path the reference rides; recorder.go:47-100 handles
        dedupe before this is called). Best-effort: HTTP failures raise and
        the Recorder swallows them."""
        import uuid

        ns = ev.namespace or "default"
        ts = k8s_codec.ts_to_k8s(ev.timestamp or self.clock.now())
        body = {
            "apiVersion": "v1", "kind": "Event",
            "metadata": {
                "name": f"{ev.object_name}.{uuid.uuid4().hex[:16]}",
                "namespace": ns,
            },
            "involvedObject": {
                "kind": ev.object_kind,
                "name": ev.object_name,
                "apiVersion": self._EVENT_API_VERSIONS.get(
                    ev.object_kind, "v1"),
                **({} if ev.object_kind in self._CLUSTER_SCOPED_KINDS
                   else {"namespace": ns}),
            },
            "reason": ev.reason, "message": ev.message, "type": ev.type,
            "source": {"component": "karpenter"},
            "firstTimestamp": ts, "lastTimestamp": ts, "count": 1,
        }
        url = f"{self.base_url}/api/v1/namespaces/{ns}/events"
        try:
            self._request("POST", url, body)
        except urllib.error.HTTPError as e:
            raise self._map_error(e) from e

    # -- Store surface -------------------------------------------------------

    def create(self, obj) -> object:
        kind = type(obj)
        _, _, namespaced, enc, dec = self._route(kind)
        try:
            out = self._request(
                "POST", self._url(kind, namespace=obj.metadata.namespace),
                enc(obj))
        except urllib.error.HTTPError as e:
            raise self._map_error(e) from e
        created = dec(out)
        obj.metadata.uid = created.metadata.uid
        obj.metadata.resource_version = created.metadata.resource_version
        obj.metadata.creation_timestamp = created.metadata.creation_timestamp
        # status is a subresource on CRDs: push it if the caller set any
        self._maybe_put_status(kind, obj, enc)
        return obj

    def get(self, kind: type, name: str, namespace: str = ""):
        _, _, _, _, dec = self._route(kind)
        try:
            out = self._request("GET", self._url(kind, name=name,
                                                 namespace=namespace))
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise
        return dec(out)

    def get_by_uid(self, kind: type, uid: str):
        for obj in self.list(kind):
            if obj.metadata.uid == uid:
                return obj
        return None

    def list(self, kind: type, namespace: Optional[str] = None,
             predicate: Optional[Callable] = None,
             field_selector: Optional[str] = None) -> list:
        _, _, _, _, dec = self._route(kind)
        # namespace=None means CLUSTER-WIDE (the in-process store contract:
        # provisioner/disruption/termination all list pods across namespaces)
        query = ""
        if field_selector is not None:
            query = "fieldSelector=" + urllib.parse.quote(field_selector,
                                                          safe="=")
        out = self._request(
            "GET", self._url(kind, namespace=namespace or "",
                             all_namespaces=namespace is None, query=query))
        items = [dec(i) for i in out.get("items", [])]
        if namespace is not None:
            items = [o for o in items if o.metadata.namespace == namespace]
        if predicate is not None:
            items = [o for o in items if predicate(o)]
        return items

    def update(self, obj) -> object:
        from ..api.objects import Pod
        kind = type(obj)
        _, _, _, enc, dec = self._route(kind)
        if kind is Pod:
            return self._update_pod(obj)
        try:
            out = self._request(
                "PUT", self._url(kind, name=obj.metadata.name,
                                 namespace=obj.metadata.namespace),
                enc(obj))
        except urllib.error.HTTPError as e:
            raise self._map_error(e) from e
        obj.metadata.resource_version = int(
            (out.get("metadata") or {}).get("resourceVersion", 0) or 0)
        self._maybe_put_status(kind, obj, enc)
        return obj

    @staticmethod
    def _map_error(e: urllib.error.HTTPError) -> Exception:
        from .store import InvalidError
        if e.code == 404:
            return NotFoundError(str(e))
        if e.code == 409:
            return ConflictError(str(e))
        if e.code == 422:
            return InvalidError(str(e))
        return e

    def _update_pod(self, obj) -> object:
        """Pods need apiserver-specific verbs: binding rides the
        pods/binding subresource (the kube-scheduler's bind call — a plain
        PUT cannot set spec.nodeName, and pod specs are immutable, so a
        re-encoded PUT with fabricated containers would 422). Other pod
        updates overlay only the MUTABLE metadata onto the server's live
        object."""
        from ..api.objects import Pod
        url = self._url(Pod, name=obj.metadata.name,
                        namespace=obj.metadata.namespace)
        try:
            live = self._request("GET", url)
        except urllib.error.HTTPError as e:
            raise self._map_error(e) from e
        live_node = (live.get("spec") or {}).get("nodeName", "")
        if obj.spec.node_name and not live_node:
            self._request(
                "POST", url.rsplit("/", 1)[0]
                + f"/{obj.metadata.name}/binding",
                {"apiVersion": "v1", "kind": "Binding",
                 "metadata": {"name": obj.metadata.name,
                              "namespace": obj.metadata.namespace
                              or "default"},
                 "target": {"apiVersion": "v1", "kind": "Node",
                            "name": obj.spec.node_name}})
            return obj
        meta = live.setdefault("metadata", {})
        meta["labels"] = dict(obj.metadata.labels)
        meta["annotations"] = dict(obj.metadata.annotations)
        meta["finalizers"] = list(obj.metadata.finalizers)
        try:
            out = self._request("PUT", url, live)
        except urllib.error.HTTPError as e:
            raise self._map_error(e) from e
        obj.metadata.resource_version = int(
            (out.get("metadata") or {}).get("resourceVersion", 0) or 0)
        return obj

    def _maybe_put_status(self, kind: type, obj, enc) -> None:
        from ..api.nodeclaim import NodeClaim
        from ..api.nodepool import NodePool
        if kind not in (NodeClaim, NodePool):
            return
        body = enc(obj)
        if not body.get("status"):
            return
        try:
            out = self._request(
                "PUT", self._url(kind, name=obj.metadata.name,
                                 subresource="status"), body)
            obj.metadata.resource_version = int(
                (out.get("metadata") or {}).get("resourceVersion", 0) or 0)
        except urllib.error.HTTPError as e:
            log.error("status subresource update failed",
                      kind=kind.__name__, name=obj.metadata.name,
                      code=e.code)

    def apply(self, obj) -> object:
        try:
            return self.create(obj)
        except ConflictError:
            return self.update(obj)

    def delete(self, obj) -> None:
        kind = type(obj)
        try:
            self._request("DELETE",
                          self._url(kind, name=obj.metadata.name,
                                    namespace=obj.metadata.namespace))
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise

    def remove_finalizer(self, obj, finalizer: str) -> None:
        if finalizer in obj.metadata.finalizers:
            obj.metadata.finalizers.remove(finalizer)
            # the apiserver garbage-collects once deletionTimestamp is set
            # and the finalizer list drains — no manual delete needed
            self.update(obj)

    # checkpointing is the apiserver's problem: restart = resync
    def save(self, path: str) -> int:
        return 0

    def load(self, path: str) -> int:
        return 0

    # -- watch plumbing ------------------------------------------------------

    def watch(self, cb: Callable[[Event], None]) -> None:
        self._watchers.append(cb)

    def start_watches(self, kinds=None) -> None:
        """Spawn one watch stream per kind; events queue until the caller
        drains them with pump_events() (the manager dispatch thread)."""
        kinds = list(kinds or k8s_codec.WATCH_KINDS)
        for kind in kinds:
            t = threading.Thread(target=self._watch_loop, args=(kind,),
                                 daemon=True,
                                 name=f"kubeapi-watch-{kind.__name__}")
            t.start()
            self._threads.append(t)

    def stop_watches(self) -> None:
        self._stop.set()

    def pump_events(self, max_events: int = 10_000) -> int:
        """Deliver queued watch events on the CALLING thread — the
        deterministic-manager contract the in-process store provides by
        being synchronous."""
        n = 0
        while n < max_events:
            try:
                ev = self._events.get_nowait()
            except queue.Empty:
                break
            self._rv += 1
            for cb in self._watchers:
                cb(ev)
            n += 1
        return n

    def _watch_loop(self, kind: type) -> None:
        _, _, _, _, dec = self._route(kind)
        rv = ""
        # (namespace, name) -> obj: what this stream believes exists, so a
        # relist after a dropped stream can synthesize DELETED for objects
        # that vanished during the gap (client-go reflector replace semantics)
        known: dict = {}
        while not self._stop.is_set():
            try:
                if not rv:
                    # seed: list cluster-wide, emit ADDED, then watch from
                    # that version
                    out = self._request(
                        "GET", self._url(kind, all_namespaces=True))
                    live = {}
                    for item in out.get("items", []):
                        obj = dec(item)
                        live[(obj.metadata.namespace, obj.metadata.name)] = obj
                        self._events.put(Event(ADDED, kind, obj))
                    for key, obj in known.items():
                        if key not in live:
                            self._events.put(Event(DELETED, kind, obj))
                    known = live
                    rv = (out.get("metadata") or {}).get("resourceVersion",
                                                         "0")
                url = self._url(
                    kind, all_namespaces=True,
                    query=f"watch=true&resourceVersion={rv}"
                    "&timeoutSeconds=60&allowWatchBookmarks=true")
                req = urllib.request.Request(url)
                req.add_header("Accept", "application/json")
                if self._token:
                    req.add_header("Authorization", f"Bearer {self._token}")
                with urllib.request.urlopen(req, context=self._ctx,
                                            timeout=90) as resp:
                    for line in resp:
                        if self._stop.is_set():
                            return
                        ev = json.loads(line.decode())
                        etype = ev.get("type")
                        item = ev.get("object") or {}
                        rv = (item.get("metadata") or {}).get(
                            "resourceVersion", rv)
                        if etype == "BOOKMARK":
                            continue
                        if etype == "ERROR":
                            rv = ""  # relist (410 Gone and friends)
                            break
                        mapped = {"ADDED": ADDED, "MODIFIED": MODIFIED,
                                  "DELETED": DELETED}.get(etype)
                        if mapped:
                            obj = dec(item)
                            key = (obj.metadata.namespace, obj.metadata.name)
                            if mapped is DELETED:
                                known.pop(key, None)
                            else:
                                known[key] = obj
                            self._events.put(Event(mapped, kind, obj))
            except Exception as exc:
                if self._stop.is_set():
                    return
                log.error("watch stream error; relisting",
                          kind=kind.__name__, error=str(exc))
                rv = ""
                self._stop.wait(1.0)
