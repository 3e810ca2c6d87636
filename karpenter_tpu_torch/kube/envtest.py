"""An in-process kube-apiserver for tests — the envtest analog.

The reference runs every unit suite against envtest (a real apiserver +
etcd; karpenter's pkg/test/environment.go:41-49). This module stands up
the REST subset the adapter (kube/apiserver.py) actually speaks, over HTTP
on a loopback port, so the codec, the REST adapter, admission, and the full
operator loop are exercised against a live wire in the default test run —
no cluster, no gate.

Fidelity points that matter to the controllers:
- resourceVersion: one monotonic counter; stale-RV PUTs get 409.
- finalizers: DELETE on a finalized object stamps deletionTimestamp and
  returns it (MODIFIED); the object is only removed — with a DELETED watch
  event — when a later PUT clears the finalizer list.
- status subresource: PUT .../status merges ONLY the status stanza.
- watch: chunked JSON lines `{"type": ..., "object": ...}` from the given
  resourceVersion, long-polling up to timeoutSeconds.
- admission: NodePools/NodeClaims decode through the codec and run the
  same validation battery the in-process store enforces
  (kube/admission.py); violations get 422.
- core/v1 Events POST is accepted and retained for assertions.
- list: every object of the route (of the namespace, when one is named);
  a ``fieldSelector`` is not evaluated, as in the JAX package's server.

The watch log is kept twice: in order (``log``, the whole history, for
drivers that read it under ``lock``) and per route, each route's
resourceVersions ascending beside its encoded lines. A watch batch starts
at its cursor by bisection on its route's versions and a write wakes only
the watches of its route, so a watch does work in proportion to the lines
it delivers. Each line is encoded once, when its entry is logged, from a
snapshot of the object: history never aliases a live dict.

``stop()`` ends every open connection as well as the listener, as an
apiserver that goes away does: a client's kept-alive connection fails on
its next call instead of reaching a stopped server's state.
"""

from __future__ import annotations

import bisect
import json
import re
import socket
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from ..utils.clock import Clock
from . import k8s_codec
from .admission import validate as admission_validate

_CRD_PATH = "/apis/apiextensions.k8s.io/v1/customresourcedefinitions"


class _RouteLog:
    """One route's watch history: resourceVersions ascending, and the watch
    line of each, encoded once."""

    def __init__(self, mutex):
        self.rvs: List[int] = []
        self.lines: List[bytes] = []
        self.changed = threading.Condition(mutex)


class _State:
    def __init__(self, clock: Optional[Clock] = None):
        # creation/deletion timestamps come from the injected clock, never
        # time.time() directly: a FakeClock-driven suite (or a flight-record
        # replay) must see deterministic object metadata
        self.clock = clock or Clock()
        self._mutex = threading.RLock()
        self.lock = threading.Condition(self._mutex)
        self.rv = 0
        # (prefix, plural) -> {(ns, name): k8s dict}
        self.objects: Dict[Tuple[str, str], Dict[Tuple[str, str], dict]] = {}
        # append-only watch log: (rv, (prefix, plural), type, obj)
        self.log: List[tuple] = []
        self.routes: Dict[Tuple[str, str], _RouteLog] = {}
        self.events: List[dict] = []   # core/v1 Events posted
        self.crds: List[dict] = []
        self.closed = False            # set by EnvtestServer.stop()
        self.connections: set = set()  # open client sockets

    def bump(self) -> int:
        self.rv += 1
        return self.rv

    def route_log(self, route: Tuple[str, str]) -> _RouteLog:
        rl = self.routes.get(route)
        if rl is None:
            rl = self.routes[route] = _RouteLog(self._mutex)
        return rl

    def emit(self, route: Tuple[str, str], etype: str, obj: dict) -> None:
        # snapshot: log entries must not alias live dicts (a later in-place
        # mutation would rewrite watch history mid-serialization; a real
        # apiserver's etcd revisions are immutable)
        snap = json.loads(json.dumps(obj))
        self.log.append((self.rv, route, etype, snap))
        rl = self.route_log(route)
        rl.rvs.append(self.rv)
        rl.lines.append((json.dumps({"type": etype, "object": snap})
                         + "\n").encode())
        rl.changed.notify_all()

    def entries(self, route: Tuple[str, str], cursor: int) -> list:
        """``route``'s (rv, line) entries past ``cursor``, in order; call
        under ``lock``."""
        rl = self.routes.get(route)
        if rl is None:
            return []
        i = bisect.bisect_right(rl.rvs, cursor)
        return list(zip(rl.rvs[i:], rl.lines[i:]))


_ROUTE_RE = re.compile(
    r"^/(?P<prefix>api/v1|apis/[^/]+/[^/]+)"
    r"(?:/namespaces/(?P<ns>[^/]+))?"
    r"/(?P<plural>[^/?]+)"
    r"(?:/(?P<name>[^/?]+))?"
    r"(?:/(?P<sub>status|binding))?$")

# plurals whose writes run the admission battery (decoded via the codec)
_ADMITTED = {
    "nodepools": (k8s_codec.nodepool_from_k8s,),
    "nodeclaims": (k8s_codec.nodeclaim_from_k8s,),
}


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # a response is written as headers, then body: on a kept-alive
    # connection Nagle's algorithm would hold the body until the client's
    # delayed ACK of the headers
    disable_nagle_algorithm = True
    state: _State = None  # set by serve()

    # -- helpers ------------------------------------------------------------

    def log_message(self, fmt, *args):  # silence request logging
        pass

    def setup(self):
        super().setup()
        with self.state.lock:
            self.state.connections.add(self.connection)

    def finish(self):
        with self.state.lock:
            self.state.connections.discard(self.connection)
        super().finish()

    def _body(self) -> Optional[dict]:
        n = int(self.headers.get("Content-Length") or 0)
        if not n:
            return None
        return json.loads(self.rfile.read(n).decode())

    def _send(self, code: int, payload: Optional[dict] = None) -> None:
        self._send_bytes(code, json.dumps(payload).encode()
                         if payload is not None else b"")

    def _send_bytes(self, code: int, data: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        if data:
            self.wfile.write(data)

    def _status_err(self, code: int, reason: str, message: str) -> None:
        self._send(code, {"kind": "Status", "apiVersion": "v1",
                          "status": "Failure", "reason": reason,
                          "message": message, "code": code})

    def _parse(self):
        from urllib.parse import parse_qs, urlparse
        u = urlparse(self.path)
        m = _ROUTE_RE.match(u.path)
        if m is None:
            return None
        q = {k: v[0] for k, v in parse_qs(u.query).items()}
        return m.group("prefix"), m.group("ns"), m.group("plural"), \
            m.group("name"), m.group("sub"), q

    @staticmethod
    def _key(ns: Optional[str], obj_or_name) -> Tuple[str, str]:
        if isinstance(obj_or_name, str):
            return (ns or "", obj_or_name)
        meta = obj_or_name.get("metadata") or {}
        return (ns or meta.get("namespace") or "", meta.get("name") or "")

    def _admit(self, plural: str, body: dict, old: Optional[dict]) -> Optional[str]:
        dec = _ADMITTED.get(plural)
        if dec is None:
            return None
        try:
            new_obj = dec[0](body)
            old_obj = dec[0](old) if old is not None else None
        except Exception as e:  # codec reject = malformed object
            return f"malformed {plural[:-1]}: {e}"
        errs = admission_validate(new_obj, old_obj)
        return "; ".join(errs) if errs else None

    # -- verbs --------------------------------------------------------------

    def do_GET(self):
        parsed = self._parse()
        if parsed is None:
            return self._status_err(404, "NotFound", self.path)
        prefix, ns, plural, name, _sub, q = parsed
        st = self.state
        route = (prefix, plural)
        if name:
            with st.lock:
                obj = st.objects.get(route, {}).get(self._key(ns, name))
                # encoded under the lock: a later write cannot tear it
                data = json.dumps(obj).encode() if obj is not None else None
            if data is None:
                return self._status_err(404, "NotFound",
                                        f"{plural} {name} not found")
            return self._send_bytes(200, data)
        if q.get("watch") == "true":
            return self._watch(route, q)
        with st.lock:
            data = json.dumps(
                {"kind": "List", "apiVersion": "v1",
                 "metadata": {"resourceVersion": str(st.rv)},
                 "items": [o for k, o in sorted(st.objects.get(route,
                                                               {}).items())
                           if ns is None or k[0] == ns]}).encode()
        self._send_bytes(200, data)

    def _watch(self, route, q) -> None:
        st = self.state
        try:
            since = int(q.get("resourceVersion") or 0)
        except ValueError:
            since = 0
        deadline = time.monotonic() + float(q.get("timeoutSeconds") or 60)
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Connection", "close")
        self.end_headers()
        cursor = since
        with st.lock:
            changed = st.route_log(route).changed
        while True:
            with st.lock:
                batch = st.entries(route, cursor)
                if not batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or st.closed:
                        return
                    changed.wait(min(remaining, 1.0))
                    batch = st.entries(route, cursor)
            for rv, line in batch:
                cursor = rv
                try:
                    self.wfile.write(line)
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    return
            if time.monotonic() >= deadline:
                return

    def do_POST(self):
        if self.path == _CRD_PATH:
            body = self._body() or {}
            st = self.state
            with st.lock:
                if any(c.get("metadata", {}).get("name")
                       == body.get("metadata", {}).get("name")
                       for c in st.crds):
                    return self._status_err(409, "AlreadyExists", "crd exists")
                st.crds.append(body)
            return self._send(201, body)
        parsed = self._parse()
        if parsed is None:
            return self._status_err(404, "NotFound", self.path)
        prefix, ns, plural, name, sub, _q = parsed
        body = self._body() or {}
        st = self.state
        route = (prefix, plural)
        if sub == "binding" and name:
            # the kube-scheduler's bind verb: the only way to set a pod's
            # nodeName (pod specs are immutable to plain PUTs)
            with st.lock:
                cur = st.objects.get(route, {}).get(self._key(ns, name))
                if cur is None:
                    return self._status_err(404, "NotFound",
                                            f"{plural} {name} not found")
                cur.setdefault("spec", {})["nodeName"] = \
                    (body.get("target") or {}).get("name", "")
                cur["metadata"]["resourceVersion"] = str(st.bump())
                st.emit(route, "MODIFIED", cur)
            return self._send(201, {"kind": "Status", "status": "Success"})
        if plural == "events" and prefix == "api/v1":
            with st.lock:
                st.events.append(body)
            return self._send(201, body)
        key = self._key(ns, body)
        with st.lock:
            coll = st.objects.setdefault(route, {})
            if key in coll:
                return self._status_err(409, "AlreadyExists",
                                        f"{plural} {key[1]} already exists")
            err = self._admit(plural, body, None)
            if err:
                return self._status_err(422, "Invalid", err)
            meta = body.setdefault("metadata", {})
            meta.setdefault("uid", str(uuid.uuid4()))
            meta.setdefault("creationTimestamp",
                            k8s_codec.ts_to_k8s(st.clock.now()))
            meta["resourceVersion"] = str(st.bump())
            if ns:
                meta.setdefault("namespace", ns)
            coll[key] = body
            st.emit(route, "ADDED", body)
            data = json.dumps(body).encode()
        self._send_bytes(201, data)

    def do_PUT(self):
        parsed = self._parse()
        if parsed is None or parsed[3] is None:
            return self._status_err(404, "NotFound", self.path)
        prefix, ns, plural, name, sub, _q = parsed
        body = self._body() or {}
        st = self.state
        route = (prefix, plural)
        key = self._key(ns, name)
        with st.lock:
            coll = st.objects.setdefault(route, {})
            cur = coll.get(key)
            if cur is None:
                return self._status_err(404, "NotFound",
                                        f"{plural} {name} not found")
            cur_rv = (cur.get("metadata") or {}).get("resourceVersion")
            sent_rv = (body.get("metadata") or {}).get("resourceVersion")
            if sent_rv and cur_rv and sent_rv != cur_rv:
                return self._status_err(
                    409, "Conflict",
                    f"resourceVersion {sent_rv} is stale (current {cur_rv})")
            if sub == "status":
                cur["status"] = body.get("status")
                cur["metadata"]["resourceVersion"] = str(st.bump())
                st.emit(route, "MODIFIED", cur)
                return self._send_bytes(200, json.dumps(cur).encode())
            err = self._admit(plural, body, cur)
            if err:
                return self._status_err(422, "Invalid", err)
            meta = body.setdefault("metadata", {})
            meta["uid"] = cur["metadata"].get("uid")
            meta.setdefault("creationTimestamp",
                            cur["metadata"].get("creationTimestamp"))
            if cur["metadata"].get("deletionTimestamp"):
                meta["deletionTimestamp"] = cur["metadata"]["deletionTimestamp"]
            meta["resourceVersion"] = str(st.bump())
            if cur["metadata"].get("deletionTimestamp") and \
                    not meta.get("finalizers"):
                # last finalizer dropped on a deleting object: it goes now
                del coll[key]
                st.emit(route, "DELETED", body)
                return self._send(200, body)
            coll[key] = body
            st.emit(route, "MODIFIED", body)
            data = json.dumps(body).encode()
        self._send_bytes(200, data)

    def do_DELETE(self):
        parsed = self._parse()
        if parsed is None or parsed[3] is None:
            return self._status_err(404, "NotFound", self.path)
        prefix, ns, plural, name, _sub, _q = parsed
        st = self.state
        route = (prefix, plural)
        key = self._key(ns, name)
        with st.lock:
            coll = st.objects.setdefault(route, {})
            cur = coll.get(key)
            if cur is None:
                return self._status_err(404, "NotFound",
                                        f"{plural} {name} not found")
            meta = cur.setdefault("metadata", {})
            if meta.get("finalizers"):
                if not meta.get("deletionTimestamp"):
                    meta["deletionTimestamp"] = k8s_codec.ts_to_k8s(
                        st.clock.now())
                    meta["resourceVersion"] = str(st.bump())
                    st.emit(route, "MODIFIED", cur)
                return self._send_bytes(200, json.dumps(cur).encode())
            del coll[key]
            meta["resourceVersion"] = str(st.bump())
            st.emit(route, "DELETED", cur)
        self._send(200, cur)


class EnvtestServer:
    """Lifecycle wrapper: `with EnvtestServer() as srv: ... srv.url ...`."""

    def __init__(self, clock: Optional[Clock] = None, port: int = 0):
        self.state = _State(clock)
        handler = type("Handler", (_Handler,), {"state": self.state})
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="karpenter-envtest")

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address
        return f"http://{host}:{port}"

    def start(self) -> "EnvtestServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop serving; open watches end at once, open connections are
        shut."""
        st = self.state
        with st.lock:
            st.closed = True
            for rl in st.routes.values():
                rl.changed.notify_all()
        self._httpd.shutdown()
        self._httpd.server_close()
        with st.lock:
            connections = list(st.connections)
        for sock in connections:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def __enter__(self) -> "EnvtestServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
