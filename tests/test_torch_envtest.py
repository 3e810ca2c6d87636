"""The port's in-process apiserver (karpenter_tpu_torch/kube/envtest.py)
against the JAX package's:

- tests/test_apiserver_adapter.py's seven ``TestEnvtest`` cases for every
  pair of store package and server package;
- a seeded write sequence (creates, updates, a stale PUT, a finalized
  delete and its release, the status and binding subresources, a 422, a
  CRD and an Event POST, lists and a 404) sent to both servers: the same
  status codes and bodies, then the same watch lines from several
  resourceVersions of every route, each watch ending at its timeout. The
  server's uids (uuid4) are renamed by first appearance before comparing;
- the watch's work: while 2,000 pods are written with a store's five
  watches open, the port's watch reads only the log entries it delivers,
  where the reference's rescans the whole log on every wake-up;
- the timestamps follow the injected clock.
"""

import importlib
import json
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_torch_support import JAX, PORT, ROOTS, factories
from test_torch_support import device_series_kept  # noqa: F401 (autouse)
from test_torch_support import tracer_kept  # noqa: F401 (autouse)

PAIRS = [(store, server) for store in ROOTS for server in ROOTS]


def _mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


# -- tests/test_apiserver_adapter.py TestEnvtest, for every pair -------------

@pytest.fixture(params=PAIRS, ids=[f"{s.split('_')[-1]}-store-"
                                   f"{v.split('_')[-1]}-server"
                                   for s, v in PAIRS])
def env(request):
    store_root, server_root = request.param
    srv = _mod(server_root, "kube.envtest").EnvtestServer()
    with srv:
        store = _mod(store_root, "kube.apiserver").KubeApiStore(
            srv.url, clock=_mod(store_root, "utils.clock").Clock())
        store._envtest = srv
        yield store_root, store
        store.stop_watches()


def test_crud_round_trip_over_http(env):
    root, store = env
    Pod = _mod(root, "api.objects").Pod
    store.create(factories(root).make_pod(cpu="250m", name="envtest-pod",
                                          labels={"app": "x"}))
    live = store.get(Pod, "envtest-pod", "default")
    assert live is not None and live.labels == {"app": "x"}
    assert live.metadata.uid and live.metadata.resource_version
    live.spec.node_name = "some-node"
    store.update(live)
    again = store.get(Pod, "envtest-pod", "default")
    assert again.spec.node_name == "some-node"
    store.delete(again)
    assert store.get(Pod, "envtest-pod", "default") is None


def test_stale_resource_version_conflicts(env):
    root, store = env
    o = _mod(root, "api.objects")
    store.create(o.Node(metadata=o.ObjectMeta(name="rv-node", namespace=""),
                        spec=o.NodeSpec(provider_id="t://rv")))
    first = store.get(o.Node, "rv-node")
    store.update(store.get(o.Node, "rv-node"))  # bumps RV
    first.metadata.labels["stale"] = "write"
    with pytest.raises(_mod(root, "kube.store").ConflictError):
        store.update(first)


def test_finalizer_gates_deletion(env):
    root, store = env
    o = _mod(root, "api.objects")
    store.create(o.Node(metadata=o.ObjectMeta(
        name="fin-node", namespace="", finalizers=["karpenter.sh/test"]),
        spec=o.NodeSpec(provider_id="t://fin")))
    store.delete(store.get(o.Node, "fin-node"))
    live = store.get(o.Node, "fin-node")
    assert live is not None, "finalized object removed prematurely"
    assert live.metadata.deletion_timestamp is not None
    store.remove_finalizer(live, "karpenter.sh/test")
    assert store.get(o.Node, "fin-node") is None


def test_admission_rejects_over_http(env):
    root, store = env
    np_ = _mod(root, "api.nodepool")
    bad = factories(root).make_nodepool(name="bad-pool")
    bad.spec.disruption.budgets = [np_.Budget(nodes="150%")]
    with pytest.raises(_mod(root, "kube.store").InvalidError):
        store.create(bad)
    assert store.get(np_.NodePool, "bad-pool") is None


def test_recorder_sink_posts_real_events(env):
    root, store = env
    rec = _mod(root, "events.recorder").Recorder(
        _mod(root, "utils.clock").FakeClock(), sink=store.post_event)
    rec.publish(_mod(root, "events.catalog").evict_pod(
        factories(root).make_pod(name="evicted-pod")))
    [ev] = store._envtest.state.events
    assert ev["reason"] == "Evicted"
    assert ev["involvedObject"]["name"] == "evicted-pod"
    assert ev["source"] == {"component": "karpenter"}


def test_watch_streams_store_changes(env):
    root, store = env
    seen = []
    store.watch(seen.append)
    store.start_watches(kinds=(_mod(root, "api.objects").Pod,))
    store.create(factories(root).make_pod(cpu="100m", name="watched-pod"))
    deadline = time.time() + 10
    while time.time() < deadline:
        store.pump_events()
        if any(e.obj.metadata.name == "watched-pod" for e in seen):
            break
        time.sleep(0.05)
    assert any(e.obj.metadata.name == "watched-pod" for e in seen), \
        "watch stream never delivered the pod"


def test_operator_provision_loop_e2e(env):
    """The control loop against the live wire: NodePool + pending Pod in,
    NodeClaim launched, Node fabricated, pod bound."""
    root, store = env
    m = lambda name: _mod(root, name)  # noqa: E731
    clock = m("utils.clock").Clock()
    cluster = m("state.cluster").Cluster(store, clock)
    m("state.informers").wire_informers(store, cluster)
    provider = m("cloudprovider.kwok").KwokCloudProvider(store=store)
    mgr = m("controllers.manager").Manager(store, clock)
    prov = m("provisioning.provisioner")
    kw = {"device": "cpu"} if root == PORT else {}
    provisioner = prov.Provisioner(store, cluster, provider, clock, **kw)
    mgr.register(provisioner, prov.PodTrigger(provisioner),
                 prov.Binder(store, cluster, provisioner),
                 m("controllers.nodeclaim_lifecycle").NodeClaimLifecycle(
                     store, cluster, provider, clock))
    store.start_watches()
    store.apply(factories(root).make_nodepool(name="envtest-default"))
    pod = factories(root).make_pod(cpu="100m", name="envtest-e2e-pod")
    store.apply(pod)
    Pod = m("api.objects").Pod
    deadline = time.time() + 60
    bound = None
    while time.time() < deadline:
        store.pump_events()
        mgr.run_until_quiet()
        live = store.get(Pod, pod.metadata.name, pod.metadata.namespace)
        if live is not None and live.spec.node_name:
            bound = live
            break
        time.sleep(0.2)
    assert bound is not None, "pod never bound through the apiserver"
    labels = m("api.labels")
    assert any(c.metadata.labels.get(labels.NODEPOOL_LABEL_KEY)
               == "envtest-default"
               for c in store.list(m("api.nodeclaim").NodeClaim))
    assert store.list(m("api.objects").Node), \
        "no node materialized through the wire"


# -- a seeded write sequence through both servers -----------------------------

_UID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
                  r"[0-9a-f]{12}")
WATCHED = ("api/v1/pods", "api/v1/nodes", "apis/karpenter.sh/v1/nodepools",
           "apis/karpenter.sh/v1/nodeclaims")
#: a watch's timeout: every watch of the sequence ends at it
WATCH_TIMEOUT_S = 0.3


def _call(url: str, method: str, path: str, body=None) -> tuple:
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _renamed(text: str, uids: dict) -> str:
    return _UID.sub(lambda m: uids.setdefault(m.group(0),
                                              f"uid-{len(uids)}"), text)


def _sequence(seed: int) -> list:
    """(method, path, body) requests drawn from ``seed``; a body of None
    for a PUT means "the object as the server last returned it"."""
    import copy
    from karpenter_tpu_torch.api import crds
    from karpenter_tpu_torch.kube import k8s_codec as kc
    rng = np.random.default_rng(seed)
    F = factories(PORT)
    reqs = [("POST", "/apis/apiextensions.k8s.io/v1/"
             "customresourcedefinitions", crds.nodepool_crd()),
            ("POST", "/apis/apiextensions.k8s.io/v1/"
             "customresourcedefinitions", crds.nodepool_crd())]
    pool = kc.nodepool_to_k8s(F.make_nodepool(name="default"))
    reqs.append(("POST", "/apis/karpenter.sh/v1/nodepools", pool))
    bad = F.make_nodepool(name="bad")
    bad.spec.disruption.budgets = [
        _mod(PORT, "api.nodepool").Budget(nodes="150%")]
    reqs.append(("POST", "/apis/karpenter.sh/v1/nodepools",
                 kc.nodepool_to_k8s(bad)))
    n_pods = int(rng.integers(4, 9))
    names = []
    for i in range(n_pods):
        cpu = f"{int(rng.integers(1, 20)) * 50}m"
        pod = F.make_pod(cpu=cpu, name=f"sq-{seed}-{i}",
                         labels={"app": f"a{int(rng.integers(0, 3))}"})
        names.append(pod.metadata.name)
        reqs.append(("POST", "/api/v1/namespaces/default/pods",
                     kc.pod_to_k8s(pod)))
    reqs.append(("POST", "/api/v1/namespaces/default/pods",
                 kc.pod_to_k8s(F.make_pod(name=names[0]))))   # 409
    for name in rng.choice(names, size=3, replace=False):
        reqs.append(("PUT", f"/api/v1/namespaces/default/pods/{name}",
                     ("labels", {"moved": str(name)})))
    reqs.append(("PUT", f"/api/v1/namespaces/default/pods/{names[1]}",
                 ("stale", None)))                             # 409
    for i, name in enumerate(names[2:5]):
        reqs.append(("POST",
                     f"/api/v1/namespaces/default/pods/{name}/binding",
                     {"apiVersion": "v1", "kind": "Binding",
                      "metadata": {"name": name, "namespace": "default"},
                      "target": {"kind": "Node", "name": f"node-{i}"}}))
    node = {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": "fin", "finalizers": ["karpenter.sh/t"]},
            "spec": {"providerID": "t://fin"}}
    reqs += [("POST", "/api/v1/nodes", node),
             ("DELETE", "/api/v1/nodes/fin", None),
             ("CLOCK", 30.0, None),
             ("DELETE", "/api/v1/nodes/fin", None),
             ("PUT", "/api/v1/nodes/fin", ("finalizers", [])),
             ("GET", "/api/v1/nodes/fin", None),
             ("DELETE", f"/api/v1/namespaces/default/pods/{names[-1]}",
              None)]
    claim = copy.deepcopy(kc.nodeclaim_to_k8s(
        _mod(PORT, "api.nodeclaim").NodeClaim(
            metadata=_mod(PORT, "api.objects").ObjectMeta(
                name=f"claim-{seed}", namespace=""))))
    reqs += [("POST", "/apis/karpenter.sh/v1/nodeclaims", claim),
             ("PUT", f"/apis/karpenter.sh/v1/nodeclaims/claim-{seed}/status",
              ("status", {"providerID": f"kwok://{seed}",
                          "conditions": [{"type": "Launched",
                                          "status": "True"}]})),
             ("POST", "/api/v1/namespaces/default/events",
              {"apiVersion": "v1", "kind": "Event",
               "metadata": {"name": "ev", "namespace": "default"},
               "reason": "Seeded", "message": str(seed)}),
             ("GET", "/api/v1/pods", None),
             ("GET", "/api/v1/namespaces/other/pods", None),
             ("GET", "/api/v1/namespaces/default/pods/absent", None),
             ("GET", "/apis/karpenter.sh/v1/nodepools", None)]
    for _, _, body in reqs:
        # the factories' uids count per process: the server assigns them
        if isinstance(body, dict):
            body.get("metadata", {}).pop("uid", None)
    return reqs


def _drive(root: str, seed: int) -> dict:
    """The sequence through ``root``'s server on a FakeClock: each answer,
    then every watch line of each route from resourceVersion 0, a middle
    one and the last."""
    clock = _mod(root, "utils.clock").FakeClock(1_700_000_000.0)
    uids: dict = {}
    answers, last = [], {}
    with _mod(root, "kube.envtest").EnvtestServer(clock=clock) as srv:
        for method, path, body in _sequence(seed):
            if method == "CLOCK":
                clock.step(path)
                continue
            if method == "PUT":
                what, value = body
                obj_path = path[:-len("/status")] \
                    if path.endswith("/status") else path
                body = json.loads(last[obj_path])
                if what == "stale":
                    body["metadata"]["resourceVersion"] = "1"
                elif what == "status":
                    body["status"] = value
                else:
                    body["metadata"][what] = value
            code, text = _call(srv.url, method, path, body)
            if code in (200, 201) and method != "CLOCK":
                try:
                    obj = json.loads(text)
                except ValueError:
                    obj = {}
                name = (obj.get("metadata") or {}).get("name")
                if name and obj.get("kind") not in ("List", "Status"):
                    base = path if method != "POST" or path.endswith(
                        "/binding") else f"{path}/{name}"
                    last[base.removesuffix("/status")] = text
            answers.append((method, path, code, _renamed(text, uids)))
        rv = srv.state.rv
        raw = {}

        def watch(route, since):
            t0 = time.monotonic()
            with urllib.request.urlopen(
                    f"{srv.url}/{route}?watch=true&resourceVersion="
                    f"{since}&timeoutSeconds={WATCH_TIMEOUT_S}",
                    timeout=30) as resp:
                raw[f"{route}@{since}"] = (list(resp),
                                           time.monotonic() - t0)
        threads = [threading.Thread(target=watch, args=(route, since))
                   for route in WATCHED for since in (0, rv // 2, rv)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        watches = {}
        for key in sorted(raw):
            lines, took = raw[key]
            assert took >= WATCH_TIMEOUT_S * 0.9, (key, took)
            watches[key] = [_renamed(ln.decode(), uids) for ln in lines]
        events = [json.dumps(e) for e in srv.state.events]
        crds = [json.dumps(c) for c in srv.state.crds]
    return {"answers": answers, "watches": watches, "events": events,
            "crds": crds, "rv": rv}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_sequence_answers_and_watches_as_the_reference(seed):
    want, got = _drive(JAX, seed), _drive(PORT, seed)
    assert got["rv"] == want["rv"]
    for w, g in zip(want["answers"], got["answers"], strict=True):
        assert g == w
    codes = {a[2] for a in got["answers"]}
    assert {200, 201, 404, 409, 422} <= codes, codes
    assert got["watches"] == want["watches"]
    assert any(got["watches"].values())
    assert got["events"] == want["events"] and got["crds"] == want["crds"]


# -- the watch's work ----------------------------------------------------------

class _CountingLog(list):
    """A list that counts the items its iterations yield."""

    def __init__(self, items=()):
        super().__init__(items)
        self.read = 0

    def __iter__(self):
        for item in super().__iter__():
            self.read += 1
            yield item


def _write_pods(root: str, n: int, monkeypatch) -> tuple:
    """``n`` pods POSTed through ``root``'s KubeApiStore to ``root``'s
    server while a second store's five watch streams are open; returns
    (log entries the watches read, lines they delivered)."""
    envtest = _mod(root, "kube.envtest")
    examined = [0]
    if root == PORT:
        entries = envtest._State.entries

        def counted(self, route, cursor):
            out = entries(self, route, cursor)
            examined[0] += len(out)
            return out
        monkeypatch.setattr(envtest._State, "entries", counted)
    Clock = _mod(root, "utils.clock").Clock
    api = _mod(root, "kube.apiserver")
    with envtest.EnvtestServer() as srv:
        srv.state.log = log = _CountingLog()
        watcher = api.KubeApiStore(srv.url, clock=Clock())
        delivered = [0]
        watcher.watch(lambda ev: delivered.__setitem__(0, delivered[0] + 1))
        watcher.start_watches()
        writer = api.KubeApiStore(srv.url, clock=Clock())
        F = factories(root)
        for i in range(n):
            writer.create(F.make_pod(cpu="100m", name=f"lw-{i}"))
        deadline = time.time() + 60
        while delivered[0] < n and time.time() < deadline:
            watcher.pump_events()
            time.sleep(0.02)
        watcher.stop_watches()
    return examined[0] + log.read, delivered[0]


def test_watch_reads_only_what_it_delivers(monkeypatch):
    n = 2_000
    examined, delivered = _write_pods(PORT, n, monkeypatch)
    assert delivered == n
    # each pod's line is read once, by the one watch of its route; the
    # global log is never walked
    assert examined == n, (examined, delivered)


def test_reference_watch_rescans_the_log(monkeypatch):
    """The same writes through the JAX package's server: its five watches
    read the whole log on every wake-up (at least 50 entries a pod where
    the port reads one)."""
    n = 500
    examined, delivered = _write_pods(JAX, n, monkeypatch)
    assert delivered == n
    assert examined > 50 * n, examined


def apply_ms_per_pod(root: str, n: int) -> float:
    """Milliseconds a pod for ``root``'s KubeApiStore to create ``n`` pods
    on ``root``'s EnvtestServer while a second store's five watches run
    (the wire's cost as the pods of a burst arrive)."""
    envtest = _mod(root, "kube.envtest")
    api = _mod(root, "kube.apiserver")
    Clock = _mod(root, "utils.clock").Clock
    F = factories(root)
    with envtest.EnvtestServer() as srv:
        watcher = api.KubeApiStore(srv.url, clock=Clock())
        watcher.start_watches()
        writer = api.KubeApiStore(srv.url, clock=Clock())
        pods = [F.make_pod(cpu="100m", name=f"rate-{i}") for i in range(n)]
        t0 = time.perf_counter()
        for p in pods:
            writer.apply(p)
        ms = 1e3 * (time.perf_counter() - t0) / n
        watcher.stop_watches()
    return ms


def test_watch_batches_are_snapshots():
    """A write after an entry was logged does not change that entry's
    line or the ordered log's object."""
    from karpenter_tpu_torch.kube.envtest import _State
    st = _State()
    obj = {"metadata": {"name": "a", "resourceVersion": "1"}}
    route = ("api/v1", "pods")
    with st.lock:
        st.bump()
        st.emit(route, "ADDED", obj)
        obj["metadata"]["name"] = "mutated"
        [(rv, line)] = st.entries(route, 0)
    assert rv == 1 and json.loads(line)["object"]["metadata"]["name"] == "a"
    assert st.log[0][3]["metadata"]["name"] == "a"
    assert st.entries(route, 1) == [] and st.entries(("x", "y"), 0) == []


def test_a_write_wakes_only_its_route():
    """A watch on nodes sleeps through pod writes; a node write wakes
    it."""
    from karpenter_tpu_torch.kube.envtest import EnvtestServer
    with EnvtestServer() as srv:
        woke = []
        changed = srv.state.route_log(("api/v1", "nodes")).changed

        def wait():
            with srv.state.lock:
                woke.append(changed.wait(2.0))
        t = threading.Thread(target=wait)
        t.start()
        time.sleep(0.1)
        _call(srv.url, "POST", "/api/v1/namespaces/default/pods",
              {"metadata": {"name": "p"}})
        t.join()
        t = threading.Thread(target=wait)
        t.start()
        time.sleep(0.1)
        _call(srv.url, "POST", "/api/v1/nodes", {"metadata": {"name": "n"}})
        t.join()
    assert woke == [False, True]


def test_store_recovers_when_the_server_comes_back():
    """The port's store keeps one connection a thread: a 404 leaves it
    in use; once the server has gone, every call fails with URLError (not
    http.client's CannotSendRequest from a connection left mid-call); a
    server started on the same port answers the next call."""
    from karpenter_tpu_torch.api.objects import Pod
    from karpenter_tpu_torch.kube.apiserver import KubeApiStore
    from karpenter_tpu_torch.kube.envtest import EnvtestServer
    from karpenter_tpu_torch.utils.clock import Clock
    make_pod = factories(PORT).make_pod
    first = EnvtestServer().start()
    port = first._httpd.server_address[1]
    store = KubeApiStore(first.url, clock=Clock())
    store.create(make_pod(cpu="250m", name="before"))
    conn = store._local.conn
    assert store.get(Pod, "missing", "default") is None
    assert store._local.conn is conn
    first.stop()
    for _ in range(2):
        with pytest.raises(urllib.error.URLError) as err:
            store.get(Pod, "before", "default")
        assert not isinstance(err.value, urllib.error.HTTPError)
        assert store._local.conn is None
    with EnvtestServer(port=port) as second:
        assert second.url == first.url
        store.create(make_pod(cpu="250m", name="after"))
        assert store.get(Pod, "after", "default") is not None
        assert store.get(Pod, "before", "default") is None


def test_envtest_timestamps_follow_injected_clock():
    from karpenter_tpu_torch.kube.envtest import EnvtestServer
    from karpenter_tpu_torch.kube.k8s_codec import ts_to_k8s
    from karpenter_tpu_torch.utils.clock import FakeClock
    clock = FakeClock(1_700_000_000.0)
    with EnvtestServer(clock=clock) as srv:
        req = urllib.request.Request(
            f"{srv.url}/api/v1/namespaces/default/pods",
            data=json.dumps({
                "apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": "p1",
                             "finalizers": ["test/finalizer"]},
                "spec": {}}).encode(),
            method="POST", headers={"Content-Type": "application/json"})
        created = json.loads(urllib.request.urlopen(req).read())
        assert created["metadata"]["creationTimestamp"] == \
            ts_to_k8s(1_700_000_000.0)
        clock.step(30.0)
        req = urllib.request.Request(
            f"{srv.url}/api/v1/namespaces/default/pods/p1", method="DELETE")
        deleted = json.loads(urllib.request.urlopen(req).read())
        assert deleted["metadata"]["deletionTimestamp"] == \
            ts_to_k8s(1_700_000_030.0)


if __name__ == "__main__":
    # python tests/test_torch_envtest.py [n ...]: each package's store
    # applying n pods to its own server with five watches open
    import sys
    import conftest  # noqa: F401 (the JAX package on the CPU)
    for n in [int(a) for a in sys.argv[1:]] or [2_000, 5_000]:
        for root in ROOTS:
            print(json.dumps({"server": root, "pods": n,
                              "ms_per_pod": apply_ms_per_pod(root, n)}),
                  flush=True)
