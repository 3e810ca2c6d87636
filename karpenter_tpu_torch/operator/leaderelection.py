"""Leader election for HA operator deployments.

The reference delegates this to a Kubernetes coordination Lease via
controller-runtime (karpenter's pkg/operator/operator.go:137-141:
LeaderElection over leases in kube-system, renewed by the manager; only the
leader runs controllers). Standalone, the shared substrate is the state
directory, so the lease is a file: a JSON record {holder, acquired, renew
deadline} mutated only under an fcntl lock on a sidecar lock file — the
single-host analog of the apiserver's compare-and-swap on resourceVersion.
Multi-host deployments would point this at the real coordination API via a
Lease-shaped adapter; the Operator only sees acquire/renew/release.

Semantics mirror client-go leaderelection: a candidate acquires when the
lease is absent, expired, or already its own; the holder renews every
renew_period; a holder that cannot renew within lease_duration is considered
dead and its lease is stolen.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from ..utils.clock import Clock


class FileLease:
    def __init__(self, path: str, identity: str,
                 lease_duration: float = 15.0,
                 clock: Optional[Clock] = None):
        self.path = path
        self.identity = identity
        self.lease_duration = lease_duration
        self.clock = clock or Clock()

    # -- locked read-modify-write -------------------------------------------

    def _locked(self, fn):
        import fcntl
        lock_path = self.path + ".lock"
        os.makedirs(os.path.dirname(os.path.abspath(lock_path)), exist_ok=True)
        with open(lock_path, "a+") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                return fn()
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)

    def _read(self) -> Optional[dict]:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (FileNotFoundError, ValueError):
            return None

    def _write(self, record: dict) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(record, f)
        os.replace(tmp, self.path)

    # -- API ----------------------------------------------------------------

    def try_acquire(self) -> bool:
        """Acquire or renew; returns True when this identity holds the
        lease afterwards."""
        def attempt():
            now = self.clock.now()
            rec = self._read()
            if rec is not None and rec.get("holder") != self.identity and \
                    rec.get("renew_deadline", 0) > now:
                return False
            self._write({"holder": self.identity, "acquired": now,
                         "renew_deadline": now + self.lease_duration})
            return True
        return self._locked(attempt)

    def renew(self) -> bool:
        """Extend the lease; returns False if it was lost (stolen after an
        expiry — the caller must stop leading immediately)."""
        def attempt():
            now = self.clock.now()
            rec = self._read()
            if rec is None or rec.get("holder") != self.identity:
                return False
            self._write({"holder": self.identity,
                         "acquired": rec.get("acquired", now),
                         "renew_deadline": now + self.lease_duration})
            return True
        return self._locked(attempt)

    def release(self) -> None:
        """Graceful handoff: delete the lease so the next candidate acquires
        without waiting out the expiry."""
        def attempt():
            rec = self._read()
            if rec is not None and rec.get("holder") == self.identity:
                try:
                    os.unlink(self.path)
                except FileNotFoundError:
                    pass
        self._locked(attempt)

    def holder(self) -> Optional[str]:
        rec = self._locked(self._read)
        if rec is None or rec.get("renew_deadline", 0) <= self.clock.now():
            return None
        return rec.get("holder")


class KubeLease:
    """Leader election over a coordination.k8s.io/v1 Lease — the reference's
    actual mechanism (operator.go:137-141: controller-runtime LeaderElection
    with leases in kube-system). The apiserver's resourceVersion CAS is the
    serialization point, so this works across hosts (the FileLease's fcntl
    lock ends at the machine boundary).

    Takes any object with the KubeApiStore's `_request(method, url)` +
    `base_url` surface; tests inject an in-memory CAS double.
    """

    GROUP = "apis/coordination.k8s.io/v1"

    def __init__(self, api_store, identity: str,
                 name: str = "karpenter-tpu-leader-election",
                 namespace: str = "kube-system",
                 lease_duration: float = 15.0,
                 clock: Optional[Clock] = None):
        self.api = api_store
        self.identity = identity
        self.name = name
        self.namespace = namespace
        self.lease_duration = lease_duration
        self.clock = clock or Clock()
        # locally observed record state: (holder, renewTime, rv) -> when WE
        # first saw it. Expiry is judged against this local observation, not
        # the remote renewTime, so another replica's clock skew can't make a
        # healthy leader's lease look expired (client-go does the same)
        self._observed_record = None
        self._observed_at = 0.0

    # -- REST plumbing -------------------------------------------------------

    def _url(self, name: str = "") -> str:
        parts = [self.api.base_url, self.GROUP, "namespaces", self.namespace,
                 "leases"]
        if name:
            parts.append(name)
        return "/".join(parts)

    def _get(self) -> Optional[dict]:
        import urllib.error
        try:
            return self.api._request("GET", self._url(self.name))
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    @staticmethod
    def _micro(ts: float) -> str:
        from datetime import datetime, timezone
        return datetime.fromtimestamp(ts, tz=timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%S.%fZ")

    @staticmethod
    def _from_micro(s: Optional[str]) -> float:
        if not s:
            return 0.0
        from datetime import datetime, timezone
        for fmt in ("%Y-%m-%dT%H:%M:%S.%fZ", "%Y-%m-%dT%H:%M:%SZ"):
            try:
                return datetime.strptime(s, fmt).replace(
                    tzinfo=timezone.utc).timestamp()
            except ValueError:
                continue
        return 0.0

    def _expired(self, live: dict, now: float) -> bool:
        spec = live.get("spec") or {}
        if not spec.get("holderIdentity"):
            return True  # released: free immediately
        record = (spec.get("holderIdentity"), spec.get("renewTime"),
                  (live.get("metadata") or {}).get("resourceVersion"))
        if record != self._observed_record:
            # the record changed since we last looked: the holder is alive
            # by OUR clock as of now — restart the local expiry window
            self._observed_record = record
            self._observed_at = now
            return False
        duration = spec.get("leaseDurationSeconds") or self.lease_duration
        return now - self._observed_at >= duration

    # -- API (FileLease-compatible) ------------------------------------------

    def try_acquire(self) -> bool:
        import urllib.error
        now = self.clock.now()
        live = self._get()
        if live is None:
            body = {"apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
                    "metadata": {"name": self.name,
                                 "namespace": self.namespace},
                    "spec": {"holderIdentity": self.identity,
                             "leaseDurationSeconds": int(self.lease_duration),
                             "acquireTime": self._micro(now),
                             "renewTime": self._micro(now),
                             "leaseTransitions": 0}}
            try:
                self.api._request("POST", self._url(), body)
                return True
            except urllib.error.HTTPError as e:
                if e.code == 409:  # raced another candidate
                    return False
                raise
        spec = live.get("spec") or {}
        holder = spec.get("holderIdentity")
        if holder == self.identity:
            return self._renew(live)
        if not self._expired(live, now):
            return False
        # expired: steal, CAS-guarded by resourceVersion
        spec.update({"holderIdentity": self.identity,
                     "acquireTime": self._micro(now),
                     "renewTime": self._micro(now),
                     "leaseDurationSeconds": int(self.lease_duration),
                     "leaseTransitions": (spec.get("leaseTransitions") or 0)
                     + 1})
        live["spec"] = spec
        try:
            self.api._request("PUT", self._url(self.name), live)
            return True
        except urllib.error.HTTPError as e:
            if e.code == 409:
                return False
            raise

    def renew(self) -> bool:
        live = self._get()
        if live is None:
            return False
        return self._renew(live)

    def _renew(self, live: dict) -> bool:
        """Extend an already-fetched lease; CAS via resourceVersion."""
        import urllib.error
        spec = live.get("spec") or {}
        if spec.get("holderIdentity") != self.identity:
            return False
        spec["renewTime"] = self._micro(self.clock.now())
        live["spec"] = spec
        try:
            self.api._request("PUT", self._url(self.name), live)
            return True
        except urllib.error.HTTPError as e:
            if e.code == 409:
                return False
            raise

    def release(self) -> None:
        """Graceful handoff, CAS-guarded: an unconditional DELETE could
        remove a lease another replica legitimately stole between our GET
        and the delete (client-go instead CAS-writes a 1s duration). A 409
        means the lease changed hands — leave it alone."""
        import urllib.error
        live = self._get()
        if live is None:
            return
        spec = live.get("spec") or {}
        if spec.get("holderIdentity") != self.identity:
            return
        spec.update({"holderIdentity": "",
                     "leaseDurationSeconds": 1,
                     "renewTime": self._micro(self.clock.now()
                                              - self.lease_duration)})
        live["spec"] = spec
        try:
            self.api._request("PUT", self._url(self.name), live)
        except urllib.error.HTTPError as e:
            if e.code not in (404, 409):
                raise

    def holder(self) -> Optional[str]:
        live = self._get()
        if live is None:
            return None
        if self._expired(live, self.clock.now()):
            return None
        return (live.get("spec") or {}).get("holderIdentity")
