"""Per-node host-port conflict tracking.

Mirrors karpenter's pkg/scheduling/hostportusage.go:34-113: a port entry
conflicts when (ip equal, or either side binds 0.0.0.0) and port+protocol match.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..api.objects import HostPort, Pod

WILDCARD = _WILDCARD = "0.0.0.0"


def ips_overlap(a: str, b: str) -> bool:
    """The ONE ip-overlap rule (hostportusage.go:56-60): equal, or either
    side binds the wildcard. Every conflict predicate routes through it."""
    return a == b or a == _WILDCARD or b == _WILDCARD


@dataclass(frozen=True)
class _Entry:
    pod_uid: str
    ip: str
    port: int
    protocol: str

    def conflicts(self, other: "_Entry") -> bool:
        if self.port != other.port or self.protocol != other.protocol:
            return False
        return ips_overlap(self.ip, other.ip)


def get_host_ports(pod: Pod) -> "list[_Entry]":
    out = []
    for hp in pod.spec.host_ports:
        ip = hp.host_ip or _WILDCARD
        out.append(_Entry(pod_uid=pod.uid, ip=ip, port=hp.port, protocol=hp.protocol))
    return out


class HostPortUsage:
    """Bucketed by (port, protocol): a conflict requires both to match, so
    each candidate port only scans its own bucket — the flat-list scan was
    the host oracle's hottest loop at 50k host-port pods."""

    __slots__ = ("_by_port",)

    def __init__(self):
        self._by_port: "dict[tuple[int, str], List[_Entry]]" = {}

    def conflicts(self, pod: Pod, ports: "list[_Entry]") -> "list[str]":
        errs = []
        for p in ports:
            for existing in self._by_port.get((p.port, p.protocol), ()):
                # a pod never conflicts with its own tracked ports
                # (hostportusage.go Conflicts:75-86)
                if existing.pod_uid != pod.uid and p.conflicts(existing):
                    errs.append(
                        f"port {p.port}/{p.protocol} on ip {p.ip} conflicts with existing usage")
        return errs

    def add(self, pod: Pod, ports: "list[_Entry]") -> None:
        for p in ports:
            self._by_port.setdefault((p.port, p.protocol), []).append(p)

    def delete_pod(self, pod_uid: str) -> None:
        for key in list(self._by_port):
            kept = [e for e in self._by_port[key] if e.pod_uid != pod_uid]
            if kept:
                self._by_port[key] = kept
            else:
                del self._by_port[key]

    def copy(self) -> "HostPortUsage":
        out = HostPortUsage()
        out._by_port = {k: list(v) for k, v in self._by_port.items()}
        return out

    def entries(self) -> "list[_Entry]":
        """Every tracked port entry — the serialization surface (sidecar
        wire codec, flight recorder); keeps _by_port's layout private."""
        return [e for es in self._by_port.values() for e in es]

    def add_entries(self, entries) -> None:
        """Rebuild-side twin of entries() for wire decoders."""
        for e in entries:
            self._by_port.setdefault((e.port, e.protocol), []).append(e)

    def conflicts_triples(self, triples) -> bool:
        """Conflict check for anonymous (ip, port, protocol) triples — the
        tensor packer's existing-node exclusion (no pod identity: a group's
        ports either fit a node or they don't)."""
        for ip, port, protocol in triples:
            for e in self._by_port.get((port, protocol), ()):
                if ips_overlap(ip, e.ip):
                    return True
        return False


def triples_conflict(a, b) -> bool:
    """Whether any port of triple-set a conflicts with any of b
    (hostportusage.go:56-60 pairwise: port+protocol equal and IPs overlap
    via the wildcard)."""
    for ip1, port1, proto1 in a:
        for ip2, port2, proto2 in b:
            if port1 == port2 and proto1 == proto2 and ips_overlap(ip1, ip2):
                return True
    return False
