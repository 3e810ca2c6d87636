"""Binary wire framing for the solver sidecar's session protocol.

A frame is a JSON header plus raw binary blobs, so bulk per-pod data rides
as packed arrays instead of JSON (a JSON codec spends more time
serializing 50k pods than the solver spends packing them):

    [4-byte magic "KTPW"] [uint32 header_len] [header JSON] [blob bytes...]

The header's "__blobs__" entry maps blob name -> [offset, length] relative
to the end of the header. Blobs are raw little-endian numpy buffers or
joined string tables; unpack returns zero-copy memoryviews.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, List, Tuple

import numpy as np

MAGIC = b"KTPW"
_SEP = "\x1f"  # string-table separator: illegal in k8s names/UIDs


def pack(header: dict, blobs: Dict[str, bytes] = None) -> bytes:
    blobs = blobs or {}
    index = {}
    off = 0
    parts: List[bytes] = []
    for name, data in blobs.items():
        b = bytes(data) if not isinstance(data, (bytes, bytearray, memoryview)) else data
        index[name] = [off, len(b)]
        off += len(b)
        parts.append(b)
    h = dict(header)
    h["__blobs__"] = index
    hj = json.dumps(h).encode()
    return b"".join([MAGIC, struct.pack("<I", len(hj)), hj] + parts)


def unpack(data: bytes) -> Tuple[dict, Dict[str, memoryview]]:
    if data[:4] != MAGIC:
        raise ValueError("not a KTPW frame")
    (hlen,) = struct.unpack_from("<I", data, 4)
    header = json.loads(bytes(data[8:8 + hlen]).decode())
    base = 8 + hlen
    view = memoryview(data)
    blobs = {name: view[base + off:base + off + ln]
             for name, (off, ln) in header.pop("__blobs__", {}).items()}
    return header, blobs


# -- typed blob helpers ------------------------------------------------------


def pack_u32(values) -> bytes:
    return np.asarray(values, dtype="<u4").tobytes()


def unpack_u32(blob) -> np.ndarray:
    return np.frombuffer(blob, dtype="<u4")


def pack_u16(values) -> bytes:
    return np.asarray(values, dtype="<u2").tobytes()


def unpack_u16(blob) -> np.ndarray:
    return np.frombuffer(blob, dtype="<u2")


def pack_f64(values) -> bytes:
    return np.asarray(values, dtype="<f8").tobytes()


def unpack_f64(blob) -> np.ndarray:
    return np.frombuffer(blob, dtype="<f8")


def pack_strs(strings) -> bytes:
    """Join a string table; k8s object names/UIDs never contain 0x1f."""
    return _SEP.join(strings).encode()


def unpack_strs(blob) -> List[str]:
    if len(blob) == 0:
        return []
    return bytes(blob).decode().split(_SEP)


def content_digest(*parts) -> str:
    """sha256 hex over byte/str parts — the delta-session handshake digest
    primitive. Both ends of the wire hash through this ONE function so a
    representation tweak can never make the two sides disagree about
    identical state (it would instead fail loudly as a permanent mismatch
    in tests)."""
    import hashlib
    h = hashlib.sha256()
    for p in parts:
        h.update(p.encode() if isinstance(p, str) else bytes(p))
        h.update(b"\x1f")
    return h.hexdigest()
