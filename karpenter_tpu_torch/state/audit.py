"""Anti-entropy for the warm state: the StateAuditor.

Every hot path is warm and incremental — the shared EncodePlane's
node/group rows and exist stacks, the topo-count memos, the warm-pack
checkpoints — and each one promises decisions bit-identical to a cold
rebuild *by contract*. The auditor enforces that contract continuously:

* **Lazy digest checks on reuse.** Each cached artifact carries (or is
  shadowed by) a crc32 content digest recorded when it was built. Every
  serve re-derives the digest from the bytes about to be served and
  compares; a corrupted entry is therefore detected BEFORE its content
  reaches a solve.
* **Sampled shadow audits every pass.** Digests catch mutation of the
  stored bytes but not a stale-build (digest recorded over already-wrong
  content). So each pass additionally re-encodes K randomly chosen
  node rows cold, re-encodes a sampled group row, and recomputes one
  topo-memo entry from the cluster, byte-comparing against the cache.
  K is a knob; the work is amortized so headline overhead stays <= 5%
  (asserted by BENCH_MODE=audit).
* **Quarantine, per layer.** On mismatch the offending LAYER drops to a
  cold rebuild for the pass (node-row generations + stacks wiped, group
  rows cleared, topo memo cleared, warm seed dropped) and exactly one
  incident fires: `karpenter_state_audit_total{layer,outcome="corrupt"}`,
  a `StateCorruption` warning event, and a flight-recorder dump. The
  pass still produces correct decisions. Quarantine is per-layer, not
  per-row: one detected flip means the layer's invariants can no longer
  be trusted (the corruptor that hit one row may have hit its siblings),
  and a layer rebuild is exactly one cold pass — cheap insurance.

The device-loss half of the anti-entropy story (the degradation ladder)
lives in parallel/mesh.resilient_precompute; its breaker outcomes share
the `karpenter_state_audit_total` family under layer="device".
"""

from __future__ import annotations

import random
import struct
import time
import zlib
from collections import Counter, OrderedDict
from typing import Any, Callable, Dict, List, Optional

import numpy as np

#: cache layers the auditor guards (utils/chaos.StateCorruptor mirrors it)
LAYERS = ("node_rows", "group_rows", "exist_stack", "topo_memo",
          "warm_checkpoint")


# -- content digests ---------------------------------------------------------


def content_digest(obj: Any) -> int:
    """Order-stable crc32 over the CONTENT of a nested artifact: ndarray
    bytes (dtype + shape + raw buffer), scalars, strings, containers, and
    dataclass-ish objects (PackSeed/PackCheckpoint/EncodedRequirements)
    via their field dicts. Anything else digests by repr — stable for the
    lifetime of the cached object, which is the window the digest guards."""
    return _crc(obj, 0)


def _crc(obj: Any, crc: int, _crc32=zlib.crc32, _pack=struct.pack) -> int:
    # this runs once per cached artifact per SERVE (the lazy reuse check),
    # so the common leaves — ndarrays, ints, strs — take the fast exits:
    # buffer-protocol crc32 with no tobytes() copy, struct-packed floats,
    # and no repr-keyed sorting on the hot paths
    if isinstance(obj, np.ndarray):
        crc = _crc32(f"a{obj.dtype.str}{obj.shape}".encode(), crc)
        if not obj.flags.c_contiguous:
            obj = np.ascontiguousarray(obj)
        return _crc32(obj, crc)
    if obj is None:
        return _crc32(b"\x00n", crc)
    if isinstance(obj, bool):
        return _crc32(b"\x01" if obj else b"\x02", crc)
    if isinstance(obj, int):
        return _crc32(b"i" + str(obj).encode(), crc)
    if isinstance(obj, float):
        return _crc32(b"f" + _pack("<d", obj), crc)
    if isinstance(obj, str):
        return _crc32(b"s" + obj.encode("utf-8", "replace"), crc)
    if isinstance(obj, (bytes, bytearray)):
        return _crc32(bytes(obj), _crc32(b"b", crc))
    if isinstance(obj, (tuple, list)):
        crc = _crc32(b"(", crc)
        for item in obj:
            crc = _crc(item, crc)
        return crc
    if isinstance(obj, dict):
        # plain data dicts sort so key order can't alias; repr-keying is
        # only needed for the rare non-string key
        crc = _crc32(b"{", crc)
        try:
            keys = sorted(obj)
        except TypeError:
            keys = sorted(obj, key=repr)
        for k in keys:
            crc = _crc(k, crc)
            crc = _crc(obj[k], crc)
        return crc
    if isinstance(obj, (set, frozenset)):
        crc = _crc32(b"#", crc)
        for item in sorted(obj, key=repr):
            crc = _crc(item, crc)
        return crc
    fields = getattr(obj, "__dict__", None)
    if fields is not None:
        # field ORDER is class-construction order — deterministic between
        # the recorded and the recomputed digest of the same type, so the
        # dict branch's sort (and its cost) is skipped
        crc = _crc32(b"o" + type(obj).__name__.encode(), crc)
        for k, v in fields.items():
            crc = _crc32(k.encode(), crc)
            crc = _crc(v, crc)
        return crc
    return _crc32(b"r" + repr(obj).encode("utf-8", "replace"), crc)


_CHECKPOINT_FIELDS = ("pos", "C", "rows", "existing", "error_log",
                      "exist_avail", "limits", "limit_constrained",
                      "g_of_pos")


def warm_digest(seed, shard_seeds) -> Optional[int]:
    """Digest of the warm-pack checkpoint state whose SILENT corruption
    could replay wrong decisions: each seed's per-group prefix tokens plus
    its checkpoints' numeric packer state. The global token (which embeds
    the whole vocab — megabytes of encoding the digest must not walk every
    pass) and pods_by_group (a live object graph) are excluded
    deliberately: corrupting either breaks the token/prefix match and
    forces a cold pack — self-healing, never silent."""
    seeds = [seed] if seed is not None else []
    seeds += [s for s in (shard_seeds or []) if s is not None]
    if not seeds:
        return None
    crc = 0
    for s in seeds:
        crc = zlib.crc32(b"S", crc)
        crc = _crc(getattr(s, "ffd_tokens", None), crc)
        for ck in getattr(s, "checkpoints", None) or ():
            crc = zlib.crc32(b"C", crc)
            for f in _CHECKPOINT_FIELDS:
                crc = _crc(getattr(ck, f, None), crc)
    return crc


def row_digest(row: tuple, _crc32=zlib.crc32) -> int:
    """Digest of a node-row's CONTENT fields (everything past the revision
    token, excluding a trailing digest element if one is present).

    Hand-specialized over the row's known shape — (rev, encoded
    requirements, avail vector, zone idx, taints) — because this runs once
    per cached row per SERVE: at fleet scale the generic walker's dispatch
    overhead IS the auditor's headline cost. Raw buffers crc directly
    (no tobytes() copy, no per-array dtype/shape header: the array count
    and order are fixed by the row layout, and every corruption kind the
    layer admits — flip, stale value, truncation — changes the byte
    stream). Falls back to the generic walker on any unexpected shape."""
    e = row[1]
    try:
        crc = _crc32(e.mask, 0)
        crc = _crc32(e.defined, crc)
        crc = _crc32(e.complement, crc)
        crc = _crc32(e.exempt, crc)
        crc = _crc32(e.gt, crc)
        crc = _crc32(e.lt, crc)
        crc = _crc32(row[2], crc)
        crc = _crc32(b"i%d" % row[3], crc)
    except (AttributeError, BufferError, TypeError, ValueError):
        return content_digest(row[1:5])
    taints = row[4]
    return _crc(taints, crc) if taints else crc


# -- the auditor -------------------------------------------------------------


class StateAuditor:
    """Clock-injectable integrity auditor attached to one EncodePlane
    (``auditor.attach(plane)``); ProblemState handles find it through
    ``plane.auditor``. One auditor serves every subscriber of the plane —
    corruption is a property of the shared caches, not of a consumer."""

    def __init__(self, seed: int = 0, sample_rows: int = 4,
                 now: Optional[Callable[[], float]] = None,
                 recorder=None, flightrec=None):
        self.rng = random.Random(seed)
        self.sample_rows = int(sample_rows)
        self._now = now or time.monotonic
        self.recorder = recorder
        self.flightrec = flightrec
        self.passes = 0
        self.stats: Counter = Counter()
        self.incidents: List[dict] = []
        self._seq = 0
        # side tables for artifacts whose shape is frozen by consumers
        # (group rows stay 2-tuples, stack slots stay 4-tuples): digests
        # live here, keyed the way the plane keys the artifact
        self._group_digests: "OrderedDict[Any, Dict[Any, int]]" = \
            OrderedDict()
        self._stack_digests: "OrderedDict[Any, int]" = OrderedDict()
        # per-pass shadow-audit budgets (begin_pass resets)
        self._group_budget = 0
        self._topo_budget = 0

    def attach(self, plane) -> "StateAuditor":
        plane.auditor = self
        return self

    # -- pass lifecycle ------------------------------------------------------

    def begin_pass(self) -> None:
        """Called from ProblemState.begin_solve: resets the per-pass
        shadow-audit budgets so every consumer pass pays the same bounded
        audit cost regardless of how many layers it touches."""
        self.passes += 1
        self._group_budget = 1
        self._topo_budget = 1

    # -- incident machinery --------------------------------------------------

    def incident(self, layer: str, detail: str = "") -> dict:
        """Record ONE corruption incident: metric + warning event +
        flight-recorder dump + in-memory ledger. The caller quarantines
        the layer immediately after, so a single fault cannot fire twice
        (the rebuilt layer has nothing left to re-detect)."""
        from ..metrics.registry import STATE_AUDIT
        self._seq += 1
        rec = {"seq": self._seq, "layer": layer, "detail": detail,
               "at": self._now()}
        self.incidents.append(rec)
        self.stats["corrupt:" + layer] += 1
        STATE_AUDIT.inc({"layer": layer, "outcome": "corrupt"})
        if self.recorder is not None:
            try:
                from ..events import catalog
                self.recorder.publish(
                    catalog.state_corruption(layer, detail, self._seq))
            except Exception:  # noqa: BLE001 — auditing must not cost a pass
                pass
        if self.flightrec is not None:
            try:
                self.flightrec.capture_corruption(layer, detail,
                                                  seq=self._seq)
            except Exception:  # noqa: BLE001
                pass
        return rec

    def audited(self, layer: str, n: int = 1) -> None:
        from ..metrics.registry import STATE_AUDIT
        self.stats["audited:" + layer] += n
        STATE_AUDIT.inc({"layer": layer, "outcome": "audited"}, n)

    # -- sampling helpers ----------------------------------------------------

    def sample_indices(self, n: int, k: Optional[int] = None) -> List[int]:
        k = self.sample_rows if k is None else k
        if n <= 0 or k <= 0:
            return []
        if n <= k:
            return list(range(n))
        return self.rng.sample(range(n), k)

    def take_group_audit(self) -> bool:
        if self._group_budget <= 0:
            return False
        self._group_budget -= 1
        return True

    def take_topo_audit(self) -> bool:
        if self._topo_budget <= 0:
            return False
        self._topo_budget -= 1
        return True

    # -- group-row digests (side table, keyed like the plane) ----------------

    def _group_table(self, vocab) -> Dict[Any, int]:
        table = self._group_digests.get(vocab)
        if table is None:
            table = self._group_digests[vocab] = {}
            while len(self._group_digests) > 4:
                self._group_digests.popitem(last=False)
        return table

    def record_group(self, vocab, sig, row) -> None:
        self._group_table(vocab)[sig] = content_digest(row)

    def verify_group(self, vocab, sig, row) -> bool:
        """True if the cached group row matches its recorded digest; a
        row with no recorded digest (the auditor attached after it was
        cached, or the side table was trimmed) is adopted as-is."""
        table = self._group_table(vocab)
        want = table.get(sig)
        if want is None:
            table[sig] = content_digest(row)
            return True
        return content_digest(row) == want

    def quarantine_groups(self, vocab) -> None:
        self._group_digests.pop(vocab, None)

    # -- exist-stack digests -------------------------------------------------

    def record_stack(self, token, stack) -> None:
        self._stack_digests[token] = content_digest(stack)
        while len(self._stack_digests) > 16:
            self._stack_digests.popitem(last=False)

    def verify_stack(self, token, stack) -> bool:
        want = self._stack_digests.get(token)
        if want is None:
            self.record_stack(token, stack)
            return True
        return content_digest(stack) == want

    def quarantine_stacks(self) -> None:
        self._stack_digests.clear()
