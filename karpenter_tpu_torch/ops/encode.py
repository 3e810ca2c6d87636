"""Tensor encoding of the constraint algebra.

The host-side ``scheduling.Requirement`` set-or-complement algebra (reference:
pkg/scheduling/requirement.go) is lowered onto fixed-shape arrays:

- A label-key vocabulary of K keys; per key, a value vocabulary of up to D
  values plus one OTHER slot standing for "any value outside the vocab".
  Complement sets (NotIn/Exists/Gt/Lt) include the OTHER bit, which makes
  mask-AND an *exact* implementation of Requirement.Intersection emptiness
  because every concrete value ever compared appears in the vocab.
- Masks are bitpacked into uint32 words: mask[K, W] with W = ceil((D+1)/32).
  Intersection = bitwise AND; emptiness = all words zero.
- Gt/Lt integer bounds ride along as per-key int32 columns; the joint-bound
  crossing rule (requirement.go:163-165: max(gt) >= min(lt) collapses the
  intersection to DoesNotExist) is applied on top of the mask AND, which makes
  bound handling exact as well (known in-vocab values are pre-filtered per side).
- Per key we track defined / complement / exempt (operator in {NotIn,
  DoesNotExist}) flags to reproduce Requirements.Intersects/Compatible corner
  cases (requirements.go:283-304,175-187).

Resources are scaled to int32: cpu -> millicores, memory/storage -> MiB
(requests rounded up, capacity rounded down — conservative in the fit
direction), everything else -> whole units rounded the same way.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from ..api import labels as api_labels
from ..scheduling.requirement import Requirement
from ..scheduling.requirements import Requirements

INT_MIN = -(2**31)
INT_MAX = 2**31 - 1

MIB = 1024 * 1024

# Per-resource int32 scaling: milli stays for cpu-like, MiB for byte-like.
_BYTE_RESOURCES = ("memory", "ephemeral-storage", "storage")


def scale_request(name: str, milli: int) -> int:
    """Round UP: a request must not shrink when quantized."""
    if name in _BYTE_RESOURCES:
        return -((-milli) // (MIB * 1000))  # milli-bytes -> MiB, ceil
    return milli  # already integer milli


def scale_capacity(name: str, milli: int) -> int:
    """Round DOWN: capacity must not grow when quantized."""
    if name in _BYTE_RESOURCES:
        return milli // (MIB * 1000)
    return milli


class Vocab:
    """Label-key/value vocabulary shared by all encoded entities in one solve."""

    def __init__(self):
        self.keys: List[str] = []
        self.key_idx: Dict[str, int] = {}
        self.values: List[List[str]] = []
        self.value_idx: List[Dict[str, int]] = []
        self.resources: List[str] = []
        self.resource_idx: Dict[str, int] = {}
        self._frozen = False

    def add_key(self, key: str) -> int:
        key = api_labels.NORMALIZED_LABELS.get(key, key)
        if key in self.key_idx:
            return self.key_idx[key]
        assert not self._frozen, f"vocab frozen; unknown key {key}"
        idx = len(self.keys)
        self.keys.append(key)
        self.key_idx[key] = idx
        self.values.append([])
        self.value_idx.append({})
        return idx

    def add_value(self, key: str, value: str) -> int:
        k = self.add_key(key)
        vi = self.value_idx[k]
        if value in vi:
            return vi[value]
        assert not self._frozen, f"vocab frozen; unknown value {key}={value}"
        idx = len(self.values[k])
        self.values[k].append(value)
        vi[value] = idx
        return idx

    def add_resource(self, name: str) -> int:
        if name in self.resource_idx:
            return self.resource_idx[name]
        assert not self._frozen
        idx = len(self.resources)
        self.resources.append(name)
        self.resource_idx[name] = idx
        return idx

    def observe_requirements(self, reqs: Requirements) -> None:
        for key in reqs:
            r = reqs.get(key)
            self.add_key(key)
            for v in sorted(r.values):
                self.add_value(key, v)

    def observe_resources(self, rl: dict) -> None:
        for name in rl:
            self.add_resource(name)

    def freeze(self, domain_bucket: Optional[int] = None) -> None:
        """domain_bucket rounds the mask domain width up to a multiple, so
        solves whose value counts differ only within a bucket share jit
        shapes (SURVEY.md §7 'bucketed padding and recompile management')."""
        self._frozen = True
        self._domain_bucket = domain_bucket

    @property
    def K(self) -> int:
        return len(self.keys)

    @property
    def D(self) -> int:
        """Padded per-key domain width including the OTHER slot."""
        d = (max((len(v) for v in self.values), default=0)) + 1
        bucket = getattr(self, "_domain_bucket", None)
        if bucket:
            d = -(-d // bucket) * bucket
        return d

    @property
    def W(self) -> int:
        return (self.D + 31) // 32

    @property
    def R(self) -> int:
        return len(self.resources)

    def other_bit(self, k: int) -> int:
        """The OTHER slot index for key k (just past its concrete values)."""
        return len(self.values[k])


@dataclass
class EncodedRequirements:
    """One entity's requirement set in tensor form. Rows stack into batches."""
    mask: np.ndarray        # uint32 [K, W]
    defined: np.ndarray     # bool [K]
    complement: np.ndarray  # bool [K]
    exempt: np.ndarray      # bool [K]  (operator in {NotIn, DoesNotExist})
    gt: np.ndarray          # int32 [K] (INT_MIN when unset)
    lt: np.ndarray          # int32 [K] (INT_MAX when unset)


def _int_or_none(s: str):
    try:
        return int(s)
    except (TypeError, ValueError):
        return None


def encode_requirements(vocab: Vocab, reqs: Requirements) -> EncodedRequirements:
    K, W = vocab.K, vocab.W
    mask = np.zeros((K, W), dtype=np.uint32)
    defined = np.zeros(K, dtype=bool)
    complement = np.ones(K, dtype=bool)  # undefined == Exists
    exempt = np.zeros(K, dtype=bool)
    gt = np.full(K, INT_MIN, dtype=np.int64)
    lt = np.full(K, INT_MAX, dtype=np.int64)

    # undefined keys behave as Exists: every bit set (incl. OTHER)
    mask[:, :] = 0xFFFFFFFF
    _trim_tail_bits(vocab, mask)

    for key in reqs:
        r = reqs.get(key)
        k = vocab.key_idx[api_labels.NORMALIZED_LABELS.get(key, key)]
        defined[k] = True
        complement[k] = r.complement
        op = r.operator()
        exempt[k] = op in ("NotIn", "DoesNotExist")
        if r.greater_than is not None:
            gt[k] = r.greater_than
        if r.less_than is not None:
            lt[k] = r.less_than
        row = np.zeros(W, dtype=np.uint32)
        if r.complement:
            # all known values except excluded, filtered by bounds; OTHER set
            # unless individually crossed (it never is at construction)
            for i, v in enumerate(vocab.values[k]):
                if v in r.values:
                    continue
                iv = _int_or_none(v)
                if r.greater_than is not None or r.less_than is not None:
                    if iv is None:
                        continue
                    if r.greater_than is not None and iv <= r.greater_than:
                        continue
                    if r.less_than is not None and iv >= r.less_than:
                        continue
                row[i // 32] |= np.uint32(1 << (i % 32))
            ob = vocab.other_bit(k)
            row[ob // 32] |= np.uint32(1 << (ob % 32))
        else:
            for v in r.values:
                i = vocab.value_idx[k].get(v)
                if i is not None:
                    row[i // 32] |= np.uint32(1 << (i % 32))
                # In-values outside the vocab can never match any other entity;
                # dropping them is exact because the vocab covers all entities
                # in the solve.
        mask[k] = row
    return EncodedRequirements(mask=mask, defined=defined, complement=complement,
                               exempt=exempt, gt=gt.astype(np.int64), lt=lt.astype(np.int64))


#: NodeLabelTable codes of a node with no value under a key, and of a node
#: whose beta and GA labels disagree (label_requirements intersects them
#: to an empty In set: DoesNotExist)
ABSENT = -1
CONFLICT = -2


class NodeLabelTable:
    """A fleet's node labels column by column: for each normalised label
    key, each node's value as an index into the key's distinct values, or
    ABSENT, or CONFLICT. A node label is always ``In [v]``, so a node's
    encoded row depends only on these codes, and the encode becomes one
    gather and one scatter per vocab key (encode_node_labels) in place of
    a Requirements object per node.

    - ``values[key]``: the key's distinct values in the order of their
      first appearance over the nodes, which is the order in which a
      node-by-node ``Vocab.add_value`` walk meets them;
    - ``zones``: each node's raw ``topology.kubernetes.io/zone`` label
      ("" when unset), which the existing-node zone index reads as it
      stands;
    - ``resources``: the nodes' allocatable resource names in the order
      of their first appearance."""

    __slots__ = ("n", "codes", "values", "zones", "resources")

    def __init__(self, nodes: Sequence):
        raw = [sn.labels() for sn in nodes]
        zone_key = api_labels.LABEL_TOPOLOGY_ZONE
        self.n = len(raw)
        self.zones: List[str] = [labels.get(zone_key, "") for labels in raw]
        aliased = api_labels.NORMALIZED_LABELS.keys()
        rows = [labels if aliased.isdisjoint(labels) else _normalised(labels)
                for labels in raw]
        self.codes: Dict[str, np.ndarray] = {}
        self.values: Dict[str, List[str]] = {}
        for key in sorted(set().union(*rows)):
            column = [labels.get(key, _ABSENT) for labels in rows]
            values = [v for v in dict.fromkeys(column)
                      if v is not _ABSENT and v is not _CONFLICT]
            index = {v: i for i, v in enumerate(values)}
            index[_ABSENT], index[_CONFLICT] = ABSENT, CONFLICT
            self.codes[key] = np.fromiter(map(index.__getitem__, column),
                                          dtype=np.int32, count=self.n)
            self.values[key] = values
        self.resources: List[str] = list(dict.fromkeys(
            itertools.chain.from_iterable(sn.allocatable() for sn in nodes)))


_ABSENT = object()
_CONFLICT = object()


def _normalised(labels: dict) -> dict:
    """One node's labels under their normalised keys, a beta key and its
    GA key that disagree marked _CONFLICT (the intersection of their In
    sets is empty, and stays empty)."""
    out: dict = {}
    for key, v in labels.items():
        key = api_labels.NORMALIZED_LABELS.get(key, key)
        if key in out and out[key] != v:
            v = _CONFLICT
        out[key] = v
    return out


def encode_node_labels(vocab: Vocab, table: NodeLabelTable,
                       total: int) -> EncodedRequirements:
    """[total, ...] requirement rows of a table's nodes, byte-identical to
    stacking ``encode_requirements`` of each node's in-vocab
    ``label_requirements``; rows from ``table.n`` on are the
    empty-Requirements row (pow2 padding). Each row starts undefined (the
    tail mask, complement); per vocab key, a node with a value is defined
    with one bit set, or none where the value is outside the vocab, and a
    CONFLICT node is defined DoesNotExist (empty, exempt)."""
    K, W, n = vocab.K, vocab.W, table.n
    mask = np.empty((total, K, W), dtype=np.uint32)
    mask[:] = _tail_mask(vocab)
    defined = np.zeros((total, K), dtype=bool)
    complement = np.ones((total, K), dtype=bool)
    exempt = np.zeros((total, K), dtype=bool)
    gt = np.full((total, K), INT_MIN, dtype=np.int64)
    lt = np.full((total, K), INT_MAX, dtype=np.int64)
    for k, key in enumerate(vocab.keys):
        codes = table.codes.get(key)
        if codes is None:
            continue
        has = codes != ABSENT
        defined[:n, k] = has
        complement[:n, k] = ~has
        exempt[:n, k] = codes == CONFLICT
        mask[:n, k][has] = 0
        vi = vocab.value_idx[k]
        # the two trailing -1 entries answer the codes CONFLICT and ABSENT
        lut = np.array([vi.get(v, -1) for v in table.values[key]] + [-1, -1],
                       dtype=np.int64)
        bit = lut[codes]
        rows = np.flatnonzero(bit >= 0)
        bit = bit[rows]
        mask[rows, k, bit >> 5] = np.left_shift(
            np.uint32(1), (bit & 31).astype(np.uint32))
    return EncodedRequirements(mask=mask, defined=defined,
                               complement=complement, exempt=exempt,
                               gt=gt, lt=lt)


def _tail_mask(vocab: Vocab) -> np.ndarray:
    """[K, W] uint32 mask keeping bits up to each key's OTHER slot. Cached
    only on a frozen vocab: an unfrozen vocab can grow a key's value count
    without changing (K, W), which would silently zero the new OTHER bit."""
    if not vocab._frozen:
        return _build_tail_mask(vocab)
    cached = getattr(vocab, "_tail_mask", None)
    if cached is not None and cached.shape == (vocab.K, vocab.W):
        return cached
    mask = _build_tail_mask(vocab)
    vocab._tail_mask = mask
    return mask


def _build_tail_mask(vocab: Vocab) -> np.ndarray:
    K, W = vocab.K, vocab.W
    ob = np.array([vocab.other_bit(k) for k in range(K)])[:, None]  # [K,1]
    lo = (np.arange(W) * 32)[None, :]                               # [1,W]
    keep = np.clip(ob + 1 - lo, 0, 32)
    full = np.uint32(0xFFFFFFFF)
    safe = np.minimum(keep, 31).astype(np.uint32)  # avoid UB shift by 32
    return np.where(keep >= 32, full,
                    (np.uint32(1) << safe) - np.uint32(1)).astype(np.uint32)


def _trim_tail_bits(vocab: Vocab, mask: np.ndarray) -> None:
    """Zero bits beyond each key's OTHER slot so popcounts stay meaningful."""
    mask &= _tail_mask(vocab)


def stack_encoded(items: Sequence[EncodedRequirements]) -> EncodedRequirements:
    return EncodedRequirements(
        mask=np.stack([e.mask for e in items]),
        defined=np.stack([e.defined for e in items]),
        complement=np.stack([e.complement for e in items]),
        exempt=np.stack([e.exempt for e in items]),
        gt=np.stack([e.gt for e in items]),
        lt=np.stack([e.lt for e in items]))


def copy_encoded(e: EncodedRequirements) -> EncodedRequirements:
    return EncodedRequirements(
        mask=e.mask.copy(), defined=e.defined.copy(),
        complement=e.complement.copy(), exempt=e.exempt.copy(),
        gt=e.gt.copy(), lt=e.lt.copy())


def pad_stacked(e: EncodedRequirements, total: int,
                zero: EncodedRequirements) -> EncodedRequirements:
    """Pad a stacked [B, ...] batch along axis 0 to ``total`` rows with
    copies of ``zero`` (an empty-Requirements row: defined nowhere, so a
    padded row never fails a compatibility check and never packs). The
    row-sliced delta encode uses this to keep the group/node batch axes on
    pow2 shape buckets so the compiled-executable cache keeps hitting."""
    n = e.mask.shape[0]
    if total <= n:
        return e

    def rep(name: str) -> np.ndarray:
        a = getattr(e, name)
        z = getattr(zero, name)
        return np.concatenate(
            [a, np.broadcast_to(z, (total - n,) + z.shape).copy()])

    return EncodedRequirements(
        mask=rep("mask"), defined=rep("defined"),
        complement=rep("complement"), exempt=rep("exempt"),
        gt=rep("gt"), lt=rep("lt"))


def shard_spans(total: int, shards: int) -> "list":
    """Contiguous equal [start, stop) row spans carving a stacked batch
    axis into ``shards`` blocks, or a single full span when the axis does
    not divide evenly (a pow2-bucketed axis always divides a pow2 shard
    count). Shared by the sharded ProblemState's per-shard exist tokens
    and the mesh placer's per-shard upload blocks, so the two sides can
    never disagree about which rows a shard owns."""
    if shards <= 1 or total % shards != 0:
        return [(0, total)]
    rows = total // shards
    return [(s * rows, (s + 1) * rows) for s in range(shards)]


def pow2_bucket(n: int, minimum: int) -> int:
    """Next power of two >= max(n, minimum): bounded distinct jit shapes.
    Shared by the group/node batch-axis buckets (tensor_scheduler) and the
    mesh's per-shard stack padding (parallel/mesh.pad_problem), so every
    padded axis in the system rounds the same way."""
    b = minimum
    while b < n:
        b *= 2
    return b


def pack_bits(a: np.ndarray) -> np.ndarray:
    """Little-endian bitpack of a bool array along its LAST axis:
    [..., Z] bool -> [..., ceil(Z/8)] uint8 with bit i of word w standing
    for position w*8+i. The packer's per-cohort zone-feasibility bitfield
    (ops/binpack.py CohortSet.okz) uses this layout; read single positions
    back with bit_column()."""
    return np.packbits(np.asarray(a, dtype=bool), axis=-1, bitorder="little")


def bit_column(packed: np.ndarray, i: int) -> np.ndarray:
    """Extract logical position ``i`` from a pack_bits() array -> bool
    with the last (word) axis dropped."""
    return (packed[..., i >> 3] >> (i & 7)) & 1 == 1


def encode_resource_vector(vocab: Vocab, rl: dict, *, capacity: bool) -> np.ndarray:
    out = np.zeros(vocab.R, dtype=np.int64)
    for name, milli in rl.items():
        idx = vocab.resource_idx.get(name)
        if idx is None:
            continue
        out[idx] = scale_capacity(name, milli) if capacity else scale_request(name, milli)
    return out


def encode_capacity_rows(vocab: Vocab, rls: Sequence[dict],
                         total: int) -> np.ndarray:
    """[total, R] rows of ``encode_resource_vector(..., capacity=True)``
    over ``rls``, built a resource column at a time; rows past len(rls)
    are zero (pow2 padding). The quantities are whole milli-units, so
    numpy's floor division scales them as ``scale_capacity`` does."""
    out = np.zeros((total, vocab.R), dtype=np.int64)
    n = len(rls)
    for r, name in enumerate(vocab.resources):
        col = np.array([rl.get(name, 0) for rl in rls], dtype=np.int64)
        if name in _BYTE_RESOURCES:
            col //= MIB * 1000
        out[:n, r] = col
    return out
