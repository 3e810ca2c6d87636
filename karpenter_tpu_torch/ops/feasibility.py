"""Plain PyTorch feasibility functions over encoded requirement tensors.

These reproduce, as dense tensor ops, exactly the checks the host scheduler
runs per pod x instance-type (reference: scheduling/nodeclaim.go:248-301 —
compatible() = Requirements.Intersects, fits() = resources.Fits, offering
compatibility = Offerings.Available().HasCompatible):

- ``intersects_matrix``  [A,B]: pairwise Requirements.Intersects emptiness rule
  incl. the both-sides-{NotIn,DoesNotExist} exemption and Gt/Lt joint-bound
  collapse (requirements.go:283-304, requirement.go:155-188).
- ``compatible_matrix``  [A,B]: Intersects plus the undefined-key rule with an
  allow-undefined key set (requirements.go:175-187).
- ``fits_matrix``        [A,B]: int32 resource fit.
- ``offering_compat``    [B,T]: any available offering whose (zone, capacity
  type) values are admitted by the B-side masks.
- ``combine``: requirement-set intersection of two encoded batches — the tensor
  analogue of Requirements.Add over all keys at once.

They keep the argument layouts of the JAX package's functions. Mask words
are uint32 bit patterns held in int32 tensors: CPU torch implements no shift
for uint32, and AND, ``!= 0`` and ``(w >> b) & 1`` give the same bits on the
int32 view. These are the plain versions the hand-written kernels
(ops/kernels.py) are held against; they run wherever the tensors live.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

INT_MIN = -2**31
INT_MAX = 2**31 - 1


class Enc(NamedTuple):
    """Device-side batch of encoded requirement sets ([..., K, W] / [..., K])."""
    mask: torch.Tensor        # int32 [..., K, W] (uint32 bit patterns)
    defined: torch.Tensor     # bool [..., K]
    complement: torch.Tensor  # bool [..., K]
    exempt: torch.Tensor      # bool [..., K]
    gt: torch.Tensor          # int32 [..., K]
    lt: torch.Tensor          # int32 [..., K]


def host_enc(e) -> Enc:
    """to_device's dtype normalization WITHOUT committing to a device: host
    numpy leaves (uint32 masks, int32 bounds clipped so the INT_MIN/INT_MAX
    "unbounded" sentinels survive exactly)."""
    return Enc(mask=np.ascontiguousarray(e.mask.astype(np.uint32)),
               defined=np.asarray(e.defined, dtype=bool),
               complement=np.asarray(e.complement, dtype=bool),
               exempt=np.asarray(e.exempt, dtype=bool),
               gt=np.clip(e.gt, INT_MIN, INT_MAX).astype(np.int32),
               lt=np.clip(e.lt, INT_MIN, INT_MAX).astype(np.int32))


def to_device(e, device) -> Enc:
    h = host_enc(e)
    return Enc(mask=torch.from_numpy(h.mask.view(np.int32)).to(device),
               defined=torch.from_numpy(h.defined).to(device),
               complement=torch.from_numpy(h.complement).to(device),
               exempt=torch.from_numpy(h.exempt).to(device),
               gt=torch.from_numpy(h.gt).to(device),
               lt=torch.from_numpy(h.lt).to(device))


def _crossed(gt, lt):
    return (gt > INT_MIN) & (lt < INT_MAX) & (gt >= lt)


def _pairwise_nonempty(a: Enc, b: Enc):
    """[A,B,K] mask-AND emptiness + joint bound collapse."""
    # accumulate over words to keep peak memory at [A,B,K]
    W = a.mask.shape[-1]
    nonempty = None
    for w in range(W):
        nz = (a.mask[:, None, :, w] & b.mask[None, :, :, w]) != 0
        nonempty = nz if nonempty is None else (nonempty | nz)
    gt = torch.maximum(a.gt[:, None, :], b.gt[None, :, :])
    lt = torch.minimum(a.lt[:, None, :], b.lt[None, :, :])
    return nonempty & ~_crossed(gt, lt)


def _pairwise_bad(a: Enc, b: Enc):
    """[A,B,K] keys both sides define whose intersection is empty, unless
    both sides are exempt."""
    checked = a.defined[:, None, :] & b.defined[None, :, :]
    exempt = a.exempt[:, None, :] & b.exempt[None, :, :]
    return checked & ~_pairwise_nonempty(a, b) & ~exempt


def intersects_matrix(a: Enc, b: Enc) -> torch.Tensor:
    """[A,B] True where a.Intersects(b) passes (requirements.go:283-304)."""
    return ~torch.any(_pairwise_bad(a, b), dim=-1)


def compatible_matrix(a: Enc, b: Enc, allow_undefined: torch.Tensor
                      ) -> torch.Tensor:
    """[A,B] True where a.Compatible(b, allow_undefined) passes
    (requirements.go:175-187). allow_undefined: bool [K]."""
    undef_bad = (b.defined[None, :, :] & ~a.defined[:, None, :]
                 & ~allow_undefined[None, None, :] & ~b.exempt[None, :, :])
    return ~torch.any(_pairwise_bad(a, b) | undef_bad, dim=-1)


def combine(a: Enc, b: Enc) -> Enc:
    """Per-key intersection of two aligned batches (shapes must broadcast) —
    the tensor analogue of Requirements.Add(...) over every key at once
    (requirement.go:155-188 semantics)."""
    gt = torch.maximum(a.gt, b.gt)
    lt = torch.minimum(a.lt, b.lt)
    crossed = _crossed(gt, lt)
    mask = torch.where(crossed[..., None], 0, a.mask & b.mask)
    complement = a.complement & b.complement & ~crossed
    empty = ~torch.any(mask != 0, dim=-1)
    exempt = torch.where(complement, a.exempt | b.exempt, empty)
    # concrete results drop bounds (requirement.go:183-186)
    gt = torch.where(complement, gt, INT_MIN)
    lt = torch.where(complement, lt, INT_MAX)
    return Enc(mask=mask, defined=a.defined | b.defined, complement=complement,
               exempt=exempt, gt=gt, lt=lt)


def fits_matrix(requests: torch.Tensor, available: torch.Tensor) -> torch.Tensor:
    """requests [B,R] x available [A,R] -> [A,B] bool (resources.Fits:
    zero-valued requests always fit; missing resources encode as 0)."""
    req = requests[None, :, :]
    avail = available[:, None, :]
    return torch.all((req <= 0) | (req <= avail), dim=-1)


def value_bit_ok(masks: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """masks [B,W] (one key's words), idx [T,O] value indices -> [B,T,O]:
    does each row admit each single value (-1 == unconstrained, never read).
    An index at or past 32 * W is admitted: the reference gathers with
    ``jnp.take`` / ``jnp.take_along_axis``, whose out-of-range fill for
    uint32 is all ones. No word past W is read."""
    W = masks.shape[-1]
    word = torch.where(idx >= 0, idx // 32, 0)
    bit = torch.where(idx >= 0, idx % 32, 0)
    inside = word < W
    has = (masks[:, torch.where(inside, word, 0).long()]
           >> bit[None, :, :]) & 1
    return torch.where((idx >= 0) & inside, has == 1, True)


def value_bit_ok_clamped(masks: torch.Tensor, idx: torch.Tensor
                         ) -> torch.Tensor:
    """value_bit_ok, but an index at or past 32 * W reads its bit from the
    last word, as the reference's plain ``masks[:, word]`` gather clamps
    (binpack._offering_value_ok, the capacity-type test of the
    precompute)."""
    W = masks.shape[-1]
    word = torch.where(idx >= 0, idx // 32, 0).clamp(max=W - 1)
    bit = torch.where(idx >= 0, idx % 32, 0)
    has = (masks[:, word.long()] >> bit[None, :, :]) & 1
    return torch.where(idx[None, :, :] >= 0, has == 1, True)


def offering_compat(mask_b: torch.Tensor, zone_key: int, captype_key: int,
                    off_zone: torch.Tensor, off_captype: torch.Tensor,
                    off_available: torch.Tensor) -> torch.Tensor:
    """[B,T]: does any available offering of instance type t satisfy entity b's
    zone/capacity-type masks? (Offerings.Available().HasCompatible — an
    offering passes when the entity's mask at the key admits its single value.)

    mask_b: int32 [B,K,W]; off_zone/off_captype: int32 [T,O] value indices
    (-1 == offering doesn't constrain that key); off_available: bool [T,O].
    """
    zone_ok = value_bit_ok(mask_b[:, zone_key, :], off_zone)
    cap_ok = value_bit_ok(mask_b[:, captype_key, :], off_captype)
    return torch.any(off_available[None, :, :] & zone_ok & cap_ok, dim=-1)


def pods_per_node(alloc: torch.Tensor, overhead: torch.Tensor,
                  req: torch.Tensor) -> torch.Tensor:
    """alloc [T,R], overhead [M,R] (daemon), req [G,R] -> [G,M,T] int32: how many
    identical pods fit a fresh node of type t under template m. Zero-request
    resources don't constrain the pod count — but the daemon overhead itself
    must fit the node in EVERY resource (the host oracle folds daemon
    requests into the claim's request vector, scheduler.go:356-382 +
    nodeclaim.go:108-117, so a type whose overhead outgrows it in any
    column is infeasible there too): such types get 0."""
    free = alloc[None, :, :] - overhead[:, None, :]      # [M,T,R]
    daemon_fits = torch.all(free >= 0, dim=-1)           # [M,T]
    free = free.clamp_min(0)
    r = req[:, None, None, :]                            # [G,1,1,R]
    per = torch.where(r > 0, torch.div(free[None], r.clamp_min(1),
                                       rounding_mode="floor"), 2**30)
    per = per.amin(dim=-1).to(torch.int32)               # [G,M,T]
    return torch.where(daemon_fits[None], per, 0)
