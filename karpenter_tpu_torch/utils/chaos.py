"""Seeded fault injection: the chaos-engineering substrate.

The reference operator's resilience is exercised by real clusters being
flaky at it; the standalone framework needs the flakiness injected. One
`FaultInjector` is shared by every chaos surface — the store wrapper
(kube/chaos.py), the cloudprovider wrapper (cloudprovider/chaos.py), and
the FakeCloudProvider hooks — so a single seeded RNG drives the whole
fault schedule deterministically (Basiri et al., "Chaos Engineering":
reproducible experiments, not random vandalism).

Faults fire only while a controller is reconciling (utils/injection.py
contextvar set by the Manager dispatch): test setup and assertions talk to
the store/provider unperturbed, exactly like a chaos experiment that spares
the control plane's own tooling.
"""

from __future__ import annotations

import contextlib
import random
from collections import Counter, deque
from typing import Optional

from .backoff import TerminalError
from .injection import controller_name


class InjectedFault(Exception):
    """Transient injected failure (apiserver 500 / provider throttle
    analog): reconcilers are expected to surface it and the manager to
    retry it through the item backoff."""


class InjectedTerminalFault(TerminalError):
    """Terminal injected failure: the manager must NOT retry it."""


class FaultInjector:
    """Seeded fault schedule shared across chaos surfaces.

    - ``rate``: probability that any gated operation raises.
    - ``terminal_rate``: fraction of fired faults that are terminal
      (InjectedTerminalFault) instead of transient.
    - ``poison(name)``: operations touching that object name ALWAYS raise
      transiently — the deliberately-unreconcilable object whose landing
      in the dead-letter set the soak test asserts.
    - ``reconcile_only`` (default True): faults fire only inside a
      reconcile (controller-name contextvar set), so harness setup code
      is never perturbed.

    ``counts`` records fired faults per operation label for assertions
    ("faults actually fired") and experiment reports.
    """

    def __init__(self, seed: int = 0, rate: float = 0.05,
                 terminal_rate: float = 0.0, reconcile_only: bool = True):
        self.rng = random.Random(seed)
        self.rate = rate
        self.terminal_rate = terminal_rate
        self.reconcile_only = reconcile_only
        self.enabled = True
        self.poisoned: set = set()
        self.counts: Counter = Counter()

    def poison(self, name: str) -> None:
        self.poisoned.add(name)

    def maybe_raise(self, op: str, name: str = "") -> None:
        """Fault gate: called at the top of every wrapped operation."""
        if not self.enabled:
            return
        if self.reconcile_only and not controller_name():
            return
        if name and name in self.poisoned:
            self.counts[op] += 1
            raise InjectedFault(f"poisoned object {name!r} in {op}")
        if self.rate and self.rng.random() < self.rate:
            self.counts[op] += 1
            if self.terminal_rate \
                    and self.rng.random() < self.terminal_rate:
                raise InjectedTerminalFault(f"injected terminal fault "
                                            f"in {op} ({name or 'op'})")
            raise InjectedFault(f"injected fault in {op} "
                                f"({name or 'op'})")

    def fired(self) -> int:
        return sum(self.counts.values())


class CapacityDrought:
    """Scheduled capacity-exhaustion windows for the simulated providers —
    the chaos substrate behind the unavailable-offerings feedback loop.

    A window is an ``(instance_type, zone, capacity_type)`` pattern ("*"
    wildcard per position) with an optional expiry: while live, any create
    whose CHOSEN offering matches raises InsufficientCapacityError carrying
    the matched pattern — exactly the zone-running-dry / capacity-type-
    exhausted failure every production autoscaler hits, recovering on its
    own once the window lapses. Clock-injected (FakeClock in tests) so the
    drought-and-recovery timeline is deterministic; ``hits`` counts fired
    exhaustions per pattern for assertions ("zero repeat create calls
    against a cached-unavailable offering" is ``hits`` staying flat while
    the registry TTL lives).
    """

    def __init__(self, clock=None):
        self.clock = clock
        self._windows: list = []  # ((it, zone, ct), until_or_None)
        self.hits: Counter = Counter()

    def exhaust(self, instance_type: str = "*", zone: str = "*",
                capacity_type: str = "*",
                duration: Optional[float] = None) -> None:
        until = None
        if duration is not None:
            if self.clock is None:
                raise ValueError("duration needs an injected clock")
            until = self.clock.now() + duration
        self._windows.append(((instance_type, zone, capacity_type), until))

    def clear(self) -> None:
        self._windows.clear()

    def match(self, instance_type: str, zone: str,
              capacity_type: str) -> Optional[tuple]:
        """First live pattern covering the offering (pruning lapsed
        windows), or None. Counts the hit."""
        now = self.clock.now() if self.clock is not None else None
        live, hit = [], None
        for pat, until in self._windows:
            if until is not None and now is not None and now >= until:
                continue
            live.append((pat, until))
            pit, pz, pct = pat
            if hit is None and pit in ("*", instance_type) \
                    and pz in ("*", zone) and pct in ("*", capacity_type):
                hit = pat
        self._windows = live
        if hit is not None:
            self.hits["/".join(hit)] += 1
        return hit


class WireFaultInjector:
    """Seeded fault schedule for the gRPC wire (the service-path chaos
    substrate below the process boundary, where the FaultInjector
    stops). One injector drives a chaos-wrapped channel
    (sidecar/wire_chaos.ChaosChannel); per RPC *attempt* it draws one
    verdict from the seeded RNG:

    - ``drop``: the request never reaches the server (connection reset /
      blackholed packet) — the client sees UNAVAILABLE, the server sees
      nothing.
    - ``disconnect``: the request IS delivered and applied, the response
      is lost mid-stream — the client sees UNAVAILABLE while the server
      state advanced (the desync case the request-digest dedupe cache
      must make retry-safe).
    - ``duplicate``: the request is delivered twice back to back (a
      retransmit racing its original) — the second delivery must be
      served from the dedupe cache, not re-applied.
    - ``delay``: ``delay_seconds`` of added latency before delivery (a
      congested wire; with a short client deadline this manufactures
      DEADLINE_EXCEEDED).

    Draw order is fixed (delay, then drop, then duplicate, then
    disconnect — at most one delivery-altering fault per attempt) so the
    same seed yields the same fault schedule for the same RPC sequence;
    ``counts`` records fired faults per kind for "faults actually fired"
    assertions. ``enabled=False`` short-circuits to zero overhead — the
    chaos-off bench line wraps the channel and asserts the wrapper costs
    nothing."""

    KINDS = ("drop", "delay", "duplicate", "disconnect")

    def __init__(self, seed: int = 0, drop: float = 0.0, delay: float = 0.0,
                 duplicate: float = 0.0, disconnect: float = 0.0,
                 delay_seconds: float = 0.02):
        self.rng = random.Random(seed)
        self.drop = drop
        self.delay = delay
        self.duplicate = duplicate
        self.disconnect = disconnect
        self.delay_seconds = delay_seconds
        self.enabled = True
        self.counts: Counter = Counter()
        # one-shot forced faults consumed before any random draw: the
        # deterministic "this exact fault WILL happen on the next attempt"
        # primitive harnesses use to pin each recovery path regardless of
        # what the background rates roll
        self._forced: deque = deque()

    def inject_next(self, *kinds: str) -> None:
        """Queue a forced fault verdict for the next attempt (e.g.
        inject_next("drop"), inject_next("delay", "disconnect"))."""
        for k in kinds:
            if k not in self.KINDS:
                raise ValueError(f"unknown wire fault kind {k!r} "
                                 f"(known: {', '.join(self.KINDS)})")
        self._forced.append(list(kinds))

    def set_rates(self, drop: float = 0.0, delay: float = 0.0,
                  duplicate: float = 0.0, disconnect: float = 0.0,
                  delay_seconds: Optional[float] = None) -> None:
        self.drop = drop
        self.delay = delay
        self.duplicate = duplicate
        self.disconnect = disconnect
        if delay_seconds is not None:
            self.delay_seconds = delay_seconds

    def rates(self) -> dict:
        return {"drop": self.drop, "delay": self.delay,
                "duplicate": self.duplicate, "disconnect": self.disconnect,
                "delay_seconds": self.delay_seconds}

    def draw(self) -> list:
        """Fault verdict for one RPC attempt: a (possibly empty) list of
        kind names, ``delay`` optionally preceding ONE delivery-altering
        fault. Always consumes the same number of RNG draws per call so
        the schedule depends only on the attempt sequence, not on which
        faults happen to fire."""
        if not self.enabled:
            return []
        # the draws are burned even when a forced verdict overrides them:
        # a run using inject_next() must see the SAME background schedule
        # as a same-seed run without it, or forced-vs-baseline comparisons
        # diverge from the forced attempt onward
        draws = [self.rng.random() for _ in range(4)]
        if self._forced:
            out = self._forced.popleft()
            for kind in out:
                self.counts[kind] += 1
            return out
        out = []
        if self.delay and draws[0] < self.delay:
            out.append("delay")
        if self.drop and draws[1] < self.drop:
            out.append("drop")
        elif self.duplicate and draws[2] < self.duplicate:
            out.append("duplicate")
        elif self.disconnect and draws[3] < self.disconnect:
            out.append("disconnect")
        for kind in out:
            self.counts[kind] += 1
        return out

    def fired(self) -> int:
        return sum(self.counts.values())


@contextlib.contextmanager
def chaos_pause(injector: Optional[FaultInjector]):
    """Context manager: suspend fault injection (convergence checks)."""
    if injector is None:
        yield
        return
    prev, injector.enabled = injector.enabled, False
    try:
        yield
    finally:
        injector.enabled = prev


class DeviceKiller:
    """Seeded device-kill verdict source for the mesh dispatch path
    (installed via ops/binpack.install_device_chaos). ``kill``/``revive``
    toggle a device's liveness; ``verdict(ids)`` returns the first dead
    device among a dispatch's participants (counting the hit) or None —
    the dispatch then raises DeviceLossError for it, driving the
    degradation ladder exactly the way a real mid-solve chip loss would."""

    def __init__(self):
        self.dead: set = set()
        self.counts: Counter = Counter()
        self.enabled = True

    def kill(self, device_id: int) -> None:
        self.dead.add(int(device_id))

    def revive(self, device_id: int) -> None:
        self.dead.discard(int(device_id))

    def verdict(self, device_ids) -> Optional[int]:
        if not self.enabled or not self.dead:
            return None
        for did in device_ids:
            if int(did) in self.dead:
                self.counts[int(did)] += 1
                return int(did)
        return None


class StateCorruptor:
    """Seeded corruption of the warm solver state: the chaos half of the
    anti-entropy loop (state/audit.py detects, quarantines, heals what
    this injects). Targets the live caches of one EncodePlane (and the
    warm-pack seed of one ProblemState handle) with three fault kinds:

    - ``bit_flip``  — one byte of a cached ndarray flipped IN PLACE;
    - ``stale_value`` — an entry's content replaced while its validity
      token (and any recorded digest) is kept, the silently-stale-row
      failure mode token checks alone can never catch;
    - ``truncate`` — an array shortened, the torn-write analog.

    Every fault lands on the CURRENT serve path (cur-generation node rows,
    resident stacks, live memo entries, the live seed) so an attached
    auditor must detect 100% of them before the entry is served; the
    prev-generation and dead-token cases are pinned by directed tests.
    ``corrupt`` returns the injected records; with no candidates in a
    layer nothing is injected (and nothing counted)."""

    LAYERS = ("node_rows", "group_rows", "exist_stack", "topo_memo",
              "warm_checkpoint")
    KINDS = ("bit_flip", "stale_value", "truncate")

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)
        self.counts: Counter = Counter()
        self.injected: list = []

    # -- array mutation helpers ----------------------------------------------

    def _flip(self, arr) -> bool:
        import numpy as np
        try:
            flat = arr.view(np.uint8).reshape(-1)
        except (ValueError, AttributeError):
            return False
        if not flat.size:
            return False
        flat[self.rng.randrange(flat.size)] ^= 0xFF
        return True

    def _arrays_in(self, obj, out) -> None:
        import numpy as np
        if isinstance(obj, np.ndarray):
            if obj.size:
                out.append(obj)
        elif isinstance(obj, (tuple, list)):
            for item in obj:
                self._arrays_in(item, out)
        elif isinstance(obj, dict):
            for item in obj.values():
                self._arrays_in(item, out)
        elif hasattr(obj, "__dict__"):
            for item in vars(obj).values():
                self._arrays_in(item, out)

    # -- per-layer injections ------------------------------------------------

    def _corrupt_node_rows(self, plane, kind: str) -> Optional[dict]:
        caches = [c for c in plane._node_caches.values() if c.cur]
        if not caches:
            return None
        cache = self.rng.choice(caches)
        key = self.rng.choice(sorted(cache.cur, key=repr))
        row = cache.cur[key]
        if kind == "bit_flip":
            if not self._flip(row[2]):
                return None
        elif kind == "stale_value":
            # zone index perturbed; rev (row[0]) and any digest kept
            cache.cur[key] = row[:3] + (int(row[3]) + 1,) + row[4:]
        else:
            cache.cur[key] = row[:2] + (row[2][:-1],) + row[3:]
        return {"layer": "node_rows", "kind": kind, "key": key[0]}

    def _corrupt_group_rows(self, plane, kind: str) -> Optional[dict]:
        import numpy as np
        tables = [t for t in plane._group_caches.values() if t]
        if not tables:
            return None
        rows = self.rng.choice(tables)
        sig = self.rng.choice(sorted(rows, key=repr))
        enc_row, req_vec = rows[sig]
        if kind == "bit_flip":
            if not self._flip(req_vec):
                return None
        elif kind == "stale_value":
            rows[sig] = (enc_row, req_vec + np.float64(1.0))
        else:
            rows[sig] = (enc_row, req_vec[:-1])
        return {"layer": "group_rows", "kind": kind}

    def _corrupt_exist_stack(self, plane, kind: str) -> Optional[dict]:
        caches = [c for c in plane._node_caches.values() if c.stacks]
        if not caches:
            return None
        stacks = self.rng.choice(caches).stacks
        token = next(reversed(stacks))  # the most recently served slot
        exist_enc, exist_avail, exist_zone, taints = stacks[token]
        if kind == "bit_flip":
            if not self._flip(exist_avail):
                return None
        elif kind == "stale_value":
            stacks[token] = (exist_enc, exist_avail + 1.0, exist_zone,
                             taints)
        else:
            stacks[token] = (exist_enc, exist_avail[:-1], exist_zone,
                             taints)
        return {"layer": "exist_stack", "kind": kind}

    def _corrupt_topo_memo(self, plane, kind: str) -> Optional[dict]:
        memos = [m for m in plane._topo_memos.values() if m]
        if not memos:
            return None
        memo = memos[-1]  # the most recently proven token's entries
        sig = self.rng.choice(sorted(memo, key=repr))
        entry = memo[sig]
        if kind == "bit_flip":
            if not self._flip(entry[0]):
                return None
        elif kind == "stale_value":
            memo[sig] = entry[:2] + (int(entry[2]) + 1,) + entry[3:]
        else:
            memo[sig] = (entry[0][:-1],) + entry[1:]
        return {"layer": "topo_memo", "kind": kind}

    def _corrupt_warm_checkpoint(self, handle, kind: str) -> Optional[dict]:
        if handle is None:
            return None
        arrays: list = []
        for ck in getattr(handle.seed, "checkpoints", ()) or ():
            self._arrays_in(ck.rows, arrays)
            self._arrays_in(ck.exist_avail, arrays)
        if not arrays:
            return None
        # every warm fault is an in-place flip: the seed's digest was
        # recorded by finish_pack, so any content change is detectable —
        # the kind only varies which failure mode produced it
        if not self._flip(self.rng.choice(arrays)):
            return None
        return {"layer": "warm_checkpoint", "kind": "bit_flip"}

    # -- driver --------------------------------------------------------------

    def corrupt(self, plane, handle=None, layer: str = "all",
                count: int = 1) -> list:
        """Inject up to ``count`` seeded faults into ``plane`` (and
        ``handle``'s warm seed for the warm_checkpoint layer). Returns the
        records actually injected; layers with no live candidates are
        skipped (nothing counted), so detection assertions can compare
        against the return value exactly."""
        injectors = {
            "node_rows": lambda k: self._corrupt_node_rows(plane, k),
            "group_rows": lambda k: self._corrupt_group_rows(plane, k),
            "exist_stack": lambda k: self._corrupt_exist_stack(plane, k),
            "topo_memo": lambda k: self._corrupt_topo_memo(plane, k),
            "warm_checkpoint":
                lambda k: self._corrupt_warm_checkpoint(handle, k),
        }
        out = []
        for _ in range(count):
            layers = list(self.LAYERS) if layer == "all" else [layer]
            self.rng.shuffle(layers)
            kind = self.rng.choice(self.KINDS)
            for name in layers:
                rec = injectors[name](kind)
                if rec is not None:
                    self.counts[rec["layer"]] += 1
                    self.injected.append(rec)
                    out.append(rec)
                    break
        return out
