"""The port's copy of utils/chaos.py held against the reference: for the
same seeds every fault source gives the same schedule — the wire
injector's verdicts (forced faults interleaved), the controller fault
gate, capacity-drought windows on a fake clock, device-kill verdicts, and
the warm-state corruptor's injections into each package's ProblemState
after the same solve."""

import importlib

import numpy as np
import pytest

from test_torch_support import (JAX, PORT, ROOTS, mini_workload, scheduler,
                                warm_pkg)
from test_torch_support import device_series_kept  # noqa: F401 (autouse)


def chaos(root: str):
    return importlib.import_module(f"{root}.utils.chaos")


def _wire_schedule(root: str, seed: int, rates: dict, forced: dict,
                   attempts: int = 200) -> tuple:
    inj = chaos(root).WireFaultInjector(seed=seed, **rates)
    out = []
    for i in range(attempts):
        if i in forced:
            inj.inject_next(*forced[i])
        out.append(tuple(inj.draw()))
    return out, dict(inj.counts), inj.fired()


@pytest.mark.parametrize("seed", [0, 7, 99, 1234])
def test_wire_fault_schedules_match(seed):
    rates = dict(drop=0.1, delay=0.2, duplicate=0.05, disconnect=0.05,
                 delay_seconds=0.01)
    forced = {3: ("drop",), 17: ("delay", "disconnect"), 60: ("duplicate",)}
    want = _wire_schedule(JAX, seed, rates, forced)
    assert want[2] > 0
    assert _wire_schedule(PORT, seed, rates, forced) == want


def test_wire_injector_rejects_unknown_kinds_in_both():
    for root in ROOTS:
        with pytest.raises(ValueError, match="unknown wire fault kind"):
            chaos(root).WireFaultInjector(seed=1).inject_next("melt")


@pytest.mark.parametrize("seed", [1, 5, 42])
def test_controller_fault_gate_schedules_match(seed):
    def run(root):
        c = chaos(root)
        injection = importlib.import_module(f"{root}.utils.injection")
        inj = c.FaultInjector(seed=seed, rate=0.2, terminal_rate=0.3)
        inj.poison("bad-pod")
        out = []
        for i in range(150):
            name = "bad-pod" if i % 37 == 0 else f"obj-{i}"
            ctx = injection.with_controller("ctrl") if i % 5 else None
            try:
                if ctx is None:
                    inj.maybe_raise("get", name)
                else:
                    with ctx:
                        inj.maybe_raise("update", name)
                out.append("ok")
            except c.InjectedTerminalFault as e:
                out.append(f"terminal: {e}")
            except c.InjectedFault as e:
                out.append(f"transient: {e}")
        return out, dict(inj.counts)
    want = run(JAX)
    assert any(o.startswith("terminal") for o in want[0])
    assert run(PORT) == want


def test_capacity_drought_windows_match():
    def run(root):
        clock = importlib.import_module(f"{root}.utils.clock").FakeClock()
        d = chaos(root).CapacityDrought(clock=clock)
        d.exhaust("m5.large", "*", "spot", duration=10.0)
        d.exhaust("*", "zone-b")
        out = []
        for t in range(4):
            for it in ("m5.large", "c5.xlarge"):
                for zone in ("zone-a", "zone-b"):
                    for ct in ("spot", "on-demand"):
                        out.append(d.match(it, zone, ct))
            clock.step(6.0)
        d.clear()
        out.append(d.match("m5.large", "zone-b", "spot"))
        return out, dict(d.hits)
    assert run(PORT) == run(JAX)


def test_device_killer_verdicts_match():
    def run(root):
        k = chaos(root).DeviceKiller()
        out = [k.verdict([0, 1, 2])]
        k.kill(2)
        k.kill(5)
        out += [k.verdict([0, 1, 2]), k.verdict([5, 2]), k.verdict([3])]
        k.revive(2)
        out.append(k.verdict([0, 1, 2]))
        k.enabled = False
        out.append(k.verdict([5]))
        return out, dict(k.counts)
    assert run(PORT) == run(JAX)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_state_corruptor_flips_the_same_bytes(seed):
    base = np.arange(64, dtype=np.int32).reshape(8, 8)
    got = {}
    for root in ROOTS:
        arrays = [base.copy(), base[:3].copy(), np.zeros(0, np.int32)]
        c = chaos(root).StateCorruptor(seed=seed)
        flips = [c._flip(a) for a in arrays for _ in range(3)]
        got[root] = (flips, [a.tobytes() for a in arrays])
    assert got[PORT] == got[JAX]


@pytest.mark.parametrize("seed", [2, 9])
def test_state_corruptor_injects_the_same_faults(seed):
    """After the same warm solve in each package, the same seed corrupts
    the same layers of each package's plane in the same way."""
    records = {}
    for root in ROOTS:
        pools, its, nodes, pods = mini_workload(root)
        ps = warm_pkg(root).problem_state.ProblemState()
        scheduler(root, pools, its, state_nodes=nodes,
                  problem_state=ps).solve(pods)
        c = chaos(root).StateCorruptor(seed=seed)
        records[root] = ([{k: v for k, v in r.items()}
                          for r in c.corrupt(ps.plane, ps, count=6)],
                         dict(c.counts))
        ps.close()
    assert records[JAX][0], "nothing was injected"
    assert records[PORT] == records[JAX]
