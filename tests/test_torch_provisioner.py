"""provisioning/provisioner.py: Provisioner.reconcile on the port (on the
CPU, through the kernels' plain versions) against the JAX package's, over
the same live cluster — the created NodeClaims, the nominations, the pods
bound to existing nodes and the pod errors equal, pass after pass, the
warm passes over each package's shared EncodePlane included."""

import pytest
import torch

from test_torch_support import (JAX, PORT, ROOTS, LiveEnv, deployment,
                                live_pkg, mini_workload, pkg,
                                provisioning_digest)
from test_torch_support import device_series_kept  # noqa: F401 (autouse)
from test_torch_solve_parity import SEEDS, fuzz_case


def _mini_env(root):
    """__graft_entry__._mini_scheduler's workload as a live cluster: two
    weighted pools (one cpu-limited), an initialized node and an
    uninitialized one, a zonal-spread mix pending."""
    pools, its, _, pods = mini_workload(root)
    env = LiveEnv(root, its, pools)
    env.node("graft-node-init", its["default"][0],
             alloc={"cpu": "4", "memory": "8Gi", "pods": "110"})
    env.node("graft-node-uninit", its["default"][0], zone="test-zone-b",
             alloc={"cpu": "2", "memory": "4Gi", "pods": "110"},
             initialized=False)
    for p in pods:
        env.store.create(p)
    return env


def _fuzz_env(seed):
    def make(root):
        pools, its, pods = fuzz_case(seed, root)
        env = LiveEnv(root, its, pools)
        for p in pods:
            env.store.create(p)
        return env
    return make


def _lockstep(make_env, windows):
    """Build the env in both packages, run one provisioning pass, then one
    more after each window (a function of the env); every pass's digest
    and ProblemState record must agree across the packages."""
    envs = {root: make_env(root) for root in ROOTS}
    digests = []
    for i in range(len(windows) + 1):
        got, last = {}, {}
        for root, env in envs.items():
            if i:
                windows[i - 1](env)
            env.provision()
            got[root] = provisioning_digest(env)
            last[root] = {k: env.provisioner.problem_state.last.get(k)
                          for k in ("encode_kind", "node_rows_reencoded",
                                    "precompute")}
        assert got[PORT] == got[JAX], f"pass {i}"
        assert last[PORT] == last[JAX], (i, last)
        digests.append(got[PORT])
    return envs, digests


def _rollout(name, n, cpu="300m"):
    def window(env):
        for p in deployment(env.root, name, n, cpu=cpu, spread_key="zone"):
            env.store.create(p)
    return window


def _drop_pending(count):
    def window(env):
        o = env.k.objects
        pending = sorted((p for p in env.store.list(o.Pod)
                          if not p.spec.node_name),
                         key=lambda p: p.metadata.name)
        for p in pending[:count]:
            env.store.delete(p)
    return window


def test_mini_workload_passes():
    envs, digests = _lockstep(_mini_env, [_rollout("roll-a", 9),
                                          _drop_pending(3)])
    claims, bound, _ = digests[0]
    assert claims and bound
    # later passes pack onto the claims of the first (in flight)
    assert len(digests[1][0]) >= len(claims)
    for env in envs.values():
        ts = env.provisioner.last_scheduler
        assert ts.fallback_reason == ""
    assert envs[PORT].provisioner.last_scheduler.device.type == "cpu"


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_seed_passes(seed):
    _, digests = _lockstep(_fuzz_env(seed), [_rollout(f"roll-{seed}", 5)])
    assert digests[0][0] or digests[0][2]


def test_deleting_node_pods_ride_along():
    """Pods on a node marked for deletion are re-planned even with nothing
    pending: the replacement claim carries them in both packages."""
    def make(root):
        its = pkg(root).kwok.construct_instance_types()[:24]
        env = LiveEnv(root, its)
        env.pool()
        env.node("leaving", its[5], alloc={"cpu": "4", "memory": "16Gi",
                                           "pods": "110"})
        for i in range(3):
            env.bind("leaving", f"ride-{i}", cpu="700m")
        sn = next(iter(env.cluster.nodes.values()))
        env.cluster.mark_for_deletion(sn.provider_id)
        return env

    _, digests = _lockstep(make, [])
    claims = digests[0][0]
    assert claims and sum(len(c[3]) for c in claims) == 3


def test_device_and_unported_options():
    """The port's Provisioner runs on the card unless told otherwise (and
    refuses a default device with no CUDA present); the per-pass profile
    and the flight recorder, once refused, are carried: each is kept where
    the reference keeps it."""
    from karpenter_tpu_torch.flightrec import FlightRecorder
    lv = live_pkg(PORT)
    env = LiveEnv(PORT, [])
    prov = env.provisioner
    assert prov.device == torch.device("cpu")
    assert prov.profile_dir is None and prov.flight_recorder is None
    prov.profile_dir = "/tmp/profile"
    assert prov.profile_dir == "/tmp/profile"
    rec = FlightRecorder()
    assert lv.provisioner.Provisioner(
        env.store, env.cluster, env.provider, env.clock, device="cpu",
        flight_recorder=rec).flight_recorder is rec
    assert lv.controller.DisruptionController(
        env.store, env.cluster, prov, env.queue, env.clock,
        flight_recorder=rec).flight_recorder is rec
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            lv.provisioner.Provisioner(env.store, env.cluster, env.provider,
                                       env.clock)
