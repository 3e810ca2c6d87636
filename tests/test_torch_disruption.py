"""disruption/*: the port's disruption solver (on the CPU, through the
kernels' plain versions) against the JAX package's, over the same live
cluster in each package — Emptiness, Drift, MultiNodeConsolidation and
SingleNodeConsolidation commands, the batched leave-one-out engine on the
generator of test_single_consolidation_fuzzer.py (held also to the port's
own per-candidate oracle), StreamingDisruptionState warm passes against
cold rebuilds, and DisruptionController passes. Commands are compared by
name: equal, or the test fails."""

import random

import pytest
import torch

import test_torch_support as support
from test_torch_support import (JAX, PORT, ROOTS, LiveEnv, MinValuesReq,
                                command_summary, pkg, stuck_fleet)
from test_torch_support import device_series_kept  # noqa: F401 (autouse)

OD, SPOT = "on-demand", "spot"
CPUS = ("100m", "250m", "500m", "1", "2")
METHODS = ("Emptiness", "Drift", "MultiNodeConsolidation",
           "SingleNodeConsolidation")


def catalog(root):
    return sorted(pkg(root).kwok.construct_instance_types(),
                  key=lambda it: it.name)


def make_method(env, name, spot_to_spot=False):
    cls = getattr(env.lv.methods, name)
    if name in ("MultiNodeConsolidation", "SingleNodeConsolidation"):
        return cls(env.cluster, env.provisioner,
                   spot_to_spot_enabled=spot_to_spot, clock=env.clock)
    return cls(env.cluster, env.provisioner)


def cold_pass(env, name, spot_to_spot=False):
    """A fresh snapshot and the cold candidate / budget path."""
    lv = env.lv
    m = make_method(env, name, spot_to_spot)
    snap = lv.prefix.DisruptionSnapshot(env.cluster, env.provisioner)
    if hasattr(m, "attach_snapshot"):
        m.attach_snapshot(snap)
    cands = lv.helpers.get_candidates(
        env.cluster, env.provisioner, m.should_disrupt,
        disruption_class=m.disruption_class, context=snap)
    budgets = lv.helpers.build_disruption_budget_mapping(env.cluster,
                                                         m.reason)
    cmd, res = m.compute_command(budgets, cands)
    return [c.name for c in cands], budgets, command_summary(env, cmd, res)


def stream_pass(env, name):
    """The same pass through the controller's persistent streaming state."""
    stream = env.disruption.stream
    m = make_method(env, name)
    snap = stream.refresh(env.cluster, env.provisioner)
    if hasattr(m, "attach_snapshot"):
        m.attach_snapshot(snap)
    cands = stream.candidates_for(m.should_disrupt,
                                  disruption_class=m.disruption_class)
    budgets = stream.budget_mapping(m.reason)
    cmd, res = m.compute_command(budgets, cands)
    return [c.name for c in cands], budgets, command_summary(env, cmd, res)


def assert_stream_parity(envs, methods=METHODS):
    """Warm == cold inside each package, and the port == the JAX package."""
    for name in methods:
        got = {}
        for root, env in envs.items():
            warm = stream_pass(env, name)
            assert warm == cold_pass(env, name), (root, name)
            got[root] = warm
        assert got[PORT] == got[JAX], name


# -- a mixed fleet: empty, drifted, underutilized, spot and full nodes -------

def mixed_fleet(root, n=10):
    its = catalog(root)
    env = LiveEnv(root, its)
    env.pool()
    for i in range(n):
        it = its[(7 * i) % 40]
        cores = max(1, it.capacity.get("cpu", 4000) // 1000)
        name = f"mix-{i:02d}"
        env.node(name, it, capacity_type=SPOT if i % 4 == 3 else OD,
                 zone=f"test-zone-{'abc'[i % 3]}",
                 alloc={"cpu": str(cores), "memory": "16Gi", "pods": "110"},
                 drifted=i in (2, 7))
        for j in range((0, 1, 2, 1, 0, 3)[i % 6]):
            env.bind(name, f"mix-pod-{i}-{j}", cpu=CPUS[(i + j) % 4],
                     labels={"app": ("web", "api")[j % 2]})
    env.pending("mix-pending-0", cpu="300m")
    env.clock.step(600)
    return env


def oversized_fleet(root):
    """Two nodes of the most expensive on-demand type, each holding a pod
    that the other has no room for: no deletion works, a cheaper
    replacement of one node does (and no pair fits one node)."""
    its = catalog(root)
    env = LiveEnv(root, its)
    env.pool()
    big = max(its, key=lambda it: (min(o.price for o in it.offerings
                                       if o.capacity_type == OD), it.name))
    for i in range(2):
        env.node(f"big-{i}", big, alloc=big.allocatable())
        env.bind(f"big-{i}", f"big-pod-{i}",
                 cpu=f"{big.allocatable()['cpu'] * 6 // 10}m")
    env.clock.step(600)
    return env


FLEETS = {"mixed": mixed_fleet, "oversized": oversized_fleet,
          # chip_smoke.py's fleets at a small size
          "underutilized": lambda root: support.underutilized_fleet(root, 12),
          "stuck": lambda root: stuck_fleet(root, 12)}


@pytest.mark.parametrize("fleet", sorted(FLEETS))
@pytest.mark.parametrize("method", METHODS)
def test_method_commands_match(method, fleet):
    got = {root: cold_pass(FLEETS[fleet](root), method) for root in ROOTS}
    assert got[PORT] == got[JAX]
    summary = got[PORT][2]
    if fleet == "mixed" and method in ("Emptiness", "Drift"):
        assert summary["candidates"], method
    if fleet == "oversized" and method == "SingleNodeConsolidation":
        assert summary["decision"] == "replace" and \
            summary["replacements"][0], summary


@pytest.mark.parametrize("fleet,method,decision,n_candidates", [
    ("underutilized_fleet", "MultiNodeConsolidation", "delete", 100),
    ("stuck_fleet", "SingleNodeConsolidation", "delete", 1)])
def test_consolidation_at_full_size_matches(fleet, method, decision,
                                            n_candidates):
    """chip_smoke.py's consolidation phases at their 5,000 nodes: equal
    candidates, budgets and commands in both packages."""
    got = {root: cold_pass(getattr(support, fleet)(root, 5000), method)
           for root in ROOTS}
    assert got[PORT] == got[JAX]
    cands, _, summary = got[PORT]
    assert len(cands) == 5000
    assert (summary["decision"], len(summary["candidates"])) == \
        (decision, n_candidates)
    if fleet == "stuck_fleet":
        assert summary["candidates"] == ["single-node-04999"]


def _plain(x):
    """An object as plain values, its uid (drawn per process) left out."""
    if hasattr(x, "__dict__"):
        return {k: _plain(v) for k, v in sorted(vars(x).items())
                if k != "uid"}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def store_objects(store) -> dict:
    from karpenter_tpu_torch.api.nodeclaim import NodeClaim
    from karpenter_tpu_torch.api.nodepool import NodePool
    from karpenter_tpu_torch.api.objects import Node, Pod
    return {kind.__name__: sorted((_plain(o) for o in store.list(kind)),
                                  key=lambda o: o["metadata"]["name"])
            for kind in (NodePool, NodeClaim, Node, Pod)}


@pytest.mark.parametrize("fleet", ("underutilized_fleet", "stuck_fleet"))
def test_chip_smoke_fleets_match_live_env(fleet):
    """chip_smoke.py builds its live fleets with the port alone; the
    LiveEnv builders that the tests above run in both packages create the
    same objects, on the same catalog and clock."""
    import chip_smoke
    smoke = getattr(chip_smoke, fleet)("cpu", 12)
    live = getattr(support, fleet)(PORT, 12)
    assert [it.name for it in smoke.catalog] == \
        [it.name for it in live.provider.its]
    assert smoke.clock.now() == live.clock.now()
    got, want = store_objects(smoke.store), store_objects(live.store)
    assert [len(v) for v in got.values()] == [1, 12, 12, 12 + (
        fleet == "stuck_fleet")]
    assert got == want


def test_multi_node_engine_matches():
    """MultiNodeConsolidation's ranked subset search: same command, same
    probes saved, in both packages."""
    got = {}
    for root in ROOTS:
        env = mixed_fleet(root, n=14)
        m = make_method(env, "MultiNodeConsolidation")
        cands = env.lv.helpers.get_candidates(env.cluster, env.provisioner,
                                              m.should_disrupt)
        cmd, res = m.compute_command({"default": 100}, cands)
        stats = m.last_multi_engine_stats
        got[root] = (command_summary(env, cmd, res),
                     None if stats is None else sorted(stats.items()))
    assert got[PORT] == got[JAX]
    assert got[PORT][0]["candidates"]


# -- test_single_consolidation_fuzzer.py's generator, for either package ----

def fuzz_cluster(seed: int, root: str):
    """Spot candidates under the spot-to-spot gate (on or off), minValues
    pools, uninitialized nodes, multi-pod and multi-group candidates, and
    nodes too full to absorb anything."""
    rng = random.Random(seed)
    spot_to_spot = rng.random() < 0.5
    its = catalog(root)
    env = LiveEnv(root, its, spot_to_spot=spot_to_spot)
    reqs = []
    if rng.random() < 0.2:
        reqs = [MinValuesReq(pkg(root).labels.LABEL_INSTANCE_TYPE, "Exists",
                             (), rng.choice((5, 20)))]
    env.pool(requirements=reqs)
    for i in range(rng.randint(18, 26)):
        ct = SPOT if rng.random() < 0.4 else OD
        it = rng.choice(its)
        initialized = rng.random() > 0.15
        cores = max(1, it.capacity.get("cpu", 4000) // 1000)
        name = f"fz-{i:02d}"
        env.node(name, it, capacity_type=ct,
                 alloc={"cpu": str(cores), "memory": "16Gi", "pods": "110"},
                 initialized=initialized, consolidatable=initialized)
        shape = rng.random()
        if shape < 0.45:
            pods = [f"{cores * 800}m"]
        elif shape < 0.6 and cores >= 2:
            pods = [f"{cores * 250}m"] * 2
        else:
            pods = [rng.choice(CPUS) for _ in range(rng.randint(0, 2))]
        for j, cpu in enumerate(pods):
            env.bind(name, f"fz-pod-{i}-{j}", cpu=cpu)
    env.clock.step(600)
    return env, spot_to_spot


def run_single_node(env, spot_to_spot, batched):
    """One compute_command pass; batched=False forces the reference's
    serial shape (one simulate_scheduling per candidate: the oracle)."""
    methods = env.lv.methods
    saved = methods.SINGLE_NODE_BATCH_MIN_CANDIDATES
    methods.SINGLE_NODE_BATCH_MIN_CANDIDATES = 1 if batched else 10**9
    try:
        m = make_method(env, "SingleNodeConsolidation", spot_to_spot)
        cands = env.lv.helpers.get_candidates(env.cluster, env.provisioner,
                                              m.should_disrupt)
        budgets = env.lv.helpers.build_disruption_budget_mapping(
            env.cluster, m.reason)
        cmd, results = m.compute_command(budgets, cands)
    finally:
        methods.SINGLE_NODE_BATCH_MIN_CANDIDATES = saved
    return ([c.name for c in cands], command_summary(env, cmd, results),
            m.last_engine_stats)


# seeds 7000-7011 of the JAX package's corpus: spot-to-spot on and off,
# minValues pools (7003, 7004, 7006, 7010) and uninitialized nodes in every
# case
@pytest.mark.parametrize("seed", range(7000, 7012))
def test_leave_one_out_matches_jax_and_oracle(seed):
    got = {}
    for root in ROOTS:
        env, spot_to_spot = fuzz_cluster(seed, root)
        got[root] = run_single_node(env, spot_to_spot, batched=True)
    assert got[PORT] == got[JAX], seed
    cands, summary, stats = got[PORT]
    if cands:
        assert stats is not None, "the batched engine never engaged"
    env, spot_to_spot = fuzz_cluster(seed, PORT)
    _, oracle, _ = run_single_node(env, spot_to_spot, batched=False)
    assert summary == oracle, seed


def test_fuzz_seeds_cover_the_gates():
    seen = set()
    for seed in range(7000, 7012):
        rng = random.Random(seed)
        spot_to_spot = rng.random() < 0.5
        seen.add("spot_to_spot" if spot_to_spot else "no_spot_to_spot")
        if rng.random() < 0.2:
            seen.add("min_values")
    assert seen == {"spot_to_spot", "no_spot_to_spot", "min_values"}


# -- StreamingDisruptionState: warm passes equal cold rebuilds --------------

def small_fleet(root, n=6, pods_per_node=(1, 1, 2, 0, 1, 1)):
    its = catalog(root)
    env = LiveEnv(root, its)
    env.pool()
    for i in range(n):
        it = its[i % 7]
        cores = max(1, it.capacity.get("cpu", 4000) // 1000)
        env.node(f"sf-{i:02d}", it, capacity_type=OD if i % 3 else SPOT,
                 alloc={"cpu": str(cores), "memory": "16Gi", "pods": "110"})
        for j in range(pods_per_node[i % len(pods_per_node)]):
            env.bind(f"sf-{i:02d}", f"sf-pod-{i}-{j}", labels={"app": "web"})
    env.clock.step(600)
    return env


def fleets(n=6):
    return {root: small_fleet(root, n) for root in ROOTS}


def test_idle_pass_reuses_every_layer():
    envs = fleets()
    for env in envs.values():
        stream = env.disruption.stream
        stream.refresh(env.cluster, env.provisioner)
        snap = stream._snapshot
        stream.refresh(env.cluster, env.provisioner)
        assert stream._snapshot is snap
        assert stream.last["layers"] == {
            "pods": "reused", "context": "reused", "scheduler": "reused",
            "encodings": "reused"}
        assert stream.last["rows_rebuilt"] == 0
    assert_stream_parity(envs)


def test_bind_rebuilds_one_row():
    envs = fleets()
    for env in envs.values():
        env.disruption.stream.refresh(env.cluster, env.provisioner)
        env.bind("sf-02", "extra", cpu="100m", memory="64Mi")
        env.disruption.stream.refresh(env.cluster, env.provisioner)
        assert env.disruption.stream.last["rows_rebuilt"] == 1
    assert_stream_parity(envs)


def test_pdb_and_budget_edits():
    envs = fleets()
    for env in envs.values():
        stream = env.disruption.stream
        stream.refresh(env.cluster, env.provisioner)
        pol, o = env.lv.policy, env.k.objects
        env.store.create(pol.PodDisruptionBudget(
            metadata=o.ObjectMeta(name="block-web", namespace="default"),
            spec=pol.PDBSpec(selector=o.LabelSelector(
                match_labels={"app": "web"}), max_unavailable="0")))
        stream.refresh(env.cluster, env.provisioner)
        assert stream.last["layers"]["context"] == "rebuilt"
    assert_stream_parity(envs)
    for env in envs.values():
        pool = env.store.list(env.k.nodepool.NodePool)[0]
        pool.spec.disruption.budgets = [env.k.nodepool.Budget(nodes="1")]
        env.store.update(pool)
    assert_stream_parity(envs)


def test_node_encode_rows_are_delta_applied():
    envs = fleets()
    for env in envs.values():
        stream = env.disruption.stream
        snap = stream.refresh(env.cluster, env.provisioner)
        m = make_method(env, "SingleNodeConsolidation")
        snap.simulate(stream.candidates_for(m.should_disrupt))
        assert stream.problem_state.last["node_rows_reencoded"] == \
            len(snap.state_nodes)
        env.pending("warm-pending", cpu="100m", memory="64Mi")
        snap = stream.refresh(env.cluster, env.provisioner)
        snap.simulate(stream.candidates_for(m.should_disrupt))
        assert stream.problem_state.last["node_rows_reencoded"] == 0
        assert stream.problem_state.last["encode_kind"] == "delta"
    assert_stream_parity(envs)


def _churn_step(env, rng, seed, seq):
    """One seeded mutation (test_streaming_disruption.py's churn, without
    a controller roster: a provisioning pass takes the place of the
    roster's reconciles, and drift is the marker's Drifted condition)."""
    k, o = env.k, env.k.objects
    its = catalog(env.root)
    action = rng.choice(["bind", "unbind", "pending", "add_node", "pdb",
                         "budget", "nominate", "mark", "drift",
                         "provision"])
    nodes = sorted(n.name for n in env.store.list(o.Node))
    if action == "bind" and nodes:
        env.bind(rng.choice(nodes), f"churn-{seed}-{seq}", memory="64Mi",
                 labels={"app": rng.choice(("web", "api"))})
    elif action == "unbind":
        pods = sorted((p for p in env.store.list(o.Pod) if p.spec.node_name),
                      key=lambda p: p.metadata.name)
        if pods:
            env.store.delete(rng.choice(pods))
    elif action == "pending":
        env.pending(f"churn-pend-{seed}-{seq}", cpu="50m", memory="32Mi")
    elif action == "add_node":
        it = rng.choice(its[:7])
        cores = max(1, it.capacity.get("cpu", 4000) // 1000)
        env.node(f"churn-node-{seq}", it,
                 alloc={"cpu": str(cores), "memory": "16Gi", "pods": "110"})
        env.clock.step(600)
    elif action == "pdb":
        pol = env.lv.policy
        env.store.create(pol.PodDisruptionBudget(
            metadata=o.ObjectMeta(name=f"churn-pdb-{seed}-{seq}",
                                  namespace="default"),
            spec=pol.PDBSpec(selector=o.LabelSelector(
                match_labels={"app": rng.choice(("web", "api"))}),
                max_unavailable=rng.choice(("0", "1")))))
    elif action == "budget":
        pool = env.store.list(k.nodepool.NodePool)[0]
        pool.spec.disruption.budgets = [k.nodepool.Budget(
            nodes=rng.choice(("0", "1", "50%", "100%")))]
        env.store.update(pool)
    elif action == "nominate" and nodes:
        env.cluster.nominate_node_for_pod(
            rng.choice(nodes), o.Pod(metadata=o.ObjectMeta(
                name=f"nom-{seq}", namespace="default"), spec=o.PodSpec()))
    elif action == "mark":
        pids = sorted(env.cluster.nodes)
        pid = rng.choice(pids)
        if rng.random() < 0.5:
            env.cluster.mark_for_deletion(pid)
        else:
            env.cluster.unmark_for_deletion(pid)
    elif action == "drift":
        ncs = sorted(env.store.list(env.w.nodeclaim.NodeClaim),
                     key=lambda nc: nc.name)
        nc = rng.choice(ncs)
        nc.metadata.annotations[
            k.labels.NODEPOOL_HASH_ANNOTATION_KEY] = "stale"
        nc.conditions.set_true(env.w.nodeclaim.COND_DRIFTED,
                               now=env.clock.now())
        env.store.update(nc)
    elif action == "provision":
        env.provision()
    return action


@pytest.mark.parametrize("seed", range(8100, 8104))
def test_streaming_churn_matches_cold_every_step(seed):
    """After every seeded mutation the streaming pass (accumulated deltas)
    equals a cold rebuild for all four methods, and the port the JAX
    package."""
    envs = fleets(n=8)
    rngs = {root: random.Random(seed) for root in ROOTS}
    assert_stream_parity(envs)
    for seq in range(8):
        actions = {root: _churn_step(env, rngs[root], seed, seq)
                   for root, env in envs.items()}
        assert actions[PORT] == actions[JAX]
        step = random.Random(seed * 100 + seq)
        if step.random() < 0.3:
            dt = step.choice((1, 30, 400))
            for env in envs.values():
                env.clock.step(dt)
        assert_stream_parity(envs)


# -- DisruptionController: cold pass, warm passes, validated execution ------

def _controller_command(ctrl):
    assert ctrl.pending is not None, "the pass made no decision"
    cmd = ctrl.pending[0]
    return (cmd.decision, sorted(c.name for c in cmd.candidates),
            [[it.name for it in r.instance_type_options]
             for r in cmd.replacements])


def _one_pass(ctrl):
    ctrl.pending = None
    for m in ctrl.methods:
        if hasattr(m, "_last_state"):
            m._last_state = None
    ctrl.reconcile()
    return _controller_command(ctrl)


def test_controller_warm_passes_match_cold_rebuild():
    """A cold DisruptionController pass, then warm passes served by the
    streaming state (every layer reused): each command equals a fresh
    controller's, and the port's the JAX package's. Then the TTL re-check
    executes the command in both."""
    got = {}
    for root in ROOTS:
        env = stuck_fleet(root, 24)
        cold = _one_pass(env.disruption)
        assert cold[:2] == ("delete", ["single-node-00023"])
        warm = []
        for _ in range(2):
            warm.append(_one_pass(env.disruption))
            last = env.disruption.stream.last
            assert set(last["layers"].values()) == {"reused"}, last
            assert last["rows_rebuilt"] == 0
        assert warm == [cold, cold]
        ctrl = env.lv.controller
        fresh = ctrl.DisruptionController(
            env.store, env.cluster, env.provisioner,
            ctrl.OrchestrationQueue(env.store, env.cluster, env.clock),
            env.clock)
        assert _one_pass(fresh) == cold
        # validation after the consolidation TTL, then execution
        env.clock.step(env.lv.validation.CONSOLIDATION_TTL_SECONDS + 0.1)
        env.disruption.reconcile()
        assert env.disruption.pending is None
        marked = sorted(sn.name() for sn in env.cluster.nodes.values()
                        if sn.mark_for_deletion)
        got[root] = (cold, marked)
    assert got[PORT] == got[JAX]
    assert got[PORT][1] == ["single-node-00023"]


def test_snapshot_runs_on_the_provisioners_device():
    """The snapshot's TensorScheduler takes the provisioner's device: a
    port Provisioner on the CPU gives a CPU snapshot whose encodings run
    the plain versions (no kernel launch counted)."""
    from karpenter_tpu_torch.ops import kernels
    env = small_fleet(PORT)
    snap = env.lv.prefix.DisruptionSnapshot(env.cluster, env.provisioner)
    assert snap.ts.device == torch.device("cpu") == env.provisioner.device
    m = make_method(env, "SingleNodeConsolidation")
    cands = env.lv.helpers.get_candidates(env.cluster, env.provisioner,
                                          m.should_disrupt, context=snap)
    before = dict(kernels.LAUNCHES)
    enc = snap.encoding_for(cands)
    assert enc.tensors.it_ok.any()
    assert kernels.LAUNCHES == before
    stream = env.disruption.stream
    assert stream.refresh(env.cluster, env.provisioner).ts.device == \
        torch.device("cpu")
