"""The port's recording fake provider (karpenter_tpu_torch/cloudprovider/
fake.py): tests/test_cloudprovider.py's three ``test_fake_*`` cases on the
port, ``fake_instance_types(n)`` equal to the JAX package's for several n,
its chaos, drought and unavailable-offering hooks, and one solve over a
fake catalog through both packages to the same decision digest."""

import importlib

import pytest

from karpenter_tpu_torch.api import labels as api_labels
from karpenter_tpu_torch.api.nodeclaim import NodeClaim, NodeClaimSpec
from karpenter_tpu_torch.api.objects import NodeSelectorRequirement
from karpenter_tpu_torch.cloudprovider.fake import (FAKE_ZONES,
                                                    FakeCloudProvider,
                                                    fake_instance_types)
from karpenter_tpu_torch.cloudprovider.types import (
    InsufficientCapacityError, NodeClaimNotFoundError)
from karpenter_tpu_torch.scheduling.requirement import IN
from karpenter_tpu_torch.utils import resources as res

from test_torch_support import JAX, PORT, ROOTS, factories, scheduler
from test_torch_support import device_series_kept  # noqa: F401 (autouse)


def _claim(cpu="1", zone=None):
    reqs = []
    if zone:
        reqs.append(NodeSelectorRequirement(api_labels.LABEL_TOPOLOGY_ZONE,
                                            IN, (zone,)))
    return NodeClaim(spec=NodeClaimSpec(
        requirements=reqs, resources_requests=res.parse_list({"cpu": cpu})))


def test_fake_create_cheapest_and_records():
    cp = FakeCloudProvider()
    nc = cp.create(_claim())
    assert nc.status.provider_id.startswith("fake://")
    assert len(cp.create_calls) == 1
    # cheapest compatible = 1-cpu spot
    assert nc.metadata.labels[api_labels.CAPACITY_TYPE_LABEL_KEY] == \
        api_labels.CAPACITY_TYPE_SPOT


def test_fake_injectable_errors_and_caps():
    cp = FakeCloudProvider()
    cp.next_create_err = InsufficientCapacityError("boom")
    with pytest.raises(InsufficientCapacityError):
        cp.create(_claim())
    cp.reset()
    cp.allowed_create_calls = 1
    cp.create(_claim())
    with pytest.raises(InsufficientCapacityError):
        cp.create(_claim())


def test_fake_delete_and_get():
    cp = FakeCloudProvider()
    nc = cp.create(_claim())
    assert cp.get(nc.status.provider_id) is nc
    cp.delete(nc)
    with pytest.raises(NodeClaimNotFoundError):
        cp.get(nc.status.provider_id)


def _catalog_rows(root: str, n: int) -> list:
    fake = importlib.import_module(f"{root}.cloudprovider.fake")
    rows = []
    for it in fake.fake_instance_types(n):
        rows.append((it.name, sorted(it.capacity.items()),
                     sorted(it.allocatable().items()),
                     repr(sorted((r.key, r.operator(), sorted(r.values))
                                 for r in it.requirements.values())),
                     [(o.zone, o.capacity_type, o.price, o.available)
                      for o in it.offerings]))
    return rows


@pytest.mark.parametrize("n", [0, 1, 6, 9, 40])
def test_fake_instance_types_equal_the_reference(n):
    assert _catalog_rows(PORT, n) == _catalog_rows(JAX, n)


def _created(root: str, claims) -> list:
    fake = importlib.import_module(f"{root}.cloudprovider.fake")
    cp = fake.FakeCloudProvider(fake.fake_instance_types(12))
    out = []
    for cpu, zone in claims:
        nc_mod = importlib.import_module(f"{root}.api.nodeclaim")
        o = importlib.import_module(f"{root}.api.objects")
        L = importlib.import_module(f"{root}.api.labels")
        r = importlib.import_module(f"{root}.utils.resources")
        reqs = [o.NodeSelectorRequirement(L.LABEL_TOPOLOGY_ZONE, "In",
                                          (zone,))] if zone else []
        try:
            nc = cp.create(nc_mod.NodeClaim(spec=nc_mod.NodeClaimSpec(
                requirements=reqs,
                resources_requests=r.parse_list({"cpu": cpu}))))
        except Exception as e:  # noqa: BLE001 — compared by type and text
            out.append((type(e).__name__, str(e)))
            continue
        out.append((nc.status.provider_id, dict(nc.metadata.labels),
                    sorted(nc.status.allocatable.items())))
    out.append(sorted(cp.created))
    return out


def test_fake_creates_equal_the_reference():
    claims = [("1", None), ("3", FAKE_ZONES[1]), ("100", None),
              ("16", FAKE_ZONES[2]), ("2", "no-such-zone"), ("64", None)]
    assert _created(PORT, claims) == _created(JAX, claims)


def test_fake_chaos_drought_and_unavailable_hooks():
    from karpenter_tpu_torch.state.unavailable import UnavailableOfferings
    from karpenter_tpu_torch.utils.chaos import (CapacityDrought,
                                               FaultInjector, InjectedFault)
    from karpenter_tpu_torch.utils.clock import FakeClock
    cp = FakeCloudProvider()
    cp.chaos = FaultInjector(seed=3, rate=1.0, reconcile_only=False)
    with pytest.raises(InjectedFault):
        cp.create(_claim())
    assert cp.chaos.counts["fake.create"] == 1 and not cp.create_calls
    cp.chaos = None
    cheapest = cp.create(_claim())
    zone = cheapest.metadata.labels[api_labels.LABEL_TOPOLOGY_ZONE]
    it = cheapest.metadata.labels[api_labels.LABEL_INSTANCE_TYPE]
    ct = cheapest.metadata.labels[api_labels.CAPACITY_TYPE_LABEL_KEY]
    cp.unavailable = UnavailableOfferings(clock=FakeClock())
    cp.unavailable.mark(it, zone, ct)
    other = cp.create(_claim())
    assert (other.metadata.labels[api_labels.LABEL_INSTANCE_TYPE],
            other.metadata.labels[api_labels.LABEL_TOPOLOGY_ZONE],
            other.metadata.labels[api_labels.CAPACITY_TYPE_LABEL_KEY]) != \
        (it, zone, ct)
    cp.unavailable = None
    cp.drought = CapacityDrought(clock=FakeClock())
    cp.drought.exhaust(instance_type=it, zone=zone, capacity_type=ct,
                       duration=60.0)
    with pytest.raises(InsufficientCapacityError) as dry:
        cp.create(_claim())
    assert dry.value.offerings == ((it, zone, ct),)


@pytest.mark.parametrize("n_types", [6, 16])
def test_solve_over_a_fake_catalog_matches(n_types):
    digests = []
    for root in ROOTS:
        fake = importlib.import_module(f"{root}.cloudprovider.fake")
        record = importlib.import_module(f"{root}.flightrec.record")
        F = factories(root)
        pods = [F.make_pod(cpu=f"{(i % 5 + 1) * 300}m", name=f"fk-{i}")
                for i in range(24)]
        ts = scheduler(root, [F.make_nodepool(name="default")],
                       {"default": fake.fake_instance_types(n_types)},
                       force_tensor=True)
        results = ts.solve(pods)
        assert ts.fallback_reason == ""
        assert results.new_nodeclaims
        digests.append(record.decision_digest(results, pods))
    assert digests[0] == digests[1]
