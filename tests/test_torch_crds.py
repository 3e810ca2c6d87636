"""The port's CRD generator (karpenter_tpu_torch/api/crds.py):
tests/test_crds.py's cases on the port, its manifests equal to the JAX
package's string for string, its checked-in YAML equal to its own output,
and ``python -m karpenter_tpu_torch.api.crds <dir>`` writing the same two
files."""

import os
import re
import subprocess
import sys
from pathlib import Path

import yaml

from karpenter_tpu.api import crds as jcrds
from karpenter_tpu_torch.api import crds

REPO = Path(__file__).resolve().parents[1]
HERE = REPO / "karpenter_tpu_torch" / "api" / "crds"


class TestManifests:
    def test_checked_in_files_match_generator(self):
        for name, content in crds.manifests().items():
            assert (HERE / name).read_text() == content, \
                f"{name} is stale; regenerate with python -m " \
                f"karpenter_tpu_torch.api.crds"

    def test_crd_structure(self):
        for crd in (crds.nodepool_crd(), crds.nodeclaim_crd()):
            assert crd["apiVersion"] == "apiextensions.k8s.io/v1"
            assert crd["spec"]["scope"] == "Cluster"
            v = crd["spec"]["versions"][0]
            assert v["name"] == "v1" and v["served"] and v["storage"]
            assert "status" in v["subresources"]
            schema = v["schema"]["openAPIV3Schema"]
            assert set(schema["properties"]) >= {"spec", "status", "metadata"}

    def test_yaml_round_trips(self):
        for name, content in crds.manifests().items():
            assert yaml.safe_load(content)["kind"] == \
                "CustomResourceDefinition"


class TestSchemaRules:
    """The schema mirrors api/validation.py's battery."""

    def _req_schema(self):
        spec = crds.nodeclaim_crd()["spec"]["versions"][0]["schema"][
            "openAPIV3Schema"]["properties"]["spec"]
        return spec["properties"]["requirements"]["items"]

    def test_operator_enum_matches_validation(self):
        assert self._req_schema()["properties"]["operator"]["enum"] == \
            ["In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt"]

    def test_cel_rules_cover_value_constraints(self):
        rules = {r["message"]
                 for r in self._req_schema()["x-kubernetes-validations"]}
        assert any("In requires values" in m for m in rules)
        assert any("forbids values" in m for m in rules)
        assert any("Gt/Lt" in m for m in rules)

    def test_budget_pattern(self):
        pool = crds.nodepool_crd()["spec"]["versions"][0]["schema"][
            "openAPIV3Schema"]["properties"]["spec"]
        pat = pool["properties"]["disruption"]["properties"]["budgets"][
            "items"]["properties"]["nodes"]["pattern"]
        for ok in ("0", "10", "100%", "30%", "0%"):
            assert re.fullmatch(pat, ok), ok
        for bad in ("101%", "-1", "ten", "10%%", ""):
            assert not re.fullmatch(pat, bad), bad

    def test_duration_pattern(self):
        pat = crds._duration_schema()["pattern"]
        for ok in ("10m", "1h30m", "90s", "Never"):
            assert re.fullmatch(pat, ok), ok
        for bad in ("10", "never", "1d", ""):
            assert not re.fullmatch(pat, bad), bad


def test_manifests_equal_the_reference():
    assert crds.manifests() == jcrds.manifests()
    assert crds.nodepool_crd() == jcrds.nodepool_crd()
    assert crds.nodeclaim_crd() == jcrds.nodeclaim_crd()


def test_checked_in_files_equal_the_reference_bytes():
    ref = REPO / "karpenter_tpu" / "api" / "crds"
    names = sorted(p.name for p in HERE.glob("*.yaml"))
    assert names == sorted(p.name for p in ref.glob("*.yaml")) == \
        sorted(crds.manifests())
    for name in names:
        assert (HERE / name).read_bytes() == (ref / name).read_bytes()


def test_module_entry_point_writes_the_files(tmp_path):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch.api.crds",
         str(tmp_path)], cwd=str(REPO), env=env, capture_output=True,
        text=True, timeout=120, check=True).stdout.split()
    assert sorted(out) == sorted(str(tmp_path / n) for n in crds.manifests())
    for name, content in crds.manifests().items():
        assert (tmp_path / name).read_text() == content
        assert (tmp_path / name).read_bytes() == (HERE / name).read_bytes()
