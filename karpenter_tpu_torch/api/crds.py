"""CRD manifest generation for the karpenter.sh API types.

The reference ships controller-gen-generated CustomResourceDefinitions
(karpenter's pkg/apis/crds/karpenter.sh_{nodepools,nodeclaims}.yaml)
with CEL validation rules. This module generates the equivalent manifests
from THIS package's API dataclasses (api/nodepool.py, api/nodeclaim.py) and
its validation battery (api/validation.py): the schema encodes the same
accept/reject rules the operator enforces at admission
(nodeclaim_validation.go semantics), so a real-apiserver deployment rejects
what the in-process store would.

Regenerate with:  python -m karpenter_tpu_torch.api.crds [output-dir]
A test pins the checked-in files to the generator's output.
"""

from __future__ import annotations

import os
from typing import Dict

GROUP = "karpenter.sh"
VERSION = "v1"

# nodeclaim_validation.go operator set; Gt/Lt take one non-negative integer
OPERATORS = ["In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt"]
QUALIFIED_NAME = r"^([a-z0-9]([-a-z0-9]*[a-z0-9])?(\.[a-z0-9]([-a-z0-9]*[a-z0-9])?)*\/)?([A-Za-z0-9][-A-Za-z0-9_.]*)?[A-Za-z0-9]$"
LABEL_VALUE = r"^(([A-Za-z0-9][-A-Za-z0-9_.]*)?[A-Za-z0-9])?$"


def _requirement_schema() -> dict:
    return {
        "type": "object",
        "required": ["key", "operator"],
        "properties": {
            "key": {"type": "string", "maxLength": 316,
                    "pattern": QUALIFIED_NAME},
            "operator": {"type": "string", "enum": OPERATORS},
            "values": {"type": "array", "maxItems": 50,
                       "items": {"type": "string", "maxLength": 63,
                                 "pattern": LABEL_VALUE}},
            "minValues": {"type": "integer", "minimum": 1, "maximum": 50},
        },
        # validation.py: In needs values; Exists/DoesNotExist forbid them;
        # Gt/Lt need exactly one non-negative integer
        "x-kubernetes-validations": [
            {"rule": "self.operator != 'In' || size(self.values) > 0",
             "message": "operator In requires values"},
            {"rule": "(self.operator != 'Exists' && "
                     "self.operator != 'DoesNotExist') || "
                     "!has(self.values) || size(self.values) == 0",
             "message": "operator Exists/DoesNotExist forbids values"},
            {"rule": "(self.operator != 'Gt' && self.operator != 'Lt') || "
                     "(has(self.values) && size(self.values) == 1 && "
                     "self.values.all(x, x.matches('^[0-9]+$')))",
             "message": "operator Gt/Lt requires a single positive integer"},
            {"rule": "!has(self.minValues) || self.operator != 'In' || "
                     "self.minValues <= size(self.values)",
             "message": "minValues cannot exceed the number of values"},
        ],
    }


def _taint_schema(require_effect: bool = True) -> dict:
    s = {
        "type": "object",
        "required": ["key"] + (["effect"] if require_effect else []),
        "properties": {
            "key": {"type": "string", "minLength": 1,
                    "pattern": QUALIFIED_NAME},
            "value": {"type": "string", "pattern": LABEL_VALUE},
            "effect": {"type": "string",
                       "enum": ["NoSchedule", "PreferNoSchedule",
                                "NoExecute"]},
        },
    }
    return s


def _resource_list_schema() -> dict:
    return {"type": "object",
            "additionalProperties": {
                "anyOf": [{"type": "integer"}, {"type": "string"}],
                "x-kubernetes-int-or-string": True}}


def _duration_schema() -> dict:
    # NillableDuration (api/duration.py): "10m", "1h30m", or "Never"
    return {"type": "string",
            "pattern": r"^(([0-9]+(s|m|h))+|Never)$"}


def _node_class_ref_schema() -> dict:
    return {
        "type": "object",
        "required": ["group", "kind", "name"],
        "properties": {
            "group": {"type": "string", "maxLength": 253},
            "kind": {"type": "string", "maxLength": 63},
            "name": {"type": "string", "maxLength": 253},
        },
    }


def _nodeclaim_spec_schema() -> dict:
    return {
        "type": "object",
        "properties": {
            "requirements": {"type": "array", "maxItems": 100,
                             "items": _requirement_schema()},
            "resources": {
                "type": "object",
                "properties": {"requests": _resource_list_schema()}},
            "taints": {"type": "array", "items": _taint_schema()},
            "startupTaints": {"type": "array", "items": _taint_schema()},
            "nodeClassRef": _node_class_ref_schema(),
            "expireAfter": _duration_schema(),
            "terminationGracePeriod": _duration_schema(),
        },
    }


def _budget_schema() -> dict:
    return {
        "type": "object",
        "required": ["nodes"],
        "properties": {
            # absolute count or percent (nodepool.go Budget.Nodes)
            "nodes": {"type": "string",
                      "pattern": r"^((100|[0-9]{1,2})%|[0-9]+)$"},
            "schedule": {"type": "string"},   # cron expression
            "duration": _duration_schema(),
            "reasons": {"type": "array",
                        "items": {"type": "string",
                                  "enum": ["Underutilized", "Empty",
                                           "Drifted"]}},
        },
    }


def _disruption_schema() -> dict:
    return {
        "type": "object",
        "properties": {
            "consolidateAfter": _duration_schema(),
            "consolidationPolicy": {
                "type": "string",
                "enum": ["WhenEmpty", "WhenEmptyOrUnderutilized"]},
            "budgets": {"type": "array", "maxItems": 50,
                        "items": _budget_schema()},
        },
    }


def _conditions_schema() -> dict:
    return {"type": "array", "items": {
        "type": "object",
        "required": ["type", "status"],
        "properties": {
            "type": {"type": "string"},
            "status": {"type": "string",
                       "enum": ["True", "False", "Unknown"]},
            "reason": {"type": "string"},
            "message": {"type": "string"},
            "lastTransitionTime": {"type": "string"},
        }}}


def _crd(kind: str, plural: str, spec_schema: dict, status_schema: dict,
         printer_columns: list) -> dict:
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{plural}.{GROUP}"},
        "spec": {
            "group": GROUP,
            "names": {"categories": ["karpenter"], "kind": kind,
                      "listKind": f"{kind}List", "plural": plural,
                      "singular": kind.lower()},
            "scope": "Cluster",
            "versions": [{
                "name": VERSION,
                "served": True,
                "storage": True,
                "subresources": {"status": {}},
                "additionalPrinterColumns": printer_columns,
                "schema": {"openAPIV3Schema": {
                    "type": "object",
                    "properties": {
                        "apiVersion": {"type": "string"},
                        "kind": {"type": "string"},
                        "metadata": {"type": "object"},
                        "spec": spec_schema,
                        "status": status_schema,
                    }}},
            }],
        },
    }


def nodepool_crd() -> dict:
    spec = {
        "type": "object",
        "required": ["template"],
        "properties": {
            "template": {
                "type": "object",
                "required": ["spec"],
                "properties": {
                    "metadata": {
                        "type": "object",
                        "properties": {
                            "labels": {"type": "object",
                                       "additionalProperties":
                                           {"type": "string"}},
                            "annotations": {"type": "object",
                                            "additionalProperties":
                                                {"type": "string"}}}},
                    "spec": _nodeclaim_spec_schema(),
                }},
            "disruption": _disruption_schema(),
            "limits": _resource_list_schema(),
            "weight": {"type": "integer", "minimum": 1, "maximum": 100},
        },
    }
    status = {
        "type": "object",
        "properties": {"resources": _resource_list_schema(),
                       "conditions": _conditions_schema()},
    }
    cols = [
        {"jsonPath": ".spec.template.spec.nodeClassRef.name",
         "name": "NodeClass", "type": "string"},
        {"jsonPath": ".status.resources.nodes", "name": "Nodes",
         "type": "string"},
        {"jsonPath": '.status.conditions[?(@.type=="Ready")].status',
         "name": "Ready", "type": "string"},
        {"jsonPath": ".metadata.creationTimestamp", "name": "Age",
         "type": "date"},
        {"jsonPath": ".spec.weight", "name": "Weight", "priority": 1,
         "type": "integer"},
    ]
    return _crd("NodePool", "nodepools", spec, status, cols)


def nodeclaim_crd() -> dict:
    status = {
        "type": "object",
        "properties": {
            "providerID": {"type": "string"},
            "nodeName": {"type": "string"},
            "imageID": {"type": "string"},
            "capacity": _resource_list_schema(),
            "allocatable": _resource_list_schema(),
            "conditions": _conditions_schema(),
            "lastPodEventTime": {"type": "string"},
        },
    }
    cols = [
        {"jsonPath": ".metadata.labels.node\\.kubernetes\\.io/instance-type",
         "name": "Type", "type": "string"},
        {"jsonPath": ".metadata.labels.karpenter\\.sh/capacity-type",
         "name": "Capacity", "type": "string"},
        {"jsonPath": ".metadata.labels.topology\\.kubernetes\\.io/zone",
         "name": "Zone", "type": "string"},
        {"jsonPath": ".status.nodeName", "name": "Node", "type": "string"},
        {"jsonPath": '.status.conditions[?(@.type=="Ready")].status',
         "name": "Ready", "type": "string"},
        {"jsonPath": ".metadata.creationTimestamp", "name": "Age",
         "type": "date"},
    ]
    return _crd("NodeClaim", "nodeclaims", _nodeclaim_spec_schema(), status,
                cols)


def manifests() -> Dict[str, str]:
    import yaml
    return {
        f"{GROUP}_nodepools.yaml": yaml.safe_dump(nodepool_crd(),
                                                  sort_keys=False),
        f"{GROUP}_nodeclaims.yaml": yaml.safe_dump(nodeclaim_crd(),
                                                   sort_keys=False),
    }


def write_manifests(directory: str) -> list:
    os.makedirs(directory, exist_ok=True)
    out = []
    for name, content in manifests().items():
        path = os.path.join(directory, name)
        with open(path, "w") as f:
            f.write(content)
        out.append(path)
    return out


if __name__ == "__main__":
    import sys
    target = sys.argv[1] if len(sys.argv) > 1 else \
        os.path.join(os.path.dirname(__file__), "crds")
    for p in write_manifests(target):
        print(p)
