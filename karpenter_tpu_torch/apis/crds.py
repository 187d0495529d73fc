"""CRD schema artifacts — the pkg/apis/crds analogue.

Copy of `karpenter_tpu/apis/crds.py`.

The reference ships generated CRD YAML whose openAPIV3Schema carries
every admission rule: kubebuilder markers become patterns/enums/
bounds, and hack/validation/*.sh patches in the CEL rules. This
runtime has no API server to install CRDs into, but the SCHEMA is
still the contract users program against — so the same rule corpus
that `validation.py` enforces at admission is emitted here as a
schema artifact, generated from the SAME constants (single source:
drift between the enforced rules and the published schema is a test
failure, mirroring `make verify` codegen checks).

Artifacts live at karpenter_tpu_torch/apis/crds/karpenter.sh_{nodepools,
nodeclaims}.json; regenerate with `python -m karpenter_tpu_torch.apis.crds`.
"""

from __future__ import annotations

import json
import os

from karpenter_tpu_torch.apis.v1.validation import (
    MAX_BUDGETS,
    MAX_KEY_LENGTH,
    MAX_REQUIREMENTS,
    MAX_TEMPLATE_LABELS,
    MAX_VALUE_LENGTH,
    MAX_WEIGHT,
    VALID_BUDGET_REASONS,
    VALID_CONSOLIDATION_POLICIES,
    VALID_OPERATORS,
    VALID_TAINT_EFFECTS,
    _BUDGET_DURATION_RE,
    _BUDGET_NODES_RE,
    _BUDGET_SCHEDULE_RE,
    _DURATION_RE,
    _LABEL_VALUE_RE,
    _QUALIFIED_KEY_RE,
)

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "crds")


def _requirement_schema() -> dict:
    """NodeSelectorRequirementWithMinValues (nodeclaim.go:80-89 plus
    the hack/validation/requirements.sh patches)."""
    return {
        "type": "array",
        "maxItems": MAX_REQUIREMENTS,
        "x-kubernetes-validations": [
            {"message": "requirements with operator 'In' must have a value defined",
             "rule": "self.all(x, x.operator == 'In' ? x.values.size() != 0 : true)"},
            {"message": "requirements operator 'Gt' or 'Lt' must have a single positive integer value",
             "rule": "self.all(x, (x.operator == 'Gt' || x.operator == 'Lt') ? (x.values.size() == 1 && int(x.values[0]) >= 0) : true)"},
            {"message": "requirements with 'minValues' must have at least that many values specified in the 'values' field",
             "rule": "self.all(x, (x.operator == 'In' && has(x.minValues)) ? x.values.size() >= x.minValues : true)"},
        ],
        "items": {
            "type": "object",
            "required": ["key", "operator"],
            "properties": {
                "key": {
                    "type": "string",
                    "maxLength": MAX_KEY_LENGTH,
                    "pattern": _QUALIFIED_KEY_RE.pattern,
                },
                "operator": {
                    "type": "string",
                    "enum": sorted(VALID_OPERATORS),
                },
                "values": {
                    "type": "array",
                    "items": {
                        "type": "string",
                        "maxLength": MAX_VALUE_LENGTH,
                        "pattern": _LABEL_VALUE_RE.pattern,
                    },
                },
                "minValues": {
                    "type": "integer", "minimum": 1, "maximum": 50,
                },
            },
        },
    }


def _taints_schema() -> dict:
    return {
        "type": "array",
        "items": {
            "type": "object",
            "required": ["key", "effect"],
            "properties": {
                "key": {
                    "type": "string",
                    "minLength": 1,
                    "pattern": _QUALIFIED_KEY_RE.pattern,
                },
                "value": {
                    "type": "string",
                    "pattern": _LABEL_VALUE_RE.pattern,
                },
                "effect": {
                    "type": "string",
                    "enum": sorted(VALID_TAINT_EFFECTS),
                },
            },
        },
    }


def _claim_spec_properties() -> dict:
    return {
        "requirements": _requirement_schema(),
        "taints": _taints_schema(),
        "startupTaints": _taints_schema(),
        "expireAfter": {
            "type": "string",
            "pattern": rf"^({_DURATION_RE.pattern[1:-1]}|Never)$",
        },
        "terminationGracePeriod": {
            "type": "string",
            "pattern": _DURATION_RE.pattern,
        },
        "nodeClassRef": {
            "type": "object",
            "required": ["group", "kind", "name"],
            "properties": {
                "group": {"type": "string"},
                "kind": {"type": "string"},
                "name": {"type": "string"},
            },
        },
    }


def nodeclaim_schema() -> dict:
    return {
        "group": "karpenter.sh",
        "kind": "NodeClaim",
        "versions": ["v1"],
        "openAPIV3Schema": {
            "type": "object",
            "properties": {
                "spec": {
                    "type": "object",
                    "properties": _claim_spec_properties(),
                },
            },
        },
    }


def nodepool_schema() -> dict:
    return {
        "group": "karpenter.sh",
        "kind": "NodePool",
        "versions": ["v1"],
        "openAPIV3Schema": {
            "type": "object",
            "properties": {
                "spec": {
                    "type": "object",
                    # the transition rules address spec fields, so they
                    # hang on the SPEC schema where `self` resolves
                    # them (nodepool.go:39-41 places the markers on the
                    # spec struct for the same reason)
                    "x-kubernetes-validations": [
                        {"message": "Cannot transition NodePool between static (replicas set) and dynamic (replicas unset) provisioning modes",
                         "rule": "has(self.replicas) == has(oldSelf.replicas)"},
                        {"message": "only 'limits.nodes' is supported on static NodePools",
                         "rule": "!has(self.replicas) || (!has(self.limits) || size(self.limits) == 0 || (size(self.limits) == 1 && 'nodes' in self.limits))"},
                        {"message": "'weight' is not supported on static NodePools",
                         "rule": "!has(self.replicas) || !has(self.weight)"},
                    ],
                    "properties": {
                        "weight": {
                            # 0 plays the reference's nil (= unset);
                            # 1-100 is the reference's declared range
                            "type": "integer",
                            "minimum": 0,
                            "maximum": MAX_WEIGHT,
                        },
                        "replicas": {"type": "integer", "minimum": 0},
                        "limits": {
                            "type": "object",
                            "additionalProperties": {"type": "number"},
                        },
                        "disruption": {
                            "type": "object",
                            "properties": {
                                "consolidateAfter": {
                                    "type": "string",
                                    "pattern": rf"^({_DURATION_RE.pattern[1:-1]}|Never)$",
                                },
                                "consolidationPolicy": {
                                    "type": "string",
                                    "enum": sorted(VALID_CONSOLIDATION_POLICIES),
                                },
                                "budgets": {
                                    "type": "array",
                                    "maxItems": MAX_BUDGETS,
                                    "x-kubernetes-validations": [
                                        {"message": "'schedule' must be set with 'duration'",
                                         "rule": "self.all(x, has(x.schedule) == has(x.duration))"},
                                    ],
                                    "items": {
                                        "type": "object",
                                        "properties": {
                                            "nodes": {
                                                "type": "string",
                                                "pattern": _BUDGET_NODES_RE.pattern,
                                            },
                                            "schedule": {
                                                "type": "string",
                                                "pattern": _BUDGET_SCHEDULE_RE.pattern,
                                            },
                                            "duration": {
                                                "type": "string",
                                                "pattern": _BUDGET_DURATION_RE.pattern,
                                            },
                                            "reasons": {
                                                "type": "array",
                                                "items": {
                                                    "type": "string",
                                                    "enum": sorted(VALID_BUDGET_REASONS),
                                                },
                                            },
                                        },
                                    },
                                },
                            },
                        },
                        "template": {
                            "type": "object",
                            "properties": {
                                "metadata": {
                                    "type": "object",
                                    "properties": {
                                        "labels": {
                                            "type": "object",
                                            "maxProperties": MAX_TEMPLATE_LABELS,
                                            "additionalProperties": {
                                                "type": "string",
                                                "maxLength": MAX_VALUE_LENGTH,
                                                "pattern": _LABEL_VALUE_RE.pattern,
                                            },
                                        },
                                    },
                                },
                                "spec": {
                                    "type": "object",
                                    "properties": _claim_spec_properties(),
                                },
                            },
                        },
                    },
                },
            },
        },
    }


ARTIFACTS = {
    "karpenter.sh_nodepools.json": nodepool_schema,
    "karpenter.sh_nodeclaims.json": nodeclaim_schema,
}


def render() -> dict[str, str]:
    return {
        name: json.dumps(fn(), indent=2, sort_keys=True) + "\n"
        for name, fn in ARTIFACTS.items()
    }


def write(directory: str = ARTIFACT_DIR) -> None:
    os.makedirs(directory, exist_ok=True)
    for name, content in render().items():
        with open(os.path.join(directory, name), "w") as fh:
            fh.write(content)


if __name__ == "__main__":  # pragma: no cover
    write()
    print(f"wrote {len(ARTIFACTS)} artifacts to {ARTIFACT_DIR}")
