"""Deployable manifests — the kwok/charts analogue.

Copy of `karpenter_tpu/deploy.py`, rendered from this package's own
sources, with PyYAML imported only where the manifests are rendered.

The reference ships a Helm chart (kwok/charts: deployment, RBAC,
service, PDB, CRDs) so a user can install the controller on a real
cluster. This module renders the equivalent static manifests for the
operator binary (`python -m karpenter_tpu_torch` takes the flags the
Deployment passes), generated from the SAME sources the runtime
enforces:

- `deploy/crds.yaml` — full CustomResourceDefinition objects whose
  openAPIV3Schema is the generated admission-rule corpus
  (apis/crds.py; drift from validation.py is a test failure),
- `deploy/karpenter.yaml` — namespace, service account, RBAC scoped
  to exactly the kinds the real client speaks (kube/real.py
  RESOURCES), the operator Deployment with /healthz//readyz probes
  and the Prometheus port, a Service, and a PodDisruptionBudget.

Regenerate with `python -m karpenter_tpu_torch.deploy`; tests assert
the checked-in files match the generator (the `make verify` codegen
pattern). Importing this module needs no PyYAML: `render()` and
`write()` import it, and without it raise an ImportError naming it.
"""

from __future__ import annotations

import os

from karpenter_tpu_torch.apis.crds import nodeclaim_schema, nodepool_schema

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPLOY_DIR = os.path.join(REPO_ROOT, "deploy")

NAMESPACE = "karpenter"
APP = "karpenter-tpu"


def _crd(group: str, plural: str, kind: str, schema: dict,
         version: str = "v1", served: bool = True) -> dict:
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{plural}.{group}"},
        "spec": {
            "group": group,
            "names": {
                "plural": plural,
                "singular": kind.lower(),
                "kind": kind,
                "categories": ["karpenter"],
            },
            "scope": "Cluster",
            "versions": [{
                "name": version,
                "served": served,
                "storage": True,
                # no status subresource: the real client writes status
                # through the main resource (kube/real.py PUT); with the
                # subresource enabled a real API server would silently
                # strip status from those writes
                "schema": {"openAPIV3Schema": schema["openAPIV3Schema"]},
            }],
        },
    }


def _overlay_schema() -> dict:
    """NodeOverlay v1alpha1 schema from the runtime-validation rules
    (apis/v1alpha1/nodeoverlay.py runtime_validate)."""
    from karpenter_tpu_torch.apis.v1alpha1.nodeoverlay import _VALID_OPERATORS

    return {
        "group": "karpenter.sh",
        "kind": "NodeOverlay",
        "openAPIV3Schema": {
            "type": "object",
            "properties": {
                "spec": {
                    "type": "object",
                    "properties": {
                        "requirements": {
                            "type": "array",
                            "items": {
                                "type": "object",
                                "required": ["key", "operator"],
                                "properties": {
                                    "key": {"type": "string"},
                                    "operator": {
                                        "type": "string",
                                        "enum": sorted(_VALID_OPERATORS),
                                    },
                                    "values": {
                                        "type": "array",
                                        "items": {"type": "string"},
                                    },
                                },
                            },
                        },
                        "priceAdjustment": {
                            "type": "string",
                            "pattern": r"^[+-]?\d+(\.\d+)?%?$",
                        },
                        "price": {
                            "type": "string",
                            "pattern": r"^\d+(\.\d+)?$",
                        },
                        "capacity": {
                            "type": "object",
                            "additionalProperties": {
                                "anyOf": [{"type": "integer"},
                                          {"type": "string"}],
                            },
                        },
                        "weight": {
                            "type": "integer", "minimum": 0, "maximum": 100,
                        },
                    },
                },
                "status": {
                    "type": "object",
                    "properties": {
                        "conditions": {"type": "array",
                                       "items": {"type": "object",
                                                 "x-kubernetes-preserve-unknown-fields": True}},
                    },
                },
            },
        },
    }


def crds() -> list[dict]:
    return [
        _crd("karpenter.sh", "nodepools", "NodePool", nodepool_schema()),
        _crd("karpenter.sh", "nodeclaims", "NodeClaim", nodeclaim_schema()),
        _crd("karpenter.sh", "nodeoverlays", "NodeOverlay",
             _overlay_schema(), version="v1alpha1"),
    ]


def _rbac_rules() -> list[dict]:
    """Scoped to the kinds the real client speaks (kube/real.py
    RESOURCES) — read everywhere, write where the controllers write."""
    return [
        {"apiGroups": ["karpenter.sh"],
         # no */status entries: the generated CRDs deliberately omit
         # the status subresource (see _crd comment above), so those
         # RBAC resources would name nothing
         "resources": ["nodepools", "nodeclaims", "nodeoverlays"],
         "verbs": ["get", "list", "watch", "create", "update", "patch",
                   "delete"]},
        {"apiGroups": [""],
         "resources": ["nodes", "pods", "persistentvolumeclaims",
                       "persistentvolumes"],
         # create: kwok-style providers register Node objects and the
         # eviction queue recreates successor pods
         "verbs": ["get", "list", "watch", "create", "update", "patch",
                   "delete"]},
        {"apiGroups": [""],
         "resources": ["pods/binding", "pods/eviction"],
         "verbs": ["create"]},
        # update: the recorder bumps count/lastTimestamp on deduped
        # Events via PUT (the reference's record.EventRecorder patches)
        {"apiGroups": [""], "resources": ["events"],
         "verbs": ["create", "patch", "update"]},
        {"apiGroups": ["apps"], "resources": ["daemonsets"],
         "verbs": ["get", "list", "watch"]},
        {"apiGroups": ["policy"], "resources": ["poddisruptionbudgets"],
         "verbs": ["get", "list", "watch"]},
        {"apiGroups": ["storage.k8s.io"],
         "resources": ["storageclasses", "csinodes"],
         "verbs": ["get", "list", "watch"]},
        {"apiGroups": ["coordination.k8s.io"], "resources": ["leases"],
         "verbs": ["get", "list", "watch", "create", "update", "patch"]},
    ]


def operator_manifests(image: str = "karpenter-tpu:latest") -> list[dict]:
    labels = {"app.kubernetes.io/name": APP}
    return [
        {"apiVersion": "v1", "kind": "Namespace",
         "metadata": {"name": NAMESPACE}},
        {"apiVersion": "v1", "kind": "ServiceAccount",
         "metadata": {"name": APP, "namespace": NAMESPACE}},
        {"apiVersion": "rbac.authorization.k8s.io/v1", "kind": "ClusterRole",
         "metadata": {"name": APP}, "rules": _rbac_rules()},
        {"apiVersion": "rbac.authorization.k8s.io/v1",
         "kind": "ClusterRoleBinding",
         "metadata": {"name": APP},
         "roleRef": {"apiGroup": "rbac.authorization.k8s.io",
                     "kind": "ClusterRole", "name": APP},
         "subjects": [{"kind": "ServiceAccount", "name": APP,
                       "namespace": NAMESPACE}]},
        {"apiVersion": "apps/v1", "kind": "Deployment",
         "metadata": {"name": APP, "namespace": NAMESPACE,
                      "labels": labels},
         "spec": {
             "replicas": 2,  # active/passive via leader election
             "selector": {"matchLabels": labels},
             "template": {
                 "metadata": {"labels": labels},
                 "spec": {
                     "serviceAccountName": APP,
                     "containers": [{
                         "name": "controller",
                         "image": image,
                         "args": [
                             "--api-server",
                             "https://kubernetes.default.svc",
                             "--api-token-file",
                             "/var/run/secrets/kubernetes.io/"
                             "serviceaccount/token",  # re-read on expiry
                             "--api-ca-file",
                             "/var/run/secrets/kubernetes.io/"
                             "serviceaccount/ca.crt",
                             "--leader-elect",
                             "--metrics-port", "8080",
                         ],
                         "ports": [{"name": "http-metrics",
                                    "containerPort": 8080}],
                         "livenessProbe": {
                             "httpGet": {"path": "/healthz", "port": 8080},
                             "initialDelaySeconds": 10,
                         },
                         "readinessProbe": {
                             "httpGet": {"path": "/readyz", "port": 8080},
                         },
                         "env": [{
                             "name": "HOSTNAME",
                             "valueFrom": {"fieldRef": {
                                 "fieldPath": "metadata.name"}},
                         }],
                         "resources": {
                             "requests": {"cpu": "1", "memory": "1Gi"},
                         },
                     }],
                 },
             },
         }},
        {"apiVersion": "v1", "kind": "Service",
         "metadata": {"name": APP, "namespace": NAMESPACE,
                      "labels": labels},
         "spec": {"selector": labels,
                  "ports": [{"name": "http-metrics", "port": 8080,
                             "targetPort": 8080}]}},
        {"apiVersion": "policy/v1", "kind": "PodDisruptionBudget",
         "metadata": {"name": APP, "namespace": NAMESPACE},
         "spec": {"maxUnavailable": 1,
                  "selector": {"matchLabels": labels}}},
    ]


def _yaml():
    try:
        import yaml
    except ImportError as err:
        raise ImportError(
            "karpenter_tpu_torch.deploy renders its manifests with PyYAML "
            "(the `yaml` module), which is not installed") from err
    return yaml


def render() -> dict[str, str]:
    yaml = _yaml()
    return {
        "crds.yaml": yaml.safe_dump_all(crds(), sort_keys=True),
        "karpenter.yaml": yaml.safe_dump_all(
            operator_manifests(), sort_keys=True
        ),
    }


def write(directory: str = DEPLOY_DIR) -> None:
    os.makedirs(directory, exist_ok=True)
    for name, content in render().items():
        with open(os.path.join(directory, name), "w") as fh:
            fh.write(content)


if __name__ == "__main__":  # pragma: no cover
    write()
    print(f"wrote deploy manifests to {DEPLOY_DIR}")
