"""CR dict codecs: typed objects <-> real Kubernetes resource dicts.

Copy of `karpenter_tpu/kube/serialize.py`.

The in-memory store works on typed dataclasses; a real API server
speaks JSON resources shaped by the CRD schemas this repo generates
(apis/crds/*.json, mirroring pkg/apis/crds/*.yaml). This module is the
boundary: `to_cr` renders a typed object as the dict a real cluster
would accept (camelCase keys, RFC3339 timestamps, k8s quantity
strings), `from_cr` parses a watch/get payload back into the typed
object. Round-trip fidelity is tested field-for-field
(tests/test_real_client.py) and the rendered CRs are checked against
the generated openAPIV3Schema artifacts.

Covered kinds (the TO_CR/FROM_CR registries below are the source of
truth): NodePool, NodeClaim, NodeOverlay (the CRDs); Pod and Node
(requests, affinity, topology spread, tolerations, volumes, taints,
conditions, ownerReferences); DaemonSet, PodDisruptionBudget,
PersistentVolumeClaim, PriorityClass (read-side controller inputs);
Lease (leader election); and Event (write-side recorder output).
"""

from __future__ import annotations

import calendar
import time
from typing import Optional

from karpenter_tpu_torch.apis.v1.condition import Condition, ConditionSet
from karpenter_tpu_torch.apis.v1.nodeclaim import (
    NodeClaim,
    NodeClaimSpec,
    NodeClaimStatus,
    NodeClassRef,
    RequirementSpec,
)
from karpenter_tpu_torch.apis.v1.nodepool import (
    Budget,
    Disruption,
    NodeClaimTemplate,
    NodePool,
    NodePoolSpec,
    NodePoolStatus,
)
from karpenter_tpu_torch.apis.v1alpha1.nodeoverlay import NodeOverlay, NodeOverlaySpec
from karpenter_tpu_torch.kube.objects import (
    Affinity,
    Container,
    LabelSelector,
    LabelSelectorRequirement,
    Node,
    NodeAffinity,
    NodeCondition,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PodSpec,
    PodStatus,
    PodVolume,
    PreferredSchedulingTerm,
    Taint,
    Toleration,
    TopologySpreadConstraint,
    WeightedPodAffinityTerm,
)
from karpenter_tpu_torch.utils.quantity import format_quantity, parse_quantity

GROUP_V1 = "karpenter.sh/v1"
GROUP_V1ALPHA1 = "karpenter.sh/v1alpha1"


# ---------------------------------------------------------------- scalars


def ts_to_rfc3339(ts: Optional[float]) -> Optional[str]:
    if ts is None:
        return None
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts))


def ts_from_rfc3339(value) -> Optional[float]:
    if value in (None, ""):
        return None
    if isinstance(value, (int, float)):
        return float(value)
    # metav1.MicroTime (Lease renewTime, Event eventTime) carries
    # fractional seconds: "2026-07-30T12:00:00.123456Z".
    base, frac = value, 0.0
    if "." in value:
        head, tail = value.split(".", 1)
        digits = tail.rstrip("Zz")
        base = head + "Z"
        if digits:
            frac = float("0." + digits)
    return float(calendar.timegm(time.strptime(base, "%Y-%m-%dT%H:%M:%SZ"))) + frac


def _resources_to_cr(resources: dict) -> dict:
    return {k: format_quantity(v) for k, v in resources.items()}


def _resources_from_cr(resources: Optional[dict]) -> dict:
    return {k: parse_quantity(v) for k, v in (resources or {}).items()}


def _drop_none(d: dict) -> dict:
    return {k: v for k, v in d.items() if v not in (None, "", [], {}, ())}


# ---------------------------------------------------------------- metadata


def meta_to_cr(meta: ObjectMeta, namespaced: bool = False) -> dict:
    out = {
        "name": meta.name,
        "uid": meta.uid,
        "labels": dict(meta.labels),
        "annotations": dict(meta.annotations),
        "finalizers": list(meta.finalizers),
        "creationTimestamp": ts_to_rfc3339(meta.creation_timestamp),
        "deletionTimestamp": ts_to_rfc3339(meta.deletion_timestamp),
        # resourceVersion is an opaque STRING on the wire
        "resourceVersion": str(meta.resource_version),
        "generation": meta.generation,
        # controller ownership drives drain semantics (DaemonSet
        # detection, rebirth gating) — losing it on the wire would
        # make every real-cluster pod look bare
        "ownerReferences": [
            _drop_none({
                "apiVersion": ref.api_version,
                "kind": ref.kind, "name": ref.name, "uid": ref.uid,
                "controller": ref.controller or None,
            })
            for ref in meta.owner_references
        ] or None,
    }
    if namespaced:
        out["namespace"] = meta.namespace
    return _drop_none(out)


def meta_from_cr(cr: dict) -> ObjectMeta:
    meta = cr.get("metadata", {})
    return ObjectMeta(
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        uid=meta.get("uid", ""),
        labels=dict(meta.get("labels", {})),
        annotations=dict(meta.get("annotations", {})),
        finalizers=list(meta.get("finalizers", [])),
        creation_timestamp=ts_from_rfc3339(meta.get("creationTimestamp"))
        or 0.0,
        deletion_timestamp=ts_from_rfc3339(meta.get("deletionTimestamp")),
        resource_version=int(meta.get("resourceVersion", "0") or 0),
        generation=int(meta.get("generation", 0)),
        owner_references=[
            OwnerReference(
                kind=ref.get("kind", ""), name=ref.get("name", ""),
                uid=ref.get("uid", ""),
                controller=bool(ref.get("controller", False)),
                api_version=ref.get("apiVersion", "apps/v1"),
            )
            for ref in meta.get("ownerReferences", [])
        ],
    )


# ---------------------------------------------------------------- shared


def _taints_to_cr(taints) -> list[dict]:
    return [
        _drop_none({"key": t.key, "value": t.value, "effect": t.effect})
        for t in taints
    ]


def _taints_from_cr(items) -> list[Taint]:
    return [
        Taint(key=t["key"], value=t.get("value", ""),
              effect=t.get("effect", "NoSchedule"))
        for t in (items or [])
    ]


def _conditions_to_cr(conditions: ConditionSet) -> list[dict]:
    return [
        _drop_none({
            "type": c.type,
            "status": c.status,
            "reason": c.reason,
            "message": c.message,
            "lastTransitionTime": ts_to_rfc3339(c.last_transition_time),
            "observedGeneration": c.observed_generation or None,
        })
        for c in conditions.conditions
    ]


def _conditions_from_cr(items, root_types: list[str]) -> ConditionSet:
    out = ConditionSet(root_types=list(root_types))
    for c in items or []:
        out.conditions.append(Condition(
            type=c["type"],
            status=c.get("status", "Unknown"),
            reason=c.get("reason", ""),
            message=c.get("message", ""),
            last_transition_time=ts_from_rfc3339(
                c.get("lastTransitionTime")) or 0.0,
            observed_generation=int(c.get("observedGeneration", 0)),
        ))
    return out


def _requirements_to_cr(reqs: list[RequirementSpec]) -> list[dict]:
    return [
        _drop_none({
            "key": r.key,
            "operator": r.operator,
            "values": list(r.values),
            "minValues": r.min_values,
        })
        for r in reqs
    ]


def _requirements_from_cr(items) -> list[RequirementSpec]:
    return [
        RequirementSpec(
            key=r["key"],
            operator=r["operator"],
            values=tuple(r.get("values", [])),
            min_values=r.get("minValues"),
        )
        for r in (items or [])
    ]


def _claim_spec_to_cr(spec: NodeClaimSpec) -> dict:
    out = {
        "requirements": _requirements_to_cr(spec.requirements),
        "resources": (
            {"requests": _resources_to_cr(spec.resources)}
            if spec.resources else None
        ),
        "taints": _taints_to_cr(spec.taints),
        "startupTaints": _taints_to_cr(spec.startup_taints),
        "expireAfter": spec.expire_after,
        "terminationGracePeriod": spec.termination_grace_period,
    }
    if spec.node_class_ref is not None:
        out["nodeClassRef"] = {
            "group": spec.node_class_ref.group,
            "kind": spec.node_class_ref.kind,
            "name": spec.node_class_ref.name,
        }
    return _drop_none(out)


def _claim_spec_from_cr(spec: dict) -> NodeClaimSpec:
    ref = spec.get("nodeClassRef")
    return NodeClaimSpec(
        requirements=_requirements_from_cr(spec.get("requirements")),
        resources=_resources_from_cr(
            (spec.get("resources") or {}).get("requests")
        ),
        taints=_taints_from_cr(spec.get("taints")),
        startup_taints=_taints_from_cr(spec.get("startupTaints")),
        node_class_ref=(
            NodeClassRef(group=ref.get("group", ""), kind=ref.get("kind", ""),
                         name=ref.get("name", ""))
            if ref else None
        ),
        expire_after=spec.get("expireAfter"),
        termination_grace_period=spec.get("terminationGracePeriod"),
    )


# ---------------------------------------------------------------- NodeClaim


def nodeclaim_to_cr(claim: NodeClaim) -> dict:
    return {
        "apiVersion": GROUP_V1,
        "kind": "NodeClaim",
        "metadata": meta_to_cr(claim.metadata),
        "spec": _claim_spec_to_cr(claim.spec),
        "status": _drop_none({
            "providerID": claim.status.provider_id,
            "imageID": claim.status.image_id,
            "nodeName": claim.status.node_name,
            "capacity": _resources_to_cr(claim.status.capacity),
            "allocatable": _resources_to_cr(claim.status.allocatable),
            "lastPodEventTime": ts_to_rfc3339(
                claim.status.last_pod_event_time
            ),
            "conditions": _conditions_to_cr(claim.status_conditions),
        }),
    }


def nodeclaim_from_cr(cr: dict) -> NodeClaim:
    from karpenter_tpu_torch.apis.v1.nodeclaim import LIFECYCLE_ROOT_CONDITIONS

    status = cr.get("status", {})
    return NodeClaim(
        metadata=meta_from_cr(cr),
        spec=_claim_spec_from_cr(cr.get("spec", {})),
        status=NodeClaimStatus(
            provider_id=status.get("providerID", ""),
            image_id=status.get("imageID", ""),
            node_name=status.get("nodeName", ""),
            capacity=_resources_from_cr(status.get("capacity")),
            allocatable=_resources_from_cr(status.get("allocatable")),
            last_pod_event_time=ts_from_rfc3339(
                status.get("lastPodEventTime")
            ),
        ),
        status_conditions=_conditions_from_cr(
            status.get("conditions"), LIFECYCLE_ROOT_CONDITIONS
        ),
    )


# ---------------------------------------------------------------- NodePool


def nodepool_to_cr(pool: NodePool) -> dict:
    disruption = pool.spec.disruption
    return {
        "apiVersion": GROUP_V1,
        "kind": "NodePool",
        "metadata": meta_to_cr(pool.metadata),
        "spec": _drop_none({
            "template": _drop_none({
                "metadata": _drop_none({
                    "labels": dict(pool.spec.template.labels),
                    "annotations": dict(pool.spec.template.annotations),
                }),
                "spec": _claim_spec_to_cr(pool.spec.template.spec),
            }),
            "disruption": _drop_none({
                "consolidateAfter": disruption.consolidate_after,
                "consolidationPolicy": disruption.consolidation_policy,
                "budgets": [
                    _drop_none({
                        "nodes": b.nodes,
                        "schedule": b.schedule,
                        "duration": b.duration,
                        "reasons": b.reasons,
                    })
                    for b in disruption.budgets
                ],
            }),
            "limits": _resources_to_cr(pool.spec.limits),
            "weight": pool.spec.weight or None,
            "replicas": pool.spec.replicas,
        }),
        "status": _drop_none({
            "resources": _resources_to_cr(pool.status.resources),
            "nodes": pool.status.nodes or None,
            "conditions": _conditions_to_cr(pool.status_conditions),
        }),
    }


def nodepool_from_cr(cr: dict) -> NodePool:
    from karpenter_tpu_torch.apis.v1.nodepool import (
        COND_NODE_CLASS_READY,
        COND_VALIDATION_SUCCEEDED,
    )

    spec = cr.get("spec", {})
    template = spec.get("template", {})
    disruption = spec.get("disruption", {})
    status = cr.get("status", {})
    return NodePool(
        metadata=meta_from_cr(cr),
        spec=NodePoolSpec(
            template=NodeClaimTemplate(
                labels=dict((template.get("metadata") or {}).get("labels", {})),
                annotations=dict(
                    (template.get("metadata") or {}).get("annotations", {})
                ),
                spec=_claim_spec_from_cr(template.get("spec", {})),
            ),
            disruption=Disruption(
                consolidate_after=disruption.get("consolidateAfter", "0s"),
                consolidation_policy=disruption.get(
                    "consolidationPolicy", "WhenEmptyOrUnderutilized"
                ),
                budgets=[
                    Budget(
                        nodes=b.get("nodes", "10%"),
                        schedule=b.get("schedule"),
                        duration=b.get("duration"),
                        reasons=b.get("reasons"),
                    )
                    for b in disruption.get("budgets", [])
                ],
            ),
            limits=_resources_from_cr(spec.get("limits")),
            weight=int(spec.get("weight", 0)),
            replicas=spec.get("replicas"),
        ),
        status=NodePoolStatus(
            resources=_resources_from_cr(status.get("resources")),
            nodes=int(status.get("nodes", 0)),
        ),
        status_conditions=_conditions_from_cr(
            status.get("conditions"),
            [COND_VALIDATION_SUCCEEDED, COND_NODE_CLASS_READY],
        ),
    )


# ---------------------------------------------------------------- NodeOverlay


def nodeoverlay_to_cr(overlay: NodeOverlay) -> dict:
    return {
        "apiVersion": GROUP_V1ALPHA1,
        "kind": "NodeOverlay",
        "metadata": meta_to_cr(overlay.metadata),
        "spec": _drop_none({
            "requirements": [
                _drop_none({
                    "key": r.key,
                    "operator": r.operator,
                    "values": list(r.values),
                })
                for r in overlay.spec.requirements
            ],
            "priceAdjustment": overlay.spec.price_adjustment,
            "price": overlay.spec.price,
            "capacity": _resources_to_cr(overlay.spec.capacity),
            "weight": overlay.spec.weight or None,
        }),
        "status": _drop_none({
            "conditions": _conditions_to_cr(overlay.status_conditions),
        }),
    }


def nodeoverlay_from_cr(cr: dict) -> NodeOverlay:
    from karpenter_tpu_torch.apis.v1alpha1.nodeoverlay import COND_OVERLAY_VALIDATION

    spec = cr.get("spec", {})
    return NodeOverlay(
        metadata=meta_from_cr(cr),
        spec=NodeOverlaySpec(
            requirements=[
                NodeSelectorRequirement(
                    key=r["key"], operator=r["operator"],
                    values=tuple(r.get("values", [])),
                )
                for r in spec.get("requirements", [])
            ],
            price_adjustment=spec.get("priceAdjustment"),
            price=spec.get("price"),
            capacity=_resources_from_cr(spec.get("capacity")),
            weight=int(spec.get("weight", 0)),
        ),
        status_conditions=_conditions_from_cr(
            (cr.get("status") or {}).get("conditions"),
            [COND_OVERLAY_VALIDATION],
        ),
    )


# ---------------------------------------------------------------- Pod


def _label_selector_to_cr(sel: LabelSelector) -> dict:
    return _drop_none({
        "matchLabels": dict(sel.match_labels),
        "matchExpressions": [
            _drop_none({"key": e.key, "operator": e.operator,
                        "values": list(e.values)})
            for e in sel.match_expressions
        ],
    })


def _label_selector_from_cr(sel: Optional[dict]) -> LabelSelector:
    sel = sel or {}
    return LabelSelector.of(
        labels=sel.get("matchLabels", {}),
        expressions=[
            LabelSelectorRequirement(
                key=e["key"], operator=e["operator"],
                values=tuple(e.get("values", [])),
            )
            for e in sel.get("matchExpressions", [])
        ],
    )


def _node_term_to_cr(term: NodeSelectorTerm) -> dict:
    return {
        "matchExpressions": [
            _drop_none({"key": e.key, "operator": e.operator,
                        "values": list(e.values)})
            for e in term.match_expressions
        ]
    }


def _node_term_from_cr(term: dict) -> NodeSelectorTerm:
    return NodeSelectorTerm(match_expressions=tuple(
        NodeSelectorRequirement(
            key=e["key"], operator=e["operator"],
            values=tuple(e.get("values", [])),
        )
        for e in term.get("matchExpressions", [])
    ))


def _pod_term_to_cr(term: PodAffinityTerm) -> dict:
    return _drop_none({
        "labelSelector": _label_selector_to_cr(term.label_selector),
        "topologyKey": term.topology_key,
        "namespaces": list(term.namespaces),
    })


def _pod_term_from_cr(term: dict) -> PodAffinityTerm:
    return PodAffinityTerm(
        label_selector=_label_selector_from_cr(term.get("labelSelector")),
        topology_key=term.get("topologyKey", ""),
        namespaces=tuple(term.get("namespaces", [])),
    )


def _affinity_to_cr(affinity: Affinity) -> dict:
    out: dict = {}
    if affinity.node_affinity is not None:
        na = affinity.node_affinity
        out["nodeAffinity"] = _drop_none({
            "requiredDuringSchedulingIgnoredDuringExecution": (
                {"nodeSelectorTerms": [_node_term_to_cr(t) for t in na.required]}
                if na.required else None
            ),
            "preferredDuringSchedulingIgnoredDuringExecution": [
                {"weight": p.weight, "preference": _node_term_to_cr(p.preference)}
                for p in na.preferred
            ],
        })
    for attr, key in (("pod_affinity", "podAffinity"),
                      ("pod_anti_affinity", "podAntiAffinity")):
        pa = getattr(affinity, attr)
        if pa is not None:
            out[key] = _drop_none({
                "requiredDuringSchedulingIgnoredDuringExecution": [
                    _pod_term_to_cr(t) for t in pa.required
                ],
                "preferredDuringSchedulingIgnoredDuringExecution": [
                    {"weight": w.weight,
                     "podAffinityTerm": _pod_term_to_cr(w.pod_affinity_term)}
                    for w in pa.preferred
                ],
            })
    return out


def _affinity_from_cr(cr: Optional[dict]) -> Optional[Affinity]:
    if not cr:
        return None
    node_affinity = None
    na = cr.get("nodeAffinity")
    if na:
        required = (
            na.get("requiredDuringSchedulingIgnoredDuringExecution") or {}
        ).get("nodeSelectorTerms", [])
        preferred = na.get(
            "preferredDuringSchedulingIgnoredDuringExecution", []
        )
        node_affinity = NodeAffinity(
            required=tuple(_node_term_from_cr(t) for t in required),
            preferred=tuple(
                PreferredSchedulingTerm(
                    weight=p.get("weight", 1),
                    preference=_node_term_from_cr(p.get("preference", {})),
                )
                for p in preferred
            ),
        )

    def pod_aff(key):
        pa = cr.get(key)
        if not pa:
            return None
        return PodAffinity(
            required=tuple(
                _pod_term_from_cr(t)
                for t in pa.get(
                    "requiredDuringSchedulingIgnoredDuringExecution", []
                )
            ),
            preferred=tuple(
                WeightedPodAffinityTerm(
                    weight=w.get("weight", 1),
                    pod_affinity_term=_pod_term_from_cr(
                        w.get("podAffinityTerm", {})
                    ),
                )
                for w in pa.get(
                    "preferredDuringSchedulingIgnoredDuringExecution", []
                )
            ),
        )

    if node_affinity is None and pod_aff("podAffinity") is None and pod_aff(
        "podAntiAffinity"
    ) is None:
        return None
    return Affinity(
        node_affinity=node_affinity,
        pod_affinity=pod_aff("podAffinity"),
        pod_anti_affinity=pod_aff("podAntiAffinity"),
    )


def _container_to_cr(c: Container) -> dict:
    return _drop_none({
        "name": c.name,
        "resources": (
            {"requests": _resources_to_cr(c.requests)} if c.requests else None
        ),
        "ports": [{"hostPort": p} for p in c.ports] or None,
        "restartPolicy": c.restart_policy,
    })


def _container_from_cr(c: dict) -> Container:
    return Container(
        name=c.get("name", "main"),
        requests=_resources_from_cr(
            (c.get("resources") or {}).get("requests")
        ),
        ports=[p["hostPort"] for p in c.get("ports", []) if "hostPort" in p],
        restart_policy=c.get("restartPolicy"),
    )


def pod_to_cr(pod: Pod) -> dict:
    spec = pod.spec
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": meta_to_cr(pod.metadata, namespaced=True),
        "spec": _drop_none({
            "nodeSelector": dict(spec.node_selector),
            "affinity": _affinity_to_cr(spec.affinity) if spec.affinity else None,
            "tolerations": [
                _drop_none({
                    "key": t.key, "operator": t.operator, "value": t.value,
                    "effect": t.effect,
                    "tolerationSeconds": t.toleration_seconds,
                })
                for t in spec.tolerations
            ],
            "topologySpreadConstraints": [
                _drop_none({
                    "maxSkew": t.max_skew,
                    "topologyKey": t.topology_key,
                    "whenUnsatisfiable": t.when_unsatisfiable,
                    "labelSelector": _label_selector_to_cr(t.label_selector),
                    "minDomains": t.min_domains,
                    "nodeAffinityPolicy": t.node_affinity_policy,
                    "nodeTaintsPolicy": t.node_taints_policy,
                })
                for t in spec.topology_spread_constraints
            ],
            "containers": [_container_to_cr(c) for c in spec.containers],
            "initContainers": [
                _container_to_cr(c) for c in spec.init_containers
            ],
            "overhead": _resources_to_cr(spec.overhead),
            "volumes": [
                _drop_none({
                    "name": v.name,
                    "persistentVolumeClaim": (
                        {"claimName": v.pvc_name} if v.pvc_name else None
                    ),
                    "ephemeral": {} if v.ephemeral else None,
                })
                for v in spec.volumes
            ],
            "nodeName": spec.node_name,
            "priority": spec.priority or None,
            "priorityClassName": spec.priority_class_name,
            "schedulerName": spec.scheduler_name,
            "terminationGracePeriodSeconds": spec.termination_grace_period_seconds,
            "restartPolicy": spec.restart_policy,
        }),
        "status": _drop_none({
            "phase": pod.status.phase,
            "startTime": ts_to_rfc3339(pod.status.start_time),
            "nominatedNodeName": pod.status.nominated_node_name,
        }),
    }


def pod_from_cr(cr: dict) -> Pod:
    spec = cr.get("spec", {})
    status = cr.get("status", {})
    return Pod(
        metadata=meta_from_cr(cr),
        spec=PodSpec(
            node_selector=dict(spec.get("nodeSelector", {})),
            affinity=_affinity_from_cr(spec.get("affinity")),
            tolerations=[
                Toleration(
                    key=t.get("key", ""),
                    operator=t.get("operator", "Equal"),
                    value=t.get("value", ""),
                    effect=t.get("effect", ""),
                    toleration_seconds=t.get("tolerationSeconds"),
                )
                for t in spec.get("tolerations", [])
            ],
            topology_spread_constraints=[
                TopologySpreadConstraint(
                    max_skew=t.get("maxSkew", 1),
                    topology_key=t.get("topologyKey", ""),
                    when_unsatisfiable=t.get(
                        "whenUnsatisfiable", "DoNotSchedule"
                    ),
                    label_selector=_label_selector_from_cr(
                        t.get("labelSelector")
                    ),
                    min_domains=t.get("minDomains"),
                    node_affinity_policy=t.get("nodeAffinityPolicy", "Honor"),
                    node_taints_policy=t.get("nodeTaintsPolicy", "Ignore"),
                )
                for t in spec.get("topologySpreadConstraints", [])
            ],
            containers=[
                _container_from_cr(c) for c in spec.get("containers", [])
            ],
            init_containers=[
                _container_from_cr(c) for c in spec.get("initContainers", [])
            ],
            overhead=_resources_from_cr(spec.get("overhead")),
            volumes=[
                PodVolume(
                    name=v.get("name", ""),
                    pvc_name=(
                        (v.get("persistentVolumeClaim") or {}).get("claimName")
                    ),
                    ephemeral="ephemeral" in v,
                )
                for v in spec.get("volumes", [])
            ],
            node_name=spec.get("nodeName", ""),
            priority=int(spec.get("priority", 0)),
            priority_class_name=spec.get("priorityClassName", ""),
            scheduler_name=spec.get("schedulerName", "default-scheduler"),
            termination_grace_period_seconds=spec.get(
                "terminationGracePeriodSeconds", 30
            ),
            restart_policy=spec.get("restartPolicy", "Always"),
        ),
        status=PodStatus(
            phase=status.get("phase", "Pending"),
            start_time=ts_from_rfc3339(status.get("startTime")),
            nominated_node_name=status.get("nominatedNodeName", ""),
        ),
    )


# ---------------------------------------------------------------- Node


def node_to_cr(node: Node) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": meta_to_cr(node.metadata),
        "spec": _drop_none({
            "taints": _taints_to_cr(node.spec.taints),
            "unschedulable": node.spec.unschedulable or None,
            "providerID": node.spec.provider_id,
        }),
        "status": _drop_none({
            "capacity": _resources_to_cr(node.status.capacity),
            "allocatable": _resources_to_cr(node.status.allocatable),
            "conditions": [
                _drop_none({
                    "type": c.type,
                    "status": c.status,
                    "reason": c.reason,
                    "lastTransitionTime": ts_to_rfc3339(
                        c.last_transition_time
                    ),
                })
                for c in node.status.conditions
            ],
        }),
    }


def node_from_cr(cr: dict) -> Node:
    spec = cr.get("spec", {})
    status = cr.get("status", {})
    return Node(
        metadata=meta_from_cr(cr),
        spec=NodeSpec(
            taints=_taints_from_cr(spec.get("taints")),
            unschedulable=bool(spec.get("unschedulable", False)),
            provider_id=spec.get("providerID", ""),
        ),
        status=NodeStatus(
            capacity=_resources_from_cr(status.get("capacity")),
            allocatable=_resources_from_cr(status.get("allocatable")),
            conditions=[
                NodeCondition(
                    type=c["type"],
                    status=c.get("status", "Unknown"),
                    reason=c.get("reason", ""),
                    last_transition_time=ts_from_rfc3339(
                        c.get("lastTransitionTime")
                    ) or 0.0,
                )
                for c in status.get("conditions", [])
            ],
        ),
    )


# ------------------------------------------------- workload/storage kinds


def daemonset_to_cr(ds) -> dict:
    return {
        "apiVersion": "apps/v1",
        "kind": "DaemonSet",
        "metadata": meta_to_cr(ds.metadata, namespaced=True),
        "spec": _drop_none({
            "selector": _label_selector_to_cr(ds.spec.selector),
            "template": _drop_none({
                "metadata": _drop_none({
                    "labels": dict(ds.spec.template.metadata.labels),
                }),
                "spec": pod_to_cr(
                    Pod(spec=ds.spec.template.spec)
                )["spec"],
            }),
        }),
    }


def daemonset_from_cr(cr: dict):
    from karpenter_tpu_torch.kube.objects import DaemonSet, DaemonSetSpec, PodTemplateSpec

    spec = cr.get("spec", {})
    template = spec.get("template", {})
    pod = pod_from_cr({"metadata": template.get("metadata", {}),
                       "spec": template.get("spec", {})})
    return DaemonSet(
        metadata=meta_from_cr(cr),
        spec=DaemonSetSpec(
            selector=_label_selector_from_cr(spec.get("selector")),
            template=PodTemplateSpec(metadata=pod.metadata, spec=pod.spec),
        ),
    )


def pdb_to_cr(pdb) -> dict:
    return {
        "apiVersion": "policy/v1",
        "kind": "PodDisruptionBudget",
        "metadata": meta_to_cr(pdb.metadata, namespaced=True),
        "spec": _drop_none({
            "selector": _label_selector_to_cr(pdb.spec.selector),
            "minAvailable": pdb.spec.min_available,
            "maxUnavailable": pdb.spec.max_unavailable,
        }),
        "status": _drop_none({
            "disruptionsAllowed": pdb.status.disruptions_allowed or None,
            "currentHealthy": pdb.status.current_healthy or None,
            "desiredHealthy": pdb.status.desired_healthy or None,
            "expectedPods": pdb.status.expected_pods or None,
        }),
    }


def pdb_from_cr(cr: dict):
    from karpenter_tpu_torch.kube.objects import (
        PodDisruptionBudget,
        PodDisruptionBudgetSpec,
        PodDisruptionBudgetStatus,
    )

    spec = cr.get("spec", {})
    status = cr.get("status", {})
    return PodDisruptionBudget(
        metadata=meta_from_cr(cr),
        spec=PodDisruptionBudgetSpec(
            selector=_label_selector_from_cr(spec.get("selector")),
            min_available=spec.get("minAvailable"),
            max_unavailable=spec.get("maxUnavailable"),
        ),
        status=PodDisruptionBudgetStatus(
            disruptions_allowed=int(status.get("disruptionsAllowed", 0)),
            current_healthy=int(status.get("currentHealthy", 0)),
            desired_healthy=int(status.get("desiredHealthy", 0)),
            expected_pods=int(status.get("expectedPods", 0)),
        ),
    )


def pvc_to_cr(pvc) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "PersistentVolumeClaim",
        "metadata": meta_to_cr(pvc.metadata, namespaced=True),
        "spec": _drop_none({
            "storageClassName": pvc.spec.storage_class_name,
            "volumeName": pvc.spec.volume_name,
        }),
        "status": _drop_none({"phase": pvc.phase}),
    }


def pvc_from_cr(cr: dict):
    from karpenter_tpu_torch.kube.objects import (
        PersistentVolumeClaim,
        PersistentVolumeClaimSpec,
    )

    spec = cr.get("spec", {})
    return PersistentVolumeClaim(
        metadata=meta_from_cr(cr),
        spec=PersistentVolumeClaimSpec(
            storage_class_name=spec.get("storageClassName"),
            volume_name=spec.get("volumeName", ""),
        ),
        phase=(cr.get("status") or {}).get("phase", ""),
    )


# ---------------------------------------------------------------- Lease


def lease_to_cr(lease) -> dict:
    return {
        "apiVersion": "coordination.k8s.io/v1",
        "kind": "Lease",
        "metadata": meta_to_cr(lease.metadata, namespaced=True),
        "spec": _drop_none({
            "holderIdentity": lease.holder,
            "leaseDurationSeconds": int(lease.lease_duration),
            "renewTime": ts_to_rfc3339(lease.renew_time),
        }),
    }


def lease_from_cr(cr: dict):
    from karpenter_tpu_torch.operator.leader import Lease

    spec = cr.get("spec", {})
    return Lease(
        metadata=meta_from_cr(cr),
        holder=spec.get("holderIdentity", ""),
        renew_time=ts_from_rfc3339(spec.get("renewTime")) or 0.0,
        lease_duration=float(spec.get("leaseDurationSeconds", 15)),
    )


def priorityclass_to_cr(pc) -> dict:
    """scheduling.k8s.io/v1 PriorityClass wire form (value /
    globalDefault / preemptionPolicy are the fields admission-time
    priority resolution reads)."""
    return {
        "apiVersion": "scheduling.k8s.io/v1",
        "kind": "PriorityClass",
        "metadata": meta_to_cr(pc.metadata),
        "value": pc.value,
        "globalDefault": pc.global_default,
        "preemptionPolicy": pc.preemption_policy,
    }


def priorityclass_from_cr(cr: dict):
    from karpenter_tpu_torch.kube.objects import PriorityClass

    meta = meta_from_cr(cr)
    meta.namespace = ""  # cluster-scoped
    return PriorityClass(
        metadata=meta,
        value=int(cr.get("value", 0)),
        global_default=bool(cr.get("globalDefault", False)),
        preemption_policy=cr.get("preemptionPolicy", "PreemptLowerPriority"),
    )


# ---------------------------------------------------------------- registry

def event_to_cr(ev) -> dict:
    """corev1.Event wire form (pkg/events/recorder.go publishes these
    through record.EventRecorder; kubectl describe joins them on
    involvedObject)."""
    return {
        "apiVersion": "v1",
        "kind": "Event",
        "metadata": meta_to_cr(ev.metadata, namespaced=True),
        "involvedObject": _drop_none({
            "kind": ev.involved_kind,
            "name": ev.involved_name,
            "namespace": ev.involved_namespace or None,
        }),
        "type": ev.type,
        "reason": ev.reason,
        "message": ev.message,
        "count": ev.count,
        "firstTimestamp": ts_to_rfc3339(ev.first_timestamp or None),
        "lastTimestamp": ts_to_rfc3339(ev.last_timestamp or None),
        "source": {"component": ev.source_component},
        "reportingComponent": ev.source_component,
    }


def event_from_cr(cr: dict):
    from karpenter_tpu_torch.kube.objects import KubeEvent

    involved = cr.get("involvedObject", {})
    return KubeEvent(
        metadata=meta_from_cr(cr),
        involved_kind=involved.get("kind", ""),
        involved_name=involved.get("name", ""),
        involved_namespace=involved.get("namespace", ""),
        type=cr.get("type", "Normal"),
        reason=cr.get("reason", ""),
        message=cr.get("message", ""),
        count=int(cr.get("count", 1)),
        first_timestamp=ts_from_rfc3339(cr.get("firstTimestamp")) or 0.0,
        last_timestamp=ts_from_rfc3339(cr.get("lastTimestamp")) or 0.0,
        source_component=(cr.get("source") or {}).get("component", ""),
    )


TO_CR = {
    "Event": event_to_cr,
    "NodePool": nodepool_to_cr,
    "NodeClaim": nodeclaim_to_cr,
    "NodeOverlay": nodeoverlay_to_cr,
    "Pod": pod_to_cr,
    "Node": node_to_cr,
    "DaemonSet": daemonset_to_cr,
    "PodDisruptionBudget": pdb_to_cr,
    "PersistentVolumeClaim": pvc_to_cr,
    "PriorityClass": priorityclass_to_cr,
    "Lease": lease_to_cr,
}

FROM_CR = {
    "Event": event_from_cr,
    "NodePool": nodepool_from_cr,
    "NodeClaim": nodeclaim_from_cr,
    "NodeOverlay": nodeoverlay_from_cr,
    "Pod": pod_from_cr,
    "Node": node_from_cr,
    "DaemonSet": daemonset_from_cr,
    "PodDisruptionBudget": pdb_from_cr,
    "PersistentVolumeClaim": pvc_from_cr,
    "PriorityClass": priorityclass_from_cr,
    "Lease": lease_from_cr,
}


def to_cr(obj) -> dict:
    return TO_CR[obj.kind](obj)


def from_cr(cr: dict) -> object:
    return FROM_CR[cr["kind"]](cr)
