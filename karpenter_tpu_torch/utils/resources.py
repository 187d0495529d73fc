"""Resource-list arithmetic over `dict[str, float]` resource maps.

Trimmed copy of `karpenter_tpu/utils/resources.py`: the merge,
subtract, clamp and pod-request aggregation that the encode, the
instance-type model and the consolidation workload read.
"""

from __future__ import annotations

from typing import Iterable, Mapping, TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from karpenter_tpu_torch.kube.objects import Pod

CPU = "cpu"
MEMORY = "memory"
EPHEMERAL_STORAGE = "ephemeral-storage"
PODS = "pods"

ResourceList = dict[str, float]


def merge(*lists: Mapping[str, float]) -> ResourceList:
    """Sum resource lists key-wise."""
    out: ResourceList = {}
    for rl in lists:
        for key, value in rl.items():
            out[key] = out.get(key, 0.0) + value
    return out


def subtract(a: Mapping[str, float], b: Mapping[str, float]) -> ResourceList:
    """a - b key-wise; keys only in b appear negated."""
    out: ResourceList = dict(a)
    for key, value in b.items():
        out[key] = out.get(key, 0.0) - value
    return out


def max_resources(*lists: Mapping[str, float]) -> ResourceList:
    """Key-wise maximum (reference MaxResources)."""
    out: ResourceList = {}
    for rl in lists:
        for key, value in rl.items():
            if value > out.get(key, float("-inf")):
                out[key] = value
    return out


def positive(rl: Mapping[str, float]) -> ResourceList:
    """Clamp all values to >= 0 and drop zero entries."""
    return {k: v for k, v in rl.items() if v > 1e-9}


def pod_requests(pod: "Pod") -> ResourceList:
    """Effective pod resource requests (k8s semantics):

    - pod-level resources, when set, replace container aggregation for
      cpu, memory and hugepages;
    - otherwise: walk init containers in order, where a RESTARTABLE
      init container (restartPolicy=Always — a native sidecar) keeps
      its requests for the pod's whole life and stacks under every
      later init container and the main containers, while a regular
      init container only peaks during its own run;
    - plus pod overhead, plus one implicit "pods" unit.
    """
    sidecar_sum: ResourceList = {}
    init_peak: ResourceList = {}
    for c in pod.spec.init_containers:
        if c.restart_policy == "Always":
            sidecar_sum = merge(sidecar_sum, c.requests)
        else:
            init_peak = max_resources(
                init_peak, merge(sidecar_sum, c.requests)
            )
    main = merge(
        sidecar_sum, *(c.requests for c in pod.spec.containers)
    )
    out = max_resources(main, init_peak)
    if pod.spec.resources:
        for key, value in pod.spec.resources.items():
            if key in (CPU, MEMORY) or key.startswith("hugepages-"):
                out[key] = value
    if pod.spec.overhead:
        out = merge(out, pod.spec.overhead)
    out[PODS] = out.get(PODS, 0.0) + 1.0
    return out


def requests_for_pods(pods: Iterable["Pod"]) -> ResourceList:
    """The summed effective requests of `pods`."""
    return merge(*(pod_requests(p) for p in pods))
