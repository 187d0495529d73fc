"""Resource-list arithmetic over `dict[str, float]` resource maps.

Copy of `karpenter_tpu/utils/resources.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

Counterpart of the reference's pkg/utils/resources/resources.go (822
LoC of Quantity arithmetic): merge/subtract/fits over resource lists,
and pod-request aggregation including init-container max semantics and
pod-overhead (resources.go RequestsForPods / Ceiling semantics).
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


def fits(candidate: Mapping[str, float], total: Mapping[str, float]) -> bool:
    """True if every requested resource is available in `total`.

    Mirrors resources.Fits: a resource requested but absent from the
    total is only OK when the request is zero.
    """
    for key, value in candidate.items():
        if value > total.get(key, 0.0) + 1e-9:
            return False
    return True


def fits_declared(candidate: Mapping[str, float], total: Mapping[str, float]) -> bool:
    """`fits` with leniency for undeclared EXTENDED resources only.

    Providers materializing a claim check size against the *raw*
    catalog; extended resources the raw type doesn't declare may be
    legitimately injected at scheduling time (NodeOverlay capacity, or
    a device plugin on the real node) and must not fail the launch.
    Core resources (cpu/memory/pods/ephemeral-storage) can never be
    injected that way — a type that doesn't declare them cannot run
    the pods, so they stay strict to catch solver/claim sizing bugs."""
    core = (CPU, MEMORY, PODS, EPHEMERAL_STORAGE)
    for key, value in candidate.items():
        if key in total:
            if value > total[key] + 1e-9:
                return False
        elif key in core and value > 1e-9:
            return False
    return True


def is_zero(rl: Mapping[str, float]) -> bool:
    return all(abs(v) < 1e-9 for v in rl.values())


def positive(rl: Mapping[str, float]) -> ResourceList:
    """Clamp all values to >= 0 and drop zero entries."""
    return {k: v for k, v in rl.items() if v > 1e-9}


def pod_requests(pod: "Pod") -> ResourceList:
    """Effective pod resource requests.

    k8s semantics (mirrored from resources.PodRequests, which defers
    to k8s resource helpers):

    - pod-level resources, when set, replace container aggregation
      (PodLevelResources feature; suite_test.go:684);
    - otherwise: walk init containers in order, where a RESTARTABLE
      init container (restartPolicy=Always — a native sidecar) keeps
      its requests for the pod's whole life and stacks under every
      later init container and the main containers, while a regular
      init container only peaks during its own run
      (suite_test.go:531-683 sidecar families);
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
        # pod-level values override aggregation ONLY for the resources
        # k8s supports at pod level (cpu/memory/hugepages); extended
        # resources and everything else stay container-aggregated
        for key, value in pod.spec.resources.items():
            if key in (CPU, MEMORY) or key.startswith("hugepages-"):
                out[key] = value
    if pod.spec.overhead:
        out = merge(out, pod.spec.overhead)
    out[PODS] = out.get(PODS, 0.0) + 1.0
    return out


def requests_for_pods(pods: Iterable["Pod"]) -> ResourceList:
    return merge(*(pod_requests(p) for p in pods))
