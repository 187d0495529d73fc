"""kwok-style simulated cloud provider.

Copy of `karpenter_tpu/cloudprovider/kwok.py`.

Counterpart of kwok/cloudprovider/cloudprovider.go: `create` picks the
cheapest compatible offering and records a simulated instance;
`tick(now)` materializes Node objects for instances whose registration
delay has elapsed (fabricated nodes, no kubelet — the reference's kwok
pattern that lets hundred-node scale-ups run on a laptop). Nodes appear
with the `unregistered` NoExecute taint, capacity/allocatable from the
instance type, and Ready=True.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from dataclasses import dataclass
from typing import Optional

from karpenter_tpu_torch.apis.v1.labels import (
    ARCH_LABEL,
    CAPACITY_TYPE_LABEL,
    INSTANCE_TYPE_LABEL,
    NODEPOOL_LABEL,
    OS_LABEL,
    RESERVATION_ID_LABEL,
    TOPOLOGY_ZONE_LABEL,
    UNREGISTERED_NO_EXECUTE_TAINT,
)
from karpenter_tpu_torch.apis.v1.nodeclaim import NodeClaim, NodeClaimStatus
from karpenter_tpu_torch.apis.v1.nodepool import NodePool
from karpenter_tpu_torch.cloudprovider.fake import kwok_instance_types
from karpenter_tpu_torch.cloudprovider.types import (
    CloudProvider,
    InstanceType,
    InsufficientCapacityError,
    NodeClaimNotFoundError,
    named_by,
    order_by_price,
)
from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.kube.objects import (
    Node,
    NodeCondition,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
)
from karpenter_tpu_torch.scheduling.requirement import Requirement
from karpenter_tpu_torch.scheduling.requirements import Requirements
from karpenter_tpu_torch.utils.resources import fits_declared


@dataclass
class _Instance:
    claim_name: str
    node_name: str
    instance_type: InstanceType
    labels: dict[str, str]
    created_at: float
    registered: bool = False
    terminated: bool = False


class KwokCloudProvider(CloudProvider):
    def __init__(
        self,
        kube: KubeClient,
        types: Optional[list[InstanceType]] = None,
        registration_delay: float = 0.0,
        clock=None,
    ):
        """`clock` supplies the time source for instance timestamps.
        Inject a simulated clock when driving tick() with simulated
        `now` values and a nonzero registration delay — otherwise
        created_at (wall) and now (simulated) come from different
        clocks and the delay comparison is meaningless."""
        self.kube = kube
        self.types = types if types is not None else kwok_instance_types()
        self.registration_delay = registration_delay
        self.clock = clock or time.time
        self._lock = threading.RLock()
        self._instances: dict[str, _Instance] = {}  # provider id -> instance
        self._counter = itertools.count(1)
        self._repair_policies: list = []
        # chaos hook (parity with the fake provider's error injection,
        # fake/cloudprovider.go): the next create() raises this once
        self.next_create_error: Optional[Exception] = None
        # provider ids of spot instances holding an interruption notice
        # (the cloud's rebalance/termination warning; consumed by the
        # interruption controller's poll)
        self.interrupted: set[str] = set()

    def restore(self) -> int:
        """Rehydrate instance state from the store after a restart —
        the checkpoint/resume analogue: claims (and their nodes) are
        the durable record, the provider's in-memory map is a cache.
        Returns the number of instances rebuilt."""
        with self._lock:
            by_name = {it.name: it for it in self.types}
            nodes_by_pid = {
                n.spec.provider_id: n for n in self.kube.nodes()
                if n.spec.provider_id
            }
            rebuilt = 0
            for claim in self.kube.node_claims():
                pid = claim.status.provider_id
                if not pid or pid in self._instances:
                    continue
                it = by_name.get(
                    claim.metadata.labels.get(INSTANCE_TYPE_LABEL, "")
                )
                if it is None:
                    continue
                node = nodes_by_pid.get(pid)
                self._instances[pid] = _Instance(
                    claim_name=claim.metadata.name,
                    node_name=(
                        node.metadata.name if node is not None
                        else pid.removeprefix("kwok://")
                    ),
                    instance_type=it,
                    labels=dict(claim.metadata.labels),
                    created_at=self.clock(),
                    registered=node is not None,
                )
                rebuilt += 1
            # never reuse a node-name sequence number from a prior life
            taken = [
                int(inst.node_name.rsplit("-", 1)[-1])
                for inst in self._instances.values()
                if inst.node_name.rsplit("-", 1)[-1].isdigit()
            ]
            if taken:
                self._counter = itertools.count(max(taken) + 1)
            return rebuilt

    # -- SPI ------------------------------------------------------------------

    def create(self, node_claim: NodeClaim) -> NodeClaim:
        with self._lock:
            if self.next_create_error is not None:
                err, self.next_create_error = self.next_create_error, None
                raise err
            reqs = Requirements(
                Requirement(r.key, r.operator, r.values, r.min_values)
                for r in node_claim.spec.requirements
            )
            compatible = [
                it
                for it in named_by(self.types, reqs)
                if it.requirements.intersects(reqs) is None
                and it.offerings.available().has_compatible(reqs)
                and fits_declared(node_claim.spec.resources, it.allocatable)
            ]
            if not compatible:
                raise InsufficientCapacityError(
                    f"no offering satisfies {node_claim.metadata.name}"
                )
            chosen = order_by_price(compatible, reqs)[0]
            offering = chosen.offerings.available().compatible(reqs).cheapest()
            seq = next(self._counter)
            node_name = f"{node_claim.metadata.name}-{seq}"
            provider_id = f"kwok://{node_name}"
            labels = {
                # every representative label of the chosen type lands
                # on the node (the reference's instance types expose
                # Requirements().Labels(); custom catalog labels like
                # accelerator families must be visible to selectors)
                **chosen.requirements.labels(),
                **node_claim.metadata.labels,
                INSTANCE_TYPE_LABEL: chosen.name,
                TOPOLOGY_ZONE_LABEL: offering.zone,
                CAPACITY_TYPE_LABEL: offering.capacity_type,
                ARCH_LABEL: chosen.requirements.get(ARCH_LABEL).any_value(),
                OS_LABEL: chosen.requirements.get(OS_LABEL).any_value() or "linux",
            }
            if offering.reservation_id:
                labels[RESERVATION_ID_LABEL] = offering.reservation_id
            self._instances[provider_id] = _Instance(
                claim_name=node_claim.metadata.name,
                node_name=node_name,
                instance_type=chosen,
                labels=labels,
                created_at=self.clock(),
            )
            out = NodeClaim(
                metadata=node_claim.metadata,
                spec=node_claim.spec,
                status=NodeClaimStatus(
                    provider_id=provider_id,
                    image_id="kwok-image",
                    capacity=dict(chosen.capacity),
                    allocatable=dict(chosen.allocatable),
                ),
                status_conditions=node_claim.status_conditions,
            )
            out.metadata.labels = labels
            return out

    def tick(self, now: Optional[float] = None) -> list[Node]:
        """Materialize Node objects for instances past the registration
        delay (kwok NodeRegistrationDelay, cloudprovider.go:74-83)."""
        now = self.clock() if now is None else now
        created = []
        with self._lock:
            for pid, inst in self._instances.items():
                if inst.registered or inst.terminated:
                    continue
                # created_at is wall clock while `now` may be simulated;
                # only gate when a delay is actually configured
                if (
                    self.registration_delay > 0
                    and now - inst.created_at < self.registration_delay
                ):
                    continue
                claim = self.kube.get_node_claim(inst.claim_name)
                taints = [UNREGISTERED_NO_EXECUTE_TAINT]
                if claim is not None:
                    taints += list(claim.spec.taints) + list(claim.spec.startup_taints)
                node = Node(
                    metadata=ObjectMeta(name=inst.node_name, namespace="",
                                        labels=dict(inst.labels)),
                    spec=NodeSpec(taints=taints, provider_id=pid),
                    status=NodeStatus(
                        capacity=dict(inst.instance_type.capacity),
                        allocatable=dict(inst.instance_type.allocatable),
                        conditions=[NodeCondition(type="Ready", status="True")],
                    ),
                )
                self.kube.create(node)
                inst.registered = True
                created.append(node)
        return created

    def delete(self, node_claim: NodeClaim) -> None:
        with self._lock:
            pid = node_claim.status.provider_id
            inst = self._instances.get(pid)
            if inst is None or inst.terminated:
                raise NodeClaimNotFoundError(pid)
            inst.terminated = True
            del self._instances[pid]
            self.interrupted.discard(pid)

    def reprice(self, now: float) -> int:
        """Advance spot offering prices to the deterministic hourly
        curve (fake.spot_price_at). 0 changes within one price hour, so
        the encoder cache's catalog fingerprint busts only when the
        curve actually moved."""
        from karpenter_tpu_torch.cloudprovider.fake import reprice_spot

        with self._lock:
            return reprice_spot(self.types, now)

    def poll_interruptions(self, now: Optional[float] = None) -> list[str]:
        """One `cloud_interrupt` fault check per live spot instance, in
        sorted provider-id order (occurrence numbers map to instances
        deterministically). A firing `spot_interruption` rule is
        CONSUMED here — the instance gets an interruption notice
        surfaced through `self.interrupted`, exactly like a cloud's
        rebalance/termination warning. Returns newly noticed ids."""
        from karpenter_tpu_torch.apis.v1.labels import CAPACITY_TYPE_SPOT
        from karpenter_tpu_torch.metrics.store import SPOT_INTERRUPTIONS
        from karpenter_tpu_torch.solver import faults as _faults

        newly: list[str] = []
        with self._lock:
            for pid in sorted(self._instances):
                if pid in self.interrupted:
                    continue
                inst = self._instances[pid]
                if inst.terminated:
                    continue
                if inst.labels.get(CAPACITY_TYPE_LABEL) != CAPACITY_TYPE_SPOT:
                    continue
                try:
                    _faults.fire("cloud_interrupt")
                except _faults.SpotInterruptionError:
                    self.interrupted.add(pid)
                    newly.append(pid)
                    SPOT_INTERRUPTIONS.inc({"provider": "kwok"})
                except _faults.FaultError as err:
                    # a mis-kinded spec (e.g. device_lost@cloud_interrupt)
                    # is consumed, not propagated: a chaos knob must
                    # never take the operator tick down
                    logging.getLogger(__name__).warning(
                        "ignoring non-interruption fault at "
                        "cloud_interrupt: %r", err,
                    )
        return newly

    def get(self, provider_id: str) -> NodeClaim:
        with self._lock:
            inst = self._instances.get(provider_id)
            if inst is None:
                raise NodeClaimNotFoundError(provider_id)
            claim = NodeClaim(metadata=ObjectMeta(name=inst.claim_name, namespace=""))
            claim.status.provider_id = provider_id
            claim.metadata.labels = dict(inst.labels)
            return claim

    def list(self) -> list[NodeClaim]:
        with self._lock:
            return [self.get(pid) for pid in list(self._instances)]

    def get_instance_types(self, node_pool: Optional[NodePool]) -> list[InstanceType]:
        return list(self.types)

    def is_drifted(self, node_claim: NodeClaim) -> str:
        return ""

    def repair_policies(self) -> list:
        return list(self._repair_policies)

    def name(self) -> str:
        return "kwok"

    def get_supported_node_classes(self) -> list[str]:
        return ["KwokNodeClass"]
