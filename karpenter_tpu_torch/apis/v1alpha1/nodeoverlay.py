"""NodeOverlay (alpha): runtime overrides of instance-type attributes.

Copy of `karpenter_tpu/apis/v1alpha1/nodeoverlay.py`.

Counterpart of pkg/apis/v1alpha1/nodeoverlay.go + the overlay store and
cloudprovider decorator (pkg/controllers/nodeoverlay/store.go:47-260,
pkg/cloudprovider/overlay/cloudprovider.go:30-60): operator-supplied
price overrides / adjustments and extended-capacity injection, selected
by requirements, with weight-based conflict resolution.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from karpenter_tpu_torch.apis.v1.condition import ConditionSet
from karpenter_tpu_torch.apis.v1.nodepool import NodePool
from karpenter_tpu_torch.cloudprovider.types import (
    CloudProvider,
    InstanceType,
    Offering,
    Offerings,
)
from karpenter_tpu_torch.kube.objects import NodeSelectorRequirement, ObjectMeta
from karpenter_tpu_torch.scheduling.requirements import Requirements
from karpenter_tpu_torch.utils.resources import ResourceList


@dataclass
class NodeOverlaySpec:
    requirements: list[NodeSelectorRequirement] = field(default_factory=list)
    price_adjustment: Optional[str] = None  # "+0.5" | "-1.2" | "+10%" | "-5%"
    price: Optional[str] = None             # absolute override
    capacity: ResourceList = field(default_factory=dict)  # extended resources only
    weight: int = 0


COND_OVERLAY_VALIDATION = "ValidationSucceeded"


@dataclass
class NodeOverlay:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeOverlaySpec = field(default_factory=NodeOverlaySpec)
    status_conditions: ConditionSet = field(
        default_factory=lambda: ConditionSet(
            root_types=[COND_OVERLAY_VALIDATION]
        )
    )

    kind = "NodeOverlay"

    @property
    def key(self) -> str:
        return self.metadata.name


def adjusted_price(base: float, change: Optional[str]) -> float:
    """types.go:369-401: percent or absolute signed adjustment,
    clamped at zero."""
    if not change:
        return base
    if change.endswith("%"):
        out = base * (1 + float(change[:-1]) / 100.0)
    else:
        out = base + float(change)
    return max(0.0, out)


class OverlayStore:
    """Immutable snapshot applying overlays to instance types
    (store.go:47-260). Overlays sorted by weight descending; the
    heaviest matching overlay wins per attribute."""

    def __init__(self, overlays: list[NodeOverlay], snapshot: bool = True):
        # snapshot the SPECS: a controller-owned store must be immutable
        # under overlay churn (store.go's internal store is rebuilt,
        # never mutated) — holding live references would leak spec edits
        # into an already-taken snapshot between controller passes. The
        # lazy read-through path (no controller) builds a throwaway
        # store per call and skips the copy.
        if snapshot:
            import copy

            overlays = [copy.deepcopy(o) for o in overlays]
        self.overlays = sorted(
            overlays, key=lambda o: (-o.spec.weight, o.metadata.name)
        )
        # parse each overlay's selector once; matching runs per
        # (instance type x offering) on the scheduler hot path
        self._overlay_reqs = [
            Requirements.from_node_selector_requirements(o.spec.requirements)
            for o in self.overlays
        ]
        # applied-result memo keyed by input object identity (the
        # stored input ref keeps the id valid). A store is an immutable
        # snapshot — rebuilt, never mutated, when overlays change — so
        # the memo's lifetime is exactly the window the applied result
        # stays correct. This keeps output OBJECT IDENTITY stable
        # across calls, which the solver's encoder cache fingerprints
        # on: without it, every overlay-touched tick rebuilds the
        # whole catalog's InstanceTypes and busts the cache.
        self._applied: dict[int, tuple[InstanceType, InstanceType]] = {}

    def _matching(self, it: InstanceType, offering: Offering) -> list[NodeOverlay]:
        out = []
        combined = it.requirements.copy()
        combined.add(*offering.requirements.values())
        for overlay, reqs in zip(self.overlays, self._overlay_reqs):
            if combined.intersects(reqs) is None:
                out.append(overlay)
        return out

    def apply(self, it: InstanceType) -> InstanceType:
        hit = self._applied.get(id(it))
        if hit is not None and hit[0] is it:
            return hit[1]
        out = self._apply(it)
        self._applied[id(it)] = (it, out)
        return out

    def _apply(self, it: InstanceType) -> InstanceType:
        new_offerings = Offerings()
        price_touched = False
        capacity_extra: ResourceList = {}
        for offering in it.offerings:
            price = offering.price
            applied_price = False
            for overlay in self._matching(it, offering):
                if not applied_price and overlay.spec.price is not None:
                    price = max(0.0, float(overlay.spec.price))
                    applied_price = True
                elif not applied_price and overlay.spec.price_adjustment is not None:
                    price = adjusted_price(price, overlay.spec.price_adjustment)
                    applied_price = True
                # extended resources merge across overlays, heaviest
                # writer wins per key (store.go:173-176)
                for key, value in overlay.spec.capacity.items():
                    if key not in it.capacity and key not in capacity_extra:
                        capacity_extra[key] = value
            price_touched = price_touched or applied_price
            new_offerings.append(
                Offering(
                    requirements=offering.requirements,
                    price=price,
                    available=offering.available,
                    reservation_capacity=offering.reservation_capacity,
                )
            )
        if not price_touched and not capacity_extra:
            return it
        capacity = dict(it.capacity)
        capacity.update(capacity_extra)
        return InstanceType(
            name=it.name,
            requirements=it.requirements,
            offerings=new_offerings,
            capacity=capacity,
            overhead=it.overhead,
        )


# well-known resources an overlay may NOT override — capacity injection
# is for EXTENDED resources only (nodeoverlay_validation.go:50-57)
WELL_KNOWN_RESOURCES = frozenset(
    ("cpu", "memory", "pods", "ephemeral-storage", "hugepages-2Mi",
     "hugepages-1Gi")
)
_VALID_OPERATORS = frozenset(
    ("In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt")
)


def runtime_validate(overlay: NodeOverlay) -> Optional[str]:
    """RuntimeValidate (nodeoverlay_validation.go:31-57): the rules a
    webhook would enforce beyond CRD schema — requirement operator
    sanity, capacity restricted to extended resources, parseable price
    fields. Returns a reason string, or None when valid."""
    spec = overlay.spec
    for req in spec.requirements:
        if req.operator not in _VALID_OPERATORS:
            return f"invalid operator {req.operator!r} for key {req.key}"
        if req.operator in ("In", "NotIn") and not req.values:
            return (
                f"key {req.key} with operator {req.operator} must have a "
                f"value defined"
            )
    for resource in spec.capacity:
        if resource in WELL_KNOWN_RESOURCES:
            return f"invalid capacity: {resource} is restricted"
    if not 0 <= spec.weight <= 100:
        # same bound the published CRD schema enforces at admission —
        # simulation and cluster behavior must agree
        return f"weight {spec.weight} out of range [0, 100]"
    if spec.price is not None and spec.price_adjustment is not None:
        return "price and priceAdjustment are mutually exclusive"
    import math

    if spec.price is not None:
        try:
            value = float(spec.price)
        except ValueError:
            return f"price {spec.price!r} is not a number"
        if not math.isfinite(value) or value < 0:
            # nan slips past a `< 0` check and max(0, nan) zero-prices
            # every matched offering downstream
            return f"price {spec.price!r} must be a non-negative number"
    if spec.price_adjustment is not None:
        raw = spec.price_adjustment
        body = raw[:-1] if raw.endswith("%") else raw
        try:
            value = float(body)
        except ValueError:
            return f"priceAdjustment {raw!r} is malformed"
        if not math.isfinite(value):
            return f"priceAdjustment {raw!r} must be finite"
    return None


def detect_conflicts(
    overlays: list[NodeOverlay],
    instance_types_by_pool: dict[Optional[str], list[InstanceType]],
) -> dict[str, str]:
    """Conflicts against ACTUAL instance types, the reference's
    semantics (store.go:185-258 + controller.go:144-160): walk overlays
    in descending weight (name-ascending on ties), record which overlay
    last wrote each (pool, instance, offering) price cell and each
    (pool, instance, capacity-resource) cell, and flag an overlay that
    writes a cell already written AT THE SAME WEIGHT by a different
    overlay — regardless of the value; equal-weight double-writes are
    ambiguous by definition. A flagged overlay is excluded from the
    store ENTIRELY (atomicity: validate-then-store,
    controller.go:152-159). Selector algebra alone would flag overlays
    whose selectors intersect but never co-match a real offering; the
    concrete evaluation does not."""
    ordered = sorted(
        overlays, key=lambda o: (-o.spec.weight, o.metadata.name)
    )
    reqs = {
        o.metadata.name: Requirements.from_node_selector_requirements(
            o.spec.requirements
        )
        for o in ordered
    }
    conflicts: dict[str, str] = {}
    # cell -> (weight, overlay name) of the last writer
    price_writer: dict[tuple, tuple[int, str]] = {}
    capacity_writer: dict[tuple, tuple[int, str]] = {}
    for overlay in ordered:
        name = overlay.metadata.name
        writes_price = (
            overlay.spec.price is not None
            or overlay.spec.price_adjustment is not None
        )
        clash: Optional[str] = None
        touched_price: list[tuple] = []
        touched_capacity: list[tuple] = []
        for pool_name, its in instance_types_by_pool.items():
            for it in its:
                combined_base = it.requirements
                for offering in it.offerings:
                    combined = combined_base.copy()
                    combined.add(*offering.requirements.values())
                    if combined.intersects(reqs[name]) is not None:
                        continue
                    if writes_price:
                        cell = (pool_name, it.name,
                                offering.zone, offering.capacity_type,
                                offering.reservation_id)
                        prior = price_writer.get(cell)
                        if (
                            prior is not None
                            and prior[0] == overlay.spec.weight
                            and prior[1] != name
                        ):
                            clash = (
                                f"price conflicts with {prior[1]} at weight "
                                f"{overlay.spec.weight} on {it.name}"
                            )
                            break
                        touched_price.append(cell)
                    for resource in overlay.spec.capacity:
                        cell = (pool_name, it.name, resource)
                        prior = capacity_writer.get(cell)
                        if (
                            prior is not None
                            and prior[0] == overlay.spec.weight
                            and prior[1] != name
                        ):
                            clash = (
                                f"capacity {resource} conflicts with "
                                f"{prior[1]} at weight {overlay.spec.weight} "
                                f"on {it.name}"
                            )
                            break
                        touched_capacity.append(cell)
                    if clash:
                        break
                if clash:
                    break
            if clash:
                break
        if clash:
            conflicts[name] = clash
            continue  # atomic: none of its writes land
        # record this overlay as the LATEST writer of its cells: the
        # heaviest writer owns the value (apply() honors that), while
        # clash checks above compare against the most recent — i.e.
        # lowest-so-far — weight, exactly the reference's lowestWeight
        # tracking (store.go:198-205, 232-246)
        for cell in touched_price:
            price_writer[cell] = (overlay.spec.weight, name)
        for cell in touched_capacity:
            capacity_writer[cell] = (overlay.spec.weight, name)
    return conflicts


class UnevaluatedNodePoolError(Exception):
    """GetInstanceTypes called for a pool the overlay controller has
    not evaluated yet (store.go:64-67, 121-124) — new pools stay gated
    until the next controller pass; the provisioner skips them."""


class NodeOverlayController:
    """Singleton revalidation loop (controller.go:69-160): runtime-
    validates every overlay, detects conflicts against each pool's
    ACTUAL instance types, publishes results to overlay status
    conditions and Warning events, then atomically swaps an immutable
    snapshot (valid overlays + the evaluated-pool set) into the
    decorator and marks the cluster unconsolidated so consolidation
    re-evaluates against the new prices."""

    # full re-evaluation cadence with an unchanged input set — catches
    # provider catalog drift the object watch can't see (the reference
    # requeues on a long timer, controller.go:120 RequeueAfter)
    REEVALUATE_SECONDS = 6 * 3600.0

    def __init__(self, kube, provider: "OverlayCloudProvider",
                 recorder=None, cluster=None):
        self.kube = kube
        self.provider = provider
        self.recorder = recorder
        self.cluster = cluster
        self._fingerprint: Optional[tuple] = None
        self._evaluated_at = 0.0
        provider.gated = True  # serve only controller snapshots

    def _publish(self, overlay: NodeOverlay, reason: str, message: str,
                 now: Optional[float]) -> None:
        changed = overlay.status_conditions.set_false(
            COND_OVERLAY_VALIDATION, reason=reason, message=message, now=now
        )
        if changed:
            # announce the transition (and push it to a real API server)
            self.kube.touch(overlay)
        if self.recorder is not None:
            from karpenter_tpu_torch.events.recorder import Event

            self.recorder.publish(Event(
                kind="NodeOverlay", name=overlay.metadata.name,
                type="Warning", reason=reason, message=message,
            ), now=now)

    def reconcile(self, now: Optional[float] = None) -> None:
        import time as _time

        overlays = list(self.kube.list("NodeOverlay"))
        # deleting pools stay evaluated: their nodes serve (and may be
        # disrupted/priced) until they are actually gone — permanent
        # gating would wedge disruption's price lookups for them
        pools = list(self.kube.list("NodePool"))
        # change detection: re-evaluation is O(overlays x pools x
        # catalog); skip it while the input objects are unchanged (the
        # reference controller is watch-triggered), re-running on a
        # long timer to catch provider catalog drift
        def current_fingerprint():
            return (
                tuple(sorted(
                    (o.metadata.name, o.metadata.resource_version)
                    for o in overlays
                )),
                tuple(sorted(
                    (p.metadata.name, p.metadata.resource_version)
                    for p in pools
                )),
            )

        wall = _time.monotonic()
        if (
            current_fingerprint() == self._fingerprint
            and wall - self._evaluated_at < self.REEVALUATE_SECONDS
        ):
            return
        # conflict evaluation runs against the RAW catalog (the inner
        # provider) per pool — reserved offerings are injected per pool,
        # so an overlay targeting them must be validated per pool
        # (controller.go:144-150). A pool whose catalog fetch FAILS is
        # neither conflict-checked nor marked evaluated: degrading to
        # "no conflicts" would open the gate on an unchecked snapshot.
        inner = self.provider.inner
        its_by_pool: dict[Optional[str], list[InstanceType]] = {}
        fetch_failed: set[str] = set()
        for pool in pools:
            try:
                its_by_pool[pool.metadata.name] = inner.get_instance_types(pool)
            except Exception:
                fetch_failed.add(pool.metadata.name)
        if not pools:
            # poolless (direct/simulation) use still needs a catalog to
            # validate against
            try:
                its_by_pool[None] = inner.get_instance_types(None)
            except Exception:
                return  # no catalog at all: keep the previous snapshot

        valid: list[NodeOverlay] = []
        evaluatable: list[NodeOverlay] = []
        for overlay in overlays:
            reason = runtime_validate(overlay)
            if reason is not None:
                self._publish(overlay, "ValidationFailed", reason, now)
            else:
                evaluatable.append(overlay)
        conflicts = detect_conflicts(evaluatable, its_by_pool)
        for overlay in evaluatable:
            message = conflicts.get(overlay.metadata.name)
            if message:
                self._publish(overlay, "Conflict", message, now)
            else:
                if overlay.status_conditions.set_true(
                    COND_OVERLAY_VALIDATION, now=now
                ):
                    self.kube.touch(overlay)
                valid.append(overlay)
        self.provider.set_store(
            OverlayStore(valid),
            evaluated_pools={
                p.metadata.name for p in pools
                if p.metadata.name not in fetch_failed
            },
        )
        if not fetch_failed:
            # re-read AFTER the touch loop above bumped overlay rvs —
            # storing the pre-touch fingerprint would force one wasted
            # full re-evaluation (and a spurious unconsolidated mark)
            # on the very next pass. A pass with failed fetches commits
            # nothing, so the gated pools are retried next tick instead
            # of staying gated for REEVALUATE_SECONDS.
            self._fingerprint = current_fingerprint()
            self._evaluated_at = wall
        if self.cluster is not None:
            # prices moved: force consolidation to re-evaluate
            # (controller.go:119 MarkUnconsolidated) — only on a real
            # snapshot swap, never on the per-tick no-op path above
            self.cluster.mark_unconsolidated(now=now)


class OverlayCloudProvider(CloudProvider):
    """Decorator applying the overlay store to GetInstanceTypes
    (overlay/cloudprovider.go:30-60). Serves the controller's snapshot;
    before the first evaluation — and per pool, for pools created AFTER
    the snapshot was built — requests are gated behind
    UnevaluatedNodePoolError (store.go:64-67)."""

    def __init__(self, inner: CloudProvider, kube):
        self.inner = inner
        self.kube = kube
        self._snapshot: Optional[OverlayStore] = None
        self._evaluated_pools: set[str] = set()
        # set by NodeOverlayController: once a controller owns this
        # decorator, only its snapshots are served (the reference's
        # UnevaluatedNodePoolError gate); standalone use builds lazily
        self.gated = False

    def set_store(self, store: OverlayStore,
                  evaluated_pools: Optional[set[str]] = None) -> None:
        self._evaluated_pools = set(evaluated_pools or ())
        self._snapshot = store

    def _store(self, node_pool: Optional[NodePool]) -> OverlayStore:
        if self._snapshot is not None:
            if (
                self.gated
                and node_pool is not None
                and node_pool.metadata.name not in self._evaluated_pools
            ):
                # a pool created after the snapshot: its (possibly
                # reserved) offerings were never conflict-checked —
                # gate it until the next controller pass
                raise UnevaluatedNodePoolError(
                    f"node pool {node_pool.metadata.name} not yet evaluated"
                )
            return self._snapshot
        if self.gated:
            raise UnevaluatedNodePoolError("node overlays not yet evaluated")
        # standalone (no controller): read-through, no caching
        return OverlayStore(list(self.kube.list("NodeOverlay")), snapshot=False)

    def get_instance_types(self, node_pool: Optional[NodePool]) -> list[InstanceType]:
        store = self._store(node_pool)
        return [store.apply(it) for it in self.inner.get_instance_types(node_pool)]

    # passthrough SPI
    def create(self, node_claim):
        return self.inner.create(node_claim)

    def delete(self, node_claim):
        return self.inner.delete(node_claim)

    def get(self, provider_id):
        return self.inner.get(provider_id)

    def list(self):
        return self.inner.list()

    def is_drifted(self, node_claim):
        return self.inner.is_drifted(node_claim)

    def repair_policies(self):
        return self.inner.repair_policies()

    # spot-tier hooks (optional on the SPI)
    def reprice(self, now):
        fn = getattr(self.inner, "reprice", None)
        return 0 if fn is None else fn(now)

    def poll_interruptions(self, now=None):
        fn = getattr(self.inner, "poll_interruptions", None)
        return [] if fn is None else fn(now)

    @property
    def interrupted(self):
        return getattr(self.inner, "interrupted", set())

    def name(self):
        return self.inner.name()

    def get_supported_node_classes(self):
        return self.inner.get_supported_node_classes()
