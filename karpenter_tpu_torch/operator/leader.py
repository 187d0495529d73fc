"""Leader election over a store-backed Lease.

Copy of `karpenter_tpu/operator/leader.py`.

Counterpart of the reference's lease-based leader election
(operator.go:141-165: a coordination.k8s.io Lease named
"karpenter-leader-election", renewed by the active replica; standbys
take over when the lease expires). The lease lives in the same store
as everything else, so HA semantics — exactly one active operator,
failover on silence — are testable with two Operator instances sharing
one client.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

from karpenter_tpu_torch.kube.objects import ObjectMeta

LEASE_NAME = "karpenter-leader-election"
LEASE_DURATION_SECONDS = 15.0  # controller-runtime default
RENEW_DEADLINE_SECONDS = 10.0


@dataclass
class Lease:
    """coordination.k8s.io/v1 Lease, trimmed to what election needs."""

    kind = "Lease"
    metadata: ObjectMeta = field(default_factory=lambda: ObjectMeta(name=LEASE_NAME))
    holder: str = ""
    renew_time: float = 0.0
    lease_duration: float = LEASE_DURATION_SECONDS

    @property
    def key(self) -> str:
        return self.metadata.name

    def expired(self, now: float) -> bool:
        return now - self.renew_time > self.lease_duration


class LeaderElector:
    def __init__(self, kube, identity: str,
                 lease_duration: float = LEASE_DURATION_SECONDS):
        self.kube = kube
        self.identity = identity
        self.lease_duration = lease_duration

    def try_acquire_or_renew(self, now: Optional[float] = None) -> bool:
        """One election tick: returns True while this identity holds
        the lease. Acquires a missing/expired lease, renews an owned
        one, and defers to a live foreign holder."""
        now = time.time() if now is None else now
        lease = self.kube.get("Lease", LEASE_NAME)
        if lease is None:
            lease = Lease(holder=self.identity, renew_time=now,
                          lease_duration=self.lease_duration)
            try:
                self.kube.create(lease)
            except Exception:
                lease = self.kube.get("Lease", LEASE_NAME)
                return lease is not None and lease.holder == self.identity
            return True
        if lease.holder == self.identity or lease.expired(now):
            # write a fresh object (not an in-place mutation of the
            # shared stored one) and re-read after the update: when two
            # replicas race an expired lease, last-writer-wins on the
            # store and the re-read confirms exactly one winner
            claimed = Lease(
                metadata=lease.metadata, holder=self.identity,
                renew_time=now, lease_duration=self.lease_duration,
            )
            self.kube.update(claimed)
            final = self.kube.get("Lease", LEASE_NAME)
            return final is not None and final.holder == self.identity
        return False

    def is_leader(self, now: Optional[float] = None) -> bool:
        now = time.time() if now is None else now
        lease = self.kube.get("Lease", LEASE_NAME)
        return (
            lease is not None
            and lease.holder == self.identity
            and not lease.expired(now)
        )
