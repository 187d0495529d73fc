"""Per-NodePool launch/registration health tracking.

Copy of `karpenter_tpu/state/nodepoolhealth.py`.

Counterpart of pkg/state/nodepoolhealth (ring buffer capacity 10):
recent registration outcomes decide Healthy/Degraded for the
NodeRegistrationHealthy condition. Every record publishes the
`karpenter_nodepool_registration_healthy` gauge and the tracker
snapshots into `Operator.readyz()["nodepool_health"]` — the state was
previously invisible outside the condition writer.
"""

from __future__ import annotations

from collections import deque

CAPACITY = 10
UNHEALTHY_THRESHOLD = 0.5  # more than half failures -> degraded


class HealthTracker:
    def __init__(self) -> None:
        self._buffers: dict[str, deque[bool]] = {}

    def record(self, pool_name: str, success: bool) -> None:
        if not pool_name:
            return
        self._buffers.setdefault(pool_name, deque(maxlen=CAPACITY)).append(success)
        self._publish(pool_name)

    def healthy(self, pool_name: str) -> bool:
        buf = self._buffers.get(pool_name)
        if not buf:
            return True
        failures = sum(1 for ok in buf if not ok)
        return failures / len(buf) <= UNHEALTHY_THRESHOLD or len(buf) < 3

    def reset(self, pool_name: str) -> None:
        self._buffers.pop(pool_name, None)
        from karpenter_tpu_torch.metrics.store import (
            NODEPOOL_REGISTRATION_HEALTHY,
        )

        # the pool's history is gone (pool deleted or hash-reset):
        # drop the series rather than freeze a stale verdict
        NODEPOOL_REGISTRATION_HEALTHY.delete({"nodepool": pool_name})

    def _publish(self, pool_name: str) -> None:
        from karpenter_tpu_torch.metrics.store import (
            NODEPOOL_REGISTRATION_HEALTHY,
        )

        NODEPOOL_REGISTRATION_HEALTHY.set(
            1.0 if self.healthy(pool_name) else 0.0,
            {"nodepool": pool_name},
        )

    def snapshot(self) -> dict:
        """Operator-facing view (readyz): which tracked pools are
        degraded right now, with their recent failure counts."""
        degraded = {}
        for pool_name, buf in self._buffers.items():
            if not self.healthy(pool_name):
                degraded[pool_name] = {
                    "recent_failures": sum(1 for ok in buf if not ok),
                    "window": len(buf),
                }
        return {
            "tracked_pools": len(self._buffers),
            "degraded": degraded,
        }
