"""Metrics decorator for the CloudProvider SPI.

Copy of `karpenter_tpu/cloudprovider/metrics.py`.

Counterpart of pkg/cloudprovider/metrics/cloudprovider.go:81-180: every
SPI call is wrapped with duration and error counters labeled by method
and provider.
"""

from __future__ import annotations

import time

from karpenter_tpu_torch.cloudprovider.types import CloudProvider
from karpenter_tpu_torch.metrics.store import REGISTRY

DURATION = REGISTRY.histogram(
    "karpenter_cloudprovider_duration_seconds",
    "Duration of cloud provider method calls",
)
ERRORS = REGISTRY.counter(
    "karpenter_cloudprovider_errors_total",
    "Cloud provider method errors",
)


class MetricsCloudProvider(CloudProvider):
    def __init__(self, inner: CloudProvider):
        self.inner = inner

    def _call(self, method: str, fn, *args, **kwargs):
        labels = {"method": method, "provider": self.inner.name()}
        start = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        except Exception as err:
            ERRORS.inc({**labels, "error": type(err).__name__})
            raise
        finally:
            DURATION.observe(time.perf_counter() - start, labels)

    def create(self, node_claim):
        return self._call("Create", self.inner.create, node_claim)

    def delete(self, node_claim):
        return self._call("Delete", self.inner.delete, node_claim)

    def get(self, provider_id):
        return self._call("Get", self.inner.get, provider_id)

    def list(self):
        return self._call("List", self.inner.list)

    def get_instance_types(self, node_pool):
        return self._call("GetInstanceTypes", self.inner.get_instance_types, node_pool)

    def is_drifted(self, node_claim):
        return self._call("IsDrifted", self.inner.is_drifted, node_claim)

    def repair_policies(self):
        return self.inner.repair_policies()

    # spot-tier hooks (optional on the SPI): forwarded so controllers
    # handed the decorated provider still see the notice/price surface
    def reprice(self, now):
        fn = getattr(self.inner, "reprice", None)
        return 0 if fn is None else fn(now)

    def poll_interruptions(self, now=None):
        fn = getattr(self.inner, "poll_interruptions", None)
        return [] if fn is None else self._call("PollInterruptions", fn, now)

    @property
    def interrupted(self):
        return getattr(self.inner, "interrupted", set())

    def name(self):
        return self.inner.name()

    def get_supported_node_classes(self):
        return self.inner.get_supported_node_classes()
