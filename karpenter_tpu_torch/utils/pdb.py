"""PodDisruptionBudget limits.

Copy of `karpenter_tpu/utils/pdb.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

Counterpart of pkg/utils/pdb (506 LoC): map pods to the PDBs selecting
them and answer "can this pod be evicted right now" / "is this node's
pod set disruptable".
"""

from __future__ import annotations

import math
from typing import Optional

from karpenter_tpu_torch.kube.client import KubeClient
from karpenter_tpu_torch.kube.objects import Pod, PodDisruptionBudget


def _scaled(value: int | str, total: int, round_up: bool) -> int:
    if isinstance(value, int):
        return value
    if value.endswith("%"):
        pct = int(value[:-1])
        scaled = pct * total / 100.0
        return math.ceil(scaled) if round_up else math.floor(scaled)
    return int(value)


class PdbLimits:
    def __init__(self, kube: KubeClient, memoize_allowance: bool = False):
        """`memoize_allowance`: cache disruptions_allowed per PDB for
        this instance's lifetime. ONLY safe for read-only passes over
        a fixed pod population (the disruption candidate scan, which
        constructs a fresh instance per scan and evicts nothing while
        it runs) — eviction loops must keep the default so each
        verdict sees the shrinking budget."""
        self.kube = kube
        self.pdbs = kube.pdbs()
        self._allowance_cache: dict = {} if memoize_allowance else None

    def _matching(self, pod: Pod) -> list[PodDisruptionBudget]:
        return [
            pdb
            for pdb in self.pdbs
            if pdb.metadata.namespace == pod.metadata.namespace
            and pdb.spec.selector.matches(pod.metadata.labels)
        ]

    def matching(self, pod: Pod) -> list[PodDisruptionBudget]:
        """The PDBs selecting this pod — public for callers that plan
        multi-victim evictions (preemption) and must budget a WHOLE
        victim set against each selecting PDB, not just the first
        victim (can_evict is point-in-time per pod)."""
        return self._matching(pod)

    def disruptions_allowed(self, pdb: PodDisruptionBudget) -> int:
        """Compute allowed disruptions from live pod state (the real
        controller-manager maintains status; we derive it)."""
        if self._allowance_cache is not None:
            hit = self._allowance_cache.get(pdb.key)
            if hit is not None:
                return hit
        out = self._disruptions_allowed(pdb)
        if self._allowance_cache is not None:
            self._allowance_cache[pdb.key] = out
        return out

    def _disruptions_allowed(self, pdb: PodDisruptionBudget) -> int:
        pods = [
            p
            for p in self.kube.pods(namespace=pdb.metadata.namespace,
                                    selector=pdb.spec.selector)
            if not p.is_terminal()
        ]
        total = len(pods)
        healthy = sum(1 for p in pods if p.spec.node_name and not p.is_terminating())
        if pdb.spec.max_unavailable is not None:
            max_unavailable = _scaled(pdb.spec.max_unavailable, total, round_up=False)
            unavailable = total - healthy
            return max(0, max_unavailable - unavailable)
        if pdb.spec.min_available is not None:
            min_available = _scaled(pdb.spec.min_available, total, round_up=True)
            return max(0, healthy - min_available)
        return total

    @staticmethod
    def _evictable(pod: Pod, server_side: bool = False) -> bool:
        """pdb.go isEvictable gate via pod.IsEvictable
        (utils/pod/scheduling.go:56-61): pods karpenter will never
        call the eviction API on bypass PDB math entirely — terminal/
        terminating pods, mirror pods (Node-owned), pods tolerating the
        disrupted taint (they ride the node down), and do-not-disrupt
        pods (blocked earlier, by the annotation check).

        `server_side` models the API SERVER's view on the eviction
        subresource instead: it knows nothing of karpenter annotations
        or taints, so only terminal/terminating and mirror pods bypass
        the budget there."""
        from karpenter_tpu_torch.apis.v1.labels import (
            DISRUPTED_NO_SCHEDULE_TAINT,
            DO_NOT_DISRUPT_ANNOTATION,
        )

        if pod.is_terminal() or pod.is_terminating():
            return False
        if pod.owner_kind() == "Node":
            return False
        if server_side:
            return True
        if pod.metadata.annotations.get(DO_NOT_DISRUPT_ANNOTATION) == "true":
            return False
        from karpenter_tpu_torch.scheduling.taints import tolerates_pod

        return tolerates_pod([DISRUPTED_NO_SCHEDULE_TAINT], pod) is not None

    def can_evict(self, pod: Pod, server_side: bool = False) -> Optional[str]:
        """None if eviction is permitted, else the blocking PDB
        name(s). Kubernetes refuses eviction outright when MULTIPLE
        PDBs select one pod (eviction.go:L226 upstream), budgets
        notwithstanding — pdb.go:98-103."""
        if not self._evictable(pod, server_side=server_side):
            return None
        matching = self._matching(pod)
        if len(matching) > 1:
            return ",".join(sorted(p.key for p in matching))
        for pdb in matching:
            if self.disruptions_allowed(pdb) <= 0:
                return pdb.key
        return None

