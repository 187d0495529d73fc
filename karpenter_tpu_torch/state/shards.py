"""State-plane sharding: the hash partition every sharded seam shares.

Copy of `karpenter_tpu/state/shards.py`, whole.

The state plane is sharded — the watch/list pump's logical
streams, the retained-state invalidation domains, and the bind/evict
queues — by ONE consistent hash of the node/claim key, so that a
continuity loss (a 410 on one shard's stream) or a queue drain touches
only the keys that hash to the affected shard. Everything here is a
pure function of the key string: shard routing must be stable across
processes and restarts (retained epochs survive neither, but the
regression suite replays event orders across shard counts and the
routes must agree).

Routing is BY NODE KEY wherever a kind's events affect a node-keyed
retained row: a Pod event routes by the node the pod is bound to (its
usage lands on that node's row), a NodeClaim by its materialized node
name (falling back to the claim name while in flight — exactly the
state key `_state_node_key` answers to in that window). Unbound pods
route by their own key: they touch no retained row, and any stable
route keeps their stream partition consistent. Kinds with fleet-wide
effect (DaemonSet, PodDisruptionBudget, NodePool) are not sharded —
consumers treat their relists as whole-cache events.
"""

from __future__ import annotations

import os
import zlib
from typing import Optional

ENV_SHARDS = "KARPENTER_STATE_SHARDS"
DEFAULT_SHARDS = 8

# kinds whose events are routed by node/claim key; everything else has
# fleet-wide effect and stays on the unsharded (whole-cache) contract
SHARDED_KINDS = frozenset({"Node", "NodeClaim", "Pod"})


def shard_count() -> int:
    """The configured shard count (KARPENTER_STATE_SHARDS, default 8,
    floor 1). Read per call so tests can vary it; long-lived holders
    (clients, queues) capture it at construction."""
    raw = os.environ.get(ENV_SHARDS, "")
    try:
        n = int(raw) if raw else DEFAULT_SHARDS
    except ValueError:
        n = DEFAULT_SHARDS
    return max(1, n)


def shard_of(key: str, shards: Optional[int] = None) -> int:
    """Stable shard for one state key. crc32, not hash(): Python's
    string hash is salted per process, and shard routes must agree
    between the operator that wrote a retained row and the test (or
    restarted operator) replaying the event order."""
    n = shard_count() if shards is None else shards
    if n <= 1:
        return 0
    return zlib.crc32(key.encode()) % n


def route_key(kind: str, obj) -> str:
    """The key an event routes by — the node/claim key whose retained
    row the event can touch (module doc)."""
    if kind == "Pod":
        node = obj.spec.node_name
        return node if node else obj.key
    if kind == "NodeClaim":
        node = obj.status.node_name
        return node if node else obj.metadata.name
    return obj.key


def shard_of_event(kind: str, obj, shards: Optional[int] = None) -> int:
    return shard_of(route_key(kind, obj), shards)
