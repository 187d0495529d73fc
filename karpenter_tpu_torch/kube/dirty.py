"""Watch-driven dirty tracking for incremental controller reconciles.

Copy of `karpenter_tpu/kube/dirty.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

The reference is watch-driven end to end (controllers.go:85-106): a
controller touches an object only when an informer event names it. The
tick-driven runtime here gets the same property via this tracker: each
controller owns one, subscribes it to the kinds it cares about, and
each tick drains only the keys that changed since the last drain —
O(changes) instead of O(cluster) per tick. `KubeClient.watch` replays
current state on subscribe (the informer initial LIST), so the first
drain after startup is a full pass.

In-place mutations bypass the API server analogue and therefore emit
no watch events; controllers that mutate objects in place call
`KubeClient.touch` so every tracker sees the change (the reference has
no such path — every write goes through the API server — which is
exactly the property touch() restores).

Two extensions serve retained-state consumers (the provisioner's
incremental live tick):

- `watch(kind, key=fn)` maps each event to DERIVED keys (e.g. a Pod
  event dirties the NODE the pod is bound to), so a consumer keyed by
  one kind can be fed from events of another.
- `relisted(kind)` latches 410-driven relists: a watch_gone re-LIST
  means the watch stream fell off the server's event horizon, so the
  diff-based relist events CANNOT be trusted to name every change the
  stale window hid (the mirror's rv guard suppresses echoes, and a
  change-then-change-back is invisible to a diff). A retained-state
  consumer must treat such a relist as "everything dirty" and rebuild —
  correctness over incrementality, exactly once per relist. Snapshot
  transports re-LIST every pump BY DESIGN — their diff events are the
  primary event stream, not a recovery path — so they never advance
  the generation (marking everything dirty every pump would erase
  incrementality entirely).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from karpenter_tpu_torch.kube.client import KubeClient

# key-mapping hook: (event, obj) -> derived dirty keys
KeyFn = Callable[[str, object], Iterable[str]]


class DirtyTracker:
    def __init__(self, kube: KubeClient):
        self.kube = kube
        self._sets: dict[str, set[str]] = {}
        self._watched: set[str] = set()
        # dirty-wake hooks: cheap callables fired when a
        # watched kind gains a dirty key, so an event-driven loop can
        # sleep on an Event instead of polling peek()
        self._hooks: list[Callable[[], None]] = []
        # last relist generation observed per kind (clients that never
        # relist — the in-memory substrate — simply never advance it)
        self._relist_gen: dict[str, int] = {}
        # last PER-SHARD relist generation observed, (kind, shard) ->
        # gen — the sharded state plane's scoped continuity latch
        self._shard_gen: dict[tuple[str, int], int] = {}

    def watch(self, *kinds: str, key: Optional[KeyFn] = None) -> "DirtyTracker":
        for kind in kinds:
            if kind in self._watched:
                continue
            self._watched.add(kind)
            self._sets.setdefault(kind, set())

            def handler(event: str, obj, _k: str = kind,
                        _key: Optional[KeyFn] = key) -> None:
                if _key is None:
                    self._sets[_k].add(obj.key)
                else:
                    self._sets[_k].update(_key(event, obj))
                for hook in self._hooks:
                    hook()

            self.kube.watch(kind, handler)
        return self

    def on_dirty(self, hook: Callable[[], None]) -> "DirtyTracker":
        """Register a cheap, exception-free callable (e.g.
        threading.Event.set) fired on every event a watched kind
        receives — the reactive wake seam for consumers that sleep
        between ticks and only want to run when O(dirty) work exists."""
        self._hooks.append(hook)
        return self

    def mark(self, kind: str, key: str) -> None:
        self._sets.setdefault(kind, set()).add(key)

    def drain(self, kind: str) -> set[str]:
        out = self._sets.get(kind, set())
        self._sets[kind] = set()
        return out

    def peek(self, kind: str) -> set[str]:
        return set(self._sets.get(kind, set()))

    def relisted(self, *kinds: str) -> bool:
        """True once per 410-driven relist of any of `kinds` since the
        last call — the signal that the event stream lost continuity
        and a retained-state consumer must mark EVERYTHING dirty.
        Reads the client's per-kind relist generation (RealKubeClient
        increments it only on watch_gone re-LISTs; snapshot pumps
        re-LIST every cycle by design and never advance it); clients
        without one never relist."""
        gen_of = getattr(self.kube, "relist_generation", None)
        if gen_of is None:
            return False
        hit = False
        for kind in kinds:
            gen = gen_of(kind)
            if gen != self._relist_gen.get(kind, 0):
                self._relist_gen[kind] = gen
                hit = True
        return hit

    def relisted_shards(self, *kinds: str) -> Optional[set[int]]:
        """Shard-scoped continuity latch: the set of shard
        ids whose relist epoch advanced for any of `kinds` since the
        last call — each named shard's retained keys must be treated as
        dirty, while every OTHER shard's rows stay warm. Returns None
        when a relist happened but the client cannot scope it (no
        per-shard epochs — the merged contract's conservative reading:
        everything dirty). Returns an empty set when nothing relisted.

        Latches the merged per-kind generation alongside the shard
        generations, so mixing `relisted_shards` and `relisted` over
        the same kinds never double-fires for one relist."""
        gens_of = getattr(self.kube, "relist_generations", None)
        if gens_of is None:
            return None if self.relisted(*kinds) else set()
        out: set[int] = set()
        for kind in kinds:
            for shard, gen in gens_of(kind).items():
                if gen != self._shard_gen.get((kind, shard), 0):
                    self._shard_gen[(kind, shard)] = gen
                    out.add(shard)
        gen_of = getattr(self.kube, "relist_generation", None)
        if gen_of is not None:
            for kind in kinds:
                self._relist_gen[kind] = gen_of(kind)
        return out

    def clear(self) -> None:
        """Drop all pending dirt without reporting it (used after a
        consumer rebuilt its state from scratch — a relist or a full
        cache bust — so stale keys don't force a second rebuild)."""
        for kind in self._sets:
            self._sets[kind] = set()
