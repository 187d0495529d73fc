"""Conflict/throttle-aware retry policy for kube API requests.

Copy of `karpenter_tpu/kube/retry.py`.

Counterpart of client-go's rest.Request retry + controller-runtime's
RetryOnConflict: the reference controllers never see a transient 429
or a racy 409 — the client machinery re-reads and re-applies under
bounded backoff, and only a persistent failure surfaces. RealKubeClient
funnels every transport request through `RetryPolicy.execute` so this
module is the ONE place that decides what retries, how long, and with
what jitter (tests/test_kube_write_sites.py statically enforces the
funnel).

Semantics per status:

- 409 Conflict   -> the caller's `on_conflict` hook runs (targeted
                    re-GET + read-modify-write re-apply of the caller's
                    mutation), then the request retries. No hook, or a
                    hook returning False, makes the 409 terminal —
                    create-conflicts ("already exists") are semantic,
                    not transient.
- 429 TooManyRequests -> honored Retry-After (Status
                    details.retryAfterSeconds, where a real apiserver
                    puts it) combined with full-jitter exponential
                    backoff. A PDB-blocked eviction also answers 429
                    but with a DisruptionBudget cause: that one is a
                    policy decision owned by the eviction backoff
                    queue, never retried here.
- 5xx            -> full-jitter exponential backoff and retry (an
                    apiserver riding out an etcd leader election).
- anything else  -> returned to the caller unchanged.

Every retry burns from a per-call wall budget
(KARPENTER_KUBE_RETRY_BUDGET_MS): a throttled API server degrades the
tick (the last response surfaces and the controller requeues) instead
of wedging it.

Knobs (read per call, so tests can flip them without rebuilding
clients):

    KARPENTER_KUBE_RETRY_MAX        attempts per request   (default 5)
    KARPENTER_KUBE_RETRY_BASE_MS    first backoff window   (default 25)
    KARPENTER_KUBE_RETRY_CAP_MS     window cap             (default 1000)
    KARPENTER_KUBE_RETRY_BUDGET_MS  wall budget per call   (default 5000)
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import Callable, Optional

from karpenter_tpu_torch.metrics.store import KUBE_RETRIES
from karpenter_tpu_torch.utils.backoff import capped_exponential, full_jitter

log = logging.getLogger("karpenter.kube.retry")

Attempt = Callable[[], tuple[int, dict]]

_ENV_DEFAULTS = (
    ("KARPENTER_KUBE_RETRY_MAX", 5.0),
    ("KARPENTER_KUBE_RETRY_BASE_MS", 25.0),
    ("KARPENTER_KUBE_RETRY_CAP_MS", 1000.0),
    ("KARPENTER_KUBE_RETRY_BUDGET_MS", 5000.0),
)


def _parse_env(raw: tuple) -> tuple[float, ...]:
    out = []
    for value, (_, default) in zip(raw, _ENV_DEFAULTS):
        try:
            out.append(float(value) if value else default)
        except ValueError:
            out.append(default)
    return tuple(out)


# Freshness probe for the policy cache. This runs on EVERY kube
# request (the <5% healthy-path guard), and os.environ.get pays
# ~1.3us/key in codec wrappers — on POSIX, read the raw bytes->bytes
# backing dict instead (~0.1us/key); values only need decoding on an
# actual cache miss.
try:
    _RAW_ENV = os.environ._data  # type: ignore[attr-defined]
    # encodekey is what _Environ.__getitem__ itself applies (bytes on
    # POSIX, upcased str on Windows) — hand-encoding would silently
    # miss every knob on str-keyed platforms
    _RAW_KEYS = tuple(
        os.environ.encodekey(key)  # type: ignore[attr-defined]
        for key, _ in _ENV_DEFAULTS
    )

    def _probe_env() -> tuple:
        get = _RAW_ENV.get
        return (get(_RAW_KEYS[0]), get(_RAW_KEYS[1]),
                get(_RAW_KEYS[2]), get(_RAW_KEYS[3]))

    def _decode_probe(raw: tuple) -> tuple:
        return tuple(
            v.decode(errors="replace") if isinstance(v, bytes) else v
            for v in raw
        )
except AttributeError:  # non-POSIX / exotic environ: plain reads
    def _probe_env() -> tuple:
        get = os.environ.get
        return tuple(get(key) for key, _ in _ENV_DEFAULTS)

    def _decode_probe(raw: tuple) -> tuple:
        return raw


def retry_after_seconds(body: dict) -> float:
    """Retry-After as a real apiserver ships it: Status
    details.retryAfterSeconds (HTTPTransport also folds the header in
    there)."""
    try:
        return float((body.get("details") or {}).get("retryAfterSeconds", 0))
    except (TypeError, ValueError):
        return 0.0


def is_pdb_eviction_block(body: dict) -> bool:
    """A 429 from the eviction subresource whose cause is a
    DisruptionBudget: policy, not load — the eviction queue owns its
    backoff."""
    causes = (body.get("details") or {}).get("causes") or []
    return any(c.get("reason") == "DisruptionBudget" for c in causes)


@dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 5
    base_seconds: float = 0.025
    cap_seconds: float = 1.0
    budget_seconds: float = 5.0

    @classmethod
    def current(cls) -> "RetryPolicy":
        """The env-configured policy, cached against the RAW env
        strings — this sits on every kube request's healthy path (the
        <5% overhead guard in test_perf_floor.py), so the cache check
        is four dict reads and a tuple compare, no parsing."""
        global _cached
        raw = _probe_env()
        if _cached is None or _cached[0] != raw:
            env = _parse_env(_decode_probe(raw))
            _cached = (raw, cls(
                max_attempts=max(1, int(env[0])),
                base_seconds=env[1] / 1000.0,
                cap_seconds=env[2] / 1000.0,
                budget_seconds=env[3] / 1000.0,
            ))
        return _cached[1]

    # verbs whose requests land a flight-recorder span (with retry
    # counts) on the open tick trace; reads stay span-free — a LIST
    # per tick per kind would swamp the ring with healthy noise
    WRITE_VERBS = frozenset(
        {"create", "update", "delete", "evict", "bind", "patch"})

    def execute(
        self,
        verb: str,
        attempt: Attempt,
        on_conflict: Optional[Callable[..., bool]] = None,
        sleep=time.sleep,
        clock=time.monotonic,
    ) -> tuple[int, dict]:
        """Run `attempt` (-> (status, body)) under the retry semantics
        above; returns the final response. `verb` labels the metric
        series (create/update/delete/evict/bind/get/list).
        `on_conflict` receives the statuses seen so far in this call
        (the current 409 included) — a 409 right after a 5xx is how a
        lost-response write that actually landed announces itself, and
        the hook must be able to tell that apart from a genuine race.

        Write verbs record a span on the open tick trace carrying the
        final status and the retry count — the per-write provenance
        the aggregate karpenter_kube_retries_total cannot give."""
        if verb in self.WRITE_VERBS:
            from karpenter_tpu_torch import tracing

            with tracing.span(f"kube.{verb}") as sp:
                status, body, retries = self._execute(
                    verb, attempt, on_conflict, sleep, clock)
                sp.annotate(status=status, retries=retries)
            return status, body
        status, body, _ = self._execute(
            verb, attempt, on_conflict, sleep, clock)
        return status, body

    def _execute(
        self,
        verb: str,
        attempt: Attempt,
        on_conflict: Optional[Callable[..., bool]] = None,
        sleep=time.sleep,
        clock=time.monotonic,
    ) -> tuple[int, dict, int]:
        deadline = clock() + self.budget_seconds
        history: list[int] = []
        retries = 0
        status, body = attempt()
        for tries in range(1, self.max_attempts):
            history.append(status)
            if status == 409:
                if on_conflict is None or not on_conflict(tuple(history)):
                    return status, body, retries
                KUBE_RETRIES.inc({"verb": verb, "status": "409"})
            elif status == 429:
                if is_pdb_eviction_block(body):
                    return status, body, retries
                KUBE_RETRIES.inc({"verb": verb, "status": "429"})
                wait = max(
                    retry_after_seconds(body),
                    full_jitter(capped_exponential(
                        tries, self.base_seconds, self.cap_seconds)),
                )
                if clock() + wait > deadline:
                    break
                sleep(wait)
            elif status >= 500:
                KUBE_RETRIES.inc({"verb": verb, "status": str(status)})
                wait = full_jitter(capped_exponential(
                    tries, self.base_seconds, self.cap_seconds))
                if clock() + wait > deadline:
                    break
                sleep(wait)
            else:
                return status, body, retries
            if clock() > deadline:
                break
            retries += 1
            status, body = attempt()
        if status in (409, 429) or status >= 500:
            log.warning("kube %s still failing after retries: HTTP %s %s",
                        verb, status, (body or {}).get("message", ""))
        return status, body, retries


_cached: Optional[tuple[tuple, RetryPolicy]] = None
