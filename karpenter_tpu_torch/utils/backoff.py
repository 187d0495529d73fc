"""Shared retry-backoff math: capped exponential windows and the
desynchronizing jitter factor.

Every retry site in the control plane (eviction 429s, watch
reconnects, nodeclaim launch failures, solver-service and resilience
breakers) backs off through these two primitives, so the jitter band
and cap semantics can never silently diverge between sites — the
failure mode that makes a fleet retry in lockstep again one audit
later.
"""

from __future__ import annotations

import random as _random
from typing import Optional


def jitter(rng: Optional[_random.Random] = None) -> float:
    """Desynchronizing multiplier in [0.5, 1.0): cuts the window by at
    most half (so backoff stays a backoff) while spreading a cohort
    tripped by the same event across half the window."""
    return 0.5 + 0.5 * (rng or _random).random()


def full_jitter(window: float, rng: Optional[_random.Random] = None) -> float:
    """Full-jitter wait in [0, window): the AWS-architecture-blog
    variant for API-server retry storms, where spreading a throttled
    cohort across the WHOLE window (including ~0) empties the server's
    queue fastest. Use `jitter` instead when the wait must remain a
    lower-bounded backoff (breaker cooldowns, reconnects)."""
    return window * (rng or _random).random()


def capped_exponential(
    attempts: int, base: float, cap: float, max_exp: int = 16
) -> float:
    """The n-th (1-based) consecutive failure's backoff window:
    base * 2^(n-1), saturating at `cap` (exponent clamped long before
    float overflow)."""
    return min(cap, base * 2 ** min(max(attempts - 1, 0), max_exp))
