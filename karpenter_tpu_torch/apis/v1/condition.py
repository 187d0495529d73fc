"""Status conditions with transition tracking.

Copy of `karpenter_tpu/apis/v1/condition.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

Counterpart of operatorpkg status conditions used throughout the
reference's CRD statuses (Launched/Registered/Initialized/...).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

TRUE = "True"
FALSE = "False"
UNKNOWN = "Unknown"


@dataclass
class Condition:
    type: str
    status: str = UNKNOWN
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0
    observed_generation: int = 0


@dataclass
class ConditionSet:
    """A set of typed conditions; Ready aggregates the root types."""

    conditions: list[Condition] = field(default_factory=list)
    root_types: list[str] = field(default_factory=list)

    def get(self, ctype: str) -> Optional[Condition]:
        for cond in self.conditions:
            if cond.type == ctype:
                return cond
        return None

    def set(
        self,
        ctype: str,
        status: str,
        reason: str = "",
        message: str = "",
        now: Optional[float] = None,
    ) -> bool:
        """Set a condition; returns True if status transitioned."""
        now = time.time() if now is None else now
        cond = self.get(ctype)
        if cond is None:
            self.conditions.append(
                Condition(type=ctype, status=status, reason=reason, message=message,
                          last_transition_time=now)
            )
            return True
        changed = cond.status != status
        cond.reason = reason
        cond.message = message
        if changed:
            cond.status = status
            cond.last_transition_time = now
        return changed

    def set_true(self, ctype: str, reason: str = "", now: Optional[float] = None) -> bool:
        return self.set(ctype, TRUE, reason or ctype, now=now)

    def set_false(self, ctype: str, reason: str = "", message: str = "",
                  now: Optional[float] = None) -> bool:
        return self.set(ctype, FALSE, reason, message, now=now)

    def clear(self, ctype: str) -> bool:
        for i, cond in enumerate(self.conditions):
            if cond.type == ctype:
                del self.conditions[i]
                return True
        return False

    def is_true(self, ctype: str) -> bool:
        cond = self.get(ctype)
        return cond is not None and cond.status == TRUE

    def is_false(self, ctype: str) -> bool:
        cond = self.get(ctype)
        return cond is not None and cond.status == FALSE

    def root(self) -> Condition:
        """Aggregate Ready condition over the declared root types."""
        for ctype in self.root_types:
            cond = self.get(ctype)
            if cond is None or cond.status == UNKNOWN:
                return Condition(type="Ready", status=UNKNOWN, reason="AwaitingReconciliation")
            if cond.status == FALSE:
                return Condition(type="Ready", status=FALSE, reason=cond.reason or cond.type)
        return Condition(type="Ready", status=TRUE, reason="Ready")
