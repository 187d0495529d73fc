"""Duration and cron-schedule helpers.

Copy of `karpenter_tpu/utils/duration.py`, whole, with its imports pointed into
`karpenter_tpu_torch`.

`parse_duration` accepts Go-style duration strings ("30s", "5m", "1h",
"1h30m") plus the CRD sentinel "Never" (returns None). `CronSchedule`
is a minimal 5-field cron matcher covering the reference's
NodePool.Budget schedule windows (robfig/cron semantics for the subset
used: numbers, ranges, steps, lists, `*`, and @hourly/@daily/@weekly/
@monthly/@yearly shortcuts).
"""

from __future__ import annotations

import re
import time as _time
from dataclasses import dataclass
from typing import Optional

_DUR_RE = re.compile(r"([0-9]*\.?[0-9]+)(ns|us|ms|s|m|h|d)")
_UNITS = {"ns": 1e-9, "us": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}


def parse_duration(value: str | int | float | None) -> Optional[float]:
    """Duration string -> seconds; "Never"/None -> None."""
    if value is None:
        return None
    if isinstance(value, (int, float)):
        return float(value)
    if value == "Never" or value == "":
        return None
    pos = 0
    total = 0.0
    for match in _DUR_RE.finditer(value):
        if match.start() != pos:
            raise ValueError(f"invalid duration {value!r}")
        total += float(match.group(1)) * _UNITS[match.group(2)]
        pos = match.end()
    if pos != len(value):
        raise ValueError(f"invalid duration {value!r}")
    return total


def format_duration(seconds: Optional[float]) -> str:
    if seconds is None:
        return "Never"
    if seconds >= 3600 and seconds % 3600 == 0:
        return f"{int(seconds // 3600)}h"
    if seconds >= 60 and seconds % 60 == 0:
        return f"{int(seconds // 60)}m"
    return f"{seconds:g}s"


_SHORTCUTS = {
    "@hourly": "0 * * * *",
    "@daily": "0 0 * * *",
    "@midnight": "0 0 * * *",
    "@weekly": "0 0 * * 0",
    "@monthly": "0 0 1 * *",
    "@yearly": "0 0 1 1 *",
    "@annually": "0 0 1 1 *",
}

_DOW_NAMES = {"sun": 0, "mon": 1, "tue": 2, "wed": 3, "thu": 4, "fri": 5, "sat": 6}
_MON_NAMES = {
    "jan": 1, "feb": 2, "mar": 3, "apr": 4, "may": 5, "jun": 6,
    "jul": 7, "aug": 8, "sep": 9, "oct": 10, "nov": 11, "dec": 12,
}


def _parse_field(field: str, lo: int, hi: int, names: dict[str, int]) -> set[int]:
    out: set[int] = set()
    for part in field.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
        if part in ("*", ""):
            start, end = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            start = names.get(a.lower(), None) if not a.isdigit() else int(a)
            end = names.get(b.lower(), None) if not b.isdigit() else int(b)
            if start is None or end is None:
                raise ValueError(f"bad cron field {part!r}")
        else:
            val = names.get(part.lower()) if not part.isdigit() else int(part)
            if val is None:
                raise ValueError(f"bad cron field {part!r}")
            start = end = val
        out.update(range(start, end + 1, step))
    return out


@dataclass
class CronSchedule:
    minutes: set[int]
    hours: set[int]
    days: set[int]
    months: set[int]
    weekdays: set[int]

    @classmethod
    def parse(cls, expr: str) -> "CronSchedule":
        expr = _SHORTCUTS.get(expr.strip(), expr.strip())
        fields = expr.split()
        if len(fields) != 5:
            raise ValueError(f"cron expression must have 5 fields: {expr!r}")
        return cls(
            minutes=_parse_field(fields[0], 0, 59, {}),
            hours=_parse_field(fields[1], 0, 23, {}),
            days=_parse_field(fields[2], 1, 31, {}),
            months=_parse_field(fields[3], 1, 12, _MON_NAMES),
            weekdays=_parse_field(fields[4], 0, 6, _DOW_NAMES),
        )

    def matches(self, ts: float) -> bool:
        tm = _time.gmtime(ts)
        weekday = (tm.tm_wday + 1) % 7  # go Sunday=0
        return (
            tm.tm_min in self.minutes
            and tm.tm_hour in self.hours
            and tm.tm_mday in self.days
            and tm.tm_mon in self.months
            and weekday in self.weekdays
        )

    def last_fire_before(self, ts: float) -> Optional[float]:
        """Most recent minute boundary <= ts matching the schedule.

        Scans back minute-by-minute bounded to 366 days (cron has at
        least one match per year for valid expressions we accept).
        """
        minute = int(ts // 60) * 60
        for _ in range(366 * 24 * 60):
            if self.matches(minute):
                return float(minute)
            minute -= 60
        return None
