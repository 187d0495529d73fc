"""Kubernetes resource-quantity parsing and arithmetic.

Copy of `karpenter_tpu/utils/quantity.py`.

Replaces apimachinery's `resource.Quantity` (used throughout the
reference, e.g. pkg/utils/resources/resources.go) with plain floats in
canonical units: cpu is measured in cores (float), memory/storage in
bytes (float), everything else in counts. Parsing accepts the k8s
suffix grammar ("100m", "1536Mi", "2Gi", "1e3", plain ints).
"""

from __future__ import annotations

import math
import re

_DECIMAL_SUFFIXES = {
    "n": 1e-9,
    "u": 1e-6,
    "m": 1e-3,
    "": 1.0,
    "k": 1e3,
    "M": 1e6,
    "G": 1e9,
    "T": 1e12,
    "P": 1e15,
    "E": 1e18,
}
_BINARY_SUFFIXES = {
    "Ki": 2**10,
    "Mi": 2**20,
    "Gi": 2**30,
    "Ti": 2**40,
    "Pi": 2**50,
    "Ei": 2**60,
}

_QUANTITY_RE = re.compile(
    r"^\s*([+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)\s*"
    r"(n|u|m|k|M|G|T|P|E|Ki|Mi|Gi|Ti|Pi|Ei)?\s*$"
)


def parse_quantity(value: str | int | float) -> float:
    """Parse a k8s quantity string into a float in canonical units."""
    if isinstance(value, (int, float)):
        return float(value)
    match = _QUANTITY_RE.match(value)
    if match is None:
        raise ValueError(f"invalid quantity {value!r}")
    number, suffix = match.groups()
    suffix = suffix or ""
    scale = _BINARY_SUFFIXES.get(suffix) or _DECIMAL_SUFFIXES[suffix]
    return float(number) * scale


def format_quantity(value: float) -> str:
    """Render a canonical float back to a compact k8s-style string."""
    if value == 0:
        return "0"
    if value == int(value):
        intval = int(value)
        for suffix, scale in (("Gi", 2**30), ("Mi", 2**20), ("Ki", 2**10)):
            if intval % scale == 0 and intval >= scale:
                return f"{intval // scale}{suffix}"
        return str(intval)
    milli = value * 1000
    if math.isclose(milli, round(milli)):
        return f"{round(milli)}m"
    return repr(value)
