"""Power-of-two ndata suffixes (own copy of climate2weather_tpu/utils/ndata.py):
intervals and budgets count training examples, with optional Ki/Mi/Gi."""

from __future__ import annotations

_SUFFIXES = ((30, "Gi"), (20, "Mi"), (10, "Ki"))


def parse_ndata(s) -> int:
    """Parse an int with optional suffix: Ki=2^10, Mi=2^20, Gi=2^30."""
    if isinstance(s, int):
        return s
    s = str(s)
    for shift, suffix in _SUFFIXES:
        if s.endswith(suffix):
            return int(s[:-2]) << shift
    return int(s)


def format_ndata(n: int) -> str:
    """Inverse of :func:`parse_ndata` for printing (exact only)."""
    for shift, suffix in _SUFFIXES:
        if n and n % (1 << shift) == 0:
            return f"{n >> shift}{suffix}"
    return str(n)
