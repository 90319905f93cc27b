"""Deterministic seeds (own copy of climate2weather_tpu/utils/seeding.py)."""

from __future__ import annotations

import hashlib


def derive_seed(*args) -> int:
    """Stable 31-bit seed from arbitrary hashable components.

    blake2 of ``repr(args)``, not Python's ``hash``, so the value is the same
    across interpreter runs and hosts, and equal to the JAX package's.
    """
    h = hashlib.blake2b(repr(tuple(args)).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") % (1 << 31)
