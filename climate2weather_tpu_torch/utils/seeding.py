"""Deterministic seeds (own copy of climate2weather_tpu/utils/seeding.py)."""

from __future__ import annotations

import hashlib
import random

import numpy as np


def derive_seed(*args) -> int:
    """Stable 31-bit seed from arbitrary hashable components.

    blake2 of ``repr(args)``, not Python's ``hash``, so the value is the same
    across interpreter runs and hosts, and equal to the JAX package's.
    """
    h = hashlib.blake2b(repr(tuple(args)).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") % (1 << 31)


def set_random_seed(seed: int, *extra) -> int:
    """Seed Python's and numpy's global RNGs from ``derive_seed(seed,
    *extra)`` and return that seed."""
    s = derive_seed(seed, *extra)
    random.seed(s)
    np.random.seed(s)
    return s
