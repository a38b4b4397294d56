"""Vectorized Morton (z-order) bit interleaving.

The reference delegates this to the external ``sfcurve-zorder`` library
(imported at GeoMesa geomesa-z3/.../Z3SFC.scala:13-14); here it is
implemented directly with the standard magic-mask spread, vectorized over
numpy arrays (the host ingest path).

Two layouts, matching the sfcurve ones the reference uses:
  - Z2: two dims × 31 bits → 62-bit keys, x least significant of each pair.
  - Z3: three dims × 21 bits → 63-bit keys, x least significant of each triple.

All functions are pure and shape-polymorphic (scalars or arrays).
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# 2-D spread: 31-bit int -> every-other-bit in a 62-bit word
# ---------------------------------------------------------------------------

_M2 = [
    np.uint64(0x00000000FFFFFFFF),
    np.uint64(0x0000FFFF0000FFFF),
    np.uint64(0x00FF00FF00FF00FF),
    np.uint64(0x0F0F0F0F0F0F0F0F),
    np.uint64(0x3333333333333333),
    np.uint64(0x5555555555555555),
]

_S2 = [np.uint64(32), np.uint64(16), np.uint64(8), np.uint64(4), np.uint64(2), np.uint64(1)]


def spread2(x):
    """Spread the low 32 bits of ``x`` so bit i moves to bit 2i."""
    x = np.asarray(x).astype(np.uint64) & _M2[0]
    for s, m in zip(_S2[1:], _M2[1:]):
        x = (x | (x << s)) & m
    return x


def squash2(x):
    """Inverse of :func:`spread2`: collect even-position bits back together."""
    x = np.asarray(x).astype(np.uint64) & _M2[-1]
    for s, m in zip(reversed(_S2[1:]), reversed([_M2[0]] + _M2[1:-1])):
        x = (x | (x >> s)) & m
    return x


def z2_encode(x, y):
    """Interleave two ≤31-bit non-negative ints into a z2 key (int64)."""
    return (spread2(x) | (spread2(y) << np.uint64(1))).astype(np.int64)


def z2_decode(z):
    """Inverse of :func:`z2_encode` → (x, y) int64 arrays."""
    z = np.asarray(z).astype(np.uint64)
    return squash2(z).astype(np.int64), squash2(z >> np.uint64(1)).astype(np.int64)


# ---------------------------------------------------------------------------
# 3-D spread: 21-bit int -> every-third-bit in a 63-bit word
# ---------------------------------------------------------------------------

_M3 = [
    np.uint64(0x00000000001FFFFF),
    np.uint64(0x001F00000000FFFF),
    np.uint64(0x001F0000FF0000FF),
    np.uint64(0x100F00F00F00F00F),
    np.uint64(0x10C30C30C30C30C3),
    np.uint64(0x1249249249249249),
]

_S3 = [np.uint64(0), np.uint64(32), np.uint64(16), np.uint64(8), np.uint64(4), np.uint64(2)]


def spread3(x):
    """Spread the low 21 bits of ``x`` so bit i moves to bit 3i."""
    x = np.asarray(x).astype(np.uint64) & _M3[0]
    for s, m in zip(_S3[1:], _M3[1:]):
        x = (x | (x << s)) & m
    return x


def z3_encode(x, y, t):
    """Interleave three ≤21-bit non-negative ints into a z3 key (int64)."""
    return (spread3(x) | (spread3(y) << np.uint64(1)) | (spread3(t) << np.uint64(2))).astype(np.int64)

