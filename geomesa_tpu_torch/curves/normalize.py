"""Dimension normalization: double in [min,max] → int in [0, 2^precision).

Semantics match the reference's ``BitNormalizedDimension``
(GeoMesa geomesa-z3/.../NormalizedDimension.scala:56-72):
  - normalize: floor((x - min) * bins/(max-min)), with x >= max clamping to
    maxIndex (so the upper bound is inclusive and lands in the last bin)

Vectorized over numpy arrays; pure float64 host math (curve encoding happens
on the host / in f64 islands — device kernels consume the resulting ints).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class BitNormalizedDimension:
    min: float
    max: float
    precision: int

    def __post_init__(self):
        if not (0 < self.precision < 32):
            raise ValueError("Precision (bits) must be in [1,31]")

    @property
    def bins(self) -> int:
        return 1 << self.precision

    @property
    def max_index(self) -> int:
        return self.bins - 1

    def normalize(self, x):
        x = np.asarray(x, dtype=np.float64)
        normalizer = self.bins / (self.max - self.min)
        res = np.floor((x - self.min) * normalizer).astype(np.int64)
        return np.where(x >= self.max, np.int64(self.max_index), res)

    def clamp(self, x):
        """Lenient bounds standardization (reference lenientIndex semantics)."""
        return np.clip(np.asarray(x, dtype=np.float64), self.min, self.max)


def NormalizedLat(precision: int) -> BitNormalizedDimension:
    return BitNormalizedDimension(-90.0, 90.0, precision)


def NormalizedLon(precision: int) -> BitNormalizedDimension:
    return BitNormalizedDimension(-180.0, 180.0, precision)


def NormalizedTime(precision: int, max: float) -> BitNormalizedDimension:
    return BitNormalizedDimension(0.0, max, precision)
