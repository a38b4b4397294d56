"""Z2 / Z3 space-filling curves (≙ reference Z2SFC.scala / Z3SFC.scala).

Vectorized over numpy arrays; strict bounds checking with a ``lenient`` clamp
escape hatch, matching the reference's index()/lenientIndex() pair
(Z2SFC.scala:27-41, Z3SFC.scala:32-47), and the array-form z-range covers
the staged path's range pruner reads (``ranges_arrays``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from geomesa_tpu_torch.curves import zorder
from geomesa_tpu_torch.curves.binnedtime import TimePeriod, max_offset
from geomesa_tpu_torch.curves.normalize import (NormalizedLat, NormalizedLon,
                                                NormalizedTime)
from geomesa_tpu_torch.curves.ranges import (IndexRange, to_ranges,
                                             zranges_2d_arrays,
                                             zranges_3d_arrays)


class Z2SFC:
    """2-D Morton curve over lon/lat, 31 bits/dim by default."""

    def __init__(self, precision: int = 31):
        self.precision = precision
        self.lon = NormalizedLon(precision)
        self.lat = NormalizedLat(precision)

    def _check(self, x, y, lenient: bool):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        oob = (x < self.lon.min) | (x > self.lon.max) | (y < self.lat.min) | (y > self.lat.max)
        if np.any(oob):
            if not lenient:
                raise ValueError(
                    f"Value(s) out of bounds ([{self.lon.min},{self.lon.max}], "
                    f"[{self.lat.min},{self.lat.max}])")
            x, y = self.lon.clamp(x), self.lat.clamp(y)
        return x, y

    def normalize(self, x, y, lenient: bool = False):
        """(lon, lat) → per-dim normalized ints (the device-resident coords)."""
        x, y = self._check(x, y, lenient)
        return self.lon.normalize(x), self.lat.normalize(y)

    def index(self, x, y, lenient: bool = False):
        xi, yi = self.normalize(x, y, lenient)
        return zorder.z2_encode(xi, yi)

    def ranges(
        self,
        xy: Sequence[Tuple[float, float, float, float]],
        max_ranges: Optional[int] = None,
        max_levels: int = 64,
    ) -> List[IndexRange]:
        """Cover (xmin, ymin, xmax, ymax) user-space boxes with z ranges."""
        return to_ranges(self.ranges_arrays(xy, max_ranges, max_levels))

    def ranges_arrays(self, xy, max_ranges: Optional[int] = None,
                      max_levels: int = 64):
        """Array-form cover (lo, hi, contained) — the query-planning hot
        path (feeds prune.ranges_to_slices without per-range objects)."""
        boxes = []
        for xmin, ymin, xmax, ymax in xy:
            xlo, ylo = self.normalize(xmin, ymin)
            xhi, yhi = self.normalize(xmax, ymax)
            boxes.append((int(xlo), int(ylo), int(xhi), int(yhi)))
        return zranges_2d_arrays(boxes, self.precision, max_ranges or 2000,
                                 max_levels)


class Z3SFC:
    """3-D Morton curve over (lon, lat, binned time offset), 21 bits/dim.

    One instance per TimePeriod, as in the reference (Z3SFC.scala:65-77);
    time normalization runs over [0, max_offset(period)].
    """

    _cache: dict = {}

    def __init__(self, period: TimePeriod, precision: int = 21):
        if not (0 < precision < 22):
            raise ValueError("Precision (bits) per dimension must be in [1,21]")
        self.period = TimePeriod.parse(period)
        self.precision = precision
        self.lon = NormalizedLon(precision)
        self.lat = NormalizedLat(precision)
        self.time = NormalizedTime(precision, float(max_offset(self.period)))

    @classmethod
    def apply(cls, period: TimePeriod) -> "Z3SFC":
        period = TimePeriod.parse(period)
        if period not in cls._cache:
            cls._cache[period] = cls(period)
        return cls._cache[period]

    def _check(self, x, y, t, lenient: bool):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        t = np.asarray(t, dtype=np.float64)
        oob = (
            (x < self.lon.min) | (x > self.lon.max)
            | (y < self.lat.min) | (y > self.lat.max)
            | (t < self.time.min) | (t > self.time.max)
        )
        if np.any(oob):
            if not lenient:
                raise ValueError("Value(s) out of bounds for z3 index")
            x, y, t = self.lon.clamp(x), self.lat.clamp(y), self.time.clamp(t)
        return x, y, t

    def normalize(self, x, y, t, lenient: bool = False):
        x, y, t = self._check(x, y, t, lenient)
        return self.lon.normalize(x), self.lat.normalize(y), self.time.normalize(t)

    def index(self, x, y, t, lenient: bool = False):
        """x/y in degrees, t = offset *within the time bin* (period units)."""
        xi, yi, ti = self.normalize(x, y, t, lenient)
        return zorder.z3_encode(xi, yi, ti)

    def ranges(
        self,
        xy: Sequence[Tuple[float, float, float, float]],
        t: Sequence[Tuple[int, int]],
        max_ranges: Optional[int] = None,
        max_levels: int = 64,
    ) -> List[IndexRange]:
        """Cover the cross product of lon/lat boxes and in-bin time windows
        (the explain path; planning uses ``ranges_arrays``)."""
        return to_ranges(self.ranges_arrays(xy, t, max_ranges, max_levels))

    def ranges_arrays(self, xy, t, max_ranges: Optional[int] = None,
                      max_levels: int = 64):
        """Array-form cover (lo, hi, contained) of the cross product of
        lon/lat boxes ``xy`` and in-bin time windows ``t`` — the
        query-planning path (feeds prune.ranges_to_slices without
        per-range objects)."""
        boxes = []
        for xmin, ymin, xmax, ymax in xy:
            xlo, ylo = self.lon.normalize(xmin), self.lat.normalize(ymin)
            xhi, yhi = self.lon.normalize(xmax), self.lat.normalize(ymax)
            for tmin, tmax in t:
                tlo, thi = self.time.normalize(tmin), self.time.normalize(tmax)
                boxes.append((int(xlo), int(ylo), int(tlo),
                              int(xhi), int(yhi), int(thi)))
        return zranges_3d_arrays(boxes, self.precision, max_ranges or 2000,
                                 max_levels)
