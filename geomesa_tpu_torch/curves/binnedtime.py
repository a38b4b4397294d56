"""Epoch-binned time: millis → (bin: int16, offset: int64).

Semantics match the reference's BinnedTime
(GeoMesa geomesa-z3/.../BinnedTime.scala):

  period  bin unit            offset unit   max offset
  day     days since epoch    millis        86_400_000
  week    weeks since epoch   seconds       604_800
  month   months since epoch  seconds       86_400 * 31
  year    years since epoch   minutes       1440 * 366 + 10

Bins are computed against the UTC java epoch; month/year bins are *calendar*
months/years (via numpy datetime64[M]/[Y] truncation, which agrees with
ChronoUnit.MONTHS/YEARS.between from a midnight-of-jan-1 epoch). All functions
are vectorized over int64 epoch-millis arrays.
"""

from __future__ import annotations

import enum

import numpy as np


class TimePeriod(enum.Enum):
    DAY = "day"
    WEEK = "week"
    MONTH = "month"
    YEAR = "year"

    @classmethod
    def parse(cls, s: "str | TimePeriod") -> "TimePeriod":
        if isinstance(s, TimePeriod):
            return s
        return cls(s.lower())


_DAY_MS = 86_400_000
_WEEK_MS = 7 * _DAY_MS


def max_offset(period: TimePeriod) -> int:
    """Max offset value (exclusive upper bound for normalization) per period.

    Mirrors BinnedTime.maxOffset (BinnedTime.scala:148-156), including the
    year fudge factor for leap seconds.
    """
    period = TimePeriod.parse(period)
    if period is TimePeriod.DAY:
        return _DAY_MS
    if period is TimePeriod.WEEK:
        return _WEEK_MS // 1000
    if period is TimePeriod.MONTH:
        return (_DAY_MS // 1000) * 31
    return 1440 * 366 + 10  # minutes in a leap year + leap-second fudge


def time_to_binned_time(millis, period: TimePeriod):
    """Vectorized millis → (bin int64, offset int64).

    Negative (pre-epoch) times are a caller error, mirroring the reference's
    require(); we do not raise here — the lenient/strict decision lives in the
    SFC layer — but results for negative inputs are unspecified.
    """
    period = TimePeriod.parse(period)
    millis = np.asarray(millis, dtype=np.int64)
    if period is TimePeriod.DAY:
        bins = millis // _DAY_MS
        offsets = millis - bins * _DAY_MS
    elif period is TimePeriod.WEEK:
        bins = millis // _WEEK_MS
        offsets = (millis - bins * _WEEK_MS) // 1000
    else:
        dt = millis.astype("datetime64[ms]")
        unit = "M" if period is TimePeriod.MONTH else "Y"
        bins = dt.astype(f"datetime64[{unit}]").astype(np.int64)
        start_ms = bins.astype(f"datetime64[{unit}]").astype("datetime64[ms]").astype(np.int64)
        if period is TimePeriod.MONTH:
            offsets = (millis - start_ms) // 1000
        else:
            offsets = (millis - start_ms) // 60_000
    return bins, offsets

