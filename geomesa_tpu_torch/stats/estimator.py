"""Selectivity estimation from cached sketches.

Copied from ``geomesa_tpu.stats.estimator``
(host-only) with its imports pointed at this package.

≙ reference `StatsBasedEstimator` (geomesa-index-api/.../stats/
StatsBasedEstimator.scala): spatial selectivity from the Z2 grid histogram,
temporal from the Z3 per-bin histogram, equality from the count-min Frequency,
numeric ranges from binned Histograms. Feeds the cost-based strategy decider
(StrategyDecider.scala:140-168) — plans are priced by estimated matching rows.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from geomesa_tpu_torch.curves.binnedtime import TimePeriod, max_offset, time_to_binned_time
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.filter.extract import extract_bboxes, extract_intervals
from geomesa_tpu_torch.stats import sketches as sk


class StatsBasedEstimator:
    """Estimates matching-row counts for filters against one feature type."""

    def __init__(self, sft, stats: Dict[str, sk.Stat], total: int):
        self.sft = sft
        self.stats = stats
        self.total = total
        geom = sft.geometry_attribute
        dtg = sft.dtg_attribute
        self.geom = geom.name if geom else None
        self.dtg = dtg.name if dtg else None

    def _find(self, kind: str, attr: Optional[str] = None):
        return sk.find_stat(self.stats.values(), kind, attr)

    # -- selectivities (fractions of total) ---------------------------------

    def spatial_selectivity(self, boxes) -> Optional[float]:
        hist: sk.Z2HistogramStat = self._find("z2histogram", self.geom)
        if hist is None or hist.is_empty:
            return None
        mass = sum(hist.mass_in_box(*b) for b in boxes)
        return min(1.0, mass / max(1, self.total))

    def temporal_selectivity(self, intervals) -> Optional[float]:
        hist: sk.Z3HistogramStat = self._find("z3histogram", self.dtg)
        if hist is None or hist.is_empty:
            return None
        period = TimePeriod.parse(hist.period)
        mo = max_offset(period)
        windows = []
        for lo, hi in intervals:
            blo, olo = time_to_binned_time(lo, period)
            bhi, ohi = time_to_binned_time(hi, period)
            windows.append((int(blo), int(olo), int(bhi), int(ohi)))
        return min(1.0, hist.mass_in_windows(windows, mo) / max(1, self.total))

    def equality_selectivity(self, attr: str, value) -> Optional[float]:
        enum: sk.EnumerationStat = self._find("enumeration", attr)
        if enum is not None and not enum.is_empty:
            return enum.counts.get(value, 0) / max(1, self.total)
        freq: sk.FrequencyStat = self._find("frequency", attr)
        if freq is not None and not freq.is_empty:
            return freq.estimate(value) / max(1, self.total)
        mm: sk.MinMaxStat = self._find("minmax", attr)
        if mm is not None and not mm.is_empty:
            return 1.0 / max(1, mm.cardinality)
        return None

    def range_selectivity(self, attr: str, lo, hi) -> Optional[float]:
        hist: sk.HistogramStat = self._find("histogram", attr)
        if hist is None or hist.is_empty:
            return None
        return min(1.0, hist.mass_between(float(lo), float(hi)) / max(1, self.total))

    # -- filter walk ---------------------------------------------------------

    def selectivity(self, f: ir.Filter) -> float:
        """Estimated fraction of rows matching ``f`` (1.0 when unknown —
        conservative superset, like the reference's fallback heuristics)."""
        if isinstance(f, ir.Include):
            return 1.0
        if isinstance(f, ir.Exclude):
            return 0.0
        if isinstance(f, ir.And):
            out = 1.0
            for c in f.children:
                out *= self.selectivity(c)
            return out
        if isinstance(f, ir.Or):
            return min(1.0, sum(self.selectivity(c) for c in f.children))
        if isinstance(f, ir.Not):
            return max(0.0, 1.0 - self.selectivity(f.child))
        if isinstance(f, (ir.BBox, ir.Intersects, ir.Contains, ir.Within, ir.Dwithin)):
            ext = extract_bboxes(f, self.geom)
            if ext.unconstrained or len(ext.boxes) == 0:
                return 1.0
            s = self.spatial_selectivity(ext.boxes)
            return 1.0 if s is None else s
        if isinstance(f, ir.During):
            iv = extract_intervals(f, self.dtg)
            if iv is None or iv.unconstrained:
                return 1.0
            s = self.temporal_selectivity(iv.intervals)
            return 1.0 if s is None else s
        if isinstance(f, ir.Cmp):
            if f.attr == self.dtg:
                iv = extract_intervals(f, self.dtg)
                if iv is not None and not iv.unconstrained and len(iv.intervals):
                    s = self.temporal_selectivity(iv.intervals)
                    if s is not None:
                        return s
            if f.op == "=":
                s = self.equality_selectivity(f.attr, f.value)
                return 1.0 if s is None else s
            if f.op in ("<", "<=", ">", ">="):
                mm: sk.MinMaxStat = self._find("minmax", f.attr)
                if mm is not None and not mm.is_empty and not mm.geometric \
                        and isinstance(f.value, (int, float, np.number)):
                    lo = mm.min if f.op in ("<", "<=") else f.value
                    hi = f.value if f.op in ("<", "<=") else mm.max
                    s = self.range_selectivity(f.attr, lo, hi)
                    if s is not None:
                        return s
                    span = float(mm.max) - float(mm.min)
                    if span > 0:
                        frac = (float(hi) - float(lo)) / span
                        return float(np.clip(frac, 0.0, 1.0))
                return 0.5
            if f.op == "<>":
                s = self.equality_selectivity(f.attr, f.value)
                return 1.0 if s is None else max(0.0, 1.0 - s)
        if isinstance(f, ir.In):
            ss = [self.equality_selectivity(f.attr, v) for v in f.values]
            known = [s for s in ss if s is not None]
            if known:
                return min(1.0, sum(known) + (len(ss) - len(known)) * 0.1)
            return 1.0
        if isinstance(f, ir.FidFilter):
            return min(1.0, len(f.fids) / max(1, self.total))
        return 1.0

    def estimate_count(self, f: ir.Filter) -> int:
        return int(round(self.selectivity(f) * self.total))
