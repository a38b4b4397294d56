"""Small analytic processes.

Copied from ``geomesa_tpu.process.misc``
(host-only) with its imports pointed at this package.

≙ reference `Point2PointProcess` (point sequences → per-track LineStrings),
`UniqueProcess` (distinct attribute values + counts), `HashAttributeProcess`
/ `HashAttributeColorProcess` (stable hash buckets for styling), and
`DateOffsetProcess` (shift a date attribute). All columnar one-pass ops."""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np

from geomesa_tpu_torch.features.table import FeatureTable, StringColumn
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.stats.sketches import hash64


def point2point(planner, track_attr: str, f: Union[str, ir.Filter] = "INCLUDE",
                break_on_day: bool = False):
    """Per-track LineStrings from time-ordered points (≙ Point2PointProcess).
    Returns a list of (track value, LineString WKT, n_points); tracks with
    fewer than 2 points are dropped. break_on_day splits tracks at UTC day
    boundaries like the reference's breakOnDay flag."""
    dtg = planner.sft.dtg_attribute
    if dtg is None:
        raise ValueError("point2point requires a date attribute")
    rows = planner.select_indices(f)
    sub = planner.table.take(rows)
    x, y = sub.geometry().point_xy()
    t = np.asarray(sub.columns[dtg.name], dtype=np.int64)
    col = sub.columns[track_attr]
    keys = col.codes if isinstance(col, StringColumn) else np.asarray(col)

    day = t // 86_400_000 if break_on_day else np.zeros_like(t)
    order = np.lexsort((t, day, keys))
    keys_s, day_s = keys[order], day[order]
    xs, ys = x[order], y[order]
    breaks = np.nonzero((np.diff(keys_s) != 0) | (np.diff(day_s) != 0))[0] + 1
    out = []
    for s, e in zip(np.r_[0, breaks], np.r_[breaks, len(keys_s)]):
        if e - s < 2:
            continue
        val = col.vocab[keys_s[s]] if isinstance(col, StringColumn) else keys_s[s].item()
        coords = ", ".join(f"{xs[i]:.9g} {ys[i]:.9g}" for i in range(s, e))
        out.append((val, f"LINESTRING ({coords})", int(e - s)))
    return out


def unique_values(planner, attr: str, f: Union[str, ir.Filter] = "INCLUDE",
                  sort_by_count: bool = False) -> List[Tuple[object, int]]:
    """Distinct values + counts (≙ UniqueProcess), via the stats scan."""
    from geomesa_tpu_torch.aggregates.stats_scan import run_stat
    stat = run_stat(planner, f'Enumeration("{attr}")', f)
    items = list(stat.counts.items())
    return sorted(items, key=(lambda kv: -kv[1]) if sort_by_count else (lambda kv: str(kv[0])))


def hash_attribute(planner, attr: str, buckets: int,
                   f: Union[str, ir.Filter] = "INCLUDE") -> np.ndarray:
    """Stable per-feature hash bucket of an attribute (≙
    HashAttributeProcess; styling/partitioning helper)."""
    rows = planner.select_indices(f)
    sub = planner.table.take(rows)
    col = sub.columns[attr]
    if isinstance(col, StringColumn):
        vocab_h = hash64(np.asarray(col.vocab, dtype=object))
        h = vocab_h[col.codes]
    else:
        h = hash64(np.asarray(col))
    return (h % np.uint64(buckets)).astype(np.int32)


def date_offset(planner, offset_ms: int, f: Union[str, ir.Filter] = "INCLUDE",
                attr: Optional[str] = None) -> FeatureTable:
    """Matching rows with the date attribute shifted (≙ DateOffsetProcess)."""
    dtg_attr = attr or (planner.sft.dtg_attribute.name
                        if planner.sft.dtg_attribute else None)
    if dtg_attr is None:
        raise ValueError("date_offset requires a date attribute")
    rows = planner.select_indices(f)
    sub = planner.table.take(rows)
    sub.columns[dtg_attr] = np.asarray(sub.columns[dtg_attr], dtype=np.int64) + offset_ms
    return sub
