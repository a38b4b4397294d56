"""Planning-time extraction: pull spatial bounds and temporal intervals out of
a filter tree.

≙ reference ``FilterHelper.extractGeometries`` / ``extractIntervals``
(GeoMesa geomesa-filter/.../FilterHelper.scala:101,147): traverse the
tree; AND intersects constraints, OR unions them. Returns disjunctive lists —
a list of bboxes / intervals whose union covers the constraint — plus a flag
marking whether extraction was exact (so the planner knows if the primary
constraint fully subsumes the predicate or a residual filter must run,
the useFullFilter decision).

Bboxes are clamped to the whole world; antimeridian-crossing boxes (xmin >
xmax) split into two, mirroring FilterHelper's normalization.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from geomesa_tpu_torch.filter import geom_numpy as gn
from geomesa_tpu_torch.filter import ir

WHOLE_WORLD = (-180.0, -90.0, 180.0, 90.0)
# unbounded interval sentinel (epoch millis)
MIN_MS = 0
MAX_MS = np.iinfo(np.int64).max // 2


@dataclass(frozen=True)
class Extraction:
    """Disjoint union of boxes/intervals covering the filter's constraint.

    ``exact`` — True when the union *is* the constraint (e.g. a single BBOX),
    False when it over-covers (e.g. bbox of a polygon intersects). Drives the
    useFullFilter decision (Z3IndexKeySpace.scala:235-249).
    """

    boxes: Tuple[Tuple[float, float, float, float], ...]
    exact: bool

    @property
    def unconstrained(self) -> bool:
        return len(self.boxes) == 1 and self.boxes[0] == WHOLE_WORLD


def _clamp_box(b: Tuple[float, float, float, float]) -> List[Tuple[float, float, float, float]]:
    xmin, ymin, xmax, ymax = b
    ymin = max(ymin, -90.0)
    ymax = min(ymax, 90.0)
    if xmin > xmax:  # antimeridian crossing: split
        return [(max(xmin, -180.0), ymin, 180.0, ymax), (-180.0, ymin, min(xmax, 180.0), ymax)]
    return [(max(xmin, -180.0), ymin, min(xmax, 180.0), ymax)]


def _intersect_boxes(a, b):
    out = []
    for ax0, ay0, ax1, ay1 in a:
        for bx0, by0, bx1, by1 in b:
            x0, y0 = max(ax0, bx0), max(ay0, by0)
            x1, y1 = min(ax1, bx1), min(ay1, by1)
            if x0 <= x1 and y0 <= y1:
                out.append((x0, y0, x1, y1))
    return out


def extract_bboxes(f: ir.Filter, attr: Optional[str] = None) -> Extraction:
    """Spatial constraint of ``f`` on geometry attribute ``attr`` (None = any)."""

    def walk(node: ir.Filter) -> Tuple[List[Tuple[float, float, float, float]], bool]:
        if isinstance(node, ir.BBox) and (attr is None or node.attr == attr):
            return _clamp_box((node.xmin, node.ymin, node.xmax, node.ymax)), True
        if isinstance(node, (ir.Intersects, ir.Contains, ir.Within)) and \
                (attr is None or node.attr == attr):
            box = gn.literal_bbox(node.geometry)
            from geomesa_tpu_torch.features import geometry as geo
            # a bbox-shaped polygon (axis-aligned rectangle) extracts exactly
            exact = node.geometry[0] == geo.POINT or _is_rectangle(node.geometry)
            return _clamp_box(box), exact and isinstance(node, ir.Intersects)
        if isinstance(node, ir.Dwithin) and (attr is None or node.attr == attr):
            x0, y0, x1, y1 = gn.literal_bbox(node.geometry)
            d = node.distance
            return _clamp_box((x0 - d, y0 - d, x1 + d, y1 + d)), False
        if isinstance(node, (ir.Func, ir.FuncCmp)):
            box = _func_box(node, attr)
            if box is not None:
                return _clamp_box(box), False   # always loose: host refines
            return None, True
        if isinstance(node, ir.And):
            exact = True
            constrained = False
            acc = list(_clamp_box(WHOLE_WORLD))
            for c in node.children:
                cb, ce = walk(c)
                if cb is None:
                    continue
                acc = _intersect_boxes(acc, cb)
                exact = exact and ce
                constrained = True
            if not constrained:
                return None, True
            return acc, exact
        if isinstance(node, ir.Or):
            boxes = []
            exact = True
            for c in node.children:
                cb, ce = walk(c)
                if cb is None:
                    return None, True  # one branch unconstrained -> whole world
                boxes.extend(cb)
                exact = exact and ce
            return boxes, exact
        if isinstance(node, ir.Not):
            return None, False  # negations don't constrain the scan
        return None, True  # non-spatial predicate: no constraint

    boxes, exact = walk(f)
    if boxes is None:
        return Extraction((WHOLE_WORLD,), False)
    if not boxes:
        return Extraction((), True)  # spatially unsatisfiable
    return Extraction(tuple(boxes), exact)


def _func_box(node, attr: Optional[str]
              ) -> Optional[Tuple[float, float, float, float]]:
    """Sound spatial constraint of a geometry-function predicate on ``attr``:
    st_contains/st_intersects of the raw attribute vs a constant literal
    constrain to the literal's bbox; st_distance(attr, lit) < d expands it
    by d. Everything else (nested exprs, attr-vs-attr) is unconstrained."""
    args = node.args
    attr_arg = lit = None
    for a in args:
        if isinstance(a, str):
            attr_arg = a
        elif isinstance(a, tuple):
            lit = a
    if attr_arg is None or lit is None or len(args) != 2:
        return None
    if attr is not None and attr_arg != attr:
        return None
    if isinstance(node, ir.Func):
        return gn.literal_bbox(lit)
    if node.name == "st_distance" and node.op in ("<", "<="):
        d = max(float(node.value), 0.0)
        x0, y0, x1, y1 = gn.literal_bbox(lit)
        return (x0 - d, y0 - d, x1 + d, y1 + d)
    return None


def _is_rectangle(literal: tuple) -> bool:
    from geomesa_tpu_torch.features import geometry as geo
    code, data = literal
    if code != geo.POLYGON or len(data) != 1:
        return False
    ring = np.asarray(data[0], dtype=np.float64)
    if np.array_equal(ring[0], ring[-1]):
        ring = ring[:-1]
    if len(ring) != 4:
        return False
    xs, ys = sorted(set(ring[:, 0])), sorted(set(ring[:, 1]))
    return len(xs) == 2 and len(ys) == 2


@dataclass(frozen=True)
class IntervalExtraction:
    intervals: Tuple[Tuple[int, int], ...]  # inclusive millis [lo, hi]
    exact: bool

    @property
    def unconstrained(self) -> bool:
        return len(self.intervals) == 1 and self.intervals[0] == (MIN_MS, MAX_MS)


def _intersect_intervals(a, b):
    out = []
    for alo, ahi in a:
        for blo, bhi in b:
            lo, hi = max(alo, blo), min(ahi, bhi)
            if lo <= hi:
                out.append((lo, hi))
    return out


def extract_intervals(f: ir.Filter, attr: str) -> IntervalExtraction:
    """Temporal constraint on ``attr`` as inclusive millis intervals.

    Exclusive DURING endpoints tighten by 1ms (the key offset resolution),
    mirroring how the reference converts to indexable bounds
    (BinnedTime.boundsToIndexableDates).
    """

    def walk(node: ir.Filter):
        if isinstance(node, ir.During) and node.attr == attr:
            lo = node.lo if node.lo_inclusive else node.lo + 1
            hi = node.hi if node.hi_inclusive else node.hi - 1
            return ([(lo, hi)] if lo <= hi else []), True
        if isinstance(node, ir.Cmp) and node.attr == attr and isinstance(node.value, (int, np.integer)):
            v = int(node.value)
            if node.op == "=":
                return [(v, v)], True
            if node.op == "<":
                return [(MIN_MS, v - 1)], True
            if node.op == "<=":
                return [(MIN_MS, v)], True
            if node.op == ">":
                return [(v + 1, MAX_MS)], True
            if node.op == ">=":
                return [(v, MAX_MS)], True
            return None, True
        if isinstance(node, ir.And):
            acc = [(MIN_MS, MAX_MS)]
            exact = True
            constrained = False
            for c in node.children:
                ci, ce = walk(c)
                if ci is None:
                    continue
                acc = _intersect_intervals(acc, ci)
                exact = exact and ce
                constrained = True
            return (acc if constrained else None), exact
        if isinstance(node, ir.Or):
            ivs = []
            exact = True
            for c in node.children:
                ci, ce = walk(c)
                if ci is None:
                    return None, True
                ivs.extend(ci)
                exact = exact and ce
            return ivs, exact
        if isinstance(node, ir.Not):
            return None, False
        return None, True

    ivs, exact = walk(f)
    if ivs is None:
        return IntervalExtraction(((MIN_MS, MAX_MS),), False)
    if not ivs:
        return IntervalExtraction((), True)
    # merge overlaps
    ivs = sorted(ivs)
    merged = [list(ivs[0])]
    for lo, hi in ivs[1:]:
        if lo <= merged[-1][1] + 1:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return IntervalExtraction(tuple((lo, hi) for lo, hi in merged), exact)
