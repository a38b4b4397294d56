"""Exact numpy host oracles for the geometry function catalog.

≙ ``geomesa_tpu.geom.oracle``, by copy: the JTS operations behind the
reference's geomesa-spark-jts UDFs
(st_area/st_length/st_centroid/st_distance/st_buffer/st_convexHull/
st_contains/st_intersects) over point and ragged (line, polygon, multi)
features. The filter evaluator (``filter.evaluate``) and the fused
program's uncertain-sliver refine call them directly, so the oracle IS the
semantics. (The device catalog, ``geom.catalog``, is judged against
these, and refines its predicates' uncertain sliver with them.)

Semantics notes (documented in the README function table):

* ``st_area``  — planar shoelace: Σ per polygon part of |shell| − Σ|holes|,
  in squared degrees; 0 for points and lines.
* ``st_length`` — Σ boundary segment lengths (JTS ``getLength``: line length
  for lineal features, ring perimeter for polygonal ones, 0 for points).
* ``st_centroid`` — JTS discipline: area-weighted for polygonal features
  with nonzero area, else length-weighted over boundary segments, else the
  vertex mean.
* ``st_buffer`` — vertex-offset approximation: the convex hull of the
  feature's vertices Minkowski-summed with a regular octagon of circumradius
  ``d / cos(π/8)``. A guaranteed superset of the true d-buffer of the hull
  whose boundary overshoots by ≤ ``d·(sec(π/8) − 1) ≈ 0.0824·d``; the
  envelope (bbox ± d) is exact.
* ``st_convexHull`` — Andrew monotone chain, strict (collinear boundary
  vertices dropped), CCW vertex order starting from the lexicographic min.
* ``st_contains(a, b)`` — boundary-inclusive containment (matches the
  existing ``ir.Contains``/``batch_within`` discipline).
* ``st_distance`` — exact min distance in degrees (0 when intersecting).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from geomesa_tpu_torch.features import geometry as geo
from geomesa_tpu_torch.filter import geom_batch as gb
from geomesa_tpu_torch.filter import geom_numpy as gn

# Minkowski octagon: circumradius d/cos(pi/8) circumscribes the d-disk, so
# the octagonal buffer CONTAINS the true buffer; max overshoot sec(pi/8)-1.
BUFFER_SEC = float(1.0 / np.cos(np.pi / 8.0))
BUFFER_OVERSHOOT = BUFFER_SEC - 1.0   # ≈ 0.082392
_OCT_ANGLES = (np.arange(8) + 0.5) * (np.pi / 4.0)


def octagon_offsets(d: float) -> np.ndarray:
    """(8, 2) f64 vertex offsets of the buffer octagon (d=0 → zeros)."""
    r = float(d) * BUFFER_SEC
    return np.stack([r * np.cos(_OCT_ANGLES), r * np.sin(_OCT_ANGLES)],
                    axis=1)


def feature_shape(arr: geo.GeometryArray, i: int) -> tuple:
    """(type_code, nested lists) literal of feature ``i``."""
    return arr.shape(int(i))


def _ring_signed_area(pts: np.ndarray) -> float:
    """Signed shoelace area of one (closed or unclosed) ring, f64."""
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def _feature_rings(arr: geo.GeometryArray, i: int
                   ) -> List[Tuple[np.ndarray, bool]]:
    """[(ring coords, is_shell)] for feature ``i`` (polygonal only)."""
    out = []
    g0, g1 = int(arr.geom_offsets[i]), int(arr.geom_offsets[i + 1])
    for p in range(g0, g1):
        r0, r1 = int(arr.part_offsets[p]), int(arr.part_offsets[p + 1])
        for r in range(r0, r1):
            c0, c1 = int(arr.ring_offsets[r]), int(arr.ring_offsets[r + 1])
            out.append((arr.coords[c0:c1], r == r0))
    return out


def area(arr: geo.GeometryArray, rows: np.ndarray) -> np.ndarray:
    """(len(rows),) f64 planar areas."""
    rows = np.asarray(rows, dtype=np.int64)
    out = np.zeros(len(rows), dtype=np.float64)
    polyish = (geo.POLYGON, geo.MULTIPOLYGON)
    for k, i in enumerate(rows):
        if int(arr.type_codes[i]) not in polyish:
            continue
        a = 0.0
        for ring, is_shell in _feature_rings(arr, int(i)):
            ra = abs(_ring_signed_area(ring))
            a += ra if is_shell else -ra
        out[k] = max(a, 0.0)
    return out


def length(arr: geo.GeometryArray, rows: np.ndarray) -> np.ndarray:
    """(len(rows),) f64 boundary lengths (perimeter for polygons)."""
    rows = np.asarray(rows, dtype=np.int64)
    if len(rows) == 0:
        return np.zeros(0, dtype=np.float64)
    segs, fid = gb.build_segments(arr, rows)
    if len(segs) == 0:
        return np.zeros(len(rows), dtype=np.float64)
    ln = np.hypot(segs[:, 2] - segs[:, 0], segs[:, 3] - segs[:, 1])
    return np.bincount(fid, weights=ln, minlength=len(rows))


# areal-centroid gate: a feature routes through the area-weighted moment
# formula only when |2·area| exceeds this fraction of its bbox extent² —
# below it the f32 kernel's moment/area quotient is ill-conditioned, so BOTH
# the oracle and the kernel (which reads the host-computed mode flag) fall
# back to the length-weighted boundary centroid. Shared rule == shared
# semantics; the deviation from JTS (thin slivers centroid their boundary)
# is documented in the README.
AREAL_REL = 1e-3

MODE_POINT, MODE_LINEAL, MODE_AREAL = 0, 1, 2


def centroid_mode(arr: geo.GeometryArray, i: int) -> int:
    """Shared areal/lineal/point cascade decision (host f64)."""
    i = int(i)
    code = int(arr.type_codes[i])
    if code in (geo.POLYGON, geo.MULTIPOLYGON):
        a2 = 0.0
        for ring, is_shell in _feature_rings(arr, i):
            sa = _ring_signed_area(ring)
            a2 += (1.0 if is_shell else -1.0) * 2.0 * abs(sa)
        bb = arr.bboxes()[i]
        ext2 = max((bb[2] - bb[0]) * (bb[3] - bb[1]), 1e-300)
        if abs(a2) > AREAL_REL * ext2:
            return MODE_AREAL
    if code != geo.POINT and len(gn.feature_segments(arr, i)):
        return MODE_LINEAL
    return MODE_POINT


def centroid(arr: geo.GeometryArray, rows: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray]:
    """((C,) x, (C,) y) f64 JTS-style centroids (cascade per
    ``centroid_mode``)."""
    rows = np.asarray(rows, dtype=np.int64)
    cx = np.zeros(len(rows), dtype=np.float64)
    cy = np.zeros(len(rows), dtype=np.float64)
    for k, i in enumerate(rows):
        i = int(i)
        pts = arr.feature_coords(i)
        # local origin: keeps the shoelace moments well-conditioned (the
        # kernel shifts identically, so parity is apples-to-apples)
        ox, oy = float(np.mean(pts[:, 0])), float(np.mean(pts[:, 1]))
        mode = centroid_mode(arr, i)
        if mode == MODE_AREAL:
            a2 = 0.0
            mx = my = 0.0
            for ring, is_shell in _feature_rings(arr, i):
                x = ring[:, 0] - ox
                y = ring[:, 1] - oy
                x2, y2 = np.roll(x, -1), np.roll(y, -1)
                cross = x * y2 - x2 * y
                sa = 0.5 * float(np.sum(cross))
                sgn = 1.0 if is_shell else -1.0
                w = sgn * (1.0 if sa >= 0 else -1.0)
                a2 += w * 2.0 * sa
                mx += w * float(np.sum((x + x2) * cross))
                my += w * float(np.sum((y + y2) * cross))
            if abs(a2) > 0.0:
                cx[k] = ox + mx / (3.0 * a2)
                cy[k] = oy + my / (3.0 * a2)
                continue
            mode = MODE_LINEAL
        if mode == MODE_LINEAL:
            segs = gn.feature_segments(arr, i)
            ln = np.hypot(segs[:, 2] - segs[:, 0], segs[:, 3] - segs[:, 1])
            tot = float(np.sum(ln))
            if tot > 0.0:
                cx[k] = float(np.sum(ln * (segs[:, 0] + segs[:, 2]))) \
                    / (2.0 * tot)
                cy[k] = float(np.sum(ln * (segs[:, 1] + segs[:, 3]))) \
                    / (2.0 * tot)
                continue
        cx[k], cy[k] = ox, oy
    return cx, cy


def distance(arr: geo.GeometryArray, rows: np.ndarray,
             literal: tuple) -> np.ndarray:
    """(len(rows),) f64 exact min distances to the literal geometry."""
    rows = np.asarray(rows, dtype=np.int64)
    if len(rows) == 0:
        return np.zeros(0, dtype=np.float64)
    return gb.batch_distance(arr, rows, literal)


def convex_hull(pts: np.ndarray) -> np.ndarray:
    """Strict convex hull (Andrew monotone chain), CCW from the
    lexicographic-min vertex. Degenerate inputs (≤2 distinct, collinear)
    return the distinct extreme points."""
    pts = np.unique(np.asarray(pts, dtype=np.float64), axis=0)
    if len(pts) <= 2:
        return pts
    # lexicographic sort (x, then y) — np.unique already provides it
    def half(seq):
        h: List[np.ndarray] = []
        for p in seq:
            while len(h) >= 2:
                u, v = h[-1] - h[-2], p - h[-2]
                if u[0] * v[1] - u[1] * v[0] <= 0:
                    h.pop()
                else:
                    break
            h.append(p)
        return h
    lower = half(pts)
    upper = half(pts[::-1])
    hull = np.asarray(lower[:-1] + upper[:-1])
    if len(hull) < 3:   # fully collinear input
        return np.asarray([pts[0], pts[-1]])
    return hull


def convex_hull_of(arr: geo.GeometryArray, i: int) -> np.ndarray:
    return convex_hull(arr.feature_coords(int(i)))


def convex_hull_shapes(arr: geo.GeometryArray,
                       rows: np.ndarray) -> List[tuple]:
    """Hulls as geometry literals (polygon / linestring / point)."""
    out = []
    for i in np.asarray(rows, dtype=np.int64):
        h = convex_hull_of(arr, int(i))
        if len(h) >= 3:
            out.append((geo.POLYGON, [h.tolist() + [h[0].tolist()]]))
        elif len(h) == 2:
            out.append((geo.LINESTRING, h.tolist()))
        else:
            out.append((geo.POINT, h[0].tolist()))
    return out


def buffer_shapes(arr: geo.GeometryArray, rows: np.ndarray,
                  d: float) -> List[tuple]:
    """Octagonal vertex-offset buffers as POLYGON literals (see module
    docstring for the documented error bound)."""
    offs = octagon_offsets(d)
    out = []
    for i in np.asarray(rows, dtype=np.int64):
        pts = arr.feature_coords(int(i))
        swept = (pts[:, None, :] + offs[None, :, :]).reshape(-1, 2)
        h = convex_hull(swept)
        if len(h) >= 3:
            out.append((geo.POLYGON, [h.tolist() + [h[0].tolist()]]))
        elif len(h) == 2:
            out.append((geo.LINESTRING, h.tolist()))
        else:
            out.append((geo.POINT, h[0].tolist()))
    return out


def buffer_envelopes(arr: geo.GeometryArray, rows: np.ndarray,
                     d: float) -> np.ndarray:
    """(C, 4) exact expanded envelopes [xmin ymin xmax ymax] — the
    envelope-exact half of st_buffer."""
    rows = np.asarray(rows, dtype=np.int64)
    bb = arr.bboxes()[rows].astype(np.float64).copy()
    bb[:, 0] -= d
    bb[:, 1] -= d
    bb[:, 2] += d
    bb[:, 3] += d
    return bb


def intersects(arr: geo.GeometryArray, rows: np.ndarray,
               literal: tuple) -> np.ndarray:
    """(len(rows),) bool — feature ∩ literal ≠ ∅ (symmetric)."""
    rows = np.asarray(rows, dtype=np.int64)
    if len(rows) == 0:
        return np.zeros(0, dtype=bool)
    return gb.batch_intersects(arr, rows, literal)


def contains_literal(arr: geo.GeometryArray, rows: np.ndarray,
                     literal: tuple) -> np.ndarray:
    """literal CONTAINS feature (boundary-inclusive) — the
    ``st_contains(LITERAL, geom)`` direction.

    Non-polygonal literals: point literals contain only coincident point
    features; lineal literals contain features whose vertices AND segment
    midpoints all lie on the literal (exact for points, a documented
    sampling approximation for collinear line-on-line cases)."""
    rows = np.asarray(rows, dtype=np.int64)
    if len(rows) == 0:
        return np.zeros(0, dtype=bool)
    lcode = literal[0]
    if lcode in (geo.POLYGON, geo.MULTIPOLYGON):
        return gb.batch_within(arr, rows, literal)
    out = np.zeros(len(rows), dtype=bool)
    lc = gn.literal_coords(literal)
    lsegs = gn.literal_segments(literal)
    for k, i in enumerate(rows):
        i = int(i)
        if int(arr.type_codes[i]) in (geo.POLYGON, geo.MULTIPOLYGON):
            continue
        fc = arr.feature_coords(i)
        if lcode in (geo.POINT, geo.MULTIPOINT):
            match = ((fc[:, None, 0] == lc[None, :, 0])
                     & (fc[:, None, 1] == lc[None, :, 1]))
            out[k] = bool(len(fc)) and bool(match.any(axis=1).all())
            continue
        samples = [fc]
        fsegs = gn.feature_segments(arr, i)
        if len(fsegs):
            samples.append(np.stack(
                [(fsegs[:, 0] + fsegs[:, 2]) * 0.5,
                 (fsegs[:, 1] + fsegs[:, 3]) * 0.5], axis=1))
        pts = np.concatenate(samples)
        out[k] = bool(np.all(gn._points_on_segments(
            pts[:, 0], pts[:, 1], lsegs)))
    return out


def feature_contains(arr: geo.GeometryArray, rows: np.ndarray,
                     literal: tuple) -> np.ndarray:
    """feature CONTAINS literal (boundary-inclusive) — the
    ``st_contains(geom, LITERAL)`` direction. Polygonal features can contain
    anything; lineal/point features contain only geometries lying on them
    (supported for point literals; other degenerate shapes refine per-row).
    """
    rows = np.asarray(rows, dtype=np.int64)
    out = np.zeros(len(rows), dtype=bool)
    if len(rows) == 0:
        return out
    lcode = literal[0]
    if lcode == geo.POINT:
        px, py = float(literal[1][0]), float(literal[1][1])
        for k, i in enumerate(rows):
            i = int(i)
            code = int(arr.type_codes[i])
            if code in (geo.POLYGON, geo.MULTIPOLYGON):
                segs = gn.feature_segments(arr, i)
                out[k] = _point_in_rings(px, py, segs)
            else:
                segs = gn.feature_segments(arr, i)
                if len(segs):
                    out[k] = bool(gn.point_segment_distance(
                        np.asarray([px]), np.asarray([py]), segs)[0] == 0.0)
                else:
                    c0 = int(arr.ring_offsets[arr.part_offsets[
                        arr.geom_offsets[i]]])
                    out[k] = (arr.coords[c0, 0] == px
                              and arr.coords[c0, 1] == py)
        return out
    # general literal: feature must be polygonal; contained iff every
    # literal vertex is in the feature and no boundaries properly cross
    lc = gn.literal_coords(literal)
    lsegs = gn.literal_segments(literal)
    for k, i in enumerate(rows):
        i = int(i)
        if int(arr.type_codes[i]) not in (geo.POLYGON, geo.MULTIPOLYGON):
            continue
        fsegs = gn.feature_segments(arr, i)
        if not all(_point_in_rings(float(x), float(y), fsegs)
                   for x, y in lc):
            continue
        out[k] = not gn._segments_properly_cross(lsegs, fsegs)
    return out


def _point_in_rings(px: float, py: float, segs: np.ndarray) -> bool:
    """Boundary-inclusive point-in-polygon against a segment soup (crossing
    parity; on-edge counts as inside)."""
    if len(segs) == 0:
        return False
    d = gn.point_segment_distance(np.asarray([px]), np.asarray([py]), segs)
    if d[0] == 0.0:
        return True
    x1, y1, x2, y2 = segs[:, 0], segs[:, 1], segs[:, 2], segs[:, 3]
    cond = (y1 > py) != (y2 > py)
    with np.errstate(divide="ignore", invalid="ignore"):
        xs = x1 + (py - y1) * (x2 - x1) / (y2 - y1)
    return bool(np.sum(cond & (xs > px)) % 2 == 1)
