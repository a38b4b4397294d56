"""Exact host-side geometry predicates (float64 numpy).

≙ ``geomesa_tpu.filter.geom_numpy``, the JTS-equivalent predicate surface
the filters need: point-in-polygon (crossing parity), segment intersection,
distance. It gives the boundary segments of a literal (the device refine's
edge table), settles in f64 the rows the f32 certainty bands leave
uncertain, and is the scalar oracle of ``filter.geom_batch``, over point
and ragged features alike.

Geometry literals are (type_code, nested lists) as in features.geometry.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from geomesa_tpu_torch.features import geometry as geo


def polygon_rings(literal: tuple) -> List[np.ndarray]:
    """All rings of a Polygon/MultiPolygon literal as (k,2) closed arrays."""
    code, data = literal
    if code == geo.POLYGON:
        polys = [data]
    elif code == geo.MULTIPOLYGON:
        polys = data
    else:
        raise ValueError(f"Expected polygonal literal, got type {code}")
    rings = []
    for poly in polys:
        for ring in poly:
            arr = np.asarray(ring, dtype=np.float64)
            if not np.array_equal(arr[0], arr[-1]):
                arr = np.vstack([arr, arr[:1]])
            rings.append(arr)
    return rings


def literal_coords(literal: tuple) -> np.ndarray:
    """All coordinates of any literal as an (M, 2) array."""
    code, data = literal
    if code == geo.POINT:
        return np.asarray([data], dtype=np.float64)
    if code in (geo.LINESTRING, geo.MULTIPOINT):
        return np.asarray(data, dtype=np.float64)
    if code in (geo.POLYGON, geo.MULTILINESTRING):
        return np.concatenate([np.asarray(r, dtype=np.float64) for r in data])
    if code == geo.MULTIPOLYGON:
        return np.concatenate([np.asarray(r, dtype=np.float64) for p in data for r in p])
    raise ValueError(f"Unknown literal type {code}")


def literal_segments(literal: tuple) -> np.ndarray:
    """Boundary segments of a literal as (S, 4) [x1, y1, x2, y2]."""
    code, data = literal
    segs = []

    def ring_segs(ring, close: bool):
        arr = np.asarray(ring, dtype=np.float64)
        if close and not np.array_equal(arr[0], arr[-1]):
            arr = np.vstack([arr, arr[:1]])
        if len(arr) >= 2:
            segs.append(np.concatenate([arr[:-1], arr[1:]], axis=1))

    if code == geo.LINESTRING:
        ring_segs(data, close=False)
    elif code == geo.MULTILINESTRING:
        for line in data:
            ring_segs(line, close=False)
    elif code == geo.POLYGON:
        for ring in data:
            ring_segs(ring, close=True)
    elif code == geo.MULTIPOLYGON:
        for poly in data:
            for ring in poly:
                ring_segs(ring, close=True)
    elif code in (geo.POINT, geo.MULTIPOINT):
        return np.zeros((0, 4))
    else:
        raise ValueError(f"Unknown literal type {code}")
    return np.concatenate(segs) if segs else np.zeros((0, 4))


def literal_bbox(literal: tuple) -> Tuple[float, float, float, float]:
    c = literal_coords(literal)
    return float(c[:, 0].min()), float(c[:, 1].min()), float(c[:, 0].max()), float(c[:, 1].max())


def points_in_polygon(px: np.ndarray, py: np.ndarray, literal: tuple) -> np.ndarray:
    """Vectorized crossing-parity test; boundary points count as inside
    (matching JTS `intersects` semantics closely enough for index tests —
    exact boundary behavior differs at shared-edge degeneracies).
    """
    px = np.asarray(px, dtype=np.float64)
    py = np.asarray(py, dtype=np.float64)
    inside = np.zeros(px.shape, dtype=bool)
    on_edge = np.zeros(px.shape, dtype=bool)
    for ring in polygon_rings(literal):
        x1, y1 = ring[:-1, 0], ring[:-1, 1]
        x2, y2 = ring[1:, 0], ring[1:, 1]
        # crossing parity (half-open rule), accumulated over all rings so
        # holes toggle points back out
        pyv = py[..., None]
        pxv = px[..., None]
        cond = (y1 > pyv) != (y2 > pyv)
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = (x2 - x1) * (pyv - y1) / (y2 - y1) + x1
        crossings = cond & (pxv < xint)
        inside ^= (np.count_nonzero(crossings, axis=-1) % 2).astype(bool)
        # boundary test: point on segment
        on_edge |= _points_on_segments(px, py, np.concatenate(
            [ring[:-1], ring[1:]], axis=1))
    return inside | on_edge


def _points_on_segments(px, py, segs, eps: float = 1e-12) -> np.ndarray:
    """Whether each point lies on any segment (collinear + within extent)."""
    if len(segs) == 0:
        return np.zeros(np.shape(px), dtype=bool)
    x1, y1, x2, y2 = segs[:, 0], segs[:, 1], segs[:, 2], segs[:, 3]
    pxv, pyv = np.asarray(px)[..., None], np.asarray(py)[..., None]
    cross = (x2 - x1) * (pyv - y1) - (y2 - y1) * (pxv - x1)
    scale = np.maximum(np.abs(x2 - x1), np.abs(y2 - y1)) + eps
    collinear = np.abs(cross) <= eps * scale * np.maximum(1.0, np.maximum(np.abs(pxv), np.abs(pyv)))
    within = (
        (np.minimum(x1, x2) - eps <= pxv) & (pxv <= np.maximum(x1, x2) + eps)
        & (np.minimum(y1, y2) - eps <= pyv) & (pyv <= np.maximum(y1, y2) + eps)
    )
    return np.any(collinear & within, axis=-1)


def segments_cross(a: np.ndarray, b: np.ndarray) -> bool:
    """Whether any segment in a (n,4) crosses any in b (m,4). Proper and
    improper (touching) intersections both count."""
    if len(a) == 0 or len(b) == 0:
        return False
    ax1, ay1, ax2, ay2 = (a[:, i][:, None] for i in range(4))
    bx1, by1, bx2, by2 = (b[:, i][None, :] for i in range(4))

    def orient(ox, oy, px_, py_, qx, qy):
        return (px_ - ox) * (qy - oy) - (py_ - oy) * (qx - ox)

    d1 = orient(ax1, ay1, ax2, ay2, bx1, by1)
    d2 = orient(ax1, ay1, ax2, ay2, bx2, by2)
    d3 = orient(bx1, by1, bx2, by2, ax1, ay1)
    d4 = orient(bx1, by1, bx2, by2, ax2, ay2)
    proper = ((d1 * d2) < 0) & ((d3 * d4) < 0)
    if np.any(proper):
        return True

    def on(ox, oy, qx, qy, px_, py_, d):
        return (d == 0) & (np.minimum(ox, qx) <= px_) & (px_ <= np.maximum(ox, qx)) \
            & (np.minimum(oy, qy) <= py_) & (py_ <= np.maximum(oy, qy))

    touch = (
        on(ax1, ay1, ax2, ay2, bx1, by1, d1) | on(ax1, ay1, ax2, ay2, bx2, by2, d2)
        | on(bx1, by1, bx2, by2, ax1, ay1, d3) | on(bx1, by1, bx2, by2, ax2, ay2, d4)
    )
    return bool(np.any(touch))


def feature_segments(arr: "geo.GeometryArray", i: int) -> np.ndarray:
    """Boundary segments of feature i as (S, 4)."""
    return literal_segments(arr.shape(i))


def geometry_intersects(arr: "geo.GeometryArray", i: int, literal: tuple) -> bool:
    """Exact-ish intersects between feature i and a literal geometry.

    Covers: any feature vertex inside literal (polygonal), any literal vertex
    inside feature (polygonal feature), or boundary segments crossing. This is
    complete for all non-degenerate polygon/line/point combinations.
    """
    code = int(arr.type_codes[i])
    fcoords = arr.feature_coords(i)
    lcode = literal[0]

    if lcode in (geo.POLYGON, geo.MULTIPOLYGON):
        if np.any(points_in_polygon(fcoords[:, 0], fcoords[:, 1], literal)):
            return True
    if code in (geo.POLYGON, geo.MULTIPOLYGON):
        fshape = arr.shape(i)
        lc = literal_coords(literal)
        if np.any(points_in_polygon(lc[:, 0], lc[:, 1], fshape)):
            return True
    if lcode in (geo.POINT, geo.MULTIPOINT):
        lc = literal_coords(literal)
        if code in (geo.POINT, geo.MULTIPOINT):
            return bool(np.any((fcoords[:, None, 0] == lc[None, :, 0])
                               & (fcoords[:, None, 1] == lc[None, :, 1])))
        if code in (geo.LINESTRING, geo.MULTILINESTRING):
            return bool(np.any(_points_on_segments(lc[:, 0], lc[:, 1], feature_segments(arr, i))))
    if code in (geo.POINT, geo.MULTIPOINT) and lcode in (geo.LINESTRING, geo.MULTILINESTRING):
        return bool(np.any(_points_on_segments(fcoords[:, 0], fcoords[:, 1], literal_segments(literal))))
    return segments_cross(feature_segments(arr, i), literal_segments(literal))


def point_segment_distance(px, py, segs: np.ndarray) -> np.ndarray:
    """Min distance from each point to any segment; (N,) array."""
    pxv = np.asarray(px, dtype=np.float64)[..., None]
    pyv = np.asarray(py, dtype=np.float64)[..., None]
    if len(segs) == 0:
        return np.full(np.shape(px), np.inf)
    x1, y1, x2, y2 = segs[:, 0], segs[:, 1], segs[:, 2], segs[:, 3]
    dx, dy = x2 - x1, y2 - y1
    ll = dx * dx + dy * dy
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.clip(((pxv - x1) * dx + (pyv - y1) * dy) / np.where(ll == 0, 1, ll), 0, 1)
    cx, cy = x1 + t * dx, y1 + t * dy
    return np.sqrt(np.min((pxv - cx) ** 2 + (pyv - cy) ** 2, axis=-1))


def geometry_distance(arr: "geo.GeometryArray", i: int, literal: tuple) -> float:
    """Approximate min distance between feature i and a literal (0 when they
    intersect; otherwise min vertex-to-boundary distance both ways)."""
    if geometry_intersects(arr, i, literal):
        return 0.0
    fcoords = arr.feature_coords(i)
    lsegs = literal_segments(literal)
    d = np.inf
    if len(lsegs):
        d = min(d, float(np.min(point_segment_distance(fcoords[:, 0], fcoords[:, 1], lsegs))))
    lc = literal_coords(literal)
    fsegs = feature_segments(arr, i)
    if len(fsegs):
        d = min(d, float(np.min(point_segment_distance(lc[:, 0], lc[:, 1], fsegs))))
    elif not len(lsegs):
        d = min(d, float(np.min(np.hypot(fcoords[:, None, 0] - lc[None, :, 0],
                                         fcoords[:, None, 1] - lc[None, :, 1]))))
    return d


def geometry_within(arr: "geo.GeometryArray", i: int, literal: tuple) -> bool:
    """Feature i entirely within a polygonal literal: all vertices inside and
    no boundary crossing out (approximate at shared boundaries)."""
    fcoords = arr.feature_coords(i)
    if not np.all(points_in_polygon(fcoords[:, 0], fcoords[:, 1], literal)):
        return False
    fsegs = feature_segments(arr, i)
    if len(fsegs) == 0:
        return True
    # vertices all inside: only a boundary crossing can place part outside
    return not _segments_properly_cross(fsegs, literal_segments(literal))


def _segments_properly_cross(a: np.ndarray, b: np.ndarray) -> bool:
    if len(a) == 0 or len(b) == 0:
        return False
    ax1, ay1, ax2, ay2 = (a[:, i][:, None] for i in range(4))
    bx1, by1, bx2, by2 = (b[:, i][None, :] for i in range(4))

    def orient(ox, oy, px_, py_, qx, qy):
        return (px_ - ox) * (qy - oy) - (py_ - oy) * (qx - ox)

    d1 = orient(ax1, ay1, ax2, ay2, bx1, by1)
    d2 = orient(ax1, ay1, ax2, ay2, bx2, by2)
    d3 = orient(bx1, by1, bx2, by2, ax1, ay1)
    d4 = orient(bx1, by1, bx2, by2, ax2, ay2)
    return bool(np.any(((d1 * d2) < 0) & ((d3 * d4) < 0)))


def point_segment_distance(px, py, segs: np.ndarray) -> np.ndarray:
    """Min distance from each point to any segment; (N,) array."""
    pxv = np.asarray(px, dtype=np.float64)[..., None]
    pyv = np.asarray(py, dtype=np.float64)[..., None]
    if len(segs) == 0:
        return np.full(np.shape(px), np.inf)
    x1, y1, x2, y2 = segs[:, 0], segs[:, 1], segs[:, 2], segs[:, 3]
    dx, dy = x2 - x1, y2 - y1
    ll = dx * dx + dy * dy
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.clip(((pxv - x1) * dx + (pyv - y1) * dy) / np.where(ll == 0, 1, ll), 0, 1)
    cx, cy = x1 + t * dx, y1 + t * dy
    return np.sqrt(np.min((pxv - cx) ** 2 + (pyv - cy) ** 2, axis=-1))


def geometry_distance(arr: "geo.GeometryArray", i: int, literal: tuple) -> float:
    """Approximate min distance between feature i and a literal (0 when they
    intersect; otherwise min vertex-to-boundary distance both ways)."""
    if geometry_intersects(arr, i, literal):
        return 0.0
    fcoords = arr.feature_coords(i)
    lsegs = literal_segments(literal)
    d = np.inf
    if len(lsegs):
        d = min(d, float(np.min(point_segment_distance(fcoords[:, 0], fcoords[:, 1], lsegs))))
    lc = literal_coords(literal)
    fsegs = feature_segments(arr, i)
    if len(fsegs):
        d = min(d, float(np.min(point_segment_distance(lc[:, 0], lc[:, 1], fsegs))))
    elif not len(lsegs):
        d = min(d, float(np.min(np.hypot(fcoords[:, None, 0] - lc[None, :, 0],
                                         fcoords[:, None, 1] - lc[None, :, 1]))))
    return d
