"""Exact host-side geometry predicates (float64 numpy) for polygon literals.

≙ ``geomesa_tpu.filter.geom_numpy`` trimmed to what the point-layer polygon
refine reads: the boundary segments of a literal (the device kernel's edge
table) and the f64 crossing-parity point-in-polygon test that settles the
rows the f32 certainty band leaves uncertain.

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
    """Boundary segments of a polygonal literal as (S, 4) [x1, y1, x2, y2]."""
    rings = polygon_rings(literal)
    return np.concatenate([np.concatenate([r[:-1], r[1:]], axis=1)
                           for r in rings if len(r) >= 2])


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
