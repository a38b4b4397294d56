"""Exact numpy host oracles of the st_* functions on point features.

≙ ``geomesa_tpu.geom.oracle``: the JTS operations behind the reference's
geomesa-spark-jts UDFs, which the filter evaluator and the fused
program's uncertain-sliver refine call, so the oracle IS the semantics.
The port's ``GeometryArray`` is a point column; each function here is the
reference's on point features (a point has no area, no boundary length,
and is its own centroid). Ragged features — polygons and lines as table
rows — come with the extent layers (ROADMAP.md Queue 1, item 9).

* ``st_distance`` — exact min distance in degrees (0 when intersecting).
* ``st_intersects`` — feature ∩ literal ≠ ∅.
* ``st_contains(a, b)`` — boundary-inclusive containment, in both
  directions (``contains_literal``, ``feature_contains``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from geomesa_tpu_torch.features import geometry as geo
from geomesa_tpu_torch.filter import geom_batch as gb
from geomesa_tpu_torch.filter import geom_numpy as gn


def _xy(arr: geo.GeometryArray, rows: np.ndarray
        ) -> Tuple[np.ndarray, np.ndarray]:
    x, y = arr.point_xy()
    rows = np.asarray(rows, dtype=np.int64)
    return x[rows], y[rows]


def area(arr: geo.GeometryArray, rows: np.ndarray) -> np.ndarray:
    """(len(rows),) f64 planar areas: 0 for points."""
    return np.zeros(len(rows), dtype=np.float64)


def length(arr: geo.GeometryArray, rows: np.ndarray) -> np.ndarray:
    """(len(rows),) f64 boundary lengths: 0 for points."""
    return np.zeros(len(rows), dtype=np.float64)


def centroid(arr: geo.GeometryArray, rows: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray]:
    """((C,) x, (C,) y) f64 centroids: a point's own coordinates (the
    reference's vertex mean of one vertex)."""
    return _xy(arr, rows)


def distance(arr: geo.GeometryArray, rows: np.ndarray,
             literal: tuple) -> np.ndarray:
    """(len(rows),) f64 exact min distances to the literal geometry."""
    return gb.batch_distance(arr, rows, literal)


def intersects(arr: geo.GeometryArray, rows: np.ndarray,
               literal: tuple) -> np.ndarray:
    """(len(rows),) bool — feature ∩ literal ≠ ∅ (symmetric)."""
    return gb.batch_intersects(arr, rows, literal)


def contains_literal(arr: geo.GeometryArray, rows: np.ndarray,
                     literal: tuple) -> np.ndarray:
    """literal CONTAINS feature (boundary-inclusive) — the
    ``st_contains(LITERAL, geom)`` direction: a polygonal literal contains
    the points within it, a point literal the coincident points, a lineal
    literal the points on it."""
    rows = np.asarray(rows, dtype=np.int64)
    lcode = literal[0]
    if lcode in (geo.POLYGON, geo.MULTIPOLYGON):
        return gb.batch_within(arr, rows, literal)
    x, y = _xy(arr, rows)
    if lcode in (geo.POINT, geo.MULTIPOINT):
        lc = gn.literal_coords(literal)
        return np.any((x[:, None] == lc[None, :, 0])
                      & (y[:, None] == lc[None, :, 1]), axis=1)
    return gn._points_on_segments(x, y, gn.literal_segments(literal))


def feature_contains(arr: geo.GeometryArray, rows: np.ndarray,
                     literal: tuple) -> np.ndarray:
    """feature CONTAINS literal (boundary-inclusive) — the
    ``st_contains(geom, LITERAL)`` direction: a point contains only an
    equal point literal."""
    rows = np.asarray(rows, dtype=np.int64)
    if literal[0] != geo.POINT:
        return np.zeros(len(rows), dtype=bool)
    x, y = _xy(arr, rows)
    px, py = float(literal[1][0]), float(literal[1][1])
    return (x == px) & (y == py)
