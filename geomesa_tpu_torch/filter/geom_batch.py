"""Batched host geometry predicates over candidate sets of a point layer.

≙ ``geomesa_tpu.filter.geom_batch``: the exact f64 predicates the host
refine and the geometry functions evaluate over thousands of candidate
features at once — every test one chunked numpy broadcast instead of a
per-feature loop. The reference batches ragged features (coordinate and
segment "soups" tagged with a candidate ordinal, reduced per feature);
the port's ``GeometryArray`` is a point column, so each candidate owns
exactly one coordinate and no boundary segment, and each per-feature
reduction of the reference is the identity here. What remains is, term
for term, the reference's computation on point features; the soups of
ragged features (polygon and line layers) come with the extent layers
(ROADMAP.md Queue 1, item 9).

Semantics are identical to the scalar oracles in ``filter.geom_numpy``.
"""

from __future__ import annotations

import numpy as np

from geomesa_tpu_torch.features import geometry as geo
from geomesa_tpu_torch.filter import geom_numpy as gn

# max elements in any broadcast temporary (~32 MB of f64)
_CHUNK = 4_000_000


def gather_coords(arr: geo.GeometryArray, idx: np.ndarray) -> np.ndarray:
    """(C, 2) f64 coordinates of the selected point features (candidate k
    owns row k)."""
    idx = np.asarray(idx, dtype=np.int64)
    x, y = arr.point_xy()
    return np.stack([x[idx], y[idx]], axis=1)


# -- chunked broadcasts ------------------------------------------------------


def _pip_chunked(px: np.ndarray, py: np.ndarray, literal: tuple) -> np.ndarray:
    """points_in_polygon with bounded temporaries."""
    n = len(px)
    nv = max(1, len(gn.literal_coords(literal)))
    step = max(1, _CHUNK // nv)
    if n <= step:
        return gn.points_in_polygon(px, py, literal)
    out = np.empty(n, dtype=bool)
    for i in range(0, n, step):
        out[i:i + step] = gn.points_in_polygon(px[i:i + step], py[i:i + step],
                                               literal)
    return out


def _point_eq_chunked(coords: np.ndarray, lc: np.ndarray) -> np.ndarray:
    """Vertex == any-literal-point equality with bounded temporaries."""
    n = len(coords)
    step = max(1, _CHUNK // max(1, len(lc)))
    out = np.empty(n, dtype=bool)
    for i in range(0, n, step):
        ch = coords[i:i + step]
        out[i:i + step] = np.any((ch[:, None, 0] == lc[None, :, 0])
                                 & (ch[:, None, 1] == lc[None, :, 1]), axis=1)
    return out


def _vertex_dist_chunked(coords: np.ndarray, lc: np.ndarray) -> np.ndarray:
    """Min vertex-to-literal-point distance with bounded temporaries."""
    n = len(coords)
    step = max(1, _CHUNK // max(1, len(lc)))
    out = np.empty(n)
    for i in range(0, n, step):
        ch = coords[i:i + step]
        out[i:i + step] = np.min(np.hypot(ch[:, None, 0] - lc[None, :, 0],
                                          ch[:, None, 1] - lc[None, :, 1]),
                                 axis=1)
    return out


def _on_segments_chunked(px, py, segs: np.ndarray) -> np.ndarray:
    n = len(px)
    step = max(1, _CHUNK // max(1, len(segs)))
    out = np.empty(n, dtype=bool)
    for i in range(0, n, step):
        out[i:i + step] = gn._points_on_segments(px[i:i + step],
                                                 py[i:i + step], segs)
    return out


def _point_to_segs_min(coords: np.ndarray, lsegs: np.ndarray) -> np.ndarray:
    """(C,) min distance from each point to any of the (S ≥ 1) literal
    segments."""
    step = max(1, _CHUNK // len(lsegs))
    dv = np.empty(len(coords))
    for i in range(0, len(coords), step):
        dv[i:i + step] = gn.point_segment_distance(
            coords[i:i + step, 0], coords[i:i + step, 1], lsegs)
    return dv


# -- public batched predicates ----------------------------------------------


def batch_intersects(arr: geo.GeometryArray, idx: np.ndarray,
                     literal: tuple) -> np.ndarray:
    """bool (len(idx),): intersects per candidate point, semantics
    identical to geom_numpy.geometry_intersects: inside a polygonal literal
    (boundary included), equal to a vertex of a point literal, or on a
    segment of a lineal literal."""
    coords = gather_coords(arr, idx)
    c = len(coords)
    out = np.zeros(c, dtype=bool)
    if c == 0:
        return out
    lcode = literal[0]
    if lcode in (geo.POLYGON, geo.MULTIPOLYGON):
        out |= _pip_chunked(coords[:, 0], coords[:, 1], literal)
    if lcode in (geo.POINT, geo.MULTIPOINT):
        out |= _point_eq_chunked(coords, gn.literal_coords(literal))
    elif lcode in (geo.LINESTRING, geo.MULTILINESTRING):
        out |= _on_segments_chunked(coords[:, 0], coords[:, 1],
                                    gn.literal_segments(literal))
    return out


def batch_within(arr: geo.GeometryArray, idx: np.ndarray,
                 literal: tuple) -> np.ndarray:
    """bool (len(idx),): point within a polygonal literal (boundary
    included) — the reference's ``geometry_within`` for a point, which has
    no segment that could cross out."""
    coords = gather_coords(arr, idx)
    if len(coords) == 0:
        return np.zeros(0, dtype=bool)
    return _pip_chunked(coords[:, 0], coords[:, 1], literal)


def batch_distance(arr: geo.GeometryArray, idx: np.ndarray,
                   literal: tuple) -> np.ndarray:
    """float (len(idx),): min distance per candidate point — semantics
    identical to geom_numpy.geometry_distance (0 where it intersects)."""
    coords = gather_coords(arr, idx)
    c = len(coords)
    if c == 0:
        return np.zeros(0)
    inter = batch_intersects(arr, idx, literal)
    lsegs = gn.literal_segments(literal)
    d = np.full(c, np.inf)
    if len(lsegs):
        d = np.minimum(d, _point_to_segs_min(coords, lsegs))
    else:
        # point-ish literal: pure vertex distances
        d = np.minimum(d, _vertex_dist_chunked(coords,
                                               gn.literal_coords(literal)))
    d[inter] = 0.0
    return d
