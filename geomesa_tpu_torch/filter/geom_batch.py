"""Batched host geometry predicates over candidate sets.

≙ ``geomesa_tpu.filter.geom_batch``: the device scan returns candidate row
sets, and the residual spatial refine evaluates exact geometry predicates
over thousands of features at once — not a per-feature Python loop: all
candidates' coordinates and boundary segments are flattened into "soups"
tagged with a candidate ordinal, every geometric test runs as one (chunked)
numpy broadcast, and per-feature verdicts come back via ``bincount``/
``reduceat`` group reductions. A point column (``GeometryArray.points``)
takes its own shortcut, term for term the same computation without the
soups (each candidate owns one coordinate and no segment).

Semantics are identical to the scalar oracles in ``filter.geom_numpy``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from geomesa_tpu_torch.features import geometry as geo
from geomesa_tpu_torch.filter import geom_numpy as gn

# max elements in any broadcast temporary (~32 MB of f64)
_CHUNK = 4_000_000

_expand_slices = geo.expand_slices


def gather_coords(arr: geo.GeometryArray, idx: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """All coordinates of the selected features: ((M, 2) f64, (M,) ordinal).

    Ordinals index into ``idx`` (0..C-1) and come out grouped ascending —
    features own contiguous coordinate slices by construction. A point
    column gathers its two arrays directly (candidate k owns row k).
    """
    idx = np.asarray(idx, dtype=np.int64)
    if arr.is_point_column:
        return (np.stack([arr.x[idx], arr.y[idx]], axis=1),
                np.arange(len(idx), dtype=np.int64))
    starts, ends = arr.coord_slices(idx)
    counts = ends - starts
    sel = _expand_slices(starts, counts)
    fid = np.repeat(np.arange(len(idx), dtype=np.int64), counts)
    return arr.coords[sel], fid


def build_segments(arr: geo.GeometryArray, idx: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Boundary-segment soup of the selected features.

    Returns ((S, 4) f64 [x1 y1 x2 y2], (S,) ordinal), ordinals grouped
    ascending. Rings of polygonal features gain a closing segment when stored
    unclosed (a degenerate duplicate is never added).
    """
    idx = np.asarray(idx, dtype=np.int64)
    c = len(idx)
    if arr.is_point_column:
        return np.zeros((0, 4)), np.zeros(0, dtype=np.int64)
    g0, g1 = arr.geom_offsets[idx], arr.geom_offsets[idx + 1]
    r0, r1 = arr.part_offsets[g0], arr.part_offsets[g1]
    nrings = r1 - r0
    rings = _expand_slices(r0, nrings)
    if len(rings) == 0:
        return np.zeros((0, 4)), np.zeros(0, dtype=np.int64)
    ring_fid = np.repeat(np.arange(c, dtype=np.int64), nrings)
    s, e = arr.ring_offsets[rings], arr.ring_offsets[rings + 1]
    k = e - s
    nseg = np.maximum(k - 1, 0)
    a = _expand_slices(s, nseg)
    segs = np.concatenate([arr.coords[a], arr.coords[a + 1]], axis=1)
    seg_fid = np.repeat(ring_fid, nseg)

    is_poly = np.isin(arr.type_codes[idx], (geo.POLYGON, geo.MULTIPOLYGON))
    need = is_poly[ring_fid] & (k >= 3) \
        & np.any(arr.coords[s] != arr.coords[np.maximum(e - 1, s)], axis=1)
    if np.any(need):
        close = np.concatenate([arr.coords[e[need] - 1], arr.coords[s[need]]],
                               axis=1)
        segs = np.concatenate([segs, close])
        seg_fid = np.concatenate([seg_fid, ring_fid[need]])
        order = np.argsort(seg_fid, kind="stable")
        segs, seg_fid = segs[order], seg_fid[order]
    return segs, seg_fid


# -- group reductions --------------------------------------------------------


def _any_per_feature(fid: np.ndarray, hits: np.ndarray, c: int) -> np.ndarray:
    """bool (c,): any item with this ordinal is True."""
    if len(fid) == 0:
        return np.zeros(c, dtype=bool)
    return np.bincount(fid[hits], minlength=c).astype(bool)


def _min_per_feature(fid: np.ndarray, vals: np.ndarray, c: int) -> np.ndarray:
    """float (c,): min value per ordinal (inf where a feature has no items).
    Requires ``fid`` grouped ascending (gather_coords/build_segments order)."""
    out = np.full(c, np.inf)
    if len(fid) == 0:
        return out
    present, first = np.unique(fid, return_index=True)
    out[present] = np.minimum.reduceat(vals, first)
    return out


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
    """Any-vertex == any-literal-point equality with bounded temporaries
    (the raw (n_coords x n_literal) broadcast blows the temp budget for a
    large candidate set against a large MULTIPOINT literal)."""
    n = len(coords)
    step = max(1, _CHUNK // max(1, len(lc)))
    if n <= step:
        return np.any((coords[:, None, 0] == lc[None, :, 0])
                      & (coords[:, None, 1] == lc[None, :, 1]), axis=1)
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
    if n <= step:
        return np.min(np.hypot(coords[:, None, 0] - lc[None, :, 0],
                               coords[:, None, 1] - lc[None, :, 1]), axis=1)
    out = np.empty(n)
    for i in range(0, n, step):
        ch = coords[i:i + step]
        out[i:i + step] = np.min(np.hypot(ch[:, None, 0] - lc[None, :, 0],
                                          ch[:, None, 1] - lc[None, :, 1]),
                                 axis=1)
    return out


def _on_segments_chunked(px, py, segs: np.ndarray) -> np.ndarray:
    n = len(px)
    ns = max(1, len(segs))
    step = max(1, _CHUNK // ns)
    if n <= step:
        return gn._points_on_segments(px, py, segs)
    out = np.empty(n, dtype=bool)
    for i in range(0, n, step):
        out[i:i + step] = gn._points_on_segments(px[i:i + step],
                                                 py[i:i + step], segs)
    return out


def _points_in_features(lx: np.ndarray, ly: np.ndarray, segs: np.ndarray,
                        seg_fid: np.ndarray, c: int) -> np.ndarray:
    """bool (c,): any of the query points falls inside the feature by
    crossing parity over ALL the feature's ring segments (holes toggle;
    disjoint multipolygon members contribute even counts). Mirrors the
    accumulation in geom_numpy.points_in_polygon."""
    out = np.zeros(c, dtype=bool)
    s = len(segs)
    if s == 0 or len(lx) == 0:
        return out
    present, first = np.unique(seg_fid, return_index=True)
    x1, y1, x2, y2 = segs[:, 0], segs[:, 1], segs[:, 2], segs[:, 3]
    step = max(1, _CHUNK // s)
    for i in range(0, len(lx), step):
        pxv = lx[i:i + step, None]
        pyv = ly[i:i + step, None]
        cond = (y1 > pyv) != (y2 > pyv)
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = (x2 - x1) * (pyv - y1) / (y2 - y1) + x1
        cross = cond & (pxv < xint)                       # (l, S)
        counts = np.add.reduceat(cross, first, axis=1)    # (l, |present|)
        out[present] |= np.any(counts % 2 == 1, axis=0)
    return out


def _segs_touch(segs: np.ndarray, seg_fid: np.ndarray, lsegs: np.ndarray,
                c: int, proper_only: bool = False) -> np.ndarray:
    """bool (c,): any feature segment crosses (or, proper_only, *properly*
    crosses) any literal segment. Orientation convention matches
    geom_numpy.segments_cross exactly."""
    out = np.zeros(c, dtype=bool)
    s, sl = len(segs), len(lsegs)
    if s == 0 or sl == 0:
        return out
    bx1, by1, bx2, by2 = (lsegs[:, j][None, :] for j in range(4))
    hit = np.zeros(s, dtype=bool)
    step = max(1, _CHUNK // sl)
    for i in range(0, s, step):
        a = segs[i:i + step]
        ax1, ay1, ax2, ay2 = (a[:, j][:, None] for j in range(4))
        d1 = (bx1 - ax1) * (ay2 - ay1) - (by1 - ay1) * (ax2 - ax1)
        d2 = (bx2 - ax1) * (ay2 - ay1) - (by2 - ay1) * (ax2 - ax1)
        d3 = (ax1 - bx1) * (by2 - by1) - (ay1 - by1) * (bx2 - bx1)
        d4 = (ax2 - bx1) * (by2 - by1) - (ay2 - by1) * (bx2 - bx1)
        # NB: orient(o, p, q) = (q-o) x (p-o) with the scalar convention
        # orient(ox,oy,px,py,qx,qy) = (px-ox)(qy-oy)-(py-oy)(qx-ox); the signs
        # above are its negation uniformly, which leaves sign-products intact.
        m = ((d1 * d2) < 0) & ((d3 * d4) < 0)
        if not proper_only:
            def on(ox, oy, qx, qy, px_, py_, d):
                return (d == 0) & (np.minimum(ox, qx) <= px_) \
                    & (px_ <= np.maximum(ox, qx)) \
                    & (np.minimum(oy, qy) <= py_) & (py_ <= np.maximum(oy, qy))
            m |= on(ax1, ay1, ax2, ay2, bx1, by1, d1) \
                | on(ax1, ay1, ax2, ay2, bx2, by2, d2) \
                | on(bx1, by1, bx2, by2, ax1, ay1, d3) \
                | on(bx1, by1, bx2, by2, ax2, ay2, d4)
        hit[i:i + step] = np.any(m, axis=1)
    return _any_per_feature(seg_fid, hit, c)


def _point_to_segs_min(coords: np.ndarray, fid: np.ndarray, lsegs: np.ndarray,
                       c: int) -> np.ndarray:
    """float (c,): min distance from any feature vertex to any literal seg."""
    if len(lsegs) == 0 or len(coords) == 0:
        return np.full(c, np.inf)
    step = max(1, _CHUNK // len(lsegs))
    dv = np.empty(len(coords))
    for i in range(0, len(coords), step):
        dv[i:i + step] = gn.point_segment_distance(
            coords[i:i + step, 0], coords[i:i + step, 1], lsegs)
    return _min_per_feature(fid, dv, c)


# -- public batched predicates ----------------------------------------------


def batch_intersects(arr: geo.GeometryArray, idx: np.ndarray,
                     literal: tuple, _soups=None) -> np.ndarray:
    """bool (len(idx),): exact-ish intersects per candidate feature,
    semantics identical to geom_numpy.geometry_intersects.

    ``_soups``: optional precomputed (coords, cfid, segs, sfid) for the same
    idx — batch_distance shares them to avoid rebuilding."""
    idx = np.asarray(idx, dtype=np.int64)
    if arr.is_point_column:
        return _points_intersects(arr, idx, literal)
    c = len(idx)
    out = np.zeros(c, dtype=bool)
    if c == 0:
        return out
    lcode = literal[0]
    fcodes = arr.type_codes[idx]
    if _soups is None:
        coords, cfid = gather_coords(arr, idx)
        segs, sfid = build_segments(arr, idx)
    else:
        coords, cfid, segs, sfid = _soups
    lsegs = gn.literal_segments(literal)
    lc = gn.literal_coords(literal)

    # feature vertex inside polygonal literal (incl. boundary)
    if lcode in (geo.POLYGON, geo.MULTIPOLYGON):
        pip = _pip_chunked(coords[:, 0], coords[:, 1], literal)
        out |= _any_per_feature(cfid, pip, c)

    # literal vertex strictly inside polygonal feature (parity; the boundary
    # case is covered by the segment touch tests below)
    poly_feat = np.isin(fcodes, (geo.POLYGON, geo.MULTIPOLYGON))
    todo = poly_feat & ~out
    if np.any(todo):
        sub = np.nonzero(todo)[0]
        psegs, pfid = build_segments(arr, idx[sub])
        out[sub] |= _points_in_features(lc[:, 0], lc[:, 1], psegs, pfid,
                                        len(sub))

    # boundary segments touch
    out |= _segs_touch(segs, sfid, lsegs, c)

    # point-ish features / literals
    point_feat = np.isin(fcodes, (geo.POINT, geo.MULTIPOINT))
    if np.any(point_feat):
        pf = point_feat[cfid]
        if lcode in (geo.POINT, geo.MULTIPOINT):
            eq = _point_eq_chunked(coords, lc)
            out |= _any_per_feature(cfid, eq & pf, c)
        elif lcode in (geo.LINESTRING, geo.MULTILINESTRING):
            on = _on_segments_chunked(coords[:, 0], coords[:, 1], lsegs)
            out |= _any_per_feature(cfid, on & pf, c)
    if lcode in (geo.POINT, geo.MULTIPOINT) and len(segs):
        # literal vertex on a feature boundary segment
        seg_hit = _any_point_on_each_segment(lc, segs)
        out |= _any_per_feature(sfid, seg_hit, c)
    return out


def _any_point_on_each_segment(pts: np.ndarray, segs: np.ndarray,
                               eps: float = 1e-12) -> np.ndarray:
    """bool (S,): any of the points lies on each segment (same collinearity
    rule as geom_numpy._points_on_segments, reduced over points)."""
    s = len(segs)
    out = np.zeros(s, dtype=bool)
    if s == 0 or len(pts) == 0:
        return out
    px, py = pts[None, :, 0], pts[None, :, 1]
    step = max(1, _CHUNK // len(pts))
    for i in range(0, s, step):
        sub = segs[i:i + step]
        x1, y1 = sub[:, 0][:, None], sub[:, 1][:, None]
        x2, y2 = sub[:, 2][:, None], sub[:, 3][:, None]
        cross = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)
        scale = np.maximum(np.abs(x2 - x1), np.abs(y2 - y1)) + eps
        collinear = np.abs(cross) <= eps * scale * np.maximum(
            1.0, np.maximum(np.abs(px), np.abs(py)))
        within = ((np.minimum(x1, x2) - eps <= px)
                  & (px <= np.maximum(x1, x2) + eps)
                  & (np.minimum(y1, y2) - eps <= py)
                  & (py <= np.maximum(y1, y2) + eps))
        out[i:i + step] = np.any(collinear & within, axis=1)
    return out


def batch_within(arr: geo.GeometryArray, idx: np.ndarray,
                 literal: tuple) -> np.ndarray:
    """bool (len(idx),): feature entirely within a polygonal literal —
    semantics identical to geom_numpy.geometry_within."""
    idx = np.asarray(idx, dtype=np.int64)
    if arr.is_point_column:
        return _points_within(arr, idx, literal)
    c = len(idx)
    if c == 0:
        return np.zeros(0, dtype=bool)
    coords, cfid = gather_coords(arr, idx)
    pip = _pip_chunked(coords[:, 0], coords[:, 1], literal)
    all_in = np.bincount(cfid[~pip], minlength=c) == 0
    segs, sfid = build_segments(arr, idx)
    proper = _segs_touch(segs, sfid, gn.literal_segments(literal), c,
                         proper_only=True)
    return all_in & ~proper


def batch_distance(arr: geo.GeometryArray, idx: np.ndarray,
                   literal: tuple) -> np.ndarray:
    """float (len(idx),): approx min distance per candidate feature —
    semantics identical to geom_numpy.geometry_distance."""
    idx = np.asarray(idx, dtype=np.int64)
    if arr.is_point_column:
        return _points_distance(arr, idx, literal)
    c = len(idx)
    if c == 0:
        return np.zeros(0)
    coords, cfid = gather_coords(arr, idx)
    segs, sfid = build_segments(arr, idx)
    inter = batch_intersects(arr, idx, literal,
                             _soups=(coords, cfid, segs, sfid))
    lsegs = gn.literal_segments(literal)
    lc = gn.literal_coords(literal)
    d = np.full(c, np.inf)
    if len(lsegs):
        d = np.minimum(d, _point_to_segs_min(coords, cfid, lsegs, c))
    if len(segs):
        # literal vertices to feature segments: per-segment min over the
        # literal's vertices, then per-feature min
        step = max(1, _CHUNK // max(1, len(lc)))
        dm = np.empty(len(segs))
        for i in range(0, len(segs), step):
            sub = segs[i:i + step]
            dm[i:i + step] = _segs_to_points_min(sub, lc)
        d = np.minimum(d, _min_per_feature(sfid, dm, c))
    if not len(lsegs):
        # point-ish literal vs point-ish features: pure vertex distances
        has_segs = np.bincount(sfid, minlength=c) > 0 if len(segs) \
            else np.zeros(c, dtype=bool)
        nose = ~has_segs
        if np.any(nose):
            pv = nose[cfid]
            dv = _vertex_dist_chunked(coords[pv], lc)
            d = np.minimum(d, _min_per_feature(cfid[pv], dv, c))
    d[inter] = 0.0
    return d


def _segs_to_points_min(segs: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """float (S,): min distance from each segment to any point."""
    x1, y1 = segs[:, 0][:, None], segs[:, 1][:, None]
    x2, y2 = segs[:, 2][:, None], segs[:, 3][:, None]
    px, py = pts[None, :, 0], pts[None, :, 1]
    dx, dy = x2 - x1, y2 - y1
    ll = dx * dx + dy * dy
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.clip(((px - x1) * dx + (py - y1) * dy)
                    / np.where(ll == 0, 1, ll), 0, 1)
    cx, cy = x1 + t * dx, y1 + t * dy
    return np.sqrt(np.min((px - cx) ** 2 + (py - cy) ** 2, axis=1))


# -- point columns ------------------------------------------------------------
#
# A point feature owns one coordinate and no boundary segment, so each
# per-feature reduction of the ragged path is the identity: these are the
# ragged functions' terms for points, without the soups.


def _points_intersects(arr: geo.GeometryArray, idx: np.ndarray,
                       literal: tuple) -> np.ndarray:
    """bool (len(idx),): intersects per candidate point, semantics
    identical to geom_numpy.geometry_intersects: inside a polygonal literal
    (boundary included), equal to a vertex of a point literal, or on a
    segment of a lineal literal."""
    coords = gather_coords(arr, idx)[0]
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


def _points_within(arr: geo.GeometryArray, idx: np.ndarray,
                   literal: tuple) -> np.ndarray:
    """bool (len(idx),): point within a polygonal literal (boundary
    included) — the reference's ``geometry_within`` for a point, which has
    no segment that could cross out."""
    coords = gather_coords(arr, idx)[0]
    if len(coords) == 0:
        return np.zeros(0, dtype=bool)
    return _pip_chunked(coords[:, 0], coords[:, 1], literal)


def _points_distance(arr: geo.GeometryArray, idx: np.ndarray,
                     literal: tuple) -> np.ndarray:
    """float (len(idx),): min distance per candidate point — semantics
    identical to geom_numpy.geometry_distance (0 where it intersects)."""
    coords = gather_coords(arr, idx)[0]
    c = len(coords)
    if c == 0:
        return np.zeros(0)
    inter = _points_intersects(arr, idx, literal)
    lsegs = gn.literal_segments(literal)
    d = np.full(c, np.inf)
    if len(lsegs):
        d = np.minimum(d, _point_to_segs_min(
            coords, np.arange(c, dtype=np.int64), lsegs, c))
    else:
        # point-ish literal: pure vertex distances
        d = np.minimum(d, _vertex_dist_chunked(coords,
                                               gn.literal_coords(literal)))
    d[inter] = 0.0
    return d
