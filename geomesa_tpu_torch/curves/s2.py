"""S2 curve: Hilbert ordering on the quadrilateralized-sphere cube.

A copy of ``geomesa_tpu.curves.s2`` (its imports rewritten). ≙ GeoMesa's
``S2SFC`` (geomesa-z3, ``curve/S2SFC.scala:17,27,61``), which delegates to Google's
S2 library (``S2CellId``/``S2RegionCoverer``). Like the Morton interleave the
reference takes from sfcurve, the curve math is implemented here directly —
vectorized numpy over the standard public cell-id scheme:

  lon/lat → unit vector → cube face (6) → quadratic (s,t) projection →
  level-30 (i,j) ints → Hilbert position via the 4-cell lookup recursion →
  63-bit key  [face:3][hilbert_pos:60]

Covering decomposes a lat/lon box into cell-id ranges by BFS over the cell
tree with a CONSERVATIVE lat/lon-rectangle test per cell (corner rect padded
by the cell's angular size, full-longitude for pole cells). The cover is a
superset by construction — exactness always comes from the fp62 device
masks, so cover slop costs only scan width, never correctness.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from geomesa_tpu_torch.curves.ranges import IndexRange, merge_ranges

MAX_LEVEL = 30

# Hilbert sub-cell traversal: for each orientation state (0..3), the order
# in which the four (i,j) quadrants are visited, and the child orientation.
# This is the standard 2-bit Hilbert recursion (the same tables S2 uses,
# expressed directly).
_POS_TO_IJ = np.array([
    [0, 1, 3, 2],   # state 0: visits (0,0),(0,1),(1,1),(1,0)
    [0, 2, 3, 1],   # state 1 (swapped axes)
    [3, 2, 0, 1],   # state 2 (inverted)
    [3, 1, 0, 2],   # state 3 (swapped+inverted)
], dtype=np.int64)
_IJ_TO_POS = np.zeros((4, 4), dtype=np.int64)
for _s in range(4):
    for _p in range(4):
        _IJ_TO_POS[_s, _POS_TO_IJ[_s, _p]] = _p
# orientation transition: state x position-visited -> child state
_NEXT_STATE = np.array([
    [1, 0, 0, 3],
    [0, 1, 1, 2],
    [3, 2, 2, 1],
    [2, 3, 3, 0],
], dtype=np.int64)


def _face_uv(x, y, z):
    """Unit-vector → (face, u, v) with the largest-axis rule."""
    ax, ay, az = np.abs(x), np.abs(y), np.abs(z)
    face = np.where(ax >= np.maximum(ay, az),
                    np.where(x >= 0, 0, 3),
                    np.where(ay >= az,
                             np.where(y >= 0, 1, 4),
                             np.where(z >= 0, 2, 5)))
    u = np.empty_like(x)
    v = np.empty_like(x)
    for f, (un, ud, vn, vd) in _FACE_AXES.items():
        m = face == f
        u[m] = un(x[m], y[m], z[m]) / ud(x[m], y[m], z[m])
        v[m] = vn(x[m], y[m], z[m]) / vd(x[m], y[m], z[m])
    return face, u, v


# per-face (u_num, u_den, v_num, v_den) axis selectors (S2's canonical frame)
_FACE_AXES = {
    0: (lambda x, y, z: y, lambda x, y, z: x,
        lambda x, y, z: z, lambda x, y, z: x),
    1: (lambda x, y, z: -x, lambda x, y, z: y,
        lambda x, y, z: z, lambda x, y, z: y),
    2: (lambda x, y, z: -x, lambda x, y, z: z,
        lambda x, y, z: -y, lambda x, y, z: z),
    3: (lambda x, y, z: z, lambda x, y, z: -x,
        lambda x, y, z: y, lambda x, y, z: -x),
    4: (lambda x, y, z: z, lambda x, y, z: -y,
        lambda x, y, z: -x, lambda x, y, z: -y),
    5: (lambda x, y, z: -y, lambda x, y, z: -z,
        lambda x, y, z: -x, lambda x, y, z: -z),
}


def _uv_to_st(u):
    """S2 quadratic projection (area-equalizing). Both where-branches
    evaluate, so clamp the radicands (negative only in the discarded lane)."""
    return np.where(u >= 0,
                    0.5 * np.sqrt(np.maximum(1 + 3 * u, 0.0)),
                    1 - 0.5 * np.sqrt(np.maximum(1 - 3 * u, 0.0)))


def _st_to_uv(s):
    return np.where(s >= 0.5,
                    (1.0 / 3.0) * (4 * s * s - 1),
                    (1.0 / 3.0) * (1 - 4 * (1 - s) * (1 - s)))


def lonlat_to_cell(lon, lat, level: int = MAX_LEVEL):
    """(face, i, j) ints at ``level`` for lon/lat degrees (vectorized)."""
    lon = np.radians(np.asarray(lon, dtype=np.float64))
    lat = np.radians(np.asarray(lat, dtype=np.float64))
    cl = np.cos(lat)
    x, y, z = cl * np.cos(lon), cl * np.sin(lon), np.sin(lat)
    face, u, v = _face_uv(x, y, z)
    size = 1 << level
    i = np.clip((_uv_to_st(u) * size).astype(np.int64), 0, size - 1)
    j = np.clip((_uv_to_st(v) * size).astype(np.int64), 0, size - 1)
    return face.astype(np.int64), i, j


def hilbert_pos(i, j, level: int = MAX_LEVEL):
    """(i, j) → Hilbert position (2*level bits), vectorized lookup descent."""
    i = np.asarray(i, dtype=np.int64)
    j = np.asarray(j, dtype=np.int64)
    pos = np.zeros_like(i)
    state = np.zeros_like(i)
    for l in range(level - 1, -1, -1):
        q = (((i >> l) & 1) << 1) | ((j >> l) & 1)  # quadrant bits (i major)
        p = _IJ_TO_POS[state, q]
        pos = (pos << 2) | p
        state = _NEXT_STATE[state, p]
    return pos


def hilbert_ij(pos, level: int = MAX_LEVEL):
    """Inverse of :func:`hilbert_pos`."""
    pos = np.asarray(pos, dtype=np.int64)
    i = np.zeros_like(pos)
    j = np.zeros_like(pos)
    state = np.zeros_like(pos)
    for l in range(level - 1, -1, -1):
        p = (pos >> (2 * l)) & 3
        q = _POS_TO_IJ[state, p]
        i = (i << 1) | (q >> 1)
        j = (j << 1) | (q & 1)
        state = _NEXT_STATE[state, p]
    return i, j


def cell_id(lon, lat) -> np.ndarray:
    """63-bit sort key: [face:3][hilbert_pos:60] at level 30."""
    face, i, j = lonlat_to_cell(lon, lat)
    return (face << 60) | hilbert_pos(i, j)


def cell_center(face: int, i: int, j: int, level: int) -> Tuple[float, float]:
    """lon/lat degrees of a cell center (host scalar; covering/tests)."""
    size = 1 << level
    s = (i + 0.5) / size
    t = (j + 0.5) / size
    return _st_lonlat(face, s, t)


def _st_lonlat(face, s, t):
    u = _st_to_uv(np.asarray(s, dtype=np.float64))
    v = _st_to_uv(np.asarray(t, dtype=np.float64))
    one = np.ones_like(u)
    # inverse of the _FACE_AXES forward ratios with the major axis at ±1
    if face == 0:
        x, y, z = one, u, v
    elif face == 1:
        x, y, z = -u, one, v
    elif face == 2:
        x, y, z = -u, -v, one
    elif face == 3:
        x, y, z = -one, v, u
    elif face == 4:
        x, y, z = -v, -one, u
    else:
        x, y, z = -v, -u, -one
    lon = np.degrees(np.arctan2(y, x))
    lat = np.degrees(np.arctan2(z, np.hypot(x, y)))
    return lon, lat


class S2SFC:
    """S2 curve facade mirroring the SFC interface (index / ranges)."""

    _cache: dict = {}

    def __init__(self, level: int = MAX_LEVEL):
        self.level = level

    @classmethod
    def apply(cls, level: int = MAX_LEVEL) -> "S2SFC":
        if level not in cls._cache:
            cls._cache[level] = cls(level)
        return cls._cache[level]

    def index(self, lon, lat, lenient: bool = False) -> np.ndarray:
        lon = np.asarray(lon, dtype=np.float64)
        lat = np.asarray(lat, dtype=np.float64)
        if lenient:
            lon = np.clip(lon, -180.0, 180.0)
            lat = np.clip(lat, -90.0, 90.0)
        elif np.any((lon < -180) | (lon > 180) | (lat < -90) | (lat > 90)):
            raise ValueError("Value(s) out of bounds for s2 index")
        return cell_id(lon, lat)

    def invert(self, ids) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.asarray(ids, dtype=np.int64)
        face = ids >> 60
        i, j = hilbert_ij(ids & ((1 << 60) - 1))
        size = 1 << MAX_LEVEL
        out_lon = np.empty(len(ids))
        out_lat = np.empty(len(ids))
        for f in range(6):
            m = face == f
            if not m.any():
                continue
            lon, lat = _st_lonlat(f, (i[m] + 0.5) / size, (j[m] + 0.5) / size)
            out_lon[m] = lon
            out_lat[m] = lat
        return out_lon, out_lat

    # -- covering -----------------------------------------------------------

    def ranges(self, boxes: Sequence[Tuple[float, float, float, float]],
               max_ranges: Optional[int] = None,
               max_level: int = 18) -> List[IndexRange]:
        """Cell-id ranges covering the union of lon/lat boxes.

        BFS over the cell tree with a conservative per-cell lat/lon rect
        (corner rect padded by the cell's angular extent; pole cells span
        all longitudes) — a SUPERSET of every cell intersecting a box. The
        fp62 device masks re-check exactly, so slop only widens the scan.
        """
        max_ranges = max_ranges or 2000
        boxes = [tuple(map(float, b)) for b in boxes]
        out: List[IndexRange] = []
        queue: List[Tuple[int, int, int, int]] = [
            (f, 0, 0, 0) for f in range(6)]
        while queue:
            nxt: List[Tuple[int, int, int, int]] = []
            for face, i, j, level in queue:
                rect = self._cell_rect(face, i, j, level)
                if not any(_rect_overlap(rect, b) for b in boxes):
                    continue
                if level >= max_level or len(out) + len(nxt) >= max_ranges:
                    out.append(self._cell_range(face, i, j, level))
                    continue
                for di in (0, 1):
                    for dj in (0, 1):
                        nxt.append((face, (i << 1) | di, (j << 1) | dj,
                                    level + 1))
            queue = nxt
        return merge_ranges(out)

    # 5 samples per edge: the lat/lon extremes of a cell lie on its
    # boundary (the only interior critical points are the poles, which sit
    # at cell corners for level >= 1), and denser boundary sampling shrinks
    # the conservative pad from 2 cells (r4) to a quarter cell — measured
    # cover slop 1.37x -> 1.10x of true rows on 1M uniform points over
    # random boxes (z2 on the same boxes: 1.02x); superset property pinned
    # by the randomized covers in tests/test_s2.py
    _EDGE_K = np.linspace(0.0, 1.0, 5)
    _EDGE_SS = np.concatenate([_EDGE_K, _EDGE_K, np.zeros(5), np.ones(5)])
    _EDGE_TT = np.concatenate([np.zeros(5), np.ones(5), _EDGE_K, _EDGE_K])

    def _cell_rect(self, face, i, j, level):
        """Conservative (lon0, lat0, lon1, lat1) bounds of a cell;
        (-180, lat0, 180, lat1) for pole-adjacent/antimeridian cells."""
        if level == 0:
            # boundary sampling is blind to the poles at level 0 — they sit
            # INSIDE faces 2/5, not on an edge (from level 1 down they are
            # cell corners). Six whole-sphere rects cost the BFS nothing.
            return (-180.0, -90.0, 180.0, 90.0)
        size = 1 << level
        lon, lat = _st_lonlat(face, (i + self._EDGE_SS) / size,
                              (j + self._EDGE_TT) / size)
        cell = 90.0 / (1 << level)
        pad = cell * 0.25 + 1e-9
        lat0 = max(-90.0, float(lat.min()) - pad)
        lat1 = min(90.0, float(lat.max()) + pad)
        lon0, lon1 = float(lon.min()), float(lon.max())
        # the pole guard stays at the OLD 2-cell width on purpose: near the
        # pole the sampled lon range is meaningless however small the lat
        # pad is, so widen to all longitudes well before it matters
        if lat1 >= 90.0 - 2.0 * cell or lat0 <= -90.0 + 2.0 * cell \
                or (lon1 - lon0) > 180.0:
            return (-180.0, lat0, 180.0, lat1)
        max_abs_lat = max(abs(lat0), abs(lat1))
        lon_pad = min(180.0, pad / max(0.05, float(np.cos(np.radians(max_abs_lat)))))
        return (max(-180.0, lon0 - lon_pad), lat0,
                min(180.0, lon1 + lon_pad), lat1)

    def _cell_range(self, face, i, j, level) -> IndexRange:
        """Leaf-id interval covered by a cell."""
        shift = 2 * (MAX_LEVEL - level)
        pos = hilbert_pos(np.int64(i), np.int64(j), level)
        lo = (np.int64(face) << 60) | (pos << shift)
        return IndexRange(int(lo), int(lo + (1 << shift) - 1), False)


def _rect_overlap(a, b) -> bool:
    ax0, ay0, ax1, ay1 = a
    bx0, by0, bx1, by1 = b
    return ax0 <= bx1 and ax1 >= bx0 and ay0 <= by1 and ay1 >= by0
