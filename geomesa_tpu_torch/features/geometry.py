"""Columnar geometry storage (GeoArrow-style nested offsets) + WKT codec.

≙ ``geomesa_tpu.features.geometry``: one flat (M, 2) float64 coordinate
buffer with three levels of offsets — geometry → part → ring → coords — so
every geometry type shares one layout and per-feature envelopes are one
``reduceat`` away:

  - Point:            1 part, 1 ring, 1 coord
  - LineString:       1 part, 1 ring (the line), k coords
  - Polygon:          1 part, r rings (shell + holes)
  - MultiPoint:       p parts, each 1 ring / 1 coord
  - MultiLineString:  p parts, each 1 ring
  - MultiPolygon:     p parts, each r_i rings

A pure point column keeps only its two float64 arrays ``x`` and ``y`` (the
``points`` fast path): the reference shares one ``arange`` buffer between
its three offset levels and still stacks an (N, 2) copy of the
coordinates; here nothing beyond the two arrays is held, and the ragged
views (``type_codes``, offsets, ``coords``) are built only when a caller
asks for them. The bbox columns are what the XZ indexes and the envelope
filters read; exact predicates walk the ragged buffers on the host. Type
codes keep the WKB numbering of the reference package so filter literals
compare equal across both.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

# geometry type codes (WKB-compatible numbering)
POINT, LINESTRING, POLYGON = 1, 2, 3
MULTIPOINT, MULTILINESTRING, MULTIPOLYGON = 4, 5, 6

TYPE_NAMES = {
    POINT: "Point", LINESTRING: "LineString", POLYGON: "Polygon",
    MULTIPOINT: "MultiPoint", MULTILINESTRING: "MultiLineString",
    MULTIPOLYGON: "MultiPolygon",
}
NAME_TYPES = {v: k for k, v in TYPE_NAMES.items()}


def _exclusive_cumsum(counts: np.ndarray) -> np.ndarray:
    out = np.empty(len(counts), dtype=np.int64)
    if len(counts):
        out[0] = 0
        np.cumsum(counts[:-1], out=out[1:])
    return out


def expand_slices(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenate the index ranges [starts[i], starts[i]+counts[i]) without a
    Python loop (the workhorse for every ragged-buffer gather)."""
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    base = np.repeat(np.asarray(starts, dtype=np.int64)
                     - _exclusive_cumsum(counts), counts)
    return base + np.arange(total, dtype=np.int64)


def _offsets(counts: np.ndarray) -> np.ndarray:
    out = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=out[1:])
    return out


class GeometryArray:
    """Columnar geometry collection of length N: a point column (``x``,
    ``y``) or a ragged one (``type_codes`` int8, ``geom_offsets`` (N+1,),
    ``part_offsets`` (P+1,), ``ring_offsets`` (R+1,) int64, ``coords``
    (M, 2) float64). Both forms answer every accessor; the arrays are
    treated as immutable."""

    def __init__(self, type_codes, geom_offsets, part_offsets, ring_offsets,
                 coords):
        self.x = self.y = None
        self._tc = np.asarray(type_codes, dtype=np.int8)
        self._go = np.asarray(geom_offsets, dtype=np.int64)
        self._po = np.asarray(part_offsets, dtype=np.int64)
        self._ro = np.asarray(ring_offsets, dtype=np.int64)
        self._coords = np.asarray(coords, dtype=np.float64).reshape(-1, 2)
        self._bboxes = None

    def __len__(self) -> int:
        return len(self.x) if self.x is not None else len(self._tc)

    # -- constructors -------------------------------------------------------

    @classmethod
    def points(cls, x, y) -> "GeometryArray":
        """Fast path for pure point collections: two float64 arrays, no
        offsets."""
        self = cls.__new__(cls)
        self.x = np.asarray(x, dtype=np.float64)
        self.y = np.asarray(y, dtype=np.float64)
        if self.x.shape != self.y.shape or self.x.ndim != 1:
            raise ValueError("point x/y must be equal-length 1-D arrays")
        self._tc = self._go = self._po = self._ro = self._coords = None
        self._bboxes = None
        return self

    @classmethod
    def from_shapes(cls, shapes: Sequence[Tuple[int, list]]) -> "GeometryArray":
        """Build from (type_code, nested-coordinate-list) pairs.

        Nesting per type: Point [x, y]; LineString [[x,y],...];
        Polygon [ring, ...] where ring = [[x,y],...]; Multi* = list of members.
        A collection of Points only comes back as a point column.
        """
        if shapes and all(code == POINT for code, _ in shapes):
            xy = np.asarray([data for _, data in shapes], dtype=np.float64)
            return cls.points(xy[:, 0], xy[:, 1])
        type_codes, geom_off, part_off, ring_off = [], [0], [0], [0]
        coord_chunks: List[np.ndarray] = []
        n_parts = n_rings = n_coords = 0

        def add_ring(ring_coords):
            nonlocal n_coords, n_rings
            arr = np.asarray(ring_coords, dtype=np.float64).reshape(-1, 2)
            coord_chunks.append(arr)
            n_coords += len(arr)
            ring_off.append(n_coords)
            n_rings += 1

        def add_part(rings: Iterable) -> None:
            nonlocal n_parts
            for ring in rings:
                add_ring(ring)
            n_parts += 1
            part_off.append(n_rings)

        for code, data in shapes:
            type_codes.append(code)
            if code == POINT:
                add_part([[data]])
            elif code == LINESTRING:
                add_part([data])
            elif code == POLYGON:
                add_part(data)
            elif code == MULTIPOINT:
                for pt in data:
                    add_part([[pt]])
            elif code == MULTILINESTRING:
                for line in data:
                    add_part([line])
            elif code == MULTIPOLYGON:
                for poly in data:
                    add_part(poly)
            else:
                raise ValueError(f"Unsupported geometry type code {code}")
            geom_off.append(n_parts)

        coords = np.concatenate(coord_chunks, axis=0) if coord_chunks \
            else np.zeros((0, 2))
        return cls(np.array(type_codes), geom_off, part_off, ring_off, coords)

    @classmethod
    def from_wkt(cls, wkts: Sequence[str]) -> "GeometryArray":
        return cls.from_shapes([parse_wkt(w) for w in wkts])

    @classmethod
    def from_rows(cls, vals: Sequence) -> "GeometryArray":
        """Coerce per-row geometry values — (x, y) pairs or WKT strings —
        into a column (the row writers' sniff, ≙
        ``geomesa_tpu/features/geometry.py:150``)."""
        if vals and isinstance(vals[0], (tuple, list)) and len(vals[0]) == 2 \
                and isinstance(vals[0][0], (int, float)):
            xy = np.asarray(vals, dtype=np.float64)
            return cls.points(xy[:, 0], xy[:, 1])
        return cls.from_wkt(list(vals))

    @classmethod
    def linestrings(cls, coords: np.ndarray,
                    offsets: Optional[np.ndarray] = None) -> "GeometryArray":
        """Bulk LineString constructor from flat coordinate buffers (the
        vectorized ingest path: O(coords) numpy, no shape list).

        coords: (M, 2) float64 vertices. offsets: (N+1,) int64 vertex
        offsets per linestring; None = uniform 2-vertex segments (M/2
        features)."""
        coords = np.asarray(coords, dtype=np.float64)
        if offsets is None:
            if len(coords) % 2:
                raise ValueError("odd vertex count for 2-point segments")
            offsets = np.arange(0, len(coords) + 1, 2, dtype=np.int64)
        else:
            offsets = np.asarray(offsets, dtype=np.int64)
        n = len(offsets) - 1
        level = np.arange(n + 1, dtype=np.int64)
        return cls(np.full(n, LINESTRING, dtype=np.int8),
                   level, level.copy(), offsets, coords)

    # -- accessors ----------------------------------------------------------

    @property
    def is_point_column(self) -> bool:
        """True for the points fast-path form (two arrays, no offsets)."""
        return self.x is not None

    @property
    def is_points(self) -> bool:
        if self.x is not None:
            return True
        return bool(np.all(self._tc == POINT))

    def point_xy(self) -> Tuple[np.ndarray, np.ndarray]:
        """(x, y) arrays for pure-point collections."""
        if self.x is not None:
            return self.x, self.y
        if not self.is_points:
            raise ValueError("Not a pure point collection")
        return self._coords[:, 0], self._coords[:, 1]

    @property
    def type_codes(self) -> np.ndarray:
        """(N,) int8 type codes (built on each call for a point column)."""
        if self.x is not None:
            return np.full(len(self.x), POINT, dtype=np.int8)
        return self._tc

    def _levels(self) -> np.ndarray:
        return np.arange(len(self.x) + 1, dtype=np.int64)

    @property
    def geom_offsets(self) -> np.ndarray:
        return self._levels() if self.x is not None else self._go

    @property
    def part_offsets(self) -> np.ndarray:
        return self._levels() if self.x is not None else self._po

    @property
    def ring_offsets(self) -> np.ndarray:
        return self._levels() if self.x is not None else self._ro

    @property
    def coords(self) -> np.ndarray:
        """(M, 2) float64 coordinates (stacked on each call for a point
        column)."""
        if self.x is not None:
            return np.stack([self.x, self.y], axis=1)
        return self._coords

    def coord_slices(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(start, end) coordinate offsets of the features ``idx``."""
        idx = np.asarray(idx, dtype=np.int64)
        if self.x is not None:
            return idx, idx + 1
        starts = self._ro[self._po[self._go[idx]]]
        ends = self._ro[self._po[self._go[idx + 1]]]
        return starts, ends

    def bboxes(self) -> np.ndarray:
        """(N, 4) per-feature [xmin, ymin, xmax, ymax] — computed once and
        cached (read-only; every extent index and envelope filter reads
        it). Features own contiguous coordinate slices by construction, so
        ``reduceat`` over the per-feature start offsets reduces exactly each
        feature's coords."""
        if self._bboxes is not None:
            return self._bboxes
        n = len(self)
        out = np.empty((n, 4), dtype=np.float64)
        if self.x is not None:
            out[:, 0] = out[:, 2] = self.x
            out[:, 1] = out[:, 3] = self.y
        elif n:
            starts = self._ro[self._po[self._go[:-1]]]
            out[:, 0] = np.minimum.reduceat(self._coords[:, 0], starts)
            out[:, 1] = np.minimum.reduceat(self._coords[:, 1], starts)
            out[:, 2] = np.maximum.reduceat(self._coords[:, 0], starts)
            out[:, 3] = np.maximum.reduceat(self._coords[:, 1], starts)
        out.setflags(write=False)  # shared cache — guard against mutation
        self._bboxes = out
        return out

    def feature_coords(self, i: int) -> np.ndarray:
        """(k, 2) coordinates of feature i."""
        if self.x is not None:
            return np.array([[self.x[i], self.y[i]]], dtype=np.float64)
        s = self._ro[self._po[self._go[i]]]
        e = self._ro[self._po[self._go[i + 1]]]
        return self._coords[s:e]

    def shape(self, i: int):
        """(type_code, nested lists) for feature i (inverse of from_shapes)."""
        if self.x is not None:
            return POINT, [float(self.x[i]), float(self.y[i])]
        code = int(self._tc[i])
        parts = []
        for p in range(self._go[i], self._go[i + 1]):
            rings = []
            for r in range(self._po[p], self._po[p + 1]):
                s, e = self._ro[r], self._ro[r + 1]
                rings.append(self._coords[s:e].tolist())
            parts.append(rings)
        if code == POINT:
            return code, parts[0][0][0]
        if code == LINESTRING:
            return code, parts[0][0]
        if code == POLYGON:
            return code, parts[0]
        if code == MULTIPOINT:
            return code, [p[0][0] for p in parts]
        if code == MULTILINESTRING:
            return code, [p[0] for p in parts]
        return code, parts

    def wkt(self, i: int) -> str:
        return write_wkt(*self.shape(i))

    # -- row operations -----------------------------------------------------

    def take(self, idx: np.ndarray) -> "GeometryArray":
        """Gather a subset — vectorized offset rebuild, no per-feature loop."""
        idx = np.asarray(idx, dtype=np.int64)
        if self.x is not None:
            return GeometryArray.points(self.x[idx], self.y[idx])
        nparts = self._go[idx + 1] - self._go[idx]
        parts = expand_slices(self._go[idx], nparts)
        nrings = self._po[parts + 1] - self._po[parts]
        rings = expand_slices(self._po[parts], nrings)
        ncoords = self._ro[rings + 1] - self._ro[rings]
        sel = expand_slices(self._ro[rings], ncoords)
        return GeometryArray(
            self._tc[idx], _offsets(nparts), _offsets(nrings),
            _offsets(ncoords), self._coords[sel])

    @classmethod
    def concat(cls, arrays: Sequence["GeometryArray"]) -> "GeometryArray":
        """Vectorized concatenation: point columns stay a point column;
        otherwise coords stack and the offset levels shift by the running
        totals (O(coords); the LSM flush path depends on it)."""
        if all(a.x is not None for a in arrays):
            return cls.points(np.concatenate([a.x for a in arrays]),
                              np.concatenate([a.y for a in arrays]))
        tc = np.concatenate([a.type_codes for a in arrays])
        go = [np.zeros(1, np.int64)]
        po = [np.zeros(1, np.int64)]
        ro = [np.zeros(1, np.int64)]
        coords = []
        g_base = p_base = r_base = 0
        for a in arrays:
            ag, ap, ar = a.geom_offsets, a.part_offsets, a.ring_offsets
            go.append(ag[1:] + g_base)
            po.append(ap[1:] + p_base)
            ro.append(ar[1:] + r_base)
            coords.append(a.coords)
            g_base += int(ag[-1]) if len(a) else 0
            p_base += int(ap[-1]) if len(ap) else 0
            r_base += int(ar[-1]) if len(ar) else 0
        return cls(tc, np.concatenate(go), np.concatenate(po),
                   np.concatenate(ro), np.vstack(coords))

    def replace_rows(self, rows: np.ndarray,
                     new: "GeometryArray") -> "GeometryArray":
        """A copy with feature ``rows[j]`` replaced by ``new``'s feature j
        (the update writer's geometry patch)."""
        rows = np.asarray(rows, dtype=np.int64)
        if self.x is not None and new.x is not None:
            x, y = self.x.copy(), self.y.copy()
            x[rows], y[rows] = new.x, new.y
            return GeometryArray.points(x, y)
        order = np.arange(len(self), dtype=np.int64)
        order[rows] = len(self) + np.arange(len(rows), dtype=np.int64)
        return GeometryArray.concat([self, new]).take(order)


# ---------------------------------------------------------------------------
# WKT codec (host-side interchange; no JTS dependency)
# ---------------------------------------------------------------------------

_WKT_RE = re.compile(r"^\s*(\w+)\s*(EMPTY|\(.*\))\s*$", re.IGNORECASE | re.DOTALL)


def _parse_coord_seq(body: str) -> list:
    return [[float(t) for t in pair.split()[:2]] for pair in body.split(",")]


def _split_groups(body: str) -> List[str]:
    """Split '(...),(...),...' at top level parens."""
    groups, depth, start = [], 0, None
    for i, ch in enumerate(body):
        if ch == "(":
            if depth == 0:
                start = i + 1
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                groups.append(body[start:i])
    return groups


def parse_wkt(wkt: str) -> Tuple[int, list]:
    """WKT → (type_code, nested lists), the literal form of the reference
    package's ``parse_wkt``."""
    m = _WKT_RE.match(wkt)
    if not m:
        raise ValueError(f"Invalid WKT: {wkt[:80]}")
    name = m.group(1).upper()
    body = m.group(2)
    if body.upper() == "EMPTY":
        raise ValueError("EMPTY geometries not supported")
    inner = body[1:-1].strip()
    if name == "POINT":
        return POINT, _parse_coord_seq(inner)[0]
    if name == "LINESTRING":
        return LINESTRING, _parse_coord_seq(inner)
    if name == "POLYGON":
        return POLYGON, [_parse_coord_seq(g) for g in _split_groups(inner)]
    if name == "MULTIPOINT":
        if "(" in inner:
            return MULTIPOINT, [_parse_coord_seq(g)[0]
                                for g in _split_groups(inner)]
        return MULTIPOINT, _parse_coord_seq(inner)
    if name == "MULTILINESTRING":
        return MULTILINESTRING, [_parse_coord_seq(g)
                                 for g in _split_groups(inner)]
    if name == "MULTIPOLYGON":
        return MULTIPOLYGON, [[_parse_coord_seq(g) for g in _split_groups(p)]
                              for p in _split_groups(inner)]
    raise ValueError(f"Unsupported WKT type: {name}")


def _fmt_coords(coords: list) -> str:
    # .9g keeps ~1cm lon/lat precision; bare %g truncates to 6 significant
    # digits (~50m error at mid-latitudes)
    return ", ".join(f"{x:.9g} {y:.9g}" for x, y in coords)


def write_wkt(code: int, data: list) -> str:
    if code == POINT:
        return f"POINT ({data[0]:.9g} {data[1]:.9g})"
    if code == LINESTRING:
        return f"LINESTRING ({_fmt_coords(data)})"
    if code == POLYGON:
        rings = ", ".join(f"({_fmt_coords(r)})" for r in data)
        return f"POLYGON ({rings})"
    if code == MULTIPOINT:
        return f"MULTIPOINT ({_fmt_coords(data)})"
    if code == MULTILINESTRING:
        lines = ", ".join(f"({_fmt_coords(l)})" for l in data)
        return f"MULTILINESTRING ({lines})"
    if code == MULTIPOLYGON:
        polys = ", ".join("(" + ", ".join(f"({_fmt_coords(r)})" for r in p)
                          + ")" for p in data)
        return f"MULTIPOLYGON ({polys})"
    raise ValueError(f"Unsupported type code {code}")
