"""Point geometry storage + the WKT parsing the Z3 point path reads.

≙ ``geomesa_tpu.features.geometry`` reduced to pure point layers: the JAX
package keeps every geometry in one ragged GeoArrow-style buffer; a point
layer there is the degenerate case of one coordinate per feature, so here it
is two flat float64 arrays, with the per-feature views (``type_codes``,
``feature_coords``, ``shape``) that the host geometry
predicates read. WKT parses every literal type the reference's
``parse_wkt`` does; geometry type codes keep the WKB numbering of the
reference package so filter literals compare equal across both.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

# geometry type codes (WKB-compatible numbering)
POINT, LINESTRING, POLYGON = 1, 2, 3
MULTIPOINT, MULTILINESTRING, MULTIPOLYGON = 4, 5, 6

@dataclass
class GeometryArray:
    """Point collection of length N: float64 lon/lat, the exact values the
    host refine evaluates (the device holds f32 and fp62 projections)."""

    x: np.ndarray
    y: np.ndarray

    def __post_init__(self):
        self.x = np.asarray(self.x, dtype=np.float64)
        self.y = np.asarray(self.y, dtype=np.float64)
        if self.x.shape != self.y.shape or self.x.ndim != 1:
            raise ValueError("point x/y must be equal-length 1-D arrays")

    def __len__(self) -> int:
        return len(self.x)

    @classmethod
    def points(cls, x, y) -> "GeometryArray":
        return cls(x, y)

    @property
    def is_points(self) -> bool:
        return True

    def point_xy(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.x, self.y

    @property
    def type_codes(self) -> np.ndarray:
        """(N,) int8 type codes: every feature is a POINT."""
        return np.full(len(self), POINT, dtype=np.int8)

    def feature_coords(self, i: int) -> np.ndarray:
        """(1, 2) coordinates of feature i."""
        return np.array([[self.x[i], self.y[i]]], dtype=np.float64)

    def shape(self, i: int) -> Tuple[int, list]:
        """(type_code, nested lists) literal of feature i."""
        return POINT, [float(self.x[i]), float(self.y[i])]

    def take(self, idx: np.ndarray) -> "GeometryArray":
        idx = np.asarray(idx, dtype=np.int64)
        return GeometryArray(self.x[idx], self.y[idx])

    @classmethod
    def from_wkt(cls, wkts: Sequence[str]) -> "GeometryArray":
        """Point WKT literals → a column (≙ the reference's ``from_wkt``,
        ``geomesa_tpu/features/geometry.py:146``, for point layers)."""
        xy = np.empty((len(wkts), 2), dtype=np.float64)
        for i, w in enumerate(wkts):
            code, coords = parse_wkt(w)
            if code != POINT:
                raise NotImplementedError(
                    "non-point geometries in a column are not ported to "
                    "geomesa_tpu_torch yet (ROADMAP.md Queue 1, item 9)")
            xy[i] = coords
        return cls(xy[:, 0], xy[:, 1])

    @classmethod
    def from_rows(cls, vals: Sequence) -> "GeometryArray":
        """Coerce per-row geometry values — (x, y) pairs or WKT strings —
        into a column (the row writers' sniff, ≙
        ``geomesa_tpu/features/geometry.py:150``)."""
        if vals and isinstance(vals[0], (tuple, list)) and len(vals[0]) == 2 \
                and isinstance(vals[0][0], (int, float)):
            xy = np.asarray(vals, dtype=np.float64)
            return cls(xy[:, 0], xy[:, 1])
        return cls.from_wkt(list(vals))

    @classmethod
    def concat(cls, arrays: Sequence["GeometryArray"]) -> "GeometryArray":
        """Row concatenation (≙ ``geomesa_tpu/features/geometry.py:223``)."""
        return cls(np.concatenate([a.x for a in arrays]),
                   np.concatenate([a.y for a in arrays]))


# ---------------------------------------------------------------------------
# WKT parsing (host-side literals; no JTS dependency)
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
