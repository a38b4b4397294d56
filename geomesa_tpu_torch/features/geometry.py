"""Point geometry storage + the WKT parsing the Z3 point path reads.

≙ ``geomesa_tpu.features.geometry`` reduced to pure point layers: the JAX
package keeps every geometry in one ragged GeoArrow-style buffer; a point
layer there is the degenerate case of one coordinate per feature, so here it
is two flat float64 arrays. WKT parses POINT and POLYGON literals (the
shapes of this slice's filters); geometry type codes keep the WKB numbering
of the reference package so filter literals compare equal across both.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

# geometry type codes (WKB-compatible numbering)
POINT, LINESTRING, POLYGON = 1, 2, 3
MULTIPOINT, MULTILINESTRING, MULTIPOLYGON = 4, 5, 6

_LATER = ("extent layers and the geometry catalog are not ported yet "
          "(ROADMAP.md Queue 1, items 9 and 13)")


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

    def take(self, idx: np.ndarray) -> "GeometryArray":
        idx = np.asarray(idx, dtype=np.int64)
        return GeometryArray(self.x[idx], self.y[idx])


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
    """POINT / POLYGON WKT → (type_code, nested lists), the literal form of
    the reference package's ``parse_wkt``."""
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
    if name == "POLYGON":
        return POLYGON, [_parse_coord_seq(g) for g in _split_groups(inner)]
    raise NotImplementedError(f"{name} literals: {_LATER}")
