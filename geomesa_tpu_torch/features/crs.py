"""Coordinate reprojection for query output (≙ the reference's
QueryReferenceSystems / reprojection step in QueryPlanner.runQuery:59-93,
geomesa-index-api planning/QueryRunner.scala:293).

The framework stores everything in EPSG:4326 (lon/lat WGS84, GeoMesa's wire
CRS); output reprojection supports the web-mapping workhorse EPSG:3857
(spherical mercator) in closed form — vectorized numpy, no external proj
dependency.
"""

from __future__ import annotations

import numpy as np

_R = 6378137.0  # WGS84 spherical mercator radius
_MAX_LAT = 85.051128779806604  # atan(sinh(pi)) — mercator clamp


def _norm(code) -> str:
    c = str(code).upper()
    if c in ("4326", "EPSG:4326", "CRS:84", "WGS84"):
        return "EPSG:4326"
    if c in ("3857", "EPSG:3857", "EPSG:900913", "WEB_MERCATOR"):
        return "EPSG:3857"
    raise ValueError(f"Unsupported CRS {code!r} (have EPSG:4326, EPSG:3857)")


def transformer(src, dst):
    """(x, y) -> (x', y') vectorized transform between supported CRSs."""
    s, d = _norm(src), _norm(dst)
    if s == d:
        return lambda x, y: (x, y)
    if s == "EPSG:4326" and d == "EPSG:3857":
        def fwd(x, y):
            lat = np.clip(y, -_MAX_LAT, _MAX_LAT)
            return (_R * np.radians(x),
                    _R * np.log(np.tan(np.pi / 4 + np.radians(lat) / 2)))
        return fwd
    if s == "EPSG:3857" and d == "EPSG:4326":
        def inv(x, y):
            return (np.degrees(x / _R),
                    np.degrees(2 * np.arctan(np.exp(y / _R)) - np.pi / 2))
        return inv
    raise ValueError(f"No transform {s} -> {d}")


def reproject_geometry(garr, src, dst):
    """GeometryArray with coordinates mapped through the CRS transform."""
    from geomesa_tpu_torch.features.geometry import GeometryArray

    f = transformer(src, dst)
    x, y = f(garr.coords[:, 0], garr.coords[:, 1])
    return GeometryArray(garr.type_codes, garr.geom_offsets,
                         garr.part_offsets, garr.ring_offsets,
                         np.stack([np.asarray(x, dtype=np.float64),
                                   np.asarray(y, dtype=np.float64)], axis=1))
