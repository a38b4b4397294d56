"""Geodesic helpers for the process layer (vectorized).

Copied from ``geomesa_tpu.process.geo`` (host-only)."""

from __future__ import annotations

import numpy as np

EARTH_R_M = 6371008.8


def haversine_m(x1, y1, x2, y2) -> np.ndarray:
    """Great-circle distance in meters between lon/lat degree points."""
    lon1, lat1, lon2, lat2 = (np.radians(np.asarray(a, dtype=np.float64))
                              for a in (x1, y1, x2, y2))
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    a = np.sin(dlat / 2) ** 2 + np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2) ** 2
    return 2 * EARTH_R_M * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))


def meters_to_degrees(m: float, lat: float) -> tuple:
    """(dlon, dlat) spans covering a radius of ``m`` meters at ``lat``."""
    dlat = m / 111_320.0
    dlon = m / (111_320.0 * max(0.01, np.cos(np.radians(lat))))
    return dlon, dlat


def expand_bbox(x: float, y: float, radius_m: float) -> tuple:
    dlat = radius_m / 111_320.0
    # longitude degrees shrink toward the poles: buffer at the WIDEST
    # latitude the box reaches, or the prefilter under-covers high latitudes
    lat_w = min(89.0, abs(y) + dlat)
    dlon, _ = meters_to_degrees(radius_m, lat_w)
    return (max(-180.0, x - dlon), max(-90.0, y - dlat),
            min(180.0, x + dlon), min(90.0, y + dlat))


def buffered_envelope(xmin: float, ymin: float, xmax: float, ymax: float,
                      radius_m: float) -> tuple:
    """Envelope grown by ``radius_m`` on every side, with the longitude
    buffer computed at the envelope's widest latitude."""
    dlat = radius_m / 111_320.0
    lat_w = min(89.0, max(abs(ymin - dlat), abs(ymax + dlat)))
    dlon, _ = meters_to_degrees(radius_m, lat_w)
    return (max(-180.0, xmin - dlon), max(-90.0, ymin - dlat),
            min(180.0, xmax + dlon), min(90.0, ymax + dlat))


def point_segment_distance_m(px, py, ax, ay, bx, by) -> np.ndarray:
    """Distance from points (px, py) to segments (a→b), all lon/lat degrees.
    Uses a local equirectangular projection around each segment — accurate to
    well under 1% for segments below a few hundred km, which is the tube/
    route regime (≙ the reference evaluating JTS distance in degrees, but
    metric)."""
    px, py, ax, ay, bx, by = (np.asarray(v, dtype=np.float64)
                              for v in (px, py, ax, ay, bx, by))
    lat0 = np.radians((ay + by) / 2)
    kx = 111_320.0 * np.cos(lat0)
    ky = 111_320.0
    pxm, pym = (px - ax) * kx, (py - ay) * ky
    bxm, bym = (bx - ax) * kx, (by - ay) * ky
    seg2 = bxm ** 2 + bym ** 2
    t = np.where(seg2 > 0, (pxm * bxm + pym * bym) / np.where(seg2 > 0, seg2, 1.0), 0.0)
    t = np.clip(t, 0.0, 1.0)
    dx, dy = pxm - t * bxm, pym - t * bym
    return np.sqrt(dx ** 2 + dy ** 2)
