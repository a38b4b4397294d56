"""Tube select: space-time corridor search.

Copied from ``geomesa_tpu.process.tube``
(host-only) with its imports pointed at this package.

≙ reference `TubeSelectProcess` + `TubeBuilder` (geomesa-process/.../tube/):
given an ordered track of (x, y, t) tube points, select features that fall
within ``buffer_m`` of the track's interpolated position at their own
timestamp (± ``time_buffer_ms``). Vectorized: per feature, ``searchsorted``
finds the bracketing tube points, position interpolates linearly, one
haversine pass scores every candidate."""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.filter.parser import parse_ecql
from geomesa_tpu_torch.process.geo import buffered_envelope, haversine_m


def tube_select(planner, track: Sequence[Tuple[float, float, object]],
                buffer_m: float, time_buffer_ms: int = 0,
                f: Union[str, ir.Filter, None] = None) -> np.ndarray:
    """Row indices inside the tube. ``track``: ordered (x, y, t) where t is
    epoch ms or datetime64/ISO string."""
    if isinstance(f, str):
        f = parse_ecql(f)
    dtg = planner.sft.dtg_attribute
    geom = planner.sft.geometry_attribute
    if dtg is None or geom is None:
        raise ValueError("tube select requires geometry + date attributes")

    tx = np.asarray([p[0] for p in track], dtype=np.float64)
    ty = np.asarray([p[1] for p in track], dtype=np.float64)
    tt = np.asarray([_ms(p[2]) for p in track], dtype=np.int64)
    order = np.argsort(tt, kind="stable")
    tx, ty, tt = tx[order], ty[order], tt[order]

    # index prefilter: track envelope buffered in space and time
    env = buffered_envelope(float(tx.min()), float(ty.min()),
                            float(tx.max()), float(ty.max()), buffer_m)
    pre: ir.Filter = ir.And((
        ir.BBox(geom.name, *env),
        ir.During(dtg.name, int(tt[0] - time_buffer_ms) - 1,
                  int(tt[-1] + time_buffer_ms) + 1),
    ))
    if f is not None and not isinstance(f, ir.Include):
        pre = ir.and_filters([f, pre])
    rows = planner.select_indices(pre)
    if len(rows) == 0:
        return rows

    sub = planner.table.take(rows)
    garr = sub.geometry()
    if garr.is_points:
        px, py = garr.point_xy()
    else:
        bb = garr.bboxes()
        px, py = (bb[:, 0] + bb[:, 2]) / 2, (bb[:, 1] + bb[:, 3]) / 2
    pt = np.asarray(sub.columns[dtg.name], dtype=np.int64)

    # clamp each feature time into the track span (time_buffer permitting),
    # interpolate the track position at that instant
    t_lo, t_hi = tt[0], tt[-1]
    in_time = (pt >= t_lo - time_buffer_ms) & (pt <= t_hi + time_buffer_ms)
    tc = np.clip(pt, t_lo, t_hi)
    hi = np.clip(np.searchsorted(tt, tc, side="left"), 1, len(tt) - 1)
    lo = hi - 1
    span = (tt[hi] - tt[lo]).astype(np.float64)
    w = np.where(span > 0, (tc - tt[lo]) / np.where(span > 0, span, 1.0), 0.0)
    ix = tx[lo] + w * (tx[hi] - tx[lo])
    iy = ty[lo] + w * (ty[hi] - ty[lo])

    d = haversine_m(px, py, ix, iy)
    return rows[in_time & (d <= buffer_m)]


def _ms(t) -> int:
    if isinstance(t, (int, np.integer)):
        return int(t)
    return int(np.datetime64(t, "ms").astype(np.int64))
