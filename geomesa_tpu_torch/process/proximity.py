"""Proximity + route search.

Copied from ``geomesa_tpu.process.proximity``
(host-only) with its imports pointed at this package.

≙ reference `ProximitySearchProcess` (features within a distance of a set of
input geometries) and `RouteSearchProcess` (features along a route — the
same computation against a LineString). Bbox prefilter through the index,
exact metric distance refine vectorized over (feature × segment) pairs."""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np

from geomesa_tpu_torch.features import geometry as geo
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.filter.parser import parse_ecql
from geomesa_tpu_torch.process.geo import (buffered_envelope, haversine_m,
                                     point_segment_distance_m)


def _segments(garr: geo.GeometryArray) -> Tuple[np.ndarray, ...]:
    """All line segments (ax, ay, bx, by) of every ring/line in the input."""
    segs = []
    for r in range(len(garr.ring_offsets) - 1):
        s, e = garr.ring_offsets[r], garr.ring_offsets[r + 1]
        if e - s >= 2:
            c = garr.coords[s:e]
            segs.append(np.concatenate([c[:-1], c[1:]], axis=1))
    if not segs:
        return (np.empty(0),) * 4
    allsegs = np.concatenate(segs, axis=0)
    return allsegs[:, 0], allsegs[:, 1], allsegs[:, 2], allsegs[:, 3]


def proximity_search(planner, inputs: Union[geo.GeometryArray, Sequence[str]],
                     distance_m: float,
                     f: Union[str, ir.Filter, None] = None) -> np.ndarray:
    """Row indices of features within ``distance_m`` of ANY input geometry."""
    if not isinstance(inputs, geo.GeometryArray):
        inputs = geo.GeometryArray.from_wkt(list(inputs))
    if isinstance(f, str):
        f = parse_ecql(f)
    geom = planner.sft.geometry_attribute
    if geom is None:
        raise ValueError("proximity requires a geometry attribute")

    # bbox prefilter: union of per-input buffered boxes (through the index)
    bbs = inputs.bboxes()
    boxes = [ir.BBox(geom.name, *buffered_envelope(*bb, distance_m))
             for bb in bbs]
    pre: ir.Filter = ir.or_filters(boxes) if len(boxes) > 1 else boxes[0]
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

    keep = np.zeros(len(rows), dtype=bool)
    # point inputs: plain haversine; line/polygon inputs: segment distance
    pts_mask = inputs.type_codes == geo.POINT
    if pts_mask.any():
        starts = inputs.ring_offsets[inputs.part_offsets[inputs.geom_offsets[:-1]]]
        ppts = inputs.coords[starts[pts_mask]]
        d = haversine_m(px[:, None], py[:, None], ppts[None, :, 0], ppts[None, :, 1])
        keep |= (d <= distance_m).any(axis=1)
    if (~pts_mask).any():
        extent_inputs = inputs.take(np.nonzero(~pts_mask)[0])
        ax, ay, bx, by = _segments(extent_inputs)
        if len(ax):
            d = point_segment_distance_m(
                px[:, None], py[:, None],
                ax[None, :], ay[None, :], bx[None, :], by[None, :])
            keep |= (d <= distance_m).any(axis=1)
        # distance-to-boundary misses interior points: polygon containment
        # is distance 0 (≙ the reference's isWithinDistance semantics)
        from geomesa_tpu_torch.filter.geom_numpy import points_in_polygon
        for i in range(len(extent_inputs)):
            code = int(extent_inputs.type_codes[i])
            if code in (geo.POLYGON, geo.MULTIPOLYGON):
                keep |= points_in_polygon(px, py, extent_inputs.shape(i))
    return rows[keep]


def route_search(planner, route_wkt: str, distance_m: float,
                 f: Union[str, ir.Filter, None] = None) -> np.ndarray:
    """Features within ``distance_m`` of the route LineString (≙
    RouteSearchProcess)."""
    return proximity_search(planner, [route_wkt], distance_m, f)
