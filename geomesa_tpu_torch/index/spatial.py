"""The Z3 point index (≙ ``geomesa_tpu.index.spatial.Z3Index``).

Rows live on the device in epoch-major (bin, z3) order — the reference's
``[epoch:2][z:8]`` row layout. The keys are encoded on the host (numpy, the
reference's ``_sort_keys``), the stable sort runs on the device, and every
query column gathers through the permutation once. ``plan`` turns a filter
into padded fp62 boxes, exact binned-time windows and a residual split
between the device and the host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from geomesa_tpu_torch.curves.binnedtime import TimePeriod, time_to_binned_time
from geomesa_tpu_torch.curves.sfc import Z3SFC
from geomesa_tpu_torch.features.table import FeatureTable, StringColumn
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.filter.extract import extract_bboxes, extract_intervals
from geomesa_tpu_torch.index.api import IndexScanPlan, not_ported
from geomesa_tpu_torch.index.device import (DeviceTable, fp62_lat, fp62_lon,
                                            host_planes, resolve)
from geomesa_tpu_torch.index.scan import (compile_residual, pad_boxes,
                                          pad_windows, split_residual)


def device_sort_perm(bins: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic (bin, z) sort permutation, on the keys' device.

    Two stable passes — by z, then by bin through the first permutation —
    give exactly the reference's ``lax.sort`` over (bin, z planes, row iota),
    ties broken by row id, i.e. ``np.lexsort((z, bin))``."""
    p1 = torch.sort(z, stable=True).indices
    p2 = torch.sort(bins.index_select(0, p1), stable=True).indices
    return p1.index_select(0, p2)


def _strip_handled(f: ir.Filter, geom: Optional[str], dtg: Optional[str],
                   points: bool) -> Optional[ir.Filter]:
    """Residual after removing predicates the primary boxes/windows enforce
    exactly (the reference's rule): BBox always, point/rectangle Intersects
    on point layers, and temporal predicates on the dtg. OR-rooted filters
    keep the whole filter as residual."""
    if isinstance(f, ir.Or):
        return f
    children = f.children if isinstance(f, ir.And) else (f,)
    rest: List[ir.Filter] = []
    for c in children:
        if isinstance(c, (ir.BBox, ir.Intersects, ir.Contains, ir.Within, ir.Dwithin)) \
                and (geom is None or c.attr == geom):
            if isinstance(c, ir.BBox):
                continue  # envelope semantics: primary boxes are exact
            if points and extract_bboxes(c, geom).exact:
                continue  # point-in-rectangle: primary boxes are exact
            rest.append(c)
        elif isinstance(c, ir.During) and c.attr == dtg:
            continue  # exact via windows
        elif isinstance(c, ir.Cmp) and c.attr == dtg and isinstance(c.value, (int, np.integer)):
            continue  # exact via windows
        else:
            rest.append(c)
    return ir.and_filters(rest) if rest else None


def _boxes_fp62(boxes) -> np.ndarray:
    """User-space boxes → (B, 8) int32 fp62 query planes:
    [qxlo_hi, qxlo_lo, qxhi_hi, qxhi_lo, qylo_hi, qylo_lo, qyhi_hi, qyhi_lo]."""
    out = np.empty((len(boxes), 8), dtype=np.int32)
    for i, (xmin, ymin, xmax, ymax) in enumerate(boxes):
        xlo = fp62_lon(xmin)
        xhi = fp62_lon(xmax)
        ylo = fp62_lat(ymin)
        yhi = fp62_lat(ymax)
        out[i] = (xlo[0], xlo[1], xhi[0], xhi[1], ylo[0], ylo[1], yhi[0], yhi[1])
    return out


class Z3Index:
    """Point + time: epoch-major (bin, z3) order (≙ Z3IndexKeySpace.scala:34)."""

    name = "z3"
    points = True

    def __init__(self, sft, table: FeatureTable,
                 device: Union[str, torch.device, None] = None):
        if not self.supports(sft):
            raise not_ported("indexes other than Z3 over Point + Date "
                             "(Z2 and the extent indexes)", 9)
        dev = resolve(device)
        self.sft = sft
        self.table = table
        self.geom = sft.geometry_attribute.name
        self.dtg = sft.dtg_attribute.name
        self.period = TimePeriod.parse(sft.z3_interval)
        bins, z = self._sort_keys()
        self.perm = device_sort_perm(torch.from_numpy(bins).to(dev),
                                     torch.from_numpy(z).to(dev))
        self.device = DeviceTable.build_sorted(
            host_planes(table, self.period), self.perm)
        self.vocabs = {
            name: col.vocab for name, col in table.columns.items()
            if isinstance(col, StringColumn)
        }

    @classmethod
    def supports(cls, sft) -> bool:
        g = sft.geometry_attribute
        return g is not None and g.type_name == "Point" and sft.dtg_attribute is not None

    def _sort_keys(self) -> Tuple[np.ndarray, np.ndarray]:
        """(bin int32, z3 int64) per table row, as the reference encodes them."""
        x, y = self.table.geometry().point_xy()
        ms = np.asarray(self.table.columns[self.dtg], dtype=np.int64)
        bins, offs = time_to_binned_time(ms, self.period)
        sfc = Z3SFC.apply(self.period)
        z = sfc.index(x, y, np.minimum(offs, int(sfc.time.max)), lenient=True)
        return np.asarray(bins, dtype=np.int32), np.asarray(z, dtype=np.int64)

    def map_rows(self, idx: np.ndarray) -> np.ndarray:
        """Sorted positions → table rows (gathered on the device)."""
        idx = torch.as_tensor(np.asarray(idx, dtype=np.int64),
                              device=self.perm.device)
        return self.perm.index_select(0, idx).cpu().numpy()

    def plan(self, f: ir.Filter) -> IndexScanPlan:
        ext = extract_bboxes(f, self.geom)
        iv = extract_intervals(f, self.dtg)
        if len(ext.boxes) == 0 or len(iv.intervals) == 0:
            return IndexScanPlan(self, "none", empty=True)

        residual = _strip_handled(f, self.geom, self.dtg, self.points)

        boxes_loose = None
        kind = "none"
        if not ext.unconstrained:
            kind = "point_boxes"
            boxes_loose = pad_boxes(_boxes_fp62(ext.boxes))

        windows = None
        if not iv.unconstrained:
            w = np.empty((len(iv.intervals), 4), dtype=np.int32)
            i32 = (1 << 31) - 1  # open-ended intervals overflow the bin i32
            for i, (lo, hi) in enumerate(iv.intervals):
                blo, olo = time_to_binned_time(lo, self.period)
                bhi, ohi = time_to_binned_time(hi, self.period)
                w[i] = (max(-i32, int(blo)), int(olo),
                        min(i32, int(bhi)), int(ohi))
            windows = pad_windows(w)

        avail = set(self.device.columns)
        dev_res, host_res = split_residual(residual, self.sft, self.vocabs,
                                           avail)
        compiled = compile_residual(dev_res, self.sft, self.vocabs, avail) \
            if dev_res else None
        return IndexScanPlan(
            index=self,
            primary_kind=kind,
            boxes_loose=boxes_loose,
            windows=windows,
            residual_device=compiled,
            residual_host=host_res,
            explain={"index": self.name, "boxes": ext.boxes,
                     "intervals": iv.intervals,
                     "residual_device": dev_res, "residual_host": host_res},
        )
