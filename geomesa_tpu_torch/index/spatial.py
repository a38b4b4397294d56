"""The Z3 point index (≙ ``geomesa_tpu.index.spatial.Z3Index``).

Rows live on the device in epoch-major (bin, z3) order — the reference's
``[epoch:2][z:8]`` row layout. The keys are encoded on the host (numpy, the
reference's ``_sort_keys``), the stable sort runs on the device, and every
query column gathers through the permutation once. ``plan`` turns a filter
into padded fp62 boxes, exact binned-time windows and a residual split
between the device and the host; ``candidate_blocks`` covers a plan with the
gather blocks of its z-ranges (the staged path's range pruning), from host
copies of the sorted keys.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from geomesa_tpu_torch.curves.binnedtime import (TimePeriod, max_offset,
                                                 time_to_binned_time)
from geomesa_tpu_torch.curves.sfc import Z3SFC
from geomesa_tpu_torch.features.table import FeatureTable, StringColumn
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.filter.extract import extract_bboxes, extract_intervals
from geomesa_tpu_torch.index import prune as _p
from geomesa_tpu_torch.index.api import IndexScanPlan, not_ported
from geomesa_tpu_torch.index.device import (DeviceTable, fp62_lat, fp62_lon,
                                            host_planes, resolve)
from geomesa_tpu_torch.index.scan import (ScanKernels, compile_residual,
                                          pad_boxes, pad_windows,
                                          split_residual)


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
        self._sfc = Z3SFC.apply(self.period)
        self._bins, self._z = self._sort_keys()
        self.perm = device_sort_perm(torch.from_numpy(self._bins).to(dev),
                                     torch.from_numpy(self._z).to(dev))
        self.device = DeviceTable.build_sorted(
            host_planes(table, self.period), self.perm)
        self.kernels = ScanKernels(self.device.columns)
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
        sfc = self._sfc
        z = sfc.index(x, y, np.minimum(offs, int(sfc.time.max)), lenient=True)
        return np.asarray(bins, dtype=np.int32), np.asarray(z, dtype=np.int64)

    # host sorted keys (range pruning) -------------------------------------

    def _sorted_plane(self, attr: str, src: np.ndarray) -> np.ndarray:
        """A host key plane in index order, gathered through the device
        permutation on first use and kept."""
        cached = getattr(self, attr, None)
        if cached is None:
            cached = torch.from_numpy(src).to(self.perm.device).index_select(
                0, self.perm).cpu().numpy()
            setattr(self, attr, cached)
        return cached

    @property
    def sorted_z(self) -> np.ndarray:
        return self._sorted_plane("_sorted_z", self._z)

    @property
    def sorted_bins(self) -> np.ndarray:
        return self._sorted_plane("_sorted_bins", self._bins)

    def _bin_segments(self) -> _p.BinSegments:
        if getattr(self, "_bin_segs", None) is None:
            self._bin_segs = _p.BinSegments(self.sorted_bins)
        return self._bin_segs

    def candidate_blocks(self, plan: IndexScanPlan) -> Optional[np.ndarray]:
        """Sorted unique gather-block ids covering every possibly-matching
        row; None when pruning does not apply or would not pay (no spatial
        box, over 16 boxes, a table under 4 blocks, a cover over
        ``PRUNE_MAX_FRACTION`` of the rows or blocks); an empty array when
        the cover is provably empty. The device re-applies the full exact
        mask to gathered blocks, so this only needs to be a superset (≙ the
        reference's ≤2000-range scan plans, Z3IndexKeySpace.getRanges)."""
        if plan.empty or plan.boxes_loose is None:
            return None
        boxes = plan.explain.get("boxes")
        if not boxes or len(boxes) > 16:
            return None
        n = len(self.table)
        if n < 4 * _p.BLOCK_SIZE:
            return None
        # plan.windows is None iff the temporal extraction was unconstrained:
        # the explain intervals then hold the open-ended sentinel, which must
        # read as "no temporal constraint"
        intervals = plan.explain.get("intervals") \
            if plan.windows is not None else None
        slices = self._row_slices(list(boxes), intervals)
        if slices is None:
            return None
        total = int((slices[:, 1] - slices[:, 0]).sum()) if len(slices) else 0
        if total > _p.PRUNE_MAX_FRACTION * n:
            return None
        blocks = _p.slices_to_blocks(slices, n)
        if blocks is not None \
                and len(blocks) * _p.BLOCK_SIZE > _p.PRUNE_MAX_FRACTION * n:
            return None
        plan.explain.update(_p.candidate_stats(slices, blocks, n))
        if blocks is None:
            # provably empty candidate set — still exact (superset of nothing)
            blocks = np.empty(0, dtype=np.int32)
        return blocks

    def _binned_row_slices(self, boxes, intervals, sorted_keys,
                           cover_fn) -> Optional[np.ndarray]:
        """Epoch-major pruning: per-bin segments × per-window covers (covers
        dedup by in-bin window, so a multi-bin interval costs at most three
        distinct covers: head, whole period, tail)."""
        segs = self._bin_segments()
        mo = max_offset(self.period) - 1
        if intervals:
            bw = _p.bin_windows(intervals, self.period)
            if bw is None:
                return None
        else:
            bins = segs.all_bins()
            if len(bins) > _p.MAX_BINS:
                return None
            bw = [(int(b), (0, mo)) for b in bins]
        covers = {}
        out = []
        for b, w in bw:
            lo, hi = segs.segment(b)
            if lo >= hi:
                continue
            if w not in covers:
                covers[w] = cover_fn(boxes, w)
            out.append(_p.ranges_to_slices(sorted_keys, covers[w], lo=lo, hi=hi))
        return np.concatenate(out) if out else np.empty((0, 2), dtype=np.int64)

    def _row_slices(self, boxes, intervals) -> Optional[np.ndarray]:
        """Candidate [lo, hi) row slices in index order (a superset of the
        matches), or None when the decomposition explodes."""
        return self._binned_row_slices(
            boxes, intervals, self.sorted_z,
            lambda bx, w: self._sfc.ranges_arrays(
                bx, [w], max_ranges=_p.MAX_RANGES))

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
