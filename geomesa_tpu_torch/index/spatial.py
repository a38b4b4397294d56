"""The Z3 point index (≙ ``geomesa_tpu.index.spatial.Z3Index``).

Rows live on the device in epoch-major (bin, z3) order — the reference's
``[epoch:2][z:8]`` row layout. The keys are encoded on the host (numpy, the
reference's ``_sort_keys``), the stable sort runs on the device, and every
query column gathers through the permutation once. ``plan`` turns a filter
into padded fp62 boxes, exact binned-time windows and a residual split
between the device and the host; ``candidate_blocks`` covers a plan with the
gather blocks of its z-ranges (the staged path's range pruning), from host
copies of the sorted keys. ``merge_from`` builds the index of a table that
grew by a delta run incrementally: only the delta sorts, and the device
columns merge through the ``merge_scatter`` kernel (``build_stages`` holds
each build's synchronised stage seconds).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple, Union

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
                                            host_planes, resolve, sync)
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


class _DeltaKeyShim:
    """Minimal stand-in passed to ``Z3Index._sort_keys`` to encode a delta
    run's keys without building an index over it (≙
    ``geomesa_tpu/index/spatial.py:349``)."""

    def __init__(self, table, dtg, period, sfc):
        self.table = table
        self.dtg = dtg
        self.period = period
        self._sfc = sfc


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
        # the build by stage, each timer stopped on a device sync: host
        # keys, key upload + plane uploads, the device sort, host planes,
        # the sorted gathers
        st: Dict[str, float] = {}
        t0 = time.perf_counter()
        self._bins, self._z = self._sort_keys()
        t1 = time.perf_counter()
        bins = torch.from_numpy(self._bins).to(dev)
        z = torch.from_numpy(self._z).to(dev)
        sync(dev)
        t2 = time.perf_counter()
        self.perm = device_sort_perm(bins, z)
        del bins, z
        sync(dev)
        t3 = time.perf_counter()
        planes = host_planes(table, self.period)
        st.update(keys_s=t1 - t0, upload_s=t2 - t1, sort_s=t3 - t2,
                  planes_s=time.perf_counter() - t3)
        self.device = DeviceTable.build_sorted(planes, self.perm, st)
        self.build_stages = st
        self.kernels = ScanKernels(self.device.columns)
        self.vocabs = {
            name: col.vocab for name, col in table.columns.items()
            if isinstance(col, StringColumn)
        }

    @classmethod
    def merge_from(cls, old: "Z3Index", merged_table: FeatureTable,
                   n_old: int) -> "Z3Index":
        """Incremental (LSM-merge) build (≙
        ``geomesa_tpu/index/spatial.py:663-823``): ``merged_table`` is
        ``old.table`` followed by ``n_delta`` appended rows. Only the delta
        run's keys are encoded and sorted (``np.lexsort``); each delta row's
        rank ``r`` among the resident sorted keys comes from a per-bin
        ``searchsorted`` with ties to the residents (``side="right"``); the
        host key planes merge by direct placement; the device columns and
        the permutation merge in one ``merge_scatter`` launch, moving only
        delta-sized data over the host link. The result is bitwise the full
        rebuild's: the merged order is the stable lexsort of the
        concatenated keys (residents keep their order, delta rows keep
        theirs, ties go to the smaller table row — a resident)."""
        n_new = len(merged_table)
        n_delta = n_new - n_old
        self = cls.__new__(cls)
        self.sft = old.sft
        self.table = merged_table
        self.geom, self.dtg = old.geom, old.dtg
        self.period, self._sfc = old.period, old._sfc
        st: Dict[str, float] = {}
        t0 = time.perf_counter()

        # 1-2. the delta run's keys and its own stable sort
        delta_table = merged_table.take(np.arange(n_old, n_new,
                                                  dtype=np.int64))
        bins_d, z_d = cls._sort_keys(_DeltaKeyShim(
            delta_table, old.dtg, old.period, old._sfc))
        p_d = np.lexsort((z_d, bins_d)).astype(np.int64)
        z_sd, b_sd = z_d[p_d], bins_d[p_d]
        t1 = time.perf_counter()

        # 3. ranks among the residents, bin segment by bin segment
        old_z, old_b = old.sorted_z, old.sorted_bins
        r = np.empty(n_delta, dtype=np.int64)
        touched = np.unique(b_sd)
        for b in touched:
            ds = np.searchsorted(b_sd, b, side="left")
            de = np.searchsorted(b_sd, b, side="right")
            rs = np.searchsorted(old_b, b, side="left")
            re_ = np.searchsorted(old_b, b, side="right")
            r[ds:de] = rs + np.searchsorted(old_z[rs:re_], z_sd[ds:de],
                                            side="right")
        t2 = time.perf_counter()

        # 4. host key planes: delta row j lands at r[j] + j, the residents
        # fill the rest in order
        is_delta = np.zeros(n_new, dtype=bool)
        is_delta[r + np.arange(n_delta, dtype=np.int64)] = True
        self._z = np.concatenate([old._z, z_d])
        self._bins = np.concatenate([old._bins, bins_d])
        for attr, res, dl in (("_sorted_z", old_z, z_sd),
                              ("_sorted_bins", old_b, b_sd)):
            merged = np.empty(n_new, dtype=res.dtype)
            merged[~is_delta] = res
            merged[is_delta] = dl
            setattr(self, attr, merged)
        del is_delta
        t3 = time.perf_counter()

        # 5. dictionary columns whose vocab grew under the union-vocab
        # concat: the resident device codes are stale, so those columns
        # rebuild from the merged codes
        self.vocabs = {name: col.vocab
                       for name, col in merged_table.columns.items()
                       if isinstance(col, StringColumn)}
        stale = [name for name in old.device.columns
                 if name in self.vocabs
                 and old.vocabs.get(name) != self.vocabs[name]]
        full_codes = {name: merged_table.columns[name].codes
                      for name in stale}
        t4 = time.perf_counter()

        # 6. the delta's device planes, in delta-sorted order
        delta_planes = {k: v[p_d] for k, v in
                        host_planes(delta_table, old.period).items()}
        t5 = time.perf_counter()

        # 7. one merge_scatter launch: every column and the permutation
        self.device, self.perm = DeviceTable.merge_scatter(
            old.device, delta_planes, r, stale=stale, full_codes=full_codes,
            perm_pair=(old.perm, n_old + p_d), stages=st)

        # 8. the staged scan modes over the merged columns
        self.kernels = ScanKernels(self.device.columns)
        st.update(keys_s=t1 - t0, rank_s=t2 - t1, host_runs_s=t3 - t2,
                  vocab_s=t4 - t3, planes_s=t5 - t4,
                  merge_s=time.perf_counter() - t0, merge_rows=n_delta,
                  merge_fraction=n_delta / max(1, n_old),
                  merge_touched_bins=len(touched),
                  merge_stale_cols=sorted(stale))
        self.build_stages = st
        return self

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
