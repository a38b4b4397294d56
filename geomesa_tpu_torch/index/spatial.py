"""The spatial indexes: S3, S2, Z3, XZ3, Z2, XZ2 and the full-scan index
(≙ ``geomesa_tpu.index.spatial``).

Each index owns a device-resident projection of the table sorted in its key
order — epoch-major for the temporal variants, the reference's
``[epoch:2][z:8]`` row layout — plus host copies of the sorted keys for
range pruning:

  - ``Z3Index``  point + time, (bin, z3) order (Z3IndexKeySpace.scala:34);
  - ``XZ3Index`` extent + time, (bin, xz3) order (XZ3IndexKeySpace.scala:33);
  - ``Z2Index``  point, z2 order (Z2IndexKeySpace.scala:29);
  - ``XZ2Index`` extent, xz2 order (XZ2IndexKeySpace.scala:28);
  - ``S3Index``/``S2Index`` point (+ time), (bin, s2) / s2 order, opt-in
    through ``geomesa.indices`` (S3IndexKeySpace.scala:36,
    S2IndexKeySpace.scala:34);
  - ``FullScanIndex`` the table's natural order.

A point layer builds as the reference's ``_build_native`` does: the
native C++ encoder (``geomesa_tpu_torch.native``) makes every plane and
key in one host pass; above ``GEOMESA_TPU_BUILD_STREAM_CHUNK`` rows it
encodes chunk i+1 while chunk i goes up to the card from pinned memory on
a side stream (``_stream_encode_upload``). Other layers, and calendar
periods, encode their keys in numpy (``_sort_keys``) and their planes with
``host_planes``. Every build sorts on the device (``device_sort_perm``,
stable, the order of ``np.lexsort``) and gathers every query column
through the permutation once (``build_stages`` holds each build's
synchronised stage seconds). ``plan`` turns a filter into padded
fp62 boxes — a point-in-box primary on point layers, an envelope-overlap
primary (``bbox_overlap``) on extent layers — exact binned-time windows and
a residual split between the device and the host; ``candidate_blocks``
covers a plan with the gather blocks of its key ranges (the staged path's
range pruning). ``ensure_segment_columns`` uploads a single-segment line
layer's endpoints for the certainty-band intersects count. Every index
also builds incrementally from a grown table (``merge_from``, the
``merge_scatter`` kernel).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from geomesa_tpu_torch import config
from geomesa_tpu_torch.curves.binnedtime import (TimePeriod, max_offset,
                                                 time_to_binned_time)
from geomesa_tpu_torch.curves.s2 import S2SFC
from geomesa_tpu_torch.curves.sfc import Z2SFC, Z3SFC
from geomesa_tpu_torch.curves.xz import XZ2SFC, XZ3SFC
from geomesa_tpu_torch.features import geometry as geo
from geomesa_tpu_torch.features.table import FeatureTable, StringColumn
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.filter.extract import (WHOLE_WORLD, Extraction,
                                              extract_bboxes,
                                              extract_intervals)
from geomesa_tpu_torch.index import prune as _p
from geomesa_tpu_torch.index.api import IndexScanPlan
from geomesa_tpu_torch.index.device import (DeviceTable, fp62_lat, fp62_lon,
                                            host_planes, resolve, sync)
from geomesa_tpu_torch.index.scan import (Readback, ScanKernels, _dev,
                                          compile_residual, pad_boxes,
                                          pad_windows, split_residual)

_MASK21 = (1 << 21) - 1


def _split63(v: np.ndarray) -> List[np.ndarray]:
    """Split non-negative int64 keys (< 2^63) into three 21-bit int32 planes
    (major → minor), the reference's device sort keys."""
    v = np.asarray(v, dtype=np.int64)
    return [((v >> 42) & _MASK21).astype(np.int32),
            ((v >> 21) & _MASK21).astype(np.int32),
            (v & _MASK21).astype(np.int32)]


def device_sort_perm(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic sort permutation of integer key planes (major →
    minor), on the keys' device.

    One stable pass a plane, minor first, each through the permutation so
    far: exactly the reference's ``lax.sort`` over (key planes, row iota),
    ties broken by row id, i.e. ``np.lexsort(tuple(reversed(keys)))``."""
    perm = None
    for k in reversed(list(keys)):
        kk = k if perm is None else k.index_select(0, perm)
        p = torch.sort(kk, stable=True).indices
        perm = p if perm is None else perm.index_select(0, p)
    return perm


class _ChunkUploader:
    """The device planes of a streamed build, filled chunk by chunk: each
    plane is one ``n``-row device tensor, and chunk i copies into its rows.
    On the card a chunk goes through one of two pinned staging sets, used
    in turns (set i % 2 waits for the copies of chunk i - 2), with
    ``non_blocking`` copies on a side stream; ``finish`` makes the current
    stream wait for them (an event) before anything reads the planes."""

    def __init__(self, n: int, chunk_rows: int, dev: torch.device):
        self.n = n
        self.chunk_rows = chunk_rows
        self.dev = dev
        self.planes: Optional[Dict[str, torch.Tensor]] = None
        self.cuda = dev.type == "cuda"
        self.side = torch.cuda.Stream(dev) if self.cuda else None
        self.staging: List[Optional[Dict[str, torch.Tensor]]] = [None, None]
        self.done: List[Optional[torch.cuda.Event]] = [None, None]

    def put(self, i: int, a: int, enc: Dict[str, np.ndarray]) -> None:
        """Copy chunk ``i`` (host planes ``enc``, starting at row ``a``)."""
        src = {k: torch.from_numpy(v) for k, v in enc.items()}
        if self.planes is None:
            self.planes = {k: torch.empty(self.n, dtype=v.dtype,
                                          device=self.dev)
                           for k, v in src.items()}
        m = len(next(iter(enc.values())))
        if not self.cuda:
            for k, v in src.items():
                self.planes[k][a: a + m].copy_(v)
            return
        j = i % 2
        if self.done[j] is not None:
            self.done[j].synchronize()
        if self.staging[j] is None:
            self.staging[j] = {k: torch.empty(self.chunk_rows, dtype=v.dtype,
                                              pin_memory=True)
                               for k, v in src.items()}
        with torch.cuda.device(self.dev), torch.cuda.stream(self.side):
            for k, v in src.items():
                buf = self.staging[j][k][:m]
                buf.copy_(v)
                self.planes[k][a: a + m].copy_(buf, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.side)
            self.done[j] = ev

    def finish(self) -> Dict[str, torch.Tensor]:
        """The filled planes, ordered before the current stream's next
        work."""
        if self.cuda:
            for ev in self.done:
                if ev is not None:
                    torch.cuda.current_stream(self.dev).wait_event(ev)
        return self.planes


def _stream_encode_upload(encode_chunk: Callable, n: int, chunk_rows: int,
                          dev: torch.device):
    """Chunked native encode overlapped with the upload (≙ the reference's
    ``_stream_encode_upload``, ``geomesa_tpu/index/spatial.py:57``, without
    its mesh-sharded variant): this thread encodes chunk i+1 (the C++
    encoder releases the GIL) while an uploader thread copies chunk i into
    the device planes (``_ChunkUploader``), through a queue of two chunks.

    ``encode_chunk(lo, hi)`` → plane dict, or None when the native path
    declines that input. Returns ({plane: device tensor}, [host chunks of
    ``z`` and ``bin16``]), or None when a chunk declines. An upload error
    is kept while the uploader goes on draining the queue (so the encoder
    never blocks on a full queue), and re-raised here."""
    q: "queue.Queue" = queue.Queue(maxsize=2)
    up = _ChunkUploader(n, chunk_rows, dev)
    state: dict = {"error": None}

    def uploader():
        while True:
            item = q.get()
            if item is None:
                return
            if state["error"] is not None:
                continue
            try:
                up.put(*item)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                state["error"] = e

    th = threading.Thread(target=uploader, daemon=True)
    th.start()
    host_kept: List[dict] = []
    failed = False
    try:
        for i, a in enumerate(range(0, n, chunk_rows)):
            if state["error"] is not None:
                break
            enc = encode_chunk(a, min(n, a + chunk_rows))
            if enc is None:
                failed = True
                break
            host_kept.append({k: enc[k] for k in ("z", "bin16") if k in enc})
            q.put((i, a, {k: v for k, v in enc.items()
                          if k not in ("zhi", "zlo")}))
    finally:
        q.put(None)
        th.join()
    if state["error"] is not None:
        raise state["error"]
    if failed or up.planes is None:
        return None
    return up.finish(), host_kept


def _row_gather(dev_perm: torch.Tensor, idx: np.ndarray) -> np.ndarray:
    """``dev_perm[idx]`` gathered on the device (≙ the reference's
    ``_row_gather``, ``geomesa_tpu/index/spatial.py:216``): the positions
    padded to a power of two (at least 8) go up from pinned memory, and
    the rows come back into pinned memory behind an event (``scan._dev``,
    ``scan.Readback``), so the host waits for this copy alone and nothing
    crosses through pageable memory."""
    if len(idx) == 0:
        return np.empty(0, dtype=np.int64)
    cap = max(8, 1 << max(0, len(idx) - 1).bit_length())
    pad = np.zeros(cap, dtype=np.int64)
    pad[: len(idx)] = idx
    rows = dev_perm.index_select(0, _dev(pad, dev_perm.device))
    return Readback(rows).wait()[: len(idx)].astype(np.int64)


def _query_column(name: str, t):
    """A build plane's device column (name, values): ``bin16`` lands as the
    int32 ``bin`` column, the sort key ``z`` is not a column (≙ the
    reference's ``_as_query_column``)."""
    if name == "z":
        return None, None
    if name == "bin16":
        return "bin", t.to(torch.int32)
    return name, t


def _strip_handled(f: ir.Filter, geom: Optional[str], dtg: Optional[str],
                   points: bool) -> Optional[ir.Filter]:
    """Residual after removing predicates the primary boxes/windows enforce
    exactly (the reference's rule): BBox always (envelope semantics, exact
    for points and extents alike through the fp62 planes), point/rectangle
    Intersects on point layers only, and temporal predicates on the dtg.
    OR-rooted filters keep the whole filter as residual."""
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
    """Minimal stand-in passed to an index class's ``_sort_keys`` to encode
    a delta run's keys without building an index over it (``_sort_keys``
    reads table/sft/geom/dtg/period and writes its key arrays — ``_z``/
    ``_xz``/``_bins``/``_sfc`` — onto ``self``; ≙
    ``geomesa_tpu/index/spatial.py:349``)."""

    def __init__(self, sft, table, geom, dtg, period):
        self.sft = sft
        self.table = table
        self.geom = geom
        self.dtg = dtg
        self.period = period


def _segment_planes(garr) -> Optional[Dict[str, np.ndarray]]:
    """The f32 endpoint planes ``sx1``/``sy1``/``sx2``/``sy2`` of a column
    of two-point LineStrings, in table order; None when any feature is
    another shape (or the column is empty or of points)."""
    if garr.is_point_column or not len(garr):
        return None
    counts = np.diff(garr.ring_offsets)
    if not (np.all(garr.type_codes == geo.LINESTRING)
            and len(counts) == len(garr) and np.all(counts == 2)):
        return None
    segs = garr.coords.reshape(len(garr), 4)
    return {name: np.ascontiguousarray(segs[:, i].astype(np.float32))
            for i, name in enumerate(("sx1", "sy1", "sx2", "sy2"))}


class BaseSpatialIndex:
    """Shared machinery (≙ the reference's ``BaseSpatialIndex``): the
    build, the device table and its scan modes, planning, the host sorted
    keys and the range cover. Subclasses supply ``supports``,
    ``_sort_keys`` and ``_row_slices``."""

    name: str = "base"
    temporal: bool = False
    points: bool = True

    def __init__(self, sft, table: FeatureTable,
                 device: Union[str, torch.device, None] = None):
        if not self.supports(sft):
            raise ValueError(f"{type(self).__name__} does not support "
                             f"schema {sft.name}")
        dev = resolve(device)
        self.sft = sft
        self.table = table
        g = sft.geometry_attribute
        self.geom = g.name if g is not None else None
        dtg = sft.dtg_attribute
        self.dtg = dtg.name if dtg is not None else None
        self.period = TimePeriod.parse(sft.z3_interval) \
            if self.dtg is not None else None
        # the build by stage, each timer stopped on a device sync
        self.build_stages: Dict[str, float] = {}
        if not self._build_native(dev):
            self._build_numpy(dev)
        self.kernels = ScanKernels(self.device.columns)
        self.vocabs = {
            name: col.vocab for name, col in table.columns.items()
            if isinstance(col, StringColumn)
        }

    @classmethod
    def supports(cls, sft) -> bool:
        raise NotImplementedError

    def _sort_keys(self) -> List[np.ndarray]:
        """Integer key planes, major → minor; sets the index's host key
        arrays (``_z`` or ``_xz``, and ``_bins`` on temporal indexes)."""
        raise NotImplementedError

    def _build_numpy(self, dev: torch.device) -> None:
        """The build from numpy keys and planes: host keys
        (``_sort_keys``), their upload and the device sort, host planes,
        then each plane's upload and gather (stages ``keys_s``,
        ``upload_s``, ``sort_s``, ``planes_s``, ``gather_s``)."""
        st = self.build_stages
        t0 = time.perf_counter()
        keys = self._sort_keys()
        t1 = time.perf_counter()
        if keys is None:   # natural table order
            self.perm = torch.arange(len(self.table), dtype=torch.int64,
                                     device=dev)
            st.update(keys_s=t1 - t0)
            self.device = DeviceTable.build_sorted(
                host_planes(self.table, self.period), self.perm, st)
            return
        dkeys = [torch.from_numpy(np.ascontiguousarray(k)).to(dev)
                 for k in keys]
        sync(dev)
        t2 = time.perf_counter()
        self.perm = device_sort_perm(dkeys)
        del dkeys
        sync(dev)
        t3 = time.perf_counter()
        planes = host_planes(self.table, self.period)
        st.update(keys_s=t1 - t0, upload_s=t2 - t1, sort_s=t3 - t2,
                  planes_s=time.perf_counter() - t3)
        self.device = DeviceTable.build_sorted(planes, self.perm, st)

    def _build_native(self, dev: torch.device) -> bool:
        """The build through the native encoder (point layers); False when
        the layer has none or declines it, and the numpy build runs."""
        return False

    def _native_build(self, encode_chunk: Callable, n: int,
                      key_names: Sequence[str], dev: torch.device) -> bool:
        """The native build (≙ the reference's ``_build_native``,
        ``_stream_build`` and ``_finish_native``,
        ``geomesa_tpu/index/spatial.py:510-610``): ``encode_chunk(lo, hi)``
        encodes rows [lo, hi) into every plane and key, or returns None
        when the native path declines the input (then False: the numpy
        build runs). Streamed past ``GEOMESA_TPU_BUILD_STREAM_CHUNK`` rows
        (``_stream_encode_upload``, stage ``encode_upload_overlap_s``),
        else one encode (``encode_s``); then the attribute planes
        (``planes_s``), the device sort on ``key_names`` (``sort_s``) and
        the gathers (``upload_s``, ``gather_s``)."""
        st = self.build_stages
        chunk = config.BUILD_STREAM_CHUNK.get()
        t0 = time.perf_counter()
        if n > chunk:
            res = _stream_encode_upload(encode_chunk, n, chunk, dev)
            if res is None:
                return False
            planes, kept = res
            z = np.concatenate([h["z"] for h in kept])
            bins = np.concatenate([h["bin16"] for h in kept]) \
                if "bin16" in kept[0] else None
            del kept
            st["encode_upload_overlap_s"] = time.perf_counter() - t0
        else:
            enc = encode_chunk(0, n)
            if enc is None:
                return False
            planes = {k: v for k, v in enc.items() if k not in ("zhi", "zlo")}
            z, bins = enc["z"], enc.get("bin16")
            del enc
            st["encode_s"] = time.perf_counter() - t0
        self._z = z
        if bins is not None:
            self._bins = bins.astype(np.int32)
        t1 = time.perf_counter()
        extra = host_planes(self.table, self.period, skip_geom=True,
                            skip_dtg=True)
        st["planes_s"] = time.perf_counter() - t1
        self._finish_native(planes, key_names, dev)
        self.device = DeviceTable.build_sorted(extra, self.perm, st,
                                               self.device.columns)
        return True

    def _finish_native(self, planes: dict, key_names: Sequence[str],
                       dev: torch.device) -> None:
        """Native planes (host arrays, or device tensors from the streamed
        upload) uploaded, sorted on the device by ``device_sort_perm`` over
        ``key_names`` and gathered one plane at a time, each unsorted plane
        freed after its gather."""
        st = self.build_stages
        t0 = time.perf_counter()
        planes = {k: v if torch.is_tensor(v)
                  else torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                  for k, v in planes.items()}
        sync(dev)
        t1 = time.perf_counter()
        self.perm = device_sort_perm([planes[k] for k in key_names])
        sync(dev)
        t2 = time.perf_counter()
        cols = {}
        for k in list(planes):
            name, col = _query_column(k, planes.pop(k))
            if name is not None:
                cols[name] = col.index_select(0, self.perm)
            del col
        sync(dev)
        st.update(upload_s=st.get("upload_s", 0.0) + t1 - t0, sort_s=t2 - t1,
                  gather_s=st.get("gather_s", 0.0)
                  + time.perf_counter() - t2)
        self.device = DeviceTable(int(self.perm.shape[0]), cols)

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
        raise NotImplementedError

    # the rows path: sorted positions → table rows ------------------------

    # a request past this many positions reads the whole permutation back
    # (the reference's rule, ``geomesa_tpu/index/spatial.py:492``)
    ROW_GATHER_MAX = 1 << 20
    # the host permutation, once read back (``host_perm``)
    _perm_cache: Optional[np.ndarray] = None

    @property
    def host_perm(self) -> np.ndarray:
        """The host copy of the sort permutation (sorted position → table
        row), read back from the device once and kept (≙ the reference's
        ``perm``, ``geomesa_tpu/index/spatial.py:431-439``). The seconds of
        that one read-back are ``build_stages["perm_readback_s"]``."""
        if self._perm_cache is None:
            t0 = time.perf_counter()
            self._perm_cache = self.perm.cpu().numpy()
            self.build_stages["perm_readback_s"] = time.perf_counter() - t0
        return self._perm_cache

    def map_rows(self, idx: np.ndarray) -> np.ndarray:
        """Sorted positions → table rows, by the reference's rule
        (``geomesa_tpu/index/spatial.py:485-494``): the cached host
        permutation once it exists; a request of more than
        ``ROW_GATHER_MAX`` positions reads the whole permutation back once,
        into that cache; a smaller one gathers on the device
        (``_row_gather``)."""
        idx = np.asarray(idx, dtype=np.int64)
        if self._perm_cache is not None or len(idx) > self.ROW_GATHER_MAX:
            return self.host_perm[idx]
        return _row_gather(self.perm, idx)

    # certified segment predicates ------------------------------------------

    def ensure_segment_columns(self) -> bool:
        """Upload each feature's segment endpoints (``sx1``/``sy1``/
        ``sx2``/``sy2`` f32, in index order) when every feature is a
        two-point LineString — what the device certainty-band intersects
        count (``kernels/seg_band.py``) reads. Lazy and cached; False when
        the layer does not qualify (≙ ``geomesa_tpu/index/spatial.py:892``)."""
        cached = getattr(self, "_seg_cols_ok", None)
        if cached is not None:
            return cached
        planes = _segment_planes(self.table.geometry())
        if planes is not None:
            for name, v in planes.items():
                raw = torch.from_numpy(v).to(self.perm.device)
                self.device.columns[name] = raw.index_select(0, self.perm)
        self._seg_cols_ok = planes is not None
        return self._seg_cols_ok

    # incremental merge builds --------------------------------------------

    @classmethod
    def merge_from(cls, old: "BaseSpatialIndex", merged_table: FeatureTable,
                   n_old: int) -> "BaseSpatialIndex":
        """Incremental (LSM-merge) build of any spatial index (≙ the
        reference's ``BaseSpatialIndex.merge_from``,
        ``geomesa_tpu/index/spatial.py:663-823``): ``merged_table`` is
        ``old.table`` followed by ``n_delta`` appended rows. Only the delta
        run's keys are encoded and sorted (``np.lexsort`` of its key
        planes); each delta row's rank ``r`` among the resident sorted keys
        comes from a ``searchsorted`` of its ``_z``/``_xz`` secondary, per
        bin segment on a temporal index, with ties to the residents
        (``side="right"``); the full-scan index appends in natural order
        (every rank ``n_old``). The host key planes merge by direct
        placement; the device columns (an extent layer's envelope planes
        and, where the merged layer keeps them, its segment planes too) and
        the permutation merge in one ``merge_scatter`` launch, moving only
        delta-sized data over the host link; a cached host permutation
        (``host_perm``) merges by the same placement, so it survives the
        flush. Dictionary columns whose vocabulary grew, and the visibility
        codes, rebuild from the merged codes. The result is bitwise the full
        rebuild's: the merged order is the stable lexsort of the
        concatenated keys (residents keep their order, delta rows keep
        theirs, ties go to the smaller table row — a resident)."""
        n_new = len(merged_table)
        n_delta = n_new - n_old
        self = cls.__new__(cls)
        self.sft = old.sft
        self.table = merged_table
        self.geom, self.dtg, self.period = old.geom, old.dtg, old.period
        if hasattr(old, "_sfc"):
            self._sfc = old._sfc
        st: Dict[str, float] = {}
        t0 = time.perf_counter()

        # 1-2. the delta run's keys and its own stable sort
        delta_table = merged_table.take(np.arange(n_old, n_new,
                                                  dtype=np.int64))
        shim = _DeltaKeyShim(old.sft, delta_table, old.geom, old.dtg,
                             old.period)
        keys_d = cls._sort_keys(shim)
        t1 = time.perf_counter()

        # 3. ranks among the residents (bin segment by bin segment)
        touched = 0
        runs = []
        if keys_d is None:   # natural order: the delta appends
            p_d = np.arange(n_delta, dtype=np.int64)
            r = np.full(n_delta, n_old, dtype=np.int64)
        else:
            p_d = np.lexsort(tuple(reversed(keys_d))).astype(np.int64)
            sec = "_z" if hasattr(shim, "_z") else "_xz"
            sec_d = np.asarray(getattr(shim, sec))
            sec_sd = sec_d[p_d]
            old_sec = getattr(old, "sorted" + sec)
            bins_d = getattr(shim, "_bins", None)
            if bins_d is not None:
                b_sd = bins_d[p_d]
                old_b = old.sorted_bins
                r = np.empty(n_delta, dtype=np.int64)
                ub = np.unique(b_sd)
                touched = len(ub)
                for b in ub:
                    ds = np.searchsorted(b_sd, b, side="left")
                    de = np.searchsorted(b_sd, b, side="right")
                    rs = np.searchsorted(old_b, b, side="left")
                    re_ = np.searchsorted(old_b, b, side="right")
                    r[ds:de] = rs + np.searchsorted(old_sec[rs:re_],
                                                    sec_sd[ds:de],
                                                    side="right")
                self._bins = np.concatenate([old._bins, bins_d])
                runs.append(("_sorted_bins", old_b, b_sd))
            else:
                r = np.searchsorted(old_sec, sec_sd,
                                    side="right").astype(np.int64)
            setattr(self, sec, np.concatenate([getattr(old, sec), sec_d]))
            runs.append(("_sorted" + sec, old_sec, sec_sd))
        t2 = time.perf_counter()

        # 4. host key planes: delta row j lands at r[j] + j, the residents
        # fill the rest in order; so does a cached host permutation (the
        # device one merges in step 7 in either case)
        if old._perm_cache is not None:
            runs.append(("_perm_cache", old._perm_cache, n_old + p_d))
        if runs:
            is_delta = np.zeros(n_new, dtype=bool)
            is_delta[r + np.arange(n_delta, dtype=np.int64)] = True
            for attr, res, dl in runs:
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
        # the visibility codes likewise, and when the old table had none
        # (≙ ``geomesa_tpu/index/spatial.py:790-796``)
        old_vis, new_vis = old.table.visibility, merged_table.visibility
        if new_vis is not None and (
                "__vis__" not in old.device.columns or old_vis is None
                or old_vis.vocab != new_vis.vocab):
            stale.append("__vis__")
            full_codes["__vis__"] = new_vis.codes
        t4 = time.perf_counter()

        # 6. the delta's device planes, in delta-sorted order; a line
        # layer's segment planes while every merged feature is still one
        # segment (else they drop, and ``ensure_segment_columns`` declines)
        delta_planes = host_planes(delta_table, old.period)
        seg = _segment_planes(delta_table.geometry()) \
            if getattr(old, "_seg_cols_ok", None) else None
        if seg is not None:
            delta_planes.update(seg)
            self._seg_cols_ok = True
        delta_planes = {k: v[p_d] for k, v in delta_planes.items()}
        t5 = time.perf_counter()

        # 7. one merge_scatter launch: every column and the permutation
        self.device, self.perm = DeviceTable.merge_scatter(
            old.device, delta_planes, r, stale=stale, full_codes=full_codes,
            perm_pair=(old.perm, n_old + p_d),
            host_perm=self._perm_cache, stages=st)

        # 8. the staged scan modes over the merged columns
        self.kernels = ScanKernels(self.device.columns)
        st.update(keys_s=t1 - t0, rank_s=t2 - t1, host_runs_s=t3 - t2,
                  vocab_s=t4 - t3, planes_s=t5 - t4,
                  merge_s=time.perf_counter() - t0, merge_rows=n_delta,
                  merge_fraction=n_delta / max(1, n_old),
                  merge_touched_bins=touched,
                  merge_stale_cols=sorted(stale))
        self.build_stages = st
        return self

    # planning ---------------------------------------------------------------

    def plan(self, f: ir.Filter) -> IndexScanPlan:
        ext = extract_bboxes(f, self.geom) if self.geom is not None \
            else Extraction((WHOLE_WORLD,), False)
        iv = extract_intervals(f, self.dtg) if self.dtg is not None else None
        if len(ext.boxes) == 0 or (iv is not None and len(iv.intervals) == 0):
            return IndexScanPlan(self, "none", empty=True, full_filter=f,
                                 cost=0.0)

        residual = _strip_handled(f, self.geom, self.dtg, self.points)

        boxes_loose = None
        kind = "none"
        if not ext.unconstrained:
            kind = "point_boxes" if self.points else "bbox_overlap"
            boxes_loose = pad_boxes(_boxes_fp62(ext.boxes))

        windows = None
        if iv is not None and not iv.unconstrained:
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
            full_filter=f,
            cost=self._cost(ext, iv),
            explain={"index": self.name, "boxes": ext.boxes,
                     "intervals": None if iv is None else iv.intervals,
                     "residual_device": dev_res, "residual_host": host_res},
        )

    def _cost(self, ext: Extraction, iv) -> float:
        """Heuristic strategy cost (≙ the reference's ``_cost``,
        StrategyDecider's index heuristics: lower is better;
        spatio-temporal beats spatial beats a full scan)."""
        spatial = not ext.unconstrained
        temporal = iv is not None and not iv.unconstrained
        if self.temporal and spatial and temporal:
            return 1.0
        if spatial:
            return 2.0 if not self.temporal else 2.5
        if temporal and self.temporal:
            return 3.0
        return 10.0  # full scan

    # explain ---------------------------------------------------------------

    def key_ranges(self, plan: IndexScanPlan, max_ranges: int = 2000):
        """The reference's z/xz range decomposition of a plan, for explain
        (≙ ``geomesa_tpu/index/spatial.py:1011``): only the Z3 index has
        one."""
        raise NotImplementedError


class Z3Index(BaseSpatialIndex):
    """Point + time: epoch-major (bin, z3) order (≙ Z3IndexKeySpace.scala:34)."""

    name = "z3"
    temporal = True
    points = True

    @classmethod
    def supports(cls, sft) -> bool:
        g = sft.geometry_attribute
        return g is not None and g.type_name == "Point" and sft.dtg_attribute is not None

    def _sort_keys(self) -> List[np.ndarray]:
        """(bin int32, z3 int64) per table row, as the reference encodes
        them; its device sort splits z into three 21-bit planes, which
        orders exactly as the int64 key does."""
        x, y = self.table.geometry().point_xy()
        ms = np.asarray(self.table.columns[self.dtg], dtype=np.int64)
        bins, offs = time_to_binned_time(ms, self.period)
        sfc = Z3SFC.apply(self.period)
        self._sfc = sfc
        self._z = np.asarray(
            sfc.index(x, y, np.minimum(offs, int(sfc.time.max)), lenient=True),
            dtype=np.int64)
        self._bins = np.asarray(bins, dtype=np.int32)
        return [self._bins, self._z]

    def _build_native(self, dev: torch.device) -> bool:
        """The native build (≙ the reference's ``Z3Index._build_native``):
        ``native.z3_encode`` over the points and dates, the sort on
        (``bin16``, ``z``) — the order of (bin, z3) and of the reference's
        (bin16, zhi, zlo)."""
        from geomesa_tpu_torch import native
        garr = self.table.geometry()
        if not (garr.is_points and native.enabled()):
            return False
        x, y = garr.point_xy()
        ms = np.asarray(self.table.columns[self.dtg], dtype=np.int64)
        self._sfc = Z3SFC.apply(self.period)
        period = self.period.value
        return self._native_build(
            lambda a, b: native.z3_encode(x[a:b], y[a:b], ms[a:b], period),
            len(x), ("bin16", "z"), dev)

    @property
    def sorted_z(self) -> np.ndarray:
        return self._sorted_plane("_sorted_z", self._z)

    def key_ranges(self, plan: IndexScanPlan, max_ranges: int = 2000):
        """[(bin, z3 ranges)] of the plan's first 8 intervals, bin by bin
        (≙ ``geomesa_tpu/index/spatial.py:1078``)."""
        ext = extract_bboxes(plan.full_filter, self.geom)
        iv = extract_intervals(plan.full_filter, self.dtg)
        ranges = []
        for lo, hi in iv.intervals[:8] if not iv.unconstrained else []:
            blo, olo = time_to_binned_time(lo, self.period)
            bhi, ohi = time_to_binned_time(hi, self.period)
            for b in range(int(blo), int(bhi) + 1):
                t0 = int(olo) if b == int(blo) else 0
                t1 = int(ohi) if b == int(bhi) \
                    else max_offset(self.period) - 1
                rs = self._sfc.ranges(list(ext.boxes), [(t0, t1)],
                                      max_ranges=max_ranges)
                ranges.append((b, rs))
        return ranges

    def _row_slices(self, boxes, intervals) -> Optional[np.ndarray]:
        return self._binned_row_slices(
            boxes, intervals, self.sorted_z,
            lambda bx, w: self._sfc.ranges_arrays(
                bx, [w], max_ranges=_p.MAX_RANGES))


class Z2Index(BaseSpatialIndex):
    """Point, no time: z2 order (≙ Z2IndexKeySpace.scala:29)."""

    name = "z2"
    temporal = False
    points = True

    @classmethod
    def supports(cls, sft) -> bool:
        g = sft.geometry_attribute
        return g is not None and g.type_name == "Point"

    def _sort_keys(self) -> List[np.ndarray]:
        x, y = self.table.geometry().point_xy()
        self._z = Z2SFC().index(x, y, lenient=True)
        return _split63(self._z)

    def _build_native(self, dev: torch.device) -> bool:
        """The native build (≙ the reference's ``Z2Index._build_native``):
        ``native.z2_encode``, the sort on ``z`` (the order of its three
        21-bit planes and of the reference's (zhi, zlo))."""
        from geomesa_tpu_torch import native
        garr = self.table.geometry()
        if not (garr.is_points and native.enabled()):
            return False
        x, y = garr.point_xy()
        return self._native_build(
            lambda a, b: native.z2_encode(x[a:b], y[a:b]), len(x), ("z",),
            dev)

    @property
    def sorted_z(self) -> np.ndarray:
        return self._sorted_plane("_sorted_z", self._z)

    def _row_slices(self, boxes, intervals) -> Optional[np.ndarray]:
        rs = Z2SFC().ranges_arrays(boxes, max_ranges=_p.MAX_RANGES)
        return _p.ranges_to_slices(self.sorted_z, rs)


class XZ3Index(BaseSpatialIndex):
    """Extent + time: (bin, xz3) order (≙ XZ3IndexKeySpace.scala:33)."""

    name = "xz3"
    temporal = True
    points = False

    @classmethod
    def supports(cls, sft) -> bool:
        g = sft.geometry_attribute
        return g is not None and g.type_name != "Point" \
            and sft.dtg_attribute is not None

    def _sort_keys(self) -> List[np.ndarray]:
        bb = self.table.geometry().bboxes()
        ms = np.asarray(self.table.columns[self.dtg], dtype=np.int64)
        bins, offs = time_to_binned_time(ms, self.period)
        sfc = XZ3SFC.apply(self.sft.xz_precision, self.period)
        mins = np.stack([bb[:, 0], bb[:, 1], offs.astype(np.float64)], axis=1)
        maxs = np.stack([bb[:, 2], bb[:, 3], offs.astype(np.float64)], axis=1)
        self._xz = sfc.index(mins, maxs, lenient=True)
        self._bins = np.asarray(bins, dtype=np.int32)
        return [self._bins] + _split63(self._xz)

    @property
    def sorted_xz(self) -> np.ndarray:
        return self._sorted_plane("_sorted_xz", self._xz)

    def _row_slices(self, boxes, intervals) -> Optional[np.ndarray]:
        sfc = XZ3SFC.apply(self.sft.xz_precision, self.period)

        def cover(bx, w):
            qs = [(xmin, ymin, float(w[0]), xmax, ymax, float(w[1]))
                  for xmin, ymin, xmax, ymax in bx]
            return sfc.ranges(qs, max_ranges=_p.MAX_RANGES)

        return self._binned_row_slices(boxes, intervals, self.sorted_xz, cover)


class XZ2Index(BaseSpatialIndex):
    """Extent, no time: xz2 order (≙ XZ2IndexKeySpace.scala:28)."""

    name = "xz2"
    temporal = False
    points = False

    @classmethod
    def supports(cls, sft) -> bool:
        g = sft.geometry_attribute
        return g is not None and g.type_name != "Point"

    def _sort_keys(self) -> List[np.ndarray]:
        bb = self.table.geometry().bboxes()
        sfc = XZ2SFC.apply(self.sft.xz_precision)
        self._xz = sfc.index(bb[:, [0, 1]], bb[:, [2, 3]], lenient=True)
        return _split63(self._xz)

    @property
    def sorted_xz(self) -> np.ndarray:
        return self._sorted_plane("_sorted_xz", self._xz)

    def _row_slices(self, boxes, intervals) -> Optional[np.ndarray]:
        sfc = XZ2SFC.apply(self.sft.xz_precision)
        rs = sfc.ranges_bbox(boxes, max_ranges=_p.MAX_RANGES)
        return _p.ranges_to_slices(self.sorted_xz, rs)


class S2Index(BaseSpatialIndex):
    """Point, no time: S2 (Hilbert-on-cube) order, opt-in through
    ``geomesa.indices=s2`` (≙ the reference's ``S2Index``,
    ``geomesa_tpu/index/spatial.py:1218-1251``; S2IndexKeySpace.scala:34).
    Its keys come from the host encode (``curves.s2``) and sort on the
    device; its table is a point table, so it scans as Z2's does."""

    name = "s2"
    temporal = False
    points = True
    # measured cover slop vs true rows (curves/s2.py _cell_rect): the cost
    # model prices S2 plans above an equally-selective Z cover
    cover_slop = 1.1

    @classmethod
    def supports(cls, sft) -> bool:
        g = sft.geometry_attribute
        names = sft.configured_indices
        return (names is not None and "s2" in names
                and g is not None and g.type_name == "Point")

    def _sort_keys(self) -> List[np.ndarray]:
        x, y = self.table.geometry().point_xy()
        self._z = S2SFC.apply().index(x, y, lenient=True)
        return _split63(self._z)

    @property
    def sorted_z(self) -> np.ndarray:
        return self._sorted_plane("_sorted_z", self._z)

    def _row_slices(self, boxes, intervals) -> Optional[np.ndarray]:
        rs = S2SFC.apply().ranges(boxes, max_ranges=_p.MAX_RANGES)
        return _p.ranges_to_slices(self.sorted_z, rs)


class S3Index(BaseSpatialIndex):
    """Point + time: epoch-major (bin, s2) order, opt-in through
    ``geomesa.indices=s3`` (≙ the reference's ``S3Index``,
    ``geomesa_tpu/index/spatial.py:1254-1301``; S3IndexKeySpace.scala:36):
    the S2 cell id carries no time bits, so temporal pruning lands at bin
    granularity, as in the [epoch][s2] layout."""

    name = "s3"
    temporal = True
    points = True
    cover_slop = 1.1   # see S2Index

    @classmethod
    def supports(cls, sft) -> bool:
        g = sft.geometry_attribute
        names = sft.configured_indices
        return (names is not None and "s3" in names and g is not None
                and g.type_name == "Point" and sft.dtg_attribute is not None)

    def _sort_keys(self) -> List[np.ndarray]:
        x, y = self.table.geometry().point_xy()
        ms = np.asarray(self.table.columns[self.dtg], dtype=np.int64)
        bins, _ = time_to_binned_time(ms, self.period)
        self._z = S2SFC.apply().index(x, y, lenient=True)
        self._bins = np.asarray(bins, dtype=np.int32)
        return [self._bins] + _split63(self._z)

    @property
    def sorted_z(self) -> np.ndarray:
        return self._sorted_plane("_sorted_z", self._z)

    def _row_slices(self, boxes, intervals) -> Optional[np.ndarray]:
        sfc = S2SFC.apply()
        cover = {}

        def cover_fn(bx, w):   # no time dim in the s2 key: one shared cover
            if "c" not in cover:
                cover["c"] = sfc.ranges(bx, max_ranges=_p.MAX_RANGES)
            return cover["c"]

        return self._binned_row_slices(boxes, intervals, self.sorted_z,
                                       cover_fn)


class FullScanIndex(BaseSpatialIndex):
    """Natural-order fallback for a schema with no spatial index (≙ the
    reference's ``FullScanIndex``, ``geomesa_tpu/index/spatial.py
    :1304-1331``, its full-table-scan strategy): the table's rows in load
    order (the permutation is the identity), every predicate a residual,
    cost 100. The reference builds one for every schema; it never wins
    against a spatial plan (its cost and its priced rows are never lower),
    so the port builds it only where no spatial index is picked."""

    name = "full"
    temporal = False
    points = True

    @classmethod
    def supports(cls, sft) -> bool:
        return True

    def _sort_keys(self):
        return None   # natural table order

    def map_rows(self, idx: np.ndarray) -> np.ndarray:
        return np.asarray(idx, dtype=np.int64)

    def plan(self, f: ir.Filter) -> IndexScanPlan:
        avail = set(self.device.columns)
        dev_res, host_res = split_residual(
            f if not isinstance(f, ir.Include) else None, self.sft,
            self.vocabs, avail)
        compiled = compile_residual(dev_res, self.sft, self.vocabs, avail) \
            if dev_res else None
        return IndexScanPlan(
            index=self, primary_kind="none", residual_device=compiled,
            residual_host=host_res, full_filter=f, cost=100.0,
            explain={"index": self.name, "residual_host": host_res})


# the reference's order (geomesa_tpu/index/spatial.py:1334): a schema
# builds the first class that supports it (S3 and S2 only where
# ``geomesa.indices`` names them)
INDEX_CLASSES = [S3Index, S2Index, Z3Index, XZ3Index, Z2Index, XZ2Index]


def spatial_index_class(sft):
    """The spatial index a schema builds (≙ the pick of the reference's
    ``_build_planner``, ``geomesa_tpu/datastore.py:519-530``): the first
    class of ``INDEX_CLASSES`` that supports ``sft`` and, when
    ``geomesa.indices`` names indexes, that it names; None when there is
    none (the full-scan index then serves)."""
    names = sft.configured_indices
    for c in INDEX_CLASSES:
        if names is not None and c.name not in names:
            continue
        if c.supports(sft):
            return c
    return None
