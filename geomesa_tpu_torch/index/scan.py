"""Device predicates of the scans and the staged scan path, as torch
functions.

≙ ``geomesa_tpu.index.scan``: the exact fp62 box mask of point layers and
envelope-overlap mask of extent layers (``PRIMARY_FNS``), the exact
binned-time window mask, the residual-predicate compiler (a torch closure
and the same predicate as a postfix program, ``eval_program``), the fused
program's block gate, candidate scan and ordered compaction (``block_gate``,
``fused_scan`` and ``ordered_compact``, the plain versions of
``kernels/csrc/block_gate.cu``, ``fused_scan.cu`` and
``ordered_compact.cu``, over the packed ``FusedQuery``), the
segment certainty band of single-segment line layers (``seg_band``, the
plain version of ``kernels/csrc/seg_band.cu``), the certainty-band
point-in-polygon classifier (``pip_band``) and the fused program's polygon
refine built on it (``pip_refine``, the plain version of the CUDA kernel in
``kernels/csrc/pip_refine.cu``), the radial-distance refine
(``dist_refine``, the plain version of ``kernels/csrc/dist_refine.cu``),
the masked density scatter (``_grid_scatter``
and ``grid_scatter``, the plain versions of ``kernels/csrc/grid_scatter.cu``),
the batched box counts (``box_count``, the plain version of
``kernels/csrc/box_count.cu``), and ``ScanKernels``, the staged scan modes
over one index's device table, on a point layer through the fused
program's kernels (``staged_query``). Every function takes tensors on whatever
device the caller's table lives on. ``ROUNDS`` counts the host-to-device
copies (``_dev``) and blocking readbacks (``_fetch``) of the port's query
paths.

Exactness contract (as in the reference): box and time masks compare int32
planes and so reproduce the host's f64 predicates exactly; geometry uses f32
with a certainty band, and only the uncertain sliver refines on the host.
"""

from __future__ import annotations

import functools
import warnings
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from geomesa_tpu_torch import trace as _trace
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.index import prune as _prune


class _RoundLedger:
    """Process-wide count of host↔device rounds (≙ the reference's
    ``ROUNDS``): ``dispatches`` counts blocking readbacks (``_fetch``),
    ``uploads`` host-to-device copies of query constants (``_dev``).
    Host syncs inside a dispatch are measured by ``host_syncs``."""

    __slots__ = ("dispatches", "uploads")

    def __init__(self):
        self.dispatches = 0
        self.uploads = 0

    def snapshot(self):
        return (self.dispatches, self.uploads)


ROUNDS = _RoundLedger()

# the calls that make the host wait for the card: a tensor's value read
# into Python, or an output whose size depends on the values
_SYNC_CALLS = frozenset({
    torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.numpy,
    torch.Tensor.__bool__, torch.Tensor.__int__, torch.Tensor.__float__,
    torch.Tensor.__index__, torch.nonzero, torch.Tensor.nonzero,
    torch.argwhere, torch.Tensor.argwhere, torch.masked_select,
    torch.Tensor.masked_select, torch.unique, torch.Tensor.unique,
    torch.unique_consecutive, torch.Tensor.unique_consecutive})
# ... and these when a bool tensor indexes (a hidden nonzero)
_MASK_INDEX = frozenset({torch.Tensor.__getitem__, torch.Tensor.__setitem__,
                         torch.Tensor.index_put, torch.Tensor.index_put_})


def _bool_index(idx) -> bool:
    items = idx if isinstance(idx, (tuple, list)) else (idx,)
    return any(isinstance(i, torch.Tensor) and i.dtype is torch.bool
               for i in items)


class _SyncCalls(torch.overrides.TorchFunctionMode):
    def __init__(self, counter):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (func in _SYNC_CALLS
                or (func is torch.where and len(args) + len(kwargs or ()) == 1)
                or (func in _MASK_INDEX and len(args) > 1
                    and _bool_index(args[1]))):
            self.counter.count += 1
        return func(*args, **(kwargs or {}))


# the warning of torch.cuda.set_sync_debug_mode("warn") (and only that one:
# turning the mode on warns that it is a prototype, "synchronizing" too)
_SYNC_WARNING = "called a synchronizing CUDA operation"


class host_syncs:
    """Counts the host syncs that work on ``device`` makes inside a
    ``with`` block, as ``count``. On the card it is CUDA's own check:
    ``torch.cuda.set_sync_debug_mode`` makes the operations that wait for
    the device warn (torch calls the mode a prototype that does not see
    every such operation), and each warning counts (a wait on a CUDA
    event, as ``Readback.host`` makes, is not one). On the CPU, where nothing waits,
    it counts the calls that would wait on the card: a tensor's value read
    into Python (``item``, ``bool``, ``int``, ``tolist``, ``numpy`` ...)
    and the operations whose output size depends on the values
    (``nonzero``, ``masked_select``, ``unique``, indexing by a bool mask).
    For tests and measurements: on the CPU it slows every torch call."""

    def __init__(self, device="cpu"):
        self.cuda = torch.device(device).type == "cuda"
        self.count = 0

    def __enter__(self) -> "host_syncs":
        self.count = 0
        if self.cuda:
            self._warns = warnings.catch_warnings(record=True)
            self._seen = self._warns.__enter__()
            warnings.simplefilter("always")
            self._debug = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        else:
            self._mode = _SyncCalls(self)
            self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.set_sync_debug_mode(self._debug)
            self.count = sum(_SYNC_WARNING in str(w.message)
                             for w in self._seen)
            self._warns.__exit__(*exc)
        else:
            self._mode.__exit__(*exc)
        return False


def _host(t):
    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
        return Readback(t).host()
    return t


def _ready(out):
    """A dispatch's result read back to the host: each device tensor copies
    into pinned host memory (``Readback``) and waits for its stream's event
    only (no device-wide synchronise). Host values and CPU tensors pass as
    they are."""
    if isinstance(out, (tuple, list)):
        return type(out)(_host(t) for t in out)
    return _host(out)


def _fetch(dispatch, *args):
    """Run a dispatch under a ``device_scan`` span (the host-side enqueue)
    and read it back under a ``device_wait`` span; returns the result on
    the host. One blocking readback in ``ROUNDS``."""
    ROUNDS.dispatches += 1
    return _trace.device_fetch(_ready, dispatch, *args)


def _dev(a, device) -> Optional[torch.Tensor]:
    """A host array's copy on ``device`` (one upload in ``ROUNDS``). To the
    card it goes through pinned memory, queued on the current stream: the
    host does not wait for the copy."""
    if a is None:
        return None
    ROUNDS.uploads += 1
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class Readback:
    """A device result's copy to the host, started now and read later from
    another thread: on the card the values copy into pinned host memory on
    the launching thread's stream, behind a CUDA event recorded after the
    copy; ``wait`` blocks on that event only. A CPU tensor needs no copy."""

    __slots__ = ("_host", "_event")

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t

    def host(self) -> torch.Tensor:
        """The host tensor, once the copy is done."""
        if self._event is not None:
            self._event.synchronize()
        return self._host

    def wait(self) -> np.ndarray:
        return self.host().numpy()

# -- primary spatial/temporal masks -----------------------------------------


def _ge62(hi, lo, qhi, qlo):
    """Lexicographic fixed-point (hi, lo) >= (qhi, qlo)."""
    return (hi > qhi) | ((hi == qhi) & (lo >= qlo))


def _le62(hi, lo, qhi, qlo):
    return (hi < qhi) | ((hi == qhi) & (lo <= qlo))


def point_boxes(cols, boxes: torch.Tensor) -> torch.Tensor:
    """Any-box containment for point layers — EXACT (fp62 planes). boxes
    (B, 8) int32: [qxlo_hi, qxlo_lo, qxhi_hi, qxhi_lo, qylo_hi, qylo_lo,
    qyhi_hi, qyhi_lo]; empty boxes use qlo=max/qhi=0 so nothing matches."""
    xi, xl = cols["xi"][:, None], cols["xl"][:, None]
    yi, yl = cols["yi"][:, None], cols["yl"][:, None]
    b = boxes[None, :, :]
    return (
        _ge62(xi, xl, b[..., 0], b[..., 1]) & _le62(xi, xl, b[..., 2], b[..., 3])
        & _ge62(yi, yl, b[..., 4], b[..., 5]) & _le62(yi, yl, b[..., 6], b[..., 7])
    ).any(dim=1)


def bbox_overlap(cols, boxes: torch.Tensor) -> torch.Tensor:
    """Any-box envelope overlap for extent layers — EXACT on the envelopes
    (fp62 planes; refining to the geometry is the spatial residual's job):
    a row passes box b when bxmin <= qxhi, bxmax >= qxlo, bymin <= qyhi and
    bymax >= qylo (≙ the reference's ``_bbox_overlap_mask``)."""
    b = boxes[None, :, :]
    return (
        _le62(cols["bxmin_i"][:, None], cols["bxmin_l"][:, None],
              b[..., 2], b[..., 3])
        & _ge62(cols["bxmax_i"][:, None], cols["bxmax_l"][:, None],
                b[..., 0], b[..., 1])
        & _le62(cols["bymin_i"][:, None], cols["bymin_l"][:, None],
                b[..., 6], b[..., 7])
        & _ge62(cols["bymax_i"][:, None], cols["bymax_l"][:, None],
                b[..., 4], b[..., 5])
    ).any(dim=1)


# the primary masks by kind (≙ the reference's PRIMARY_FNS)
PRIMARY_FNS: Dict[str, Callable] = {
    "point_boxes": point_boxes,
    "bbox_overlap": bbox_overlap,
}


def _time_mask(cols, windows: torch.Tensor) -> torch.Tensor:
    """Any-window (bin, off) containment (≙ Z3Filter.timeInBounds, exact).
    windows (T, 4) int32 [bin_lo, off_lo, bin_hi, off_hi]; empty windows
    have bin_lo > bin_hi."""
    b = cols["bin"][:, None]
    o = cols["off"][:, None]
    blo, olo = windows[None, :, 0], windows[None, :, 1]
    bhi, ohi = windows[None, :, 2], windows[None, :, 3]
    after_lo = (b > blo) | ((b == blo) & (o >= olo))
    before_hi = (b < bhi) | ((b == bhi) & (o <= ohi))
    return (after_lo & before_hi & (blo <= bhi)).any(dim=1)


# -- certified f32 point-in-polygon ------------------------------------------
#
# Every orientation sign carries an error bound covering the f32 arithmetic
# and the f64→f32 input rounding, so each point classifies as certain-in /
# certain-out / uncertain; only the uncertain sliver goes to the host's f64
# refine. The constants and the order of every operation are the reference's
# (geomesa_tpu/index/scan.py _orient_band/_pip_band), which makes the flags
# bit-identical to it.

_F32_EPS = np.float32(1.2e-7)     # 2^-23 with margin
_IN_DELTA = np.float32(2.5e-5)    # |f64 coord - f32 coord| bound (lon/lat)
_DY_BAND = np.float32(3e-5)       # vertex y-tie band for the crossing rule
# the reference's 8 * _F32_EPS and 4 * _IN_DELTA, as f32 values (the CUDA
# kernel receives these same numbers)
TOL_T = float(8 * _F32_EPS)
TOL_D = float(4 * _IN_DELTA)
DY_BAND = float(_DY_BAND)

# polygon-edge pad: far-away horizontal edges (ey1 == ey2 → no crossing;
# orientation signs large and same → certain-miss), so padded rows never
# create hits or uncertainty
EDGE_PAD = np.array([1e9, 1e9, 2e9, 1e9], dtype=np.float32)

# (point, edge) pairs per chunk of the plain version: bounds its
# temporaries to a few hundred MB whatever the edge count
_PIP_CHUNK_PAIRS = 1 << 24


def _orient_band(px, py, qx, qy, rx, ry):
    """Signed area orientation of (p,q,r) with a conservative error bound."""
    d1x = qx - px
    d1y = qy - py
    d2x = rx - px
    d2y = ry - py
    t1 = d1x * d2y
    t2 = d1y * d2x
    det = t1 - t2
    tol = (TOL_T * (t1.abs() + t2.abs())
           + TOL_D * (d1x.abs() + d1y.abs() + d2x.abs() + d2y.abs()))
    return det, tol


def _pip_band(px, py, ex1, ey1, ex2, ey2, evalid=None):
    """(certainly-inside, certainly-outside) of points against padded
    polygon edges, reduced over the last axis (≙ the reference's
    ``_pip_band``): ``evalid`` masks the padded edges out of both the
    crossings and the uncertainty, as the geometry catalog's feature edge
    tables need."""
    cond = (ey1 > py) != (ey2 > py)
    o, t = _orient_band(ex1, ey1, ex2, ey2, px, py)
    upward = ey2 > ey1
    cross = cond & torch.where(upward, o > t, o < -t)
    unc = (cond & (o.abs() <= t)) \
        | ((ey1 - py).abs() <= DY_BAND) | ((ey2 - py).abs() <= DY_BAND)
    if evalid is not None:
        cross = cross & evalid
        unc = unc & evalid
    inside = (cross.sum(dim=-1) % 2) == 1
    any_unc = unc.any(dim=-1)
    return inside & ~any_unc, ~inside & ~any_unc


def pip_band(px: torch.Tensor, py: torch.Tensor, edges: torch.Tensor):
    """(certainly-inside, certainly-outside) bool flags of f32 points
    ``px``/``py`` (n,) against an f32 edge table (ne, 4) = [x1, y1, x2, y2],
    by the half-open crossing rule: uncertain when any edge's crossing
    decision sits inside its error band or a vertex y ties the ray.

    Points run in chunks so the (point, edge) temporaries stay bounded;
    each point's flags depend on its own row only, so chunking changes
    nothing."""
    n, ne = px.shape[0], edges.shape[0]
    cin = torch.empty(n, dtype=torch.bool, device=px.device)
    cout = torch.empty(n, dtype=torch.bool, device=px.device)
    e = [edges[None, :, k] for k in range(4)]
    step = max(1, _PIP_CHUNK_PAIRS // max(1, ne))
    for a in range(0, n, step):
        b = min(n, a + step)
        cin[a:b], cout[a:b] = _pip_band(
            px[a:b, None], py[a:b, None], *e)
    return cin, cout


def _segpair_band(ax, ay, bx, by, cx, cy, dx, dy):
    """(certain-intersect, certain-miss) of segment (a, b) against edge
    (c, d), four orientation bands (≙ the reference's ``_segpair_band``)."""
    o1, t1 = _orient_band(ax, ay, bx, by, cx, cy)
    o2, t2 = _orient_band(ax, ay, bx, by, dx, dy)
    o3, t3 = _orient_band(cx, cy, dx, dy, ax, ay)
    o4, t4 = _orient_band(cx, cy, dx, dy, bx, by)
    opp12 = ((o1 > t1) & (o2 < -t2)) | ((o1 < -t1) & (o2 > t2))
    opp34 = ((o3 > t3) & (o4 < -t4)) | ((o3 < -t3) & (o4 > t4))
    same12 = ((o1 > t1) & (o2 > t2)) | ((o1 < -t1) & (o2 < -t2))
    same34 = ((o3 > t3) & (o4 > t4)) | ((o3 < -t3) & (o4 < -t4))
    return opp12 & opp34, same12 | same34


def _seg_flags(ax, ay, bx, by, edges: torch.Tensor):
    """(certain hit, certain miss) of segments (a, b) (n,) against a
    polygon's edge table: an endpoint certainly inside or a certain
    crossing is a hit; both endpoints certainly outside and every edge a
    certain miss is a miss (the reference's ``intersects_band_blocks``
    composition). Segments run in chunks, as in ``pip_band``."""
    n, ne = ax.shape[0], edges.shape[0]
    hit = torch.empty(n, dtype=torch.bool, device=ax.device)
    miss = torch.empty(n, dtype=torch.bool, device=ax.device)
    e = [edges[None, :, k] for k in range(4)]
    step = max(1, _PIP_CHUNK_PAIRS // max(1, ne))
    for a in range(0, n, step):
        b = min(n, a + step)
        sa = [v[a:b, None] for v in (ax, ay, bx, by)]
        hit_p, miss_p = _segpair_band(*sa, *e)
        in_a, out_a = _pip_band(sa[0], sa[1], *e)
        in_b, out_b = _pip_band(sa[2], sa[3], *e)
        hit[a:b] = in_a | in_b | hit_p.any(dim=1)
        miss[a:b] = out_a & out_b & miss_p.all(dim=1)
    return hit, miss


def seg_band(cols, boxes: torch.Tensor, windows: Optional[torch.Tensor],
             resid: Optional[torch.Tensor], block_ids: torch.Tensor,
             bsz: int, edges: torch.Tensor, n_edges: Optional[int],
             unc_cap: int) -> torch.Tensor:
    """int32 ``[certain hits, n_uncertain, uncertain rows × unc_cap]`` of
    the segment features in the candidate blocks against a polygon (≙ the
    reference's ``intersects_band_blocks`` mode). A candidate is live when
    it belongs to its block (``expand_blocks``), its envelope overlaps any
    of the (B, 8) fp62 ``boxes``, its (bin, off) lies in any of the (T, 4)
    ``windows``, its ``resid`` byte is set and the table's ``__valid__``
    holds; a live candidate is a certain hit, a certain miss or uncertain
    by ``_seg_flags`` over its ``sx1``/``sy1``/``sx2``/``sy2`` planes and
    the f32 ``edges`` (``n_edges`` keeps the table's first rows, the rest
    being ``EDGE_PAD`` filler that changes no flag). The uncertain rows are
    the sorted-table positions of the first ``unc_cap`` uncertain
    candidates in candidate order, padded with the table's row count;
    ``n_uncertain`` counts them all.

    The plain PyTorch version of the ``seg_band`` CUDA kernel. The CPU
    path, and the kernel's yardstick on the card."""
    n = int(next(iter(cols.values())).shape[0])
    m, rows, _, g = expand_blocks(cols, block_ids, bsz, n)
    m = m & bbox_overlap(g, boxes)
    if windows is not None:
        m = m & _time_mask(g, windows)
    for extra in (resid, g["__valid__"] if "__valid__" in g else None):
        if extra is not None:
            m = m & extra
    if n_edges is not None:
        edges = edges[:n_edges]
    hit, miss = _seg_flags(g["sx1"], g["sy1"], g["sx2"], g["sy2"], edges)
    hit = m & hit
    unc = m & ~hit & ~miss
    return torch.cat([hit.sum(dtype=torch.int32).reshape(1),
                      unc.sum(dtype=torch.int32).reshape(1),
                      _ordered(unc, unc_cap, rows, n)])


def live_candidates(mask: Optional[torch.Tensor], ncand: int,
                    n_blocks: Optional[torch.Tensor], bsz: Optional[int],
                    device) -> Optional[torch.Tensor]:
    """``mask`` limited to the candidates of the first ``n_blocks`` slots of
    a block list (int32 (1,) on the device; None: every candidate), as the
    kernels limit it: they read the count and stop there."""
    if n_blocks is None:
        return mask
    live = (torch.arange(ncand, device=device)
            < n_blocks.to(torch.int64) * bsz)
    return live if mask is None else mask & live


def pip_refine(xf: torch.Tensor, yf: torch.Tensor, edges: torch.Tensor,
               mask: Optional[torch.Tensor] = None,
               starts: Optional[torch.Tensor] = None,
               bsz: Optional[int] = None, n_edges: Optional[int] = None,
               n_blocks: Optional[torch.Tensor] = None):
    """(hit, uncertain) bool flags of the fused program's candidate rows
    against a polygon edge table: ``mask & cin`` and ``mask & ~cin & ~cout``
    over ``pip_band``'s flags (≙ the reference's ``refine_of`` for its
    ``pip`` kind). Candidate i is row ``starts[i // bsz] + i % bsz`` of
    ``xf``/``yf`` when block starts are given, else row i; ``mask=None``
    makes every candidate live; ``n_edges`` keeps only the table's first
    rows (the rest ``EDGE_PAD`` filler, which changes no flag); with
    ``n_blocks`` (int32 (1,) on the device) only the first ``n_blocks``
    slots' candidates are live, and the flags of the others are 0 here and
    unwritten by the kernel.

    The plain PyTorch version of the ``pip_refine`` CUDA kernel: gather,
    classify, mask. The CPU path, and the kernel's yardstick on the card."""
    if starts is not None:
        rows = block_rows(starts, bsz)
        xf, yf = xf.index_select(0, rows), yf.index_select(0, rows)
    mask = live_candidates(mask, xf.shape[0], n_blocks, bsz, xf.device)
    if n_edges is not None:
        edges = edges[:n_edges]
    cin, cout = pip_band(xf, yf, edges)
    unc = ~cin & ~cout
    if mask is None:
        return cin, unc
    return mask & cin, mask & unc


# radial-distance certainty band (degrees) of the ``dist`` refine kind (the
# reference's compiled._DIST_BAND): it exceeds the f32 error of the distance
# over the f32 coordinate planes (coordinate rounding ≤ 2.5e-5 an axis, a
# few ulp of arithmetic, the radius literal's own f32 cast), so rows inside
# the band re-evaluate on the host in exact f64
DIST_BAND = np.float32(1e-3)


class DistBounds(NamedTuple):
    """(cx, cy, r − DIST_BAND, r + DIST_BAND) of a circle, each an f32
    value held as a Python float."""
    cx: float
    cy: float
    rlo: float
    rhi: float


def dist_bounds(circle) -> DistBounds:
    """The bounds of an f32 [cx, cy, r], each rounded in f32 as the
    reference's traced program rounds it."""
    cx, cy, r = np.asarray(circle, dtype=np.float32)
    return DistBounds(float(cx), float(cy), float(r - DIST_BAND),
                      float(r + DIST_BAND))


def dist_refine(xf: torch.Tensor, yf: torch.Tensor, bounds: DistBounds,
                mask: Optional[torch.Tensor] = None,
                starts: Optional[torch.Tensor] = None,
                bsz: Optional[int] = None,
                n_blocks: Optional[torch.Tensor] = None):
    """(hit, uncertain) bool flags of the fused program's candidate rows
    against the circle of ``bounds`` (``dist_bounds`` of f32 [cx, cy, r];
    ≙ the reference's ``refine_of`` for its ``dist`` kind): with d =
    sqrt((x − cx)² + (y − cy)²) in f32, hit = d ≤ r − DIST_BAND and
    uncertain = not hit and not d ≥ r + DIST_BAND, both masked. Candidates
    are read (and limited by ``n_blocks``) as in ``pip_refine``. Also int32
    [hits, uncertain]: the flags' sums, the first two words of the fused
    program's refine result.

    The plain PyTorch version of the ``dist_refine`` CUDA kernel: gather,
    classify, mask. The CPU path, and the kernel's yardstick on the card."""
    if starts is not None:
        rows = block_rows(starts, bsz)
        xf, yf = xf.index_select(0, rows), yf.index_select(0, rows)
    mask = live_candidates(mask, xf.shape[0], n_blocks, bsz, xf.device)
    cx, cy, lo, hi = (torch.tensor(v, dtype=torch.float32, device=xf.device)
                      for v in bounds)
    dx = xf - cx
    dy = yf - cy
    d = torch.sqrt(dx * dx + dy * dy)
    hit = d <= lo
    unc = ~hit & ~(d >= hi)
    if mask is not None:
        hit, unc = mask & hit, mask & unc
    return hit, unc, torch.stack([hit.sum(dtype=torch.int32),
                                  unc.sum(dtype=torch.int32)])


# -- density scatter (plain versions of kernels/csrc/grid_scatter.cu) --------

# where an f32 sum of ones stops growing: 2^24 + 1 rounds back to 2^24
UNIT_CLAMP = 1 << 24


def _grid_scatter(xs: torch.Tensor, ys: torch.Tensor, mask: torch.Tensor,
                  weight: Optional[torch.Tensor], grid: torch.Tensor,
                  width: int, height: int) -> torch.Tensor:
    """Masked scatter-add onto a (height, width) f32 raster, ``grid`` =
    [xmin, ymin, xmax, ymax] f32 (GridSnap.scala:23 snap semantics, the
    reference's ``_grid_scatter`` operation for operation): a row counts when
    0 <= fx < 1 and 0 <= fy < 1, then lands in cell (clip(int(fy * H)),
    clip(int(fx * W))). ``weight`` (int32 or f32) converts to f32 and adds
    in f32. None counts rows: the reference adds f32 ones one at a time, and
    such a sum stops at 2^24, so the counts are integers clamped there
    (exact in any order, on any device). Rows that do not count land in
    cells past the raster that are dropped, so no size depends on the mask
    (spread over as many cells as the raster has, so that no one cell takes
    every atomic add)."""
    xmin, ymin, xmax, ymax = grid[0], grid[1], grid[2], grid[3]
    fx = (xs - xmin) / (xmax - xmin)
    fy = (ys - ymin) / (ymax - ymin)
    inb = mask & (fx >= 0) & (fx < 1) & (fy >= 0) & (fy < 1)
    ix = (fx * width).to(torch.int32).clamp_(0, width - 1)
    iy = (fy * height).to(torch.int32).clamp_(0, height - 1)
    cells = height * width
    spill = cells + torch.arange(inb.shape[0], device=xs.device) % cells
    cell = torch.where(inb, iy.to(torch.int64) * width + ix, spill)
    if weight is None:
        out = torch.zeros(2 * cells, dtype=torch.int64, device=xs.device)
        out.scatter_add_(0, cell, torch.ones_like(cell))
        out = out[:cells].clamp_(max=UNIT_CLAMP).to(torch.float32)
    else:
        out = torch.zeros(2 * cells, dtype=torch.float32, device=xs.device)
        out.scatter_add_(0, cell, weight.to(torch.float32))
        out = out[:cells]
    return out.reshape(height, width)


def block_rows(starts: torch.Tensor, bsz: int) -> torch.Tensor:
    """Row ids of the candidates read through block starts: candidate i is
    row ``starts[i // bsz] + i % bsz``."""
    return (starts[:, None] + torch.arange(
        bsz, device=starts.device)[None, :]).reshape(-1)


def grid_scatter(xf: torch.Tensor, yf: torch.Tensor, mask: torch.Tensor,
                 weight: Optional[torch.Tensor], starts: Optional[torch.Tensor],
                 bsz: Optional[int], grid: torch.Tensor, width: int,
                 height: int, n_blocks: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """((height, width) f32 grid, int32 count of masked candidates) of the
    candidate rows: row ``starts[i // bsz] + i % bsz`` of the table's
    ``xf``/``yf`` (and ``weight``) planes when block starts are given, else
    row i; with ``n_blocks`` only the first ``n_blocks`` slots' candidates
    (as in ``pip_refine``). The count is every masked candidate, in the
    grid's bbox or not (the reference's ``jnp.sum(m)``).

    The plain PyTorch version of the ``grid_scatter`` CUDA kernel: gather,
    snap, scatter-add. The CPU path, and the kernel's yardstick on the
    card."""
    if starts is not None:
        rows = block_rows(starts, bsz)
        xf, yf = xf.index_select(0, rows), yf.index_select(0, rows)
        if weight is not None:
            weight = weight.index_select(0, rows)
    mask = live_candidates(mask, xf.shape[0], n_blocks, bsz, xf.device)
    out = _grid_scatter(xf, yf, mask, weight, grid, width, height)
    return out, mask.sum(dtype=torch.int32)


# -- KNN distance + ordered top-m (plain version of topk_nearest.cu) --------

_EARTH_R_M = 6371008.8
# the reference's f32 constants of ``_haversine_f32``
HAVERSINE_RAD = float(np.float32(np.pi / 180.0))
HAVERSINE_TWO_R = float(np.float32(2 * _EARTH_R_M))


def haversine_f32(lon: torch.Tensor, lat: torch.Tensor,
                  q: torch.Tensor) -> torch.Tensor:
    """Great-circle metres in f32 from the f32 query point ``q`` = (qlon,
    qlat), the reference's ``_haversine_f32`` operation for operation (its
    ``/ 2`` a multiplication by 0.5, as XLA makes it)."""
    qlon, qlat = q[0], q[1]
    la1 = lat * HAVERSINE_RAD
    la2 = qlat * HAVERSINE_RAD
    dla = (qlat - lat) * HAVERSINE_RAD
    dlo = (qlon - lon) * HAVERSINE_RAD
    s1 = torch.sin(dla * 0.5)
    s2 = torch.sin(dlo * 0.5)
    a = s1 * s1 + torch.cos(la1) * torch.cos(la2) * (s2 * s2)
    return HAVERSINE_TWO_R * torch.asin(torch.sqrt(a.clamp(0.0, 1.0)))


def topk_nearest(xf: torch.Tensor, yf: torch.Tensor, mask: torch.Tensor,
                 qx: float, qy: float, m: int,
                 starts: Optional[torch.Tensor] = None,
                 bsz: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """((m,) f32 distances, (m,) int32 positions) of the m candidates
    nearest (qx, qy) (f32 values): ``haversine_f32`` of every candidate,
    +inf where ``mask`` is unset, ascending by (distance, candidate) — the
    order ``lax.top_k(-d, m)`` gives, equal distances (the +inf past the
    matches too) lower candidate first (≙ the reference's modes ``topk`` and
    ``topk_blocks``). Candidate i is row i, or with block ``starts`` row
    ``starts[i // bsz] + i % bsz``, and that row is its position.

    The plain PyTorch version of the ``topk_nearest`` CUDA kernel: the
    distances, then a stable sort. The CPU path, and the kernel's yardstick
    on the card."""
    rows = None
    if starts is not None:
        rows = block_rows(starts, bsz)
        xf, yf = xf.index_select(0, rows), yf.index_select(0, rows)
    q = torch.tensor([qx, qy], dtype=torch.float32, device=xf.device)
    d = torch.where(mask, haversine_f32(xf, yf, q),
                    torch.tensor(float("inf"), device=xf.device))
    order = torch.sort(d, stable=True).indices[:m]
    pos = order if rows is None else rows.index_select(0, order)
    return d.index_select(0, order), pos.to(torch.int32)


# -- batched box counts (plain version of kernels/csrc/box_count.cu) --------


def pack62(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Order-preserving int64 key of (hi, lo) int32 pairs: hi in the high
    word, lo with its sign bit flipped in the low word, so that keys compare
    as the reference's signed lexicographic ``_ge62``/``_le62`` for every
    int32 value (what the ``box_count`` kernel compares)."""
    return hi.to(torch.int64) * (1 << 32) + (lo.to(torch.int64) + (1 << 31))


def _keys_any(k: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor) -> torch.Tensor:
    """Rows whose key lies in any [lo[j], hi[j]] (an empty range, lo > hi,
    holds nothing), one pass a range."""
    out = torch.zeros_like(k, dtype=torch.bool)
    for j in range(lo.shape[0]):
        out |= (k >= lo[j]) & (k <= hi[j])
    return out


def box_count(cols, boxes: Optional[torch.Tensor],
              windows: Optional[torch.Tensor], resid: Optional[torch.Tensor],
              block_ids: Optional[torch.Tensor], bsz: Optional[int],
              per_box: bool, envelope: bool = False) -> torch.Tensor:
    """int32 counts of a table's candidates (≙ the reference's
    ``count_multi``/``count_multi_blocks`` and the any-box mask plus sum of
    ``count``/``count_blocks``). The candidates are the table's rows, or
    the rows of the padded ``block_ids`` (pad -1) through
    ``expand_blocks``' membership test; ``base`` = membership AND any of
    the (T, 4) ``windows`` AND the ``resid`` mask (one bool a candidate)
    AND the table's ``__valid__``. ``per_box``: one count per row of the
    (B, 8) fp62 ``boxes`` of ``base`` and that box (a (B,) tensor, one
    pass a box as the reference's ``lax.map``: the (N, B) matrix is never
    built); else a 0-d count of ``base`` and any box (of ``base`` alone
    without boxes). A row is in a box when its point is (``xi``/``xl``,
    ``yi``/``yl``), or with ``envelope`` when its envelope overlaps the box
    (the ``bbox_overlap`` primary of extent layers: ``bxmin`` <= qxhi,
    ``bxmax`` >= qxlo, ``bymin`` <= qyhi, ``bymax`` >= qylo on the fp62
    planes). Boxes and windows compare ``pack62`` keys, as the kernel does.

    The plain PyTorch version of the ``box_count`` CUDA kernel. The CPU
    path, and the kernel's yardstick on the card."""
    n = int(next(iter(cols.values())).shape[0])
    base, g = None, cols
    if block_ids is not None:
        base, _, _, g = expand_blocks(cols, block_ids, bsz, n)
    tmask = None
    if windows is not None:
        tmask = _keys_any(pack62(g["bin"], g["off"]),
                          pack62(windows[:, 0], windows[:, 1]),
                          pack62(windows[:, 2], windows[:, 3]))
    for m in (tmask, resid, g["__valid__"] if "__valid__" in g else None):
        if m is not None:
            base = m if base is None else base & m

    def count(m: torch.Tensor) -> torch.Tensor:
        return (m if base is None else m & base).sum(dtype=torch.int32)

    if boxes is not None:
        q = pack62(boxes[:, 0::2], boxes[:, 1::2])   # (B, 4) xlo xhi ylo yhi
        if envelope:
            x0, x1 = (pack62(g[f"bx{e}_i"], g[f"bx{e}_l"])
                      for e in ("min", "max"))
            y0, y1 = (pack62(g[f"by{e}_i"], g[f"by{e}_l"])
                      for e in ("min", "max"))
        else:
            x0 = x1 = pack62(g["xi"], g["xl"])
            y0 = y1 = pack62(g["yi"], g["yl"])

        def inside(b: int) -> torch.Tensor:
            return (x1 >= q[b, 0]) & (x0 <= q[b, 1]) \
                & (y1 >= q[b, 2]) & (y0 <= q[b, 3])

        if per_box:
            return torch.stack([count(inside(b))
                                for b in range(boxes.shape[0])])
        hit = torch.zeros_like(x0, dtype=torch.bool)
        for b in range(boxes.shape[0]):
            hit |= inside(b)
        return count(hit)
    if base is None:
        dev = next(iter(cols.values())).device
        return torch.tensor(n, dtype=torch.int32, device=dev)
    return base.sum(dtype=torch.int32)


# -- residual predicate compiler --------------------------------------------


class Unsupported(Exception):
    """Raised when a predicate subtree can't run on device."""


# attr type names whose device columns are exact representations
_EXACT_DEVICE_TYPES = {"Int", "Integer", "Boolean", "String", "Float"}


# the residual as a postfix program of int32 words, the form the fused_scan
# kernel evaluates: (op, slot, a, b) a word row; a stack of booleans
OP_TRUE, OP_FALSE, OP_AND, OP_OR, OP_NOT, OP_CMP, OP_IN = range(7)
# OP_CMP's a: the comparison; b: its constant's index in ``consts``.
# OP_IN's a: its constants' first index; b: their count
CMP_CODES = {"=": 0, "<>": 1, "<": 2, "<=": 3, ">": 4, ">=": 5}
# slot kinds: an int32 column (Int, Integer, String codes), an f32 column
# (Float, compared in f32) or a bool column (Boolean, compared as 0/1)
SLOT_I32, SLOT_F32, SLOT_BOOL = 0, 1, 2
# the kernel's stack is the bits of one 64-bit word
MAX_PROGRAM_DEPTH = 64


class ResidualProgram(NamedTuple):
    """A lowered residual: (L, 4) int32 ``words``, int32 ``consts`` (f32
    constants as their bits) and the column ``slots`` ((name, kind), ...)
    that the words' slot numbers index; ``depth`` is the stack's most."""
    words: np.ndarray
    consts: np.ndarray
    slots: tuple
    depth: int


class Residual(NamedTuple):
    """A compiled device residual: its structure ``key``, its constants
    ``params``, the torch closure ``fn(cols, params)`` and the same
    predicate as a ``program`` (None when it is deeper than
    ``MAX_PROGRAM_DEPTH``). A residual folded with the caller's
    authorizations (``fold_vis``) also carries the allowed visibility
    codes ``vis``; its ``fn`` tests them, its ``program`` does not (the
    fused scan tests them as a section of its own)."""
    key: str
    params: list
    fn: Optional[Callable]
    program: Optional[ResidualProgram]
    vis: Optional[np.ndarray] = None


# the program of a residual that is only a visibility test
_NO_PROGRAM = ResidualProgram(np.zeros((0, 4), np.int32),
                              np.zeros(0, np.int32), (), 0)


def fold_vis(residual: Optional[Residual], allowed) -> Residual:
    """``residual`` ANDed with the visibility test "the row's ``__vis__``
    code is one of ``allowed``" (≙ the reference's auths fold,
    ``geomesa_tpu/index/planner.py:283-296``): the key becomes
    ``vis{P}&(key)`` and the params gain the allowed codes padded to a
    power of two P with -1, as the reference's, so the structure keys of
    both packages agree; ``fn`` ANDs ``torch.isin`` on ``__vis__``;
    ``program`` stays the residual's own (empty without one) and ``vis``
    holds the allowed codes."""
    allowed = np.asarray(allowed, dtype=np.int32).reshape(-1)
    size = max(1, 1 << max(0, len(allowed) - 1).bit_length())
    padded = np.full(size, -1, dtype=np.int32)
    padded[: len(allowed)] = allowed
    if residual is None:
        key, params, fn, program = "none", [], None, _NO_PROGRAM
    else:
        key, params, fn, program = residual[:4]
    i = len(params)

    def fn2(cols, p, fn=fn, i=i):
        m = torch.isin(cols["__vis__"], p[i])
        return m if fn is None else m & fn(cols, p)

    return Residual(f"vis{size}&({key})", list(params) + [padded], fn2,
                    program, allowed)


def shared_vis(residuals) -> Optional[np.ndarray]:
    """The allowed visibility codes the ``residuals`` (of a query's
    branches, each a ``Residual`` or None) were folded with, or None when
    none was; raises Unsupported when they differ (one visibility test a
    query)."""
    vis = [getattr(r, "vis", None) for r in residuals]
    if any((v is None) != (vis[0] is None)
           or (v is not None and not np.array_equal(v, vis[0]))
           for v in vis):
        raise Unsupported("branches under different authorizations")
    return vis[0] if vis else None


def vis_member(codes: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Which ``codes`` have their bit set in the bitmap ``words`` (int32,
    bit c % 32 of word c // 32; a code past the bitmap is not in it): the
    ``vis`` section's test, in torch ops."""
    nbits = int(words.shape[0]) * 32
    c = codes.to(torch.int64)
    inside = (c >= 0) & (c < nbits)
    c = c.clamp(0, nbits - 1)
    bit = (words.to(torch.int64).index_select(0, c >> 5) >> (c & 31)) & 1
    return inside & (bit == 1)


def compile_residual(f: Optional[ir.Filter], sft,
                     string_vocabs: Dict[str, list],
                     available: Optional[set] = None) -> Residual:
    """IR → ``Residual(structure_key, params, fn(cols, params) -> bool
    mask, program)``.

    The structure keys are the reference's (``scan.compile_residual`` and
    ``compiled._lower_residual``): ``=``/``<>``/``<``/``<=``/``>``/``>=``
    on Int/Float/Boolean columns, ``=``/``<>`` and ``IN`` on String
    dictionary codes, ``IN`` on Int, and AND/OR/NOT over them. ``params`` is
    a list of numpy constants (int32, or f32 for Float columns) that the
    caller moves to the table's device; ``fn`` reads them by position. The
    same walk lowers the tree into a postfix ``ResidualProgram`` over the
    same constants (``eval_program`` is its plain interpreter, the
    ``fused_scan`` kernel runs it per candidate). Raises Unsupported for
    subtrees that must stay host-side, including predicates on attributes
    outside the device columns (``available``).
    """
    if f is None:
        return Residual("none", [], None, None)

    def check_available(attr: str) -> None:
        if available is not None and attr not in available:
            raise Unsupported(f"{attr} not in the device column group")

    params: list = []
    words: list = []
    consts: list = []
    slots: Dict[str, tuple] = {}
    depth = [0, 0]   # now, most

    def const(v, dtype) -> int:
        params.append(np.asarray(v, dtype=dtype))
        return len(params) - 1

    def emit(op: int, slot: int = 0, a: int = 0, b: int = 0) -> None:
        words.append((op, slot, a, b))
        depth[0] += {OP_AND: -1, OP_OR: -1, OP_NOT: 0}.get(op, 1)
        depth[1] = max(depth[1], depth[0])

    def slot_of(attr) -> int:
        kind = SLOT_F32 if attr.type_name == "Float" else \
            SLOT_BOOL if attr.type_name == "Boolean" else SLOT_I32
        return slots.setdefault(attr.name, (len(slots), kind))[0]

    def leaf(op: int, attr, cmp: int, i: int) -> None:
        """A leaf's word over constant ``params[i]``."""
        at = len(consts)
        consts.extend(params[i].reshape(-1).view(np.int32).tolist())
        if op == OP_CMP:
            emit(OP_CMP, slot_of(attr), cmp, at)
        else:
            emit(OP_IN, slot_of(attr), at, len(consts) - at)

    def walk(node: ir.Filter) -> Tuple[str, Callable]:
        if isinstance(node, ir.Include):
            emit(OP_TRUE)
            return "inc", lambda cols, p: torch.ones_like(
                next(iter(cols.values())), dtype=torch.bool)
        if isinstance(node, ir.Exclude):
            emit(OP_FALSE)
            return "exc", lambda cols, p: torch.zeros_like(
                next(iter(cols.values())), dtype=torch.bool)
        if isinstance(node, (ir.And, ir.Or)):
            op = OP_AND if isinstance(node, ir.And) else OP_OR
            keys, fns = [], []
            for j, c in enumerate(node.children):
                k, g = walk(c)
                keys.append(k)
                fns.append(g)
                if j:
                    emit(op)
            red = torch.logical_and if op == OP_AND else torch.logical_or
            name = "and(" if op == OP_AND else "or("
            return name + ",".join(keys) + ")", \
                lambda cols, p, fns=tuple(fns), red=red: functools.reduce(
                    red, [g(cols, p) for g in fns])
        if isinstance(node, ir.Not):
            k, g = walk(node.child)
            emit(OP_NOT)
            return f"not({k})", lambda cols, p, g=g: ~g(cols, p)
        if isinstance(node, ir.Cmp):
            check_available(node.attr)
            attr = sft.attribute(node.attr)
            if attr.type_name == "String":
                if node.op not in ("=", "<>"):
                    raise Unsupported("ordered string cmp on device")
                vocab = string_vocabs.get(node.attr)
                if vocab is None:
                    raise Unsupported("no vocab")
                try:
                    code = vocab.index(node.value)
                except ValueError:
                    code = -1  # matches nothing
                i = const(code, np.int32)
                leaf(OP_CMP, attr, CMP_CODES[node.op], i)
                if node.op == "=":
                    return f"seq:{node.attr}", \
                        lambda cols, p, i=i, a=node.attr: cols[a] == p[i]
                return f"sne:{node.attr}", \
                    lambda cols, p, i=i, a=node.attr: cols[a] != p[i]
            if attr.type_name not in _EXACT_DEVICE_TYPES:
                raise Unsupported(f"{attr.type_name} cmp is inexact on device")
            dtype = np.float32 if attr.type_name == "Float" else np.int32
            i = const(node.value, dtype)
            op = node.op
            leaf(OP_CMP, attr, CMP_CODES[op], i)
            cmp = {"=": torch.eq, "<>": torch.ne, "<": torch.lt,
                   "<=": torch.le, ">": torch.gt, ">=": torch.ge}[op]
            return f"cmp{op}:{node.attr}", \
                lambda cols, p, i=i, a=node.attr, cmp=cmp: cmp(cols[a], p[i])
        if isinstance(node, ir.In):
            check_available(node.attr)
            attr = sft.attribute(node.attr)
            if attr.type_name == "String":
                vocab = string_vocabs.get(node.attr)
                if vocab is None:
                    raise Unsupported("no vocab")
                codes = [vocab.index(v) for v in node.values if v in vocab] or [-1]
            elif attr.type_name in ("Int", "Integer"):
                codes = [int(v) for v in node.values]
            else:
                raise Unsupported("IN on non-int/string")
            # pow2-padded like the reference, so the keys agree
            size = max(1, 1 << (len(codes) - 1).bit_length())
            padded = codes + [codes[-1]] * (size - len(codes))
            i = const(padded, np.int32)
            leaf(OP_IN, attr, 0, i)
            return f"in{size}:{node.attr}", \
                lambda cols, p, i=i, a=node.attr: torch.isin(cols[a], p[i])
        if isinstance(node, ir.During):
            # exact (bin, off) windows carry the primary dtg
            raise Unsupported("During handled by primary time windows")
        raise Unsupported(type(node).__name__)

    key, fn = walk(f)
    program = None
    if depth[1] <= MAX_PROGRAM_DEPTH:
        program = ResidualProgram(
            np.asarray(words, dtype=np.int32).reshape(-1, 4),
            np.asarray(consts, dtype=np.int32),
            tuple((name, kind) for name, (_, kind) in slots.items()),
            depth[1])
    return Residual(key, params, fn, program)


_CMP_FNS = (torch.eq, torch.ne, torch.lt, torch.le, torch.gt, torch.ge)


def eval_program(cols, words: np.ndarray, consts: torch.Tensor,
                 slots: tuple, n: int) -> torch.Tensor:
    """The (n,) bool mask of a postfix residual program over ``cols`` (a
    mapping of the ``slots``' column names to their n candidate rows):
    the plain interpreter of the ``fused_scan`` kernel's. ``consts`` is the
    int32 constant vector on the columns' device; an f32 slot compares
    with its constant's bits read as f32, a bool slot as 0/1."""
    dev = consts.device
    stack = []
    for op, slot, a, b in words.tolist():
        if op in (OP_TRUE, OP_FALSE):
            stack.append(torch.full((n,), op == OP_TRUE, dtype=torch.bool,
                                    device=dev))
        elif op in (OP_AND, OP_OR):
            y, x = stack.pop(), stack.pop()
            stack.append(x & y if op == OP_AND else x | y)
        elif op == OP_NOT:
            stack.append(~stack.pop())
        else:
            name, kind = slots[slot]
            c = cols[name]
            if kind == SLOT_BOOL:
                c = c.to(torch.int32)
            if op == OP_CMP:
                v = consts[b: b + 1]
                if kind == SLOT_F32:
                    v = v.view(torch.float32)
                stack.append(_CMP_FNS[a](c, v[0]))
            elif op == OP_IN:
                stack.append(torch.isin(c, consts[a: a + b]))
            else:
                raise ValueError(f"opcode {op}")
    (m,) = stack
    return m


def split_residual(f: Optional[ir.Filter], sft, string_vocabs,
                   available: Optional[set] = None):
    """Split a residual filter into (device_part, host_part): AND trees split
    per child; any child the device compiler rejects stays on the host."""
    if f is None or isinstance(f, ir.Include):
        return None, None
    children = f.children if isinstance(f, ir.And) else (f,)
    dev, host = [], []
    for c in children:
        try:
            compile_residual(c, sft, string_vocabs, available)
            dev.append(c)
        except Unsupported:
            host.append(c)
    return (
        ir.and_filters(dev) if dev else None,
        ir.and_filters(host) if host else None,
    )


# -- padding helpers --------------------------------------------------------

_I31MAX = (1 << 31) - 1
# fp62 empty box: lo bound = +max, hi bound = 0 — matches nothing
EMPTY_BOX = np.array([_I31MAX, _I31MAX, 0, 0, _I31MAX, _I31MAX, 0, 0], dtype=np.int32)
EMPTY_WINDOW = np.array([1, 0, 0, 0], dtype=np.int32)    # bin_lo > bin_hi


def pad_boxes(boxes: np.ndarray, min_size: int = 1) -> np.ndarray:
    """Pad (B,8) int32 fp62 box array to the next power-of-two count."""
    b = max(min_size, len(boxes))
    size = 1 << (b - 1).bit_length()
    out = np.tile(EMPTY_BOX, (size, 1))
    if len(boxes):
        out[: len(boxes)] = boxes
    return out


def pad_windows(windows: np.ndarray, min_size: int = 1) -> np.ndarray:
    b = max(min_size, len(windows))
    size = 1 << (b - 1).bit_length()
    out = np.tile(EMPTY_WINDOW, (size, 1))
    if len(windows):
        out[: len(windows)] = windows
    return out


# -- the staged scan path ----------------------------------------------------


def _mask_kernel(primary_kind: str, has_time: bool):
    """The staged mask fn of one structural signature, as torch ops: the
    primary (exact fp62 point boxes or envelope overlap, or none), AND the
    time windows, AND the device residual; all rows when nothing
    constrains the scan; AND the table's ``__valid__`` (≙ the reference's
    ``_mask_kernel``). The route of the stages ``staged_query`` declines."""
    if primary_kind != "none" and primary_kind not in PRIMARY_FNS:
        raise ValueError(f"primary kind {primary_kind}")

    def mask(cols, boxes, windows, rparams, residual_fn):
        m = None
        if primary_kind != "none":
            m = PRIMARY_FNS[primary_kind](cols, boxes)
        if has_time:
            tm = _time_mask(cols, windows)
            m = tm if m is None else (m & tm)
        if residual_fn is not None:
            rm = residual_fn(cols, rparams)
            m = rm if m is None else (m & rm)
        if m is None:
            r = next(iter(cols.values()))
            m = torch.ones(r.shape[0], dtype=torch.bool, device=r.device)
        if "__valid__" in cols:
            m = m & cols["__valid__"]
        return m

    return mask


class _Gather:
    """Dict-like view of the candidate rows of each column, read on first
    access, so a pruned scan touches only the columns its mask needs
    (≙ the reference's ``_LazyBlockGather``)."""

    def __init__(self, cols, rows: torch.Tensor):
        self._cols = cols
        self._rows = rows
        self._cache = {}

    def __getitem__(self, k: str) -> torch.Tensor:
        if k not in self._cache:
            self._cache[k] = self._cols[k].index_select(0, self._rows)
        return self._cache[k]

    def __contains__(self, k: str) -> bool:
        return k in self._cols

    def values(self):
        # row-count probes (Include/Exclude) only need a length and device
        yield self._rows


def expand_blocks(cols, block_ids: torch.Tensor, bsz: int, n: int):
    """Block ids (pad = -1) → (membership mask, row ids, clamped starts,
    lazy gather). A start past ``n - bsz`` clamps, so the last partial block
    re-reads a suffix of the previous one; the membership test (the row
    belongs to ITS intended block) masks those re-reads and the pad blocks
    without double counts. Candidate i is row ``astart[i // bsz] + i % bsz``.
    The one home of this logic: the fused program's pruned branch and every
    staged block mode go through it."""
    starts = block_ids.to(torch.int64) * bsz
    astart = starts.clamp(0, max(0, n - bsz))
    rows = astart[:, None] + torch.arange(bsz, device=block_ids.device)[None, :]
    valid = ((block_ids >= 0)[:, None]
             & (rows >= starts[:, None])
             & (rows < starts[:, None] + bsz)).reshape(-1)
    rows = rows.reshape(-1)
    return valid, rows, astart, _Gather(cols, rows)


def run_members(ids: torch.Tensor, runs: torch.Tensor, rows: torch.Tensor,
                bsz: int) -> torch.Tensor:
    """The candidates of run pieces (``expand_blocks``' rows of block
    ``ids``) that lie in their slot's ``runs`` [lo, hi); pads (id -1) have
    none."""
    lo = runs[:, 0].to(torch.int64).repeat_interleave(bsz)
    hi = runs[:, 1].to(torch.int64).repeat_interleave(bsz)
    return (ids >= 0).repeat_interleave(bsz) & (rows >= lo) & (rows < hi)


def run_pieces(runs, n: int, bsz: int):
    """(ids int32, bounds int32 (P, 2)) of sorted disjoint runs [lo, hi) of
    rows cut at every ``bsz``-row block boundary: piece k is block ids[k]
    with its rows bounds[k] (one piece a block a run touches)."""
    r = np.asarray(runs, dtype=np.int64).reshape(-1, 2)
    r = r[r[:, 1] > r[:, 0]]
    if len(r) == 0:
        return np.empty(0, np.int32), np.empty((0, 2), np.int32)
    first = r[:, 0] // bsz
    count = (r[:, 1] - 1) // bsz - first + 1
    k = np.repeat(np.arange(len(r)), count)
    ids = first[k] + (np.arange(len(k)) - np.repeat(np.cumsum(count) - count,
                                                    count))
    lo = np.maximum(r[k, 0], ids * bsz)
    hi = np.minimum(r[k, 1], (ids + 1) * bsz)
    return ids.astype(np.int32), np.stack([lo, hi], axis=1).astype(np.int32)


# -- the fused scan (plain versions of kernels/csrc/block_gate.cu,
#    fused_scan.cu and ordered_compact.cu) ------------------------------------


def _pack62_np(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """``pack62`` of int32 numpy planes."""
    return hi.astype(np.int64) * (1 << 32) + (lo.astype(np.int64) + (1 << 31))


class FusedQuery:
    """The constants of one fused program, packed into one byte buffer that
    goes to the device in one upload and that the kernels (and their plain
    versions) read in place. ``branches`` are (boxes (B, 8) int32 fp62,
    gate (B, 4) f32 [xmin, ymin, xmax, ymax], windows (T, 4) int32 or None,
    ``ResidualProgram`` or None); a row matches when any branch's boxes,
    windows and program all hold. A branch whose boxes (and gate) are None
    has no spatial test (a staged scan without a primary): every row is in
    its boxes, and no gate box keeps a block alive for it (the staged scans
    that use it take no gate). ``points`` is False when no branch has
    boxes: the scan then reads no point plane. Sections, each 16-byte
    aligned:

    - ``br``: one int32 row a branch, [box0, nbox, win0, nwin, prog0,
      nprog, boxless, 0] (first rows and counts in the sections below;
      ``boxless`` 1 for a branch without a spatial test);
    - ``box``: int64 (ΣB, 4) keys [xlo, xhi, ylo, yhi] (``pack62``);
    - ``gate``: f32 (ΣB, 4);
    - ``wkey``: int64 (ΣT, 2) keys [lo, hi]; ``wbin``: int32 (ΣT, 2)
      [bin_lo, bin_hi] (the block gate's);
    - ``prog``: int32 (ΣL, 4) program words, slots numbered in ``slots``
      (shared by the branches), constant indices into ``const``;
    - ``const``: int32 (ΣC,);
    - ``vis``: with ``vis`` (the allowed visibility codes of the caller's
      authorizations), a bitmap over the codes, bit c % 32 of int32 word
      c // 32, as long as the largest allowed code needs: a row matches
      only when its ``__vis__`` code's bit is set (≙ the reference's
      ``vis`` section, ``geomesa_tpu/index/compiled.py:482-485``, one test
      for the whole query however many branches it has).

    ``slots`` lists the residual columns ((name, kind), ...). With ``env``
    the rows are an extent layer's envelopes: a row is in a box when its
    envelope overlaps it (the fp62 envelope planes' keys against the same
    box keys; ``fused_scan``'s ENV form)."""

    def __init__(self, branches, vis=None, env: bool = False):
        secs: Dict[str, list] = {k: [] for k in
                                 ("br", "box", "gate", "wkey", "wbin",
                                  "prog", "const", "vis")}
        self.vis = vis is not None
        self.env = bool(env)
        if self.vis:
            codes = np.asarray(vis, dtype=np.int64).reshape(-1)
            codes = codes[codes >= 0]
            nbits = int(codes.max()) + 1 if len(codes) else 1
            words = np.zeros(-(-nbits // 32), dtype=np.uint32)
            np.bitwise_or.at(words, codes >> 5,
                             np.left_shift(1, codes & 31).astype(np.uint32))
            secs["vis"].append(words.view(np.int32))
        slots: Dict[str, tuple] = {}
        nbox = nwin = nprog = ncon = 0
        self.branches = []
        self.boxless = []
        for boxes, gate, windows, prog in branches:
            boxless = boxes is None
            boxes = np.zeros((0, 8), np.int32) if boxless \
                else np.asarray(boxes, dtype=np.int32).reshape(-1, 8)
            B, T = len(boxes), 0 if windows is None else len(windows)
            secs["box"].append(np.stack([
                _pack62_np(boxes[:, 2 * j], boxes[:, 2 * j + 1])
                for j in range(4)], axis=1))
            secs["gate"].append(np.zeros((0, 4), np.float32) if gate is None
                                else np.asarray(gate, dtype=np.float32))
            if T:
                w = np.asarray(windows, dtype=np.int32)
                secs["wkey"].append(np.stack([_pack62_np(w[:, 0], w[:, 1]),
                                              _pack62_np(w[:, 2], w[:, 3])],
                                             axis=1))
                secs["wbin"].append(w[:, [0, 2]])
            L = 0
            if prog is not None:
                words = prog.words.copy()
                for j, (name, kind) in enumerate(prog.slots):
                    g = slots.setdefault(name, (len(slots), kind))
                    if g[1] != kind:
                        raise Unsupported(f"column {name} read as two kinds")
                    words[prog.words[:, 1] == j, 1] = g[0]
                cmp = words[:, 0] == OP_CMP
                words[cmp, 3] += ncon
                words[words[:, 0] == OP_IN, 2] += ncon
                L = len(words)
                secs["prog"].append(words)
                secs["const"].append(prog.consts)
                ncon += len(prog.consts)
            rec = (nbox, B, nwin, T, nprog, L)
            self.branches.append(rec)
            self.boxless.append(boxless)
            secs["br"].append(np.array([*rec, int(boxless), 0],
                                       dtype=np.int32))
            nbox, nwin, nprog = nbox + B, nwin + T, nprog + L
        self.slots = tuple((name, kind) for name, (_, kind) in slots.items())
        self.has_time = nwin > 0
        self.points = not all(self.boxless)
        parts, off = [], 0
        self.offsets: Dict[str, Tuple[int, int]] = {}   # name -> (at, bytes)
        for k, v in secs.items():
            raw = np.concatenate([np.ascontiguousarray(x).reshape(-1)
                                  for x in v]).view(np.uint8) if v \
                else np.zeros(0, np.uint8)
            self.offsets[k] = (off, len(raw))
            pad = -len(raw) % 16
            parts += [raw, np.zeros(pad, np.uint8)]
            off += len(raw) + pad
        self.packed = np.concatenate(parts) if off else np.zeros(16, np.uint8)
        self.words = (np.concatenate(secs["prog"]) if secs["prog"]
                      else np.zeros((0, 4), np.int32))

    def section(self, buf: torch.Tensor, name: str, dtype: torch.dtype,
                cols: int) -> torch.Tensor:
        """Section ``name`` of the device copy ``buf`` as (rows, cols)
        ``dtype`` (a view, no copy)."""
        at, size = self.offsets[name]
        return buf[at: at + size].view(dtype).reshape(-1, cols)


def _ordered(flags: torch.Tensor, cap: int, values: torch.Tensor,
             fill: int) -> torch.Tensor:
    """The ``values`` at the set ``flags``, in order, in a ``cap``-long
    int32 vector padded with ``fill`` (≙ ``jnp.nonzero(size=cap,
    fill_value=...)`` mapped through ``values``): ranks by a cumulative
    sum, and a scatter that sends every flag past the cap to a dropped
    slot, so no length is read back."""
    pos = torch.cumsum(flags, 0) - 1
    idx = torch.where(flags & (pos < cap), pos, torch.full_like(pos, cap))
    out = torch.full((cap + 1,), fill, dtype=torch.int32, device=flags.device)
    out.scatter_(0, idx, values.to(torch.int32))
    return out[:cap]


def block_gate(summ: dict, qbuf: torch.Tensor, query: FusedQuery, n: int,
               bsz: int):
    """(ids, starts, n_blocks) of the gather blocks that the query's gates
    can touch (≙ the gate of the reference's ``_jit_program``, the OR of
    gates of its ``_jit_union_program``, and ``jnp.nonzero(alive, size,
    fill_value=-1)``): ``ids`` int32 (nb,) the ascending alive block ids
    padded with -1, ``starts`` int64 (nb,) their clamped first rows
    (``expand_blocks``' clamp; 0 in the pad), ``n_blocks`` int32 (1,) how
    many are alive. A block is alive when, for some branch, any gate
    envelope meets its slack-widened coordinate envelope and (when the
    branch has windows and the table bins) any window's bin range meets
    its bin range.

    The plain PyTorch version of the ``block_gate`` CUDA kernel. The CPU
    path, and the kernel's yardstick on the card."""
    gates = query.section(qbuf, "gate", torch.float32, 4)
    wbin = query.section(qbuf, "wbin", torch.int32, 2)
    nb = int(summ["bxmin"].shape[0])
    alive = torch.zeros(nb, dtype=torch.bool, device=qbuf.device)
    for b0, B, w0, T, _, _ in query.branches:
        g = gates[b0: b0 + B]
        a = ((summ["bxmax"][:, None] >= g[None, :, 0])
             & (summ["bxmin"][:, None] <= g[None, :, 2])
             & (summ["bymax"][:, None] >= g[None, :, 1])
             & (summ["bymin"][:, None] <= g[None, :, 3])).any(dim=1)
        if T and "binmin" in summ:
            blo, bhi = wbin[w0: w0 + T, 0], wbin[w0: w0 + T, 1]
            a = a & ((blo <= bhi)[None, :]
                     & (summ["binmin"][:, None] <= bhi[None, :])
                     & (summ["binmax"][:, None] >= blo[None, :])).any(dim=1)
        alive |= a
    ids = _ordered(alive, nb, torch.arange(nb, device=alive.device), -1)
    starts = torch.where(ids >= 0, (ids.to(torch.int64) * bsz).clamp(
        0, max(0, n - bsz)), torch.zeros_like(ids, dtype=torch.int64))
    return ids, starts, alive.sum(dtype=torch.int32).reshape(1)


def _keys_in(k: torch.Tensor, lo: torch.Tensor,
             hi: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(k, dtype=torch.bool)
    for j in range(lo.shape[0]):
        out |= (k >= lo[j]) & (k <= hi[j])
    return out


def fused_scan(cols, qbuf: torch.Tensor, query: FusedQuery, ids: torch.Tensor,
               n_blocks: torch.Tensor, bsz: int, mode: str,
               runs: Optional[torch.Tensor] = None):
    """The fused program's scan over the candidates of a block list (≙
    ``mask_of`` and ``gathered()`` of the reference's ``_jit_program`` and
    ``_jit_union_program``, and their ``jnp.sum``; ``select``'s
    ``nonzero`` is ``ordered_compact`` of the mask). Candidate i is row ``clamp(ids[i // bsz] * bsz) + i %
    bsz``, read in place; it matches when it is a member of its block
    (``expand_blocks``' rule) among the first ``n_blocks`` slots, the
    table's ``__valid__`` holds, its ``__vis__`` code is in the query's
    ``vis`` bitmap (when it has one), and for some
    branch of ``query`` its point lies in any box (always, in a branch
    without boxes), its (bin, off) in any window, and its residual program
    holds (boxes and windows compare ``pack62`` keys). By ``mode``:

    - ``count``: int32 (1,) matches;
    - ``mask``: (bool (slots * bsz,) match per candidate, int32 (1,)).

    With ``query.env`` (the ENV form) the table's rows are envelopes, and a
    row is in a box when its envelope overlaps it (``bbox_overlap``'s test
    on ``pack62`` keys: bxmin <= qxhi, bxmax >= qxlo, bymin <= qyhi, bymax
    >= qylo).

    With ``runs`` (int32 (slots, 2), the RUNS form: the attribute index's
    staged ``count_at`` and ``select_at``, ≙ ``geomesa_tpu/index/scan.py
    :603-619``) a candidate is a member when its row lies in its slot's
    ``[lo, hi)`` (a piece of one of the plan's runs of sorted positions)
    instead of in its block.

    The plain PyTorch version of the ``fused_scan`` CUDA kernel. The CPU
    path, and the kernel's yardstick on the card. It evaluates the
    predicates over the whole table and then takes each candidate's flag:
    without reading ``n_blocks`` back it cannot size the work to the alive
    blocks, so on the CPU a query scans every row whatever the gate
    keeps."""
    n = int(cols["bxmin_i" if query.env else "xi"].shape[0])
    member, rows, _, _ = expand_blocks(cols, ids, bsz, n)
    if runs is not None:
        member = run_members(ids, runs, rows, bsz)
    live = torch.arange(ids.shape[0], device=ids.device) \
        < n_blocks.to(torch.int64)
    member &= live.repeat_interleave(bsz)
    boxes = query.section(qbuf, "box", torch.int64, 4)
    wkey = query.section(qbuf, "wkey", torch.int64, 2)
    consts = query.section(qbuf, "const", torch.int32, 1).reshape(-1)
    # the predicates over the table's rows in place; each candidate then
    # takes its row's flag
    if query.points and query.env:
        x = pack62(cols["bxmin_i"], cols["bxmin_l"])
        y = pack62(cols["bymin_i"], cols["bymin_l"])
        x1 = pack62(cols["bxmax_i"], cols["bxmax_l"])
        y1 = pack62(cols["bymax_i"], cols["bymax_l"])
    elif query.points:
        x = x1 = pack62(cols["xi"], cols["xl"])
        y = y1 = pack62(cols["yi"], cols["yl"])
    t = pack62(cols["bin"], cols["off"]) if query.has_time else None
    m = None
    for (b0, B, w0, T, p0, L), boxless in zip(query.branches,
                                              query.boxless):
        q = boxes[b0: b0 + B]
        bm = torch.full((n,), boxless, dtype=torch.bool,
                        device=qbuf.device)
        for j in range(B):
            bm |= ((x1 >= q[j, 0]) & (x <= q[j, 1])
                   & (y1 >= q[j, 2]) & (y <= q[j, 3]))
        if T:
            bm &= _keys_in(t, wkey[w0: w0 + T, 0], wkey[w0: w0 + T, 1])
        if L:
            bm &= eval_program(cols, query.words[p0: p0 + L], consts,
                               query.slots, n)
        m = bm if m is None else m | bm
    if "__valid__" in cols:
        m = m & cols["__valid__"]
    if query.vis:
        m = m & vis_member(cols["__vis__"],
                           query.section(qbuf, "vis", torch.int32, 1)
                           .reshape(-1))
    m = m.index_select(0, rows) & member
    count = m.sum(dtype=torch.int32).reshape(1)
    if mode == "count":
        return count
    if mode == "mask":
        return m, count
    raise ValueError(f"fused_scan mode {mode}")


def ordered_compact(mask: torch.Tensor, cap: int, fill: int,
                    starts: Optional[torch.Tensor] = None,
                    bsz: Optional[int] = None,
                    n_blocks: Optional[torch.Tensor] = None):
    """(int32 (1,) count, int32 (cap,) rows) of a candidate mask: the rows
    of the set candidates in ascending candidate order, the first ``cap``
    of them, padded with ``fill`` (≙ ``jnp.nonzero(size=cap,
    fill_value=...)`` with the reference's ``rowids`` mapping). Candidate i
    is row ``starts[i // bsz] + i % bsz`` when block starts are given, else
    row i; with ``n_blocks`` (int32 (1,) on the device) only the
    candidates of the first ``n_blocks`` slots count. The count is every
    set candidate, past the cap too.

    The plain PyTorch version of the ``ordered_compact`` CUDA kernel. The
    CPU path, and the kernel's yardstick on the card."""
    m = mask
    rows = None
    if starts is not None:
        rows = block_rows(starts, bsz)
        if n_blocks is not None:
            m = m & (torch.arange(m.shape[0], device=m.device)
                     < n_blocks.to(torch.int64) * bsz)
    else:
        rows = torch.arange(m.shape[0], device=m.device)
    return (m.sum(dtype=torch.int32).reshape(1),
            _ordered(m, cap, rows, fill))


def staged_query(cols, stages) -> Optional[FusedQuery]:
    """The packed query of staged scans over a point layer's or an extent
    layer's ``cols``, one ``FusedQuery`` branch a stage ``(primary_kind,
    boxes, windows, residual)`` (a row matches when any stage holds), or
    None when the stages take the torch ops (``_mask_kernel``): the table
    has neither point nor envelope planes, a stage's primary is not the
    table's (``point_boxes`` on points, ``bbox_overlap`` on envelopes —
    the query's ``env``, ``fused_scan``'s ENV form), a residual has no
    program (deeper than ``MAX_PROGRAM_DEPTH``), or the residuals read more
    columns than ``fused_scan.MAX_SLOTS`` or pack past
    ``compiled.QUERY_MAX_BYTES`` — the fused program's declines. Primary
    ``"none"`` is a branch without boxes (every row is in; a query of such
    branches alone reads no spatial plane). The gate section, which only
    ``block_gate`` reads, is zeros. Residuals folded with authorizations
    (``fold_vis``) give the query its ``vis`` section; stages whose allowed
    codes differ take the torch ops."""
    from geomesa_tpu_torch.index.compiled import QUERY_MAX_BYTES
    from geomesa_tpu_torch.kernels.fused_scan import MAX_SLOTS
    env = "xi" not in cols
    if env and "bxmin_i" not in cols:
        return None
    try:
        vis = shared_vis([st[3] for st in stages])
    except Unsupported:
        return None
    if vis is not None and "__vis__" not in cols:
        return None
    branches = []
    for primary_kind, boxes, windows, residual in stages:
        if primary_kind == "none":
            boxes = None
        elif primary_kind != ("bbox_overlap" if env else "point_boxes"):
            if primary_kind in PRIMARY_FNS:
                return None
            raise ValueError(f"primary kind {primary_kind}")
        prog = None
        if residual is not None and residual[2] is not None:
            prog = getattr(residual, "program", None)
            if prog is None:
                return None
        gate = None
        if boxes is not None:
            boxes = np.asarray(boxes, dtype=np.int32).reshape(-1, 8)
            gate = np.zeros((len(boxes), 4), np.float32)
        branches.append((boxes, gate, windows, prog))
    try:
        query = FusedQuery(branches, vis, env)
    except Unsupported:       # one column read as two kinds
        return None
    if len(query.slots) > MAX_SLOTS or len(query.packed) > QUERY_MAX_BYTES:
        return None
    return query


class _Scan(NamedTuple):
    """A staged scan on the kernel route: the packed query, its device
    copy, and the candidate space — int32 block ``ids`` (pad -1), their
    int64 clamped first rows ``starts`` (0 in the pad), the int32 (1,)
    device count of live blocks ``n_blocks``, the block size ``bsz``."""
    query: FusedQuery
    qbuf: torch.Tensor
    ids: torch.Tensor
    starts: torch.Tensor
    n_blocks: torch.Tensor
    bsz: int


class ScanKernels:
    """The staged scan modes over one index's device table (≙ the
    reference's ``ScanKernels``): ``count``, ``mask``, ``count_blocks``,
    ``counts_multi``, ``counts_multi_blocks``, ``select_blocks``,
    ``select`` (the packed select), ``density_compact`` and
    ``density_blocks``, each with the reference's arguments — a primary
    kind, pow2-padded fp62 boxes, pow2-padded time windows and the compiled
    residual — and the OR of several such stages (``union_count``,
    ``union_mask``).

    PyTorch runs eagerly, so nothing is compiled or cached per signature:
    the ``prepare_*`` methods stage the query constants on the table's
    device once and return zero-arg dispatchers whose results stay on the
    device (the reference's prepared-statement pattern); the blocking
    methods read results back.

    A point layer's stage runs on the ``fused_scan`` kernel
    (``staged_query`` packs the stages into one buffer, uploaded once a
    prepare), which reads a candidate space of gather blocks in place:
    every block of the table (``GEOMESA_TPU_PRUNE_BLOCK`` rows, ids
    ``arange(ceil(n / bsz))``) in the full-table modes, the host cover's
    padded blocks in the block modes. Candidate i is row ``clamp(ids[i //
    bsz] * bsz) + i % bsz``; the last partial block re-reads a suffix of
    the block before it, and membership masks the re-reads. The selects
    compact that mask with ``ordered_compact`` and the densities scatter it
    with ``grid_scatter``, both through the blocks' starts; a count with a
    residual is ``fused_scan``'s count, one without is ``box_count``'s,
    and per-box counts are ``box_count``'s behind ``fused_scan``'s mask of
    the residual alone; an OR of stages is one K-branch ``fused_scan``. The stages
    ``staged_query`` declines keep the torch ops (``_mask_kernel`` over
    ``expand_blocks``' gather), and their counts ``box_count`` behind a
    torch residual mask."""

    def __init__(self, device_cols: Dict[str, torch.Tensor]):
        self.cols = device_cols
        first = next(iter(device_cols.values()))
        self.n = int(first.shape[0])
        self.device = first.device
        self._tables: Dict[int, tuple] = {}   # bsz -> the table's blocks

    def _dev(self, a) -> Optional[torch.Tensor]:
        return _dev(a, self.device)

    def _pad_blocks(self, blocks: np.ndarray) -> np.ndarray:
        nb = max(8, 1 << max(0, (len(blocks) - 1)).bit_length())
        out = np.full(nb, -1, dtype=np.int32)
        out[: len(blocks)] = blocks
        return out

    # the kernel route -------------------------------------------------------

    def _space(self, ids: np.ndarray, live: int, bsz: int) -> tuple:
        """(ids, starts, n_blocks) of a block list, on the device."""
        starts = np.where(ids >= 0, np.clip(ids.astype(np.int64) * bsz, 0,
                                            max(0, self.n - bsz)), 0)
        return (self._dev(ids.astype(np.int32)), self._dev(starts),
                self._dev(np.array([live], dtype=np.int32)))

    def _scan(self, stages, blocks: Optional[np.ndarray] = None,
              block_size: Optional[int] = None) -> Optional[_Scan]:
        """The kernel route of ``stages`` over the table's blocks, or over
        the padded host cover ``blocks`` of ``block_size`` rows; None when
        the stages keep the torch ops (``staged_query``, or a table without
        rows). A cover's block may not be larger than the table."""
        if blocks is not None and block_size > self.n:
            raise ValueError(f"blocks of {block_size} rows over a table of "
                             f"{self.n}")
        if self.n == 0:
            return None
        query = staged_query(self.cols, stages)
        if query is None:
            return None
        if blocks is None:
            bsz = min(int(_prune.BLOCK_SIZE), self.n)
            space = self._tables.get(bsz)
            if space is None:
                nb = -(-self.n // bsz)
                space = self._tables[bsz] = self._space(
                    np.arange(nb, dtype=np.int32), nb, bsz)
        else:
            bsz = int(block_size)
            space = self._space(self._pad_blocks(blocks), len(blocks), bsz)
        return _Scan(query, self._dev(query.packed), *space, bsz)

    def _kernel_mask(self, sc: _Scan) -> torch.Tensor:
        """The candidate mask of a kernel-route scan (one launch)."""
        from geomesa_tpu_torch.kernels.fused_scan import fused_scan
        return fused_scan(self.cols, sc.qbuf, sc.query, sc.ids, sc.n_blocks,
                          sc.bsz, "mask")[0]

    def _kernel_count(self, sc: _Scan) -> torch.Tensor:
        """The 0-d int32 count of a kernel-route scan (one launch)."""
        from geomesa_tpu_torch.kernels.fused_scan import fused_scan
        return fused_scan(self.cols, sc.qbuf, sc.query, sc.ids, sc.n_blocks,
                          sc.bsz, "count").reshape(())

    def _row_mask(self, m: torch.Tensor, bsz: int) -> torch.Tensor:
        """The (n,) row mask of a candidate mask over every block of the
        table: the last block's re-read rows taken out by one ``torch.cat``
        of two views (none when ``bsz`` divides n)."""
        reread = m.shape[0] - self.n
        if reread == 0:
            return m
        cut = m.shape[0] - bsz
        return torch.cat([m[:cut], m[cut + reread:]])

    def _candidates(self, stages, blocks: Optional[np.ndarray] = None,
                    block_size: Optional[int] = None):
        """Zero-arg dispatcher → (candidate mask, starts, n_blocks, bsz) of
        ``stages`` over the table, or over the padded cover ``blocks``: the
        kernel route's, or the torch ops' (the row mask with starts,
        n_blocks and bsz None over the table; over a cover the gathered
        mask with its clamped starts, the pads not members)."""
        sc = self._scan(stages, blocks, block_size)
        if sc is not None:
            return lambda: (self._kernel_mask(sc), sc.starts, sc.n_blocks,
                            sc.bsz)
        masks = [self._stage(*st) for st in stages]
        if blocks is None:
            return lambda: (functools.reduce(
                lambda a, b: a | b, [m(self.cols) for m in masks]),
                None, None, None)
        db = self._dev(self._pad_blocks(blocks))

        def run():
            valid, _, astart, g = expand_blocks(self.cols, db, block_size,
                                                self.n)
            m = functools.reduce(lambda a, b: a | b, [f(g) for f in masks])
            return m & valid, astart, None, block_size
        return run

    # the torch-ops route ----------------------------------------------------

    def _stage(self, primary_kind, boxes, windows, residual):
        """Constants on the device → torch-ops mask fn over a dict of
        columns."""
        kernel = _mask_kernel(primary_kind, windows is not None)
        b, w = self._dev(boxes), self._dev(windows)
        rp = [self._dev(p) for p in residual[1]] if residual else []
        fn = residual[2] if residual else None
        return lambda cols: kernel(cols, b, w, rp, fn)

    def _stage_count(self, primary_kind, boxes, windows, residual,
                     blocks: Optional[np.ndarray] = None,
                     block_size: Optional[int] = None,
                     per_box: bool = False):
        """Constants on the device → zero-arg count dispatcher: per-box
        counts ((B,) int32) or the any-box count (0-d int32), over the
        table or the padded candidate blocks. An any-box count with a
        residual is one ``fused_scan`` count on the kernel route; the rest
        is the ``box_count`` kernel, behind a mask of the candidates that a
        residual makes first: ``fused_scan``'s mask of the residual alone
        (a boxless stage) on the kernel route, else torch ops (over the
        gathered residual columns in the block case); membership, windows,
        ``__valid__`` and boxes are the kernel's."""
        from geomesa_tpu_torch.kernels.box_count import box_count as kernel
        if (primary_kind != "none" and primary_kind not in PRIMARY_FNS) \
                or (per_box and primary_kind == "none"):
            raise ValueError(f"primary kind {primary_kind}")
        fn = residual[2] if residual else None
        resid_of = None
        if fn is not None:
            if not per_box:
                sc = self._scan([(primary_kind, boxes, windows, residual)],
                                blocks, block_size)
                if sc is not None:
                    return lambda: self._kernel_count(sc)
            sc = self._scan([("none", None, None, residual)], blocks,
                            block_size)
            if sc is not None:
                if blocks is None:
                    resid_of = lambda: self._row_mask(  # noqa: E731
                        self._kernel_mask(sc), sc.bsz)
                else:   # the cover's layout: box_count's membership skips
                    resid_of = lambda: self._kernel_mask(sc)  # noqa: E731
        envelope = primary_kind == "bbox_overlap"
        b = self._dev(boxes) if primary_kind != "none" else None
        w = self._dev(windows)
        rp = [self._dev(p) for p in residual[1]] \
            if residual and resid_of is None else []
        db = None if blocks is None else self._dev(self._pad_blocks(blocks))
        cols, n = self.cols, self.n

        def run():
            rm = None
            if resid_of is not None:
                rm = resid_of()
            elif fn is not None:
                if db is None:
                    rm = fn(cols, rp)
                else:
                    rm = fn(expand_blocks(cols, db, block_size, n)[3], rp)
            return kernel(cols, b, w, rm, db, block_size, per_box,
                          envelope)
        return run

    # full-table modes -------------------------------------------------------

    def prepare_mask(self, primary_kind, boxes, windows, residual):
        """Zero-arg dispatcher → the (n,) bool mask over the table's rows
        (device constants pre-staged)."""
        return self.prepare_union_mask(
            [(primary_kind, boxes, windows, residual)])

    def mask(self, primary_kind, boxes, windows, residual) -> torch.Tensor:
        return self.prepare_mask(primary_kind, boxes, windows, residual)()

    def prepare_count(self, primary_kind, boxes, windows, residual):
        """Zero-arg count dispatcher → 0-d int32 device tensor."""
        return self._stage_count(primary_kind, boxes, windows, residual)

    def count(self, primary_kind, boxes, windows, residual) -> int:
        return int(_fetch(self.prepare_count(primary_kind, boxes, windows,
                                             residual)))

    def prepare_counts_multi(self, primary_kind, boxes: np.ndarray, windows,
                             residual):
        """Zero-arg dispatcher → per-box int32 counts over the FULL table
        (the batched serving path when range pruning declined). B pads to
        a power of two (``EMPTY_BOX`` rows count zero); callers slice the
        readback to ``len(boxes)``."""
        return self._stage_count(primary_kind, pad_boxes(boxes), windows,
                                 residual, per_box=True)

    def counts_multi(self, primary_kind, boxes: np.ndarray, windows,
                     residual) -> np.ndarray:
        """Per-box counts for a (B, 8) box array: one upload of each
        constant, one kernel, one readback."""
        out = _fetch(self.prepare_counts_multi(primary_kind, boxes, windows,
                                               residual))
        return out.cpu().numpy()[: len(boxes)]

    def _prepare_select(self, stage, blocks, block_size, capacity: int):
        from geomesa_tpu_torch.kernels.compact import ordered_compact
        disp = self._candidates([stage], blocks, block_size)
        n = self.n

        def run():
            m, starts, nblk, bsz = disp()
            out = torch.empty(1 + capacity, dtype=torch.int32,
                              device=self.device)
            ordered_compact(m, capacity, n, starts=starts, bsz=bsz,
                            n_blocks=nblk, count_out=out[:1],
                            rows_out=out[1:])
            return out
        return run

    def prepare_select(self, primary_kind, boxes, windows, residual,
                       capacity: int):
        """Zero-arg packed-select dispatcher → int32 [count, ascending
        positions × capacity, padded with n] (the reference's
        ``select_packed`` mode): the mask, then the ``ordered_compact``
        kernel (through the blocks' starts on the kernel route)."""
        return self._prepare_select((primary_kind, boxes, windows, residual),
                                    None, None, capacity)

    def select(self, primary_kind, boxes, windows, residual, capacity: int):
        """(sorted positions int64, true count); grows the capacity and
        re-runs on overflow."""
        while True:
            out = _fetch(self.prepare_select(
                primary_kind, boxes, windows, residual,
                capacity)).cpu().numpy()
            cnt = int(out[0])
            if cnt <= capacity:
                return out[1: 1 + cnt].astype(np.int64), cnt
            capacity = 1 << int(np.ceil(np.log2(cnt)))

    # the OR of stages -------------------------------------------------------

    def prepare_union_count(self, stages):
        """Zero-arg dispatcher → 0-d int32 count of the rows that any of
        ``stages`` ((primary_kind, boxes, windows, residual) each) holds,
        rows that several hold counted once (≙ the sum of the reference's
        OR of masks): one K-branch ``fused_scan`` count over the table's
        blocks, or the sum of the torch ops' OR of masks."""
        sc = self._scan(stages)
        if sc is not None:
            return lambda: self._kernel_count(sc)
        disp = self.prepare_union_mask(stages)
        return lambda: disp().sum(dtype=torch.int32)

    def union_count(self, stages) -> int:
        return int(_fetch(self.prepare_union_count(stages)))

    def prepare_union_mask(self, stages):
        """Zero-arg dispatcher → the (n,) bool row mask of the OR of
        ``stages``: the K-branch ``fused_scan`` mask over the table's
        blocks mapped to rows (``_row_mask``), or the OR of the torch ops'
        masks."""
        disp = self._candidates(stages)

        def run():
            m, _, _, bsz = disp()
            return m if bsz is None else self._row_mask(m, bsz)
        return run

    def union_mask(self, stages) -> torch.Tensor:
        return self.prepare_union_mask(stages)()

    # range-pruned block modes -----------------------------------------------

    def prepare_count_blocks(self, primary_kind, boxes, windows, residual,
                             blocks: np.ndarray, block_size: int):
        """Zero-arg pruned-count dispatcher → 0-d int32 device tensor over
        the candidate blocks."""
        return self._stage_count(primary_kind, boxes, windows, residual,
                                 blocks, block_size)

    def count_blocks(self, primary_kind, boxes, windows, residual,
                     blocks: np.ndarray, block_size: int) -> int:
        """Exact count scanning only the candidate blocks."""
        return int(_fetch(self.prepare_count_blocks(
            primary_kind, boxes, windows, residual, blocks, block_size)))

    def prepare_counts_multi_blocks(self, primary_kind, boxes: np.ndarray,
                                    windows, residual, blocks: np.ndarray,
                                    block_size: int):
        """Zero-arg dispatcher → per-box int32 counts for a whole batch of
        box-queries over the union of their candidate blocks (the batched
        serving path). Boxes pad to a power of two, blocks to a power of
        two of at least 8 with pad -1."""
        return self._stage_count(primary_kind, pad_boxes(boxes), windows,
                                 residual, blocks, block_size, per_box=True)

    def counts_multi_blocks(self, primary_kind, boxes: np.ndarray, windows,
                            residual, blocks: np.ndarray,
                            block_size: int) -> np.ndarray:
        """Blocking counterpart of ``prepare_counts_multi_blocks``."""
        out = _fetch(self.prepare_counts_multi_blocks(
            primary_kind, boxes, windows, residual, blocks, block_size))
        return out.cpu().numpy()[: len(boxes)]

    def prepare_select_blocks(self, primary_kind, boxes, windows, residual,
                              blocks: np.ndarray, block_size: int,
                              capacity: int):
        """Zero-arg pruned packed-select dispatcher → int32 [count, ascending
        positions × capacity, padded with n]: the mask over the candidate
        blocks, then the ``ordered_compact`` kernel through their starts."""
        return self._prepare_select((primary_kind, boxes, windows, residual),
                                    blocks, block_size, capacity)

    def select_blocks(self, primary_kind, boxes, windows, residual,
                      blocks: np.ndarray, block_size: int, capacity: int):
        """(sorted positions int64, true count) scanning only candidate
        blocks; grows the capacity and re-runs on overflow."""
        nb = len(self._pad_blocks(blocks))
        capacity = min(max(1024, capacity), nb * block_size)
        while True:
            out = _fetch(self.prepare_select_blocks(
                primary_kind, boxes, windows, residual, blocks, block_size,
                capacity)).cpu().numpy()
            cnt = int(out[0])
            if cnt <= capacity:
                return out[1: 1 + cnt].astype(np.int64), cnt
            capacity = 1 << int(np.ceil(np.log2(cnt)))

    # candidate runs (the attribute index) -----------------------------------

    # the RUNS form's block: a run is cut into pieces of at most this many
    # rows, and a piece's quads outside its run load nothing
    RUNS_BSZ = 256
    # select_at's largest first capacity: a slice of at most this many
    # candidates compacts once, into a buffer of its candidates' size
    SELECT_AT_MAX = 1 << 20

    def _runs_space(self, runs):
        """(ids, bounds, n_blocks, starts, bsz) of the pieces of sorted,
        disjoint position runs [lo, hi) (``run_pieces``), padded to a power
        of two of at least 8 slots (pad id -1, bounds [0, 0)): ids, bounds
        and the live count go up in one upload, as views of one int32
        buffer; ``starts`` (int64, the clamped first rows) stays on the
        host until a select needs it."""
        bsz = min(self.RUNS_BSZ, self.n)
        ids, bounds = run_pieces(runs, self.n, bsz)
        live = len(ids)
        P = max(8, 1 << max(0, live - 1).bit_length())
        buf = np.zeros(3 * P + 1, np.int32)
        buf[:P] = -1
        buf[:live] = ids
        buf[P: P + 2 * live] = bounds.reshape(-1)
        buf[3 * P] = live
        d = self._dev(buf)
        pad = buf[:P].astype(np.int64)
        starts = np.where(pad >= 0, np.clip(pad * bsz, 0, max(0, self.n - bsz)),
                          0)
        return d[:P], d[P: 3 * P].view(P, 2), d[3 * P: 3 * P + 1], starts, bsz

    def _runs_candidates(self, stage, runs, mode: str):
        """Zero-arg dispatcher over the candidates of ``runs``: ``mode``
        "count" → 0-d int32; "mask" → (candidate mask, starts, n_blocks,
        bsz). A stage ``staged_query`` packs (a point layer's, or an extent
        layer's through the ENV form) is one launch of ``fused_scan``'s RUNS
        form. A stage whose residual it declines (deeper than
        ``MAX_PROGRAM_DEPTH``, more than ``fused_scan.MAX_SLOTS`` columns,
        packed past ``QUERY_MAX_BYTES``) keeps its primary — boxes,
        windows, runs — on that launch as a mask, and ANDs the residual in
        as torch ops over the pieces' gathered rows (the closure the block
        form runs for the same residuals). A table the kernel cannot read
        runs the torch ops over the gathered rows."""
        from geomesa_tpu_torch.kernels.fused_scan import fused_scan
        ids, bounds, nb, starts, bsz = self._runs_space(runs)
        cols, n = self.cols, self.n
        query = staged_query(cols, [stage])
        if query is not None:
            qbuf = self._dev(query.packed)
            if mode == "count":
                return lambda: fused_scan(cols, qbuf, query, ids, nb, bsz,
                                          "count", runs=bounds).reshape(())
            dstarts = self._dev(starts)
            return lambda: (fused_scan(cols, qbuf, query, ids, nb, bsz,
                                       "mask", runs=bounds)[0], dstarts, nb,
                            bsz)
        kind, boxes, windows, residual = stage
        prim = staged_query(cols, [(kind, boxes, windows, None)]) \
            if residual is not None and residual[2] is not None else None
        if prim is not None:
            qbuf = self._dev(prim.packed)
            dstarts = self._dev(starts)
            fn, rp = residual[2], [self._dev(p) for p in residual[1]]

            def run_residual():
                m = fused_scan(cols, qbuf, prim, ids, nb, bsz, "mask",
                               runs=bounds)[0]
                m = m & fn(expand_blocks(cols, ids, bsz, n)[3], rp)
                if mode == "mask":
                    return m, dstarts, nb, bsz
                # the kernel leaves the bytes past the live pieces unwritten
                live = torch.arange(m.shape[0], device=m.device) \
                    < nb.to(torch.int64) * bsz
                return (m & live).sum(dtype=torch.int32)
            return run_residual
        f = self._stage(*stage)

        def run():
            _, rows, astart, g = expand_blocks(cols, ids, bsz, n)
            m = f(g) & run_members(ids, bounds, rows, bsz)
            if mode == "count":
                return m.sum(dtype=torch.int32)
            return m, astart, None, bsz
        return run

    def prepare_count_at(self, primary_kind, boxes, windows, residual, runs):
        """Zero-arg dispatcher → 0-d int32 count of the rows of the sorted,
        disjoint position ``runs`` [lo, hi) that the stage holds (≙ the
        reference's ``count_at``, ``geomesa_tpu/index/scan.py:603-611``,
        over the same positions without materialising them): one
        ``fused_scan`` launch of the RUNS form on a point layer, no host
        sync before the result is read."""
        if self.n == 0 or not len(runs):
            zero = torch.zeros((), dtype=torch.int32, device=self.device)
            return lambda: zero
        return self._runs_candidates(
            (primary_kind, boxes, windows, residual), runs, "count")

    def count_at(self, primary_kind, boxes, windows, residual, runs) -> int:
        """Count over the candidate runs only (attribute-index pruning)."""
        return int(_fetch(self.prepare_count_at(primary_kind, boxes, windows,
                                                residual, runs)))

    def prepare_select_at(self, primary_kind, boxes, windows, residual, runs,
                          capacity: int):
        """Zero-arg dispatcher → int32 [count, ascending positions ×
        capacity, padded with n] of the candidate runs' matches: the RUNS
        form's mask, then ``ordered_compact`` through the pieces' starts."""
        from geomesa_tpu_torch.kernels.compact import ordered_compact
        disp = self._runs_candidates((primary_kind, boxes, windows, residual),
                                     runs, "mask")
        n = self.n

        def run():
            m, starts, nblk, bsz = disp()
            out = torch.empty(1 + capacity, dtype=torch.int32,
                              device=self.device)
            ordered_compact(m, capacity, n, starts=starts, bsz=bsz,
                            n_blocks=nblk, count_out=out[:1],
                            rows_out=out[1:])
            return out
        return run

    def select_at(self, primary_kind, boxes, windows, residual, runs,
                  capacity: int = 1 << 16):
        """(ascending positions int64, count) of the candidate runs' matches
        (≙ the reference's ``select_at``, ``geomesa_tpu/index/scan.py
        :905``, whose positions come in the order of its slices; the
        planner sorts the rows either way); grows the capacity and re-runs
        on overflow."""
        total = int(sum(h - l for l, h in np.asarray(runs).reshape(-1, 2)))
        if self.n == 0 or total <= 0:
            return np.empty(0, dtype=np.int64), 0
        # the candidates bound the matches: up to the largest tier one pass
        capacity = total if total <= self.SELECT_AT_MAX else \
            min(max(1024, capacity), total)
        while True:
            out = _fetch(self.prepare_select_at(
                primary_kind, boxes, windows, residual, runs,
                capacity)).cpu().numpy()
            cnt = int(out[0])
            if cnt <= capacity:
                return out[1: 1 + cnt].astype(np.int64), cnt
            capacity = min(total, 1 << int(np.ceil(np.log2(cnt))))

    # certainty-band segment intersects -------------------------------------

    def prepare_intersects_band_blocks(self, primary_kind, boxes, windows,
                                       residual, edges: np.ndarray,
                                       blocks: np.ndarray, block_size: int,
                                       unc_cap: int = 4096):
        """Zero-arg dispatcher → int32 ``[certain hits, n_uncertain,
        uncertain rows × unc_cap]`` on the device: the ``seg_band`` kernel
        over the padded candidate blocks of a single-segment line layer
        (``sx1``/``sy1``/``sx2``/``sy2``, see ``index.spatial``
        ``ensure_segment_columns``) against a polygon's f32 ``edges``,
        padded as the reference pads them (a power of two of at least 4
        rows of ``EDGE_PAD``; the kernel reads the real rows only). The
        residual is a mask of the candidates: ``fused_scan``'s mask of the
        residual alone (a boxless stage) where ``staged_query`` packs it,
        else torch ops over the gathered residual columns."""
        from geomesa_tpu_torch.kernels.seg_band import seg_band as kernel
        if primary_kind != "bbox_overlap":
            raise ValueError(f"primary kind {primary_kind}")
        ne = max(4, 1 << max(0, (len(edges) - 1)).bit_length())
        ep = np.tile(EDGE_PAD, (ne, 1))
        ep[: len(edges)] = edges
        n_edges = len(edges)
        b, w, e = self._dev(boxes), self._dev(windows), self._dev(ep)
        fn = residual[2] if residual else None
        sc = self._scan([("none", None, None, residual)], blocks,
                        block_size) if fn is not None else None
        rp = [self._dev(p) for p in residual[1]] \
            if residual and sc is None else []
        db = self._dev(self._pad_blocks(blocks))
        cols, n = self.cols, self.n

        def run():
            rm = None
            if sc is not None:   # the cover's layout, as seg_band's
                rm = self._kernel_mask(sc)
            elif fn is not None:
                rm = fn(expand_blocks(cols, db, block_size, n)[3], rp)
            return kernel(cols, b, w, rm, db, block_size, e, n_edges,
                          unc_cap)
        return run

    def intersects_band_blocks(self, primary_kind, boxes, windows, residual,
                               edges: np.ndarray, blocks: np.ndarray,
                               block_size: int, unc_cap: int = 4096):
        """(certain hit count, uncertain row positions) of the exact
        segment-feature × polygon intersects over the candidate blocks (≙
        the reference's ``ScanKernels.intersects_band_blocks``). The
        uncertain positions (rows within the f32 certainty band of a
        boundary) need the host's exact f64 refine; they are None when
        they overflowed ``unc_cap`` (the caller then refines every
        candidate on the host)."""
        out = _fetch(self.prepare_intersects_band_blocks(
            primary_kind, boxes, windows, residual, edges, blocks,
            block_size, unc_cap)).cpu().numpy()
        certain, n_unc = int(out[0]), int(out[1])
        if n_unc > unc_cap:
            return certain, None
        return certain, out[2: 2 + n_unc].astype(np.int64)

    # KNN ----------------------------------------------------------------------

    def prepare_topk_nearest(self, primary_kind, boxes, windows, residual,
                             qx: float, qy: float, m: int):
        """Zero-arg dispatcher → ((m,) f32 distances, (m,) int32 row
        positions) on the device of the m masked rows nearest (qx, qy) over
        the table (≙ the reference's mode ``topk``): the row mask, then the
        ``topk_nearest`` kernel. Distances are +inf past the matches."""
        from geomesa_tpu_torch.kernels.topk import topk_nearest as kernel
        if not 1 <= m <= self.n:
            raise ValueError(f"m = {m} over a table of {self.n} rows")
        disp = self.prepare_mask(primary_kind, boxes, windows, residual)
        cols = self.cols
        return lambda: kernel(cols["xf"], cols["yf"], disp(), qx, qy, m)

    def topk_nearest(self, primary_kind, boxes, windows, residual,
                     qx: float, qy: float, m: int):
        """(distances_m f32, sorted-order positions int32) of the m nearest
        masked rows to (qx, qy) — one readback. Distances are +inf past the
        number of matching rows."""
        d, pos = _fetch(self.prepare_topk_nearest(
            primary_kind, boxes, windows, residual, qx, qy, m))
        return d.cpu().numpy(), pos.cpu().numpy()

    def prepare_topk_nearest_blocks(self, primary_kind, boxes, windows,
                                    residual, qx: float, qy: float, m: int,
                                    blocks: np.ndarray, block_size: int):
        """Zero-arg dispatcher for the pruned KNN (≙ the reference's mode
        ``topk_blocks``): the candidate mask over the padded cover blocks
        (``fused_scan`` on the kernel route), then the ``topk_nearest``
        kernel through the blocks' starts; ``m`` is capped at the
        candidates (padded blocks × ``block_size``)."""
        from geomesa_tpu_torch.kernels.topk import topk_nearest as kernel
        m = min(m, len(self._pad_blocks(blocks)) * block_size)
        disp = self._candidates([(primary_kind, boxes, windows, residual)],
                                blocks, block_size)
        cols = self.cols

        def run():
            mask, starts, _, bsz = disp()
            return kernel(cols["xf"], cols["yf"], mask, qx, qy, m,
                          starts, bsz)
        return run

    def topk_nearest_blocks(self, primary_kind, boxes, windows, residual,
                            qx: float, qy: float, m: int,
                            blocks: np.ndarray, block_size: int):
        """Pruned variant of ``topk_nearest``: distances + top-m over the
        candidate blocks only, positions mapped through their rows."""
        d, pos = _fetch(self.prepare_topk_nearest_blocks(
            primary_kind, boxes, windows, residual, qx, qy, m, blocks,
            block_size))
        return d.cpu().numpy(), pos.cpu().numpy()

    # density ----------------------------------------------------------------

    def prepare_density_compact(self, primary_kind, boxes, windows, residual,
                                grid_bbox, width: int, height: int,
                                cap: int, wname: Optional[str]):
        """Zero-arg dispatcher → ((H, W) f32 grid, 0-d int32 match count),
        both on the device. The reference compacts up to ``cap`` matching
        rows before its scatter (a TPU scatter prices per update); the card
        scatters straight from the table's candidate mask (through the
        blocks' starts on the kernel route). ``cap`` stays in the API so
        the caller's overflow check (count > cap → restage) behaves as the
        reference's."""
        del cap
        return self._prepare_density((primary_kind, boxes, windows, residual),
                                     None, None, grid_bbox, width, height,
                                     wname)

    def prepare_density_blocks(self, primary_kind, boxes, windows, residual,
                               grid_bbox, width: int, height: int,
                               blocks: np.ndarray, block_size: int,
                               wname: Optional[str]):
        """Zero-arg dispatcher for the range-pruned heat-map: the scatter
        reads the candidates' coordinates (and weights) through the
        candidate blocks' starts."""
        return self._prepare_density((primary_kind, boxes, windows, residual),
                                     blocks, block_size, grid_bbox, width,
                                     height, wname)

    def _prepare_density(self, stage, blocks, block_size, grid_bbox,
                         width: int, height: int, wname: Optional[str]):
        from geomesa_tpu_torch.kernels.density import grid_scatter as kernel
        disp = self._candidates([stage], blocks, block_size)
        # f64 bounds round to f32 the way the reference stages them
        g = self._dev(np.asarray(grid_bbox, dtype=np.float32))
        w = self.cols[wname] if wname else None
        cols = self.cols

        def run():
            m, starts, nblk, bsz = disp()
            return kernel(cols["xf"], cols["yf"], m, w, starts, bsz, g,
                          width, height, n_blocks=nblk)
        return run
