"""The geometry function catalog on the device (≙ ``geomesa_tpu.geom.catalog``).

≙ geomesa-spark-jts: the st_* UDF surface, evaluated on the device over the
columnar geometry table. Features are packed into pow2-padded vertex and
segment tables (``pack_features``: ``pack_host`` derives the vertices and
segment ends with numpy, ``pack_device`` scatters them into the tables on
the device) and each function is one program over the batch's real rows:

  st_area / st_length / st_centroid  — ``geom_unary`` (kernels/geom.py)
  st_distance                        — ``geom_dist``: a min over the
                                       feature's and the literal's parts
  st_contains / st_intersects        — ``geom_pred``: certainty-banded
                                       (cin, cout), the uncertain sliver
                                       refined by the f64 host oracle, so
                                       the booleans are exact
  st_convexHull / st_buffer          — a gift-wrap hull (buffer = the hull
                                       of the eight-offset octagon sweep),
                                       plain torch ops

Precision (as the reference): device arithmetic is f32. Vertices are
shifted per feature to a grid-quantized local origin (multiples of 1/256
degree, exact in f32). The boolean predicates use the ``_pip_band`` /
``_segpair_band`` certainty bands and are exact after the refine; the
scalars carry the forward-error bounds ``parity_report`` computes per
feature.

The plain versions (``_unary_plain``, ``_dist_plain``, ``_pred_plain``,
``_hull_plain``) are torch ops batched over the B features, in the
reference's operation order and with its rounding: XLA on the CPU flushes
subnormal f32 inputs and results to zeros of their sign and contracts ``a
* b + c`` into one fused multiply-add where the product has no other use
(``geomesa_tpu_torch/arith.py``: ``x1 * y2 - x2 * y1`` is ``fma(x1, y2,
-(x2 * y1))``, ``jnp.hypot``'s ``1 + r * r`` is ``fma(r, r, 1)``, a sum of
products accumulates by fma). The unary sums run left to right over the
padded rows, which is XLA's order up to 8 segments (it reassociates wider
sums; there the values are held to ``parity_report``'s bounds). The
CUDA kernels do the same operations in the same order, so they equal the
plain versions bit for bit.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from geomesa_tpu_torch import config
from geomesa_tpu_torch.arith import add as _add
from geomesa_tpu_torch.arith import div as _div
from geomesa_tpu_torch.arith import flush as _z
from geomesa_tpu_torch.arith import fma as _fma
from geomesa_tpu_torch.arith import mul as _mul
from geomesa_tpu_torch.arith import pow2 as _pow2
from geomesa_tpu_torch.arith import sqrt as _sqrt
from geomesa_tpu_torch.arith import sub as _sub
from geomesa_tpu_torch.features import geometry as geo
from geomesa_tpu_torch.filter import geom_numpy as gn
from geomesa_tpu_torch.geom import oracle
from geomesa_tpu_torch.index.device import resolve
from geomesa_tpu_torch.index.scan import EDGE_PAD, _pip_band, _segpair_band
from geomesa_tpu_torch.kernels import geom as _kgeom

# f32 eps and the |f64 − f32| lon/lat coordinate bound: the scan bands'
# constants (parity_report's bounds)
_EPS32 = 1.2e-7
_DELTA = 2.5e-5

# certain-miss distance band of the predicates: a true distance of 0 reads
# at most ~4·_DELTA on the device, so anything beyond it is certainly
# disjoint; compared squared, the square taken in f32
_MISS_BAND = np.float32(1.5e-4)
MISS2 = float(_MISS_BAND * _MISS_BAND)

# the programs' pads and sentinels (the reference's constants)
VERT_PAD = 3e9       # masked vertices and literal points
SEG_PAD = 4e9        # masked feature segments in the crossing test
BIG = float(np.float32(9e18))
HULL_STEPS = 160     # gift-wrap steps; hulls beyond go to the host

# per-op uncertain-sliver / host-refine counters (observability + tests)
STATS: Dict[str, int] = {
    "predicate_calls": 0, "predicate_rows": 0, "refined_rows": 0,
    "unary_calls": 0, "distance_calls": 0, "hull_calls": 0,
    "hull_host_fallbacks": 0,
}
_LOCK = threading.Lock()

_OP_CODE = {"intersects": 0, "within": 1, "contains": 2}


# -- feature packing ---------------------------------------------------------


@dataclass
class FeaturePack:
    """Pow2-padded per-feature vertex/segment tables (see module doc)."""
    n: int                  # real feature count (≤ B)
    verts: torch.Tensor     # (B, K, 2) f32, local-origin shifted
    vmask: torch.Tensor     # (B, K) bool
    segs: torch.Tensor      # (B, S, 4) f32, shifted, rings closed
    smask: torch.Tensor     # (B, S) bool
    wsign: torch.Tensor     # (B, S) f32 shoelace weights (0 off polygons)
    mode: torch.Tensor      # (B,) int32 centroid cascade (oracle rule)
    poly: torch.Tensor      # (B,) bool polygonal feature
    ref: np.ndarray         # (B, 2) f64 local origins (f32-exact values)
    ref32: torch.Tensor     # (B, 2) f32

    def rows(self, *fields: str) -> List[torch.Tensor]:
        """The named tables' first n rows, the real features: what the
        programs are handed, so that no launch spends work on a pad row."""
        return [getattr(self, f)[: self.n] for f in fields]


UNARY = ("verts", "vmask", "segs", "smask", "wsign", "mode")
PAIR = ("verts", "vmask", "segs", "smask", "poly", "ref32")


def _quantize_ref(bb: np.ndarray) -> np.ndarray:
    """(B, 2) grid-quantized bbox centers, exactly representable in f32:
    round((lo + hi) · 0.5 · 256) / 256, column by column."""
    c = np.empty((len(bb), 2), dtype=np.float64)
    for k in (0, 1):
        col = bb[:, k] + bb[:, k + 2]
        col *= 0.5
        col *= 256.0
        np.round(col, out=col)
        col /= 256.0
        c[:, k] = col
    return c


def _ordinals(counts: np.ndarray) -> np.ndarray:
    """0, 1, ... within each run of ``counts`` (concatenated)."""
    total = int(counts.sum())
    starts = np.repeat(np.cumsum(counts) - counts, counts)
    return np.arange(total, dtype=np.int64) - starts


def _ring_width(arr: geo.GeometryArray) -> int:
    """m when every feature of ``arr`` is one part of one ring of m >= 2
    coordinates, stored back to back (a line layer, simple polygons); else
    0. Three sequential passes over the offsets."""
    go, po, ro = arr.geom_offsets, arr.part_offsets, arr.ring_offsets
    levels = np.arange(len(go), dtype=np.int64)
    if len(go) < 2 or not (np.array_equal(go, levels)
                           and np.array_equal(po, levels)):
        return 0
    m = int(ro[1])
    return m if m >= 2 and np.array_equal(ro, m * levels) else 0


def _one_ring_tables(arr: geo.GeometryArray, rows: np.ndarray, m: int):
    """``_ragged_tables``' arrays for rows of a ``_ring_width`` m layer of
    LineStrings and closed Polygons (None for another layer): one gather
    of the rows' m coordinates, the bboxes their extremes (bboxes()'
    values), a feature's segments its m − 1 consecutive vertex pairs, a
    polygon's weight the sign of its ring's signed area. The general
    expansion takes longer on such a layer (PERF.md §6 has the
    measurement). Columns are taken one at a time: numpy's loops over an
    axis of 2 are slow."""
    codes = arr.type_codes
    polys = codes == geo.POLYGON
    if not np.all(polys | (codes == geo.LINESTRING)):
        return None
    n = len(rows)
    fpoly = polys[rows] if polys.any() else np.zeros(n, dtype=bool)
    xy = np.take(arr.coords.reshape(-1, m, 2), rows, axis=0)
    cols = xy.reshape(n, 2 * m)   # x0 y0 x1 y1 ...
    if fpoly.any() and not np.all(
            ~fpoly | ((cols[:, 0] == cols[:, 2 * m - 2])
                      & (cols[:, 1] == cols[:, 2 * m - 1]))):
        return None
    bbt = np.empty((4, n), dtype=np.float64)   # bb column by column
    for k in (0, 1):
        np.minimum(cols[:, k], cols[:, 2 + k], out=bbt[k])
        np.maximum(cols[:, k], cols[:, 2 + k], out=bbt[k + 2])
        for j in range(2, m):
            np.minimum(bbt[k], cols[:, 2 * j + k], out=bbt[k])
            np.maximum(bbt[k + 2], cols[:, 2 * j + k], out=bbt[k + 2])
    bb = bbt.T
    # counts and vertex positions as int32 where they fit: a smaller upload
    it = np.int32 if n * m < 2 ** 31 else np.int64
    seg_a = ((np.arange(n, dtype=it) * m)[:, None]
             + np.arange(m - 1, dtype=it)).ravel()
    seg_w = np.zeros(len(seg_a), dtype=np.float32)
    mode = np.full(n, oracle.MODE_LINEAL, dtype=np.int32)
    if fpoly.any():
        x, y = cols[:, 0::2], cols[:, 1::2]
        sa = 0.5 * np.sum(x * np.roll(y, -1, axis=1)
                          - np.roll(x, -1, axis=1) * y, axis=1)
        seg_w = np.repeat(np.where(fpoly, np.where(sa >= 0, 1.0, -1.0), 0.0)
                          .astype(np.float32), m - 1)
        mode = _areal_mode(mode, fpoly, 2.0 * np.abs(sa), bb)
    return (bb, np.full(n, m, dtype=it), xy.reshape(-1, 2),
            np.full(n, m - 1, dtype=it), seg_a, seg_a + 1, seg_w, fpoly,
            mode)


def _areal_mode(mode: np.ndarray, feat_poly: np.ndarray, a2: np.ndarray,
                bb: np.ndarray) -> np.ndarray:
    """``centroid_mode``'s areal rule over ``mode``: a polygon whose doubled
    area ``a2`` exceeds AREAL_REL of its bbox area."""
    ext2 = np.maximum((bb[:, 2] - bb[:, 0]) * (bb[:, 3] - bb[:, 1]), 1e-300)
    return np.where(feat_poly & (np.abs(a2) > oracle.AREAL_REL * ext2),
                    oracle.MODE_AREAL, mode).astype(np.int32)


def _ragged_tables(arr: geo.GeometryArray, rows: np.ndarray):
    """The reference's per-feature loop, vectorized over the ragged offsets
    of the features ``rows``: their bboxes; the per-feature vertex counts
    and the vertices feature by feature; the per-feature segment counts
    and each segment's end vertices (positions in that vertex array) and
    weight; each feature's polygon flag and centroid mode.

    Vertices are the feature's coordinates (``feature_coords``); segments
    are ``feature_segments``' (the rings of the parts ``shape`` keeps, a
    polygon ring closed when stored open); a polygon ring's segments weigh
    its shoelace sign, +1 a shell and −1 a hole times the sign of its
    ``_ring_signed_area``, and the mode is ``centroid_mode``'s."""
    n = len(rows)
    codes = arr.type_codes[rows]
    bb = np.take(arr.bboxes(), rows, axis=0)
    go, po, ro = arr.geom_offsets, arr.part_offsets, arr.ring_offsets
    # one 16-byte item a coordinate: a 1-D gather is the fastest numpy has
    cv = np.ascontiguousarray(arr.coords).view(np.complex128).ravel()
    g0, g1 = go[rows], go[rows + 1]
    c0 = ro[po[g0]]
    nv = ro[po[g1]] - c0
    nparts = g1 - g0
    parts = geo.expand_slices(g0, nparts)
    part_feat = np.repeat(np.arange(n, dtype=np.int64), nparts)
    part_ord = _ordinals(nparts)
    nrings = po[parts + 1] - po[parts]
    rings = geo.expand_slices(po[parts], nrings)
    ring_feat = np.repeat(part_feat, nrings)
    ring_part = np.repeat(part_ord, nrings)
    ring_ord = _ordinals(nrings)
    rs, re_ = ro[rings], ro[rings + 1]
    rlen = re_ - rs
    code = codes[ring_feat]
    polyish = (code == geo.POLYGON) | (code == geo.MULTIPOLYGON)
    lineal = (code == geo.LINESTRING) | (code == geo.MULTILINESTRING)
    nonempty = rlen >= 1
    closed = np.zeros(len(rings), dtype=bool)
    ne = np.flatnonzero(polyish & nonempty)
    closed[ne] = cv[rs[ne]] == cv[re_[ne] - 1]
    keep_poly = polyish & ((code == geo.MULTIPOLYGON) | (ring_part == 0))
    keep_line = lineal & (ring_ord == 0) \
        & ((code == geo.MULTILINESTRING) | (ring_part == 0))
    closing = keep_poly & nonempty & ~closed
    nseg = np.where(keep_line, np.maximum(rlen - 1, 0), 0)
    span = rlen + closing
    nseg = np.where(keep_poly, np.where(span >= 2, span - 1, 0), nseg)
    # segments: start at the ring's coordinate s + j, end at s + j + 1 or,
    # for the closing segment, back at s; as positions in the vertex array
    # (a feature's coordinates are one slice, from c0)
    seg_ring = np.repeat(np.arange(len(rings), dtype=np.int64), nseg)
    a = geo.expand_slices(rs, nseg)
    b = a + 1
    wrap = b >= re_[seg_ring]
    b[wrap] = rs[seg_ring[wrap]]
    seg_feat = ring_feat[seg_ring]
    ns = np.bincount(seg_feat, minlength=n).astype(np.int64)
    shift = (np.cumsum(nv) - nv - c0)[seg_feat]
    a += shift
    b += shift
    feat_poly = (codes == geo.POLYGON) | (codes == geo.MULTIPOLYGON)
    mode = np.where(codes != geo.POINT, np.where(ns > 0, oracle.MODE_LINEAL,
                                                 oracle.MODE_POINT),
                    oracle.MODE_POINT).astype(np.int32)
    seg_w = np.zeros(len(a), dtype=np.float32)
    pr = np.flatnonzero(polyish & nonempty)
    if len(pr):
        # per-ring signed areas (np.sum per ring, as _ring_signed_area),
        # grouped by ring length so each group is one row sum
        ring_sa = np.zeros(len(rings), dtype=np.float64)
        for length in np.unique(rlen[pr]):
            g = pr[rlen[pr] == length]
            z = cv[rs[g][:, None] + np.arange(length, dtype=np.int64)]
            x, y = z.real, z.imag
            cr = x * np.roll(y, -1, axis=1) - np.roll(x, -1, axis=1) * y
            ring_sa[g] = 0.5 * np.sum(cr, axis=1)
        shell = np.where(ring_ord == 0, 1.0, -1.0)
        ring_w = shell * np.where(ring_sa >= 0, 1.0, -1.0)
        seg_w = np.where(polyish[seg_ring], ring_w[seg_ring], 0.0) \
            .astype(np.float32)
        # centroid_mode: a2 summed left to right over the feature's rings
        a2 = np.zeros(n, dtype=np.float64)
        term = shell * 2.0 * np.abs(ring_sa)
        rf_ord = _ordinals(np.bincount(ring_feat, minlength=n)
                           .astype(np.int64))
        for j in range(int(rf_ord.max(initial=-1)) + 1):
            at = np.flatnonzero(polyish & (rf_ord == j))
            a2[ring_feat[at]] += term[at]
        mode = _areal_mode(mode, feat_poly, a2, bb)
    vert_xy = cv[geo.expand_slices(c0, nv)].view(np.float64).reshape(-1, 2)
    return bb, nv, vert_xy, ns, a, b, seg_w, feat_poly, mode


@dataclass
class HostPack:
    """A batch's tables before padding, on the host (``pack_host``)."""
    n: int
    B: int
    K: int
    S: int
    ref: np.ndarray         # (B, 2) f64 local origins
    poly: np.ndarray        # (B,) bool
    mode: np.ndarray        # (B,) int32
    nv: np.ndarray          # (n,) vertex counts (int32 or int64)
    vert_xy: np.ndarray     # (Σ nv, 2) f64 vertices, feature by feature
    ns: np.ndarray          # (n,) segment counts
    seg_a: np.ndarray       # (Σ ns,) start vertex (a position in vert_xy)
    seg_b: np.ndarray       # (Σ ns,) end vertex
    seg_w: np.ndarray       # (Σ ns,) f32 shoelace weights


def pack_host(arr: geo.GeometryArray, rows: np.ndarray) -> HostPack:
    """The host half of ``pack_features``: numpy over the ragged offsets,
    no loop over features (a batch of points takes the reference's point
    fast path: one vertex and no segment a feature)."""
    rows = np.asarray(rows, dtype=np.int64)
    n = len(rows)
    B = _pow2(max(n, 1), 8)
    ref = np.zeros((B, 2), dtype=np.float64)
    poly = np.zeros(B, dtype=bool)
    mode = np.zeros(B, dtype=np.int32)
    none = np.zeros(0, dtype=np.int64)
    if n == 0:
        return HostPack(0, B, 1, 1, ref, poly, mode, none,
                        np.zeros((0, 2)), none, none, none,
                        np.zeros(0, dtype=np.float32))
    if arr.is_point_column or bool(np.all(arr.type_codes[rows]
                                          == geo.POINT)):
        # the point fast path (Z2/Z3 point layers)
        ref[:n] = _quantize_ref(np.take(arr.bboxes(), rows, axis=0))
        if arr.is_point_column:
            xy = np.stack([arr.x[rows], arr.y[rows]], axis=1)
        else:
            xy = np.take(arr.coords, arr.ring_offsets[arr.part_offsets[
                arr.geom_offsets[rows]]], axis=0)
        return HostPack(n, B, 1, 1, ref, poly, mode,
                        np.ones(n, dtype=np.int64), xy,
                        np.zeros(n, dtype=np.int64), none, none,
                        np.zeros(0, dtype=np.float32))
    m = _ring_width(arr)
    t = _one_ring_tables(arr, rows, m) if m else None
    bb, nv, vert_xy, ns, seg_a, seg_b, seg_w, fpoly, fmode = \
        t if t is not None else _ragged_tables(arr, rows)
    ref[:n] = _quantize_ref(bb)
    poly[:n], mode[:n] = fpoly, fmode
    K = _pow2(max(int(nv.max()), 1))
    S = _pow2(max(int(ns.max()), 1))
    return HostPack(n, B, K, S, ref, poly, mode, nv, vert_xy, ns, seg_a,
                    seg_b, seg_w)


def _up(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(a).to(dev)


def _slots(counts: np.ndarray, dev: torch.device):
    """(feature, slot) of every item of the runs ``counts``, on ``dev``."""
    total = int(counts.sum())
    c = _up(counts, dev).long()
    feat = torch.repeat_interleave(torch.arange(len(counts), device=dev), c,
                                   output_size=total)
    start = torch.repeat_interleave(torch.cumsum(c, 0) - c, c,
                                    output_size=total)
    return feat, torch.arange(total, device=dev) - start


def pack_device(h: HostPack, device=None) -> FeaturePack:
    """The device half of ``pack_features``: the host arrays go to
    ``device`` once and the padded tables are scattered there (each
    vertex shifted by its feature's origin in f64 and rounded to f32, as
    the reference does on the host)."""
    dev = resolve(device)
    f32 = torch.float32
    B, K, S, n = h.B, h.K, h.S, h.n
    ref = _up(h.ref[:n], dev)
    ref32 = torch.zeros((B, 2), dtype=f32, device=dev)
    ref32[:n] = ref.to(f32)
    verts = torch.zeros((B, K, 2), dtype=f32, device=dev)
    vmask = torch.zeros((B, K), dtype=torch.bool, device=dev)
    segs = _up(EDGE_PAD, dev).repeat(B, S, 1)
    smask = torch.zeros((B, S), dtype=torch.bool, device=dev)
    wsign = torch.zeros((B, S), dtype=f32, device=dev)
    if len(h.vert_xy):
        vf, vs = _slots(h.nv, dev)
        local = (_up(h.vert_xy, dev) - ref[vf]).to(f32)
        verts[vf, vs] = local
        vmask[vf, vs] = True
        if len(h.seg_a):
            sf, ss = _slots(h.ns, dev)
            segs[sf, ss] = torch.cat([local[_up(h.seg_a, dev).long()],
                                      local[_up(h.seg_b, dev).long()]],
                                     dim=1)
            smask[sf, ss] = True
            wsign[sf, ss] = _up(h.seg_w, dev)
    return FeaturePack(
        n=n, verts=verts, vmask=vmask, segs=segs, smask=smask, wsign=wsign,
        mode=_up(h.mode, dev), poly=_up(h.poly, dev), ref=h.ref, ref32=ref32)


def pack_features(arr: geo.GeometryArray, rows: np.ndarray,
                  device=None) -> FeaturePack:
    """The reference's ``pack_features`` on ``device`` (the card unless the
    caller names another): ``pack_host``'s numpy arrays, padded into
    tables on ``device`` by ``pack_device``."""
    return pack_device(pack_host(arr, rows), device)


def pack_literal(literal: tuple, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """((L, 4) padded f32 edges, (P, 2) f32 points, polygonal?) in the
    global frame (the programs shift them by each feature's ref).

    The points pad to a power of two with copies of the literal's last
    point (``VERT_PAD`` only for a literal without points), so every
    ``any``, ``all`` and ``min`` the programs take over the points is the
    one over the literal's own. The reference pads with ``VERT_PAD``,
    which lies outside every feature: its banded contains answers false
    for a feature that contains a literal of 3, 5, 6 or 7 points."""
    dev = resolve(device)
    lsegs = gn.literal_segments(literal)
    L = _pow2(max(len(lsegs), 1))
    ls = np.tile(EDGE_PAD, (L, 1)).astype(np.float32)
    ls[: len(lsegs)] = lsegs.astype(np.float32)
    lc = gn.literal_coords(literal).astype(np.float32)
    P = _pow2(max(len(lc), 1))
    lp = np.full((P, 2), VERT_PAD, dtype=np.float32)
    lp[: len(lc)] = lc
    if len(lc):
        lp[len(lc):] = lc[-1]
    return torch.from_numpy(ls).to(dev), torch.from_numpy(lp).to(dev), \
        literal[0] in (geo.POLYGON, geo.MULTIPOLYGON)


# -- the plain programs: f32 arithmetic as XLA does it on the CPU --------------


def _lsum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right."""
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = _add(acc, x[..., j])
    return acc


def _lfma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of products over the last axis, accumulated by fma left to
    right from 0."""
    acc = torch.zeros(a.shape[:-1], dtype=torch.float32, device=a.device)
    for j in range(a.shape[-1]):
        acc = _fma(a[..., j], b[..., j], acc)
    return acc


def _hypot(a, b):
    """``jnp.hypot``: max · sqrt(1 + (min / max)²), 0 where max is 0."""
    a, b = a.abs(), b.abs()
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    r = _div(lo, torch.where(hi == 0, torch.ones_like(hi), hi))
    h = torch.where(hi == 0, hi, _mul(hi, _sqrt(_fma(r, r, 1.0))))
    return torch.where(torch.isinf(a) | torch.isinf(b),
                       torch.full_like(h, float("inf")), h)


def _unary_plain(verts, vmask, segs, smask, wsign, mode):
    """(area, length, cx, cy) (B,) f32 of the packed features (local frame);
    ≙ the reference's ``_unary_one``, vmapped."""
    verts, segs, wsign = _z(verts), _z(segs), _z(wsign)
    x1, y1, x2, y2 = segs.unbind(-1)
    sm = smask.to(torch.float32)
    cross = _mul(_fma(x1, y2, -_mul(x2, y1)), wsign)
    a2 = _lsum(cross)
    area = torch.clamp_min(_mul(a2, 0.5), 0.0)
    ln = _mul(_hypot(_sub(x2, x1), _sub(y2, y1)), sm)
    length = _lsum(ln)
    sx, sy = _add(x1, x2), _add(y1, y2)
    # areal moments
    three = _mul(torch.where(a2 == 0, torch.ones_like(a2), a2), 3.0)
    acx, acy = _div(_lfma(sx, cross), three), _div(_lfma(sy, cross), three)
    # lineal: length-weighted midpoints
    two = _mul(torch.where(length == 0, torch.ones_like(length), length),
               2.0)
    lcx, lcy = _div(_lfma(ln, sx), two), _div(_lfma(ln, sy), two)
    # point: vertex mean
    vm = vmask.to(torch.float32)
    nv = torch.clamp_min(_lsum(vm), 1.0)
    pcx = _div(_lsum(_mul(verts[..., 0], vm)), nv)
    pcy = _div(_lsum(_mul(verts[..., 1], vm)), nv)
    cx = torch.where(mode == 2, acx, torch.where(mode == 1, lcx, pcx))
    cy = torch.where(mode == 2, acy, torch.where(mode == 1, lcy, pcy))
    return area, length, cx, cy


def _pt_seg_d2(px, py, s):
    """Squared point-to-segment distance, broadcasting."""
    x1, y1, x2, y2 = s.unbind(-1)
    dx, dy = _sub(x2, x1), _sub(y2, y1)
    ll = _fma(dx, dx, _mul(dy, dy))
    t = _div(_fma(_sub(px, x1), dx, _mul(_sub(py, y1), dy)),
             torch.where(ll == 0, torch.ones_like(ll), ll)).clamp(0.0, 1.0)
    ex, ey = _sub(px, _fma(t, dx, x1)), _sub(py, _fma(t, dy, y1))
    return _fma(ex, ex, _mul(ey, ey))


def _pip_plain(px, py, e, evalid=None):
    """Unbanded crossing-parity point-in-polygon over the last axis (the
    distance program's containment)."""
    x1, y1, x2, y2 = e.unbind(-1)
    cond = (y1 > py) != (y2 > py)
    den = _sub(y2, y1)
    xs = _add(x1, _div(_mul(_sub(py, y1), _sub(x2, x1)),
                       torch.where(y2 == y1, torch.ones_like(den), den)))
    cr = cond & (xs > px)
    if evalid is not None:
        cr = cr & evalid
    return (cr.sum(dim=-1) % 2) == 1


def _cross_plain(a, b):
    """Any proper crossing between (..., S, 4) and (..., L, 4): (..., S, L)."""
    ax1, ay1, ax2, ay2 = (a[..., :, None, i] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))

    def orient(ox, oy, px, py, qx, qy):
        return _fma(_sub(px, ox), _sub(qy, oy),
                    -_mul(_sub(py, oy), _sub(qx, ox)))

    d1 = orient(ax1, ay1, ax2, ay2, bx1, by1)
    d2 = orient(ax1, ay1, ax2, ay2, bx2, by2)
    d3 = orient(bx1, by1, bx2, by2, ax1, ay1)
    d4 = orient(bx1, by1, bx2, by2, ax2, ay2)
    return (_mul(d1, d2) < 0) & (_mul(d3, d4) < 0)


def _shifted(verts, vmask, ref32, lsegs, lpts):
    """The literal in each feature's frame and the padded vertex columns:
    (le (B, L, 4), lp (B, P, 2), vx (B, K), vy (B, K))."""
    ref32 = _z(ref32)
    le = _sub(_z(lsegs)[None], torch.cat([ref32, ref32], dim=1)[:, None])
    lp = _sub(_z(lpts)[None], ref32[:, None])
    verts = _z(verts)
    vx = torch.where(vmask, verts[..., 0], VERT_PAD)
    vy = torch.where(vmask, verts[..., 1], VERT_PAD)
    return le, lp, vx, vy


def _min_d2(vx, vy, vmask, segs, smask, le, lp):
    """(B,) min over vertex → literal edge, literal point → segment and
    vertex → literal point squared distances (masked to 9e18)."""
    d2a = torch.where(vmask[:, :, None],
                      _pt_seg_d2(vx[:, :, None], vy[:, :, None],
                                 le[:, None]), BIG).amin(dim=(1, 2))
    d2b = torch.where(smask[:, None, :],
                      _pt_seg_d2(lp[:, :, 0, None], lp[:, :, 1, None],
                                 segs[:, None]), BIG).amin(dim=(1, 2))
    dx = _sub(vx[:, :, None], lp[:, None, :, 0])
    dy = _sub(vy[:, :, None], lp[:, None, :, 1])
    d2c = torch.where(vmask[:, :, None], _fma(dx, dx, _mul(dy, dy)),
                      BIG).amin(dim=(1, 2))
    return torch.minimum(torch.minimum(d2a, d2b), d2c)


def _dist_plain(verts, vmask, segs, smask, poly, ref32, lsegs, lpts,
                lit_poly: bool):
    """(B,) f32 distances of the packed features to the literal; 0 on a
    proper crossing or a containment by unbanded parity (≙ the
    reference's ``_dist_one``, vmapped)."""
    segs = _z(segs)
    le, lp, vx, vy = _shifted(verts, vmask, ref32, lsegs, lpts)
    d2 = _min_d2(vx, vy, vmask, segs, smask, le, lp)
    zero = _cross_plain(torch.where(smask[..., None], segs, SEG_PAD),
                        le).any(dim=2).any(dim=1)
    if lit_poly:
        zero |= (_pip_plain(vx[:, :, None], vy[:, :, None], le[:, None])
                 & vmask).any(dim=1)
    zero |= poly & _pip_plain(lp[:, :, 0, None], lp[:, :, 1, None],
                              segs[:, None], evalid=smask[:, None, :]
                              ).any(dim=1)
    return torch.where(zero, torch.zeros_like(d2), _sqrt(d2))


def _pred_plain(verts, vmask, segs, smask, poly, ref32, lsegs, lpts,
                op: int, lit_poly: bool, lit_ext: bool):
    """Banded (certainly-true, certainly-false) (B,) bools of the packed
    features against the literal (≙ the reference's ``_pred_one``,
    vmapped). op: 0 = intersects, 1 = within (literal ⊇ feature),
    2 = contains (feature ⊇ literal)."""
    segs = _z(segs)
    le, lp, vx, vy = _shifted(verts, vmask, ref32, lsegs, lpts)
    # banded pip: feature vertices vs literal edges (pads never cross)
    e = le[:, None]
    vin, vout = _pip_band(vx[:, :, None], vy[:, :, None], e[..., 0],
                          e[..., 1], e[..., 2], e[..., 3])
    # banded pip: literal points vs feature edges
    f = segs[:, None]
    pin, pout = _pip_band(lp[:, :, 0, None], lp[:, :, 1, None], f[..., 0],
                          f[..., 1], f[..., 2], f[..., 3],
                          evalid=smask[:, None, :])
    # banded segment pairs (S, L)
    a, b = segs[:, :, None], le[:, None]
    si, sm = _segpair_band(a[..., 0], a[..., 1], a[..., 2], a[..., 3],
                           b[..., 0], b[..., 1], b[..., 2], b[..., 3])
    si = si & smask[:, :, None]
    sm = sm | ~smask[:, :, None]
    far = _min_d2(vx, vy, vmask, segs, smask, le, lp) > MISS2
    if op == 0:
        cin = si.any(dim=2).any(dim=1)
        if lit_poly:
            cin |= (vin & vmask).any(dim=1)
        cin |= poly & pin.any(dim=1)
        cout = far
    elif op == 1:
        cout = far
        if lit_poly:
            cin = vmask.any(dim=1) & (vin | ~vmask).all(dim=1) \
                & sm.all(dim=2).all(dim=1)
            cout = cout | (vout & vmask).any(dim=1)
        else:
            cin = torch.zeros_like(far)
    else:
        cout = far | (poly & pout.any(dim=1))
        if lit_ext:
            cout = cout | ~poly
        cin = poly & pin.all(dim=1) & sm.all(dim=2).all(dim=1)
    return cin, cout


def _hull_plain(verts, vmask):
    """Gift-wrap convex hulls of the padded vertex sets: ((B, K, 2) hull
    vertices CCW from the lexicographic min, (B,) int32 count, (B,)
    closed?) — not closed (the wrap did not come back within min(K, 160)
    steps, possible under f32 collinear ties) goes to the host. ≙ the
    reference's ``_hull_one``, vmapped; the scan over candidates keeps its
    order, since its tie rule is not a total order."""
    B, K = vmask.shape
    dev = verts.device
    verts = _z(verts)
    vx = torch.where(vmask, verts[..., 0], VERT_PAD)
    vy = torch.where(vmask, verts[..., 1], VERT_PAD)
    minx = vx.amin(dim=1, keepdim=True)
    start = torch.argmin(torch.where(vx == minx, vy,
                                     torch.full_like(vy, VERT_PAD)), dim=1)
    ar = torch.arange(B, device=dev)
    sx, sy = vx[ar, start], vy[ar, start]

    # candidate slots no feature fills never win the scan (skipped)
    live_r = torch.nonzero(vmask.any(dim=0)).flatten().tolist()

    def pick_next(cur):
        cx, cy = vx[ar, cur], vy[ar, cur]
        q = cur
        for r in live_r:
            qx, qy = vx[ar, q], vy[ar, q]
            rx, ry = vx[:, r], vy[:, r]
            dqx, dqy = _sub(qx, cx), _sub(qy, cy)
            drx, dry = _sub(rx, cx), _sub(ry, cy)
            cr = _fma(dqx, dry, -_mul(dqy, drx))
            d2q = _fma(dqx, dqx, _mul(dqy, dqy))
            d2r = _fma(drx, drx, _mul(dry, dry))
            better = vmask[:, r] & (cur != r) & (
                (cr < 0) | (q == cur) | ((cr == 0) & (d2r > d2q)))
            q = torch.where(better, torch.full_like(q, r), q)
        return q

    out = torch.zeros((B, K, 2), dtype=torch.float32, device=dev)
    out[:, 0, 0], out[:, 0, 1] = sx, sy
    cur = start
    cnt = torch.ones(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for k in range(1, min(K, HULL_STEPS) + 1):
        nxt = pick_next(cur)
        nx, ny = vx[ar, nxt], vy[ar, nxt]
        closing = ((nx == sx) & (ny == sy)) | (nxt == cur)
        write = ~done & ~closing
        if k < K:   # the reference's scatter drops a write past the table
            out[:, k, 0] = torch.where(write, nx, out[:, k, 0])
            out[:, k, 1] = torch.where(write, ny, out[:, k, 1])
        cnt = torch.where(write, cnt + 1, cnt)
        done = done | closing
        cur = nxt
        if bool(done.all()):
            break   # every wrap closed: later steps write nothing
    return out, cnt, done


# -- batch entry points ------------------------------------------------------


def _row_chunks(rows: np.ndarray, lit_items: int):
    """Split a row batch so the plain (B, S, L) pair tables stay under the
    GEOM_CHUNK element budget (S estimated at 64)."""
    budget = max(int(config.GEOM_CHUNK.get()), 1024)
    per = max(1, budget // max(1, 64 * lit_items))
    for s in range(0, len(rows), per):
        yield rows[s: s + per]


def _chunks(rows: np.ndarray, lit_items: int, dev: torch.device):
    """The row batches of one call: all rows in one launch on the card (each
    output row depends on its own feature only), ``_row_chunks`` for the
    plain pair tables elsewhere."""
    if dev.type == "cuda":
        return [rows]
    return list(_row_chunks(rows, lit_items))


def unary_values(arr: geo.GeometryArray, rows: np.ndarray,
                 device=None) -> Dict[str, np.ndarray]:
    """{'area', 'length', 'cx', 'cy'} f64 arrays through ``geom_unary``
    (centroids shifted back into the global frame in f64)."""
    rows = np.asarray(rows, dtype=np.int64)
    with _LOCK:
        STATS["unary_calls"] += 1
    if len(rows) == 0:
        z = np.zeros(0, dtype=np.float64)
        return {"area": z, "length": z.copy(), "cx": z.copy(),
                "cy": z.copy()}
    p = pack_features(arr, rows, device)
    area, length, cx, cy = (t.cpu().numpy() for t in _kgeom.geom_unary(
        *p.rows(*UNARY)))
    n = p.n
    return {
        "area": area.astype(np.float64),
        "length": length.astype(np.float64),
        "cx": cx.astype(np.float64) + p.ref[:n, 0],
        "cy": cy.astype(np.float64) + p.ref[:n, 1],
    }


def batch_distance(arr: geo.GeometryArray, rows: np.ndarray,
                   literal: tuple, device=None) -> np.ndarray:
    """(len(rows),) f64 kernel distances (documented tol: ≤ 2e-4 + 1e-5·d
    against the exact oracle — boundary-sliver rows read ≤ the band
    instead of 0)."""
    rows = np.asarray(rows, dtype=np.int64)
    with _LOCK:
        STATS["distance_calls"] += 1
    if len(rows) == 0:
        return np.zeros(0, dtype=np.float64)
    dev = resolve(device)
    ls, lp, lit_poly = pack_literal(literal, dev)
    parts = []
    for sub in _chunks(rows, ls.shape[0] + lp.shape[0], dev):
        p = pack_features(arr, sub, dev)
        d = _kgeom.geom_dist(*p.rows(*PAIR), ls, lp, lit_poly)
        parts.append(d.cpu().numpy().astype(np.float64))
    return np.concatenate(parts)


def batch_predicate(arr: geo.GeometryArray, rows: np.ndarray, op: str,
                    literal: tuple, device=None) -> np.ndarray:
    """Exact boolean predicate batch: ``geom_pred``'s bands, then the f64
    host oracle over the uncertain sliver.

    op: 'intersects' (symmetric), 'within' (literal contains feature),
    'contains' (feature contains literal). Boundary-inclusive throughout.
    """
    rows = np.asarray(rows, dtype=np.int64)
    if len(rows) == 0:
        return np.zeros(0, dtype=bool)
    code = _OP_CODE[op]
    dev = resolve(device)
    ls, lp, lit_poly = pack_literal(literal, dev)
    lit_ext = literal[0] not in (geo.POINT, geo.MULTIPOINT)
    cins, couts = [], []
    for sub in _chunks(rows, ls.shape[0] + lp.shape[0], dev):
        p = pack_features(arr, sub, dev)
        ci, co = _kgeom.geom_pred(*p.rows(*PAIR), ls, lp, code, lit_poly,
                                  lit_ext)
        cins.append(ci.cpu().numpy())
        couts.append(co.cpu().numpy())
    cin = np.concatenate(cins)
    cout = np.concatenate(couts)
    out = cin.copy()
    unc = ~cin & ~cout
    nunc = int(np.count_nonzero(unc))
    with _LOCK:
        STATS["predicate_calls"] += 1
        STATS["predicate_rows"] += len(rows)
        STATS["refined_rows"] += nunc
    if nunc:
        sub = rows[unc]
        if op == "intersects":
            out[unc] = oracle.intersects(arr, sub, literal)
        elif op == "within":
            out[unc] = oracle.contains_literal(arr, sub, literal)
        else:
            out[unc] = oracle.feature_contains(arr, sub, literal)
    return out


def _hull_list(hv, cnt, ok, ref, n: int, fallback) -> List[np.ndarray]:
    """Per-feature f64 hull vertex arrays from the gift wrap's outputs, the
    host's ``fallback(k)`` where a wrap did not close."""
    hv, cnt, ok = hv.cpu().numpy(), cnt.cpu().numpy(), ok.cpu().numpy()
    out = []
    for k in range(n):
        if ok[k] and cnt[k] >= 1:
            out.append(hv[k, : cnt[k]].astype(np.float64) + ref[k])
        else:
            with _LOCK:
                STATS["hull_host_fallbacks"] += 1
            out.append(fallback(k))
    return out


def kernel_hulls(arr: geo.GeometryArray, rows: np.ndarray,
                 device=None) -> List[np.ndarray]:
    """[(H_i, 2) f64 hull vertex arrays] through the gift wrap, the host
    oracle's hull where a wrap did not close (f32 collinear ties)."""
    rows = np.asarray(rows, dtype=np.int64)
    with _LOCK:
        STATS["hull_calls"] += 1
    if len(rows) == 0:
        return []
    p = pack_features(arr, rows, device)
    hv, cnt, ok = _hull_plain(*p.rows("verts", "vmask"))
    return _hull_list(hv, cnt, ok, p.ref, p.n,
                      lambda k: oracle.convex_hull_of(arr, int(rows[k])))


def kernel_buffers(arr: geo.GeometryArray, rows: np.ndarray, d: float,
                   device=None) -> List[np.ndarray]:
    """[(H_i, 2) f64 octagonal-buffer hull vertex arrays] (the oracle's
    vertex-offset buffer's bound plus the f32 hull tolerance)."""
    rows = np.asarray(rows, dtype=np.int64)
    if len(rows) == 0:
        return []
    p = pack_features(arr, rows, device)
    offs = torch.from_numpy(oracle.octagon_offsets(d).astype(np.float32)
                            ).to(p.verts.device)
    verts, vmask = p.rows("verts", "vmask")
    B, K = vmask.shape
    swept = _add(_z(verts)[:, :, None, :], _z(offs)[None, None]
                 ).reshape(B, K * 8, 2)
    hv, cnt, ok = _hull_plain(swept, torch.repeat_interleave(vmask, 8,
                                                              dim=1))

    def fallback(k):
        shape = oracle.buffer_shapes(arr, [int(rows[k])], d)[0]
        return np.asarray(gn.literal_coords(shape))

    return _hull_list(hv, cnt, ok, p.ref, p.n, fallback)


def stats_snapshot() -> Dict[str, int]:
    with _LOCK:
        return dict(STATS)


# -- parity ------------------------------------------------------------------


def _hull_area(pts: np.ndarray) -> float:
    if len(pts) < 3:
        return 0.0
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * abs(float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)))


def parity_report(arr: geo.GeometryArray, rows: np.ndarray,
                  literal: tuple, d: float = 0.05,
                  device=None) -> Dict[str, int]:
    """Catalog-vs-oracle mismatch counts for every catalog function.

    Booleans compare strictly; scalars compare against per-feature forward
    error bounds computed in f64 from the kernel's own term magnitudes (the
    documented bounds). All axes pin 0.
    """
    rows = np.asarray(rows, dtype=np.int64)
    rep = {k: 0 for k in ("st_area", "st_length", "st_centroid",
                          "st_distance", "st_contains", "st_within",
                          "st_intersects", "st_convexhull", "st_buffer")}
    if len(rows) == 0:
        return rep
    u = unary_values(arr, rows, device)
    o_area = oracle.area(arr, rows)
    o_len = oracle.length(arr, rows)
    o_cx, o_cy = oracle.centroid(arr, rows)
    bb = arr.bboxes()[rows].astype(np.float64)
    ext = np.maximum(np.maximum(bb[:, 2] - bb[:, 0], bb[:, 3] - bb[:, 1]),
                     1e-12)
    mag = np.maximum(np.max(np.abs(bb), axis=1), 1.0)
    # per-feature forward bounds: K f32 ops over terms ≤ ext² (area),
    # ext (length) or ext³/area (centroid), plus the f32 input rounding of
    # shifted coords (≤ ext·2^-24 each)
    nseg = np.asarray([len(gn.feature_segments(arr, int(i))) + 1
                       for i in rows], dtype=np.float64)
    t_area = 64.0 * nseg * _EPS32 * ext * ext + 8.0 * nseg * _EPS32 * ext * mag
    t_len = 64.0 * nseg * _EPS32 * ext + 8.0 * nseg * _EPS32 * mag
    rep["st_area"] = int(np.sum(np.abs(u["area"] - o_area) > t_area))
    rep["st_length"] = int(np.sum(np.abs(u["length"] - o_len) > t_len))
    safe_a = np.maximum(o_area, oracle.AREAL_REL * ext * ext * 0.25)
    t_cen = (256.0 * nseg * _EPS32 * ext * ext * ext) / safe_a \
        + 64.0 * nseg * _EPS32 * ext + 1e-6
    rep["st_centroid"] = int(np.sum(
        np.maximum(np.abs(u["cx"] - o_cx), np.abs(u["cy"] - o_cy)) > t_cen))
    kd = batch_distance(arr, rows, literal, device)
    od = oracle.distance(arr, rows, literal)
    rep["st_distance"] = int(np.sum(
        np.abs(kd - od) > 2e-4 + 1e-5 * np.abs(od)))
    for name, op, ofn in (
            ("st_intersects", "intersects", oracle.intersects),
            ("st_within", "within", oracle.contains_literal),
            ("st_contains", "contains", oracle.feature_contains)):
        rep[name] = int(np.sum(batch_predicate(arr, rows, op, literal, device)
                               != ofn(arr, rows, literal)))
    hulls = kernel_hulls(arr, rows, device)
    for k, i in enumerate(rows):
        oh = oracle.convex_hull_of(arr, int(i))
        tol = 512.0 * _EPS32 * ext[k] * ext[k] + 1e-10
        if abs(_hull_area(hulls[k]) - _hull_area(oh)) > tol:
            rep["st_convexhull"] += 1
    bufs = kernel_buffers(arr, rows, d, device)
    oshapes = oracle.buffer_shapes(arr, rows, d)
    for k in range(len(rows)):
        oc = np.asarray(gn.literal_coords(oshapes[k]))
        e = ext[k] + 2.0 * d * oracle.BUFFER_SEC
        tol = 512.0 * _EPS32 * e * e + 1e-10
        if abs(_hull_area(bufs[k]) - _hull_area(oc)) > tol:
            rep["st_buffer"] += 1
    return rep
