"""Device refine of extent×extent join candidate pairs (≙
``geomesa_tpu.parallel.pair_kernel``, its single-device half).

≙ the compute half of the reference's partition join: GeoMesaJoinRelation
evaluates the JTS predicate per candidate pair inside the executors
(GeoMesaJoinRelation.scala:41-56). Here each candidate pair (left geometry,
right geometry) evaluates INTERSECTS in f32 with certified error bands on
the card (the ``pair_band`` kernel): certain-hit / certain-miss decisions
are exact, and only the uncertain sliver refines on the host in f64.

Data layout (the reference's): each side's unique geometries become one
padded segment table ``(G, S, 4)`` (S = pow2 of the max boundary-segment
count) plus per-geometry segment counts, uploaded once; the pairs are int32
index vectors into those tables, and the kernel gathers. The pair vectors
pad to the reference's chunked dispatch shape (``_chunk_size``), so the
packed verdicts equal the reference's byte for byte; the kernel takes them
in one launch (it builds no (chunk, Ls, Rs) intermediates).

Intersects per pair, all band-certified (``_band_core``):
  hit  = any real segment pair certainly crosses
         OR (right is polygonal AND left's first vertex certainly inside)
         OR (left is polygonal AND right's first vertex certainly inside)
  miss = every real segment pair certainly misses
         AND (right not polygonal OR left's first vertex certainly outside
              and left is single-part)
         AND (left not polygonal OR right's first vertex certainly outside
              and right is single-part)
  else uncertain → host exact refine (filter/geom_batch).

The bands are ``index/scan.py``'s, unfused and unflushed. That is the
reference's arithmetic here: XLA contracts ``_orient_band`` into fused
multiply-adds when it is jitted alone, but not inside ``_pair_fn`` (its
verdicts at pairs on a band's edge are the unfused band's,
``tests/test_torch_extent_join.py``), and flushing subnormals changes no
certified verdict.

``padded_segment_table`` returns None where the reference's does (a point
geometry, or more than ``MAX_SEGMENTS`` segments): the reference's own
decline, after which the join refines every pair on the host. Sharding the
pair axis over a mesh (``mesh_join_pairs``) comes with multi-GPU (ROADMAP.md
Queue 1, item 14) and raises here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from geomesa_tpu_torch.arith import pow2
from geomesa_tpu_torch.features import geometry as geo
from geomesa_tpu_torch.filter import geom_batch
from geomesa_tpu_torch.index.api import not_ported
from geomesa_tpu_torch.index.device import resolve
from geomesa_tpu_torch.index.scan import _pip_band, _segpair_band
from geomesa_tpu_torch.kernels import pair_band as _kpair

# largest per-geometry boundary segment count the device path accepts;
# pairs involving bigger geometries refine on host (they are rare and one
# giant geometry would inflate every pair's padded shape)
MAX_SEGMENTS = 512
# the reference's pair-chunk dispatch shape budget: the pair vectors pad to
# a whole number of its chunks
_CHUNK_BUDGET = 1 << 26
# (pair, left segment, right segment) elements per chunk of the plain
# version: bounds its band temporaries
_PLAIN_BUDGET = 1 << 24

_BITS = (128, 64, 32, 16, 8, 4, 2, 1)


def padded_segment_table(arr: geo.GeometryArray, ids: np.ndarray
                         ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                             np.ndarray, np.ndarray]]:
    """((G, S, 4) f32 padded segments, (G,) int32 counts, (G,) bool
    polygonal, (G,) bool single-part) for the selected geometries, or None
    when any geometry is segment-free (points) or exceeds MAX_SEGMENTS —
    callers refine on the host.

    ``single-part`` drives the miss certification: "first vertex certainly
    outside + no boundary crossing ⇒ disjoint" is only sound for a
    CONNECTED geometry (a polygon's holes don't break connectivity of the
    filled region, but a MULTI* geometry's disconnected parts do — a
    non-first part could sit wholly inside the other geometry).
    """
    ids = np.asarray(ids, dtype=np.int64)
    segs, fid = geom_batch.build_segments(arr, ids)
    counts = np.bincount(fid, minlength=len(ids)).astype(np.int32)
    if len(ids) == 0 or counts.min() == 0 or counts.max() > MAX_SEGMENTS:
        return None
    s_cap = pow2(int(counts.max()))
    g_cap = pow2(len(ids))  # pow2 geometry axis: stable jit signatures
    out = np.zeros((g_cap, s_cap, 4), dtype=np.float32)
    pos = np.arange(len(fid)) - np.repeat(
        np.cumsum(counts) - counts, counts)
    out[fid, pos] = segs.astype(np.float32)
    cnt = np.zeros(g_cap, dtype=np.int32)
    cnt[: len(ids)] = counts
    poly = np.zeros(g_cap, dtype=bool)
    poly[: len(ids)] = np.isin(arr.type_codes[ids],
                               (geo.POLYGON, geo.MULTIPOLYGON))
    single = np.zeros(g_cap, dtype=bool)
    single[: len(ids)] = (arr.geom_offsets[ids + 1]
                          - arr.geom_offsets[ids]) == 1
    return out, cnt, poly, single


def _chunk_size(s_l: int, s_r: int) -> int:
    ch = int(np.clip(_CHUNK_BUDGET // max(1, s_l * s_r), 1024, 1 << 20))
    # whole bytes of packed verdicts a chunk, whatever the budget
    return max(8, ch & ~7)


# -- the plain version ------------------------------------------------------------


def _band_core(ls, lc, lpoly, lsingle, rs, rc, rpoly, rsingle):
    """Padded pair segments → (certain_hit, uncertain), (P,) bools (≙ the
    reference's ``_band_core``, on ``index/scan.py``'s bands).

    ls: (P, Ls, 4) f32   lc: (P,) int32   lpoly/lsingle: (P,) bool
    rs: (P, Rs, 4) f32   rc: (P,) int32   rpoly/rsingle: (P,) bool
    Padded segments are masked out of both the hit and the uncertainty
    reductions, so padding never flips a verdict; multi-part pairs that are
    not certain hits stay uncertain (miss certification needs a connected
    geometry)."""
    dev = ls.device
    lv = torch.arange(ls.shape[1], device=dev)[None, :] < lc[:, None]
    rv = torch.arange(rs.shape[1], device=dev)[None, :] < rc[:, None]
    ax, ay, bx, by = ls.unbind(-1)
    cx, cy, dx, dy = rs.unbind(-1)
    hit_p, miss_p = _segpair_band(
        ax[:, :, None], ay[:, :, None], bx[:, :, None], by[:, :, None],
        cx[:, None, :], cy[:, None, :], dx[:, None, :], dy[:, None, :])
    pv = lv[:, :, None] & rv[:, None, :]
    any_hit = (hit_p & pv).flatten(1).any(dim=1)
    all_miss = (miss_p | ~pv).flatten(1).all(dim=1)
    l_in, l_out = _pip_band(ax[:, 0:1], ay[:, 0:1], cx, cy, dx, dy,
                            evalid=rv)
    r_in, r_out = _pip_band(cx[:, 0:1], cy[:, 0:1], ax, ay, bx, by,
                            evalid=lv)
    hit = any_hit | (rpoly & l_in) | (lpoly & r_in)
    miss = (all_miss
            & (~rpoly | (l_out & lsingle))
            & (~lpoly | (r_out & rsingle)))
    return hit, ~hit & ~miss


def _packbits(bits: torch.Tensor) -> torch.Tensor:
    """``np.packbits``: 8 bools a byte, the first the most significant
    bit; the tail byte zero-padded."""
    pad = (-bits.shape[0]) % 8
    b = torch.cat([bits, bits.new_zeros(pad)]).view(-1, 8).to(torch.uint8)
    w = torch.tensor(_BITS, dtype=torch.uint8, device=bits.device)
    return (b * w).sum(dim=1).to(torch.uint8)


def pair_plain(lsegs, lcnt, lpoly, lsingle, rsegs, rcnt, rpoly, rsingle,
               pl, pr) -> torch.Tensor:
    """(2, ceil(P/8)) uint8 packed verdicts of the pairs (``pl``, ``pr``)
    (row 0 certain hits, row 1 uncertain; a -1 in ``pl`` is a pad: both
    bits 0), gathered from the two padded segment tables (≙ the reference's
    ``_pair_fn``, its chunks' bits concatenated). The plain PyTorch version
    of the ``pair_band`` kernel: the CPU path, and the kernel's yardstick
    on the card. Pairs run in chunks of whole bytes so the band temporaries
    stay bounded."""
    n = int(pl.shape[0])
    ch = max(8, (_PLAIN_BUDGET // max(1, lsegs.shape[1] * rsegs.shape[1]))
             & ~7)
    hits, uncs = [], []
    for a in range(0, n, ch):
        l, r = pl[a:a + ch], pr[a:a + ch]
        valid = l >= 0
        l = l.clamp(0, lsegs.shape[0] - 1).long()
        r = r.clamp(0, rsegs.shape[0] - 1).long()
        hit, unc = _band_core(lsegs[l], lcnt[l], lpoly[l], lsingle[l],
                              rsegs[r], rcnt[r], rpoly[r], rsingle[r])
        hits.append(hit & valid)
        uncs.append(unc & valid)
    if not hits:
        return torch.zeros((2, 0), dtype=torch.uint8, device=pl.device)
    return torch.stack([_packbits(torch.cat(hits)),
                        _packbits(torch.cat(uncs))])


# -- the entry points ---------------------------------------------------------------


class PreparedPairRefine:
    """Pair refine with every input staged on the device (the prepared-query
    pattern applied to the join: geometry tables + padded pair index vectors
    upload once, re-dispatches pay only the kernel + the packed verdict
    readback)."""

    def __init__(self, d_l, d_r, d_pl, d_pr, n: int, device: torch.device):
        self._d_l = d_l
        self._d_r = d_r
        self._d_pl = d_pl
        self._d_pr = d_pr
        self.n = n
        self.device = device

    def dispatch(self) -> torch.Tensor:
        """ONE (2, P/8) packed uint8 tensor on the device (row 0 = hits,
        row 1 = uncertain), P the padded pair count: one launch."""
        if self.n == 0:
            return torch.zeros((2, 0), dtype=torch.uint8, device=self.device)
        return _kpair.pair_band(*self._d_l, *self._d_r, self._d_pl,
                                self._d_pr)

    def __call__(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.n == 0:
            return np.zeros(0, dtype=bool), np.zeros(0, dtype=bool)
        packed = self.dispatch().cpu().numpy()
        hit = np.unpackbits(packed[0])[: self.n]
        unc = np.unpackbits(packed[1])[: self.n]
        return hit.astype(bool), unc.astype(bool)


def prepare_refine(left: geo.GeometryArray, right: geo.GeometryArray,
                   li: np.ndarray, rj: np.ndarray, device=None
                   ) -> Optional[PreparedPairRefine]:
    """Stage an INTERSECTS pair-refine on ``device`` (the card unless the
    caller names another), or None when the workload doesn't fit the
    device path (point/oversized geometries: the reference's decline)."""
    dev = resolve(device)
    n = len(li)
    if n == 0:  # a legitimately empty join is not "unsupported"
        return PreparedPairRefine([], [], None, None, 0, dev)
    ul, inv_l = np.unique(li, return_inverse=True)
    ur, inv_r = np.unique(rj, return_inverse=True)
    lt = padded_segment_table(left, ul)
    rt = padded_segment_table(right, ur)
    if lt is None or rt is None:
        return None
    d_l = [torch.from_numpy(a).to(dev) for a in lt]
    d_r = [torch.from_numpy(a).to(dev) for a in rt]
    ch = _chunk_size(lt[0].shape[1], rt[0].shape[1])
    total = -(-n // ch) * ch
    pl = np.full(total, -1, dtype=np.int32)
    pr = np.zeros(total, dtype=np.int32)
    pl[:n] = inv_l
    pr[:n] = inv_r
    return PreparedPairRefine(d_l, d_r, torch.from_numpy(pl).to(dev),
                              torch.from_numpy(pr).to(dev), n, dev)


def device_refine(left: geo.GeometryArray, right: geo.GeometryArray,
                  li: np.ndarray, rj: np.ndarray, device=None
                  ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Evaluate INTERSECTS for candidate pairs on the device.

    Returns (certain_hit bool (P,), uncertain bool (P,)) — uncertain pairs
    need the host's exact f64 refine. None when the workload shape doesn't
    fit the device path (point geometries / oversized geometries); callers
    refine everything on the host.
    """
    prep = prepare_refine(left, right, li, rj, device)
    return None if prep is None else prep()


def mesh_join_pairs(mesh, left: geo.GeometryArray, right: geo.GeometryArray,
                    li: np.ndarray, rj: np.ndarray):
    """The reference's pair refine over a device mesh (the pair axis
    sharded, psum'd hit counts): it comes with multi-GPU."""
    raise not_ported("mesh_join_pairs (the pair refine over a mesh)", 14)
