"""Extent × extent spatial join: grid partition → bbox pair generation →
device band refine → exact host refine of the uncertain sliver (≙
``geomesa_tpu.parallel.extent_join``, host numpy by copy).

≙ the reference's Spark join machinery: `RelationUtils` spatial partitioning
(grid / weighted, RelationUtils.scala:85-160) feeding the per-partition
sweepline overlap join (GeoMesaJoinRelation.scala:41-56, JTS SweepLineIndex
+ predicate evaluate). Here:

  - both sides' envelopes land on a density-sized grid; each geometry fans
    out to every cell its bbox overlaps (duplicate-and-own: a candidate pair
    is emitted only by the cell that contains the max of the two bbox min
    corners, the standard dedup that avoids a global unique pass)
  - candidate pairs stream out in bounded chunks (never a monolithic
    materialization — an overlap-heavy workload degrades to more chunks,
    not an error), filtered by envelope overlap — the moral equivalent of
    the sweepline, O(pairs) after gridding
  - surviving pairs refine on the card with the certified f32 band kernel
    (``parallel.pair_kernel``, ``pair_band``), leaving only the uncertain
    sliver for the host's exact f64 geometry soups (filter/geom_batch),
    grouped by right-hand geometry so each group is one batched evaluation;
    where the pair kernel declines (a point geometry, or more than 512
    segments), every pair refines on the host, as in the reference

Partitioned variant: row-band partitioning of the grid, each band an
independent join (the unit the reference shards over a mesh; that half
comes with multi-GPU, ROADMAP.md Queue 1 item 14)."""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

from geomesa_tpu_torch import config
from geomesa_tpu_torch import trace as _trace
from geomesa_tpu_torch.features import geometry as geo
from geomesa_tpu_torch.filter import geom_batch
from geomesa_tpu_torch.parallel import pair_kernel

# memory bound per candidate-pair chunk (NOT a failure cap: bigger joins
# stream through more chunks)
MAX_CANDIDATE_PAIRS = 50_000_000


def _cell_ranges(bb: np.ndarray, origin, csize, gx, gy):
    """Per-geometry inclusive grid-cell ranges covered by each bbox."""
    ix0 = np.clip(((bb[:, 0] - origin[0]) / csize[0]).astype(np.int64), 0, gx - 1)
    iy0 = np.clip(((bb[:, 1] - origin[1]) / csize[1]).astype(np.int64), 0, gy - 1)
    ix1 = np.clip(((bb[:, 2] - origin[0]) / csize[0]).astype(np.int64), 0, gx - 1)
    iy1 = np.clip(((bb[:, 3] - origin[1]) / csize[1]).astype(np.int64), 0, gy - 1)
    return ix0, iy0, ix1, iy1


def _fanout(ix0, iy0, ix1, iy1, gx):
    """(geom id, cell id) pairs for every covered cell (ragged iota)."""
    nx = ix1 - ix0 + 1
    ny = iy1 - iy0 + 1
    counts = nx * ny
    total = int(counts.sum())
    gid = np.repeat(np.arange(len(counts)), counts)
    local = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    lx = local % np.repeat(nx, counts)
    ly = local // np.repeat(nx, counts)
    cell = (np.repeat(iy0, counts) + ly) * gx + (np.repeat(ix0, counts) + lx)
    return gid, cell


def candidate_pair_chunks(lbb: np.ndarray, rbb: np.ndarray,
                          grid: Optional[Tuple[int, int]] = None,
                          chunk_pairs: int = MAX_CANDIDATE_PAIRS
                          ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Stream (li, rj) candidate-pair chunks whose envelopes overlap,
    deduplicated via cell ownership. Each yielded chunk materializes at most
    ~``chunk_pairs`` raw pairs, so overlap-heavy workloads degrade to more
    chunks instead of raising (the reference never throws on join size; it
    partitions harder — RelationUtils weighted partitioning)."""
    if len(lbb) == 0 or len(rbb) == 0:
        return
    xmin = min(lbb[:, 0].min(), rbb[:, 0].min())
    ymin = min(lbb[:, 1].min(), rbb[:, 1].min())
    xmax = max(lbb[:, 2].max(), rbb[:, 2].max())
    ymax = max(lbb[:, 3].max(), rbb[:, 3].max())
    if grid is None:
        g = int(np.clip(np.sqrt((len(lbb) + len(rbb)) / 4.0), 1, 1024))
        grid = (g, g)
    gx, gy = grid
    csize = (max((xmax - xmin) / gx, 1e-9), max((ymax - ymin) / gy, 1e-9))
    origin = (xmin, ymin)

    l0x, l0y, l1x, l1y = _cell_ranges(lbb, origin, csize, gx, gy)
    r0x, r0y, r1x, r1y = _cell_ranges(rbb, origin, csize, gx, gy)
    lg, lc = _fanout(l0x, l0y, l1x, l1y, gx)
    rg, rc = _fanout(r0x, r0y, r1x, r1y, gx)

    # sort right entries by cell; for each left entry expand the right run
    # of its cell (ragged cross product per cell)
    order = np.argsort(rc, kind="stable")
    rc_s, rg_s = rc[order], rg[order]
    starts = np.searchsorted(rc_s, lc, side="left")
    stops = np.searchsorted(rc_s, lc, side="right")
    counts = stops - starts
    cum = np.cumsum(counts)
    total = int(cum[-1]) if len(cum) else 0
    if total == 0:
        return
    # split left-fanout entries into runs of <= chunk_pairs raw pairs
    cuts = [0]
    while cuts[-1] < len(counts):
        base = int(cum[cuts[-1] - 1]) if cuts[-1] else 0
        nxt = int(np.searchsorted(cum, base + chunk_pairs, side="right"))
        nxt = max(nxt, cuts[-1] + 1)  # always advance (one entry may exceed)
        cuts.append(min(nxt, len(counts)))

    for a, b in zip(cuts[:-1], cuts[1:]):
        cnt = counts[a:b]
        n = int(cnt.sum())
        if n == 0:
            continue
        li = np.repeat(lg[a:b], cnt)
        pos = np.arange(n) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        rj = rg_s[np.repeat(starts[a:b], cnt) + pos]
        cell = np.repeat(lc[a:b], cnt)

        # envelope overlap + ownership dedup (the cell holding the pair's
        # max-of-mins corner owns it)
        lb = lbb[li]
        rb = rbb[rj]
        overlap = ((lb[:, 0] <= rb[:, 2]) & (lb[:, 2] >= rb[:, 0])
                   & (lb[:, 1] <= rb[:, 3]) & (lb[:, 3] >= rb[:, 1]))
        ox = np.maximum(lb[:, 0], rb[:, 0])
        oy = np.maximum(lb[:, 1], rb[:, 1])
        own_cell = (np.clip(((oy - origin[1]) / csize[1]).astype(np.int64),
                            0, gy - 1) * gx
                    + np.clip(((ox - origin[0]) / csize[0]).astype(np.int64),
                              0, gx - 1))
        keep = overlap & (own_cell == cell)
        if keep.any():
            yield li[keep], rj[keep]


def candidate_pairs(lbb: np.ndarray, rbb: np.ndarray,
                    grid: Optional[Tuple[int, int]] = None):
    """(li, rj) candidate pairs whose envelopes overlap (all chunks
    concatenated — the streaming form is ``candidate_pair_chunks``)."""
    out = list(candidate_pair_chunks(lbb, rbb, grid))
    if not out:
        return (np.empty(0, np.int64),) * 2
    return (np.concatenate([c[0] for c in out]),
            np.concatenate([c[1] for c in out]))


def _host_refine_mask(left: geo.GeometryArray, right: geo.GeometryArray,
                      li: np.ndarray, rj: np.ndarray, fn) -> np.ndarray:
    """Exact f64 predicate per pair, batched per distinct right geometry
    (each group is one geom_batch soup evaluation). Returns bool (P,)."""
    mask = np.zeros(len(li), dtype=bool)
    if len(li) == 0:
        return mask
    order = np.argsort(rj, kind="stable")
    rj_s = rj[order]
    bounds = np.flatnonzero(np.diff(rj_s)) + 1
    for seg_pos, j in zip(np.split(order, bounds),
                          rj_s[np.concatenate([[0], bounds])]):
        mask[seg_pos] = fn(left, li[seg_pos], right.shape(int(j)))
    return mask


def _refine_chunk(left: geo.GeometryArray, right: geo.GeometryArray,
                  li: np.ndarray, rj: np.ndarray, predicate: str,
                  device: str, torch_device=None) -> np.ndarray:
    """Exact hit mask for one candidate chunk: device band kernel first
    (when it applies), host f64 for the uncertain sliver / fallback."""
    fn = geom_batch.batch_intersects if predicate == "intersects" \
        else geom_batch.batch_within
    use_device = (predicate == "intersects" and device != "never"
                  and (device == "always"
                       or len(li) >= config.JOIN_DEVICE_MIN_PAIRS.get()))
    if use_device:
        with _trace.span("device_scan", kind="device_scan", pairs=len(li)):
            out = pair_kernel.device_refine(left, right, li, rj,
                                            torch_device)
        if out is not None:
            hit, unc = out
            if unc.any():
                u = np.flatnonzero(unc)
                hit = hit.copy()
                with _trace.span("refine", kind="refine", pairs=len(u)):
                    hit[u] = _host_refine_mask(left, right, li[u], rj[u], fn)
            return hit
    with _trace.span("refine", kind="refine", pairs=len(li)):
        return _host_refine_mask(left, right, li, rj, fn)


def extent_join(left: geo.GeometryArray, right: geo.GeometryArray,
                predicate: str = "intersects",
                grid: Optional[Tuple[int, int]] = None,
                device: str = "auto", torch_device=None):
    """Exact extent×extent join → (left ids, right ids) of matching pairs.

    Candidate pairs stream from the grid partitioner in bounded chunks;
    each chunk refines on the device (certified f32 bands, INTERSECTS) with
    host f64 only for the uncertain sliver — or fully on host for small
    chunks / WITHIN / unsupported shapes. ``device``: "auto" (size
    threshold, config JOIN_DEVICE_MIN_PAIRS), "always", "never".
    ``torch_device``: where the band kernel runs (the card unless the
    caller names another).
    """
    if predicate not in ("intersects", "within"):
        raise ValueError(f"Unsupported join predicate {predicate!r}")
    with _trace.trace("extent_join", predicate=predicate,
                      left=len(left), right=len(right)):
        out_l: List[np.ndarray] = []
        out_r: List[np.ndarray] = []
        it = candidate_pair_chunks(left.bboxes(), right.bboxes(), grid)
        while True:
            # pull each candidate chunk under range_decompose — the grid
            # partitioner's work happens lazily inside the generator
            with _trace.span("range_decompose", kind="range_decompose"):
                chunk = next(it, None)
            if chunk is None:
                break
            li, rj = chunk
            hit = _refine_chunk(left, right, li, rj, predicate, device,
                                torch_device)
            out_l.append(li[hit])
            out_r.append(rj[hit])
        if not out_l:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        with _trace.span("aggregate", kind="aggregate"):
            la = np.concatenate(out_l)
            ra = np.concatenate(out_r)
            order = np.lexsort((ra, la))
            return la[order], ra[order]


def extent_join_partitioned(left: geo.GeometryArray,
                            right: geo.GeometryArray,
                            n_partitions: int = 8,
                            predicate: str = "intersects",
                            device: str = "auto", torch_device=None):
    """Band-partitioned join: the grid's y-extent splits into bands, each an
    independent join over the geometries overlapping it (geometries fan out
    to every band they touch; pair ownership dedups at the band of the
    max-of-mins corner). This is the shuffle unit for a device mesh — each
    band's refine is independent work (≙ one Spark partition)."""
    lbb, rbb = left.bboxes(), right.bboxes()
    if len(lbb) == 0 or len(rbb) == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    ymin = min(lbb[:, 1].min(), rbb[:, 1].min())
    ymax = max(lbb[:, 3].max(), rbb[:, 3].max())
    h = max((ymax - ymin) / n_partitions, 1e-9)
    out_l, out_r = [], []
    for b in range(n_partitions):
        y0 = ymin + b * h
        y1 = ymin + (b + 1) * h
        lsel = np.flatnonzero((lbb[:, 3] >= y0) & (lbb[:, 1] <= y1))
        rsel = np.flatnonzero((rbb[:, 3] >= y0) & (rbb[:, 1] <= y1))
        if len(lsel) == 0 or len(rsel) == 0:
            continue
        la, ra = extent_join(left.take(lsel), right.take(rsel), predicate,
                             device=device, torch_device=torch_device)
        if len(la) == 0:
            continue
        gl, gr = lsel[la], rsel[ra]
        # band ownership: the pair belongs to the band of its overlap's ymin
        oy = np.maximum(lbb[gl, 1], rbb[gr, 1])
        own = np.clip(((oy - ymin) / h).astype(np.int64), 0, n_partitions - 1)
        keep = own == b
        out_l.append(gl[keep])
        out_r.append(gr[keep])
    if not out_l:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    la = np.concatenate(out_l)
    ra = np.concatenate(out_r)
    order = np.lexsort((ra, la))
    return la[order], ra[order]
