"""Host-side z-range cover: decompose integer query boxes into Morton ranges.

≙ ``geomesa_tpu.curves.ranges`` (the reference's from-scratch take on
sfcurve's ``Z3.zranges``, Z3SFC.scala:61): a breadth-first octree traversal
that emits a z-interval for each tree cell fully contained in (or, at the
recursion budget, overlapping) any query box, then sort-merges adjacent
intervals. Host numpy, in the array form only: (lo, hi, contained) arrays
of inclusive z-intervals, at most ``max_ranges`` of them (default the
reference's ``geomesa.scan.ranges.target`` = 2000), which the range pruner
turns into candidate row blocks.

Only the 3-D cover of the Z3 index is here (Z2 is not ported). The
reference runs an equivalent C++ pass when its native library is built;
this is its numpy fallback, which gives the same ranges.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from geomesa_tpu_torch.curves import zorder


_EMPTY_COVER = (np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, bool))


def merge_range_arrays(lo: np.ndarray, hi: np.ndarray, cont: np.ndarray):
    """Sort and merge inclusive (lo, hi, contained) range arrays: merge when
    lower <= current.upper + 1; a merged range is contained only if all its
    inputs were (the sfcurve/XZ2SFC merge rule)."""
    if len(lo) == 0:
        return _EMPTY_COVER
    order = np.lexsort((hi, lo))
    lo, hi, cont = lo[order], hi[order], cont[order]
    cmax = np.maximum.accumulate(hi)
    new = np.empty(len(lo), bool)
    new[0] = True
    np.greater(lo[1:], cmax[:-1] + 1, out=new[1:])
    starts = np.flatnonzero(new)
    return (lo[starts], np.maximum.reduceat(hi, starts),
            np.logical_and.reduceat(cont, starts))


def _zranges_arrays(boxes: Sequence[Sequence[Tuple[int, int]]], bits: int,
                    max_ranges: int, max_levels: int):
    """3-D Morton cover → merged (lo, hi, contained) inclusive z-interval
    arrays covering the union of boxes.

    boxes: per-box, per-dim inclusive int bounds [(lo, hi), ...] in
    normalized int space. A level-synchronous vectorized BFS. Budget rule
    mirrors sfcurve's maxRanges stop: when expanding the next level would
    exceed the budget, remaining overlapping cells flush as coarse
    (uncontained) ranges.
    """
    if not boxes:
        return _EMPTY_COVER
    dims = 3
    max_levels = min(max_levels, bits)

    blo = np.array([[d[0] for d in b] for b in boxes], dtype=np.int64)  # (B,D)
    bhi = np.array([[d[1] for d in b] for b in boxes], dtype=np.int64)

    child_bits = np.array(
        [[(c >> d) & 1 for d in range(dims)] for c in range(1 << dims)],
        dtype=np.int64)  # (fan, D)

    out_lo: List[np.ndarray] = []
    out_hi: List[np.ndarray] = []
    out_cont: List[np.ndarray] = []

    def emit(cells: np.ndarray, level: int, contained: bool) -> None:
        if len(cells) == 0:
            return
        shift = bits - level
        lo_coords = cells << shift
        zlo = zorder.z3_encode(lo_coords[:, 0], lo_coords[:, 1],
                               lo_coords[:, 2]).astype(np.int64)
        out_lo.append(zlo)
        out_hi.append(zlo + ((1 << (dims * shift)) - 1))
        out_cont.append(np.full(len(cells), contained))

    cells = np.zeros((1, dims), dtype=np.int64)
    level = 0
    emitted = 0
    while len(cells):
        shift = bits - level
        clo = (cells << shift)[:, None, :]                 # (C,1,D)
        chi = (((cells + 1) << shift) - 1)[:, None, :]
        inside = ((blo[None] <= clo) & (chi <= bhi[None])).all(-1).any(-1)
        touches = ((chi >= blo[None]) & (clo <= bhi[None])).all(-1).any(-1)
        overlap = touches & ~inside

        emit(cells[inside], level, True)
        emitted += int(inside.sum())
        live = cells[overlap]
        n_live = len(live)
        if n_live == 0:
            break
        if level >= max_levels or emitted + n_live * (1 << dims) > max_ranges:
            emit(live, level, False)  # budget/depth stop: coarse cover
            break
        cells = ((live[:, None, :] << 1) | child_bits[None]).reshape(-1, dims)
        level += 1

    if not out_lo:
        return _EMPTY_COVER
    return merge_range_arrays(np.concatenate(out_lo), np.concatenate(out_hi),
                              np.concatenate(out_cont))


def zranges_3d_arrays(boxes, bits: int = 21, max_ranges: int = 2000,
                      max_levels: int = 64):
    """Array-form 3-D cover of boxes = (xlo, ylo, tlo, xhi, yhi, thi)
    inclusive normalized ints: merged (lo, hi, contained), consumed directly
    by ``index.prune.ranges_to_slices``."""
    return _zranges_arrays(
        [((xlo, xhi), (ylo, yhi), (tlo, thi))
         for xlo, ylo, tlo, xhi, yhi, thi in boxes],
        bits, max_ranges, max_levels)
