"""Host-side z-range cover: decompose integer query boxes into Morton ranges.

≙ ``geomesa_tpu.curves.ranges`` (the reference's from-scratch take on
sfcurve's ``Z2.zranges`` / ``Z3.zranges``, Z2SFC.scala:52, Z3SFC.scala:61):
a breadth-first quad/octree traversal that emits a z-interval for each tree
cell fully contained in (or, at the recursion budget, overlapping) any query
box, then sort-merges adjacent intervals. Host numpy: (lo, hi, contained)
arrays of inclusive z-intervals, at most ``max_ranges`` of them (default the
reference's ``geomesa.scan.ranges.target`` = 2000), which the range pruner
turns into candidate row blocks; ``IndexRange``/``merge_ranges`` are the
object form the XZ curves' covers use.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from geomesa_tpu_torch.curves import zorder


@dataclass(frozen=True)
class IndexRange:
    """Inclusive z-interval [lower, upper]; ``contained`` means every z in the
    interval satisfies the query box (no further filtering needed)."""

    lower: int
    upper: int
    contained: bool = False


def merge_ranges(ranges: List[IndexRange]) -> List[IndexRange]:
    """Sort and merge adjacent/overlapping ranges (sfcurve/XZ2SFC merge rule:
    merge when lower <= current.upper + 1; merged range is contained only if
    both inputs were)."""
    if not ranges:
        return []
    ranges = sorted(ranges, key=lambda r: (r.lower, r.upper))
    out: List[IndexRange] = []
    cur = ranges[0]
    for r in ranges[1:]:
        if r.lower <= cur.upper + 1:
            cur = IndexRange(cur.lower, max(cur.upper, r.upper), cur.contained and r.contained)
        else:
            out.append(cur)
            cur = r
    out.append(cur)
    return out


_EMPTY_COVER = (np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, bool))


def merge_range_arrays(lo: np.ndarray, hi: np.ndarray, cont: np.ndarray):
    """Vectorized sort+merge of inclusive (lo, hi, contained) range arrays
    (same rule as ``merge_ranges``; arrays in, arrays out — no per-range
    Python objects on the query-planning hot path)."""
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


def _zranges_arrays(
    boxes: Sequence[Sequence[Tuple[int, int]]],
    bits: int,
    dims: int,
    max_ranges: int,
    max_levels: int,
):
    """Generic D-dimensional Morton cover → merged (lo, hi, contained)
    inclusive z-interval arrays covering the union of boxes.

    boxes: per-box, per-dim inclusive int bounds [(lo, hi), ...] in
    normalized int space. The native C++ pass (``native.zranges``, the
    reference's ``gm_zranges``) runs unless ``GEOMESA_TPU_NO_NATIVE`` is
    set or its output would overflow; else a level-synchronous vectorized
    numpy BFS, which the C++ pass matches bit for bit. Budget rule mirrors
    sfcurve's maxRanges stop: when expanding the next level would exceed
    the budget, remaining overlapping cells flush as coarse (uncontained)
    ranges.
    """
    if not boxes:
        return _EMPTY_COVER
    interleave = {2: zorder.z2_encode, 3: zorder.z3_encode}[dims]
    max_levels = min(max_levels, bits)

    blo = np.array([[d[0] for d in b] for b in boxes], dtype=np.int64)  # (B,D)
    bhi = np.array([[d[1] for d in b] for b in boxes], dtype=np.int64)

    from geomesa_tpu_torch import native
    res = native.zranges(blo, bhi, dims, bits, max_ranges, max_levels)
    if res is not None:
        return res

    child_bits = np.array(
        [[(c >> d) & 1 for d in range(dims)] for c in range(1 << dims)],
        dtype=np.int64)  # (fan, D)

    out_lo: List[np.ndarray] = []
    out_hi: List[np.ndarray] = []
    out_cont: List[np.ndarray] = []

    def emit(cells: np.ndarray, level: int, contained: np.ndarray) -> None:
        if len(cells) == 0:
            return
        shift = bits - level
        lo_coords = cells << shift
        zlo = interleave(*(lo_coords[:, d] for d in range(dims))).astype(np.int64)
        out_lo.append(zlo)
        out_hi.append(zlo + ((1 << (dims * shift)) - 1))
        out_cont.append(np.broadcast_to(contained, (len(cells),)).copy()
                        if contained.ndim == 0 else contained)

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

        emit(cells[inside], level, np.True_)
        emitted += int(inside.sum())
        live = cells[overlap]
        n_live = len(live)
        if n_live == 0:
            break
        if level >= max_levels or emitted + n_live * (1 << dims) > max_ranges:
            emit(live, level, np.False_)  # budget/depth stop: coarse cover
            break
        cells = ((live[:, None, :] << 1) | child_bits[None]).reshape(-1, dims)
        level += 1

    if not out_lo:
        return _EMPTY_COVER
    return merge_range_arrays(np.concatenate(out_lo), np.concatenate(out_hi),
                              np.concatenate(out_cont))


def to_ranges(arrays) -> List[IndexRange]:
    """(lo, hi, contained) arrays → IndexRange list (the object-form API)."""
    lo, hi, cont = arrays
    return [IndexRange(int(l), int(h), bool(c))
            for l, h, c in zip(lo, hi, cont)]


def _reshape_2d(boxes):
    return [((xlo, xhi), (ylo, yhi)) for xlo, ylo, xhi, yhi in boxes]


def _reshape_3d(boxes):
    return [((xlo, xhi), (ylo, yhi), (tlo, thi))
            for xlo, ylo, tlo, xhi, yhi, thi in boxes]


def zranges_2d(
    boxes: Sequence[Tuple[int, int, int, int]],
    bits: int = 31,
    max_ranges: int = 2000,
    max_levels: int = 64,
) -> List[IndexRange]:
    """2-D cover. boxes = (xlo, ylo, xhi, yhi) inclusive normalized ints."""
    return to_ranges(zranges_2d_arrays(boxes, bits, max_ranges, max_levels))


def zranges_3d(
    boxes: Sequence[Tuple[int, int, int, int, int, int]],
    bits: int = 21,
    max_ranges: int = 2000,
    max_levels: int = 64,
) -> List[IndexRange]:
    """3-D cover. boxes = (xlo, ylo, tlo, xhi, yhi, thi) inclusive ints."""
    return to_ranges(zranges_3d_arrays(boxes, bits, max_ranges, max_levels))


def zranges_2d_arrays(boxes, bits: int = 31, max_ranges: int = 2000,
                      max_levels: int = 64):
    """Array-form 2-D cover: merged (lo, hi, contained) — the hot-path form
    consumed directly by prune.ranges_to_slices."""
    return _zranges_arrays(_reshape_2d(boxes), bits, 2, max_ranges, max_levels)


def zranges_3d_arrays(boxes, bits: int = 21, max_ranges: int = 2000,
                      max_levels: int = 64):
    """Array-form 3-D cover: merged (lo, hi, contained)."""
    return _zranges_arrays(_reshape_3d(boxes), bits, 3, max_ranges, max_levels)
