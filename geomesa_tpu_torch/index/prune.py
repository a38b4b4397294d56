"""Range-pruned scan planning (host side) and the block geometry both scan
paths share.

≙ ``geomesa_tpu.index.prune``: decompose a query region into at most
``MAX_RANGES`` key ranges (the reference's ``geomesa.scan.ranges.target``,
Z3IndexKeySpace.getRanges), turn them into row intervals of the index's
sorted order by binary search over the host-resident sorted key arrays, and
then into fixed-size *blocks* of ``BLOCK_SIZE`` rows — small int32 ids the
device turns back into row indices, so a pruned scan ships a few hundred
ints instead of millions of row positions. The device re-applies the full
exact mask to the gathered blocks, so the cover only ever needs to be a
superset. The pruned path is taken while the candidates stay under
``PRUNE_MAX_FRACTION`` of the table.

``MAX_RANGES``/``BLOCK_SIZE``/``PRUNE_MAX_FRACTION`` resolve through the
config registry on every access (PEP 562), so ``GEOMESA_TPU_*`` variables
and ``config.*.set`` overrides apply at run time.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Tuple

import numpy as np

from geomesa_tpu_torch import config
from geomesa_tpu_torch.curves.binnedtime import max_offset, time_to_binned_time

_CONFIG_ATTRS = {
    "MAX_RANGES": config.SCAN_RANGES_TARGET,
    "BLOCK_SIZE": config.PRUNE_BLOCK,
    "PRUNE_MAX_FRACTION": config.PRUNE_MAX_FRACTION,
}


def __getattr__(name: str):
    prop = _CONFIG_ATTRS.get(name)
    if prop is None:
        raise AttributeError(name)
    return prop.get()


# cap on per-query interval decomposition (bins), mirroring the reference's
# per-epoch range decomposition limits
MAX_BINS = 512


def ranges_to_slices(sorted_keys: np.ndarray, ranges, lo: int = 0,
                     hi: Optional[int] = None) -> np.ndarray:
    """Inclusive key ranges → [lo, hi) row slices via binary search over
    one contiguous segment of a sorted key array. Returns (S, 2) int64.
    ``ranges``: the (lo, hi, ...) arrays of ``ranges_arrays`` (Z2, Z3), or
    a list of ``IndexRange`` (the XZ curves' covers)."""
    if hi is None:
        hi = len(sorted_keys)
    if isinstance(ranges, tuple) and len(ranges) >= 2 \
            and isinstance(ranges[0], np.ndarray):
        lowers, uppers = ranges[0], ranges[1]
    else:
        lowers = np.fromiter((r.lower for r in ranges), np.int64, len(ranges))
        uppers = np.fromiter((r.upper for r in ranges), np.int64, len(ranges))
    if len(lowers) == 0 or lo >= hi:
        return np.empty((0, 2), dtype=np.int64)
    seg = sorted_keys[lo:hi]
    starts = np.searchsorted(seg, lowers, side="left") + lo
    stops = np.searchsorted(seg, uppers, side="right") + lo
    keep = stops > starts
    return np.stack([starts[keep], stops[keep]], axis=1)


def slices_to_blocks(slices: np.ndarray, n_rows: int,
                     block_size: Optional[int] = None) -> Optional[np.ndarray]:
    """Row slices → sorted unique block ids (int32); None when there are no
    slices. ``block_size`` defaults to the current ``BLOCK_SIZE``."""
    if block_size is None:
        block_size = sys.modules[__name__].BLOCK_SIZE
    if len(slices) == 0:
        return None
    last = max(0, (n_rows - 1) // block_size)
    lo_b = np.minimum(slices[:, 0] // block_size, last)
    hi_b = np.minimum((slices[:, 1] - 1) // block_size, last)
    counts = (hi_b - lo_b + 1)
    total = int(counts.sum())
    # expand each [lo_b, hi_b] run with a ragged iota
    offsets = np.repeat(np.cumsum(counts) - counts, counts)
    ids = np.repeat(lo_b, counts) + (np.arange(total) - offsets)
    return np.unique(ids).astype(np.int32)


def candidate_stats(slices: np.ndarray, blocks: Optional[np.ndarray],
                    n_rows: int, block_size: Optional[int] = None) -> dict:
    """Explain payload for a pruned plan."""
    if block_size is None:
        block_size = sys.modules[__name__].BLOCK_SIZE
    rows = int((slices[:, 1] - slices[:, 0]).sum()) if len(slices) else 0
    nb = 0 if blocks is None else len(blocks)
    return {
        "candidate_rows": rows,
        "candidate_blocks": nb,
        "scanned_rows": nb * block_size,
        "scanned_fraction": round(nb * block_size / max(1, n_rows), 5),
    }


def bin_windows(intervals, period) -> Optional[List[Tuple[int, Tuple[int, int]]]]:
    """Time intervals → per-bin in-bin offset windows [(bin, (t_lo, t_hi))],
    t in period offset units, inclusive (≙ Z3IndexKeySpace.getIndexValues'
    per-epoch decomposition). None past ``MAX_BINS`` bins: the caller scans
    unpruned."""
    out: List[Tuple[int, Tuple[int, int]]] = []
    mo = max_offset(period) - 1
    for lo, hi in intervals:
        blo, olo = time_to_binned_time(int(lo), period)
        bhi, ohi = time_to_binned_time(int(hi), period)
        blo, olo, bhi, ohi = int(blo), int(olo), int(bhi), int(ohi)
        if bhi - blo + 1 > MAX_BINS or len(out) + (bhi - blo + 1) > MAX_BINS:
            return None
        for b in range(blo, bhi + 1):
            t0 = olo if b == blo else 0
            t1 = ohi if b == bhi else mo
            out.append((b, (t0, min(t1, mo))))
    return out


class BinSegments:
    """Per-bin contiguous row segments of an epoch-major sorted index (one
    linear pass over the sorted bins array)."""

    def __init__(self, sorted_bins: np.ndarray):
        bins = np.asarray(sorted_bins)
        if len(bins) == 0:
            self.bins = np.empty(0, np.int64)
            self.starts = np.zeros(1, np.int64)
            return
        change = np.flatnonzero(np.diff(bins)) + 1
        self.bins = np.concatenate([[bins[0]], bins[change]]).astype(np.int64)
        self.starts = np.concatenate(
            [[0], change, [len(bins)]]).astype(np.int64)

    def segment(self, b: int) -> Tuple[int, int]:
        """[lo, hi) rows of bin ``b`` (empty slice when absent)."""
        i = int(np.searchsorted(self.bins, b))
        if i == len(self.bins) or self.bins[i] != b:
            return 0, 0
        return int(self.starts[i]), int(self.starts[i + 1])

    def all_bins(self) -> np.ndarray:
        return self.bins
