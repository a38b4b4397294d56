"""XZ-ordering curves for geometries with extent (lines/polygons).

≙ ``geomesa_tpu.curves.xz``, a copy: 'XZ-Ordering: A Space-Filling Curve for
Objects with Spatial Extension' (Böhm, Klump, Kriegel), with GeoMesa's
XZ2SFC.scala / XZ3SFC.scala semantics:

  - a bbox is indexed by the sequence code of the *enlarged* tree cell
    (cell doubled in each dim) that contains it; the code-length l is derived
    from the bbox's max extent (l1 or l1+1 via the two-cell predicate)
  - query decomposition is a BFS over tree cells: cells whose enlarged bounds
    are contained in a query window emit a "contained" code interval (lemma 3
    of the paper); overlapping cells emit their single code and recurse
  - ranges are sort-merged (adjacent codes coalesce)

One generic implementation covers both the 2-D quadtree (XZ2) and the 3-D
octree (XZ3, spatial + binned-time). ``index`` is vectorized over numpy bbox
arrays (the write path encodes millions of geometries at once); ``ranges``
stays scalar host code, as in the reference.
"""

from __future__ import annotations

import math
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

from geomesa_tpu_torch.curves.binnedtime import TimePeriod, max_offset
from geomesa_tpu_torch.curves.ranges import IndexRange, merge_ranges


class XZSFC:
    """Generic D-dimensional XZ curve over user-space bounds per dim."""

    def __init__(self, g: int, bounds: Sequence[Tuple[float, float]]):
        self.g = int(g)
        self.dims = len(bounds)
        self.bounds = [(float(lo), float(hi)) for lo, hi in bounds]
        self._los = np.array([b[0] for b in self.bounds])
        self._sizes = np.array([b[1] - b[0] for b in self.bounds])
        self.fan = 1 << self.dims  # children per cell: 4 (quad) or 8 (oct)

    # -- indexing ----------------------------------------------------------

    def _normalize(self, mins: np.ndarray, maxs: np.ndarray, lenient: bool):
        """User-space (N, D) bbox corners → [0,1] normalized."""
        if np.any(mins > maxs):
            raise ValueError("Bounds must be ordered (min <= max per dim)")
        oob = (mins < self._los) | (maxs > self._los + self._sizes)
        if np.any(oob):
            if not lenient:
                raise ValueError("Values out of bounds for xz index")
            mins = np.clip(mins, self._los, self._los + self._sizes)
            maxs = np.clip(maxs, self._los, self._los + self._sizes)
        return (mins - self._los) / self._sizes, (maxs - self._los) / self._sizes

    def _seq_term(self, i) -> "int | np.ndarray":
        """Number of descendants-plus-self below one quadrant at level i:
        (fan^(g-i) - 1) / (fan - 1). Exact in int64 for g <= 21 (2D) / 14 (3D);
        we use Python/object ints via numpy int64 — g defaults keep it safe."""
        return (self.fan ** (self.g - i) - 1) // (self.fan - 1)

    def index(self, mins, maxs, lenient: bool = False) -> np.ndarray:
        """Vectorized: (N, D) bbox min/max corners → (N,) int64 codes."""
        mins = np.atleast_2d(np.asarray(mins, dtype=np.float64))
        maxs = np.atleast_2d(np.asarray(maxs, dtype=np.float64))
        nmins, nmaxs = self._normalize(mins, maxs, lenient)
        n = nmins.shape[0]

        # code length: l1 = floor(log(maxDim)/log(0.5)); maxDim == 0 → g
        ext = np.max(nmaxs - nmins, axis=1)
        with np.errstate(divide="ignore"):
            l1 = np.floor(np.log(ext) / math.log(0.5))
        l1 = np.where(np.isfinite(l1), l1, self.g).astype(np.int64)
        l1 = np.minimum(l1, self.g)

        # two-cell predicate: bump to l1+1 when the bbox spans at most two
        # cells of the finer resolution in every dim (XZ2SFC.scala:66-74)
        w2 = np.power(0.5, (l1 + 1).astype(np.float64))[:, None]
        fits = nmaxs <= np.floor(nmins / w2) * w2 + 2 * w2
        length = np.where((l1 < self.g) & np.all(fits, axis=1), l1 + 1, l1)

        # sequence code: walk the tree `length` levels toward the bbox's min
        # corner (XZ2SFC.sequenceCode, :264-286), all features in lockstep
        cs = np.zeros(n, dtype=np.int64)
        lo = np.zeros((n, self.dims))
        hi = np.ones((n, self.dims))
        pos = nmins
        for i in range(self.g):
            active = i < length
            center = (lo + hi) / 2.0
            upper = pos >= center  # per-dim quadrant bit
            quadrant = np.zeros(n, dtype=np.int64)
            for d in range(self.dims):
                quadrant |= upper[:, d].astype(np.int64) << d
            cs = np.where(active, cs + 1 + quadrant * self._seq_term(i), cs)
            sel = active[:, None] & upper
            lo = np.where(sel, center, lo)
            hi = np.where(active[:, None] & ~upper, center, hi)
        return cs

    # -- query decomposition ----------------------------------------------

    def ranges(
        self,
        queries: Sequence[Sequence[float]],
        max_ranges: Optional[int] = None,
    ) -> List[IndexRange]:
        """Cover query windows with code ranges.

        queries: each (min_0..min_D-1, max_0..max_D-1) in user space.
        """
        max_ranges = max_ranges or (1 << 62)
        windows = []
        for q in queries:
            mins = np.asarray(q[: self.dims], dtype=np.float64)
            maxs = np.asarray(q[self.dims:], dtype=np.float64)
            nmins, nmaxs = self._normalize(mins[None, :], maxs[None, :], lenient=False)
            windows.append((nmins[0], nmaxs[0]))

        out: List[IndexRange] = []

        def seq_code(point: np.ndarray, length: int) -> int:
            cs = 0
            lo = np.zeros(self.dims)
            hi = np.ones(self.dims)
            for i in range(length):
                center = (lo + hi) / 2.0
                quadrant = 0
                for d in range(self.dims):
                    if point[d] >= center[d]:
                        quadrant |= 1 << d
                        lo[d] = center[d]
                    else:
                        hi[d] = center[d]
                cs += 1 + quadrant * self._seq_term(i)
            return cs

        def emit(cell_lo: np.ndarray, level: int, contained: bool) -> None:
            lo_code = seq_code(cell_lo, level)
            if contained:
                # lemma 3: all codes prefixed by this cell's code. NB the
                # reference adds the full subtree size with no -1
                # (XZ2SFC.scala:297-306) — over-inclusive by one code, which
                # the fine filter removes; we match it for parity.
                hi_code = lo_code + self._seq_term(level - 1)
            else:
                hi_code = lo_code
            out.append(IndexRange(lo_code, hi_code, contained))

        # BFS over cells; a cell at `level` has side 0.5^level, and its
        # *enlarged* element doubles that side (XElement semantics)
        queue: deque = deque()
        root_children = [
            (np.array([(c >> d) & 1 for d in range(self.dims)]) * 0.5, 1)
            for c in range(self.fan)
        ]
        queue.extend(root_children)

        while queue:
            cell_lo, level = queue.popleft()
            side = 0.5 ** level
            ext_hi = cell_lo + 2 * side  # enlarged element upper corner
            cell_hi = cell_lo + side
            contained = overlapped = False
            for wmin, wmax in windows:
                if np.all(wmin <= cell_lo) and np.all(wmax >= ext_hi):
                    contained = True
                    break
                if np.all(wmax >= cell_lo) and np.all(wmin <= ext_hi):
                    overlapped = True
            if contained:
                emit(cell_lo, level, True)
            elif overlapped:
                emit(cell_lo, level, False)
                if level < self.g and len(out) < max_ranges:
                    half = side / 2.0
                    for c in range(self.fan):
                        child = cell_lo + np.array(
                            [((c >> d) & 1) * half for d in range(self.dims)])
                        queue.append((child, level + 1))
                elif level < self.g:
                    # budget exhausted: cover the whole subtree coarsely
                    lo_code = seq_code(cell_lo, level)
                    out.append(IndexRange(lo_code, lo_code + self._seq_term(level - 1), False))

        return merge_ranges(out)


class XZ2SFC(XZSFC):
    """2-D XZ curve over lon/lat (reference XZ2SFC.scala; default g=12)."""

    _cache: dict = {}

    def __init__(self, g: int = 12, x_bounds=(-180.0, 180.0), y_bounds=(-90.0, 90.0)):
        super().__init__(g, [x_bounds, y_bounds])

    @classmethod
    def apply(cls, g: int = 12) -> "XZ2SFC":
        if g not in cls._cache:
            cls._cache[g] = cls(g)
        return cls._cache[g]

    def index_bbox(self, xmin, ymin, xmax, ymax, lenient: bool = False) -> np.ndarray:
        mins = np.stack([np.asarray(xmin, dtype=np.float64), np.asarray(ymin, dtype=np.float64)], axis=-1)
        maxs = np.stack([np.asarray(xmax, dtype=np.float64), np.asarray(ymax, dtype=np.float64)], axis=-1)
        return self.index(mins, maxs, lenient)

    def ranges_bbox(self, queries: Sequence[Tuple[float, float, float, float]],
                    max_ranges: Optional[int] = None) -> List[IndexRange]:
        return self.ranges([(xmin, ymin, xmax, ymax) for xmin, ymin, xmax, ymax in queries], max_ranges)


class XZ3SFC(XZSFC):
    """3-D XZ curve over lon/lat/binned-time (reference XZ3SFC.scala).

    The time dim spans one period bin, [0, max_offset(period)]; callers
    decompose multi-bin intervals per bin as with Z3. Default g=36 exceeds
    what int64 codes can hold for an octree; the reference uses g=36 for XZ3?
    No — the reference XZ3 uses the same g resolution as XZ2 (12) by default
    at the index layer; we keep g configurable and default to 12.
    """

    _cache: dict = {}

    def __init__(self, g: int = 12, period: TimePeriod = TimePeriod.WEEK,
                 x_bounds=(-180.0, 180.0), y_bounds=(-90.0, 90.0)):
        period = TimePeriod.parse(period)
        super().__init__(g, [x_bounds, y_bounds, (0.0, float(max_offset(period)))])
        self.period = period

    @classmethod
    def apply(cls, g: int = 12, period: TimePeriod = TimePeriod.WEEK) -> "XZ3SFC":
        period = TimePeriod.parse(period)
        key = (g, period)
        if key not in cls._cache:
            cls._cache[key] = cls(g, period)
        return cls._cache[key]
