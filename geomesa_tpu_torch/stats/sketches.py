"""Stat sketches — the summary statistics family.

Copied from ``geomesa_tpu.stats.sketches`` (host-only, numpy) with the same
sketch state for the same observations. Four changes reach that state
another way: ``np.maximum.at``/``np.add.at`` over every row became
``np.bincount`` (the HyperLogLog registers, the count-min and Z2 tables),
the Z3 histogram finds its time bins by one ``np.bincount`` instead of
``np.unique``, and the order-free kinds (MinMax, Enumeration, TopK,
Frequency) take a column as its distinct values with their counts
(``observe_counts``), so that a dictionary-encoded string column is observed
through its vocabulary (``stats.dsl.observe_table``). Every observe here
depends only on the multiset of values observed, so either way gives the
reference's ``to_dict()``.

≙ reference `Stat` hierarchy (geomesa-utils/.../stats/
Stat.scala:40-131, MinMax.scala:30, Histogram.scala:34, Frequency.scala:42,
TopK.scala:24, Z3Histogram.scala:33) and the vendored HyperLogLog
(utils/clearspring). Re-designed for columnar bulk observation: every sketch
has a vectorized ``observe(values)`` over whole numpy columns (the reference
observes one SimpleFeature at a time — a per-row loop would throw away the
columnar layout), plus ``merge`` (``+=``) for cross-device/cross-partition
combination and JSON-safe ``to_dict``/``from_dict`` round-tripping (the
reference's serialize/deserialize + toJson contract).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# -- deterministic 64-bit hashing (process-stable: sketches must merge across
#    hosts/runs, so Python's salted hash() is out) ---------------------------

_U = np.uint64


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = x + _U(0x9E3779B97F4A7C15)   # a new array; the rest in place
    x ^= x >> _U(30)
    x *= _U(0xBF58476D1CE4E5B9)
    x ^= x >> _U(27)
    x *= _U(0x94D049BB133111EB)
    x ^= x >> _U(31)
    return x


def hash64(values: np.ndarray) -> np.ndarray:
    """Deterministic uint64 hashes for a column of values."""
    arr = np.asarray(values)
    if arr.dtype.kind in "OU":  # strings: blake2b over unique values
        uniq, inverse = np.unique(arr.astype(object), return_inverse=True)
        digests = np.array(
            [int.from_bytes(hashlib.blake2b(str(u).encode(), digest_size=8).digest(), "little")
             for u in uniq], dtype=np.uint64)
        return digests[inverse]
    if arr.dtype.kind == "f":
        arr = np.where(arr == 0.0, 0.0, arr)  # canonicalize -0.0
        bits = arr.astype(np.float64).view(np.uint64)
        return _splitmix64(bits)
    if arr.dtype.kind == "b":
        arr = arr.astype(np.uint64)
    with np.errstate(over="ignore"):
        return _splitmix64(arr.astype(np.int64).view(np.uint64))


# big columns observe in chunks of this many rows, over a thread pool
_CHUNK = 1 << 22
_POOL = []


def _pool():
    """The process's thread pool for chunked observes (made at first use)."""
    if not _POOL:
        from concurrent.futures import ThreadPoolExecutor
        _POOL.append(ThreadPoolExecutor(
            max_workers=max(1, min(8, os.cpu_count() or 1)),
            thread_name_prefix="stats"))
    return _POOL[0]


def _chunks(n: int, fn) -> list:
    """``fn(lo, hi)`` over rows [0, n) in spans of ``_CHUNK``, the spans
    over the pool when there are several."""
    spans = [(lo, min(n, lo + _CHUNK)) for lo in range(0, n, _CHUNK)]
    if len(spans) <= 1:
        return [fn(0, n)]
    return list(_pool().map(lambda s: fn(*s), spans))


# -- base --------------------------------------------------------------------


class Stat:
    """Base sketch. Subclasses define kind, observe, merge, to/from_dict."""

    kind = "stat"
    attrs: Tuple[str, ...] = ()

    def observe(self, *columns: np.ndarray) -> None:
        raise NotImplementedError

    def __iadd__(self, other: "Stat") -> "Stat":
        raise NotImplementedError

    def __add__(self, other: "Stat") -> "Stat":
        out = from_dict(self.to_dict())
        out += other
        return out

    @property
    def is_empty(self) -> bool:
        raise NotImplementedError

    def to_dict(self) -> dict:
        raise NotImplementedError

    def to_json(self) -> dict:
        """Human-readable summary (≙ Stat.toJson)."""
        return self.to_dict()

    def spec(self) -> str:
        """Round-trippable DSL string for this sketch."""
        raise NotImplementedError


_REGISTRY: Dict[str, type] = {}


def register(cls):
    _REGISTRY[cls.kind] = cls
    return cls


def from_dict(d: dict) -> Stat:
    return _REGISTRY[d["kind"]]._from_dict(d)


def _json_key(v):
    return v.item() if isinstance(v, np.generic) else v


def find_stat(stats, kind: str, attr: Optional[str] = None) -> Optional["Stat"]:
    """Find the first leaf sketch of ``kind`` (optionally over ``attr``) in an
    iterable of stats, descending into SeqStats."""
    for s in stats:
        for leaf in (s.stats if isinstance(s, SeqStat) else [s]):
            if leaf.kind == kind and (attr is None or attr in leaf.attrs):
                return leaf
    return None


# -- Count -------------------------------------------------------------------


@register
class CountStat(Stat):
    """Row count (≙ stats/CountStat)."""

    kind = "count"

    def __init__(self, count: int = 0):
        self.count = int(count)

    def observe(self, n_or_column) -> None:
        if np.isscalar(n_or_column):
            self.count += int(n_or_column)
        else:
            self.count += len(n_or_column)

    def __iadd__(self, other):
        self.count += other.count
        return self

    @property
    def is_empty(self):
        return self.count == 0

    def to_dict(self):
        return {"kind": self.kind, "count": self.count}

    @classmethod
    def _from_dict(cls, d):
        return cls(d["count"])

    def spec(self):
        return "Count()"


# -- HyperLogLog (cardinality, used inside MinMax) ---------------------------


class HyperLogLog:
    """Dense HLL, p=11 (2048 registers) — ≙ the vendored clearspring HLL
    backing MinMax cardinality (utils/clearspring, SURVEY.md §2.5)."""

    P = 11
    M = 1 << P

    def __init__(self, registers: Optional[np.ndarray] = None):
        self.registers = (np.zeros(self.M, dtype=np.uint8)
                          if registers is None else registers.astype(np.uint8))

    def observe_hashes(self, h: np.ndarray) -> None:
        if len(h) == 0:
            return
        np.maximum(self.registers, self.ranks(h), out=self.registers)

    def observe_rows(self, n: int, hashes) -> None:
        """Observe rows [0, n) whose hashes ``hashes(lo, hi)`` gives a span
        at a time: a column past ``_CHUNK`` rows goes in chunks over threads
        (numpy leaves the GIL in its loops), the registers the max of the
        chunks' (order-free, so the reference's registers)."""
        if n == 0:
            return
        for top in _chunks(n, lambda a, b: self.ranks(hashes(a, b))):
            np.maximum(self.registers, top, out=self.registers)

    @classmethod
    def ranks(cls, h: np.ndarray) -> np.ndarray:
        """(M,) uint8: each register's highest rank among hashes ``h`` (0
        where none lands) — the reference's np.maximum.at, through a table
        of the ranks present."""
        idx = (h >> _U(64 - cls.P)).astype(np.int64)
        rem = (h & _U((1 << (64 - cls.P)) - 1)).astype(np.uint64)
        # rank = leading zeros of the (64-P)-bit remainder + 1; remainder
        # < 2^53 → exact in f64; frexp exponent = bit length (0 for 0)
        nbits = 64 - cls.P
        rank = nbits + 1 - np.frexp(rem.astype(np.float64))[1]   # 1 .. 54
        idx *= 64
        idx += rank
        seen = np.bincount(idx, minlength=cls.M * 64).reshape(cls.M, 64) > 0
        return np.where(seen.any(axis=1),
                        63 - np.argmax(seen[:, ::-1], axis=1), 0
                        ).astype(np.uint8)

    def merge(self, other: "HyperLogLog") -> None:
        np.maximum(self.registers, other.registers, out=self.registers)

    def cardinality(self) -> int:
        m = float(self.M)
        alpha = 0.7213 / (1 + 1.079 / m)
        est = alpha * m * m / float(np.sum(np.ldexp(1.0, -self.registers.astype(np.int64))))
        zeros = int(np.sum(self.registers == 0))
        if est <= 2.5 * m and zeros > 0:
            est = m * np.log(m / zeros)  # linear counting
        return int(round(est))


# -- MinMax ------------------------------------------------------------------


@register
class MinMaxStat(Stat):
    """Min/max + HLL cardinality for one attribute (≙ MinMax.scala:30).
    Works for numeric, date (int64 ms), string, and geometry (observe with
    bbox columns xmin,ymin,xmax,ymax → envelope union)."""

    kind = "minmax"

    def __init__(self, attr: str, geometric: bool = False):
        self.attrs = (attr,)
        self.attr = attr
        self.geometric = geometric
        self.min = None
        self.max = None
        self.hll = HyperLogLog()

    def observe(self, values, *extra) -> None:
        if self.geometric:
            xmin, ymin, xmax, ymax = (values, *extra)
            if len(xmin) == 0:
                return
            lo = (float(np.min(xmin)), float(np.min(ymin)))
            hi = (float(np.max(xmax)), float(np.max(ymax)))
            self.min = lo if self.min is None else (min(self.min[0], lo[0]), min(self.min[1], lo[1]))
            self.max = hi if self.max is None else (max(self.max[0], hi[0]), max(self.max[1], hi[1]))
            xmin, ymin, xmax, ymax = (np.asarray(a) for a in
                                      (xmin, ymin, xmax, ymax))

            def hashes(a, b):
                cx = (xmin[a:b] + xmax[a:b]) / 2
                cy = (ymin[a:b] + ymax[a:b]) / 2
                return hash64(np.round(cx, 6) * 1e6 + np.round(cy, 6))
            self.hll.observe_rows(len(xmin), hashes)
            return
        arr = np.asarray(values)
        if len(arr) == 0:
            return
        lo, hi = np.min(arr), np.max(arr)
        if arr.dtype.kind in "OU":
            lo, hi = str(lo), str(hi)
            self.min = lo if self.min is None else min(self.min, lo)
            self.max = hi if self.max is None else max(self.max, hi)
        else:
            lo, hi = _json_key(lo), _json_key(hi)
            self.min = lo if self.min is None else min(self.min, lo)
            self.max = hi if self.max is None else max(self.max, hi)
            if arr.dtype.kind == "i" and len(arr) > _CHUNK \
                    and hi - lo < len(arr):
                # a narrow integer range: the registers of its distinct
                # values are the column's
                seen = np.bincount(arr.astype(np.int64) - lo)
                arr = np.flatnonzero(seen) + lo
        if arr.dtype.kind in "OU":
            self.hll.observe_hashes(hash64(arr))
        else:
            self.hll.observe_rows(len(arr), lambda a, b: hash64(arr[a:b]))

    def observe_counts(self, values: np.ndarray, counts: np.ndarray) -> None:
        """Observe a column given as its distinct values (ascending, as
        ``np.unique`` gives them) and their counts: min and max are the ends,
        and the registers take each distinct value's hash once."""
        if self.geometric:
            raise TypeError("geometric MinMax observes bbox columns")
        if len(values) == 0:
            return
        self.observe(values)

    @property
    def cardinality(self) -> int:
        return self.hll.cardinality()

    @property
    def bounds(self):
        return (self.min, self.max)

    def __iadd__(self, other):
        if other.min is not None:
            if self.min is None:
                self.min, self.max = other.min, other.max
            elif self.geometric:
                self.min = (min(self.min[0], other.min[0]), min(self.min[1], other.min[1]))
                self.max = (max(self.max[0], other.max[0]), max(self.max[1], other.max[1]))
            else:
                self.min = min(self.min, other.min)
                self.max = max(self.max, other.max)
        self.hll.merge(other.hll)
        return self

    @property
    def is_empty(self):
        return self.min is None

    def to_dict(self):
        return {"kind": self.kind, "attr": self.attr, "geometric": self.geometric,
                "min": list(self.min) if self.geometric and self.min else self.min,
                "max": list(self.max) if self.geometric and self.max else self.max,
                "registers": self.hll.registers.tolist()}

    def to_json(self):
        return {"kind": self.kind, "attr": self.attr, "min": self.min,
                "max": self.max, "cardinality": self.cardinality}

    @classmethod
    def _from_dict(cls, d):
        out = cls(d["attr"], d.get("geometric", False))
        out.min = tuple(d["min"]) if out.geometric and d["min"] else d["min"]
        out.max = tuple(d["max"]) if out.geometric and d["max"] else d["max"]
        out.hll = HyperLogLog(np.asarray(d["registers"], dtype=np.uint8))
        return out

    def spec(self):
        return f'MinMax("{self.attr}")'


# -- Enumeration (exact value counts) ----------------------------------------


@register
class EnumerationStat(Stat):
    """Exact value→count map (≙ EnumerationStat)."""

    kind = "enumeration"

    def __init__(self, attr: str):
        self.attrs = (attr,)
        self.attr = attr
        self.counts: Dict[object, int] = {}

    def observe(self, values) -> None:
        self.observe_counts(*np.unique(np.asarray(values), return_counts=True))

    def observe_counts(self, uniq: np.ndarray, cnt: np.ndarray) -> None:
        """Observe distinct values (ascending) with their counts."""
        for v, c in zip(uniq, cnt):
            v = _json_key(v)
            self.counts[v] = self.counts.get(v, 0) + int(c)

    def __iadd__(self, other):
        for v, c in other.counts.items():
            self.counts[v] = self.counts.get(v, 0) + c
        return self

    @property
    def is_empty(self):
        return not self.counts

    def to_dict(self):
        return {"kind": self.kind, "attr": self.attr,
                "values": [[v, c] for v, c in self.counts.items()]}

    @classmethod
    def _from_dict(cls, d):
        out = cls(d["attr"])
        out.counts = {v: c for v, c in d["values"]}
        return out

    def spec(self):
        return f'Enumeration("{self.attr}")'


# -- TopK (space-saving) -----------------------------------------------------


@register
class TopKStat(Stat):
    """Approximate heavy hitters via space-saving (≙ TopK.scala:24, which
    wraps a StreamSummary)."""

    kind = "topk"
    CAPACITY = 128

    def __init__(self, attr: str):
        self.attrs = (attr,)
        self.attr = attr
        self.counts: Dict[object, int] = {}

    def observe(self, values) -> None:
        self.observe_counts(*np.unique(np.asarray(values), return_counts=True))

    def observe_counts(self, uniq: np.ndarray, cnt: np.ndarray) -> None:
        """Observe distinct values (ascending) with their int64 counts."""
        order = np.argsort(-cnt)
        for i in order:
            v, c = _json_key(uniq[i]), int(cnt[i])
            if v in self.counts:
                self.counts[v] += c
            elif len(self.counts) < self.CAPACITY:
                self.counts[v] = c
            else:
                evict = min(self.counts, key=self.counts.get)
                base = self.counts.pop(evict)
                self.counts[v] = base + c

    def topk(self, k: int = 10) -> List[Tuple[object, int]]:
        return sorted(self.counts.items(), key=lambda kv: -kv[1])[:k]

    def __iadd__(self, other):
        for v, c in sorted(other.counts.items(), key=lambda kv: -kv[1]):
            if v in self.counts:
                self.counts[v] += c
            elif len(self.counts) < self.CAPACITY:
                self.counts[v] = c
            else:
                evict = min(self.counts, key=self.counts.get)
                base = self.counts.pop(evict)
                self.counts[v] = base + c
        return self

    @property
    def is_empty(self):
        return not self.counts

    def to_dict(self):
        return {"kind": self.kind, "attr": self.attr,
                "values": [[v, c] for v, c in self.counts.items()]}

    def to_json(self):
        return {"kind": self.kind, "attr": self.attr, "topk": self.topk()}

    @classmethod
    def _from_dict(cls, d):
        out = cls(d["attr"])
        out.counts = {v: c for v, c in d["values"]}
        return out

    def spec(self):
        return f'TopK("{self.attr}")'


# -- Frequency (count-min sketch) --------------------------------------------


@register
class FrequencyStat(Stat):
    """Count-min sketch (≙ Frequency.scala:42 / RichCountMinSketch)."""

    kind = "frequency"
    DEPTH = 4

    def __init__(self, attr: str, width_bits: int = 12):
        self.attrs = (attr,)
        self.attr = attr
        self.width_bits = width_bits
        self.width = 1 << width_bits
        self.table = np.zeros((self.DEPTH, self.width), dtype=np.int64)
        self.total = 0

    def _rows(self, h: np.ndarray) -> np.ndarray:
        """(DEPTH, n) bucket indices."""
        return np.stack([
            (_splitmix64(h ^ _U((0xA076_1D64_78BD_642F * (i + 1)) & 0xFFFF_FFFF_FFFF_FFFF))
             % _U(self.width)).astype(np.int64)
            for i in range(self.DEPTH)])

    def observe(self, values) -> None:
        arr = np.asarray(values)
        if len(arr) == 0:
            return
        rows = self._rows(hash64(arr))
        for i in range(self.DEPTH):
            self.table[i] += np.bincount(rows[i], minlength=self.width)
        self.total += len(arr)

    def observe_counts(self, uniq: np.ndarray, cnt: np.ndarray) -> None:
        """Observe distinct values with their counts: each value's buckets
        take its count once."""
        if len(uniq) == 0:
            return
        rows = self._rows(hash64(uniq))
        for i in range(self.DEPTH):
            np.add.at(self.table[i], rows[i], np.asarray(cnt, np.int64))
        self.total += int(np.sum(cnt))

    def estimate(self, value) -> int:
        h = hash64(np.asarray([value]))
        rows = self._rows(h)
        return int(min(self.table[i, rows[i, 0]] for i in range(self.DEPTH)))

    def __iadd__(self, other):
        self.table += other.table
        self.total += other.total
        return self

    @property
    def is_empty(self):
        return self.total == 0

    def to_dict(self):
        return {"kind": self.kind, "attr": self.attr, "width_bits": self.width_bits,
                "total": self.total, "table": self.table.ravel().tolist()}

    def to_json(self):
        return {"kind": self.kind, "attr": self.attr, "total": self.total}

    @classmethod
    def _from_dict(cls, d):
        out = cls(d["attr"], d["width_bits"])
        out.table = np.asarray(d["table"], dtype=np.int64).reshape(cls.DEPTH, out.width)
        out.total = d["total"]
        return out

    def spec(self):
        return f'Frequency("{self.attr}",{self.width_bits})'


# -- Histogram (binned range counts) -----------------------------------------


@register
class HistogramStat(Stat):
    """Fixed-bin histogram over [lo, hi]; outliers clamp into the end bins
    (≙ Histogram.scala:34 BinnedArray semantics)."""

    kind = "histogram"

    def __init__(self, attr: str, bins: int, lo: float, hi: float):
        self.attrs = (attr,)
        self.attr = attr
        self.bins = int(bins)
        self.lo = float(lo)
        self.hi = float(hi)
        self.counts = np.zeros(self.bins, dtype=np.int64)

    def observe(self, values) -> None:
        arr = np.asarray(values, dtype=np.float64)
        if len(arr) == 0:
            return
        span = self.hi - self.lo
        idx = np.clip(((arr - self.lo) / span * self.bins).astype(np.int64),
                      0, self.bins - 1)
        self.counts += np.bincount(idx, minlength=self.bins)

    def bin_edges(self) -> np.ndarray:
        return np.linspace(self.lo, self.hi, self.bins + 1)

    def mass_between(self, lo: float, hi: float) -> float:
        """Estimated count in [lo, hi] (fractional end bins)."""
        edges = self.bin_edges()
        frac = np.clip((np.minimum(hi, edges[1:]) - np.maximum(lo, edges[:-1]))
                       / (edges[1:] - edges[:-1]), 0.0, 1.0)
        return float(np.sum(self.counts * frac))

    def __iadd__(self, other):
        self.counts += other.counts
        return self

    @property
    def is_empty(self):
        return int(self.counts.sum()) == 0

    def to_dict(self):
        return {"kind": self.kind, "attr": self.attr, "bins": self.bins,
                "lo": self.lo, "hi": self.hi, "counts": self.counts.tolist()}

    def to_json(self):
        return {"kind": self.kind, "attr": self.attr, "bins": self.bins,
                "lo": self.lo, "hi": self.hi, "total": int(self.counts.sum())}

    @classmethod
    def _from_dict(cls, d):
        out = cls(d["attr"], d["bins"], d["lo"], d["hi"])
        out.counts = np.asarray(d["counts"], dtype=np.int64)
        return out

    def spec(self):
        return f'Histogram("{self.attr}",{self.bins},{self.lo},{self.hi})'


# -- Z2Histogram (spatial grid) ----------------------------------------------


@register
class Z2HistogramStat(Stat):
    """2-D lon/lat grid counts at 2^g × 2^g resolution — the spatial
    selectivity surface (≙ the reference's geometry Histogram binned on Z2,
    used by StatsBasedEstimator for spatial estimates). Stored as an (iy, ix)
    grid: box-mass queries are sub-grid sums."""

    kind = "z2histogram"

    def __init__(self, attr: str, gbits: int = 5):
        self.attrs = (attr,)
        self.attr = attr
        self.gbits = int(gbits)
        self.g = 1 << self.gbits
        self.counts = np.zeros((self.g, self.g), dtype=np.int64)

    def observe(self, x: np.ndarray, y: np.ndarray) -> None:
        if len(x) == 0:
            return
        x, y, g = np.asarray(x, np.float64), np.asarray(y, np.float64), self.g

        def cells(a, b):
            ix = np.clip(((x[a:b] + 180.0) / 360.0 * g).astype(np.int64), 0, g - 1)
            iy = np.clip(((y[a:b] + 90.0) / 180.0 * g).astype(np.int64), 0, g - 1)
            return np.bincount(iy * g + ix, minlength=g * g)
        # the reference's np.add.at, as the sum of bincounts over chunks
        self.counts += sum(_chunks(len(x), cells)).reshape(g, g)

    def mass_in_box(self, xmin, ymin, xmax, ymax) -> float:
        """Estimated count inside the bbox (fractional edge cells)."""
        cw, ch = 360.0 / self.g, 180.0 / self.g
        x0 = np.clip((xmin + 180.0) / cw, 0, self.g)
        x1 = np.clip((xmax + 180.0) / cw, 0, self.g)
        y0 = np.clip((ymin + 90.0) / ch, 0, self.g)
        y1 = np.clip((ymax + 90.0) / ch, 0, self.g)
        fx = np.clip(np.minimum(x1, np.arange(1, self.g + 1)) - np.maximum(x0, np.arange(self.g)), 0, 1)
        fy = np.clip(np.minimum(y1, np.arange(1, self.g + 1)) - np.maximum(y0, np.arange(self.g)), 0, 1)
        return float(fy @ self.counts @ fx)

    def __iadd__(self, other):
        self.counts += other.counts
        return self

    @property
    def is_empty(self):
        return int(self.counts.sum()) == 0

    def to_dict(self):
        return {"kind": self.kind, "attr": self.attr, "gbits": self.gbits,
                "counts": self.counts.ravel().tolist()}

    def to_json(self):
        return {"kind": self.kind, "attr": self.attr, "gbits": self.gbits,
                "total": int(self.counts.sum())}

    @classmethod
    def _from_dict(cls, d):
        out = cls(d["attr"], d["gbits"])
        out.counts = np.asarray(d["counts"], dtype=np.int64).reshape(out.g, out.g)
        return out

    def spec(self):
        return f'Z2Histogram("{self.attr}",{self.gbits})'


# -- Z3Histogram (per-epoch temporal buckets) --------------------------------


@register
class Z3HistogramStat(Stat):
    """Per time-bin offset histograms (≙ Z3Histogram.scala:33): counts[bin]
    is a BUCKETS-long histogram over the period offset. Temporal selectivity
    = mass of the query windows."""

    kind = "z3histogram"
    BUCKETS = 64
    _SPAN = 1 << 16     # bins spanned past which the table would be too big

    def __init__(self, dtg: str, period: str = "week"):
        self.attrs = (dtg,)
        self.dtg = dtg
        self.period = period
        self.bins: Dict[int, np.ndarray] = {}

    def observe(self, bins: np.ndarray, offs: np.ndarray, max_off: int) -> None:
        """bins/offs: the exact (bin, offset) decomposition; max_off: period
        length in offset units."""
        if len(bins) == 0:
            return
        self.observe_tables(_chunks(len(bins), lambda a, b: self.span_table(
            bins[a:b], offs[a:b], max_off)))

    @classmethod
    def span_table(cls, bins: np.ndarray, offs: np.ndarray, max_off: int) -> dict:
        """{bin: BUCKETS int64 counts} of one span of rows: a (bin, bucket)
        table over the bins' span by one np.bincount (the reference's
        np.unique loop where the span is too wide)."""
        b = np.asarray(bins, dtype=np.int64)
        o = np.clip((np.asarray(offs, np.float64) / max_off * cls.BUCKETS).astype(np.int64),
                    0, cls.BUCKETS - 1)
        lo = int(b.min())
        span = int(b.max()) - lo + 1
        if span > cls._SPAN:
            return {int(ub): np.bincount(o[b == ub], minlength=cls.BUCKETS)
                    for ub in np.unique(b)}
        t = np.bincount((b - lo) * cls.BUCKETS + o,
                        minlength=span * cls.BUCKETS).reshape(span, cls.BUCKETS)
        return {lo + int(j): t[j] for j in np.flatnonzero(t.any(axis=1))}

    def observe_tables(self, tables) -> None:
        """Add span tables, new bins inserted in ascending order (as the
        reference's one pass over np.unique(bins) inserts them)."""
        total: Dict[int, np.ndarray] = {}
        for t in tables:
            for ub, counts in t.items():
                total[ub] = total[ub] + counts if ub in total else counts
        for ub in sorted(total):
            if ub not in self.bins:
                self.bins[ub] = np.zeros(self.BUCKETS, dtype=np.int64)
            self.bins[ub] += total[ub]

    def mass_in_windows(self, windows: Sequence[Tuple[int, int, int, int]],
                        max_off: int) -> float:
        """windows: (bin_lo, off_lo, bin_hi, off_hi) rows."""
        total = 0.0
        for blo, olo, bhi, ohi in windows:
            # iterate only bins with data — open-ended intervals produce
            # astronomically wide (blo, bhi) spans
            for b in [b for b in self.bins if int(blo) <= b <= int(bhi)]:
                counts = self.bins[b]
                lo = olo / max_off * self.BUCKETS if b == blo else 0.0
                hi = ohi / max_off * self.BUCKETS if b == bhi else float(self.BUCKETS)
                edges = np.arange(self.BUCKETS + 1, dtype=np.float64)
                frac = np.clip(np.minimum(hi, edges[1:]) - np.maximum(lo, edges[:-1]), 0, 1)
                total += float(np.sum(counts * frac))
        return total

    @property
    def total(self) -> int:
        return int(sum(int(c.sum()) for c in self.bins.values()))

    def __iadd__(self, other):
        for b, c in other.bins.items():
            if b in self.bins:
                self.bins[b] += c
            else:
                self.bins[b] = c.copy()
        return self

    @property
    def is_empty(self):
        return not self.bins

    def to_dict(self):
        return {"kind": self.kind, "dtg": self.dtg, "period": self.period,
                "bins": {str(b): c.tolist() for b, c in self.bins.items()}}

    def to_json(self):
        return {"kind": self.kind, "dtg": self.dtg, "period": self.period,
                "bins": sorted(self.bins), "total": self.total}

    @classmethod
    def _from_dict(cls, d):
        out = cls(d["dtg"], d["period"])
        out.bins = {int(b): np.asarray(c, dtype=np.int64) for b, c in d["bins"].items()}
        return out

    def spec(self):
        return f'Z3Histogram("{self.dtg}","{self.period}")'


# -- DescriptiveStats --------------------------------------------------------


@register
class DescriptiveStat(Stat):
    """count/mean/variance/covariance over numeric attributes
    (≙ DescriptiveStats.scala). Accumulates raw power sums (merge = add)."""

    kind = "descriptive"

    def __init__(self, attrs: Sequence[str]):
        self.attrs = tuple(attrs)
        k = len(self.attrs)
        self.n = 0
        self.sum = np.zeros(k)
        self.cross = np.zeros((k, k))  # sum of outer products

    def observe(self, *columns: np.ndarray) -> None:
        x = np.stack([np.asarray(c, dtype=np.float64) for c in columns], axis=1)
        if len(x) == 0:
            return
        self.n += len(x)
        self.sum += x.sum(axis=0)
        self.cross += x.T @ x

    @property
    def mean(self) -> np.ndarray:
        return self.sum / max(self.n, 1)

    @property
    def covariance(self) -> np.ndarray:
        if self.n < 2:
            return np.zeros_like(self.cross)
        m = self.mean
        return (self.cross - self.n * np.outer(m, m)) / (self.n - 1)

    @property
    def variance(self) -> np.ndarray:
        return np.diag(self.covariance)

    def __iadd__(self, other):
        self.n += other.n
        self.sum += other.sum
        self.cross += other.cross
        return self

    @property
    def is_empty(self):
        return self.n == 0

    def to_dict(self):
        return {"kind": self.kind, "attrs": list(self.attrs), "n": self.n,
                "sum": self.sum.tolist(), "cross": self.cross.ravel().tolist()}

    def to_json(self):
        return {"kind": self.kind, "attrs": list(self.attrs), "count": self.n,
                "mean": self.mean.tolist(), "variance": self.variance.tolist()}

    @classmethod
    def _from_dict(cls, d):
        out = cls(d["attrs"])
        out.n = d["n"]
        out.sum = np.asarray(d["sum"])
        k = len(out.attrs)
        out.cross = np.asarray(d["cross"]).reshape(k, k)
        return out

    def spec(self):
        inner = ",".join(f'"{a}"' for a in self.attrs)
        return f"DescriptiveStats({inner})"


# -- GroupBy -----------------------------------------------------------------


@register
class GroupByStat(Stat):
    """Per-group sub-sketches (≙ GroupBy.scala)."""

    kind = "groupby"

    def __init__(self, attr: str, sub_spec: str):
        from geomesa_tpu_torch.stats.dsl import parse_stat  # cycle-free at runtime
        self.attr = attr
        self.sub_spec = sub_spec
        self._template = parse_stat(sub_spec)
        self.attrs = (attr,) + tuple(self._template.attrs)
        self.groups: Dict[object, Stat] = {}

    def observe(self, group_col: np.ndarray, *sub_cols: np.ndarray) -> None:
        g = np.asarray(group_col)
        self.observe_groups(((v, g == v) for v in np.unique(g)), *sub_cols)

    def observe_groups(self, groups, *sub_cols: np.ndarray) -> None:
        """Observe (group value, row selection) pairs, the values ascending
        (a dictionary-encoded group column selects by its codes)."""
        from geomesa_tpu_torch.stats.dsl import parse_stat
        colmap = dict(zip(self._template.attrs, sub_cols))
        for v, sel in groups:
            key = _json_key(v)
            if key not in self.groups:
                self.groups[key] = parse_stat(self.sub_spec)
            self._observe_sub(self.groups[key], sel, colmap)

    @staticmethod
    def _observe_sub(stat: Stat, sel: np.ndarray, colmap: dict) -> None:
        if isinstance(stat, SeqStat):
            for child in stat.stats:
                GroupByStat._observe_sub(child, sel, colmap)
        elif isinstance(stat, CountStat):
            stat.observe(int(sel.sum()))
        else:
            stat.observe(*[np.asarray(colmap[a])[sel] for a in stat.attrs])

    def __iadd__(self, other):
        for v, s in other.groups.items():
            if v in self.groups:
                self.groups[v] += s
            else:
                self.groups[v] = from_dict(s.to_dict())
        return self

    @property
    def is_empty(self):
        return not self.groups

    def to_dict(self):
        return {"kind": self.kind, "attr": self.attr, "sub_spec": self.sub_spec,
                "groups": [[v, s.to_dict()] for v, s in self.groups.items()]}

    def to_json(self):
        return {"kind": self.kind, "attr": self.attr,
                "groups": {str(v): s.to_json() for v, s in self.groups.items()}}

    @classmethod
    def _from_dict(cls, d):
        out = cls(d["attr"], d["sub_spec"])
        out.groups = {v: from_dict(s) for v, s in d["groups"]}
        return out

    def spec(self):
        return f'GroupBy("{self.attr}",{self.sub_spec})'


# -- SeqStat -----------------------------------------------------------------


@register
class SeqStat(Stat):
    """Ordered list of sketches observed together (≙ SeqStat)."""

    kind = "seq"

    def __init__(self, stats: Sequence[Stat]):
        self.stats = list(stats)
        seen: List[str] = []
        for s in self.stats:
            for a in s.attrs:
                if a not in seen:
                    seen.append(a)
        self.attrs = tuple(seen)

    def __iter__(self):
        return iter(self.stats)

    def __iadd__(self, other):
        for mine, theirs in zip(self.stats, other.stats):
            mine += theirs
        return self

    @property
    def is_empty(self):
        return all(s.is_empty for s in self.stats)

    def to_dict(self):
        return {"kind": self.kind, "stats": [s.to_dict() for s in self.stats]}

    def to_json(self):
        return {"kind": self.kind, "stats": [s.to_json() for s in self.stats]}

    @classmethod
    def _from_dict(cls, d):
        return cls([from_dict(s) for s in d["stats"]])

    def spec(self):
        return ";".join(s.spec() for s in self.stats)
