"""The attribute index: value-sorted rows with a spatio-temporal tier (≙
``geomesa_tpu.index.attribute``, AttributeIndexKeySpace.scala:35 and
AttributeIndexKey.scala:23-79).

One index an indexed attribute (``index=true``/``full``/``join`` on the
attribute, or ``attr:<name>`` in ``geomesa.indices``). Its rows sort by
(value, bin, off) — the value first, then the Z3 tier's binned time when
the schema has a date — ties by table row, exactly the reference's
``np.lexsort``; string columns sort by dictionary code (vocabularies are
sorted, so code order is lexicographic order). The sort runs on the device
(``device_sort_perm``) over order-preserving integer keys
(``value_keys``): integers as they are, floats by their bit patterns with
-0.0 made 0.0 and every NaN one key past +inf (numpy's order: -0.0 ties
with 0.0, NaN last); only an attribute whose values have no such key (an
object column) takes the host ``np.lexsort``. Built beside a spatial index
over the same table (``base``), the index takes the tier and every query
column from that index's device planes, through the permutations, instead
of encoding and uploading the table again.

Query path: equality, range and ``IN`` predicates on the attribute become
``searchsorted`` slices of the host copy of the sorted values (≙ the row
ranges of GeoMesaFeatureIndex.getQueryStrategy); the plan carries them as
``candidate_slices``, and the staged scan reads only those runs of rows
(``ScanKernels.count_at``/``select_at``: ``fused_scan``'s RUNS form),
applying the remaining boxes, windows and residual there. The slices are
sorted and merged, so a row is a candidate once: the reference keeps one
slice a listed ``IN`` value, and a repeated value scans its rows twice
(ROADMAP.md, "Found in the reference, not the port").
"""

from __future__ import annotations

import math
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from geomesa_tpu_torch.curves.binnedtime import time_to_binned_time
from geomesa_tpu_torch.features.table import StringColumn
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.index.api import IndexScanPlan
from geomesa_tpu_torch.index.device import DeviceTable, host_planes, sync
from geomesa_tpu_torch.index.spatial import BaseSpatialIndex, device_sort_perm

# predicates an attribute slice consumes entirely
_RANGE_OPS = {"=", "<", "<=", ">", ">="}
_INDEX_OPTS = ("true", "full", "join")


def indexed_attributes(sft) -> List[str]:
    """Attributes flagged for indexing: ``index=true``/``full``/``join``
    options plus ``attr:X`` entries of ``geomesa.indices`` (≙
    ``geomesa_tpu/index/attribute.py:33``)."""
    out = []
    for a in sft.attributes:
        if a.is_geometry:
            continue
        if a.options.get("index", "").lower() in _INDEX_OPTS:
            out.append(a.name)
    raw = sft.user_data.get("geomesa.indices", "")
    for part in raw.split(","):
        if ":" in part:
            name, _, attr = part.partition(":")
            if name == "attr" and attr and attr not in out:
                out.append(attr)
    return out


# float dtype -> (int dtype of its bits, low bits of the magnitude, NaN key)
_FLOAT_KEYS = {np.dtype(np.float32): (np.int32, 0x7FFFFFFF, 0x7FC00000),
               np.dtype(np.float64): (np.int64, 0x7FFFFFFFFFFFFFFF,
                                      0x7FF8000000000000)}


def value_keys(values: np.ndarray) -> Optional[np.ndarray]:
    """Integer keys that sort as numpy sorts ``values`` (ties included), or
    None when the values have none (an object column): integers as they
    are, booleans as 0/1, floats by their bits — -0.0 made 0.0, a negative
    value's magnitude bits flipped, every NaN one key past +inf."""
    v = np.asarray(values)
    if v.dtype.kind in "iu":
        return v
    if v.dtype.kind == "b":
        return v.astype(np.int32)
    if v.dtype.kind == "f":
        if v.dtype not in _FLOAT_KEYS:
            v = v.astype(np.float32)
        it, low, nan = _FLOAT_KEYS[v.dtype]
        bits = np.where(v == 0, np.zeros((), v.dtype), v).view(it)
        bits = np.where(np.isnan(v), it(nan), bits)
        return np.where(bits < 0, bits ^ it(low), bits)
    return None


def keys_to_values(keys: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """The values of ``value_keys`` in the column's dtype (a float's -0.0
    comes back as 0.0 and its NaNs as one NaN, which sort and compare
    alike)."""
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        if dtype not in _FLOAT_KEYS:
            dtype = np.dtype(np.float32)
        it, low, _ = _FLOAT_KEYS[dtype]
        k = np.asarray(keys, dtype=it)
        return np.where(k < 0, k ^ it(low), k).view(dtype)
    if dtype.kind == "b":
        return np.asarray(keys).astype(bool)
    return np.asarray(keys)


def _key_of(dtype: np.dtype, v, side: str):
    """``v`` as a scalar of ``dtype`` that ``np.searchsorted`` counts alike
    on ``side`` — the least value not below ``v`` ("left": the elements
    under ``v``), the greatest not above it ("right": those at most ``v``)
    — or None (a value of another kind, NaN, out of an integer dtype's
    range)."""
    if isinstance(v, (bool, np.bool_)) or not isinstance(
            v, (int, float, np.integer, np.floating)) or dtype.kind == "b":
        return None
    if dtype.kind in "iu":
        if isinstance(v, (float, np.floating)):
            if not math.isfinite(v):
                return None
            v = math.ceil(v) if side == "left" else math.floor(v)
        info = np.iinfo(dtype)
        return dtype.type(v) if info.min <= int(v) <= info.max else None
    if dtype.kind != "f" or (isinstance(v, (int, np.integer))
                             and abs(int(v)) > 2 ** 53):
        return None
    x = float(v)
    if x != x:
        return None
    with np.errstate(over="ignore"):
        k = dtype.type(x)
    if side == "left" and float(k) < x:
        k = np.nextafter(k, dtype.type(np.inf))
    elif side == "right" and float(k) > x:
        k = np.nextafter(k, dtype.type(-np.inf))
    return k


def search(sv: np.ndarray, v, side: str = "left") -> int:
    """``np.searchsorted(sv, v, side)`` without widening ``sv``: numpy
    compares a Python or wider scalar by converting the whole array (about
    a second at 100M rows), so ``v`` goes in as ``sv``'s own dtype
    (``_key_of``) wherever that keeps the answer."""
    k = _key_of(sv.dtype, v, side)
    return int(np.searchsorted(sv, v if k is None else k, side=side))


class AttributeIndex(BaseSpatialIndex):
    """One instance an indexed attribute (as the reference's: one
    GeoMesaFeatureIndex an attribute, with the secondary tier)."""

    name = "attr"
    temporal = True   # the tier carries (bin, off) when the sft has a dtg
    points = True

    def __init__(self, sft, table, attr: str, device=None,
                 base: Optional[BaseSpatialIndex] = None):
        self.attr = attr
        spec = sft.attribute(attr)
        self.type_name = spec.type_name
        g = sft.geometry_attribute
        self.points = g is not None and g.type_name == "Point"
        self._base = base
        super().__init__(sft, table, device)
        self._base = None

    @classmethod
    def supports(cls, sft) -> bool:
        return bool(indexed_attributes(sft))

    # the build -------------------------------------------------------------

    def _raw_values(self) -> np.ndarray:
        col = self.table.columns[self.attr]
        if isinstance(col, StringColumn):
            self._vocab = col.vocab
            return np.asarray(col.codes)
        self._vocab = None
        return np.asarray(col)

    def _tier(self) -> List[np.ndarray]:
        if self.dtg is None:
            return []
        ms = np.asarray(self.table.columns[self.dtg], dtype=np.int64)
        bins, offs = time_to_binned_time(ms, self.period)
        return [np.asarray(bins), np.asarray(offs)]

    def _sort_keys(self) -> List[np.ndarray]:
        """(value key, bin, off) per table row (the numpy build's keys)."""
        vals = self._raw_values()
        self._dtype = vals.dtype
        return [value_keys(vals)] + self._tier()

    def _build_native(self, dev: torch.device) -> bool:
        """The build beside ``base`` (a spatial index over the same table
        holding every query plane), else an object column's host lexsort;
        False leaves the numpy build (host keys and planes)."""
        base = self._base
        vals = self._raw_values()
        self._dtype = vals.dtype
        keys = value_keys(vals)
        if keys is None:
            self._build_host_sort(vals, dev)
            return True
        if base is None or base.table is not self.table or (
                self.dtg is not None
                and not {"bin", "off"} <= set(base.device.columns)):
            return False
        self._build_from(base, keys, dev)
        return True

    def _build_host_sort(self, vals: np.ndarray, dev: torch.device) -> None:
        """The reference's host ``np.lexsort`` (values without integer
        keys), then the planes through its permutation."""
        st = self.build_stages
        t0 = time.perf_counter()
        perm = np.lexsort(tuple(reversed([vals] + self._tier())))
        self._perm_cache = perm.astype(np.int64)
        self.perm = torch.from_numpy(self._perm_cache).to(dev)
        self._sorted_vals = vals[perm]
        st["host_sort_s"] = time.perf_counter() - t0
        self.device = DeviceTable.build_sorted(
            host_planes(self.table, self.period), self.perm, st)

    def _build_from(self, base: BaseSpatialIndex, keys: np.ndarray,
                    dev: torch.device) -> None:
        """Sort on the device by (value key, bin, off) in table order — the
        tier scattered back from ``base``'s planes — and gather every one
        of ``base``'s columns through (base position of each row) o (this
        index's permutation). Stages ``upload_s`` (the value keys),
        ``tier_s``, ``sort_s``, ``gather_s`` and ``sorted_vals_s`` (the
        sorted values read back for planning)."""
        st = self.build_stages
        n = len(self.table)
        t0 = time.perf_counter()
        kv = torch.from_numpy(np.ascontiguousarray(keys)).to(dev)
        sync(dev)
        t1 = time.perf_counter()
        dkeys = [kv]
        for name in (("bin", "off") if self.dtg is not None else ()):
            c = base.device.columns[name]
            dkeys.append(torch.empty_like(c).index_copy_(0, base.perm, c))
        sync(dev)
        t2 = time.perf_counter()
        self.perm = device_sort_perm(dkeys)
        del dkeys
        sync(dev)
        t3 = time.perf_counter()
        inv = torch.empty(n, dtype=torch.int64, device=dev).index_copy_(
            0, base.perm, torch.arange(n, dtype=torch.int64, device=dev))
        at = inv.index_select(0, self.perm)
        del inv
        cols = {k: v.index_select(0, at)
                for k, v in base.device.columns.items()}
        del at
        self.device = DeviceTable(n, cols)
        sync(dev)
        t4 = time.perf_counter()
        sorted_keys = kv.index_select(0, self.perm).cpu().numpy()
        del kv
        self._sorted_vals = keys_to_values(sorted_keys, self._dtype)
        st.update(upload_s=t1 - t0, tier_s=t2 - t1, sort_s=t3 - t2,
                  gather_s=t4 - t3,
                  sorted_vals_s=time.perf_counter() - t4)

    @property
    def sorted_vals(self) -> np.ndarray:
        """The attribute's values in index order (host), the slices'
        ``searchsorted`` domain."""
        sv = getattr(self, "_sorted_vals", None)
        if sv is None:
            keys = value_keys(self._raw_values())
            sv = keys_to_values(torch.from_numpy(np.ascontiguousarray(keys))
                                .to(self.perm.device).index_select(
                                    0, self.perm).cpu().numpy(), self._dtype)
            self._sorted_vals = sv
        return sv

    # predicate extraction ----------------------------------------------------

    def _split_attr_predicate(self, f: ir.Filter):
        """(consumable predicates on the attribute, remaining filter). Only
        AND-rooted (or single) filters qualify — an OR across attributes
        falls back to other strategies (≙ FilterSplitter per-index
        primaries)."""
        if isinstance(f, ir.Or):
            return [], f
        children = f.children if isinstance(f, ir.And) else (f,)
        mine, rest = [], []
        for c in children:
            if isinstance(c, ir.Cmp) and c.attr == self.attr \
                    and c.op in _RANGE_OPS:
                mine.append(c)
            elif isinstance(c, ir.In) and c.attr == self.attr:
                mine.append(c)
            else:
                rest.append(c)
        return mine, (ir.and_filters(rest) if rest else None)

    def _value_key(self, v):
        """User value → sort-domain value; TypeError for a string against a
        numeric column (a date literal on a Date attribute among them),
        which the general path then answers as it does without the
        index."""
        if self._vocab is not None:
            return np.searchsorted(np.asarray(self._vocab, dtype=object), v), v
        if isinstance(v, str):
            raise TypeError(f"{self.attr} compares numbers, not {v!r}")
        return v, v

    def _slices(self, preds) -> List[Tuple[int, int]]:
        """Sorted, disjoint candidate [lo, hi) position slices of the
        predicates (≙ ``geomesa_tpu/index/attribute.py:124-169``, whose
        slices stay one a listed value: here equal and overlapping slices
        merge). NaN rows, sorted last, satisfy no comparison, as in numpy
        (the reference's ``>``/``>=`` slices run to the end and take them).
        Raises TypeError for a value the column cannot compare."""
        sv = self.sorted_vals
        n = len(sv)
        lo, hi = 0, n
        if sv.dtype.kind == "f":
            hi = int(np.searchsorted(sv, sv.dtype.type(np.nan), side="left"))
        points: Optional[List[Tuple[int, int]]] = None
        for p in preds:
            if isinstance(p, ir.In):
                pts = [self._eq_slice(v) for v in p.values]
                points = pts if points is None else [
                    (max(l0, l1), min(h0, h1))
                    for (l0, h0) in points for (l1, h1) in pts]
                continue
            code, raw = self._value_key(p.value)
            if self._vocab is not None:
                # string order: codes are lexicographic. The bound maps to
                # a code cutpoint first (codes < cut satisfy </<=, codes >=
                # cut satisfy >/>=), so a bound outside the vocabulary is
                # exact
                if p.op == "=":
                    l, h = self._eq_slice(raw)
                    lo, hi = max(lo, l), min(hi, h)
                    continue
                vocab = np.asarray(self._vocab, dtype=object)
                vside = "left" if p.op in ("<", ">=") else "right"
                cut = int(np.searchsorted(vocab, raw, side=vside))
                pos = search(sv, cut, "left")
                if p.op in ("<", "<="):
                    hi = min(hi, pos)
                else:
                    lo = max(lo, pos)
                continue
            if p.op == "=":
                lo = max(lo, search(sv, code, "left"))
                hi = min(hi, search(sv, code, "right"))
            elif p.op in ("<", "<="):
                hi = min(hi, search(sv, code, "left" if p.op == "<"
                                    else "right"))
            else:
                lo = max(lo, search(sv, code, "right" if p.op == ">"
                                    else "left"))
        if points is None:
            return [(lo, hi)] if hi > lo else []
        merged: List[Tuple[int, int]] = []
        for l, h in sorted((max(l, lo), min(h, hi)) for l, h in points):
            if h <= l:
                continue
            if merged and l <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], h))
            else:
                merged.append((l, h))
        return merged

    def _eq_slice(self, v) -> Tuple[int, int]:
        sv = self.sorted_vals
        if self._vocab is not None:
            vocab = np.asarray(self._vocab, dtype=object)
            pos = int(np.searchsorted(vocab, v))
            if pos >= len(vocab) or vocab[pos] != v:
                return (0, 0)
            v = pos
        elif isinstance(v, str):
            raise TypeError(f"{self.attr} compares numbers, not {v!r}")
        return search(sv, v, "left"), search(sv, v, "right")

    # planning ----------------------------------------------------------------

    def plan(self, f: ir.Filter) -> Optional[IndexScanPlan]:
        """The slice plan (≙ ``geomesa_tpu/index/attribute.py:182-210``):
        None when no predicate on the attribute can be consumed; empty
        (cost 0) when the slices hold no row; else the remaining filter's
        plan (boxes, windows, residual split) over this index with the
        slices as its candidates, cost 0.5."""
        mine, rest = self._split_attr_predicate(f)
        if not mine:
            return None
        try:
            slices = self._slices(mine)
        except TypeError:
            return None   # a value the column cannot compare
        if not slices:
            return IndexScanPlan(self, "none", empty=True, full_filter=f,
                                 cost=0.0,
                                 explain={"index": f"attr:{self.attr}"})
        base = super().plan(rest if rest is not None else ir.Include())
        base.candidate_slices = slices
        base.full_filter = f
        base.cost = 0.5 if not base.empty else 0.0
        base.explain.update({
            "index": f"attr:{self.attr}",
            "predicates": [type(p).__name__ for p in mine],
            "candidates": base.n_candidates,
        })
        return base
