"""FeatureTable: the host columnar feature collection.

≙ ``geomesa_tpu.features.table``: per attribute, a host numpy column (the
durable copy the host refine reads); geometries as a ``GeometryArray``
(point or ragged); strings as
dictionary codes (int32) + a sorted vocab, exactly the reference's
``StringColumn.encode`` so device codes agree across both packages.
Feature ids are explicit strings or implicit (fid == str(row)); both stay
in the lazy ``FidRuns`` form across ``take`` and ``concat`` and read back
exactly as the reference's materialized ``fids`` array. Per-feature
visibility expressions (geomesa-security) are one more dictionary-encoded
column, ``visibility``, carried by ``take`` and ``concat``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from geomesa_tpu_torch.features.geometry import GeometryArray
from geomesa_tpu_torch.features.sft import SimpleFeatureType


@dataclass
class StringColumn:
    codes: np.ndarray           # (N,) int32 indices into vocab
    vocab: List[str]

    def __len__(self) -> int:
        return len(self.codes)

    def decode(self, idx) -> List[str]:
        return [self.vocab[c] for c in self.codes[idx]]

    @classmethod
    def encode(cls, values: Sequence[str]) -> "StringColumn":
        vocab, inverse = np.unique(np.asarray(values, dtype=object), return_inverse=True)
        return cls(inverse.astype(np.int32), [str(v) for v in vocab])

    @classmethod
    def concat(cls, parts: Sequence["StringColumn"]) -> "StringColumn":
        """Merged-vocab concatenation: codes remap through searchsorted into
        the sorted union vocab (≙ ``geomesa_tpu/features/table.py:45``)."""
        union = sorted(set().union(*(p.vocab for p in parts)))
        uarr = np.asarray(union, dtype=object)
        out = []
        for p in parts:
            remap = np.searchsorted(uarr, np.asarray(p.vocab, dtype=object))
            out.append(remap[p.codes].astype(np.int32))
        return cls(np.concatenate(out) if out else np.empty(0, np.int32),
                   [str(v) for v in union])


_NO_STRS = np.empty(0, dtype=object)


class FidRuns:
    """Feature ids kept lazy: a sequence of runs, each either

    - ``("range", start, n)``: implicit ids ``str(start)`` … ``str(start +
      n - 1)``, stored as two integers, or
    - ``("num", num, strs)``: per row an int64 ``num``; ``num >= 0`` is the
      implicit id ``str(num)``, ``num < 0`` the explicit id
      ``strs[-num - 1]``.

    The reference keeps implicit ids as ``None`` and materializes
    ``str(row)`` per table on ``take`` and ``concat``
    (``geomesa_tpu/features/table.py:61-86``, ``:193``) — 100M Python
    strings, about a minute at the store's scale. Here a row keeps its
    number until the ids are read, and every read gives exactly the
    reference's strings."""

    # runs kept apart; a longer list folds into one "num" run, so a table
    # that grew by many small appends takes rows in O(rows), not
    # O(rows x runs)
    MAX_RUNS = 64

    def __init__(self, runs: Sequence[tuple]):
        self.runs: Tuple[tuple, ...] = tuple(
            r for r in runs if self._len(r))
        self.n = sum(self._len(r) for r in self.runs)
        if len(self.runs) > self.MAX_RUNS:
            self.runs = self.take(np.arange(self.n, dtype=np.int64)).runs

    @staticmethod
    def _len(run) -> int:
        return run[2] if run[0] == "range" else len(run[1])

    @classmethod
    def implicit(cls, n: int) -> "FidRuns":
        return cls([("range", 0, int(n))])

    @classmethod
    def explicit(cls, fids) -> "FidRuns":
        strs = np.asarray(fids, dtype=object)
        return cls([("num", -1 - np.arange(len(strs), dtype=np.int64),
                     strs)])

    def __len__(self) -> int:
        return self.n

    def concat(self, other: "FidRuns") -> "FidRuns":
        return FidRuns(self.runs + other.runs)

    def take(self, idx: np.ndarray) -> "FidRuns":
        """The ids of rows ``idx``, still lazy, as one run; explicit ids
        compact to the selected ones."""
        idx = np.asarray(idx, dtype=np.int64)
        num = np.empty(len(idx), dtype=np.int64)
        strs = []
        n_str = 0
        bounds = np.cumsum([0] + [self._len(r) for r in self.runs])
        # the rows of each run, as slices of idx when idx is ascending
        which = np.searchsorted(bounds[1:], idx, side="right")
        order = None
        if len(which) > 1 and not bool((which[1:] >= which[:-1]).all()):
            order = np.argsort(which, kind="stable")
        cut = np.searchsorted(which if order is None else which[order],
                              np.arange(len(self.runs) + 1))
        for k, run in enumerate(self.runs):
            sel = slice(cut[k], cut[k + 1]) if order is None \
                else order[cut[k]:cut[k + 1]]
            local = idx[sel] - bounds[k]
            if run[0] == "range":
                num[sel] = run[1] + local
                continue
            v = run[1][local]
            neg = v < 0
            if neg.any():
                strs.append(run[2][-1 - v[neg]])
                v[neg] = -1 - (n_str + np.arange(int(neg.sum()),
                                                 dtype=np.int64))
                n_str += len(strs[-1])
            num[sel] = v
        out = FidRuns.__new__(FidRuns)
        out.runs = (("num", num,
                     np.concatenate(strs) if strs else _NO_STRS),)
        out.n = len(idx)
        return out

    def materialize(self) -> np.ndarray:
        """The reference's (n,) object array of ids."""
        out = np.empty(self.n, dtype=object)
        at = 0
        for run in self.runs:
            m = self._len(run)
            if run[0] == "range":
                out[at:at + m] = [str(i) for i in
                                  range(run[1], run[1] + m)]
            else:
                num, strs = run[1], run[2]
                seg = out[at:at + m]
                imp = num >= 0
                seg[imp] = [str(v) for v in num[imp].tolist()]
                seg[~imp] = strs[-1 - num[~imp]]
            at += m
        return out

    def isin(self, values) -> np.ndarray:
        """(n,) bool: which rows' ids equal one of ``values`` — as
        ``np.isin(fids, values)`` on the materialized ids, without building
        the implicit ones: an implicit id ``str(k)`` matches exactly the
        canonical decimal strings ``k``."""
        values = np.asarray(values, dtype=object)
        nums = sorted({int(v) for v in values.tolist()
                       if isinstance(v, str) and v.isascii() and v.isdigit()
                       and str(int(v)) == v and int(v) < 2 ** 63})
        nums = np.asarray(nums, dtype=np.int64)
        out = np.zeros(self.n, dtype=bool)
        at = 0
        for run in self.runs:
            m = self._len(run)
            seg = out[at:at + m]
            if run[0] == "range":
                hit = nums[(nums >= run[1]) & (nums < run[1] + m)]
                seg[hit - run[1]] = True
            else:
                num, strs = run[1], run[2]
                imp = num >= 0
                seg[imp] = np.isin(num[imp], nums)
                if len(strs):
                    seg[~imp] = np.isin(strs[-1 - num[~imp]], values)
            at += m
        return out


@dataclass
class FeatureTable:
    sft: SimpleFeatureType
    # values: np.ndarray | StringColumn | GeometryArray
    columns: Dict[str, object] = field(default_factory=dict)
    _n: int = 0
    # feature ids; None = implicit (fid == str(row))
    _fids: Optional[FidRuns] = None
    # per-feature visibility expressions, dictionary-encoded ('' = public;
    # None = no labels: every row public)
    visibility: Optional[StringColumn] = None

    def __len__(self) -> int:
        return self._n

    @property
    def fid_runs(self) -> FidRuns:
        return self._fids if self._fids is not None \
            else FidRuns.implicit(self._n)

    @property
    def fids(self) -> np.ndarray:
        """(N,) object array of feature ids, the reference's ``fids``
        (``geomesa_tpu/features/table.py:75``)."""
        return self.fid_runs.materialize()

    def fids_at(self, rows) -> np.ndarray:
        """Fids of the given rows, without materializing the rest."""
        return self.fid_runs.take(rows).materialize()

    @classmethod
    def build(cls, sft: SimpleFeatureType, data: Dict[str, object],
              fids=None,
              visibilities: Optional[Sequence[str]] = None
              ) -> "FeatureTable":
        """data: attribute name → column values. Geometries are a
        GeometryArray, an (x, y) point array tuple or a list of WKT;
        strings encode to dictionaries (or arrive as a StringColumn).
        ``fids``: explicit feature ids, or a ``FidRuns`` kept as it is
        (default: implicit, str(row)). ``visibilities``: per-feature
        visibility expressions ('' = public), dictionary-encoded as the
        reference's ``geomesa_tpu/features/table.py:94-142``."""
        columns: Dict[str, object] = {}
        n = None
        for attr in sft.attributes:
            if attr.name not in data:
                raise KeyError(f"Missing column {attr.name}")
            raw = data[attr.name]
            if attr.is_geometry:
                if isinstance(raw, GeometryArray):
                    col = raw
                elif isinstance(raw, tuple) and len(raw) == 2:
                    col = GeometryArray.points(raw[0], raw[1])
                else:
                    col = GeometryArray.from_wkt(list(raw))
            elif attr.type_name == "String":
                col = raw if isinstance(raw, StringColumn) else StringColumn.encode(raw)
            elif attr.type_name == "Date":
                arr = np.asarray(raw)
                if arr.dtype.kind == "M":
                    arr = arr.astype("datetime64[ms]").astype(np.int64)
                elif arr.dtype.kind in "OU":
                    arr = np.array(raw, dtype="datetime64[ms]").astype(np.int64)
                col = arr.astype(np.int64)
            else:
                col = np.asarray(raw, dtype=attr.binding)
            m = len(col)
            if n is None:
                n = m
            elif n != m:
                raise ValueError(f"Column {attr.name} length {m} != {n}")
            columns[attr.name] = col
        n = n or 0
        runs = None
        if fids is not None:
            runs = fids if isinstance(fids, FidRuns) \
                else FidRuns.explicit(fids)
            if len(runs) != n:
                raise ValueError("fids length mismatch")
        vis = None
        if visibilities is not None:
            if len(visibilities) != n:
                raise ValueError("visibilities length mismatch")
            vis = visibilities if isinstance(visibilities, StringColumn) \
                else StringColumn.encode(visibilities)
        return cls(sft, columns, _n=n, _fids=runs, visibility=vis)

    def column(self, name: str):
        return self.columns[name]

    def geometry(self) -> GeometryArray:
        attr = self.sft.geometry_attribute
        if attr is None:
            raise ValueError("No geometry attribute")
        return self.columns[attr.name]

    def take(self, idx: np.ndarray) -> "FeatureTable":
        """Host-side row gather (result hydration); fids follow."""
        idx = np.asarray(idx, dtype=np.int64)
        cols: Dict[str, object] = {}
        for name, col in self.columns.items():
            if isinstance(col, GeometryArray):
                cols[name] = col.take(idx)
            elif isinstance(col, StringColumn):
                cols[name] = StringColumn(col.codes[idx], col.vocab)
            else:
                cols[name] = col[idx]
        vis = None if self.visibility is None else StringColumn(
            self.visibility.codes[idx], self.visibility.vocab)
        return FeatureTable(self.sft, cols, _n=len(idx),
                            _fids=self.fid_runs.take(idx), visibility=vis)

    @staticmethod
    def concat(tables: Sequence["FeatureTable"]) -> "FeatureTable":
        """Concatenate tables sharing a schema (≙
        ``geomesa_tpu/features/table.py:193``): strings over the union
        vocab, fids as the runs of every part; the visibility column over
        the union of the parts' vocabularies, a part without labels public
        ('')."""
        if not tables:
            raise ValueError("No tables")
        sft = tables[0].sft
        cols: Dict[str, object] = {}
        for attr in sft.attributes:
            parts = [t.columns[attr.name] for t in tables]
            first = parts[0]
            if isinstance(first, GeometryArray):
                cols[attr.name] = GeometryArray.concat(parts)
            elif isinstance(first, StringColumn):
                cols[attr.name] = StringColumn.concat(parts)
            else:
                cols[attr.name] = np.concatenate(parts)
        runs = FidRuns([r for t in tables for r in t.fid_runs.runs])
        vis = None
        if any(t.visibility is not None for t in tables):
            vis = StringColumn.concat([
                t.visibility if t.visibility is not None
                else StringColumn(np.zeros(len(t), np.int32), [""])
                for t in tables])
        return FeatureTable(sft, cols, _n=len(runs), _fids=runs,
                            visibility=vis)
