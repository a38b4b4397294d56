"""Stat DSL parser + columnar observation.

Copied from ``geomesa_tpu.stats.dsl`` (host-only) with its imports pointed
at this package. ``observe_table`` gives the same sketch state by a shorter
road: the order-free kinds (MinMax, Enumeration, TopK, Frequency) and a
GroupBy's groups read a ``StringColumn`` through its codes — one
``np.bincount`` of the codes, the distinct strings once — instead of an
object array of every row's string; a point layer's MinMax reads the
coordinates, not a (n, 4) bbox table (a point's bbox is (x, y, x, y)).

≙ the reference's parser-combinator Stat spec grammar (utils/stats/
Stat.scala:40-131): semicolon-separated ``Name(args)`` calls, attribute names
quoted. Examples accepted here exactly as there::

    Count()
    MinMax("dtg");Count()
    Enumeration("name");TopK("name")
    Frequency("name",12)
    Histogram("val",20,0,100)
    Z3Histogram("dtg","week")
    GroupBy("cat",Count())

``observe_table`` drives bulk observation from a FeatureTable — each sketch
receives whole numpy columns (geometry → bbox planes / point coords; dtg for
Z3Histogram → exact (bin, offset) decomposition).
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np

from geomesa_tpu_torch.curves.binnedtime import TimePeriod, max_offset, time_to_binned_time
from geomesa_tpu_torch.features.table import FeatureTable, StringColumn
from geomesa_tpu_torch.features.geometry import GeometryArray
from geomesa_tpu_torch.stats import sketches as sk

_CALL = re.compile(r"^\s*(\w+)\s*\(")


def _split_top(s: str, delim: str) -> List[str]:
    """Split on top-level ``delim`` (respects quotes and parens)."""
    out, depth, quote, cur = [], 0, None, []
    for ch in s:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
            cur.append(ch)
        elif ch == "(":
            depth += 1
            cur.append(ch)
        elif ch == ")":
            depth -= 1
            cur.append(ch)
        elif ch == delim and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur).strip())
    return [a for a in out if a]


def _split_args(body: str) -> List[str]:
    return _split_top(body, ",")


def _split_calls(spec: str) -> List[str]:
    return _split_top(spec, ";")


def _unquote(s: str) -> str:
    s = s.strip()
    if len(s) >= 2 and s[0] in "\"'" and s[-1] == s[0]:
        return s[1:-1]
    return s


def parse_stat(spec: str) -> sk.Stat:
    """Parse a Stat DSL string into a sketch (SeqStat when ';'-separated)."""
    calls = _split_calls(spec)
    if not calls:
        raise ValueError(f"Empty stat spec: {spec!r}")
    stats = [_parse_one(c) for c in calls]
    return stats[0] if len(stats) == 1 else sk.SeqStat(stats)


def _parse_one(call: str) -> sk.Stat:
    m = _CALL.match(call)
    if not m or not call.rstrip().endswith(")"):
        raise ValueError(f"Invalid stat call: {call!r}")
    name = m.group(1)
    body = call[m.end(): call.rstrip().rfind(")")]
    args = _split_args(body)
    if name == "Count":
        return sk.CountStat()
    if name == "MinMax":
        return sk.MinMaxStat(_unquote(args[0]))
    if name == "Enumeration":
        return sk.EnumerationStat(_unquote(args[0]))
    if name == "TopK":
        return sk.TopKStat(_unquote(args[0]))
    if name == "Frequency":
        return sk.FrequencyStat(_unquote(args[0]),
                                int(args[1]) if len(args) > 1 else 12)
    if name == "Histogram":
        return sk.HistogramStat(_unquote(args[0]), int(args[1]),
                                float(args[2]), float(args[3]))
    if name == "Z2Histogram":
        return sk.Z2HistogramStat(_unquote(args[0]),
                                  int(args[1]) if len(args) > 1 else 5)
    if name == "Z3Histogram":
        return sk.Z3HistogramStat(_unquote(args[0]),
                                  _unquote(args[1]) if len(args) > 1 else "week")
    if name == "DescriptiveStats":
        return sk.DescriptiveStat([_unquote(a) for a in args])
    if name == "GroupBy":
        return sk.GroupByStat(_unquote(args[0]), ",".join(args[1:]))
    raise ValueError(f"Unknown stat: {name!r}")


# -- columnar observation ----------------------------------------------------


def _raw_column(table: FeatureTable, attr: str) -> np.ndarray:
    col = table.columns[attr]
    if isinstance(col, StringColumn):
        return np.asarray(col.vocab, dtype=object)[col.codes]
    if isinstance(col, GeometryArray):
        raise TypeError("geometry columns are observed via bbox/point paths")
    return np.asarray(col)


# the sketch kinds whose observe depends only on the multiset of values
_COUNTED = (sk.MinMaxStat, sk.EnumerationStat, sk.TopKStat, sk.FrequencyStat)


def _distinct(col: StringColumn):
    """(distinct strings ascending as an object array, int64 counts) of a
    dictionary-encoded column — what ``np.unique(values,
    return_counts=True)`` gives over its decoded rows. A vocabulary may be
    unsorted, hold entries no row uses, or repeat a string."""
    counts = np.bincount(col.codes, minlength=len(col.vocab))
    used = np.flatnonzero(counts)
    vals = np.empty(len(used), dtype=object)
    vals[:] = [col.vocab[i] for i in used]
    uniq, inv = np.unique(vals, return_inverse=True)
    cnt = np.zeros(len(uniq), dtype=np.int64)
    np.add.at(cnt, inv.reshape(-1), counts[used])
    return uniq, cnt


def _coded_groups(col: StringColumn):
    """(value, row selection) for each distinct string of a coded column,
    ascending (``GroupByStat.observe``'s ``np.unique`` loop)."""
    counts = np.bincount(col.codes, minlength=len(col.vocab))
    by_value = {}
    for i in np.flatnonzero(counts):
        by_value.setdefault(col.vocab[i], []).append(i)
    for v in sorted(by_value):
        codes = by_value[v]
        yield v, (col.codes == codes[0] if len(codes) == 1
                  else np.isin(col.codes, codes))


def observe_table(stat: sk.Stat, table: FeatureTable,
                  mask: Optional[np.ndarray] = None) -> sk.Stat:
    """Observe every row of ``table`` (optionally mask-filtered) into ``stat``."""
    sub = table if mask is None else table.take(np.nonzero(mask)[0])
    n = len(sub)
    if isinstance(stat, sk.SeqStat):
        for s in stat.stats:
            observe_table(s, sub)
        return stat
    if isinstance(stat, sk.CountStat):
        stat.observe(n)
        return stat
    if isinstance(stat, sk.Z3HistogramStat):
        period = TimePeriod.parse(stat.period)
        ms = np.asarray(sub.columns[stat.dtg], dtype=np.int64)
        if len(ms) == 0:
            return stat

        def table(a, b):
            bins, offs = time_to_binned_time(ms[a:b], period)
            return stat.span_table(bins, offs, max_offset(period))
        stat.observe_tables(sk._chunks(len(ms), table))
        return stat
    if isinstance(stat, sk.Z2HistogramStat):
        garr = sub.columns[stat.attr]
        if garr.is_points:
            x, y = garr.point_xy()
        else:
            bb = garr.bboxes()
            x, y = (bb[:, 0] + bb[:, 2]) / 2, (bb[:, 1] + bb[:, 3]) / 2
        stat.observe(x, y)
        return stat
    if isinstance(stat, sk.MinMaxStat):
        col = sub.columns[stat.attr]
        if isinstance(col, GeometryArray):
            stat.geometric = True
            if col.is_points:
                x, y = col.point_xy()
                stat.observe(x, y, x, y)
            else:
                bb = col.bboxes()
                stat.observe(bb[:, 0], bb[:, 1], bb[:, 2], bb[:, 3])
            return stat
    if isinstance(stat, sk.GroupByStat):
        sub_cols = [_raw_column(sub, a) for a in stat._template.attrs]
        col = sub.columns[stat.attr]
        if isinstance(col, StringColumn):
            stat.observe_groups(_coded_groups(col), *sub_cols)
        else:
            stat.observe(_raw_column(sub, stat.attr), *sub_cols)
        return stat
    if isinstance(stat, _COUNTED) and \
            isinstance(sub.columns.get(stat.attrs[0]), StringColumn):
        stat.observe_counts(*_distinct(sub.columns[stat.attrs[0]]))
        return stat
    stat.observe(*[_raw_column(sub, a) for a in stat.attrs])
    return stat
