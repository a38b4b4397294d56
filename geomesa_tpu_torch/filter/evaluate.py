"""Host numpy evaluation of the filter IR over a FeatureTable.

≙ ``geomesa_tpu.filter.evaluate``: ``evaluate`` returns a boolean mask over
the table's rows; ``evaluate_at`` evaluates only at the given candidate rows
(the refine path: the rows the device's f32 certainty bands left uncertain
re-evaluate here in exact f64, geometry predicates batched through
``geom_batch``). Feature-id filters test the table's ids
(``FidRuns.isin``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from geomesa_tpu_torch.features import geometry as geo
from geomesa_tpu_torch.features.table import FeatureTable, StringColumn
from geomesa_tpu_torch.filter import geom_batch as gb
from geomesa_tpu_torch.filter import geom_numpy as gn
from geomesa_tpu_torch.filter import ir


def evaluate(f: ir.Filter, table: FeatureTable) -> np.ndarray:
    """Boolean mask over all table rows."""
    return _eval(f, table, None)


def evaluate_at(f: ir.Filter, table: FeatureTable,
                rows: np.ndarray) -> np.ndarray:
    """Boolean mask over ``rows`` (indices into the table)."""
    return _eval(f, table, np.asarray(rows, dtype=np.int64))


def _col(table: FeatureTable, name: str, rows: Optional[np.ndarray]):
    col = np.asarray(table.column(name))
    return col if rows is None else col[rows]


def _geom_col(table: FeatureTable, attr: str) -> geo.GeometryArray:
    col = table.column(attr)
    if not isinstance(col, geo.GeometryArray):
        raise TypeError(f"Attribute {attr} is not a geometry")
    return col


def _xy(col: geo.GeometryArray, rows: Optional[np.ndarray]):
    x, y = col.point_xy()
    return (x, y) if rows is None else (x[rows], y[rows])


def _envelopes(col: geo.GeometryArray, rows: Optional[np.ndarray]):
    """Per-feature [xmin, ymin, xmax, ymax] of an extent column."""
    bb = col.bboxes()
    return bb if rows is None else bb[rows]


def _eval(f: ir.Filter, table: FeatureTable,
          rows: Optional[np.ndarray]) -> np.ndarray:
    n = len(table) if rows is None else len(rows)
    if isinstance(f, ir.Include):
        return np.ones(n, dtype=bool)
    if isinstance(f, ir.Exclude):
        return np.zeros(n, dtype=bool)
    if isinstance(f, ir.And):
        mask = np.ones(n, dtype=bool)
        for c in f.children:
            mask &= _eval(c, table, rows)
        return mask
    if isinstance(f, ir.Or):
        mask = np.zeros(n, dtype=bool)
        for c in f.children:
            mask |= _eval(c, table, rows)
        return mask
    if isinstance(f, ir.Not):
        return ~_eval(f.child, table, rows)
    if isinstance(f, ir.BBox):
        # envelope overlap; a point's envelope is the point itself
        col = _geom_col(table, f.attr)
        if col.is_points:
            x, y = _xy(col, rows)
            return (x <= f.xmax) & (x >= f.xmin) & (y <= f.ymax) \
                & (y >= f.ymin)
        bb = _envelopes(col, rows)
        return (bb[:, 0] <= f.xmax) & (bb[:, 2] >= f.xmin) \
            & (bb[:, 1] <= f.ymax) & (bb[:, 3] >= f.ymin)
    if isinstance(f, (ir.Intersects, ir.Contains, ir.Within)):
        return _spatial(f, table, rows)
    if isinstance(f, ir.Dwithin):
        return _dwithin(f, table, rows)
    if isinstance(f, ir.During):
        col = _col(table, f.attr, rows).astype(np.int64)
        lo = (col >= f.lo) if f.lo_inclusive else (col > f.lo)
        hi = (col <= f.hi) if f.hi_inclusive else (col < f.hi)
        return lo & hi
    if isinstance(f, ir.Cmp):
        return _cmp(f, table, rows)
    if isinstance(f, ir.In):
        col = table.column(f.attr)
        if isinstance(col, StringColumn):
            codes = col.codes if rows is None else col.codes[rows]
            wanted = set(f.values)
            keep = [i for i, v in enumerate(col.vocab) if v in wanted]
            return np.isin(codes, keep)
        return np.isin(_col(table, f.attr, rows), list(f.values))
    if isinstance(f, ir.IsNull):
        col = table.column(f.attr)
        if isinstance(col, StringColumn):
            codes = col.codes if rows is None else col.codes[rows]
            return np.array([col.vocab[c] == "" for c in codes], dtype=bool)
        arr = _col(table, f.attr, rows)
        return np.isnan(arr) if arr.dtype.kind == "f" \
            else np.zeros(len(arr), dtype=bool)
    if isinstance(f, (ir.Func, ir.FuncCmp)):
        # host-oracle backend only: this evaluator IS the parity reference
        # of the fused program's refine kinds
        from geomesa_tpu_torch.geom.functions import eval_filter_node
        return eval_filter_node(f, table, rows, kernels=False)
    if isinstance(f, ir.FidFilter):
        # ≙ ``geomesa_tpu/filter/evaluate.py:90``: the rows whose fid is
        # listed, without materializing implicit ids
        runs = table.fid_runs if rows is None else table.fid_runs.take(rows)
        return runs.isin(list(f.fids))
    raise NotImplementedError(f"Cannot evaluate {type(f).__name__}")


def _spatial(f, table: FeatureTable,
             rows: Optional[np.ndarray]) -> np.ndarray:
    """Intersects, Contains and Within against a literal: Within (feature
    within literal) and Contains (literal contains feature) are the same
    relation from the feature's side. Extent features go through the
    batched ragged predicates after an envelope prefilter."""
    col = _geom_col(table, f.attr)
    lit = f.geometry
    if not col.is_points:
        return _spatial_extent(f, col, rows)
    x, y = _xy(col, rows)
    out = np.zeros(len(x), dtype=bool)
    lx0, ly0, lx1, ly1 = gn.literal_bbox(lit)
    cand = np.nonzero((x <= lx1) & (x >= lx0) & (y <= ly1) & (y >= ly0))[0]
    if len(cand) == 0:
        return out
    if lit[0] in (geo.POLYGON, geo.MULTIPOLYGON):
        out[cand] = gn.points_in_polygon(x[cand], y[cand], lit)
        return out
    cand_rows = cand if rows is None else rows[cand]
    if isinstance(f, ir.Intersects):
        out[cand] = gb.batch_intersects(col, cand_rows, lit)
    else:
        out[cand] = gb.batch_within(col, cand_rows, lit)
    return out


def _spatial_extent(f, col: geo.GeometryArray,
                    rows: Optional[np.ndarray]) -> np.ndarray:
    """``_spatial`` over extent features (≙
    ``geomesa_tpu/filter/evaluate.py:123-150``)."""
    lit = f.geometry
    bb = _envelopes(col, rows)
    out = np.zeros(len(bb), dtype=bool)
    lx0, ly0, lx1, ly1 = gn.literal_bbox(lit)
    cand = np.nonzero((bb[:, 0] <= lx1) & (bb[:, 2] >= lx0)
                      & (bb[:, 1] <= ly1) & (bb[:, 3] >= ly0))[0]
    if len(cand) == 0:
        return out
    cand_rows = cand if rows is None else rows[cand]
    if isinstance(f, ir.Intersects):
        out[cand] = gb.batch_intersects(col, cand_rows, lit)
    else:
        out[cand] = gb.batch_within(col, cand_rows, lit)
    return out


def _dwithin(f: ir.Dwithin, table: FeatureTable,
             rows: Optional[np.ndarray]) -> np.ndarray:
    col = _geom_col(table, f.attr)
    if not col.is_points:
        bb = _envelopes(col, rows)
        out = np.zeros(len(bb), dtype=bool)
        lx0, ly0, lx1, ly1 = gn.literal_bbox(f.geometry)
        d = f.distance
        cand = np.nonzero((bb[:, 0] <= lx1 + d) & (bb[:, 2] >= lx0 - d)
                          & (bb[:, 1] <= ly1 + d) & (bb[:, 3] >= ly0 - d))[0]
        if len(cand):
            cand_rows = cand if rows is None else rows[cand]
            out[cand] = gb.batch_distance(col, cand_rows, f.geometry) <= d
        return out
    x, y = _xy(col, rows)
    out = np.zeros(len(x), dtype=bool)
    lx0, ly0, lx1, ly1 = gn.literal_bbox(f.geometry)
    d = f.distance
    cand = np.nonzero((x <= lx1 + d) & (x >= lx0 - d)
                      & (y <= ly1 + d) & (y >= ly0 - d))[0]
    if len(cand) == 0:
        return out
    code = f.geometry[0]
    if code in (geo.POLYGON, geo.MULTIPOLYGON, geo.LINESTRING,
                geo.MULTILINESTRING):
        xc, yc = x[cand], y[cand]
        inside = gn.points_in_polygon(xc, yc, f.geometry) \
            if code in (geo.POLYGON, geo.MULTIPOLYGON) \
            else np.zeros(len(cand), bool)
        dist = gn.point_segment_distance(xc, yc,
                                         gn.literal_segments(f.geometry))
        out[cand] = inside | (dist <= d)
        return out
    cand_rows = cand if rows is None else rows[cand]
    out[cand] = gb.batch_distance(col, cand_rows, f.geometry) <= d
    return out


def _cmp(f: ir.Cmp, table: FeatureTable,
         rows: Optional[np.ndarray]) -> np.ndarray:
    col = table.column(f.attr)
    if isinstance(col, StringColumn):
        codes = col.codes if rows is None else col.codes[rows]
        if f.op in ("=", "<>"):
            try:
                mask = codes == col.vocab.index(f.value)
            except ValueError:
                mask = np.zeros(len(codes), dtype=bool)
            return mask if f.op == "=" else ~mask
        vals = np.array(col.vocab, dtype=object)[codes]
        return _apply_op(f.op, vals, f.value)
    return _apply_op(f.op, _col(table, f.attr, rows), f.value)


def _apply_op(op: str, arr, value) -> np.ndarray:
    if op == "=":
        return arr == value
    if op == "<>":
        return arr != value
    if op == "<":
        return arr < value
    if op == "<=":
        return arr <= value
    if op == ">":
        return arr > value
    if op == ">=":
        return arr >= value
    raise ValueError(f"Unknown op {op}")
