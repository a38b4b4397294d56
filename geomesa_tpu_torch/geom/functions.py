"""Binding layer: filter-IR Func nodes → the geometry functions.

≙ ``geomesa_tpu.geom.functions`` with ``kernels=False``, the reference's
default: evaluates ``ir.Func`` / ``ir.FuncCmp`` predicates and
``ir.FuncExpr`` values over a FeatureTable of points, lines or polygons
with the exact f64 host oracle (``geom.oracle``). ``filter/evaluate.py``
dispatches here, so it stays the parity reference of the fused program's
refine kinds. The reference's second backend, the device catalog
(``kernels=True``, ``geom/catalog.py``), is ROADMAP.md Queue 1, item 13,
and raises naming it.

Arguments evaluate to ``GeomBatch``es — (GeometryArray, idx) pairs — so nested
geometry-valued calls (st_buffer/st_centroid/st_convexHull) compose with
every predicate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from geomesa_tpu_torch.features import geometry as geo
from geomesa_tpu_torch.filter import geom_numpy as gn
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.geom import oracle
from geomesa_tpu_torch.index.api import not_ported


@dataclass
class GeomBatch:
    """A per-row geometry value: ``arr[idx[k]]`` is row k's geometry."""
    arr: geo.GeometryArray
    idx: np.ndarray
    constant: bool            # one shared geometry broadcast to every row
    attr: Optional[str] = None   # set when this is the raw geometry column

    def literal(self) -> tuple:
        """The shared (type_code, data) literal of a constant batch."""
        return self.arr.shape(int(self.idx[0]) if len(self.idx) else 0)


def _rows_of(table, rows: Optional[np.ndarray]) -> np.ndarray:
    if rows is None:
        return np.arange(len(table), dtype=np.int64)
    return np.asarray(rows, dtype=np.int64)


def geom_arg(table, rows: Optional[np.ndarray], arg) -> GeomBatch:
    """Evaluate one function argument to a GeomBatch."""
    r = _rows_of(table, rows)
    if isinstance(arg, str):
        col = table.column(arg)
        if not isinstance(col, geo.GeometryArray):
            raise TypeError(f"Attribute {arg} is not a geometry")
        return GeomBatch(col, r, False, arg)
    if isinstance(arg, ir.FuncExpr):
        return eval_funcexpr(table, rows, arg)
    if isinstance(arg, tuple) and len(arg) == 2 and isinstance(arg[0], int):
        lit = geo.GeometryArray.from_shapes([arg])
        return GeomBatch(lit, np.zeros(len(r), dtype=np.int64), True)
    raise TypeError(f"Bad geometry argument {arg!r}")


def eval_funcexpr(table, rows: Optional[np.ndarray],
                  e: ir.FuncExpr) -> GeomBatch:
    """st_buffer / st_centroid / st_convexHull → a new GeomBatch (host f64,
    collapsing constant inputs to a single computed geometry)."""
    g = geom_arg(table, rows, e.args[0])
    idx = np.zeros(1, dtype=np.int64) if g.constant else g.idx
    if e.name == "st_centroid":
        cx, cy = oracle.centroid(g.arr, idx)
        out = geo.GeometryArray.points(cx, cy)
    elif e.name == "st_convexhull":
        out = geo.GeometryArray.from_shapes(
            oracle.convex_hull_shapes(g.arr, idx))
    elif e.name == "st_buffer":
        if len(e.args) < 2 or not isinstance(e.args[1], float):
            raise TypeError("st_buffer needs a numeric distance")
        out = geo.GeometryArray.from_shapes(
            oracle.buffer_shapes(g.arr, idx, float(e.args[1])))
    else:
        raise TypeError(f"{e.name} is not geometry-valued")
    if g.constant:
        n = len(g.idx)
        return GeomBatch(out, np.zeros(n, dtype=np.int64), True)
    return GeomBatch(out, np.arange(len(idx), dtype=np.int64), False)


def _two_args(table, rows, args, name: str) -> Tuple[GeomBatch, GeomBatch]:
    if len(args) != 2:
        raise TypeError(f"{name} takes 2 geometry arguments")
    return geom_arg(table, rows, args[0]), geom_arg(table, rows, args[1])


def _pairwise_shapes(b: GeomBatch) -> List[tuple]:
    return [b.arr.shape(int(i)) for i in b.idx]


def _no_kernels(kernels: bool) -> None:
    if kernels:
        raise not_ported("the device geometry catalog (geom/catalog.py)", 13)


def scalar_values(table, rows: Optional[np.ndarray], name: str,
                  args: tuple, kernels: bool = False) -> np.ndarray:
    """f64 values of a scalar st_* call at ``rows``."""
    _no_kernels(kernels)
    if name in ("st_area", "st_length"):
        g = geom_arg(table, rows, args[0])
        idx = np.zeros(1, dtype=np.int64) if g.constant else g.idx
        fn = oracle.area if name == "st_area" else oracle.length
        v = fn(g.arr, idx)
        return np.broadcast_to(v, (len(g.idx),)).copy() if g.constant else v
    if name == "st_distance":
        a, b = _two_args(table, rows, args, name)
        if a.constant and not b.constant:
            a, b = b, a
        if b.constant:
            return oracle.distance(a.arr, a.idx, b.literal())
        # both sides row-dependent: exact per-row host loop
        return np.asarray(
            [gn.geometry_distance(a.arr, int(a.idx[k]), shp)
             for k, shp in enumerate(_pairwise_shapes(b))],
            dtype=np.float64)
    raise TypeError(f"{name} is not a scalar function")


def bool_values(table, rows: Optional[np.ndarray], name: str,
                args: tuple, kernels: bool = False) -> np.ndarray:
    """Exact boolean values of st_contains / st_intersects at ``rows``."""
    _no_kernels(kernels)
    a, b = _two_args(table, rows, args, name)
    if name == "st_intersects":
        if a.constant and not b.constant:
            a, b = b, a
        if b.constant:
            return oracle.intersects(a.arr, a.idx, b.literal())
        return np.asarray(
            [gn.geometry_intersects(a.arr, int(a.idx[k]), shp)
             for k, shp in enumerate(_pairwise_shapes(b))], dtype=bool)
    if name == "st_contains":
        # st_contains(a, b): a contains b
        if a.constant:
            return oracle.contains_literal(b.arr, b.idx, a.literal())
        if b.constant:
            return oracle.feature_contains(a.arr, a.idx, b.literal())
        return np.concatenate(
            [oracle.feature_contains(a.arr, a.idx[k: k + 1], shp)
             for k, shp in enumerate(_pairwise_shapes(b))]) \
            if len(a.idx) else np.zeros(0, dtype=bool)
    raise TypeError(f"{name} is not a boolean predicate")


def _prefilter_box(f) -> Optional[Tuple[str, float, float, float, float]]:
    """(attr, xmin, ymin, xmax, ymax) bbox prefilter for a Func/FuncCmp on
    the raw geometry column vs a constant literal, or None. Sound: every
    matching feature's bbox overlaps the box."""
    if isinstance(f, ir.Func):
        args = f.args
        attr = lit = None
        for a in args:
            if isinstance(a, str):
                attr = a
            elif isinstance(a, tuple):
                lit = a
        if attr is None or lit is None or len(args) != 2:
            return None
        x0, y0, x1, y1 = gn.literal_bbox(lit)
        return attr, x0, y0, x1, y1
    if isinstance(f, ir.FuncCmp) and f.name == "st_distance" \
            and f.op in ("<", "<="):
        attr = lit = None
        for a in f.args:
            if isinstance(a, str):
                attr = a
            elif isinstance(a, tuple):
                lit = a
        if attr is None or lit is None or len(f.args) != 2:
            return None
        d = max(float(f.value), 0.0)
        x0, y0, x1, y1 = gn.literal_bbox(lit)
        return attr, x0 - d, y0 - d, x1 + d, y1 + d
    return None


def eval_filter_node(f, table, rows: Optional[np.ndarray],
                     kernels: bool = False) -> np.ndarray:
    """Boolean mask at ``rows`` for an ir.Func / ir.FuncCmp node, with a
    bbox prefilter for the common attr-vs-literal shapes (host oracle;
    ``kernels=True``, the device catalog, is not ported)."""
    _no_kernels(kernels)
    r = _rows_of(table, rows)
    pre = _prefilter_box(f)
    sub = None
    if pre is not None:
        attr, x0, y0, x1, y1 = pre
        col = table.column(attr)
        if isinstance(col, geo.GeometryArray):
            bb = col.bboxes()[r]
            cand = np.nonzero((bb[:, 0] <= x1) & (bb[:, 2] >= x0)
                              & (bb[:, 1] <= y1) & (bb[:, 3] >= y0))[0]
            out = np.zeros(len(r), dtype=bool)
            if len(cand) == 0:
                return out
            sub = r[cand]
    eval_rows = r if sub is None else sub
    if isinstance(f, ir.Func):
        vals = bool_values(table, eval_rows, f.name, f.args, kernels)
    else:
        from geomesa_tpu_torch.filter.evaluate import _apply_op
        s = scalar_values(table, eval_rows, f.name, f.args, kernels)
        vals = _apply_op(f.op, s, f.value)
    if sub is None:
        return vals
    out = np.zeros(len(r), dtype=bool)
    out[cand] = vals
    return out
