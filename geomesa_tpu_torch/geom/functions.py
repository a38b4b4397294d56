"""Binding layer: filter-IR Func nodes → the geometry functions.

≙ ``geomesa_tpu.geom.functions``: evaluates ``ir.Func`` / ``ir.FuncCmp``
predicates over a point FeatureTable with the exact f64 host oracle
(``geom.oracle``). ``filter/evaluate.py`` dispatches here, so it stays the
parity reference of the fused program's refine kinds. The reference's
second backend, the device catalog (``kernels=True``, ``geom/catalog.py``),
and derived geometries with ragged output (``st_buffer``,
``st_convexHull``) are ROADMAP.md Queue 1, item 13.

Arguments evaluate to ``GeomBatch``es — a point column with per-row
indices, or one literal shared by every row — so ``st_centroid`` (a point
layer's centroids are its points) composes with every predicate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from geomesa_tpu_torch.features import geometry as geo
from geomesa_tpu_torch.filter import geom_numpy as gn
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.geom import oracle
from geomesa_tpu_torch.index.api import not_ported


@dataclass
class GeomBatch:
    """A per-row geometry value: ``arr[idx[k]]`` is row k's geometry. A
    constant batch holds one literal shared by every row (``lit``); a POINT
    literal is a one-point ``arr`` too, other literals have no ``arr``."""
    arr: Optional[geo.GeometryArray]
    idx: np.ndarray
    constant: bool
    lit: Optional[tuple] = None

    def literal(self) -> tuple:
        """The shared (type_code, data) literal of a constant batch."""
        return self.lit

    def points(self) -> geo.GeometryArray:
        """The point geometries of this batch's rows."""
        if self.arr is None:
            raise not_ported(f"st_* functions of a literal of geometry type "
                             f"{self.lit[0]} (the geometry catalog)", 13)
        return self.arr


def _points_only(col: geo.GeometryArray) -> None:
    """st_* functions read point features only (the ragged oracle is not
    ported)."""
    if not col.is_points:
        raise not_ported("st_* functions over extent features (the ragged "
                         "geom/oracle.py)", 9)


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
        _points_only(col)
        return GeomBatch(col, r, False)
    if isinstance(arg, ir.FuncExpr):
        return eval_funcexpr(table, rows, arg)
    if isinstance(arg, tuple) and len(arg) == 2 and isinstance(arg[0], int):
        arr = None
        if arg[0] == geo.POINT:
            arr = geo.GeometryArray.points([arg[1][0]], [arg[1][1]])
        return GeomBatch(arr, np.zeros(len(r), dtype=np.int64), True,
                         lit=arg)
    raise TypeError(f"Bad geometry argument {arg!r}")


def eval_funcexpr(table, rows: Optional[np.ndarray],
                  e: ir.FuncExpr) -> GeomBatch:
    """``st_centroid`` → a new GeomBatch (host f64). ``st_buffer`` and
    ``st_convexHull`` build polygons, which need the geometry catalog."""
    if e.name != "st_centroid":
        if e.name in ("st_buffer", "st_convexhull"):
            raise not_ported(f"{e.name} (derived geometries with ragged "
                             "output, the geometry catalog)", 13)
        raise TypeError(f"{e.name} is not geometry-valued")
    g = geom_arg(table, rows, e.args[0])
    if g.constant:
        return g   # a point literal is its own centroid
    cx, cy = oracle.centroid(g.arr, g.idx)
    return GeomBatch(geo.GeometryArray.points(cx, cy),
                     np.arange(len(g.idx), dtype=np.int64), False)


def _two_args(table, rows, args, name: str) -> Tuple[GeomBatch, GeomBatch]:
    if len(args) != 2:
        raise TypeError(f"{name} takes 2 geometry arguments")
    return geom_arg(table, rows, args[0]), geom_arg(table, rows, args[1])


def _pairwise_shapes(b: GeomBatch) -> list:
    return [b.points().shape(int(i)) for i in b.idx]


def _no_kernels(kernels: bool) -> None:
    if kernels:
        raise not_ported("the device geometry catalog (geom/catalog.py)", 13)


def scalar_values(table, rows: Optional[np.ndarray], name: str,
                  args: tuple, kernels: bool = False) -> np.ndarray:
    """f64 values of a scalar st_* call at ``rows``."""
    _no_kernels(kernels)
    if name in ("st_area", "st_length"):
        g = geom_arg(table, rows, args[0])
        fn = oracle.area if name == "st_area" else oracle.length
        return fn(g.points(), g.idx)
    if name == "st_distance":
        a, b = _two_args(table, rows, args, name)
        if a.constant and not b.constant:
            a, b = b, a
        if b.constant:
            return oracle.distance(a.points(), a.idx, b.literal())
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
            return oracle.intersects(a.points(), a.idx, b.literal())
        return np.asarray(
            [gn.geometry_intersects(a.arr, int(a.idx[k]), shp)
             for k, shp in enumerate(_pairwise_shapes(b))], dtype=bool)
    if name == "st_contains":
        # st_contains(a, b): a contains b
        if a.constant:
            return oracle.contains_literal(b.points(), b.idx, a.literal())
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
            _points_only(col)
            # a point's bbox is the point itself
            x, y = col.point_xy()
            x, y = x[r], y[r]
            cand = np.nonzero((x <= x1) & (x >= x0)
                              & (y <= y1) & (y >= y0))[0]
            out = np.zeros(len(r), dtype=bool)
            if len(cand) == 0:
                return out
            sub = r[cand]
    eval_rows = r if sub is None else sub
    if isinstance(f, ir.Func):
        vals = bool_values(table, eval_rows, f.name, f.args)
    else:
        from geomesa_tpu_torch.filter.evaluate import _apply_op
        s = scalar_values(table, eval_rows, f.name, f.args)
        vals = _apply_op(f.op, s, f.value)
    if sub is None:
        return vals
    out = np.zeros(len(r), dtype=bool)
    out[cand] = vals
    return out
