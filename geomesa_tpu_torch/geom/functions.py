"""Binding layer: filter-IR Func nodes → the geometry catalog.

≙ ``geomesa_tpu.geom.functions``: evaluates ``ir.Func`` / ``ir.FuncCmp``
predicates and ``ir.FuncExpr`` projections over a FeatureTable of points,
lines or polygons. Two backends share one argument-evaluation core:

* host — the exact f64 oracle (``geom.oracle``); ``filter/evaluate.py``
  dispatches here with ``kernels=False``, so it stays the parity reference
  of the fused program's refine kinds;
* kernels — the device catalog (``geom.catalog``: the ``geom_unary``,
  ``geom_dist`` and ``geom_pred`` kernels) for the planner's staged refine
  (``GEOMESA_TPU_GEOM_KERNELS``, on by default, as in the reference);
  boolean predicates stay exact (banded + host-refined), scalars are the
  kernels' f32 values, with the documented bounds.

``scalar_values``/``bool_values`` default to ``kernels=False``, as the
reference's do; ``eval_filter_node`` and ``project_values`` read the knob
when ``kernels`` is None. ``device`` is where the catalog runs (the card
unless the caller names another).

Arguments evaluate to ``GeomBatch``es — (GeometryArray, idx) pairs — so
nested geometry-valued calls (st_buffer/st_centroid/st_convexHull) compose
with every predicate and with select/export projections
(``st_centroid(geom) AS c``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from geomesa_tpu_torch import config
from geomesa_tpu_torch.features import geometry as geo
from geomesa_tpu_torch.filter import geom_numpy as gn
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.geom import catalog, oracle


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


def scalar_values(table, rows: Optional[np.ndarray], name: str,
                  args: tuple, kernels: bool = False,
                  device=None) -> np.ndarray:
    """f64 values of a scalar st_* call at ``rows``."""
    if name in ("st_area", "st_length"):
        g = geom_arg(table, rows, args[0])
        idx = np.zeros(1, dtype=np.int64) if g.constant else g.idx
        if kernels:
            v = catalog.unary_values(g.arr, idx, device)[
                "area" if name == "st_area" else "length"]
        else:
            fn = oracle.area if name == "st_area" else oracle.length
            v = fn(g.arr, idx)
        return np.broadcast_to(v, (len(g.idx),)).copy() if g.constant else v
    if name == "st_distance":
        a, b = _two_args(table, rows, args, name)
        if a.constant and not b.constant:
            a, b = b, a
        if b.constant:
            lit = b.literal()
            if kernels:
                return catalog.batch_distance(a.arr, a.idx, lit, device)
            return oracle.distance(a.arr, a.idx, lit)
        # both sides row-dependent: exact per-row host loop
        return np.asarray(
            [gn.geometry_distance(a.arr, int(a.idx[k]), shp)
             for k, shp in enumerate(_pairwise_shapes(b))],
            dtype=np.float64)
    raise TypeError(f"{name} is not a scalar function")


def bool_values(table, rows: Optional[np.ndarray], name: str,
                args: tuple, kernels: bool = False,
                device=None) -> np.ndarray:
    """Exact boolean values of st_contains / st_intersects at ``rows``."""
    a, b = _two_args(table, rows, args, name)
    if name == "st_intersects":
        if a.constant and not b.constant:
            a, b = b, a
        if b.constant:
            lit = b.literal()
            if kernels:
                return catalog.batch_predicate(a.arr, a.idx, "intersects",
                                               lit, device)
            return oracle.intersects(a.arr, a.idx, lit)
        return np.asarray(
            [gn.geometry_intersects(a.arr, int(a.idx[k]), shp)
             for k, shp in enumerate(_pairwise_shapes(b))], dtype=bool)
    if name == "st_contains":
        # st_contains(a, b): a contains b
        if a.constant:
            lit = a.literal()
            if kernels:
                return catalog.batch_predicate(b.arr, b.idx, "within", lit,
                                               device)
            return oracle.contains_literal(b.arr, b.idx, lit)
        if b.constant:
            lit = b.literal()
            if kernels:
                return catalog.batch_predicate(a.arr, a.idx, "contains",
                                               lit, device)
            return oracle.feature_contains(a.arr, a.idx, lit)
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
                     kernels: Optional[bool] = None,
                     device=None) -> np.ndarray:
    """Boolean mask at ``rows`` for an ir.Func / ir.FuncCmp node, with a
    bbox prefilter for the common attr-vs-literal shapes. ``kernels`` None
    reads GEOMESA_TPU_GEOM_KERNELS; filter/evaluate.py passes False (it IS
    the host oracle)."""
    if kernels is None:
        kernels = bool(config.GEOM_KERNELS.get())
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
        vals = bool_values(table, eval_rows, f.name, f.args, kernels, device)
    else:
        from geomesa_tpu_torch.filter.evaluate import _apply_op
        s = scalar_values(table, eval_rows, f.name, f.args, kernels, device)
        vals = _apply_op(f.op, s, f.value)
    if sub is None:
        return vals
    out = np.zeros(len(r), dtype=bool)
    out[cand] = vals
    return out


# -- projections (select / export: "st_centroid(geom) AS c") -----------------


def parse_projection(spec: str):
    """Parse one ``st_fn(args) AS name`` projection term → (FuncExpr-or-
    (name, args), alias). Plain attribute names pass through as (attr,
    alias)."""
    from geomesa_tpu_torch.filter.parser import _Tokens, _parse_func_args
    text = spec.strip()
    toks = _Tokens(text)
    tok = toks.peek()
    if tok is None:
        raise ValueError("Empty projection")
    k, v = tok
    if k != "word":
        raise ValueError(f"Bad projection {spec!r}")
    name = v.lower()
    if name in ir.FUNC_NAMES:
        toks.next()
        args = _parse_func_args(toks)
        node = (name, args)
    else:
        toks.next()
        node = v
    alias = None
    if toks.peek_word() == "AS":
        toks.next()
        alias = toks.expect("word")
    if toks.peek() is not None:
        raise ValueError(f"Trailing input in projection {spec!r}")
    if alias is None:
        alias = name if isinstance(node, tuple) else v
    return node, alias


def project_values(table, rows: Optional[np.ndarray], node,
                   kernels: Optional[bool] = None, device=None):
    """Evaluate a parsed projection term at ``rows``.

    Returns (kind, values): kind 'scalar' → f64 array; kind 'geom' → list of
    (type_code, data) shapes; kind 'attr' → the raw column values.
    """
    if kernels is None:
        kernels = bool(config.GEOM_KERNELS.get())
    r = _rows_of(table, rows)
    if isinstance(node, str):
        col = table.column(node)
        if isinstance(col, geo.GeometryArray):
            return "geom", [col.shape(int(i)) for i in r]
        from geomesa_tpu_torch.features.table import StringColumn
        if isinstance(col, StringColumn):
            return "attr", [col.vocab[c] for c in col.codes[r]]
        return "attr", np.asarray(col)[r]
    name, args = node
    if name in ir.FUNC_SCALAR:
        return "scalar", scalar_values(table, r, name, args, kernels, device)
    if name in ir.FUNC_BOOLEAN:
        return "scalar", bool_values(table, r, name, args, kernels,
                                     device).astype(np.float64)
    e = ir.FuncExpr(name, args)
    if name == "st_centroid" and kernels:
        g = geom_arg(table, r, args[0])
        if not g.constant:
            u = catalog.unary_values(g.arr, g.idx, device)
            return "geom", [(geo.POINT, [float(x), float(y)])
                            for x, y in zip(u["cx"], u["cy"])]
    b = eval_funcexpr(table, r, e)
    return "geom", _pairwise_shapes(b)


def parse_projections(spec: str) -> List[tuple]:
    """Split a comma-separated projection list on TOP-LEVEL commas only
    (``st_distance(geom, POINT(1 2)) AS d, val`` is two terms, not three)
    and parse each — the ``?select=`` / ``--select`` surface grammar."""
    terms, depth, start = [], 0, 0
    for i, ch in enumerate(spec):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "," and depth == 0:
            terms.append(spec[start:i])
            start = i + 1
    terms.append(spec[start:])
    return [parse_projection(t) for t in terms if t.strip()]


def projection_columns(table, rows: Optional[np.ndarray], spec: str,
                       kernels: Optional[bool] = None,
                       device=None) -> dict:
    """Evaluate a ``?select=`` projection list → ordered {alias: values}
    with JSON-safe values: geometry terms serialize to WKT, scalars to
    floats, raw attributes to native types (the reference's REST features
    route and CLI export path read it; their port is ROADMAP.md item
    15)."""
    out: dict = {}
    for node, alias in parse_projections(spec):
        kind, vals = project_values(table, rows, node, kernels, device)
        if kind == "geom":
            out[alias] = [geo.write_wkt(*s) for s in vals]
        elif kind == "scalar":
            out[alias] = [float(v) for v in np.asarray(vals)]
        else:
            out[alias] = [v.item() if isinstance(v, np.generic) else v
                          for v in vals]
    return out
