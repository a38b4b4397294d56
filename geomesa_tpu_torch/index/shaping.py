"""Query result shaping: projection/transforms, sort, limit, reprojection.

≙ ``geomesa_tpu.index.shaping``, a copy: the client-side shaping chain of
GeoMesa's QueryPlanner.runQuery (geomesa-index-api
index/planning/QueryPlanner.scala:56-94) and QueryRunner's query
normalization (planning/QueryRunner.scala:185-304): transform definitions
become a projected feature type, sort + max-features trim the result, and
reprojection maps output geometries to the requested CRS.

Sort keys and limits apply to ROW INDICES before hydration (a
sorted+limited query never materializes more than `limit` features), and
transform expressions evaluate vectorized over whole columns via the
converter expression DSL (convert/expression.py) — there is no per-feature
path anywhere.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.features.table import FeatureTable, StringColumn

SortSpec = Union[str, Sequence[str]]


def _sort_key(table: FeatureTable, attr: str, rows: np.ndarray):
    """(key array ascending-sorts like the attribute, descending flag)."""
    desc = attr.startswith("-")
    name = attr[1:] if desc else attr
    col = table.columns[name] if name in table.columns else None
    if col is None:
        raise ValueError(f"No such sort attribute: {name}")
    if isinstance(col, StringColumn):
        codes = col.codes[rows]
        if list(col.vocab) != sorted(col.vocab):
            # vocab not in lexicographic order (merged/streamed tables):
            # rank-map the codes so integer order == string order
            rank = np.empty(len(col.vocab), dtype=np.int64)
            rank[np.argsort(np.asarray(col.vocab, dtype=object))] = \
                np.arange(len(col.vocab))
            codes = rank[codes]
        key = codes.astype(np.int64)
    else:
        key = np.asarray(col)[rows]
        if key.dtype == object or key.dtype.kind not in "biufM":
            raise ValueError(f"Cannot sort by {name} (dtype {key.dtype})")
    if desc:
        key = -key.astype(np.float64) if key.dtype.kind == "f" else -key.astype(np.int64)
    return key


def shape_rows(table: FeatureTable, rows: np.ndarray,
               sort: Optional[SortSpec] = None,
               limit: Optional[int] = None) -> np.ndarray:
    """Apply sort (attr | '-attr' | list, stable lexicographic) and limit to
    matching row indices BEFORE hydration (≙ sort + maxFeatures hints)."""
    if sort is not None:
        specs = [sort] if isinstance(sort, str) else list(sort)
        keys = [_sort_key(table, s, rows) for s in specs]
        # np.lexsort sorts by the LAST key first; our specs are major-first
        order = np.lexsort(tuple(reversed(keys + [rows])))
        rows = rows[order]
    if limit is not None:
        rows = rows[: int(limit)]
    return rows


def shape_local(table: FeatureTable,
                sort: Optional[SortSpec] = None,
                limit: Optional[int] = None) -> np.ndarray:
    """Sort/limit order over ALL rows of an already-hydrated table (the
    merged main+delta sub-result); returns local row indices."""
    return shape_rows(table, np.arange(len(table), dtype=np.int64),
                      sort, limit)


_DTYPE_TO_TYPE = {
    "i4": "Int", "i8": "Long", "f4": "Float", "f8": "Double", "b1": "Boolean",
}


def _infer_type(arr) -> str:
    if isinstance(arr, StringColumn):
        return "String"
    a = np.asarray(arr)
    if a.dtype == object:
        # json-path / mixed expression outputs: ONE pass classifies the
        # column — clean numeric promotes, anything mixed/None-bearing
        # becomes dictionary strings
        all_bool = all_int = all_num = bool(len(a))
        for v in a:
            if isinstance(v, bool):
                all_int = all_num = False
            elif isinstance(v, (int, np.integer)):
                all_bool = False
            elif isinstance(v, (float, np.floating)):
                all_bool = all_int = False
            else:
                return "String"
            if not (all_bool or all_num):
                return "String"
        if all_bool:
            return "Boolean"
        if all_int:
            return "Long"
        if all_num:
            return "Double"
        return "String"
    return _DTYPE_TO_TYPE.get(a.dtype.str[1:], "Double")


def transform_table(table: FeatureTable, transforms: Sequence[str],
                    type_name: Optional[str] = None) -> FeatureTable:
    """Project/derive attributes (≙ setQueryTransforms,
    QueryPlanner.scala:185-235): each entry is either an attribute name or
    ``out=expression`` with the converter expression DSL operating on
    ``$attr`` field references — evaluated vectorized over the whole column
    set."""
    from geomesa_tpu_torch.convert.expression import parse_expression

    n = len(table)
    fields = {}
    for name, col in table.columns.items():
        if isinstance(col, StringColumn):
            fields[name] = np.asarray(col.decode(np.arange(n)), dtype=object)
        elif hasattr(col, "coords"):        # GeometryArray: ref only
            fields[name] = col
        else:
            fields[name] = np.asarray(col)

    out_cols = {}
    spec_parts: List[str] = []
    for t in transforms:
        if "=" in t:
            out_name, expr_src = (s.strip() for s in t.split("=", 1))
            expr = parse_expression(expr_src)
            val = expr.eval(fields, n)
            if np.ndim(val) == 0:
                val = np.full(n, val)
            t = _infer_type(val)
            if t == "String" and getattr(val, "dtype", None) == object:
                # stringify mixed/None-bearing outputs for the dictionary
                val = np.asarray(["" if v is None else str(v) for v in val],
                                 dtype=object)
            out_cols[out_name] = val
            spec_parts.append(f"{out_name}:{t}")
        else:
            attr = table.sft.attribute(t)
            out_cols[t] = table.columns[t]
            spec_parts.append(attr.to_spec())
    sft = SimpleFeatureType.from_spec(type_name or table.sft.name,
                                      ",".join(spec_parts))
    return FeatureTable.build(sft, out_cols, fids=table._fids)


def reproject_table(table: FeatureTable, crs) -> FeatureTable:
    """Output geometries mapped to ``crs`` (≙ QueryRunner reprojection,
    planning/QueryRunner.scala:293); attribute columns pass through."""
    from geomesa_tpu_torch.features.crs import reproject_geometry

    geom_attr = table.sft.geometry_attribute
    if geom_attr is None:
        return table
    cols = dict(table.columns)
    cols[geom_attr.name] = reproject_geometry(
        table.geometry(), "EPSG:4326", crs)
    return FeatureTable.build(table.sft, cols, fids=table._fids)
