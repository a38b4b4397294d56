"""Predicate IR: the typed filter tree all layers share.

≙ the role GeoTools ``Filter`` objects play in the reference; GeoMesa compiles
them into fast evaluators (FastFilterFactory.scala) and extracts planning info
from them (FilterHelper.scala). Here the IR is a small algebra the parser
produces, the planner decomposes, and the numpy/torch backends evaluate.

Geometry literals are (type_code, nested-list) pairs as produced by
``features.geometry.parse_wkt``. Temporal literals are int64 epoch millis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple


class Filter:
    """Base class; nodes are frozen dataclasses."""

    def __and__(self, other: "Filter") -> "Filter":
        return And([self, other])

    def __or__(self, other: "Filter") -> "Filter":
        return Or([self, other])

    def __invert__(self) -> "Filter":
        return Not(self)


@dataclass(frozen=True)
class Include(Filter):
    """Match everything (Filter.INCLUDE)."""


@dataclass(frozen=True)
class Exclude(Filter):
    """Match nothing (Filter.EXCLUDE)."""


@dataclass(frozen=True)
class And(Filter):
    children: Tuple[Filter, ...]

    def __init__(self, children: Sequence[Filter]):
        flat: List[Filter] = []
        for c in children:
            if isinstance(c, And):
                flat.extend(c.children)
            else:
                flat.append(c)
        object.__setattr__(self, "children", tuple(flat))


@dataclass(frozen=True)
class Or(Filter):
    children: Tuple[Filter, ...]

    def __init__(self, children: Sequence[Filter]):
        flat: List[Filter] = []
        for c in children:
            if isinstance(c, Or):
                flat.extend(c.children)
            else:
                flat.append(c)
        object.__setattr__(self, "children", tuple(flat))


@dataclass(frozen=True)
class Not(Filter):
    child: Filter


# -- spatial ----------------------------------------------------------------

@dataclass(frozen=True)
class BBox(Filter):
    attr: str
    xmin: float
    ymin: float
    xmax: float
    ymax: float


@dataclass(frozen=True)
class Intersects(Filter):
    attr: str
    geometry: tuple  # (type_code, nested lists)


@dataclass(frozen=True)
class Contains(Filter):
    """Literal geometry CONTAINS the feature geometry."""
    attr: str
    geometry: tuple


@dataclass(frozen=True)
class Within(Filter):
    """Feature geometry WITHIN the literal geometry."""
    attr: str
    geometry: tuple


@dataclass(frozen=True)
class Dwithin(Filter):
    attr: str
    geometry: tuple
    distance: float  # degrees


# -- geometry function calls (≙ geomesa-spark-jts st_* UDFs) ----------------

# canonical (lowercase) catalog names by kind
FUNC_BOOLEAN = frozenset({"st_contains", "st_intersects"})
FUNC_SCALAR = frozenset({"st_area", "st_length", "st_distance"})
FUNC_GEOM = frozenset({"st_buffer", "st_centroid", "st_convexhull"})
FUNC_NAMES = FUNC_BOOLEAN | FUNC_SCALAR | FUNC_GEOM


@dataclass(frozen=True)
class FuncExpr:
    """A geometry-valued st_* expression (st_buffer/st_centroid/
    st_convexHull) nested inside a predicate or projection — not itself a
    filter. Each arg is an attribute name (str), a geometry literal
    ``(type_code, nested lists)``, a float scalar, or a nested FuncExpr."""

    name: str     # canonical lowercase
    args: tuple


@dataclass(frozen=True)
class Func(Filter):
    """Boolean st_* predicate call: st_contains(a, b) / st_intersects(a, b).
    Args as in FuncExpr."""

    name: str
    args: tuple


@dataclass(frozen=True)
class FuncCmp(Filter):
    """Scalar st_* call compared to a literal:
    ``st_distance(geom, POINT(..)) < 5000``. op in {'=','<>','<','<=','>',
    '>='}; args as in FuncExpr."""

    op: str
    name: str
    args: tuple
    value: float


# -- temporal ---------------------------------------------------------------

@dataclass(frozen=True)
class During(Filter):
    """attr in (lo, hi); ECQL DURING is exclusive on both ends, BETWEEN is
    inclusive — modeled with the *_inclusive flags."""

    attr: str
    lo: int   # epoch millis
    hi: int
    lo_inclusive: bool = False
    hi_inclusive: bool = False


# -- attribute --------------------------------------------------------------

@dataclass(frozen=True)
class Cmp(Filter):
    """Property comparison: op in {'=', '<>', '<', '<=', '>', '>='}."""

    op: str
    attr: str
    value: object


@dataclass(frozen=True)
class In(Filter):
    attr: str
    values: Tuple[object, ...]


@dataclass(frozen=True)
class IsNull(Filter):
    attr: str


@dataclass(frozen=True)
class FidFilter(Filter):
    """Feature-id lookup (ECQL ``IN ('fid1', ...)`` with no attribute)."""

    fids: Tuple[str, ...]


def and_filters(filters: Sequence[Filter]) -> Filter:
    """Combine, dropping INCLUDEs (reference filter/package.scala andFilters)."""
    fs = [f for f in filters if not isinstance(f, Include)]
    if not fs:
        return Include()
    if any(isinstance(f, Exclude) for f in fs):
        return Exclude()
    return fs[0] if len(fs) == 1 else And(fs)


def or_filters(filters: Sequence[Filter]) -> Filter:
    """Combine, dropping EXCLUDEs (the reference's ``or_filters``)."""
    fs = [f for f in filters if not isinstance(f, Exclude)]
    if not fs:
        return Exclude()
    if any(isinstance(f, Include) for f in fs):
        return Include()
    return fs[0] if len(fs) == 1 else Or(fs)
