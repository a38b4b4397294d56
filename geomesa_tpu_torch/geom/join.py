"""Spatial joins: polygon literals × the feature table (≙ the single-process
half of ``geomesa_tpu.geom.join``).

A spatial join here is the ``st_contains``/``st_intersects``
point-in-polygon shape: a small set of polygon literals (the broadcast
side) joined against the feature table. Each probe is the filter IR node
the CQL parser makes for ``st_contains(POLYGON(..), geom)`` and evaluates
through ``geom.functions.eval_filter_node`` — the catalog's banded device
kernels classify certain-in / certain-out in f32 and the f64 host oracle
refines the uncertain sliver, so every verdict is exact. Pair lists come in
the primary index's key order.

The reference runs the same code across the processes of a cluster: a
psum round reduces the per-polygon counts and the pair lists merge in rank
order. That half comes with the cluster (ROADMAP.md Queue 1, item 14): a
``runtime`` other than None raises naming it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from geomesa_tpu_torch.features import geometry as geo
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.index.api import not_ported

JOIN_OPS = ("st_contains", "st_intersects")


@dataclass
class JoinResult:
    """A join's verdict (the reference's; identical on every rank there)."""

    op: str
    polygons: int
    counts: List[int]                      # per-polygon hit counts
    pairs: List[List[str]]                 # per-polygon fids, key order
    rows_local: int                        # this process's table size
    rows_global: int                       # the table size over processes
    num_processes: int
    wall_s: float
    truncated: bool = False                # pairs capped at max_pairs
    meta: dict = field(default_factory=dict)

    def stable(self) -> dict:
        """The rank-invariant portion (the reference's equality surface)."""
        return {
            "op": self.op, "polygons": self.polygons,
            "counts": [int(c) for c in self.counts],
            "pairs": [[str(f) for f in p] for p in self.pairs],
            "rows_global": int(self.rows_global),
            "truncated": bool(self.truncated),
        }

    def to_dict(self) -> dict:
        return {
            **self.stable(),
            "rows_local": int(self.rows_local),
            "num_processes": int(self.num_processes),
            "wall_s": round(float(self.wall_s), 3),
        }


def _literal(poly) -> tuple:
    """Accept WKT strings or parsed ``(code, data)`` literals."""
    lit = geo.parse_wkt(poly) if isinstance(poly, str) else poly
    if lit[0] not in (geo.POLYGON, geo.MULTIPOLYGON):
        raise ValueError(f"spatial join literal must be polygonal: {poly!r}")
    return lit


def _join_node(op: str, lit: tuple, attr: str) -> ir.Filter:
    """The filter-IR node one join probe evaluates — the node the CQL
    parser produces for ``st_contains(POLYGON(..), geom)``."""
    if op == "st_contains":
        return ir.Func("st_contains", (lit, attr))
    if op == "st_intersects":
        return ir.Func("st_intersects", (attr, lit))
    raise ValueError(f"unsupported join op {op!r} (want one of {JOIN_OPS})")


def _single_process(runtime) -> None:
    if runtime is not None:
        raise not_ported("a spatial join over a cluster runtime (the psum "
                         "round and the rank-order merge of geom/join.py)",
                         14)


def _key_order(planner) -> np.ndarray:
    """The table's rows in the primary index's key order (z3 when present,
    the first index otherwise), read through the index's host permutation."""
    idx = next((i for i in planner.indexes if i.name == "z3"),
               planner.indexes[0])
    return idx.map_rows(np.arange(len(planner.table), dtype=np.int64))


def local_matches(planner, polygons: Sequence, op: str = "st_contains",
                  rows: Optional[np.ndarray] = None,
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Evaluate every polygon against the table.

    Returns ``(counts, hits)`` — ``counts`` (P,) int64 hit counts, ``hits``
    (P, n) bool match matrix over ``rows`` (default: the primary index's
    key order). Kernel or oracle follows ``GEOMESA_TPU_GEOM_KERNELS``
    through ``eval_filter_node``, on the planner's device."""
    from geomesa_tpu_torch.geom.functions import eval_filter_node

    attr = planner.sft.geometry_attribute.name
    if rows is None:
        rows = _key_order(planner)
    nodes = [_join_node(op, _literal(p), attr) for p in polygons]
    hits = np.zeros((len(nodes), len(rows)), dtype=bool)
    for j, node in enumerate(nodes):
        hits[j] = eval_filter_node(node, planner.table, rows,
                                   device=planner.device)
    return hits.sum(axis=1).astype(np.int64), hits


def spatial_join(planner, polygons: Sequence, op: str = "st_contains",
                 runtime=None, fids: Optional[np.ndarray] = None,
                 rows: Optional[np.ndarray] = None,
                 with_pairs: bool = True,
                 max_pairs: Optional[int] = None) -> JoinResult:
    """``op(polygon, geom)`` join against the table.

    ``fids``/``rows`` default to the primary index's key order.
    ``max_pairs`` caps each polygon's pair list (a prefix in key order)."""
    _single_process(runtime)
    t0 = time.perf_counter()
    if rows is None:
        rows = _key_order(planner)
    if fids is None:
        fids = planner.table.fids_at(rows)
    counts, hits = local_matches(planner, polygons, op, rows=rows)
    pairs: List[List[str]] = []
    truncated = False
    if with_pairs:
        pairs = [[str(f) for f in np.asarray(fids)[hits[j]]]
                 for j in range(len(hits))]
        if max_pairs is not None:
            truncated = any(len(p) > max_pairs for p in pairs)
            pairs = [p[:max_pairs] for p in pairs]
    return JoinResult(
        op=op, polygons=len(hits), counts=[int(c) for c in counts],
        pairs=pairs, rows_local=int(len(rows)), rows_global=int(len(rows)),
        num_processes=1, wall_s=time.perf_counter() - t0,
        truncated=truncated)


def func_counts(planner, queries: Sequence[str],
                runtime=None) -> Dict[str, int]:
    """st_* function COUNT queries over the table, each through the
    planner's residual refine (the catalog's banded classify + f64 refine
    of the uncertain sliver with GEOMESA_TPU_GEOM_KERNELS on)."""
    from geomesa_tpu_torch.filter.parser import parse_ecql

    _single_process(runtime)
    rows = _key_order(planner)
    return {q: int(planner._refine_mask(parse_ecql(q), rows).sum())
            for q in queries}


def join_battery(planner, polygons: Sequence, runtime=None,
                 fids: Optional[np.ndarray] = None,
                 max_pairs: Optional[int] = None) -> dict:
    """Both join ops over one polygon set: ``stable`` (the reference's
    equality surface) and ``meta`` (sizes and timings)."""
    _single_process(runtime)
    out: dict = {"stable": {}, "meta": {}}
    for op in JOIN_OPS:
        r = spatial_join(planner, polygons, op, fids=fids,
                         max_pairs=max_pairs)
        out["stable"][op] = r.stable()
        out["meta"][op] = {"rows_local": int(r.rows_local),
                           "num_processes": int(r.num_processes),
                           "wall_s": round(float(r.wall_s), 3)}
    return out
