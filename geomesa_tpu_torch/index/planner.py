"""Query planning and execution (≙ ``geomesa_tpu.index.planner``).

Flow: parse the ECQL, plan it on the Z3 index (boxes, windows, residual
split), then run the fused program (``index/compiled.py``): a count, or a
select of ascending table rows, with the uncertain polygon sliver refined
on the host in f64. Plan shapes the fused program does not take raise
NotImplementedError naming the ROADMAP.md item that ports them.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from geomesa_tpu_torch.features.table import FeatureTable
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.filter.parser import parse_ecql
from geomesa_tpu_torch.index import compiled as _fused
from geomesa_tpu_torch.index.api import IndexScanPlan, QueryResult, not_ported


class QueryPlanner:
    """Planner + executor for one feature type over its Z3 index."""

    def __init__(self, sft, table: FeatureTable, indexes: List[object]):
        self.sft = sft
        self.table = table
        self.indexes = indexes

    def plan(self, f: Union[str, ir.Filter]) -> IndexScanPlan:
        if isinstance(f, str):
            f = parse_ecql(f)
        if isinstance(f, ir.FidFilter):
            raise not_ported("feature-id lookups", 10)
        if not self.indexes:
            raise ValueError(f"No indexes for {self.sft.name}")
        plan = self.indexes[0].plan(f)
        if isinstance(f, ir.Or) and plan.residual_host is not None:
            # the reference answers these with per-branch plans + a union
            raise not_ported("OR filters planned as a union of branches", 3)
        return plan

    def count(self, f: Union[str, ir.Filter]) -> int:
        plan = self.plan(f)
        if plan.empty:
            return 0
        return _fused.count(self, plan)

    def select_indices(self, f: Union[str, ir.Filter],
                       plan: Optional[IndexScanPlan] = None,
                       capacity: Optional[int] = None) -> np.ndarray:
        """Matching row indices (ascending) into the table. ``capacity``:
        expected match-count hint that sizes the first select."""
        if plan is None:
            plan = self.plan(f)
        if plan.empty:
            return np.empty(0, dtype=np.int64)
        return _fused.select(self, plan, capacity)

    def query(self, f: Union[str, ir.Filter]) -> QueryResult:
        plan = self.plan(f)
        rows = self.select_indices(f, plan=plan)
        return QueryResult(rows, self.table.take(rows), plan)
