"""Query planning and execution (≙ ``geomesa_tpu.index.planner``).

Flow: parse the ECQL, plan it on the Z3 index (boxes, windows, residual
split), then execute as the reference does: the fused program first
(``index/compiled.py``), else the staged ``ScanKernels`` over the plan's
range-pruned block cover (``_pruned_blocks``), else the staged full-table
mask. A count or a select of ascending table rows; host residuals
re-evaluate on the host in f64 (``_refine``). Plan shapes that need modules
not yet ported raise NotImplementedError naming their ROADMAP.md item.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from geomesa_tpu_torch import config
from geomesa_tpu_torch.features.table import FeatureTable
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.filter.evaluate import evaluate_at
from geomesa_tpu_torch.filter.parser import parse_ecql
from geomesa_tpu_torch.index import compiled as _fused
from geomesa_tpu_torch.index import prune as _prune
from geomesa_tpu_torch.index.api import IndexScanPlan, QueryResult, not_ported

_SELECT_CAP = 1 << 16
# select-capacity tiers (the reference's): hints quantize UP to a tier
_SELECT_TIERS = (1 << 10, 1 << 13, _SELECT_CAP, 1 << 19, 1 << 22)


def _select_tier(capacity) -> int:
    if capacity is None:
        return _SELECT_CAP
    for t in _SELECT_TIERS:
        if capacity <= t:
            return t
    return 1 << max(0, (int(capacity) - 1)).bit_length()


def _has_function(f: Optional[ir.Filter]) -> bool:
    if isinstance(f, (ir.Func, ir.FuncCmp)):
        return True
    if isinstance(f, (ir.And, ir.Or)):
        return any(_has_function(c) for c in f.children)
    if isinstance(f, ir.Not):
        return _has_function(f.child)
    return False


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
        if _has_function(plan.residual_host):
            raise not_ported("st_* function predicates and the dist refine "
                             "(the geometry catalog's host oracle)", 5)
        return plan

    # -- range pruning -------------------------------------------------------

    def _pruned_blocks(self, plan: IndexScanPlan) -> Optional[np.ndarray]:
        """Candidate gather-blocks of a plan (cached on the plan), or None
        when the full-table mask is the better scan (≙ choosing ranged scans
        over a full-table scan, QueryProperties.BlockFullTableScans)."""
        if not config.PRUNE_ENABLED.get():
            return None
        if plan.blocks is False:
            plan.blocks = None if plan.empty or plan.index is None \
                else plan.index.candidate_blocks(plan)
        return plan.blocks

    # -- execution -----------------------------------------------------------

    def count(self, f: Union[str, ir.Filter]) -> int:
        return self._count(self.plan(f), f)

    def _count(self, plan: IndexScanPlan, f) -> int:
        if plan.empty:
            return 0
        if plan.residual_host is None:
            # fully device-exact: the fused program, else a staged count
            fused = _fused.try_count(self, plan)
            if fused is not None:
                return fused
            kernels = plan.index.kernels
            blocks = self._pruned_blocks(plan)
            if blocks is not None:
                if len(blocks) == 0:
                    return 0
                return kernels.count_blocks(
                    plan.primary_kind, plan.boxes_loose, plan.windows,
                    plan.residual_device, blocks, _prune.BLOCK_SIZE)
            return kernels.count(plan.primary_kind, plan.boxes_loose,
                                 plan.windows, plan.residual_device)
        fused = _fused.try_count_refine(self, plan)
        if fused is not None:
            return fused
        return len(self.select_indices(f, plan=plan))

    def select_indices(self, f: Union[str, ir.Filter],
                       plan: Optional[IndexScanPlan] = None,
                       capacity: Optional[int] = None) -> np.ndarray:
        """Matching row indices (ascending) into the table. ``capacity``:
        expected match-count hint that sizes the first select."""
        if plan is None:
            plan = self.plan(f)
        if plan.empty:
            return np.empty(0, dtype=np.int64)
        if plan.residual_host is None:
            pos = _fused.try_select(self, plan, capacity)
            if pos is not None:
                return np.sort(plan.index.map_rows(pos))
        else:
            rows = _fused.try_select_refine(self, plan, capacity)
            if rows is not None:
                return rows
        kernels = plan.index.kernels
        blocks = self._pruned_blocks(plan)
        if blocks is not None:
            if len(blocks) == 0:
                return np.empty(0, dtype=np.int64)
            idx, _ = kernels.select_blocks(
                plan.primary_kind, plan.boxes_loose, plan.windows,
                plan.residual_device, blocks, _prune.BLOCK_SIZE,
                _select_tier(capacity))
        else:
            idx, _ = kernels.select(
                plan.primary_kind, plan.boxes_loose, plan.windows,
                plan.residual_device, _select_tier(capacity))
        rows = plan.index.map_rows(idx)
        if plan.residual_host is None:
            return np.sort(rows)
        return np.sort(self._refine(plan, rows))

    def query(self, f: Union[str, ir.Filter]) -> QueryResult:
        plan = self.plan(f)
        rows = self.select_indices(f, plan=plan)
        return QueryResult(rows, self.table.take(rows), plan)

    # -- helpers -------------------------------------------------------------

    def _refine(self, plan: IndexScanPlan, rows: np.ndarray) -> np.ndarray:
        """Host f64 re-evaluation of device candidates against the residual
        (≙ the reference's full-filter path over overlapping-range rows),
        evaluated in place at the candidate rows."""
        if len(rows) == 0 or plan.residual_host is None:
            return rows
        return rows[self._refine_mask(plan.residual_host, rows)]

    def _refine_mask(self, res: ir.Filter, rows: np.ndarray) -> np.ndarray:
        """Residual mask over candidate rows (the st_* catalog route of the
        reference raises at plan time in the port: ROADMAP.md item 5)."""
        return evaluate_at(res, self.table, rows)
