"""Query planning and execution (≙ ``geomesa_tpu.index.planner``).

Flow: parse the ECQL, let the interceptors rewrite it, plan it on every
index of the type — its spatial index (Z3, XZ3, Z2 or XZ2: boxes, windows,
residual split), an attribute index an indexed attribute (its equality,
range and ``IN`` predicates as candidate slices), or the full-scan index of
a schema without a spatial one — and take the cheapest plan (priced by the
stats battery's estimated rows where several indexes plan, the heuristic
cost breaking ties; by heuristic cost alone otherwise); the interceptors'
guards may veto it. Then execute as the reference does: a sliced plan
through the staged ``count_at``/``select_at`` over its runs, else the
fused program first (``index/compiled.py``, point primaries), else the
staged ``ScanKernels`` over the plan's range-pruned block cover
(``_pruned_blocks``), else the staged full-table mask. A count or a select of ascending table rows; host
residuals re-evaluate on the host in f64 (``_refine``). A polygon
INTERSECTS over a single-segment line layer counts through the
certainty-band ``seg_band`` kernel, refining only its uncertain rows
(``_band_intersects_count``). An OR whose single plan would
need a host residual plans one branch at a time (``UnionScanPlan``) when
every branch has a spatial primary: the branches OR on the device when
all are device-exact (one K-branch scan), else the branch row sets union on
the host. A feature-id filter is answered from the table's ids (the id
index). Authorizations fold into the device stage as the allowed
visibility codes (``_apply_auths``).
``prepare`` plans once (or binds a known shape's new values through the
recipe fast path) and hands back a re-executable ``PreparedQuery``.
``explain`` describes a plan (and, with ``analyze``, runs its count). Plan
shapes that need modules not yet ported raise NotImplementedError naming
their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Union

import numpy as np
import torch

from geomesa_tpu_torch import config
from geomesa_tpu_torch import trace as _trace
from geomesa_tpu_torch.features import geometry as geo
from geomesa_tpu_torch.features.table import FeatureTable
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.filter.evaluate import evaluate_at
from geomesa_tpu_torch.filter.geom_batch import batch_intersects
from geomesa_tpu_torch.filter.geom_numpy import literal_segments
from geomesa_tpu_torch.filter.parser import parse_ecql
from geomesa_tpu_torch.index import compiled as _fused
from geomesa_tpu_torch.index import prune as _prune
from geomesa_tpu_torch.index.api import (IndexScanPlan, QueryResult,
                                         UnionScanPlan)
from geomesa_tpu_torch.index.guards import Deadline, QueryGuardError
from geomesa_tpu_torch.index.scan import _fetch, fold_vis
from geomesa_tpu_torch.security.visibility import allowed_codes
from geomesa_tpu_torch.serve.resilience import deadline as _rdl

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


class QueryPlanner:
    """Planner + executor for one feature type over its indexes.
    ``timeout_ms``: the cooperative deadline of ``count`` and prepared
    counts (``guards.Deadline``, checked between stages). ``interceptors``:
    ``guards.QueryInterceptor`` hooks that rewrite each filter before
    planning and may veto the chosen plan (≙ the reference's, a list the
    store shares with every planner of the type)."""

    def __init__(self, sft, table: FeatureTable, indexes: List[object],
                 timeout_ms: Optional[float] = None, stats=None,
                 interceptors: Optional[list] = None):
        self.sft = sft
        self.table = table
        self.indexes = indexes
        self.timeout_ms = timeout_ms
        self.stats = stats  # GeoMesaStats: the cost-based choice's prices
        self.interceptors = interceptors if interceptors is not None else []

    def plan(self, f: Union[str, ir.Filter]) -> IndexScanPlan:
        if not _trace.enabled():
            return self._plan(f)
        t0 = time.perf_counter()
        try:
            return self._plan(f)
        finally:
            _trace.record("plan", "plan", time.perf_counter() - t0)

    def _plan(self, f: Union[str, ir.Filter]) -> IndexScanPlan:
        if isinstance(f, str):
            f = parse_ecql(f)
        for ic in self.interceptors:
            f = ic.rewrite(f, self.sft)   # ≙ QueryInterceptor.rewrite
        if isinstance(f, ir.FidFilter):
            # ≙ the id index: the rows whose fids are listed
            return IndexScanPlan(None, "fid", full_filter=f, cost=0.5,
                                 explain={"index": "id", "fids": f.fids})
        if not self.indexes:
            raise ValueError(f"No indexes for {self.sft.name}")
        plan = self._choose(f)
        if isinstance(f, ir.Or) and plan.residual_host is not None:
            # OR → one plan a branch (≙ FilterSplitter's OR expansion): when
            # every branch plans with a spatial primary, per-branch scans and
            # a row-set union beat the union-boxes prefilter + host residual
            # the single plan needs
            union = self._union_plan(f)
            if union is not None:
                plan = union
        for ic in self.interceptors:   # ≙ the query guards' veto
            msg = ic.guard(plan, f, self.sft)
            if msg:
                raise QueryGuardError(msg)
        return plan

    def _choose(self, f: ir.Filter) -> IndexScanPlan:
        """The cheapest index's plan (≙ the reference's strategy choice,
        ``geomesa_tpu/index/planner.py:102-136``): with a populated stats
        battery and more than one plan, priced by the estimated rows its
        primary constraints leave to scan (≙ CostBasedStrategyDecider,
        StrategyDecider.scala:140-168), the heuristic cost breaking ties;
        else by heuristic cost alone."""
        plans = self._plans(f)
        # one plan needs no prices (and leaves a deferred battery unread)
        if len(plans) < 2 or self.stats is None or self.stats.total <= 0:
            return min(plans, key=lambda p: p.cost)
        est = self.stats.estimator
        n = self.stats.total

        def priced(p):
            if p.empty:
                return (0.0, p.cost)
            if p.candidate_slices is not None:
                # attribute slices: the scanned row count is exact
                return (float(p.n_candidates), p.cost)
            sel = 1.0
            boxes = p.explain.get("boxes")
            if p.boxes_loose is not None and boxes:
                s = est.spatial_selectivity(boxes)
                if s is not None:
                    sel *= s
            intervals = p.explain.get("intervals")
            if p.windows is not None and intervals:
                s = est.temporal_selectivity(intervals)
                if s is not None:
                    sel *= s
            # per-curve cover quality (the reference's S2 cover scans ~1.1x
            # the true rows where z-covers scan ~1.02x)
            slop = getattr(p.index, "cover_slop", 1.0)
            return (sel * n * slop, p.cost)

        return min(plans, key=priced)

    def _plans(self, f: ir.Filter) -> list:
        return [p for p in (idx.plan(f) for idx in self.indexes)
                if p is not None]

    def _union_plan(self, f: ir.Or) -> Optional[UnionScanPlan]:
        """Per-branch plans of an OR filter, or None when a branch would
        scan unconstrained (then the single superset plan wins). The branch
        count is capped like the reference's DNF expansion."""
        if len(f.children) > 8:
            return None
        branches = []
        cost = 0.0
        for c in f.children:
            # each branch by heuristic cost, as the reference's
            plans = self._plans(c)
            if not plans:
                return None
            bp = min(plans, key=lambda p: p.cost)
            if bp.empty:
                continue
            if bp.primary_kind == "none" and bp.candidate_slices is None:
                return None   # unconstrained branch: a union buys nothing
            branches.append((c, bp))
            cost += bp.cost
        return UnionScanPlan(
            branches=branches, full_filter=f, cost=cost, empty=not branches,
            explain={"index": "union",
                     "strategies": [p.explain.get("index")
                                    for _, p in branches]})

    def explain(self, f: Union[str, ir.Filter], analyze: bool = False,
                auths=None) -> dict:
        """The plan's description (≙ the reference's ``explain``,
        ``geomesa_tpu/index/planner.py:179-252``): the plan's own keys
        (``index``, boxes, intervals, residual split; ``candidates`` of an
        attribute slice), ``scan`` ("range-pruned" or "full-mask"),
        ``strategy``, ``cost``, ``empty``, ``n_boxes``, ``n_windows``, the
        index's ``build`` stages and, when tracing is on, the span tree of
        the dry run (``trace``: plan and range decomposition; no scan).
        ``analyze`` also runs the plan's count in the same trace and, when
        tracing is on, adds ``analyze``: ``executed``, ``rows_matched``,
        ``rows_scanned``, ``duration_ms``, the device and host ms and the
        self ms by stage. The reference's span annotations
        (``obs/attrib.py``), its build-progress history and its cache
        provenance wait for ROADMAP.md Queue 1 item 15."""
        with _trace.trace("explain", type=self.sft.name) as t:
            plan = self.plan(f)
            blocks = self._pruned_blocks(plan)
            n = None
            if analyze:
                n = self._count(
                    self._apply_auths(plan, auths),
                    f if isinstance(f, ir.Filter) else parse_ecql(f), auths)
        out = dict(plan.explain)
        if t is not None:
            out["trace"] = t.to_dict()
        out["scan"] = "range-pruned" if blocks is not None else "full-mask"
        out.update({
            "type": self.sft.name,
            "strategy": plan.primary_kind,
            "cost": plan.cost,
            "empty": plan.empty,
            "n_boxes": 0 if plan.boxes_loose is None
            else len(plan.boxes_loose),
            "n_windows": 0 if plan.windows is None else len(plan.windows),
        })
        stages = getattr(plan.index, "build_stages", None)
        if stages:
            out["build"] = {"stages": dict(stages)}
        if analyze and t is not None:
            st = t.self_times_ms()
            device_ms = st.get("device_scan", 0.0) + st.get("device_wait", 0.0)
            out["analyze"] = {
                "executed": True,
                "rows_matched": int(n) if n is not None else None,
                "rows_scanned": (len(blocks) * _prune.BLOCK_SIZE
                                 if blocks is not None else len(self.table)),
                "duration_ms": round(t.duration_ms, 3),
                "device_ms": round(device_ms, 3),
                "host_ms": round(max(0.0, t.duration_ms - device_ms), 3),
                "stages_ms": {k: round(v, 3) for k, v in st.items()},
            }
        return out

    # -- range pruning -------------------------------------------------------

    def _pruned_blocks(self, plan: IndexScanPlan) -> Optional[np.ndarray]:
        """Candidate gather-blocks of a plan (cached on the plan), or None
        when the full-table mask is the better scan (≙ choosing ranged scans
        over a full-table scan, QueryProperties.BlockFullTableScans)."""
        if not config.PRUNE_ENABLED.get():
            return None
        if plan.blocks is False:
            # per-request deadline checkpoint: the range decomposition is
            # the priciest host stage before a device dispatch
            _rdl.check_current("range_decompose")
            blocks = None
            if not plan.empty and plan.index is not None \
                    and plan.candidate_slices is None:
                t0 = time.perf_counter()
                blocks = plan.index.candidate_blocks(plan)
                if _trace.enabled():
                    _trace.record("range_decompose", "range_decompose",
                                  time.perf_counter() - t0)
            plan.blocks = blocks
        return plan.blocks

    # -- visibility and audit ------------------------------------------------

    def _apply_auths(self, plan: IndexScanPlan, auths) -> IndexScanPlan:
        """The plan under the caller's authorizations (≙ the reference's
        ``_apply_auths``, ``geomesa_tpu/index/planner.py:254-296``): each
        distinct visibility expression evaluates once on the host
        (``allowed_codes``) and the allowed codes fold into the device
        residual (``scan.fold_vis``), which the fused and staged scans test
        against the ``__vis__`` plane. ``None`` auths, a table without
        labels, an empty plan and a plan already folded pass as they are;
        an OR folds its branches at execution. When every expression is
        allowed nothing folds; when none is, the plan is empty. The
        ``__vis_applied__`` mark goes on a copy of ``explain``, so a plan
        that is reused (a prepared query, a cache, a union branch) folds
        again under other auths."""
        if auths is None or self.table.visibility is None or plan.empty \
                or plan.explain.get("__vis_applied__"):
            return plan
        if isinstance(plan, UnionScanPlan):
            return plan
        marked = dict(plan.explain, __vis_applied__=True)
        vocab = self.table.visibility.vocab
        allowed = allowed_codes(vocab, auths)
        if len(allowed) == len(vocab):
            return dataclasses.replace(plan, explain=marked)
        if len(allowed) == 0:
            return dataclasses.replace(plan, empty=True, explain=marked)
        return dataclasses.replace(
            plan, explain=marked,
            residual_device=fold_vis(plan.residual_device, allowed))

    def _fid_vis_filter(self, rows: np.ndarray, auths) -> np.ndarray:
        """The rows of a feature-id lookup that the auths may see (≙
        ``geomesa_tpu/index/planner.py:298``)."""
        if auths is None or self.table.visibility is None or len(rows) == 0:
            return rows
        allowed = allowed_codes(self.table.visibility.vocab, auths)
        return rows[np.isin(self.table.visibility.codes[rows], allowed)]

    def _fid_rows(self, f: ir.FidFilter) -> np.ndarray:
        """Ascending rows whose fids are listed (≙ the reference's
        ``_fid_rows``, ``geomesa_tpu/index/planner.py:576``): ``np.isin``
        on the ids, without materializing the implicit ones."""
        return np.flatnonzero(self.table.fid_runs.isin(list(f.fids)))

    def _write_audit(self, plan, f, plan_ms: float, scan_ms: float,
                     hits: int) -> None:
        """The reference's audit-log hook; the audit log is not ported yet
        (ROADMAP.md Queue 1 item 15, with its rotation), so nothing is
        written."""

    # -- execution -----------------------------------------------------------

    def prepare(self, f: Union[str, ir.Filter],
                auths=None) -> Union["PreparedQuery", "_fused.FusedPrepared"]:
        """Plan once and stage the query's constants on the device; the
        handle re-executes without re-parsing, re-planning or re-uploading.
        When this (filter shape, auths) has fused before, the recipe fast
        path binds the new values straight into a fused count program (no
        plan, no range cover); the ordinary path registers each shape's
        outcome so its next occurrence takes the fast path."""
        f_ir = f if isinstance(f, ir.Filter) else parse_ecql(f)
        fp = _fused.fast_prepare(self, f_ir, auths)
        if fp is not None:
            return fp
        plan = self._apply_auths(self.plan(f_ir), auths)
        pq = PreparedQuery(self, plan, f_ir, auths)
        _fused.note_shape(self, plan, f_ir, auths, pq._fused)
        return pq

    def count(self, f: Union[str, ir.Filter], auths=None) -> int:
        with _trace.trace("count", type=self.sft.name, filter=str(f)):
            dl = Deadline(self.timeout_ms)
            t0 = time.perf_counter()
            plan = self._apply_auths(self.plan(f), auths)
            plan_ms = (time.perf_counter() - t0) * 1000
            dl.check("plan")
            t1 = time.perf_counter()
            n = self._count(plan, f, auths)
            dl.check("scan")
            self._write_audit(plan, f, plan_ms,
                              (time.perf_counter() - t1) * 1000, n)
            return n

    def _union_stages(self, plan: UnionScanPlan, auths) -> list:
        """The branches of an OR plan as staged scans (primary kind,
        boxes, windows, device residual), for ``ScanKernels``' OR of
        stages: one K-branch ``fused_scan`` (rows two branches share count
        once). A branch that the auths leave empty drops out."""
        return [(bp.primary_kind, bp.boxes_loose, bp.windows,
                 bp.residual_device)
                for bp in (self._apply_auths(bp, auths)
                           for _, bp in plan.branches) if not bp.empty]

    def _count(self, plan: IndexScanPlan, f, auths=None) -> int:
        if plan.empty:
            return 0
        if isinstance(plan, UnionScanPlan):
            idx = plan.same_index_device_exact()
            if idx is not None:
                # the OR of the branches on the device, one readback
                stages = self._union_stages(plan, auths)
                return idx.kernels.union_count(stages) if stages else 0
            return len(self._union_select(plan, auths))
        if plan.primary_kind == "fid":
            return len(self._fid_vis_filter(
                self._fid_rows(plan.full_filter), auths))
        if plan.residual_host is None:
            if plan.candidate_slices is not None:
                # the attribute index's runs: one staged count over them
                return plan.index.kernels.count_at(
                    plan.primary_kind, plan.boxes_loose, plan.windows,
                    plan.residual_device, plan.candidate_slices)
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
        fast = self._band_intersects_count(plan)
        if fast is not None:
            return fast
        return len(self.select_indices(f, plan=plan, auths=auths))

    def _band_intersects_count(self, plan: IndexScanPlan) -> Optional[int]:
        """Device certainty-band count for the common extent query shape (≙
        ``geomesa_tpu/index/planner.py:434-469``): a single polygon
        INTERSECTS residual over a single-segment line layer. The
        ``seg_band`` kernel classifies the candidate blocks' segments as
        certain hit / certain miss / uncertain (f32 error bands), and only
        the uncertain sliver refines on the host in exact f64. None when
        the shape does not apply or the uncertain rows overflow the
        kernel's cap (the caller then refines every candidate)."""
        res = plan.residual_host
        if not (isinstance(res, ir.Intersects) and plan.index is not None
                and plan.candidate_slices is None
                and plan.primary_kind == "bbox_overlap"
                and res.attr == plan.index.geom):
            return None
        if res.geometry[0] != geo.POLYGON:
            return None
        if not plan.index.ensure_segment_columns():
            return None
        blocks = self._pruned_blocks(plan)
        if blocks is None or len(blocks) == 0:
            return 0 if blocks is not None else None
        edges = literal_segments(res.geometry).astype(np.float32)
        certain, unc = plan.index.kernels.intersects_band_blocks(
            plan.primary_kind, plan.boxes_loose, plan.windows,
            plan.residual_device, edges, blocks, _prune.BLOCK_SIZE)
        band = {"certain": certain,
                "uncertain": None if unc is None else len(unc)}
        plan.explain["band"] = band
        if unc is None or len(unc) == 0:
            return None if unc is None else certain
        t0 = time.perf_counter()
        with _trace.span("refine", kind="refine", rows=len(unc)):
            rows = plan.index.map_rows(unc)
            n = certain + int(batch_intersects(self.table.geometry(), rows,
                                               res.geometry).sum())
        band["refine_s"] = time.perf_counter() - t0
        return n

    def select_indices(self, f: Union[str, ir.Filter],
                       plan: Optional[IndexScanPlan] = None,
                       capacity: Optional[int] = None,
                       auths=None) -> np.ndarray:
        """Matching row indices (ascending) into the table. ``capacity``:
        expected match-count hint that sizes the first select."""
        if plan is None:
            plan = self.plan(f)
        plan = self._apply_auths(plan, auths)
        if plan.empty:
            return np.empty(0, dtype=np.int64)
        if isinstance(plan, UnionScanPlan):
            return self._union_select(plan, auths)
        if plan.primary_kind == "fid":
            return self._fid_vis_filter(self._fid_rows(plan.full_filter),
                                        auths)
        if plan.candidate_slices is not None:
            idx, _ = plan.index.kernels.select_at(
                plan.primary_kind, plan.boxes_loose, plan.windows,
                plan.residual_device, plan.candidate_slices,
                _select_tier(capacity))
            rows = np.sort(plan.index.map_rows(idx))
            return rows if plan.residual_host is None \
                else self._refine(plan, rows)
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

    def _union_select(self, plan: UnionScanPlan, auths) -> np.ndarray:
        """Sorted unique rows of an OR plan: one union program when every
        branch is device-exact on one index, else the union of the branch
        row sets."""
        rows = _fused.try_union_select(self, plan, auths)
        if rows is not None:
            return rows
        sets = [self.select_indices(c, plan=bp, auths=auths)
                for c, bp in plan.branches]
        if not sets:
            return np.empty(0, dtype=np.int64)
        return np.unique(np.concatenate(sets))

    def scan_mask(self, f: Union[str, ir.Filter], auths=None):
        """(plan, device mask over the plan index's sorted rows); the mask
        is None when the plan needs a host refine (≙ the reference's
        ``scan_mask``, the aggregation scans' shared validate step)."""
        plan = self._apply_auths(self.plan(f), auths)
        if isinstance(plan, UnionScanPlan):
            idx = plan.same_index_device_exact()
            if idx is None or plan.empty:
                return plan, None
            stages = self._union_stages(plan, auths)
            if not stages:
                return plan, torch.zeros(idx.kernels.n, dtype=torch.bool,
                                         device=idx.kernels.device)
            return plan, idx.kernels.union_mask(stages)
        if not plan.device_exact:
            return plan, None
        return plan, plan.index.kernels.mask(
            plan.primary_kind, plan.boxes_loose, plan.windows,
            plan.residual_device)

    def query(self, f: Union[str, ir.Filter], auths=None) -> QueryResult:
        plan = self.plan(f)
        rows = self.select_indices(f, plan=plan, auths=auths)
        return QueryResult(rows, self.table.take(rows), plan)

    # -- helpers -------------------------------------------------------------

    def _refine(self, plan: IndexScanPlan, rows: np.ndarray) -> np.ndarray:
        """Host f64 re-evaluation of device candidates against the residual
        (≙ the reference's full-filter path over overlapping-range rows),
        evaluated in place at the candidate rows."""
        if len(rows) == 0 or plan.residual_host is None:
            return rows
        return rows[self._refine_mask(plan.residual_host, rows)]

    @property
    def device(self) -> torch.device:
        """The device the type's indexes (and so its catalog route) run on."""
        return self.indexes[0].kernels.device

    def _refine_mask(self, res: ir.Filter, rows: np.ndarray) -> np.ndarray:
        """Residual mask over candidate rows (≙ the reference's route). With
        GEOMESA_TPU_GEOM_KERNELS on (the default), each st_* part of an AND
        residual goes through the device catalog (``geom.catalog``) on the
        planner's device: the predicates' bands plus the f64 refine of
        their uncertain sliver give the host oracle's mask, and a scalar
        comparison reads the f32 kernel value, as the reference's does. The
        other parts, and every part with the knob off, evaluate on the
        host (``evaluate_at``)."""
        parts = res.children if isinstance(res, ir.And) else (res,)
        if config.GEOM_KERNELS.get() \
                and any(isinstance(p, (ir.Func, ir.FuncCmp)) for p in parts):
            from geomesa_tpu_torch.geom.functions import eval_filter_node
            mask = np.ones(len(rows), dtype=bool)
            rest = []
            for p in parts:
                if isinstance(p, (ir.Func, ir.FuncCmp)):
                    mask &= eval_filter_node(p, self.table, rows,
                                             kernels=True,
                                             device=self.device)
                else:
                    rest.append(p)
            if rest:
                mask &= evaluate_at(ir.and_filters(rest), self.table, rows)
            return mask
        return evaluate_at(res, self.table, rows)


class PreparedQuery:
    """A planned query with its constants staged on the device.

    ``count_async`` dispatches and returns the 0-d count tensor without a
    readback, so many queries can be read back together; ``count`` and
    ``select_indices`` block for the value. Plans that need a host refine
    run through the planner's general execution (``count``)."""

    def __init__(self, planner: QueryPlanner, plan: IndexScanPlan,
                 f: ir.Filter, auths):
        self.planner = planner
        self.plan = plan
        self.filter = f
        self.auths = auths
        self._count_disp = None
        self._fused = None
        if plan.device_exact:
            prog = _fused.prepare_count_program(planner, plan)
            if prog is not None:
                # the fused program: cover + scan + residual + count
                self._fused = prog
                self._count_disp = lambda: prog.run()[0]
                return
            blocks = planner._pruned_blocks(plan)
            kernels = plan.index.kernels
            if blocks is not None and len(blocks) > 0:
                self._count_disp = kernels.prepare_count_blocks(
                    plan.primary_kind, plan.boxes_loose, plan.windows,
                    plan.residual_device, blocks, _prune.BLOCK_SIZE)
            elif blocks is None:
                self._count_disp = kernels.prepare_count(
                    plan.primary_kind, plan.boxes_loose, plan.windows,
                    plan.residual_device)
            else:  # provably-empty candidate set
                self._count_disp = lambda: np.zeros((), dtype=np.int32)

    @property
    def device_exact(self) -> bool:
        """True when the whole query resolves on the device (no host
        refine)."""
        return self._count_disp is not None

    def count_async(self):
        """Dispatch → 0-d int32 count (None for empty plans), on the
        device for the fused and the staged programs: no readback and no
        host sync, so the call returns once the kernels are queued."""
        if self._count_disp is None:
            if self.plan.empty:
                return None
            raise ValueError("plan needs host execution; use count()")
        with _trace.span("device_scan", kind="device_scan"):
            return self._count_disp()

    def count(self) -> int:
        """Blocking count, subject to the planner's cooperative deadline."""
        attrs = {"type": self.planner.sft.name, "prepared": True}
        if _trace.enabled():
            attrs["filter"] = str(self.filter)
        with _trace.trace("count", **attrs):
            dl = Deadline(self.planner.timeout_ms)
            t0 = time.perf_counter()
            if self.plan.empty:
                n = 0
            elif self._count_disp is not None:
                n = int(_fetch(self._count_disp))
            else:
                n = self.planner._count(self.plan, self.filter, self.auths)
            dl.check("scan")
            self.planner._write_audit(self.plan, self.filter, 0.0,
                                      (time.perf_counter() - t0) * 1000, n)
            return n

    def select_indices(self) -> np.ndarray:
        return self.planner.select_indices(self.filter, plan=self.plan,
                                           auths=self.auths)
