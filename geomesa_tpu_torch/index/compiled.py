"""The fused query program: one plan → cover, scan, residual, refine and
aggregate on the device (≙ ``geomesa_tpu.index.compiled``).

For a point_boxes plan the program

1. gates the table's gather blocks against per-block f32 summaries of the
   coordinates and time bins (a slack-expanded superset: the exact masks
   re-apply to every candidate row) and lists the alive blocks in
   ascending order with their count, on the device (the ``block_gate``
   CUDA kernel);
2. scans every candidate of those blocks in place, whatever their number
   — the gate is a proven superset, so these are the rows of the
   reference's pruned branch and of its full-table branch alike, in the
   same order, and no branch is chosen — with the exact fp62 box mask,
   the exact time windows and the residual lowered to a postfix program
   (the ``fused_scan`` CUDA kernel);
3. counts, or compacts the scan's mask into row positions of a
   fixed-capacity result (the ``ordered_compact`` CUDA kernel); in the
   refine modes classifies the masked candidate rows (certain hit /
   uncertain) by the plan's refine kind: against a polygon with the
   ``pip_refine`` CUDA kernel, or against a circle with the
   ``dist_refine`` CUDA kernel, then compacts the hits and the uncertain
   rows in order (the ``ordered_compact`` CUDA kernel); in the density
   mode scatters them onto a raster with the ``grid_scatter`` CUDA
   kernel. Every kernel after the gate reads the block count on the
   device and stops there, so nothing is sized by a value read back and
   the program makes no host sync (``scan.host_syncs`` counts none).

Under authorizations the query buffer carries the allowed visibility
codes as a bitmap (``scan.FusedQuery``'s ``vis`` section, ≙ the
reference's ``vis`` section), which ``fused_scan`` tests against the
``__vis__`` plane; the union program folds the auths branch by branch and
drops a branch they leave empty, and the recipe cache is keyed by (shape,
sorted auths).

The uncertain sliver re-evaluates on the host in exact f64. An OR whose
branches are all device-exact on one index runs as one ``UnionProgram``:
the branch gates and masks OR inside the same kernels (select and
density modes).

Prepared counts (``planner.prepare``) register each filter shape's outcome
in a per-planner recipe cache; a repeat shape with new values binds them
straight into a count ``Program`` (``fast_prepare``: no ``planner.plan()``,
no range cover), as the reference's recipe fast path does. PyTorch runs
eagerly, so where the reference rebinds a packed constant vector into a
compiled program, the port packs the bound values into one buffer
(``scan.FusedQuery``) and builds a ``Program`` over it.

Modes: ``count``, ``select``, ``count_refine``, ``select_refine``,
``density`` (a union program: ``select``, ``density``). The results are
the reference program's, value for value: the same packed int32 layout,
capacities and fill, and for ``density`` the same (H, W) f32 grid and
int32 count.

The ``try_*`` entry points return None for every plan the reference's
``_from_plan`` declines (the fused switch off, no spatial box, a host
residual other than a refine kind, a table under four blocks), and for a
residual nested deeper than the kernel's program stack
(``scan.MAX_PROGRAM_DEPTH``) or residuals that read more columns than the
kernel holds (``kernels.fused_scan.MAX_SLOTS``); the planner then runs the staged path
(``index/scan.py`` ``ScanKernels``). Their results read back through
pinned memory (``scan._fetch``).
"""

from __future__ import annotations

import math
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from geomesa_tpu_torch import config
from geomesa_tpu_torch import trace as _trace
from geomesa_tpu_torch.arith import pow2
from geomesa_tpu_torch.curves.binnedtime import time_to_binned_time
from geomesa_tpu_torch.features import geometry as geo
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.filter.evaluate import evaluate_at
from geomesa_tpu_torch.filter.extract import extract_bboxes, extract_intervals
from geomesa_tpu_torch.filter.geom_numpy import literal_segments
from geomesa_tpu_torch.index import prune as _prune
from geomesa_tpu_torch.index.api import IndexScanPlan, UnionScanPlan
from geomesa_tpu_torch.index.scan import (EDGE_PAD, FusedQuery, Residual,
                                          Unsupported, _dev, _fetch,
                                          compile_residual, dist_bounds,
                                          fold_vis, pad_boxes, pad_windows,
                                          shared_vis, split_residual)
from geomesa_tpu_torch.index.spatial import _boxes_fp62, _strip_handled
from geomesa_tpu_torch.kernels.compact import ordered_compact
from geomesa_tpu_torch.kernels.density import grid_scatter
from geomesa_tpu_torch.kernels.dist import dist_refine
from geomesa_tpu_torch.kernels.fused_scan import MAX_SLOTS, fused_scan
from geomesa_tpu_torch.kernels.gate import block_gate
from geomesa_tpu_torch.kernels.pip import pip_refine
from geomesa_tpu_torch.metrics import REGISTRY
from geomesa_tpu_torch.serve.resilience import deadline as _rdl

# block-gate slack in degrees: the per-block summaries are f32 reductions of
# the f32 coordinate planes and the gate envelopes are f32 roundings of f64
# query bounds — both within 2.5e-5 of exact, far inside 1e-3, so a
# gated-out block provably holds no match
_GATE_SLACK = np.float32(1e-3)

# select-capacity tiers (the reference's; hints quantize UP)
_SELECT_TIERS = (1 << 10, 1 << 13, 1 << 16, 1 << 19, 1 << 22)

_UNC_CAP = 4096  # refine-mode uncertain-row capacity (regrows past it)

# the packed query constants (boxes, gates, windows, residual programs) sit
# in a kernel's shared memory: a query past this serves staged
QUERY_MAX_BYTES = 96 * 1024

_REFINE_MODES = ("count_refine", "select_refine")

_I32_MIN = -(1 << 31) + 1
_I32_MAX = (1 << 31) - 1

# observable ledger for tests and the debug surfaces: the reference's keys,
# counted where the reference counts them (its ``programs_built`` has no
# counterpart: the port compiles nothing)
STATS: Dict[str, int] = {
    "queries": 0,          # runs served by a fused program
    "fallbacks": 0,        # qualification declines (staged path served)
    "shape_hits": 0,       # recipe fast-path binds (no planner.plan at all)
    "shape_misses": 0,     # shapes seen before a recipe existed
    "bind_failures": 0,    # recipe present but the new values didn't bind
    "overflow_retries": 0, # capacity regrows
}


def _tier(capacity: Optional[int]) -> int:
    if capacity is None:
        return 1 << 16
    for t in _SELECT_TIERS:
        if capacity <= t:
            return t
    return pow2(capacity)


# -- per-block device summaries (the in-kernel cover) -------------------------


def block_summaries(index, bsz: int) -> dict:
    """Per-gather-block coordinate and time-bin envelopes (≙ the reference's
    ``_block_summaries``), on the device and cached on the index: the f32
    min/max of ``xf``/``yf`` widened by the slack, and the int32 min/max of
    ``bin`` (a ragged last block pads with the fold values, so padding never
    keeps a block alive)."""
    cached = getattr(index, "_fused_summ", None)
    if cached is not None and cached[0] == bsz:
        return cached[1]
    cols = index.device.columns
    n = int(cols["xf"].shape[0])
    nb = -(-n // bsz)
    pad = nb * bsz - n

    def blocked(c, fill):
        if pad:
            c = torch.cat([c, c.new_full((pad,), fill)])
        return c.reshape(nb, bsz)

    inf = float("inf")
    slack = float(_GATE_SLACK)
    summ = {
        "bxmin": blocked(cols["xf"], inf).amin(dim=1) - slack,
        "bxmax": blocked(cols["xf"], -inf).amax(dim=1) + slack,
        "bymin": blocked(cols["yf"], inf).amin(dim=1) - slack,
        "bymax": blocked(cols["yf"], -inf).amax(dim=1) + slack,
    }
    if "bin" in cols:
        summ["binmin"] = blocked(cols["bin"], _I32_MAX).amin(dim=1)
        summ["binmax"] = blocked(cols["bin"], _I32_MIN).amax(dim=1)
    index._fused_summ = (bsz, summ)
    return summ


def _gate_of(boxes_geo, B: int) -> np.ndarray:
    """(B, 4) f32 [xmin, ymin, xmax, ymax] block-gate envelopes; padded rows
    are inverted (nothing alive)."""
    gate = np.empty((B, 4), dtype=np.float32)
    gate[:, 0] = 3e38
    gate[:, 1] = 3e38
    gate[:, 2] = -3e38
    gate[:, 3] = -3e38
    for i, (xmin, ymin, xmax, ymax) in enumerate(boxes_geo):
        gate[i] = (xmin, ymin, xmax, ymax)
    return gate


def refine_spec(plan: IndexScanPlan):
    """(kind, f32 constants) when the host residual is a single predicate
    the fused program can classify with certainty bands over the index's
    point geometry (≙ the reference's ``_refine_spec``), else None:

    - ``("pip", edges)`` — point-in-polygon against the padded edge table
      (pow2 rows ≥ 4, ``EDGE_PAD`` filler), for ``INTERSECTS(geom,
      POLYGON)`` and for ``st_contains(POLYGON, geom)`` /
      ``st_intersects(geom, POLYGON)`` / ``st_intersects(POLYGON, geom)``
      (a point intersects or lies within a polygon iff it is in it);
    - ``("dist", [cx, cy, r])`` — the banded radial distance, for
      ``st_distance(geom, POINT) < r`` or ``<= r`` (rows within
      ``DIST_BAND`` of the circle are uncertain, so the comparison's
      strictness resolves in the exact host refine).
    """
    res = plan.residual_host
    geom_attr = plan.index.geom
    lit = None
    if isinstance(res, ir.Intersects):
        if res.attr != geom_attr:
            return None
        lit = res.geometry
    elif isinstance(res, ir.Func) and len(res.args) == 2:
        a, b = res.args
        if res.name in ("st_contains", "st_intersects") \
                and isinstance(a, tuple) and b == geom_attr:
            lit = a
        elif res.name == "st_intersects" and isinstance(b, tuple) \
                and a == geom_attr:
            lit = b
    elif isinstance(res, ir.FuncCmp) and res.name == "st_distance" \
            and res.op in ("<", "<=") and len(res.args) == 2:
        a, b = res.args
        pt = a if isinstance(a, tuple) else b if isinstance(b, tuple) else None
        attr_arg = b if isinstance(a, tuple) else a
        if pt is None or attr_arg != geom_attr or pt[0] != geo.POINT:
            return None
        r = float(res.value)
        if not r >= 0.0:
            return None
        return "dist", np.array([pt[1][0], pt[1][1], r], dtype=np.float32)
    if lit is None or lit[0] != geo.POLYGON:
        return None
    edges = literal_segments(lit).astype(np.float32)
    ep = np.tile(EDGE_PAD, (max(4, pow2(len(edges))), 1))
    ep[: len(edges)] = edges
    return "pip", ep


def real_edges(edges: np.ndarray) -> int:
    """Rows of a ``pip`` edge table before its ``EDGE_PAD`` filler."""
    n = len(edges)
    while n and np.array_equal(edges[n - 1], EDGE_PAD):
        n -= 1
    return n


class Program:
    """The fused program of one plan in one mode (≙ the reference's
    ``_jit_program``), with its constants packed into one device buffer
    (``scan.FusedQuery``). ``run()`` returns the reference program's
    result, on the device, with no host sync on the way:

    - ``count``: int32 [count]
    - ``select``: int32 [count, positions × sel_cap]
    - ``count_refine``: int32 [certain, uncertain, uncertain positions ×
      unc_cap], by the ``refine`` kind (``refine_spec``)
    - ``select_refine``: int32 [certain, uncertain, certain positions ×
      sel_cap, uncertain positions × unc_cap]
    - ``density``: ((height, width) f32 grid over ``grid`` = [xmin, ymin,
      xmax, ymax], 0-d int32 count of the masked rows)

    Positions index the table's sorted rows, ascending, padded with n. The
    candidates are the alive blocks in ascending order, whatever their
    number (see the module's note on the branch)."""

    def __init__(self, plan: IndexScanPlan, mode: str, sel_cap: int = 0,
                 unc_cap: int = 0, refine: Optional[tuple] = None,
                 grid=None, width: int = 0, height: int = 0):
        self._bind(plan.index, mode, plan.boxes_loose,
                   _gate_of(plan.explain["boxes"], len(plan.boxes_loose)),
                   plan.windows, plan.residual_device, sel_cap, unc_cap,
                   refine, grid, width, height)

    @classmethod
    def of_values(cls, index, mode: str, boxes: np.ndarray, gate: np.ndarray,
                  windows: Optional[np.ndarray],
                  residual: Optional[Residual]) -> "Program":
        """The program of already-bound query values — pow2-padded fp62
        ``boxes``, their (B, 4) f32 block ``gate``, pow2-padded
        ``windows`` and the compiled device ``residual`` — built without a
        plan (the recipe fast path's rebind)."""
        prog = cls.__new__(cls)
        prog._bind(index, mode, boxes, gate, windows, residual)
        return prog

    def _bind(self, index, mode: str, boxes: np.ndarray, gate: np.ndarray,
              windows: Optional[np.ndarray], residual: Optional[Residual],
              sel_cap: int = 0, unc_cap: int = 0,
              refine: Optional[tuple] = None, grid=None, width: int = 0,
              height: int = 0) -> None:
        self._bind_common(index, mode, sel_cap, grid, width, height,
                          [(boxes, gate, windows, residual)])
        self.unc_cap = unc_cap
        self.res_key = residual[0] if residual is not None else "none"
        dev = index.device.device
        self.refine = None if refine is None else refine[0]
        self.edges = self.n_edges = self.dist = None
        if self.refine == "pip":
            self.edges = _dev(refine[1], dev)
            self.n_edges = real_edges(refine[1])
        elif self.refine == "dist":
            # the circle's f32 bounds, made once: launch arguments
            self.dist = dist_bounds(refine[1])

    def _bind_common(self, index, mode: str, sel_cap: int, grid, width: int,
                     height: int, branches) -> None:
        """Binds what every program has; ``branches`` are (boxes, gate,
        windows, residual) and pack into the one query buffer, with the
        allowed visibility codes of residuals folded under authorizations
        (``scan.fold_vis``) as its ``vis`` section. Raises Unsupported when
        the branches' allowed codes differ, a residual has no program, the
        residuals read more
        columns than ``fused_scan.MAX_SLOTS`` or the buffer is past
        ``QUERY_MAX_BYTES`` (the caller serves the plan staged)."""
        self.index = index
        self.mode = mode
        self.sel_cap = sel_cap
        self.n = index.device.n
        self.bsz = int(_prune.BLOCK_SIZE)
        progs = []
        for boxes, gate, windows, res in branches:
            if res is not None and res.program is None:
                raise Unsupported("residual deeper than the program stack")
            progs.append((boxes, gate, windows,
                          None if res is None else res.program))
        # the allowed visibility codes: one section of the query (≙ the
        # reference's ``vis``, ``geomesa_tpu/index/compiled.py:655-660``)
        self.query = FusedQuery(progs, shared_vis([b[3] for b in branches]))
        if len(self.query.slots) > MAX_SLOTS:
            raise Unsupported(f"residuals read {len(self.query.slots)} "
                              f"columns, past the kernel's {MAX_SLOTS}")
        if len(self.query.packed) > QUERY_MAX_BYTES:
            raise Unsupported("query constants past the kernels' shared "
                              "memory")
        dev = index.device.device
        self.qbuf = _dev(self.query.packed, dev)
        # the raster's bbox rounds f64 → f32 as the reference stages it
        self.grid = None if grid is None \
            else _dev(np.asarray(grid, dtype=np.float32), dev)
        self.width = width
        self.height = height

    def _gate(self):
        """(ids, starts, n_blocks) of the alive blocks (``block_gate``)."""
        return block_gate(block_summaries(self.index, self.bsz), self.qbuf,
                          self.query, self.n, self.bsz)

    def _candidates(self):
        """(mask, n_blocks, starts): the match flag of every candidate of
        the alive blocks (candidate i is row ``starts[i // bsz] + i %
        bsz``), for the first ``n_blocks`` blocks; past them the flags are
        not written on the card (and 0 on the CPU)."""
        ids, starts, nblk = self._gate()
        m, _ = fused_scan(self.index.device.columns, self.qbuf, self.query,
                          ids, nblk, self.bsz, "mask")
        return m, nblk, starts

    def run(self):
        cols = self.index.device.columns
        n, bsz = self.n, self.bsz
        if self.mode == "count":
            ids, _, nblk = self._gate()
            return fused_scan(cols, self.qbuf, self.query, ids, nblk, bsz,
                              "count")
        m, nblk, starts = self._candidates()
        if self.mode == "select":
            out = torch.empty(1 + self.sel_cap, dtype=torch.int32,
                              device=m.device)
            ordered_compact(m, self.sel_cap, n, starts=starts, bsz=bsz,
                            n_blocks=nblk, count_out=out[0:1],
                            rows_out=out[1:])
            return out
        if self.mode == "density":
            return grid_scatter(cols["xf"], cols["yf"], m, None, starts, bsz,
                                self.grid, self.width, self.height,
                                n_blocks=nblk)
        if self.mode not in _REFINE_MODES:
            raise ValueError(self.mode)
        kw = dict(mask=m, starts=starts, bsz=bsz, n_blocks=nblk)
        if self.refine == "dist":
            hit, unc, _ = dist_refine(cols["xf"], cols["yf"], self.dist, **kw)
        else:
            hit, unc = pip_refine(cols["xf"], cols["yf"], self.edges,
                                  n_edges=self.n_edges, **kw)
        sel = self.sel_cap if self.mode == "select_refine" else 0
        out = torch.empty(2 + sel + self.unc_cap, dtype=torch.int32,
                          device=m.device)
        kw = dict(starts=starts, bsz=bsz, n_blocks=nblk)
        ordered_compact(hit, sel, n, count_out=out[0:1],
                        rows_out=out[2: 2 + sel], **kw)
        ordered_compact(unc, self.unc_cap, n, count_out=out[1:2],
                        rows_out=out[2 + sel:], **kw)
        return out


class UnionProgram(Program):
    """The fused program of an OR whose branches are all device-exact
    point-box scans on one index (≙ the reference's ``_jit_union_program``),
    in ``select`` or ``density`` mode, with ``Program``'s results. A block
    is alive when any branch's gate touches it; a row matches when any
    branch's boxes, windows and device residual hold, so rows that two
    branches share count once. The branches pack into one query buffer,
    and the kernels OR them per candidate."""

    def __init__(self, plan: UnionScanPlan, mode: str, sel_cap: int = 0,
                 grid=None, width: int = 0, height: int = 0,
                 branches=None):
        """``branches``: the branch plans to bind, when not the plan's own
        (``_union_from_plan`` passes them folded under the caller's
        authorizations, the empty ones dropped)."""
        if branches is None:
            branches = [bp for _, bp in plan.branches]
        self._bind_common(plan.same_index_device_exact(), mode, sel_cap,
                          grid, width, height, [
                              (bp.boxes_loose,
                               _gate_of(bp.explain["boxes"],
                                        len(bp.boxes_loose)),
                               bp.windows, bp.residual_device)
                              for bp in branches])


# -- qualification and execution ----------------------------------------------


def _from_plan(plan: IndexScanPlan, mode: str, capacity: Optional[int] = None,
               unc_cap: int = 0, grid=None, width: int = 0,
               height: int = 0) -> Optional[Program]:
    """The fused program of a plan in one mode, or None when the fused
    program does not take the plan and the staged path answers it (≙ the
    reference's ``_from_plan``/``_build`` declines)."""
    if not config.FUSED_QUERY.get():
        return None
    if plan.empty or plan.index is None \
            or plan.primary_kind != "point_boxes" or plan.boxes_loose is None \
            or plan.candidate_slices is not None:
        return None
    boxes_geo = plan.explain.get("boxes")
    if not boxes_geo or len(boxes_geo) > len(plan.boxes_loose):
        return None
    refine = None
    if mode in _REFINE_MODES:
        refine = refine_spec(plan)
        if refine is None:
            return None
    elif plan.residual_host is not None:
        return None
    n = plan.index.device.n
    if n < 4 * int(_prune.BLOCK_SIZE):
        return None  # tiny tables: the staged full mask is already one pass
    sel_cap = min(_tier(capacity), pow2(n)) \
        if mode in ("select", "select_refine") else 0
    try:
        return Program(plan, mode, sel_cap=sel_cap, unc_cap=unc_cap,
                       refine=refine, grid=grid, width=width, height=height)
    except Unsupported:
        return None


def _fallback() -> None:
    if config.FUSED_QUERY.get():
        STATS["fallbacks"] += 1


def _dispatched() -> None:
    _rdl.check_current("fused_dispatch")
    STATS["queries"] += 1
    REGISTRY.inc("fused.queries")


def prepare_count_program(planner, plan: IndexScanPlan) -> Optional[Program]:
    """The PreparedQuery hook: the fused count program of a device-exact
    plan, or None (the staged dispatchers take over)."""
    prog = _from_plan(plan, "count")
    if prog is not None:
        STATS["queries"] += 1
        REGISTRY.inc("fused.queries")
    else:
        _fallback()
    return prog


def try_count(planner, plan: IndexScanPlan) -> Optional[int]:
    """One-program count of a device-exact plan, or None."""
    prog = _from_plan(plan, "count")
    if prog is None:
        _fallback()
        return None
    _dispatched()
    return int(_fetch(prog.run)[0])


def try_select(planner, plan: IndexScanPlan,
               capacity: Optional[int]) -> Optional[np.ndarray]:
    """One-program select → index POSITIONS (the caller maps and sorts), or
    None. Overflow regrows the capacity tier and re-runs."""
    while True:
        prog = _from_plan(plan, "select", capacity=capacity)
        if prog is None:
            _fallback()
            return None
        _dispatched()
        out = _fetch(prog.run).numpy()
        cnt = int(out[0])
        if cnt <= prog.sel_cap:
            return out[1: 1 + cnt].astype(np.int64)
        STATS["overflow_retries"] += 1
        capacity = pow2(cnt)


def try_count_refine(planner, plan: IndexScanPlan) -> Optional[int]:
    """Fused scan + polygon refine + count: certain hits plus the host f64
    verdict on the uncertain sliver, or None. An uncertainty overflow
    regrows the capacity and re-runs (the reference hands it to the staged
    path instead; the results are the same)."""
    unc_cap = _UNC_CAP
    while True:
        prog = _from_plan(plan, "count_refine", unc_cap=unc_cap)
        if prog is None:
            _fallback()
            return None
        _dispatched()
        out = _fetch(prog.run).numpy()
        certain, n_unc = int(out[0]), int(out[1])
        if n_unc <= unc_cap:
            break
        STATS["overflow_retries"] += 1
        unc_cap = pow2(n_unc)
    if n_unc == 0:
        return certain
    rows = plan.index.map_rows(out[2: 2 + n_unc].astype(np.int64))
    return certain + int(np.sum(
        evaluate_at(plan.residual_host, planner.table, rows)))


def try_select_refine(planner, plan: IndexScanPlan,
                      capacity: Optional[int]) -> Optional[np.ndarray]:
    """Fused select with the polygon refine → FINAL sorted table rows
    (certain hits + host-confirmed uncertain rows), or None. Overflow of the
    select or uncertain capacity regrows it and re-runs."""
    unc_cap = _UNC_CAP
    while True:
        prog = _from_plan(plan, "select_refine", capacity=capacity,
                          unc_cap=unc_cap)
        if prog is None:
            _fallback()
            return None
        _dispatched()
        out = _fetch(prog.run).numpy()
        n_in, n_unc = int(out[0]), int(out[1])
        if n_in > prog.sel_cap:
            capacity = pow2(n_in)
        elif n_unc > unc_cap:
            unc_cap = pow2(n_unc)
        else:
            break
        STATS["overflow_retries"] += 1
    sel_cap = prog.sel_cap
    rows = plan.index.map_rows(out[2: 2 + n_in].astype(np.int64))
    if n_unc:
        unc_rows = plan.index.map_rows(
            out[2 + sel_cap: 2 + sel_cap + n_unc].astype(np.int64))
        keep = evaluate_at(plan.residual_host, planner.table, unc_rows)
        rows = np.concatenate([rows, unc_rows[keep]])
    return np.sort(rows)


def try_density(planner, plan: IndexScanPlan, grid_bbox, width: int,
                height: int):
    """One-program heat-map: ((H, W) f32 grid, count) as numpy and int, or
    None. Available to aggregation callers; the staged density modes stay
    the default route (as in the reference)."""
    prog = _from_plan(plan, "density", grid=grid_bbox, width=width,
                      height=height)
    if prog is None:
        _fallback()
        return None
    _dispatched()
    grid, cnt = _fetch(prog.run)
    return grid.numpy(), int(cnt)


def _union_from_plan(planner, plan: UnionScanPlan, mode: str, auths,
                     capacity: Optional[int] = None, grid=None,
                     width: int = 0, height: int = 0
                     ) -> Optional[UnionProgram]:
    """The union program of an OR plan, or None when a branch is not a
    device-exact point-box scan on the shared index (≙ the reference's
    ``_build_union`` declines; the per-branch path then serves it). The
    branches fold the auths one by one, and a branch that they leave
    empty drops out (``geomesa_tpu/index/compiled.py:1089-1092``); None
    when none is left."""
    if not config.FUSED_QUERY.get():
        return None
    idx = plan.same_index_device_exact()
    if idx is None or idx.device.n < 4 * int(_prune.BLOCK_SIZE):
        return None
    branches = []
    for _, bp in plan.branches:
        bp = planner._apply_auths(bp, auths)
        if bp.empty:
            continue
        boxes_geo = bp.explain.get("boxes")
        if bp.primary_kind != "point_boxes" or bp.boxes_loose is None \
                or bp.candidate_slices is not None \
                or not boxes_geo or len(boxes_geo) > len(bp.boxes_loose):
            return None
        branches.append(bp)
    if not branches:
        return None
    sel_cap = min(_tier(capacity), pow2(idx.device.n)) \
        if mode == "select" else 0
    try:
        return UnionProgram(plan, mode, sel_cap=sel_cap, grid=grid,
                            width=width, height=height, branches=branches)
    except Unsupported:
        return None


def try_union_select(planner, plan: UnionScanPlan, auths,
                     capacity: Optional[int] = None) -> Optional[np.ndarray]:
    """One-program select of an OR plan → FINAL sorted table rows (rows of
    overlapping branches once), or None. Overflow regrows the capacity tier
    and re-runs."""
    while True:
        prog = _union_from_plan(planner, plan, "select", auths,
                                capacity=capacity)
        if prog is None:
            _fallback()
            return None
        _dispatched()
        out = _fetch(prog.run).numpy()
        cnt = int(out[0])
        if cnt <= prog.sel_cap:
            return np.sort(prog.index.map_rows(
                out[1: 1 + cnt].astype(np.int64)))
        STATS["overflow_retries"] += 1
        capacity = pow2(cnt)


def try_union_density(planner, plan: UnionScanPlan, auths, grid_bbox,
                      width: int, height: int):
    """One-program heat-map of an OR plan: ((H, W) f32 grid, count) as
    numpy and int, or None."""
    prog = _union_from_plan(planner, plan, "density", auths, grid=grid_bbox,
                            width=width, height=height)
    if prog is None:
        _fallback()
        return None
    _dispatched()
    grid, cnt = _fetch(prog.run)
    return grid.numpy(), int(cnt)


# -- shape-keyed recipe fast path (skip planning entirely) --------------------


def _shape_key(f: ir.Filter) -> str:
    """Value-free structural signature of a filter tree (the reference's,
    string for string): two queries with this key in common differ only in
    geometry/time/constant VALUES."""
    if isinstance(f, ir.And):
        return "and(" + ",".join(_shape_key(c) for c in f.children) + ")"
    if isinstance(f, ir.Or):
        return "or(" + ",".join(_shape_key(c) for c in f.children) + ")"
    if isinstance(f, ir.Not):
        return f"not({_shape_key(f.child)})"
    if isinstance(f, ir.Include):
        return "inc"
    if isinstance(f, ir.Exclude):
        return "exc"
    if isinstance(f, ir.BBox):
        return f"bbox:{f.attr}"
    if isinstance(f, ir.Intersects):
        return f"ints:{f.attr}:{f.geometry[0]}"
    if isinstance(f, ir.During):
        return f"during:{f.attr}:{int(f.lo_inclusive)}{int(f.hi_inclusive)}"
    if isinstance(f, ir.Cmp):
        return f"cmp{f.op}:{f.attr}"
    if isinstance(f, ir.In):
        return f"in{pow2(len(f.values))}:{f.attr}"
    if isinstance(f, ir.Func):
        return f"fn:{f.name}({_func_args_sig(f.args)})"
    if isinstance(f, ir.FuncCmp):
        return f"fc{f.op}:{f.name}({_func_args_sig(f.args)})"
    raise Unsupported(type(f).__name__)


def _func_args_sig(args: tuple) -> str:
    """Value-free signature of st_* call arguments: attributes by name,
    geometry literals by type code, scalars as 'f'."""
    parts = []
    for a in args:
        if isinstance(a, str):
            parts.append(f"a:{a}")
        elif isinstance(a, tuple):
            parts.append(f"l{a[0]}")
        elif isinstance(a, ir.FuncExpr):
            parts.append(f"{a.name}({_func_args_sig(a.args)})")
        else:
            parts.append("f")
    return ",".join(parts)


def _auths_key(auths) -> Optional[tuple]:
    return None if auths is None else tuple(sorted(auths))


class _RecipeCache:
    """Small thread-safe LRU for (shape, auths) → Recipe | None (negative),
    bounded by ``GEOMESA_TPU_FUSED_SHAPE_CACHE``."""

    MISS = object()

    def __init__(self):
        self._d: "OrderedDict" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            v = self._d.get(key, self.MISS)
            if v is not self.MISS:
                self._d.move_to_end(key)
            return v

    def put(self, key, value) -> None:
        with self._lock:
            cap = max(1, int(config.FUSED_SHAPE_CACHE.get()))
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > cap:
                self._d.popitem(last=False)

    def __len__(self) -> int:
        return len(self._d)


def _recipes(planner) -> _RecipeCache:
    cache = getattr(planner, "_fused_recipes", None)
    if cache is None:
        cache = _RecipeCache()
        planner._fused_recipes = cache
    return cache


_EMPTY_BIND = object()   # bind result: provably-empty query (count 0)


def _boxes_fp62_fast(boxes) -> Optional[np.ndarray]:
    """Scalar twin of ``spatial._boxes_fp62`` for a handful of boxes:
    Python float math, bit-identical to the numpy path (Python floats are C
    doubles, and floor(ldexp(frac, 62)) of an integral float converts to
    int exactly). None on a NaN or infinite coordinate (the caller then
    uses the array path)."""
    out = np.empty((len(boxes), 8), dtype=np.int32)
    m62 = (1 << 62) - 1
    m31 = (1 << 31) - 1
    try:
        for i, (xmin, ymin, xmax, ymax) in enumerate(boxes):
            row = out[i]
            for j, (c, lo, span) in enumerate(
                    ((xmin, -180.0, 360.0), (xmax, -180.0, 360.0),
                     (ymin, -90.0, 180.0), (ymax, -90.0, 180.0))):
                frac = (float(c) - lo) / span
                frac = 0.0 if frac < 0.0 else (1.0 if frac > 1.0 else frac)
                v = min(math.floor(math.ldexp(frac, 62)), m62)
                row[2 * j] = v >> 31
                row[2 * j + 1] = v & m31
    except (ValueError, OverflowError):   # NaN / inf coordinate
        return None
    return out


class Recipe:
    """Bind instructions for one (filter shape, auths): everything needed to
    turn a NEW same-shape filter into a fused count program without calling
    ``planner.plan()`` — extract boxes/intervals, window them, recompile
    the device residual (its structure key must reproduce the recipe's).
    Any drift (box count, window count, residual key, a host residual)
    returns None and the planner serves the query exactly."""

    __slots__ = ("index", "sft", "geom", "dtg", "period", "vocabs",
                 "n_boxes", "n_windows", "res_key", "vis", "template_plan")

    def __init__(self, plan, planner, res_key, vis=None):
        self.index = plan.index
        self.sft = planner.sft
        self.geom = plan.index.geom
        self.dtg = plan.index.dtg
        self.period = plan.index.period
        self.vocabs = plan.index.vocabs
        self.n_boxes = len(plan.boxes_loose)
        self.n_windows = 0 if plan.windows is None else len(plan.windows)
        self.res_key = res_key
        # the allowed visibility codes the shape was folded with (None: no
        # visibility test), re-folded into every bind
        self.vis = vis
        self.template_plan = plan

    def bind(self, f: ir.Filter):
        """→ (boxes, gate, windows, dev_ir) | _EMPTY_BIND | None."""
        if self.geom is None:
            return None
        ext = extract_bboxes(f, self.geom)
        if len(ext.boxes) == 0:
            return _EMPTY_BIND
        if ext.unconstrained:
            return None
        boxes = (_boxes_fp62_fast(ext.boxes) if len(ext.boxes) <= 4
                 else None)
        if boxes is None:
            boxes = _boxes_fp62(ext.boxes)
        if len(boxes) & (len(boxes) - 1):
            boxes = pad_boxes(boxes)
        if len(boxes) != self.n_boxes:
            return None
        windows = None
        iv = extract_intervals(f, self.dtg) if self.dtg else None
        if iv is not None and len(iv.intervals) == 0:
            return _EMPTY_BIND
        if iv is not None and not iv.unconstrained:
            w = np.empty((len(iv.intervals), 4), dtype=np.int32)
            i32 = (1 << 31) - 1   # open-ended intervals overflow the bin i32
            for i, (lo, hi) in enumerate(iv.intervals):
                blo, olo = time_to_binned_time(lo, self.period)
                bhi, ohi = time_to_binned_time(hi, self.period)
                w[i] = (max(-i32, int(blo)), int(olo),
                        min(i32, int(bhi)), int(ohi))
            windows = pad_windows(w)
        if (0 if windows is None else len(windows)) != self.n_windows:
            return None
        residual = _strip_handled(f, self.geom, self.dtg, True)
        dev_ir, host_ir = split_residual(
            residual, self.sft, self.vocabs, set(self.index.device.columns))
        if host_ir is not None:
            return None   # refine shapes go through the planner
        return boxes, _gate_of(ext.boxes, len(boxes)), windows, dev_ir


def _rebind(recipe: Recipe, boxes, gate, windows, dev_ir) -> Optional[Program]:
    """The count program of a bound query: recompile the device residual
    over the index's columns, fold the recipe's allowed visibility codes
    into it, and build the program from the values. None when the
    residual's structure key drifted from the recipe's, or the table is
    under four blocks (the fused program declines it)."""
    index = recipe.index
    if index.device.n < 4 * int(_prune.BLOCK_SIZE):
        return None
    try:
        residual = compile_residual(dev_ir, recipe.sft, recipe.vocabs,
                                    set(index.device.columns)) \
            if dev_ir is not None else None
        if recipe.vis is not None:
            residual = fold_vis(residual, recipe.vis)
        if (residual[0] if residual is not None else "none") \
                != recipe.res_key:
            return None   # structure drift: stay on the planner's path
        return Program.of_values(index, "count", boxes, gate, windows,
                                 residual)
    except Unsupported:
        return None


class FusedPrepared:
    """PreparedQuery-shaped handle from the recipe fast path: the query went
    filter → bound values → one fused program, never through
    ``planner.plan()``. ``plan`` exposes the recipe's template plan (its
    box/window VALUES belong to the recipe's exemplar query — audit and
    explain surfaces only)."""

    def __init__(self, planner, recipe: Recipe, f: ir.Filter, auths,
                 prog: Optional[Program]):
        self.planner = planner
        self.plan = recipe.template_plan
        self.filter = f
        self.auths = auths
        self._prog = prog        # None → provably empty

    @property
    def device_exact(self) -> bool:
        return self._prog is not None

    def count_async(self):
        """Dispatch → 0-d int32 device tensor (None for empty binds): the
        same contract as PreparedQuery.count_async. The fused program
        makes no host sync, so the call returns once its kernels are
        queued."""
        if self._prog is None:
            return None
        with _trace.span("device_scan", kind="device_scan"):
            return self._prog.run()[0]

    def count(self) -> int:
        from geomesa_tpu_torch.index.guards import Deadline
        attrs = {"type": self.planner.sft.name, "prepared": True}
        if _trace.enabled():
            attrs["filter"] = str(self.filter)
        with _trace.trace("count", **attrs):
            dl = Deadline(self.planner.timeout_ms)
            t0 = time.perf_counter()
            n = 0 if self._prog is None else int(_fetch(self._prog.run)[0])
            dl.check("scan")
            self.planner._write_audit(self.plan, self.filter, 0.0,
                                      (time.perf_counter() - t0) * 1000, n)
            return n

    def select_indices(self) -> np.ndarray:
        # selects replan through the general path (capacity tiers vary);
        # counts are the latency-critical shape the recipe accelerates
        return self.planner.select_indices(self.filter, auths=self.auths)


def fast_prepare(planner, f: ir.Filter, auths) -> Optional[FusedPrepared]:
    """Recipe-keyed prepare: when this (filter shape, auths) has fused
    before, bind the new VALUES straight into a fused count program — no
    plan, no range decomposition. None sends the caller down the ordinary
    prepare path (which registers the shape)."""
    if not config.FUSED_QUERY.get() or getattr(planner, "interceptors", None):
        return None
    try:
        skey = _shape_key(f)
    except Unsupported:
        return None
    cache = _recipes(planner)
    r = cache.get((skey, _auths_key(auths)))
    if r is _RecipeCache.MISS:
        STATS["shape_misses"] += 1
        return None
    if r is None:   # negative entry: shape known non-fusable
        return None
    bound = r.bind(f)
    if bound is _EMPTY_BIND:
        STATS["shape_hits"] += 1
        return FusedPrepared(planner, r, f, auths, None)
    if bound is None:
        STATS["bind_failures"] += 1
        return None
    prog = _rebind(r, *bound)
    if prog is None:
        STATS["bind_failures"] += 1
        return None
    STATS["shape_hits"] += 1
    STATS["queries"] += 1
    REGISTRY.inc("fused.shape_hits")
    REGISTRY.inc("fused.queries")
    return FusedPrepared(planner, r, f, auths, prog)


def note_shape(planner, plan, f: ir.Filter, auths,
               prog: Optional[Program]) -> None:
    """Slow-path epilogue: record how this shape resolved so the NEXT
    same-shape query takes the recipe fast path (or skips the attempt —
    negative entries stop re-qualifying known-staged shapes)."""
    if not config.FUSED_QUERY.get() or getattr(planner, "interceptors", None):
        return
    if getattr(plan, "empty", False):
        return   # emptiness is a property of the values, not the shape
    try:
        skey = _shape_key(f)
    except Unsupported:
        return
    cache = _recipes(planner)
    ck = (skey, _auths_key(auths))
    if cache.get(ck) is not _RecipeCache.MISS:
        return
    if prog is None:
        cache.put(ck, None)
        return
    res = plan.residual_device
    cache.put(ck, Recipe(plan, planner, prog.res_key,
                         None if res is None else res.vis))


# -- startup warming ----------------------------------------------------------


def warm_programs(index) -> int:
    """Make the fused count path ready for traffic on an index: build its
    per-block summaries and load the kernels the path launches, so the
    first cold query pays neither. Returns the kernels loaded (0 where the
    fused program declines the index, and on the CPU, which runs the plain
    versions)."""
    if not config.FUSED_QUERY.get():
        return 0
    cols = getattr(getattr(index, "device", None), "columns", None)
    if not cols or "xf" not in cols or not getattr(index, "points", False):
        return 0
    if index.device.n < 4 * int(_prune.BLOCK_SIZE):
        return 0
    block_summaries(index, int(_prune.BLOCK_SIZE))
    if index.device.device.type != "cuda":
        return 0
    from geomesa_tpu_torch.kernels import build
    for name in build.KERNELS:
        build.load(name)
    return len(build.KERNELS)


def stats_snapshot() -> Dict[str, int]:
    """STATS (debug/healthz surfaces). The port compiles no programs, so
    there is no live program count beside it."""
    return dict(STATS)
