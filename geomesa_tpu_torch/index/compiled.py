"""The fused query program: one plan → cover, scan, residual, refine and
aggregate on the device (≙ ``geomesa_tpu.index.compiled``).

For a point_boxes plan the program

1. gates the table's gather blocks against per-block f32 summaries of the
   coordinates and time bins (a slack-expanded superset: the exact masks
   re-apply to every gathered row);
2. takes the pruned branch — gather the alive blocks, with a membership
   mask for the clamped last block — when at most ``cap`` blocks are alive,
   else masks the full table (the reference's ``lax.cond(n_alive <= cap)``);
3. applies the exact fp62 box mask, the exact time windows and the lowered
   residual;
4. counts, or compacts row positions into a fixed-capacity result; in
   the refine modes classifies the masked candidate rows against the
   polygon with the ``pip_refine`` CUDA kernel (certain hit / uncertain);
   in the density mode scatters them onto a raster with the
   ``grid_scatter`` CUDA kernel. Both kernels read the candidates'
   coordinates through the gathered blocks' starts.

The uncertain sliver re-evaluates on the host in exact f64.

Modes: ``count``, ``select``, ``count_refine``, ``select_refine``,
``density``. The results are the reference program's, value for value: the
same packed int32 layout, capacities and fill, and for ``density`` the same
(H, W) f32 grid and int32 count.

The ``try_*`` entry points return None for every plan the reference's
``_from_plan`` declines (the fused switch off, no spatial box, a host
residual other than the polygon refine, a table under four blocks); the
planner then runs the staged path (``index/scan.py`` ``ScanKernels``).

Choosing the branch and compacting synchronize with the host once each
(``torch.nonzero`` and the alive count); the reference does neither. A
sync-free compaction is ROADMAP.md Queue 2, item 4.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from geomesa_tpu_torch import config
from geomesa_tpu_torch.features import geometry as geo
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.filter.evaluate import evaluate_at
from geomesa_tpu_torch.filter.geom_numpy import literal_segments
from geomesa_tpu_torch.index import prune as _prune
from geomesa_tpu_torch.index.api import IndexScanPlan
from geomesa_tpu_torch.index.scan import (EDGE_PAD, _compact, _time_mask,
                                          expand_blocks, point_boxes)
from geomesa_tpu_torch.kernels.density import grid_scatter
from geomesa_tpu_torch.kernels.pip import pip_refine

# block-gate slack in degrees: the per-block summaries are f32 reductions of
# the f32 coordinate planes and the gate envelopes are f32 roundings of f64
# query bounds — both within 2.5e-5 of exact, far inside 1e-3, so a
# gated-out block provably holds no match
_GATE_SLACK = np.float32(1e-3)

# select-capacity tiers (the reference's; hints quantize UP)
_SELECT_TIERS = (1 << 10, 1 << 13, 1 << 16, 1 << 19, 1 << 22)

_UNC_CAP = 4096  # refine-mode uncertain-row capacity (regrows past it)

_I32_MIN = -(1 << 31) + 1
_I32_MAX = (1 << 31) - 1


def _pow2(x: int) -> int:
    return max(1, 1 << max(0, int(x) - 1).bit_length())


def _tier(capacity: Optional[int]) -> int:
    if capacity is None:
        return 1 << 16
    for t in _SELECT_TIERS:
        if capacity <= t:
            return t
    return _pow2(capacity)


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


def refine_edges(plan: IndexScanPlan) -> Optional[np.ndarray]:
    """The padded f32 edge table (pow2 rows ≥ 4, ``EDGE_PAD`` filler) when
    the host residual is ``INTERSECTS(geom, POLYGON)`` on the index's point
    geometry — the reference's ``_refine_spec`` for its ``pip`` kind, the
    one refine kind of this slice; else None."""
    res = plan.residual_host
    if not (isinstance(res, ir.Intersects) and res.attr == plan.index.geom
            and res.geometry[0] == geo.POLYGON):
        return None
    edges = literal_segments(res.geometry).astype(np.float32)
    ep = np.tile(EDGE_PAD, (max(4, _pow2(len(edges))), 1))
    ep[: len(edges)] = edges
    return ep


def real_edges(edges: np.ndarray) -> int:
    """Rows of a ``refine_edges`` table before its ``EDGE_PAD`` filler."""
    n = len(edges)
    while n and np.array_equal(edges[n - 1], EDGE_PAD):
        n -= 1
    return n


class Program:
    """The fused program of one plan in one mode (≙ the reference's
    ``_jit_program``), with its constants on the table's device. ``run()``
    returns the reference program's result:

    - ``count``: int32 [count]
    - ``select``: int32 [count, positions × sel_cap]
    - ``count_refine``: int32 [certain, uncertain, uncertain positions ×
      unc_cap]
    - ``select_refine``: int32 [certain, uncertain, certain positions ×
      sel_cap, uncertain positions × unc_cap]
    - ``density``: ((height, width) f32 grid over ``grid`` = [xmin, ymin,
      xmax, ymax], 0-d int32 count of the masked rows)

    Positions index the table's sorted rows, ascending, padded with n.
    """

    def __init__(self, plan: IndexScanPlan, mode: str, sel_cap: int = 0,
                 unc_cap: int = 0, edges: Optional[np.ndarray] = None,
                 grid=None, width: int = 0, height: int = 0):
        index = plan.index
        self.index = index
        self.mode = mode
        self.sel_cap = sel_cap
        self.unc_cap = unc_cap
        dev = index.device.device
        self.n = index.device.n
        self.bsz = int(_prune.BLOCK_SIZE)
        nb = -(-self.n // self.bsz)
        self.cap = min(_pow2(max(4, int(np.ceil(
            nb * float(_prune.PRUNE_MAX_FRACTION))))), _pow2(nb))
        self.boxes = torch.from_numpy(plan.boxes_loose).to(dev)
        self.gate = torch.from_numpy(
            _gate_of(plan.explain["boxes"], len(plan.boxes_loose))).to(dev)
        self.windows = None if plan.windows is None \
            else torch.from_numpy(plan.windows).to(dev)
        self.res_fn = None
        self.res_params = []
        if plan.residual_device is not None:
            _, params, self.res_fn = plan.residual_device
            self.res_params = [torch.from_numpy(p).to(dev) for p in params]
        self.edges = None if edges is None else torch.from_numpy(edges).to(dev)
        self.n_edges = None if edges is None else real_edges(edges)
        # the raster's bbox rounds f64 → f32 as the reference stages it
        self.grid = None if grid is None else torch.from_numpy(
            np.asarray(grid, dtype=np.float32)).to(dev)
        self.width = width
        self.height = height

    def _mask(self, c) -> torch.Tensor:
        m = point_boxes(c, self.boxes)
        if self.windows is not None:
            m = m & _time_mask(c, self.windows)
        if self.res_fn is not None:
            m = m & self.res_fn(c, self.res_params)
        return m

    def _alive(self) -> torch.Tensor:
        summ = block_summaries(self.index, self.bsz)
        g = self.gate
        alive = ((summ["bxmax"][:, None] >= g[None, :, 0])
                 & (summ["bxmin"][:, None] <= g[None, :, 2])
                 & (summ["bymax"][:, None] >= g[None, :, 1])
                 & (summ["bymin"][:, None] <= g[None, :, 3])).any(dim=1)
        if self.windows is not None and "binmin" in summ:
            blo, bhi = self.windows[:, 0], self.windows[:, 2]
            alive = alive & ((blo <= bhi)[None, :]
                             & (summ["binmin"][:, None] <= bhi[None, :])
                             & (summ["binmax"][:, None] >= blo[None, :])).any(dim=1)
        return alive

    def _candidates(self):
        """(mask, rowids, starts) of the candidate rows: the pruned branch's
        gathered blocks when few enough are alive (candidate i is row
        ``starts[i // bsz] + i % bsz``), else the full table (rowids and
        starts None)."""
        cols = self.index.device.columns
        n, bsz = self.n, self.bsz
        if n >= 4 * bsz:
            alive = self._alive()
            # host sync: the branch choice of the reference's lax.cond
            if int(alive.sum()) <= self.cap:
                bids = torch.nonzero(alive).flatten()
                membership, rows, astart, g = expand_blocks(cols, bids, bsz, n)
                return self._mask(g) & membership, rows, astart
        # tiny tables (under 4 blocks) and overfull gates: the full mask
        return self._mask(cols), None, None

    def run(self):
        m, rowids, starts = self._candidates()
        n = self.n
        cols = self.index.device.columns
        if self.mode == "density":
            return grid_scatter(cols["xf"], cols["yf"], m, None, starts,
                                self.bsz, self.grid, self.width, self.height)
        count = m.sum(dtype=torch.int32).reshape(1)
        if self.mode == "count":
            return count
        if self.mode == "select":
            return torch.cat([count, _compact(m, rowids, self.sel_cap, n)])
        if self.mode not in ("count_refine", "select_refine"):
            raise ValueError(self.mode)
        hit, unc = pip_refine(cols["xf"], cols["yf"], self.edges, mask=m,
                              starts=starts, bsz=self.bsz,
                              n_edges=self.n_edges)
        parts = [hit.sum(dtype=torch.int32).reshape(1),
                 unc.sum(dtype=torch.int32).reshape(1)]
        if self.mode == "select_refine":
            parts.append(_compact(hit, rowids, self.sel_cap, n))
        parts.append(_compact(unc, rowids, self.unc_cap, n))
        return torch.cat(parts)


# -- qualification and execution ----------------------------------------------

_REFINE_MODES = ("count_refine", "select_refine")


def _from_plan(plan: IndexScanPlan, mode: str, capacity: Optional[int] = None,
               unc_cap: int = 0, grid=None, width: int = 0,
               height: int = 0) -> Optional[Program]:
    """The fused program of a plan in one mode, or None when the fused
    program does not take the plan and the staged path answers it (≙ the
    reference's ``_from_plan``/``_build`` declines)."""
    if not config.FUSED_QUERY.get():
        return None
    if plan.empty or plan.index is None \
            or plan.primary_kind != "point_boxes" or plan.boxes_loose is None:
        return None
    boxes_geo = plan.explain.get("boxes")
    if not boxes_geo or len(boxes_geo) > len(plan.boxes_loose):
        return None
    edges = None
    if mode in _REFINE_MODES:
        edges = refine_edges(plan)
        if edges is None:
            return None
    elif plan.residual_host is not None:
        return None
    n = plan.index.device.n
    if n < 4 * int(_prune.BLOCK_SIZE):
        return None  # tiny tables: the staged full mask is already one pass
    sel_cap = min(_tier(capacity), _pow2(n)) \
        if mode in ("select", "select_refine") else 0
    return Program(plan, mode, sel_cap=sel_cap, unc_cap=unc_cap, edges=edges,
                   grid=grid, width=width, height=height)


def try_count(planner, plan: IndexScanPlan) -> Optional[int]:
    """One-program count of a device-exact plan, or None."""
    prog = _from_plan(plan, "count")
    return None if prog is None else int(prog.run()[0])


def try_select(planner, plan: IndexScanPlan,
               capacity: Optional[int]) -> Optional[np.ndarray]:
    """One-program select → index POSITIONS (the caller maps and sorts), or
    None. Overflow regrows the capacity tier and re-runs."""
    while True:
        prog = _from_plan(plan, "select", capacity=capacity)
        if prog is None:
            return None
        out = prog.run().cpu().numpy()
        cnt = int(out[0])
        if cnt <= prog.sel_cap:
            return out[1: 1 + cnt].astype(np.int64)
        capacity = _pow2(cnt)


def try_count_refine(planner, plan: IndexScanPlan) -> Optional[int]:
    """Fused scan + polygon refine + count: certain hits plus the host f64
    verdict on the uncertain sliver, or None. An uncertainty overflow
    regrows the capacity and re-runs (the reference hands it to the staged
    path instead; the results are the same)."""
    unc_cap = _UNC_CAP
    while True:
        prog = _from_plan(plan, "count_refine", unc_cap=unc_cap)
        if prog is None:
            return None
        out = prog.run().cpu().numpy()
        certain, n_unc = int(out[0]), int(out[1])
        if n_unc <= unc_cap:
            break
        unc_cap = _pow2(n_unc)
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
            return None
        out = prog.run().cpu().numpy()
        n_in, n_unc = int(out[0]), int(out[1])
        if n_in > prog.sel_cap:
            capacity = _pow2(n_in)
        elif n_unc > unc_cap:
            unc_cap = _pow2(n_unc)
        else:
            break
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
        return None
    grid, cnt = prog.run()
    return grid.cpu().numpy(), int(cnt)
