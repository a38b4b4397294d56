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
4. counts, or compacts row positions into a fixed-capacity result, and in
   the refine modes classifies the masked candidate rows against the
   polygon with the ``pip_refine`` CUDA kernel (certain hit / uncertain),
   which reads their coordinates through the gathered blocks' starts.

The uncertain sliver re-evaluates on the host in exact f64.

Modes: ``count``, ``select``, ``count_refine``, ``select_refine``. The
results are the reference program's, value for value: the same packed int32
layout, capacities and fill.

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
from geomesa_tpu_torch.index.api import IndexScanPlan, not_ported
from geomesa_tpu_torch.index.scan import EDGE_PAD, _time_mask, point_boxes
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


class _Gather:
    """Dict-like view of the candidate rows of each column, read on first
    access, so a pruned scan touches only the columns its mask needs
    (≙ the reference's ``_LazyBlockGather``)."""

    def __init__(self, cols, rows: torch.Tensor):
        self._cols = cols
        self._rows = rows
        self._cache = {}

    def __getitem__(self, k: str) -> torch.Tensor:
        if k not in self._cache:
            self._cache[k] = self._cols[k].index_select(0, self._rows)
        return self._cache[k]

    def __contains__(self, k: str) -> bool:
        return k in self._cols

    def values(self):
        # row-count probes (Include/Exclude) only need a length and device
        yield self._rows


def _compact(mask: torch.Tensor, rowids: Optional[torch.Tensor], cap: int,
             fill: int) -> torch.Tensor:
    """Ascending positions of ``mask`` (mapped through ``rowids`` when the
    rows were gathered) in a ``cap``-long int32 vector padded with ``fill``
    (≙ ``jnp.nonzero(size=cap, fill_value=...)``)."""
    pos = torch.nonzero(mask).flatten()[:cap]
    if rowids is not None:
        pos = rowids.index_select(0, pos)
    out = torch.full((cap,), fill, dtype=torch.int32, device=mask.device)
    out[: pos.shape[0]] = pos.to(torch.int32)
    return out


class Program:
    """The fused program of one plan in one mode (≙ the reference's
    ``_jit_program``), with its constants on the table's device. ``run()``
    returns the reference program's int32 result:

    - ``count``: [count]
    - ``select``: [count, positions × sel_cap]
    - ``count_refine``: [certain, uncertain, uncertain positions × unc_cap]
    - ``select_refine``: [certain, uncertain, certain positions × sel_cap,
      uncertain positions × unc_cap]

    Positions index the table's sorted rows, ascending, padded with n.
    """

    def __init__(self, plan: IndexScanPlan, mode: str, sel_cap: int = 0,
                 unc_cap: int = 0, edges: Optional[np.ndarray] = None):
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
                starts = bids * bsz
                # clamped starts re-read a suffix of the previous block; the
                # membership test masks the re-reads (no double counts)
                astart = starts.clamp(0, n - bsz)
                rows = astart[:, None] + torch.arange(
                    bsz, device=bids.device)[None, :]
                membership = ((rows >= starts[:, None])
                              & (rows < starts[:, None] + bsz)).reshape(-1)
                rows = rows.reshape(-1)
                g = _Gather(cols, rows)
                return self._mask(g) & membership, rows, astart
        # tiny tables (under 4 blocks) and overfull gates: the full mask
        return self._mask(cols), None, None

    def run(self) -> torch.Tensor:
        m, rowids, starts = self._candidates()
        n = self.n
        count = m.sum(dtype=torch.int32).reshape(1)
        if self.mode == "count":
            return count
        if self.mode == "select":
            return torch.cat([count, _compact(m, rowids, self.sel_cap, n)])
        if self.mode not in ("count_refine", "select_refine"):
            raise ValueError(self.mode)
        cols = self.index.device.columns
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


def _qualify(plan: IndexScanPlan) -> Optional[np.ndarray]:
    """Raise for every plan shape the fused program does not take; return
    the refine edge table (None when the plan is device-exact)."""
    if not config.FUSED_QUERY.get():
        raise not_ported("execution with GEOMESA_TPU_FUSED_QUERY off (the "
                         "staged ScanKernels path)", 6)
    if plan.primary_kind != "point_boxes" or plan.boxes_loose is None:
        raise not_ported("plans without a spatial box (the staged "
                         "ScanKernels path)", 6)
    boxes_geo = plan.explain.get("boxes")
    if not boxes_geo or len(boxes_geo) > len(plan.boxes_loose):
        raise not_ported("this spatial extraction", 6)
    if plan.residual_host is None:
        return None
    edges = refine_edges(plan)
    if edges is None:
        raise not_ported(
            f"the host residual {type(plan.residual_host).__name__} (dist "
            "refine, st_* calls and other host predicates)", 5)
    return edges


def count(planner, plan: IndexScanPlan) -> int:
    """Count of a non-empty plan: device-exact in one program, or certain
    hits plus the host f64 verdict on the uncertain sliver."""
    edges = _qualify(plan)
    if edges is None:
        return int(Program(plan, "count").run()[0])
    unc_cap = _UNC_CAP
    while True:
        out = Program(plan, "count_refine", unc_cap=unc_cap,
                      edges=edges).run().cpu().numpy()
        certain, n_unc = int(out[0]), int(out[1])
        if n_unc <= unc_cap:
            break
        unc_cap = _pow2(n_unc)   # uncertainty overflow: regrow, re-run
    if n_unc == 0:
        return certain
    rows = plan.index.map_rows(out[2: 2 + n_unc].astype(np.int64))
    return certain + int(np.sum(
        evaluate_at(plan.residual_host, planner.table, rows)))


def select(planner, plan: IndexScanPlan,
           capacity: Optional[int] = None) -> np.ndarray:
    """Ascending table rows of a non-empty plan. Overflow of the select or
    uncertain capacity regrows it and re-runs the program."""
    edges = _qualify(plan)
    sel_cap = min(_tier(capacity), _pow2(plan.index.device.n))
    unc_cap = _UNC_CAP if edges is not None else 0
    while True:
        if edges is None:
            out = Program(plan, "select", sel_cap=sel_cap).run().cpu().numpy()
            n_in, n_unc, head = int(out[0]), 0, 1
        else:
            out = Program(plan, "select_refine", sel_cap=sel_cap,
                          unc_cap=unc_cap, edges=edges).run().cpu().numpy()
            n_in, n_unc, head = int(out[0]), int(out[1]), 2
        if n_in > sel_cap:
            sel_cap = _pow2(n_in)
        elif n_unc > unc_cap:
            unc_cap = _pow2(n_unc)
        else:
            break
    rows = plan.index.map_rows(out[head: head + n_in].astype(np.int64))
    if n_unc:
        unc_rows = plan.index.map_rows(
            out[head + sel_cap: head + sel_cap + n_unc].astype(np.int64))
        keep = evaluate_at(plan.residual_host, planner.table, unc_rows)
        rows = np.concatenate([rows, unc_rows[keep]])
    return np.sort(rows)
