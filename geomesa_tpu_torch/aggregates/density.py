"""Density (heat-map) aggregation (≙ ``geomesa_tpu.aggregates.density``).

≙ the reference's ``DensityScan`` (index/iterators/DensityScan.scala:29):
snap each matching feature onto a width×height grid over the render bbox,
accumulating optional per-feature weights. On the card the snap and the
accumulate are the ``grid_scatter`` CUDA kernel (``kernels/density.py``),
behind the staged scan's mask or the fused program's candidates.

Grid snap semantics mirror GridSnap.scala:23: i = floor((x - xmin)/sizeX * W),
clamped to the grid, features outside the bbox excluded.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from geomesa_tpu_torch import config
from geomesa_tpu_torch.aggregates import grid_codec
from geomesa_tpu_torch.index import compiled as _fused
from geomesa_tpu_torch.index import prune as _prune
from geomesa_tpu_torch.index.api import UnionScanPlan


@dataclass
class DensityGrid:
    bbox: tuple            # (xmin, ymin, xmax, ymax)
    width: int
    height: int
    weights: np.ndarray    # (height, width) float32

    def to_points(self):
        """Non-zero cells as (x_center, y_center, weight) — the decode side
        (DensityScan.decodeResult)."""
        xmin, ymin, xmax, ymax = self.bbox
        iy, ix = np.nonzero(self.weights)
        dx = (xmax - xmin) / self.width
        dy = (ymax - ymin) / self.height
        return (xmin + (ix + 0.5) * dx, ymin + (iy + 0.5) * dy, self.weights[iy, ix])


def density_kernel(mask: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   grid: torch.Tensor, width: int, height: int,
                   weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked scatter-add of full-table planes: the (H, W) grid of weights,
    grid = [xmin, ymin, xmax, ymax] f32 (the ``grid_scatter`` kernel on the
    card, its plain version on the CPU)."""
    from geomesa_tpu_torch.kernels.density import grid_scatter
    return grid_scatter(x, y, mask, weight, None, None, grid, width,
                        height)[0]


_COMPACT_TIERS = (1 << 17, 1 << 20, 1 << 23)

_WEIGHT_TYPES = ("Int", "Integer", "Long", "Float", "Double")


def prepare_density(planner, f, bbox, width: int = 256, height: int = 256,
                    weight_attr: Optional[str] = None, auths=None):
    """Plan once, stage constants, return a zero-arg callable producing a
    DensityGrid per call (≙ a configured DensityScan handed to the servers).

    Device path (plan fully device-exact), the reference's default route:
    the range-pruned block scatter when the planner has a cover, else the
    full-table mask scatter (``density_compact``, sized by a count). The
    grid comes back through the device-side encoding ladder
    (``grid_codec``), stepping down to a wider encoding when a decode says
    the narrow one cannot carry the result. The returned callable carries
    ``.dispatch()`` — the (H, W) device grid without readback — and
    ``.packed()`` — the (mode, cap) of the encoding in use. Plans that are
    not device-exact, whose weight is not a device column, or over an
    extent layer (lines and polygons: no point planes; their selects run
    ``fused_scan``'s ENV form, then the envelope centres snap on the host,
    as the reference renders them) go through the
    host (``_host_density``). An OR plan (``UnionScanPlan``) renders unit
    weights in one union program (``compiled.try_union_density``) when
    every branch is device-exact on one index, else through the host."""
    # auths fold into the device scan as the allowed visibility codes (≙
    # the reference's density under auths, VisibilityFilter on the scan)
    plan = planner._apply_auths(planner.plan(f), auths)
    shape = (height, width)

    def run_empty():
        return DensityGrid(tuple(bbox), width, height,
                           np.zeros(shape, np.float32))

    if plan.empty:
        return run_empty

    if isinstance(plan, UnionScanPlan) and weight_attr is None:
        def run_union():
            out = _fused.try_union_density(planner, plan, auths, bbox, width,
                                           height)
            if out is None:
                return _host_density(planner, f, plan, bbox, width, height,
                                     weight_attr, auths)
            return DensityGrid(tuple(bbox), width, height, out[0])
        return run_union

    idx = plan.index
    weight_on_device = weight_attr is None or (
        idx is not None and weight_attr in idx.device.columns
        and planner.sft.attribute(weight_attr).type_name in _WEIGHT_TYPES)
    if plan.device_exact and "xf" in idx.device.columns and weight_on_device:
        blocks = planner._pruned_blocks(plan)
        if blocks is not None and len(blocks) == 0:
            return run_empty  # provably-empty cover

        state: dict = {}

        def _stage_compact(cnt):
            cap = next((t for t in _COMPACT_TIERS if cnt <= t),
                       1 << max(0, (max(cnt, 1) - 1)).bit_length())
            state["disp"] = idx.kernels.prepare_density_compact(
                plan.primary_kind, plan.boxes_loose, plan.windows,
                plan.residual_device, bbox, width, height, cap, weight_attr)
            state["cap"] = cap

        def _stage_pack(bound):
            """The readback encoding ladder (u8/sparse/fp16 → raw), sized
            from a bound on the matched rows: nonzero cells can't exceed it.
            Encodings that can't carry a result get popped at decode time."""
            state["ladder"] = grid_codec.choose(
                bound, height, width, config.DENSITY_PACK.get(),
                unit_weights=weight_attr is None)
            state["pack"] = _next_pack()

        def _next_pack():
            if state["ladder"]:
                pmode, pcap = state["ladder"].pop(0)
                return pmode, pcap, grid_codec.pack_fn(pmode, pcap)
            return None

        if blocks is not None:
            state["disp"] = idx.kernels.prepare_density_blocks(
                plan.primary_kind, plan.boxes_loose, plan.windows,
                plan.residual_device, bbox, width, height, blocks,
                _prune.BLOCK_SIZE, weight_attr)
            state["cap"] = None  # gather scan — no compaction to overflow
            _stage_pack(len(blocks) * _prune.BLOCK_SIZE)
        else:
            cnt = planner._count(plan, f, auths)
            _stage_compact(cnt)
            _stage_pack(cnt)

        def dispatch():
            return state["disp"]()[0]

        def run():
            for _ in range(6):
                g, c = state["disp"]()
                pack = state["pack"]
                dec = None
                if pack is not None:
                    pmode, pcap, fn = pack
                    dec = grid_codec.decode(grid_codec.words(fn(g, c)), pmode,
                                            pcap, height, width)
                    if dec is None:
                        # cap overflow / saturation / rounding drift: this
                        # encoding can't carry the result — step down the
                        # ladder (ultimately to raw f32)
                        state["pack"] = _next_pack()
                if dec is None:
                    weights, got = g.cpu().numpy(), int(c)
                else:
                    weights, got, _mass = dec
                if state["cap"] is not None and got > state["cap"]:
                    # the match count outgrew the staged capacity (the
                    # reference's compaction would have dropped rows):
                    # restage with a bigger cap
                    _stage_compact(got)
                    if state["pack"] is not None:
                        _stage_pack(got)
                    continue
                return DensityGrid(tuple(bbox), width, height, weights)
            raise RuntimeError("density capacity kept overflowing")
        run.dispatch = dispatch
        run.packed = lambda: state["pack"] and state["pack"][:2]
        return run

    def run_host():
        return _host_density(planner, f, plan, bbox, width, height,
                             weight_attr, auths)
    return run_host


def density(planner, f, bbox, width: int = 256, height: int = 256,
            weight_attr: Optional[str] = None, auths=None) -> DensityGrid:
    """One-shot density query (plan + execute). Repeated renders should hold
    onto ``prepare_density`` instead — it skips re-planning and re-staging."""
    return prepare_density(planner, f, bbox, width, height, weight_attr,
                           auths)()


def host_grid(table, rows: np.ndarray, bbox, width: int, height: int,
              weight_attr: Optional[str] = None) -> np.ndarray:
    """Snap+accumulate selected table rows onto an (H, W) grid on the host
    in f64 (the LocalQueryRunner density transform; also the LSM delta
    tier's contribution): each feature at its envelope's centre — a point
    is its own — as the reference's ``host_grid``. Its snap is not the
    device's: the device snaps the f32 coordinate planes in f32."""
    bbs = table.geometry().bboxes()[rows]
    x = (bbs[:, 0] + bbs[:, 2]) / 2
    y = (bbs[:, 1] + bbs[:, 3]) / 2
    w = np.asarray(table.column(weight_attr), dtype=np.float64)[rows] \
        if weight_attr else None
    xmin, ymin, xmax, ymax = bbox
    fx = (x - xmin) / (xmax - xmin)
    fy = (y - ymin) / (ymax - ymin)
    inb = (fx >= 0) & (fx < 1) & (fy >= 0) & (fy < 1)
    ix = np.clip((fx[inb] * width).astype(np.int64), 0, width - 1)
    iy = np.clip((fy[inb] * height).astype(np.int64), 0, height - 1)
    weights = np.zeros((height, width), dtype=np.float32)
    np.add.at(weights, (iy, ix), w[inb] if w is not None else 1.0)
    return weights


def _host_density(planner, f, plan, bbox, width, height,
                  weight_attr, auths=None) -> DensityGrid:
    """Host route (≙ LocalQueryRunner's density transform): the selected
    rows snapped on the host."""
    rows = planner.select_indices(f, plan=plan, auths=auths)
    return DensityGrid(tuple(bbox), width, height,
                       host_grid(planner.table, rows, bbox, width, height,
                                 weight_attr))
