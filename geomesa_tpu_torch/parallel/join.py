"""Spatial join: point-in-polygon on one device (≙ ``geomesa_tpu.parallel.join``).

≙ the reference's Spark spatial join surface — st_contains/st_intersects UDFs
(spark-jts SpatialRelationFunctions.scala:20-60) executed via spatially
partitioned sweepline joins (GeoMesaJoinRelation.scala:41-56). Here:

  - the small side (polygons) packs once into padded edge tables
    (``PackedPolygons``, byte for byte the reference's) and one (P, E, 4)
    f32 table of recentred edges on the join's device
  - the points stay where the caller keeps them (a CUDA tensor runs the
    ``pip_join`` kernel, a CPU tensor its plain version below)
  - per polygon: the bbox test in the original frame, the crossing parity
    in the recentred frame, the mask; summed to (P,) counts, or the first
    matching polygon per point

Arithmetic: the reference's ``_pip_block`` as XLA compiles it on the CPU —
subnormal inputs and results flushed to zeros of their sign, the IEEE
division, and ``x1 + t * (x2 - x1)`` contracted into one fused multiply-add
``fma(t, x2 - x1, x1)`` (the product has no other use; a point within an ulp
of the crossing shows it, ``tests/test_torch_join.py``). Recentred
differences of f32 coordinates are subnormal only where both operands lie
within 2^-125 of zero, and a quotient t only for such numerators; both are
flushed as XLA flushes them.

The reference shards the points over a mesh (``sharded=``): that comes with
multi-GPU (ROADMAP.md Queue 1, item 14) and raises here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from geomesa_tpu_torch.arith import div, flush, fma, sub
from geomesa_tpu_torch.filter import geom_numpy as gn
from geomesa_tpu_torch.index.api import not_ported
from geomesa_tpu_torch.index.device import resolve
from geomesa_tpu_torch.kernels import pip_join as _kpip

# (point, edge) pairs per chunk of the plain parity: bounds its temporaries
_PAIR_CHUNK = 1 << 24


@dataclass
class PackedPolygons:
    """Broadcast-ready polygon buffers (the reference's, byte for byte)."""

    edges_a: np.ndarray    # (P, E, 2) f32 edge start vertices (recentered)
    edges_b: np.ndarray    # (P, E, 2) f32 edge end vertices
    valid: np.ndarray      # (P, E) bool real-edge mask
    bboxes: np.ndarray     # (P, 4) f32 [xmin, ymin, xmax, ymax] (original frame)
    center: np.ndarray     # (2,) f64 recentering offset
    n: int

    @classmethod
    def pack(cls, polygons: List[tuple]) -> "PackedPolygons":
        """polygons: list of (type_code, nested) Polygon/MultiPolygon literals."""
        all_edges = []
        bboxes = []
        for lit in polygons:
            rings = gn.polygon_rings(lit)
            e = np.concatenate([
                np.concatenate([r[:-1], r[1:]], axis=1) for r in rings])
            all_edges.append(e)
            bboxes.append(gn.literal_bbox(lit))
        emax = max(len(e) for e in all_edges)
        p = len(polygons)
        ea = np.zeros((p, emax, 2), dtype=np.float64)
        eb = np.zeros((p, emax, 2), dtype=np.float64)
        valid = np.zeros((p, emax), dtype=bool)
        for i, e in enumerate(all_edges):
            ea[i, : len(e)] = e[:, 0:2]
            eb[i, : len(e)] = e[:, 2:4]
            valid[i, : len(e)] = True
        bboxes = np.asarray(bboxes, dtype=np.float32)
        center = np.array([bboxes[:, [0, 2]].mean(), bboxes[:, [1, 3]].mean()], dtype=np.float64)
        ea -= center
        eb -= center
        return cls(ea.astype(np.float32), eb.astype(np.float32), valid,
                   bboxes, center, p)

    def tables(self, device) -> tuple:
        """The kernel's inputs on ``device``: ((P, E, 4) f32 edges [x1, y1,
        x2, y2] in the recentred frame, (P,) int32 real edges (``valid`` is
        a prefix of each row), (P, 4) f32 bboxes, (2,) f32 center — as the
        reference hands ``center`` to its program)."""
        edges = np.concatenate([self.edges_a, self.edges_b], axis=2)
        counts = self.valid.sum(axis=1).astype(np.int32)
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in (edges, counts, self.bboxes,
                               self.center.astype(np.float32)))


# -- the plain versions: XLA's f32 arithmetic on the CPU ------------------------


def _pip_block(pxc: torch.Tensor, pyc: torch.Tensor,
               edges: torch.Tensor) -> torch.Tensor:
    """(n,) bool crossing parity of flushed recentred points against one
    polygon's real edges (E, 4) (≙ the reference's ``_pip_block``). The
    division and the fused multiply-add run only for the (point, edge)
    pairs whose edge straddles the point's y (elsewhere the reference masks
    them out); points run in chunks so the temporaries stay bounded."""
    n, ne = pxc.shape[0], edges.shape[0]
    out = torch.zeros(n, dtype=torch.bool, device=pxc.device)
    if n == 0 or ne == 0:
        return out
    y1, y2 = edges[None, :, 1], edges[None, :, 3]
    step = max(1, _PAIR_CHUNK // ne)
    for a in range(0, n, step):
        b = min(n, a + step)
        py = pyc[a:b, None]
        i, e = ((y1 > py) != (y2 > py)).nonzero(as_tuple=True)
        x1, ey1, x2, ey2 = edges[e].unbind(-1)
        den = torch.where(ey2 == ey1, torch.ones_like(ey1), sub(ey2, ey1))
        t = div(sub(pyc[a + i], ey1), den)
        cross = pxc[a + i] < fma(t, sub(x2, x1), x1)
        count = torch.bincount(i[cross], minlength=b - a)
        out[a:b] = (count % 2) == 1
    return out


def _polygon_hits(px, py, pxc, pyc, live, edges, n_edges, bboxes,
                  p: int) -> torch.Tensor:
    """Positions of the live points in polygon p's bbox (original frame)
    whose parity (recentred frame) is odd."""
    bb = bboxes[p]
    inb = live & (px >= bb[0]) & (px <= bb[2]) & (py >= bb[1]) & (py <= bb[3])
    idx = inb.nonzero().squeeze(1)
    par = _pip_block(pxc[idx], pyc[idx], edges[p, : int(n_edges[p])])
    return idx[par]


def _flushed(px, py, mask, edges, bboxes, center):
    px, py, edges, bboxes, center = (flush(t) for t in (px, py, edges,
                                                         bboxes, center))
    live = torch.ones_like(px, dtype=torch.bool) if mask is None else mask
    return px, py, sub(px, center[0]), sub(py, center[1]), live, edges, \
        bboxes


def contains_matrix(px, py, mask, edges, n_edges, bboxes,
                    center) -> torch.Tensor:
    """(P,) int32 per-polygon hit counts of the masked points (≙ the
    reference's ``contains_matrix_kernel``). The plain PyTorch version of
    the ``pip_join`` kernel's COUNTS mode: the CPU path, and the kernel's
    yardstick on the card."""
    px, py, pxc, pyc, live, edges, bboxes = _flushed(px, py, mask, edges,
                                                     bboxes, center)
    out = torch.zeros(edges.shape[0], dtype=torch.int32, device=px.device)
    for p in range(edges.shape[0]):
        out[p] = _polygon_hits(px, py, pxc, pyc, live, edges, n_edges,
                               bboxes, p).numel()
    return out


def assign(px, py, mask, edges, n_edges, bboxes, center) -> torch.Tensor:
    """(N,) int32 first matching polygon per point, -1 for none (≙ the
    reference's ``assign_kernel``: ``argmax`` over the polygon axis of the
    hit matrix). The plain PyTorch version of the ``pip_join`` kernel's
    ASSIGN mode: polygons in order, each over the points still unassigned."""
    px, py, pxc, pyc, live, edges, bboxes = _flushed(px, py, mask, edges,
                                                     bboxes, center)
    out = torch.full(px.shape, -1, dtype=torch.int32, device=px.device)
    live = live.clone()
    for p in range(edges.shape[0]):
        hit = _polygon_hits(px, py, pxc, pyc, live, edges, n_edges, bboxes, p)
        out[hit] = p
        live[hit] = False
    return out


class SpatialJoin:
    """Point-in-polygon join between a point column and a polygon
    collection, on one device: the points' (CUDA tensors: the ``pip_join``
    kernel; CPU tensors: its plain version). Host arrays go to ``device``
    (the card unless the caller names another)."""

    def __init__(self, polygons: List[tuple], device=None):
        self.packed = PackedPolygons.pack(polygons)
        self.device = device
        self._tables = {}

    def _bufs(self, dev: torch.device) -> tuple:
        t = self._tables.get(dev)
        if t is None:
            t = self._tables[dev] = self.packed.tables(dev)
        return t

    def _inputs(self, px, py, mask, sharded):
        if sharded is not None:
            raise not_ported("SpatialJoin over a sharded table", 14)
        dev = px.device if isinstance(px, torch.Tensor) \
            else resolve(self.device)
        # host arrays compute in f32, as the reference's jit casts them
        px, py = (v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v, dtype=np.float32), device=dev) for v in (px, py))
        if mask is not None:
            mask = torch.as_tensor(mask, device=dev)
        return px, py, mask, self._bufs(dev)

    def counts(self, px, py, mask=None, sharded=None) -> torch.Tensor:
        """(P,) int32 per-polygon containment counts, on the points'
        device."""
        px, py, mask, bufs = self._inputs(px, py, mask, sharded)
        return _kpip.pip_join(px, py, mask, *bufs, assign=False)

    def assign(self, px, py, mask=None, sharded=None) -> torch.Tensor:
        """(N,) int32 per-point polygon assignment (-1 = no polygon) — the
        join's row-level output (st_contains join column)."""
        px, py, mask, bufs = self._inputs(px, py, mask, sharded)
        return _kpip.pip_join(px, py, mask, *bufs, assign=True)
