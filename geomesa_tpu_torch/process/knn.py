"""K-nearest-neighbor search.

Copied from ``geomesa_tpu.process.knn`` with its imports pointed at this
package: the device work is ``ScanKernels.topk_nearest`` /
``topk_nearest_blocks`` (the ``topk_nearest`` CUDA kernel behind the
``fused_scan`` mask), the radius fallback's counts ``counts_multi`` (the
``box_count`` kernel). A plan with attribute slices (``candidate_slices``)
leaves the pruned and pipelined routes, as in the reference. What follows
is the reference's own account.

≙ reference `KNearestNeighborSearchProcess` (geomesa-process/.../query/
KNearestNeighborSearchProcess.scala): the reference iterates expanding-radius
index queries because a storage scan prices by key range. A TPU prices by
full-array reductions, so the whole search is ONE fused kernel: mask (the
optional filter) → haversine distance → `lax.top_k` → a k-sized readback.
No radius schedule, no candidate pull, no guarantee re-query.

Exactness: device distances are f32, so the kernel returns a top-`m` margin
(m >= 2k) and the host re-ranks those m candidates in f64 — rank noise from
f32 rounding (~1e-7 relative) cannot push a true top-k member out of a 2k
margin unless distances tie at that precision, in which case either ordering
is a correct KNN result.

The expanding-radius path survives as the fallback for plans the device
kernel can't serve (extent layers without point coords, host residuals,
k beyond the kernel tier cap).

Under a sharded cluster this module answers the LOCAL shard only;
cluster/exec.py's ClusterScan.knn wraps it in the bounded radius
exchange (each shard proves an upper bound from its local kth distance,
then ships only candidates inside the agreed radius) and falls back to
these single-process paths verbatim when the runtime is inactive.
"""

from __future__ import annotations

import math
import weakref
from typing import Optional, Union

import numpy as np

from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.filter.parser import parse_ecql
from geomesa_tpu_torch.metrics import REGISTRY as _metrics
from geomesa_tpu_torch.process.geo import expand_bbox, haversine_m

_WORLD = (-180.0, -90.0, 180.0, 90.0)
_MAX_DEVICE_K = 2048

# per-planner KNN state: the radius that last satisfied the candidate
# target (keyed by target, so k=10 and k=500 seed independently) and the
# last padded block tier. Each extra radius round is a full host
# plan+cover pass (the measured cfg4 cost at 100M — see the perf watch
# report perf/reports/cfg4_knn_regression.json), and a tier flip between
# adjacent powers of two is a fresh XLA compile (kernels.recompiles), so
# both memos directly buy back blocking latency. Weak: a dropped planner
# frees its state.
_MEMO: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _memo_for(planner) -> dict:
    m = _MEMO.get(planner)
    if m is None:
        m = {"radii": {}, "tier": 0}
        _MEMO[planner] = m
    return m


def _stable_tier_blocks(memo: dict, blocks: np.ndarray) -> np.ndarray:
    """Pad candidate blocks to a hysteresis-stable power-of-two tier: a
    query whose cover straddles a pow2 boundary reuses the NEIGHBORING
    query's (compiled) tier instead of flip-flopping between two jit
    signatures — the recompile churn the kernels.recompiles counter made
    visible. Padded ids are -1 (masked out by the kernel)."""
    nb = max(8, 1 << max(0, len(blocks) - 1).bit_length())
    tier = memo.get("tier", 0)
    if tier and nb < tier <= 2 * nb:
        nb = tier  # round UP to the remembered tier (<= 2x the work)
    memo["tier"] = nb
    out = np.full(nb, -1, dtype=np.int32)
    out[: len(blocks)] = blocks
    return out


def knn(planner, x: float, y: float, k: int,
        f: Union[str, ir.Filter, None] = None,
        initial_radius_m: float = 1000.0, max_doublings: int = 20):
    """(row indices, distances in meters) of the k features nearest (x, y),
    optionally restricted by a filter."""
    if isinstance(f, str):
        f = parse_ecql(f)
    geom = planner.sft.geometry_attribute
    if geom is None:
        raise ValueError("KNN requires a geometry attribute")
    if k <= 0:
        return np.empty(0, dtype=np.int64), np.empty(0)

    plan = planner.plan(f if f is not None else ir.Include())
    device_ok = (plan.device_exact and "xf" in plan.index.device.columns
                 and k <= _MAX_DEVICE_K)
    if device_ok:
        return _device_knn(planner, plan, x, y, k, f=f,
                           initial_radius_m=initial_radius_m)
    if plan.empty:
        return np.empty(0, dtype=np.int64), np.empty(0)
    return _radius_knn(planner, x, y, k, f, initial_radius_m, max_doublings)


def _device_knn(planner, plan, x: float, y: float, k: int,
                f=None, initial_radius_m: float = 1000.0):
    """Device KNN with a host-driven radius bound.

    The search radius grows HOST-SIDE: the range cover's candidate-row count
    (pure host binary searches over the sorted keys — zero device traffic)
    tells us when a bbox plausibly holds >= k matches. One device dispatch
    then runs distance + top_k over just the candidate blocks (lax.top_k is
    a full sort on TPU, so operand size is everything: candidate blocks make
    KNN cost flat in table size). The classic inscribed-circle guarantee
    re-runs wider when the k-th distance exceeds the radius — so results are
    exactly the global k nearest."""
    m = max(16, 1 << (max(2 * k, k + 16) - 1).bit_length())
    geom = planner.sft.geometry_attribute
    index = plan.index

    def with_bbox(radius_m):
        bbox = ir.BBox(geom.name, *expand_bbox(x, y, radius_m))
        return bbox if f is None or isinstance(f, ir.Include) \
            else ir.and_filters([f, bbox])

    memo = _memo_for(planner)
    target = max(32 * k, 2048)
    fkey = ("full", target)
    uses = memo.get(fkey)
    if uses is not None and uses < 16:
        # last probe ended at the full-table kernel (cover declined before
        # the candidate target — the small-table / wide-data regime):
        # skip the radius walk entirely. Re-probe every 16th query so a
        # grown table regains the pruned path; a stale choice is still
        # exact, just unpruned.
        memo[fkey] = uses + 1
        _metrics.inc("knn.radius_memo_hits")
        return _full_table_knn(planner, plan, index, x, y, k, m)
    memo.pop(fkey, None)
    seeded = memo["radii"].get(target)
    r = float(seeded if seeded is not None else initial_radius_m)
    first_round = True
    prev_rows = -1
    for _ in range(40):
        _metrics.inc("knn.plan_rounds")
        whole_world = expand_bbox(x, y, r) == _WORLD
        plan_r = planner.plan(plan.full_filter if whole_world else with_bbox(r))
        if not (plan_r.residual_host is None and plan_r.candidate_slices is None
                and plan_r.index is index):
            break  # composition changed the plan shape: full-table kernel
        blocks = planner._pruned_blocks(plan_r)
        if blocks is None:
            if first_round and seeded is not None:
                # stale memo (table shrank / cover now declines at this
                # radius): restart the ordinary schedule, don't give up
                # the pruned path
                r = float(initial_radius_m)
                seeded = None
                first_round = False
                continue
            break  # no cover (wide bbox / tiny table): full-table kernel
        # candidate rows are free to evaluate (host binary searches), so aim
        # well past k: a generous candidate set makes the inscribed-circle
        # guarantee pass on the FIRST dispatch almost always — each failed
        # guarantee costs a full device round trip, each extra radius step
        # a full host plan+cover pass (the dominant cfg4 cost at 100M on a
        # single-core host — which is why the growth below is density-
        # scaled and the landing radius is memoized per planner)
        rows = plan_r.explain.get("candidate_rows", 0)
        enough = rows >= target
        if not (enough or whole_world):
            # candidate rows grow ~r^2 in locally-uniform data: jump
            # toward the radius that should hold ~1.5x the target instead
            # of walking a blind schedule. A stagnant count means the
            # cover's resolution hasn't moved yet — fall back to the x8
            # step (never slower than the pre-memo schedule).
            if rows > 0 and rows != prev_rows:
                grow = min(max(math.sqrt(1.5 * target / rows), 2.0), 8.0)
            else:
                grow = 8.0
            prev_rows = rows
            r *= grow
            first_round = False
            continue
        if first_round and seeded is not None:
            _metrics.inc("knn.radius_memo_hits")
        memo["radii"][target] = r
        from geomesa_tpu_torch.index import prune as _prune
        _metrics.inc("knn.device_dispatches")
        dists, pos = index.kernels.topk_nearest_blocks(
            plan_r.primary_kind, plan_r.boxes_loose, plan_r.windows,
            plan_r.residual_device, x, y, m,
            _stable_tier_blocks(memo, blocks), _prune.BLOCK_SIZE)
        valid = np.isfinite(dists)
        kth_ok = valid.sum() >= k and float(np.sort(dists[valid])[k - 1]) <= r
        if whole_world or kth_ok:
            return _exact_rerank(planner, index, pos[valid], x, y, k)
        # fewer than k in radius, or the k-th may lie outside the bbox
        r = max(r * 4, float(np.sort(dists[valid])[min(valid.sum(), k) - 1])
                * 1.001 if valid.any() else r * 4)
        first_round = False
    else:
        return np.empty(0, dtype=np.int64), np.empty(0)

    memo[fkey] = 1  # remember the full-table outcome for the neighbors
    return _full_table_knn(planner, plan, index, x, y, k, m)


def _full_table_knn(planner, plan, index, x, y, k, m):
    _metrics.inc("knn.device_dispatches")
    dists, pos = index.kernels.topk_nearest(
        plan.primary_kind, plan.boxes_loose, plan.windows,
        plan.residual_device, x, y, m)
    valid = np.isfinite(dists)
    return _exact_rerank(planner, index, pos[valid], x, y, k)


def _exact_rerank(planner, index, pos: np.ndarray, x: float, y: float, k: int):
    rows = index.map_rows(pos.astype(np.int64))
    if len(rows) == 0:
        return rows, np.empty(0)
    gx, gy = planner.table.geometry().point_xy()
    d = haversine_m(gx[rows], gy[rows], x, y)
    take = min(k, len(d))
    part = np.argpartition(d, take - 1)[:take]
    order = part[np.argsort(d[part], kind="stable")]
    return rows[order], d[order]


# -- expanding-radius fallback (reference-shaped) ---------------------------


def _radius_knn(planner, x, y, k, f, initial_radius_m, max_doublings):
    geom = planner.sft.geometry_attribute

    def with_bbox(radius_m):
        bbox = ir.BBox(geom.name, *expand_bbox(x, y, radius_m))
        return bbox if f is None or isinstance(f, ir.Include) \
            else ir.and_filters([f, bbox])

    # doubling schedule (stops once a bbox covers the world); always at
    # least the initial radius, so max_doublings < 1 degrades gracefully
    radii = []
    r = float(initial_radius_m)
    for _ in range(max(1, max_doublings)):
        radii.append(r)
        if expand_bbox(x, y, r) == _WORLD:
            break
        r *= 2

    counts = _pipelined_counts(planner, with_bbox, radii)
    enough = np.nonzero(counts >= k)[0]
    if len(enough) == 0:
        # even the widest bbox held < k — rank whatever the widest query has
        radius, expected = radii[-1], int(counts[-1])
        whole_world = expand_bbox(x, y, radius) == _WORLD
    else:
        i = int(enough[0])
        radius, expected = radii[i], int(counts[i])
        whole_world = False

    rows, dists = _rank(planner,
                        (f or ir.Include()) if whole_world else with_bbox(radius),
                        x, y, k, capacity=expected)
    if len(rows) == 0 or whole_world:
        return rows, dists
    # guarantee: the k-th distance may exceed the bbox's inscribed circle —
    # re-query at that radius so boundary-adjacent closer points are seen
    dk = float(dists[-1])
    if dk > radius:
        rows, dists = _rank(planner, with_bbox(dk * 1.001), x, y, k)
    return rows, dists


def _pipelined_counts(planner, with_bbox, radii) -> np.ndarray:
    """Counts for every radius in ONE round trip when the plan allows it
    (device-exact primary boxes); otherwise sequential blocking counts."""
    plan = planner.plan(with_bbox(radii[0]))
    if (not plan.empty and plan.primary_kind in ("point_boxes", "bbox_overlap")
            and plan.residual_host is None and plan.candidate_slices is None
            and plan.index is not None):
        from geomesa_tpu_torch.filter.extract import extract_bboxes
        from geomesa_tpu_torch.index.spatial import _boxes_fp62
        geom = planner.sft.geometry_attribute.name
        # rebuild only the box constants per radius; a radius whose bbox
        # splits (antimeridian) falls back to the sequential path
        raws = [_boxes_fp62(extract_bboxes(with_bbox(r), geom).boxes)
                for r in radii]
        if all(len(b) == 1 for b in raws):
            boxes = np.concatenate(raws, axis=0)
            return plan.index.kernels.counts_multi(
                plan.primary_kind, boxes, plan.windows,
                plan.residual_device)
    return np.array([planner.count(with_bbox(r)) for r in radii])


def _rank(planner, f, x, y, k, capacity: Optional[int] = None):
    rows = planner.select_indices(f, capacity=capacity)
    if len(rows) == 0:
        return rows, np.empty(0)
    garr = planner.table.geometry()
    if garr.is_points:
        gx, gy = garr.point_xy()
        gx, gy = gx[rows], gy[rows]
    else:
        bb = garr.bboxes()[rows]
        gx, gy = (bb[:, 0] + bb[:, 2]) / 2, (bb[:, 1] + bb[:, 3]) / 2
    d = haversine_m(gx, gy, x, y)
    take = min(k, len(d))
    part = np.argpartition(d, take - 1)[:take]
    order = part[np.argsort(d[part], kind="stable")]
    return rows[order], d[order]
