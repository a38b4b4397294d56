"""Chip smoke test of the PyTorch/CUDA port (geomesa_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit) when it fails:

1. device: the card's name and power limit;
2. build: every CUDA kernel of the port (``kernels/build.py`` ``KERNELS``)
   from the checkout's sources, one nvcc each, all started together, with
   ptxas' report and the SASS instructions per (point, edge) pair of the
   refine kernel's inner loop and per (candidate, box) of the box count's
   tile loop;
3. pip_refine against its plain PyTorch version on the card at near-edge
   shapes, unmasked and masked, with times and bounds;
4. the main path: a 100M-point Z3 layer loaded through the port's
   DataStore (the native encoder, its chunks streamed to the card from
   pinned memory while the next one encodes, the device sort; the load
   split by stage and its peak device memory) and queried — (a) box
   count, (b) polygon count, (c) polygon select, (d) the flagship 64x64
   density of ``__graft_entry__.entry()`` through ``store.query(...,
   hints={"density": ...})`` (the staged route) and through the fused
   program, (e) query (a) as a 256x256 ``val``-weighted density, (f) a
   time+attribute count and select and an INCLUDE count on the staged
   path — each result equal to a numpy oracle computed here, with every
   kernel's launch count read around the run ((a)-(d) through
   ``block_gate`` and ``fused_scan``, the staged (d)-(f) through
   ``fused_scan``, (b), (c) and (f)'s select through
   ``ordered_compact``);
5. the serving path (g) on the same store, every answer equal to its numpy
   oracle: (g1) ``planner.prepare`` of (a) — blocking counts and 64
   ``count_async`` calls with one stacked readback, each launching
   ``block_gate`` and ``fused_scan``, with no host sync (CUDA's sync debug
   mode); (g2) 10 never-seen boxes, each prepared and counted (the recipe fast path); (g3) 64
   distinct boxes in one ``prepare_counts_multi_blocks`` dispatch over the
   union of their covers, and ``counts_multi`` over the full table; (g4)
   the micro-batching ``QueryScheduler`` under 64 client threads, against
   64 threads of unbatched ``planner.count``, and the store's
   ``count_many`` — with ``box_count``'s launches read around (g);
5b. the point layer's other filters (h)-(k) on the same store, every answer
   equal to its numpy oracle, with every kernel's launches read around
   them: (h) an OR of two box+time branches as a count (one two-branch
   ``fused_scan``), as rows (the union program) and as a 64x64 density
   over both branches (the union program's grid_scatter);
   (i) ``st_distance(geom, POINT) < r`` and ``<= r`` as counts and rows
   (the fused dist refine, ``dist_refine``); (j) ``st_contains`` with
   (b)'s polygon (the fused pip refine) and ``WITHIN`` (the staged scan and
   the host refine); (k) a MULTIPOLYGON ``INTERSECTS`` and a ``DWITHIN``;
6. each kernel against its plain version on the tensors the main path
   gives it: pip_refine at (b)'s candidates; dist_refine at (i)'s
   candidates and at points within a few ulps of r ± DIST_BAND;
   grid_scatter at (d)'s route
   inputs and at the full-table mask, at 64x64 and 256x256, unit and
   ``val``-weighted, with times, bounds, device activities a call and
   ``torch.bincount``'s time for the scatter part; box_count at (g3)'s
   union blocks and the full table with 64 boxes, and at (f)'s count, with
   the passing candidates and the kernel's tile fills; the fused
   program's kernels (``phase_fused_kernels``): block_gate over the
   table's 24,415 blocks with (a)'s gate and with (h)'s two-branch union
   gate and over 244,141 blocks resampled from the table's (a billion-row
   table) with (a)'s gate, each with its alive count (and the cluster
   size, the CTA width, registers and spills), fused_scan's
   count at (a)'s alive blocks and over every block and its mask at (b)'s
   alive blocks, ordered_compact at (c)'s certain hits (caps 65,536 and
   4,096), (b)'s hits (cap 0) and uncertain rows (cap 4,096) and over
   33,554,432 candidates with 1%, 10% and 50% set (``torch.nonzero``'s
   time beside it), each with its device activities and device time a
   call, and the three kernels' registers and spills; then each staged
   mode on its kernel route against the same mode with its kernels'
   plain versions (``phase_staged_kernels``): (f)'s count, select and
   row mask over all 24,415 blocks, (d)'s and (e)'s densities on their
   routes, (h)'s OR count, with times, activities and bounds;
7. a profile of each query: device activities, idle share and the host
   syncs made inside it;
7b. Z2 and the extent indexes (m), on stores of their own: (m1) bench.py
   cfg2 not cut — 5,000,000 single-segment LineStrings (XZ2), the polygon
   INTERSECTS as a count (the ``seg_band`` route) and as rows against
   bench.py's exact segment test, a BBOX count and 64 shifted boxes through
   ``counts_multi_blocks`` and ``store.count_many`` (``box_count``'s
   envelope mode); (m2) the same segments with a date (XZ3), the
   INTERSECTS AND a week; (m3) 500,000 small convex quadrilaterals (XZ2,
   the host ragged refine); (m4) the first 10,000,000 points of the cfg1
   corpus without a date (Z2) — every answer equal to its numpy oracle,
   p50s of prepared queries, the builds by stage and the host refine's
   share of the band count; then ``seg_band`` against its plain version at
   (m1)'s candidate blocks and at 33,554,432 near-edge segments, and
   ``box_count``'s envelope mode at (m1)'s box and 64 boxes;
7b'. the geometry catalog (q) (``phase_catalog``, ``{"catalog": ...}``
   line) on (m1)'s and (m3)'s stores, the planner's default route for st_*
   residuals: (q1) ``st_length(geom) > 1.5`` over the 5M lines
   (``geom_unary``), (q2) (m3)'s ``st_area`` count in M_BOX
   (``geom_unary``) and its buffer count (``geom_pred``), (q3)
   ``st_intersects`` with M_WKT and ``st_contains`` of POINT(1 39) over
   the quads (``geom_pred``), (q4) ``st_distance(geom, POINT(1 39)) <
   0.5`` (``geom_dist``) — scalar counts equal to a numpy f32 oracle in the
   reference's arithmetic (the f64 count and the rows on which the two
   differ beside it), booleans to their f64 oracles, (q4) to the plain
   version's count on the card with every distance within the documented
   2e-4 + 1e-5·d of its f64 value; each query's p50 with
   GEOMESA_TPU_GEOM_KERNELS on and off, its kernels' launches (each must
   launch) and the split of its catalog call (pack, upload, kernel,
   refine); then each catalog kernel against its plain version at (q)'s
   shapes and, for the pair kernels, at the layers' scale (all 500,000
   quads against POINT(1 39), M_WKT and a 700-edge ring, all 5M lines
   against M_WKT: ``catalog_pair_calls``) with its bound, registers and
   spills (``phase_catalog_kernels``);
7c. authorizations, feature ids, shaping and the rows path (n)
   (``phase_auths``): a store of its own over the same 100M points, each
   labelled with one of 8 seed-drawn visibility expressions; (a)-(d) under
   auths that allow some, all and none of them, (h)'s OR, an IN of 1,000
   feature ids alone and with (a)'s box, (a) sorted, limited, transformed
   and reprojected — every answer equal to a numpy oracle that evaluates
   the expressions itself, every kernel's launches read around, and
   ``fused_scan``'s VIS form against its plain version; then on the main
   store (c)'s, (h)'s, (i)'s and (j)'s rows with the host permutation not
   cached (host syncs, device activities), and the first select of more
   than 2^20 rows with its one permutation read-back;
7d. stats, BIN, sampling and KNN (o) on the main store, before the write
   path changes its corpus (``phase_process``, ``{"process": ...}`` line):
   bench.py cfg4's ``knn(planner, 2.0 + 0.03 i, 48.0, 10)`` warm and six
   reps (p50, plan rounds and dispatches a query, the k-th distance), k =
   2048 (the device cap), k = 2500 (the radius fallback), k = 10 under
   (a)'s filter and inside a box far from the point (the full-table
   kernel) — each against a numpy f64 brute force; the ``stats`` hint
   (Count, Histogram, Z2Histogram, Enumeration, GroupBy, MinMax) over (a)
   and INCLUDE against numpy with the reference's f32 binning; the store's
   battery, estimated and exact counts of (a) and (f); (a)'s BIN records
   (bytes) and its 1-in-100 sample by name — every kernel's launches read
   around it; then ``masked_hist`` (each form, at (a)'s mask and over the
   whole table) and ``topk_nearest`` (FULL at m = 32 and 4,096 over the
   100M rows, BLOCKS at cfg4's cover) against their plain versions, with
   ``torch.bincount``'s and ``torch.topk``'s times beside them
   (``phase_process_kernels``), ``topk_nearest``'s one-cluster and grid
   routes at 2^19 to 2^22 candidates, and its keys pass's SASS;
7e. the attribute index (p) (``phase_attribute``, ``{"attribute": ...}``
   line): a store of its own over the same 100M points with ``code`` (300
   synthetic three-letter codes, Zipf-like, a generator of their own) and
   ``val`` indexed, each row labelled as in (n): (p1) an equality on a code at
   about 0.1% of rows, (p2) an ``IN`` of five codes with one repeated,
   (p3) a string range whose bounds are outside the vocabulary, (p4)
   ``val BETWEEN`` with (a)'s box and week (the chosen index, each index's
   estimated and actual candidates), (p5) (p1) under auths, (p6) (p1) with
   (b)'s polygon — each against a numpy oracle, with every kernel's
   launches read around them (``fused_scan``'s RUNS form must launch) —
   each query's p50, host syncs and device activities, ``explain`` of (p1)
   and (p4), the build split of every index, ``reindex`` under concurrent
   counts and ``update_schema``; then the RUNS form against its plain
   version at (p1)'s, (p3)'s and (p4)'s runs and at 33.5M candidates in 1,
   64 and 4,096 runs (count, mask, VIS, no box), and ``masked_hist`` HIST
   over subnormal ranges (``P_HIST``) (``phase_attribute_kernels``); the
   store is freed after it;
7f. bench.py cfg3's joins (r) (``phase_cfg3``, ``{"cfg3": ...}`` line),
   before (l): (r1) ``SpatialJoin.counts`` and ``assign`` over the first
   20,000,000 points of the corpus against perf/polygons_complex.json's 32
   polygons (``pip_join``; p50s and Mpts/s, ``hits.sum() > 0`` as bench.py
   asserts); (r2) ``extent_join`` of 200,000 seeded two-point lines against
   them on the host and on the device route, the pair lists equal, the
   pair kernel declined (polygons past ``MAX_SEGMENTS``, 0 ``pair_band``
   launches); (r3) the 13 polygons of at most 512 segments: the candidate
   pairs tiled to about 1,000,000 through ``device_refine`` and
   ``prepare_refine``'s staged call (p50s, Mpairs/s) and the join on both
   routes; then each kernel against its plain version on the card at those
   inputs, with its bound (``pip_join``: the (point in bbox, edge) pairs
   and the straddling ones, the reference's dense count beside them;
   ``pair_band``: the real segment pairs);
8. the write path (l) on the same store, after every other phase (the
   corpus changes under it): 20 appends of 100,000 rows into the LSM delta
   tier, (a)-(d) and (g3)'s 64 boxes through ``count_many`` over main +
   delta, a 21st append that flushes through by the incremental merge
   build (``merge_scatter``), the same answers again, the merged
   permutation against ``np.lexsort`` and the merged columns against the
   numpy planes, ``merge_scatter`` against its plain version at the flush's
   shape, and upsert / remove / update / age-off on a separate 1M-row
   store — every answer equal to its numpy oracle, every kernel's launches
   counted from 0 around it;
9. the result lines: one JSON object per kernel, the card, and the final
   ``{"ok": true, ...}`` line.

The main path's load prints its split by stage (the native encode
overlapped with the upload, the attribute planes, the device sort, the
sorted gathers), each timer stopped on a device sync, and beside it the
sketch battery's seconds at its first read after the load. Every
``[kernel]`` line gives, beside the CUDA-event time, the device time a call
by kernel name from the same profiler session as its activities (events
recorded, mean ms).

Imports nothing of JAX and nothing of the JAX package. Exits non-zero
without a result when no CUDA card is present.
"""

from __future__ import annotations

import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# f32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12

# f32 operations the refine needs, whatever implements it, counting each
# addition, subtraction, multiplication and comparison as one (absolute
# values and negations are operand modifiers on this card, not counted).
# Per (live point, real edge) pair:
#   2 comparisons   cond = (y1 > y) != (y2 > y)
#   5 arithmetic    d2x, d2y, t1 = d1x*d2y, t2 = d1y*d2x, det = t1 - t2
#   2 additions     sd = (|d1x| + |d1y|) + |d2x| + |d2y|, its edge-only
#                   first sum not counted here
#   4 arithmetic    tol = tol_t * (|t1| + |t2|) + tol_d * sd
#   1 comparison    the crossing: det > tol (upward) or det < -tol
#   1 comparison    |det| <= tol
#   1 comparison    |y1 - y| <= band (|y1 - y| is |d2y|: no new subtraction)
#   2 (sub + cmp)   |y2 - y| <= band
# = 18. Per real edge, once: d1x, d1y, |d1x| + |d1y| and upward (y2 > y1) = 4.
PIP_OPS_PER_PAIR = 18
PIP_OPS_PER_EDGE = 4

# f32 operations of the density scatter per live candidate, whatever
# implements it: 2 subtractions and 2 divisions (fx, fy), 4 comparisons
# (the bbox test), 2 multiplications (by W and H) and 1 addition (the cell
# update); the bbox's two widths once per call are not counted
SCATTER_OPS_PER_ROW = 11

# int32 operations of the batched box count, the fewest an implementation
# needs. A signed lexicographic (hi, lo) compare is one signed 64-bit
# compare of the order-preserving key hi:(lo ^ 2^31) (index/scan.py
# pack62): 2 instructions (ISETP.U32 on the low word, ISETP.EX on the high
# one), with the ANDs and ORs folded into the predicate inputs of the next
# compare. Per (candidate
# in its block, real window): 2 compares = 4. Per (candidate passing
# membership, windows, residual and __valid__; real box): 4 compares = 8.
# A window's own test (bin_lo <= bin_hi) is once per window, not counted.
# The card issues 64 INT32 lanes an SM a clock (Hopper).
WINDOW_OPS = 4
BOX_OPS = 8
INT32_LANES_PER_SM = 64

# f32 operations of the dist refine per live candidate: 2 subtractions, 2
# multiplications, 1 addition, 1 square root and 2 comparisons
DIST_OPS_PER_ROW = 8

CONCAVE_WKT = "POLYGON((-10 20, 40 20, 40 60, -10 60, 15 40, -10 20))"
CONCAVE = [(-10.0, 20.0), (40.0, 20.0), (40.0, 60.0), (-10.0, 60.0),
           (15.0, 40.0), (-10.0, 20.0)]
KERNEL_N = 8192 * 4096   # cap blocks x block rows: the pruned branch's most
# block_gate's third shape: a billion-row table's blocks of 4,096 rows
GATE_ROWS = 1_000_000_000
GATE_BLOCKS = -(-GATE_ROWS // 4096)
GATE_SEED = 31

# the main path: the bench.py cfg1 corpus at its full size, the entry()
# schema, and three queries of the flagship shape
N = 100_000_000
SPEC = "name:String,val:Int,dtg:Date,*geom:Point;geomesa.z3.interval=week"
DURING = "dtg DURING 2020-01-05T00:00:00Z/2020-01-12T00:00:00Z"
Q_BOX = f"BBOX(geom, -10, 30, 30, 55) AND {DURING} AND val > 10"
Q_POLY = f"INTERSECTS(geom, {CONCAVE_WKT}) AND {DURING}"
# (d): __graft_entry__.entry()'s flagship step, a 64x64 density
D_BBOX = (-60.0, -30.0, 60.0, 30.0)
Q_D = ("BBOX(geom, -60, -30, 60, 30) AND dtg DURING "
       "2020-01-03T00:00:00Z/2020-01-15T00:00:00Z AND val > 10")
# (e): query (a) as a 256x256 val-weighted density over its own box
E_BBOX = (-10.0, 30.0, 30.0, 55.0)
# (f): plans without a box, on the staged path
Q_F = f"{DURING} AND val > 90"
# (h)-(k): the point layer's other filters on the same store. (h) an OR of
# two device-exact branches (the union program); (i) a radius around a
# point (the fused dist refine); (j) st_contains with (b)'s polygon (the
# fused pip refine) and WITHIN (staged scan + host refine); (k) a
# MULTIPOLYGON and DWITHIN (staged scan + host refine)
Q_H = (f"BBOX(geom,-10,30,30,55) AND {DURING} OR "
       f"BBOX(geom,60,-10,100,20) AND {DURING} AND val > 50")
# (h)'s 64x64 density covers both branches ((d)'s bbox holds neither)
H_BBOX = (-20.0, -20.0, 110.0, 60.0)
I_CX, I_CY, I_R = 10.0, 45.0, 5.0
Q_I_LT = f"st_distance(geom, POINT({I_CX} {I_CY})) < {I_R} AND {DURING}"
Q_I_LE = f"st_distance(geom, POINT({I_CX} {I_CY})) <= {I_R} AND {DURING}"
Q_J_CONTAINS = f"st_contains({CONCAVE_WKT}, geom) AND {DURING}"
Q_J_WITHIN = f"WITHIN(geom, {CONCAVE_WKT}) AND {DURING}"
TRIANGLE = [(60.0, -10.0), (100.0, -10.0), (80.0, 20.0), (60.0, -10.0)]
MULTI_WKT = ("MULTIPOLYGON(((-10 20, 40 20, 40 60, -10 60, 15 40, -10 20)),"
             " ((60 -10, 100 -10, 80 20, 60 -10)))")
Q_K_MULTI = f"INTERSECTS(geom, {MULTI_WKT}) AND {DURING}"
K_D = 3.0
Q_K_DWITHIN = (f"DWITHIN(geom, POINT({I_CX} {I_CY}), {K_D}, degrees) "
               f"AND {DURING}")
REPS = 10
# (h)-(k)'s p50s: SLOW_REPS calls of a query slower than SLOW_MS
SLOW_MS = 150.0
SLOW_REPS = 3
# (g): bench.py cfg1's serving queries around (a)'s box: 10 never-seen
# boxes for the cold path (bench.py:389-395) and 64 distinct boxes for the
# batch and the scheduler (bench.py:425-431)
QX0, QY0, QX1, QY1 = -10.0, 30.0, 30.0, 55.0
COLD_DAYS = ("2020-01-06", "2020-01-13")
BATCH_DAYS = ("2020-01-05", "2020-01-12")
COLD_BOXES = [(QX0 + 0.11 + 0.83 * i, QY0 - 0.07 - 0.41 * i,
               QX1 + 0.11 + 0.83 * i, QY1 - 0.07 - 0.41 * i)
              for i in range(10)]
BATCH_BOXES = [(QX0 + (i % 8) * 0.4, QY0 + (i // 8) * 0.3,
                QX1 + (i % 8) * 0.4, QY1 + (i // 8) * 0.3)
               for i in range(64)]
G_THREADS = 64
# (l): the write path on the same store: 20 appends of 100,000 rows into
# the LSM delta (the threshold is max(50,000, 0.02 x 100M) = 2M rows), a
# 21st that flushes through by the merge build, and the full-rebuild
# mutations on a separate 1M-row store
L_BATCHES = 20
L_BATCH = 100_000
L_SEED = 77
L_STORE_N = 1_000_000
# (n): visibility labels, authorizations, feature ids, the shaping hints
# and the rows path on the cfg1 corpus: each row labelled with one of 8
# expressions drawn from N_SEED over N_LABELS, an IN of N_FIDS ids
N_SEED = 88
N_LABELS = ("admin", "ops", "user", "intel", "ext")
N_FIDS = 1000


def box_query(box, days) -> str:
    return (f"BBOX(geom, {box[0]}, {box[1]}, {box[2]}, {box[3]}) AND dtg "
            f"DURING {days[0]}T00:00:00Z/{days[1]}T00:00:00Z")


def log(*a):
    print(*a, flush=True)


def ring_1000(seed: int = 3) -> np.ndarray:
    """Closed star-shaped ring of 1000 vertices around (15, 40)."""
    rng = np.random.default_rng(seed)
    ang = np.sort(rng.uniform(0, 2 * np.pi, 1000))
    rad = rng.uniform(5, 20, 1000)
    pts = np.stack([15 + rad * np.cos(ang), 40 + rad * np.sin(ang)], 1)
    return np.vstack([pts, pts[:1]])


def padded_edges(ring) -> np.ndarray:
    from geomesa_tpu_torch.index.scan import EDGE_PAD
    r = np.asarray(ring, dtype=np.float64)
    segs = np.concatenate([r[:-1], r[1:]], axis=1).astype(np.float32)
    ne = max(4, 1 << (len(segs) - 1).bit_length())
    ep = np.tile(EDGE_PAD, (ne, 1))
    ep[: len(segs)] = segs
    return ep


def near_edge_points(ring, n: int, seed: int):
    """Half uniform over the ring's bbox, half within 1e-5 deg of an edge."""
    rng = np.random.default_rng(seed)
    r = np.asarray(ring, dtype=np.float64)
    (x0, y0), (x1, y1) = r.min(0) - 1, r.max(0) + 1
    h = n // 2
    px = np.empty(n, np.float32)
    py = np.empty(n, np.float32)
    px[:h] = rng.uniform(x0, x1, h)
    py[:h] = rng.uniform(y0, y1, h)
    k = rng.integers(0, len(r) - 1, n - h)
    t = rng.uniform(0, 1, n - h)
    a, b = r[k], r[k + 1]
    px[h:] = a[:, 0] + t * (b[:, 0] - a[:, 0]) + rng.uniform(-1e-5, 1e-5, n - h)
    py[h:] = a[:, 1] + t * (b[:, 1] - a[:, 1]) + rng.uniform(-1e-5, 1e-5, n - h)
    return px, py


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """The host's ms a call of ``fn``: back-to-back calls on the host
    clock with no sync between them (a sync before and after)."""
    import torch
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    sync()
    return (t1 - t0) * 1e3 / reps


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    return smi.splitlines()[0], name


def phase_build():
    from geomesa_tpu_torch.kernels import box_count, build, pip, seg_band
    t0 = time.perf_counter()
    out = build.build(build.KERNELS)
    secs = time.perf_counter() - t0
    for name, r in out.items():
        log(f"[build] {name}: {r['seconds']:.2f} s")
        for line in r["log"].splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "smem", "spill")):
                log(f"[build]   {line.strip()}")
    log(f"[build] total {secs:.2f} s")
    sass = sass_per_pair(build._target(pip.NAME)[1])
    log(f"[build] {pip.NAME} SASS inner loop: {json.dumps(sass)}")
    sass = sass_per_candidate_box(build._target(box_count.NAME)[1])
    log(f"[build] {box_count.NAME} SASS tile loop: {json.dumps(sass)}")
    sass = sass_per_segment_pair(build._target(seg_band.NAME)[1])
    log(f"[build] {seg_band.NAME} SASS edge loop: {json.dumps(sass)}")
    return secs


def sass_inner_loops(so_path: str):
    """Each kernel's innermost loops in a built library, read with
    ``cuobjdump -sass``: (instructions, opcode counts) of every backward
    branch's body that holds no other loop. None when the toolkit's
    cuobjdump is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", so_path], capture_output=True,
                          text=True, check=True).stdout
    out = []
    for fn in text.split("Function : ")[1:]:
        ins = [(int(a, 16), op.strip()) for a, op in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
        loops = []
        for at, op in ins:
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", op)
            if m and int(m.group(1), 16) < at:
                loops.append((int(m.group(1), 16), at))
        for lo, hi in loops:
            if any(o != (lo, hi) and lo <= o[0] and o[1] <= hi
                   for o in loops):
                continue
            ops = {}
            for at, op in ins:
                if lo <= at <= hi:
                    name = re.sub(r"^@!?U?P\w+\s+", "", op).split()[0]
                    ops[name] = ops.get(name, 0) + 1
            out.append((sum(ops.values()), ops))
    return out


def sass_per_pair(so_path: str):
    """SASS instructions per (point, edge) pair in a point-in-polygon
    kernel's inner loop: among the innermost loops, the one covering the
    most pairs per pass, where a pair has exactly 4 FMUL (t1, t2 and the
    two tolerance products); with the loop's opcode counts. None when no
    loop qualifies or cuobjdump is missing."""
    best = None
    for n_ins, ops in sass_inner_loops(so_path) or ():
        fmul = sum(v for k, v in ops.items() if k.startswith("FMUL"))
        if fmul >= 4 and (best is None or fmul > best["fmul"]):
            best = {"instructions": n_ins, "fmul": fmul, "pairs": fmul / 4,
                    "per_pair": n_ins / (fmul / 4), "opcodes": ops}
    return best


def sass_per_segment_pair(so_path: str):
    """SASS instructions per (segment, edge) pair in the segment band's
    edge loop: among the innermost loops, the one covering the most pairs
    per pass, where a pair has exactly 16 FMUL (four orientations, each
    t1, t2 and the two tolerance products); with the loop's opcode counts.
    None when no loop qualifies or cuobjdump is missing."""
    best = None
    for n_ins, ops in sass_inner_loops(so_path) or ():
        fmul = sum(v for k, v in ops.items() if k.startswith("FMUL"))
        if fmul >= 16 and (best is None or fmul > best["fmul"]):
            best = {"instructions": n_ins, "fmul": fmul, "pairs": fmul / 16,
                    "per_pair": n_ins / (fmul / 16), "opcodes": ops}
    return best


def sass_per_candidate_box(so_path: str):
    """SASS instructions per (candidate, box) in the box count's tile loop
    (phase B): among the innermost loops with 16-byte shared loads (one a
    candidate: LDS.128) and 64-bit compares (ISETP), the one with the most
    candidates a pass, its instructions over its LDS.128 count (one box a
    lane); with its opcode counts. Taken over all template instances, which
    share the loop. None when no loop qualifies or cuobjdump is missing."""
    best = None
    for n_ins, ops in sass_inner_loops(so_path) or ():
        lds = sum(v for k, v in ops.items()
                  if k.startswith("LDS") and ".128" in k)
        isetp = sum(v for k, v in ops.items() if k.startswith("ISETP"))
        if lds and isetp >= 8 * lds and (best is None or lds > best["lds"]):
            best = {"instructions": n_ins, "lds": lds, "isetp": isetp,
                    "per_candidate_box": n_ins / lds, "opcodes": ops}
    return best


def refine_bound(n: int, live: int, ne: int, n_starts: int,
                 masked: bool) -> dict:
    """The least time the card could take for the refine's work on these
    inputs: bytes (the mask, live rows' coordinates once, both outputs, the
    block starts and the real edges) over the HBM rate, against operations
    (live points x real edges x PIP_OPS_PER_PAIR, plus the edge-only terms)
    over the f32 rate."""
    nbytes = (n if masked else 0) + live * 8 + 2 * n + n_starts * 8 + ne * 16
    ops = live * ne * PIP_OPS_PER_PAIR + ne * PIP_OPS_PER_EDGE
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes * 1e3, "ops_ms": t_ops * 1e3}


def compare_refine(label: str, tx, ty, te, n_edges: int, reps: int,
                   mask=None, starts=None, bsz=None) -> dict:
    """pip_refine's kernel (pad rows skipped) against its plain version
    (the whole padded table) on the same card tensors: hit and unc must be
    byte-equal; both timed with CUDA events."""
    import torch
    from geomesa_tpu_torch.index.scan import pip_refine as plain
    from geomesa_tpu_torch.kernels import pip

    kw = {"mask": mask, "starts": starts, "bsz": bsz}
    khit, kunc = pip.pip_refine(tx, ty, te, n_edges=n_edges, **kw)
    torch.cuda.synchronize()
    phit, punc = plain(tx, ty, te, **kw)
    torch.cuda.synchronize()
    err = max(int((khit.to(torch.int8) - phit.to(torch.int8)).abs().max()),
              int((kunc.to(torch.int8) - punc.to(torch.int8)).abs().max())) \
        if khit.numel() else 0
    if err != 0 or not (torch.equal(khit, phit) and torch.equal(kunc, punc)):
        raise AssertionError(f"pip_refine {label}: kernel hit/unc differ "
                             f"from the plain version")
    n = khit.shape[0]
    live = n if mask is None else int(mask.sum())
    ms = cuda_ms(lambda: pip.pip_refine(tx, ty, te, n_edges=n_edges, **kw),
                 reps)
    plain_ms = cuda_ms(lambda: plain(tx, ty, te, **kw), max(1, reps // 10))
    r = {"n": n, "live": live, "ne": n_edges, "ms": ms, "plain_ms": plain_ms,
         "max_abs_err": err, "hit": int(phit.sum()),
         "uncertain": int(punc.sum()),
         **refine_bound(n, live, n_edges,
                        0 if starts is None else starts.shape[0],
                        mask is not None)}
    log(f"[kernel] pip_refine {label}: n={n} live={live} ne={n_edges} "
        f"hit/unc equal (hit {r['hit']}, uncertain {r['uncertain']}), "
        f"kernel {ms} ms, plain {plain_ms} ms, bound {r['bound_ms']} ms "
        f"({r['bound_by']}; bytes {r['bytes_ms']} ms, operations "
        f"{r['ops_ms']} ms)")
    return r


def near_edge_masks(n: int, seed: int) -> dict:
    """20% masks over n candidates: at random, and in coherent runs of 1000
    rows (a fifth of the runs live)."""
    rng = np.random.default_rng(seed)
    runs = np.repeat(rng.random(-(-n // 1000)) < 0.2, 1000)[:n]
    return {"random20": rng.random(n) < 0.2, "runs20": runs}


def phase_kernels():
    """pip_refine against its plain version at n = cap * block rows (the
    pruned branch's largest gather on the 100M table), half the points
    within 1e-5 deg of an edge, for the concave query polygon and a
    1000-vertex ring, unmasked and under 20% masks."""
    import torch

    dev = torch.device("cuda")
    out = {}
    for label, ring, seed in (("concave8", CONCAVE, 11),
                              ("ring1024", ring_1000(), 12)):
        px, py = near_edge_points(ring, KERNEL_N, seed)
        t = [torch.from_numpy(a).to(dev) for a in (px, py, padded_edges(ring))]
        reps = 20 if label == "concave8" else 10
        ne = len(ring) - 1
        out[label] = compare_refine(f"near-edge {label}", *t, ne, reps)
        for mlabel, m in near_edge_masks(KERNEL_N, seed).items():
            out[f"{label}_{mlabel}"] = compare_refine(
                f"near-edge {label} {mlabel}", *t, ne, reps,
                mask=torch.from_numpy(m).to(dev))
        del t
    torch.cuda.empty_cache()
    return out


def live_candidates(prog):
    """(mask, starts) of a program's candidates cut to its live blocks: the
    tensors its refine kernel reads on the main path (which takes the full
    lists with the gate's device count and stops at that count)."""
    m, nblk, starts = prog._candidates()
    k = int(nblk[0])
    return m[: k * prog.bsz], starts[:k]


def phase_kernel_main_inputs(store) -> dict:
    """pip_refine against its plain version on the very tensors the main
    path's polygon query hands it: the table's xf/yf columns, the mask and
    block starts of query (b)'s candidates, and its edge table."""
    from geomesa_tpu_torch.index import compiled

    plan = store.planner("gdelt").plan(Q_POLY)
    prog = compiled.Program(plan, "count_refine", unc_cap=4096,
                            refine=compiled.refine_spec(plan))
    m, starts = live_candidates(prog)
    cols = prog.index.device.columns
    r = compare_refine("main-path (b)", cols["xf"], cols["yf"], prog.edges,
                       prog.n_edges, reps=50, mask=m, starts=starts,
                       bsz=prog.bsz)
    log(f"[kernel] main-path (b): the mask keeps {r['live']} of {r['n']} "
        f"candidates ({r['live'] / max(1, r['n'])})")
    return r


def activities_per_call(fn, calls: int = 10, by_kernel: bool = False):
    """(device activities, their summed device ms) a warm call of ``fn`` —
    kernels, copies, memsets — from torch.profiler over ``calls`` calls (a
    profile of one call of a few µs sometimes comes back without device
    events); (None, None) when the profiler recorded no device activity.
    The device time excludes the host's part of the call, which the
    CUDA-event times of back-to-back calls include when the host is the
    slower side. ``by_kernel`` adds, from the same session, kernel name →
    [events recorded, mean device ms an event]: a one-kernel wrapper's
    device time a call even where the profiler drops some events (then
    fewer events than calls are recorded, and their mean still reads one
    call's kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    per = {}
    for e in dev:
        if "Memset" not in e.name and "Memcpy" not in e.name:
            k = per.setdefault(e.name[:80], [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us() / 1e3
    per = {k: [c, t / c] for k, (c, t) in per.items()}
    if not dev:   # the profiler recorded no device activity: not measured
        acts, dev_ms = None, None
    else:
        acts = len(dev) / calls
        dev_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / calls
    return (acts, dev_ms, per) if by_kernel else (acts, dev_ms)


def scatter_bound(n: int, live: int, weighted: bool, cells: int,
                  n_starts: int) -> dict:
    """The least time the card could take for the scatter on these inputs:
    bytes (the mask, the live rows' x/y and weight once, the raster written
    once, the block starts) over the HBM rate, against operations (live rows
    x SCATTER_OPS_PER_ROW) over the f32 rate."""
    nbytes = n + live * (12 if weighted else 8) + cells * 4 + n_starts * 8
    ops = live * SCATTER_OPS_PER_ROW
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes * 1e3, "ops_ms": t_ops * 1e3}


def compare_scatter(label: str, cols, mask, starts, bsz, bbox, width: int,
                    height: int, wname) -> dict:
    """grid_scatter's kernel against its plain version on the same card
    tensors: unit weights byte-equal; weighted per cell within
    2 * gamma(n_cell - 1) * sum|w| (two summation orders, each within
    gamma(n_cell - 1) * sum|w| of the exact sum; gamma(k) = k u / (1 - k u),
    u = 2^-24). Times by CUDA events; ``torch.bincount`` over precomputed
    cell ids as the library's time for the scatter part (excluding the
    snap)."""
    import torch
    from geomesa_tpu_torch.index import scan
    from geomesa_tpu_torch.kernels import density

    g = torch.tensor(bbox, dtype=torch.float32, device=mask.device)
    w = None if wname is None else cols[wname]
    args = (cols["xf"], cols["yf"], mask, w, starts, bsz, g, width, height)
    kg, kc = density.grid_scatter(*args)
    torch.cuda.synchronize()
    pg, pc = scan.grid_scatter(*args)
    torch.cuda.synchronize()
    if int(kc) != int(pc):
        raise AssertionError(f"grid_scatter {label}: count {int(kc)} != "
                             f"plain {int(pc)}")
    err = float((kg - pg).abs().max())
    if w is None:
        if not torch.equal(kg, pg):
            raise AssertionError(f"grid_scatter {label}: unit grid differs "
                                 f"from the plain version (max {err})")
    else:
        unit, _ = scan.grid_scatter(*args[:3], None, *args[4:])
        absw, _ = scan.grid_scatter(*args[:3], w.abs().to(torch.float32),
                                    *args[4:])
        k = (unit.double() - 1).clamp_min(0) * 2.0 ** -24
        tol = 2 * k / (1 - k) * absw.double()
        if bool(((kg.double() - pg.double()).abs() > tol).any()):
            raise AssertionError(f"grid_scatter {label}: weighted grid off "
                                 f"the plain version past the bound ({err})")
    # cell ids of the live rows inside the bbox, for bincount's time
    rows = None if starts is None else scan.block_rows(starts, bsz)
    xs = cols["xf"] if rows is None else cols["xf"].index_select(0, rows)
    ys = cols["yf"] if rows is None else cols["yf"].index_select(0, rows)
    fx = (xs - g[0]) / (g[2] - g[0])
    fy = (ys - g[1]) / (g[3] - g[1])
    inb = mask & (fx >= 0) & (fx < 1) & (fy >= 0) & (fy < 1)
    cell = ((fy * height).to(torch.int32).clamp_(0, height - 1).to(torch.int64)
            * width + (fx * width).to(torch.int32).clamp_(0, width - 1))[inb]
    wts = None
    if w is not None:
        wts = (w if rows is None else w.index_select(0, rows))[inb].to(
            torch.float32)
    del xs, ys, fx, fy, inb
    live = int(mask.sum())
    acts, dev_ms = activities_per_call(lambda: density.grid_scatter(*args))
    ms = cuda_ms(lambda: density.grid_scatter(*args), 20)
    plain_ms = cuda_ms(lambda: scan.grid_scatter(*args), 3)
    lib_ms = cuda_ms(lambda: torch.bincount(cell, weights=wts,
                                            minlength=width * height), 20)
    r = {"label": label, "n": int(mask.shape[0]), "live": live,
         "in_bbox": int(cell.shape[0]), "width": width, "height": height,
         "weight": wname, "ms": ms, "plain_ms": plain_ms,
         "activities_per_call": acts, "device_ms_per_call": dev_ms,
         "library_ms": lib_ms, "max_abs_err": err,
         "count": int(kc), "grid_sum": float(kg.sum()),
         **scatter_bound(int(mask.shape[0]), live, w is not None,
                         width * height,
                         0 if starts is None else int(starts.shape[0]))}
    log(f"[kernel] grid_scatter {label} {width}x{height} weight={wname}: "
        f"n={r['n']} live={live} in bbox {r['in_bbox']}, equal to the plain "
        f"version (max abs err {err}), kernel {ms} ms, plain {plain_ms} ms, "
        f"bincount (scatter part only) {lib_ms} ms, bound {r['bound_ms']} ms "
        f"({r['bound_by']}; bytes {r['bytes_ms']} ms, operations "
        f"{r['ops_ms']} ms), {acts} device activities a call "
        f"({dev_ms} ms of device time)")
    return r


def phase_density_kernel(store) -> list:
    """grid_scatter against its plain version on the tensors query (d)'s
    staged route hands it (``fused_scan``'s mask of the range-pruned
    blocks, or of every block, with the blocks' starts) and on the
    full-table 100M-row mask, at 64x64 and 256x256, unit and
    val-weighted."""
    from geomesa_tpu_torch.index import prune

    planner = store.planner("gdelt")
    plan = planner.plan(Q_D)
    kern = plan.index.kernels
    args = (plan.primary_kind, plan.boxes_loose, plan.windows,
            plan.residual_device)
    cols = plan.index.device.columns
    full = kern.mask(*args)
    blocks = planner._pruned_blocks(plan)
    # (d)'s candidates as its staged route hands them to the scatter (the
    # fused_scan mask through the blocks' starts), cut to the live blocks
    m, starts, nblk, bsz = kern._candidates([args], blocks, None if blocks
                                            is None else int(prune.BLOCK_SIZE))()
    k = int(nblk[0])
    m, starts = m[: k * bsz], starts[:k]
    if blocks is None:
        sets = [("main-path (d) = full-table candidates", m, starts, bsz),
                ("full-table mask (d)", full, None, None)]
    else:
        sets = [("main-path (d) range-pruned", m, starts, bsz),
                ("full-table mask (d)", full, None, None)]
    out = []
    for label, m, st, bsz in sets:
        for shape in ((64, 64), (256, 256)):
            for wname in (None, "val"):
                out.append(compare_scatter(label, cols, m, st, bsz, D_BBOX,
                                           *shape, wname))
    return out


def sm_clock_mhz(fn, ms: float) -> dict:
    """The SM clock (``nvidia-smi clocks.sm``) read while about half a
    second of ``fn`` launches is queued on the card, and its maximum."""
    import torch
    for _ in range(max(50, int(500 / max(ms, 1e-3)))):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    torch.cuda.synchronize()
    cur, mx = (float(v) for v in out.splitlines()[0].split(","))
    return {"sm_mhz": cur, "max_sm_mhz": mx}


def box_count_bound(cols, boxes, windows, resid, block_ids, bsz,
                    per_box: bool, clock_mhz: float,
                    envelope: bool = False) -> dict:
    """The least time the card could take for the batched count on these
    inputs. Bytes: the time planes (8 B) of every candidate in its block,
    the box planes (16 B; an envelope's 32 B) of every candidate that
    passes the windows, the residual and __valid__, the residual mask
    bytes, the block ids, boxes, windows and counts. Operations:
    WINDOW_OPS per (candidate in its block, real window) and BOX_OPS per
    (passing candidate, real box), over the INT32 rate at the measured SM
    clock."""
    import torch
    from geomesa_tpu_torch.index import scan
    n = int(next(iter(cols.values())).shape[0])
    if block_ids is None:
        member, ncand = n, n
    else:
        member = int(scan.expand_blocks(cols, block_ids, bsz, n)[0].sum())
        ncand = int(block_ids.shape[0]) * bsz
    base = int(scan.box_count(cols, None, windows, resid, block_ids, bsz,
                              False))
    t_real = 0 if windows is None else int((windows[:, 0]
                                            <= windows[:, 2]).sum())
    empty = torch.as_tensor(scan.EMPTY_BOX, device=boxes.device) \
        if boxes is not None else None
    b_real = 0 if boxes is None else int((boxes != empty).any(dim=1).sum())
    nbytes = (member * (8 if windows is not None else 0)
              + base * ((32 if envelope else 16) if boxes is not None
                        else 0)
              + (ncand if resid is not None else 0)
              + (member if "__valid__" in cols else 0)
              + (0 if block_ids is None else 4 * int(block_ids.shape[0]))
              + (0 if boxes is None else 32 * int(boxes.shape[0]))
              + (0 if windows is None else 16 * int(windows.shape[0]))
              + 4 * (int(boxes.shape[0]) if per_box else 1))
    ops = member * t_real * WINDOW_OPS + base * b_real * BOX_OPS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_rate = sms * INT32_LANES_PER_SM * clock_mhz * 1e6
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / int_rate
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes * 1e3, "ops_ms": t_ops * 1e3,
            "candidates": ncand, "in_blocks": member, "passing": base,
            "boxes_real": b_real, "windows_real": t_real,
            "int_ops_per_s": int_rate}


def compare_box_count(label: str, cols, boxes, windows, resid, block_ids,
                      bsz, per_box: bool, reps: int,
                      envelope: bool = False) -> dict:
    """box_count's kernel against its plain version on the same card
    tensors: integer counts, so equal value for value; both timed with
    CUDA events; the SM clock read under the kernel's own load."""
    import torch
    from geomesa_tpu_torch.index import scan
    from geomesa_tpu_torch.kernels import box_count, build

    args = (cols, boxes, windows, resid, block_ids, bsz, per_box, envelope)
    kern = box_count.box_count(*args)
    torch.cuda.synchronize()
    plain = scan.box_count(*args)
    torch.cuda.synchronize()
    err = int((kern.long() - plain.long()).abs().max())
    if err != 0 or not torch.equal(kern, plain):
        raise AssertionError(f"box_count {label}: kernel counts differ from "
                             f"the plain version (max abs err {err})")
    acts, dev_ms = activities_per_call(lambda: box_count.box_count(*args))
    ms = cuda_ms(lambda: box_count.box_count(*args), reps)
    plain_ms = cuda_ms(lambda: scan.box_count(*args), max(1, reps // 10))
    clk = sm_clock_mhz(lambda: box_count.box_count(*args), ms)
    r = {"label": label, "per_box": per_box, "ms": ms, "plain_ms": plain_ms,
         "max_abs_err": err, "total": int(kern.sum()), **clk,
         "activities_per_call": acts, "device_ms_per_call": dev_ms,
         **box_count_bound(*args[:6], per_box, clk["sm_mhz"], envelope)}
    # the kernel's rounds of TILE candidates a CTA; per box, each round's
    # passing candidates fill one shared-memory tile
    tile = int(build.load(box_count.NAME).box_count_tile())
    r["tile"] = tile
    r["tiles"] = -(-r["candidates"] // tile)
    r["mean_tile_fill"] = r["passing"] / (r["tiles"] * tile)
    log(f"[kernel] box_count {label}: {r['candidates']} candidates "
        f"({r['in_blocks']} in their blocks, {r['passing']} passing; "
        f"{r['tiles']} rounds of {tile}, mean tile fill "
        f"{r['mean_tile_fill']}), {acts} device activities a call "
        f"({dev_ms} ms of device time), "
        f"{r['boxes_real']} boxes, equal to the plain version (total "
        f"{r['total']}), kernel {ms} ms, plain {plain_ms} ms, bound "
        f"{r['bound_ms']} ms ({r['bound_by']}; bytes {r['bytes_ms']} ms, "
        f"operations {r['ops_ms']} ms at {clk['sm_mhz']} MHz)")
    return r


def phase_box_count_kernel(store, g) -> list:
    """box_count against its plain version on the main path's tensors:
    (g3)'s 64 boxes over the union of their covers and over the full table
    (per-box counts), and (f)'s staged count (the any-box count: its time
    window and its residual mask, no box)."""
    import torch
    from geomesa_tpu_torch.index import scan

    planner = store.planner("gdelt")
    kern = planner.indexes[0].kernels
    cols = kern.cols
    dev = kern.device
    boxes = torch.from_numpy(scan.pad_boxes(g["boxes64"])).to(dev)
    win = torch.from_numpy(g["windows"]).to(dev)
    bids = torch.from_numpy(kern._pad_blocks(g["union"])).to(dev)
    out = [compare_box_count("(g3) union blocks, 64 boxes", cols, boxes,
                             win, None, bids, g["bsz"], True, 50),
           compare_box_count("full table, 64 boxes", cols, boxes, win, None,
                             None, None, True, 10)]
    plan = planner.plan(Q_F)
    params, fn = plan.residual_device.params, plan.residual_device.fn
    resid = fn(cols, [torch.from_numpy(p).to(dev) for p in params])
    out.append(compare_box_count(
        "(f) staged count", cols, None,
        torch.from_numpy(plan.windows).to(dev), resid, None, None, False,
        20))
    return out


def corpus(n: int, seed: int = 1234):
    """64 Gaussian clusters of points over 30 days (bench.py cfg1), with
    name drawn from 3 values and val from integers(0, 100)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform([-120, -40], [140, 60], size=(64, 2))
    which = rng.integers(0, 64, n)
    x = np.clip(centers[which, 0] + rng.normal(0, 8, n), -180, 180)
    y = np.clip(centers[which, 1] + rng.normal(0, 6, n), -90, 90)
    del which
    base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
    dtg = base + rng.integers(0, 30 * 86400000, n)
    name = rng.integers(0, 3, n).astype(np.int32)
    val = rng.integers(0, 100, n).astype(np.int32)
    return x, y, dtg, name, val


def oracle_density(x, y, rows, bbox, width: int, height: int,
                   weight=None) -> np.ndarray:
    """The device path's density, written out here: the selected rows' f32
    coordinate planes snapped with f32 numpy arithmetic in the reference's
    order (bbox rounded to f32; fx = (x - xmin) / (xmax - xmin); a row counts
    when 0 <= fx < 1 and 0 <= fy < 1, in cell (int(fy*H), int(fx*W))
    clipped), the counts (or the weights) summed per cell exactly (f64)."""
    g = np.asarray(bbox, dtype=np.float32)
    xf = x[rows].astype(np.float32)
    yf = y[rows].astype(np.float32)
    fx = (xf - g[0]) / (g[2] - g[0])
    fy = (yf - g[1]) / (g[3] - g[1])
    inb = (fx >= 0) & (fx < 1) & (fy >= 0) & (fy < 1)
    ix = np.clip((fx[inb] * np.float32(width)).astype(np.int32), 0, width - 1)
    iy = np.clip((fy[inb] * np.float32(height)).astype(np.int32), 0,
                 height - 1)
    cell = iy.astype(np.int64) * width + ix
    w = None if weight is None else weight[rows][inb].astype(np.float64)
    return np.bincount(cell, weights=w, minlength=width * height).reshape(
        height, width)


def oracle_pip(px, py, ring) -> np.ndarray:
    """f64 crossing parity (half-open rule) or on an edge: the semantics of
    filter/geom_numpy.points_in_polygon, written out here independently."""
    r = np.asarray(ring, dtype=np.float64)
    x1, y1, x2, y2 = r[:-1, 0], r[:-1, 1], r[1:, 0], r[1:, 1]
    out = np.empty(len(px), dtype=bool)
    step = 1 << 22
    for a in range(0, len(px), step):
        qx = px[a:a + step, None]
        qy = py[a:a + step, None]
        cond = (y1 > qy) != (y2 > qy)
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = (x2 - x1) * (qy - y1) / (y2 - y1) + x1
        inside = (np.count_nonzero(cond & (qx < xint), axis=1) % 2) == 1
        eps = 1e-12
        cross = (x2 - x1) * (qy - y1) - (y2 - y1) * (qx - x1)
        scale = np.maximum(np.abs(x2 - x1), np.abs(y2 - y1)) + eps
        coll = np.abs(cross) <= eps * scale * np.maximum(
            1.0, np.maximum(np.abs(qx), np.abs(qy)))
        within = ((np.minimum(x1, x2) - eps <= qx) & (qx <= np.maximum(x1, x2) + eps)
                  & (np.minimum(y1, y2) - eps <= qy) & (qy <= np.maximum(y1, y2) + eps))
        out[a:a + step] = inside | np.any(coll & within, axis=1)
    return out


def density_hint(bbox, width, height, weight=None) -> dict:
    return {"density": {"bbox": bbox, "width": width, "height": height,
                        "weight": weight}}


def phase_main_path(n: int = N, device: str = "cuda"):
    """Load the corpus through the port's DataStore (Z3 build on the card)
    and answer queries (a)-(f); each must equal its numpy oracle. Returns
    each kernel's launches in the checked run, and the store."""
    import torch
    from geomesa_tpu_torch import DataStoreFinder
    from geomesa_tpu_torch.aggregates.density import prepare_density
    from geomesa_tpu_torch.features.table import FeatureTable, StringColumn
    from geomesa_tpu_torch.index import compiled
    from geomesa_tpu_torch.kernels import (box_count, compact, density,
                                           fused_scan, gate, pip)

    t0 = time.perf_counter()
    x, y, dtg, name, val = corpus(n)
    gen_s = time.perf_counter() - t0
    log(f"[main] corpus n={n} generated in {gen_s:.2f} s")

    def during(a, b):
        return (dtg > np.datetime64(a, "ms").astype(np.int64)) \
            & (dtg < np.datetime64(b, "ms").astype(np.int64))

    t0 = time.perf_counter()
    tmask = during("2020-01-05", "2020-01-12")
    sel_a = tmask & (x >= -10) & (x <= 30) & (y >= 30) & (y <= 55) & (val > 10)
    want_box = int(np.count_nonzero(sel_a))
    cand = np.flatnonzero(tmask & (x >= -10) & (x <= 40) & (y >= 20) & (y <= 60))
    want_rows = cand[oracle_pip(x[cand], y[cand], CONCAVE)]
    rows_d = np.flatnonzero(during("2020-01-03", "2020-01-15") & (x >= -60)
                            & (x <= 60) & (y >= -30) & (y <= 30) & (val > 10))
    want_d = oracle_density(x, y, rows_d, D_BBOX, 64, 64)
    rows_e = np.flatnonzero(sel_a)
    want_e = oracle_density(x, y, rows_e, E_BBOX, 256, 256, val)
    n_e = oracle_density(x, y, rows_e, E_BBOX, 256, 256)
    want_f = np.flatnonzero(tmask & (val > 90))
    g_oracle = serving_oracle(x, y, dtg)
    g_oracle["a"] = want_box
    g_oracle["b_rows"] = want_rows
    g_oracle["d_grid"] = want_d
    # (n)'s oracles start from these rows
    g_oracle["a_rows"] = rows_e
    g_oracle["d_rows"] = rows_d
    g_oracle["f_rows"] = want_f
    f_oracle = filters_oracle(x, y, val, tmask, len(want_rows))
    del tmask, cand, sel_a
    log(f"[main] numpy oracle in {time.perf_counter() - t0:.2f} s: "
        f"box {want_box}, polygon {len(want_rows)}, (d) {len(rows_d)} rows "
        f"(densest cell {int(want_d.max())}), (e) {len(rows_e)} rows, "
        f"(f) {len(want_f)} rows")
    if want_d.max() >= 1 << 24:
        raise AssertionError("(d)'s densest cell reaches 2^24: f32 unit "
                             "sums are no longer exact there")

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    store = DataStoreFinder.get_data_store(type="torch", device=device)
    sft = store.create_schema("gdelt", SPEC)
    t0 = time.perf_counter()
    table = FeatureTable.build(sft, {
        "name": StringColumn(name, ["a", "b", "c"]), "val": val, "dtg": dtg,
        "geom": (x, y)})
    store.load("gdelt", table)
    sync()
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated() if device == "cuda" \
        else None
    planner = store.planner("gdelt")
    idx = planner.indexes[0]
    placed = {k: str(v.device) for k, v in idx.device.columns.items()}
    if not all(d.startswith(device) for d in placed.values()):
        raise AssertionError(f"device columns off the card: {placed}")
    log(f"[main] load (host encode + Z3 sort/gather on the card) "
        f"{load_s:.2f} s; columns {sorted(placed)} on {set(placed.values())}")
    # the load by stage, each timer stopped on a device sync
    # (Z3Index.build_stages): the native encode overlapped with the pinned
    # side-stream upload of its chunks (encode_upload_overlap_s, or
    # encode_s and upload_s in one shot), the attribute planes (planes_s),
    # device_sort_perm (sort_s), the sorted gathers and the attribute
    # planes' uploads (gather_s, upload_s)
    split = dict(idx.build_stages)
    # the sketch battery, observed over the whole table at its first read
    # (GeoMesaStats.defer): a stage after the load, not in it
    battery = store.stats("gdelt")
    if battery.observed:
        raise AssertionError("the load observed the battery: it should wait "
                             "for its first read")
    t0 = time.perf_counter()
    battery.cached   # the first read observes it
    battery_s = time.perf_counter() - t0
    log(f"[main] the battery's sketches, each observed side by side (s): "
        f"{json.dumps(battery.update_split_s)}")
    log(f"[main] load split (s): {json.dumps(split)}; the rest of the "
        f"load {load_s - sum(split.values())} s; the battery at its first "
        f"read after the load: stats_battery_s {battery_s} "
        f"(update_s {battery.update_s}); peak device memory "
        f"{load_peak} bytes (the sorted columns "
        f"{sum(v.numel() * v.element_size() for v in idx.device.columns.values())}"
        f" bytes, the permutation {idx.perm.numel() * idx.perm.element_size()})")

    # the checked run: every kernel's launch count read around it
    counters = {"pip_refine": pip.pip_refine,
                "grid_scatter": density.grid_scatter,
                "box_count": box_count.box_count,
                "block_gate": gate.block_gate,
                "fused_scan": fused_scan.fused_scan,
                "ordered_compact": compact.ordered_compact}
    for c in counters.values():
        c.launches = 0
    per_query = {}

    def run(label, fn):
        before = {k: c.launches for k, c in counters.items()}
        out = fn()
        per_query[label] = {k: c.launches - before[k]
                            for k, c in counters.items()}
        return out

    got_box = run("a", lambda: store.count("gdelt", Q_BOX))
    got_poly = run("b", lambda: store.count("gdelt", Q_POLY))
    got_rows = run("c", lambda: store.query("gdelt", Q_POLY).indices)
    got_d = run("d", lambda: store.query(
        "gdelt", Q_D, hints=density_hint(D_BBOX, 64, 64)))
    fused_d = run("d_fused", lambda: compiled.try_density(
        planner, planner.plan(Q_D), D_BBOX, 64, 64))
    got_e = run("e", lambda: store.query(
        "gdelt", Q_BOX, hints=density_hint(E_BBOX, 256, 256, "val")))
    prep_e = prepare_density(planner, Q_BOX, E_BBOX, 256, 256, "val")
    enc_e = prep_e.packed()
    raw_e = run("e_device", lambda: prep_e.dispatch().cpu().numpy())
    got_f_count = run("f_count", lambda: store.count("gdelt", Q_F))
    got_f_rows = run("f_select", lambda: store.query("gdelt", Q_F).indices)
    got_inc = run("f_include", lambda: store.count("gdelt", "INCLUDE"))
    sync()
    launches = {k: c.launches for k, c in counters.items()}

    if got_box != want_box:
        raise AssertionError(f"(a) count {got_box} != oracle {want_box}")
    if got_poly != len(want_rows):
        raise AssertionError(f"(b) count {got_poly} != oracle {len(want_rows)}")
    if not np.array_equal(got_rows, want_rows):
        raise AssertionError(f"(c) rows differ from the oracle "
                             f"({len(got_rows)} vs {len(want_rows)})")
    for label, grid in (("store", got_d.weights), ("fused", fused_d[0])):
        if grid.dtype != np.float32 or grid.shape != (64, 64) \
                or not np.array_equal(grid, want_d.astype(np.float32)):
            raise AssertionError(f"(d) {label} grid differs from the oracle "
                                 f"(sum {grid.sum()} vs {want_d.sum()})")
    if fused_d[1] != len(rows_d):
        raise AssertionError(f"(d) fused count {fused_d[1]} != {len(rows_d)}")
    # (e): the device grid per cell within gamma(n_cell - 1) * sum|w| of the
    # exact f64 sum (val >= 0, so sum|w| is the oracle's own cell sum); the
    # store's grid comes back through the readback encoding the reference's
    # ladder picks for a weighted 256x256 grid (fp16), which adds at most
    # 2^-11 of each cell
    k = np.maximum(n_e - 1, 0) * 2.0 ** -24
    gam = k / (1 - k)
    err_raw = np.abs(raw_e.astype(np.float64) - want_e)
    if raw_e.shape != (256, 256) or not np.all(err_raw <= gam * want_e):
        raise AssertionError(f"(e) device grid off the oracle by "
                             f"{float(err_raw.max())}")
    err_e = np.abs(got_e.weights.astype(np.float64) - want_e)
    fp16 = 2.0 ** -11 if enc_e and enc_e[0] in ("fp16", "sparse") else 0.0
    tol_e = (gam * (1 + fp16) + fp16) * want_e
    if got_e.weights.shape != (256, 256) or not np.all(err_e <= tol_e):
        raise AssertionError(f"(e) store grid off the oracle by "
                             f"{float(err_e.max())} (encoding {enc_e})")
    if got_f_count != len(want_f) or not np.array_equal(got_f_rows, want_f):
        raise AssertionError(f"(f) {got_f_count} / {len(got_f_rows)} rows "
                             f"!= oracle {len(want_f)}")
    if got_inc != n:
        raise AssertionError(f"(f) INCLUDE count {got_inc} != {n}")
    q = per_query
    if device == "cuda" and (
            q["a"]["pip_refine"] != 0 or q["b"]["pip_refine"] < 1
            or q["c"]["pip_refine"] < 1 or q["d"]["grid_scatter"] < 1
            or q["d_fused"]["grid_scatter"] < 1 or q["e"]["grid_scatter"] < 1
            or q["e_device"]["grid_scatter"] < 1
            or launches["grid_scatter"] == 0
            or any(q[k]["fused_scan"] < 1
                   for k in ("d", "e", "e_device", "f_count", "f_select"))
            or q["f_select"]["ordered_compact"] < 1
            or q["f_include"]["box_count"] < 1
            or any(q[k]["block_gate"] < 1 or q[k]["fused_scan"] < 1
                   for k in ("a", "b", "c", "d_fused"))
            or q["a"]["ordered_compact"] != 0
            or q["b"]["ordered_compact"] < 1
            or q["c"]["ordered_compact"] < 1):
        raise AssertionError(f"kernel launches per query {json.dumps(q)}: "
                             "(b), (c) must launch pip_refine and (a) not; "
                             "(d), (d) fused and (e) grid_scatter; the "
                             "staged (d), (e), (f) count and select "
                             "fused_scan, (f)'s select ordered_compact, "
                             "INCLUDE box_count; (a), (b), (c) and (d) "
                             "fused block_gate and fused_scan; (b), (c) "
                             "ordered_compact and (a) not")
    routes = {lbl: "range-pruned" if planner._pruned_blocks(
        planner.plan(qq)) is not None else "full-mask"
        for lbl, qq in (("d", Q_D), ("e", Q_BOX), ("f", Q_F))}
    log(f"[main] (a) {got_box} (b) {got_poly} (c) {len(got_rows)} rows "
        f"(d) 64x64 grid of {int(got_d.weights.sum())} (store and fused) "
        f"(e) 256x256 val grid of {float(got_e.weights.sum())} (device grid "
        f"max cell error {float(err_raw.max())}; store grid through "
        f"{enc_e}, max cell error {float(err_e.max())}) (f) {got_f_count} "
        f"rows, INCLUDE {got_inc}: equal to the oracles")
    log(f"[main] densest (d) cell {int(want_d.max())} (< 2^24, so unit "
        f"grids compare byte for byte); staged routes {json.dumps(routes)}")
    log(f"[main] launches per query {json.dumps(per_query)}")

    for label, qq in (("box (a)", Q_BOX), ("polygon (b)", Q_POLY)):
        prog = compiled.Program(planner.plan(qq), "count")
        alive = int(prog._gate()[2][0])
        log(f"[main] {label}: {alive} of {-(-n // prog.bsz)} blocks alive; "
            f"candidates per launch {alive * prog.bsz}")

    p50 = {}
    for label, fn in queries(store):
        fn()
        ts = []
        for _ in range(REPS):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        p50[label] = float(np.median(ts))
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    log(json.dumps({"main_path": {
        "n": n, "device": device, "gen_s": gen_s, "load_s": load_s, "p50_ms": p50,
        "reps": REPS, "max_memory_allocated": peak,
        "load_peak_memory_allocated": load_peak, "load_split_s": split,
        "launches_checked_run": launches, "routes": routes}}))
    breakdown(store, sync)
    return launches, store, routes, g_oracle, f_oracle


def filters_oracle(x, y, val, tmask, n_concave: int) -> dict:
    """numpy answers of (h)-(k) over (a)'s week: f64 box predicates,
    ``np.hypot`` distances to the centre, and ``oracle_pip`` for the
    polygons (the concave polygon's own count is (b)'s, ``n_concave``)."""
    rt = np.flatnonzero(tmask)
    xt, yt = x[rt], y[rt]
    h_rows = rt[((xt >= -10) & (xt <= 30) & (yt >= 30) & (yt <= 55))
                | ((xt >= 60) & (xt <= 100) & (yt >= -10) & (yt <= 20)
                   & (val[rt] > 50))]
    dist = np.hypot(xt - I_CX, yt - I_CY)
    tri = np.flatnonzero((xt >= 60) & (xt <= 100) & (yt >= -10) & (yt <= 20))
    n_tri = int(np.count_nonzero(oracle_pip(xt[tri], yt[tri], TRIANGLE)))
    return {"h_rows": h_rows,
            "h_grid": oracle_density(x, y, h_rows, H_BBOX, 64, 64),
            "i_lt": rt[dist < I_R], "i_le": rt[dist <= I_R],
            "j": n_concave, "k_multi": n_concave + n_tri,
            "k_dwithin": int(np.count_nonzero(dist <= K_D))}


def filter_queries(store):
    """(h)-(k) as (label, zero-arg fn), for the checked run, the timings
    and the profile."""
    hint = density_hint(H_BBOX, 64, 64)
    return (("h_count", lambda: store.count("gdelt", Q_H)),
            ("h_rows", lambda: store.query("gdelt", Q_H).indices),
            ("h_density", lambda: store.query("gdelt", Q_H,
                                              hints=hint).weights),
            ("i_lt_count", lambda: store.count("gdelt", Q_I_LT)),
            ("i_lt_rows", lambda: store.query("gdelt", Q_I_LT).indices),
            ("i_le_count", lambda: store.count("gdelt", Q_I_LE)),
            ("i_le_rows", lambda: store.query("gdelt", Q_I_LE).indices),
            ("j_contains_count", lambda: store.count("gdelt",
                                                     Q_J_CONTAINS)),
            ("j_within_count", lambda: store.count("gdelt", Q_J_WITHIN)),
            ("k_multipolygon_count", lambda: store.count("gdelt",
                                                         Q_K_MULTI)),
            ("k_dwithin_count", lambda: store.count("gdelt", Q_K_DWITHIN)))


def phase_filters(store, oracle) -> dict:
    """(h)-(k) on the 100M-point store, each answer equal to its numpy
    oracle (counts and ascending rows exactly, the unit grid byte for
    byte), with every kernel's launches counted from 0 around the run:
    (i) must launch dist_refine, (j)'s st_contains pip_refine and (h)'s
    density grid_scatter. Returns the launches."""
    import torch
    from geomesa_tpu_torch.index import compiled
    from geomesa_tpu_torch.index.api import UnionScanPlan
    from geomesa_tpu_torch.kernels import (box_count, compact, density,
                                           dist, fused_scan, gate, pip)

    planner = store.planner("gdelt")
    plan_h = planner.plan(Q_H)
    if not isinstance(plan_h, UnionScanPlan) \
            or plan_h.same_index_device_exact() is None:
        raise AssertionError("(h) did not plan as a device-exact union")
    kinds = {q: (compiled.refine_spec(planner.plan(q)) or ("none",))[0]
             for q in (Q_I_LT, Q_I_LE, Q_J_CONTAINS, Q_J_WITHIN, Q_K_MULTI,
                       Q_K_DWITHIN)}
    counters = {"pip_refine": pip.pip_refine,
                "grid_scatter": density.grid_scatter,
                "box_count": box_count.box_count,
                "dist_refine": dist.dist_refine,
                "block_gate": gate.block_gate,
                "fused_scan": fused_scan.fused_scan,
                "ordered_compact": compact.ordered_compact}
    for c in counters.values():
        c.launches = 0
    per_query, got = {}, {}
    st0 = compiled.STATS["queries"]
    for label, fn in filter_queries(store):
        before = {k: c.launches for k, c in counters.items()}
        got[label] = fn()
        per_query[label] = {k: c.launches - before[k]
                            for k, c in counters.items()}
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    fused_runs = compiled.STATS["queries"] - st0

    o = oracle
    checks = {
        "h_count": got["h_count"] == len(o["h_rows"]),
        "h_rows": np.array_equal(got["h_rows"], o["h_rows"]),
        "h_density": got["h_density"].dtype == np.float32
        and np.array_equal(got["h_density"], o["h_grid"].astype(np.float32)),
        "i_lt_count": got["i_lt_count"] == len(o["i_lt"]),
        "i_lt_rows": np.array_equal(got["i_lt_rows"], o["i_lt"]),
        "i_le_count": got["i_le_count"] == len(o["i_le"]),
        "i_le_rows": np.array_equal(got["i_le_rows"], o["i_le"]),
        "j_contains_count": got["j_contains_count"] == o["j"],
        "j_within_count": got["j_within_count"] == o["j"],
        "k_multipolygon_count": got["k_multipolygon_count"] == o["k_multi"],
        "k_dwithin_count": got["k_dwithin_count"] == o["k_dwithin"]}
    if not all(checks.values()):
        raise AssertionError(f"(h)-(k) differ from their oracles: "
                             f"{[k for k, v in checks.items() if not v]}")
    q = per_query
    if store.device.type == "cuda" and (
            q["i_lt_count"]["dist_refine"] < 1
            or q["i_le_rows"]["dist_refine"] < 1
            or q["j_contains_count"]["pip_refine"] < 1
            or q["h_density"]["grid_scatter"] < 1
            or q["h_count"]["fused_scan"] != 1
            or any(q[k]["block_gate"] < 1 or q[k]["fused_scan"] < 1
                   for k in ("h_rows", "h_density", "i_lt_count",
                             "j_contains_count"))
            or q["i_le_rows"]["ordered_compact"] < 1
            or q["h_rows"]["ordered_compact"] < 1):
        raise AssertionError(f"kernel launches per query {json.dumps(q)}: "
                             "(i) must launch dist_refine, (j)'s st_contains "
                             "pip_refine, (h)'s density grid_scatter; "
                             "(h)'s count one fused_scan; the "
                             "union program (h) and the fused refines (i), "
                             "(j) block_gate and fused_scan; (h)'s and (i)'s "
                             "rows ordered_compact")
    sizes = {k: (int(v) if np.isscalar(v) else
                 (int(v.sum()) if k == "h_density" else len(v)))
             for k, v in got.items()}
    log(f"[filters] (h)-(k) equal to their oracles: {json.dumps(sizes)}; "
        f"refine kinds {json.dumps(list(kinds.values()))}; "
        f"{fused_runs} fused program runs")
    log(f"[filters] launches per query {json.dumps(per_query)}")

    # a query whose warm-up call takes over SLOW_MS (the host refines of
    # (j)'s WITHIN and (k)'s MULTIPOLYGON, (h)'s rows) times SLOW_REPS
    # calls, not REPS: they held (h)-(k) at over a minute
    p50, reps = {}, {}
    for label, fn in filter_queries(store):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        slow = (time.perf_counter() - t0) * 1e3 > SLOW_MS
        reps[label] = SLOW_REPS if slow else REPS
        ts = []
        for _ in range(reps[label]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        p50[label] = float(np.median(ts))
    log(json.dumps({"filters": {
        "p50_ms": p50, "reps": reps, "answers": sizes,
        "refine_kinds": {"i": kinds[Q_I_LT], "j_contains":
                         kinds[Q_J_CONTAINS], "j_within": kinds[Q_J_WITHIN],
                         "k_multipolygon": kinds[Q_K_MULTI],
                         "k_dwithin": kinds[Q_K_DWITHIN]},
        "launches_checked_run": launches}}))
    return launches


def band_points(cx: float, cy: float, r: float, n: int, seed: int):
    """f32 points: half at a distance within 4 ulps (of each coordinate) of
    r - DIST_BAND, r + DIST_BAND or r from (cx, cy), at random angles; half
    uniform over the square of side 4r around the centre."""
    from geomesa_tpu_torch.index.scan import DIST_BAND
    rng = np.random.default_rng(seed)
    cx, cy, r = np.float32(cx), np.float32(cy), np.float32(r)
    h = n // 2
    edge = np.array([r - DIST_BAND, r + DIST_BAND, r],
                    dtype=np.float32)[rng.integers(0, 3, h)]
    ang = rng.uniform(0, 2 * np.pi, h)
    px = np.empty(n, np.float32)
    py = np.empty(n, np.float32)
    px[:h] = cx + edge * np.cos(ang).astype(np.float32)
    py[:h] = cy + edge * np.sin(ang).astype(np.float32)
    px[:h] += rng.integers(-4, 5, h).astype(np.float32) * np.spacing(px[:h])
    py[:h] += rng.integers(-4, 5, h).astype(np.float32) * np.spacing(py[:h])
    px[h:] = rng.uniform(cx - 2 * r, cx + 2 * r, n - h)
    py[h:] = rng.uniform(cy - 2 * r, cy + 2 * r, n - h)
    return px, py


def dist_bound(n: int, live: int, n_starts: int, masked: bool) -> dict:
    """The least time the card could take for the dist refine and its
    counts on these inputs: bytes (the mask, the live rows' coordinates
    once, both flag outputs, the block starts, the two counts) over the HBM
    rate, against operations (live rows x DIST_OPS_PER_ROW) over the f32
    rate."""
    nbytes = (n if masked else 0) + live * 8 + 2 * n + n_starts * 8 + 8
    ops = live * DIST_OPS_PER_ROW
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes * 1e3, "ops_ms": t_ops * 1e3}


def compare_dist(label: str, tx, ty, bounds, reps: int, mask=None,
                 starts=None, bsz=None) -> dict:
    """dist_refine's kernel against its plain version on the same card
    tensors, with the (hit, uncertain) counts the fused program takes from
    the same launch: flags byte-equal, counts equal; both timed with CUDA
    events."""
    import torch
    from geomesa_tpu_torch.index.scan import dist_refine as plain
    from geomesa_tpu_torch.kernels import dist

    kw = {"mask": mask, "starts": starts, "bsz": bsz}
    khit, kunc, kcnt = dist.dist_refine(tx, ty, bounds, **kw)
    torch.cuda.synchronize()
    phit, punc, pcnt = plain(tx, ty, bounds, **kw)
    torch.cuda.synchronize()
    err = max(int((khit.to(torch.int8) - phit.to(torch.int8)).abs().max()),
              int((kunc.to(torch.int8) - punc.to(torch.int8)).abs().max())) \
        if khit.numel() else 0
    err = max(err, int((kcnt.long() - pcnt.long()).abs().max()))
    if err != 0 or not (torch.equal(khit, phit) and torch.equal(kunc, punc)
                        and torch.equal(kcnt, pcnt)):
        raise AssertionError(f"dist_refine {label}: kernel hit/unc/counts "
                             f"differ from the plain version")
    n = khit.shape[0]
    live = n if mask is None else int(mask.sum())
    acts, dev_ms = activities_per_call(
        lambda: dist.dist_refine(tx, ty, bounds, **kw))
    ms = cuda_ms(lambda: dist.dist_refine(tx, ty, bounds, **kw), reps)
    plain_ms = cuda_ms(lambda: plain(tx, ty, bounds, **kw),
                       max(1, reps // 10))
    r = {"label": label, "n": n, "live": live, "ms": ms,
         "plain_ms": plain_ms, "max_abs_err": err, "hit": int(pcnt[0]),
         "uncertain": int(pcnt[1]), "activities_per_call": acts,
         "device_ms_per_call": dev_ms,
         **dist_bound(n, live, 0 if starts is None else starts.shape[0],
                      mask is not None)}
    log(f"[kernel] dist_refine {label}: n={n} live={live} hit/unc and "
        f"counts equal (hit {r['hit']}, uncertain {r['uncertain']}), kernel "
        f"with counts {ms} ms, plain {plain_ms} ms, bound {r['bound_ms']} ms "
        f"({r['bound_by']}; bytes {r['bytes_ms']} ms, operations "
        f"{r['ops_ms']} ms), {acts} device activities a call ({dev_ms} ms "
        f"of device time)")
    return r


def phase_dist_kernel(store) -> list:
    """dist_refine against its plain version on the tensors query (i)'s
    fused refine hands it (the table's xf/yf, its candidates' mask and
    block starts, its circle), and on KERNEL_N points within a few ulps of
    r ± DIST_BAND, unmasked and under a 20% mask."""
    import torch
    from geomesa_tpu_torch.index import compiled, scan

    plan = store.planner("gdelt").plan(Q_I_LT)
    prog = compiled.Program(plan, "count_refine", unc_cap=4096,
                            refine=compiled.refine_spec(plan))
    m, starts = live_candidates(prog)
    cols = prog.index.device.columns
    out = [compare_dist("main-path (i)", cols["xf"], cols["yf"], prog.dist,
                        50, mask=m, starts=starts, bsz=prog.bsz)]
    dev = torch.device("cuda")
    px, py = band_points(I_CX, I_CY, I_R, KERNEL_N, 13)
    tx, ty = (torch.from_numpy(a).to(dev) for a in (px, py))
    cr = scan.dist_bounds(np.array([I_CX, I_CY, I_R], dtype=np.float32))
    out.append(compare_dist("near-band", tx, ty, cr, 20))
    m20 = torch.from_numpy(
        np.random.default_rng(14).random(KERNEL_N) < 0.2).to(dev)
    out.append(compare_dist("near-band random20", tx, ty, cr, 20, mask=m20))
    del tx, ty, m20
    torch.cuda.empty_cache()
    return out


def _equal_or_raise(label: str, got, want) -> int:
    """0 when every tensor of ``got`` equals its twin in ``want``; raises
    with the largest difference otherwise."""
    import torch
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    err = 0
    for a, b in zip(got, want):
        if a.shape != b.shape:
            raise AssertionError(f"{label}: shape {tuple(a.shape)} != plain "
                                 f"{tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: kernel differs from the plain "
                                 f"version (max abs err {err})")
    return err


def _bound(nbytes: float, ops: float) -> dict:
    """The least time for ``nbytes`` moved and ``ops`` operations on this
    card's published peaks (HBM rate; the f32 rate outside the tensor cores
    for f32 compares and, as the ALU's rate, for int32/int64 compares)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes * 1e3, "ops_ms": t_ops * 1e3,
            "bytes": nbytes, "ops": ops}


def _time_kernel(label: str, kern, plain, bound: dict, reps: int,
                 library=None, cut=None, got_rows=None) -> dict:
    """A kernel against its plain version on the same card tensors (equal,
    or the run fails; ``cut`` trims both results to what the kernel writes
    first; ``got_rows`` picks the kernel's rows that a plain version run on
    a slice of the inputs gives), then its time by CUDA events, its device
    activities and device time a call from the profiler, the plain
    version's time and the library call's."""
    import torch
    got = kern()
    torch.cuda.synchronize()
    want = plain()
    torch.cuda.synchronize()
    if cut is not None:
        got, want = cut(got), cut(want)
    if got_rows is not None:
        got = tuple(g[got_rows] for g in got) if isinstance(got, tuple) \
            else got[got_rows]
    err = _equal_or_raise(label, got, want)
    acts, dev_ms, by_kernel = activities_per_call(kern, 50, by_kernel=True)
    ms = cuda_ms(kern, reps)
    plain_ms = cuda_ms(plain, max(1, reps // 10))
    lib_ms = None if library is None else cuda_ms(library, max(1, reps // 5))
    r = {"label": label, "ms": ms, "plain_ms": plain_ms,
         "library_ms": lib_ms, "activities_per_call": acts,
         "device_ms_per_call": dev_ms, "device_ms_by_kernel": by_kernel,
         "max_abs_err": err, **bound}
    log(f"[kernel] {label}: equal to the plain version, kernel {ms} ms, "
        f"plain {plain_ms} ms, library {lib_ms} ms, bound {r['bound_ms']} ms "
        f"({r['bound_by']}; bytes {r['bytes_ms']} ms, operations "
        f"{r['ops_ms']} ms), {acts} device activities a call ({dev_ms} ms of "
        f"device time; by kernel, events recorded and mean ms: "
        f"{json.dumps(by_kernel)})")
    return r


def fused_kernel_inputs(store) -> dict:
    """The main path's tensors of block_gate, fused_scan and
    ordered_compact on the 100M store: the block summaries, (a)'s gate and
    (h)'s union program (its two-branch gate); (a)'s alive blocks and
    every block; (b)'s alive blocks, candidates' mask, its certain hits and
    uncertain rows (pip_refine), which (c)'s select compacts too."""
    import torch
    from geomesa_tpu_torch.index import compiled
    from geomesa_tpu_torch.kernels import gate, pip

    planner = store.planner("gdelt")
    idx = planner.indexes[0]
    cols = idx.device.columns
    dev = cols["xi"].device
    plan_a = planner.plan(Q_BOX)
    prog_a = compiled.Program(plan_a, "count")
    bsz, n = prog_a.bsz, prog_a.n
    summ = compiled.block_summaries(idx, bsz)
    nb = int(summ["bxmin"].shape[0])
    ids_a, _, nblk_a = gate.block_gate(summ, prog_a.qbuf, prog_a.query, n,
                                       bsz)
    prog_h = compiled.UnionProgram(planner.plan(Q_H), "select",
                                   sel_cap=1 << 16)
    plan_b = planner.plan(Q_POLY)
    prog_b = compiled.Program(plan_b, "count_refine", unc_cap=4096,
                              refine=compiled.refine_spec(plan_b))
    ids_b, starts_b, nblk_b = prog_b._gate()
    m_b, _, _ = prog_b._candidates()
    hit, unc = pip.pip_refine(cols["xf"], cols["yf"], prog_b.edges,
                              mask=m_b, starts=starts_b, bsz=bsz,
                              n_edges=prog_b.n_edges, n_blocks=nblk_b)
    return {"cols": cols, "dev": dev, "bsz": bsz, "n": n, "nb": nb,
            "summ": summ, "plan_a": plan_a, "prog_a": prog_a,
            "prog_h": prog_h,
            "ids_a": ids_a, "nblk_a": nblk_a,
            "ids_all": torch.arange(nb, dtype=torch.int32, device=dev),
            "nblk_all": torch.tensor([nb], dtype=torch.int32, device=dev),
            "prog_b": prog_b, "ids_b": ids_b, "starts_b": starts_b,
            "nblk_b": nblk_b, "hit": hit, "unc": unc,
            "sel": compiled._tier(None)}


def fused_kernel_calls(inp: dict, big_n: int = KERNEL_N) -> dict:
    """key → (label, kernel call, plain call, bound, reps, cut, library
    call) of fused_scan and ordered_compact at PERF.md §6's shapes — the
    count at (a)'s alive blocks and over every block, the mask at (b)'s,
    the compaction of (c)'s certain hits at its select capacity and of
    ``big_n`` candidates with 10% set — and more: (c)'s hits at cap 4,096
    (beside the select capacity: what the pad and the rows up to it
    cost), (b)'s two compactions (hits at cap 0, uncertain rows at cap
    4,096), ``big_n`` candidates with 1% and 50% set. ``cut``
    trims both results to what the kernel writes."""
    import torch
    from geomesa_tpu_torch.index import compiled, scan
    from geomesa_tpu_torch.kernels import compact, fused_scan

    cols, dev, bsz, n = inp["cols"], inp["dev"], inp["bsz"], inp["n"]
    plan_a, prog_a = inp["plan_a"], inp["prog_a"]
    q, qbuf = prog_a.query, prog_a.qbuf

    def scan_bound(k: int, ids_q, nblk_q) -> dict:
        """Bytes: the point planes of every candidate; the time planes of
        those in a box; the residual's columns of those in a box and a
        window (counted by the plain scan of the query cut to its boxes,
        and to its boxes and windows); the block ids; the count. Operations:
        one box's 4 key compares a candidate."""
        boxes, gate_, windows = plan_a.boxes_loose, compiled._gate_of(
            plan_a.explain["boxes"], len(plan_a.boxes_loose)), plan_a.windows
        prog = plan_a.residual_device.program
        counts = []
        for parts in ((boxes, gate_, None, None),
                      (boxes, gate_, windows, None)):
            qq = scan.FusedQuery([parts])
            counts.append(int(scan.fused_scan(
                cols, torch.from_numpy(qq.packed).to(dev), qq, ids_q,
                nblk_q, bsz, "count")[0]))
        rbytes = sum(cols[c].element_size() for c, _ in prog.slots)
        cand = k * bsz
        return _bound(16 * cand + 8 * counts[0] + rbytes * counts[1]
                      + 4 * k + 4, 4 * cand)

    out = {}
    k_a, nb = int(inp["nblk_a"][0]), inp["nb"]
    for key, label, ids, nblk, k, reps in (
            ("scan_a", f"fused_scan count at (a)'s {k_a} alive blocks",
             inp["ids_a"], inp["nblk_a"], k_a, 200),
            ("scan_all", f"fused_scan count over all {nb} blocks",
             inp["ids_all"], inp["nblk_all"], nb, 20)):
        args = (cols, qbuf, q, ids, nblk, bsz, "count")
        out[key] = (label, lambda args=args: fused_scan.fused_scan(*args),
                    lambda args=args: scan.fused_scan(*args),
                    scan_bound(k, ids, nblk), reps, None, None)
    prog_b, k_b = inp["prog_b"], int(inp["nblk_b"][0])
    args = (cols, prog_b.qbuf, prog_b.query, inp["ids_b"], inp["nblk_b"],
            bsz, "mask")
    out["scan_b_mask"] = (
        f"fused_scan mask at (b)'s {k_b} alive blocks",
        lambda: fused_scan.fused_scan(*args),
        lambda: scan.fused_scan(*args),
        _bound(16 * k_b * bsz + 4 * k_b + k_b * bsz + 4, 4 * k_b * bsz),
        100, lambda r: (r[0][: k_b * bsz], r[1]), None)

    kw = dict(starts=inp["starts_b"], bsz=bsz, n_blocks=inp["nblk_b"])
    for key, label, m, cap in (
            ("compact_c", f"ordered_compact at (c)'s certain hits ({k_b} "
             f"blocks, cap {inp['sel']})", inp["hit"], inp["sel"]),
            ("compact_c_cap4096", f"ordered_compact at (c)'s certain hits "
             f"({k_b} blocks, cap 4096)", inp["hit"], 4096),
            ("compact_b_hits", f"ordered_compact at (b)'s certain hits "
             f"({k_b} blocks, cap 0)", inp["hit"], 0),
            ("compact_b_unc", f"ordered_compact at (b)'s uncertain rows "
             f"({k_b} blocks, cap 4096)", inp["unc"], 4096)):
        live = m[: k_b * bsz]
        out[key] = (label,
                    lambda m=m, cap=cap: compact.ordered_compact(m, cap, n,
                                                                 **kw),
                    lambda m=m, cap=cap: scan.ordered_compact(m, cap, n,
                                                              **kw),
                    _bound(k_b * bsz + 8 * k_b + 4 * cap + 4, 0), 100, None,
                    lambda live=live: torch.nonzero(live))
    cap = 1 << 16
    for key, pct, seed in (("compact_big", 10, 21), ("compact_big1", 1, 22),
                           ("compact_big50", 50, 23)):
        big = torch.from_numpy(np.random.default_rng(seed).random(big_n)
                               < pct / 100).to(dev)
        out[key] = (f"ordered_compact over {big_n} candidates ({pct}% set, "
                    f"cap {cap})",
                    lambda big=big: compact.ordered_compact(big, cap, n),
                    lambda big=big: scan.ordered_compact(big, cap, n),
                    _bound(big_n + 4 * cap + 4, 0), 50, None,
                    lambda big=big: torch.nonzero(big))
    return out


def gate_summaries(summ: dict, nb: int, seed: int) -> dict:
    """Summaries of ``nb`` blocks resampled from the table's ``summ``: the
    blocks drawn from ``seed`` with replacement and kept in table order, so
    each block's envelope (its centre and widths) and bin range are a real
    block's, and Z order's runs of neighbouring blocks stay runs, as in a
    table of the same data with more rows."""
    import torch
    rng = np.random.default_rng(seed)
    src = int(summ["bxmin"].shape[0])
    pick = torch.from_numpy(np.sort(rng.integers(0, src, nb))).to(
        summ["bxmin"].device)
    return {k: v.index_select(0, pick) for k, v in summ.items()}


def gate_bound(nb: int, summ: dict, qbuf, query) -> dict:
    """Bytes: the summaries (16 B a block, 24 with bins), the ids and
    starts of every block (12 B, the pad too), the count, the query
    buffer. Operations: 4 f32 compares a (block, gate box) and 3 int
    compares a (block, window)."""
    nbox = sum(b[1] for b in query.branches)
    nwin = sum(b[3] for b in query.branches)
    return _bound(nb * (16 + (8 if "binmin" in summ else 0)) + nb * 12 + 4
                  + qbuf.numel(), nb * (4 * nbox + 3 * nwin))


def gate_calls(inp: dict) -> dict:
    """key → (label, kernel call, plain call, bound, reps) of block_gate at
    its three shapes: (a)'s gate over the 100M table's blocks, (h)'s
    two-branch union gate over them, and (a)'s gate over GATE_BLOCKS
    blocks resampled from the table's (``gate_summaries``, a billion-row
    table at 4,096 rows a block); each label ends with the shape's alive
    blocks, as the plain version counts them."""
    from geomesa_tpu_torch.index import scan
    from geomesa_tpu_torch.kernels import gate

    summ, nb, n, bsz = inp["summ"], inp["nb"], inp["n"], inp["bsz"]
    pa, ph = inp["prog_a"], inp["prog_h"]
    big = gate_summaries(summ, GATE_BLOCKS, GATE_SEED)
    out = {}
    for key, label, sm, q, qbuf, rows in (
            ("gate_a", f"block_gate over {nb} blocks x (a)'s gate", summ,
             pa.query, pa.qbuf, n),
            ("gate_h", f"block_gate over {nb} blocks x (h)'s two-branch "
             f"union gate", summ, ph.query, ph.qbuf, n),
            ("gate_big", f"block_gate over {GATE_BLOCKS} blocks resampled "
             f"from the table's x (a)'s gate", big, pa.query, pa.qbuf,
             GATE_ROWS)):
        args = (sm, qbuf, q, rows, bsz)
        alive = int(scan.block_gate(*args)[2][0])
        label = f"{label} ({alive} alive)"
        out[key] = (label, lambda args=args: gate.block_gate(*args),
                    lambda args=args: scan.block_gate(*args),
                    gate_bound(int(sm["bxmin"].shape[0]), sm, qbuf, q), 200)
    return out


def kernel_resources(name: str) -> dict:
    """function → {"registers", "stack", "local"} of a built kernel, read
    with ``cuobjdump -res-usage`` (a spill shows as stack and local bytes);
    {} when the toolkit's cuobjdump is missing or refuses."""
    from geomesa_tpu_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    run = subprocess.run([tool, "-res-usage", build._target(name)[1]],
                         capture_output=True, text=True)
    if run.returncode != 0:
        return {}
    text = run.stdout
    out = {}
    for fn, res in re.findall(r"Function (\S+):\s*\n\s*(.*)", text):
        got = dict(re.findall(r"(REG|STACK|LOCAL):(\d+)", res))
        out[fn] = {"registers": int(got.get("REG", -1)),
                   "stack": int(got.get("STACK", -1)),
                   "local": int(got.get("LOCAL", -1))}
    return out


def gate_host_split(summ: dict, prog, n: int, bsz: int,
                    reps: int = 2000) -> dict:
    """Host ms a call of the gate's wrapper on ``summ`` with ``prog``'s
    gate, and of its parts: the input checks, the ctypes launch replayed
    with the wrapper's own arguments, and the three ``torch.empty`` of the
    outputs."""
    import torch
    from geomesa_tpu_torch.kernels import gate
    args = (summ, prog.qbuf, prog.query, n, bsz)
    real = gate._bind()
    seen = []

    def spy(packed, stream):
        seen[:] = [packed, stream]
        return real(packed, stream)
    gate._FN = spy
    try:
        gate.block_gate(*args)
    finally:
        gate._FN = real
    nb, dev = int(summ["bxmin"].shape[0]), summ["bxmin"].device

    def empties():
        return (torch.empty(nb, dtype=torch.int32, device=dev),
                torch.empty(nb, dtype=torch.int64, device=dev),
                torch.empty(1, dtype=torch.int32, device=dev))
    out = {key: host_ms(fn, reps) for key, fn in (
        ("wrapper_ms", lambda: gate.block_gate(*args)),
        ("checks_ms", lambda: gate._check(summ, prog.qbuf, bsz)),
        ("launch_ms", lambda: real(*seen)), ("empty_ms", empties))}
    log(f"[kernel] block_gate host ms a call: {json.dumps(out)}")
    return out


def phase_fused_kernels(store) -> dict:
    """block_gate, fused_scan and ordered_compact against their plain
    versions on the main path's tensors (``fused_kernel_inputs``): the
    gate at its three shapes (``gate_calls``) and its wrapper's host time
    by part (``gate_host_split``); then ``fused_kernel_calls``, with
    ``torch.nonzero``'s time beside each compaction; and the three
    kernels' registers and spills."""
    from geomesa_tpu_torch.kernels import compact, fused_scan, gate

    inp = fused_kernel_inputs(store)
    out = {}

    # the gate: summaries in, ids and starts out
    g_calls = gate_calls(inp)
    out["block_gate"] = [
        _time_kernel(label, kern, plain, bound, reps)
        for label, kern, plain, bound, reps in g_calls.values()]
    out["block_gate_host"] = gate_host_split(inp["summ"], inp["prog_a"],
                                             inp["n"], inp["bsz"])
    log(f"[kernel] block_gate: one cluster of {gate.CLUSTER} CTAs of "
        f"{gate.THREADS} threads; resources "
        f"{json.dumps(kernel_resources(gate.NAME))}")
    del g_calls
    calls = fused_kernel_calls(inp)
    for mod, prefix in ((fused_scan, "scan"), (compact, "compact")):
        out[mod.NAME] = [
            _time_kernel(label, kern, plain, bound, reps, library=lib,
                         cut=cut)
            for key, (label, kern, plain, bound, reps, cut, lib)
            in calls.items() if key.startswith(prefix)]
        log(f"[kernel] {mod.NAME} resources: "
            f"{json.dumps(kernel_resources(mod.NAME))}")
    del calls, inp
    import torch
    torch.cuda.empty_cache()
    return out


class plain_kernels:
    """A context in which the wrappers of ``fused_scan``, ``ordered_compact``
    and ``grid_scatter`` run their plain PyTorch versions (on the card's
    tensors): the staged modes' dispatchers, prepared and called inside it,
    are their kernel route's yardstick."""

    def __enter__(self):
        from geomesa_tpu_torch.index import scan
        from geomesa_tpu_torch.kernels import compact, density, fused_scan

        def compact_plain(mask, cap, fill, starts=None, bsz=None,
                          n_blocks=None, count_out=None, rows_out=None):
            c, r = scan.ordered_compact(mask, cap, fill, starts, bsz,
                                        n_blocks)
            if count_out is None:
                return c, r
            count_out.copy_(c)
            rows_out.copy_(r)
            return count_out, rows_out

        self.saved = [(fused_scan, "fused_scan", fused_scan.fused_scan),
                      (compact, "ordered_compact", compact.ordered_compact),
                      (density, "grid_scatter", density.grid_scatter)]
        fused_scan.fused_scan = scan.fused_scan
        compact.ordered_compact = compact_plain
        density.grid_scatter = scan.grid_scatter
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def staged_mode_calls(store) -> dict:
    """key → (label, kernel-route dispatcher, plain dispatcher, bound,
    reps, cut) of the staged modes at the main path's shapes on the 100M
    store, each prepared through ``ScanKernels`` as the main path prepares
    it: (f)'s count (no box, (f)'s week and ``val > 90``, over all
    24,415 blocks), (f)'s packed select and row mask, (d)'s 64x64 density
    and (e)'s 256x256 density on the routes the planner gives them (unit
    weights), and (h)'s OR count (one two-branch ``fused_scan``). The plain
    dispatcher is the same one prepared and run in ``plain_kernels``."""
    import torch
    from geomesa_tpu_torch.index import prune, scan

    planner = store.planner("gdelt")
    kern = planner.indexes[0].kernels
    cols, n = kern.cols, kern.n
    bsz = int(prune.BLOCK_SIZE)

    def args(q):
        p = planner.plan(q)
        return (p.primary_kind, p.boxes_loose, p.windows, p.residual_device)

    def both(make):
        disp = make()
        with plain_kernels():
            plain = make()

        def run_plain():
            with plain_kernels():
                return plain()
        return disp, run_plain

    def cand_bound(stages, blocks, extra_bytes: float) -> dict:
        """Bytes: the point planes of every candidate (when a stage has
        boxes), the time planes of
        those in a box and the residual's columns of those in a box and a
        window (the plain scan of the stages cut to their boxes, and to
        their boxes and windows), the block ids and ``extra_bytes`` (the
        mode's mask, rows, grid); operations: a box's 4 key compares a
        candidate."""
        sc = kern._scan(stages, blocks, None if blocks is None else bsz)
        k = int(sc.n_blocks[0])
        cand = k * sc.bsz
        counts = []
        for cut in (lambda st: (*st[:2], None, None),
                    lambda st: (*st[:3], None)):
            qq = scan.staged_query(cols, [cut(st) for st in stages])
            counts.append(int(scan.fused_scan(
                cols, torch.from_numpy(qq.packed).to(sc.ids.device), qq,
                sc.ids, sc.n_blocks, sc.bsz, "count")[0]))
        rbytes = sum(cols[c].element_size() for c, _ in sc.query.slots)
        planes = 16 * cand if sc.query.points else 0   # none without boxes
        return _bound(planes + 8 * counts[0] + rbytes * counts[1] + 4 * k
                      + extra_bytes, 4 * cand), cand

    out = {}
    f = args(Q_F)
    nb = -(-n // bsz)
    bnd, cand = cand_bound([f], None, 4)
    out["f_count"] = (f"staged count (f) over all {nb} blocks",
                      *both(lambda: kern.prepare_count(*f)), bnd, 20, None)
    cap = 1 << 22
    bnd, _ = cand_bound([f], None, 2 * cand + 4 * cap + 4)
    out["f_select"] = (f"staged select (f) over all {nb} blocks, cap {cap}",
                       *both(lambda: kern.prepare_select(*f, cap)), bnd, 10,
                       None)
    bnd, _ = cand_bound([f], None, 2 * cand + 2 * n)
    out["f_mask"] = (f"staged row mask (f) over all {nb} blocks",
                     *both(lambda: kern.prepare_mask(*f)), bnd, 10, None)
    for key, q, bbox, w, h in (("d_density", Q_D, D_BBOX, 64, 64),
                               ("e_density", Q_BOX, E_BBOX, 256, 256)):
        a = args(q)
        blocks = planner._pruned_blocks(planner.plan(q))
        if blocks is None:
            make = (lambda a=a, bbox=bbox, w=w, h=h:
                    kern.prepare_density_compact(*a, bbox, w, h, 1 << 17,
                                                 None))
            route = f"the table's {nb} blocks"
        else:
            make = (lambda a=a, bbox=bbox, w=w, h=h, blocks=blocks:
                    kern.prepare_density_blocks(*a, bbox, w, h, blocks, bsz,
                                                None))
            route = f"the range cover's {len(blocks)} blocks"
        bnd, cand = cand_bound([a], blocks, 0)
        live = int(make()()[1])
        bnd = _bound(bnd["bytes"] + 2 * cand + 8 * live + 4 * w * h,
                     bnd["ops"] + live * SCATTER_OPS_PER_ROW)
        out[key] = (f"staged density ({key[0]}) {w}x{h} over {route}",
                    *both(make), bnd, 20, None)
    hs = planner._union_stages(planner.plan(Q_H), None)
    bnd, _ = cand_bound(hs, None, 4)
    out["h_count"] = (f"staged OR count (h), {len(hs)} branches over all "
                      f"{nb} blocks",
                      *both(lambda: kern.prepare_union_count(hs)), bnd, 20,
                      None)
    return out


def phase_staged_kernels(store) -> list:
    """Each staged mode of the main path on its kernel route against the
    same mode with the plain versions of its kernels, on the 100M store
    (``staged_mode_calls``): equal, or the run fails; with CUDA-event
    times, device activities and device time a call, and the bound. Then
    (e)'s ``val`` density on its route, within the f32 summation bound of
    the plain version's grid."""
    import torch
    from geomesa_tpu_torch.index import prune, scan
    from geomesa_tpu_torch.kernels import fused_scan

    fused_scan.fused_scan.launches = 0
    calls = staged_mode_calls(store)
    rows = [_time_kernel(label, kern, plain, bound, reps, cut=cut)
            for label, kern, plain, bound, reps, cut in calls.values()]
    if fused_scan.fused_scan.launches == 0:
        raise AssertionError("the staged modes launched no fused_scan")
    planner = store.planner("gdelt")
    kern = planner.indexes[0].kernels
    p = planner.plan(Q_BOX)
    a = (p.primary_kind, p.boxes_loose, p.windows, p.residual_device)
    blocks = planner._pruned_blocks(p)

    def make(wname):
        if blocks is None:
            return kern.prepare_density_compact(*a, E_BBOX, 256, 256,
                                                1 << 17, wname)
        return kern.prepare_density_blocks(*a, E_BBOX, 256, 256, blocks,
                                           int(prune.BLOCK_SIZE), wname)
    kg, kc = make("val")()
    with plain_kernels():
        pg, pc = make("val")()
        unit, _ = make(None)()
    torch.cuda.synchronize()
    k = (unit.double() - 1).clamp_min(0) * 2.0 ** -24
    tol = 2 * k / (1 - k) * pg.double()   # val >= 0: sum|w| is the grid
    err = float((kg.double() - pg.double()).abs().max())
    if int(kc) != int(pc) or bool(((kg.double() - pg.double()).abs()
                                   > tol).any()):
        raise AssertionError(f"staged density (e) val: kernel route off the "
                             f"plain version (count {int(kc)} vs {int(pc)}, "
                             f"max abs err {err})")
    log(f"[staged] (e) val-weighted 256x256 on its route: count {int(kc)}, "
        f"within the f32 bound of the plain version (max abs err {err})")
    rows.append({"label": "staged density (e) 256x256 val", "count": int(kc),
                 "max_abs_err": err})
    del calls
    torch.cuda.empty_cache()
    return rows


def serving_oracle(x, y, dtg) -> dict:
    """numpy counts of (g)'s cold and batch queries: f64 box predicates
    and the exclusive DURING bounds over the raw columns, each box over
    the rows of its time window inside the union of the boxes."""
    out = {}
    for key, boxes, days in (("cold", COLD_BOXES, COLD_DAYS),
                             ("batch", BATCH_BOXES, BATCH_DAYS)):
        lo, hi = (np.datetime64(d, "ms").astype(np.int64) for d in days)
        b = np.asarray(boxes)
        rows = np.flatnonzero(
            (dtg > lo) & (dtg < hi) & (x >= b[:, 0].min())
            & (x <= b[:, 2].max()) & (y >= b[:, 1].min())
            & (y <= b[:, 3].max()))
        xs, ys = x[rows], y[rows]
        out[key] = [int(np.count_nonzero((xs >= q[0]) & (xs <= q[2])
                                         & (ys >= q[1]) & (ys <= q[3])))
                    for q in boxes]
    return out


def run_clients(fn, queries_, wants, reps: int, timeout: float = 300.0):
    """``G_THREADS`` client threads released together, client i asking
    ``queries_[i % len]`` ``reps`` times through ``fn``: (per-call seconds,
    wall seconds). Every answer must equal its oracle; a client's error is
    raised here."""
    import threading
    lats, errs = [], []
    lock = threading.Lock()
    barrier = threading.Barrier(G_THREADS + 1)

    def client(i):
        q, want = queries_[i % len(queries_)], wants[i % len(wants)]
        mine = []
        try:
            barrier.wait()
            for _ in range(reps):
                t0 = time.perf_counter()
                got = fn(q)
                mine.append(time.perf_counter() - t0)
                if got != want:
                    raise AssertionError(f"{q}: {got} != oracle {want}")
        except Exception as e:  # raised below, after the join
            with lock:
                errs.append(e)
        with lock:
            lats.extend(mine)

    ths = [threading.Thread(target=client, args=(i,))
           for i in range(G_THREADS)]
    for th in ths:
        th.start()
    barrier.wait()
    t0 = time.perf_counter()
    for th in ths:
        th.join(timeout=timeout)
    wall = time.perf_counter() - t0
    if any(th.is_alive() for th in ths):
        raise AssertionError("a client thread did not finish")
    if errs:
        raise errs[0]
    return lats, wall


def p50_ms(samples) -> float:
    return float(np.median(np.asarray(samples) * 1e3))


def phase_serving(store, oracle) -> dict:
    """(g): the serving path on the 100M-point store, every answer equal to
    its numpy oracle, with box_count's launches counted from 0 around it.
    Returns the measurements and (g3)'s dispatch inputs."""
    import torch
    from geomesa_tpu_torch.index import compiled, prune, scan
    from geomesa_tpu_torch.kernels import box_count, fused_scan, gate
    from geomesa_tpu_torch.serve.scheduler import (PlannerBinding,
                                                   QueryScheduler)

    planner = store.planner("gdelt")
    sync = torch.cuda.synchronize
    r = {}
    box_count.box_count.launches = 0

    # (g1) prepared count of (a): blocking, then 64 count_async calls and
    # one stacked readback
    want = oracle["a"]
    pq = planner.prepare(Q_BOX)
    r["g1_handle"] = type(pq).__name__
    r["g1_fused"] = getattr(pq, "_fused", None) is not None
    if not r["g1_fused"]:
        raise AssertionError(f"(g1) prepared {r['g1_handle']} is not the "
                             "fused program")
    ts = []
    for _ in range(REPS + 1):
        t0 = time.perf_counter()
        got = pq.count()
        ts.append(time.perf_counter() - t0)
        if got != want:
            raise AssertionError(f"(g1) count {got} != oracle {want}")
    r["g1_blocking_p50_ms"] = p50_ms(ts[1:])

    def pipeline():
        return torch.stack([pq.count_async() for _ in range(64)]).cpu()

    pipeline()
    sync()
    d0 = scan.ROUNDS.dispatches
    l0 = (gate.block_gate.launches, fused_scan.fused_scan.launches)
    t0 = time.perf_counter()
    total = pipeline().numpy()
    wall = time.perf_counter() - t0
    if not (total == want).all():
        raise AssertionError(f"(g1) pipelined counts {set(total.tolist())} "
                             f"!= oracle {want}")
    r["g1_pipelined_per_query_ms"] = wall * 1e3 / 64
    r["g1_pipelined_readbacks"] = scan.ROUNDS.dispatches - d0
    r["g1_pipelined_launches"] = {
        "block_gate": gate.block_gate.launches - l0[0],
        "fused_scan": fused_scan.fused_scan.launches - l0[1]}
    if min(r["g1_pipelined_launches"].values()) < 64:
        raise AssertionError(f"(g1) 64 count_async calls launched "
                             f"{r['g1_pipelined_launches']}: each must "
                             "launch block_gate and fused_scan")
    # host syncs, by CUDA's sync debug mode around the 64 calls (apart
    # from the timed run: the check slows the host)
    sync()
    with scan.host_syncs("cuda") as hs:
        futs = [pq.count_async() for _ in range(64)]
    total = torch.stack(futs).cpu().numpy()
    if not (total == want).all():
        raise AssertionError(f"(g1) counts {set(total.tolist())} under the "
                             f"sync check != oracle {want}")
    r["g1_pipelined_host_syncs_per_query"] = hs.count / 64
    if hs.count:
        raise AssertionError(f"(g1) count_async made {hs.count} host syncs "
                             "in 64 calls; the fused program makes none")

    # (g2) never-seen boxes: prepare (the recipe fast path after the
    # shape's first query) + blocking count, end to end
    st0 = dict(compiled.STATS)
    prep, tot, kinds = [], [], []
    for box, want_c in zip(COLD_BOXES, oracle["cold"]):
        q = box_query(box, COLD_DAYS)
        t0 = time.perf_counter()
        pqc = planner.prepare(q)
        t1 = time.perf_counter()
        got = pqc.count()
        tot.append(time.perf_counter() - t0)
        prep.append(t1 - t0)
        kinds.append(type(pqc).__name__)
        if got != want_c:
            raise AssertionError(f"(g2) {q}: {got} != oracle {want_c}")
    r["g2_prepare_p50_ms"] = p50_ms(prep)
    r["g2_cold_query_p50_ms"] = p50_ms(tot)
    r["g2_stats"] = {k: compiled.STATS[k] - st0[k] for k in st0}
    r["g2_handles"] = kinds
    if r["g2_stats"]["shape_hits"] < 9:
        raise AssertionError(f"(g2) recipe stats {r['g2_stats']}: expected "
                             "at least 9 shape hits")

    # (g3) 64 distinct boxes in one dispatch over the union of their covers
    bqueries = [box_query(b, BATCH_DAYS) for b in BATCH_BOXES]
    wants = np.asarray(oracle["batch"], dtype=np.int64)
    t0 = time.perf_counter()
    plans = [planner.plan(q) for q in bqueries]
    blocks = [planner._pruned_blocks(p) for p in plans]
    if any(b is None for b in blocks):
        raise AssertionError("(g3) a batch box's cover declined pruning")
    union = np.unique(np.concatenate(blocks)).astype(np.int32)
    boxes64 = np.concatenate([p.boxes_loose[:1] for p in plans])
    r["g3_prep_ms"] = (time.perf_counter() - t0) * 1e3
    r["g3_union_blocks"] = int(len(union))
    lead = plans[0]
    kern = lead.index.kernels
    bsz = int(prune.BLOCK_SIZE)
    disp = kern.prepare_counts_multi_blocks(
        "point_boxes", boxes64, lead.windows, lead.residual_device, union,
        bsz)
    got = disp().cpu().numpy()[:64]
    if not np.array_equal(got, wants):
        raise AssertionError(f"(g3) batch counts differ from the oracle at "
                             f"{np.flatnonzero(got != wants).tolist()}")
    nb = 16
    outs = [disp() for _ in range(nb)]
    sync()
    t0 = time.perf_counter()
    outs = [disp() for _ in range(nb)]
    sync()
    r["g3_batch64_per_query_ms"] =         (time.perf_counter() - t0) * 1e3 / (nb * 64)
    if not all(np.array_equal(o.cpu().numpy()[:64], wants) for o in outs):
        raise AssertionError("(g3) a timed batch differs from the oracle")
    full = kern.counts_multi("point_boxes", boxes64, lead.windows,
                             lead.residual_device)
    if not np.array_equal(full, wants):
        raise AssertionError("(g3) full-table counts_multi differs from the "
                             "oracle")
    # the scheduler reads a batch's counts back through pinned memory and
    # a CUDA event; the pageable copy beside it
    t = disp()
    sync()
    ts_pg, ts_pin = [], []
    for _ in range(100):
        t0 = time.perf_counter()
        t.cpu()
        ts_pg.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        scan.Readback(t).wait()
        ts_pin.append(time.perf_counter() - t0)
    r["g4_readback"] = {"form": "pinned + CUDA event",
                        "pinned_event_p50_ms": p50_ms(ts_pin),
                        "pageable_cpu_p50_ms": p50_ms(ts_pg)}

    # (g4) the micro-batching scheduler under 64 client threads, then the
    # unbatched per-request path, then the store's own scheduler
    sched = QueryScheduler(PlannerBinding({"gdelt": planner}),
                           flush_size=64, window_us=8000)
    try:
        if sched.count_many("gdelt", bqueries, timeout=300) != wants.tolist():
            raise AssertionError("(g4) scheduler warm-up differs from the "
                                 "oracle")
        lat, wall = run_clients(
            lambda q: sched.count("gdelt", q, timeout=300), bqueries,
            wants.tolist(), 8)
        st = sched.stats()
    finally:
        sched.shutdown()
    r["g4_scheduler_qps"] = len(lat) / wall
    r["g4_scheduler_p50_ms"] = p50_ms(lat)
    r["g4_plan_cache_hit_rate"] = st["plan_cache"]["hit_rate"]
    r["g4_flush_reasons"] = st["flush_reasons"]
    r["g4_mean_batch"] = st["queries"] / max(1, st["batches"])
    r["g4_batches"] = st["batches"]
    for q in bqueries[:4]:
        planner.count(q)
    lat_u, wall_u = run_clients(lambda q: planner.count(q), bqueries,
                                wants.tolist(), 2)
    r["g4_unbatched_qps"] = len(lat_u) / wall_u
    r["g4_unbatched_p50_ms"] = p50_ms(lat_u)
    t0 = time.perf_counter()
    if store.count_many("gdelt", bqueries) != wants.tolist():
        raise AssertionError("(g4) store.count_many differs from the oracle")
    r["g4_store_count_many_ms"] = (time.perf_counter() - t0) * 1e3
    sync()
    r["box_count_launches"] = box_count.box_count.launches
    if kern.device.type == "cuda" and r["box_count_launches"] == 0:
        raise AssertionError("(g) launched no box_count kernel")
    log(json.dumps({"serving": r}))
    return {"r": r, "pq": pq, "disp": disp, "boxes64": boxes64,
            "windows": lead.windows, "union": union, "bsz": bsz}


def write_batch(k: int, seed: int = L_SEED):
    """Batch k of phase (l): L_BATCH rows from (seed, k), half inside (a)'s
    box and week, half over the globe and the corpus's month; name from
    the corpus's 3 values, val from integers(0, 100)."""
    rng = np.random.default_rng([seed, k])
    n, h = L_BATCH, L_BATCH // 2
    lo, hi = (np.datetime64(d, "ms").astype(np.int64)
              for d in ("2020-01-05", "2020-01-12"))
    base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
    x = np.concatenate([rng.uniform(QX0, QX1, h), rng.uniform(-180, 180,
                                                              n - h)])
    y = np.concatenate([rng.uniform(QY0, QY1, h), rng.uniform(-90, 90,
                                                              n - h)])
    dtg = np.concatenate([rng.integers(lo + 1, hi, h),
                          base + rng.integers(0, 30 * 86400000, n - h)])
    return (x, y, dtg, rng.integers(0, 3, n).astype(np.int32),
            rng.integers(0, 100, n).astype(np.int32))


def oracle_host_density(x, y, rows, bbox, width: int, height: int):
    """The delta tier's density, written out: the selected rows' f64
    coordinates snapped in f64 (fx = (x - xmin) / (xmax - xmin); a row
    counts when 0 <= fx < 1 and 0 <= fy < 1, in cell (int(fy*H),
    int(fx*W)) clipped), counted per cell."""
    xmin, ymin, xmax, ymax = (float(v) for v in bbox)
    fx = (x[rows] - xmin) / (xmax - xmin)
    fy = (y[rows] - ymin) / (ymax - ymin)
    inb = (fx >= 0) & (fx < 1) & (fy >= 0) & (fy < 1)
    ix = np.clip((fx[inb] * width).astype(np.int64), 0, width - 1)
    iy = np.clip((fy[inb] * height).astype(np.int64), 0, height - 1)
    return np.bincount(iy * width + ix, minlength=width * height).reshape(
        height, width)


def delta_oracle(x, y, dtg, val, m: int) -> dict:
    """numpy answers of (a), (b)/(c), (d)'s rows and (g3)'s 64 boxes over
    the first m appended rows (row ids within the delta)."""
    x, y, dtg, val = x[:m], y[:m], dtg[:m], val[:m]

    def during(a, b):
        return (dtg > np.datetime64(a, "ms").astype(np.int64)) \
            & (dtg < np.datetime64(b, "ms").astype(np.int64))

    tmask = during("2020-01-05", "2020-01-12")
    a = int(np.count_nonzero(tmask & (x >= -10) & (x <= 30) & (y >= 30)
                             & (y <= 55) & (val > 10)))
    cand = np.flatnonzero(tmask & (x >= -10) & (x <= 40) & (y >= 20)
                          & (y <= 60))
    rows_d = np.flatnonzero(during("2020-01-03", "2020-01-15") & (x >= -60)
                            & (x <= 60) & (y >= -30) & (y <= 30) & (val > 10))
    b = np.asarray(BATCH_BOXES)
    lo, hi = (np.datetime64(d, "ms").astype(np.int64) for d in BATCH_DAYS)
    inb = (dtg > lo) & (dtg < hi)
    batch = [int(np.count_nonzero(inb & (x >= q[0]) & (x <= q[2])
                                  & (y >= q[1]) & (y <= q[3])))
             for q in b]
    return {"a": a, "b_rows": cand[oracle_pip(x[cand], y[cand], CONCAVE)],
            "rows_d": rows_d, "batch": batch}


def write_queries(store):
    """Phase (l)'s queries as (label, zero-arg fn)."""
    bq = [box_query(b, BATCH_DAYS) for b in BATCH_BOXES]
    return (("a", lambda: store.count("gdelt", Q_BOX)),
            ("b", lambda: store.count("gdelt", Q_POLY)),
            ("c", lambda: store.query("gdelt", Q_POLY).indices),
            ("d", lambda: store.query(
                "gdelt", Q_D, hints=density_hint(D_BBOX, 64, 64)).weights),
            ("g3_count_many", lambda: store.count_many("gdelt", bq)))


def check_write_answers(label, got, want) -> None:
    bad = [k for k in want if not (
        np.array_equal(got[k], want[k]) if isinstance(want[k], np.ndarray)
        else got[k] == want[k])]
    if bad:
        raise AssertionError(f"(l) {label}: {bad} differ from their "
                             f"oracles")
    if got["d"].dtype != np.float32:
        raise AssertionError(f"(l) {label}: density grid {got['d'].dtype}")


def merge_bound(olds, n_delta: int) -> dict:
    """The least time the card could take for the merge: every column's
    n_old + n_delta elements read once and n_new written once, plus the
    int32 ranks, over the HBM rate (no arithmetic to speak of)."""
    n_new = int(olds[0].shape[0]) + n_delta
    nbytes = sum(2 * n_new * o.element_size() for o in olds) + 4 * n_delta
    return {"bound_ms": nbytes / PEAK_BYTES_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes}


def compare_merge(old_idx, new_idx) -> dict:
    """merge_scatter's kernel against its plain version at the flush's own
    shape and inputs: the resident columns and permutation of the index
    before the flush, and the delta rows and ranks read back out of the
    merged index (the delta rows are those whose table row is past the
    old table; their merged positions give the ranks). Both must equal
    the merged index's columns byte for byte; both timed with CUDA
    events."""
    import torch
    from geomesa_tpu_torch.index import device
    from geomesa_tpu_torch.kernels import merge

    n_old = int(old_idx.perm.shape[0])
    pos_del = torch.nonzero(new_idx.perm >= n_old).squeeze(1)
    n_delta = int(pos_del.shape[0])
    r = (pos_del - torch.arange(n_delta, device=pos_del.device)).to(
        torch.int32)
    names = list(new_idx.device.columns)
    olds = [old_idx.device[k] for k in names] + [old_idx.perm]
    deltas = [new_idx.device[k].index_select(0, pos_del) for k in names] \
        + [new_idx.perm.index_select(0, pos_del)]
    want = [new_idx.device[k] for k in names] + [new_idx.perm]
    got = merge.merge_scatter(olds, deltas, r)
    torch.cuda.synchronize()
    plain = device.merge_scatter(olds, deltas, r)
    torch.cuda.synchronize()
    for k, g, p, w in zip(names + ["perm"], got, plain, want):
        if not (torch.equal(g, w) and torch.equal(p, w)):
            raise AssertionError(f"merge_scatter at the flush's shape: "
                                 f"column {k} differs")
    del got, plain
    acts, dev_ms = activities_per_call(
        lambda: merge.merge_scatter(olds, deltas, r))
    ms = cuda_ms(lambda: merge.merge_scatter(olds, deltas, r), 10)
    plain_ms = cuda_ms(lambda: device.merge_scatter(olds, deltas, r), 3)
    out = {"n_old": n_old, "n_delta": n_delta, "columns": len(olds),
           "column_bytes": [o.element_size() for o in olds],
           "ms": ms, "plain_ms": plain_ms, "max_abs_err": 0,
           "activities_per_call": acts, "device_ms_per_call": dev_ms,
           **merge_bound(olds, n_delta)}
    log(f"[kernel] merge_scatter flush shape: {n_old} resident + {n_delta} "
        f"delta rows, {len(olds)} columns {out['column_bytes']} B, equal to "
        f"the plain version and the merged index, kernel {ms} ms, plain "
        f"{plain_ms} ms, bound {out['bound_ms']} ms (bytes, "
        f"{out['bytes']} B), {acts} device activities a call ({dev_ms} ms "
        f"of device time)")
    return out


def phase_write(store, oracle) -> dict:
    """(l): the write path on the 100M-point store, after every other
    phase (the corpus changes under it). 20 appends of L_BATCH rows land in
    the LSM delta (the threshold is max(50,000, 0.02 x 100M)); (a), (b),
    (c), (d) and (g3)'s 64 boxes through ``count_many`` answer over main
    + delta, each equal to its oracle; a 21st append flushes through by
    the merge build (``merge_scatter``); the same answers again; the
    merged permutation equals ``np.lexsort`` of the merged keys and the
    downloaded xi/yi/bin/off columns equal the numpy planes gathered
    through it; the kernel against its plain version at the flush's
    shape; then the full-rebuild mutations on their own 1M-row store.
    Every kernel's launches are counted from 0 around the checked run."""
    import torch
    from geomesa_tpu_torch.curves.binnedtime import time_to_binned_time
    from geomesa_tpu_torch.features.table import FeatureTable, StringColumn
    from geomesa_tpu_torch.index.device import fp62_lat, fp62_lon
    from geomesa_tpu_torch.kernels import (box_count, density, dist, merge,
                                           pip)
    from geomesa_tpu_torch.metrics import REGISTRY

    def counter(name):
        return REGISTRY.snapshot()["counters"].get(name, 0)

    t0 = time.perf_counter()
    batches = [write_batch(k) for k in range(L_BATCHES + 1)]
    dx, dy, ddtg, dname, dval = (np.concatenate(c) for c in zip(*batches))
    o20 = delta_oracle(dx, dy, ddtg, dval, L_BATCHES * L_BATCH)
    o21 = delta_oracle(dx, dy, ddtg, dval, len(dx))
    log(f"[write] {L_BATCHES + 1} batches of {L_BATCH} rows and their "
        f"oracles in {time.perf_counter() - t0:.2f} s")
    sft = store.get_schema("gdelt")
    n0 = len(store.tables["gdelt"])
    counters = {"pip_refine": pip.pip_refine,
                "grid_scatter": density.grid_scatter,
                "box_count": box_count.box_count,
                "dist_refine": dist.dist_refine,
                "merge_scatter": merge.merge_scatter}
    for c in counters.values():
        c.launches = 0
    appends0 = counter("ingest.delta_appends")
    merges0 = counter("ingest.merge_builds")
    append_s = []

    def append(k):
        x, y, dtg, name, val = batches[k]
        t = FeatureTable.build(sft, {
            "name": StringColumn(name, ["a", "b", "c"]), "val": val,
            "dtg": dtg, "geom": (x, y)})
        t1 = time.perf_counter()
        store.load("gdelt", t)
        torch.cuda.synchronize()
        append_s.append(time.perf_counter() - t1)

    # 1. twenty appends into the delta tier
    for k in range(L_BATCHES):
        append(k)
    n_appends = counter("ingest.delta_appends") - appends0
    delta = store.deltas["gdelt"]
    if n_appends != L_BATCHES or merge.merge_scatter.launches != 0 \
            or delta is None or len(delta) != L_BATCHES * L_BATCH:
        raise AssertionError(f"(l) {n_appends} delta appends, "
                             f"{merge.merge_scatter.launches} merges, delta "
                             f"{None if delta is None else len(delta)} rows")

    def wants(od, grid):
        return {"a": oracle["a"] + od["a"],
                "b": len(oracle["b_rows"]) + len(od["b_rows"]),
                "c": np.concatenate([oracle["b_rows"], od["b_rows"] + n0]),
                "d": grid.astype(np.float32),
                "g3_count_many": [int(a + b) for a, b in
                                  zip(oracle["batch"], od["batch"])]}

    per_query = {}

    def run_all(label):
        got, ts = {}, {}
        for q, fn in write_queries(store):
            before = {k: c.launches for k, c in counters.items()}
            t1 = time.perf_counter()
            got[q] = fn()
            torch.cuda.synchronize()
            ts[q] = (time.perf_counter() - t1) * 1e3
            per_query[f"{label}_{q}"] = {k: c.launches - before[k]
                                         for k, c in counters.items()}
        return got, ts

    got1, ms1 = run_all("delta")
    check_write_answers("over main + delta", got1, wants(
        o20, oracle["d_grid"] + oracle_host_density(dx, dy, o20["rows_d"],
                                                    D_BBOX, 64, 64)))

    # 2. the 21st append flushes through by the merge build, under the
    # profiler: the flush's device busy time against its wall time
    idx_old = store.planners["gdelt"].indexes[0]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        append(L_BATCHES)
    flush_s = append_s[-1]
    busy = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    flush_busy_ms = sum(e.time_range.elapsed_us() for e in busy) / 1e3
    log(f"[write] flush-through append {flush_s * 1e3} ms: {len(busy)} "
        f"device activities, {flush_busy_ms} ms busy, idle share "
        f"{1.0 - flush_busy_ms / (flush_s * 1e3)}")
    on_card = store.device.type == "cuda"
    if store.deltas["gdelt"] is not None \
            or counter("ingest.merge_builds") != merges0 + 1 \
            or (on_card and merge.merge_scatter.launches < 1):
        raise AssertionError(f"(l) the 21st append did not flush through by "
                             f"the merge build (merge_scatter launches "
                             f"{merge.merge_scatter.launches})")
    idx = store.planners["gdelt"].indexes[0]
    got2, ms2 = run_all("merged")
    rows21 = o21["rows_d"]
    check_write_answers("after the merge", got2, wants(
        o21, oracle["d_grid"] + oracle_density(dx, dy, rows21, D_BBOX, 64,
                                               64)))
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    q = per_query
    if on_card and (q["delta_b"]["pip_refine"] < 1
                    or q["merged_b"]["pip_refine"] < 1
                    or q["delta_d"]["grid_scatter"] < 1
                    or launches["merge_scatter"] != 1):
        raise AssertionError(f"(l) kernel launches {json.dumps(q)}: (b) "
                             "must launch pip_refine, (d) grid_scatter, the "
                             "flush merge_scatter once")

    # 3. the merged table against a full sort and the numpy planes
    t1 = time.perf_counter()
    perm = idx.perm.cpu().numpy()
    if not np.array_equal(perm, np.lexsort((idx._z, idx._bins))):
        raise AssertionError("(l) merged permutation != np.lexsort of the "
                             "merged (z, bin) keys")
    if not (np.array_equal(idx.sorted_z, idx._z[perm])
            and np.array_equal(idx.sorted_bins, idx._bins[perm])):
        raise AssertionError("(l) merged sorted key runs differ")
    mt = store.tables["gdelt"]
    mx, my = mt.geometry().point_xy()
    bins, offs = time_to_binned_time(np.asarray(mt.columns["dtg"]),
                                     idx.period)
    for name, plane in (("xi", lambda: fp62_lon(mx)[0]),
                        ("yi", lambda: fp62_lat(my)[0]),
                        ("bin", lambda: np.asarray(bins, dtype=np.int32)),
                        ("off", lambda: np.asarray(offs, dtype=np.int32))):
        if not np.array_equal(idx.device[name].cpu().numpy(),
                              plane()[perm]):
            raise AssertionError(f"(l) merged device column {name} != the "
                                 "numpy plane gathered through the perm")
    del perm, bins, offs
    check_s = time.perf_counter() - t1
    log(f"[write] merged table: perm == np.lexsort of the merged keys, "
        f"xi/yi/bin/off == numpy planes through it ({check_s:.2f} s)")

    # 4. the kernel at the flush's shape
    k = compare_merge(idx_old, idx)
    del idx_old
    torch.cuda.empty_cache()

    # 5. the full-rebuild mutations on their own store
    m = phase_mutations(store.device)
    out = {"appends": L_BATCHES + 1, "batch_rows": L_BATCH,
           "append_p50_ms": p50_ms(append_s[:-1]),
           "append_ms": [t * 1e3 for t in append_s[:-1]],
           "flush_through_ms": flush_s * 1e3,
           "flush_device_busy_ms": flush_busy_ms,
           "flush_device_activities": len(busy),
           "flush_idle_share": 1.0 - flush_busy_ms / (flush_s * 1e3),
           "merge_stages_s": idx.build_stages,
           "query_ms_over_delta": ms1, "query_ms_merged": ms2,
           "launches_checked_run": launches, "kernel": k,
           "mutations": m}
    log(f"[write] launches per query {json.dumps(per_query)}")
    log(json.dumps({"write": out}, default=str))
    return out


def phase_mutations(device) -> dict:
    """upsert, remove_features, update_features and age_off — each a full
    rebuild — on a separate L_STORE_N-row store of the corpus's shape
    (with a 4000-day expiry, so the 2020 rows survive the write-path check
    on today's clock), each answer against its numpy oracle."""
    import torch
    from geomesa_tpu_torch import DataStoreFinder
    from geomesa_tpu_torch.features.table import FeatureTable, StringColumn

    x, y, dtg, name, val = corpus(L_STORE_N, seed=L_SEED)
    store = DataStoreFinder.get_data_store(type="torch", device=device)
    sft = store.create_schema(
        "m", SPEC + ",geomesa.feature.expiry=dtg(4000 days)")

    def table(x, y, dtg, name, val, fids=None):
        return FeatureTable.build(sft, {
            "name": StringColumn(name, ["a", "b", "c"]), "val": val,
            "dtg": dtg, "geom": (x, y)}, fids=fids)

    store.load("m", table(x, y, dtg, name, val))
    n = L_STORE_N

    def box_count_of(x, y, dtg, val):
        lo, hi = (np.datetime64(d, "ms").astype(np.int64)
                  for d in ("2020-01-05", "2020-01-12"))
        return int(np.count_nonzero(
            (dtg > lo) & (dtg < hi) & (x >= -10) & (x <= 30) & (y >= 30)
            & (y <= 55) & (val > 10)))

    out = {}

    def timed(label, fn):
        t1 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[f"{label}_ms"] = (time.perf_counter() - t1) * 1e3
        return r

    # upsert: 1,000 rows whose fids collide with implicit main-table ids
    rng = np.random.default_rng([L_SEED, 1])
    hit = np.sort(rng.choice(n, 1000, replace=False))
    bx, by, bdtg, bname, bval = (a[:1000] for a in write_batch(99))
    timed("upsert", lambda: store.upsert("m", table(
        bx, by, bdtg, bname, bval, fids=[str(k) for k in hit])))
    keep = np.ones(n, dtype=bool)
    keep[hit] = False
    x, y, dtg, name, val = (np.concatenate([a[keep], b]) for a, b in
                            zip((x, y, dtg, name, val),
                                (bx, by, bdtg, bname, bval)))
    fids_tail = store.tables["m"].fids_at(np.arange(n - 1000, n)).tolist()
    if store.count("m", "INCLUDE") != n \
            or store.count("m", Q_BOX) != box_count_of(x, y, dtg, val) \
            or fids_tail != [str(k) for k in hit]:
        raise AssertionError("(l) upsert differs from its oracle")
    out["upserted"] = 1000
    # remove_features
    want = int(np.count_nonzero(val == 7))
    got = timed("remove", lambda: store.remove_features("m", "val = 7"))
    keep = val != 7
    x, y, dtg, name, val = (a[keep] for a in (x, y, dtg, name, val))
    if got != want or store.count("m", "INCLUDE") != len(x) \
            or store.count("m", Q_BOX) != box_count_of(x, y, dtg, val):
        raise AssertionError("(l) remove_features differs from its oracle")
    out["removed"] = got
    # update_features
    want = int(np.count_nonzero(val > 90))
    got = timed("update", lambda: store.update_features(
        "m", "val > 90", {"val": 7}))
    val = np.where(val > 90, 7, val).astype(np.int32)
    if got != want or store.count("m", "val = 7") != want \
            or store.count("m", "val > 90") != 0 \
            or store.count("m", Q_BOX) != box_count_of(x, y, dtg, val):
        raise AssertionError("(l) update_features differs from its oracle")
    out["updated"] = got
    # age_off at a clock whose cutoff is 2020-01-15
    cutoff = np.datetime64("2020-01-15", "ms").astype(np.int64)
    now_ms = int(cutoff) + 4000 * 86_400_000
    want = int(np.count_nonzero(dtg <= cutoff))
    got = timed("age_off", lambda: store.age_off("m", now_ms=now_ms))
    keep = dtg > cutoff
    x, y, dtg, name, val = (a[keep] for a in (x, y, dtg, name, val))
    if got != want or store.count("m", "INCLUDE") != len(x) \
            or store.count("m", Q_BOX) != box_count_of(x, y, dtg, val):
        raise AssertionError("(l) age_off differs from its oracle")
    out.update(rows=n, aged_off=got)
    log(f"[write] mutations on a {n}-row store equal their oracles: "
        f"{json.dumps(out)}")
    return out


# -- (m): Z2 and the extent indexes -------------------------------------------

# f32 operations of the segment band per (live segment, real edge), whatever
# implements it: four orientations with their bounds, 11 each (d2x, d2y; t1,
# t2; det; |t1| + |t2|; the two sums of the |d| terms past the hoisted
# |d1x| + |d1y|; the two products and the bound's sum), 8 band compares
# (o > t and o < -t of each), 4 compares of the crossing rule's conditions,
# 2 of |o| <= t, 2 of the |y1 - y| ties and 2 subtractions and 2 compares
# of the |y2 - y| ties = 64; per live segment once: b - a and |b - a| (3)
SEG_OPS_PER_PAIR = 64
SEG_OPS_PER_SEGMENT = 3

# bench.py cfg2, not cut: 5,000,000 single-segment LineStrings with its
# distributions (bench.py:605-618), its polygon and its exact oracle
M_N = 5_000_000
M_SEED = 2602
M_WKT = "POLYGON ((-12 30, 10 28, 14 44, -2 50, -12 30))"
M_RING = [(-12.0, 30.0), (10.0, 28.0), (14.0, 44.0), (-2.0, 50.0),
          (-12.0, 30.0)]
Q_M1 = f"INTERSECTS(geom, {M_WKT})"
M_BOX = (-12.0, 28.0, 14.0, 50.0)
Q_M1_BBOX = "BBOX(geom, -12, 28, 14, 50)"
# 64 boxes shifted from M_BOX as (g3)'s are from (a)'s
M_BOXES = [(M_BOX[0] + (i % 8) * 0.4, M_BOX[1] + (i // 8) * 0.3,
            M_BOX[2] + (i % 8) * 0.4, M_BOX[3] + (i // 8) * 0.3)
           for i in range(64)]
# (m2) the same segments with a date uniform over 30 days, a week's query
Q_M2 = f"{Q_M1} AND {DURING}"
# (m3) small convex quadrilaterals in an XZ2 layer
M_POLY_N = 500_000
# (m4) the first 10,000,000 points of the cfg1 corpus, without a date
M_Z2_N = 10_000_000
Q_M4 = "BBOX(geom, -10, 30, 30, 55) AND val > 10"
# the seg_band check at segments within a few ulps of the polygon's edges
M_NEAR_N = 33_554_432
# (m1) the lines' density and an st_length count; (m3) an st_area count and
# st_intersects of a buffer around each polygon with a point, both in M_BOX
# (the host evaluates them feature by feature, as the reference's oracle)
M_GRID = 256
M_LEN = 1.5
Q_M1_LEN = f"st_length(geom) > {M_LEN}"
M_AREA = 1.0
Q_M3_AREA = f"{Q_M1_BBOX} AND st_area(geom) > {M_AREA}"
M_BUF_D = 0.5
M_BUF_P = (1.0, 39.0)
Q_M3_BUF = (f"{Q_M1_BBOX} AND st_intersects(st_buffer(geom, {M_BUF_D}), "
            f"POINT({M_BUF_P[0]} {M_BUF_P[1]}))")
# (m5) S2 and S3 over (m4)'s points: (a)'s box (with its week on S3) and
# the concave polygon
Q_M5_S2_POLY = f"INTERSECTS(geom, {CONCAVE_WKT})"
# (m6) an append into (m1)'s layer, flushed by the merge build
M_APPEND_N = 100_000


def cfg2_segments(n: int, seed: int):
    """bench.py:605-618's distributions: start U(-175, 170) x U(-85, 80),
    extent U(0.01, 2.0) in each axis."""
    rng = np.random.default_rng(seed)
    lx = rng.uniform(-175, 170, n)
    ly = rng.uniform(-85, 80, n)
    dx = rng.uniform(0.01, 2.0, n)
    dy = rng.uniform(0.01, 2.0, n)
    return lx, ly, lx + dx, ly + dy


def oracle_cfg2(ax, ay, bx, by, ring) -> np.ndarray:
    """bench.py:643-676's exact test, f64: an endpoint inside the ring
    (even-odd ray cast) or a proper crossing of an edge (orientation
    signs)."""
    ring = np.asarray(ring, dtype=np.float64)
    hit = np.zeros(len(ax), dtype=bool)
    for qx, qy in ((ax, ay), (bx, by)):
        ins = np.zeros(len(ax), dtype=bool)
        for i in range(len(ring) - 1):
            (x1, y1), (x2, y2) = ring[i], ring[i + 1]
            crosses = (y1 > qy) != (y2 > qy)
            with np.errstate(divide="ignore", invalid="ignore"):
                xint = x1 + (qy - y1) * (x2 - x1) / (y2 - y1)
            ins ^= crosses & (qx < xint)
        hit |= ins

    def orient(ox, oy, px_, py_, rx, ry):
        return np.sign((px_ - ox) * (ry - oy) - (py_ - oy) * (rx - ox))

    for i in range(len(ring) - 1):
        (x1, y1), (x2, y2) = ring[i], ring[i + 1]
        o1 = orient(ax, ay, bx, by, x1, y1)
        o2 = orient(ax, ay, bx, by, x2, y2)
        o3 = orient(x1, y1, x2, y2, ax, ay)
        o4 = orient(x1, y1, x2, y2, bx, by)
        hit |= (o1 != o2) & (o3 != o4)
    return hit


def quads(n: int, seed: int) -> np.ndarray:
    """(n, 5, 2) closed rings of small convex quadrilaterals: four
    vertices at sorted angles around a centre U(-175, 175) x U(-85, 85),
    radii U(0.05, 1.5)."""
    rng = np.random.default_rng(seed)
    cx = rng.uniform(-175, 175, n)
    cy = rng.uniform(-85, 85, n)
    r = rng.uniform(0.05, 1.5, (n, 4))
    ang = np.sort(rng.uniform(0, 2 * np.pi, (n, 4)), axis=1)
    ring = np.empty((n, 5, 2))
    ring[:, :4, 0] = cx[:, None] + r * np.cos(ang)
    ring[:, :4, 1] = cy[:, None] + r * np.sin(ang)
    ring[:, 4] = ring[:, 0]
    return ring


def oracle_quads(rings: np.ndarray, ring) -> np.ndarray:
    """f64, written out here: a quadrilateral intersects the polygon when a
    vertex of either lies inside the other (crossing parity, or on an edge
    for the quadrilateral's vertices) or an edge of one crosses an edge of
    the other (orientation signs differ on both, as bench.py's test)."""
    q = np.asarray(ring, dtype=np.float64)
    n = len(rings)
    v = rings[:, :4].reshape(-1, 2)
    hit = oracle_pip(v[:, 0], v[:, 1], q).reshape(n, 4).any(axis=1)
    for px, py in q[:-1]:
        ins = np.zeros(n, dtype=bool)
        for k in range(4):
            x1, y1 = rings[:, k, 0], rings[:, k, 1]
            x2, y2 = rings[:, k + 1, 0], rings[:, k + 1, 1]
            crosses = (y1 > py) != (y2 > py)
            with np.errstate(divide="ignore", invalid="ignore"):
                xint = (x2 - x1) * (py - y1) / (y2 - y1) + x1
            ins ^= crosses & (px < xint)
        hit |= ins

    def orient(ox, oy, px_, py_, rx, ry):
        return np.sign((px_ - ox) * (ry - oy) - (py_ - oy) * (rx - ox))

    for k in range(4):
        ax, ay = rings[:, k, 0], rings[:, k, 1]
        bx, by = rings[:, k + 1, 0], rings[:, k + 1, 1]
        for i in range(len(q) - 1):
            (x1, y1), (x2, y2) = q[i], q[i + 1]
            hit |= (orient(ax, ay, bx, by, x1, y1)
                    != orient(ax, ay, bx, by, x2, y2)) \
                & (orient(x1, y1, x2, y2, ax, ay)
                   != orient(x1, y1, x2, y2, bx, by))
    return hit


def near_edge_segments(n: int, seed: int, ring=M_RING):
    """(ax, ay, bx, by) of n segments with an end within a few f32 ulps of
    a point of the ring's edges (a tenth on a vertex), running off in a
    random direction for 1e-6 to 2 degrees, or along the edge: every
    orientation and crossing band of the classifier occurs."""
    rng = np.random.default_rng(seed)
    r = np.asarray(ring, dtype=np.float64)
    k = rng.integers(0, len(r) - 1, n)
    t = rng.uniform(0, 1, n)
    t[: n // 10] = 0.0
    e1, e2 = r[k], r[k + 1]
    p = e1 + t[:, None] * (e2 - e1)
    ulp = np.spacing(np.abs(p).astype(np.float32)).astype(np.float64)
    a = p + rng.integers(-4, 5, (n, 2)) * ulp
    length = rng.choice([1e-6, 1e-4, 1e-2, 2.0], n)
    ang = rng.uniform(0, 2 * np.pi, n)
    d = np.stack([np.cos(ang), np.sin(ang)], 1) * length[:, None]
    along = rng.random(n) < 0.15
    d[along] = (e2 - e1)[along] * rng.uniform(-0.3, 0.3, int(along.sum())
                                              )[:, None]
    return a[:, 0], a[:, 1], a[:, 0] + d[:, 0], a[:, 1] + d[:, 1]


def timed(fn, sync, reps: int = REPS):
    """(p50 ms, last result) of ``fn`` over ``reps`` synchronised calls
    after one warm-up call."""
    out = fn()
    ts = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return p50_ms(ts), out


def _check(label: str, got, want) -> None:
    """A count or a row set against its oracle."""
    if isinstance(want, np.ndarray):
        if not np.array_equal(got, want):
            raise AssertionError(f"(m) {label}: {len(got)} rows differ from "
                                 f"the oracle's {len(want)}")
    elif got != want:
        raise AssertionError(f"(m) {label}: {got} != oracle {want}")


def _hull(pts: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain, counter-clockwise, collinear points
    dropped (written out here)."""
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(seq):
        h = []
        for p in seq:
            while len(h) >= 2 and ((h[-1][0] - h[-2][0]) * (p[1] - h[-2][1])
                                   - (h[-1][1] - h[-2][1]) * (p[0] - h[-2][0])
                                   ) <= 0:
                h.pop()
            h.append(p)
        return h

    lower, upper = half(pts), half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def oracle_buffer_hits(rings: np.ndarray, box, d: float, point) -> int:
    """The quadrilaterals whose envelope meets ``box`` and whose buffer —
    the convex hull of their vertices, each moved by the eight vertices of
    the octagon of circumradius d / cos(pi/8) at angles (k + 1/2) pi/4 —
    holds ``point`` (on its boundary too): f64, written out here."""
    v = rings[:, :4]
    lo, hi = v.min(axis=1), v.max(axis=1)
    r = d / np.cos(np.pi / 8)
    px, py = point
    keep = ((lo[:, 0] <= box[2]) & (hi[:, 0] >= box[0])
            & (lo[:, 1] <= box[3]) & (hi[:, 1] >= box[1])
            & (lo[:, 0] - r <= px) & (hi[:, 0] + r >= px)
            & (lo[:, 1] - r <= py) & (hi[:, 1] + r >= py))
    ang = (np.arange(8) + 0.5) * (np.pi / 4)
    off = np.stack([r * np.cos(ang), r * np.sin(ang)], axis=1)
    hits = 0
    for i in np.flatnonzero(keep):
        h = _hull((v[i][:, None, :] + off[None, :, :]).reshape(-1, 2))
        e = np.roll(h, -1, axis=0) - h
        cross = e[:, 0] * (py - h[:, 1]) - e[:, 1] * (px - h[:, 0])
        hits += bool(np.all(cross >= 0))
    return hits


def extent_store(device: str, name: str, spec: str, cols: dict):
    """A store of its own holding one layer; returns (store, planner, load
    seconds, the index's build stages)."""
    from geomesa_tpu_torch import DataStoreFinder
    from geomesa_tpu_torch.features.table import FeatureTable
    store = DataStoreFinder.get_data_store(type="torch", device=device)
    store.create_schema(name, spec)
    table = FeatureTable.build(store.get_schema(name), cols)
    t0 = time.perf_counter()
    store.load(name, table)
    planner = store.planner(name)
    load_s = time.perf_counter() - t0
    return store, planner, load_s, dict(planner.indexes[0].build_stages)


def prepared_band(planner, q: str, sync) -> dict:
    """p50 of a prepared count (the plan and its cover made once, as
    bench.py's cfg2 prepares its query) with the band's split: certain and
    uncertain rows, the host refine's seconds and its share of the count's
    wall time (p50 over the reps)."""
    pq = planner.prepare(q)
    pq.count()
    walls, shares = [], []
    for _ in range(REPS):
        sync()
        t0 = time.perf_counter()
        n = pq.count()
        sync()
        w = time.perf_counter() - t0
        band = pq.plan.explain.get("band") or {}
        walls.append(w)
        shares.append(band.get("refine_s", 0.0) / w)
    return {"count": n, "p50_ms": p50_ms(walls),
            "refine_share_p50": float(np.median(shares)),
            "band": dict(pq.plan.explain.get("band") or {}),
            "candidate_blocks": pq.plan.explain.get("candidate_blocks")}


def phase_extent(points_table, device: str = "cuda", n: int = M_N,
                 n_poly: int = M_POLY_N, n_z2: int = M_Z2_N) -> dict:
    """(m): Z2 and the extent indexes on stores of their own, every answer
    equal to a numpy oracle computed here, every kernel's launches counted
    from 0 around the run. (m1) bench.py cfg2 not cut: the polygon
    INTERSECTS as a count (the seg_band route) and as rows, a BBOX count
    (box_count's envelope any-box count), 64 shifted boxes through
    ``counts_multi_blocks`` and ``store.count_many`` (its per-box count);
    (m2) the same segments with a date (XZ3), the INTERSECTS AND a week;
    (m3) small convex quadrilaterals (XZ2; the band declines, the host
    ragged refine answers); (m4) the first ``n_z2`` points of the cfg1
    corpus (``points_table``) without a date (Z2), (a)'s box AND val > 10.
    (m1) also selects the BBOX's rows and renders a M_GRID x M_GRID
    density of the lines (envelope centres snapped on the host), both
    through ``fused_scan``'s ENV form (its launches counted around each,
    above 0 on the card), and counts ``st_length``; (m3) counts
    ``st_area`` and a buffer's ``st_intersects`` with a point.
    Returns the measurements and (m1)'s store for the kernel checks."""
    import torch
    from geomesa_tpu_torch.features.geometry import (POLYGON,
                                                     GeometryArray)
    from geomesa_tpu_torch.index import prune
    from geomesa_tpu_torch.index.spatial import _boxes_fp62
    from geomesa_tpu_torch.kernels import (box_count, density, dist,
                                           fused_scan, geom, merge, pip,
                                           seg_band)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    on_card = device == "cuda"
    counters = {"pip_refine": pip.pip_refine,
                "grid_scatter": density.grid_scatter,
                "box_count": box_count.box_count,
                "dist_refine": dist.dist_refine,
                "merge_scatter": merge.merge_scatter,
                "seg_band": seg_band.seg_band,
                "fused_scan": fused_scan.fused_scan,
                "geom_unary": geom.geom_unary,
                "geom_dist": geom.geom_dist,
                "geom_pred": geom.geom_pred}
    for c in counters.values():
        c.launches = 0
    fused_scan.fused_scan.env_launches = 0
    out = {}
    env_counts: dict = {}

    def env_run(label: str, fn):
        """``fn()`` with the ENV form's launches counted around it (the
        selects and the density of an extent layer must take it)."""
        before = fused_scan.fused_scan.env_launches
        r = fn()
        sync()
        k = fused_scan.fused_scan.env_launches - before
        if on_card and k < 1:
            raise AssertionError(f"(m) {label} did not launch fused_scan's "
                                 f"ENV form")
        env_counts[label] = k
        return r

    # (m1) cfg2
    t0 = time.perf_counter()
    ax, ay, bx, by = cfg2_segments(n, M_SEED)
    coords = np.empty((2 * n, 2))
    coords[0::2, 0], coords[0::2, 1] = ax, ay
    coords[1::2, 0], coords[1::2, 1] = bx, by
    hit = oracle_cfg2(ax, ay, bx, by, M_RING)
    want_rows = np.flatnonzero(hit)
    env = ((ax <= M_BOX[2]) & (bx >= M_BOX[0]) & (ay <= M_BOX[3])
           & (by >= M_BOX[1]))
    want_boxes = [int(np.count_nonzero((ax <= q[2]) & (bx >= q[0])
                                       & (ay <= q[3]) & (by >= q[1])))
                  for q in M_BOXES]
    log(f"[m1] {n} segments and their oracles in "
        f"{time.perf_counter() - t0:.2f} s")
    store, planner, load_s, stages = extent_store(
        device, "osm", "*geom:LineString",
        {"geom": GeometryArray.linestrings(coords)})
    del coords
    idx = planner.indexes[0]
    log(f"[m1] load {load_s} s into {idx.name}; split (s): "
        f"{json.dumps(stages)}")
    t0 = time.perf_counter()
    got = store.count("osm", Q_M1)
    cold_count_ms = (time.perf_counter() - t0) * 1e3
    _check("m1 count", got, len(want_rows))
    _check("m1 rows", env_run("m1 INTERSECTS rows", lambda: store.query(
        "osm", Q_M1).indices), want_rows)
    band = prepared_band(planner, Q_M1, sync)
    _check("m1 prepared count", band["count"], len(want_rows))
    if band["band"].get("uncertain") is None:
        raise AssertionError(f"(m1) the band route did not answer: {band}")
    pq = planner.prepare(Q_M1)
    rows_p50, rows = timed(pq.select_indices, sync)
    _check("m1 prepared rows", rows, want_rows)
    _check("m1 bbox count", store.count("osm", Q_M1_BBOX),
           int(np.count_nonzero(env)))
    bbox_p50, got = timed(planner.prepare(Q_M1_BBOX).count, sync)
    _check("m1 prepared bbox count", got, int(np.count_nonzero(env)))
    plans = [planner.plan(f"BBOX(geom, {q[0]}, {q[1]}, {q[2]}, {q[3]})")
             for q in M_BOXES]
    covers = [planner._pruned_blocks(p) for p in plans]
    union = np.unique(np.concatenate(covers)).astype(np.int32)
    fp = _boxes_fp62(M_BOXES)
    multi_p50, got = timed(lambda: idx.kernels.counts_multi_blocks(
        "bbox_overlap", fp, None, None, union, prune.BLOCK_SIZE), sync)
    _check("m1 counts_multi_blocks", list(map(int, got)), want_boxes)
    filters = [f"BBOX(geom, {q[0]}, {q[1]}, {q[2]}, {q[3]})"
               for q in M_BOXES]
    many_p50, got = timed(lambda: store.count_many("osm", filters), sync)
    _check("m1 count_many", list(map(int, got)), want_boxes)
    # the BBOX's rows and the density through fused_scan's ENV form
    want_bbox = np.flatnonzero(env)
    _check("m1 bbox rows", env_run("m1 BBOX rows", lambda: store.query(
        "osm", Q_M1_BBOX).indices), want_bbox)
    bbox_rows_p50, rows = timed(planner.prepare(Q_M1_BBOX).select_indices,
                                sync)
    _check("m1 prepared bbox rows", rows, want_bbox)
    # each segment's envelope centre (bx > ax, by > ay), as the host snaps
    want_grid = oracle_host_density((ax + bx) / 2, (ay + by) / 2, want_bbox,
                                    M_BOX, M_GRID, M_GRID)
    grid = env_run("m1 density", lambda: store.query(
        "osm", Q_M1_BBOX, hints=density_hint(M_BOX, M_GRID, M_GRID)))
    if not np.array_equal(grid.weights, want_grid.astype(np.float32)):
        raise AssertionError("(m1) the density differs from the oracle's in "
                             f"{int((grid.weights != want_grid).sum())} "
                             "cells")
    density_p50, _ = timed(lambda: store.query(
        "osm", Q_M1_BBOX, hints=density_hint(M_BOX, M_GRID, M_GRID)), sync)
    # st_length through the catalog (geom_unary): the f32 value, as the
    # reference's route reads it
    want_len = int(np.count_nonzero(lines_length32(ax, ay, bx, by) > M_LEN))
    t0 = time.perf_counter()
    _check("m1 st_length count", store.count("osm", Q_M1_LEN), want_len)
    len_ms = (time.perf_counter() - t0) * 1e3
    store.close()
    out["m1"] = {
        "n": n, "load_s": load_s, "build_stages_s": stages,
        "index": idx.name, "count": len(want_rows),
        "cold_count_ms": cold_count_ms, "count_p50_ms": band["p50_ms"],
        "refine_share_p50": band["refine_share_p50"],
        "certain": band["band"]["certain"],
        "uncertain": band["band"]["uncertain"],
        "candidate_blocks": band["candidate_blocks"],
        "rows_p50_ms": rows_p50, "bbox_count": int(np.count_nonzero(env)),
        "bbox_count_p50_ms": bbox_p50, "union_blocks": int(len(union)),
        "counts_multi_blocks_p50_ms": multi_p50,
        "count_many_p50_ms": many_p50, "bbox_rows": len(want_bbox),
        "bbox_rows_p50_ms": bbox_rows_p50, "density_p50_ms": density_p50,
        "density_cells_set": int(np.count_nonzero(want_grid)),
        "st_length_count": want_len, "st_length_count_ms": len_ms,
        "env_launches": dict(env_counts)}
    log(json.dumps({"m1": out["m1"]}))
    m1 = {"store": store, "planner": planner, "union": union, "fp": fp,
          "segments": (ax, ay, bx, by)}

    # (m2) XZ3: the same segments with a date
    rng = np.random.default_rng(M_SEED + 1)
    base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
    dtg = base + rng.integers(0, 30 * 86400000, n)
    tm = (dtg > np.datetime64("2020-01-05", "ms").astype(np.int64)) \
        & (dtg < np.datetime64("2020-01-12", "ms").astype(np.int64))
    want2 = np.flatnonzero(hit & tm)
    coords = np.empty((2 * n, 2))
    coords[0::2, 0], coords[0::2, 1] = ax, ay
    coords[1::2, 0], coords[1::2, 1] = bx, by
    store2, planner2, load2, stages2 = extent_store(
        device, "osm_t", "dtg:Date,*geom:LineString;"
        "geomesa.z3.interval=week",
        {"dtg": dtg, "geom": GeometryArray.linestrings(coords)})
    del coords, dtg, tm
    _check("m2 count", store2.count("osm_t", Q_M2), len(want2))
    _check("m2 rows", store2.query("osm_t", Q_M2).indices, want2)
    band2 = prepared_band(planner2, Q_M2, sync)
    _check("m2 prepared count", band2["count"], len(want2))
    rows2_p50, rows = timed(planner2.prepare(Q_M2).select_indices, sync)
    _check("m2 prepared rows", rows, want2)
    out["m2"] = {"n": n, "load_s": load2, "build_stages_s": stages2,
                 "index": planner2.indexes[0].name, "count": len(want2),
                 "count_p50_ms": band2["p50_ms"],
                 "refine_share_p50": band2["refine_share_p50"],
                 "certain": band2["band"].get("certain"),
                 "uncertain": band2["band"].get("uncertain"),
                 "rows_p50_ms": rows2_p50}
    log(json.dumps({"m2": out["m2"]}))
    del store2, planner2, hit

    # (m3) polygons
    rings = quads(n_poly, M_SEED + 2)
    want3 = np.flatnonzero(oracle_quads(rings, M_RING))
    lv = np.arange(n_poly + 1, dtype=np.int64)
    garr = GeometryArray(np.full(n_poly, POLYGON, dtype=np.int8), lv, lv,
                         5 * lv, rings.reshape(-1, 2))
    store3, planner3, load3, stages3 = extent_store(
        device, "parcels", "*geom:Polygon", {"geom": garr})
    _check("m3 count", store3.count("parcels", Q_M1), len(want3))
    _check("m3 rows", store3.query("parcels", Q_M1).indices, want3)
    count3_p50, got = timed(planner3.prepare(Q_M1).count, sync)
    _check("m3 prepared count", got, len(want3))
    rows3_p50, rows = timed(planner3.prepare(Q_M1).select_indices, sync)
    _check("m3 prepared rows", rows, want3)
    plan3 = planner3.plan(Q_M1)
    planner3._count(plan3, Q_M1)
    if "band" in plan3.explain:
        raise AssertionError("(m3) the band route took a polygon layer")
    # st_area through the catalog (geom_unary): the f32 value, as the
    # reference's route reads it
    lo3, hi3 = rings.min(axis=1), rings.max(axis=1)
    in_box = ((lo3[:, 0] <= M_BOX[2]) & (hi3[:, 0] >= M_BOX[0])
              & (lo3[:, 1] <= M_BOX[3]) & (hi3[:, 1] >= M_BOX[1]))
    want_area = int(np.count_nonzero(in_box & (quads_area32(rings) > M_AREA)))
    t0 = time.perf_counter()
    _check("m3 st_area count", store3.count("parcels", Q_M3_AREA), want_area)
    area_ms = (time.perf_counter() - t0) * 1e3
    want_buf = oracle_buffer_hits(rings, M_BOX, M_BUF_D, M_BUF_P)
    t0 = time.perf_counter()
    _check("m3 st_buffer count", env_run("m3 st_buffer", lambda: store3.count(
        "parcels", Q_M3_BUF)), want_buf)
    buf_ms = (time.perf_counter() - t0) * 1e3
    out["m3"] = {"n": n_poly, "load_s": load3, "build_stages_s": stages3,
                 "index": planner3.indexes[0].name, "count": len(want3),
                 "count_p50_ms": count3_p50, "rows_p50_ms": rows3_p50,
                 "st_area_count": want_area, "st_area_count_ms": area_ms,
                 "st_buffer_count": want_buf, "st_buffer_count_ms": buf_ms}
    log(json.dumps({"m3": out["m3"]}))
    m3 = {"store": store3, "planner": planner3, "rings": rings,
          "in_box": in_box, "want_hits": want3, "want_buf": want_buf}
    del garr

    # (m4) Z2: the first n_z2 points of the cfg1 corpus without a date
    px, py = (v[:n_z2] for v in points_table.geometry().point_xy())
    val = np.asarray(points_table.columns["val"])[:n_z2]
    want4 = np.flatnonzero((px >= -10) & (px <= 30) & (py >= 30)
                           & (py <= 55) & (val > 10))
    store4, planner4, load4, stages4 = extent_store(
        device, "pts", "val:Int,*geom:Point",
        {"val": val, "geom": (px, py)})
    _check("m4 count", store4.count("pts", Q_M4), len(want4))
    _check("m4 rows", store4.query("pts", Q_M4).indices, want4)
    count4_p50, got = timed(planner4.prepare(Q_M4).count, sync)
    _check("m4 prepared count", got, len(want4))
    rows4_p50, rows = timed(lambda: store4.query("pts", Q_M4).indices, sync)
    _check("m4 rows p50", rows, want4)
    out["m4"] = {"n": n_z2, "load_s": load4, "build_stages_s": stages4,
                 "index": planner4.indexes[0].name, "count": len(want4),
                 "count_p50_ms": count4_p50, "rows_p50_ms": rows4_p50}
    log(json.dumps({"m4": out["m4"]}))
    del store4, planner4

    sync()
    out["launches"] = {k: c.launches for k, c in counters.items()}
    out["launches"]["fused_scan_env"] = fused_scan.fused_scan.env_launches
    if on_card and (out["launches"]["seg_band"] < 1
                    or out["launches"]["box_count"] < 1
                    or out["launches"]["fused_scan_env"] < 1
                    or out["launches"]["geom_unary"] < 1
                    or out["launches"]["geom_pred"] < 1):
        raise AssertionError(f"(m) did not launch seg_band, box_count, "
                             f"fused_scan's ENV form, geom_unary and "
                             f"geom_pred: {out['launches']}")
    log(json.dumps({"extent": {k: out[k] for k in ("m1", "m2", "m3", "m4",
                                                   "launches")}}))
    out["m1_state"] = m1
    out["m3_state"] = m3
    return out


def seg_band_bound(cols, boxes, windows, resid, block_ids, bsz,
                   n_edges: int, unc_cap: int) -> dict:
    """The least time the card could take for the band count on these
    inputs. Bytes: the block ids, the time planes (8 B) of every candidate
    in its block (with windows), the mask bytes, the envelope planes (32 B)
    of every candidate past the windows, residual and __valid__, the
    segment planes (16 B) of every live candidate, the edges, boxes,
    windows and the output. Operations: SEG_OPS_PER_PAIR per (live
    segment, real edge) and SEG_OPS_PER_SEGMENT per live segment over the
    f32 rate."""
    from geomesa_tpu_torch.index import scan
    n = int(cols["sx1"].shape[0])
    member, _, _, g = scan.expand_blocks(cols, block_ids, bsz, n)
    pre = member.clone()
    if windows is not None:
        pre &= scan._time_mask(g, windows)
    for m in (resid, g["__valid__"] if "__valid__" in g else None):
        if m is not None:
            pre &= m
    live = int((pre & scan.bbox_overlap(g, boxes)).sum())
    n_member, n_pre = int(member.sum()), int(pre.sum())
    ncand = int(block_ids.shape[0]) * bsz
    nbytes = (4 * int(block_ids.shape[0])
              + (8 * n_member if windows is not None else 0)
              + (ncand if resid is not None else 0)
              + (n_member if "__valid__" in cols else 0)
              + 32 * n_pre + 16 * live + 16 * n_edges
              + 32 * int(boxes.shape[0])
              + (0 if windows is None else 16 * int(windows.shape[0]))
              + 4 * (2 + unc_cap))
    ops = live * (n_edges * SEG_OPS_PER_PAIR + SEG_OPS_PER_SEGMENT)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes * 1e3, "ops_ms": t_ops * 1e3,
            "candidates": ncand, "in_blocks": n_member, "live": live}


def compare_seg_band(label: str, cols, boxes, windows, resid, block_ids,
                     bsz, edges, n_edges: int, reps: int,
                     unc_cap: int = 4096) -> dict:
    """seg_band's kernel against its plain version on the same card
    tensors: integer vectors, so equal value for value; both timed with
    CUDA events; the device activities and device time of one call."""
    import torch
    from geomesa_tpu_torch.index import scan
    from geomesa_tpu_torch.kernels import seg_band

    args = (cols, boxes, windows, resid, block_ids, bsz, edges, n_edges,
            unc_cap)
    kern = seg_band.seg_band(*args)
    torch.cuda.synchronize()
    plain = scan.seg_band(*args)
    torch.cuda.synchronize()
    err = int((kern.long() - plain.long()).abs().max())
    if err != 0 or not torch.equal(kern, plain):
        raise AssertionError(f"seg_band {label}: the kernel's vector differs "
                             f"from the plain version (max abs err {err})")
    acts, dev_ms = activities_per_call(lambda: seg_band.seg_band(*args))
    ms = cuda_ms(lambda: seg_band.seg_band(*args), reps)
    plain_ms = cuda_ms(lambda: scan.seg_band(*args), max(1, reps // 10))
    r = {"label": label, "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
         "certain": int(kern[0]), "uncertain": int(kern[1]),
         "edges": n_edges, "activities_per_call": acts,
         "device_ms_per_call": dev_ms,
         **seg_band_bound(*args[:6], n_edges, unc_cap)}
    log(f"[kernel] seg_band {label}: {r['candidates']} candidates "
        f"({r['in_blocks']} in their blocks, {r['live']} live), "
        f"{n_edges} edges, {r['certain']} certain and {r['uncertain']} "
        f"uncertain, equal to the plain version, kernel {ms} ms, plain "
        f"{plain_ms} ms, bound {r['bound_ms']} ms ({r['bound_by']}; bytes "
        f"{r['bytes_ms']} ms, operations {r['ops_ms']} ms), {acts} device "
        f"activities a call ({dev_ms} ms of device time)")
    return r


def near_edge_table(n: int, seed: int, dev):
    """Device columns of n near-edge segments in table order: the fp62
    envelope planes and the f32 segment planes."""
    import torch
    from geomesa_tpu_torch.index.device import fp62_lat, fp62_lon
    ax, ay, bx, by = near_edge_segments(n, seed)
    cols = {}
    for name, v, enc in (("bxmin", np.minimum(ax, bx), fp62_lon),
                         ("bymin", np.minimum(ay, by), fp62_lat),
                         ("bxmax", np.maximum(ax, bx), fp62_lon),
                         ("bymax", np.maximum(ay, by), fp62_lat)):
        cols[name + "_i"], cols[name + "_l"] = enc(v)
    for name, v in (("sx1", ax), ("sy1", ay), ("sx2", bx), ("sy2", by)):
        cols[name] = v.astype(np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in cols.items()}


def env_bound(cols, ids, k: int, bsz: int, nbox: int, mode: str) -> dict:
    """``fused_scan``'s ENV form over the first ``k`` of block list
    ``ids``: bytes — the eight fp62 envelope planes (32 B) and the
    ``__valid__`` byte (where the table has one) of every candidate that is
    its block's own row, the block ids, a mask byte a candidate in MASK,
    the count; operations — four key compares a candidate a real box."""
    from geomesa_tpu_torch.index import scan
    n = int(cols["bxmin_i"].shape[0])
    member = scan.expand_blocks(cols, ids[:k], bsz, n)[0]
    rows = int(member.sum())
    nbytes = (32 * rows + (rows if "__valid__" in cols else 0) + 4 * k
              + (k * bsz if mode == "mask" else 0) + 4)
    return _bound(nbytes, 4 * rows * nbox)


def env_calls(m1: dict) -> list:
    """(label, kernel call, plain call, bound, reps, cut) of the ENV form
    at (m1)'s BBOX: its cover's blocks and all the table's blocks, count
    and mask."""
    import torch
    from geomesa_tpu_torch.index import prune, scan
    from geomesa_tpu_torch.kernels import fused_scan

    planner = m1["planner"]
    kern = planner.indexes[0].kernels
    cols, dev, n = kern.cols, kern.device, kern.n
    bsz = int(prune.BLOCK_SIZE)
    plan = planner.plan(Q_M1_BBOX)
    stage = (plan.primary_kind, plan.boxes_loose, plan.windows,
             plan.residual_device)
    q = scan.staged_query(cols, [stage])
    if q is None or not (q.env and q.points):
        raise AssertionError(f"(m1) BBOX did not pack an ENV query: {q}")
    qbuf = torch.from_numpy(q.packed).to(dev)
    nbox = len(plan.explain["boxes"])
    cover = planner._pruned_blocks(plan)
    nb = -(-n // bsz)
    out = []
    for where, ids, k in (
            (f"(m1)'s BBOX cover ({len(cover)} blocks)",
             torch.from_numpy(kern._pad_blocks(cover)).to(dev), len(cover)),
            (f"all {n} rows ({nb} blocks)",
             torch.arange(nb, dtype=torch.int32, device=dev), nb)):
        nblk = torch.tensor([k], dtype=torch.int32, device=dev)
        for mode in ("count", "mask"):
            args = (cols, qbuf, q, ids, nblk, bsz, mode)
            cut = (lambda r, k=k: (r[0][: k * bsz], r[1])) \
                if mode == "mask" else None
            out.append((f"fused_scan ENV {mode} at {where}",
                        lambda args=args: fused_scan.fused_scan(*args),
                        lambda args=args: scan.fused_scan(*args),
                        env_bound(cols, ids, k, bsz, nbox, mode),
                        200 if k < nb else 20, cut))
    return out


def phase_extent_kernels(m1: dict) -> dict:
    """seg_band and box_count's envelope mode against their plain versions
    on the card: seg_band at (m1)'s candidate blocks and at M_NEAR_N
    segments within a few ulps of the polygon's edges (every block a
    candidate); box_count at (m1)'s BBOX count (any box over its cover) and
    its 64 boxes (per box over their union cover); ``fused_scan``'s ENV
    form at (m1)'s BBOX over its cover and over all the table's blocks,
    count and mask (equal bit for bit, or the run fails; no single PyTorch
    call computes it, so no library time)."""
    import torch
    from geomesa_tpu_torch.filter.geom_numpy import literal_segments
    from geomesa_tpu_torch.filter.parser import parse_ecql
    from geomesa_tpu_torch.index import prune, scan
    from geomesa_tpu_torch.index.spatial import _boxes_fp62

    planner = m1["planner"]
    kern = planner.indexes[0].kernels
    cols, dev = kern.cols, kern.device
    bsz = int(prune.BLOCK_SIZE)
    plan = planner.plan(Q_M1)
    blocks = planner._pruned_blocks(plan)
    edges = literal_segments(parse_ecql(Q_M1).geometry).astype(np.float32)
    ne = max(4, 1 << max(0, len(edges) - 1).bit_length())
    ep = np.tile(scan.EDGE_PAD, (ne, 1))
    ep[: len(edges)] = edges
    e = torch.from_numpy(ep).to(dev)
    boxes = torch.from_numpy(plan.boxes_loose).to(dev)
    bids = torch.from_numpy(kern._pad_blocks(blocks)).to(dev)
    seg = [compare_seg_band("(m1) candidate blocks", cols, boxes, None,
                            None, bids, bsz, e, len(edges), 50)]
    near = near_edge_table(M_NEAR_N, M_SEED + 3, dev)
    all_blocks = torch.arange(-(-M_NEAR_N // bsz), dtype=torch.int32,
                              device=dev)
    qbox = torch.from_numpy(scan.pad_boxes(_boxes_fp62([M_BOX]))).to(dev)
    seg.append(compare_seg_band(f"{M_NEAR_N} near-edge segments", near,
                                qbox, None, None, all_blocks, bsz, e,
                                len(edges), 5))
    del near
    plan_b = planner.plan(Q_M1_BBOX)
    bb = planner._pruned_blocks(plan_b)
    box = [compare_box_count(
        "(m1) BBOX, its cover", cols,
        torch.from_numpy(plan_b.boxes_loose).to(dev), None, None,
        torch.from_numpy(kern._pad_blocks(bb)).to(dev), bsz, False, 50,
        envelope=True),
        compare_box_count(
        "(m1) 64 boxes, union cover", cols,
        torch.from_numpy(scan.pad_boxes(m1["fp"])).to(dev), None, None,
        torch.from_numpy(kern._pad_blocks(m1["union"])).to(dev), bsz, True,
        50, envelope=True)]
    env = [_time_kernel(label, k_, p_, b_, reps, cut=cut)
           for label, k_, p_, b_, reps, cut in env_calls(m1)]
    return {"seg_band": seg, "box_count": box, "fused_scan_env": env}


# -- (q) the geometry catalog -------------------------------------------------
#
# The st_* residuals of (m1)'s and (m3)'s stores through the planner's
# default route, the device catalog (geom/catalog.py): geom_unary for
# st_length / st_area, geom_pred for st_intersects / st_contains (and the
# buffer's), geom_dist for st_distance. Scalar comparisons read the f32
# kernel value, as the reference's route does, so their counts are held to
# a numpy f32 oracle in the reference's arithmetic (the 1/256-degree local
# origin, jnp.hypot's fma(r, r, 1), left-to-right sums, subnormals
# flushed), with the f64 count printed beside it; the booleans are exact.

Q_Q3_CONTAINS = f"st_contains(geom, POINT({M_BUF_P[0]} {M_BUF_P[1]}))"
Q_Q3_INTERSECTS = f"st_intersects(geom, {M_WKT})"
Q_DIST_R = 0.5
Q_Q4 = (f"st_distance(geom, POINT({M_BUF_P[0]} {M_BUF_P[1]})) "
        f"< {Q_DIST_R}")
Q_REPS = 3          # p50 reps of a (q) query on the catalog route
Q_REPS_OFF = 1      # and on the host route (seconds a call at 5M rows)
F32_TINY = 2.0 ** -126

# f32 operations of the catalog's programs, each add, subtraction,
# multiplication, division, square root, min, max and compare one, a fused
# multiply-add two (its two flops). geom_unary per real segment: 2 (x2 −
# x1, y2 − y1) + hypot 8 (max, min, division, fma, sqrt, multiplication,
# the zero test) + the mask 1 + cross 4 (x2·y1, fma, ·w) + 2 sums + 2 (x1
# + x2, y1 + y2) + 4 fma sums (8) = 27; per real vertex 3 (·mask, 2 sums);
# per feature 10 (max, two guards, 2 multiplications, 2 divisions, the
# mode). geom_dist / geom_pred per pair: point → segment 22 (2
# subtractions, ll 3, the numerator 5, the division, the clamp 2, 2 fma
# (4), 2 subtractions, the square 3), the vertex → point square 5, the
# unbanded crossing 8, the proper crossing of a (segment, literal edge)
# pair 4 × 7 + 4 = 32, a banded (point, edge) step 22 (PIP_OPS_PER_PAIR
# and the edge's own 4), a banded (segment, edge) pair SEG_OPS_PER_PAIR
# (64) and the literal's shift into each feature's frame 6 an edge.
GEOM_UNARY_OPS_SEG = 27
GEOM_UNARY_OPS_VERT = 3
GEOM_UNARY_OPS_FEAT = 10
GEOM_PTSEG_OPS = 22
GEOM_PTPT_OPS = 5
GEOM_PIP_OPS = 8
GEOM_CROSS_OPS = 32
GEOM_BAND_OPS = PIP_OPS_PER_PAIR + PIP_OPS_PER_EDGE


def _ftz32(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=np.float32)
    return np.where(np.abs(a) < F32_TINY, a * np.float32(0), a)


def _fma32(a, b, c) -> np.ndarray:
    """f32 a·b + c rounded once (the product exact in f64, the f64 sum
    rounded to odd), flushed: numpy, written out here."""
    p = np.asarray(a, np.float32).astype(np.float64) \
        * np.asarray(b, np.float32).astype(np.float64)
    cd = np.asarray(c, np.float32).astype(np.float64)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    odd = (err != 0) & ((s.view(np.int64) & 1) == 0) & np.isfinite(s)
    s = np.where(odd, np.nextafter(s, np.copysign(np.inf, err)), s)
    return _ftz32(s.astype(np.float32))


def _local32(v: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """f32 coordinates in each feature's frame: minus the centre of its
    envelope rounded to 1/256 degree, in f64, then rounded to f32."""
    ref = np.round(((lo + hi) * 0.5) * 256.0) / 256.0
    return _ftz32((v - ref).astype(np.float32))


def lines_length32(ax, ay, bx, by) -> np.ndarray:
    """st_length of single-segment lines in the catalog's f32 arithmetic:
    jnp.hypot's max · sqrt(fma(r, r, 1)), r = min / max."""
    x1 = _local32(ax, np.minimum(ax, bx), np.maximum(ax, bx))
    x2 = _local32(bx, np.minimum(ax, bx), np.maximum(ax, bx))
    y1 = _local32(ay, np.minimum(ay, by), np.maximum(ay, by))
    y2 = _local32(by, np.minimum(ay, by), np.maximum(ay, by))
    a, b = np.abs(_ftz32(x2 - x1)), np.abs(_ftz32(y2 - y1))
    hi, lo = np.maximum(a, b), np.minimum(a, b)
    with np.errstate(divide="ignore", invalid="ignore"):
        r = _ftz32(lo / np.where(hi == 0, np.float32(1), hi))
    root = _ftz32(np.sqrt(_fma32(r, r, 1.0).astype(np.float64)
                          ).astype(np.float32))
    return np.where(hi == 0, hi, _ftz32(hi * root))


def quads_area32(rings: np.ndarray) -> np.ndarray:
    """st_area of closed quadrilateral rings (n, 5, 2) in the catalog's f32
    arithmetic: Σ fma(x1, y2, −x2·y1)·w left to right, w the sign of the
    ring's f64 signed area, halved, clamped at 0."""
    lo, hi = rings.min(axis=1), rings.max(axis=1)
    lx = _local32(rings[..., 0], lo[:, None, 0], hi[:, None, 0])
    ly = _local32(rings[..., 1], lo[:, None, 1], hi[:, None, 1])
    x, y = rings[..., 0], rings[..., 1]
    sa = 0.5 * np.sum(x * np.roll(y, -1, axis=1) - np.roll(x, -1, axis=1) * y,
                      axis=1)
    w = np.where(sa >= 0, np.float32(1), np.float32(-1))
    a2 = None
    for j in range(4):
        c = _ftz32(_fma32(lx[:, j], ly[:, j + 1],
                          -_ftz32(lx[:, j + 1] * ly[:, j])) * w)
        a2 = c if a2 is None else _ftz32(a2 + c)
    return np.maximum(_ftz32(a2 * np.float32(0.5)), np.float32(0))


def quads_contain_point(rings: np.ndarray, point) -> np.ndarray:
    """f64, written out here: the quadrilaterals holding ``point`` by
    crossing parity, or on an edge."""
    px, py = point
    x1, y1 = rings[:, :4, 0], rings[:, :4, 1]
    x2, y2 = rings[:, 1:, 0], rings[:, 1:, 1]
    cond = (y1 > py) != (y2 > py)
    with np.errstate(divide="ignore", invalid="ignore"):
        xint = (x2 - x1) * (py - y1) / (y2 - y1) + x1
    inside = (np.count_nonzero(cond & (px < xint), axis=1) % 2) == 1
    cross = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)
    on = (cross == 0) & (np.minimum(x1, x2) <= px) & (px <= np.maximum(x1, x2)) \
        & (np.minimum(y1, y2) <= py) & (py <= np.maximum(y1, y2))
    return inside | on.any(axis=1)


class _pack_recorder:
    """Within it, the rows of every ``catalog.pack_features`` call (the
    rows the planner's route hands the catalog)."""

    def __enter__(self):
        from geomesa_tpu_torch.geom import catalog
        self.mod, self.orig, self.calls = catalog, catalog.pack_features, []

        def rec(arr, rows, device=None):
            self.calls.append((arr, np.asarray(rows, dtype=np.int64)))
            return self.orig(arr, rows, device)

        catalog.pack_features = rec
        return self

    def __exit__(self, *exc):
        self.mod.pack_features = self.orig


def catalog_split(kind: str, arr, rows, literal=None, op: int = 0,
                  device: str = "cuda") -> dict:
    """Seconds of one catalog call on ``rows``, by the stages the query
    runs: the pack's host half (``catalog.pack_host``: numpy over the
    ragged offsets), its device half (``catalog.pack_device``: the upload
    and the padded tables built on the card, synchronised), the kernel on
    the pack's real rows (synchronised), and the refine (read back, and the
    f64 host refine of the predicate's uncertain rows); and, apart, the
    whole ``pack_features`` call the query makes."""
    import torch
    from geomesa_tpu_torch.features.geometry import MULTIPOINT, POINT
    from geomesa_tpu_torch.geom import catalog, oracle
    from geomesa_tpu_torch.kernels import geom
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    sync()
    t0 = time.perf_counter()
    catalog.pack_features(arr, rows, dev)
    sync()
    whole = time.perf_counter() - t0
    t0 = time.perf_counter()
    h = catalog.pack_host(arr, rows)
    t1 = time.perf_counter()
    p = catalog.pack_device(h, dev)
    if literal is not None:
        ls, lp, lpoly = catalog.pack_literal(literal, dev)
    sync()
    t2 = time.perf_counter()
    if kind == "unary":
        res = geom.geom_unary(*p.rows(*catalog.UNARY))
    elif kind == "dist":
        res = (geom.geom_dist(*p.rows(*catalog.PAIR), ls, lp, lpoly),)
    else:
        ext = literal[0] not in (POINT, MULTIPOINT)
        res = geom.geom_pred(*p.rows(*catalog.PAIR), ls, lp, op, lpoly, ext)
    sync()
    t3 = time.perf_counter()
    host = [r.cpu().numpy() for r in res]
    n_unc = 0
    if kind == "pred":
        unc = ~host[0] & ~host[1]
        n_unc = int(unc.sum())
        if n_unc:
            oracle.intersects(arr, rows[unc], literal) if op == 0 else \
                oracle.feature_contains(arr, rows[unc], literal)
    t4 = time.perf_counter()
    return {"rows": int(len(rows)), "B": int(p.verts.shape[0]),
            "K": int(p.verts.shape[1]), "S": int(p.segs.shape[1]),
            "uncertain": n_unc, "pack_features_s": whole,
            "pack_host_s": t1 - t0, "pack_device_s": t2 - t1,
            "kernel_s": t3 - t2, "refine_s": t4 - t3}


def _q_count(label: str, store, layer: str, q: str, want, uses,
             want_off=None, device: str = "cuda") -> dict:
    """One (q) query: the count on the catalog route (each kernel of
    ``uses`` launched, counted around the call), equal to ``want``; its
    p50 with GEOMESA_TPU_GEOM_KERNELS on (Q_REPS synced calls after that
    one) and off (Q_REPS_OFF calls: the host f64 route, its count equal to
    ``want_off``); the catalog calls' rows."""
    import torch
    from geomesa_tpu_torch import config as tconfig
    from geomesa_tpu_torch.kernels import geom
    kerns = {"geom_unary": geom.geom_unary, "geom_dist": geom.geom_dist,
             "geom_pred": geom.geom_pred}

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    before = {k: f.launches for k, f in kerns.items()}
    with _pack_recorder() as rec:
        got = store.count(layer, q)
    sync()
    used = {k: kerns[k].launches - before[k] for k in kerns}
    for k in uses:
        if device == "cuda" and used[k] < 1:
            raise AssertionError(f"(q) {label} did not launch {k}: {used}")
    if got != want:
        raise AssertionError(f"(q) {label}: {got} != oracle {want}")

    def p50(reps):
        ts = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            n = store.count(layer, q)
            sync()
            ts.append(time.perf_counter() - t0)
        return p50_ms(ts), n

    on_ms, n = p50(Q_REPS)
    if n != want:
        raise AssertionError(f"(q) {label}: {n} != oracle {want}")
    tconfig.GEOM_KERNELS.set(False)
    try:
        off_ms, n_off = p50(Q_REPS_OFF)
    finally:
        tconfig.GEOM_KERNELS.unset()
    if want_off is not None and n_off != want_off:
        raise AssertionError(f"(q) {label} on the host route: {n_off} != "
                             f"oracle {want_off}")
    r = {"count": int(got), "p50_on_ms": on_ms, "p50_off_ms": off_ms,
         "count_host_route": int(n_off), "launches": used,
         "catalog_rows": [int(len(rw)) for _, rw in rec.calls]}
    log(f"[q] {label}: {json.dumps(r)}")
    r["calls"] = rec.calls
    return r


def phase_catalog(m1: dict, m3: dict, device: str = "cuda") -> dict:
    """(q): the geometry catalog on (m1)'s 5M-line and (m3)'s 500,000-quad
    stores. (q1) st_length(geom) > 1.5 over every line (geom_unary); (q2)
    (m3)'s st_area count in M_BOX (geom_unary) and its buffer count
    (geom_pred); (q3) st_intersects with M_WKT and st_contains of POINT(1
    39) over the quads (geom_pred); (q4) st_distance(geom, POINT(1 39)) <
    0.5 (geom_dist). Scalar counts equal the f32 oracle (the f64 oracle's
    count and the rows on which they differ printed beside), booleans their
    f64 oracles; (q4) equals the plain version's count on the card and
    every candidate's f32 distance is within 2e-4 + 1e-5·d of its f64
    distance (geom/catalog.py's documented tolerance). Each query's p50 on
    and off the catalog, its kernels' launches and the split of its
    catalog call. Returns the measurements, the launches of the whole
    phase and the recorded catalog inputs for the kernel checks."""
    from geomesa_tpu_torch.features.geometry import POINT, parse_wkt
    from geomesa_tpu_torch.geom import catalog, oracle
    from geomesa_tpu_torch.kernels import geom

    for k in (geom.geom_unary, geom.geom_dist, geom.geom_pred):
        k.launches = 0
    out = {}
    ax, ay, bx, by = m1["segments"]
    len32 = lines_length32(ax, ay, bx, by)
    len64 = np.hypot(bx - ax, by - ay)
    want32 = int(np.count_nonzero(len32 > M_LEN))
    want64 = int(np.count_nonzero(len64 > M_LEN))
    q1 = _q_count("q1 st_length", m1["store"], "osm", Q_M1_LEN, want32,
                  ("geom_unary",), want64, device)
    q1.update(f64_count=want64, rows_f32_f64_differ=int(np.count_nonzero(
        (len32 > M_LEN) != (len64 > M_LEN))))
    out["q1"] = q1
    rings, in_box = m3["rings"], m3["in_box"]
    area32 = quads_area32(rings)
    x3, y3 = rings[..., 0], rings[..., 1]
    area64 = np.abs(0.5 * np.sum(x3 * np.roll(y3, -1, axis=1)
                                 - np.roll(x3, -1, axis=1) * y3, axis=1))
    want32 = int(np.count_nonzero(in_box & (area32 > M_AREA)))
    want64 = int(np.count_nonzero(in_box & (area64 > M_AREA)))
    q2 = _q_count("q2 st_area", m3["store"], "parcels", Q_M3_AREA, want32,
                  ("geom_unary",), want64, device)
    q2.update(f64_count=want64, rows_f32_f64_differ=int(np.count_nonzero(
        in_box & ((area32 > M_AREA) != (area64 > M_AREA)))))
    out["q2_area"] = q2
    out["q2_buffer"] = _q_count("q2 buffer", m3["store"], "parcels",
                                Q_M3_BUF, m3["want_buf"], ("geom_pred",),
                                m3["want_buf"], device)
    want = len(m3["want_hits"])
    out["q3_intersects"] = _q_count("q3 st_intersects", m3["store"],
                                    "parcels", Q_Q3_INTERSECTS, want,
                                    ("geom_pred",), want, device)
    want = int(np.count_nonzero(quads_contain_point(rings, M_BUF_P)))
    out["q3_contains"] = _q_count("q3 st_contains", m3["store"], "parcels",
                                  Q_Q3_CONTAINS, want, ("geom_pred",), want,
                                  device)
    # (q4): the plain version's count over the prefilter's candidates (the
    # rows whose envelope meets the point's box of side 2r), on the card
    garr = m3["planner"].table.column("geom")
    bb = garr.bboxes()
    px, py = M_BUF_P
    cand = np.flatnonzero((bb[:, 0] <= px + Q_DIST_R)
                          & (bb[:, 2] >= px - Q_DIST_R)
                          & (bb[:, 1] <= py + Q_DIST_R)
                          & (bb[:, 3] >= py - Q_DIST_R))
    lit = (POINT, [px, py])
    p = catalog.pack_features(garr, cand, device)
    ls, lp, lpoly = catalog.pack_literal(lit, device)
    d32 = catalog._dist_plain(*p.rows(*catalog.PAIR), ls, lp,
                              lpoly).cpu().numpy()
    d64 = oracle.distance(garr, cand, lit)
    tol = 2e-4 + 1e-5 * np.abs(d64)
    worst = float(np.max(np.abs(d32.astype(np.float64) - d64) - tol,
                         initial=-np.inf))
    if worst > 0:
        raise AssertionError(f"(q4) an f32 distance is {worst} past the "
                             "documented tolerance 2e-4 + 1e-5·d")
    want32 = int(np.count_nonzero(d32 < Q_DIST_R))
    want64 = int(np.count_nonzero(d64 < Q_DIST_R))
    q4 = _q_count("q4 st_distance", m3["store"], "parcels", Q_Q4, want32,
                  ("geom_dist",), want64, device)
    q4.update(f64_count=want64, candidates=int(len(cand)),
              rows_f32_f64_differ=int(np.count_nonzero(
                  (d32 < Q_DIST_R) != (d64 < Q_DIST_R))),
              max_abs_f32_f64=float(np.max(np.abs(d32 - d64), initial=0.0)))
    out["q4"] = q4
    out["launches"] = {k.__name__: k.launches
                       for k in (geom.geom_unary, geom.geom_dist,
                                 geom.geom_pred)}
    # the split of each query's catalog call, on the rows it was given
    wkt = parse_wkt(M_WKT)
    for key, kind, literal, op in (
            ("q1", "unary", None, 0), ("q2_area", "unary", None, 0),
            ("q2_buffer", "pred", lit, 0),
            ("q3_intersects", "pred", wkt, 0),
            ("q3_contains", "pred", lit, 2), ("q4", "dist", lit, 0)):
        arr, rows = out[key]["calls"][-1]
        out[key]["split"] = catalog_split(kind, arr, rows, literal, op,
                                          device)
    log(json.dumps({"catalog": {k: {kk: vv for kk, vv in v.items()
                                    if kk != "calls"}
                                if isinstance(v, dict) else v
                                for k, v in out.items()}}))
    return out


def geom_bound(kind: str, p, L: int = 0, P: int = 0,
               out_bytes: int = 4) -> dict:
    """The least time for one catalog kernel call on the ``p.n`` real
    features of pack ``p`` (and a literal of L edges and P points): bytes
    — the features' real vertices (8 B and a mask byte each) and segments
    (16 B and a mask byte; for geom_unary also a 4-byte weight) read once,
    a feature's mode (geom_unary) or polygon flag and 8-byte origin, and
    the outputs written once; operations — the GEOM_* counts over the same
    vertices, segments and literal items. Neither counts the pads the pack
    holds for the reference's shapes (rows past n, slots past a feature's
    own): L and P are the literal's own edges and points, not the padded
    lengths of ``pack_literal``."""
    n = int(p.n)
    nv = int(p.vmask[:n].sum())
    ns = int(p.smask[:n].sum())
    nbytes = nv * 9 + ns * 17 + (ns * 4 + n * 4 if kind == "unary"
                                 else n * 9) + n * out_bytes \
        + 16 * L + 8 * P
    if kind == "unary":
        ops = (GEOM_UNARY_OPS_SEG * ns + GEOM_UNARY_OPS_VERT * nv
               + GEOM_UNARY_OPS_FEAT * n)
    elif kind == "dist":
        ops = (GEOM_PTSEG_OPS * (nv * L + P * ns) + GEOM_PTPT_OPS * nv * P
               + GEOM_PIP_OPS * (nv * L + P * ns) + GEOM_CROSS_OPS * ns * L
               + 6 * L * n)
    else:
        ops = (GEOM_PTSEG_OPS * (nv * L + P * ns) + GEOM_PTPT_OPS * nv * P
               + GEOM_BAND_OPS * (nv * L + P * ns)
               + SEG_OPS_PER_PAIR * ns * L + 6 * L * n)
    return _bound(nbytes, ops)


# the plain versions' rows at the scale of a layer: a seeded slice (their
# pair tables at 5,000,000 lines, or 500,000 quads against a 1,024-edge
# literal, would take minutes and tens of GB)
CATALOG_SLICE_LINES = 1 << 20
CATALOG_SLICE_RING = 4096
CATALOG_SLICE_SEED = 2020


def star_ring(n: int):
    """A closed star-shaped polygon of n edges around POINT(1 39) (at 700,
    tests/test_torch_catalog.py's literal past a tile: L and P 1,024 after
    the padding)."""
    from geomesa_tpu_torch.features.geometry import POLYGON
    ang = np.linspace(0, 2 * np.pi, n + 1)
    r = 12 + 3 * np.sin(7 * ang)
    ring = [[1 + float(a), 39 + float(b)]
            for a, b in zip(r * np.cos(ang), r * np.sin(ang))]
    ring[-1] = ring[0]
    return (POLYGON, [ring])


def catalog_pair_calls(quads, lines, rows: dict, dev) -> list:
    """geom_dist's and geom_pred's shapes, on the card: (q3)'s intersects
    rows against M_WKT and contains rows against POINT(1 39), (q4)'s
    candidates, (q3)'s intersects rows against the 700-edge ring (both
    kernels, in the plan's LIT form), then at the scale of a layer — all 500,000 quads against
    POINT(1 39) (geom_dist), M_WKT (geom_pred op 0, 1, 2) and the 700-edge
    ring (both), and all 5,000,000 lines against M_WKT (geom_pred op 0).
    ``rows`` holds (q)'s rows by key. Each entry: key, kernel name, label,
    the kernel's call, the plain version's call (on a seeded slice of the
    rows where the entry's ``got_rows`` says which), the bound, reps."""
    import torch
    from geomesa_tpu_torch.features.geometry import (MULTIPOINT, POINT,
                                                     parse_wkt)
    from geomesa_tpu_torch.filter import geom_numpy as gn
    from geomesa_tpu_torch.geom import catalog
    from geomesa_tpu_torch.kernels import geom
    lit_pt = (POINT, [M_BUF_P[0], M_BUF_P[1]])
    lits = {"M_WKT": parse_wkt(M_WKT), "POINT(1 39)": lit_pt,
            "the 700-edge ring": star_ring(700)}
    packed = {k: catalog.pack_literal(v, dev) for k, v in lits.items()}
    # the literal's own edges and points: the bound counts no pad
    real = {k: (len(gn.literal_segments(v)), len(gn.literal_coords(v)))
            for k, v in lits.items()}
    rng = np.random.default_rng(CATALOG_SLICE_SEED)
    out = []

    def add(key, layer, kname, arr, rw, litname, op=0, slice_n=None,
            reps=50):
        p = catalog.pack_features(arr, rw, dev)
        args = tuple(p.rows(*catalog.PAIR))
        ls, lp, lpoly = packed[litname]
        ext = lits[litname][0] not in (POINT, MULTIPOINT)
        got_rows = None
        pargs = args
        if slice_n is not None and slice_n < p.n:
            pick = np.sort(rng.choice(p.n, slice_n, replace=False))
            got_rows = torch.from_numpy(pick).to(dev)
            pargs = tuple(t[got_rows] for t in args)
        if kname == geom.NAME_DIST:
            call = (lambda a=args: geom.geom_dist(*a, ls, lp, lpoly))
            plain = (lambda a=pargs: catalog._dist_plain(*a, ls, lp, lpoly))
            bound = geom_bound("dist", p, *real[litname])
        else:
            call = (lambda a=args: geom.geom_pred(*a, ls, lp, op, lpoly, ext))
            plain = (lambda a=pargs: catalog._pred_plain(*a, ls, lp, op,
                                                         lpoly, ext))
            bound = geom_bound("pred", p, *real[litname], out_bytes=2)
        shape = (p.n, p.verts.shape[1], p.segs.shape[1], ls.shape[0],
                 lp.shape[0])
        # (chip_compare.py runs this with a parent tree's wrapper, which
        # may have no plan)
        plan = geom.plan(*shape) if hasattr(geom, "plan") else None
        opname = "" if kname == geom.NAME_DIST else f" op {op}"
        label = (f"{kname}{opname} at {key}: {p.n} rows, K {shape[1]}, S "
                 f"{shape[2]} x {litname} (L {shape[3]}, P {shape[4]}; "
                 f"{real[litname][0]} and {real[litname][1]} real), plan "
                 f"{plan}")
        if got_rows is not None:
            label += (f"; the plain version on {slice_n} of the rows (seed "
                      f"{CATALOG_SLICE_SEED})")
        ident = "_".join((kname.split("_")[1] + opname.replace(" op ", ""),
                          layer, {"M_WKT": "mwkt", "POINT(1 39)": "point",
                                  "the 700-edge ring": "ring"}[litname]))
        out.append({"key": key, "ident": ident, "kernel": kname,
                    "label": label,
                    "call": call, "plain": plain, "bound": bound,
                    "reps": reps, "got_rows": got_rows})

    add("(q3) intersects", "q3", geom.NAME_PRED, quads,
        rows["q3_intersects"], "M_WKT", 0)
    add("(q3) contains", "q3", geom.NAME_PRED, quads, rows["q3_contains"],
        "POINT(1 39)", 2)
    add("(q4)'s candidates", "q4", geom.NAME_DIST, quads, rows["q4"],
        "POINT(1 39)")
    # (q3)'s rows against a long literal: the plan's LIT form
    add("(q3) intersects", "q3", geom.NAME_DIST, quads,
        rows["q3_intersects"], "the 700-edge ring")
    add("(q3) intersects", "q3", geom.NAME_PRED, quads,
        rows["q3_intersects"], "the 700-edge ring", 0)
    every = np.arange(len(quads))
    add("all 500,000 quads", "quads", geom.NAME_DIST, quads, every,
        "POINT(1 39)")
    for op in (0, 1, 2):
        add("all 500,000 quads", "quads", geom.NAME_PRED, quads, every,
            "M_WKT", op)
    add("all 5,000,000 lines", "lines", geom.NAME_PRED, lines,
        np.arange(len(lines)), "M_WKT", 0, CATALOG_SLICE_LINES, 20)
    add("all 500,000 quads", "quads", geom.NAME_DIST, quads, every,
        "the 700-edge ring", 0, CATALOG_SLICE_RING, 10)
    add("all 500,000 quads", "quads", geom.NAME_PRED, quads, every,
        "the 700-edge ring", 0, CATALOG_SLICE_RING, 10)
    return out


def phase_catalog_kernels(qres: dict) -> dict:
    """Each catalog kernel against its plain version on the card (equal bit
    for bit, or the run fails): geom_unary at (q1)'s 5M lines and (q2)'s
    st_area rows; geom_dist and geom_pred at ``catalog_pair_calls``' shapes
    ((q)'s rows and the layers' scale); kernel ms by CUDA events, the plain
    version's ms, the bound, registers and spills (cuobjdump). No single
    PyTorch call computes them: no library time."""
    import torch
    from geomesa_tpu_torch.geom import catalog
    from geomesa_tpu_torch.kernels import geom

    dev = torch.device("cuda")
    out = {"geom_unary": [], "geom_dist": [], "geom_pred": []}
    for key in ("q1", "q2_area"):
        arr, rw = qres[key]["calls"][-1]
        p = catalog.pack_features(arr, rw, dev)
        args = tuple(p.rows(*catalog.UNARY))
        out["geom_unary"].append(_time_kernel(
            f"geom_unary at ({key}): {p.n} rows (B {p.verts.shape[0]}), K "
            f"{p.verts.shape[1]}, S {p.segs.shape[1]}",
            lambda a=args: geom.geom_unary(*a),
            lambda a=args: catalog._unary_plain(*a),
            geom_bound("unary", p, out_bytes=16), 50 if key != "q1" else 20))
        del p, args
    quads = qres["q4"]["calls"][-1][0]
    lines = qres["q1"]["calls"][-1][0]
    rows = {k: qres[k]["calls"][-1][1]
            for k in ("q3_intersects", "q3_contains", "q4")}
    for c in catalog_pair_calls(quads, lines, rows, dev):
        r = _time_kernel(c["label"], c["call"], c["plain"], c["bound"],
                         c["reps"], got_rows=c["got_rows"])
        r["key"] = c["key"]
        out[c["kernel"]].append(r)
        del c
        torch.cuda.empty_cache()
    for name in out:
        res = kernel_resources(name)
        log(f"[kernel] {name} registers and spills (cuobjdump): "
            f"{json.dumps(res)}")
    return out


def phase_extent_s2(points_table, device: str = "cuda",
                    n: int = M_Z2_N) -> dict:
    """(m5): S2 and S3 layers (``geomesa.indices=s2``/``s3``) over (m4)'s
    points, the first ``n`` of the cfg1 corpus (S3 with their dates), on
    stores of their own: (a)'s box (and val > 10; on S3 with its week) as
    a count, a prepared count and rows, and the concave polygon's
    INTERSECTS (on S3 with the week) as a count and rows through
    ``pip_refine`` (its launches counted around them, above 0 on the
    card), each against a numpy oracle."""
    import torch
    from geomesa_tpu_torch.kernels import pip

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    px, py = (v[:n] for v in points_table.geometry().point_xy())
    val = np.asarray(points_table.columns["val"])[:n]
    dtg = np.asarray(points_table.columns["dtg"])[:n]
    inbox = (px >= -10) & (px <= 30) & (py >= 30) & (py <= 55) & (val > 10)
    week = (dtg > np.datetime64("2020-01-05", "ms").astype(np.int64)) \
        & (dtg < np.datetime64("2020-01-12", "ms").astype(np.int64))
    inpoly = oracle_pip(px, py, CONCAVE)
    out = {}
    for kind, spec, cols, qb, wb, qp, wp in (
            ("s2", "val:Int,*geom:Point;geomesa.indices=s2",
             {"val": val, "geom": (px, py)}, Q_M4, inbox, Q_M5_S2_POLY,
             inpoly),
            ("s3", "val:Int,dtg:Date,*geom:Point;geomesa.indices=s3,"
             "geomesa.z3.interval=week",
             {"val": val, "dtg": dtg, "geom": (px, py)}, Q_BOX,
             inbox & week, Q_POLY, inpoly & week)):
        store, planner, load_s, stages = extent_store(device, kind, spec,
                                                      cols)
        for q in (qb, qp):
            if store.explain(kind, q)["index"] != kind:
                raise AssertionError(f"(m5) {q} planned on "
                                     f"{store.explain(kind, q)['index']}")
        want_b, want_p = np.flatnonzero(wb), np.flatnonzero(wp)
        _check(f"m5 {kind} box count", store.count(kind, qb), len(want_b))
        _check(f"m5 {kind} box rows", store.query(kind, qb).indices, want_b)
        count_p50, got = timed(planner.prepare(qb).count, sync)
        _check(f"m5 {kind} prepared box count", got, len(want_b))
        rows_p50, rows = timed(lambda: store.query(kind, qb).indices, sync)
        _check(f"m5 {kind} box rows p50", rows, want_b)
        pip.pip_refine.launches = 0
        _check(f"m5 {kind} polygon count", store.count(kind, qp),
               len(want_p))
        _check(f"m5 {kind} polygon rows", store.query(kind, qp).indices,
               want_p)
        sync()
        pips = pip.pip_refine.launches
        if device == "cuda" and pips < 1:
            raise AssertionError(f"(m5) {kind}'s polygon did not launch "
                                 f"pip_refine")
        poly_p50, got = timed(planner.prepare(qp).count, sync)
        _check(f"m5 {kind} prepared polygon count", got, len(want_p))
        out[kind] = {"n": n, "load_s": load_s, "build_stages_s": stages,
                     "indexes": [i.name for i in planner.indexes],
                     "box_count": len(want_b), "box_count_p50_ms": count_p50,
                     "box_rows_p50_ms": rows_p50,
                     "polygon_count": len(want_p),
                     "polygon_count_p50_ms": poly_p50,
                     "pip_refine_launches": pips}
        store.close()
        del store, planner
    log(json.dumps({"m5": out}))
    return out


def phase_extent_merge(m1: dict, device: str = "cuda",
                       n_add: int = M_APPEND_N) -> dict:
    """(m6): ``n_add`` more cfg2 segments appended into (m1)'s layer and
    flushed by the merge build (``merge_from``: one ``merge_scatter``
    launch on the card), held bitwise to a full rebuild of the merged
    table (permutation, sorted keys, every device column, the segment
    planes included), and the BBOX's count and rows on the merged layer
    against the oracle."""
    import torch
    from geomesa_tpu_torch.features.geometry import GeometryArray
    from geomesa_tpu_torch.features.table import FeatureTable
    from geomesa_tpu_torch.index.spatial import XZ2Index
    from geomesa_tpu_torch.kernels import merge

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    store = m1["store"]
    ax, ay, bx, by = m1["segments"]
    cx, cy, dx, dy = cfg2_segments(n_add, M_SEED + 5)
    coords = np.empty((2 * n_add, 2))
    coords[0::2, 0], coords[0::2, 1] = cx, cy
    coords[1::2, 0], coords[1::2, 1] = dx, dy
    old = store.planner("osm").indexes[0]
    segs = "sx1" in old.device.columns
    n_old = len(old.table)
    merge.merge_scatter.launches = 0
    sync()
    t0 = time.perf_counter()
    store.load("osm", FeatureTable.build(store.get_schema("osm"), {
        "geom": GeometryArray.linestrings(coords)}))
    store.flush("osm")
    sync()
    flush_s = time.perf_counter() - t0
    launches = merge.merge_scatter.launches
    new = store.planner("osm").indexes[0]
    if new.build_stages.get("merge_rows") != n_add:
        raise AssertionError(f"(m6) the flush did not merge: "
                             f"{new.build_stages}")
    if device == "cuda" and launches != 1:
        raise AssertionError(f"(m6) merge_scatter launched {launches} times")
    t0 = time.perf_counter()
    full = XZ2Index(store.get_schema("osm"), store.planner("osm").table,
                    device)
    if segs:
        full.ensure_segment_columns()
    sync()
    rebuild_s = time.perf_counter() - t0
    if not torch.equal(new.perm, full.perm) \
            or not np.array_equal(new.sorted_xz, full.sorted_xz):
        raise AssertionError("(m6) the merged permutation or keys differ "
                             "from the full rebuild's")
    if set(new.device.columns) != set(full.device.columns):
        raise AssertionError(f"(m6) columns {sorted(new.device.columns)} != "
                             f"{sorted(full.device.columns)}")
    for name, col in full.device.columns.items():
        if not torch.equal(new.device.columns[name], col):
            raise AssertionError(f"(m6) column {name} differs from the full "
                                 f"rebuild's")
    ex, ey = np.concatenate([ax, cx]), np.concatenate([ay, cy])
    fx, fy = np.concatenate([bx, dx]), np.concatenate([by, dy])
    want = np.flatnonzero((ex <= M_BOX[2]) & (fx >= M_BOX[0])
                          & (ey <= M_BOX[3]) & (fy >= M_BOX[1]))
    _check("m6 bbox count", store.count("osm", Q_M1_BBOX), len(want))
    _check("m6 bbox rows", store.query("osm", Q_M1_BBOX).indices, want)
    out = {"n_old": n_old, "n_add": n_add, "flush_s": flush_s,
           "merge_scatter_launches": launches,
           "merge_stages_s": dict(new.build_stages),
           "full_rebuild_s": rebuild_s, "segment_planes": segs,
           "columns": len(full.device.columns), "bbox_count": len(want)}
    log(json.dumps({"m6": out}))
    del full
    return out


def vis_expressions(seed: int = N_SEED):
    """8 distinct visibility expressions drawn from a seed, as sorted
    (text, tree) pairs: a label, an AND or an OR of two labels, or
    label&(label|label). None is public, so a set of auths can allow none.
    The tree is the oracle's own form of the expression."""
    rng = np.random.default_rng(seed)
    out = {}
    while len(out) < 8:
        a, b, c = (str(v) for v in rng.choice(N_LABELS, 3, replace=False))
        form = int(rng.integers(0, 4))
        text, tree = ((a, a), (f"{a}&{b}", ("&", [a, b])),
                      (f"{a}|{b}", ("|", [a, b])),
                      (f"{a}&({b}|{c})", ("&", [a, ("|", [b, c])])))[form]
        out.setdefault(text, tree)
    return sorted(out.items())


def oracle_visible(tree, auths) -> bool:
    """The oracle's evaluation of an expression tree under ``auths``."""
    if isinstance(tree, str):
        return tree in auths
    op, kids = tree
    return (all if op == "&" else any)(oracle_visible(k, auths)
                                       for k in kids)


def vis_scan_bound(cols, plan, ids, nblk, bsz: int, k: int) -> dict:
    """``fused_scan``'s bound in its VIS form at ``k`` live blocks of
    ``plan`` (a box, windows, a residual, the allowed codes): bytes — the
    point planes of every candidate; the time planes and the ``__vis__``
    code of those in a box; the residual's columns of those in a box and a
    window (counted by the plain scan of the query cut to its boxes, and
    to its boxes and windows); the block ids; the count. Operations: one
    box's 4 key compares a candidate."""
    import torch
    from geomesa_tpu_torch.index import compiled, scan
    dev = cols["xi"].device
    boxes, windows = plan.boxes_loose, plan.windows
    gate_ = compiled._gate_of(plan.explain["boxes"], len(boxes))
    counts = []
    for parts in ((boxes, gate_, None, None), (boxes, gate_, windows, None)):
        qq = scan.FusedQuery([parts])
        counts.append(int(scan.fused_scan(
            cols, torch.from_numpy(qq.packed).to(dev), qq, ids, nblk, bsz,
            "count")[0]))
    rbytes = sum(cols[c].element_size()
                 for c, _ in plan.residual_device.program.slots)
    cand = k * bsz
    return _bound(16 * cand + (8 + 4) * counts[0] + rbytes * counts[1]
                  + 4 * k + 4, 4 * cand)


def query_profile(fn, device) -> dict:
    """One query's host syncs (CUDA's sync debug mode), device activities,
    busy ms and idle share (the profiler, one call) and p50 of ``REPS``
    synced calls, after a warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from geomesa_tpu_torch.index import scan
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fn()
    sync()
    with scan.host_syncs(device) as hs:
        fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    names = sorted({e.name for e in dev})
    return {"host_syncs": hs.count, "device_activities": len(dev),
            "device_busy_ms": busy, "wall_ms_profiled": wall_ms,
            "idle_share": 1.0 - busy / wall_ms,
            "pageable": [m for m in names if "Pageable" in m],
            "copies": [m for m in names if "Memcpy" in m],
            "p50_ms": timed(fn, sync, REPS)[0]}


def phase_auths(store, oracle, f_oracle) -> dict:
    """(n) on the cfg1 corpus: a store of its own over the main store's
    100M points and columns, each row labelled with one of 8 seed-drawn
    visibility expressions (passed dictionary-encoded, codes and sorted
    vocabulary, as ``FeatureTable.build`` takes a string column), and three
    sets of auths: one that allows some of the 8, one that allows all, one
    that allows none. Every answer equals a numpy oracle that evaluates the
    expressions itself (``oracle_visible``):

    - (n1) (a)'s count, (b)'s polygon count, (c)'s select and (d)'s 64x64
      density under each set, with every kernel's launches read around
      (n1)-(n4) (``fused_scan``'s VIS form and ``pip_refine`` must launch);
    - (n2) (h)'s OR as a count and as rows under the first set;
    - (n3) an ``IN`` of 1,000 seed-drawn feature ids, alone and ANDed with
      (a)'s box, with and without the first set;
    - (n4) (a)'s filter sorted on ``-val`` then ``dtg``, limited to 1,000,
      transformed to ``["val", "geom"]`` and reprojected to EPSG:3857,
      with and without the first set;
    - (n5) on the main store, the rows path: (c)'s, (h)'s, (i)'s and (j)'s
      rows and (b)'s, (i)'s and (j)'s counts with the host permutation not
      cached (each mapping a device gather), their host syncs (CUDA's
      sync debug mode) and device activities, then the first select of
      more than 2^20 rows ((f)'s) with its one permutation read-back and
      the host memory of the cache;

    then ``fused_scan``'s VIS form against its plain version at (a)'s
    alive blocks and over every block (on the card). ``store``'s device
    runs it (``cpu``: a dry run of the protocol, without the kernel
    timings and profiles). Returns the launches and the VIS rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from geomesa_tpu_torch import DataStoreFinder
    from geomesa_tpu_torch.features.table import FeatureTable, StringColumn
    from geomesa_tpu_torch.index import compiled, scan
    from geomesa_tpu_torch.index.spatial import _row_gather
    from geomesa_tpu_torch.kernels import (box_count, compact, density,
                                           fused_scan, gate, pip)

    cuda = store.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    main = store.planner("gdelt").table
    n = len(main)
    x, y = main.geometry().point_xy()
    val = np.asarray(main.columns["val"])
    dtg = np.asarray(main.columns["dtg"])
    exprs = vis_expressions()
    vocab = [t for t, _ in exprs]
    codes = np.random.default_rng(N_SEED).integers(0, len(vocab), n) \
        .astype(np.int32)
    sets = {"all": list(N_LABELS), "none": []}
    sets["some"] = next(a for a in (["admin"], ["admin", "ops"], ["ops"],
                                    ["user", "intel"], ["ext"], ["intel"])
                        if 0 < sum(oracle_visible(t, a) for _, t in exprs)
                        < len(exprs))
    luts = {k: np.array([oracle_visible(t, a) for _, t in exprs])
            for k, a in sets.items()}
    if not luts["all"].all() or luts["none"].any():
        raise AssertionError(f"auths sets {sets} do not allow all / none")
    some = sets["some"]
    ok_some = luts["some"][codes]

    t0 = time.perf_counter()
    vstore = DataStoreFinder.get_data_store(type="torch",
                                            device=store.device)
    sft = vstore.create_schema("gvis", SPEC)
    vstore.load("gvis", FeatureTable.build(
        sft, {k: main.columns[k] for k in ("name", "val", "dtg", "geom")},
        visibilities=StringColumn(codes, vocab)))
    sync()
    load_s = time.perf_counter() - t0
    vplanner = vstore.planner("gvis")
    vidx = vplanner.indexes[0]
    if "__vis__" not in vidx.device.columns:
        raise AssertionError("(n) the store has no __vis__ plane")
    log(f"[auths] (n) store of {n} rows labelled with {json.dumps(vocab)} "
        f"loaded in {load_s} s; auths sets {json.dumps(sets)}, the first "
        f"allowing {int(luts['some'].sum())} of {len(vocab)}")

    counters = {"pip_refine": pip.pip_refine,
                "grid_scatter": density.grid_scatter,
                "box_count": box_count.box_count,
                "block_gate": gate.block_gate,
                "fused_scan": fused_scan.fused_scan,
                "ordered_compact": compact.ordered_compact}
    for c in counters.values():
        c.launches = 0
    fused_scan.fused_scan.vis_launches = 0
    a_rows, b_rows, d_rows = oracle["a_rows"], oracle["b_rows"], \
        oracle["d_rows"]
    checks, answers = {}, {}

    # (n1) the main path's queries under each set of auths
    for key, auths in sets.items():
        ok = luts[key][codes]
        vis_before = fused_scan.fused_scan.vis_launches
        pip_before = pip.pip_refine.launches
        got_a = vstore.count("gvis", Q_BOX, auths=auths)
        got_b = vstore.count("gvis", Q_POLY, auths=auths)
        got_c = vstore.query("gvis", Q_POLY, auths=auths).indices
        got_d = vstore.query("gvis", Q_D, hints=density_hint(D_BBOX, 64, 64),
                             auths=auths).weights
        want_b = b_rows[ok[b_rows]]
        want_d = oracle_density(x, y, d_rows[ok[d_rows]], D_BBOX, 64, 64)
        checks[f"n1_{key}"] = (
            got_a == int(ok[a_rows].sum()) and got_b == len(want_b)
            and np.array_equal(got_c, want_b)
            and np.array_equal(got_d, want_d.astype(np.float32)))
        answers[f"n1_{key}"] = {
            "a": got_a, "b": got_b, "c_rows": len(got_c),
            "d_sum": float(got_d.sum()),
            "vis_launches": fused_scan.fused_scan.vis_launches - vis_before,
            "pip_refine": pip.pip_refine.launches - pip_before}
    if cuda and (answers["n1_some"]["vis_launches"] < 4
                 or answers["n1_some"]["pip_refine"] < 2
                 or answers["n1_all"]["vis_launches"] != 0
                 or answers["n1_none"]["vis_launches"] != 0):
        raise AssertionError(f"(n1) launches {json.dumps(answers)}: the "
                             "first auths must launch fused_scan's VIS "
                             "form for (a)-(d) and pip_refine for (b), (c); "
                             "all and none not the VIS form")

    # (n2) (h)'s OR under the first set
    h_rows = f_oracle["h_rows"]
    want_h = h_rows[ok_some[h_rows]]
    got_hc = vstore.count("gvis", Q_H, auths=some)
    got_hr = vstore.query("gvis", Q_H, auths=some).indices
    checks["n2"] = got_hc == len(want_h) and np.array_equal(got_hr, want_h)
    answers["n2"] = {"count": got_hc, "rows": len(got_hr)}

    # (n3) feature ids
    fid_rows = np.sort(np.random.default_rng(N_SEED + 1).choice(
        n, N_FIDS, replace=False))
    q_fid = "IN (" + ", ".join(f"'{r}'" for r in fid_rows) + ")"
    in_a = np.zeros(n, dtype=bool)
    in_a[a_rows] = True
    for label, q, auths, want in (
            ("fid", q_fid, None, fid_rows),
            ("fid_auths", q_fid, some, fid_rows[ok_some[fid_rows]]),
            ("fid_box", f"{q_fid} AND {Q_BOX}", None,
             fid_rows[in_a[fid_rows]]),
            ("fid_box_auths", f"{q_fid} AND {Q_BOX}", some,
             fid_rows[in_a[fid_rows] & ok_some[fid_rows]])):
        got_n = vstore.count("gvis", q, auths=auths)
        got_r = vstore.query("gvis", q, auths=auths).indices
        checks[f"n3_{label}"] = got_n == len(want) \
            and np.array_equal(got_r, want)
        answers[f"n3_{label}"] = got_n
    del in_a

    # (n4) the shaping hints on (a)'s filter
    hints = {"sort": ["-val", "dtg"], "limit": 1000,
             "transform": ["val", "geom"], "crs": "EPSG:3857"}
    R = 6378137.0
    for label, auths in (("shaped", None), ("shaped_auths", some)):
        rows = a_rows if auths is None else a_rows[ok_some[a_rows]]
        want = rows[np.lexsort((rows, dtg[rows], -val[rows].astype(
            np.int64)))][:1000]
        res = vstore.query("gvis", Q_BOX, hints=dict(hints), auths=auths)
        gx, gy = res.table.geometry().point_xy()
        wy = np.clip(y[want], -85.051128779806604, 85.051128779806604)
        checks[f"n4_{label}"] = (
            np.array_equal(res.indices, want)
            and [a.name for a in res.table.sft.attributes] == ["val", "geom"]
            and np.array_equal(np.asarray(res.table.columns["val"]),
                               val[want])
            and np.allclose(gx, R * np.radians(x[want]), rtol=1e-12, atol=0)
            and np.allclose(gy, R * np.log(np.tan(np.pi / 4
                                                  + np.radians(wy) / 2)),
                            rtol=1e-12, atol=0))
        answers[f"n4_{label}"] = len(res.indices)
    sync()
    launches = {k: c.launches for k, c in counters.items()}
    vis_launches = fused_scan.fused_scan.vis_launches
    if not all(checks.values()):
        raise AssertionError(f"(n) differs from its oracles: "
                             f"{[k for k, v in checks.items() if not v]}; "
                             f"{json.dumps(answers)}")
    log(f"[auths] (n1)-(n4) equal to their oracles: {json.dumps(answers)}; "
        f"launches {json.dumps(launches)}, of them fused_scan's VIS form "
        f"{vis_launches}")

    p50 = {}
    for label, fn in (
            ("a_count", lambda: vstore.count("gvis", Q_BOX, auths=some)),
            ("b_count", lambda: vstore.count("gvis", Q_POLY, auths=some)),
            ("c_rows", lambda: vstore.query("gvis", Q_POLY, auths=some)),
            ("d_density", lambda: vstore.query(
                "gvis", Q_D, hints=density_hint(D_BBOX, 64, 64),
                auths=some)),
            ("h_count", lambda: vstore.count("gvis", Q_H, auths=some)),
            ("fid_count", lambda: vstore.count("gvis", q_fid, auths=some)),
            ("shaped", lambda: vstore.query("gvis", Q_BOX,
                                            hints=dict(hints),
                                            auths=some))):
        p50[label] = timed(fn, sync, REPS)[0]

    # fused_scan's VIS form against its plain version, (a) under the first
    # set of auths
    plan_v = vplanner._apply_auths(vplanner.plan(Q_BOX), some)
    prog_v = compiled.Program(plan_v, "count")
    if not prog_v.query.vis:
        raise AssertionError("(n) (a)'s program has no vis section")
    cols, bsz = vidx.device.columns, prog_v.bsz
    ids_a, _, nblk_a = prog_v._gate()
    nb = -(-n // bsz)
    ids_all = torch.arange(nb, dtype=torch.int32, device=cols["xi"].device)
    nblk_all = torch.tensor([nb], dtype=torch.int32, device=ids_all.device)
    vis_rows = []
    k_a = int(nblk_a[0])
    for label, ids, nblk, k, reps in () if not cuda else (
            (f"fused_scan VIS count at (a)'s {k_a} alive blocks", ids_a,
             nblk_a, k_a, 200),
            (f"fused_scan VIS count over all {nb} blocks", ids_all,
             nblk_all, nb, 20)):
        args = (cols, prog_v.qbuf, prog_v.query, ids, nblk, bsz, "count")
        vis_rows.append(_time_kernel(
            label, lambda args=args: fused_scan.fused_scan(*args),
            lambda args=args: scan.fused_scan(*args),
            vis_scan_bound(cols, plan_v, ids, nblk, bsz, k), reps))
    del vstore, vplanner, vidx, cols, prog_v, plan_v
    torch.cuda.empty_cache()

    # (n5) the rows path on the main store: first with no host permutation
    # cached (every set below 2^20 rows, so each mapping is a device
    # gather), then (h)'s rows, past 2^20, which read it back once
    idx = store.planner("gdelt").indexes[0]
    idx._perm_cache = None
    idx.build_stages.pop("perm_readback_s", None)

    def measure(fn) -> dict:
        return query_profile(fn, store.device)

    rows_path = {}
    for label, fn in (
            ("b_count", lambda: store.count("gdelt", Q_POLY)),
            ("c_rows", lambda: store.query("gdelt", Q_POLY).indices),
            ("i_lt_count", lambda: store.count("gdelt", Q_I_LT)),
            ("i_lt_rows", lambda: store.query("gdelt", Q_I_LT).indices),
            ("j_contains_count", lambda: store.count("gdelt",
                                                     Q_J_CONTAINS)),
            ("j_contains_rows", lambda: store.query(
                "gdelt", Q_J_CONTAINS).indices)):
        rows_path[label] = measure(fn)
    cached_after_small = idx._perm_cache is not None
    sync()
    t0 = time.perf_counter()
    got_h = store.query("gdelt", Q_H).indices
    first_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(got_h, h_rows) or idx._perm_cache is None:
        raise AssertionError("(n5) (h)'s rows differ from their oracle or "
                             "left no host permutation")
    perm_read = {"rows": len(got_h), "first_select_ms": first_ms,
                 "perm_readback_s": idx.build_stages["perm_readback_s"],
                 "host_perm_bytes": int(idx._perm_cache.nbytes),
                 "cached_after_small_sets": cached_after_small}
    rows_path["h_rows_cached"] = measure(lambda: store.query(
        "gdelt", Q_H).indices)
    # the mapping alone at (h)'s positions, by each route of the rule
    prog_h = compiled.UnionProgram(store.planner("gdelt").plan(Q_H),
                                   "select", sel_cap=1 << 21)
    out_h = scan._fetch(prog_h.run).numpy()
    pos_h = out_h[1: 1 + int(out_h[0])].astype(np.int64)
    perm_read["map_ms_host_perm"] = timed(lambda: idx.host_perm[pos_h],
                                          sync, REPS)[0]
    perm_read["map_ms_device_gather"] = timed(
        lambda: _row_gather(idx.perm, pos_h), sync, REPS)[0]
    rows_path["f_rows_cached"] = measure(lambda: store.query(
        "gdelt", Q_F).indices)
    log(json.dumps({"auths": {
        "n": n, "load_s": load_s, "vocab": vocab, "sets": sets,
        "answers": answers, "p50_ms_first_auths": p50,
        "launches_checked_run": launches, "vis_launches": vis_launches,
        "rows_path": rows_path, "perm_readback": perm_read}}))
    return {"launches": launches, "vis_launches": vis_launches,
            "vis_rows": vis_rows}


# -- (p) the attribute index on the cfg1 corpus --------------------------------

P_SPEC = ("code:String:index=true,val:Int:index=true,dtg:Date,*geom:Point;"
          "geomesa.z3.interval=week")
P_SEED = 1235               # the codes' own generator: the corpus's stays
P_CODES = 300
P_ZIPF = 1.1
P_SHARE = 0.001             # (p1)'s code: the one nearest this share
Q_P3 = "code >= 'M' AND code < 'P'"
Q_P4 = f"val BETWEEN 40 AND 42 AND BBOX(geom, -10, 30, 30, 55) AND {DURING}"
P_RUNS_N = 1 << 25          # the RUNS kernel's big shapes: 33,554,432 rows
# HIST's subnormal re-check (lo, hi, bins): a range under 2^-126, bins
# narrower than 2^-126 whose range and reciprocal are normal (the edges,
# the flushed guess), and bins of 2^-100 (the guess without flushes)
P_HIST = ((0.0, 1e-40, 8), (0.0, 1e-37, 20), (-1e-37, 1e-37, 4096),
          (0.0, 20 * 2.0**-100, 20))
P_READERS = 3               # counting threads beside the reindex


def p_codes(n: int):
    """(codes int32 a row, sorted vocabulary): 300 distinct random
    three-letter codes, drawn with a Zipf-like skew (s = 1.1 over a
    seed-drawn rank) from a generator of their own. The distribution is
    synthetic: it stands for a skewed categorical column of event codes,
    and no public count of any code set's shares is behind it."""
    rng = np.random.default_rng(P_SEED)
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))
    vocab = set()
    while len(vocab) < P_CODES:
        vocab.add("".join(rng.choice(letters, 3)))
    vocab = sorted(vocab)
    rank = rng.permutation(P_CODES)
    p = 1.0 / (rank + 1.0) ** P_ZIPF
    return rng.choice(P_CODES, n, p=p / p.sum()).astype(np.int32), vocab


def runs_bound(cols, stage, space, runs, mode: str, vis) -> dict:
    """``fused_scan``'s RUNS form at ``runs`` of one stage: bytes — the
    point planes of every candidate (a stage with boxes), the time planes
    of those in a box (every candidate without boxes), the residual's
    columns of those in a box and a window (counted by the plain scan of
    the stage cut to its boxes, and to its boxes and windows), 4 bytes of
    ``__vis__`` a candidate in the VIS form, 12 bytes a piece (block id
    and bounds), a mask byte a candidate in MASK, the count; operations:
    four key compares a candidate a box."""
    import torch
    from geomesa_tpu_torch.index import scan
    kind, boxes, windows, residual = stage
    ids, bounds, nb, _, bsz = space
    cand = int(sum(h - l for l, h in runs))
    counts = []
    for cut in ((kind, boxes, None, None), (kind, boxes, windows, None)):
        q = scan.staged_query(cols, [cut])
        counts.append(int(scan.fused_scan(
            cols, torch.from_numpy(q.packed).to(ids.device), q, ids, nb, bsz,
            "count", runs=bounds)[0]))
    rbytes = 0 if residual is None or residual.program is None else sum(
        cols[c].element_size() for c, _ in residual.program.slots)
    nbox = 0 if boxes is None else len(boxes)
    point = 16 * cand if nbox else 0
    tier = 0 if windows is None else 8 * (counts[0] if nbox else cand)
    return _bound(point + tier + rbytes * counts[1] + (4 * cand if vis else 0)
                  + 12 * int(nb[0]) + (cand if mode == "mask" else 0) + 4,
                  4 * cand * max(1, nbox))


def phase_attribute(store) -> dict:
    """(p) on the cfg1 corpus: a store of its own over the main store's
    100M points, dates and ``val``, with a ``code`` column of 300
    three-letter codes (``p_codes``) and the schema ``P_SPEC`` (``code`` and
    ``val`` indexed), each row labelled as in (n). Every answer equals a
    numpy oracle:

    - (p1) ``code = <the code nearest 0.1% of rows>``, count and rows;
    - (p2) ``code IN`` five codes, one repeated, out of order, count (the
      port counts a row once: numpy's answer);
    - (p3) ``code >= 'M' AND code < 'P'`` (bounds outside the vocabulary),
      count;
    - (p4) ``val BETWEEN 40 AND 42`` with (a)'s box and week, count and
      rows, with the index the planner chose and each index's estimated
      (the battery's) and actual candidates;
    - (p5) (p1) under (n)'s first auths (``fused_scan``'s RUNS form with
      its VIS section);
    - (p6) (p1) ANDed with (b)'s concave polygon: the slice, then the host
      refine;

    with every kernel's launches read around (p1)-(p6) (``fused_scan``'s
    RUNS form must launch), each query's p50, host syncs and device
    activities, ``explain`` of (p1) and (p4), the build split of every
    index and the load's peak device memory; then ``reindex`` under
    ``P_READERS`` counting threads (every count unchanged, the generation
    bumped once) and ``update_schema`` adding an Int attribute, each
    followed by counts against the oracle. Then the RUNS kernel against its
    plain version (``phase_attribute_kernels``). The store is freed before
    the next phase."""
    import threading

    import torch

    from geomesa_tpu_torch import DataStoreFinder
    from geomesa_tpu_torch.features.table import FeatureTable, StringColumn
    from geomesa_tpu_torch.filter.parser import parse_ecql
    from geomesa_tpu_torch.kernels import (box_count, compact, density,
                                           fused_scan, gate, pip)

    cuda = store.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    main = store.planner("gdelt").table
    n = len(main)
    x, y = main.geometry().point_xy()
    val = np.asarray(main.columns["val"])
    dtg = np.asarray(main.columns["dtg"])
    t0 = time.perf_counter()
    codes, vocab = p_codes(n)
    codes_s = time.perf_counter() - t0
    exprs = vis_expressions()
    vvocab = [t for t, _ in exprs]
    vcodes = np.random.default_rng(N_SEED).integers(0, len(vvocab), n) \
        .astype(np.int32)
    some = next(a for a in (["admin"], ["admin", "ops"], ["ops"],
                            ["user", "intel"], ["ext"], ["intel"])
                if 0 < sum(oracle_visible(t, a) for _, t in exprs)
                < len(exprs))
    ok_some = np.array([oracle_visible(t, some) for _, t in exprs])[vcodes]

    # the oracles
    per_code = np.bincount(codes, minlength=P_CODES)
    c1 = int(np.argmin(np.abs(per_code / n - P_SHARE)))
    in1 = codes == c1
    rows1 = np.flatnonzero(in1)
    by_count = np.argsort(-per_code, kind="stable")
    p2 = [int(by_count[k]) for k in (40, 7, 150, 40, 90)]   # out of order
    in_range = np.array([(v >= "M") & (v < "P") for v in vocab])
    lo_ms = np.datetime64("2020-01-05", "ms").astype(np.int64)
    hi_ms = np.datetime64("2020-01-12", "ms").astype(np.int64)
    sel4 = ((val >= 40) & (val <= 42) & (x >= -10) & (x <= 30) & (y >= 30)
            & (y <= 55) & (dtg > lo_ms) & (dtg < hi_ms))
    rows4 = np.flatnonzero(sel4)
    del sel4
    rows6 = rows1[oracle_pip(x[rows1], y[rows1], CONCAVE)]
    q1 = f"code = '{vocab[c1]}'"
    q2 = "code IN (" + ", ".join(f"'{vocab[c]}'" for c in p2) + ")"
    q6 = f"{q1} AND INTERSECTS(geom, {CONCAVE_WKT})"
    want = {"p1": len(rows1),
            "p2": int(np.isin(codes, sorted(set(p2))).sum()),
            "p3": int(in_range[codes].sum()), "p4": len(rows4),
            "p5": int(ok_some[rows1].sum()), "p6": len(rows6)}

    # the store
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    pstore = DataStoreFinder.get_data_store(type="torch",
                                            device=store.device)
    sft = pstore.create_schema("p", P_SPEC)
    pstore.load("p", FeatureTable.build(
        sft, {"code": StringColumn(codes, vocab), "val": val, "dtg": dtg,
              "geom": main.columns["geom"]},
        visibilities=StringColumn(vcodes, vvocab)))
    sync()
    load_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base_mem if cuda else None
    planner = pstore.planner("p")
    t0 = time.perf_counter()
    total = planner.stats.total   # the battery at its first read
    battery_s = time.perf_counter() - t0
    names = [f"attr:{i.attr}" if i.name == "attr" else i.name
             for i in planner.indexes]
    if names != ["z3", "attr:code", "attr:val"] or total != n:
        raise AssertionError(f"(p) indexes {names}, battery total {total}")
    split = {nm: dict(i.build_stages) for nm, i in zip(names,
                                                       planner.indexes)}
    log(f"[attr] (p) store of {n} rows, {P_CODES} codes (generated in "
        f"{codes_s} s), loaded in {load_s} s; build split by index (s): "
        f"{json.dumps(split)}; the battery at its first read {battery_s} s; "
        f"peak device memory of the load {peak} bytes")

    counters = {"pip_refine": pip.pip_refine,
                "grid_scatter": density.grid_scatter,
                "box_count": box_count.box_count,
                "block_gate": gate.block_gate,
                "fused_scan": fused_scan.fused_scan,
                "ordered_compact": compact.ordered_compact}
    for c in counters.values():
        c.launches = 0
    fused_scan.fused_scan.vis_launches = 0
    fused_scan.fused_scan.runs_launches = 0
    got = {"p1": pstore.count("p", q1), "p2": pstore.count("p", q2),
           "p3": pstore.count("p", Q_P3), "p4": pstore.count("p", Q_P4),
           "p5": pstore.count("p", q1, auths=some),
           "p6": pstore.count("p", q6)}
    rows = {"p1": pstore.query("p", q1).indices,
            "p4": pstore.query("p", Q_P4).indices,
            "p6": pstore.query("p", q6).indices}
    sync()
    launches = {k: c.launches for k, c in counters.items()}
    runs_launches = fused_scan.fused_scan.runs_launches
    vis_launches = fused_scan.fused_scan.vis_launches
    bad = [k for k in want if got[k] != want[k]] + [
        k for k, r in (("p1", rows1), ("p4", rows4), ("p6", rows6))
        if not np.array_equal(rows[k], r)]
    if bad:
        raise AssertionError(f"(p) differs from its oracles at {bad}: got "
                             f"{json.dumps(got)}, want {json.dumps(want)}")
    if cuda and (runs_launches < 5 or vis_launches < 1):
        raise AssertionError(f"(p) fused_scan's RUNS form launched "
                             f"{runs_launches} times, its VIS form "
                             f"{vis_launches}: (p1)-(p3), (p5) and (p6) "
                             "must run on it")
    plans = {}
    for label, q in (("p1", q1), ("p2", q2), ("p3", Q_P3), ("p4", Q_P4),
                     ("p6", q6)):
        est = planner.stats.estimator
        per_index = {}
        for idx in planner.indexes:
            p_ = idx.plan(parse_ecql(q))
            if p_ is None:
                continue
            nm = f"attr:{idx.attr}" if idx.name == "attr" else idx.name
            sel = 1.0
            for on, s_ in (
                    (p_.boxes_loose is not None, lambda p_=p_:
                     est.spatial_selectivity(p_.explain["boxes"])),
                    (p_.windows is not None, lambda p_=p_:
                     est.temporal_selectivity(p_.explain["intervals"]))):
                if on and p_.candidate_slices is None:
                    s_ = s_()
                    sel *= 1.0 if s_ is None else s_
            per_index[nm] = {
                "estimated": p_.n_candidates if p_.candidate_slices
                is not None else sel * n,
                "actual": p_.n_candidates}
        plans[label] = {"chosen": planner.plan(q).explain["index"],
                        "candidates": per_index}
    log(f"[attr] (p1)-(p6) equal to their oracles: {json.dumps(got)}; "
        f"(p1)'s code {vocab[c1]!r}, (p2) {q2}; launches "
        f"{json.dumps(launches)}, of them fused_scan's RUNS form "
        f"{runs_launches} (VIS {vis_launches}); plans {json.dumps(plans)}")

    profiles = {}
    for label, fn in (
            ("p1_count", lambda: pstore.count("p", q1)),
            ("p1_rows", lambda: pstore.query("p", q1).indices),
            ("p2_count", lambda: pstore.count("p", q2)),
            ("p3_count", lambda: pstore.count("p", Q_P3)),
            ("p4_count", lambda: pstore.count("p", Q_P4)),
            ("p4_rows", lambda: pstore.query("p", Q_P4).indices),
            ("p5_count", lambda: pstore.count("p", q1, auths=some)),
            ("p6_count", lambda: pstore.count("p", q6))):
        profiles[label] = query_profile(fn, store.device)
    explain = {}
    for label, q in (("p1", q1), ("p4", Q_P4)):
        e = pstore.explain("p", q, analyze=True)
        explain[label] = {k: e.get(k) for k in (
            "index", "strategy", "cost", "candidates", "scan", "n_boxes",
            "n_windows", "analyze")}
    log(json.dumps({"attribute_queries": profiles, "explain": explain}))

    # reindex under concurrent counts
    g0 = pstore.generation("p")
    old = pstore.planners["p"]
    seen, errors = [], []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            try:
                seen.append(pstore.count("p", q1))
            except Exception as e:  # noqa: BLE001 - collected and raised
                errors.append(repr(e))

    threads = [threading.Thread(target=reader) for _ in range(P_READERS)]
    for t in threads:
        t.start()
    try:
        t0 = time.perf_counter()
        pstore.reindex("p")
        pstore._reindex_threads["p"].join(600)
        reindex_s = time.perf_counter() - t0
    finally:
        stop.set()
        for t in threads:
            t.join()
    st = pstore.reindex_status("p")
    after = pstore.count("p", q1)
    if (st["state"] != "installed" or errors or set(seen) != {want["p1"]}
            or after != want["p1"] or pstore.generation("p") != g0 + 1
            or pstore.planners["p"] is old):
        raise AssertionError(f"(p) reindex {json.dumps(st)}: errors "
                             f"{errors[:3]}, counts {sorted(set(seen))}, "
                             f"after {after}, generation "
                             f"{pstore.generation('p')} (was {g0})")
    del old
    g1 = pstore.generation("p")

    # update_schema: one more attribute, every row 0
    t0 = time.perf_counter()
    pstore.update_schema("p", "extra:Int")
    sync()
    update_s = time.perf_counter() - t0
    evolved = {"p1": pstore.count("p", q1),
               "extra": pstore.count("p", "extra = 0 AND " + q1)}
    if evolved != {"p1": want["p1"], "extra": want["p1"]}:
        raise AssertionError(f"(p) after update_schema {evolved}")
    log(f"[attr] reindex under {P_READERS} counting threads: "
        f"{json.dumps(st)} in {reindex_s} s, {len(seen)} counts all "
        f"{want['p1']}, generation {g0} -> {g1}; "
        f"update_schema adding extra:Int in {update_s} s, then "
        f"{json.dumps(evolved)}")

    kernels = phase_attribute_kernels(pstore, q1, Q_P3, Q_P4, some) \
        if cuda else {"runs": [], "hist": []}
    del pstore, planner
    if cuda:
        torch.cuda.empty_cache()
    log(json.dumps({"attribute": {
        "n": n, "load_s": load_s, "build_split": split,
        "peak_device_bytes": peak, "battery_s": battery_s, "answers": got,
        "launches_checked_run": launches, "runs_launches": runs_launches,
        "vis_launches": vis_launches, "plans": plans,
        "reindex_s": reindex_s, "update_schema_s": update_s}}))
    return {"launches": launches, "runs_launches": runs_launches,
            "runs_rows": kernels["runs"], "hist_rows": kernels["hist"]}


P_WIDE_N = 4_000_000        # (p7)'s store: a sliced plan past the program


def phase_sliced_wide(device: str = "cuda", n: int = P_WIDE_N) -> dict:
    """(p7): a store of its own with an indexed ``a`` and 17 Int columns
    (one past ``fused_scan.MAX_SLOTS``): sliced plans whose residual reads
    all 17, with and without a box, counted and selected — the runs'
    primary on ``fused_scan``'s RUNS form (its launches counted, above 0
    on the card), the residual ANDed in as torch ops over the pieces'
    rows — each equal to numpy."""
    import torch
    from geomesa_tpu_torch.index import scan
    from geomesa_tpu_torch.kernels import fused_scan

    cs = [f"c{i}" for i in range(fused_scan.MAX_SLOTS + 1)]
    spec = ("a:Int:index=true," + ",".join(f"{c}:Int" for c in cs)
            + ",dtg:Date,*geom:Point;geomesa.z3.interval=week")
    rng = np.random.default_rng(P_SEED + 7)
    base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
    cols = {"a": rng.integers(0, 2000, n).astype(np.int32),
            "dtg": base + rng.integers(0, 30 * 86400000, n),
            "geom": (rng.uniform(-180, 180, n), rng.uniform(-90, 90, n))}
    for c in cs:
        cols[c] = rng.integers(0, 10, n).astype(np.int32)
    resid = " AND ".join(f"{c} > 0" for c in cs)
    x, y = cols["geom"]
    allc = np.all([cols[c] > 0 for c in cs], axis=0)
    qs = {f"a = 3 AND {resid}": (cols["a"] == 3) & allc,
          f"a = 7 AND BBOX(geom, -60, -40, 60, 40) AND {resid}":
          (cols["a"] == 7) & allc & (x >= -60) & (x <= 60) & (y >= -40)
          & (y <= 40)}
    store, planner, load_s, _ = extent_store(device, "wide", spec, cols)
    fused_scan.fused_scan.runs_launches = 0
    out = {"n": n, "load_s": load_s, "queries": []}
    for q, m in qs.items():
        plan = planner.plan(q)
        stage = (plan.primary_kind, plan.boxes_loose, plan.windows,
                 plan.residual_device)
        if plan.candidate_slices is None or scan.staged_query(
                plan.index.kernels.cols, [stage]) is not None:
            raise AssertionError(f"(p7) {q[:30]}... is not a sliced plan "
                                 f"past the program")
        want = np.flatnonzero(m)
        _check("p7 count", store.count("wide", q), len(want))
        _check("p7 rows", store.query("wide", q).indices, want)
        out["queries"].append({"candidates": plan.n_candidates,
                               "count": len(want)})
    if device == "cuda":
        torch.cuda.synchronize()
    out["runs_launches"] = fused_scan.fused_scan.runs_launches
    if device == "cuda" and out["runs_launches"] < 1:
        raise AssertionError("(p7) the RUNS form did not launch")
    store.close()
    log(json.dumps({"attribute_wide": out}))
    return out


def phase_attribute_kernels(pstore, q1: str, q3: str, q4: str,
                            some) -> dict:
    """``fused_scan``'s RUNS form against its plain version on the card:
    at (p1)'s, (p3)'s and (p4)'s runs (their plans on ``attr:code`` and
    ``attr:val``) in count mode and (p1)'s in mask mode; at 33,554,432
    candidates of ``attr:code`` in 1, 64 and 4,096 runs with unaligned
    starts, with (a)'s box, week and residual, in count mode, the 4,096
    runs also in mask mode, in the VIS form (under (n)'s first auths) and
    with no box. Then ``masked_hist`` HIST over ``P_HIST``'s subnormal
    ranges on ``val`` and on values at and around their edges and across
    the subnormals, against the plain version."""
    import torch

    from geomesa_tpu_torch.aggregates import stats_scan
    from geomesa_tpu_torch.filter.parser import parse_ecql as parse
    from geomesa_tpu_torch.index import scan
    from geomesa_tpu_torch.index.spatial import BaseSpatialIndex
    from geomesa_tpu_torch.kernels import fused_scan, hist

    planner = pstore.planner("p")
    by = {f"attr:{i.attr}": i for i in planner.indexes if i.name == "attr"}
    out = []

    def block_form(idx, stage, runs, reps):
        """(ms, candidates) of ``fused_scan``'s block form (its count) over
        the table's 4,096-row blocks that ``runs`` touch, on the same
        index's columns: the same rows, read as blocks."""
        k = idx.kernels
        query = scan.staged_query(k.cols, [stage])
        qbuf = torch.from_numpy(query.packed).to(k.device)
        ids = np.unique(np.concatenate([np.arange(lo // 4096,
                                                  (hi - 1) // 4096 + 1)
                                        for lo, hi in runs]))
        dids = torch.from_numpy(ids.astype(np.int32)).to(k.device)
        nb = torch.tensor([len(ids)], dtype=torch.int32, device=k.device)
        ms = cuda_ms(lambda: fused_scan.fused_scan(
            k.cols, qbuf, query, dids, nb, 4096, "count"), reps)
        return ms, len(ids) * 4096

    def compare(label, idx, stage, runs, mode, reps, vis=False):
        k = idx.kernels
        space = k._runs_space(runs)
        ids, bounds, nb, _, bsz = space
        query = scan.staged_query(k.cols, [stage])
        if query is None or query.vis != vis:
            raise AssertionError(f"(p) {label}: no RUNS query")
        qbuf = torch.from_numpy(query.packed).to(k.device)
        args = (k.cols, qbuf, query, ids, nb, bsz, mode)
        cut = None if mode == "count" else (
            lambda r, live=int(nb[0]) * bsz: (r[0][:live], r[1]))
        out.append(_time_kernel(
            f"fused_scan RUNS {mode} {label}: {len(runs)} runs, "
            f"{int(sum(h - l for l, h in runs))} candidates, "
            f"{int(nb[0])} pieces",
            lambda: fused_scan.fused_scan(*args, runs=bounds),
            lambda: scan.fused_scan(*args, runs=bounds),
            runs_bound(k.cols, stage, space, runs, mode, vis), reps, cut=cut))

    for label, q, name, modes in (("(p1)", q1, "attr:code", ("count",
                                                             "mask")),
                                  ("(p3)", q3, "attr:code", ("count",)),
                                  ("(p4)", q4, "attr:val", ("count",))):
        idx = by[name]
        p_ = idx.plan(parse(q))
        stage = (p_.primary_kind, p_.boxes_loose, p_.windows,
                 p_.residual_device)
        for mode in modes:
            compare(label, idx, stage, p_.candidate_slices, mode, 50)
    idx = by["attr:code"]
    base = BaseSpatialIndex.plan(idx, parse(Q_BOX))
    stage = (base.primary_kind, base.boxes_loose, base.windows,
             base.residual_device)
    vis_stage = planner._apply_auths(base, some)
    vis_stage = (vis_stage.primary_kind, vis_stage.boxes_loose,
                 vis_stage.windows, vis_stage.residual_device)
    n = idx.device.n
    for k_runs in (1, 64, 4096):
        # sorted, disjoint, spread over the table, starts not multiples of 4
        width, step = P_RUNS_N // k_runs, (n - 16) // k_runs
        runs = [(12345, 12345 + P_RUNS_N)] if k_runs == 1 else [
            (3 + i * step + i % 7, 3 + i * step + i % 7 + width)
            for i in range(k_runs)]
        compare(f"at {k_runs} runs", idx, stage, runs, "count", 20)
        ms_b, cand_b = block_form(idx, stage, runs, 20)
        out[-1].update(block_form_ms=ms_b, block_form_candidates=cand_b)
        log(f"[kernel] fused_scan block form over the {cand_b // 4096} "
            f"blocks of 4,096 rows that the {k_runs} runs touch ({cand_b} "
            f"candidates): {ms_b} ms; the RUNS form {out[-1]['ms']} ms over "
            f"its {P_RUNS_N}")
        if k_runs == 4096:
            compare(f"at {k_runs} runs", idx, stage, runs, "mask", 20)
            compare(f"VIS at {k_runs} runs", idx, vis_stage, runs, "count",
                    20, vis=True)
            compare(f"boxless at {k_runs} runs", idx,
                    ("none", None, stage[2], stage[3]), runs, "count", 20)

    # HIST over subnormal ranges and bins narrower than 2^-126, as the
    # reference's CPU program flushes
    hrows = []
    col = idx.device.columns["val"]
    f32 = np.float32
    hrng = np.random.default_rng(P_SEED + 1)
    tiny = np.finfo(f32).tiny
    for lo, hi, bins in P_HIST:
        edges = f32(lo) + (f32(hi) - f32(lo)) * np.arange(
            bins + 1, dtype=f32) / f32(bins)
        vals = np.concatenate([
            edges, np.nextafter(edges, f32(np.inf)),
            np.nextafter(edges, f32(-np.inf)),
            np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45, -1e-45,
                      1.0, -1.0], f32),
            (tiny * hrng.uniform(-2.0, 2.0, 1 << 18)
             * np.exp2(-hrng.integers(0, 24, 1 << 18))).astype(f32),
            hrng.uniform(lo - (hi - lo), hi + (hi - lo),
                         1 << 20).astype(f32)])
        fcol = torch.from_numpy(vals.astype(f32)).to(col.device)
        for label, c in (("val", col), ("edges", fcol)):
            mask = torch.ones(c.shape[0], dtype=torch.bool, device=c.device)
            got = hist.masked_hist("hist", mask, c, lo=lo, hi=hi, bins=bins)
            torch.cuda.synchronize()
            want = stats_scan.masked_hist("hist", mask, c,
                                          lo=float(f32(lo)),
                                          hi=float(f32(hi)), bins=bins)
            err = _equal_or_raise(f"masked_hist HIST lo {lo} hi {hi} "
                                  f"{bins} bins on {label}", got, want)
            counts = got.tolist()
            hrows.append({"range": [lo, hi, bins], "label": label,
                          "counts": counts if bins <= 20 else
                          {"nonzero_bins": sum(1 for x in counts if x),
                           "total": sum(counts)},
                          "max_abs_err": err})
    log(f"[kernel] masked_hist HIST over subnormal ranges: equal to the "
        f"plain version: {json.dumps(hrows)}")
    return {"runs": out, "hist": hrows}


# -- (o) stats, BIN, sampling and KNN on the main store ------------------------

O_STATS = ('Count();Histogram("val",20,0,100);Z2Histogram("geom",5);'
           'Enumeration("name");GroupBy("name",Count());MinMax("val")')
O_VOCAB = ("a", "b", "c")          # the main store's name vocabulary
O_Q = (2.0, 48.0)                  # bench.py cfg4's KNN point
O_REPS = 6                         # cfg4's reps: 2.0 + 0.03 * i, 48.0
EARTH_R_M = 6371008.8
# the full-table route: a box far from the query point — knn's first
# bboxes around the point meet it nowhere, so their plans are empty, the
# range cover declines, and the k nearest come from the full-table kernel
O_FAR_BOX = (100.0, -20.0, 110.0, -10.0)
Q_O_FAR = "BBOX(geom, {}, {}, {}, {})".format(*O_FAR_BOX)


def haversine_np(x1, y1, x2, y2) -> np.ndarray:
    """Great-circle metres in f64, numpy (process/geo.py's formula)."""
    lon1, lat1, lon2, lat2 = (np.radians(np.asarray(a, dtype=np.float64))
                              for a in (x1, y1, x2, y2))
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    a = np.sin(dlat / 2) ** 2 + np.cos(lat1) * np.cos(lat2) \
        * np.sin(dlon / 2) ** 2
    return 2 * EARTH_R_M * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))


def knn_oracle(x, y, q, k: int, dk: float, keep=None):
    """(rows, f64 metres) of the k points nearest q by numpy brute force:
    f64 haversine, argpartition, then a stable sort (ties by row). Only
    rows within dk's latitude band are measured — a great-circle distance
    is at least R times the latitude difference, so every row within dk of
    q lies in the band — where dk is the checked answer's k-th distance:
    once the answer's rows and distances equal the oracle's, its k rows
    lie within dk, so the true k nearest do too."""
    band = dk / EARTH_R_M * 180.0 / np.pi * (1 + 1e-6) + 1e-9
    rows = keep if keep is not None else None
    if rows is None:
        rows = np.flatnonzero(np.abs(y - q[1]) <= band)
    else:
        rows = rows[np.abs(y[rows] - q[1]) <= band]
    d = haversine_np(x[rows], y[rows], q[0], q[1])
    take = min(k, len(d))
    part = np.argpartition(d, take - 1)[:take]
    order = part[np.argsort(d[part], kind="stable")]
    return rows[order], d[order]


def boxes_rows(x, y, boxes) -> np.ndarray:
    """Ascending rows inside any of ``boxes`` (inclusive edges): the
    one-degree cells the boxes touch first, then the exact test."""
    cell = ((np.floor(y).astype(np.int64) + 90) * 361
            + np.floor(x).astype(np.int64) + 180)
    hit = np.zeros(182 * 361, dtype=bool)
    for a, b, c, d in boxes:
        for cy in range(int(np.floor(b)), int(np.floor(d)) + 1):
            for cx in range(int(np.floor(a)), int(np.floor(c)) + 1):
                hit[(cy + 90) * 361 + cx + 180] = True
    cand = np.flatnonzero(hit[cell])
    keep = np.zeros(len(cand), dtype=bool)
    for a, b, c, d in boxes:
        keep |= (x[cand] >= a) & (x[cand] <= c) & (y[cand] >= b) \
            & (y[cand] <= d)
    return cand[keep]


def check_knn(label, got, x, y, q, k, keep=None) -> float:
    rows, dists = got
    if len(rows) != (k if keep is None else min(k, len(keep))):
        raise AssertionError(f"(o) {label}: {len(rows)} rows for k={k}")
    want_rows, want_d = knn_oracle(x, y, q, k, float(dists[-1]), keep)
    if not np.array_equal(rows, want_rows) \
            or dists.tobytes() != want_d.tobytes():
        raise AssertionError(f"(o) {label}: rows or distances differ from "
                             f"the numpy brute force")
    return float(dists[-1])


def stats_oracle(x, y, val, name, rows) -> dict:
    """The (o) spec's leaves over ``rows`` (None: every row), numpy: the
    device kinds with the reference's f32 arithmetic (Histogram: (f32(v) -
    lo) / (hi - lo) * bins; Z2: (x + 180) * f32(1/360) * g), truncated and
    clipped; MinMax by min, max and the distinct count."""
    f32 = np.float32
    v = val if rows is None else val[rows]
    xs = x if rows is None else x[rows]
    ys = y if rows is None else y[rows]
    codes = name if rows is None else name[rows]

    def clip_trunc(a, bins):
        return np.clip(np.nan_to_num(a, nan=0.0), 0, bins - 1).astype(np.int64)
    frac = (v.astype(f32) - f32(0)) / (f32(100) - f32(0))
    hist = np.bincount(clip_trunc(frac * f32(20), 20), minlength=20)
    g = 32
    ix = clip_trunc((xs.astype(f32) + f32(180)) * (f32(1) / f32(360))
                    * f32(g), g)
    iy = clip_trunc((ys.astype(f32) + f32(90)) * (f32(1) / f32(180))
                    * f32(g), g)
    grid = np.bincount(iy * g + ix, minlength=g * g)
    counts = np.bincount(codes, minlength=len(O_VOCAB))
    by_name = {O_VOCAB[i]: int(c) for i, c in enumerate(counts) if c}
    return {"count": int(len(v)), "hist": hist.tolist(),
            "grid": grid.tolist(), "enum": by_name,
            "min": int(v.min()), "max": int(v.max()),
            "distinct": int(np.count_nonzero(np.bincount(
                v.astype(np.int64) - int(v.min()))))}


def check_stats(label, stat, want) -> dict:
    leaves = stat.stats
    got = {"count": leaves[0].count, "hist": leaves[1].counts.tolist(),
           "grid": leaves[2].counts.ravel().tolist(),
           "enum": dict(leaves[3].counts),
           "groupby": {k: s.count for k, s in leaves[4].groups.items()},
           "min": leaves[5].min, "max": leaves[5].max,
           "cardinality": leaves[5].cardinality}
    for key in ("count", "hist", "grid", "enum", "min", "max"):
        if got[key] != want[key]:
            raise AssertionError(f"(o) stats {label}: {key} {got[key]} != "
                                 f"oracle {want[key]}")
    if got["groupby"] != want["enum"]:
        raise AssertionError(f"(o) stats {label}: GroupBy {got['groupby']} "
                             f"!= oracle {want['enum']}")
    if abs(got["cardinality"] - want["distinct"]) > max(2, 0.05
                                                          * want["distinct"]):
        raise AssertionError(f"(o) stats {label}: MinMax cardinality "
                             f"{got['cardinality']} far from the "
                             f"{want['distinct']} distinct values")
    return {"count": got["count"], "cardinality": got["cardinality"],
            "distinct": want["distinct"]}


def bin_oracle(x, y, dtg, name, rows) -> bytes:
    """(a)'s BIN records, track = blake2b of the name & 0x7FFFFFFF, sorted
    by dtg (stable), packed as the 16-byte wire records."""
    import hashlib
    ids = np.array([int.from_bytes(hashlib.blake2b(
        v.encode(), digest_size=8).digest(), "little") & 0x7FFFFFFF
        for v in O_VOCAB], dtype=np.int64).astype(np.int32)
    out = np.empty(len(rows), dtype=[("track", "<i4"), ("dtg", "<i4"),
                                     ("lat", "<f4"), ("lon", "<f4")])
    out["track"] = ids[name[rows]]
    out["dtg"] = (dtg[rows] // 1000).astype(np.int32)
    out["lat"] = y[rows].astype(np.float32)
    out["lon"] = x[rows].astype(np.float32)
    return out[np.argsort(out["dtg"], kind="stable")].tobytes()


def sample_oracle(name, rows, n: int) -> np.ndarray:
    """Every n-th row of each name's run, in row order."""
    keys = name[rows]
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    starts = np.r_[0, np.nonzero(np.diff(sk))[0] + 1]
    pos = np.arange(len(rows)) - np.repeat(starts,
                                           np.diff(np.r_[starts, len(rows)]))
    return np.sort(rows[order[pos % n == 0]])


def phase_process(store, g_oracle) -> dict:
    """(o): bench.py cfg4's KNN, the stats hint, the store's battery, BIN
    and sampling on the main 100M-point store, before the write path
    changes its corpus — every answer against numpy, every kernel's
    launches counted from 0 around the phase."""
    import torch
    from geomesa_tpu_torch.kernels import (box_count, compact, density,
                                           dist, fused_scan, gate, geom,
                                           hist, merge, pip, seg_band, topk)
    from geomesa_tpu_torch.metrics import REGISTRY
    from geomesa_tpu_torch.process import knn
    table = store.tables["gdelt"]
    x, y = table.geometry().point_xy()
    val = np.asarray(table.columns["val"])
    dtg = np.asarray(table.columns["dtg"])
    name = table.columns["name"].codes
    if list(table.columns["name"].vocab) != list(O_VOCAB):
        raise AssertionError("(o) the main store's name vocabulary moved")
    rows_a = g_oracle["a_rows"]
    rows_f = g_oracle["f_rows"]
    planner = store.planner("gdelt")
    counters = {"pip_refine": pip.pip_refine,
                "grid_scatter": density.grid_scatter,
                "box_count": box_count.box_count,
                "dist_refine": dist.dist_refine,
                "merge_scatter": merge.merge_scatter,
                "seg_band": seg_band.seg_band,
                "block_gate": gate.block_gate,
                "fused_scan": fused_scan.fused_scan,
                "ordered_compact": compact.ordered_compact,
                "masked_hist": hist.masked_hist,
                "topk_nearest": topk.topk_nearest}
    for c in counters.values():
        c.launches = 0
    for f in hist.masked_hist.form_launches:
        hist.masked_hist.form_launches[f] = 0
    for f in topk.topk_nearest.form_launches:
        topk.topk_nearest.form_launches[f] = 0
    for r in topk.topk_nearest.route_launches:
        topk.topk_nearest.route_launches[r] = 0
    out = {}

    def kc():
        c = REGISTRY.snapshot()["counters"]
        return c.get("knn.plan_rounds", 0), c.get("knn.device_dispatches", 0)

    # KNN as bench.py cfg4 runs it (bench.py:812-846)
    c0 = kc()
    t0 = time.perf_counter()
    got = knn(planner, *O_Q, 10)
    warm_s = time.perf_counter() - t0
    kth = [check_knn("k=10 warm", got, x, y, O_Q, 10)]
    lat = []
    for i in range(O_REPS):
        q = (O_Q[0] + 0.03 * i, O_Q[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = knn(planner, *q, 10)
        lat.append((time.perf_counter() - t0) * 1e3)
        kth.append(check_knn(f"k=10 at {q}", got, x, y, q, 10))
    c1 = kc()
    nq = O_REPS + 1
    out["cfg4"] = {"warm_s": warm_s, "p50_ms": float(np.median(lat)),
                   "ms": lat, "kth_m": kth,
                   "plan_rounds_per_query": (c1[0] - c0[0]) / nq,
                   "dispatches_per_query": (c1[1] - c0[1]) / nq}
    cases = {}
    for label, q, k, f, keep in (
            ("k=2048 (the device cap)", O_Q, 2048, None, None),
            ("k=2500 (the radius fallback)", O_Q, 2500, None, None),
            ("k=10 with (a)'s filter", O_Q, 10, Q_BOX, rows_a),
            ("k=10 in a far box (the full table)", O_Q, 10, Q_O_FAR,
             boxes_rows(x, y, [O_FAR_BOX]))):
        full0 = topk.topk_nearest.form_launches["full"]
        c0 = kc()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = knn(planner, *q, k, f=f)
        ms = (time.perf_counter() - t0) * 1e3
        c1 = kc()
        cases[label] = {"ms": ms, "kth_m": check_knn(label, got, x, y, q, k,
                                                     keep),
                        "plan_rounds": c1[0] - c0[0],
                        "dispatches": c1[1] - c0[1],
                        "full_table_launches":
                            topk.topk_nearest.form_launches["full"] - full0}
    if cases["k=10 in a far box (the full table)"][
            "full_table_launches"] < 1:
        raise AssertionError("(o) the far box's query did not take the "
                             "full-table route")
    out["knn"] = cases
    log(f"[o] knn cfg4 p50 {out['cfg4']['p50_ms']} ms (warm "
        f"{warm_s} s), plan rounds {out['cfg4']['plan_rounds_per_query']} "
        f"and dispatches {out['cfg4']['dispatches_per_query']} a query, "
        f"k-th {kth[0]} m; {json.dumps(cases)}: equal to the numpy brute "
        f"force")

    # the stats hint over (a) and over INCLUDE
    st = {}
    for label, f, rows in (("a", Q_BOX, rows_a), ("include", "INCLUDE",
                                                  None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stat = store.query("gdelt", f, hints={"stats": O_STATS})
        ms = (time.perf_counter() - t0) * 1e3
        st[label] = dict(check_stats(label, stat,
                                     stats_oracle(x, y, val, name, rows)),
                         ms=ms)
    out["stats"] = st
    battery = store.stats("gdelt")
    est = {}
    for label, f, rows in (("a", Q_BOX, rows_a), ("f", Q_F, rows_f)):
        exact = battery.get_count(f, exact=True)
        if exact != len(rows):
            raise AssertionError(f"(o) exact count ({label}) {exact} != "
                                 f"{len(rows)}")
        est[label] = {"estimated": battery.get_count(f), "exact": exact}
    out["estimates"] = est
    log(f"[o] stats hint {json.dumps(st)}: equal to numpy; the battery's "
        f"estimated and exact counts {json.dumps(est)}")

    # BIN and sampling over (a)
    t0 = time.perf_counter()
    b = store.query("gdelt", Q_BOX, hints={"bin": {"track": "name",
                                                   "sort": True}})
    bin_ms = (time.perf_counter() - t0) * 1e3
    if b.tobytes() != bin_oracle(x, y, dtg, name, rows_a):
        raise AssertionError("(o) (a)'s BIN records differ from numpy")
    t0 = time.perf_counter()
    s = store.query("gdelt", Q_BOX, hints={"sample": {"n": 100,
                                                      "by": "name"}})
    sample_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(s.indices, sample_oracle(name, rows_a, 100)):
        raise AssertionError("(o) (a)'s sample differs from the numpy "
                             "stride")
    out["bin"] = {"records": len(b), "ms": bin_ms}
    out["sample"] = {"rows": len(s.indices), "ms": sample_ms}
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    if launches["masked_hist"] < 1 or launches["topk_nearest"] < 1 \
            or launches["fused_scan"] < 1:
        raise AssertionError(f"(o) launches {json.dumps(launches)}: the "
                             "stats hint must launch masked_hist and knn "
                             "topk_nearest, both behind fused_scan")
    out["launches"] = launches
    out["form_launches"] = {"masked_hist": dict(
        hist.masked_hist.form_launches), "topk_nearest": dict(
        topk.topk_nearest.form_launches), "topk_nearest_routes": dict(
        topk.topk_nearest.route_launches)}
    log(json.dumps({"process": out}))
    return out


def hist_bound(n: int, live: int, col_bytes: int, bins: int) -> dict:
    """The function's own bytes: each row's mask byte, the column bytes of
    the ``live`` rows whose mask is set (no other row's bin is needed),
    the bins written once; a handful of f32 operations a live row."""
    return _bound(n + live * col_bytes + 4 * bins, 8 * live)


def topk_bound(n: int, m: int, live: int, start_bytes: int = 0) -> dict:
    """The function's own bytes: each candidate's mask byte, 8 bytes of
    coordinates of the ``live`` candidates whose mask is set, the block
    starts (BLOCKS), the m pairs out; ~40 f32 operations a live candidate
    (the haversine's transcendental functions). The design's own scratch
    is not the function's: it stands beside the bound as ``design_bytes``
    — the grid route's keys, written once and read once by the level pass
    that hands the prefix over (8 bytes a candidate; more only when more
    than a million composites share a 12-bit digit), none on the
    one-cluster route."""
    from geomesa_tpu_torch.kernels import topk
    # the wrapper's route (an older tree, timed by chip_compare.py, has
    # none); BLOCKS calls pass their starts' bytes
    cmax = getattr(topk, "CLUSTER_MAX" if start_bytes
                   else "FULL_CLUSTER_MAX", 0)
    grid_route = n > cmax
    return {**_bound(n + live * 8 + start_bytes + m * 8, 40 * live),
            "design_bytes": n * 8 if grid_route else 0}


def process_kernel_calls(store) -> list:
    """The ``masked_hist`` and ``topk_nearest`` calls of (o) on the main
    store's tensors, as dicts of kernel, label, key, call, plain version,
    bound, reps, library call and ``cut`` (the results compared bit for
    bit: distances as their bits): each ``masked_hist`` form at (a)'s mask
    and over every row, ``topk_nearest`` FULL at m = 32 and 4,096 over the
    table and BLOCKS at m = 32 on cfg4's cover (knn's memoised radius: run
    cfg4's query first, or the cover falls back to 100 km)."""
    import torch
    from geomesa_tpu_torch.aggregates import stats_scan
    from geomesa_tpu_torch.filter import ir
    from geomesa_tpu_torch.index import prune, scan
    from geomesa_tpu_torch.kernels import hist, topk
    from geomesa_tpu_torch.process.geo import expand_bbox
    knn_mod = importlib.import_module("geomesa_tpu_torch.process.knn")
    planner = store.planner("gdelt")
    cols = planner.indexes[0].device.columns
    n = int(cols["xf"].shape[0])
    calls = []

    def bits(r):
        return r[0].view(torch.int32), r[1]
    for mkey, mlabel, f in (("a", "(a)'s mask", Q_BOX),
                            ("all", "the full table's mask", "INCLUDE")):
        _, mask = planner.scan_mask(f)
        live = int(mask.sum())
        for form, cs, kw, nbins, cb in (
                ("hist", (cols["val"],), {"lo": 0.0, "hi": 100.0,
                                          "bins": 20}, 20, 4),
                ("grid", (cols["xf"], cols["yf"]), {"bins": 32}, 1024, 8),
                ("bincount", (cols["name"],), {"bins": 3}, 3, 4)):
            # the masked bin indices torch.bincount counts
            if form == "hist":
                bi = stats_scan._bin_index(
                    (cs[0].float() - 0.0) / 100.0 * 20.0, 20)
            elif form == "grid":
                bi = (stats_scan._bin_index((cs[1] + 90.0) * stats_scan.INV180
                                            * 32.0, 32) * 32
                      + stats_scan._bin_index((cs[0] + 180.0)
                                              * stats_scan.INV360 * 32.0, 32))
            else:
                bi = cs[0].long()
            sel = bi[mask]
            del bi
            calls.append({
                "kernel": "masked_hist", "key": f"hist_{form}_{mkey}",
                "label": f"masked_hist {form} at {mlabel} ({live} of {n} "
                         f"rows set)",
                "call": lambda form=form, cs=cs, kw=kw, mask=mask:
                    hist.masked_hist(form, mask, *cs, **kw),
                "plain": lambda form=form, cs=cs, kw=kw, mask=mask:
                    stats_scan.masked_hist(form, mask, *cs, **kw),
                "bound": hist_bound(n, live, cb, nbins), "reps": 20,
                "library": lambda sel=sel, nbins=nbins: torch.bincount(
                    sel, minlength=nbins),
                "cut": None, "extra": {"form": form, "live": live}})
    # topk_nearest FULL over the table at m = 32 and 4096
    _, mask = planner.scan_mask("INCLUDE")
    q = torch.tensor(O_Q, dtype=torch.float32, device=cols["xf"].device)
    dmask = torch.where(mask, scan.haversine_f32(cols["xf"], cols["yf"], q),
                        torch.tensor(float("inf"), device=q.device))
    for m in (32, 4096):
        calls.append({
            "kernel": "topk_nearest", "key": f"topk_full_{m}",
            "label": f"topk_nearest FULL m={m} over {n} rows",
            "call": lambda m=m: topk.topk_nearest(cols["xf"], cols["yf"],
                                                  mask, *O_Q, m),
            "plain": lambda m=m: scan.topk_nearest(cols["xf"], cols["yf"],
                                                   mask, *O_Q, m),
            "bound": topk_bound(n, m, int(mask.sum())), "reps": 10,
            "library": lambda m=m: torch.topk(dmask, m, largest=False),
            "cut": bits, "extra": {"form": "full", "m": m}})
    # BLOCKS at cfg4's candidate blocks: the cover knn's memoised radius
    # gives at (2, 48), padded as knn pads it
    memo = knn_mod._memo_for(planner)
    # the radius cfg4's k=10 queries landed on; 100 km where they took
    # the full table (a smaller table)
    radius = memo["radii"].get(max(32 * 10, 2048), 100_000.0)
    geom = planner.sft.geometry_attribute.name
    plan_r = planner.plan(ir.BBox(geom, *expand_bbox(*O_Q, radius)))
    blocks = planner._pruned_blocks(plan_r)
    if blocks is None or len(blocks) == 0:
        raise AssertionError("(o) cfg4's cover declined at its memo radius")
    kern = planner.indexes[0].kernels
    tier = knn_mod._stable_tier_blocks({"tier": 0}, blocks)
    disp = kern._candidates([(plan_r.primary_kind, plan_r.boxes_loose,
                              plan_r.windows, plan_r.residual_device)],
                            tier, prune.BLOCK_SIZE)
    bmask, starts, _, bsz = disp()
    nc = int(bmask.shape[0])
    brows = scan.block_rows(starts, bsz)
    bq = torch.where(bmask, scan.haversine_f32(
        cols["xf"].index_select(0, brows), cols["yf"].index_select(0, brows),
        q), torch.tensor(float("inf"), device=q.device))
    calls.append({
        "kernel": "topk_nearest", "key": "topk_blocks_32",
        "label": f"topk_nearest BLOCKS m=32 over cfg4's {len(blocks)} cover "
                 f"blocks ({len(tier)} with the tier's pad, {nc} "
                 f"candidates, {int(bmask.sum())} set)",
        "call": lambda: topk.topk_nearest(cols["xf"], cols["yf"], bmask,
                                          *O_Q, 32, starts, bsz),
        "plain": lambda: scan.topk_nearest(cols["xf"], cols["yf"], bmask,
                                           *O_Q, 32, starts, bsz),
        "bound": topk_bound(nc, 32, int(bmask.sum()),
                            starts.numel() * starts.element_size()),
        "reps": 50, "library": lambda: torch.topk(bq, 32, largest=False),
        "cut": bits, "extra": {"form": "blocks", "m": 32,
                               "blocks": len(blocks), "radius_m": radius}})
    return calls


def topk_routes(store) -> list:
    """``topk_nearest``'s two routes at 2^19 to 2^22 candidates, m = 32:
    FULL over the first n rows of the table, and BLOCKS over n / 4,096
    blocks of 4,096 rows at random block starts in the table; every
    candidate set, one in a hundred and one in four hundred (cfg4's
    cover sets 2,627 of 1,048,576); each route forced through the
    wrapper's threshold of its form (``FULL_CLUSTER_MAX``,
    ``CLUSTER_MAX``), kernel ms by CUDA events and the results equal. The
    dense rows show the one cluster past its listing capacity (every pass
    computes the keys again), the sparse ones its reach."""
    import torch
    from geomesa_tpu_torch.kernels import topk
    cols = store.planner("gdelt").indexes[0].device.columns
    dev = cols["xf"].device
    gen = torch.Generator(device=dev).manual_seed(5)
    keep = topk.FULL_CLUSTER_MAX, topk.CLUSTER_MAX
    bsz = 4096
    nrows = cols["xf"].shape[0]
    out = []
    try:
        for form in ("full", "blocks"):
            for n in (1 << 19, 1 << 20, 1 << 21, 1 << 22):
                if form == "full":
                    x, y, kw = cols["xf"][:n], cols["yf"][:n], {}
                else:
                    x, y = cols["xf"], cols["yf"]
                    ids = torch.randperm(nrows // bsz, generator=gen,
                                         device=dev)[:n // bsz]
                    kw = {"starts": torch.sort(ids).values * bsz,
                          "bsz": bsz}
                for dense in (1.0, 0.01, 0.0025):
                    mask = (torch.ones(n, dtype=torch.bool, device=dev)
                            if dense == 1.0 else
                            torch.rand(n, generator=gen, device=dev) < dense)
                    row = {"form": form, "n": n, "set": dense}
                    got = {}
                    for route, cmax in (("cluster", n), ("grid", n - 1)):
                        topk.FULL_CLUSTER_MAX = topk.CLUSTER_MAX = cmax
                        call = lambda: topk.topk_nearest(x, y, mask, *O_Q,
                                                         32, **kw)
                        got[route] = call()
                        row[f"{route}_ms"] = cuda_ms(call, 20)
                    if not (torch.equal(got["cluster"][0].view(torch.int32),
                                        got["grid"][0].view(torch.int32))
                            and torch.equal(got["cluster"][1],
                                            got["grid"][1])):
                        raise AssertionError(f"topk_nearest's routes "
                                             f"differ at {row}")
                    out.append(row)
    finally:
        topk.FULL_CLUSTER_MAX, topk.CLUSTER_MAX = keep
    log(f"[kernel] topk_nearest routes (m = 32; the wrapper's "
        f"FULL_CLUSTER_MAX {keep[0]}, CLUSTER_MAX {keep[1]}): "
        f"{json.dumps(out)}")
    return out


def phase_process_kernels(store) -> dict:
    """``masked_hist`` (each form) and ``topk_nearest`` (FULL and BLOCKS)
    against their plain versions on the main path's tensors, with times,
    bounds, device activities and the library call's time; the top-m's
    two routes around their threshold."""
    rows = {"masked_hist": [], "topk_nearest": []}
    for c in process_kernel_calls(store):
        r = _time_kernel(c["label"], c["call"], c["plain"], c["bound"],
                         c["reps"], library=c["library"], cut=c["cut"])
        r.update(c["extra"])
        rows[c["kernel"]].append(r)
    topk_routes(store)
    for name in ("masked_hist", "topk_nearest"):
        log(f"[kernel] {name} registers and spills: "
            f"{json.dumps(kernel_resources(name))}")
    log(f"[kernel] topk_nearest keys pass SASS: "
        f"{json.dumps(sass_keys_pass())}")
    log(json.dumps({"process_kernels": rows}))
    return rows


def sass_keys_pass(so_path=None):
    """The FULL keys pass of a built ``topk_nearest`` (the function whose
    name holds ``keys_kernel`` and ``ILb0E``): its static SASS instructions
    and opcode counts, and the instructions over the 4 candidates its loop
    computes a pass (a static count: the transcendental functions' slow
    paths, never taken at these inputs, are in it). None when cuobjdump is
    missing or no such function is found."""
    from geomesa_tpu_torch.kernels import build, topk
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    so_path = so_path or build._target(topk.NAME)[1]
    if not os.path.exists(tool) or not os.path.exists(so_path):
        return None
    text = subprocess.run([tool, "-sass", so_path], capture_output=True,
                          text=True).stdout
    for fn in text.split("Function : ")[1:]:
        name = fn.split()[0]
        if "keys_kernel" in name and "ILb0E" in name:
            ops = {}
            for op in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", fn):
                o = re.sub(r"^@!?U?P\w+\s+", "", op.strip()).split()[0]
                ops[o] = ops.get(o, 0) + 1
            total = sum(ops.values())
            top = dict(sorted(ops.items(), key=lambda kv: -kv[1])[:12])
            return {"function": name, "instructions": total,
                    "per_candidate": total / 4, "top_opcodes": top}
    return None


# bench.py cfg3 (bench.py:685-770): the point-in-polygon join over the first
# 20M points of the cfg1 corpus against perf/polygons_complex.json's 32
# polygons, and the extent join of 200,000 seeded two-point lines against
# them; the pair kernel at the 13 polygons of at most MAX_SEGMENTS segments
# (the reference declines the others), the candidate pairs tiled to about
# 1M as bench.py tiles them
R_N = 20_000_000
R_LINES = 200_000
R_SEED = 3303
R_PAIRS = 1_000_000
R_REPS = 5
# f32 operations of the join a (point in a polygon's bbox, real edge) pair:
# the two y compares and their xor; a straddling edge adds 2 subtractions,
# the division, the fma (2) and the compare
PIPJ_OPS_PER_PAIR = 3
PIPJ_OPS_PER_CROSS = 6


def cfg3_polygons():
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "perf", "polygons_complex.json")) as fh:
        pc = json.load(fh)
    return [(int(code), rings) for code, rings in pc["polygons"]], \
        pc["vertex_counts"]


def cfg3_lines(n: int = R_LINES, seed: int = R_SEED) -> np.ndarray:
    """(2n, 2) vertices of bench.py cfg3's two-point lines (its
    distributions, bench.py:724-730; a generator of their own)."""
    rng = np.random.default_rng(seed)
    jx = rng.uniform(-60, 60, n)
    jy = rng.uniform(-60, 60, n)
    jc = np.empty((2 * n, 2))
    jc[0::2, 0], jc[0::2, 1] = jx, jy
    jc[1::2, 0] = jx + rng.uniform(-1, 1, n)
    jc[1::2, 1] = jy + rng.uniform(-1, 1, n)
    return jc


def pip_join_work(px, py, bufs, first) -> dict:
    """What one join call over these points must do, counted on their
    device, for each mode: the (point in a polygon's bbox, real edge)
    pairs and those whose edge straddles the point's y (COUNTS: every
    polygon whose bbox holds the point; ASSIGN: only the polygons up to
    the point's first hit ``first``, after which the kernel drops it), the
    (point, polygon) pairs in a bbox; the bytes read (the points, 8 a
    point; the real edges, 16 each); and the reference's dense count
    (every point against every polygon's padded edges)."""
    from geomesa_tpu_torch.arith import flush, sub
    edges, n_edges, bboxes, center = bufs
    c = flush(center)
    work = {m: {"inbbox_pairs": 0, "straddling_pairs": 0,
                "inbbox_points": 0} for m in ("counts", "assign")}
    for p in range(edges.shape[0]):
        bb = flush(bboxes[p])
        inb = ((px >= bb[0]) & (px <= bb[2]) & (py >= bb[1])
               & (py <= bb[3])).nonzero().squeeze(1)
        f = first[inb]
        keep = (f < 0) | (f >= p)
        ne = int(n_edges[p])
        e = flush(edges[p, :ne])
        for m, k in (("counts", int(inb.numel())), ("assign",
                                                    int(keep.sum()))):
            work[m]["inbbox_points"] += k
            work[m]["inbbox_pairs"] += k * ne
        step = max(1, (1 << 24) // max(1, ne))
        for a in range(0, int(inb.numel()), step):
            q = sub(flush(py[inb[a:a + step]]), c[1])[:, None]
            sc = ((e[None, :, 1] > q) != (e[None, :, 3] > q)).sum(1)
            work["counts"]["straddling_pairs"] += int(sc.sum())
            work["assign"]["straddling_pairs"] += int(
                sc[keep[a:a + step]].sum())
    work["in_bytes"] = 8 * px.numel() + 16 * int(n_edges.sum())
    work["dense_pairs"] = int(edges.shape[0]) * px.numel() \
        * int(edges.shape[1])
    return work


def pip_join_bound(work: dict, mode: str, out_bytes: int) -> dict:
    """The least time for one join call in ``mode`` ("counts" or
    "assign"): bytes — ``work``'s inputs read once, the output written
    once; operations — PIPJ_OPS_PER_PAIR a (point in the polygon's bbox,
    real edge) pair the mode must test and PIPJ_OPS_PER_CROSS more a pair
    whose edge straddles the point's y."""
    w = work[mode]
    r = _bound(work["in_bytes"] + out_bytes,
               PIPJ_OPS_PER_PAIR * w["inbbox_pairs"]
               + PIPJ_OPS_PER_CROSS * w["straddling_pairs"])
    r.update(w)
    r["dense_pairs"] = work["dense_pairs"]
    return r


def pair_band_bound(prep) -> dict:
    """The least time for one ``pair_band`` call: bytes — the pair vectors
    (8 a pair), the real segments of the two tables (16 each) and their
    counts and flags (6 a geometry) read once, the packed verdicts written
    once; operations — what this run's pairs need, found by the plain
    version's segment-pair band on the same inputs: a pair with a certain
    crossing SEG_OPS_PER_PAIR for each real segment pair up to its first
    crossing (in the kernel's order, left segment major) and nothing
    more; any other pair SEG_OPS_PER_PAIR for each of its real segment
    pairs and GEOM_BAND_OPS for each (left first vertex, right real edge)
    pair where the right side is polygonal, and the converse."""
    import torch
    from geomesa_tpu_torch.index.scan import _segpair_band
    lseg, lcnt, lpoly, _ = prep._d_l
    rseg, rcnt, rpoly, _ = prep._d_r
    n = prep.n
    ls_, rs_ = lseg.shape[1], rseg.shape[1]
    dev = lseg.device
    li = torch.arange(ls_, device=dev)[None, :, None]
    ri = torch.arange(rs_, device=dev)[None, None, :]
    step = max(1, (1 << 24) // (ls_ * rs_))
    segpairs = pips = crossed = 0
    for a in range(0, n, step):
        pl = prep._d_pl[a:min(n, a + step)].long()
        pr = prep._d_pr[a:min(n, a + step)].long()
        lc, rc = lcnt[pl].long(), rcnt[pr].long()
        sl = lseg[pl][:, :, None, :]
        sr = rseg[pr][:, None, :, :]
        hit, _ = _segpair_band(*sl.unbind(-1), *sr.unbind(-1))
        hit = (hit & (li < lc[:, None, None]) & (ri < rc[:, None, None])
               ).flatten(1)
        crossing = hit.any(dim=1)
        k = hit.to(torch.uint8).argmax(dim=1)   # the first crossing
        upto = (k // rs_) * rc + k % rs_ + 1
        segpairs += int(torch.where(crossing, upto, lc * rc).sum())
        pips += int(torch.where(crossing, 0, rc * rpoly[pr].long()
                                + lc * lpoly[pl].long()).sum())
        crossed += int(crossing.sum())
    nbytes = 8 * int(prep._d_pl.numel()) + 16 * int(lcnt.sum() + rcnt.sum()) \
        + 6 * (lcnt.numel() + rcnt.numel()) + 2 * ((prep._d_pl.numel() + 7) // 8)
    r = _bound(nbytes, SEG_OPS_PER_PAIR * segpairs + GEOM_BAND_OPS * pips)
    r.update(segment_pairs=segpairs, first_vertex_pairs=pips,
             crossing_pairs=crossed)
    return r


def phase_cfg3(x, y, device: str = "cuda", n: int = R_N,
               n_lines: int = R_LINES, n_pairs: int = R_PAIRS) -> dict:
    """bench.py cfg3 on the card, over the corpus's first ``n`` points
    ``x``/``y`` (before (l) changes it): (r1) the point-in-polygon join,
    (r2) the extent join at its shapes (the pair kernel declines there: the
    reference's MAX_SEGMENTS), (r3) the pair kernel at the polygons it
    accepts; every answer against its plain version or the host route,
    each kernel's launches read around the main path's run. Prints a
    ``{"cfg3": ...}`` line. ``device="cpu"`` rehearses the path with the
    plain versions (no kernel timings)."""
    import torch
    from geomesa_tpu_torch.features.geometry import GeometryArray
    from geomesa_tpu_torch.filter import geom_batch
    from geomesa_tpu_torch.kernels import pair_band, pip_join
    from geomesa_tpu_torch.parallel import join as pjoin
    from geomesa_tpu_torch.parallel import pair_kernel
    ej = importlib.import_module("geomesa_tpu_torch.parallel.extent_join")
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    polys, vc = cfg3_polygons()
    out = {"n_points": n, "n_polygons": len(polys),
           "poly_vertices_total": int(sum(vc)),
           "poly_vertices_max": int(max(vc))}

    # (r1) the point-in-polygon join
    px = torch.from_numpy(np.ascontiguousarray(x[:n], dtype=np.float32))
    py = torch.from_numpy(np.ascontiguousarray(y[:n], dtype=np.float32))
    dx, dy = px.to(device), py.to(device)
    join = pjoin.SpatialJoin(polys, device)
    join.counts(dx, dy)   # the polygon tables on the card, the build warm
    sync()
    pip_join.pip_join.launches = 0
    hits = join.counts(dx, dy)
    first = join.assign(dx, dy)
    sync()
    launches = {"pip_join": pip_join.pip_join.launches}
    if cuda and launches["pip_join"] < 2:
        raise AssertionError("(r1) the join did not run on pip_join")
    if int(hits.sum()) <= 0:
        raise AssertionError("(r1) no point in any polygon")
    n_first = int((first >= 0).sum())
    # every point in a polygon has a first polygon; a point counted twice
    # lies in two of them
    if not n_first <= int(hits.sum()):
        raise AssertionError("(r1) assign's hits exceed the counts'")
    p50, _ = timed(lambda: join.counts(dx, dy), sync, R_REPS)
    p50_a, _ = timed(lambda: join.assign(dx, dy), sync, R_REPS)
    out["r1"] = {"hits": int(hits.sum()), "assigned": n_first,
                 "counts_p50_ms": p50, "assign_p50_ms": p50_a,
                 "mpts_per_s_per_chip": n / (p50 / 1e3) / 1e6}
    log(f"[cfg3] (r1) {n} points x {len(polys)} polygons: {int(hits.sum())} "
        f"hits, {n_first} points assigned; counts p50 {p50} ms "
        f"({out['r1']['mpts_per_s_per_chip']} Mpts/s), assign p50 {p50_a} ms")
    bufs = join._bufs(dx.device)
    rows = []
    work = pip_join_work(dx, dy, bufs, first)
    for label in ("counts", "assign"):
        w = work[label]
        log(f"[cfg3] (r1) pip_join {label} work: {w['inbbox_pairs']} (point "
            f"in bbox, edge) pairs, {w['straddling_pairs']} straddling, "
            f"{w['inbbox_points']} (point, polygon) in bbox; the reference's "
            f"dense count {work['dense_pairs']} pairs")
    for label, assign in (("counts", False), ("assign", True)):
        bound = pip_join_bound(work, label, 4 * (n if assign else len(polys)))
        log(f"[cfg3] (r1) pip_join {label} bound {bound['bound_ms']} ms "
            f"({bound['bound_by']})")
        if not cuda:
            continue
        plain = pjoin.assign if assign else pjoin.contains_matrix
        rows.append(_time_kernel(
            f"pip_join {label} (r1): {n} points x {len(polys)} polygons",
            lambda a=assign: pip_join.pip_join(dx, dy, None, *bufs,
                                               assign=a),
            lambda f=plain: f(dx, dy, None, *bufs), bound, 10))
    del dx, dy, px, py, first, join, bufs

    # (r2) the extent join at cfg3's shapes
    lines = GeometryArray.linestrings(cfg3_lines(n_lines))
    polys_g = GeometryArray.from_shapes(polys)
    cli, crj = ej.candidate_pairs(lines.bboxes(), polys_g.bboxes())
    pair_band.pair_band.launches = 0
    t0 = time.perf_counter()
    la, ra = ej.extent_join(lines, polys_g, device="never",
                            torch_device=device)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    la_d, ra_d = ej.extent_join(lines, polys_g, device="always",
                                torch_device=device)
    dev_s = time.perf_counter() - t0
    if not (np.array_equal(la, la_d) and np.array_equal(ra, ra_d)):
        raise AssertionError("(r2) host and device pair lists differ")
    _, fid = geom_batch.build_segments(polys_g, np.arange(len(polys)))
    nseg = np.bincount(fid, minlength=len(polys))
    launches["pair_band_r2"] = pair_band.pair_band.launches
    if launches["pair_band_r2"] != 0:
        raise AssertionError("(r2) pair_band launched where the reference "
                             "declines")
    out["r2"] = {"lines": n_lines, "candidate_pairs": int(len(cli)),
                 "candidate_polygons": int(len(np.unique(crj))),
                 "pairs": int(len(la)), "host_s": host_s, "device_s": dev_s,
                 "polygons_over_512_segments":
                     int((nseg > pair_kernel.MAX_SEGMENTS).sum()),
                 "pair_band_launches": launches["pair_band_r2"]}
    log(f"[cfg3] (r2) {n_lines} lines x {len(polys)} polygons: "
        f"{len(cli)} candidate pairs over {out['r2']['candidate_polygons']} "
        f"polygons, {len(la)} pairs; host {host_s} s, device route "
        f"{dev_s} s (declined: {out['r2']['polygons_over_512_segments']} "
        f"polygons past {pair_kernel.MAX_SEGMENTS} segments; pair_band "
        f"launches 0)")

    # (r3) the pair kernel at the polygons it accepts
    keep = np.flatnonzero(nseg <= pair_kernel.MAX_SEGMENTS)
    small = GeometryArray.from_shapes([polys[i] for i in keep])
    sli, srj = ej.candidate_pairs(lines.bboxes(), small.bboxes())
    reps_t = max(1, n_pairs // max(1, len(sli)))
    tli, trj = np.tile(sli, reps_t), np.tile(srj, reps_t)
    pair_band.pair_band.launches = 0
    hit, unc = pair_kernel.device_refine(lines, small, tli, trj, device)
    prep = pair_kernel.prepare_refine(lines, small, tli, trj, device)
    h2, u2 = prep()
    la_s, ra_s = ej.extent_join(lines, small, device="never",
                                torch_device=device)
    la_sd, ra_sd = ej.extent_join(lines, small, device="always",
                                  torch_device=device)
    sync()
    launches["pair_band"] = pair_band.pair_band.launches
    if cuda and launches["pair_band"] < 3:
        raise AssertionError("(r3) the refine did not run on pair_band")
    if not (np.array_equal(hit, h2) and np.array_equal(unc, u2)):
        raise AssertionError("(r3) device_refine and the staged refine "
                             "differ")
    if not (np.array_equal(la_s, la_sd) and np.array_equal(ra_s, ra_sd)):
        raise AssertionError("(r3) host and device pair lists differ")
    p50_d, _ = timed(lambda: pair_kernel.device_refine(
        lines, small, tli, trj, device), sync, R_REPS)
    p50_p, _ = timed(prep, sync, R_REPS)
    out["r3"] = {"polygons": int(len(keep)), "candidate_pairs": int(len(sli)),
                 "tiled_pairs": int(len(tli)), "hits": int(hit.sum()),
                 "uncertain": int(unc.sum()), "pairs": int(len(la_s)),
                 "refine_p50_ms": p50_d, "staged_p50_ms": p50_p,
                 "mpairs_per_s_per_chip": len(tli) / (p50_d / 1e3) / 1e6,
                 "staged_mpairs_per_s_per_chip":
                     len(tli) / (p50_p / 1e3) / 1e6}
    log(f"[cfg3] (r3) {len(tli)} pairs ({len(sli)} candidates x {reps_t}) "
        f"of {n_lines} lines x {len(keep)} polygons: {int(hit.sum())} hits, "
        f"{int(unc.sum())} uncertain; device_refine p50 {p50_d} ms "
        f"({out['r3']['mpairs_per_s_per_chip']} Mpairs/s), staged p50 "
        f"{p50_p} ms; the join {len(la_s)} pairs on both routes")
    args = (*prep._d_l, *prep._d_r, prep._d_pl, prep._d_pr)
    bound = pair_band_bound(prep)
    log(f"[cfg3] (r3) pair_band work: {bound['segment_pairs']} real "
        f"segment pairs, {bound['first_vertex_pairs']} first-vertex "
        f"pairs ({bound['crossing_pairs']} pairs end at a crossing); bound "
        f"{bound['bound_ms']} ms ({bound['bound_by']})")
    if cuda:
        rows.append(_time_kernel(
            f"pair_band (r3): {len(tli)} pairs, S_l {args[0].shape[1]}, "
            f"S_r {args[4].shape[1]}",
            lambda: pair_band.pair_band(*args),
            lambda: pair_kernel.pair_plain(*args), bound, 10))
    out["launches"] = launches
    out["kernels"] = rows
    print(json.dumps({"cfg3": {k: v for k, v in out.items()
                               if k != "kernels"}}))
    return out


def queries(store):
    """The main path's queries as (label, zero-arg fn), for the timings and
    the profile."""
    return (("a_box_count", lambda: store.count("gdelt", Q_BOX)),
            ("b_poly_count", lambda: store.count("gdelt", Q_POLY)),
            ("c_poly_query", lambda: store.query("gdelt", Q_POLY)),
            ("d_density", lambda: store.query(
                "gdelt", Q_D, hints=density_hint(D_BBOX, 64, 64))),
            ("e_density_val", lambda: store.query(
                "gdelt", Q_BOX, hints=density_hint(E_BBOX, 256, 256, "val"))),
            ("f_staged_count", lambda: store.count("gdelt", Q_F)))


def _split(stages: dict, sync, reps: int) -> dict:
    out = {}
    for label, fn in stages.items():
        fn()
        ts = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        out[label] = float(np.median(ts))
    return out


def breakdown(store, sync) -> None:
    """Host-clock splits (p50 each): query (c) into parse + plan, the fused
    select (program runs, row mapping, host refine, sort) and the hydration
    of the selected rows (REPS each); query (a) into plan, the bare fused
    program (run + readback, without and with a device synchronise before
    the readback), ``compiled.try_count`` (plus its readback bookkeeping),
    and ``store.count`` with tracing on and off (5 * REPS each, two
    passes: the layers the port's count path stacks on the program)."""
    import torch
    from geomesa_tpu_torch import trace
    from geomesa_tpu_torch.index import compiled

    planner = store.planner("gdelt")
    plan = planner.plan(Q_POLY)
    rows = compiled.try_select_refine(planner, plan, None)
    log(json.dumps({"breakdown_c_ms": _split({
        "plan": lambda: planner.plan(Q_POLY),
        "fused_select": lambda: compiled.try_select_refine(planner, plan,
                                                           None),
        "hydrate": lambda: planner.table.take(rows)}, sync, REPS)}))

    plan_a = planner.plan(Q_BOX)

    def untraced():
        with trace.disabled():
            store.count("gdelt", Q_BOX)

    def synced():
        out = compiled.Program(plan_a, "count").run()
        torch.cuda.synchronize()
        return int(out[0])

    stages = {"plan": lambda: planner.plan(Q_BOX),
              "program_run": lambda: int(
                  compiled.Program(plan_a, "count").run()[0]),
              "program_run_synced": synced,
              "try_count": lambda: compiled.try_count(planner, plan_a),
              "store_count": lambda: store.count("gdelt", Q_BOX),
              "store_count_untraced": untraced}
    for rnd in (1, 2):   # two passes: the spread between them is the noise
        log(json.dumps({"breakdown_a_ms": _split(stages, sync, 5 * REPS),
                        "pass": rnd}))


def phase_profile(store, extra=()) -> None:
    """One run of each query under torch.profiler: wall time, the summed
    time of its device activities (kernels and copies), the device's idle
    share over the run, the activities that take the most time, and the
    column gathers (``index_select``) it made, of which those of float
    columns: the layer's only float device columns are the coordinates
    xf/yf, which the refine reads through the block starts instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from geomesa_tpu_torch.index import scan

    runs = (*queries(store), *extra)
    # host syncs inside each query, by CUDA's sync debug mode, in runs of
    # their own before any profile (the check slows the host); a pinned
    # readback's event wait is not one
    syncs = {}
    for label, fn in runs:
        fn()
        torch.cuda.synchronize()
        with scan.host_syncs("cuda") as hs:
            fn()
        torch.cuda.synchronize()
        syncs[label] = hs.count
    for label, fn in runs:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        top = {}
        for e in kernels:
            top[e.name] = top.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        top5 = sorted(top.items(), key=lambda kv: -kv[1])[:5]
        gathers = [e for e in prof.events() if e.name == "aten::index_select"]
        float_gathers = sum(
            1 for e in gathers
            if (getattr(e, "input_dtypes", None) or [""])[0] == "float")
        log(json.dumps({"profile": {
            "query": label, "wall_ms_profiled": wall_ms,
            "device_busy_ms": busy_ms, "device_activities": len(kernels),
            "idle_share": 1.0 - busy_ms / wall_ms,
            "host_syncs_inside": syncs[label],
            "index_select": len(gathers),
            "index_select_float": float_gathers,
            "top": [[k[:60], v] for k, v in top5]}}))


def timed_phase(label: str, fn, *args):
    """``fn(*args)``, its wall seconds logged as a ``[phase]`` line."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[phase] {label}: {time.perf_counter() - t0} s")
    return out


def main() -> int:
    t_start = time.perf_counter()
    smi, name = phase_device()
    log(f"[device] nvidia-smi: {smi}")
    timed_phase("build", phase_build)
    timed_phase("kernels", phase_kernels)
    launches, store, routes, g_oracle, f_oracle = timed_phase(
        "main path", phase_main_path)
    g = timed_phase("(g) serving", phase_serving, store, g_oracle)
    f = timed_phase("(h)-(k) filters", phase_filters, store, f_oracle)
    k = timed_phase("pip_refine at the main path", phase_kernel_main_inputs,
                    store)
    d = timed_phase("grid_scatter", phase_density_kernel, store)
    b = timed_phase("box_count", phase_box_count_kernel, store, g)
    t = timed_phase("dist_refine", phase_dist_kernel, store)
    fk = timed_phase("fused kernels", phase_fused_kernels, store)
    timed_phase("staged kernels", phase_staged_kernels, store)
    timed_phase("profile", phase_profile, store, (
        ("g1_prepared_count", g["pq"].count),
        ("g3_batch64_dispatch", g["disp"]), *filter_queries(store)))
    nres = timed_phase("(n) auths", phase_auths, store, g_oracle, f_oracle)
    nl = nres["launches"]
    m = timed_phase("(m) extent", phase_extent,
                    store.planner("gdelt").table)
    m1_state = m.pop("m1_state")
    m3_state = m.pop("m3_state")
    mk = timed_phase("(m) extent kernels", phase_extent_kernels, m1_state)
    qres = timed_phase("(q) catalog", phase_catalog, m1_state, m3_state)
    qk = timed_phase("(q) catalog kernels", phase_catalog_kernels, qres)
    qlaunch = qres["launches"]
    del m3_state, qres
    timed_phase("(m5) S2/S3", phase_extent_s2, store.planner("gdelt").table)
    timed_phase("(m6) merge", phase_extent_merge, m1_state)
    del m1_state
    o = timed_phase("(o) process", phase_process, store, g_oracle)
    ok = timed_phase("(o) kernels", phase_process_kernels, store)
    pres = timed_phase("(p) attribute", phase_attribute, store)
    timed_phase("(p7) wide residual", phase_sliced_wide)
    r = timed_phase("(r) cfg3", phase_cfg3,
                    *store.tables["gdelt"].geometry().point_xy())
    w = timed_phase("(l) write", phase_write, store, g_oracle)
    import torch
    from geomesa_tpu_torch.kernels import (box_count, compact, density,
                                           dist, fused_scan, gate, geom,
                                           hist, merge, pair_band, pip,
                                           pip_join, seg_band, topk)
    head = d[0]   # (d)'s own inputs, 64x64, unit weights
    bhead = b[0]  # (g3)'s batch over the union of its covers
    thead = t[0]  # (i)'s own inputs
    print(json.dumps({"kernels": [{
        "name": pip.NAME, "route": "cuda", "source": pip.SOURCE,
        "replaces": pip.REPLACES,
        "launches": launches["pip_refine"] + f["pip_refine"]
        + nl["pip_refine"],
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None}, {
        "name": density.NAME, "route": "cuda", "source": density.SOURCE,
        "replaces": density.REPLACES,
        "launches": launches["grid_scatter"] + f["grid_scatter"]
        + nl["grid_scatter"],
        "max_abs_err": max(r["max_abs_err"] for r in d), "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"]}, {
        "name": box_count.NAME, "route": "cuda", "source": box_count.SOURCE,
        "replaces": box_count.REPLACES,
        "launches": launches["box_count"] + g["r"]["box_count_launches"]
        + f["box_count"] + nl["box_count"] + m["launches"]["box_count"],
        "max_abs_err": max(r["max_abs_err"] for r in b + mk["box_count"]),
        "ms": bhead["ms"],
        "plain_ms": bhead["plain_ms"], "bound_ms": bhead["bound_ms"],
        "bound_by": bhead["bound_by"], "library_ms": None}, {
        "name": dist.NAME, "route": "cuda", "source": dist.SOURCE,
        "replaces": dist.REPLACES, "launches": f["dist_refine"],
        "max_abs_err": max(r["max_abs_err"] for r in t), "ms": thead["ms"],
        "plain_ms": thead["plain_ms"], "bound_ms": thead["bound_ms"],
        "bound_by": thead["bound_by"], "library_ms": None}, {
        "name": merge.NAME, "route": "cuda", "source": merge.SOURCE,
        "replaces": merge.REPLACES,
        "launches": w["launches_checked_run"]["merge_scatter"],
        "max_abs_err": w["kernel"]["max_abs_err"], "ms": w["kernel"]["ms"],
        "plain_ms": w["kernel"]["plain_ms"],
        "bound_ms": w["kernel"]["bound_ms"],
        "bound_by": w["kernel"]["bound_by"], "library_ms": None}, {
        "name": seg_band.NAME, "route": "cuda", "source": seg_band.SOURCE,
        "replaces": seg_band.REPLACES, "launches": m["launches"]["seg_band"],
        "max_abs_err": max(r["max_abs_err"] for r in mk["seg_band"]),
        "ms": mk["seg_band"][0]["ms"],
        "plain_ms": mk["seg_band"][0]["plain_ms"],
        "bound_ms": mk["seg_band"][0]["bound_ms"],
        "bound_by": mk["seg_band"][0]["bound_by"], "library_ms": None}] + [{
        "name": mod.NAME, "route": "cuda", "source": mod.SOURCE,
        "replaces": mod.REPLACES,
        "launches": launches[mod.NAME] + f[mod.NAME] + nl[mod.NAME],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
        "bound_ms": rows[0]["bound_ms"], "bound_by": rows[0]["bound_by"],
        "library_ms": rows[0]["library_ms"]}
        for mod, rows in ((gate, fk["block_gate"]),
                          (fused_scan, fk["fused_scan"]),
                          (compact, fk["ordered_compact"]))] + [{
        # fused_scan's VIS form (a query under authorizations): its
        # launches are (n)'s, also counted in fused_scan's above
        "name": f"{fused_scan.NAME}_vis", "route": "cuda",
        "source": fused_scan.SOURCE, "replaces": fused_scan.REPLACES_VIS,
        "launches": nres["vis_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in nres["vis_rows"]),
        "ms": nres["vis_rows"][0]["ms"],
        "plain_ms": nres["vis_rows"][0]["plain_ms"],
        "bound_ms": nres["vis_rows"][0]["bound_ms"],
        "bound_by": nres["vis_rows"][0]["bound_by"], "library_ms": None}] + [{
        # (o)'s kernels: launches from the phase's run, the rest from the
        # first row (FULL / (a)'s mask) of each kernel's comparisons
        "name": mod.NAME, "route": "cuda", "source": mod.SOURCE,
        "replaces": mod.REPLACES, "launches": o["launches"][mod.NAME],
        "max_abs_err": max(r["max_abs_err"] for r in ok[mod.NAME]),
        "ms": ok[mod.NAME][0]["ms"], "plain_ms": ok[mod.NAME][0]["plain_ms"],
        "bound_ms": ok[mod.NAME][0]["bound_ms"],
        "bound_by": ok[mod.NAME][0]["bound_by"],
        "library_ms": ok[mod.NAME][0]["library_ms"]}
        for mod in (hist, topk)] + [{
        # fused_scan's RUNS form (the attribute index's staged count_at and
        # select_at): its launches are (p)'s; the first row is (p1)'s count
        "name": f"{fused_scan.NAME}_runs", "route": "cuda",
        "source": fused_scan.SOURCE, "replaces": fused_scan.REPLACES_RUNS,
        "launches": pres["runs_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in pres["runs_rows"]),
        "ms": pres["runs_rows"][0]["ms"],
        "plain_ms": pres["runs_rows"][0]["plain_ms"],
        "bound_ms": pres["runs_rows"][0]["bound_ms"],
        "bound_by": pres["runs_rows"][0]["bound_by"], "library_ms": None}] + [{
        # fused_scan's ENV form (the envelope primary of extent layers): its
        # launches are (m)'s; the first row is (m1)'s BBOX cover's count.
        # No single PyTorch call computes it: library n/a
        "name": f"{fused_scan.NAME}_env", "route": "cuda",
        "source": fused_scan.SOURCE, "replaces": fused_scan.REPLACES_ENV,
        "launches": m["launches"]["fused_scan_env"],
        "max_abs_err": max(r["max_abs_err"] for r in mk["fused_scan_env"]),
        "ms": mk["fused_scan_env"][0]["ms"],
        "plain_ms": mk["fused_scan_env"][0]["plain_ms"],
        "bound_ms": mk["fused_scan_env"][0]["bound_ms"],
        "bound_by": mk["fused_scan_env"][0]["bound_by"],
        "library_ms": None}] + [{
        # the geometry catalog's kernels: launches from (q)'s run, the
        # rest from the first row of each kernel's comparisons ((q1)'s
        # lines, (q3)'s intersects rows, (q4)'s candidates)
        "name": name, "route": "cuda", "source": geom.SOURCES[name],
        "replaces": geom.REPLACES[name], "launches": qlaunch[name],
        "max_abs_err": max(r["max_abs_err"] for r in qk[name]),
        "ms": qk[name][0]["ms"], "plain_ms": qk[name][0]["plain_ms"],
        "bound_ms": qk[name][0]["bound_ms"],
        "bound_by": qk[name][0]["bound_by"], "library_ms": None}
        for name in geom.NAMES] + [{
        # (r)'s kernels: launches from the phase's run, the rest from the
        # first row of each kernel's comparisons ((r1)'s counts, (r3)'s
        # pairs); no single PyTorch call computes either
        "name": mod.NAME, "route": "cuda", "source": mod.SOURCE,
        "replaces": mod.REPLACES, "launches": r["launches"][mod.NAME],
        "max_abs_err": max(x["max_abs_err"] for x in rows),
        "ms": rows[0]["ms"], "plain_ms": rows[0]["plain_ms"],
        "bound_ms": rows[0]["bound_ms"], "bound_by": rows[0]["bound_by"],
        "library_ms": None}
        for mod, rows in ((pip_join, r["kernels"][:2]),
                          (pair_band, r["kernels"][2:]))]}))
    log(f"[done] every phase passed in {time.perf_counter() - t_start} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
