"""Chip smoke test of the PyTorch/CUDA port (geomesa_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit) when it fails:

1. device: the card's name and power limit;
2. build: every CUDA kernel of the main path from the checkout's sources,
   with ptxas' report and the SASS instructions per (point, edge) pair of
   the refine kernel's inner loop;
3. kernels against their plain PyTorch versions on the card, at the shapes
   the main path gives them (and near-edge shapes, unmasked and masked),
   with times and bounds;
4. the main path: a 100M-point Z3 layer loaded through the port's
   DataStore and queried (count, polygon count, polygon select), each
   result equal to a numpy f64 oracle computed here, with the kernel's
   launch count read around the run;
5. the result lines: one JSON object per kernel, the card, and the final
   ``{"ok": true, ...}`` line.

Imports nothing of JAX and nothing of the JAX package. Exits non-zero
without a result when no CUDA card is present.
"""

from __future__ import annotations

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

CONCAVE_WKT = "POLYGON((-10 20, 40 20, 40 60, -10 60, 15 40, -10 20))"
CONCAVE = [(-10.0, 20.0), (40.0, 20.0), (40.0, 60.0), (-10.0, 60.0),
           (15.0, 40.0), (-10.0, 20.0)]
KERNEL_N = 8192 * 4096   # cap blocks x block rows: the pruned branch's most

# the main path: the bench.py cfg1 corpus at its full size, the entry()
# schema, and three queries of the flagship shape
N = 100_000_000
SPEC = "name:String,val:Int,dtg:Date,*geom:Point;geomesa.z3.interval=week"
DURING = "dtg DURING 2020-01-05T00:00:00Z/2020-01-12T00:00:00Z"
Q_BOX = f"BBOX(geom, -10, 30, 30, 55) AND {DURING} AND val > 10"
Q_POLY = f"INTERSECTS(geom, {CONCAVE_WKT}) AND {DURING}"
REPS = 10


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
    from geomesa_tpu_torch.kernels import build, pip
    t0 = time.perf_counter()
    out = build.build([pip.NAME])
    secs = time.perf_counter() - t0
    for name, r in out.items():
        log(f"[build] {name}: {r['seconds']:.2f} s")
        for line in r["log"].splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] total {secs:.2f} s")
    sass = sass_per_pair(build._target(pip.NAME)[1])
    log(f"[build] {pip.NAME} SASS inner loop: {json.dumps(sass)}")
    return secs


def sass_per_pair(so_path: str):
    """SASS instructions per (point, edge) pair in a point-in-polygon
    kernel's inner loop, read with ``cuobjdump -sass``: among the innermost
    loops (a backward branch and the instructions from its target to it),
    the one covering the most pairs per pass, where a pair has exactly 4
    FMUL (t1, t2 and the two tolerance products); with the loop's opcode
    counts. None when the toolkit's cuobjdump is missing or no loop
    qualifies."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", so_path], capture_output=True,
                          text=True, check=True).stdout
    best = None
    for fn in text.split("Function : ")[1:]:
        ins = [(int(a, 16), op.strip()) for a, op in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
        loops = []
        for at, op in ins:
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", op)
            if m and int(m.group(1), 16) < at:
                loops.append((int(m.group(1), 16), at))
        inner = [lp for lp in loops if not any(
            o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
        for lo, hi in inner:
            body = [op for at, op in ins if lo <= at <= hi]
            fmul = sum(1 for op in body
                       if re.match(r"(@!?U?P\w+\s+)?FMUL\b", op))
            if fmul >= 4 and (best is None or fmul > best["fmul"]):
                ops = {}
                for op in body:
                    name = re.sub(r"^@!?U?P\w+\s+", "", op).split()[0]
                    ops[name] = ops.get(name, 0) + 1
                best = {"instructions": len(body), "fmul": fmul,
                        "pairs": fmul / 4, "per_pair": len(body) / (fmul / 4),
                        "opcodes": ops}
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


def phase_kernel_main_inputs(store) -> dict:
    """pip_refine against its plain version on the very tensors the main
    path's polygon query hands it: the table's xf/yf columns, the mask and
    block starts of query (b)'s candidates, and its edge table."""
    from geomesa_tpu_torch.index import compiled

    plan = store.planner("gdelt").plan(Q_POLY)
    edges = compiled.refine_edges(plan)
    prog = compiled.Program(plan, "count_refine", unc_cap=4096, edges=edges)
    m, _, starts = prog._candidates()
    cols = prog.index.device.columns
    r = compare_refine("main-path (b)", cols["xf"], cols["yf"], prog.edges,
                       prog.n_edges, reps=50, mask=m, starts=starts,
                       bsz=prog.bsz)
    log(f"[kernel] main-path (b): the mask keeps {r['live']} of {r['n']} "
        f"candidates ({r['live'] / max(1, r['n'])})")
    return r


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


def phase_main_path(n: int = N, device: str = "cuda"):
    """Load the corpus through the port's DataStore (Z3 build on the card)
    and answer the three queries; each must equal the numpy f64 oracle.
    Returns the pip_refine launches of the checked run."""
    import torch
    from geomesa_tpu_torch import DataStoreFinder
    from geomesa_tpu_torch.features.table import FeatureTable, StringColumn
    from geomesa_tpu_torch.index import compiled
    from geomesa_tpu_torch.kernels import pip

    t0 = time.perf_counter()
    x, y, dtg, name, val = corpus(n)
    gen_s = time.perf_counter() - t0
    log(f"[main] corpus n={n} generated in {gen_s:.2f} s")

    lo = np.datetime64("2020-01-05", "ms").astype(np.int64)
    hi = np.datetime64("2020-01-12", "ms").astype(np.int64)
    t0 = time.perf_counter()
    tmask = (dtg > lo) & (dtg < hi)
    want_box = int(np.count_nonzero(
        tmask & (x >= -10) & (x <= 30) & (y >= 30) & (y <= 55) & (val > 10)))
    cand = np.flatnonzero(tmask & (x >= -10) & (x <= 40) & (y >= 20) & (y <= 60))
    want_rows = cand[oracle_pip(x[cand], y[cand], CONCAVE)]
    del tmask, cand
    log(f"[main] numpy f64 oracle in {time.perf_counter() - t0:.2f} s: "
        f"box {want_box}, polygon {len(want_rows)}")

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
    idx = store.planner("gdelt").indexes[0]
    placed = {k: str(v.device) for k, v in idx.device.columns.items()}
    if not all(d.startswith(device) for d in placed.values()):
        raise AssertionError(f"device columns off the card: {placed}")
    log(f"[main] load (host encode + Z3 sort/gather on the card) "
        f"{load_s:.2f} s; columns {sorted(placed)} on {set(placed.values())}")

    # the checked run: launch counts read around it
    pip.pip_refine.launches = 0
    got_box = store.count("gdelt", Q_BOX)
    l_a = pip.pip_refine.launches
    got_poly = store.count("gdelt", Q_POLY)
    l_b = pip.pip_refine.launches - l_a
    got_rows = store.query("gdelt", Q_POLY).indices
    sync()
    launches = pip.pip_refine.launches
    l_c = launches - l_a - l_b
    if got_box != want_box:
        raise AssertionError(f"(a) count {got_box} != oracle {want_box}")
    if got_poly != len(want_rows):
        raise AssertionError(f"(b) count {got_poly} != oracle {len(want_rows)}")
    if not np.array_equal(got_rows, want_rows):
        raise AssertionError(f"(c) rows differ from the oracle "
                             f"({len(got_rows)} vs {len(want_rows)})")
    if device == "cuda" and (l_a != 0 or l_b < 1 or l_c < 1):
        raise AssertionError(f"pip_refine launches (a) {l_a} (b) {l_b} (c) "
                             f"{l_c}: (b) and (c) must launch it, (a) not")
    log(f"[main] (a) {got_box} (b) {got_poly} (c) {len(got_rows)} rows: "
        f"equal to the oracle; pip_refine launches (a) {l_a} (b) {l_b} "
        f"(c) {l_c}")

    plan = store.planner("gdelt").plan(Q_POLY)
    prog = compiled.Program(plan, "count")
    alive = int(prog._alive().sum())
    log(f"[main] polygon query: {alive} of {-(-n // prog.bsz)} blocks alive "
        f"(cap {prog.cap}); pip_refine candidates per launch "
        f"{alive * prog.bsz if alive <= prog.cap else n}")

    p50 = {}
    for label, fn in (("a_box_count", lambda: store.count("gdelt", Q_BOX)),
                      ("b_poly_count", lambda: store.count("gdelt", Q_POLY)),
                      ("c_poly_query", lambda: store.query("gdelt", Q_POLY))):
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
        "launches_checked_run": launches}}))
    breakdown(store, sync)
    return launches, store


def breakdown(store, sync) -> None:
    """Host-clock split of query (c) into its stages (p50 of REPS each):
    parse + plan, the fused select (program runs, row mapping, host refine,
    sort), and the hydration of the selected rows."""
    from geomesa_tpu_torch.index import compiled

    planner = store.planner("gdelt")
    plan = planner.plan(Q_POLY)
    rows = compiled.select(planner, plan)
    stages = {"plan": lambda: planner.plan(Q_POLY),
              "fused_select": lambda: compiled.select(planner, plan),
              "hydrate": lambda: planner.table.take(rows)}
    out = {}
    for label, fn in stages.items():
        ts = []
        for _ in range(REPS):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
        out[label] = float(np.median(ts))
    log(json.dumps({"breakdown_c_ms": out}))


def phase_profile(store) -> None:
    """One run of each query under torch.profiler: wall time, the summed
    time of its device activities (kernels and copies), the device's idle
    share over the run, the activities that take the most time, and the
    column gathers (``index_select``) it made, of which those of float
    columns: the layer's only float device columns are the coordinates
    xf/yf, which the refine reads through the block starts instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for label, fn in (("a_box_count", lambda: store.count("gdelt", Q_BOX)),
                      ("b_poly_count", lambda: store.count("gdelt", Q_POLY)),
                      ("c_poly_query", lambda: store.query("gdelt", Q_POLY))):
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
            "index_select": len(gathers),
            "index_select_float": float_gathers,
            "top": [[k[:60], v] for k, v in top5]}}))


def main() -> int:
    smi, name = phase_device()
    log(f"[device] nvidia-smi: {smi}")
    phase_build()
    phase_kernels()
    launches, store = phase_main_path()
    k = phase_kernel_main_inputs(store)
    phase_profile(store)
    import torch
    from geomesa_tpu_torch.kernels import pip
    print(json.dumps({"kernels": [{
        "name": pip.NAME, "route": "cuda", "source": pip.SOURCE,
        "replaces": pip.REPLACES, "launches": launches,
        "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
