"""Two trees of the port timed on one card, in turns.

    python3 chip_compare.py PARENT_ROOT CHANGE_ROOT
        [--phases count,kernels,fused,fusedk,staged,rows,process,knn,m3,
                  pack,catalog]
        [--rounds 4] [--reps 40] [--n 100000000] [--out FILE] [--device cpu]

One worker process a tree imports ``geomesa_tpu_torch`` from that tree,
builds its kernels and sets up each phase once; the main process then asks
the two in turns — parent, change, change, parent, ... — so that each
adjacent pair of answers ran on the same card, seconds apart. The phases:

- ``count``: query (a) of ``chip_smoke.py`` on its 100M-point bench cfg1
  corpus (``--n``), loaded through the tree's store and checked against
  the numpy oracle. An answer is the p50 of ``--reps`` timed
  ``store.count`` calls and of as many runs of the fused program alone
  (``compiled.Program(plan, "count").run()``, which the trees share: a
  control for the card's and the host's drift).
- ``kernels``: ``seg_band`` at bench cfg2's (m1) shape (32 blocks of
  4,096 candidates, a 4-edge polygon, its box) and at 33,554,432
  segments within a few ulps of the polygon's edges; ``dist_refine`` at
  query (i)'s shape (268 blocks of 4,096 candidates through block starts
  into 8,388,608 points, 9.26% of them masked in) and at 33,554,432
  points within a few ulps of r ± DIST_BAND, unmasked. For each, the
  wrapper's call (``flags`` for ``dist_refine``) and the call with the
  two counts the fused program takes (``with_counts``: a tree whose
  wrapper gives no counts sums the flags after it). An answer is
  ``chip_smoke.cuda_ms`` over back-to-back calls and
  ``chip_smoke.activities_per_call`` (device activities and device ms a
  call over ten calls). The inputs are made once from fixed seeds and
  saved under ``archive_check/compare_inputs/`` (``.gitignore`` lists
  it); both trees must give the same outputs (compared by digest).
- ``fused``: the fused programs of ``chip_smoke.py``'s main path on the
  same store as ``count`` (loaded once a worker): (a) as a count, (b) as
  ``count_refine``, (c) as ``select_refine``, (d) as a 64x64 density and
  (h) as the union program's select, each built once
  (``compiled.Program`` / ``UnionProgram``, the API both trees share). An
  answer is the p50 of ``--reps`` runs to a device synchronise and, on
  the card, the device activities and device ms a run; both trees must
  give the same raw results (compared by digest).
- ``fusedk``: ``fused_scan`` and ``ordered_compact`` bare on the same
  store's tensors (``chip_smoke.fused_kernel_calls``: PERF.md §6's five
  shapes, the compaction of (c)'s hits at cap 4,096, (b)'s two
  compactions, 33,554,432 candidates at 1%, 10% and 50% set), and
  ``block_gate`` at its three shapes (``chip_smoke.gate_calls``: every
  block with (a)'s gate and with (h)'s union gate, 244,141 synthetic
  blocks with (a)'s gate), each checked against its plain version. An
  answer is ``chip_smoke.cuda_ms`` over back-to-back calls, the host's
  ms a call (``chip_smoke.host_ms``: the same calls without a sync), the
  median of single calls between two syncs (``sync_ms``) and the device
  activities and device ms a call; both trees must give the same outputs
  (compared by digest).
- ``staged``: the staged counts of ``chip_smoke.py``'s main path through
  ``store.count`` on the same store as ``count``: (f) (a window and
  ``val > 90``, no box, over every block) and (h) (the OR of two boxes).
  An answer is the p50 of ``--reps`` calls to a device synchronise and,
  on the card, the device activities and device ms a call; both trees
  must give the same counts.
- ``rows``: the rows path through ``store.count`` and ``store.query`` on
  the same store as ``count``: (b)'s and (i)'s counts and (c)'s, (h)'s,
  (i)'s and (j)'s rows. An answer is the p50 of ``--reps`` calls to a
  device synchronise and, on the card, the device activities and device
  ms a call; both trees must give the same answers (compared by digest).
- ``process``: ``masked_hist`` and ``topk_nearest`` bare on the same
  store's tensors (``chip_smoke.process_kernel_calls``: HIST, GRID and
  BINCOUNT at (a)'s mask and over every row; the top-m FULL at m = 32 and
  4,096 over the table and BLOCKS at m = 32 on cfg4's cover, whose radius
  one cfg4 query memoises first). An answer is ``chip_smoke.cuda_ms`` over
  back-to-back calls, the median of lone calls between two syncs and, on
  the card, the device activities and device ms a call; both trees must
  give the same outputs, distances bit for bit (compared by digest).
- ``knn``: knn end to end on the same store as ``count``: cfg4's k = 10
  at its six query points, k = 2,048 at cfg4's point and (o)'s stats
  hint over (a). An answer is the p50 of ``--reps`` calls to a device
  synchronise (10 for the stats hint); both trees must give the same
  rows and distances (compared by digest).
- ``pack``: the geometry catalog's ``pack_features`` onto the card at
  (m1)'s 5,000,000 lines and (m3)'s 500,000 quadrilaterals, every row in
  a seeded random order. An answer is the p50 of up to 8 calls to a device
  synchronise (and, where the tree's pack has a host and a device half,
  of each half); both trees must give the same packs (compared by digest).
- ``catalog``: the geometry catalog's ``geom_dist`` and ``geom_pred``
  bare on ``chip_smoke.catalog_pair_calls``' packs — (q3)'s rows (from the
  counts of an XZ2 store of (m3)'s 500,000 quadrilaterals), (q4)'s
  candidates, all 500,000 quads against POINT(1 39), M_WKT (ops 0, 1, 2)
  and a 700-edge ring, all 5,000,000 of (m1)'s lines against M_WKT —
  each checked against its plain version. An answer is
  ``chip_smoke.cuda_ms`` over back-to-back calls, the host's ms a call
  (``chip_smoke.host_ms``), the median of lone calls between two syncs
  and, on the card, the device activities and device ms a call; both
  trees must give the same outputs (compared by digest).
- ``m3``: ``chip_smoke.py``'s (m3), 500,000 quadrilaterals in an XZ2
  layer of their own: its polygon's prepared count, ``store.count`` and
  prepared rows, each the p50 of ``--reps`` calls to a device
  synchronise; both trees must give the same count.

Prints each answer, then per tree the median of every metric and the
change-minus-parent median over adjacent pairs; writes all of it to
``--out``. ``--device cpu`` is a dry run of the protocol at a small size
(times then come from the host clock). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, "archive_check", "compare_inputs")
BSZ = 4096
M1_BLOCKS = 32
M1_TABLE = 4 * M1_BLOCKS * BSZ
NEAR_N = 33_554_432
I_TABLE = 8_388_608
I_BLOCKS = 268
I_LIVE = 0.0926
CIRCLE = (10.0, 45.0, 5.0)
RING = [(-12.0, 30.0), (10.0, 28.0), (14.0, 44.0), (-2.0, 50.0),
        (-12.0, 30.0)]
BOX = (-12.0, 28.0, 14.0, 50.0)


def _smoke():
    """This tree's ``chip_smoke.py`` (its inputs and timing helpers), loaded
    by path so that a worker's own tree stays first on ``sys.path``."""
    spec = importlib.util.spec_from_file_location(
        "_compare_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _median(v):
    return float(np.median(v))


# -- phase count ------------------------------------------------------------


_STORE = {}


def _store(cs, a):
    """(store, (a)'s oracle count): the corpus loaded through this tree's
    store, once a worker."""
    if "store" in _STORE:
        return _STORE["store"]
    from geomesa_tpu_torch import DataStoreFinder
    from geomesa_tpu_torch.features.table import FeatureTable, StringColumn

    x, y, dtg, name, val = cs.corpus(a.n)
    lo = np.datetime64("2020-01-05", "ms").astype(np.int64)
    hi = np.datetime64("2020-01-12", "ms").astype(np.int64)
    want = int(np.count_nonzero((dtg > lo) & (dtg < hi) & (x >= -10)
                                & (x <= 30) & (y >= 30) & (y <= 55)
                                & (val > 10)))
    store = DataStoreFinder.get_data_store(type="torch", device=a.device)
    sft = store.create_schema("gdelt", cs.SPEC)
    store.load("gdelt", FeatureTable.build(sft, {
        "name": StringColumn(name, ["a", "b", "c"]), "val": val, "dtg": dtg,
        "geom": (x, y)}))
    del x, y, dtg, name, val
    _STORE["store"] = (store, want)
    return store, want


def setup_count(cs, a) -> tuple:
    import torch

    from geomesa_tpu_torch.index import compiled

    store, want = _store(cs, a)
    plan = store.planner("gdelt").plan(cs.Q_BOX)
    got = store.count("gdelt", cs.Q_BOX)
    prog = int(compiled.Program(plan, "count").run()[0])
    if got != want or prog != want:
        raise AssertionError(f"(a) {got}, program {prog}, oracle {want}")
    sync = torch.cuda.synchronize if a.device == "cuda" else (lambda: None)
    stages = {"count": lambda: store.count("gdelt", cs.Q_BOX),
              "program": lambda: int(
                  compiled.Program(plan, "count").run()[0])}
    for fn in stages.values():
        for _ in range(20):
            fn()

    def answer() -> dict:
        out = {}
        for label, fn in stages.items():
            ts = []
            for _ in range(a.reps):
                sync()
                t0 = time.perf_counter()
                fn()
                sync()
                ts.append((time.perf_counter() - t0) * 1e3)
            out[f"{label}_p50_ms"] = _median(ts)
        return out

    return {"count": got}, answer


# -- phase kernels ----------------------------------------------------------


def _near_n(device: str) -> int:
    return NEAR_N if device == "cuda" else 1 << 16


def make_inputs(cs, device: str) -> str:
    """Every input array of the kernels phase, made once and saved as .npy
    under a directory of CACHE; returns the directory."""
    near_n = _near_n(device)
    d = os.path.join(CACHE, str(near_n))
    if os.path.exists(os.path.join(d, "done")):
        return d
    from geomesa_tpu_torch.index.device import fp62_lat, fp62_lon
    os.makedirs(d, exist_ok=True)

    def segments(name, ax, ay, bx, by):
        for plane, v, enc in (("bxmin", np.minimum(ax, bx), fp62_lon),
                              ("bymin", np.minimum(ay, by), fp62_lat),
                              ("bxmax", np.maximum(ax, bx), fp62_lon),
                              ("bymax", np.maximum(ay, by), fp62_lat)):
            hi, lo = enc(v)
            np.save(os.path.join(d, f"{name}_{plane}_i.npy"), hi)
            np.save(os.path.join(d, f"{name}_{plane}_l.npy"), lo)
        for plane, v in (("sx1", ax), ("sy1", ay), ("sx2", bx), ("sy2", by)):
            np.save(os.path.join(d, f"{name}_{plane}.npy"),
                    v.astype(np.float32))

    rng = np.random.default_rng(9)
    ax = rng.uniform(-19, 21, M1_TABLE)   # ~44% of envelopes meet the box
    ay = rng.uniform(20, 58, M1_TABLE)
    segments("m1", ax, ay, ax + rng.uniform(-2, 2, M1_TABLE),
             ay + rng.uniform(-2, 2, M1_TABLE))
    segments("near", *cs.near_edge_segments(near_n, cs.M_SEED + 3))
    x = rng.uniform(0, 20, I_TABLE).astype(np.float32)
    y = rng.uniform(35, 55, I_TABLE).astype(np.float32)
    np.save(os.path.join(d, "i_x.npy"), x)
    np.save(os.path.join(d, "i_y.npy"), y)
    starts = np.sort(rng.choice(I_TABLE // BSZ, I_BLOCKS, replace=False))
    np.save(os.path.join(d, "i_starts.npy"), (starts * BSZ).astype(np.int64))
    np.save(os.path.join(d, "i_mask.npy"),
            rng.random(I_BLOCKS * BSZ) < I_LIVE)
    px, py = cs.band_points(*CIRCLE, near_n, 13)
    np.save(os.path.join(d, "dn_x.npy"), px)
    np.save(os.path.join(d, "dn_y.npy"), py)
    open(os.path.join(d, "done"), "w").close()
    return d


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def setup_kernels(cs, a) -> tuple:
    import torch

    from geomesa_tpu_torch.index import scan
    from geomesa_tpu_torch.index.spatial import _boxes_fp62
    from geomesa_tpu_torch.kernels import build, dist, seg_band

    if a.device == "cuda":
        build.build(["seg_band", "dist_refine"])
    d = a.inputs
    dev = torch.device(a.device)

    def load(name):
        return torch.from_numpy(np.load(os.path.join(d, name))).to(dev)

    r = np.asarray(RING)
    e = torch.from_numpy(np.concatenate([r[:-1], r[1:]], 1)
                         .astype(np.float32)).to(dev)
    box = torch.from_numpy(scan.pad_boxes(_boxes_fp62([BOX]))).to(dev)
    planes = [p + s for p in ("bxmin", "bymin", "bxmax", "bymax")
              for s in ("_i", "_l")] + ["sx1", "sy1", "sx2", "sy2"]
    near_n = _near_n(a.device)
    calls, ready = {}, {}
    for name, bids, reps in (
            ("m1", np.arange(0, 4 * M1_BLOCKS, 4), 200),
            ("near", np.arange(-(-near_n // BSZ)), 20)):
        cols = {p: load(f"{name}_{p}.npy") for p in planes}
        bid = torch.from_numpy(bids.astype(np.int32)).to(dev)
        args = (cols, box, None, None, bid, BSZ, e, 4, 4096)
        res = seg_band.seg_band(*args)
        ready[f"seg_{name}"] = [_digest(res), res[:2].tolist()]
        calls[f"seg_{name}"] = (lambda args=args: seg_band.seg_band(*args),
                                reps)
    cr = np.asarray(CIRCLE, dtype=np.float32)
    # a tree whose wrapper takes f32 [cx, cy, r] and gives the flags alone
    # (before DistBounds): the program summed the flags after it
    counted = hasattr(scan, "DistBounds")
    circle = scan.dist_bounds(cr) if counted else cr
    for name, pre, kw, reps in (
            ("i", "i", {"mask": "i_mask.npy", "starts": "i_starts.npy",
                        "bsz": BSZ}, 200),
            ("near", "dn", {}, 20)):
        tx, ty = load(f"{pre}_x.npy"), load(f"{pre}_y.npy")
        kw = {k: (load(v) if isinstance(v, str) else v)
              for k, v in kw.items()}

        def flags(tx=tx, ty=ty, kw=kw):
            return dist.dist_refine(tx, ty, circle, **kw)

        def with_counts(flags=flags):
            if counted:
                return flags()
            hit, unc = flags()
            return hit, unc, torch.cat(
                [hit.sum(dtype=torch.int32).reshape(1),
                 unc.sum(dtype=torch.int32).reshape(1)])

        hit, unc, cnt = with_counts()
        ready[f"dist_{name}"] = [_digest(hit, unc, cnt), cnt.tolist()]
        calls[f"dist_{name}_flags"] = (flags, reps)
        calls[f"dist_{name}_with_counts"] = (with_counts, reps)

    def answer() -> dict:
        out = {}
        for key, (fn, reps) in calls.items():
            if a.device == "cuda":
                out[f"{key}_ms"] = cs.cuda_ms(fn, reps)
                acts, dev_ms = cs.activities_per_call(fn)
            else:
                t0 = time.perf_counter()
                for _ in range(2):
                    fn()
                out[f"{key}_ms"] = (time.perf_counter() - t0) * 1e3 / 2
                acts = dev_ms = None
            out[f"{key}_activities"] = acts
            out[f"{key}_device_ms"] = dev_ms
        return out

    return ready, answer


# -- phase fused ------------------------------------------------------------


def setup_fused(cs, a) -> tuple:
    import torch

    from geomesa_tpu_torch.index import compiled

    store, _ = _store(cs, a)
    planner = store.planner("gdelt")

    def refine(q, mode, **kw):
        plan = planner.plan(q)
        return compiled.Program(plan, mode, unc_cap=4096,
                                refine=compiled.refine_spec(plan), **kw)

    progs = {
        "a_count": compiled.Program(planner.plan(cs.Q_BOX), "count"),
        "b_count_refine": refine(cs.Q_POLY, "count_refine"),
        "c_select_refine": refine(cs.Q_POLY, "select_refine",
                                  sel_cap=1 << 16),
        "d_density": compiled.Program(planner.plan(cs.Q_D), "density",
                                      grid=cs.D_BBOX, width=64, height=64),
        "h_union_select": compiled.UnionProgram(planner.plan(cs.Q_H),
                                                "select", sel_cap=1 << 16)}
    sync = torch.cuda.synchronize if a.device == "cuda" else (lambda: None)
    ready = {}
    for label, prog in progs.items():
        out = prog.run()
        ready[label] = _digest(*(out if isinstance(out, tuple) else (out,)))
        for _ in range(10):
            prog.run()

    def answer() -> dict:
        out = {}
        for label, prog in progs.items():
            ts = []
            for _ in range(a.reps):
                sync()
                t0 = time.perf_counter()
                prog.run()
                sync()
                ts.append((time.perf_counter() - t0) * 1e3)
            out[f"{label}_p50_ms"] = _median(ts)
            acts = dev_ms = None
            if a.device == "cuda":
                acts, dev_ms = cs.activities_per_call(prog.run)
            out[f"{label}_activities"] = acts
            out[f"{label}_device_ms"] = dev_ms
        return out

    return ready, answer


# -- phase fusedk -----------------------------------------------------------


def sync_ms(fn, reps: int) -> float:
    """The median ms of one call of ``fn`` between two syncs: the latency
    a lone call sees, its launch included."""
    import torch
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    ts = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append((time.perf_counter() - t0) * 1e3)
    return _median(ts)


def setup_fusedk(cs, a) -> tuple:
    import torch

    store, _ = _store(cs, a)
    inp = cs.fused_kernel_inputs(store)
    calls = {key: (kern, reps, cut) for key, (_, kern, _, _, reps, cut, _)
             in cs.fused_kernel_calls(
                 inp, cs.KERNEL_N if a.device == "cuda" else 1 << 16).items()}
    gates = cs.gate_calls(inp)
    for key, (label, kern, plain, _, reps) in gates.items():
        if any(not torch.equal(x, y) for x, y in zip(kern(), plain())):
            raise AssertionError(f"{label} differs from its plain version")
        calls[key] = (kern, reps, None)
    ready = {}
    for key, (kern, _, cut) in calls.items():
        got = kern()
        got = cut(got) if cut else got
        ready[key] = _digest(*(got if isinstance(got, tuple) else (got,)))

    def answer() -> dict:
        out = {}
        for key, (kern, reps, _) in calls.items():
            out[f"{key}_host_ms"] = cs.host_ms(kern, reps)
            out[f"{key}_sync_ms"] = sync_ms(kern, reps)
            if a.device == "cuda":
                out[f"{key}_ms"] = cs.cuda_ms(kern, reps)
                acts, dev_ms = cs.activities_per_call(kern)
            else:
                t0 = time.perf_counter()
                for _ in range(2):
                    kern()
                out[f"{key}_ms"] = (time.perf_counter() - t0) * 1e3 / 2
                acts = dev_ms = None
            out[f"{key}_activities"] = acts
            out[f"{key}_device_ms"] = dev_ms
        return out

    return ready, answer


# -- phase staged -----------------------------------------------------------


def setup_staged(cs, a) -> tuple:
    import torch

    store, _ = _store(cs, a)
    queries = {"f": cs.Q_F, "h": cs.Q_H}
    counts = {k: store.count("gdelt", q) for k, q in queries.items()}
    sync = torch.cuda.synchronize if a.device == "cuda" else (lambda: None)
    calls = {k: (lambda q=q: store.count("gdelt", q))
             for k, q in queries.items()}
    for fn in calls.values():
        for _ in range(20):
            fn()

    def answer() -> dict:
        out = {}
        for k, fn in calls.items():
            ts = []
            for _ in range(a.reps):
                sync()
                t0 = time.perf_counter()
                fn()
                sync()
                ts.append((time.perf_counter() - t0) * 1e3)
            out[f"{k}_p50_ms"] = _median(ts)
            acts = dev_ms = None
            if a.device == "cuda":
                acts, dev_ms = cs.activities_per_call(fn)
            out[f"{k}_activities"] = acts
            out[f"{k}_device_ms"] = dev_ms
        return out

    return counts, answer


def setup_rows(cs, a) -> tuple:
    """The rows path through the tree's store on the same store as
    ``count``: (b)'s and (i)'s counts (their uncertain rows mapped) and
    (c)'s, (h)'s, (i)'s and (j)'s rows (``store.query(...).indices``), each
    a p50 of ``--reps`` calls to a device synchronise and, on the card, its
    device activities and device ms a call; the answers compared by
    digest."""
    import torch

    store, _ = _store(cs, a)
    calls = {"b_count": lambda: store.count("gdelt", cs.Q_POLY),
             "i_count": lambda: store.count("gdelt", cs.Q_I_LT),
             "c_rows": lambda: store.query("gdelt", cs.Q_POLY).indices,
             "h_rows": lambda: store.query("gdelt", cs.Q_H).indices,
             "i_rows": lambda: store.query("gdelt", cs.Q_I_LT).indices,
             "j_rows": lambda: store.query("gdelt",
                                           cs.Q_J_CONTAINS).indices}
    ready = {k: hashlib.sha256(np.asarray(fn()).tobytes()).hexdigest()[:16]
             for k, fn in calls.items()}
    sync = torch.cuda.synchronize if a.device == "cuda" else (lambda: None)

    def answer() -> dict:
        out = {}
        for k, fn in calls.items():
            ts = []
            for _ in range(a.reps):
                sync()
                t0 = time.perf_counter()
                fn()
                sync()
                ts.append((time.perf_counter() - t0) * 1e3)
            out[f"{k}_p50_ms"] = _median(ts)
            acts = dev_ms = None
            if a.device == "cuda":
                acts, dev_ms = cs.activities_per_call(fn, calls=3)
            out[f"{k}_activities"] = acts
            out[f"{k}_device_ms"] = dev_ms
        return out

    return ready, answer


# -- phase process ----------------------------------------------------------


def setup_process(cs, a) -> tuple:
    """``masked_hist`` and ``topk_nearest`` bare on the same store's tensors
    (``chip_smoke.process_kernel_calls``: each histogram form at (a)'s mask
    and over every row, the top-m FULL at m = 32 and 4,096 over the table
    and BLOCKS at m = 32 on cfg4's cover, after one cfg4 query seeds knn's
    radius memo), each checked against its plain version; an answer is
    ``chip_smoke.cuda_ms`` over back-to-back calls, the median of lone
    calls between two syncs and, on the card, the device activities and
    device ms a call; both trees must give the same outputs (digests)."""
    import torch

    from geomesa_tpu_torch import process
    from geomesa_tpu_torch.kernels import build, topk

    store, _ = _store(cs, a)
    process.knn(store.planner("gdelt"), *cs.O_Q, 10)
    # the tree's keys pass, as built (stderr: the trees' outputs must agree)
    print(json.dumps({"keys_pass_sass": cs.sass_keys_pass(
        build._target(topk.NAME)[1])}), file=sys.stderr, flush=True)
    calls = {}
    ready = {}
    for c in cs.process_kernel_calls(store):
        got, want = c["call"](), c["plain"]()
        if c["cut"] is not None:
            got, want = c["cut"](got), c["cut"](want)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if any(not torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"{c['label']} differs from its plain "
                                 "version")
        ready[c["key"]] = _digest(*got)
        calls[c["key"]] = (c["call"], c["reps"])

    def answer() -> dict:
        out = {}
        for key, (kern, reps) in calls.items():
            out[f"{key}_sync_ms"] = sync_ms(kern, reps)
            if a.device == "cuda":
                out[f"{key}_ms"] = cs.cuda_ms(kern, reps)
                acts, dev_ms = cs.activities_per_call(kern)
            else:
                t0 = time.perf_counter()
                for _ in range(2):
                    kern()
                out[f"{key}_ms"] = (time.perf_counter() - t0) * 1e3 / 2
                acts = dev_ms = None
            out[f"{key}_activities"] = acts
            out[f"{key}_device_ms"] = dev_ms
        return out

    return ready, answer


# -- phase catalog -------------------------------------------------------------


def setup_catalog(cs, a) -> tuple:
    """``geom_dist`` and ``geom_pred`` bare on ``chip_smoke.py``'s
    ``catalog_pair_calls`` packs: (m3)'s 500,000 quadrilaterals in an XZ2
    store of their own, whose (q3) counts give the catalog its rows (as
    recorded by ``chip_smoke._pack_recorder``), (q4)'s candidates by their
    envelopes, and (m1)'s 5,000,000 lines; each call checked against its
    plain version. An answer is ``chip_smoke.cuda_ms`` over back-to-back
    calls, the host's ms a call, the median of lone calls between two
    syncs and, on the card, the device activities and device ms a call;
    both trees must give the same outputs (compared by digest)."""
    import torch

    from geomesa_tpu_torch.features.geometry import POLYGON, GeometryArray

    n3 = cs.M_POLY_N if a.device == "cuda" else 2_000
    n1 = cs.M_N if a.device == "cuda" else 20_000
    rings = cs.quads(n3, cs.M_SEED + 2)
    lv = np.arange(n3 + 1, dtype=np.int64)
    quads = GeometryArray(np.full(n3, POLYGON, dtype=np.int8), lv, lv,
                          5 * lv, rings.reshape(-1, 2))
    store, _, _, _ = cs.extent_store(a.device, "parcels", "*geom:Polygon",
                                     {"geom": quads})
    rows = {}
    for key, q in (("q3_intersects", cs.Q_Q3_INTERSECTS),
                   ("q3_contains", cs.Q_Q3_CONTAINS)):
        with cs._pack_recorder() as rec:
            store.count("parcels", q)
        # (a small dry-run layer may leave a query no candidate)
        rows[key] = rec.calls[-1][1] if rec.calls else np.zeros(0, np.int64)
    bb = quads.bboxes()
    (px, py), r = cs.M_BUF_P, cs.Q_DIST_R
    rows["q4"] = np.flatnonzero((bb[:, 0] <= px + r) & (bb[:, 2] >= px - r)
                                & (bb[:, 1] <= py + r) & (bb[:, 3] >= py - r))
    ax, ay, bx, by = cs.cfg2_segments(n1, cs.M_SEED)
    coords = np.empty((2 * n1, 2))
    coords[0::2, 0], coords[0::2, 1] = ax, ay
    coords[1::2, 0], coords[1::2, 1] = bx, by
    lines = GeometryArray.linestrings(coords)
    dev = torch.device(a.device)
    calls = {}
    ready = {"rows": {k: int(len(v)) for k, v in rows.items()}}
    for c in cs.catalog_pair_calls(quads, lines, rows, dev):
        got, want = c["call"](), c["plain"]()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if c["got_rows"] is not None:
            got = tuple(g[c["got_rows"]] for g in got)
        if any(not torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"{c['label']} differs from its plain "
                                 "version")
        got = c["call"]()
        ready[c["ident"]] = _digest(*(got if isinstance(got, tuple)
                                      else (got,)))
        calls[c["ident"]] = (c["call"], min(c["reps"], a.reps))
    del store

    def answer() -> dict:
        out = {}
        for key, (kern, reps) in calls.items():
            out[f"{key}_host_ms"] = cs.host_ms(kern, reps)
            out[f"{key}_sync_ms"] = sync_ms(kern, reps)
            if a.device == "cuda":
                out[f"{key}_ms"] = cs.cuda_ms(kern, reps)
                acts, dev_ms = cs.activities_per_call(kern)
            else:
                t0 = time.perf_counter()
                for _ in range(2):
                    kern()
                out[f"{key}_ms"] = (time.perf_counter() - t0) * 1e3 / 2
                acts = dev_ms = None
            out[f"{key}_activities"] = acts
            out[f"{key}_device_ms"] = dev_ms
        return out

    return ready, answer


# -- phase knn ----------------------------------------------------------------


def setup_knn(cs, a) -> tuple:
    """knn end to end on the same store as ``count``, as ``chip_smoke.py``'s
    (o) drives it: cfg4's k = 10 at its six query points (2.0 + 0.03 i,
    48.0), k = 2,048 (the device cap) at cfg4's point, and the (o) stats
    hint over (a). An answer is the p50 of ``--reps`` calls to a device
    synchronise (10 for the stats hint); both trees must give the same
    rows and distances (compared by digest)."""
    import torch

    from geomesa_tpu_torch import process

    store, _ = _store(cs, a)
    planner = store.planner("gdelt")
    points = [(cs.O_Q[0] + 0.03 * i, cs.O_Q[1]) for i in range(cs.O_REPS)]
    h = hashlib.sha256()
    for q, k in [(q, 10) for q in points] + [(cs.O_Q, 2048)]:
        rows, dists = process.knn(planner, *q, k)
        h.update(np.asarray(rows).tobytes())
        h.update(np.asarray(dists).tobytes())
    stat = store.query("gdelt", cs.Q_BOX, hints={"stats": cs.O_STATS})
    h.update(json.dumps(stat.to_dict() if hasattr(stat, "to_dict")
                        else str(stat), sort_keys=True,
                        default=str).encode())
    sync = torch.cuda.synchronize if a.device == "cuda" else (lambda: None)
    turn = iter(range(1 << 62))
    stages = {
        "knn_k10": (lambda: process.knn(
            planner, *points[next(turn) % len(points)], 10), a.reps),
        "knn_k2048": (lambda: process.knn(planner, *cs.O_Q, 2048), a.reps),
        "stats_hint_a": (lambda: store.query(
            "gdelt", cs.Q_BOX, hints={"stats": cs.O_STATS}), 10)}

    def answer() -> dict:
        out = {}
        for label, (fn, reps) in stages.items():
            ts = []
            for _ in range(reps):
                sync()
                t0 = time.perf_counter()
                fn()
                sync()
                ts.append((time.perf_counter() - t0) * 1e3)
            out[f"{label}_p50_ms"] = _median(ts)
        return out

    return {"digest": h.hexdigest()[:16]}, answer


# -- phase m3 -----------------------------------------------------------------


def setup_m3(cs, a) -> tuple:
    """``chip_smoke.py``'s (m3): 500,000 small convex quadrilaterals (XZ2)
    on a store of their own, its polygon's count (prepared, and through
    ``store.count``) and rows (prepared). An answer is the p50 of
    ``--reps`` calls to a device synchronise; both trees must give the
    same count."""
    import torch

    from geomesa_tpu_torch.features.geometry import POLYGON, GeometryArray

    n = cs.M_POLY_N if a.device == "cuda" else 20_000
    rings = cs.quads(n, cs.M_SEED + 2)
    want = int(np.count_nonzero(cs.oracle_quads(rings, cs.M_RING)))
    lv = np.arange(n + 1, dtype=np.int64)
    garr = GeometryArray(np.full(n, POLYGON, dtype=np.int8), lv, lv,
                         5 * lv, rings.reshape(-1, 2))
    store, planner, _, _ = cs.extent_store(a.device, "parcels",
                                           "*geom:Polygon", {"geom": garr})
    got = store.count("parcels", cs.Q_M1)
    if got != want:
        raise AssertionError(f"(m3) {got}, oracle {want}")
    pq = planner.prepare(cs.Q_M1)
    sync = torch.cuda.synchronize if a.device == "cuda" else (lambda: None)
    stages = {"prepared_count": pq.count,
              "count": lambda: store.count("parcels", cs.Q_M1),
              "prepared_rows": pq.select_indices}

    def answer() -> dict:
        out = {}
        for label, fn in stages.items():
            fn()
            ts = []
            for _ in range(a.reps):
                sync()
                t0 = time.perf_counter()
                fn()
                sync()
                ts.append((time.perf_counter() - t0) * 1e3)
            out[f"{label}_p50_ms"] = _median(ts)
        return out

    return {"count": got}, answer


# -- phase pack ---------------------------------------------------------------


def setup_pack(cs, a) -> tuple:
    """``geom.catalog.pack_features`` onto the card at (q)'s layers: (m1)'s
    5,000,000 lines (bench cfg2's segments) and (m3)'s 500,000
    quadrilaterals, every row, in a seeded random order (the planner hands
    the catalog its rows in index order, which is not the layer's). An
    answer is the p50 of ``min(--reps, 8)`` calls to a device synchronise;
    both trees must give the same packs (compared by digest)."""
    import torch

    from geomesa_tpu_torch.features.geometry import POLYGON, GeometryArray
    from geomesa_tpu_torch.geom import catalog

    n1 = cs.M_N if a.device == "cuda" else 20_000
    n3 = cs.M_POLY_N if a.device == "cuda" else 20_000
    ax, ay, bx, by = cs.cfg2_segments(n1, cs.M_SEED)
    coords = np.empty((2 * n1, 2))
    coords[0::2, 0], coords[0::2, 1] = ax, ay
    coords[1::2, 0], coords[1::2, 1] = bx, by
    rings = cs.quads(n3, cs.M_SEED + 2)
    lv = np.arange(n3 + 1, dtype=np.int64)
    rng = np.random.default_rng(7)
    cases = {
        "lines": (GeometryArray.linestrings(coords), rng.permutation(n1)),
        "quads": (GeometryArray(np.full(n3, POLYGON, dtype=np.int8), lv, lv,
                                5 * lv, rings.reshape(-1, 2)),
                  rng.permutation(n3))}
    dev = torch.device(a.device)
    sync = torch.cuda.synchronize if a.device == "cuda" else (lambda: None)
    fields = ("verts", "vmask", "segs", "smask", "wsign", "mode", "poly",
              "ref32")
    ready = {}
    for k, (arr, rows) in cases.items():
        arr.bboxes()   # cached on the layer's array, as in a store
        p = catalog.pack_features(arr, rows, dev)
        ready[k] = _digest(*(getattr(p, f) for f in fields))
        del p

    split = hasattr(catalog, "pack_host")

    def answer() -> dict:
        out = {}
        for k, (arr, rows) in cases.items():
            ts, th, td = [], [], []
            for _ in range(min(a.reps, 8)):
                sync()
                t0 = time.perf_counter()
                catalog.pack_features(arr, rows, dev)
                sync()
                ts.append((time.perf_counter() - t0) * 1e3)
                if split:   # a tree whose pack has a host and a device half
                    t0 = time.perf_counter()
                    h = catalog.pack_host(arr, rows)
                    t1 = time.perf_counter()
                    catalog.pack_device(h, dev)
                    sync()
                    th.append((t1 - t0) * 1e3)
                    td.append((time.perf_counter() - t1) * 1e3)
            out[f"{k}_p50_ms"] = _median(ts)
            if split:
                out[f"{k}_host_p50_ms"] = _median(th)
                out[f"{k}_device_p50_ms"] = _median(td)
        return out

    return ready, answer


PHASES = {"count": setup_count, "kernels": setup_kernels,
          "fused": setup_fused, "fusedk": setup_fusedk,
          "staged": setup_staged, "rows": setup_rows,
          "process": setup_process, "knn": setup_knn, "m3": setup_m3,
          "pack": setup_pack, "catalog": setup_catalog}


# -- worker and turns -------------------------------------------------------


def worker(a) -> None:
    # the protocol owns the real stdout; anything else printed goes to
    # stderr (a kernel build's report, nvcc's output)
    proto = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    cs = _smoke()
    root = os.path.abspath(a.worker)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    sys.path.insert(0, root)
    os.chdir(root)
    t0 = time.perf_counter()
    ready, answers = {}, {}
    for phase in a.phases.split(","):
        ready[phase], answers[phase] = PHASES[phase](cs, a)
    print(json.dumps({"ready": ready,
                      "setup_s": time.perf_counter() - t0}),
          file=proto, flush=True)
    for line in sys.stdin:
        phase = line.strip()
        if not phase:
            break
        print(json.dumps(answers[phase]()), file=proto, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--phases", default="count,kernels")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--n", type=int, default=100_000_000)
    ap.add_argument("--out", default=os.path.join(HERE, "archive_check",
                                                  "compare.json"))
    ap.add_argument("--device", default="cuda",
                    help="cpu: a dry run of the protocol at a small size")
    ap.add_argument("--worker")
    ap.add_argument("--inputs")
    a = ap.parse_args()
    if a.worker:
        worker(a)
        return 0
    if len(a.roots) != 2:
        ap.error("give PARENT_ROOT and CHANGE_ROOT")
    if any(p not in PHASES for p in a.phases.split(",")):
        ap.error(f"phases are {sorted(PHASES)}")
    import torch
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: torch.cuda.is_available() is false")
    cs = _smoke()
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    except FileNotFoundError:
        card = "no nvidia-smi"
    print(card, flush=True)
    inputs = ""
    if "kernels" in a.phases:
        t0 = time.perf_counter()
        inputs = make_inputs(cs, a.device)
        print(f"inputs {time.perf_counter() - t0:.1f} s", flush=True)
    sides = ("parent", "change")
    procs = {}
    try:
        for side, root in zip(sides, a.roots):
            procs[side] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 os.path.abspath(root), "--phases", a.phases, "--reps",
                 str(a.reps), "--n", str(a.n), "--device", a.device,
                 "--inputs", inputs],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        ready = {}
        for side, p in procs.items():
            line = p.stdout.readline()
            if not line:
                raise RuntimeError(f"{side} worker died before it was ready")
            ready[side] = json.loads(line)
            print(json.dumps({side: ready[side]}), flush=True)
        if ready["parent"]["ready"] != ready["change"]["ready"]:
            raise AssertionError("the trees' outputs differ")
        answers = {s: {p: [] for p in a.phases.split(",")} for s in sides}
        pairs = {p: [] for p in a.phases.split(",")}
        for r in range(a.rounds):
            order = sides if r % 2 == 0 else sides[::-1]
            for phase in a.phases.split(","):
                got = {}
                for side in order:
                    p = procs[side]
                    p.stdin.write(phase + "\n")
                    p.stdin.flush()
                    line = p.stdout.readline()
                    if not line:
                        raise RuntimeError(f"{side} worker died in round {r}")
                    got[side] = json.loads(line)
                    answers[side][phase].append(got[side])
                pairs[phase].append({
                    k: got["change"][k] - got["parent"][k]
                    for k in got["change"] if k in got["parent"]
                    and None not in (got["change"][k], got["parent"][k])})
                print(json.dumps({"round": r, "phase": phase,
                                  "order": list(order), **got}), flush=True)
        summary = {"card": card, "phases": a.phases, "rounds": a.rounds,
                   "median": {}, "change_minus_parent": {}}
        for phase in pairs:
            summary["median"][phase] = {
                s: {k: _median([b[k] for b in answers[s][phase]])
                    for k in answers[s][phase][0]
                    if all(b[k] is not None for b in answers[s][phase])}
                for s in sides}
            keys = set.intersection(*(set(d) for d in pairs[phase]))
            summary["change_minus_parent"][phase] = {
                k: {"median": _median([d[k] for d in pairs[phase]]),
                    "change_slower_in": sum(d[k] > 0 for d in pairs[phase]),
                    "of_pairs": len(pairs[phase])}
                for k in sorted(keys)}
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump({"summary": summary, "ready": ready,
                       "answers": answers}, fh, indent=1)
        print(json.dumps(summary), flush=True)
    finally:
        for p in procs.values():
            if p.poll() is None:
                try:
                    p.stdin.write("\n")
                    p.stdin.flush()
                    p.wait(timeout=60)
                except (OSError, subprocess.TimeoutExpired):
                    p.kill()
                    p.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
