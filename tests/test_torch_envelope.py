"""The envelope primary on ``fused_scan``'s ENV form (extent layers:
``XZ2Index``/``XZ3Index`` over lines and polygons) against the JAX package
on identical seeded tables: a 4,000-row single-segment line layer (XZ2)
and a 3,000-row polygon layer with a date (XZ3), gather blocks of 512 rows
in both packages.

- the packed query of an envelope stage (``staged_query``): the ENV flag,
  its box keys ``pack62`` of the reference's fp62 boxes, and the point
  layer's and extent layer's primaries kept apart;
- every staged mode of ``ScanKernels`` — the full-table mask, count and
  packed select, the block count and selects, the per-box counts — on the
  kernel route (the torch ops refused, every scan through the ENV form)
  and on the torch ops (residuals past the program) against the
  reference's ``ScanKernels``, with and without ``__valid__``;
- the OR of envelope and boxless stages (one K-branch scan);
- ``count_at``/``select_at`` over runs (the RUNS and ENV forms together)
  against the reference's over the same positions;
- ``seg_band``'s block residual through ``fused_scan``'s boxless mask
  against the reference's band count and uncertain rows.

Tolerance: none — counts, masks, packed selects and row ids compare
exactly. The port runs with device="cpu" (the plain versions).

The ``gpu`` tests hold the ENV form to its plain version on the card:
block lists with pads and the clamped last block, 1–64 boxes (empty ones
too), envelopes on the boxes' edges and the domain's, windows, residuals,
``__valid__``, the VIS and RUNS forms, count and mask, and an XZ2 store's
answers on the card to the CPU's. They import nothing of JAX: ``python -m
pytest --noconftest -m gpu tests/test_torch_envelope.py`` runs them on the
card.
"""

import importlib

import numpy as np
import pytest
import torch

from geomesa_tpu_torch import DataStoreFinder
from geomesa_tpu_torch import config as tconfig
from geomesa_tpu_torch.features import geometry as tgeo
from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.filter.parser import parse_ecql as tparse
from geomesa_tpu_torch.index import scan as tscan
from geomesa_tpu_torch.index.device import fp62_lat, fp62_lon
from geomesa_tpu_torch.index.planner import QueryPlanner as TPlanner
from geomesa_tpu_torch.index.spatial import XZ2Index as TXZ2
from geomesa_tpu_torch.index.spatial import XZ3Index as TXZ3
from geomesa_tpu_torch.index.spatial import _boxes_fp62 as t_fp62
from geomesa_tpu_torch.kernels import compact as kcompact
from geomesa_tpu_torch.kernels import fused_scan as kscan

BSZ = 512
WIDE = 17   # residual columns: one past fused_scan.MAX_SLOTS
DURING = "dtg DURING 2020-01-03T00:00:00Z/2020-01-15T00:00:00Z"
BOX = "BBOX(geom, -12, 28, 14, 50)"
POLY = "POLYGON ((-12 30, 10 28, 14 44, -2 50, -12 30))"


def _ref(name: str):
    """A module of the JAX package (imported only by the CPU tests)."""
    pytest.importorskip("jax")
    return importlib.import_module(name)


def _segments(n, rng):
    """bench.py cfg2's segments, narrowed to (-60, 60) x (0, 70)."""
    lx = rng.uniform(-60, 60, n)
    ly = rng.uniform(0, 70, n)
    coords = np.empty((2 * n, 2))
    coords[0::2, 0], coords[0::2, 1] = lx, ly
    coords[1::2, 0] = lx + rng.uniform(0.01, 2.0, n)
    coords[1::2, 1] = ly + rng.uniform(0.01, 2.0, n)
    # envelopes on the query boxes' edges and the domain's
    coords[0:8:2, 0] = [-12.0, 14.0, -60.0, 58.0]
    coords[1:9:2, 0] = [-13.0, 16.0, -60.0, 60.0]
    return coords


def _quads(n, rng):
    cx = rng.uniform(-60, 60, n)
    cy = rng.uniform(0, 70, n)
    r = rng.uniform(0.05, 1.5, (n, 4))
    ang = np.sort(rng.uniform(0, 2 * np.pi, (n, 4)), axis=1)
    xs = cx[:, None] + r * np.cos(ang)
    ys = cy[:, None] + r * np.sin(ang)
    return [(tgeo.POLYGON, [np.column_stack(
        [np.append(xs[i], xs[i, 0]), np.append(ys[i], ys[i, 0])]).tolist()])
        for i in range(n)]


# layer: (geometry type, dated, rows, index class names)
LAYERS = {"lines": ("LineString", False, 4000, "XZ2Index"),
          "polys": ("Polygon", True, 3000, "XZ3Index")}


def _spec(layer):
    gtype, dated, _, _ = LAYERS[layer]
    spec = "val:Int,name:String,score:Float," \
        + ",".join(f"c{k}:Int" for k in range(WIDE)) \
        + (",dtg:Date" if dated else "") + f",*geom:{gtype}"
    return spec + (";geomesa.z3.interval=week" if dated else "")


def _columns(layer, seed):
    gtype, dated, n, _ = LAYERS[layer]
    rng = np.random.default_rng(seed)
    cols = {"val": rng.integers(0, 100, n).astype(np.int32),
            "name": rng.choice(["a", "b", "c"], n),
            "score": rng.uniform(0, 1, n).astype(np.float32)}
    for k in range(WIDE):
        cols[f"c{k}"] = rng.integers(0, 100, n).astype(np.int32)
    if dated:
        base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
        cols["dtg"] = base + rng.integers(0, 30 * 86400000, n)
    return cols, (_segments(n, rng) if gtype == "LineString"
                  else _quads(n, rng))


@pytest.fixture(autouse=True)
def _blocks():
    """Gather blocks of ``BSZ`` rows in both packages (the port's alone
    where the JAX package is not installed, as on the card)."""
    confs = [tconfig]
    try:
        confs.append(importlib.import_module("geomesa_tpu.config"))
        vars(importlib.import_module("geomesa_tpu.index.prune")).pop(
            "BLOCK_SIZE", None)
    except ImportError:
        pass
    for c in confs:
        c.PRUNE_BLOCK.set(BSZ)
    yield
    for c in confs:
        c.PRUNE_BLOCK.unset()


@pytest.fixture(scope="module")
def layers():
    """{layer: (reference planner, port planner, __valid__)}."""
    jconfig = _ref("geomesa_tpu.config")
    jgeo = _ref("geomesa_tpu.features.geometry")
    JSFT = _ref("geomesa_tpu.features.sft").SimpleFeatureType
    JTable = _ref("geomesa_tpu.features.table").FeatureTable
    JPlanner = _ref("geomesa_tpu.index.planner").QueryPlanner
    jspatial = _ref("geomesa_tpu.index.spatial")
    vars(_ref("geomesa_tpu.index.prune")).pop("BLOCK_SIZE", None)
    out = {}
    jconfig.PRUNE_BLOCK.set(BSZ)
    tconfig.PRUNE_BLOCK.set(BSZ)
    try:
        for layer, (gtype, _, n, cls) in LAYERS.items():
            cols, g = _columns(layer, 7)
            if gtype == "LineString":
                jg = jgeo.GeometryArray.linestrings(g)
                tg = tgeo.GeometryArray.linestrings(g)
            else:
                jg = jgeo.GeometryArray.from_shapes(g)
                tg = tgeo.GeometryArray.from_shapes(g)
            jsft = JSFT.from_spec(layer, _spec(layer))
            tsft = TSFT.from_spec(layer, _spec(layer))
            jt = JTable.build(jsft, dict(cols, geom=jg))
            tt = TTable.build(tsft, dict(cols, geom=tg))
            tcls = TXZ2 if cls == "XZ2Index" else TXZ3
            jp = JPlanner(jsft, jt, [getattr(jspatial, cls)(jsft, jt)])
            tp = TPlanner(tsft, tt, [tcls(tsft, tt, "cpu")])
            valid = np.random.default_rng(3).random(n) >= 0.2
            out[layer] = (jp, tp, valid)
    finally:
        jconfig.PRUNE_BLOCK.unset()
        tconfig.PRUNE_BLOCK.unset()
    return out


def _kernels(jp, tp, valid):
    """Both packages' ScanKernels over their index's columns, with the
    ``__valid__`` column when given."""
    jnp = _ref("jax.numpy")
    JKernels = _ref("geomesa_tpu.index.scan").ScanKernels
    jcols = dict(jp.indexes[0].device.columns)
    tcols = dict(tp.indexes[0].device.columns)
    if valid is not None:
        jcols["__valid__"] = jnp.asarray(valid)
        tcols["__valid__"] = torch.from_numpy(valid)
    return JKernels(jcols), tscan.ScanKernels(tcols)


def _args(plan):
    return (plan.primary_kind, plan.boxes_loose, plan.windows,
            plan.residual_device)


def _packed(jk, mode, ja, extra):
    res = ja[3]
    return np.asarray(jk._get(
        mode, ja[0], ja[2] is not None, res[0] if res else "none",
        res[2] if res else None, 0 if ja[1] is None else len(ja[1]),
        0 if ja[2] is None else len(ja[2]), extra[0])(
            jk.cols, ja[1], ja[2],
            [np.asarray(p) for p in res[1]] if res else [], *extra[1:]))


def _refuse(*a, **k):
    raise AssertionError("the torch-ops route ran")


def _kernel_route(monkeypatch, stages):
    """Refuse the torch-ops route (the staged mask's torch ops and the
    residual's closure) and spy on the ``fused_scan`` wrapper; returns
    (the stages with that closure, the (env, points) flags of the scans
    made)."""
    monkeypatch.setattr(tscan, "_mask_kernel", _refuse)
    monkeypatch.setattr(tscan.ScanKernels, "_stage", _refuse)
    seen = []
    plain = kscan.fused_scan

    def spy(cols, qbuf, query, *a, **kw):
        seen.append((query.env, query.points))
        return plain(cols, qbuf, query, *a, **kw)

    monkeypatch.setattr(kscan, "fused_scan", spy)
    stages = [st if st[3] is None else (*st[:3], st[3]._replace(fn=_refuse))
              for st in stages]
    return stages, seen


def _deep(k: int = 70) -> str:
    r = "val > 1"
    for j in range(k):
        r = f"(val <> {j + 200} {'AND' if j % 2 else 'OR'} {r})"
    return r


# (label, layer, query, kernel route?)
STAGES = [
    ("box", "lines", BOX, True),
    ("box_resid", "lines", f"{BOX} AND val > 30", True),
    ("box_in_float", "lines", "BBOX(geom, -40, 10, 40, 60) AND name IN "
     "('b', 'c') AND score >= 0.25", True),
    ("two_boxes", "lines", "INTERSECTS(geom, MULTIPOLYGON (((-10 30, 0 30, "
     "0 40, -10 30)), ((5 45, 12 45, 12 52, 5 45))))", True),
    ("edge", "lines", "BBOX(geom, 58, 60, 60, 70)", True),
    ("none_resid", "lines", "val < 20", True),
    ("include", "lines", "INCLUDE", True),
    ("wide", "lines", f"{BOX} AND "
     + " AND ".join(f"c{k} < 97" for k in range(WIDE)), False),
    ("deep", "lines", f"{BOX} AND {_deep()}", False),
    ("poly_box", "polys", BOX, True),
    ("poly_windows", "polys", f"{BOX} AND {DURING} AND val > 20", True),
    ("poly_none_windows", "polys", f"{DURING} AND val > 30", True),
    ("poly_intersects", "polys", f"INTERSECTS(geom, {POLY})", True),
]


def test_envelope_stage_packs_the_env_query(layers):
    """An extent layer's ``bbox_overlap`` stage packs into a query with the
    ENV flag, its box keys the ``pack62`` keys of the plan's fp62 boxes
    (the point form's packing); a point primary on envelopes, or an
    envelope primary on points, keeps the torch ops."""
    jp, tp, _ = layers["polys"]
    plan = tp.plan(f"{BOX} AND {DURING} AND val > 20")
    assert plan.primary_kind == "bbox_overlap"
    cols = tp.indexes[0].device.columns
    q = tscan.staged_query(cols, [_args(plan)])
    assert q.env and q.points and q.has_time and len(q.slots) == 1
    b = np.asarray(plan.boxes_loose)
    keys = q.section(torch.from_numpy(q.packed), "box", torch.int64, 4)
    want = np.stack([tscan._pack62_np(b[:, 2 * j], b[:, 2 * j + 1])
                     for j in range(4)], axis=1)
    assert np.array_equal(keys.numpy(), want)
    jb = np.asarray(jp.plan(f"{BOX} AND {DURING} AND val > 20").boxes_loose)
    assert np.array_equal(b, jb)
    assert tscan.staged_query(cols, [("point_boxes", *_args(plan)[1:])]) \
        is None
    pts = {k: torch.zeros(4, dtype=torch.int32) for k in
           ("xi", "xl", "yi", "yl")}
    assert tscan.staged_query(pts, [("bbox_overlap", b, None, None)]) is None
    boxless = tscan.staged_query(cols, [("none", None, plan.windows, None)])
    assert boxless.env and not boxless.points


@pytest.mark.parametrize("valid", [False, True], ids=["all_valid",
                                                      "valid_col"])
@pytest.mark.parametrize("label,layer,q,kernel", STAGES,
                         ids=[s[0] for s in STAGES])
def test_envelope_modes_equal_reference(layers, label, layer, q, kernel,
                                        valid, monkeypatch):
    jp, tp, vmask = layers[layer]
    n = LAYERS[layer][2]
    jk, tk = _kernels(jp, tp, vmask if valid else None)
    ja, ta = _args(jp.plan(q)), _args(tp.plan(q))
    assert ta[0] == ja[0]
    assert (tscan.staged_query(tk.cols, [ta]) is not None) == kernel
    seen = []
    if kernel:
        (ta,), seen = _kernel_route(monkeypatch, [ta])
    want_mask = np.asarray(jk.mask(*ja))
    got_mask = tk.mask(*ta)
    assert got_mask.dtype == torch.bool and got_mask.shape == (n,)
    assert np.array_equal(got_mask.numpy(), want_mask)
    want = int(want_mask.sum())
    assert want > 0
    assert tk.count(*ta) == jk.count(*ja) == want
    assert int(tk.prepare_count(*ta)()) == want
    for cap in (16, 1024, 8192):
        got = tk.prepare_select(*ta, cap)()
        assert np.array_equal(got.numpy(),
                              _packed(jk, "select_packed", ja, (cap,)))
    blocks = np.array([0, 2, 3, n // BSZ - 1, n // BSZ], dtype=np.int32)
    pad = jk._pad_blocks(blocks)
    assert tk.count_blocks(*ta, blocks, BSZ) == \
        jk.count_blocks(*ja, blocks, BSZ)
    got = tk.prepare_select_blocks(*ta, blocks, BSZ, 2048)()
    assert np.array_equal(got.numpy(), _packed(
        jk, "select_blocks", ja, ((len(pad), BSZ, 2048), pad)))
    ji, jc = jk.select_blocks(*ja, blocks, BSZ, 16)
    ti, tc = tk.select_blocks(*ta, blocks, BSZ, 16)
    assert tc == jc and np.array_equal(ti, ji)
    if ta[0] == "bbox_overlap":   # per-box counts: box_count's ENV variant
        for b in (None, blocks):
            jm = jk.counts_multi(*ja) if b is None \
                else jk.counts_multi_blocks(*ja, b, BSZ)
            tm = tk.counts_multi(*ta) if b is None \
                else tk.counts_multi_blocks(*ta, b, BSZ)
            assert np.array_equal(tm, np.asarray(jm))
    if kernel and ta[0] == "bbox_overlap":
        # every scan read envelopes, and those with boxes took the ENV form
        assert all(e for e, _ in seen) and any(p for _, p in seen)


UNIONS = [
    ("two_boxes", "lines", [BOX, "BBOX(geom, 0, 40, 30, 60) AND val > 50"]),
    ("box_and_none", "lines", [BOX, "val < 5"]),
    ("dated", "polys", [f"{BOX} AND {DURING}",
                        "BBOX(geom, -40, 10, -20, 30) AND name = 'b'",
                        f"{DURING} AND val < 3"]),
]


@pytest.mark.parametrize("valid", [False, True], ids=["all_valid",
                                                      "valid_col"])
@pytest.mark.parametrize("label,layer,qs", UNIONS,
                         ids=[u[0] for u in UNIONS])
def test_envelope_union_equals_reference(layers, label, layer, qs, valid,
                                         monkeypatch):
    """The OR of envelope (and boxless) stages: one K-branch ENV scan, its
    count and row mask against the reference's OR of masks."""
    jp, tp, vmask = layers[layer]
    jk, tk = _kernels(jp, tp, vmask if valid else None)
    stages, seen = _kernel_route(monkeypatch,
                                 [_args(tp.plan(q)) for q in qs])
    masks = [np.asarray(jk.mask(*_args(jp.plan(q)))) for q in qs]
    want = np.logical_or.reduce(masks)
    assert tk.union_count(stages) == int(want.sum()) > 0
    got = tk.union_mask(stages)
    assert np.array_equal(got.numpy(), want)
    assert seen == [(True, True), (True, True)]


RUNS = [[(0, 1)], [(3, 9), (500, 530), (1020, 1030)],
        [(0, 4000)], [(3990, 4000)], [(5, 5), (700, 1800)]]


@pytest.mark.parametrize("runs", RUNS, ids=[str(i) for i in range(len(RUNS))])
@pytest.mark.parametrize("q", [BOX, f"{BOX} AND val > 30", "val < 50",
                               f"{BOX} AND " + " AND ".join(
                                   f"c{k} < 97" for k in range(WIDE))],
                         ids=["box", "box_resid", "resid", "wide"])
def test_envelope_runs_equal_reference(layers, q, runs):
    """``count_at``/``select_at`` over runs of positions on an extent
    layer (the RUNS and ENV forms in one launch; past the program the
    primary stays there and the residual ANDs in as torch ops) against the
    reference's over the same positions."""
    jp, tp, _ = layers["lines"]
    jk, tk = _kernels(jp, tp, None)
    ja, ta = _args(jp.plan(q)), _args(tp.plan(q))
    pos = np.concatenate([np.arange(lo, hi) for lo, hi in runs])
    want = jk.count_at(*ja, pos)
    assert tk.count_at(*ta, runs) == want
    jsel, jcnt = jk.select_at(*ja, pos)
    tsel, tcnt = tk.select_at(*ta, runs, 64)
    assert tcnt == jcnt == want
    assert np.array_equal(tsel, np.sort(jsel))


@pytest.mark.parametrize("resid", [None, "val > 30", "name = 'b'"])
def test_band_residual_through_the_boxless_scan(layers, resid, monkeypatch):
    """``seg_band``'s block residual is ``fused_scan``'s mask of the
    residual alone (no torch closure); the band's certain count and
    uncertain rows equal the reference's."""
    jp, tp, _ = layers["lines"]
    jk, tk = _kernels(jp, tp, None)
    assert tp.indexes[0].ensure_segment_columns()
    jp.indexes[0].ensure_segment_columns()
    jk, tk = _kernels(jp, tp, None)
    q = f"INTERSECTS(geom, {POLY})" + (f" AND {resid}" if resid else "")
    ja, ta = _args(jp.plan(q)), _args(tp.plan(q))
    if resid:
        (ta,), _ = _kernel_route(monkeypatch, [ta])
    ring = tgeo.parse_wkt(POLY)[1][0]
    edges = np.array([[a[0], a[1], b[0], b[1]] for a, b in
                      zip(ring[:-1], ring[1:])], dtype=np.float32)
    blocks = np.arange(LAYERS["lines"][2] // BSZ + 1, dtype=np.int32)
    jc, ju = jk.intersects_band_blocks(*ja, edges, blocks, BSZ)
    tc, tu = tk.intersects_band_blocks(*ta, edges, blocks, BSZ)
    assert tc == jc and np.array_equal(tu, np.asarray(ju))


@pytest.mark.parametrize("layer,q", [
    ("lines", f"{BOX} AND val > 30"), ("lines", f"INTERSECTS(geom, {POLY})"),
    ("polys", f"{BOX} AND {DURING}"), ("polys", "INCLUDE"),
    ("polys", f"BBOX(geom, -40, 10, 40, 60) AND name = 'c' OR {BOX}")])
def test_store_answers_equal_reference(layers, layer, q):
    """Counts and rows through the planners (the staged selects on the ENV
    form, the host refine behind them) equal the reference's."""
    jp, tp, _ = layers[layer]
    assert tp.count(q) == jp.count(q)
    assert np.array_equal(np.sort(tp.select_indices(q)),
                          np.sort(jp.select_indices(q)))


# -- the ENV form against its plain version (card only) ----------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the fused_scan ENV form)")
    return torch.device("cuda")


def _env_planes(n: int, seed: int, dev, valid: bool):
    """Device planes of an extent table: fp62 envelopes (a fiftieth with
    bxmin on x = 10, a box edge; some points and world-wide ones), binned
    time, residual columns, a sparse ``__valid__``, visibility codes."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-180, 175, n)
    y0 = rng.uniform(-90, 85, n)
    x1 = np.minimum(180.0, x0 + rng.uniform(0, 5, n))
    y1 = np.minimum(90.0, y0 + rng.uniform(0, 5, n))
    x0[: n // 50] = 10.0
    x1[n // 50: n // 25] = x0[n // 50: n // 25]      # points
    x0[:3], y0[:3], x1[:3], y1[:3] = -180.0, -90.0, 180.0, 90.0
    cols = {}
    for name, v, enc in (("bxmin", x0, fp62_lon), ("bymin", y0, fp62_lat),
                         ("bxmax", x1, fp62_lon), ("bymax", y1, fp62_lat)):
        cols[name + "_i"], cols[name + "_l"] = enc(v)
        cols[name] = v.astype(np.float32)
    cols.update({
        "bin": np.sort(rng.integers(2600, 2606, n)).astype(np.int32),
        "off": rng.integers(0, 604800, n).astype(np.int32),
        "val": rng.integers(0, 100, n).astype(np.int32),
        "score": rng.uniform(0, 1, n).astype(np.float32),
        "__vis__": rng.integers(-1, 6, n).astype(np.int32)})
    if valid:
        cols["__valid__"] = rng.random(n) < 0.9
    return {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}


def _env_query(nbox: int, windows: bool, resid, seed: int, vis=None,
               empty=False):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-180, 170, max(1, nbox))
    y0 = rng.uniform(-90, 80, max(1, nbox))
    geo = [(float(a), float(b), float(min(180, a + rng.uniform(0, 40))),
            float(min(90, b + rng.uniform(0, 30)))) for a, b in zip(x0, y0)]
    geo[0] = (10.0, geo[0][1], geo[0][2], geo[0][3])
    boxes = tscan.pad_boxes(t_fp62(geo))
    if empty:
        boxes[:] = tscan.EMPTY_BOX
    w = np.array([[2601, 1000, 2603, 500], [2605, 7, 2605, 90000]],
                 dtype=np.int32) if windows else None
    sft = TSFT.from_spec("g", "val:Int,score:Float,dtg:Date,*geom:Polygon")
    prog = tscan.compile_residual(tparse(resid), sft, {}).program \
        if resid else None
    return tscan.FusedQuery([(boxes, None, w, prog)], vis, env=True)


def _blocks(case: str, nb: int):
    if case == "all":
        return np.arange(nb, dtype=np.int32), nb
    ids = {"edge": np.array([0, 3, nb - 2, nb - 1], dtype=np.int32),
           "none": np.empty(0, dtype=np.int32)}.get(
        case, np.arange(0, nb, 3, dtype=np.int32))
    full = np.full(nb, -1, dtype=np.int32)
    full[: len(ids)] = ids
    return full, len(ids)


ENV_CASES = [(n, bsz, nbox, windows, resid, valid, blocks)
             for n, bsz in ((100_003, 4096), (20_011, 512))
             for nbox in (1, 4, 64)
             for windows, resid, valid in (
                 (False, None, False), (True, "val > 10", False),
                 (True, "NOT (val > 50 AND score < 0.5)", True))
             for blocks in ("all", "edge", "sparse", "none")]


def _run_both(cols, q, ids, k, bsz, runs=None):
    dev = cols["bxmin_i"].device
    qbuf = torch.from_numpy(q.packed).to(dev)
    ids = torch.from_numpy(ids).to(dev)
    nblk = torch.tensor([k], dtype=torch.int32, device=dev)
    live = k * bsz
    out = {}
    for mode in ("count", "mask"):
        before = (kscan.fused_scan.launches, kscan.fused_scan.env_launches)
        got = kscan.fused_scan(cols, qbuf, q, ids, nblk, bsz, mode,
                               runs=runs)
        want = tscan.fused_scan(cols, qbuf, q, ids, nblk, bsz, mode,
                                runs=runs)
        torch.cuda.synchronize()
        assert (kscan.fused_scan.launches, kscan.fused_scan.env_launches) \
            == (before[0] + 1, before[1] + 1)
        if mode == "mask":
            assert torch.equal(got[1], want[1])
            assert torch.equal(got[0][:live], want[0][:live])
        else:
            assert torch.equal(got, want)
        out[mode] = (got, want)
    return out, ids, nblk


@pytest.mark.gpu
@pytest.mark.parametrize("n,bsz,nbox,windows,resid,valid,blocks", ENV_CASES)
def test_cuda_env_form_equals_plain(n, bsz, nbox, windows, resid, valid,
                                    blocks):
    dev = _cuda()
    cols = _env_planes(n, nbox + bsz, dev, valid)
    q = _env_query(nbox, windows, resid, seed=nbox)
    ids, k = _blocks(blocks, -(-n // bsz))
    out, dids, nblk = _run_both(cols, q, ids, k, bsz)
    got, want = out["mask"]
    starts = tscan.expand_blocks(cols, dids, bsz, n)[2]
    for cap in (0, 5000):
        kw = dict(starts=starts, bsz=bsz, n_blocks=nblk)
        c, r = kcompact.ordered_compact(got[0], cap, n, **kw)
        cw, rw = tscan.ordered_compact(want[0], cap, n, **kw)
        assert torch.equal(c, cw) and torch.equal(r, rw), cap


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["vis", "runs", "empty_boxes",
                                  "misaligned"])
def test_cuda_env_forms_equal_plain(form):
    dev = _cuda()
    n, bsz = 50_021, 256
    cols = _env_planes(n, 5, dev, True)
    # the runs' rows lie in the first bin, before every window
    q = _env_query(8, form != "runs", "val > 20", seed=9,
                   vis=[0, 2, 5] if form == "vis" else None,
                   empty=form == "empty_boxes")
    if form == "misaligned":   # every plane a view at offset 1
        cols = {k: v[1:] for k, v in cols.items()}
        n -= 1
    runs = None
    if form == "runs":
        r = [(3, 9), (255, 260), (1000, 1513), (n - 7, n)]
        ids, bounds = tscan.run_pieces(r, n, bsz)
        k = len(ids)
        runs = torch.from_numpy(bounds).to(dev)
    else:
        ids, k = _blocks("edge", -(-n // bsz))
    out, _, _ = _run_both(cols, q, ids, k, bsz, runs=runs)
    if form == "empty_boxes":
        assert int(out["count"][1]) == 0
    else:
        assert int(out["count"][1]) > 0


@pytest.mark.gpu
def test_cuda_store_envelope_answers_equal_cpu():
    """An XZ2 line store and an XZ3 polygon store on the card answer as on
    the CPU (counts, rows, a density), their staged scans on the ENV
    form."""
    _cuda()
    rng = np.random.default_rng(21)
    n = 30_000
    segs = _segments(n, rng)
    base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
    cols = {"val": rng.integers(0, 100, n).astype(np.int32),
            "dtg": base + rng.integers(0, 30 * 86400000, n)}
    spec = "val:Int,dtg:Date,*geom:LineString;geomesa.z3.interval=week"
    answers = []
    for dev in ("cpu", "cuda"):
        s = DataStoreFinder.get_data_store(type="torch", device=dev)
        s.create_schema("l", spec)
        s.load("l", TTable.build(s.get_schema("l"), dict(
            cols, geom=tgeo.GeometryArray.linestrings(segs))))
        before = kscan.fused_scan.env_launches
        qs = [f"{BOX} AND {DURING}", f"{BOX} AND val > 30",
              f"INTERSECTS(geom, {POLY}) AND val < 50"]
        got = [(s.count("l", q), s.query("l", q).indices.tolist())
               for q in qs]
        grid = s.query("l", BOX, hints={"density": {
            "bbox": (-12, 28, 14, 50), "width": 32, "height": 32}})
        got.append(grid.weights.tobytes())
        if dev == "cuda":
            assert kscan.fused_scan.env_launches > before
        answers.append(got)
    assert answers[0] == answers[1]
