"""Visibility labels and query authorizations in the port
(geomesa_tpu_torch) against the JAX package on identical state, on the
inputs of the reference's own ``tests/test_security.py``: the expression
grammar and ``allowed_codes`` of the copied ``security`` module, then a
6,000-row point layer whose features carry eight visibility expressions,
with gather blocks of 512 rows in both packages so the fused program
qualifies. Under every set of auths, counts and selected row ids (in order)
must equal the reference's and a numpy oracle that evaluates the
expressions itself: the fused count, select and polygon refine, the staged
modes (no box, a residual, INCLUDE), OR unions (the union program and the
per-branch path), prepared queries and the recipe cache, a reused plan
under other auths (the ``__vis_applied__`` leak guard), unit and weighted
density grids, the store's delta tier and a flush whose visibility
vocabulary grows, and the scheduler keyed by auths. The port runs with
device="cpu": its kernels' plain versions."""

import importlib

import numpy as np
import pytest
import torch

from geomesa_tpu import config as jconfig
from geomesa_tpu import security as jsec
from geomesa_tpu.datastore import TpuDataStore
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.features.table import FeatureTable as JTable
from geomesa_tpu.index import compiled as jcompiled
from geomesa_tpu.index.planner import QueryPlanner as JPlanner
from geomesa_tpu.index.spatial import Z3Index as JZ3
from geomesa_tpu_torch import DataStoreFinder
from geomesa_tpu_torch import config as tconfig
from geomesa_tpu_torch import security as tsec
from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.index import compiled as tcompiled
from geomesa_tpu_torch.index import scan as tscan
from geomesa_tpu_torch.index.api import UnionScanPlan
from geomesa_tpu_torch.index.planner import QueryPlanner as TPlanner
from geomesa_tpu_torch.index.spatial import Z3Index as TZ3

jdensity = importlib.import_module("geomesa_tpu.aggregates.density")
tdensity = importlib.import_module("geomesa_tpu_torch.aggregates.density")

SPEC = ("name:String,age:Int,score:Float,dtg:Date,*geom:Point;"
        "geomesa.z3.interval=week")
POLY = "POLYGON((-10 20, 40 20, 40 60, -10 60, 15 40, -10 20))"
DURING = "dtg DURING 2020-01-03T00:00:00Z/2020-01-15T00:00:00Z"
BOX = "BBOX(geom,-60,-30,60,30)"
EXPRS = ["", "admin", "admin&ops", "user|ops", "admin&(user|ops)",
         '"a b"', "ops", "x|y|admin"]
AUTHS = [None, [], ["admin"], ["ops"], ["user"], ["admin", "ops"],
         ["user", "admin"], ["admin", "ops", "user", "a b", "x"]]
QUERIES = [
    f"{BOX} AND {DURING}",                       # fused count / select
    f"{BOX} AND {DURING} AND age > 10",          # fused, residual
    f"INTERSECTS(geom, {POLY}) AND {DURING}",    # fused polygon refine
    "st_distance(geom, POINT(0 0)) < 40",         # fused dist refine
    f"{DURING} AND age > 50",                    # staged, no box
    "INCLUDE",                                   # staged, nothing at all
    "age < 30",                                  # staged residual only
    "BBOX(geom,-60,-30,0,0) OR BBOX(geom,-10,-10,60,30)",   # union program
    f"BBOX(geom,-60,-30,0,0) OR INTERSECTS(geom, {POLY})",  # per branch
]


@pytest.fixture(autouse=True)
def _small_blocks():
    from geomesa_tpu.index import prune
    vars(prune).pop("BLOCK_SIZE", None)
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.set(512)
        c.FUSED_QUERY.set(True)
    yield
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.unset()
        c.FUSED_QUERY.unset()


def _columns(n, seed):
    rng = np.random.default_rng(seed)
    base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
    cols = {"name": rng.choice(["alpha", "beta", "gamma"], n),
            "age": rng.integers(0, 100, n).astype(np.int32),
            "score": rng.uniform(0, 1, n).astype(np.float32),
            "dtg": base + rng.integers(0, 30 * 86400000, n),
            "geom": (rng.uniform(-170, 170, n), rng.uniform(-80, 80, n))}
    return cols, rng.choice(EXPRS, n)


@pytest.fixture(scope="module")
def world():
    from geomesa_tpu.index import prune
    vars(prune).pop("BLOCK_SIZE", None)
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.set(512)
    try:
        cols, vis = _columns(6000, 7)
        jsft = JSFT.from_spec("fq", SPEC)
        jt = JTable.build(jsft, cols, visibilities=vis)
        jp = JPlanner(jsft, jt, [JZ3(jsft, jt)])
        tsft = TSFT.from_spec("fq", SPEC)
        tt = TTable.build(tsft, cols, visibilities=vis)
        tp = TPlanner(tsft, tt, [TZ3(tsft, tt, "cpu")])
    finally:
        for c in (jconfig, tconfig):
            c.PRUNE_BLOCK.unset()
    return jp, tp, vis


def visible(vis, auths):
    """The numpy oracle's own evaluation of each row's expression."""
    if auths is None:
        return np.ones(len(vis), dtype=bool)
    return np.asarray([tsec.evaluate(v, auths) for v in vis], dtype=bool)


# -- the expression grammar (the copied module) -------------------------------


@pytest.mark.parametrize("expr", [
    "", "admin", "admin&ops", "admin|ops", "admin&(user|ops)",
    '"a b"&x', "(a|b)&(c|d)", "a|(b&(c|d))", "x.y:z/w+1"])
@pytest.mark.parametrize("auths", [[], ["admin"], ["admin", "ops"],
                                   ["a b", "x"], ["a", "d"], ["b", "c"]])
def test_evaluate_equal_reference(expr, auths):
    assert tsec.evaluate(expr, auths) == jsec.evaluate(expr, auths)
    assert tsec.parse_visibility(expr) == jsec.parse_visibility(expr)


@pytest.mark.parametrize("bad", ["a&b|c", "a&(b", "&a", "a b", "(a))"])
def test_malformed_raises_as_reference(bad):
    with pytest.raises(jsec.VisibilityError):
        jsec.parse_visibility(bad)
    with pytest.raises(tsec.VisibilityError):
        tsec.parse_visibility(bad)


def test_allowed_codes_equal_reference():
    vocab = ["", "admin", "admin&ops", "user|ops"]
    for auths in ([], ["admin"], ["admin", "ops"], ["user"]):
        got = tsec.allowed_codes(vocab, auths)
        assert got.dtype == np.int32
        assert np.array_equal(got, jsec.allowed_codes(vocab, auths))
    assert tsec.AuthorizationsProvider(["a"]).get_authorizations() == ["a"]


def test_table_visibility_column_equal_reference():
    cols, vis = _columns(300, 3)
    jt = JTable.build(JSFT.from_spec("t", SPEC), cols, visibilities=vis)
    tt = TTable.build(TSFT.from_spec("t", SPEC), cols, visibilities=vis)
    assert tt.visibility.vocab == jt.visibility.vocab
    assert np.array_equal(tt.visibility.codes, jt.visibility.codes)
    idx = np.array([5, 1, 299, 5])
    assert np.array_equal(tt.take(idx).visibility.codes,
                          jt.take(idx).visibility.codes)
    plain = TTable.build(TSFT.from_spec("t", SPEC), _columns(10, 4)[0])
    jplain = JTable.build(JSFT.from_spec("t", SPEC), _columns(10, 4)[0])
    for parts in ((tt, plain), (plain, tt)):
        jparts = tuple(jt if p is tt else jplain for p in parts)
        got = TTable.concat(list(parts)).visibility
        want = JTable.concat(list(jparts)).visibility
        assert got.vocab == want.vocab
        assert np.array_equal(got.codes, want.codes)
    with pytest.raises(ValueError, match="visibilities"):
        TTable.build(TSFT.from_spec("t", SPEC), cols, visibilities=vis[:5])


def test_device_vis_plane_equal_reference(world):
    jp, tp, _ = world
    want = np.asarray(jp.indexes[0].device.columns["__vis__"])
    got = tp.indexes[0].device.columns["__vis__"].numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize("route", ["native", "streamed", "numpy"])
def test_every_build_route_carries_the_vis_plane(world, route):
    """The native one-shot build, the streamed build (chunks of 1,000
    rows) and the numpy build all gather the ``__vis__`` plane into index
    order, equal to the reference's, and answer under auths alike."""
    jp, tp, vis = world
    cols, _ = _columns(6000, 7)
    try:
        if route == "streamed":
            tconfig.BUILD_STREAM_CHUNK.set(1000)
        elif route == "numpy":
            tconfig.NO_NATIVE.set(True)
        tsft = TSFT.from_spec("fq", SPEC)
        tt = TTable.build(tsft, cols, visibilities=vis)
        idx = TZ3(tsft, tt, "cpu")
    finally:
        tconfig.BUILD_STREAM_CHUNK.unset()
        tconfig.NO_NATIVE.unset()
    want = np.asarray(jp.indexes[0].device.columns["__vis__"])
    assert np.array_equal(idx.device.columns["__vis__"].numpy(), want)
    assert ("encode_upload_overlap_s" in idx.build_stages) \
        == (route == "streamed")
    p = TPlanner(tsft, tt, [idx])
    q = f"{BOX} AND {DURING}"
    assert p.count(q, auths=["ops"]) == jp.count(q, auths=["ops"])


# -- the planner under auths ---------------------------------------------------


@pytest.mark.parametrize("auths", AUTHS, ids=str)
@pytest.mark.parametrize("q", QUERIES)
def test_count_and_select_equal_reference_and_oracle(world, q, auths):
    jp, tp, vis = world
    want_rows = jp.select_indices(q, auths=auths)
    rows = tp.select_indices(q, auths=auths)
    assert np.array_equal(rows, want_rows)
    assert tp.count(q, auths=auths) == jp.count(q, auths=auths) == len(rows)
    everything = tp.select_indices(q)
    oracle = everything[visible(vis, auths)[everything]]
    assert np.array_equal(rows, oracle)


def test_fused_programs_carry_the_vis_section(world):
    jp, tp, vis = world
    plan = tp._apply_auths(tp.plan(f"{BOX} AND {DURING}"), ["admin"])
    assert plan.residual_device.key.startswith("vis")
    prog = tcompiled._from_plan(plan, "count")
    assert prog is not None and prog.query.vis
    allowed = tsec.allowed_codes(tp.table.visibility.vocab, ["admin"])
    words = prog.query.section(prog.qbuf, "vis", torch.int32, 1).reshape(-1)
    member = tscan.vis_member(torch.arange(-2, 70, dtype=torch.int32),
                              words).numpy()
    assert np.array_equal(np.flatnonzero(member) - 2, allowed)
    # every expression allowed: no section; none allowed: an empty plan
    every = sorted({t for e in EXPRS for t in ("admin", "ops", "user",
                                                "a b", "x")})
    full = tp._apply_auths(tp.plan(BOX), every)
    assert full.residual_device is None and not full.empty
    assert full.explain["__vis_applied__"]


def test_count_without_residual_is_one_fused_scan(world, monkeypatch):
    """A staged count that gains only the visibility term runs as one
    ``fused_scan`` count (not ``box_count``); per-box counts keep
    ``box_count`` behind a boxless ``fused_scan`` mask with ``vis``."""
    jp, tp, vis = world
    from geomesa_tpu_torch.kernels import box_count as kbox
    from geomesa_tpu_torch.kernels import fused_scan as kfs
    seen = []
    real = kfs.fused_scan

    def spy(cols, qbuf, query, *a):
        seen.append((query.vis, query.points))
        return real(cols, qbuf, query, *a)
    monkeypatch.setattr(kfs, "fused_scan", spy)
    monkeypatch.setattr(kbox, "box_count",
                        lambda *a, **k: pytest.fail("box_count launched"))
    plan = tp._apply_auths(tp.plan(DURING), ["ops"])
    k = plan.index.kernels
    got = k.count(plan.primary_kind, plan.boxes_loose, plan.windows,
                  plan.residual_device)
    assert seen == [(True, False)]
    assert got == jp.count(DURING, auths=["ops"])
    monkeypatch.undo()
    boxes = tp.plan(BOX).boxes_loose
    got = k.counts_multi("point_boxes", np.concatenate([boxes, boxes]),
                         None, plan.residual_device)
    want = jp.indexes[0].kernels.counts_multi(
        "point_boxes", np.concatenate([boxes, boxes]), None,
        jp._apply_auths(jp.plan(DURING), ["ops"]).residual_device)
    assert np.array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("auths", [["admin"], [], ["user", "admin"]],
                         ids=str)
def test_prepared_and_recipe_cache_keyed_by_auths(world, auths):
    jp, tp, vis = world
    tpl = "BBOX(geom,{x0},-30,{x1},30) AND " + DURING
    for x0, x1 in ((-60, 60), (-50, 10), (-20, 70)):
        q = tpl.format(x0=x0, x1=x1)
        want = jp.prepare(q, auths=auths).count()
        assert tp.prepare(q, auths=auths).count() == want
        assert tp.prepare(q).count() == jp.prepare(q).count()
    # the third shape bound through the recipe, under these auths
    hits = tcompiled.STATS["shape_hits"]
    q = tpl.format(x0=-40, x1=40)
    fp = tp.prepare(q, auths=auths)
    assert isinstance(fp, tcompiled.FusedPrepared)
    assert tcompiled.STATS["shape_hits"] > hits
    assert fp.count() == jp.count(q, auths=auths)
    keys = {k[1] for k in tcompiled._recipes(tp)._d}
    assert tcompiled._auths_key(auths) in keys


def test_reused_plan_refolds_under_other_auths(world):
    """The ``__vis_applied__`` mark lives on the folded copy: a plan
    reused under other auths folds again, and the original never
    skips its fold (the reference's leak guard)."""
    jp, tp, vis = world
    q = f"{BOX} AND {DURING}"
    plan = tp.plan(q)
    for auths in (["admin", "ops"], [], ["admin", "ops"], ["user"]):
        folded = tp._apply_auths(plan, auths)
        assert "__vis_applied__" not in plan.explain
        assert tp._apply_auths(folded, ["admin", "ops", "user", "x"]) \
            is folded
        assert tp._count(folded, q, auths) == jp.count(q, auths=auths)
    pq = tp.prepare(q, auths=["admin"])
    assert pq.count() == jp.count(q, auths=["admin"])
    assert tp.prepare(q, auths=[]).count() == jp.count(q, auths=[])
    # a union plan object reused: every execution folds
    union = tp.plan("BBOX(geom,-50,-50,0,50) OR BBOX(geom,0,-50,50,50)")
    assert isinstance(union, UnionScanPlan)
    want = jp.count("BBOX(geom,-50,-50,0,50) OR BBOX(geom,0,-50,50,50)",
                    auths=["admin"])
    for _ in range(3):
        assert tp._count(union, None, ["admin"]) == want


def test_union_under_auths_that_allow_nothing_is_empty():
    """A vocabulary without the public expression and auths that allow
    none of it: every branch of an OR drops out, so the union counts and
    selects nothing (the numpy oracle; the union program's drop-out rule
    is the reference's, ``geomesa_tpu/index/compiled.py:1089-1092``)."""
    cols, _ = _columns(3000, 9)
    vis = np.random.default_rng(9).choice(["admin", "ops"], 3000)
    tsft = TSFT.from_spec("u", SPEC)
    tt = TTable.build(tsft, cols, visibilities=vis)
    tconfig.PRUNE_BLOCK.set(512)
    tp = TPlanner(tsft, tt, [TZ3(tsft, tt, "cpu")])
    q = "BBOX(geom,-60,-30,0,0) OR BBOX(geom,-10,-10,60,30)"
    assert tp.count(q, auths=["nobody"]) == 0
    assert len(tp.select_indices(q, auths=["nobody"])) == 0
    _, mask = tp.scan_mask(q, auths=["nobody"])
    assert mask is not None and not bool(mask.any())
    assert tp.count(q, auths=["ops"]) == int(
        (visible(vis, ["ops"])[tp.select_indices(q)]).sum())


# -- density under auths -------------------------------------------------------


@pytest.mark.parametrize("auths", [["admin"], ["admin", "ops"], []],
                         ids=str)
@pytest.mark.parametrize("q", [f"{BOX} AND {DURING}", DURING,
                               "BBOX(geom,-60,-30,0,0) OR "
                               "BBOX(geom,-10,-10,60,30)"])
def test_density_equal_reference(world, q, auths):
    jp, tp, vis = world
    bbox = (-60.0, -30.0, 60.0, 30.0)
    got = tdensity.density(tp, q, bbox, 16, 8, auths=auths).weights
    want = jdensity.density(jp, q, bbox, 16, 8, auths=auths).weights
    assert np.array_equal(got, np.asarray(want))
    assert got.sum() == len(tp.select_indices(
        q + " AND BBOX(geom,-60,-30,59.999999,29.999999)", auths=auths))
    grid = tdensity.density(tp, DURING, bbox, 16, 8, "age", auths=auths)
    ref = jdensity.density(jp, DURING, bbox, 16, 8, "age", auths=auths)
    assert np.allclose(grid.weights, np.asarray(ref.weights), rtol=0,
                       atol=1e-3)


def test_fused_density_program_under_auths(world):
    jp, tp, vis = world
    q = f"{BOX} AND {DURING}"
    plan = tp._apply_auths(tp.plan(q), ["admin"])
    jplan = jp._apply_auths(jp.plan(q), ["admin"])
    got = tcompiled.try_density(tp, plan, (-60, -30, 60, 30), 32, 32)
    want = jcompiled.try_density(jp, jplan, (-60, -30, 60, 30), 32, 32)
    assert got is not None and want is not None
    assert np.array_equal(got[0], np.asarray(want[0]))
    assert got[1] == int(want[1])


# -- the store: writer, delta tier, flush, scheduler ----------------------------


def _stores():
    return TpuDataStore(), DataStoreFinder.get_data_store(type="torch",
                                                          device="cpu")


def test_writer_vis_roundtrip_equal_reference():
    out = []
    for store in _stores():
        store.create_schema("w", "v:Int,*geom:Point")
        with store.get_writer("w") as w:
            w.write(v=1, geom=(0.0, 0.0))
            w.write(v=2, geom=(1.0, 1.0), vis="secret")
        out.append([store.count("w"), store.count("w", auths=[]),
                    store.count("w", auths=["secret"])])
    assert out[0] == out[1] == [2, 1, 2]


def test_delta_and_growing_vocabulary_flush_equal_reference():
    """A labelled main table, appends into the delta tier under new and old
    expressions (counted and selected under auths inline), then a flush
    through the merge build whose visibility vocabulary grew: the stale
    ``__vis__`` plane rebuilds, and every answer stays the reference's."""
    js, ts = _stores()
    cols, vis = _columns(6000, 11)
    lsm = "age:Int,dtg:Date,*geom:Point;geomesa.z3.interval=week"
    keep = {k: cols[k] for k in ("age", "dtg", "geom")}
    for store, tbl, sft_cls in ((js, JTable, JSFT), (ts, TTable, TSFT)):
        store.create_schema("t", lsm)
        store.load("t", tbl.build(store.get_schema("t"), keep,
                                  visibilities=vis[:6000]))
    rng = np.random.default_rng(12)
    extra = ["", "admin", "brand|new", "newer&admin"]
    parts = []
    for k in range(3):
        c, _ = _columns(300, 20 + k)
        v = rng.choice(extra, 300)
        parts.append((c, v))
        for store, tbl in ((js, JTable), (ts, TTable)):
            store.load("t", tbl.build(store.get_schema("t"),
                                      {x: c[x] for x in ("age", "dtg",
                                                         "geom")},
                                      visibilities=v))
    assert ts.deltas["t"] is not None and len(ts.deltas["t"]) == 900
    qs = [f"{BOX} AND {DURING}", "age > 40", "INCLUDE"]
    auth_sets = [None, [], ["admin"], ["brand"], ["newer", "admin"]]

    def same():
        for q in qs:
            for a in auth_sets:
                assert ts.count("t", q, auths=a) == js.count("t", q,
                                                             auths=a), (q, a)
                jr = js.query("t", q, auths=a)
                tr = ts.query("t", q, auths=a)
                assert np.array_equal(tr.indices, jr.indices), (q, a)
    same()
    ts.flush("t")
    js.flush("t")
    idx = ts.planners["t"].indexes[0]
    assert idx.build_stages.get("merge_stale_cols") == ["__vis__"]
    want = np.asarray(js.planners["t"].indexes[0].device.columns["__vis__"])
    assert np.array_equal(idx.device.columns["__vis__"].numpy(), want)
    same()


def test_unlabelled_table_gains_labels_on_flush():
    js, ts = _stores()
    cols, _ = _columns(6000, 13)
    lsm = "age:Int,dtg:Date,*geom:Point;geomesa.z3.interval=week"
    keep = {k: cols[k] for k in ("age", "dtg", "geom")}
    add, _ = _columns(200, 14)
    add = {k: add[k] for k in ("age", "dtg", "geom")}
    v = np.random.default_rng(1).choice(["", "admin"], 200)
    for store, tbl in ((js, JTable), (ts, TTable)):
        store.create_schema("t", lsm)
        store.load("t", tbl.build(store.get_schema("t"), keep))
        store.load("t", tbl.build(store.get_schema("t"), add,
                                  visibilities=v))
        store.flush("t")
    assert "__vis__" in ts.planners["t"].indexes[0].device.columns
    for a in (None, [], ["admin"]):
        assert ts.count("t", "INCLUDE", auths=a) \
            == js.count("t", "INCLUDE", auths=a) \
            == 6000 + (200 if a == ["admin"] or a is None
                       else int((v == "").sum()))


def test_scheduler_plan_cache_keyed_by_auths():
    _, ts = _stores()
    ts.create_schema("sec", "name:String,v:Int,dtg:Date,*geom:Point")
    rng = np.random.default_rng(6)
    n = 3000
    base = np.datetime64("2024-01-01", "ms").astype(np.int64)
    vis = rng.choice(["", "admin", "admin&ops", "user|ops"], n,
                     p=[0.4, 0.3, 0.2, 0.1])
    ts.load("sec", TTable.build(ts.get_schema("sec"), {
        "name": rng.choice(["a", "b"], n).astype(object),
        "v": rng.integers(0, 100, n).astype(np.int32),
        "dtg": base + rng.integers(0, 86400000, n),
        "geom": (rng.uniform(-50, 50, n), rng.uniform(-50, 50, n))},
        visibilities=vis))
    sched = ts.scheduler()
    q = "BBOX(geom, -50, -50, 50, 50)"
    expect = {tuple(a): int(visible(vis, list(a)).sum())
              for a in ((), ("admin",), ("admin", "ops"))}
    try:
        for _ in range(3):
            for auths, want in expect.items():
                assert sched.count("sec", q, auths=list(auths)) == want
        assert sched.count("sec", q) == n
        assert sched.plans.stats()["hits"] >= 4
        keys = {k[-1] for k in sched.plans._d}
        assert {(), ("admin",), ("admin", "ops"), None} <= keys
        got = ts.count_many("sec", [q, "v < 50", q], auths=["admin"])
        assert got == [ts.count("sec", f, auths=["admin"])
                       for f in (q, "v < 50", q)]
    finally:
        ts.close()


@pytest.fixture(scope="module")
def extent_stores():
    from geomesa_tpu.features.geometry import GeometryArray as JG

    from geomesa_tpu_torch.features.geometry import GeometryArray as TG
    rng = np.random.default_rng(3)
    n = 20_000
    a = rng.uniform(-50, 50, (n, 2))
    b = a + rng.uniform(-2, 2, (n, 2))
    coords = np.stack([a, b], 1).reshape(-1, 2)
    vis = rng.choice(["", "admin", "ops|user"], n)
    v = rng.integers(0, 9, n).astype(np.int32)
    out = []
    for store, tbl, geo in ((TpuDataStore(), JTable, JG),
                            (DataStoreFinder.get_data_store(
                                type="torch", device="cpu"), TTable, TG)):
        store.create_schema("osm", "*geom:LineString,v:Int")
        store.load("osm", tbl.build(store.get_schema("osm"),
                                    {"geom": geo.linestrings(coords),
                                     "v": v}, visibilities=vis))
        out.append(store)
    return out


@pytest.mark.parametrize("q", [
    "INTERSECTS(geom, POLYGON ((-12 30, 10 28, 14 44, -2 50, -12 30)))",
    "BBOX(geom,-12,28,14,50)", "BBOX(geom,-12,28,14,50) AND v > 3"])
@pytest.mark.parametrize("auths", [None, [], ["admin"], ["ops"]], ids=str)
def test_extent_layer_under_auths_equals_reference(extent_stores, q, auths):
    """An XZ2 line layer's envelope stages keep the torch ops: the
    visibility test ANDs into their residual there (the band count, the
    box count and rows), as the reference's residual function does."""
    js, ts = extent_stores
    assert ts.count("osm", q, auths=auths) == js.count("osm", q, auths=auths)
    assert np.array_equal(ts.query("osm", q, auths=auths).indices,
                          js.query("osm", q, auths=auths).indices)
