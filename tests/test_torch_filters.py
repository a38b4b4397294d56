"""The point layer's remaining filters in the port (geomesa_tpu_torch)
against the JAX package on identical inputs: WKT literals of every type,
the host geometry predicates (``filter.geom_numpy``, ``filter.geom_batch``,
``geom.oracle``, ``geom.functions``) on the inputs of the reference's own
``tests/test_geom_batch.py`` and ``tests/test_filter.py`` restricted to
point features, and WITHIN, CONTAINS, DWITHIN, IS NULL and MULTIPOLYGON
literals through both planners (fused and staged), count and ascending
rows. Tolerance: none — every mask, distance, count and row id is compared
exactly. The port runs with device="cpu" (its kernels' plain versions)."""

import numpy as np
import pytest

from geomesa_tpu import config as jconfig
from geomesa_tpu.features import geometry as jgeo
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.features.table import FeatureTable as JTable
from geomesa_tpu.filter import geom_batch as jgb
from geomesa_tpu.filter import geom_numpy as jgn
from geomesa_tpu.filter.evaluate import evaluate as jevaluate
from geomesa_tpu.filter.parser import parse_ecql as jparse
from geomesa_tpu.geom import functions as jfunctions
from geomesa_tpu.geom import oracle as joracle
from geomesa_tpu.index.planner import QueryPlanner as JPlanner
from geomesa_tpu.index.spatial import Z3Index as JZ3
from geomesa_tpu_torch import config as tconfig
from geomesa_tpu_torch.features import geometry as tgeo
from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.filter import geom_batch as tgb
from geomesa_tpu_torch.filter import geom_numpy as tgn
from geomesa_tpu_torch.filter.evaluate import evaluate as tevaluate
from geomesa_tpu_torch.filter.parser import parse_ecql as tparse
from geomesa_tpu_torch.geom import functions as tfunctions
from geomesa_tpu_torch.geom import oracle as toracle
from geomesa_tpu_torch.index.planner import QueryPlanner as TPlanner
from geomesa_tpu_torch.index.spatial import Z3Index as TZ3

WKTS = [
    "POINT (1.5 -2.25)",
    "LINESTRING (0 0, 10 10, 20 5)",
    "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0), (4 4, 6 4, 6 6, 4 6, 4 4))",
    "MULTIPOINT ((1 2), (3 4))",
    "MULTIPOINT (1 2, 3 4)",
    "MULTILINESTRING ((0 0, 1 1), (2 2, 3 3, 4 2))",
    "MULTIPOLYGON (((0 0, 4 0, 4 4, 0 0)), ((10 10, 14 10, 14 14, 10 10),"
    " (11 11, 12 11, 12 12, 11 11)))",
    "polygon((-10 20, 40 20, 40 60, -10 60, 15 40, -10 20))",
]

# the literals of tests/test_geom_batch.py: a polygon with a hole, a
# linestring, a point, a multipolygon and a multipoint
LITERALS = [
    (3, [[[-20, -20], [20, -20], [20, 20], [-20, 20], [-20, -20]],
         [[-5, -5], [5, -5], [5, 5], [-5, 5], [-5, -5]]]),
    (2, [[-30, -30], [0, 0], [30, 25]]),
    (1, [0.0, 0.0]),
    (6, [[[[-15, -15], [-1, -15], [-1, -1], [-15, -1], [-15, -15]]],
         [[[1, 1], [15, 1], [15, 15], [1, 15], [1, 1]]]]),
    (4, [[2.0, 2.0], [-40.0, -40.0]]),
]
POLYGONAL = [0, 3]


def _points(seed=42, n=400):
    """Uniform points over [-50, 50]² plus points exactly on the literals'
    vertices, on their segments' midpoints and just off them."""
    rng = np.random.default_rng(seed)
    xs = [rng.uniform(-50, 50, n)]
    ys = [rng.uniform(-50, 50, n)]
    for lit in LITERALS:
        c = jgn.literal_coords(lit)
        xs.append(c[:, 0])
        ys.append(c[:, 1])
        s = jgn.literal_segments(lit)
        if len(s):
            mx, my = (s[:, 0] + s[:, 2]) / 2, (s[:, 1] + s[:, 3]) / 2
            xs += [mx, mx + 1e-9]
            ys += [my, my - 1e-9]
    return np.concatenate(xs), np.concatenate(ys)


@pytest.fixture(scope="module")
def arrays():
    x, y = _points()
    return jgeo.GeometryArray.points(x, y), tgeo.GeometryArray.points(x, y)


# -- WKT literals --------------------------------------------------------------


@pytest.mark.parametrize("wkt", WKTS)
def test_wkt_literal_equals_reference(wkt):
    assert tgeo.parse_wkt(wkt) == jgeo.parse_wkt(wkt)


@pytest.mark.parametrize("wkt", WKTS[1:])
def test_ecql_literal_equals_reference(wkt):
    q = f"INTERSECTS(geom, {wkt})"
    assert tparse(q).geometry == jparse(q).geometry


def test_bad_wkt_raises_value_error_in_both():
    for parse in (tgeo.parse_wkt, jgeo.parse_wkt):
        with pytest.raises(ValueError):
            parse("CIRCLE (0 0, 1)")


# -- geom_numpy ----------------------------------------------------------------


@pytest.mark.parametrize("li", range(len(LITERALS)))
def test_literal_views_equal_reference(li):
    lit = LITERALS[li]
    assert np.array_equal(tgn.literal_segments(lit), jgn.literal_segments(lit))
    assert np.array_equal(tgn.literal_coords(lit), jgn.literal_coords(lit))
    assert tgn.literal_bbox(lit) == jgn.literal_bbox(lit)


@pytest.mark.parametrize("li", range(len(LITERALS)))
def test_geom_numpy_predicates_equal_reference(arrays, li):
    jarr, tarr = arrays
    lit = LITERALS[li]
    x, y = tarr.point_xy()
    segs = jgn.literal_segments(lit)
    assert np.array_equal(tgn.point_segment_distance(x, y, segs),
                          jgn.point_segment_distance(x, y, segs))
    assert np.array_equal(tgn._points_on_segments(x, y, segs),
                          jgn._points_on_segments(x, y, segs))
    if li in POLYGONAL:
        assert np.array_equal(tgn.points_in_polygon(x, y, lit),
                              jgn.points_in_polygon(x, y, lit))
    for i in range(0, len(tarr), 7):
        assert tgn.geometry_intersects(tarr, i, lit) \
            == jgn.geometry_intersects(jarr, i, lit)
        assert tgn.geometry_distance(tarr, i, lit) \
            == jgn.geometry_distance(jarr, i, lit)


def test_segments_cross_equals_reference():
    rng = np.random.default_rng(5)
    for _ in range(50):
        a = rng.integers(-3, 4, (3, 4)).astype(np.float64)
        b = rng.integers(-3, 4, (2, 4)).astype(np.float64)
        assert tgn.segments_cross(a, b) == jgn.segments_cross(a, b)


# -- geom_batch and oracle -----------------------------------------------------


@pytest.mark.parametrize("li", range(len(LITERALS)))
def test_batch_predicates_equal_reference(arrays, li):
    jarr, tarr = arrays
    lit = LITERALS[li]
    idx = np.arange(len(tarr))
    assert np.array_equal(tgb.batch_intersects(tarr, idx, lit),
                          jgb.batch_intersects(jarr, idx, lit))
    assert np.array_equal(tgb.batch_distance(tarr, idx, lit),
                          jgb.batch_distance(jarr, idx, lit))
    if li in POLYGONAL:
        assert np.array_equal(tgb.batch_within(tarr, idx, lit),
                              jgb.batch_within(jarr, idx, lit))


def test_batch_subset_duplicates_and_empty(arrays):
    jarr, tarr = arrays
    lit = LITERALS[0]
    idx = np.array([5, 17, 203, 5], dtype=np.int64)
    assert np.array_equal(tgb.batch_intersects(tarr, idx, lit),
                          jgb.batch_intersects(jarr, idx, lit))
    empty = np.empty(0, np.int64)
    for fn in (tgb.batch_intersects, tgb.batch_within, tgb.batch_distance):
        assert fn(tarr, empty, lit).shape == (0,)


def test_batch_chunking_is_exact(arrays, monkeypatch):
    jarr, tarr = arrays
    idx = np.arange(len(tarr))
    want = [jgb.batch_distance(jarr, idx, lit) for lit in LITERALS]
    monkeypatch.setattr(tgb, "_CHUNK", 7)
    for lit, w in zip(LITERALS, want):
        assert np.array_equal(tgb.batch_distance(tarr, idx, lit), w)


@pytest.mark.parametrize("li", range(len(LITERALS)))
def test_oracle_equals_reference(arrays, li):
    jarr, tarr = arrays
    lit = LITERALS[li]
    rows = np.arange(0, len(tarr), 3)
    for name in ("distance", "intersects", "contains_literal",
                 "feature_contains"):
        got = getattr(toracle, name)(tarr, rows, lit)
        want = getattr(joracle, name)(jarr, rows, lit)
        assert np.array_equal(got, want), name
    assert np.array_equal(toracle.area(tarr, rows), joracle.area(jarr, rows))
    assert np.array_equal(toracle.length(tarr, rows),
                          joracle.length(jarr, rows))
    for g, w in zip(toracle.centroid(tarr, rows),
                    joracle.centroid(jarr, rows)):
        assert np.array_equal(g, w)


def test_feature_contains_coincident_point(arrays):
    jarr, tarr = arrays
    x, y = tarr.point_xy()
    lit = (tgeo.POINT, [float(x[9]), float(y[9])])
    rows = np.arange(len(tarr))
    got = toracle.feature_contains(tarr, rows, lit)
    assert got[9] and np.array_equal(
        got, joracle.feature_contains(jarr, rows, lit))


# -- functions: the st_* filter nodes ------------------------------------------

SPEC = ("name:String,val:Int,score:Float,dtg:Date,*geom:Point;"
        "geomesa.z3.interval=week")

FUNC_FILTERS = [
    "st_distance(geom, POINT(10 10)) < 15",
    "st_distance(POINT(10 10), geom) <= 15",
    "st_distance(geom, POLYGON((0 0, 20 0, 20 20, 0 20, 0 0))) < 4",
    "st_distance(geom, LINESTRING(-30 -30, 30 25)) <= 2",
    "st_distance(geom, st_centroid(geom)) = 0",
    "st_contains(POLYGON((-40 -30, 20 -30, 20 20, -40 20, -40 -30)), geom)",
    "st_contains(LINESTRING(-30 -30, 0 0, 30 30), geom)",
    "st_contains(geom, POINT(3 4))",
    "st_intersects(geom, POLYGON((0 0, 60 0, 30 50, 0 0)))",
    "st_intersects(POLYGON((0 0, 60 0, 30 50, 0 0)), geom)",
    "st_intersects(geom, MULTIPOLYGON(((-15 -15, -1 -15, -1 -1, -15 -1,"
    " -15 -15)), ((1 1, 15 1, 15 15, 1 15, 1 1))))",
    "st_intersects(geom, st_centroid(geom))",
    "st_area(geom) > 0",
    "st_length(geom) = 0",
    "st_distance(geom, POINT(10 10)) > 40 AND val < 50",
]


def _columns(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-170, 170, n)
    y = rng.uniform(-80, 80, n)
    # exact hits for the equality predicates
    x[:3], y[:3] = (3.0, 10.0, 0.0), (4.0, 10.0, 0.0)
    base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
    score = rng.uniform(0, 1, n).astype(np.float32)
    score[rng.random(n) < 0.1] = np.nan
    return {"name": rng.choice(["alpha", "", "beta", "gamma"], n),
            "val": rng.integers(0, 100, n).astype(np.int32),
            "score": score,
            "dtg": base + rng.integers(0, 30 * 86400000, n),
            "geom": (x, y)}


def _tables(n=6000, seed=7):
    cols = _columns(n, seed)
    jsft = JSFT.from_spec("pf", SPEC)
    tsft = TSFT.from_spec("pf", SPEC)
    return (jsft, JTable.build(jsft, cols)), (tsft, TTable.build(tsft, cols))


@pytest.fixture(scope="module")
def world():
    jconfig.PRUNE_BLOCK.set(512)
    tconfig.PRUNE_BLOCK.set(512)
    try:
        (jsft, jt), (tsft, tt) = _tables()
        return (JPlanner(jsft, jt, [JZ3(jsft, jt)]),
                TPlanner(tsft, tt, [TZ3(tsft, tt, "cpu")]))
    finally:
        jconfig.PRUNE_BLOCK.unset()
        tconfig.PRUNE_BLOCK.unset()


@pytest.fixture(autouse=True)
def _small_blocks():
    from geomesa_tpu.index import prune
    vars(prune).pop("BLOCK_SIZE", None)
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.set(512)
    yield
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.unset()
        c.FUSED_QUERY.unset()


@pytest.mark.parametrize("q", FUNC_FILTERS)
def test_func_filter_mask_equals_reference(world, q):
    jp, tp = world
    rows = np.arange(0, len(tp.table), 2)
    jf, tf = jparse(q), tparse(q)
    want = jevaluate(jf, jp.table)
    assert np.array_equal(tevaluate(tf, tp.table), want)
    node = tf.children[0] if hasattr(tf, "children") else tf
    jnode = jf.children[0] if hasattr(jf, "children") else jf
    assert np.array_equal(
        tfunctions.eval_filter_node(node, tp.table, rows, kernels=False),
        jfunctions.eval_filter_node(jnode, jp.table, rows, kernels=False))


def test_scalar_values_equal_reference(world):
    jp, tp = world
    rows = np.arange(0, len(tp.table), 5)
    lit = (1, [10.0, 10.0])
    for name, args in (("st_distance", ("geom", lit)),
                       ("st_distance", (lit, "geom")),
                       ("st_area", ("geom",)), ("st_length", ("geom",))):
        assert np.array_equal(
            tfunctions.scalar_values(tp.table, rows, name, args),
            jfunctions.scalar_values(jp.table, rows, name, args))


@pytest.mark.parametrize("q", [
    "st_area(st_buffer(geom, 2.0)) > 10",
    "st_length(st_convexHull(st_buffer(geom, 1.0))) > 5",
    "st_area(POLYGON((0 0, 1 0, 1 1, 0 0))) > 0",
])
def test_catalog_shapes_raise_naming_roadmap(world, q):
    """``st_buffer``, ``st_convexHull`` and non-point literals, once refused
    naming item 13, take the reference's routes: counts and rows equal the
    reference's (the planner's through the device catalog,
    GEOMESA_TPU_GEOM_KERNELS; the evaluator's through the host oracle)."""
    jp, tp = world
    assert tp.count(q) == jp.count(q)
    assert np.array_equal(np.sort(tp.select_indices(q)),
                          np.sort(jp.select_indices(q)))
    jf, tf = jparse(q), tparse(q)
    assert np.array_equal(tevaluate(tf, tp.table),
                          jevaluate(jf, jp.table))


# -- the evaluator on tests/test_filter.py's point inputs ----------------------


@pytest.mark.parametrize("xs,ys,q", [
    ([1.0, 5.0, 2.0], [1.0, 5.0, 0.5],
     "INTERSECTS(geom, POLYGON ((0 0, 4 0, 0 4, 0 0)))"),
    ([5.0, 1.0], [5.0, 1.0], "INTERSECTS(geom, POLYGON ((0 0, 10 0, 10 10, "
                             "0 10, 0 0), (4 4, 6 4, 6 6, 4 6, 4 4)))"),
    ([0.0, 3.0], [0.0, 0.0], "DWITHIN(geom, LINESTRING (1 -1, 1 1), 1.5, "
                             "degrees)"),
    ([1.0, 1.4, 2.0], [2.0, 2.3, 2.0], "DWITHIN(geom, POINT (1 2), 0.5, "
                                       "degrees)"),
    ([3.0, 8.0, 20.0], [3.0, 2.0, 20.0],
     "WITHIN(geom, POLYGON ((2 2, 8 2, 8 8, 2 8, 2 2)))"),
    ([3.0, 8.0, 20.0], [3.0, 2.0, 20.0],
     "CONTAINS(geom, POLYGON ((2 2, 8 2, 8 8, 2 8, 2 2)))"),
    ([0.0, 5.0, 10.0], [0.0, 5.0, 0.0],
     "INTERSECTS(geom, LINESTRING (0 0, 10 10))"),
    ([1.0, 2.0], [2.0, 2.0], "INTERSECTS(geom, MULTIPOINT ((1 2), (3 4)))"),
    ([1.0, 2.0, 12.5], [2.0, 2.0, 12.5],
     "WITHIN(geom, MULTIPOLYGON (((0 0, 4 0, 4 4, 0 0)), ((10 10, 14 10,"
     " 14 14, 10 10))))"),
])
def test_evaluate_equals_reference(xs, ys, q):
    spec = "*geom:Point"
    cols = {"geom": (np.array(xs), np.array(ys))}
    jt = JTable.build(JSFT.from_spec("t", spec), cols)
    tt = TTable.build(TSFT.from_spec("t", spec), cols)
    want = jevaluate(jparse(q), jt)
    assert np.array_equal(tevaluate(tparse(q), tt), want)


# -- WITHIN, CONTAINS, DWITHIN, IS NULL, MULTIPOLYGON through both planners ----

DURING = "dtg DURING 2020-01-03T00:00:00Z/2020-01-15T00:00:00Z"
POLY = "POLYGON((-10 20, 40 20, 40 60, -10 60, 15 40, -10 20))"
MULTI = ("MULTIPOLYGON(((-60 -30, -20 -30, -20 10, -60 -30)),"
         " ((20 20, 60 20, 60 50, 20 50, 20 20), (30 30, 40 30, 40 40,"
         " 30 40, 30 30)))")

PLANNER_FILTERS = [
    f"WITHIN(geom, {POLY})",
    f"WITHIN(geom, {POLY}) AND {DURING}",
    f"CONTAINS(geom, {POLY}) AND val > 30",
    f"INTERSECTS(geom, {MULTI})",
    f"INTERSECTS(geom, {MULTI}) AND {DURING}",
    f"WITHIN(geom, {MULTI}) AND {DURING}",
    "DWITHIN(geom, POINT(10 45), 12, degrees)",
    f"DWITHIN(geom, POINT(10 45), 12, kilometers) AND {DURING}",
    f"DWITHIN(geom, {POLY}, 3.5, degrees) AND {DURING}",
    "DWITHIN(geom, LINESTRING(-100 -50, 100 50), 2, degrees)",
    "INTERSECTS(geom, LINESTRING(-100 -50, 100 50))",
    f"score IS NULL AND {DURING}",
    "name IS NULL",
    "BBOX(geom, -60, -30, 60, 30) AND NOT (score IS NULL)",
]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("q", PLANNER_FILTERS)
def test_planner_filter_equals_reference(world, q, fused):
    jp, tp = world
    jconfig.FUSED_QUERY.set(fused)
    tconfig.FUSED_QUERY.set(fused)
    jc, js = jp.count(q), jp.select_indices(q)
    tc, ts = tp.count(q), tp.select_indices(q)
    assert tc == jc, q
    assert ts.dtype == np.int64 and np.array_equal(ts, js), q
    host = jevaluate(jparse(q), jp.table)
    assert tc == int(host.sum()), q


def test_is_null_finds_the_nulls(world):
    jp, tp = world
    score = np.asarray(tp.table.column("score"))
    assert tp.count("score IS NULL") == int(np.isnan(score).sum()) > 0
    names = tp.table.column("name")
    empty = names.vocab.index("")
    assert tp.count("name IS NULL") == int((names.codes == empty).sum()) > 0
