"""The planner's st_* route through the device catalog, the projections and
the single-process join, against the JAX package.

The reference's planner sends every st_* part of a staged AND residual
through its device catalog when ``GEOMESA_TPU_GEOM_KERNELS`` is on (the
default; ``geomesa_tpu/index/planner.py`` ``_refine_mask``), and the
port's does the same on its planner's device:

- ``scalar_values``/``bool_values`` with ``kernels=True`` and
  ``eval_filter_node`` with ``kernels`` True, False and None under both
  settings of the knob, on ``tests/test_geom_catalog.py``'s mixed corpus:
  values and masks equal;
- counts and row sets of staged st_* queries on point (Z3), line (XZ3) and
  polygon (XZ2) layers built by both stores, under both settings, and the
  catalog's ``STATS`` they move: equal;
- rows built to sit on a threshold where the f32 catalog value and the f64
  oracle value fall on different sides (``st_length``, ``st_area``,
  ``st_distance``): with the knob on both packages answer the f32 side,
  with it off the f64 side;
- ``projection_columns`` on ``test_projection_columns_wkt_and_scalars``'s
  inputs (and st_area/st_length/st_centroid/st_buffer terms over lines and
  polygons): equal;
- ``spatial_join``, ``join_battery`` and ``func_counts`` with
  ``runtime=None`` equal the reference's; a runtime raises naming ROADMAP
  item 14.

Tolerance: none. The port runs with device="cpu" (the kernels' plain
versions).
"""

import numpy as np
import pytest

from geomesa_tpu import config as jconfig
from geomesa_tpu.datastore import TpuDataStore
from geomesa_tpu.features import geometry as jgeo
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.features.table import FeatureTable as JTable
from geomesa_tpu.filter.parser import parse_ecql as jparse
from geomesa_tpu.geom import catalog as jcat
from geomesa_tpu.geom import functions as jfunctions
from geomesa_tpu.geom import join as jjoin
from geomesa_tpu.index.planner import QueryPlanner as JPlanner
from geomesa_tpu.index.spatial import Z3Index as JZ3
from geomesa_tpu_torch import DataStoreFinder
from geomesa_tpu_torch import config as tconfig
from geomesa_tpu_torch.features import geometry as tgeo
from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.filter.parser import parse_ecql as tparse
from geomesa_tpu_torch.geom import catalog as tcat
from geomesa_tpu_torch.geom import functions as tfunctions
from geomesa_tpu_torch.geom import join as tjoin
from geomesa_tpu_torch.geom import oracle as toracle
from geomesa_tpu_torch.index.planner import QueryPlanner as TPlanner
from geomesa_tpu_torch.index.spatial import Z3Index as TZ3

from test_geom_catalog import LITERAL, _mixed_shapes

POLY_LIT = (tgeo.POLYGON, [[[-40.0, -30.0], [20.0, -30.0], [20.0, 20.0],
                            [-40.0, 20.0], [-40.0, -30.0]]])


class _knob:
    """GEOMESA_TPU_GEOM_KERNELS set in both packages (None: the default)."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        for c in (jconfig, tconfig):
            if self.on is None:
                c.GEOM_KERNELS.unset()
            else:
                c.GEOM_KERNELS.set(self.on)

    def __exit__(self, *exc):
        for c in (jconfig, tconfig):
            c.GEOM_KERNELS.unset()


def _node(f):
    return f.children[0] if hasattr(f, "children") else f


@pytest.fixture(scope="module")
def tables():
    out = {}
    for seed in (3, 11):
        shapes = _mixed_shapes(np.random.default_rng(seed))
        n = len(shapes)
        for mod, sft_cls, tbl, key in ((jgeo, JSFT, JTable, "j"),
                                       (tgeo, TSFT, TTable, "t")):
            sft = sft_cls.from_spec("mixed", "val:Int,*geom:Geometry")
            out[(seed, key)] = tbl.build(sft, {
                "val": np.arange(n, dtype=np.int32),
                "geom": mod.GeometryArray.from_shapes(shapes)})
    return out


SCALARS = [("st_area", ("geom",)), ("st_length", ("geom",)),
           ("st_distance", ("geom", LITERAL)),
           ("st_distance", ((tgeo.POINT, [10.0, 10.0]), "geom"))]
BOOLS = [("st_intersects", ("geom", LITERAL)),
         ("st_intersects", ((tgeo.POINT, [0.0, 0.0]), "geom")),
         ("st_contains", (POLY_LIT, "geom")),
         ("st_contains", ("geom", (tgeo.POINT, [10.0, 10.0])))]


@pytest.mark.parametrize("seed", [3, 11])
def test_values_with_kernels_equal_reference(tables, seed):
    jt, tt = tables[(seed, "j")], tables[(seed, "t")]
    rows = np.arange(0, len(tt), 2)
    for name, args in SCALARS:
        got = tfunctions.scalar_values(tt, rows, name, args, kernels=True,
                                       device="cpu")
        want = jfunctions.scalar_values(jt, rows, name, args, kernels=True)
        assert np.array_equal(got, want), name
    for name, args in BOOLS:
        got = tfunctions.bool_values(tt, rows, name, args, kernels=True,
                                     device="cpu")
        want = jfunctions.bool_values(jt, rows, name, args, kernels=True)
        assert np.array_equal(got, want), name


FILTERS = [
    "st_area(geom) > 1.0", "st_length(geom) >= 6", "st_length(geom) < 2",
    "st_distance(geom, POINT(10 10)) < 40",
    "st_distance(geom, POINT(-120 40)) <= 30",
    "st_intersects(geom, POLYGON((0 0, 60 0, 30 50, 0 0)))",
    "st_contains(POLYGON((-40 -30, 20 -30, 20 20, -40 20, -40 -30)), geom)",
    "st_contains(geom, POINT(10 10))",
    "st_area(st_buffer(geom, 2.0)) > 10",
]


@pytest.mark.parametrize("q", FILTERS)
@pytest.mark.parametrize("kernels", [True, False, None])
@pytest.mark.parametrize("knob", [True, False])
def test_eval_filter_node_equals_reference(tables, q, kernels, knob):
    jt, tt = tables[(3, "j")], tables[(3, "t")]
    rows = np.arange(1, len(tt), 2)
    with _knob(knob):
        for r in (None, rows):
            got = tfunctions.eval_filter_node(_node(tparse(q)), tt, r,
                                              kernels=kernels, device="cpu")
            want = jfunctions.eval_filter_node(_node(jparse(q)), jt, r,
                                               kernels=kernels)
            assert np.array_equal(got, want)


# -- the planner's route on stores of point, line and polygon layers --------


LAYERS = {
    "points": "val:Int,dtg:Date,*geom:Point;geomesa.z3.interval=week",
    "lines": "val:Int,dtg:Date,*geom:LineString;geomesa.z3.interval=week",
    "polys": "val:Int,*geom:Polygon",
}


def _layer_shapes(layer, rng):
    if layer == "points":
        return [(tgeo.POINT, [float(x), float(y)])
                for x, y in zip(rng.uniform(-170, 170, 3000),
                                rng.uniform(-80, 80, 3000))]
    code = tgeo.POLYGON if layer == "polys" else tgeo.LINESTRING
    return [s for s in _mixed_shapes(rng, 2400) if s[0] == code]


@pytest.fixture(scope="module")
def stores():
    rng = np.random.default_rng(23)
    js = TpuDataStore()
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    for layer, spec in LAYERS.items():
        shapes = _layer_shapes(layer, rng)
        n = len(shapes)
        cols = {"val": rng.integers(0, 100, n).astype(np.int32)}
        if "dtg" in spec:
            base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
            cols["dtg"] = base + rng.integers(0, 30 * 86400000, n)
        for s, mod, tbl in ((js, jgeo, JTable), (ts, tgeo, TTable)):
            s.create_schema(layer, spec)
            s.load(layer, tbl.build(s.get_schema(layer), dict(
                cols, geom=mod.GeometryArray.from_shapes(shapes))))
    return js, ts


STORE_QUERIES = FILTERS + [
    "st_area(geom) > 0.5 AND BBOX(geom, -100, -60, 100, 60)",
    "st_length(geom) > 3 AND val < 50",
    "st_distance(geom, POINT(10 10)) < 60 AND st_area(geom) < 5",
    "st_intersects(geom, POLYGON((0 0, 60 0, 30 50, 0 0))) AND "
    "dtg DURING 2020-01-05T00:00:00Z/2020-01-20T00:00:00Z",
]


@pytest.mark.parametrize("layer,q", [
    (layer, q) for layer in LAYERS for q in STORE_QUERIES
    if "dtg" not in q or "dtg" in LAYERS[layer]])
@pytest.mark.parametrize("knob", [None, False])
def test_store_route_equals_reference(stores, layer, q, knob):
    js, ts = stores
    with _knob(knob):
        j0, t0 = jcat.stats_snapshot(), tcat.stats_snapshot()
        jc, tc = js.count(layer, q), ts.count(layer, q)
        jr, tr = js.query(layer, q).indices, ts.query(layer, q).indices
        j1, t1 = jcat.stats_snapshot(), tcat.stats_snapshot()
    assert tc == jc
    assert np.array_equal(tr, jr)
    assert {k: t1[k] - t0[k] for k in t1} == {k: j1[k] - j0[k] for k in j1}


def test_route_follows_the_knob_on_the_catalog(stores):
    """With the knob on the planner's st_* refine runs the catalog (its
    STATS move), with it off the host oracle (they do not)."""
    _, ts = stores
    q = "st_area(geom) > 1.0"
    for knob, moved in ((None, True), (True, True), (False, False)):
        with _knob(knob):
            before = tcat.stats_snapshot()["unary_calls"]
            ts.count("polys", q)
            assert (tcat.stats_snapshot()["unary_calls"] > before) == moved


# -- rows on a threshold where f32 and f64 disagree --------------------------


DIST_POINT = (0.3, 0.7)


def _lines(n=4000, seed=41):
    """(2n, 2) vertices of single-segment lines of length 1.5."""
    rng = np.random.default_rng(seed)
    a = np.stack([rng.uniform(-5, 5, n), rng.uniform(-5, 5, n)], 1)
    ang = rng.uniform(0, 2 * np.pi, n)
    coords = np.empty((2 * n, 2))
    coords[0::2] = a
    coords[1::2] = a + 1.5 * np.stack([np.cos(ang), np.sin(ang)], 1)
    return coords


def _quads(n=4000, seed=43):
    """(n, 5, 2) closed axis-aligned rectangles of area near 1."""
    rng = np.random.default_rng(seed)
    c = np.stack([rng.uniform(-170, 170, n), rng.uniform(-80, 80, n)], 1)
    w = rng.uniform(0.9, 1.1, n)
    ring = np.empty((n, 5, 2))
    ring[:, 0] = ring[:, 4] = c
    ring[:, 1] = c + np.stack([w, 0 * w], 1)
    ring[:, 2] = c + np.stack([w, 1.0 / w], 1)
    ring[:, 3] = c + np.stack([0 * w, 1.0 / w], 1)
    return ring


def _polys(mod, ring):
    n = len(ring)
    lv = np.arange(n + 1, dtype=np.int64)
    return mod.GeometryArray(np.full(n, mod.POLYGON, dtype=np.int8), lv, lv,
                             5 * lv, ring.reshape(-1, 2))


def _split(v32, v64):
    """The first row whose f32 catalog value and f64 oracle value differ,
    a threshold between them, and whether the f32 value is above it."""
    k = int(np.flatnonzero(v32 != v64)[0])
    return k, float((v32[k] + v64[k]) / 2.0), bool(v32[k] > v64[k])


@pytest.mark.parametrize("kind", ["length", "area", "distance"])
def test_threshold_row_follows_the_reference_route(kind):
    """A row built to sit between its f32 catalog value and its f64 value:
    the knob on, both packages answer by the f32 value (the reference's
    route); off, by the f64 value."""
    if kind == "area":
        ring = _quads()
        geoms = [_polys(mod, ring) for mod in (jgeo, tgeo)]
        rows = np.arange(len(ring))
        k, thr, above = _split(tcat.unary_values(geoms[1], rows, "cpu")
                               ["area"], toracle.area(geoms[1], rows))
        spec, q = "*geom:Polygon", f"st_area(geom) > {thr!r}"
    else:
        coords = _lines()
        geoms = [mod.GeometryArray.linestrings(coords)
                 for mod in (jgeo, tgeo)]
        rows = np.arange(len(coords) // 2)
        spec = "*geom:LineString"
        if kind == "length":
            k, thr, above = _split(tcat.unary_values(geoms[1], rows, "cpu")
                                   ["length"],
                                   toracle.length(geoms[1], rows))
            q = f"st_length(geom) > {thr!r}"
        else:
            lit = (tgeo.POINT, list(DIST_POINT))
            k, thr, above = _split(
                tcat.batch_distance(geoms[1], rows, lit, "cpu"),
                toracle.distance(geoms[1], rows, lit))
            # `<`: the row is in when its value is below the threshold
            above = not above
            q = (f"st_distance(geom, POINT({DIST_POINT[0]} "
                 f"{DIST_POINT[1]})) < {thr!r}")
    js, ts = _store_pair("t", spec, *geoms)
    for knob, want_in in ((None, above), (True, above), (False, not above)):
        with _knob(knob):
            jr = js.query("t", q).indices
            tr = ts.query("t", q).indices
            jc, tc = js.count("t", q), ts.count("t", q)
        assert np.array_equal(tr, jr) and tc == jc == len(tr)
        assert (k in set(tr.tolist())) == want_in, (knob, q)


def _store_pair(name, spec, j_geom, t_geom):
    js = TpuDataStore()
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    for s, geom, tbl in ((js, j_geom, JTable), (ts, t_geom, TTable)):
        s.create_schema(name, spec)
        s.load(name, tbl.build(s.get_schema(name), {"geom": geom}))
    return js, ts


# -- projections ----------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(7)
    n = 6000
    spec = ("name:String,val:Int,dtg:Date,*geom:Point;"
            "geomesa.z3.interval=week")
    base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
    cols = {"name": rng.choice(["a", "b", "c"], n),
            "val": rng.integers(0, 100, n).astype(np.int32),
            "dtg": base + rng.integers(0, 30 * 86400000, n),
            "geom": (rng.uniform(-170, 170, n), rng.uniform(-80, 80, n))}
    jsft, tsft = JSFT.from_spec("gc", spec), TSFT.from_spec("gc", spec)
    jt, tt = JTable.build(jsft, cols), TTable.build(tsft, cols)
    return (JPlanner(jsft, jt, [JZ3(jsft, jt)]),
            TPlanner(tsft, tt, [TZ3(tsft, tt, "cpu")]))


PROJECTIONS = [
    "st_centroid(geom) AS c, st_distance(geom, POINT(0 0)) AS d, val",
    "name, st_buffer(geom, 0.5) AS b, st_contains(POLYGON((-40 -30, 20 -30, "
    "20 20, -40 20, -40 -30)), geom) AS inside",
]


@pytest.mark.parametrize("spec", PROJECTIONS)
@pytest.mark.parametrize("kernels", [True, False, None])
def test_projection_columns_equal_reference(world, spec, kernels):
    jp, tp = world
    rows = np.arange(8)
    got = tfunctions.projection_columns(tp.table, rows, spec, kernels,
                                        device="cpu")
    want = jfunctions.projection_columns(jp.table, rows, spec, kernels)
    assert list(got) == list(want)
    assert got == want


@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("kernels", [True, False])
def test_projections_over_extents_equal_reference(tables, seed, kernels):
    jt, tt = tables[(seed, "j")], tables[(seed, "t")]
    spec = ("st_area(geom) AS a, st_length(geom) AS l, st_centroid(geom) AS "
            "c, st_convexHull(geom) AS h, val")
    rows = np.arange(0, len(tt), 5)
    assert tfunctions.projection_columns(tt, rows, spec, kernels,
                                         device="cpu") == \
        jfunctions.projection_columns(jt, rows, spec, kernels)
    assert tfunctions.parse_projections(spec) == [
        (tfunctions.parse_projection(t)) for t in spec.split(", ")]


# -- the single-process join ------------------------------------------------------


JOIN_POLYGONS = [
    "POLYGON((-20 -20, 20 -20, 20 20, -20 20, -20 -20))",
    "POLYGON((0 0, 40 0, 20 35, 0 0))",
    "POLYGON((100 -30, 160 -30, 160 40, 130 5, 100 40, 100 -30))",
]


@pytest.mark.parametrize("knob", [None, False])
def test_spatial_join_equals_reference(world, knob):
    jp, tp = world
    with _knob(knob):
        for op in tjoin.JOIN_OPS:
            got = tjoin.spatial_join(tp, JOIN_POLYGONS, op)
            want = jjoin.spatial_join(jp, JOIN_POLYGONS, op, runtime=None)
            assert got.stable() == want.stable()
            assert got.counts == [int(c) for c in want.counts]
            capped = tjoin.spatial_join(tp, JOIN_POLYGONS, op, max_pairs=5)
            assert capped.stable() == jjoin.spatial_join(
                jp, JOIN_POLYGONS, op, max_pairs=5).stable()
        assert tjoin.join_battery(tp, JOIN_POLYGONS)["stable"] == \
            jjoin.join_battery(jp, JOIN_POLYGONS)["stable"]


def test_func_counts_equal_reference(world):
    jp, tp = world
    qs = ["st_distance(geom, POINT(10 10)) < 15",
          "st_contains(POLYGON((-40 -30, 20 -30, 20 20, -40 20, -40 -30)), "
          "geom)", "st_area(st_buffer(geom, 2.0)) > 10"]
    assert tjoin.func_counts(tp, qs) == jjoin.func_counts(jp, qs)


def test_join_over_a_runtime_names_item_14(world):
    _, tp = world
    for call in (lambda: tjoin.spatial_join(tp, JOIN_POLYGONS,
                                            runtime=object()),
                 lambda: tjoin.join_battery(tp, JOIN_POLYGONS,
                                            runtime=object()),
                 lambda: tjoin.func_counts(tp, ["st_area(geom) > 1"],
                                           runtime=object())):
        with pytest.raises(NotImplementedError, match="item 14"):
            call()
