"""The port's ragged geometry oracle (``geom/oracle.py``, a copy of the
reference's) and the st_* functions over extent features
(``geom/functions.py``'s ``kernels=False`` routes) against the JAX
package:

- every oracle function on ``tests/test_geom_catalog.py``'s mixed corpus
  (points, polygons, degenerate rings, lines, collinear lines, tiny
  triangles, dateline-adjacent shapes; seeds 3, 11 and 29), against its
  polygon literal and point, line and multipolygon literals: areas,
  lengths, centroids and their mode, distances, hulls, buffers and their
  envelopes, intersects and both containments — f64 values exactly,
  shapes equal;
- ``scalar_values``/``bool_values``/``eval_filter_node`` on that corpus,
  with ``st_buffer``, ``st_convexHull``, ``st_centroid`` and non-point
  literals as arguments (``kernels=True``, the device catalog, is
  ``tests/test_torch_catalog.py``'s and ``test_torch_catalog_route.py``'s);
- st_* filters over line and polygon layers through both stores (XZ2 and
  XZ3 layers): counts and row ids equal.

Tolerance: none. The port runs with device="cpu".
"""

import numpy as np
import pytest

from geomesa_tpu.datastore import TpuDataStore
from geomesa_tpu.features import geometry as jgeo
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.features.table import FeatureTable as JTable
from geomesa_tpu.filter.parser import parse_ecql as jparse
from geomesa_tpu.geom import functions as jfunctions
from geomesa_tpu.geom import oracle as joracle
from geomesa_tpu_torch import DataStoreFinder
from geomesa_tpu_torch.features import geometry as tgeo
from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.filter.parser import parse_ecql as tparse
from geomesa_tpu_torch.geom import functions as tfunctions
from geomesa_tpu_torch.geom import oracle as toracle

from test_geom_catalog import LITERAL, _mixed_shapes

LITERALS = {
    "polygon": LITERAL,
    "point": (tgeo.POINT, [10.0, 10.0]),
    "line": (tgeo.LINESTRING, [[-40.0, -10.0], [20.0, 30.0], [60.0, 0.0]]),
    "multipolygon": (tgeo.MULTIPOLYGON, [
        [[[-10.0, -10.0], [0.0, -10.0], [0.0, 0.0], [-10.0, -10.0]]],
        [[[100.0, 40.0], [120.0, 40.0], [120.0, 60.0], [100.0, 40.0]]]]),
}


def _arrays(seed, n=160):
    shapes = _mixed_shapes(np.random.default_rng(seed), n)
    return (jgeo.GeometryArray.from_shapes(shapes),
            tgeo.GeometryArray.from_shapes(shapes))


def _rows(n):
    return {"all": np.arange(n, dtype=np.int64),
            "some": np.arange(n - 1, 0, -3, dtype=np.int64),
            "none": np.empty(0, dtype=np.int64)}


def _same(a, b):
    """Equal f64 arrays (NaN where NaN), or equal nested lists."""
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == np.asarray(b).dtype and np.array_equal(
            a, b, equal_nan=a.dtype.kind == "f")
    return a == b


@pytest.mark.parametrize("seed", [3, 11, 29])
@pytest.mark.parametrize("rows", ["all", "some", "none"])
def test_unary_oracles_equal_reference(seed, rows):
    ja, ta = _arrays(seed)
    r = _rows(len(ta))[rows]
    for fn in ("area", "length", "centroid", "convex_hull_shapes"):
        assert _same(getattr(toracle, fn)(ta, r),
                     getattr(joracle, fn)(ja, r)), fn
    for d in (0.0, 0.25, 3.0):
        assert _same(toracle.buffer_shapes(ta, r, d),
                     joracle.buffer_shapes(ja, r, d)), d
        assert _same(toracle.buffer_envelopes(ta, r, d),
                     joracle.buffer_envelopes(ja, r, d)), d
    for i in r[:40]:
        assert toracle.centroid_mode(ta, i) == joracle.centroid_mode(ja, i)
        assert toracle.feature_shape(ta, i) == joracle.feature_shape(ja, i)
        assert _same(toracle.convex_hull_of(ta, i),
                     joracle.convex_hull_of(ja, i))
        tr, jr = toracle._feature_rings(ta, i), joracle._feature_rings(ja, i)
        assert len(tr) == len(jr)
        for (tp, ts), (jp, js) in zip(tr, jr):
            assert ts == js and np.array_equal(tp, jp)
            assert toracle._ring_signed_area(tp) \
                == joracle._ring_signed_area(jp)


@pytest.mark.parametrize("seed", [3, 11, 29])
@pytest.mark.parametrize("lit", list(LITERALS))
def test_literal_oracles_equal_reference(seed, lit):
    ja, ta = _arrays(seed)
    literal = LITERALS[lit]
    for r in _rows(len(ta)).values():
        for fn in ("distance", "intersects", "contains_literal",
                   "feature_contains"):
            assert _same(getattr(toracle, fn)(ta, r, literal),
                         getattr(joracle, fn)(ja, r, literal)), fn


def test_buffer_octagon_and_point_in_rings_equal_reference():
    for d in (0.0, 0.25, 7.5):
        assert np.array_equal(toracle.octagon_offsets(d),
                              joracle.octagon_offsets(d))
    assert toracle.BUFFER_SEC == joracle.BUFFER_SEC
    segs = np.array([[0, 0, 4, 0], [4, 0, 4, 4], [4, 4, 0, 4], [0, 4, 0, 0]],
                    dtype=np.float64)
    for px, py in ((2, 2), (0, 2), (4, 4), (5, 1), (-1e-12, 2), (2, 4.0)):
        assert toracle._point_in_rings(px, py, segs) \
            == joracle._point_in_rings(px, py, segs)
    assert toracle._point_in_rings(1, 1, segs[:0]) is False
    pts = np.random.default_rng(1).uniform(-5, 5, (50, 2))
    assert np.array_equal(toracle.convex_hull(pts), joracle.convex_hull(pts))


SPEC = "val:Int,*geom:Geometry"
FUNC_FILTERS = [
    "st_area(geom) > 1",
    "st_length(geom) > 6",
    "st_distance(geom, POINT(10 10)) < 40",
    "st_distance(geom, LINESTRING(-40 -10, 20 30, 60 0)) <= 25",
    "st_intersects(geom, POLYGON((-30 -20, 30 -20, 30 25, -30 25, "
    "-30 -20)))",
    "st_contains(POLYGON((-90 -60, 90 -60, 90 60, -90 60, -90 -60)), geom)",
    "st_contains(geom, POINT(10 10))",
    "st_area(st_buffer(geom, 0.5)) > 3",
    "st_length(st_convexHull(geom)) > 4",
    "st_intersects(st_buffer(geom, 2.0), POINT(0 0))",
    "st_distance(st_centroid(geom), POINT(-120 40)) < 60",
    "st_area(POLYGON((0 0, 1 0, 1 1, 0 0))) > 0",
    "st_area(st_buffer(POINT(1 2), 1.0)) > 3",
]


@pytest.fixture(scope="module")
def tables():
    shapes = _mixed_shapes(np.random.default_rng(11), 480)
    val = np.arange(480, dtype=np.int32) % 17
    jsft, tsft = JSFT.from_spec("o", SPEC), TSFT.from_spec("o", SPEC)
    return (JTable.build(jsft, {"val": val, "geom":
                                jgeo.GeometryArray.from_shapes(shapes)}),
            TTable.build(tsft, {"val": val, "geom":
                                tgeo.GeometryArray.from_shapes(shapes)}))


def _node(f):
    return f.children[0] if hasattr(f, "children") else f


@pytest.mark.parametrize("q", FUNC_FILTERS)
def test_func_nodes_equal_reference(tables, q):
    jt, tt = tables
    rows = np.arange(1, len(tt), 2)
    for r in (None, rows):
        got = tfunctions.eval_filter_node(_node(tparse(q)), tt, r,
                                          kernels=False)
        want = jfunctions.eval_filter_node(_node(jparse(q)), jt, r,
                                           kernels=False)
        assert np.array_equal(got, want), r


@pytest.mark.parametrize("name,args", [
    ("st_area", ("geom",)), ("st_length", ("geom",)),
    ("st_distance", ("geom", LITERAL)), ("st_distance", (LITERAL, "geom")),
    ("st_distance", ("geom", "geom")),
    ("st_area", (LITERAL,)), ("st_length", (LITERALS["line"],))])
def test_scalar_values_equal_reference(tables, name, args):
    jt, tt = tables
    rows = np.arange(0, len(tt), 3)
    assert _same(tfunctions.scalar_values(tt, rows, name, args),
                 jfunctions.scalar_values(jt, rows, name, args,
                                          kernels=False))


@pytest.mark.parametrize("name,args", [
    ("st_intersects", ("geom", LITERAL)),
    ("st_intersects", (LITERALS["multipolygon"], "geom")),
    ("st_intersects", ("geom", "geom")),
    ("st_contains", (LITERAL, "geom")), ("st_contains", ("geom", LITERAL)),
    ("st_contains", ("geom", "geom"))])
def test_bool_values_equal_reference(tables, name, args):
    jt, tt = tables
    rows = np.arange(0, len(tt), 3)
    assert np.array_equal(
        tfunctions.bool_values(tt, rows, name, args),
        jfunctions.bool_values(jt, rows, name, args, kernels=False))


LAYERS = {"polys": "val:Int,*geom:Polygon",
          "lines": "val:Int,dtg:Date,*geom:LineString;"
                   "geomesa.z3.interval=week"}


@pytest.fixture(scope="module")
def stores():
    rng = np.random.default_rng(13)
    js = TpuDataStore()
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    for layer, spec in LAYERS.items():
        shapes = [s for s in _mixed_shapes(rng, 2400)
                  if s[0] == (tgeo.POLYGON if layer == "polys"
                              else tgeo.LINESTRING)]
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


@pytest.mark.parametrize("layer", list(LAYERS))
@pytest.mark.parametrize("q", FUNC_FILTERS[:11] + [
    "st_area(geom) > 0.5 AND BBOX(geom, -100, -60, 100, 60)",
    "st_intersects(st_buffer(geom, 1.0), POINT(10 10)) OR val < 3"])
def test_extent_layers_through_both_stores(stores, layer, q):
    js, ts = stores
    assert ts.count(layer, q) == js.count(layer, q)
    assert np.array_equal(ts.query(layer, q).indices,
                          js.query(layer, q).indices)
