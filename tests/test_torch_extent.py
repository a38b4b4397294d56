"""The port's extent and Z2 layers end to end against the JAX package: a
``TorchDataStore`` (device="cpu", the kernels' plain versions) and a
``TpuDataStore`` fed the same numpy-seeded tables.

Layers: single-segment LineStrings without a date (XZ2: the band route of
the reference's bench cfg2) and with one (XZ3), small convex polygons
(XZ2), ``tests/test_geom_batch.py``'s mixed geometries with multi-part
members and a date (XZ3), and points without a date (Z2). Filters:
polygon INTERSECTS, BBOX, WITHIN, DWITHIN, DURING, attribute residuals,
OR and INCLUDE. Every count and every row set must equal the reference's;
the index each store picks, the band route (its plan record and launch
counter), appends into the delta tier and a flush of an extent layer
(the merge build, as the reference's) too.
"""

import numpy as np
import pytest

from geomesa_tpu import config as jconfig
from geomesa_tpu.datastore import TpuDataStore
from geomesa_tpu.features import geometry as jgeo
from geomesa_tpu.features.table import FeatureTable as JTable
from geomesa_tpu_torch import DataStoreFinder
from geomesa_tpu_torch import config as tconfig
from geomesa_tpu_torch.features import geometry as tgeo
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.kernels import seg_band as tseg

from test_torch_geometry import _random_shapes

POLY = "POLYGON ((-12 30, 10 28, 14 44, -2 50, -12 30))"
DURING = "dtg DURING 2020-01-03T00:00:00Z/2020-01-12T00:00:00Z"
BSZ = 256


@pytest.fixture(scope="module", autouse=True)
def small_blocks():
    from geomesa_tpu.index import prune as jprune
    for k in ("BLOCK_SIZE", "PRUNE_MAX_FRACTION"):
        vars(jprune).pop(k, None)
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.set(BSZ)
        c.PRUNE_MAX_FRACTION.set(1.0)
    yield
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.unset()
        c.PRUNE_MAX_FRACTION.unset()


def _segments(n, seed):
    """bench.py cfg2's distributions, narrowed to (-60, 60) x (0, 70)."""
    rng = np.random.default_rng(seed)
    lx = rng.uniform(-60, 60, n)
    ly = rng.uniform(0, 70, n)
    coords = np.empty((2 * n, 2))
    coords[0::2, 0], coords[0::2, 1] = lx, ly
    coords[1::2, 0] = lx + rng.uniform(0.01, 2.0, n)
    coords[1::2, 1] = ly + rng.uniform(0.01, 2.0, n)
    return coords


def _quads(n, seed):
    """n small convex quadrilaterals (closed rings)."""
    rng = np.random.default_rng(seed)
    cx = rng.uniform(-60, 60, n)
    cy = rng.uniform(0, 70, n)
    r = rng.uniform(0.05, 1.5, (n, 4))
    ang = np.sort(rng.uniform(0, 2 * np.pi, (n, 4)), axis=1)
    xs = cx[:, None] + r * np.cos(ang)
    ys = cy[:, None] + r * np.sin(ang)
    return [(tgeo.POLYGON, [np.column_stack(
        [np.append(xs[i], xs[i, 0]), np.append(ys[i], ys[i, 0])]).tolist()])
        for i in range(n)]


def _attrs(n, seed, dated):
    rng = np.random.default_rng(seed)
    cols = {"val": rng.integers(0, 100, n).astype(np.int32),
            "name": rng.choice(["a", "b", "c"], n)}
    if dated:
        base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
        cols["dtg"] = base + rng.integers(0, 30 * 86400000, n)
    return cols


def _geoms(kind, n, seed):
    """(reference column, port column) of one layer kind."""
    if kind.startswith("lines"):
        c = _segments(n, seed)
        return (jgeo.GeometryArray.linestrings(c),
                tgeo.GeometryArray.linestrings(c))
    if kind == "polys":
        s = _quads(n, seed)
    elif kind == "mixed":
        s = [(code, data) for code, data in _random_shapes(
            np.random.default_rng(seed), n)]
        # shift into the query region's latitudes
        s = [(code, _shift(code, data)) for code, data in s]
    else:
        rng = np.random.default_rng(seed)
        x, y = rng.uniform(-60, 60, n), rng.uniform(0, 70, n)
        return (x, y), (x, y)
    return (jgeo.GeometryArray.from_shapes(s),
            tgeo.GeometryArray.from_shapes(s))


def _shift(code, data, dy=35.0):
    if code == tgeo.POINT:
        return [data[0], data[1] + dy]
    if code in (tgeo.LINESTRING, tgeo.MULTIPOINT):
        return [[x, y + dy] for x, y in data]
    if code in (tgeo.POLYGON, tgeo.MULTILINESTRING):
        return [[[x, y + dy] for x, y in ring] for ring in data]
    return [[[[x, y + dy] for x, y in ring] for ring in poly]
            for poly in data]


# layer: (geometry type, dated, rows, the index both stores pick)
LAYERS = {
    "lines": ("LineString", False, 12_000, "xz2"),
    "lines_dtg": ("LineString", True, 12_000, "xz3"),
    "polys": ("Polygon", False, 8_000, "xz2"),
    "mixed": ("Geometry", True, 3_000, "xz3"),
    "points": ("Point", False, 12_000, "z2"),
}


def _spec(layer):
    gtype, dated, _, _ = LAYERS[layer]
    spec = "val:Int,name:String," + ("dtg:Date," if dated else "") \
        + f"*geom:{gtype}"
    return spec + (";geomesa.z3.interval=week" if dated else "")


def _tables(layer, n, seed, js, ts):
    dated = LAYERS[layer][1]
    jg, tg = _geoms(layer, n, seed)
    cols = _attrs(n, seed + 1, dated)
    return (JTable.build(js.get_schema(layer), dict(cols, geom=jg)),
            TTable.build(ts.get_schema(layer), dict(cols, geom=tg)))


@pytest.fixture(scope="module")
def stores():
    js = TpuDataStore()
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    for layer, (_, _, n, _) in LAYERS.items():
        js.create_schema(layer, _spec(layer))
        ts.create_schema(layer, _spec(layer))
        jt, tt = _tables(layer, n, 11, js, ts)
        js.load(layer, jt)
        ts.load(layer, tt)
    return js, ts


QUERIES = [
    f"INTERSECTS(geom, {POLY})",
    "BBOX(geom, -12, 28, 14, 50)",
    f"WITHIN(geom, {POLY})",
    "DWITHIN(geom, POINT (0 40), 3, degrees)",
    "DWITHIN(geom, LINESTRING (-20 20, 20 60), 1.5, degrees)",
    f"INTERSECTS(geom, {POLY}) AND val > 50",
    "BBOX(geom, -12, 28, 14, 50) AND name = 'b'",
    "BBOX(geom, -40, 10, -30, 20) OR BBOX(geom, 20, 50, 30, 60)",
    "INTERSECTS(geom, MULTIPOLYGON (((-10 30, 0 30, 0 40, -10 30)), "
    "((5 45, 12 45, 12 52, 5 45))))",
    "val < 10",
    "INCLUDE",
]
DATED = [f"INTERSECTS(geom, {POLY}) AND {DURING}",
         f"BBOX(geom, -12, 28, 14, 50) AND {DURING} AND val > 20",
         DURING]


def _cases():
    for layer, (_, dated, _, _) in LAYERS.items():
        for q in QUERIES + (DATED if dated else []):
            yield layer, q


@pytest.mark.parametrize("layer,q", list(_cases()))
def test_counts_and_rows_equal_reference(stores, layer, q):
    js, ts = stores
    assert ts.count(layer, q) == js.count(layer, q)
    tr, jr = ts.query(layer, q), js.query(layer, q)
    assert np.array_equal(tr.indices, jr.indices)
    assert tr.table.geometry().wkt(0) == jr.table.geometry().wkt(0) \
        if len(tr.indices) else True


@pytest.mark.parametrize("layer", list(LAYERS))
def test_index_choice_equals_reference(stores, layer):
    js, ts = stores
    want = LAYERS[layer][3]
    assert ts.planner(layer).indexes[0].name == want
    assert js.planner(layer).indexes[0].name == want
    assert ts.planner(layer).plan(f"INTERSECTS(geom, {POLY})").primary_kind \
        == ("point_boxes" if want == "z2" else "bbox_overlap")


@pytest.mark.parametrize("layer,route", [("lines", True),
                                         ("lines_dtg", True),
                                         ("polys", False),
                                         ("mixed", False)])
def test_band_route_engages_on_single_segment_layers(stores, layer, route):
    """The band count runs on single-segment line layers (plan record,
    kernel launches: none on the CPU, the plain version) and declines on
    polygons and mixed layers, where the host ragged refine answers."""
    js, ts = stores
    q = f"INTERSECTS(geom, {POLY})"
    if LAYERS[layer][1]:
        q += f" AND {DURING}"   # the cover of all bins would not prune
    planner = ts.planner(layer)
    plan = planner.plan(q)
    before = tseg.seg_band.launches
    n = planner._count(plan, q)
    assert tseg.seg_band.launches == before
    assert ("band" in plan.explain) == route
    if route:
        assert plan.explain["band"]["certain"] <= n
    assert n == js.count(layer, q)


def test_appends_and_flush_on_extent_layers():
    """Appends land in the delta tier and count exactly; a flush merges
    them into the XZ index (``merge_from``); every answer equals the
    reference's throughout."""
    js = TpuDataStore()
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    queries = [f"INTERSECTS(geom, {POLY}) AND {DURING}",
               "BBOX(geom, -12, 28, 14, 50)"]
    for layer, n in (("lines_dtg", 4000), ("mixed", 1500)):
        js.create_schema(layer, _spec(layer))
        ts.create_schema(layer, _spec(layer))
        for k, rows in enumerate((n, 500, 700)):
            jt, tt = _tables(layer, rows, 20 + k, js, ts)
            js.load(layer, jt)
            ts.load(layer, tt)
            if k:
                assert ts.deltas[layer] is not None
            for q in queries:
                assert ts.count(layer, q) == js.count(layer, q), (layer, k, q)
                assert np.array_equal(ts.query(layer, q).indices,
                                      js.query(layer, q).indices)
        ts.flush(layer)
        js.flush(layer)
        assert ts.deltas[layer] is None
        assert len(ts.planner(layer).table) == n + 1200
        for q in queries:
            assert ts.count(layer, q) == js.count(layer, q), (layer, q)
            assert np.array_equal(ts.query(layer, q).indices,
                                  js.query(layer, q).indices)


def test_mutations_on_an_extent_layer():
    """update_features (a geometry patch), remove_features and upsert
    rebuild the XZ index; answers equal the reference's."""
    js = TpuDataStore()
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    layer = "polys"
    js.create_schema(layer, _spec(layer))
    ts.create_schema(layer, _spec(layer))
    jt, tt = _tables(layer, 3000, 31, js, ts)
    js.load(layer, jt)
    ts.load(layer, tt)
    sq = "POLYGON ((0 40, 1 40, 1 41, 0 41, 0 40))"
    for s in (js, ts):
        s.update_features(layer, "val = 7", {"geom": sq})
        s.remove_features(layer, "val > 90")
    q = "BBOX(geom, 0, 40, 1, 41)"
    assert ts.count(layer, q) == js.count(layer, q) > 0
    assert np.array_equal(ts.query(layer, q).indices,
                          js.query(layer, q).indices)
    assert ts.count(layer, "INCLUDE") == js.count(layer, "INCLUDE")


def test_outside_the_slice_raises_naming_roadmap(stores):
    """What this test once held refused naming item 9 — density over an
    extent layer, st_* over extent features, a configured S2 index — now
    answers as the reference does: the density grid byte for byte, the
    count and rows; a schema without a geometry builds the full-scan
    index."""
    js, ts = stores
    hints = {"density": {"bbox": (-60, 0, 60, 70), "width": 8, "height": 8}}
    got = ts.query("lines", "INCLUDE", hints=hints)
    want = js.query("lines", "INCLUDE", hints=hints)
    assert got.weights.dtype == np.float32
    assert got.weights.tobytes() == np.asarray(want.weights).tobytes()
    q = "st_area(geom) > 1"
    assert ts.count("polys", q) == js.count("polys", q) > 0
    assert np.array_equal(ts.query("polys", q).indices,
                          js.query("polys", q).indices)
    ts.create_schema("nogeom", "val:Int")
    assert ts.get_schema("nogeom").geometry_attribute is None
    spec = "val:Int,*geom:Point;geomesa.indices=s2"
    ts.create_schema("s2", spec)
    js.create_schema("s2", spec)
    x, y = np.random.default_rng(3).uniform(-60, 60, (2, 2000))
    for s in (js, ts):
        tbl = TTable if s is ts else JTable
        s.load("s2", tbl.build(s.get_schema("s2"), {
            "val": np.arange(2000, dtype=np.int32), "geom": (x, y)}))
    q = "BBOX(geom, -10, -10, 20, 30) AND val > 500"
    assert ts.count("s2", q) == js.count("s2", q) > 0
    assert ts.explain("s2", q)["index"] == js.explain("s2", q)["index"] \
        == "s2"
