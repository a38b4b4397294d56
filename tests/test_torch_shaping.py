"""The query shaping hints of the port's store (geomesa_tpu_torch) — sort,
limit, transform and crs — against the JAX package on the inputs of the
reference's own ``tests/test_shaping.py`` (30,000 points, four names), and
the copied host modules under them (``index/shaping.py``,
``features/crs.py``, ``convert/expression.py``, ``features/jsonpath.py``):
row ids in order, the shaped tables' schemas, columns, geometries and fids
must equal the reference's byte for byte, with and without auths and with
a pending delta merged inline. The port runs with device="cpu"."""

import numpy as np
import pytest

from geomesa_tpu.convert import expression as jexpr
from geomesa_tpu.datastore import TpuDataStore
from geomesa_tpu.features import crs as jcrs
from geomesa_tpu.features import jsonpath as jjson
from geomesa_tpu.features.table import FeatureTable as JTable
from geomesa_tpu_torch import DataStoreFinder
from geomesa_tpu_torch.convert import expression as texpr
from geomesa_tpu_torch.features import crs as tcrs
from geomesa_tpu_torch.features import jsonpath as tjson
from geomesa_tpu_torch.features.table import FeatureTable as TTable

Q = "BBOX(geom, -20, -20, 20, 20)"
SPEC = "name:String,v:Int,dtg:Date,*geom:Point"


def _data(n=30_000, seed=31):
    rng = np.random.default_rng(seed)
    base = np.datetime64("2021-03-01T00:00:00", "ms").astype(np.int64)
    return {"name": rng.choice(["delta", "alpha", "charlie", "bravo"], n),
            "v": rng.integers(-500, 500, n).astype(np.int32),
            "dtg": base + rng.integers(0, 20 * 86400000, n),
            "geom": (rng.uniform(-60, 60, n), rng.uniform(-60, 60, n))}


@pytest.fixture(scope="module")
def stores():
    data = _data()
    vis = np.random.default_rng(32).choice(["", "admin", "secret&admin"],
                                           len(data["v"]))
    js = TpuDataStore()
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    for store, tbl in ((js, JTable), (ts, TTable)):
        store.create_schema("s", SPEC)
        store.load("s", tbl.build(store.get_schema("s"), data,
                                  visibilities=vis))
    return js, ts


def same_table(a, b):
    """Two hydrated tables equal byte for byte: schema, columns (strings
    decoded), geometries' coordinates and fids."""
    assert a.sft.to_spec() == b.sft.to_spec()
    assert len(a) == len(b)
    assert list(map(str, a.fids)) == list(map(str, b.fids))
    for name, col in a.columns.items():
        other = b.columns[name]
        if hasattr(col, "decode"):
            assert col.decode(np.arange(len(a))) \
                == other.decode(np.arange(len(b))), name
        elif hasattr(col, "coords"):
            assert np.array_equal(col.coords, other.coords), name
        else:
            x, y = np.asarray(col), np.asarray(other)
            assert x.dtype == y.dtype and np.array_equal(x, y), name


HINTS = [
    {"sort": "v"}, {"sort": "-v"}, {"sort": "name", "limit": 100},
    {"sort": ["name", "v"]}, {"sort": ["-v", "dtg"], "limit": 17},
    {"sort": "v", "limit": 17}, {"limit": 5},
    {"transform": ["name", "doubled=add($v,$v)"], "limit": 50},
    {"transform": ["v", "geom"], "sort": "-v", "limit": 1000},
    {"transform": ["tag=concat($name,'-',toString($v))",
                   "up=uppercase($name)"], "sort": "dtg", "limit": 30},
    {"crs": "EPSG:3857", "limit": 200},
    {"crs": "EPSG:3857", "sort": ["-v", "dtg"], "limit": 1000,
     "transform": ["v", "geom"]},
]


@pytest.mark.parametrize("auths", [None, ["admin"], []], ids=str)
@pytest.mark.parametrize("hints", HINTS, ids=str)
def test_shaped_query_equals_reference(stores, hints, auths):
    js, ts = stores
    want = js.query("s", Q, hints=dict(hints), auths=auths)
    got = ts.query("s", Q, hints=dict(hints), auths=auths)
    assert np.array_equal(got.indices, want.indices)
    same_table(got.table, want.table)


def test_shaping_merges_a_pending_delta_inline():
    js = TpuDataStore()
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    main, more = _data(20_000, 1), _data(300, 2)
    for store, tbl in ((js, JTable), (ts, TTable)):
        store.create_schema("s", SPEC)
        store.load("s", tbl.build(store.get_schema("s"), main))
        store.load("s", tbl.build(store.get_schema("s"), more))
    assert ts.deltas["s"] is not None
    for hints in ({"sort": ["-v", "dtg"], "limit": 1000},
                  {"sort": "name", "transform": ["name", "v"]},
                  {"crs": "EPSG:3857", "limit": 40}):
        want = js.query("s", Q, hints=dict(hints))
        got = ts.query("s", Q, hints=dict(hints))
        assert np.array_equal(got.indices, want.indices)
        same_table(got.table, want.table)
    assert ts.deltas["s"] is not None   # no flush


def test_reference_shaping_cases(stores):
    """The reference's own assertions, on the port's store."""
    js, ts = stores
    data = _data()
    x, y = data["geom"]
    inbox = (x >= -20) & (x <= 20) & (y >= -20) & (y <= 20)
    r = ts.query("s", Q, hints={"sort": "v"})
    assert np.all(np.diff(np.asarray(r.table.columns["v"])) >= 0)
    assert r.count == int(inbox.sum())
    r = ts.query("s", Q, hints={"sort": "name", "limit": 100})
    names = r.table.columns["name"].decode(np.arange(r.count))
    assert names == sorted(names) and r.count == 100
    r = ts.query("s", Q, hints={"crs": "EPSG:3857", "limit": 200})
    gx, gy = r.table.geometry().point_xy()
    R = 6378137.0
    np.testing.assert_allclose(gx, R * np.radians(x[r.indices]), rtol=1e-12)
    np.testing.assert_allclose(
        gy, R * np.log(np.tan(np.pi / 4 + np.radians(y[r.indices]) / 2)),
        rtol=1e-12)


@pytest.mark.parametrize("hint", ["stats", "bin", "sample"])
def test_aggregation_hints_name_their_roadmap_item(stores, hint):
    """The aggregation hints, once ROADMAP.md Queue 1 item 12, now answer
    as the reference's (with the shaping hints beside them ignored, as
    there), under auths too."""
    js, ts = stores
    value = {"stats": 'Count();Enumeration("name")',
             "bin": {"track": "name", "sort": True},
             "sample": {"n": 3, "by": "name"}}[hint]
    for auths in (None, ["admin"]):
        q = {hint: value, "sort": "v", "limit": 5}
        got = ts.query("s", Q, hints=q, auths=auths)
        want = js.query("s", Q, hints=q, auths=auths)
        if hint == "stats":
            assert got.to_dict() == want.to_dict()
        elif hint == "bin":
            assert got.tobytes() == want.tobytes()
        else:
            assert np.array_equal(got.indices, want.indices)


def test_unknown_hint_raises_as_reference(stores):
    js, ts = stores
    for store in (js, ts):
        with pytest.raises(ValueError, match="Unknown hints"):
            store.query("s", Q, hints={"sort": "v", "bogus": 1})


# -- the copied host modules ---------------------------------------------------


def test_crs_transformers_equal_reference():
    x = np.array([-179.0, 0.0, 12.345, 179.0, -45.5])
    y = np.array([-89.0, 0.0, 45.0, 80.0, 88.0])
    for src, dst in (("EPSG:4326", "EPSG:3857"), ("3857", "WGS84"),
                     ("CRS:84", "EPSG:900913"), ("4326", "4326")):
        a = tcrs.transformer(src, dst)(x, y)
        b = jcrs.transformer(src, dst)(x, y)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    with pytest.raises(ValueError, match="Unsupported CRS"):
        tcrs.transformer("EPSG:2154", "EPSG:4326")


@pytest.mark.parametrize("src", [
    "add($v, $v)", "concat($name, '-', toString($v))", "uppercase($name)",
    "substring($name, 0, 3)", "toDouble($v)", "multiply($v, 2)",
    "regexReplace($name, 'a+', 'X')", "md5($name)", "literal('x')",
    "jsonPath('$.a.b[1]', $doc)", "trim($name)", "divide($v, 4)"])
def test_expressions_equal_reference(src):
    rng = np.random.default_rng(4)
    n = 50
    fields = {"name": np.asarray(rng.choice([" alpha", "bravo", "caaa"], n),
                                 dtype=object),
              "v": rng.integers(-9, 9, n).astype(np.int32),
              "doc": np.asarray(['{"a": {"b": [1, %d]}}' % i
                                 for i in range(n)], dtype=object)}
    a = texpr.parse_expression(src).eval(dict(fields), n)
    b = jexpr.parse_expression(src).eval(dict(fields), n)
    assert np.array_equal(np.asarray(a, dtype=object),
                          np.asarray(b, dtype=object))
    assert sorted(texpr.FUNCTIONS) == sorted(jexpr.FUNCTIONS)


def test_jsonpath_equal_reference():
    docs = ['{"a": {"b": [1, 2, {"c": "x"}]}}', "not json", '{"a": 3}', ""]
    for path in ("$.a.b[2].c", "$.a", "$.a.b[0]", "$", "$.missing"):
        for d in docs:
            assert tjson.extract_path(d, path) == jjson.extract_path(d, path)
