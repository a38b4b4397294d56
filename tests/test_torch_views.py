"""Merged and routed views over the port's stores (geomesa_tpu_torch,
``views.py``, a copy of the reference's) against the same views over the
JAX package's stores, on the inputs of the reference's own
``tests/test_guards_views.py``, with auths passed through: counts,
concatenated tables (columns and fids) and routes must equal the
reference's. The port runs with device="cpu"."""

import numpy as np
import pytest

from geomesa_tpu import views as jviews
from geomesa_tpu.datastore import TpuDataStore
from geomesa_tpu.features.table import FeatureTable as JTable
from geomesa_tpu.filter.parser import parse_ecql as jparse
from geomesa_tpu_torch import DataStoreFinder
from geomesa_tpu_torch import views as tviews
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.filter.parser import parse_ecql as tparse

SPEC = "name:String,v:Int,dtg:Date,*geom:Point"
BASE = np.datetime64("2024-01-01", "ms").astype(np.int64)


def _pair(n=2000, seed=0, fid_prefix="f", labelled=False):
    """The reference's ``_store`` fixture on both packages (visibility
    labels on every other feature when ``labelled``)."""
    rng = np.random.default_rng(seed)
    data = {"name": rng.choice(["a", "b"], n).astype(object),
            "v": rng.integers(0, 100, n).astype(np.int32),
            "dtg": BASE + rng.integers(0, 7 * 86400000, n),
            "geom": (rng.uniform(-60, 60, n), rng.uniform(-60, 60, n))}
    fids = [f"{fid_prefix}{i}" for i in range(n)]
    vis = np.where(np.arange(n) % 2, "admin", "") if labelled else None
    js = TpuDataStore()
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    for store, tbl in ((js, JTable), (ts, TTable)):
        store.create_schema("t", SPEC)
        store.load("t", tbl.build(store.get_schema("t"), data, fids=fids,
                                  visibilities=vis))
    return js, ts


@pytest.fixture(scope="module")
def merged():
    (ja, ta) = _pair(1000, seed=3, fid_prefix="a", labelled=True)
    (jb, tb) = _pair(500, seed=4, fid_prefix="b")
    return (jviews.MergedDataStoreView([ja, jb], "t"),
            tviews.MergedDataStoreView([ta, tb], "t"))


@pytest.mark.parametrize("auths", [None, [], ["admin"]], ids=str)
@pytest.mark.parametrize("q", ["BBOX(geom, -30, -30, 30, 30) AND v < 50",
                               "INCLUDE", "EXCLUDE", "IN ('a3', 'b7', 'x')"])
def test_merged_view_equals_reference(merged, q, auths):
    jv, tv = merged
    assert tv.count(q, auths=auths) == jv.count(q, auths=auths)
    got, want = tv.query(q, auths=auths), jv.query(q, auths=auths)
    assert len(got) == len(want) == tv.count(q, auths=auths)
    assert list(map(str, got.fids)) == list(map(str, want.fids))
    assert np.array_equal(np.asarray(got.columns["v"]),
                          np.asarray(want.columns["v"]))
    assert np.array_equal(got.geometry().coords, want.geometry().coords)


def test_merged_view_schema_mismatch():
    a = _pair(10)[1]
    b = DataStoreFinder.get_data_store(type="torch", device="cpu")
    b.create_schema("t", "other:Int,*geom:Point")
    with pytest.raises(ValueError, match="disagree"):
        tviews.MergedDataStoreView([a, b], "t")
    with pytest.raises(ValueError, match="at least one"):
        tviews.MergedDataStoreView([], "t")


@pytest.mark.parametrize("q,store", [
    ("BBOX(geom, 0, 0, 20, 20)", 0), ("v = 7", 1),
    ("v = 7 AND BBOX(geom, 0, 0, 20, 20)", 0),
    ("name = 'a' OR v < 3", 1)])
def test_routed_view_equals_reference(q, store):
    recent, historic = _pair(1000, seed=5), _pair(1000, seed=6,
                                                  labelled=True)
    routes = [(0, {"dtg", "geom"}), (1, {"name", "v"})]
    jv = jviews.RoutedDataStoreView(
        [recent[0], historic[0]], "t",
        jviews.RouteSelectorByAttribute(routes, default=0))
    tsel = tviews.RouteSelectorByAttribute(routes, default=0)
    tv = tviews.RoutedDataStoreView([recent[1], historic[1]], "t", tsel)
    assert tsel.route(tparse(q)) == store \
        == jviews.RouteSelectorByAttribute(routes, 0).route(jparse(q))
    for auths in (None, ["admin"], []):
        assert tv.count(q, auths=auths) == jv.count(q, auths=auths)
        got = tv.query(q, auths=auths)
        want = jv.query(q, auths=auths)
        assert np.array_equal(got.indices, want.indices)
    assert tv.count(q) == (recent, historic)[store][1].count("t", q)


def test_routed_view_without_a_default_raises():
    tv = tviews.RoutedDataStoreView(
        [_pair(10)[1]], "t",
        tviews.RouteSelectorByAttribute([(0, {"geom"})]))
    with pytest.raises(ValueError, match="No route"):
        tv.count("v = 1")
