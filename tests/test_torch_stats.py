"""The port's stats subsystem (geomesa_tpu_torch ``stats/``) against the JAX
package's, on the inputs of the reference's own ``tests/test_stats.py``
(every one of its cases, through both packages) and more: each sketch's
``to_dict()`` after observe and after merge, the DSL, ``observe_table``
over dictionary-encoded string columns (repeated, single and all-equal
values, one row, no row, unsorted vocabularies with unused and repeated
entries), the chunked observes over a thread pool, the estimator's
selectivities and counts, the battery carried by ``to_dict``/``from_dict``
and by ``load(stats_cached=)``, the store's battery after a load, a merge
flush (carried over) and a full rebuild, the GeoMesaStats API exact and
estimated, the planner's cost-based choice and the scheduler's degraded
count. Every sketch dict, count and selectivity must equal the reference's
exactly (no tolerance). The port runs with device="cpu"."""

import numpy as np
import pytest

from geomesa_tpu import stats as jst
from geomesa_tpu.curves import binnedtime as jbt
from geomesa_tpu.datastore import TpuDataStore
from geomesa_tpu.features import table as jtable
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.filter.parser import parse_ecql as jparse
from geomesa_tpu.serve.resilience import degrade as jdegrade
from geomesa_tpu.stats import dsl as jdsl
from geomesa_tpu.stats.store import GeoMesaStats as JStats
from geomesa_tpu_torch import DataStoreFinder
from geomesa_tpu_torch import stats as tst
from geomesa_tpu_torch.curves import binnedtime as tbt
from geomesa_tpu_torch.features import table as ttable
from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
from geomesa_tpu_torch.filter.parser import parse_ecql as tparse
from geomesa_tpu_torch.serve.resilience import degrade as tdegrade
from geomesa_tpu_torch.stats import dsl as tdsl
from geomesa_tpu_torch.stats import sketches as tsk
from geomesa_tpu_torch.stats.store import GeoMesaStats as TStats

SPEC = "name:String,val:Int,score:Double,dtg:Date,*geom:Point"
BASE = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
SIDES = {"jax": (jst, jdsl, jtable, JSFT, JStats),
         "torch": (tst, tdsl, ttable, TSFT, TStats)}


def _data(n=20_000, seed=42):
    """The reference test's store: 20,000 rows, four skewed names,
    clustered points over 28 days."""
    rng = np.random.default_rng(seed)
    return {
        "name": rng.choice(["alpha", "beta", "gamma", "delta"], n,
                           p=[0.5, 0.3, 0.15, 0.05]),
        "val": rng.integers(0, 1000, n).astype(np.int32),
        "score": rng.normal(50, 10, n),
        "dtg": BASE + rng.integers(0, 28 * 86400000, n),
        "geom": (np.clip(rng.normal(10, 30, n), -180, 180),
                 np.clip(rng.normal(20, 15, n), -90, 90)),
    }


@pytest.fixture(scope="module")
def stores():
    data = _data()
    js = TpuDataStore()
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    for s, tbl in ((js, jtable.FeatureTable), (ts, ttable.FeatureTable)):
        s.create_schema("pts", SPEC)
        s.load("pts", tbl.build(s.get_schema("pts"), data))
    return js, ts


def _both(fn):
    """fn(side modules) through both packages → (reference, port)."""
    return fn(*SIDES["jax"]), fn(*SIDES["torch"])


def _same(fn):
    a, b = _both(fn)
    assert a == b
    return b


# -- the reference's sketch cases through both packages ----------------------


def test_count_and_merge():
    def run(st, *_):
        a, b = st.CountStat(), st.CountStat()
        a.observe(np.arange(10))
        b.observe(5)
        a += b
        return a.to_dict(), st.from_dict(a.to_dict()).count
    assert _same(run)[1] == 15


def test_minmax_numeric():
    vals = np.random.default_rng(42).integers(-500, 500, 5000)

    def run(st, *_):
        mm = st.MinMaxStat("v")
        mm.observe(vals)
        return mm.to_dict(), mm.cardinality
    d, card = _same(run)
    assert d["min"] == vals.min() and d["max"] == vals.max()
    true = len(np.unique(vals))
    assert abs(card - true) / true < 0.1


def test_minmax_strings_and_merge():
    def run(st, *_):
        a, b = st.MinMaxStat("s"), st.MinMaxStat("s")
        a.observe(np.array(["kiwi", "apple"], dtype=object))
        b.observe(np.array(["zebra", "mango"], dtype=object))
        a += b
        rt = st.from_dict(a.to_dict())
        return a.to_dict(), rt.min, rt.max
    assert _same(run)[1:] == ("apple", "zebra")


def test_enumeration_exact():
    vals = np.random.default_rng(1).choice(["x", "y", "z"], 1000,
                                           p=[0.6, 0.3, 0.1])

    def run(st, *_):
        e = st.EnumerationStat("a")
        e.observe(vals)
        return e.to_dict(), e.counts
    assert _same(run)[1] == {v: int(c) for v, c in
                             zip(*np.unique(vals, return_counts=True))}


def test_topk():
    rng = np.random.default_rng(2)
    vals = np.concatenate([
        np.repeat("big", 5000), np.repeat("mid", 1000),
        rng.choice([f"t{i}" for i in range(500)], 2000)])
    rng.shuffle(vals)

    def run(st, *_):
        tk = st.TopKStat("a")
        for chunk in np.array_split(vals, 7):
            tk.observe(chunk)
        return tk.to_dict(), tk.topk(2)
    top = _same(run)[1]
    assert top[0][0] == "big" and top[1][0] == "mid" and top[0][1] >= 5000


def test_frequency_countmin():
    rng = np.random.default_rng(3)
    vals = np.concatenate([np.repeat(7, 3000),
                           rng.integers(100, 10000, 10000)])

    def run(st, *_):
        fr = st.FrequencyStat("a")
        fr.observe(vals)
        f1, f2 = st.FrequencyStat("a"), st.FrequencyStat("a")
        halves = np.array_split(vals, 2)
        f1.observe(halves[0])
        f2.observe(halves[1])
        f1 += f2
        return fr.to_dict(), f1.to_dict(), fr.estimate(7), f1.estimate(7)
    _, _, est, merged = _same(run)
    assert 3000 <= est <= 3200 and merged == est


def test_histogram_mass():
    vals = np.random.default_rng(4).uniform(0, 100, 20000)

    def run(st, *_):
        h = st.HistogramStat("a", 50, 0, 100)
        h.observe(vals)
        return h.to_dict(), h.mass_between(25, 75)
    d, mass = _same(run)
    assert sum(d["counts"]) == 20000 and abs(mass - 10000) < 300


def test_z2histogram_box_mass():
    rng = np.random.default_rng(5)
    x, y = rng.uniform(-180, 180, 30000), rng.uniform(-90, 90, 30000)

    def run(st, *_):
        z = st.Z2HistogramStat("geom", 5)
        z.observe(x, y)
        return z.to_dict(), z.mass_in_box(-30, -20, 30, 20)
    _, est = _same(run)
    true = int(np.sum((x >= -30) & (x <= 30) & (y >= -20) & (y <= 20)))
    assert abs(est - true) / true < 0.1


def test_z3histogram_windows():
    ms = BASE + np.random.default_rng(6).integers(0, 28 * 86400000, 20000)

    def run(st, _dsl, _tbl, _sft, _stats):
        bt = jbt if st is jst else tbt
        period = bt.TimePeriod.parse("week")
        bins, offs = bt.time_to_binned_time(ms, period)
        zh = st.Z3HistogramStat("dtg", "week")
        zh.observe(bins, offs, bt.max_offset(period))
        lo, hi = BASE + 7 * 86400000, BASE + 14 * 86400000
        blo, olo = bt.time_to_binned_time(np.int64(lo), period)
        bhi, ohi = bt.time_to_binned_time(np.int64(hi), period)
        est = zh.mass_in_windows([(int(blo), int(olo), int(bhi), int(ohi))],
                                 bt.max_offset(period))
        return zh.to_dict(), list(zh.bins), zh.total, est
    d, order, total, est = _same(run)
    assert order == sorted(order) and total == 20000
    lo, hi = BASE + 7 * 86400000, BASE + 14 * 86400000
    true = int(np.sum((ms >= lo) & (ms <= hi)))
    assert abs(est - true) / true < 0.1


def test_descriptive_stats():
    rng = np.random.default_rng(7)
    a = rng.normal(10, 2, 5000)
    b = 3 * a + rng.normal(0, 1, 5000)

    def run(st, *_):
        d = st.DescriptiveStat(["a", "b"])
        d1, d2 = st.DescriptiveStat(["a", "b"]), st.DescriptiveStat(["a", "b"])
        d1.observe(a[:2500], b[:2500])
        d2.observe(a[2500:], b[2500:])
        d1 += d2
        d.observe(a, b)
        return d.to_dict(), d1.to_dict()
    d, _ = _same(run)
    np.testing.assert_allclose(np.asarray(d["sum"]) / d["n"],
                               [a.mean(), b.mean()], rtol=1e-9)


def test_groupby():
    def run(st, *_):
        g = st.GroupByStat("cat", "Count()")
        g.observe(np.array(["a", "b", "a", "a"], dtype=object))
        g.observe(np.array(["b"], dtype=object))
        rt = st.from_dict(g.to_dict())
        return g.to_dict(), g.groups["a"].count, rt.groups["a"].count
    assert _same(run)[1:] == (3, 3)


def test_dsl_roundtrip():
    specs = ['Count()', 'MinMax("dtg")', 'Enumeration("name")',
             'TopK("name")', 'Frequency("name",12)',
             'Histogram("val",20,0.0,100.0)', 'Z2Histogram("geom",5)',
             'Z3Histogram("dtg","week")', 'DescriptiveStats("a","b")',
             'GroupBy("cat",Count())', "Count();MinMax('val')",
             'GroupBy("name",Count();MinMax("val"))']

    def run(_st, dsl, *_):
        out = []
        for spec in specs:
            stat = dsl.parse_stat(spec)
            again = dsl.parse_stat(stat.spec())
            out.append((stat.kind, stat.spec(), again.spec(), stat.attrs,
                        stat.to_dict()))
        return out
    _same(run)
    with pytest.raises(ValueError):
        tdsl.parse_stat("Nope()")


def test_observe_table(stores):
    js, ts = stores

    def run(_st, dsl, *_, store):
        seq = dsl.parse_stat('Count();MinMax("val");Enumeration("name")')
        dsl.observe_table(seq, store.tables["pts"])
        return seq.to_dict()
    a, b = run(*SIDES["jax"], store=js), run(*SIDES["torch"], store=ts)
    assert a == b
    assert b["stats"][0]["count"] == len(ts.tables["pts"])
    assert b["stats"][1]["min"] == int(np.min(ts.tables["pts"].columns["val"]))


# -- the store's battery and the GeoMesaStats API ----------------------------


def test_store_stats_api(stores):
    js, ts = stores
    a, b = js.stats("pts"), ts.stats("pts")
    assert a.to_dict() == b.to_dict()
    n = len(ts.tables["pts"])
    assert b.get_count() == a.get_count() == n
    assert b.get_count(exact=True) == a.get_count(exact=True) == n
    assert b.get_bounds() == a.get_bounds()
    x, y = ts.tables["pts"].geometry().point_xy()
    assert (b.get_bounds()[0], b.get_bounds()[3]) == (x.min(), y.max())
    assert b.get_min_max("val").to_dict() == a.get_min_max("val").to_dict()
    assert b.get_top_k("name").topk(1)[0][0] == "alpha"
    assert b.get_top_k("name").to_dict() == a.get_top_k("name").to_dict()
    assert b.get_frequency("name").to_dict() \
        == a.get_frequency("name").to_dict()
    assert b.get_enumeration("name").to_dict() \
        == a.get_enumeration("name").to_dict()


@pytest.mark.parametrize("ecql", [
    "BBOX(geom, -20, 5, 40, 35)",
    "BBOX(geom, -20, 5, 40, 35) AND "
    "dtg DURING 2020-01-07T00:00:00Z/2020-01-14T00:00:00Z",
    "dtg > 2020-01-07T00:00:00Z",
    "dtg < 2020-01-10T00:00:00Z",
    "name = 'gamma'", "name <> 'alpha'", "name IN ('beta', 'delta', 'zz')",
    "val < 100", "val >= 900", "score > 55",
    "BBOX(geom, -20, 5, 40, 35) OR val < 10",
    "NOT (val < 500)", "INCLUDE", "EXCLUDE",
    "IN ('pts.1', 'pts.2')",
])
def test_estimated_count_close(stores, ecql):
    """The estimator (and so get_count) equals the reference's for each
    shape; the reference test's error envelopes hold for the box and the
    box+window."""
    js, ts = stores
    a, b = js.stats("pts"), ts.stats("pts")
    assert b.get_count(ecql) == a.get_count(ecql)
    assert b.estimator.selectivity(tparse(ecql)) \
        == a.estimator.selectivity(jparse(ecql))
    exact = b.get_count(ecql, exact=True)
    assert exact == a.get_count(ecql, exact=True)
    if ecql == "BBOX(geom, -20, 5, 40, 35)":
        assert abs(b.get_count(ecql) - exact) / exact < 0.25


def test_estimated_spatiotemporal(stores):
    js, ts = stores
    ecql = ("BBOX(geom, -20, 5, 40, 35) AND "
            "dtg DURING 2020-01-07T00:00:00Z/2020-01-14T00:00:00Z")
    est = ts.stats("pts").get_count(ecql)
    exact = ts.stats("pts").get_count(ecql, exact=True)
    assert est == js.stats("pts").get_count(ecql)
    assert exact > 0 and abs(est - exact) / exact < 0.35


def test_estimator_selectivities_equal(stores):
    """spatial/temporal/equality/range selectivities of the Z3 plan's
    boxes and intervals, the cost-based choice's prices."""
    js, ts = stores
    a, b = js.stats("pts").estimator, ts.stats("pts").estimator
    q = ("BBOX(geom, -20, 5, 40, 35) AND "
         "dtg DURING 2020-01-07T00:00:00Z/2020-01-14T00:00:00Z")
    jp, tp = js.planner("pts").plan(q), ts.planner("pts").plan(q)
    assert tp.explain["boxes"] == jp.explain["boxes"]
    assert b.spatial_selectivity(tp.explain["boxes"]) \
        == a.spatial_selectivity(jp.explain["boxes"])
    assert b.temporal_selectivity(tp.explain["intervals"]) \
        == a.temporal_selectivity(jp.explain["intervals"])
    for boxes in ([(-180, -90, 180, 90)], [(0, 0, 0, 0)],
                  [(-20, 5, 40, 35), (100, -10, 120, 10)]):
        assert b.spatial_selectivity(boxes) == a.spatial_selectivity(boxes)
    for v in ("alpha", "delta", "nope"):
        assert b.equality_selectivity("name", v) \
            == a.equality_selectivity("name", v)
    assert b.equality_selectivity("val", 7) == a.equality_selectivity("val", 7)
    assert b.range_selectivity("val", 10, 500) \
        == a.range_selectivity("val", 10, 500)


def test_exact_stat_scan_filtered(stores):
    js, ts = stores
    e = ts.stats("pts").run_stat('Enumeration("name")', "val < 100")
    assert e.to_dict() == js.stats("pts").run_stat(
        'Enumeration("name")', "val < 100").to_dict()
    assert sum(e.counts.values()) == ts.count("pts", "val < 100")


def test_histogram_api(stores):
    js, ts = stores
    h = ts.stats("pts").get_histogram("val", bins=10)
    assert h.to_dict() == js.stats("pts").get_histogram("val",
                                                        bins=10).to_dict()
    assert int(h.counts.sum()) == len(ts.tables["pts"])
    q = "BBOX(geom, -20, 5, 40, 35)"
    assert ts.stats("pts").get_histogram("val", 7, q).to_dict() \
        == js.stats("pts").get_histogram("val", 7, q).to_dict()
    assert ts.stats("pts").get_min_max("dtg", q, exact=True).to_dict() \
        == js.stats("pts").get_min_max("dtg", q, exact=True).to_dict()
    assert ts.stats("pts").get_bounds(q, exact=True) \
        == js.stats("pts").get_bounds(q, exact=True)


def test_cost_based_decider_runs(stores):
    """With the battery the planner prices its plans; the port's one index
    plans Z3, as the reference's choice does, and a second index (the same
    class twice) goes through the pricing path."""
    js, ts = stores
    q = ("BBOX(geom, -20, 5, 40, 35) AND "
         "dtg DURING 2020-01-07T00:00:00Z/2020-01-14T00:00:00Z")
    assert ts.planner("pts").plan(q).index.name == "z3"
    assert js.planner("pts").plan(q).index.name == "z3"
    tp = ts.planner("pts")
    assert tp.stats is ts.stats("pts") and tp.stats.total > 0
    from geomesa_tpu_torch.index.planner import QueryPlanner
    twin = QueryPlanner(tp.sft, tp.table, [tp.indexes[0], tp.indexes[0]],
                        stats=tp.stats)
    plan = twin.plan(q)
    assert plan.index is tp.indexes[0]
    assert twin.count(q) == tp.count(q) == js.count("pts", q)


def test_one_sided_dtg_estimate_fast(stores):
    import time
    js, ts = stores
    s = ts.stats("pts")
    t0 = time.perf_counter()
    est = s.get_count("dtg > 2020-01-07T00:00:00Z")
    assert time.perf_counter() - t0 < 2.0
    assert est == js.stats("pts").get_count("dtg > 2020-01-07T00:00:00Z")
    exact = s.get_count("dtg > 2020-01-07T00:00:00Z", exact=True)
    assert abs(est - exact) / exact < 0.15


def test_remove_and_recreate_schema():
    """The reference re-creates a removed schema; the port has no
    ``remove_schema`` (ROADMAP Queue 1 item 10), so each schema is a fresh
    store's: its battery observes its own rows only."""
    out = []
    for store in (TpuDataStore(),
                  DataStoreFinder.get_data_store(type="torch",
                                                 device="cpu")):
        tbl = jtable if isinstance(store, TpuDataStore) else ttable
        store.create_schema("t", "other:Int,*geom:Point")
        store.load("t", tbl.FeatureTable.build(
            store.get_schema("t"), {"other": [2], "geom": ([1.0], [1.0])}))
        out.append(store.stats("t").to_dict())
        assert store.stats("t").get_min_max("other").min == 2
    assert out[0] == out[1]


def test_histogram_on_string_returns_none(stores):
    js, ts = stores
    assert ts.stats("pts").get_histogram("name") is None
    assert js.stats("pts").get_histogram("name") is None


def test_groupby_seq_substat(stores):
    js, ts = stores

    def run(_st, dsl, *_, store):
        g = dsl.parse_stat('GroupBy("name",Count();MinMax("val"))')
        dsl.observe_table(g, store.tables["pts"])
        return g.to_dict()
    a, b = run(*SIDES["jax"], store=js), run(*SIDES["torch"], store=ts)
    assert a == b
    total = sum(sub["stats"][0]["count"] for _, sub in b["groups"])
    assert total == len(ts.tables["pts"])


def test_stats_persistence_roundtrip(stores):
    js, ts = stores
    s = ts.stats("pts")
    rt = TStats.from_dict(ts.get_schema("pts"), s.to_dict(),
                          planner=s.planner)
    assert rt.total == s.total
    assert rt.get_bounds() == s.get_bounds()
    assert rt.to_dict() == js.stats("pts").to_dict()


# -- sketches after observe and after merge ----------------------------------


def _columns(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "int":
        return (rng.integers(-50, 50, n),)
    if kind == "float":
        return (np.where(rng.random(n) < 0.1, 0.0, rng.normal(0, 1e3, n)),)
    if kind == "str":
        return (rng.choice(["a", "bb", "c c", "é", ""], n).astype(object),)
    if kind == "xy":
        return rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    if kind == "bbox":
        x, y = rng.uniform(-170, 170, n), rng.uniform(-80, 80, n)
        return x, y, x + rng.uniform(0, 5, n), y + rng.uniform(0, 5, n)
    raise ValueError(kind)


SKETCHES = [
    ("MinMax", "int"), ("MinMax", "float"), ("MinMax", "str"),
    ("MinMaxGeo", "bbox"), ("Enumeration", "int"), ("Enumeration", "str"),
    ("TopK", "int"), ("TopK", "str"), ("Frequency", "int"),
    ("Frequency", "float"), ("Frequency", "str"), ("Histogram", "float"),
    ("Histogram", "int"), ("Z2Histogram", "xy"), ("Descriptive", "float"),
    ("GroupBy", "str"),
]


def _sketch(st, name):
    return {"MinMax": lambda: st.MinMaxStat("a"),
            "MinMaxGeo": lambda: st.MinMaxStat("a", geometric=True),
            "Enumeration": lambda: st.EnumerationStat("a"),
            "TopK": lambda: st.TopKStat("a"),
            "Frequency": lambda: st.FrequencyStat("a", 8),
            "Histogram": lambda: st.HistogramStat("a", 16, -40.0, 40.0),
            "Z2Histogram": lambda: st.Z2HistogramStat("a", 4),
            "Descriptive": lambda: st.DescriptiveStat(["a"]),
            "GroupBy": lambda: st.GroupByStat("a", "Count()")}[name]()


@pytest.mark.parametrize("name,kind", SKETCHES)
@pytest.mark.parametrize("n", [0, 1, 3000])
def test_sketch_dicts_after_observe_and_merge(name, kind, n):
    cols1, cols2 = _columns(kind, n, 1), _columns(kind, 777, 2)

    def run(st, *_):
        a, b = _sketch(st, name), _sketch(st, name)
        a.observe(*cols1)
        b.observe(*cols2)
        first = a.to_dict()
        a += b
        c = a + b
        return first, a.to_dict(), c.to_dict(), st.from_dict(
            a.to_dict()).to_dict()
    out = _same(run)
    assert out[1] == out[3]


def test_chunked_observes_over_threads(monkeypatch):
    """Columns past ``_CHUNK`` rows observe in chunks over the thread pool
    (MinMax registers, Z2 cells, Z3 tables) and a narrow integer range
    hashes its distinct values: the same dicts as the reference's one
    pass."""
    monkeypatch.setattr(tsk, "_CHUNK", 997)
    monkeypatch.setattr(tsk.Z3HistogramStat, "_SPAN", 2)
    rng = np.random.default_rng(9)
    n = 10_000
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    ints = rng.integers(5, 60, n).astype(np.int32)
    wide = rng.integers(-2**40, 2**40, n)
    ms = BASE + rng.integers(0, 90 * 86400000, n)

    def run(st, *_):
        bt = jbt if st is jst else tbt
        out = []
        for sketch, cols in ((st.MinMaxStat("a", geometric=True),
                              (x, y, x, y)),
                             (st.MinMaxStat("a"), (ints,)),
                             (st.MinMaxStat("a"), (wide,)),
                             (st.MinMaxStat("a"), (x,)),
                             (st.Z2HistogramStat("a", 5), (x, y))):
            sketch.observe(*cols)
            out.append(sketch.to_dict())
        period = bt.TimePeriod.parse("week")
        z3 = st.Z3HistogramStat("dtg", "week")
        z3.observe(*bt.time_to_binned_time(ms, period),
                   bt.max_offset(period))
        out.append(z3.to_dict())
        out.append(list(z3.bins))
        return out
    _same(run)


def _string_tables(vocab_kind: str):
    """(reference table, port table) over one dictionary-encoded column
    and points."""
    rng = np.random.default_rng(11)
    n = {"one_row": 1, "empty": 0}.get(vocab_kind, 4000)
    if vocab_kind == "all_equal":
        vocab, codes = ["same"], np.zeros(n, np.int32)
    elif vocab_kind == "unsorted":
        # unsorted, an unused entry, a string twice
        vocab = ["pear", "apple", "unused", "fig", "apple"]
        codes = rng.choice([0, 1, 3, 4], n).astype(np.int32)
    else:
        vocab = ["a", "b", "c", "d", "e", "f"]
        codes = rng.integers(0, len(vocab), n).astype(np.int32)
    cols = {"val": rng.integers(0, 50, n).astype(np.int32),
            "dtg": BASE + rng.integers(0, 20 * 86400000, n),
            "geom": (rng.uniform(-60, 60, n), rng.uniform(-40, 40, n))}
    spec = "name:String,val:Int,dtg:Date,*geom:Point"
    out = []
    for tbl, sft in ((jtable, JSFT), (ttable, TSFT)):
        c = dict(cols, name=tbl.StringColumn(codes.copy(), list(vocab)))
        out.append(tbl.FeatureTable.build(sft.from_spec("t", spec), c))
    return out


@pytest.mark.parametrize("vocab_kind", ["repeated", "all_equal", "one_row",
                                        "empty", "unsorted"])
def test_battery_over_coded_strings(vocab_kind):
    """The battery (and the order-free kinds, a GroupBy) observed through a
    StringColumn's codes equal the reference's observe over decoded
    rows."""
    jt, tt = _string_tables(vocab_kind)
    a, b = JStats(jt.sft), TStats(tt.sft)
    a.update(jt)
    b.update(tt)
    assert list(a.to_dict()) == list(b.to_dict())
    assert a.to_dict() == b.to_dict()
    spec = ('Enumeration("name");TopK("name");Frequency("name",6);'
            'MinMax("name");GroupBy("name",Count();MinMax("val"))')
    sa, sb = jdsl.parse_stat(spec), tdsl.parse_stat(spec)
    jdsl.observe_table(sa, jt)
    tdsl.observe_table(sb, tt)
    assert sa.to_dict() == sb.to_dict()
    mask = np.arange(len(jt)) % 3 == 0
    sa, sb = jdsl.parse_stat(spec), tdsl.parse_stat(spec)
    jdsl.observe_table(sa, jt, mask)
    tdsl.observe_table(sb, tt, mask)
    assert sa.to_dict() == sb.to_dict()


def test_battery_update_side_by_side(monkeypatch):
    """A table past 2^20 rows observes the battery's sketches side by side
    on threads: dicts and their order equal the reference's."""
    from geomesa_tpu_torch.stats import store as tstore
    jt, tt = _string_tables("repeated")
    monkeypatch.setattr(tstore, "_SIDE_BY_SIDE", 0)
    a, b = JStats(jt.sft), TStats(tt.sft)
    a.update(jt)
    b.update(tt)
    assert list(a.to_dict().items()) == list(b.to_dict().items())
    assert b.update_s > 0


# -- carrying the battery ----------------------------------------------------


def test_reference_battery_into_port(stores):
    """The reference's ``to_dict()`` restored in the port (``from_dict``
    and ``load(stats_cached=)``) estimates as the reference's."""
    js, ts = stores
    d = js.stats("pts").to_dict()
    rt = TStats.from_dict(ts.get_schema("pts"), d)
    qs = ["BBOX(geom, -20, 5, 40, 35)", "val < 100", "name = 'beta'",
          "dtg DURING 2020-01-07T00:00:00Z/2020-01-14T00:00:00Z"]
    for q in qs:
        assert rt.estimator.estimate_count(tparse(q)) \
            == js.stats("pts").estimator.estimate_count(jparse(q))
    store = DataStoreFinder.get_data_store(type="torch", device="cpu")
    store.create_schema("pts", SPEC)
    cached = {spec: tsk.from_dict(sd) for spec, sd in d.items()}
    store.load("pts", ttable.FeatureTable.build(
        store.get_schema("pts"), _data(500, 3)), stats_cached=cached)
    s = store.stats("pts")
    assert s.cached is cached and s.to_dict() == d
    for q in qs:
        assert s.get_count(q) == js.stats("pts").get_count(q)
    # a later load carrying a battery flushes through with it
    store.load("pts", ttable.FeatureTable.build(
        store.get_schema("pts"), _data(300, 4)), stats_cached=cached)
    assert store.deltas["pts"] is None and len(store.tables["pts"]) == 800
    assert store.stats("pts").cached is cached


def test_store_battery_lifecycle():
    """After a load both batteries are the whole table's; a flush by the
    merge build carries the pre-flush battery over (the same sketches);
    a full rebuild (remove) observes the survivors afresh."""
    js = TpuDataStore()
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    first, more = _data(6000, 21), _data(1000, 22)
    for s, tbl in ((js, jtable), (ts, ttable)):
        s.create_schema("p", SPEC)
        s.load("p", tbl.FeatureTable.build(s.get_schema("p"), first))
    assert ts.stats("p").to_dict() == js.stats("p").to_dict()
    before = ts.stats("p").cached
    for s, tbl in ((js, jtable), (ts, ttable)):
        s.load("p", tbl.FeatureTable.build(s.get_schema("p"), more))
        assert s.deltas["p"] is not None
        s.flush("p")
    assert ts.stats("p").cached is before
    assert ts.stats("p").to_dict() == js.stats("p").to_dict()
    assert ts.stats("p").total == 6000       # carried, not re-observed
    for s in (js, ts):
        assert s.remove_features("p", "val < 100") > 0
    assert ts.stats("p").cached is not before
    assert ts.stats("p").to_dict() == js.stats("p").to_dict()
    assert ts.stats("p").total == len(ts.tables["p"])


@pytest.mark.parametrize("flushes", [0, 1, 2])
def test_store_battery_deferred_to_first_read(flushes):
    """A build leaves the battery to its first read: the load, a count and
    a query observe nothing; merge-build flushes before that read carry
    the deferred observe over the pre-flush rows; the read then gives the
    reference's sketches (eager in the reference)."""
    js = TpuDataStore()
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    first = _data(6000, 31)
    for s, tbl in ((js, jtable), (ts, ttable)):
        s.create_schema("p", SPEC)
        s.load("p", tbl.FeatureTable.build(s.get_schema("p"), first))
    assert not ts._stats["p"].observed
    assert ts.count("p", "BBOX(geom, -20, 5, 40, 35)") \
        == js.count("p", "BBOX(geom, -20, 5, 40, 35)")
    assert len(ts.query("p", "val < 300").indices) \
        == len(js.query("p", "val < 300").indices)
    for k in range(flushes):
        for s, tbl in ((js, jtable), (ts, ttable)):
            s.load("p", tbl.FeatureTable.build(s.get_schema("p"),
                                               _data(1000, 32 + k)))
            s.flush("p")
        assert not ts._stats["p"].observed      # carried, still deferred
    assert len(ts.tables["p"]) == 6000 + 1000 * flushes
    battery = ts.stats("p")
    assert battery.total == 6000 and battery.observed
    assert battery.to_dict() == js.stats("p").to_dict()
    for q in ("BBOX(geom, -20, 5, 40, 35)", "name = 'beta'"):
        assert battery.get_count(q) == js.stats("p").get_count(q)


def test_carried_battery_frees_the_old_generation():
    """Merge-build flushes that carry an unobserved battery keep no
    reference to the pre-flush battery, its planner or its table: after
    two such flushes with no read, the first planner is freed; the read
    still gives the first load's sketches."""
    import gc
    import weakref
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    ts.create_schema("p", SPEC)
    ts.load("p", ttable.FeatureTable.build(ts.get_schema("p"),
                                           _data(6000, 41)))
    first = weakref.ref(ts.planner("p"))
    first_table = weakref.ref(ts.tables["p"])
    for k in range(2):
        ts.load("p", ttable.FeatureTable.build(ts.get_schema("p"),
                                               _data(1000, 42 + k)))
        ts.flush("p")
        assert ts.deltas["p"] is None and not ts._stats["p"].observed
    gc.collect()
    assert first() is None and first_table() is None
    assert ts.stats("p").total == 6000


def test_degraded_count_equals_reference(stores):
    """The scheduler's degraded count (``degrade.estimate``) prices the
    store planner's counts, as the reference's does, once the battery is
    observed (before that it declines: ``test_torch_scheduler.py``)."""
    js, ts = stores
    assert ts.stats("pts").total > 0    # the first read observes it
    for q in ("BBOX(geom, -20, 5, 40, 35)", "val < 300",
              "BBOX(geom, -20, 5, 40, 35) AND "
              "dtg DURING 2020-01-07T00:00:00Z/2020-01-14T00:00:00Z"):
        a = jdegrade.estimate(js.planner("pts"), jparse(q), "deadline")
        b = tdegrade.estimate(ts.planner("pts"), tparse(q), "deadline")
        assert b is not None and tdegrade.is_approximate(b)
        assert int(b) == int(a) and b.reason == a.reason
    assert tdegrade.eligible(ts.planner("pts"))
