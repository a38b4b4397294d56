"""The port's S2 curve and S2/S3 indexes against the JAX package, on
``tests/test_s2.py``'s inputs (its seeds and distributions; the index
layers cut to a few thousand rows):

- ``curves/s2.py`` (a copy of the reference's): the Hilbert position and
  its inverse, cell ids, ``invert``, and the range covers of random,
  polar and antimeridian boxes — bit for bit the reference's;
- ``S2Index``/``S3Index``: sorted keys, permutation, the planner's index,
  candidate blocks, counts and row ids (and numpy's brute force), on the
  planner and through both stores (``geomesa.indices=s2``/``s3``), with
  appends, a flush by the merge build, and the full-scan index the
  reference builds beside them;
- the cost model's tie: with S2 and Z2 both configured and equal
  selectivities, both packages pick the Z cover (S2's ``cover_slop``).

Tolerance: none — ids, ranges, permutations, counts and rows compare
exactly. The port runs with device="cpu" (the plain versions).
"""

import numpy as np
import pytest

from geomesa_tpu import config as jconfig
from geomesa_tpu.curves import s2 as js2
from geomesa_tpu.datastore import TpuDataStore
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.features.table import FeatureTable as JTable
from geomesa_tpu.index import prune as jprune
from geomesa_tpu.index.planner import QueryPlanner as JPlanner
from geomesa_tpu.index import spatial as jspatial
from geomesa_tpu.stats.store import GeoMesaStats as JStats
from geomesa_tpu_torch import DataStoreFinder
from geomesa_tpu_torch import config as tconfig
from geomesa_tpu_torch.curves import s2 as ts2
from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.index import spatial as tspatial
from geomesa_tpu_torch.index.planner import QueryPlanner as TPlanner
from geomesa_tpu_torch.stats.store import GeoMesaStats as TStats

BOX = "BBOX(geom, -8, 20, 12, 40)"
WEEK = "dtg DURING 2020-01-05T00:00:00Z/2020-01-12T00:00:00Z"


@pytest.fixture(autouse=True)
def small_blocks():
    for k in ("BLOCK_SIZE", "PRUNE_MAX_FRACTION"):
        vars(jprune).pop(k, None)
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.set(256)
        c.PRUNE_MAX_FRACTION.set(1.0)
    yield
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.unset()
        c.PRUNE_MAX_FRACTION.unset()
        c.MERGE_BUILD.unset()


# -- the curve -----------------------------------------------------------------


def test_hilbert_positions_equal_reference():
    rng = np.random.default_rng(1)
    i = rng.integers(0, 1 << 30, 5000)
    j = rng.integers(0, 1 << 30, 5000)
    pos = ts2.hilbert_pos(i, j)
    assert np.array_equal(pos, js2.hilbert_pos(i, j))
    for a, b in zip(ts2.hilbert_ij(pos), js2.hilbert_ij(pos)):
        assert np.array_equal(a, b)
    p8 = np.arange(1 << 16)
    for a, b in zip(ts2.hilbert_ij(p8, 8), js2.hilbert_ij(p8, 8)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("lenient", [False, True])
def test_cell_ids_and_invert_equal_reference(lenient):
    rng = np.random.default_rng(2)
    lon = rng.uniform(-180, 180, 20000)
    lat = rng.uniform(-90, 90, 20000)
    # the domain's corners, the poles and the antimeridian
    lon[:6] = [-180.0, 180.0, 0.0, 0.0, 179.99999999999997, -180.0]
    lat[:6] = [-90.0, 90.0, 90.0, -90.0, 0.0, 45.0]
    tid = ts2.S2SFC.apply().index(lon, lat, lenient=lenient)
    jid = js2.S2SFC.apply().index(lon, lat, lenient=lenient)
    assert tid.dtype == jid.dtype and np.array_equal(tid, jid)
    assert np.array_equal(ts2.cell_id(lon, lat), js2.cell_id(lon, lat))
    for a, b in zip(ts2.S2SFC.apply().invert(tid),
                    js2.S2SFC.apply().invert(jid)):
        assert np.array_equal(a, b)


def _boxes():
    rng = np.random.default_rng(3)
    out = []
    for _ in range(25):
        xmin = rng.uniform(-175, 150)
        ymin = rng.uniform(-85, 60)
        out.append([(xmin, ymin, xmin + rng.uniform(0.05, 30),
                     ymin + rng.uniform(0.05, 25))])
    out += [[(-180.0, 85.0, 180.0, 90.0)], [(-180.0, -90.0, 180.0, -88.0)],
            [(176.0, -10.0, 180.0, 10.0)], [(-180.0, -5.0, -176.0, 5.0)],
            [(-8.0, 20.0, 12.0, 40.0), (30.0, -10.0, 31.0, -9.0)]]
    return out


@pytest.mark.parametrize("max_ranges", [None, 16, 2000])
def test_ranges_equal_reference(max_ranges):
    for boxes in _boxes():
        kw = {} if max_ranges is None else {"max_ranges": max_ranges}
        got = ts2.S2SFC.apply().ranges(boxes, **kw)
        want = js2.S2SFC.apply().ranges(boxes, **kw)
        assert [(r.lower, r.upper, r.contained) for r in got] \
            == [(r.lower, r.upper, r.contained) for r in want], boxes


# -- the indexes ----------------------------------------------------------------


def _points(n, seed):
    rng = np.random.default_rng(seed)
    x = np.clip(rng.normal(0, 50, n), -180, 180)
    y = np.clip(rng.normal(0, 25, n), -90, 90)
    base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
    dtg = base + rng.integers(0, 30 * 86400000, n)
    val = rng.integers(0, 100, n).astype(np.int32)
    return x, y, dtg, val


SPECS = {
    "s2": "val:Int,*geom:Point;geomesa.indices=s2",
    "s3": "val:Int,dtg:Date,*geom:Point;geomesa.indices=s3,"
          "geomesa.z3.interval=week",
}
QUERIES = {
    "s2": [BOX, f"{BOX} AND val > 40", "BBOX(geom, 170, -10, 180, 10)",
           "INTERSECTS(geom, POLYGON ((-10 18, 14 20, 10 42, -10 18)))",
           "val < 5", "INCLUDE"],
    "s3": [f"{BOX} AND {WEEK}", BOX, WEEK, f"{BOX} AND {WEEK} AND val < 30",
           "INTERSECTS(geom, POLYGON ((-10 18, 14 20, 10 42, -10 18))) AND "
           f"{WEEK}", "INCLUDE"],
}


def _tables(kind, n, seed):
    x, y, dtg, val = _points(n, seed)
    cols = {"val": val, "geom": (x, y)}
    if kind == "s3":
        cols["dtg"] = dtg
    jsft, tsft = JSFT.from_spec(kind, SPECS[kind]), TSFT.from_spec(
        kind, SPECS[kind])
    return (jsft, JTable.build(jsft, cols)), (tsft, TTable.build(tsft, cols))


@pytest.fixture(scope="module")
def planners():
    out = {}
    for kind in SPECS:
        (jsft, jt), (tsft, tt) = _tables(kind, 6000, 5)
        name = "S2Index" if kind == "s2" else "S3Index"
        jconfig.PRUNE_BLOCK.set(256)
        tconfig.PRUNE_BLOCK.set(256)
        try:
            ji = getattr(jspatial, name)(jsft, jt)
            ti = getattr(tspatial, name)(tsft, tt, "cpu")
        finally:
            jconfig.PRUNE_BLOCK.unset()
            tconfig.PRUNE_BLOCK.unset()
        out[kind] = (JPlanner(jsft, jt, [ji]), TPlanner(tsft, tt, [ti]))
    return out


@pytest.mark.parametrize("kind", list(SPECS))
def test_index_keys_and_permutation_equal_reference(planners, kind):
    jp, tp = planners[kind]
    ji, ti = jp.indexes[0], tp.indexes[0]
    assert ti.name == ji.name == kind
    assert tspatial.spatial_index_class(tp.sft) is type(ti)
    assert np.array_equal(ti.sorted_z, ji.sorted_z)
    assert np.array_equal(ti.host_perm, ji.perm)
    if kind == "s3":
        assert np.array_equal(ti.sorted_bins, ji.sorted_bins)
    for name, col in ti.device.columns.items():
        assert np.array_equal(col.numpy(), np.asarray(
            ji.device.columns[name])), name


@pytest.mark.parametrize("kind,q", [(k, q) for k in SPECS
                                    for q in QUERIES[k]])
def test_counts_rows_and_blocks_equal_reference(planners, kind, q):
    jp, tp = planners[kind]
    jplan, tplan = jp.plan(q), tp.plan(q)
    assert tplan.explain["index"] == jplan.explain["index"]
    jb, tb = jp._pruned_blocks(jplan), tp._pruned_blocks(tplan)
    assert (jb is None) == (tb is None)
    if jb is not None:
        assert np.array_equal(tb, jb)
    assert tp.count(q) == jp.count(q)
    assert np.array_equal(tp.select_indices(q), jp.select_indices(q))


def test_the_reference_brute_force_queries(planners):
    """``tests/test_s2.py``'s box and box-and-week queries against numpy's
    brute force on both packages."""
    x, y, dtg, _ = _points(6000, 5)
    inb = (x >= -8) & (x <= 12) & (y >= 20) & (y <= 40)
    lo = np.datetime64("2020-01-05", "ms").astype(np.int64)
    hi = np.datetime64("2020-01-12", "ms").astype(np.int64)
    for kind, q, m in (("s2", BOX, inb),
                       ("s3", f"{BOX} AND {WEEK}",
                        inb & (dtg > lo) & (dtg < hi))):
        jp, tp = planners[kind]
        assert tp._pruned_blocks(tp.plan(q)) is not None
        assert np.array_equal(tp.select_indices(q), np.flatnonzero(m))
        assert np.array_equal(jp.select_indices(q), np.flatnonzero(m))


@pytest.mark.parametrize("kind", list(SPECS))
def test_stores_with_appends_and_a_merge_flush(kind):
    """Both stores over a configured S2/S3 index: the index picked (the
    full-scan index beside it, as the reference builds it, for a plan the
    cover leaves unconstrained), counts and rows, appends into the delta,
    and a flush through ``merge_from`` that leaves the index bitwise a full
    rebuild's."""
    js = TpuDataStore()
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    for s in (js, ts):
        s.create_schema(kind, SPECS[kind])
    for k, rows in enumerate((5000, 400, 600)):
        (_, jt), (_, tt) = _tables(kind, rows, 40 + k)
        js.load(kind, jt)
        ts.load(kind, tt)
        for q in QUERIES[kind]:
            assert ts.count(kind, q) == js.count(kind, q), (k, q)
            assert np.array_equal(ts.query(kind, q).indices,
                                  js.query(kind, q).indices), (k, q)
    for s in (js, ts):
        s.flush(kind)
    for q in QUERIES[kind]:
        assert ts.explain(kind, q)["index"] == js.explain(kind, q)["index"]
        assert ts.count(kind, q) == js.count(kind, q), q
        assert np.array_equal(ts.query(kind, q).indices,
                              js.query(kind, q).indices)
    assert ts.explain(kind, "val < 5")["index"] == "full"
    merged = ts.planner(kind).indexes[0]
    assert merged.build_stages["merge_rows"] == 1000
    full = type(merged)(ts.get_schema(kind), ts.planner(kind).table, "cpu")
    assert np.array_equal(merged.perm.numpy(), full.perm.numpy())
    assert np.array_equal(merged.sorted_z, full.sorted_z)
    for name, col in full.device.columns.items():
        assert np.array_equal(merged.device.columns[name].numpy(),
                              col.numpy()), name


def test_cost_model_prefers_z_cover_on_tied_selectivity():
    """``tests/test_s2.py``'s tie: S2 and Z2 over one table with equal
    selectivities; both packages price S2's cover above Z2's and pick the
    Z cover, though S2 is listed first."""
    rng = np.random.default_rng(3)
    n = 30_000
    x = rng.uniform(-60, 60, n)
    y = rng.uniform(-60, 60, n)
    spec = "*geom:Point;geomesa.indices=s2,z2"
    q = "BBOX(geom, -10, -10, 10, 10)"
    jsft, tsft = JSFT.from_spec("both", spec), TSFT.from_spec("both", spec)
    jt, tt = JTable.build(jsft, {"geom": (x, y)}), TTable.build(
        tsft, {"geom": (x, y)})
    jstats, tstats = JStats(jsft), TStats(tsft)
    jstats.update(jt)
    tstats.update(tt)
    jp = JPlanner(jsft, jt, [jspatial.S2Index(jsft, jt),
                             jspatial.Z2Index(jsft, jt)], stats=jstats)
    tp = TPlanner(tsft, tt, [tspatial.S2Index(tsft, tt, "cpu"),
                             tspatial.Z2Index(tsft, tt, "cpu")],
                  stats=tstats)
    assert tp.explain(q)["index"] == jp.explain(q)["index"] == "z2"
    assert tp.count(q) == jp.count(q)
    assert tspatial.S2Index.cover_slop == jspatial.S2Index.cover_slop
    assert tspatial.INDEX_CLASSES[0] is tspatial.S3Index
    assert [c.name for c in tspatial.INDEX_CLASSES] \
        == [c.name for c in jspatial.INDEX_CLASSES]
