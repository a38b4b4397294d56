"""Feature-id lookups in the port (geomesa_tpu_torch) against the JAX
package: ``IN ('id', ...)`` alone (the id plan: the rows whose fids are
listed, ascending), ANDed with a box and a time window (a host residual
over the box's candidates), under auths, over explicit and implicit
(``str(row)``) ids, through the store with a pending delta, prepared
queries and the scheduler. Counts, row ids in order and fids must equal
the reference's. The port runs with device="cpu"."""

import numpy as np
import pytest

from geomesa_tpu import config as jconfig
from geomesa_tpu.datastore import TpuDataStore
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.features.table import FeatureTable as JTable
from geomesa_tpu.filter.evaluate import evaluate as jevaluate
from geomesa_tpu.filter.parser import parse_ecql as jparse
from geomesa_tpu.index.planner import QueryPlanner as JPlanner
from geomesa_tpu.index.spatial import Z3Index as JZ3
from geomesa_tpu_torch import DataStoreFinder
from geomesa_tpu_torch import config as tconfig
from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.filter.evaluate import evaluate as tevaluate
from geomesa_tpu_torch.filter.parser import parse_ecql as tparse
from geomesa_tpu_torch.index.planner import QueryPlanner as TPlanner
from geomesa_tpu_torch.index.spatial import Z3Index as TZ3

SPEC = "age:Int,dtg:Date,*geom:Point;geomesa.z3.interval=week"
BOX = "BBOX(geom,-60,-30,60,30)"
DURING = "dtg DURING 2020-01-03T00:00:00Z/2020-01-15T00:00:00Z"


@pytest.fixture(autouse=True)
def _small_blocks():
    from geomesa_tpu.index import prune
    vars(prune).pop("BLOCK_SIZE", None)
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.set(512)
    yield
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.unset()


def _columns(n, seed):
    rng = np.random.default_rng(seed)
    base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
    return {"age": rng.integers(0, 100, n).astype(np.int32),
            "dtg": base + rng.integers(0, 30 * 86400000, n),
            "geom": (rng.uniform(-170, 170, n), rng.uniform(-80, 80, n))}


def _planners(n, seed, explicit, vis=None):
    cols = _columns(n, seed)
    fids = [f"t.{i * 7 + 3}" for i in range(n)] if explicit else None
    jsft, tsft = JSFT.from_spec("f", SPEC), TSFT.from_spec("f", SPEC)
    jt = JTable.build(jsft, cols, fids=fids, visibilities=vis)
    tt = TTable.build(tsft, cols, fids=fids, visibilities=vis)
    return (JPlanner(jsft, jt, [JZ3(jsft, jt)]),
            TPlanner(tsft, tt, [TZ3(tsft, tt, "cpu")]))


def _in(fids) -> str:
    return "IN (" + ", ".join(f"'{f}'" for f in fids) + ")"


def _drawn(n, k, seed, explicit):
    """k seed-drawn ids of the table, and a few that are not in it."""
    rows = np.random.default_rng(seed).choice(n, k, replace=False)
    ids = [f"t.{r * 7 + 3}" if explicit else str(r) for r in rows]
    return ids + ["t.4", "nope", "-1", "007", str(n + 5)]


@pytest.mark.parametrize("explicit", [True, False],
                         ids=["explicit", "implicit"])
@pytest.mark.parametrize("shape", ["alone", "box", "box_time"])
@pytest.mark.parametrize("auths", [None, ["admin"], []], ids=str)
def test_fid_lookup_equals_reference(explicit, shape, auths):
    n = 6000
    vis = np.random.default_rng(2).choice(["", "admin", "ops"], n)
    jp, tp = _planners(n, 1, explicit, vis)
    q = _in(_drawn(n, 1000, 3, explicit))
    if shape != "alone":
        q = f"{q} AND {BOX}" + (f" AND {DURING}" if shape == "box_time"
                                else "")
    want = jp.select_indices(q, auths=auths)
    got = tp.select_indices(q, auths=auths)
    assert np.array_equal(got, want)
    assert np.all(np.diff(got) > 0)
    assert tp.count(q, auths=auths) == jp.count(q, auths=auths) == len(got)
    if shape == "alone":
        plan = tp.plan(q)
        assert plan.primary_kind == "fid" and plan.explain["index"] == "id"
        assert len(got) == (1000 if auths is None else
                            int(np.isin(vis[got], ["", "admin"]
                                        if auths else [""]).sum()))
    res = tp.query(q, auths=auths)
    assert list(map(str, res.table.fids)) \
        == list(map(str, jp.query(q, auths=auths).table.fids))


def test_fid_evaluate_equals_reference():
    n = 500
    for explicit in (True, False):
        jp, tp = _planners(n, 4, explicit)
        f = _in(_drawn(n, 40, 5, explicit))
        assert np.array_equal(tevaluate(tparse(f), tp.table),
                              jevaluate(jparse(f), jp.table))
        sub = np.array([3, 1, 400, 3, 77])
        from geomesa_tpu_torch.filter.evaluate import evaluate_at
        want = jevaluate(jparse(f), jp.table)[sub]
        assert np.array_equal(evaluate_at(tparse(f), tp.table, sub), want)


def test_fid_prepared_and_scheduled():
    n = 6000
    jp, tp = _planners(n, 6, True)
    q = _in(_drawn(n, 50, 7, True))
    pq = tp.prepare(q)
    assert not pq.device_exact
    assert pq.count() == jp.prepare(q).count() == 50
    assert np.array_equal(pq.select_indices(), jp.select_indices(q))


def test_store_fid_lookup_with_delta_and_writer():
    js = TpuDataStore()
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    lsm = "v:Int,dtg:Date,*geom:Point;geomesa.z3.interval=week"
    for store, tbl in ((js, JTable), (ts, TTable)):
        store.create_schema("t", lsm)
        c = _columns(6000, 8)
        store.load("t", tbl.build(store.get_schema("t"), {
            "v": c["age"], "dtg": c["dtg"], "geom": c["geom"]}))
        with store.get_writer("t") as w:
            for i in range(20):
                w.write(v=i, dtg=np.datetime64("2020-01-05"),
                        geom=f"POINT ({i} {i})",
                        vis="secret" if i % 2 else "")
    assert ts.deltas["t"] is not None
    q = "IN ('t.3', 't.4', '17', '5999', '6000', 'zz')"
    for auths in (None, [], ["secret"]):
        assert ts.count("t", q, auths=auths) == js.count("t", q, auths=auths)
        got, want = ts.query("t", q, auths=auths), js.query("t", q,
                                                              auths=auths)
        assert np.array_equal(got.indices, want.indices)
        assert list(map(str, got.table.fids)) \
            == list(map(str, want.table.fids))
        assert ts.count_many("t", [q], auths=auths) \
            == [js.count("t", q, auths=auths)]
    ts.close()
