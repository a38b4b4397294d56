"""The port's write path (geomesa_tpu_torch) against the JAX package on the
inputs of the reference's own tests: the LSM delta tier
(``tests/test_lsm.py``), feature expiry and age-off
(``tests/test_age_off.py``), the modify writer (``tests/test_update_writer.py``),
upserts by fid, the scheduler's counts over a pending delta, and the lazy
fid form against the reference's materialized fids. Every count, row set,
fid set and unit density grid must equal the reference's exactly. The port
runs with device="cpu": its kernels' plain versions."""

import time

import numpy as np
import pytest

from geomesa_tpu import config as jconfig
from geomesa_tpu.datastore import TpuDataStore
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.features.sft import parse_duration_ms as jparse_duration
from geomesa_tpu.features.table import FeatureTable as JTable
from geomesa_tpu_torch import DataStoreFinder
from geomesa_tpu_torch import config as tconfig
from geomesa_tpu_torch.datastore import TorchDataStore
from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
from geomesa_tpu_torch.features.sft import parse_duration_ms
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.features.table import FidRuns
from geomesa_tpu_torch.metrics import REGISTRY as tmetrics

LSM_SPEC = "v:Int,dtg:Date,*geom:Point;geomesa.z3.interval=week"
Q = "BBOX(geom, -10, -10, 10, 10) AND v < 50"
DAY = 86_400_000


def _stores():
    return TpuDataStore(), DataStoreFinder.get_data_store(type="torch",
                                                          device="cpu")


def _both(fn):
    """fn(store, FeatureTable class) on the reference and the port."""
    js, ts = _stores()
    return fn(js, JTable), fn(ts, TTable)


def _counter(name):
    return tmetrics.snapshot()["counters"].get(name, 0)


def _same_answers(js, ts, t, queries):
    for q in queries:
        assert ts.count(t, q) == js.count(t, q), q
        jr, tr = js.query(t, q), ts.query(t, q)
        assert np.array_equal(tr.indices, jr.indices), q
        assert sorted(map(str, tr.table.fids)) \
            == sorted(map(str, jr.table.fids)), q


# -- the LSM delta tier (tests/test_lsm.py inputs) -----------------------------


def _mk(n, seed, base_day=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-30, 30, n)
    y = rng.uniform(-30, 30, n)
    base = np.datetime64("2022-01-01T00:00:00", "ms").astype(np.int64)
    dtg = base + base_day * 86400000 + rng.integers(0, 5 * 86400000, n)
    v = rng.integers(0, 100, n).astype(np.int32)
    return x, y, dtg, v


def _cols(part):
    x, y, dtg, v = part
    return {"v": v, "dtg": dtg, "geom": (x, y)}


def _lsm_store(store, build, n=200_000, seed=1):
    store.create_schema("t", LSM_SPEC)
    store.load("t", build.build(store.get_schema("t"), _cols(_mk(n, seed))))
    return store


def _append(store, build, part, **kw):
    store.load("t", build.build(store.get_schema("t"), _cols(part), **kw))


def _ref_count(parts):
    tot = 0
    for x, y, dtg, v in parts:
        tot += int(np.sum((x >= -10) & (x <= 10) & (y >= -10) & (y <= 10)
                          & (v < 50)))
    return tot


def test_delta_append_is_cheap_and_exact():
    """A 1% append lands in the delta without rebuilding the index; counts
    and stacked rows (delta rows above the main table) equal the
    reference's and numpy."""
    main = _mk(200_000, 1)
    part = _mk(2_000, 7)
    stores = _both(lambda s, b: _lsm_store(s, b))
    js, ts = stores
    idx = ts.planners["t"].indexes[0]
    gen = ts.generation("t")
    before = _counter("ingest.delta_appends")
    for s, b in zip(stores, (JTable, TTable)):
        _append(s, b, part)
    assert ts.deltas["t"] is not None and len(ts.deltas["t"]) == 2_000
    assert ts.planners["t"].indexes[0] is idx, "the append rebuilt the index"
    assert _counter("ingest.delta_appends") == before + 1
    assert ts.generation("t") == gen + 1
    want = _ref_count([main, part])
    assert ts.count("t", Q) == js.count("t", Q) == want
    r = ts.query("t", Q)
    assert np.array_equal(r.indices, js.query("t", Q).indices)
    n_main = len(ts.tables["t"])
    assert (r.indices >= n_main).sum() == _ref_count([part])
    assert len(r.table) == r.count == want
    assert r.plan.explain["stacked_rows_base"] == n_main


def test_multiple_delta_appends_then_flush():
    js, ts = _both(lambda s, b: _lsm_store(s, b, n=100_000))
    parts = [_mk(100_000, 1)]
    for i in range(3):
        parts.append(_mk(500, 20 + i))
        for s, b in ((js, JTable), (ts, TTable)):
            _append(s, b, parts[-1])
    assert len(ts.deltas["t"]) == 1500
    expected = _ref_count(parts)
    assert ts.count("t", Q) == js.count("t", Q) == expected
    merges = _counter("ingest.merge_builds")
    js.flush("t")
    ts.flush("t")
    assert ts.deltas["t"] is None and len(ts.tables["t"]) == 101_500
    assert _counter("ingest.merge_builds") == merges + 1
    assert ts.count("t", Q) == expected
    _same_answers(js, ts, "t", [Q, "v = 7", "INCLUDE"])


def test_threshold_triggers_auto_flush():
    js, ts = _both(lambda s, b: _lsm_store(s, b, n=100_000))
    part = _mk(60_000, 33)   # above the 50k floor
    flushes = _counter("ingest.flushes")
    for s, b in ((js, JTable), (ts, TTable)):
        _append(s, b, part)
    assert ts.deltas["t"] is None, "large batch should flush through"
    assert _counter("ingest.flushes") == flushes + 1
    assert len(ts.tables["t"]) == 160_000
    assert ts.count("t", Q) == js.count("t", Q) \
        == _ref_count([_mk(100_000, 1), part])


@pytest.mark.parametrize("lsm_frac", [0.02, 0.7])
def test_threshold_is_the_larger_of_floor_and_fraction(lsm_frac):
    """``max(50_000, LSM_MAX_FRACTION × main rows)``: at 0.7 a 60k batch
    on 100k rows stays in the delta."""
    tconfig.LSM_MAX_FRACTION.set(lsm_frac)
    try:
        ts = _lsm_store(_stores()[1], TTable, n=100_000)
        _append(ts, TTable, _mk(60_000, 33))
        assert (ts.deltas["t"] is not None) == (lsm_frac == 0.7)
        assert ts.count("t", "INCLUDE") == 160_000
    finally:
        tconfig.LSM_MAX_FRACTION.unset()


def test_density_hints_see_merged_state():
    """Density over main + delta without a flush: the device grid of the
    main table plus the host grid of the delta rows, equal to the
    reference's grids."""
    js, ts = _both(lambda s, b: _lsm_store(s, b, n=60_000))
    part = _mk(1_000, 41)
    for s, b in ((js, JTable), (ts, TTable)):
        _append(s, b, part)
    hint = {"density": {"bbox": (-30, -30, 30, 30), "width": 16,
                        "height": 16}}
    for q in ("INCLUDE", Q):
        g = ts.query("t", q, hints=hint)
        assert np.array_equal(g.weights, js.query("t", q, hints=hint).weights)
        assert ts.deltas["t"] is not None, "density must not flush"
    assert int(ts.query("t", "INCLUDE", hints=hint).weights.sum()) == 61_000
    assert int(ts.query("t", Q, hints=hint).weights.sum()) \
        == _ref_count([_mk(60_000, 1), part])


def test_writer_appends_take_delta_path():
    def run(store, build):
        _lsm_store(store, build, n=80_000)
        with store.get_writer("t") as w:
            fids = [w.write(v=int(i), dtg=np.datetime64("2022-01-02T00:00:00"),
                            geom="POINT (1 2)") for i in range(50)]
        return store, fids

    (js, jf), (ts, tf) = _both(run)
    assert tf == jf == [f"t.{i}" for i in range(50)]
    assert ts.deltas["t"] is not None and len(ts.deltas["t"]) == 50
    q = "BBOX(geom, 0.9, 1.9, 1.1, 2.1) AND v < 50"
    assert ts.count("t", q) == js.count("t", q) == 50
    assert sorted(map(str, ts.query("t", q).table.fids)) == sorted(jf)
    # visibility labels on written rows (once refused as ROADMAP.md
    # Queue 1 item 10), in the delta tier under auths, as the reference
    for store in (js, ts):
        with store.get_writer("t") as w:
            w.write(v=1, dtg=np.datetime64("2022-01-02"),
                    geom="POINT (1 2)", vis="secret")
    for auths in (None, [], ["secret"]):
        assert ts.count("t", q, auths=auths) == js.count("t", q, auths=auths)
    assert ts.count("t", q, auths=[]) == 50


def test_upsert_without_collision_lands_in_delta_tier():
    """A small persisted upsert of new fids (the reference's hot-tier
    persist) rides the delta path and must not rebuild the index."""
    part = _mk(200, 55)

    def run(store, build):
        _lsm_store(store, build, n=120_000)
        store.upsert("t", build.build(store.get_schema("t"), _cols(part),
                                      fids=[f"hot.{i}" for i in range(200)]))
        return store

    js, ts = _both(run)
    assert ts.deltas["t"] is not None and len(ts.deltas["t"]) == 200
    assert ts.tables["t"] is ts.planners["t"].table
    _same_answers(js, ts, "t", [Q, "v = 7"])


def test_upsert_collisions_replace_rows_exactly():
    """Colliding fids (implicit main-table ids and explicit delta ids) are
    replaced, idempotently; rows, fids and counts equal the reference's."""
    part = _mk(300, 56)
    fids = [str(k) for k in range(0, 3000, 10)]   # implicit main-table ids
    re_part = _mk(300, 57)

    def run(store, build):
        _lsm_store(store, build, n=100_000)
        _append(store, build, _mk(400, 58), fids=[f"d{i}" for i in range(400)])
        sft = store.get_schema("t")
        store.upsert("t", build.build(sft, _cols(part), fids=fids))
        store.upsert("t", build.build(sft, _cols(re_part),
                                      fids=[f"d{i}" for i in range(300)]))
        store.upsert("t", build.build(sft, _cols(re_part),
                                      fids=[f"d{i}" for i in range(300)]))
        return store

    upserts = _counter("ingest.upserts")
    js, ts = _both(run)
    assert _counter("ingest.upserts") == upserts + 3
    assert len(ts.tables["t"]) + len(ts.deltas["t"] or ()) == 100_400
    assert np.array_equal(ts.tables["t"].fids, js.tables["t"].fids)
    _same_answers(js, ts, "t", [Q, "v < 10", "INCLUDE"])


# -- age-off (tests/test_age_off.py inputs) ------------------------------------

NOW = np.datetime64("2026-07-30T00:00:00", "ms").astype(np.int64)


def _age_table(store, dtg):
    n = len(dtg)
    rng = np.random.default_rng(5)
    build = TTable if isinstance(store, TorchDataStore) else JTable
    return build.build(store.get_schema("t"), {
        "v": np.arange(n, dtype=np.int32), "dtg": np.asarray(dtg),
        "geom": (rng.uniform(-10, 10, n), rng.uniform(-10, 10, n))})


def _age_stores(expiry="dtg(7 days)"):
    out = _stores()
    for s in out:
        s.create_schema(
            "t", f"v:Int,dtg:Date,*geom:Point;geomesa.feature.expiry={expiry}")
    return out


@pytest.mark.parametrize("text", ["7 days", "30min", "500 ms", "2 hours",
                                  "1 w", "7 fortnights", "eleven days", ""])
def test_duration_grammar(text):
    try:
        want = jparse_duration(text)
    except ValueError:
        with pytest.raises(ValueError):
            parse_duration_ms(text)
        return
    assert parse_duration_ms(text) == want


@pytest.mark.parametrize("spec", [
    "v:Int,dtg:Date,*geom:Point;geomesa.feature.expiry=2 hours",
    "a:Date,b:Date,*geom:Point;geomesa.feature.expiry=b(1 day)",
    "v:Int,*geom:Point;geomesa.feature.expiry=v(1 day)",
    "v:Int,*geom:Point;geomesa.feature.expiry=1 day",
    "v:Int,dtg:Date,*geom:Point"])
def test_expiry_spec_parsing(spec):
    try:
        want = JSFT.from_spec("t", spec).feature_expiry
    except ValueError:
        with pytest.raises(ValueError):
            TSFT.from_spec("t", spec).feature_expiry
        return
    assert TSFT.from_spec("t", spec).feature_expiry == want


def test_expired_rows_dropped_at_load():
    now = int(time.time() * 1000)
    dtg = np.concatenate([np.full(50, now - 30 * DAY), np.full(70, now - DAY)])
    aged = _counter("ingest.aged_off")
    for s in _age_stores():
        s.load("t", _age_table(s, dtg))
        assert s.count("t", "INCLUDE") == 70
    assert _counter("ingest.aged_off") == aged + 50


def test_flush_ages_off_main_table():
    now = int(time.time() * 1000)
    for s in _age_stores():
        s.load("t", _age_table(s, np.full(1000, now - DAY)))
        assert s.count("t", "INCLUDE") == 1000
        assert s.age_off("t") == 0
        assert s.count("t", "INCLUDE") == 1000
        assert s.age_off("t", now_ms=now + 30 * DAY) == 1000
        assert s.count("t", "INCLUDE") == 0
        assert len(s.query("t", "INCLUDE").indices) == 0


def test_delta_flush_applies_ttl():
    now = int(time.time() * 1000)
    for s in _age_stores():
        s.load("t", _age_table(s, np.full(100_000, now - DAY)))
        s.load("t", _age_table(s, np.full(500, now - 2 * DAY)))
        assert s.deltas["t"] is not None
        assert s.count("t", "INCLUDE") == 100_500
        s.flush("t")
        assert s.count("t", "INCLUDE") == 100_500
        assert s.age_off("t", now_ms=now + 5 * DAY) == 500
        assert s.count("t", "INCLUDE") == 100_000


def test_flush_with_lapsed_rows_takes_the_full_rebuild():
    """Delta rows that lapse between their append and the flush drop at
    the flush; the drop breaks the resident run's row identity, so the
    flush rebuilds instead of merging — with the reference's answers."""
    js, ts = _age_stores("dtg(3 days)")
    merges = _counter("ingest.merge_builds")
    t_append = []
    for s in (js, ts):
        s.load("t", _age_table(s, np.full(100_000, int(time.time() * 1000)
                                          - DAY)))
        t_append.append(time.time() * 1000)
        # within the TTL at the append, past it 5 s later
        s.load("t", _age_table(s, np.full(500, int(t_append[-1]) - 3 * DAY
                                          + 5_000)))
        assert s.deltas["t"] is not None
    time.sleep(max(0.0, (max(t_append) + 5_500) / 1000 - time.time()))
    for s in (js, ts):
        s.flush("t")
        assert s.count("t", "INCLUDE") == 100_000
    assert _counter("ingest.merge_builds") == merges
    assert "merge_s" not in ts.planners["t"].indexes[0].build_stages
    _same_answers(js, ts, "t", ["INCLUDE", "v < 400"])


def test_no_expiry_schema_unaffected():
    dtg = np.full(200, np.datetime64("1999-01-01", "ms").astype(np.int64))
    for s in _stores():
        s.create_schema("t", "v:Int,dtg:Date,*geom:Point")
        s.load("t", _age_table(s, dtg))
        assert s.count("t", "INCLUDE") == 200
        assert s.age_off("t") == 0
        assert s.count("t", "INCLUDE") == 200


def test_null_dates_never_expire():
    now = int(time.time() * 1000)
    nat = np.iinfo(np.int64).min
    dtg = np.array([now - DAY, nat, now - 30 * DAY], dtype=np.int64)
    for s in _age_stores():
        s.load("t", _age_table(s, dtg))
        assert s.count("t", "INCLUDE") == 2
        assert s.age_off("t", now_ms=now + 365 * DAY) == 1
        assert s.count("t", "INCLUDE") == 1


def test_age_off_counts_delta_removals_at_now_ms():
    now = int(time.time() * 1000)
    for s in _age_stores():
        s.load("t", _age_table(s, np.full(100_000, now - DAY)))
        s.load("t", _age_table(s, np.full(300, now - 2 * DAY)))
        assert s.deltas["t"] is not None
        assert s.age_off("t", now_ms=now + 30 * DAY) == 100_300
        assert s.count("t", "INCLUDE") == 0


@pytest.mark.parametrize("name,spec", [
    ("a", "v:Int,*geom:Point;geomesa.feature.expiry=1 day"),
    ("b", "v:Int,dtg:Date,*geom:Point;geomesa.feature.expiry=v(1 day)"),
    ("c", "dtg:Date,*geom:Point;geomesa.feature.expiry=7 fortnights")])
def test_invalid_expiry_rejected_at_create_schema(name, spec):
    for s in _stores():
        with pytest.raises(ValueError):
            s.create_schema(name, spec)
        assert s.get_type_names() == []


# -- the modify writer (tests/test_update_writer.py:31-65 inputs) --------------


def _update_stores():
    rng = np.random.default_rng(13)
    n = 20_000
    x = rng.uniform(-30, 30, n)
    y = rng.uniform(-30, 30, n)
    base = np.datetime64("2023-01-01T00:00:00", "ms").astype(np.int64)
    data = {"name": rng.choice(["a", "b", "c"], n),
            "v": rng.integers(0, 100, n).astype(np.int32),
            "dtg": base + rng.integers(0, 10 * 86400000, n),
            "geom": (x, y)}
    out = _stores()
    for s, b in zip(out, (JTable, TTable)):
        s.create_schema("u", "name:String,v:Int,dtg:Date,*geom:Point")
        s.load("u", b.build(s.get_schema("u"), data))
    return out, data


@pytest.mark.parametrize("f,updates,checks", [
    ("v < 10", {"v": 999}, ["v = 999", "v < 10", "v = 50"]),
    ("name = 'a'", {"v": lambda sub: np.asarray(sub.columns["v"]) + 1000},
     ["v >= 1000", "name = 'a'"]),
    ("v > 90", {"name": "hot"}, ["name = 'hot'", "name = 'a'"]),
    ("v = 42", {"geom": "POINT (175 85)"},
     ["BBOX(geom, 170, 80, 180, 90)", "BBOX(geom, -30, -30, 30, 30)"]),
    ("v < 5", {"dtg": np.datetime64("2023-03-01T00:00:00", "ms")},
     ["dtg DURING 2023-02-28T00:00:00Z/2023-03-02T00:00:00Z"]),
])
def test_update_features_equals_reference(f, updates, checks):
    (js, ts), data = _update_stores()
    n_up = ts.update_features("u", f, updates)
    assert n_up == js.update_features("u", f, updates) > 0
    _same_answers(js, ts, "u", checks)
    jidx, tidx = js.planners["u"].indexes[0], ts.planners["u"].indexes[0]
    assert np.array_equal(np.asarray(jidx.perm), tidx.perm.numpy())
    for k, v in tidx.device.columns.items():
        assert np.array_equal(v.numpy(), np.asarray(jidx.device.columns[k]))


def test_update_with_pending_delta_flushes_first():
    (js, ts), data = _update_stores()
    part = _mk(700, 61)
    for s, b in ((js, JTable), (ts, TTable)):
        s.load("u", b.build(s.get_schema("u"), {
            "name": np.array(["z"] * 700), **_cols(part)}))
        assert s.update_features("u", "name = 'z' AND v < 30",
                                 {"v": 5}) > 0
        assert s.deltas["u"] is None
    _same_answers(js, ts, "u", ["v = 5", "name = 'z'"])


@pytest.mark.parametrize("f", ["v = 7", "name = 'b' AND v < 40",
                               "BBOX(geom, -5, -5, 5, 5)", "v > 1000"])
def test_remove_features_equals_reference(f):
    (js, ts), data = _update_stores()
    assert ts.remove_features("u", f) == js.remove_features("u", f)
    assert np.array_equal(ts.tables["u"].fids, js.tables["u"].fids)
    _same_answers(js, ts, "u", [f, "INCLUDE", "v < 50"])


# -- the scheduler over a pending delta ----------------------------------------


def test_scheduler_counts_include_the_pending_delta():
    """``count_many``/``count_future`` through the store's StoreBinding add
    each request's delta rows to its count, as the reference's scheduler
    does; the snapshot carries (planner, delta, generation, epoch)."""
    js, ts = _both(lambda s, b: _lsm_store(s, b, n=60_000))
    part = _mk(3_000, 71)
    for s, b in ((js, JTable), (ts, TTable)):
        _append(s, b, part)
    qs = [Q, "BBOX(geom, 0, 0, 20, 20)", "v = 3",
          "BBOX(geom, -30, -30, 30, 30) AND v > 90", "INCLUDE",
          "BBOX(geom, 5, 5, 6, 6) AND dtg DURING "
          "2022-01-02T00:00:00Z/2022-01-04T00:00:00Z"]
    want = [js.count("t", q) for q in qs]
    try:
        assert js.count_many("t", qs) == want
        assert ts.count_many("t", qs) == want
        assert ts.count_future("t", qs[0]).result(timeout=60) == want[0]
        assert ts.count_coalesced("t", qs[1]) == want[1]
        planner, delta, gen, epoch = ts._sched_snapshot("t")
        assert delta is ts.deltas["t"] and len(delta) == 3_000
        assert (gen, epoch) == (ts.generation("t"), ts.epoch)
        ts.flush("t")
        assert ts.count_many("t", qs) == want
    finally:
        ts.close()
        js.close()


# -- lazy fids -----------------------------------------------------------------


def _fid_tables(build, sft):
    rng = np.random.default_rng(3)

    def cols(n):
        return {"v": rng.integers(0, 100, n).astype(np.int32),
                "dtg": np.full(n, 1_600_000_000_000),
                "geom": (rng.uniform(-10, 10, n), rng.uniform(-10, 10, n))}

    return [build(sft, cols(12)), build(sft, cols(5), fids=list("abcde")),
            build(sft, cols(7)),
            build(sft, cols(4), fids=["3", "x", "012", "11"])]


def test_lazy_fids_equal_reference_after_concat_and_take():
    jsft, tsft = (c.from_spec("t", LSM_SPEC) for c in (JSFT, TSFT))
    jt = JTable.concat(_fid_tables(JTable.build, jsft))
    tt = TTable.concat(_fid_tables(TTable.build, tsft))
    assert np.array_equal(tt.fids, jt.fids)
    rng = np.random.default_rng(9)
    for _ in range(5):
        idx = rng.integers(0, len(jt), 17)
        assert np.array_equal(tt.fids_at(idx), jt.fids_at(idx))
        jt2, tt2 = jt.take(idx), tt.take(idx)
        assert np.array_equal(tt2.fids, jt2.fids)
        both = (JTable.concat([jt2, jt]), TTable.concat([tt2, tt]))
        assert np.array_equal(both[1].fids, both[0].fids)
        jt, tt = both
    for probe in (["3", "11", "x", "0", "012", "99"], ["12", "b"], []):
        want = np.isin(jt.fids, np.asarray(probe, dtype=object))
        assert np.array_equal(tt.fid_runs.isin(probe), want), probe


def test_lazy_fids_fold_after_many_small_appends():
    """A table grown by many small appends (the row writer's pattern) folds
    its runs into one, and still reads back the reference's ids — through
    ascending and unordered takes and the collision test."""
    jsft, tsft = (c.from_spec("t", LSM_SPEC) for c in (JSFT, TSFT))
    rng = np.random.default_rng(11)
    jt, tt = [], []
    for i in range(150):
        n = int(rng.integers(1, 9))
        cols = {"v": np.arange(n, dtype=np.int32),
                "dtg": np.full(n, 1_600_000_000_000),
                "geom": (np.zeros(n), np.zeros(n))}
        fids = [f"w{i}.{j}" for j in range(n)] if i % 2 else None
        jt.append(JTable.build(jsft, cols, fids=fids))
        tt.append(TTable.build(tsft, cols, fids=fids))
    jc, tc = JTable.concat(jt), TTable.concat(tt)
    assert len(tc.fid_runs.runs) <= FidRuns.MAX_RUNS
    assert np.array_equal(tc.fids, jc.fids)
    for idx in (np.sort(rng.integers(0, len(jc), 300)),
                rng.integers(0, len(jc), 300)):
        assert np.array_equal(tc.fids_at(idx), jc.fids_at(idx))
        assert np.array_equal(tc.take(idx).fids, jc.take(idx).fids)
    probe = ["3", "w7.1", "0", "w8.0"]
    assert np.array_equal(tc.fid_runs.isin(probe),
                          np.isin(jc.fids, np.asarray(probe, dtype=object)))


def test_lazy_fids_stay_lazy_on_a_large_implicit_table():
    """Implicit ids of a large table stay two integers through concat and
    an upsert's collision test (no string a row is built)."""
    runs = FidRuns.concat(FidRuns.implicit(50_000_000), FidRuns.implicit(3))
    assert [r[0] for r in runs.runs] == ["range", "range"]
    hit = runs.isin(["49999999", "2", "1e3", "-1", "007"])
    assert np.flatnonzero(hit).tolist() == [2, 49_999_999, 50_000_002]
    assert runs.take(np.array([49_999_999, 50_000_001])).materialize() \
        .tolist() == ["49999999", "1"]


def test_lazy_fids_equal_reference_after_upserts():
    part = _mk(50, 81)

    def run(store, build):
        _lsm_store(store, build, n=20_000)
        sft = store.get_schema("t")
        store.upsert("t", build.build(sft, _cols(part),
                                      fids=[str(k * 7) for k in range(50)]))
        store.upsert("t", build.build(sft, _cols(part),
                                      fids=[f"n{k}" for k in range(50)]))
        store.flush("t")
        store.upsert("t", build.build(sft, _cols(part),
                                      fids=[f"n{k}" for k in range(0, 50, 2)]
                                      + [str(k) for k in range(25)]))
        return store

    js, ts = _both(run)
    assert np.array_equal(ts.tables["t"].fids, js.tables["t"].fids)
    assert np.array_equal(ts.query("t", Q).table.fids,
                          js.query("t", Q).table.fids)


# -- mutations with MERGE_BUILD off equal the merge build ----------------------


def test_flush_through_full_rebuild_equals_merge_build():
    def run(merge):
        tconfig.MERGE_BUILD.set(merge)
        jconfig.MERGE_BUILD.set(merge)
        try:
            s = _lsm_store(_stores()[1], TTable, n=60_000)
            for i in range(3):
                _append(s, TTable, _mk(800, 90 + i, i))
            s.flush("t")
            return s
        finally:
            tconfig.MERGE_BUILD.unset()
            jconfig.MERGE_BUILD.unset()

    a, b = run(True), run(False)
    ia, ib = a.planners["t"].indexes[0], b.planners["t"].indexes[0]
    assert "merge_s" in ia.build_stages and "sort_s" in ib.build_stages
    assert np.array_equal(ia.perm.numpy(), ib.perm.numpy())
    assert np.array_equal(ia.sorted_z, ib.sorted_z)
    assert np.array_equal(ia.sorted_bins, ib.sorted_bins)
    for k in ib.device.columns:
        assert np.array_equal(ia.device[k].numpy(), ib.device[k].numpy()), k


def test_write_path_imports_neither_jax_nor_reference():
    """Appends, a merge-build flush, an upsert, a removal and an age-off in
    a fresh interpreter load nothing of JAX or the reference."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, numpy as np\n"
        "from geomesa_tpu_torch import DataStoreFinder\n"
        "import geomesa_tpu_torch.kernels.merge\n"
        "from geomesa_tpu_torch.features.table import FeatureTable\n"
        "s = DataStoreFinder.get_data_store(type='torch', device='cpu')\n"
        "sft = s.create_schema('t', 'val:Int,dtg:Date,*geom:Point;"
        "geomesa.feature.expiry=dtg(3650 days)')\n"
        "r = np.random.default_rng(0)\n"
        "def b(n, **kw):\n"
        "    return FeatureTable.build(sft, {'val': r.integers(0, 9, n),"
        " 'dtg': 1577836800000 + r.integers(0, 10**9, n),"
        " 'geom': (r.uniform(-50, 50, n), r.uniform(-50, 50, n))}, **kw)\n"
        "s.load('t', b(2000))\n"
        "s.load('t', b(300))\n"
        "s.flush('t')\n"
        "s.upsert('t', b(10, fids=[str(i) for i in range(10)]))\n"
        "s.remove_features('t', 'val = 3')\n"
        "s.age_off('t', now_ms=1577836800000)\n"
        "print(s.count('t', 'BBOX(geom, -10, -10, 10, 10) AND val > 2'))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'geomesa_tpu' or m.startswith('geomesa_tpu.')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 0


def test_durability_parameter_raises_naming_roadmap(tmp_path):
    """The write-ahead log, snapshots and recovery are not ported: a store
    asked for them refuses instead of running without them."""
    with pytest.raises(NotImplementedError, match="item 15"):
        DataStoreFinder.get_data_store(type="torch", device="cpu",
                                       durability=str(tmp_path))


def test_ingest_counters_and_spans():
    """Every write feeds the reference's ``ingest.*`` counters and spans:
    an append, a delta append, a merge-build flush, an upsert, an age-off."""
    def counts():
        snap = tmetrics.snapshot()
        timers = {k: v["count"] for k, v in snap["timers"].items()}
        return snap["counters"], timers

    c0, t0 = counts()
    ts = _stores()[1]
    ts.create_schema("t", LSM_SPEC + ",geomesa.feature.expiry=dtg(1 days)")
    sft = ts.get_schema("t")
    now = int(time.time() * 1000)

    def batch(n, seed, dtg, **kw):
        return TTable.build(sft, dict(_cols(_mk(n, seed)),
                                      dtg=np.full(n, dtg)), **kw)

    ts.load("t", batch(10_000, 1, now))
    ts.load("t", batch(1_000, 2, now - 2 * DAY))   # expired at the write
    ts.load("t", batch(1_000, 3, now))             # into the delta
    ts.flush("t")                                  # a merge build
    # ids 0..999 collide with the main table's and the merged delta's
    # implicit ids: 2,000 rows out, 1,000 in
    ts.upsert("t", batch(1_000, 4, now, fids=[str(i) for i in range(1_000)]))
    assert ts.count("t", "INCLUDE") == 10_000
    assert ts.age_off("t", now_ms=now + 2 * DAY) == 10_000
    c1, t1 = counts()

    def dc(name):
        return c1.get(name, 0) - c0.get(name, 0)

    def dt(name):
        return t1.get(name, 0) - t0.get(name, 0)

    # a colliding upsert rebuilds without the append path's counter, as in
    # the reference
    assert dc("ingest.features") == 12_000
    assert dc("ingest.delta_appends") == 2
    assert dc("ingest.merge_builds") == 1
    assert dc("ingest.upserts") == 1
    assert dc("ingest.aged_off") == 1_000 + 10_000
    assert ts.count("t", "INCLUDE") == 0
    for span in ("ingest.index_build", "ingest.flush", "ingest.merge_build",
                 "ingest.upsert", "ingest.age_off"):
        assert dt(span) >= 1, span
