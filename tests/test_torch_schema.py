"""Schema evolution and the store's lifecycle in the port
(``TorchDataStore.update_schema``, ``remove_schema``, ``reindex`` /
``reindex_status``, ``add_interceptor``, ``create``, ``DataStoreFinder.register``,
and ``open`` / ``cluster_scan``, which raise naming their ROADMAP.md
items), against the JAX package on the inputs of its own tests:

- ``tests/test_update_writer.py:66-146``'s ``update_schema`` (20,000 rows,
  seed 13): an added Double attribute whose rows are 0 until updated, a
  rename, a geometry attribute refused before any load, the sketch
  battery rebuilt over the evolved schema; and an added indexed attribute;
- ``tests/test_age_off.py:149``: interceptors do not survive
  ``remove_schema``; a re-created type starts a fresh fid sequence and a
  new generation;
- ``tests/test_reindex.py:258``: a background reindex under three
  counting threads and a flush-through append (60,000 + 60,000 rows): no
  error, every count one of the two consistent states, the final count
  equal to the reference's, the planner swapped and the generation
  bumped; and a reindex run in place (``background=False``), with an
  attribute index.

Counts compare exactly. The port runs with device="cpu".
"""

import importlib
import threading

import numpy as np
import pytest

from geomesa_tpu_torch import DataStoreFinder
from geomesa_tpu_torch.datastore import TorchDataStore
from geomesa_tpu_torch.features.table import FeatureTable as TTable


def _ref(name: str):
    """A module of the JAX package (imported only by these CPU tests)."""
    pytest.importorskip("jax")
    return importlib.import_module(name)


def _pair(spec, cols, name="u"):
    JStore = _ref("geomesa_tpu.datastore").TpuDataStore
    JTable = _ref("geomesa_tpu.features.table").FeatureTable
    js = JStore()
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    for s, tbl in ((js, JTable), (ts, TTable)):
        s.create_schema(name, spec)
        s.load(name, tbl.build(s.get_schema(name), cols))
    return js, ts


USPEC = "name:String,v:Int,dtg:Date,*geom:Point"


def _update_data():
    """tests/test_update_writer.py:13's fixture."""
    rng = np.random.default_rng(13)
    n = 20_000
    x = rng.uniform(-30, 30, n)
    y = rng.uniform(-30, 30, n)
    base = np.datetime64("2023-01-01T00:00:00", "ms").astype(np.int64)
    return {"name": rng.choice(["a", "b", "c"], n),
            "v": rng.integers(0, 100, n).astype(np.int32),
            "dtg": base + rng.integers(0, 10 * 86400000, n),
            "geom": (x, y)}


@pytest.fixture()
def ustores():
    data = _update_data()
    js, ts = _pair(USPEC, data)
    return js, ts, data


def test_update_schema_add_attribute(ustores):
    js, ts, data = ustores
    for s in (js, ts):
        sft = s.update_schema("u", add_attributes="score:Double")
        assert sft.attribute("score").type_name == "Double"
        r = s.query("u", "INCLUDE", hints={"limit": 5})
        assert float(np.asarray(r.table.columns["score"]).sum()) == 0.0
        s.update_features("u", "v < 50", {"score": 1.5})
    assert ts.count("u", "score > 1") == js.count("u", "score > 1") \
        == int(np.sum(data["v"] < 50))
    assert ts.get_schema("u").to_spec() == js.get_schema("u").to_spec()


def test_update_schema_rename(ustores):
    js, ts, _ = ustores
    total = js.count("u")
    g = ts.generation("u")
    for s in (js, ts):
        s.update_schema("u", new_name="u2")
        assert "u" not in s.get_type_names()
    assert ts.count("u2") == js.count("u2") == total
    assert ts.generation("u") == g + 1   # no cached plan survives the name
    with pytest.raises(ValueError, match="exists"):
        ts.create_schema("u2", USPEC)


def test_update_schema_rejects_new_geometry_even_before_load():
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    ts.create_schema("g0", "v:Int,*geom:Point")
    with pytest.raises(ValueError, match="geometry"):
        ts.update_schema("g0", add_attributes="geom2:Polygon")
    assert ts.get_schema("g0").to_spec() == "v:Int,*geom:Point"


def test_update_schema_refreshes_stats(ustores):
    js, ts, _ = ustores
    for s in (js, ts):
        s.update_schema("u", add_attributes="score:Double")
        s.update_features("u", "v < 50", {"score": 2.0})
    mm = ts.stats("u").get_min_max("score")
    want = js.stats("u").get_min_max("score")
    assert mm is not None and float(mm.max) == float(want.max) == 2.0


def test_update_schema_adds_an_indexed_attribute(ustores):
    """An attribute added with ``index=true`` builds its attribute index
    over the evolved table (every row 0 until updated), as the
    reference's rebuild does."""
    js, ts, data = ustores
    for s in (js, ts):
        s.update_schema("u", add_attributes="k:Int:index=true")
        s.update_features("u", "v > 80", {"k": 5})
    for q in ("k = 5", "k = 0", "k = 5 AND BBOX(geom, -10, -10, 10, 10)",
              "k IN (0, 5) AND name = 'b'"):
        assert ts.count("u", q) == js.count("u", q), q
        assert ts.explain("u", q)["index"] == js.explain("u", q)["index"], q
    assert ts.count("u", "k = 5") == int(np.sum(data["v"] > 80))


def test_interceptors_and_counters_do_not_survive_remove_schema():
    """tests/test_age_off.py:149 (and the fid sequence beside it)."""
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    ts.create_schema("r", "v:Int,dtg:Date,*geom:Point")

    class Guard:
        def rewrite(self, f, sft):
            return f

        def guard(self, plan, f, sft):
            return "vetoed"

    ts.add_interceptor("r", Guard())
    with ts.get_writer("r") as w:
        w.write(v=1, dtg=0, geom="POINT (0 0)")
    g = ts.generation("r")
    ts.remove_schema("r")
    assert "r" not in ts.get_type_names() and "r" not in ts.planners
    ts.create_schema("r", "v:Int,dtg:Date,*geom:Point")
    assert ts._interceptors.get("r") in (None, [])
    assert ts.generation("r") > g
    with ts.get_writer("r") as w:
        assert w.write(v=2, dtg=0, geom="POINT (1 1)") == "r.0"
    assert ts.count("r", "v = 2") == 1   # no guard left to veto it


# -- reindex -------------------------------------------------------------------


RSPEC = "name:String,v:Int,dtg:Date,*geom:Point;geomesa.z3.interval=week"
RQ = "BBOX(geom, -10, -10, 10, 10) AND v < 50"
_RBASE = int(np.datetime64("2022-01-01T00:00:00", "ms").astype(np.int64))
_DAY = 86_400_000


def _rdata(n, seed):
    """tests/test_reindex.py:41's batches."""
    rng = np.random.default_rng(seed)
    return {"name": rng.choice(["a", "b", "c", f"s{seed}"], n).astype(object),
            "v": rng.integers(0, 100, n).astype(np.int32),
            "dtg": _RBASE + rng.integers(0, 5 * _DAY, n),
            "geom": (rng.uniform(-30, 30, n), rng.uniform(-30, 30, n))}


def _rbatch(sft, n, seed, tbl=TTable):
    return tbl.build(sft, _rdata(n, seed),
                     fids=[f"s{seed}_{j}" for j in range(n)])


def test_reindex_swaps_under_concurrent_queries_and_ingest():
    s = DataStoreFinder.get_data_store(type="torch", device="cpu")
    s.create_schema("t", RSPEC)
    sft = s.get_schema("t")
    s.load("t", _rbatch(sft, 60_000, 1))
    s.flush("t")
    base = s.count("t", RQ)
    extra = _rbatch(sft, 60_000, 2)
    old_planner = s.planners["t"]
    g0 = s.generation("t")
    counts, errors = [], []
    stop = threading.Event()

    def qloop():
        while not stop.is_set():
            try:
                counts.append(s.count("t", RQ))
            except Exception as e:  # noqa: BLE001 - collected for the assert
                errors.append(e)

    workers = [threading.Thread(target=qloop) for _ in range(3)]
    for w in workers:
        w.start()
    try:
        s.reindex("t")
        s.load("t", extra)   # flush-through mid-reindex: abort and retry
        s._reindex_threads["t"].join(180)
        assert not s._reindex_threads["t"].is_alive()
    finally:
        stop.set()
        for w in workers:
            w.join()
    st = s.reindex_status("t")
    assert st["state"] == "installed", st
    assert not errors
    final = s.count("t", RQ)
    assert final > base
    assert set(counts) <= {base, final}
    assert s.planners["t"] is not old_planner
    assert s.generation("t") > g0
    assert st["rows"] == 120_000
    assert s.count("t", RQ) == final
    # the reference's answer over the same rows
    js = _ref("geomesa_tpu.datastore").TpuDataStore()
    JTable = _ref("geomesa_tpu.features.table").FeatureTable
    js.create_schema("t", RSPEC)
    for seed in (1, 2):
        js.load("t", _rbatch(js.get_schema("t"), 60_000, seed, JTable))
    assert js.count("t", RQ) == final


def test_reindex_in_place_with_an_attribute_index():
    s = DataStoreFinder.get_data_store(type="torch", device="cpu")
    s.create_schema("t", RSPEC.replace("v:Int", "v:Int:index=true"))
    s.load("t", _rbatch(s.get_schema("t"), 5_000, 1))
    assert s.reindex_status("t") == {"state": "idle", "running": False}
    before = {q: s.count("t", q) for q in (RQ, "v = 7", "v < 3 AND "
                                           "name = 'a'")}
    g0 = s.generation("t")
    st = s.reindex("t", background=False)
    assert st["state"] == "installed" and st["attempts"] == 1
    assert st["generation"] == g0 + 1 == s.generation("t")
    assert {q: s.count("t", q) for q in before} == before
    assert s.explain("t", "v = 7")["index"] == "attr:v"
    with pytest.raises(KeyError):
        s.reindex("missing")


# -- the factory SPI and what is not ported ---------------------------------------


def test_create_and_register():
    store = TorchDataStore.create({"type": "torch", "device": "cpu"})
    assert isinstance(store, TorchDataStore)

    class Other:
        made = []

        @classmethod
        def can_process(cls, params):
            return params.get("type") == "other"

        @classmethod
        def create(cls, params):
            cls.made.append(params)
            return "other-store"

    DataStoreFinder.register(Other)
    DataStoreFinder.register(Other)
    try:
        assert DataStoreFinder._factories.count(Other) == 1
        assert DataStoreFinder.get_data_store(type="other") == "other-store"
        assert isinstance(DataStoreFinder.get_data_store(
            type="torch", device="cpu"), TorchDataStore)
        with pytest.raises(ValueError, match="No datastore"):
            DataStoreFinder.get_data_store(type="none")
    finally:
        DataStoreFinder._factories.remove(Other)


def test_open_and_cluster_scan_raise_naming_roadmap(tmp_path):
    with pytest.raises(NotImplementedError, match="item 15"):
        TorchDataStore.open(str(tmp_path / "durable"))
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    ts.create_schema("t", USPEC)
    with pytest.raises(NotImplementedError, match="item 14"):
        ts.cluster_scan("t")
