"""The rows path of the port (geomesa_tpu_torch ``index/spatial.py``
``map_rows``) against the JAX package's: sorted positions map to table
rows by the reference's rule (a cached host permutation once it exists; a
request of more than 2^20 positions reads the whole permutation back once,
into that cache; a smaller one gathers on the device with a pow2-padded
upload), equal to ``perm[idx]`` and to the reference's ``map_rows`` on both
sides of 2^20, and after ``merge_from`` with and without the cache. The
port runs with device="cpu"."""

import numpy as np
import pytest

from geomesa_tpu import config as jconfig
from geomesa_tpu.datastore import TpuDataStore
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.features.table import FeatureTable as JTable
from geomesa_tpu.index.spatial import Z3Index as JZ3
from geomesa_tpu_torch import DataStoreFinder
from geomesa_tpu_torch import config as tconfig
from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.index import spatial as tspatial
from geomesa_tpu_torch.index.spatial import Z3Index as TZ3

SPEC = "v:Int,dtg:Date,*geom:Point;geomesa.z3.interval=week"
BIG = (1 << 20) + 1


def _columns(n, seed):
    rng = np.random.default_rng(seed)
    base = np.datetime64("2022-01-01T00:00:00", "ms").astype(np.int64)
    return {"v": rng.integers(0, 100, n).astype(np.int32),
            "dtg": base + rng.integers(0, 40 * 86400000, n),
            "geom": (rng.uniform(-170, 170, n), rng.uniform(-80, 80, n))}


@pytest.fixture
def indexes():
    cols = _columns(9000, 1)
    jsft, tsft = JSFT.from_spec("r", SPEC), TSFT.from_spec("r", SPEC)
    jt, tt = JTable.build(jsft, cols), TTable.build(tsft, cols)
    return JZ3(jsft, jt), TZ3(tsft, tt, "cpu")


@pytest.mark.parametrize("size", [0, 1, 7, 8, 9, 1000, 8999, 1 << 20, BIG],
                         ids=str)
def test_map_rows_equals_perm_and_reference(indexes, size):
    jidx, tidx = indexes
    idx = np.random.default_rng(size).integers(0, 9000, size)
    want = np.asarray(jidx.perm)[idx]
    got = tidx.map_rows(idx)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert np.array_equal(got, jidx.map_rows(idx))
    # the cache exists exactly when a request was past 2^20 positions
    cached = getattr(tidx, "_perm_cache", None) is not None
    assert cached == (size > 1 << 20)
    if cached:
        assert "perm_readback_s" in tidx.build_stages
        assert np.array_equal(tidx.host_perm, np.asarray(jidx.perm))


def test_cache_serves_every_later_request(indexes, monkeypatch):
    _, tidx = indexes
    perm = tidx.perm.numpy().copy()
    calls = []
    real = tspatial._row_gather
    monkeypatch.setattr(tspatial, "_row_gather",
                        lambda p, i: calls.append(len(i)) or real(p, i))
    small = np.array([5, 0, 8999, 5])
    assert np.array_equal(tidx.map_rows(small), perm[small])
    assert calls == [4]
    big = np.random.default_rng(0).integers(0, 9000, BIG)
    assert np.array_equal(tidx.map_rows(big), perm[big])
    assert np.array_equal(tidx.map_rows(small), perm[small])
    assert calls == [4]   # the cache answered both
    stamp = tidx.build_stages["perm_readback_s"]
    tidx.map_rows(big)
    assert tidx.build_stages["perm_readback_s"] == stamp   # read back once


@pytest.mark.parametrize("n", [1, 8, 9, 100, 1025])
def test_row_gather_uploads_a_power_of_two(indexes, monkeypatch, n):
    _, tidx = indexes
    sizes = []
    real = tspatial._dev
    monkeypatch.setattr(tspatial, "_dev",
                        lambda a, d: sizes.append(len(a)) or real(a, d))
    idx = np.arange(n, dtype=np.int64) * 3
    assert np.array_equal(tidx.map_rows(idx), tidx.perm.numpy()[idx])
    assert sizes == [max(8, 1 << (n - 1).bit_length())]


@pytest.mark.parametrize("cached", [False, True], ids=["device", "host"])
def test_merge_from_keeps_the_rows_path(cached):
    """After an incremental flush the merged index maps rows as a full
    rebuild's permutation does; a host permutation cached before the flush
    is merged by placement (no second read-back), else the device one."""
    for c in (jconfig, tconfig):
        c.MERGE_BUILD.set(True)
    try:
        js = TpuDataStore()
        ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
        main, more = _columns(60_000, 2), _columns(3_000, 3)
        for store, tbl in ((js, JTable), (ts, TTable)):
            store.create_schema("r", SPEC)
            store.load("r", tbl.build(store.get_schema("r"), main))
        old = ts.planners["r"].indexes[0]
        if cached:
            old.host_perm   # noqa: B018 - fills the cache
        for store, tbl in ((js, JTable), (ts, TTable)):
            store.load("r", tbl.build(store.get_schema("r"), more))
            store.flush("r")
        new = ts.planners["r"].indexes[0]
        assert "merge_rows" in new.build_stages
        assert (getattr(new, "_perm_cache", None) is not None) == cached
        assert "perm_readback_s" not in new.build_stages
        jperm = np.asarray(js.planners["r"].indexes[0].perm)
        assert np.array_equal(new.perm.numpy(), jperm)
        for size in (17, BIG):
            idx = np.random.default_rng(size).integers(0, 63_000, size)
            assert np.array_equal(new.map_rows(idx), jperm[idx])
        if cached:
            assert np.array_equal(new._perm_cache, jperm)
    finally:
        for c in (jconfig, tconfig):
            c.MERGE_BUILD.unset()
