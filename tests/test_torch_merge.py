"""The incremental merge build of the port (geomesa_tpu_torch) against the
JAX package: ``DeviceTable.merge_scatter`` in isolation on carried-over
resident columns, the reference's randomized append/flush/remove/age-off
interleavings (``tests/test_reindex.py``) on a ``TpuDataStore`` and a
``TorchDataStore`` with ``MERGE_BUILD`` on and off — index state (sorted
keys, permutation, every device column), counts and fids equal after every
step — and the union-vocabulary remap of stale dictionary columns. The port
runs with device="cpu" here: the plain version of its kernel.

The CUDA kernel ``merge_scatter`` is held to its plain version, byte for
byte, by the ``gpu`` tests, which skip without a card and import nothing of
JAX (the reference is imported only by the tests that compare):
``python -m pytest --noconftest -m gpu tests/test_torch_merge.py``."""

import sys
import time

import numpy as np
import pytest
import torch

from geomesa_tpu_torch import DataStoreFinder
from geomesa_tpu_torch import config as tconfig
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.index.device import DeviceTable
from geomesa_tpu_torch.kernels import merge as tmerge

SPEC = "name:String,v:Int,dtg:Date,*geom:Point;geomesa.z3.interval=week"
SPEC_EXP = SPEC + ",geomesa.feature.expiry=dtg(30 days)"
Q = "BBOX(geom, -10, -10, 10, 10) AND v < 50"
_BASE = int(np.datetime64("2022-01-01T00:00:00", "ms").astype(np.int64))
_DAY = 86_400_000
# the expiry script needs dtg near the real clock (write-path age-off drops
# already-expired rows): batches span [now-10d, now-5d)
_NOW = int(time.time() * 1000)
_EXP_BASE = _NOW - 10 * _DAY
TILE = 2048   # merge_scatter.cu's rows a block


def _ref():
    pytest.importorskip("jax")
    from geomesa_tpu import config
    from geomesa_tpu.datastore import TpuDataStore
    from geomesa_tpu.features.table import FeatureTable
    from geomesa_tpu.index import device
    return config, TpuDataStore, FeatureTable, device


@pytest.fixture(autouse=True)
def _reset_knobs():
    yield
    tconfig.MERGE_BUILD.unset()
    tconfig.MERGE_MAX_FRACTION.unset()
    if "geomesa_tpu.config" in sys.modules:
        jconfig = _ref()[0]
        jconfig.MERGE_BUILD.unset()
        jconfig.MERGE_MAX_FRACTION.unset()


def _data(n, seed, base_day=0, base=_BASE):
    rng = np.random.default_rng(seed)
    return {"name": rng.choice(["a", "b", "c", f"s{seed}"], n).astype(object),
            "v": rng.integers(0, 100, n).astype(np.int32),
            "dtg": base + base_day * _DAY + rng.integers(0, 5 * _DAY, n),
            "geom": (rng.uniform(-30, 30, n), rng.uniform(-30, 30, n))}


def _fids(n, seed):
    return [f"s{seed}_{j}" for j in range(n)]


# -- DeviceTable.merge_scatter in isolation -----------------------------------


def _ranks(kind: str, n_old: int, n_delta: int, seed: int) -> np.ndarray:
    """Non-decreasing delta ranks in [0, n_old] of one edge shape."""
    rng = np.random.default_rng(seed)
    if kind == "all_first":
        return np.zeros(n_delta, dtype=np.int64)
    if kind == "all_last":
        return np.full(n_delta, n_old, dtype=np.int64)
    if kind == "one_run":
        return np.full(n_delta, n_old // 3, dtype=np.int64)
    if kind == "runs":
        # long runs of equal ranks at a few places, one past a tile's slice
        at = np.sort(rng.integers(0, n_old + 1, 4))
        return np.sort(np.repeat(at, -(-n_delta // 4))[:n_delta])
    return np.sort(rng.integers(0, n_old + 1, n_delta))


# (n_old, n_delta, rank shape): n_old off the kernel's tile, every delta
# row first or last, long equal runs (one longer than a tile's staged
# slice), a single delta row, an empty resident side
MERGE_CASES = [
    (3 * TILE + 17, 500, "random"),
    (3 * TILE + 17, 500, "all_first"),
    (3 * TILE + 17, 500, "all_last"),
    (5000, 3000, "one_run"),
    (2 * TILE, 2500, "runs"),
    (4099, 1, "random"),
    (4099, 1, "all_last"),
    (1, 7, "random"),
]


def _resident(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"xi": rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64)
            .astype(np.int32),
            "xf": rng.normal(0, 50, n).astype(np.float32),
            "flag": rng.random(n) < 0.5,
            "name": rng.integers(0, 4, n).astype(np.int32)}


@pytest.mark.parametrize("n_old,n_delta,kind", MERGE_CASES)
@pytest.mark.parametrize("host_perm", [False, True])
def test_device_table_merge_scatter_equals_reference(n_old, n_delta, kind,
                                                      host_perm):
    """The same resident columns (the reference's, carried over), delta
    planes, ranks and perm pair through both packages'
    ``DeviceTable.merge_scatter``: every merged column and the merged
    permutation equal; the stale ``name`` column rebuilds from the full
    codes through the host or the merged device permutation."""
    import jax.numpy as jnp
    _, _, _, jdevice = _ref()
    old = _resident(n_old, 1)
    delta = _resident(n_delta, 2)
    r = _ranks(kind, n_old, n_delta, 3)
    rng = np.random.default_rng(4)
    old_perm = rng.permutation(n_old)
    p_d = rng.permutation(n_delta)
    full_codes = {"name": rng.integers(0, 5, n_old + n_delta)
                  .astype(np.int32)}
    new_host_perm = None
    if host_perm:
        new_host_perm = np.empty(n_old + n_delta, dtype=np.int64)
        shift = np.searchsorted(r, np.arange(n_old), side="right")
        new_host_perm[np.arange(n_old) + shift] = old_perm
        new_host_perm[r + np.arange(n_delta)] = n_old + p_d

    jold = jdevice.DeviceTable(n_old, {k: jnp.asarray(v)
                                       for k, v in old.items()})
    jpair = None if host_perm else (jnp.asarray(old_perm.astype(np.int32)),
                                    (n_old + p_d).astype(np.int32))
    jtab, jperm = jdevice.DeviceTable.merge_scatter(
        jold, delta, r, stale={"name"}, full_codes=full_codes,
        perm_pair=jpair, host_perm=new_host_perm)

    told = DeviceTable.from_numpy({k: np.asarray(v)
                                   for k, v in jold.columns.items()}, "cpu")
    tpair = None if host_perm else (torch.from_numpy(old_perm),
                                    n_old + p_d)
    before = tmerge.merge_scatter.launches
    stages = {}
    ttab, tperm = DeviceTable.merge_scatter(
        told, delta, r, stale=["name"], full_codes=full_codes,
        perm_pair=tpair, host_perm=new_host_perm, stages=stages)
    assert tmerge.merge_scatter.launches == before   # the CPU: plain version
    assert ttab.n == jtab.n == n_old + n_delta
    assert set(ttab.columns) == set(jtab.columns) == set(old)
    for k in old:
        want = np.asarray(jtab.columns[k])
        got = ttab[k].numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), k
    if host_perm:
        assert tperm is None and jperm is None
    else:
        assert tperm.dtype == torch.int64
        assert np.array_equal(tperm.numpy(), np.asarray(jperm))
    assert {"upload_s", "kernel_s", "stale_s"} <= set(stages)


def _plain_by_definition(olds, deltas, r):
    """out[i + #{j: r[j] <= i}] = old[i], out[r[j] + j] = delta[j], in
    numpy, independently of both versions."""
    n_old, n_delta = len(olds[0]), len(r)
    shift = np.searchsorted(r, np.arange(n_old), side="right")
    outs = []
    for o, d in zip(olds, deltas):
        out = np.empty(n_old + n_delta, dtype=o.dtype)
        out[np.arange(n_old) + shift] = o
        out[r + np.arange(n_delta)] = d
        outs.append(out)
    return outs


@pytest.mark.parametrize("n_old,n_delta,kind", MERGE_CASES + [
    (0, 9, "all_first"), (9, 0, "random")])
def test_plain_merge_scatter_matches_its_definition(n_old, n_delta, kind):
    olds = [np.arange(n_old, dtype=np.int64) * 3,
            np.arange(n_old, dtype=np.float32) / 7,
            (np.arange(n_old) % 3 == 0), np.arange(n_old, dtype=np.int16)]
    deltas = [-1 - np.arange(n_delta, dtype=np.int64),
              -np.arange(n_delta, dtype=np.float32),
              np.ones(n_delta, dtype=bool),
              -np.arange(n_delta, dtype=np.int16)]
    r = _ranks(kind, n_old, n_delta, 5)
    got = tmerge.merge_scatter([torch.from_numpy(o) for o in olds],
                               [torch.from_numpy(d) for d in deltas],
                               torch.from_numpy(r.astype(np.int32)))
    for g, w in zip(got, _plain_by_definition(olds, deltas, r)):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("r,match", [
    ([0, 2, 1], "non-decreasing"), ([-1, 0], "non-decreasing"),
    ([0, 11], "non-decreasing")])
def test_merge_scatter_rejects_bad_ranks(r, match):
    old = [torch.arange(10, dtype=torch.int32)]
    delta = [torch.zeros(len(r), dtype=torch.int32)]
    with pytest.raises(ValueError, match=match):
        tmerge.merge_scatter(old, delta, torch.tensor(r, dtype=torch.int32))


def test_merge_scatter_rejects_past_the_int32_ranks():
    """The reference ranks as int32 (``r32``): a merged table of 2^31 rows
    raises before anything is allocated."""
    old = [torch.zeros(1, dtype=torch.uint8).expand((1 << 31) - 1)]
    delta = [torch.zeros(1, dtype=torch.uint8)]
    with pytest.raises(ValueError, match="int32"):
        tmerge.merge_scatter(old, delta, torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("bad", ["dtype", "rdtype", "length", "device",
                                 "none"])
def test_merge_scatter_checks_its_inputs(bad):
    old = [torch.arange(10, dtype=torch.int32)]
    delta = [torch.zeros(2, dtype=torch.int32)]
    r = torch.tensor([1, 4], dtype=torch.int32)
    if bad == "dtype":
        delta = [delta[0].float()]
    elif bad == "rdtype":
        r = r.long()
    elif bad == "length":
        delta = [torch.zeros(3, dtype=torch.int32)]
    elif bad == "device":
        old = [old[0].to("meta")]
    else:
        old, delta = [], []
    with pytest.raises((TypeError, ValueError)):
        tmerge.merge_scatter(old, delta, r)


# -- the store: merge build == full rebuild == the reference -------------------


def _index_state(idx) -> dict:
    out = {"sorted_z": np.asarray(idx.sorted_z),
           "sorted_bins": np.asarray(idx.sorted_bins),
           "perm": np.asarray(idx.perm.numpy() if torch.is_tensor(idx.perm)
                              else idx.perm).astype(np.int64)}
    for k, v in idx.device.columns.items():
        out[f"dev.{k}"] = v.numpy() if torch.is_tensor(v) else np.asarray(v)
    return out


def _assert_same(a: dict, b: dict, where: str):
    """Equal values everywhere; equal dtypes for the device columns (the
    reference narrows its host bin keys to int16, the port keeps int32)."""
    assert set(a) == set(b), where
    for k in a:
        if k.startswith("dev."):
            assert a[k].dtype == b[k].dtype, f"{where}: {k} dtype"
        assert np.array_equal(a[k], b[k]), f"{where}: {k} differs"


def _store_state(store) -> dict:
    return _index_state(store.planners["t"].indexes[0])


def _script():
    """The reference's interleaving script (tests/test_reindex.py:103-126),
    same seed and sizes."""
    rng = np.random.default_rng(1234)
    script = [("load", 40_000, 1, 0)]
    seed = 10
    for _ in range(14):
        k = int(rng.integers(0, 10))
        if k < 5:
            script.append(("load", int(rng.integers(500, 3_000)), seed,
                           int(rng.integers(0, 4))))
            seed += 1
        elif k < 8:
            script.append(("flush",))
        elif k == 8:
            script.append(("remove", f"v = {int(rng.integers(0, 100))}"))
        else:
            script.append(("age_off", _NOW + 22 * _DAY))
    script.append(("flush",))
    return script


def _apply(store, build, op):
    if op[0] == "load":
        store.load("t", build(store.get_schema("t"),
                              _data(op[1], op[2], op[3], base=_EXP_BASE),
                              fids=_fids(op[1], op[2])))
    elif op[0] == "flush":
        store.flush("t")
    elif op[0] == "remove":
        store.remove_features("t", op[1])
    else:
        store.age_off("t", now_ms=op[1])


@pytest.mark.parametrize("merge_on", [True, False])
def test_interleavings_match_reference_after_every_step(merge_on):
    """The reference's append/flush/remove/age-off interleavings with
    expiry, on both stores with MERGE_BUILD ``merge_on``: after every step
    the sorted key runs, the permutation, every device column, the count
    of Q and the sorted fids of query(Q) are equal; a port store with the
    knob flipped (full rebuilds ↔ merge builds) is equal too."""
    jconfig, TpuDataStore, JTable, _ = _ref()
    from geomesa_tpu.metrics import REGISTRY as jmetrics
    from geomesa_tpu_torch.metrics import REGISTRY as tmetrics
    jconfig.MERGE_BUILD.set(merge_on)
    js = TpuDataStore()
    js.create_schema("t", SPEC_EXP)
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    ts.create_schema("t", SPEC_EXP)
    other = DataStoreFinder.get_data_store(type="torch", device="cpu")
    other.create_schema("t", SPEC_EXP)
    merges = tmetrics.snapshot()["counters"].get("ingest.merge_builds", 0)
    jmerges = jmetrics.snapshot()["counters"].get("ingest.merge_builds", 0)
    for step, op in enumerate(_script()):
        _apply(js, JTable.build, op)
        tconfig.MERGE_BUILD.set(merge_on)
        _apply(ts, TTable.build, op)
        tconfig.MERGE_BUILD.set(not merge_on)
        _apply(other, TTable.build, op)
        where = f"step {step} {op[:2]}"
        want = _store_state(js)
        _assert_same(_store_state(ts), want, where)
        _assert_same(_store_state(other), want, where)
        assert (js.deltas["t"] is None) == (ts.deltas["t"] is None), where
        assert ts.count("t", Q) == other.count("t", Q) == js.count("t", Q)
        jf = sorted(map(str, js.query("t", Q).table.fids))
        assert sorted(map(str, ts.query("t", Q).table.fids)) == jf, where
    d_t = tmetrics.snapshot()["counters"].get("ingest.merge_builds", 0) \
        - merges
    d_j = jmetrics.snapshot()["counters"].get("ingest.merge_builds", 0) \
        - jmerges
    # the port's counter holds the merge-on store's merges (ts or other):
    # as many as the reference's merge-on store makes
    if merge_on:
        assert d_j > 0 and d_t == d_j, "the script never merged"
    else:
        assert d_j == 0 and d_t > 0, "the script never merged"


def test_vocabulary_growth_rebuilds_stale_columns():
    """A delta with a new dictionary entry (tests/test_reindex.py:154):
    the resident ``name`` codes are stale, so that column rebuilds from the
    merged codes; the state equals the reference's and the port's own full
    rebuild."""
    jconfig, TpuDataStore, JTable, _ = _ref()

    def run(store, build):
        store.create_schema("t", SPEC)
        sft = store.get_schema("t")
        store.load("t", build(sft, _data(30_000, 1), fids=_fids(30_000, 1)))
        store.flush("t")
        store.load("t", build(sft, _data(2_000, 99), fids=_fids(2_000, 99)))
        store.flush("t")
        return store

    jconfig.MERGE_BUILD.set(True)
    js = run(TpuDataStore(), JTable.build)
    tconfig.MERGE_BUILD.set(True)
    ts = run(DataStoreFinder.get_data_store(type="torch", device="cpu"),
             TTable.build)
    st = ts.planners["t"].indexes[0].build_stages
    assert st["merge_stale_cols"] == ["name"] and st["merge_rows"] == 2_000
    tconfig.MERGE_BUILD.set(False)
    full = run(DataStoreFinder.get_data_store(type="torch", device="cpu"),
               TTable.build)
    want = _store_state(js)
    _assert_same(_store_state(ts), want, "merge")
    _assert_same(_store_state(full), want, "full")
    qn = "name = 's99' AND v < 50"
    assert ts.count("t", qn) == full.count("t", qn) == js.count("t", qn) > 0


def test_merge_fraction_gate_falls_back_to_full_rebuild():
    """A delta over MERGE_MAX_FRACTION takes the full rebuild and counts
    the breach, as the reference does; the state is the same."""
    from geomesa_tpu_torch.metrics import REGISTRY as tmetrics
    tconfig.MERGE_MAX_FRACTION.set(0.01)
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    ts.create_schema("t", SPEC)
    sft = ts.get_schema("t")
    ts.load("t", TTable.build(sft, _data(30_000, 1)))
    c = tmetrics.snapshot()["counters"]
    before = (c.get("ingest.merge_fraction_breaches", 0),
              c.get("ingest.merge_builds", 0))
    ts.load("t", TTable.build(sft, _data(1_500, 2)))
    ts.flush("t")
    c = tmetrics.snapshot()["counters"]
    assert c.get("ingest.merge_fraction_breaches", 0) == before[0] + 1
    assert c.get("ingest.merge_builds", 0) == before[1]
    assert "merge_s" not in ts.planners["t"].indexes[0].build_stages
    assert ts.count("t", "INCLUDE") == 31_500


# -- every index's merge build == its full rebuild == the reference's ---------


def _lines(n, rng):
    """Single-segment LineStrings (the band route's layers)."""
    lx, ly = rng.uniform(-30, 30, n), rng.uniform(-30, 30, n)
    c = np.empty((2 * n, 2))
    c[0::2, 0], c[0::2, 1] = lx, ly
    c[1::2, 0] = lx + rng.uniform(0.01, 2.0, n)
    c[1::2, 1] = ly + rng.uniform(0.01, 2.0, n)
    return c


def _polys(n, rng):
    cx, cy = rng.uniform(-30, 30, n), rng.uniform(-30, 30, n)
    r = rng.uniform(0.05, 1.5, n)
    return [(3, [[[x - d, y - d], [x + d, y - d], [x + d, y + d],
                  [x - d, y - d]]]) for x, y, d in zip(cx, cy, r)]


# kind: (spec, geometry, index class name)
INDEX_KINDS = {
    "z3": ("v:Int,dtg:Date,*geom:Point;geomesa.z3.interval=week", "points",
           "Z3Index"),
    "z2": ("v:Int,*geom:Point", "points", "Z2Index"),
    "xz2": ("v:Int,*geom:LineString", "lines", "XZ2Index"),
    "xz3": ("v:Int,dtg:Date,*geom:Polygon;geomesa.z3.interval=week",
            "polys", "XZ3Index"),
    "s2": ("v:Int,*geom:Point;geomesa.indices=s2", "points", "S2Index"),
    "s3": ("v:Int,dtg:Date,*geom:Point;geomesa.indices=s3,"
           "geomesa.z3.interval=week", "points", "S3Index"),
    "full": ("v:Int,name:String,dtg:Date", None, "FullScanIndex"),
}


def _kind_cols(kind, n, seed, tgeo, jgeo):
    """(reference columns, port columns) of ``n`` rows; ties in the keys
    (repeated geometries and dates) so the ranks' tie rule shows."""
    spec, geom, _ = INDEX_KINDS[kind]
    rng = np.random.default_rng(seed)
    cols = {"v": rng.integers(0, 100, n).astype(np.int32)}
    if "dtg" in spec:
        cols["dtg"] = _BASE + rng.integers(0, 3 * 7, n) * _DAY
    if "name" in spec:
        cols["name"] = rng.choice(["a", "b", f"s{seed}"], n).astype(object)
    if geom is None:
        return cols, dict(cols)
    if geom == "points":
        x = np.round(rng.uniform(-30, 30, n), 1)
        y = np.round(rng.uniform(-30, 30, n), 1)
        return dict(cols, geom=(x, y)), dict(cols, geom=(x, y))
    if geom == "lines":
        c = _lines(n, rng)
        if n >= 8:
            c[2:8] = c[0:6]   # repeated segments
        return (dict(cols, geom=jgeo.GeometryArray.linestrings(c)),
                dict(cols, geom=tgeo.GeometryArray.linestrings(c)))
    shapes = _polys(n, rng)
    if n >= 8:
        shapes[1:4] = shapes[0:3]
    return (dict(cols, geom=jgeo.GeometryArray.from_shapes(shapes)),
            dict(cols, geom=tgeo.GeometryArray.from_shapes(shapes)))


def _state(idx, names=None) -> dict:
    """Sorted key runs, the permutation and the device columns (``names``
    only, when given) of a spatial index of either package."""
    out = {"perm": np.asarray(idx.perm.numpy() if torch.is_tensor(idx.perm)
                              else idx.perm).astype(np.int64)}
    for attr in ("sorted_z", "sorted_xz", "sorted_bins"):
        try:
            out[attr] = np.asarray(getattr(idx, attr))
        except (AttributeError, TypeError):
            pass
    for k, v in idx.device.columns.items():
        if names is None or k in names:
            out[f"dev.{k}"] = v.numpy() if torch.is_tensor(v) \
                else np.asarray(v)
    return out


@pytest.mark.parametrize("kind", list(INDEX_KINDS))
@pytest.mark.parametrize("sizes", [(3000, 400), (2000, 1)],
                         ids=["delta_400", "delta_1"])
def test_every_index_merges_bitwise_a_full_rebuild(kind, sizes):
    """``merge_from`` of each index (Z3, Z2, XZ2, XZ3, S2, S3 and the
    full-scan index) over a resident table and an appended run: the merged
    permutation, sorted key runs and every device column equal a full
    rebuild of the merged table and the reference's ``merge_from`` of the
    same tables (a line layer's segment planes merge too); one
    ``merge_scatter`` call moves the device columns."""
    jspatial = pytest.importorskip("geomesa_tpu.index.spatial")
    jgeo = pytest.importorskip("geomesa_tpu.features.geometry")
    JSFT = pytest.importorskip("geomesa_tpu.features.sft").SimpleFeatureType
    _, _, JTable, _ = _ref()
    from geomesa_tpu_torch.features import geometry as tgeo
    from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
    from geomesa_tpu_torch.index import spatial as tspatial
    spec, geom, cls = INDEX_KINDS[kind]
    n_old, n_delta = sizes
    jsft, tsft = JSFT.from_spec("m", spec), TSFT.from_spec("m", spec)
    ja, ta = _kind_cols(kind, n_old, 1, tgeo, jgeo)
    jd, td = _kind_cols(kind, n_delta, 2, tgeo, jgeo)
    jold, told = JTable.build(jsft, ja), TTable.build(tsft, ta)
    jmerged = JTable.concat([jold, JTable.build(jsft, jd)])
    tmerged = TTable.concat([told, TTable.build(tsft, td)])
    JCls, TCls = getattr(jspatial, cls), getattr(tspatial, cls)
    jidx, tidx = JCls(jsft, jold), TCls(tsft, told, "cpu")
    segments = geom == "lines"
    if segments:
        assert tidx.ensure_segment_columns()
    calls = []
    plain = tmerge.merge_scatter

    def spy(*a, **k):
        calls.append(len(a[0]))
        return plain(*a, **k)

    tmerge.merge_scatter, saved = spy, tmerge.merge_scatter
    try:
        tnew = TCls.merge_from(tidx, tmerged, n_old)
    finally:
        tmerge.merge_scatter = saved
    assert len(calls) == 1 and tnew.build_stages["merge_rows"] == n_delta
    jnew = JCls.merge_from(jidx, jmerged, n_old)
    tfull = TCls(tsft, tmerged, "cpu")
    if segments:
        assert "sx1" in tnew.device.columns
        assert tfull.ensure_segment_columns()
    got = _state(tnew)
    _assert_same(got, _state(tfull), f"{kind}: merge vs rebuild")
    jcols = set(jnew.device.columns)
    want = _state(jnew, jcols)
    got_ref = {k: v for k, v in got.items()
               if not k.startswith("dev.") or k[4:] in jcols}
    assert set(got_ref) == set(want), kind
    for k in want:
        assert np.array_equal(got_ref[k], want[k]), f"{kind}: {k}"


def test_segment_planes_drop_when_the_delta_is_not_segments():
    """A line layer's segment planes survive a merge of single segments
    and drop when the delta brings a longer line; the band route then
    declines, as after a full rebuild."""
    from geomesa_tpu_torch.features import geometry as tgeo
    from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
    from geomesa_tpu_torch.index.spatial import XZ2Index
    sft = TSFT.from_spec("m", "v:Int,*geom:LineString")
    rng = np.random.default_rng(4)
    old = TTable.build(sft, {"v": np.arange(600, dtype=np.int32),
                             "geom": tgeo.GeometryArray.linestrings(
                                 _lines(600, rng))})
    idx = XZ2Index(sft, old, "cpu")
    assert idx.ensure_segment_columns()
    longer = tgeo.GeometryArray.from_shapes(
        [(2, [[0.0, 0.0], [1.0, 1.0], [2.0, 0.0]])])
    merged = TTable.concat([old, TTable.build(sft, {
        "v": np.array([7], np.int32), "geom": longer})])
    new = XZ2Index.merge_from(idx, merged, 600)
    assert "sx1" not in new.device.columns
    assert not new.ensure_segment_columns()
    assert not XZ2Index(sft, merged, "cpu").ensure_segment_columns()


@pytest.mark.parametrize("kind", ["xz2", "xz3", "z2", "s3", "full", "attr"])
def test_store_flush_merges_every_index_kind(kind):
    """A store's flush merges every index kind (``_merge_rebuild``), and
    answers as the reference's store; a type with an attribute index stays
    on the full rebuild, as the reference's."""
    config, TpuDataStore, JTable, _ = _ref()
    jgeo = pytest.importorskip("geomesa_tpu.features.geometry")
    from geomesa_tpu_torch.features import geometry as tgeo
    spec = INDEX_KINDS["z3"][0].replace("v:Int", "v:Int:index=true") \
        if kind == "attr" else INDEX_KINDS[kind][0]
    k = "z3" if kind == "attr" else kind
    js = TpuDataStore()
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    for s in (js, ts):
        s.create_schema("t", spec)
    for j, rows in enumerate((3000, 300, 200)):
        jc, tc = _kind_cols(k, rows, 10 + j, tgeo, jgeo)
        js.load("t", JTable.build(js.get_schema("t"), jc))
        ts.load("t", TTable.build(ts.get_schema("t"), tc))
    for s in (js, ts):
        s.flush("t")
    idx = ts.planners["t"].indexes[0]
    assert ("merge_rows" in idx.build_stages) == (kind != "attr")
    q = "v < 30" if kind == "full" else "BBOX(geom, -5, -5, 10, 10) AND v < 60"
    assert ts.count("t", q) == js.count("t", q) > 0
    assert np.array_equal(ts.query("t", q).indices, js.query("t", q).indices)


# -- the CUDA kernel against its plain version (card only) --------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _columns(n: int, seed: int, sign: int):
    """4- and 8-byte columns (and 1- and 2-byte ones) for one launch."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(sign * rng.integers(0, 2**31 - 1, n)
                             .astype(np.int32)),
            torch.from_numpy(rng.normal(0, 1, n).astype(np.float32)),
            torch.from_numpy(sign * rng.integers(0, 2**62, n)),
            torch.from_numpy(rng.random(n) < 0.5),
            torch.from_numpy(rng.integers(-2**15, 2**15 - 1, n)
                             .astype(np.int16))]


def _kernel_vs_plain(n_old, n_delta, r):
    dev = _cuda()
    olds = _columns(n_old, 1, 1)
    deltas = _columns(n_delta, 2, -1)
    rt = torch.from_numpy(np.asarray(r, dtype=np.int32))
    want = tmerge.merge_scatter(olds, deltas, rt)
    before = tmerge.merge_scatter.launches
    got = tmerge.merge_scatter([o.to(dev) for o in olds],
                               [d.to(dev) for d in deltas], rt.to(dev))
    torch.cuda.synchronize()
    assert tmerge.merge_scatter.launches == before + 1
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("n_old,n_delta,kind", MERGE_CASES + [
    (0, 9, "all_first"), (9, 0, "random"), (1_000_003, 20_011, "random"),
    (1_000_003, 20_011, "runs"), (TILE, TILE, "random")])
def test_cuda_merge_scatter_equals_plain(n_old, n_delta, kind):
    """Byte for byte on every edge: every delta row before all residents
    (r = 0) and after them (r = n_old), long runs of equal r (one past a
    tile's staged slice of 2,048 ranks), n_delta = 1, n_old off the tile,
    an empty side; 1-, 2-, 4- and 8-byte columns in one launch."""
    _kernel_vs_plain(n_old, n_delta, _ranks(kind, n_old, n_delta, 7))


@pytest.mark.gpu
def test_cuda_merge_scatter_at_the_int32_limit():
    """A merged table of 2^31 - 1 rows (the most the reference's int32
    ranks address), ranks up to n_old: the kernel's 64-bit positions place
    every row by the definition; one more row raises."""
    dev = _cuda()
    n_delta = 5
    n_old = (1 << 31) - 1 - n_delta
    old = torch.arange(n_old, dtype=torch.int32, device=dev).remainder_(
        251).to(torch.uint8)
    delta = torch.full((n_delta,), 255, dtype=torch.uint8, device=dev)
    r = torch.tensor([0, 7, n_old // 2, n_old, n_old], dtype=torch.int32,
                     device=dev)
    before = tmerge.merge_scatter.launches
    (out,) = tmerge.merge_scatter([old], [delta], r)
    torch.cuda.synchronize()
    assert tmerge.merge_scatter.launches == before + 1
    # the definition, written out: residents fill the runs between the
    # delta rows' positions r[j] + j, in order
    want = torch.empty_like(out)
    at = src = 0
    for j, rj in enumerate(r.tolist()):
        want[at:rj + j] = old[src:rj]
        want[rj + j] = delta[j]
        at, src = rj + j + 1, rj
    want[at:] = old[src:]
    assert torch.equal(out, want)
    del out, want
    with pytest.raises(ValueError, match="int32"):
        tmerge.merge_scatter([torch.cat([old, old[:1]])], [delta], r)


@pytest.mark.gpu
def test_cuda_device_table_merge_equals_cpu():
    """``DeviceTable.merge_scatter`` on the card (one launch: the columns
    and the int64 permutation) equals the CPU run, stale column
    included."""
    dev = _cuda()
    n_old, n_delta = 70_001, 3_001
    old = _resident(n_old, 1)
    delta = _resident(n_delta, 2)
    r = _ranks("runs", n_old, n_delta, 3)
    rng = np.random.default_rng(4)
    perm = torch.from_numpy(rng.permutation(n_old))
    p_d = rng.permutation(n_delta)
    codes = {"name": rng.integers(0, 5, n_old + n_delta).astype(np.int32)}
    out = {}
    for d, launched in (("cpu", 0), ("cuda", 1)):
        tab = DeviceTable.from_numpy(old, d)
        before = tmerge.merge_scatter.launches
        out[d] = DeviceTable.merge_scatter(
            tab, delta, r, stale=["name"], full_codes=codes,
            perm_pair=(perm.to(dev if launched else "cpu"), n_old + p_d))
        assert tmerge.merge_scatter.launches == before + launched
    (ct, cp), (gt, gp) = out["cpu"], out["cuda"]
    assert torch.equal(gp.cpu(), cp)
    for k in ct.columns:
        assert torch.equal(gt[k].cpu(), ct[k]), k


@pytest.mark.gpu
def test_cuda_store_flush_merges_through_the_kernel():
    """A store on the card: appends land in the delta, the flush merges
    through ``merge_scatter`` (one launch), and the index state and
    answers equal the same store on the CPU."""
    _cuda()
    stores = {}
    for d in ("cpu", "cuda"):
        s = DataStoreFinder.get_data_store(type="torch", device=d)
        s.create_schema("t", SPEC)
        sft = s.get_schema("t")
        s.load("t", TTable.build(sft, _data(40_000, 1)))
        s.load("t", TTable.build(sft, _data(1_500, 2, 1)))
        s.load("t", TTable.build(sft, _data(700, 3, 2)))
        before = tmerge.merge_scatter.launches
        s.flush("t")
        assert tmerge.merge_scatter.launches == before + (d == "cuda")
        stores[d] = s
    ci, gi = (stores[d].planners["t"].indexes[0] for d in ("cpu", "cuda"))
    assert torch.equal(gi.perm.cpu(), ci.perm)
    assert np.array_equal(gi.sorted_z, ci.sorted_z)
    for k in ci.device.columns:
        assert torch.equal(gi.device[k].cpu(), ci.device[k]), k
    for q in (Q, "name = 's2'", "INCLUDE"):
        assert stores["cuda"].count("t", q) == stores["cpu"].count("t", q)
        assert np.array_equal(stores["cuda"].query("t", q).indices,
                              stores["cpu"].query("t", q).indices)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [1000, 4096, 1 << 30])
def test_cuda_native_build_equals_cpu(chunk):
    """The native build on the card — the encode of chunk i+1 overlapped
    with chunk i's pinned side-stream upload, the device sort and the
    gathers — against the same table's build on the CPU: one permutation
    and byte-equal columns and host keys (``chunk`` past the table: one
    encode and one upload)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
    from geomesa_tpu_torch.index.spatial import Z3Index
    n = 20_011
    rng = np.random.default_rng(3)
    x, y = rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)
    base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
    dtg = base + rng.integers(0, 60 * 86400000, n)
    dup = np.arange(0, n, 7)[1:]
    x[dup], y[dup], dtg[dup] = x[dup - 1], y[dup - 1], dtg[dup - 1]
    sft = TSFT.from_spec("t", "val:Int,dtg:Date,*geom:Point;"
                         "geomesa.z3.interval=week")
    table = TTable.build(sft, {"val": rng.integers(0, 9, n).astype(np.int32),
                               "dtg": dtg, "geom": (x, y)})
    tconfig.BUILD_STREAM_CHUNK.set(chunk)
    try:
        gpu, cpu = Z3Index(sft, table, "cuda"), Z3Index(sft, table, "cpu")
    finally:
        tconfig.BUILD_STREAM_CHUNK.unset()
    first = "encode_upload_overlap_s" if chunk < n else "encode_s"
    assert first in gpu.build_stages
    assert torch.equal(gpu.perm.cpu(), cpu.perm)
    assert list(gpu.device.columns) == list(cpu.device.columns)
    for k, v in cpu.device.columns.items():
        assert torch.equal(gpu.device.columns[k].cpu(), v), k
    assert np.array_equal(gpu._z, cpu._z)
    assert np.array_equal(gpu._bins, cpu._bins)
    keys = [cpu._bins, cpu._z]
    assert np.array_equal(cpu.perm.numpy(), np.lexsort(tuple(reversed(keys))))
