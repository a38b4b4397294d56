"""The port's aggregation hints — ``stats``, ``bin`` and ``sample`` through
``TorchDataStore.query`` — and the masked histograms under the stats scan,
against the JAX package on one seeded, labelled table (8,000 points, gather
blocks of 512 rows):

- the ``stats`` hint for every device-reduced kind (Count, Histogram on an
  Int and on a Float column, Z2Histogram, Enumeration,
  ``GroupBy(…,Count())``) and a mixed spec with host kinds, over INCLUDE, a
  box and window, an OR (the union mask), and a polygon that refines on
  the host (no mask), under auths that allow some, all and none of the
  labels — every sketch dict equal to the reference's. The reference reads
  ``plan.index`` of an OR's union plan, which is None, and raises; there
  its answer is its own ``observe_on_device`` over its union mask and the
  branches' index;
- the plain histograms (``_masked_hist``, ``_masked_grid``,
  ``_masked_bincount``) against the reference's jitted programs on values
  on bin and cell edges and one f32 ulp either side, far outside the range,
  NaN and ±inf, an empty range, and codes outside the vocabulary — equal;
  and the two Z2 binnings (the device's f32 reciprocal, the host's f64
  division) on cell-edge points, each equal to the reference's own;
- ``bin`` with and without ``label`` and ``sort`` (compared as bytes) and
  ``sample`` with n = 1, 7 and 100, with and without ``by`` — rows and
  hydrated ids equal; the three hints over a pending delta (flushed first,
  as the reference's).

The ``gpu`` tests hold the ``masked_hist`` CUDA kernel to its plain version
on the card (every form, the shared and the global route, edge values) and
the store's stats on the card to the CPU's. They import no JAX (the JAX
package is imported lazily by the CPU tests), so ``python -m pytest
--noconftest -m gpu tests/test_torch_aggregations.py`` runs them on a
machine without it."""

import importlib
import sys

import numpy as np
import pytest
import torch

from geomesa_tpu_torch import DataStoreFinder
from geomesa_tpu_torch import config as tconfig
from geomesa_tpu_torch.aggregates import stats_scan as tscan_stats
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.kernels import hist as thist
from geomesa_tpu_torch.stats import dsl as tdsl

SPEC = ("name:String,age:Int,score:Float,dtg:Date,*geom:Point;"
        "geomesa.z3.interval=week")
DURING = "dtg DURING 2020-01-03T00:00:00Z/2020-01-15T00:00:00Z"
POLY = "POLYGON((-10 20, 40 20, 40 60, -10 60, 15 40, -10 20))"
FILTERS = {
    "include": "INCLUDE",
    "box_window": f"BBOX(geom, -40, -20, 50, 45) AND {DURING}",
    "or": "BBOX(geom, -40, -20, 0, 10) OR BBOX(geom, 20, 5, 60, 40)",
    "host_refine": f"INTERSECTS(geom, {POLY}) AND age > 20",
}
AUTHS = {"none_given": None, "some": ["admin"], "all": ["admin", "secret"],
         "nothing": []}
DEVICE_SPECS = {
    "count": "Count()",
    "hist_int": 'Histogram("age",20,0,100)',
    "hist_float": 'Histogram("score",16,0.1,0.9)',
    "z2": 'Z2Histogram("geom",5)',
    "enum": 'Enumeration("name")',
    "groupby": 'GroupBy("name",Count())',
    "mixed": ('Count();Histogram("age",10,0,100);MinMax("age");TopK("name");'
              'Z2Histogram("geom",4);DescriptiveStats("score");'
              'GroupBy("name",Count())'),
}


def _ref(name: str):
    """A module of the JAX package (imported only by the CPU tests)."""
    pytest.importorskip("jax")
    return importlib.import_module(name)


def _columns(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-170, 170, n)
    y = rng.uniform(-80, 80, n)
    # some rows exactly on the 32x32 and 16x16 cell edges
    k = n // 10
    x[:k] = -180.0 + rng.integers(0, 33, k) * (360.0 / 32)
    y[k:2 * k] = -90.0 + rng.integers(0, 17, k) * (180.0 / 16)
    base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
    return {"name": rng.choice(["alpha", "beta", "gamma", "delta"], n),
            "age": rng.integers(0, 100, n).astype(np.int32),
            "score": rng.uniform(0, 1, n).astype(np.float32),
            "dtg": base + rng.integers(0, 30 * 86400000, n),
            "geom": (x, y)}


def _vis(n, seed):
    return np.random.default_rng(seed).choice(
        ["", "admin", "secret&admin", "secret"], n)


@pytest.fixture(autouse=True)
def _small_blocks():
    """512-row gather blocks in both packages (16 blocks a table)."""
    confs = [tconfig]
    if "geomesa_tpu.config" in sys.modules:
        confs.append(sys.modules["geomesa_tpu.config"])
        vars(importlib.import_module("geomesa_tpu.index.prune")).pop(
            "BLOCK_SIZE", None)
    for c in confs:
        c.PRUNE_BLOCK.set(512)
    yield
    for c in confs:
        c.PRUNE_BLOCK.unset()


def _stores(n=8000, seed=11, vis=True):
    JStore = _ref("geomesa_tpu.datastore").TpuDataStore
    JTable = _ref("geomesa_tpu.features.table").FeatureTable
    cols = _columns(n, seed)
    labels = _vis(n, seed + 1) if vis else None
    js = JStore()
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    for s, tbl in ((js, JTable), (ts, TTable)):
        s.create_schema("a", SPEC)
        s.load("a", tbl.build(s.get_schema("a"), cols, visibilities=labels))
    return js, ts


@pytest.fixture(scope="module")
def stores():
    _ref("geomesa_tpu.config").PRUNE_BLOCK.set(512)
    tconfig.PRUNE_BLOCK.set(512)
    try:
        return _stores()
    finally:
        _ref("geomesa_tpu.config").PRUNE_BLOCK.unset()
        tconfig.PRUNE_BLOCK.unset()


def _ref_stat(js, spec, f, auths):
    """The reference's stats hint; over an OR's union mask (where its
    ``run_stat`` reads ``plan.index`` = None and raises) its own device
    reductions over its union mask on the branches' index, the host kinds
    over its select."""
    try:
        return js.query("a", f, hints={"stats": spec}, auths=auths)
    except AttributeError:
        pass
    jscan = _ref("geomesa_tpu.aggregates.stats_scan")
    jdsl = _ref("geomesa_tpu.stats.dsl")
    jsk = _ref("geomesa_tpu.stats.sketches")
    planner = js.planner("a")
    stat = jdsl.parse_stat(spec)
    plan, mask = planner.scan_mask(f, auths=auths)
    index = plan.same_index_device_exact()
    assert mask is not None and plan.index is None and index is not None
    leaves = stat.stats if isinstance(stat, jsk.SeqStat) else [stat]
    host = [leaf for leaf in leaves
            if not jscan.observe_on_device(leaf, index, mask)]
    sub = planner.table.take(planner.select_indices(f, plan=plan,
                                                    auths=auths))
    for leaf in host:
        jdsl.observe_table(leaf, sub)
    return stat


@pytest.mark.parametrize("auths", list(AUTHS), ids=list(AUTHS))
@pytest.mark.parametrize("filt", list(FILTERS), ids=list(FILTERS))
@pytest.mark.parametrize("spec", list(DEVICE_SPECS), ids=list(DEVICE_SPECS))
def test_stats_hint_equals_reference(stores, spec, filt, auths):
    js, ts = stores
    f, a, sp = FILTERS[filt], AUTHS[auths], DEVICE_SPECS[spec]
    got = ts.query("a", f, hints={"stats": sp}, auths=a)
    want = _ref_stat(js, sp, f, a)
    assert got.to_dict() == want.to_dict()
    if spec == "count":
        assert got.count == ts.count("a", f, auths=a)


def test_stats_hint_goes_through_the_kernel_wrapper(stores, monkeypatch):
    """A masked scan's histogram kinds reduce through ``kernels.hist``
    (its plain version on the CPU), one call a device leaf; a host-refined
    filter has no mask and calls none."""
    _, ts = stores
    calls = []
    real = thist.masked_hist

    def spy(form, *a, **k):
        calls.append(form)
        return real(form, *a, **k)
    monkeypatch.setattr(thist, "masked_hist", spy)
    ts.query("a", FILTERS["box_window"],
             hints={"stats": DEVICE_SPECS["mixed"]})
    assert sorted(calls) == ["bincount", "grid", "hist"]
    calls.clear()
    ts.query("a", FILTERS["host_refine"], hints={"stats": 'Z2Histogram("geom",5)'})
    assert calls == []


# -- the plain histograms against the reference's programs --------------------


def _edges_and_more(lo, hi, bins, rng):
    f32 = np.float32
    edges = (f32(lo) + (f32(hi) - f32(lo)) * np.arange(bins + 1,
                                                       dtype=f32) / f32(bins))
    around = [edges]
    for d in range(1, 4):
        around.append(np.nextafter(edges, f32(np.inf)))
        around.append(np.nextafter(edges, f32(-np.inf)))
        edges = around[-2]
    special = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30, 3e9, -3e9,
                        lo, hi], dtype=f32)
    rand = rng.uniform(lo - (hi - lo), hi + (hi - lo), 20000).astype(f32)
    # every binade of the subnormals and the least normals, both signs
    tiny = np.finfo(f32).tiny
    sub = (tiny * rng.uniform(-2.0, 2.0, 2000) * np.exp2(
        -rng.integers(0, 24, 2000))).astype(f32)
    return np.concatenate(around + [special, rand, sub]).astype(f32)


@pytest.mark.parametrize("lo,hi,bins", [(0.0, 100.0, 20), (0.3, 77.7, 7),
                                        (-5.0, 5.0, 1), (2.0, 2.0, 10),
                                        (0.1, 0.9, 16), (-1e6, 1e6, 1000),
                                        (0.0, 1e38, 3), (0.0, 1e-40, 8),
                                        (1e-39, 2.5e-39, 5),
                                        (1e-40, 1.0, 10), (-3e-39, 1.0, 7),
                                        (0.0, 1e-37, 20), (2e-38, 1e-37, 20),
                                        (0.0, 1e-36, 4096),
                                        (-1e-37, 1e-37, 4096),
                                        (0.0, 20 * 2.0**-100, 20),
                                        (0.0, 20 * 2.0**-101, 20)])
def test_plain_masked_hist_equals_reference(lo, hi, bins):
    jnp = _ref("jax.numpy")
    jscan = _ref("geomesa_tpu.aggregates.stats_scan")
    rng = np.random.default_rng(bins)
    vals = _edges_and_more(lo, hi, bins, rng)
    ints = np.concatenate([rng.integers(-200, 200, 5000),
                           np.array([2**31 - 1, -2**31, 0, 2**24 + 1])]
                          ).astype(np.int32)
    for col in (vals, ints):
        mask = rng.random(len(col)) < 0.7
        want = np.asarray(jscan._masked_hist(
            jnp.asarray(col), jnp.asarray(mask), np.float32(lo),
            np.float32(hi), bins))
        got = tscan_stats._masked_hist(torch.from_numpy(col),
                                       torch.from_numpy(mask),
                                       float(np.float32(lo)),
                                       float(np.float32(hi)), bins)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
        # the wrapper's CPU route is the plain version
        via = thist.masked_hist("hist", torch.from_numpy(mask),
                                torch.from_numpy(col), lo=lo, hi=hi,
                                bins=bins)
        assert np.array_equal(via.numpy(), want)


@pytest.mark.parametrize("g", [1, 4, 32, 64])
def test_plain_masked_grid_equals_reference_on_cell_edges(g):
    jnp = _ref("jax.numpy")
    jscan = _ref("geomesa_tpu.aggregates.stats_scan")
    rng = np.random.default_rng(g)
    x = _edges_and_more(-180.0, 180.0, g, rng)
    y = _edges_and_more(-90.0, 90.0, g, rng)
    n = min(len(x), len(y))
    x, y = x[:n], rng.permutation(y)[:n]
    mask = rng.random(n) < 0.8
    want = np.asarray(jscan._masked_grid(jnp.asarray(x), jnp.asarray(y),
                                         jnp.asarray(mask), g))
    got = thist.masked_hist("grid", torch.from_numpy(mask),
                            torch.from_numpy(x), torch.from_numpy(y), bins=g)
    assert got.shape == (g, g) and np.array_equal(got.numpy(), want)


def test_z2_device_and_host_binnings_differ_on_edges():
    """On cell-edge points the device's f32 reciprocal and the host sketch's
    f64 division can bin differently; each route equals the reference's
    own."""
    jnp = _ref("jax.numpy")
    jscan = _ref("geomesa_tpu.aggregates.stats_scan")
    jsk = _ref("geomesa_tpu.stats.sketches")
    from geomesa_tpu_torch.stats import sketches as tsk
    g = 32
    k = np.arange(g + 1)
    x = np.concatenate([(-180.0 + k * 360.0 / g).astype(np.float32)] + [
        np.nextafter((-180.0 + k * 360.0 / g).astype(np.float32),
                     np.float32(s * np.inf)) for s in (-1, 1)])
    y = np.zeros_like(x)
    mask = np.ones(len(x), bool)
    dev_t = thist.masked_hist("grid", torch.from_numpy(mask),
                              torch.from_numpy(x), torch.from_numpy(y),
                              bins=g).numpy()
    dev_j = np.asarray(jscan._masked_grid(jnp.asarray(x), jnp.asarray(y),
                                          jnp.asarray(mask), g))
    host_t, host_j = tsk.Z2HistogramStat("g", 5), jsk.Z2HistogramStat("g", 5)
    host_t.observe(x.astype(np.float64), y.astype(np.float64))
    host_j.observe(x.astype(np.float64), y.astype(np.float64))
    assert np.array_equal(dev_t, dev_j)
    assert host_t.to_dict() == host_j.to_dict()
    assert not np.array_equal(dev_t.astype(np.int64), host_t.counts)


def test_plain_masked_bincount_equals_reference():
    jnp = _ref("jax.numpy")
    jscan = _ref("geomesa_tpu.aggregates.stats_scan")
    rng = np.random.default_rng(5)
    for n in (1, 5, 300):
        codes = np.concatenate([rng.integers(-2 * n - 3, 2 * n + 3, 4000),
                                [-1, -n, -n - 1, n, n - 1, 0]]).astype(np.int32)
        mask = rng.random(len(codes)) < 0.6
        want = np.asarray(jscan._masked_bincount(
            jnp.asarray(codes), jnp.asarray(mask), n))
        got = thist.masked_hist("bincount", torch.from_numpy(mask),
                                torch.from_numpy(codes), bins=n)
        assert np.array_equal(got.numpy(), want)
    empty = thist.masked_hist("bincount", torch.zeros(3, dtype=torch.bool),
                              torch.zeros(3, dtype=torch.int32), bins=0)
    assert empty.shape == (0,)


def test_masked_hist_wrapper_rejects_bad_inputs():
    m = torch.ones(4, dtype=torch.bool)
    c = torch.zeros(4, dtype=torch.int32)
    for args, kw in (((m, c), {"bins": 4}),                 # no form
                     (("nope", m, c), {"bins": 4}),
                     (("hist", m, c.to(torch.int64)), {"bins": 4}),
                     (("hist", m, c), {"bins": 0}),
                     (("grid", m, c.float()), {"bins": 4}),
                     (("hist", m, c[:3]), {"bins": 4}),
                     (("bincount", m.int(), c), {"bins": 4})):
        with pytest.raises((TypeError, ValueError)):
            thist.masked_hist(*args, **kw)


# -- bin and sample --------------------------------------------------------------


BIN_HINTS = [{"track": "name"}, {"track": "name", "sort": True},
             {"track": "name", "label": "name", "sort": True},
             {"track": "age", "label": "age"}, {"track": "score"}]


@pytest.mark.parametrize("auths", ["none_given", "some", "nothing"])
@pytest.mark.parametrize("filt", ["include", "box_window", "or",
                                  "host_refine"])
@pytest.mark.parametrize("hint", range(len(BIN_HINTS)))
def test_bin_hint_bytes_equal(stores, hint, filt, auths):
    js, ts = stores
    q = {"bin": BIN_HINTS[hint]}
    got = ts.query("a", FILTERS[filt], hints=q, auths=AUTHS[auths])
    want = js.query("a", FILTERS[filt], hints=q, auths=AUTHS[auths])
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("auths", ["none_given", "some"])
@pytest.mark.parametrize("filt", ["include", "box_window", "or",
                                  "host_refine"])
@pytest.mark.parametrize("sample", [1, 7, 100, {"n": 7}, {"n": 1, "by": "name"},
                                    {"n": 7, "by": "name"},
                                    {"n": 100, "by": "age"}],
                         ids=lambda s: str(s).replace(" ", ""))
def test_sample_hint_equal(stores, sample, filt, auths):
    js, ts = stores
    got = ts.query("a", FILTERS[filt], hints={"sample": sample},
                   auths=AUTHS[auths])
    want = js.query("a", FILTERS[filt], hints={"sample": sample},
                    auths=AUTHS[auths])
    assert np.array_equal(got.indices, want.indices)
    assert list(map(str, got.table.fids)) == list(map(str, want.table.fids))


def test_aggregation_hints_over_a_pending_delta():
    """``bin``, ``stats`` and ``sample`` read the merged state: the pending
    delta flushes first, in both packages, and the answers agree."""
    js, ts = _stores(n=6000, seed=21, vis=False)
    JTable = _ref("geomesa_tpu.features.table").FeatureTable
    more = _columns(500, 22)
    for s, tbl in ((js, JTable), (ts, TTable)):
        s.load("a", tbl.build(s.get_schema("a"), more))
        assert s.deltas["a"] is not None
    f = FILTERS["box_window"]
    got = ts.query("a", f, hints={"stats": DEVICE_SPECS["mixed"]})
    assert ts.deltas["a"] is None
    assert got.to_dict() == js.query(
        "a", f, hints={"stats": DEVICE_SPECS["mixed"]}).to_dict()
    assert js.deltas["a"] is None
    for s, tbl in ((js, JTable), (ts, TTable)):
        s.load("a", tbl.build(s.get_schema("a"), _columns(300, 23)))
    b = {"bin": {"track": "name", "sort": True}}
    assert ts.query("a", f, hints=b).tobytes() \
        == js.query("a", f, hints=b).tobytes()
    assert ts.deltas["a"] is None
    for s, tbl in ((js, JTable), (ts, TTable)):
        s.load("a", tbl.build(s.get_schema("a"), _columns(200, 24)))
    sm = {"sample": {"n": 3, "by": "name"}}
    assert np.array_equal(ts.query("a", f, hints=sm).indices,
                          js.query("a", f, hints=sm).indices)
    assert ts.deltas["a"] is None and len(ts.tables["a"]) == 7000


def test_stats_observe_table_after_select(stores):
    """The host path's shared select: MinMax/TopK/Descriptive over the
    selected rows equal ``observe_table`` of the same rows."""
    _, ts = stores
    f = FILTERS["box_window"]
    spec = 'MinMax("age");TopK("name");DescriptiveStats("score")'
    got = ts.query("a", f, hints={"stats": spec})
    planner = ts.planner("a")
    want = tdsl.parse_stat(spec)
    tdsl.observe_table(want, planner.table.take(planner.select_indices(f)))
    assert got.to_dict() == want.to_dict()


# -- the CUDA kernel against its plain version (on the card) ------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _kernel_inputs(form, n, mask_kind, bins, seed):
    rng = np.random.default_rng(seed)
    m = {"all": np.ones(n, bool), "none": np.zeros(n, bool),
         "random": rng.random(n) < 0.3,
         "runs": np.repeat(rng.random(-(-n // 777)) < 0.3, 777)[:n]}[mask_kind]
    if form == "hist_f32":
        cols = (_edges_and_more(-3.0, 7.5, bins, rng)[:n]
                if n >= 100 else rng.uniform(-5, 9, n).astype(np.float32),)
        cols = (np.resize(cols[0], n).astype(np.float32),)
    elif form == "hist_i32":
        cols = (rng.integers(-50, 150, n).astype(np.int32),)
    elif form == "grid":
        cols = (np.resize(_edges_and_more(-180.0, 180.0, bins, rng), n),
                np.resize(_edges_and_more(-90.0, 90.0, bins, rng)[::-1], n))
    else:
        cols = (rng.integers(-bins - 2, bins + 2, n).astype(np.int32),)
    return m, cols


@pytest.mark.gpu
@pytest.mark.parametrize("mask_kind", ["all", "none", "random", "runs"])
@pytest.mark.parametrize("n", [1, 31, 129, 100_003, 2_000_001])
@pytest.mark.parametrize("form,bins", [
    ("hist_f32", 20), ("hist_f32", 1), ("hist_i32", 7), ("hist_i32", 20_000),
    ("grid", 32), ("grid", 1), ("grid", 128),
    ("bincount", 4), ("bincount", 12_288), ("bincount", 100_000)])
def test_cuda_masked_hist_equals_plain(form, bins, n, mask_kind):
    dev = _cuda()
    m, cols = _kernel_inputs(form, n, mask_kind, bins, seed=bins + n)
    mt = torch.from_numpy(m).to(dev)
    ct = [torch.from_numpy(np.ascontiguousarray(c)).to(dev) for c in cols]
    kind = {"hist_f32": "hist", "hist_i32": "hist"}.get(form, form)
    kw = {"lo": -3.0, "hi": 7.5} if kind == "hist" else {}
    before = thist.masked_hist.launches
    got = thist.masked_hist(kind, mt, *ct, bins=bins, **kw)
    torch.cuda.synchronize()
    assert thist.masked_hist.launches == before + 1
    want = tscan_stats.masked_hist(kind, mt, *ct, bins=bins,
                                   **{k: float(np.float32(v))
                                      for k, v in kw.items()})
    assert torch.equal(got, want)
    assert int(got.sum()) <= int(m.sum())


@pytest.mark.gpu
def test_cuda_masked_hist_back_to_back_and_views():
    """Calls on one stream in a row, and a mask that is a view at an odd
    offset (1-byte aligned)."""
    dev = _cuda()
    rng = np.random.default_rng(3)
    col = torch.from_numpy(rng.uniform(0, 1, 500_001).astype(np.float32)
                           ).to(dev)
    base = torch.from_numpy(rng.random(500_002) < 0.5).to(dev)
    mask = base[1:]
    outs = [thist.masked_hist("hist", mask, col, lo=0.0, hi=1.0, bins=b)
            for b in (3, 50, 12_289, 3)]
    torch.cuda.synchronize()
    for b, o in zip((3, 50, 12_289, 3), outs):
        want = tscan_stats.masked_hist("hist", mask, col, lo=0.0, hi=1.0,
                                       bins=b)
        assert torch.equal(o, want)
    assert torch.equal(outs[0], outs[3])


@pytest.mark.gpu
def test_cuda_store_stats_equal_cpu():
    """The stats hint on the card (the kernel behind ``fused_scan``'s mask)
    equals the CPU's (the plain versions) for every spec and filter."""
    _cuda()
    cols = _columns(60_000, 31)
    labels = _vis(60_000, 32)
    out = {}
    for device in ("cuda", "cpu"):
        s = DataStoreFinder.get_data_store(type="torch", device=device)
        s.create_schema("a", SPEC)
        s.load("a", TTable.build(s.get_schema("a"), cols,
                                 visibilities=labels))
        out[device] = [s.query("a", f, hints={"stats": sp},
                               auths=a).to_dict()
                       for f in FILTERS.values()
                       for sp in DEVICE_SPECS.values()
                       for a in (None, ["admin"])]
        out[device].append(s.stats("a").to_dict())
    assert out["cuda"] == out["cpu"]


def _masks(n, seed):
    """Masks of long runs (all-zero and all-set 16-byte vectors), of
    random bytes and of isolated rows."""
    rng = np.random.default_rng(seed)
    runs = np.repeat(rng.random(-(-n // 4096)) < 0.5, 4096)[:n]
    return {"runs": runs, "random": rng.random(n) < 0.5,
            "isolated": rng.random(n) < 0.002}


@pytest.mark.gpu
@pytest.mark.parametrize("offset", list(range(1, 16)))
@pytest.mark.parametrize("n", [37, 100_003])
@pytest.mark.parametrize("form,bins", [("hist", 20), ("hist", 5000),
                                       ("grid", 32), ("bincount", 3),
                                       ("bincount", 50)])
def test_cuda_masked_hist_mask_offsets(offset, n, form, bins):
    """Masks that are views at byte offsets 1 to 15 (the scalar head up to
    the 16-byte boundary), lengths not a multiple of 16 (the scalar tail),
    columns as views at the same row offset (unaligned column vectors),
    masks of long runs, random bytes and isolated rows."""
    dev = _cuda()
    rng = np.random.default_rng(offset * 100 + bins)
    total = n + offset
    if form == "hist":
        cols = [rng.uniform(-5, 110, total).astype(np.float32)]
        kw = {"lo": 0.0, "hi": 100.0}
    elif form == "grid":
        cols = [rng.uniform(-190, 190, total).astype(np.float32),
                rng.uniform(-95, 95, total).astype(np.float32)]
        kw = {}
    else:
        cols = [rng.integers(-bins - 2, bins + 2, total).astype(np.int32)]
        kw = {}
    ct = [torch.from_numpy(c).to(dev)[offset:] for c in cols]
    for kind, m in _masks(total, offset + n).items():
        mt = torch.from_numpy(m).to(dev)[offset:]
        got = thist.masked_hist(form, mt, *ct, bins=bins, **kw)
        torch.cuda.synchronize()
        want = tscan_stats.masked_hist(form, mt, *ct, bins=bins, **kw)
        assert torch.equal(got, want), kind


@pytest.mark.gpu
@pytest.mark.parametrize("lo,hi,bins", [
    (0.0, 100.0, 20), (0.3, 77.7, 7), (-5.0, 5.0, 1), (0.1, 0.9, 16),
    (-1e6, 1e6, 1000), (0.0, 1.0, 4096), (0.0, 1.0, 4097),
    (-1e30, 1e30, 100), (7.5, -3.0, 20), (2.0, 2.0, 10),
    (0.0, 1e-40, 8), (1e-39, 2.5e-39, 5), (0.0, 1e38, 3),
    (1e-40, 1.0, 10), (-3e-39, 1.0, 7), (0.0, 1e-37, 20),
    (2e-38, 1e-37, 20), (0.0, 1e-36, 4096), (-1e-37, 1e-37, 4096),
    (0.0, 20 * 2.0**-100, 20), (0.0, 20 * 2.0**-101, 20)])
@pytest.mark.parametrize("col", ["f32", "i32"])
def test_cuda_masked_hist_edges_exact(lo, hi, bins, col):
    """HIST on values at lo + k (hi - lo) / bins and their f32 neighbours
    (and NaN, +-inf, huge values): hi > lo through the edges found by
    bisection (bins up to 4,096; 4,097 divides), hi < lo and hi == lo
    through the division, and so ranges whose reciprocal is no normal
    f32 (a subnormal range's overflows, 1e38's is subnormal), and bins
    narrower than 2^-126 and either side of the flushed guess's 2^-100,
    with values across the subnormals — every count the plain
    version's."""
    dev = _cuda()
    rng = np.random.default_rng(bins + abs(int(lo)))
    if col == "f32":
        vals = _edges_and_more(min(lo, hi), max(lo, hi), bins, rng)
    else:
        span = np.clip(np.array([lo, hi]), -2e9, 2e9).astype(np.int64)
        vals = np.concatenate([
            np.arange(min(span) - 3, min(span) + 40),
            np.arange(max(span) - 40, max(span) + 3),
            rng.integers(min(span) - 50, max(span) + 50, 20000),
            [2**31 - 1, -2**31, 0]]).clip(-2**31, 2**31 - 1).astype(np.int32)
    vt = torch.from_numpy(np.ascontiguousarray(vals)).to(dev)
    for m in (np.ones(len(vals), bool), rng.random(len(vals)) < 0.6):
        mt = torch.from_numpy(m).to(dev)
        got = thist.masked_hist("hist", mt, vt, lo=lo, hi=hi, bins=bins)
        torch.cuda.synchronize()
        want = tscan_stats.masked_hist("hist", mt, vt,
                                       lo=float(np.float32(lo)),
                                       hi=float(np.float32(hi)), bins=bins)
        assert torch.equal(got, want)
