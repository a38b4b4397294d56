"""The port's process layer (geomesa_tpu_torch ``process/``) and its KNN
kernel against the JAX package's, on the inputs of the reference's own
``tests/test_process.py`` (every one of its cases, through both packages):

- ``knn`` at k = 1, 10, 100, 2048 (``_MAX_DEVICE_K``, the device route's
  cap) and 2049 (the radius fallback), with and without a filter, with a
  host-residual filter, with k above the matches, on a pruned cover and on
  the full-table route, and the radius memo on a second query: rows and f64
  distances equal to the reference's, byte for byte (and to a numpy brute
  force);
- proximity, route, tube, point2point, unique values, hash attribute and
  date offset equal;
- the plain ``topk_nearest`` (``index/scan.py``) and the staged modes
  ``ScanKernels.topk_nearest``/``topk_nearest_blocks`` against the
  reference's ``_haversine_f32`` + ``lax.top_k``: the raw f32 distances
  agree within TOL (below), positions equal wherever the distances around
  them are further apart than that; equal distances — duplicated points
  and the +inf past the matches — lower candidate first, equal exactly.

TOL. CUDA's and PyTorch's sin/cos/asin are not XLA's CPU functions, so the
f32 distances differ in their last bits: measured within 5 f32 ulps below
3,000 km, and up to 2.2e-4 relative near the antipode, where asin's slope
(1 / sqrt(1 - s^2)) magnifies them. The tests allow 8 ulps of the
reference's distance below 3,000 km and 5e-4 relative beyond.

The ``gpu`` tests hold the ``topk_nearest`` CUDA kernel to its plain
version on the card (FULL and BLOCKS, m from 1 to 4096, ties, +inf tails,
radix digits shared by many keys) and knn on the card to the CPU's. They
import no JAX (the JAX package is imported lazily by the CPU tests), so
``python -m pytest --noconftest -m gpu tests/test_torch_process.py`` runs
them on a machine without it."""

import importlib

import numpy as np
import pytest
import torch

from geomesa_tpu_torch import DataStoreFinder
from geomesa_tpu_torch import process as tproc
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.index import scan as tscan
from geomesa_tpu_torch.kernels import topk as ttopk
from geomesa_tpu_torch.metrics import REGISTRY as TREG

# the module (the package re-exports its ``knn`` function by that name)
tknn = importlib.import_module("geomesa_tpu_torch.process.knn")

SPEC = "track:String,v:Int,dtg:Date,*geom:Point"
BASE = np.datetime64("2024-01-01T00:00:00", "ms").astype(np.int64)


def _ref(name: str):
    """A module of the JAX package (imported only by the CPU tests)."""
    pytest.importorskip("jax")
    return importlib.import_module(name)


def _tol(d_ref: np.ndarray) -> np.ndarray:
    """The stated raw-distance tolerance (see the module docstring)."""
    d = np.asarray(d_ref, dtype=np.float32)
    ulps = 8 * np.spacing(np.abs(d)).astype(np.float64)
    return np.where(d < 3e6, ulps, 5e-4 * d.astype(np.float64))


def _world_data(n=20000, seed=17):
    rng = np.random.default_rng(seed)
    return {"track": rng.choice(["t1", "t2", "t3"], n).astype(object),
            "v": rng.integers(0, 100, n).astype(np.int32),
            "dtg": BASE + rng.integers(0, 86400000, n),
            "x": rng.uniform(-30, 30, n), "y": rng.uniform(-30, 30, n)}


def _load(store, tbl, name, spec, cols):
    store.create_schema(name, spec)
    store.load(name, tbl.build(store.get_schema(name), cols))
    return store.planner(name)


@pytest.fixture(scope="module")
def world():
    """The reference test's world in both packages: (reference planner,
    port planner, data)."""
    JStore = _ref("geomesa_tpu.datastore").TpuDataStore
    JTable = _ref("geomesa_tpu.features.table").FeatureTable
    data = _world_data()
    cols = {"track": data["track"], "v": data["v"], "dtg": data["dtg"],
            "geom": (data["x"], data["y"])}
    jp = _load(JStore(), JTable, "w", SPEC, cols)
    tp = _load(DataStoreFinder.get_data_store(type="torch", device="cpu"),
               TTable, "w", SPEC, cols)
    return jp, tp, data


def _jproc():
    return _ref("geomesa_tpu.process")


def _same_knn(jp, tp, *args, **kw):
    """knn through both packages; rows and f64 distances equal."""
    jr, jd = _jproc().knn(jp, *args, **kw)
    tr, td = tproc.knn(tp, *args, **kw)
    assert np.array_equal(tr, jr)
    assert td.dtype == jd.dtype and td.tobytes() == jd.tobytes()
    return tr, td


# -- the reference's cases through both packages -------------------------------


def test_knn_matches_bruteforce(world):
    jp, tp, data = world
    rows, dists = _same_knn(jp, tp, 5.0, 5.0, 25)
    ref_d = tproc.haversine_m(data["x"], data["y"], 5.0, 5.0)
    ref_rows = np.argsort(ref_d, kind="stable")[:25]
    assert np.array_equal(np.sort(rows), np.sort(ref_rows))
    np.testing.assert_allclose(dists, ref_d[ref_rows], rtol=1e-9)
    assert np.all(np.diff(dists) >= 0)


def test_knn_with_filter(world):
    jp, tp, data = world
    rows, _ = _same_knn(jp, tp, 0.0, 0.0, 10, f="v < 50")
    assert len(rows) == 10 and np.all(data["v"][rows] < 50)
    ref_d = tproc.haversine_m(data["x"], data["y"], 0.0, 0.0)
    ref = np.argsort(np.where(data["v"] < 50, ref_d, np.inf),
                     kind="stable")[:10]
    assert np.array_equal(np.sort(rows), np.sort(ref))


def test_knn_k_exceeds_matches(world):
    jp, tp, data = world
    rows, _ = _same_knn(jp, tp, 0.0, 0.0, 50, f="v = 7")
    assert len(rows) == min(50, int(np.sum(data["v"] == 7)))


def test_proximity_points(world):
    jp, tp, data = world
    centers = ["POINT (5 5)", "POINT (-10 -10)"]
    rows = tproc.proximity_search(tp, centers, 200_000.0)
    assert np.array_equal(rows, _jproc().proximity_search(jp, centers,
                                                          200_000.0))
    d1 = tproc.haversine_m(data["x"], data["y"], 5.0, 5.0)
    d2 = tproc.haversine_m(data["x"], data["y"], -10.0, -10.0)
    assert np.array_equal(np.sort(rows),
                          np.nonzero((d1 <= 200_000) | (d2 <= 200_000))[0])


def test_route_search(world):
    jp, tp, data = world
    route = "LINESTRING (-20 0, 0 0, 20 10)"
    rows = tproc.route_search(tp, route, 100_000.0)
    assert np.array_equal(rows, _jproc().route_search(jp, route, 100_000.0))
    assert len(rows) > 0
    vx, vy = np.array([-20.0, 0.0, 20.0]), np.array([0.0, 0.0, 10.0])
    dmin = np.min(tproc.haversine_m(data["x"][rows, None],
                                    data["y"][rows, None],
                                    vx[None, :], vy[None, :]), axis=1)
    assert np.all(dmin <= 100_000 + 2_300_000)


def test_tube_select(world):
    jp, tp, data = world
    track = [(-20.0, -20.0, int(BASE)),
             (0.0, 0.0, int(BASE + 12 * 3600_000)),
             (20.0, 20.0, int(BASE + 24 * 3600_000))]
    rows = tproc.tube_select(tp, track, buffer_m=150_000.0)
    assert np.array_equal(rows, _jproc().tube_select(jp, track,
                                                     buffer_m=150_000.0))
    t = np.clip(data["dtg"], BASE, BASE + 24 * 3600_000)
    w = (t - BASE) / (24 * 3600_000)
    ix = np.where(w <= 0.5, -20 + w * 2 * 20, 0 + (w - 0.5) * 2 * 20)
    d = tproc.haversine_m(data["x"], data["y"], ix, ix)
    assert np.array_equal(np.sort(rows), np.nonzero(d <= 150_000)[0])


def test_tube_high_latitude_buffer():
    JStore = _ref("geomesa_tpu.datastore").TpuDataStore
    JTable = _ref("geomesa_tpu.features.table").FeatureTable
    cols = {"dtg": np.asarray([BASE + 3600_000]),
            "geom": (np.asarray([-1.5]), np.asarray([60.0]))}
    track = [(0.0, 0.0, int(BASE)), (0.0, 60.0, int(BASE + 3600_000))]
    jp = _load(JStore(), JTable, "hl", "dtg:Date,*geom:Point", cols)
    tp = _load(DataStoreFinder.get_data_store(type="torch", device="cpu"),
               TTable, "hl", "dtg:Date,*geom:Point", cols)
    rows = tproc.tube_select(tp, track, buffer_m=100_000)
    assert len(rows) == 1
    assert np.array_equal(rows, _jproc().tube_select(jp, track,
                                                     buffer_m=100_000))


def test_proximity_polygon_interior(world):
    jp, tp, data = world
    poly = "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0))"
    rows = tproc.proximity_search(tp, [poly], 10_000.0, f="v > 3")
    assert np.array_equal(rows, _jproc().proximity_search(jp, [poly],
                                                          10_000.0,
                                                          f="v > 3"))
    inside = ((data["x"] > 0) & (data["x"] < 10) & (data["y"] > 0)
              & (data["y"] < 10) & (data["v"] > 3))
    assert np.all(np.isin(np.nonzero(inside)[0], rows))


def test_point2point(world):
    jp, tp, data = world
    for args in (("track", "v < 5"), ("track", "v < 5", True),
                 ("v", "BBOX(geom, -5, -5, 5, 5)")):
        lines = tproc.point2point(tp, *args)
        assert lines == _jproc().point2point(jp, *args)
    lines = tproc.point2point(tp, "track", "v < 5")
    m = data["v"] < 5
    ref = {tr: int(np.sum(m & (data["track"] == tr)))
           for tr in ("t1", "t2", "t3")}
    assert {val: n for val, _, n in lines} == \
        {k: v for k, v in ref.items() if v >= 2}


def test_unique_values(world):
    jp, tp, data = world
    for args in (("track",), ("track", "v < 20", True), ("v", "v > 90")):
        assert tproc.unique_values(tp, *args) \
            == _jproc().unique_values(jp, *args)
    vals = tproc.unique_values(tp, "track", sort_by_count=True)
    uniq, cnt = np.unique(data["track"], return_counts=True)
    assert dict(vals) == {v: int(c) for v, c in zip(uniq, cnt)}
    assert vals[0][1] == max(cnt)


def test_hash_attribute(world):
    jp, tp, _ = world
    for attr, f in (("track", "INCLUDE"), ("v", "v < 30")):
        h = tproc.hash_attribute(tp, attr, 16, f)
        assert np.array_equal(h, _jproc().hash_attribute(jp, attr, 16, f))
    h = tproc.hash_attribute(tp, "track", 16)
    assert h.min() >= 0 and h.max() < 16


def test_date_offset(world):
    jp, tp, data = world
    out = tproc.date_offset(tp, 3600_000, "v = 1")
    want = _jproc().date_offset(jp, 3600_000, "v = 1")
    assert np.array_equal(np.asarray(out.columns["dtg"]),
                          np.asarray(want.columns["dtg"]))
    rows = tp.select_indices("v = 1")
    assert np.array_equal(np.asarray(out.columns["dtg"]),
                          data["dtg"][rows] + 3600_000)


def test_knn_zero_doublings_fallback(world):
    jp, tp, data = world
    jknn = _ref("geomesa_tpu.process.knn")
    want = jknn._radius_knn(jp, 5.0, 5.0, 5, None, initial_radius_m=500_000.0,
                            max_doublings=0)
    rows, dists = tknn._radius_knn(tp, 5.0, 5.0, 5, None,
                                   initial_radius_m=500_000.0,
                                   max_doublings=0)
    assert np.array_equal(rows, want[0]) and np.array_equal(dists, want[1])
    ref_d = tproc.haversine_m(data["x"], data["y"], 5.0, 5.0)
    assert np.array_equal(np.sort(rows),
                          np.sort(np.argsort(ref_d, kind="stable")[:5]))


def test_knn_host_residual_filter_falls_back(world):
    jp, tp, data = world
    f = "INTERSECTS(geom, POLYGON ((-20 -20, 20 -21, 21 20, -21 19, -20 -20)))"
    rows, _ = _same_knn(jp, tp, 0.0, 0.0, 8, f=f)
    from geomesa_tpu_torch.filter.evaluate import evaluate
    from geomesa_tpu_torch.filter.parser import parse_ecql
    mask = evaluate(parse_ecql(f), tp.table)
    ref_d = tproc.haversine_m(data["x"], data["y"], 0.0, 0.0)
    ref = np.argsort(np.where(mask, ref_d, np.inf), kind="stable")[:8]
    assert np.array_equal(np.sort(rows), np.sort(ref))


def _counters(reg):
    c = reg.snapshot()["counters"]
    return (c.get("knn.plan_rounds", 0), c.get("knn.device_dispatches", 0),
            c.get("knn.radius_memo_hits", 0))


@pytest.fixture(scope="module")
def dense_world():
    """A table where the range-pruned device KNN engages (the cfg4
    regime, cut from the reference test's 1,000,000 clustered points to
    200,000 spread over the world in one day — at that size the clustered
    table's covers decline): candidate covers exist and the 2048-row target
    is reachable before the cover declines."""
    JStore = _ref("geomesa_tpu.datastore").TpuDataStore
    JTable = _ref("geomesa_tpu.features.table").FeatureTable
    rng = np.random.default_rng(3)
    n = 200_000
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-90, 90, n)
    cols = {"dtg": BASE + rng.integers(0, 86400000, n), "geom": (x, y)}
    spec = "dtg:Date,*geom:Point;geomesa.z3.interval=week"
    jp = _load(JStore(), JTable, "dw", spec, cols)
    tp = _load(DataStoreFinder.get_data_store(type="torch", device="cpu"),
               TTable, "dw", spec, cols)
    return jp, tp, x, y


def test_knn_radius_memo_cuts_plan_rounds(dense_world):
    """A cold query walks the radius schedule (>= 2 plan rounds, one
    dispatch over its cover's blocks); a warm neighbour plans once and hits
    the memo — the same counts in both packages, the same answers."""
    jp, tp, x, y = dense_world
    jreg = _ref("geomesa_tpu.metrics").REGISTRY
    deltas = []
    for reg, planner, mod in ((jreg, jp, _jproc()), (TREG, tp, tproc)):
        c0 = _counters(reg)
        mod.knn(planner, 12.0, 4.0, 10)
        c1 = _counters(reg)
        mod.knn(planner, 12.02, 4.01, 10)
        c2 = _counters(reg)
        deltas.append((tuple(b - a for a, b in zip(c0, c1)),
                       tuple(b - a for a, b in zip(c1, c2))))
    assert deltas[0] == deltas[1]
    cold, warm = deltas[1]
    assert cold[1] == 1 and cold[0] >= 2
    assert warm == (1, 1, 1)
    rows, dists = _same_knn(jp, tp, 12.02, 4.01, 10)
    ref_d = tproc.haversine_m(x, y, 12.02, 4.01)
    ref = np.argsort(ref_d, kind="stable")[:10]
    assert np.array_equal(np.sort(rows), np.sort(ref))
    np.testing.assert_allclose(dists, ref_d[ref], rtol=1e-9)


# -- knn shapes ---------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 10, 100, 2048, 2049])
@pytest.mark.parametrize("f", [None, "v < 50",
                               "dtg DURING 2024-01-01T03:00:00Z/"
                               "2024-01-01T20:00:00Z AND v > 10"])
def test_knn_k_and_filters(world, k, f):
    jp, tp, data = world
    rows, dists = _same_knn(jp, tp, 3.3, -4.1, k, f=f)
    keep = np.ones(len(data["v"]), bool) if f is None else \
        (data["v"] < 50 if f == "v < 50" else None)
    if keep is not None:
        ref_d = np.where(keep, tproc.haversine_m(data["x"], data["y"],
                                                 3.3, -4.1), np.inf)
        order = np.argsort(ref_d, kind="stable")[:min(k, int(keep.sum()))]
        assert np.array_equal(np.sort(rows), np.sort(order))


@pytest.mark.parametrize("q", [(12.0, 4.0), (35.0, 20.0), (0.0, 0.0),
                               (179.0, 80.0)])
@pytest.mark.parametrize("k", [1, 10, 100, 2048, 2049])
def test_knn_pruned_and_full_table_routes(dense_world, q, k):
    """Near the data the pruned cover serves; far from it (and for k past
    the device cap) the cover declines: the full-table kernel or the
    radius fallback — equal answers either way."""
    jp, tp, x, y = dense_world
    rows, dists = _same_knn(jp, tp, q[0], q[1], k)
    ref_d = tproc.haversine_m(x, y, *q)
    ref = np.argsort(ref_d, kind="stable")[:k]
    assert np.array_equal(np.sort(rows), np.sort(ref))


def test_knn_memo_second_query_full_table(dense_world):
    """k = 2048 aims at 65,536 candidate rows, past the cover's quarter of
    the table: the walk ends at the full-table kernel, and that outcome is
    memoised — the second query skips the radius walk in both packages (one
    dispatch, no plan round)."""
    jp, tp, x, y = dense_world
    jreg = _ref("geomesa_tpu.metrics").REGISTRY
    out = []
    for reg, planner, mod in ((jreg, jp, _jproc()), (TREG, tp, tproc)):
        mod.knn(planner, 170.0, -70.0, 2048)
        c0 = _counters(reg)
        mod.knn(planner, 170.1, -70.0, 2048)
        out.append(tuple(b - a for a, b in zip(c0, _counters(reg))))
    assert out[0] == out[1] == (0, 1, 1)
    rows, _ = _same_knn(jp, tp, 170.2, -70.1, 2048)
    ref = np.argsort(tproc.haversine_m(x, y, 170.2, -70.1),
                     kind="stable")[:2048]
    assert np.array_equal(np.sort(rows), np.sort(ref))


# -- the raw top-m against the reference's programs ---------------------------


def _ref_topk(x, y, mask, q, m):
    jax = _ref("jax")
    jnp = _ref("jax.numpy")
    jscan = _ref("geomesa_tpu.index.scan")

    @jax.jit
    def run(x, y, mask, q):
        d = jscan._haversine_f32(x, y, q[0], q[1])
        d = jnp.where(mask, d, jnp.inf)
        vals, idxs = jax.lax.top_k(-d, m)
        return -vals, idxs.astype(jnp.int32)
    d, i = run(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
               jnp.asarray(np.asarray(q, np.float32)))
    return np.asarray(d), np.asarray(i)


def _assert_topk_close(got_d, got_p, want_d, want_p, d_ref_all):
    """Distances within TOL; positions equal where the reference's
    distances around them are further apart than TOL; every port position
    at most TOL beyond the reference's m-th distance."""
    got_d, want_d = np.asarray(got_d), np.asarray(want_d)
    assert got_d.dtype == np.float32 and np.asarray(got_p).dtype == np.int32
    fin = np.isfinite(want_d)
    assert np.array_equal(np.isfinite(got_d), fin)
    tol = _tol(want_d[fin])
    assert np.all(np.abs(got_d[fin].astype(np.float64) - want_d[fin]) <= tol)
    assert np.all(np.diff(got_d[fin]) >= 0)
    gap = np.full(len(want_d), np.inf)
    with np.errstate(invalid="ignore"):     # inf - inf past the matches
        dd = np.diff(want_d.astype(np.float64))
    gap[:-1] = np.minimum(gap[:-1], dd)
    gap[1:] = np.minimum(gap[1:], dd)
    sep = fin & (gap > 2 * _tol(want_d))
    sep[-1] = False   # the m-th may trade places with the (m+1)-th
    assert np.array_equal(np.asarray(got_p)[sep], np.asarray(want_p)[sep])
    # the +inf tail: lower candidate first, exactly
    assert np.array_equal(np.asarray(got_p)[~fin], np.asarray(want_p)[~fin])
    if fin.any():
        last = want_d[fin][-1]
        assert np.all(d_ref_all[np.asarray(got_p)[fin]]
                      <= last + 2 * _tol(np.array([last]))[0])


def _points(n, seed, dup=False):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-180, 180, n).astype(np.float32)
    y = rng.uniform(-90, 90, n).astype(np.float32)
    if dup:   # runs of identical points: equal distances, lower first
        h = n // 2
        x[:h] = np.repeat(x[: -(-h // 10)], 10)[:h]
        y[:h] = np.repeat(y[: -(-h // 10)], 10)[:h]
    return x, y


@pytest.mark.parametrize("m", [1, 16, 64, 4096])
@pytest.mark.parametrize("case", ["all", "sparse", "dup", "few"])
@pytest.mark.parametrize("q", [(2.0, 48.0), (-179.5, 89.0), (0.0, 0.0)])
def test_plain_topk_against_lax_top_k(m, case, q):
    n = 30_011
    x, y = _points(n, m + len(case), dup=case == "dup")
    rng = np.random.default_rng(m)
    mask = {"all": np.ones(n, bool), "dup": np.ones(n, bool),
            "sparse": rng.random(n) < 0.05,
            "few": np.isin(np.arange(n), rng.choice(n, 9, replace=False))
            }[case]
    want_d, want_p = _ref_topk(x, y, mask, q, m)
    got_d, got_p = ttopk.topk_nearest(torch.from_numpy(x),
                                      torch.from_numpy(y),
                                      torch.from_numpy(mask), q[0], q[1], m)
    jscan = _ref("geomesa_tpu.index.scan")
    d_all = np.asarray(jscan._haversine_f32(x, y, np.float32(q[0]),
                                            np.float32(q[1])))
    _assert_topk_close(got_d.numpy(), got_p.numpy(), want_d, want_p, d_all)
    if case == "dup":
        # equal distances in both lists are ordered by candidate
        for d in np.unique(got_d.numpy()):
            same = got_p.numpy()[got_d.numpy() == d]
            assert np.all(np.diff(same) > 0)


def test_plain_topk_blocks_maps_positions():
    """BLOCKS: candidate i reads row starts[i // bsz] + i % bsz (the pad
    blocks start at row 0 and are masked out) and returns that row; equal
    to FULL over the same rows."""
    x, y = _points(10_000, 5)
    bsz = 512
    starts = torch.tensor([1024, 0, 9488, 0], dtype=torch.int64)
    rows = tscan.block_rows(starts, bsz)
    mask = torch.zeros(len(rows), dtype=torch.bool)
    mask[: 3 * bsz] = True
    d, p = ttopk.topk_nearest(torch.from_numpy(x), torch.from_numpy(y),
                              mask, 10.0, 10.0, 700, starts, bsz)
    full_mask = torch.zeros(10_000, dtype=torch.bool)
    full_mask[rows[: 3 * bsz]] = True
    fd, fp = ttopk.topk_nearest(torch.from_numpy(x), torch.from_numpy(y),
                                full_mask, 10.0, 10.0, 700)
    assert torch.equal(d, fd)
    fin = torch.isfinite(d)
    assert torch.equal(p[fin], fp[fin])
    # the +inf tail: the first non-members in candidate order
    tail = p[~fin].numpy()
    want = rows[~mask].numpy()[: len(tail)]
    assert np.array_equal(tail, want)


@pytest.mark.parametrize("f", [None, "v < 50", "v = 7"])
@pytest.mark.parametrize("route", ["full", "blocks"])
def test_scan_kernels_topk_modes_equal_reference(world, f, route):
    """``ScanKernels.topk_nearest[_blocks]`` against the reference's modes
    on the same index: the same staged mask (the port's through
    ``fused_scan``), raw top-m within TOL."""
    jp, tp, data = world
    filt = "INCLUDE" if f is None else f
    jplan, tplan = jp.plan(filt), tp.plan(filt)
    m = 64
    if route == "full":
        want = jplan.index.kernels.topk_nearest(
            jplan.primary_kind, jplan.boxes_loose, jplan.windows,
            jplan.residual_device, 5.0, 5.0, m)
        got = tplan.index.kernels.topk_nearest(
            tplan.primary_kind, tplan.boxes_loose, tplan.windows,
            tplan.residual_device, 5.0, 5.0, m)
    else:
        jprune = _ref("geomesa_tpu.index.prune")
        from geomesa_tpu_torch.index import prune as tprune
        blocks = np.array([0, 1], dtype=np.int32)
        want = jplan.index.kernels.topk_nearest_blocks(
            jplan.primary_kind, jplan.boxes_loose, jplan.windows,
            jplan.residual_device, 5.0, 5.0, m, blocks, jprune.BLOCK_SIZE)
        got = tplan.index.kernels.topk_nearest_blocks(
            tplan.primary_kind, tplan.boxes_loose, tplan.windows,
            tplan.residual_device, 5.0, 5.0, m, blocks, tprune.BLOCK_SIZE)
    # sorted-row positions index the index's sorted columns
    xf = tplan.index.kernels.cols["xf"].numpy()
    yf = tplan.index.kernels.cols["yf"].numpy()
    jscan = _ref("geomesa_tpu.index.scan")
    d_all = np.asarray(jscan._haversine_f32(xf, yf, np.float32(5.0),
                                            np.float32(5.0)))
    _assert_topk_close(got[0], got[1], want[0], want[1], d_all)


def test_topk_wrapper_rejects_bad_inputs():
    x = torch.zeros(8)
    m = torch.ones(8, dtype=torch.bool)
    for args in ((x.double(), x, m, 0.0, 0.0, 1),
                 (x, x[:7], m, 0.0, 0.0, 1),
                 (x, x, m[:7], 0.0, 0.0, 1),
                 (x, x, m, 0.0, 0.0, 0),
                 (x, x, m, 0.0, 0.0, 9),
                 (x, x, m.int(), 0.0, 0.0, 1)):
        with pytest.raises((TypeError, ValueError)):
            ttopk.topk_nearest(*args)
    with pytest.raises((TypeError, ValueError)):
        ttopk.topk_nearest(x, x, m, 0.0, 0.0, 1,
                           torch.zeros(2, dtype=torch.int32), 4)


# -- the CUDA kernel against its plain version (on the card) ------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 2, 16, 33, 1000, 4096])
@pytest.mark.parametrize("n", [4096, 100_003, 3_000_017])
@pytest.mark.parametrize("case", ["all", "sparse", "dup", "few", "clustered"])
def test_cuda_topk_full_equals_plain(m, n, case):
    dev = _cuda()
    x, y = _points(n, n % 97 + m, dup=case == "dup")
    rng = np.random.default_rng(m + n)
    if case == "clustered":   # many keys share the top radix digits
        x = (2.0 + rng.normal(0, 1e-3, n)).astype(np.float32)
        y = (48.0 + rng.normal(0, 1e-3, n)).astype(np.float32)
    mask = {"sparse": rng.random(n) < 0.01,
            "few": np.isin(np.arange(n), rng.choice(n, 7, replace=False))
            }.get(case, np.ones(n, bool))
    t = [torch.from_numpy(a).to(dev) for a in (x, y, mask)]
    before = ttopk.topk_nearest.launches
    kd, kp = ttopk.topk_nearest(*t, 2.0, 48.0, m)
    torch.cuda.synchronize()
    assert ttopk.topk_nearest.launches == before + 1
    pd, pp = tscan.topk_nearest(*t, 2.0, 48.0, m)
    assert torch.equal(kd, pd), float((kd - pd).abs().max())
    assert torch.equal(kp, pp)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [16, 4096])
@pytest.mark.parametrize("bsz,nb", [(4096, 8), (4096, 64), (512, 40),
                                    (999, 17)])
def test_cuda_topk_blocks_equals_plain(m, bsz, nb):
    dev = _cuda()
    n = 300_000
    x, y = _points(n, bsz + nb)
    rng = np.random.default_rng(nb)
    live = nb - 3
    ids = np.sort(rng.choice(n // bsz, live, replace=False))
    starts = np.zeros(nb, dtype=np.int64)
    starts[:live] = np.minimum(ids * bsz, n - bsz)
    mask = np.zeros(nb * bsz, bool)
    mask[: live * bsz] = rng.random(live * bsz) < 0.5
    m = min(m, nb * bsz)
    t = [torch.from_numpy(a).to(dev) for a in (x, y, mask, starts)]
    kd, kp = ttopk.topk_nearest(t[0], t[1], t[2], -20.0, 10.0, m, t[3], bsz)
    torch.cuda.synchronize()
    pd, pp = tscan.topk_nearest(t[0], t[1], t[2], -20.0, 10.0, m, t[3], bsz)
    assert torch.equal(kd, pd) and torch.equal(kp, pp)


@pytest.mark.gpu
def test_cuda_knn_equals_cpu():
    """knn on the card (the kernel behind ``fused_scan``'s mask, pruned and
    full-table) equals the CPU's, rows and f64 distances."""
    _cuda()
    rng = np.random.default_rng(3)
    n = 200_000
    cols = {"dtg": BASE + rng.integers(0, 86400000, n),
            "geom": (np.clip(rng.normal(0, 10, n), -180, 180),
                     np.clip(rng.normal(0, 5, n), -90, 90))}
    spec = "dtg:Date,*geom:Point;geomesa.z3.interval=week"
    out = {}
    for device in ("cuda", "cpu"):
        s = DataStoreFinder.get_data_store(type="torch", device=device)
        p = _load(s, TTable, "dw", spec, cols)
        out[device] = [tproc.knn(p, qx, qy, k)
                       for qx, qy in ((12.0, 4.0), (170.0, -70.0))
                       for k in (1, 10, 2048, 2049)]
    for (a, da), (b, db) in zip(out["cuda"], out["cpu"]):
        assert np.array_equal(a, b) and np.array_equal(da, db)


def _bits_equal(got, want):
    """Distances bit for bit (NaN included) and positions equal."""
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["full", "blocks"])
@pytest.mark.parametrize("side", [0, 1])
@pytest.mark.parametrize("case", ["all", "sparse", "few", "dup"])
@pytest.mark.parametrize("m", [1, 32, 4096])
@pytest.mark.parametrize("offset", [0, 5])
def test_cuda_topk_each_side_of_the_cluster_threshold(form, side, case, m,
                                                      offset):
    """A FULL call of ``FULL_CLUSTER_MAX`` candidates, and a BLOCKS call of
    ``CLUSTER_MAX`` (blocks of 1,024 rows), take the one-cluster route; one
    candidate (one block) more the grid route. Masks and coordinates are
    views at an offset (unaligned vectors: the scalar head and tail,
    scalar coordinates)."""
    dev = _cuda()
    bsz = 1024
    n = (ttopk.FULL_CLUSTER_MAX + side if form == "full"
         else ttopk.CLUSTER_MAX + side * bsz)
    rows = n + offset + (bsz if form == "blocks" else 0)
    x, y = _points(rows, m + side, dup=case == "dup")
    rng = np.random.default_rng(m + 7 * side)
    mask = {"sparse": rng.random(n + offset) < 0.01,
            "few": np.isin(np.arange(n + offset),
                           rng.choice(n + offset, 9, replace=False))
            }.get(case, np.ones(n + offset, bool))
    t = [torch.from_numpy(a).to(dev)[offset:] for a in (x, y)]
    t.append(torch.from_numpy(mask).to(dev)[offset:])
    kw = {}
    if form == "blocks":   # block b reads rows from b * bsz + 3
        starts = np.arange(n // bsz, dtype=np.int64) * bsz + 3
        kw = {"starts": torch.from_numpy(starts).to(dev), "bsz": bsz}
    route = "grid" if side else "cluster"
    before = dict(ttopk.topk_nearest.route_launches)
    got = ttopk.topk_nearest(*t, 2.0, 48.0, m, **kw)
    torch.cuda.synchronize()
    assert ttopk.topk_nearest.route_launches[route] == before[route] + 1
    _bits_equal(got, tscan.topk_nearest(*t, 2.0, 48.0, m, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["full", "blocks"])
def test_cuda_topk_grid_route_from_two_threads(form):
    """Two threads call the grid route at once on one stream, whose
    workspace their calls share; each call's six launches go in together,
    so every result equals its plain version (a dense and a sparse mask,
    m = 4,096 and 32, so that one call's prefix or counts in the other's
    pass would show)."""
    import threading
    dev = _cuda()
    n = 3_000_017 if form == "full" else ttopk.CLUSTER_MAX + 4096
    x, y = _points(n if form == "full" else n + 4096, 29)
    t = [torch.from_numpy(a).to(dev) for a in (x, y)]
    kw = {}
    if form == "blocks":
        kw = {"starts": torch.arange(n // 4096, dtype=torch.int64,
                                     device=dev) * 4096 + 7, "bsz": 4096}
    rng = np.random.default_rng(31)
    args = [(torch.ones(n, dtype=torch.bool, device=dev), 2.0, 48.0, 4096),
            (torch.from_numpy(rng.random(n) < 0.01).to(dev), -20.0, 10.0,
             32)]
    want = [tscan.topk_nearest(*t, mask, qx, qy, m, **kw)
            for mask, qx, qy, m in args]
    got = [None, None]
    start = threading.Barrier(2)

    def run(i):
        mask, qx, qy, m = args[i]
        start.wait()
        got[i] = [ttopk.topk_nearest(*t, mask, qx, qy, m, **kw)
                  for _ in range(16)]

    before = ttopk.topk_nearest.route_launches["grid"]
    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    assert ttopk.topk_nearest.route_launches["grid"] == before + 32
    for i in range(2):
        for res in got[i]:
            _bits_equal(res, want[i])


@pytest.mark.parametrize("name", ["CLUSTER", "CAPC"])
def test_topk_cluster_shape_matches_the_kernel_source(name):
    """``topk.CLUSTER`` and ``topk.CAPC``, which size the FULL route's
    threshold, are the shape ``csrc/topk_nearest.cu`` fixes."""
    import os
    import re
    with open(os.path.join(os.path.dirname(ttopk.__file__), "csrc",
                           "topk_nearest.cu")) as fh:
        src = fh.read()
    got = re.search(rf"constexpr int {name} = (\d+);", src)
    assert got is not None and int(got.group(1)) == getattr(ttopk, name)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4099, 100_003, 3_000_017])
@pytest.mark.parametrize("live", [0, 1, 40])
@pytest.mark.parametrize("m", [16, 700, 4096])
def test_cuda_topk_equal_keys_and_inf_tails(n, live, m):
    """Every point the same (every set key equal), ``live`` of them set:
    m above the set count fills the +inf tail with the first unset
    candidates in order, m below it takes the lowest set candidates."""
    dev = _cuda()
    x = np.full(n, 2.5, np.float32)
    y = np.full(n, 47.0, np.float32)
    mask = np.zeros(n, bool)
    mask[np.random.default_rng(n + live).choice(n, live, replace=False)] = 1
    if live == 0:
        mask[:] = True                      # all set: every key equal
    t = [torch.from_numpy(a).to(dev) for a in (x, y, mask)]
    _bits_equal(ttopk.topk_nearest(*t, 2.0, 48.0, m),
                tscan.topk_nearest(*t, 2.0, 48.0, m))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1000, 100_003, 3_000_017])
@pytest.mark.parametrize("m", [8, 4096])
def test_cuda_topk_nan_coordinates(n, m):
    """Set candidates with NaN coordinates sort after the +inf of the
    unset ones, lower candidate first, NaN bits as the plain version's."""
    dev = _cuda()
    x, y = _points(n, n % 13)
    rng = np.random.default_rng(n)
    x[rng.random(n) < 0.3] = np.nan
    y[rng.random(n) < 0.1] = np.nan
    mask = rng.random(n) < 0.9
    m = min(m, n)
    t = [torch.from_numpy(a).to(dev) for a in (x, y, mask)]
    _bits_equal(ttopk.topk_nearest(*t, -20.0, 10.0, m),
                tscan.topk_nearest(*t, -20.0, 10.0, m))
    # every finite distance of a few rows, then +inf, then NaN
    few = np.zeros(n, bool)
    few[:5] = True
    t[2] = torch.from_numpy(few).to(dev)
    _bits_equal(ttopk.topk_nearest(*t, -20.0, 10.0, m),
                tscan.topk_nearest(*t, -20.0, 10.0, m))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 3, 8])
@pytest.mark.parametrize("nb", [3, 300, 700])
def test_cuda_topk_blocks_views(offset, nb):
    """BLOCKS on both routes (``nb`` blocks of 4,096: up to 2,867,200
    candidates) with a mask that is a view at an odd offset."""
    dev = _cuda()
    bsz = 4096
    n = 1_000_000
    x, y = _points(n, nb)
    rng = np.random.default_rng(offset)
    starts = np.sort(rng.integers(0, n - bsz, nb)).astype(np.int64)
    mask = rng.random(nb * bsz + offset) < 0.2
    t = [torch.from_numpy(a).to(dev) for a in (x, y, mask, starts)]
    mt = t[2][offset:]
    got = ttopk.topk_nearest(t[0], t[1], mt, -3.0, 40.0, 64, t[3], bsz)
    want = tscan.topk_nearest(t[0], t[1], mt, -3.0, 40.0, 64, t[3], bsz)
    _bits_equal(got, want)
