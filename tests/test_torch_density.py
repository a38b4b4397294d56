"""The port's density heat maps (geomesa_tpu_torch) against the JAX package.

- the plain scatter (``index/scan.py:_grid_scatter``) against the JAX
  ``_grid_scatter`` on coordinates placed exactly on cell edges, on the
  bbox's far edge and one f32 ulp either side, at 1x1, 7x5, 64x64 and
  256x256;
- ``density``/``prepare_density`` through both packages on one table, on
  each route: range-pruned blocks, the full-table mask, the fused program
  and the host;
- ``__graft_entry__.entry()``'s 64x64 grid and count against the port's for
  the same plan and table.

Tolerances: unit weights are compared byte for byte (sums of ones below
2^24 are exact in any order). Weighted cells are sums of f32 weights whose
order may differ between the packages; each order is within
gamma(n-1) * sum|w| of the exact sum (gamma(k) = k*u / (1 - k*u), u = 2^-24,
n the cell's row count), so two of them are within twice that.

The ``gpu`` tests hold the CUDA kernel to its plain version on the card:
unit weights byte for byte, weighted within the same bound. They import no
JAX (the JAX package is imported lazily by the CPU tests), so
``pytest --noconftest -m gpu tests/test_torch_density.py`` runs them on a
machine without it.
"""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

from geomesa_tpu_torch import DataStoreFinder
from geomesa_tpu_torch import config as tconfig
from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.index import compiled as tcompiled
from geomesa_tpu_torch.index import scan as tscan
from geomesa_tpu_torch.index.planner import QueryPlanner as TPlanner
from geomesa_tpu_torch.index.spatial import Z3Index as TZ3
from geomesa_tpu_torch.kernels import density as tkernel

# the module (the package re-exports its ``density`` function by that name)
tdensity = importlib.import_module("geomesa_tpu_torch.aggregates.density")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPEC = ("name:String,age:Int,score:Float,dtg:Date,*geom:Point;"
        "geomesa.z3.interval=week")
POLY = "POLYGON((-10 20, 40 20, 40 60, -10 60, 15 40, -10 20))"
DURING = "dtg DURING 2020-01-03T00:00:00Z/2020-01-15T00:00:00Z"
U = 2.0 ** -24


def _ref(name: str):
    """A module of the JAX package (imported only by the CPU tests)."""
    pytest.importorskip("jax")
    return importlib.import_module(name)


def _gamma(k):
    k = np.asarray(k, dtype=np.float64)
    return k * U / (1 - k * U)


def assert_weighted_close(got, want, n_cell, abs_sum, orders=2):
    """Per cell |got - want| <= orders * gamma(n_cell - 1) * sum|w|."""
    tol = orders * _gamma(np.maximum(n_cell - 1, 0)) * abs_sum
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert np.all(err <= tol), float(np.max(err - tol))


# -- plain scatter against the JAX scatter -----------------------------------

GRID = np.array([-60.0, -30.0, 60.0, 30.0], dtype=np.float32)
SHAPES = [(1, 1), (7, 5), (64, 64), (256, 256)]


def _edge_coords(lo, hi, cells, rng, n_rand):
    """f32 coordinates on every cell edge lo + k*(hi-lo)/cells (in f32 and
    f64 rounding), on lo and hi, one ulp either side of each, and uniform
    ones past both ends."""
    k = np.arange(cells + 1)
    e32 = (np.float32(lo) + k.astype(np.float32)
           * ((np.float32(hi) - np.float32(lo)) / np.float32(cells)))
    e64 = (lo + k * (hi - lo) / cells).astype(np.float32)
    base = np.concatenate([e32, e64, np.float32([lo, hi])])
    out = np.concatenate([base, np.nextafter(base, np.float32(np.inf)),
                          np.nextafter(base, np.float32(-np.inf)),
                          rng.uniform(lo - 5, hi + 5, n_rand).astype(np.float32)])
    return out.astype(np.float32)


def _boundary_points(w, h, seed):
    rng = np.random.default_rng(seed)
    xs = _edge_coords(GRID[0], GRID[2], w, rng, 300)
    ys = _edge_coords(GRID[1], GRID[3], h, rng, 300)
    # every x against a few ys and every y against a few xs
    px = np.concatenate([xs, rng.choice(xs, len(ys))])
    py = np.concatenate([rng.choice(ys, len(xs)), ys])
    return px.astype(np.float32), py.astype(np.float32)


def _weights(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "none":
        return None
    if kind == "int32":
        return rng.integers(-1000, 100000, n).astype(np.int32)
    return rng.normal(10.0, 30.0, n).astype(np.float32)


@pytest.mark.parametrize("weight", ["none", "int32", "f32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_scatter_equals_jax_on_cell_edges(shape, weight):
    jnp = _ref("jax.numpy")
    jscan = _ref("geomesa_tpu.index.scan")
    w, h = shape
    px, py = _boundary_points(w, h, seed=w * 7 + h)
    n = len(px)
    m = np.random.default_rng(5).random(n) < 0.8
    wt = _weights(weight, n, seed=n)
    want = np.asarray(jscan._grid_scatter(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(m),
        None if wt is None else jnp.asarray(wt), jnp.asarray(GRID), w, h))
    tw = None if wt is None else torch.from_numpy(wt)
    got, cnt = tkernel.grid_scatter(
        torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(m), tw,
        None, None, torch.from_numpy(GRID), w, h)
    assert got.dtype == torch.float32 and got.shape == (h, w)
    assert int(cnt) == int(m.sum())
    got = got.numpy()
    if wt is None:
        assert np.array_equal(got, want)
        assert got.sum() > 0
        return
    # per-cell row counts and |w| sums, from the unit grid and an |w| grid
    n_cell = np.asarray(jscan._grid_scatter(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(m), None,
        jnp.asarray(GRID), w, h))
    abs_sum = np.asarray(jscan._grid_scatter(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(m),
        jnp.abs(jnp.asarray(wt).astype(jnp.float32)), jnp.asarray(GRID), w,
        h)).astype(np.float64)
    assert_weighted_close(got, want, n_cell, abs_sum)


def test_plain_scatter_reads_through_block_starts():
    """Candidates read through clamped block starts give the grid of the
    same rows gathered first."""
    rng = np.random.default_rng(3)
    n, bsz = 1000, 64
    x = rng.uniform(-70, 70, n).astype(np.float32)
    y = rng.uniform(-40, 40, n).astype(np.float32)
    starts = np.array([0, 128, 320, n - bsz], dtype=np.int64)
    m = rng.random(len(starts) * bsz) < 0.5
    rows = (starts[:, None] + np.arange(bsz)[None, :]).reshape(-1)
    t = torch.from_numpy
    got, cnt = tkernel.grid_scatter(t(x), t(y), t(m), None, t(starts), bsz,
                                    t(GRID), 16, 8)
    want = tscan._grid_scatter(t(x[rows]), t(y[rows]), t(m), None, t(GRID),
                               16, 8)
    assert torch.equal(got, want) and int(cnt) == int(m.sum())


def test_wrapper_cpu_runs_plain_and_counts_nothing():
    before = tkernel.grid_scatter.launches
    x = torch.zeros(4)
    g, c = tkernel.grid_scatter(x, x, torch.ones(4, dtype=torch.bool), None,
                                None, None, torch.from_numpy(GRID), 3, 2)
    assert tkernel.grid_scatter.launches == before
    assert g.shape == (2, 3) and float(g[1, 1]) == 4.0 and int(c) == 4


@pytest.mark.parametrize("bad", ["dtype", "grid", "raster", "weight",
                                 "mask", "mask_length", "starts",
                                 "contiguous"])
def test_wrapper_rejects_bad_inputs(bad):
    x = torch.zeros(8)
    args = {"xf": x, "yf": x, "mask": torch.ones(8, dtype=torch.bool),
            "weight": None, "starts": None, "bsz": None,
            "grid": torch.from_numpy(GRID), "width": 4, "height": 4}
    if bad == "dtype":
        args["xf"] = torch.zeros(8, dtype=torch.float64)
    elif bad == "grid":
        args["grid"] = torch.zeros(3)
    elif bad == "raster":
        args["width"] = 0
    elif bad == "weight":
        args["weight"] = torch.zeros(8, dtype=torch.int64)
    elif bad == "mask":
        args["mask"] = torch.ones(8, dtype=torch.uint8)
    elif bad == "mask_length":
        args["mask"] = torch.ones(7, dtype=torch.bool)
    elif bad == "starts":
        args["starts"] = torch.zeros(2, dtype=torch.int64)
    else:
        args["xf"] = torch.zeros(16)[::2]
    with pytest.raises((TypeError, ValueError)):
        tkernel.grid_scatter(**args)


# -- density through both packages --------------------------------------------


def _columns(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-170, 170, n)
    y = rng.uniform(-80, 80, n)
    base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
    dtg = base + rng.integers(0, 30 * 86400000, n)
    name = rng.choice(["alpha", "beta", "gamma", "delta"], n)
    age = rng.integers(0, 100, n).astype(np.int32)
    score = rng.uniform(0, 1, n).astype(np.float32)
    return {"name": name, "age": age, "score": score, "dtg": dtg,
            "geom": (x, y)}


@pytest.fixture(autouse=True)
def _small_blocks():
    """512-row gather blocks in both packages, so the 8,000-row table has
    16 blocks and every route qualifies."""
    confs = [tconfig]
    if "geomesa_tpu.config" in sys.modules:
        confs.append(sys.modules["geomesa_tpu.config"])
        # earlier suites monkeypatch the reference's prune.BLOCK_SIZE; the
        # teardown leaves a real attribute that shadows config.PRUNE_BLOCK
        vars(importlib.import_module("geomesa_tpu.index.prune")).pop(
            "BLOCK_SIZE", None)
    for c in confs:
        c.PRUNE_BLOCK.set(512)
    yield
    for c in confs:
        c.PRUNE_BLOCK.unset()


@pytest.fixture(scope="module")
def world():
    jconfig = _ref("geomesa_tpu.config")
    JSFT = _ref("geomesa_tpu.features.sft").SimpleFeatureType
    JTable = _ref("geomesa_tpu.features.table").FeatureTable
    JPlanner = _ref("geomesa_tpu.index.planner").QueryPlanner
    JZ3 = _ref("geomesa_tpu.index.spatial").Z3Index
    vars(_ref("geomesa_tpu.index.prune")).pop("BLOCK_SIZE", None)
    cols = _columns(8000, 11)
    jconfig.PRUNE_BLOCK.set(512)
    tconfig.PRUNE_BLOCK.set(512)
    try:
        jsft = JSFT.from_spec("d", SPEC)
        jt = JTable.build(jsft, cols)
        jp = JPlanner(jsft, jt, [JZ3(jsft, jt)])
        tsft = TSFT.from_spec("d", SPEC)
        tt = TTable.build(tsft, cols)
        tp = TPlanner(tsft, tt, [TZ3(tsft, tt, "cpu")])
    finally:
        jconfig.PRUNE_BLOCK.unset()
        tconfig.PRUNE_BLOCK.unset()
    return jp, tp


BBOX = (-60.0, -30.0, 60.0, 30.0)

# (query, the route the reference's default path takes at 512-row blocks)
Q_PRUNED = ("BBOX(geom, 10, 10, 40, 40) AND dtg DURING "
            "2020-01-04T00:00:00Z/2020-01-07T00:00:00Z")
ROUTES = [
    (Q_PRUNED, "pruned"),
    (f"BBOX(geom, -60, -30, 60, 30) AND {DURING} AND age > 10", "compact"),
    ("age < 30", "compact"),
    (f"INTERSECTS(geom, {POLY}) AND {DURING}", "host"),
]


def _route(planner, plan):
    if not plan.device_exact:
        return "host"
    blocks = planner._pruned_blocks(plan)
    return "compact" if blocks is None else "pruned"


@pytest.mark.parametrize("shape", [(64, 64), (256, 256), (7, 5)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("q,route", ROUTES, ids=[r for _, r in ROUTES])
def test_density_routes_equal_reference(world, q, route, shape):
    jdensity = _ref("geomesa_tpu.aggregates.density")
    jp, tp = world
    w, h = shape
    assert _route(tp, tp.plan(q)) == route
    want = jdensity.density(jp, q, BBOX, w, h)
    got = tdensity.density(tp, q, BBOX, w, h)
    assert got.weights.dtype == np.float32 and got.weights.shape == (h, w)
    assert np.array_equal(got.weights, want.weights), q
    assert got.weights.sum() > 0
    assert (got.bbox, got.width, got.height) == (want.bbox, w, h)


STAGED = [
    (Q_PRUNED, "pruned"),
    (f"BBOX(geom, -60, -30, 60, 30) AND {DURING} AND age > 10", "compact"),
    (f"{DURING} AND age > 90", "compact"),
    ("age < 30", "compact"),
    (DURING, "compact"),
    ("INCLUDE", "compact"),
]


@pytest.mark.parametrize("weight", [None, "age"])
@pytest.mark.parametrize("q,route", STAGED, ids=[q for q, _ in STAGED])
def test_staged_density_runs_on_the_kernel(world, q, route, weight,
                                           monkeypatch):
    """The staged density of a point layer scatters ``fused_scan``'s mask
    through the blocks' starts: no torch-ops mask and no column gather,
    for plans with a box, with windows only, a residual only, or nothing
    (primary "none" is the whole box). Unit grids byte for byte, and
    ``age`` grids (small integers, exact in f32 in any order)."""
    from geomesa_tpu_torch.index import scan as tscan
    jdensity = _ref("geomesa_tpu.aggregates.density")
    jp, tp = world
    assert _route(tp, tp.plan(q)) == route
    want = jdensity.density(jp, q, BBOX, 64, 64, weight)

    def refuse(*a, **k):
        raise AssertionError("the torch-ops route ran")
    monkeypatch.setattr(tscan, "_mask_kernel", refuse)
    monkeypatch.setattr(tscan._Gather, "__getitem__", refuse)
    masks = []
    kmask = tscan.ScanKernels._kernel_mask
    monkeypatch.setattr(tscan.ScanKernels, "_kernel_mask",
                        lambda self, sc: masks.append(sc.bsz)
                        or kmask(self, sc))
    run = tdensity.prepare_density(tp, q, BBOX, 64, 64, weight)
    got = run()
    assert masks and set(masks) == {512}
    assert got.weights.dtype == np.float32
    assert np.array_equal(got.weights, want.weights), q
    assert got.weights.sum() > 0


def assert_nonneg_weighted_close(got, want, unit):
    """The weighted bound for weights >= 0, whose |w| sums are the grids
    themselves (each within gamma(n-1) of the exact sum)."""
    bound = np.maximum(got, want).astype(np.float64) * (1 + _gamma(unit))
    assert_weighted_close(got, want, unit, bound)


@pytest.mark.parametrize("weight", ["age", "score"])
@pytest.mark.parametrize("q,route", ROUTES[:3], ids=[r for _, r in ROUTES[:3]])
def test_weighted_density_equal_reference(world, q, route, weight):
    """Weights >= 0 (age is an Int column, score a Float one)."""
    jdensity = _ref("geomesa_tpu.aggregates.density")
    jp, tp = world
    want = jdensity.density(jp, q, BBOX, 64, 64, weight)
    got = tdensity.density(tp, q, BBOX, 64, 64, weight)
    unit = tdensity.density(tp, q, BBOX, 64, 64)
    assert got.weights.sum() > 0
    assert_nonneg_weighted_close(got.weights, want.weights, unit.weights)


def test_fused_density_equals_reference_program(world, monkeypatch):
    jcompiled = _ref("geomesa_tpu.index.compiled")
    jp, tp = world
    q = f"BBOX(geom, -60, -30, 60, 30) AND {DURING} AND age > 10"
    want = jcompiled.try_density(jp, jp.plan(q), BBOX, 64, 64)
    got = tcompiled.try_density(tp, tp.plan(q), BBOX, 64, 64)
    assert want is not None and got is not None
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    # the pruned branch reads every column in place through the alive
    # blocks' starts (nothing is gathered) and agrees too: a three-day
    # window keeps 5 of 16 blocks, under the cap of 8 that a 0.5 gather
    # fraction allows the reference
    seen = []
    gather = tscan._Gather.__getitem__
    monkeypatch.setattr(tscan._Gather, "__getitem__",
                        lambda self, k: seen.append(k) or gather(self, k))
    confs = (_ref("geomesa_tpu.config"), tconfig)
    for c in confs:
        c.PRUNE_MAX_FRACTION.set(0.5)
    try:
        want = jcompiled.try_density(jp, jp.plan(Q_PRUNED), BBOX, 64, 64)
        prog = tcompiled._from_plan(tp.plan(Q_PRUNED), "density", grid=BBOX,
                                    width=64, height=64)
        _, nblk, starts = prog._candidates()
        assert int(nblk[0]) == 5 and starts.shape[0] == 16
        got = tcompiled.try_density(tp, tp.plan(Q_PRUNED), BBOX, 64, 64)
    finally:
        for c in confs:
            c.PRUNE_MAX_FRACTION.unset()
    assert got[1] > 0
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    assert seen == []


def test_prepare_density_dispatch_packed_and_ladder(world, monkeypatch):
    jdensity = _ref("geomesa_tpu.aggregates.density")
    jconfig = _ref("geomesa_tpu.config")
    jp, tp = world
    q = ROUTES[1][0]
    for mode in ("auto", "sparse", "fp16", "u8", "none"):
        monkeypatch.setenv("GEOMESA_TPU_DENSITY_PACK", mode)
        jrun = jdensity.prepare_density(jp, q, BBOX, 64, 64)
        trun = tdensity.prepare_density(tp, q, BBOX, 64, 64)
        assert trun.packed() == jrun.packed(), mode
        assert np.array_equal(trun().weights, jrun().weights), mode
        assert np.array_equal(trun.dispatch().numpy(),
                              np.asarray(jrun.dispatch()))
    assert jconfig.DENSITY_PACK.get() == tconfig.DENSITY_PACK.get()
    # a u8 ladder whose cells overflow 255 steps down to the next encoding
    monkeypatch.setenv("GEOMESA_TPU_DENSITY_PACK", "auto")
    trun = tdensity.prepare_density(tp, "INCLUDE", BBOX, 1, 1)
    jrun = jdensity.prepare_density(jp, "INCLUDE", BBOX, 1, 1)
    assert np.array_equal(trun().weights, jrun().weights)
    assert trun().weights[0, 0] > 255


def jdensity_mod():
    return _ref("geomesa_tpu.aggregates.density")


def test_density_empty_and_unported(world):
    jp, tp = world
    empty = tdensity.density(
        tp, "BBOX(geom, -60, -30, 60, 30) AND dtg DURING "
        "2021-03-01T00:00:00Z/2021-03-09T00:00:00Z", BBOX, 8, 8)
    assert empty.weights.shape == (8, 8) and not empty.weights.any()
    # auths over a table without visibility labels (once refused as
    # ROADMAP.md Queue 1 item 10): every row is public, as the reference
    want = jdensity_mod().density(jp, "INCLUDE", BBOX, 8, 8,
                                  auths=["admin"]).weights
    assert np.array_equal(tdensity.density(tp, "INCLUDE", BBOX, 8, 8,
                                           auths=["admin"]).weights,
                          np.asarray(want))
    # an OR with a host-refined branch (ROADMAP.md Queue 1 item 3, now
    # ported): the per-branch select and the host grid, as the reference
    jdensity = _ref("geomesa_tpu.aggregates.density")
    q = f"BBOX(geom,0,0,1,1) OR INTERSECTS(geom, {POLY})"
    got = tdensity.density(tp, q, BBOX, 8, 8).weights
    assert got.any()
    assert np.array_equal(got, jdensity.density(jp, q, BBOX, 8, 8).weights)


def test_store_density_hint(world):
    jp, _ = world
    jdensity = _ref("geomesa_tpu.aggregates.density")
    store = DataStoreFinder.get_data_store(type="torch", device="cpu")
    sft = store.create_schema("d", SPEC)
    tconfig.PRUNE_BLOCK.set(512)
    store.load("d", TTable.build(sft, _columns(8000, 11)))
    q = ROUTES[1][0]
    grid = store.query("d", q, hints={"density": {
        "bbox": BBOX, "width": 32, "height": 16, "weight": "age"}})
    want = jdensity.density(jp, q, BBOX, 32, 16, "age")
    unit = store.query("d", q, hints={"density": {
        "bbox": BBOX, "width": 32, "height": 16}})
    assert isinstance(grid, tdensity.DensityGrid)
    assert_nonneg_weighted_close(grid.weights, want.weights, unit.weights)
    default = store.query("d", q, hints={"density": {"bbox": BBOX}})
    assert default.weights.shape == (256, 256)
    # the stats hint beside it (ROADMAP item 12 before) counts the same rows
    assert store.query("d", q, hints={"stats": "Count()"}).count \
        == jp.count(q)


def test_entry_grid_and_count_equal_port():
    """``__graft_entry__.entry()``'s flagship step (fused mask + 64x64
    density) against the port on the same table and plan, byte for byte."""
    _ref("jax")
    sys.path.insert(0, REPO)
    graft = importlib.import_module("__graft_entry__")
    step, args = graft.entry()
    out = step(*args)
    sft, jt = graft._tiny_table()
    cols = {}
    for name, col in jt.columns.items():
        if hasattr(col, "vocab"):
            cols[name] = np.asarray(col.vocab, dtype=object)[col.codes]
        elif hasattr(col, "point_xy"):
            cols[name] = col.point_xy()
        else:
            cols[name] = np.asarray(col)
    tsft = TSFT.from_spec("gdelt", "name:String,val:Int,dtg:Date,*geom:Point;"
                          "geomesa.z3.interval=week")
    tt = TTable.build(tsft, cols)
    tp = TPlanner(tsft, tt, [TZ3(tsft, tt, "cpu")])
    ecql = ("BBOX(geom, -60, -30, 60, 30) AND "
            "dtg DURING 2020-01-03T00:00:00Z/2020-01-15T00:00:00Z AND val > 10")
    plan = tp.plan(ecql)
    idx = tp.indexes[0]
    m = idx.kernels.mask(plan.primary_kind, plan.boxes_loose, plan.windows,
                         plan.residual_device)
    grid = torch.from_numpy(np.array([-60, -30, 60, 30], dtype=np.float32))
    dens = tdensity.density_kernel(m, idx.device["xf"], idx.device["yf"],
                                   grid, 64, 64)
    assert int(m.sum()) == int(out["count"]) > 0
    assert np.array_equal(dens.numpy(), np.asarray(out["density"]))
    # and through the store's density route on the same plan
    got = tdensity.density(tp, ecql, (-60, -30, 60, 30), 64, 64)
    assert np.array_equal(got.weights, np.asarray(out["density"]))


# -- the CUDA kernel against its plain version (on the card) ------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _kernel_case(n_rows, starts_kind, mask_kind, weight, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-70, 70, n_rows).astype(np.float32)
    y = rng.uniform(-40, 40, n_rows).astype(np.float32)
    # a tenth of the rows exactly on cell edges of a 64x64 raster
    k = n_rows // 10
    x[:k] = GRID[0] + rng.integers(0, 65, k).astype(np.float32) * np.float32(
        (GRID[2] - GRID[0]) / 64)
    starts, bsz, n = None, None, n_rows
    if starts_kind != "none":
        bsz = 4096 if starts_kind == "pow2" else 999
        nb = max(1, n_rows // (3 * bsz))
        starts = np.minimum(np.sort(rng.choice(n_rows // bsz, nb,
                                               replace=False)) * bsz,
                            n_rows - bsz).astype(np.int64)
        starts[-1] = n_rows - bsz   # a clamped last block
        n = len(starts) * bsz
    m = {"all": np.ones(n, bool), "none": np.zeros(n, bool),
         "random20": rng.random(n) < 0.2,
         "runs20": np.repeat(rng.random(-(-n // 1000)) < 0.2, 1000)[:n]}[mask_kind]
    return x, y, _weights(weight, n_rows, seed + 1), m, starts, bsz


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["shared", "global"])
@pytest.mark.parametrize("weight", ["none", "int32", "f32"])
@pytest.mark.parametrize("mask", ["all", "none", "random20", "runs20"])
@pytest.mark.parametrize("starts", ["none", "pow2", "odd"])
@pytest.mark.parametrize("shape", [(64, 64), (256, 256), (7, 5)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_cuda_kernel_equals_plain(shape, starts, mask, weight, route,
                                  monkeypatch):
    dev = _cuda()
    if route == "global":
        monkeypatch.setattr(tkernel, "SHARED_CELLS", 0)
    elif shape[0] * shape[1] > tkernel.SHARED_CELLS:
        pytest.skip("the raster does not fit the shared-memory route")
    w, h = shape
    x, y, wt, m, st, bsz = _kernel_case(300_007, starts, mask, weight,
                                        seed=w + h)
    t = lambda a: None if a is None else torch.from_numpy(a).to(dev)
    args = (t(x), t(y), t(m), t(wt), t(st), bsz, t(GRID), w, h)
    before = tkernel.grid_scatter.launches
    kg, kc = tkernel.grid_scatter(*args)
    torch.cuda.synchronize()
    assert tkernel.grid_scatter.launches == before + 1
    pg, pc = tscan.grid_scatter(*args)
    assert int(kc) == int(pc) == int(m.sum())
    if wt is None:
        assert torch.equal(kg, pg)
        return
    unit, _ = tscan.grid_scatter(*args[:3], None, *args[4:])
    absw, _ = tscan.grid_scatter(*args[:3], t(np.abs(wt.astype(np.float32))),
                                 *args[4:])
    assert_weighted_close(kg.cpu().numpy(), pg.cpu().numpy(),
                          unit.cpu().numpy(), absw.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["shared", "global"])
def test_cuda_unit_cell_clamps_at_2_24(route, monkeypatch):
    """A cell holding 2^24 + 1000 points: the reference's sequential f32
    sum of ones stops at 2^24, and so must the kernel's grid."""
    dev = _cuda()
    if route == "global":
        monkeypatch.setattr(tkernel, "SHARED_CELLS", 0)
    n = (1 << 24) + 1000
    x = torch.full((n,), 1.5, device=dev)
    y = torch.full((n,), -2.5, device=dev)
    m = torch.ones(n, dtype=torch.bool, device=dev)
    g = torch.from_numpy(GRID).to(dev)
    kg, kc = tkernel.grid_scatter(x, y, m, None, None, None, g, 64, 64)
    pg, _ = tscan.grid_scatter(x, y, m, None, None, None, g, 64, 64)
    assert int(kc) == n
    assert float(kg.max()) == float(1 << 24) and float(kg.sum()) == float(1 << 24)
    assert torch.equal(kg, pg)


@pytest.mark.gpu
def test_cuda_density_equals_cpu():
    """The staged and fused density routes on the card (kernel) and on the
    CPU (plain version) give the same grids."""
    _cuda()
    cols = _columns(300_000, 5)
    sft = TSFT.from_spec("d", SPEC)
    table = TTable.build(sft, cols)
    cpu = TPlanner(sft, table, [TZ3(sft, table, "cpu")])
    gpu = TPlanner(sft, table, [TZ3(sft, table, "cuda")])
    before = tkernel.grid_scatter.launches
    for q in ("BBOX(geom, -20, -10, 0, 5) AND dtg DURING "
              "2020-01-04T00:00:00Z/2020-01-06T00:00:00Z",
              f"BBOX(geom, -60, -30, 60, 30) AND {DURING} AND age > 10"):
        for shape in ((64, 64), (256, 256)):
            a = tdensity.density(gpu, q, BBOX, *shape)
            b = tdensity.density(cpu, q, BBOX, *shape)
            assert np.array_equal(a.weights, b.weights)
        a = tcompiled.try_density(gpu, gpu.plan(q), BBOX, 64, 64)
        b = tcompiled.try_density(cpu, cpu.plan(q), BBOX, 64, 64)
        assert np.array_equal(a[0], b[0]) and a[1] == b[1]
    assert tkernel.grid_scatter.launches >= before + 6


def _assert_kernel_equals_plain(args):
    kg, kc = tkernel.grid_scatter(*args)
    torch.cuda.synchronize()
    pg, pc = tscan.grid_scatter(*args)
    assert int(kc) == int(pc)
    if args[3] is None:
        assert torch.equal(kg, pg)
        return kg
    unit, _ = tscan.grid_scatter(*args[:3], None, *args[4:])
    absw, _ = tscan.grid_scatter(*args[:3], args[3].abs().to(torch.float32),
                                 *args[4:])
    assert_weighted_close(kg.cpu().numpy(), pg.cpu().numpy(),
                          unit.cpu().numpy(), absw.cpu().numpy())
    return kg


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["shared", "global"])
@pytest.mark.parametrize("weight", ["none", "int32", "f32"])
@pytest.mark.parametrize("case", ["misaligned", "ragged", "misaligned_starts",
                                  "one_live_a_unit"])
def test_cuda_kernel_mask_edges_equal_plain(case, weight, route,
                                            monkeypatch):
    """A mask 1 byte past a 16-byte boundary (read bytewise), a ragged
    tail (n not a multiple of a warp's 512 candidates), both through block
    starts with a clamped last block, and one live candidate per 512."""
    dev = _cuda()
    if route == "global":
        monkeypatch.setattr(tkernel, "SHARED_CELLS", 0)
    n_rows = 512 * 300 + 37
    x, y, wt, m, st, bsz = _kernel_case(
        n_rows, "odd" if case == "misaligned_starts" else "none", "random20",
        weight, seed=5)
    if case == "one_live_a_unit":
        m = np.zeros_like(m)
        m[511::512] = True
    t = lambda a: None if a is None else torch.from_numpy(a).to(dev)  # noqa: E731
    mask = t(m)
    if case.startswith("misaligned"):
        big = torch.zeros(len(m) + 1, dtype=torch.bool, device=dev)
        big[1:] = mask
        mask = big[1:]
        assert mask.data_ptr() % 16 == 1
    _assert_kernel_equals_plain((t(x), t(y), mask, t(wt), t(st), bsz,
                                 t(GRID), 64, 64))


@pytest.mark.gpu
def test_cuda_back_to_back_calls_reset_scratch():
    """Calls in a row on one stream, without a synchronise between them,
    each equal to the plain version: the scratch the kernel zeroes after
    use is clean for the next call, across routes, weights, raster sizes
    (a larger raster grows it) and both ways of finishing a raster (the
    last CTA alone at 64x64 and 7x5, every CTA past a grid barrier at
    256x256)."""
    dev = _cuda()
    x, y, wt, m, st, bsz = _kernel_case(300_007, "pow2", "runs20", "f32", 9)
    t = lambda a: None if a is None else torch.from_numpy(a).to(dev)  # noqa: E731
    base = [t(x), t(y), t(m), None, t(st), bsz, t(GRID)]
    calls = [(None, 64, 64), (None, 64, 64), (t(wt), 64, 64), (None, 7, 5),
             (t(wt), 256, 256), (None, 256, 256), (None, 64, 64)]
    before = tkernel.grid_scatter.launches
    outs = []
    for w, width, height in calls:
        args = list(base)
        args[3] = w
        outs.append((tkernel.grid_scatter(*args, width, height), args,
                     width, height))
    torch.cuda.synchronize()
    assert tkernel.grid_scatter.launches == before + len(calls)
    for (kg, kc), args, width, height in outs:
        pg, pc = tscan.grid_scatter(*args, width, height)
        assert int(kc) == int(pc) == int(m.sum())
        if args[3] is None:
            assert torch.equal(kg, pg)
    assert torch.equal(outs[0][0][0], outs[-1][0][0])
