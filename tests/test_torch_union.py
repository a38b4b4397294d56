"""OR filters in the port (geomesa_tpu_torch): the union plan, its staged
OR-of-masks count, the union program's select and density, and the
per-branch fallback, against the JAX package on identical state — the
cases of the reference's ``tests/test_or_planning.py``, the union select
and density of ``tests/test_geom_catalog.py``, and the union program's raw
``[count, rows…]`` and (grid, count) against the reference's
``_jit_union_program``. Tolerance: none — counts, ascending rows, raw
program results and unit grids compare exactly; the weighted grid takes
the host route in both packages, with the same f32 accumulation. The port
runs with device="cpu" (its kernels' plain versions)."""

import numpy as np
import pytest
import torch

from geomesa_tpu import config as jconfig
from geomesa_tpu.aggregates.density import prepare_density as jdensity
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.features.table import FeatureTable as JTable
from geomesa_tpu.filter.evaluate import evaluate as jevaluate
from geomesa_tpu.filter.parser import parse_ecql as jparse
from geomesa_tpu.index import compiled as jcompiled
from geomesa_tpu.index.planner import QueryPlanner as JPlanner
from geomesa_tpu.index.spatial import Z3Index as JZ3
from geomesa_tpu_torch import DataStoreFinder
from geomesa_tpu_torch import config as tconfig
from geomesa_tpu_torch.aggregates.density import host_grid
from geomesa_tpu_torch.aggregates.density import prepare_density as tdensity
from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.index import compiled as tcompiled
from geomesa_tpu_torch.index.api import UnionScanPlan
from geomesa_tpu_torch.index.planner import QueryPlanner as TPlanner
from geomesa_tpu_torch.index.spatial import Z3Index as TZ3

SPEC = ("name:String,val:Int,dtg:Date,*geom:Point;"
        "geomesa.z3.interval=week")
DURING = "dtg DURING 2020-01-05T00:00:00Z/2020-01-12T00:00:00Z"
POLY = "POLYGON((-10 20, 40 20, 40 60, -10 60, 15 40, -10 20))"
BOX_A = "BBOX(geom, -20, 10, -5, 25)"
BOX_B = "BBOX(geom, 5, -25, 20, -10)"


@pytest.fixture(autouse=True)
def _small_blocks():
    from geomesa_tpu.index import prune
    vars(prune).pop("BLOCK_SIZE", None)
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.set(512)
        c.FUSED_QUERY.set(True)
    yield
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.unset()
        c.FUSED_QUERY.unset()


def _both(cols, spec=SPEC, name="u"):
    jsft = JSFT.from_spec(name, spec)
    jt = JTable.build(jsft, cols)
    tsft = TSFT.from_spec(name, spec)
    tt = TTable.build(tsft, cols)
    return (JPlanner(jsft, jt, [JZ3(jsft, jt)]),
            TPlanner(tsft, tt, [TZ3(tsft, tt, "cpu")]))


def _gauss_columns(n=80_000, seed=77):
    """tests/test_or_planning.py's corpus (plus name and val)."""
    rng = np.random.default_rng(seed)
    x = np.clip(rng.normal(0, 60, n), -180, 180)
    y = np.clip(rng.normal(0, 30, n), -90, 90)
    base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
    return {"name": rng.choice(["a", "b", "c"], n),
            "val": rng.integers(0, 100, n).astype(np.int32),
            "dtg": base + rng.integers(0, 30 * 86400000, n),
            "geom": (x, y)}


def _uniform_columns(n=6000, seed=7):
    """tests/test_geom_catalog.py's corpus."""
    rng = np.random.default_rng(seed)
    base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
    return {"name": rng.choice(["a", "b", "c"], n),
            "val": rng.integers(0, 100, n).astype(np.int32),
            "dtg": base + rng.integers(0, 30 * 86400000, n),
            "geom": (rng.uniform(-170, 170, n), rng.uniform(-80, 80, n))}


def _built(cols):
    jconfig.PRUNE_BLOCK.set(512)
    tconfig.PRUNE_BLOCK.set(512)
    try:
        return _both(cols)
    finally:
        jconfig.PRUNE_BLOCK.unset()
        tconfig.PRUNE_BLOCK.unset()


@pytest.fixture(scope="module")
def gauss():
    cols = _gauss_columns()
    return (*_built(cols), cols)


@pytest.fixture(scope="module")
def uniform():
    cols = _uniform_columns()
    return (*_built(cols), cols)


def _parity(jp, tp, q):
    jc, js = jp.count(q), jp.select_indices(q)
    tc, ts = tp.count(q), tp.select_indices(q)
    assert tc == jc, q
    assert ts.dtype == np.int64 and np.array_equal(ts, js), q
    host = jevaluate(jparse(q), jp.table)
    assert np.array_equal(ts, np.flatnonzero(host)), q
    return tc


def _box(cols, x0, y0, x1, y1):
    x, y = cols["geom"]
    return (x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)


# -- tests/test_or_planning.py -------------------------------------------------


def test_bbox_or_bbox_uses_union_plan(gauss):
    jp, tp, cols = gauss
    q = f"{BOX_A} OR {BOX_B}"
    plan = tp.plan(q)
    assert isinstance(plan, UnionScanPlan), "OR did not take the union plan"
    assert len(plan.branches) == 2
    assert plan.same_index_device_exact() is tp.indexes[0]
    m = _box(cols, -20, 10, -5, 25) | _box(cols, 5, -25, 20, -10)
    rows = tp.select_indices(q, plan=plan)
    assert np.array_equal(rows, np.flatnonzero(m))
    assert tp.count(q) == int(m.sum())
    _parity(jp, tp, q)


def test_overlapping_branches_dedup(gauss):
    jp, tp, cols = gauss
    q = "BBOX(geom, -10, -10, 10, 10) OR BBOX(geom, 0, 0, 20, 20)"
    m = _box(cols, -10, -10, 10, 10) | _box(cols, 0, 0, 20, 20)
    assert _parity(jp, tp, q) == int(m.sum())


def test_branch_with_time_constraint(gauss):
    jp, tp, cols = gauss
    q = (f"({BOX_A} AND dtg DURING 2020-01-05T00:00:00Z/"
         f"2020-01-12T00:00:00Z) OR {BOX_B}")
    assert isinstance(tp.plan(q), UnionScanPlan)
    lo = np.datetime64("2020-01-05", "ms").astype(np.int64)
    hi = np.datetime64("2020-01-12", "ms").astype(np.int64)
    dtg = cols["dtg"]
    m = (_box(cols, -20, 10, -5, 25) & (dtg > lo) & (dtg < hi)) \
        | _box(cols, 5, -25, 20, -10)
    assert _parity(jp, tp, q) == int(m.sum())


@pytest.mark.parametrize("q", [
    f"{BOX_A} OR dtg > 2020-01-20T00:00:00Z",
    f"{DURING} OR val > 50",
])
def test_unconstrained_branch_declines_union(gauss, q):
    jp, tp, _ = gauss
    assert not isinstance(tp.plan(q), UnionScanPlan)
    assert type(jp.plan(q)).__name__ == "IndexScanPlan"
    assert _parity(jp, tp, q) > 0


def test_union_scan_mask(gauss):
    jp, tp, cols = gauss
    q = f"{BOX_A} OR {BOX_B}"
    plan, mask = tp.scan_mask(q)
    assert isinstance(plan, UnionScanPlan) and mask is not None
    _, jmask = jp.scan_mask(q)
    assert np.array_equal(mask.numpy(), np.asarray(jmask))
    m = _box(cols, -20, 10, -5, 25) | _box(cols, 5, -25, 20, -10)
    perm = plan.same_index_device_exact().perm.numpy()
    assert np.array_equal(np.sort(perm[mask.numpy()]), np.flatnonzero(m))


UNION_COUNTS = [
    f"{BOX_A} OR {BOX_B}",
    f"{BOX_A} AND {DURING} OR {BOX_B} AND {DURING} AND val > 50",
    "BBOX(geom, -5, -5, 5, 5) OR BBOX(geom, -5, -5, 5, 5) AND val > 20",
    f"{BOX_A} OR {BOX_B} OR BBOX(geom, -15, 0, 10, 20) AND name = 'b'",
]


@pytest.mark.parametrize("q", UNION_COUNTS)
def test_union_count_is_one_kbranch_scan(gauss, q, monkeypatch):
    """The OR count of a device-exact union: one K-branch ``fused_scan``
    count over the table's blocks (no OR of masks, no torch ops), rows
    that branches share counted once, equal to the reference's sum of its
    OR of masks; the union's row mask (``scan_mask``) too."""
    from geomesa_tpu_torch.index import scan as tscan
    jp, tp, _ = gauss
    plan = tp.plan(q)
    idx = plan.same_index_device_exact()
    assert isinstance(plan, UnionScanPlan) and idx is not None
    counts = []
    kcount = tscan.ScanKernels._kernel_count
    monkeypatch.setattr(tscan.ScanKernels, "_kernel_count",
                        lambda self, sc: counts.append(
                            len(sc.query.branches)) or kcount(self, sc))

    def refuse(*a, **k):
        raise AssertionError("the torch-ops route ran")
    monkeypatch.setattr(tscan, "_mask_kernel", refuse)
    want = jp.count(q)
    assert want > 0 and tp.count(q) == want
    assert counts == [len(plan.branches)]
    _, jmask = jp.scan_mask(q)
    _, tmask = tp.scan_mask(q)
    assert np.array_equal(tmask.numpy(), np.asarray(jmask))
    assert int(tmask.sum()) == want


# -- the acceptance shapes, fused and staged -----------------------------------

UNION_FILTERS = [
    f"{BOX_A} OR {BOX_B}",
    f"{BOX_A} AND {DURING} OR {BOX_B} AND {DURING} AND val > 50",
    f"{BOX_A} OR INTERSECTS(geom, {POLY})",
    f"INTERSECTS(geom, {POLY}) AND {DURING} OR {BOX_B} AND name = 'b'",
    f"{BOX_A} OR {BOX_B} OR BBOX(geom, 100, -60, 140, -20) AND val < 10",
    f"{BOX_A} OR st_distance(geom, POINT(10 -15)) < 6",
    "BBOX(geom, -5, -5, 5, 5) OR BBOX(geom, -5, -5, 5, 5) AND val > 20",
    f"({BOX_A} OR {BOX_B}) AND {DURING}",
]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("q", UNION_FILTERS)
def test_union_filter_equals_reference(gauss, q, fused):
    jp, tp, _ = gauss
    jconfig.FUSED_QUERY.set(fused)
    tconfig.FUSED_QUERY.set(fused)
    _parity(jp, tp, q)


def test_union_program_serves_select(gauss, monkeypatch):
    """A device-exact union selects through one union program; a branch
    with a host refine sends the select down the per-branch path."""
    jp, tp, _ = gauss
    calls = []
    run = tcompiled.UnionProgram.run
    monkeypatch.setattr(tcompiled.UnionProgram, "run",
                        lambda self: calls.append(self.mode) or run(self))
    _parity(jp, tp, UNION_FILTERS[1])
    assert calls == ["select"]
    calls.clear()
    _parity(jp, tp, UNION_FILTERS[2])
    assert calls == []


# -- the union program, raw ----------------------------------------------------


@pytest.mark.parametrize("q", UNION_FILTERS[:2] + UNION_FILTERS[4:5]
                         + UNION_FILTERS[6:7])
def test_union_program_select_equals_reference(gauss, q):
    jp, tp, _ = gauss
    jprog = jcompiled._build_union(jp, jp.plan(q), "select", None)
    want = np.asarray(jprog.dispatch())
    prog = tcompiled.UnionProgram(tp.plan(q), "select",
                                  sel_cap=jprog.sel_cap)
    got = prog.run()
    assert got.dtype == torch.int32 and got[0] > 0
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("q", UNION_FILTERS[:2])
def test_union_program_density_equals_reference(gauss, q):
    jp, tp, _ = gauss
    bbox = (-60.0, -40.0, 60.0, 40.0)
    jprog = jcompiled._build_union(jp, jp.plan(q), "density", None,
                                   grid=bbox, width=64, height=32)
    jgrid, jcnt = jprog.dispatch()
    grid, cnt = tcompiled.UnionProgram(tp.plan(q), "density", grid=bbox,
                                       width=64, height=32).run()
    assert int(cnt) == int(jcnt) > 0
    assert np.array_equal(grid.numpy(), np.asarray(jgrid))


def test_try_union_entry_points_equal_reference(gauss):
    jp, tp, _ = gauss
    q = UNION_FILTERS[1]
    assert np.array_equal(
        tcompiled.try_union_select(tp, tp.plan(q), None, capacity=4),
        jcompiled.try_union_select(jp, jp.plan(q), None, capacity=4))
    bbox = (-30.0, -30.0, 30.0, 30.0)
    tg, tc = tcompiled.try_union_density(tp, tp.plan(q), None, bbox, 16, 16)
    jg, jc = jcompiled.try_union_density(jp, jp.plan(q), None, bbox, 16, 16)
    assert tc == jc and np.array_equal(tg, jg)


def test_union_program_declines_host_branch(gauss):
    _, tp, _ = gauss
    plan = tp.plan(UNION_FILTERS[2])
    assert plan.same_index_device_exact() is None
    assert tcompiled.try_union_select(tp, plan, None) is None


# -- tests/test_geom_catalog.py's union select and density ---------------------


def test_union_select_and_density_lowering(uniform):
    jp, tp, _ = uniform
    q = ("BBOX(geom, -60, -40, -10, 10) AND val < 70"
         " OR BBOX(geom, 20, -10, 70, 45) AND val >= 30")
    host = jevaluate(jparse(q), jp.table)
    rows = tp.select_indices(q)
    assert np.array_equal(rows, np.flatnonzero(host))
    assert np.array_equal(rows, jp.select_indices(q))
    bbox = (-180.0, -90.0, 180.0, 90.0)
    g = tdensity(tp, q, bbox, 64, 32)()
    assert np.array_equal(g.weights, host_grid(tp.table, np.flatnonzero(host),
                                               bbox, 64, 32))
    assert np.array_equal(g.weights, jdensity(jp, q, bbox, 64, 32)().weights)


@pytest.mark.parametrize("q,weight", [
    (f"{BOX_A} OR INTERSECTS(geom, {POLY})", None),
    ("BBOX(geom, -60, -40, -10, 10) OR BBOX(geom, 20, -10, 70, 45)", "val"),
])
def test_union_density_host_routes_equal_reference(uniform, q, weight):
    jp, tp, _ = uniform
    bbox = (-90.0, -45.0, 90.0, 75.0)
    g = tdensity(tp, q, bbox, 32, 16, weight)()
    assert g.weights.sum() > 0
    assert np.array_equal(g.weights,
                          jdensity(jp, q, bbox, 32, 16, weight)().weights)


# -- through the store ---------------------------------------------------------


def test_store_answers_or_filters(uniform):
    jp, _, cols = uniform
    store = DataStoreFinder.get_data_store(type="torch", device="cpu")
    tconfig.PRUNE_BLOCK.set(512)
    try:
        sft = store.create_schema("u", SPEC)
        store.load("u", TTable.build(sft, cols))
        qs = [f"{BOX_A} OR {BOX_B}", f"{DURING} OR val > 50",
              f"{BOX_A} OR INTERSECTS(geom, {POLY})"]
        for q in qs:
            assert store.count("u", q) == jp.count(q)
            assert np.array_equal(store.query("u", q).indices,
                                  jp.select_indices(q))
        assert store.count_many("u", qs) == [jp.count(q) for q in qs]
        bbox = (-180.0, -90.0, 180.0, 90.0)
        g = store.query("u", qs[0], hints={"density": {
            "bbox": bbox, "width": 64, "height": 32}})
        assert np.array_equal(g.weights,
                              jdensity(jp, qs[0], bbox, 64, 32)().weights)
    finally:
        store.close()
