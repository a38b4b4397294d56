"""The fused program's refine kinds in the port (geomesa_tpu_torch):
``refine_spec``'s ``pip`` kind for the st_* polygon predicates and its
``dist`` kind for ``st_distance(geom, POINT) < r`` / ``<= r``, with the
``dist_refine`` kernel's plain version, against the JAX package on
identical state: the FUNC queries of the reference's
``tests/test_geom_catalog.py`` three ways (fused, staged, host), the
program's raw ``count_refine``/``select_refine`` arrays against the
reference's ``_jit_program``, also on table rows placed within a few ulps
of ``r ± DIST_BAND``, and the plain ``dist_refine`` against numpy f32.
Tolerance: none — flags, counts, rows and raw arrays compare exactly. The
port runs with device="cpu" here.

The CUDA kernel is held to the plain version by the ``gpu`` tests, which
skip without a card. They import nothing of JAX (the reference is imported
only inside the tests that compare with it), so on the card
``python -m pytest --noconftest -m gpu tests/test_torch_refine_kinds.py``
runs them."""

import numpy as np
import pytest
import torch

from geomesa_tpu_torch import config as tconfig
from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.filter.evaluate import evaluate as tevaluate
from geomesa_tpu_torch.filter.parser import parse_ecql as tparse
from geomesa_tpu_torch.index import compiled as tcompiled
from geomesa_tpu_torch.index import scan as tscan
from geomesa_tpu_torch.index.planner import QueryPlanner as TPlanner
from geomesa_tpu_torch.index.spatial import Z3Index as TZ3
from geomesa_tpu_torch.kernels import dist as tdist

SPEC = ("name:String,val:Int,dtg:Date,*geom:Point;"
        "geomesa.z3.interval=week")
DURING = "dtg DURING 2020-01-03T00:00:00Z/2020-01-15T00:00:00Z"

# tests/test_geom_catalog.py FUNC_QUERIES that a point layer answers
# without the geometry catalog, plus the other argument orders
FUNC_QUERIES = [
    "st_distance(geom, POINT(10 10)) < 15",
    "st_distance(geom, POINT(-120 40)) <= 8",
    "st_contains(POLYGON((-40 -30, 20 -30, 20 20, -40 20, -40 -30)), geom)",
    "st_intersects(geom, POLYGON((0 0, 60 0, 30 50, 0 0)))",
    "st_distance(geom, POINT(10 10)) < 25 AND val < 50",
    "st_intersects(POLYGON((0 0, 60 0, 30 50, 0 0)), geom)",
    "st_distance(POINT(10 10), geom) < 15",
    f"st_distance(geom, POINT(10 45)) < 5 AND {DURING}",
    f"st_distance(geom, POINT(10 45)) <= 5 AND {DURING}",
    "st_distance(geom, POINT(0 0)) <= 0",
]


def _ref():
    """The reference's modules (imported only by the tests that compare)."""
    pytest.importorskip("jax")
    from geomesa_tpu import config
    from geomesa_tpu.features.sft import SimpleFeatureType
    from geomesa_tpu.features.table import FeatureTable
    from geomesa_tpu.filter.evaluate import evaluate
    from geomesa_tpu.filter.parser import parse_ecql
    from geomesa_tpu.index import compiled
    from geomesa_tpu.index import prune
    from geomesa_tpu.index.planner import QueryPlanner
    from geomesa_tpu.index.spatial import Z3Index
    return dict(config=config, SFT=SimpleFeatureType, Table=FeatureTable,
                evaluate=evaluate, parse=parse_ecql, compiled=compiled,
                prune=prune, Planner=QueryPlanner, Z3=Z3Index)


def _columns(n=6000, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-170, 170, n)
    y = rng.uniform(-80, 80, n)
    x[:2], y[:2] = (0.0, 10.0), (0.0, 10.0)   # on the r = 0 circle's centre
    base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
    return {"name": rng.choice(["a", "b", "c"], n),
            "val": rng.integers(0, 100, n).astype(np.int32),
            "dtg": base + rng.integers(0, 30 * 86400000, n),
            "geom": (x, y)}


@pytest.fixture(scope="module")
def world():
    r = _ref()
    vars(r["prune"]).pop("BLOCK_SIZE", None)
    r["config"].PRUNE_BLOCK.set(512)
    tconfig.PRUNE_BLOCK.set(512)
    try:
        cols = _columns()
        jsft = r["SFT"].from_spec("gc", SPEC)
        jt = r["Table"].build(jsft, cols)
        tsft = TSFT.from_spec("gc", SPEC)
        tt = TTable.build(tsft, cols)
        return (r["Planner"](jsft, jt, [r["Z3"](jsft, jt)]),
                TPlanner(tsft, tt, [TZ3(tsft, tt, "cpu")]))
    finally:
        r["config"].PRUNE_BLOCK.unset()
        tconfig.PRUNE_BLOCK.unset()


@pytest.fixture
def fused_on(world):
    r = _ref()
    vars(r["prune"]).pop("BLOCK_SIZE", None)
    for c in (r["config"], tconfig):
        c.PRUNE_BLOCK.set(512)
        c.FUSED_QUERY.set(True)
    yield r
    for c in (r["config"], tconfig):
        c.PRUNE_BLOCK.unset()
        c.FUSED_QUERY.unset()


# -- three ways: fused, staged, host -------------------------------------------


@pytest.mark.parametrize("q", FUNC_QUERIES)
def test_func_query_three_way_parity(world, fused_on, q):
    jp, tp = world
    r = fused_on
    host = tevaluate(tparse(q), tp.table)
    assert np.array_equal(host, r["evaluate"](r["parse"](q), jp.table))
    want = (jp.count(q), jp.select_indices(q))
    assert want[0] == int(host.sum())
    for fused in (True, False):
        tconfig.FUSED_QUERY.set(fused)
        assert tp.count(q) == want[0], (q, fused)
        rows = tp.select_indices(q)
        assert rows.dtype == np.int64 and np.array_equal(rows, want[1])
        assert np.array_equal(rows, np.flatnonzero(host))


@pytest.mark.parametrize("q,kind", [
    ("st_distance(geom, POINT(10 10)) < 15", "dist"),
    ("st_contains(POLYGON((-40 -30, 20 -30, 20 20, -40 20, -40 -30)), geom)",
     "pip"),
    ("st_intersects(geom, POLYGON((0 0, 60 0, 30 50, 0 0)))", "pip"),
])
def test_eligible_func_refines_in_the_fused_program(world, fused_on,
                                                    monkeypatch, q, kind):
    """An eligible st_* residual runs inside the fused program (one
    readback, no fallback) through its refine kind's kernel wrapper."""
    jp, tp = world
    calls = []
    for name in ("pip_refine", "dist_refine"):
        fn = getattr(tcompiled, name)
        monkeypatch.setattr(tcompiled, name, lambda *a, fn=fn, name=name,
                            **k: calls.append(name) or fn(*a, **k))
    f0 = tcompiled.STATS["fallbacks"]
    d0 = tscan.ROUNDS.dispatches
    assert tp.count(q) == jp.count(q)
    assert tscan.ROUNDS.dispatches - d0 == 1
    assert tcompiled.STATS["fallbacks"] == f0
    assert calls == [f"{kind}_refine"]


@pytest.mark.parametrize("q", [
    "st_distance(geom, POINT(10 10)) > 15",
    "st_distance(geom, POLYGON((0 0, 9 0, 9 9, 0 0))) < 3",
    "st_distance(geom, POINT(10 10)) < -1",
    "st_contains(geom, POINT(10 10))",
    "st_intersects(geom, LINESTRING(0 0, 10 10))",
    "st_distance(geom, POINT(10 10)) < 15 AND val > 50 "
    "AND st_intersects(geom, POLYGON((0 0, 60 0, 30 50, 0 0)))",
    f"WITHIN(geom, POLYGON((0 0, 60 0, 30 50, 0 0))) AND {DURING}",
])
def test_ineligible_residual_declines_and_stays_exact(world, fused_on, q):
    """Residuals that are no single refine kind take the staged path and
    the host refine, as in the reference, with its answers."""
    jp, tp = world
    assert tcompiled.refine_spec(tp.plan(q)) is None
    assert jp.count(q) == tp.count(q)
    assert np.array_equal(jp.select_indices(q), tp.select_indices(q))


@pytest.mark.parametrize("q", FUNC_QUERIES[:4] + FUNC_QUERIES[5:7]
                         + ["INTERSECTS(geom, POLYGON((0 0, 60 0, 30 50, "
                            "0 0)))"])
def test_refine_spec_equals_reference(world, fused_on, q):
    jp, tp = world
    want = fused_on["compiled"]._refine_spec(jp.plan(q))
    got = tcompiled.refine_spec(tp.plan(q))
    assert got[0] == want[0]
    assert got[1].dtype == np.float32 and np.array_equal(got[1], want[1])


# -- the raw program -----------------------------------------------------------


@pytest.mark.parametrize("mode", ["count_refine", "select_refine"])
@pytest.mark.parametrize("q", [
    "st_distance(geom, POINT(10 10)) < 15",
    f"st_distance(geom, POINT(10 45)) <= 5 AND {DURING}",
    "st_distance(geom, POINT(-120 40)) <= 8 AND val < 50",
    "st_contains(POLYGON((-40 -30, 20 -30, 20 20, -40 20, -40 -30)), geom)",
    f"st_intersects(geom, POLYGON((0 0, 60 0, 30 50, 0 0))) AND {DURING}",
])
def test_program_output_equals_reference(world, fused_on, q, mode):
    """The fused program's raw int32 result, value for value, on both
    branches (the one-week window prunes; the others gate the full
    table)."""
    jp, tp = world
    jprog = fused_on["compiled"]._from_plan(jp, jp.plan(q), mode)
    want = np.asarray(jprog.dispatch())
    tplan = tp.plan(q)
    got = tcompiled.Program(tplan, mode, sel_cap=jprog.sel_cap,
                            unc_cap=jprog.unc_cap,
                            refine=tcompiled.refine_spec(tplan)).run()
    assert got.dtype == torch.int32 and got[0] > 0
    assert np.array_equal(got.numpy(), want)


# -- the dist refine's plain version -------------------------------------------


def _band_points(cx, cy, r, k=4, seed=3):
    """f32 points whose distance to (cx, cy) lands within k ulps of
    r − DIST_BAND, r + DIST_BAND and r, along several directions, plus a
    uniform spray around the circle."""
    cx, cy, r = (np.float32(v) for v in (cx, cy, r))
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for edge in (r - tscan.DIST_BAND, r + tscan.DIST_BAND, r):
        for ang in (0.0, np.pi / 2, np.pi, 0.7, 2.1, 4.0):
            px = np.float32(cx + edge * np.float32(np.cos(ang)))
            py = np.float32(cy + edge * np.float32(np.sin(ang)))
            for sx in range(-k, k + 1):
                for sy in (-1, 0, 1):
                    xs.append(px + sx * np.spacing(px))
                    ys.append(py + sy * np.spacing(py))
    t = rng.uniform(0, 2 * np.pi, 2000)
    rad = rng.uniform(0, 2 * float(r) + 0.01, 2000)
    xs += list(cx + rad * np.cos(t))
    ys += list(cy + rad * np.sin(t))
    return (np.asarray(xs, dtype=np.float32),
            np.asarray(ys, dtype=np.float32))


def _numpy_flags(xf, yf, centre_r):
    """The dist classification in numpy f32, one rounding an operation."""
    cx, cy, lo, hi = (np.float32(v) for v in tscan.dist_bounds(centre_r))
    dx, dy = xf - cx, yf - cy
    d = np.sqrt(dx * dx + dy * dy)
    cin = d <= lo
    return cin, ~cin & ~(d >= hi)


BAND_CENTRES = [(10.0, 45.0, 5.0), (-120.3, 40.7, 8.0), (0.0, 0.0, 0.0),
                (179.9, -89.5, 0.25), (10.0, 10.0, 1e-4)]


@pytest.mark.parametrize("centre_r", BAND_CENTRES)
def test_plain_dist_refine_equals_numpy_f32(centre_r):
    cr = np.asarray(centre_r, dtype=np.float32)
    xf, yf = _band_points(*cr)
    hit, unc, counts = tscan.dist_refine(
        torch.from_numpy(xf), torch.from_numpy(yf), tscan.dist_bounds(cr))
    whit, wunc = _numpy_flags(xf, yf, cr)
    assert np.array_equal(hit.numpy(), whit)
    assert np.array_equal(unc.numpy(), wunc)
    assert counts.dtype == torch.int32
    assert counts.tolist() == [int(whit.sum()), int(wunc.sum())]
    assert unc.numpy().sum() > 0


@pytest.mark.parametrize("during", [False, True])
@pytest.mark.parametrize("centre_r", BAND_CENTRES)
def test_band_points_program_equals_reference(centre_r, during):
    """Table rows placed within a few ulps of r ± DIST_BAND (and of r)
    through the reference's fused program and the port's, raw arrays
    value for value, on the pruned (one-day window) and full branches."""
    r = _ref()
    cr = np.asarray(centre_r, dtype=np.float32)
    xf, yf = _band_points(*cr)
    x = np.tile(xf, 3).astype(np.float64)
    y = np.tile(yf, 3).astype(np.float64)
    n = len(x)
    base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
    cols = {"name": np.full(n, "a"), "val": np.zeros(n, np.int32),
            "dtg": base + np.arange(n) * 200_000, "geom": (x, y)}
    vars(r["prune"]).pop("BLOCK_SIZE", None)
    for c in (r["config"], tconfig):
        c.PRUNE_BLOCK.set(512)
        c.FUSED_QUERY.set(True)
    try:
        jsft = r["SFT"].from_spec("b", SPEC)
        jt = r["Table"].build(jsft, cols)
        jp = r["Planner"](jsft, jt, [r["Z3"](jsft, jt)])
        tsft = TSFT.from_spec("b", SPEC)
        tt = TTable.build(tsft, cols)
        tp = TPlanner(tsft, tt, [TZ3(tsft, tt, "cpu")])
        q = (f"st_distance(geom, POINT({centre_r[0]} {centre_r[1]})) "
             f"<= {centre_r[2]}")
        if during:
            q += " AND dtg DURING 2020-01-01T00:00:00Z/2020-01-02T00:00:00Z"
        for mode in ("count_refine", "select_refine"):
            jprog = r["compiled"]._from_plan(jp, jp.plan(q), mode,
                                             capacity=n)
            want = np.asarray(jprog.dispatch())
            tplan = tp.plan(q)
            got = tcompiled.Program(
                tplan, mode, sel_cap=jprog.sel_cap, unc_cap=jprog.unc_cap,
                refine=tcompiled.refine_spec(tplan)).run()
            assert np.array_equal(got.numpy(), want), mode
            assert want[1] > 0
    finally:
        for c in (r["config"], tconfig):
            c.PRUNE_BLOCK.unset()
            c.FUSED_QUERY.unset()


def _band_world(r, centre_r):
    """Both packages' planners over table rows placed within a few ulps of
    r ± DIST_BAND (``_band_points`` three times over, one row a 200 s
    step from 2020-01-01). Call with PRUNE_BLOCK at 512."""
    xf, yf = _band_points(*centre_r)
    x = np.tile(xf, 3).astype(np.float64)
    y = np.tile(yf, 3).astype(np.float64)
    n = len(x)
    base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
    cols = {"name": np.full(n, "a"), "val": np.zeros(n, np.int32),
            "dtg": base + np.arange(n) * 200_000, "geom": (x, y)}
    jsft = r["SFT"].from_spec("b", SPEC)
    jt = r["Table"].build(jsft, cols)
    tsft = TSFT.from_spec("b", SPEC)
    tt = TTable.build(tsft, cols)
    return (r["Planner"](jsft, jt, [r["Z3"](jsft, jt)]),
            TPlanner(tsft, tt, [TZ3(tsft, tt, "cpu")]))


def _dist_counts_case(r, jp, tp, q, mode):
    """The raw fused program of ``q`` in both packages, and the dist
    refine's counts — the plain version's and the wrapper's, from the
    program's own candidates — against the reference's first two words."""
    jprog = r["compiled"]._from_plan(jp, jp.plan(q), mode)
    want = np.asarray(jprog.dispatch())
    tplan = tp.plan(q)
    prog = tcompiled.Program(tplan, mode, sel_cap=jprog.sel_cap,
                             unc_cap=jprog.unc_cap,
                             refine=tcompiled.refine_spec(tplan))
    assert prog.refine == "dist"
    assert isinstance(prog.dist, tscan.DistBounds)
    got = prog.run()
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    m, _, starts = prog._candidates()
    cols = prog.index.device.columns
    kw = dict(mask=m, starts=starts, bsz=prog.bsz)
    for fn in (tscan.dist_refine, tdist.dist_refine):
        hit, unc, counts = fn(cols["xf"], cols["yf"], prog.dist, **kw)
        assert counts.dtype == torch.int32 and counts.shape == (2,)
        assert counts.tolist() == [int(hit.sum()), int(unc.sum())]
        assert np.array_equal(counts.numpy(), want[:2])
    return want


@pytest.mark.parametrize("mode", ["count_refine", "select_refine"])
@pytest.mark.parametrize("q", [
    "st_distance(geom, POINT(10 10)) < 15",
    f"st_distance(geom, POINT(10 45)) <= 5 AND {DURING}",
    "st_distance(geom, POINT(-120 40)) <= 8 AND val < 50",
])
def test_dist_counts_equal_reference(world, fused_on, q, mode):
    """The dist refine's (hit, uncertain) counts, which ``Program.run``
    now takes from the refine's own launch, equal the reference program's
    first two words, and the raw program equals the reference's."""
    jp, tp = world
    assert _dist_counts_case(fused_on, jp, tp, q, mode)[0] > 0


@pytest.mark.parametrize("mode", ["count_refine", "select_refine"])
@pytest.mark.parametrize("during", [False, True])
@pytest.mark.parametrize("centre_r", BAND_CENTRES[:3])
def test_band_points_dist_counts_equal_reference(centre_r, during, mode):
    """The same on rows within a few ulps of the band, where the counts
    hold uncertain rows, on the pruned (one-day window) and full
    branches."""
    r = _ref()
    cr = np.asarray(centre_r, dtype=np.float32)
    vars(r["prune"]).pop("BLOCK_SIZE", None)
    for c in (r["config"], tconfig):
        c.PRUNE_BLOCK.set(512)
        c.FUSED_QUERY.set(True)
    try:
        jp, tp = _band_world(r, cr)
        q = f"st_distance(geom, POINT({cr[0]} {cr[1]})) <= {cr[2]}"
        if during:
            q += " AND dtg DURING 2020-01-01T00:00:00Z/2020-01-02T00:00:00Z"
        assert _dist_counts_case(r, jp, tp, q, mode)[1] > 0
    finally:
        for c in (r["config"], tconfig):
            c.PRUNE_BLOCK.unset()
            c.FUSED_QUERY.unset()


def test_plain_dist_refine_masks_and_starts():
    cr = np.asarray([10.0, 45.0, 5.0], dtype=np.float32)
    xf, yf = _band_points(*cr)
    n = len(xf) // 8 * 8
    x, y = torch.from_numpy(xf[:n]), torch.from_numpy(yf[:n])
    rng = np.random.default_rng(1)
    mask = torch.from_numpy(rng.random(n) < 0.6)
    b = tscan.dist_bounds(cr)
    hit, unc, _ = tscan.dist_refine(x, y, b)
    mhit, munc, mcnt = tscan.dist_refine(x, y, b, mask)
    assert torch.equal(mhit, hit & mask) and torch.equal(munc, unc & mask)
    assert mcnt.tolist() == [int(mhit.sum()), int(munc.sum())]
    starts = torch.tensor([n - 8, 0, 16], dtype=torch.int64)
    rows = tscan.block_rows(starts, 8)
    m = torch.ones(24, dtype=torch.bool)
    shit, sunc, _ = tscan.dist_refine(x, y, b, m, starts, 8)
    assert torch.equal(shit, hit[rows]) and torch.equal(sunc, unc[rows])


def test_dist_bounds_round_in_f32():
    cx, cy, lo, hi = tscan.dist_bounds([10.0, 45.0, 5.0])
    assert np.float32(lo) == np.float32(5.0) - np.float32(1e-3)
    assert np.float32(hi) == np.float32(5.0) + np.float32(1e-3)
    assert (cx, cy) == (10.0, 45.0)


def test_wrapper_cpu_runs_plain_and_counts_nothing():
    cr = np.asarray([1.0, 2.0, 3.0], dtype=np.float32)
    x = torch.linspace(-5, 5, 101)
    y = torch.full((101,), 2.0)
    b = tscan.dist_bounds(cr)
    before = tdist.dist_refine.launches
    got = tdist.dist_refine(x, y, b)
    want = tscan.dist_refine(x, y, b)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tdist.dist_refine.launches == before
    assert tdist.REPLACES == "geomesa_tpu/index/compiled.py:508"


@pytest.mark.parametrize("bad", ["f64", "shape", "mask_dtype", "mask_len",
                                 "starts_no_bsz", "too_many", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    cr = np.asarray([0.0, 0.0, 1.0], dtype=np.float32)
    x = torch.zeros(16)
    y = torch.zeros(16)
    kw = {}
    if bad == "f64":
        x = x.double()
    elif bad == "shape":
        y = torch.zeros(15)
    elif bad == "mask_dtype":
        kw["mask"] = torch.zeros(16, dtype=torch.uint8)
    elif bad == "mask_len":
        kw["mask"] = torch.zeros(15, dtype=torch.bool)
    elif bad == "starts_no_bsz":
        kw["starts"] = torch.zeros(2, dtype=torch.int64)
    elif bad == "too_many":   # 2^31 candidates through two starts
        kw.update(starts=torch.zeros(2, dtype=torch.int64), bsz=1 << 30)
    else:
        x, y = x.to("meta"), y.to("meta")
    with pytest.raises((TypeError, ValueError)):
        tdist.dist_refine(x, y, tscan.dist_bounds(cr), **kw)


# -- the CUDA kernel against its plain version (card only) --------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on_card(t: torch.Tensor, dev) -> torch.Tensor:
    """``t`` on the card as a view at the same storage offset (so that a
    mask one byte into its storage stays misaligned there)."""
    off = t.storage_offset()
    if off == 0:
        return t.to(dev)
    return torch.cat([torch.zeros(off, dtype=t.dtype), t]).to(dev)[off:]


def _kernel_vs_plain(xf, yf, cr, mask=None, starts=None, bsz=None):
    """The kernel's flags and counts against the plain version's, and the
    counts against the flags' sums."""
    dev = _cuda()
    before = tdist.dist_refine.launches
    b = tscan.dist_bounds(cr)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (xf, yf)]
    kw = {"mask": mask, "starts": starts, "bsz": bsz}
    want = tdist.dist_refine(*t, b, **kw)
    kw = {k: (_on_card(v, dev) if isinstance(v, torch.Tensor) else v)
          for k, v in kw.items()}
    got = tdist.dist_refine(*(a.to(dev) for a in t), b, **kw)
    torch.cuda.synchronize()
    assert tdist.dist_refine.launches == before + (1 if len(want[0]) else 0)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == torch.bool and torch.equal(g.cpu(), w)
    assert got[2].dtype == torch.int32
    assert torch.equal(got[2].cpu(), want[2])
    assert got[2].tolist() == [int(want[0].sum()), int(want[1].sum())]


@pytest.mark.gpu
@pytest.mark.parametrize("centre_r", [(10.0, 45.0, 5.0), (0.0, 0.0, 0.0),
                                      (179.9, -89.5, 0.25),
                                      (-120.3, 40.7, 8.0)])
@pytest.mark.parametrize("variant", ["nomask", "mask", "misaligned"])
def test_cuda_dist_refine_equals_plain(centre_r, variant):
    cr = np.asarray(centre_r, dtype=np.float32)
    xf, yf = _band_points(*cr)
    mask = None
    if variant != "nomask":
        rng = np.random.default_rng(2)
        m = torch.from_numpy(rng.random(len(xf) + 1) < 0.7)
        mask = m[1:] if variant == "misaligned" else m[:-1].clone()
        if variant == "misaligned":
            # a contiguous view one byte into its storage
            assert mask.is_contiguous() and mask.storage_offset() == 1
    _kernel_vs_plain(xf, yf, cr, mask=mask)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 127, 1000, 100_003])
def test_cuda_dist_refine_ragged_lengths(n):
    cr = np.asarray([10.0, 45.0, 5.0], dtype=np.float32)
    xf, yf = _band_points(*cr)
    rep = -(-n // len(xf)) if n else 0
    xf, yf = np.tile(xf, rep)[:n], np.tile(yf, rep)[:n]
    _kernel_vs_plain(xf, yf, cr)
    m = torch.from_numpy(np.arange(n) % 3 != 1)
    _kernel_vs_plain(xf, yf, cr, mask=m)


@pytest.mark.gpu
@pytest.mark.parametrize("bsz", [512, 300])
def test_cuda_dist_refine_through_block_starts(bsz):
    """Candidates read through clamped block starts, as the fused program's
    pruned branch passes them (pow2 and other block sizes)."""
    cr = np.asarray([10.0, 45.0, 5.0], dtype=np.float32)
    xf, yf = _band_points(*cr)
    n = len(xf)
    nb = 7
    starts = torch.tensor([0, 3 * bsz, n - bsz, bsz, n - bsz, 5, 2 * bsz],
                          dtype=torch.int64)[:nb]
    rng = np.random.default_rng(4)
    mask = torch.from_numpy(rng.random(nb * bsz) < 0.8)
    _kernel_vs_plain(xf, yf, cr, mask=mask, starts=starts, bsz=bsz)
    _kernel_vs_plain(xf, yf, cr, mask=None, starts=starts, bsz=bsz)


@pytest.mark.gpu
def test_cuda_slice_dist_refine_equals_cpu():
    """The fused st_distance count and select on the card equal the CPU
    run's, and go through the kernel."""
    _cuda()
    cols = _columns()
    tconfig.PRUNE_BLOCK.set(512)
    try:
        out = {}
        for dev in ("cpu", "cuda"):
            sft = TSFT.from_spec("gc", SPEC)
            table = TTable.build(sft, cols)
            planner = TPlanner(sft, table, [TZ3(sft, table, dev)])
            before = tdist.dist_refine.launches
            out[dev] = [(planner.count(q), planner.select_indices(q))
                        for q in FUNC_QUERIES[7:9]]
            if dev == "cuda":
                assert tdist.dist_refine.launches > before
    finally:
        tconfig.PRUNE_BLOCK.unset()
    for (cc, cs), (gc, gs) in zip(out["cpu"], out["cuda"]):
        assert cc == gc > 0 and np.array_equal(cs, gs)


COUNT_CASES = [(n, v) for v in ("nomask", "mask", "mask_off1", "mask_off4")
               for n in (0, 1, 15, 16, 17, 1000, 100_003)] + [
    (n, v) for v in ("starts_pow2", "starts_300")
    for n in (300, 1000, 100_003)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,variant", COUNT_CASES)
def test_cuda_dist_refine_counts_equal_flag_sums(n, variant):
    """The kernel's (hit, uncertain) counts, from the same launch as the
    flags, equal the flags' sums: without a mask, with aligned, 1-byte and
    4-byte offset masks (the 4-wide route and the 1-wide one), through
    block starts of a power-of-two and another size, at ragged lengths;
    back to back on one workspace (the kernel leaves it zeroed)."""
    cr = np.asarray([10.0, 45.0, 5.0], dtype=np.float32)
    xf, yf = _band_points(*cr)
    rep = -(-max(n, 1) // len(xf))
    xf, yf = np.tile(xf, rep)[: max(n, 1)], np.tile(yf, rep)[: max(n, 1)]
    rng = np.random.default_rng(n + 5)
    kw = {}
    if variant.startswith("starts"):
        bsz = 256 if variant == "starts_pow2" else 300
        nb = -(-n // bsz)
        kw = {"starts": torch.from_numpy(rng.integers(
                  0, n - bsz + 1, nb).astype(np.int64)),
              "bsz": bsz,
              "mask": torch.from_numpy(rng.random(nb * bsz) < 0.8)}
    else:
        xf, yf = xf[:n], yf[:n]
        if variant != "nomask":
            off = {"mask": 0, "mask_off1": 1, "mask_off4": 4}[variant]
            m = torch.from_numpy(rng.random(n + off) < 0.7)[off:]
            assert m.storage_offset() == off
            kw = {"mask": m}
    for _ in range(2):
        _kernel_vs_plain(xf, yf, cr, **kw)
