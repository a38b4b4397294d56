"""The port's staged scan path (geomesa_tpu_torch ``ScanKernels``, the host
range cover and the planner's staged routing) against the JAX package on
identical state: an 8,000-row table with gather blocks of 512 rows in both
packages. Every comparison is exact:

- each ported ``ScanKernels`` mode's raw output (counts, masks, packed
  selects with their capacity and fill, density grids and counts);
- ``Z3Index.candidate_blocks``, byte for byte, with its ``None`` (no box,
  a cover over the gather fraction, a table under four blocks) and empty
  (provably empty cover) outcomes, and its explain stats;
- counts and selected row ids, in order, for INCLUDE, time-only and
  attribute-only plans, and for box plans with ``GEOMESA_TPU_FUSED_QUERY``
  off and with range pruning off.

The port runs with device="cpu" here: its kernels' plain versions.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu import config as jconfig
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.features.table import FeatureTable as JTable
from geomesa_tpu.filter.evaluate import evaluate as jevaluate
from geomesa_tpu.filter.parser import parse_ecql as jparse
from geomesa_tpu.index import prune as jprune
from geomesa_tpu.index.planner import QueryPlanner as JPlanner
from geomesa_tpu.index.spatial import Z3Index as JZ3
from geomesa_tpu_torch import config as tconfig
from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.index import compiled as tcompiled
from geomesa_tpu_torch.index import prune as tprune
from geomesa_tpu_torch.index.planner import QueryPlanner as TPlanner
from geomesa_tpu_torch.index.spatial import Z3Index as TZ3

SPEC = ("name:String,age:Int,score:Float,dtg:Date,*geom:Point;"
        "geomesa.z3.interval=week")
POLY = "POLYGON((-10 20, 40 20, 40 60, -10 60, 15 40, -10 20))"
DURING = "dtg DURING 2020-01-03T00:00:00Z/2020-01-15T00:00:00Z"
SHORT = "dtg DURING 2020-01-04T00:00:00Z/2020-01-07T00:00:00Z"
Q_PRUNED = f"BBOX(geom, 10, 10, 40, 40) AND {SHORT}"
BBOX = (-60.0, -30.0, 60.0, 30.0)


@pytest.fixture(autouse=True)
def _small_blocks():
    # earlier suites monkeypatch the reference's prune.BLOCK_SIZE; the
    # teardown leaves a real attribute that shadows config.PRUNE_BLOCK
    vars(jprune).pop("BLOCK_SIZE", None)
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.set(512)
    yield
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.unset()
        c.FUSED_QUERY.unset()
        c.PRUNE_ENABLED.unset()


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


def _both(n, seed=11):
    cols = _columns(n, seed)
    jsft = JSFT.from_spec("s", SPEC)
    jt = JTable.build(jsft, cols)
    jp = JPlanner(jsft, jt, [JZ3(jsft, jt)])
    tsft = TSFT.from_spec("s", SPEC)
    tt = TTable.build(tsft, cols)
    tp = TPlanner(tsft, tt, [TZ3(tsft, tt, "cpu")])
    return jp, tp


@pytest.fixture(scope="module")
def world():
    vars(jprune).pop("BLOCK_SIZE", None)
    jconfig.PRUNE_BLOCK.set(512)
    tconfig.PRUNE_BLOCK.set(512)
    try:
        return _both(8000)
    finally:
        jconfig.PRUNE_BLOCK.unset()
        tconfig.PRUNE_BLOCK.unset()


def _args(plan):
    return (plan.primary_kind, plan.boxes_loose, plan.windows,
            plan.residual_device)


MODE_QUERIES = [
    Q_PRUNED,
    f"{Q_PRUNED} AND age > 30",
    f"BBOX(geom, -60, -30, 60, 30) AND {DURING} AND name <> 'gamma'",
    "INCLUDE",
    f"{DURING} AND score >= 0.25",
    "age IN (3, 5, 7)",
]


@pytest.mark.parametrize("q", MODE_QUERIES)
def test_full_table_modes_equal_reference(world, q):
    jp, tp = world
    jk, tk = jp.indexes[0].kernels, tp.indexes[0].kernels
    ja, ta = _args(jp.plan(q)), _args(tp.plan(q))
    assert tk.count(*ta) == jk.count(*ja) > 0
    assert np.array_equal(tk.mask(*ta).numpy(), np.asarray(jk.mask(*ja)))
    assert int(tk.prepare_count(*ta)()) == int(jk.prepare_count(*ja)())
    for cap in (1024, 8192):
        want = np.asarray(jk._get(
            "select_packed", ja[0], ja[2] is not None,
            ja[3][0] if ja[3] else "none", ja[3][2] if ja[3] else None,
            0 if ja[1] is None else len(ja[1]),
            0 if ja[2] is None else len(ja[2]), cap)(
                jk.cols, ja[1], ja[2],
                [np.asarray(p) for p in ja[3][1]] if ja[3] else []))
        got = tk.prepare_select(*ta, cap)()
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
    ji, jc = jk.select(*ja, 1024)
    ti, tc = tk.select(*ta, 1024)
    assert tc == jc and ti.dtype == np.int64 and np.array_equal(ti, ji)


BLOCK_QUERIES = [
    Q_PRUNED,
    f"{Q_PRUNED} AND age > 30",
    f"{Q_PRUNED} AND name IN ('beta', 'delta')",
]


@pytest.mark.parametrize("q", BLOCK_QUERIES)
def test_block_modes_equal_reference(world, q):
    jp, tp = world
    jk, tk = jp.indexes[0].kernels, tp.indexes[0].kernels
    jplan, tplan = jp.plan(q), tp.plan(q)
    blocks = jp._pruned_blocks(jplan)
    assert blocks is not None and len(blocks) > 0
    assert np.array_equal(tp._pruned_blocks(tplan), blocks)
    bsz = 512
    ja, ta = _args(jplan), _args(tplan)
    # the last block of the table, clamped, and pad blocks beside the cover
    for b in (blocks, np.concatenate([blocks, [15]]).astype(np.int32)):
        assert tk.count_blocks(*ta, b, bsz) == jk.count_blocks(*ja, b, bsz)
        assert int(tk.prepare_count_blocks(*ta, b, bsz)()) == \
            int(jk.prepare_count_blocks(*ja, b, bsz)())
        ji, jc = jk.select_blocks(*ja, b, bsz, 1024)
        ti, tc = tk.select_blocks(*ta, b, bsz, 1024)
        assert tc == jc > 0 and np.array_equal(ti, ji)
        pad = jk._pad_blocks(b)
        assert np.array_equal(tk._pad_blocks(b), pad)
        want = np.asarray(jk._get(
            "select_blocks", ja[0], True, ja[3][0] if ja[3] else "none",
            ja[3][2] if ja[3] else None, len(ja[1]), len(ja[2]),
            (len(pad), bsz, 2048))(
                jk.cols, ja[1], ja[2],
                [np.asarray(p) for p in ja[3][1]] if ja[3] else [], pad))
        got = tk.prepare_select_blocks(*ta, b, bsz, 2048)()
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("weight", [None, "age"])
@pytest.mark.parametrize("shape", [(64, 64), (7, 5)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_density_modes_equal_reference(world, shape, weight):
    """Unit grids byte for byte; ``age`` weights are small integers, whose
    f32 sums are exact in any order here (every cell sum stays far below
    2^24), so those are byte for byte too."""
    jp, tp = world
    jk, tk = jp.indexes[0].kernels, tp.indexes[0].kernels
    w, h = shape
    for q in (Q_PRUNED, f"BBOX(geom, -60, -30, 60, 30) AND {DURING}"):
        ja, ta = _args(jp.plan(q)), _args(tp.plan(q))
        cnt = jk.count(*ja)
        jg, jc = jk.prepare_density_compact(*ja, BBOX, w, h, 1 << 17,
                                            weight)()
        tg, tc = tk.prepare_density_compact(*ta, BBOX, w, h, 1 << 17,
                                            weight)()
        assert int(tc) == int(jc) == cnt
        assert np.array_equal(tg.numpy(), np.asarray(jg))
        blocks = jp._pruned_blocks(jp.plan(Q_PRUNED))
        jg, jc = jk.prepare_density_blocks(*ja, BBOX, w, h, blocks, 512,
                                           weight)()
        tg, tc = tk.prepare_density_blocks(*ta, BBOX, w, h, blocks, 512,
                                           weight)()
        assert int(tc) == int(jc)
        assert np.array_equal(tg.numpy(), np.asarray(jg))


@pytest.mark.parametrize("q,outcome", [
    (Q_PRUNED, "blocks"),
    (f"BBOX(geom, -20, -10, 0, 5) AND {SHORT}", "blocks"),
    (f"BBOX(geom, 170, -10, -170, 10) AND {SHORT}", "blocks"),  # split box
    ("BBOX(geom, -170, -80, 170, 80)", "none"),            # over the fraction
    (f"{DURING} AND age > 3", "none"),                     # no spatial box
    ("BBOX(geom, 10, 10, 40, 40) AND dtg DURING "
     "2021-03-01T00:00:00Z/2021-03-09T00:00:00Z", "empty"),  # no data there
])
def test_candidate_blocks_byte_equal(world, q, outcome):
    jp, tp = world
    jplan, tplan = jp.plan(q), tp.plan(q)
    want = jp.indexes[0].candidate_blocks(jplan)
    got = tp.indexes[0].candidate_blocks(tplan)
    if outcome == "none":
        assert want is None and got is None
        return
    assert got.dtype == want.dtype == np.int32
    assert got.tobytes() == want.tobytes()
    assert (len(got) > 0) == (outcome == "blocks")
    keys = ("candidate_rows", "candidate_blocks", "scanned_rows",
            "scanned_fraction")
    assert {k: tplan.explain[k] for k in keys} == \
        {k: jplan.explain[k] for k in keys}


def test_candidate_blocks_none_for_tiny_tables():
    jp, tp = _both(1500, seed=3)          # 3 blocks of 512 rows
    jplan, tplan = jp.plan(Q_PRUNED), tp.plan(Q_PRUNED)
    assert jp.indexes[0].candidate_blocks(jplan) is None
    assert tp.indexes[0].candidate_blocks(tplan) is None


def test_sorted_keys_equal_reference(world):
    jp, tp = world
    ji, ti = jp.indexes[0], tp.indexes[0]
    assert np.array_equal(ti.sorted_z, ji.sorted_z)
    assert np.array_equal(ti.sorted_bins, np.asarray(ji.sorted_bins))
    w = (0, 100000)
    assert all(np.array_equal(a, b) for a, b in zip(
        ti._sfc.ranges_arrays([(10, 10, 40, 40)], [w], max_ranges=2000),
        ji._sfc.ranges_arrays([(10, 10, 40, 40)], [w], max_ranges=2000)))
    assert tprune.MAX_RANGES == jprune.MAX_RANGES == 2000


def _parity(jp, tp, q):
    jc, tc = jp.count(q), tp.count(q)
    js, ts = jp.select_indices(q), tp.select_indices(q)
    assert tc == jc, q
    assert ts.dtype == np.int64 and np.array_equal(ts, js), q
    assert tc == int(jevaluate(jparse(q), jp.table).sum()), q
    return tc


STAGED = [
    "INCLUDE",
    DURING,
    f"{DURING} AND age > 3",
    "age < 20",
    "name = 'beta' AND score < 0.5",
    "NOT (age <> 7)",
    "dtg DURING 2021-03-01T00:00:00Z/2021-03-09T00:00:00Z",
]


@pytest.mark.parametrize("q", STAGED)
def test_plans_without_a_box(world, q, monkeypatch):
    """INCLUDE, time-only and attribute-only plans run the staged full-table
    scan: the fused program declines them in both packages."""
    jp, tp = world
    seen = []
    monkeypatch.setattr(tcompiled, "Program", lambda *a, **k: seen.append(a))
    n = _parity(jp, tp, q)
    assert not seen
    assert n > 0 or "2021" in q or "7" in q


FUSED_OFF = [
    Q_PRUNED,
    f"BBOX(geom, -60, -30, 60, 30) AND {DURING} AND age > 10",
    "BBOX(geom, 170, -10, -170, 10) AND age > 50",
    f"INTERSECTS(geom, {POLY}) AND {DURING}",
    f"INTERSECTS(geom, {POLY}) AND {SHORT}",
    "BBOX(geom, 10, 10, 40, 40) AND dtg DURING "
    "2021-03-01T00:00:00Z/2021-03-09T00:00:00Z",
]


@pytest.mark.parametrize("prune", [True, False])
@pytest.mark.parametrize("q", FUSED_OFF)
def test_fused_query_off_runs_staged(world, q, prune, monkeypatch):
    """With GEOMESA_TPU_FUSED_QUERY off the staged path answers box plans:
    the range-pruned blocks (or the full mask), with polygon residuals
    refined on the host."""
    jp, tp = world
    for c in (jconfig, tconfig):
        c.FUSED_QUERY.set(False)
        c.PRUNE_ENABLED.set(prune)
    seen = []
    monkeypatch.setattr(tcompiled, "Program", lambda *a, **k: seen.append(a))
    _parity(jp, tp, q)
    assert not seen


def test_staged_select_regrows_capacity(world):
    jp, tp = world
    q = f"{DURING} AND age >= 0"
    tk = tp.indexes[0].kernels
    plan = tp.plan(q)
    idx, cnt = tk.select(*_args(plan), 16)
    assert cnt > 16 and len(idx) == cnt
    assert np.array_equal(np.sort(tp.indexes[0].map_rows(idx)),
                          jp.select_indices(q))
