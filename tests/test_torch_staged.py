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
from geomesa_tpu_torch.index import scan as tscan
from geomesa_tpu_torch.index.api import UnionScanPlan
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


# -- the staged modes on the kernel route (fused_scan) -------------------------
#
# Every staged mode over the same stages in both packages, on a table whose
# row count is not a multiple of the block (5,037 rows, 512-row blocks), with
# points on the domain's edges, and again with a ``__valid__`` column that
# clears a fifth of the rows (both packages' modes AND it): counts, masks,
# packed selects and unit grids byte for byte; ``age`` grids too (small
# integer weights, exact in f32 in any order).

WIDE = 17   # one residual column more than the fused_scan kernel holds
EDGE_SPEC = ("name:String,age:Int,score:Float,"
             + ",".join(f"c{k}:Int" for k in range(WIDE))
             + ",dtg:Date,*geom:Point;geomesa.z3.interval=week")
EDGE_N = 5037


def _deep(k: int = 70) -> str:
    """A residual nested past the program stack (AND and OR in turn)."""
    r = "age > 1"
    for j in range(k):
        r = f"(age <> {j + 200} {'AND' if j % 2 else 'OR'} {r})"
    return r


# (label, query, kernel route?)
STAGES = [
    ("box", Q_PRUNED, True),
    ("box_resid", f"{Q_PRUNED} AND age > 30", True),
    ("box_in_float", "BBOX(geom, -60, -30, 60, 30) AND name IN ('b', 'c') "
     "AND score >= 0.25", True),
    ("none_windows_resid", f"{DURING} AND age > 30", True),
    ("none_resid", "age < 20", True),
    ("none_windows", DURING, True),
    ("include", "INCLUDE", True),
    ("edge_corner", "BBOX(geom, 175, 85, 180, 90)", True),
    ("whole_world", "BBOX(geom, -180, -90, 180, 90)", True),
    ("wide", f"{Q_PRUNED} AND "
     + " AND ".join(f"c{k} < 97" for k in range(WIDE)), False),
    ("deep", f"BBOX(geom, -60, -30, 60, 30) AND {_deep()}", False),
]


@pytest.fixture(scope="module")
def edge_world():
    rng = np.random.default_rng(29)
    cols = _columns(EDGE_N, 23)
    x, y = cols.pop("geom")
    # the domain's edges, where fp62 clamps
    x[:10] = [-180.0, 180.0, -180.0, 180.0, 179.99999999999997, 0.0, -180.0,
              180.0, 175.0, -177.5]
    y[:10] = [-90.0, 90.0, 90.0, -90.0, 89.99999999999999, 90.0, -87.0, 85.0,
              -90.0, 90.0]
    cols["name"] = rng.choice(["a", "b", "c"], EDGE_N)
    cols["geom"] = (x, y)
    for k in range(WIDE):
        cols[f"c{k}"] = rng.integers(0, 100, EDGE_N).astype(np.int32)
    vars(jprune).pop("BLOCK_SIZE", None)
    jconfig.PRUNE_BLOCK.set(512)
    tconfig.PRUNE_BLOCK.set(512)
    try:
        jsft, tsft = JSFT.from_spec("e", EDGE_SPEC), TSFT.from_spec(
            "e", EDGE_SPEC)
        jt, tt = JTable.build(jsft, cols), TTable.build(tsft, cols)
        jp = JPlanner(jsft, jt, [JZ3(jsft, jt)])
        tp = TPlanner(tsft, tt, [TZ3(tsft, tt, "cpu")])
    finally:
        jconfig.PRUNE_BLOCK.unset()
        tconfig.PRUNE_BLOCK.unset()
    valid = rng.random(EDGE_N) >= 0.2
    valid[:10] = [True, False] * 5
    return jp, tp, valid


def _kernels(jp, tp, valid):
    """Both packages' ScanKernels over their index's columns, with the
    ``__valid__`` column when given."""
    import jax.numpy as jnp

    from geomesa_tpu.index.scan import ScanKernels as JKernels
    from geomesa_tpu_torch.index.scan import ScanKernels as TKernels
    jcols = dict(jp.indexes[0].device.columns)
    tcols = dict(tp.indexes[0].device.columns)
    if valid is not None:
        jcols["__valid__"] = jnp.asarray(valid)
        tcols["__valid__"] = torch.from_numpy(valid)
    return JKernels(jcols), TKernels(tcols)


def _packed(jk, mode, ja, extra):
    res = ja[3]
    return np.asarray(jk._get(
        mode, ja[0], ja[2] is not None, res[0] if res else "none",
        res[2] if res else None, 0 if ja[1] is None else len(ja[1]),
        0 if ja[2] is None else len(ja[2]), extra[0])(
            jk.cols, ja[1], ja[2],
            [np.asarray(p) for p in res[1]] if res else [], *extra[1:]))


def _refuse(*a, **k):
    raise AssertionError("the torch-ops route ran")


def _torch_ops_refused(monkeypatch, stages):
    """Make the torch-ops route raise — the staged mask's torch ops and
    the residual's torch closure — so the modes must run on the kernel;
    returns the stages with that closure."""
    monkeypatch.setattr(tscan, "_mask_kernel", _refuse)
    monkeypatch.setattr(tscan.ScanKernels, "_stage", _refuse)
    return [st if st[3] is None else (*st[:3], st[3]._replace(fn=_refuse))
            for st in stages]


@pytest.mark.parametrize("valid", [False, True], ids=["all_valid",
                                                      "valid_col"])
@pytest.mark.parametrize("label,q,kernel", STAGES,
                         ids=[s[0] for s in STAGES])
def test_staged_modes_equal_reference_on_both_routes(edge_world, label, q,
                                                     kernel, valid,
                                                     monkeypatch):
    jp, tp, vmask = edge_world
    jk, tk = _kernels(jp, tp, vmask if valid else None)
    ja, ta = _args(jp.plan(q)), _args(tp.plan(q))
    assert (tscan.staged_query(tk.cols, [ta]) is not None) == kernel
    if kernel:
        (ta,) = _torch_ops_refused(monkeypatch, [ta])
    n = EDGE_N
    # full-table modes
    want_mask = np.asarray(jk.mask(*ja))
    got_mask = tk.mask(*ta)
    assert got_mask.dtype == torch.bool and got_mask.shape == (n,)
    assert np.array_equal(got_mask.numpy(), want_mask)
    want = int(want_mask.sum())
    assert want > 0
    assert tk.count(*ta) == jk.count(*ja) == want
    assert int(tk.prepare_count(*ta)()) == want
    for cap in (16, 1024, 8192):
        got = tk.prepare_select(*ta, cap)()
        assert np.array_equal(got.numpy(),
                              _packed(jk, "select_packed", ja, (cap,)))
    # block modes: the table's last (clamped) block, a middle run and pads
    blocks = np.array([0, 3, 4, 7, 9], dtype=np.int32)
    pad = jk._pad_blocks(blocks)
    assert np.array_equal(tk._pad_blocks(blocks), pad)
    assert tk.count_blocks(*ta, blocks, 512) == \
        jk.count_blocks(*ja, blocks, 512)
    got = tk.prepare_select_blocks(*ta, blocks, 512, 2048)()
    assert np.array_equal(got.numpy(), _packed(
        jk, "select_blocks", ja, ((len(pad), 512, 2048), pad)))
    ji, jc = jk.select_blocks(*ja, blocks, 512, 16)
    ti, tc = tk.select_blocks(*ta, blocks, 512, 16)
    assert tc == jc and np.array_equal(ti, ji)
    if ta[0] == "point_boxes":   # per-box counts: box_count behind the mask
        for b in (None, blocks):  # of the residual alone
            jm = jk.counts_multi(*ja) if b is None \
                else jk.counts_multi_blocks(*ja, b, 512)
            tm = tk.counts_multi(*ta) if b is None \
                else tk.counts_multi_blocks(*ta, b, 512)
            assert np.array_equal(tm, np.asarray(jm))
    # densities, unit and ``age`` weights
    for wname in (None, "age"):
        jg, jn = jk.prepare_density_compact(*ja, BBOX, 16, 8, 1 << 17,
                                            wname)()
        tg, tn = tk.prepare_density_compact(*ta, BBOX, 16, 8, 1 << 17,
                                            wname)()
        assert int(tn) == int(jn) == want
        assert tg.dtype == torch.float32
        assert np.array_equal(tg.numpy(), np.asarray(jg))
        jg, jn = jk.prepare_density_blocks(*ja, BBOX, 16, 8, blocks, 512,
                                           wname)()
        tg, tn = tk.prepare_density_blocks(*ta, BBOX, 16, 8, blocks, 512,
                                           wname)()
        assert int(tn) == int(jn)
        assert np.array_equal(tg.numpy(), np.asarray(jg))


UNIONS = [
    ("two_boxes", [f"BBOX(geom, -20, 10, -5, 25) AND {DURING}",
                   "BBOX(geom, -10, 15, 30, 40) AND age > 50"], True),
    ("box_and_none", [f"BBOX(geom, 0, 0, 40, 40) AND {SHORT}",
                      f"{DURING} AND age < 5"], True),
    ("three", [Q_PRUNED, "BBOX(geom, 170, 80, 180, 90)",
               "name = 'b' AND score < 0.1"], True),
    ("wide_between", [f"{Q_PRUNED} AND "
                      + " AND ".join(f"c{k} < 97" for k in range(9)),
                      "BBOX(geom, -60, -30, 0, 0) AND "
                      + " AND ".join(f"c{k} < 97" for k in range(9, WIDE))],
     False),
]


@pytest.mark.parametrize("valid", [False, True], ids=["all_valid",
                                                      "valid_col"])
@pytest.mark.parametrize("label,qs,kernel", UNIONS,
                         ids=[u[0] for u in UNIONS])
def test_union_count_and_mask_equal_reference(edge_world, label, qs, kernel,
                                              valid, monkeypatch):
    """The OR of stages: one K-branch ``fused_scan`` count (rows that
    several stages hold count once) and its row mask, against the sum of
    the reference's OR of masks."""
    jp, tp, vmask = edge_world
    jk, tk = _kernels(jp, tp, vmask if valid else None)
    stages = [_args(tp.plan(q)) for q in qs]
    assert (tscan.staged_query(tk.cols, stages) is not None) == kernel
    if kernel:
        stages = _torch_ops_refused(monkeypatch, stages)
    masks = [np.asarray(jk.mask(*_args(jp.plan(q)))) for q in qs]
    want = np.logical_or.reduce(masks)
    if label in ("two_boxes", "box_and_none"):   # rows both stages hold
        assert want.sum() < sum(m.sum() for m in masks)
    assert tk.union_count(stages) == int(want.sum()) > 0
    assert int(tk.prepare_union_count(stages)()) == int(want.sum())
    got = tk.union_mask(stages)
    assert got.shape == (EDGE_N,) and np.array_equal(got.numpy(), want)


def test_boxless_branch_holds_every_row_and_only_valid_ones(edge_world):
    """Primary "none" is a branch without boxes: every row is in it, on the
    domain's edges too, and ``__valid__`` clears its rows, as in the
    reference's mask without a primary. Such a query reads no point plane
    (``points`` False), one that ORs it with a box does."""
    jp, tp, vmask = edge_world
    jk, tk = _kernels(jp, tp, vmask)
    stage = ("none", None, None, None)
    want = np.asarray(jk.mask(*stage))
    assert np.array_equal(want, vmask)
    m = tk.mask(*stage)
    assert np.array_equal(m.numpy(), want)
    assert tk.union_count([stage]) == int(vmask.sum())
    assert not tscan.staged_query(tk.cols, [stage]).points
    box = _args(tp.plan("BBOX(geom, 175, 85, 180, 90)"))
    q = tscan.staged_query(tk.cols, [stage, box])
    assert q.points and q.boxless == [True, False]
    assert tk.union_count([box, stage]) == int(vmask.sum())
    assert _kernels(jp, tp, None)[1].mask(*stage).all()


def test_tiny_table_scans_one_block(monkeypatch):
    """A table smaller than one block scans it as one block of n rows."""
    jp, tp = _both(300, seed=5)
    jk, tk = jp.indexes[0].kernels, tp.indexes[0].kernels
    for q in (f"{DURING} AND age > 30", "BBOX(geom, -60, -30, 60, 30)"):
        ja, ta = _args(jp.plan(q)), _args(tp.plan(q))
        (ta,) = _torch_ops_refused(monkeypatch, [ta])
        assert np.array_equal(tk.mask(*ta).numpy(), np.asarray(jk.mask(*ja)))
        assert tk.count(*ta) == jk.count(*ja)
        assert np.array_equal(tk.prepare_select(*ta, 512)().numpy(),
                              _packed(jk, "select_packed", ja, (512,)))


def test_cover_blocks_larger_than_the_table_raise():
    """A cover whose block is larger than the table cannot be scanned (its
    clamped block would read past the table's end): the block modes
    raise."""
    _, tp = _both(300, seed=5)
    tk = tp.indexes[0].kernels
    ta = _args(tp.plan(f"{DURING} AND age > 30"))
    blocks = np.array([0], dtype=np.int32)
    with pytest.raises(ValueError, match="over a table of 300"):
        tk.count_blocks(*ta, blocks, 512)
    with pytest.raises(ValueError, match="over a table of 300"):
        tk.prepare_density_blocks(*ta, BBOX, 8, 8, blocks, 512, None)


def _route(tp, q) -> str:
    """The planner's route for a count of ``q``: the fused program (with a
    refine), the staged scan over the range cover or over the table, the
    union on the device or by row sets, or an empty plan."""
    plan = tp.plan(q)
    if plan.empty:
        return "empty"
    if isinstance(plan, UnionScanPlan):
        return "union-device" if plan.same_index_device_exact() is not None \
            else "union-rows"
    if plan.residual_host is None:
        if tcompiled._from_plan(plan, "count") is not None:
            return "fused"
    elif tcompiled._from_plan(plan, "count_refine") is not None:
        return "fused-refine"
    return "staged-pruned" if tp._pruned_blocks(plan) is not None \
        else "staged-full"


# the routes of the staged tests' queries, as the planner took them before
# the staged modes ran on the kernel (unchanged by it)
ROUTES = {
    Q_PRUNED: "fused",
    f"{Q_PRUNED} AND age > 30": "fused",
    f"{Q_PRUNED} AND name IN ('beta', 'delta')": "fused",
    f"BBOX(geom, -60, -30, 60, 30) AND {DURING} AND name <> 'gamma'":
        "fused",
    "INCLUDE": "staged-full",
    f"{DURING} AND score >= 0.25": "staged-full",
    "age IN (3, 5, 7)": "staged-full",
    DURING: "staged-full",
    f"{DURING} AND age > 3": "staged-full",
    "age < 20": "staged-full",
    "name = 'beta' AND score < 0.5": "staged-full",
    "NOT (age <> 7)": "staged-full",
    "dtg DURING 2021-03-01T00:00:00Z/2021-03-09T00:00:00Z": "staged-full",
    f"INTERSECTS(geom, {POLY}) AND {DURING}": "fused-refine",
    f"INTERSECTS(geom, {POLY}) AND {SHORT}": "fused-refine",
    f"BBOX(geom, 170, -10, -170, 10) AND {SHORT}": "fused",
    "BBOX(geom, 10, 10, 40, 40) AND dtg DURING "
    "2021-03-01T00:00:00Z/2021-03-09T00:00:00Z": "fused",
    f"BBOX(geom, -20, 10, -5, 25) AND {DURING} OR "
    "BBOX(geom, -10, 15, 30, 40) AND age > 50": "union-device",
    f"BBOX(geom, -20, 10, -5, 25) OR INTERSECTS(geom, {POLY})":
        "union-rows",
}


@pytest.mark.parametrize("fused", [True, False], ids=["fused_on",
                                                      "fused_off"])
@pytest.mark.parametrize("q", list(ROUTES))
def test_routes_unchanged(world, q, fused):
    """The planner picks the route it picked before the staged modes ran
    on the kernel: fused, staged or union. With the fused program off every
    fused route is staged, as before."""
    _, tp = world
    tconfig.FUSED_QUERY.set(fused)
    want = ROUTES[q]
    if not fused and want in ("fused", "fused-refine"):
        want = "staged-pruned" if tp._pruned_blocks(tp.plan(q)) is not None \
            else "staged-full"
    assert _route(tp, q) == want
