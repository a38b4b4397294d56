"""The port's Z3 point slice (geomesa_tpu_torch) against the JAX package on
identical state: the 6,000-row corpus of the fused-query tests with gather
blocks of 512 rows in both packages, so the reference's fused program
qualifies. Device columns and the sort permutation must be equal, counts
exact, selected row ids exact and in order — for box+time scans, every
residual op, string predicates, the concave-polygon refine (with the
reference's Pallas kernel off and on), an empty window and a 3-row table.
The port runs with device="cpu" here: its kernels' plain versions."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from geomesa_tpu import config as jconfig
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.features.table import FeatureTable as JTable
from geomesa_tpu.filter.evaluate import evaluate as jevaluate
from geomesa_tpu.filter.parser import parse_ecql as jparse
from geomesa_tpu.index import compiled as jcompiled
from geomesa_tpu.index.planner import QueryPlanner as JPlanner
from geomesa_tpu.index.spatial import Z3Index as JZ3
from geomesa_tpu_torch import DataStoreFinder
from geomesa_tpu_torch import config as tconfig
from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.index import compiled as tcompiled
from geomesa_tpu_torch.index import scan as tscan
from geomesa_tpu_torch.index.device import DeviceTable
from geomesa_tpu_torch.index.planner import QueryPlanner as TPlanner
from geomesa_tpu_torch.index.spatial import Z3Index as TZ3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = ("name:String,age:Int,score:Float,dtg:Date,*geom:Point;"
        "geomesa.z3.interval=week")
POLY = "POLYGON((-10 20, 40 20, 40 60, -10 60, 15 40, -10 20))"
DURING = "dtg DURING 2020-01-03T00:00:00Z/2020-01-15T00:00:00Z"
BOX = "BBOX(geom,-60,-30,60,30)"


def _unshadow_block_size():
    # earlier suites monkeypatch the reference's prune.BLOCK_SIZE; the
    # teardown leaves a real attribute that shadows config.PRUNE_BLOCK
    from geomesa_tpu.index import prune
    vars(prune).pop("BLOCK_SIZE", None)


@pytest.fixture(autouse=True)
def _small_blocks():
    _unshadow_block_size()
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.set(512)
        c.FUSED_QUERY.set(True)
    yield
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.unset()
        c.FUSED_QUERY.unset()
    jconfig.PALLAS_REFINE.unset()


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


def _both(n=6000, seed=7):
    cols = _columns(n, seed)
    jsft = JSFT.from_spec("fq", SPEC)
    jt = JTable.build(jsft, cols)
    jp = JPlanner(jsft, jt, [JZ3(jsft, jt)])
    tsft = TSFT.from_spec("fq", SPEC)
    tt = TTable.build(tsft, cols)
    tp = TPlanner(tsft, tt, [TZ3(tsft, tt, "cpu")])
    return jp, tp


@pytest.fixture(scope="module")
def world():
    _unshadow_block_size()
    jconfig.PRUNE_BLOCK.set(512)
    tconfig.PRUNE_BLOCK.set(512)
    try:
        return _both()
    finally:
        jconfig.PRUNE_BLOCK.unset()
        tconfig.PRUNE_BLOCK.unset()


def test_state_carries_over(world):
    jp, tp = world
    jidx, tidx = jp.indexes[0], tp.indexes[0]
    assert np.array_equal(jidx.perm, tidx.perm.numpy())
    jcols = {k: np.asarray(v) for k, v in jidx.device.columns.items()}
    carried = DeviceTable.from_numpy(jcols, "cpu")
    own = tidx.device
    assert set(carried.columns) == set(own.columns) == set(jcols)
    assert carried.n == own.n == len(jidx.perm)
    for k in jcols:
        assert carried[k].dtype == own[k].dtype, k
        assert torch.equal(carried[k], own[k]), k
    assert tidx.vocabs == jidx.vocabs


def _parity(jp, tp, q):
    jc = jp.count(q)
    js = jp.select_indices(q)
    tc = tp.count(q)
    ts = tp.select_indices(q)
    assert tc == jc, q
    assert ts.dtype == np.int64
    assert np.array_equal(ts, js), q
    host = jevaluate(jparse(q), jp.table)
    assert tc == int(host.sum()), q
    return tc


RESIDUALS = [
    "age > 10",
    "age <= 30 AND score >= 0.25",
    "(age < 50 OR score = 0.5)",
    "NOT (age <> 7)",
    "name = 'beta'",
    "name = 'zeta'",
    "name <> 'gamma'",
    "name IN ('beta','delta','zeta')",
    "age IN (3, 5, 7)",
]


@pytest.mark.parametrize("res", RESIDUALS)
def test_box_time_residual(world, res):
    jp, tp = world
    assert _parity(jp, tp, f"{BOX} AND {DURING} AND {res}") > 0 \
        or "zeta" in res or "7" in res


@pytest.mark.parametrize("q", [
    f"{BOX} AND {DURING}",
    "BBOX(geom,-170,-80,170,80)",                      # gate overfull: full
    "BBOX(geom,170,-10,-170,10) AND age > 50",         # antimeridian split
    f"BBOX(geom,-60,-30,60,30) AND dtg DURING "
    "2021-03-01T00:00:00Z/2021-03-09T00:00:00Z",       # empty window
])
def test_box_time(world, q):
    jp, tp = world
    _parity(jp, tp, q)


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("during", [True, False])
def test_polygon_refine(world, pallas, during):
    jp, tp = world
    jconfig.PALLAS_REFINE.set(pallas)
    q = f"INTERSECTS(geom, {POLY})" + (f" AND {DURING}" if during else "")
    assert _parity(jp, tp, q) > 0


@pytest.mark.parametrize("mode,q", [
    ("count", f"{BOX} AND {DURING} AND age > 10"),
    ("select", f"{BOX} AND {DURING} AND name <> 'gamma'"),
    ("select", "BBOX(geom,-170,-80,170,80)"),
    ("count_refine", f"INTERSECTS(geom, {POLY})"),
    ("select_refine", f"INTERSECTS(geom, {POLY}) AND {DURING}"),
])
def test_program_output_equals_reference(world, mode, q):
    """The fused program's raw int32 result, value for value."""
    jp, tp = world
    jprog = jcompiled._from_plan(jp, jp.plan(q), mode)
    want = np.atleast_1d(np.asarray(jprog.dispatch()))
    tplan = tp.plan(q)
    refine = tcompiled.refine_spec(tplan) if "refine" in mode else None
    got = tcompiled.Program(tplan, mode, sel_cap=jprog.sel_cap,
                            unc_cap=jprog.unc_cap, refine=refine).run()
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["count_refine", "select_refine"])
def test_refine_gathers_no_coordinates(world, monkeypatch, mode):
    """On the pruned branch (a one-day window keeps 3 of 12 blocks) the
    program reads every column in place through the alive blocks' starts:
    the gate lists those blocks on the device, nothing is gathered (the
    mask's columns no more than xf/yf), and the raw result is the
    reference's, value for value."""
    jp, tp = world
    q = (f"INTERSECTS(geom, {POLY}) AND dtg DURING "
         "2020-01-05T00:00:00Z/2020-01-06T00:00:00Z")
    jprog = jcompiled._from_plan(jp, jp.plan(q), mode)
    want = np.asarray(jprog.dispatch())
    seen = []
    gather = tscan._Gather.__getitem__
    monkeypatch.setattr(tscan._Gather, "__getitem__",
                        lambda self, k: seen.append(k) or gather(self, k))
    plan = tp.plan(q)
    prog = tcompiled.Program(plan, mode, sel_cap=jprog.sel_cap,
                             unc_cap=jprog.unc_cap,
                             refine=tcompiled.refine_spec(plan))
    assert prog.n_edges == 5
    got = prog.run()
    assert seen == []
    ids, starts, nblk = prog._gate()
    alive = int(nblk[0])
    assert 0 < alive < ids.shape[0]               # the pruned branch's blocks
    assert (ids[:alive] >= 0).all() and (ids[alive:] == -1).all()
    assert torch.equal(starts[:alive],
                       (ids[:alive].long() * prog.bsz).clamp(
                           0, prog.n - prog.bsz))
    assert got[0] > 0 and np.array_equal(got.numpy(), want)


def test_three_row_table_runs_full_branch():
    cols = _columns(3, seed=1)
    cols["geom"] = (np.array([1.0, 20.0, 30.0]), np.array([25.0, 45.0, 50.0]))
    jsft = JSFT.from_spec("fq", SPEC)
    jt = JTable.build(jsft, cols)
    jp = JPlanner(jsft, jt, [JZ3(jsft, jt)])
    tsft = TSFT.from_spec("fq", SPEC)
    tt = TTable.build(tsft, cols)
    tp = TPlanner(tsft, tt, [TZ3(tsft, tt, "cpu")])
    for q in ("BBOX(geom,0,0,40,60)", f"INTERSECTS(geom, {POLY})",
              "BBOX(geom,0,0,40,60) AND name <> 'beta'"):
        _parity(jp, tp, q)


def _store(n=6000):
    store = DataStoreFinder.get_data_store(type="torch", device="cpu")
    sft = store.create_schema("fq", SPEC)
    store.load("fq", TTable.build(sft, _columns(n, 7)))
    return store


@pytest.mark.parametrize("spec,item", [
    (SPEC.replace("age:Int", "age:Int:index=true"), "item 10"),
    (SPEC + ",geomesa.indices='z3,attr:age'", "item 10"),
])
def test_outside_slice_raises_naming_roadmap(spec, item):
    """The attribute and configured indexes, once refused naming ``item``
    (ROADMAP.md Queue 1 item 10's rest), are ported: the schema creates and
    plans and counts ``age = 40`` as the reference does (the quoted
    ``geomesa.indices`` value names no index it knows, in both). A
    configured S2 index beside the attribute index, once refused naming
    item 9, builds in both and answers alike."""
    from geomesa_tpu.datastore import TpuDataStore
    store = DataStoreFinder.get_data_store(type="torch", device="cpu")
    ref = TpuDataStore()
    for s, tbl in ((store, TTable), (ref, JTable)):
        s.create_schema("fq", spec)
        s.load("fq", tbl.build(s.get_schema("fq"), _columns(3000, 7)))
    for q in ("age = 40", "age > 90 AND BBOX(geom,0,0,40,60)"):
        assert store.explain("fq", q)["index"] \
            == ref.explain("fq", q)["index"], q
        assert store.count("fq", q) == ref.count("fq", q), q
    assert item == "item 10"
    s2 = spec.split(";")[0] + ";geomesa.indices=s2,attr:age"
    for s, tbl in ((store, TTable), (ref, JTable)):
        s.create_schema("s2", s2)
        s.load("s2", tbl.build(s.get_schema("s2"), _columns(3000, 7)))
    for q in ("age = 40", "BBOX(geom,0,0,40,60)",
              "age > 90 AND BBOX(geom,0,0,40,60)"):
        assert store.explain("s2", q)["index"] \
            == ref.explain("s2", q)["index"], q
        assert store.count("s2", q) == ref.count("s2", q), q
        assert np.array_equal(store.query("s2", q).indices,
                              ref.query("s2", q).indices), q


@pytest.mark.parametrize("q", ["IN ('1', '2')", "IN ('1', '2', 'x', '5999')",
                               f"IN ('3', '40', '41') AND {BOX}"])
def test_fid_lookups_match_reference(world, q):
    """Feature-id lookups (once refused as ROADMAP.md Queue 1 item 10)
    answer as the reference does, through the planner and the store."""
    jp, tp = world
    _parity(jp, tp, q)
    assert _store(6000).count("fq", q) == jp.count(q)


@pytest.mark.parametrize("q", [
    f"{BOX} OR INTERSECTS(geom, {POLY})",
    f"{DURING} AND st_distance(geom, POINT(0 0)) < 5",
    "st_distance(geom, POINT(0 0)) < 5 AND BBOX(geom,-5,-5,5,5)",
])
def test_former_outside_slice_cases_match_reference(world, q):
    """The OR-union and st_* shapes this slice once refused (ROADMAP.md
    Queue 1 items 3 and 5, now ported) answer as the reference does."""
    jp, tp = world
    _parity(jp, tp, q)


def test_prepare_with_auths_raises_naming_roadmap():
    """Prepared queries under auths (once refused as ROADMAP.md Queue 1
    item 10): a table without visibility labels is public, so every auths
    see every row; labelled tables: ``tests/test_torch_security.py``."""
    planner = _store(600).planner("fq")
    for auths in (["admin"], []):
        assert planner.prepare(BOX, auths=auths).count() \
            == planner.count(BOX)


def test_store_count_and_query(world):
    jp, _ = world
    store = _store()
    q = f"INTERSECTS(geom, {POLY}) AND {DURING}"
    res = store.query("fq", q)
    assert store.count("fq", q) == res.count == jp.count(q)
    assert np.array_equal(res.indices, jp.select_indices(q))
    assert len(res.table) == res.count
    # a second load appends through the LSM delta tier (ported since the
    # write path): the same rows again, stacked above the main table
    n = len(store.tables["fq"])
    store.load("fq", store.tables["fq"])
    assert store.deltas["fq"] is not None
    assert store.count("fq", q) == 2 * jp.count(q)
    rows = jp.select_indices(q)
    assert np.array_equal(store.query("fq", q).indices,
                          np.concatenate([rows, rows + n]))


def test_cuda_requested_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        DataStoreFinder.get_data_store(type="torch", device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        DataStoreFinder.get_data_store(type="torch")   # cuda by default


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import sys, numpy as np\n"
        "from geomesa_tpu_torch import DataStoreFinder\n"
        "import geomesa_tpu_torch.serve.scheduler, "
        "geomesa_tpu_torch.serve.resilience, geomesa_tpu_torch.metrics, "
        "geomesa_tpu_torch.trace, geomesa_tpu_torch.index.guards, "
        "geomesa_tpu_torch.durability.faults, "
        "geomesa_tpu_torch.kernels.box_count, "
        "geomesa_tpu_torch.kernels.hist, geomesa_tpu_torch.kernels.topk, "
        "geomesa_tpu_torch.stats, geomesa_tpu_torch.process, "
        "geomesa_tpu_torch.aggregates.stats_scan, "
        "geomesa_tpu_torch.aggregates.bin, "
        "geomesa_tpu_torch.aggregates.sampling, "
        "geomesa_tpu_torch.parallel, geomesa_tpu_torch.parallel.join, "
        "geomesa_tpu_torch.parallel.pair_kernel, "
        "geomesa_tpu_torch.kernels.pip_join, "
        "geomesa_tpu_torch.kernels.pair_band\n"
        "from geomesa_tpu_torch.features.table import FeatureTable\n"
        "s = DataStoreFinder.get_data_store(type='torch', device='cpu')\n"
        "sft = s.create_schema('t', 'val:Int,dtg:Date,*geom:Point')\n"
        "r = np.random.default_rng(0)\n"
        "s.load('t', FeatureTable.build(sft, {'val': r.integers(0, 9, 500),"
        " 'dtg': 1577836800000 + r.integers(0, 10**9, 500),"
        " 'geom': (r.uniform(-50, 50, 500), r.uniform(-50, 50, 500))}))\n"
        "print(s.count('t', 'BBOX(geom, -10, -10, 10, 10) AND val > 2'))\n"
        "s.query('t', 'val > 2', hints={'stats': 'Count();MinMax(\"val\")'})\n"
        "geomesa_tpu_torch.process.knn(s.planner('t'), 0.0, 0.0, 5)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'geomesa_tpu' or m.startswith('geomesa_tpu.')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 0

