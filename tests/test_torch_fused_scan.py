"""The fused program without host syncs: the block gate, the fused scan
(fp62 boxes, windows, the residual as a postfix program) and the ordered
fixed-capacity compaction (``index/scan.py`` ``block_gate``,
``fused_scan``, ``ordered_compact``; the CUDA kernels in
``kernels/csrc/block_gate.cu``, ``fused_scan.cu``, ``ordered_compact.cu``).

On the CPU, against the JAX package on identical state (the 6,000-row
corpus of the fused-query tests, gather blocks of 512 rows, so 12 blocks,
the last one partial): the gate's block list against the reference's
``_block_summaries`` and gate formula; the raw result of every fused mode
and of the union program's select and density against the reference
program's ``dispatch()``, value for value, where the gate keeps no block,
some blocks (the last partial one among them), and more blocks than the
reference's ``cap`` (its full-table branch); a select whose count passes
its capacity; every residual form of ``compile_residual`` (the lowered
program, the torch closure and the reference's closure give one mask);
residuals that read more columns than the kernel holds, answered by the
staged path; and no host sync inside any dispatch (``scan.host_syncs``
counts the calls that would wait on the card); the look-back workspace's
epochs, growth and wrap, the compaction's unit and the gate's cluster
shape against their kernel sources, and the gate wrapper's checks of its
inputs. Tolerance: none — counts,
rows, raw program results and unit grids compare exactly. The port runs
with device="cpu" (the plain versions).

The ``gpu`` tests hold each kernel to its plain version on the card: block
lists with pads, the clamped last block and no live block, B up to 64
boxes, empty boxes and windows, residual programs, ``__valid__``, the
compaction saturated early, late, at its count and at cap 0, masks with
every or no byte set, masks and planes that are views at offset 1 (the
kernels' byte and scalar paths), lengths and block sizes that are not
multiples of 16 or of 4, and repeated calls on one stream (each takes a
fresh epoch; a saturated call leaves no full word for the next); the gate
at its cluster's edges (one block, fewer than a warp, exactly the
cluster's threads and one more, several load batches a thread, 244,141
blocks, every and no block alive, three branches, no bins) and a block
list whose ballots pass the shared memory, which raises; the store's
programs on the card against the same table's on the CPU; and no host sync
in the fused entry points on the card (CUDA's sync debug mode). They import
nothing of JAX, so on the card ``python -m pytest --noconftest -m gpu
tests/test_torch_fused_scan.py`` runs them.
"""

import importlib
import types

import numpy as np
import pytest
import torch

from geomesa_tpu_torch import config as tconfig
from geomesa_tpu_torch.arith import pow2
from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.filter import ir as tir
from geomesa_tpu_torch.filter.parser import parse_ecql as tparse
from geomesa_tpu_torch.index import compiled as tcompiled
from geomesa_tpu_torch.index import scan as tscan
from geomesa_tpu_torch.index.device import fp62
from geomesa_tpu_torch.index import planner as tplanner
from geomesa_tpu_torch.index.planner import QueryPlanner as TPlanner
from geomesa_tpu_torch.index.spatial import Z3Index as TZ3
from geomesa_tpu_torch.index.spatial import _boxes_fp62 as t_fp62
from geomesa_tpu_torch.kernels import compact as kcompact
from geomesa_tpu_torch.kernels import density as kdensity
from geomesa_tpu_torch.kernels import dist as kdist
from geomesa_tpu_torch.kernels import fused_scan as kscan
from geomesa_tpu_torch.kernels import gate as kgate
from geomesa_tpu_torch.kernels import pip as kpip

SPEC = ("name:String,age:Int,score:Float,flag:Boolean,dtg:Date,*geom:Point;"
        "geomesa.z3.interval=week")
N = 6000
BSZ = 512
BOX = "BBOX(geom,-60,-30,60,30)"
POLY = "POLYGON((-10 20, 40 20, 40 60, -10 60, 15 40, -10 20))"
DURING = "dtg DURING 2020-01-03T00:00:00Z/2020-01-15T00:00:00Z"
GRID = (-60.0, -40.0, 60.0, 40.0)

# where the gate keeps no block (a window past the data), some blocks (the
# last week: its blocks end with the partial last one), and every block
# (more than the reference's cap of 4 of 12: its full-table branch)
GATES = {
    "none": "dtg DURING 2021-03-01T00:00:00Z/2021-03-09T00:00:00Z",
    "some": "dtg DURING 2020-01-27T00:00:00Z/2020-01-31T00:00:00Z",
    "all": "dtg DURING 2019-12-01T00:00:00Z/2020-03-01T00:00:00Z",
}

# the spatial part of each mode's query, and its residual
MODES = {
    "count": f"{BOX} AND age > 10",
    "select": f"{BOX} AND name <> 'gamma'",
    "count_refine": f"INTERSECTS(geom, {POLY})",
    "select_refine": f"INTERSECTS(geom, {POLY}) AND score < 0.8",
    "dist_count": "st_distance(geom, POINT(10 10)) < 25",
    "dist_select": "st_distance(geom, POINT(-20 5)) <= 30 AND age < 70",
    "density": f"{BOX} AND flag = true",
}

# every form compile_residual accepts
RESIDUALS = [
    "age = 40", "age <> 40", "age < 40", "age <= 40", "age > 40",
    "age >= 40", "score = 0.5", "score <> 0.5", "score < 0.25",
    "score <= 0.5", "score > 0.75", "score >= 0.5", "flag = true",
    "flag <> true", "flag = false", "flag < true", "flag >= true",
    "name = 'beta'", "name <> 'beta'", "name = 'zeta'", "name <> 'zeta'",
    "name IN ('alpha', 'gamma')", "name IN ('zeta')",
    "name IN ('alpha', 'beta', 'gamma')", "age IN (1, 5, 40, 77, 99)",
    "age > 10 AND name = 'beta'", "age < 10 OR name = 'beta'",
    "NOT (age > 50)",
    "NOT (age > 50 AND (name = 'beta' OR score < 0.5)) AND flag = false",
    "age > 5 AND age < 90 AND name <> 'delta' AND score > 0.1",
]

UNIONS = {
    gate: f"(BBOX(geom,-60,-30,0,0) AND {w}) OR "
          f"(BBOX(geom,-10,-10,60,30) AND {w} AND age > 30)"
    for gate, w in GATES.items()
}


def _ref(name: str):
    """A module of the JAX package (imported only by the CPU tests)."""
    pytest.importorskip("jax")
    return importlib.import_module(name)


@pytest.fixture(autouse=True)
def _small_blocks(request):
    confs = [tconfig]
    if "world" in request.fixturenames:
        # earlier suites monkeypatch the reference's prune.BLOCK_SIZE; the
        # teardown leaves a real attribute that shadows config.PRUNE_BLOCK
        vars(_ref("geomesa_tpu.index.prune")).pop("BLOCK_SIZE", None)
        confs.append(_ref("geomesa_tpu.config"))
    for c in confs:
        c.PRUNE_BLOCK.set(BSZ)
        c.FUSED_QUERY.set(True)
    yield
    for c in confs:
        c.PRUNE_BLOCK.unset()
        c.FUSED_QUERY.unset()


def _columns(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-170, 170, n)
    y = rng.uniform(-80, 80, n)
    base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
    dtg = base + rng.integers(0, 30 * 86400000, n)
    return {"name": rng.choice(["alpha", "beta", "gamma", "delta"], n),
            "age": rng.integers(0, 100, n).astype(np.int32),
            "score": rng.uniform(0, 1, n).astype(np.float32),
            "flag": rng.random(n) < 0.4,
            "dtg": dtg, "geom": (x, y)}


def _port(cols, dev="cpu"):
    sft = TSFT.from_spec("fs", SPEC)
    table = TTable.build(sft, cols)
    return TPlanner(sft, table, [TZ3(sft, table, dev)])


@pytest.fixture(scope="module")
def world():
    jsft_mod = _ref("geomesa_tpu.features.sft")
    jtable = _ref("geomesa_tpu.features.table")
    jplanner = _ref("geomesa_tpu.index.planner")
    jspatial = _ref("geomesa_tpu.index.spatial")
    jconfig = _ref("geomesa_tpu.config")
    vars(_ref("geomesa_tpu.index.prune")).pop("BLOCK_SIZE", None)
    cols = _columns(N, 7)
    jconfig.PRUNE_BLOCK.set(BSZ)
    tconfig.PRUNE_BLOCK.set(BSZ)
    try:
        jsft = jsft_mod.SimpleFeatureType.from_spec("fs", SPEC)
        jt = jtable.FeatureTable.build(jsft, cols)
        jp = jplanner.QueryPlanner(jsft, jt, [jspatial.Z3Index(jsft, jt)])
        return jp, _port(cols)
    finally:
        jconfig.PRUNE_BLOCK.unset()
        tconfig.PRUNE_BLOCK.unset()


def _query(mode: str, gate: str) -> str:
    return f"{MODES[mode]} AND {GATES[gate]}"


def _reference_mode(mode: str) -> str:
    return {"dist_count": "count_refine",
            "dist_select": "select_refine"}.get(mode, mode)


def _run(prog):
    """A port program's run, with no host sync on the way."""
    with tscan.host_syncs() as h:
        out = prog.run()
    assert h.count == 0
    return out


@pytest.fixture
def dispatch_syncs(monkeypatch):
    """The host syncs of every dispatch that ``_fetch`` reads back, one
    count a dispatch, measured around the dispatch alone (the readback
    after it is the one wait it is allowed)."""
    counts = []
    fetch = tscan._fetch

    def counted(dispatch, *args):
        with tscan.host_syncs() as h:
            out = dispatch(*args)
        counts.append(h.count)
        return fetch(lambda: out)

    for mod in (tscan, tcompiled, tplanner):
        monkeypatch.setattr(mod, "_fetch", counted)
    return counts


# -- the block gate -------------------------------------------------------------


@pytest.mark.parametrize("gate", list(GATES))
@pytest.mark.parametrize("mode", ["count", "select_refine", "dist_count"])
def test_gate_lists_the_reference_alive_blocks(world, gate, mode):
    """The gate's ascending block list, its clamped starts and its count
    against the alive set of the reference's per-block summaries and gate
    formula (``_jit_program``'s ``alive``)."""
    jc = _ref("geomesa_tpu.index.compiled")
    jp, tp = world
    q = _query(mode, gate)
    jplan, tplan = jp.plan(q), tp.plan(q)
    summ = {k: np.asarray(v) for k, v in
            jc._block_summaries(jp.indexes[0], BSZ).items()}
    g = jc._gate_of(jplan.explain["boxes"], len(jplan.boxes_loose))
    alive = ((summ["bxmax"][:, None] >= g[None, :, 0])
             & (summ["bxmin"][:, None] <= g[None, :, 2])
             & (summ["bymax"][:, None] >= g[None, :, 1])
             & (summ["bymin"][:, None] <= g[None, :, 3])).any(axis=1)
    if jplan.windows is not None:
        blo, bhi = jplan.windows[:, 0], jplan.windows[:, 2]
        alive &= ((blo <= bhi)[None, :]
                  & (summ["binmin"][:, None] <= bhi[None, :])
                  & (summ["binmax"][:, None] >= blo[None, :])).any(axis=1)
    want = np.flatnonzero(alive)
    prog = tcompiled.Program(tplan, "count")
    ids, starts, nblk = prog._gate()
    k = int(nblk[0])
    nb = len(alive)
    assert ids.shape == (nb,) and starts.shape == (nb,)
    assert k == len(want)
    assert np.array_equal(ids.numpy()[:k], want)
    assert (ids.numpy()[k:] == -1).all() and (starts.numpy()[k:] == 0).all()
    assert np.array_equal(starts.numpy()[:k],
                          np.clip(want * BSZ, 0, N - BSZ))
    if gate == "none":
        assert k == 0
    elif gate == "all":
        assert k == nb and k > prog_cap(nb)
    else:
        assert 0 < k < nb and want[-1] == nb - 1   # the partial last block


def prog_cap(nb: int) -> int:
    """The reference's pruned-branch capacity at the default fraction."""
    return pow2(max(4, int(np.ceil(nb * 0.25))))


# -- every mode, raw ---------------------------------------------------------------


@pytest.mark.parametrize("gate", list(GATES))
@pytest.mark.parametrize("mode", list(MODES))
def test_program_equals_reference_program(world, gate, mode):
    """The raw result of every fused mode, value for value, against the
    reference program's ``dispatch()``."""
    jc = _ref("geomesa_tpu.index.compiled")
    jp, tp = world
    q = _query(mode, gate)
    rmode = _reference_mode(mode)
    kw = dict(grid=GRID, width=64, height=32) if rmode == "density" else {}
    jprog = jc._from_plan(jp, jp.plan(q), rmode, **kw)
    assert jprog is not None
    want = jprog.dispatch()
    tplan = tp.plan(q)
    refine = tcompiled.refine_spec(tplan) if "refine" in rmode else None
    got = _run(tcompiled.Program(tplan, rmode, sel_cap=jprog.sel_cap,
                                 unc_cap=jprog.unc_cap, refine=refine,
                                 **kw))
    if rmode == "density":
        assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
        assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
        assert int(got[1]) == int(want[1])
        total = int(got[1])
    else:
        want = np.atleast_1d(np.asarray(want))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
        total = int(want[0]) + (int(want[1]) if "refine" in rmode else 0)
    assert (total == 0) == (gate == "none")


@pytest.mark.parametrize("gate", list(GATES))
def test_union_program_equals_reference(world, gate):
    """The union program's select and density, raw, against the
    reference's ``_jit_union_program``."""
    jc = _ref("geomesa_tpu.index.compiled")
    jp, tp = world
    q = UNIONS[gate]
    jprog = jc._build_union(jp, jp.plan(q), "select", None)
    want = np.asarray(jprog.dispatch())
    got = _run(tcompiled.UnionProgram(tp.plan(q), "select",
                                      sel_cap=jprog.sel_cap))
    assert np.array_equal(got.numpy(), want)
    assert (int(want[0]) == 0) == (gate == "none")
    jprog = jc._build_union(jp, jp.plan(q), "density", None, grid=GRID,
                            width=64, height=32)
    jgrid, jcnt = jprog.dispatch()
    grid, cnt = _run(tcompiled.UnionProgram(tp.plan(q), "density",
                                            grid=GRID, width=64, height=32))
    assert int(cnt) == int(jcnt)
    assert np.array_equal(grid.numpy(), np.asarray(jgrid))


def test_select_past_its_capacity(world):
    """count > sel_cap: the true count and the first sel_cap rows, as the
    reference returns them (the caller regrows)."""
    jc = _ref("geomesa_tpu.index.compiled")
    jp, tp = world
    q = f"BBOX(geom,-170,-80,170,80) AND {GATES['all']}"
    jprog = jc._from_plan(jp, jp.plan(q), "select", capacity=1000)
    want = np.asarray(jprog.dispatch())
    assert jprog.sel_cap == 1024 and want[0] > 1024
    got = _run(tcompiled.Program(tp.plan(q), "select", sel_cap=1024))
    assert np.array_equal(got.numpy(), want)
    before = tcompiled.STATS["overflow_retries"]
    rows = tcompiled.try_select(tp, tp.plan(q), 1000)
    assert tcompiled.STATS["overflow_retries"] == before + 1
    assert len(rows) == int(want[0])


def test_entry_points_and_count_async_make_no_sync(world, dispatch_syncs):
    """The try_* entry points and both count_async routes answer as the
    reference does, with no host sync; count_async hands back a device
    tensor and reads nothing back."""
    jc = _ref("geomesa_tpu.index.compiled")
    jp, tp = world
    q = _query("count", "some")
    assert tcompiled.try_count(tp, tp.plan(q)) == jc.try_count(jp, jp.plan(q))
    q = _query("select", "some")
    assert np.array_equal(tcompiled.try_select(tp, tp.plan(q), None),
                          jc.try_select(jp, jp.plan(q), None))
    q = _query("select_refine", "some")
    assert np.array_equal(tcompiled.try_select_refine(tp, tp.plan(q), None),
                          jc.try_select_refine(jp, jp.plan(q), None))
    for q in (f"{BOX} AND {DURING} AND age > 10",
              f"BBOX(geom,0,0,40,40) AND {DURING} AND age > 20"):
        prepared = tp.prepare(q)     # the second shape binds a recipe
        d0 = tscan.ROUNDS.dispatches
        with tscan.host_syncs() as h:
            out = prepared.count_async()
        assert h.count == 0
        assert isinstance(out, torch.Tensor) and out.dim() == 0
        assert tscan.ROUNDS.dispatches == d0
        assert int(out) == jp.count(q)
    assert isinstance(tp.prepare(f"{BOX} AND {DURING} AND age > 20"),
                      tcompiled.FusedPrepared)
    assert dispatch_syncs == [0, 0, 0]


def test_staged_selects_compact_in_order(world, dispatch_syncs):
    """The staged selects (full table and candidate blocks) through
    ``ordered_compact`` against the reference's ScanKernels, a capacity
    that overflows and regrows among them, and the raw packed vector of
    the port's dispatcher against the selected rows."""
    jp, tp = world
    q = f"{BOX} AND {DURING} AND age > 10"
    jplan, tplan = jp.plan(q), tp.plan(q)
    args = (jplan.primary_kind, jplan.boxes_loose, jplan.windows)
    jk, tk = jp.indexes[0].kernels, tp.indexes[0].kernels
    blocks = np.array([0, 3, 5, 11], dtype=np.int32)
    for cap in (16, 1024):
        want = jk.select(*args, jplan.residual_device, cap)
        got = tk.select(*args, tplan.residual_device, cap)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
        with tscan.host_syncs() as h:
            raw = tk.prepare_select(*args, tplan.residual_device, cap)()
        assert h.count == 0
        assert int(raw[0]) == want[1]
        k = min(cap, want[1])
        assert np.array_equal(raw[1: 1 + k].numpy(), want[0][:k])
        assert (raw[1 + k:] == tk.n).all()
        want = jk.select_blocks(*args, jplan.residual_device, blocks, BSZ,
                                cap)
        got = tk.select_blocks(*args, tplan.residual_device, blocks, BSZ,
                               cap)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1] > 0
    assert dispatch_syncs and not any(dispatch_syncs)


# -- the residual program ------------------------------------------------------


@pytest.mark.parametrize("r", RESIDUALS)
def test_residual_program_equals_closure_and_reference(world, r):
    """Every residual form: the lowered program's mask (``eval_program``)
    equals the torch closure's and the reference closure's over the
    device columns, and the fused count and select with it equal the
    reference program's."""
    jc = _ref("geomesa_tpu.index.compiled")
    jscan = _ref("geomesa_tpu.index.scan")
    jparse = _ref("geomesa_tpu.filter.parser").parse_ecql
    jnp = _ref("jax.numpy")
    jp, tp = world
    tidx, jidx = tp.indexes[0], jp.indexes[0]
    cols = tidx.device.columns
    res = tscan.compile_residual(tparse(r), tp.sft, tidx.vocabs, set(cols))
    jkey, jparams, jfn = jscan.compile_residual(jparse(r), jp.sft,
                                                jidx.vocabs,
                                                set(jidx.device.columns))
    assert res.key == jkey and res.program is not None
    want = np.asarray(jfn(jidx.device.columns,
                          [jnp.asarray(p) for p in jparams]))
    closure = res.fn(cols, [torch.from_numpy(np.asarray(p))
                            for p in res.params])
    prog = res.program
    lowered = tscan.eval_program(cols, prog.words,
                                 torch.from_numpy(prog.consts), prog.slots,
                                 tidx.device.n)
    assert np.array_equal(closure.numpy(), want)
    assert np.array_equal(lowered.numpy(), want)
    for mode in ("count", "select"):
        q = f"{BOX} AND {DURING} AND ({r})"
        jprog = jc._from_plan(jp, jp.plan(q), mode)
        got = _run(tcompiled.Program(tp.plan(q), mode,
                                     sel_cap=jprog.sel_cap))
        assert np.array_equal(got.numpy(),
                              np.atleast_1d(np.asarray(jprog.dispatch())))


@pytest.mark.parametrize("node,value", [(tir.Include(), True),
                                        (tir.Exclude(), False)])
def test_include_exclude_lower(world, node, value):
    _, tp = world
    cols = tp.indexes[0].device.columns
    res = tscan.compile_residual(node, tp.sft, {}, set(cols))
    n = tp.indexes[0].device.n
    got = tscan.eval_program(cols, res.program.words,
                             torch.from_numpy(res.program.consts),
                             res.program.slots, n)
    assert torch.equal(got, res.fn(cols, []))
    assert bool(got.all()) == value and bool(got.any()) == value


def test_deep_residual_declines_to_staged(world):
    """A residual nested past the program's stack has no program: the
    fused program declines it and the staged path answers exactly."""
    jp, tp = world
    r = "age > 1"
    for k in range(70):   # right-nested, AND and OR in turn: 71 deep
        r = f"(age <> {k + 200} {'AND' if k % 2 else 'OR'} {r})"
    cols = tp.indexes[0].device.columns
    res = tscan.compile_residual(tparse(r), tp.sft, tp.indexes[0].vocabs,
                                 set(cols))
    assert res.program is None
    q = f"{BOX} AND {DURING} AND {r}"
    assert tp.plan(q).residual_device.program is None
    assert tcompiled._from_plan(tp.plan(q), "count") is None
    assert tp.count(q) == jp.count(q)


# one more residual column than the fused_scan kernel holds
WIDE = kscan.MAX_SLOTS + 1
WIDE_SPEC = (",".join(f"c{k}:Int" for k in range(WIDE))
             + ",dtg:Date,*geom:Point;geomesa.z3.interval=week")


@pytest.fixture(scope="module")
def wide_world():
    """Both packages' planners over one table of WIDE Int columns."""
    jsft_mod = _ref("geomesa_tpu.features.sft")
    jtable = _ref("geomesa_tpu.features.table")
    jplanner = _ref("geomesa_tpu.index.planner")
    jspatial = _ref("geomesa_tpu.index.spatial")
    jconfig = _ref("geomesa_tpu.config")
    vars(_ref("geomesa_tpu.index.prune")).pop("BLOCK_SIZE", None)
    base = _columns(N, 11)
    rng = np.random.default_rng(13)
    cols = {f"c{k}": rng.integers(0, 100, N).astype(np.int32)
            for k in range(WIDE)}
    cols.update(dtg=base["dtg"], geom=base["geom"])
    jconfig.PRUNE_BLOCK.set(BSZ)
    tconfig.PRUNE_BLOCK.set(BSZ)
    try:
        jsft = jsft_mod.SimpleFeatureType.from_spec("wide", WIDE_SPEC)
        jt = jtable.FeatureTable.build(jsft, cols)
        jp = jplanner.QueryPlanner(jsft, jt, [jspatial.Z3Index(jsft, jt)])
        sft = TSFT.from_spec("wide", WIDE_SPEC)
        table = TTable.build(sft, cols)
        return jp, TPlanner(sft, table, [TZ3(sft, table, "cpu")])
    finally:
        jconfig.PRUNE_BLOCK.unset()
        tconfig.PRUNE_BLOCK.unset()


def _wide(ks) -> str:
    return " AND ".join(f"c{k} < 97" for k in ks)


@pytest.mark.parametrize("shape", ["single", "union"])
def test_wide_residual_declines_to_staged(wide_world, shape):
    """Residuals that read more columns than the kernel holds: the fused
    program declines them and the staged path answers as the reference
    does — a plan whose residual reads WIDE columns, and an OR whose two
    branches read WIDE columns between them. At the kernel's limit the
    fused program takes the plan."""
    jp, tp = wide_world
    if shape == "single":
        q = f"{BOX} AND {DURING} AND {_wide(range(WIDE))}"
        at_limit = f"{BOX} AND {DURING} AND {_wide(range(WIDE - 1))}"
        assert tcompiled._from_plan(tp.plan(at_limit), "count") is not None
        assert tp.count(at_limit) == jp.count(at_limit)
        for mode in ("count", "select"):
            assert tcompiled._from_plan(tp.plan(q), mode) is None
        assert tcompiled.try_count(tp, tp.plan(q)) is None
    else:
        half = WIDE // 2
        q = (f"(BBOX(geom,-60,-30,0,0) AND {DURING} AND "
             f"{_wide(range(half))}) OR (BBOX(geom,-10,-10,60,30) AND "
             f"{DURING} AND {_wide(range(half, WIDE))})")
        plan = tp.plan(q)
        assert isinstance(plan, tcompiled.UnionScanPlan)
        for mode in ("select", "density"):
            assert tcompiled._union_from_plan(tp, plan, mode, None) is None
    want = jp.count(q)
    assert want > 0 and tp.count(q) == want
    assert np.array_equal(tp.select_indices(q), jp.select_indices(q))


# -- the plain versions against numpy ------------------------------------------


@pytest.mark.parametrize("cap", [0, 1, 7, 300, 5000])
@pytest.mark.parametrize("blocks", [False, True])
def test_plain_ordered_compact(cap, blocks):
    """The plain compaction against numpy's nonzero, over a table and over
    a block list whose slots past n_blocks hold set bytes it must skip."""
    rng = np.random.default_rng(cap + 3)
    kw = {}
    if blocks:
        starts = np.array([0, 1536, 3000, 4488, 0, 0], dtype=np.int64)
        m = rng.random(len(starts) * BSZ) < 0.3
        rows = (starts[:, None] + np.arange(BSZ)[None, :]).reshape(-1)
        live = m.copy()
        live[4 * BSZ:] = False
        kw = dict(starts=torch.from_numpy(starts), bsz=BSZ,
                  n_blocks=torch.tensor([4], dtype=torch.int32))
    else:
        m = rng.random(4001) < 0.3
        rows = np.arange(len(m))
        live = m
    kept = rows[np.flatnonzero(live)][:cap]
    want = np.full(cap, 99, dtype=np.int32)
    want[: len(kept)] = kept
    count, got = kcompact.ordered_compact(torch.from_numpy(m), cap, 99, **kw)
    assert int(count[0]) == int(live.sum())
    assert np.array_equal(got.numpy(), want)
    out = torch.empty(1 + cap, dtype=torch.int32)
    kcompact.ordered_compact(torch.from_numpy(m), cap, 99, count_out=out[:1],
                             rows_out=out[1:], **kw)
    assert int(out[0]) == int(live.sum())
    assert np.array_equal(out[1:].numpy(), want)


def test_workspace_epochs_wrap_and_forget_tagged_words(monkeypatch):
    """``kernels.lookback``: a stream's workspace is made zeroed and grows
    to the units a call asks (a grown one is new and zeroed, so its epochs
    start again); each call takes the next epoch; when the epoch wraps,
    every epoch-tagged word (``ordered_compact``'s full word, word 3, and
    the status words) is zeroed and the counters (words 0-2, which the
    kernels leave zero) are not touched."""
    from geomesa_tpu_torch.kernels import lookback
    monkeypatch.setattr(lookback, "_WS", {})
    dev = torch.device("cpu")
    ws, units, epoch = lookback.workspace(dev, 7, 10)
    assert units >= 10 and ws.shape == (4 + units,) and epoch == 1
    assert lookback.workspace(dev, 7, 10)[2] == 2
    big, units, epoch = lookback.workspace(dev, 7, 5000)
    assert units >= 5000 and big.shape == (4 + units,) and epoch == 1
    assert big is not ws and not big.any()
    monkeypatch.setattr(lookback, "_EPOCH_MAX", 3)
    big[:] = 5
    assert lookback.workspace(dev, 7, 1)[2] == 2
    assert lookback.workspace(dev, 7, 1)[2] == 3 and bool((big == 5).all())
    again, _, epoch = lookback.workspace(dev, 7, 1)
    assert again is big and epoch == 1
    assert bool((big[:3] == 5).all()) and not big[3:].any()
    assert lookback.workspace(dev, 8, 1)[2] == 1   # another stream


def test_compact_unit_matches_the_kernel_source():
    """The wrapper sizes the look-back's status words by ``compact.UNIT``:
    the kernel's threads x vectors a thread x vector bytes, as
    ``csrc/lookback.cuh`` and ``csrc/ordered_compact.cu`` declare them
    (the card checks ``ordered_compact_unit`` too)."""
    import os
    import re
    csrc = os.path.join(os.path.dirname(kcompact.__file__), "csrc")
    with open(os.path.join(csrc, "lookback.cuh")) as fh:
        threads = int(re.search(r"constexpr int THREADS = (\d+);",
                                fh.read()).group(1))
    with open(os.path.join(csrc, "ordered_compact.cu")) as fh:
        src = fh.read()
    vec, v = (int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
              for k in ("VEC", "V"))
    assert kcompact.UNIT == threads * v * vec


def test_fused_query_packs_every_section():
    """The packed buffer's sections read back as the branches' boxes (as
    keys), gates, windows (as keys and bins), program words and
    constants."""
    boxes = t_fp62([(-10.0, -5.0, 10.0, 5.0), (20.0, 20.0, 30.0, 40.0)])
    gate = np.array([[-10, -5, 10, 5], [20, 20, 30, 40]], dtype=np.float32)
    win = np.array([[2600, 5, 2601, 9], [1, 0, 0, 0]], dtype=np.int32)
    sft = TSFT.from_spec("p", SPEC)
    res = tscan.compile_residual(tparse("age > 3 AND score < 0.5"), sft, {})
    res2 = tscan.compile_residual(tparse("name IN ('a')"), sft,
                                  {"name": ["a", "b"]})
    q = tscan.FusedQuery([(boxes, gate, win, res.program),
                          (boxes[:1], gate[:1], None, res2.program)])
    buf = torch.from_numpy(q.packed)
    assert len(q.packed) % 16 == 0
    assert q.branches == [(0, 2, 0, 2, 0, 3), (2, 1, 2, 0, 3, 1)]
    both = np.concatenate([boxes, boxes[:1]])
    keys = q.section(buf, "box", torch.int64, 4).numpy()
    assert np.array_equal(keys, np.stack([tscan.pack62(
        torch.from_numpy(both[:, 2 * j].copy()),
        torch.from_numpy(both[:, 2 * j + 1].copy())).numpy()
        for j in range(4)], axis=1))
    wkeys = q.section(buf, "wkey", torch.int64, 2).numpy()
    assert wkeys[0, 0] == (2600 << 32) + 5 + (1 << 31)
    assert (wkeys[1, 0] > wkeys[1, 1])    # the empty window holds nothing
    assert np.array_equal(q.section(buf, "gate", torch.float32, 4).numpy(),
                          np.concatenate([gate, gate[:1]]))
    assert np.array_equal(q.section(buf, "wbin", torch.int32, 2).numpy(),
                          win[:, [0, 2]])
    words = q.section(buf, "prog", torch.int32, 4).numpy()
    assert np.array_equal(words, q.words) and len(words) == 4
    assert q.slots == (("age", tscan.SLOT_I32), ("score", tscan.SLOT_F32),
                       ("name", tscan.SLOT_I32))
    assert words[3, 1] == 2 and words[3, 2] == 2   # remapped slot, const
    cn = q.section(buf, "const", torch.int32, 1).numpy().reshape(-1)
    assert cn[0] == 3 and cn[1] == np.float32(0.5).view(np.int32) \
        and cn[2] == 0



@pytest.mark.parametrize("name", ["CLUSTER", "THREADS"])
def test_gate_cluster_shape_matches_the_kernel_source(name):
    """``gate.CLUSTER`` and ``gate.THREADS``, which the card tests size
    their block lists by, are the shape ``csrc/block_gate.cu`` fixes."""
    import os
    import re
    with open(os.path.join(os.path.dirname(kgate.__file__), "csrc",
                           "block_gate.cu")) as fh:
        src = fh.read()
    got = re.search(rf"constexpr int {name} = (\d+);", src)
    assert got is not None and int(got.group(1)) == getattr(kgate, name)


@pytest.mark.parametrize("bad", ["dtype", "shape", "one_bin", "no_blocks",
                                 "bin_dtype", "qbuf_dtype", "qbuf_words",
                                 "block_size"])
def test_gate_checks_summaries_at_their_first_call(bad):
    """The wrapper checks its inputs at every call, the first one too:
    summaries of the wrong type or shape, with one bin plane or with no
    block, a query buffer that is not 16-byte words of uint8, and a block
    size below 1 raise; the good inputs answer as the plain version does
    before and after."""
    summ = _gate_summaries(40, 3, torch.device("cpu"))
    q = _fused_query(4, "some", None, seed=7)
    qbuf = torch.from_numpy(q.packed)
    want = tscan.block_gate(summ, qbuf, q, 40 * 512, 512)
    got = kgate.block_gate(summ, qbuf, q, 40 * 512, 512)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    bad_summ, bad_qbuf, bsz = dict(summ), qbuf, 512
    if bad == "dtype":
        bad_summ["bymax"] = bad_summ["bymax"].double()
    elif bad == "shape":
        bad_summ["binmin"] = bad_summ["binmin"][:-1]
    elif bad == "one_bin":
        del bad_summ["binmax"]
    elif bad == "no_blocks":
        bad_summ = {k: v[:0] for k, v in summ.items()}
    elif bad == "bin_dtype":
        bad_summ["binmax"] = bad_summ["binmax"].long()
    elif bad == "qbuf_dtype":
        bad_qbuf = qbuf.view(torch.int32)
    elif bad == "qbuf_words":
        bad_qbuf = qbuf[:-8]
    else:
        bsz = 0
    with pytest.raises((TypeError, ValueError)):
        kgate.block_gate(bad_summ, bad_qbuf, q, 40 * 512, bsz)
    got = kgate.block_gate(summ, qbuf, q, 40 * 512, 512)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

# -- the CUDA kernels against their plain versions (card only) -----------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the fused-scan kernels)")
    return torch.device("cuda")


def _planes(n: int, seed: int, dev, valid: bool):
    """Device planes of a Z3 point table: fp62 and f32 x/y (with ties on a
    box edge), binned time, residual columns, a sparse __valid__."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-90, 90, n)
    x[: n // 50] = 10.0
    xi, xl = fp62(x, -180.0, 180.0)
    yi, yl = fp62(y, -90.0, 90.0)
    cols = {"xi": xi, "xl": xl, "yi": yi, "yl": yl,
            "xf": x.astype(np.float32), "yf": y.astype(np.float32),
            "bin": np.sort(rng.integers(2600, 2606, n)).astype(np.int32),
            "off": rng.integers(0, 604800, n).astype(np.int32),
            "age": rng.integers(0, 100, n).astype(np.int32),
            "score": rng.uniform(0, 1, n).astype(np.float32),
            "flag": rng.random(n) < 0.4,
            "name": rng.integers(0, 4, n).astype(np.int32)}
    if valid:
        cols["__valid__"] = rng.random(n) < 0.9
    return {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}


def _geo_boxes(k: int, seed: int):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-180, 170, k)
    y0 = rng.uniform(-90, 80, k)
    w = rng.uniform(0, 60, k)
    h = rng.uniform(0, 40, k)
    return [(float(a), float(b), float(min(180, a + c)), float(min(90, b + d)))
            for a, b, c, d in zip(x0, y0, w, h)]


def _fused_query(nbox: int, windows: str, resid, seed: int,
                 branches: int = 1, boxless_all: bool = False):
    """A packed query of ``branches`` branches of ``nbox`` random boxes
    each; ``nbox`` 0: the first branch has no boxes (a staged scan without
    a primary), the others one box (none either with ``boxless_all``)."""
    sft = TSFT.from_spec("g", SPEC)
    vocab = {"name": ["alpha", "beta", "gamma", "delta"]}
    out = []
    for k in range(branches):
        geo = _geo_boxes(max(1, nbox), seed + k)
        boxes = tscan.pad_boxes(t_fp62(geo))
        if windows == "empty_boxes":
            boxes[:] = tscan.EMPTY_BOX
        gate = tcompiled._gate_of(geo, len(boxes))
        if nbox == 0 and (k == 0 or boxless_all):
            boxes = gate = None
        w = None
        if windows == "some":
            w = np.array([[2601, 1000, 2603, 500], [2605, 7, 2605, 90000],
                          [1, 0, 0, 0], [1, 0, 0, 0]], dtype=np.int32)
        elif windows == "empty":
            w = np.tile(tscan.EMPTY_WINDOW, (2, 1))
        prog = None
        if resid:
            prog = tscan.compile_residual(tparse(resid), sft, vocab).program
        out.append((boxes, gate, w, prog))
    return tscan.FusedQuery(out)


def _block_list(case: str, nb: int):
    if case == "all":
        return np.arange(nb, dtype=np.int32), nb
    if case == "edge":   # the clamped last block, pads
        ids = np.array([0, 3, nb - 2, nb - 1], dtype=np.int32)
    elif case == "none":
        ids = np.empty(0, dtype=np.int32)
    else:
        ids = np.arange(0, nb, 3, dtype=np.int32)
    full = np.full(nb, -1, dtype=np.int32)
    full[: len(ids)] = ids
    return full, len(ids)


GPU_CASES = [(n, bsz, nbox, windows, resid, valid, blocks)
             for n, bsz in ((100_003, 4096), (20_011, 512))
             for nbox in (0, 1, 4, 64)
             for windows, resid, valid in (
                 ("none", None, False), ("some", "age > 10", False),
                 ("some", "NOT (age > 50 AND (name = 'beta' OR "
                          "score < 0.5)) AND flag = false", True),
                 ("empty", None, False), ("empty_boxes", None, False))
             for blocks in ("all", "edge", "sparse", "none")
             if not (nbox == 0 and windows == "empty_boxes")]


def _gpu_case(n, bsz, nbox, windows, resid, valid, blocks, branches=1):
    dev = _cuda()
    cols = _planes(n, nbox + bsz, dev, valid)
    q = _fused_query(nbox, windows, resid, seed=nbox, branches=branches)
    nb = -(-n // bsz)
    ids, k = _block_list(blocks, nb)
    ids = torch.from_numpy(ids).to(dev)
    nblk = torch.tensor([k], dtype=torch.int32, device=dev)
    qbuf = torch.from_numpy(q.packed).to(dev)
    return cols, q, qbuf, ids, nblk


@pytest.mark.gpu
@pytest.mark.parametrize("n,bsz,nbox,windows,resid,valid,blocks", GPU_CASES)
def test_cuda_fused_scan_equals_plain(n, bsz, nbox, windows, resid, valid,
                                      blocks):
    cols, q, qbuf, ids, nblk = _gpu_case(n, bsz, nbox, windows, resid,
                                         valid, blocks)
    k = int(nblk[0])
    for mode in ("count", "mask"):
        before = kscan.fused_scan.launches
        got = kscan.fused_scan(cols, qbuf, q, ids, nblk, bsz, mode)
        want = tscan.fused_scan(cols, qbuf, q, ids, nblk, bsz, mode)
        torch.cuda.synchronize()
        assert kscan.fused_scan.launches == before + 1
        if mode == "mask":
            live = k * bsz
            assert torch.equal(got[1], want[1])
            assert torch.equal(got[0][:live], want[0][:live])
        else:
            assert torch.equal(got, want), mode
    if windows in ("empty", "empty_boxes"):
        assert int(want[1]) == 0
    # select: the mask compacted in order (the program's select)
    starts = tscan.expand_blocks(cols, ids, bsz, n)[2]
    for cap in (0, 1, 5000):
        kw = dict(starts=starts, bsz=bsz, n_blocks=nblk)
        c, r = kcompact.ordered_compact(got[0], cap, n, **kw)
        cw, rw = tscan.ordered_compact(want[0], cap, n, **kw)
        assert torch.equal(c, cw) and torch.equal(r, rw), cap


@pytest.mark.gpu
@pytest.mark.parametrize("nbox", [0, 4], ids=["boxless_first", "boxes"])
@pytest.mark.parametrize("branches", [2, 5])
@pytest.mark.parametrize("blocks", ["all", "edge"])
def test_cuda_union_scan_equals_plain(branches, blocks, nbox):
    cols, q, qbuf, ids, nblk = _gpu_case(100_003, 4096, nbox, "some",
                                         "age > 30", False, blocks,
                                         branches=branches)
    live = int(nblk[0]) * 4096
    got = kscan.fused_scan(cols, qbuf, q, ids, nblk, 4096, "count")
    want = tscan.fused_scan(cols, qbuf, q, ids, nblk, 4096, "count")
    assert torch.equal(got, want)
    got = kscan.fused_scan(cols, qbuf, q, ids, nblk, 4096, "mask")
    want = tscan.fused_scan(cols, qbuf, q, ids, nblk, 4096, "mask")
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0][:live], want[0][:live])


def _summaries(cols, bsz):
    index = types.SimpleNamespace(device=types.SimpleNamespace(columns=cols))
    return tcompiled.block_summaries(index, bsz)


@pytest.mark.gpu
@pytest.mark.parametrize("n,bsz", [(100_003, 4096), (20_011, 512),
                                   (3_000_017, 64)])
@pytest.mark.parametrize("nbox,windows,branches", [
    (1, "none", 1), (4, "some", 1), (64, "some", 1), (4, "empty", 1),
    (4, "some", 3)])
def test_cuda_block_gate_equals_plain(n, bsz, nbox, windows, branches):
    dev = _cuda()
    cols = _planes(n, bsz, dev, False)
    summ = _summaries(cols, bsz)
    q = _fused_query(nbox, windows, None, seed=nbox, branches=branches)
    qbuf = torch.from_numpy(q.packed).to(dev)
    before = kgate.block_gate.launches
    got = kgate.block_gate(summ, qbuf, q, n, bsz)
    want = tscan.block_gate(summ, qbuf, q, n, bsz)
    torch.cuda.synchronize()
    assert kgate.block_gate.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if windows == "empty":
        assert int(got[2][0]) == 0


def _gate_summaries(nb: int, seed: int, dev, fill: str = "some",
                    bins: bool = True) -> dict:
    """Block summaries made from a seed: small random envelopes over the
    world and bin ranges about ``_fused_query``'s windows (``fill``
    "some"), every block over the whole world and every bin ("all"), or
    every block far from any box ("none"); without bins for a table that
    has none."""
    rng = np.random.default_rng(seed)
    cx, cy = rng.uniform(-180, 180, nb), rng.uniform(-90, 90, nb)
    w, h = rng.uniform(0, 8, nb), rng.uniform(0, 6, nb)
    env = [cx - w, cx + w, cy - h, cy + h]
    b0 = rng.integers(2598, 2608, nb)
    b1 = b0 + rng.integers(0, 3, nb)
    if fill == "all":
        env = [np.full(nb, v) for v in (-181.0, 181.0, -91.0, 91.0)]
        b0, b1 = np.zeros(nb), np.full(nb, 1 << 30)
    elif fill == "none":
        env = [np.full(nb, v) for v in (1000.0, 1001.0, 1000.0, 1001.0)]
    summ = {k: torch.from_numpy(v.astype(np.float32)).to(dev)
            for k, v in zip(("bxmin", "bxmax", "bymin", "bymax"), env)}
    if bins:
        summ["binmin"] = torch.from_numpy(b0.astype(np.int32)).to(dev)
        summ["binmax"] = torch.from_numpy(b1.astype(np.int32)).to(dev)
    return summ


# name -> (blocks: an int, or a multiple of the cluster's threads plus an
# offset, fill, bins, boxes, windows, branches)
GATE_EDGES = {
    "one_block": (1, "all", True, 4, "some", 1),
    "one_block_none_alive": (1, "none", True, 4, "some", 1),
    "below_a_warp": (20, "some", True, 64, "some", 1),
    "cluster_threads": ((1, 0), "some", True, 4, "some", 1),
    "cluster_threads_plus_one": ((1, 1), "some", True, 4, "some", 1),
    "several_a_thread": ((9, 7), "some", True, 4, "some", 1),
    "table_of_1b_rows": (244_141, "some", True, 4, "some", 1),
    "all_alive": (24_415, "all", True, 4, "some", 1),
    "none_alive": (24_415, "none", True, 4, "some", 1),
    "three_branches_windows": (24_415, "some", True, 4, "some", 3),
    "three_branches_no_windows": (24_415, "some", True, 4, "none", 3),
    "no_bins": (24_415, "some", False, 4, "some", 1),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GATE_EDGES))
def test_cuda_block_gate_layout_edges(case):
    """The cluster's edges: one block, fewer than a warp, exactly the
    cluster's threads and one more, several blocks a thread (two load
    batches), the 244,141 blocks of a billion-row table, every and no
    block alive, three branches with and without windows, a table without
    bins; each one launch, equal to the plain version on all three
    outputs (the pad too)."""
    dev = _cuda()
    blocks, fill, bins, nbox, windows, branches = GATE_EDGES[case]
    if isinstance(blocks, tuple):
        blocks = blocks[0] * kgate.CLUSTER * kgate.THREADS + blocks[1]
    bsz = 4096
    n = blocks * bsz - 123   # a ragged last block: its start clamps
    summ = _gate_summaries(blocks, blocks, dev, fill, bins)
    q = _fused_query(nbox, windows, None, seed=7, branches=branches)
    qbuf = torch.from_numpy(q.packed).to(dev)
    before = kgate.block_gate.launches
    got = kgate.block_gate(summ, qbuf, q, n, bsz)
    want = tscan.block_gate(summ, qbuf, q, n, bsz)
    torch.cuda.synchronize()
    assert kgate.block_gate.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    k = int(want[2][0])
    if fill == "all":
        assert k == blocks
    elif fill == "none":
        assert k == 0
    elif blocks > 1000:
        assert 0 < k < blocks


@pytest.mark.gpu
def test_cuda_block_gate_raises_when_the_cluster_does_not_fit():
    """A block list whose ballots pass the CTA's shared memory has no
    cluster that fits: the call raises and launches nothing."""
    dev = _cuda()
    warps = kgate.THREADS // 32
    items = 232_448 // (4 * warps) + 1
    nb = kgate.CLUSTER * kgate.THREADS * items
    summ = {k: torch.zeros(nb, dtype=torch.float32, device=dev)
            for k in ("bxmin", "bxmax", "bymin", "bymax")}
    q = _fused_query(1, "none", None, seed=1)
    qbuf = torch.from_numpy(q.packed).to(dev)
    before = kgate.block_gate.launches
    with pytest.raises(RuntimeError, match="no cluster"):
        kgate.block_gate(summ, qbuf, q, nb * 4096, 4096)
    assert kgate.block_gate.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [0, 1, 1000, 1 << 16, 1 << 21])
@pytest.mark.parametrize("where", ["table", "blocks", "none"])
def test_cuda_ordered_compact_equals_plain(cap, where):
    dev = _cuda()
    rng = np.random.default_rng(cap)
    n = 3_000_017
    kw = {}
    if where == "table":
        m = rng.random(n) < 0.3
    else:
        nb, bsz = 1000, 4096
        starts = np.clip(rng.permutation(nb)[:nb] * bsz, 0, n - bsz)
        m = rng.random(nb * bsz) < 0.05
        kw = dict(starts=torch.from_numpy(starts.astype(np.int64)).to(dev),
                  bsz=bsz, n_blocks=torch.tensor(
                      [0 if where == "none" else 700], dtype=torch.int32,
                      device=dev))
    mask = torch.from_numpy(m).to(dev)
    before = kcompact.ordered_compact.launches
    got = kcompact.ordered_compact(mask, cap, -7, **kw)
    want = tscan.ordered_compact(mask, cap, -7, **kw)
    torch.cuda.synchronize()
    assert kcompact.ordered_compact.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _compact_space(where: str, dev, fill: str, size: int, bsz=None,
                   offset: int = 0, rate: float = 0.3, seed: int = 0):
    """A mask of ``size`` table rows, or of ``size`` blocks of ``bsz``
    candidates through clamped starts of which the first 5/6 are live;
    ``offset`` bytes into its storage (1: not 16-byte aligned). Returns
    (mask, keywords, the live set candidates)."""
    rng = np.random.default_rng(seed)
    ncand = size if where == "table" else size * bsz
    if fill == "all":
        m = np.ones(ncand + offset, dtype=bool)
    elif fill == "none":
        m = np.zeros(ncand + offset, dtype=bool)
    else:
        m = rng.random(ncand + offset) < rate
    mask = torch.from_numpy(m).to(dev)[offset:]
    if where == "table":
        return mask, {}, int(m[offset:].sum())
    n = size * bsz + 3 * bsz + 7
    starts = np.clip(rng.permutation(size + 3)[:size].astype(np.int64) * bsz,
                     0, n - bsz)
    k = size - size // 6
    kw = dict(starts=torch.from_numpy(starts).to(dev), bsz=bsz,
              n_blocks=torch.tensor([k], dtype=torch.int32, device=dev))
    return mask, kw, int(m[offset:offset + k * bsz].sum())


def _compact_equals_plain(mask, cap, kw, views: bool = False):
    """ordered_compact on the card against its plain version, once into
    fresh tensors and, with ``views``, once into views of one vector (the
    rows 4 bytes past a 16-byte boundary, as a program's result)."""
    before = kcompact.ordered_compact.launches
    got = kcompact.ordered_compact(mask, cap, -7, **kw)
    want = tscan.ordered_compact(mask, cap, -7, **kw)
    outs = [got]
    if views:
        out = torch.full((1 + cap,), 99, dtype=torch.int32,
                         device=mask.device)
        kcompact.ordered_compact(mask, cap, -7, count_out=out[:1],
                                 rows_out=out[1:], **kw)
        outs.append((out[:1], out[1:]))
    torch.cuda.synchronize()
    assert kcompact.ordered_compact.launches == before + len(outs)
    for c, r in outs:
        assert torch.equal(c, want[0]) and torch.equal(r, want[1]), cap


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["table", "blocks"])
@pytest.mark.parametrize("cap", ["zero", "one", "below", "at", "above"])
def test_cuda_ordered_compact_saturates(where, cap):
    """A dense mask (60% set) saturated early (cap 1), late (one below
    the count), exactly at the count, not at all (one above) and at cap
    0: the units past the cap only count, and the count stays every set
    candidate."""
    dev = _cuda()
    mask, kw, count = _compact_space(where, dev, "rate",
                                     3_000_017 if where == "table" else 700,
                                     4096, rate=0.6, seed=31)
    c = {"zero": 0, "one": 1, "below": count - 1, "at": count,
         "above": count + 1}[cap]
    _compact_equals_plain(mask, c, kw)


@pytest.mark.gpu
@pytest.mark.parametrize("fill", ["all", "none"])
@pytest.mark.parametrize("where", ["table", "blocks"])
@pytest.mark.parametrize("cap", [0, 1000, 1 << 21])
def test_cuda_ordered_compact_all_and_none_set(fill, where, cap):
    dev = _cuda()
    mask, kw, _ = _compact_space(where, dev, fill,
                                 3_000_017 if where == "table" else 700,
                                 4096, seed=cap)
    _compact_equals_plain(mask, cap, kw)


ODD_SPACES = [("table", 1_000_003, None), ("table", 16_385, None),
              ("table", 17, None), ("table", 0, None),
              ("blocks", 300, 1000), ("blocks", 300, 4099),
              ("blocks", 2000, 24), ("blocks", 40, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("where,size,bsz", ODD_SPACES)
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("cap", [5, 1 << 16])
def test_cuda_ordered_compact_views_and_odd_sizes(where, size, bsz, offset,
                                                  cap):
    """A mask that is a view at byte offset 1 (the kernel's byte path),
    lengths and block sizes that are not multiples of 16 (a unit spans
    blocks; ragged tails), no candidates, and the rows written into a
    view 4 bytes past a 16-byte boundary (the fill's head and tail)."""
    dev = _cuda()
    mask, kw, _ = _compact_space(where, dev, "rate", size, bsz,
                                 offset=offset, seed=size + offset)
    _compact_equals_plain(mask, cap, kw, views=True)


@pytest.mark.gpu
@pytest.mark.parametrize("n,bsz", [(100_003, 4096), (50_000, 4096),
                                   (20_011, 1000), (20_011, 514),
                                   (20_011, 1001)])
@pytest.mark.parametrize("view", [False, True])
@pytest.mark.parametrize("valid", [False, True])
def test_cuda_fused_scan_views_and_odd_blocks(n, bsz, view, valid):
    """Planes (and __valid__) that are views at element offset 1 (every
    quad on the scalar path), a clamped last block that is 16-byte
    aligned (n = 50,000) or not, block sizes that are not multiples of 16
    or of 4 (quads across blocks): count, mask and the mask's compaction
    against the plain versions."""
    dev = _cuda()
    cols = _planes(n + 1, bsz, dev, valid)
    cols = {k: (v[1:] if view else v[:n]) for k, v in cols.items()}
    q = _fused_query(4, "some", "age > 10", seed=4)
    qbuf = torch.from_numpy(q.packed).to(dev)
    nb = -(-n // bsz)
    for blocks in ("all", "edge", "sparse"):
        ids, k = _block_list(blocks, nb)
        ids = torch.from_numpy(ids).to(dev)
        nblk = torch.tensor([k], dtype=torch.int32, device=dev)
        got = kscan.fused_scan(cols, qbuf, q, ids, nblk, bsz, "count")
        want = tscan.fused_scan(cols, qbuf, q, ids, nblk, bsz, "count")
        assert torch.equal(got, want), blocks
        got = kscan.fused_scan(cols, qbuf, q, ids, nblk, bsz, "mask")
        want = tscan.fused_scan(cols, qbuf, q, ids, nblk, bsz, "mask")
        assert torch.equal(got[1], want[1]), blocks
        assert torch.equal(got[0][:k * bsz], want[0][:k * bsz]), blocks
        starts = tscan.expand_blocks(cols, ids, bsz, n)[2]
        _compact_equals_plain(got[0], 300, dict(starts=starts, bsz=bsz,
                                                n_blocks=nblk))


@pytest.mark.gpu
@pytest.mark.parametrize("resid", [
    "score < 0.5", "flag = false AND age > 10",
    "name IN ('beta', 'delta') OR score >= 0.25",
    "NOT (age > 50 AND (name = 'beta' OR score < 0.5)) AND flag = false"])
@pytest.mark.parametrize("windows", ["none", "some"])
@pytest.mark.parametrize("shape", ["aligned", "view", "column_views",
                                   "one_block"])
@pytest.mark.parametrize("branches", [1, 3])
def test_cuda_boxless_scan_reads_residual_slots_in_quads(resid, windows,
                                                         shape, branches):
    """A query of boxless branches tests a quad at a time, its residual's
    columns (f32, bool and int32 slots, two of them in the quads' vector
    loads) read for the four lanes: count, mask and its compaction against
    the plain versions, with planes that are aligned, views at element
    offset 1 (the scalar path), aligned planes with residual columns that
    are views (each column's lanes loaded one at a time), and a table of
    one block of n rows (the staged scan of a table under one block); one
    branch, and three ORed."""
    dev = _cuda()
    n, bsz = {"aligned": (100_003, 4096), "view": (20_011, 512),
              "column_views": (20_011, 512),
              "one_block": (3_000, 3_000)}[shape]
    cols = _planes(n + 1, 7, dev, True)
    shifted = {"view": set(cols),
               "column_views": {"age", "score", "flag", "name"}}.get(
                   shape, set())
    cols = {k: (v[1:] if k in shifted else v[:n]) for k, v in cols.items()}
    q = _fused_query(0, windows, resid, seed=3, branches=branches,
                     boxless_all=True)
    assert not q.points
    qbuf = torch.from_numpy(q.packed).to(dev)
    nb = -(-n // bsz)
    for blocks in ("all", "edge", "sparse") if nb >= 4 else ("all",):
        ids, k = _block_list(blocks, nb)
        ids = torch.from_numpy(ids).to(dev)
        nblk = torch.tensor([k], dtype=torch.int32, device=dev)
        got = kscan.fused_scan(cols, qbuf, q, ids, nblk, bsz, "count")
        want = tscan.fused_scan(cols, qbuf, q, ids, nblk, bsz, "count")
        assert torch.equal(got, want), blocks
        got = kscan.fused_scan(cols, qbuf, q, ids, nblk, bsz, "mask")
        want = tscan.fused_scan(cols, qbuf, q, ids, nblk, bsz, "mask")
        assert torch.equal(got[1], want[1]), blocks
        assert torch.equal(got[0][:k * bsz], want[0][:k * bsz]), blocks
        starts = tscan.expand_blocks(cols, ids, bsz, n)[2]
        _compact_equals_plain(got[0], 300, dict(starts=starts, bsz=bsz,
                                                n_blocks=nblk))


@pytest.mark.gpu
def test_cuda_repeated_calls_take_fresh_epochs():
    """Back-to-back calls on one stream, growing and shrinking the work
    and the caps, share the stream's workspace; each agrees with the plain
    version (a stale status word would read as a published prefix)."""
    dev = _cuda()
    n = 300_007
    cols = _planes(n, 11, dev, False)
    q = _fused_query(8, "some", "age > 20", seed=3)
    qbuf = torch.from_numpy(q.packed).to(dev)
    nb = -(-n // 512)
    rng = np.random.default_rng(5)
    outs = []
    for it in range(24):
        k = int(rng.integers(0, nb + 1))
        ids = np.full(nb, -1, dtype=np.int32)
        ids[:k] = np.sort(rng.choice(nb, k, replace=False))
        ids = torch.from_numpy(ids).to(dev)
        nblk = torch.tensor([k], dtype=torch.int32, device=dev)
        cap = int(rng.choice([0, 10, 5000, 1 << 18]))
        got = kscan.fused_scan(cols, qbuf, q, ids, nblk, 512, "count")
        m = torch.from_numpy(rng.random(n) < 0.2).to(dev)
        c = kcompact.ordered_compact(m, cap, n)
        outs.append((got, tscan.fused_scan(cols, qbuf, q, ids, nblk, 512,
                                           "count"),
                     c, tscan.ordered_compact(m, cap, n)))
    torch.cuda.synchronize()
    for got, want, c, cw in outs:
        assert torch.equal(got, want)
        assert torch.equal(c[0], cw[0]) and torch.equal(c[1], cw[1])
    # a saturated call (its first unit raises the full word) followed by
    # calls that do not saturate: a stale full word would skip their units
    m = torch.from_numpy(rng.random(n) < 0.5).to(dev)
    pairs = [(cap, kcompact.ordered_compact(m, cap, n))
             for cap in (1, 1 << 18, 3, n, 0, n)]
    torch.cuda.synchronize()
    for cap, (c, r) in pairs:
        cw, rw = tscan.ordered_compact(m, cap, n)
        assert torch.equal(c, cw) and torch.equal(r, rw), cap


@pytest.mark.gpu
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("gate", list(GATES))
def test_cuda_program_equals_cpu(mode, gate):
    """The store's fused programs on the card (block_gate, fused_scan, the
    refine or density kernel, ordered_compact) against the same table's on
    the CPU, raw; the union program too."""
    dev = _cuda()
    cols = _columns(N, 7)
    cpu, gpu = _port(cols), _port(cols, "cuda")
    rmode = _reference_mode(mode)
    kw = dict(grid=GRID, width=64, height=32) if rmode == "density" else {}
    q = _query(mode, gate)
    progs = []
    for p in (cpu, gpu):
        plan = p.plan(q)
        refine = tcompiled.refine_spec(plan) if "refine" in rmode else None
        progs.append(tcompiled.Program(plan, rmode, sel_cap=1024,
                                       unc_cap=64, refine=refine, **kw))
    counts = (kgate.block_gate.launches, kscan.fused_scan.launches)
    want, got = progs[0].run(), progs[1].run()
    torch.cuda.synchronize()
    assert kgate.block_gate.launches == counts[0] + 1
    assert kscan.fused_scan.launches == counts[1] + 1
    if rmode == "density":
        assert torch.equal(got[0].cpu(), want[0])
        assert int(got[1]) == int(want[1])
    else:
        assert torch.equal(got.cpu(), want)
    u = [tcompiled.UnionProgram(p.plan(UNIONS[gate]), "select",
                                sel_cap=1024) for p in (cpu, gpu)]
    assert torch.equal(u[1].run().cpu(), u[0].run())


@pytest.mark.gpu
def test_cuda_fused_dispatches_make_no_sync():
    """On the card, CUDA's sync debug mode (``scan.host_syncs``) sees no
    wait inside the fused programs' runs — every mode and the union
    program's select and density — nor in 16 ``count_async`` calls, nor in
    ``try_count``/``try_select``, whose one wait is their pinned
    readback's event. Each is run once first (kernel builds, block
    summaries)."""
    _cuda()
    gpu = _port(_columns(N, 7), "cuda")
    runs = []
    with tscan.host_syncs("cuda") as h:    # the check sees syncs: a
        torch.zeros(1, device="cuda").item()   # value read back, and a
        torch.zeros(4).to("cuda")              # pageable upload
    assert h.count == 2
    for mode in MODES:
        rmode = _reference_mode(mode)
        kw = dict(grid=GRID, width=64, height=32) if rmode == "density" \
            else {}
        plan = gpu.plan(_query(mode, "some"))
        refine = tcompiled.refine_spec(plan) if "refine" in rmode else None
        runs.append(tcompiled.Program(plan, rmode, sel_cap=1024, unc_cap=64,
                                      refine=refine, **kw).run)
    uplan = gpu.plan(UNIONS["some"])
    for mode, kw in (("select", dict(sel_cap=1024)),
                     ("density", dict(grid=GRID, width=64, height=32))):
        runs.append(tcompiled.UnionProgram(uplan, mode, **kw).run)
    # both count_async routes: the first shape's PreparedQuery over the
    # fused program, then the recipe's FusedPrepared
    first = gpu.prepare(f"{BOX} AND {DURING} AND age > 10")
    recipe = gpu.prepare(f"BBOX(geom,0,0,40,40) AND {DURING} AND age > 20")
    assert first._fused is not None
    assert isinstance(recipe, tcompiled.FusedPrepared)
    for prepared in (first, recipe):
        runs.append(lambda p=prepared: [p.count_async() for _ in range(16)])
    plan_c, plan_s = gpu.plan(_query("count", "some")), \
        gpu.plan(_query("select", "some"))
    runs.append(lambda: tcompiled.try_count(gpu, plan_c))
    runs.append(lambda: tcompiled.try_select(gpu, plan_s, None))
    for run in runs:
        run()
        torch.cuda.synchronize()
        with tscan.host_syncs("cuda") as h:
            run()
        torch.cuda.synchronize()
        assert h.count == 0, run


@pytest.mark.gpu
def test_cuda_refine_kernels_stop_at_the_live_blocks():
    """pip_refine, dist_refine and grid_scatter with the gate's device
    count read only the live blocks' candidates: their live flags, counts
    and grids equal the plain versions'."""
    dev = _cuda()
    n, bsz = 100_003, 4096
    cols = _planes(n, 1, dev, False)
    nb = -(-n // bsz)
    ids, k = _block_list("sparse", nb)
    starts = torch.from_numpy(np.clip(ids.astype(np.int64) * bsz, 0,
                                      n - bsz)).to(dev)
    starts[k:] = 0
    nblk = torch.tensor([k], dtype=torch.int32, device=dev)
    mask = torch.from_numpy(np.random.default_rng(2).random(nb * bsz)
                            < 0.5).to(dev)
    live = k * bsz
    edges = torch.tensor([[-50, -50, 50, -50], [50, -50, 0, 60],
                          [0, 60, -50, -50], [1e9, 1e9, 2e9, 1e9]],
                         dtype=torch.float32, device=dev)
    kw = dict(mask=mask, starts=starts, bsz=bsz, n_blocks=nblk)
    got = kpip.pip_refine(cols["xf"], cols["yf"], edges, n_edges=3, **kw)
    want = tscan.pip_refine(cols["xf"], cols["yf"], edges, n_edges=3, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a[:live], b[:live])
    bounds = tscan.dist_bounds([10.0, 10.0, 40.0])
    got = kdist.dist_refine(cols["xf"], cols["yf"], bounds, **kw)
    want = tscan.dist_refine(cols["xf"], cols["yf"], bounds, **kw)
    assert torch.equal(got[2], want[2])
    assert torch.equal(got[0][:live], want[0][:live])
    grid = torch.tensor(GRID, dtype=torch.float32, device=dev)
    got = kdensity.grid_scatter(cols["xf"], cols["yf"], mask, None, starts,
                                bsz, grid, 64, 32, n_blocks=nblk)
    want = tscan.grid_scatter(cols["xf"], cols["yf"], mask, None, starts,
                              bsz, grid, 64, 32, n_blocks=nblk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# the staged modes' stages on the kernel route: a box with windows and a
# residual, windows and a residual without a box (the whole box), nothing
# but a residual, and INCLUDE
STAGED_QUERIES = [f"{BOX} AND {DURING} AND age > 10 AND flag = true",
                  f"{DURING} AND score >= 0.25 AND name <> 'beta'",
                  "age IN (3, 5, 7, 11)", "INCLUDE"]


@pytest.mark.gpu
@pytest.mark.parametrize("q", STAGED_QUERIES)
def test_cuda_staged_modes_equal_cpu(q):
    """Every staged mode on the card's kernel route (fused_scan, then
    ordered_compact or grid_scatter) against the same table's on the CPU,
    raw: counts, row masks, packed selects, grids and their counts, over
    the table's blocks and over a cover with the clamped last block and
    pads; and the OR of two stages. Each mode launches fused_scan."""
    _cuda()
    cols = _columns(N, 7)
    cpu, gpu = _port(cols), _port(cols, "cuda")
    kc, kg = cpu.indexes[0].kernels, gpu.indexes[0].kernels
    a = [(p.primary_kind, p.boxes_loose, p.windows, p.residual_device)
         for p in (cpu.plan(q), gpu.plan(q))]
    assert tscan.staged_query(kg.cols, [a[1]]) is not None
    blocks = np.array([0, 2, 3, 11], dtype=np.int32)   # 11: the last block
    runs = [
        lambda k, s: k.prepare_mask(*s)(),
        lambda k, s: k.prepare_select(*s, 1024)(),
        lambda k, s: k.prepare_select_blocks(*s, blocks, BSZ, 1024)(),
        lambda k, s: k.prepare_density_compact(*s, GRID, 64, 32, 1 << 17,
                                               None)(),
        lambda k, s: k.prepare_density_blocks(*s, GRID, 64, 32, blocks, BSZ,
                                              "age")(),
        lambda k, s: k.prepare_union_count(
            [s, k is kg and a[1] or a[0]])(),
    ]
    if a[0][3] is not None:
        runs += [lambda k, s: k.prepare_count(*s)(),
                 lambda k, s: k.prepare_count_blocks(*s, blocks, BSZ)()]
    for run in runs:
        before = kscan.fused_scan.launches
        want, got = run(kc, a[0]), run(kg, a[1])
        torch.cuda.synchronize()
        assert kscan.fused_scan.launches == before + 1
        for w, g in zip(want if isinstance(want, tuple) else (want,),
                        got if isinstance(got, tuple) else (got,)):
            assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_cuda_staged_dispatches_make_no_sync():
    """The staged modes' prepared dispatchers on the card make no host
    sync (CUDA's sync debug mode): the row mask, the count, the OR count,
    the selects and the densities."""
    _cuda()
    gpu = _port(_columns(N, 7), "cuda")
    k = gpu.indexes[0].kernels
    s = [(p.primary_kind, p.boxes_loose, p.windows, p.residual_device)
         for p in (gpu.plan(q) for q in STAGED_QUERIES[:2])]
    blocks = np.array([1, 4, 11], dtype=np.int32)
    runs = [k.prepare_mask(*s[0]), k.prepare_count(*s[1]),
            k.prepare_union_count(s), k.prepare_select(*s[1], 1024),
            k.prepare_select_blocks(*s[0], blocks, BSZ, 1024),
            k.prepare_density_compact(*s[1], GRID, 64, 32, 1 << 17, None),
            k.prepare_density_blocks(*s[0], GRID, 64, 32, blocks, BSZ,
                                     "score")]
    for run in runs:
        run()
        torch.cuda.synchronize()
        with tscan.host_syncs("cuda") as h:
            run()
        torch.cuda.synchronize()
        assert h.count == 0, run


# -- the visibility section (the VIS form) ------------------------------------

# allowed visibility codes over a vocabulary of V codes: one code, every
# code, none, codes past the first bitmap word, a sparse set
VIS_CASES = {"one": (1, [0]), "all": (40, list(range(40))),
             "none": (40, []), "past_32": (40, [0, 31, 32, 33, 39]),
             "sparse": (70, [3, 17, 32, 45, 63, 64, 69])}


def _vis_query(nbox: int, windows: str, resid, case: str, branches=1):
    """(query with the allowed codes of ``case`` as its ``vis`` section,
    the same query without it, the vocabulary size): ``branches`` branches
    of ``nbox`` random boxes each (``nbox`` 0: every branch boxless)."""
    sft = TSFT.from_spec("g", SPEC)
    vocab, allowed = VIS_CASES[case]
    out = []
    for k in range(branches):
        geo = _geo_boxes(max(1, nbox), nbox + 11 + k)
        boxes = tscan.pad_boxes(t_fp62(geo))
        gate = tcompiled._gate_of(geo, len(boxes))
        if nbox == 0:
            boxes = gate = None
        w = None
        if windows == "some":
            w = np.array([[2601, 1000, 2603, 500], [2605, 7, 2605, 90000],
                          [1, 0, 0, 0], [1, 0, 0, 0]], dtype=np.int32)
        prog = tscan.compile_residual(
            tparse(resid), sft,
            {"name": ["alpha", "beta", "gamma", "delta"]}).program \
            if resid else None
        out.append((boxes, gate, w, prog))
    return (tscan.FusedQuery(out, np.asarray(allowed, np.int32)),
            tscan.FusedQuery(out), vocab)


@pytest.mark.parametrize("case", sorted(VIS_CASES))
@pytest.mark.parametrize("nbox", [0, 4], ids=["boxless", "boxes"])
def test_plain_vis_section_equals_isin(case, nbox):
    """The plain ``fused_scan`` under a ``vis`` section keeps exactly the
    rows whose ``__vis__`` code is allowed (``np.isin``) among the rows it
    keeps without one; the bitmap is as long as the largest allowed code
    needs."""
    n, bsz = 20_011, 512
    cols = _planes(n, 5, "cpu", True)
    q, plain_q, vocab = _vis_query(nbox, "some", "age > 10", case)
    assert q.vis and not plain_q.vis
    codes = np.random.default_rng(8).integers(0, vocab, n).astype(np.int32)
    cols["__vis__"] = torch.from_numpy(codes)
    nb = -(-n // bsz)
    ids, k = _block_list("edge", nb)
    ids = torch.from_numpy(ids)
    nblk = torch.tensor([k], dtype=torch.int32)
    m, c = tscan.fused_scan(cols, torch.from_numpy(q.packed), q, ids, nblk,
                            bsz, "mask")
    m0, _ = tscan.fused_scan(cols, torch.from_numpy(plain_q.packed),
                             plain_q, ids, nblk, bsz, "mask")
    rows = tscan.expand_blocks(cols, ids, bsz, n)[1]
    allowed = np.isin(codes, VIS_CASES[case][1])
    want = m0.numpy() & allowed[rows.numpy()]
    assert np.array_equal(m.numpy(), want) and int(c) == int(want.sum())
    top = max(VIS_CASES[case][1], default=0)
    assert q.offsets["vis"][1] // 4 == top // 32 + 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(VIS_CASES))
@pytest.mark.parametrize("nbox,windows,resid", [
    (4, "some", "age > 10"), (64, "none", None),
    (0, "some", "flag = false AND age > 10"), (0, "none", None)],
    ids=["boxes", "many_boxes", "boxless", "boxless_bare"])
@pytest.mark.parametrize("shape", ["aligned", "view", "vis_view"])
def test_cuda_vis_scan_equals_plain(case, nbox, windows, resid, shape):
    """The VIS form against the plain version in both instantiations
    (boxes: the boxed form; boxless: every branch without boxes), for one
    allowed code, every code, none, codes past 32 and a sparse set, with
    aligned planes (the quads' vector loads), planes that are views at
    offset 1 (the scalar path) and a ``__vis__`` plane alone at offset 1
    (vector loads declined for the call): count, mask and its compaction,
    one VIS launch each."""
    dev = _cuda()
    n, bsz = (100_003, 4096) if shape == "aligned" else (20_011, 512)
    cols = _planes(n + 1, 9, dev, True)
    q, _, vocab = _vis_query(nbox, windows, resid, case, branches=2)
    codes = np.random.default_rng(6).integers(0, vocab, n + 1)
    cols["__vis__"] = torch.from_numpy(codes.astype(np.int32)).to(dev)
    shifted = {"view": set(cols), "vis_view": {"__vis__"}}.get(shape, set())
    cols = {k: (v[1:] if k in shifted else v[:n]) for k, v in cols.items()}
    qbuf = torch.from_numpy(q.packed).to(dev)
    nb = -(-n // bsz)
    for blocks in ("all", "edge", "sparse"):
        ids, k = _block_list(blocks, nb)
        ids = torch.from_numpy(ids).to(dev)
        nblk = torch.tensor([k], dtype=torch.int32, device=dev)
        before = kscan.fused_scan.vis_launches
        got = kscan.fused_scan(cols, qbuf, q, ids, nblk, bsz, "count")
        want = tscan.fused_scan(cols, qbuf, q, ids, nblk, bsz, "count")
        assert torch.equal(got, want), blocks
        assert kscan.fused_scan.vis_launches == before + 1
        got = kscan.fused_scan(cols, qbuf, q, ids, nblk, bsz, "mask")
        want = tscan.fused_scan(cols, qbuf, q, ids, nblk, bsz, "mask")
        assert torch.equal(got[1], want[1]), blocks
        assert torch.equal(got[0][:k * bsz], want[0][:k * bsz]), blocks
        if case == "none":
            assert int(want[1]) == 0
        starts = tscan.expand_blocks(cols, ids, bsz, n)[2]
        _compact_equals_plain(got[0], 300, dict(starts=starts, bsz=bsz,
                                                n_blocks=nblk))


@pytest.mark.gpu
@pytest.mark.parametrize("q", [
    "BBOX(geom,-60,-30,60,30) AND dtg DURING "
    "2020-01-03T00:00:00Z/2020-01-15T00:00:00Z",
    "dtg DURING 2020-01-03T00:00:00Z/2020-01-15T00:00:00Z AND age > 50",
    "BBOX(geom,-60,-30,0,0) OR BBOX(geom,-10,-10,60,30)"])
@pytest.mark.parametrize("auths", [["admin"], [], ["admin", "ops"]],
                         ids=str)
def test_cuda_store_under_auths_equals_cpu(q, auths):
    """The store's count and select under auths on the card (the fused,
    staged and union programs with their vis section) equal the CPU's."""
    dev = _cuda()
    cols = _columns(20_000, 21)
    vis = np.random.default_rng(21).choice(
        ["", "admin", "admin&ops", "user|ops", "ops"], 20_000)
    out = []
    for d in ("cpu", dev):
        sft = TSFT.from_spec("v", SPEC)
        t = TTable.build(sft, cols, visibilities=vis)
        p = TPlanner(sft, t, [TZ3(sft, t, d)])
        out.append((p.count(q, auths=auths),
                    p.select_indices(q, auths=auths)))
    assert out[0][0] == out[1][0]
    assert np.array_equal(out[0][1], out[1][1])
