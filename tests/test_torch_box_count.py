"""The port's batched box counts (``ScanKernels.counts_multi`` /
``counts_multi_blocks``) and the staged ``count`` / ``count_blocks`` that
now go through the same reduction, against the JAX package's
``ScanKernels`` on identical state: an 8,000-row table with gather blocks of
512 rows in both packages (the last block is partial, so its start clamps).
Every comparison is exact (int32 counts, value for value): B in {1, 3, 8,
64, 300} boxes, with and without time windows, with and without a device
residual (``age > 10``, a string ``IN``), over the full table, a real range
cover, explicit block lists with pad blocks, the clamped last block and
ids past the table, an empty block list, and all-empty boxes.

The port runs with device="cpu" here: the plain versions. The ``gpu`` tests
hold the ``box_count`` CUDA kernel to its plain version on the card at the
same cases and at n = 3 * 2^20 + 17 rows. They import nothing of JAX, so on
the card (where JAX is not installed) ``python -m pytest --noconftest -m gpu
tests/test_torch_box_count.py`` runs them.
"""

import importlib

import numpy as np
import pytest
import torch

from geomesa_tpu_torch import config as tconfig
from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.index import scan as tscan
from geomesa_tpu_torch.index.device import fp62
from geomesa_tpu_torch.index.planner import QueryPlanner as TPlanner
from geomesa_tpu_torch.index.spatial import Z3Index as TZ3
from geomesa_tpu_torch.index.spatial import _boxes_fp62 as t_fp62
from geomesa_tpu_torch.kernels import box_count as tkernel

SPEC = ("name:String,age:Int,score:Float,dtg:Date,*geom:Point;"
        "geomesa.z3.interval=week")
DURING = "dtg DURING 2020-01-03T00:00:00Z/2020-01-15T00:00:00Z"
N = 8000
BSZ = 512

# plans whose windows and device residual the batched counts reuse
FILTERS = {
    "none": "INCLUDE",
    "time": DURING,
    "resid": "age > 10",
    "time_resid": f"{DURING} AND age > 10",
    "time_in": f"{DURING} AND name IN ('alpha', 'beta')",
}


def _ref(name: str):
    """A module of the JAX package (imported only by the CPU tests)."""
    pytest.importorskip("jax")
    return importlib.import_module(name)


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


def _boxes(k: int, seed: int):
    """k user-space boxes: random spans, some degenerate, some touching the
    domain edges."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-180, 170, k)
    y0 = rng.uniform(-90, 80, k)
    w = rng.uniform(0, 60, k)
    h = rng.uniform(0, 40, k)
    out = [(float(a), float(b), float(min(180, a + c)), float(min(90, b + d)))
           for a, b, c, d in zip(x0, y0, w, h)]
    if k > 2:
        out[1] = (-180.0, -90.0, 180.0, 90.0)
        out[2] = (10.0, 10.0, 10.0, 10.0)
    return out


@pytest.fixture(scope="module")
def world():
    jconfig = _ref("geomesa_tpu.config")
    jprune = _ref("geomesa_tpu.index.prune")
    vars(jprune).pop("BLOCK_SIZE", None)
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.set(BSZ)
    try:
        cols = _columns(N, 5)
        JSFT = _ref("geomesa_tpu.features.sft").SimpleFeatureType
        JTable = _ref("geomesa_tpu.features.table").FeatureTable
        JZ3 = _ref("geomesa_tpu.index.spatial").Z3Index
        JPlanner = _ref("geomesa_tpu.index.planner").QueryPlanner
        jsft = JSFT.from_spec("s", SPEC)
        jt = JTable.build(jsft, cols)
        jp = JPlanner(jsft, jt, [JZ3(jsft, jt)])
        tsft = TSFT.from_spec("s", SPEC)
        tt = TTable.build(tsft, cols)
        tp = TPlanner(tsft, tt, [TZ3(tsft, tt, "cpu")])
        yield jp, tp
    finally:
        for c in (jconfig, tconfig):
            c.PRUNE_BLOCK.unset()


def _fp62(k: int, seed: int):
    boxes = _boxes(k, seed)
    jb = _ref("geomesa_tpu.index.spatial")._boxes_fp62(boxes)
    tb = t_fp62(boxes)
    assert np.array_equal(jb, tb)
    return jb, tb


def _rest(plan):
    return plan.windows, plan.residual_device


def _cover(jp, tp):
    """The union of two box queries' range covers (as the scheduler
    builds it), equal in both packages."""
    short = "dtg DURING 2020-01-04T00:00:00Z/2020-01-07T00:00:00Z"
    qs = [f"BBOX(geom, 10, 10, 40, 40) AND {short}",
          f"BBOX(geom, -120, -50, -90, -20) AND {short}"]
    jb = [jp._pruned_blocks(jp.plan(q)) for q in qs]
    tb = [tp._pruned_blocks(tp.plan(q)) for q in qs]
    for a, b in zip(jb, tb):
        assert a is not None and np.array_equal(a, b)
    return np.unique(np.concatenate(tb)).astype(np.int32)


# the clamped last block (15: rows 7680..7999 read from 7488), ids past the
# table (20, 99), and a count that is not a power of two (pads with -1)
EDGE_BLOCKS = np.array([0, 3, 14, 15, 20, 99], dtype=np.int32)


@pytest.mark.parametrize("B,fkey", [
    (1, "none"), (1, "time_resid"), (3, "time"), (3, "resid"),
    (8, "none"), (8, "time"), (8, "resid"), (8, "time_resid"),
    (8, "time_in"), (64, "time_resid"), (64, "none"), (300, "time"),
])
@pytest.mark.parametrize("where", ["table", "cover", "edge", "empty"])
def test_counts_multi_equal_reference(world, B, fkey, where):
    jp, tp = world
    jk, tk = jp.indexes[0].kernels, tp.indexes[0].kernels
    jb, tb = _fp62(B, seed=B)
    f = FILTERS[fkey]
    ja, ta = _rest(jp.plan(f)), _rest(tp.plan(f))
    if where == "table":
        want = jk.counts_multi("point_boxes", jb, *ja)
        got = tk.counts_multi("point_boxes", tb, *ta)
    else:
        blocks = {"cover": lambda: _cover(jp, tp),
                  "edge": lambda: EDGE_BLOCKS,
                  "empty": lambda: np.empty(0, dtype=np.int32)}[where]()
        want = jk.counts_multi_blocks("point_boxes", jb, *ja, blocks, BSZ)
        got = tk.counts_multi_blocks("point_boxes", tb, *ta, blocks, BSZ)
    assert got.dtype == np.int32 and got.shape == (B,)
    assert np.array_equal(got, np.asarray(want))
    if where in ("table", "cover") and B > 1:
        assert got.max() > 0


@pytest.mark.parametrize("where", ["table", "edge"])
def test_all_empty_boxes_count_zero(world, where):
    jp, tp = world
    jk, tk = jp.indexes[0].kernels, tp.indexes[0].kernels
    boxes = np.tile(tscan.EMPTY_BOX, (5, 1))
    ja, ta = _rest(jp.plan(DURING)), _rest(tp.plan(DURING))
    if where == "table":
        want = jk.counts_multi("point_boxes", boxes, *ja)
        got = tk.counts_multi("point_boxes", boxes, *ta)
    else:
        want = jk.counts_multi_blocks("point_boxes", boxes, *ja,
                                      EDGE_BLOCKS, BSZ)
        got = tk.counts_multi_blocks("point_boxes", boxes, *ta,
                                     EDGE_BLOCKS, BSZ)
    assert np.array_equal(got, np.asarray(want))
    assert not got.any()


@pytest.mark.parametrize("nbox", [0, 1, 4])
@pytest.mark.parametrize("fkey", ["none", "time_resid", "time_in"])
def test_rerouted_count_and_count_blocks_equal_reference(world, nbox, fkey):
    """``count``/``count_blocks`` (now the kernel's any-box count) against
    the reference's: primary ``point_boxes`` with 1 and 4 boxes, and
    primary ``none`` (nbox 0)."""
    jp, tp = world
    jk, tk = jp.indexes[0].kernels, tp.indexes[0].kernels
    f = FILTERS[fkey]
    ja, ta = _rest(jp.plan(f)), _rest(tp.plan(f))
    if nbox:
        jb, tb = _fp62(nbox, seed=40 + nbox)
        jb = tb = tscan.pad_boxes(tb)
        kind = "point_boxes"
    else:
        jb = tb = None
        kind = "none"
    want = jk.count(kind, jb, *ja)
    assert tk.count(kind, tb, *ta) == want
    assert int(tk.prepare_count(kind, tb, *ta)()) == want
    for blocks in (_cover(jp, tp), EDGE_BLOCKS):
        want = jk.count_blocks(kind, jb, *ja, blocks, BSZ)
        assert tk.count_blocks(kind, tb, *ta, blocks, BSZ) == want
        assert int(tk.prepare_count_blocks(kind, tb, *ta, blocks,
                                           BSZ)()) == want


def test_per_box_needs_a_box_primary(world):
    _, tp = world
    with pytest.raises(ValueError, match="primary kind"):
        tp.indexes[0].kernels.prepare_counts_multi(
            "none", np.tile(tscan.EMPTY_BOX, (1, 1)), None, None)


# -- the order-preserving keys against the reference's compares -------------

INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1
# every edge of the int32 range and of the lo sign (I31MAX is INT32_MAX)
EDGE_INTS = np.array(sorted({INT32_MIN, -1, 0, 1, tscan._I31MAX, INT32_MAX}),
                     dtype=np.int32)


def _key_pairs(kind: str):
    """(a_hi, a_lo, b_hi, b_lo) int32 arrays: every pair of EDGE_INTS pairs,
    or 10,000 random pairs of which a third tie on hi with lo of either
    sign and a third draw hi from [-3, 3]."""
    if kind == "edges":
        hi, lo = (g.ravel() for g in np.meshgrid(EDGE_INTS, EDGE_INTS))
        ah, bh = (g.ravel() for g in np.meshgrid(hi, hi))
        al, bl = (g.ravel() for g in np.meshgrid(lo, lo))
        return ah, al, bh, bl
    rng = np.random.default_rng(62)
    n = 10_000

    def draw(size):
        return rng.integers(INT32_MIN, INT32_MAX, size, endpoint=True,
                            dtype=np.int64).astype(np.int32)

    ah, al, bh, bl = draw(n), draw(n), draw(n), draw(n)
    third = n // 3
    bh[:third] = ah[:third]
    bl[:third // 2] = -al[:third // 2] - 1   # lo of the other sign
    small = slice(third, 2 * third)
    ah[small] = rng.integers(-3, 4, third)
    bh[small] = rng.integers(-3, 4, third)
    return ah, al, bh, bl


@pytest.mark.parametrize("op", ["ge", "le"])
@pytest.mark.parametrize("kind", ["edges", "random"])
def test_pack62_order_equals_reference_lexicographic(kind, op):
    """``pack62`` keys compare, element for element, as the reference's
    signed lexicographic ``_ge62``/``_le62``."""
    jscan = _ref("geomesa_tpu.index.scan")
    jnp = _ref("jax.numpy")
    ah, al, bh, bl = _key_pairs(kind)
    ka = tscan.pack62(torch.from_numpy(ah), torch.from_numpy(al))
    kb = tscan.pack62(torch.from_numpy(bh), torch.from_numpy(bl))
    assert ka.dtype == torch.int64
    got = (ka >= kb if op == "ge" else ka <= kb).numpy()
    ref = jscan._ge62 if op == "ge" else jscan._le62
    want = np.asarray(ref(*(jnp.asarray(a) for a in (ah, al, bh, bl))))
    assert np.array_equal(got, want)
    assert got.any() and not got.all()


def _int32_planes(n: int, seed: int):
    """Point planes over the whole int32 range: hi from [-3, 3] (ties on
    box edges), lo of either sign; bin from 3 values, off of either sign."""
    rng = np.random.default_rng(seed)

    def full(size):
        return rng.integers(INT32_MIN, INT32_MAX, size, endpoint=True,
                            dtype=np.int64).astype(np.int32)

    return {"xi": rng.integers(-3, 4, n).astype(np.int32), "xl": full(n),
            "yi": rng.integers(-3, 4, n).astype(np.int32), "yl": full(n),
            "bin": rng.integers(0, 3, n).astype(np.int32), "off": full(n)}


def _int32_boxes(k: int, seed: int, cols):
    """k boxes whose bounds are rows' own (hi, lo) pairs (ties on every
    edge) or random pairs, plus EMPTY_BOX; and 3 windows, one empty."""
    rng = np.random.default_rng(seed)
    n = cols["xi"].shape[0]
    r = rng.integers(0, n, (k, 4))
    x = np.stack([cols["xi"][r], cols["xl"][r]], axis=-1)   # (k, 4, 2)
    y = np.stack([cols["yi"][r], cols["yl"][r]], axis=-1)
    key = lambda p: p[..., 0].astype(np.int64) * (1 << 32) + p[..., 1]  # noqa: E731
    xs = np.take_along_axis(x, np.argsort(key(x), axis=1)[..., None], 1)
    ys = np.take_along_axis(y, np.argsort(key(y), axis=1)[..., None], 1)
    boxes = np.concatenate([xs[:, 0], xs[:, 3], ys[:, 0], ys[:, 3]], axis=1)
    boxes = np.concatenate([boxes, tscan.EMPTY_BOX[None]]).astype(np.int32)
    i = rng.integers(0, n, 2)
    windows = np.array([[0, cols["off"][i[0]], 1, cols["off"][i[1]]],
                        [2, INT32_MIN, 2, -1], [2, 0, 1, 0]], dtype=np.int32)
    return boxes, windows


@pytest.mark.parametrize("per_box", [True, False])
@pytest.mark.parametrize("windows", [False, True])
def test_plain_box_count_equals_reference_on_signed_planes(per_box, windows):
    """The plain ``box_count`` (``pack62`` keys) against the reference's
    ``_point_box_pairwise`` and ``_time_mask`` on planes whose lo values
    take both signs and whose hi values tie on the boxes' edges."""
    jscan = _ref("geomesa_tpu.index.scan")
    jnp = _ref("jax.numpy")
    cols = _int32_planes(4000, 9)
    boxes, win = _int32_boxes(12, 10, cols)
    jcols = {k: jnp.asarray(v) for k, v in cols.items()}
    pair = np.asarray(jscan._point_box_pairwise(jcols, jnp.asarray(boxes)))
    base = np.ones(len(cols["xi"]), bool)
    if windows:
        base = np.asarray(jscan._time_mask(jcols, jnp.asarray(win)))
    want = (pair & base[:, None]).sum(axis=0) if per_box \
        else (pair.any(axis=1) & base).sum()
    tcols = {k: torch.from_numpy(v) for k, v in cols.items()}
    got = tscan.box_count(tcols, torch.from_numpy(boxes),
                          torch.from_numpy(win) if windows else None,
                          None, None, None, per_box)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert 0 < int(got.sum()) and (not per_box or got[-1] == 0)


# -- the CUDA kernel against its plain version (card only) --------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the box_count kernel)")
    return torch.device("cuda")


def _planes(n: int, seed: int, dev):
    """Random device planes of a Z3 point table: fp62 x/y (with exact ties
    to the boxes' bounds), binned time, a sparse __valid__."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-90, 90, n)
    x[: n // 50] = 10.0        # ties on a box edge
    xi, xl = fp62(x, -180.0, 180.0)
    yi, yl = fp62(y, -90.0, 90.0)
    cols = {"xi": xi, "xl": xl, "yi": yi, "yl": yl,
            "bin": rng.integers(2600, 2606, n).astype(np.int32),
            "off": rng.integers(0, 604800, n).astype(np.int32)}
    out = {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}
    return out, rng.random(n) < 0.9


def _gpu_case(n, nbox, windows, resid, blocks, valid, seed):
    dev = _cuda()
    cols, vmask = _planes(n, seed, dev)
    if valid:
        cols["__valid__"] = torch.from_numpy(vmask).to(dev)
    boxes = None
    if nbox:
        b = t_fp62(_boxes(nbox, seed))
        boxes = torch.from_numpy(tscan.pad_boxes(b)).to(dev)
    w = None
    if windows:
        w = torch.tensor([[2601, 1000, 2603, 500], [2605, 7, 2605, 90000],
                          [1, 0, 0, 0], [1, 0, 0, 0]], dtype=torch.int32,
                         device=dev)
    bid = None
    ncand = n
    if blocks is not None:
        nb = max(8, 1 << max(0, len(blocks) - 1).bit_length())
        pad = np.full(nb, -1, dtype=np.int32)
        pad[: len(blocks)] = blocks
        bid = torch.from_numpy(pad).to(dev)
        ncand = nb * BSZ
    r = None
    if resid:
        rng = np.random.default_rng(seed + 1)
        r = torch.from_numpy(rng.random(ncand) < 0.7).to(dev)
    return cols, boxes, w, r, bid


GPU_BLOCKS = {
    "table": None,
    "edge": "edge",          # clamped last block, ids past the table, pads
    "empty": np.empty(0, dtype=np.int32),
    "many": "many",
}


# (n, boxes, per_box): the any-box count without boxes, with 1 and 4; the
# per-box counts at 1, 3, 64 and 300 boxes, and at 1500 (two launches of
# 1024-box tiles) on the small table
GPU_SHAPES = [(n, b, pb) for n in (N, 3 * (1 << 20) + 17)
              for b, pb in ((0, False), (1, False), (4, False), (1, True),
                            (3, True), (64, True), (300, True))] \
    + [(N, 1500, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,nbox,per_box", GPU_SHAPES)
@pytest.mark.parametrize("windows,resid,valid", [
    (False, False, False), (True, False, False), (True, True, False),
    (True, True, True)])
@pytest.mark.parametrize("where", list(GPU_BLOCKS))
def test_cuda_kernel_equals_plain(n, nbox, per_box, windows, resid, valid,
                                  where):
    blocks = GPU_BLOCKS[where]
    last = -(-n // BSZ) - 1
    if isinstance(blocks, str):
        blocks = (np.array([0, 3, last - 1, last, last + 5, last + 90],
                           dtype=np.int32) if blocks == "edge"
                  else np.arange(0, last + 1, 3, dtype=np.int32))
    cols, boxes, w, r, bid = _gpu_case(n, nbox, windows, resid, blocks,
                                       valid, seed=nbox + 7 * windows)
    before = tkernel.box_count.launches
    got = tkernel.box_count(cols, boxes, w, r, bid, BSZ if bid is not None
                            else None, per_box)
    torch.cuda.synchronize()
    plain = tscan.box_count(cols, boxes, w, r, bid, BSZ if bid is not None
                            else None, per_box)
    assert got.dtype == torch.int32 and got.shape == plain.shape
    assert torch.equal(got, plain), (got, plain)
    assert tkernel.box_count.launches == before + 1


def _small_boxes(k: int, seed: int):
    """k boxes of at most 12 x 8 degrees: a row lies in few of them, so
    the any-box loop walks far down the list."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-180, 168, k)
    y0 = rng.uniform(-90, 82, k)
    return [(float(a), float(b), float(a + c), float(b + d)) for a, b, c, d
            in zip(x0, y0, rng.uniform(0, 12, k), rng.uniform(0, 8, k))]


def _narrow_windows(k: int, seed: int, dev):
    """k windows over the planes' bins, narrow enough that together they
    hold about a third of the rows, every fifth one empty (bin_lo >
    bin_hi)."""
    rng = np.random.default_rng(seed)
    blo = rng.integers(2600, 2606, k)
    olo = rng.integers(0, 604800, k)
    wide = rng.integers(0, 2_200_000 // max(k, 1) + 1, k)
    w = np.stack([blo, olo, blo, olo + wide], axis=1)
    w[::5, 0] = w[::5, 2] + 1
    return torch.from_numpy(w.astype(np.int32)).to(dev)


# (boxes, windows, per_box): more boxes than the kernel stages in shared
# memory on the any-box count (the rest read from device memory), more
# windows than it stages, both, and a window list with no rows (nothing
# passes, as the plain version's any over no windows)
GPU_LISTS = [(1500, 4, False), (4, 300, False), (1500, 300, False),
             (64, 300, True), (1500, 300, True), (4, 0, False),
             (64, 0, True), (0, 0, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("nbox,nwin,per_box", GPU_LISTS)
@pytest.mark.parametrize("where", ["table", "edge"])
def test_cuda_kernel_long_box_and_window_lists_equal_plain(nbox, nwin,
                                                           per_box, where):
    dev = _cuda()
    cols, _ = _planes(N, nbox + nwin, dev)
    some = _small_boxes if nbox > 1024 else _boxes
    boxes = None if nbox == 0 else torch.from_numpy(
        tscan.pad_boxes(t_fp62(some(nbox, nbox)))).to(dev)
    w = _narrow_windows(nwin, nwin, dev)
    bid = None if where == "table" else torch.from_numpy(
        np.concatenate([EDGE_BLOCKS, np.full(2, -1, np.int32)])).to(dev)
    bsz = None if bid is None else BSZ
    before = tkernel.box_count.launches
    got = tkernel.box_count(cols, boxes, w, None, bid, bsz, per_box)
    torch.cuda.synchronize()
    plain = tscan.box_count(cols, boxes, w, None, bid, bsz, per_box)
    assert got.dtype == torch.int32 and got.shape == plain.shape
    assert torch.equal(got, plain), (got, plain)
    assert tkernel.box_count.launches == before + (1 if nwin else 0)
    if nwin:
        assert int(plain.sum()) > 0


@pytest.mark.gpu
def test_cuda_staged_counts_equal_cpu():
    """The staged counts through the store's route on the card equal the
    same table's on the CPU."""
    dev = _cuda()
    tconfig.PRUNE_BLOCK.set(BSZ)
    try:
        cols = _columns(N, 5)
        sft = TSFT.from_spec("s", SPEC)
        table = TTable.build(sft, cols)
        cpu = TPlanner(sft, table, [TZ3(sft, table, "cpu")])
        gpu = TPlanner(sft, table, [TZ3(sft, table, dev)])
        tb = tscan.pad_boxes(t_fp62(_boxes(64, 3)))
        for f in FILTERS.values():
            cp, gp = cpu.plan(f), gpu.plan(f)
            ck, gk = cpu.indexes[0].kernels, gpu.indexes[0].kernels
            assert np.array_equal(
                gk.counts_multi("point_boxes", tb, *_rest(gp)),
                ck.counts_multi("point_boxes", tb, *_rest(cp)))
            assert np.array_equal(
                gk.counts_multi_blocks("point_boxes", tb, *_rest(gp),
                                       EDGE_BLOCKS, BSZ),
                ck.counts_multi_blocks("point_boxes", tb, *_rest(cp),
                                       EDGE_BLOCKS, BSZ))
            assert gk.count(cp.primary_kind, gp.boxes_loose, *_rest(gp)) \
                == ck.count(cp.primary_kind, cp.boxes_loose, *_rest(cp))
    finally:
        tconfig.PRUNE_BLOCK.unset()


# -- the kernel's tile, box-slot and key edges (card only) --------------------

# box counts around the kernel's box slots: fewer than a warp (lanes split
# the tile by candidate), one warp, box groups of 32, past the 256 threads,
# and past a launch's 1,024 staged boxes
GPU_B = [1, 5, 31, 32, 33, 64, 65, 1024, 1025, 1500]


@pytest.mark.gpu
@pytest.mark.parametrize("nbox", GPU_B)
@pytest.mark.parametrize("where", ["table", "edge"])
def test_cuda_kernel_box_slots_equal_plain(nbox, where):
    cols, _, w, r, bid = _gpu_case(
        N, 0, True, True, EDGE_BLOCKS if where == "edge" else None, True,
        seed=nbox)
    # unpadded: B itself, not the next power of two
    boxes = torch.from_numpy(t_fp62(_boxes(nbox, nbox))).to(cols["xi"].device)
    bsz = None if bid is None else BSZ
    got = tkernel.box_count(cols, boxes, w, r, bid, bsz, True)
    torch.cuda.synchronize()
    plain = tscan.box_count(cols, boxes, w, r, bid, bsz, True)
    assert got.shape == (nbox,) and torch.equal(got, plain), (got, plain)
    assert int(plain.sum()) > 0


def _tile() -> int:
    from geomesa_tpu_torch.kernels import build
    return int(build.load(tkernel.NAME).box_count_tile())


# (candidates in tiles, extra candidates, residual): every candidate live
# over exactly one tile, one tile and one more, and three tiles and one
# more; one live candidate a warp step (128 candidates), with a ragged tail
GPU_TILES = [(1, 0, "all"), (1, 1, "all"), (3, 1, "all"), (3, 17, "sparse")]


@pytest.mark.gpu
@pytest.mark.parametrize("tiles,extra,resid", GPU_TILES)
@pytest.mark.parametrize("nbox", [1, 64])
def test_cuda_kernel_tile_fill_equal_plain(tiles, extra, resid, nbox):
    dev = _cuda()
    n = tiles * _tile() + extra
    cols, _ = _planes(n, 3, dev)
    boxes = torch.from_numpy(tscan.pad_boxes(t_fp62(
        [(-180.0, -90.0, 180.0, 90.0)] + _boxes(nbox - 1, 4)))).to(dev)
    r = None
    if resid == "sparse":
        m = np.zeros(n, bool)
        m[::128] = True
        r = torch.from_numpy(m).to(dev)
    got = tkernel.box_count(cols, boxes, None, r, None, None, True)
    torch.cuda.synchronize()
    plain = tscan.box_count(cols, boxes, None, r, None, None, True)
    assert torch.equal(got, plain), (got, plain)
    assert int(got[0]) == (n if r is None else -(-n // 128))


@pytest.mark.gpu
@pytest.mark.parametrize("per_box", [True, False])
@pytest.mark.parametrize("where", ["table", "edge", "empty"])
@pytest.mark.parametrize("windows", ["some", "none", "no rows"])
def test_cuda_kernel_signed_planes_equal_plain(per_box, where, windows):
    """Planes over the whole int32 range (lo of either sign, hi ties on the
    boxes' edges), EMPTY_BOX among the boxes, the clamped last block and
    pads, and a (0, 4) window list."""
    dev = _cuda()
    n = N + 5
    np_cols = _int32_planes(n, 21)
    boxes, win = _int32_boxes(40, 22, np_cols)
    cols = {k: torch.from_numpy(v).to(dev) for k, v in np_cols.items()}
    w = {"some": torch.from_numpy(win).to(dev), "none": None,
         "no rows": torch.empty((0, 4), dtype=torch.int32, device=dev)
         }[windows]
    blocks = {"table": None, "edge": np.concatenate(
        [EDGE_BLOCKS, np.full(2, -1, np.int32)]),
        "empty": np.full(4, -1, np.int32)}[where]
    bid = None if blocks is None else torch.from_numpy(blocks).to(dev)
    bsz = None if bid is None else BSZ
    b = torch.from_numpy(boxes).to(dev)
    got = tkernel.box_count(cols, b, w, None, bid, bsz, per_box)
    torch.cuda.synchronize()
    plain = tscan.box_count(cols, b, w, None, bid, bsz, per_box)
    assert got.shape == plain.shape and torch.equal(got, plain), (got, plain)
    if per_box:
        assert int(got[-1]) == 0   # EMPTY_BOX
    if where != "empty" and windows != "no rows":
        assert int(got.sum()) > 0


# -- extent layers: the envelope primary (bbox_overlap) -----------------------

EXT_SPEC = ("name:String,age:Int,dtg:Date,*geom:LineString;"
            "geomesa.z3.interval=week")


def _lines(n: int, seed: int):
    """n two- and three-vertex LineStrings: envelopes from points to 8 x 6
    degrees, a fiftieth of them with an end on x = 10 (ties on box
    edges)."""
    from geomesa_tpu_torch.features.geometry import LINESTRING
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-178, 170, n)
    y0 = rng.uniform(-88, 82, n)
    x0[: n // 50] = 10.0
    shapes = []
    for i in range(n):
        k = 2 + (i % 2)
        xs = x0[i] + np.concatenate([[0.0], rng.uniform(0, 8, k - 1)])
        ys = y0[i] + np.concatenate([[0.0], rng.uniform(0, 6, k - 1)])
        shapes.append((LINESTRING, np.stack([xs, ys], 1).tolist()))
    return shapes


@pytest.fixture(scope="module")
def extent_world():
    """An XZ3 layer of N LineStrings in both packages, blocks of BSZ."""
    jconfig = _ref("geomesa_tpu.config")
    jprune = _ref("geomesa_tpu.index.prune")
    vars(jprune).pop("BLOCK_SIZE", None)
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.set(BSZ)
    try:
        from geomesa_tpu_torch.features.geometry import GeometryArray
        from geomesa_tpu_torch.index.spatial import XZ3Index as TXZ3
        cols = _columns(N, 15)
        del cols["score"]
        shapes = _lines(N, 16)
        JGeo = _ref("geomesa_tpu.features.geometry").GeometryArray
        JSFT = _ref("geomesa_tpu.features.sft").SimpleFeatureType
        JTable = _ref("geomesa_tpu.features.table").FeatureTable
        JXZ3 = _ref("geomesa_tpu.index.spatial").XZ3Index
        JPlanner = _ref("geomesa_tpu.index.planner").QueryPlanner
        jsft = JSFT.from_spec("e", EXT_SPEC)
        jt = JTable.build(jsft, dict(cols, geom=JGeo.from_shapes(shapes)))
        jp = JPlanner(jsft, jt, [JXZ3(jsft, jt)])
        tsft = TSFT.from_spec("e", EXT_SPEC)
        tt = TTable.build(tsft, dict(cols,
                                     geom=GeometryArray.from_shapes(shapes)))
        tp = TPlanner(tsft, tt, [TXZ3(tsft, tt, "cpu")])
        yield jp, tp
    finally:
        for c in (jconfig, tconfig):
            c.PRUNE_BLOCK.unset()


def _ext_cover(jp, tp):
    short = "dtg DURING 2020-01-04T00:00:00Z/2020-01-07T00:00:00Z"
    qs = [f"BBOX(geom, 10, 10, 40, 40) AND {short}",
          f"BBOX(geom, -120, -50, -90, -20) AND {short}"]
    jb = [jp._pruned_blocks(jp.plan(q)) for q in qs]
    tb = [tp._pruned_blocks(tp.plan(q)) for q in qs]
    for a, b in zip(jb, tb):
        assert a is not None and np.array_equal(a, b)
    return np.unique(np.concatenate(tb)).astype(np.int32)


@pytest.mark.parametrize("B,fkey", [
    (1, "none"), (1, "time_resid"), (3, "time"), (8, "resid"),
    (8, "time_in"), (64, "time_resid"), (300, "none"),
])
@pytest.mark.parametrize("where", ["table", "cover", "edge", "empty"])
def test_envelope_counts_multi_equal_reference(extent_world, B, fkey, where):
    """Per-box envelope-overlap counts (``counts_multi`` and
    ``counts_multi_blocks`` with primary ``bbox_overlap``) against the
    reference's on the same XZ3 layer."""
    jp, tp = extent_world
    jk, tk = jp.indexes[0].kernels, tp.indexes[0].kernels
    jb, tb = _fp62(B, seed=B + 1)
    f = FILTERS[fkey]
    ja, ta = _rest(jp.plan(f)), _rest(tp.plan(f))
    if where == "table":
        want = jk.counts_multi("bbox_overlap", jb, *ja)
        got = tk.counts_multi("bbox_overlap", tb, *ta)
    else:
        blocks = {"cover": lambda: _ext_cover(jp, tp),
                  "edge": lambda: EDGE_BLOCKS,
                  "empty": lambda: np.empty(0, dtype=np.int32)}[where]()
        want = jk.counts_multi_blocks("bbox_overlap", jb, *ja, blocks, BSZ)
        got = tk.counts_multi_blocks("bbox_overlap", tb, *ta, blocks, BSZ)
    assert got.dtype == np.int32 and got.shape == (B,)
    assert np.array_equal(got, np.asarray(want))
    if where in ("table", "cover") and B > 1:
        assert got.max() > 0


@pytest.mark.parametrize("nbox", [1, 4])
@pytest.mark.parametrize("fkey", ["none", "time_resid", "time_in"])
def test_envelope_count_and_count_blocks_equal_reference(extent_world, nbox,
                                                         fkey):
    """The any-box envelope count (``count`` / ``count_blocks``) against
    the reference's."""
    jp, tp = extent_world
    jk, tk = jp.indexes[0].kernels, tp.indexes[0].kernels
    f = FILTERS[fkey]
    ja, ta = _rest(jp.plan(f)), _rest(tp.plan(f))
    jb, tb = _fp62(nbox, seed=50 + nbox)
    jb = tb = tscan.pad_boxes(tb)
    want = jk.count("bbox_overlap", jb, *ja)
    assert tk.count("bbox_overlap", tb, *ta) == want
    assert int(tk.prepare_count("bbox_overlap", tb, *ta)()) == want
    for blocks in (_ext_cover(jp, tp), EDGE_BLOCKS):
        want = jk.count_blocks("bbox_overlap", jb, *ja, blocks, BSZ)
        assert tk.count_blocks("bbox_overlap", tb, *ta, blocks, BSZ) == want
    assert want > 0


def _int32_env_planes(n: int, seed: int):
    """Envelope planes over the whole int32 range: each min/max pair a
    row's two (hi, lo) keys in order, hi from [-3, 3] (ties on the box
    edges), lo of either sign; bin from 3 values, off of either sign."""
    a = _int32_planes(n, seed)
    b = _int32_planes(n, seed + 100)
    out = {"bin": a["bin"], "off": a["off"]}
    for ax, hi, lo in (("x", "xi", "xl"), ("y", "yi", "yl")):
        ka = a[hi].astype(np.int64) * (1 << 32) + a[lo]
        kb = b[hi].astype(np.int64) * (1 << 32) + b[lo]
        swap = kb < ka
        for name, src, alt in ((f"b{ax}min", a, b), (f"b{ax}max", b, a)):
            out[f"{name}_i"] = np.where(swap, alt[hi], src[hi])
            out[f"{name}_l"] = np.where(swap, alt[lo], src[lo])
    return out


@pytest.mark.parametrize("per_box", [True, False])
@pytest.mark.parametrize("windows", [False, True])
def test_plain_envelope_box_count_equals_reference_on_signed_planes(
        per_box, windows):
    """The plain envelope ``box_count`` (``pack62`` keys) against the
    reference's ``_bbox_overlap_pairwise`` and ``_time_mask``."""
    jscan = _ref("geomesa_tpu.index.scan")
    jnp = _ref("jax.numpy")
    cols = _int32_env_planes(4000, 31)
    pts = {"xi": cols["bxmin_i"], "xl": cols["bxmin_l"],
           "yi": cols["bymin_i"], "yl": cols["bymin_l"], "off": cols["off"]}
    boxes, win = _int32_boxes(12, 32, pts)
    jcols = {k: jnp.asarray(v) for k, v in cols.items()}
    pair = np.asarray(jscan._bbox_overlap_pairwise(jcols,
                                                   jnp.asarray(boxes)))
    base = np.ones(4000, bool)
    if windows:
        base = np.asarray(jscan._time_mask(jcols, jnp.asarray(win)))
    want = (pair & base[:, None]).sum(axis=0) if per_box \
        else (pair.any(axis=1) & base).sum()
    tcols = {k: torch.from_numpy(v) for k, v in cols.items()}
    got = tscan.box_count(tcols, torch.from_numpy(boxes),
                          torch.from_numpy(win) if windows else None,
                          None, None, None, per_box, envelope=True)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert 0 < int(got.sum())


def _env_planes(n: int, seed: int, dev):
    """Random device envelope planes of an extent table (fp62, a fiftieth
    with bxmin on x = 10, ties on box edges), binned time."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-180, 175, n)
    y0 = rng.uniform(-90, 86, n)
    x0[: n // 50] = 10.0
    x1 = np.minimum(180.0, x0 + rng.uniform(0, 5, n))
    y1 = np.minimum(90.0, y0 + rng.uniform(0, 4, n))
    cols = {"bin": rng.integers(2600, 2606, n).astype(np.int32),
            "off": rng.integers(0, 604800, n).astype(np.int32)}
    for name, v, lo, hi in (("bxmin", x0, -180.0, 180.0),
                            ("bymin", y0, -90.0, 90.0),
                            ("bxmax", x1, -180.0, 180.0),
                            ("bymax", y1, -90.0, 90.0)):
        cols[name + "_i"], cols[name + "_l"] = fp62(v, lo, hi)
    out = {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}
    return out, rng.random(n) < 0.9


@pytest.mark.gpu
@pytest.mark.parametrize("n", [N, 3 * (1 << 20) + 17])
@pytest.mark.parametrize("nbox,per_box", [
    (0, False), (1, False), (4, False), (1, True), (3, True), (64, True),
    (300, True), (1500, True), (1500, False)])
@pytest.mark.parametrize("windows,resid,valid", [
    (False, False, False), (True, True, True)])
@pytest.mark.parametrize("where", list(GPU_BLOCKS))
def test_cuda_envelope_kernel_equals_plain(n, nbox, per_box, windows, resid,
                                           valid, where):
    """The envelope kernel (``box_count(..., envelope=True)``) against its
    plain version: any-box and per-box, over the table and blocks (the
    clamped last block, ids past the table, pads, an empty list), with
    windows, a residual and __valid__, past the staged box counts."""
    dev = _cuda()
    blocks = GPU_BLOCKS[where]
    last = -(-n // BSZ) - 1
    if isinstance(blocks, str):
        blocks = (np.array([0, 3, last - 1, last, last + 5, last + 90],
                           dtype=np.int32) if blocks == "edge"
                  else np.arange(0, last + 1, 3, dtype=np.int32))
    _, _, w, r, bid = _gpu_case(n, 0, windows, resid, blocks, False,
                                seed=nbox + 3)
    cols, vmask = _env_planes(n, nbox + 5, dev)
    if valid:
        cols["__valid__"] = torch.from_numpy(vmask).to(dev)
    boxes = None
    if nbox:
        b = t_fp62(_boxes(nbox, nbox + 9))
        boxes = torch.from_numpy(b if nbox == 1500 else tscan.pad_boxes(b)
                                 ).to(dev)
    bsz = None if bid is None else BSZ
    before = tkernel.box_count.launches
    got = tkernel.box_count(cols, boxes, w, r, bid, bsz, per_box,
                            envelope=nbox > 0)
    torch.cuda.synchronize()
    plain = tscan.box_count(cols, boxes, w, r, bid, bsz, per_box,
                            envelope=nbox > 0)
    assert got.dtype == torch.int32 and got.shape == plain.shape
    assert torch.equal(got, plain), (got, plain)
    assert tkernel.box_count.launches == before + 1
    if nbox and where in ("table", "many"):
        assert int(got.sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("per_box", [True, False])
@pytest.mark.parametrize("where", ["table", "edge"])
def test_cuda_envelope_kernel_signed_planes_equal_plain(per_box, where):
    """Envelope planes over the whole int32 range, EMPTY_BOX among the
    boxes, windows of either sign."""
    dev = _cuda()
    n = N + 5
    np_cols = _int32_env_planes(n, 41)
    pts = {"xi": np_cols["bxmin_i"], "xl": np_cols["bxmin_l"],
           "yi": np_cols["bymin_i"], "yl": np_cols["bymin_l"],
           "off": np_cols["off"]}
    boxes, win = _int32_boxes(40, 42, pts)
    cols = {k: torch.from_numpy(v).to(dev) for k, v in np_cols.items()}
    bid = None if where == "table" else torch.from_numpy(EDGE_BLOCKS).to(dev)
    bsz = None if bid is None else BSZ
    b = torch.from_numpy(boxes).to(dev)
    w = torch.from_numpy(win).to(dev)
    got = tkernel.box_count(cols, b, w, None, bid, bsz, per_box,
                            envelope=True)
    torch.cuda.synchronize()
    plain = tscan.box_count(cols, b, w, None, bid, bsz, per_box,
                            envelope=True)
    assert got.shape == plain.shape and torch.equal(got, plain), (got, plain)
    assert int(got.sum()) > 0
