"""The certainty-band segment intersects (``ScanKernels.intersects_band_blocks``
and the plain ``scan.seg_band``) against the JAX package's
``intersects_band_blocks`` mode on identical state.

Single-segment LineString layers of ``tests/test_band_intersects.py``'s
shape (40,000 segments over (-60, 60) x (0, 70), seed 2) and segments
placed within a few f32 ulps of the polygon's edges (every band case:
certain hits, certain misses, uncertain rows on both sides), in XZ2 and
XZ3 layers built by both packages, gather blocks of 256 rows. The raw
``[certain, n_uncertain, uncertain rows ...]`` vector must be equal value
for value: with time windows, with a device residual, with edge tables of
every padding (the ``EDGE_PAD`` rows are neutral), and past ``unc_cap``
(the count stays exact, the list keeps the first rows).

The port runs with device="cpu" here: the plain version. The ``gpu`` tests
hold the ``seg_band`` CUDA kernel to its plain version on the card; they
import nothing of JAX, so on the card ``python -m pytest --noconftest -m
gpu tests/test_torch_seg_band.py`` runs them.
"""

import importlib
import threading

import numpy as np
import pytest
import torch

from geomesa_tpu_torch import config as tconfig
from geomesa_tpu_torch.features.geometry import GeometryArray
from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.filter.geom_numpy import literal_segments
from geomesa_tpu_torch.filter.parser import parse_ecql
from geomesa_tpu_torch.index import scan as tscan
from geomesa_tpu_torch.index.device import fp62
from geomesa_tpu_torch.index.planner import QueryPlanner as TPlanner
from geomesa_tpu_torch.index.spatial import XZ2Index as TXZ2
from geomesa_tpu_torch.index.spatial import XZ3Index as TXZ3
from geomesa_tpu_torch.index.spatial import _boxes_fp62 as t_fp62
from geomesa_tpu_torch.kernels import build as tbuild
from geomesa_tpu_torch.kernels import lookback as tlookback
from geomesa_tpu_torch.kernels import seg_band as tkernel

POLY = "POLYGON ((-12 30, 10 28, 14 44, -2 50, -12 30))"
RING = np.array([(-12.0, 30.0), (10.0, 28.0), (14.0, 44.0), (-2.0, 50.0),
                 (-12.0, 30.0)])
Q = f"INTERSECTS(geom, {POLY})"
DURING = "dtg DURING 2020-01-03T00:00:00Z/2020-01-15T00:00:00Z"
BSZ = 256


def _ref(name: str):
    """A module of the JAX package (imported only by the CPU tests)."""
    pytest.importorskip("jax")
    return importlib.import_module(name)


def random_segments(n: int, seed: int) -> np.ndarray:
    """(2n, 2) vertices of ``tests/test_band_intersects.py``'s layer."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-60, 60, n)
    y0 = rng.uniform(0, 70, n)
    coords = np.empty((2 * n, 2))
    coords[0::2, 0], coords[0::2, 1] = x0, y0
    coords[1::2, 0] = x0 + rng.uniform(-2, 2, n)
    coords[1::2, 1] = y0 + rng.uniform(-2, 2, n)
    return coords


def near_edge_segments(n: int, seed: int, ring=RING) -> np.ndarray:
    """(2n, 2) vertices of segments with an end within a few f32 ulps of a
    point of the ring's edges (or of a vertex), running off in a random
    direction for 1e-6 to 2 degrees, or along the edge: every
    orientation and crossing band of the classifier occurs."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, len(ring) - 1, n)
    t = rng.uniform(0, 1, n)
    t[: n // 10] = 0.0                       # on a vertex
    e1, e2 = ring[k], ring[k + 1]
    p = e1 + t[:, None] * (e2 - e1)
    ulp = np.spacing(np.abs(p).astype(np.float32)).astype(np.float64)
    a = p + rng.integers(-4, 5, (n, 2)) * ulp
    length = rng.choice([1e-6, 1e-4, 1e-2, 2.0], n)
    ang = rng.uniform(0, 2 * np.pi, n)
    d = np.stack([np.cos(ang), np.sin(ang)], 1) * length[:, None]
    along = rng.random(n) < 0.15
    d[along] = (e2 - e1)[along] * rng.uniform(-0.3, 0.3, along.sum())[:, None]
    b = a + d
    coords = np.empty((2 * n, 2))
    coords[0::2], coords[1::2] = a, b
    return coords


def _layer(coords, temporal: bool, seed: int):
    """Both packages' planners over one LineString layer (XZ3 with dtg and
    age when temporal, else XZ2)."""
    n = len(coords) // 2
    rng = np.random.default_rng(seed)
    spec = "*geom:LineString"
    cols = {}
    if temporal:
        spec = ("age:Int,dtg:Date,*geom:LineString;"
                "geomesa.z3.interval=week")
        base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
        cols = {"age": rng.integers(0, 100, n).astype(np.int32),
                "dtg": base + rng.integers(0, 30 * 86400000, n)}
    jgeo = _ref("geomesa_tpu.features.geometry")
    JSFT = _ref("geomesa_tpu.features.sft").SimpleFeatureType
    JTable = _ref("geomesa_tpu.features.table").FeatureTable
    jspatial = _ref("geomesa_tpu.index.spatial")
    JPlanner = _ref("geomesa_tpu.index.planner").QueryPlanner
    jsft = JSFT.from_spec("l", spec)
    jt = JTable.build(jsft, dict(
        cols, geom=jgeo.GeometryArray.linestrings(coords)))
    J = jspatial.XZ3Index if temporal else jspatial.XZ2Index
    jp = JPlanner(jsft, jt, [J(jsft, jt)])
    tsft = TSFT.from_spec("l", spec)
    tt = TTable.build(tsft, dict(cols,
                                 geom=GeometryArray.linestrings(coords)))
    T = TXZ3 if temporal else TXZ2
    tp = TPlanner(tsft, tt, [T(tsft, tt, "cpu")])
    return jp, tp


@pytest.fixture(scope="module")
def small_blocks():
    jconfig = _ref("geomesa_tpu.config")
    jprune = _ref("geomesa_tpu.index.prune")
    for k in ("BLOCK_SIZE", "PRUNE_MAX_FRACTION"):
        vars(jprune).pop(k, None)
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.set(BSZ)
        c.PRUNE_MAX_FRACTION.set(1.0)
    yield
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.unset()
        c.PRUNE_MAX_FRACTION.unset()


LAYERS = {
    "random": lambda: random_segments(40_000, 2),
    "near": lambda: np.concatenate([near_edge_segments(6_000, 3),
                                    random_segments(40_000, 4)]),
}


@pytest.fixture(scope="module")
def worlds(small_blocks):
    out = {}
    for name, make in LAYERS.items():
        coords = make()
        for temporal in (False, True):
            out[(name, temporal)] = _layer(coords, temporal, 7)
    return out


def _ref_raw(jk, primary, boxes, windows, residual, edges, blocks,
             unc_cap):
    """The reference program's raw [certain, n_uncertain, rows ...]."""
    jnp = _ref("jax.numpy")
    jscan = _ref("geomesa_tpu.index.scan")
    b = jk._pad_blocks(blocks)
    ne = max(4, 1 << max(0, (len(edges) - 1)).bit_length())
    ep = np.tile(jk._EDGE_PAD, (ne, 1))
    ep[: len(edges)] = edges
    fn = jk._get("intersects_band_blocks", primary, windows is not None,
                 residual[0] if residual else "none",
                 residual[2] if residual else None, boxes.shape[0],
                 0 if windows is None else windows.shape[0],
                 (b.shape[0], BSZ, 0, unc_cap, ne))
    rp = [jnp.asarray(p) for p in residual[1]] if residual else []
    return np.asarray(fn(jk.cols, jscan._dev(boxes), jscan._dev(windows),
                         rp, jnp.asarray(ep), jnp.asarray(b)))


def _edges(poly: str) -> np.ndarray:
    return literal_segments(parse_ecql(f"INTERSECTS(geom, {poly})")
                            .geometry).astype(np.float32)


# (layer, temporal, filter besides the polygon, unc_cap)
CASES = [
    ("random", False, None, 4096),
    ("near", False, None, 4096),
    ("near", False, None, 16),          # overflow past the cap
    ("random", True, DURING, 4096),     # windows
    ("near", True, "age > 40", 4096),   # a device residual
    ("near", True, f"{DURING} AND age > 40", 64),
]


@pytest.mark.parametrize("layer,temporal,extra,unc_cap", CASES)
def test_raw_band_vector_equals_reference(worlds, layer, temporal, extra,
                                          unc_cap):
    jp, tp = worlds[(layer, temporal)]
    f = Q if extra is None else f"{Q} AND {extra}"
    jplan, tplan = jp.plan(f), tp.plan(f)
    assert tplan.primary_kind == jplan.primary_kind == "bbox_overlap"
    assert np.array_equal(tplan.boxes_loose, jplan.boxes_loose)
    jb, tb = jp._pruned_blocks(jplan), tp._pruned_blocks(tplan)
    assert jb is not None and np.array_equal(jb, tb)
    assert jp.indexes[0].ensure_segment_columns()
    assert tp.indexes[0].ensure_segment_columns()
    edges = _edges(POLY)
    want = _ref_raw(jp.indexes[0].kernels, "bbox_overlap", jplan.boxes_loose,
                    jplan.windows, jplan.residual_device, edges, jb,
                    unc_cap)
    got = tp.indexes[0].kernels.prepare_intersects_band_blocks(
        "bbox_overlap", tplan.boxes_loose, tplan.windows,
        tplan.residual_device, edges, tb, BSZ, unc_cap)().numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert got[0] > 0
    if layer == "near":
        assert got[1] > 0                      # uncertain rows occur
    if unc_cap < 4096:
        assert got[1] > unc_cap                # and overflow the cap
    # the blocking form: (certain, positions or None past the cap)
    jc, ju = jp.indexes[0].kernels.intersects_band_blocks(
        "bbox_overlap", jplan.boxes_loose, jplan.windows,
        jplan.residual_device, edges, jb, BSZ, unc_cap)
    tc, tu = tp.indexes[0].kernels.intersects_band_blocks(
        "bbox_overlap", tplan.boxes_loose, tplan.windows,
        tplan.residual_device, edges, tb, BSZ, unc_cap)
    assert tc == jc
    assert (tu is None) == (ju is None)
    if tu is not None:
        assert np.array_equal(tu, ju)


# polygons whose edge counts pad differently: 3 real edges (pads to 4), 4
# (no pad), 5 (pads to 8), 9 (pads to 16)
POLYS = [
    "POLYGON ((-12 30, 10 28, 0 50, -12 30))",
    POLY,
    "POLYGON ((-12 30, 0 25, 10 28, 14 44, -2 50, -12 30))",
    "POLYGON ((-12 30, -5 26, 0 25, 5 26, 10 28, 14 44, 8 48, 3 49, -2 50, "
    "-12 30))",
]


@pytest.mark.parametrize("poly", POLYS)
def test_edge_padding_is_neutral(worlds, poly):
    """The reference pads the edge table with ``EDGE_PAD`` rows to a power
    of two; the plain version over the real rows only (what the kernel
    reads) gives the same vector, which equals the reference's."""
    jp, tp = worlds[("near", False)]
    q = f"INTERSECTS(geom, {poly})"
    jplan, tplan = jp.plan(q), tp.plan(q)
    blocks = tp._pruned_blocks(tplan)
    tp.indexes[0].ensure_segment_columns()
    jp.indexes[0].ensure_segment_columns()
    edges = _edges(poly)
    want = _ref_raw(jp.indexes[0].kernels, "bbox_overlap", jplan.boxes_loose,
                    None, None, edges, jp._pruned_blocks(jplan), 4096)
    k = tp.indexes[0].kernels
    cols = k.cols
    bid = torch.from_numpy(k._pad_blocks(blocks))
    boxes = torch.from_numpy(tplan.boxes_loose)
    ne = max(4, 1 << max(0, (len(edges) - 1)).bit_length())
    ep = np.tile(tscan.EDGE_PAD, (ne, 1))
    ep[: len(edges)] = edges
    full = tscan.seg_band(cols, boxes, None, None, bid, BSZ,
                          torch.from_numpy(ep), None, 4096)
    real = tscan.seg_band(cols, boxes, None, None, bid, BSZ,
                          torch.from_numpy(ep), len(edges), 4096)
    assert np.array_equal(full.numpy(), want)
    assert np.array_equal(real.numpy(), want)


@pytest.mark.parametrize("layer", list(LAYERS))
@pytest.mark.parametrize("temporal", [False, True])
def test_band_count_and_rows_equal_reference(worlds, layer, temporal):
    """The planner's band route (``_band_intersects_count``) and the
    public count and select against the reference's and against the exact
    f64 brute force. On the near-edge layer without a time filter the
    uncertain rows overflow the cap, and both packages decline the band
    (the host refines every candidate)."""
    jp, tp = worlds[(layer, temporal)]
    q = Q if not temporal else f"{Q} AND {DURING}"
    tplan = tp.plan(q)
    fast = tp._band_intersects_count(tplan)
    want = jp._band_intersects_count(jp.plan(q))
    assert fast == want
    overflow = layer == "near" and not temporal
    assert (fast is None) == overflow
    band = tplan.explain["band"]
    assert (band["uncertain"] is None) == overflow
    rows = tp.select_indices(q)
    assert np.array_equal(rows, jp.select_indices(q))
    assert tp.count(q) == jp.count(q) == len(rows)
    if fast is not None:
        assert fast == len(rows)
    from geomesa_tpu_torch.filter.evaluate import evaluate
    brute = np.flatnonzero(evaluate(parse_ecql(q), tp.table))
    assert np.array_equal(rows, brute)


def test_band_declines_for_multi_vertex_layers(small_blocks):
    """A layer with a three-vertex line declines the band (as the
    reference's does) and the host refine answers exactly."""
    coords = random_segments(5000, 9)
    shapes = [(2, [[0, 0], [1, 1], [2, 0]])] * 100 + [
        (2, coords[2 * i: 2 * i + 2].tolist()) for i in range(5000)]
    jgeo = _ref("geomesa_tpu.features.geometry")
    JSFT = _ref("geomesa_tpu.features.sft").SimpleFeatureType
    JTable = _ref("geomesa_tpu.features.table").FeatureTable
    JXZ2 = _ref("geomesa_tpu.index.spatial").XZ2Index
    JPlanner = _ref("geomesa_tpu.index.planner").QueryPlanner
    jsft = JSFT.from_spec("l", "*geom:LineString")
    jt = JTable.build(jsft, {"geom": jgeo.GeometryArray.from_shapes(shapes)})
    jp = JPlanner(jsft, jt, [JXZ2(jsft, jt)])
    tsft = TSFT.from_spec("l", "*geom:LineString")
    tt = TTable.build(tsft, {"geom": GeometryArray.from_shapes(shapes)})
    tp = TPlanner(tsft, tt, [TXZ2(tsft, tt, "cpu")])
    assert tp._band_intersects_count(tp.plan(Q)) is None
    assert jp._band_intersects_count(jp.plan(Q)) is None
    assert tp.count(Q) == jp.count(Q) > 0


# -- the CUDA kernel against its plain version (card only) --------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the seg_band kernel)")
    return torch.device("cuda")


def ring_edges(k: int) -> np.ndarray:
    """(k, 4) f32 edges of a closed k-gon around (1, 39)."""
    ang = np.linspace(0, 2 * np.pi, k + 1)
    r = 12 + 3 * np.sin(5 * ang)
    ring = np.stack([1 + r * np.cos(ang), 39 + r * np.sin(ang)], 1)
    ring[-1] = ring[0]
    return np.concatenate([ring[:-1], ring[1:]], 1).astype(np.float32)


def gpu_table(coords: np.ndarray, dev, seed: int):
    """Device columns of a segment table in table order: the fp62 envelope
    planes, the f32 segment planes, binned time, a sparse __valid__."""
    rng = np.random.default_rng(seed)
    n = len(coords) // 2
    a, b = coords[0::2], coords[1::2]
    cols = {}
    for name, v, lo, hi in (
            ("bxmin", np.minimum(a[:, 0], b[:, 0]), -180.0, 180.0),
            ("bymin", np.minimum(a[:, 1], b[:, 1]), -90.0, 90.0),
            ("bxmax", np.maximum(a[:, 0], b[:, 0]), -180.0, 180.0),
            ("bymax", np.maximum(a[:, 1], b[:, 1]), -90.0, 90.0)):
        cols[name + "_i"], cols[name + "_l"] = fp62(v, lo, hi)
    for name, v in (("sx1", a[:, 0]), ("sy1", a[:, 1]), ("sx2", b[:, 0]),
                    ("sy2", b[:, 1])):
        cols[name] = v.astype(np.float32)
    cols["bin"] = rng.integers(2600, 2606, n).astype(np.int32)
    cols["off"] = rng.integers(0, 604800, n).astype(np.int32)
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
           for k, v in cols.items()}
    return out, rng.random(n) < 0.9


def _gpu_args(n, where, windows, resid, valid, nbox, seed, near=True):
    dev = _cuda()
    coords = near_edge_segments(n, seed) if near \
        else random_segments(n, seed)
    cols, vmask = gpu_table(coords, dev, seed)
    if valid:
        cols["__valid__"] = torch.from_numpy(vmask).to(dev)
    boxes = [(-12.0, 28.0, 14.0, 50.0)] + [
        (-60.0 + 7 * i, 0.0 + 5 * i, -50.0 + 7 * i, 8.0 + 5 * i)
        for i in range(nbox - 1)]
    b = torch.from_numpy(tscan.pad_boxes(t_fp62(boxes))).to(dev)
    last = -(-n // BSZ) - 1
    blocks = {"all": np.arange(0, last + 1, dtype=np.int32),
              "every3": np.arange(0, last + 1, 3, dtype=np.int32),
              "edge": np.array([0, 3, last - 1, last, last + 5, last + 90],
                               dtype=np.int32)}[where]
    nb = max(8, 1 << max(0, len(blocks) - 1).bit_length())
    pad = np.full(nb, -1, dtype=np.int32)
    pad[: len(blocks)] = blocks
    bid = torch.from_numpy(pad).to(dev)
    w = None
    if windows:
        w = torch.tensor([[2601, 1000, 2603, 500], [2605, 7, 2605, 90000],
                          [1, 0, 0, 0], [1, 0, 0, 0]], dtype=torch.int32,
                         device=dev)
    r = None
    if resid:
        rng = np.random.default_rng(seed + 1)
        r = torch.from_numpy(rng.random(nb * BSZ) < 0.7).to(dev)
    return cols, b, w, r, bid


def _check_equal(cols, b, w, r, bid, edges, n_edges, unc_cap):
    before = tkernel.seg_band.launches
    got = tkernel.seg_band(cols, b, w, r, bid, BSZ, edges, n_edges, unc_cap)
    torch.cuda.synchronize()
    plain = tscan.seg_band(cols, b, w, r, bid, BSZ, edges, n_edges, unc_cap)
    assert got.dtype == torch.int32 and got.shape == plain.shape
    assert torch.equal(got, plain), (got[:8], plain[:8])
    assert tkernel.seg_band.launches == before + 1
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("n", [5000, 3 * (1 << 18) + 17])
@pytest.mark.parametrize("where", ["all", "every3", "edge"])
@pytest.mark.parametrize("windows,resid,valid", [
    (False, False, False), (True, False, False), (False, True, False),
    (True, True, True)])
@pytest.mark.parametrize("nbox", [1, 3])
def test_cuda_seg_band_equals_plain(n, where, windows, resid, valid, nbox):
    cols, b, w, r, bid = _gpu_args(n, where, windows, resid, valid, nbox,
                                   seed=n % 97 + nbox)
    edges = torch.from_numpy(_edges(POLY)).to(cols["sx1"].device)
    got = _check_equal(cols, b, w, r, bid, edges, None, 4096)
    assert int(got[0]) > 0
    if not windows:
        assert int(got[1]) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("k", [0, 3, 4, 5, 64, 1023, 1024, 1025, 2500, 4100])
def test_cuda_seg_band_edge_counts_equal_plain(k):
    """Real edge counts from none to past the staged 1,024 (1,025, 2,500
    and 4,100 stream through two tiles of 512 by cp.async), with EDGE_PAD
    filler rows behind them (the kernel reads the real ones only)."""
    cols, b, w, r, bid = _gpu_args(20_000, "all", False, False, False, 1,
                                   seed=k)
    dev = cols["sx1"].device
    real = ring_edges(max(k, 3))[:k]
    ne = max(4, 1 << max(0, k - 1).bit_length())
    ep = np.tile(tscan.EDGE_PAD, (ne, 1))
    ep[:k] = real
    _check_equal(cols, b, w, r, bid, torch.from_numpy(ep).to(dev), k, 4096)


@pytest.mark.gpu
@pytest.mark.parametrize("unc_cap", [0, 1, 7, 4096, 1 << 16])
def test_cuda_seg_band_cap_equals_plain(unc_cap):
    """The uncertain list at caps from none to past every uncertain row: the
    count stays exact, the list keeps the first rows in candidate order."""
    cols, b, w, r, bid = _gpu_args(200_000, "all", False, False, False, 1,
                                   seed=5)
    edges = torch.from_numpy(_edges(POLY)).to(cols["sx1"].device)
    got = _check_equal(cols, b, w, r, bid, edges, None, unc_cap)
    assert int(got[1]) > 7


@pytest.mark.gpu
def test_cuda_band_count_equals_cpu():
    """The planner's band count and rows on the card against the CPU
    (blocks of 256 rows, so that the range cover prunes this table)."""
    _cuda()
    from geomesa_tpu_torch.datastore import DataStoreFinder
    coords = np.concatenate([near_edge_segments(2_000, 11),
                             random_segments(100_000, 12)])
    out = {}
    tconfig.PRUNE_BLOCK.set(BSZ)
    try:
        for device in ("cpu", "cuda"):
            store = DataStoreFinder.get_data_store(type="torch",
                                                   device=device)
            store.create_schema("l", "*geom:LineString")
            sft = store.get_schema("l")
            store.load("l", TTable.build(
                sft, {"geom": GeometryArray.linestrings(coords)}))
            before = tkernel.seg_band.launches
            out[device] = (store.count("l", Q), store.query("l", Q).indices,
                           tkernel.seg_band.launches - before)
    finally:
        tconfig.PRUNE_BLOCK.unset()
    assert out["cuda"][0] == out["cpu"][0] > 0
    assert np.array_equal(out["cuda"][1], out["cpu"][1])
    assert out["cuda"][2] == 1 and out["cpu"][2] == 0


# -- the wrapper's input rules (CPU) ------------------------------------------


def _small_inputs():
    """Valid CPU inputs of the wrapper: 600 near-edge segments in blocks of
    BSZ rows, windows, a residual and __valid__."""
    coords = near_edge_segments(600, 21)
    cols, vmask = gpu_table(coords, "cpu", 21)
    cols["__valid__"] = torch.from_numpy(vmask)
    boxes = torch.from_numpy(tscan.pad_boxes(t_fp62(
        [(-12.0, 28.0, 14.0, 50.0)])))
    bid = torch.tensor([0, 2, 1, -1], dtype=torch.int32)
    w = torch.tensor([[2600, 0, 2606, 0]], dtype=torch.int32)
    resid = torch.from_numpy(
        np.random.default_rng(22).random(4 * BSZ) < 0.8)
    edges = torch.from_numpy(_edges(POLY))
    return dict(cols=cols, boxes=boxes, windows=w, resid=resid,
                block_ids=bid, bsz=BSZ, edges=edges, n_edges=None,
                unc_cap=64)


def _replace_col(kw, name, t):
    kw["cols"] = dict(kw["cols"], **{name: t})


# every rule of kernels/seg_band.py _check, and the device rule after it
BAD_INPUTS = {
    "envelope_dtype": lambda kw: _replace_col(
        kw, "bxmin_i", kw["cols"]["bxmin_i"].long()),
    "envelope_rows": lambda kw: _replace_col(
        kw, "bymax_l", kw["cols"]["bymax_l"][:-1].clone()),
    "time_dtype": lambda kw: _replace_col(
        kw, "bin", kw["cols"]["bin"].float()),
    "time_rows": lambda kw: _replace_col(
        kw, "off", kw["cols"]["off"][1:].clone()),
    "segment_dtype": lambda kw: _replace_col(
        kw, "sx2", kw["cols"]["sx2"].double()),
    "segment_rows": lambda kw: _replace_col(
        kw, "sy1", kw["cols"]["sy1"][:10].clone()),
    "boxes_dtype": lambda kw: kw.update(boxes=kw["boxes"].long()),
    "boxes_shape": lambda kw: kw.update(boxes=kw["boxes"][:, :4].clone()),
    "boxes_dims": lambda kw: kw.update(boxes=kw["boxes"].reshape(-1)),
    "windows_dtype": lambda kw: kw.update(windows=kw["windows"].long()),
    "windows_shape": lambda kw: kw.update(windows=kw["windows"][:, :3]
                                          .clone()),
    "edges_dtype": lambda kw: kw.update(edges=kw["edges"].double()),
    "edges_shape": lambda kw: kw.update(edges=kw["edges"][:, :2].clone()),
    "n_edges_high": lambda kw: kw.update(n_edges=kw["edges"].shape[0] + 1),
    "n_edges_negative": lambda kw: kw.update(n_edges=-1),
    "block_ids_dtype": lambda kw: kw.update(block_ids=kw["block_ids"]
                                            .long()),
    "block_ids_dims": lambda kw: kw.update(block_ids=kw["block_ids"]
                                           .reshape(2, 2)),
    "bsz_zero": lambda kw: kw.update(bsz=0),
    "bsz_none": lambda kw: kw.update(bsz=None),
    "unc_cap_negative": lambda kw: kw.update(unc_cap=-1),
    "valid_dtype": lambda kw: _replace_col(
        kw, "__valid__", kw["cols"]["__valid__"].to(torch.uint8)),
    "valid_rows": lambda kw: _replace_col(
        kw, "__valid__", kw["cols"]["__valid__"][:-3].clone()),
    "resid_dtype": lambda kw: kw.update(resid=kw["resid"].to(torch.uint8)),
    "resid_rows": lambda kw: kw.update(resid=kw["resid"][:-1].clone()),
    "column_strided": lambda kw: _replace_col(
        kw, "sx1", torch.stack([kw["cols"]["sx1"]] * 2, 1)[:, 0]),
    "envelope_strided": lambda kw: _replace_col(
        kw, "bxmax_l", torch.stack([kw["cols"]["bxmax_l"]] * 2, 1)[:, 1]),
    "block_ids_strided": lambda kw: kw.update(
        block_ids=torch.stack([kw["block_ids"]] * 2, 1)[:, 0]),
    "edges_strided": lambda kw: kw.update(
        edges=torch.cat([kw["edges"]] * 2, 1)[:, :4]),
    "column_other_device": lambda kw: _replace_col(
        kw, "bymin_i", kw["cols"]["bymin_i"].to("meta")),
    "resid_other_device": lambda kw: kw.update(resid=kw["resid"]
                                               .to("meta")),
    "all_on_meta": lambda kw: kw.update(
        cols={k: v.to("meta") for k, v in kw["cols"].items()},
        **{k: kw[k].to("meta") for k in ("boxes", "windows", "resid",
                                         "block_ids", "edges")}),
}


def test_wrapper_cpu_runs_plain_and_counts_nothing():
    kw = _small_inputs()
    before = tkernel.seg_band.launches
    got = tkernel.seg_band(**kw)
    want = tscan.seg_band(**kw)
    assert torch.equal(got, want) and int(got[0]) > 0
    assert tkernel.seg_band.launches == before
    assert tkernel.REPLACES == "geomesa_tpu/index/scan.py:754"


@pytest.mark.parametrize("bad", sorted(BAD_INPUTS))
def test_wrapper_rejects_bad_inputs(bad):
    kw = _small_inputs()
    BAD_INPUTS[bad](kw)
    with pytest.raises((TypeError, ValueError)):
        tkernel.seg_band(**kw)


# -- the one-launch design on the card: workspace reuse, streams, no
# candidates ------------------------------------------------------------------


@pytest.mark.gpu
def test_cuda_seg_band_back_to_back_calls_share_a_workspace():
    """Calls on one stream without a sync between them, with candidate
    counts and caps that shrink, then grow: the status words a larger call
    left behind must not leak into a smaller one (each call has its own
    epoch), nor the ticket, the done counter or the totals."""
    cols, b, w, r, _ = _gpu_args(300_000, "all", False, False, False, 1,
                                 seed=31)
    dev = cols["sx1"].device
    edges = torch.from_numpy(_edges(POLY)).to(dev)
    last = -(-300_000 // BSZ) - 1
    plan = [(np.arange(0, last + 1), 4096), (np.arange(0, 40), 16),
            (np.arange(0, 0), 8), (np.arange(3, 9), 1),
            (np.arange(0, last + 1, 2), 1 << 16),
            (np.arange(0, last + 1), 7), (np.arange(100, 130), 4096)]
    before = tkernel.seg_band.launches
    outs = []
    for blocks, cap in plan:
        bid = torch.from_numpy(blocks.astype(np.int32)).to(dev)
        outs.append((bid, cap, tkernel.seg_band(cols, b, None, None, bid,
                                                 BSZ, edges, None, cap)))
    torch.cuda.synchronize()
    assert tkernel.seg_band.launches == before + len(plan)
    for bid, cap, got in outs:
        want = tscan.seg_band(cols, b, None, None, bid, BSZ, edges, None,
                              cap)
        assert torch.equal(got, want), (cap, got[:4], want[:4])
    assert int(outs[0][2][1]) > 4096 and int(outs[2][2][1]) == 0


@pytest.mark.gpu
def test_cuda_seg_band_threads_grow_one_workspace():
    """Two threads on one stream, each with calls of growing candidate
    counts, so that one grows the stream's workspace while the other may
    hold the one it replaces, not yet launched; each call then allocates
    a block of the workspace's size and fills it, so a freed workspace
    that a pending launch still used would be overwritten. Every result
    equals the plain version."""
    cols, b, _, _, _ = _gpu_args(300_000, "all", False, False, False, 1,
                                 seed=37)
    dev = cols["sx1"].device
    edges = torch.from_numpy(_edges(POLY)).to(dev)
    bsz = 4096
    nblk = -(-300_000 // bsz)
    sizes = [200, 300, 600, 1200, 2400]   # blocks: 800 to 9,600 chunks
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    key = (dev.index, stream.cuda_stream)
    start = threading.Barrier(2)
    outs = [[], []]
    errors = []
    seen = set()

    def run(t):
        try:
            with torch.cuda.stream(stream):
                seen.add(tbuild.raw_stream(dev))
                start.wait()
                for nb in sizes:
                    bid = torch.from_numpy(np.resize(
                        np.arange(nblk, dtype=np.int32), nb + t)).to(dev)
                    got = tkernel.seg_band(cols, b, None, None, bid, bsz,
                                           edges, None, 64)
                    torch.full((4 + 4 * nb,), -1, dtype=torch.int64,
                               device=dev)
                    outs[t].append((bid, got))
        except Exception as e:   # re-raised in the test's thread
            errors.append(e)

    for _ in range(3):
        with tlookback._LOCK:
            tlookback._WS.pop(key, None)
        threads = [threading.Thread(target=run, args=(t,)) for t in (0, 1)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        torch.cuda.synchronize()
        assert not errors, errors
        assert seen == {stream.cuda_stream}
        assert tlookback._WS[key][1] >= 4 * (sizes[-1] + 1)
    for bid, got in outs[0] + outs[1]:
        want = tscan.seg_band(cols, b, None, None, bid, bsz, edges, None, 64)
        assert torch.equal(got, want), (got[:4], want[:4])
    assert len(outs[0]) == len(outs[1]) == 3 * len(sizes)


@pytest.mark.gpu
def test_cuda_seg_band_on_two_streams():
    """Calls interleaved on two streams (a workspace each) equal the plain
    version."""
    cols, b, w, r, bid = _gpu_args(200_000, "all", True, True, True, 3,
                                   seed=33)
    dev = cols["sx1"].device
    edges = torch.from_numpy(_edges(POLY)).to(dev)
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
    args = [(bid, 4096), (bid[: len(bid) // 2].clone(), 32)]
    outs = []
    for rep in range(4):
        for s, (bids, cap) in zip(streams, args):
            with torch.cuda.stream(s):
                resid = r[: len(bids) * BSZ].clone()
                outs.append((bids, resid, cap, tkernel.seg_band(
                    cols, b, w, resid, bids, BSZ, edges, None, cap)))
    torch.cuda.synchronize()
    for bids, resid, cap, got in outs:
        want = tscan.seg_band(cols, b, w, resid, bids, BSZ, edges, None, cap)
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("blocks", ["none", "pad_only"])
@pytest.mark.parametrize("unc_cap", [0, 5])
def test_cuda_seg_band_without_candidates(blocks, unc_cap):
    """No candidate (an empty block list) or none live (pad blocks only):
    the counts are 0 and the list is all padding."""
    cols, b, w, r, _ = _gpu_args(5000, "all", False, False, False, 1, seed=35)
    dev = cols["sx1"].device
    bid = torch.full((0 if blocks == "none" else 8,), -1, dtype=torch.int32,
                     device=dev)
    edges = torch.from_numpy(_edges(POLY)).to(dev)
    got = _check_equal(cols, b, None, None, bid, edges, None, unc_cap)
    assert got[:2].tolist() == [0, 0]


@pytest.mark.gpu
@pytest.mark.parametrize("bsz", [300, 1000, 1500, 4096, 5000])
def test_cuda_seg_band_block_sizes(bsz):
    """Block sizes past the power-of-two ones (a candidate's block by a
    shift): under the 1,024-candidate chunk (a 32-bit division) and over
    it (a chunk spans at most two blocks), with clamped and pad blocks."""
    dev = _cuda()
    n = 60_000
    cols, _ = gpu_table(near_edge_segments(n, 41), dev, 41)
    last = -(-n // bsz) - 1
    bid = torch.tensor(list(range(0, last + 1, 2)) + [last, last + 3, -1],
                       dtype=torch.int32, device=dev)
    boxes = torch.from_numpy(tscan.pad_boxes(t_fp62(
        [(-12.0, 28.0, 14.0, 50.0)]))).to(dev)
    edges = torch.from_numpy(_edges(POLY)).to(dev)
    for cap in (16, 4096):
        before = tkernel.seg_band.launches
        got = tkernel.seg_band(cols, boxes, None, None, bid, bsz, edges,
                               None, cap)
        torch.cuda.synchronize()
        want = tscan.seg_band(cols, boxes, None, None, bid, bsz, edges, None,
                              cap)
        assert torch.equal(got, want) and int(got[1]) > 0
        assert tkernel.seg_band.launches == before + 1
