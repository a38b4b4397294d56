"""The point-in-polygon join (``geomesa_tpu_torch/parallel/join.py``) and its
kernel (``kernels/pip_join.py``) against the JAX package's
``parallel/join.py``.

Inputs:
- ``tests/test_parallel.py``'s unsharded ``TestSpatialJoin`` inputs (2,000
  seeded points against a box, a triangle and a box with a hole; four
  points against two polygons);
- a boundary-heavy set: for every edge of three star polygons (one with a
  hole), points whose recentred x is the crossing's ``fma(t, x2 - x1, x1)``,
  its product-then-sum value and their f32 neighbours, and points on the
  vertices' y. The reference's answer is the fused multiply-add's (XLA on
  the CPU contracts ``x1 + t * (x2 - x1)``): the separate product and sum
  answer otherwise on these points, which the test shows;
- 1,000 seeded points against all 32 polygons of ``perf/polygons_complex.json``
  (half of them drawn in the polygons' bboxes);
- a random mask over each.

``PackedPolygons`` arrays are held byte for byte; ``counts`` and ``assign``
exactly (the reference's own tests allow ±2 against f64; the port against
the reference allows 0). The port runs with device="cpu" (the kernel's
plain version). ``sharded=`` raises naming ROADMAP item 14.

The ``gpu`` tests hold ``pip_join`` (COUNTS and ASSIGN) to its plain version
on the card bit for bit, on the same inputs, masked points, 100,003 points
(tiles and a ragged tail) and a polygon of 5,000 edges (edge tiles); they
import nothing of JAX (``python -m pytest --noconftest -m gpu
tests/test_torch_join.py`` on the card).
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch

from geomesa_tpu_torch.arith import fma
from geomesa_tpu_torch.features import geometry as tgeo
from geomesa_tpu_torch.filter import geom_numpy as gn
from geomesa_tpu_torch.kernels import pip_join as kpip
from geomesa_tpu_torch.parallel import join as tjoin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BASIC = [
    "POLYGON ((-40 -40, -10 -40, -10 -10, -40 -10, -40 -40))",
    "POLYGON ((0 0, 30 0, 15 25, 0 0))",
    "POLYGON ((-5 -5, 5 -5, 5 5, -5 5, -5 -5), (-2 -2, 2 -2, 2 2, -2 2, "
    "-2 -2))",
]


def _ref(name: str):
    """A module of the JAX package (imported only by the CPU tests)."""
    pytest.importorskip("jax")
    return importlib.import_module(name)


def _star(cx, cy, k, seed, hole=False):
    rng = np.random.default_rng(seed)
    ang = np.sort(rng.uniform(0, 2 * np.pi, k))
    r = rng.uniform(2.0, 8.0, k)
    ring = [[float(cx + r[i] * np.cos(ang[i])),
             float(cy + r[i] * np.sin(ang[i]))] for i in range(k)]
    ring.append(ring[0])
    rings = [ring]
    if hole:
        h = [[cx - 0.7, cy - 0.5], [cx + 0.6, cy - 0.6], [cx + 0.5, cy + 0.7],
             [cx - 0.6, cy + 0.4]]
        rings.append(h + [h[0]])
    return (tgeo.POLYGON, rings)


def _complex():
    with open(os.path.join(REPO, "perf", "polygons_complex.json")) as fh:
        pc = json.load(fh)
    return [(int(code), rings) for code, rings in pc["polygons"]]


def _recentred_to_original(v: np.ndarray, c: np.float32) -> np.ndarray:
    """f32 values px with fl(px - c) == v (a few ulps searched); NaN where
    none is found."""
    out = np.full(v.shape, np.nan, dtype=np.float32)
    guess = (v + c).astype(np.float32)
    for k in range(-3, 4):
        cand = guess
        step = np.float32(np.inf) if k > 0 else np.float32(-np.inf)
        for _ in range(abs(k)):
            cand = np.nextafter(cand, step)
        ok = np.isnan(out) & ((cand - c).astype(np.float32) == v)
        out[ok] = cand[ok]
    return out


def _boundary_points(polys):
    """(px, py) f32 on the crossings of every edge (see the module doc)."""
    pk = tjoin.PackedPolygons.pack(polys)
    c = pk.center.astype(np.float32)
    xs, ys = [], []
    rng = np.random.default_rng(5)
    for p in range(pk.n):
        e = np.concatenate([pk.edges_a[p], pk.edges_b[p]], 1)[pk.valid[p]]
        x1, y1, x2, y2 = e.T
        live = y1 != y2
        for u in (0.25, 0.5, 0.75):
            pyc = (y1 + (y2 - y1).astype(np.float32) * np.float32(u)
                   ).astype(np.float32)[live]
            ex1, ey1, ex2, ey2 = x1[live], y1[live], x2[live], y2[live]
            t = ((pyc - ey1).astype(np.float32)
                 / (ey2 - ey1).astype(np.float32)).astype(np.float32)
            dx = (ex2 - ex1).astype(np.float32)
            fused = fma(torch.from_numpy(t), torch.from_numpy(dx),
                        torch.from_numpy(ex1)).numpy()
            split = (ex1 + (t * dx).astype(np.float32)).astype(np.float32)
            for v in (fused, split):
                for d in (-np.inf, None, np.inf):
                    xs.append(v if d is None else np.nextafter(
                        v, np.float32(d)))
                    ys.append(pyc)
        # on the vertices' y, x across the polygon
        bb = pk.bboxes[p]
        xs.append(rng.uniform(bb[0], bb[2], len(y1)).astype(np.float32)
                  - c[0])
        ys.append(y1)
    pxc = np.concatenate(xs).astype(np.float32)
    pyc = np.concatenate(ys).astype(np.float32)
    px = _recentred_to_original(pxc, c[0])
    py = _recentred_to_original(pyc, c[1])
    keep = ~np.isnan(px) & ~np.isnan(py)
    return px[keep], py[keep]


def _split_counts(polys, px, py):
    """Per-polygon counts with x1 + t * (x2 - x1) as a product and a sum
    (numpy f32; the inputs have no subnormal)."""
    pk = tjoin.PackedPolygons.pack(polys)
    c = pk.center.astype(np.float32)
    pxc, pyc = (px - c[0]).astype(np.float32), (py - c[1]).astype(np.float32)
    out = []
    for p in range(pk.n):
        bb = pk.bboxes[p]
        inb = (px >= bb[0]) & (px <= bb[2]) & (py >= bb[1]) & (py <= bb[3])
        e = np.concatenate([pk.edges_a[p], pk.edges_b[p]], 1)[pk.valid[p]]
        x1, y1, x2, y2 = (v[None, :] for v in e.T)
        q = pyc[:, None]
        cond = (y1 > q) != (y2 > q)
        den = np.where(y2 == y1, np.float32(1), (y2 - y1).astype(np.float32))
        t = ((q - y1).astype(np.float32) / den).astype(np.float32)
        xint = (x1 + (t * (x2 - x1).astype(np.float32)).astype(np.float32)
                ).astype(np.float32)
        par = (cond & (pxc[:, None] < xint)).sum(1) % 2 == 1
        out.append(int((par & inb).sum()))
    return np.asarray(out)


def _cases():
    """name → (polygon literals, px, py) of the CPU tests."""
    rng = np.random.default_rng(99)
    basic = [tgeo.parse_wkt(w) for w in BASIC]
    stars = [_star(10.0, 5.0, 24, 1), _star(-3.0, 12.0, 17, 2, hole=True),
             _star(4.0, -6.0, 40, 3)]
    bx, by = _boundary_points(stars)
    cplx = _complex()
    crng = np.random.default_rng(1234)
    ux = crng.uniform(-120, 140, 500)
    uy = crng.uniform(-40, 60, 500)
    pick = crng.integers(0, len(cplx), 500)
    bbs = np.asarray([gn.literal_bbox(p) for p in cplx])[pick]
    ix = bbs[:, 0] + crng.uniform(0, 1, 500) * (bbs[:, 2] - bbs[:, 0])
    iy = bbs[:, 1] + crng.uniform(0, 1, 500) * (bbs[:, 3] - bbs[:, 1])
    return {
        "basic": (basic, rng.uniform(-50, 50, 2000).astype(np.float32),
                  rng.uniform(-50, 50, 2000).astype(np.float32)),
        "assign4": (basic[:2],
                    np.array([-20.0, 10.0, 0.0, 60.0], dtype=np.float32),
                    np.array([-20.0, 5.0, 0.0, 60.0], dtype=np.float32)),
        "boundary": (stars, bx, by),
        "complex": (cplx, np.concatenate([ux, ix]).astype(np.float32),
                    np.concatenate([uy, iy]).astype(np.float32)),
    }


CASES = ("basic", "assign4", "boundary", "complex")


@pytest.fixture(scope="module")
def cases():
    return _cases()


def _ref_join(polys):
    return _ref("geomesa_tpu.parallel.join").SpatialJoin(polys)


@pytest.mark.parametrize("case", CASES)
def test_packed_polygons_equal_reference(cases, case):
    polys = cases[case][0]
    want = _ref_join(polys).packed
    got = tjoin.PackedPolygons.pack(polys)
    for f in ("edges_a", "edges_b", "valid", "bboxes", "center"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert got.n == want.n


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("masked", [False, True])
def test_counts_and_assign_equal_reference(cases, case, masked):
    polys, px, py = cases[case]
    mask = None
    if masked:
        mask = np.random.default_rng(7).random(len(px)) < 0.7
    jj = _ref_join(polys)
    tj = tjoin.SpatialJoin(polys, device="cpu")
    jm = None if mask is None else mask
    want_c = np.asarray(jj.counts(px, py, jm))
    want_a = np.asarray(jj.assign(px, py, jm))
    got_c = tj.counts(px, py, mask)
    got_a = tj.assign(px, py, mask)
    assert got_c.dtype == torch.int32 and got_a.dtype == torch.int32
    assert np.array_equal(got_c.numpy(), want_c)
    assert np.array_equal(got_a.numpy(), want_a)
    if case == "assign4" and not masked:
        assert got_a.numpy()[[0, 1, 3]].tolist() == [0, 1, -1]
    if case in ("basic", "complex"):
        assert got_c.numpy().sum() > 0


@pytest.mark.parametrize("case", ["basic", "complex"])
def test_host_float64_points_equal_reference(cases, case):
    """f64 numpy points (values no f32 holds) compute in f32 on both
    sides: the reference's jit casts them, the port's entry point too."""
    polys, px, py = cases[case]
    rng = np.random.default_rng(11)
    x64 = px.astype(np.float64) + rng.uniform(-1e-3, 1e-3, len(px))
    y64 = py.astype(np.float64) + rng.uniform(-1e-3, 1e-3, len(py))
    jj = _ref_join(polys)
    tj = tjoin.SpatialJoin(polys, device="cpu")
    got_c, got_a = tj.counts(x64, y64), tj.assign(x64, y64)
    assert got_c.dtype == torch.int32 and got_a.dtype == torch.int32
    assert np.array_equal(got_c.numpy(), np.asarray(jj.counts(x64, y64)))
    assert np.array_equal(got_a.numpy(), np.asarray(jj.assign(x64, y64)))
    assert torch.equal(got_c, tj.counts(x64.astype(np.float32),
                                        y64.astype(np.float32)))


def test_boundary_points_settle_the_fused_multiply_add(cases):
    """On points at the crossings the reference's counts are the fused
    multiply-add's: a product and a sum answer otherwise, the port as the
    reference."""
    polys, px, py = cases["boundary"]
    want = np.asarray(_ref_join(polys).counts(px, py))
    assert len(px) > 500
    assert not np.array_equal(_split_counts(polys, px, py), want)
    got = tjoin.SpatialJoin(polys, device="cpu").counts(px, py).numpy()
    assert np.array_equal(got, want)


def test_tensors_stay_on_their_device(cases):
    polys, px, py = cases["basic"]
    tj = tjoin.SpatialJoin(polys, device="cpu")
    got = tj.counts(torch.from_numpy(px), torch.from_numpy(py))
    assert got.device.type == "cpu"
    assert torch.equal(got, tj.counts(px, py))


def test_sharded_join_names_item_14(cases):
    polys, px, py = cases["basic"]
    tj = tjoin.SpatialJoin(polys, device="cpu")
    for call in (tj.counts, tj.assign):
        with pytest.raises(NotImplementedError, match="item 14"):
            call(px, py, sharded=object())


def test_wrapper_checks_its_inputs(cases):
    polys, px, py = cases["basic"]
    bufs = tjoin.PackedPolygons.pack(polys).tables("cpu")
    x, y = torch.from_numpy(px), torch.from_numpy(py)
    with pytest.raises(TypeError):
        kpip.pip_join(x.double(), y, None, *bufs)
    with pytest.raises(TypeError):
        kpip.pip_join(x, y, torch.ones(3, dtype=torch.bool), *bufs)
    with pytest.raises(TypeError):
        kpip.pip_join(x, y, None, bufs[0], bufs[1].long(), *bufs[2:])
    before = kpip.pip_join.launches
    kpip.pip_join(x, y, None, *bufs)
    assert kpip.pip_join.launches == before  # the CPU runs the plain version


def test_port_has_no_jax_import():
    """No module of the port imports JAX or the JAX package."""
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|geomesa_tpu)\b", re.M)
    root = os.path.join(REPO, "geomesa_tpu_torch")
    bad = []
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                with open(path) as fh:
                    if pat.search(fh.read()):
                        bad.append(path)
    assert not bad, bad
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        assert not pat.search(fh.read())


# -- the CUDA kernel against its plain version (card only) ------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the pip_join kernel)")
    return torch.device("cuda")


def _gpu_cases():
    out = {k: v for k, v in _cases().items()}
    rng = np.random.default_rng(11)
    out["tiles"] = ([_star(0.0, 0.0, 64, 4), _star(3.0, 2.0, 33, 5,
                                                   hole=True)],
                    rng.uniform(-10, 10, 100_003).astype(np.float32),
                    rng.uniform(-10, 10, 100_003).astype(np.float32))
    out["long_ring"] = ([_star(1.0, 1.0, 5000, 6), _star(0.0, 0.0, 12, 7)],
                        rng.uniform(-9, 9, 20_000).astype(np.float32),
                        rng.uniform(-9, 9, 20_000).astype(np.float32))
    return out


GPU_CASES = CASES + ("tiles", "long_ring")


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("assign", [False, True])
def test_cuda_pip_join_equals_plain(case, masked, assign):
    dev = _cuda()
    polys, px, py = _gpu_cases()[case]
    mask = None
    if masked:
        mask = torch.from_numpy(
            np.random.default_rng(7).random(len(px)) < 0.7).to(dev)
    bufs = tjoin.PackedPolygons.pack(polys).tables(dev)
    x, y = torch.from_numpy(px).to(dev), torch.from_numpy(py).to(dev)
    before = kpip.pip_join.launches
    got = kpip.pip_join(x, y, mask, *bufs, assign=assign)
    torch.cuda.synchronize()
    assert kpip.pip_join.launches == before + 1
    plain = tjoin.assign if assign else tjoin.contains_matrix
    want = plain(x, y, mask, *bufs)
    assert torch.equal(got, want)
    cpu = plain(x.cpu(), y.cpu(), None if mask is None else mask.cpu(),
                *(b.cpu() for b in bufs))
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.gpu
def test_cuda_spatial_join_defaults_to_the_card():
    _cuda()
    polys, px, py = _gpu_cases()["basic"]
    tj = tjoin.SpatialJoin(polys)
    before = kpip.pip_join.launches
    got = tj.counts(px, py)
    assert got.device.type == "cuda"
    assert kpip.pip_join.launches == before + 1
    assert torch.equal(got.cpu(), tjoin.SpatialJoin(polys, device="cpu")
                       .counts(px, py))
