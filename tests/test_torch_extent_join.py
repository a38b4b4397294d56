"""The extent×extent join (``geomesa_tpu_torch/parallel/extent_join.py``,
``parallel/pair_kernel.py``) and the ``pair_band`` kernel against the JAX
package's ``parallel/extent_join.py`` and ``parallel/pair_kernel.py``.

Inputs: every single-device test of ``tests/test_extent_join.py`` (seeded
lines of span 2 and octagons; candidate pairs, their dedup and chunked
streaming; host and device joins of lines × polygons and lines × lines;
nested polygons; a MULTILINESTRING whose second part lies inside a polygon;
the decline for points; the partitioned join; an empty side), and pairs
built on the edge of a certainty band (a segment pair's orientation and a
first vertex's crossing, each within an ulp or two of its ``tol``, where
the fused band XLA makes of ``_orient_band`` jitted alone would answer
otherwise) and with subnormal coordinates, built from the same numpy arrays
in both packages. Every pair list equals the
reference's; the raw packed verdicts of ``prepare_refine(...).dispatch()``
equal the reference's ``_pair_fn`` chunks byte for byte, pad bytes
included; the padded segment tables equal the reference's. The port runs
its pair kernel's plain version (device="cpu"). ``mesh_join_pairs`` raises
naming ROADMAP item 14.

The ``gpu`` tests hold ``pair_band`` to its plain version on the card bit
for bit on the same pairs, on -1 pair pads, pair counts that are not a
multiple of 8, and multi-part and polygon × polygon pairs; they import
nothing of JAX (``python -m pytest --noconftest -m gpu
tests/test_torch_extent_join.py`` on the card).
"""

import importlib

import numpy as np
import pytest
import torch

from geomesa_tpu_torch import arith
from geomesa_tpu_torch.features import geometry as tgeo
from geomesa_tpu_torch.index import scan as tscan
from geomesa_tpu_torch.kernels import pair_band as kpair
from geomesa_tpu_torch.parallel import pair_kernel as tpk

# the module (the package exports its function of the same name)
tej = importlib.import_module("geomesa_tpu_torch.parallel.extent_join")


def _ref(name: str):
    """A module of the JAX package (imported only by the CPU tests)."""
    pytest.importorskip("jax")
    return importlib.import_module(name)


def _line_coords(n, seed, span=2.0):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-60, 60, n)
    y0 = rng.uniform(-60, 60, n)
    coords = np.empty((2 * n, 2))
    coords[0::2, 0], coords[0::2, 1] = x0, y0
    coords[1::2, 0] = x0 + rng.uniform(-span, span, n)
    coords[1::2, 1] = y0 + rng.uniform(-span, span, n)
    return coords


def _poly_shapes(m, seed):
    rng = np.random.default_rng(seed)
    shapes = []
    for _ in range(m):
        cx, cy = rng.uniform(-55, 55, 2)
        r = rng.uniform(0.5, 4.0)
        ang = np.linspace(0, 2 * np.pi, 9)[:-1]
        ring = [[float(cx + r * np.cos(a)), float(cy + r * np.sin(a))]
                for a in ang]
        ring.append(ring[0])
        shapes.append((tgeo.POLYGON, [ring]))
    return shapes


def _nested():
    shapes_l, shapes_r = [], []
    for k in range(6):
        c = k * 10.0
        big = [[c - 2, -2.0], [c + 2, -2.0], [c + 2, 2.0], [c - 2, 2.0],
               [c - 2, -2.0]]
        small = [[c - .5, -.5], [c + .5, -.5], [c + .5, .5], [c - .5, .5],
                 [c - .5, -.5]]
        shapes_l.append((tgeo.POLYGON, [small]))
        shapes_r.append((tgeo.POLYGON, [big]))
    return shapes_l, shapes_r


def _orient_fused(px, py, qx, qy, rx, ry):
    """``_orient_band`` with ``det`` and ``tol`` each one fused multiply-add,
    flushed: XLA's form when the band is the whole jitted program
    (``test_reference_orient_band_is_fused_under_jit``)."""
    d1x, d1y = arith.sub(qx, px), arith.sub(qy, py)
    d2x, d2y = arith.sub(rx, px), arith.sub(ry, py)
    t1, t2 = arith.mul(d1x, d2y), arith.mul(d1y, d2x)
    sd = arith.add(arith.add(arith.add(d1x.abs(), d1y.abs()), d2x.abs()),
                   d2y.abs())
    det = arith.fma(d1x, d2y, -t2)
    tol = arith.fma(torch.full_like(t1, tscan.TOL_T),
                    arith.add(t1.abs(), t2.abs()),
                    arith.mul(torch.full_like(sd, tscan.TOL_D), sd))
    return det, tol


def _edge_rows(p, q, r, rows=48):
    """The first ``rows`` orientations (p, q, r) (f64 arrays, read in f32)
    whose ``det > tol`` the port's band and the fused band answer
    differently: each lies within an ulp or two of its band's edge."""
    a = [torch.from_numpy(v.astype(np.float32)) for v in (*p, *q, *r)]
    det, tol = tscan._orient_band(*a)
    fdet, ftol = _orient_fused(*a)
    flips = np.flatnonzero(((det > tol) != (fdet > ftol)).numpy())
    assert len(flips) >= rows
    return flips[:rows], (det > tol).numpy()


def _band_edge_segments(n=100_000, seed=21):
    """Left line a-b and right line c-d, c on the edge of a-b's band (at
    the distance where ``|det|`` meets ``tol``), d far across: every other
    orientation is certain, so a pair is a certain hit exactly when c's
    ``o > t`` holds, else uncertain."""
    rng = np.random.default_rng(seed)
    ax, ay = rng.uniform(-50, 50, n), rng.uniform(-50, 50, n)
    ang, ln = rng.uniform(0, 2 * np.pi, n), rng.uniform(0.1, 2, n)
    bx, by = ax + ln * np.cos(ang), ay + ln * np.sin(ang)
    nx, ny = -np.sin(ang), np.cos(ang)
    s = rng.uniform(0.3, 0.7, n)
    ex, ey = ax + s * (bx - ax), ay + s * (by - ay)
    sd = np.abs(bx - ax) + np.abs(by - ay) + np.abs(ex - ax) \
        + np.abs(ey - ay)
    h = tscan.TOL_D * sd / ln * (1 + rng.uniform(-3e-6, 3e-6, n))
    cx, cy = ex + h * nx, ey + h * ny
    rows, state = _edge_rows((ax, ay), (bx, by), (cx, cy))
    left = [(tgeo.LINESTRING, [[ax[i], ay[i]], [bx[i], by[i]]])
            for i in rows]
    right = [(tgeo.LINESTRING, [[cx[i], cy[i]],
                                [ex[i] - 0.5 * nx[i], ey[i] - 0.5 * ny[i]]])
             for i in rows]
    return left, right, state[rows]


def _band_edge_first_vertex(n=100_000, seed=22):
    """Left a quad whose right edge leans, right a line whose first vertex
    lies on the edge of that edge's band, inside, and which runs inward:
    no segment pair is certain, so a pair is a certain hit exactly when
    the vertex's crossing of that edge is certain (``o > t``), else
    uncertain."""
    rng = np.random.default_rng(seed)
    x0, y0 = rng.uniform(-40, 40, n), rng.uniform(-40, 40, n)
    w, lean = rng.uniform(0.5, 3, n), rng.uniform(-0.5, 0.5, n)
    x1, y1, x2, y2 = x0 + w, y0, x0 + w + lean * w, y0 + w
    u = rng.uniform(0.3, 0.7, n)
    qx, qy = x1 + u * (x2 - x1), y1 + u * (y2 - y1)
    ln = np.hypot(x2 - x1, y2 - y1)
    nx, ny = -(y2 - y1) / ln, (x2 - x1) / ln
    sd = np.abs(x2 - x1) + np.abs(y2 - y1) + np.abs(qx - x1) \
        + np.abs(qy - y1)
    h = tscan.TOL_D * sd / ln * (1 + rng.uniform(-3e-6, 3e-6, n))
    px, py = qx + h * nx, qy + h * ny
    rows, state = _edge_rows((x1, y1), (x2, y2), (px, py))
    left = [(tgeo.POLYGON, [[[x0[i], y0[i]], [x1[i], y1[i]], [x2[i], y2[i]],
                             [x0[i], y2[i]], [x0[i], y0[i]]]]) for i in rows]
    right = [(tgeo.LINESTRING, [[px[i], py[i]], [px[i] + 0.2 * w[i] * nx[i],
                                                 py[i] + 0.2 * w[i] * ny[i]]])
             for i in rows]
    return left, right, state[rows]


def _subnormal():
    """Crossing, touching and disjoint lines whose coordinates or
    coordinate differences are subnormal f32 (under 2^-126), beside
    normal ones: XLA flushes them, the port's bands do not, and no
    verdict can tell (a band that certifies a sign has |det| > tol >=
    TOL_D · |d| for its largest difference d, so |d| > 4e-5 and no
    subnormal changes det's rounding)."""
    t = 3e-39
    left = [(tgeo.LINESTRING, [[0.0, 0.0], [4 * t, 4 * t]]),
            (tgeo.LINESTRING, [[0.0, 0.0], [1.0, t]]),
            (tgeo.LINESTRING, [[-1.0, t], [1.0, -t]]),
            (tgeo.LINESTRING, [[t, -1.0], [-t, 1.0]])]
    right = [(tgeo.LINESTRING, [[0.0, 4 * t], [4 * t, 0.0]]),
             (tgeo.LINESTRING, [[0.5, -1.0], [0.5, 1.0]]),
             (tgeo.LINESTRING, [[t, -1.0], [-t, 1.0]]),
             (tgeo.LINESTRING, [[2.0, 2.0], [3.0, 3.0 + t]])]
    return left, right


BAND_EDGE = {"edge_segments": _band_edge_segments(),
             "edge_first_vertex": _band_edge_first_vertex()}

MULTI = ([(tgeo.MULTILINESTRING, [[[100.0, 100.0], [101.0, 101.0]],
                                  [[0.0, 0.0], [1.0, 1.0]]])],
         [(tgeo.POLYGON, [[[-5.0, -5.0], [5.0, -5.0], [5.0, 5.0],
                           [-5.0, 5.0], [-5.0, -5.0]]])])

# name → (left, right) as ("lines", n, seed) or ("polys", m, seed) or shapes
PAIRS = {
    "lines_polys": (("lines", 2500, 3), ("polys", 50, 4)),
    "lines_lines": (("lines", 1500, 5), ("lines", 1500, 6)),
    "partitioned": (("lines", 2000, 7), ("polys", 40, 8)),
    "device_lines_polys": (("lines", 2500, 12), ("polys", 50, 13)),
    "device_lines_lines": (("lines", 1200, 14), ("lines", 1200, 15)),
    "nested": _nested(),
    "multipart": MULTI,
    "edge_segments": BAND_EDGE["edge_segments"][:2],
    "edge_first_vertex": BAND_EDGE["edge_first_vertex"][:2],
    "subnormal": _subnormal(),
}


def _array(mod, spec):
    if isinstance(spec, list):
        return mod.GeometryArray.from_shapes(spec)
    kind, n, seed = spec
    if kind == "lines":
        return mod.GeometryArray.linestrings(_line_coords(n, seed))
    return mod.GeometryArray.from_shapes(_poly_shapes(n, seed))


def _both(name):
    """(reference left, right), (port left, right) of PAIRS[name]."""
    jgeo = _ref("geomesa_tpu.features.geometry")
    ls, rs = PAIRS[name]
    return ((_array(jgeo, ls), _array(jgeo, rs)),
            (_array(tgeo, ls), _array(tgeo, rs)))


def _same(a, b):
    assert np.array_equal(np.asarray(a[0]), np.asarray(b[0]))
    assert np.array_equal(np.asarray(a[1]), np.asarray(b[1]))


def test_candidate_pairs_equal_reference():
    jej = _ref("geomesa_tpu.parallel.extent_join")
    for name in ("lines_polys", "lines_lines"):
        (jl, jr), (tl, tr) = _both(name)
        want = jej.candidate_pairs(jl.bboxes(), jr.bboxes())
        got = tej.candidate_pairs(tl.bboxes(), tr.bboxes())
        _same(got, want)
        assert len(set(zip(got[0].tolist(), got[1].tolist()))) \
            == len(got[0])


def test_chunked_candidates_equal_reference():
    jej = _ref("geomesa_tpu.parallel.extent_join")
    jgeo = _ref("geomesa_tpu.features.geometry")
    jl = jgeo.GeometryArray.linestrings(_line_coords(2000, 10))
    jr = jgeo.GeometryArray.from_shapes(_poly_shapes(40, 11))
    tl = tgeo.GeometryArray.linestrings(_line_coords(2000, 10))
    tr = tgeo.GeometryArray.from_shapes(_poly_shapes(40, 11))
    want = list(jej.candidate_pair_chunks(jl.bboxes(), jr.bboxes(),
                                          chunk_pairs=500))
    got = list(tej.candidate_pair_chunks(tl.bboxes(), tr.bboxes(),
                                         chunk_pairs=500))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        _same(a, b)


@pytest.mark.parametrize("name", sorted(PAIRS))
@pytest.mark.parametrize("device", ["never", "always", "auto"])
def test_extent_join_equals_reference(name, device):
    jej = _ref("geomesa_tpu.parallel.extent_join")
    (jl, jr), (tl, tr) = _both(name)
    want = jej.extent_join(jl, jr, device=device)
    got = tej.extent_join(tl, tr, device=device, torch_device="cpu")
    _same(got, want)
    if name == "nested":
        assert len(got[0]) == 6
    if name == "multipart":
        assert len(got[0]) == 1


def test_within_join_equals_reference():
    jej = _ref("geomesa_tpu.parallel.extent_join")
    (jl, jr), (tl, tr) = _both("lines_polys")
    _same(tej.extent_join(tl, tr, "within", torch_device="cpu"),
          jej.extent_join(jl, jr, "within"))


@pytest.mark.parametrize("device", ["never", "always"])
def test_partitioned_join_equals_reference(device):
    jej = _ref("geomesa_tpu.parallel.extent_join")
    (jl, jr), (tl, tr) = _both("partitioned")
    want = jej.extent_join_partitioned(jl, jr, n_partitions=6, device=device)
    got = tej.extent_join_partitioned(tl, tr, n_partitions=6, device=device,
                                      torch_device="cpu")
    _same(got, want)
    _same(got, tej.extent_join(tl, tr, device=device, torch_device="cpu"))


def test_empty_sides_equal_reference():
    jej = _ref("geomesa_tpu.parallel.extent_join")
    jgeo = _ref("geomesa_tpu.features.geometry")
    jl = jgeo.GeometryArray.linestrings(_line_coords(100, 9))
    tl = tgeo.GeometryArray.linestrings(_line_coords(100, 9))
    j, t = (m.GeometryArray.from_shapes([]) for m in (jgeo, tgeo))
    for args_j, args_t in (((jl, j), (tl, t)), ((j, jl), (t, tl))):
        got = tej.extent_join(*args_t, torch_device="cpu")
        _same(got, jej.extent_join(*args_j))
        assert len(got[0]) == 0
        _same(tej.extent_join_partitioned(*args_t, torch_device="cpu"),
              jej.extent_join_partitioned(*args_j))


def test_points_decline_as_the_reference():
    jpk = _ref("geomesa_tpu.parallel.pair_kernel")
    jej = _ref("geomesa_tpu.parallel.extent_join")
    jgeo = _ref("geomesa_tpu.features.geometry")
    x = np.array([0.0, 50.0])
    jp, tp = jgeo.GeometryArray.points(x, x), tgeo.GeometryArray.points(x, x)
    jr = jgeo.GeometryArray.from_shapes(_poly_shapes(10, 16))
    tr = tgeo.GeometryArray.from_shapes(_poly_shapes(10, 16))
    ij = np.array([0, 1])
    assert jpk.device_refine(jp, jr, ij, ij) is None
    assert tpk.device_refine(tp, tr, ij, ij, "cpu") is None
    assert tpk.prepare_refine(tp, tr, ij, ij, "cpu") is None
    before = kpair.pair_band.launches
    _same(tej.extent_join(tp, tr, device="always", torch_device="cpu"),
          jej.extent_join(jp, jr, device="always"))
    assert kpair.pair_band.launches == before


def test_more_than_512_segments_declines():
    """A ring of 600 segments: the reference's decline (MAX_SEGMENTS), the
    port's too; the join refines on the host and equals the reference."""
    jpk = _ref("geomesa_tpu.parallel.pair_kernel")
    jej = _ref("geomesa_tpu.parallel.extent_join")
    jgeo = _ref("geomesa_tpu.features.geometry")
    ang = np.linspace(0, 2 * np.pi, 601)[:-1]
    ring = [[float(20 * np.cos(a)), float(20 * np.sin(a))] for a in ang]
    big = [(tgeo.POLYGON, [ring + [ring[0]]])]
    coords = _line_coords(300, 21)
    jl, tl = (m.GeometryArray.linestrings(coords) for m in (jgeo, tgeo))
    jr, tr = (m.GeometryArray.from_shapes(big) for m in (jgeo, tgeo))
    li, rj = tej.candidate_pairs(tl.bboxes(), tr.bboxes())
    assert len(li) > 0
    assert jpk.padded_segment_table(jr, np.array([0])) is None
    assert tpk.padded_segment_table(tr, np.array([0])) is None
    assert tpk.prepare_refine(tl, tr, li, rj, "cpu") is None
    _same(tej.extent_join(tl, tr, device="always", torch_device="cpu"),
          jej.extent_join(jl, jr, device="always"))


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_padded_segment_tables_equal_reference(name):
    jpk = _ref("geomesa_tpu.parallel.pair_kernel")
    (jl, jr), (tl, tr) = _both(name)
    for j, t in ((jl, tl), (jr, tr)):
        ids = np.arange(0, len(t), 3, dtype=np.int64)
        want = jpk.padded_segment_table(j, ids)
        got = tpk.padded_segment_table(t, ids)
        assert (want is None) == (got is None)
        if got is not None:
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert tpk._chunk_size(1, 8) == jpk._chunk_size(1, 8)
    assert tpk._chunk_size(512, 512) == jpk._chunk_size(512, 512)


def _dispatch_inputs(name):
    """Candidate pairs of PAIRS[name], with a tail that is not a multiple
    of 8 and a few pairs repeated."""
    (jl, jr), (tl, tr) = _both(name)
    li, rj = tej.candidate_pairs(tl.bboxes(), tr.bboxes())
    if len(li) > 3:
        li, rj = np.concatenate([li, li[:3]]), np.concatenate([rj, rj[:3]])
    if len(li) % 8 == 0:
        li, rj = li[:-1], rj[:-1]
    return jl, jr, tl, tr, li, rj


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_packed_verdicts_equal_reference(name):
    """The raw (2, P/8) packed verdicts of a staged refine, pad bytes
    included, equal the reference's ``_pair_fn`` chunks byte for byte."""
    jpk = _ref("geomesa_tpu.parallel.pair_kernel")
    jl, jr, tl, tr, li, rj = _dispatch_inputs(name)
    jprep = jpk.prepare_refine(jl, jr, li, rj)
    tprep = tpk.prepare_refine(tl, tr, li, rj, "cpu")
    assert (jprep is None) == (tprep is None)
    if tprep is None:
        return
    want = np.asarray(jprep.dispatch())
    got = tprep.dispatch()
    assert got.dtype == torch.uint8
    assert got.numpy().shape == want.shape
    assert got.numpy().tobytes() == want.tobytes()
    for a, b in zip(tprep(), jprep()):
        assert np.array_equal(a, b)
    for a, b in zip(tpk.device_refine(tl, tr, li, rj, "cpu"),
                    jpk.device_refine(jl, jr, li, rj)):
        assert np.array_equal(a, b)


def test_empty_refine_equals_reference():
    jpk = _ref("geomesa_tpu.parallel.pair_kernel")
    (jl, jr), (tl, tr) = _both("lines_polys")
    e = np.empty(0, np.int64)
    tprep = tpk.prepare_refine(tl, tr, e, e, "cpu")
    assert tuple(tprep.dispatch().shape) == \
        tuple(np.asarray(jpk.prepare_refine(jl, jr, e, e).dispatch()).shape)
    for a in tprep():
        assert a.shape == (0,) and a.dtype == bool


def test_packbits_is_numpy_packbits():
    rng = np.random.default_rng(3)
    for n in (0, 1, 7, 8, 9, 63, 64, 65):
        bits = rng.random(n) < 0.5
        got = tpk._packbits(torch.from_numpy(bits)).numpy()
        assert got.tobytes() == np.packbits(bits).tobytes()


def test_mesh_join_pairs_names_item_14():
    (_, _), (tl, tr) = _both("lines_polys")
    with pytest.raises(NotImplementedError, match="item 14"):
        tpk.mesh_join_pairs(None, tl, tr, np.array([0]), np.array([0]))


def test_reference_orient_band_is_fused_under_jit():
    """Jitted alone on the CPU, the reference's ``_orient_band`` is ``det =
    fma(d1x, d2y, -(d1y * d2x))`` and ``tol = fma(TOL_T, |t1| + |t2|,
    TOL_D * s)`` (``_orient_fused``) on every one of 200,000 seeded
    orientations, and the port's unfused band differs from it on some.
    Inside ``_pair_fn`` XLA does not contract it: there the verdicts at
    the band-edge pairs are the unfused band's
    (``test_band_edge_verdicts_follow_the_unfused_band`` and the
    ``edge_*`` cases of ``test_packed_verdicts_equal_reference``)."""
    jax = _ref("jax")
    jscan = _ref("geomesa_tpu.index.scan")
    rng = np.random.default_rng(1)
    a = [rng.uniform(-50, 50, 200_000).astype(np.float32) for _ in range(6)]
    det, tol = (np.asarray(v) for v in jax.jit(jscan._orient_band)(*a))
    t = [torch.from_numpy(v) for v in a]
    fdet, ftol = _orient_fused(*t)
    assert np.array_equal(fdet.numpy(), det)
    assert np.array_equal(ftol.numpy(), tol)
    udet, utol = tscan._orient_band(*t)
    assert not np.array_equal(udet.numpy(), det)
    assert not np.array_equal(utol.numpy(), tol)


@pytest.mark.parametrize("name", sorted(BAND_EDGE))
def test_band_edge_verdicts_follow_the_unfused_band(name):
    """On every band-edge pair the port's verdict is a certain hit exactly
    where its unfused band reads ``o > t`` (else uncertain), and the fused
    band reads the other way on each: so the reference's ``_pair_fn``,
    which these verdicts equal byte for byte, evaluates the band
    unfused."""
    left, right, state = BAND_EDGE[name]
    tl, tr = (tgeo.GeometryArray.from_shapes(v) for v in (left, right))
    rows = np.arange(len(left))
    hit, unc = tpk.device_refine(tl, tr, rows, rows, "cpu")
    assert 0 < state.sum() < len(state)
    assert np.array_equal(hit, state)
    assert np.array_equal(unc, ~state)


def test_join_device_knob_is_the_reference_knob():
    jconfig = _ref("geomesa_tpu.config")
    from geomesa_tpu_torch import config as tconfig
    assert tconfig.JOIN_DEVICE_MIN_PAIRS.name \
        == jconfig.JOIN_DEVICE_MIN_PAIRS.name
    assert tconfig.JOIN_DEVICE_MIN_PAIRS.get() \
        == jconfig.JOIN_DEVICE_MIN_PAIRS.get() == 32_768


# -- the CUDA kernel against its plain version (card only) ------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the pair_band kernel)")
    return torch.device("cuda")


def _port_pairs(name):
    ls, rs = PAIRS[name]
    tl, tr = _array(tgeo, ls), _array(tgeo, rs)
    li, rj = tej.candidate_pairs(tl.bboxes(), tr.bboxes())
    return tl, tr, li, rj


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(PAIRS))
@pytest.mark.parametrize("cut", [0, 1, 5])
def test_cuda_pair_band_equals_plain(name, cut):
    """Every case's pairs (less ``cut`` from the end: tails of 8k + r
    pairs) with their -1 pads, on the card and against the plain version
    there and on the CPU."""
    dev = _cuda()
    tl, tr, li, rj = _port_pairs(name)
    n = max(1, len(li) - cut)
    prep = tpk.prepare_refine(tl, tr, li[:n], rj[:n], dev)
    if prep is None:
        pytest.skip("the reference's decline (points or > 512 segments)")
    before = kpair.pair_band.launches
    got = prep.dispatch()
    torch.cuda.synchronize()
    assert kpair.pair_band.launches == before + 1
    args = (*prep._d_l, *prep._d_r, prep._d_pl, prep._d_pr)
    assert torch.equal(got, tpk.pair_plain(*args))
    assert torch.equal(got.cpu(), tpk.pair_plain(*(a.cpu() for a in args)))
    # the unpadded pairs too (a tail byte of fewer than 8 pairs)
    raw = (prep._d_pl[:n], prep._d_pr[:n])
    assert torch.equal(kpair.pair_band(*args[:8], *raw),
                       tpk.pair_plain(*args[:8], *raw))


@pytest.mark.gpu
def test_cuda_pair_band_pads_and_clamps():
    """Pairs with -1 pads among them and right indices past the table
    (clamped, as the reference clamps): equal to the plain version."""
    dev = _cuda()
    tl, tr, li, rj = _port_pairs("lines_polys")
    prep = tpk.prepare_refine(tl, tr, li, rj, dev)
    pl = prep._d_pl.clone()
    pr = prep._d_pr.clone()
    pl[::7] = -1
    pr[::5] = int(prep._d_r[0].shape[0]) + 3
    args = (*prep._d_l, *prep._d_r)
    assert torch.equal(kpair.pair_band(*args, pl, pr),
                       tpk.pair_plain(*args, pl, pr))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["device_lines_polys", "nested",
                                  "multipart"])
def test_cuda_extent_join_equals_cpu(name):
    dev = _cuda()
    tl, tr, _, _ = _port_pairs(name)
    a = tej.extent_join(tl, tr, device="always", torch_device=dev)
    b = tej.extent_join(tl, tr, device="never", torch_device="cpu")
    _same(a, b)
