"""The device geometry catalog (``geomesa_tpu_torch/geom/catalog.py``) and its
kernels (``kernels/geom.py``: ``geom_unary``, ``geom_dist``,
``geom_pred``) against the JAX package's ``geom/catalog.py``.

Inputs: ``tests/test_geom_catalog.py``'s ``_mixed_shapes`` corpus (points,
dateline-adjacent points, convex polygons, zero-area slivers, boxes by the
dateline, lines, collinear lines, tiny triangles; seeds 3, 11 and 29),
copied here as ``_corpus`` (held equal to the original) so the card tests
need no JAX; ``_extra_shapes``: features of extent 1e-20 on and off the
1/256-degree grid (subnormal products, flushed as XLA flushes them on the
CPU), coincident vertices, polygons stored open, a two-point ring, holes,
multi-parts, multipoints and lines and polygons of 12 to 40 segments; an
all-point batch (a point column and ragged points) and an empty row set.

- ``pack_features`` and ``pack_literal``: every array equal to the
  reference's, but ``pack_literal``'s point pads (copies of the literal's
  last point; the reference's 3e9 make its banded contains false for a
  feature that contains a literal whose point count is not a power of
  two). Contains (op 2) is held to the reference's program on the port's
  literal points and to the f64 oracle (``_hold_contains``), and
  ``INSIDE``'s literals in ``BOXES`` answer the oracle's through
  ``batch_predicate`` and a store query.
- The plain programs against ``_unary_batch``, ``_dist_batch``,
  ``_pred_batch`` and ``_hull_batch`` on the same packs: distances, the
  bands and the hulls equal; the unary values bit for bit where the pack
  has at most 8 segment slots (XLA sums wider rows in another order),
  within ``parity_report``'s per-feature bounds of the reference's values
  above.
- ``unary_values``, ``batch_distance``, ``batch_predicate``,
  ``kernel_hulls``, ``kernel_buffers``, ``parity_report`` and the
  ``STATS`` they count equal the reference's; every parity axis 0.

- The pair programs' plain versions against the reference's on packs 1 to
  64 slots wide, a mixed pack (one 1,000-vertex line among quads) and
  quads against a 700-edge ring; the pair kernels' launch plan and packed
  arguments.

Tolerance: none, but the unary values of packs wider than 8 segments.
The port runs with device="cpu" (the plain versions). The ``gpu`` tests
hold each kernel to its plain version on the card, bit for bit, on the
same corpora and at (m1)/(m3)-like shapes of ``chip_smoke.py``, and the
pair kernels in every form (lane-group widths, batch sizes, literal
lengths about a tile, a mixed pack, subnormal and NaN coordinates, rows
on the bands' edges); they import nothing of JAX (``python -m pytest
--noconftest -m gpu tests/test_torch_catalog.py`` on the card).
"""

import importlib

import numpy as np
import pytest
import torch

from geomesa_tpu_torch import config as tconfig
from geomesa_tpu_torch.features import geometry as tgeo
from geomesa_tpu_torch.geom import catalog as tcat
from geomesa_tpu_torch.geom import oracle as toracle
from geomesa_tpu_torch.kernels import geom as kgeom

SEEDS = (3, 11, 29)


def _ref(name: str):
    """A module of the JAX package (imported only by the CPU tests)."""
    pytest.importorskip("jax")
    return importlib.import_module(name)


def _corpus(rng, n=160):
    """``tests/test_geom_catalog.py``'s ``_mixed_shapes``, with the port's
    type codes."""
    shapes = []
    for i in range(n):
        kind = i % 8
        cx = float(rng.uniform(-175, 175))
        cy = float(rng.uniform(-85, 85))
        if kind == 0:
            shapes.append((tgeo.POINT, [cx, cy]))
        elif kind == 1:
            shapes.append((tgeo.POINT, [float(rng.uniform(179.0, 180.0))
                                        * (1 if i % 2 else -1), cy]))
        elif kind == 2:
            k = int(rng.integers(4, 9))
            ang = np.sort(rng.uniform(0, 2 * np.pi, k))
            r = rng.uniform(0.5, 4.0, k)
            ring = [[cx + float(r[j] * np.cos(ang[j])),
                     cy + float(r[j] * np.sin(ang[j]))] for j in range(k)]
            ring.append(ring[0])
            shapes.append((tgeo.POLYGON, [ring]))
        elif kind == 3:
            ring = [[cx, cy], [cx + 2.0, cy], [cx, cy]]
            ring.append(ring[0])
            shapes.append((tgeo.POLYGON, [ring]))
        elif kind == 4:
            w, h = float(rng.uniform(0.1, 2)), float(rng.uniform(0.1, 2))
            x0 = float(rng.uniform(176.0, 178.0)) * (1 if i % 2 else -1)
            x1, y0 = x0 + w * (0.1 if x0 > 0 else 1.0), cy
            ring = [[x0, y0], [x1, y0], [x1, y0 + h], [x0, y0 + h],
                    [x0, y0]]
            shapes.append((tgeo.POLYGON, [ring]))
        elif kind == 5:
            k = int(rng.integers(2, 6))
            pts = [[cx + float(rng.uniform(-3, 3)),
                    cy + float(rng.uniform(-3, 3))] for _ in range(k)]
            shapes.append((tgeo.LINESTRING, pts))
        elif kind == 6:
            shapes.append((tgeo.LINESTRING,
                           [[cx + j * 0.5, cy + j * 0.25]
                            for j in range(4)]))
        else:
            ring = [[cx, cy], [cx + 0.01, cy], [cx, cy + 0.01], [cx, cy]]
            shapes.append((tgeo.POLYGON, [ring]))
    return shapes


def _tiny(x, y, e):
    """A triangle of extent ``e`` at (x, y), closed."""
    return (tgeo.POLYGON, [[[x, y], [x + e, y], [x, y + e], [x, y]]])


def _extra_shapes():
    """Shapes the corpus lacks (see the module doc)."""
    rng = np.random.default_rng(17)
    ang = np.linspace(0, 2 * np.pi, 13)[:-1]
    twelve = [[5 + 2 * float(np.cos(a)), -7 + 3 * float(np.sin(a))]
              for a in ang]
    return [
        _tiny(0.0, 0.0, 1e-20), _tiny(0.5, -0.25, 1e-20),
        _tiny(10.3, 20.7, 1e-20), _tiny(0.0, 0.0, 1e-30),
        (tgeo.LINESTRING, [[0.0, 0.0], [1e-20, 2e-20], [3e-20, -1e-20]]),
        (tgeo.LINESTRING, [[1.0, 2.0], [1.0, 2.0], [1.0, 2.0]]),
        (tgeo.POLYGON, [[[3.0, 3.0], [3.0, 3.0], [4.0, 3.0], [4.0, 4.0],
                         [4.0, 4.0], [3.0, 3.0]]]),
        (tgeo.POLYGON, [[[-2.0, -2.0], [2.0, -2.0], [2.0, 2.0],
                         [-2.0, 2.0]]]),
        (tgeo.POLYGON, [[[7.0, 7.0], [8.0, 8.0]]]),
        (tgeo.POLYGON, [[[20.0, 20.0], [30.0, 20.0], [30.0, 30.0],
                         [20.0, 30.0], [20.0, 20.0]],
                        [[22.0, 22.0], [22.0, 24.0], [24.0, 24.0],
                         [24.0, 22.0], [22.0, 22.0]]]),
        (tgeo.MULTIPOLYGON, [
            [[[-10.0, -10.0], [0.0, -10.0], [0.0, 0.0], [-10.0, -10.0]]],
            [[[100.0, 40.0], [120.0, 40.0], [120.0, 60.0], [100.0, 40.0]],
             [[110.0, 45.0], [115.0, 45.0], [115.0, 50.0],
              [110.0, 45.0]]]]),
        (tgeo.MULTILINESTRING, [[[0.0, 5.0], [1.0, 6.0]],
                                [[2.0, 5.0], [3.0, 7.0], [4.0, 5.0]]]),
        (tgeo.MULTIPOINT, [[1.0, 1.0], [2.0, -1.0], [1.0, 1.0]]),
        (tgeo.POLYGON, [twelve + [twelve[0]]]),
        (tgeo.LINESTRING, [[float(x), float(np.sin(x))]
                           for x in rng.uniform(-3, 3, 40)]),
        (tgeo.POINT, [0.0, 0.0]),
    ]


LITERALS = {
    "polygon": (tgeo.POLYGON, [[[-30.0, -20.0], [30.0, -20.0],
                                [30.0, 25.0], [-30.0, 25.0],
                                [-30.0, -20.0]]]),
    "point": (tgeo.POINT, [10.0, 10.0]),
    "origin": (tgeo.POINT, [0.0, 0.0]),
    "line": (tgeo.LINESTRING, [[-40.0, -10.0], [20.0, 30.0],
                               [60.0, 0.0]]),
    "multipolygon": (tgeo.MULTIPOLYGON, [
        [[[-10.0, -10.0], [0.0, -10.0], [0.0, 0.0], [-10.0, -10.0]]],
        [[[100.0, 40.0], [120.0, 40.0], [120.0, 60.0], [100.0, 40.0]]]]),
    "multipoint": (tgeo.MULTIPOINT, [[1.0, 1.0], [3.0, 4.0], [-5.0, 2.0]]),
}


# literals inside the box BOXES[0] (and the larger box around it), of 5, 3
# and 3 points: the reference's contains answers false for both boxes, the
# oracle true
INSIDE_WKT = {
    "inside_polygon": "POLYGON((-10 30, 10 30, 10 50, -10 50, -10 30))",
    "inside_line": "LINESTRING(-20 30, 0 45, 20 35)",
    "inside_multipoint": "MULTIPOINT((-5 40), (5 42), (0 35))",
}
INSIDE = {k: tgeo.parse_wkt(v) for k, v in INSIDE_WKT.items()}
BOXES = [
    "POLYGON((-40 20, 40 20, 40 60, -40 60, -40 20))",
    "POLYGON((-50 10, 50 10, 50 70, -50 70, -50 10))",
    "POLYGON((100 0, 110 0, 110 10, 100 10, 100 0))",
]


def _ref_pred(jcat, jp, jls, jlp, tlp, op, jpoly, ext):
    """The reference's banded predicate program on the same pack; contains
    (op 2) on the port's literal points (``pack_literal``: the reference's
    pads answer false for a feature that contains a literal whose point
    count is not a power of two), so the program is held bit for bit and
    the pads to the oracle (``_hold_contains``)."""
    lp = _np(tlp) if op == 2 else jlp
    return jcat._pred_batch(jp.verts, jp.vmask, jp.segs, jp.smask, jp.poly,
                            jp.ref32, jls, lp, op, jpoly, ext)


def _stored_closed(ta, i) -> bool:
    """Whether every ring of feature i is stored closed."""
    code, data = toracle.feature_shape(ta, int(i))
    rings = data if code == tgeo.POLYGON else \
        [r for p in data for r in p] if code == tgeo.MULTIPOLYGON else []
    return all(np.array_equal(np.asarray(r[0]), np.asarray(r[-1]))
               for r in rings)


def _hold_contains(ta, rows, literal, cin, cout):
    """Contains' bands against the f64 oracle: a certainly-true row
    contains the literal; a row neither certainly true nor left to the
    refine (cout) does not. Polygons stored open are left out: there the
    program's rings and the oracle's differ whatever the pads."""
    n = len(rows)
    keep = np.asarray([_stored_closed(ta, i) for i in rows], dtype=bool)
    want = toracle.feature_contains(ta, rows, literal)
    cin, cout = _np(cin)[:n], _np(cout)[:n]
    assert not np.any(cin & ~want)
    assert not np.any(keep & cout & ~cin & want)


def _shapes(which):
    if which == "extra":
        return _extra_shapes()
    if which == "points":
        rng = np.random.default_rng(5)
        return [(tgeo.POINT, [float(x), float(y)])
                for x, y in zip(rng.uniform(-180, 180, 300),
                                rng.uniform(-90, 90, 300))]
    return _corpus(np.random.default_rng(which))


CORPORA = SEEDS + ("extra",)


def _arrays(which):
    jgeo = _ref("geomesa_tpu.features.geometry")
    shapes = _shapes(which)
    return (jgeo.GeometryArray.from_shapes(shapes),
            tgeo.GeometryArray.from_shapes(shapes))


def _row_sets(n):
    return {"all": np.arange(n, dtype=np.int64),
            "some": np.arange(n - 1, 0, -3, dtype=np.int64),
            "none": np.empty(0, dtype=np.int64)}


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# -- the corpus and the packs ---------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_corpus_is_the_reference_corpus(seed):
    tgc = _ref("test_geom_catalog")
    want = tgc._mixed_shapes(np.random.default_rng(seed))
    got = _corpus(np.random.default_rng(seed))
    assert [(int(c), d) for c, d in got] == [(int(c), d) for c, d in want]


PACK_FIELDS = ("verts", "vmask", "segs", "smask", "wsign", "mode", "poly",
               "ref32")


def _same_pack(jp, tp):
    assert jp.n == tp.n
    assert np.array_equal(jp.ref, tp.ref) and tp.ref.dtype == np.float64
    for f in PACK_FIELDS:
        a, b = np.asarray(getattr(jp, f)), _np(getattr(tp, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert np.array_equal(a, b), f


@pytest.mark.parametrize("which", CORPORA)
@pytest.mark.parametrize("rows", ["all", "some", "none"])
def test_pack_features_equals_reference(which, rows):
    jcat = _ref("geomesa_tpu.geom.catalog")
    ja, ta = _arrays(which)
    r = _row_sets(len(ta))[rows]
    _same_pack(jcat.pack_features(ja, r), tcat.pack_features(ta, r, "cpu"))


@pytest.mark.parametrize("form", ["point_column", "ragged"])
def test_pack_features_all_points_equals_reference(form):
    jcat = _ref("geomesa_tpu.geom.catalog")
    jgeo = _ref("geomesa_tpu.features.geometry")
    shapes = _shapes("points")
    if form == "ragged":
        # points of a ragged array (beside a line, which is not packed)
        shapes = shapes + [(tgeo.LINESTRING, [[0.0, 0.0], [1.0, 1.0]])]
    ja = jgeo.GeometryArray.from_shapes(shapes)
    ta = tgeo.GeometryArray.from_shapes(shapes)
    assert ta.is_point_column == (form == "point_column")
    r = np.arange(300, dtype=np.int64)[::-1].copy()
    _same_pack(jcat.pack_features(ja, r), tcat.pack_features(ta, r, "cpu"))


@pytest.mark.parametrize("lit", sorted(LITERALS) + sorted(INSIDE))
def test_pack_literal_equals_reference(lit):
    """Edges, the literal's own points and the polygonal flag equal the
    reference's. The point pads do not: the reference pads with 3e9, which
    lies outside every feature, so its banded contains answers false for a
    feature that contains a literal of 3, 5, 6 or 7 points (the f64 oracle:
    true). The port pads with copies of the last point, which leave every
    reduction over the points as it is over the literal's own."""
    jcat = _ref("geomesa_tpu.geom.catalog")
    literal = {**LITERALS, **INSIDE}[lit]
    jls, jlp, jpoly = jcat.pack_literal(literal)
    tls, tlp, tpoly = tcat.pack_literal(literal, "cpu")
    n = len(_ref("geomesa_tpu.filter.geom_numpy").literal_coords(literal))
    assert np.array_equal(np.asarray(jls), _np(tls))
    assert np.array_equal(np.asarray(jlp)[:n], _np(tlp)[:n])
    assert np.all(_np(tlp)[n:] == _np(tlp)[n - 1])
    assert jpoly == tpoly


def test_constants_equal_reference():
    jcat = _ref("geomesa_tpu.geom.catalog")
    assert tcat.MISS2 == float(jcat._MISS_BAND * jcat._MISS_BAND)
    assert np.array_equal(tcat.EDGE_PAD, jcat._EDGE_PAD_ROW)
    assert (tcat._EPS32, tcat._DELTA) == (jcat._EPS32, jcat._DELTA)


# -- the plain programs against the reference's ---------------------------------


def _packs(which):
    jcat = _ref("geomesa_tpu.geom.catalog")
    ja, ta = _arrays(which)
    r = np.arange(len(ta), dtype=np.int64)
    return jcat, ja, ta, r, jcat.pack_features(ja, r), \
        tcat.pack_features(ta, r, "cpu")


def _unary_bounds(ta, rows):
    """parity_report's per-feature (area, length, centroid) bounds."""
    toracle = importlib.import_module("geomesa_tpu_torch.geom.oracle")
    gn = importlib.import_module("geomesa_tpu_torch.filter.geom_numpy")
    bb = ta.bboxes()[rows]
    ext = np.maximum(np.maximum(bb[:, 2] - bb[:, 0], bb[:, 3] - bb[:, 1]),
                     1e-12)
    mag = np.maximum(np.max(np.abs(bb), axis=1), 1.0)
    nseg = np.asarray([len(gn.feature_segments(ta, int(i))) + 1
                       for i in rows], dtype=np.float64)
    eps = tcat._EPS32
    t_area = 64 * nseg * eps * ext * ext + 8 * nseg * eps * ext * mag
    t_len = 64 * nseg * eps * ext + 8 * nseg * eps * mag
    area = toracle.area(ta, rows)
    safe_a = np.maximum(area, toracle.AREAL_REL * ext * ext * 0.25)
    t_cen = 256 * nseg * eps * ext ** 3 / safe_a + 64 * nseg * eps * ext \
        + 1e-6
    return t_area, t_len, t_cen


@pytest.mark.parametrize("which", CORPORA)
def test_plain_unary_equals_reference(which):
    jcat, ja, ta, r, jp, tp = _packs(which)
    want = [np.asarray(v) for v in jcat._unary_batch(
        jp.verts, jp.vmask, jp.segs, jp.smask, jp.wsign, jp.mode)]
    got = [_np(v) for v in tcat._unary_plain(
        tp.verts, tp.vmask, tp.segs, tp.smask, tp.wsign, tp.mode)]
    if tp.segs.shape[1] <= 8:
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        return
    # wider rows: XLA reassociates the sums; within the reference's own
    # forward bounds of each other (both are held to them by parity)
    n = len(r)
    t_area, t_len, t_cen = _unary_bounds(ta, r)
    ref = tp.ref[:n]
    assert np.all(np.abs(got[0][:n] - want[0][:n]) <= t_area)
    assert np.all(np.abs(got[1][:n] - want[1][:n]) <= t_len)
    for k in (2, 3):
        assert np.all(np.abs((got[k][:n] + ref[:, k - 2])
                             - (want[k][:n] + ref[:, k - 2])) <= t_cen)


@pytest.mark.parametrize("which", CORPORA)
@pytest.mark.parametrize("lit", sorted(LITERALS))
def test_plain_dist_equals_reference(which, lit):
    jcat, ja, ta, r, jp, tp = _packs(which)
    jls, jlp, jpoly = jcat.pack_literal(LITERALS[lit])
    tls, tlp, tpoly = tcat.pack_literal(LITERALS[lit], "cpu")
    want = np.asarray(jcat._dist_batch(jp.verts, jp.vmask, jp.segs,
                                       jp.smask, jp.poly, jp.ref32, jls, jlp,
                                       jpoly))
    got = _np(tcat._dist_plain(tp.verts, tp.vmask, tp.segs, tp.smask,
                               tp.poly, tp.ref32, tls, tlp, tpoly))
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("which", CORPORA)
@pytest.mark.parametrize("lit", sorted(LITERALS))
@pytest.mark.parametrize("op", [0, 1, 2])
def test_plain_pred_equals_reference(which, lit, op):
    jcat, ja, ta, r, jp, tp = _packs(which)
    literal = LITERALS[lit]
    jls, jlp, jpoly = jcat.pack_literal(literal)
    tls, tlp, tpoly = tcat.pack_literal(literal, "cpu")
    ext = literal[0] not in (tgeo.POINT, tgeo.MULTIPOINT)
    want = _ref_pred(jcat, jp, jls, jlp, tlp, op, jpoly, ext)
    got = tcat._pred_plain(tp.verts, tp.vmask, tp.segs, tp.smask, tp.poly,
                           tp.ref32, tls, tlp, op, tpoly, ext)
    for a, b in zip(got, want):
        assert np.array_equal(_np(a), np.asarray(b))
    if op == 2:
        _hold_contains(ta, r, literal, *got)


@pytest.mark.parametrize("which", CORPORA)
def test_plain_hull_equals_reference(which):
    jcat, ja, ta, r, jp, tp = _packs(which)
    want = [np.asarray(v) for v in jcat._hull_batch(jp.verts, jp.vmask)]
    got = [_np(v) for v in tcat._hull_plain(tp.verts, tp.vmask)]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_plain_programs_at_the_smoke_shapes():
    """(m1)-like single-segment lines and (m3)-like quadrilaterals (a few
    thousand of each, ``chip_smoke.py``'s generators' shapes): unary values
    bit for bit, distances and bands equal."""
    jcat = _ref("geomesa_tpu.geom.catalog")
    jgeo = _ref("geomesa_tpu.features.geometry")
    for ja, ta in _smoke_arrays(jgeo):
        r = np.arange(len(ta), dtype=np.int64)
        jp, tp = jcat.pack_features(ja, r), tcat.pack_features(ta, r, "cpu")
        _same_pack(jp, tp)
        want = [np.asarray(v) for v in jcat._unary_batch(
            jp.verts, jp.vmask, jp.segs, jp.smask, jp.wsign, jp.mode)]
        got = [_np(v) for v in tcat._unary_plain(
            tp.verts, tp.vmask, tp.segs, tp.smask, tp.wsign, tp.mode)]
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        for lit in (SMOKE_POLY, (tgeo.POINT, [1.0, 39.0])):
            jls, jlp, jpoly = jcat.pack_literal(lit)
            tls, tlp, tpoly = tcat.pack_literal(lit, "cpu")
            assert np.array_equal(
                _np(tcat._dist_plain(tp.verts, tp.vmask, tp.segs, tp.smask,
                                     tp.poly, tp.ref32, tls, tlp, tpoly)),
                np.asarray(jcat._dist_batch(
                    jp.verts, jp.vmask, jp.segs, jp.smask, jp.poly,
                    jp.ref32, jls, jlp, jpoly)))
            for op in (0, 2):
                ext = lit[0] != tgeo.POINT
                a = tcat._pred_plain(tp.verts, tp.vmask, tp.segs, tp.smask,
                                     tp.poly, tp.ref32, tls, tlp, op, tpoly,
                                     ext)
                b = _ref_pred(jcat, jp, jls, jlp, tlp, op, jpoly, ext)
                assert all(np.array_equal(_np(x), np.asarray(y))
                           for x, y in zip(a, b))
                if op == 2:
                    _hold_contains(ta, r, lit, *a)


SMOKE_POLY = (tgeo.POLYGON, [[[-12.0, 30.0], [10.0, 28.0], [14.0, 44.0],
                              [-2.0, 50.0], [-12.0, 30.0]]])


def _smoke_lines(n, seed):
    """(2n, 2) vertices of single-segment lines around the smoke polygon."""
    rng = np.random.default_rng(seed)
    a = np.stack([rng.uniform(-20, 20, n), rng.uniform(25, 55, n)], 1)
    d = rng.normal(0, 1.0, (n, 2))
    out = np.empty((2 * n, 2))
    out[0::2], out[1::2] = a, a + d
    return out


def _smoke_quads(n, seed):
    """(n, 5, 2) closed convex quadrilaterals (``chip_smoke.quads``'s
    shape) around the smoke polygon."""
    rng = np.random.default_rng(seed)
    cx = rng.uniform(-20, 20, n)
    cy = rng.uniform(25, 55, n)
    r = rng.uniform(0.05, 1.5, (n, 4))
    ang = np.sort(rng.uniform(0, 2 * np.pi, (n, 4)), axis=1)
    ring = np.empty((n, 5, 2))
    ring[:, :4, 0] = cx[:, None] + r * np.cos(ang)
    ring[:, :4, 1] = cy[:, None] + r * np.sin(ang)
    ring[:, 4] = ring[:, 0]
    return ring


def _quad_array(mod, rings):
    n = len(rings)
    lv = np.arange(n + 1, dtype=np.int64)
    return mod.GeometryArray(np.full(n, mod.POLYGON, dtype=np.int8), lv, lv,
                             5 * lv, rings.reshape(-1, 2))


def _smoke_arrays(jgeo=None, n=3000):
    """[(reference array or None, port array)] of lines and quads."""
    lines = _smoke_lines(n, 2602)
    quads = _smoke_quads(n, 2604)
    out = []
    for build in (lambda m: m.GeometryArray.linestrings(lines),
                  lambda m: _quad_array(m, quads)):
        out.append((None if jgeo is None else build(jgeo), build(tgeo)))
    return out


@pytest.mark.parametrize("k", [0, 1])
def test_one_ring_route_equals_the_general_route(k):
    """A layer of one-ring features (lines, closed quads) packs its host
    arrays by one gather (``_one_ring_tables``); they equal the general
    expansion's (``_ragged_tables``) array for array, rows shuffled."""
    ta = _smoke_arrays(None, 3000)[k][1]
    rows = np.random.default_rng(k).permutation(len(ta))
    m = tcat._ring_width(ta)
    assert m == (2, 5)[k]
    got = tcat._one_ring_tables(ta, rows, m)
    want = tcat._ragged_tables(ta, rows)
    assert got is not None and len(got) == len(want)
    for a, b in zip(got, want):   # counts and positions may be narrower
        assert a.dtype.kind == b.dtype.kind and np.array_equal(a, b)


def test_one_ring_layer_with_an_open_ring_packs_as_reference():
    """A one-ring layer whose polygon is stored open takes the general
    expansion (its closing segment), and packs as the reference."""
    jcat = _ref("geomesa_tpu.geom.catalog")
    jgeo = _ref("geomesa_tpu.features.geometry")
    quads = _smoke_quads(64, 7)
    quads[5, 4] = quads[5, 3] + 0.25   # the ring no longer closes
    ja, ta = _quad_array(jgeo, quads), _quad_array(tgeo, quads)
    rows = np.random.default_rng(3).permutation(len(ta))
    assert tcat._ring_width(ta) == 5
    assert tcat._one_ring_tables(ta, rows, 5) is None
    _same_pack(jcat.pack_features(ja, rows),
               tcat.pack_features(ta, rows, "cpu"))


# -- the entry points ------------------------------------------------------------


def _stats_delta(mod, fn):
    before = mod.stats_snapshot()
    out = fn()
    after = mod.stats_snapshot()
    return out, {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("which", CORPORA)
@pytest.mark.parametrize("rows", ["all", "some", "none"])
def test_entry_points_equal_reference(which, rows):
    jcat = _ref("geomesa_tpu.geom.catalog")
    ja, ta = _arrays(which)
    r = _row_sets(len(ta))[rows]
    exact = tcat.pack_features(ta, r, "cpu").segs.shape[1] <= 8
    got, dt = _stats_delta(tcat, lambda: tcat.unary_values(ta, r, "cpu"))
    want, dj = _stats_delta(jcat, lambda: jcat.unary_values(ja, r))
    assert dt == dj
    if exact:
        assert all(np.array_equal(got[k], want[k]) for k in want)
    for lit in ("polygon", "point", "line", "multipolygon"):
        literal = LITERALS[lit]
        got, dt = _stats_delta(tcat, lambda: tcat.batch_distance(
            ta, r, literal, "cpu"))
        want, dj = _stats_delta(jcat, lambda: jcat.batch_distance(
            ja, r, literal))
        assert dt == dj and np.array_equal(got, want)
        for op in ("intersects", "within"):
            got, dt = _stats_delta(tcat, lambda: tcat.batch_predicate(
                ta, r, op, literal, "cpu"))
            want, dj = _stats_delta(jcat, lambda: jcat.batch_predicate(
                ja, r, op, literal))
            assert dt == dj and np.array_equal(got, want), (lit, op)
        # contains: the f64 oracle's answer (the reference's point pads
        # make it false for a feature that contains a literal whose point
        # count is not a power of two; see test_pack_literal_equals_reference)
        got = tcat.batch_predicate(ta, r, "contains", literal, "cpu")
        assert np.array_equal(got, toracle.feature_contains(ta, r, literal))
    got, dt = _stats_delta(tcat, lambda: tcat.kernel_hulls(ta, r, "cpu"))
    want, dj = _stats_delta(jcat, lambda: jcat.kernel_hulls(ja, r))
    assert dt == dj and len(got) == len(want)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    got, dt = _stats_delta(tcat, lambda: tcat.kernel_buffers(ta, r, 0.25,
                                                              "cpu"))
    want, dj = _stats_delta(jcat, lambda: jcat.kernel_buffers(ja, r, 0.25))
    assert dt == dj and len(got) == len(want)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def _box_arrays():
    jgeo = _ref("geomesa_tpu.features.geometry")
    return (jgeo.GeometryArray.from_shapes([jgeo.parse_wkt(b)
                                            for b in BOXES]),
            tgeo.GeometryArray.from_shapes([tgeo.parse_wkt(b)
                                            for b in BOXES]))


@pytest.mark.parametrize("lit", sorted(INSIDE))
def test_contains_a_literal_inside_answers_the_oracle(lit):
    """Two boxes that contain a literal of 5 or 3 points, and one that does
    not: ``batch_predicate(..., "contains", ...)`` answers the f64 oracle's
    [True, True, False] (the reference answers all False: its point pads
    lie outside every feature). intersects, within and the distances stay
    the reference's, STATS included."""
    jcat = _ref("geomesa_tpu.geom.catalog")
    ja, ta = _box_arrays()
    r = np.arange(len(BOXES), dtype=np.int64)
    literal = INSIDE[lit]
    got = tcat.batch_predicate(ta, r, "contains", literal, "cpu")
    want = toracle.feature_contains(ta, r, literal)
    assert want.tolist() == [True, True, False]
    assert np.array_equal(got, want)
    for op in ("intersects", "within"):
        g, dt = _stats_delta(tcat, lambda: tcat.batch_predicate(
            ta, r, op, literal, "cpu"))
        w, dj = _stats_delta(jcat, lambda: jcat.batch_predicate(
            ja, r, op, literal))
        assert dt == dj and np.array_equal(g, w), op
    g, dt = _stats_delta(tcat, lambda: tcat.batch_distance(ta, r, literal,
                                                            "cpu"))
    w, dj = _stats_delta(jcat, lambda: jcat.batch_distance(ja, r, literal))
    assert dt == dj and np.array_equal(g, w)


@pytest.mark.parametrize("lit", sorted(INSIDE))
def test_store_st_contains_a_literal_inside_answers_the_oracle(lit):
    """``st_contains(geom, <literal>)`` through a store of the three boxes
    with GEOMESA_TPU_GEOM_KERNELS on (the planner's st_* refine through the
    catalog): the oracle's two rows; ``st_intersects`` and ``st_within``'s
    converse (the literal within the feature is contains) stay equal to
    the reference's store."""
    jds = _ref("geomesa_tpu.datastore")
    jtable = _ref("geomesa_tpu.features.table")
    jconfig = _ref("geomesa_tpu.config")
    from geomesa_tpu_torch import DataStoreFinder
    from geomesa_tpu_torch.features.table import FeatureTable
    ja, ta = _box_arrays()
    spec = "val:Int,*geom:Polygon"
    vals = np.arange(len(BOXES), dtype=np.int32)
    js = jds.TpuDataStore()
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    for s, tbl, arr in ((js, jtable.FeatureTable, ja),
                        (ts, FeatureTable, ta)):
        s.create_schema("boxes", spec)
        s.load("boxes", tbl.build(s.get_schema("boxes"),
                                  {"val": vals, "geom": arr}))
    wkt = INSIDE_WKT[lit]
    for c in (jconfig, tconfig):
        c.GEOM_KERNELS.set(True)
    try:
        q = f"st_contains(geom, {wkt})"
        assert ts.count("boxes", q) == 2
        assert np.array_equal(np.sort(ts.query("boxes", q).indices), [0, 1])
        q = f"st_intersects(geom, {wkt})"
        assert ts.count("boxes", q) == js.count("boxes", q) == 2
    finally:
        for c in (jconfig, tconfig):
            c.GEOM_KERNELS.unset()


@pytest.mark.parametrize("which", CORPORA)
def test_parity_report_pins_zero_as_the_reference(which):
    jcat = _ref("geomesa_tpu.geom.catalog")
    ja, ta = _arrays(which)
    r = np.arange(len(ta), dtype=np.int64)
    got = tcat.parity_report(ta, r, LITERALS["polygon"], device="cpu")
    assert got == jcat.parity_report(ja, r, LITERALS["polygon"])
    if which == "extra":
        # the reference's own misses, which the port keeps: a polygon of
        # coincident vertices off the grid reads an st_area of ~3.8e-14
        # (XLA's fma keeps the product's rounding error) and a two-point
        # ring's closing segment doubles its st_length against the oracle's
        assert got == dict({k: 0 for k in got}, st_area=1, st_centroid=1,
                           st_length=1), got
        return
    assert all(v == 0 for v in got.values()), got


def test_parity_on_empty_row_set():
    ta = tgeo.GeometryArray.from_shapes(_corpus(np.random.default_rng(0),
                                                16))
    rep = tcat.parity_report(ta, np.array([], dtype=np.int64),
                             LITERALS["polygon"], device="cpu")
    assert all(v == 0 for v in rep.values()), rep


@pytest.mark.parametrize("chunk", [1024, 20_000])
def test_chunked_plain_route_equals_reference(chunk):
    """``GEOM_CHUNK`` splits the plain pair tables (64 rows a chunk at
    1,024 against a literal of 16 items) as the reference splits its own;
    the answers and STATS do not move."""
    jcat = _ref("geomesa_tpu.geom.catalog")
    jconfig = _ref("geomesa_tpu.config")
    ja, ta = _arrays(11)
    r = np.arange(len(ta), dtype=np.int64)
    lit = LITERALS["polygon"]
    tconfig.GEOM_CHUNK.set(chunk)
    jconfig.GEOM_CHUNK.set(chunk)
    try:
        assert len(list(tcat._row_chunks(r, 16))) == \
            len(list(jcat._row_chunks(r, 16)))
        got, dt = _stats_delta(tcat, lambda: (
            tcat.batch_distance(ta, r, lit, "cpu"),
            tcat.batch_predicate(ta, r, "intersects", lit, "cpu")))
        want, dj = _stats_delta(jcat, lambda: (
            jcat.batch_distance(ja, r, lit),
            jcat.batch_predicate(ja, r, "intersects", lit)))
    finally:
        tconfig.GEOM_CHUNK.unset()
        jconfig.GEOM_CHUNK.unset()
    assert dt == dj
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_knobs_are_the_reference_knobs():
    jconfig = _ref("geomesa_tpu.config")
    for name in ("GEOM_KERNELS", "GEOM_FUSE", "GEOM_CHUNK"):
        t, j = getattr(tconfig, name), getattr(jconfig, name)
        assert (t.name, t.default) == (j.name, j.default)
        assert t.get() == j.get()


def test_wrappers_check_their_inputs():
    ta = tgeo.GeometryArray.from_shapes(_extra_shapes())
    p = tcat.pack_features(ta, np.arange(len(ta)), "cpu")
    ls, lp, lpoly = tcat.pack_literal(LITERALS["polygon"], "cpu")
    with pytest.raises(TypeError):
        kgeom.geom_unary(p.verts.double(), p.vmask, p.segs, p.smask,
                         p.wsign, p.mode)
    with pytest.raises(ValueError):
        kgeom.geom_dist(p.verts, p.vmask[:-1], p.segs, p.smask, p.poly,
                        p.ref32, ls, lp, lpoly)
    with pytest.raises(ValueError):
        kgeom.geom_pred(p.verts, p.vmask, p.segs, p.smask, p.poly, p.ref32,
                        ls, lp, 3, lpoly, True)
    with pytest.raises(ValueError):
        kgeom.geom_unary(p.verts.to("meta"), p.vmask.to("meta"),
                         p.segs.to("meta"), p.smask.to("meta"),
                         p.wsign.to("meta"), p.mode.to("meta"))


def test_catalog_defaults_to_the_card():
    """The entry points run on the card unless the caller names another:
    without one they raise rather than run the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ta = tgeo.GeometryArray.from_shapes(_extra_shapes())
    with pytest.raises(RuntimeError, match="cuda"):
        tcat.unary_values(ta, np.arange(3))


# -- the pair programs on wide packs, a mixed pack and a long literal -------------

WIDTHS = (1, 2, 4, 8, 16, 32, 64)


def _slot_shapes(slots: int, n: int = 96):
    """n features whose packs are ``slots`` wide (K and S): points at 1,
    else lines and closed polygons of up to ``slots`` coordinates (most at
    it, some shorter, so that masks end at different slots), around the
    polygon literal."""
    rng = np.random.default_rng(slots)
    shapes = []
    for i in range(n):
        cx, cy = float(rng.uniform(-40, 40)), float(rng.uniform(-30, 30))
        if slots == 1:
            shapes.append((tgeo.POINT, [cx, cy]))
            continue
        m = slots if i % 3 else int(rng.integers(2, slots + 1))
        ang = np.sort(rng.uniform(0, 2 * np.pi, m))
        r = rng.uniform(0.5, 12.0, m)
        pts = [[cx + float(a), cy + float(b)]
               for a, b in zip(r * np.cos(ang), r * np.sin(ang))]
        if i % 2 and m >= 4:
            shapes.append((tgeo.POLYGON, [pts[:-1] + [pts[0]]]))
        else:
            shapes.append((tgeo.LINESTRING, pts))
    return shapes


def _mixed_shapes():
    """One 1,000-vertex line among 100 quadrilaterals: every quad padded
    to the line's 1,024 slots."""
    quads = [(tgeo.POLYGON, [q.tolist()]) for q in _smoke_quads(100, 9)]
    line = (tgeo.LINESTRING, [[float(x), float(np.sin(x)) + 39.0]
                              for x in np.linspace(-5, 5, 1000)])
    return quads[:60] + [line] + quads[60:]


def _ring(n: int, cx: float = 1.0, cy: float = 39.0):
    """A closed star-shaped polygon of n edges around (cx, cy)."""
    ang = np.linspace(0, 2 * np.pi, n + 1)
    r = 12 + 3 * np.sin(7 * ang)
    ring = [[cx + float(a), cy + float(b)]
            for a, b in zip(r * np.cos(ang), r * np.sin(ang))]
    ring[-1] = ring[0]
    return (tgeo.POLYGON, [ring])


def _pair_case(case):
    """(shapes, literals) of a wide, mixed or long-literal case."""
    if case == "mixed":
        return _mixed_shapes(), (LITERALS["polygon"],)
    if case == "ring700":
        quads = [(tgeo.POLYGON, [q.tolist()]) for q in _smoke_quads(256, 4)]
        return quads, (_ring(700),)
    return _slot_shapes(case), (LITERALS["polygon"], LITERALS["point"])


@pytest.mark.parametrize("case", WIDTHS + ("mixed", "ring700"))
@pytest.mark.parametrize("kind", ["dist", "pred"])
def test_plain_pair_programs_equal_reference_on_new_shapes(case, kind):
    """_dist_plain / _pred_plain against the reference's _dist_batch /
    _pred_batch on packs 1 to 64 slots wide, a mixed pack (one 1,000-vertex
    line among quads) and quads against a 700-edge ring: the plain
    versions the card is held to equal the JAX package there too."""
    jcat = _ref("geomesa_tpu.geom.catalog")
    jgeo = _ref("geomesa_tpu.features.geometry")
    shapes, lits = _pair_case(case)
    ja = jgeo.GeometryArray.from_shapes(shapes)
    ta = tgeo.GeometryArray.from_shapes(shapes)
    r = np.arange(len(ta), dtype=np.int64)
    jp, tp = jcat.pack_features(ja, r), tcat.pack_features(ta, r, "cpu")
    if case in WIDTHS:
        assert max(tp.verts.shape[1], tp.segs.shape[1]) == case
    for lit in lits:
        jls, jlp, jpoly = jcat.pack_literal(lit)
        tls, tlp, tpoly = tcat.pack_literal(lit, "cpu")
        if kind == "dist":
            want = np.asarray(jcat._dist_batch(
                jp.verts, jp.vmask, jp.segs, jp.smask, jp.poly, jp.ref32,
                jls, jlp, jpoly))
            got = _np(tcat._dist_plain(tp.verts, tp.vmask, tp.segs,
                                       tp.smask, tp.poly, tp.ref32, tls,
                                       tlp, tpoly))
            assert got.dtype == want.dtype and np.array_equal(got, want)
            continue
        ext = lit[0] not in (tgeo.POINT, tgeo.MULTIPOINT)
        for op in (0, 1, 2):
            want = _ref_pred(jcat, jp, jls, jlp, tlp, op, jpoly, ext)
            got = tcat._pred_plain(tp.verts, tp.vmask, tp.segs, tp.smask,
                                   tp.poly, tp.ref32, tls, tlp, op, tpoly,
                                   ext)
            for a, b in zip(got, want):
                assert np.array_equal(_np(a), np.asarray(b)), (lit[0], op)
            if op == 2:
                _hold_contains(ta, r, lit, *got)


@pytest.mark.parametrize("B, K, S, L, P, want", [
    (500_000, 8, 4, 1, 1, (False, 1)),       # (m3)'s quads, a point
    (5_000_000, 2, 1, 4, 8, (False, 1)),     # (m1)'s lines, M_WKT
    (50_000, 8, 4, 4, 8, (False, 2)),
    (5_328, 8, 4, 4, 8, (False, 8)),         # (q3)'s rows
    (45, 8, 4, 1, 1, (False, 8)),            # (q4)'s candidates
    (5_328, 8, 4, 1024, 1024, (True, 32)),   # a long literal, few rows
    (500_000, 8, 4, 1024, 1024, (False, 1)),
    (100, 64, 64, 4, 8, (False, 32)),
    (100, 1, 1, 64, 64, (True, 32)),         # a few points, a long ring
    (500_000, 1, 1, 64, 64, (False, 1)),
])
def test_pair_plan(B, K, S, L, P, want):
    """The launch plan: a lane a feature where the batch fills the card,
    more lanes (at most one a slot) where it does not, and a warp over a
    literal of 64 or more items when even that leaves the card short."""
    assert kgeom.plan(B, K, S, L, P) == want


def test_pair_args_match_the_kernels_struct():
    """The wrapper packs csrc/geom_pair.cuh's PairArgs: its 8-byte integer
    slots, then its doubles, in that order."""
    import os
    import re
    src = os.path.join(os.path.dirname(kgeom.__file__), "csrc",
                       "geom_pair.cuh")
    with open(src) as fh:
        body = re.search(r"struct PairArgs \{(.*?)\};", fh.read(),
                         re.S).group(1)
    ints = sum(len(m.split(",")) for m in re.findall(
        r"long long ([^;]*);", body))
    dbls = sum(len(m.split(",")) for m in re.findall(
        r"double ([^;]*);", body))
    assert kgeom._PAIR_ARGS.format.lstrip("=") == f"{ints}q{dbls}d"
    assert kgeom._PAIR_ARGS.size == 8 * (ints + dbls)


# -- the CUDA kernels against their plain versions (card only) --------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the geometry catalog's kernels)")
    return torch.device("cuda")


def _gpu_corpora():
    out = [tgeo.GeometryArray.from_shapes(_shapes(w))
           for w in SEEDS + ("extra", "points")]
    return out + [a for _, a in _smoke_arrays(None, 1 << 15)]


def _on(p, dev):
    return [getattr(p, f).to(dev) for f in PACK_FIELDS]


@pytest.mark.gpu
@pytest.mark.parametrize("k", range(7))
def test_cuda_pack_equals_cpu_pack(k):
    """A pack built on the card (its padded tables scattered there)
    equals the CPU's array for array, rows in a shuffled order."""
    dev = _cuda()
    ta = _gpu_corpora()[k]
    rows = np.random.default_rng(k).permutation(len(ta))
    a = tcat.pack_features(ta, rows, "cpu")
    b = tcat.pack_features(ta, rows, dev)
    assert a.n == b.n and np.array_equal(a.ref, b.ref)
    for f in PACK_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f).cpu()), f


@pytest.mark.gpu
@pytest.mark.parametrize("k", range(7))
def test_cuda_geom_unary_equals_plain(k):
    dev = _cuda()
    ta = _gpu_corpora()[k]
    p = tcat.pack_features(ta, np.arange(len(ta)), "cpu")
    v, vm, s, sm, w, m, _, _ = _on(p, dev)
    before = kgeom.geom_unary.launches
    got = kgeom.geom_unary(v, vm, s, sm, w, m)
    torch.cuda.synchronize()
    assert kgeom.geom_unary.launches == before + 1
    want = tcat._unary_plain(v, vm, s, sm, w, m)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # and equal to the plain version on the CPU (the same arithmetic)
    for a, b in zip(got, tcat._unary_plain(p.verts, p.vmask, p.segs,
                                           p.smask, p.wsign, p.mode)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
@pytest.mark.parametrize("k", range(7))
@pytest.mark.parametrize("lit", sorted(LITERALS))
def test_cuda_geom_dist_equals_plain(k, lit):
    dev = _cuda()
    ta = _gpu_corpora()[k]
    p = tcat.pack_features(ta, np.arange(len(ta)), "cpu")
    v, vm, s, sm, _, _, poly, ref32 = _on(p, dev)
    ls, lp, lpoly = tcat.pack_literal(LITERALS[lit], dev)
    before = kgeom.geom_dist.launches
    got = kgeom.geom_dist(v, vm, s, sm, poly, ref32, ls, lp, lpoly)
    torch.cuda.synchronize()
    assert kgeom.geom_dist.launches == before + 1
    want = tcat._dist_plain(v, vm, s, sm, poly, ref32, ls, lp, lpoly)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("k", range(7))
@pytest.mark.parametrize("lit", sorted(LITERALS))
@pytest.mark.parametrize("op", [0, 1, 2])
def test_cuda_geom_pred_equals_plain(k, lit, op):
    dev = _cuda()
    ta = _gpu_corpora()[k]
    p = tcat.pack_features(ta, np.arange(len(ta)), "cpu")
    v, vm, s, sm, _, _, poly, ref32 = _on(p, dev)
    literal = LITERALS[lit]
    ls, lp, lpoly = tcat.pack_literal(literal, dev)
    ext = literal[0] not in (tgeo.POINT, tgeo.MULTIPOINT)
    before = kgeom.geom_pred.launches
    got = kgeom.geom_pred(v, vm, s, sm, poly, ref32, ls, lp, op, lpoly, ext)
    torch.cuda.synchronize()
    assert kgeom.geom_pred.launches == before + 1
    want = tcat._pred_plain(v, vm, s, sm, poly, ref32, ls, lp, op, lpoly,
                            ext)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("lit", sorted(INSIDE))
@pytest.mark.parametrize("op", [0, 1, 2])
def test_cuda_geom_pred_literal_inside_equals_plain(lit, op):
    """The boxes around a literal of 5 or 3 points (its pads copies of its
    last point, which the kernel's trailing-run cut takes as one): equal
    to the plain version, and contains answers the oracle's on the card."""
    dev = _cuda()
    ta = tgeo.GeometryArray.from_shapes([tgeo.parse_wkt(b) for b in BOXES])
    r = np.arange(len(BOXES), dtype=np.int64)
    p = tcat.pack_features(ta, r, "cpu")
    v, vm, s, sm, _, _, poly, ref32 = _on(p, dev)
    literal = INSIDE[lit]
    ls, lp, lpoly = tcat.pack_literal(literal, dev)
    ext = literal[0] not in (tgeo.POINT, tgeo.MULTIPOINT)
    got = kgeom.geom_pred(v, vm, s, sm, poly, ref32, ls, lp, op, lpoly, ext)
    torch.cuda.synchronize()
    want = tcat._pred_plain(v, vm, s, sm, poly, ref32, ls, lp, op, lpoly,
                            ext)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if op == 2:
        assert np.array_equal(
            tcat.batch_predicate(ta, r, "contains", literal, dev),
            toracle.feature_contains(ta, r, literal))


@pytest.mark.gpu
def test_cuda_literal_past_a_tile():
    """A literal of 700 edges and points (1,024 each after the padding,
    one whole shared-memory tile of the pair kernels; lengths past a tile
    are ``test_cuda_pair_kernels_literal_lengths``'): distances and bands
    equal the plain version's."""
    dev = _cuda()
    ang = np.linspace(0, 2 * np.pi, 701)
    r = 12 + 3 * np.sin(7 * ang)
    ring = [[1 + float(a), 39 + float(b)]
            for a, b in zip(r * np.cos(ang), r * np.sin(ang))]
    ring[-1] = ring[0]
    lit = (tgeo.POLYGON, [ring])
    ta = _smoke_arrays(None, 4096)[1][1]
    p = tcat.pack_features(ta, np.arange(len(ta)), "cpu")
    v, vm, s, sm, _, _, poly, ref32 = _on(p, dev)
    ls, lp, lpoly = tcat.pack_literal(lit, dev)
    assert ls.shape[0] > 512 and lp.shape[0] > 512
    assert torch.equal(
        kgeom.geom_dist(v, vm, s, sm, poly, ref32, ls, lp, lpoly),
        tcat._dist_plain(v, vm, s, sm, poly, ref32, ls, lp, lpoly))
    for op in (0, 1, 2):
        got = kgeom.geom_pred(v, vm, s, sm, poly, ref32, ls, lp, op, lpoly,
                              True)
        want = tcat._pred_plain(v, vm, s, sm, poly, ref32, ls, lp, op, lpoly,
                                True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
def test_cuda_entry_points_equal_cpu():
    """The entry points on the card (one launch a call) against the CPU
    (the plain versions in GEOM_CHUNK chunks): values, bands after the
    refine, and STATS."""
    _cuda()
    ta = tgeo.GeometryArray.from_shapes(_shapes(3) + _extra_shapes())
    r = np.arange(len(ta), dtype=np.int64)
    lit = LITERALS["polygon"]
    for dev in ("cuda", "cpu"):
        u = tcat.unary_values(ta, r, dev)
        d = tcat.batch_distance(ta, r, lit, dev)
        b = [tcat.batch_predicate(ta, r, op, lit, dev)
             for op in ("intersects", "within", "contains")]
        if dev == "cuda":
            first = (u, d, b)
    assert all(np.array_equal(first[0][k], u[k]) for k in u)
    assert np.array_equal(first[1], d)
    assert all(np.array_equal(x, y) for x, y in zip(first[2], b))


# -- the pair kernels' forms (card only) -----------------------------------------


def _pair_on_card(p, dev):
    return [getattr(p, f)[: p.n].to(dev) for f in tcat.PAIR]


def _same_nan(a, b):
    """Equal bit for bit but NaN payloads: NaN in the same rows."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def _held(args, ls, lp, lpoly, ext=True, ops=(0, 1, 2), nan=False):
    """Both kernels on ``args`` against a literal, each one launch, equal
    to the plain versions on the same card tensors."""
    before = kgeom.geom_dist.launches
    got = kgeom.geom_dist(*args, ls, lp, lpoly)
    torch.cuda.synchronize()
    assert kgeom.geom_dist.launches == before + 1
    want = tcat._dist_plain(*args, ls, lp, lpoly)
    assert (_same_nan if nan else torch.equal)(got, want)
    for op in ops:
        before = kgeom.geom_pred.launches
        got = kgeom.geom_pred(*args, ls, lp, op, lpoly, ext)
        torch.cuda.synchronize()
        assert kgeom.geom_pred.launches == before + 1
        want = tcat._pred_plain(*args, ls, lp, op, lpoly, ext)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), op


FORMS = {"natural": None, "items1": (False, 1), "items8": (False, 8),
         "lit": (True, 32)}


def _force(monkeypatch, form):
    if FORMS[form] is not None:
        monkeypatch.setattr(kgeom, "plan", lambda *_: FORMS[form])


@pytest.mark.gpu
@pytest.mark.parametrize("slots", WIDTHS)
@pytest.mark.parametrize("lit", ["polygon", "point", "line", "multipoint"])
def test_cuda_pair_kernels_at_every_width(slots, lit):
    """Packs 1 to 64 slots wide at 96 rows: the launch gives each feature
    min(32, slots) lanes, every width the plan can choose."""
    dev = _cuda()
    ta = tgeo.GeometryArray.from_shapes(_slot_shapes(slots))
    p = tcat.pack_features(ta, np.arange(len(ta)), "cpu")
    args = _pair_on_card(p, dev)
    K, S = args[0].shape[1], args[2].shape[1]
    literal = LITERALS[lit]
    ls, lp, lpoly = tcat.pack_literal(literal, dev)
    assert kgeom.plan(p.n, K, S, ls.shape[0], lp.shape[0]) == \
        (False, min(32, slots))
    _held(args, ls, lp, lpoly,
          literal[0] not in (tgeo.POINT, tgeo.MULTIPOINT))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 37, 255, 257, 1000, 40_000])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_cuda_pair_kernels_batch_sizes(B, form, monkeypatch):
    """Batches of one feature, fewer than a warp, either side of a CTA's
    256 features, and 40,000 (2 lanes a feature), quads from a row that is
    not a CTA's multiple, in every form."""
    dev = _cuda()
    ta = _quad_array(tgeo, _smoke_quads(B + 3, B))
    p = tcat.pack_features(ta, np.arange(3, B + 3), "cpu")
    args = _pair_on_card(p, dev)
    _force(monkeypatch, form)
    for lit in ("polygon", "point"):
        _held(args, *tcat.pack_literal(LITERALS[lit], dev))


def _unpadded_ring(n: int, dev):
    """The first n edges and n points of a closed star-shaped ring around
    (1, 39), unpadded (the last edge ends on the first point at n > 2)."""
    ring = np.asarray(_ring(max(n, 3))[1][0], dtype=np.float32)[: n + 1]
    ls = torch.from_numpy(np.concatenate([ring[:-1], ring[1:]], 1)).to(dev)
    lp = torch.from_numpy(np.ascontiguousarray(ring[:n])).to(dev)
    return ls, lp


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 1024, 1025])
@pytest.mark.parametrize("form", ["items1", "items8", "lit"])
def test_cuda_pair_kernels_literal_lengths(n, form, monkeypatch):
    """A literal of n edges and n points (unpadded) at 1, one whole tile
    of 1,024 and one past it (two tiles behind CTA barriers), in both
    forms: lanes over the feature's items and over the literal."""
    dev = _cuda()
    ta = _quad_array(tgeo, _smoke_quads(600, 21))
    p = tcat.pack_features(ta, np.arange(600), "cpu")
    args = _pair_on_card(p, dev)
    ls, lp = _unpadded_ring(n, dev)
    assert ls.shape[0] == n and lp.shape[0] == n
    _force(monkeypatch, form)
    _held(args, ls, lp, n > 1)


@pytest.mark.gpu
@pytest.mark.parametrize("form", sorted(FORMS))
def test_cuda_pair_kernels_mixed_pack(form, monkeypatch):
    """One 1,000-vertex line among quads (every quad padded to 1,024
    slots): the quads' loops stop at their own counts. Against a literal
    of 1,025 edges and points (two tiles), the line's vertex rounds (1,000,
    or 125 at 8 lanes) run in several chunks, each restaging the tiles
    behind CTA barriers."""
    dev = _cuda()
    ta = tgeo.GeometryArray.from_shapes(_mixed_shapes())
    p = tcat.pack_features(ta, np.arange(len(ta)), "cpu")
    args = _pair_on_card(p, dev)
    assert args[0].shape[1] == 1024 and args[2].shape[1] == 1024
    _force(monkeypatch, form)
    for lit in (LITERALS["polygon"], LITERALS["point"], _ring(700)):
        _held(args, *tcat.pack_literal(lit, dev))
    _held(args, *_unpadded_ring(1025, dev), True)


@pytest.mark.gpu
@pytest.mark.parametrize("form", sorted(FORMS))
def test_cuda_pair_kernels_subnormal_and_nan(form, monkeypatch):
    """Subnormal and NaN coordinates in vertices, segments and origins,
    and masks that are not prefixes: NaN where the plain version gives
    NaN (its min keeps them), every other value bit for bit."""
    dev = _cuda()
    ta = tgeo.GeometryArray.from_shapes(_extra_shapes() + _shapes(11))
    p = tcat.pack_features(ta, np.arange(len(ta)), "cpu")
    v, vm, s, sm, poly, ref = [t.clone() for t in p.rows(*tcat.PAIR)]
    rng = np.random.default_rng(5)
    vm &= torch.from_numpy(rng.random(tuple(vm.shape)) < 0.8)
    vm |= torch.from_numpy(rng.random(tuple(vm.shape)) < 0.05)
    sm &= torch.from_numpy(rng.random(tuple(sm.shape)) < 0.8)
    for t, k in ((v, 40), (s, 30)):
        flat = t.view(-1)
        at = torch.from_numpy(rng.choice(flat.numel(), k, replace=False))
        flat[at[: k // 2]] = float("nan")
        flat[at[k // 2:]] = torch.from_numpy(
            (rng.standard_normal(k - k // 2) * 1e-39).astype(np.float32))
    ref[3, 0], ref[5, 1] = float("nan"), 1e-40
    args = [t.to(dev) for t in (v, vm, s, sm, poly, ref)]
    want = tcat._dist_plain(*args, *tcat.pack_literal(
        LITERALS["polygon"], dev))
    assert bool(torch.isnan(want).any())
    _force(monkeypatch, form)
    for lit in ("polygon", "point", "line", "multipoint"):
        literal = LITERALS[lit]
        _held(args, *tcat.pack_literal(literal, dev),
              ext=literal[0] not in (tgeo.POINT, tgeo.MULTIPOINT), nan=True)


def _run_literal(r: int, lead: bool):
    """(edges (L, 4), points (P, 2)) f32 numpy: a 31-edge ring around
    (1, 39) and its 31 points (or nothing, ``lead`` false), then r copies
    of one of its edges and r of the point (1, 39)."""
    ring = np.asarray(_ring(31)[1][0], dtype=np.float32)
    edges = np.concatenate([ring[:-1], ring[1:]], 1)
    pts = ring[:-1]
    ls = np.concatenate([edges if lead else edges[:0],
                         np.repeat(edges[5:6], r, 0)])
    lp = np.concatenate([pts if lead else pts[:0],
                         np.repeat(np.float32([[1.0, 39.0]]), r, 0)])
    return ls, lp


def _run_cut(ls, lp, r: int):
    """The literal with its trailing runs cut as the pair kernels cut them:
    one point, and one edge or two as r is odd or even."""
    keep = 2 - (r & 1)
    return ls[: len(ls) - r + keep], lp[: len(lp) - r + 1]


@pytest.mark.parametrize("r", [1, 2, 3, 4, 7])
@pytest.mark.parametrize("kind", ["dist", "pred"])
def test_plain_pair_programs_keep_their_answer_when_a_trailing_run_is_cut(
        r, kind):
    """What the pair kernels rely on to skip pack_literal's pads: a
    trailing run of r identical edges answers as its first one (r odd) or
    two (r even), and a run of r identical points as its first one, in the
    plain versions (the card's kernels are held to them bit for bit)."""
    ta = _quad_array(tgeo, _smoke_quads(400, 17))
    p = tcat.pack_features(ta, np.arange(400), "cpu")
    args = list(p.rows(*tcat.PAIR))
    for lead in (True, False):
        ls, lp = _run_literal(r, lead)
        cut = _run_cut(ls, lp, r)
        full_t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (ls, lp)]
        cut_t = [torch.from_numpy(np.ascontiguousarray(a)) for a in cut]
        if kind == "dist":
            assert torch.equal(tcat._dist_plain(*args, *full_t, True),
                               tcat._dist_plain(*args, *cut_t, True))
            continue
        for op in (0, 1, 2):
            got = tcat._pred_plain(*args, *full_t, op, True, True)
            want = tcat._pred_plain(*args, *cut_t, op, True, True)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), op


@pytest.mark.gpu
@pytest.mark.parametrize("r", [1, 2, 3, 6])
@pytest.mark.parametrize("lead", [True, False])
@pytest.mark.parametrize("form", ["items1", "items8", "lit"])
def test_cuda_pair_kernels_trailing_runs(r, lead, form, monkeypatch):
    """A literal that ends in r copies of one of its edges (each crossing
    some quads' vertex rays: the parity of r shows) and of a point, or is
    nothing but those copies: the kernels, which cut such runs, equal the
    plain versions, which take every copy."""
    dev = _cuda()
    ta = _quad_array(tgeo, _smoke_quads(2000, 23))
    p = tcat.pack_features(ta, np.arange(2000), "cpu")
    args = _pair_on_card(p, dev)
    ls, lp = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in _run_literal(r, lead))
    _force(monkeypatch, form)
    _held(args, ls, lp, True)


def _band_edge_shapes():
    """Features on the polygon literal's edges and corners: points on its
    edges and at its corners, quads sharing an edge or a corner with it,
    lines along its edges, and a copy of it."""
    ring = LITERALS["polygon"][1][0]
    shapes = []
    for (x1, y1), (x2, y2) in zip(ring[:-1], ring[1:]):
        for t in (0.0, 0.25, 0.5):
            shapes.append((tgeo.POINT, [x1 + t * (x2 - x1),
                                        y1 + t * (y2 - y1)]))
        shapes.append((tgeo.LINESTRING, [[x1, y1], [x2, y2]]))
        shapes.append((tgeo.POLYGON, [[[x1, y1], [x2, y2], [x2 + 1, y2 + 1],
                                       [x1 + 1, y1 + 1], [x1, y1]]]))
    shapes.append(LITERALS["polygon"])
    return shapes


@pytest.mark.gpu
def test_cuda_band_edge_rows_go_to_the_refine():
    """Rows on the bands' edges: the kernels equal the plain versions, some
    rows are neither certainly in nor certainly out, and the entry points
    on the card refine them to the CPU's answers."""
    dev = _cuda()
    ta = tgeo.GeometryArray.from_shapes(_band_edge_shapes())
    r = np.arange(len(ta), dtype=np.int64)
    p = tcat.pack_features(ta, r, "cpu")
    args = _pair_on_card(p, dev)
    ls, lp, lpoly = tcat.pack_literal(LITERALS["polygon"], dev)
    _held(args, ls, lp, lpoly)
    unc = 0
    for op in (0, 1, 2):
        ci, co = kgeom.geom_pred(*args, ls, lp, op, lpoly, True)
        unc += int((~ci & ~co).sum())
    assert unc > 0
    refined = 0
    for name in ("intersects", "within", "contains"):
        before = tcat.STATS["refined_rows"]
        got = tcat.batch_predicate(ta, r, name, LITERALS["polygon"], "cuda")
        refined += tcat.STATS["refined_rows"] - before
        want = tcat.batch_predicate(ta, r, name, LITERALS["polygon"], "cpu")
        assert np.array_equal(got, want), name
    assert refined == unc
