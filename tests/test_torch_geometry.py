"""The port's ragged ``GeometryArray`` and the ragged half of
``filter/geom_batch.py`` against the JAX package's, on
``tests/test_features.py``'s and ``tests/test_geom_batch.py``'s inputs.

Every WKT type (points, lines, polygons with holes, the Multi* types)
parses, round-trips and takes, concatenates and reports its envelope
exactly as the reference's; the point column keeps its fast path (two
float64 arrays) and answers the ragged accessors the same way; every batched
predicate over ragged features (intersects, within, distance) equals the
reference's value for value, through both ``geom_batch`` modules and the
port's scalar oracles. No tolerance applies: the same f64 operations run on
the same inputs.
"""

import numpy as np
import pytest

from geomesa_tpu.features import geometry as jgeo
from geomesa_tpu.filter import geom_batch as jgb
from geomesa_tpu.filter import geom_numpy as jgn
from geomesa_tpu_torch.features import geometry as tgeo
from geomesa_tpu_torch.filter import geom_batch as tgb
from geomesa_tpu_torch.filter import geom_numpy as tgn

# tests/test_features.py's literals, one of every type
WKTS = [
    "POINT (30 10)",
    "LINESTRING (30 10, 10 30, 40 40)",
    "POLYGON ((30 10, 40 40, 20 40, 10 20, 30 10))",
    "POLYGON ((35 10, 45 45, 15 40, 10 20, 35 10), (20 30, 35 35, 30 20, 20 30))",
    "MULTIPOINT (10 40, 40 30, 20 20, 30 10)",
    "MULTILINESTRING ((10 10, 20 20, 10 40), (40 40, 30 30, 40 20, 30 10))",
    "MULTIPOLYGON (((30 20, 45 40, 10 40, 30 20)), ((15 5, 40 10, 10 20, 5 10, 15 5)))",
]


def _fields(a):
    return (np.asarray(a.type_codes), np.asarray(a.geom_offsets),
            np.asarray(a.part_offsets), np.asarray(a.ring_offsets),
            np.asarray(a.coords))


def _same(t, j):
    assert len(t) == len(j)
    for x, y in zip(_fields(t), _fields(j)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert np.array_equal(t.bboxes(), j.bboxes())
    assert t.is_points == j.is_points
    for i in range(len(t)):
        assert t.shape(i) == j.shape(i)
        assert t.wkt(i) == j.wkt(i)
        assert np.array_equal(t.feature_coords(i), j.feature_coords(i))


@pytest.mark.parametrize("i", range(len(WKTS)))
def test_every_wkt_type_equals_reference(i):
    t = tgeo.GeometryArray.from_wkt([WKTS[i]])
    j = jgeo.GeometryArray.from_wkt([WKTS[i]])
    _same(t, j)
    assert tgeo.parse_wkt(WKTS[i]) == jgeo.parse_wkt(WKTS[i])
    assert tgeo.parse_wkt(t.wkt(0)) == jgeo.parse_wkt(WKTS[i])


def test_mixed_column_take_concat_equal_reference():
    t = tgeo.GeometryArray.from_wkt(WKTS)
    j = jgeo.GeometryArray.from_wkt(WKTS)
    _same(t, j)
    idx = np.array([6, 0, 3, 3, 1, 5, 2, 4])
    _same(t.take(idx), j.take(idx))
    _same(tgeo.GeometryArray.concat([t, t.take(idx)]),
          jgeo.GeometryArray.concat([j, j.take(idx)]))
    pts = tgeo.GeometryArray.points([1.0, 2.0], [3.0, 4.0])
    jpts = jgeo.GeometryArray.points([1.0, 2.0], [3.0, 4.0])
    _same(tgeo.GeometryArray.concat([pts, t]),
          jgeo.GeometryArray.concat([jpts, j]))


def test_point_column_answers_the_ragged_accessors():
    """A point column holds two arrays and no offsets, yet every accessor
    equals the reference's point array's."""
    rng = np.random.default_rng(3)
    x, y = rng.uniform(-180, 180, 50), rng.uniform(-90, 90, 50)
    t = tgeo.GeometryArray.points(x, y)
    assert t.is_point_column and t.is_points
    assert t._go is None and t._coords is None
    _same(t, jgeo.GeometryArray.points(x, y))
    assert t.point_xy()[0] is t.x
    idx = np.array([4, 9, 4, 0])
    _same(t.take(idx), jgeo.GeometryArray.points(x, y).take(idx))
    assert t.take(idx).is_point_column
    assert tgeo.GeometryArray.from_wkt(["POINT (1 2)", "POINT (3 4)"]
                                       ).is_point_column


def test_bboxes_and_take_of_test_features():
    wkts = ["POLYGON ((0 0, 10 0, 10 5, 0 5, 0 0))", "LINESTRING (-3 -4, 7 8)",
            "POINT (1 2)"]
    t, j = tgeo.GeometryArray.from_wkt(wkts), jgeo.GeometryArray.from_wkt(wkts)
    _same(t, j)
    _same(t.take(np.array([2, 0])), j.take(np.array([2, 0])))


def test_linestrings_constructor_equals_reference():
    rng = np.random.default_rng(4)
    n = 500
    coords = rng.uniform(-50, 50, (2 * n, 2))
    _same(tgeo.GeometryArray.linestrings(coords),
          jgeo.GeometryArray.linestrings(coords))
    offs = np.array([0, 2, 5, 6], dtype=np.int64)
    _same(tgeo.GeometryArray.linestrings(coords[:6], offs),
          jgeo.GeometryArray.linestrings(coords[:6], offs))


def test_replace_rows():
    """The update writer's geometry patch, on point and ragged columns."""
    t = tgeo.GeometryArray.from_wkt(WKTS)
    new = tgeo.GeometryArray.from_wkt(["POINT (1 1)", WKTS[3]])
    out = t.replace_rows(np.array([1, 5]), new)
    want = [WKTS[0], "POINT (1 1)", *WKTS[2:5], WKTS[3], WKTS[6]]
    _same(out, tgeo.GeometryArray.from_wkt(want))
    pts = tgeo.GeometryArray.points([0.0, 1.0, 2.0], [0.0, 1.0, 2.0])
    p2 = pts.replace_rows(np.array([2]),
                          tgeo.GeometryArray.points([9.0], [8.0]))
    assert p2.is_point_column and p2.shape(2) == (tgeo.POINT, [9.0, 8.0])


# -- tests/test_geom_batch.py's ragged inputs, through both modules -----------

def _random_shapes(rng, n):
    """tests/test_geom_batch.py's generator: every geometry type."""
    shapes = []
    for _ in range(n):
        kind = rng.integers(0, 6)
        cx, cy = rng.uniform(-50, 50, 2)
        if kind == 0:
            shapes.append((tgeo.POINT, [cx, cy]))
        elif kind == 1:
            k = int(rng.integers(2, 6))
            pts = np.column_stack([cx + np.cumsum(rng.uniform(-2, 2, k)),
                                   cy + np.cumsum(rng.uniform(-2, 2, k))])
            shapes.append((tgeo.LINESTRING, pts.tolist()))
        elif kind == 2:
            r = rng.uniform(0.5, 4)
            ang = np.linspace(0, 2 * np.pi, int(rng.integers(4, 9)))[:-1]
            ring = np.column_stack([cx + r * np.cos(ang),
                                    cy + r * np.sin(ang)]).tolist()
            ring.append(ring[0])
            shapes.append((tgeo.POLYGON, [ring]))
        elif kind == 3:
            pts = np.column_stack([cx + rng.uniform(-3, 3, 3),
                                   cy + rng.uniform(-3, 3, 3)])
            shapes.append((tgeo.MULTIPOINT, pts.tolist()))
        elif kind == 4:
            lines = []
            for _ in range(2):
                k = int(rng.integers(2, 4))
                pts = np.column_stack([cx + np.cumsum(rng.uniform(-2, 2, k)),
                                       cy + np.cumsum(rng.uniform(-2, 2, k))])
                lines.append(pts.tolist())
            shapes.append((tgeo.MULTILINESTRING, lines))
        else:
            polys = []
            for dx in (0.0, 8.0):
                r = rng.uniform(0.5, 3)
                ang = np.linspace(0, 2 * np.pi, 5)[:-1]
                ring = np.column_stack([cx + dx + r * np.cos(ang),
                                        cy + r * np.sin(ang)]).tolist()
                ring.append(ring[0])
                polys.append([ring])
            shapes.append((tgeo.MULTIPOLYGON, polys))
    return shapes


LITERALS = [
    (tgeo.POLYGON, [[[-20, -20], [20, -20], [20, 20], [-20, 20], [-20, -20]],
                    [[-5, -5], [5, -5], [5, 5], [-5, 5], [-5, -5]]]),
    (tgeo.LINESTRING, [[-30, -30], [0, 0], [30, 25]]),
    (tgeo.POINT, [0.0, 0.0]),
    (tgeo.MULTIPOLYGON, [[[[-15, -15], [-1, -15], [-1, -1], [-15, -1],
                           [-15, -15]]],
                         [[[1, 1], [15, 1], [15, 15], [1, 15], [1, 1]]]]),
    (tgeo.MULTIPOINT, [[2.0, 2.0], [-40.0, -40.0]]),
]


@pytest.fixture(scope="module")
def arrays():
    shapes = _random_shapes(np.random.default_rng(42), 300)
    return (tgeo.GeometryArray.from_shapes(shapes),
            jgeo.GeometryArray.from_shapes(shapes))


# within takes polygonal literals only
PREDICATES = [(fn, i) for fn in ("batch_intersects", "batch_within",
                                 "batch_distance")
              for i, lit in enumerate(LITERALS)
              if fn != "batch_within"
              or lit[0] in (tgeo.POLYGON, tgeo.MULTIPOLYGON)]


@pytest.mark.parametrize("fn,lit_i", PREDICATES)
def test_batch_predicates_equal_reference(arrays, fn, lit_i):
    t, j = arrays
    lit = LITERALS[lit_i]
    idx = np.concatenate([np.arange(len(t)), [5, 17, 5]])
    got = getattr(tgb, fn)(t, idx, lit)
    want = getattr(jgb, fn)(j, idx, lit)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    scalar = {"batch_intersects": tgn.geometry_intersects,
              "batch_within": tgn.geometry_within,
              "batch_distance": tgn.geometry_distance}[fn]
    ref_scalar = {"batch_intersects": jgn.geometry_intersects,
                  "batch_within": jgn.geometry_within,
                  "batch_distance": jgn.geometry_distance}[fn]
    for i in range(0, len(t), 7):
        assert scalar(t, i, lit) == ref_scalar(j, i, lit)
    assert getattr(tgb, fn)(t, np.empty(0, np.int64), lit).shape == (0,)


@pytest.mark.parametrize("lit_i", range(len(LITERALS)))
def test_soups_equal_reference(arrays, lit_i):
    """The coordinate and segment soups the batched predicates reduce."""
    t, j = arrays
    idx = np.array([3, 0, 299, 150, 3])
    for a, b in zip(tgb.gather_coords(t, idx), jgb.gather_coords(j, idx)):
        assert np.array_equal(a, b)
    for a, b in zip(tgb.build_segments(t, idx), jgb.build_segments(j, idx)):
        assert np.array_equal(a, b)
