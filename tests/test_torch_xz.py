"""The port's Z2 and XZ curves and the Z2/XZ2/XZ3 indexes against the JAX
package's, on identical inputs.

- ``Z2SFC``, ``XZ2SFC`` and ``XZ3SFC``: ``index`` (strict and ``lenient``,
  envelopes outside the bounds, zero-extent envelopes whose code length
  falls back to g) and ``ranges`` / ``ranges_arrays`` / ``ranges_bbox`` on
  ``tests/test_curves.py``'s inputs and on random envelopes, key for key;
- ``Z2Index``, ``XZ2Index``, ``XZ3Index``: the host keys, the device sort
  permutation (equal to ``np.lexsort`` of the reference's key planes and to
  the reference's own), the sorted host planes, the device columns, and
  ``candidate_blocks`` of box and box+time plans, byte for byte;
- ``device_sort_perm`` over int32 planes with ties, against ``np.lexsort``.

Exact equality throughout: keys, ranges, permutations and block ids are
integers.
"""

import numpy as np
import pytest
import torch

from geomesa_tpu.curves import sfc as jsfc
from geomesa_tpu.curves import xz as jxz
from geomesa_tpu.curves import zorder as jzorder
from geomesa_tpu.features import geometry as jgeo
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.features.table import FeatureTable as JTable
from geomesa_tpu.index import spatial as jspatial
from geomesa_tpu_torch import config as tconfig
from geomesa_tpu_torch.curves import sfc as tsfc
from geomesa_tpu_torch.curves import xz as txz
from geomesa_tpu_torch.curves import zorder as tzorder
from geomesa_tpu_torch.curves.binnedtime import TimePeriod
from geomesa_tpu_torch.features import geometry as tgeo
from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.index import spatial as tspatial


def _envelopes(n: int, seed: int):
    """n envelopes: random spans up to 20 x 10 degrees, a tenth of them
    points (zero extent), some past the lon/lat bounds (the lenient
    clamp)."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-185, 180, n)
    y0 = rng.uniform(-92, 90, n)
    w = rng.uniform(0, 20, n)
    h = rng.uniform(0, 10, n)
    w[::10] = 0.0
    h[::10] = 0.0
    return x0, y0, x0 + w, y0 + h


@pytest.mark.parametrize("g", [1, 6, 12, 16])
def test_xz2_index_equals_reference(g):
    x0, y0, x1, y1 = _envelopes(5000, g)
    t = txz.XZ2SFC.apply(g).index_bbox(x0, y0, x1, y1, lenient=True)
    j = jxz.XZ2SFC.apply(g).index_bbox(x0, y0, x1, y1, lenient=True)
    assert t.dtype == j.dtype and np.array_equal(t, j)
    # strict bounds raise in both
    with pytest.raises(ValueError):
        txz.XZ2SFC.apply(g).index_bbox(-181.0, 0.0, 0.0, 1.0)
    boxes = [(-50.0, -50.0, -49.0, -49.5), (0.0, 0.0, 10.0, 10.0),
             (179.0, 89.0, 180.0, 90.0), (1.0, 1.0, 1.0, 1.0)]
    for b in boxes:
        assert np.array_equal(txz.XZ2SFC.apply(g).index_bbox(*b),
                              jxz.XZ2SFC.apply(g).index_bbox(*b))


@pytest.mark.parametrize("period", ["day", "week", "month"])
def test_xz3_index_equals_reference(period):
    x0, y0, x1, y1 = _envelopes(3000, 7)
    rng = np.random.default_rng(8)
    tsf = txz.XZ3SFC.apply(12, TimePeriod.parse(period))
    jsf = jxz.XZ3SFC.apply(12, jxz.TimePeriod.parse(period))
    t = rng.uniform(0, tsf.bounds[2][1], len(x0))
    mins = np.stack([x0, y0, t], 1)
    maxs = np.stack([x1, y1, t], 1)
    assert np.array_equal(tsf.index(mins, maxs, lenient=True),
                          jsf.index(mins, maxs, lenient=True))


def _ranges(rs):
    return [(r.lower, r.upper, r.contained) for r in rs]


WINDOWS = [(-20.0, -20.0, 20.0, 20.0), (-10.0, -10.0, 10.0, 10.0),
           (-12.0, 28.0, 14.0, 50.0), (170.0, 80.0, 180.0, 90.0),
           (-180.0, -90.0, 180.0, 90.0)]


@pytest.mark.parametrize("w", WINDOWS)
@pytest.mark.parametrize("max_ranges", [None, 50, 2000])
def test_xz2_ranges_equal_reference(w, max_ranges):
    t = txz.XZ2SFC.apply(12).ranges_bbox([w], max_ranges=max_ranges)
    j = jxz.XZ2SFC.apply(12).ranges_bbox([w], max_ranges=max_ranges)
    assert _ranges(t) == _ranges(j) and len(t) > 0


@pytest.mark.parametrize("w", WINDOWS[:3])
def test_xz3_ranges_equal_reference(w):
    tsf = txz.XZ3SFC.apply(12, TimePeriod.WEEK)
    jsf = jxz.XZ3SFC.apply(12, jxz.TimePeriod.WEEK)
    q = [(w[0], w[1], 1000.0, w[2], w[3], 200_000.0)]
    assert _ranges(tsf.ranges(q, max_ranges=2000)) == \
        _ranges(jsf.ranges(q, max_ranges=2000))


def test_z2_index_and_ranges_equal_reference():
    rng = np.random.default_rng(0)
    x = rng.uniform(-180, 180, 500)
    y = rng.uniform(-90, 90, 500)
    t, j = tsfc.Z2SFC(), jsfc.Z2SFC()
    assert np.array_equal(t.index(x, y), j.index(x, y))
    assert int(t.index(181.0, 0.0, lenient=True)) \
        == int(j.index(181.0, 0.0, lenient=True))
    with pytest.raises(ValueError):
        t.index(181.0, 0.0)
    for w in WINDOWS:
        for mr in (500, 2000):
            ta, ja = t.ranges_arrays([w], max_ranges=mr), \
                j.ranges_arrays([w], max_ranges=mr)
            for a, b in zip(ta, ja):
                assert np.array_equal(a, b)
            assert _ranges(t.ranges([w], max_ranges=mr)) == \
                _ranges(j.ranges([w], max_ranges=mr))
    z = t.index(x, y)
    for a, b in zip(tzorder.z2_decode(z), jzorder.z2_decode(z)):
        assert np.array_equal(a, b)


# -- the indexes ---------------------------------------------------------------

BSZ = 256


@pytest.fixture(scope="module")
def small_blocks():
    from geomesa_tpu import config as jconfig
    from geomesa_tpu.index import prune as jprune
    vars(jprune).pop("BLOCK_SIZE", None)
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.set(BSZ)
    yield
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.unset()


def _shapes(n: int, seed: int):
    """Lines and polygons (a fifth of each feature set a polygon), with
    clustered and duplicate envelopes (ties in the keys)."""
    x0, y0, x1, y1 = _envelopes(n, seed)
    x0, x1 = np.clip(x0, -180, 180), np.clip(x1, -180, 180)
    y0, y1 = np.clip(y0, -90, 90), np.clip(y1, -90, 90)
    x0[n // 2: n // 2 + 50] = x0[0]     # duplicate envelopes: key ties
    x1[n // 2: n // 2 + 50] = x1[0]
    y0[n // 2: n // 2 + 50] = y0[0]
    y1[n // 2: n // 2 + 50] = y1[0]
    out = []
    for i in range(n):
        if i % 5 == 4:
            ring = [[x0[i], y0[i]], [x1[i], y0[i]], [x1[i], y1[i]],
                    [x0[i], y1[i]], [x0[i], y0[i]]]
            out.append((tgeo.POLYGON, [ring]))
        else:
            out.append((tgeo.LINESTRING, [[x0[i], y0[i]], [x1[i], y1[i]]]))
    return out


def _both(kind: str, n: int = 6000, seed: int = 3):
    rng = np.random.default_rng(seed)
    if kind == "z2":
        spec = "age:Int,*geom:Point"
        x = rng.uniform(-180, 180, n)
        y = rng.uniform(-90, 90, n)
        x[100:150] = x[0]
        y[100:150] = y[0]
        jg, tg = (x, y), (x, y)
    else:
        spec = "age:Int,*geom:LineString"
        shapes = _shapes(n, seed)
        jg = jgeo.GeometryArray.from_shapes(shapes)
        tg = tgeo.GeometryArray.from_shapes(shapes)
    cols = {"age": rng.integers(0, 100, n).astype(np.int32)}
    if kind == "xz3":
        spec = "age:Int,dtg:Date,*geom:LineString;geomesa.z3.interval=week"
        base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
        cols["dtg"] = base + rng.integers(0, 30 * 86400000, n)
    J = {"z2": jspatial.Z2Index, "xz2": jspatial.XZ2Index,
         "xz3": jspatial.XZ3Index}[kind]
    T = {"z2": tspatial.Z2Index, "xz2": tspatial.XZ2Index,
         "xz3": tspatial.XZ3Index}[kind]
    jsft, tsft = JSFT.from_spec("t", spec), TSFT.from_spec("t", spec)
    jt = JTable.build(jsft, dict(cols, geom=jg))
    tt = TTable.build(tsft, dict(cols, geom=tg))
    return J(jsft, jt), T(tsft, tt, "cpu")


@pytest.mark.parametrize("kind", ["z2", "xz2", "xz3"])
def test_index_perm_planes_and_columns_equal_reference(small_blocks, kind):
    ji, ti = _both(kind)
    assert ti.name == ji.name
    keys = ti._sort_keys()
    want = np.lexsort(tuple(reversed(keys)))
    perm = ti.perm.numpy()
    assert np.array_equal(perm, want)
    assert np.array_equal(perm, np.asarray(ji.perm))
    key = "_z" if kind == "z2" else "_xz"
    assert np.array_equal(getattr(ti, key), np.asarray(getattr(ji, key)))
    sorted_name = "sorted_z" if kind == "z2" else "sorted_xz"
    assert np.array_equal(getattr(ti, sorted_name),
                          np.asarray(getattr(ji, sorted_name)))
    if kind == "xz3":
        assert np.array_equal(ti.sorted_bins, np.asarray(ji.sorted_bins))
    jcols = {k: np.asarray(v) for k, v in ji.device.columns.items()}
    tcols = {k: v.numpy() for k, v in ti.device.columns.items()}
    assert set(tcols) == set(jcols)
    for k in tcols:
        assert tcols[k].dtype == jcols[k].dtype, k
        assert np.array_equal(tcols[k], jcols[k]), k
    # a point layer's keys and planes come from the native encoder
    # (``encode_s``), an extent layer's from numpy (``keys_s``)
    first = "encode_s" if kind == "z2" else "keys_s"
    assert set(ti.build_stages) >= {first, "upload_s", "sort_s",
                                    "planes_s", "gather_s"}


QUERIES = [
    "BBOX(geom, -20, -20, 20, 20)",
    "BBOX(geom, -12, 28, 14, 50) AND age > 30",
    "INTERSECTS(geom, POLYGON ((-12 30, 10 28, 14 44, -2 50, -12 30)))",
    "BBOX(geom, 170, 80, 180, 90) OR BBOX(geom, -180, -90, -170, -80)",
    "BBOX(geom, -20, -20, 20, 20) AND "
    "dtg DURING 2020-01-03T00:00:00Z/2020-01-15T00:00:00Z",
]


@pytest.mark.parametrize("kind", ["z2", "xz2", "xz3"])
@pytest.mark.parametrize("q", QUERIES)
def test_plans_and_candidate_blocks_equal_reference(small_blocks, kind, q):
    if "dtg" in q and kind != "xz3":
        q = q.split(" AND dtg")[0]
    ji, ti = _both(kind)
    jp, tp = ji.plan(_parse_j(q)), ti.plan(_parse_t(q))
    assert tp.primary_kind == jp.primary_kind
    assert tp.cost == jp.cost
    for a, b in ((tp.boxes_loose, jp.boxes_loose), (tp.windows, jp.windows)):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a, b)
    assert str(tp.residual_host) == str(jp.residual_host)
    assert (tp.residual_device is None) == (jp.residual_device is None)
    tb, jb = ti.candidate_blocks(tp), ji.candidate_blocks(jp)
    assert (tb is None) == (jb is None)
    if tb is not None:
        assert np.array_equal(tb, jb) and tb.dtype == jb.dtype
    if kind != "z2" and tp.boxes_loose is not None:
        assert tp.primary_kind == "bbox_overlap"


def _parse_t(q):
    from geomesa_tpu_torch.filter.parser import parse_ecql
    return parse_ecql(q)


def _parse_j(q):
    from geomesa_tpu.filter.parser import parse_ecql
    return parse_ecql(q)


@pytest.mark.parametrize("planes", [1, 2, 3, 4])
def test_device_sort_perm_equals_lexsort(planes):
    """The stable pass-per-plane sort over int32 planes with heavy ties
    (the first planes from three values) equals ``np.lexsort``."""
    rng = np.random.default_rng(planes)
    n = 20_000
    keys = [rng.integers(0, 3, n).astype(np.int32) for _ in range(planes - 1)]
    keys.append(rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32))
    keys[-1][:500] = keys[-1][0]
    perm = tspatial.device_sort_perm([torch.from_numpy(k) for k in keys])
    assert np.array_equal(perm.numpy(), np.lexsort(tuple(reversed(keys))))
