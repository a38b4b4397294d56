"""The port's host layers (geomesa_tpu_torch, numpy copies free of JAX)
against the JAX package's originals, on the same seeded inputs. Every
comparison is exact equality."""

import numpy as np
import pytest

from geomesa_tpu.curves.binnedtime import time_to_binned_time as j_binned
from geomesa_tpu.curves.sfc import Z3SFC as JZ3SFC
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.filter.extract import extract_bboxes as j_bboxes
from geomesa_tpu.filter.extract import extract_intervals as j_intervals
from geomesa_tpu.filter.parser import parse_ecql as j_parse
from geomesa_tpu.index import device as jdevice
from geomesa_tpu_torch.curves.binnedtime import time_to_binned_time as t_binned
from geomesa_tpu_torch.curves.sfc import Z3SFC as TZ3SFC
from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
from geomesa_tpu_torch.filter.extract import extract_bboxes as t_bboxes
from geomesa_tpu_torch.filter.extract import extract_intervals as t_intervals
from geomesa_tpu_torch.filter.parser import parse_ecql as t_parse
from geomesa_tpu_torch.index import device as tdevice

EDGES_X = [-180.0, 180.0, 0.0, -1e-300, 179.99999999999997, -180.1, 180.1,
           -179.99999999999997]
EDGES_Y = [-90.0, 90.0, 0.0, 1e-300, 89.99999999999999, -90.1, 90.1,
           -89.99999999999999]


def _coords(n=20_000, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-185, 185, n)
    y = rng.uniform(-92, 92, n)
    x[:8] = EDGES_X
    y[:8] = EDGES_Y
    return x, y


@pytest.mark.parametrize("axis", ["lon", "lat"])
def test_fp62_planes(axis):
    x, y = _coords()
    v = x if axis == "lon" else y
    # below the size where the reference takes its native encoder: the
    # numpy path is the canonical semantics both packages share
    jf = jdevice.fp62_lon if axis == "lon" else jdevice.fp62_lat
    tf = tdevice.fp62_lon if axis == "lon" else tdevice.fp62_lat
    for j, t in zip(jf(v), tf(v)):
        assert j.dtype == t.dtype == np.int32
        assert np.array_equal(j, t)
    for edge in (EDGES_X if axis == "lon" else EDGES_Y):
        assert [int(a) for a in jf(edge)] == [int(a) for a in tf(edge)]


def _millis(n=20_000, seed=3):
    rng = np.random.default_rng(seed)
    base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
    ms = base + rng.integers(-400 * 86400000, 400 * 86400000, n)
    ms[:3] = [0, base, base + 7 * 86400000 - 1]
    return ms


def test_binned_time_week():
    ms = _millis()
    jb, jo = j_binned(ms, "week")
    tb, to = t_binned(ms, "week")
    assert np.array_equal(jb, tb) and np.array_equal(jo, to)


def test_z3_keys():
    x, y = _coords()
    ms = _millis()
    _, offs = t_binned(ms, "week")
    jz = JZ3SFC.apply("week")
    tz = TZ3SFC.apply("week")
    t = np.minimum(offs, int(tz.time.max))
    assert np.array_equal(jz.index(x, y, t, lenient=True),
                          tz.index(x, y, t, lenient=True))
    with pytest.raises(ValueError):
        tz.index(x, y, t)   # strict mode refuses the out-of-range rows


SPECS = [
    "name:String,val:Int,dtg:Date,*geom:Point;geomesa.z3.interval=week",
    "name:String,age:Int,score:Float,dtg:Date,*geom:Point:srid=4326;"
    "geomesa.z3.interval=day,geomesa.column.groups=age:score",
    "flag:Boolean,n:Long,d:Double,when:Date,*pt:Point",
]


@pytest.mark.parametrize("spec", SPECS)
def test_sft_from_spec(spec):
    j = JSFT.from_spec("t", spec)
    t = TSFT.from_spec("t", spec)
    assert repr(j) == repr(t).replace("geomesa_tpu_torch", "geomesa_tpu")
    assert t.to_spec() == j.to_spec()
    assert t.geometry_attribute.name == j.geometry_attribute.name
    assert t.dtg_attribute.name == j.dtg_attribute.name
    assert t.z3_interval == j.z3_interval
    assert t.device_column_group == j.device_column_group


POLY = "POLYGON((-10 20, 40 20, 40 60, -10 60, 15 40, -10 20))"
DURING = "dtg DURING 2020-01-05T00:00:00Z/2020-01-12T00:00:00Z"
ECQL = [
    f"BBOX(geom, -10, 30, 30, 55) AND {DURING} AND val > 10",
    f"INTERSECTS(geom, {POLY}) AND {DURING}",
    f"INTERSECTS(geom, {POLY})",
    "BBOX(geom, 170, -10, -170, 10) AND name IN ('a', 'b')",
    "INTERSECTS(geom, POLYGON((0 0, 10 0, 10 10, 0 10, 0 0)))",
    "INTERSECTS(geom, POINT(5 5)) AND val <= 3",
    f"BBOX(geom, -60, -30, 60, 30) AND ({DURING} OR "
    "dtg DURING 2020-01-20T00:00:00Z/2020-01-22T00:00:00Z)",
    "BBOX(geom, -60, -30, 60, 30) AND dtg BETWEEN "
    "2020-01-03T00:00:00Z AND 2020-01-04T00:00:00Z AND NOT (name = 'c')",
    "BBOX(geom, -60, -30, 60, 30) AND dtg > 2020-01-03T00:00:00Z "
    "AND val <> 4 AND val >= 2",
    "BBOX(geom, 0, 0, 1, 1) AND dtg DURING "
    "2021-06-01T00:00:00Z/2021-05-01T00:00:00Z",
]


@pytest.mark.parametrize("ecql", ECQL)
def test_parse_and_extract(ecql):
    jf, tf = j_parse(ecql), t_parse(ecql)
    assert repr(tf) == repr(jf)
    tb, jb = t_bboxes(tf, "geom"), j_bboxes(jf, "geom")
    assert (tb.boxes, tb.exact) == (jb.boxes, jb.exact)
    ti, ji = t_intervals(tf, "dtg"), j_intervals(jf, "dtg")
    assert (ti.intervals, ti.exact) == (ji.intervals, ji.exact)
