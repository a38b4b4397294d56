"""The port's prepared queries (``planner.prepare`` → ``PreparedQuery`` /
the recipe fast path's ``FusedPrepared``) against the JAX package's on
identical state: an 8,000-row table with gather blocks of 512 rows in both
packages. Every comparison is exact:

- ``prepare(q).count()`` and ``int(count_async())`` for box+time,
  box+time+residual, the polygon refine (not device-exact: ``count()``
  runs the planner's path and ``count_async`` raises in both), INCLUDE and
  an empty time window, with the fused program on and off and range
  pruning on and off;
- ``_shape_key`` string for string on a battery of filters (and the same
  ``Unsupported`` refusals);
- the recipe path: a sequence of prepares whose ``STATS`` deltas
  (``shape_hits``, ``shape_misses``, ``bind_failures``, ``queries``) and
  counts equal the reference's step by step — a repeat shape binds, an
  empty bind, a bind failure (a vocabulary miss shrinks an ``IN``), a
  non-fusable shape's negative entry;
- ``ROUNDS``: one blocking readback per ``PreparedQuery.count``, as the
  reference's ledger counts it.

The port runs with device="cpu" here (the kernels' plain versions).
"""

import numpy as np
import pytest

from geomesa_tpu import config as jconfig
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.features.table import FeatureTable as JTable
from geomesa_tpu.filter.parser import parse_ecql as jparse
from geomesa_tpu.index import compiled as jcompiled
from geomesa_tpu.index import prune as jprune
from geomesa_tpu.index import scan as jscan
from geomesa_tpu.index.guards import QueryTimeout as JTimeout
from geomesa_tpu.index.planner import QueryPlanner as JPlanner
from geomesa_tpu.index.spatial import Z3Index as JZ3
from geomesa_tpu_torch import config as tconfig
from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.filter.parser import parse_ecql as tparse
from geomesa_tpu_torch.index import compiled as tcompiled
from geomesa_tpu_torch.index import scan as tscan
from geomesa_tpu_torch.index.guards import QueryTimeout as TTimeout
from geomesa_tpu_torch.index.planner import QueryPlanner as TPlanner
from geomesa_tpu_torch.index.spatial import Z3Index as TZ3

SPEC = ("name:String,age:Int,score:Float,dtg:Date,*geom:Point;"
        "geomesa.z3.interval=week")
POLY = "POLYGON((-10 20, 40 20, 40 60, -10 60, 15 40, -10 20))"
DURING = "dtg DURING 2020-01-03T00:00:00Z/2020-01-15T00:00:00Z"
SHORT = "dtg DURING 2020-01-04T00:00:00Z/2020-01-07T00:00:00Z"
EMPTY_TIME = (f"{SHORT} AND dtg DURING "
              "2020-01-20T00:00:00Z/2020-01-22T00:00:00Z")


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


def _both(n, seed=13, timeout_ms=None):
    cols = _columns(n, seed)
    jsft = JSFT.from_spec("s", SPEC)
    jt = JTable.build(jsft, cols)
    jp = JPlanner(jsft, jt, [JZ3(jsft, jt)], timeout_ms=timeout_ms)
    tsft = TSFT.from_spec("s", SPEC)
    tt = TTable.build(tsft, cols)
    tp = TPlanner(tsft, tt, [TZ3(tsft, tt, "cpu")], timeout_ms=timeout_ms)
    return jp, tp


@pytest.fixture(autouse=True)
def _small_blocks():
    vars(jprune).pop("BLOCK_SIZE", None)
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.set(512)
    yield
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.unset()
        c.FUSED_QUERY.unset()
        c.PRUNE_ENABLED.unset()


@pytest.fixture(scope="module")
def world():
    vars(jprune).pop("BLOCK_SIZE", None)
    jconfig.PRUNE_BLOCK.set(512)
    tconfig.PRUNE_BLOCK.set(512)
    try:
        return _both(8000)
    finally:
        jconfig.PRUNE_BLOCK.unset()
        tconfig.PRUNE_BLOCK.unset()


QUERIES = {
    "box_time": f"BBOX(geom, 10, 10, 40, 40) AND {SHORT}",
    "box_time_resid": f"BBOX(geom, -60, -30, 60, 30) AND {DURING} "
                      "AND age > 30 AND name <> 'gamma'",
    "polygon": f"INTERSECTS(geom, {POLY}) AND {DURING}",
    "include": "INCLUDE",
    "empty_time": f"BBOX(geom, 10, 10, 40, 40) AND {EMPTY_TIME}",
    "time_resid": f"{DURING} AND name IN ('alpha', 'beta')",
}


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("prune", [True, False])
@pytest.mark.parametrize("qkey", list(QUERIES))
def test_prepared_count_equals_reference(world, qkey, fused, prune):
    jp, tp = world
    for c in (jconfig, tconfig):
        c.FUSED_QUERY.set(fused)
        c.PRUNE_ENABLED.set(prune)
    q = QUERIES[qkey]
    jq, tq = jp.prepare(q), tp.prepare(q)
    want = jq.count()
    assert tq.count() == want == jp.count(q)
    assert tq.device_exact == jq.device_exact
    if qkey == "polygon":
        assert not tq.device_exact
        for pq in (jq, tq):
            with pytest.raises(ValueError, match="host execution"):
                pq.count_async()
    elif qkey == "empty_time":
        assert want == 0
        assert tq.count_async() is None and jq.count_async() is None
    else:
        assert want > 0
        assert int(tq.count_async()) == int(jq.count_async()) == want
    assert np.array_equal(tq.select_indices(), jq.select_indices())


SHAPES = [
    f"BBOX(geom, 1, 2, 3, 4) AND {DURING}",
    f"BBOX(geom, 1, 2, 3, 4) AND {DURING} AND age > 3",
    f"INTERSECTS(geom, {POLY}) AND dtg DURING "
    "2020-01-03T00:00:00Z/2020-01-15T00:00:00Z",
    "name IN ('a', 'b', 'c')",
    "NOT (age <= 5) OR score < 0.5",
    "INCLUDE",
    "EXCLUDE",
    "age = 7 AND name = 'beta'",
    "st_distance(geom, POINT(0 0)) < 5",
    "st_contains(POLYGON((0 0, 1 0, 1 1, 0 0)), geom)",
    f"BBOX(geom, -10, -10, 10, 10) OR BBOX(geom, 20, 20, 30, 30)",
]


@pytest.mark.parametrize("q", SHAPES)
def test_shape_key_equals_reference(q):
    assert tcompiled._shape_key(tparse(q)) == jcompiled._shape_key(jparse(q))


def test_shape_key_refuses_what_the_reference_refuses():
    q = "name IS NULL"
    with pytest.raises(jscan.Unsupported):
        jcompiled._shape_key(jparse(q))
    with pytest.raises(tscan.Unsupported):
        tcompiled._shape_key(tparse(q))


_KEYS = ("shape_hits", "shape_misses", "bind_failures", "queries")


def _delta(stats, before):
    return {k: stats[k] - before[k] for k in _KEYS}


# one planner pair per sequence: the recipe cache lives on the planner
RECIPE_SEQ = [
    # the first of a shape: a miss, the ordinary path registers it
    f"BBOX(geom, 10, 10, 40, 40) AND {SHORT}",
    # the same shape with new values: the fast path binds it
    f"BBOX(geom, -30, -20, 0, 10) AND {DURING}",
    "BBOX(geom, 100, -60, 150, -20) AND "
    "dtg DURING 2020-01-10T00:00:00Z/2020-01-25T00:00:00Z",
    # a two-window shape: a miss; then the same shape whose windows
    # intersect to nothing: an empty bind
    f"BBOX(geom, 10, 10, 40, 40) AND {DURING} AND dtg DURING "
    "2020-01-05T00:00:00Z/2020-01-20T00:00:00Z",
    f"BBOX(geom, 10, 10, 40, 40) AND {SHORT} AND dtg DURING "
    "2020-01-20T00:00:00Z/2020-01-22T00:00:00Z",
    # a residual shape: miss, then binds
    f"BBOX(geom, -60, -30, 60, 30) AND {DURING} AND name IN "
    "('alpha', 'beta', 'gamma')",
    f"BBOX(geom, -50, -30, 70, 30) AND {DURING} AND name IN "
    "('beta', 'gamma', 'delta')",
    # a vocabulary miss shrinks the IN's pad: the residual key drifts, a
    # bind failure, and the ordinary path serves it
    f"BBOX(geom, -50, -30, 70, 30) AND {DURING} AND name IN "
    "('beta', 'nope', 'nada')",
    # a non-fusable shape (no box): a negative entry, then neither a hit
    # nor a miss
    f"{DURING} AND age > 30",
    f"{SHORT} AND age > 70",
    # the polygon refine: count() falls back; its shape is not fusable
    f"INTERSECTS(geom, {POLY}) AND {DURING}",
    f"INTERSECTS(geom, {POLY}) AND {SHORT}",
]


def test_recipe_stats_and_counts_equal_reference():
    jp, tp = _both(8000, seed=29)
    kinds = []
    for q in RECIPE_SEQ:
        j0, t0 = dict(jcompiled.STATS), dict(tcompiled.STATS)
        jq, tq = jp.prepare(q), tp.prepare(q)
        dj, dt = _delta(jcompiled.STATS, j0), _delta(tcompiled.STATS, t0)
        assert dt == dj, q
        assert type(tq).__name__ == type(jq).__name__, q
        assert tq.count() == jq.count() == jp.count(q), q
        kinds.append(type(tq).__name__)
    fp, pq = "FusedPrepared", "PreparedQuery"
    assert kinds == [pq, fp, fp, pq, fp, pq, fp, pq, pq, pq, pq, pq]


def test_rounds_one_readback_per_prepared_count(world):
    """Each ``PreparedQuery.count`` makes one blocking readback (``_fetch``)
    in both packages' ledgers — fused, range-pruned staged and full-mask
    staged, and through the recipe fast path — and ``count_async`` makes
    none, and no host sync inside ``count_async`` (``scan.host_syncs``:
    the port's fused program gates, counts and compacts on the device)."""
    jp, tp = world
    cases = [(True, True), (False, True), (False, False)]
    for fused, prune in cases:
        for c in (jconfig, tconfig):
            c.FUSED_QUERY.set(fused)
            c.PRUNE_ENABLED.set(prune)
        for q in (QUERIES["box_time"], QUERIES["box_time_resid"],
                  f"BBOX(geom, 0, 0, 30, 30) AND {SHORT}"):
            jq, tq = jp.prepare(q), tp.prepare(q)
            js, ts = jscan.ROUNDS.snapshot(), tscan.ROUNDS.snapshot()
            assert tq.count() == jq.count()
            assert tscan.ROUNDS.dispatches - ts[0] == 1
            assert jscan.ROUNDS.dispatches - js[0] == 1
            d0 = tscan.ROUNDS.dispatches
            with tscan.host_syncs() as h:
                tq.count_async()
            assert tscan.ROUNDS.dispatches == d0
            assert h.count == 0, (fused, prune, q)


def test_planner_timeout_raises_like_reference():
    jp, tp = _both(600, timeout_ms=0.0)
    q = f"BBOX(geom, 10, 10, 40, 40) AND {SHORT}"
    with pytest.raises(JTimeout):
        jp.count(q)
    with pytest.raises(TTimeout):
        tp.count(q)
