"""The attribute index and the reference's index set in the port
(``index/attribute.py``, ``FullScanIndex``, the staged ``count_at`` /
``select_at`` over a plan's runs, ``fused_scan``'s RUNS form), against the
JAX package on identical seeded inputs:

- the reference's own attribute-index suite (``tests/test_attribute_index.py``:
  8,000 rows, seed 3, ``name`` and ``val`` indexed) — every query's count,
  ascending rows, chosen index (``explain["index"]``), ``candidates`` and
  explain keys equal, and each attribute index's sort permutation equal to
  the reference's (and to ``np.lexsort``);
- random probes on a schema indexing a String, an Int, a Long, a Float
  (with NaN, -0.0 and 0.0) and a Date attribute: equality, ranges and
  ``IN`` ANDed with boxes, windows, residuals and a polygon, under auths,
  on the main table and after appends (a pending delta), a flush, removes,
  updates and age-off — counts, rows and the chosen index equal;
- the staged ``count_at``/``select_at`` over a plan's runs against the
  reference's over the same positions, and the cutting of runs into
  pieces; a sliced plan whose residual is past the program (17 columns);
- the index pick: ``geomesa.indices`` naming the spatial index, an
  attribute only (the full-scan index then serves), a schema without a
  geometry, and ``s2``/``s3`` (the S2/S3 index first, the full-scan index
  beside it); the Z3 ``key_ranges``;
- ``explain`` with and without ``analyze``, over a pending delta;
- the guards of ``tests/test_guards_views.py:35-85`` through
  ``add_interceptor``.

Where the reference is at fault the port answers what numpy answers, and
the test asserts the known difference: a repeated ``IN`` value (the
reference keeps one slice a listed value, so ``name IN ('ann','ann')``
counts 3,290 of 1,645 rows) and a ``>``/``>=`` range on a Float attribute
with NaN (the reference's slice runs to the end, where NaN sorts, and
takes the NaN rows). Tolerance: none — counts, rows and permutations
compare exactly. The port runs with device="cpu" (the plain versions).

The ``gpu`` tests hold ``fused_scan``'s RUNS form to its plain version on
the card (unaligned starts, runs of 1-3 rows, several runs in one block,
empty runs, a run ending at the table's last row, count and mask, the VIS
form, a boxless stage, no windows), a sliced count to one RUNS launch with
no host sync, and the store's attribute answers on the card to the CPU's.
They import nothing of JAX: ``python -m pytest --noconftest -m gpu
tests/test_torch_attribute.py`` runs them on the card.
"""

import importlib

import numpy as np
import pytest
import torch

from geomesa_tpu_torch import DataStoreFinder
from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.filter.parser import parse_ecql as tparse
from geomesa_tpu_torch.index import scan as tscan
from geomesa_tpu_torch.index.attribute import (AttributeIndex,
                                               indexed_attributes,
                                               keys_to_values, value_keys)
from geomesa_tpu_torch.index.device import fp62
from geomesa_tpu_torch.index.guards import (FullTableScanGuard,
                                            GraduatedQueryGuard,
                                            QueryGuardError, SizeAndDuration,
                                            TemporalQueryGuard)
from geomesa_tpu_torch.index.spatial import _boxes_fp62 as t_fp62
from geomesa_tpu_torch.kernels import compact as kcompact
from geomesa_tpu_torch.kernels import fused_scan as kscan


def _ref(name: str):
    """A module of the JAX package (imported only by the CPU tests)."""
    pytest.importorskip("jax")
    return importlib.import_module(name)


def _pair(spec: str, cols: dict, name: str = "t", vis=None, fids=None):
    """(reference store, port store) holding one table of ``cols``."""
    JStore = _ref("geomesa_tpu.datastore").TpuDataStore
    JTable = _ref("geomesa_tpu.features.table").FeatureTable
    js = JStore()
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    for s, tbl in ((js, JTable), (ts, TTable)):
        s.create_schema(name, spec)
        s.load(name, tbl.build(s.get_schema(name), cols, visibilities=vis,
                               fids=fids))
    return js, ts


def _same(js, ts, q, type_name="t", auths=None, rows=True):
    """Counts, rows and the chosen index of both stores; returns the
    count."""
    jc = js.count(type_name, q, auths=auths)
    tc = ts.count(type_name, q, auths=auths)
    assert tc == jc, q
    if rows:
        jr = np.sort(js.query(type_name, q, auths=auths).indices)
        tr = ts.query(type_name, q, auths=auths).indices
        assert np.array_equal(tr, jr), q
    je = js.planner(type_name).plan(q).explain
    te = ts.planner(type_name).plan(q).explain
    assert te.get("index") == je.get("index"), q
    assert te.get("candidates") == je.get("candidates"), q
    return tc


# -- the reference's attribute-index suite -----------------------------------


SPEC = "name:String:index=true,val:Int:index=true,dtg:Date,*geom:Point"
_BASE = np.datetime64("2022-06-01T00:00:00", "ms").astype(np.int64)


def _ref_data():
    """The reference suite's fixture (tests/test_attribute_index.py:12)."""
    rng = np.random.default_rng(3)
    n = 8000
    return {
        "name": rng.choice(["ann", "bob", "cat", "dee", "eli"], n).astype(object),
        "val": rng.integers(0, 500, n).astype(np.int32),
        "dtg": _BASE + rng.integers(0, 21 * 86400000, n),
        "geom": (rng.uniform(-60, 60, n), rng.uniform(-40, 40, n)),
    }


@pytest.fixture(scope="module")
def world():
    data = _ref_data()
    js, ts = _pair(SPEC, data)
    return js, ts, data


WEEK = "dtg DURING 2022-06-05T00:00:00Z/2022-06-12T00:00:00Z"
POLY = "POLYGON((-10 20, 40 20, 40 60, -10 60, 15 40, -10 20))"
REF_QUERIES = [
    "name = 'bob'", "name = 'zzz'", "name >= 'bob' AND name < 'dee'",
    "val > 100 AND val <= 200", "name IN ('ann', 'cat')",
    f"name = 'ann' AND BBOX(geom, -20, -10, 30, 25) AND {WEEK}",
    "val = 42", "name = 'eli' AND BBOX(geom, -180, -90, 180, 90)",
    "val >= 0 AND BBOX(geom, 1, 1, 2, 2) AND "
    "dtg DURING 2022-06-05T00:00:00Z/2022-06-07T00:00:00Z",
    "name <= 'b'", "name > 'b'", "name < 'cat!'", "name >= 'az'",
    "val > 10000", "name IN ('cat', 'ann')", "name IN ('eli', 'ann', 'dee')",
    f"val BETWEEN 40 AND 42 AND INTERSECTS(geom, {POLY})",
    f"name = 'cat' AND {WEEK} AND val < 250",
    "val < 3 OR name = 'bob'",
    "(val = 7 AND BBOX(geom, -60, -40, 0, 0)) OR "
    "(name = 'dee' AND BBOX(geom, 10, 10, 60, 40))",
    "BBOX(geom, -5, -5, 5, 5)", "INCLUDE",
]


def test_indexed_attributes_discovery(world):
    js, ts, _ = world
    assert indexed_attributes(ts.get_schema("t")) == ["name", "val"] \
        == _ref("geomesa_tpu.index.attribute").indexed_attributes(
            js.get_schema("t"))
    names = [getattr(i, "attr", i.name) for i in ts.planner("t").indexes]
    assert names == [getattr(i, "attr", i.name)
                     for i in js.planner("t").indexes if i.name != "full"]


@pytest.mark.parametrize("q", REF_QUERIES)
def test_reference_queries_equal(world, q):
    js, ts, _ = world
    _same(js, ts, q)
    je, te = js.explain("t", q), ts.explain("t", q)
    # the reference's explain keys the port has (its build-progress history
    # and cache provenance wait for ROADMAP.md Queue 1 item 15)
    assert set(je) - {"build"} <= set(te), q
    for k in ("index", "strategy", "cost", "empty", "n_boxes", "n_windows",
              "scan", "candidates"):
        assert te.get(k) == je.get(k), (q, k)


@pytest.mark.parametrize("attr", ["name", "val"])
def test_sort_permutation_equals_reference(world, attr):
    js, ts, data = world
    jidx = next(i for i in js.planner("t").indexes
                if getattr(i, "attr", None) == attr)
    tidx = next(i for i in ts.planner("t").indexes
                if getattr(i, "attr", None) == attr)
    want = np.asarray(jidx.perm)
    assert np.array_equal(tidx.host_perm, want)
    # and the order of np.lexsort over (value, bin, off), ties by row
    tcore = _ref("geomesa_tpu.curves.binnedtime")
    bins, offs = tcore.time_to_binned_time(
        data["dtg"], jidx.period)
    vals = np.searchsorted(sorted(set(data["name"])), data["name"]) \
        if attr == "name" else data["val"]
    assert np.array_equal(want, np.lexsort((offs, bins, vals)))
    assert "sort_s" in tidx.build_stages and "gather_s" in tidx.build_stages
    for k, v in jidx.device.columns.items():
        assert np.array_equal(tidx.device.columns[k].numpy(), np.asarray(v)), k


@pytest.mark.parametrize("q,values", [("name IN ('ann','ann')", ["ann"]),
                                      ("val IN (42, 42)", [42]),
                                      ("name IN ('cat','ann','cat')",
                                       ["cat", "ann"])])
def test_repeated_in_values_counted_once(world, q, values):
    """The port counts each row once (numpy's answer); the reference keeps
    one slice a listed value and scans a repeated value's rows twice
    (``geomesa_tpu/index/attribute.py:130-138``)."""
    js, ts, data = world
    attr = "name" if "name" in q else "val"
    mask = np.isin(data[attr], values)
    want = int(mask.sum())
    assert ts.count("t", q) == want
    assert np.array_equal(ts.query("t", q).indices, np.flatnonzero(mask))
    dup = int(sum(np.sum(data[attr] == v) * (q.count(repr(v) if
                                                      isinstance(v, str)
                                                      else str(v)) - 1)
                  for v in values))
    assert dup > 0 and js.count("t", q) == want + dup
    assert ts.explain("t", q)["candidates"] == want


def test_sliced_staged_modes_equal_reference(world):
    """The staged ``count_at``/``select_at`` over a plan's runs against the
    reference's over the same positions (padded to a power of two)."""
    js, ts, _ = world
    for q in ("name = 'bob' AND BBOX(geom, -30, -20, 40, 30)",
              "name IN ('ann', 'dee') AND val < 50",
              "val > 100 AND val < 300 AND name <> 'cat'",
              "name >= 'bob' AND name < 'dee'"):
        jp = js.planner("t").plan(q)
        tp = ts.planner("t").plan(q)
        assert tp.candidate_slices is not None
        assert sorted(jp.candidate_slices) == tp.candidate_slices
        args = (tp.primary_kind, tp.boxes_loose, tp.windows,
                tp.residual_device)
        jargs = (jp.primary_kind, jp.boxes_loose, jp.windows,
                 jp.residual_device)
        pos = jp.candidate_positions()
        want = jp.index.kernels.count_at(*jargs, pos)
        assert tp.index.kernels.count_at(*args, tp.candidate_slices) == want
        jsel, jcnt = jp.index.kernels.select_at(*jargs, pos)
        tsel, tcnt = tp.index.kernels.select_at(*args, tp.candidate_slices,
                                                1024)
        assert tcnt == jcnt == want
        assert np.array_equal(tsel, np.sort(jsel))


@pytest.mark.parametrize("runs,n,bsz", [
    ([(0, 1)], 1000, 256), ([(3, 4), (5, 8), (250, 260)], 1000, 256),
    ([(0, 1000)], 1000, 256), ([(999, 1000)], 1000, 256),
    ([(10, 10), (20, 21)], 100, 64), ([], 100, 64),
    ([(255, 257), (511, 513), (700, 999)], 1001, 256)])
def test_run_pieces_cover_the_runs(runs, n, bsz):
    ids, bounds = tscan.run_pieces(runs, n, bsz)
    rows = np.concatenate([np.arange(lo, hi) for lo, hi in bounds]) \
        if len(bounds) else np.empty(0, np.int64)
    want = np.concatenate([np.arange(lo, hi) for lo, hi in runs]) \
        if runs else np.empty(0, np.int64)
    assert np.array_equal(rows, want)
    assert np.all(bounds[:, 0] // bsz == ids) if len(ids) else True
    assert np.all((bounds[:, 1] - 1) // bsz == ids) if len(ids) else True


def test_sliced_count_is_one_runs_scan_without_host_sync(world,
                                                          monkeypatch):
    """A sliced count is one call of the ``fused_scan`` wrapper in its RUNS
    form (on the CPU its plain version) and nothing that would wait on the
    device (``scan.host_syncs``)."""
    js, ts, _ = world
    q = "name = 'cat' AND BBOX(geom, -30, -20, 40, 30)"
    plan = ts.planner("t").plan(q)
    disp = plan.index.kernels.prepare_count_at(
        plan.primary_kind, plan.boxes_loose, plan.windows,
        plan.residual_device, plan.candidate_slices)
    calls = []
    plain = tscan.fused_scan

    def spy(*a, **kw):
        calls.append(kw.get("runs") is not None)
        return plain(*a, **kw)

    monkeypatch.setattr(tscan, "fused_scan", spy)
    with tscan.host_syncs() as h:
        out = disp()
    assert h.count == 0 and calls == [True]
    assert int(out) == js.count("t", q)


def test_sliced_residual_past_the_program_raises_naming_roadmap(monkeypatch):
    """A sliced plan on a point layer whose residual the RUNS form cannot
    take (17 columns, past ``fused_scan.MAX_SLOTS``) — refused until the
    RUNS form took such residuals — now keeps its primary on the RUNS
    launch and ANDs the residual in as torch ops over the pieces' rows:
    its count and rows equal the reference's and numpy's, its staged
    ``count_at``/``select_at`` the reference's over the same positions, and
    the RUNS form launched. The same residual on the spatial index keeps
    the block route's answer."""
    cs = [f"c{i}" for i in range(kscan.MAX_SLOTS + 1)]
    spec = "a:Int:index=true," + ",".join(f"{c}:Int" for c in cs) \
        + ",dtg:Date,*geom:Point"
    rng = np.random.default_rng(5)
    n = 3000
    cols = {"a": rng.integers(0, 20, n).astype(np.int32),
            "dtg": _BASE + rng.integers(0, 21 * 86400000, n),
            "geom": (rng.uniform(-60, 60, n), rng.uniform(-40, 40, n))}
    for c in cs:
        cols[c] = rng.integers(0, 10, n).astype(np.int32)
    js, ts = _pair(spec, cols)
    calls = []
    plain = tscan.fused_scan

    def spy(*a, **kw):
        calls.append(kw.get("runs") is not None)
        return plain(*a, **kw)

    monkeypatch.setattr(tscan, "fused_scan", spy)
    resid = " AND ".join(f"{c} > 0" for c in cs)
    want_mask = (cols["a"] == 3) & np.all([cols[c] > 0 for c in cs], axis=0)
    for q, m in ((f"a = 3 AND {resid}", want_mask),
                 (f"a = 3 AND BBOX(geom, -20, -40, 60, 10) AND {resid}",
                  want_mask & (cols["geom"][0] >= -20)
                  & (cols["geom"][1] <= 10))):
        plan = ts.planner("t").plan(q)
        assert plan.candidate_slices is not None
        args = (plan.primary_kind, plan.boxes_loose, plan.windows,
                plan.residual_device)
        assert tscan.staged_query(plan.index.kernels.cols, [args]) is None
        calls.clear()
        assert ts.count("t", q) == js.count("t", q) == int(m.sum()) > 0
        assert np.array_equal(ts.query("t", q).indices,
                              js.query("t", q).indices)
        assert np.array_equal(ts.query("t", q).indices, np.flatnonzero(m))
        jp = js.planner("t").plan(q)
        pos = jp.candidate_positions()
        jargs = (jp.primary_kind, jp.boxes_loose, jp.windows,
                 jp.residual_device)
        want = jp.index.kernels.count_at(*jargs, pos)
        assert plan.index.kernels.count_at(*args,
                                           plan.candidate_slices) == want
        jsel, jcnt = jp.index.kernels.select_at(*jargs, pos)
        tsel, tcnt = plan.index.kernels.select_at(
            *args, plan.candidate_slices, 64)
        assert tcnt == jcnt == want and np.array_equal(tsel, np.sort(jsel))
        # every scan of the runs went through the RUNS form
        assert calls and all(calls)
    q2 = f"BBOX(geom, -60, -40, 60, 40) AND {resid}"
    assert ts.count("t", q2) == js.count("t", q2)


def test_select_at_compacts_once_up_to_its_candidates(monkeypatch):
    """``select_at`` starts at its candidates' count (at most
    ``SELECT_AT_MAX``), so a slice of 70,000 matching rows compacts in one
    pass, not a 65,536-row pass and a retry."""
    n = 70_000
    rng = np.random.default_rng(9)
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    ts.create_schema("t", SPEC)
    ts.load("t", TTable.build(ts.get_schema("t"), {
        "name": np.array(["ann"] * n, dtype=object),
        "val": rng.integers(0, 500, n).astype(np.int32),
        "dtg": _BASE + rng.integers(0, 21 * 86400000, n),
        "geom": (rng.uniform(-60, 60, n), rng.uniform(-40, 40, n))}))
    plan = ts.planner("t").plan("name = 'ann'")
    k = plan.index.kernels
    calls = []
    prep = k.prepare_select_at

    def spy(*a, **kw):
        calls.append(a[-1])
        return prep(*a, **kw)

    monkeypatch.setattr(k, "prepare_select_at", spy)
    rows, cnt = k.select_at(plan.primary_kind, plan.boxes_loose,
                            plan.windows, plan.residual_device,
                            plan.candidate_slices)
    assert cnt == n and calls == [n]
    assert np.array_equal(rows, np.arange(n))


def test_value_keys_sort_as_numpy():
    rng = np.random.default_rng(5)
    f = rng.normal(0, 1e3, 4000).astype(np.float32)
    f[:40] = np.nan
    f[40:80] = -0.0
    f[80:120] = 0.0
    f[120:130] = np.inf
    f[130:140] = -np.inf
    f[140:150] = np.float32(1e-42)
    for v in (f, f.astype(np.float64), rng.integers(-2**40, 2**40, 4000),
              rng.integers(-5, 5, 4000).astype(np.int32),
              rng.random(4000) < 0.5):
        k = value_keys(v)
        assert k.dtype.kind in "iu"
        assert np.array_equal(np.argsort(k, kind="stable"),
                              np.argsort(v, kind="stable"))
        back = keys_to_values(k, v.dtype)
        assert np.array_equal(back, v, equal_nan=True) or v.dtype.kind == "f"
    back = keys_to_values(value_keys(f), f.dtype)
    assert np.array_equal(back[~np.isnan(f)], np.where(f == 0, 0.0, f)[
        ~np.isnan(f)]) and np.isnan(back[np.isnan(f)]).all()
    assert value_keys(np.array(["a"], dtype=object)) is None


def test_search_equals_numpy_without_widening():
    """``attribute.search`` answers ``np.searchsorted`` exactly for Python,
    numpy and out-of-range values on every column dtype, with the value
    converted to the column's dtype (no whole-array conversion)."""
    from geomesa_tpu_torch.index.attribute import _key_of, search
    rng = np.random.default_rng(9)
    f = np.sort(np.concatenate([rng.normal(0, 100, 3000),
                                [0.1, -0.0, 0.0, 1e-42, 3e38, np.inf,
                                 -np.inf, np.nan]]))
    cols = [np.sort(rng.integers(-1000, 1000, 3000)).astype(np.int32),
            np.sort(rng.integers(-2**40, 2**40, 3000)),
            f.astype(np.float32), f]
    values = [0, 7, -1000, 999, 2**31, -2**31 - 1, 2**40, 2**60, 0.1, 2.5,
              -7.5, 1e-42, 3e38, 1e300, -1e300, np.inf, -np.inf, np.nan,
              np.float32(0.1), np.float64(0.1), np.int64(5), np.int32(-3),
              float(np.float32(0.1))]
    for sv in cols:
        for v in values:
            for side in ("left", "right"):
                assert search(sv, v, side) == int(np.searchsorted(
                    sv, v, side=side)), (sv.dtype, v, side)
                k = _key_of(sv.dtype, v, side)
                assert k is None or np.asarray(k).dtype == sv.dtype


# -- random probes over typed attributes --------------------------------------


TSPEC = ("dtg:Date,s:String:index=true,i:Int:index=true,l:Long:index=true,"
         "f:Float:index=true,d:Date:index=true,*geom:Point;"
         "geomesa.z3.interval=week")
_T0 = int(np.datetime64("2021-03-01T00:00:00", "ms").astype(np.int64))
_DAY = 86_400_000
_WORDS = ["ak", "bd", "ce", "cf", "dz", "ea", "fb", "gc", "m", "ma", "zz",
          "q"]


def _typed(n, seed, base_day=0):
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 10, n).astype(np.float32)
    f[rng.random(n) < 0.05] = np.nan
    f[rng.random(n) < 0.03] = -0.0
    f[rng.random(n) < 0.03] = 0.0
    return {"dtg": _T0 + base_day * _DAY + rng.integers(0, 20 * _DAY, n),
            "s": rng.choice(_WORDS, n).astype(object),
            "i": rng.integers(-50, 50, n).astype(np.int32),
            "l": rng.integers(-2**45, 2**45, n) // (2**40),
            "f": f,
            "d": _T0 + rng.integers(0, 10, n) * _DAY,
            "geom": (rng.uniform(-50, 50, n), rng.uniform(-40, 40, n))}


def _labels(n, seed):
    return np.random.default_rng(seed).choice(
        ["", "admin", "secret&admin", "ops"], n)


def _probes(seed: int, k: int):
    """``k`` seed-drawn filters: a predicate on an indexed attribute
    (equality, range, IN) ANDed with nothing, a box, a window, a residual
    or a polygon."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        a = rng.choice(["s", "i", "l", "f", "d"])
        form = rng.choice(["eq", "range", "in"])
        # distinct values (a repeated IN value is a known difference,
        # test_repeated_in_values_counted_once)
        if a == "s":
            v = [f"'{w}'" for w in rng.choice(_WORDS + ["b", "cz", "n"], 3,
                                                replace=False)]
        elif a == "i":
            v = [str(int(x)) for x in rng.choice(np.arange(-55, 55), 3,
                                                 replace=False)]
        elif a == "l":
            v = [str(int(x)) for x in rng.choice(np.arange(-40, 40), 3,
                                                 replace=False)]
        elif a == "f":
            v = [f"{x:.2f}" for x in rng.normal(0, 10, 3)]
            if form == "eq":
                v[0] = "0.0"
        else:
            v = [str(_T0 + int(x) * _DAY) for x in rng.choice(
                np.arange(-1, 11), 3, replace=False)]
        if form == "eq":
            p = f"{a} = {v[0]}"
        elif form == "range":
            lo, hi = sorted(v[:2], key=lambda t: float(t.strip("'"))
                            if a != "s" else t)
            p = f"{a} >= {lo} AND {a} < {hi}" if rng.random() < 0.5 \
                else f"{a} > {lo}"
        else:
            p = f"{a} IN ({', '.join(v)})"
        extra = rng.choice(["", "box", "window", "resid", "poly"])
        if extra == "box":
            p += " AND BBOX(geom, -20, -15, 30, 25)"
        elif extra == "window":
            p += (" AND dtg DURING 2021-03-04T00:00:00Z/"
                  "2021-03-12T00:00:00Z")
        elif extra == "resid":
            p += " AND i > -10 AND s <> 'q'"
        elif extra == "poly":
            p += " AND INTERSECTS(geom, POLYGON((-10 -10, 30 -5, 20 30, " \
                 "5 5, -10 25, -10 -10)))"
        out.append(p)
    return out


@pytest.fixture(scope="module")
def typed():
    data = _typed(6000, 21)
    js, ts = _pair(TSPEC, data, vis=_labels(6000, 22),
                   fids=[f"t{j}" for j in range(6000)])
    return js, ts, data


def _nan_moved(q: str) -> bool:
    """A probe whose ``f`` slice runs to the end in the reference (its NaN
    rows counted)."""
    return "f >" in q and "f < " not in q


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("auths", [None, ["admin"]], ids=["all", "admin"])
def test_random_probes_equal(typed, seed, auths):
    js, ts, _ = typed
    for q in _probes(seed, 12):
        if _nan_moved(q):
            continue
        _same(js, ts, q, auths=auths, rows=seed % 2 == 0)


@pytest.mark.parametrize("q", ["f > 1.5", "f >= -0.0",
                               "f > 12.5 AND s <> 'q'"])
def test_float_ranges_leave_nan_out(typed, q):
    """NaN satisfies no comparison: the port's slice stops where NaN rows
    sort; the reference's ``>``/``>=`` slice runs to the end and counts
    them."""
    js, ts, data = typed
    from geomesa_tpu_torch.filter.evaluate import evaluate
    want = int(evaluate(tparse(q), ts.planner("t").table).sum())
    assert ts.count("t", q) == want
    n_nan = js.count("t", q) - want
    assert n_nan > 0 and ts.explain("t", q)["index"] == "attr:f"


def test_date_literal_on_indexed_date_leaves_the_index(typed):
    """A date string against an indexed Date attribute is no slice: the
    plan takes the spatial index, as without the attribute index."""
    _, ts, _ = typed
    assert ts.planner("t").plan(
        "d > '2021-03-05T00:00:00Z'").explain["index"] == "z3"


@pytest.mark.parametrize("step", ["append", "flush", "remove", "update",
                                  "age_off"])
def test_probes_after_mutations(step):
    js, ts = _pair(TSPEC + ",geomesa.feature.expiry=dtg(3650 days)",
                   _typed(3000, 31), vis=_labels(3000, 32))
    JTable = _ref("geomesa_tpu.features.table").FeatureTable
    more = _typed(400, 33, base_day=5)
    vis = _labels(400, 34)
    for s, tbl in ((js, JTable), (ts, TTable)):
        s.load("t", tbl.build(s.get_schema("t"), more, visibilities=vis))
        if step == "flush":
            s.flush("t")
        elif step == "remove":
            s.remove_features("t", "i < -30 OR s = 'ma'")
        elif step == "update":
            s.update_features("t", "i > 40", {"s": "zz", "i": 7})
        elif step == "age_off":
            s.age_off("t", now_ms=_T0 + 3650 * _DAY + 12 * _DAY)
    for q in _probes(40, 10) + ["i = 7", "s = 'zz'", "s IN ('ak', 'zz')"]:
        if _nan_moved(q):
            continue
        assert ts.count("t", q) == js.count("t", q), (step, q)
        assert ts.count("t", q, auths=["ops"]) == \
            js.count("t", q, auths=["ops"]), (step, q)
        assert np.array_equal(ts.query("t", q).indices,
                              np.sort(js.query("t", q).indices)), (step, q)
        je, te = js.explain("t", q), ts.explain("t", q)
        assert te["index"] == je["index"], (step, q)
        assert te.get("delta_rows") == je.get("delta_rows"), (step, q)


def test_aggregations_over_a_sliced_plan(world):
    """The stats, bin and sample hints and a density over a sliced plan take
    the host-rows route, as the reference's do for a plan that is not
    device-exact."""
    js, ts, _ = world
    q = "name = 'bob' AND BBOX(geom, -30, -20, 40, 30)"
    assert ts.planner("t").scan_mask(q)[1] is None
    for spec in ("Count()", 'Histogram("val",10,0,500)', 'Enumeration("name")'):
        assert ts.query("t", q, hints={"stats": spec}).to_dict() == \
            js.query("t", q, hints={"stats": spec}).to_dict(), spec
    d = {"bbox": (-60, -40, 60, 40), "width": 16, "height": 8}
    assert np.array_equal(ts.query("t", q, hints={"density": d}).weights,
                          np.asarray(js.query("t", q, hints={
                              "density": d}).weights))
    assert np.array_equal(ts.query("t", q, hints={"sample": 5}).indices,
                          js.query("t", q, hints={"sample": 5}).indices)


def test_scheduler_counts_over_sliced_plans(world):
    """The scheduler's batched route takes device-exact box plans only: a
    sliced plan leaves it, as the reference's does, and every count of a
    mixed batch equals the reference's direct count."""
    js, ts, _ = world
    qs = ["name = 'bob'", "val = 42 AND BBOX(geom, -30, -20, 40, 30)",
          "BBOX(geom, -20, -10, 30, 25)", "BBOX(geom, 0, 0, 20, 20)",
          "name IN ('ann', 'cat') AND val < 100"]
    try:
        got = ts.count_many("t", qs)
    finally:
        ts.close()
    assert got == [js.count("t", q) for q in qs]


# -- the index pick ------------------------------------------------------------


@pytest.mark.parametrize("spec,want", [
    (SPEC + ";geomesa.indices=z3,attr:val", ["z3", "attr:name", "attr:val"]),
    ("name:String,val:Int,dtg:Date,*geom:Point;geomesa.indices=attr:val",
     ["attr:val", "full"]),
    ("name:String:index=true,val:Int,dtg:Date", ["attr:name", "full"]),
    ("name:String,val:Int:index=full,dtg:Date,*geom:Point;"
     "geomesa.indices=z2", ["z2", "attr:val"]),
])
def test_index_set_follows_configured_indices(spec, want):
    data = _ref_data()
    if "geom" not in spec:
        data = {k: v for k, v in data.items() if k != "geom"}
    js, ts = _pair(spec, data)
    names = [f"attr:{i.attr}" if i.name == "attr" else i.name
             for i in ts.planner("t").indexes]
    assert names == want
    for q in ("val = 42", "name = 'bob'", "val > 100 AND name <> 'ann'",
              "INCLUDE", "name IN ('ann', 'cat') AND val < 100"):
        _same(js, ts, q)


@pytest.mark.parametrize("spec", [SPEC + ";geomesa.indices=s2",
                                  SPEC + ";geomesa.indices=s3,z3"])
def test_s2_and_s3_raise_naming_roadmap(spec):
    """``geomesa.indices`` naming ``s2`` or ``s3`` (and ``z3``), once
    refused naming item 9, builds the S2/S3 index first — the reference's
    ``INDEX_CLASSES`` order — beside the attribute indexes and the
    full-scan index, and answers as the reference does: counts, rows and
    the chosen index."""
    js, ts = _pair(spec, _ref_data())
    names = [f"attr:{i.attr}" if i.name == "attr" else i.name
             for i in ts.planner("t").indexes]
    kind = "s2" if "s2" in spec else "s3"
    assert names == [kind, "attr:name", "attr:val", "full"]
    for q in ("val = 42", "name = 'bob'", "INCLUDE",
              "BBOX(geom, -20, -10, 30, 25) AND val > 100",
              f"BBOX(geom, -20, -10, 30, 25) AND {WEEK}",
              "name IN ('ann', 'cat') AND BBOX(geom, 0, 0, 20, 20)"):
        _same(js, ts, q)


def test_z3_key_ranges_equal_reference(world):
    js, ts, _ = world
    q = f"BBOX(geom, -20, -10, 30, 25) AND {WEEK}"
    jp, tp = js.planner("t").plan(q), ts.planner("t").plan(q)
    want = jp.index.key_ranges(jp, max_ranges=64)
    got = tp.index.key_ranges(tp, max_ranges=64)
    assert [b for b, _ in got] == [b for b, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert [(r.lower, r.upper, r.contained) for r in g] == \
            [(r.lower, r.upper, r.contained) for r in w]


# -- explain -------------------------------------------------------------------


def test_explain_analyze_and_delta():
    data = _ref_data()
    js, ts = _pair(SPEC, data)
    JTable = _ref("geomesa_tpu.features.table").FeatureTable
    more = {k: (v[0][:50], v[1][:50]) if k == "geom" else v[:50]
            for k, v in _ref_data().items()}
    for s, tbl in ((js, JTable), (ts, TTable)):
        s.load("t", tbl.build(s.get_schema("t"), more))
    for q in ("name = 'bob'", f"BBOX(geom, -20, -10, 30, 25) AND {WEEK}",
              "val < 3 OR name = 'bob'"):
        je = js.explain("t", q, analyze=True)
        te = ts.explain("t", q, analyze=True)
        assert te["delta_rows"] == je["delta_rows"] == 50
        for k in ("executed", "rows_matched", "rows_scanned",
                  "delta_rows_matched"):
            assert te["analyze"][k] == je["analyze"][k], (q, k)
        assert te["analyze"]["rows_matched"] == ts.count("t", q)
        assert te["analyze"]["duration_ms"] >= 0
        assert te["trace"]["name"] == "explain"


# -- interceptors and guards ---------------------------------------------------


GSPEC = "name:String,v:Int,dtg:Date,*geom:Point"
_GBASE = np.datetime64("2024-01-01", "ms").astype(np.int64)


def _guard_store(spec=GSPEC, n=2000, seed=0):
    rng = np.random.default_rng(seed)
    cols = {"name": rng.choice(["a", "b"], n).astype(object),
            "v": rng.integers(0, 100, n).astype(np.int32),
            "dtg": _GBASE + rng.integers(0, 7 * 86400000, n),
            "geom": (rng.uniform(-60, 60, n), rng.uniform(-60, 60, n))}
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    ts.create_schema("t", spec)
    ts.load("t", TTable.build(ts.get_schema("t"), cols,
                              fids=[f"f{i}" for i in range(n)]))
    return ts


def test_full_table_scan_guard():
    ds = _guard_store()
    ds.add_interceptor("t", FullTableScanGuard())
    assert ds.count("t") == 2000
    assert ds.count("t", "BBOX(geom, 0, 0, 10, 10)") > 0
    with pytest.raises(QueryGuardError, match="full-table"):
        ds.count("t", "name = 'a'")
    # an indexed attribute's slice is no full-table scan
    ds2 = _guard_store(GSPEC.replace("name:String", "name:String:index=true"))
    ds2.add_interceptor("t", FullTableScanGuard())
    assert ds2.count("t", "name = 'a'") > 0


def test_guard_added_after_cached_plans_applies():
    """A guard attached after the scheduler cached a filter's plan vetoes
    that filter: ``add_interceptor`` advances the type's generation, the
    plan cache's key. The reference keeps serving its cached plan (ROADMAP
    Queue 3, "Found in the reference, not the port")."""
    ds = _guard_store()
    JStore = _ref("geomesa_tpu.datastore").TpuDataStore
    JTable = _ref("geomesa_tpu.features.table").FeatureTable
    JGuard = _ref("geomesa_tpu.index.guards").FullTableScanGuard
    rng = np.random.default_rng(0)
    js = JStore()
    js.create_schema("t", GSPEC)
    cols = {"name": rng.choice(["a", "b"], 2000).astype(object),
            "v": rng.integers(0, 100, 2000).astype(np.int32),
            "dtg": _GBASE + rng.integers(0, 7 * 86400000, 2000),
            "geom": (rng.uniform(-60, 60, 2000), rng.uniform(-60, 60, 2000))}
    js.load("t", JTable.build(js.get_schema("t"), cols))
    q = ["name = 'a'"]
    want = js.count_many("t", q)
    assert ds.count_many("t", q) == want
    g = ds.generation("t")
    ds.add_interceptor("t", FullTableScanGuard())
    assert ds.generation("t") == g + 1
    with pytest.raises(QueryGuardError, match="full-table"):
        ds.count_many("t", q)
    js.add_interceptor("t", JGuard())
    assert js.count_many("t", q) == want     # the reference's cached plan


def test_temporal_guard():
    ds = _guard_store()
    ds.add_interceptor("t", TemporalQueryGuard(max_duration_ms=2 * 86400000))
    ok = ("BBOX(geom, 0, 0, 10, 10) AND "
          "dtg DURING 2024-01-01T00:00:00Z/2024-01-02T00:00:00Z")
    assert ds.count("t", ok) >= 0
    with pytest.raises(QueryGuardError, match="temporal"):
        ds.count("t", "BBOX(geom, 0, 0, 10, 10)")
    with pytest.raises(QueryGuardError, match="limit"):
        ds.count("t", "BBOX(geom, 0, 0, 10, 10) AND "
                      "dtg DURING 2024-01-01T00:00:00Z/2024-01-06T00:00:00Z")


def test_graduated_guard():
    ds = _guard_store()
    ds.add_interceptor("t", GraduatedQueryGuard([
        SizeAndDuration(100.0, 7 * 86400000),
        SizeAndDuration(float("inf"), 86400000)]))
    assert ds.count("t", "BBOX(geom, 0, 0, 5, 5) AND "
                         "dtg DURING 2024-01-01T00:00:00Z/"
                         "2024-01-06T00:00:00Z") >= 0
    with pytest.raises(QueryGuardError):
        ds.count("t", "BBOX(geom, -50, -50, 50, 50) AND "
                      "dtg DURING 2024-01-01T00:00:00Z/2024-01-06T00:00:00Z")
    assert ds.count("t", "BBOX(geom, -50, -50, 50, 50) AND "
                         "dtg DURING 2024-01-01T00:00:00Z/"
                         "2024-01-01T12:00:00Z") >= 0


def test_guard_only_on_this_type_and_rewrite():
    ds = _guard_store()
    ds.create_schema("open", "v:Int,*geom:Point")
    ds.load("open", TTable.build(ds.get_schema("open"),
                                 {"v": [1], "geom": ([0.0], [0.0])}))
    ds.add_interceptor("t", FullTableScanGuard())
    assert ds.count("open", "v = 1") == 1

    class OnlyA:
        def rewrite(self, f, sft):
            from geomesa_tpu_torch.filter import ir
            return ir.and_filters([f, tparse("name = 'a'")])

        def guard(self, plan, f, sft):
            return None

    ds.add_interceptor("t", OnlyA())
    n_a = ds.count("t", "INCLUDE AND BBOX(geom, -60, -60, 60, 60)")
    assert n_a == int(np.sum(
        np.random.default_rng(0).choice(["a", "b"], 2000) == "a"))


# -- the card --------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the fused_scan RUNS form)")
    return torch.device("cuda")


def _planes(n: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-180, 180, n)
    y = rng.uniform(-90, 90, n)
    xi, xl = fp62(x, -180.0, 180.0)
    yi, yl = fp62(y, -90.0, 90.0)
    cols = {"xi": xi, "xl": xl, "yi": yi, "yl": yl,
            "bin": np.sort(rng.integers(2600, 2606, n)).astype(np.int32),
            "off": rng.integers(0, 604800, n).astype(np.int32),
            "age": rng.integers(0, 100, n).astype(np.int32),
            "score": rng.uniform(0, 1, n).astype(np.float32),
            "__vis__": rng.integers(0, 6, n).astype(np.int32)}
    return {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}


def _runs_query(kind: str, windows: bool, resid, vis):
    sft = TSFT.from_spec("g", "age:Int,score:Float,dtg:Date,*geom:Point")
    boxes = None
    if kind == "boxes":
        boxes = tscan.pad_boxes(t_fp62([(-120.0, -60.0, 100.0, 70.0),
                                        (130.0, -10.0, 180.0, 90.0)]))
    w = np.array([[2601, 1000, 2603, 500], [2605, 7, 2605, 90000]],
                 dtype=np.int32) if windows else None
    prog = tscan.compile_residual(tparse(resid), sft, {}).program \
        if resid else None
    gate = None if boxes is None else np.zeros((len(boxes), 4), np.float32)
    return tscan.FusedQuery([(boxes, gate, w, prog)],
                            None if vis is None else np.asarray(vis))


def _runs_case(case: str, n: int):
    rng = np.random.default_rng(len(case) + n)
    if case == "one":
        return [(3, n - 5)]
    if case == "short":     # runs of 1-3 rows, several a block
        starts = np.sort(rng.choice(n - 4, 300, replace=False))
        ends = starts + rng.integers(1, 4, 300)
        out, last = [], -1
        for s, e in zip(starts, ends):
            if s > last:
                out.append((int(s), int(e)))
                last = e
        return out
    if case == "tail":      # a run ending at the table's last row
        return [(1, 2), (n - 1000 - 3, n)]
    if case == "empty":
        return [(5, 5), (9, 9)]
    # unaligned starts and ends, some runs across blocks
    cuts = np.sort(rng.choice(n, 64, replace=False))
    return [(int(a), int(b)) for a, b in zip(cuts[::2], cuts[1::2])]


RUNS_GPU = [(n, case, kind, windows, resid, vis)
            for n in (100_003, 4_099)
            for case in ("one", "short", "tail", "empty", "unaligned")
            for kind, windows, resid, vis in (
                ("boxes", True, "age > 10", None),
                ("boxes", False, None, None),
                ("none", True, "score < 0.5", None),
                ("none", False, "age < 70", None),
                ("boxes", True, "age > 10", [0, 2, 5]),
                ("none", False, None, [1, 3]))]


@pytest.mark.gpu
@pytest.mark.parametrize("n,case,kind,windows,resid,vis", RUNS_GPU)
def test_cuda_runs_scan_equals_plain(n, case, kind, windows, resid, vis):
    dev = _cuda()
    cols = _planes(n, n, dev)
    k = tscan.ScanKernels(cols)
    q = _runs_query(kind, windows, resid, vis)
    qbuf = torch.from_numpy(q.packed).to(dev)
    runs = _runs_case(case, n)
    ids, bounds, nb, starts, bsz = k._runs_space(runs)
    for mode in ("count", "mask"):
        b0 = (kscan.fused_scan.launches, kscan.fused_scan.runs_launches)
        got = kscan.fused_scan(cols, qbuf, q, ids, nb, bsz, mode,
                               runs=bounds)
        want = tscan.fused_scan(cols, qbuf, q, ids, nb, bsz, mode,
                                runs=bounds)
        torch.cuda.synchronize()
        assert (kscan.fused_scan.launches, kscan.fused_scan.runs_launches) \
            == (b0[0] + 1, b0[1] + 1)
        if mode == "count":
            assert torch.equal(got, want)
            continue
        live = int(nb[0]) * bsz
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0][:live], want[0][:live])
        st = torch.from_numpy(starts).to(dev)
        for cap in (0, 7, 1 << 16):
            kw = dict(starts=st, bsz=bsz, n_blocks=nb)
            c, r = kcompact.ordered_compact(got[0], cap, n, **kw)
            cw, rw = tscan.ordered_compact(want[0], cap, n, **kw)
            assert torch.equal(c, cw) and torch.equal(r, rw), cap
    if case == "empty":
        assert int(want[1]) == 0


@pytest.mark.gpu
def test_cuda_sliced_count_one_launch_no_sync_and_store_equal_cpu():
    dev = _cuda()
    data = _ref_data()
    stores = {}
    for d in ("cpu", "cuda"):
        s = DataStoreFinder.get_data_store(type="torch", device=d)
        s.create_schema("t", SPEC)
        s.load("t", TTable.build(s.get_schema("t"), data))
        stores[d] = s
    for q in REF_QUERIES + ["name IN ('ann','ann')"]:
        assert stores["cuda"].count("t", q) == stores["cpu"].count("t", q), q
        assert np.array_equal(stores["cuda"].query("t", q).indices,
                              stores["cpu"].query("t", q).indices), q
    p = stores["cuda"].planner("t")
    plan = p.plan("name = 'cat' AND BBOX(geom, -30, -20, 40, 30)")
    disp = plan.index.kernels.prepare_count_at(
        plan.primary_kind, plan.boxes_loose, plan.windows,
        plan.residual_device, plan.candidate_slices)
    disp()
    torch.cuda.synchronize(dev)
    b0 = (kscan.fused_scan.launches, kscan.fused_scan.runs_launches)
    with tscan.host_syncs("cuda") as h:
        out = disp()
    torch.cuda.synchronize(dev)
    assert h.count == 0
    assert (kscan.fused_scan.launches, kscan.fused_scan.runs_launches) == (
        b0[0] + 1, b0[1] + 1)
    assert int(out) == stores["cpu"].count(
        "t", "name = 'cat' AND BBOX(geom, -30, -20, 40, 30)")
