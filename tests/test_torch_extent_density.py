"""Density over extent layers in the port against the JAX package: a
``TorchDataStore`` (device="cpu") and a ``TpuDataStore`` fed the same
seeded tables of single-segment lines (XZ2), lines with a date (XZ3),
small polygons (XZ2) and mixed multi-part geometries (XZ3). The select
runs the staged scan (``fused_scan``'s ENV form on the card), then the
envelope centres snap on the host (``host_grid``), as the reference
renders them.

Grids compare byte for byte — unit weights and ``val`` weights (the host
sums in the reference's order, ``np.add.at``) — through the ``density``
hint and ``aggregates.density.density`` on the planner, for boxes,
windows, residuals, a polygon (host refine), an OR (``UnionScanPlan``),
INCLUDE, an empty plan, under auths, and over a pending delta.
"""

import numpy as np
import pytest

from geomesa_tpu import config as jconfig
from geomesa_tpu.aggregates.density import density as jdensity
from geomesa_tpu.datastore import TpuDataStore
from geomesa_tpu_torch import DataStoreFinder
from geomesa_tpu_torch import config as tconfig
from geomesa_tpu_torch.aggregates.density import prepare_density

from test_torch_extent import DURING, LAYERS, POLY, _spec, _tables

BBOX = (-60.0, 0.0, 60.0, 70.0)
KINDS = ["lines", "lines_dtg", "polys", "mixed"]
QUERIES = ["INCLUDE", "BBOX(geom, -12, 28, 14, 50)",
           "BBOX(geom, -12, 28, 14, 50) AND val > 50",
           f"INTERSECTS(geom, {POLY})",
           "BBOX(geom, -40, 10, -30, 20) OR BBOX(geom, 20, 50, 30, 60)",
           "val < 10", "BBOX(geom, 100, 80, 110, 85)"]


@pytest.fixture(scope="module", autouse=True)
def small_blocks():
    from geomesa_tpu.index import prune as jprune
    for k in ("BLOCK_SIZE", "PRUNE_MAX_FRACTION"):
        vars(jprune).pop(k, None)
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.set(256)
    yield
    for c in (jconfig, tconfig):
        c.PRUNE_BLOCK.unset()


@pytest.fixture(scope="module")
def stores():
    js = TpuDataStore()
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    for layer in KINDS:
        js.create_schema(layer, _spec(layer))
        ts.create_schema(layer, _spec(layer))
        n = min(LAYERS[layer][2], 4000)
        jt, tt = _tables(layer, n, 17, js, ts)
        js.load(layer, jt)
        ts.load(layer, tt)
    return js, ts


def _grid(store, layer, q, w, h, weight=None, auths=None):
    spec = {"bbox": BBOX, "width": w, "height": h}
    if weight:
        spec["weight"] = weight
    kw = {} if auths is None else {"auths": auths}
    return np.asarray(store.query(layer, q, hints={"density": spec},
                                  **kw).weights)


def _cases():
    for layer in KINDS:
        for q in QUERIES + ([f"{DURING} AND val > 20"]
                            if LAYERS[layer][1] else []):
            yield layer, q


@pytest.mark.parametrize("layer,q", list(_cases()))
@pytest.mark.parametrize("weight", [None, "val"])
def test_density_hint_grids_equal_reference(stores, layer, q, weight):
    js, ts = stores
    for w, h in ((32, 16), (7, 5)):
        got = _grid(ts, layer, q, w, h, weight)
        want = _grid(js, layer, q, w, h, weight)
        assert got.dtype == np.float32 and got.shape == (h, w)
        assert got.tobytes() == want.tobytes(), (w, h)
    if q == "INCLUDE" and weight is None:
        assert got.sum() > 0


@pytest.mark.parametrize("layer", KINDS)
def test_planner_density_equals_reference(stores, layer):
    """``density`` on the planner (its prepared callable twice), the grid's
    points decoded."""
    js, ts = stores
    q = "BBOX(geom, -12, 28, 14, 50)"
    prep = prepare_density(ts.planner(layer), q, BBOX, 24, 24)
    want = jdensity(js.planner(layer), q, BBOX, 24, 24)
    for _ in range(2):
        got = prep()
        assert got.weights.tobytes() == np.asarray(want.weights).tobytes()
    for a, b in zip(got.to_points(), want.to_points()):
        assert np.array_equal(a, np.asarray(b))


def test_density_over_a_pending_delta_and_under_auths():
    """Appends into the delta add their envelope centres to the grid, as
    the reference's; a labelled layer's grid under auths keeps only the
    visible rows."""
    js = TpuDataStore()
    ts = DataStoreFinder.get_data_store(type="torch", device="cpu")
    layer = "polys"
    for s in (js, ts):
        s.create_schema(layer, _spec(layer))
    for k, rows in enumerate((3000, 400)):
        jt, tt = _tables(layer, rows, 50 + k, js, ts)
        js.load(layer, jt)
        ts.load(layer, tt)
    assert ts.deltas[layer] is not None
    for q in ("INCLUDE", "BBOX(geom, -12, 28, 14, 50) AND val > 30"):
        assert _grid(ts, layer, q, 16, 16).tobytes() \
            == _grid(js, layer, q, 16, 16).tobytes()
    lab = "lines"
    vis = np.where(np.arange(2000) % 3 == 0, "admin", "user")
    for s in (js, ts):
        s.create_schema(lab, _spec(lab))
    jt, tt = _tables(lab, 2000, 61, js, ts)
    for s, tbl in ((js, jt), (ts, tt)):
        s.load(lab, type(tbl).build(s.get_schema(lab), {
            name: tbl.columns[name] for name in ("val", "name", "geom")},
            visibilities=vis))
    for auths in (["user"], ["admin", "user"], []):
        for q in ("INCLUDE", "BBOX(geom, -12, 28, 14, 50)"):
            got = _grid(ts, lab, q, 16, 16, auths=auths)
            assert got.tobytes() == _grid(js, lab, q, 16, 16,
                                          auths=auths).tobytes(), auths
