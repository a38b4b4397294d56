"""The port's density readback codecs (``geomesa_tpu_torch/aggregates/
grid_codec.py``) against the JAX package's: the packed words of every
encoding equal the reference's ``pack_jit`` output word for word, except the
header's f32 ``mass`` word — a sum over the grid whose order is each
framework's — which must decode to within ``MASS_RTOL`` of the reference's
(relative, as the decoder reads it). Then the round trips and the step-down
signals of ``tests/test_grid_codec.py``, through the port's pack and decode,
and the density path's grid under every encoding."""

import numpy as np
import pytest
import torch

from geomesa_tpu.aggregates import grid_codec as jcodec
from geomesa_tpu_torch import DataStoreFinder
from geomesa_tpu_torch.aggregates import grid_codec
from geomesa_tpu_torch.aggregates.density import prepare_density
from geomesa_tpu_torch.config import DENSITY_PACK
from geomesa_tpu_torch.features.table import FeatureTable

MASS = 2  # header word of the f32 mass


def _pack(fn, grid, count, *extra):
    return grid_codec.words(fn(torch.from_numpy(grid),
                               torch.tensor(count, dtype=torch.int32), *extra))


def _f32(word) -> float:
    return float(np.array([word], np.uint32).view(np.float32)[0])


def _grids():
    rng = np.random.default_rng(17)
    sparse = np.zeros((16, 32), np.float32)
    cells = rng.choice(16 * 32, 40, replace=False)
    sparse.reshape(-1)[cells] = rng.integers(1, 2000, 40).astype(np.float32)
    big = np.zeros((64, 64), np.float32)
    big.reshape(-1)[rng.choice(4096, 3000, replace=False)] = \
        rng.integers(1, 1 << 20, 3000).astype(np.float32)
    return {
        "sparse16x32": sparse,
        "odd7x9": rng.integers(0, 100, (7, 9)).astype(np.float32),
        "u8_17": rng.integers(0, 255, (16, 17)).astype(np.float32),
        "weighted": (rng.normal(0, 50, (13, 11)) * (rng.random((13, 11)) < 0.4)
                     ).astype(np.float32),
        "fractions_and_ties": np.float32([[0.5, 1.5, 2.5, -0.5], [255.5, 254.5,
                                          70000.0, 1e-8], [0, 0, 3, 0]]),
        "mass_past_2_24": big,
        "empty": np.zeros((4, 6), np.float32),
    }


@pytest.mark.parametrize("mode", ["sparse8", "sparse64", "sparse4096",
                                  "fp16", "u8"])
@pytest.mark.parametrize("name", sorted(_grids()))
def test_packed_words_equal_reference(name, mode):
    grid = _grids()[name]
    cap = int(mode[6:]) if mode.startswith("sparse") else None
    base = "sparse" if cap else mode
    want = np.asarray(jcodec.pack_jit(base, cap)(grid, np.int32(12345)))
    got = _pack(grid_codec.pack_fn(base, cap), grid, 12345)
    assert got.dtype == np.uint32 and got.shape == want.shape
    other = np.arange(len(want)) != MASS
    assert np.array_equal(got[other], want[other])
    gm, wm = _f32(got[MASS]), _f32(want[MASS])
    assert abs(gm - wm) <= grid_codec.MASS_RTOL * max(abs(wm), 1.0)
    if grid_codec.decode(want, base, cap, *grid.shape) is None:
        assert grid_codec.decode(got, base, cap, *grid.shape) is None
    else:
        g, c, _ = grid_codec.decode(got, base, cap, *grid.shape)
        w, _, _ = grid_codec.decode(want, base, cap, *grid.shape)
        assert c == 12345 and np.array_equal(g, w)


def test_header_words():
    grid = np.float32([[0, 3, 0], [2.5, 0, 7]])
    got = _pack(grid_codec.pack_fp16, grid, 9)
    assert list(got[:2]) == [3, 9]
    assert _f32(got[2]) == 12.5 and _f32(got[3]) == 7.0


def test_sparse_round_trip_exact():
    grid = _grids()["sparse16x32"]
    packed = _pack(grid_codec.pack_fn("sparse", 64), grid, 40)
    got, count, mass = grid_codec.decode(packed, "sparse", 64, 16, 32)
    np.testing.assert_array_equal(got, grid)  # integer cells ≤2048: exact
    assert count == 40
    assert mass == pytest.approx(float(grid.sum()), rel=1e-6)


def test_sparse_overflow_signals_refetch():
    grid = np.ones((8, 8), np.float32)  # 64 nonzero > cap 32
    packed = _pack(grid_codec.pack_fn("sparse", 32), grid, 64)
    assert grid_codec.decode(packed, "sparse", 32, 8, 8) is None


def test_fp16_round_trip_and_odd_cells():
    grid = _grids()["odd7x9"]
    got, count, _ = grid_codec.decode(_pack(grid_codec.pack_fp16, grid, 17),
                                      "fp16", None, 7, 9)
    np.testing.assert_array_equal(got, grid)
    assert count == 17


def test_fp16_saturation_signals_refetch():
    grid = np.zeros((4, 4), np.float32)
    grid[0, 0] = 1e9  # fp16 max is 65504 -> inf
    assert grid_codec.decode(_pack(grid_codec.pack_fp16, grid, 1),
                             "fp16", None, 4, 4) is None


def test_u8_round_trip_and_saturation():
    grid = _grids()["u8_17"]
    got, count, _ = grid_codec.decode(_pack(grid_codec.pack_u8, grid, 9),
                                      "u8", None, 16, 17)
    np.testing.assert_array_equal(got, grid)
    assert count == 9
    grid[3, 3] = 90000.0  # a cell past 255 saturates
    assert grid_codec.decode(_pack(grid_codec.pack_u8, grid, 9),
                             "u8", None, 16, 17) is None


def test_u8_small_hotspot_rejected_despite_mass_guard():
    grid = np.full((64, 64), 200.0, np.float32)   # mass ~819k
    grid[10, 10] = 500.0                          # clip error 245 << 2e-3*mass
    assert grid_codec.decode(_pack(grid_codec.pack_u8, grid, 0),
                             "u8", None, 64, 64) is None


@pytest.mark.parametrize("bound,h,w,mode,unit", [
    (100, 512, 512, "auto", False), (512 * 512, 512, 512, "auto", False),
    (512 * 512, 512, 512, "auto", True), (10, 64, 64, "none", False),
    (10 ** 9, 64, 64, "sparse", False), (10, 64, 64, "u8", False),
    (5000, 64, 64, "bogus", True), (1, 1, 1, "auto", True)])
def test_choose_ladder_equals_reference(bound, h, w, mode, unit):
    assert grid_codec.choose(bound, h, w, mode, unit) == \
        jcodec.choose(bound, h, w, mode, unit)
    for m, cap in (("sparse", 128), ("u8", None), ("fp16", None)):
        assert grid_codec.packed_bytes(m, cap, h, w) == \
            jcodec.packed_bytes(m, cap, h, w)


@pytest.fixture(scope="module")
def store():
    rng = np.random.default_rng(11)
    n = 20000
    base = np.datetime64("2022-01-01T00:00:00", "ms").astype(np.int64)
    ds = DataStoreFinder.get_data_store(type="torch", device="cpu")
    sft = ds.create_schema("pk", "w:Double,dtg:Date,*geom:Point")
    ds.load("pk", FeatureTable.build(sft, {
        "w": rng.uniform(0.5, 2.0, n),
        "dtg": base + rng.integers(0, 7 * 86400000, n),
        "geom": (rng.uniform(-90, 90, n), rng.uniform(-45, 45, n))}))
    return ds


def _render(store, mode, *args, **kw):
    DENSITY_PACK.set(mode)
    try:
        return prepare_density(store.planner("pk"), *args, **kw)().weights
    finally:
        DENSITY_PACK.unset()


@pytest.mark.parametrize("mode", ["none", "sparse", "fp16", "u8", "auto"])
def test_density_same_grid_under_every_encoding(store, mode):
    q, bbox = "BBOX(geom, -50, -20, 50, 30)", (-50, -20, 50, 30)
    got = _render(store, mode, q, bbox, 32, 16)
    ref = _render(store, "none", q, bbox, 32, 16)
    np.testing.assert_array_equal(got, ref)  # unit counts ≤2048/cell: exact


def test_density_weighted_fp16_stays_within_band(store):
    args = ("INCLUDE", (-90, -45, 90, 45), 16, 8)
    got = _render(store, "fp16", *args, weight_attr="w")
    ref = _render(store, "none", *args, weight_attr="w")
    # fp16 per-cell relative error ~2^-11; the decoder's mass guard would
    # have forced raw f32 had the total drifted further
    np.testing.assert_allclose(got, ref, rtol=2e-3)
    assert float(got.sum(dtype=np.float64)) == pytest.approx(
        float(ref.sum(dtype=np.float64)), rel=2e-3)

