"""The port's point-in-polygon certainty band (geomesa_tpu_torch) against
the JAX package's: the plain torch ``pip_band`` must give flags identical
to ``scan._pip_band`` and to the Pallas kernel ``compiled._pallas_pip``
(interpret mode on the CPU), for seeded near-edge points. Tolerance: none,
the flags are compared exactly.

The CUDA kernel is held to the plain version by the ``gpu`` tests, which
skip without a card. They import nothing of JAX, so on the card (where JAX
is not installed) ``python -m pytest -m gpu tests/test_torch_pip.py`` runs
them; the reference is imported only by the tests that compare with it."""

import numpy as np
import pytest
import torch

from geomesa_tpu_torch.index import scan as tscan
from geomesa_tpu_torch.kernels import pip as tpip


def _reference():
    """(jax.numpy, reference scan, reference compiled)."""
    jnp = pytest.importorskip("jax.numpy")
    from geomesa_tpu.index import compiled, scan
    return jnp, scan, compiled

CONCAVE = [(-10, 20), (40, 20), (40, 60), (-10, 60), (15, 40), (-10, 20)]


def _ring(nv: int, seed: int = 3):
    """Closed star-shaped ring of nv vertices around (15, 40)."""
    rng = np.random.default_rng(seed)
    ang = np.sort(rng.uniform(0, 2 * np.pi, nv))
    rad = rng.uniform(5, 20, nv)
    pts = np.stack([15 + rad * np.cos(ang), 40 + rad * np.sin(ang)], 1)
    return np.vstack([pts, pts[:1]])


def _edges(ring) -> np.ndarray:
    """Padded (pow2 ≥ 4) f32 edge table, the fused program's layout."""
    r = np.asarray(ring, dtype=np.float64)
    segs = np.concatenate([r[:-1], r[1:]], axis=1).astype(np.float32)
    ne = max(4, 1 << (len(segs) - 1).bit_length())
    ep = np.tile(tscan.EDGE_PAD, (ne, 1))
    ep[: len(segs)] = segs
    return ep


def _points(ring, n: int, seed: int = 11):
    """Half uniform over the ring's bbox, half within 1e-5 deg of an edge
    (and some exactly on vertices), as f32."""
    rng = np.random.default_rng(seed)
    r = np.asarray(ring, dtype=np.float64)
    x0, y0 = r.min(0) - 1
    x1, y1 = r.max(0) + 1
    h = n // 2
    px = np.empty(n)
    py = np.empty(n)
    px[:h] = rng.uniform(x0, x1, h)
    py[:h] = rng.uniform(y0, y1, h)
    k = rng.integers(0, len(r) - 1, n - h)
    t = rng.uniform(0, 1, n - h)
    a, b = r[k], r[k + 1]
    px[h:] = a[:, 0] + t * (b[:, 0] - a[:, 0]) + rng.uniform(-1e-5, 1e-5, n - h)
    py[h:] = a[:, 1] + t * (b[:, 1] - a[:, 1]) + rng.uniform(-1e-5, 1e-5, n - h)
    m = min(8, len(r))
    px[h:h + m] = r[:m, 0]
    py[h:h + m] = r[:m, 1]
    return px.astype(np.float32), py.astype(np.float32)


CASES = {"concave": (CONCAVE, 20_000), "ring1024": (_ring(1000), 1_536)}


def _jax_band(px, py, ep):
    jnp, jscan, _ = _reference()
    cin, cout = jscan._pip_band(
        jnp.asarray(px)[:, None], jnp.asarray(py)[:, None],
        *(jnp.asarray(ep[None, :, k]) for k in range(4)))
    return np.asarray(cin), np.asarray(cout)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_equals_jax_band(case):
    ring, n = CASES[case]
    px, py = _points(ring, n)
    ep = _edges(ring)
    jin, jout = _jax_band(px, py, ep)
    tin, tout = tscan.pip_band(torch.from_numpy(px), torch.from_numpy(py),
                               torch.from_numpy(ep))
    assert np.array_equal(tin.numpy(), jin)
    assert np.array_equal(tout.numpy(), jout)
    # the near-edge half must really exercise all three classes
    assert jin.any() and jout.any() and (~jin & ~jout).any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_equals_pallas_kernel(case):
    jnp, _, jcompiled = _reference()
    ring, n = CASES[case]
    n = min(n, 2_048)   # interpret mode is slow
    px, py = _points(ring, n, seed=5)
    ep = _edges(ring)
    pin, pout = jcompiled._pallas_pip(jnp.asarray(px), jnp.asarray(py),
                                      jnp.asarray(ep))
    tin, tout = tscan.pip_band(torch.from_numpy(px), torch.from_numpy(py),
                               torch.from_numpy(ep))
    assert np.array_equal(tin.numpy(), np.asarray(pin))
    assert np.array_equal(tout.numpy(), np.asarray(pout))


def test_plain_chunking_is_exact(monkeypatch):
    ring, n = CASES["concave"]
    px, py = _points(ring, 3_000, seed=9)
    t = [torch.from_numpy(a) for a in (px, py, _edges(ring))]
    whole = tscan.pip_band(*t)
    monkeypatch.setattr(tscan, "_PIP_CHUNK_PAIRS", 97)
    chunked = tscan.pip_band(*t)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_wrapper_cpu_runs_plain_and_counts_nothing():
    ring, _ = CASES["concave"]
    px, py = _points(ring, 1_000)
    t = [torch.from_numpy(a) for a in (px, py, _edges(ring))]
    before = tpip.pip_flags.launches
    got = tpip.pip_flags(*t)
    want = tscan.pip_band(*t)
    assert tpip.pip_flags.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "length"])
def test_wrapper_rejects_bad_inputs(bad):
    px = torch.zeros(8)
    py = torch.zeros(8)
    ep = torch.from_numpy(np.tile(tscan.EDGE_PAD, (4, 1)))
    if bad == "dtype":
        px = px.double()
    elif bad == "shape":
        ep = ep[:, :3].contiguous()
    elif bad == "contiguous":
        px = torch.zeros(16)[::2]
    else:
        py = torch.zeros(7)
    with pytest.raises((TypeError, ValueError)):
        tpip.pip_flags(px, py, ep)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_equals_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    ring, _ = CASES[case]
    px, py = _points(ring, 200_003)
    t = [torch.from_numpy(a).cuda() for a in (px, py, _edges(ring))]
    before = tpip.pip_flags.launches
    kin, kout = tpip.pip_flags(*t)
    torch.cuda.synchronize()
    assert tpip.pip_flags.launches == before + 1
    pin, pout = tscan.pip_band(*t)
    assert torch.equal(kin, pin) and torch.equal(kout, pout)


@pytest.mark.gpu
def test_cuda_slice_refine_equals_cpu():
    """The fused program on the card (kernel) and on the CPU (plain
    version) give the same polygon counts and rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from geomesa_tpu_torch.features.sft import SimpleFeatureType
    from geomesa_tpu_torch.features.table import FeatureTable
    from geomesa_tpu_torch.index.planner import QueryPlanner
    from geomesa_tpu_torch.index.spatial import Z3Index
    rng = np.random.default_rng(7)
    n = 200_000
    base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
    sft = SimpleFeatureType.from_spec(
        "t", "val:Int,dtg:Date,*geom:Point;geomesa.z3.interval=week")
    table = FeatureTable.build(sft, {
        "val": rng.integers(0, 100, n).astype(np.int32),
        "dtg": base + rng.integers(0, 30 * 86400000, n),
        "geom": (rng.uniform(-30, 60, n), rng.uniform(0, 80, n))})
    cpu = QueryPlanner(sft, table, [Z3Index(sft, table, "cpu")])
    gpu = QueryPlanner(sft, table, [Z3Index(sft, table, "cuda")])
    poly = "POLYGON((-10 20, 40 20, 40 60, -10 60, 15 40, -10 20))"
    before = tpip.pip_flags.launches
    for q in (f"INTERSECTS(geom, {poly})",
              f"INTERSECTS(geom, {poly}) AND val > 10 AND dtg DURING "
              "2020-01-05T00:00:00Z/2020-01-12T00:00:00Z"):
        assert gpu.count(q) == cpu.count(q)
        assert np.array_equal(gpu.select_indices(q), cpu.select_indices(q))
    assert tpip.pip_flags.launches >= before + 4
