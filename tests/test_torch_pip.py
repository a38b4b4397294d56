"""The port's point-in-polygon certainty band and polygon refine
(geomesa_tpu_torch) against the JAX package's: the plain torch ``pip_band``
must give flags identical to ``scan._pip_band`` and to the Pallas kernel
``compiled._pallas_pip`` (interpret mode on the CPU), and the plain
``pip_refine`` must equal the reference's refine composition (gather, those
flags, ``m & cin``, ``m & ~cin & ~cout``), for seeded near-edge points,
masks and block starts. Tolerance: none, the flags are compared exactly.

The CUDA kernel is held to the plain version by the ``gpu`` tests, which
skip without a card. They import nothing of JAX, so on the card (where JAX
is not installed) ``python -m pytest --noconftest -m gpu
tests/test_torch_pip.py`` runs them; the reference is imported only by the
tests that compare with it."""

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
    m = min(8, len(r), n - h)
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


def _masks(n: int, seed: int = 21):
    """The mask shapes of the refine tests: all live, none live, 20% at
    random, and 20% in coherent runs (of 1 to 600 rows)."""
    rng = np.random.default_rng(seed)
    runs = np.zeros(n, dtype=bool)
    at = 0
    while at < n:
        length = int(rng.integers(1, 600))
        runs[at:at + length] = rng.random() < 0.2
        at += length
    return {"all": np.ones(n, dtype=bool), "none": np.zeros(n, dtype=bool),
            "random20": rng.random(n) < 0.2, "runs20": runs}


def _table_and_starts(ring, n_rows: int, bsz: int, seed: int):
    """A coordinate table of n_rows near-edge points (some exactly on a
    vertex's y, some at ±0) and the starts of every other block of bsz
    rows, the last one clamped to n_rows - bsz as the fused program's."""
    px, py = _points(ring, n_rows, seed=seed)
    r = np.asarray(ring, dtype=np.float32)
    k = np.arange(0, n_rows, 7)
    py[k] = r[k % len(r), 1]                       # ties a vertex's y
    px[1::97], py[2::97] = np.float32(-0.0), np.float32(0.0)
    px[3::97], py[3::97] = np.float32(0.0), np.float32(-0.0)
    nb = -(-n_rows // bsz)
    starts = np.arange(0, nb, 2, dtype=np.int64) * bsz
    if (nb - 1) % 2:
        starts = np.append(starts, (nb - 1) * bsz)
    return px, py, np.minimum(starts, n_rows - bsz)


REFINE_RINGS = {"concave": CONCAVE,
                "diamond": [(-1, 0), (0, -1), (1, 0), (0, 1), (-1, 0)]}


@pytest.mark.parametrize("flags", ["band", "pallas"])
@pytest.mark.parametrize("mask", ["all", "none", "random20", "runs20"])
@pytest.mark.parametrize("ring", sorted(REFINE_RINGS))
def test_plain_refine_equals_reference_composition(ring, mask, flags):
    jnp, _, jcompiled = _reference()
    ring = REFINE_RINGS[ring]
    bsz = 96
    px, py, starts = _table_and_starts(ring, 2_000, bsz, seed=13)
    ep = _edges(ring)
    rows = (starts[:, None] + np.arange(bsz)[None, :]).reshape(-1)
    m = _masks(len(rows))[mask]
    if flags == "band":
        cin, cout = _jax_band(px[rows], py[rows], ep)
    else:
        cin, cout = (np.asarray(a) for a in jcompiled._pallas_pip(
            jnp.asarray(px[rows]), jnp.asarray(py[rows]), jnp.asarray(ep)))
    want_hit, want_unc = m & cin, m & ~cin & ~cout
    t = [torch.from_numpy(a) for a in (px, py, ep)]
    for fn in (tscan.pip_refine, tpip.pip_refine):
        hit, unc = fn(*t, mask=torch.from_numpy(m),
                      starts=torch.from_numpy(starts), bsz=bsz)
        assert np.array_equal(hit.numpy(), want_hit)
        assert np.array_equal(unc.numpy(), want_unc)
    if mask == "all":   # the tie and near-edge rows reach every class
        assert want_hit.any() and want_unc.any() and (~cin & ~cout).any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_pad_edges_change_no_flag(case):
    """EDGE_PAD rows can set neither a crossing nor a band flag: the flags
    with the padded table, with its real rows only, and with n_edges equal."""
    ring, _ = CASES[case]
    px, py = _points(ring, 4_000, seed=17)
    ep = _edges(ring)
    ne = len(ring) - 1
    assert len(ep) > ne and np.all(ep[ne:] == tscan.EDGE_PAD)
    t = [torch.from_numpy(a) for a in (px, py)]
    padded = tscan.pip_refine(*t, torch.from_numpy(ep))
    for kw in ({"edges": torch.from_numpy(ep[:ne].copy())},
               {"edges": torch.from_numpy(ep), "n_edges": ne}):
        got = tscan.pip_refine(*t, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, padded))


def test_wrapper_cpu_runs_plain_and_counts_nothing():
    ring, _ = CASES["concave"]
    px, py = _points(ring, 1_000)
    t = [torch.from_numpy(a) for a in (px, py, _edges(ring))]
    before = tpip.pip_refine.launches
    got = tpip.pip_refine(*t)
    cin, cout = tscan.pip_band(*t)
    assert tpip.pip_refine.launches == before
    assert torch.equal(got[0], cin) and torch.equal(got[1], ~cin & ~cout)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "length",
                                 "mask_dtype", "mask_length", "starts_bsz",
                                 "n_edges"])
def test_wrapper_rejects_bad_inputs(bad):
    px = torch.zeros(8)
    py = torch.zeros(8)
    ep = torch.from_numpy(np.tile(tscan.EDGE_PAD, (4, 1)))
    kw = {}
    if bad == "dtype":
        px = px.double()
    elif bad == "shape":
        ep = ep[:, :3].contiguous()
    elif bad == "contiguous":
        px = torch.zeros(16)[::2]
    elif bad == "length":
        py = torch.zeros(7)
    elif bad == "mask_dtype":
        kw["mask"] = torch.ones(8, dtype=torch.uint8)
    elif bad == "mask_length":
        kw["mask"] = torch.ones(7, dtype=torch.bool)
    elif bad == "starts_bsz":
        kw["starts"] = torch.zeros(2, dtype=torch.int64)
    else:
        kw["n_edges"] = 5
    with pytest.raises((TypeError, ValueError)):
        tpip.pip_refine(px, py, ep, **kw)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_equals_plain(case):
    dev = _cuda()
    ring, _ = CASES[case]
    px, py = _points(ring, 200_003)
    t = [torch.from_numpy(a).to(dev) for a in (px, py, _edges(ring))]
    before = tpip.pip_refine.launches
    khit, kunc = tpip.pip_refine(*t, n_edges=len(ring) - 1)
    torch.cuda.synchronize()
    assert tpip.pip_refine.launches == before + 1
    phit, punc = tscan.pip_refine(*t)
    assert torch.equal(khit, phit) and torch.equal(kunc, punc)


@pytest.mark.gpu
@pytest.mark.parametrize("mask", ["all", "none", "random20", "runs20"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_masked_refine_equals_plain(case, mask):
    """Masks and clamped block starts at a size of many tiles and CTAs."""
    dev = _cuda()
    ring, _ = CASES[case]
    bsz = 4096
    px, py, starts = _table_and_starts(ring, 300_001, bsz, seed=19)
    m = _masks(len(starts) * bsz)[mask]
    t = [torch.from_numpy(a).to(dev) for a in (px, py, _edges(ring))]
    kw = {"mask": torch.from_numpy(m).to(dev),
          "starts": torch.from_numpy(starts).to(dev), "bsz": bsz}
    khit, kunc = tpip.pip_refine(*t, n_edges=len(ring) - 1, **kw)
    phit, punc = tscan.pip_refine(*t, **kw)
    assert torch.equal(khit, phit) and torch.equal(kunc, punc)


_TILE = 256   # candidates per warp tile in csrc/pip_refine.cu
_CHUNK = 512  # edges per shared-memory buffer there


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["none", "mask", "mask_unaligned",
                                     "starts", "starts_odd"])
@pytest.mark.parametrize("n", [0, 1, 31, 33, _TILE - 1, _TILE + 1])
@pytest.mark.parametrize("ne", [1, 5, 8, _CHUNK - 1, _CHUNK, _CHUNK + 1,
                                5000])
def test_cuda_refine_shapes_equal_plain(ne, n, variant):
    """Edge counts around the chunk size, candidate counts around the warp
    tile, with and without mask and starts (power-of-two and odd block
    sizes, a mask off 8-byte alignment)."""
    dev = _cuda()
    ring = _ring(ne, seed=ne)
    ep = _edges(ring)
    rng = np.random.default_rng(n * 31 + ne)
    kw = {}
    if variant.startswith("starts"):
        bsz = 32 if variant == "starts" else 33
        rows = max(bsz, 4 * n)
        px, py = _points(ring, rows, seed=n + 1)
        starts = np.minimum(np.arange(-(-n // bsz), dtype=np.int64) * 3 * bsz,
                            rows - bsz)
        kw.update(starts=torch.from_numpy(starts).to(dev), bsz=bsz)
        n = len(starts) * bsz
    else:
        px, py = _points(ring, n, seed=n + 1)
    if variant != "none":
        m = torch.from_numpy(rng.random(n + 1) < 0.5).to(dev)
        kw["mask"] = m[1:] if variant == "mask_unaligned" else m[:n]
    t = [torch.from_numpy(a).to(dev) for a in (px, py, ep)]
    khit, kunc = tpip.pip_refine(*t, n_edges=ne, **kw)
    phit, punc = tscan.pip_refine(*t, **kw)
    assert khit.shape == (n,) and kunc.shape == (n,)
    assert torch.equal(khit, phit) and torch.equal(kunc, punc)


@pytest.mark.gpu
def test_cuda_slice_refine_equals_cpu():
    """The fused program on the card (kernel) and on the CPU (plain
    version) give the same polygon counts and rows."""
    _cuda()
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
    before = tpip.pip_refine.launches
    for q in (f"INTERSECTS(geom, {poly})",
              f"INTERSECTS(geom, {poly}) AND val > 10 AND dtg DURING "
              "2020-01-05T00:00:00Z/2020-01-12T00:00:00Z"):
        assert gpu.count(q) == cpu.count(q)
        assert np.array_equal(gpu.select_indices(q), cpu.select_indices(q))
    assert tpip.pip_refine.launches >= before + 4
