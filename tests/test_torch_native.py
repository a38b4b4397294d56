"""The port's native encoder (``geomesa_tpu_torch.native``) and the builds
that run on it, against the reference's native encoder and both packages'
numpy paths:

- ``tests/test_native.py``'s inputs through the port's encoder, the
  reference's and the numpy paths: the Z3 and Z2 encodes, the fp62 planes
  and the range cover, all bit-identical; the month period and a bin past
  int16 decline to numpy in both packages;
- a ``Z3Index``/``Z2Index`` built natively (single shot and streamed in
  small chunks, the last chunk down to one row), built from numpy
  (``GEOMESA_TPU_NO_NATIVE``) and built by the reference: one permutation
  (ties in the stable order of ``np.lexsort``) and byte-equal columns;
- a failed chunk upload re-raises and does not hang the streamed build;
- an encoder that does not build raises: nothing runs numpy in its place.

The port runs with device="cpu" here.
"""

import os
import threading

import numpy as np
import pytest
import torch

from geomesa_tpu import config as jconfig
from geomesa_tpu import native as jnative
from geomesa_tpu.curves import ranges as jranges
from geomesa_tpu.features.sft import SimpleFeatureType as JSFT
from geomesa_tpu.features.table import FeatureTable as JTable
from geomesa_tpu.index.spatial import Z2Index as JZ2
from geomesa_tpu.index.spatial import Z3Index as JZ3
from geomesa_tpu_torch import config as tconfig
from geomesa_tpu_torch import native
from geomesa_tpu_torch.curves import ranges as tranges
from geomesa_tpu_torch.curves.binnedtime import TimePeriod, time_to_binned_time
from geomesa_tpu_torch.curves.sfc import Z2SFC, Z3SFC
from geomesa_tpu_torch.features.sft import SimpleFeatureType as TSFT
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.index import device as tdevice
from geomesa_tpu_torch.index import spatial as tspatial

SPEC3 = "name:String,val:Int,dtg:Date,*geom:Point;geomesa.z3.interval=week"
SPEC2 = "name:String,val:Int,*geom:Point"


@pytest.fixture(autouse=True)
def _thresholds():
    yield
    for c in (tconfig.NO_NATIVE, tconfig.BUILD_STREAM_CHUNK,
              jconfig.NO_NATIVE):
        c.unset()


def _corpus(n=50_000, seed=7):
    """``tests/test_native.py``'s corpus: out-of-domain values (the lenient
    clamp) and the domain's edges."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-185, 185, n)
    y = rng.uniform(-92, 92, n)
    base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
    ms = base + rng.integers(0, 400 * 86400000, n)
    x[:8] = [-180.0, 180.0, 0.0, -1e-300, 179.99999999999997, -180.1, 180.1,
             10.0]
    y[:8] = [-90.0, 90.0, 0.0, 1e-300, 89.99999999999999, -90.1, 90.1, 45.0]
    ms[0] = base
    return x, y, ms


def _numpy_fp62(v, lo, hi):
    """``index/device.py``'s fp62 with the native route off."""
    tconfig.NO_NATIVE.set(True)
    try:
        return tdevice.fp62(v, lo, hi)
    finally:
        tconfig.NO_NATIVE.unset()


def _equal(a: dict, b: dict, keys) -> None:
    for k in keys:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("period", ["day", "week"])
def test_z3_encode_parity(period):
    x, y, ms = _corpus()
    got = native.z3_encode(x, y, ms, period)
    ref = jnative.z3_encode(x, y, ms, period)
    assert got is not None and ref is not None
    _equal(got, ref, ref.keys())
    want = {}
    want["xi"], want["xl"] = _numpy_fp62(np.clip(x, -180, 180), -180.0, 180.0)
    want["yi"], want["yl"] = _numpy_fp62(np.clip(y, -90, 90), -90.0, 90.0)
    tp = TimePeriod.parse(period)
    bins, offs = time_to_binned_time(ms, tp)
    want["bin16"] = bins.astype(np.int16)
    want["off"] = offs.astype(np.int32)
    want["xf"] = x.astype(np.float32)
    want["yf"] = y.astype(np.float32)
    sfc = Z3SFC.apply(tp)
    z = np.asarray(sfc.index(x, y, np.minimum(offs, int(sfc.time.max)),
                             lenient=True), dtype=np.int64)
    want["z"] = z
    want["zhi"] = (z.astype(np.uint64) >> np.uint64(31)).astype(np.uint32)
    want["zlo"] = (z.astype(np.uint64)
                   & np.uint64(0x7FFFFFFF)).astype(np.uint32)
    _equal(got, want, want.keys())


def test_z2_encode_parity():
    x, y, _ = _corpus(seed=11)
    got = native.z2_encode(x, y)
    ref = jnative.z2_encode(x, y)
    _equal(got, ref, ref.keys())
    want = {"z": np.asarray(Z2SFC().index(x, y, lenient=True),
                            dtype=np.int64),
            "xf": x.astype(np.float32), "yf": y.astype(np.float32)}
    want["xi"], want["xl"] = _numpy_fp62(np.clip(x, -180, 180), -180.0, 180.0)
    want["yi"], want["yl"] = _numpy_fp62(np.clip(y, -90, 90), -90.0, 90.0)
    _equal(got, want, want.keys())


@pytest.mark.parametrize("n", [10_000, 70_000])
def test_fp62_planes_parity(n):
    """``tests/test_native.py``'s 10,000 values, and a bulk encode that
    ``index/device.py`` sends to the native encoder itself."""
    x = np.random.default_rng(3).uniform(-180, 180, n)
    got = native.fp62_planes(x, -180.0, 180.0)
    ref = jnative.fp62_planes(x, -180.0, 180.0)
    want = _numpy_fp62(x, -180.0, 180.0)
    bulk = tdevice.fp62(x, -180.0, 180.0)
    for a in (ref, want, bulk):
        assert all(p.tobytes() == q.tobytes() for p, q in zip(got, a))


def test_month_period_falls_back():
    x, y, ms = _corpus(n=100)
    assert native.z3_encode(x, y, ms, "month") is None
    assert jnative.z3_encode(x, y, ms, "month") is None


def test_bin_overflow_falls_back():
    """Bins ride as int16 (the reference's Short bins): a bin past 32767 or
    before 1970 declines to the numpy path instead of wrapping."""
    x, y, _ = _corpus(n=16)
    far = np.datetime64("2060-01-01T00:00:00", "ms").astype(np.int64)
    for enc in (native.z3_encode, jnative.z3_encode):
        assert enc(x[:4], y[:4], np.full(4, far), "day") is None
        assert enc(x[:4], y[:4], np.full(4, -1, np.int64), "day") is None
        assert enc(x[:4], y[:4], np.full(4, far), "week") is not None


def test_no_native_declines_every_entry_point():
    tconfig.NO_NATIVE.set(True)
    x, y, ms = _corpus(n=100)
    assert native.z3_encode(x, y, ms, "week") is None
    assert native.z2_encode(x, y) is None
    assert native.fp62_planes(x, -180.0, 180.0) is None
    assert native.zranges(np.zeros((1, 2), np.int64),
                          np.ones((1, 2), np.int64), 2, 31, 10, 64) is None


def test_zranges_parity_with_python_bfs():
    """``tests/test_native.py``'s 60 random covers: the port's native cover,
    its numpy BFS and the reference's native cover, bit-identical."""
    rng = np.random.default_rng(7)
    for trial in range(60):
        dims = 2 if trial % 2 else 3
        bits = 31 if dims == 2 else 21
        boxes = []
        for _ in range(int(rng.integers(1, 4))):
            b = []
            for _d in range(dims):
                lo = int(rng.integers(0, (1 << bits) - 1))
                hi = int(rng.integers(lo, min((1 << bits) - 1,
                                              lo + (1 << rng.integers(5, bits)))))
                b.append((lo, hi))
            boxes.append(b)
        mr = int(rng.choice([50, 500, 2000]))
        nat = tranges._zranges_arrays(boxes, bits, dims, mr, 64)
        ref = jranges._zranges_arrays(boxes, bits, dims, mr, 64)
        tconfig.NO_NATIVE.set(True)
        try:
            py = tranges._zranges_arrays(boxes, bits, dims, mr, 64)
        finally:
            tconfig.NO_NATIVE.unset()
        for a, b2, c, name in zip(nat, py, ref, ("lo", "hi", "cont")):
            assert a.dtype == b2.dtype == c.dtype, (trial, name)
            assert np.array_equal(a, b2) and np.array_equal(a, c), \
                (trial, name)
        assert len(nat[0]) <= 2 * mr


def _table_columns(n: int, seed: int) -> dict:
    """Points with ties: every fifth row repeats an earlier row's point and
    time, so equal keys must keep the stable order of ``np.lexsort``."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-170, 170, n)
    y = rng.uniform(-80, 80, n)
    base = np.datetime64("2020-01-01T00:00:00", "ms").astype(np.int64)
    dtg = base + rng.integers(0, 60 * 86400000, n)
    dup = np.arange(0, n, 5)[1:]
    src = rng.integers(0, n // 2, len(dup))
    x[dup], y[dup], dtg[dup] = x[src], y[src], dtg[src]
    name = rng.choice(["a", "b", "c"], n)
    val = rng.integers(0, 100, n).astype(np.int32)
    return {"name": name, "val": val, "dtg": dtg, "geom": (x, y)}


def _indexes(kind: str, n: int = 6000, seed: int = 5):
    spec = SPEC3 if kind == "z3" else SPEC2
    cols = _table_columns(n, seed)
    if kind == "z2":
        cols.pop("dtg")
    T = tspatial.Z3Index if kind == "z3" else tspatial.Z2Index
    J = JZ3 if kind == "z3" else JZ2
    jsft, tsft = JSFT.from_spec("t", spec), TSFT.from_spec("t", spec)
    jt, tt = JTable.build(jsft, cols), TTable.build(tsft, cols)
    return J(jsft, jt), lambda: T(tsft, tt, "cpu")


def _same(a, b) -> None:
    assert torch.equal(a.perm, b.perm)
    assert a.perm.dtype == b.perm.dtype == torch.int64
    assert list(a.device.columns) == list(b.device.columns)
    for k in a.device.columns:
        x, y = a.device.columns[k], b.device.columns[k]
        assert x.dtype == y.dtype, k
        assert x.numpy().tobytes() == y.numpy().tobytes(), k
    assert a._z.dtype == b._z.dtype and np.array_equal(a._z, b._z)
    if hasattr(b, "_bins"):
        assert a._bins.dtype == b._bins.dtype
        assert np.array_equal(a._bins, b._bins)


# BUILD_STREAM_CHUNK over the 6,000-row tables: one shot, the streamed
# build in chunks of 1,000 and of 4,096 rows, and in two chunks the last
# of one row
BUILDS = {"one_shot": 10**9, "streamed_1000": 1000, "streamed_4096": 4096,
          "streamed_last_row_alone": 5999}


@pytest.mark.parametrize("build", list(BUILDS))
@pytest.mark.parametrize("kind", ["z3", "z2"])
def test_native_build_equals_numpy_and_reference(kind, build):
    ref, make = _indexes(kind)
    chunk = BUILDS[build]
    tconfig.NO_NATIVE.set(True)
    numpy_built = make()
    tconfig.NO_NATIVE.unset()
    assert "keys_s" in numpy_built.build_stages
    tconfig.BUILD_STREAM_CHUNK.set(chunk)
    got = make()
    stages = got.build_stages
    first = "encode_upload_overlap_s" if build.startswith("streamed") \
        else "encode_s"
    assert first in stages and "keys_s" not in stages
    assert {"sort_s", "planes_s", "upload_s", "gather_s"} <= set(stages)
    _same(got, numpy_built)
    keys = numpy_built._sort_keys()
    assert np.array_equal(got.perm.numpy(),
                          np.lexsort(tuple(reversed(keys))))
    assert np.array_equal(got.perm.numpy(), np.asarray(ref.perm))
    jcols = {k: np.asarray(v) for k, v in ref.device.columns.items()}
    assert set(got.device.columns) == set(jcols)
    for k, v in got.device.columns.items():
        assert v.numpy().dtype == jcols[k].dtype, k
        assert v.numpy().tobytes() == jcols[k].tobytes(), k
    assert np.array_equal(got.sorted_z, np.asarray(ref.sorted_z))


def test_streamed_chunk_that_declines_builds_from_numpy():
    """A chunk whose bins leave int16 declines the native route: the build
    runs from numpy, and equals the numpy build."""
    cols = _table_columns(3000, 9)
    cols["dtg"][2500] = np.datetime64("2090-01-01T00:00:00",
                                      "ms").astype(np.int64)
    spec = SPEC3.replace("week", "day")
    tsft = TSFT.from_spec("t", spec)
    tt = TTable.build(tsft, cols)
    tconfig.BUILD_STREAM_CHUNK.set(1000)
    got = tspatial.Z3Index(tsft, tt, "cpu")
    assert "keys_s" in got.build_stages
    tconfig.NO_NATIVE.set(True)
    _same(got, tspatial.Z3Index(tsft, tt, "cpu"))


def test_failed_upload_reraises_without_hanging(monkeypatch):
    """The uploader keeps draining the queue after an error, so the encoder
    never blocks on it; the error reaches the caller."""
    _, make = _indexes("z3", n=9000)
    tconfig.BUILD_STREAM_CHUNK.set(500)
    put = tspatial._ChunkUploader.put
    seen = []

    def failing(self, i, a, enc):
        seen.append(i)
        if i == 1:
            raise MemoryError("device memory exhausted")
        put(self, i, a, enc)

    monkeypatch.setattr(tspatial._ChunkUploader, "put", failing)
    out = {}

    def build():
        try:
            make()
        except BaseException as e:  # noqa: BLE001 - inspected below
            out["error"] = e

    th = threading.Thread(target=build, daemon=True)
    th.start()
    th.join(timeout=120)
    assert not th.is_alive(), "the streamed build hung after a failed upload"
    assert isinstance(out.get("error"), MemoryError)
    assert seen[:2] == [0, 1] and len(seen) <= 2


def test_broken_compiler_raises(monkeypatch, tmp_path):
    """An encoder that does not build fails the build; nothing runs the
    numpy path in its place."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    _, make = _indexes("z3", n=500)
    with pytest.raises(RuntimeError, match="did not build"):
        make()
    x, y, ms = _corpus(n=10)
    with pytest.raises(RuntimeError, match="did not build"):
        native.z3_encode(x, y, ms, "week")
    assert not list(tmp_path.glob("*.so"))


def test_build_lands_in_the_build_dir(monkeypatch, tmp_path):
    """A first use builds into the build directory under the source's
    digest (no temporary file left), and loads from there."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    x, y, ms = _corpus(n=1000)
    got = native.z3_encode(x, y, ms, "week")
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == 1 and files[0].startswith("libgm_encode-") \
        and files[0].endswith(".so")
    _equal(got, jnative.z3_encode(x, y, ms, "week"), got.keys())
    assert native.nthreads() == max(1, min(os.cpu_count() or 1, 16))
