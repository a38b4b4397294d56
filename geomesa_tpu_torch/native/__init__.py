"""The native (C++) host encoder of the index build (≙ ``geomesa_tpu.native``).

The build's host hot loops — the fused Z3/Z2 key and plane encode of a
point layer (``z3_encode``, ``z2_encode``), the bulk fp62 planes
(``fp62_planes``) and the Morton range cover (``zranges``) — as one C++
pass each over columnar arrays, multi-threaded, bound with ctypes.
``encode.cpp`` is the port's own copy of the reference's source.

It compiles at first use with ``g++ -O3 -shared -fPIC -std=c++17 -pthread``
(``$CXX`` when set) into ``geomesa_tpu_torch/_build/`` (listed in
``.gitignore``), under a file name that carries a digest of the source and
the flags, through a temporary name and an atomic rename, so concurrent
first uses in several processes cannot load a torn file. A failure to build
or load raises: nothing falls back to numpy in its place. The numpy paths
run only where the caller asks for them (``GEOMESA_TPU_NO_NATIVE``, when
every entry point returns None) or where the input has no native form (a
month or year period, a bin past int16, a range cover past its capacity:
the entry point returns None).

Parity: bit-identical outputs to the numpy paths (``index/device.py``
``fp62``, ``curves/normalize.py``, ``curves/binnedtime.py``,
``curves/zorder.py``, ``curves/ranges.py``), pinned by
``tests/test_torch_native.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Optional

import numpy as np

from geomesa_tpu_torch import config

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "encode.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_lock = threading.Lock()


def enabled() -> bool:
    """True unless ``GEOMESA_TPU_NO_NATIVE`` asks for the numpy paths."""
    return not config.NO_NATIVE.get()


def nthreads() -> int:
    """The encoder's threads: the host's cores, at most 16."""
    return max(1, min(os.cpu_count() or 1, 16))


def _target() -> str:
    with open(SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libgm_encode-{digest.hexdigest()[:12]}.so")


def _build(so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    cxx = os.environ.get("CXX") or "g++"
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([cxx, *FLAGS, SRC, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"the native encoder did not build with {cxx}: "
                           f"{e}") from e
    if proc.returncode != 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise RuntimeError(f"the native encoder did not build with {cxx} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed. Raises RuntimeError when
    it does not build or load."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _target()
        if not os.path.exists(so):
            _build(so)
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            raise RuntimeError(f"the native encoder {so} did not load: "
                               f"{e}") from e
        i64, i32, i16, u32, f64, f32, u8 = (
            np.ctypeslib.ndpointer(t, flags="C_CONTIGUOUS")
            for t in (np.int64, np.int32, np.int16, np.uint32, np.float64,
                      np.float32, np.uint8))
        lib.gm_z3_encode.argtypes = [
            f64, f64, i64, ctypes.c_int64, ctypes.c_int32,
            i32, i32, i32, i32, f32, f32, i16, i32, u32, u32, i64,
            ctypes.c_int32]
        lib.gm_z3_encode.restype = None
        lib.gm_z2_encode.argtypes = [
            f64, f64, ctypes.c_int64,
            i32, i32, i32, i32, f32, f32, u32, u32, i64, ctypes.c_int32]
        lib.gm_z2_encode.restype = None
        lib.gm_fp62.argtypes = [
            f64, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
            i32, i32, ctypes.c_int32]
        lib.gm_fp62.restype = None
        lib.gm_zranges.argtypes = [
            i64, i64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int32, i64, i64, u8, ctypes.c_int64]
        lib.gm_zranges.restype = ctypes.c_int64
        _lib = lib
        return lib


_PERIOD_CODES = {"day": 0, "week": 1}
_PERIOD_MS = {0: 86_400_000, 1: 604_800_000}


def z3_encode(x: np.ndarray, y: np.ndarray, ms: np.ndarray,
              period: str) -> Optional[Dict[str, np.ndarray]]:
    """Every build plane of a Z3 point layer in one pass: the fp62 planes
    ``xi``/``xl``/``yi``/``yl``, the f32 ``xf``/``yf``, ``bin16`` (int16)
    and ``off``, the z3 key ``z`` and its two sort planes ``zhi``/``zlo``.
    None when the numpy path must run: ``GEOMESA_TPU_NO_NATIVE``, a
    calendar period (month, year), or a bin outside int16 (the reference's
    Short bins: a date before 1970 or past bin 32767)."""
    code = _PERIOD_CODES.get(str(period).lower())
    if not enabled() or code is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    ms = np.ascontiguousarray(ms, dtype=np.int64)
    n = len(x)
    if n and not (0 <= int(ms.min())
                  and int(ms.max()) // _PERIOD_MS[code] <= 32767):
        return None
    lib = load()
    out = {"xi": np.empty(n, np.int32), "xl": np.empty(n, np.int32),
           "yi": np.empty(n, np.int32), "yl": np.empty(n, np.int32),
           "xf": np.empty(n, np.float32), "yf": np.empty(n, np.float32),
           "bin16": np.empty(n, np.int16), "off": np.empty(n, np.int32),
           "zhi": np.empty(n, np.uint32), "zlo": np.empty(n, np.uint32),
           "z": np.empty(n, np.int64)}
    lib.gm_z3_encode(x, y, ms, n, code, out["xi"], out["xl"], out["yi"],
                     out["yl"], out["xf"], out["yf"], out["bin16"],
                     out["off"], out["zhi"], out["zlo"], out["z"], nthreads())
    return out


def z2_encode(x: np.ndarray,
              y: np.ndarray) -> Optional[Dict[str, np.ndarray]]:
    """Every build plane of a Z2 point layer in one pass (``z3_encode``'s
    planes without the time planes; ``z`` the z2 key). None under
    ``GEOMESA_TPU_NO_NATIVE``."""
    if not enabled():
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    n = len(x)
    lib = load()
    out = {"xi": np.empty(n, np.int32), "xl": np.empty(n, np.int32),
           "yi": np.empty(n, np.int32), "yl": np.empty(n, np.int32),
           "xf": np.empty(n, np.float32), "yf": np.empty(n, np.float32),
           "zhi": np.empty(n, np.uint32), "zlo": np.empty(n, np.uint32),
           "z": np.empty(n, np.int64)}
    lib.gm_z2_encode(x, y, n, out["xi"], out["xl"], out["yi"], out["yl"],
                     out["xf"], out["yf"], out["zhi"], out["zlo"], out["z"],
                     nthreads())
    return out


def fp62_planes(x: np.ndarray, lo: float, hi: float):
    """(hi, lo) int32 fp62 planes of f64 values over [lo, hi], or None
    under ``GEOMESA_TPU_NO_NATIVE``."""
    if not enabled():
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    n = len(x)
    lib = load()
    phi = np.empty(n, np.int32)
    plo = np.empty(n, np.int32)
    lib.gm_fp62(x, n, float(lo), float(hi), phi, plo, nthreads())
    return phi, plo


def zranges(blo: np.ndarray, bhi: np.ndarray, dims: int, bits: int,
            max_ranges: int, max_levels: int):
    """Morton range cover of (n_boxes, dims) inclusive normalized bounds:
    merged (lo, hi, contained) inclusive z-interval arrays, or None when
    the numpy BFS must run (``GEOMESA_TPU_NO_NATIVE``, or more merged
    ranges than the output holds)."""
    if not enabled():
        return None
    blo = np.ascontiguousarray(blo, dtype=np.int64)
    bhi = np.ascontiguousarray(bhi, dtype=np.int64)
    lib = load()
    cap = 2 * int(max_ranges) + 4 * (1 << dims)
    lo = np.empty(cap, np.int64)
    hi = np.empty(cap, np.int64)
    cont = np.empty(cap, np.uint8)
    n = lib.gm_zranges(blo, bhi, blo.shape[0], dims, bits, int(max_ranges),
                       int(max_levels), lo, hi, cont, cap)
    if n < 0:
        return None
    return lo[:n], hi[:n], cont[:n].astype(bool)
