"""Wrapper of the ``pair_band`` CUDA kernel (``csrc/pair_band.cu``).

``pair_band(lsegs, lcnt, lpoly, lsingle, rsegs, rcnt, rpoly, rsingle, pl,
pr)`` launches the kernel for tensors on a CUDA device and runs the plain
PyTorch version (``parallel.pair_kernel.pair_plain``) for tensors on the
CPU. There is no fallback: a CUDA tensor either launches the kernel or
raises. ``pair_band.launches`` counts the calls that launched the kernel
(and nothing else). A call is one launch; it allocates only its output.
"""

from __future__ import annotations

import ctypes

import torch

from geomesa_tpu_torch.index import scan
from geomesa_tpu_torch.kernels import build

NAME = "pair_band"
SOURCE = "geomesa_tpu_torch/kernels/csrc/pair_band.cu"
REPLACES = "geomesa_tpu/parallel/pair_kernel.py:137"   # _pair_fn, _band_core :87

_FN = None


def _bind():
    global _FN
    if _FN is None:
        lib = build.load(NAME)
        p, i = ctypes.c_void_p, ctypes.c_int
        f = ctypes.c_float
        fn = lib.pair_band_launch
        fn.argtypes = [p, p, p, p, i, i, p, p, p, p, i, i, p, p,
                       ctypes.c_longlong, f, f, f, p, i, p]
        fn.restype = ctypes.c_int
        lib.pair_band_error_string.argtypes = [ctypes.c_int]
        lib.pair_band_error_string.restype = ctypes.c_char_p
        _FN = fn
    return _FN


def _check_side(segs, cnt, poly, single, dev, label: str) -> None:
    if segs.dtype != torch.float32 or segs.dim() != 3 or segs.shape[2] != 4:
        raise TypeError(f"{label} segments must be a (G, S, 4) float32 "
                        "tensor")
    g = (int(segs.shape[0]),)
    if cnt.dtype != torch.int32 or cnt.shape != g:
        raise TypeError(f"{label} counts must be int32 of shape {g}")
    for t, what in ((poly, "polygonal"), (single, "single-part")):
        if t.dtype != torch.bool or t.shape != g:
            raise TypeError(f"{label} {what} flags must be bool of shape {g}")
    for t in (segs, cnt, poly, single):
        build.placed(t, dev)
    if g[0] == 0:
        raise ValueError(f"{label} table has no geometry")
    if dev.type == "cuda":
        if segs.data_ptr() % 16:
            raise ValueError(f"{label} segments must be 16-byte aligned")
        if bool(((cnt < 0) | (cnt > segs.shape[1])).any()):
            raise ValueError(f"{label} counts outside [0, {segs.shape[1]}]")


def pair_band(lsegs, lcnt, lpoly, lsingle, rsegs, rcnt, rpoly, rsingle,
              pl: torch.Tensor, pr: torch.Tensor) -> torch.Tensor:
    """(2, ceil(P/8)) uint8 packed (certain hit, uncertain) verdicts of
    the pairs; see ``parallel.pair_kernel.pair_plain``."""
    dev = pl.device
    if pl.dtype != torch.int32 or pl.dim() != 1 or pr.dtype != torch.int32 \
            or pr.shape != pl.shape:
        raise TypeError("pl and pr must be 1-D int32 tensors of one length")
    build.placed(pl, dev)
    build.placed(pr, dev)
    _check_side(lsegs, lcnt, lpoly, lsingle, dev, "left")
    _check_side(rsegs, rcnt, rpoly, rsingle, dev, "right")
    if dev.type == "cpu":
        from geomesa_tpu_torch.parallel import pair_kernel
        return pair_kernel.pair_plain(lsegs, lcnt, lpoly, lsingle, rsegs,
                                      rcnt, rpoly, rsingle, pl, pr)
    if dev.type != "cuda":
        raise ValueError(f"pair_band runs on cuda or cpu, not {dev}")
    n = int(pl.shape[0])
    out = torch.empty((2, (n + 7) // 8), dtype=torch.uint8, device=dev)
    fn = _bind()
    with build.on_device(dev):
        rc = fn(lsegs.data_ptr(), lcnt.data_ptr(), lpoly.data_ptr(),
                lsingle.data_ptr(), int(lsegs.shape[0]), int(lsegs.shape[1]),
                rsegs.data_ptr(), rcnt.data_ptr(), rpoly.data_ptr(),
                rsingle.data_ptr(), int(rsegs.shape[0]), int(rsegs.shape[1]),
                pl.data_ptr(), pr.data_ptr(), n, scan.TOL_T, scan.TOL_D,
                scan.DY_BAND, out.data_ptr(), dev.index,
                build.raw_stream(dev))
    if rc != 0:
        msg = build.load(NAME).pair_band_error_string(rc).decode()
        raise RuntimeError(f"pair_band launch failed: {msg} (cudaError {rc})")
    pair_band.launches += 1
    return out


pair_band.launches = 0
