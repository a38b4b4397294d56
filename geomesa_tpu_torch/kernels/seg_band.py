"""Wrapper of the ``seg_band`` CUDA kernel (``csrc/seg_band.cu``).

``seg_band(cols, boxes, windows, resid, block_ids, bsz, edges, n_edges,
unc_cap)`` launches the kernel for tensors on a CUDA device and runs the
plain PyTorch version (``index.scan.seg_band``) for tensors on the CPU.
There is no fallback: a CUDA tensor either launches the kernel or raises.
``seg_band.launches`` counts the calls that launched the kernel (and
nothing else), so a run can show its main path went through it.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Optional

import torch

from geomesa_tpu_torch.index import scan
from geomesa_tpu_torch.kernels import build

NAME = "seg_band"
SOURCE = "geomesa_tpu_torch/kernels/csrc/seg_band.cu"
REPLACES = "geomesa_tpu/index/scan.py:754"

_ENVELOPE = ("bxmin_i", "bxmin_l", "bymin_i", "bymin_l",
            "bxmax_i", "bxmax_l", "bymax_i", "bymax_l")
_SEGMENTS = ("sx1", "sy1", "sx2", "sy2")
_TIME = ("bin", "off")


def _bind(lib: ctypes.CDLL):
    fn = lib.seg_band_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        ll = ctypes.c_longlong
        f = ctypes.c_float
        fn.argtypes = [p] * 12 + [p, ll, ll, ll, p, i, p, i] + [p] * 4 \
            + [p, i, f, f, f, p, p, i, p, p]
        fn.restype = ctypes.c_int
        lib.seg_band_chunk.restype = ctypes.c_int
        lib.seg_band_error_string.argtypes = [ctypes.c_int]
        lib.seg_band_error_string.restype = ctypes.c_char_p
    return fn


def _check(cols, boxes, windows, resid, block_ids, bsz, edges, n_edges,
           unc_cap):
    """Validate the inputs; return (table rows, candidates, device)."""
    n = int(next(iter(cols.values())).shape[0])
    for k in _ENVELOPE + (_TIME if windows is not None else ()):
        t = cols[k]
        if t.dtype != torch.int32 or t.shape != (n,):
            raise TypeError(f"column {k} must be int32 with {n} rows")
    for k in _SEGMENTS:
        t = cols[k]
        if t.dtype != torch.float32 or t.shape != (n,):
            raise TypeError(f"column {k} must be float32 with {n} rows")
    if boxes.dtype != torch.int32 or boxes.dim() != 2 or boxes.shape[1] != 8:
        raise TypeError("boxes must be a (B, 8) int32 tensor")
    if windows is not None and (windows.dtype != torch.int32
                                or windows.dim() != 2
                                or windows.shape[1] != 4):
        raise TypeError("windows must be a (T, 4) int32 tensor")
    if edges.dtype != torch.float32 or edges.dim() != 2 \
            or edges.shape[1] != 4:
        raise TypeError("edges must be a (ne, 4) float32 tensor")
    if n_edges is not None and not 0 <= n_edges <= edges.shape[0]:
        raise ValueError(f"n_edges {n_edges} outside [0, {edges.shape[0]}]")
    if block_ids.dtype != torch.int32 or block_ids.dim() != 1:
        raise TypeError("block_ids must be a 1-D int32 tensor")
    if bsz is None or int(bsz) <= 0:
        raise ValueError("block ids need a positive block size bsz")
    if unc_cap < 0:
        raise ValueError("unc_cap must be >= 0")
    ncand = int(block_ids.shape[0]) * int(bsz)
    valid = cols["__valid__"] if "__valid__" in cols else None
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != (n,)):
        raise TypeError(f"__valid__ must be bool with {n} rows")
    if resid is not None and (resid.dtype != torch.bool
                              or resid.shape != (ncand,)):
        raise TypeError(f"resid must be a bool mask of the {ncand} "
                        "candidates")
    tensors = [cols[k] for k in _ENVELOPE + _SEGMENTS] \
        + [t for t in (valid, resid, block_ids, windows, boxes, edges)
           if t is not None]
    if windows is not None:
        tensors += [cols[k] for k in _TIME]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("every input must be contiguous")
    dev = cols["sx1"].device
    if any(t.device != dev for t in tensors):
        raise ValueError("every input must lie on one device")
    return n, ncand, dev


def seg_band(cols: Mapping[str, torch.Tensor], boxes: torch.Tensor,
             windows: Optional[torch.Tensor], resid: Optional[torch.Tensor],
             block_ids: torch.Tensor, bsz: int, edges: torch.Tensor,
             n_edges: Optional[int] = None,
             unc_cap: int = 4096) -> torch.Tensor:
    """int32 ``[certain hits, n_uncertain, uncertain rows × unc_cap]``,
    left on the device; see ``index.scan.seg_band`` for the semantics."""
    n, ncand, dev = _check(cols, boxes, windows, resid, block_ids, bsz,
                           edges, n_edges, unc_cap)
    if dev.type == "cpu":
        return scan.seg_band(cols, boxes, windows, resid, block_ids, bsz,
                             edges, n_edges, unc_cap)
    if dev.type != "cuda":
        raise ValueError(f"seg_band runs on cuda or cpu, not {dev}")
    if edges.data_ptr() % 16:
        raise ValueError("edges must be 16-byte aligned (16-byte row loads)")
    ne = edges.shape[0] if n_edges is None else int(n_edges)
    out = torch.empty(2 + unc_cap, dtype=torch.int32, device=dev)
    lib = build.load(NAME)
    fn = _bind(lib)
    chunk = int(lib.seg_band_chunk())
    nchunks = max(1, -(-ncand // chunk))
    flags = torch.empty(max(1, ncand), dtype=torch.uint8, device=dev)
    counts = torch.empty(2 * nchunks, dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    valid = cols["__valid__"] if "__valid__" in cols else None
    has_time = windows is not None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(ptr(cols[k]) for k in _ENVELOPE),
                *(ptr(cols[k]) if has_time else None for k in _TIME),
                ptr(valid), ptr(resid), block_ids.data_ptr(),
                int(block_ids.shape[0]), int(bsz), n, ptr(windows),
                0 if windows is None else int(windows.shape[0]),
                boxes.data_ptr(), int(boxes.shape[0]),
                *(ptr(cols[k]) for k in _SEGMENTS),
                edges.data_ptr(), ne, scan.TOL_T, scan.TOL_D, scan.DY_BAND,
                flags.data_ptr(), counts.data_ptr(), int(unc_cap),
                out.data_ptr(), stream)
    if rc != 0:
        msg = lib.seg_band_error_string(rc).decode()
        raise RuntimeError(f"seg_band launch failed: {msg} (cudaError {rc})")
    seg_band.launches += 1
    return out


seg_band.launches = 0
