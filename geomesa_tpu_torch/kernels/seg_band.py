"""Wrapper of the ``seg_band`` CUDA kernel (``csrc/seg_band.cu``).

``seg_band(cols, boxes, windows, resid, block_ids, bsz, edges, n_edges,
unc_cap)`` launches the kernel for tensors on a CUDA device and runs the
plain PyTorch version (``index.scan.seg_band``) for tensors on the CPU.
There is no fallback: a CUDA tensor either launches the kernel or raises.
``seg_band.launches`` counts the calls that launched the kernel (and
nothing else), so a run can show its main path went through it. A call is
one launch; it allocates only the returned vector: the kernel's chunk
ticket, totals and per-chunk status words live in the stream's look-back
workspace (``kernels.lookback``), which the kernel leaves ready for the
next call.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Mapping, Optional

import torch

from geomesa_tpu_torch.index import scan
from geomesa_tpu_torch.kernels import build, lookback

NAME = "seg_band"
SOURCE = "geomesa_tpu_torch/kernels/csrc/seg_band.cu"
REPLACES = "geomesa_tpu/index/scan.py:754"

_ENVELOPE = ("bxmin_i", "bxmin_l", "bymin_i", "bymin_l",
            "bxmax_i", "bxmax_l", "bymax_i", "bymax_l")
_SEGMENTS = ("sx1", "sy1", "sx2", "sy2")
_TIME = ("bin", "off")

# the C side's Args: 32 8-byte slots (pointers, 0 for none, and sizes), then
# the three f32 band constants and a pad
_ARGS = struct.Struct("=32q4f")

_FN = None
_CHUNK = 0


def _bind():
    """The launch function (and the kernel's chunk size), bound once."""
    global _FN, _CHUNK
    if _FN is None:
        lib = build.load(NAME)
        fn = lib.seg_band_launch
        fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.seg_band_chunk.restype = ctypes.c_int
        lib.seg_band_error_string.argtypes = [ctypes.c_int]
        lib.seg_band_error_string.restype = ctypes.c_char_p
        _CHUNK = int(lib.seg_band_chunk())
        _FN = fn
    return _FN


def _check(cols, boxes, windows, resid, block_ids, bsz, edges, n_edges,
           unc_cap):
    """Validate the inputs, one pass over each tensor; return (table rows,
    candidates, device, valid)."""
    n = int(next(iter(cols.values())).shape[0])
    rows = (n,)
    dev = cols["sx1"].device
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    for k in _ENVELOPE + (_TIME if windows is not None else ()):
        t = cols[k]
        if t.dtype is not i32 or t.shape != rows:
            raise TypeError(f"column {k} must be int32 with {n} rows")
        build.placed(t, dev)
    for k in _SEGMENTS:
        t = cols[k]
        if t.dtype is not f32 or t.shape != rows:
            raise TypeError(f"column {k} must be float32 with {n} rows")
        build.placed(t, dev)
    if boxes.dtype is not i32 or boxes.dim() != 2 or boxes.shape[1] != 8:
        raise TypeError("boxes must be a (B, 8) int32 tensor")
    if windows is not None and (windows.dtype is not i32
                                or windows.dim() != 2
                                or windows.shape[1] != 4):
        raise TypeError("windows must be a (T, 4) int32 tensor")
    if edges.dtype is not f32 or edges.dim() != 2 or edges.shape[1] != 4:
        raise TypeError("edges must be a (ne, 4) float32 tensor")
    if n_edges is not None and not 0 <= n_edges <= edges.shape[0]:
        raise ValueError(f"n_edges {n_edges} outside [0, {edges.shape[0]}]")
    if block_ids.dtype is not i32 or block_ids.dim() != 1:
        raise TypeError("block_ids must be a 1-D int32 tensor")
    if bsz is None or int(bsz) <= 0:
        raise ValueError("block ids need a positive block size bsz")
    if unc_cap < 0:
        raise ValueError("unc_cap must be >= 0")
    ncand = int(block_ids.shape[0]) * int(bsz)
    valid = cols.get("__valid__")
    if valid is not None and (valid.dtype is not b8 or valid.shape != rows):
        raise TypeError(f"__valid__ must be bool with {n} rows")
    if resid is not None and (resid.dtype is not b8
                              or resid.shape != (ncand,)):
        raise TypeError(f"resid must be a bool mask of the {ncand} "
                        "candidates")
    for t in (valid, resid, block_ids, windows, boxes, edges):
        if t is not None:
            build.placed(t, dev)
    return n, ncand, dev, valid


def seg_band(cols: Mapping[str, torch.Tensor], boxes: torch.Tensor,
             windows: Optional[torch.Tensor], resid: Optional[torch.Tensor],
             block_ids: torch.Tensor, bsz: int, edges: torch.Tensor,
             n_edges: Optional[int] = None,
             unc_cap: int = 4096) -> torch.Tensor:
    """int32 ``[certain hits, n_uncertain, uncertain rows × unc_cap]``,
    left on the device; see ``index.scan.seg_band`` for the semantics."""
    n, ncand, dev, valid = _check(cols, boxes, windows, resid, block_ids,
                                  bsz, edges, n_edges, unc_cap)
    if dev.type == "cpu":
        return scan.seg_band(cols, boxes, windows, resid, block_ids, bsz,
                             edges, n_edges, unc_cap)
    if dev.type != "cuda":
        raise ValueError(f"seg_band runs on cuda or cpu, not {dev}")
    edge_ptr = edges.data_ptr()
    if edge_ptr % 16:
        raise ValueError("edges must be 16-byte aligned (16-byte row copies)")
    fn = _bind()
    out = torch.empty(2 + unc_cap, dtype=torch.int32, device=dev)
    has_time = windows is not None
    with build.on_device(dev):
        stream = build.raw_stream(dev)
        ws, ws_chunks, epoch = lookback.workspace(dev, stream,
                                                  -(-ncand // _CHUNK))
        args = _ARGS.pack(
            *(cols[k].data_ptr() for k in _ENVELOPE),
            *((cols[k].data_ptr() for k in _TIME) if has_time else (0, 0)),
            0 if valid is None else valid.data_ptr(),
            0 if resid is None else resid.data_ptr(),
            block_ids.data_ptr(), int(block_ids.shape[0]), int(bsz), n,
            windows.data_ptr() if has_time else 0,
            int(windows.shape[0]) if has_time else 0,
            boxes.data_ptr(), int(boxes.shape[0]),
            *(cols[k].data_ptr() for k in _SEGMENTS),
            edge_ptr, edges.shape[0] if n_edges is None else int(n_edges),
            int(unc_cap), out.data_ptr(), ws.data_ptr(), ws_chunks, epoch,
            dev.index,
            scan.TOL_T, scan.TOL_D, scan.DY_BAND, 0.0)
        rc = fn(args, stream)
    if rc != 0:
        msg = build.load(NAME).seg_band_error_string(rc).decode()
        raise RuntimeError(f"seg_band launch failed: {msg} (cudaError {rc})")
    seg_band.launches += 1
    return out


seg_band.launches = 0
