"""Wrapper of the ``grid_scatter`` CUDA kernel (``csrc/grid_scatter.cu``).

``grid_scatter(xf, yf, mask, weight, starts, bsz, grid, width, height,
n_blocks)`` launches the kernel for tensors on a CUDA device and runs the
plain PyTorch version (``index.scan.grid_scatter``) for tensors on the
CPU. There is no fallback: a CUDA tensor either launches the kernel or
raises. ``grid_scatter.launches`` counts kernel launches (and nothing
else), so a run can show its main path went through the kernel. A call is one launch:
the kernel's accumulators live in a scratch kept per stream, which the
kernel leaves zeroed for the next call.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from geomesa_tpu_torch.index import scan
from geomesa_tpu_torch.kernels import build

NAME = "grid_scatter"
SOURCE = "geomesa_tpu_torch/kernels/csrc/grid_scatter.cu"
REPLACES = "geomesa_tpu/index/scan.py:391"

# rasters of at most this many cells take the shared-memory route (private
# uint32/f32 rasters in a CTA's shared memory, at most 96 KB); larger ones
# (the reference's default 256x256) add with global atomics
SHARED_CELLS = 24 * 1024

# (device index, stream) -> the kernel's scratch: two CTA counters, the live
# count and one accumulator a cell, zero between calls
# (the kernel zeroes them after use). Calls on one stream run in order, so
# they share it.
_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}
_SCRATCH_LOCK = threading.Lock()

_WEIGHT_KINDS = {torch.int32: 1, torch.float32: 2}


def _bind(lib: ctypes.CDLL):
    fn = lib.grid_scatter_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        ll = ctypes.c_longlong
        fn.argtypes = [p, p, p, i, p, p, p, ll, ll, p, i, i, i, p, p, p, p]
        # (xf, yf, weight, kind, mask, starts, nlive, bsz, n, bbox, width,
        #  height, shared, grid, count, scratch, stream)
        fn.restype = ctypes.c_int
        lib.grid_scatter_error_string.argtypes = [ctypes.c_int]
        lib.grid_scatter_error_string.restype = ctypes.c_char_p
    return fn


def _check(xf, yf, mask, weight, starts, bsz, grid, width, height,
           n_blocks) -> int:
    """Validate the inputs; return the candidate count."""
    for name, t in (("xf", xf), ("yf", yf), ("grid", grid)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if xf.dim() != 1 or yf.shape != xf.shape:
        raise ValueError("xf and yf must be 1-D tensors of one length")
    if grid.shape != (4,):
        raise ValueError(f"grid must be [xmin, ymin, xmax, ymax], got "
                         f"{tuple(grid.shape)}")
    if not (isinstance(width, int) and isinstance(height, int)
            and width >= 1 and height >= 1 and width * height < 1 << 31):
        raise ValueError(f"bad raster {width}x{height}")
    tensors = [xf, yf, grid, mask]
    if weight is not None:
        if weight.dtype not in _WEIGHT_KINDS:
            raise TypeError(f"weight must be int32 or float32, got "
                            f"{weight.dtype}")
        if weight.shape != xf.shape:
            raise ValueError("weight must have one value per table row")
        tensors.append(weight)
    n = xf.shape[0]
    if starts is not None:
        if starts.dtype != torch.int64 or starts.dim() != 1:
            raise TypeError("starts must be a 1-D int64 tensor")
        if bsz is None or bsz <= 0:
            raise ValueError("starts need a positive block size bsz")
        n = starts.shape[0] * int(bsz)
        tensors.append(starts)
    if n_blocks is not None:
        if starts is None:
            raise ValueError("n_blocks limits a block list: give starts")
        if n_blocks.dtype != torch.int32 or n_blocks.shape != (1,):
            raise TypeError("n_blocks must be an int32 (1,) tensor")
        tensors.append(n_blocks)
    if mask.dtype != torch.bool or mask.dim() != 1:
        raise TypeError("mask must be a 1-D bool tensor")
    if mask.shape[0] != n:
        raise ValueError(f"mask has {mask.shape[0]} rows, not the {n} "
                         "candidates")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("every input must be contiguous")
    if any(t.device != xf.device for t in tensors):
        raise ValueError("every input must lie on one device")
    return n


def _scratch(dev: torch.device, stream: int, cells: int) -> torch.Tensor:
    """The zeroed scratch of ``stream`` on ``dev``, 4 + ``cells`` words at
    least: made (zeroed once) on first use and when a larger raster needs
    more."""
    key = (dev.index, stream)
    with _SCRATCH_LOCK:
        t = _SCRATCH.get(key)
        if t is None or t.numel() < 4 + cells:
            t = torch.zeros(4 + max(cells, 64 * 64), dtype=torch.int32,
                            device=dev)
            _SCRATCH[key] = t
        return t


def grid_scatter(xf: torch.Tensor, yf: torch.Tensor, mask: torch.Tensor,
                 weight: Optional[torch.Tensor], starts: Optional[torch.Tensor],
                 bsz: Optional[int], grid: torch.Tensor, width: int,
                 height: int, n_blocks: Optional[torch.Tensor] = None):
    """((height, width) f32 raster, 0-d int32 count of masked candidates),
    both left on the device; see ``index.scan.grid_scatter`` for the
    semantics. Unit weights give the reference's grid byte for byte; f32
    weights agree with its sequential sum within the summation error bound.
    On the card the block starts are not range-checked (that would cost a
    host sync): each ``starts[b] + bsz`` must stay within ``len(xf)``;
    with ``n_blocks`` only the first ``n_blocks`` blocks' candidates
    count."""
    n = _check(xf, yf, mask, weight, starts, bsz, grid, width, height,
               n_blocks)
    if xf.device.type == "cpu":
        return scan.grid_scatter(xf, yf, mask, weight, starts, bsz, grid,
                                 width, height, n_blocks)
    if xf.device.type != "cuda":
        raise ValueError(f"grid_scatter runs on cuda or cpu, not {xf.device}")
    cells = width * height
    out = torch.empty((height, width), dtype=torch.float32, device=xf.device)
    count = torch.empty((), dtype=torch.int32, device=xf.device)
    if n == 0:
        return out.zero_(), count.zero_()
    fn = _bind(build.load(NAME))
    with torch.cuda.device(xf.device):
        stream = torch.cuda.current_stream(xf.device).cuda_stream
        scratch = _scratch(xf.device, stream, cells)
        rc = fn(xf.data_ptr(), yf.data_ptr(),
                None if weight is None else weight.data_ptr(),
                0 if weight is None else _WEIGHT_KINDS[weight.dtype],
                mask.data_ptr(),
                None if starts is None else starts.data_ptr(),
                None if n_blocks is None else n_blocks.data_ptr(),
                int(bsz or 0), n, grid.data_ptr(), width, height,
                int(cells <= SHARED_CELLS), out.data_ptr(),
                count.data_ptr(), scratch.data_ptr(), stream)
    if rc != 0:
        msg = build.load(NAME).grid_scatter_error_string(rc).decode()
        raise RuntimeError(f"grid_scatter launch failed: {msg} "
                           f"(cudaError {rc})")
    grid_scatter.launches += 1
    return out, count


grid_scatter.launches = 0
