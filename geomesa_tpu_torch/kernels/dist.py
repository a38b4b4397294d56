"""Wrapper of the ``dist_refine`` CUDA kernel (``csrc/dist_refine.cu``).

``dist_refine(xf, yf, centre_r, mask, starts, bsz)`` launches the kernel
for tensors on a CUDA device and runs the plain PyTorch version
(``index.scan.dist_refine``) for tensors on the CPU. There is no fallback:
a CUDA tensor either launches the kernel or raises. ``dist_refine.launches``
counts kernel launches (and nothing else), so a run can show its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from geomesa_tpu_torch.index import scan
from geomesa_tpu_torch.kernels import build

NAME = "dist_refine"
SOURCE = "geomesa_tpu_torch/kernels/csrc/dist_refine.cu"
REPLACES = "geomesa_tpu/index/compiled.py:508"


def _bind(lib: ctypes.CDLL):
    fn = lib.dist_refine_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        f = ctypes.c_float
        fn.argtypes = [p, p, p, p, ctypes.c_longlong, ctypes.c_longlong,
                       f, f, f, f, p, p, p]
        fn.restype = ctypes.c_int
        lib.dist_refine_error_string.argtypes = [ctypes.c_int]
        lib.dist_refine_error_string.restype = ctypes.c_char_p
    return fn


def _check(xf, yf, mask, starts, bsz) -> int:
    """Validate the inputs; return the candidate count."""
    for name, t in (("xf", xf), ("yf", yf)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if xf.dim() != 1 or yf.shape != xf.shape:
        raise ValueError("xf and yf must be 1-D tensors of one length")
    n = xf.shape[0]
    tensors = [xf, yf]
    if starts is not None:
        if starts.dtype != torch.int64 or starts.dim() != 1:
            raise TypeError("starts must be a 1-D int64 tensor")
        if bsz is None or bsz <= 0:
            raise ValueError("starts need a positive block size bsz")
        n = starts.shape[0] * int(bsz)
        tensors.append(starts)
    if mask is not None:
        if mask.dtype != torch.bool or mask.dim() != 1:
            raise TypeError("mask must be a 1-D bool tensor")
        if mask.shape[0] != n:
            raise ValueError(f"mask has {mask.shape[0]} rows, not the "
                             f"{n} candidates")
        tensors.append(mask)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("every input must be contiguous")
    if any(t.device != xf.device for t in tensors):
        raise ValueError("every input must lie on one device")
    return n


def dist_refine(xf: torch.Tensor, yf: torch.Tensor, centre_r,
                mask: Optional[torch.Tensor] = None,
                starts: Optional[torch.Tensor] = None,
                bsz: Optional[int] = None):
    """(hit, uncertain) bool flags of the candidate rows against the circle
    ``centre_r`` = f32 [cx, cy, r] (host values); see
    ``index.scan.dist_refine`` for the semantics. On the card the block
    starts are not range-checked (that would cost a host sync): each
    ``starts[b] + bsz`` must stay within ``len(xf)``, as the fused
    program's clamped starts do."""
    n = _check(xf, yf, mask, starts, bsz)
    if xf.device.type == "cpu":
        return scan.dist_refine(xf, yf, centre_r, mask, starts, bsz)
    if xf.device.type != "cuda":
        raise ValueError(f"dist_refine runs on cuda or cpu, not {xf.device}")
    hit = torch.empty(n, dtype=torch.bool, device=xf.device)
    unc = torch.empty(n, dtype=torch.bool, device=xf.device)
    if n == 0:
        return hit, unc
    cx, cy, rlo, rhi = scan.dist_bounds(centre_r)
    fn = _bind(build.load(NAME))
    with torch.cuda.device(xf.device):
        stream = torch.cuda.current_stream(xf.device).cuda_stream
        rc = fn(xf.data_ptr(), yf.data_ptr(),
                None if mask is None else mask.data_ptr(),
                None if starts is None else starts.data_ptr(),
                int(bsz or 0), n, cx, cy, rlo, rhi,
                hit.data_ptr(), unc.data_ptr(), stream)
    if rc != 0:
        msg = build.load(NAME).dist_refine_error_string(rc).decode()
        raise RuntimeError(f"dist_refine launch failed: {msg} "
                           f"(cudaError {rc})")
    dist_refine.launches += 1
    return hit, unc


dist_refine.launches = 0
