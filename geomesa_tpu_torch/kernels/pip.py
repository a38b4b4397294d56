"""Wrapper of the ``pip_refine`` CUDA kernel (``csrc/pip_refine.cu``).

``pip_refine(xf, yf, edges, mask, starts, bsz, n_edges, n_blocks)``
launches the
kernel for tensors on a CUDA device and runs the plain PyTorch version
(``index.scan.pip_refine``) for tensors on the CPU. There is no fallback: a
CUDA tensor either launches the kernel or raises. ``pip_refine.launches``
counts kernel launches (and nothing else), so a run can show its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from geomesa_tpu_torch.index import scan
from geomesa_tpu_torch.kernels import build

NAME = "pip_refine"
SOURCE = "geomesa_tpu_torch/kernels/csrc/pip_refine.cu"
REPLACES = "geomesa_tpu/index/compiled.py:351"


def _bind(lib: ctypes.CDLL):
    fn = lib.pip_refine_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, ctypes.c_longlong, p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
                       ctypes.c_float, p, p, p]
        fn.restype = ctypes.c_int
        lib.pip_refine_error_string.argtypes = [ctypes.c_int]
        lib.pip_refine_error_string.restype = ctypes.c_char_p
    return fn


def _check(xf, yf, edges, mask, starts, bsz, n_edges, n_blocks) -> int:
    """Validate the inputs; return the candidate count."""
    for name, t in (("xf", xf), ("yf", yf), ("edges", edges)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if xf.dim() != 1 or yf.shape != xf.shape:
        raise ValueError("xf and yf must be 1-D tensors of one length")
    if edges.dim() != 2 or edges.shape[1] != 4:
        raise ValueError(f"edges must be (ne, 4), got {tuple(edges.shape)}")
    if n_edges is not None and not 0 <= n_edges <= edges.shape[0]:
        raise ValueError(f"n_edges {n_edges} outside [0, {edges.shape[0]}]")
    n = xf.shape[0]
    tensors = [xf, yf, edges]
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


def pip_refine(xf: torch.Tensor, yf: torch.Tensor, edges: torch.Tensor,
               mask: Optional[torch.Tensor] = None,
               starts: Optional[torch.Tensor] = None,
               bsz: Optional[int] = None, n_edges: Optional[int] = None,
               n_blocks: Optional[torch.Tensor] = None):
    """(hit, uncertain) bool flags of the candidate rows against a polygon
    edge table; see ``index.scan.pip_refine`` for the semantics. On the
    card the block starts are not range-checked (that would cost a host
    sync): each ``starts[b] + bsz`` must stay within ``len(xf)``, as the
    fused program's clamped starts do; with ``n_blocks`` the flags past the
    first ``n_blocks`` blocks are not written."""
    n = _check(xf, yf, edges, mask, starts, bsz, n_edges, n_blocks)
    if xf.device.type == "cpu":
        return scan.pip_refine(xf, yf, edges, mask, starts, bsz, n_edges,
                               n_blocks)
    if xf.device.type != "cuda":
        raise ValueError(f"pip_refine runs on cuda or cpu, not {xf.device}")
    hit = torch.empty(n, dtype=torch.bool, device=xf.device)
    unc = torch.empty(n, dtype=torch.bool, device=xf.device)
    if n == 0:
        return hit, unc
    if edges.data_ptr() % 16:
        raise ValueError("edges must be 16-byte aligned (16-byte row copies)")
    ne = edges.shape[0] if n_edges is None else n_edges
    fn = _bind(build.load(NAME))
    with torch.cuda.device(xf.device):
        stream = torch.cuda.current_stream(xf.device).cuda_stream
        rc = fn(xf.data_ptr(), yf.data_ptr(),
                None if mask is None else mask.data_ptr(),
                None if starts is None else starts.data_ptr(),
                None if n_blocks is None else n_blocks.data_ptr(),
                int(bsz or 0), edges.data_ptr(), ne, n,
                scan.TOL_T, scan.TOL_D, scan.DY_BAND,
                hit.data_ptr(), unc.data_ptr(), stream)
    if rc != 0:
        msg = build.load(NAME).pip_refine_error_string(rc).decode()
        raise RuntimeError(f"pip_refine launch failed: {msg} (cudaError {rc})")
    pip_refine.launches += 1
    return hit, unc


pip_refine.launches = 0
