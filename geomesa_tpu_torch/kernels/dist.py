"""Wrapper of the ``dist_refine`` CUDA kernel (``csrc/dist_refine.cu``).

``dist_refine(xf, yf, bounds, mask, starts, bsz, n_blocks)`` launches the
kernel
for tensors on a CUDA device and runs the plain PyTorch version
(``index.scan.dist_refine``) for tensors on the CPU. There is no fallback:
a CUDA tensor either launches the kernel or raises. ``dist_refine.launches``
counts kernel launches (and nothing else), so a run can show its main path
went through the kernel. The same launch also gives the flags' (hit,
uncertain) counts: the kernel adds them into a workspace kept per stream,
which it leaves zeroed for the next call.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from geomesa_tpu_torch.index import scan
from geomesa_tpu_torch.kernels import build

NAME = "dist_refine"
SOURCE = "geomesa_tpu_torch/kernels/csrc/dist_refine.cu"
REPLACES = "geomesa_tpu/index/compiled.py:508"

# (device index, stream) -> the kernel's count workspace: 2 int64 words
# (uncertain << 32 | hits, CTAs done), zero between calls
_WS: Dict[Tuple[int, int], torch.Tensor] = {}
_WS_LOCK = threading.Lock()

_FN = None


def _bind():
    """The launch function, bound once."""
    global _FN
    if _FN is None:
        lib = build.load(NAME)
        fn = lib.dist_refine_launch
        p = ctypes.c_void_p
        f = ctypes.c_float
        fn.argtypes = [p, p, p, p, p, ctypes.c_longlong, ctypes.c_longlong,
                       f, f, f, f, p, p, p, p, ctypes.c_int, p]
        fn.restype = ctypes.c_int
        lib.dist_refine_error_string.argtypes = [ctypes.c_int]
        lib.dist_refine_error_string.restype = ctypes.c_char_p
        _FN = fn
    return _FN


def _workspace(dev: torch.device, stream: int) -> int:
    key = (dev.index, stream)
    with _WS_LOCK:
        t = _WS.get(key)
        if t is None:
            t = _WS[key] = torch.zeros(2, dtype=torch.int64, device=dev)
        return t.data_ptr()


def _check(xf, yf, mask, starts, bsz, n_blocks) -> int:
    """Validate the inputs; return the candidate count."""
    f32 = torch.float32
    if xf.dtype is not f32:
        raise TypeError(f"xf must be float32, got {xf.dtype}")
    if yf.dtype is not f32:
        raise TypeError(f"yf must be float32, got {yf.dtype}")
    if xf.dim() != 1 or yf.shape != xf.shape:
        raise ValueError("xf and yf must be 1-D tensors of one length")
    dev = xf.device
    n = xf.shape[0]
    build.placed(xf, dev)
    build.placed(yf, dev)
    if starts is not None:
        if starts.dtype is not torch.int64 or starts.dim() != 1:
            raise TypeError("starts must be a 1-D int64 tensor")
        if bsz is None or bsz <= 0:
            raise ValueError("starts need a positive block size bsz")
        n = starts.shape[0] * int(bsz)
        build.placed(starts, dev)
    if n_blocks is not None:
        if starts is None:
            raise ValueError("n_blocks limits a block list: give starts")
        if n_blocks.dtype is not torch.int32 or n_blocks.shape != (1,):
            raise TypeError("n_blocks must be an int32 (1,) tensor")
        build.placed(n_blocks, dev)
    if n >= 1 << 31:
        raise ValueError(f"{n} candidates: the int32 counts hold at most "
                         "2^31 - 1")
    if mask is not None:
        if mask.dtype is not torch.bool or mask.dim() != 1:
            raise TypeError("mask must be a 1-D bool tensor")
        if mask.shape[0] != n:
            raise ValueError(f"mask has {mask.shape[0]} rows, not the "
                             f"{n} candidates")
        build.placed(mask, dev)
    return n


def dist_refine(xf: torch.Tensor, yf: torch.Tensor, bounds: scan.DistBounds,
                mask: Optional[torch.Tensor] = None,
                starts: Optional[torch.Tensor] = None,
                bsz: Optional[int] = None,
                n_blocks: Optional[torch.Tensor] = None):
    """(hit, uncertain) bool flags of the candidate rows against the circle
    of ``bounds`` (``scan.dist_bounds``, made once by the caller) and int32
    [hits, uncertain], the flags' sums, from the same launch; see
    ``index.scan.dist_refine`` for the semantics. On the
    card the block starts are not range-checked (that would cost a host
    sync): each ``starts[b] + bsz`` must stay within ``len(xf)``, as the
    fused program's clamped starts do; with ``n_blocks`` the flags past the
    first ``n_blocks`` blocks are not written."""
    n = _check(xf, yf, mask, starts, bsz, n_blocks)
    dev = xf.device
    if dev.type == "cpu":
        return scan.dist_refine(xf, yf, bounds, mask, starts, bsz, n_blocks)
    if dev.type != "cuda":
        raise ValueError(f"dist_refine runs on cuda or cpu, not {dev}")
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    unc = torch.empty(n, dtype=torch.bool, device=dev)
    cnt = torch.empty(2, dtype=torch.int32, device=dev)
    if n == 0:
        return hit, unc, cnt.zero_()
    cx, cy, rlo, rhi = bounds
    fn = _bind()
    with build.on_device(dev):
        stream = build.raw_stream(dev)
        rc = fn(xf.data_ptr(), yf.data_ptr(),
                None if mask is None else mask.data_ptr(),
                None if starts is None else starts.data_ptr(),
                None if n_blocks is None else n_blocks.data_ptr(),
                int(bsz or 0), n, cx, cy, rlo, rhi,
                hit.data_ptr(), unc.data_ptr(), cnt.data_ptr(),
                _workspace(dev, stream), dev.index, stream)
    if rc != 0:
        msg = build.load(NAME).dist_refine_error_string(rc).decode()
        raise RuntimeError(f"dist_refine launch failed: {msg} "
                           f"(cudaError {rc})")
    dist_refine.launches += 1
    return hit, unc, cnt


dist_refine.launches = 0
