"""Wrapper of the ``topk_nearest`` CUDA kernel (``csrc/topk_nearest.cu``).

``topk_nearest(xf, yf, mask, qx, qy, m, starts=None, bsz=None)`` gives the
m candidates nearest (qx, qy) — f32 haversine metres, +inf where ``mask`` is
unset — ascending by (distance, candidate), as (distances f32, positions
int32), for tensors on a CUDA device, and runs the plain PyTorch version
(``index.scan.topk_nearest``) for tensors on the CPU. Without ``starts``
(FULL) candidate i is row i of ``xf``/``yf``; with the int64 block
``starts`` and ``bsz`` (BLOCKS) it is row ``starts[i // bsz] + i % bsz``,
and that row is its position. At most ``CLUSTER_MAX`` candidates of a
BLOCKS call and ``FULL_CLUSTER_MAX`` of a FULL call take the kernel's
one-cluster route (one launch), more its grid route (the keys pass, four
level passes and the cluster's finish, with a per-stream workspace
whose calls enqueue one at a time). There is no fallback: a CUDA tensor
either launches the kernel or raises. ``topk_nearest.launches`` counts
calls that launched the kernel (and nothing else), ``form_launches`` the
same by form and ``route_launches`` by route.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from geomesa_tpu_torch.index import scan
from geomesa_tpu_torch.kernels import build

NAME = "topk_nearest"
SOURCE = "geomesa_tpu_torch/kernels/csrc/topk_nearest.cu"
REPLACES = "geomesa_tpu/index/scan.py:809"
# the kernel's sort holds at most this many pairs (knn's largest margin)
MAX_M = 4096
# the one cluster's shape (csrc/topk_nearest.cu CLUSTER x CAPC): set
# candidates it lists, CAPC a CTA, and computes once; past that every pass
# computes their keys again
CLUSTER, CAPC = 16, 6144
# BLOCKS calls (a range cover, selective) of at most CLUSTER_MAX candidates
# take the one-cluster route (one launch, no workspace), FULL calls (any
# mask) only up to what the cluster lists whole, CLUSTER x CAPC; larger
# ones the grid route (its keys pass on every SM). The route cannot see
# the mask's density: the cluster wins on sparse masks and loses 2-5x on
# dense ones, so BLOCKS take it up to the cover measured sparse, cfg4's
# 1,048,576 candidates. PERF.md §6 has both routes' times on either side.
CLUSTER_MAX = 1 << 20
FULL_CLUSTER_MAX = CLUSTER * CAPC
# (device index, stream) -> the grid route's workspace (histogram, ticket,
# state, pairs, buffer), zero between calls: the kernels zero what they
# used. The stream's calls share it: the library enqueues each call's
# passes under a lock of the device, so that no other thread's call lands
# between them, and the stream runs them in that order.
_WS: Dict[Tuple[int, int], torch.Tensor] = {}
_WS_LOCK = threading.Lock()


def _bind(lib: ctypes.CDLL):
    fn = lib.topk_nearest_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, ctypes.c_longlong, ctypes.c_uint, f, f,
                       f, f, i, i, p, p, p, p, i, p]
        # (xf, yf, mask, starts, bsz, n, qx, qy, rad, two_r, m, route,
        #  keys, ws, dist, pos, device, stream)
        fn.restype = ctypes.c_int
        lib.topk_nearest_error_string.argtypes = [ctypes.c_int]
        lib.topk_nearest_error_string.restype = ctypes.c_char_p
        lib.topk_nearest_ws_bytes.argtypes = []
        lib.topk_nearest_ws_bytes.restype = ctypes.c_longlong
    return fn


def _workspace(lib: ctypes.CDLL, dev: torch.device, stream: int
               ) -> torch.Tensor:
    """The zeroed workspace of ``stream`` on ``dev``, made (zeroed once) on
    first use."""
    key = (dev.index, stream)
    with _WS_LOCK:
        t = _WS.get(key)
        if t is None:
            words = -(-int(lib.topk_nearest_ws_bytes()) // 8)
            t = _WS[key] = torch.zeros(words, dtype=torch.int64, device=dev)
        return t


def _check(xf, yf, mask, m, starts, bsz) -> int:
    """Validate the inputs; return the candidate count."""
    for name, t in (("xf", xf), ("yf", yf)):
        if t.dtype != torch.float32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D float32 tensor")
    if yf.shape != xf.shape:
        raise ValueError("xf and yf must have one length")
    tensors = [xf, yf, mask]
    n = xf.shape[0]
    if starts is not None:
        if starts.dtype != torch.int64 or starts.dim() != 1:
            raise TypeError("starts must be a 1-D int64 tensor")
        if bsz is None or int(bsz) <= 0:
            raise ValueError("starts need a positive block size bsz")
        n = starts.shape[0] * int(bsz)
        tensors.append(starts)
    if mask.dtype != torch.bool or mask.dim() != 1 or mask.shape[0] != n:
        raise ValueError(f"mask must be a 1-D bool tensor of the {n} "
                         "candidates")
    if n >= 1 << 31:
        raise ValueError(f"{n} candidates: at most 2^31 - 1")
    if not 1 <= int(m) <= n:
        raise ValueError(f"m = {m} must lie in [1, {n}] (the candidates)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("every input must be contiguous")
    if any(t.device != xf.device for t in tensors):
        raise ValueError("every input must lie on one device")
    return n


def topk_nearest(xf: torch.Tensor, yf: torch.Tensor, mask: torch.Tensor,
                 qx: float, qy: float, m: int,
                 starts: Optional[torch.Tensor] = None,
                 bsz: Optional[int] = None):
    """((m,) f32 distances, (m,) int32 positions), left on the device, of
    the m nearest candidates; see ``index.scan.topk_nearest``. ``qx`` and
    ``qy`` are rounded to f32, as the reference stages them. On the card
    the block starts are not range-checked: each ``starts[b] + bsz`` must
    stay within ``len(xf)``."""
    n = _check(xf, yf, mask, m, starts, bsz)
    qx, qy = float(np.float32(qx)), float(np.float32(qy))
    dev = xf.device
    if dev.type == "cpu":
        return scan.topk_nearest(xf, yf, mask, qx, qy, m, starts, bsz)
    if dev.type != "cuda":
        raise ValueError(f"topk_nearest runs on cuda or cpu, not {dev}")
    m = int(m)
    if m > MAX_M:
        raise ValueError(f"m = {m} exceeds the kernel's {MAX_M}")
    route = 0 if n <= (FULL_CLUSTER_MAX if starts is None
                       else CLUSTER_MAX) else 1
    dist = torch.empty(m, dtype=torch.float32, device=dev)
    pos = torch.empty(m, dtype=torch.int32, device=dev)
    lib = build.load(NAME)
    fn = _bind(lib)
    keys = ws = None
    with build.on_device(dev):
        stream = build.raw_stream(dev)
        if route:
            keys = torch.empty(n + 3, dtype=torch.int32, device=dev)
            ws = _workspace(lib, dev, stream)
        rc = fn(xf.data_ptr(), yf.data_ptr(), mask.data_ptr(),
                None if starts is None else starts.data_ptr(),
                int(bsz or 0), n, qx, qy, scan.HAVERSINE_RAD,
                scan.HAVERSINE_TWO_R, m, route,
                None if keys is None else keys.data_ptr(),
                None if ws is None else ws.data_ptr(), dist.data_ptr(),
                pos.data_ptr(), dev.index, stream)
    if rc != 0:
        if route:
            # a pass that did not run leaves the workspace unknown
            with _WS_LOCK:
                _WS.pop((dev.index, stream), None)
        msg = lib.topk_nearest_error_string(rc).decode()
        raise RuntimeError(f"topk_nearest launch failed: {msg} "
                           f"(cudaError {rc})")
    topk_nearest.launches += 1
    topk_nearest.form_launches["full" if starts is None else "blocks"] += 1
    topk_nearest.route_launches["grid" if route else "cluster"] += 1
    return dist, pos


topk_nearest.launches = 0
topk_nearest.form_launches = {"full": 0, "blocks": 0}
topk_nearest.route_launches = {"cluster": 0, "grid": 0}
