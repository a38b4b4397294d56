"""Wrapper of the ``pip_join`` CUDA kernel (``csrc/pip_join.cu``).

``pip_join(px, py, mask, edges, n_edges, bboxes, center, assign)`` launches
the kernel for tensors on a CUDA device and runs the plain PyTorch version
(``parallel.join.contains_matrix``, or ``parallel.join.assign`` with
``assign=True``) for tensors on the CPU. There is no fallback: a CUDA
tensor either launches the kernel or raises. ``pip_join.launches`` counts
the calls that launched the kernel (and nothing else). A call is one
launch; it allocates only its output.
"""

from __future__ import annotations

import ctypes

import torch

from geomesa_tpu_torch.kernels import build

NAME = "pip_join"
SOURCE = "geomesa_tpu_torch/kernels/csrc/pip_join.cu"
REPLACES = "geomesa_tpu/parallel/join.py:86"   # and :72, :103

_FN = None


def _bind():
    global _FN
    if _FN is None:
        lib = build.load(NAME)
        p = ctypes.c_void_p
        fn = lib.pip_join_launch
        fn.argtypes = [p, p, p, ctypes.c_longlong, p, p, ctypes.c_int,
                       ctypes.c_int, p, p, ctypes.c_int, p, ctypes.c_int, p]
        fn.restype = ctypes.c_int
        lib.pip_join_error_string.argtypes = [ctypes.c_int]
        lib.pip_join_error_string.restype = ctypes.c_char_p
        _FN = fn
    return _FN


def _check(px, py, mask, edges, n_edges, bboxes, center) -> torch.device:
    dev = px.device
    if px.dtype != torch.float32 or px.dim() != 1:
        raise TypeError("px must be a 1-D float32 tensor")
    if py.dtype != torch.float32 or py.shape != px.shape:
        raise TypeError("py must be float32 with px's shape")
    if mask is not None and (mask.dtype != torch.bool
                             or mask.shape != px.shape):
        raise TypeError("mask must be bool with px's shape")
    if edges.dtype != torch.float32 or edges.dim() != 3 \
            or edges.shape[2] != 4:
        raise TypeError("edges must be a (P, E, 4) float32 tensor")
    P, E = int(edges.shape[0]), int(edges.shape[1])
    if n_edges.dtype != torch.int32 or n_edges.shape != (P,):
        raise TypeError(f"n_edges must be int32 of shape ({P},)")
    if bboxes.dtype != torch.float32 or bboxes.shape != (P, 4):
        raise TypeError(f"bboxes must be float32 of shape ({P}, 4)")
    if center.dtype != torch.float32 or center.shape != (2,):
        raise TypeError("center must be a (2,) float32 tensor")
    for t in (px, py, mask, edges, n_edges, bboxes, center):
        if t is not None:
            build.placed(t, dev)
    if dev.type == "cuda":
        if edges.data_ptr() % 16 or bboxes.data_ptr() % 16:
            raise ValueError("edges and bboxes must be 16-byte aligned "
                             "(the kernel reads their rows as float4)")
        if bool(((n_edges < 0) | (n_edges > E)).any()):
            raise ValueError(f"n_edges outside [0, {E}]")
    return dev


def pip_join(px: torch.Tensor, py: torch.Tensor, mask, edges: torch.Tensor,
             n_edges: torch.Tensor, bboxes: torch.Tensor,
             center: torch.Tensor, assign: bool = False) -> torch.Tensor:
    """(P,) int32 hit counts, or with ``assign`` the (N,) int32 first
    matching polygon per point (-1 for none); see
    ``parallel.join.contains_matrix`` and ``parallel.join.assign``."""
    dev = _check(px, py, mask, edges, n_edges, bboxes, center)
    if dev.type == "cpu":
        from geomesa_tpu_torch.parallel import join
        fn = join.assign if assign else join.contains_matrix
        return fn(px, py, mask, edges, n_edges, bboxes, center)
    if dev.type != "cuda":
        raise ValueError(f"pip_join runs on cuda or cpu, not {dev}")
    P, E = int(edges.shape[0]), int(edges.shape[1])
    n = int(px.shape[0])
    if assign:
        out = torch.empty(n, dtype=torch.int32, device=dev)
    else:
        out = torch.zeros(P, dtype=torch.int32, device=dev)
    fn = _bind()
    with build.on_device(dev):
        rc = fn(px.data_ptr(), py.data_ptr(),
                0 if mask is None else mask.data_ptr(), n,
                edges.data_ptr(), n_edges.data_ptr(), P, E,
                bboxes.data_ptr(), center.data_ptr(), int(bool(assign)),
                out.data_ptr(), dev.index, build.raw_stream(dev))
    if rc != 0:
        msg = build.load(NAME).pip_join_error_string(rc).decode()
        raise RuntimeError(f"pip_join launch failed: {msg} (cudaError {rc})")
    pip_join.launches += 1
    return out


pip_join.launches = 0
