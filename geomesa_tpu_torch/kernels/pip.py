"""Wrapper of the ``pip_band`` CUDA kernel (``csrc/pip_band.cu``).

``pip_flags(px, py, edges)`` launches the kernel for tensors on a CUDA
device and runs the plain PyTorch version (``index.scan.pip_band``) for
tensors on the CPU. There is no fallback: a CUDA tensor either launches
the kernel or raises. ``pip_flags.launches`` counts kernel launches (and
nothing else), so a run can show its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from geomesa_tpu_torch.index.scan import DY_BAND, TOL_D, TOL_T, pip_band
from geomesa_tpu_torch.kernels import build

NAME = "pip_band"
SOURCE = "geomesa_tpu_torch/kernels/csrc/pip_band.cu"
REPLACES = "geomesa_tpu/index/compiled.py:351"


def _bind(lib: ctypes.CDLL):
    fn = lib.pip_band_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                       ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.pip_band_error_string.argtypes = [ctypes.c_int]
        lib.pip_band_error_string.restype = ctypes.c_char_p
    return fn


def _check(px: torch.Tensor, py: torch.Tensor, edges: torch.Tensor) -> None:
    for name, t in (("px", px), ("py", py), ("edges", edges)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if px.dim() != 1 or py.shape != px.shape:
        raise ValueError("px and py must be 1-D tensors of one length")
    if edges.dim() != 2 or edges.shape[1] != 4:
        raise ValueError(f"edges must be (ne, 4), got {tuple(edges.shape)}")
    if not (px.device == py.device == edges.device):
        raise ValueError("px, py and edges must lie on one device")


def pip_flags(px: torch.Tensor, py: torch.Tensor, edges: torch.Tensor):
    """(certainly-inside, certainly-outside) bool flags of points vs a
    polygon edge table; see ``index.scan.pip_band`` for the semantics."""
    _check(px, py, edges)
    if px.device.type == "cpu":
        return pip_band(px, py, edges)
    if px.device.type != "cuda":
        raise ValueError(f"pip_flags runs on cuda or cpu, not {px.device}")
    n, ne = px.shape[0], edges.shape[0]
    cin = torch.empty(n, dtype=torch.bool, device=px.device)
    cout = torch.empty(n, dtype=torch.bool, device=px.device)
    if n == 0:
        return cin, cout
    if edges.data_ptr() % 16:
        raise ValueError("edges must be 16-byte aligned (float4 loads)")
    fn = _bind(build.load(NAME))
    with torch.cuda.device(px.device):
        stream = torch.cuda.current_stream(px.device).cuda_stream
        rc = fn(px.data_ptr(), py.data_ptr(), edges.data_ptr(), n, ne,
                TOL_T, TOL_D, DY_BAND, cin.data_ptr(), cout.data_ptr(),
                stream)
    if rc != 0:
        msg = build.load(NAME).pip_band_error_string(rc).decode()
        raise RuntimeError(f"pip_band launch failed: {msg} (cudaError {rc})")
    pip_flags.launches += 1
    return cin, cout


pip_flags.launches = 0
