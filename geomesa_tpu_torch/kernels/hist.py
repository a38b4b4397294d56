"""Wrapper of the ``masked_hist`` CUDA kernel (``csrc/masked_hist.cu``).

``masked_hist(form, mask, *cols, lo=, hi=, bins=)`` counts the masked rows
by bin — ``form`` "hist" (an int32 or f32 column over [lo, hi]), "grid"
(xf, yf onto a g x g lon/lat grid, ``bins`` = g) or "bincount" (int32
dictionary codes, ``bins`` = the vocabulary size) — in one kernel launch
for tensors on a CUDA device, and runs the plain PyTorch version
(``aggregates.stats_scan.masked_hist``) for tensors on the CPU. There is no
fallback: a CUDA tensor either launches the kernel or raises.
``masked_hist.launches`` counts kernel launches (and nothing else), and
``masked_hist.form_launches`` the same by form, so a run can show its stats
scan went through the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from geomesa_tpu_torch.aggregates import stats_scan as _plain
from geomesa_tpu_torch.kernels import build

NAME = "masked_hist"
SOURCE = "geomesa_tpu_torch/kernels/csrc/masked_hist.cu"
REPLACES = "geomesa_tpu/aggregates/stats_scan.py:29"
FORMS = ("hist", "grid", "bincount")

_HIST_I32, _HIST_F32, _GRID, _BINCOUNT = 0, 1, 2, 3


def _bind(lib: ctypes.CDLL):
    fn = lib.masked_hist_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        f = ctypes.c_float
        fn.argtypes = [i, p, p, p, ctypes.c_longlong, f, f, f, f, i, i, p, i,
                       p]
        # (form, a, b, mask, n, lo, hi, inv_x, inv_y, bins, nbins, out,
        #  device, stream)
        fn.restype = ctypes.c_int
        lib.masked_hist_error_string.argtypes = [ctypes.c_int]
        lib.masked_hist_error_string.restype = ctypes.c_char_p
    return fn


def _check(form: str, mask: torch.Tensor, cols, bins: int) -> int:
    """Validate the inputs; return the kernel's form code."""
    if form not in FORMS:
        raise ValueError(f"masked_hist form {form!r}, not one of {FORMS}")
    want = 2 if form == "grid" else 1
    if len(cols) != want:
        raise ValueError(f"form {form!r} takes {want} column(s)")
    if mask.dtype != torch.bool or mask.dim() != 1:
        raise TypeError("mask must be a 1-D bool tensor")
    if not isinstance(bins, int) or bins < (0 if form == "bincount" else 1):
        raise ValueError(f"bad bins {bins!r}")
    if form == "grid" and bins * bins >= 1 << 31:
        raise ValueError(f"a {bins}x{bins} grid is too large")
    for c in cols:
        if c.dim() != 1 or c.shape[0] != mask.shape[0]:
            raise ValueError("every column must be 1-D with one value a "
                             "mask row")
        if not c.is_contiguous():
            raise ValueError("every input must be contiguous")
        if c.device != mask.device:
            raise ValueError("every input must lie on one device")
    if not mask.is_contiguous():
        raise ValueError("every input must be contiguous")
    if form == "hist":
        if cols[0].dtype == torch.int32:
            return _HIST_I32
        if cols[0].dtype == torch.float32:
            return _HIST_F32
        raise TypeError(f"a histogram column must be int32 or float32, "
                        f"got {cols[0].dtype}")
    if form == "grid":
        if any(c.dtype != torch.float32 for c in cols):
            raise TypeError("grid coordinates must be float32")
        return _GRID
    if cols[0].dtype != torch.int32:
        raise TypeError(f"codes must be int32, got {cols[0].dtype}")
    return _BINCOUNT


def masked_hist(form: str, mask: torch.Tensor, *cols: torch.Tensor,
                lo: float = 0.0, hi: float = 0.0,
                bins: int = 0) -> torch.Tensor:
    """int32 counts of the masked rows by bin, left on the device: (bins,)
    for "hist" and "bincount", (g, g) indexed [iy, ix] for "grid" (``bins``
    = g); see ``aggregates.stats_scan`` for each form's arithmetic. ``lo``
    and ``hi`` are rounded to f32, as the reference stages them."""
    code = _check(form, mask, cols, bins)
    lo, hi = float(np.float32(lo)), float(np.float32(hi))
    dev = mask.device
    if dev.type == "cpu":
        return _plain.masked_hist(form, mask, *cols, lo=lo, hi=hi, bins=bins)
    if dev.type != "cuda":
        raise ValueError(f"masked_hist runs on cuda or cpu, not {dev}")
    nbins = bins * bins if form == "grid" else bins
    out = torch.zeros(nbins, dtype=torch.int32, device=dev)
    shape = (bins, bins) if form == "grid" else (bins,)
    n = int(mask.shape[0])
    if n == 0 or nbins == 0:
        return out.reshape(shape)
    lib = build.load(NAME)
    fn = _bind(lib)
    with build.on_device(dev):
        rc = fn(code, cols[0].data_ptr(),
                cols[1].data_ptr() if form == "grid" else None,
                mask.data_ptr(), n, lo, hi, _plain.INV360, _plain.INV180,
                bins, nbins, out.data_ptr(), dev.index, build.raw_stream(dev))
    if rc != 0:
        msg = lib.masked_hist_error_string(rc).decode()
        raise RuntimeError(f"masked_hist launch failed: {msg} "
                           f"(cudaError {rc})")
    masked_hist.launches += 1
    masked_hist.form_launches[form] += 1
    return out.reshape(shape)


masked_hist.launches = 0
masked_hist.form_launches = {f: 0 for f in FORMS}
