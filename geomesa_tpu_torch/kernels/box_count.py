"""Wrapper of the ``box_count`` CUDA kernel (``csrc/box_count.cu``).

``box_count(cols, boxes, windows, resid, block_ids, bsz, per_box,
envelope)`` launches the kernel for tensors on a CUDA device and runs the plain PyTorch
version (``index.scan.box_count``) for tensors on the CPU. There is no
fallback: a CUDA tensor either launches the kernel or raises.
``box_count.launches`` counts the calls that launched the kernel (and
nothing else), so a run can show its main path went through it.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Optional

import torch

from geomesa_tpu_torch.index import scan
from geomesa_tpu_torch.kernels import build

NAME = "box_count"
SOURCE = "geomesa_tpu_torch/kernels/csrc/box_count.cu"
REPLACES = "geomesa_tpu/index/scan.py:620"

_PLANES = ("xi", "xl", "yi", "yl")
# an extent layer's envelope: the min planes take the point planes' slots,
# the max planes ride beside them
_ENV_MIN = ("bxmin_i", "bxmin_l", "bymin_i", "bymin_l")
_ENV_MAX = ("bxmax_i", "bxmax_l", "bymax_i", "bymax_l")
_TIME = ("bin", "off")


def _bind(lib: ctypes.CDLL):
    fn = lib.box_count_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        ll = ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, p, ll, ll, ll,
                       p, i, p, i, i, p, p]
        fn.restype = ctypes.c_int
        lib.box_count_error_string.argtypes = [ctypes.c_int]
        lib.box_count_error_string.restype = ctypes.c_char_p
    return fn


def _planes(envelope: bool):
    return _ENV_MIN + _ENV_MAX if envelope else _PLANES


def _check(cols, boxes, windows, resid, block_ids, bsz, per_box, envelope):
    """Validate the inputs; return (table rows, candidates, device)."""
    if not cols:
        raise ValueError("cols must hold the table's device columns")
    n = int(next(iter(cols.values())).shape[0])
    need = {}
    if boxes is not None:
        if boxes.dtype != torch.int32 or boxes.dim() != 2 \
                or boxes.shape[1] != 8:
            raise TypeError("boxes must be a (B, 8) int32 tensor")
        need.update((k, cols[k]) for k in _planes(envelope))
    elif per_box:
        raise ValueError("per_box counts need boxes")
    if windows is not None:
        if windows.dtype != torch.int32 or windows.dim() != 2 \
                or windows.shape[1] != 4:
            raise TypeError("windows must be a (T, 4) int32 tensor")
        need.update((k, cols[k]) for k in _TIME)
    for k, t in need.items():
        if t.dtype != torch.int32 or t.shape != (n,):
            raise TypeError(f"column {k} must be int32 with {n} rows")
    valid = cols["__valid__"] if "__valid__" in cols else None
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != (n,)):
        raise TypeError(f"__valid__ must be bool with {n} rows")
    ncand = n
    if block_ids is not None:
        if block_ids.dtype != torch.int32 or block_ids.dim() != 1:
            raise TypeError("block_ids must be a 1-D int32 tensor")
        if bsz is None or int(bsz) <= 0:
            raise ValueError("block ids need a positive block size bsz")
        ncand = int(block_ids.shape[0]) * int(bsz)
    if resid is not None and (resid.dtype != torch.bool
                              or resid.shape != (ncand,)):
        raise TypeError(f"resid must be a bool mask of the {ncand} "
                        "candidates")
    tensors = [t for t in (*need.values(), valid, resid, block_ids,
                           windows, boxes) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("every input must be contiguous")
    dev = next(iter(cols.values())).device
    if any(t.device != dev for t in tensors):
        raise ValueError("every input must lie on one device")
    return n, ncand, dev


def box_count(cols: Mapping[str, torch.Tensor], boxes: Optional[torch.Tensor],
              windows: Optional[torch.Tensor], resid: Optional[torch.Tensor],
              block_ids: Optional[torch.Tensor], bsz: Optional[int],
              per_box: bool, envelope: bool = False) -> torch.Tensor:
    """int32 counts of the candidates, left on the device: with
    ``per_box`` one per row of ``boxes`` (B,), else a 0-d count of the
    candidates inside any box (of every live candidate when ``boxes`` is
    None); ``envelope`` tests an extent layer's envelope overlap instead of
    point containment. See ``index.scan.box_count`` for the semantics."""
    n, ncand, dev = _check(cols, boxes, windows, resid, block_ids, bsz,
                           per_box, envelope)
    if dev.type == "cpu":
        return scan.box_count(cols, boxes, windows, resid, block_ids, bsz,
                              per_box, envelope)
    if dev.type != "cuda":
        raise ValueError(f"box_count runs on cuda or cpu, not {dev}")
    nbox = 0 if boxes is None else int(boxes.shape[0])
    # zeroed on the stream, before the launch that adds into it
    counts = torch.zeros(nbox if per_box else 1, dtype=torch.int32,
                         device=dev)
    out = counts if per_box else counts.reshape(())
    if ncand == 0 or (boxes is not None and nbox == 0) \
            or (windows is not None and windows.shape[0] == 0):
        return out   # no candidate, no box or no window to be inside
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    valid = cols["__valid__"] if "__valid__" in cols else None
    has_boxes = boxes is not None
    has_time = windows is not None
    fn = _bind(build.load(NAME))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(ptr(cols[k]) if has_boxes else None
                  for k in (_ENV_MIN if envelope else _PLANES)),
                *(ptr(cols[k]) if has_boxes and envelope else None
                  for k in _ENV_MAX),
                *(ptr(cols[k]) if has_time else None for k in _TIME),
                ptr(valid), ptr(resid), ptr(block_ids),
                0 if block_ids is None else int(block_ids.shape[0]),
                int(bsz or 0), n, ptr(windows),
                0 if windows is None else int(windows.shape[0]),
                ptr(boxes), nbox, int(bool(per_box)), counts.data_ptr(),
                stream)
    if rc != 0:
        msg = build.load(NAME).box_count_error_string(rc).decode()
        raise RuntimeError(f"box_count launch failed: {msg} (cudaError {rc})")
    box_count.launches += 1
    return out


box_count.launches = 0
