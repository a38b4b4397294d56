"""Wrapper of the ``ordered_compact`` CUDA kernel
(``csrc/ordered_compact.cu``).

``ordered_compact(mask, cap, fill, starts, bsz, n_blocks, count_out,
rows_out)`` launches the kernel for tensors on a CUDA device and runs the
plain PyTorch version (``index.scan.ordered_compact``) for tensors on the
CPU. There is no fallback: a CUDA tensor either launches the kernel or
raises. ``ordered_compact.launches`` counts the calls that launched the
kernel (and nothing else). A call is one launch; its look-back status words
(one a unit of ``UNIT`` candidates) and its full word live in the
stream's workspace (``kernels.lookback``). The count and the
rows go to fresh tensors, or into the caller's ``count_out`` / ``rows_out``
(views of one result vector, so a program's result needs no concatenation).
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional

import torch

from geomesa_tpu_torch.index import scan
from geomesa_tpu_torch.kernels import build, lookback

NAME = "ordered_compact"
SOURCE = "geomesa_tpu_torch/kernels/csrc/ordered_compact.cu"
REPLACES = "geomesa_tpu/index/compiled.py:555"

# the C side's OrderedCompactArgs: 14 8-byte slots
_ARGS = struct.Struct("=14q")

# candidates a unit: 256 threads x 2 vectors x 16 mask bytes (the kernel's
# look-back holds one status word a unit; csrc/ordered_compact.cu UNIT)
UNIT = 8192

_FN = None


def _bind():
    global _FN
    if _FN is None:
        lib = build.load(NAME)
        fn = lib.ordered_compact_launch
        fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ordered_compact_error_string.argtypes = [ctypes.c_int]
        lib.ordered_compact_error_string.restype = ctypes.c_char_p
        if lib.ordered_compact_unit() != UNIT:
            raise RuntimeError("ordered_compact's unit differs from "
                               "compact.UNIT")
        _FN = fn
    return _FN


def _out(t: Optional[torch.Tensor], length: int, name: str,
         dev: torch.device) -> torch.Tensor:
    if t is None:
        return torch.empty(length, dtype=torch.int32, device=dev)
    if t.dtype is not torch.int32 or t.shape != (length,):
        raise TypeError(f"{name} must be int32 ({length},)")
    build.placed(t, dev)
    return t


def _check(mask, cap, starts, bsz, n_blocks) -> int:
    """Validate the inputs; return the candidate count."""
    if mask.dtype is not torch.bool or mask.dim() != 1:
        raise TypeError("mask must be a 1-D bool tensor")
    dev = mask.device
    build.placed(mask, dev)
    if cap < 0:
        raise ValueError("cap must be >= 0")
    ncand = int(mask.shape[0])
    if starts is not None:
        if starts.dtype is not torch.int64 or starts.dim() != 1:
            raise TypeError("starts must be a 1-D int64 tensor")
        if bsz is None or int(bsz) <= 0:
            raise ValueError("starts need a positive block size bsz")
        if ncand != starts.shape[0] * int(bsz):
            raise ValueError(f"mask has {ncand} rows, not the "
                             f"{starts.shape[0] * int(bsz)} candidates")
        build.placed(starts, dev)
    if n_blocks is not None:
        if starts is None:
            raise ValueError("n_blocks limits a block list: give starts")
        if n_blocks.dtype is not torch.int32 or n_blocks.shape != (1,):
            raise TypeError("n_blocks must be an int32 (1,) tensor")
        build.placed(n_blocks, dev)
    if ncand >= 1 << 31:
        raise ValueError(f"{ncand} candidates: the int32 rows hold at most "
                         "2^31 - 1")
    return ncand


def ordered_compact(mask: torch.Tensor, cap: int, fill: int,
                    starts: Optional[torch.Tensor] = None,
                    bsz: Optional[int] = None,
                    n_blocks: Optional[torch.Tensor] = None,
                    count_out: Optional[torch.Tensor] = None,
                    rows_out: Optional[torch.Tensor] = None):
    """(count int32 (1,), rows int32 (cap,)), left on the device; see
    ``index.scan.ordered_compact`` for the semantics."""
    ncand = _check(mask, cap, starts, bsz, n_blocks)
    dev = mask.device
    count_out = _out(count_out, 1, "count_out", dev)
    rows_out = _out(rows_out, cap, "rows_out", dev)
    if dev.type == "cpu":
        c, r = scan.ordered_compact(mask, cap, fill, starts, bsz, n_blocks)
        count_out.copy_(c)
        rows_out.copy_(r)
        return count_out, rows_out
    if dev.type != "cuda":
        raise ValueError(f"ordered_compact runs on cuda or cpu, not {dev}")
    fn = _bind()
    slots = 1 if starts is None else int(starts.shape[0])
    with build.on_device(dev):
        stream = build.raw_stream(dev)
        ws, ws_units, epoch = lookback.workspace(dev, stream,
                                                 -(-ncand // UNIT))
        args = _ARGS.pack(
            mask.data_ptr(), ncand, 0 if starts is None else starts.data_ptr(),
            0 if n_blocks is None else n_blocks.data_ptr(), slots,
            0 if bsz is None else int(bsz), int(cap), int(fill),
            count_out.data_ptr(), rows_out.data_ptr() if cap else 0,
            ws.data_ptr(), ws_units, epoch, dev.index)
        rc = fn(args, stream)
    if rc != 0:
        msg = build.load(NAME).ordered_compact_error_string(rc).decode()
        raise RuntimeError(f"ordered_compact launch failed: {msg} "
                           f"(cudaError {rc})")
    ordered_compact.launches += 1
    return count_out, rows_out


ordered_compact.launches = 0
