"""Wrapper of the ``merge_scatter`` CUDA kernel (``csrc/merge_scatter.cu``).

``merge_scatter(olds, deltas, r)`` merges every resident column of
``olds`` with its sorted delta column of ``deltas`` at the delta ranks
``r`` in one kernel launch for tensors on a CUDA device, and runs the plain
PyTorch version (``index.device.merge_scatter``) for tensors on the CPU.
There is no fallback: a CUDA tensor either launches the kernel or raises.
``merge_scatter.launches`` counts kernel launches (and nothing else), so a
run can show its flush went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from geomesa_tpu_torch.index import device as _device
from geomesa_tpu_torch.kernels import build

NAME = "merge_scatter"
SOURCE = "geomesa_tpu_torch/kernels/csrc/merge_scatter.cu"
REPLACES = "geomesa_tpu/index/device.py:241"

# the reference ranks delta rows as int32 (its ``r32``): the merged table
# must stay under 2^31 rows
MAX_ROWS = (1 << 31) - 1
_ELEMENT_BYTES = (1, 2, 4, 8)


def _bind(lib: ctypes.CDLL):
    fn = lib.merge_scatter_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        ll = ctypes.c_longlong
        fn.argtypes = [p, ctypes.c_int, p, ll, ll, p]
        fn.restype = ctypes.c_int
        lib.merge_scatter_error_string.argtypes = [ctypes.c_int]
        lib.merge_scatter_error_string.restype = ctypes.c_char_p
        lib.merge_scatter_max_cols.argtypes = []
        lib.merge_scatter_max_cols.restype = ctypes.c_int
    return fn


def _check(olds: Sequence[torch.Tensor], deltas: Sequence[torch.Tensor],
           r: torch.Tensor):
    """Validate the inputs; return (n_old, n_delta, device)."""
    if not olds or len(olds) != len(deltas):
        raise ValueError("merge_scatter needs one delta column for each of "
                         "at least one resident column")
    if r.dtype != torch.int32 or r.dim() != 1:
        raise TypeError("r must be a 1-D int32 tensor")
    n_old, n_delta = int(olds[0].shape[0]), int(r.shape[0])
    if n_old + n_delta > MAX_ROWS:
        raise ValueError(f"a merged table of {n_old + n_delta} rows "
                         f"exceeds the int32 ranks' {MAX_ROWS}")
    for o, d in zip(olds, deltas):
        if o.dim() != 1 or o.shape[0] != n_old:
            raise ValueError(f"every resident column must be 1-D with "
                             f"{n_old} rows")
        if d.dim() != 1 or d.shape[0] != n_delta:
            raise ValueError(f"every delta column must be 1-D with "
                             f"{n_delta} rows")
        if d.dtype != o.dtype:
            raise TypeError(f"delta dtype {d.dtype} != resident {o.dtype}")
        if o.element_size() not in _ELEMENT_BYTES:
            raise TypeError(f"{o.dtype} columns do not merge: element bytes "
                            f"must be one of {_ELEMENT_BYTES}")
    tensors = [*olds, *deltas, r]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("every input must be contiguous")
    if any(t.device != r.device for t in tensors):
        raise ValueError("every input must lie on one device")
    if n_delta:
        # ranks outside [0, n_old] or out of order would write out of
        # bounds on the card: one host sync a merge checks them
        bad = (r[0] < 0) | (r[-1] > n_old)
        if n_delta > 1:
            bad = bad | (r[1:] < r[:-1]).any()
        if bool(bad):
            raise ValueError("r must be non-decreasing within [0, n_old]")
    return n_old, n_delta, r.device


def merge_scatter(olds: Sequence[torch.Tensor],
                  deltas: Sequence[torch.Tensor],
                  r: torch.Tensor) -> List[torch.Tensor]:
    """The merged columns, one (n_old + n_delta,) tensor a resident column:
    ``out[i + #{j : r[j] <= i}] = olds[c][i]``, ``out[r[j] + j] =
    deltas[c][j]``; see ``index.device.merge_scatter``."""
    n_old, n_delta, dev = _check(olds, deltas, r)
    if dev.type == "cpu":
        return _device.merge_scatter(olds, deltas, r)
    if dev.type != "cuda":
        raise ValueError(f"merge_scatter runs on cuda or cpu, not {dev}")
    outs = [torch.empty(n_old + n_delta, dtype=o.dtype, device=dev)
            for o in olds]
    lib = build.load(NAME)
    fn = _bind(lib)
    if len(olds) > lib.merge_scatter_max_cols():
        raise ValueError(f"{len(olds)} columns exceed the kernel's "
                         f"{lib.merge_scatter_max_cols()} a launch")
    if n_old + n_delta == 0:
        return outs
    desc = torch.tensor([[o.data_ptr(), d.data_ptr(), out.data_ptr(),
                          o.element_size()]
                         for o, d, out in zip(olds, deltas, outs)],
                        dtype=torch.int64).to(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(desc.data_ptr(), len(olds), r.data_ptr(), n_old, n_delta,
                stream)
    if rc != 0:
        msg = lib.merge_scatter_error_string(rc).decode()
        raise RuntimeError(f"merge_scatter launch failed: {msg} "
                           f"(cudaError {rc})")
    merge_scatter.launches += 1
    return outs


merge_scatter.launches = 0
