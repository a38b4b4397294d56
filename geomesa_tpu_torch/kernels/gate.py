"""Wrapper of the ``block_gate`` CUDA kernel (``csrc/block_gate.cu``).

``block_gate(summ, qbuf, query, n, bsz)`` launches the kernel for tensors
on a CUDA device and runs the plain PyTorch version
(``index.scan.block_gate``) for tensors on the CPU. There is no fallback: a
CUDA tensor either launches the kernel or raises, and so does a cluster
that does not fit on the card. ``block_gate.launches`` counts the calls
that launched the kernel (and nothing else). A call is one launch of one
thread-block cluster of ``CLUSTER`` CTAs of ``THREADS`` threads, a shape
the kernel fixes.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from geomesa_tpu_torch.index import scan
from geomesa_tpu_torch.kernels import build

NAME = "block_gate"
SOURCE = "geomesa_tpu_torch/kernels/csrc/block_gate.cu"
REPLACES = "geomesa_tpu/index/compiled.py:463"

# the kernel's cluster shape, as csrc/block_gate.cu fixes it: CTAs of the
# cluster (a non-portable size) and threads a CTA
CLUSTER = 16
THREADS = 512

# the C side's BlockGateArgs: 19 8-byte slots
_ARGS = struct.Struct("=19q")
_SUMM = ("bxmin", "bxmax", "bymin", "bymax")

_FN = None


def _bind():
    global _FN
    if _FN is None:
        lib = build.load(NAME)
        fn = lib.block_gate_launch
        fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.block_gate_error_string.argtypes = [ctypes.c_int]
        lib.block_gate_error_string.restype = ctypes.c_char_p
        _FN = fn
    return _FN


def _check(summ: dict, qbuf: torch.Tensor, bsz: int) -> int:
    """Validate the inputs; return the block count."""
    nb = int(summ["bxmin"].shape[0])
    dev = summ["bxmin"].device
    for k in _SUMM:
        t = summ[k]
        if t.dtype is not torch.float32 or t.shape != (nb,):
            raise TypeError(f"summary {k} must be float32 with {nb} blocks")
        build.placed(t, dev)
    for k in ("binmin", "binmax"):
        if k in summ:
            t = summ[k]
            if t.dtype is not torch.int32 or t.shape != (nb,):
                raise TypeError(f"summary {k} must be int32 with {nb} blocks")
            build.placed(t, dev)
    if ("binmin" in summ) != ("binmax" in summ):
        raise TypeError("summaries need both binmin and binmax, or neither")
    if qbuf.dtype is not torch.uint8 or qbuf.dim() != 1 or qbuf.shape[0] % 16:
        raise TypeError("qbuf must be a 1-D uint8 tensor of 16-byte words")
    build.placed(qbuf, dev)
    if nb < 1 or bsz < 1:
        raise ValueError("the gate needs blocks and a positive block size")
    return nb


def block_gate(summ: dict, qbuf: torch.Tensor, query: scan.FusedQuery,
               n: int, bsz: int):
    """(ids int32 (nb,), starts int64 (nb,), n_blocks int32 (1,)), left on
    the device; see ``index.scan.block_gate`` for the semantics."""
    nb = _check(summ, qbuf, bsz)
    dev = qbuf.device
    if dev.type == "cpu":
        return scan.block_gate(summ, qbuf, query, n, bsz)
    if dev.type != "cuda":
        raise ValueError(f"block_gate runs on cuda or cpu, not {dev}")
    if qbuf.data_ptr() % 16:
        raise ValueError("qbuf must be 16-byte aligned")
    fn = _bind()
    ids = torch.empty(nb, dtype=torch.int32, device=dev)
    starts = torch.empty(nb, dtype=torch.int64, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    binned = "binmin" in summ
    off = query.offsets
    with build.on_device(dev):
        args = _ARGS.pack(
            *(summ[k].data_ptr() for k in _SUMM),
            summ["binmin"].data_ptr() if binned else 0,
            summ["binmax"].data_ptr() if binned else 0,
            qbuf.data_ptr(), qbuf.shape[0], off["br"][0], off["gate"][0],
            off["wbin"][0], len(query.branches), nb, int(bsz), int(n),
            ids.data_ptr(), starts.data_ptr(), count.data_ptr(), dev.index)
        rc = fn(args, build.raw_stream(dev))
    if rc != 0:
        msg = build.load(NAME).block_gate_error_string(rc).decode()
        raise RuntimeError(f"block_gate launch failed: {msg} (code {rc}; "
                           f"{CLUSTER} CTAs of {THREADS} threads, {nb} "
                           f"blocks)")
    block_gate.launches += 1
    return ids, starts, count


block_gate.launches = 0
