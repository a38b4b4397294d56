"""Wrapper of the ``fused_scan`` CUDA kernel (``csrc/fused_scan.cu``).

``fused_scan(cols, qbuf, query, ids, n_blocks, bsz, mode)``
launches the kernel for tensors on a CUDA device and runs the plain PyTorch
version (``index.scan.fused_scan``) for tensors on the CPU. There is no
fallback: a CUDA tensor either launches the kernel or raises.
``fused_scan.launches`` counts the calls that launched the kernel (and
nothing else). A call is one launch; it allocates only its outputs, and the
count's total and done counter live in the stream's workspace
(``kernels.lookback``). A select is this kernel's mask compacted by
``ordered_compact``. The fused program and the staged scan modes of a
point layer (``index.scan.ScanKernels``) both launch it; a query whose
branches have no boxes (``FusedQuery.points`` False) reads no point plane,
and a query under authorizations (``FusedQuery.vis``) reads the table's
``__vis__`` codes and tests them against its bitmap (the kernel's VIS
form; ``vis_launches`` counts those launches among ``launches``). The
attribute index's staged ``count_at`` and ``select_at`` pass ``runs``, the
member rows [lo, hi) of each slot (a piece of one of the plan's sorted
runs), and take the kernel's RUNS form; ``runs_launches`` counts those
launches among ``launches``. A query over an extent layer's envelopes
(``FusedQuery.env``, the staged modes of XZ2/XZ3 layers) reads the eight
fp62 envelope planes in place of the point planes and tests envelope
overlap (the kernel's ENV form); ``env_launches`` counts those launches
among ``launches``.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Mapping, Optional

import torch

from geomesa_tpu_torch.index import scan
from geomesa_tpu_torch.kernels import build, lookback

NAME = "fused_scan"
SOURCE = "geomesa_tpu_torch/kernels/csrc/fused_scan.cu"
REPLACES = "geomesa_tpu/index/compiled.py:476"
# the VIS form: the fused mask's visibility test
REPLACES_VIS = "geomesa_tpu/index/compiled.py:482"
# the RUNS form: the attribute index's staged count_at / select_at
REPLACES_RUNS = "geomesa_tpu/index/scan.py:603"
# the ENV form: the envelope primary _bbox_overlap_pairwise via _mask_kernel
REPLACES_ENV = "geomesa_tpu/index/scan.py:100"

MAX_SLOTS = 16
_MODES = {"count": 0, "mask": 1}
_KIND_DTYPES = {scan.SLOT_I32: torch.int32, scan.SLOT_F32: torch.float32,
                scan.SLOT_BOOL: torch.bool}
_POINT = ("xi", "xl", "yi", "yl")
# the ENV form's planes: the minima in the point planes' four slots, then
# the maxima
_ENV = ("bxmin_i", "bxmin_l", "bymin_i", "bymin_l",
        "bxmax_i", "bxmax_l", "bymax_i", "bymax_l")
_TIME = ("bin", "off")

# the C side's FusedScanArgs: 54 8-byte slots
_ARGS = struct.Struct("=54q")

_FN = None


def _bind():
    global _FN
    if _FN is None:
        lib = build.load(NAME)
        fn = lib.fused_scan_launch
        fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.fused_scan_error_string.argtypes = [ctypes.c_int]
        lib.fused_scan_error_string.restype = ctypes.c_char_p
        _FN = fn
    return _FN


def _check(cols, qbuf, query, ids, n_blocks, bsz, mode, runs=None) -> int:
    """Validate the inputs; return the table's rows."""
    if mode not in _MODES:
        raise ValueError(f"fused_scan mode {mode}")
    planes = _ENV if query.env else _POINT
    n = int(cols[planes[0]].shape[0])
    dev = cols[planes[0]].device
    for k in planes + (_TIME if query.has_time else ()):
        t = cols[k]
        if t.dtype is not torch.int32 or t.shape != (n,):
            raise TypeError(f"column {k} must be int32 with {n} rows")
        build.placed(t, dev)
    if len(query.slots) > MAX_SLOTS:
        raise ValueError(f"a query reads at most {MAX_SLOTS} residual "
                         "columns")
    for name, kind in query.slots:
        t = cols[name]
        if t.dtype is not _KIND_DTYPES[kind] or t.shape != (n,):
            raise TypeError(f"column {name} must be "
                            f"{_KIND_DTYPES[kind]} with {n} rows")
        build.placed(t, dev)
    valid = cols["__valid__"] if "__valid__" in cols else None
    if valid is not None:
        if valid.dtype is not torch.bool or valid.shape != (n,):
            raise TypeError(f"__valid__ must be bool with {n} rows")
        build.placed(valid, dev)
    if query.vis:
        vis = cols["__vis__"]
        if vis.dtype is not torch.int32 or vis.shape != (n,):
            raise TypeError(f"__vis__ must be int32 with {n} rows")
        build.placed(vis, dev)
    if qbuf.dtype is not torch.uint8 or qbuf.dim() != 1 or qbuf.shape[0] % 16:
        raise TypeError("qbuf must be a 1-D uint8 tensor of 16-byte words")
    if ids.dtype is not torch.int32 or ids.dim() != 1:
        raise TypeError("ids must be a 1-D int32 tensor")
    if n_blocks.dtype is not torch.int32 or n_blocks.shape != (1,):
        raise TypeError("n_blocks must be an int32 (1,) tensor")
    if bsz is None or int(bsz) <= 0:
        raise ValueError("the block list needs a positive block size bsz")
    for t in (qbuf, ids, n_blocks):
        build.placed(t, dev)
    if runs is not None:
        if runs.dtype is not torch.int32 or runs.shape != (ids.shape[0], 2):
            raise TypeError("runs must be int32 (slots, 2): [lo, hi) a slot")
        build.placed(runs, dev)
    return n


def fused_scan(cols: Mapping[str, torch.Tensor], qbuf: torch.Tensor,
               query: scan.FusedQuery, ids: torch.Tensor,
               n_blocks: torch.Tensor, bsz: int, mode: str,
               runs: Optional[torch.Tensor] = None):
    """The count (int32 (1,)) or (mask, count) of the candidates of the
    block list (with ``runs``: of its run pieces), left on the device; see
    ``index.scan.fused_scan`` for the semantics. On the card the mask's
    bytes past the first ``n_blocks`` blocks are not written."""
    n = _check(cols, qbuf, query, ids, n_blocks, bsz, mode, runs)
    dev = qbuf.device
    if dev.type == "cpu":
        return scan.fused_scan(cols, qbuf, query, ids, n_blocks, bsz, mode,
                               runs=runs)
    if dev.type != "cuda":
        raise ValueError(f"fused_scan runs on cuda or cpu, not {dev}")
    if qbuf.data_ptr() % 16:
        raise ValueError("qbuf must be 16-byte aligned")
    fn = _bind()
    slots, bsz = int(ids.shape[0]), int(bsz)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    mask = torch.empty(slots * bsz if mode == "mask" else 0,
                       dtype=torch.bool, device=dev)
    col = [cols[name].data_ptr() for name, _ in query.slots]
    kinds = 0
    for j, (_, kind) in enumerate(query.slots):
        kinds |= kind << (4 * j)
    valid = cols["__valid__"] if "__valid__" in cols else None
    off = query.offsets
    vis = (cols["__vis__"].data_ptr(), off["vis"][0], off["vis"][1] // 4) \
        if query.vis else (0, 0, 0)
    planes = [cols[k].data_ptr() for k in (_ENV if query.env else _POINT)]
    with build.on_device(dev):
        stream = build.raw_stream(dev)
        ws, _, epoch = lookback.workspace(dev, stream, 0)
        args = _ARGS.pack(
            *planes[:4],
            *((cols[k].data_ptr() for k in _TIME) if query.has_time
              else (0, 0)),
            0 if valid is None else valid.data_ptr(),
            *col, *([0] * (MAX_SLOTS - len(col))), kinds, len(col),
            qbuf.data_ptr(), qbuf.shape[0], off["br"][0], off["box"][0],
            off["wkey"][0], off["prog"][0], off["const"][0],
            len(query.branches), int(query.points), *vis,
            ids.data_ptr(), 0 if runs is None else runs.data_ptr(),
            n_blocks.data_ptr(), slots, bsz, n,
            _MODES[mode], out.data_ptr(), mask.data_ptr() if slots * bsz
            and mode == "mask" else 0, ws.data_ptr(), epoch, dev.index,
            *(planes[4:] if query.env else (0, 0, 0, 0)), int(query.env))
        rc = fn(args, stream)
    if rc != 0:
        msg = build.load(NAME).fused_scan_error_string(rc).decode()
        raise RuntimeError(f"fused_scan launch failed: {msg} (cudaError {rc})")
    fused_scan.launches += 1
    if query.vis:
        fused_scan.vis_launches += 1
    if runs is not None:
        fused_scan.runs_launches += 1
    if query.env and query.points:
        fused_scan.env_launches += 1
    return (mask, out) if mode == "mask" else out


fused_scan.launches = 0
fused_scan.vis_launches = 0
fused_scan.runs_launches = 0
fused_scan.env_launches = 0
