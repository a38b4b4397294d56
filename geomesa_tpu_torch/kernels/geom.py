"""Wrappers of the geometry catalog's CUDA kernels (``csrc/geom_unary.cu``,
``csrc/geom_dist.cu``, ``csrc/geom_pred.cu``).

``geom_unary``, ``geom_dist`` and ``geom_pred`` take a packed batch
(``geom.catalog.pack_features``, and ``pack_literal`` for the literal) and
launch their kernel for tensors on a CUDA device, or run the plain PyTorch
version (``geom.catalog._unary_plain``, ``_dist_plain``, ``_pred_plain``)
for tensors on the CPU. There is no fallback: a CUDA tensor either launches
the kernel or raises. Each function's ``launches`` counts its kernel
launches and nothing else.

A call takes all of its batch in one launch: each output row depends on
its own feature only, and the kernels build no (B, S, L) pair table (the
plain versions' pair tables are what ``GEOM_CHUNK`` bounds). The catalog
hands them a pack's first n rows (``FeaturePack.rows``), so a launch
spends nothing on the rows that pad the pack to a power of two.

The pair kernels (``csrc/geom_pair.cuh``) give each feature a group of
lanes and take the literal in one of two forms; ``plan`` picks both from
the batch's size, the pack's slot counts and the literal's length.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Tuple

import torch

from geomesa_tpu_torch.index import scan
from geomesa_tpu_torch.kernels import build

NAME_UNARY = "geom_unary"
NAME_DIST = "geom_dist"
NAME_PRED = "geom_pred"
NAMES = (NAME_UNARY, NAME_DIST, NAME_PRED)
SOURCES = {n: f"geomesa_tpu_torch/kernels/csrc/{n}.cu" for n in NAMES}
REPLACES = {NAME_UNARY: "geomesa_tpu/geom/catalog.py:252",
            NAME_DIST: "geomesa_tpu/geom/catalog.py:283",
            NAME_PRED: "geomesa_tpu/geom/catalog.py:351"}

_FNS = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ARGTYPES = {
    NAME_UNARY: [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _P, _I, _P],
    NAME_DIST: [ctypes.c_char_p, _P],
    NAME_PRED: [ctypes.c_char_p, _P],
}

# the pair kernels' PairArgs (csrc/geom_pair.cuh): 22 8-byte integer slots,
# then index/scan.py's band constants and catalog.MISS2 as doubles
_PAIR_ARGS = struct.Struct("=22q4d")
_CONSTS = None

# threads from which a batch keeps the card busy (chip_geom_plans.py: at
# 50,000 quads 2 lanes a feature beat 8): a batch with fewer features
# gives each feature more lanes
FILL = 1 << 16
# the literal's length (edges or points) from which a feature's lanes
# split the literal (LIT) when its own items cannot fill the card
LIT_FROM = 64


def plan(B: int, K: int, S: int, L: int, P: int) -> Tuple[bool, int]:
    """(lanes over the literal?, lanes a feature) of a pair kernel's launch
    for B features of K vertex and S segment slots against a literal of L
    edges and P points. A lane a feature where the batch fills the card
    (no lane idles on a feature's short item list); else the fewest lanes
    that fill it, at most one a slot; and a warp a feature with its lanes
    over a literal of LIT_FROM or more items when even a lane a slot leaves
    the card short (chip_geom_plans.py measures the choice)."""
    slots = 1
    while slots < max(K, S) and slots < 32:
        slots *= 2
    g = 1
    while g < slots and B * g < FILL:
        g *= 2
    if B * slots < FILL and max(L, P) >= LIT_FROM:
        return True, 32
    return False, g


def _bind(name: str):
    """The launch function of kernel ``name``, bound once."""
    fn = _FNS.get(name)
    if fn is None:
        lib = build.load(name)
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _FNS[name] = fn
    return fn


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        msg = getattr(build.load(name), f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {rc})")


def _expect(t: torch.Tensor, label: str, dtype, shape, dev) -> None:
    if (t.dtype is dtype and t.shape == shape and t.is_contiguous()
            and t.device == dev):
        return   # a call's every tensor: the checks below name the fault
    if t.dtype is not dtype:
        raise TypeError(f"{label} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{label} has shape {tuple(t.shape)}, not "
                         f"{tuple(shape)}")
    build.placed(t, dev)


def _check_pack(verts, vmask, segs, smask) -> Tuple[int, int, int]:
    """Validate a pack's vertex and segment tables; return (B, K, S)."""
    if verts.dim() != 3 or verts.shape[2] != 2:
        raise ValueError("verts must be (B, K, 2)")
    B, K = int(verts.shape[0]), int(verts.shape[1])
    if segs.dim() != 3 or segs.shape[2] != 4 or segs.shape[0] != B:
        raise ValueError("segs must be (B, S, 4)")
    S = int(segs.shape[1])
    dev = verts.device
    f32 = torch.float32
    _expect(verts, "verts", f32, (B, K, 2), dev)
    _expect(vmask, "vmask", torch.bool, (B, K), dev)
    _expect(segs, "segs", f32, (B, S, 4), dev)
    _expect(smask, "smask", torch.bool, (B, S), dev)
    if B >= 1 << 31:
        raise ValueError(f"{B} features: at most 2^31 - 1 a call")
    return B, K, S


def _check_literal(poly, ref32, lsegs, lpts, B: int) -> Tuple[int, int]:
    dev = poly.device
    _expect(poly, "poly", torch.bool, (B,), dev)
    _expect(ref32, "ref32", torch.float32, (B, 2), dev)
    if lsegs.dim() != 2 or lsegs.shape[1] != 4 or lsegs.shape[0] < 1:
        raise ValueError("lsegs must be (L, 4) with L >= 1")
    if lpts.dim() != 2 or lpts.shape[1] != 2 or lpts.shape[0] < 1:
        raise ValueError("lpts must be (P, 2) with P >= 1")
    _expect(lsegs, "lsegs", torch.float32, tuple(lsegs.shape), dev)
    _expect(lpts, "lpts", torch.float32, tuple(lpts.shape), dev)
    return int(lsegs.shape[0]), int(lpts.shape[0])


def _on_cuda(dev: torch.device, name: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def geom_unary(verts: torch.Tensor, vmask: torch.Tensor, segs: torch.Tensor,
               smask: torch.Tensor, wsign: torch.Tensor, mode: torch.Tensor):
    """(area, length, cx, cy), each (B,) f32, of a packed batch (local
    frame); see ``geom.catalog._unary_plain`` for the semantics."""
    B, K, S = _check_pack(verts, vmask, segs, smask)
    dev = verts.device
    _expect(wsign, "wsign", torch.float32, (B, S), dev)
    _expect(mode, "mode", torch.int32, (B,), dev)
    if dev.type == "cpu":
        from geomesa_tpu_torch.geom import catalog
        return catalog._unary_plain(verts, vmask, segs, smask, wsign, mode)
    _on_cuda(dev, NAME_UNARY)
    out = torch.empty((4, B), dtype=torch.float32, device=dev)
    fn = _bind(NAME_UNARY)
    with build.on_device(dev):
        rc = fn(_ptr(verts), _ptr(vmask), _ptr(segs), _ptr(smask),
                _ptr(wsign), _ptr(mode), B, K, S, _ptr(out), dev.index,
                build.raw_stream(dev))
    _raise_on(NAME_UNARY, rc)
    geom_unary.launches += 1
    return out[0], out[1], out[2], out[3]


def _pair_launch(name: str, verts, vmask, segs, smask, poly, ref32, lsegs,
                 lpts, B: int, K: int, S: int, L: int, P: int, op: int,
                 lit_poly: bool, lit_ext: bool, out: int, cin: int,
                 cout: int) -> None:
    """One launch of pair kernel ``name`` on ``verts``' device, planned by
    ``plan``; raises when it is refused."""
    global _CONSTS
    dev = verts.device
    if _CONSTS is None:
        # bound at the first launch: geom.catalog imports this module
        from geomesa_tpu_torch.geom import catalog
        _CONSTS = (scan.TOL_T, scan.TOL_D, scan.DY_BAND, catalog.MISS2)
    lit, g = plan(B, K, S, L, P)
    args = _PAIR_ARGS.pack(
        verts.data_ptr(), vmask.data_ptr(), segs.data_ptr(),
        smask.data_ptr(), poly.data_ptr(), ref32.data_ptr(),
        lsegs.data_ptr(), lpts.data_ptr(), B, K, S, L, P,
        g.bit_length() - 1, int(lit), op, int(bool(lit_poly)),
        int(bool(lit_ext)), out, cin, cout, dev.index, *_CONSTS)
    fn = _bind(name)
    with build.on_device(dev):
        rc = fn(args, build.raw_stream(dev))
    _raise_on(name, rc)


def geom_dist(verts, vmask, segs, smask, poly, ref32, lsegs, lpts,
              lit_poly: bool) -> torch.Tensor:
    """(B,) f32 distances of a packed batch to a packed literal; see
    ``geom.catalog._dist_plain``."""
    B, K, S = _check_pack(verts, vmask, segs, smask)
    L, P = _check_literal(poly, ref32, lsegs, lpts, B)
    dev = verts.device
    if dev.type == "cpu":
        from geomesa_tpu_torch.geom import catalog
        return catalog._dist_plain(verts, vmask, segs, smask, poly, ref32,
                                   lsegs, lpts, lit_poly)
    _on_cuda(dev, NAME_DIST)
    out = torch.empty(B, dtype=torch.float32, device=dev)
    _pair_launch(NAME_DIST, verts, vmask, segs, smask, poly, ref32, lsegs,
                 lpts, B, K, S, L, P, 0, lit_poly, False, out.data_ptr(), 0,
                 0)
    geom_dist.launches += 1
    return out


def geom_pred(verts, vmask, segs, smask, poly, ref32, lsegs, lpts, op: int,
              lit_poly: bool, lit_ext: bool):
    """(cin, cout), each (B,) bool, of a packed batch against a packed
    literal: op 0 intersects, 1 within, 2 contains; see
    ``geom.catalog._pred_plain``."""
    if op not in (0, 1, 2):
        raise ValueError(f"op must be 0, 1 or 2, not {op}")
    B, K, S = _check_pack(verts, vmask, segs, smask)
    L, P = _check_literal(poly, ref32, lsegs, lpts, B)
    dev = verts.device
    if dev.type == "cpu":
        from geomesa_tpu_torch.geom import catalog
        return catalog._pred_plain(verts, vmask, segs, smask, poly, ref32,
                                   lsegs, lpts, op, lit_poly, lit_ext)
    _on_cuda(dev, NAME_PRED)
    flags = torch.empty((2, B), dtype=torch.bool, device=dev)
    ptr = flags.data_ptr()
    _pair_launch(NAME_PRED, verts, vmask, segs, smask, poly, ref32, lsegs,
                 lpts, B, K, S, L, P, op, lit_poly, lit_ext, 0, ptr, ptr + B)
    geom_pred.launches += 1
    return flags.unbind(0)


geom_unary.launches = 0
geom_dist.launches = 0
geom_pred.launches = 0
