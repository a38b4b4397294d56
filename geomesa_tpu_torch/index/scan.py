"""Device predicates of the point scan as torch functions.

≙ ``geomesa_tpu.index.scan``: the exact fp62 box mask, the exact binned-time
window mask, the residual-predicate compiler, the certainty-band
point-in-polygon classifier (``pip_band``) and the fused program's polygon
refine built on it (``pip_refine``, the plain version of the CUDA kernel in
``kernels/csrc/pip_refine.cu``). Every function takes tensors on whatever
device the caller's table lives on.

Exactness contract (as in the reference): box and time masks compare int32
planes and so reproduce the host's f64 predicates exactly; geometry uses f32
with a certainty band, and only the uncertain sliver refines on the host.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from geomesa_tpu_torch.filter import ir

# -- primary spatial/temporal masks -----------------------------------------


def _ge62(hi, lo, qhi, qlo):
    """Lexicographic fixed-point (hi, lo) >= (qhi, qlo)."""
    return (hi > qhi) | ((hi == qhi) & (lo >= qlo))


def _le62(hi, lo, qhi, qlo):
    return (hi < qhi) | ((hi == qhi) & (lo <= qlo))


def point_boxes(cols, boxes: torch.Tensor) -> torch.Tensor:
    """Any-box containment for point layers — EXACT (fp62 planes). boxes
    (B, 8) int32: [qxlo_hi, qxlo_lo, qxhi_hi, qxhi_lo, qylo_hi, qylo_lo,
    qyhi_hi, qyhi_lo]; empty boxes use qlo=max/qhi=0 so nothing matches."""
    xi, xl = cols["xi"][:, None], cols["xl"][:, None]
    yi, yl = cols["yi"][:, None], cols["yl"][:, None]
    b = boxes[None, :, :]
    return (
        _ge62(xi, xl, b[..., 0], b[..., 1]) & _le62(xi, xl, b[..., 2], b[..., 3])
        & _ge62(yi, yl, b[..., 4], b[..., 5]) & _le62(yi, yl, b[..., 6], b[..., 7])
    ).any(dim=1)


def _time_mask(cols, windows: torch.Tensor) -> torch.Tensor:
    """Any-window (bin, off) containment (≙ Z3Filter.timeInBounds, exact).
    windows (T, 4) int32 [bin_lo, off_lo, bin_hi, off_hi]; empty windows
    have bin_lo > bin_hi."""
    b = cols["bin"][:, None]
    o = cols["off"][:, None]
    blo, olo = windows[None, :, 0], windows[None, :, 1]
    bhi, ohi = windows[None, :, 2], windows[None, :, 3]
    after_lo = (b > blo) | ((b == blo) & (o >= olo))
    before_hi = (b < bhi) | ((b == bhi) & (o <= ohi))
    return (after_lo & before_hi & (blo <= bhi)).any(dim=1)


# -- certified f32 point-in-polygon ------------------------------------------
#
# Every orientation sign carries an error bound covering the f32 arithmetic
# and the f64→f32 input rounding, so each point classifies as certain-in /
# certain-out / uncertain; only the uncertain sliver goes to the host's f64
# refine. The constants and the order of every operation are the reference's
# (geomesa_tpu/index/scan.py _orient_band/_pip_band), which makes the flags
# bit-identical to it.

_F32_EPS = np.float32(1.2e-7)     # 2^-23 with margin
_IN_DELTA = np.float32(2.5e-5)    # |f64 coord - f32 coord| bound (lon/lat)
_DY_BAND = np.float32(3e-5)       # vertex y-tie band for the crossing rule
# the reference's 8 * _F32_EPS and 4 * _IN_DELTA, as f32 values (the CUDA
# kernel receives these same numbers)
TOL_T = float(8 * _F32_EPS)
TOL_D = float(4 * _IN_DELTA)
DY_BAND = float(_DY_BAND)

# polygon-edge pad: far-away horizontal edges (ey1 == ey2 → no crossing;
# orientation signs large and same → certain-miss), so padded rows never
# create hits or uncertainty
EDGE_PAD = np.array([1e9, 1e9, 2e9, 1e9], dtype=np.float32)

# (point, edge) pairs per chunk of the plain version: bounds its
# temporaries to a few hundred MB whatever the edge count
_PIP_CHUNK_PAIRS = 1 << 24


def _orient_band(px, py, qx, qy, rx, ry):
    """Signed area orientation of (p,q,r) with a conservative error bound."""
    d1x = qx - px
    d1y = qy - py
    d2x = rx - px
    d2y = ry - py
    t1 = d1x * d2y
    t2 = d1y * d2x
    det = t1 - t2
    tol = (TOL_T * (t1.abs() + t2.abs())
           + TOL_D * (d1x.abs() + d1y.abs() + d2x.abs() + d2y.abs()))
    return det, tol


def _pip_band_pairs(px, py, ex1, ey1, ex2, ey2):
    cond = (ey1 > py) != (ey2 > py)
    o, t = _orient_band(ex1, ey1, ex2, ey2, px, py)
    upward = ey2 > ey1
    cross = cond & torch.where(upward, o > t, o < -t)
    unc = (cond & (o.abs() <= t)) \
        | ((ey1 - py).abs() <= DY_BAND) | ((ey2 - py).abs() <= DY_BAND)
    inside = (cross.sum(dim=-1) % 2) == 1
    any_unc = unc.any(dim=-1)
    return inside & ~any_unc, ~inside & ~any_unc


def pip_band(px: torch.Tensor, py: torch.Tensor, edges: torch.Tensor):
    """(certainly-inside, certainly-outside) bool flags of f32 points
    ``px``/``py`` (n,) against an f32 edge table (ne, 4) = [x1, y1, x2, y2],
    by the half-open crossing rule: uncertain when any edge's crossing
    decision sits inside its error band or a vertex y ties the ray.

    Points run in chunks so the (point, edge) temporaries stay bounded;
    each point's flags depend on its own row only, so chunking changes
    nothing."""
    n, ne = px.shape[0], edges.shape[0]
    cin = torch.empty(n, dtype=torch.bool, device=px.device)
    cout = torch.empty(n, dtype=torch.bool, device=px.device)
    e = [edges[None, :, k] for k in range(4)]
    step = max(1, _PIP_CHUNK_PAIRS // max(1, ne))
    for a in range(0, n, step):
        b = min(n, a + step)
        cin[a:b], cout[a:b] = _pip_band_pairs(
            px[a:b, None], py[a:b, None], *e)
    return cin, cout


def pip_refine(xf: torch.Tensor, yf: torch.Tensor, edges: torch.Tensor,
               mask: Optional[torch.Tensor] = None,
               starts: Optional[torch.Tensor] = None,
               bsz: Optional[int] = None, n_edges: Optional[int] = None):
    """(hit, uncertain) bool flags of the fused program's candidate rows
    against a polygon edge table: ``mask & cin`` and ``mask & ~cin & ~cout``
    over ``pip_band``'s flags (≙ the reference's ``refine_of`` for its
    ``pip`` kind). Candidate i is row ``starts[i // bsz] + i % bsz`` of
    ``xf``/``yf`` when block starts are given, else row i; ``mask=None``
    makes every candidate live; ``n_edges`` keeps only the table's first
    rows (the rest ``EDGE_PAD`` filler, which changes no flag).

    The plain PyTorch version of the ``pip_refine`` CUDA kernel: gather,
    classify, mask. The CPU path, and the kernel's yardstick on the card."""
    if starts is not None:
        rows = (starts[:, None] + torch.arange(
            bsz, device=starts.device)[None, :]).reshape(-1)
        xf, yf = xf.index_select(0, rows), yf.index_select(0, rows)
    if n_edges is not None:
        edges = edges[:n_edges]
    cin, cout = pip_band(xf, yf, edges)
    unc = ~cin & ~cout
    if mask is None:
        return cin, unc
    return mask & cin, mask & unc


# -- residual predicate compiler --------------------------------------------


class Unsupported(Exception):
    """Raised when a predicate subtree can't run on device."""


# attr type names whose device columns are exact representations
_EXACT_DEVICE_TYPES = {"Int", "Integer", "Boolean", "String", "Float"}


def compile_residual(f: Optional[ir.Filter], sft,
                     string_vocabs: Dict[str, list],
                     available: Optional[set] = None):
    """IR → (structure_key, params, fn(cols, params) -> bool mask).

    The structure keys are the reference's (``scan.compile_residual`` and
    ``compiled._lower_residual``): ``=``/``<>``/``<``/``<=``/``>``/``>=``
    on Int/Float/Boolean columns, ``=``/``<>`` and ``IN`` on String
    dictionary codes, ``IN`` on Int, and AND/OR/NOT over them. ``params`` is
    a list of numpy constants (int32, or f32 for Float columns) that the
    caller moves to the table's device; ``fn`` reads them by position.
    Raises Unsupported for subtrees that must stay host-side, including
    predicates on attributes outside the device columns (``available``).
    """
    if f is None:
        return "none", [], None

    def check_available(attr: str) -> None:
        if available is not None and attr not in available:
            raise Unsupported(f"{attr} not in the device column group")

    params: list = []

    def const(v, dtype) -> int:
        params.append(np.asarray(v, dtype=dtype))
        return len(params) - 1

    def walk(node: ir.Filter) -> Tuple[str, Callable]:
        if isinstance(node, ir.Include):
            return "inc", lambda cols, p: torch.ones_like(
                next(iter(cols.values())), dtype=torch.bool)
        if isinstance(node, ir.Exclude):
            return "exc", lambda cols, p: torch.zeros_like(
                next(iter(cols.values())), dtype=torch.bool)
        if isinstance(node, ir.And):
            keys, fns = zip(*(walk(c) for c in node.children))
            return "and(" + ",".join(keys) + ")", \
                lambda cols, p, fns=fns: functools.reduce(
                    torch.logical_and, [g(cols, p) for g in fns])
        if isinstance(node, ir.Or):
            keys, fns = zip(*(walk(c) for c in node.children))
            return "or(" + ",".join(keys) + ")", \
                lambda cols, p, fns=fns: functools.reduce(
                    torch.logical_or, [g(cols, p) for g in fns])
        if isinstance(node, ir.Not):
            k, g = walk(node.child)
            return f"not({k})", lambda cols, p, g=g: ~g(cols, p)
        if isinstance(node, ir.Cmp):
            check_available(node.attr)
            attr = sft.attribute(node.attr)
            if attr.type_name == "String":
                if node.op not in ("=", "<>"):
                    raise Unsupported("ordered string cmp on device")
                vocab = string_vocabs.get(node.attr)
                if vocab is None:
                    raise Unsupported("no vocab")
                try:
                    code = vocab.index(node.value)
                except ValueError:
                    code = -1  # matches nothing
                i = const(code, np.int32)
                if node.op == "=":
                    return f"seq:{node.attr}", \
                        lambda cols, p, i=i, a=node.attr: cols[a] == p[i]
                return f"sne:{node.attr}", \
                    lambda cols, p, i=i, a=node.attr: cols[a] != p[i]
            if attr.type_name not in _EXACT_DEVICE_TYPES:
                raise Unsupported(f"{attr.type_name} cmp is inexact on device")
            dtype = np.float32 if attr.type_name == "Float" else np.int32
            i = const(node.value, dtype)
            op = node.op
            cmp = {"=": torch.eq, "<>": torch.ne, "<": torch.lt,
                   "<=": torch.le, ">": torch.gt, ">=": torch.ge}[op]
            return f"cmp{op}:{node.attr}", \
                lambda cols, p, i=i, a=node.attr, cmp=cmp: cmp(cols[a], p[i])
        if isinstance(node, ir.In):
            check_available(node.attr)
            attr = sft.attribute(node.attr)
            if attr.type_name == "String":
                vocab = string_vocabs.get(node.attr)
                if vocab is None:
                    raise Unsupported("no vocab")
                codes = [vocab.index(v) for v in node.values if v in vocab] or [-1]
            elif attr.type_name in ("Int", "Integer"):
                codes = [int(v) for v in node.values]
            else:
                raise Unsupported("IN on non-int/string")
            # pow2-padded like the reference, so the keys agree
            size = max(1, 1 << (len(codes) - 1).bit_length())
            padded = codes + [codes[-1]] * (size - len(codes))
            i = const(padded, np.int32)
            return f"in{size}:{node.attr}", \
                lambda cols, p, i=i, a=node.attr: torch.isin(cols[a], p[i])
        if isinstance(node, ir.During):
            # exact (bin, off) windows carry the primary dtg
            raise Unsupported("During handled by primary time windows")
        raise Unsupported(type(node).__name__)

    key, fn = walk(f)
    return key, params, fn


def split_residual(f: Optional[ir.Filter], sft, string_vocabs,
                   available: Optional[set] = None):
    """Split a residual filter into (device_part, host_part): AND trees split
    per child; any child the device compiler rejects stays on the host."""
    if f is None or isinstance(f, ir.Include):
        return None, None
    children = f.children if isinstance(f, ir.And) else (f,)
    dev, host = [], []
    for c in children:
        try:
            compile_residual(c, sft, string_vocabs, available)
            dev.append(c)
        except Unsupported:
            host.append(c)
    return (
        ir.and_filters(dev) if dev else None,
        ir.and_filters(host) if host else None,
    )


# -- padding helpers --------------------------------------------------------

_I31MAX = (1 << 31) - 1
# fp62 empty box: lo bound = +max, hi bound = 0 — matches nothing
EMPTY_BOX = np.array([_I31MAX, _I31MAX, 0, 0, _I31MAX, _I31MAX, 0, 0], dtype=np.int32)
EMPTY_WINDOW = np.array([1, 0, 0, 0], dtype=np.int32)    # bin_lo > bin_hi


def pad_boxes(boxes: np.ndarray, min_size: int = 1) -> np.ndarray:
    """Pad (B,8) int32 fp62 box array to the next power-of-two count."""
    b = max(min_size, len(boxes))
    size = 1 << (b - 1).bit_length()
    out = np.tile(EMPTY_BOX, (size, 1))
    if len(boxes):
        out[: len(boxes)] = boxes
    return out


def pad_windows(windows: np.ndarray, min_size: int = 1) -> np.ndarray:
    b = max(min_size, len(windows))
    size = 1 << (b - 1).bit_length()
    out = np.tile(EMPTY_WINDOW, (size, 1))
    if len(windows):
        out[: len(windows)] = windows
    return out
