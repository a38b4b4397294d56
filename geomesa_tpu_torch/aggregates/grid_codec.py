"""Device-side grid readback codecs (sparse, fp16 and u8 packing).

≙ ``geomesa_tpu.aggregates.grid_codec``, wire format word for word: the
pack runs on the device (torch ops after the scatter) and the host decodes,
so a render reads back one small vector instead of the raw f32 grid.

- ``sparse``: ``[nnz, count, mass_bits, peak_bits, cell ids × cap (padded
  with H*W), fp16 weight pairs]`` — 6 bytes per nonzero cell;
- ``fp16``: the header + the whole grid as fp16, two cells per word;
- ``u8``: the header + the whole grid as uint8, four cells per word (exact
  for integer counts up to 255: unit weights).

The header carries the device's f32 ``mass`` (the grid's sum) and ``peak``
(its largest cell); the decoder checks the decoded sum against the mass and
the peak against the encoding's range, and asks the caller to step down to
a wider encoding (ultimately the raw f32 grid) when they disagree. The
mass is a device reduction whose order is the card's, so past 2^24 of total
mass its last bits may differ from the reference's; the decoder only ever
reads it within ``MASS_RTOL``.

The pack functions return int32 tensors holding the uint32 words' bits;
``words`` reads them back as a numpy uint32 vector.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

HEADER = 4  # [nnz, count, mass_bits, maxcell_bits]

# decoded f64 sum vs device f32 mass: fp16 carries ~11 mantissa bits, so a
# sum of rounded cells stays within ~2^-10 relative of the true mass; beyond
# that something saturated (inf) or overflowed and the caller must re-fetch
MASS_RTOL = 2e-3

_U32 = 1 << 32


def _as_words(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → int32 tensor of the same 32 bits."""
    return torch.where(v >= 1 << 31, v - _U32, v).to(torch.int32)


def _fp16_pairs(w: torch.Tensor) -> torch.Tensor:
    """(M,) f32 → (ceil(M/2),) words of bit-packed fp16 pairs, the even
    cell in the low half."""
    h = w.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF
    if h.shape[0] % 2:
        h = torch.cat([h, h.new_zeros(1)])
    h = h.reshape(-1, 2)
    return _as_words(h[:, 0] | (h[:, 1] << 16))


def _f32_word(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).reshape(1).view(torch.int32)


def _header(flat: torch.Tensor, nnz: torch.Tensor,
            count: torch.Tensor) -> torch.Tensor:
    mass = flat.sum(dtype=torch.float32)
    # max cell rides along so narrow encodings can reject per-cell overflow
    # exactly — a clipped hotspot can be tiny relative to the global mass
    peak = flat.max().clamp_min(0.0)
    return torch.cat([
        _as_words(nnz.to(torch.int64).reshape(1)),
        _as_words(count.to(torch.int64).reshape(1)),
        _f32_word(mass), _f32_word(peak)])


def pack_sparse(grid: torch.Tensor, count: torch.Tensor,
                cap: int) -> torch.Tensor:
    """Nonzero cells of an (H, W) f32 grid, ascending cell ids padded with
    H*W, as one word vector."""
    flat = grid.reshape(-1)
    hw = flat.shape[0]
    nz = flat != 0
    idx = torch.nonzero(nz).flatten()[:cap]
    sel = torch.full((cap,), hw, dtype=torch.int64, device=flat.device)
    sel[: idx.shape[0]] = idx
    w = torch.zeros(cap, dtype=torch.float32, device=flat.device)
    w[: idx.shape[0]] = flat.index_select(0, idx)
    head = _header(flat, nz.sum(), count)
    return torch.cat([head, sel.to(torch.int32), _fp16_pairs(w)])


def pack_fp16(grid: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Whole (H, W) f32 grid as fp16, two cells per word."""
    flat = grid.reshape(-1)
    head = _header(flat, (flat != 0).sum(), count)
    return torch.cat([head, _fp16_pairs(flat)])


def pack_u8(grid: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Whole (H, W) grid as uint8 cells (rounded half to even, clipped to
    [0, 255]), four per word, the first cell in the low byte. Saturated or
    fractional cells distort the decoded sum, which the mass and peak guards
    catch."""
    flat = grid.reshape(-1)
    head = _header(flat, (flat != 0).sum(), count)
    q = torch.round(flat).clamp(0, 255).to(torch.int64)
    pad = (-q.shape[0]) % 4
    if pad:
        q = torch.cat([q, q.new_zeros(pad)])
    q = q.reshape(-1, 4)
    body = q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16) | (q[:, 3] << 24)
    return torch.cat([head, _as_words(body)])


def pack_fn(mode: str, cap: Optional[int]):
    """The pack of one ladder entry as fn(grid, count) (≙ the reference's
    ``pack_jit``; PyTorch runs eagerly, so there is nothing to compile or
    cache)."""
    if mode == "sparse":
        return lambda g, c: pack_sparse(g, c, cap)
    return {"fp16": pack_fp16, "u8": pack_u8}[mode]


def words(packed: torch.Tensor) -> np.ndarray:
    """A packed vector read back as the host's uint32 words."""
    return packed.cpu().numpy().view(np.uint32)


# -- host side (numpy, the reference's decode) --------------------------------


def _unpack_fp16_pairs(u: np.ndarray, m: int) -> np.ndarray:
    h = np.empty(u.size * 2, np.uint16)
    h[0::2] = (u & 0xFFFF).astype(np.uint16)
    h[1::2] = (u >> 16).astype(np.uint16)
    return h[:m].view(np.float16).astype(np.float32)


def _f32_bits(word) -> float:
    return float(np.array([word], dtype=np.uint32).view(np.float32)[0])


def decode(packed: np.ndarray, mode: str, cap: Optional[int],
           height: int, width: int
           ) -> Optional[Tuple[np.ndarray, int, float]]:
    """Packed uint32 vector → ((H, W) f32 grid, count, mass), or ``None``
    when the encoding can't represent the result faithfully (sparse cap
    overflow, u8/fp16 per-cell overflow, rounding drift past the mass
    guard) and the caller should step down the encoding ladder."""
    packed = np.asarray(packed, dtype=np.uint32)
    nnz = int(packed[0])
    count = int(packed[1])
    mass = _f32_bits(packed[2])
    peak = _f32_bits(packed[3])
    if mode == "u8" and peak > 255.0:
        return None  # a clipped hotspot may be tiny vs the global mass
    if mode == "fp16" and peak > 65504.0:
        return None  # fp16 saturates to inf
    grid = np.zeros((height, width), dtype=np.float32)
    hw = height * width
    if mode == "sparse":
        if nnz > cap:
            return None
        idx = packed[HEADER: HEADER + nnz].astype(np.int64)
        w = _unpack_fp16_pairs(packed[HEADER + cap:], cap)[:nnz]
        grid.reshape(-1)[idx] = w
    elif mode == "u8":
        body = packed[HEADER:]
        cells = np.empty(body.size * 4, np.uint8)
        cells[0::4] = body & 0xFF
        cells[1::4] = (body >> 8) & 0xFF
        cells[2::4] = (body >> 16) & 0xFF
        cells[3::4] = (body >> 24) & 0xFF
        grid = cells[:hw].astype(np.float32).reshape(height, width)
    else:
        grid = _unpack_fp16_pairs(packed[HEADER:], hw).reshape(height, width)
    got = float(grid.sum(dtype=np.float64))
    if not np.isfinite(got) or abs(got - mass) > MASS_RTOL * max(abs(mass), 1.0):
        return None
    return grid, count, mass


def choose(count_bound: int, height: int, width: int, mode: str = "auto",
           unit_weights: bool = False) -> list:
    """Encoding ladder (cheapest wire cost first) from a bound on the number
    of matched rows (nnz ≤ min(matches, cells)). Each entry is
    (mode, sparse_cap); the caller walks down the ladder when a decode
    reports it couldn't carry the result, ending at raw f32 readback.
    ``unit_weights`` admits the u8 encoding (exact only for integer counts
    ≤255/cell)."""
    if mode == "none":
        return []
    if mode not in ("auto", "sparse", "fp16", "u8"):
        mode = "auto"  # malformed knob values fall back (reference behavior)
    if mode == "u8" and not unit_weights:
        # u8 per-cell rounding of fractional weights can cancel in the mass
        # guard while individual cells are off by up to 0.5 — not faithful
        mode = "fp16"
    hw = height * width
    nnzb = max(1, min(int(count_bound), hw))
    cap = 1 << max(5, (nnzb - 1).bit_length())
    if mode != "auto":
        return [(mode, cap if mode == "sparse" else None)]
    ladder = [("sparse", cap), ("fp16", None)]
    if unit_weights:
        ladder.insert(0, ("u8", None))
    # an encoding that ships more bytes than the raw f32 grid (sparse cap at
    # high occupancy) is strictly worse than falling straight to raw
    ladder = [mc for mc in ladder
              if packed_bytes(mc[0], mc[1], height, width) < 4 * hw]
    ladder.sort(key=lambda mc: packed_bytes(mc[0], mc[1], height, width))
    return ladder


def packed_bytes(mode: str, cap: Optional[int], height: int, width: int) -> int:
    hw = height * width
    if mode == "sparse":
        return 4 * (HEADER + cap + (cap + 1) // 2)
    if mode == "u8":
        return 4 * (HEADER + (hw + 3) // 4)
    return 4 * (HEADER + (hw + 1) // 2)
