"""f32 arithmetic as XLA does it on the CPU, and pow2 padding.

The plain versions that must answer bit for bit as the reference's jitted
programs (the geometry catalog, the point-in-polygon join, the stats scan)
compute with these: subnormal f32 inputs and results flushed to zeros of
their sign, division and square root correctly rounded (through f64: the
quotient and root round once to f32 on every backend), and a fused
multiply-add rounded once where XLA contracts ``a * b + c``. The CUDA
kernels do the same with PTX's ``.rn.ftz`` instructions
(``kernels/csrc/geom_common.cuh``).
"""

from __future__ import annotations

import torch

# the least normal f32
TINY = 2.0 ** -126


def pow2(n: int, lo: int = 1) -> int:
    """The least power of two that is at least ``n`` and ``lo``."""
    p, n = lo, int(n)
    while p < n:
        p <<= 1
    return p


def flush(t: torch.Tensor) -> torch.Tensor:
    """f32 values with every subnormal made a zero of its sign."""
    return torch.where(t.abs() < TINY, t * 0.0, t)


def add(a, b):
    return flush(a + b)


def sub(a, b):
    return flush(a - b)


def mul(a, b):
    return flush(a * b)


def div(a, b):
    b = b.double() if isinstance(b, torch.Tensor) else float(b)
    return flush((a.double() / b).float())


def sqrt(a):
    # PyTorch's f32 sqrt on the CPU is not correctly rounded
    return flush(torch.sqrt(a.double()).float())


def fma(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once (a fused multiply-add), flushed: the
    product is exact in f64 and the f64 sum rounds to odd (TwoSum's error
    picks the odd neighbour), so its rounding to f32 is the single
    rounding of the exact value."""
    p = a.double() * b.double()
    cd = c.double() if isinstance(c, torch.Tensor) else torch.tensor(
        float(c), dtype=torch.float64, device=p.device)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.copysign(torch.full_like(s, float("inf")), err)
    s = torch.where((err != 0) & even & torch.isfinite(s),
                    torch.nextafter(s, toward), s)
    return flush(s.float())
