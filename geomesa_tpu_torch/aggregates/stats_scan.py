"""Device-side stat reductions (≙ ``geomesa_tpu.aggregates.stats_scan``,
the StatsScan kernel path).

≙ reference `StatsScan` (index/iterators/StatsScan.scala): sketches computed
next to the data. The scan mask stays on the device and each supported
sketch becomes one masked histogram over it — only the tiny reduced result
crosses to the host. Unsupported sketch kinds take select+observe (the
LocalQueryRunner path); the split is per leaf, so one spec string can mix
both.

Device-computable: Count, Histogram (numeric), Z2Histogram (point layers),
Enumeration (dictionary strings), GroupBy(string, Count()). MinMax keeps the
host path — its HLL cardinality needs 64-bit hashing.

The three histograms (``_masked_hist``, ``_masked_grid``,
``_masked_bincount``, the reference's jitted programs of the same names)
are the plain PyTorch versions of the ``masked_hist`` CUDA kernel
(``kernels/csrc/masked_hist.cu``, wrapper ``kernels/hist.py``), which runs
them on the card: one form a histogram, the bin of each masked row computed
as the reference's XLA program computes it on the CPU —

- HIST: ``clip(int32((f32(col) - lo) / (hi - lo) * bins), 0, bins - 1)``, a
  true division;
- GRID: ``clip(int32((x + 180) * f32(1/360) * g), 0, g - 1)`` and the same
  for y with 90 and f32(1/180): inside its jitted program XLA turns the
  division by the constant into a multiplication by its f32 reciprocal
  (rows on cell edges land as that gives them; the host sketch's f64
  binning, ``sketches.Z2HistogramStat.observe``, can differ there);
- BINCOUNT: codes below 0 count at ``code + n``, codes still outside
  ``[0, n)`` are dropped (JAX's indexing, then its scatter's).

f32 → int32 saturates and maps NaN to 0 (XLA's convert), so after the clip
NaN and -inf land in bin 0 and +inf in the last. XLA on the CPU reads a
subnormal f32 as a zero of its sign and flushes a subnormal result to one
(``flush``): HIST takes that flush at its inputs and after each step, so a
range under 2^-126 divides by zero as the reference's does. GRID's sums
of coordinates and 180 or 90 are never subnormal. Counts are int32.
"""

from __future__ import annotations

import numpy as np
import torch

from geomesa_tpu_torch.arith import flush
from geomesa_tpu_torch.stats import sketches as sk

# the f32 reciprocals XLA multiplies by in place of the grid's divisions
INV360 = float(np.float32(1) / np.float32(360))
INV180 = float(np.float32(1) / np.float32(180))


def _bin_index(v: torch.Tensor, bins: int) -> torch.Tensor:
    """int64 bin of f32 values: truncation toward zero clipped to [0,
    bins - 1], NaN in bin 0 (XLA's saturating f32 → int32, then the
    clip)."""
    v = torch.nan_to_num(v, nan=0.0).clamp_(0.0, float(bins - 1))
    return v.to(torch.int64)


def _count(idx: torch.Tensor, mask: torch.Tensor, n: int) -> torch.Tensor:
    """int32 (n,) count of the masked rows at each index of ``idx`` (every
    index within [0, n))."""
    out = torch.zeros(n, dtype=torch.int32, device=idx.device)
    return out.index_add_(0, idx, mask.to(torch.int32))


def _masked_hist(col: torch.Tensor, mask: torch.Tensor, lo: float, hi: float,
                 bins: int) -> torch.Tensor:
    """int32 (bins,) histogram of the masked rows of an int32 or f32 column
    over [lo, hi] (f32 values), end bins taking what falls outside; every
    input and step flushed as XLA flushes them on the CPU (``flush``)."""
    lo_t = flush(torch.tensor(lo, dtype=torch.float32, device=col.device))
    hi_t = flush(torch.tensor(hi, dtype=torch.float32, device=col.device))
    frac = flush(flush(flush(col.to(torch.float32)) - lo_t)
                 / flush(hi_t - lo_t))
    return _count(_bin_index(flush(frac * float(bins)), bins), mask, bins)


def _masked_grid(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                 g: int) -> torch.Tensor:
    """int32 (g, g) lon/lat grid counts of the masked rows, [iy, ix]."""
    ix = _bin_index((x + 180.0) * INV360 * float(g), g)
    iy = _bin_index((y + 90.0) * INV180 * float(g), g)
    return _count(iy * g + ix, mask, g * g).reshape(g, g)


def _masked_bincount(codes: torch.Tensor, mask: torch.Tensor,
                     n: int) -> torch.Tensor:
    """int32 (n,) count of the masked rows at each dictionary code."""
    c = codes.to(torch.int64)
    c = torch.where(c < 0, c + n, c)
    keep = mask & (c >= 0) & (c < n)
    return _count(c.clamp(0, max(0, n - 1)), keep, max(n, 1))[:n]


def masked_hist(form: str, mask: torch.Tensor, *cols: torch.Tensor,
                lo: float = 0.0, hi: float = 0.0,
                bins: int = 0) -> torch.Tensor:
    """The plain version of every form of the ``masked_hist`` kernel:
    ``form`` "hist" (cols = (col,), ``lo``, ``hi``, ``bins``), "grid" (cols =
    (xf, yf), ``bins`` = g) or "bincount" (cols = (codes,), ``bins`` = the
    vocabulary size)."""
    if form == "hist":
        return _masked_hist(cols[0], mask, lo, hi, bins)
    if form == "grid":
        return _masked_grid(cols[0], cols[1], mask, bins)
    if form == "bincount":
        return _masked_bincount(cols[0], mask, bins)
    raise ValueError(f"masked_hist form {form!r}")


def _reduce(form: str, mask, *cols, **kw) -> np.ndarray:
    """One masked histogram through the kernel's wrapper, read back."""
    from geomesa_tpu_torch.kernels.hist import masked_hist as kernel
    return kernel(form, mask, *cols, **kw).cpu().numpy()


def observe_on_device(leaf: sk.Stat, index, mask) -> bool:
    """Try to fold the masked scan into ``leaf`` via a device reduction.
    Returns False when this sketch kind must take the host path."""
    cols = index.device.columns
    sft = index.sft

    if isinstance(leaf, sk.CountStat):
        leaf.observe(int(mask.sum()))
        return True

    if isinstance(leaf, sk.HistogramStat):
        attr = leaf.attr
        try:
            spec = sft.attribute(attr)
        except KeyError:
            return False
        if attr not in cols or spec.type_name not in ("Int", "Integer", "Float"):
            return False
        counts = _reduce("hist", mask, cols[attr],
                         lo=float(np.float32(leaf.lo)),
                         hi=float(np.float32(leaf.hi)), bins=leaf.bins)
        leaf.counts += counts.astype(np.int64)
        return True

    if isinstance(leaf, sk.Z2HistogramStat):
        if "xf" not in cols:
            return False
        grid = _reduce("grid", mask, cols["xf"], cols["yf"], bins=leaf.g)
        leaf.counts += grid.astype(np.int64)
        return True

    if isinstance(leaf, sk.EnumerationStat):
        vocab = index.vocabs.get(leaf.attr)
        if vocab is None or leaf.attr not in cols:
            return False
        counts = _reduce("bincount", mask, cols[leaf.attr], bins=len(vocab))
        for v, c in zip(vocab, counts):
            if c:
                leaf.counts[v] = leaf.counts.get(v, 0) + int(c)
        return True

    if isinstance(leaf, sk.GroupByStat) and leaf.sub_spec.strip() == "Count()":
        vocab = index.vocabs.get(leaf.attr)
        if vocab is None or leaf.attr not in cols:
            return False
        counts = _reduce("bincount", mask, cols[leaf.attr], bins=len(vocab))
        for v, c in zip(vocab, counts):
            if c:
                sub = leaf.groups.setdefault(v, sk.CountStat())
                sub.observe(int(c))
        return True

    return False


def run_stat(planner, spec: str, f=None, auths=None) -> sk.Stat:
    """Compute a stat spec over matching rows, device reductions first.

    The scan mask is evaluated once (auths fold into it as a visibility-code
    residual, ≙ VisibilityFilter riding the server scan); device-supported
    leaves reduce against it, the rest share one select+observe pass (≙ the
    coprocessor running some aggregations region-side while the client
    computes the rest)."""
    from geomesa_tpu_torch.filter import ir
    from geomesa_tpu_torch.filter.parser import parse_ecql
    from geomesa_tpu_torch.stats.dsl import observe_table, parse_stat

    stat = parse_stat(spec)
    if f is None:
        f = ir.Include()
    elif isinstance(f, str):
        f = parse_ecql(f)

    leaves = stat.stats if isinstance(stat, sk.SeqStat) else [stat]
    restricted = auths is not None and planner.table.visibility is not None
    include = isinstance(f, ir.Include) and not restricted
    plan, mask = planner.scan_mask(f, auths=auths)
    host_leaves = list(leaves)
    if mask is not None:
        # an OR's mask lies over its branches' shared index (the
        # reference reads ``plan.index``, None on a union plan, and raises)
        index = plan.index if plan.index is not None \
            else plan.same_index_device_exact()
        host_leaves = [l for l in leaves
                       if not observe_on_device(l, index, mask)]
    if host_leaves:
        # one shared pass for every host-path leaf; INCLUDE observes the
        # master table directly (no select, no copy)
        sub = planner.table if include else \
            planner.table.take(planner.select_indices(f, plan=plan,
                                                      auths=auths))
        for l in host_leaves:
            observe_table(l, sub)
    return stat
