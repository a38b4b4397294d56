"""Result sampling.

Copied from ``geomesa_tpu.aggregates.sampling``
(host-only) with its imports pointed at this package.

≙ reference `SamplingIterator` (index/iterators/SamplingIterator.scala):
keep 1-in-n of the matching features, optionally per-thread-key (the
``by`` attribute groups so every track keeps points). Selection runs on
device; the thinning is a cheap host stride over the surviving row ids —
transfer and hydration shrink by the sample factor, which is the point.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from geomesa_tpu_torch.features.table import StringColumn


def sample_rows(planner, f, n: int, by: Optional[str] = None,
                plan=None, auths=None) -> np.ndarray:
    """Row indices of a 1-in-n sample of matches (per ``by``-group when set).
    Pass a precomputed plan to avoid re-planning; ``auths`` restricts to
    visible rows."""
    rows = planner.select_indices(f, plan=plan, auths=auths)
    if n <= 1:
        return rows
    if len(rows) == 0 or by is None:
        return rows[::n]
    col = planner.table.columns[by]
    keys = col.codes[rows] if isinstance(col, StringColumn) else np.asarray(col)[rows]
    # stable per-group stride: order by (group, position), take every n-th
    # within each group run
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    starts = np.r_[0, np.nonzero(np.diff(sorted_keys))[0] + 1]
    pos_in_group = np.arange(len(rows)) - np.repeat(
        starts, np.diff(np.r_[starts, len(rows)]))
    keep = order[pos_in_group % n == 0]
    return np.sort(rows[keep])
