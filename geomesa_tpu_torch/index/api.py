"""Plan and result datatypes (≙ ``geomesa_tpu.index.api``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from geomesa_tpu_torch.features.table import FeatureTable
from geomesa_tpu_torch.filter import ir


def not_ported(what: str, item: int) -> NotImplementedError:
    """The error every entry point raises for a shape outside the slice,
    naming the ROADMAP.md item that ports it (never a result computed by
    some other path)."""
    return NotImplementedError(
        f"{what} is not ported to geomesa_tpu_torch yet "
        f"(ROADMAP.md Queue 1, item {item})")


@dataclass
class IndexScanPlan:
    """One executable strategy: device primary params + residual split.

    ≙ QueryStrategy (api/GeoMesaFeatureIndex.getQueryStrategy:248): the
    index chosen, its primary key-space constraints (padded fp62 box /
    binned-time window arrays), and the filter remainder split between the
    device (compiled residual) and the host.
    """

    index: object
    primary_kind: str        # "point_boxes" | "bbox_overlap" | "none" | "fid"
    boxes_loose: Optional[np.ndarray] = None       # (B,8) int32 fp62 planes
    windows: Optional[np.ndarray] = None           # (T,4) int32 exact bin/off
    residual_device: Optional[tuple] = None        # (key, params, fn)
    residual_host: Optional[ir.Filter] = None      # host-refined remainder
    empty: bool = False                            # provably no results
    explain: Dict[str, object] = field(default_factory=dict)
    # range-pruning cache (planner._pruned_blocks): False = not yet computed,
    # None = pruning declined (full scan), ndarray = candidate block ids
    blocks: object = False
    # heuristic strategy cost (the index's ``_cost``; lower is better)
    cost: float = 0.0
    # the whole filter, where execution needs it (the feature-id plan)
    full_filter: Optional[ir.Filter] = None
    # attribute-index pruning: [lo, hi) slices (into the index's sorted
    # order) of the candidate rows; the device scan then reads only these
    # rows (≙ a key-range scan instead of a full-table scan)
    candidate_slices: Optional[List[Tuple[int, int]]] = None

    @property
    def device_exact(self) -> bool:
        """True when the plan resolves entirely on the device: a mask scan
        with no host refinement and no candidate slices (≙
        ``geomesa_tpu/index/api.py:44-52``)."""
        return (not self.empty and self.residual_host is None
                and self.candidate_slices is None
                and self.index is not None)

    @property
    def n_candidates(self) -> Optional[int]:
        if self.candidate_slices is None:
            return None
        return sum(h - l for l, h in self.candidate_slices)

    def candidate_positions(self) -> np.ndarray:
        """The candidate slices' positions, ascending (the reference's
        materialised form; the port's scans read the slices as runs)."""
        return np.concatenate(
            [np.arange(l, h, dtype=np.int64) for l, h in self.candidate_slices]
        ) if self.candidate_slices else np.empty(0, dtype=np.int64)


@dataclass
class UnionScanPlan:
    """OR → one plan a branch (≙ the reference's ``UnionScanPlan``, its
    FilterSplitter OR expansion): each branch plans on its own and the
    executor unions the row sets. When every branch is a device-exact mask
    on the same index, the union runs as one program whose branch masks OR
    on the device; otherwise the row sets union on the host."""

    branches: List[tuple]            # [(child_filter, IndexScanPlan), ...]
    full_filter: Optional[ir.Filter] = None
    cost: float = 0.0                # the branches' heuristic costs summed
    empty: bool = False
    explain: Dict[str, object] = field(default_factory=dict)

    # duck-typed surface shared with IndexScanPlan consumers
    primary_kind: str = "union"
    candidate_slices = None
    residual_host = None
    index = None
    blocks: object = None
    boxes_loose = None
    windows = None

    @property
    def device_exact(self) -> bool:
        return False   # prepared and count fast paths run per branch

    def same_index_device_exact(self):
        """The shared index when every branch is a device-exact mask scan
        on one index, else None."""
        idxs = {id(p.index) for _, p in self.branches}
        if len(idxs) != 1:
            return None
        if not all(p.device_exact for _, p in self.branches):
            return None
        return self.branches[0][1].index


@dataclass
class QueryResult:
    """Materialized query output: ascending row indices into the loaded
    table and the hydrated rows."""

    indices: np.ndarray
    table: FeatureTable
    plan: Optional[IndexScanPlan] = None

    @property
    def count(self) -> int:
        return len(self.indices)
