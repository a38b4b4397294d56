"""DeviceTable: the device-resident columnar projection the scans read.

≙ ``geomesa_tpu.index.device``: structure-of-arrays torch tensors in
index-sorted row order —

  - ``xi``/``xl``, ``yi``/``yl``  int32 fp62 planes (hi/lo 31 bits) of the
                   f64 coordinates: box predicates compare these exactly
  - ``xf``/``yf``  float32 coordinates (block summaries, polygon band)
  - ``bin``/``off`` int32 exact binned time of the primary dtg
  - attribute columns: Int/Boolean as is, Float as f32, strings as
                   dictionary codes

The planes are encoded on the host with the reference's numpy semantics
(the native C++ encoder is not ported yet), then moved to the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Union

import numpy as np
import torch

from geomesa_tpu_torch.curves.binnedtime import TimePeriod, time_to_binned_time
from geomesa_tpu_torch.features.table import FeatureTable, StringColumn


def resolve(device: Union[str, torch.device, None] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Asking for ``cuda`` on a machine without one raises; nothing
    falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run the plain versions")
    return dev


def fp62(x, lo: float, hi: float):
    """62-bit fixed-point normalization of a coordinate, split into two int32
    planes (hi = top 31 bits, lo = bottom 31); the reference's numpy path.

    The quantum is (hi-lo)/2^62 ≈ 8e-17 degrees for lon — finer than the f64
    ulp of any real coordinate — so lexicographic (hi, lo) comparison on the
    device reproduces the host's f64 predicate exactly up to ties at the f64
    rounding quantum.
    """
    x = np.asarray(x, dtype=np.float64)
    frac = np.clip((x - lo) / (hi - lo), 0.0, 1.0)
    # clamp in int64: float(2^62 - 1) rounds UP to 2^62, so a float-side min
    # would let the domain edge overflow the 31-bit hi plane
    v = np.minimum(np.floor(np.ldexp(frac, 62)).astype(np.int64), (1 << 62) - 1)
    return (v >> 31).astype(np.int32), (v & ((1 << 31) - 1)).astype(np.int32)


def fp62_lon(x):
    return fp62(x, -180.0, 180.0)


def fp62_lat(y):
    return fp62(y, -90.0, 90.0)


def host_planes(table: FeatureTable,
                period: Optional[TimePeriod] = None) -> Dict[str, np.ndarray]:
    """Unsorted numpy projection of a point ``table`` onto the device column
    layout (row order = table order; the index applies its sort on the
    device). Same planes, dtypes and values as the reference's
    ``host_planes`` for point layers."""
    cols: Dict[str, np.ndarray] = {}
    geom_attr = table.sft.geometry_attribute
    if geom_attr is not None:
        x, y = table.columns[geom_attr.name].point_xy()
        cols["xi"], cols["xl"] = fp62_lon(x)
        cols["yi"], cols["yl"] = fp62_lat(y)
        cols["xf"] = np.asarray(x, dtype=np.float32)
        cols["yf"] = np.asarray(y, dtype=np.float32)

    dtg_attr = table.sft.dtg_attribute
    if dtg_attr is not None and period is not None:
        ms = np.asarray(table.columns[dtg_attr.name], dtype=np.int64)
        bins, offs = time_to_binned_time(ms, period)
        cols["bin"] = np.asarray(bins, dtype=np.int32)
        cols["off"] = np.asarray(offs, dtype=np.int32)

    group = table.sft.device_column_group
    for attr in table.sft.attributes:
        if attr.is_geometry:
            continue
        if group is not None and attr.name not in group \
                and not (dtg_attr is not None and attr.name == dtg_attr.name):
            continue  # outside the device column group: host-only attribute
        raw = table.columns[attr.name]
        if isinstance(raw, StringColumn):
            cols[attr.name] = np.asarray(raw.codes, dtype=np.int32)
        elif attr.type_name == "Date":
            if dtg_attr is not None and attr.name == dtg_attr.name \
                    and period is not None:
                continue  # (bin, off) planes carry the primary dtg exactly
            # secondary dates: seconds resolution (advisory; host-refined)
            cols[attr.name] = (np.asarray(raw, dtype=np.int64) // 1000).astype(np.int32)
        elif attr.type_name == "Long":
            cols[attr.name] = np.asarray(raw).astype(np.float64).astype(np.float32)
        elif attr.type_name == "Double":
            cols[attr.name] = np.asarray(raw, dtype=np.float32)
        else:
            cols[attr.name] = np.asarray(raw)
    return cols


@dataclass
class DeviceTable:
    """Device-resident columns for one index, in index-sorted row order."""

    n: int
    columns: Dict[str, torch.Tensor] = field(default_factory=dict)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    @property
    def device(self) -> torch.device:
        return next(iter(self.columns.values())).device

    @classmethod
    def from_numpy(cls, cols: Dict[str, np.ndarray],
                   device: Union[str, torch.device, None] = None
                   ) -> "DeviceTable":
        """Carry already-sorted columns (e.g. the JAX package's device
        columns, read back as numpy) over as the port's table, unchanged in
        dtype and order — the state hand-over that lets both packages run
        over identical tables."""
        dev = resolve(device)
        out = {k: torch.from_numpy(np.array(v, copy=True)).to(dev)
               for k, v in cols.items()}
        n = len(next(iter(cols.values()))) if cols else 0
        return cls(n, out)

    @classmethod
    def build_sorted(cls, planes: Dict[str, np.ndarray],
                     perm: torch.Tensor) -> "DeviceTable":
        """Upload unsorted host planes one at a time and gather each through
        the device permutation ``perm`` (the index's sort), so at most one
        unsorted plane is resident beside the sorted table."""
        cols = {}
        for k, v in planes.items():
            cols[k] = torch.from_numpy(np.ascontiguousarray(v)).to(
                perm.device).index_select(0, perm)
        return cls(int(perm.shape[0]), cols)
