"""DeviceTable: the device-resident columnar projection the scans read.

≙ ``geomesa_tpu.index.device``: structure-of-arrays torch tensors in
index-sorted row order —

  - ``xi``/``xl``, ``yi``/``yl``  int32 fp62 planes (hi/lo 31 bits) of the
                   f64 coordinates: box predicates compare these exactly
  - ``xf``/``yf``  float32 coordinates (block summaries, polygon band)
  - ``bxmin``/``bymin``/``bxmax``/``bymax`` float32 envelopes of an extent
                   layer, with their fp62 planes ``*_i``/``*_l``; the
                   segment planes ``sx1``/``sy1``/``sx2``/``sy2`` (f32) join
                   lazily for single-segment line layers
  - ``bin``/``off`` int32 exact binned time of the primary dtg
  - attribute columns: Int/Boolean as is, Float as f32, strings as
                   dictionary codes

The planes are encoded on the host with the reference's semantics — a
point layer's by the native C++ encoder (``native``, the index's
``_build_native``), the rest in numpy, bulk fp62 planes natively — then
moved to the device. A
flush of the store's delta tier merges a sorted delta run into the resident
columns (``DeviceTable.merge_scatter``) through the ``merge_scatter`` CUDA
kernel (``kernels/merge.py``); ``merge_scatter`` below is its plain
version.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

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


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op off CUDA): the build
    stages' timers stop on it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fp62(x, lo: float, hi: float):
    """62-bit fixed-point normalization of a coordinate, split into two int32
    planes (hi = top 31 bits, lo = bottom 31); the reference's semantics.

    The quantum is (hi-lo)/2^62 ≈ 8e-17 degrees for lon — finer than the f64
    ulp of any real coordinate — so lexicographic (hi, lo) comparison on the
    device reproduces the host's f64 predicate exactly up to ties at the f64
    rounding quantum.

    A bulk encode (one dimension, at least 65,536 values) takes the native
    one-pass encoder (``native.fp62_planes``, bit-identical) unless
    ``GEOMESA_TPU_NO_NATIVE`` is set.
    """
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1 and len(x) >= 65536:
        from geomesa_tpu_torch import native
        planes = native.fp62_planes(x, float(lo), float(hi))
        if planes is not None:
            return planes
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
                period: Optional[TimePeriod] = None,
                skip_geom: bool = False,
                skip_dtg: bool = False) -> Dict[str, np.ndarray]:
    """Unsorted numpy projection of ``table`` onto the device column layout
    (row order = table order; the index applies its sort on the device).
    Same planes, dtypes and values as the reference's ``host_planes``: a
    point layer's fp62 and f32 coordinates, an extent layer's f32 envelope
    (``bxmin``/``bymin``/``bxmax``/``bymax``) and its fp62 planes
    (``*_i``/``*_l``, exact envelope-overlap tests), and the visibility
    codes ``__vis__`` of a labelled table. ``skip_geom`` /
    ``skip_dtg`` leave out the geometry / binned-time planes that the
    native encoder already made."""
    cols: Dict[str, np.ndarray] = {}
    geom_attr = None if skip_geom else table.sft.geometry_attribute
    if geom_attr is not None:
        garr = table.columns[geom_attr.name]
        if garr.is_points:
            x, y = garr.point_xy()
            cols["xi"], cols["xl"] = fp62_lon(x)
            cols["yi"], cols["yl"] = fp62_lat(y)
            cols["xf"] = np.asarray(x, dtype=np.float32)
            cols["yf"] = np.asarray(y, dtype=np.float32)
        else:
            bb = garr.bboxes()
            env = (("bxmin", fp62_lon), ("bymin", fp62_lat),
                   ("bxmax", fp62_lon), ("bymax", fp62_lat))
            for k, (name, _) in enumerate(env):
                cols[name] = np.asarray(bb[:, k], dtype=np.float32)
            for k, (name, enc) in enumerate(env):
                cols[name + "_i"], cols[name + "_l"] = enc(bb[:, k])

    dtg_attr = table.sft.dtg_attribute
    if dtg_attr is not None and period is not None and not skip_dtg:
        ms = np.asarray(table.columns[dtg_attr.name], dtype=np.int64)
        bins, offs = time_to_binned_time(ms, period)
        cols["bin"] = np.asarray(bins, dtype=np.int32)
        cols["off"] = np.asarray(offs, dtype=np.int32)

    if table.visibility is not None:
        # dictionary codes; query-time auths shrink to an allowed-code set
        cols["__vis__"] = np.asarray(table.visibility.codes, dtype=np.int32)

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
                     perm: torch.Tensor,
                     stages: Dict[str, float],
                     cols: Optional[Dict[str, torch.Tensor]] = None
                     ) -> "DeviceTable":
        """Upload unsorted host planes one at a time and gather each through
        the device permutation ``perm`` (the index's sort), so at most one
        unsorted plane is resident beside the sorted table; they join the
        already sorted ``cols`` when given. ``stages`` accumulates the
        synchronised seconds of the uploads (``upload_s``) and of the
        gathers (``gather_s``)."""
        cols = {} if cols is None else dict(cols)
        for k, v in planes.items():
            t0 = time.perf_counter()
            raw = torch.from_numpy(np.ascontiguousarray(v)).to(perm.device)
            sync(perm.device)
            t1 = time.perf_counter()
            cols[k] = raw.index_select(0, perm)
            sync(perm.device)
            stages["upload_s"] = stages.get("upload_s", 0.0) + t1 - t0
            stages["gather_s"] = stages.get("gather_s", 0.0) \
                + time.perf_counter() - t1
            del raw
        return cls(int(perm.shape[0]), cols)

    @classmethod
    def merge_scatter(cls, old: "DeviceTable",
                      delta_planes: Dict[str, np.ndarray],
                      r: np.ndarray, stale=(),
                      full_codes: Optional[Dict[str, np.ndarray]] = None,
                      perm_pair=None,
                      host_perm: Optional[np.ndarray] = None,
                      stages: Optional[Dict[str, float]] = None):
        """Incremental merge of ``old``'s sorted columns with a sorted delta
        run, the device half of the LSM merge build (≙
        ``geomesa_tpu/index/device.py:160-238``).

        ``r[j]`` = merged rank of sorted-delta row j among the resident rows
        (count of resident keys ≤ the delta key — residents win ties), host
        int, non-decreasing. Only delta-sized data crosses the host link:
        every column that is in both ``old`` and ``delta_planes`` and not
        ``stale`` merges in ONE launch of the ``merge_scatter`` kernel
        (``kernels/merge.py``; its plain version on the CPU), the
        permutation with them when ``perm_pair`` = (old device perm, delta
        perm values) is given — the port's permutation is int64, so it
        merges as an 8-byte column. ``stale`` columns (dictionary codes
        whose vocab changed under the union-vocab concat) rebuild from
        ``full_codes`` through one gather by ``host_perm`` or the merged
        device perm. ``stages`` receives the synchronised seconds of the
        upload (``upload_s``), the kernel (``kernel_s``) and the stale
        gathers (``stale_s``). Returns (DeviceTable, merged perm or None)."""
        from geomesa_tpu_torch.kernels import merge as _merge

        dev = old.device
        full_codes = full_codes or {}
        st = {} if stages is None else stages
        t0 = time.perf_counter()
        names = [k for k in old.columns
                 if k in delta_planes and k not in stale]
        olds = [old.columns[k] for k in names]
        deltas = [torch.from_numpy(np.ascontiguousarray(
            np.asarray(delta_planes[k], dtype=_np_dtype(old.columns[k]))))
            .to(dev) for k in names]
        if perm_pair is not None:
            olds.append(perm_pair[0])
            deltas.append(torch.from_numpy(np.ascontiguousarray(
                np.asarray(perm_pair[1], dtype=_np_dtype(perm_pair[0]))))
                .to(dev))
        r32 = torch.from_numpy(np.asarray(r, dtype=np.int32)).to(dev)
        sync(dev)
        t1 = time.perf_counter()
        outs = _merge.merge_scatter(olds, deltas, r32)
        sync(dev)
        t2 = time.perf_counter()
        merged = dict(zip(names, outs))
        new_perm = outs[-1] if perm_pair is not None else None
        for name in stale:
            codes = np.asarray(full_codes[name], dtype=np.int32)
            if host_perm is not None:
                merged[name] = torch.from_numpy(codes[host_perm]).to(dev)
            else:
                merged[name] = torch.from_numpy(codes).to(dev).index_select(
                    0, new_perm)
        sync(dev)
        st["upload_s"] = t1 - t0
        st["kernel_s"] = t2 - t1
        st["stale_s"] = time.perf_counter() - t2
        # a stale column the old table lacked (its first visibility
        # labels) joins the merged table
        cols = {k: merged[k] for k in [*old.columns, *stale] if k in merged}
        return cls(old.n + len(r), cols), new_perm


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def merge_scatter(olds: Sequence[torch.Tensor],
                  deltas: Sequence[torch.Tensor],
                  r: torch.Tensor) -> List[torch.Tensor]:
    """Plain version of the ``merge_scatter`` kernel (the reference's
    ``_build_merge_scatter``, ``geomesa_tpu/index/device.py:241``): for
    every column pair, ``out[i + #{j : r[j] <= i}] = old[i]`` and
    ``out[r[j] + j] = delta[j]``, by ``torch.searchsorted`` and
    ``index_copy_``."""
    n_delta = int(r.shape[0])
    n_old = int(olds[0].shape[0]) if olds else 0
    dev = r.device
    shift = torch.searchsorted(
        r, torch.arange(n_old, dtype=r.dtype, device=dev), right=True)
    pos_res = torch.arange(n_old, dtype=torch.int64, device=dev) + shift
    pos_del = r.to(torch.int64) + torch.arange(n_delta, dtype=torch.int64,
                                               device=dev)
    out = []
    for o, d in zip(olds, deltas):
        buf = torch.empty(n_old + n_delta, dtype=o.dtype, device=dev)
        buf.index_copy_(0, pos_res, o)
        buf.index_copy_(0, pos_del, d)
        out.append(buf)
    return out
